"""The port's ``repro_torch.configs``.

Port note: a framework-free copy of ``repro.configs``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import (AttnConfig, LayerSpec, ModelConfig, MoEConfig,
                                SSMConfig, ShapeSpec)
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["AttnConfig", "LayerSpec", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeSpec", "SHAPES", "shapes_for", "ARCHS", "get_config", "list_archs"]
