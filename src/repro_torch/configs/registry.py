"""Architecture registry: ``--arch <id>`` resolution.

Port note: a framework-free copy of ``repro.configs.registry``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, str] = {
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "granite-34b": "repro_torch.configs.granite_34b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_16b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def list_archs() -> list[str]:
    return sorted(ARCHS)
