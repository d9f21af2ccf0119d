"""The model stack in PyTorch (the port of ``repro.models``): shared layers,
the Mamba-2 SSM block and the model builder."""
from repro_torch.models.builder import Model, build_model

__all__ = ["Model", "build_model"]
