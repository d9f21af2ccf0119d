"""The steps every wrapper of the accelerator layer shares between its
checks and its kernel: which version runs for the tensors' device, the
stream the C entry takes, and the error it returns."""
from __future__ import annotations

import torch


def runs_plain(name: str, *tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the CPU (the wrapper runs its plain
    version), False when they lie on one CUDA device (it launches the
    kernel); raises for any other device or a mix, and on the card for
    tensors that require grad under grad mode: the kernel has no backward,
    and its output would leave the autograd graph without a word."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda (or cpu for its plain "
                         f"version), not {dev}")
    if (dev.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and these inputs "
            f"require grad; call it under torch.no_grad(), or take the "
            f"train route (Model.loss), which runs no kernel")
    return dev.type == "cpu"


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a C entry did not launch: -1 for arguments the kernel
    refused, else the CUDA error of the launch."""
    if err == -1:
        raise ValueError(f"{name}: the kernel refused its arguments")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
