"""Synthetic batches: the single source of truth for per-family input shapes.

The counterpart of ``repro.data.synth``. ``batch_shapes(cfg, B, S)``
returns {name: (shape, dtype)}; ``make_batch`` fills them. Conventions:

  text LM        tokens/labels [B, S]
  vlm            patch_embeds [B, P, D] + tokens [B, S-P] + labels [B, S]
                 (P = cfg.modality_tokens, capped at S//2)
  audio enc-dec  enc_embeds [B, S, D] + tokens/labels [B, max(S//4, 8)]

``make_batch`` makes the reference's ``np.random.default_rng(seed)`` draws
in the reference's order, so its arrays equal the JAX package's bit for
bit; they come back as tensors on the given device (tokens and labels
int32, embeddings rounded from float32 to ``dtype``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig


def batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                 dtype=torch.bfloat16
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    if cfg.encoder_decoder:
        dec = max(seq // 4, 8)
        return {
            "enc_embeds": ((batch, seq, cfg.d_model), dtype),
            "tokens": ((batch, dec), torch.int32),
            "labels": ((batch, dec), torch.int32),
        }
    if cfg.modality is not None:
        p = min(cfg.modality_tokens, seq // 2)
        return {
            "patch_embeds": ((batch, p, cfg.d_model), dtype),
            "tokens": ((batch, seq - p), torch.int32),
            "labels": ((batch, seq), torch.int32),
        }
    return {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               dtype=torch.bfloat16, device=None) -> dict[str, torch.Tensor]:
    """Deterministic synthetic batch with a learnable structure (a noisy
    periodic token process), on ``device`` (None: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    shapes = batch_shapes(cfg, batch, seq, dtype)
    out: dict[str, np.ndarray] = {}

    def tokens_like(shape):
        b, s = shape
        base = (np.arange(s)[None, :] * 7 + rng.integers(0, 13, (b, 1))) % min(
            cfg.vocab_size, 1024)
        noise = rng.integers(0, cfg.vocab_size, (b, s))
        take_noise = rng.random((b, s)) < 0.1
        return np.where(take_noise, noise, base).astype(np.int32)

    for name, (shape, _) in shapes.items():
        if name == "tokens":
            out[name] = tokens_like(shape)
        elif name != "labels":  # embedding stubs
            out[name] = rng.standard_normal(shape, dtype=np.float32) * 0.02

    # labels: next-token shift of the text stream; modality positions masked
    toks = out["tokens"]
    nxt = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    lab_shape = shapes["labels"][0]
    if lab_shape[1] != toks.shape[1]:  # vlm: prepend masked modality positions
        pad = -np.ones((lab_shape[0], lab_shape[1] - toks.shape[1]), np.int32)
        nxt = np.concatenate([pad, nxt], axis=1)
    out["labels"] = nxt
    return {name: torch.from_numpy(out[name]).to(dev, shapes[name][1])
            for name in shapes}
