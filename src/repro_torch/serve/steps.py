"""Serving step functions (the port of ``repro.serve.steps``): prefill and
decode with a greedy next token, as plain calls."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.builder import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(batch):
        logits, cache = model.prefill(batch)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, cache
    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(tokens, cache, cur_len):
        logits, cache = model.decode_step(tokens, cache, cur_len)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, cache
    return decode_step
