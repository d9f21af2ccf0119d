"""The four canonical input shapes (assigned per-arch; see DESIGN.md Sec. 6).

Port note: a framework-free copy of ``repro.configs.shapes``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeSpec

SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[ShapeSpec]:
    """Applicable shapes for an arch. ``long_500k`` needs sub-quadratic
    attention: it runs only for SSM/hybrid archs (mamba2, jamba); the
    pure-full-attention archs skip it (documented in DESIGN.md Sec. 6)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


def skipped_shapes_for(cfg: ModelConfig) -> list[tuple[str, str]]:
    if cfg.subquadratic:
        return []
    return [("long_500k", "pure full-attention arch: 524k-token context is the "
             "quadratic regime this shape excludes (DESIGN.md Sec. 6)")]
