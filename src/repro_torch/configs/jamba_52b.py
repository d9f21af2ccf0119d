"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other layer
[arXiv:2403.19887; hf].

Block pattern (8 layers, repeated 4x): attention at position 4 of 8 (1:7
ratio), MoE on odd positions (16 MoE layers total). Jamba v0.1 uses Mamba-1
internally; we use the Mamba-2/SSD block for the SSM positions (hardware
adaptation — SSD is the TPU-matched formulation; noted in DESIGN.md).

Port note: a framework-free copy of ``repro.configs.jamba_52b``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, MoEConfig, SSMConfig

_S, _A = "ssm", "attn"
_D, _E = "dense", "moe"

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    pattern=tuple(LayerSpec(mixer=m, ffn=f) for m, f in
                  [(_S, _D), (_S, _E), (_S, _D), (_S, _E),
                   (_A, _D), (_S, _E), (_S, _D), (_S, _E)]),
    n_repeats=4,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=32),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    subquadratic=True,                    # only 4/32 layers attend: long_500k runs
    source="arXiv:2403.19887; hf",
)
