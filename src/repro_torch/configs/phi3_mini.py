"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32, i.e. MHA) d_ff=8192
vocab=32064 — RoPE SwiGLU [arXiv:2404.14219; unverified].

Port note: a framework-free copy of ``repro.configs.phi3_mini``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_repeats=32,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=96),
    source="arXiv:2404.14219; unverified",
)
