"""granite-34b [dense]: 88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324; hf].

granite-34b-code uses a GPT-BigCode-style 2-matrix GELU MLP (mlp_glu=False),
which is what makes the published 34 B parameter count work out.

Port note: a framework-free copy of ``repro.configs.granite_34b``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_repeats=88,
    attn=AttnConfig(n_heads=48, n_kv_heads=1, head_dim=128),
    mlp_glu=False,
    act="gelu",
    source="arXiv:2405.04324; hf",
)
