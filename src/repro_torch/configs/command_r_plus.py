"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01; unverified].

Note: the HF model uses parallel attn+FFN blocks; we use the standard
sequential pre-norm block (identical parameter and FLOP count; noted as a
hardware-adaptation simplification in DESIGN.md).

Port note: a framework-free copy of ``repro.configs.command_r_plus``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    d_model=12288,
    d_ff=33792,
    vocab_size=256000,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_repeats=64,
    attn=AttnConfig(n_heads=96, n_kv_heads=8, head_dim=128, rope_theta=75_000.0),
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
