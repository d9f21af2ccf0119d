"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 —
llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

Parallelism: pure DP (params replicated, batch sharded over data x model) —
the realistic deployment of a 135 M model on a 256-chip pod (DESIGN.md Sec. 5).

Port note: a framework-free copy of ``repro.configs.smollm_135m``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    d_model=576,
    d_ff=1536,
    vocab_size=49152,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_repeats=30,
    attn=AttnConfig(n_heads=9, n_kv_heads=3, head_dim=64),
    tie_embeddings=True,
    pure_dp=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
