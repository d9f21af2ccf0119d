"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

~779 B total / ~17 B active parameters as specced. Memory plan: optimizer_mode
"adamw_lowmem" (bf16 moments, factored second moment, no fp32 master) — fp32
Adam for 779 B params cannot fit 256 x 16 GB; the low-mem mode is how such
models are actually trained on small-HBM chips (DESIGN.md Sec. 5). 40 heads do
not divide the 16-way model axis: attention pads to 48 heads (masked).

Port note: a framework-free copy of ``repro.configs.llama4_maverick``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_repeats=48,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128, rope_theta=500_000.0),
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, n_shared_experts=1),
    optimizer_mode="adafactor",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
