"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408(expert)
vocab=163840, MoE 64e top-6 + 2 shared experts (Moonlight/DeepSeek-MoE-style
fine-grained experts) [hf:moonshotai/Moonlight-16B-A3B; hf].

The assigned spec pins 48 layers; the released Moonlight checkpoint is
shallower — we implement the spec as given (DESIGN.md Sec. 6).

Port note: a framework-free copy of ``repro.configs.moonshot_16b``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    d_model=2048,
    d_ff=1408,
    vocab_size=163840,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_repeats=48,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
