"""seamless-m4t-large-v2 [audio]: enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206 — multimodal [arXiv:2308.11596; hf].

24 encoder layers (non-causal, over precomputed audio-frame embeddings — the
speech frontend is a STUB per the assignment) + 24 decoder layers (causal
self-attn + cross-attn). Decoder length conventions: train/prefill use
dec_len = seq_len // 4 (text is shorter than audio frames).

Port note: a framework-free copy of ``repro.configs.seamless_m4t``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import AttnConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    d_model=1024,
    d_ff=8192,
    vocab_size=256206,                    # padded to 256256 for TP
    # one decoder layer per repeat: self-attn (no FFN) -> cross-attn -> FFN
    pattern=(LayerSpec(mixer="attn", ffn="none"),
             LayerSpec(mixer="cross", ffn="dense")),
    n_repeats=24,                          # 24 decoder layers
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64, causal=True),
    encoder_decoder=True,
    enc_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    enc_repeats=24,
    modality="audio",
    source="arXiv:2308.11596; hf",
)
