"""mamba2-780m [ssm]: 48L d_model=1536, attn-free (d_ff=0), vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

Port note: a framework-free copy of ``repro.configs.mamba2_780m``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    d_model=1536,
    d_ff=0,
    vocab_size=50280,                     # padded to 50432 for TP (ModelConfig.padded_vocab)
    pattern=(LayerSpec(mixer="ssm", ffn="none"),),
    n_repeats=48,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=64),
    tie_embeddings=True,
    subquadratic=True,                    # constant-state decode: long_500k runs
    source="arXiv:2405.21060; unverified",
)
