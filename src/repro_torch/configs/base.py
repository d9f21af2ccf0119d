"""Model / shape configuration dataclasses.

A model is a stack of ``blocks``: a block is a short layer *pattern* (for
hybrids like Jamba), repeated ``n_repeats`` times. Uniform models use a
1-layer pattern. Parameters are stacked over repeats and the forward pass scans
over them, keeping compiled HLO size O(pattern), not O(depth) — essential for
the 88-layer/104 B dry-runs.

Port note: a framework-free copy of ``repro.configs.base``, with import paths
rewritten to ``repro_torch`` (the port never imports the JAX
package); tests/test_torch_configs.py holds it equal to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    qk_norm: bool = False
    sliding_window: int | None = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD block hyperparameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256          # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the block pattern."""
    mixer: Literal["attn", "ssm", "cross"]  # "cross" used inside decoder stacks
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["ssm", "hybrid", "dense", "moe", "audio", "vlm"]
    d_model: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...]          # layer pattern within a block
    n_repeats: int                          # blocks (pattern repetitions)
    attn: AttnConfig | None = None
    ssm: SSMConfig | None = None
    moe: MoEConfig | None = None
    mlp_glu: bool = True                    # SwiGLU (3 mats) vs plain up/down (2 mats)
    act: str = "silu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # encoder-decoder (seamless): a separate non-causal encoder stack
    encoder_decoder: bool = False
    enc_pattern: tuple[LayerSpec, ...] = ()
    enc_repeats: int = 0
    # modality stub: inputs are precomputed frame/patch embeddings
    modality: Literal[None, "audio", "vision"] = None
    modality_tokens: int = 0                # prefix embedding positions (vlm/audio)
    # parallelism / memory hints (see DESIGN.md Sec. 5)
    pure_dp: bool = False                   # replicate params, batch over data x model
    optimizer_mode: Literal["adamw", "adafactor"] = "adamw"
    subquadratic: bool = False              # eligible for long_500k
    remat: Literal["none", "dots", "full"] = "dots"
    source: str = ""                        # provenance note ([arXiv/hf]; verified tier)

    # ---------------- derived ----------------
    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_repeats

    @property
    def padded_vocab(self) -> int:
        """Megatron-style vocab padding to a multiple of 256 for TP sharding."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    def layer_specs(self):
        for _ in range(self.n_repeats):
            yield from self.pattern

    def param_count(self) -> int:
        """Analytic parameter count (used in tests and MODEL_FLOPS)."""
        d = self.d_model
        n = 0

        def attn_params():
            a = self.attn
            return d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2

        def ssm_params():
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_ch = di + 2 * s.n_groups * s.d_state
            in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            return (in_proj + conv_ch * (s.d_conv + 1)      # conv weights + biases
                    + nh * 2                                # A_log, D
                    + di + nh                               # gated-norm scale, dt_bias
                    + di * d)                               # out_proj

        def ffn_params(kind):
            if kind == "none":
                return 0
            mats = 3 if self.mlp_glu else 2
            if kind == "dense":
                return mats * d * self.d_ff
            m = self.moe
            per = mats * d * m.d_ff_expert
            return per * (m.n_experts + m.n_shared_experts) + d * m.n_experts

        for spec in self.layer_specs():
            n += d  # mixer norm
            n += attn_params() if spec.mixer in ("attn", "cross") else ssm_params()
            if spec.ffn != "none":
                n += d  # ffn norm
                n += ffn_params(spec.ffn)
        if self.encoder_decoder:
            for _ in range(self.enc_repeats):
                for spec in self.enc_pattern:
                    n += d + attn_params()
                    if spec.ffn != "none":
                        n += d + ffn_params(spec.ffn)
        n += self.vocab_size * d            # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d        # lm head
        n += d                              # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        mats = 3 if self.mlp_glu else 2
        per_expert = mats * d * m.d_ff_expert
        inactive = 0
        for spec in self.layer_specs():
            if spec.ffn == "moe":
                inactive += per_expert * (m.n_experts - m.top_k)
        return self.param_count() - inactive

    def reduced(self, seed_width: int = 64) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        d = seed_width
        attn = None
        if self.attn is not None:
            attn = dataclasses.replace(
                self.attn, n_heads=4, head_dim=d // 4,
                n_kv_heads=max(1, 4 * self.attn.n_kv_heads // max(self.attn.n_heads, 1)))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                                      d_ff_expert=2 * d,
                                      n_shared_experts=min(1, self.moe.n_shared_experts))
        return dataclasses.replace(
            self, d_model=d, d_ff=2 * d, vocab_size=512,
            n_repeats=min(self.n_repeats, 2), attn=attn, ssm=ssm, moe=moe,
            enc_repeats=min(self.enc_repeats, 2),
            modality_tokens=min(self.modality_tokens, 8),
            remat="none")
