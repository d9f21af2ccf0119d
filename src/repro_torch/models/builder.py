"""Model assembly: config -> an ``nn.Module`` with forward, prefill,
decode_step and init_cache.

The counterpart of ``repro.models.builder``. Parameters keep the
reference's tree and its stacked layout: every leaf under ``dec`` carries a
leading ``[n_repeats, ...]`` axis, and ``state_dict()`` names a leaf by its
path in the reference's tree joined with dots (``dec.pos0.mixer.in_zx``),
so :func:`repro_torch.interop.params_from_reference` carries the JAX
package's weights across leaf for leaf. As the reference splits ``init``
from ``apply``, the model is built from a parameter state and draws none
of its own. Where the reference scans over the
repeats, the port loops over them in Python and takes layer ``r`` as a view
of row ``r``. ``prefill``, ``decode_step`` and ``init_cache`` take and
return the reference's cache layout: ``{"pos{i}": SSMState}`` with the
leading ``[n_repeats]`` axis.

Supported: pattern positions with mixer ``ssm`` and ffn ``dense`` or
``none`` (mamba2-780m, or hand-built SSM + dense-FFN stacks). Attention,
cross-attention, MoE, encoder-decoder and modality-prefix configs raise
``NotImplementedError`` when the model is built; ``loss`` waits for the
train slice. The reference's JAX-only fields ``carry_spec`` and
``scan_unroll`` are dropped; ``pad_heads``, ``attn_impl`` and
``decode_grouped`` come with attention.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.compat import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Gen, embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, unembed)
from repro_torch.models.ssm import SSMState

Params = dict

NOT_PORTED = ("not ported yet: attention, cross-attention and MoE model "
              "modules (and encoder-decoder and modality-prefix models) "
              "wait for ROADMAP.md Queue 1 item 2")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot build."""
    bad = [f"{s.mixer}/{s.ffn}" for s in cfg.pattern
           if s.mixer != "ssm" or s.ffn not in ("dense", "none")]
    if bad or cfg.encoder_decoder or cfg.modality is not None:
        what = ", ".join(sorted(set(bad))) or ("encoder-decoder"
                                               if cfg.encoder_decoder
                                               else f"modality {cfg.modality}")
        raise NotImplementedError(f"{cfg.name}: {what} — {NOT_PORTED}")


def init_params(cfg: ModelConfig, gen: Gen, device=None) -> Params:
    """A parameter tree in the reference's layout, from ``gen``."""
    def init_pos(spec: LayerSpec) -> Params:
        p: Params = {"mixer_norm": init_rmsnorm(cfg.d_model, device),
                     "mixer": ssm_mod.init_ssm(gen, cfg.d_model, cfg.ssm,
                                               device)}
        if spec.ffn != "none":
            p["ffn_norm"] = init_rmsnorm(cfg.d_model, device)
            p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_glu,
                                device)
        return p

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params: Params = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, device),
        "dec": {f"pos{i}": stack([init_pos(spec)
                                  for _ in range(cfg.n_repeats)])
                for i, spec in enumerate(cfg.pattern)},
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                           device)
    return params


def _module(tree: Params) -> nn.Module:
    """Nested ModuleDicts of ParameterDicts holding ``tree``'s leaves."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def _tree(module: nn.Module) -> Params:
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _tree(m) for k, m in module.items()}


def _row(tree: Params, r: int) -> Params:
    return {k: _row(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


class Model(nn.Module):
    """A decoder-only stack of SSM (+ dense FFN) positions; parameters in
    the reference's tree (see the module docstring), copied from
    ``params`` into memory on ``device`` that nothing else initialises."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor],
                 *, dtype=torch.bfloat16, device=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        skeleton = init_params(cfg, torch.Generator(), device="meta")
        for name, module in _module(skeleton).items():
            self.add_module(name, module)
        self.to_empty(device=dev)
        self.load_state_dict(params)

    # ------------------------------------------------------------- pieces
    @property
    def device(self) -> torch.device:
        return self.final_norm["scale"].device

    def param_tree(self) -> Params:
        """The parameters as the reference's nested dict (no copies)."""
        return {name: _tree(m) for name, m in self.named_children()}

    def _ffn(self, spec: LayerSpec, p, x):
        """``x`` plus the position's dense FFN, if it has one."""
        if spec.ffn == "none":
            return x
        cfg = self.cfg
        return x + mlp(p["ffn"], rmsnorm(p["ffn_norm"], x, cfg.norm_eps),
                       cfg.act, cfg.mlp_glu)

    def _layers(self, tree: Params):
        """(r, i, spec, layer params) in depth order."""
        for r in range(self.cfg.n_repeats):
            for i, spec in enumerate(self.cfg.pattern):
                yield r, i, spec, _row(tree["dec"][f"pos{i}"], r)

    def _logits(self, tree: Params, x):
        head = tree.get("lm_head", tree["embed"])
        return unembed(head, x, self.cfg.vocab_size)

    # ------------------------------------------------------------- train
    @torch.no_grad()
    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits [B,S,Vpad], aux_loss)."""
        cfg, tree = self.cfg, self.param_tree()
        x = embed(tree["embed"], batch["tokens"], self.dtype)
        for _, _, spec, p in self._layers(tree):
            x = self._ffn(spec, p, x + ssm_mod.ssm_forward(
                p["mixer"], rmsnorm(p["mixer_norm"], x, cfg.norm_eps),
                cfg.d_model, cfg.ssm))
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return self._logits(tree, x), aux

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch):
        """Prefill -> (last-position logits [B,1,Vpad], cache)."""
        cfg, tree = self.cfg, self.param_tree()
        x = embed(tree["embed"], batch["tokens"], self.dtype)
        states: dict[str, list[SSMState]] = {f"pos{i}": []
                                             for i in range(len(cfg.pattern))}
        for _, i, spec, p in self._layers(tree):
            h, st = ssm_mod.ssm_forward(
                p["mixer"], rmsnorm(p["mixer_norm"], x, cfg.norm_eps),
                cfg.d_model, cfg.ssm, return_state=True)
            states[f"pos{i}"].append(st)
            x = self._ffn(spec, p, x + h)
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        return self._logits(tree, x[:, -1:]), _stack_cache(states)

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, tokens, cache, cur_len):
        """One-token decode. tokens [B,1]; cache from prefill/init_cache;
        cur_len: current sequence length (unused by SSM positions, kept for
        the reference's signature)."""
        cfg, tree = self.cfg, self.param_tree()
        x = embed(tree["embed"], tokens, self.dtype)
        states: dict[str, list[SSMState]] = {k: [] for k in cache}
        for r, i, spec, p in self._layers(tree):
            c = SSMState(*(a[r] for a in cache[f"pos{i}"]))
            h, st = ssm_mod.ssm_decode(
                p["mixer"], rmsnorm(p["mixer_norm"], x, cfg.norm_eps), c,
                cfg.d_model, cfg.ssm)
            states[f"pos{i}"].append(st)
            x = self._ffn(spec, p, x + h)
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        return self._logits(tree, x), _stack_cache(states)

    # ------------------------------------------------------------- cache init
    def init_cache(self, batch_size: int, max_len: int, *,
                   enc_len: int = 0) -> Any:
        """Zero-filled cache (shape-faithful to the reference's)."""
        cfg, s = self.cfg, self.cfg.ssm
        r = cfg.n_repeats

        def zeros(*shape, dt=self.dtype):
            return torch.zeros((r, *shape), dtype=dt, device=self.device)

        return {f"pos{i}": SSMState(
            conv_x=zeros(batch_size, s.d_conv - 1, s.d_inner(cfg.d_model)),
            conv_bc=zeros(batch_size, s.d_conv - 1,
                          2 * s.n_groups * s.d_state),
            ssd=zeros(batch_size, s.n_heads(cfg.d_model), s.d_state,
                      s.head_dim, dt=torch.float32))
            for i in range(len(cfg.pattern))}


def _stack_cache(states: dict[str, list[SSMState]]) -> dict[str, SSMState]:
    return {k: SSMState(*(torch.stack(parts) for parts in zip(*v)))
            for k, v in states.items()}


def build_model(cfg: ModelConfig, params: dict[str, torch.Tensor], *,
                dtype=torch.bfloat16, device=None) -> Model:
    """The port's model for ``cfg`` on ``device`` (None means the card;
    raises without one), holding a copy of ``params``: a ``state_dict`` with
    every leaf, as :func:`repro_torch.interop.params_from_reference`
    makes it from the reference's parameter tree."""
    return Model(cfg, params, dtype=dtype, device=device)
