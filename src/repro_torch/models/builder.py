"""Model assembly: config -> an ``nn.Module`` with forward, loss, prefill,
decode_step and init_cache.

The counterpart of ``repro.models.builder``, for every architecture of the
registry: pattern positions with mixer ``ssm``, ``attn`` or ``cross`` and
ffn ``dense``, ``moe`` or ``none``; encoder-decoder configs (a non-causal
encoder stack over ``enc_embeds``, cross-attention in the decoder) and
modality configs (``patch_embeds`` ahead of the text embeddings).

Parameters keep the reference's tree and its stacked layout: every leaf
under ``dec`` (and ``enc``) carries a leading ``[n_repeats, ...]`` axis,
and ``state_dict()`` names a leaf by its path in the reference's tree
joined with dots (``dec.pos0.mixer.wq``), so
:func:`repro_torch.interop.params_from_reference` carries the JAX
package's weights across leaf for leaf. As the reference splits ``init``
from ``apply``, the model is built from a parameter state and draws none
of its own. Where the reference scans over the repeats, the port loops
over them in Python and takes layer ``r`` as row ``r`` of one ``unbind``
of each stacked leaf: its backward stacks the rows' gradients once,
where a view a row would add a zero-filled gradient of the whole stacked
leaf for every row.
``prefill``, ``decode_step`` and ``init_cache`` take and return the
reference's cache layout: ``{"pos{i}": SSMState or KVCache}`` with the
leading ``[n_repeats]`` axis. ``forward`` returns the MoE positions' aux
loss. The reference's JAX-only fields ``carry_spec`` and ``scan_unroll``
are dropped.

``forward``, ``prefill`` and ``decode_step`` run without autograd and
launch the kernels on the card. ``loss`` is the train route, with
gradients: the reference's own path, which calls no Pallas kernel (the SSM
through ``ssd_chunked``, the MoE's expert products as ``einsum``), so it
launches none. On ``meta`` (the dry-run's shapes without data, which no
kernel takes) ``prefill`` and ``decode_step`` take that path too. With
``cfg.remat != "none"`` each decoder block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), which
saves memory and changes no number. Parameters are built with
``requires_grad=False``; ``repro_torch.train.step`` turns it on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.compat import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (Gen, embed, init_embedding, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm, unembed)
from repro_torch.models.ssm import SSMState

Params = dict


def _noncausal(cfg):
    return dataclasses.replace(cfg, causal=False)


def init_params(cfg: ModelConfig, gen: Gen, device=None,
                pad_heads: int = 0) -> Params:
    """A parameter tree in the reference's layout, from ``gen``: the
    decoder's positions in order, each drawn ``n_repeats`` times, then the
    head and the encoder stack."""
    d = cfg.d_model

    def init_pos(spec: LayerSpec) -> Params:
        p: Params = {"mixer_norm": init_rmsnorm(d, device)}
        if spec.mixer in ("attn", "cross"):
            p["mixer"] = attn_mod.init_attention(gen, d, cfg.attn, pad_heads,
                                                 device)
        else:
            p["mixer"] = ssm_mod.init_ssm(gen, d, cfg.ssm, device)
        if spec.ffn != "none":
            p["ffn_norm"] = init_rmsnorm(d, device)
            p["ffn"] = (init_mlp(gen, d, cfg.d_ff, cfg.mlp_glu, device)
                        if spec.ffn == "dense" else
                        moe_mod.init_moe(gen, d, cfg.moe, cfg.mlp_glu, device))
        return p

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    def init_stack(pattern, repeats):
        return {f"pos{i}": stack([init_pos(spec) for _ in range(repeats)])
                for i, spec in enumerate(pattern)}

    params: Params = {
        "embed": init_embedding(gen, cfg.padded_vocab, d, device),
        "dec": init_stack(cfg.pattern, cfg.n_repeats),
        "final_norm": init_rmsnorm(d, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.padded_vocab, d, device)
    if cfg.encoder_decoder:
        params["enc"] = init_stack(cfg.enc_pattern, cfg.enc_repeats)
        params["enc_norm"] = init_rmsnorm(d, device)
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


def _unbind(tree: Params, n: int) -> list[Params]:
    """The ``n`` per-repeat trees of a stacked tree (views)."""
    rows: list[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
        for r in range(n):
            rows[r][k] = parts[r]
    return rows


def _cache_row(c: NamedTuple, r: int) -> NamedTuple:
    return type(c)(*(a[r] for a in c))


def _stack_cache(parts: dict[str, list]) -> dict[str, NamedTuple]:
    return {k: type(v[0])(*(torch.stack(a) for a in zip(*v)))
            for k, v in parts.items()}


class Model(nn.Module):
    """A registry architecture; parameters in the reference's tree (see
    the module docstring), copied from ``params`` into memory on
    ``device`` that nothing else initialises. ``pad_heads``, ``attn_impl``
    and ``decode_grouped`` are the reference's fields of the same names."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor],
                 *, pad_heads: int = 0, attn_impl: str = "naive",
                 decode_grouped: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.pad_heads = pad_heads
        self.attn_impl = attn_impl
        self.decode_grouped = decode_grouped
        self.dtype = dtype
        skeleton = init_params(cfg, torch.Generator(), device="meta",
                               pad_heads=pad_heads)
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

    def _mixer(self, spec: LayerSpec, p, x, *, enc=None, mode="train",
               use_kernel=True):
        cfg = self.cfg
        if spec.mixer == "ssm":
            return ssm_mod.ssm_forward(p, x, cfg.d_model, cfg.ssm,
                                       use_kernel=use_kernel)
        if spec.mixer == "cross":
            return attn_mod.cross_attention(p, x, enc, _noncausal(cfg.attn))
        acfg = cfg.attn if mode != "encoder" else _noncausal(cfg.attn)
        return attn_mod.attention(p, x, acfg, impl=self.attn_impl)

    def _add_ffn(self, spec: LayerSpec, p, x, use_kernel=True):
        """(``x`` plus the position's FFN, if it has one; its aux loss)."""
        cfg = self.cfg
        if spec.ffn == "none":
            return x, 0.0
        h = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
        if spec.ffn == "dense":
            return x + mlp(p["ffn"], h, cfg.act, cfg.mlp_glu), 0.0
        h, aux = moe_mod.moe_ffn(p["ffn"], h, cfg.moe, cfg.act, cfg.mlp_glu,
                                 use_kernel=use_kernel)
        return x + h, aux

    def _stack(self, pattern, repeats: int, stack: Params, x, *, enc=None,
               mode="train", train=False):
        """The ``repeats`` blocks of ``stack`` over ``x`` -> (x, aux), the
        aux summed a block at a time as the reference's scan carries it.
        ``train`` takes the train route (no kernel; remat as configured)."""
        rows = [_unbind(stack[f"pos{i}"], repeats)
                for i in range(len(pattern))]

        def block(x, r):
            block_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, spec in enumerate(pattern):
                p = rows[i][r]
                x = x + self._mixer(spec, p["mixer"],
                                    rmsnorm(p["mixer_norm"], x,
                                            self.cfg.norm_eps),
                                    enc=enc, mode=mode, use_kernel=not train)
                x, a = self._add_ffn(spec, p, x, use_kernel=not train)
                block_aux = block_aux + a
            return x, block_aux

        remat = train and mode == "train" and self.cfg.remat != "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for r in range(repeats):
            if remat:
                x, a = checkpoint(block, x, r, use_reentrant=False)
            else:
                x, a = block(x, r)
            aux = aux + a
        return x, aux

    def _layers(self, tree: Params):
        """(r, i, spec, layer params) of the decoder in depth order."""
        rows = [_unbind(tree["dec"][f"pos{i}"], self.cfg.n_repeats)
                for i in range(len(self.cfg.pattern))]
        for r in range(self.cfg.n_repeats):
            for i, spec in enumerate(self.cfg.pattern):
                yield r, i, spec, rows[i][r]

    def _embed_inputs(self, tree: Params, batch) -> torch.Tensor:
        txt = embed(tree["embed"], batch["tokens"], self.dtype)
        if self.cfg.modality is not None and not self.cfg.encoder_decoder:
            return torch.cat([batch["patch_embeds"].to(self.dtype), txt],
                             dim=1)
        return txt

    def _encode(self, tree: Params, batch, train=False):
        if not self.cfg.encoder_decoder:
            return None
        enc, _ = self._stack(self.cfg.enc_pattern, self.cfg.enc_repeats,
                             tree["enc"],
                             batch["enc_embeds"].to(self.dtype),
                             mode="encoder", train=train)
        return rmsnorm(tree["enc_norm"], enc, self.cfg.norm_eps)

    def _logits(self, tree: Params, x):
        head = tree.get("lm_head", tree["embed"])
        return unembed(head, x, self.cfg.vocab_size)

    # ------------------------------------------------------------- train
    def _forward(self, batch, train: bool):
        cfg, tree = self.cfg, self.param_tree()
        x = self._embed_inputs(tree, batch)
        enc = self._encode(tree, batch, train)
        x, aux = self._stack(cfg.pattern, cfg.n_repeats, tree["dec"], x,
                             enc=enc, train=train)
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        return self._logits(tree, x), aux

    @torch.no_grad()
    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits [B,S,Vpad], aux_loss)."""
        return self._forward(batch, train=False)

    def loss(self, batch) -> tuple[torch.Tensor, dict]:
        """The train objective -> (ce + aux, {"ce", "aux"}), with
        gradients, on the train route (see the module docstring). Labels
        below 0 are masked; ``logits[t]`` predicts ``labels[t]``."""
        logits, aux = self._forward(batch, train=True)
        labels = batch["labels"]
        valid = labels >= 0
        safe = labels.clamp(min=0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        ce = (nll * valid).sum() / valid.sum().clamp(min=1)
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch):
        """Prefill -> (last-position logits [B,1,Vpad], cache)."""
        cfg, tree = self.cfg, self.param_tree()
        kernels = self.device.type != "meta"
        x = self._embed_inputs(tree, batch)
        enc = self._encode(tree, batch)
        parts: dict[str, list] = {f"pos{i}": []
                                  for i in range(len(cfg.pattern))}
        for _, i, spec, p in self._layers(tree):
            xin = rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
            if spec.mixer == "ssm":
                h, c = ssm_mod.ssm_forward(p["mixer"], xin, cfg.d_model,
                                           cfg.ssm, return_state=True,
                                           use_kernel=kernels)
            elif spec.mixer == "cross":
                c = attn_mod.cross_kv(p["mixer"], enc, self.dtype)
                h = attn_mod.cross_attend(p["mixer"], xin, c,
                                          _noncausal(cfg.attn))
            else:
                h, c = attn_mod.prefill_attention(p["mixer"], xin, cfg.attn,
                                                  impl=self.attn_impl)
            parts[f"pos{i}"].append(c)
            x, _ = self._add_ffn(spec, p, x + h, use_kernel=kernels)
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        return self._logits(tree, x[:, -1:]), _stack_cache(parts)

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, tokens, cache, cur_len):
        """One-token decode. tokens [B,1]; cache from prefill/init_cache;
        cur_len: current sequence length (an int, a [] or a [B] tensor)."""
        cfg, tree = self.cfg, self.param_tree()
        kernels = self.device.type != "meta"
        x = embed(tree["embed"], tokens, self.dtype)
        cur = torch.as_tensor(cur_len, device=x.device)
        parts: dict[str, list] = {k: [] for k in cache}
        for r, i, spec, p in self._layers(tree):
            c = _cache_row(cache[f"pos{i}"], r)
            xin = rmsnorm(p["mixer_norm"], x, cfg.norm_eps)
            if spec.mixer == "ssm":
                h, c = ssm_mod.ssm_decode(p["mixer"], xin, c, cfg.d_model,
                                          cfg.ssm)
            elif spec.mixer == "cross":
                h = attn_mod.cross_attend(p["mixer"], xin, c,
                                          _noncausal(cfg.attn))
            else:
                h, c = attn_mod.decode_attention(p["mixer"], xin, cfg.attn,
                                                 c, cur,
                                                 grouped=self.decode_grouped)
            parts[f"pos{i}"].append(c)
            x, _ = self._add_ffn(spec, p, x + h, use_kernel=kernels)
        x = rmsnorm(tree["final_norm"], x, cfg.norm_eps)
        return self._logits(tree, x), _stack_cache(parts)

    # ------------------------------------------------------------- cache init
    def init_cache(self, batch_size: int, max_len: int, *,
                   enc_len: int = 0) -> Any:
        """Zero-filled cache (shape-faithful to the reference's)."""
        cfg = self.cfg
        r = cfg.n_repeats

        def zeros(*shape, dt=self.dtype):
            return torch.zeros((r, *shape), dtype=dt, device=self.device)

        cache = {}
        for i, spec in enumerate(cfg.pattern):
            if spec.mixer == "ssm":
                s = cfg.ssm
                cache[f"pos{i}"] = SSMState(
                    conv_x=zeros(batch_size, s.d_conv - 1,
                                 s.d_inner(cfg.d_model)),
                    conv_bc=zeros(batch_size, s.d_conv - 1,
                                  2 * s.n_groups * s.d_state),
                    ssd=zeros(batch_size, s.n_heads(cfg.d_model), s.d_state,
                              s.head_dim, dt=torch.float32))
            else:
                a = cfg.attn
                n = enc_len if spec.mixer == "cross" else max_len
                cache[f"pos{i}"] = KVCache(
                    k=zeros(batch_size, n, a.n_kv_heads, a.head_dim),
                    v=zeros(batch_size, n, a.n_kv_heads, a.head_dim))
        return cache


def build_model(cfg: ModelConfig, params: dict[str, torch.Tensor], *,
                pad_heads: int = 0, attn_impl: str = "naive",
                dtype=torch.bfloat16, decode_grouped: bool = False,
                device=None) -> Model:
    """The port's model for ``cfg`` (any registry architecture) on
    ``device`` (None means the card; raises without one), holding a copy
    of ``params``: a ``state_dict`` with every leaf, as
    :func:`repro_torch.interop.params_from_reference` makes it from the
    reference's parameter tree (with the same ``pad_heads``)."""
    return Model(cfg, params, pad_heads=pad_heads, attn_impl=attn_impl,
                 decode_grouped=decode_grouped, dtype=dtype, device=device)
