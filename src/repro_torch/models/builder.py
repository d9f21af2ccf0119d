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
from repro_torch.models.attention import KVCache, Window
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


class Layout:
    """Where a model's compute takes its parameters from, and how its
    activations lie: the hooks the sharded steps
    (``repro_torch.distributed.partition``) replace. This one is the
    single-device route: the tree's own leaves (layer ``r`` a row of one
    ``unbind`` of each stacked leaf), the whole sequence, no collective,
    the kernels on the card. ``group`` (a
    :class:`repro_torch.models.layers.BatchGroup`) makes the MoE capacity,
    the aux loss and the cross-entropy the whole batch's when this batch
    is one member's rows."""

    kernels = True
    norm_sum = None

    def __init__(self, tree: Params, group=None):
        self.tree, self.group = tree, group
        self._rows: dict = {}

    def prepare(self, stack: str, n_pos: int, repeats: int) -> None:
        """Called before a stack's blocks run (outside any remat)."""
        for i in range(n_pos):
            if (stack, i) not in self._rows:
                self._rows[stack, i] = _unbind(self.tree[stack][f"pos{i}"],
                                               repeats)

    def block(self, stack: str, i: int, r: int) -> Params:
        """Position ``i``'s parameters in repeat ``r`` of ``stack``."""
        return self._rows[stack, i][r]

    def top(self, name: str) -> Params:
        return self.tree[name]

    def experts(self, stack: str, i: int):
        """The ``[e0, e1)`` of experts this rank computes (None: all)."""
        return None

    def carry(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        """A stack's input (the whole sequence) as its residual lies."""
        return x

    def enter(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        """A mixer's or FFN's input from the residual."""
        return x

    def exit(self, y: torch.Tensor, stack: str, i: int, part: str
             ) -> torch.Tensor:
        """A mixer's or FFN's output (``part``) as the residual lies."""
        return y

    def whole_seq(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        """A residual as the whole sequence (the encoder's output)."""
        return x

    def cache(self, c, stack: str, i: int):
        """Position ``i``'s prefill cache as the model returns it."""
        return c

    def window(self, stack: str, i: int) -> Window:
        """Position ``i``'s decode attention on the cache it is given:
        here every slot and every head, no collective."""
        return Window()

    def embed(self, model: "Model", tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.top("embed"), tokens, model.dtype)

    def embed_inputs(self, model: "Model", batch) -> torch.Tensor:
        """The decoder's input, as its residual lies."""
        txt = self.embed(model, batch["tokens"])
        if model.cfg.modality is not None and not model.cfg.encoder_decoder:
            return torch.cat([batch["patch_embeds"].to(model.dtype), txt],
                             dim=1)
        return txt

    def logits(self, model: "Model", x: torch.Tensor) -> torch.Tensor:
        head = (self.top("lm_head") if "lm_head" in self.tree
                else self.top("embed"))
        return unembed(head, x, model.cfg.vocab_size)

    def ce(self, model: "Model", x: torch.Tensor, labels: torch.Tensor
           ) -> torch.Tensor:
        """Mean cross-entropy of the final-normed ``x`` over the labels
        at or above 0 (the group's, with a ``group``)."""
        logits = self.logits(model, x)
        valid = labels >= 0
        safe = labels.clamp(min=0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        if self.group is None:
            return (nll * valid).sum() / valid.sum().clamp(min=1)
        tot = self.group.sum(torch.stack([(nll * valid).sum(),
                                          valid.sum().float()]))
        return tot[0] / tot[1].clamp(min=1)


class Model(nn.Module):
    """A registry architecture; parameters in the reference's tree (see
    the module docstring), copied from ``params`` into memory on
    ``device`` that nothing else initialises. ``pad_heads``, ``attn_impl``
    and ``decode_grouped`` are the reference's fields of the same names.

    ``loss``, ``prefill`` and ``decode_step`` take an optional
    :class:`Layout`: the parameters then come from it, block by block,
    and the model's own are not read (a model on ``meta`` serves)."""

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

    def layout(self, group=None) -> Layout:
        """The single-device :class:`Layout` over this model's own
        parameters."""
        return Layout(self.param_tree(), group)

    def _mixer(self, spec: LayerSpec, p, x, *, enc=None, mode="train",
               use_kernel=True, norm_sum=None):
        cfg = self.cfg
        if spec.mixer == "ssm":
            return ssm_mod.ssm_forward(p, x, cfg.d_model, cfg.ssm,
                                       use_kernel=use_kernel,
                                       norm_sum=norm_sum)
        if spec.mixer == "cross":
            return attn_mod.cross_attention(p, x, enc, _noncausal(cfg.attn),
                                            p.get("kv_index"))
        acfg = cfg.attn if mode != "encoder" else _noncausal(cfg.attn)
        return attn_mod.attention(p, x, acfg, impl=self.attn_impl,
                                  kv_index=p.get("kv_index"))

    def _add_ffn(self, spec: LayerSpec, p, x, layout: Layout, stack: str,
                 i: int, use_kernel=True):
        """(``x`` plus the position's FFN, if it has one; its aux loss)."""
        cfg = self.cfg
        if spec.ffn == "none":
            return x, 0.0
        h = layout.enter(rmsnorm(p["ffn_norm"], x, cfg.norm_eps), stack)
        if spec.ffn == "dense":
            return x + layout.exit(mlp(p["ffn"], h, cfg.act, cfg.mlp_glu),
                                   stack, i, "ffn"), 0.0
        h, aux = moe_mod.moe_ffn(p["ffn"], h, cfg.moe, cfg.act, cfg.mlp_glu,
                                 use_kernel=use_kernel, group=layout.group,
                                 experts=layout.experts(stack, i))
        return x + layout.exit(h, stack, i, "ffn"), aux

    def _stack(self, pattern, repeats: int, stack: str, x, layout: Layout,
               *, enc=None, mode="train", train=False):
        """The ``repeats`` blocks of ``stack`` ("dec" or "enc") over ``x``
        -> (x, aux), the aux summed a block at a time as the reference's
        scan carries it. ``train`` takes the train route (no kernel; remat
        as configured)."""
        layout.prepare(stack, len(pattern), repeats)
        use_kernel = not train and layout.kernels

        def block(x, r):
            block_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, spec in enumerate(pattern):
                p = layout.block(stack, i, r)
                h = layout.enter(rmsnorm(p["mixer_norm"], x,
                                         self.cfg.norm_eps), stack)
                x = x + layout.exit(
                    self._mixer(spec, p["mixer"], h, enc=enc, mode=mode,
                                use_kernel=use_kernel,
                                norm_sum=layout.norm_sum),
                    stack, i, "mixer")
                x, a = self._add_ffn(spec, p, x, layout, stack, i,
                                     use_kernel=use_kernel)
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

    def _encode(self, layout: Layout, batch, train=False):
        if not self.cfg.encoder_decoder:
            return None
        x = layout.carry(batch["enc_embeds"].to(self.dtype), "enc")
        enc, _ = self._stack(self.cfg.enc_pattern, self.cfg.enc_repeats,
                             "enc", x, layout, mode="encoder", train=train)
        return layout.whole_seq(rmsnorm(layout.top("enc_norm"), enc,
                                        self.cfg.norm_eps), "enc")

    # ------------------------------------------------------------- train
    def _trunk(self, batch, train: bool, layout: Layout):
        """The final-normed decoder output and the summed aux loss."""
        cfg = self.cfg
        x = layout.embed_inputs(self, batch)
        enc = self._encode(layout, batch, train)
        x, aux = self._stack(cfg.pattern, cfg.n_repeats, "dec", x, layout,
                             enc=enc, train=train)
        return rmsnorm(layout.top("final_norm"), x, cfg.norm_eps), aux

    @torch.no_grad()
    def forward(self, batch) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward -> (logits [B,S,Vpad], aux_loss)."""
        layout = self.layout()
        x, aux = self._trunk(batch, False, layout)
        return layout.logits(self, x), aux

    def loss(self, batch, layout: Layout | None = None
             ) -> tuple[torch.Tensor, dict]:
        """The train objective -> (ce + aux, {"ce", "aux"}), with
        gradients, on the train route (see the module docstring). Labels
        below 0 are masked; ``logits[t]`` predicts ``labels[t]``."""
        layout = layout or self.layout()
        x, aux = self._trunk(batch, True, layout)
        ce = layout.ce(self, x, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, batch, layout: Layout | None = None):
        """Prefill -> (last-position logits [B,1,Vpad], cache)."""
        cfg = self.cfg
        layout = layout or self.layout()
        x = layout.embed_inputs(self, batch)
        kernels = layout.kernels and x.device.type != "meta"
        enc = self._encode(layout, batch)
        parts: dict[str, list] = {f"pos{i}": []
                                  for i in range(len(cfg.pattern))}
        layout.prepare("dec", len(cfg.pattern), cfg.n_repeats)
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                p = layout.block("dec", i, r)
                pm = p["mixer"]
                xin = layout.enter(rmsnorm(p["mixer_norm"], x, cfg.norm_eps),
                                   "dec")
                if spec.mixer == "ssm":
                    h, c = ssm_mod.ssm_forward(pm, xin, cfg.d_model, cfg.ssm,
                                               return_state=True,
                                               use_kernel=kernels,
                                               norm_sum=layout.norm_sum)
                elif spec.mixer == "cross":
                    c = attn_mod.cross_kv(pm, enc, self.dtype)
                    h = attn_mod.cross_attend(pm, xin, c,
                                              _noncausal(cfg.attn),
                                              pm.get("kv_index"))
                else:
                    h, c = attn_mod.prefill_attention(
                        pm, xin, cfg.attn, impl=self.attn_impl,
                        kv_index=pm.get("kv_index"))
                parts[f"pos{i}"].append(layout.cache(c, "dec", i))
                x, _ = self._add_ffn(spec, p,
                                     x + layout.exit(h, "dec", i, "mixer"),
                                     layout, "dec", i, use_kernel=kernels)
        x = rmsnorm(layout.top("final_norm"), x, cfg.norm_eps)
        return layout.logits(self, x[:, -1:]), _stack_cache(parts)

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, tokens, cache, cur_len,
                    layout: Layout | None = None):
        """One-token decode. tokens [B,1]; cache from prefill/init_cache;
        cur_len: current sequence length (an int, a [] or a [B] tensor)."""
        cfg = self.cfg
        layout = layout or self.layout()
        x = layout.embed(self, tokens)
        kernels = layout.kernels and x.device.type != "meta"
        cur = torch.as_tensor(cur_len, device=x.device)
        parts: dict[str, list] = {k: [] for k in cache}
        layout.prepare("dec", len(cfg.pattern), cfg.n_repeats)
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                p = layout.block("dec", i, r)
                c = _cache_row(cache[f"pos{i}"], r)
                xin = layout.enter(rmsnorm(p["mixer_norm"], x, cfg.norm_eps),
                                   "dec")
                if spec.mixer == "ssm":
                    h, c = ssm_mod.ssm_decode(p["mixer"], xin, c,
                                              cfg.d_model, cfg.ssm,
                                              norm_sum=layout.norm_sum)
                elif spec.mixer == "cross":
                    h = attn_mod.cross_attend(p["mixer"], xin, c,
                                              _noncausal(cfg.attn),
                                              window=layout.window("dec", i))
                else:
                    h, c = attn_mod.decode_attention(
                        p["mixer"], xin, cfg.attn, c, cur,
                        grouped=self.decode_grouped,
                        window=layout.window("dec", i))
                parts[f"pos{i}"].append(c)
                x, _ = self._add_ffn(spec, p,
                                     x + layout.exit(h, "dec", i, "mixer"),
                                     layout, "dec", i, use_kernel=kernels)
        x = rmsnorm(layout.top("final_norm"), x, cfg.norm_eps)
        return layout.logits(self, x), _stack_cache(parts)

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
