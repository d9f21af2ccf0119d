"""The model's compute partitioned on the mesh: the reference's layout, run.

The reference writes layouts only (``sharding.py``) and lets GSPMD
partition the unchanged step: parameters and compute alike. PyTorch has
no GSPMD, so :class:`Partitioned`, a :class:`repro_torch.models.builder.
Layout`, states that partitioning for the port's own model functions, on
each rank's local tensors, with explicit collectives whose backward is
their exact adjoint (an all-gather's is a reduce-scatter, a
reduce-scatter's an all-gather, a sum's a sum).

Parameters (FSDP over "data"). A rank holds only its shards (the
``DTensor``'s local tensor). A block's leaves are gathered over every
mesh dimension other than "model" where they are split, at their use
inside the block (under remat the recompute gathers them again), and
freed after it; ``embed`` / ``lm_head`` are gathered a chunk of vocabulary
rows at a time, no larger than the largest block. No rank ever holds the
whole tree. "pod" splits no parameter.

Compute over "model" (tensor, expert and vocabulary parallelism) in the
train, prefill and decode steps, where the leaf's spec splits it:

  attention  wq heads local; wk / wv local where Hkv divides tp, else
             (replicated) sliced to the kv heads the rank's query heads
             read (``kv_index``, under ``pad_heads``' groups (H + pad) //
             Hkv; prefill and decode keep every kv head, which the cache
             needs); wo row-parallel. Cross-attention and the encoder
             alike. Decode attends on the cache as ``cache_pspecs`` lays
             it out: its rows, its window of the sequence and every kv
             head (``Window``). The new token's query heads (and its K /
             V where wk / wv are split) are all-gathered over "model",
             every head attends over the rank's slots, the partial
             softmax is merged by an all-reduce of the max, then one of
             the rescaled sum of exp and output, over the mesh
             dimensions that split the sequence ("model", or "data" and
             "model" for a replicated batch); the rank keeps its heads for
             wo. Cross-attention in decode alike over the encoder's
             slots, writing nothing.
  dense MLP  up / gate column-parallel over f, down row-parallel; MoE
             shared experts alike.
  MoE        experts split over "model" (``experts()``), router
             replicated: every rank routes all of its tokens and computes
             its experts' part.
  SSM        the rank's heads: conv_x, A_log, D, dt_bias, norm_scale,
             out_proj (row-parallel) local; ``in_zx`` (split contiguously
             over its 2 d_inner columns, not by heads) re-laid out by an
             all-to-all into the rank's z then x columns; ``in_bcdt`` /
             ``conv_bc`` replicated, dt sliced to the rank's heads; the
             gated norm's squares summed over "model". In decode the
             state's ``conv_x`` and ``ssd`` are the rank's shards.
  vocab      embed a masked lookup of the rank's rows summed over
             "model"; lm_head the rank's logits; the cross-entropy from
             the max, the sum of exp and the label's logit over "model".
  norms      replicated, on the residual as it lies.

Leaves ``_maybe`` leaves whole over "model": wk / wv (Hkv does not
divide tp) are sliced as above; in_bcdt, conv_bc, the router and the
norms are whole by rule and computed whole; wq / wo, up / gate / down,
the experts and shared experts, and the SSM's head leaves (their
dimension does not divide tp) make their mixer or FFN run whole: its
leaves are gathered over "model" too and every rank computes it, keeping
its own part of the output (the registry's widths split every one on
the 2x4, 16x16 and 2x16x16 meshes). An unsplit vocabulary table is
looked up and projected whole.

Residual (the sequence-parallel carry, train only). Between blocks it is
``[B_local, S / tp, d]``, as the reference's ``carry_spec`` ``P(dp,
"model", None)``: a mixer or FFN all-gathers its input over "model" along
the sequence and reduce-scatters its partial output back (or, run whole,
keeps its slice). Prefill has no carry: the residual is whole on every
"model" rank, exits all-reduce, and each layer's K/V heads and SSM state
heads are all-gathered into the prefill cache's layout (rows split, heads
and sequence whole). Decode has no carry either: one token, whole on
every "model" rank, each mixer's and FFN's partial output all-reduced
over "model"; the cache stays in its shards and nothing gathers it.

The loss and its gradient. Every rank computes the global loss ``L``
(cross-entropy over the batch's valid labels, all-reduced, plus the MoE
aux, whose capacity and sums are the whole batch's through
:class:`MeshBatch`); the step seeds each rank's backward with ``L / N``
(N ranks), so the adjoint collectives sum to the whole gradient: a split
leaf's gradient arrives in its own shard (the gather's reduce-scatter),
and a leaf that a mesh dimension replicates gets its partial gradients
summed over it (``grads()``). :class:`GatherMeter` counts the gathered
bytes alive at once and the leaves gathered over "model".
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import KVCache, Window
from repro_torch.models.builder import Layout
from repro_torch.models.ssm import SSMState
from repro_torch.tree import leaves_with_paths


#: The functional collectives under their current names (older releases
#: of torch: the ``*_tensor`` names, the same signatures).
_all_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_reduce_scatter = getattr(funcol, "reduce_scatter_single",
                          funcol.reduce_scatter_tensor)


def _done(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _done(_all_gather(x.contiguous(), dim, group))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    return _done(funcol.all_reduce(x.contiguous(), op, group))


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _done(_reduce_scatter(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _done(_reduce_scatter(x.contiguous(), "sum", dim,
                                                  group))

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum); backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Swap(torch.autograd.Function):
    """``all_to_all_single`` of x's rows; backward: the reverse."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (in_splits, out_splits), group
        return _done(funcol.all_to_all_single(x.contiguous(), out_splits,
                                              in_splits, group))

    @staticmethod
    def backward(ctx, g):
        back_out, back_in = ctx.splits
        return (_done(funcol.all_to_all_single(g.contiguous(), back_out,
                                               back_in, ctx.group)),
                None, None, None)


class MeshBatch:
    """The ranks that split the batch's rows over mesh dimensions ``dims``
    (mesh order, major to minor, as a ``DTensor`` splits them): a
    :class:`repro_torch.models.layers.BatchGroup`."""

    def __init__(self, mesh, dims):
        self.mesh = mesh
        self.dims = [d for d in dims if mesh.size(d) > 1]
        self.size, self.index = 1, 0
        for d in self.dims:
            self.size *= mesh.size(d)
            self.index = self.index * mesh.size(d) + mesh.get_local_rank(d)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        y = x[None]
        for d in reversed(self.dims):
            y = all_gather(y, 0, self.mesh.get_group(d))
        return y

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        for d in self.dims:
            x = _Sum.apply(x, self.mesh.get_group(d))
        return x

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s elementwise max over the members (no gradient)."""
        for d in self.dims:
            x = all_reduce(x, self.mesh.get_group(d), "max")
        return x


class _Heads:
    """A mixer's heads (dimension 2) split over "model": the rank holds
    ``[index h, (index + 1) h)`` of ``size h``."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, 2, self.group)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        h = t.shape[2] // self.size
        return t[:, :, self.index * h:(self.index + 1) * h]


class GatherMeter:
    """The most bytes of gathered parameters alive at once on this rank,
    counted by the gathers themselves: each gathered tensor's storage is
    held by a weak reference and drops out of the count when freed.
    ``over_model``: the leaves gathered over "model" (a mixer or FFN run
    whole)."""

    def __init__(self):
        self.peak = 0
        self.over_model = 0
        self._live: list = []

    def add(self, t: torch.Tensor) -> None:
        self._live = [(w, n) for w, n in self._live if not w.expired()]
        s = t.untyped_storage()
        self._live.append((StorageWeakRef(s), s.nbytes()))
        self.peak = max(self.peak, sum(n for _, n in self._live))


def _set(tree: dict, keys: list[str], value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


class Partitioned(Layout):
    """The model's compute on one rank of ``mesh`` (module docstring).
    ``params``: the parameter tree as ``DTensor`` shards; ``batch_dims``:
    the mesh dimensions that split the batch's rows; ``mode``: "train"
    (leaves that require grad; the sequence-parallel carry), "prefill" or
    "decode"; ``slots`` (decode): ``{"pos{i}": (s0, merge)}`` for each
    attention position, the first global slot of the rank's cache window
    and the :class:`MeshBatch` over the ranks that split its sequence
    (None: no other)."""

    kernels = False

    def __init__(self, cfg, params: dict, mesh, batch_dims, mode: str,
                 meter: GatherMeter | None = None,
                 slots: dict | None = None):
        self.cfg, self.mesh, self.mode = cfg, mesh, mode
        self.slots = slots or {}
        self.meter = meter or GatherMeter()
        self.group = MeshBatch(mesh, batch_dims)
        names = list(mesh.mesh_dim_names)
        tp = names.index("model") if "model" in names else None
        if tp is not None and (cfg.pure_dp or tp in batch_dims
                               or mesh.size(tp) == 1):
            tp = None
        self.tp_dim = tp
        self.tp = 1 if tp is None else mesh.size(tp)
        self.tp_rank = 0 if tp is None else mesh.get_local_rank(tp)
        self.leaves: dict[str, torch.Tensor] = {}
        self.pl: dict[str, list] = {}
        self._unbound: dict[str, tuple] = {}
        for path, t in leaves_with_paths(params):
            loc = t.to_local()
            if mode == "train":
                loc = loc.detach().requires_grad_()
            self.leaves[path], self.pl[path] = loc, list(t.placements)
            if path.startswith(("dec/", "enc/")):
                self._unbound[path] = loc.unbind(0)
        self.split: dict[str, bool] = {}
        self.tp_part: dict[tuple, bool] = {}
        stacks = [("dec", cfg.pattern)]
        if cfg.encoder_decoder:
            stacks.append(("enc", cfg.enc_pattern))
        ssm_split = False
        for stack, pattern in stacks:
            for i, spec in enumerate(pattern):
                pre = f"{stack}/pos{i}/"
                mixer = self._splits_mixer(pre + "mixer/", spec.mixer)
                self.tp_part[stack, i, "mixer"] = mixer
                self.tp_part[stack, i, "ffn"] = self._splits_ffn(
                    pre + "ffn/", spec.ffn)
                ssm_split |= mixer and spec.mixer == "ssm"
        if ssm_split:
            group = self._model_group()
            self.norm_sum = lambda x: _Sum.apply(x, group)
        self.budget = max((self._block_bytes(k) for k in self._blocks()),
                          default=0)

    # ------------------------------------------------------------ leaves
    def _model_group(self):
        return self.mesh.get_group(self.tp_dim)

    def _split_on_model(self, path: str, dim: int) -> bool:
        """Leaf ``path``'s (stacked) dimension ``dim`` split over
        "model"."""
        return (self.tp_dim is not None
                and self.pl[path][self.tp_dim] == Shard(dim))

    def _splits_mixer(self, pre: str, mixer: str) -> bool:
        if self.tp_dim is None:
            return False
        if mixer == "ssm":
            return (self._split_on_model(pre + "A_log", 1)
                    and self._split_on_model(pre + "in_zx", 2))
        return self._split_on_model(pre + "wq", 2)

    def _splits_ffn(self, pre: str, ffn: str) -> bool:
        if self.tp_dim is None or ffn == "none":
            return False
        if ffn == "dense":
            return self._split_on_model(pre + "up", 2)
        return self._split_on_model(pre + "up", 1) and (
            pre + "shared_up" not in self.leaves
            or self._split_on_model(pre + "shared_up", 2))

    def _blocks(self):
        return [k[:2] for k in self.tp_part if k[2] == "mixer"]

    def _gathered_dims(self, path: str, whole: bool) -> list[int]:
        """The mesh dimensions ``path`` is gathered over at use."""
        return [d for d, p in enumerate(self.pl[path])
                if isinstance(p, Shard) and (d != self.tp_dim or whole)]

    def _block_bytes(self, key) -> int:
        stack, i = key
        pre = f"{stack}/pos{i}/"
        total = 0
        for path, loc in self.leaves.items():
            if path.startswith(pre):
                part = path[len(pre):].split("/")[0]
                whole = part in ("mixer", "ffn") and not self.tp_part[
                    stack, i, part]
                n = loc[0].numel() * loc.element_size()
                for d in self._gathered_dims(path, whole):
                    n *= self.mesh.size(d)
                total += n
        return total

    def _use(self, path: str, t: torch.Tensor, whole: bool,
             stacked: bool = True) -> torch.Tensor:
        """``t`` (leaf ``path``'s local shard, a row of it if
        ``stacked``) gathered over the dimensions that split it, "model"
        only if ``whole``."""
        gathered = False
        for d in self._gathered_dims(path, whole):
            if self.mesh.size(d) > 1:
                dim = self.pl[path][d].dim - int(stacked)
                t = _Gather.apply(t, dim, self.mesh.get_group(d))
                gathered = True
                self.meter.over_model += d == self.tp_dim
        if gathered:
            self.meter.add(t)
        return t

    def _zx(self, t: torch.Tensor) -> torch.Tensor:
        """``in_zx``'s row ``[d, 2 di / tp]`` (the rank's contiguous
        columns) -> ``[d, 2 di_l]``: the z then x columns of the rank's
        heads. Column chunk c of the 2 tp chunks (chunk 2j and 2j + 1 on
        rank j) is z of rank c for c < tp, else x of rank c - tp: one
        all-to-all of the chunks."""
        tp, j = self.tp, self.tp_rank
        rows = t.T
        n = rows.shape[0] // 2
        dests = [(2 * j) % tp, (2 * j + 1) % tp]
        if dests[0] > dests[1]:
            rows = torch.cat([rows[n:], rows[:n]])
        in_splits = [n if r in dests else 0 for r in range(tp)]
        srcs = (j // 2, (tp + j) // 2)
        out_splits = [n if r in srcs else 0 for r in range(tp)]
        return _Swap.apply(rows, out_splits, in_splits,
                           self._model_group()).T

    # ------------------------------------------------------------ Layout
    def prepare(self, stack: str, n_pos: int, repeats: int) -> None:
        pass

    def block(self, stack: str, i: int, r: int) -> dict:
        pre = f"{stack}/pos{i}/"
        tp = {p: self.tp_part[stack, i, p] for p in ("mixer", "ffn")}
        out: dict = {}
        for path, rows in self._unbound.items():
            if not path.startswith(pre):
                continue
            keys = path[len(pre):].split("/")
            split = tp.get(keys[0], False)
            if split and keys[-1] == "in_zx":
                t = self._zx(self._use(path, rows[r], whole=False))
                self.meter.add(t)
            else:
                t = self._use(path, rows[r], whole=keys[0] in tp and not split)
            _set(out, keys, t)
        if tp["mixer"]:
            mixer = self.cfg.pattern[i] if stack == "dec" else \
                self.cfg.enc_pattern[i]
            if mixer.mixer == "ssm":
                self._local_ssm(out["mixer"])
            else:
                self._local_attention(out["mixer"], pre + "mixer/")
        return out

    def _local_attention(self, p: dict, pre: str) -> None:
        """Set ``kv_index`` for the rank's query heads; slice a replicated
        wk / wv to the kv heads they read (train)."""
        a = self.cfg.attn
        h_l = p["wq"].shape[1]
        groups = h_l * self.tp // a.n_kv_heads
        want = [(self.tp_rank * h_l + j) // groups for j in range(h_l)]
        dev = p["wq"].device
        if self._split_on_model(pre + "wk", 2):
            base = self.tp_rank * p["wk"].shape[1]
        elif self.mode == "train":
            base, hi = want[0], want[-1] + 1
            p["wk"], p["wv"] = p["wk"][:, base:hi], p["wv"][:, base:hi]
        else:
            base = 0
        p["kv_index"] = torch.tensor([w - base for w in want], device=dev)

    def _local_ssm(self, p: dict) -> None:
        """Slice ``in_bcdt``'s dt columns to the rank's heads."""
        s = self.cfg.ssm
        gds = 2 * s.n_groups * s.d_state
        h_l = p["A_log"].shape[0]
        h0 = self.tp_rank * h_l
        cols = torch.cat([torch.arange(gds), gds + h0 + torch.arange(h_l)])
        p["in_bcdt"] = p["in_bcdt"].index_select(
            1, cols.to(p["in_bcdt"].device))

    def top(self, name: str) -> dict:
        out: dict = {}
        for path, loc in self.leaves.items():
            if path.startswith(name + "/"):
                _set(out, path[len(name) + 1:].split("/"),
                     self._use(path, loc, whole=True, stacked=False))
        return out

    def experts(self, stack: str, i: int):
        if not self.tp_part.get((stack, i, "ffn")):
            return None
        e_l = self.cfg.moe.n_experts // self.tp
        return (self.tp_rank * e_l, (self.tp_rank + 1) * e_l)

    def _seq(self, stack: str, s: int) -> bool:
        """Whether ``stack``'s residual is split over "model" (train, and
        the sequence divides)."""
        self.split[stack] = (self.mode == "train" and self.tp > 1
                             and s % self.tp == 0)
        return self.split[stack]

    def _chunk(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[1] // self.tp
        return x[:, self.tp_rank * n:(self.tp_rank + 1) * n]

    def carry(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        return self._chunk(x) if self._seq(stack, x.shape[1]) else x

    def enter(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        if self.split.get(stack, False):
            return _Gather.apply(x, 1, self._model_group())
        return x

    def exit(self, y: torch.Tensor, stack: str, i: int, part: str
             ) -> torch.Tensor:
        if self.tp_part[stack, i, part]:
            if self.split.get(stack, False):
                return _Scatter.apply(y, 1, self._model_group())
            return _Sum.apply(y, self._model_group())
        return self._chunk(y) if self.split.get(stack, False) else y

    def whole_seq(self, x: torch.Tensor, stack: str) -> torch.Tensor:
        return self.enter(x, stack)

    def window(self, stack: str, i: int) -> Window:
        s0, merge = self.slots.get(f"pos{i}", (0, None))
        heads = (_Heads(self._model_group(), self.tp, self.tp_rank)
                 if self.tp_part[stack, i, "mixer"] else None)
        return Window(s0, merge, heads)

    def cache(self, c, stack: str, i: int):
        if not self.tp_part[stack, i, "mixer"]:
            return c
        group = self._model_group()
        if isinstance(c, SSMState):
            return SSMState(conv_x=all_gather(c.conv_x, 2, group),
                            conv_bc=c.conv_bc,
                            ssd=all_gather(c.ssd, 1, group))
        if self._split_on_model(f"{stack}/pos{i}/mixer/wk", 2):
            return KVCache(k=all_gather(c.k, 2, group),
                           v=all_gather(c.v, 2, group))
        return c

    # ------------------------------------------------------------ vocab
    def _table(self, head: bool) -> str:
        return ("lm_head/table" if head and "lm_head/table" in self.leaves
                else "embed/table")

    def _vocab(self, path: str):
        """(vocabulary split over "model", the rank's first id, row
        chunks ``(c0, c1)`` of its local rows, each gathered no larger
        than the largest block)."""
        loc = self.leaves[path]
        split = self._split_on_model(path, 0)
        v_l = loc.shape[0]
        row = loc[0].numel() * loc.element_size()
        for d in self._gathered_dims(path, whole=False):
            row *= self.mesh.size(d)
        rows = max(1, self.budget // row) if self.budget else v_l
        n = -(-v_l // min(rows, v_l))
        size = -(-v_l // n)
        chunks = [(c, min(c + size, v_l)) for c in range(0, v_l, size)]
        return split, (self.tp_rank * v_l if split else 0), chunks

    def _rows(self, path: str, c0: int, c1: int) -> torch.Tensor:
        return self._use(path, self.leaves[path][c0:c1], whole=False,
                         stacked=False)

    def _lookup(self, model, tokens: torch.Tensor):
        """(the embeddings of ``tokens`` from the rank's vocabulary rows,
        zero elsewhere, in the model's dtype; whether they are partial
        over "model")."""
        path = self._table(head=False)
        split, v0, chunks = self._vocab(path)
        out = None
        for c0, c1 in chunks:
            w = self._rows(path, c0, c1)
            ids = tokens.long() - (v0 + c0)
            hit = (ids >= 0) & (ids < c1 - c0)
            part = torch.where(hit[..., None], w[ids.clamp(0, c1 - c0 - 1)],
                               0)
            out = part if out is None else out + part
        return out.to(model.dtype), split

    def embed(self, model, tokens: torch.Tensor) -> torch.Tensor:
        x, partial = self._lookup(model, tokens)
        return _Sum.apply(x, self._model_group()) if partial else x

    def embed_inputs(self, model, batch) -> torch.Tensor:
        cfg = model.cfg
        x, partial = self._lookup(model, batch["tokens"])
        if cfg.modality is not None and not cfg.encoder_decoder:
            patch = batch["patch_embeds"].to(model.dtype)
            if partial and self.tp_rank:
                patch = torch.zeros_like(patch)
            x = torch.cat([patch, x], dim=1)
        split = self._seq("dec", x.shape[1])
        if partial:
            group = self._model_group()
            return (_Scatter.apply(x, 1, group) if split
                    else _Sum.apply(x, group))
        return self._chunk(x) if split else x

    def _logits(self, x, w, first: int) -> torch.Tensor:
        """``x`` against vocabulary rows ``w`` from id ``first``, ids past
        the vocabulary masked as ``layers.unembed`` masks them."""
        logits = x @ w.to(x.dtype).T
        ids = first + torch.arange(w.shape[0], device=x.device)
        return logits.masked_fill(ids >= self.cfg.vocab_size, -1e9)

    def logits(self, model, x: torch.Tensor) -> torch.Tensor:
        path = self._table(head=True)
        split, v0, chunks = self._vocab(path)
        y = torch.cat([self._logits(x, self._rows(path, c0, c1), v0 + c0)
                       for c0, c1 in chunks], dim=-1)
        return all_gather(y, y.ndim - 1, self._model_group()) if split else y

    def ce(self, model, x: torch.Tensor, labels: torch.Tensor
           ) -> torch.Tensor:
        """The cross-entropy over the whole batch: the vocabulary's max,
        sum of exp and label logit reduced over "model" where it is split
        there, then Σ nll·valid over Σ valid summed over the batch."""
        path = self._table(head=True)
        split, v0, chunks = self._vocab(path)
        seq = self.split.get("dec", False)
        if split:
            x = self.whole_seq(x, "dec")
        elif seq:
            labels = self._chunk(labels)

        def piece(x, c0, c1):
            lg = self._logits(x, self._rows(path, c0, c1), v0 + c0).float()
            ids = labels.long() - (v0 + c0)
            hit = (ids >= 0) & (ids < c1 - c0)
            pick = lg.gather(-1, ids.clamp(0, c1 - c0 - 1)[..., None])[..., 0]
            return torch.logsumexp(lg, dim=-1), torch.where(hit, pick, 0.0)

        remat = self.cfg.remat != "none"
        parts = [checkpoint(piece, x, c0, c1, use_reentrant=False) if remat
                 else piece(x, c0, c1) for c0, c1 in chunks]
        lse = (torch.logsumexp(torch.stack([p[0] for p in parts]), dim=0)
               if len(parts) > 1 else parts[0][0])
        pick = sum(p[1] for p in parts)
        if split:
            group = self._model_group()
            top = all_reduce(lse.detach(), group, "max")
            lse = top + torch.log(_Sum.apply(torch.exp(lse - top), group))
            pick = _Sum.apply(pick, group)
        valid = labels >= 0
        tot = torch.stack([((lse - pick) * valid).sum(), valid.sum().float()])
        if seq and not split:
            tot = _Sum.apply(tot, self._model_group())
        tot = self.group.sum(tot)
        return tot[0] / tot[1].clamp(min=1)

    # ------------------------------------------------------------ grads
    def grads(self, loss: torch.Tensor) -> dict[str, DTensor]:
        """``loss``'s gradient (every rank's seed summing to the global
        objective) as ``DTensor`` s laid out as the parameters: each
        leaf's local gradient summed over the mesh dimensions that
        replicate it."""
        paths = list(self.leaves)
        gs = torch.autograd.grad(loss, [self.leaves[p] for p in paths])
        out = {}
        for path, g in zip(paths, gs):
            for d, p in enumerate(self.pl[path]):
                if isinstance(p, Replicate) and self.mesh.size(d) > 1:
                    g = all_reduce(g, self.mesh.get_group(d))
            out[path] = DTensor.from_local(g, self.mesh, self.pl[path],
                                           run_check=False)
        return out
