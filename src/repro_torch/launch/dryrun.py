"""Multi-pod dry-run: show that the distribution config is coherent without
the hardware, on the CPU.

The counterpart of ``repro.launch.dryrun``. For every (architecture x
applicable shape) cell and both production meshes (single-pod 16x16,
multi-pod 2x16x16), this script, under a fake process group of 256 or 512
ranks (``torch.testing``'s ``FakeStore``: every collective returns at
once, nothing is sent), as rank 0:

  1. builds the model on ``meta`` (shapes without data) and shards its
     parameters, optimizer state, batch and cache by the sharding specs
     (``repro_torch.distributed.sharding``);
  2. runs the port's own sharded step (``repro_torch.distributed.step``)
     on those meta tensors: train, prefill or decode;
  3. records, per device (rank 0, which holds as much as any rank):
     - ``memory.argument_bytes``: the step's arguments, exact, from the
       local shard shapes of parameters, optimizer state, batch and cache;
     - ``memory.gathered_bytes``: the most gathered parameter bytes alive
       at once, counted by the step's gathers (``partition.GatherMeter``;
       the steps gather a block at its use and free it after);
     - ``memory.peak_bytes``: the high-water mark of live tensor storage
       over the step (``LiveBytes``): the arguments, then every storage an
       operation creates, held by a weak reference and dropped from the
       count when freed, summed after each operation; gathered blocks,
       activations, saved carries, gradients and the new optimizer state
       all count, as they would on the card (no allocator rounding, no
       fragmentation, no CUDA workspace); ``temp_bytes`` is ``peak_bytes``
       less the arguments;
     - ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
       step (matmuls, convolutions and attention; the backward and its
       recompute included);
     - ``bytes_accessed``: every aten op's tensor inputs and outputs, in
       bytes, summed op by op as the step runs (XLA's pre-fusion "bytes
       accessed": nothing is fused, views are not counted, collectives
       are counted apart);
     - ``collectives``: the bytes each collective kind moves, from the
       collectives the step issues (DTensor's redistributions, counted as
       they run under the fake group) times the reference's ring
       multipliers (``ring_bytes``), and the same bytes by link
       (``by_link``: a group inside one 8-GPU node takes NVLink, any other
       InfiniBand; ranks are numbered node by node);
  4. writes one JSON per cell under ``results/torch/dryrun/``.

Execution runs every layer, so no loop correction is needed:
``flops_corrected`` / ``bytes_corrected`` equal the counts and the record
says so. A MoE layer's expert products take the balanced load on meta
(no routing to read; ``models.moe._moe_split``). The reference's
``carry_spec`` is the partitioned step's sequence-parallel carry;
``scan_unroll`` and ``no_seq_parallel`` are XLA directives with no
counterpart here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--attn-impl chunked]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.shapes import shapes_for, skipped_shapes_for
from repro_torch.data.synth import batch_shapes
from repro_torch.distributed.sharding import (PSpec, axis_sizes,
                                              batch_pspecs, cache_pspecs,
                                              dp_axes, local_bytes, map_tree,
                                              pad_heads_for, param_pspecs,
                                              shard, shard_tree)
from repro_torch.distributed.step import (make_sharded_decode_step,
                                          make_sharded_prefill_step,
                                          make_sharded_train_step,
                                          shard_opt_state, shard_params)
from repro_torch.interop import flatten
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.builder import init_params
from repro_torch.train.optimizer import make_optimizer

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch" / "dryrun"
#: GPUs a node (an 8-GPU HGX H100 board, joined by NVLink).
GPUS_PER_NODE = 8

# ---------------------------------------------------------------- collectives
#: ``_c10d_functional`` ops -> the reference's collective kinds.
KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all"}


def ring_bytes(kind: str, nbytes: float, n: int) -> float:
    """Bytes a device moves for one collective whose per-device result is
    ``nbytes`` over a group of ``n``: the reference's ring multipliers
    (``repro.launch.dryrun.collective_bytes``)."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "all-gather":
        return nbytes * (n - 1) / n          # result is the gathered size
    if kind == "reduce-scatter":
        return nbytes * (n - 1)              # result is the shard
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    return nbytes                            # collective-permute


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


class StepCounter(TorchDispatchMode):
    """Counts, op by op, the bytes accessed and the collectives of what
    runs under it, on the local tensors: an op on DTensors is left to
    DTensor (``NotImplemented``), whose local ops and redistributions then
    pass through here."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.coll = {k: 0.0 for k in (*KINDS.values(), "collective-permute")}
        self.coll["count"] = 0
        self.by_link = {"nvlink": 0.0, "ib": 0.0}
        self._groups: dict[str, list[int]] = {}

    def _ranks(self, group_name: str) -> list[int]:
        if group_name not in self._groups:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            self._groups[group_name] = dist.get_process_group_ranks(
                _resolve_process_group(group_name))
        return self._groups[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in KINDS:
                ranks = self._ranks(args[-1])
                moved = ring_bytes(KINDS[name], _nbytes(out), len(ranks))
                self.coll[KINDS[name]] += moved
                self.coll["count"] += 1
                nodes = {r // GPUS_PER_NODE for r in ranks}
                self.by_link["nvlink" if len(nodes) == 1 else "ib"] += moved
        elif not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, tuple(kwargs.values()),
                                              (out,))))
        return out

    def collectives(self) -> dict:
        out = dict(self.coll)
        out["total"] = sum(v for k, v in out.items() if k != "count")
        out["by_link"] = dict(self.by_link)
        return out


class LiveBytes(TorchDispatchMode):
    """The high-water mark of live tensor storage over what runs under
    it, on the local tensors (an op on DTensors is left to DTensor, as in
    :class:`StepCounter`). ``seed``: tensors alive before (the step's
    arguments), counted at their own size. Every op's outputs add their
    storage once; a storage leaves the count when its weak reference has
    expired, checked whenever the count would pass the peak (so the
    peak is exact: a count with freed storages in it is only higher).
    DTensor works out an op's output layout by running the op on
    stand-ins of the whole (global) tensors, which on ``meta`` look like
    allocations: ops run while ``paused`` (:func:`dtensor_propagation`)
    are not counted."""

    def __init__(self, seed=()):
        super().__init__()
        self._live: dict[int, tuple] = {}
        self.current = self.peak = self.paused = 0
        for t in seed:
            self._add(t, t.numel() * t.element_size())
        self.peak = self.current

    def _add(self, t: torch.Tensor, nbytes: int | None = None) -> None:
        s = t.untyped_storage()
        key = s._cdata
        old = self._live.get(key)
        if old is not None and not old[0].expired():
            if nbytes is not None:      # another argument on this storage
                self._live[key] = (old[0], old[1] + nbytes)
                self.current += nbytes
            return
        if old is not None:
            self.current -= old[1]
        n = s.nbytes() if nbytes is None else nbytes
        self._live[key] = (StorageWeakRef(s), n)
        self.current += n

    def _sweep(self) -> None:
        for key in [k for k, (w, _) in self._live.items() if w.expired()]:
            self.current -= self._live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self.paused:
            return out
        for t in _tensors((out,)):
            self._add(t)
        if self.current > self.peak:   # freed storages may still count
            self._sweep()
            self.peak = max(self.peak, self.current)
        return out


@contextlib.contextmanager
def dtensor_propagation(live: LiveBytes):
    """Pause ``live`` while DTensor's sharding propagator runs an op on
    global stand-ins (``ShardingPropagator._propagate_tensor_meta*``,
    where this release of torch has them)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta",
                         "_propagate_tensor_meta_non_cached")
             if hasattr(ShardingPropagator, n)]
    saved = {n: getattr(ShardingPropagator, n) for n in names}

    def paused(fn):
        def run(*args, **kwargs):
            live.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                live.paused -= 1
        return run

    for n in names:
        setattr(ShardingPropagator, n, paused(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _locals(tree) -> list[torch.Tensor]:
    """The local tensors of a tree of (D)tensors (a tuple of trees counts
    each)."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return [t for part in tree for t in _locals(part)]
    out: list = []
    map_tree(lambda t: out.append(t.to_local() if isinstance(t, DTensor)
                                  else t)
             if isinstance(t, torch.Tensor) else None, tree)
    return out


@contextlib.contextmanager
def fake_world(multi_pod: bool):
    """A fake process group of the production mesh's size, this process
    its rank 0, and the mesh over it; torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    if dist.is_initialized():
        raise RuntimeError("a process group is up already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- cells
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: str, shape_name: str, mesh, attn_impl: str | None = None):
    """(run, arguments, step) for one cell on ``mesh``: ``run()`` runs
    the sharded step on the meta arguments and returns its outputs;
    ``step`` is the step function (its ``meter`` counts the gathered
    bytes)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if attn_impl is None:
        attn_impl = "chunked" if shape.kind == "prefill" else "naive"
    pad = pad_heads_for(cfg, mesh)
    tree = init_params(cfg, torch.Generator(), device="meta", pad_heads=pad)
    model = build_model(cfg, flatten(tree), pad_heads=pad,
                        attn_impl=attn_impl, device="meta")
    model.to(torch.bfloat16 if cfg.optimizer_mode == "adafactor"
             else torch.float32)
    full = model.param_tree()
    specs = param_pspecs(cfg, full, mesh)
    params = shard_params(full, specs, mesh)

    if shape.kind in ("train", "prefill"):
        shapes = batch_shapes(cfg, shape.global_batch, shape.seq_len)
        batch = shard_tree({k: _meta(s, dt) for k, (s, dt) in shapes.items()},
                           batch_pspecs(cfg, mesh, shape), mesh)
        if shape.kind == "prefill":
            step = make_sharded_prefill_step(model, mesh)
            return lambda: step(params, batch), (params, batch), step
        opt = make_optimizer(cfg.optimizer_mode)
        state = shard_opt_state(opt, full, specs, mesh)
        step = make_sharded_train_step(model, opt, mesh, specs)
        return (lambda: step(params, state, batch, 0), (params, state, batch),
                step)

    # decode: one new token against a cache of seq_len
    b = shape.global_batch
    enc_len = shape.seq_len if cfg.encoder_decoder else 0
    cache = shard_tree(model.init_cache(b, shape.seq_len, enc_len=enc_len),
                       cache_pspecs(cfg, mesh, b), mesh)
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh, cfg.pure_dp)
    dp_sz = 1
    for a in dp:
        dp_sz *= sizes[a]
    tok_spec = PSpec(dp, None) if b % dp_sz == 0 else PSpec(None, None)
    tokens = shard(_meta((b, 1), torch.int32), tok_spec, mesh)
    step = make_sharded_decode_step(model, mesh)
    return (lambda: step(params, tokens, cache, shape.seq_len),
            (params, tokens, cache), step)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             attn_impl: str | None = None, save: bool = True) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "ok": False}
    try:
        with fake_world(multi_pod) as mesh:
            run, arguments, step = build_cell(arch, shape_name, mesh,
                                              attn_impl)
            t_build = time.time() - t0
            counter = StepCounter()
            live = LiveBytes(_locals(arguments))
            with FlopCounterMode(display=False) as flop_counter, counter, \
                    live, dtensor_propagation(live):
                outputs = run()
            flops = float(flop_counter.get_total_flops())
            n_dev = mesh.size()
            args_b = local_bytes(arguments)
            rec.update(
                ok=True, build_s=round(t_build, 1),
                run_s=round(time.time() - t0 - t_build, 1),
                flops=flops, bytes_accessed=float(counter.bytes_accessed),
                flops_corrected=flops,
                bytes_corrected=float(counter.bytes_accessed),
                loop_correction="none: the step runs every layer",
                collectives=counter.collectives(),
                n_devices=n_dev,
                memory=dict(argument_bytes=args_b,
                            gathered_bytes=step.meter.peak,
                            output_bytes=local_bytes(outputs),
                            temp_bytes=live.peak - args_b,
                            peak_bytes=live.peak,
                            generated_code_bytes=None),
                attn_impl=attn_impl or ("chunked" if SHAPES[shape_name].kind
                                        == "prefill" else "naive"),
            )
        print(f"[dryrun] OK  {arch:28s} {shape_name:12s} {mesh_name:8s} "
              f"build={rec['build_s']:5.1f}s run={rec['run_s']:6.1f}s "
              f"flops={rec['flops']:.3e} "
              f"coll={rec['collectives']['total']:.3e}B "
              f"peak={rec['memory']['peak_bytes']:.3e}B "
              f"gathered={rec['memory']['gathered_bytes']:.3e}B")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] FAIL {arch} {shape_name} {mesh_name}: {rec['error']}")
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        (RESULTS / f"{arch}_{shape_name}_{mesh_name}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            cells.append((arch, shape.name))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--attn-impl", type=str, default=None,
                    choices=(None, "naive", "chunked"))
    args = ap.parse_args(argv)

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    if args.all:
        ok = fail = 0
        for arch, shape in all_cells():
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.attn_impl)
                ok += rec["ok"]
                fail += not rec["ok"]
        # document the skips
        for arch in list_archs():
            for sname, why in skipped_shapes_for(get_config(arch)):
                print(f"[dryrun] SKIP {arch} {sname}: {why}")
        print(f"[dryrun] done: {ok} ok, {fail} failed")
        raise SystemExit(1 if fail else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    for mp in meshes:
        rec = run_cell(args.arch, args.shape, mp, args.attn_impl)
        if not rec["ok"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
