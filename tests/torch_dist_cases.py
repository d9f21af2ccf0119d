"""Multi-rank cases of the port's distributed stack: one process a rank.

  python tests/torch_dist_cases.py RANK WORLD INIT_FILE OUT_DIR DEVICE CASE...

Every rank runs the named cases over a gloo process group (rendezvous on
``INIT_FILE``, a path no other job uses) on ``DEVICE``; rank 0 writes
``OUT_DIR/<case>.json`` and the arrays beside it (``<case>.npz``). Each
case holds the sharded result against the port's single-rank result on
the same device and inputs, and records the difference; the CPU tests
(``tests/test_torch_distributed.py``) also hold the arrays against the JAX
package, ``chip_smoke.py`` runs the cases on the card. The mesh is 2 x
WORLD/2 ("data", "model"); ``collective_matmul`` and ``compressed_mean``
take a 1-D mesh of every rank. Imports the port only, never JAX.

  train_adamw     phi3-mini-3.8b reduced(64), AdamW, B 8 x 32, two steps
                  (no warmup, so the first step's learning rate is not 0)
  train_adafactor mamba2-780m reduced(64), Adafactor, B 8 x 32, two steps
  train_accum     train_adamw's steps with grad_accum 2 on both sides
  train_jamba ... train_smollm  the same two steps for jamba (SSM, MoE,
                  attention with one kv head), moonshot (MoE, kv heads
                  split over "model"), seamless (encoder, cross-attention),
                  internvl2 (patches, 2 kv heads over 4 ranks), llama4
                  (MoE with attention, Adafactor) and smollm (pure_dp)
  grads           every leaf's gradient of one sharded step (reduce-
                  scattered, gathered) against the single rank's, for
                  each train case's architecture
  decode          phi3-mini-3.8b reduced(64): the sharded prefill of B 4 x
                  16 against the single rank's (logits, cache), then the
                  self-attention cache padded to 32 slots, laid out by
                  ``cache_pspecs`` (sequence over "model") and one sharded
                  decode step at cur_len 16; ``decode_jamba``,
                  ``decode_seamless`` (cross-attention over the encoder's
                  slots) and ``decode_moonshot`` (MoE, kv heads over
                  "model") the same; ``decode_batch1`` jamba at B 1 (the
                  batch replicated, the sequence over "data" and "model"),
                  cur_len a [] tensor; ``decode_rows`` phi3 at a [B]
                  cur_len whose rows fall in different windows, one at
                  S_max (``DECODE_ROWS``)
  cmm             collective_matmul of x [8 WORLD, 32] @ w [32, 48]
  cmean           compressed_mean of x [WORLD, 1024] and 30 error-feedback
                  rounds
  elastic         a checkpoint saved on 2 x WORLD/2, restored onto
                  WORLD/2 x 2
  ckpt_sync       every rank's CheckpointManager on one directory, rank
                  0's writer slowed: latest_step / restore after async
                  saves see rank 0's last save on every rank
"""
from __future__ import annotations

import datetime
import json
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

#: Tolerances (the reference's tests/test_distributed.py): a sharded
#: step's loss and gradient norm (rtol = atol) and parameters (rtol =
#: atol), the decode step's logits and the collective matmul (rtol =
#: atol). ``state``: an optimizer-state leaf (AdamW's m / v, Adafactor's
#: row / col / full) within this fraction of the leaf's largest entry;
#: its entries span decades (v is a squared gradient), so a bound on each
#: entry alone would say nothing of the small ones. ``grad``: every
#: gradient entry (rtol = atol).
TOLS = dict(loss=1e-5, param=5e-4, decode=2e-4, cmm=2e-4, state=1e-4,
            grad=1e-5)
#: Seeds of the cases' inputs (numpy), shared with the tests' JAX side.
SEEDS = dict(params=0, batch=1, decode=2, cmm=3, cmean=4)
#: case -> (arch, optimizer, grad_accum)
TRAIN = {"train_adamw": ("phi3-mini-3.8b", "adamw", 1),
         "train_adafactor": ("mamba2-780m", "adafactor", 1),
         "train_accum": ("phi3-mini-3.8b", "adamw", 2),
         "train_jamba": ("jamba-v0.1-52b", "adamw", 1),
         "train_moonshot": ("moonshot-v1-16b-a3b", "adamw", 1),
         "train_seamless": ("seamless-m4t-large-v2", "adamw", 1),
         "train_internvl2": ("internvl2-2b", "adamw", 1),
         "train_llama4": ("llama4-maverick-400b-a17b", "adafactor", 1),
         "train_smollm": ("smollm-135m", "adamw", 1)}
#: Cases whose optimizer state is held after the first step, not the
#: second. jamba's first AdamW update moves entries whose gradients are at
#: the level of rounding (1e-9 against a gradient norm of 24) by up to
#: 6.5e-5, since Adam divides each by its own root mean square; so its
#: second step's state differs by more than ``TOLS["state"]`` between any
#: two float32 runs: the port's single rank against the reference by 1.42
#: of it, the single rank against itself after a relative perturbation of
#: 1e-7 of its weights by 1.82 (the case's loss, gradient norm and
#: parameters stay within their tolerances after both steps).
STATE_AFTER_FIRST = ("train_jamba",)
#: The decode cases: (architecture, batch, cur_len: "int" the prompt's
#: length, "scalar" the same as a [] tensor, "rows" ``DECODE_ROWS``).
DECODES = {"decode": ("phi3-mini-3.8b", 4, "int"),
           "decode_jamba": ("jamba-v0.1-52b", 4, "int"),
           "decode_seamless": ("seamless-m4t-large-v2", 4, "int"),
           "decode_moonshot": ("moonshot-v1-16b-a3b", 4, "int"),
           "decode_batch1": ("jamba-v0.1-52b", 1, "scalar"),
           "decode_rows": ("phi3-mini-3.8b", 4, "rows")}
#: ``decode_rows``' cur_len, a row each, of the 32 slots: in the first,
#: second and last window on 4 "model" ranks (first, first and second on
#: 2), and S_max itself, where nothing is written.
DECODE_ROWS = (3, 12, 27, 32)
#: The train cases' steps: batch s draws from seed ``SEEDS["batch"] + s``;
#: ``warmup`` 0 puts the first step at the full learning rate (the
#: default warmup of 200 gives step 0 a rate of 0: parameters that never
#: move).
TRAIN_SHAPE = dict(batch=8, seq=32, lr=1e-3, warmup=0, steps=2)
DECODE = dict(arch="phi3-mini-3.8b", batch=4, prompt=16, pad=16, token=7)
CMM_SHAPE = dict(k=32, n=48, rows_per_rank=8)
CMEAN = dict(width=1024, rounds=30)


def reduced(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(64)


def cmm_inputs(world: int):
    rng = np.random.default_rng(SEEDS["cmm"])
    x = rng.standard_normal((CMM_SHAPE["rows_per_rank"] * world,
                             CMM_SHAPE["k"]), dtype=np.float32)
    w = rng.standard_normal((CMM_SHAPE["k"], CMM_SHAPE["n"]),
                            dtype=np.float32)
    return x, w


def cmean_input(world: int):
    return np.random.default_rng(SEEDS["cmean"]).standard_normal(
        (world, CMEAN["width"]), dtype=np.float32)


def serial_ring(x: torch.Tensor) -> torch.Tensor:
    """``int8_ring_allreduce`` of every row of x [n, ...] played out in one
    process, hop by hop, with the port's own quantization and
    accumulation: row d is what rank d's call returns."""
    from repro_torch.distributed.compression import (_accumulate, _dequant,
                                                     _quant)

    n = x.shape[0]
    acc = [x[d].reshape(-1).to(torch.float32).clone() for d in range(n)]
    pad = (-acc[0].numel()) % n
    acc = [F.pad(a, (0, pad)).reshape(n, -1) for a in acc]
    for i in range(n - 1):
        sent = [_quant(acc[d][(d - i) % n]) for d in range(n)]
        for d in range(n):
            q, s = sent[(d - 1) % n]
            r = (d - i - 1) % n
            acc[d][r] = _accumulate(acc[d][r], q, s)
    out = [torch.zeros_like(a) for a in acc]
    cur = []
    for d in range(n):
        own = (d + 1) % n
        out[d][own] = acc[d][own] / n
        cur.append((out[d][own], own))
    for _ in range(n - 1):
        sent = [_quant(c) for c, _ in cur]
        cur = [(_dequant(*sent[(d - 1) % n]), (cur[d][1] - 1) % n)
               for d in range(n)]
        for d in range(n):
            out[d][cur[d][1]] = cur[d][0]
    return torch.stack([o.reshape(-1)[:x[0].numel()].reshape(x[0].shape)
                        for o in out]).to(x.dtype)


def replica_mismatches(tree) -> int:
    """Leaves whose shards differ between ranks that hold the same shard
    (the ranks a leaf is replicated over); every rank takes part."""
    from repro_torch.tree import leaves

    bad = 0
    for t in leaves(tree):
        mesh = t.device_mesh
        key = tuple(int(c) if isinstance(p, Shard) else -1
                    for c, p in zip(mesh.get_coordinate(), t.placements))
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (key, t.to_local().detach().cpu()))
        first: dict = {}
        for k, local in got:
            if k in first and not torch.equal(first[k], local):
                bad += 1
                break
            first.setdefault(k, local)
    return bad


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu()
    return torch.from_numpy(np.array(x, dtype=np.float64))


def max_rel(a, b, tol: float) -> float:
    """max |a - b| / (tol (1 + |b|)): at most 1 within rtol = atol = tol."""
    a, b = _f64(a), _f64(b)
    return float(((a - b).abs() / (tol * (1 + b.abs()))).max())


def state_err(a, b) -> float:
    """max |a - b| / (``TOLS["state"]`` max |b|): at most 1 within the
    state tolerance."""
    a, b = _f64(a), _f64(b)
    return float((a - b).abs().max()
                 / (TOLS["state"] * max(float(b.abs().max()), 1e-30)))


def train_batch(cfg, step: int, device: str) -> dict:
    from repro_torch.data.synth import make_batch
    return make_batch(cfg, TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"],
                      seed=SEEDS["batch"] + step, dtype=torch.float32,
                      device=device)


def case_train(name: str, world: int, device: str) -> tuple[dict, dict]:
    """``TRAIN_SHAPE["steps"]`` sharded steps against as many single-rank
    steps: loss and gradient norm of each step, then the parameters and
    the optimizer state. The arrays: the parameters by path, the state as
    ``opt/<path>``."""
    from repro_torch import interop
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import (batch_pspecs, gather_tree,
                                                  param_pspecs, shard_tree)
    from repro_torch.distributed.step import (make_sharded_train_step,
                                              shard_opt_state, shard_params)
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves_with_paths

    arch, mode, accum = TRAIN[name]
    cfg = reduced(arch)
    tree = interop.numpy_reference_params(cfg, SEEDS["params"])
    b, s = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
    steps = range(TRAIN_SHAPE["steps"])
    opt = make_optimizer(mode, lr=TRAIN_SHAPE["lr"],
                         warmup=TRAIN_SHAPE["warmup"])

    def model():
        return build_model(cfg, interop.params_from_reference(cfg, tree),
                           dtype=torch.float32, device=device)

    m1 = model()
    step1 = make_train_step(m1, opt, accum)
    p1, s1 = m1.param_tree(), opt.init(m1.param_tree())
    p0 = {k: v.detach().clone() for k, v in leaves_with_paths(p1)}
    met1 = []
    for t in steps:
        p1, s1, m = step1(p1, s1, train_batch(cfg, t, device), t)
        met1.append(m)
        if t == 0:
            first_s = {k: v.clone() for k, v in leaves_with_paths(s1)}

    mesh = init_device_mesh(device.split(":")[0], (2, world // 2),
                            mesh_dim_names=("data", "model"))
    m2 = model()
    full = m2.param_tree()
    specs = param_pspecs(cfg, full, mesh)
    p2 = shard_params(full, specs, mesh)
    s2 = shard_opt_state(opt, full, specs, mesh)
    bspecs = batch_pspecs(cfg, mesh, ShapeSpec("t", s, b, "train"))
    step2 = make_sharded_train_step(m2, opt, mesh, specs, accum)
    met2, bad = [], 0
    for t in steps:
        p2, s2, m = step2(p2, s2, shard_tree(train_batch(cfg, t, device),
                                             bspecs, mesh), t)
        met2.append(m)
        bad += replica_mismatches(p2) + replica_mismatches(s2)
        if t == 0:      # a replicated leaf's whole is its shard, updated in place
            got_first = {k: v.detach().clone()
                         for k, v in leaves_with_paths(gather_tree(s2))}
    got = dict(leaves_with_paths(gather_tree(p2)))
    want = dict(leaves_with_paths(p1))
    got_s = dict(leaves_with_paths(gather_tree(s2)))
    want_s = dict(leaves_with_paths(s1))
    res = dict(loss_single=[float(m["loss"]) for m in met1],
               loss=[float(m["loss"]) for m in met2],
               grad_norm_single=[float(m["grad_norm"]) for m in met1],
               grad_norm=[float(m["grad_norm"]) for m in met2],
               loss_err=max(max_rel(x["loss"], y["loss"], TOLS["loss"])
                            for x, y in zip(met2, met1)),
               grad_norm_err=max(max_rel(x["grad_norm"], y["grad_norm"],
                                         TOLS["loss"])
                                 for x, y in zip(met2, met1)),
               param_err=max(max_rel(got[k], want[k], TOLS["param"])
                             for k in want),
               params_moved=max(float((want[k] - p0[k]).abs().max())
                                for k in want),
               state_err=max(state_err(got_s[k], want_s[k]) for k in want_s),
               state_leaf=max(want_s, key=lambda k: state_err(got_s[k],
                                                             want_s[k])),
               state_err_first=max(state_err(got_first[k], first_s[k])
                                   for k in first_s),
               state_leaves=len(want_s) if set(got_s) == set(want_s) else -1,
               replica_mismatches=bad, leaves=len(want))
    arrays = {k: v.detach().cpu().numpy() for k, v in got.items()}
    arrays.update({f"opt/{k}": v.detach().cpu().numpy()
                   for k, v in got_s.items()})
    arrays.update({f"opt1/{k}": v.detach().cpu().numpy()
                   for k, v in got_first.items()})
    return res, arrays


def block_bytes(cfg, mesh, whole: bool) -> int:
    """Bytes of the largest block's leaves (one repeat of one pattern
    position, fp32) as a rank gathers them: split over "model" where the
    spec splits them (``whole``: every leaf whole)."""
    from repro_torch.distributed.sharding import param_pspecs
    from repro_torch.models.builder import init_params
    from repro_torch.tree import leaves_with_paths

    tree = init_params(cfg, torch.Generator(), device="meta")
    specs = dict(leaves_with_paths(param_pspecs(cfg, tree, mesh)))
    tp = mesh.size(list(mesh.mesh_dim_names).index("model"))
    sizes: dict = {}
    for path, leaf in leaves_with_paths(tree):
        if path.startswith(("dec/", "enc/")):
            n = leaf[0].numel() * 4
            if not whole and "model" in specs[path]:
                n //= tp
            key = tuple(path.split("/")[:2])
            sizes[key] = sizes.get(key, 0) + n
    return max(sizes.values())


def decode_inputs(name: str, cache: dict, device: str):
    """(the case's tokens [B, 1], cur_len, the prefill ``cache`` with its
    self-attention positions padded to ``prompt + pad`` slots)."""
    from repro_torch.models.attention import KVCache

    cfg = reduced(DECODES[name][0])
    b, kind = DECODES[name][1:]
    cache = {k: KVCache(*(F.pad(a, (0, 0, 0, 0, 0, DECODE["pad"]))
                          for a in c))
             if cfg.pattern[int(k[3:])].mixer == "attn" else c
             for k, c in cache.items()}
    tok = torch.full((b, 1), DECODE["token"], dtype=torch.int32,
                     device=device)
    cur = {"int": DECODE["prompt"],
           "scalar": torch.tensor(DECODE["prompt"], device=device),
           "rows": torch.tensor(DECODE_ROWS, device=device)}[kind]
    return tok, cur, cache


def case_decode(name: str, world: int, device: str) -> tuple[dict, dict]:
    """The sharded prefill against the single rank's, then one sharded
    decode step on the cache as ``cache_pspecs`` lays it out against the
    single rank's ``decode_step``; the gathered parameter bytes, the
    leaves gathered over "model" and the cache leaves redistributed. The
    arrays: both steps' logits and the decode's inputs (tokens, cur_len,
    ``cache/<pos>/<field>``)."""
    from repro_torch import interop
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.synth import make_batch
    from repro_torch.distributed.sharding import (PSpec, batch_pspecs,
                                                  cache_pspecs, gather,
                                                  param_pspecs, shard,
                                                  shard_tree)
    from repro_torch.distributed.step import (make_sharded_decode_step,
                                              make_sharded_prefill_step,
                                              shard_params)
    from repro_torch.models import build_model
    from repro_torch.models.attention import KVCache

    arch, b, _ = DECODES[name]
    cfg = reduced(arch)
    tree = interop.numpy_reference_params(cfg, SEEDS["params"])

    def model():
        return build_model(cfg, interop.params_from_reference(cfg, tree),
                           dtype=torch.float32, device=device)

    m1 = model()
    batch = make_batch(cfg, b, DECODE["prompt"], seed=SEEDS["decode"],
                       dtype=torch.float32, device=device)
    pre_ref, cache = m1.prefill(batch)
    mesh = init_device_mesh(device.split(":")[0], (2, world // 2),
                            mesh_dim_names=("data", "model"))
    m2 = model()
    full = m2.param_tree()
    params = shard_params(full, param_pspecs(cfg, full, mesh), mesh)
    prefill = make_sharded_prefill_step(m2, mesh)
    pre, pre_cache = prefill(params, shard_tree(
        batch, batch_pspecs(cfg, mesh, ShapeSpec("p", DECODE["prompt"], b,
                                                 "prefill")), mesh))
    pre_cache_err = max(max_rel(gather(n), r, TOLS["decode"]) for n, r in zip(
        (x for c in pre_cache.values() for x in c),
        (x for c in cache.values() for x in c)))

    tok, cur, cache = decode_inputs(name, cache, device)
    ref, ref_cache = m1.decode_step(tok, cache, cur)
    cache_sh = shard_tree(cache, cache_pspecs(cfg, mesh, b), mesh)
    decode = make_sharded_decode_step(m2, mesh)
    moved = []
    redistribute = DTensor.redistribute
    DTensor.redistribute = lambda t, *a, **k: (moved.append(t),
                                               redistribute(t, *a, **k))[1]
    try:
        out, new = decode(params, shard(tok, PSpec("data" if b > 1 else None,
                                                   None), mesh),
                          cache_sh, cur)
    finally:
        DTensor.redistribute = redistribute
    leaves_in = [x for c in cache_sh.values() for x in c]
    logits = gather(out)
    cache_err = max(max_rel(gather(n), r, TOLS["decode"]) for n, r in zip(
        (x for c in new.values() for x in c),
        (x for c in ref_cache.values() for x in c)))
    res = dict(logits_err=max_rel(logits, ref, TOLS["decode"]),
               cache_err=cache_err,
               prefill_logits_err=max_rel(gather(pre), pre_ref,
                                          TOLS["decode"]),
               prefill_cache_err=pre_cache_err,
               cache_layout_kept=all(
                   n.placements == c.placements for n, c in zip(
                       (x for c in new.values() for x in c), leaves_in)),
               cache_redistributes=sum(any(t is x for x in leaves_in)
                                       for t in moved),
               kv_placements=[str(p) for p in next(
                   c.k for c in cache_sh.values()
                   if isinstance(c, KVCache)).placements],
               prefill_gathered=prefill.meter.peak,
               decode_gathered=decode.meter.peak,
               decode_model_gathers=decode.meter.over_model,
               block_bytes=block_bytes(cfg, mesh, whole=False),
               whole_block_bytes=block_bytes(cfg, mesh, whole=True))
    arrays = {"logits": logits.cpu().numpy(),
              "logits_single": ref.cpu().numpy(),
              "tokens": tok.cpu().numpy(),
              "cur_len": np.asarray(torch.as_tensor(cur).cpu())}
    arrays.update({f"cache/{k}/{f}": a.cpu().numpy() for k, c in cache.items()
                   for f, a in c._asdict().items()})
    return res, arrays


def case_grads(world: int, device: str) -> tuple[dict, dict]:
    """One sharded step's gradients (``train_step.grads``, gathered)
    against the single rank's (``train.step.value_and_grad``) on the same
    batch, for each train case's architecture: {arch: the largest
    ``max_rel`` over the leaves at ``TOLS["grad"]``, its leaf, the leaves
    compared}."""
    from repro_torch import interop
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import (batch_pspecs, gather,
                                                  param_pspecs, shard_tree)
    from repro_torch.distributed.step import (make_sharded_train_step,
                                              shard_params)
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.step import value_and_grad

    mesh = init_device_mesh(device.split(":")[0], (2, world // 2),
                            mesh_dim_names=("data", "model"))
    b, s = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
    res = {}
    for arch in dict.fromkeys(a for a, _, _ in TRAIN.values()):
        cfg = reduced(arch)
        tree = interop.numpy_reference_params(cfg, SEEDS["params"])
        model = build_model(cfg, interop.params_from_reference(cfg, tree),
                            dtype=torch.float32, device=device)
        batch = train_batch(cfg, 0, device)
        model.requires_grad_(True)
        _, _, want = value_and_grad(model, batch)
        model.requires_grad_(False)
        full = model.param_tree()
        specs = param_pspecs(cfg, full, mesh)
        step = make_sharded_train_step(model, make_optimizer("adamw"), mesh,
                                       specs)
        _, _, got = step.grads(shard_params(full, specs, mesh), shard_tree(
            batch, batch_pspecs(cfg, mesh, ShapeSpec("t", s, b, "train")),
            mesh))
        errs = {k: max_rel(gather(got[k]), w, TOLS["grad"])
                for k, w in want.items()}
        worst = max(errs, key=errs.get)
        res[arch] = dict(err=errs[worst], leaf=worst, leaves=len(errs),
                         same_leaves=set(got) == set(want))
    return res, {}


def case_cmm(world: int, device: str) -> tuple[dict, dict]:
    from repro_torch.distributed.collective_matmul import collective_matmul

    mesh = init_device_mesh(device.split(":")[0], (world,),
                            mesh_dim_names=("model",))
    x, w = (torch.from_numpy(a).to(device) for a in cmm_inputs(world))
    y = collective_matmul(x, w, mesh, axis="model")
    return dict(err=max_rel(y, x @ w, TOLS["cmm"])), {"y": y.cpu().numpy()}


def case_cmean(world: int, device: str) -> tuple[dict, dict]:
    from repro_torch.distributed.compression import (compressed_mean,
                                                     ef_compress_update)
    from repro_torch.distributed.sharding import gather, rows_over

    mesh = init_device_mesh(device.split(":")[0], (world,),
                            mesh_dim_names=("pod",))
    x = torch.from_numpy(cmean_input(world)).to(device)
    out = gather(compressed_mean(x, mesh, axis="pod"))
    want = x.mean(0).expand_as(x)
    scale = float(x.abs().max()) / 127
    grads = {"w": rows_over(x, mesh, "pod")}
    residual = {"w": rows_over(torch.zeros_like(x), mesh, "pod")}
    acc = torch.zeros_like(x)
    for _ in range(CMEAN["rounds"]):
        synced, residual = ef_compress_update(grads, residual, mesh, "pod")
        acc = acc + gather(synced["w"])
    ef = acc / CMEAN["rounds"]
    res = dict(err_over_scale=float((out - want).abs().max()) / scale,
               ef_err_over_scale=float((ef - want).abs().max()) / scale,
               serial_equal=bool(torch.equal(out, serial_ring(x))))
    return res, {"out": out.cpu().numpy(), "ef_mean": ef.cpu().numpy()}


def case_elastic(world: int, device: str, out_dir: pathlib.Path
                 ) -> tuple[dict, dict]:
    from repro_torch import interop
    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    from repro_torch.distributed.sharding import (gather_tree, param_pspecs,
                                                  shard_tree)
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = reduced(DECODE["arch"])
    tree = interop.numpy_reference_params(cfg, SEEDS["params"])
    params = build_model(cfg, interop.params_from_reference(cfg, tree),
                         dtype=torch.float32, device=device).param_tree()
    kind = device.split(":")[0]
    mesh_a = init_device_mesh(kind, (2, world // 2),
                              mesh_dim_names=("data", "model"))
    specs_a = param_pspecs(cfg, params, mesh_a)
    ckpt = out_dir / "elastic_ckpt"
    save_checkpoint(ckpt, 3, shard_tree(params, specs_a, mesh_a),
                    pspecs=specs_a)
    dist.barrier()
    step, restored, _ = load_checkpoint(ckpt, template=params)
    mesh_b = init_device_mesh(kind, (world // 2, 2),
                              mesh_dim_names=("data", "model"))
    specs_b = param_pspecs(cfg, params, mesh_b)
    resharded = gather_tree(shard_tree(restored, specs_b, mesh_b))
    _, onto, _ = load_checkpoint(ckpt, template=shard_tree(params, specs_b,
                                                           mesh_b))
    onto_b = all(isinstance(t, DTensor) and t.device_mesh == mesh_b
                 for t in leaves(onto))
    onto = gather_tree(onto)
    want = dict(leaves_with_paths(params))
    equal = all(torch.equal(v, want[k]) for k, v in
                leaves_with_paths(resharded)) and all(
        torch.equal(v, want[k]) for k, v in leaves_with_paths(onto))
    from repro_torch.launch.mesh import make_host_mesh
    return dict(step=step, equal=equal, template_layout=onto_b,
                host_mesh=list(make_host_mesh(kind).shape),
                manifest=str(ckpt / "step_000003" / "manifest.json")), {}


def case_ckpt_sync(world: int, device: str, out_dir: pathlib.Path
                   ) -> tuple[dict, dict]:
    import time

    from repro_torch.checkpoint import manager

    save = manager.save_checkpoint
    if dist.get_rank() == 0:
        def slow_save(*args, **kwargs):
            time.sleep(1.0)
            return save(*args, **kwargs)
        manager.save_checkpoint = slow_save
    try:
        mgr = manager.CheckpointManager(str(out_dir / "sync_ckpt"), keep=2)
        pruned = []
        gc = mgr._gc
        mgr._gc = lambda: (pruned.append(1), gc())
        tree = {"w": torch.arange(6.0, device=device)}
        for step in (1, 2, 3):
            mgr.save(step, {"w": tree["w"] * step})
        latest = mgr.latest_step()
        _, restored, _ = mgr.restore(tree)
        mgr.wait()
    finally:
        manager.save_checkpoint = save
    mine = dict(latest=latest, pruned=len(pruned),
                equal=bool(torch.equal(restored["w"], tree["w"] * 3)))
    every = [None] * world
    dist.all_gather_object(every, mine)
    return dict(ranks=every), {}


def run_ranks(world: int, out_dir, device: str, cases: list[str],
              timeout: float = 300) -> dict:
    """Run ``cases`` on ``world`` ranks, each a child process of this
    script, and return {case: rank 0's JSON}. Kills every rank and raises
    with their output when one fails or the time runs out."""
    import subprocess

    out_dir = pathlib.Path(out_dir).resolve()   # a file:// URL's path
    out_dir.mkdir(parents=True, exist_ok=True)
    init = out_dir / "pg_init"
    init.unlink(missing_ok=True)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(src))
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world),
                               str(init), str(out_dir), device, *cases],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    if rcs is None or any(rcs):
        tails = "\n".join(f"--- rank {r} ---\n"
                          + (out_dir / f"rank{r}.log").read_text()[-3000:]
                          for r in range(world))
        raise RuntimeError(f"ranks failed (exit codes {rcs}):\n{tails}")
    return {c: json.loads((out_dir / f"{c}.json").read_text())
            for c in cases}


def main(argv: list[str]) -> None:
    rank, world = int(argv[0]), int(argv[1])
    init, out_dir, device = argv[2], pathlib.Path(argv[3]), argv[4]
    cases = argv[5:]
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for case in cases:
            if case in TRAIN:
                res, arrays = case_train(case, world, device)
            elif case == "elastic":
                res, arrays = case_elastic(world, device, out_dir)
            elif case == "ckpt_sync":
                res, arrays = case_ckpt_sync(world, device, out_dir)
            elif case in DECODES:
                res, arrays = case_decode(case, world, device)
            else:
                res, arrays = {"grads": case_grads, "cmm": case_cmm,
                               "cmean": case_cmean}[case](world, device)
            if rank == 0:
                (out_dir / f"{case}.json").write_text(json.dumps(
                    dict(res, world=world, device=device)))
                np.savez(out_dir / f"{case}.npz", **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    main(sys.argv[1:])
