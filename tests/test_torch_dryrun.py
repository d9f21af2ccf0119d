"""The port's dry-run and roofline against the JAX package, on the CPU.

``ring_bytes`` gives the reference's ``collective_bytes`` on HLO lines
written for the same collectives (each kind, group sizes 2 to 512, both
``replica_groups`` syntaxes); ``model_flops`` equals the reference's for
every architecture and shape; ``analyze`` is held to a hand count with the
H100 constants on a synthetic record. One full-width cell, mamba2-780m
``train_4k`` on the 16x16 mesh, runs in a subprocess under a fake process
group of 256 ranks: ``ok``, argument bytes equal to a count from the
reference's own specs (parameters, AdamW's m and v, the batch's rows); the
gathered parameter bytes at most two blocks' leaves as the specs split
them over "model" (the step gathers a block at its use and frees it
after); a peak at least the arguments and the gathered bytes; FLOPs and
collective bytes above zero, the FLOPs low enough that ``useful`` is at
least 8x the 0.049 of the step that computed every layer whole on each
"model" rank. One decode cell, phi3-mini-3.8b ``decode_32k`` on 16x16,
the same way: the cache stays in its ``cache_pspecs`` shards and each
block is split over "model", so the peak is under an 80 GiB card and the
gathered bytes within two blocks split over "model".
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.configs as R
from repro.data.synth import batch_shapes as r_batch_shapes
from repro.distributed import sharding as r_sh
from repro.launch import dryrun as r_dryrun
from repro.launch import roofline as r_roofline
from repro.models import build_model as r_build_model
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parent.parent
HLO = {
    "all-reduce": "%ar = f32[{r}]{{0}} all-reduce(f32[{r}]{{0}} %p), {g}, to_apply=%add",
    "all-gather": "%ag = bf16[{r},64]{{1,0}} all-gather(bf16[8,64]{{1,0}} %p), {g}, dimensions={{0}}",
    "reduce-scatter": "%rs = f32[{r}]{{0}} reduce-scatter(f32[4096]{{0}} %p), {g}, dimensions={{0}}, to_apply=%add",
    "all-to-all": "%aa = s8[{r},16]{{1,0}} all-to-all(s8[{r},16]{{1,0}} %p), {g}, dimensions={{0}}",
    "collective-permute": "%cp = f32[{r}]{{0}} collective-permute(f32[{r}]{{0}} %p), source_target_pairs={{{{0,1}}}}",
}
NBYTES = {"all-reduce": 4, "all-gather": 2 * 64, "reduce-scatter": 4,
          "all-to-all": 16, "collective-permute": 4}


@pytest.mark.parametrize("n", [2, 4, 16, 512])
@pytest.mark.parametrize("kind", list(HLO))
def test_ring_bytes_match_reference_collective_bytes(kind, n):
    rows = 24
    for groups in ("replica_groups={{" + ",".join(map(str, range(n))) + "}}",
                   f"replica_groups=[{512 // n},{n}]<=[512]"):
        line = HLO[kind].format(r=rows, g=groups)
        want = r_dryrun.collective_bytes(line, default_group=n)
        assert want["count"] == 1
        got = dryrun.ring_bytes(kind, rows * NBYTES[kind], n)
        assert got == want[kind], (line, got, want)


def test_model_flops_match_reference():
    for arch in R.list_archs():
        for shape in R.SHAPES:
            assert roofline.model_flops(arch, shape) == \
                r_roofline.model_flops(arch, shape), (arch, shape)


def test_analyze_uses_the_h100_terms():
    rec = {"arch": "phi3-mini-3.8b", "shape": "train_4k", "ok": True,
           "flops": 2.0e15, "bytes_accessed": 9.0e12, "n_devices": 256,
           "collectives": {"total": 6.0e10,
                           "by_link": {"nvlink": 4.5e10, "ib": 1.5e10}},
           "memory": {"peak_bytes": None}}
    a = roofline.analyze(rec)
    assert a["compute_s"] == 2.0e15 / 989.4e12
    assert a["memory_s"] == 9.0e12 / 3.35e12
    assert a["collective_s"] == 4.5e10 / 450e9 + 1.5e10 / 50e9
    assert a["dominant"] == "memory"
    assert a["compute_fraction"] == a["compute_s"] / a["memory_s"]
    assert a["useful_ratio"] == roofline.model_flops(
        "phi3-mini-3.8b", "train_4k") / (2.0e15 * 256)
    assert a["peak_gb"] is None
    assert roofline.analyze(dict(rec, ok=False)) is None
    # a record without the split by link: every byte over InfiniBand
    del rec["collectives"]["by_link"]
    assert roofline.analyze(rec)["collective_s"] == 6.0e10 / 50e9
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) != (r_roofline.PEAK_FLOPS,
                                                      r_roofline.HBM_BW)


def expected_argument_bytes(arch: str, shape_name: str) -> int:
    """Rank 0's bytes of parameters, AdamW's m and v, and the batch on the
    16x16 mesh, from the reference's specs and shapes."""
    cfg = R.get_config(arch)
    shape = R.SHAPES[shape_name]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda: r_build_model(
        cfg, pad_heads=r_sh.pad_heads_for(cfg, mesh)).init(jax.random.key(0)))
    specs = r_sh.param_pspecs(cfg, params, mesh)

    def local(shp, spec):
        n = 1
        for d, entry in zip(shp, tuple(spec) + (None,) * len(shp)):
            axes = () if entry is None else (entry,) if isinstance(
                entry, str) else entry
            n *= d // int(np.prod([mesh.shape[a] for a in axes]))
        return n

    sizes = jax.tree.leaves(jax.tree.map(
        lambda p, s: local(p.shape, s), params, specs,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
    assert cfg.optimizer_mode == "adamw"
    total = 3 * 4 * sum(sizes)                    # fp32 params, m and v
    bspecs = r_sh.batch_pspecs(cfg, mesh, shape)
    for name, (shp, dt) in r_batch_shapes(cfg, shape.global_batch,
                                          shape.seq_len).items():
        total += local(shp, bspecs[name]) * np.dtype(dt).itemsize
    return total


def block_bytes(arch: str) -> int:
    """fp32 bytes of the largest block (one repeat of one pattern
    position) of the reference's tree at ``arch``'s full width on the 16x16
    mesh, each leaf split over "model" where its spec splits it."""
    cfg = R.get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda: r_build_model(
        cfg, pad_heads=r_sh.pad_heads_for(cfg, mesh)).init(jax.random.key(0)))
    specs = r_sh.param_pspecs(cfg, params, mesh)
    sizes: dict = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] in ("dec", "enc"):
            n = int(np.prod(leaf.shape[1:])) * 4
            if "model" in tuple(spec):
                n //= mesh.shape["model"]
            sizes[tuple(keys[:2])] = sizes.get(tuple(keys[:2]), 0) + n
    return max(sizes.values())


def cell_record(arch: str, shape: str) -> dict:
    """``dryrun.run_cell`` of one 16x16 cell, in a subprocess."""
    code = ("import json; from repro_torch.launch import dryrun; "
            "print('RECORD' + json.dumps(dryrun.run_cell("
            f"{arch!r}, {shape!r}, False, save=False)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RECORD")]
    rec = json.loads(line[-1][len("RECORD"):])
    assert rec["ok"], rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    return rec


def test_full_width_cell_runs_under_a_fake_group():
    rec = cell_record("mamba2-780m", "train_4k")
    mem = rec["memory"]
    assert mem["argument_bytes"] == expected_argument_bytes(
        "mamba2-780m", "train_4k")
    assert 0 < mem["gathered_bytes"] <= 2 * block_bytes("mamba2-780m")
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["gathered_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert roofline.analyze(rec)["useful_ratio"] >= 8 * 0.049
    assert rec["flops"] > 0 and rec["flops_corrected"] == rec["flops"]
    assert rec["bytes_accessed"] > 0
    coll = rec["collectives"]
    assert coll["total"] > 0 and coll["all-gather"] > 0
    assert coll["reduce-scatter"] > 0 and coll["count"] > 0
    assert sum(coll["by_link"].values()) == pytest.approx(coll["total"])


def test_full_width_decode_cell_keeps_the_cache_split():
    """phi3-mini-3.8b ``decode_32k``: 294.5 GiB a device when the step
    gathered every layer's cache and every block whole."""
    rec = cell_record("phi3-mini-3.8b", "decode_32k")
    mem = rec["memory"]
    assert mem["peak_bytes"] < 80 * 2**30
    assert 0 < mem["gathered_bytes"] <= 2 * block_bytes("phi3-mini-3.8b")
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["gathered_bytes"]
    assert rec["collectives"]["all-reduce"] > 0
