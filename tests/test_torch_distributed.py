"""The port's distributed stack against the JAX package, on the CPU.

Specs: ``param_pspecs`` / ``batch_pspecs`` / ``cache_pspecs`` /
``Optimizer.state_pspecs`` / ``pad_heads_for`` / ``dp_axes`` equal the
reference's leaf for leaf, for every registry architecture (``reduced()``
and full shapes, on ``meta`` and under ``jax.eval_shape``) on meshes 1x1,
2x4, 16x16 and 2x16x16. The reference reads only the mesh's sizes and
names, so an ``AbstractMesh`` serves it and a plain object the port.

Multi-rank: eight gloo ranks in child processes (``torch_dist_cases.py``,
run once for the module) hold two sharded train steps on a 2x4 mesh
(phi3-mini reduced(64) with AdamW, also with ``grad_accum=2``, mamba2-780m
reduced(64) with Adafactor; jamba, moonshot, seamless, internvl2 and
smollm with AdamW, llama4 with Adafactor; B 8 x 32, no warmup) to the
port's single-rank steps (loss and gradient norm rtol = atol 1e-5,
parameters 5e-4, as the reference's tests/test_distributed.py holds
GSPMD; the optimizer state within 1e-4 of each leaf's largest entry,
jamba's after its first step, ``tdc.STATE_AFTER_FIRST``) with every
replica identical, and to the JAX steps at the same tolerances; every
leaf's gradient of one sharded step to the single rank's (1e-5); the
sharded prefill and decode (phi3, jamba, seamless, moonshot, jamba at
batch 1, phi3 at a per-row cur_len) to the single rank's (2e-4), the
decode on the cache as ``cache_pspecs`` lays it out (no cache leaf
redistributed, the new cache in the same placements), its logits also to
the JAX package's ``decode_step`` on the same weights and inputs (2e-4),
the gathered parameter bytes of both within two blocks split over
"model" as the specs split them, and no leaf gathered over "model" in
decode;
``collective_matmul`` to ``x @ w`` (2e-4); ``compressed_mean`` and its
error feedback to the reference's own eight-device output, exactly, and
to the reference's bounds (16 and 2 quantization steps); a checkpoint
saved on 2x4 restores onto 4x2 identically, its manifest's specs equal to
the reference's; every rank's ``CheckpointManager`` sees rank 0's last
async save. ``launch.train --distributed`` on two gloo ranks gives
each rank the reference pipeline's batches of its host shard.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

import repro.configs as R
import repro_torch.configs as P
import torch_dist_cases as tdc
from conftest import run_in_devices
from repro.checkpoint.store import save_checkpoint as r_save_checkpoint
from repro.data.pipeline import DataPipeline as RPipeline
from repro.data.synth import make_batch as r_make_batch
from repro.distributed import sharding as r_sh
from repro.models import build_model as r_build_model
from repro.models.attention import KVCache as RKVCache
from repro.models.ssm import SSMState as RSSMState
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch import interop
from repro_torch.distributed import sharding as p_sh
from repro_torch.models.builder import init_params
from repro_torch.train import optimizer as p_opt

ROOT = Path(__file__).resolve().parent.parent
MESHES = [(1, 1), (2, 4), (16, 16), (2, 16, 16)]
WORLD = 8


def names_of(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def meshes(shape):
    """(the reference's abstract mesh, the port's stand-in) of one shape."""
    return (AbstractMesh(shape, names_of(shape)),
            types.SimpleNamespace(mesh_dim_names=names_of(shape),
                                  shape=shape))


def ref_spec_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def port_spec_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_spec_leaves(v, f"{prefix}{k}/"))
        elif hasattr(v, "_fields"):
            out.update({f"{prefix}{k}/{f}": s for f, s in v._asdict().items()})
        else:
            out[prefix + k] = v
    return out


@functools.lru_cache(maxsize=None)
def ref_shapes(arch: str, reduced: bool, pad: int):
    cfg = R.get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = r_build_model(cfg, pad_heads=pad)
    return jax.eval_shape(lambda: model.init(jax.random.key(0)))


def configs(arch: str, reduced: bool):
    r, p = R.get_config(arch), P.get_config(arch)
    return (r.reduced(), p.reduced()) if reduced else (r, p)


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", R.list_archs())
def test_param_and_state_pspecs_match_reference(arch, shape):
    r_mesh, p_mesh = meshes(shape)
    for reduced in (True, False):
        r_cfg, p_cfg = configs(arch, reduced)
        pad = r_sh.pad_heads_for(r_cfg, r_mesh)
        assert p_sh.pad_heads_for(p_cfg, p_mesh) == pad
        assert p_sh.dp_axes(p_mesh, p_cfg.pure_dp) == \
            r_sh.dp_axes(r_mesh, r_cfg.pure_dp)
        r_params = ref_shapes(arch, reduced, pad)
        p_params = init_params(p_cfg, torch.Generator(), device="meta",
                               pad_heads=pad)
        r_specs = r_sh.param_pspecs(r_cfg, r_params, r_mesh)
        p_specs = p_sh.param_pspecs(p_cfg, p_params, p_mesh)
        want = ref_spec_leaves(r_specs)
        assert port_spec_leaves(p_specs) == want, (arch, reduced)
        for mode in ("adamw", "adafactor"):
            r_state = r_opt.make_optimizer(mode).state_pspecs(r_specs,
                                                              r_params)
            p_state = p_opt.make_optimizer(mode).state_pspecs(p_specs,
                                                              p_params)
            assert port_spec_leaves(p_state) == ref_spec_leaves(r_state), \
                (arch, reduced, mode)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", R.list_archs())
def test_batch_and_cache_pspecs_match_reference(arch, shape):
    r_mesh, p_mesh = meshes(shape)
    r_cfg, p_cfg = configs(arch, False)
    for smart in (False, True):
        for name in R.SHAPES:
            got = p_sh.batch_pspecs(p_cfg, p_mesh, P.SHAPES[name], smart)
            want = r_sh.batch_pspecs(r_cfg, r_mesh, R.SHAPES[name], smart)
            assert got == {k: tuple(v) for k, v in want.items()}, name
        for batch in (1, 4, 16, 128, 256):
            got = port_spec_leaves(p_sh.cache_pspecs(p_cfg, p_mesh, batch,
                                                     smart))
            want = ref_spec_leaves(r_sh.cache_pspecs(r_cfg, r_mesh, batch,
                                                     smart))
            assert got == want, (batch, smart)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    spec = p_sh.PSpec(("pod", "data"), None, "model")
    assert p_sh.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert p_sh.placements(p_sh.PSpec(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    assert p_sh.PSpec(("data",), None) == ("data", None) == tuple(
        PartitionSpec(("data",), None))
    with pytest.raises(ValueError):
        p_sh.placements(p_sh.PSpec(("model", "data")), mesh)


# ------------------------------------------------------------------ ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    cases = [*tdc.TRAIN, "grads", *tdc.DECODES, "cmm", "cmean", "elastic",
             "ckpt_sync"]
    return out, tdc.run_ranks(WORLD, out, "cpu", cases, timeout=240)


def jax_steps(name: str):
    """The reference's single-device steps on the case's weights and
    batches: ({"loss", "grad_norm"}: a list per step, {path: updated
    parameter}, [{path: optimizer-state leaf} after each step])."""
    arch, mode, accum = tdc.TRAIN[name]
    cfg = R.get_config(arch).reduced(64)
    tree = interop.numpy_reference_params(P.get_config(arch).reduced(64),
                                          tdc.SEEDS["params"])
    params = jax.tree.map(jnp.asarray, tree)
    opt = r_opt.make_optimizer(mode, lr=tdc.TRAIN_SHAPE["lr"],
                               warmup=tdc.TRAIN_SHAPE["warmup"])
    step = jax.jit(r_make_train_step(r_build_model(cfg, dtype=jnp.float32),
                                     opt, accum))
    state, metrics = opt.init(params), {"loss": [], "grad_norm": []}
    states = []
    for t in range(tdc.TRAIN_SHAPE["steps"]):
        batch = r_make_batch(cfg, tdc.TRAIN_SHAPE["batch"],
                             tdc.TRAIN_SHAPE["seq"],
                             seed=tdc.SEEDS["batch"] + t, dtype=jnp.float32)
        params, state, m = step(params, state, batch, jnp.int32(t))
        states.append(state)
        for k in metrics:
            metrics[k].append(float(m[k]))

    def by_path(tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in flat}

    return metrics, by_path(params), [by_path(s) for s in states]


@pytest.mark.parametrize("name", list(tdc.TRAIN))
def test_sharded_train_step_matches_single_rank_and_jax(ranks, name):
    """Two steps at the full learning rate: the parameters move by more
    than their tolerance, so the comparison holds the sharded gradients,
    their reduce-scatter and the optimizer on shards, not the weights the
    step started from."""
    out, res = ranks
    r = res[name]
    first = name in tdc.STATE_AFTER_FIRST
    assert r["replica_mismatches"] == 0
    assert r["params_moved"] > tdc.TOLS["param"], r
    assert r["state_leaves"] > 0, r
    for k in ("loss_err", "grad_norm_err", "param_err",
              "state_err_first" if first else "state_err"):
        assert r[k] <= 1.0, (k, r)
    metrics, want, states = jax_steps(name)
    want_state = states[0 if first else -1]
    opt = "opt1" if first else "opt"
    for k in metrics:
        np.testing.assert_allclose(r[k], metrics[k], rtol=tdc.TOLS["loss"],
                                   atol=tdc.TOLS["loss"], err_msg=k)
    with np.load(out / f"{name}.npz") as got:
        assert set(got.files) == set(want) | {f"{o}/{k}" for k in want_state
                                              for o in ("opt", "opt1")}
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=tdc.TOLS["param"],
                                       atol=tdc.TOLS["param"], err_msg=k)
        for k, v in want_state.items():
            assert tdc.state_err(got[f"{opt}/{k}"], v) <= 1.0, k


@pytest.mark.parametrize("arch", list(dict.fromkeys(
    a for a, _, _ in tdc.TRAIN.values())))
def test_sharded_gradients_match_single_rank_leaf_by_leaf(ranks, arch):
    """Adam is scale-invariant leaf by leaf, so a leaf whose gradient is
    summed where it should be averaged still updates right: every leaf's
    gradient (reduce-scattered into its shard, gathered) is held to the
    single rank's on the same batch."""
    _, res = ranks
    r = res["grads"][arch]
    assert r["same_leaves"] and r["leaves"] > 0, r
    assert r["err"] <= 1.0, r


def check_prefill_and_decode(r: dict) -> None:
    assert r["logits_err"] <= 1.0 and r["cache_err"] <= 1.0, r
    assert r["prefill_logits_err"] <= 1.0, r
    assert r["prefill_cache_err"] <= 1.0, r
    assert r["cache_layout_kept"] and r["cache_redistributes"] == 0, r
    assert 0 < r["prefill_gathered"] <= 2 * r["block_bytes"], r
    assert 0 < r["decode_gathered"] <= 2 * r["block_bytes"], r
    assert r["decode_model_gathers"] == 0, r


def test_sharded_decode_matches_single_rank(ranks):
    """phi3: the sharded prefill and decode against the single rank's,
    their gathered parameter bytes within two blocks split over "model"
    as the specs split them; the decode's cache split over the sequence
    and kept so."""
    check_prefill_and_decode(ranks[1]["decode"])
    assert ranks[1]["decode"]["kv_placements"] == ["S(1)", "S(2)"]


def test_sharded_jamba_prefill_and_decode_match_single_rank(ranks):
    check_prefill_and_decode(ranks[1]["decode_jamba"])


NEW_DECODES = ["decode_seamless", "decode_moonshot", "decode_batch1",
               "decode_rows"]


@pytest.mark.parametrize("name", NEW_DECODES)
def test_sharded_decode_case_matches_single_rank(ranks, name):
    """Cross-attention over the encoder's slots (seamless), experts and
    kv heads over "model" (moonshot), a replicated batch whose sequence
    is split over "data" and "model" (jamba at B 1), a [B] cur_len with
    rows in different windows and one at S_max (phi3)."""
    r = ranks[1][name]
    check_prefill_and_decode(r)
    want = ["S(2)", "S(2)"] if name == "decode_batch1" else ["S(1)", "S(2)"]
    assert r["kv_placements"] == want, r


def jax_decode(name: str, arrays) -> np.ndarray:
    """The JAX package's ``decode_step`` logits on the case's weights and
    decode inputs (tokens, cur_len, the padded cache)."""
    arch = tdc.DECODES[name][0]
    cfg = R.get_config(arch).reduced(64)
    tree = interop.numpy_reference_params(P.get_config(arch).reduced(64),
                                          tdc.SEEDS["params"])
    model = r_build_model(cfg, dtype=jnp.float32)
    cache = {}
    for i, spec in enumerate(cfg.pattern):
        kind = RSSMState if spec.mixer == "ssm" else RKVCache
        cache[f"pos{i}"] = kind(**{f: jnp.asarray(arrays[f"cache/pos{i}/{f}"])
                                   for f in kind._fields})
    logits, _ = jax.jit(model.decode_step)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(arrays["tokens"]),
        cache, jnp.asarray(arrays["cur_len"]))
    return np.asarray(logits)


@pytest.mark.parametrize("name", list(tdc.DECODES))
def test_sharded_decode_logits_match_jax(ranks, name):
    out, _ = ranks
    with np.load(out / f"{name}.npz") as got:
        want = jax_decode(name, got)
        np.testing.assert_allclose(got["logits"], want, rtol=tdc.TOLS["decode"],
                                   atol=tdc.TOLS["decode"])


def test_collective_matmul_matches_reference(ranks):
    out, res = ranks
    assert res["cmm"]["err"] <= 1.0
    x, w = tdc.cmm_inputs(WORLD)
    with np.load(out / "cmm.npz") as got:
        np.testing.assert_allclose(got["y"], x @ w, rtol=tdc.TOLS["cmm"],
                                   atol=tdc.TOLS["cmm"])


def test_compressed_mean_equals_reference_output(ranks):
    """Bit for bit: the ring's arithmetic and hop order are the
    reference's, in float32 on both sides."""
    out, res = ranks
    code = f"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.distributed.compression import compressed_mean, ef_compress_update
sys.path.insert(0, "tests")
import torch_dist_cases as tdc
x = jnp.asarray(tdc.cmean_input({WORLD}))
mesh = compat.make_mesh(({WORLD},), ("pod",))
out = compressed_mean(x, mesh, axis="pod")
grads, residual = {{"w": x}}, {{"w": jnp.zeros_like(x)}}
acc = jnp.zeros_like(x)
ef = jax.jit(lambda g, r: ef_compress_update(g, r, mesh, "pod"))
for _ in range(tdc.CMEAN["rounds"]):
    synced, residual = ef(grads, residual)
    acc = acc + synced["w"]
np.savez({str(out / 'cmean_ref.npz')!r}, out=np.asarray(out),
         ef_mean=np.asarray(acc / tdc.CMEAN["rounds"]))
print("RESULT:" + json.dumps({{}}))
"""
    run_in_devices(code, n_devices=WORLD)
    with np.load(out / "cmean.npz") as got, \
            np.load(out / "cmean_ref.npz") as want:
        np.testing.assert_array_equal(got["out"], want["out"])
        np.testing.assert_array_equal(got["ef_mean"], want["ef_mean"])
    r = res["cmean"]
    assert r["err_over_scale"] <= 16 and r["ef_err_over_scale"] <= 2, r
    assert r["serial_equal"]


def test_elastic_restore_across_meshes(ranks, tmp_path):
    _, res = ranks
    r = res["elastic"]
    assert r == dict(r, step=3, equal=True, template_layout=True,
                     host_mesh=[WORLD])
    cfg = R.get_config(tdc.DECODE["arch"]).reduced(64)
    tree = interop.numpy_reference_params(
        P.get_config(tdc.DECODE["arch"]).reduced(64), tdc.SEEDS["params"])
    specs = r_sh.param_pspecs(cfg, tree, AbstractMesh((2, WORLD // 2),
                                                      ("data", "model")))
    r_save_checkpoint(tmp_path, 3, tree, pspecs=specs)
    want = json.loads((tmp_path / "step_000003" / "manifest.json")
                      .read_text())
    got = json.loads(Path(r["manifest"]).read_text())
    assert got == want


def test_checkpoint_manager_waits_for_rank0_save(ranks):
    """Async saves on every rank, rank 0's writer slowed: every rank's
    ``latest_step`` and ``restore`` see rank 0's last save, and only
    rank 0 prunes old steps."""
    _, res = ranks
    got = res["ckpt_sync"]["ranks"]
    assert len(got) == WORLD
    assert [r["latest"] for r in got] == [3] * WORLD, got
    assert all(r["equal"] for r in got), got
    assert [r["pruned"] for r in got] == [3] + [0] * (WORLD - 1), got


# ------------------------------------------------------------------ launcher
LAUNCH_CHILD = """
import json, sys
import numpy as np
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as launch_train
seen = {}
batch_at = DataPipeline.batch_at
def record(self, step):
    b = batch_at(self, step)
    seen[step] = {k: v.numpy() for k, v in b.items()}
    return b
DataPipeline.batch_at = record
res = launch_train.main(sys.argv[2:])
np.savez(sys.argv[1], losses=np.asarray(res.losses),
         **{f"{s}__{k}": v for s, b in seen.items() for k, v in b.items()})
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_train_distributed_takes_host_shards(tmp_path):
    """Two gloo ranks, as torchrun starts them: each rank's batches are the
    reference pipeline's for host ``rank`` of 2, and each trains."""
    steps, batch, seq = 3, 4, 32
    argv = ["--arch", "mamba2-780m", "--reduced", "--width", "64",
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--device", "cpu", "--distributed"]
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", LAUNCH_CHILD, str(tmp_path / f"r{r}.npz"),
             *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    cfg = R.get_config("mamba2-780m").reduced(64)
    for r in range(2):
        ref = RPipeline(cfg, batch, seq, host_index=r, n_hosts=2,
                        dtype=jnp.float32)
        with np.load(tmp_path / f"r{r}.npz") as got:
            assert len(got["losses"]) == steps
            assert np.isfinite(got["losses"]).all()
            for s in range(steps):
                want = ref.batch_at(s)
                for k, v in want.items():
                    np.testing.assert_array_equal(got[f"{s}__{k}"],
                                                  np.asarray(v))
        assert f"[train] done: {steps} steps" in outs[r]
