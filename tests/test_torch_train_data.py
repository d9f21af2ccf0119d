"""The port's synthetic batches, data pipeline and checkpoints against the
JAX package, on the CPU.

``repro_torch.data.make_batch`` and ``DataPipeline.batch_at`` must equal
the reference's bit for bit (the same numpy draws in the same order) for a
text, a vlm and an encoder-decoder config; host shards draw disjoint
batches. Checkpoints: a roundtrip of float32, int32 and bfloat16 leaves, a
stray ``.tmp`` directory ignored, keep-K with async saves, the writer's
error re-raised by ``wait``, and the on-disk format shared with the JAX
package in both directions (the same ``manifest.json``, byte for byte).
Thread tests join their threads and decide nothing by sleeping. The
ported examples: ``repro_torch.train_lm`` trains a tiny model through an
injected failure, and ``repro_torch.quickstart`` runs its three layers,
its train steps equal to ``examples/quickstart.py``'s layer C on the same
numpy weights.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.checkpoint import store as r_store
from repro.data.pipeline import DataPipeline as RPipeline
from repro.data.synth import batch_shapes as r_batch_shapes
from repro.data.synth import make_batch as r_make_batch
from repro.models import builder as r_builder
from repro_torch import interop, quickstart, train_lm
from repro_torch.checkpoint import manager as p_manager
from repro_torch.checkpoint import store as p_store
from repro_torch.data import DataPipeline, batch_shapes, make_batch
from repro_torch.tree import leaves_with_paths

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: A text, a vlm and an encoder-decoder architecture.
FAMILIES = ("smollm-135m", "internvl2-2b", "seamless-m4t-large-v2")
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def configs(arch: str):
    return R.get_config(arch).reduced(), P.get_config(arch).reduced()


def bits(x) -> np.ndarray:
    """An array's bytes as unsigned ints of its width (bf16 included)."""
    a = (x.view(torch.int16) if isinstance(x, torch.Tensor)
         and x.dtype == torch.bfloat16 else x)
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(f"u{a.dtype.itemsize}")


def assert_batches_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(bits(got[k]), bits(want[k]), err_msg=k)


# ------------------------------------------------------------------ synth
@pytest.mark.parametrize("arch", list(R.list_archs()))
def test_batch_shapes_match_jax(arch):
    r_cfg, p_cfg = configs(arch)
    got = batch_shapes(p_cfg, 4, 64)
    want = r_batch_shapes(r_cfg, 4, 64)
    assert list(got) == list(want)
    for k, (shape, dt) in want.items():
        assert got[k][0] == shape
        assert str(got[k][1]).split(".")[-1] == jnp.dtype(dt).name


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("seed", [0, 17])
def test_make_batch_equals_jax_bit_for_bit(arch, dtype, seed):
    r_cfg, p_cfg = configs(arch)
    r_dt, p_dt = DTYPES[dtype]
    got = make_batch(p_cfg, 3, 40, seed=seed, dtype=p_dt, device="cpu")
    assert_batches_equal(got, r_make_batch(r_cfg, 3, 40, seed=seed,
                                           dtype=r_dt))
    assert got["tokens"].dtype == torch.int32
    if p_cfg.modality is not None and not p_cfg.encoder_decoder:
        p = got["patch_embeds"].shape[1]
        assert (got["labels"][:, :p] == -1).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_at_equals_jax_and_host_shards_are_disjoint(arch):
    r_cfg, p_cfg = configs(arch)
    for host in (0, 1):
        got = DataPipeline(p_cfg, 8, 32, seed=5, host_index=host, n_hosts=2,
                           device="cpu")
        want = RPipeline(r_cfg, 8, 32, seed=5, host_index=host, n_hosts=2)
        for step in (0, 1, 41):
            assert_batches_equal(got.batch_at(step), want.batch_at(step))
    shards = [DataPipeline(p_cfg, 8, 32, seed=5, host_index=h, n_hosts=2,
                           device="cpu").batch_at(3)["tokens"]
              for h in (0, 1)]
    assert shards[0].shape[0] == 4
    assert not torch.equal(shards[0], shards[1])
    again = DataPipeline(p_cfg, 8, 32, seed=5, host_index=0, n_hosts=2,
                         device="cpu").batch_at(3)["tokens"]
    assert torch.equal(again, shards[0])


def test_pipeline_prefetches_in_step_order():
    _, cfg = configs("smollm-135m")
    pipe = DataPipeline(cfg, 2, 16, seed=1, prefetch=2, device="cpu")
    pipe.start(start_step=7)
    thread = pipe._thread
    try:
        it = iter(pipe)
        for want_step in range(7, 12):
            step, batch = next(it)
            assert step == want_step
            assert_batches_equal(batch, pipe.batch_at(step))
    finally:
        pipe.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert pipe.heartbeat >= 5


def test_pipeline_rejects_a_batch_that_does_not_split():
    _, cfg = configs("smollm-135m")
    with pytest.raises(ValueError, match="does not divide"):
        DataPipeline(cfg, 5, 16, n_hosts=2, device="cpu")


# ------------------------------------------------------------- checkpoints
def p_tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "h": torch.randn((3, 5), generator=g).to(torch.bfloat16)},
            "z": torch.randn((4,), generator=g)}


def as_jax(tree: dict) -> dict:
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(bits(t).view(ml_dtypes.bfloat16))
        return jnp.asarray(t.numpy())
    return {k: as_jax(v) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}


def assert_trees_equal(got, want) -> None:
    got_l = dict(leaves_with_paths(got))
    want_l = dict(leaves_with_paths(want))
    assert list(got_l) == list(want_l)
    for k in want_l:
        assert got_l[k].dtype == want_l[k].dtype, k
        np.testing.assert_array_equal(bits(got_l[k]), bits(want_l[k]),
                                      err_msg=k)


def test_roundtrip_keeps_every_leaf_and_dtype(tmp_path):
    tree = p_tree()
    p_store.save_checkpoint(tmp_path, 5, tree, extra_meta={"note": "x"})
    step, restored, extra = p_store.load_checkpoint(tmp_path, template=tree)
    assert (step, extra) == (5, {"note": "x"})
    assert_trees_equal(restored, tree)
    _, flat, _ = p_store.load_checkpoint(tmp_path)
    assert sorted(flat) == ["a", "b/c", "b/h", "z"]
    assert flat["b/h"].dtype == torch.bfloat16
    man = json.loads((tmp_path / "step_000005" / "manifest.json").read_text())
    assert man["leaves"]["b/h"] == {"shape": [3, 5], "dtype": "bfloat16",
                                    "pspec": None}


def test_template_mismatch_raises(tmp_path):
    tree = p_tree()
    p_store.save_checkpoint(tmp_path, 1, tree)
    with pytest.raises(ValueError, match="template"):
        p_store.load_checkpoint(tmp_path, template=dict(
            tree, a=torch.zeros((8, 15))))
    with pytest.raises(KeyError, match="missing leaf q"):
        p_store.load_checkpoint(tmp_path, template=dict(
            tree, q=torch.zeros(1)))
    with pytest.raises(FileNotFoundError):
        p_store.load_checkpoint(tmp_path / "none")


def test_partial_write_is_ignored(tmp_path):
    tree = p_tree()
    p_store.save_checkpoint(tmp_path, 1, tree)
    tmp = pathlib.Path(tmp_path) / "step_000002.tmp"
    tmp.mkdir()
    (tmp / "manifest.json").write_text("{corrupt")
    assert p_store.latest_step(tmp_path) == 1
    step, _, _ = p_store.load_checkpoint(tmp_path, template=tree)
    assert step == 1


def test_manager_keeps_k_with_async_saves(tmp_path):
    mgr = p_manager.CheckpointManager(str(tmp_path), keep=2)
    tree = p_tree()
    for s in (10, 20, 30):
        mgr.save(s, tree)
        # the save took a host copy: changing the tree now changes nothing
        tree["a"].add_(1.0)
    thread = mgr._thread
    mgr.wait()
    assert thread is not None and not thread.is_alive()
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [20, 30]
    assert mgr.latest_step() == 30
    _, restored, _ = mgr.restore(p_tree())
    want = p_tree()
    want["a"].add_(1.0).add_(1.0)
    assert_trees_equal(restored, want)


def test_manager_restart_point_counts_a_save_in_flight(tmp_path):
    """A restart read right after an async save resumes from that save:
    ``latest_step`` and ``restore`` join the writer first."""
    mgr = p_manager.CheckpointManager(str(tmp_path))
    tree = p_tree()
    mgr.save(4, tree)
    assert mgr.latest_step() == 4
    assert mgr._thread is None
    mgr.save(6, tree)
    step, restored, _ = mgr.restore(p_tree(3))
    assert step == 6
    assert_trees_equal(restored, tree)
    mgr.wait()


def test_manager_wait_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = p_manager.CheckpointManager(str(blocker))
    mgr.save(1, p_tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error is raised once


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    tree = p_tree(1)
    r_store.save_checkpoint(tmp_path / "jax", 3, as_jax(tree),
                            extra_meta={"by": "jax"})
    step, restored, extra = p_store.load_checkpoint(tmp_path / "jax",
                                                    template=p_tree(2))
    assert (step, extra) == (3, {"by": "jax"})
    assert_trees_equal(restored, tree)


def test_port_checkpoint_restores_into_jax_with_an_equal_manifest(tmp_path):
    tree = {k: v for k, v in p_tree(4).items() if k != "b"}
    tree["b"] = {"c": torch.arange(10, dtype=torch.int32)}
    p_store.save_checkpoint(tmp_path / "port", 9, tree, extra_meta={"k": 1})
    r_store.save_checkpoint(tmp_path / "jax", 9, as_jax(tree),
                            extra_meta={"k": 1})
    manifest = [(tmp_path / side / "step_000009" / "manifest.json").read_text()
                for side in ("port", "jax")]
    assert manifest[0] == manifest[1]
    template = jax.tree.map(jnp.zeros_like, as_jax(tree))
    step, restored, extra = r_store.load_checkpoint(tmp_path / "port",
                                                    template=template)
    assert (step, extra) == (9, {"k": 1})
    for (k, a), b in zip(leaves_with_paths(tree),
                         jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=k)


# ------------------------------------------------------------ examples
def test_train_lm_recovers_and_learns(capsys):
    res = train_lm.main(["--steps", "30", "--width", "32", "--batch", "4",
                         "--seq", "32", "--fail-at-step", "20",
                         "--device", "cpu"])
    assert res.final_step == 30 and res.restarts == 1
    # no checkpoint before step 20 (every 50): the run restarts from step 0
    assert len(res.losses) == 20 + 30
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10])
    assert "injected failure recovered" in capsys.readouterr().out


def test_quickstart_runs_and_trains_as_the_example(capsys, monkeypatch):
    """The port's quickstart whole on the CPU; its layer C losses against
    the example's layer C with ``Model.init`` giving the same numpy
    weights."""
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "weighted speedup" in out and "max|err| = 0.00e+00" in out

    spec = importlib.util.spec_from_file_location(
        "quickstart_example", ROOT / "examples" / "quickstart.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tree = interop.numpy_reference_params(
        P.get_config("phi3-mini-3.8b").reduced(64), 0)
    monkeypatch.setattr(r_builder.Model, "init",
                        lambda self, key: jax.tree.map(jnp.asarray, tree))
    example.layer_c_train_and_serve()
    want = [float(line.split("loss=")[1]) for line in
            capsys.readouterr().out.splitlines() if "loss=" in line]
    assert len(want) == 3
    # the example prints 3 decimals
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 + 1e-6)
