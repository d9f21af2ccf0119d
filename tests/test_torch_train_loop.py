"""The port's train route and training loop against the JAX package, on
the CPU.

For every registry architecture at ``reduced()`` (the width
``tests/test_arch_smoke.py`` uses), the same numpy weights and batch:
``Model.loss`` within rtol 1e-5 of the reference's and every gradient leaf
within rtol = atol = 2e-4 of ``jax.value_and_grad(model.loss)``, with
remat off and on (on, each block runs under ``torch.utils.checkpoint``
and the gradients equal remat off's bit for bit). The train route calls
neither the SSD-scan nor the grouped-GEMM kernel wrapper; the padded vocab
columns get no gradient; ``forward`` keeps running without autograd. The
port's ``ssd_chunked`` keeps a finite gradient where the reference's
``where(mask, exp(delta), 0)`` gives NaN (a deliberate difference).
``train()`` with an injected failure resumes from its checkpoint, and its
losses equal an uninterrupted run's and the reference loop's;
``launch.train`` does the same from its flags.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.checkpoint import manager as r_manager
from repro.data.pipeline import DataPipeline as RPipeline
from repro.data.synth import make_batch as r_make_batch
from repro.models import builder as r_builder
from repro.models import build_model as r_build_model
from repro.models import ssm as r_ssm
from repro.train import optimizer as r_opt
from repro.train.loop import train as r_train
from repro_torch import interop
from repro_torch.data import DataPipeline, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import builder as p_builder
from repro_torch.models import moe as p_moe
from repro_torch.models import ssm as p_ssm
from repro_torch.train import optimizer as p_opt
from repro_torch.train.loop import train
from repro_torch.train.step import value_and_grad
from repro_torch.tree import leaves_with_paths

TOL = dict(rtol=2e-4, atol=2e-4)


def port_model(cfg, tree, remat: str = "none"):
    cfg = dataclasses.replace(cfg, remat=remat)
    return build_model(cfg, interop.params_from_reference(cfg, tree),
                       dtype=torch.float32, device="cpu")


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """(numpy weights, numpy batch, reference loss, extras, {path: grad})
    for ``arch`` at ``reduced()``."""
    r_cfg, p_cfg = R.get_config(arch).reduced(), P.get_config(arch).reduced()
    tree = interop.numpy_reference_params(p_cfg, 0)
    batch = r_make_batch(r_cfg, 2, 32, seed=3, dtype=jnp.float32)
    model = r_build_model(r_cfg, dtype=jnp.float32)
    (loss, extras), grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(jax.tree.map(jnp.asarray, tree), batch)
    return (tree, jax.tree.map(np.asarray, batch), float(loss),
            {k: float(v) for k, v in extras.items()},
            dict(leaves_with_paths(jax.tree.map(np.asarray, grads))))


@functools.lru_cache(maxsize=None)
def port_grads(arch: str, remat: str):
    tree, batch, *_ = reference(arch)
    model = port_model(P.get_config(arch).reduced(), tree, remat)
    model.requires_grad_(True)
    return value_and_grad(model, {k: torch.from_numpy(np.array(v))
                                  for k, v in batch.items()})


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", list(R.list_archs()))
def test_loss_and_grads_match_jax(arch, remat):
    _, _, r_loss, r_extras, r_grads = reference(arch)
    loss, extras, grads = port_grads(arch, remat)
    np.testing.assert_allclose(float(loss), r_loss, rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(extras[k]), r_extras[k], rtol=1e-5,
                                   atol=1e-7)
    assert list(grads) == list(r_grads)
    for k, g in grads.items():
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), r_grads[k], err_msg=k, **TOL)
    if remat != "none":
        for k, g in port_grads(arch, "none")[2].items():
            assert torch.equal(grads[k], g), k


def test_remat_runs_each_decoder_block_under_checkpoint(monkeypatch):
    calls = []
    real = p_builder.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(p_builder, "checkpoint", counted)
    arch = "seamless-m4t-large-v2"
    tree, batch, *_ = reference(arch)
    cfg = P.get_config(arch).reduced()
    model = port_model(cfg, tree, "full")
    model.loss({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    # the decoder's blocks only: the reference remats the train-mode scan
    assert calls == [{"use_reentrant": False}] * cfg.n_repeats
    calls.clear()
    model.forward({k: torch.from_numpy(np.array(v))
                   for k, v in batch.items()})
    assert calls == []


@pytest.mark.parametrize("arch", ["mamba2-780m", "moonshot-v1-16b-a3b",
                                  "jamba-v0.1-52b"])
def test_train_route_calls_no_kernel_wrapper(arch, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper on the train route")

    monkeypatch.setattr(p_ssm, "ssd_scan", refuse)
    monkeypatch.setattr(p_moe, "grouped_matmul", refuse)
    tree, batch, *_ = reference(arch)
    model = port_model(P.get_config(arch).reduced(), tree)
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = model.loss(tb)
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    with pytest.raises(AssertionError, match="kernel wrapper"):
        model.forward(tb)        # the serving path does call them


def test_forward_prefill_and_decode_stay_without_autograd():
    arch = "jamba-v0.1-52b"
    tree, batch, *_ = reference(arch)
    model = port_model(P.get_config(arch).reduced(), tree)
    model.requires_grad_(True)
    toks = torch.from_numpy(np.array(batch["tokens"]))
    logits, aux = model.forward({"tokens": toks})
    last, cache = model.prefill({"tokens": toks})
    step, _ = model.decode_step(toks[:, :1], cache, toks.shape[1])
    assert not any(t.requires_grad for t in (logits, aux, last, step))


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3-mini-3.8b"])
def test_padded_vocab_columns_get_no_gradient(arch):
    """vocab 500 pads to 512: the logits' padded columns are set to -1e9
    in place, and no gradient reaches the head's padded rows."""
    cfg = dataclasses.replace(P.get_config(arch).reduced(), vocab_size=500)
    assert cfg.padded_vocab == 512
    model = port_model(cfg, interop.numpy_reference_params(cfg, 0))
    model.requires_grad_(True)
    _, _, grads = value_and_grad(model, make_batch(
        cfg, 2, 16, dtype=torch.float32, device="cpu"))
    head = "embed/table" if cfg.tie_embeddings else "lm_head/table"
    assert torch.count_nonzero(grads[head][500:]) == 0
    assert torch.count_nonzero(grads[head][:500]) > 0


def test_ssd_chunked_grad_stays_finite_where_the_reference_is_nan():
    """A chunk whose decay overflows exp above the diagonal: the same
    forward, the reference's gradient NaN, the port's finite and equal to
    the reference's on a decay that does not overflow."""
    rng = np.random.default_rng(0)
    B, L, H, hd, ds, chunk = 1, 32, 2, 4, 8, 16
    x = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    b = rng.standard_normal((B, L, ds)).astype(np.float32)
    c = rng.standard_normal((B, L, ds)).astype(np.float32)
    a_log = np.log(np.array([1.0, 16.0], np.float32))
    d_skip = np.ones(H, np.float32)
    for dt_val, overflows in ((0.05, False), (8.0, True)):
        dt = np.full((B, L, H), dt_val, np.float32)

        def r_fn(dt):
            return jnp.sum(r_ssm.ssd_chunked(
                jnp.asarray(x), dt, jnp.asarray(a_log), jnp.asarray(b),
                jnp.asarray(c), jnp.asarray(d_skip), chunk)[0])
        r_val, r_grad = jax.value_and_grad(r_fn)(jnp.asarray(dt))
        dtt = torch.from_numpy(dt.copy()).requires_grad_(True)
        y, _ = p_ssm.ssd_chunked(torch.from_numpy(x), dtt, *(
            torch.from_numpy(v) for v in (a_log, b, c, d_skip)), chunk)
        y.sum().backward()
        np.testing.assert_allclose(float(y.detach().sum()), float(r_val),
                                   rtol=1e-5)
        assert torch.isfinite(dtt.grad).all()
        assert bool(jnp.isnan(r_grad).any()) == overflows
        if not overflows:
            np.testing.assert_allclose(dtt.grad.numpy(), np.asarray(r_grad),
                                       **TOL)


# ------------------------------------------------------------ the loop
@pytest.fixture
def one_thread():
    """One intra-op thread for the test. MKL's threaded GEMM rounds by how
    it splits the work, which follows where the tensors lie in memory, so
    two runs of one step on this CPU may differ in the last bit; on one
    thread a run is bit-reproducible, and a resumed run can be held to
    equal an uninterrupted one exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loop_setup(arch="smollm-135m", width=64):
    r_cfg, p_cfg = R.get_config(arch).reduced(width), P.get_config(
        arch).reduced(width)
    tree = interop.numpy_reference_params(p_cfg, 0)
    model = port_model(p_cfg, tree)
    return r_cfg, p_cfg, tree, model


def test_failure_recovers_to_the_uninterrupted_losses_and_the_reference(
        tmp_path, monkeypatch, capsys, one_thread):
    r_cfg, p_cfg, tree, model = loop_setup()
    kw = dict(lr=2e-3, warmup=2, total_steps=6)
    run = dict(total_steps=6, ckpt_every=2, log_every=1, params=tree)
    clean = train(model, p_opt.make_optimizer("adamw", **kw),
                  DataPipeline(p_cfg, 4, 32, dtype=torch.float32,
                               device="cpu"), **run)
    failed = train(model, p_opt.make_optimizer("adamw", **kw),
                   DataPipeline(p_cfg, 4, 32, dtype=torch.float32,
                                device="cpu"),
                   ckpt_dir=str(tmp_path / "port"), fail_at_step=3, **run)
    assert (clean.final_step, clean.restarts) == (6, 0)
    assert (failed.final_step, failed.restarts) == (6, 1)
    # steps 0-2 ran, the crash at 3 resumed from the step-2 checkpoint
    assert failed.losses == clean.losses[:3] + clean.losses[2:]
    assert len(failed.step_s) == len(failed.losses)
    assert "[train] step=5" in capsys.readouterr().out

    monkeypatch.setattr(r_builder.Model, "init",
                        lambda self, key: jax.tree.map(jnp.asarray, tree))
    # The reference's manager reads the directory while its async writer
    # may still run, so under load its restart can miss the step-2 save
    # and start over from 0. The port joins the writer first (ROADMAP,
    # deliberate differences); hold the reference to that order too.
    latest = r_manager.CheckpointManager.latest_step
    monkeypatch.setattr(r_manager.CheckpointManager, "latest_step",
                        lambda self: (self.wait(), latest(self))[1])
    ref = r_train(r_build_model(r_cfg, dtype=jnp.float32),
                  r_opt.make_optimizer("adamw", **kw),
                  RPipeline(r_cfg, 4, 32, dtype=jnp.float32), total_steps=6,
                  ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
                  fail_at_step=3, log_every=100)
    assert ref.restarts == 1
    np.testing.assert_allclose(failed.losses, ref.losses, rtol=1e-5)


def test_launch_train_resumes_exactly(tmp_path, capsys, one_thread):
    args = ["--arch", "mamba2-780m", "--reduced", "--width", "64", "--steps",
            "4", "--batch", "2", "--seq", "32", "--device", "cpu"]
    clean = launch_train.main(args)
    failed = launch_train.main(args + ["--ckpt-dir", str(tmp_path),
                                       "--ckpt-every", "2",
                                       "--fail-at-step", "2"])
    assert failed.restarts == 1 and failed.final_step == 4
    assert failed.losses == clean.losses
    assert np.isfinite(clean.losses).all()
    assert "[train] done: 4 steps" in capsys.readouterr().out
