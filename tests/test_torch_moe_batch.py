"""A batch split in two, in one process: the MoE capacity, drop order and
aux loss, and the cross-entropy, are the whole batch's, as the JAX
package's one global program takes them.

The sharded steps pass ``moe_ffn``, ``route`` and ``Model.loss`` (through
its layout) a :class:`repro_torch.models.layers.BatchGroup`. Here two
threads stand in for two ranks: each runs one half of the batch (4 of its
8 rows) and the group hands it the other half's per-expert counts and
partial sums (:class:`Pair`). Held to the reference on the whole batch:

* ``moe_ffn`` of moonshot-v1-16b-a3b's reduced(64) layer (capacity factor
  0.5, so slots drop): each half's output rows, the aux loss and the
  capacity (rtol = atol = 2e-4, as ``test_torch_moe.py``); each half alone,
  as the parent's sharded step ran it, differs;
* ``Model.loss`` of moonshot and jamba reduced(64) on a B 8 x 32 batch:
  loss, ``ce`` and ``aux`` (rtol 1e-5, as ``test_torch_train_loop.py``);
* the default route (no group) stays bit for bit the route before the
  hook (a copy of it below).
"""
import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.configs as R
import repro_torch.configs as P
from repro.data.synth import make_batch as r_make_batch
from repro.models import build_model as r_build_model
from repro.models import moe as r_moe
from repro_torch import interop
from repro_torch.data.synth import make_batch
from repro_torch.models import build_model
from repro_torch.models import moe as p_moe
from repro_torch.models.layers import ACTS

TOL = dict(rtol=2e-4, atol=2e-4)
ROWS, SEQ = 8, 32


class Pair:
    """Two members of one batch, each run in its own thread, that swap
    values through a barrier."""

    def __init__(self):
        self.barrier = threading.Barrier(2, timeout=120)
        self.slots = [None, None]

    def member(self, index: int) -> "Member":
        return Member(self, index)


class Member:
    """One half's :class:`repro_torch.models.layers.BatchGroup`."""

    size = 2

    def __init__(self, pair: Pair, index: int):
        self.pair, self.index = pair, index

    def _swap(self, x: torch.Tensor) -> list:
        self.pair.slots[self.index] = x.detach().clone()
        self.pair.barrier.wait()
        both = list(self.pair.slots)
        self.pair.barrier.wait()
        return both

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack(self._swap(x))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        both = self._swap(x)
        return x + both[1 - self.index]


def halves(fn, *inputs):
    """``fn(group, *half)`` for both halves of ``inputs`` (rows split in
    two), each in its own thread: [half 0's result, half 1's]."""
    pair, out, errors = Pair(), [None, None], []

    def run(i):
        try:
            out[i] = fn(pair.member(i), *(x[i * ROWS // 2:(i + 1) * ROWS // 2]
                                          if x is not None else None
                                          for x in inputs))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            pair.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def moonshot_layer():
    """(reference config, port config, JAX weights, port weights) of
    moonshot reduced(64)'s first MoE layer at capacity factor 0.5."""
    r_cfg = R.get_config("moonshot-v1-16b-a3b").reduced(64)
    p_cfg = P.get_config("moonshot-v1-16b-a3b").reduced(64)
    tree = interop.numpy_reference_params(p_cfg, 0)
    ffn = {k: v[0] for k, v in tree["dec"]["pos0"]["ffn"].items()}
    r_moe_cfg = dataclasses.replace(r_cfg.moe, capacity_factor=0.5)
    p_moe_cfg = dataclasses.replace(p_cfg.moe, capacity_factor=0.5)
    return (r_cfg, r_moe_cfg, p_moe_cfg,
            {k: jnp.asarray(v) for k, v in ffn.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in ffn.items()})


def test_split_moe_ffn_matches_the_whole_batch(monkeypatch):
    r_cfg, r_moe_cfg, p_moe_cfg, pj, pt = moonshot_layer()
    x = np.random.default_rng(5).standard_normal(
        (ROWS, SEQ, r_cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = r_moe.moe_ffn(pj, jnp.asarray(x), r_moe_cfg, r_cfg.act,
                                   r_cfg.mlp_glu)
    t = ROWS * SEQ
    cap = r_moe.expert_capacity(t, r_moe_cfg)
    _, ids, _ = r_moe.route(pj, jnp.asarray(x).reshape(t, -1), r_moe_cfg)
    assert np.bincount(np.asarray(ids).reshape(-1)).max() > cap  # drops

    seen = []
    capacity = p_moe.expert_capacity
    monkeypatch.setattr(p_moe, "expert_capacity",
                        lambda n, c: seen.append(capacity(n, c)) or seen[-1])
    got = halves(lambda g, xh: p_moe.moe_ffn(
        pt, xh, p_moe_cfg, r_cfg.act, r_cfg.mlp_glu, group=g),
        torch.from_numpy(x))
    assert seen == [cap, cap]
    y = torch.cat([y for y, _ in got])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    for _, aux in got:
        np.testing.assert_allclose(float(aux), float(aux_ref), **TOL)
    # each half on its own (the parent's sharded step) drops other slots
    alone = torch.cat([p_moe.moe_ffn(pt, torch.from_numpy(x[i:i + 4]),
                                     p_moe_cfg, r_cfg.act, r_cfg.mlp_glu)[0]
                       for i in (0, 4)])
    assert float((alone - torch.from_numpy(np.array(y_ref))).abs().max()) \
        > 1e-2


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_split_loss_matches_the_whole_batch(arch):
    r_cfg = R.get_config(arch).reduced(64)
    p_cfg = P.get_config(arch).reduced(64)
    tree = interop.numpy_reference_params(p_cfg, 0)
    batch = r_make_batch(r_cfg, ROWS, SEQ, seed=1, dtype=jnp.float32)
    loss, extras = jax.jit(r_build_model(r_cfg, dtype=jnp.float32).loss)(
        jax.tree.map(jnp.asarray, tree), batch)
    model = build_model(p_cfg, interop.params_from_reference(p_cfg, tree),
                        dtype=torch.float32, device="cpu")
    tb = make_batch(p_cfg, ROWS, SEQ, seed=1, dtype=torch.float32,
                    device="cpu")
    names = list(tb)
    got = halves(lambda g, *h: model.loss(dict(zip(names, h)),
                                          layout=model.layout(g)),
                 *tb.values())
    for l, ex in got:
        np.testing.assert_allclose(float(l), float(loss), rtol=1e-5)
        for k in ("ce", "aux"):
            np.testing.assert_allclose(float(ex[k]), float(extras[k]),
                                       rtol=1e-5, atol=1e-7)
    alone = [model.loss({k: v[i:i + 4] for k, v in tb.items()})[1]
             for i in (0, 4)]
    mean = {k: (float(alone[0][k]) + float(alone[1][k])) / 2
            for k in ("ce", "aux")}
    assert any(abs(mean[k] - float(extras[k])) > 1e-5 * abs(float(extras[k]))
               for k in mean), mean


# ------------------------------------------------------------ the route before
def route_before(p, x2d, cfg):
    logits = (x2d @ p["router"].to(x2d.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
    w = w / w.sum(dim=-1, keepdim=True)
    density = F.one_hot(ids[:, 0], cfg.n_experts).float().mean(dim=0)
    aux = cfg.n_experts * (density * probs.mean(dim=0)).sum()
    return w.to(x2d.dtype), ids, aux


def moe_ffn_before(p, x, cfg, act="silu", glu=True, use_kernel=True):
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    x2d = x.reshape(t, d)
    w, ids, aux = route_before(p, x2d, cfg)
    cap = p_moe.expert_capacity(t, cfg)
    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = (torch.arange(t * k, device=x.device)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = x2d[order // k]
    xs = buf[:-1]
    eids = (p_moe.capacity_block_eids(e, cap, cap, device=x.device)
            if use_kernel else None)
    h = p_moe._experts(p["up"], xs, eids, cap)
    if glu:
        h = ACTS[act](p_moe._experts(p["gate"], xs, eids, cap)) * h
    else:
        h = ACTS[act](h)
    yflat = p_moe._experts(p["down"], h, eids, cap)
    slot_y = torch.where(keep[:, None],
                         yflat[torch.clamp(dest, max=e * cap - 1)], 0)
    unsort = torch.zeros((t * k, d), dtype=x.dtype, device=x.device)
    unsort[order] = slot_y
    y = (unsort.reshape(t, k, d) * w[..., None]).sum(dim=1)
    if cfg.n_shared_experts:
        hs = x2d @ p["shared_up"].to(x.dtype)
        if glu:
            hs = ACTS[act](x2d @ p["shared_gate"].to(x.dtype)) * hs
        else:
            hs = ACTS[act](hs)
        y = y + hs @ p["shared_down"].to(x.dtype)
    return y.reshape(b, s, d), aux * cfg.aux_loss_coef


@pytest.mark.parametrize("use_kernel", [True, False])
def test_default_route_is_bit_for_bit_the_route_before(use_kernel):
    r_cfg, _, p_moe_cfg, _, pt = moonshot_layer()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (ROWS, SEQ, r_cfg.d_model)).astype(np.float32))
    y, aux = p_moe.moe_ffn(pt, x, p_moe_cfg, r_cfg.act, r_cfg.mlp_glu,
                           use_kernel=use_kernel)
    y0, aux0 = moe_ffn_before(pt, x, p_moe_cfg, r_cfg.act, r_cfg.mlp_glu,
                              use_kernel=use_kernel)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert torch.equal(p_moe.route(pt, x.reshape(-1, r_cfg.d_model),
                                   p_moe_cfg)[2],
                       route_before(pt, x.reshape(-1, r_cfg.d_model),
                                    p_moe_cfg)[2])
    assert math.isfinite(float(aux))
