"""Decode on a rank's share of the cache, against the JAX package, on the
CPU: the modules under the sharded decode step.

The sharded decode (``repro_torch.distributed.partition``) gives each rank
a window of the KV cache's slots and a slice of the heads. Here ``n``
threads stand in for ``n`` ranks of one "model" group, each holding both
(as ``cache_pspecs`` splits the sequence over "model" and ``param_pspecs``
the heads): :class:`Rank` is each one's merge (``max`` / ``sum`` over the
ranks) and its heads (``gather`` / ``own``). Held to the reference on the
whole cache and every head, fp32, rtol = atol = 2e-4
(``tests/test_kernels.py``):

* ``decode_attention`` over windows, grouped and expanded, on MHA and GQA
  head ratios: a scalar ``cur_len`` in one window, a ``[B]`` one with a
  row whose later windows are all masked (their max is ``NEG``: weight 0,
  not NaN) and a row at S_max (nothing written), and ``cur_len == S_max``;
  every rank's output, and the windows' new K / V put side by side;
* the same with the heads split too (wq, wo and, where the kv heads
  divide, wk / wv a rank's slice; the query heads and the new K / V
  gathered; the output the sum of the ranks' ``wo`` products), also with
  padded heads;
* ``cross_attend`` over windows of the encoder's slots with the heads
  split;
* ``ssm_decode`` on a rank's heads (``in_zx`` as the rank's z then x
  columns, ``in_bcdt``'s dt columns, the state's ``conv_x`` and ``ssd``
  the rank's; the gated norm's squares summed over the ranks): the sum of
  the ranks' outputs and their new state side by side.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.models import attention as r_attn
from repro.models import ssm as r_ssm
from repro_torch.models import attention as p_attn
from repro_torch.models import ssm as p_ssm
from test_torch_attention import (HEADS, activations, cfgs, close,
                                  decode_case, weights)

S_PROMPT, S_MAX = 9, 16
#: cur_len kinds: in the third of four windows; per row (row 0's later
#: windows all masked, row 2 at S_max); S_max itself.
CURS = {"scalar": np.int32(S_PROMPT),
        "per_row": np.array([1, 6, S_MAX], np.int32),
        "at_s_max": np.int32(S_MAX)}


class Ranks:
    """``n`` threads that swap tensors through a barrier."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots = [None] * n

    def swap(self, i: int, x: torch.Tensor) -> list:
        self.slots[i] = x.clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def run(self, fn) -> list:
        """``fn(rank)`` for every rank, each in its own thread."""
        out, errors = [None] * self.n, []

        def go(i):
            try:
                out[i] = fn(Rank(self, i))
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


class Rank:
    """One rank: the merge and the heads of ``attention.Window``."""

    def __init__(self, ranks: Ranks, index: int):
        self.ranks, self.index, self.size = ranks, index, ranks.n

    def max(self, x):
        return torch.stack(self.ranks.swap(self.index, x)).amax(0)

    def sum(self, x):
        return torch.stack(self.ranks.swap(self.index, x)).sum(0)

    def gather(self, x):
        return torch.cat(self.ranks.swap(self.index, x), dim=2)

    def own(self, x):
        h = x.shape[2] // self.size
        return x[:, :, self.index * h:(self.index + 1) * h]

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return t.tensor_split(self.size, dim)[self.index]


def window_of(rank: Rank, kv: p_attn.KVCache):
    s_l = kv.k.shape[1] // rank.size
    return (rank.index * s_l,
            p_attn.KVCache(rank.part(kv.k, 1), rank.part(kv.v, 1)))


def split_heads(rank: Rank, pt: dict, n_kv: int) -> dict:
    """The rank's projections: wq / wo its heads, wk / wv its kv heads
    where they divide, else whole (replicated)."""
    p = {"wq": rank.part(pt["wq"], 1), "wo": rank.part(pt["wo"], 0)}
    for k in ("wk", "wv"):
        p[k] = rank.part(pt[k], 1) if n_kv % rank.size == 0 else pt[k]
    return p


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("label,h,kv,hd", HEADS)
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("cur", list(CURS))
def test_decode_attention_over_windows_matches_jax(n, label, h, kv, hd,
                                                   grouped, cur):
    r_cfg, p_cfg, pj, pt, kv_r, kv_p = decode_case(h, kv, hd, S_PROMPT,
                                                   S_MAX, seed=4)
    lens = CURS[cur]
    x1 = activations((3, 1, 32), seed=12)
    y_r, new_r = r_attn.decode_attention(pj, jnp.asarray(x1), r_cfg, kv_r,
                                         jnp.asarray(lens), grouped=grouped)

    def rank(r: Rank):
        s0, c = window_of(r, kv_p)
        return p_attn.decode_attention(
            pt, torch.from_numpy(x1), p_cfg, c,
            torch.from_numpy(np.asarray(lens)), grouped=grouped,
            window=p_attn.Window(s0, r))

    out = Ranks(n).run(rank)
    for y, _ in out:
        assert torch.isfinite(y).all()
        close(y, y_r)
    close(torch.cat([c.k for _, c in out], 1), new_r.k)
    close(torch.cat([c.v for _, c in out], 1), new_r.v)


#: (ranks, label, n_heads, n_kv_heads, head_dim, padded heads): every
#: ratio of ``HEADS`` on 2 and 4 ranks, and 4 heads on 2 kv heads padded
#: by 2 (groups of 3) on 2.
SPLITS = [(n, *c, 0) for n in (2, 4) for c in HEADS] + [
    (2, "gqa2_pad2", 4, 2, 16, 2)]


@pytest.mark.parametrize("n,label,h,kv,hd,pad", SPLITS)
@pytest.mark.parametrize("grouped", [False, True])
def test_decode_attention_with_heads_split_matches_jax(n, label, h, kv, hd,
                                                       pad, grouped):
    r_cfg, p_cfg, _, _, kv_r, kv_p = decode_case(h, kv, hd, S_PROMPT, S_MAX,
                                                 seed=4)
    pj, pt = weights(32, h, kv, hd, pad)
    lens = CURS["per_row"]
    x1 = activations((3, 1, 32), seed=13)
    y_r, new_r = r_attn.decode_attention(pj, jnp.asarray(x1), r_cfg, kv_r,
                                         jnp.asarray(lens), grouped=grouped)

    def rank(r: Rank):
        s0, c = window_of(r, kv_p)
        return p_attn.decode_attention(
            split_heads(r, pt, kv), torch.from_numpy(x1), p_cfg, c,
            torch.from_numpy(lens), grouped=grouped,
            window=p_attn.Window(s0, r, r))

    out = Ranks(n).run(rank)
    close(sum(y for y, _ in out), y_r)
    close(torch.cat([c.k for _, c in out], 1), new_r.k)
    close(torch.cat([c.v for _, c in out], 1), new_r.v)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("label,h,kv,hd", HEADS)
def test_cross_attend_over_windows_matches_jax(n, label, h, kv, hd):
    d = 32
    r_cfg, p_cfg = cfgs(h, kv, hd, causal=False)
    pj, pt = weights(d, h, kv, hd)
    x = activations((2, 1, d), seed=7)
    enc = activations((2, 20, d), seed=8)
    want = r_attn.cross_attention(pj, jnp.asarray(x), jnp.asarray(enc),
                                  r_cfg)
    kv_p = p_attn.cross_kv(pt, torch.from_numpy(enc), torch.float32)

    def rank(r: Rank):
        s0, c = window_of(r, kv_p)
        return p_attn.cross_attend(split_heads(r, pt, kv),
                                   torch.from_numpy(x), c, p_cfg,
                                   window=p_attn.Window(s0, r, r))

    close(sum(Ranks(n).run(rank)), want)


@pytest.mark.parametrize("n", [2, 4])
def test_ssm_decode_on_the_ranks_heads_matches_jax(n):
    r_cfg = R.get_config("mamba2-780m").reduced(64)
    cfg = P.get_config("mamba2-780m").reduced(64)
    d, s = cfg.d_model, cfg.ssm
    di, gds = s.d_inner(d), 2 * s.n_groups * s.d_state
    p_jax = r_ssm.init_ssm(jax.random.key(3), d, r_cfg.ssm)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in p_jax.items()}
    x = activations((2, 32, d), seed=5) * 0.5
    _, st_r = r_ssm.ssm_forward(p_jax, jnp.asarray(x), d, r_cfg.ssm,
                                return_state=True)
    st = p_ssm.SSMState(*(torch.from_numpy(np.array(a)) for a in st_r))
    x1 = activations((2, 1, d), seed=6)
    y_r, new_r = r_ssm.ssm_decode(p_jax, jnp.asarray(x1), st_r, d,
                                  r_cfg.ssm)

    def rank(r: Rank):
        heads = r.part(torch.arange(s.n_heads(d)), 0)
        cols = r.part(torch.arange(di), 0)
        p = {k: r.part(pt[k], 0) for k in ("A_log", "D", "dt_bias",
                                            "norm_scale", "conv_x_b",
                                            "out_proj")}
        p.update(conv_x_w=r.part(pt["conv_x_w"], 1),
                 conv_bc_w=pt["conv_bc_w"], conv_bc_b=pt["conv_bc_b"],
                 in_zx=pt["in_zx"][:, torch.cat([cols, di + cols])],
                 in_bcdt=pt["in_bcdt"][:, torch.cat([torch.arange(gds),
                                                     gds + heads])])
        state = p_ssm.SSMState(conv_x=r.part(st.conv_x, 2),
                               conv_bc=st.conv_bc, ssd=r.part(st.ssd, 1))
        return p_ssm.ssm_decode(p, torch.from_numpy(x1), state, d, cfg.ssm,
                                norm_sum=r.sum)

    out = Ranks(n).run(rank)
    close(sum(y for y, _ in out), y_r)
    close(torch.cat([c.conv_x for _, c in out], 2), new_r.conv_x)
    for _, c in out:
        close(c.conv_bc, new_r.conv_bc)
    close(torch.cat([c.ssd for _, c in out], 1), new_r.ssd)
