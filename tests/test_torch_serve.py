"""The port's serving stack against the JAX package, on the CPU.

* ``serve/kvcache.py``, ``serve/scheduler.py`` and ``core/salp`` are
  framework-free copies: on a seeded workload they give the reference's
  page tables, free lists, batch orders and costs exactly.
* ``ServingEngine`` end to end on reduced mamba2-780m, with the same numpy
  weights in both packages: the generated tokens and ``EngineStats`` equal
  the JAX engine's exactly, under BASELINE and MASA.
* ``python -m repro_torch.launch.serve --reduced --device cpu`` runs.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
import repro_torch.configs as P
from repro.core.dram.policies import Policy as RPolicy
from repro.core.salp import cost_model as r_cost, pipeline as r_pipe
from repro.models import build_model as r_build_model
from repro.serve import kvcache as r_kv, scheduler as r_sched
from repro.serve.engine import ServingEngine as RServingEngine
from repro.serve.steps import make_decode_step as r_decode_step
from repro.serve.steps import make_prefill_step as r_prefill_step
from repro_torch import interop
from repro_torch.core.dram.policies import Policy as PPolicy
from repro_torch.core.salp import cost_model as p_cost, pipeline as p_pipe
from repro_torch.launch import serve as p_launch
from repro_torch.models import build_model
from repro_torch.serve import kvcache as p_kv, scheduler as p_sched
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.steps import make_decode_step, make_prefill_step

ARCH = "mamba2-780m"


def test_cost_model_and_pipeline_equal_reference():
    for pol in RPolicy:
        r_m = r_cost.SalpCostModel(policy=pol)
        p_m = p_cost.SalpCostModel(policy=PPolicy[pol.name])
        for cls, aw, sw in itertools.product(r_cost.AccessClass,
                                             (False, True), (False, True)):
            assert (p_m.cost(p_cost.AccessClass(int(cls)), aw, sw)
                    == r_m.cost(cls, aw, sw))
        order = [r_cost.AccessClass(i % 4) for i in range(11)]
        assert (p_m.order_cost([p_cost.AccessClass(int(c)) for c in order])
                == r_m.order_cost(order))
        assert p_m.column_cost(True) == r_m.column_cost(True)
    for f, c, w, reuse in itertools.product((3.0, 10.0), (4.0, 7.0),
                                            (2.0, 12.0), (0.0, 0.5)):
        assert (p_pipe.speedup_ladder(f, c, w, reuse)
                == r_pipe.speedup_ladder(f, c, w, reuse))


def kv_workload(kv, seed: int):
    """A seeded run of adds (with shared prefixes), extends and drops;
    returns every table, length and free count along the way."""
    rng = np.random.default_rng(seed)
    cache = kv.PagedKVCache(n_pages=160, page_size=8)
    trail, live = [], []
    for sid in range(40):
        while len(live) > 6 or (live and rng.random() < 0.3):
            cache.drop_sequence(live.pop(int(rng.integers(len(live)))))
        share = (live[int(rng.integers(len(live)))]
                 if live and rng.random() < 0.5 else None)
        try:
            cache.add_sequence(sid, int(rng.integers(1, 60)),
                               shared_prefix_of=share)
            live.append(sid)
        except MemoryError as e:
            trail.append(("oom", str(e)))
        for s in live:
            cache.extend(s, int(rng.integers(0, 4)))
        trail.append((dict(cache.tables), dict(cache.lengths),
                      cache.allocator.free_pages,
                      cache.block_table(live, 6).tolist(),
                      cache.seq_lens(live).tolist()))
    return trail


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kvcache_equals_reference(seed):
    assert kv_workload(p_kv, seed) == kv_workload(r_kv, seed)
    for page in range(300):
        assert ([int(v) for v in p_kv.page_class(page, 8, 4)]
                == [int(v) for v in r_kv.page_class(page, 8, 4)])
    a = p_kv.PageAllocator(64)
    b = r_kv.PageAllocator(64)
    assert a.alloc(10, interleave=False) == b.alloc(10, interleave=False)
    assert a.alloc(13) == b.alloc(13)


def sched_workload(kv, sched, policy, seed: int):
    """Seeded admissions, steps and retirements through SalpScheduler."""
    rng = np.random.default_rng(seed)
    cache = kv.PagedKVCache(n_pages=64, page_size=4)
    s = sched.SalpScheduler(cache, max_batch=5, policy=policy)
    for rid in range(12):
        share = rid - 1 if rid and rng.random() < 0.5 else None
        s.submit(sched.Request(rid, int(rng.integers(3, 30)),
                               int(rng.integers(1, 6)),
                               shared_prefix_of=share))
    trail = []
    for _ in range(30):
        admitted = [r.rid for r in s.admit()]
        if not s.running:
            break
        order = s.schedule_step()
        trail.append((admitted, order, s.order_cost(order),
                      s.order_cost(sorted(order)), s.step_done(order)))
    return trail


@pytest.mark.parametrize("policy", [p.name for p in RPolicy])
def test_scheduler_equals_reference(policy):
    for seed in range(3):
        assert (sched_workload(p_kv, p_sched, PPolicy[policy], seed)
                == sched_workload(r_kv, r_sched, RPolicy[policy], seed))


def requests(cfg, n: int, prompt_len: int, seed: int):
    """launch/serve.py's seeded prompt and shared-prefix draw."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
        share = rid - 1 if (rid > 0 and rng.random() < 0.5) else None
        out.append((rid, prompt, share))
    return out


@pytest.mark.parametrize("policy", ["BASELINE", "MASA"])
def test_engine_matches_jax(policy):
    """Reduced mamba2-780m, 6 requests through a batch of 4 (so some
    wait), same numpy weights: tokens and stats are the JAX engine's."""
    p_cfg = P.get_config(ARCH).reduced(128)
    r_cfg = R.get_config(ARCH).reduced(128)
    tree = interop.numpy_reference_params(p_cfg, seed=2)
    r_model = r_build_model(r_cfg, dtype=jnp.float32)
    r_engine = RServingEngine(r_model, jax.tree.map(jnp.asarray, tree),
                              max_batch=4, policy=RPolicy[policy])
    p_model = build_model(p_cfg, interop.params_from_reference(p_cfg, tree),
                          dtype=torch.float32, device="cpu")
    p_engine = ServingEngine(p_model, max_batch=4, policy=PPolicy[policy])
    reqs = requests(p_cfg, 6, 32, seed=4)
    for eng in (r_engine, p_engine):
        for rid, prompt, share in reqs:
            eng.submit(rid, prompt, 5, shared_prefix_of=share)
    r_stats, p_stats = r_engine.run(max_steps=100), p_engine.run(max_steps=100)
    assert dataclasses.asdict(p_stats) == dataclasses.asdict(r_stats)
    assert p_stats.tokens == 6 * 5 and p_stats.steps > 5
    for rid, _, _ in reqs:
        assert p_engine.output(rid) == r_engine.output(rid), rid


def test_step_functions_match_jax():
    """serve/steps.py: greedy next tokens after prefill and decode."""
    p_cfg = P.get_config(ARCH).reduced(64)
    tree = interop.numpy_reference_params(p_cfg, seed=5)
    r_model = r_build_model(R.get_config(ARCH).reduced(64), dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, tree)
    p_model = build_model(p_cfg, interop.params_from_reference(p_cfg, tree),
                          dtype=torch.float32, device="cpu")
    toks = np.random.default_rng(1).integers(0, 512, (3, 16), np.int32)
    r_next, r_cache = r_prefill_step(r_model)(params,
                                              {"tokens": jnp.asarray(toks)})
    p_next, p_cache = make_prefill_step(p_model)(
        {"tokens": torch.from_numpy(toks).long()})
    assert p_next.tolist() == np.asarray(r_next).tolist()
    for t in range(16, 19):
        r_next, r_cache = r_decode_step(r_model)(
            params, r_next[:, None], r_cache, jnp.int32(t))
        p_next, p_cache = make_decode_step(p_model)(p_next[:, None], p_cache,
                                                    t)
        assert p_next.tolist() == np.asarray(r_next).tolist()


def test_launch_serve_runs_on_the_cpu(capsys):
    engine = p_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "3", "--max-new", "4"])
    assert engine.stats.tokens == 12 and engine.stats.steps == 4
    assert engine.model.device.type == "cpu"
    assert "[serve] 12 tokens" in capsys.readouterr().out
