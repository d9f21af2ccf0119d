"""Serve a model at full width with the port and hold it to its JAX
fixture: mamba2-780m (``tests/data/torch_serve_mamba2_780m.json``),
smollm-135m whole (``torch_serve_smollm_135m.json``) or
moonshot-v1-16b-a3b cut to 2 layers (``torch_serve_moonshot_16b_l2.json``).

NOT a test module (no ``test_`` prefix): full width is gigabytes of
float32 weights and some seconds of work a request, too much for the
tier-1 suite. ``chip_smoke.py`` runs these checks on the card; on the CPU
run

    PYTHONPATH=src:tests python tests/check_torch_serve.py --device cpu \
        [--arch smollm-135m]

(mamba2: about 10 GB and a few minutes). Imports nothing of the JAX
package.

* :func:`serve` runs ``repro_torch.launch.serve``'s path with the
  fixture's arguments (a fixture's ``n_repeats``, a depth cut, replaces
  the config's repeats, and the engine is built as the launcher builds
  it, by ``launch.serve.engine_for``), timing prefill and decode calls,
  and checks that the weights are the fixture's (sha256 of every leaf),
  that ``EngineStats`` equals the fixture's exactly, and that every
  request's tokens equal the fixture's at every step before the first
  whose fixture top-1/top-2 gap is under ``NEAR_TIE``.
* :func:`teacher_forced` feeds the fixture's tokens through ``prefill``
  and ``decode_step`` (the prefill cache padded to the engine's
  ``MAX_LEN`` slots, as the engine and the fixture pad it) and holds every
  step's logits at the fixture's top-8 ids within rtol = atol =
  ``LOGIT_TOL``.
* :func:`profile` traces one request's prefill and its decode steps with
  ``torch.profiler`` on the card: wall time, the time the card spent in
  kernels and copies, and the SSD-scan, grouped expert GEMM and other
  matmul (GEMM, GEMV) kernels' shares.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time

import torch

import torch_cases as tc
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.engine import grow_cache

#: A step whose fixture top-1/top-2 logit gap is under this may pick
#: another token in a different summation order.
NEAR_TIE = 1e-2
#: fp32 over up to 48 layers with sums in another order.
LOGIT_TOL = 1e-3
#: ServingEngine.run's default max_len: the slots of a decode cache (the
#: fixture's teacher forcing pads the prefill cache to it, as the engine).
MAX_LEN = 256


class CheckFailed(Exception):
    pass


def launch_args(fixture: dict, device: str) -> list[str]:
    a = fixture["args"]
    return ["--arch", a["arch"], "--requests", str(a["requests"]),
            "--prompt-len", str(a["prompt_len"]), "--max-new",
            str(a["max_new"]), "--max-batch", str(a["max_batch"]),
            "--shared-prefix", str(a["shared_prefix"]), "--policy",
            a["policy"], "--seed", str(a["seed"]), "--device", device]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, acc: dict, key: str):
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync(device)
        acc[key] += time.perf_counter() - t0
        acc[key + "_calls"] += 1
        return out
    return wrapper


def check_weights(model, fixture: dict) -> None:
    want = fixture["weights"]["sha256"]
    got = {k: hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
           for k, v in model.state_dict().items()}
    if got != want:
        bad = sorted(k for k in want if got.get(k) != want[k])
        raise CheckFailed(f"weights differ from the fixture's numpy stream in "
                          f"{bad[:4]} ({len(bad)} leaves): a numpy stream "
                          f"failure, not a kernel error")


def serve(fixture: dict, device: str) -> dict:
    """launch.serve's path with the fixture's arguments; raises CheckFailed
    on any mismatch. Returns stats, timings and the near-tie count."""
    t0 = time.perf_counter()
    args = launch_serve.parse_args(launch_args(fixture, device))
    cut = fixture["args"].get("n_repeats")
    if cut is None:
        engine = launch_serve.build(args)
    else:
        engine = launch_serve.engine_for(dataclasses.replace(
            get_config(args.arch), n_repeats=cut), args)
    model = engine.model
    dev = model.device
    _sync(dev)
    t_build = time.perf_counter() - t0
    check_weights(model, fixture)
    times = dict(prefill=0.0, prefill_calls=0, decode=0.0, decode_calls=0)
    model.prefill = _timed(model.prefill, dev, times, "prefill")
    model.decode_step = _timed(model.decode_step, dev, times, "decode")
    try:
        t1 = time.perf_counter()
        stats = engine.run(max_steps=10_000, max_len=MAX_LEN)
        _sync(dev)
        wall = time.perf_counter() - t1
    finally:
        del model.prefill, model.decode_step
    if dataclasses.asdict(stats) != fixture["stats"]:
        raise CheckFailed(f"EngineStats {dataclasses.asdict(stats)} != "
                          f"fixture {fixture['stats']}")
    near_ties, compared = 0, 0
    for req in fixture["requests"]:
        out = engine.output(req["rid"])
        if out[:len(req["prompt"])] != req["prompt"]:
            raise CheckFailed(f"request {req['rid']}: prompt differs from the "
                              f"fixture's (the seeded draw changed)")
        gen = out[len(req["prompt"]):]
        if len(gen) != len(req["generated"]):
            raise CheckFailed(f"request {req['rid']}: {len(gen)} tokens, "
                              f"fixture {len(req['generated'])}")
        ties = [i for i, s in enumerate(req["steps"]) if s["gap"] < NEAR_TIE]
        near_ties += len(ties)
        upto = ties[0] if ties else len(gen)
        if gen[:upto] != req["generated"][:upto]:
            first = next(i for i in range(upto)
                         if gen[i] != req["generated"][i])
            raise CheckFailed(f"request {req['rid']}: token {first} is "
                              f"{gen[first]}, fixture "
                              f"{req['generated'][first]} (gap "
                              f"{req['steps'][first]['gap']:.4g})")
        compared += upto
    n_prompt = sum(len(r["prompt"]) for r in fixture["requests"])
    return dict(stats=dataclasses.asdict(stats), build_s=t_build, wall_s=wall,
                prefill_s=times["prefill"], decode_s=times["decode"],
                prefill_calls=times["prefill_calls"],
                decode_calls=times["decode_calls"],
                prefill_tok_s=n_prompt / times["prefill"],
                decode_tok_s=stats.tokens / times["decode"],
                near_ties=near_ties, tokens_compared=compared,
                model=model)


def teacher_forced(model, fixture: dict) -> dict:
    """Every step's logits at the fixture's top-8 ids, within LOGIT_TOL.
    Returns the max abs error and the max of |err| / (atol + rtol |v|)."""
    dev = model.device
    max_abs, max_ratio, top1_same, steps = 0.0, 0.0, 0, 0
    for req in fixture["requests"]:
        toks = torch.tensor(req["prompt"], dtype=torch.long, device=dev)[None]
        logits, cache = model.prefill({"tokens": toks})
        cache = grow_cache(cache, toks.shape[1], MAX_LEN)
        rows = [logits[0, -1]]
        for i, tok in enumerate(req["generated"][:-1]):
            logits, cache = model.decode_step(
                torch.tensor([[tok]], dtype=torch.long, device=dev), cache,
                len(req["prompt"]) + i)
            rows.append(logits[0, -1])
        for k, (row, want) in enumerate(zip(rows, req["steps"])):
            got = row[torch.tensor(want["top_ids"], device=dev)].double().cpu()
            ref = torch.tensor(want["top_vals"], dtype=torch.float64)
            err = (got - ref).abs()
            ratio = err / (LOGIT_TOL + LOGIT_TOL * ref.abs())
            max_abs = max(max_abs, float(err.max()))
            max_ratio = max(max_ratio, float(ratio.max()))
            top1_same += int(int(row.argmax()) == want["top_ids"][0])
            steps += 1
            if not bool((ratio <= 1.0).all()):
                raise CheckFailed(f"request {req['rid']} step {k}: logits at "
                                  f"the fixture's top-8 ids differ by up to "
                                  f"{float(err.max()):.4g} (limit rtol = atol"
                                  f" = {LOGIT_TOL})")
    return dict(max_abs_err=max_abs, max_err_over_limit=max_ratio,
                steps=steps, top1_same=top1_same)


def profile(model, fixture: dict) -> dict | None:
    """Device time of one request's prefill and of its decode steps, from
    a ``torch.profiler`` trace (None when the trace holds no device
    activity). The profiler adds host time, so its walls are upper bounds
    of the unprofiled ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    dev = model.device
    req = fixture["requests"][0]
    toks = torch.tensor(req["prompt"], dtype=torch.long, device=dev)[None]

    def decode(cache):
        for i, tok in enumerate(req["generated"][:-1]):
            _, cache = model.decode_step(
                torch.tensor([[tok]], dtype=torch.long, device=dev), cache,
                len(req["prompt"]) + i)

    _, cache = model.prefill({"tokens": toks})     # warm-up
    cache = grow_cache(cache, toks.shape[1], MAX_LEN)
    _sync(dev)
    out = {}
    for name, work in (("prefill", lambda: model.prefill({"tokens": toks})),
                       ("decode", lambda: decode(cache))):
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            return None
        by_name: dict[str, list] = {}
        for e in kernels:
            t = by_name.setdefault(e.name, [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
        busy = sum(t for t, _ in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        ms = {k: 0.0 for k in ("ssd_scan", "moe_gemm", "matmul")}
        for n, (t, _) in by_name.items():
            key = next((k for k in ("ssd_scan", "moe_gemm") if k in n),
                       "matmul" if "gemm" in n.lower() or "gemv" in n.lower()
                       else None)
            if key:
                ms[key] += t
        out[name] = dict(
            wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
            device_ops=len(kernels),
            **{f"{k}_ms": v for k, v in ms.items()},
            top=[(n[:60], t, c) for n, (t, c) in top])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--arch", default="mamba2-780m",
                    choices=list(tc.SERVE_PATHS))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fixture = tc.serve_fixture(args.arch)
    try:
        res = serve(fixture, args.device)
        tf = teacher_forced(res.pop("model"), fixture)
    except CheckFailed as e:
        print(f"check_torch_serve: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(device=args.device, serve=res,
                          teacher_forced=tf), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
