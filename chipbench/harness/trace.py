"""Reading the device trace of a measured window.

The window runs under ``torch.profiler`` (CPU and CUDA activities) and this
module reduces its events to what the per-layer readers and the result's
``breakdown`` take: the union of device activity, device time by
operation, and the longest idle gaps with the host operation that was
running in each.
"""
from __future__ import annotations

import re

_KERNEL = re.compile(r"(lane_step|mix_step)_(smem|global)")
#: the prefix of the benchmark's own spans around each job
SPAN = "job:"


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _annotation(ev) -> bool:
    is_user = getattr(ev, "is_user_annotation", None)
    return bool(is_user and is_user()) or ev.name().startswith(SPAN)


def short_name(name: str) -> str:
    """A device operation's name without its mangling or arguments."""
    found = _KERNEL.findall(name)
    if found:
        return "_".join(found[-1])
    return name.split("(")[0].strip()[:80]


def _union(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(prof) -> dict:
    """``busy_s``, ``device_s`` (seconds by short name), ``device_ops`` and
    ``idle_gaps`` (the ten largest each, as ``[name, seconds]``)."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if _annotation(ev):
            # a span's copy on the device timeline: not device work
            if "CUDA" not in str(ev.device_type()):
                host.append((start, start + dur, ev.name()))
            continue
        if "CUDA" in str(ev.device_type()):
            device.append((start, start + dur, ev.name()))
        else:
            host.append((start, start + dur, ev.name()))
    merged = _union([(a, b) for a, b, _ in device])
    busy = sum(b - a for a, b in merged)
    by_name: dict[str, float] = {}
    for a, b, name in device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    idle = [[_host_at(host, (a + b) // 2), g * 1e-9] for g, a, b in gaps]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy * 1e-9, device_s=by_name,
                device_ops=[[k, v] for k, v in ops], idle_gaps=idle)


def _host_at(host: list, t: int) -> str:
    """The innermost host operation running at ``t``, within its outermost
    benchmark span."""
    inner, outer = None, None
    for a, b, name in host:
        if a <= t <= b:
            if inner is None or b - a < inner[1] - inner[0]:
                inner = (a, b, name)
            if name.startswith(SPAN) and outer is None:
                outer = name
    if inner is None:
        return "host outside any traced operation"
    if outer is None or inner[2] == outer:
        return inner[2]
    return f"{inner[2]} in {outer}"
