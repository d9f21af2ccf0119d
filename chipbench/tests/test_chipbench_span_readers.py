"""The readers of the program's spans and counter: each value from a
synthetic table, and None where the window launched nothing, where the
table lacks its entry, and where the program has no ``repro_torch.obs``."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

from chipbench.harness import main

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

#: metric -> (table, entry, value read from TABLES at LAUNCHES)
READS = {
    "sweep.cell_key_ms_per_launch": ("SPANS", "sweep.cell_key", 0.75),
    "sweep.stack_ms_per_launch": ("SPANS", "sweep.stack", 0.05),
    "engine.pack_ms_per_launch": ("SPANS", "engine.pack", 0.3),
    "sweep.readback_ms_per_launch": ("SPANS", "sweep.readback", 0.125),
    "engine.h2d_copies_per_launch": ("COUNTS", "engine.h2d_copies", 8.5),
}
LAUNCHES = {"lane_step": 150, "mix_step": 10}
#: [count, total_ns, self_ns]: totals of 160 launches at the values above
TABLES = {
    "SPANS": {"sweep.cell_key": [32, 120_000_000, 120_000_000],
              "sweep.stack": [160, 8_000_000, 8_000_000],
              "engine.pack": [160, 48_000_000, 40_000_000],
              "engine.range_check": [160, 8_000_000, 8_000_000],
              "sweep.readback": [170, 20_000_000, 20_000_000]},
    "COUNTS": {"engine.h2d_copies": 1360},
}


def ctx(launches):
    return dict(window_s=1.0, busy_s=0.5, device_s={}, launches=launches,
                work={}, trace_gen_s=None, hbm_bytes_per_s=None)


def reader(metric):
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["name"] in next(m for m in BENCH["per_layer"]
                                     if m["name"] == metric).get(
                    "workloads", [w["name"]]))
    return main.readers(BENCH, cell)[metric][1]


@pytest.fixture
def tables(monkeypatch):
    from repro_torch import obs
    for name, table in TABLES.items():
        monkeypatch.setattr(obs, name, {k: (list(v) if isinstance(v, list)
                                            else v)
                                        for k, v in table.items()})
    return obs


@pytest.mark.parametrize("metric", sorted(READS))
def test_reads_the_table_over_the_launches(tables, metric):
    assert reader(metric)(ctx(LAUNCHES)) == pytest.approx(READS[metric][2])


@pytest.mark.parametrize("metric", sorted(READS))
def test_none_without_launches(tables, metric):
    read = reader(metric)
    assert read(ctx({})) is None
    assert read(ctx({"lane_step": 0, "mix_step": 0})) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_none_without_the_entry(tables, metric):
    table, entry, _ = READS[metric]
    del getattr(tables, table)[entry]
    assert reader(metric)(ctx(LAUNCHES)) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_none_where_the_program_has_no_spans(monkeypatch, metric):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs", raising=False)
    assert reader(metric)(ctx(LAUNCHES)) is None


def test_every_span_metric_is_read_here():
    ours = {m["name"] for m in BENCH["per_layer"]
            if m["source"] in ("program_span", "program_counter")}
    assert ours == set(READS)
