"""The port's bench runner and validator equal the JAX package's.

``repro_torch.benchmarks.run`` against the repo's ``benchmarks/run.py``: the
registry's keys and suites, ``select()`` over suite and ``--only``
combinations, the exit-2 errors, and the FAILED / SKIPPED rows. Smoke
through ``run.main`` on the CPU equals the committed JAX fixture
(``tests/make_torch_paper_benches_fixture.py``: cells, summary, command
slice) and validates, also as a fault drill (``--inject-faults`` +
``--expect-quarantine``), a journal run twice (``--expect-resume``) and a
sharded run (``--shards`` / ``--fragments`` + ``--check-shards``); the
``kernels`` entry validates. ``repro_torch.benchmarks.validate``'s new
suites and modes give the reference's verdicts, message for message, on
the same good and doctored documents, and ``check_shards`` re-merges the
committed ``tests/data/shard_fragments/``. ``perf_bench`` at a tiny size
validates, keeps a trajectory under ``artifacts/torch/`` and leaves the JAX
package's ``artifacts/BENCH_perf.json`` as it was.

Everything runs on ``device="cpu"`` (the kernels' plain versions).
"""
import contextlib
import io
import json
import shutil
from pathlib import Path

import pytest

import torch_cases as tc
from benchmarks import run as R_run
from benchmarks import serving_bench as R_serving
from benchmarks import validate as R_validate
from repro_torch.benchmarks import perf_bench as P_perf
from repro_torch.benchmarks import run as P_run
from repro_torch.benchmarks import serving_bench as P_serving
from repro_torch.benchmarks import validate as P_validate
from test_artifacts import make_doc
from test_torch_refresh_memtech import mutate, verdict

ROOT = Path(__file__).resolve().parent.parent
SHARD_FRAGMENTS = ROOT / "tests" / "data" / "shard_fragments"


def quiet(fn, *args):
    """``fn(*args)`` with stdout captured: ``(result, stdout)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def test_list_matches_reference():
    _, ref = quiet(R_run.main, ["--list"])
    _, port = quiet(P_run.main, ["--list"])

    def cols(text):
        return [tuple(line.split()[:2]) for line in text.splitlines()]

    assert cols(port) == cols(ref) and len(cols(port)) == 14


@pytest.mark.parametrize("suite,only", [
    (None, None), ("paper", None), ("sens", None), ("system", None),
    ("sched", None), ("accel", None), ("kernel", None), ("smoke", None),
    ("paper,sens,system,mapping,accel,smoke", None), ("perf,refresh", None),
    (None, "fig4"), (None, "smoke,perf"), ("paper", "mapping"),
    ("smoke", "fig5,kernels"),
])
def test_select_matches_reference(suite, only):
    assert [b.key for b in P_run.select(suite, only)] == \
        [b.key for b in R_run.select(suite, only)]


@pytest.mark.parametrize("argv", [["--suite", "papr"], ["--only", "fig6"],
                                  ["--suite", "paper,nope"],
                                  ["--only", "fig4,smoke,xyz"]])
def test_unknown_names_exit_2_like_reference(argv, capsys):
    errs = []
    for main in (R_run.main, P_run.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[1] == errs[0] and "unknown" in errs[1]


def test_failed_and_skipped_rows_like_reference(monkeypatch, tmp_path):
    """A failing bench prints a FAILED row and leaves no summary; a missing
    module prints a SKIPPED row — on both runners alike."""
    def boom(device=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(R_serving, "run", boom)
    monkeypatch.setattr(P_serving, "run", boom)
    rows = []
    for main, run_mod in ((R_run.main, R_run), (P_run.main, P_run)):
        missing = run_mod.Bench("ghost", "no_such_bench_module", ("x",), "")
        monkeypatch.setattr(run_mod, "REGISTRY",
                            run_mod.REGISTRY + (missing,))
        doc, out = quiet(main, ["--only", "serving,ghost", "--out",
                                str(tmp_path / "a.json")])
        assert doc["results"] == {}
        rows.append([line for line in out.splitlines()
                     if "FAILED" in line or "SKIPPED" in line])
    assert rows[1] == rows[0] == [
        "serving.FAILED,0.0,RuntimeError:boom",
        "ghost.SKIPPED,0.0,module_missing:no_such_bench_module"]


def run_smoke(tmp_path, name: str, *extra) -> tuple[dict, Path]:
    out = tmp_path / f"{name}.json"
    doc, _ = quiet(P_run.main, ["--suite", "smoke", "--device", "cpu",
                                "--out", str(out), *extra])
    return doc, out


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run from a scratch directory: the benches write artifacts/torch/."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_smoke_run_equals_fixture_and_validates(in_tmp, capsys):
    doc, out = run_smoke(in_tmp, "smoke")
    fixture = tc.paper_benches_fixture()
    smoke = dict(doc["results"]["smoke"])
    cmd = smoke.pop("commands")
    assert cmd["path"] == "artifacts/torch/commands_smoke.trace"
    assert {k: v for k, v in cmd.items() if k != "path"} == \
        fixture["smoke_commands"]
    assert json.loads(json.dumps(smoke)) == fixture["summaries"]["smoke"]
    for s in doc["sweeps"]:
        name = s["grid"]["name"]
        want = [c for c in fixture["cells"] if c["grid"] == name]
        assert [{"grid": name, **{k: c[k] for k in w if k != "grid"}}
                for c, w in zip(s["cells"], want)] == want, name
        assert len(s["cells"]) == len(want) == {"smoke": 18,
                                                "smoke_sched": 8}[name]
    assert P_validate.main([str(out), "--check-commands", cmd["path"]]) == 0
    assert P_validate.main([str(out), "--expect-quarantine"]) == 1
    capsys.readouterr()


def test_smoke_fault_drill_quarantines(in_tmp, capsys):
    doc, out = run_smoke(in_tmp, "fault", "--inject-faults", "raise@c4:p")
    assert doc["fault_injection"] == "raise@c4:p"
    assert doc["results"]["smoke"]["quarantined"] >= 1
    assert P_validate.main([str(out), "--expect-quarantine"]) == 0
    assert "quarantined cell(s)" in capsys.readouterr().out
    # the drill is scoped to its invocation: the next run is clean
    doc, _ = run_smoke(in_tmp, "after")
    assert doc["results"]["smoke"]["quarantined"] == 0


def test_smoke_journal_resumes(in_tmp, capsys):
    journal = str(in_tmp / "cache.jsonl")
    _, first = run_smoke(in_tmp, "j1", "--journal", journal)
    doc, second = run_smoke(in_tmp, "j2", "--journal", journal)
    assert doc["cache_stats"]["loaded"] == doc["cache_stats"]["hits"] == 18
    assert P_validate.main([str(second), "--expect-resume"]) == 0
    assert P_validate.main([str(first), "--expect-resume"]) == 1
    capsys.readouterr()


def test_smoke_shards_remerge(in_tmp, capsys):
    frags = in_tmp / "frags"
    doc, out = run_smoke(in_tmp, "sharded", "--shards", "2", "--fragments",
                         str(frags))
    assert doc["sharding"]["n_shards"] == 2
    assert doc["sharding"]["devices"] == ["cpu"]
    assert sorted(p.name for p in frags.iterdir()) == ["smoke",
                                                       "smoke_sched"]
    assert P_validate.main([str(out), "--check-shards", str(frags)]) == 0
    assert "2 sweep(s) re-merged bit-identical" in capsys.readouterr().out
    # --mesh cpu:4 selects torch's one CPU device
    doc, _ = run_smoke(in_tmp, "mesh", "--mesh", "cpu:4")
    assert doc["sharding"]["devices"] == ["cpu"]


def test_kernels_entry_validates(in_tmp, capsys):
    out = in_tmp / "kernels.json"
    doc, _ = quiet(P_run.main, ["--only", "kernels", "--device", "cpu",
                                "--out", str(out)])
    assert doc["results"]["kernels"]["kernels_ok"] is True
    assert P_validate.main([str(out)]) == 0
    assert "[kernels]" in capsys.readouterr().out


def golden_shard_doc(root: Path) -> dict:
    """The committed fragments under ``root/<grid>/`` and an artifact whose
    one sweep is their committed merge."""
    merged = json.loads((SHARD_FRAGMENTS / "merged.json").read_text())
    sub = root / merged["grid"]["name"]
    sub.mkdir(parents=True)
    for p in SHARD_FRAGMENTS.glob("fragment-*.json"):
        shutil.copy(p, sub / p.name)
    return {**make_doc("smoke"), "sweeps": [merged]}


def test_check_shards_same_verdicts(tmp_path):
    doc = golden_shard_doc(tmp_path)
    root = str(tmp_path)
    cases = [(root, doc),
             (root, mutate(doc, "sweeps.0.cells.0.counters.n_act", -1)),
             (root, mutate(doc, "sweeps.0.quarantined", [])),
             (root, mutate(doc, "sweeps.0.stats.n_cells", 5)),
             (root, mutate(doc, "sweeps.0.grid.name", "other")),
             (str(tmp_path / "missing"), doc)]
    got = [verdict(P_validate, "check_shards", *a) for a in cases]
    assert got == [verdict(R_validate, "check_shards", *a) for a in cases]
    assert [v.split(":")[0] for v in got] == ["ok"] + ["invalid"] * 5
    assert "golden_shards(4f/4s)" in got[0]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert verdict(P_validate, "check_shards", str(empty), doc) == \
        verdict(R_validate, "check_shards", str(empty), doc)


def quarantined_doc() -> dict:
    doc = make_doc("smoke")
    doc["fault_injection"] = "raise@c4:p"
    doc["results"]["smoke"]["quarantined"] = 1
    doc["sweeps"][0].update(
        stats={"n_cells": 2, "quarantined_cells": 1}, cells=[{}],
        quarantined=[{"error": "boom", "policy": "MASA", "workload": "mcf",
                      "attempts": 3}])
    return doc


#: Broken artifacts, each one field off a good one (path, bad value);
#: KeyError deletes the field.
BROKEN = {
    "smoke": [("schema_version", "repro.bench/v0"), ("git_sha", "unknown"),
              ("results.smoke.ladder_ok", False),
              ("results.smoke.sched_ok", False), ("sweeps", []),
              ("sweeps.1.kind", "sweep"),
              ("sweeps.0.schema_version", "repro.sweep/v0"),
              ("results.smoke.quarantined", 2),
              ("fault_injection", KeyError),
              ("sweeps.0.quarantined.0.attempts", 0)],
    "mapping": [("seed", None), ("results.mapping.collapse_ok", False),
                ("results.mapping.gain_contiguous_MASA", 20.0),
                ("results.mapping.gain_xor_MASA", KeyError),
                ("results.mapping.footprint_rows", 512),
                ("sweeps.0.grid.name", "other"),
                ("sweeps.0.cells.2.overrides.mapping", "bitsliced")],
    "kernels": [("results.kernels.kernels_ok", False),
                ("results.kernels.errs.ssd_scan", 1.0),
                ("results.kernels.errs.flash_attention", KeyError),
                ("results.kernels.ladder.masa", 0.9),
                ("results.kernels.ladder.baseline", 2.0)],
    "perf": [("results.perf.default_req_per_s", 0),
             ("results.perf.n_cells", 3),
             ("results.perf.cells.0.warm_s", KeyError),
             ("results.perf.cells", [])],
}


def good_doc(suite: str) -> dict:
    return quarantined_doc() if suite == "smoke" else make_doc(suite)


@pytest.mark.parametrize("suite", sorted(BROKEN))
def test_validators_same_verdicts(suite):
    fn = f"validate_{suite}"
    doc = good_doc(suite)
    ok = verdict(P_validate, fn, doc)
    assert ok.startswith(f"ok: {suite} ok") and ok == verdict(R_validate, fn,
                                                              doc)
    assert P_validate.detect_suite(doc) == R_validate.detect_suite(doc) == \
        suite
    for path, value in BROKEN[suite]:
        bad = mutate(doc, path, value)
        got = verdict(P_validate, fn, bad)
        assert not got.startswith("ok"), path
        assert got == verdict(R_validate, fn, bad), path


def test_expect_modes_same_verdicts():
    docs = [make_doc("smoke"), quarantined_doc(),
            mutate(quarantined_doc(), "sweeps.0.stats",
                   {"n_cells": 1, "quarantined_cells": 1}),
            {**make_doc("smoke"), "cache_stats": {
                "journal": "j.jsonl", "loaded": 4, "hits": 4, "misses": 0}},
            {**make_doc("smoke"), "cache_stats": {
                "journal": "j.jsonl", "loaded": 4, "hits": 0}}]
    for fn in ("expect_quarantine", "expect_resume"):
        got = [verdict(P_validate, fn, d) for d in docs]
        assert got == [verdict(R_validate, fn, d) for d in docs]
    assert [verdict(P_validate, "expect_quarantine", d).split(":")[0]
            for d in docs] == ["invalid", "ok", "invalid", "invalid",
                               "invalid"]
    assert [verdict(P_validate, "expect_resume", d).split(":")[0]
            for d in docs] == ["invalid"] * 3 + ["ok", "invalid"]


def test_cli_exit_codes(tmp_path, capsys):
    art = tmp_path / "a.json"
    art.write_text(json.dumps(make_doc("mapping")))
    for validate in (R_validate, P_validate):
        assert validate.main([str(art)]) == 0
        assert validate.main([str(art), "--perf-guard"]) == 2
        assert validate.main([str(art), "--expect-resume"]) == 1
        assert validate.main([str(tmp_path / "missing.json")]) == 1
    art.write_text(json.dumps(mutate(make_doc("mapping"),
                                     "results.mapping.gain_xor_MASA",
                                     KeyError)))
    assert P_validate.main([str(art)]) == R_validate.main([str(art)]) == 1
    assert "malformed document" in capsys.readouterr().err
    art.write_text(json.dumps({**make_doc("smoke"), "results": {
        "smoke": {}, "mapping": {}}}))
    assert P_validate.main([str(art)]) == R_validate.main([str(art)]) == 2


def perf_doc(kernel_batch: float = 1.5, prev_batch: float | None = None):
    """A port perf artifact with a kernel leg (and a previous point)."""
    doc = make_doc("perf")
    perf = doc["results"]["perf"]
    perf["backends"] = {b: {"single_req_per_s": 1e5, "batch32_req_per_s": 2e5}
                        for b in ("cuda", "plain")}
    perf["kernel_vs_plain"] = {"kernel_backend": "cuda", "single": 1.2,
                               "batch32": kernel_batch}
    if prev_batch is not None:
        doc["trajectory"] = [{"git_sha": "e" * 40,
                              "batch32_req_per_s": prev_batch}]
    return doc


def test_perf_validator_and_guard(tmp_path, capsys):
    art = tmp_path / "perf.json"
    for doc, rc, warn in ((perf_doc(), 0, None),
                          (perf_doc(0.5), 0, "Kernel vs plain"),
                          (perf_doc(prev_batch=1e9), 0, "Perf trajectory"),
                          (mutate(perf_doc(), "results.perf.backends.plain",
                                  KeyError), 1, None),
                          (mutate(perf_doc(), "results.perf.kernel_vs_plain",
                                  None), 1, None)):
        art.write_text(json.dumps(doc))
        assert P_validate.main([str(art), "--perf-guard"]) == rc
        out = capsys.readouterr().out
        assert ("::warning" in out) == (warn is not None)
        if warn:
            assert warn in out


def test_perf_bench_tiny_validates(in_tmp, monkeypatch, capsys):
    """perf_bench at 64 requests on the CPU: the artifact validates under
    the guard, lands under artifacts/torch/ and chains its trajectory; the
    JAX package's artifacts/BENCH_perf.json stays byte for byte."""
    jax_perf = ROOT / "artifacts" / "BENCH_perf.json"
    before = jax_perf.read_bytes() if jax_perf.exists() else None
    monkeypatch.setattr(P_perf, "N_PERF", 64)
    monkeypatch.setattr(P_perf, "N_SHORT", 32)
    monkeypatch.setattr(P_perf, "PLAIN_REPEATS", 1)
    for _ in range(2):
        summary = P_perf.run(device="cpu")
    art = in_tmp / P_perf.OUT_PATH
    assert P_perf.OUT_PATH == "artifacts/torch/BENCH_perf.json"
    doc = json.loads(art.read_text())
    assert doc["results"]["perf"] == json.loads(json.dumps(summary))
    assert len(doc["trajectory"]) == 1
    assert set(summary["backends"]) == {"plain"}
    assert summary["kernel_vs_plain"] is None
    assert set(summary["per_step_ns"]["plain"]) == {"n32", "n64"}
    assert [c["name"] for c in summary["cells"]] == [
        "single/BASELINE/8x8", "single/MASA/8x8", "single/MASA/16x8",
        "single/MASA/8x16", "batch32/MASA/8x8",
        "multicore2/MASA/FRFCFS/8x8", "multicore4/MASA/FRFCFS/8x8"]
    assert P_validate.main([str(art), "--perf-guard"]) == 0
    assert "no kernel leg" in capsys.readouterr().out
    after = jax_perf.read_bytes() if jax_perf.exists() else None
    assert after == before


def test_artifact_paths_stay_under_artifacts_torch():
    assert P_run.OUT_DEFAULT.startswith("artifacts/torch/")
    assert P_perf.OUT_PATH.startswith("artifacts/torch/")
    src = (ROOT / "src" / "repro_torch" / "benchmarks").glob("*.py")
    for path in src:
        for line in path.read_text().splitlines():
            if '"artifacts/' in line:
                assert '"artifacts/torch' in line, (path.name, line)
    assert P_validate.SUITES.keys() == R_validate.SUITES.keys()
