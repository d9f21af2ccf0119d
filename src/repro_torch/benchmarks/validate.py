"""Artifact validation for the port's benches (the port of the repo's
``benchmarks/validate.py``).

One exit-code-driven checker for every suite the port's runner
(``repro_torch.benchmarks.run``) and benches write. The checks are the
reference's, word for word, except for the perf suite, whose backend axis is
the port's (``cuda`` against ``plain``, ``kernel_vs_plain``) and whose guard
has no CPU-host reference point.

Usage::

    python -m repro_torch.benchmarks.validate artifacts/torch/bench.json \
        --suite smoke --check-commands artifacts/torch/commands_smoke.trace
    python -m repro_torch.benchmarks.validate artifacts/torch/BENCH_perf.json \
        --suite perf --perf-guard

Suites: ``smoke`` / ``mapping`` / ``perf`` / ``refresh`` / ``kernels`` /
``memtech`` (auto-detected from the artifact's ``results`` keys when
``--suite`` is omitted). Exit code 0 = valid, 1 = validation failed or
unreadable, 2 = bad invocation (no suite to detect, or a flag that does not
apply).

``--check-commands PATH`` re-parses a command-trace dump the bench left next
to the artifact (``repro_torch.benchmarks.common.command_slice``), re-runs
the JEDEC checker (the port's copy) on it from scratch, and pins its sha256
against the artifact's ``results.<suite>.commands`` record — so the dumped
trace, the checked trace, and the summarized trace are provably the same
bytes.

``--check-shards DIR`` re-merges the shard fragments a sharded run streamed
(``repro_torch.benchmarks.run --shards/--fragments``) and pins the merged
cells and quarantine records against the artifact's sweeps — proving the
streamed fragments reassemble bit-identically to the artifact.

``--expect-quarantine`` (fault drill) and ``--expect-resume`` (journal
replay) fail unless the run stranded cells, or replayed cells from a
journal.

``--perf-guard`` (perf suite only) compares the kernel with its plain
version (the artifact's same-process ``kernel_vs_plain``) and with the
previous artifact's trajectory point, and prints a ``::warning`` line —
never a failure; a speed reading is too noisy to gate on — when the kernel
is slower than plain or throughput drops below ``PERF_GUARD_RATIO`` of the
previous point.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable

#: Warn (never fail) when batch32 req/s < ratio * the previous artifact's.
PERF_GUARD_RATIO = 0.5


class ValidationError(AssertionError):
    """An artifact failed a suite's schema/content checks."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValidationError(msg)


def validate_common(doc: dict) -> None:
    """Checks every ``repro.bench/v1`` artifact must pass."""
    _check(doc.get("schema_version") == "repro.bench/v1",
           f"schema_version: {doc.get('schema_version')!r}")
    _check(bool(doc.get("git_sha")) and doc["git_sha"] != "unknown",
           f"git_sha: {doc.get('git_sha')!r}")
    _check(doc.get("seed") is not None, "seed missing")
    _validate_quarantine(doc)


def _quarantined_records(doc: dict) -> list[dict]:
    """All quarantine records across the artifact's sweeps."""
    return [q for s in doc.get("sweeps") or ()
            for q in s.get("quarantined") or ()]


def _validate_quarantine(doc: dict) -> None:
    """Structural checks on the resilience layer's quarantine records.

    Every sweep's completed + quarantined cell counts must add back up to
    the grid size (no cell silently dropped), and each record must be
    self-describing enough to re-run the stranded cell by hand.
    """
    for s in doc.get("sweeps") or ():
        stats = s.get("stats") or {}
        if "quarantined_cells" in stats:
            _check(len(s.get("cells") or ()) + stats["quarantined_cells"]
                   == stats.get("n_cells"),
                   f"sweep {s.get('grid', {}).get('name')!r}: cells "
                   f"({len(s.get('cells') or ())}) + quarantined "
                   f"({stats['quarantined_cells']}) != n_cells "
                   f"({stats.get('n_cells')})")
        for q in s.get("quarantined") or ():
            _check(bool(q.get("error")) and q.get("policy")
                   and (q.get("workload") or q.get("mix"))
                   and q.get("attempts", 0) >= 1,
                   f"malformed quarantine record: {q}")


def expect_quarantine(doc: dict) -> str:
    """Fault-drill mode: the run was EXPECTED to strand cells (the drill
    injects a persistent fault and asserts the pipeline quarantined instead
    of died)."""
    qs = _quarantined_records(doc)
    _check(bool(qs), "expected quarantined cells, found none — the "
                     "fault-injection drill did not exercise quarantine")
    for s in doc.get("sweeps") or ():
        n_bad = (s.get("stats") or {}).get("quarantined_cells", 0)
        n_cells = (s.get("stats") or {}).get("n_cells", 0)
        _check(n_bad < n_cells or n_cells == 0,
               f"sweep {s.get('grid', {}).get('name')!r} quarantined every "
               f"cell ({n_bad}/{n_cells}) — bisection stranded nothing")
    return f"{len(qs)} quarantined cell(s), bisection stranded < grid"


def expect_resume(doc: dict) -> str:
    """Journal-resume mode: a prior process filled the cache journal, so this
    run must have replayed completed cells from disk (hits > 0)."""
    cs = doc.get("cache_stats") or {}
    _check(cs.get("journal") is not None,
           f"no journal recorded in cache_stats: {cs}")
    _check(cs.get("loaded", 0) > 0 and cs.get("hits", 0) > 0,
           f"expected journal-replayed cells (loaded>0, hits>0): {cs}")
    return (f"resumed from {cs['journal']}: loaded={cs['loaded']} "
            f"hits={cs['hits']} misses={cs.get('misses')}")


def _validate_commands_record(suite: str, summary: dict) -> None:
    """Shared checks for a ``results.<suite>.commands`` record, when present.

    Conditional: older artifacts (and the minimal synthetic fixtures) predate
    the command slice — only a *present but broken* record fails."""
    cmd = summary.get("commands")
    if cmd is None:
        return
    _check(cmd.get("checker_ok") is True, f"{suite} commands: {cmd}")
    _check(cmd.get("n_commands", 0) > 0, f"{suite} commands empty: {cmd}")
    _check(bool(cmd.get("sha256")), f"{suite} commands sha missing: {cmd}")


def validate_smoke(doc: dict) -> str:
    validate_common(doc)
    _check(bool(doc.get("sweeps")), "no sweeps recorded")
    _check(doc["sweeps"][0].get("schema_version") == "repro.sweep/v1",
           "first sweep schema_version")
    smoke = doc["results"].get("smoke") or {}
    _check(smoke.get("ladder_ok") is True, f"ladder_ok: {smoke}")
    _check(smoke.get("sched_ok") is True, f"sched_ok: {smoke}")
    _check(any(s.get("kind") == "mix_sweep" for s in doc["sweeps"]),
           "no mix_sweep among sweeps")
    if "quarantined" in smoke:   # older artifacts predate the resilience layer
        _check(smoke["quarantined"] == len(_quarantined_records(doc)),
               f"summary quarantined={smoke['quarantined']} != "
               f"{len(_quarantined_records(doc))} records in sweeps")
        _check(smoke["quarantined"] == 0 or doc.get("fault_injection")
               or smoke.get("fault_injection"),
               f"organic (non-injected) quarantine in smoke run: "
               f"{_quarantined_records(doc)}")
    _validate_commands_record("smoke", smoke)
    return (f"smoke ok: {doc['git_sha']} {doc.get('cache_stats')}"
            + (f", {smoke['quarantined']} quarantined (fault drill)"
               if smoke.get("quarantined") else ""))


def validate_mapping(doc: dict) -> str:
    validate_common(doc)
    m = doc["results"].get("mapping") or {}
    _check(m.get("collapse_ok") is True and m.get("recover_ok") is True,
           f"collapse/recover: {m}")
    _check(m["gain_contiguous_MASA"] < 0.5 * m["gain_xor_MASA"],
           f"contiguous vs xor gains: {m}")
    sweep = next((s for s in doc["sweeps"]
                  if s["grid"]["name"] == "mapping"), None)
    _check(sweep is not None, "mapping sweep missing")
    _check(sweep["grid"]["footprint_rows"] == m["footprint_rows"],
           "footprint_rows mismatch between grid and summary")
    specs = {c["overrides"].get("mapping") for c in sweep["cells"]}
    _check(specs == {"contiguous", "golden", "xor"}, f"mapping specs: {specs}")
    return (f"mapping ok: contiguous=+{m['gain_contiguous_MASA']:.1f}% "
            f"xor=+{m['gain_xor_MASA']:.1f}%")


def validate_perf(doc: dict, guard: bool = False) -> str:
    validate_common(doc)
    perf = doc["results"].get("perf") or {}
    _check(perf.get("default_req_per_s", 0) > 0, f"default_req_per_s: {perf}")
    _check(perf.get("n_cells") == len(perf.get("cells", [])) != 0,
           "n_cells != len(cells)")
    for cell in perf["cells"]:
        _check(set(cell) >= {"name", "n_requests", "cold_s", "warm_s",
                             "compile_s", "req_per_s"},
               f"cell fields: {sorted(cell)}")
    backends = perf.get("backends")
    if backends is not None:  # the synthetic documents have no backend axis
        _check("plain" in backends, f"backends missing plain: {backends}")
        for b, row in backends.items():
            _check(row.get("single_req_per_s", 0) > 0
                   and row.get("batch32_req_per_s", 0) > 0,
                   f"backend {b}: {row}")
        # a run on the card has a kernel leg, and its ratios must name it
        kvp = perf.get("kernel_vs_plain") or {}
        if "cuda" in backends or kvp:
            _check(kvp.get("kernel_backend") in backends,
                   f"kernel_vs_plain backend: {kvp}")
    msg = (f"perf ok: {doc['git_sha']} "
           f"{perf['default_req_per_s'] / 1e3:.1f}k req/s")
    if guard:
        msg += "; " + perf_guard(perf, doc.get("trajectory"))
    return msg


def perf_guard(perf: dict, trajectory: list | None = None) -> str:
    """Warn-only trajectory guard: kernel vs plain, and previous-artifact
    comparison.

    Reads the same-process ``kernel_vs_plain`` ratios (when the artifact
    carries them: a run on the card) and the last ``trajectory`` point (the
    port's previous ``artifacts/torch/BENCH_perf.json``). A kernel slower
    than its plain version, or a batch32 throughput below
    ``PERF_GUARD_RATIO`` of the previous point, prints a ``::warning``
    annotation on stdout but never fails validation. The reference's third
    comparison, against a pinned CPU-host origin point, has no counterpart:
    that figure is no target for the card.
    """
    parts = []
    kvp = perf.get("kernel_vs_plain")
    if kvp:
        kb = kvp.get("kernel_backend")
        parts.append(f"{kb} vs plain: single {kvp.get('single')}x, "
                     f"batch32 {kvp.get('batch32')}x")
        if min(kvp.get("single") or 1, kvp.get("batch32") or 1) < 1.0:
            print(f"::warning title=Kernel vs plain::{kb} throughput is "
                  f"single {kvp.get('single')}x, batch32 "
                  f"{kvp.get('batch32')}x its plain version's — the kernel "
                  f"should not lose to its reference.")
    else:
        parts.append("no kernel leg (plain versions only)")

    last = (trajectory or [{}])[-1]
    prev = last.get("batch32_req_per_s")
    now = next((c["req_per_s"] for c in perf.get("cells", ())
                if c["name"] == "batch32/MASA/8x8"), None)
    if prev and now:
        parts.append(f"batch32 {now / prev:.2f}x vs previous artifact "
                     f"({str(last.get('git_sha'))[:8]})")
        if now < PERF_GUARD_RATIO * prev:
            print(f"::warning title=Perf trajectory::batch32 req/s "
                  f"{now:.0f} fell below {PERF_GUARD_RATIO:.0%} of the "
                  f"previous artifact's {prev:.0f}.")
    return "; ".join(parts)


def validate_kernels(doc: dict) -> str:
    """The kernel-layer suite (``repro_torch.kernel_bench``): every kernel
    must agree with its plain oracle and the analytic SALP ladder must
    order."""
    validate_common(doc)
    k = doc["results"].get("kernels") or {}
    _check(k.get("kernels_ok") is True, f"kernels_ok: {k.get('kernels_ok')}")
    errs = k.get("errs") or {}
    want = {"moe_gemm", "masa_gemm", "ssd_scan", "flash_attention",
            "paged_attention/shared_prefix", "paged_attention/private"}
    _check(set(errs) >= want, f"kernels covered: {sorted(errs)}")
    from repro_torch.kernel_bench import ERR_TOL
    for name, err in errs.items():
        _check(0 <= err < ERR_TOL, f"{name} err {err} >= {ERR_TOL}")
    ladder = k.get("ladder") or {}
    _check(ladder.get("baseline") == 1.0
           and ladder.get("masa", 0) >= ladder.get("salp1", 0) > 1.0,
           f"salp ladder: {ladder}")
    worst = max(errs, key=errs.get)
    return f"kernels ok: {len(errs)} oracles, worst {worst}={errs[worst]:.1e}"


def validate_refresh(doc: dict) -> str:
    validate_common(doc)
    r = doc["results"].get("refresh") or {}
    _check(r.get("ladder_ok") is True, f"ladder_ok: {r.get('ladder_ok')}")
    table = r.get("table") or {}
    _check(set(table) == {"8Gb", "16Gb", "32Gb"}, f"densities: {set(table)}")
    for gb, per_pol in table.items():
        _check(set(per_pol) == {"BASELINE", "MASA"},
               f"{gb} policies: {set(per_pol)}")
        for pol, pens in per_pol.items():
            want = {"all_bank", "per_bank", "darp", "sarp"}
            want |= {"dsarp"} if pol == "MASA" else set()
            _check(set(pens) == want, f"{gb}/{pol} rungs: {set(pens)}")
            # the HPCA'14 ordering, re-checked from the raw table so a
            # summary-side ladder_ok bug cannot slip through
            _check(pens["all_bank"] > pens["per_bank"] > pens["darp"]
                   >= pens["sarp"],
                   f"{gb}/{pol} ladder violated: {pens}")
    sweep = next((s for s in doc.get("sweeps", ())
                  if s["grid"]["name"] == "refresh"), None)
    _check(sweep is not None, "refresh sweep missing")
    _validate_commands_record("refresh", r)
    hi = table["32Gb"]["MASA"]
    return (f"refresh ok: 32Gb MASA all_bank=+{hi['all_bank']:.1f}% "
            f"darp=+{hi['darp']:.1f}% sarp=+{hi['sarp']:.1f}%")


def check_shards(fragment_root: str, doc: dict) -> str:
    """Re-merge streamed shard fragments and pin them against the artifact.

    ``fragment_root`` is the ``repro_torch.benchmarks.run --fragments``
    directory: one subdirectory of ``fragment-*.json`` per sweep (named
    after the grid). For every subdirectory, the fragments are re-merged
    from scratch (:func:`repro_torch.experiments.merge_fragments` — which
    itself proves the
    coverage contract: every grid index exactly once across cells +
    quarantined) and the merged cells and quarantine records must equal the
    corresponding sweep in the artifact *exactly*. A sharded run whose
    fragments do not reassemble to the artifact it shipped is corrupt.
    """
    import os

    from repro_torch.experiments import merge_fragment_dir

    sweeps_by_name: dict[str, list[dict]] = {}
    for s in doc.get("sweeps") or ():
        sweeps_by_name.setdefault(s["grid"]["name"], []).append(s)
    try:
        subdirs = sorted(
            d for d in os.listdir(fragment_root)
            if os.path.isdir(os.path.join(fragment_root, d)))
    except OSError as e:
        raise ValidationError(f"fragment dir {fragment_root}: {e}")
    _check(bool(subdirs), f"no fragment subdirectories under {fragment_root}")
    checked = []
    for name in subdirs:
        _check(name in sweeps_by_name,
               f"fragments for {name!r} but no such sweep in the artifact")
        try:
            merged = merge_fragment_dir(os.path.join(fragment_root, name))
        except (OSError, ValueError) as e:
            raise ValidationError(f"fragments for {name!r}: {e}")
        for sweep in sweeps_by_name[name]:
            _check(merged["cells"] == sweep["cells"],
                   f"{name!r}: merged fragment cells != artifact sweep cells")
            _check(merged["quarantined"] == sweep["quarantined"],
                   f"{name!r}: merged quarantine records != artifact's")
            _check(merged["stats"]["n_cells"]
                   == (sweep.get("stats") or {}).get("n_cells"),
                   f"{name!r}: n_cells mismatch")
        checked.append(f"{name}({merged['stats']['n_fragments']}f/"
                       f"{merged['stats']['n_shards']}s)")
    return f"{len(checked)} sweep(s) re-merged bit-identical: " \
           f"{', '.join(checked)}"


def check_commands_file(path: str, doc: dict | None = None,
                        suite: str | None = None) -> str:
    """Re-parse a command-trace dump and re-run the JEDEC checker on it.

    Independent of the bench process that wrote it: the dump text carries
    the policy/timing/geometry meta, so the rule table is re-derived from
    the file alone. When the artifact carries a ``commands`` record, the
    file's sha256 must match it (same bytes the bench summarized)."""
    import hashlib

    from repro_torch.core.dram import check_trace
    from repro_torch.core.dram.commands import CommandTrace

    try:
        ct = CommandTrace.load(path)
    except (OSError, ValueError) as e:
        raise ValidationError(f"command trace {path} unreadable: {e}")
    result = check_trace(ct)
    _check(result.ok, f"command trace {path}: {result.summary()}")
    sha = hashlib.sha256(ct.dumps().encode()).hexdigest()
    rec = (((doc or {}).get("results") or {}).get(suite or "") or {}) \
        .get("commands")
    if rec is not None:
        _check(rec.get("sha256") == sha,
               f"command trace {path} sha {sha[:12]} != artifact record "
               f"{str(rec.get('sha256'))[:12]}")
    return (f"{len(ct)} commands legal under {result.n_rules} rules"
            + ("" if rec is None else ", sha pinned"))


def validate_memtech(doc: dict) -> str:
    validate_common(doc)
    r = doc["results"].get("memtech") or {}
    # SALP ladder on every technology, re-checked from the raw table
    _check(r.get("salp_ladder_ok") is True,
           f"salp_ladder_ok: {r.get('salp_ladder_ok')}")
    table = r.get("table") or {}
    _check(set(table) == {"ddr3", "lpddr4", "pcm_palp"},
           f"memtechs: {set(table)}")
    for tech, gains in table.items():
        _check(set(gains) == {"SALP1", "SALP2", "MASA"},
               f"{tech} policies: {set(gains)}")
        _check(gains["MASA"] >= gains["SALP2"] >= gains["SALP1"] > 0,
               f"{tech} SALP ladder violated: {gains}")
    # the default path must not have drifted: ddr3 column == pinned fixture
    pin = r.get("ddr3_pin") or {}
    _check(pin.get("ok") is True and pin.get("got") == pin.get("want"),
           f"ddr3 pin: {pin}")
    # PALP's premise: the read-priority rung beats FR-FCFS on PCM reads
    palp = (r.get("palp") or {}).get("pcm_palp") or {}
    _check(palp.get("palp_rp_read_lat", float("inf"))
           < palp.get("frfcfs_read_lat", 0),
           f"PALP_RP read latency on PCM: {palp}")
    # PCM emits NO refresh commands; LPDDR4 under per-bank refresh must
    _validate_commands_record("memtech", r)
    pcm_refs = (r.get("commands") or {}).get("ops", {}).get("REF")
    _check(pcm_refs in (None, 0), f"PCM stream has REF commands: {pcm_refs}")
    lp = r.get("commands_lpddr4") or {}
    _check(lp.get("ops", {}).get("REF", 0) > 0,
           f"LPDDR4 per-bank stream has no REF commands: {lp.get('ops')}")
    sweep = next((s for s in doc.get("sweeps", ())
                  if s["grid"]["name"] == "memtech"), None)
    _check(sweep is not None, "memtech sweep missing")
    return (f"memtech ok: MASA +{table['ddr3']['MASA']:.1f}% (ddr3) "
            f"+{table['lpddr4']['MASA']:.1f}% (lpddr4) "
            f"+{table['pcm_palp']['MASA']:.1f}% (pcm) | PALP_RP "
            f"{palp.get('improvement_pct', 0):+.1f}% read lat on PCM")


SUITES: dict[str, Callable[[dict], str]] = {
    "smoke": validate_smoke,
    "mapping": validate_mapping,
    "perf": validate_perf,
    "refresh": validate_refresh,
    "kernels": validate_kernels,
    "memtech": validate_memtech,
}


def detect_suite(doc: dict) -> str | None:
    hits = [s for s in SUITES if s in (doc.get("results") or {})]
    return hits[0] if len(hits) == 1 else None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", help="path to a repro.bench/v1 JSON artifact")
    ap.add_argument("--suite", choices=sorted(SUITES), default=None,
                    help="suite checks to apply (default: auto-detect)")
    ap.add_argument("--perf-guard", action="store_true",
                    help="perf only: warn-only comparison of the kernel with "
                         "its plain version and with the previous artifact")
    ap.add_argument("--check-commands", metavar="PATH", default=None,
                    help="re-parse a command-trace dump, re-run the JEDEC "
                         "checker, and pin its sha against the artifact's "
                         "commands record")
    ap.add_argument("--expect-quarantine", action="store_true",
                    help="fault-drill mode: fail unless the artifact records "
                         "quarantined cells (and not a fully-dead sweep)")
    ap.add_argument("--expect-resume", action="store_true",
                    help="journal mode: fail unless this run replayed "
                         "completed cells from a persistent cache journal")
    ap.add_argument("--check-shards", metavar="DIR", default=None,
                    help="re-merge streamed shard fragments under DIR/<grid>/ "
                         "and pin the merged cells + quarantine records "
                         "against the artifact's sweeps")
    args = ap.parse_args(argv)

    try:
        with open(args.artifact) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"UNREADABLE {args.artifact}: {e}", file=sys.stderr)
        return 1

    suite = args.suite or detect_suite(doc)
    if suite is None:
        print(f"cannot auto-detect suite from results keys "
              f"{sorted(doc.get('results') or {})}; pass --suite",
              file=sys.stderr)
        return 2
    if args.perf_guard and suite != "perf":
        print("--perf-guard only applies to --suite perf", file=sys.stderr)
        return 2

    try:
        msg = (validate_perf(doc, guard=True) if suite == "perf"
               and args.perf_guard else SUITES[suite](doc))
        if args.check_commands:
            msg += "; commands: " + check_commands_file(
                args.check_commands, doc, suite)
        if args.expect_quarantine:
            msg += "; quarantine: " + expect_quarantine(doc)
        if args.expect_resume:
            msg += "; resume: " + expect_resume(doc)
        if args.check_shards:
            msg += "; shards: " + check_shards(args.check_shards, doc)
    except ValidationError as e:
        print(f"INVALID {args.artifact} [{suite}]: {e}", file=sys.stderr)
        return 1
    except (KeyError, IndexError, TypeError) as e:
        # a structurally-truncated artifact (killed bench run, partial
        # write) must map onto the documented exit contract, not a traceback
        print(f"INVALID {args.artifact} [{suite}]: malformed document "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return 1
    print(f"VALID {args.artifact} [{suite}] — {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
