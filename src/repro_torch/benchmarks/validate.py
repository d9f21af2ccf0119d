"""Artifact validation for the port's benches (the port of the repo's
``benchmarks/validate.py``, the parts its refresh and memtech benches need).

The checks are the reference's, word for word: ``validate_common``, the
``refresh`` and ``memtech`` suites and ``check_commands_file``, which
re-parses a command dump the bench left next to the artifact
(``repro_torch.benchmarks.common.command_slice``), re-runs the JEDEC checker
on it from scratch (the port's copy of it) and pins its sha256 against the
artifact's ``results.<suite>.commands`` record.

Usage::

    python -m repro_torch.benchmarks.validate ARTIFACT [--suite refresh] \
        [--check-commands artifacts/torch/commands_refresh.trace]

The suite is auto-detected from the artifact's ``results`` keys when
``--suite`` is omitted. Exit code 0 = valid, 1 = validation failed, 2 = bad
invocation. The other suites, ``--check-shards`` and the perf guard come
with the port of ``benchmarks/run.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable


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
    "refresh": validate_refresh,
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
    ap.add_argument("--check-commands", metavar="PATH", default=None,
                    help="re-parse a command-trace dump, re-run the JEDEC "
                         "checker, and pin its sha against the artifact's "
                         "commands record")
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

    try:
        msg = SUITES[suite](doc)
        if args.check_commands:
            msg += "; commands: " + check_commands_file(
                args.check_commands, doc, suite)
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
