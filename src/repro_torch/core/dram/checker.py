"""Vectorized JEDEC timing-rule checker for decoded command streams.

Verifies a :class:`repro_torch.core.dram.commands.CommandTrace` against a
*declarative* table of ``(prev-ops, curr-ops, scope, min-delay)`` rules —
the shape of antmicro's LPDDR4 ``TimingChecker`` test model — plus the
windowed constraints (tFAW, refresh-burst blocking, DARP's tREFI debt
window) and SALP/MASA structural assertions that do not fit the pairwise
form. Every check is whole-array numpy (lexsort + segmented prefix
maxima + searchsorted); no per-command Python loop, so full bench-length
traces check in milliseconds.

Pair-rule semantics: command A *precedes* B iff A's array position is less
than B's. Position (decode order = scan (step, slot) order) is the model's
CAUSAL order — the engine threads timing state step by step, so step k's
commands are constrained by steps < k, never by later steps. Cycle order
is deliberately NOT the precedence: under per-bank refresh the controller
retroactively accounts bursts into past idle gaps (DARP pull-ins, deadline
slotting), so a later step may carry cycles below an earlier step's — the
stream is cycle-consistent only along the causal order, which is exactly
what a state-sequential model guarantees. A rule ``prev -> curr, scope,
d`` is violated iff some prev-class command P precedes a curr-class
command C in the same scope with ``C.cycle - P.cycle < d``; each check
takes the true *maximum* preceding prev cycle per curr (segmented running
max), so no monotonicity assumption is needed.

Model caveats the rule table encodes (docs/commands.md has the JEDEC
provenance per rule):

* ``PREA`` (closed-row auto-precharge) is held to the FULL precharge rule
  set — tRAS from the access's ACT, tWR after a write, tRTP after a read,
  and tRP into the next ACT — because the engine delays the internal
  precharge exactly like a real device (``engine._step_math``'s
  closed-row block mirrors the explicit-PRE gates). The historical
  PREA-exemption caveat is retired.
* SALP-2's column-release rule (COL >= other-subarray PRE + 1) covers
  explicit PREs only: a closed-row PREA's issue cycle may land *after*
  later column commands in array order (the log is causal, not
  cycle-sorted), so the pairwise rule would mis-bind it.
* Refresh closes rows without PRE commands (REF implies precharge of its
  scope), so a PRE may legally target an already-closed subarray
  (``row == -1``) when a refresh beat it to the closure.
* Data-bus occupancy is subsumed by tCCD/tWTR/tRTW at DDR3-1066 constants
  (tBL <= tCCD and the turnaround rules dominate the lat-adjusted gap).

Port note: a framework-free copy of ``repro.core.dram.checker``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_checker.py holds it equal to
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.commands import OP_NAMES, CommandTrace
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.refresh import RefreshPolicy
from repro_torch.core.dram.timing import DramTiming

_COL = (int(L.OP_RD), int(L.OP_WR))
_PRE_ALL = (int(L.OP_PRE), int(L.OP_PREA))


@dataclasses.dataclass(frozen=True)
class TimingRule:
    """One declarative pairwise constraint: curr >= prev + delay in scope."""
    name: str
    prev: tuple[int, ...]            # prev-class opcodes
    curr: tuple[int, ...]            # curr-class opcodes
    scope: str                       # "subarray" | "bank" | "rank"
    delay: int                       # min cycles between prev and curr issue
    why: str                         # JEDEC / paper provenance (docs table)


@dataclasses.dataclass
class Violation:
    rule: str
    curr: int                        # index into the CommandTrace arrays
    prev: int                        # binding earlier command (-1 if n/a)
    curr_cycle: int
    required: int                    # minimum legal cycle for curr
    detail: str = ""

    @property
    def deficit(self) -> int:
        return self.required - self.curr_cycle


@dataclasses.dataclass
class CheckResult:
    violations: list[Violation]
    n_commands: int
    n_rules: int

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self, limit: int = 8) -> str:
        if self.ok:
            return (f"OK: {self.n_commands} commands legal under "
                    f"{self.n_rules} rules")
        lines = [f"{len(self.violations)} violation(s) over "
                 f"{self.n_commands} commands:"]
        for v in self.violations[:limit]:
            lines.append(
                f"  {v.rule}: cmd[{v.curr}] @ {v.curr_cycle} needs "
                f">= {v.required} (prev cmd[{v.prev}], short {v.deficit})"
                + (f" — {v.detail}" if v.detail else ""))
        if len(self.violations) > limit:
            lines.append(f"  ... {len(self.violations) - limit} more")
        return "\n".join(lines)


def rules_for(policy: Policy, t: DramTiming,
              closed_row: bool = False,
              refresh_policy: RefreshPolicy = RefreshPolicy.NONE
              ) -> tuple[TimingRule, ...]:
    """The declarative rule table for one (policy, timing, config) point.

    IDEAL maps to the BASELINE ladder (it is the baseline on an enlarged
    geometry). The policy ladder only varies the cross-subarray PRE->ACT
    coupling and SALP-2's column-release rule — exactly the paper's Sec. 5
    mechanism differences.
    """
    if policy == Policy.IDEAL:
        policy = Policy.BASELINE
    act, pre = (int(L.OP_ACT),), (int(L.OP_PRE),)
    rd, wr = (int(L.OP_RD),), (int(L.OP_WR),)
    sasel, ref = (int(L.OP_SASEL),), (int(L.OP_REF),)
    rules = [
        TimingRule("tRCD", act, _COL, "subarray", t.t_rcd,
                   "JEDEC DDR3: ACT to internal RD/WR (same row)"),
        TimingRule("tRP", _PRE_ALL, act, "subarray", t.t_rp,
                   "JEDEC DDR3: PRE to ACT, same subarray (local bitlines)"),
        TimingRule("tRAS", act, _PRE_ALL, "subarray", t.t_ras,
                   "JEDEC DDR3: minimum row-open time (PREA included: the "
                   "engine delays the internal auto-precharge past tRAS)"),
        TimingRule("tWR", wr, _PRE_ALL, "subarray",
                   t.t_cwl + t.t_bl + t.t_wr,
                   "JEDEC DDR3: write recovery, WR issue + CWL + BL + tWR "
                   "before any precharge, auto (PREA) included"),
        TimingRule("tRTP", rd, _PRE_ALL, "subarray", t.t_rtp,
                   "JEDEC DDR3: read to precharge"),
        TimingRule("tCCD", _COL, _COL, "rank", t.t_ccd,
                   "JEDEC DDR3: column-to-column on the shared column bus"),
        TimingRule("tWTR", wr, rd, "rank",
                   t.t_cwl + t.t_bl + t.t_wtr,
                   "JEDEC DDR3: write-to-read bus turnaround (from WR issue: "
                   "CWL + BL + tWTR)"),
        TimingRule("tRTW", rd, wr, "rank", t.t_rtw,
                   "controller-imposed read-to-write turnaround"),
        TimingRule("tRRD", act, act, "rank", t.t_rrd,
                   "JEDEC DDR3: ACT-to-ACT, any banks (peak current)"),
        TimingRule("tRRD_sa", act, act, "bank", t.t_rrd_sa,
                   "paper Sec. 5.1: ACT-to-ACT across subarrays of one bank "
                   "(SALP's added constraint)"),
        TimingRule("tSA", sasel, _COL, "subarray", t.t_sa,
                   "paper Sec. 5.3 (MASA): SA_SEL before the column command "
                   "it redirects"),
    ]
    if policy in (Policy.BASELINE, Policy.IDEAL):
        rules.append(TimingRule(
            "tRP-bank", _PRE_ALL, act, "bank", t.t_rp,
            "baseline ladder: the bank serializes PRE -> tRP -> ACT across "
            "subarrays (single set of global structures)"))
    elif policy == Policy.SALP1:
        rules.append(TimingRule(
            "tPA-salp1", _PRE_ALL, act, "bank", 1,
            "paper Sec. 5.2 (SALP-1): cross-subarray ACT overlaps all of "
            "tRP but the PRE's own command slot"))
    elif policy == Policy.SALP2:
        rules.append(TimingRule(
            "tPC-salp2", pre, _COL, "bank", 1,
            "paper Sec. 5.2 (SALP-2): the column command waits for the "
            "other subarray's PRE to release the global structures "
            "(explicit PREs only — PREA caveat in module docstring)"))
    if refresh_policy != RefreshPolicy.NONE:
        spacing = (t.t_rfc_pb if refresh_policy == RefreshPolicy.DARP
                   else t.t_refi)
        rules.append(TimingRule(
            "tREFI" if refresh_policy != RefreshPolicy.DARP
            else "tRFCpb-chain", ref, ref, "bank", spacing,
            "per-bank refresh cadence: deadline modes re-arm every tREFI; "
            "DARP drains chain back-to-back bursts spaced tRFCpb "
            "(HPCA'14 Sec. 4)"))
    return tuple(rules)


# --------------------------------------------------------------------------
# vectorized machinery
# --------------------------------------------------------------------------

def _scope_ids(ct: CommandTrace, scope: str) -> np.ndarray:
    if scope == "rank":
        return np.zeros(len(ct), np.int64)
    if scope == "bank":
        return ct.bank.astype(np.int64)
    ns = int(ct.meta["n_subarrays"])
    # +1 folds the NEG (-1) subarray of bank-granular REF rows into a slot
    return ct.bank.astype(np.int64) * (ns + 2) + (ct.subarray + 1)


def _segmented_prev_max(seg: np.ndarray, pack: np.ndarray,
                        is_prev: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Exclusive running max of ``pack`` over prev-rows, reset per segment.

    ``seg`` must be sorted ascending. Returns (valid, prev_pack): for each
    position, the max pack among *earlier* prev-rows of the same segment
    (valid False when none exists).
    """
    if len(pack) == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64)
    huge = int(pack.max()) + 2
    total = np.where(is_prev, seg * huge + pack + 1, 0)
    run = np.maximum.accumulate(total)
    ex = np.concatenate([[0], run[:-1]])
    valid = ex > seg * huge            # an earlier prev in THIS segment
    return valid, ex - seg * huge - 1


def _apply_rule(rule: TimingRule, ct: CommandTrace
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate one pair rule; returns (curr_idx, prev_idx, required)."""
    n = len(ct)
    scope = _scope_ids(ct, rule.scope)
    perm = np.lexsort((np.arange(n), scope))   # causal (array) order in scope
    s, c, o = scope[perm], ct.cycle[perm].astype(np.int64), ct.op[perm]
    gi = perm.astype(np.int64)
    pack = c * n + gi                  # max -> largest prev cycle, pos tiebreak
    valid, prev_pack = _segmented_prev_max(s, pack, np.isin(o, rule.prev))
    prev_c, prev_i = prev_pack // n, prev_pack % n
    bad = np.isin(o, rule.curr) & valid & (c - prev_c < rule.delay)
    return gi[bad], prev_i[bad], (prev_c[bad] + rule.delay)


def _check_faw(ct: CommandTrace
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """tFAW: any 5th ACT channel-wide must be >= the 4-back ACT + tFAW.

    Causal (array) order, matching the engine's ``act_hist`` window — the
    sliding four-entry history is step-ordered, like every pair rule."""
    order = np.flatnonzero(ct.op == L.OP_ACT)
    c = ct.cycle[order].astype(np.int64)
    if len(c) < 5:
        z = np.zeros(0, np.int64)
        return z, z, z
    bad = (c[4:] - c[:-4]) < ct.timing.t_faw
    return (order[4:][bad], order[:-4][bad],
            c[:-4][bad] + ct.timing.t_faw)


def _ref_block_scope(ct: CommandTrace) -> str:
    """Which commands a refresh burst blocks (mirrors head_visibility)."""
    rp = ct.refresh_policy
    if rp == RefreshPolicy.SARP:
        return "subarray"
    if rp == RefreshPolicy.DSARP and ct.policy == Policy.MASA:
        return "subarray"
    return "bank"


def _check_ref_overlap(ct: CommandTrace
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """No command from a LATER step may issue inside a refresh burst.

    Step-indexed on purpose: commands computed before the burst fired
    (earlier or same step) may legally carry cycles inside its interval —
    visibility gating only affects later steps. For blocked scopes, every
    later-step command's cycle must clear the running max burst end.
    """
    n = len(ct)
    scope = _scope_ids(ct, _ref_block_scope(ct))
    isref = ct.op == L.OP_REF
    # same-step non-REF rows sort before the step's REF rows -> exempt
    perm = np.lexsort((np.arange(n), isref.astype(np.int64), ct.step, scope))
    s, gi = scope[perm], perm.astype(np.int64)
    end = np.where(isref, ct.aux, 0)[perm].astype(np.int64)  # REF aux = end
    pack = end * n + gi
    valid, prev_pack = _segmented_prev_max(s, pack, isref[perm])
    prev_end, prev_i = prev_pack // n, prev_pack % n
    c = ct.cycle[perm].astype(np.int64)
    bad = valid & (c < prev_end)
    return gi[bad], prev_i[bad], prev_end[bad]


def _check_darp_window(ct: CommandTrace) -> list[Violation]:
    """DARP debt audit: performed refreshes per bank must track matured
    deadlines within the spec's postpone window (and never exceed them —
    the model has no pull-in-ahead credit). Deadlines mature at request
    arrivals, so the reference clock is the bank's max visibility cycle."""
    t = ct.timing
    nb = int(ct.meta["n_banks"])
    due0 = (np.arange(nb, dtype=np.int64)
            * max(t.t_refi // max(nb, 1), 1) + t.t_refi)
    col = np.isin(ct.op, _COL)
    out = []
    for b in range(nb):
        vis_b = ct.aux[col & (ct.bank == b)]
        if len(vis_b) == 0:
            continue
        vmax = int(vis_b.max())
        matured = max(0, (vmax - int(due0[b])) // t.t_refi + 1) \
            if vmax >= due0[b] else 0
        n_refs = int(np.sum((ct.op == L.OP_REF) & (ct.bank == b)))
        lo = max(0, matured - t.ref_postpone_max)
        if not lo <= n_refs <= matured:
            out.append(Violation(
                "tREFI-window", -1, -1, n_refs, lo,
                detail=f"bank {b}: {n_refs} refresh bursts vs {matured} "
                       f"matured deadlines (postpone window "
                       f"{t.ref_postpone_max}) by vis {vmax}"))
    return out


# --------------------------------------------------------------------------
# structural (SALP/MASA) assertions — step-order, not cycle-order
# --------------------------------------------------------------------------

def _closes_for_bank(ct: CommandTrace, m: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(position, subarray) of row-closing events in one bank, -1 = all.

    PRE/PREA close their subarray; REF closes its scope (bank-granular
    modes all subarrays, subarray-granular the target) — refresh closure
    emits no PRE, which is why PREs to already-closed rows are legal."""
    pre = m & np.isin(ct.op, _PRE_ALL)
    ref = m & (ct.op == L.OP_REF)
    pos = np.concatenate([np.flatnonzero(pre), np.flatnonzero(ref)])
    sa = np.concatenate([
        ct.subarray[pre],
        ct.subarray[ref] if ct.refresh_policy.subarray_granular
        else np.full(int(ref.sum()), -1, ct.subarray.dtype)])
    order = np.argsort(pos, kind="stable")
    return pos[order], sa[order]


def _check_single_open(ct: CommandTrace) -> list[Violation]:
    """non-MASA: <= 1 raised global wordline per bank — every ACT needs the
    bank's previous activation closed first (PRE/PREA/REF, in issue
    order). Positions are array indices = the scan's (step, slot) order."""
    out = []
    for b in np.unique(ct.bank):
        m = ct.bank == b
        apos = np.flatnonzero(m & (ct.op == L.OP_ACT))
        if len(apos) < 2:
            continue
        asa = ct.subarray[apos]
        cpos, csa = _closes_for_bank(ct, m)
        prev_pos, prev_sa, cur_pos = apos[:-1], asa[:-1], apos[1:]
        for sa in np.unique(prev_sa):
            sel = prev_sa == sa
            cp = cpos[(csa == sa) | (csa == -1)]
            cnt = (np.searchsorted(cp, cur_pos[sel], "left")
                   - np.searchsorted(cp, prev_pos[sel], "right"))
            for j in np.flatnonzero(cnt == 0):
                i = int(np.flatnonzero(sel)[j])
                out.append(Violation(
                    "structure:single-open", int(cur_pos[i]),
                    int(prev_pos[i]), int(ct.cycle[cur_pos[i]]), 0,
                    detail=f"bank {b}: ACT while subarray {sa} still "
                           f"activated (no intervening PRE/REF)"))
    return out


def _check_masa_sasel(ct: CommandTrace) -> list[Violation]:
    """MASA: SA_SEL present exactly when a row-hit changes the bank's
    designated subarray (a fresh ACT re-designates for free). Checked in
    step order — an adjacent step's commands may interleave in cycle
    order, so cycle order would misattribute designations."""
    out = []
    col = np.isin(ct.op, _COL)
    for b in np.unique(ct.bank):
        m = ct.bank == b
        cidx = np.flatnonzero(m & col)          # one per serving step
        steps, sas = ct.step[cidx], ct.subarray[cidx]
        astep = np.unique(ct.step[m & (ct.op == L.OP_ACT)])
        sstep = np.unique(ct.step[m & (ct.op == L.OP_SASEL)])
        has_act = np.isin(steps, astep)
        has_sasel = np.isin(steps, sstep)
        d_prev = np.concatenate([[-1], sas[:-1]])
        expect = (~has_act) & (d_prev != sas)
        for j in np.flatnonzero(expect != has_sasel):
            out.append(Violation(
                "structure:masa-sasel", int(cidx[j]), -1,
                int(ct.cycle[cidx[j]]), 0,
                detail=f"bank {b} step {int(steps[j])}: designated subarray "
                       f"{int(d_prev[j])} -> {int(sas[j])}, "
                       f"{'missing' if expect[j] else 'spurious'} SA_SEL"))
    return out


def _check_shape(ct: CommandTrace) -> list[Violation]:
    """Stream shape: one column command per step; SASEL/PREA gating."""
    out = []
    col_steps = ct.step[np.isin(ct.op, _COL)]
    uniq, cnt = np.unique(col_steps, return_counts=True)
    if len(uniq) != ct.meta["n_steps"] or (cnt != 1).any():
        out.append(Violation(
            "structure:one-col-per-step", -1, -1, 0, 0,
            detail=f"{len(col_steps)} column commands over "
                   f"{ct.meta['n_steps']} steps"))
    if ct.policy != Policy.MASA and int(np.sum(ct.op == L.OP_SASEL)):
        out.append(Violation("structure:sasel-policy", -1, -1, 0, 0,
                             detail="SA_SEL under a non-MASA policy"))
    if not ct.closed_row and int(np.sum(ct.op == L.OP_PREA)):
        out.append(Violation("structure:prea-policy", -1, -1, 0, 0,
                             detail="auto-precharge under the open-row "
                                    "policy"))
    return out


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def check_trace(ct: CommandTrace,
                rules: tuple[TimingRule, ...] | None = None,
                structural: bool = True) -> CheckResult:
    """Verify a command stream; returns every violation found.

    ``rules=None`` derives the table from the trace's own meta
    (policy/timing/row-policy/refresh-policy — dump/load carries all of
    it). ``structural=False`` runs the pairwise/windowed timing rules only
    (the mutation property tests use this to isolate rule coverage).
    """
    if rules is None:
        rules = rules_for(ct.policy, ct.timing, ct.closed_row,
                          ct.refresh_policy)
    violations: list[Violation] = []

    def report(name, curr, prev, req, detail=""):
        for j in range(len(curr)):
            violations.append(Violation(
                name, int(curr[j]), int(prev[j]),
                int(ct.cycle[curr[j]]), int(req[j]), detail))

    for rule in rules:
        report(rule.name, *_apply_rule(rule, ct))
    report("tFAW", *_check_faw(ct))
    if ct.refresh_policy != RefreshPolicy.NONE:
        report("tRFC-blocking", *_check_ref_overlap(ct))
        if ct.refresh_policy == RefreshPolicy.DARP:
            violations.extend(_check_darp_window(ct))
    if structural:
        violations.extend(_check_shape(ct))
        if ct.policy == Policy.MASA:
            violations.extend(_check_masa_sasel(ct))
        else:
            violations.extend(_check_single_open(ct))
    violations.sort(key=lambda v: (v.curr_cycle, v.curr))
    # +2: tFAW and the refresh-blocking window count as checks too
    return CheckResult(violations, len(ct), len(rules) + 2)


def min_legal_cycles(ct: CommandTrace,
                     rules: tuple[TimingRule, ...] | None = None
                     ) -> np.ndarray:
    """Per-command lower bound on the issue cycle, all others held fixed.

    ``bound[i]`` is the max over every applicable pair rule (+ tFAW + the
    refresh-blocking window) of *binding predecessor cycle + delay*. A
    command sits at ``cycle >= bound``; rewinding it below its bound is
    exactly what the checker must flag — the mutation property tests pin
    ``check_trace`` against this oracle.
    """
    if rules is None:
        rules = rules_for(ct.policy, ct.timing, ct.closed_row,
                          ct.refresh_policy)
    bound = np.zeros(len(ct), np.int64)

    def fold(rule_apply):
        n = len(ct)
        scope, perm, is_prev, is_curr, val = rule_apply
        s = scope[perm]
        pack = val[perm] * n + perm.astype(np.int64)
        valid, prev_pack = _segmented_prev_max(s, pack, is_prev[perm])
        req = prev_pack // n
        sel = is_curr[perm] & valid
        np.maximum.at(bound, perm[sel], req[sel])

    n = len(ct)
    order = np.arange(n)
    for rule in rules:
        scope = _scope_ids(ct, rule.scope)
        perm = np.lexsort((order, scope))      # causal (array) order
        fold((scope, perm, np.isin(ct.op, rule.prev),
              np.isin(ct.op, rule.curr),
              ct.cycle.astype(np.int64) + rule.delay))
    # tFAW: 4-back ACT + tFAW, causal order (matches act_hist)
    aord = np.flatnonzero(ct.op == L.OP_ACT)
    if len(aord) >= 5:
        np.maximum.at(bound, aord[4:],
                      ct.cycle[aord[:-4]].astype(np.int64)
                      + ct.timing.t_faw)
    # refresh blocking: later-step commands must clear the burst end
    if ct.refresh_policy != RefreshPolicy.NONE:
        scope = _scope_ids(ct, _ref_block_scope(ct))
        isref = ct.op == L.OP_REF
        perm = np.lexsort((order, isref.astype(np.int64), ct.step, scope))
        fold((scope, perm, isref, ~isref,
              np.where(isref, ct.aux, 0).astype(np.int64)))
    return bound
