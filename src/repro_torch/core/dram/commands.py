"""DRAM command-stream export: decode, dump/load, and emitting entry points.

The port of ``repro.core.dram.commands``. ``SimConfig.emit_commands`` makes
the plain controller step (:func:`repro_torch.core.dram.controller.run_lanes`
/ ``run_cores`` with ``emit_commands=True``) also return a packed per-step
command log (opcode, cycle, bank, subarray, row, aux — see
``state_layout.CMD_*`` / ``OP_*``), which this module decodes into a flat
:class:`CommandTrace` and serializes as ramulator-style text, byte for byte
the reference's. :mod:`repro_torch.core.dram.checker` then re-verifies the
stream against a *declarative* JEDEC timing-rule table.

Execution: an export runs the plain emitting step on the device it is given
(``device=None`` means the card; ``device="cpu"`` as the tests pass), as the
reference's export always runs its ``lax.scan``. The CUDA lane and mix
kernels keep the per-step state on the card and refuse ``emit_commands``
(``cuda_step.check_no_emit``). Everything after the step log is numpy on the
host. ``simulate_commands`` / ``simulate_mix_commands`` return the
``(result, CommandTrace)`` pair; the result equals the non-emitting entry
point's.

Command semantics worth knowing before reading a dump:

* Commands appear in **step order** (one step = one served request), not
  globally sorted by cycle — a later step's PRE can carry an earlier cycle
  than this step's COL. ``CommandTrace.sorted_by_cycle`` reorders.
* ``OP_PREA`` is the closed-row policy's auto-precharge, folded into the
  access (not counted in ``SimResult.n_pre``).
* ``OP_REF`` rows are refresh-*burst starts*; after decode their ``aux``
  lane holds the burst's END cycle (mode 1/2 bursts last tRFC, per-bank
  modes tRFCpb). DARP's idle-drain / forced chains are emitted as one
  packed row with the chain length in aux and expanded here into
  back-to-back bursts spaced tRFCpb.
* ``OP_RD``/``OP_WR`` rows carry the request's *visibility* cycle in aux —
  the checker's tREFI-window audit and the completion cross-validation
  both need it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import IO

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.core.dram import state_layout as L
from repro_torch.core.dram.engine import (SimConfig, SimResult, lane_inputs,
                                          mix_inputs, result_from_state)
from repro_torch.core.dram.policies import Policy
from repro_torch.core.dram.refresh import RefreshPolicy
from repro_torch.core.dram.timing import DramTiming
from repro_torch.core.dram.trace import Trace, stack_traces

#: Dump header (format version + the config axes a checker run needs).
_CMDS_HEADER = "# repro-cmds v1"

#: Opcode value -> mnemonic (dump column 2); values are state_layout OP_*.
OP_NAMES = {
    int(L.OP_NOP): "NOP", int(L.OP_ACT): "ACT", int(L.OP_PRE): "PRE",
    int(L.OP_PREA): "PREA", int(L.OP_RD): "RD", int(L.OP_WR): "WR",
    int(L.OP_SASEL): "SASEL", int(L.OP_REF): "REF",
}
OP_VALUES = {v: k for k, v in OP_NAMES.items()}

_FIELDS = ("op", "cycle", "bank", "subarray", "row", "aux", "step", "core",
           "req")


@dataclasses.dataclass
class CommandTrace:
    """Flat decoded command stream (all int64 numpy arrays of length n).

    ``step``/``core``/``req`` tie each command back to the controller step
    that issued it (= the served request: ``core``'s request ``req``).
    ``step_comp`` ([n_steps]) is the engine's per-step completion cycle —
    present on freshly decoded traces, ``None`` after :meth:`load` (the text
    format carries only commands; the completion cross-check re-derives it).
    """
    op: np.ndarray
    cycle: np.ndarray
    bank: np.ndarray
    subarray: np.ndarray
    row: np.ndarray
    aux: np.ndarray
    step: np.ndarray
    core: np.ndarray
    req: np.ndarray
    meta: dict                      # policy / refresh_policy / row_policy /
                                    # n_banks / n_subarrays / n_steps
    timing: DramTiming
    step_comp: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.op.shape[0])

    @property
    def policy(self) -> Policy:
        return Policy[self.meta["policy"]]

    @property
    def refresh_policy(self) -> RefreshPolicy:
        return RefreshPolicy.from_spec(self.meta["refresh_policy"])

    @property
    def closed_row(self) -> bool:
        return self.meta["row_policy"] == "closed"

    def counts(self) -> dict[str, int]:
        """Per-opcode command counts, mnemonic-keyed (NOP never appears)."""
        return {OP_NAMES[int(v)]: int(c)
                for v, c in zip(*np.unique(self.op, return_counts=True))}

    def sorted_by_cycle(self) -> "CommandTrace":
        """Stable re-order by (cycle, step) — display convenience only."""
        order = np.lexsort((self.step, self.cycle))
        return dataclasses.replace(
            self, **{f: getattr(self, f)[order] for f in _FIELDS})

    # ---- text serialization -------------------------------------------------
    def dumps(self) -> str:
        """Serialize as deterministic ramulator-style text (see header)."""
        m = self.meta
        lines = [
            f"{_CMDS_HEADER} policy={m['policy']} "
            f"refresh_policy={m['refresh_policy']} "
            f"row_policy={m['row_policy']} n_banks={m['n_banks']} "
            f"n_subarrays={m['n_subarrays']} n_steps={m['n_steps']}",
            "# timing " + " ".join(
                f"{f.name}={getattr(self.timing, f.name)}"
                for f in dataclasses.fields(DramTiming)),
            "# columns: cycle op bank subarray row aux step core req",
        ]
        names = np.array([OP_NAMES[k] for k in range(len(OP_NAMES))])
        cols = [self.cycle.astype(str), names[self.op]] + [
            getattr(self, f).astype(str) for f in _FIELDS[2:]]
        lines += [" ".join(r) for r in zip(*cols)]
        return "\n".join(lines) + "\n"

    def dump(self, path: str | os.PathLike | IO[str]) -> None:
        text = self.dumps()
        if hasattr(path, "write"):
            path.write(text)
        else:
            with open(path, "w") as f:
                f.write(text)

    @classmethod
    def loads(cls, text: str) -> "CommandTrace":
        """Parse :meth:`dumps` output (round trip exact; step_comp is None)."""
        meta: dict = {}
        timing_kw: dict = {}
        rows: list[tuple] = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.strip()
            if not line:
                continue
            if line.startswith(_CMDS_HEADER):
                for tok in line[len(_CMDS_HEADER):].split():
                    k, v = tok.split("=", 1)
                    meta[k] = int(v) if v.lstrip("-").isdigit() else v
                continue
            if line.startswith("# timing"):
                for tok in line[len("# timing"):].split():
                    k, v = tok.split("=", 1)
                    timing_kw[k] = int(v)
                continue
            if line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) != 9:
                raise ValueError(f"line {lineno}: expected 9 columns "
                                 f"'cycle op bank subarray row aux step "
                                 f"core req', got {line!r}")
            try:
                op = OP_VALUES[toks[1].upper()]
            except KeyError:
                raise ValueError(f"line {lineno}: unknown opcode {toks[1]!r} "
                                 f"(expected one of "
                                 f"{sorted(OP_VALUES)})") from None
            rows.append((op, *(int(t) for t in (toks[0], *toks[2:]))))
        if not meta:
            raise ValueError(f"missing '{_CMDS_HEADER} ...' header")
        if not rows:
            raise ValueError("command dump contains no commands")
        a = np.asarray(rows, np.int64)
        return cls(op=a[:, 0], cycle=a[:, 1], bank=a[:, 2], subarray=a[:, 3],
                   row=a[:, 4], aux=a[:, 5], step=a[:, 6], core=a[:, 7],
                   req=a[:, 8], meta=meta, timing=DramTiming(**timing_kw),
                   step_comp=None)

    @classmethod
    def load(cls, path: str | os.PathLike | IO[str]) -> "CommandTrace":
        if hasattr(path, "read"):
            return cls.loads(path.read())
        with open(path) as f:
            return cls.loads(f.read())


def _host(x) -> np.ndarray:
    return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(
        np.int64)


def decode(ys: dict, policy: Policy, config: SimConfig) -> CommandTrace:
    """Flatten one lane's (or mix's) packed command log into a CommandTrace.

    ``ys`` holds ``cmds [steps, slots, CMD_F]`` and the ``[steps]`` vectors
    ``comp``, ``core`` and ``req`` (tensors on any device, or arrays): one
    row of the log ``run_lanes`` / ``run_cores`` return with
    ``emit_commands=True``. Slots carrying ``OP_NOP`` are dropped; DARP's
    REF chain rows (aux = chain length k) expand into k bursts spaced
    tRFCpb; every REF row's aux is rewritten to the burst's END cycle.
    """
    t = config.timing
    cmds = _host(ys["cmds"])                          # [steps, slots, CMD_F]
    n_steps, n_slots, _ = cmds.shape
    step = np.repeat(np.arange(n_steps, dtype=np.int64), n_slots)
    core = np.repeat(_host(ys["core"]), n_slots)
    req = np.repeat(_host(ys["req"]), n_slots)
    flat = cmds.reshape(-1, L.CMD_F)
    keep = flat[:, L.CMD_OP] != L.OP_NOP
    flat, step, core, req = flat[keep], step[keep], core[keep], req[keep]

    op, cycle = flat[:, L.CMD_OP], flat[:, L.CMD_CYCLE]
    aux = flat[:, L.CMD_AUX]
    rp = RefreshPolicy.from_spec(config.refresh_policy)
    burst = t.t_rfc_pb if rp.per_bank_burst else t.t_rfc

    # REF chain expansion: a REF row with aux=k becomes k back-to-back
    # bursts spaced tRFCpb (k > 1 only under DARP's drains); every REF's
    # aux is rewritten to its burst end (mode-independent for the checker).
    k = np.where(op == L.OP_REF, np.maximum(aux, 1), 1)
    idx = np.repeat(np.arange(len(op)), k)
    intra = np.arange(len(idx)) - np.repeat(np.cumsum(k) - k, k)
    op, cycle, aux = op[idx], cycle[idx] + intra * t.t_rfc_pb, aux[idx]
    aux = np.where(op == L.OP_REF, cycle + burst, aux)
    flat, step, core, req = flat[idx], step[idx], core[idx], req[idx]

    nb, ns = config.geometry_for(policy)
    meta = dict(policy=policy.name, refresh_policy=rp.spec,
                row_policy=config.row_policy, n_banks=nb, n_subarrays=ns,
                n_steps=n_steps)
    return CommandTrace(
        op=op, cycle=cycle, bank=flat[:, L.CMD_BANK],
        subarray=flat[:, L.CMD_SA], row=flat[:, L.CMD_ROW], aux=aux,
        step=step, core=core, req=req, meta=meta, timing=t,
        step_comp=_host(ys["comp"]))


def _first(log: dict) -> dict:
    """Lane (or mix) 0 of a stacked ``[B, steps, ...]`` log."""
    return {k: v[0] for k, v in log.items()}


# --------------------------------------------------------------------------
# Emitting entry points (mirror engine.simulate / multicore.simulate_multicore)
# --------------------------------------------------------------------------

def simulate_commands(trace: Trace, policy: Policy,
                      config: SimConfig = SimConfig(), device=None
                      ) -> tuple[SimResult, CommandTrace]:
    """``engine.simulate`` + the decoded command stream it issued.

    Runs the plain emitting step on ``device`` (``None`` = the card). The
    SimResult (0-d int32 tensors) equals ``simulate(trace, policy, config)``
    (the emission adds outputs, never ops, to the timing math).
    """
    from repro_torch.core.dram import controller

    cfg = dataclasses.replace(config, emit_commands=True)
    dev = resolve_device(device)
    # lane_inputs validates the window and applies IDEAL's geometry rewrite
    eff, nb, ns, xs, mlp = lane_inputs(stack_traces([trace]), policy, cfg,
                                       dev)
    sc, vis, _, log = controller.run_lanes(
        eff, nb, ns, cfg.timing, cfg.refresh_mode, xs, mlp,
        closed_row=cfg.row_policy == "closed", emit_commands=True)
    res = result_from_state(xs.shape[1], sc, vis).lane(0)
    return res, decode(_first(log), policy, cfg)


def simulate_mix_commands(traces: list[Trace], policy: Policy,
                          config: SimConfig = SimConfig(), device=None):
    """``multicore.simulate_multicore`` + the shared channel's command stream.

    Returns ``(MulticoreResult, CommandTrace)``; each command's
    ``core``/``req`` lanes identify the served request, so per-core streams
    can be sliced back out. The mix runs the plain emitting step on
    ``device``; the run-alone baselines go through ``simulate_batch``, the
    lane kernel on the card.
    """
    from repro_torch.core.dram import controller
    from repro_torch.core.dram.multicore import (MulticoreResult, _prep_mix,
                                                 alone_baseline_cycles)

    cfg = dataclasses.replace(config, emit_commands=True)
    dev = resolve_device(device)
    st, rank = _prep_mix(traces)
    stacked = {k: v[None] for k, v in st.items() if k != "addr"}
    # mix_inputs validates the windows and applies IDEAL's rewrite
    eff, sched, nb, ns, reqs, mlp, rk = mix_inputs(stacked, rank[None],
                                                   policy, cfg, dev)
    sc, vis, maxc, log = controller.run_cores(
        eff, sched, nb, ns, cfg.timing, cfg.refresh_mode, reqs, mlp, rk,
        closed_row=cfg.row_policy == "closed", emit_commands=True)
    C, N = reqs.shape[1], reqs.shape[2]
    shared = result_from_state(C * N, sc, vis.amax(dim=1)).lane(0)
    alone = alone_baseline_cycles(
        [traces], dataclasses.replace(config, emit_commands=False),
        device=dev)
    result = MulticoreResult(
        shared=shared, core_cycles=maxc[0].cpu().numpy().astype(np.float64),
        alone_cycles=alone, profiles=[t.profile for t in traces])
    return result, decode(_first(log), policy, cfg)


# --------------------------------------------------------------------------
# Stream-derived cross-validation (ties the log to the packed-state result)
# --------------------------------------------------------------------------

def completions_from_commands(ct: CommandTrace) -> np.ndarray:
    """Per-step completion cycles re-derived from the column commands alone.

    A write completes at its WR issue (the core never waits on write data);
    a read at the end of its data burst (``RD + tCL + tBL``). Must equal the
    engine's ``step_comp`` bit for bit.
    """
    col = (ct.op == L.OP_RD) | (ct.op == L.OP_WR)
    steps, cycles, ops = ct.step[col], ct.cycle[col], ct.op[col]
    comp = np.where(ops == L.OP_WR, cycles,
                    cycles + ct.timing.t_cl + ct.timing.t_bl)
    order = np.argsort(steps)
    if not np.array_equal(steps[order], np.arange(ct.meta["n_steps"])):
        raise ValueError("command stream does not carry exactly one column "
                         "command per step")
    return comp[order]


def counters_from_commands(ct: CommandTrace) -> dict[str, int]:
    """SimResult counters re-derived from the stream (same field names).

    ``sa_open_cycles`` is the one counter a command log cannot reproduce
    (it integrates open-subarray *state* over time), so it is omitted.
    """
    t = ct.timing
    c = {name: 0 for name in ("ACT", "PRE", "PREA", "RD", "WR", "SASEL",
                              "REF")}
    c.update(ct.counts())
    col = (ct.op == L.OP_RD) | (ct.op == L.OP_WR)
    acts = set(ct.step[ct.op == L.OP_ACT].tolist())
    hits = int(np.sum(~np.isin(ct.step[col], sorted(acts))))
    rd = ct.op == L.OP_RD
    lat = int(np.sum((ct.cycle[rd] + t.t_cl + t.t_bl) - ct.aux[rd]))
    comp = completions_from_commands(ct)
    return dict(
        total_cycles=int(max(comp.max(), ct.aux[col].max())),
        n_requests=int(col.sum()),
        n_act=c["ACT"], n_pre=c["PRE"],          # PREA is folded, not counted
        n_rd=c["RD"], n_wr=c["WR"], n_sasel=c["SASEL"], n_hit=hits,
        sum_latency=lat, n_reads=c["RD"],
    )
