"""Packed simulator-state layout shared by engine / controller / schedulers.

The simulator step carries its state as a handful of dense int32 buffers
instead of a ~30-leaf dict of scalars and `[nb, ns]` planes. Each step then
touches exactly one bank: a single `dynamic_slice` gathers that bank's
`[ns, SA_F]` block, the timing math runs on scalars / `[ns]` vectors, and a
single `dynamic_update_slice` scatters the block back — O(S) work per step
instead of O(B*S) full-array copies per conditional update.

Index constants below are the single source of truth for the layout; the
engine writes it, the controller carries it, and the schedulers' key
function reads it (row-hit / open-subarray / pending bits). Changing an
index is a cross-layer change — see docs/performance.md for the contract.

Layout (all int32):

* ``sa``      — ``[nb, ns + 1, SA_F]`` per-subarray timing plane. Rows
  ``0..ns-1`` are the subarrays; row ``ns`` is the *bank-vector row*
  (lanes ``BK_*``), riding in the same tensor so the per-step gather and
  scatter each touch ONE buffer instead of two,
* ``act_hist``— ``[4]`` last four ACT issue cycles, ``[0]`` oldest (tFAW),
* ``scalars`` — ``[SC_F]`` channel-global scalars + result counters.

Booleans (``SC_COL_LAST_WR``) are stored as 0/1 int32; row ids use
``NEG = -1`` as the "no open row" sentinel.

Port note: a framework-free copy of ``repro.core.dram.state_layout``, with
import paths rewritten to ``repro_torch`` (the port never imports
the JAX package); tests/test_torch_frontend.py holds it equal to
the reference.
"""
from __future__ import annotations

import numpy as np

#: "no open row / no open subarray" sentinel.
NEG = np.int32(-1)

# ---- sa: [nb, ns + 1, SA_F] per-subarray timing plane ----------------------
SA_OPEN_ROW = 0    # row latched in this subarray's local buffer (NEG = none)
SA_ACT_DONE = 1    # cycle the last ACT's tRCD completes (column-ready)
SA_RAS_DONE = 2    # earliest PRE after tRAS / tRTP
SA_WRR_DONE = 3    # earliest PRE after write recovery (tWR)
SA_PRE_DONE = 4    # cycle the last PRE's tRP completes (ACT-ready)
SA_F = 5

# lanes of the bank-vector row (sa[:, ns, :])
BK_DESIGNATED = 0  # MASA: subarray currently driving the global bitlines
BK_OPEN_SA = 1     # non-MASA: the single activated subarray (NEG = none)
BK_LAST_ACT = 2    # last ACT issue cycle in this bank (tRRD_sa spacing)

# ---- scalars: [SC_F] channel-global scalars + SimResult counters -----------
SC_COL_LAST = 0        # last column-command issue cycle (tCCD spacing)
SC_COL_LAST_WR = 1     # 1 iff the last column command was a write
SC_WR_DATA_END = 2     # end of the last write's data burst (tWTR base)
SC_DATA_BUS_FREE = 3   # cycle the shared data bus frees (pending gate)
SC_LAST_OPEN_TIME = 4  # sa_open_cycles integration checkpoint
SC_OPEN_COUNT = 5      # currently-activated subarrays (MASA static power)
SC_C_ACT = 6
SC_C_PRE = 7
SC_C_RD = 8
SC_C_WR = 9
SC_C_SASEL = 10
SC_C_HIT = 11
SC_SUM_LAT = 12
SC_C_READS = 13
SC_SA_OPEN_CYC = 14
SC_MAX_COMP = 15
SC_F = 16

# ---- controller carries ----------------------------------------------------
# core: [C, CORE_F] per-core bookkeeping
CORE_PTR = 0       # next un-served request index in this core's stream
CORE_VIS_PREV = 1  # visibility cycle of the core's last served request
CORE_MAX_COMP = 2  # max completion cycle over the core's served requests
CORE_F = 3

# ref: [nb, REF_F] per-bank refresh bookkeeping (only when refresh_mode).
# The first three lanes are the historical blocking/DSARP machinery; DEBT and
# LAST_END serve the per-bank ladder (REFpb / DARP / SARP): DARP's postponed-
# refresh counter (non-negative: matured-but-unperformed obligations, capped
# at ``DramTiming.ref_postpone_max`` — overflow forces blocking bursts;
# ahead-of-deadline pull-in credit is NOT modeled) and the write-drain /
# idle-gap bookkeeping (end of the bank's last demand activity, so the
# controller can size the idle window a pull-in or a write-shadow refresh
# may occupy).
REF_NEXT_DUE = 0     # staggered tREFI deadline
REF_BUSY_UNTIL = 1   # end of the in-flight refresh burst
REF_BUSY_TARGET = 2  # subarray the in-flight burst occupies (DSARP/SARP)
REF_DEBT = 3         # DARP: postponed (owed, >= 0) refresh count
REF_LAST_END = 4     # DARP: end of the bank's last served demand request
REF_F = 5

# ---- packed request layouts (controller) -----------------------------------
# reqs: [C, N, RQ_F] request tensor of the general C-core path — each step
# gathers every head field with one advanced-indexing gather.
RQ_BANK = 0
RQ_SA = 1
RQ_ROW = 2
RQ_WR = 3        # is_write as 0/1
RQ_GAP = 4
RQ_DEP = 5       # dep as 0/1
RQ_F = 6
# the chosen head's row is the request fields + step bookkeeping appended:
RQ_VIS = 6       # visibility cycle of the head
RQ_PTR = 7       # the head's request index in its core's stream
RQ_MAX_COMP = 8  # the serving core's running max completion
RQ_EXT_F = 9

# xs: [N, XS_F] per-step rows of the C == 1 fast path (request index + the
# RQ_BANK..RQ_DEP fields shifted one lane right).
XS_IDX = 0
XS_BANK, XS_SA, XS_ROW, XS_WR, XS_GAP, XS_DEP = range(1, 7)
XS_F = 7

# ---- packed command-log records (emit_commands) -----------------------------
# When ``SimConfig.emit_commands`` is on, every controller scan step emits a
# fixed block of ``[slots, CMD_F]`` int32 records (one slot per command the
# step *may* issue; unused slots carry OP_NOP). The slot count is static per
# (closed_row, refresh_mode) configuration; :mod:`repro_torch.core.dram.commands`
# decodes the stacked ``[steps, slots, CMD_F]`` output into a flat
# :class:`CommandTrace`. Opcodes are plain ints here so the engine/controller
# never import the (host-side) commands module; ``commands.CommandOp`` wraps
# the same values.
CMD_OP = 0      # OP_* opcode (OP_NOP = unused slot)
CMD_CYCLE = 1   # issue cycle of the command
CMD_BANK = 2
CMD_SA = 3      # subarray; NEG for bank-granular REF bursts
CMD_ROW = 4     # row id (ACT/COL); NEG when the slot has no row meaning
CMD_AUX = 5     # RD/WR: the request's visibility cycle; REF: burst-chain
                # length (DARP drains fire several back-to-back bursts in one
                # step — decode expands the chain); 0 otherwise
CMD_F = 6

OP_NOP = 0
OP_ACT = 1
OP_PRE = 2      # explicit precharge (counted in SimResult.n_pre)
OP_PREA = 3     # closed-row auto-precharge (folded into the access; NOT
                # counted in n_pre — see engine._timing_step)
OP_RD = 4
OP_WR = 5
OP_SASEL = 6    # MASA SA_SEL designation change before a column command
OP_REF = 7      # refresh-burst start (bank- or subarray-granular per mode)
