"""Collective matmul: all-gather ∥ GEMM overlap — SALP-1 at the link level.

The counterpart of ``repro.distributed.collective_matmul``. Tensor
parallelism computes y = x @ W with x sharded on its rows. The naive
schedule is all-gather(x) *then* matmul: latency = T_ag + T_mm. Here the
all-gather is decomposed into per-shard chunks moved around a ring while the
resident chunk is multiplied — chunk transfer ("activation" of the next
subarray) overlaps compute ("column access"):

    latency ~= max(T_ag, T_mm) + one-chunk ramp

Each hop posts the send of the resident chunk to the next rank and the
receive of the previous rank's as one batch of ``dist.P2POp`` before the
multiply and waits on them after it; on NCCL the transfers run on their
own stream, so they overlap the multiply. The multiply is ``torch.matmul``
(the reference's is ``jnp.dot``, not a Pallas kernel). The schedule and its
numerics are the reference's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import rows_over


def ag_matmul_ring(x_shard: torch.Tensor, w: torch.Tensor,
                   group: dist.ProcessGroup) -> torch.Tensor:
    """x_shard [m/n, k] (this rank's rows of x over ``group``'s n ranks),
    w [k, n_out] -> all_gather(x) @ w [m, n_out], with the ring-overlap
    schedule. Every rank of ``group`` calls it."""
    n_dev = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n_dev)
    prv = dist.get_global_rank(group, (idx - 1) % n_dev)

    m_shard = x_shard.shape[0]
    out = torch.empty((n_dev * m_shard, w.shape[1]), dtype=x_shard.dtype,
                      device=x_shard.device)
    chunk = x_shard.contiguous()
    for i in range(n_dev):
        reqs = []
        if i < n_dev - 1:
            # move the next chunk around the ring ("activate" the next
            # subarray) while the resident one is multiplied
            incoming = torch.empty_like(chunk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, chunk, nxt, group),
                dist.P2POp(dist.irecv, incoming, prv, group)])
        # compute on the resident chunk ("column access" on the open row)
        src = (idx - i) % n_dev
        out[src * m_shard:(src + 1) * m_shard] = torch.matmul(chunk, w)
        for r in reqs:
            r.wait()
        if reqs:
            chunk = incoming
    return out


def collective_matmul(x, w: torch.Tensor, mesh, axis: str = "model"
                      ) -> torch.Tensor:
    """y[m, n] = x[m, k] @ w[k, n], with x row-sharded over ``axis`` (as
    ``sharding.rows_over`` takes it) and the gather overlapped with
    compute. w is replicated. Returns the whole y on every rank."""
    return ag_matmul_ring(rows_over(x, mesh, axis).to_local(), w,
                          mesh.get_group(axis))
