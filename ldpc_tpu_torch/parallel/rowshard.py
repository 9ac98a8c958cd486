"""Check-block-axis (row) sharded decoder: the port of
``ldpc_tpu.parallel.rowshard``, the sequence-parallel analog.

SURVEY §5: the reference never shards a codeword across devices (it holds a
full 1022x8176 dense message matrix per GPU and shards only transmissions).
The mapping of sequence/tensor parallelism onto this workload is to shard
the **check-block axis** of one codeword's message state: each rank of the
mesh's ``row`` axis owns a contiguous slice of block rows (its checks'
messages), computes its rows' check updates locally, and the variable-node
accumulation becomes a sum over the row axis.

For every code the reference ships (n <= 8176) one card holds the whole
state, so this path exists for *giant* codes (z in the tens of thousands)
and as the second axis of a (data, row) 2-D mesh: the batch sharded over
``data``, the check rows over ``row``.  The JAX package's giant-code path
has no Pallas kernel, and this port of it none either: plain torch ops on
each rank's block rows, with the check update of ``ops/decoder.py``.

An iteration, with the semantics of ``ops/decoder.py`` (check before
update, latching, the state after exactly ``max_iters`` updates for a word
that does not converge):
  * the check frame: the rank's checks gather the totals [B, n], which
    every rank of a row group holds alike;
  * the syndrome: the rank's unsatisfied checks a word, summed over the
    row group (one ``all_reduce``) -> per-word ``ok``;
  * the variable frame: the rank's new messages added into a partial
    [B, n] frame, summed over the row group (the second ``all_reduce``),
    ``totals = channel + sum``.

With integer-valued LLRs the min-sum trajectories are bit-exact against
the unsharded decoder (every partial sum exact in float32); with other
floats they differ only by the order of float32 sums, like every engine
pair in this repository.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..codes.qc import QCCode
from ..ops.decoder import _KINDS, _check_node_update
from ..ops.plan import DecodePlan, frame_indices
from .mesh import all_reduce_sum, mesh_position, mesh_rows

__all__ = ["make_row_sharded_decoder"]


class RowShardedDecoder:
    """``fn(llr[B, n]) -> (errors[B], iterations[B], success[B])`` with the
    check-block axis sharded over a mesh axis; see
    :func:`make_row_sharded_decoder`."""

    def __init__(self, code: QCCode, mesh: DeviceMesh, row_axis: str,
                 data_axis: str | None, max_iters: int, kind: str, alpha,
                 beta, dtype):
        if kind not in _KINDS:
            raise ValueError(f"unknown decoder kind: {kind}")
        plan = DecodePlan.from_code(code)
        row, nrow = mesh_position(mesh, [row_axis])
        if plan.block_rows % nrow:
            raise ValueError(f"block_rows {plan.block_rows} not divisible "
                             f"by row-axis size {nrow}")
        per = plan.block_rows // nrow
        lo, hi = row * per * plan.z, (row + 1) * per * plan.z
        f = frame_indices(plan)
        self.var_idx = torch.as_tensor(f["var_idx"][lo:hi], dtype=torch.int64)
        self.valid = torch.as_tensor(f["cn_valid"][lo:hi], dtype=torch.bool)
        self.slot = torch.arange(plan.dmax_cn)
        self.n, self.mesh = plan.n, mesh
        self.row_axis, self.data_axis = row_axis, data_axis
        self.max_iters, self.kind = int(max_iters), kind
        self.alpha = float(alpha) if kind == "normalized-min-sum" else None
        self.beta = float(beta) if kind == "offset-min-sum" else None
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype

    def __call__(self, llr: torch.Tensor):
        if llr.ndim != 2 or llr.shape[1] != self.n:
            raise ValueError(f"llr must be [B, {self.n}], got "
                             f"{tuple(llr.shape)}")
        dev, b_all = llr.device, llr.shape[0]
        rows = slice(0, b_all)
        if self.data_axis is not None:
            nd = mesh_position(self.mesh, [self.data_axis])[1]
            if b_all % nd:
                raise ValueError(f"batch {b_all} must divide over {nd} "
                                 f"data ranks")
            rows = mesh_rows(self.mesh, b_all, [self.data_axis])
        b = rows.stop - rows.start
        var_idx = self.var_idx.to(dev)
        valid = self.valid.to(dev)
        slot = self.slot.to(dev)
        flat_idx = var_idx.reshape(-1)
        row_axes = [self.row_axis]
        channel = -llr[rows].to(self.dtype)   # inside: positive = 0
        totals = channel
        c2v = torch.zeros(b, *var_idx.shape, dtype=self.dtype, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        iters = torch.full((b,), self.max_iters, dtype=torch.int32,
                           device=dev)
        hard_latch = torch.zeros(b, self.n, dtype=torch.bool, device=dev)
        final_hard = hard_latch
        for it in range(self.max_iters + 1):
            t_cn = totals[:, var_idx]                          # [b, m_l, D]
            par = ((t_cn < 0) & valid).sum(-1) % 2
            unsat = all_reduce_sum(par.sum(-1, dtype=torch.int64),
                                   self.mesh, row_axes)
            ok = unsat == 0
            newly = ok & ~done
            iters = iters.masked_fill(newly, it)
            hard_vn = totals < 0
            hard_latch = torch.where(newly[:, None], hard_vn, hard_latch)
            final_hard = hard_vn
            done = done | ok
            if bool(done.all()) or it == self.max_iters:
                break
            c2v = _check_node_update(t_cn - c2v, valid, slot, self.kind,
                                     self.alpha, self.beta)
            partial = torch.zeros_like(channel).index_add_(
                1, flat_idx, c2v.reshape(b, -1))
            totals = channel + all_reduce_sum(partial, self.mesh, row_axes)
        hard = torch.where(done[:, None], hard_latch, final_hard)
        out = torch.stack([hard.sum(-1, dtype=torch.int64),
                           iters.to(torch.int64), done.to(torch.int64)])
        if self.data_axis is not None:
            # every data rank's words in place, zeros elsewhere, summed
            full = torch.zeros(3, b_all, dtype=torch.int64, device=dev)
            full[:, rows] = out
            out = all_reduce_sum(full, self.mesh, [self.data_axis])
        return (out[0].to(torch.int32), out[1].to(torch.int32),
                out[2].to(torch.bool))


def make_row_sharded_decoder(code: QCCode, mesh: DeviceMesh, *,
                             row_axis: str = "row",
                             data_axis: str | None = None,
                             max_iters: int = 50, kind: str = "min-sum",
                             alpha: float = 0.75, beta: float = 0.15,
                             dtype=torch.float32) -> RowShardedDecoder:
    """Build ``fn(llr[B, n]) -> (errors[B], iterations[B], success[B])``
    with the check-block axis sharded over ``mesh[row_axis]`` (and the
    batch over ``mesh[data_axis]`` if given).

    Every rank of the mesh calls ``fn`` with the same global ``llr``, on
    the device it decodes on, and gets every word's outputs; a data rank
    decodes only its contiguous rows of the batch.  ``code.block_rows``
    must divide evenly by the row-axis size.
    """
    return RowShardedDecoder(code, mesh, row_axis, data_axis, max_iters,
                             kind, alpha, beta, dtype)
