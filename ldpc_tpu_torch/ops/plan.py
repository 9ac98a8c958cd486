"""Static decode plans: QC shift tables -> index tables (numpy).

Copy of ``ldpc_tpu.ops.plan``: the same slot tables, so the port's decoders
and the JAX package's walk the Tanner graph in the same edge order.

Slot layout:
  * CN side: ``cn_nb[mb, d]`` / ``cn_shift[mb, d]`` / ``cn_valid[mb, d]``
    list the (block-col, shift) edges of block row ``mb``, padded to the max
    block-row degree ``Dmax``.  Slot ``(mb, d)`` joins check node
    ``mb*Z + i`` to variable node ``cn_nb*Z + (i + cn_shift) % Z``.
  * VN side: ``vn_slot[nb, dv]`` indexes into the flattened ``Mb*Dmax`` slot
    axis and ``vn_shift[nb, dv]`` is that edge's shift, padded to the max
    block-col degree ``DmaxV``, in ascending block-row order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codes.qc import QCCode

__all__ = ["DecodePlan", "frame_indices"]


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Host-compiled static structure of a QC code, consumed by the decoders.

    All arrays are plain numpy; the decoders upload what they need to the
    device once, when they are built.
    """

    z: int
    block_rows: int           # Mb
    block_cols: int           # Nb
    dmax_cn: int              # max block-row degree (near-earth: 32)
    dmax_vn: int              # max block-col degree (near-earth: 4)
    # CN side, shape [Mb, dmax_cn]:
    cn_nb: np.ndarray         # int32 block col of each slot (0 for padding)
    cn_shift: np.ndarray      # int32 circulant shift of each slot
    cn_valid: np.ndarray      # bool
    # VN side, shape [Nb, dmax_vn]:
    vn_slot: np.ndarray       # int32 index into flattened [Mb*dmax_cn] slots
    vn_shift: np.ndarray      # int32 shift of that edge
    vn_valid: np.ndarray      # bool

    @property
    def n(self) -> int:
        return self.block_cols * self.z

    @property
    def m(self) -> int:
        return self.block_rows * self.z

    @property
    def num_slots(self) -> int:
        return self.block_rows * self.dmax_cn

    @staticmethod
    def from_code(code: QCCode) -> "DecodePlan":
        mb_n, nb_n, z = code.block_rows, code.block_cols, code.z
        # CN side: edges of each block row in ascending (block col, shift)
        # order — the same column-major order the reference's checkNode uses
        # for its address book (np.where over a row, ldpc.py:244).
        rows = [
            [(nb, s) for nb, block in enumerate(code.shifts[mb]) for s in block]
            for mb in range(mb_n)
        ]
        dmax = max((len(r) for r in rows), default=0)
        dmax = max(dmax, 1)
        cn_nb = np.zeros((mb_n, dmax), np.int32)
        cn_shift = np.zeros((mb_n, dmax), np.int32)
        cn_valid = np.zeros((mb_n, dmax), bool)
        for mb, r in enumerate(rows):
            for d, (nb, s) in enumerate(r):
                cn_nb[mb, d] = nb
                cn_shift[mb, d] = s
                cn_valid[mb, d] = True

        # VN side: for each block col, the (flat slot, shift) of its edges in
        # ascending block-row order (the reference accumulates CN messages in
        # ascending check index, ldpc.py:298-303).
        cols: list[list[tuple[int, int]]] = [[] for _ in range(nb_n)]
        for mb, r in enumerate(rows):
            for d, (nb, s) in enumerate(r):
                cols[nb].append((mb * dmax + d, s))
        dmax_v = max((len(c) for c in cols), default=0)
        dmax_v = max(dmax_v, 1)
        vn_slot = np.zeros((nb_n, dmax_v), np.int32)
        vn_shift = np.zeros((nb_n, dmax_v), np.int32)
        vn_valid = np.zeros((nb_n, dmax_v), bool)
        for nb, c in enumerate(cols):
            for dv, (slot, s) in enumerate(c):
                vn_slot[nb, dv] = slot
                vn_shift[nb, dv] = s
                vn_valid[nb, dv] = True

        return DecodePlan(
            z=z, block_rows=mb_n, block_cols=nb_n,
            dmax_cn=dmax, dmax_vn=dmax_v,
            cn_nb=cn_nb, cn_shift=cn_shift, cn_valid=cn_valid,
            vn_slot=vn_slot, vn_shift=vn_shift, vn_valid=vn_valid,
        )


def frame_indices(plan: DecodePlan) -> dict:
    """Flat gather indices of the two frames (numpy), shared by the port's
    batched decoders:

    * ``var_idx[c, d]``: the variable of check ``c = mb*z + i``, slot ``d``,
      ``cn_nb*z + (i + cn_shift) % z`` (0 where ``cn_valid`` is False);
    * ``chk_idx[v, k]`` and ``chk_d[v, k]``: the check and row slot of
      variable ``v = nb*z + j``, column slot ``k``,
      ``mb*z + (j - vn_shift) % z`` (0 where ``vn_valid`` is False).
    """
    z, dc = plan.z, plan.dmax_cn
    i = np.arange(z)
    var_idx = (plan.cn_nb[:, None, :] * z +
               (i[None, :, None] + plan.cn_shift[:, None, :]) % z)
    cn_valid = np.broadcast_to(plan.cn_valid[:, None, :], var_idx.shape)
    col_mb, col_d = plan.vn_slot // dc, plan.vn_slot % dc
    chk_idx = (col_mb[:, None, :] * z +
               (i[None, :, None] - plan.vn_shift[:, None, :]) % z)
    vn_valid = np.broadcast_to(plan.vn_valid[:, None, :], chk_idx.shape)
    chk_d = np.broadcast_to(col_d[:, None, :], chk_idx.shape)
    flat = lambda a: np.ascontiguousarray(a).reshape(-1, a.shape[-1])  # noqa: E731
    return {"var_idx": flat(np.where(cn_valid, var_idx, 0)),
            "cn_valid": flat(cn_valid),
            "chk_idx": flat(np.where(vn_valid, chk_idx, 0)),
            "chk_d": flat(chk_d),
            "vn_valid": flat(vn_valid)}
