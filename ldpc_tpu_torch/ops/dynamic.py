"""Structure-generic decoder: QC shift tables as runtime tensors (plain
torch; the counterpart of the JAX package's XLA module ``ops/dynamic.py``).

The RL code search mutates the parity structure every environment step
(``LdpcEnv.replaceCirculant``, ldpc_env.py:293-317).  Here the plan tables
(block-col ids, circulant shifts, validity masks) are tensors, not
constants: one decoder serves every code of a shape family (Mb, Nb, Z,
padded degree caps), and circulant alignment is a gather along the Z axis
by ``(i + s) mod z`` with runtime index tensors.

Same update rule as ``ops/decoder.py`` and the JAX module: the syndrome is
checked BEFORE each update; a word that converges latches its hard
decisions, iteration count (and, with ``keep_soft``, its soft values); a
word that does not reports the state after exactly ``max_iters`` updates;
the check update is ``ops.decoder._check_node_update`` (the four kinds).
A variable's total is its channel value plus each of its column's
messages, added one by one in the plan's column-slot order: the fused
kernel's order (``ops/cuda_static.py``), so the kernel's plain version
with a float32 store and this decoder agree on every word of the min-sum
family.  The JAX module sums ``channel + (0 + messages)``, its Pallas
kernel the kernel's way; where the two orders round differently a word on
the edge of convergence may go either way, as between the JAX package's
own engines (``ops/pallas_static.py:51-56``).

This module is the plain reference of the code search's decode.  On the
card the env decodes each candidate with the fused kernel instead
(``ops/cuda_static.py``), whose edge tables are device data too, so a
mutated code costs a table upload and no build.

The decoders take ``plan`` and ``llr`` on one device and return there.
``make_multi_dynamic_decoder`` decodes N candidates, each over its own
``[B]`` words; each candidate's result equals its single decode.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.device import resolve_device
from .decoder import _KINDS, DecodeResult, _check_node_update
from .plan import DecodePlan

__all__ = ["DynamicPlan", "make_dynamic_decoder", "dynamic_plan",
           "make_multi_dynamic_decoder", "stack_plans"]

_FIELDS = ("cn_nb", "cn_shift", "cn_valid", "vn_slot", "vn_shift",
           "vn_valid")


@dataclasses.dataclass
class DynamicPlan:
    """Device-tensor decode plan.  Shapes (a leading [N] when stacked):

    cn_nb/cn_shift/cn_valid: [Mb, D]   (D = padded block-row degree cap)
    vn_slot/vn_shift/vn_valid: [Nb, DV] (slot indexes into flattened Mb*D)
    """

    cn_nb: torch.Tensor
    cn_shift: torch.Tensor
    cn_valid: torch.Tensor
    vn_slot: torch.Tensor
    vn_shift: torch.Tensor
    vn_valid: torch.Tensor

    @property
    def shape_key(self):
        mb, d = self.cn_nb.shape[-2:]
        nb, dv = self.vn_slot.shape[-2:]
        return (mb, nb, d, dv)


def dynamic_plan(code: QCCode, dmax_cn: int | None = None,
                 dmax_vn: int | None = None, *, device=None) -> DynamicPlan:
    """Build a DynamicPlan on ``device`` (default: the card), optionally
    padded to fixed degree caps.

    Fixed caps let one decoder serve every mutated variant of a code as
    long as its degrees stay under the caps (the env rejects actions
    exceeding them).
    """
    dev = resolve_device(device)
    base = DecodePlan.from_code(code)
    d = dmax_cn if dmax_cn is not None else base.dmax_cn
    dv = dmax_vn if dmax_vn is not None else base.dmax_vn
    if base.dmax_cn > d or base.dmax_vn > dv:
        raise ValueError(
            f"code degrees ({base.dmax_cn}, {base.dmax_vn}) exceed caps "
            f"({d}, {dv})")
    mb, nb = base.block_rows, base.block_cols

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return torch.as_tensor(out, device=dev)

    # vn_slot indexes the flattened [Mb * D] slot axis; re-index for the
    # padded D.
    rows, cols = np.divmod(base.vn_slot, base.dmax_cn)
    vslot = rows * d + cols
    return DynamicPlan(
        cn_nb=pad(base.cn_nb, (mb, d)),
        cn_shift=pad(base.cn_shift, (mb, d)),
        cn_valid=pad(base.cn_valid, (mb, d), False),
        vn_slot=pad(vslot, (nb, dv)),
        vn_shift=pad(base.vn_shift, (nb, dv)),
        vn_valid=pad(base.vn_valid, (nb, dv), False),
    )


def stack_plans(plans) -> DynamicPlan:
    """Stack N same-shape-family plans into one [N, ...] plan."""
    keys = {p.shape_key for p in plans}
    if len(keys) != 1:
        raise ValueError(f"plans span several shape families: {keys}")
    return DynamicPlan(**{f: torch.stack([getattr(p, f) for p in plans])
                          for f in _FIELDS})


class _MultiDecoder:
    """``decode(plans[N, ...], llr[N, B, n]) -> DecodeResult`` with a
    leading [N] on every field: the loop runs until every candidate's
    words converged or ``max_iters``; per-word latching makes the extra
    iterations of a candidate that finished early invisible."""

    def __init__(self, z, block_rows, block_cols, dmax_cn, dmax_vn,
                 max_iters, kind, alpha, beta, dtype, keep_soft):
        self.z, self.mb, self.nb = z, block_rows, block_cols
        self.d, self.dv = dmax_cn, dmax_vn
        self.max_iters, self.kind = max_iters, kind
        self.alpha, self.beta = alpha, beta
        self.dtype, self.keep_soft = dtype, keep_soft

    def _indices(self, plans: DynamicPlan):
        """Flat gather indices [N, m*D] and [N, n*DV] (as ``frame_indices``)
        and the validity masks [N, 1, m, D] and [N, 1, n, DV]."""
        z, d, dv = self.z, self.d, self.dv
        k = plans.cn_nb.shape[0]
        i = torch.arange(z, device=plans.cn_nb.device)
        cn_nb, cn_shift = plans.cn_nb.long(), plans.cn_shift.long()
        # var_idx[c = mb*z + i, s] = cn_nb*z + (i + shift_s) % z
        var_idx = (cn_nb[:, :, None, :] * z +
                   (i[None, None, :, None] + cn_shift[:, :, None, :]) % z)
        cn_valid = plans.cn_valid[:, :, None, :].expand(var_idx.shape)
        # msg_idx[v = nb*z + j, e] = (mb*z + (j - shift_e) % z) * D + slot
        col_mb = plans.vn_slot.long() // d
        col_d = plans.vn_slot.long() % d
        chk = (col_mb[:, :, None, :] * z +
               (i[None, None, :, None] - plans.vn_shift.long()[:, :, None, :])
               % z)
        msg_idx = chk * d + col_d[:, :, None, :]
        vn_valid = plans.vn_valid[:, :, None, :].expand(msg_idx.shape)
        var_idx = torch.where(cn_valid, var_idx, 0).reshape(k, -1)
        msg_idx = torch.where(vn_valid, msg_idx, 0).reshape(k, -1)
        return (var_idx, cn_valid.reshape(k, 1, -1, d), msg_idx,
                vn_valid.reshape(k, 1, -1, dv))

    def __call__(self, plans: DynamicPlan, llr: torch.Tensor) -> DecodeResult:
        k, b, n = llr.shape
        if n != self.nb * self.z or plans.shape_key != (self.mb, self.nb,
                                                        self.d, self.dv):
            raise ValueError(f"llr [{k}, {b}, {n}] or plan "
                             f"{plans.shape_key} outside the shape family "
                             f"{(self.mb, self.nb, self.d, self.dv)}, "
                             f"z = {self.z}")
        dev, dt = llr.device, self.dtype
        var_idx, cn_valid, msg_idx, vn_valid = self._indices(plans)
        m, d = self.mb * self.z, self.d
        slot = torch.arange(d, device=dev)
        var_idx = var_idx[:, None, :].expand(k, b, -1)
        msg_idx = msg_idx[:, None, :].expand(k, b, -1)
        channel = -llr.to(dt)                  # internal: positive = bit 0
        totals = channel
        c2v = torch.zeros(k, b, m, d, dtype=dt, device=dev)
        done = torch.zeros(k, b, dtype=torch.bool, device=dev)
        iters = torch.full((k, b), self.max_iters, dtype=torch.int32,
                           device=dev)
        hard_latch = torch.zeros(k, b, n, dtype=torch.bool, device=dev)
        soft_latch = torch.zeros_like(channel) if self.keep_soft else None
        final_hard, final_soft = hard_latch, soft_latch
        for it in range(self.max_iters + 1):
            t_cn = torch.gather(totals, 2, var_idx).view(k, b, m, d)
            hard_vn = totals < 0
            par = ((t_cn < 0) & cn_valid).sum(-1) % 2
            ok = ~par.bool().any(-1)
            newly = ok & ~done
            iters = iters.masked_fill(newly, it)
            hard_latch = torch.where(newly[..., None], hard_vn, hard_latch)
            final_hard = hard_vn
            if self.keep_soft:
                soft_latch = torch.where(newly[..., None], totals,
                                         soft_latch)
                final_soft = totals
            done = done | ok
            if it == self.max_iters or bool(done.all()):
                break
            c2v = _check_node_update(t_cn - c2v, cn_valid, slot, self.kind,
                                     self.alpha, self.beta)
            msg = torch.gather(c2v.view(k, b, m * d), 2, msg_idx)
            msg = torch.where(vn_valid, msg.view(k, b, n, self.dv),
                              0.0).to(dt)
            totals = channel
            for e in range(self.dv):
                totals = totals + msg[..., e]
        hard = torch.where(done[..., None], hard_latch, final_hard)
        if self.keep_soft:
            soft = -torch.where(done[..., None], soft_latch, final_soft)
        else:
            soft = torch.zeros(k, b, 0, dtype=dt, device=dev)
        return DecodeResult(hard=hard.to(torch.int8), iterations=iters,
                            success=done, soft=soft)


@functools.lru_cache(maxsize=32)
def make_multi_dynamic_decoder(z: int, block_rows: int, block_cols: int,
                               dmax_cn: int, dmax_vn: int,
                               max_iters: int = 50, *,
                               kind: str = "min-sum", alpha: float = 0.75,
                               beta: float = 0.15,
                               dtype_name: str = "float32",
                               keep_soft: bool = False):
    """``decode(plans: DynamicPlan[N, ...], llr[N, B, n]) -> DecodeResult``
    (every field with a leading [N]).

    One call evaluates N mutated codes, each over its own [B]-word
    Monte-Carlo batch — the RL search's candidate axis becomes a tensor
    axis instead of a Python loop over env steps (the reference steps one
    candidate per process-pool submit, envContainer.py:38-56 ->
    ldpc_env.py:353-377).  Per-candidate results are identical to N
    separate :func:`make_dynamic_decoder` calls.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown decoder kind: {kind}")
    a = float(alpha) if kind == "normalized-min-sum" else None
    bta = float(beta) if kind == "offset-min-sum" else None
    return _MultiDecoder(int(z), int(block_rows), int(block_cols),
                         int(dmax_cn), int(dmax_vn), int(max_iters), kind, a,
                         bta, getattr(torch, dtype_name), bool(keep_soft))


@functools.lru_cache(maxsize=32)
def make_dynamic_decoder(z: int, block_rows: int, block_cols: int,
                         dmax_cn: int, dmax_vn: int, max_iters: int = 50,
                         *, kind: str = "min-sum", alpha: float = 0.75,
                         beta: float = 0.15, dtype_name: str = "float32",
                         keep_soft: bool = False):
    """``decode(plan: DynamicPlan, llr[B, n]) -> DecodeResult``.

    Built once per shape family; the plan is a runtime argument, so
    mutated codes decode with no rebuild.
    """
    multi = make_multi_dynamic_decoder(
        z, block_rows, block_cols, dmax_cn, dmax_vn, max_iters, kind=kind,
        alpha=alpha, beta=beta, dtype_name=dtype_name, keep_soft=keep_soft)

    def decode(plan: DynamicPlan, llr: torch.Tensor) -> DecodeResult:
        res = multi(stack_plans([plan]), llr[None])
        return DecodeResult(hard=res.hard[0], iterations=res.iterations[0],
                            success=res.success[0], soft=res.soft[0])

    return decode
