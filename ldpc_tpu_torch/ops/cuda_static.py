"""Flooding min-sum decode with two-min check state: the CUDA kernel, its
plain PyTorch version, and the wrapper that chooses between them.

Port of ``ldpc_tpu.ops.pallas_static`` for its main-path configuration
(flooding schedule, ``kind="min-sum"``, bfloat16 state storage, f32
arithmetic).  ``make_static_sweep_decoder(code, max_iters)`` returns
``decode_counts(llr[B, n]) -> (errors[B], iterations[B], success[B])``, the
contract of the Pallas decoder: bit errors against the all-zero codeword,
the first iteration whose syndrome is zero (``max_iters`` if none), and
whether there was one.  The check runs BEFORE each update, so a word that
does not converge reports the state after exactly ``max_iters`` updates.

On a CUDA tensor the wrapper launches ``csrc/minsum_flooding.cu`` (one
thread block per word; see the note at the head of that file) or raises.
On a CPU tensor it runs ``minsum_flooding_reference``, the same arithmetic
written as batched tensor operations, with the same bf16 rounding points and
the same f32 summation order.  The two agree word for word; both agree with
the Pallas kernel word for word on converged words.

``launches`` counts kernel launches made through a wrapper; a run sets it to
0 and reads it to show which work went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.device import resolve_device
from .plan import DecodePlan

__all__ = ["make_static_sweep_decoder", "static_decode_counts",
           "minsum_flooding_reference", "kernel_tables"]

launches = 0

_BIG = 3.0e38          # two-min fold start, as ops/pallas_static.py _BIG
_LLR_CLIP = 1.0e30     # non-finite LLRs: NaN -> 0, +-inf -> +-1e30
_MAX_SMEM = 232_448 - 1024   # per-block shared memory, less static + margin
_SOURCE = "minsum_flooding"


def _sanitize(llr: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(llr, nan=0.0, posinf=_LLR_CLIP,
                            neginf=-_LLR_CLIP).clamp(-_LLR_CLIP, _LLR_CLIP)


def kernel_tables(plan: DecodePlan) -> np.ndarray:
    """The kernel's int32 edge tables, concatenated:
    row_deg | row_nb | row_shift | col_deg | col_mb | col_d | col_shift.

    Row slots are the plan's CN slots; column slots follow the plan's VN
    order (ascending block row, then slot), which is the accumulation order
    of the Pallas kernel's phase B."""
    dc = plan.dmax_cn
    col_mb = plan.vn_slot // dc
    col_d = plan.vn_slot % dc
    parts = [plan.cn_valid.sum(axis=1), plan.cn_nb, plan.cn_shift % plan.z,
             plan.vn_valid.sum(axis=1), col_mb, col_d,
             plan.vn_shift % plan.z]
    return np.concatenate([np.asarray(p, np.int32).ravel() for p in parts])


class _RefTables:
    """Gather indices of the plain version, built once per (plan, device)."""

    def __init__(self, plan: DecodePlan, device):
        z, dc = plan.z, plan.dmax_cn
        i = np.arange(z)
        # check c = mb*z + i, slot d -> variable nb*z + (i + s) % z
        var_idx = (plan.cn_nb[:, None, :] * z +
                   (i[None, :, None] + plan.cn_shift[:, None, :]) % z)
        cn_valid = np.broadcast_to(plan.cn_valid[:, None, :], var_idx.shape)
        # variable v = nb*z + j, column slot k -> check mb*z + (j - s) % z
        col_mb, col_d = plan.vn_slot // dc, plan.vn_slot % dc
        chk_idx = (col_mb[:, None, :] * z +
                   (i[None, :, None] - plan.vn_shift[:, None, :]) % z)
        vn_valid = np.broadcast_to(plan.vn_valid[:, None, :], chk_idx.shape)
        as_t = lambda a, dt: torch.as_tensor(    # noqa: E731
            np.ascontiguousarray(a).reshape(-1, a.shape[-1]), dtype=dt,
            device=device)
        self.var_idx = as_t(np.where(cn_valid, var_idx, 0), torch.int64)
        self.cn_valid = as_t(cn_valid, torch.bool)
        self.chk_idx = as_t(np.where(vn_valid, chk_idx, 0), torch.int64)
        self.chk_d = as_t(np.broadcast_to(col_d[:, None, :], chk_idx.shape),
                          torch.int64)
        self.vn_valid = as_t(vn_valid, torch.bool)
        self.slot = torch.arange(dc, dtype=torch.int64, device=device)


def _recon(m1, m2, am, sp, bits, d):
    """c2v of slot ``d`` from the two-min state (all gathered to one shape):
    sign = sp * (1 - 2*bit_d), magnitude m2 at the argmin slot, else m1."""
    bit = ((bits >> d) & 1).to(torch.float32)
    sgn = sp.float() * (1.0 - 2.0 * bit)
    mag = torch.where(am.float() == d.to(torch.float32), m2.float(),
                      m1.float())
    return sgn * mag


def _reference_chunk(llr: torch.Tensor, t: _RefTables, max_iters: int):
    bf16, f32 = torch.bfloat16, torch.float32
    b, dev = llr.shape[0], llr.device
    m = t.var_idx.shape[0]
    chan = _sanitize(llr).to(bf16)
    tot = (-chan.float()).to(bf16)
    m1 = torch.zeros(b, m, dtype=bf16, device=dev)
    m2 = torch.zeros_like(m1)
    am = torch.zeros_like(m1)
    sp = torch.ones_like(m1)
    bits = torch.zeros(b, m, dtype=torch.int64, device=dev)
    errors = torch.zeros(b, dtype=torch.int32, device=dev)
    iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
    success = torch.zeros(b, dtype=torch.bool, device=dev)
    slot = t.slot
    for it in range(max_iters + 1):
        # ---- phase A: syndrome + new two-min state, all checks at once ----
        tt = tot.float()[:, t.var_idx]                      # [b, m, dc]
        par = ((tt < 0) & t.cn_valid).sum(-1) % 2
        ok = par.sum(-1) == 0
        c2v = _recon(m1[..., None], m2[..., None], am[..., None],
                     sp[..., None], bits[..., None], slot)
        v = tt - c2v
        a = torch.where(t.cn_valid, v.abs(), _BIG)
        n1, amn = a.min(-1)
        # second minimum with multiplicity: mask one argmin slot
        n2 = a.scatter(-1, amn[..., None], float("inf")).min(-1).values
        n2 = n2.clamp(max=_BIG)
        neg = (v < 0) & t.cn_valid
        bits = (neg.to(torch.int64) << slot).sum(-1)
        sp = (1 - 2 * (neg.sum(-1) % 2)).to(bf16)
        m1, m2, am = n1.to(bf16), n2.to(bf16), amn.to(f32).to(bf16)
        # ---- latches (pallas_static.py _latches) ----
        iters = iters.masked_fill(ok & ~success, it)
        errs = (tot.float() < 0).sum(-1, dtype=torch.int32)
        errors = torch.where(success, errors, errs)
        success = success | ok
        if it == max_iters or bool(success.all()):
            break
        # ---- phase B: totals = -chan + sum over column slots, in order ----
        g = t.chk_idx                                       # [n, dv]
        msg = _recon(m1[:, g], m2[:, g], am[:, g], sp[:, g], bits[:, g],
                     t.chk_d)
        msg = torch.where(t.vn_valid, msg, -0.0)            # x + -0.0 == x
        acc = -chan.float()
        for k in range(msg.shape[-1]):
            acc = acc + msg[..., k]
        tot = acc.to(bf16)
    return errors, iters, success


def minsum_flooding_reference(llr: torch.Tensor, plan: DecodePlan,
                              max_iters: int, *, chunk: int = 4096,
                              tables: _RefTables | None = None):
    """Plain PyTorch version of the kernel, on ``llr``'s device.

    Decodes ``chunk`` words at a time (the gathered [chunk, m, dmax] state
    is the memory peak) and stops a chunk once all its words converged."""
    t = tables or _RefTables(plan, llr.device)
    outs = [_reference_chunk(llr[lo:lo + chunk], t, max_iters)
            for lo in range(0, llr.shape[0], chunk)]
    if not outs:
        e = torch.zeros(0, dtype=torch.int32, device=llr.device)
        return e, e.clone(), e.bool()
    return tuple(torch.cat(x) for x in zip(*outs))


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The kernel's library, built at first use and bound once."""
    global _LIB
    if _LIB is None:
        from ..csrc import load
        lib = load(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.minsum_flooding_launch.argtypes = [p, i, i, i, i, i, i, i, i, p,
                                               i, p, p, p, p]
        lib.minsum_flooding_launch.restype = i
        _LIB = lib
    return _LIB


def smem_bytes(plan: DecodePlan) -> int:
    """Dynamic shared memory of one block (as the .cu entry point sizes it)."""
    n_tab = (plan.block_rows * (1 + 2 * plan.dmax_cn) +
             plan.block_cols * (1 + 3 * plan.dmax_vn))
    return 4 * (n_tab + plan.m) + 2 * (4 * plan.m + 2 * plan.n)


def _launch(llr: torch.Tensor, plan: DecodePlan, tables: torch.Tensor,
            max_iters: int):
    global launches
    lib = _lib()
    b = llr.shape[0]
    out = [torch.empty(b, dtype=torch.int32, device=llr.device)
           for _ in range(3)]
    if b:
        with torch.cuda.device(llr.device):
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = lib.minsum_flooding_launch(
                llr.data_ptr(), b, plan.n, plan.m, plan.z, plan.block_rows,
                plan.block_cols, plan.dmax_cn, plan.dmax_vn,
                tables.data_ptr(), max_iters, out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{_SOURCE} launch failed: CUDA error {rc}")
        launches += 1
    return out[0], out[1], out[2].bool()


def make_static_sweep_decoder(code: QCCode, max_iters: int = 50, *,
                              device=None):
    """Build ``decode_counts(llr[B, n] float32) -> (errors, iterations,
    success)`` for ``code`` on ``device`` (default: the card).

    The decoder takes contiguous float32 LLRs on its own device (positive
    means bit 1; raw BPSK samples will do, min-sum is scale-invariant).  On
    CUDA it launches the kernel; on the CPU it runs the plain version."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    plan = DecodePlan.from_code(code)
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if dev.type == "cuda":
        if plan.dmax_cn > 32:
            raise NotImplementedError(
                f"check degree {plan.dmax_cn} > 32: the kernel packs one "
                "32-bit sign word per check")
        if smem_bytes(plan) > _MAX_SMEM:
            raise NotImplementedError(
                f"one word's state ({smem_bytes(plan)} bytes) exceeds a "
                "block's shared memory")
        tables = torch.as_tensor(kernel_tables(plan), device=dev)
    else:
        ref_tables = _RefTables(plan, dev)

    def decode_counts(llr: torch.Tensor):
        if llr.device != dev:
            raise ValueError(f"llr is on {llr.device}, decoder on {dev}")
        if llr.dtype != torch.float32:
            raise TypeError(f"llr must be float32, got {llr.dtype}")
        if llr.ndim != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be [B, {plan.n}], got "
                             f"{tuple(llr.shape)}")
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        if dev.type == "cpu":
            return minsum_flooding_reference(llr, plan, max_iters,
                                             tables=ref_tables)
        return _launch(llr, plan, tables, max_iters)

    decode_counts.plan = plan
    return decode_counts


def static_decode_counts(code: QCCode, llr: torch.Tensor,
                         max_iters: int = 50):
    """One-shot convenience wrapper, on ``llr``'s device."""
    return make_static_sweep_decoder(code, max_iters,
                                     device=llr.device)(llr)
