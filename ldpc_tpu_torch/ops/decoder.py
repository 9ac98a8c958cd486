"""Batched flooding decoder in plain torch ops: the counterpart of the JAX
package's XLA engine (``ldpc_tpu.ops.decoder``).

The JAX module is XLA code, not a Pallas kernel, so this is PyTorch
tensor code and no hand-written kernel: the ``"torch"`` engine of
``sim/evaluate.py``, used where a caller picks that engine and never in
place of the CUDA kernel.  Same semantics as the JAX module:

* messages per (check, slot) ``[B, m, Dmax]``; the check frame is a gather
  of the totals through the plan's slot tables (the JAX module rolls each
  slot's ``[Z, B]`` plane, which is the same permutation);
* the extrinsic check update of the four kinds: two-min with the first
  argmin for the min-sum family (normalized: x alpha, offset: - beta with a
  floor at 0, on the outgoing magnitude), and the log-domain phi rule for
  sum-product, phi(x) = -log(tanh(x/2)) with its argument clipped to
  [1e-9, 38];
* the syndrome is checked BEFORE each update; a word that converges latches
  its hard decisions and iteration count; a word that does not reports the
  state after exactly ``max_iters`` updates; the loop stops when every word
  converged;
* inputs are negated on entry (the JAX module's odd-degree note): positive
  LLR means bit 1 outside, bit 0 inside;
* totals are ``channel + sum`` of the column's messages, summed in the
  plan's column-slot order from 0.

``dtype`` is the compute dtype (float32, or bfloat16 for speed).  Outputs
are on the input's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.cache import BoundedCache
from ..utils.device import resolve_device
from .plan import DecodePlan, frame_indices

__all__ = ["DecodeResult", "make_decoder", "decode", "decoder_for_code"]

_PHI_MIN = 1e-9    # clamp for sum-product phi stability
_PHI_MAX = 38.0
_KINDS = ("min-sum", "normalized-min-sum", "offset-min-sum", "sum-product")


@dataclasses.dataclass
class DecodeResult:
    """Batched decode output.

    Attributes:
      hard: [B, n] int8 hard decisions (reference ``binaryVector``).
      iterations: [B] int32, iterations until convergence, or max_iters.
      success: [B] bool, syndrome satisfied.
      soft: [B, n] soft values at the successful check (or after the last
        iteration), only when built with ``keep_soft=True``; else [B, 0].
    """

    hard: torch.Tensor
    iterations: torch.Tensor
    success: torch.Tensor
    soft: torch.Tensor


class _Tables:
    """Gather indices of one plan on one device."""

    def __init__(self, plan: DecodePlan, device):
        f = frame_indices(plan)
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                             device=device)
        self.var_idx = as_t(f["var_idx"], torch.int64)
        self.cn_valid = as_t(f["cn_valid"], torch.bool)
        # variable, column slot -> flat (check, slot) message index
        self.msg_idx = as_t(f["chk_idx"] * plan.dmax_cn + f["chk_d"],
                            torch.int64)
        self.vn_valid = as_t(f["vn_valid"], torch.bool)
        self.slot = torch.arange(plan.dmax_cn, device=device)


def _check_node_update(v: torch.Tensor, valid: torch.Tensor,
                       slot: torch.Tensor, kind: str, alpha, beta):
    """Extrinsic check update over the last (slot) axis of v [B, m, D]."""
    dtype = v.dtype
    big = torch.finfo(dtype).max
    absv = torch.where(valid, v.abs(), big)
    # sign of 0 is +1 (ldpc.py:135-141)
    sgn = torch.where(v < 0, -1.0, 1.0).to(dtype)
    sgn = torch.where(valid, sgn, 1.0).to(dtype)
    ext_sign = sgn.prod(-1, keepdim=True) * sgn
    if kind == "sum-product":
        x = torch.where(valid, v.abs(), 0.0).to(dtype).clamp(_PHI_MIN,
                                                             _PHI_MAX)
        phi = -torch.log(torch.tanh(x * 0.5))
        phi = torch.where(valid, phi, 0.0).to(dtype)
        total = phi.sum(-1, keepdim=True)
        rest = (total - phi).clamp(_PHI_MIN, _PHI_MAX)
        mag = -torch.log(torch.tanh(rest * 0.5))
    else:
        m1 = absv.min(-1, keepdim=True).values
        am = absv.argmin(-1, keepdim=True)       # first occurrence
        is_am = slot == am
        m2 = torch.where(is_am, big, absv).min(-1, keepdim=True).values
        mag = torch.where(is_am, m2, m1)
        if kind == "normalized-min-sum":
            mag = mag * torch.tensor(alpha, dtype=dtype)
        elif kind == "offset-min-sum":
            mag = (mag - torch.tensor(beta, dtype=dtype)).clamp_min(0.0)
    return torch.where(valid, ext_sign * mag, 0.0).to(dtype)


class _Decoder:
    """``decode_fn(llr[B, n]) -> DecodeResult`` for one plan and settings;
    gather tables are built once per device."""

    def __init__(self, plan: DecodePlan, max_iters: int, kind: str, alpha,
                 beta, dtype: torch.dtype, keep_soft: bool):
        self.plan, self.max_iters, self.kind = plan, max_iters, kind
        self.alpha, self.beta = alpha, beta
        self.dtype, self.keep_soft = dtype, keep_soft
        self._tables: dict = {}

    def __call__(self, llr: torch.Tensor) -> DecodeResult:
        plan, max_iters = self.plan, self.max_iters
        if llr.ndim != 2 or llr.shape[1] != plan.n:
            raise ValueError(f"llr must be [B, {plan.n}], got "
                             f"{tuple(llr.shape)}")
        dev = llr.device
        t = self._tables.get(dev)
        if t is None:
            t = self._tables[dev] = _Tables(plan, dev)
        b, m, dc = llr.shape[0], plan.m, plan.dmax_cn
        channel = -llr.to(self.dtype)         # internal: positive = bit 0
        totals = channel
        c2v = torch.zeros(b, m, dc, dtype=self.dtype, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        iters = torch.full((b,), max_iters, dtype=torch.int32, device=dev)
        hard_latch = torch.zeros(b, plan.n, dtype=torch.bool, device=dev)
        soft_latch = torch.zeros_like(channel) if self.keep_soft else None
        final_hard, final_soft = hard_latch, soft_latch
        for it in range(max_iters + 1):
            t_cn = totals[:, t.var_idx]                      # [b, m, dc]
            hard_vn = totals < 0
            par = ((t_cn < 0) & t.cn_valid).sum(-1) % 2
            ok = ~par.bool().any(-1)
            newly = ok & ~done
            iters = iters.masked_fill(newly, it)
            hard_latch = torch.where(newly[:, None], hard_vn, hard_latch)
            final_hard = hard_vn
            if self.keep_soft:
                soft_latch = torch.where(newly[:, None], totals, soft_latch)
                final_soft = totals
            done = done | ok
            if bool(done.all()) or it == max_iters:
                break
            c2v = _check_node_update(t_cn - c2v, t.cn_valid, t.slot,
                                     self.kind, self.alpha, self.beta)
            msg = torch.where(t.vn_valid, c2v.reshape(b, -1)[:, t.msg_idx],
                              0.0).to(self.dtype)           # [b, n, dv]
            acc = torch.zeros_like(channel)
            for k in range(msg.shape[-1]):
                acc = acc + msg[..., k]
            totals = channel + acc
        hard = torch.where(done[:, None], hard_latch, final_hard)
        if self.keep_soft:
            soft = -torch.where(done[:, None], soft_latch, final_soft)
        else:
            soft = torch.zeros(b, 0, dtype=self.dtype, device=dev)
        return DecodeResult(hard=hard.to(torch.int8), iterations=iters,
                            success=done, soft=soft)


def make_decoder(plan: DecodePlan, max_iters: int = 50, *,
                 kind: str = "min-sum", alpha: float = 0.75,
                 beta: float = 0.15, dtype=torch.float32,
                 keep_soft: bool = False) -> _Decoder:
    """Build a batched decoder for a decode plan.

    Args:
      plan: static code structure (``DecodePlan.from_code``).
      max_iters: flooding iteration cap (reference default 50).
      kind: 'min-sum' (reference rule), 'normalized-min-sum',
        'offset-min-sum', or 'sum-product'.
      alpha/beta: scaling/offset of the normalized/offset variants.
      dtype: compute dtype (float32 default; bfloat16 for throughput).
      keep_soft: also return soft values (tests/analysis; costs memory).

    Returns ``decode_fn(llr[B, n]) -> DecodeResult`` on ``llr``'s device.
    """
    if kind not in _KINDS:
        raise ValueError(f"unknown decoder kind: {kind}")
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    a = float(alpha) if kind == "normalized-min-sum" else None
    b = float(beta) if kind == "offset-min-sum" else None
    return _Decoder(plan, int(max_iters), kind, a, b, dtype, bool(keep_soft))


_PLANS = BoundedCache(64)     # a code search mutates the code every step


def _plan_for_code(code: QCCode) -> DecodePlan:
    plan = _PLANS.get(code)
    if plan is None:
        plan = _PLANS[code] = DecodePlan.from_code(code)
    return plan


def decoder_for_code(code: QCCode, max_iters: int = 50, **kw) -> _Decoder:
    """QCCode -> decoder (the plan is built once per code)."""
    return make_decoder(_plan_for_code(code), max_iters, **kw)


def decode(code: QCCode, llr, max_iters: int = 50, *, device=None,
           **kw) -> DecodeResult:
    """One-shot decode of a [B, n] batch.  A tensor stays on its device;
    anything else goes to ``device`` (default: the card)."""
    if not isinstance(llr, torch.Tensor):
        llr = torch.as_tensor(np.asarray(llr, np.float32),
                              device=resolve_device(device))
    return decoder_for_code(code, max_iters, **kw)(llr)
