"""Staged Monte-Carlo decode: the port of the main path of
``ldpc_tpu.sim.evaluate`` (``make_staged_sweep_device``).

A batch is decoded with a small iteration budget first; the words that did
not converge are decoded again from scratch with the full budget.  Latching
makes each word's (errors, iterations, success) equal to those of one
straight ``max_iters`` decode, while most words pay only the first budget.

Two JAX constructs have no counterpart in PyTorch and are replaced:

* ``lax.cond(nfail <= cap, few, many)`` becomes one host-side branch on the
  number of failures (one device-to-host read per stage);
* the fixed-size redo chunk whose padding is scattered to an out-of-range
  index with ``mode="drop"`` becomes a gather of exactly the failed rows
  (ascending index, the order of the JAX stable sort) and a write back of
  only those rows.  A kernel with one block per word needs no tile padding.

"few" and "many" decode the same words the same way, so the branch changes
only the cost, never the result.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..codes.qc import QCCode
from ..ops.cuda_static import make_static_sweep_decoder
from ..utils.device import resolve_device
from .channel import awgn

__all__ = ["default_redo_capacity", "make_staged_decoder_device",
           "make_staged_sweep_device", "staged_decode_counts"]


def default_redo_capacity(b: int) -> int:
    """max(128, 3B/16) rounded up to a multiple of 128, at most B — the
    capacity of the JAX bench's cascade (bench.py, 128-word tiles)."""
    c = max(128, 3 * b // 16)
    return min(-(-c // 128) * 128, b)


class StagedDecoder:
    """``decoder(llr[B, n]) -> (errors, iterations, success)`` of a cascade
    ``phase1_iters`` -> ``max_iters``.  ``last_branches`` records, for the
    last call, each re-decode stage's branch: "few" (only the failures),
    "many" (the whole batch) or "none" (nothing failed)."""

    def __init__(self, code: QCCode, max_iters: int = 50, *,
                 phase1_iters: int | Sequence[int] = 12,
                 redo_capacity: int | Sequence[int] | None = None,
                 device=None):
        phases = ([int(phase1_iters)] if isinstance(phase1_iters, int)
                  else [int(p) for p in phase1_iters])
        if sorted(phases) != phases or (phases and phases[-1] >= max_iters):
            raise ValueError(f"phase iteration budgets must ascend below "
                             f"max_iters: {phases} vs {max_iters}")
        caps = (list(redo_capacity)
                if isinstance(redo_capacity, (list, tuple))
                else [redo_capacity] * len(phases))
        if len(caps) != len(phases):
            raise ValueError("redo_capacity needs one entry per re-decode "
                             "stage")
        self.caps = caps
        self.device = resolve_device(device)
        self.decoders = [make_static_sweep_decoder(code, it,
                                                   device=self.device)
                         for it in phases + [max_iters]]
        self.last_branches: list[str] = []

    def capacities(self, b: int) -> list[int]:
        """Each stage's redo capacity for a batch of ``b`` words: an explicit
        value as given (at most B), else ``default_redo_capacity(b)``."""
        return [default_redo_capacity(b) if c is None else min(int(c), b)
                for c in self.caps]

    def __call__(self, llr: torch.Tensor):
        errors, iters, success = self.decoders[0](llr)
        branches = []
        for decode, cap in zip(self.decoders[1:],
                               self.capacities(llr.shape[0])):
            failed = torch.nonzero(~success).squeeze(1)
            nfail = failed.numel()
            if nfail == 0:
                branches.append("none")
            elif nfail <= cap:
                e2, it2, ok2 = decode(llr.index_select(0, failed))
                errors = errors.index_copy(0, failed, e2)
                iters = iters.index_copy(0, failed, it2)
                success = success.index_copy(0, failed, ok2)
                branches.append("few")
            else:
                e2, it2, ok2 = decode(llr)
                errors = torch.where(success, errors, e2)
                iters = torch.where(success, iters, it2)
                success = success | ok2
                branches.append("many")
        self.last_branches = branches
        return errors, iters, success


def make_staged_decoder_device(code: QCCode, max_iters: int = 50, *,
                               phase1_iters: int | Sequence[int] = 12,
                               redo_capacity=None, device=None):
    """The staged decoder on ``device`` (default: the card); see
    :class:`StagedDecoder`."""
    return StagedDecoder(code, max_iters, phase1_iters=phase1_iters,
                         redo_capacity=redo_capacity, device=device)


def staged_decode_counts(code: QCCode, llr: torch.Tensor,
                         max_iters: int = 50, *,
                         phase1_iters: int | Sequence[int] = 12,
                         redo_capacity=None):
    """One-shot staged decode on ``llr``'s device; numpy outputs."""
    dec = StagedDecoder(code, max_iters, phase1_iters=phase1_iters,
                        redo_capacity=redo_capacity, device=llr.device)
    return tuple(x.cpu().numpy() for x in dec(llr))


def transmit(n: int, snr_db: torch.Tensor, *,
             generator: torch.Generator | None = None):
    """All-zero codeword of length ``n`` per entry of ``snr_db[B]``:
    (llr, sigma, sigma_actual, uncoded bit errors).  The LLRs are the raw
    noisy samples, as min-sum takes them (it is scale-invariant)."""
    clean = torch.full((snr_db.shape[0], n), -1.0, dtype=torch.float32,
                       device=snr_db.device)
    noisy, sigma, sigma_actual = awgn(clean, snr_db, generator=generator)
    unc = (noisy > 0).sum(-1, dtype=torch.int32)
    return noisy, sigma, sigma_actual, unc


class StagedSweep:
    """``step(snr_db[B]) -> dict`` of one Monte-Carlo batch: transmit the
    all-zero codeword through BPSK + AWGN, staged-decode, count.  The keys
    are those of the JAX step: errors_uncoded, errors_decoded, iterations,
    success, sigma, sigma_actual (each [B], on the device)."""

    def __init__(self, code: QCCode, max_iters: int = 50, *, device=None,
                 generator: torch.Generator | None = None, **staged_kw):
        self.decoder = StagedDecoder(code, max_iters, device=device,
                                     **staged_kw)
        self.n = code.n
        self.generator = generator

    def __call__(self, snr_db) -> dict:
        snr_db = torch.as_tensor(snr_db, dtype=torch.float32,
                                 device=self.decoder.device)
        llr, sigma, sigma_actual, unc = transmit(self.n, snr_db,
                                                 generator=self.generator)
        errors, iters, success = self.decoder(llr)
        return {
            "errors_uncoded": unc,
            "errors_decoded": errors,
            "iterations": iters,
            "success": success,
            "sigma": sigma,
            "sigma_actual": sigma_actual,
        }


def make_staged_sweep_device(code: QCCode, max_iters: int = 50, *,
                             device=None,
                             generator: torch.Generator | None = None,
                             **staged_kw):
    """Transmit + staged decode on ``device`` (default: the card), noise
    from ``generator``; see :class:`StagedSweep`.  Accepts every
    :func:`make_staged_decoder_device` keyword."""
    return StagedSweep(code, max_iters, device=device, generator=generator,
                       **staged_kw)
