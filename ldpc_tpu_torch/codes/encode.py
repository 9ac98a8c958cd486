"""Systematic encoding: c = [m | m . A] mod 2 (G = [I | A]).

The port of ``ldpc_tpu.codes.encode``.  The reference's encoder is
vestigial (``codeword = G.dot(message) % 2`` only when a generator is
supplied, ``ldpc.py:409-414``); here encoding is a batched op whose parity
block is one ``torch.matmul`` ``[B, k] x [k, n - k]`` in float32 followed by
``% 2``, as the JAX package computes it with ``jnp.dot`` outside any kernel.

Exactness: a row sum is at most k (7,154 for near-earth), exact in a
float32 accumulator; TF32 rounds only the 0/1 inputs, which it represents
exactly, so it keeps the sums exact too.  A half-precision product would
not, so the product always runs with autocast off.

``encoder_for_code`` knows the shipped CCSDS generator; any other code
derives its parity part from H over GF(2) (numpy, on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import BoundedCache
from ..utils.device import resolve_device
from .ccsds import K, near_earth_code, near_earth_generator_dense
from .qc import QCCode

__all__ = ["make_encoder", "encoder_for_code", "encode",
           "parity_part_from_h", "systematic_encoder_from_h"]


def parity_part_from_h(h: np.ndarray) -> np.ndarray:
    """Derive the systematic parity part A [k, m] from a dense H [m, n].

    Splits H = [H1 | H2] (information | parity columns), inverts H2 over
    GF(2) and returns A = (H2^-1 H1)^T so that ``c = [msg | msg . A]``
    satisfies ``H c^T = 0``.  Raises ValueError when H2 is singular (e.g.
    the 802.11n dual-diagonal family is encodable this way).
    """
    h = np.asarray(h, np.uint8) & 1
    m, n = h.shape
    k = n - m
    h1, h2 = h[:, :k].copy(), h[:, k:].copy()
    # Gauss-Jordan over GF(2): reduce [H2 | H1] -> [I | H2^-1 H1]
    aug = np.concatenate([h2, h1], axis=1)
    for col in range(m):
        piv_rows = np.nonzero(aug[col:, col])[0]
        if piv_rows.size == 0:
            raise ValueError(f"parity part singular at column {col}")
        piv = col + int(piv_rows[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        elim = np.nonzero(aug[:, col])[0]
        elim = elim[elim != col]
        aug[elim] ^= aug[col]
    return np.ascontiguousarray(aug[:, m:].T)


class _Encoder:
    """``encoder(messages[B, k_eff]) -> codewords[B, n]`` int8 on the
    messages' device.  ``info_positions`` / ``parity_positions`` say where
    the message and parity bits go (the message prefix and the rest for
    :func:`make_encoder`)."""

    def __init__(self, mt: np.ndarray, n: int, info: np.ndarray,
                 pivots: np.ndarray):
        self.k_eff = int(mt.shape[0])
        self.n = int(n)
        self.info_positions = info
        self.parity_positions = pivots
        self._mt = torch.from_numpy(np.asarray(mt, np.float32))
        self._on: dict = {}

    def _tables(self, dev: torch.device):
        t = self._on.get(dev)
        if t is None:
            t = self._on[dev] = (
                self._mt.to(dev),
                torch.as_tensor(self.info_positions, device=dev),
                torch.as_tensor(self.parity_positions, device=dev))
        return t

    def __call__(self, messages) -> torch.Tensor:
        if not isinstance(messages, torch.Tensor):
            messages = torch.as_tensor(np.asarray(messages),
                                       device=resolve_device(None))
        mt, info, piv = self._tables(messages.device)
        msgs = messages.to(torch.float32)
        with torch.autocast(messages.device.type, enabled=False):
            parity = torch.remainder(torch.matmul(msgs, mt), 2.0)
        cw = torch.zeros(msgs.shape[0], self.n, dtype=torch.int8,
                         device=messages.device)
        cw[:, info] = msgs.to(torch.int8)
        cw[:, piv] = parity.to(torch.int8)
        return cw


def make_encoder(a_dense: np.ndarray) -> _Encoder:
    """Systematic encoder from the dense parity part A [k, n - k]:
    ``encode(messages[B, k]) -> codewords[B, n]`` int8, carrying
    ``k_eff`` (the message bits it consumes)."""
    k, m = a_dense.shape
    return _Encoder(a_dense, k + m, np.arange(k), np.arange(k, k + m))


def systematic_encoder_from_h(h: np.ndarray) -> _Encoder:
    """General systematic encoder for ANY dense parity matrix H [m, n].

    Row-reduces H over GF(2) with COLUMN pivoting, so it works where
    :func:`parity_part_from_h` cannot: the pivot columns become the parity
    positions and the remaining ``n - rank`` columns carry the message.
    Rank-deficient H (redundant checks: dense near-earth H has GF(2) rank
    1020 of 1022) is handled by dropping the dependent rows:
    ``k_eff = n - rank``.

    Returns ``encode(messages[B, k_eff]) -> codewords[B, n]`` int8 carrying
    ``k_eff``, ``info_positions`` and ``parity_positions``.
    """
    h = np.asarray(h, np.uint8) & 1
    m, n = h.shape
    hb = h.copy()
    pivots = []
    r = 0
    for c in range(n):
        piv = np.nonzero(hb[r:, c])[0]
        if piv.size == 0:
            continue
        p = r + int(piv[0])
        if p != r:
            hb[[r, p]] = hb[[p, r]]
        elim = np.nonzero(hb[:, c])[0]
        elim = elim[elim != r]
        hb[elim] ^= hb[r]
        pivots.append(c)
        r += 1
        if r == m:
            break
    rank = r
    if rank == 0:
        raise ValueError("H has rank 0 — nothing to encode against")
    pivots = np.asarray(pivots, np.int64)
    info = np.setdiff1d(np.arange(n), pivots)
    # reduced row r reads: c[pivots[r]] + sum_j M[r, j] * c[info[j]] = 0
    return _Encoder(hb[:rank][:, info].T, n, info, pivots)


_ENCODERS = BoundedCache(8)


def encoder_for_code(code: QCCode) -> _Encoder:
    """Encoder for ANY code.

    Near-earth (recognised by its shifts) uses the shipped CCSDS generator;
    other codes derive the parity part from H over GF(2): first the
    message-prefix layout (:func:`parity_part_from_h`), and when that
    parity square is singular, the column-pivoted encoder
    (:func:`systematic_encoder_from_h`).  The encoder's ``k_eff`` may
    differ from ``code.k`` for rank-deficient H.
    """
    enc = _ENCODERS.get(code)
    if enc is not None:
        return enc
    if code.shifts == near_earth_code().shifts:
        enc = make_encoder(near_earth_generator_dense()[:, K:])
    else:
        h = code.to_dense()
        try:
            enc = make_encoder(parity_part_from_h(h))
        except ValueError:
            enc = systematic_encoder_from_h(h)
    _ENCODERS[code] = enc
    return enc


def encode(code: QCCode, messages, *, device=None) -> torch.Tensor:
    """One-shot systematic encode of a batch.  A tensor stays on its device;
    anything else goes to ``device`` (default: the card)."""
    if not isinstance(messages, torch.Tensor):
        messages = torch.as_tensor(np.asarray(messages),
                                   device=resolve_device(device))
    return encoder_for_code(code)(messages)
