"""NumPy golden oracle: dense flooding min-sum with reference semantics.

The port's own copy of ``ldpc_tpu.ops.oracle`` (numpy only).

This is the differential-testing anchor demanded by SURVEY.md §4: a slow,
obviously-correct float64 implementation of exactly the update rule of the
reference CPU decoder (``ldpc.py:75-337``), written against dense H:

* VN -> CN messages: total minus the CN's previous outgoing value
  (extrinsic subtraction, ``checkNode.receive``, ldpc.py:150-163).
* CN update: sign = product of signs (sign(0) = +1, ldpc.py:135-141);
  magnitudes = |incoming|; two smallest located; every edge gets
  ``smallest * sign * own_sign`` except the argmin edge which gets
  ``secondSmallest * ...`` (ldpc.py:174-202).
* VN update: sum of incoming CN messages plus the channel value
  (ldpc.py:313-324).
* Loop: initial syndrome check on the channel word, then iterate while not
  a codeword, up to max_iters; returns hard decisions, soft vector and the
  iteration count (ldpc.py:326-337).

It is pure numpy (no numba, no JAX) and used only in tests and as a
cross-check for the port's decoders.

Convention note: like the port's decoders (see ``decoder.py`` docstring), BP
runs internally with negated values so the sign-product rule is correct
for odd-degree checks too; for the reference's own (even-degree) near-earth
code this is exactly equivalent to the reference rule — every message is
simply negated — so trajectories still match ``ldpc.py`` bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dense_min_sum_decode", "syndrome_ok"]


def syndrome_ok(h: np.ndarray, hard: np.ndarray) -> bool:
    """H . x mod 2 == 0 (ldpc.py:249-268)."""
    return not (h.astype(np.int64) @ hard.astype(np.int64) % 2).any()


def dense_min_sum_decode(h: np.ndarray, channel: np.ndarray,
                         max_iters: int = 50,
                         dtype=np.float64):
    """Decode one word. Returns (hard, soft, iterations, success)."""
    h = np.asarray(h)
    m, n = h.shape
    # negate on entry: internal positive <=> bit 0 (see module docstring)
    channel = -np.asarray(channel, dtype)
    rows = [np.flatnonzero(h[i]) for i in range(m)]

    hard = (channel < 0).astype(np.int64)
    if syndrome_ok(h, hard):
        return hard, -channel, 0, True

    # c2v[i] holds check node i's previous outgoing values (aligned with
    # rows[i]); starts at zero like checkNode.outgoingValues (ldpc.py:121).
    c2v = [np.zeros(len(r), dtype) for r in rows]
    totals = channel.copy()

    for it in range(1, max_iters + 1):
        new_totals = channel.copy()
        for i, r in enumerate(rows):
            if len(r) == 0:
                continue
            incoming = totals[r] - c2v[i]
            sgn = np.where(incoming < 0, -1.0, 1.0)
            sign = np.prod(sgn)
            mag = np.abs(incoming)
            order = np.argsort(mag, kind="stable")
            m0 = order[0]
            # degree-1 checks have no extrinsic neighbours; the "second
            # smallest" saturates to finfo.max, matching the JAX decoder's
            # two-min init (decoder.py finfo-max fill) and the native
            # engine's numeric_limits<double>::max().
            m1mag = mag[order[1]] if len(r) > 1 else np.finfo(dtype).max
            out = mag[m0] * sign * sgn
            out[m0] = m1mag * sign * sgn[m0]
            c2v[i] = out
            new_totals[r] += out
        totals = new_totals
        hard = (totals < 0).astype(np.int64)
        if syndrome_ok(h, hard):
            return hard, -totals, it, True
    return hard, -totals, max_iters, False
