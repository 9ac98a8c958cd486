"""BER/FER statistics: columnar Monte-Carlo records (numpy).

A trimmed copy of ``ldpc_tpu.sim.stats``: per-word entries recorded one
device batch at a time, aggregated per SNR point into BER, FER and average
iterations, with the frame-clustered BER interval and the Wilson interval
for FER.  The merge, aggregate-entry and save/load parts of the JAX module
wait for the port's distributed and checkpoint paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BerStatistics", "snr_db_actual", "frame_ber_ci",
           "wilson_interval"]

# Column semantics (per entry of weight w):
#   snr             nominal SNR dB of the entry
#   snr_db_actual   realized SNR dB (weighted mean over the w words)
#   sigma           nominal noise sigma
#   sigma_actual    realized sigma (weighted mean)
#   errors_uncoded  SUM of uncoded bit errors over the w words
#   errors_decoded  SUM of decoded bit errors
#   iterations      SUM of decoder iterations
#   max_iterations  iteration cap
#   success         COUNT of converged words
#   frame_errors    COUNT of frame errors (wrong word or not converged)
#   weight          number of words represented
_FIELDS = ("snr", "snr_db_actual", "sigma", "sigma_actual", "errors_uncoded",
           "errors_decoded", "iterations", "max_iterations", "success",
           "frame_errors", "weight")


def snr_db_actual(sigma_actual) -> np.ndarray:
    """Realized SNR in dB from realized noise RMS (common.py:152-155)."""
    sigma_actual = np.asarray(sigma_actual, np.float64)
    return 10.0 * np.log10(1.0 / (2.0 * sigma_actual ** 2))


def frame_ber_ci(frame_errors, n_bits: int, zcrit: float = 1.96):
    """Frame-clustered BER mean and 95% CI halfwidth.

    ``frame_errors``: per-word decoded bit-error counts.  Bit errors
    cluster within frames, so the honest CI treats frames (not bits) as
    the independent samples — the convention of every measured artifact
    in docs/ (ber_parity, random_codeword, discovered_code).
    """
    errs = np.asarray(frame_errors, np.float64)
    b = errs.shape[0]
    ber = errs.mean() / n_bits
    half = zcrit * errs.std(ddof=1) / np.sqrt(b) / n_bits
    return float(ber), float(half)


def wilson_interval(k: int, n: int, zcrit: float = 1.96):
    """Wilson score interval for a binomial proportion: (p, lo, hi)."""
    if n == 0:
        return 0.0, 0.0, 1.0
    p = k / n
    z2 = zcrit * zcrit
    den = 1 + z2 / n
    centre = (p + z2 / (2 * n)) / den
    half = zcrit * np.sqrt(p * (1 - p) / n + z2 / (4 * n * n)) / den
    return float(p), float(max(0.0, centre - half)), \
        float(min(1.0, centre + half))


@dataclasses.dataclass
class BerStatistics:
    """Columnar per-transmission Monte-Carlo records + aggregation.

    Per-word rows carry the 9-tuple of ``berStatistics.addEntry``
    (common.py:150-157).
    """

    codeword_size: int = 8176
    _cols: dict = dataclasses.field(
        default_factory=lambda: {f: [] for f in _FIELDS})

    # --- recording ---------------------------------------------------------
    def add_batch(self, snr, sigma, sigma_actual, errors_uncoded,
                  errors_decoded, iterations, max_iterations, success):
        """Vectorized per-word entries: one call per decoded batch."""
        snr = np.asarray(snr, np.float64)
        b = snr.shape[0]
        errors_decoded = np.asarray(errors_decoded, np.int64)
        success = np.asarray(success, bool)
        frame_errors = ((errors_decoded > 0) | ~success).astype(np.int64)
        self._append(
            snr=snr,
            sigma=np.broadcast_to(np.asarray(sigma, np.float64), (b,)),
            sigma_actual=np.asarray(sigma_actual, np.float64),
            errors_uncoded=np.asarray(errors_uncoded, np.int64),
            errors_decoded=errors_decoded,
            iterations=np.asarray(iterations, np.int64),
            max_iterations=np.broadcast_to(
                np.asarray(max_iterations, np.int64), (b,)),
            success=success.astype(np.int64),
            frame_errors=frame_errors,
            weight=np.ones(b, np.int64))

    def _append(self, **kw):
        if (np.asarray(kw["sigma_actual"]) == 0).any():
            raise ValueError("sigma_actual == 0 (reference asserts too)")
        kw["snr_db_actual"] = snr_db_actual(kw["sigma_actual"])
        for f in _FIELDS:
            self._cols[f].append(np.atleast_1d(kw[f]).copy())

    # --- access ------------------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        chunks = self._cols[name]
        if not chunks:
            return np.zeros(0)
        return np.concatenate(chunks)

    def __len__(self) -> int:
        """Number of codewords represented (not number of rows)."""
        return int(self.column("weight").sum())

    # --- aggregation -------------------------------------------------------
    def get_stats_v2(self, codeword_size: int | None = None):
        """Reference-compatible 7-tuple (common.py:196-226).

        Returns (scatterSNR, scatterBER, scatterITR, snrAxis,
        averageSnrAxis, berData, averageNumberOfIterations); scatter arrays
        have one point per recorded row (per transmission when recording
        per-word; per reduced step otherwise).
        """
        n = codeword_size or self.codeword_size
        snr = self.column("snr")
        actual = self.column("snr_db_actual")
        errs = self.column("errors_decoded").astype(np.float64)
        iters = self.column("iterations").astype(np.float64)
        w = self.column("weight").astype(np.float64)

        scatter_snr = actual
        scatter_ber = errs / (w * n)
        scatter_itr = iters / w

        snr_axis = np.unique(snr)
        idx = np.searchsorted(snr_axis, snr)
        k = len(snr_axis)
        count = np.bincount(idx, w, k)
        avg_snr_axis = np.bincount(idx, actual * w, k) / count
        ber_data = np.bincount(idx, errs, k) / (count * n)
        avg_iters = np.bincount(idx, iters, k) / count
        return (scatter_snr, scatter_ber, scatter_itr, snr_axis,
                avg_snr_axis, ber_data, avg_iters)

    def frame_error_rate(self):
        """Per-SNR-point FER — new capability (reference counts bits only)."""
        snr = self.column("snr")
        snr_axis = np.unique(snr)
        idx = np.searchsorted(snr_axis, snr)
        k = len(snr_axis)
        count = np.bincount(idx, self.column("weight").astype(np.float64), k)
        fer = np.bincount(
            idx, self.column("frame_errors").astype(np.float64), k) / count
        return snr_axis, fer

    def summary(self) -> dict:
        """Aggregate dict used by loggers and the bench harness."""
        (_, _, _, snr_axis, avg_snr, ber, avg_itr) = self.get_stats_v2()
        _, fer = self.frame_error_rate()
        return {
            "snr_db": snr_axis.tolist(),
            "snr_db_actual": avg_snr.tolist(),
            "ber": ber.tolist(),
            "fer": fer.tolist(),
            "avg_iterations": avg_itr.tolist(),
            "transmissions": int(len(self)),
            "codeword_size": self.codeword_size,
        }
