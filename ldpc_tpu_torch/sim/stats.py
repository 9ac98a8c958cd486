"""BER/FER statistics: vectorized, mergeable Monte-Carlo records (numpy).

The port's own copy of ``ldpc_tpu.sim.stats``, whole: a checkpoint written
by either package loads in the other.

Reproduces the reference's ``berStatistics`` (``common.py:142-227``) with
a batched design: entries are stored as columnar numpy arrays (one
``add_batch`` call per decoded device batch instead of a Python list append
per transmission), aggregation is vectorized, and two merge operations match
the reference's distributed merge semantics (``union`` sorts, ``add``
concatenates — ``common.py:167-180``, used as the "all-reduce" by
``ldpc.py:458`` and ``ldpcCUDA.py:905``).

Each entry additionally carries a ``weight`` = number of codewords it
represents.  Per-word recording uses weight 1 (reference-equivalent); a
distributed counter path records one pre-reduced entry per (SNR point,
step) whose error/iteration fields are sums over the step's global batch
(``add_aggregate``), without ever materialising per-word host arrays.

Extra capabilities over the reference: frame-error rate (FER), and correct
average-iteration aggregation (the reference's ``getStatsV2`` has a no-op
statement bug at ``common.py:224`` — ``averageNumberOfIterations[index] +
...`` without assignment — so it always reports 0; we compute the real
mean).
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
    (common.py:150-157); weighted rows carry pre-reduced sums.
    """

    codeword_size: int = 8176
    _cols: dict = dataclasses.field(
        default_factory=lambda: {f: [] for f in _FIELDS})

    # --- recording ---------------------------------------------------------
    def add_entry(self, snr, sigma, sigma_actual, errors_uncoded,
                  errors_decoded, iterations, max_iterations, success):
        """Scalar per-word entry, reference-compatible (common.py:150)."""
        self.add_batch(
            np.atleast_1d(snr), np.atleast_1d(sigma),
            np.atleast_1d(sigma_actual), np.atleast_1d(errors_uncoded),
            np.atleast_1d(errors_decoded), np.atleast_1d(iterations),
            max_iterations, np.atleast_1d(success))

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

    def add_aggregate(self, snr, sigma, sigma_actual_mean, errors_uncoded,
                      errors_decoded, iterations_sum, max_iterations,
                      success_count, frame_errors, weight):
        """One pre-reduced entry for `weight` codewords (distributed path).

        All error/iteration arguments are sums over the represented words;
        ``sigma_actual_mean`` is their mean realized sigma.
        """
        self._append(
            snr=np.atleast_1d(np.float64(snr)),
            sigma=np.atleast_1d(np.float64(sigma)),
            sigma_actual=np.atleast_1d(np.float64(sigma_actual_mean)),
            errors_uncoded=np.atleast_1d(np.int64(errors_uncoded)),
            errors_decoded=np.atleast_1d(np.int64(errors_decoded)),
            iterations=np.atleast_1d(np.int64(iterations_sum)),
            max_iterations=np.atleast_1d(np.int64(max_iterations)),
            success=np.atleast_1d(np.int64(success_count)),
            frame_errors=np.atleast_1d(np.int64(frame_errors)),
            weight=np.atleast_1d(np.int64(weight)))

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

    @property
    def snr_points(self) -> np.ndarray:
        return np.unique(self.column("snr"))

    def raw(self) -> dict:
        """All columns as arrays (reference getRawStats, common.py:159)."""
        return {f: self.column(f) for f in _FIELDS}

    # --- merge (the reference's distributed reduction) ---------------------
    def union(self, rhs: "BerStatistics") -> "BerStatistics":
        """Merge + sort by (snr, realized snr) — common.py:167-172."""
        out = self.add(rhs)
        order = np.lexsort((out.column("snr_db_actual"), out.column("snr")))
        for f in _FIELDS:
            out._cols[f] = [out.column(f)[order]]
        return out

    def add(self, rhs: "BerStatistics") -> "BerStatistics":
        """Concatenate without sorting — common.py:174-180."""
        out = BerStatistics(self.codeword_size)
        for f in _FIELDS:
            out._cols[f] = list(self._cols[f]) + list(rhs._cols[f])
        return out

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

    def get_stats(self, codeword_size: int | None = None):
        """Deprecated 4-tuple wrapper kept for parity (common.py:162-165)."""
        (_, _, _, snr_axis, avg_snr_axis, ber_data,
         avg_iters) = self.get_stats_v2(codeword_size)
        return snr_axis, avg_snr_axis, ber_data, avg_iters

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

    # --- persistence (resumable sweeps; the reference has none,
    # SURVEY.md §5 checkpoint/resume) ----------------------------------
    def save(self, path) -> None:
        """Write all columns to an .npz for sweep checkpoint/resume."""
        np.savez(path, codeword_size=np.int64(self.codeword_size),
                 **{f: self.column(f) for f in _FIELDS})

    @staticmethod
    def load(path) -> "BerStatistics":
        with np.load(path) as data:
            out = BerStatistics(int(data["codeword_size"]))
            for f in _FIELDS:
                out._cols[f] = [np.asarray(data[f])]
        return out

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
