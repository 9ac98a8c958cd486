"""Reward shaping: BER-vs-SNR line fits and the code-search reward (numpy/
scipy; copy of ``ldpc_tpu.sim.reward``, line for line).

Reproduces the reference reward pipeline exactly:

* ``recursive_linear_fit`` — iteratively refit a degree-1 polynomial to the
  (realized SNR, per-transmission BER) scatter, each round dropping points
  where the fitted trend is <= 0 (``common.py:293-303``, 10 rounds).
* ``piecewise_fit`` — hinge fit used for plots (``common.py:285-291``).
* ``calc_reward`` — area between the constant 1 and the fitted line over
  the SNR sweep range: ``∫(1 - p)`` from SNRpoints[0] to SNRpoints[-1]
  (``ldpc_env.py:319-345``); fewer than 2 scatter points yields the
  bad-candidate reward (reference default -2.0, ``ldpc_env.py:120``).

Reference reward baselines for near-earth (postProcessing.py:18-19):
0.7958451612664468 over 3.0-3.8 dB and 0.3965108116285836 over 3.0-3.4 dB.
"""

from __future__ import annotations

import numpy as np

__all__ = ["recursive_linear_fit", "piecewise_fit", "piecewise_linear",
           "calc_reward", "BAD_CANDIDATE_REWARD"]

BAD_CANDIDATE_REWARD = -2.0   # ldpc_env.py:120 rewardForBadCandidate


def recursive_linear_fit(x, y, iterations: int = 10):
    """Iteratively refit y ~ p1(x) dropping points with fitted value <= 0.

    Matches ``common.recursiveLinearFit`` (common.py:293-303): each of
    ``iterations`` rounds fits a line with np.polyfit and keeps only the
    points where the trend evaluates > 0.  Returns (x_kept, y_kept,
    coeffs, poly1d, rounds).
    """
    x = np.asarray(x, np.float64).copy()
    y = np.asarray(y, np.float64).copy()
    p = np.polyfit(x, y, 1)
    trend = np.poly1d(p)
    for it in range(iterations):
        p = np.polyfit(x, y, 1)
        trend = np.poly1d(p)
        keep = trend(x) > 0
        if keep.sum() < 2:
            # All points below trend (e.g. every BER is 0 — perfect code at
            # these SNRs).  The reference crashes here on an empty polyfit;
            # we keep the last valid fit instead.
            break
        x, y = x[keep], y[keep]
    return x, y, p, trend, it + 1


def piecewise_linear(x, slope0, bias0, cutoff):
    """Hinge: slope0*x + bias0 below cutoff, 0 above (common.py:285-286)."""
    x = np.asarray(x, np.float64)
    return np.where(x < cutoff, slope0 * x + bias0, 0.0)


def piecewise_fit(snr, ber, p0=(-0.049, 0.16, 3.4)):
    """curve_fit of the hinge (common.py:288-291)."""
    from scipy.optimize import curve_fit
    params, cov = curve_fit(piecewise_linear, np.asarray(snr, np.float64),
                            np.asarray(ber, np.float64), p0=list(p0))
    return params, cov


def calc_reward(scatter_snr, scatter_ber, snr_points,
                bad_candidate_reward: float = BAD_CANDIDATE_REWARD) -> float:
    """Code-search reward: ∫(1 - fitted line) over the sweep SNR range.

    Matches ``LdpcEnv.calcReward`` (ldpc_env.py:319-345): fit the scatter
    with ``recursive_linear_fit``, integrate (1 - p1) between the first and
    last nominal SNR points.
    """
    scatter_snr = np.asarray(scatter_snr, np.float64)
    scatter_ber = np.asarray(scatter_ber, np.float64)
    if scatter_ber.size < 2:
        return float(bad_candidate_reward)
    _, _, p, trend, _ = recursive_linear_fit(scatter_snr, scatter_ber)
    p_const = np.poly1d([1.0])
    integ = (p_const - trend).integ()
    snr_points = np.asarray(snr_points, np.float64)
    return float(integ(snr_points[-1]) - integ(snr_points[0]))
