"""The port's reward fits (``sim/reward.py``) against the JAX package's on
seeded BER scatters, to 1e-12: the recursive line fit, the hinge, its
curve fit and ``calc_reward``, including the fewer-than-2-points branch and
the all-BER-zero break."""

import numpy as np
import pytest

from ldpc_tpu.sim import reward as jrew
from ldpc_tpu_torch.sim import reward as trew

TOL = dict(rtol=1e-12, atol=1e-12)


def _scatter(seed, n=30, zero_share=0.0):
    rng = np.random.default_rng(seed)
    snr = np.sort(rng.uniform(2.9, 3.5, n))
    ber = np.clip(0.16 - 0.049 * snr + rng.normal(0, 0.004, n), 0, None)
    ber[rng.random(n) < zero_share] = 0.0
    return snr, ber


@pytest.mark.parametrize("seed,zeros", [(0, 0.0), (1, 0.3), (2, 0.7),
                                        (3, 0.9)])
def test_recursive_linear_fit_matches_jax(seed, zeros):
    snr, ber = _scatter(seed, zero_share=zeros)
    got = trew.recursive_linear_fit(snr, ber)
    want = jrew.recursive_linear_fit(snr, ber)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[3].coeffs, want[3].coeffs, **TOL)
    assert got[4] == want[4]


def test_all_zero_ber_breaks_at_the_first_round():
    snr = np.linspace(3.0, 3.4, 12)
    ber = np.zeros(12)
    got = trew.recursive_linear_fit(snr, ber)
    want = jrew.recursive_linear_fit(snr, ber)
    assert got[4] == want[4] == 1          # the break, not 10 rounds
    np.testing.assert_array_equal(got[0], snr)
    assert trew.calc_reward(snr, ber, (3.0, 3.4)) == \
        jrew.calc_reward(snr, ber, (3.0, 3.4))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("points", [(3.0, 3.2, 3.4), (3.0, 3.8)])
def test_calc_reward_matches_jax(seed, points):
    snr, ber = _scatter(seed, zero_share=0.2 * seed)
    got = trew.calc_reward(snr, ber, points)
    want = jrew.calc_reward(snr, ber, points)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [0, 1])
def test_fewer_than_two_points_is_a_bad_candidate(n):
    snr, ber = np.full(n, 3.0), np.full(n, 0.01)
    assert trew.calc_reward(snr, ber, (3.0, 3.4)) == \
        jrew.calc_reward(snr, ber, (3.0, 3.4)) == \
        trew.BAD_CANDIDATE_REWARD == jrew.BAD_CANDIDATE_REWARD == -2.0
    assert trew.calc_reward(snr, ber, (3.0, 3.4),
                            bad_candidate_reward=-7.0) == -7.0


def test_piecewise_fit_matches_jax():
    rng = np.random.default_rng(9)
    snr = np.linspace(2.8, 3.8, 40)
    ber = np.asarray(trew.piecewise_linear(snr, -0.05, 0.17, 3.4)) + \
        rng.normal(0, 1e-3, 40)
    np.testing.assert_allclose(trew.piecewise_linear(snr, -0.05, 0.17, 3.4),
                               jrew.piecewise_linear(snr, -0.05, 0.17, 3.4),
                               **TOL)
    got, gcov = trew.piecewise_fit(snr, ber)
    want, wcov = jrew.piecewise_fit(snr, ber)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(gcov, wcov, **TOL)
