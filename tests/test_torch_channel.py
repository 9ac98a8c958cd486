"""The port's channel and statistics against the JAX package's.

The deterministic functions (sigma, BPSK, slicer, LLR scaling, the
statistics) are compared on the same numpy inputs.  The noise is compared
by its statistics only: Philox never draws JAX's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.sim import channel as jch
from ldpc_tpu.sim import stats as jstats
from ldpc_tpu_torch.sim import channel as ch
from ldpc_tpu_torch.sim import stats
from ldpc_tpu_torch.sim.evaluate import transmit

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

SNRS = np.array([0.0, 1.5, 3.0, 3.2, 3.4, 3.6, 6.0], np.float32)


def test_sigma_formula_equals_jax():
    got = ch.snr_db_to_sigma(torch.from_numpy(SNRS)).numpy()
    want = np.asarray(jch.snr_db_to_sigma(jnp.asarray(SNRS)))
    # float32 pow/sqrt may differ by one rounding between the libraries
    np.testing.assert_allclose(got, want, rtol=2e-7)
    scalar = ch.snr_db_to_sigma(3.4, device="cpu")
    np.testing.assert_allclose(float(scalar), np.sqrt(0.5 / 10 ** 0.34),
                               rtol=1e-6)


def test_modulate_and_slicer_equal_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(4, 64)).astype(np.int8)
    assert np.array_equal(ch.modulate(torch.from_numpy(bits)).numpy(),
                          np.asarray(jch.modulate(jnp.asarray(bits))))
    soft = rng.standard_normal((4, 64)).astype(np.float32)
    soft[0, :3] = 0.0
    assert np.array_equal(ch.slicer(torch.from_numpy(soft)).numpy(),
                          np.asarray(jch.slicer(jnp.asarray(soft))))


def test_llr_from_channel_equals_jax():
    rng = np.random.default_rng(1)
    noisy = rng.standard_normal((5, 128)).astype(np.float32)
    sigma = np.array([0.3, 0.5, 0.7, 0.9, 1.1], np.float32)
    got = ch.llr_from_channel(torch.from_numpy(noisy),
                              torch.from_numpy(sigma)).numpy()
    want = np.asarray(jch.llr_from_channel(jnp.asarray(noisy),
                                           jnp.asarray(sigma)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("snr", [3.0, 3.4])
def test_awgn_statistics(snr):
    """Noise mean 0 and variance sigma^2, realized sigma per word close to
    sigma: 256 words of n = 8176 samples each.  Tolerances are 6 standard
    errors of each statistic."""
    b, n = 256, 8176
    g = torch.Generator().manual_seed(5)
    noisy, sigma, sigma_actual = ch.transmit_zero_codeword(
        b, n, snr, generator=g, device="cpu")
    s = float(np.sqrt(0.5 / 10 ** (snr / 10)))
    assert noisy.shape == (b, n) and sigma.shape == (b,)
    assert sigma_actual.shape == (b,)
    np.testing.assert_allclose(sigma.numpy(), s, rtol=1e-6)
    noise = (noisy + 1.0).double()
    se_mean = s / np.sqrt(b * n)
    assert abs(float(noise.mean())) < 6 * se_mean
    se_var = s * s * np.sqrt(2.0 / (b * n))
    assert abs(float(noise.var()) - s * s) < 6 * se_var
    # per word, sigma_actual has standard deviation ~ sigma / sqrt(2n)
    sa = sigma_actual.double().numpy()
    assert abs(sa.mean() - s) < 6 * s / np.sqrt(2 * n * b)
    assert sa.std() < 2 * s / np.sqrt(2 * n)
    # the realized sigma is the RMS of the noise actually drawn
    np.testing.assert_allclose(
        sa, noise.pow(2).mean(-1).sqrt().numpy(), rtol=1e-5)
    # the JAX channel's realized sigma has the same distribution
    _, _, jsa = jch.transmit_zero_codeword(
        __import__("jax").random.key(5), b, n, snr)
    jsa = np.asarray(jsa, np.float64)
    assert abs(sa.mean() - jsa.mean()) < 8 * s / np.sqrt(2 * n * b)


def test_transmit_counts_uncoded_errors():
    g = torch.Generator().manual_seed(2)
    snr = torch.full((64,), 3.0)
    llr, sigma, sigma_actual, unc = transmit(1000, snr, generator=g)
    assert llr.shape == (64, 1000) and unc.dtype == torch.int32
    assert torch.equal(unc, (llr > 0).sum(-1, dtype=torch.int32))
    g2 = torch.Generator().manual_seed(2)
    llr2, *_ = transmit(1000, snr, generator=g2)
    assert torch.equal(llr, llr2)          # the generator fixes the noise


def _records(seed):
    rng = np.random.default_rng(seed)
    b = 200
    snr = np.repeat([3.0, 3.4], b // 2)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    sigma_actual = sigma * (1 + 0.01 * rng.standard_normal(b))
    unc = rng.integers(100, 200, b)
    errs = rng.integers(0, 3, b) * rng.integers(0, 2, b)
    iters = rng.integers(1, 51, b)
    success = rng.random(b) < 0.7
    return snr, sigma, sigma_actual, unc, errs, iters, 50, success


def test_statistics_equal_jax():
    port, ref = stats.BerStatistics(8176), jstats.BerStatistics(8176)
    for seed in (0, 1):
        rec = _records(seed)
        port.add_batch(*rec)
        ref.add_batch(*rec)
    assert port.summary() == ref.summary()
    for a, b in zip(port.get_stats_v2(), ref.get_stats_v2()):
        np.testing.assert_array_equal(a, b)
    assert len(port) == len(ref) == 400
    errs = _records(3)[4]
    assert stats.frame_ber_ci(errs, 8176) == jstats.frame_ber_ci(errs, 8176)
    for k, n in ((0, 0), (0, 100), (37, 100), (100, 100), (5, 131072)):
        assert stats.wilson_interval(k, n) == jstats.wilson_interval(k, n)
    np.testing.assert_array_equal(stats.snr_db_actual([0.5, 0.3]),
                                  jstats.snr_db_actual([0.5, 0.3]))


@pytest.mark.parametrize("flips", [(-1,), (0, -1), (9,), (3, 3), (-8,),
                                   (-9,), (8, -1, 2)])
def test_epsilon_probe_flip_indices_equal_jax(flips):
    """As JAX's .at[flips].multiply(-1.0), n = 8: an index in [-8, 0)
    counts from the end, one outside [-8, 8) is dropped, a bit listed twice
    is flipped twice."""
    got = ch.epsilon_probe(8, flips=flips, epsilon=0.01, device="cpu")
    want = np.asarray(jch.epsilon_probe(8, flips=flips, epsilon=0.01))
    assert np.array_equal(got.numpy(), want)


def test_epsilon_probe_without_flips():
    """No flip: JAX given an empty integer index flips nothing.  (Given
    the tuple () itself, JAX builds a float32 indexer and raises
    TypeError; the port reads () as no flip.)"""
    got = ch.epsilon_probe(8, flips=(), epsilon=0.01, device="cpu")
    want = np.asarray(jch.epsilon_probe(8, flips=np.zeros(0, np.int32),
                                        epsilon=0.01))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        jch.epsilon_probe(8, flips=(), epsilon=0.01)
