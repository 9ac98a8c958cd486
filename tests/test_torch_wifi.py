"""The port's IEEE 802.11n codes against the JAX package's, and the
flooding kernel's plain version (min-sum, bf16 and f32 state) against the
Pallas kernel on all four 802.11n rates.

The Pallas kernel runs in interpret mode on the CPU, on the same numpy
LLRs as the port.  The 802.11n checks have degrees 7 to 20, odd ones
among them, where near-earth's are all 32.  The contract is the kernel's:
equal on every word, converged or not, since both sides round at the same
points and sum in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import wifi as jax_wifi
from ldpc_tpu.ops.pallas_static import \
    make_static_sweep_decoder as jax_static_decoder
from ldpc_tpu_torch.codes import QCCode, wifi_code, wifi_rates
from ldpc_tpu_torch.codes import wifi
from ldpc_tpu_torch.ops.cuda_static import make_static_sweep_decoder
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

RATES = [1 / 2, 2 / 3, 3 / 4, 5 / 6]
# (low, high) SNR in dB per rate: the low one leaves words unconverged at
# 8 iterations, the high one converges most of them
SNRS = {1 / 2: (-1.5, -0.5), 2 / 3: (0.0, 1.0), 3 / 4: (1.0, 2.0),
        5 / 6: (2.5, 3.5)}


def _llrs(n, snrs, per, seed):
    """Raw BPSK samples of the all-zero word, ``per`` words per SNR, with a
    NaN and both infinities in the first words."""
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, 3] = np.nan
    llr[1, 11], llr[1, 12] = np.inf, -np.inf
    return llr


def _assert_same(port, ref):
    pe, pi, ps = (x.numpy() for x in port)
    re, ri, rs = (np.asarray(x) for x in ref)
    assert pe.dtype == np.int32 and pi.dtype == np.int32
    assert ps.dtype == np.bool_
    assert np.array_equal(ps, rs)
    assert np.array_equal(pe, re)
    assert np.array_equal(pi, ri)


@pytest.mark.parametrize("rate", RATES)
def test_wifi_code_equals_jax(rate):
    port, ref = wifi_code(1944, rate), jax_wifi.wifi_code(1944, rate)
    assert isinstance(port, QCCode)
    assert (port.z, port.shifts, port.name, port.message_size) == \
        (ref.z, ref.shifts, ref.name, ref.message_size)
    assert (port.n, port.k, port.num_edges) == (ref.n, ref.k, ref.num_edges)


def test_wifi_tables_and_rates_equal_jax():
    for name in ("WIFI_1944_81_RATE_1_2", "WIFI_1944_81_RATE_2_3",
                 "WIFI_1944_81_RATE_3_4", "WIFI_1944_81_RATE_5_6"):
        assert getattr(wifi, name) == getattr(jax_wifi, name)
    assert wifi_rates() == jax_wifi.wifi_rates() == RATES
    assert wifi_code() == wifi_code(1944, 5 / 6)
    with pytest.raises(ValueError):
        wifi_code(648, 1 / 2)


@pytest.mark.parametrize("rate", RATES)
def test_wifi_structure(rate):
    """The degrees the kernel has to handle: odd-degree, irregular rows."""
    plan = DecodePlan.from_code(wifi_code(1944, rate))
    deg = plan.cn_valid.sum(axis=1)
    assert plan.z == 81 and plan.block_cols == 24
    assert deg.max() == plan.dmax_cn <= 32
    assert (deg % 2 == 1).any()


@pytest.mark.parametrize("rate", RATES)
def test_plain_version_matches_pallas_wifi_bf16(rate):
    """B1 (min-sum, bf16 state) on every 802.11n rate, 8 iterations."""
    code = wifi_code(1944, rate)
    llr = _llrs(code.n, SNRS[rate], 4, seed=int(rate * 12))
    ref = jax_static_decoder(jax_wifi.wifi_code(1944, rate), max_iters=8,
                             tile_b=4, interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, device="cpu")(
        torch.from_numpy(llr))
    _assert_same(got, ref)
    assert not got[2].all()


@pytest.mark.parametrize("rate", [1 / 2, 5 / 6])
def test_plain_version_matches_pallas_wifi_f32(rate):
    """B1 with f32 state on rates 1/2 and 5/6, 10 iterations."""
    code = wifi_code(1944, rate)
    llr = _llrs(code.n, SNRS[rate], 4, seed=int(rate * 12) + 1)
    ref = jax_static_decoder(jax_wifi.wifi_code(1944, rate), max_iters=10,
                             tile_b=4, store_dtype=jnp.float32,
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 10, store_dtype="float32",
                                    device="cpu")(torch.from_numpy(llr))
    _assert_same(got, ref)
    assert got[2].any() and not got[2].all()
