"""The torch engine (``ldpc_tpu_torch.ops.decoder``, the counterpart of the
JAX package's XLA engine) against JAX ``decode`` and against the port's
float64 oracle.

Same numpy LLRs on both sides.  The min-sum family sums in the JAX
module's order and matches it word for word, soft values included;
sum-product goes through another library's tanh/log and is held
statistically, as in the JAX package's own tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.ops import oracle as jax_oracle
from ldpc_tpu.ops.decoder import decode as jax_decode
from ldpc_tpu_torch.codes import QCCode, near_earth_code, wifi_code
from ldpc_tpu_torch.ops import oracle
from ldpc_tpu_torch.ops.decoder import decode, decoder_for_code, make_decoder
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.sim.channel import epsilon_probe

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

KINDS = ["min-sum", "normalized-min-sum", "offset-min-sum", "sum-product"]
# (low, high) SNR per (rate, sum-product): in each one's waterfall
SNRS = {(1 / 2, False): (-1.75, -0.5), (1 / 2, True): (-2.5, -1.5),
        (5 / 6, False): (2.0, 3.5), (5 / 6, True): (2.0, 3.0)}


def _llrs(n, snrs, per, seed, true_llr=False):
    rng = np.random.default_rng(seed)
    rows = []
    for s in snrs:
        sigma = np.sqrt(0.5 / 10 ** (s / 10))
        y = -1.0 + sigma * rng.standard_normal((per, n))
        rows.append(2.0 * y / sigma ** 2 if true_llr else y)
    return np.concatenate(rows).astype(np.float32)


def toy_code():
    """The irregular z = 5 code of tests/test_decoder.py."""
    return QCCode(z=5, shifts=(((0, 2), (1,), (3,)), ((4,), (), (0, 1))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rate", [1 / 2, 5 / 6])
def test_torch_engine_matches_jax_decode(rate, kind):
    code = wifi_code(1944, rate)
    sp = kind == "sum-product"
    llr = _llrs(code.n, SNRS[(rate, sp)], 6, seed=len(kind), true_llr=sp)
    ref = jax_decode(jax_wifi_code(1944, rate), jnp.asarray(llr), 20,
                     kind=kind, keep_soft=True)
    got = decode(code, torch.from_numpy(llr), 20, kind=kind, keep_soft=True)
    r_ok, g_ok = np.asarray(ref.success), got.success.numpy()
    r_hard, g_hard = np.asarray(ref.hard), got.hard.numpy()
    assert got.hard.dtype == torch.int8 and got.soft.shape == (12, code.n)
    if not sp:
        # converged words exactly; in fact every word, soft values too
        assert np.array_equal(g_ok, r_ok)
        assert np.array_equal(got.iterations.numpy(),
                              np.asarray(ref.iterations))
        assert np.array_equal(g_hard, r_hard)
        assert np.array_equal(got.soft.numpy(), np.asarray(ref.soft))
    else:
        both = g_ok & r_ok
        assert np.array_equal(g_hard[both], r_hard[both])
        assert abs(int(g_hard.sum()) - int(r_hard.sum())) \
            <= 0.02 * code.n * 12 + 16
    assert g_ok.any() and not g_ok.all()


def test_oracle_is_the_jax_oracle():
    code = toy_code()
    h = code.to_dense(np.int8)
    rng = np.random.RandomState(5)
    for row in (-1.0 + rng.normal(0, 0.7, (8, code.n))):
        for a, b in zip(oracle.dense_min_sum_decode(h, row, 25),
                        jax_oracle.dense_min_sum_decode(h, row, 25)):
            assert np.array_equal(a, b)
    assert oracle.syndrome_ok(h, np.zeros(code.n, np.int64))


@pytest.mark.parametrize("flips", [(0,), (0, 100, 4000), (17, 17)])
def test_epsilon_probe_matches_oracle_near_earth(flips):
    """Deterministic probes (tests/test_decoder.py pattern): hard decisions,
    iterations and success equal the f64 oracle's; soft values track it."""
    code = near_earth_code()
    h = code.to_dense(np.int8)
    probe = epsilon_probe(code.n, flips=flips, epsilon=1e-2, device="cpu")
    o_hard, o_soft, o_it, o_ok = oracle.dense_min_sum_decode(
        h, probe[0].numpy().astype(np.float64), 20)
    res = decode(code, probe, 20, keep_soft=True)
    assert bool(res.success[0]) == o_ok
    assert int(res.iterations[0]) == o_it
    assert np.array_equal(res.hard[0].numpy(), o_hard)
    np.testing.assert_allclose(res.soft[0].numpy(), o_soft, rtol=1e-5,
                               atol=1e-5)


def test_awgn_matches_oracle_toy_irregular():
    code = toy_code()
    h = code.to_dense(np.int8)
    rng = np.random.RandomState(5)
    noisy = (-1.0 + rng.normal(0, 0.7, (32, code.n))).astype(np.float32)
    outs = [oracle.dense_min_sum_decode(h, r.astype(np.float64), 25)
            for r in noisy]
    o_hard = np.stack([o[0] for o in outs])
    o_it = np.array([o[2] for o in outs])
    o_ok = np.array([o[3] for o in outs])
    res = decode(code, torch.from_numpy(noisy), 25)
    assert np.array_equal(res.success.numpy(), o_ok)
    assert np.array_equal(res.iterations.numpy(), o_it)
    assert o_ok.sum() >= 16
    assert np.array_equal(res.hard.numpy()[o_ok], o_hard[o_ok])


def test_decoded_words_are_codewords_wifi():
    code = wifi_code()
    h = code.to_dense(np.int8)
    llr = torch.from_numpy(_llrs(code.n, (3.0,), 16, seed=3))
    res = decode(code, llr, 50)
    for i in range(16):
        if bool(res.success[i]):
            assert oracle.syndrome_ok(h, res.hard[i].numpy())
    assert res.success.sum() >= 8


def test_zero_noise_and_max_iters_cap():
    code = wifi_code()
    res = decode(code, torch.full((4, code.n), -1.0), 10)
    assert bool(res.success.all()) and not res.hard.any()
    assert torch.equal(res.iterations, torch.zeros(4, dtype=torch.int32))
    llr = torch.from_numpy(_llrs(code.n, (0.0,), 4, seed=2))
    res = decode(code, llr, 3)
    assert (res.iterations <= 3).all() and not res.success.all()
    assert res.soft.shape == (4, 0)


def test_bfloat16_compute_runs_and_decodes():
    code = wifi_code()
    llr = torch.from_numpy(_llrs(code.n, (4.0,), 8, seed=6))
    f32 = decode(code, llr, 20)
    bf16 = decode(code, llr, 20, dtype=torch.bfloat16)
    assert bf16.success.sum() >= f32.success.sum() - 1
    assert bf16.hard[bf16.success].sum() == 0


def test_decoder_builders_and_errors():
    code = wifi_code()
    plan = DecodePlan.from_code(code)
    dec = make_decoder(plan, 5, kind="normalized-min-sum", dtype="float32")
    assert dec.alpha == 0.75 and dec.beta is None
    assert decoder_for_code(code, 5).plan is decoder_for_code(code, 7).plan
    with pytest.raises(ValueError):
        make_decoder(plan, 5, kind="bit-flip")
    with pytest.raises(ValueError):
        dec(torch.zeros(2, code.n - 1))
    got = decode(code, np.zeros((1, code.n), np.float32), 2, device="cpu")
    assert got.hard.device.type == "cpu" and bool(got.success[0])
