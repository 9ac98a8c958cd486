"""Kernel B5, int8 Q4.3 message memory: the store's rounding rules, the
flooding decode in each min-sum kind against the Pallas kernel in interpret
mode, and the staged cascade with the layered schedule and int8 state
against the JAX package's Pallas cascade.

The Q4.3 store is the JAX kernel's ``_st``/``_ld``/``_st_raw``
(ops/pallas_static.py:195-223): a value x is stored as
clip(round(x * 8), -127, 127) with round half to even (``jnp.round``), and
loaded as q / 8; the argmin plane holds the slot index unscaled.  The LLRs
enter through the same quantizer (:785-788).  Decodes: tolerance none, every
word agrees on (errors, iterations, success), converged or not.  Each
Pallas build in interpret mode costs 10-20 s, so each serves one batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.ops.pallas_static import \
    make_static_sweep_decoder as jax_static_decoder
from ldpc_tpu.sim.evaluate import \
    make_staged_decoder_device as jax_staged_decoder
from ldpc_tpu_torch.codes import QCCode, near_earth_code, wifi_code
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (flooding_reference,
                                            make_static_sweep_decoder,
                                            smem_bytes)
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.sim.evaluate import make_staged_decoder_device

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

I8 = torch.int8


def _jax_store(x):
    """The JAX kernel's int8 store, as written at pallas_static.py:211-213
    (scale 8, limit 127)."""
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jnp.float32) * 8.0),
                               -127.0, 127.0).astype(jnp.int8))


def _llrs(n, snrs, per, seed):
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, 5] = np.nan
    llr[-1, :3] = [np.inf, -np.inf, 1e31]
    return llr


@pytest.mark.parametrize("x,q", [
    (0.0625, 0), (0.1875, 2), (-0.0625, 0), (-0.1875, -2), (0.3125, 2),
    (0.125, 1), (-1.0, -8), (15.875, 127), (15.9, 127), (-16.0, -127)])
def test_q43_store_rounds_half_to_even(x, q):
    got = cuda_static._st(torch.tensor([x]), I8)
    assert got.dtype == I8 and int(got[0]) == q
    assert int(_jax_store([x])[0]) == q
    assert float(cuda_static._ld(got)[0]) == q / 8


@pytest.mark.parametrize("x", [np.inf, -np.inf, 3.0e38, -3.0e38, 1e30])
def test_q43_store_saturates(x):
    """+-inf and the two-min start _BIG (x 8 is inf in f32) saturate to
    +-127, never wrap."""
    got = int(cuda_static._st(torch.tensor([x], dtype=torch.float32), I8)[0])
    assert got == (127 if x > 0 else -127) == int(_jax_store([x])[0])


def test_q43_store_matches_jax_on_a_grid():
    x = np.concatenate([np.arange(-20, 20, 1 / 16), np.linspace(-3, 3, 997),
                        [0.0, -0.0, 1e-9, -1e-9]]).astype(np.float32)
    got = cuda_static._st(torch.from_numpy(x), I8).numpy()
    assert np.array_equal(got, _jax_store(x))
    back = cuda_static._ld(torch.from_numpy(got)).numpy()
    assert np.array_equal(back, got.astype(np.float32) / 8)


def test_argmin_plane_is_stored_raw():
    d = torch.arange(0, 128, dtype=torch.float32)
    raw = cuda_static._st_raw(d, I8)
    assert torch.equal(raw.float(), d[:128].clamp(max=127))
    # scaled, slot 16 and above would saturate: the plane must not scale
    assert int(cuda_static._st(d[16:17], I8)[0]) == 127


@pytest.mark.parametrize("cname,kind", [
    ("near-earth", "min-sum"), ("r1/2", "normalized-min-sum"),
    ("r5/6", "offset-min-sum")])
def test_int8_flooding_matches_pallas(cname, kind):
    if cname == "near-earth":
        code, jcode, snrs = near_earth_code(), jax_near_earth(), (3.0, 3.6)
    else:
        rate = {"r1/2": 1 / 2, "r5/6": 5 / 6}[cname]
        code, jcode = wifi_code(1944, rate), jax_wifi_code(1944, rate)
        snrs = {"r1/2": (-1.0, 0.5), "r5/6": (2.5, 3.5)}[cname]
    llr = _llrs(code.n, snrs, 4, seed=len(kind))
    ref = jax_static_decoder(jcode, max_iters=8, tile_b=8,
                             store_dtype=jnp.int8, kind=kind,
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, kind=kind, store_dtype="int8",
                                    device="cpu")(torch.from_numpy(llr))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert got[2].any() and not got[2].all()


def test_int8_decodes_and_costs_little_fer():
    """Q4.3 state decodes near-earth as bf16 does at a good SNR, and it is
    a different decoder (the JAX package's quantized_ber study)."""
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (3.6,), 6, seed=1))
    e8, it8, ok8 = flooding_reference(llr, plan, 30, store_dtype="int8")
    eb, itb, okb = flooding_reference(llr, plan, 30)
    assert ok8[1:-1].all() and okb[1:-1].all()
    assert not torch.equal(it8, itb)


def test_int8_shared_memory():
    """Near-earth min-sum: 35,600 bytes a block against bf16's 51,952."""
    plan = DecodePlan.from_code(near_earth_code())
    # 2,896 bytes of tables + 1,022 records of 16 bytes + 2 x 8,176 x 1
    assert smem_bytes(plan, "min-sum", "int8") == 35_600
    # 2,896 bytes of tables + 1,022 records of 16 bytes + 2 x 8,176 x 2
    assert smem_bytes(plan, "min-sum", "bfloat16") == 51_952


def test_int8_refuses_sum_product_and_wide_checks():
    code = wifi_code(1944, 1 / 2)
    with pytest.raises(ValueError, match="min-sum family only"):
        make_static_sweep_decoder(code, 4, kind="sum-product",
                                  store_dtype="int8", device="cpu")
    rng = np.random.default_rng(0)
    wide = QCCode(z=3, shifts=(tuple(
        (int(rng.integers(3)),) for _ in range(130)),), name="dc130")
    with pytest.raises(NotImplementedError, match="argmin"):
        make_static_sweep_decoder(wide, 4, store_dtype="int8", device="cpu")


@pytest.fixture(scope="module")
def jax_layered_int8_cascade():
    return jax_staged_decoder(jax_wifi_code(1944, 5 / 6), 8, phase1_iters=3,
                              engine="pallas", tile_b=4, redo_capacity=4,
                              schedule="layered", store_dtype=jnp.int8)


@pytest.mark.parametrize("snr,branch", [(2.5, "many"), (3.0, "few"),
                                        (4.5, "none")])
def test_layered_int8_cascade_matches_jax_pallas(jax_layered_int8_cascade,
                                                 snr, branch):
    """8 rate-5/6 words, 3 -> 8 sweeps, capacity 4 on both sides."""
    code = wifi_code(1944, 5 / 6)
    rng = np.random.default_rng(1)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    llr = (-1.0 + sigma * rng.standard_normal((8, code.n))).astype(
        np.float32)
    want = [np.asarray(x) for x in jax_layered_int8_cascade(jnp.asarray(llr))]
    dec = make_staged_decoder_device(code, 8, phase1_iters=3,
                                     redo_capacity=4, engine="cuda",
                                     schedule="layered", store_dtype="int8",
                                     device="cpu")
    got = [x.numpy() for x in dec(torch.from_numpy(llr))]
    assert dec.last_branches == [branch]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
