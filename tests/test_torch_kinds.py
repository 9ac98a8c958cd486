"""Normalized and offset min-sum (kernel B2) in both stores, and check
degrees above 32, against the Pallas kernel in interpret mode.

The variants act on the rebuilt message only (x alpha, or - beta with a
floor at 0, with the JAX package's defaults alpha = 0.75 and beta = 0.15);
the stored state stays the raw two-min.  The plain version keeps the
kernel's rounding points and orders, so every word agrees, converged or
not.  The high-degree code needs two 32-bit sign words per check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ldpc_tpu.ops.pallas_static import \
    make_static_sweep_decoder as jax_static_decoder
from ldpc_tpu_torch.codes import code_from_dict, code_to_dict, wifi_code
from ldpc_tpu_torch.ops.cuda_static import (flooding_reference,
                                            make_static_sweep_decoder,
                                            smem_bytes)
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.sim.evaluate import make_staged_decoder_device

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

SNRS = {1 / 2: (-1.5, -0.5), 5 / 6: (2.5, 3.5)}


def _llrs(n, snrs, per, seed):
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, 5] = np.nan
    llr[-1, :2] = [np.inf, -np.inf]
    return llr


def _assert_same(port, ref):
    pe, pi, ps = (x.numpy() for x in port)
    re, ri, rs = (np.asarray(x) for x in ref)
    assert np.array_equal(ps, rs)
    assert np.array_equal(pe, re)
    assert np.array_equal(pi, ri)


def _jax_store(store):
    return {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[store]


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["normalized-min-sum", "offset-min-sum"])
@pytest.mark.parametrize("rate", [1 / 2, 5 / 6])
def test_minsum_variants_match_pallas_wifi(rate, kind, store):
    code = wifi_code(1944, rate)
    llr = _llrs(code.n, SNRS[rate], 4, seed=int(rate * 60) + len(kind))
    ref = jax_static_decoder(jax_wifi_code(1944, rate), max_iters=10,
                             tile_b=4, store_dtype=_jax_store(store),
                             kind=kind, interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 10, kind=kind, store_dtype=store,
                                    device="cpu")(torch.from_numpy(llr))
    _assert_same(got, ref)
    assert got[2].any() and not got[2].all()


def _high_degree_jax_code():
    """The code of tests/test_pallas_static.py::
    test_static_kernel_high_degree_checks: z = 9, one block row of 20
    blocks of 2-3 shifts, check degree 40-50."""
    rng = np.random.default_rng(11)
    z, nb = 9, 20
    row = tuple(tuple(sorted(rng.choice(z, size=int(rng.integers(2, 4)),
                                        replace=False).tolist()))
                for _ in range(nb))
    return JaxQCCode(z=z, shifts=(row,), name="highdeg")


@pytest.mark.parametrize("kind,store", [
    ("min-sum", "float32"), ("offset-min-sum", "bfloat16")])
def test_high_degree_checks_match_pallas(kind, store):
    """d_c > 32: the signs spill into a second word per check, in the
    plain version as in the kernel; every word agrees with Pallas."""
    jcode = _high_degree_jax_code()
    code = code_from_dict(code_to_dict(jcode))
    plan = DecodePlan.from_code(code)
    assert 32 < plan.dmax_cn < 64
    llr = _llrs(code.n, (1.0, 3.0, 5.0), 4, seed=3)
    ref = jax_static_decoder(jcode, max_iters=8, tile_b=4,
                             store_dtype=_jax_store(store), kind=kind,
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, kind=kind, store_dtype=store,
                                    device="cpu")(torch.from_numpy(llr))
    _assert_same(got, ref)
    assert got[2].any() and not got[2].all()


def test_high_degree_smem_counts_two_sign_words():
    plan = DecodePlan.from_code(code_from_dict(code_to_dict(
        _high_degree_jax_code())))
    # the second sign word of each check lies beside its record
    one_word = smem_bytes(plan, "min-sum", "float32") - 4 * plan.m
    n_tab = (plan.block_rows * (2 + 2 * plan.dmax_cn) +
             plan.block_cols * (1 + 3 * plan.dmax_vn))
    assert one_word == (-(-4 * n_tab // 16) * 16 +
                        16 * plan.block_cols * plan.dmax_vn +
                        8 * plan.block_rows * plan.dmax_cn +
                        16 * plan.m + 4 * 2 * plan.n)


@pytest.mark.parametrize("kind", ["normalized-min-sum", "offset-min-sum"])
def test_variant_parameters_reach_the_rebuild(kind):
    """alpha and beta change the decode only through the rebuilt messages:
    alpha = 1 and beta = 0 give plain min-sum word for word, and the
    defaults do not."""
    code = wifi_code(1944, 5 / 6)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (2.5,), 8, seed=9))
    plain = flooding_reference(llr, plan, 12, store_dtype="float32")
    same = flooding_reference(llr, plan, 12, kind=kind,
                              store_dtype="float32", alpha=1.0, beta=0.0)
    other = flooding_reference(llr, plan, 12, kind=kind,
                               store_dtype="float32")
    for a, b in zip(plain, same):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(plain, other))


def test_wrapper_refuses_later_variants():
    """What the port refuses is what the JAX kernel refuses (sum-product
    with int8 state or the layered schedule, unknown kinds and stores), and
    dep_stride on the torch engine (ValueError, as on JAX's xla engine).
    Layered, int8, popcount_sign and dep_stride > 0 (kernel B8: the barrier
    probe on the card, then the dep_stride=0 decode) build."""
    code = wifi_code(1944, 1 / 2)
    make_staged_decoder_device(code, 4, phase1_iters=2, engine="cuda",
                               dep_stride=2, device="cpu")
    with pytest.raises(ValueError, match="levers"):
        make_staged_decoder_device(code, 4, phase1_iters=2, dep_stride=2,
                                   device="cpu")
    with pytest.raises(ValueError, match="min-sum family"):
        make_static_sweep_decoder(code, 4, kind="sum-product",
                                  store_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="flooding only"):
        make_static_sweep_decoder(code, 4, kind="sum-product",
                                  schedule="layered", device="cpu")
    for kw in (dict(store_dtype="int8"), dict(schedule="layered"),
               dict(popcount_sign=True)):
        make_static_sweep_decoder(code, 4, device="cpu", **kw)
    with pytest.raises(ValueError):
        make_static_sweep_decoder(code, 4, kind="max-product", device="cpu")
    with pytest.raises(ValueError):
        make_static_sweep_decoder(code, 4, store_dtype="float16",
                                  device="cpu")
    dec = make_static_sweep_decoder(code, 4, store_dtype=torch.float32,
                                    device="cpu")
    assert dec(torch.full((1, code.n), -1.0))[2].all()
