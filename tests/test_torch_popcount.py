"""Kernel B6, ``popcount_sign``: the sign product folded from the packed
sign words instead of a stored plane.

The JAX contract (tests/test_pallas_static.py:115-144): trajectories are
bit-identical to the stored sign, in every schedule and store, on every
word, converged or not.  Here the port's plain version is held to it in
every (schedule, store), and against the Pallas kernel with
``popcount_sign=True`` in interpret mode on near-earth (layered, bf16: the
main layered path, two shifts in every block) and on 802.11n rate 5/6
(flooding, f32).  Tolerance: none.  Sum-product ignores the flag, as in the
JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.ops.pallas_static import \
    make_static_sweep_decoder as jax_static_decoder
from ldpc_tpu_torch.codes import near_earth_code, wifi_code
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (flooding_reference,
                                            layered_reference,
                                            make_static_sweep_decoder,
                                            smem_bytes)
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

KINDS = {"bfloat16": "min-sum", "float32": "normalized-min-sum",
         "int8": "offset-min-sum"}


def _llrs(n, snrs, per, seed):
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, 5] = np.nan
    llr[-1, :2] = [np.inf, -np.inf]
    return llr


def test_parity_sign_is_the_sign_product():
    """The xor-fold parity of the words is (-1)^(number of set bits), over
    several words (check degree above 32)."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, size=(64, 3), dtype=np.int64)
    got = cuda_static._parity_sign(torch.from_numpy(words)).numpy()
    ones = np.array([sum(bin(int(w)).count("1") for w in row)
                     for row in words])
    assert np.array_equal(got, 1.0 - 2.0 * (ones % 2))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8"])
def test_popcount_is_bit_identical_to_the_stored_sign(schedule, store):
    """Every word of two codes (near-earth, and 802.11n rate 1/2 in its
    waterfall) with and without popcount_sign; each store with its own
    kind of the min-sum family."""
    ref = layered_reference if schedule == "layered" else flooding_reference
    for code, snrs in ((near_earth_code(), (2.5, 3.4)),
                       (wifi_code(1944, 1 / 2), (-2.0, 0.0))):
        plan = DecodePlan.from_code(code)
        llr = torch.from_numpy(_llrs(code.n, snrs, 3, seed=5))
        a = ref(llr, plan, 12, kind=KINDS[store], store_dtype=store)
        b = ref(llr, plan, 12, kind=KINDS[store], store_dtype=store,
                popcount_sign=True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert a[2].any() and not a[2].all()


@pytest.mark.parametrize("cname,schedule,store", [
    ("near-earth", "layered", "bfloat16"), ("r5/6", "flooding", "float32")])
def test_popcount_matches_pallas(cname, schedule, store):
    if cname == "near-earth":
        code, jcode, snrs = near_earth_code(), jax_near_earth(), (3.0, 3.6)
    else:
        code, jcode = wifi_code(1944, 5 / 6), jax_wifi_code(1944, 5 / 6)
        snrs = (2.5, 3.5)
    llr = _llrs(code.n, snrs, 4, seed=8)
    ref = jax_static_decoder(jcode, max_iters=8, tile_b=8,
                             store_dtype={"bfloat16": jnp.bfloat16,
                                          "float32": jnp.float32}[store],
                             schedule=schedule, popcount_sign=True,
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, store_dtype=store,
                                    schedule=schedule, popcount_sign=True,
                                    device="cpu")(torch.from_numpy(llr))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert got[2].any() and not got[2].all()


def test_sum_product_ignores_popcount_sign():
    code = wifi_code(1944, 1 / 2)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (-2.0,), 4, seed=2)) * 4.0
    a = flooding_reference(llr, plan, 8, kind="sum-product",
                           store_dtype="float32")
    b = make_static_sweep_decoder(code, 8, kind="sum-product",
                                  store_dtype="float32", popcount_sign=True,
                                  device="cpu")(llr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (smem_bytes(plan, "sum-product", "float32", popcount_sign=True)
            == smem_bytes(plan, "sum-product", "float32"))


def test_popcount_drops_the_sign_plane():
    """The sign product is a bit of the check record, so folding it from
    the sign bits frees no byte: the record keeps its size."""
    plan = DecodePlan.from_code(near_earth_code())
    for store in ("bfloat16", "float32", "int8"):
        for schedule in ("flooding", "layered"):
            assert (smem_bytes(plan, "min-sum", store, schedule) -
                    smem_bytes(plan, "min-sum", store, schedule, True)
                    == 0)
