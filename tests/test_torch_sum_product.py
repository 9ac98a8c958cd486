"""Sum-product (kernel B4): the plain version against the Pallas kernel in
interpret mode, on the same numpy LLRs (true LLRs, 2y/sigma^2).

The contract against the JAX package is statistical, as the JAX package's
own sum-product tests are (tests/test_pallas_static.py): phi(x) =
-log(tanh(x/2)) goes through XLA's CPU tanh/log on one side and torch's on
the other, and the two differ in the last bits of about a third of all
f32 arguments (XLA's tanh also reaches 1.0, so phi = 0, for arguments
where torch's phi is still above 0).  On the card the kernel and the plain
version call the same CUDA tanhf/logf and agree exactly
(tests/test_torch_gpu.py).
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
                                            make_static_sweep_decoder)
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)


def _true_llrs(n, snr, b, seed):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    y = -1.0 + sigma * rng.standard_normal((b, n))
    return (2.0 * y / sigma ** 2).astype(np.float32)


def _random_codes():
    """The random QC codes of tests/test_pallas_static.py::
    test_sum_product_kernel_matches_xla_small (same generator, same draws)."""
    rng = np.random.default_rng(11)
    out = []
    for trial, (z, mb, nb) in enumerate([(21, 2, 6), (13, 3, 7)]):
        shifts = []
        for _ in range(mb):
            row = []
            for _ in range(nb):
                w = int(rng.integers(0, 3))
                row.append(tuple(sorted(
                    rng.choice(z, size=w, replace=False).tolist())))
            if all(len(b) == 0 for b in row):
                row[0] = (int(rng.integers(z)),)
            shifts.append(tuple(row))
        out.append(JaxQCCode(z=z, shifts=tuple(shifts), name=f"sprand{trial}"))
    return out


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("trial", [0, 1])
def test_sum_product_matches_pallas_random_qc(trial, store):
    """success equal on every word, errors equal on words both sides
    converged, iterations different on at most one of the 4 words."""
    jcode = _random_codes()[trial]
    code = code_from_dict(code_to_dict(jcode))
    llr = _true_llrs(code.n, 2.0, 4, seed=trial)
    jstore = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[store]
    ref = [np.asarray(x) for x in jax_static_decoder(
        jcode, max_iters=8, tile_b=4, store_dtype=jstore,
        kind="sum-product", interpret=True)(jnp.asarray(llr))]
    got = [x.numpy() for x in make_static_sweep_decoder(
        code, 8, kind="sum-product", store_dtype=store, device="cpu")(
            torch.from_numpy(llr))]
    assert np.array_equal(got[2], ref[2])
    both = got[2] & ref[2]
    assert np.array_equal(got[0][both], ref[0][both])
    assert (got[1] != ref[1]).sum() <= 1
    assert got[2].any()


def test_sum_product_wifi_statistical():
    """802.11n rate 5/6, f32 state, 8 words, 10 iterations: errors equal on
    words both sides converged, and the batch's errors within the JAX
    test's own bound (tests/test_pallas_static.py::
    test_sum_product_kernel_wifi_statistical)."""
    code = wifi_code(1944, 5 / 6)
    llr = _true_llrs(code.n, 2.2, 8, seed=5)
    ref = [np.asarray(x) for x in jax_static_decoder(
        jax_wifi_code(1944, 5 / 6), max_iters=10, tile_b=4,
        store_dtype=jnp.float32, kind="sum-product", interpret=True)(
            jnp.asarray(llr))]
    got = [x.numpy() for x in make_static_sweep_decoder(
        code, 10, kind="sum-product", store_dtype="float32", device="cpu")(
            torch.from_numpy(llr))]
    both = got[2] & ref[2]
    assert np.array_equal(got[0][both], ref[0][both])
    assert abs(float(got[0].sum()) - float(ref[0].sum())) \
        <= 0.02 * code.n * 8 + 16
    assert both.any()


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_first_rebuilt_message_is_zero(store):
    """S seeded at 38 with a zero phi stash rebuilds c2v == 0 exactly on
    the first iteration (phi(38) == 0 in f32); zero iterations report the
    channel's hard decisions."""
    code = wifi_code(1944, 1 / 2)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_true_llrs(code.n, 0.0, 6, seed=1))
    assert float(-torch.log(torch.tanh(torch.tensor(38.0) * 0.5))) == 0.0
    e, it, ok = flooding_reference(llr, plan, 0, kind="sum-product",
                                   store_dtype=store)
    assert torch.equal(e, (llr.to(getattr(torch, store)).float() > 0)
                       .sum(-1, dtype=torch.int32))
    assert torch.equal(it, torch.zeros(6, dtype=torch.int32))
    assert not ok.any()


def test_sum_product_decodes_where_min_sum_fails_less():
    """Sum-product is the stronger rule: at the same noise it leaves no more
    frames in error than min-sum (802.11n rate 1/2, 32 words, 20 it)."""
    code = wifi_code(1944, 1 / 2)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_true_llrs(code.n, -1.5, 32, seed=4))
    sp = flooding_reference(llr, plan, 20, kind="sum-product",
                            store_dtype="float32")
    ms = flooding_reference(llr, plan, 20, store_dtype="float32")
    frame_errors = [int(((e > 0) | ~ok).sum()) for e, _, ok in (sp, ms)]
    assert frame_errors[0] <= frame_errors[1]
    assert sp[2].sum() > 16
