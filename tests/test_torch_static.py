"""The plain PyTorch version of the flooding min-sum kernel against the
JAX package's Pallas kernel (interpret mode on the CPU), and the wrapper's
checks.

Both sides get the same numpy LLRs.  The port keeps the Pallas kernel's bf16
rounding points and its f32 summation order, so the contract (converged
words exact on errors, iterations and success) holds here with no tolerance
at all: non-converged words are required to match exactly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ldpc_tpu.ops.pallas_static import \
    make_static_sweep_decoder as jax_static_decoder
from ldpc_tpu_torch.codes import code_from_dict, near_earth_code
from ldpc_tpu_torch.codes.io import code_to_dict
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (make_static_sweep_decoder,
                                            flooding_reference,
                                            static_decode_counts)
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)


def _llrs(n, snrs, words_per_snr, seed, nonfinite=True):
    """Raw BPSK samples of the all-zero word (-1 + noise), numpy float32,
    ``words_per_snr`` words per SNR; optionally NaN and +-inf entries."""
    rng = np.random.default_rng(seed)
    rows = []
    for snr in snrs:
        sigma = np.sqrt(0.5 / 10 ** (snr / 10))
        rows.append(-1.0 + sigma * rng.standard_normal((words_per_snr, n)))
    llr = np.concatenate(rows).astype(np.float32)
    if nonfinite:
        llr[0, 3] = np.nan
        llr[1, 11] = np.inf
        llr[1, 12] = -np.inf
        llr[-1, :4] = [np.nan, np.inf, -np.inf, np.nan]
    return llr


def _assert_same(port, ref, label=""):
    pe, pi, ps = (x.numpy() for x in port)
    re, ri, rs = (np.asarray(x) for x in ref)
    assert pe.dtype == np.int32 and pi.dtype == np.int32
    assert ps.dtype == np.bool_
    conv = ps | rs
    assert np.array_equal(ps, rs), label
    assert np.array_equal(pe[conv], re[conv]), label
    assert np.array_equal(pi[conv], ri[conv]), label
    # non-converged words: same f32 order, so exact as well
    assert np.array_equal(pe, re), label
    assert np.array_equal(pi, ri), label


def test_plain_version_matches_pallas_near_earth():
    """Near-earth at 2.5-3.6 dB plus non-finite entries, max_iters=8 as in
    tests/test_pallas_static.py; converged and failed words both occur."""
    code = near_earth_code()
    llr = _llrs(code.n, (2.5, 3.0, 3.4, 3.6), 2, seed=11)
    ref = jax_static_decoder(jax_near_earth(), max_iters=8, tile_b=2,
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, device="cpu")(
        torch.from_numpy(llr))
    _assert_same(got, ref)
    ok = got[2].numpy()
    assert ok.any() and not ok.all()


def _random_code(trial):
    rng = np.random.default_rng(7)
    for t, (z, mb, nb) in enumerate([(21, 2, 6), (13, 3, 7)]):
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
        if t == trial:
            return JaxQCCode(z=z, shifts=tuple(shifts), name=f"rand{t}")


@pytest.mark.parametrize("trial", [0, 1])
def test_plain_version_matches_pallas_random_qc(trial):
    """Random QC codes with odd z, zero and weight-2 blocks and uneven
    degrees (tests/test_pallas_static.py:147-172), bf16 state."""
    jcode = _random_code(trial)
    code = code_from_dict(code_to_dict(jcode))
    llr = _llrs(code.n, (0.5, 2.0, 4.0), 4, seed=trial)
    ref = jax_static_decoder(jcode, max_iters=8, tile_b=4,
                             interpret=True)(jnp.asarray(llr))
    got = static_decode_counts(code, torch.from_numpy(llr), 8)
    _assert_same(got, ref, jcode.name)


def test_plain_version_zero_iterations_and_empty_batch():
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (3.0,), 3, seed=2, nonfinite=False))
    e, it, ok = flooding_reference(llr, plan, 0)
    assert torch.equal(it, torch.zeros(3, dtype=torch.int32))
    assert torch.equal(e, (llr > 0).sum(-1, dtype=torch.int32))
    assert not ok.any()
    e, it, ok = flooding_reference(llr[:0], plan, 5)
    assert e.shape == it.shape == ok.shape == (0,)


def test_plain_version_chunking_is_invisible():
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (3.2,), 6, seed=4))
    whole = flooding_reference(llr, plan, 10)
    parts = flooding_reference(llr, plan, 10, chunk=4)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    code = near_earth_code()
    dec = make_static_sweep_decoder(code, 4, device="cpu")
    good = torch.zeros(2, code.n)
    before = sum(cuda_static.launches.values())
    dec(good)
    assert sum(cuda_static.launches.values()) == before   # no CPU kernel
    with pytest.raises(TypeError):
        dec(good.double())
    with pytest.raises(ValueError):
        dec(torch.zeros(2, code.n - 1))
    with pytest.raises(ValueError):
        dec(torch.zeros(code.n))
    with pytest.raises(ValueError):
        dec(torch.zeros(code.n, 2).t())       # not contiguous
    with pytest.raises(ValueError):
        make_static_sweep_decoder(code, -1, device="cpu")
