"""The CUDA kernel, each (kind, store, schedule, popcount_sign) variant,
against its plain PyTorch version, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one.  This file imports no JAX, so it also runs on the machine with
the card, which has none (from the repository root)::

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import QCCode, near_earth_code, wifi_code
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (KINDS, STORES,
                                            flooding_reference,
                                            layered_reference,
                                            make_static_sweep_decoder)
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.sim.evaluate import make_staged_decoder_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _llr(n, snrs, per, seed, device):
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, :3] = [np.nan, np.inf, -np.inf]
    return torch.from_numpy(llr).to(device)


def _random_code(seed, z, mb, nb):
    rng = np.random.default_rng(seed)
    shifts = []
    for _ in range(mb):
        row = [tuple(sorted(rng.choice(z, size=int(rng.integers(0, 3)),
                                       replace=False).tolist()))
               for _ in range(nb)]
        if all(len(b) == 0 for b in row):
            row[0] = (int(rng.integers(z)),)
        shifts.append(tuple(row))
    return QCCode(z=z, shifts=tuple(shifts), name=f"rand{seed}")


def _high_degree_code():
    """Check degree 40-50 (> 32): two sign words per check."""
    rng = np.random.default_rng(11)
    z, nb = 9, 20
    row = tuple(tuple(sorted(rng.choice(z, size=int(rng.integers(2, 4)),
                                        replace=False).tolist()))
                for _ in range(nb))
    return QCCode(z=z, shifts=(row,), name="highdeg")


CODES = [near_earth_code(), _random_code(7, 21, 2, 6),
         _random_code(8, 13, 3, 7), wifi_code(1944, 1 / 2),
         wifi_code(1944, 5 / 6), _high_degree_code()]
VARIANTS = [(k, s) for k in KINDS for s in ("bfloat16", "float32")]
# the variants of kernels B3, B5 and B6: the min-sum family in every store,
# schedule and sign mode, less the flooding float-store pairs above
MINSUM = KINDS[:3]
NEW_VARIANTS = [(k, s, sched, pc) for k in MINSUM for s in STORES
                for sched in ("flooding", "layered") for pc in (False, True)
                if (sched, pc) != ("flooding", False) or s == "int8"]


@pytest.mark.parametrize("kind,store", VARIANTS)
@pytest.mark.parametrize("code", CODES, ids=lambda c: c.name)
def test_kernel_matches_plain_version(cuda, code, kind, store):
    """Same LLRs, same rounding points and f32 orders: every word agrees
    exactly (the contract asks it of converged words)."""
    llr = _llr(code.n, (1.0, 2.5, 3.0, 3.4, 4.0), 64, seed=3, device=cuda)
    if kind == "sum-product":       # true LLRs, 2y/sigma^2 at ~3 dB
        llr = llr * 4.0
    dec = make_static_sweep_decoder(code, 20, kind=kind, store_dtype=store,
                                    device=cuda)
    key = (kind, store, "flooding", False)
    before = cuda_static.launches[key]
    got = dec(llr)
    assert cuda_static.launches[key] == before + 1
    want = flooding_reference(llr, DecodePlan.from_code(code), 20,
                              kind=kind, store_dtype=store)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,store,schedule,popcount", NEW_VARIANTS)
@pytest.mark.parametrize("code", CODES, ids=lambda c: c.name)
def test_new_variant_matches_plain_version(cuda, code, kind, store,
                                           schedule, popcount):
    """Layered schedule, int8 state and popcount sign: every word agrees
    with the plain version, converged or not."""
    llr = _llr(code.n, (1.0, 2.5, 3.0, 3.4, 4.0), 64, seed=4, device=cuda)
    dec = make_static_sweep_decoder(code, 20, kind=kind, store_dtype=store,
                                    schedule=schedule, popcount_sign=popcount,
                                    device=cuda)
    key = (kind, store, schedule, popcount)
    before = cuda_static.launches[key]
    got = dec(llr)
    assert cuda_static.launches[key] == before + 1
    ref = layered_reference if schedule == "layered" else flooding_reference
    want = ref(llr, DecodePlan.from_code(code), 20, kind=kind,
               store_dtype=store, popcount_sign=popcount)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("store", list(STORES))
def test_popcount_sign_is_bit_identical_on_card(cuda, schedule, store):
    code = near_earth_code()
    llr = _llr(code.n, (2.8, 3.0, 3.2, 3.4), 128, seed=6, device=cuda)
    a, b = (make_static_sweep_decoder(code, 50, store_dtype=store,
                                      schedule=schedule, popcount_sign=pc,
                                      device=cuda)(llr)
            for pc in (False, True))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [dict(schedule="layered"),
                                dict(store_dtype="int8"),
                                dict(popcount_sign=True)])
def test_staged_new_variants_equal_single_pass_on_card(cuda, kw):
    code = near_earth_code()
    llr = _llr(code.n, (3.0, 3.4), 256, seed=7, device=cuda)
    single = make_static_sweep_decoder(code, 50, device=cuda, **kw)(llr)
    staged = make_staged_decoder_device(code, 50, phase1_iters=6,
                                        redo_capacity=96, engine="cuda",
                                        device=cuda, **kw)
    for a, b in zip(staged(llr), single):
        assert torch.equal(a, b)


def test_staged_equals_single_pass_on_card(cuda):
    code = near_earth_code()
    llr = _llr(code.n, (3.0, 3.4), 256, seed=5, device=cuda)
    single = make_static_sweep_decoder(code, 50, device=cuda)(llr)
    for cap in (64, 512):
        staged = make_staged_decoder_device(code, 50, redo_capacity=cap,
                                            engine="cuda", device=cuda)
        for a, b in zip(staged(llr), single):
            assert torch.equal(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    code = near_earth_code()
    dec = make_static_sweep_decoder(code, 4, device=cuda)
    with pytest.raises(ValueError):
        dec(torch.zeros(2, code.n))                      # on the CPU
    with pytest.raises(TypeError):
        dec(torch.zeros(2, code.n, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        dec(torch.zeros(code.n, 2, device=cuda).t())     # not contiguous
    e, it, ok = dec(torch.zeros(0, code.n, device=cuda))
    assert e.shape == (0,)
