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
from ldpc_tpu_torch.ops import cuda_static, microbench
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


# ---- kernel B7, the phase-split pair (csrc/split.cu), and B8 ----

def _finite_llr(n, snrs, per, seed, device):
    """As _llr without the non-finite entries: the split decoder, as the
    Pallas pair, does not sanitise them and the fused kernel does."""
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    return torch.from_numpy(np.concatenate(rows).astype(np.float32)).to(
        device)


SPLIT_CODES = [near_earth_code(), _random_code(7, 21, 2, 6),
               wifi_code(1944, 1 / 2), wifi_code(1944, 5 / 6),
               _high_degree_code()]


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("code", SPLIT_CODES, ids=lambda c: c.name)
def test_split_matches_plain_version_and_mono(cuda, code, store):
    """Every word, converged or not: the split kernels, their plain version
    and the fused kernel's min-sum flooding decode agree."""
    from ldpc_tpu_torch.ops import cuda_split
    llr = _finite_llr(code.n, (1.0, 2.5, 3.0, 3.4, 4.0), 128, seed=8,
                      device=cuda)
    dec = cuda_split.make_split_sweep_decoder(code, 20, store_dtype=store,
                                              device=cuda)
    before = dict(cuda_split.launches)
    got = dec(llr)
    for k in ("split_r", "split_c"):
        assert cuda_split.launches[(k, store)] > before.get((k, store), 0)
    assert 1 <= dec.host_reads <= 20
    want = cuda_split.split_reference(llr, dec.plan, 20, store)
    mono = make_static_sweep_decoder(code, 20, store_dtype=store,
                                     device=cuda)(llr)
    torch.cuda.synchronize()
    for g, w, m in zip(got, want, mono):
        assert torch.equal(g, w)
        assert torch.equal(g, m)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_split_launches_match_their_plain_versions(cuda, store):
    """One launch of split_r, then of split_c, on the same state as their
    plain versions: every plane and latch equal."""
    from ldpc_tpu_torch.ops import cuda_split
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = _finite_llr(code.n, (2.0, 3.0, 4.0), 64, seed=9, device=cuda)
    t = cuda_static._RefTables(plan, cuda)
    tables = torch.as_tensor(cuda_static.kernel_tables(plan), device=cuda)
    s = cuda_split.SplitState.start(llr, plan, 10, store)
    for it in range(3):      # a few plain iterations, so some words latch
        s = cuda_split.split_c_reference(
            cuda_split.split_r_reference(s, t, it), t)
    n_ok = torch.zeros(11, dtype=torch.int32, device=cuda)
    want = cuda_split.split_r_reference(s, t, 3)
    cuda_split.launch("r", s, plan, tables, n_ok, 3)
    torch.cuda.synchronize()
    for name in ("m1", "m2", "am", "sp", "bits", "errors", "iters",
                 "success"):
        assert torch.equal(getattr(s, name), getattr(want, name)), name
    assert int(n_ok[3]) == int(want.success.sum())
    want = cuda_split.split_c_reference(s, t)
    cuda_split.launch("c", s, plan, tables, n_ok)
    torch.cuda.synchronize()
    assert torch.equal(s.tot, want.tot)


def test_split_decodes_a_code_the_fused_kernel_refuses(cuda):
    """synthetic_qc_code(2048, 8, 24): one word's state (393,216 bytes in
    bf16) exceeds a block's shared memory, so the fused kernel refuses it;
    the split pair equals its plain version, failed words included."""
    from ldpc_tpu_torch.codes import synthetic_qc_code
    from ldpc_tpu_torch.ops import cuda_split
    code = synthetic_qc_code(2048, 8, 24)
    with pytest.raises(NotImplementedError, match="shared memory"):
        make_static_sweep_decoder(code, 8, device=cuda)
    llr = _finite_llr(code.n, (1.1, 4.0), 128, seed=10, device=cuda)
    dec = cuda_split.make_split_sweep_decoder(code, 8, device=cuda)
    got = dec(llr)
    want = cuda_split.split_reference(llr, dec.plan, 8, chunk=64)
    torch.cuda.synchronize()
    assert 0 < int(got[2].sum()) < llr.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_barrier_lowers_on_card(cuda):
    assert cuda_static.barrier_lowers(cuda) is True
    x = torch.randn(4096, device=cuda)
    assert torch.equal(cuda_static.barrier_probe(x), x + x.abs())


def test_dep_stride_decodes_as_zero_on_card(cuda):
    code = near_earth_code()
    llr = _llr(code.n, (3.0, 3.4), 256, seed=11, device=cuda)
    want = make_staged_decoder_device(code, 50, phase1_iters=12,
                                      redo_capacity=96, engine="cuda",
                                      device=cuda)(llr)
    got = make_staged_decoder_device(code, 50, phase1_iters=12,
                                     redo_capacity=96, engine="cuda",
                                     dep_stride=4, device=cuda)(llr)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["split", "barrier_probe", "microbench"])
def test_new_sources_build_with_a_ptxas_report(cuda, name):
    from ldpc_tpu_torch.csrc import build, build_report
    build(name)
    ptxas = build_report(name)["ptxas"]
    assert "Used" in ptxas and "registers" in ptxas
    assert "spill" in ptxas


@pytest.mark.parametrize("tiles", [1, 5, "fill"], ids=str)
@pytest.mark.parametrize("name", microbench.NAMES)
def test_microbench_probe_matches_plain_version(cuda, name, tiles):
    """Kernel B9: each probe's final buffers equal its plain version's on
    every element, at K = 1 and 7, on one tile, a few and the card-filling
    count; the sums within 1e-4 of the sum of |values| (another order)."""
    _, n_bufs, rows, dtype = microbench.PROBES[name]
    g = microbench.fill_tiles(name, cuda) if tiles == "fill" else tiles
    for k in (1, 7):
        x = microbench.input_tile(n_bufs, rows, dtype, k, g, cuda)
        before = microbench.launches[name]
        sums, bufs = microbench.probe(name, x, k)
        assert microbench.launches[name] == before + 1
        want_sums, want = microbench.probe_reference(name, x, k)
        torch.cuda.synchronize()
        assert bufs.dtype == dtype and bufs.shape == x.shape
        assert torch.equal(bufs, want)
        scale = want[:, 0].float().abs().sum(dim=(-2, -1))
        assert bool(((sums - want_sums).abs() <= 1e-4 * scale).all())


def test_microbench_rejects_what_it_does_not_take(cuda, monkeypatch):
    x = microbench.input_tile(1, 512, torch.float32, 0, 1, cuda)
    with pytest.raises(TypeError):
        microbench.probe("baseline+f32_to_bf16", x, 1)
    with pytest.raises(ValueError):
        microbench.probe("twomin_edge_no_rot", x, 1)
    assert microbench.fill_tiles("abs_add_baseline", cuda) >= 132 // 8

    class Refused:                 # a launch the card refuses raises
        def microbench_launch(self, *args):
            return 700

    monkeypatch.setattr(microbench, "_lib", Refused)
    before = microbench.launches["abs_add_baseline"]
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        microbench.probe("abs_add_baseline", x, 1)
    assert microbench.launches["abs_add_baseline"] == before


def test_phi_sass_counts_phi(cuda):
    from ldpc_tpu_torch.scripts import phi_sass
    res = phi_sass.count()
    assert res["instructions"] > 0 and res["flops"] > 0
    assert res["kernel_instructions"]["phi_only"] > \
        res["kernel_instructions"]["copy_only"]
