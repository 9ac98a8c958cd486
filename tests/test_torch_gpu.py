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

from ldpc_tpu_torch.codes import (QCCode, near_earth_code, wifi_code,
                                  zero_circulant)
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

# The flooding loops of B1 and of the instances that share them (f32, int8,
# popcount_sign): every word equal to the plain version, converged or not,
# for odd batches, clean and noisy words interleaved (so that words which
# converge at different iterations share the launch), no or one iteration,
# and NaN/+-inf LLRs.
B1_INSTANCES = [("bfloat16", False), ("float32", False), ("int8", False),
                ("bfloat16", True)]
B1_CODES = {"near-earth": (near_earth_code(), (2.5, 3.2, 4.0)),
            "wifi r1/2": (wifi_code(1944, 1 / 2), (-1.0, 0.5, 2.0))}


def _mixed_llr(n, words, snrs, seed, device):
    """Word w is the clean all-zero codeword (-1 a bit) when w % 4 == 0,
    else noisy at snrs[w % 4 - 1]; the second word (the only one, alone)
    carries NaN, +inf and -inf."""
    rng = np.random.default_rng(seed)
    llr = np.full((words, n), -1.0, np.float32)
    for w in range(words):
        if w % 4:
            sigma = np.sqrt(0.5 / 10 ** (snrs[w % 4 - 1] / 10))
            llr[w] += sigma * rng.standard_normal(n).astype(np.float32)
    llr[min(1, words - 1), 5:8] = [np.nan, np.inf, -np.inf]
    return torch.from_numpy(llr).to(device)


@pytest.mark.parametrize("max_iters", [0, 1, 20])
@pytest.mark.parametrize("batch", [1, 3, 129])
@pytest.mark.parametrize("store,popcount", B1_INSTANCES)
@pytest.mark.parametrize("code", list(B1_CODES))
def test_flooding_loops_match_plain_version_on_every_word(
        cuda, code, store, popcount, batch, max_iters):
    qc, snrs = B1_CODES[code]
    llr = _mixed_llr(qc.n, batch, snrs, 97 + batch, cuda)
    dec = make_static_sweep_decoder(qc, max_iters, store_dtype=store,
                                    popcount_sign=popcount, device=cuda)
    got = dec(llr)
    want = flooding_reference(llr, dec.plan, max_iters, store_dtype=store,
                              popcount_sign=popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if batch == 129 and max_iters == 20:
        iters = got[1][got[2]]
        assert len(set(iters.tolist())) > 1 and not got[2].all()


def test_edge_sass_counts_the_b1_loops(cuda):
    from ldpc_tpu_torch.scripts import edge_sass
    res = edge_sass.count()
    for label in edge_sass.INSTANCES:
        r = res[label]
        assert r["A"]["edges"] >= 1 and r["B"]["edges"] >= 1
        assert r["shared_per_edge"] <= 3


# B3 before the redesign of its layered sweep (PERF.md: scripts/edge_sass.py
# on that revision's decode.cu, bf16 and f32 alike): 14 shared instructions
# an edge-sweep at near-earth (syndrome 3 + fold 2 + delta 9)
B3_PARENT_SHARED_PER_EDGE_SWEEP = 14.0


def test_edge_sass_counts_the_b3_loops(cuda):
    from ldpc_tpu_torch.scripts import edge_sass
    res = edge_sass.count()["layered"]
    for label in edge_sass.LAYERED:
        r = res[label]
        for loop in ("syndrome", "fold", "delta"):
            assert r[loop]["edges"] >= 1
        assert r["syndrome_share"] == 0.5      # row 0's fold takes it
        assert r["shared_per_edge"] < B3_PARENT_SHARED_PER_EDGE_SWEEP


# B5 and B4 before their redesign (PERF.md: edge_sass.py's analysis of the
# listing of that revision's decode.cu, nvcc 12.9): int8 min-sum 23.5 + 18
# instructions an edge, with a conversion an edge in each phase; sum-product
# 3 phi an edge, 219 (bf16) and 212 (f32) instructions
B5_PARENT_INSTRUCTIONS_PER_EDGE = 41.5
B4_PARENT_INSTRUCTIONS_PER_EDGE = {"B4 bfloat16": 219.0, "B4 float32": 212.0}


@pytest.fixture(scope="module")
def edge_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ldpc_tpu_torch.scripts import edge_sass
    return edge_sass.count()


def test_edge_sass_counts_the_b5_loops_in_integers(edge_counts):
    r = edge_counts["B5 int8"]
    for phase in ("A", "B"):
        assert r[phase]["edges"] >= 1 and r[phase]["conversions"] == 0
    assert r["instructions_per_edge"] < B5_PARENT_INSTRUCTIONS_PER_EDGE


def test_edge_sass_counts_two_phi_an_edge_in_b4(edge_counts):
    for label, r in edge_counts["sum_product"].items():
        assert r["A"]["phi_per_edge"] == 1 and r["B"]["phi_per_edge"] == 1
        assert r["instructions_per_edge"] < B4_PARENT_INSTRUCTIONS_PER_EDGE[
            label]


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


def _split_launches(cuda, code, llr, store):
    """One launch of split_r, then of split_c, after a few plain iterations
    (so that some words latch), on the same state as their plain versions:
    every array and latch equal."""
    from ldpc_tpu_torch.ops import cuda_split
    plan = DecodePlan.from_code(code)
    t = cuda_static._RefTables(plan, cuda)
    tables = torch.as_tensor(cuda_split.split_tables(plan, store),
                             device=cuda)
    s = cuda_split.SplitState.start(llr, plan, 10, store)
    for it in range(3):
        s = cuda_split.split_c_reference(
            cuda_split.split_r_reference(s, t, it), t)
    assert 0 < int(s.success.sum()) < llr.shape[0]
    n_ok = torch.zeros(11, dtype=torch.int32, device=cuda)
    want = cuda_split.split_r_reference(s, t, 3)
    cuda_split.launch("r", s, plan, tables, n_ok, 3)
    torch.cuda.synchronize()
    for name in ("rec", "xbits", "errors", "iters", "success"):
        assert torch.equal(getattr(s, name), getattr(want, name)), name
    assert int(n_ok[3]) == int(want.success.sum())
    want = cuda_split.split_c_reference(s, t)
    cuda_split.launch("c", s, plan, tables, n_ok)
    torch.cuda.synchronize()
    assert torch.equal(s.tot, want.tot)
    assert torch.equal(s.errors, want.errors)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_split_launches_match_their_plain_versions(cuda, store):
    """Near-earth: both kernels stage the word in shared memory."""
    code = near_earth_code()
    llr = _finite_llr(code.n, (2.0, 3.0, 4.0), 64, seed=9, device=cuda)
    _split_launches(cuda, code, llr, store)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_split_launches_match_their_plain_versions_on_the_giant_code(
        cuda, store):
    """synthetic_qc_code(2048, 8, 24), 64 words: split_c reads the records
    from device memory, and so does split_r the totals in f32 (in bf16
    it stages them, 96 KB, past the 48 KB opt-in)."""
    from ldpc_tpu_torch.codes import synthetic_qc_code
    code = synthetic_qc_code(2048, 8, 24)
    llr = _finite_llr(code.n, (1.1, 4.0), 32, seed=12, device=cuda)
    _split_launches(cuda, code, llr, store)


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


# --- the code search on the card: each candidate through the fused kernel --

def _env_trouble_codes():
    """Codes a search makes that the sweep never feeds the kernel (see
    tests/test_torch_dynamic.py): a check degree above 32, a block column
    of degree 0, a block row at the cap, circulants of weight 3-7."""
    ne, w = near_earth_code(), wifi_code(1944, 5 / 6)
    return [ne.replace_block(0, 3, (5, 77, 130, 201, 300, 402, 480)),
            ne.replace_block(0, 5, ()).replace_block(1, 5, ()),
            w.replace_block(0, 12, (2, 20, 33, 71)),
            w.replace_block(1, 2, (1, 7, 22)).replace_block(
                3, 6, (0, 11, 23, 40, 52, 61, 79))]


ENV_CODES = _env_trouble_codes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("idx", range(len(ENV_CODES)))
def test_env_route_matches_plain_version_and_dynamic(cuda, idx, kind):
    """The env's route on the card (the kernel, float32 state, raw
    samples) equals its plain version on every word and the dynamic
    decoder on converged words (sum-product: the plain version only)."""
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    from ldpc_tpu_torch.ops.dynamic import dynamic_plan, make_dynamic_decoder
    code = ENV_CODES[idx]
    env = LdpcCodeSearchEnv(code=code, device=cuda, decoder_kind=kind)
    # finite: the dynamic decoder, as the JAX one, does not sanitise
    llr = _finite_llr(code.n, (2.6, 3.2, 4.0), 16, seed=idx, device=cuda)
    key = (kind, "float32", "flooding", False)
    before = cuda_static.launches[key]
    got = env.counts_fn(code, 30)(llr)
    assert cuda_static.launches[key] == before + 1
    want = flooding_reference(llr, DecodePlan.from_code(code), 30,
                              kind=kind, store_dtype="float32")
    for g, w in zip((got.errors, got.iterations, got.success), want):
        assert torch.equal(g, w)
    if kind == "sum-product":
        return
    res = make_dynamic_decoder(code.z, code.block_rows, code.block_cols,
                               48, 18, 30, kind=kind)(
        dynamic_plan(code, 48, 18, device=cuda), llr)
    conv = got.success | res.success
    assert torch.equal(got.success[conv], res.success[conv])
    assert torch.equal(got.errors[conv],
                       res.hard.sum(-1, dtype=torch.int32)[conv])
    assert torch.equal(got.iterations[conv], res.iterations[conv])
    assert bool(conv.any())


def test_env_steps_decode_each_code_with_no_rebuild(cuda):
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    from ldpc_tpu_torch.rl import run_random_agent
    env = LdpcCodeSearchEnv(device=cuda)
    key = ("min-sum", "float32", "flooding", False)
    before = cuda_static.launches[key]
    rewards, env = run_random_agent(env, num_steps=4, seed=42)
    lib = cuda_static._LIB
    assert lib is not None and len(rewards) == 4
    legal = sum(r != env.reward_for_illegal_action for r in rewards)
    assert cuda_static.launches[key] - before == legal
    run_random_agent(env, num_steps=2, seed=43)
    assert cuda_static._LIB is lib


@pytest.mark.parametrize("phase1", [2, 6])
def test_env_staged_equals_single_pass_on_card(cuda, phase1):
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    kw = dict(code=wifi_code(), snr_points=(2.0, 3.4),
              num_transmissions=(32, 224), num_iterations=20, seed=5,
              device=cuda)
    plain = LdpcCodeSearchEnv(**kw)
    staged = LdpcCodeSearchEnv(phase1_iterations=phase1, **kw)
    row = np.zeros(plain.z, np.int32)
    row[[1, 9, 30]] = 1
    a = np.concatenate([np.zeros(plain.x_bits + plain.y_bits, np.int32),
                        row])
    _, r0, _, i0 = plain.step(a)
    _, r1, _, i1 = staged.step(a)
    assert r0 == r1
    assert i0["accumulated_iterations"] == i1["accumulated_iterations"]
    for col in ("errors_decoded", "iterations", "success"):
        assert np.array_equal(plain.ber_stats.column(col),
                              staged.ber_stats.column(col))


def test_env_vector_batched_equals_sequential_on_card(cuda):
    from ldpc_tpu_torch.envs import EnvironmentVector, LdpcCodeSearchEnv

    def fns():
        return [(lambda s=s: LdpcCodeSearchEnv(seed=s, device=cuda))
                for s in range(4)]

    seq = EnvironmentVector(fns(), batched=False)
    bat = EnvironmentVector(fns(), batched=True)
    rng = np.random.RandomState(0)
    env0 = seq.envs[0]
    for _ in range(2):
        actions = []
        for _ in range(4):
            row = np.zeros(env0.z, np.int32)
            row[rng.choice(env0.z, rng.randint(1, 8), replace=False)] = 1
            actions.append(np.concatenate(
                [[rng.randint(2)], [int(b) for b in np.binary_repr(
                    rng.randint(16), 4)], row]).astype(np.int32))
        o1, r1, d1, i1 = seq.step(actions)
        o2, r2, d2, i2 = bat.step(actions)
        assert np.array_equal(o1, o2) and np.array_equal(r1, r2)
        assert list(d1) == list(d2)
        for es, eb in zip(seq.envs, bat.envs):
            assert es.state == eb.state
            assert es.accumulated_iterations == eb.accumulated_iterations


def test_env_raises_where_the_kernel_refuses_a_candidate(cuda):
    from ldpc_tpu_torch.codes import synthetic_qc_code
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    code = synthetic_qc_code(2048, 8, 24)
    env = LdpcCodeSearchEnv(code=code, num_transmissions=1, device=cuda)
    a = np.zeros(env.action_bits, np.int32)
    a[env.x_bits + env.y_bits + 7] = 1
    with pytest.raises(NotImplementedError, match="shared memory"):
        env.step(a)


def _trainer_env_fn(cuda, seed):
    from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
    return lambda: LdpcCodeSearchEnv(
        code=wifi_code(), snr_points=(3.0, 3.5), num_transmissions=2,
        num_iterations=5, seed=seed, dmax_cn_cap=32, dmax_vn_cap=12,
        device=cuda)


_TRAINER_AC = dict(hidden=16, row_range=4, col_range=24, z=81, max_hot=4)


@pytest.mark.parametrize("batched", [False, True])
def test_trainer_resume_is_exact_on_card(cuda, tmp_path, batched):
    """PPO on the card, 2 envs, each candidate decoded by the fused
    kernel: 3 epochs equal, byte for byte, 1 epoch resumed to 3; batched
    vector steps write what sequential ones do."""
    from ldpc_tpu_torch.rl import ActorCriticConfig, PPOConfig, ppo
    env_fn = _trainer_env_fn(cuda, 6)
    ac = ActorCriticConfig(obs_dim=env_fn().observation_space.shape[0],
                           **_TRAINER_AC)

    def run(epochs, name, resume=False, env_batched=batched):
        cfg = PPOConfig(steps_per_epoch=2, epochs=epochs, train_pi_iters=2,
                        train_v_iters=2, save_freq=1, seed=13)
        actor, _, _ = ppo(env_fn, cfg, ac, num_envs=2,
                          env_batched=env_batched,
                          output_dir=tmp_path / name,
                          checkpoint_dir=tmp_path / f"ckpt_{name}",
                          resume=resume, device=cuda)
        assert next(actor.parameters()).is_cuda
        return (tmp_path / name / "steps.tsv").read_text()

    cuda_static.launches.clear()
    full = run(3, "full")
    assert cuda_static.launches.get(
        ("min-sum", "float32", "flooding", False), 0) > 0
    run(1, "split")
    assert run(3, "split", resume=True) == full
    if batched:
        assert run(3, "seq", env_batched=False) == full


def test_trainer_policy_on_card_matches_cpu(cuda):
    """Full width: the same weights on the card and on the CPU give
    evaluate_actions within the CPU tests' tolerance (rtol 1e-5, atol
    1e-4), the same mode, the same value loss (1e-5 relative above 1), and
    the same gradients of a policy and a value step from fresh weights
    (``scripts/grad_parity.py`` at its defaults): each element within 1e-4
    of its CPU value plus 3e-5 of its tensor's largest |gradient|
    (chip_smoke.py's GRAD_RTOL, GRAD_ATOL).  The gradients are held on the
    observations / 255, as the CPU update test's are: on raw bytes nearly
    every first-layer unit of fresh weights sits in tanh's flat tail on
    every row, where the two devices' float32 tanh differ in the last
    place and that difference is the whole gradient.  chip_smoke.py phase
    14 (c) holds the trained policy's gradients on the trainer's raw-byte
    observations."""
    from ldpc_tpu_torch.rl import (ActorCriticConfig, PPOConfig,
                                   env_generators, evaluate_actions,
                                   init_params, make_update_fns,
                                   sample_step)
    from ldpc_tpu_torch.scripts import grad_parity
    cfg = ActorCriticConfig()
    a_cpu, c_cpu = init_params(cfg, seed=2, device="cpu")
    a_gpu, c_gpu = init_params(cfg, seed=2, device=cuda)
    rng = np.random.default_rng(0)
    obs = torch.tensor(rng.integers(0, 256, (16, cfg.obs_dim)).astype(
        np.float32))
    act = sample_step(cfg, a_gpu, c_gpu, obs.to(cuda),
                      env_generators(1, 16, cuda))[0]
    got = evaluate_actions(cfg, a_gpu, obs.to(cuda), act)
    want = evaluate_actions(cfg, a_cpu, obs, act.cpu())
    for k in ("logp", "logp_per_head", "entropy", "entropy_per_head"):
        np.testing.assert_allclose(got[k].detach().cpu().numpy(),
                                   want[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=k)
    assert torch.equal(
        sample_step(cfg, a_gpu, c_gpu, obs.to(cuda), deterministic=True)[0]
        .cpu(), sample_step(cfg, a_cpu, c_cpu, obs, deterministic=True)[0])
    _, vf_opt, _, v_up = make_update_fns(cfg, PPOConfig())
    ret = torch.tensor(rng.standard_normal(16).astype(np.float32))
    l_gpu = v_up(c_gpu, vf_opt(c_gpu.parameters()), obs.to(cuda),
                 ret.to(cuda))
    l_cpu = v_up(c_cpu, vf_opt(c_cpu.parameters()), obs, ret)
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * max(1.0, float(l_cpu))
    grads = grad_parity.measure(seed=2, rows=16, rtol=1e-4, atol=3e-5)
    scaled = grads["scales"]["obs/255"]
    assert len(scaled["params"]) == len(list(a_cpu.parameters())) + len(
        list(c_cpu.parameters()))
    assert scaled["max_excess"] <= 1.0, scaled


# The Monte-Carlo validation path (encoder, sort_words, host-staged counts)

VALIDATION_CODES = {"near-earth": near_earth_code,
                    "wifi-r1/2": lambda: wifi_code(1944, 1 / 2),
                    "column-pivoted": lambda: zero_circulant(
                        near_earth_code(), 0, 0)}


@pytest.mark.parametrize("name", list(VALIDATION_CODES))
def test_encoder_syndrome_zero_and_card_equals_cpu(cuda, name):
    """Every codeword encoded on the card satisfies H (the plan's sparse
    tables) and equals the CPU's bit for bit: the float32 product is
    exact."""
    from ldpc_tpu_torch.codes.encode import encoder_for_code
    from ldpc_tpu_torch.ops.plan import frame_indices
    code = VALIDATION_CODES[name]()
    enc = encoder_for_code(code)
    gen = torch.Generator(device=cuda).manual_seed(3)
    msgs = torch.randint(0, 2, (512, enc.k_eff), generator=gen,
                         dtype=torch.int8, device=cuda)
    cw = enc(msgs)
    f = frame_indices(DecodePlan.from_code(code))
    var = torch.as_tensor(f["var_idx"], device=cuda)
    valid = torch.as_tensor(f["cn_valid"], device=cuda)
    assert not ((cw[:, var].long() * valid).sum(-1) % 2).any()
    assert torch.equal(cw.cpu(), enc(msgs.cpu()))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sort_words_is_bit_identical_on_card(cuda, engine):
    code = near_earth_code()
    llr = _llr(code.n, [3.0, 3.4], 256, 21, cuda)
    kw = dict(phase1_iters=12, engine=engine, device=cuda)
    want = make_staged_decoder_device(code, 50, **kw)(llr)
    got = make_staged_decoder_device(code, 50, sort_words=True, **kw)(llr)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pad_to", [1, 3, 256])
def test_staged_decode_counts_pad_to_on_card(cuda, pad_to):
    """Host-staged counts equal the cascade on the kernel, whole-batch
    redo (3.0 dB) and chunked redo (3.6 dB) alike."""
    from ldpc_tpu_torch.sim.evaluate import staged_decode_counts
    code = near_earth_code()
    for snr in (3.0, 3.6):
        llr = _llr(code.n, [snr], 512, 22, cuda)
        want = make_staged_decoder_device(code, 50, phase1_iters=12,
                                          engine="cuda", device=cuda)(llr)
        got = staged_decode_counts(code, llr, 50, phase1_iters=12,
                                   pad_to=pad_to, engine="cuda")
        for g, w in zip(got, want):
            assert np.array_equal(g, w.cpu().numpy())
