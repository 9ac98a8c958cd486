"""Kernel B3, the layered (serial-C) schedule, against the Pallas kernel in
interpret mode, and the plain version's own contract.

Every (kind, store) pair that the JAX kernel accepts with
``schedule="layered"`` (the min-sum family in bfloat16, float32 and int8)
runs once against Pallas, the nine spread over three codes so that each
code meets each kind and each store: 802.11n rate 1/2 (12 block rows),
rate 5/6 (4 block rows) and a random QC code with zero, one- and two-shift
blocks (two edges of one row reach the same variable, so the order in which
their deltas are rounded into the totals decides the result; near-earth,
which has two shifts in every block, is in tests/test_torch_popcount.py and
tests/test_torch_int8.py).  A Pallas build in interpret mode costs 10-20 s,
so each build decodes one batch that mixes SNRs, with converged and failed
words.  Tolerance: none.  The plain version keeps the kernel's rounding
points and orders, so every word agrees on (errors, iterations, success),
converged or not.
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
from ldpc_tpu_torch.codes import near_earth_code
from ldpc_tpu_torch.ops.cuda_static import (flooding_reference,
                                            layered_reference,
                                            make_static_sweep_decoder,
                                            smem_bytes)
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

JAX_STORE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
             "int8": jnp.int8}
SNRS = {"r1/2": (-1.5, -0.5, 0.5), "r5/6": (2.5, 3.0, 3.5),
        "rand": (0.5, 2.0, 4.0)}
CASES = [("r1/2", "min-sum", "bfloat16"),
         ("r1/2", "normalized-min-sum", "int8"),
         ("r1/2", "offset-min-sum", "float32"),
         ("r5/6", "min-sum", "int8"),
         ("r5/6", "normalized-min-sum", "float32"),
         ("r5/6", "offset-min-sum", "bfloat16"),
         ("rand", "min-sum", "float32"),
         ("rand", "normalized-min-sum", "bfloat16"),
         ("rand", "offset-min-sum", "int8")]


def _llrs(n, snrs, per, seed):
    """Raw BPSK samples of the all-zero word, numpy float32, with NaN and
    +-inf entries (the kernel sanitizes them at entry)."""
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, 5] = np.nan
    llr[-1, :2] = [np.inf, -np.inf]
    return llr


def _random_jax_code():
    """z = 13, 3 block rows of 7 blocks of 0-2 shifts (the second code of
    tests/test_torch_static.py's _random_code)."""
    rng = np.random.default_rng(7)
    for z, mb, nb in [(21, 2, 6), (13, 3, 7)]:
        shifts = []
        for _ in range(mb):
            row = [tuple(sorted(rng.choice(z, size=int(rng.integers(0, 3)),
                                           replace=False).tolist()))
                   for _ in range(nb)]
            if all(len(b) == 0 for b in row):
                row[0] = (int(rng.integers(z)),)
            shifts.append(tuple(row))
    return JaxQCCode(z=z, shifts=tuple(shifts), name="rand13")


def _codes(name):
    if name == "rand":
        jcode = _random_jax_code()
        return code_from_dict(code_to_dict(jcode)), jcode
    rate = {"r1/2": 1 / 2, "r5/6": 5 / 6}[name]
    return wifi_code(1944, rate), jax_wifi_code(1944, rate)


def _assert_same(port, ref):
    pe, pi, ps = (x.numpy() for x in port)
    re, ri, rs = (np.asarray(x) for x in ref)
    assert np.array_equal(ps, rs)
    assert np.array_equal(pe, re)
    assert np.array_equal(pi, ri)


def test_random_code_has_multi_shift_blocks():
    code, _ = _codes("rand")
    assert max(len(b) for row in code.shifts for b in row) == 2


@pytest.mark.parametrize("cname,kind,store", CASES)
def test_layered_matches_pallas(cname, kind, store):
    code, jcode = _codes(cname)
    llr = _llrs(code.n, SNRS[cname], 4, seed=len(cname) + len(kind))
    ref = jax_static_decoder(jcode, max_iters=8, tile_b=12,
                             store_dtype=JAX_STORE[store], kind=kind,
                             schedule="layered",
                             interpret=True)(jnp.asarray(llr))
    got = make_static_sweep_decoder(code, 8, kind=kind, store_dtype=store,
                                    schedule="layered",
                                    device="cpu")(torch.from_numpy(llr))
    _assert_same(got, ref)
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("store", ["bfloat16", "float32", "int8"])
def test_layered_needs_fewer_sweeps(store):
    """The serial-C schedule's point (tests/test_pallas_static.py's
    test_layered_schedule_converges_faster): fewer sweeps on average than
    flooding iterations, on the same words."""
    code = wifi_code(1944, 1 / 2)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (0.0, 0.5), 6, seed=2))
    _, it_f, ok_f = flooding_reference(llr, plan, 30, store_dtype=store)
    _, it_l, ok_l = layered_reference(llr, plan, 30, store_dtype=store)
    assert ok_l.sum() >= ok_f.sum()
    assert it_l.float().mean() < it_f.float().mean()


def test_layered_zero_sweeps_chunks_and_empty_batch():
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llrs(code.n, (3.0, 3.4), 3, seed=4))
    e, it, ok = layered_reference(llr, plan, 0)
    assert torch.equal(it, torch.zeros(6, dtype=torch.int32))
    want = (torch.nan_to_num(llr, nan=0.0) > 0).sum(-1, dtype=torch.int32)
    assert torch.equal(e, want) and not ok.any()
    whole = layered_reference(llr, plan, 6)
    parts = layered_reference(llr, plan, 6, chunk=4)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
    e, it, ok = layered_reference(llr[:0], plan, 5)
    assert e.shape == it.shape == ok.shape == (0,)


def test_layered_refuses_sum_product():
    """As the JAX kernel (pallas_static.py:740-741): ValueError."""
    code = wifi_code(1944, 1 / 2)
    with pytest.raises(ValueError, match="flooding only"):
        make_static_sweep_decoder(code, 4, kind="sum-product",
                                  schedule="layered", device="cpu")
    with pytest.raises(ValueError, match="flooding only"):
        layered_reference(torch.zeros(1, code.n), DecodePlan.from_code(code),
                          4, kind="sum-product")
    with pytest.raises(ValueError, match="unknown schedule"):
        make_static_sweep_decoder(code, 4, schedule="serial", device="cpu")


def test_layered_smem_adds_the_row_scratch():
    """One 16-byte scratch record per check of a block row (z x 16), a
    (block row, block) table of 8 bytes an entry and a block count per block
    row (4 bytes), and a (block row, slot) table of 16 bytes an entry in
    place of the (block column, slot) one: near-earth's 8,696 bytes."""
    plan = DecodePlan.from_code(near_earth_code())
    z, edges = plan.z, plan.block_rows * plan.dmax_cn
    scratch = 16 * z                                      # 8,176
    tables = (8 * edges + 4 * plan.block_rows +
              16 * edges - 16 * plan.block_cols * plan.dmax_vn)   # 520
    for store in ("bfloat16", "float32", "int8"):
        extra = (smem_bytes(plan, "min-sum", store, "layered") -
                 smem_bytes(plan, "min-sum", store))
        assert extra == scratch + tables == 8_696
    # flooding's 51,952 + the row scratch's 8,176 + the tables' 520
    assert smem_bytes(plan, "min-sum", "bfloat16", "layered") == 60_648
