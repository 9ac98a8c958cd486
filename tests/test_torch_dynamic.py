"""The port's dynamic-plan decoder (``ops/dynamic.py``) against the JAX
package's on the same numpy LLRs, and the fused kernel's plain version
against it on the codes a code search makes.

* ``dynamic_plan`` is equal array for array.
* The min-sum family (min-sum, normalized, offset): converged words are
  exact on (hard bits, iterations, success).  The non-converged words
  agreed too on every case here, though the two add a column's messages
  in different orders (the port: from the channel, as the fused kernel;
  JAX: ``channel + (0 + messages)``), which can move a word on the edge of
  convergence at longer horizons; only the converged ones are the
  contract.
* Sum-product: statistical, as ``tests/test_torch_sum_product.py`` (XLA's
  and torch's CPU tanh/log differ in the last bits): success equal on
  every word, errors equal on words both converged, iterations different
  on at most one word.
* The multi-candidate decoder equals N single decodes, soft values
  included.
* The kernel's plain version (``flooding_reference``, float32 store, the
  env's route on the card) equals the dynamic decoder on converged words
  (on every word, in fact: they add in the same order),
  on codes the sweep never feeds the kernel: a block column whose
  circulants were all zeroed (column degree 0), a block row at the degree
  cap, circulants of weight 3-7, and near-earth with a check degree above
  32 (7 hot bits in a weight-2 circulant: 37).  The JAX dynamic decoder is
  held to the same codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.ops import dynamic as jdyn
from ldpc_tpu_torch.codes import code_from_dict, code_to_dict
from ldpc_tpu_torch.ops import dynamic as tdyn
from ldpc_tpu_torch.ops.cuda_static import flooding_reference
from ldpc_tpu_torch.ops.plan import DecodePlan

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

MINSUM = ("min-sum", "normalized-min-sum", "offset-min-sum")
CAPS = (48, 18)


def _port(jcode):
    return code_from_dict(code_to_dict(jcode))


def _raw(n, snrs, per, seed):
    """Raw BPSK samples of the all-zero word (the env's decoder input)."""
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    return np.concatenate(rows).astype(np.float32)


def _jax(jcode, llr, iters, kind="min-sum", caps=CAPS, keep_soft=False):
    dec = jdyn.make_dynamic_decoder(jcode.z, jcode.block_rows,
                                    jcode.block_cols, *caps, iters,
                                    kind=kind, keep_soft=keep_soft)
    res = dec(jdyn.dynamic_plan(jcode, *caps), jnp.asarray(llr))
    return (np.asarray(res.hard), np.asarray(res.iterations),
            np.asarray(res.success))


def _torch(code, llr, iters, kind="min-sum", caps=CAPS, keep_soft=False):
    dec = tdyn.make_dynamic_decoder(code.z, code.block_rows,
                                    code.block_cols, *caps, iters,
                                    kind=kind, keep_soft=keep_soft)
    res = dec(tdyn.dynamic_plan(code, *caps, device="cpu"),
              torch.from_numpy(llr))
    return res.hard.numpy(), res.iterations.numpy(), res.success.numpy()


def _trouble_codes():
    """(name, JAX code, degree caps): the codes of the module note."""
    ne = jax_near_earth()
    w = jax_wifi_code(1944, 5 / 6)       # row degrees 20, 20, 20, 19
    hot7 = ne.replace_block(0, 3, (5, 77, 130, 201, 300, 402, 480))
    zero_col = ne.replace_block(0, 5, ()).replace_block(1, 5, ())
    # row 0: a zero block becomes weight 4 -> degree 24, the cap
    at_cap = w.replace_block(0, 12, (2, 20, 33, 71))
    weights = w.replace_block(1, 2, (1, 7, 22)).replace_block(
        3, 6, (0, 11, 23, 40, 52, 61, 79))
    return [("ne-hot7-dc37", hot7, CAPS), ("ne-zero-column", zero_col, CAPS),
            ("wifi-row-at-cap", at_cap, (24, 8)),
            ("wifi-weight-3-7", weights, (32, 12))]


TROUBLE = _trouble_codes()


def test_trouble_codes_are_what_they_say():
    by = {name: c for name, c, _ in TROUBLE}
    assert max(by["ne-hot7-dc37"].row_degrees()) == 37
    assert min(by["ne-zero-column"].col_degrees()) == 0
    assert by["wifi-row-at-cap"].row_degrees()[0] == 24
    assert {len(b) for r in by["wifi-weight-3-7"].shifts for b in r} >= \
        {3, 7}


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("name,jcode,caps",
                         [("wifi-r1/2", jax_wifi_code(1944, 1 / 2), CAPS)] +
                         TROUBLE, ids=["wifi-r1/2"] + [t[0] for t in TROUBLE])
def test_dynamic_plan_equals_jax(name, jcode, caps, padded):
    caps = caps if padded else (None, None)
    got = tdyn.dynamic_plan(_port(jcode), *caps, device="cpu")
    want = jdyn.dynamic_plan(jcode, *caps)
    for f in ("cn_nb", "cn_shift", "cn_valid", "vn_slot", "vn_shift",
              "vn_valid"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert got.shape_key == want.shape_key


def test_dynamic_plan_and_stack_refuse_what_they_do_not_take():
    code = _port(jax_wifi_code(1944, 5 / 6))
    with pytest.raises(ValueError, match="exceed caps"):
        tdyn.dynamic_plan(code, 8, 18, device="cpu")
    a = tdyn.dynamic_plan(code, *CAPS, device="cpu")
    b = tdyn.dynamic_plan(code, 40, 18, device="cpu")
    with pytest.raises(ValueError, match="shape families"):
        tdyn.stack_plans([a, b])
    dec = tdyn.make_dynamic_decoder(code.z, code.block_rows,
                                    code.block_cols, 40, 18, 5)
    with pytest.raises(ValueError, match="shape family"):
        dec(a, torch.zeros(2, code.n))
    with pytest.raises(ValueError, match="unknown decoder kind"):
        tdyn.make_dynamic_decoder(81, 4, 24, 24, 8, 5, kind="bp")


@pytest.mark.parametrize("kind", MINSUM)
@pytest.mark.parametrize("rate,snrs", [(1 / 2, (0.5, 1.0)),
                                       (5 / 6, (2.4, 3.0))])
def test_min_sum_family_matches_jax(kind, rate, snrs):
    jcode = jax_wifi_code(1944, rate)
    llr = _raw(jcode.n, snrs, 8, seed=int(rate * 6))
    hj, ij, sj = _jax(jcode, llr, 12, kind)
    ht, it, st = _torch(_port(jcode), llr, 12, kind)
    assert np.array_equal(st, sj)
    conv = sj
    assert np.array_equal(ht[conv], hj[conv])
    assert np.array_equal(it[conv], ij[conv])
    assert 0 < conv.sum()
    # what the others show: they agreed too on every case here
    assert np.array_equal(ht, hj) and np.array_equal(it, ij)


def test_sum_product_matches_jax_in_statistics():
    jcode = jax_wifi_code(1944, 5 / 6)
    rng = np.random.default_rng(4)
    snr = 2.5
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    y = -1.0 + sigma * rng.standard_normal((12, jcode.n))
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    hj, ij, sj = _jax(jcode, llr, 10, "sum-product")
    ht, it, st = _torch(_port(jcode), llr, 10, "sum-product")
    assert np.array_equal(st, sj)
    both = st & sj
    assert np.array_equal(ht[both].sum(1), hj[both].sum(1))
    assert (it != ij).sum() <= 1
    assert st.any()


@pytest.mark.parametrize("kind", MINSUM + ("sum-product",))
def test_multi_decoder_equals_single_decodes(kind):
    base = _port(jax_wifi_code(1944, 5 / 6))
    codes = [base, base.replace_block(0, 0, (3,)),
             base.replace_block(2, 7, (1, 40, 70))]
    llrs = np.stack([_raw(base.n, (2.6, 3.2), 3, seed=s) for s in range(3)])
    if kind == "sum-product":
        llrs = llrs * 4.0
    plans = [tdyn.dynamic_plan(c, *CAPS, device="cpu") for c in codes]
    args = (base.z, base.block_rows, base.block_cols, *CAPS, 9)
    multi = tdyn.make_multi_dynamic_decoder(*args, kind=kind,
                                            keep_soft=True)(
        tdyn.stack_plans(plans), torch.from_numpy(llrs))
    single = tdyn.make_dynamic_decoder(*args, kind=kind, keep_soft=True)
    for j, plan in enumerate(plans):
        one = single(plan, torch.from_numpy(llrs[j]))
        for f in ("hard", "iterations", "success", "soft"):
            assert torch.equal(getattr(multi, f)[j], getattr(one, f)), f
    assert multi.soft.shape == (3, 6, base.n)


@pytest.mark.parametrize("name,jcode,caps", TROUBLE,
                         ids=[t[0] for t in TROUBLE])
def test_trouble_codes_plain_kernel_and_dynamic_agree(name, jcode, caps):
    """The kernel's plain version (float32 store) and the port's dynamic
    decoder on converged words, and the port's dynamic decoder against
    JAX's, converged words exact."""
    code = _port(jcode)
    near_earth = code.z == 511
    snrs = (3.0, 4.5) if near_earth else (2.6, 3.6)
    llr = _raw(code.n, snrs, 4, seed=len(name))
    ht, it, st = _torch(code, llr, 10, caps=caps)
    e, i, s = flooding_reference(torch.from_numpy(llr),
                                 DecodePlan.from_code(code), 10,
                                 store_dtype="float32")
    e, i, s = e.numpy(), i.numpy(), s.numpy()
    conv = st | s
    assert np.array_equal(s[conv], st[conv])
    assert np.array_equal(e[conv], ht[conv].sum(1))
    assert np.array_equal(i[conv], it[conv])
    assert conv.any()
    # the same order of additions: every word agrees
    assert np.array_equal(e, ht.sum(1)) and np.array_equal(i, it)
    hj, ij, sj = _jax(jcode, llr, 10, caps=caps)
    assert np.array_equal(sj, st)
    assert np.array_equal(hj[sj], ht[sj]) and np.array_equal(ij[sj], it[sj])
    if name == "ne-zero-column":
        # the variables without a check keep their channel decision
        cols = slice(5 * code.z, 6 * code.z)
        assert np.array_equal(ht[:, cols], (llr[:, cols] > 0).astype(
            np.int8))
