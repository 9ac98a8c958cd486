"""The port's codes and decode plans equal the JAX package's.

A code is the state this system carries across packages (its "weights"):
a JAX ``QCCode`` handed over as numpy first rows or as its JSON dict must
give an equal port ``QCCode``, and both packages must derive the same
decode-plan tables from it.
"""

import json

import numpy as np
import pytest

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.codes.io import save_code_json as jax_save_code_json
from ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ldpc_tpu.codes.qc import edges_by_block_col as jax_edges_col
from ldpc_tpu.codes.qc import edges_by_block_row as jax_edges_row
from ldpc_tpu.ops.plan import DecodePlan as JaxDecodePlan
from ldpc_tpu_torch.codes import (QCCode, code_from_dict, code_to_dict,
                                  load_code_json, near_earth_code,
                                  save_code_json)
from ldpc_tpu_torch.codes import ccsds
from ldpc_tpu_torch.codes.qc import edges_by_block_col, edges_by_block_row
from ldpc_tpu_torch.ops.cuda_static import kernel_tables, smem_bytes
from ldpc_tpu_torch.ops.plan import DecodePlan

_PLAN_FIELDS = ("z", "block_rows", "block_cols", "dmax_cn", "dmax_vn",
                "cn_nb", "cn_shift", "cn_valid", "vn_slot", "vn_shift",
                "vn_valid")


def _same_code(port, ref):
    assert isinstance(port, QCCode)
    assert (port.z, port.shifts, port.name, port.message_size) == \
        (ref.z, ref.shifts, ref.name, ref.message_size)
    assert (port.n, port.m, port.k, port.num_edges) == \
        (ref.n, ref.m, ref.k, ref.num_edges)


def _random_codes():
    """Random QC structures (zero blocks, weight-2 blocks, odd z), drawn as
    tests/test_pallas_static.py draws them."""
    rng = np.random.default_rng(7)
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
        out.append(JaxQCCode(z=z, shifts=tuple(shifts), name=f"rand{trial}"))
    return out


def _jax_codes():
    return [jax_near_earth(), jax_wifi_code(1944, 1 / 2)] + _random_codes()


def test_near_earth_shift_table_equals_jax():
    _same_code(near_earth_code(), jax_near_earth())
    assert (ccsds.Z, ccsds.BLOCK_ROWS, ccsds.BLOCK_COLS) == (511, 2, 16)
    assert (ccsds.N, ccsds.M, ccsds.K) == (8176, 1022, 7154)


@pytest.mark.parametrize("ref", _jax_codes(), ids=lambda c: c.name)
def test_code_carried_across_as_first_rows(ref):
    port = QCCode.from_first_rows(ref.first_rows(), name=ref.name,
                                  message_size=ref.message_size)
    _same_code(port, ref)
    assert np.array_equal(port.to_dense(), ref.to_dense())
    assert port.row_degrees() == ref.row_degrees()
    assert port.col_degrees() == ref.col_degrees()
    assert edges_by_block_row(port) == jax_edges_row(ref)
    assert edges_by_block_col(port) == jax_edges_col(ref)


@pytest.mark.parametrize("ref", _jax_codes(), ids=lambda c: c.name)
def test_code_carried_across_as_json(ref, tmp_path):
    jax_path = tmp_path / "jax.json"
    jax_save_code_json(ref, jax_path)
    doc = json.loads(jax_path.read_text())
    _same_code(code_from_dict(doc), ref)
    _same_code(load_code_json(jax_path), ref)
    port = code_from_dict(doc)
    assert code_to_dict(port) == doc
    save_code_json(port, tmp_path / "port.json")
    assert json.loads((tmp_path / "port.json").read_text()) == doc


def test_code_from_dict_rejects_other_formats():
    with pytest.raises(ValueError):
        code_from_dict({"format": "something.else", "z": 3, "shifts": [[[]]]})


@pytest.mark.parametrize("ref", _jax_codes(), ids=lambda c: c.name)
def test_decode_plan_equals_jax(ref):
    port = DecodePlan.from_code(code_from_dict(code_to_dict(ref)))
    want = JaxDecodePlan.from_code(ref)
    for f in _PLAN_FIELDS:
        assert np.array_equal(getattr(port, f), getattr(want, f)), f


@pytest.mark.parametrize("ref", _jax_codes(), ids=lambda c: c.name)
def test_kernel_tables_walk_the_tanner_graph(ref):
    """The CUDA kernel's tables, decoded back into edges, give exactly the
    nonzeros of H, and each column lists its edges in the plan's order."""
    code = code_from_dict(code_to_dict(ref))
    plan = DecodePlan.from_code(code)
    z, mb_n, nb_n = plan.z, plan.block_rows, plan.block_cols
    dc, dv = plan.dmax_cn, plan.dmax_vn
    t = kernel_tables(plan)
    assert t.dtype == np.int32
    assert t.size == mb_n * (2 + 2 * dc) + nb_n * (1 + 3 * dv)
    parts = np.split(t, np.cumsum([mb_n, mb_n, mb_n * dc, mb_n * dc, nb_n,
                                   nb_n * dv, nb_n * dv]))
    row_deg, row_base, row_nb, row_sh, col_deg, col_mb, col_d, col_sh = parts
    # the phi stash holds each block row's edges after the rows before it
    assert np.array_equal(row_base, np.cumsum(row_deg) - row_deg)
    row_nb, row_sh = row_nb.reshape(mb_n, dc), row_sh.reshape(mb_n, dc)
    col_mb, col_d = col_mb.reshape(nb_n, dv), col_d.reshape(nb_n, dv)
    col_sh = col_sh.reshape(nb_n, dv)
    h = np.zeros((code.m, code.n), np.int32)
    i = np.arange(z)
    for mb in range(mb_n):
        for d in range(row_deg[mb]):
            h[mb * z + i, row_nb[mb, d] * z + (i + row_sh[mb, d]) % z] += 1
    assert np.array_equal(h, code.to_dense())
    h_col = np.zeros_like(h)
    for nb in range(nb_n):
        for k in range(col_deg[nb]):
            mb, d = col_mb[nb, k], col_d[nb, k]
            # the column slot points back at the row slot with its shift
            assert row_nb[mb, d] == nb and row_sh[mb, d] == col_sh[nb, k]
            h_col[mb * z + (i - col_sh[nb, k]) % z, nb * z + i] += 1
        order = [(col_mb[nb, k], col_d[nb, k]) for k in range(col_deg[nb])]
        assert order == sorted(order)
    assert np.array_equal(h_col, code.to_dense())


# bytes a block: min-sum: 1,360 bytes of edge tables, padded to 16, + 1,024
# + 512 of packed column and row tables + 1,022 records of 16 bytes + 2 x
# 8,176 x the store's width (chan, totals); sum-product: the tables + 64
# block-edge and 64 column entries of 16 bytes + 1,022 x (8-byte record +
# parity word) + 64 x 512 f32 (the plane, z rounded up to even) + 2 x
# 8,176 x width
@pytest.mark.parametrize("kind,store,total", [
    ("min-sum", "bfloat16", 51952), ("normalized-min-sum", "bfloat16", 51952),
    ("min-sum", "float32", 84656), ("offset-min-sum", "float32", 84656),
    ("sum-product", "bfloat16", 179448), ("sum-product", "float32", 212152)])
def test_near_earth_state_fits_one_block(kind, store, total):
    """One word's kernel state in shared memory, edge tables included,
    under a block's 227 KB (232,448 bytes) for every variant."""
    got = smem_bytes(DecodePlan.from_code(near_earth_code()), kind, store)
    assert got == total
    assert got <= 232448 - 1024


# An H100 SM has 228 KB (233,472 bytes) of shared memory, and each block
# takes 1 KB more than it asks for.
@pytest.mark.parametrize("store,blocks", [("bfloat16", 4), ("int8", 4),
                                          ("float32", 2)])
@pytest.mark.parametrize("popcount", [False, True])
def test_near_earth_min_sum_fits_its_blocks_an_sm(store, blocks, popcount):
    """Near-earth min-sum flooding keeps four resident blocks an SM in bf16
    and int8, two in f32."""
    got = smem_bytes(DecodePlan.from_code(near_earth_code()), "min-sum",
                     store, "flooding", popcount)
    assert blocks * (got + 1024) <= 233_472

