"""The port's near-earth generator and systematic encoder against the JAX
package's, on the same numpy messages: near-earth (the shipped generator),
the 802.11n rates (the parity part from H), a singular parity square (the
column-pivoted fallback) and a rank-deficient H (the cases of
tests/test_codes.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.codes.ccsds import \
    near_earth_generator_rows as jax_generator_rows
from ldpc_tpu.codes.encode import encoder_for_code as jax_encoder_for_code
from ldpc_tpu.codes.encode import \
    systematic_encoder_from_h as jax_systematic_encoder
from ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ldpc_tpu_torch.codes import QCCode, near_earth_code, wifi_code
from ldpc_tpu_torch.codes.ccsds import (K, near_earth_generator_dense,
                                        near_earth_generator_rows)
from ldpc_tpu_torch.codes.encode import (encode, encoder_for_code,
                                         make_encoder, parity_part_from_h,
                                         systematic_encoder_from_h)

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

SINGULAR = (((0,), (1,), (0, 2)),)   # z = 4: I + P^2 squares to zero


def _msgs(b, k, seed):
    return np.random.default_rng(seed).integers(0, 2, (b, k)).astype(np.int8)


def _syndromes(code, cw):
    h = code.to_dense(np.int64)
    return (h @ np.asarray(cw, np.int64).T) % 2


def test_generator_rows_equal_jax_and_h_gt_is_zero():
    rows = near_earth_generator_rows()
    assert rows.shape == (14, 2, 511)
    assert np.array_equal(rows, jax_generator_rows())
    g = near_earth_generator_dense()
    assert g.shape == (7154, 8176)
    assert np.array_equal(g[:, :K], np.eye(K, dtype=np.int8))
    pick = np.random.default_rng(0).choice(K, 48, replace=False)
    assert not _syndromes(near_earth_code(), g[pick]).any()


def _case(name):
    if name == "near-earth":
        return near_earth_code(), jax_near_earth()
    if name == "singular":
        return QCCode(z=4, shifts=SINGULAR), JaxQCCode(z=4, shifts=SINGULAR)
    rate = {"r1/2": 1 / 2, "r2/3": 2 / 3, "r3/4": 3 / 4, "r5/6": 5 / 6}[name]
    return wifi_code(1944, rate), jax_wifi_code(1944, rate)


@pytest.mark.parametrize("name", ["near-earth", "r1/2", "r2/3", "r3/4",
                                  "r5/6", "singular"])
def test_encoder_matches_jax(name):
    code, jcode = _case(name)
    enc, jenc = encoder_for_code(code), jax_encoder_for_code(jcode)
    assert enc.k_eff == jenc.k_eff
    if hasattr(jenc, "info_positions"):
        assert np.array_equal(enc.info_positions, jenc.info_positions)
        assert np.array_equal(enc.parity_positions, jenc.parity_positions)
    else:
        assert np.array_equal(enc.info_positions, np.arange(enc.k_eff))
    msgs = _msgs(6, enc.k_eff, 3)
    got = enc(torch.from_numpy(msgs)).numpy()
    want = np.asarray(jenc(jnp.asarray(msgs)))
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert not _syndromes(code, got).any()
    assert np.array_equal(got[:, enc.info_positions], msgs)


def test_singular_parity_square_takes_the_column_pivoted_path():
    code = QCCode(z=4, shifts=SINGULAR)
    with pytest.raises(ValueError, match="singular"):
        parity_part_from_h(code.to_dense())
    enc = encoder_for_code(code)
    assert not np.array_equal(enc.info_positions, np.arange(enc.k_eff))


def test_rank_deficient_h_matches_jax():
    """A dependent fifth row: k_eff = n - rank, every row of H (the
    dependent one too) satisfied, as in the JAX package."""
    rng = np.random.RandomState(0)
    base = rng.randint(0, 2, size=(4, 12)).astype(np.uint8)
    h = np.vstack([base, (base[0] ^ base[1])[None]])
    enc, jenc = systematic_encoder_from_h(h), jax_systematic_encoder(h)
    assert enc.k_eff == jenc.k_eff == 8
    assert np.array_equal(enc.info_positions, jenc.info_positions)
    assert np.array_equal(enc.parity_positions, jenc.parity_positions)
    msgs = _msgs(7, enc.k_eff, 4)
    got = enc(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(got, np.asarray(jenc(jnp.asarray(msgs))))
    assert not ((h.astype(np.int64) @ got.T.astype(np.int64)) % 2).any()


def test_make_encoder_and_encode_on_the_cpu():
    code = wifi_code(1944, 1 / 2)
    a = parity_part_from_h(code.to_dense())
    msgs = _msgs(3, a.shape[0], 5)
    direct = make_encoder(a)(torch.from_numpy(msgs))
    assert torch.equal(direct, encode(code, msgs, device="cpu"))
    assert encode(code, torch.from_numpy(msgs)).device.type == "cpu"


def test_encoder_is_exact_under_autocast():
    """A half-precision product would round the row sums; the encoder runs
    its product with autocast off."""
    code = near_earth_code()
    enc = encoder_for_code(code)
    msgs = torch.ones(2, enc.k_eff, dtype=torch.int8)
    want = enc(msgs)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = enc(msgs)
    assert torch.equal(got, want)
    assert not _syndromes(code, got.numpy()).any()


def test_encoder_for_code_is_cached_and_bounded():
    import importlib
    mod = importlib.import_module("ldpc_tpu_torch.codes.encode")
    code = wifi_code(1944, 5 / 6)
    assert encoder_for_code(code) is encoder_for_code(code)
    assert mod._ENCODERS.maxsize == 8
