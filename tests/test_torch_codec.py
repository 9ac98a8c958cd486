"""The port's codec, code formats and code archives against the JAX
package's: ``compress``/``uncompress``, ``QCCode.replace_block`` and
``from_dense``, the hex codecs, the QC text readers, the zeroed-circulant
suite and the ``.npz`` instances a search writes (cross-loaded both ways),
on near-earth, 802.11n and a shape that takes the codec's byte-aligned
fallback; and ``BoundedCache``'s eviction."""

import numpy as np
import pytest

from ldpc_tpu import codes as jcodes
from ldpc_tpu.codes import io as jio
from ldpc_tpu.codes.qc import QCCode as JaxQCCode
from ldpc_tpu.utils.cache import BoundedCache as JaxBoundedCache
from ldpc_tpu_torch import codes as tcodes
from ldpc_tpu_torch.codes import io as tio
from ldpc_tpu_torch.codes.qc import QCCode
from ldpc_tpu_torch.sim.stats import BerStatistics
from ldpc_tpu_torch.utils.cache import BoundedCache


def _fallback_shape(seed=0):
    """(Mb, Nb, Z) = (3, 5, 7): 2**ceil(log2(35)) = 64 is no multiple of 5,
    so each block's first row is byte-aligned on its own."""
    rng = np.random.default_rng(seed)
    rows = (rng.random((3, 5, 7)) < 0.3).astype(np.int32)
    return rows


def _pairs():
    """(name, JAX code, port code) with the same shift tables."""
    fb = _fallback_shape()
    return [("near-earth", jcodes.near_earth_code(),
             tcodes.near_earth_code()),
            ("wifi-r1/2", jcodes.wifi_code(1944, 1 / 2),
             tcodes.wifi_code(1944, 1 / 2)),
            ("wifi-r5/6", jcodes.wifi_code(1944, 5 / 6),
             tcodes.wifi_code(1944, 5 / 6)),
            ("fallback", JaxQCCode.from_first_rows(fb, name="fb"),
             QCCode.from_first_rows(fb, name="fb"))]


PAIRS = _pairs()
IDS = [p[0] for p in PAIRS]


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=IDS)
def test_compress_matches_jax(name, jc, tc):
    assert tc.shifts == jc.shifts
    obs = tcodes.compress(tc)
    ref = jcodes.compress(jc)
    assert obs.dtype == np.uint8 and np.array_equal(obs, ref)
    shape = (tc.block_rows, tc.block_cols, tc.z)
    assert tcodes.observation_bytes(*shape) == \
        jcodes.observation_bytes(*shape) == obs.size
    back = tcodes.uncompress(obs, *shape)
    assert back.shifts == tc.shifts
    assert back.shifts == jcodes.uncompress(ref, *shape).shifts
    if name == "near-earth":
        assert obs.size == 2048
    if name == "fallback":
        # byte-aligned blocks: one byte a 7-bit first row
        assert obs.size == 3 * 5


def test_uncompress_rejects_a_wrong_size():
    tc = tcodes.wifi_code()
    obs = tcodes.compress(tc)
    with pytest.raises(ValueError, match="bytes"):
        tcodes.uncompress(obs[:-1], tc.block_rows, tc.block_cols, tc.z)


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=IDS)
@pytest.mark.parametrize("how", ["binary", "shifts", "empty"])
def test_replace_block_matches_jax(name, jc, tc, how):
    rng = np.random.default_rng(len(name))
    mb, nb = tc.block_rows - 1, tc.block_cols // 2
    if how == "binary":
        arg = np.zeros(tc.z, np.int32)
        arg[rng.choice(tc.z, 3, replace=False)] = 1
    elif how == "shifts":
        arg = sorted(rng.choice(tc.z, 2, replace=False).tolist())
    else:
        arg = ()
    got = tc.replace_block(mb, nb, arg)
    want = jc.replace_block(mb, nb, arg)
    assert got.shifts == want.shifts
    assert got.shifts[mb][nb] == tuple(int(s) for s in (
        np.flatnonzero(arg) if how == "binary" else arg))
    assert tc.shifts == jc.shifts            # pure: the original is kept


@pytest.mark.parametrize("name,jc,tc", PAIRS[1:], ids=IDS[1:])
def test_from_dense_matches_jax(name, jc, tc):
    h = tc.to_dense()
    got = QCCode.from_dense(h, tc.z)
    assert got.shifts == JaxQCCode.from_dense(h, jc.z).shifts == tc.shifts
    bad = h.copy()
    bad[1, 0] ^= 1
    with pytest.raises(ValueError, match="block-circulant"):
        QCCode.from_dense(bad, tc.z)
    with pytest.raises(ValueError, match="multiple"):
        QCCode.from_dense(h[:, :-1], tc.z)


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=IDS)
def test_hex_codecs_match_jax(name, jc, tc):
    assert tio.code_hex_name(tc) == jio.code_hex_name(jc)
    bits = np.random.default_rng(3).integers(0, 2, 4 * 37)
    hx = tio.bits_to_hex(bits)
    assert hx == jio.bits_to_hex(bits)
    assert np.array_equal(tio.hex_to_bits(hx + "\n"), bits)
    assert np.array_equal(tio.hex_to_bits("x" + hx.lower()),
                          jio.hex_to_bits("x" + hx.lower()))
    assert tio.hex_to_bits("").size == 0
    with pytest.raises(ValueError):
        tio.bits_to_hex(bits[:5])


def test_qc_text_readers_match_jax(tmp_path):
    tc = tcodes.near_earth_code()
    parity = tmp_path / "parity.txt"
    parity.write_text("\n".join(
        ",".join(str(s) for s in tc.shifts[mb][nb])
        for mb in range(tc.block_rows) for nb in range(tc.block_cols)) +
        "\n")
    got = tio.read_qc_parity(parity, 2, 16, 511, message_size=7154)
    want = jio.read_qc_parity(parity, 2, 16, 511, message_size=7154)
    assert got.shifts == want.shifts == tc.shifts
    assert got.name == want.name and got.k == 7154
    with pytest.raises(ValueError, match="lines"):
        tio.read_qc_parity(parity, 2, 15, 511)
    # a hex generator of 2 block rows, z = 11 (pad 1 bit a line)
    z, k = 11, 22
    rng = np.random.default_rng(5)
    lines = [tio.bits_to_hex(np.concatenate(
        [[0], rng.integers(0, 2, z)])) for _ in range(2 * (k // z))]
    gen = tmp_path / "gen.txt"
    gen.write_text("\n".join(lines) + "\n")
    rows = tio.read_qc_generator_rows(gen, k, z)
    assert np.array_equal(rows, jio.read_qc_generator_rows(gen, k, z))
    dense = tio.read_dense_generator(gen, k, k + 2 * z, z)
    assert np.array_equal(dense, jio.read_dense_generator(gen, k, k + 2 * z,
                                                          z))
    assert np.array_equal(dense[:, :k], np.eye(k, dtype=np.int8))


def _stats(n):
    st = BerStatistics(n)
    rng = np.random.default_rng(0)
    b = 6
    st.add_batch(snr=np.repeat([3.0, 3.4], 3), sigma=np.full(b, 0.5),
                 sigma_actual=rng.uniform(0.4, 0.6, b),
                 errors_uncoded=rng.integers(0, 50, b),
                 errors_decoded=rng.integers(0, 5, b),
                 iterations=rng.integers(1, 50, b), max_iterations=50,
                 success=rng.random(b) < 0.5)
    return st


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=IDS)
def test_code_instances_cross_load(tmp_path, name, jc, tc):
    """An archive the port writes loads in the JAX package and the other
    way round, shift tables and stats equal."""
    a = tmp_path / "port"
    b = tmp_path / "jax"
    st = _stats(tc.n)
    fa = tio.save_code_instance(tc, a, stats=st, evaluation_time=1.5)
    fb = jio.save_code_instance(jc, b, stats=st, evaluation_time=1.5)
    assert fa == fb                     # the same content-addressed name
    jcode, jpay = jio.load_code_instance(a / f"{fa}.npz")
    tcode, tpay = tio.load_code_instance(b / f"{fb}.npz")
    assert jcode.shifts == tc.shifts and tcode.shifts == jc.shifts
    assert tcode.name == jcode.name
    assert sorted(tpay) == sorted(jpay)
    for k in tpay:
        assert np.array_equal(tpay[k], jpay[k]), k


def test_code_instance_mat_cross_loads(tmp_path):
    tc = tcodes.wifi_code()
    f = tio.save_code_instance(tc, tmp_path, fmt="mat", file_name="wifi")
    jcode, _ = jio.load_code_instance(tmp_path / f"{f}.mat")
    tcode, _ = tio.load_code_instance(tmp_path / f"{f}.mat")
    assert jcode.shifts == tcode.shifts == tc.shifts
    with pytest.raises(ValueError, match="format"):
        tio.save_code_instance(tc, tmp_path, fmt="csv")


@pytest.mark.parametrize("name,jc,tc", PAIRS[1:], ids=IDS[1:])
def test_perturb_suite_matches_jax(tmp_path, name, jc, tc):
    got = list(tcodes.zeroed_circulant_suite(tc))
    want = list(jcodes.zeroed_circulant_suite(jc))
    assert len(got) == tc.block_rows * tc.block_cols
    for (mb, nb, c), (jmb, jnb, jcd) in zip(got, want):
        assert (mb, nb) == (jmb, jnb) and c.shifts == jcd.shifts
        assert c.shifts[mb][nb] == ()
    names = tcodes.write_suite(tc, tmp_path)
    assert names == jcodes.write_suite(jc, tmp_path / "jax")
    loaded, _ = jio.load_code_instance(tmp_path / f"{names[1]}.npz")
    assert loaded.shifts == got[1][2].shifts


@pytest.mark.parametrize("cls", [BoundedCache, JaxBoundedCache])
def test_bounded_cache_evicts_least_recently_used(cls):
    c = cls(maxsize=3)
    for k in "abc":
        c[k] = k.upper()
    assert c["a"] == "A"                # a is now the most recent
    c["d"] = "D"                        # evicts b, the least recent
    assert list(c) == ["c", "a", "d"]
    assert c.get("b") is None and c.get("b", 7) == 7
    assert c.get("c") == "C"            # get refreshes too
    c["e"] = "E"
    assert list(c) == ["d", "c", "e"]   # a went
    assert len(c) == 3 and c.maxsize == 3


def test_bounded_cache_bounds_the_port_plan_cache():
    from ldpc_tpu_torch.ops import decoder
    assert isinstance(decoder._PLANS, BoundedCache)
    base = tcodes.wifi_code()
    for s in range(decoder._PLANS.maxsize + 5):
        decoder._plan_for_code(base.replace_block(0, 0, (s % base.z,))
                               if s < base.z else
                               base.replace_block(1, 0, (s % base.z,)))
    assert len(decoder._PLANS) == decoder._PLANS.maxsize
