"""Kernel B7, the phase-split decoder (``ops/cuda_split.py``), the synthetic
QC codes that only it decodes on the card, and kernel B8, the barrier probe
behind ``dep_stride``, against the JAX package on the CPU.

The plain version ``split_reference`` is held to JAX's
``make_split_sweep_decoder`` in interpret mode on the same numpy LLRs, on
every word, converged or not: 802.11n rate 5/6 at 2.0 dB with bf16 state
(the input of JAX's own split test, tests/test_pallas_static.py, where
most words fail within 8 iterations), rate 1/2 with f32 state, and a small
synthetic code.  The plain versions of one launch of each kernel
(``split_r_reference``, ``split_c_reference``), looped as the host loop
runs the kernels, give ``split_reference`` again.  Tolerance: none.  Each
JAX decode runs once per module.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import synthetic_qc_code as jax_synthetic_qc_code
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.ops.pallas_split import \
    make_split_sweep_decoder as jax_split_decoder
from ldpc_tpu.sim.evaluate import \
    make_staged_decoder_device as jax_staged_decoder
from ldpc_tpu.sim.evaluate import make_staged_sweep_device as jax_staged_sweep
from ldpc_tpu_torch.codes import (near_earth_code, synthetic_qc_code,
                                  wifi_code)
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_split import (SplitState, least_bytes,
                                           make_split_sweep_decoder,
                                           split_c_reference,
                                           split_r_reference,
                                           split_reference, state_bytes)
from ldpc_tpu_torch.ops.cuda_static import (barrier_lowers, barrier_probe,
                                            flooding_reference,
                                            make_static_sweep_decoder)
from ldpc_tpu_torch.ops.plan import DecodePlan
from ldpc_tpu_torch.scripts import split_ab
from ldpc_tpu_torch.sim.evaluate import (make_staged_decoder_device,
                                         make_staged_sweep_device)

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

MAX_ITERS = 8
# (name, JAX code, port code, SNR dB, words, store)
JAX_CASES = {
    "r5/6-bf16": (lambda: jax_wifi_code(), lambda: wifi_code(), 2.0, 256,
                  "bfloat16"),
    "r1/2-f32": (lambda: jax_wifi_code(1944, 1 / 2),
                 lambda: wifi_code(1944, 1 / 2), 0.0, 128, "float32"),
    "synthetic-bf16": (lambda: jax_synthetic_qc_code(32, 4, 12),
                       lambda: synthetic_qc_code(32, 4, 12), 1.0, 128,
                       "bfloat16"),
}


def _llr(n, snr, b, seed=5):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    return (-1.0 + sigma * rng.standard_normal((b, n))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_split_outputs():
    """JAX's split decoder, interpret mode, on each case's LLRs: computed
    once for the module."""
    out = {}
    for name, (jax_code, code, snr, b, store) in JAX_CASES.items():
        llr = _llr(code().n, snr, b)
        dec = jax_split_decoder(jax_code(), MAX_ITERS, tile_b=128,
                                store_dtype=jnp.dtype(store), interpret=True)
        out[name] = (llr, [np.asarray(x) for x in dec(jnp.asarray(llr))])
    return out


@pytest.mark.parametrize("z,rows,cols,col_weight,seed", [
    (32, 4, 12, 3, 0), (7, 3, 9, 3, 1), (64, 6, 20, 2, 5),
    (2048, 8, 24, 3, 0), (5, 5, 5, 5, 3), (100, 4, 7, 1, 11)])
def test_synthetic_code_equals_jax(z, rows, cols, col_weight, seed):
    mine = synthetic_qc_code(z, rows, cols, col_weight=col_weight, seed=seed)
    ref = jax_synthetic_qc_code(z, rows, cols, col_weight=col_weight,
                                seed=seed)
    assert mine.shifts == ref.shifts
    assert mine.name == ref.name
    assert mine.z == ref.z
    named = synthetic_qc_code(z, rows, cols, col_weight=col_weight,
                              seed=seed, name="mine")
    assert named.name == jax_synthetic_qc_code(
        z, rows, cols, col_weight=col_weight, seed=seed, name="mine").name


def test_synthetic_code_raises_as_jax():
    with pytest.raises(ValueError) as ref:
        jax_synthetic_qc_code(16, 2, 6, col_weight=3)
    with pytest.raises(ValueError) as mine:
        synthetic_qc_code(16, 2, 6, col_weight=3)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_split_reference_equals_jax_split(jax_split_outputs, case):
    """Every word, converged or not; each case has failed words."""
    _, code, _, _, store = JAX_CASES[case]
    llr, want = jax_split_outputs[case]
    got = split_reference(torch.from_numpy(llr),
                          DecodePlan.from_code(code()), MAX_ITERS, store)
    assert int((~want[2].astype(bool)).sum()) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_split_reference_equals_flooding_reference(store):
    """The fused kernel's min-sum flooding plain version, near-earth, 50
    iterations, at the edge of the waterfall (some words fail)."""
    code = near_earth_code()
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llr(code.n, 3.2, 8, seed=2))
    got = split_reference(llr, plan, 50, store)
    want = flooding_reference(llr, plan, 50, store_dtype=store)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_launch_plain_versions_give_split_reference(store):
    """split_r then split_c, iteration by iteration, as the host loop
    launches the kernels, give the whole decode again; a latched word's
    state is left as it was."""
    code = synthetic_qc_code(32, 4, 12)
    plan = DecodePlan.from_code(code)
    llr = torch.from_numpy(_llr(code.n, 1.0, 16, seed=4))
    t = cuda_static._RefTables(plan, llr.device)
    s = SplitState.start(llr, plan, MAX_ITERS, store)
    for it in range(MAX_ITERS + 1):
        before = s
        s = split_r_reference(s, t, it)
        done = before.success.bool()
        for name in ("rec", "xbits", "errors", "iters"):
            assert torch.equal(getattr(s, name)[done],
                               getattr(before, name)[done])
        if it == MAX_ITERS:
            break
        s = split_c_reference(s, t)
    want = split_reference(llr, plan, MAX_ITERS, store)
    assert 0 < int(want[2].sum()) < llr.shape[0]
    for g, w in zip((s.errors, s.iters, s.success.bool()), want):
        assert torch.equal(g, w)


def test_split_decoder_on_cpu_is_the_plain_version():
    code = wifi_code(1944, 1 / 2)
    llr = torch.from_numpy(_llr(code.n, 0.0, 128, seed=6))
    dec = make_split_sweep_decoder(code, MAX_ITERS, device="cpu")
    got = dec(llr)
    want = split_reference(llr, dec.plan, MAX_ITERS)
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool]
    for g, w in zip(got, want):
        assert g.shape == (128,)
        assert torch.equal(g, w)


def test_split_decoder_refuses_as_jax():
    """B % tile_b: ValueError; an integer store: NotImplementedError
    (float-storage only), as JAX's split decoder."""
    code = wifi_code()
    dec = make_split_sweep_decoder(code, 4, tile_b=128, device="cpu")
    with pytest.raises(ValueError, match="tile_b"):
        dec(torch.zeros(100, code.n))
    dec = make_split_sweep_decoder(code, 4, tile_b=4, device="cpu")
    assert dec(torch.zeros(8, code.n))[2].all()
    with pytest.raises(NotImplementedError) as ref:
        jax_split_decoder(jax_wifi_code(), 4, store_dtype=jnp.int8,
                          interpret=True)
    with pytest.raises(type(ref.value), match="float-storage only"):
        make_split_sweep_decoder(code, 4, store_dtype="int8", device="cpu")
    with pytest.raises(ValueError):
        make_split_sweep_decoder(code, 4, store_dtype="float16",
                                 device="cpu")
    with pytest.raises(TypeError):
        dec(torch.zeros(4, code.n, dtype=torch.float64))
    with pytest.raises(ValueError):
        dec(torch.zeros(4, code.n + 1))


def test_state_bytes():
    """A near-earth word's state in device memory (bf16: the channel and
    the totals, 2 bytes a variable each, one 16-byte record a check and 3
    int32 latches: 49,068 bytes) and what each launch moves, and a giant
    synthetic code's, which no block's shared memory holds."""
    ne = DecodePlan.from_code(near_earth_code())
    frame, records = 2 * 8176, 16 * 1022
    assert state_bytes(ne)["word"] == 2 * frame + records + 12 == 49068
    # split_r: the totals in, the records in and out, the latches
    assert state_bytes(ne)["split_r"] == frame + 2 * records + 12
    # split_c: the channel in, the totals out, the records in, the errors
    assert state_bytes(ne)["split_c"] == 2 * frame + records + 4
    assert state_bytes(ne, "float32")["word"] == 4 * frame + records + 12
    giant = DecodePlan.from_code(synthetic_qc_code(2048, 8, 24))
    assert state_bytes(giant)["word"] == 2 * 2 * 49152 + 16 * 16384 + 12
    assert cuda_static.smem_bytes(giant) > cuda_static._MAX_SMEM
    assert state_bytes(giant, "float32")["word"] == 4 * 2 * 49152 + \
        16 * 16384 + 12


@pytest.mark.parametrize("store, width", [("bfloat16", 2), ("float32", 4)])
def test_least_bytes(store, width):
    """The bound's bytes: a near-earth check (degree 32) holds 32 sign
    bits, m1 and m2 without their sign bits and a 5-bit argmin, 67 bits in
    bf16 and 99 in f32, fewer than its record's 16 bytes and, in bf16,
    than the 12 bytes of the planes before the record; a giant synthetic
    code's checks (degree 9) hold 43 bits in bf16."""
    ne = DecodePlan.from_code(near_earth_code())
    bits = 32 + 2 * (8 * width - 1) + 5
    state = -(-1022 * bits // 8)
    frame = width * 8176
    lb, sb = least_bytes(ne, store), state_bytes(ne, store)
    assert lb == {"state": state, "split_r": frame + 2 * state + 12,
                  "split_c": 2 * frame + state + 4}
    assert state < 16 * 1022
    assert lb["split_r"] < sb["split_r"] and lb["split_c"] < sb["split_c"]
    if store == "bfloat16":
        assert state < 12 * 1022
    giant = DecodePlan.from_code(synthetic_qc_code(2048, 8, 24))
    assert least_bytes(giant, store)["state"] == \
        -(-16384 * (9 + 2 * (8 * width - 1) + 4) // 8)


def test_barrier_probe_plain_version():
    """On the CPU the probe is its plain version, x + |x|, and the barrier
    'lowers'; the kernel runs only on the card (tests/test_torch_gpu.py)."""
    x = np.linspace(-1.0, 1.0, 1024, dtype=np.float32).reshape(8, 128)
    got = barrier_probe(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, x + np.abs(x))
    assert barrier_lowers("cpu") is True
    with pytest.raises(ValueError):
        barrier_probe(torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("dep_stride", [None, 0, 4])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("fn", ["decoder", "sweep"])
def test_dep_stride_raises_as_jax(fn, engine, dep_stride):
    """The staged functions take dep_stride where JAX's take it (its pallas
    engine) and raise its exception type where it raises (its xla engine,
    even for 0); on the cuda engine dep_stride 4 decodes as 0."""
    jax_fn = {"decoder": jax_staged_decoder, "sweep": jax_staged_sweep}[fn]
    mine = {"decoder": make_staged_decoder_device,
            "sweep": make_staged_sweep_device}[fn]
    want = None
    try:
        jax_fn(jax_wifi_code(), 8, phase1_iters=3, dep_stride=dep_stride,
               engine={"torch": "xla", "cuda": "pallas"}[engine])
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        want = type(e)
    kw = dict(phase1_iters=3, engine=engine, dep_stride=dep_stride,
              device="cpu")
    if want is not None:
        with pytest.raises(want):
            mine(wifi_code(), 8, **kw)
        return
    built = mine(wifi_code(), 8, **kw)
    if fn == "decoder":
        llr = torch.from_numpy(_llr(wifi_code().n, 2.5, 8, seed=3))
        base = make_staged_decoder_device(wifi_code(), 8, phase1_iters=3,
                                          engine=engine, device="cpu")
        for g, w in zip(built(llr), base(llr)):
            assert torch.equal(g, w)


def test_static_decoder_dep_stride_decodes_as_zero():
    code = wifi_code(1944, 1 / 2)
    llr = torch.from_numpy(_llr(code.n, 0.0, 16, seed=8))
    want = make_static_sweep_decoder(code, MAX_ITERS, device="cpu")(llr)
    for ds in (0, 4):
        got = make_static_sweep_decoder(code, MAX_ITERS, dep_stride=ds,
                                        device="cpu")(llr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_split_ab_on_cpu(monkeypatch, capsys):
    """The A/B script's protocol at a tiny size on the CPU (the plain
    versions): word-exact, one JSON summary line, no file written."""
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    summary = split_ab.main(["--code", "wifi", "--batch", "128", "--mi",
                             "4", "--trials", "1", "--snr", "2.0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "WORD-EXACT" in "\n".join(lines)
    assert json.loads(lines[-1]) == summary
    assert summary["word_exact"] is True
    assert set(summary["best_ms"]) == {"mono", "split"}
    assert summary["device"] == "cpu"
