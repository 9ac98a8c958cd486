"""The whole slice: the port's staged decoder and sweep against the JAX
package's ``make_staged_decoder_device(engine="pallas")`` (Pallas interpret
mode on the CPU), on near-earth with the same numpy LLRs.

The JAX staged decoder rounds a redo capacity up to its kernel tile, so it gets
``tile_b=4`` and ``redo_capacity=4``, and the port the same capacity: a
batch of 8 words then reaches both branches of the cascade (3 -> 8
iterations): "many" at 2.5 and 3.6 dB, "few" at 4.2 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.sim.evaluate import \
    make_staged_decoder_device as jax_staged_decoder
from ldpc_tpu_torch.codes import near_earth_code
from ldpc_tpu_torch.ops.cuda_static import make_static_sweep_decoder
from ldpc_tpu_torch.sim.evaluate import (default_redo_capacity,
                                         make_staged_decoder_device,
                                         make_staged_sweep_device,
                                         staged_decode_counts)

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

# (SNR dB, numpy seed) -> the branch the 8-word batch takes
CASES = [(2.5, 1, "many"), (3.6, 1, "many"), (4.2, 1, "few")]


def _llr(n, snr, seed, b=8):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    return (-1.0 + sigma * rng.standard_normal((b, n))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_staged():
    return jax_staged_decoder(jax_near_earth(), 8, phase1_iters=3,
                              engine="pallas", tile_b=4, redo_capacity=4)


@pytest.mark.parametrize("snr,seed,branch", CASES)
def test_staged_matches_jax_pallas_cascade(jax_staged, snr, seed, branch):
    code = near_earth_code()
    llr = _llr(code.n, snr, seed)
    want = [np.asarray(x) for x in jax_staged(jnp.asarray(llr))]
    dec = make_staged_decoder_device(code, 8, phase1_iters=3,
                                     redo_capacity=4, engine="cuda",
                                     device="cpu")
    got = [x.numpy() for x in dec(torch.from_numpy(llr))]
    assert dec.last_branches == [branch]
    # every word, converged or not: same kernel arithmetic on both sides
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("snr", [2.8, 3.4, 4.2])
def test_cascade_equals_single_pass(snr):
    """Latching makes 3 -> 6 -> 10 equal to one 10-iteration decode."""
    code = near_earth_code()
    llr = torch.from_numpy(_llr(code.n, snr, seed=3, b=6))
    single = make_static_sweep_decoder(code, 10, device="cpu")(llr)
    for cap in (1, 6):
        dec = make_staged_decoder_device(code, 10, phase1_iters=(3, 6),
                                         redo_capacity=cap, engine="cuda",
                                         device="cpu")
        for a, b in zip(dec(llr), single):
            assert torch.equal(a, b)
    np_out = staged_decode_counts(code, llr, 10, phase1_iters=3,
                                  engine="cuda")
    for a, b in zip(np_out, single):
        assert np.array_equal(a, b.numpy())


def _no_decode(code, it, kind, dtype, engine, kw_key, nested=False):
    """Stands in for the JAX cascade's decoders: only its capacities are
    read, from the traced program."""
    def fn(llr):
        zero = jnp.zeros(llr.shape[0], jnp.int32)
        return zero, zero, zero.astype(bool)
    return fn


def test_default_redo_capacity(monkeypatch):
    """The JAX cascade's default capacity (round_cap,
    ldpc_tpu/sim/evaluate.py:275-280), read from the `nfail <= cap` of its
    traced program: B/4 for xla; rounded up to 128-word tiles, at least
    128, for pallas; at most B; None and 0 alike.  The port's torch and
    cuda engines give the same; the bench protocol passes 3B/16."""
    import ldpc_tpu.sim.evaluate as jev
    monkeypatch.setattr(jev, "_engine_counts_fn", _no_decode)
    code, jcode = near_earth_code(), jax_near_earth()
    for engine, jengine in (("torch", "xla"), ("cuda", "pallas")):
        for cap in (None, 0):
            port = make_staged_decoder_device(code, 8, phase1_iters=3,
                                              redo_capacity=cap,
                                              engine=engine, device="cpu")
            for b in (8, 100, 128, 1000, 32768):
                fn = jev._staged_core_builder(jcode, 8, phase1_iters=3,
                                              redo_capacity=cap,
                                              engine=jengine)(b)
                jaxpr = jax.make_jaxpr(fn)(
                    jax.ShapeDtypeStruct((b, jcode.n), jnp.float32))
                want = [int(e.invars[1].val) for e in jaxpr.jaxpr.eqns
                        if e.primitive.name == "le"]
                assert port.capacities(b) == want, (engine, cap, b)
                assert default_redo_capacity(b, engine) == want[0]
    assert default_redo_capacity(32768) == 8192
    assert default_redo_capacity(1000, "torch") == 250


def test_staged_rejects_bad_budgets():
    code = near_earth_code()
    with pytest.raises(ValueError):
        make_staged_decoder_device(code, 8, phase1_iters=8, device="cpu")
    with pytest.raises(ValueError):
        make_staged_decoder_device(code, 8, phase1_iters=(5, 3),
                                   device="cpu")
    with pytest.raises(ValueError):
        make_staged_decoder_device(code, 8, phase1_iters=(2, 4),
                                   redo_capacity=[4], device="cpu")


def test_sweep_step_contract():
    """The fused transmit + cascade step: the JAX step's keys, [B] outputs,
    the decode equal to decoding the same noise separately."""
    code = near_earth_code()
    b = 6
    step = make_staged_sweep_device(
        code, 8, phase1_iters=3, engine="cuda", device="cpu",
        generator=torch.Generator().manual_seed(9))
    out = step(torch.full((b,), 3.4))
    assert set(out) == {"errors_uncoded", "errors_decoded", "iterations",
                        "success", "sigma", "sigma_actual"}
    assert all(v.shape == (b,) for v in out.values())
    assert out["success"].dtype == torch.bool
    # same generator seed -> same noise -> same per-word decode
    g = torch.Generator().manual_seed(9)
    clean = torch.full((b, code.n), -1.0)
    noise = torch.randn(clean.shape, generator=g)
    sigma = out["sigma"][:, None]
    llr = clean + sigma * noise
    single = make_static_sweep_decoder(code, 8, device="cpu")(llr)
    assert torch.equal(out["errors_decoded"], single[0])
    assert torch.equal(out["iterations"], single[1])
    assert torch.equal(out["success"], single[2])
    assert torch.equal(out["errors_uncoded"],
                       (llr > 0).sum(-1, dtype=torch.int32))
