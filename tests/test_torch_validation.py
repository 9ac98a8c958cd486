"""The Monte-Carlo validation path of the port against the JAX package, on
the same numpy inputs: random codewords (encoder + torch engine against
encoder + XLA), ``sort_words`` on both engines, the host-staged
``staged_decode_counts(pad_to)``, and the studies of
``ldpc_tpu_torch/scripts/`` at tiny sizes with the JAX artifacts' keys.

The torch engine and XLA differ only on words that do not converge (float32
order), so those comparisons hold the converged words exactly; the cuda
engine's plain version and the Pallas kernel (interpret mode) share their
arithmetic and are held on every word.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.codes.encode import encoder_for_code as jax_encoder_for_code
from ldpc_tpu.ops.decoder import decoder_for_code as jax_decoder_for_code
from ldpc_tpu.sim.evaluate import \
    make_staged_decoder_device as jax_staged_decoder
from ldpc_tpu.sim.evaluate import \
    staged_decode_counts as jax_staged_decode_counts
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import near_earth_code, wifi_code
from ldpc_tpu_torch.codes.encode import encoder_for_code
from ldpc_tpu_torch.ops.decoder import decoder_for_code
from ldpc_tpu_torch.sim.evaluate import (evaluate_code,
                                         make_staged_decoder_device,
                                         make_staged_sweep_device,
                                         random_codeword_sweep_step,
                                         staged_decode_counts)

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _noise(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(
        np.float32)


def _llr(n, snr, seed, b=8):
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    return (-1.0 + sigma * _noise(b, n, seed)).astype(np.float32)


def _converged_equal(got, want):
    """(errors, iterations, success): success and iterations equal where
    either side converged, errors equal there."""
    (eg, ig, sg), (ew, iw, sw) = [[np.asarray(x) for x in t]
                                  for t in (got, want)]
    conv = sg | sw
    assert conv.any()
    assert np.array_equal(sg[conv], sw[conv])
    assert np.array_equal(ig[conv], iw[conv])
    assert np.array_equal(eg[conv], ew[conv])


# --- random codewords --------------------------------------------------------

@pytest.mark.parametrize("name,snr", [("wifi", 2.5), ("wifi", 3.5),
                                      ("near-earth", 3.2)])
def test_random_codewords_match_jax_encoder_and_xla(name, snr):
    """The same numpy messages and noise through JAX's encoder + XLA
    decoder and the port's encoder + torch engine: equal codewords, and
    equal (errors vs the transmitted word, iterations, success) on every
    converged word."""
    code, jcode = ((wifi_code(), jax_wifi_code()) if name == "wifi"
                   else (near_earth_code(), jax_near_earth()))
    enc, jenc = encoder_for_code(code), jax_encoder_for_code(jcode)
    b = 12
    msgs = np.random.default_rng(5).integers(0, 2, (b, enc.k_eff)).astype(
        np.int8)
    sigma = np.float32(np.sqrt(0.5 / 10 ** (snr / 10)))
    noise = sigma * _noise(b, code.n, 6)
    cw = enc(torch.from_numpy(msgs))
    jcw = np.asarray(jenc(jnp.asarray(msgs)))
    assert np.array_equal(cw.numpy(), jcw)
    noisy = np.where(jcw == 0, -1.0, 1.0).astype(np.float32) + noise
    res = decoder_for_code(code, 20)(torch.from_numpy(noisy))
    jres = jax_decoder_for_code(jcode, 20)(jnp.asarray(noisy))
    got = ((res.hard != cw).sum(-1).numpy(), res.iterations.numpy(),
           res.success.numpy())
    want = ((np.asarray(jres.hard) != jcw).sum(-1),
            np.asarray(jres.iterations), np.asarray(jres.success))
    _converged_equal(got, want)


def test_random_codeword_step_contract():
    """The step's keys and [B] outputs; its messages and noise come from
    the generator (one draw of messages, then the noise)."""
    code = wifi_code()
    step = random_codeword_sweep_step(code, 10, device="cpu")
    out = step(torch.full((6,), 3.0), generator=torch.Generator()
               .manual_seed(4))
    assert set(out) == {"errors_uncoded", "errors_decoded", "iterations",
                        "success", "sigma", "sigma_actual"}
    assert all(v.shape == (6,) for v in out.values())
    g = torch.Generator().manual_seed(4)
    msgs = torch.randint(0, 2, (6, encoder_for_code(code).k_eff),
                         generator=g, dtype=torch.int8)
    cw = encoder_for_code(code)(msgs)
    noisy = torch.where(cw == 0, -1.0, 1.0) + out["sigma"][:, None] * \
        torch.randn(cw.shape, generator=g)
    assert torch.equal(out["errors_uncoded"],
                       ((noisy > 0).to(torch.int8) != cw).sum(
                           -1, dtype=torch.int32))
    res = decoder_for_code(code, 10)(noisy)
    assert torch.equal(out["errors_decoded"],
                       (res.hard != cw).sum(-1, dtype=torch.int32))


def test_random_codeword_sweep_matches_all_zero():
    """tests/test_sim.py's check on the port: zero BER where the all-zero
    run has zero, the operating point's BER within the Monte-Carlo band."""
    code = wifi_code()
    kw = dict(snr_points=[2.5, 4.5], num_transmissions=192, max_iters=12,
              batch_size=96, seed=17, device="cpu")
    zero = evaluate_code(code, **kw).summary()
    rand = evaluate_code(code, codewords="random", **kw).summary()
    assert zero["ber"][1] == 0.0 and rand["ber"][1] == 0.0
    n_bits = 192 * code.n
    z_ber, r_ber = zero["ber"][0], rand["ber"][0]
    assert z_ber > 0
    band = 4 * ((z_ber + r_ber) * 20 / n_bits) ** 0.5 + 8 / n_bits
    assert abs(z_ber - r_ber) < band + 0.5 * max(z_ber, r_ber)
    assert rand["transmissions"] == 2 * 192


@pytest.mark.parametrize("kw", [dict(staged=True), dict(engine="cuda"),
                                dict(sort_words=True)])
def test_random_codeword_rejects_cuda_staged_and_sorting(kw):
    with pytest.raises(ValueError):
        evaluate_code(wifi_code(), [4.0], 4, 8, codewords="random",
                      device="cpu", **kw)


# --- sort_words ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sorted_pallas():
    return jax_staged_decoder(jax_wifi_code(), 10, phase1_iters=[4],
                              engine="pallas", tile_b=4, redo_capacity=4,
                              sort_words=True)


@pytest.mark.parametrize("snr", [2.5, 3.5])
def test_sort_words_cuda_engine_equals_jax_pallas(jax_sorted_pallas, snr):
    """Every word: the plain version of the kernel against the Pallas
    kernel, both cascades sorted, and the port's sorted cascade equal to
    its unsorted one."""
    code = wifi_code()
    llr = _llr(code.n, snr, 7)
    kw = dict(phase1_iters=[4], redo_capacity=4, engine="cuda",
              device="cpu")
    got = make_staged_decoder_device(code, 10, sort_words=True, **kw)(
        torch.from_numpy(llr))
    want = jax_sorted_pallas(jnp.asarray(llr))
    plain = make_staged_decoder_device(code, 10, **kw)(torch.from_numpy(llr))
    for g, w, p in zip(got, want, plain):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, p)


@pytest.mark.parametrize("snr", [2.5, 3.0])
def test_sort_words_torch_engine_equals_jax_xla(snr):
    code = wifi_code()
    llr = _llr(code.n, snr, 8, b=16)
    got = make_staged_decoder_device(code, 10, phase1_iters=[4],
                                     sort_words=True, device="cpu")(
        torch.from_numpy(llr))
    want = jax_staged_decoder(jax_wifi_code(), 10, phase1_iters=[4],
                              sort_words=True)(jnp.asarray(llr))
    plain = make_staged_decoder_device(code, 10, phase1_iters=[4],
                                       device="cpu")(torch.from_numpy(llr))
    _converged_equal([x.numpy() for x in got], want)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_sorted_sweep_step_is_bit_identical():
    code = wifi_code()
    snr = torch.full((16,), 2.8)
    outs = []
    for sort in (False, True):
        step = make_staged_sweep_device(code, 10, phase1_iters=[4],
                                        engine="cuda", sort_words=sort,
                                        device="cpu")
        outs.append(step(snr, generator=torch.Generator().manual_seed(23)))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# --- staged_decode_counts -----------------------------------------------------

@pytest.mark.parametrize("pad_to", [1, 3, 256])
@pytest.mark.parametrize("snr,many", [(2.5, True), (3.5, False)])
def test_staged_decode_counts_matches_jax(pad_to, snr, many):
    """The two-phase decode on the torch engine against JAX's host-staged
    one on XLA: above 25% stage-1 failures (the whole batch again) and
    below (only the failures; JAX's chunks of min(pad_to, B) words)."""
    code = wifi_code()
    llr = _llr(code.n, snr, 9, b=16)
    first = decoder_for_code(code, 4)(torch.from_numpy(llr))
    assert (int((~first.success).sum()) > 4) == many
    got = staged_decode_counts(code, torch.from_numpy(llr), 20,
                               phase1_iters=4, pad_to=pad_to)
    want = jax_staged_decode_counts(jax_wifi_code(), jnp.asarray(llr), 20,
                                    phase1_iters=4, pad_to=pad_to)
    assert got[0].dtype == np.int64
    _converged_equal(got, want)
    single = decoder_for_code(code, 20)(torch.from_numpy(llr))
    assert np.array_equal(got[0], single.hard.sum(-1).numpy())
    assert np.array_equal(got[1], single.iterations.numpy())
    assert np.array_equal(got[2], single.success.numpy())


@pytest.mark.parametrize("snr,many", [(2.5, True), (3.5, False)])
def test_staged_decode_counts_cuda_engine_is_one_straight_decode(snr, many):
    """On the cuda engine (its plain version on the CPU) the two-phase
    counts equal one straight ``max_iters`` decode whatever ``pad_to``,
    above and below 25% stage-1 failures."""
    from ldpc_tpu_torch.ops.cuda_static import make_static_sweep_decoder
    code = wifi_code()
    llr = torch.from_numpy(_llr(code.n, snr, 9, b=16))
    first = make_static_sweep_decoder(code, 4, device="cpu")(llr)
    assert (int((~first[2]).sum()) > 4) == many
    single = make_static_sweep_decoder(code, 20, device="cpu")(llr)
    for pad_to in (1, 3, 256):
        got = staged_decode_counts(code, llr, 20, phase1_iters=4,
                                   pad_to=pad_to, engine="cuda")
        assert got[0].dtype == np.int64
        for g, w in zip(got, single):
            assert np.array_equal(g, w.numpy())


def test_staged_decode_counts_refuses_unknown_options():
    code = wifi_code()
    llr = torch.from_numpy(_llr(code.n, 3.0, 1))
    with pytest.raises(ValueError, match="unsupported"):
        staged_decode_counts(code, llr, 10, phase1_iters=4, tile_b=4)
    with pytest.raises(ValueError, match="levers"):
        staged_decode_counts(code, llr, 10, phase1_iters=4, dep_stride=2)


# --- the CLI ---------------------------------------------------------------------

@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")


def test_cli_getting_started_on_the_cpu(cpu_platform, capsys):
    out = cli.main(["getting-started"])
    assert out["probe"] == "OK"
    text = capsys.readouterr().out
    assert "torch" in text and "native C++ engine" in text


def test_cli_evaluate_random_codewords_and_plot(cpu_platform, tmp_path):
    png = tmp_path / "ber.png"
    st = cli.main(["evaluate", "--code", "wifi", "--snr", "3.0", "3.5",
                   "--transmissions", "8", "--batch-size", "4",
                   "--iterations", "10", "--codewords", "random",
                   "--plot", str(png)])
    assert st.summary()["transmissions"] == 16
    assert png.stat().st_size > 0


# --- the studies at tiny sizes ---------------------------------------------------

def _keys(doc, engines=False):
    """A document's key tree (the JAX artifact's engine names, xla and
    pallas, read as the port's torch and cuda)."""
    if isinstance(doc, list):
        return _keys(doc[0]) if doc else []
    if not isinstance(doc, dict):
        return None
    out = {}
    for k, v in doc.items():
        k = k.replace("xla", "torch").replace("pallas", "cuda")
        out[k] = _keys(v)
    return out


def _contains(got, want):
    """Every key of ``want``'s tree is in ``got``'s, level by level."""
    if want is None or got is None:
        return True
    return all(k in got and _contains(got[k], v) for k, v in want.items())


def _jax_doc(name):
    return json.loads((ROOT / "docs" / f"{name}.json").read_text())


STUDIES = {
    "ber_parity": ["--words", "8", "--native-words", "4", "--max-iters",
                   "16"],
    "random_codeword_check": ["--words", "32", "--iters", "8", "--codes",
                              "wifi"],
    "error_floor": ["--code", "wifi", "--words", "64", "--snr", "3.0", "4.0",
                    "--batch", "16"],
    "wifi_waterfall": ["--words", "4", "--max-iters", "5"],
    "sort_ab": ["--batch", "64", "--mi", "8", "--phases", "4", "--code",
                "wifi", "--trials", "1"],
}
ARTIFACTS = {"ber_parity": "ber_parity",
             "random_codeword_check": "random_codeword",
             "error_floor": "error_floor", "wifi_waterfall": "wifi_waterfall",
             "sort_ab": "sort_ab"}


@pytest.mark.parametrize("script", list(STUDIES))
def test_study_runs_on_the_cpu_with_the_jax_keys(script, cpu_platform,
                                                 tmp_path):
    import importlib
    mod = importlib.import_module(f"ldpc_tpu_torch.scripts.{script}")
    argv = STUDIES[script] + ["--out", str(tmp_path / "art")]
    if script == "error_floor":
        argv += ["--checkpoint", str(tmp_path / "ck.npz")]
    doc = mod.main(argv)
    written = json.loads((tmp_path / "art.json").read_text())
    assert written == json.loads(json.dumps(doc))
    assert (tmp_path / "art.md").read_text().startswith("# ")
    want = _keys(_jax_doc(ARTIFACTS[script]))
    want.pop("reference_agreement", None)   # written by another JAX script
    if script == "random_codeword_check":   # the smoke run's one code
        want["codes"] = {"wifi": want["codes"]["wifi"]}
    assert _contains(_keys(written), want)
    assert written["device"] == "cpu" and len(written["kernel_hash"]) == 64


def test_error_floor_default_checkpoint_is_the_runs_own(cpu_platform,
                                                        tmp_path,
                                                        monkeypatch):
    """With the default checkpoint a run with other settings (words,
    engine) does not resume another run's points; the same run does."""
    import tempfile
    from ldpc_tpu_torch.scripts import error_floor
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    base = ["--code", "wifi", "--snr", "3.0", "--batch", "16", "--no-write"]

    def files():
        return sorted(tmp_path.glob("error_floor_checkpoint_*.npz"))

    first = error_floor.main(base + ["--words", "32"])
    assert len(files()) == 1 and first["points"][0]["words"] == 32
    fewer = error_floor.main(base + ["--words", "16"])
    assert fewer["points"][0]["words"] == 16
    other = error_floor.main(base + ["--words", "32", "--engine", "torch"])
    assert other["engine"] == "torch" and len(files()) == 3
    again = error_floor.main(base + ["--words", "32"])
    assert again["points"] == first["points"] and len(files()) == 3


def test_study_on_the_cpu_writes_only_where_asked(cpu_platform, tmp_path,
                                                  monkeypatch):
    from ldpc_tpu_torch.scripts import sort_ab, studies
    monkeypatch.setattr(studies, "DATA", tmp_path / "data")
    sort_ab.main(STUDIES["sort_ab"])
    assert not (tmp_path / "data").exists()
