"""The evaluate path of the port: the staged cascade with the new kinds
against the JAX package's Pallas cascade, ``evaluate_code`` (summary keys,
checkpoint resume, early abort, the options of later slices), the sweep
step, the probe, the statistics' file format, and the CLI on the CPU.

The JAX staged decoder rounds a redo capacity up to its kernel tile, so it
gets ``tile_b=4`` and ``redo_capacity=4``, and the port the same capacity:
a batch of 8 802.11n rate-5/6 words then takes each branch of the 3 -> 8
cascade ("many" at 2.5 dB, "few" at 3.5 dB, "none" at 4.5 dB).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import near_earth_code as jax_near_earth
from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.sim import stats as jax_stats
from ldpc_tpu.sim.evaluate import evaluate_code as jax_evaluate_code
from ldpc_tpu.sim.evaluate import \
    evaluate_epsilon_probe as jax_epsilon_probe
from ldpc_tpu.sim.evaluate import \
    make_staged_decoder_device as jax_staged_decoder
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import near_earth_code, wifi_code
from ldpc_tpu_torch.sim import stats
from ldpc_tpu_torch.sim.evaluate import (batch_seed, evaluate_code,
                                         evaluate_epsilon_probe,
                                         make_staged_decoder_device,
                                         make_staged_sweep_device,
                                         sweep_step)

# xdist runs several workers on the machine's cores: one intra-op
# thread each, or their thread pools contend and the CPU tests crawl
torch.set_num_threads(1)

CASES = [(2.5, "many"), (3.5, "few"), (4.5, "none")]
KEYS = {"snr_db", "snr_db_actual", "ber", "fer", "avg_iterations",
        "transmissions", "codeword_size"}


def _llr(n, snr, seed=1, b=8):
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(0.5 / 10 ** (snr / 10))
    return (-1.0 + sigma * rng.standard_normal((b, n))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_normalized_cascade():
    return jax_staged_decoder(jax_wifi_code(1944, 5 / 6), 8, phase1_iters=3,
                              engine="pallas", tile_b=4, redo_capacity=4,
                              kind="normalized-min-sum")


@pytest.mark.parametrize("snr,branch", CASES)
def test_normalized_cascade_matches_jax_pallas(jax_normalized_cascade, snr,
                                               branch):
    code = wifi_code(1944, 5 / 6)
    llr = _llr(code.n, snr)
    want = [np.asarray(x) for x in jax_normalized_cascade(jnp.asarray(llr))]
    dec = make_staged_decoder_device(code, 8, phase1_iters=3,
                                     redo_capacity=4, engine="cuda",
                                     kind="normalized-min-sum", device="cpu")
    got = [x.numpy() for x in dec(torch.from_numpy(llr))]
    assert dec.last_branches == [branch]
    for g, w in zip(got, want):        # every word: the kernel's arithmetic
        assert np.array_equal(g, w)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_summary_has_the_jax_keys(engine):
    code = wifi_code()
    port = evaluate_code(code, [3.0, 3.5], 8, 10, batch_size=4,
                         engine=engine, device="cpu").summary()
    ref = jax_evaluate_code(jax_wifi_code(), [3.0, 3.5], 8, 10,
                            batch_size=4).summary()
    assert set(port) == set(ref) == KEYS
    assert port["snr_db"] == ref["snr_db"] == [3.0, 3.5]
    assert port["transmissions"] == ref["transmissions"] == 16
    assert port["codeword_size"] == ref["codeword_size"] == code.n


def test_staged_evaluate_equals_unstaged():
    """Staged or not, the same seeds give the same per-word statistics
    (latching)."""
    code = wifi_code()
    kw = dict(batch_size=8, seed=3, device="cpu", engine="cuda",
              kind="offset-min-sum")
    a = evaluate_code(code, [2.5, 3.5], 16, 20, **kw)
    b = evaluate_code(code, [2.5, 3.5], 16, 20, staged=True,
                      phase1_iters=[4, 8], **kw)
    for f in ("errors_decoded", "iterations", "success", "sigma_actual"):
        assert np.array_equal(a.column(f), b.column(f))


def test_sum_product_sweep_takes_true_llrs():
    """scale_llr feeds 2y/sigma^2: sum-product decodes; raw samples do not
    reach its operating point."""
    code = wifi_code(1944, 1 / 2)
    kw = dict(batch_size=8, seed=5, device="cpu", kind="sum-product",
              engine="cuda", store_dtype="float32")
    good = evaluate_code(code, [-1.0], 8, 20, scale_llr=True, **kw)
    raw = evaluate_code(code, [-1.0], 8, 20, scale_llr=False, **kw)
    assert good.summary()["fer"][0] < raw.summary()["fer"][0]


def test_checkpoint_resume_equals_unbroken_run(tmp_path):
    code = wifi_code()
    path = str(tmp_path / "ckpt.npz")
    kw = dict(batch_size=4, seed=11, device="cpu", engine="cuda")
    whole = evaluate_code(code, [2.5, 3.0], 8, 10, **kw)
    # first the first batch of the first point, then the whole sweep
    evaluate_code(code, [2.5], 4, 10, checkpoint_path=path, **kw)
    resumed = evaluate_code(code, [2.5, 3.0], 8, 10, checkpoint_path=path,
                            **kw)
    for f in ("snr", "errors_decoded", "iterations", "success",
              "sigma_actual", "errors_uncoded"):
        assert np.array_equal(whole.column(f), resumed.column(f)), f
    again = evaluate_code(code, [2.5, 3.0], 8, 10, checkpoint_path=path,
                          **kw)     # nothing left to do
    assert len(again) == len(resumed) == 16


def test_early_abort_stops_the_sweep():
    code = wifi_code()
    st = evaluate_code(code, [0.0, 3.5, 4.0], 8, 10, batch_size=8,
                       early_abort_ber=1e-6, device="cpu")
    assert list(st.snr_points) == [0.0]


@pytest.mark.parametrize("kw,err,match", [
    (dict(schedule="layered"), ValueError, "cuda engine"),
    (dict(store_dtype="int8", engine="cuda", kind="sum-product"),
     ValueError, "min-sum family"),
    (dict(sort_words=True, codewords="random"), ValueError, "sort_words"),
    (dict(codewords="random", engine="cuda"), ValueError, "encode"),
    (dict(codewords="other"), ValueError, "codewords"),
    (dict(tile_b=128, engine="cuda"), ValueError, "tile_b"),
    (dict(engine="xla"), ValueError, "engine"),
    (dict(store_dtype="float32"), ValueError, "cuda-engine"),
])
def test_later_options_raise(kw, err, match):
    with pytest.raises(err, match=match):
        evaluate_code(wifi_code(), [3.0], 4, 5, device="cpu", **kw)


def test_staged_decoder_refuses_kernel_levers():
    """The kernel levers belong to the cuda engine (ValueError on the torch
    engine, as on JAX's xla); there popcount_sign and every dep_stride are
    taken, and dep_stride > 0 (kernel B8) decodes as dep_stride 0."""
    code = wifi_code()
    for kw in (dict(popcount_sign=True), dict(dep_stride=2)):
        with pytest.raises(ValueError, match="levers"):
            make_staged_decoder_device(code, 8, device="cpu", **kw)
    llr = torch.from_numpy(_llr(code.n, 3.0))
    want = make_staged_decoder_device(code, 8, phase1_iters=3,
                                      engine="cuda", device="cpu")(llr)
    for kw in (dict(popcount_sign=True), dict(dep_stride=0),
               dict(dep_stride=2)):
        got = make_staged_decoder_device(code, 8, phase1_iters=3,
                                         engine="cuda", device="cpu",
                                         **kw)(llr)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("popcount_sign", [None, False, True])
@pytest.mark.parametrize("dep_stride", [None, 0, 2])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_engine_options_raise_as_jax(engine, schedule, dep_stride,
                                     popcount_sign):
    """Every combination raises what JAX's make_staged_decoder_device
    raises on its counterpart engine (xla, pallas), and builds where it
    builds, dep_stride > 0 on the cuda engine included (kernel B8)."""
    kw = dict(phase1_iters=3, schedule=schedule, dep_stride=dep_stride,
              popcount_sign=popcount_sign)
    want = None
    try:
        jax_staged_decoder(jax_wifi_code(), 8,
                           engine={"torch": "xla", "cuda": "pallas"}[engine],
                           **kw)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        want = type(e)
    if want is None:
        make_staged_decoder_device(wifi_code(), 8, engine=engine,
                                   device="cpu", **kw)
    else:
        with pytest.raises(want):
            make_staged_decoder_device(wifi_code(), 8, engine=engine,
                                       device="cpu", **kw)


def test_sweep_step_contract_and_generator():
    code = wifi_code()
    step = sweep_step(code, 10, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    out = step(torch.full((6,), 3.0))
    assert set(out) == {"errors_uncoded", "errors_decoded", "iterations",
                        "success", "sigma", "sigma_actual"}
    assert all(v.shape == (6,) for v in out.values())
    a = step(torch.full((6,), 3.0), generator=torch.Generator().manual_seed(9))
    b = step(torch.full((6,), 3.0), generator=torch.Generator().manual_seed(9))
    for k in a:
        assert torch.equal(a[k], b[k])
    staged = make_staged_sweep_device(code, 10, phase1_iters=[], device="cpu")
    c = staged(torch.full((6,), 3.0), generator=torch.Generator().manual_seed(9))
    for k in a:
        assert torch.equal(a[k], c[k])


def test_batch_seeds_are_fixed_and_distinct():
    assert batch_seed(7, 0, 0) == batch_seed(7, 0, 0)
    seeds = {batch_seed(s, i, d) for s in (1, 2) for i in range(3)
             for d in (0, 256, 512)}
    assert len(seeds) == 18
    assert all(0 <= s < 2 ** 64 for s in seeds)


@pytest.mark.parametrize("flips", [(0,), (0, 1, 2), (5, 5)])
def test_epsilon_probe_equals_jax(flips):
    code = near_earth_code()
    got = evaluate_epsilon_probe(code, 1e-2, flips, 20, device="cpu")
    want = jax_epsilon_probe(jax_near_earth(), 1e-2, flips, 20)
    assert got == tuple(want)
    *_, wall = evaluate_epsilon_probe(code, 1e-2, flips, 20, device="cpu",
                                      return_time=True)
    assert wall > 0


def test_statistics_files_cross_load(tmp_path):
    """A checkpoint of either package loads in the other, with the same
    aggregates; merges and the reference 4-tuple agree too."""
    rng = np.random.default_rng(0)
    cols = dict(snr=np.repeat([3.0, 3.5], 4), sigma=np.full(8, 0.5),
                sigma_actual=rng.uniform(0.4, 0.6, 8),
                errors_uncoded=rng.integers(0, 50, 8),
                errors_decoded=rng.integers(0, 5, 8),
                iterations=rng.integers(1, 20, 8), max_iterations=20,
                success=rng.integers(0, 2, 8).astype(bool))
    mine, theirs = stats.BerStatistics(1944), jax_stats.BerStatistics(1944)
    mine.add_batch(**cols)
    theirs.add_batch(**cols)
    mine.add_aggregate(4.0, 0.4, 0.41, 10, 2, 30, 20, 7, 1, 8)
    theirs.add_aggregate(4.0, 0.4, 0.41, 10, 2, 30, 20, 7, 1, 8)
    mine.save(tmp_path / "port.npz")
    theirs.save(tmp_path / "jax.npz")
    a = jax_stats.BerStatistics.load(tmp_path / "port.npz")
    b = stats.BerStatistics.load(tmp_path / "jax.npz")
    assert a.summary() == b.summary() == mine.summary()
    for x, y in zip(mine.union(b).get_stats(), theirs.union(a).get_stats()):
        assert np.array_equal(x, y)
    assert len(mine.add(b)) == 32


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")


def test_cli_evaluate_on_the_cpu(cpu_platform, capsys):
    st = cli.main(["evaluate", "--code", "wifi", "--snr", "3.0", "3.5",
                   "--transmissions", "8", "--batch-size", "4",
                   "--iterations", "10", "--phase-iters", "4",
                   "--engine", "cuda", "--kind", "sum-product",
                   "--store-dtype", "float32"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(line)) == KEYS
    assert st.summary()["transmissions"] == 16


def test_cli_bench_and_probe_on_the_cpu(cpu_platform, capsys):
    out = cli.main(["bench", "wifi", "--snr", "3.4", "3.6",
                    "--transmissions", "4", "--batch-size", "4",
                    "--iterations", "16"])
    assert out["preset"] == "wifi" and out["status"] in ("OK",
                                                         "wifi problem")
    assert set(out["ber"]) == {3.4, 3.6}
    probe = cli.main(["probe", "--code", "wifi", "--iterations", "10"])
    assert probe == {"errors_uncoded": 1, "errors_decoded": 0,
                     "iterations": probe["iterations"], "success": True}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == probe


@pytest.mark.parametrize("argv,err", [
    (["evaluate", "--sharded", "--codewords", "random"], SystemExit),
    (["evaluate", "--codewords", "random", "--engine", "cuda"],
     SystemExit),
    (["evaluate", "--tile-b", "128"], SystemExit),
    (["evaluate", "--codewords", "random", "--schedule", "layered"],
     SystemExit),
    (["evaluate", "--schedule", "layered"], ValueError),
])
def test_cli_refuses_later_options(cpu_platform, argv, err):
    with pytest.raises(err):
        cli.main(argv + ["--transmissions", "4", "--iterations", "4"])


def test_cli_evaluate_sharded_on_the_cpu(cpu_platform, capsys):
    """``--sharded`` (once refused, waiting for ``parallel/``) on a
    one-rank group: the statistics of the unsharded command, on the same
    seed and batching."""
    import torch.distributed as dist
    argv = ["evaluate", "--code", "wifi", "--snr", "3.0", "3.5",
            "--transmissions", "8", "--batch-size", "4", "--iterations",
            "10", "--phase-iters", "4", "--engine", "cuda"]
    try:
        sharded = cli.main(argv + ["--sharded"]).summary()
    finally:
        dist.destroy_process_group()
    plain = cli.main(argv).summary()
    assert "[sharded] snr 3.0" in capsys.readouterr().out
    for k in ("ber", "fer", "avg_iterations", "transmissions"):
        assert sharded[k] == plain[k], k


def test_cli_evaluate_layered_int8_on_the_cpu(cpu_platform, capsys):
    st = cli.main(["evaluate", "--code", "wifi", "--snr", "3.0",
                   "--transmissions", "8", "--batch-size", "4",
                   "--iterations", "10", "--phase-iters", "4",
                   "--engine", "cuda", "--schedule", "layered",
                   "--store-dtype", "int8"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert set(json.loads(line)) == KEYS
    assert st.summary()["transmissions"] == 8


def test_cli_probe_negative_flip_equals_jax(cpu_platform):
    """`probe --flips -1` flips the last bit, as ldpc_tpu.cli does."""
    got = cli.main(["probe", "--code", "wifi", "--flips", "-1",
                    "--iterations", "10"])
    want = jax_epsilon_probe(jax_wifi_code(), 1e-2, (-1,), 10)
    assert (got["errors_uncoded"], got["errors_decoded"], got["iterations"],
            got["success"]) == tuple(want)
    assert got["errors_uncoded"] == 1


def test_cli_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.delenv("LDPC_TPU_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["probe", "--iterations", "4"])
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "tpu")
    with pytest.raises(SystemExit):
        cli.main(["probe", "--iterations", "4"])
