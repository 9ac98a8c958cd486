"""The port's ``parallel/`` on gloo groups of 1, 2 and 4 CPU processes,
held to its single-process paths and to the JAX package.

One group of each size is spawned once for the module
(``tests/torch_dist_worker.py parallel``); every rank runs the port of each
case of ``tests/test_parallel.py`` and the single-process reference it is
held to, and writes what it got.  The cases:

* sharding is transparent: the counters of ``sharded_sweep_step`` and
  ``evaluate_code_sharded`` (straight and staged, the torch engine and
  the cuda engine's plain version) equal ``sim.evaluate_code``'s with the
  same seed and batching at every world size, exactly;
* the refusals (layered needs the cuda engine; ``sort_words`` needs
  ``staged=True``; ``tile_b`` as ``evaluate_code``), checkpoint resume and
  early abort;
* the row-sharded decoder bit-exact against the unsharded decoder on
  integer LLRs (1-D and (data, row) meshes, and the giant synthetic
  code), and against JAX's ``make_row_sharded_decoder`` on the conftest's
  8-device CPU mesh with 4 row shards, 1-D and (data, row);
* the sharded sweep's BER/FER against JAX's ``evaluate_code_sharded``
  within 95% intervals (the noise differs: Philox against threefry);
* ``EnvironmentVector(mesh=)`` equal to sequential stepping, ``ppo`` with
  ``mesh`` and ``env_mesh`` and ``dryrun_train_step`` within float
  rounding of one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ldpc_tpu.codes import wifi_code as jax_wifi_code
from ldpc_tpu.parallel import evaluate_code_sharded as jax_sharded
from ldpc_tpu.parallel import make_mesh as jax_make_mesh
from ldpc_tpu.parallel.rowshard import \
    make_row_sharded_decoder as jax_row_decoder
from ldpc_tpu_torch.codes import wifi_code
from ldpc_tpu_torch.sim import evaluate_code
from ldpc_tpu_torch.sim.stats import frame_ber_ci, wilson_interval
from torch_dist_worker import row_llrs, spawn_groups

torch.set_num_threads(1)

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return spawn_groups("parallel", WORLDS,
                        tmp_path_factory.mktemp("parallel"), timeout_s=300)


def _ranks(groups, world):
    """Rank 0's results, after checking that every rank got the same."""
    got = [groups[(world, r)] for r in range(world)]
    return got[0], got


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_spans_every_rank(groups, world):
    r0, ranks = _ranks(groups, world)
    assert r0["mesh"]["size"] == world and r0["mesh"]["names"] == ["data"]
    assert r0["mesh"]["hier"] == [world, 1]    # dcn = process count


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_single_device(groups, world):
    _, ranks = _ranks(groups, world)
    for r in ranks:
        got, ref = r["step"]["sharded"], r["step"]["single"]
        assert got["frames"] == 16
        for k in ("errors_uncoded", "errors_decoded", "iterations_sum",
                  "success_count"):
            assert got[k] == ref[k], k
        assert got["sigma_actual_mean"] == pytest.approx(
            ref["sigma_actual_mean"], rel=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_evaluate_code_sharded_waterfall(groups, world):
    r0, ranks = _ranks(groups, world)
    wf = r0["waterfall"]
    assert wf["len"] == 64
    ber = wf["summary"]["ber"]
    assert ber[1] == 0.0 and ber[0] > 0
    np.testing.assert_allclose(wf["summary"]["snr_db_actual"],
                               wf["summary"]["snr_db"], atol=0.3)
    assert all(r["waterfall"] == wf for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_staged_equals_single_device_staged(groups, world):
    r0, _ = _ranks(groups, world)
    sa, sb = r0["staged_vs_single"]["sharded"], \
        r0["staged_vs_single"]["single"]
    assert sa["transmissions"] == sb["transmissions"] == 128
    np.testing.assert_array_equal(sa["ber"], sb["ber"])
    np.testing.assert_array_equal(sa["fer"], sb["fer"])
    np.testing.assert_array_equal(sa["avg_iterations"],
                                  sb["avg_iterations"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_staged_equals_sharded_unstaged(groups, world):
    r0, _ = _ranks(groups, world)
    sa, sb = r0["staged_vs_unstaged"]["staged"], \
        r0["staged_vs_unstaged"]["unstaged"]
    np.testing.assert_array_equal(sa["ber"], sb["ber"])
    np.testing.assert_array_equal(sa["avg_iterations"],
                                  sb["avg_iterations"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_layered_needs_cuda(groups, world):
    refused = groups[(world, 0)]["refused"]
    assert "cuda engine" in refused["layered"]
    assert "tile_b" in refused["tile_b"]
    assert "staged=True" in refused["sort_words"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_layered_schedule_matches_single_device(groups, world):
    r0, _ = _ranks(groups, world)
    sa, sb = r0["layered"]["sharded"], r0["layered"]["single"]
    np.testing.assert_array_equal(sa["ber"], sb["ber"])
    np.testing.assert_array_equal(sa["fer"], sb["fer"])
    np.testing.assert_array_equal(sa["avg_iterations"],
                                  sb["avg_iterations"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_resume_and_early_abort(groups, world):
    ck = groups[(world, 0)]["checkpoint"]
    assert ck["b"]["transmissions"] == ck["a"]["transmissions"] == 64
    assert ck["b"] == ck["a"]
    assert ck["c_snrs"] == [2.0]


@pytest.mark.parametrize("world", WORLDS)
def test_process_batch_slice(groups, world):
    slices = [groups[(world, r)]["mesh"]["slice"] for r in range(world)]
    assert slices[0][0] == 0
    assert sum(size for _, size in slices) == 100
    for (s0, n0), (s1, _) in zip(slices, slices[1:]):
        assert s0 + n0 == s1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_and_unsharded_sweeps_agree(groups, world):
    """The JAX test packs the batches differently and agrees in statistics
    only; with the same batching the port's agree exactly."""
    st = groups[(world, 0)]["statistical"]
    assert st["sharded"]["transmissions"] == 64
    for k in ("ber", "fer", "avg_iterations"):
        assert st["sharded"][k] == st["single"][k], k


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cuda_engine_matches_torch(groups, world):
    """The cuda engine (its plain version on the CPU) against the torch
    engine on the same words: equal up to rare marginal words (the f32
    order of the variable sums)."""
    e = groups[(world, 0)]["engines"]
    sa, sb = e["cuda"], e["torch"]
    assert sa["transmissions"] == sb["transmissions"] == 32
    assert abs(sa["ber"][0] - sb["ber"][0]) < 2e-3
    assert abs(sa["fer"][0] - sb["fer"][0]) <= 2 / 32
    assert e == groups[(1, 0)]["engines"]


def _same(got: dict, plain: dict, mask=None):
    for k in ("errors", "iterations", "success"):
        a, b = np.asarray(got[k]), np.asarray(plain[k])
        if mask is not None:
            a, b = a[mask], b[mask]
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_row_sharded_decoder_exact_integer_llrs(groups, world):
    r0, ranks = _ranks(groups, world)
    assert not all(r0["row_plain"]["success"])   # non-converged words too
    for r in ranks:
        _same(r["row_1d"], r0["row_plain"])
        _same(r["row_2d"], r0["row_plain"])
    assert r0["row_mesh_2d"] == [world // max(1, world // 2),
                                 max(1, world // 2)]


@pytest.mark.parametrize("world", WORLDS)
def test_synthetic_qc_code_and_giant_rowshard(groups, world):
    g = groups[(world, 0)]["giant"]
    assert g["n"] == 24 * 2048 and g["degrees"] == [3]
    _same(g["sharded"], g["plain"])


@pytest.mark.parametrize("world", WORLDS)
def test_row_sharded_decoder_2d_mesh_awgn(groups, world):
    a = groups[(world, 0)]["row_awgn"]
    conv = np.asarray(a["plain"]["success"]) & np.asarray(
        a["sharded"]["success"])
    assert conv.any()
    _same(a["sharded"], a["plain"], conv)
    n = wifi_code(rate=0.5).n
    assert abs(sum(a["sharded"]["errors"]) - sum(a["plain"]["errors"])) \
        <= 0.02 * n * 8 + 16


def test_row_sharded_decoder_bit_exact_against_jax(groups):
    """The same integer LLRs through JAX's row-sharded decoder on the
    8-device CPU mesh (4 row shards; 1-D and (data 2, row 4)) and through
    the port's on 4 ranks (1-D and (data 2, row 2)): every word's errors,
    iterations and success equal, converged or not."""
    half = jax_wifi_code(rate=0.5)
    llr = jnp.asarray(row_llrs(half.n))
    devs = np.asarray(jax.devices())
    want = {}
    for name, mesh, kw in (
            ("row_1d", Mesh(devs[:4], ("row",)), {}),
            ("row_2d", Mesh(devs.reshape(2, 4), ("data", "row")),
             {"data_axis": "data"})):
        dec = jax_row_decoder(half, mesh, max_iters=12, **kw)
        e, i, s = map(np.asarray, jax.device_get(dec(llr)))
        want[name] = {"errors": e, "iterations": i, "success": s}
    assert not want["row_1d"]["success"].all()
    for r in range(4):
        for name in ("row_1d", "row_2d"):
            _same(groups[(4, r)][name], want[name])


def test_sharded_sweep_agrees_with_jax_within_ci(groups):
    """802.11n rate 5/6 at 2.5 dB, 256 words: the port's sharded sweep
    equals its evaluate_code exactly, and its BER and FER agree with JAX's
    evaluate_code_sharded (8-device CPU mesh) within 95% intervals."""
    port = groups[(4, 0)]["vs_jax"]
    assert all(groups[(w, 0)]["vs_jax"] == port for w in WORLDS)
    single = evaluate_code(wifi_code(), [2.5], 256, max_iters=20,
                           batch_size=64, seed=17, device="cpu")
    for k in ("ber", "fer", "avg_iterations", "transmissions"):
        assert single.summary()[k] == port[k], k
    ref = jax_sharded(jax_wifi_code(), [2.5], 256, max_iters=20,
                      mesh=jax_make_mesh(), batch_size=64, seed=17).summary()
    n = wifi_code().n
    ber, half = frame_ber_ci(single.column("errors_decoded"), n)
    assert ber == pytest.approx(port["ber"][0], rel=1e-12)
    assert abs(ref["ber"][0] - ber) <= np.sqrt(2) * half
    fe = int(single.column("frame_errors").sum())
    _, lo, hi = wilson_interval(fe, 256)
    _, jlo, jhi = wilson_interval(round(ref["fer"][0] * 256), 256)
    assert fe > 20 and lo <= jhi and jlo <= hi


@pytest.mark.parametrize("world", WORLDS)
def test_vector_env_mesh_matches_sequential(groups, world):
    """2 x world envs stepped twice with their candidates sharded over the
    ranks (batched=None fuses with a mesh), one illegal action a step:
    rewards, legality, codes and iteration budgets equal sequential
    stepping's on every rank."""
    for r in range(world):
        v = groups[(world, r)]["vector_env"]
        assert v["rewards"] == v["seq_rewards"]
        assert v["iterations"] == v["seq_iterations"]
        assert all(v["equal_state"])
        assert [legal[-1] for legal in v["legal"]] == [False, False]
        assert all(all(legal[:-1]) for legal in v["legal"])
    assert groups[(world, 0)]["vector_env"]["rewards"][0][0] == \
        groups[(1, 0)]["vector_env"]["rewards"][0][0]


@pytest.mark.parametrize("world", WORLDS)
def test_ppo_meshes_match_one_process(groups, world):
    """An epoch of PPO with the update batch and the env step sharded over
    the ranks: the same steps.tsv as the same run in one process (rank 0
    writes it) and parameters within float rounding (the gradients are
    sums of the ranks' partial sums)."""
    for r in range(world):
        p = groups[(world, r)]["ppo"]
        assert p["max_param_diff"] <= 1e-6
        assert p["steps_tsv_written"] == (r == 0)
    assert groups[(world, 0)]["ppo"]["steps_equal"]


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_train_step_matches_one_process(groups, world):
    t = groups[(world, 0)]["train_step"]
    assert t["batch"] == 2 * world
    assert t["max_param_diff"] <= 1e-6
    for k in ("kl", "loss_pi", "entropy", "clipfrac", "loss_v"):
        assert t[k] == pytest.approx(t["one_process"][k], rel=1e-5,
                                     abs=1e-6), k
