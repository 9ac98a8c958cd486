"""The port's post-hoc analysis (``analysis/postprocess.py``,
``analysis/dashboard.py``, ``cli post-mortem``/``reward-surface``) on the
CPU, held to the JAX package's on the same steps.tsv: ``reward_surface``,
``learning_windows`` and ``action_heatmaps`` equal, ``post_mortem_best_codes``
within 95% intervals (the noise differs: Philox against threefry);
``topk_select`` re-scores every distinct candidate
(ports of ``tests/test_analysis.py:44-89`` and
``tests/test_dashboard_vpg.py:10-27``, plus the functions those leave
out)."""

import json

import numpy as np
import pytest
import torch

from ldpc_tpu.analysis import action_heatmaps as jax_heatmaps
from ldpc_tpu.analysis import post_mortem_best_codes as jax_post_mortem
from ldpc_tpu.analysis import reward_surface as jax_reward_surface
from ldpc_tpu.analysis.postprocess import \
    learning_windows as jax_learning_windows
from ldpc_tpu.analysis.postprocess import _read_steps as jax_read_steps
from ldpc_tpu_torch import cli
from ldpc_tpu_torch.analysis.postprocess import _read_steps
from ldpc_tpu_torch.analysis import (CirculantDashboard, RewardPlotter,
                                     action_heatmaps, learning_windows,
                                     post_mortem_best_codes, reeval_reward,
                                     reward_surface, topk_select)
from ldpc_tpu_torch.codes import compress, near_earth_code, wifi_code
from ldpc_tpu_torch.sim.stats import wilson_interval

torch.set_num_threads(1)

HEADER = ("epoch\tstep\tenv\treward\tvalue\tlogp\ti\tj\tk\t"
          "observation_hex")


def _tsv(path, code, mutated, epochs=2, steps=3):
    """A steps.tsv as ``rl.ppo`` writes it: the best reward (0.9) at epoch
    1, step 2, on the mutated code; the start code elsewhere."""
    obs_hex = bytes(compress(code)).hex()
    mutated_hex = bytes(compress(mutated)).hex()
    rows = [HEADER]
    for e in range(epochs):
        for t in range(steps):
            r = 0.9 if (e, t) == (1, 2) else 0.1 * t
            hx = mutated_hex if (e, t) == (1, 2) else obs_hex
            rows.append(f"{e}\t{t}\t0\t{r}\t0.0\t-2.0\t{t % 2}\t{t}\t2\t{hx}")
    path.write_text("\n".join(rows) + "\n")
    return path


@pytest.fixture()
def steps_tsv(tmp_path):
    wifi = wifi_code()
    return _tsv(tmp_path / "steps.tsv", wifi, wifi.replace_block(0, 0, (7,)))


def _wifi_shape():
    w = wifi_code()
    return dict(block_rows=w.block_rows, block_cols=w.block_cols, z=w.z)


def test_post_mortem_best_codes(steps_tsv):
    results = post_mortem_best_codes(
        steps_tsv, snr_points=(3.5,), num_transmissions=4, max_iters=8,
        device="cpu", **_wifi_shape())
    assert len(results) == 1
    code, stats = results[0]
    assert code.shifts[0][0] == (7,)  # the mutated best code came back
    assert len(stats) == 4


def test_post_mortem_within_ci_of_jax(steps_tsv):
    """The best code re-evaluated in a waterfall point by both packages:
    their FER intervals overlap."""
    kw = dict(snr_points=(2.5,), num_transmissions=256, max_iters=20,
              **_wifi_shape())
    (code, port), = post_mortem_best_codes(steps_tsv, device="cpu", **kw)
    (jcode, ref), = jax_post_mortem(steps_tsv, **kw)
    assert code.shifts == jcode.shifts
    fe = int(port.column("frame_errors").sum())
    jfe = int(ref.column("frame_errors").sum())
    _, lo, hi = wilson_interval(fe, 256)
    _, jlo, jhi = wilson_interval(jfe, 256)
    assert fe > 20 and lo <= jhi and jlo <= hi


def test_action_heatmaps_equal_jax(steps_tsv):
    grids = action_heatmaps(steps_tsv, save_figures=True)
    assert set(grids) == {"i", "j", "k"}
    assert grids["k"].shape == (1, 2)      # k always 2, 2 epochs
    assert grids["i"].shape[1] == 2
    assert (steps_tsv.parent / "heatMapI.png").exists()
    ref = jax_heatmaps(steps_tsv)
    for k in grids:
        np.testing.assert_array_equal(grids[k], ref[k])


def test_learning_windows_equal_jax(tmp_path):
    wifi = wifi_code()
    path = _tsv(tmp_path / "steps.tsv", wifi,
                wifi.replace_block(1, 2, (3,)), epochs=20, steps=4)
    got = learning_windows(_read_steps(path), num=5)
    assert got == jax_learning_windows(jax_read_steps(path), num=5)
    assert [w["window"] for w in got] == ["epochs 0-4", "epochs 8-12",
                                          "epochs 16-20"]


def test_reward_surface_equal_jax(tmp_path):
    slope, bias, reward = reward_surface(save_path=tmp_path / "surf.png")
    assert slope.shape == bias.shape == reward.shape
    i, j = np.unravel_index(np.argmin(slope ** 2 + bias ** 2), slope.shape)
    assert abs(reward[i, j] - 1.0) < 0.2
    assert (tmp_path / "surf.png").exists()
    for a, b in zip((slope, bias, reward), jax_reward_surface()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(reward_surface(3.0, 3.6)[2],
                                  jax_reward_surface(3.0, 3.6)[2])


def test_reeval_reward_and_topk_select(steps_tsv, capsys):
    """Every distinct positive-reward candidate re-scored (none skipped),
    rows best-first on the penalized objective, each floor term with its
    Wilson interval; reeval_reward's mean is the mean of its seeds'."""
    shape = _wifi_shape()
    kw = dict(snr_points=(3.0, 3.5), reeval_transmissions=8,
              reeval_seeds=(1, 2), max_iters=8,
              reeval_kw={"device": "cpu"})
    best, rows = topk_select(
        steps_tsv, **shape, topk=4, floor_penalties=(0.5,),
        floor_snrs=(3.5,), floor_words=16,
        floor_eval_kw={"device": "cpu"}, **kw)
    assert "SKIPPED" not in capsys.readouterr().out
    # positive rewards: 0.1, 0.2 on the start code, 0.9 on the mutated
    assert len(rows) == 2
    assert [r["penalized"] for r in rows] == sorted(
        (r["penalized"] for r in rows), reverse=True)
    assert best is rows[0]["code"]
    for r in rows:
        (f,) = r["floors"]
        assert f["words"] == 16 and f["fer_wilson95"][0] <= f["fer"]
        assert r["penalized"] == pytest.approx(r["reward_mean"] -
                                               0.5 * f["fer"])
    mean, std, per_seed = reeval_reward(rows[0]["code"], (3.0, 3.5), 8, 8,
                                        (1, 2), device="cpu")
    assert mean == pytest.approx(np.mean(per_seed)) and len(per_seed) == 2
    assert mean == pytest.approx(rows[0]["reward_mean"])


def test_cli_post_mortem_and_reward_surface(tmp_path, monkeypatch, capsys):
    """The CLI's defaults are near-earth's shape (2 x 16, z = 511)."""
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    ne = near_earth_code()
    tsv = _tsv(tmp_path / "steps.tsv", ne, ne.replace_block(0, 0, (5,)),
               epochs=2, steps=2)
    out = cli.main(["post-mortem", str(tsv), "--best", "--heatmaps",
                    "--transmissions", "2"])
    assert out["heatmaps"] == {"i": [2, 2], "j": [2, 2], "k": [1, 2]}
    assert len(out["best"]) == 1 and out["best"][0]["transmissions"] == 8
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out["best"][0]
    assert (tmp_path / "heatMapK.png").exists()
    surf = tmp_path / "surface.png"
    slope, _, _ = cli.main(["reward-surface", "--out", str(surf)])
    assert surf.exists() and slope.shape == (60, 60)


def test_circulant_dashboard(tmp_path):
    code = wifi_code()
    dash = CirculantDashboard(code, file_name=tmp_path / "dash.png")
    dash.update_ber([3.0, 4.0], [1e-2, 1e-4], label="wifi")
    dash.update_circulant(code.replace_block(0, 0, (3, 5)))
    assert (tmp_path / "dash.png").exists()
    dash.close()


def test_reward_plotter(tmp_path):
    rp = RewardPlotter(file_name=tmp_path / "r.png")
    for r in (0.1, 0.5, -2.0):
        rp.append(r)
    assert (tmp_path / "r.png").exists()
    rp.close()
