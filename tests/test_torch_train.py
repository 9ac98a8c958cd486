"""The port's trainer on the CPU (``device="cpu"``): ``rl/ppo.py``,
``rl/vpg.py``, ``rl/train.py``, ``cli train``, ``utils/checkpoint.py`` and
``utils/experiment.py``.

Ports, run on the port, of ``tests/test_rl.py``'s trainer tests (end to
end on a tiny 802.11n env, vector rollout equal to sequential, exact resume
with one env and with two, log truncation on a resume between
checkpoints), of ``tests/test_dashboard_vpg.py``'s VPG run, of
``tests/test_envs.py``'s floor-anneal callback and of
``tests/test_utils.py``'s experiment-grid tests, whose variants, names and
output directories are also held equal to the JAX package's; plus ``cli
train`` under ``LDPC_TPU_PLATFORM=cpu``, the batched vector rollout, and
the checkpoint's ``weights_only`` load.  Equalities here are exact: the
same program on the same device, re-run.  ``tests/test_torch_ppo.py``
holds ``ppo`` and ``vpg`` against the JAX package.
"""

import importlib
import json
import shutil

import numpy as np
import pytest
import torch

from ldpc_tpu_torch import cli
from ldpc_tpu_torch.codes import wifi_code
from ldpc_tpu_torch.envs import LdpcCodeSearchEnv
from ldpc_tpu_torch.rl import (ActorCriticConfig, PPOConfig, VPGConfig,
                               action_to_env_action, env_generators,
                               init_params, ppo, sample_step, vpg)
from ldpc_tpu_torch.utils import (ExperimentGrid, latest_step,
                                  restore_checkpoint, save_checkpoint,
                                  setup_logger_kwargs)

rl_train = importlib.import_module("ldpc_tpu_torch.rl.train")
jx_exp = importlib.import_module("ldpc_tpu.utils.experiment")

torch.set_num_threads(1)


def _tiny_env_fn(seed=1):
    return lambda: LdpcCodeSearchEnv(
        code=wifi_code(), snr_points=(3.0, 3.5), num_transmissions=2,
        num_iterations=5, seed=seed, dmax_cn_cap=32, dmax_vn_cap=12,
        device="cpu")


_TINY_AC = dict(hidden=16, row_range=4, col_range=24, z=81, max_hot=4)


def _ac_cfg(env_fn):
    return ActorCriticConfig(obs_dim=env_fn().observation_space.shape[0],
                             **_TINY_AC)


def test_ppo_end_to_end_tiny(tmp_path):
    """Two epochs of PPO against the wifi env: rollout -> buffer -> update
    -> logging -> checkpoint."""
    env_fn = _tiny_env_fn()
    ppo_cfg = PPOConfig(steps_per_epoch=3, epochs=2, train_pi_iters=2,
                        train_v_iters=2, save_freq=1)
    actor, critic, logger = ppo(env_fn, ppo_cfg, _ac_cfg(env_fn),
                                output_dir=tmp_path / "exp",
                                checkpoint_dir=tmp_path / "ckpt",
                                device="cpu")
    progress = (tmp_path / "exp" / "progress.txt").read_text().splitlines()
    assert len(progress) == 3  # header + 2 epochs
    assert "AverageEpRet" in progress[0] or "Epoch" in progress[0]
    assert latest_step(tmp_path / "ckpt") == 1
    state = restore_checkpoint(tmp_path / "ckpt")
    assert state["epoch"] == 1
    assert state["code_first_rows"].shape == (4, 24, 81)
    for k, v in actor.state_dict().items():
        assert torch.equal(state["actor"][k], v)
    assert next(actor.parameters()).device.type == "cpu"


def _steps(path):
    rows = (path / "steps.tsv").read_text().splitlines()
    return rows[0].split("\t"), [r.split("\t") for r in rows[1:]]


def test_ppo_vector_rollout_matches_sequential(tmp_path):
    """num_envs=2: each env's (action, reward, observation) stream is
    IDENTICAL to stepping the same envs one at a time with the same
    per-env generators and seeds (base + 10000 * i)."""
    ppo_cfg = PPOConfig(steps_per_epoch=3, epochs=1, train_pi_iters=0,
                        train_v_iters=0, seed=5)
    env_fn = _tiny_env_fn(seed=3)
    ac_cfg = _ac_cfg(env_fn)
    ppo(env_fn, ppo_cfg, ac_cfg, num_envs=2, output_dir=tmp_path / "vec",
        device="cpu")
    header, data = _steps(tmp_path / "vec")
    assert len(data) == 2 * ppo_cfg.steps_per_epoch
    col = {k: i for i, k in enumerate(header)}

    actor, critic = init_params(ac_cfg, ppo_cfg.seed, device="cpu")
    gens = env_generators(ppo_cfg.seed, 2, "cpu")
    envs = [env_fn(), env_fn()]
    base = envs[0].seed_value
    for i, e in enumerate(envs):
        e.seed(base + 10000 * i)
    obs = [e.reset().astype(np.float32) for e in envs]
    for t in range(ppo_cfg.steps_per_epoch):
        for e in range(2):
            ba = sample_step(ac_cfg, actor, critic,
                             torch.tensor(obs[e][None]), [gens[e]])[0][0]
            next_obs, reward, done, info = envs[e].step(
                action_to_env_action(ac_cfg, ba.numpy()))
            obs[e] = next_obs.astype(np.float32)
            row = [r for r in data
                   if r[col["step"]] == str(t) and r[col["env"]] == str(e)]
            assert len(row) == 1
            row = row[0]
            assert float(row[col["reward"]]) == float(reward)
            assert (int(row[col["i"]]), int(row[col["j"]]),
                    int(row[col["k"]])) == tuple(ba[:3].tolist())
            assert row[col["observation_hex"]] == bytes(
                np.asarray(next_obs, np.uint8)).hex()


def test_ppo_batched_vector_step_equals_sequential(tmp_path):
    """env_batched=True (every candidate decoded with one host read)
    writes the same steps.tsv as sequential stepping."""
    env_fn = _tiny_env_fn(seed=4)
    cfg = PPOConfig(steps_per_epoch=2, epochs=2, train_pi_iters=1,
                    train_v_iters=1, seed=3)
    for name, batched in (("seq", False), ("bat", True)):
        ppo(env_fn, cfg, _ac_cfg(env_fn), num_envs=2, env_batched=batched,
            output_dir=tmp_path / name, device="cpu")
    assert (tmp_path / "bat" / "steps.tsv").read_text() == \
        (tmp_path / "seq" / "steps.tsv").read_text()


def _resume_case(tmp_path, seed, num_envs, cfg_kw, full_epochs,
                 split_epochs, drop=()):
    env_fn = _tiny_env_fn(seed=seed)
    ac_cfg = _ac_cfg(env_fn)

    def run(epochs, out, ckpt, resume=False):
        cfg = PPOConfig(epochs=epochs, save_freq=1, **cfg_kw)
        return ppo(env_fn, cfg, ac_cfg, num_envs=num_envs, output_dir=out,
                   checkpoint_dir=ckpt, resume=resume, device="cpu")

    run(full_epochs, tmp_path / "full", tmp_path / "ckpt_full")
    run(split_epochs, tmp_path / "split", tmp_path / "ckpt_split")
    for step in drop:
        shutil.rmtree(tmp_path / "ckpt_split" / step)
    run(full_epochs, tmp_path / "split", tmp_path / "ckpt_split",
        resume=True)
    full = (tmp_path / "full" / "steps.tsv").read_text()
    split = (tmp_path / "split" / "steps.tsv").read_text()
    assert split == full


def test_ppo_resume_exact(tmp_path):
    """Kill a run at epoch k, resume, and the merged steps.tsv is IDENTICAL
    to an uninterrupted run's; so are the final checkpoints: parameters,
    optimiser states, generators, env code and budgets."""
    _resume_case(tmp_path, 2, 1, dict(steps_per_epoch=2, train_pi_iters=2,
                                      train_v_iters=2, seed=9), 4, 2)
    a = restore_checkpoint(tmp_path / "ckpt_full")
    b = restore_checkpoint(tmp_path / "ckpt_split")
    assert int(a["epoch"]) == int(b["epoch"]) == 3
    assert torch.equal(a["code_first_rows"], b["code_first_rows"])
    assert all(torch.equal(x, y) for x, y in zip(a["rng"], b["rng"]))
    for k in ("actor", "critic"):
        for name, v in a[k].items():
            assert torch.equal(v, b[k][name]), (k, name)
    for k in ("pi_opt", "vf_opt"):
        for idx, st in a[k]["state"].items():
            for name, v in st.items():
                assert torch.equal(v, b[k]["state"][idx][name]), (k, name)
    for name, v in a["env"].items():
        if name != "acc_time":      # wall-clock seconds
            assert torch.equal(v, b["env"][name]), name


def test_ppo_resume_exact_multi_env(tmp_path):
    """Resume exactness with num_envs=2: the stacked per-env state (codes,
    budgets, MT19937 states, episode accumulators, generators) restores."""
    _resume_case(tmp_path, 6, 2, dict(steps_per_epoch=2, train_pi_iters=1,
                                      train_v_iters=1, seed=13), 3, 1)


def test_ppo_resume_between_checkpoints_truncates_logs(tmp_path):
    """A crash after epoch 1's checkpoint (epoch 2 logged, its checkpoint
    lost): resume drops epoch 2's rows and re-runs it exactly."""
    _resume_case(tmp_path, 8, 1, dict(steps_per_epoch=2, train_pi_iters=1,
                                      train_v_iters=1, seed=21), 4, 3,
                 drop=("2",))
    prog = (tmp_path / "split" / "progress.txt").read_text().splitlines()
    assert [row.split("\t")[0] for row in prog[1:]] == ["0", "1", "2", "3"]


def test_ppo_refuses_what_it_cannot_do(tmp_path):
    env_fn = _tiny_env_fn()
    with pytest.raises(ValueError, match="needs a checkpoint_dir"):
        ppo(env_fn, PPOConfig(epochs=0), _ac_cfg(env_fn), resume=True,
            output_dir=tmp_path, device="cpu")

    class OtherDevice:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="same device"):
        ppo(OtherDevice, PPOConfig(epochs=0), device="cpu")


def test_ppo_meshes_and_dryrun_train_step_on_one_rank(tmp_path):
    """``mesh=`` and ``env_mesh=`` (once refused, waiting for
    ``parallel/``) on a one-rank gloo group: the same steps.tsv as the
    run without meshes, parameters within float rounding (the sharded
    losses are sums over the global count, not ``torch.mean``); and
    ``dryrun_train_step`` within rounding of its one-process update.  On 2
    and 4 ranks: ``tests/test_torch_parallel.py``."""
    import torch.distributed as dist
    from ldpc_tpu_torch.parallel import make_mesh
    env_fn = _tiny_env_fn()
    cfg = PPOConfig(steps_per_epoch=2, epochs=2, train_pi_iters=2,
                    train_v_iters=2, seed=7)
    mesh = make_mesh(device="cpu")
    try:
        runs = {}
        for name, m in (("mesh", mesh), ("plain", None)):
            actor, critic, _ = ppo(env_fn, cfg, _ac_cfg(env_fn), num_envs=2,
                                   mesh=m, env_mesh=m,
                                   output_dir=tmp_path / name, device="cpu")
            runs[name] = [p.detach() for p in (*actor.parameters(),
                                               *critic.parameters())]
        step = rl_train.dryrun_train_step(mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    assert (tmp_path / "mesh" / "steps.tsv").read_text() == \
        (tmp_path / "plain" / "steps.tsv").read_text()
    for p, q in zip(runs["mesh"], runs["plain"]):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)
    assert step["batch"] == 2 and step["max_param_diff"] <= 1e-6


def test_vpg_end_to_end_tiny(tmp_path):
    env_fn = _tiny_env_fn(seed=2)
    cfg = VPGConfig(steps_per_epoch=3, epochs=2, train_v_iters=2)
    actor, critic, logger = vpg(env_fn, cfg, _ac_cfg(env_fn),
                                output_dir=tmp_path / "exp", device="cpu")
    progress = (tmp_path / "exp" / "progress.txt").read_text().splitlines()
    assert len(progress) == 3
    again = vpg(env_fn, cfg, _ac_cfg(env_fn), output_dir=tmp_path / "again",
                device="cpu")[0]
    for k, v in actor.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])


def test_train_floor_anneal_epoch_callback(tmp_path):
    """--floor_penalty_final wires a pure-function-of-epoch schedule into
    ppo's epoch_callback: scale 1.0 at epoch 0, final/initial at the last
    epoch, identical on resume (recomputed, not replayed)."""
    import unittest.mock as mock

    class _Env:
        floor_penalty_scale = 1.0

    def run(argv):
        with mock.patch.object(rl_train, "ppo") as fake:
            rl_train.main(argv, device="cpu")
            return fake.call_args.kwargs

    kw = run(["--epochs", "5", "--steps", "2",
              "--floor_penalty", "30", "60", "--floor_snr_index", "3", "4",
              "--floor_penalty_final", "180",
              "--data_dir", str(tmp_path), "--exp_name", "anneal"])
    assert kw["device"] == "cpu"
    cb = kw["epoch_callback"]
    env = _Env()
    cb(0, [env])
    assert env.floor_penalty_scale == 1.0
    cb(4, [env])
    np.testing.assert_allclose(env.floor_penalty_scale, 3.0)  # 180/60
    cb(2, [env])
    np.testing.assert_allclose(env.floor_penalty_scale, 2.0)
    # no anneal flag -> no callback
    kw = run(["--epochs", "3", "--steps", "2", "--floor_penalty", "30",
              "--data_dir", str(tmp_path), "--exp_name", "anneal2"])
    assert kw["epoch_callback"] is None


@pytest.mark.parametrize("sep", [[], ["--"]], ids=["plain", "dashdash"])
def test_cli_train_on_the_cpu(monkeypatch, tmp_path, sep):
    """``cli train`` with the JAX CLI's arguments, on the CPU under
    LDPC_TPU_PLATFORM=cpu: an 802.11n search, one epoch of two steps."""
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    actor, critic, logger = cli.main(
        ["train"] + sep + ["--start_code", "wifi", "--snr", "3.0", "3.5",
                           "--num_transmissions", "2", "--steps", "2",
                           "--epochs", "1", "--cpu", "2", "--seed", "4",
                           "--data_dir", str(tmp_path),
                           "--exp_name", "t"])
    out = tmp_path / "t" / "t_s4"
    header, rows = _steps(out)
    assert len(rows) == 4 and header[:3] == ["epoch", "step", "env"]
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["num_envs"] == 2 and cfg["model"]["z"] == 81
    assert cfg["ppo"]["train_pi_iters"] == 80
    assert latest_step(tmp_path / "t" / "checkpoints") == 0
    assert next(actor.parameters()).device.type == "cpu"


def test_checkpoint_roundtrip_and_weights_only(tmp_path):
    state = {"a": torch.arange(3), "nested": {"g": torch.Generator(
        ).manual_seed(2).get_state(), "n": 3},
        "opt": torch.optim.Adam([torch.nn.Parameter(torch.ones(2))]
                                ).state_dict()}
    save_checkpoint(tmp_path, 4, state)
    save_checkpoint(tmp_path, 12, state)
    assert latest_step(tmp_path) == 12 and latest_step(tmp_path / "x") is None
    got = restore_checkpoint(tmp_path, step=4, template=state)
    assert torch.equal(got["a"], state["a"]) and got["nested"]["n"] == 3
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(tmp_path, template={"a": 0, "b": 1})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty")
    # the load is weights_only: a numpy array in a state is refused
    save_checkpoint(tmp_path, 20, {"np": np.zeros(3)})
    with pytest.raises(Exception, match="(?i)weights_only|unpickl"):
        restore_checkpoint(tmp_path)


def test_setup_logger_kwargs_convention(tmp_path):
    kw = setup_logger_kwargs("exp", seed=3, data_dir=str(tmp_path))
    assert kw["output_dir"].endswith("exp/exp_s3")
    kw2 = setup_logger_kwargs("exp", data_dir=str(tmp_path))
    assert kw2["output_dir"].endswith("exp")
    for args in (("exp", 3), ("exp", None), ("a_b-1", 0)):
        assert setup_logger_kwargs(*args, data_dir=str(tmp_path)) == \
            jx_exp.setup_logger_kwargs(*args, data_dir=str(tmp_path))


def _both_grids(name, adds):
    """The same grid built in both packages."""
    grids = ExperimentGrid(name), jx_exp.ExperimentGrid(name)
    for g in grids:
        for args, kw in adds:
            g.add(*args, **kw)
    return grids


def _assert_grids_equal(port, jax_grid):
    vs = port.variants()
    assert vs == jax_grid.variants()
    assert [port.variant_name(v) for v in vs] == \
        [jax_grid.variant_name(v) for v in vs]


def test_experiment_grid_variants_and_names():
    g, jg = _both_grids("sweep", [(("seed", [0, 1]), {"in_name": True}),
                                  (("lr", [1e-3]), {})])
    vs = g.variants()
    assert len(vs) == 2
    assert vs[0] == {"seed": 0, "lr": 1e-3}
    assert "see-0" in g.variant_name(vs[0])
    _assert_grids_equal(g, jg)


@pytest.mark.parametrize("name,adds", [
    ("", [(("ppo_cfg:seed", [0, 1]), {}),
          (("ppo_cfg:steps_per_epoch", 32), {})]),
    ("b", [(("env.entropy_bonus", [True, False]), {}),
           (("x", [3]), {"shorthand": "xx", "in_name": True})]),
    ("t", [(("snr", [(3.0, 3.5), [4.0]]), {}),
           (("act", [np.tanh, len]), {"shorthand": "f"}),
           (("dir", ["a/b c", "D"]), {})]),
    ("", [(("lr", [1e-3]), {})]),
], ids=["keys", "bools", "values", "unnamed"])
def test_experiment_grid_names_agree_with_jax(name, adds):
    """The port's grid gives the JAX package's variants and names: colon
    and dotted keys, bools, shorthands, tuples, functions, odd strings, and
    a grid whose name is empty."""
    _assert_grids_equal(*_both_grids(name, adds))


def test_experiment_grid_runs_the_trainer(tmp_path):
    """The grid runs ``ppo`` over its variants in-process."""
    env_fn = _tiny_env_fn()
    g = ExperimentGrid("t").add("seed", [0, 1])

    def thunk(output_dir, exp_name, seed):
        return ppo(env_fn, PPOConfig(steps_per_epoch=2, epochs=1,
                                     train_pi_iters=1, train_v_iters=1,
                                     seed=seed), _ac_cfg(env_fn),
                   output_dir=output_dir, device="cpu")

    results = g.run(thunk, data_dir=str(tmp_path))
    assert len(results) == 2
    # the JAX grid calls its thunk with the same arguments
    calls = jx_exp.ExperimentGrid("t").add("seed", [0, 1]).run(
        lambda **kw: kw, data_dir=str(tmp_path))
    assert g.run(lambda **kw: kw, data_dir=str(tmp_path)) == calls
    assert results[1][2].output_dir == tmp_path / "t_see-1" / "t_see-1_s1"
    assert (results[1][2].output_dir / "steps.tsv").exists()
    w = [r[0].state_dict()["encoder.dense.0.weight"] for r in results]
    assert not torch.equal(w[0], w[1])
