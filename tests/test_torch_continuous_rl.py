"""Integration tests of the port's continuous-control suite
(``ldpc_tpu_torch.rl``: trpo/ddpg/td3/sac), the JAX package's
``tests/test_continuous_rl.py`` run on the port, on the CPU: each algorithm
improves the return on the built-in point-mass env over a random policy,
TRPO keeps its KL within the trust region, SAC's auto-alpha moves the
temperature, and the gymnasium adapter drives a short SAC run.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.rl import (DDPGConfig, PointMassEnv, SACConfig,
                               TRPOConfig, ddpg, sac, td3, trpo)
from ldpc_tpu_torch.utils.logging import EpochLogger

torch.set_num_threads(1)


def eval_policy(env, act_fn, episodes=5):
    rets = []
    for _ in range(episodes):
        obs = env.reset()
        total = 0.0
        done = False
        while not done:
            obs, r, done, _ = env.step(act_fn(obs))
            total += r
        rets.append(total)
    return float(np.mean(rets))


def random_baseline(seed=123):
    env = PointMassEnv(seed=seed)
    rng = np.random.RandomState(0)
    return eval_policy(env, lambda o: rng.uniform(-1, 1, 1))


def quiet_logger(tmp_path, name):
    with redirect_stdout(io.StringIO()):
        return EpochLogger(output_dir=tmp_path / name)


def _module_policy(module):
    def act(o):
        with torch.no_grad():
            out = module(torch.as_tensor(o[None], dtype=torch.float32))
        return (out[0] if isinstance(out, tuple) else out)[0].numpy()
    return act


@pytest.mark.parametrize("algo", ["ddpg", "td3"])
def test_ddpg_td3_improve_over_random(tmp_path, algo):
    fn = td3 if algo == "td3" else ddpg
    cfg = DDPGConfig(steps_per_epoch=256, epochs=8, start_steps=256,
                     update_after=256, seed=1)
    with redirect_stdout(io.StringIO()):
        nets, _ = fn(lambda: PointMassEnv(seed=1), cfg,
                     logger=quiet_logger(tmp_path, algo), device="cpu")
    score = eval_policy(PointMassEnv(seed=77), _module_policy(nets["pi"]))
    assert score > random_baseline() + 2.0


def test_sac_improves_over_random(tmp_path):
    cfg = SACConfig(steps_per_epoch=256, epochs=4, start_steps=128,
                    update_after=128, seed=2)
    with redirect_stdout(io.StringIO()):
        params, _, act_det = sac(lambda: PointMassEnv(seed=2), cfg,
                                 logger=quiet_logger(tmp_path, "sac"),
                                 device="cpu")
    score = eval_policy(PointMassEnv(seed=77),
                        lambda o: act_det(params["pi"], o[None])[0].numpy())
    assert score > random_baseline() + 2.0


def test_trpo_improves_and_respects_trust_region(tmp_path):
    cfg = TRPOConfig(steps_per_epoch=256, epochs=6, seed=3)
    with redirect_stdout(io.StringIO()):
        actor, _, _ = trpo(lambda: PointMassEnv(seed=3), cfg,
                           logger=quiet_logger(tmp_path, "trpo"),
                           device="cpu")
    # the mean action
    score = eval_policy(PointMassEnv(seed=77), _module_policy(actor))
    assert score > random_baseline() + 1.0
    # every epoch's KL stayed within ~the trust region
    progress = (tmp_path / "trpo" / "progress.txt").read_text().splitlines()
    header = progress[0].split("\t")
    kl_col = header.index("KL")
    kls = [float(row.split("\t")[kl_col]) for row in progress[1:]]
    assert len(kls) == cfg.epochs
    assert max(kls) < 5 * cfg.delta


def test_sac_auto_alpha_tunes_temperature(tmp_path):
    """auto_alpha=True learns log_alpha: it must move from its init and
    training must still improve over random."""
    cfg = SACConfig(steps_per_epoch=256, epochs=4, start_steps=128,
                    update_after=128, seed=2, auto_alpha=True, alpha=0.2)
    with redirect_stdout(io.StringIO()):
        params, _, act_det = sac(lambda: PointMassEnv(seed=2), cfg,
                                 logger=quiet_logger(tmp_path, "sac_aa"),
                                 device="cpu")
    assert abs(float(params["log_alpha"]) - np.log(0.2)) > 1e-3
    score = eval_policy(PointMassEnv(seed=77),
                        lambda o: act_det(params["pi"], o[None])[0].numpy())
    assert score > random_baseline() + 2.0


def test_gymnasium_adapter_api(tmp_path):
    """The adapter exposes the flat API on a real gymnasium Box env and a
    short SAC run on it executes end-to-end."""
    gymnasium = pytest.importorskip("gymnasium")
    from ldpc_tpu_torch.rl.continuous import GymnasiumAdapter

    env = GymnasiumAdapter(gymnasium.make("Pendulum-v1"))
    assert env.obs_dim == 3 and env.act_dim == 1 and env.act_limit == 2.0
    obs = env.reset()
    assert obs.shape == (3,)
    obs2, r, done, info = env.step(np.zeros(1))
    assert obs2.shape == (3,) and isinstance(r, float)
    assert "truncated" in info

    cfg = SACConfig(steps_per_epoch=64, epochs=1, start_steps=32,
                    update_after=32, update_every=16, seed=0)
    with redirect_stdout(io.StringIO()):
        params, _, act_det = sac(
            lambda: GymnasiumAdapter(gymnasium.make("Pendulum-v1")), cfg,
            logger=quiet_logger(tmp_path, "gym_sac"), device="cpu")
    a = act_det(params["pi"], obs[None])[0]
    assert a.shape == (1,) and abs(float(a[0])) <= 2.0


def test_entry_points_default_to_the_card():
    """device=None means the card: without one each entry point raises
    rather than training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn, cfg in ((ddpg, DDPGConfig(epochs=1)), (sac, SACConfig(epochs=1)),
                    (trpo, TRPOConfig(epochs=1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(PointMassEnv, cfg)
