"""Whole runs of the port's DDPG, TD3 and SAC (``ldpc_tpu_torch/rl/
{ddpg,sac}.py``) against the JAX package's, on ``PointMassEnv``, from the
same initial weights and with the same noise.

The JAX run initialises its networks from its seed as it always does; the
port's ``init_nets`` is patched to load those same weights (carried across
by ``params_from_jax``).  numpy's ``RandomState`` draws the warm-up
actions, DDPG's exploration noise and the replay indices in both packages,
so DDPG needs nothing more.  TD3's smoothing noise and SAC's actor noise
are Gaussian draws: ``jax.random.normal`` is wrapped to record each draw
(an ordered ``jax.debug.callback``; the runs stay jitted) and the port's
``continuous.gaussian_noise`` is patched to hand the recorded draws out in
call order, so both runs use one table of noise.

Every epoch's logged row (returns and losses) agrees within rtol 1e-4
(atol 1e-6), and every final parameter within ``PARAM_ATOL = 1e-5``, but
for a few elements that Adam moves on rounding-level gradients: an
element whose gradient sits at rounding level (a ReLU unit at its kink
on the batch's one active row) steps by up to lr whichever sign the
rounding gives it, so at most ``ADAM_OUTLIERS`` elements of a tensor may
differ by up to lr x the steps taken (measured: 3 of the actor's 4,096
second-layer weights in TD3, by up to 5.6e-4 after 24 policy steps; every
other element within 6e-6).

The runs are 2 epochs of 32 steps, updates from step 16, 8 every 8 steps
(48 updates).  Longer runs diverge by chaos: the few elements above feed
the policy, the policy the data, and the data the next updates.  At 2
epochs of 64 steps with updates from step 32, 16 every 16 (96 updates),
the second epoch's returns differed by 6.3e-3 (DDPG), 6.5e-4 (TD3) and
5.6e-3 (SAC, auto-alpha) of their value, and parameters by up to 2.5e-2,
although the first epoch agreed to 1e-5; at 48 updates the worst logged
difference is 5.2e-5 of its value.
"""

import importlib
import io
import pathlib
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.utils.logging import EpochLogger as JaxLogger
from ldpc_tpu_torch.utils.logging import EpochLogger

# the modules (``rl`` exports functions of the same names)
jc, jd, js = (importlib.import_module(f"ldpc_tpu.rl.{m}")
              for m in ("continuous", "ddpg", "sac"))
tc, td, ts = (importlib.import_module(f"ldpc_tpu_torch.rl.{m}")
              for m in ("continuous", "ddpg", "sac"))

torch.set_num_threads(1)

PARAM_ATOL = 1e-5
ADAM_OUTLIERS = 4
LOG_RTOL, LOG_ATOL = 1e-4, 1e-6
SEED = 4
SHORT = dict(steps_per_epoch=32, epochs=2, start_steps=16, update_after=16,
             update_every=8, seed=SEED)
UPDATES = 48
OBS0, ACT0 = jnp.zeros((1, 2)), jnp.zeros((1, 1))


def _env():
    return jc.PointMassEnv(seed=SEED)


def _port_env():
    return tc.PointMassEnv(seed=SEED)


def _loggers(tmp_path, name):
    with redirect_stdout(io.StringIO()):
        return (JaxLogger(output_dir=tmp_path / f"jax_{name}"),
                EpochLogger(output_dir=tmp_path / f"port_{name}"))


def _rows(path: pathlib.Path) -> list[dict]:
    lines = (path / "progress.txt").read_text().splitlines()
    head = lines[0].split("\t")
    return [dict(zip(head, map(float, ln.split("\t")))) for ln in lines[1:]]


def _assert_logs_agree(tmp_path, name):
    want, got = (_rows(tmp_path / f"{side}_{name}")
                 for side in ("jax", "port"))
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            if k != "Time":
                np.testing.assert_allclose(g[k], w[k], rtol=LOG_RTOL,
                                           atol=LOG_ATOL, err_msg=k)


def _assert_params_close(module, tree, lr_steps=0.0):
    """Every element within PARAM_ATOL, but for at most ADAM_OUTLIERS a
    tensor within ``lr_steps`` (lr x the Adam steps taken)."""
    want = tc.params_from_jax(jax.device_get(tree))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        diff = (got[k] - v).abs()
        out = diff > PARAM_ATOL
        assert int(out.sum()) <= ADAM_OUTLIERS, (k, int(out.sum()))
        assert float(diff.max()) <= max(PARAM_ATOL, lr_steps), \
            (k, float(diff.max()))


class _Draws:
    """JAX's Gaussian draws, recorded in call order, handed to the port in
    the same order."""

    def __init__(self):
        self.draws, self.pos = [], 0

    def record(self, x):
        self.draws.append(np.array(x))

    def take(self, shape):
        x = self.draws[self.pos]
        assert x.shape == tuple(shape), (x.shape, shape)
        self.pos += 1
        return x


def _share_noise(monkeypatch) -> _Draws:
    table = _Draws()
    normal = jax.random.normal

    def recorded(key, shape=(), dtype=jnp.float32):
        x = normal(key, shape, dtype)
        jax.debug.callback(table.record, x, ordered=True)
        return x

    monkeypatch.setattr(jax.random, "normal", recorded)
    monkeypatch.setattr(tc, "gaussian_noise",
                        lambda shape, generator, device: torch.as_tensor(
                            table.take(shape), device=device))
    return table


def _jax_actor_critics(actor, seed):
    """The JAX run's own initial weights (its key split in three)."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    return jax.device_get((actor.init(k1, OBS0),
                           jc.QCritic().init(k2, OBS0, ACT0),
                           jc.QCritic().init(k3, OBS0, ACT0)))


def _carry(factories, trees):
    """An ``init_nets`` that loads ``trees`` into new networks."""
    def init_nets(*args):
        nets = [f() for f in factories]
        for n, t in zip(nets, trees):
            n.load_state_dict(tc.params_from_jax(t))
        device = args[-1]
        return [n.to(device) for n in nets]
    return init_nets


@pytest.mark.parametrize("algo", ["ddpg", "td3"])
def test_ddpg_td3_runs_agree(tmp_path, monkeypatch, algo):
    td3_mode = algo == "td3"
    trees = _jax_actor_critics(jc.DeterministicActor(1, 1.0), SEED)
    init = _carry([lambda: tc.DeterministicActor(2, 1, 1.0),
                   lambda: tc.QCritic(2, 1), lambda: tc.QCritic(2, 1)], trees)
    monkeypatch.setattr(td, "init_nets", lambda *a: dict(
        zip(("pi", "q1", "q2"), init(*a))))
    table = _share_noise(monkeypatch)
    jlog, tlog = _loggers(tmp_path, algo)
    cfg = td.DDPGConfig(**SHORT)
    with redirect_stdout(io.StringIO()):
        jp, _ = jd.ddpg(_env, jd.DDPGConfig(**SHORT), td3_mode=td3_mode,
                        logger=jlog)
        tp, _ = td.ddpg(_port_env, cfg, td3_mode=td3_mode, logger=tlog,
                        device="cpu")
    # TD3: one [batch, 1] smoothing draw an update; DDPG: none
    assert len(table.draws) == table.pos == (UPDATES if td3_mode else 0)
    _assert_logs_agree(tmp_path, algo)
    pi_steps = UPDATES // (cfg.policy_delay if td3_mode else 1)
    _assert_params_close(tp["pi"], jp["pi"], cfg.pi_lr * pi_steps)
    for k in ("q1", "q2"):
        _assert_params_close(tp[k], jp[k], cfg.q_lr * UPDATES)


@pytest.mark.parametrize("auto_alpha", [False, True])
def test_sac_runs_agree(tmp_path, monkeypatch, auto_alpha):
    trees = _jax_actor_critics(jc.SquashedGaussianActor(1, 1.0), SEED)
    init = _carry([lambda: tc.SquashedGaussianActor(2, 1, 1.0),
                   lambda: tc.QCritic(2, 1), lambda: tc.QCritic(2, 1)], trees)
    monkeypatch.setattr(ts, "init_nets", lambda *a: dict(
        zip(("pi", "q1", "q2"), init(*a))))
    table = _share_noise(monkeypatch)
    jlog, tlog = _loggers(tmp_path, "sac")
    cfg = dict(SHORT, auto_alpha=auto_alpha)
    with redirect_stdout(io.StringIO()):
        jp, _, _ = js.sac(_env, js.SACConfig(**cfg), logger=jlog)
        tp, _, act_det = ts.sac(_port_env, ts.SACConfig(**cfg), logger=tlog,
                                device="cpu")
    # an acting draw a step from step 16, then two draws an update
    acting = SHORT["epochs"] * SHORT["steps_per_epoch"] - SHORT[
        "start_steps"]
    assert len(table.draws) == table.pos == acting + 2 * UPDATES
    _assert_logs_agree(tmp_path, "sac")
    lr = ts.SACConfig().lr
    for k in ("pi", "q1", "q2"):
        _assert_params_close(tp[k], jp[k], lr * UPDATES)
    assert abs(float(tp["log_alpha"]) - float(jp["log_alpha"])) <= \
        PARAM_ATOL
    moved = abs(float(tp["log_alpha"]) - np.log(0.2)) > 1e-3
    assert moved == auto_alpha
    obs = np.random.default_rng(0).standard_normal((5, 2)).astype(np.float32)
    want = jc.SquashedGaussianActor(1, 1.0).apply(jp["pi"], obs,
                                                  deterministic=True)[0]
    np.testing.assert_allclose(act_det(tp["pi"], obs).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
