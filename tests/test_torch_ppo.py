"""The port's PPO updates and trainer (``ldpc_tpu_torch/rl/ppo.py``)
against the JAX package's (``ldpc_tpu/rl/ppo.py``, optax), from the same
weights carried across by ``params_from_jax``, on the same numpy inputs.

* ``make_update_fns``: K = 20 policy and value steps on one fixed batch.
  The losses and the extras (``kl``, ``loss_pi``, ``clipfrac``,
  entropies) of each iteration agree to 1e-5 absolute (float32 means of
  O(1) values; measured 6e-7), ``clipfrac`` exactly, and the KL early stop
  falls on the same iteration.  The parameters after K steps agree to
  ``PARAM_ATOL = 1e-5``.
* ``ppo`` for 2 epochs with ``deterministic_eval=True`` in both packages,
  the same carried initial weights (each module's ``init_params``
  patched) and a stub env of the test's own whose observation and reward
  are fixed functions of the actions (the real env's channel noise is
  threefry in one package and Philox in the other): ``steps.tsv`` has the
  same actions, rewards and observations, values and log-probs within
  the model tests' tolerance (rtol 1e-5, atol 1e-4), the same early-stop
  iterations, and the final parameters agree to ``PARAM_ATOL``, with one
  exception below.
* ``vpg`` (``ldpc_tpu_torch/rl/vpg.py``) for 2 epochs in both packages
  the same way, each acting by ``mode``: the same actions, LossPi, LossV
  and VVals within rtol 1e-5 + 1e-5, and every parameter within
  ``PARAM_ATOL``.

Adam divides by sqrt(v): an element whose gradient sits at rounding level
steps by up to lr on one side whatever the other side does.  That happens
to the weights into a first-layer unit that tanh holds in its flat tail on
every row (``_saturated_units``: the observations are raw bytes, up to
255), where XLA's and torch's float32 tanh round differently.  Those rows
alone get lr x their Adam steps; at most two units a layer may be such, and
every element that carries a real gradient stays at ``PARAM_ATOL``, so a
real difference in the loss, the optimiser or the model still fails.  The
update test's batch (observations / 255) has no such unit: all of its
elements end within 3e-7.
"""

import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu_torch.rl import (Actor, ActorCriticConfig, Critic, PPOConfig,
                               VPGConfig, make_update_fns, params_from_jax,
                               ppo, sample_step, vpg)

jm = importlib.import_module("ldpc_tpu.rl.model")
jp = importlib.import_module("ldpc_tpu.rl.ppo")
jv = importlib.import_module("ldpc_tpu.rl.vpg")
port_ppo = importlib.import_module("ldpc_tpu_torch.rl.ppo")
port_vpg = importlib.import_module("ldpc_tpu_torch.rl.vpg")

torch.set_num_threads(1)

SMALL = dict(obs_dim=32, hidden=16, row_range=2, col_range=4, z=31,
             max_hot=3)
PARAM_ATOL = 1e-5
EXTRAS_ATOL = 1e-5


def _carried(seed):
    jcfg, cfg = jm.ActorCriticConfig(**SMALL), ActorCriticConfig(**SMALL)
    ap, cp = jax.device_get(jax.jit(jm.init_params, static_argnums=(0, 1))(
        jcfg, seed))

    def port_init(*_, device=None):
        asd, csd = params_from_jax(ap, cp)
        actor, critic = Actor(cfg), Critic(cfg)
        actor.load_state_dict(asd)
        critic.load_state_dict(csd)
        return actor.to(device), critic.to(device)

    return jcfg, cfg, (ap, cp), port_init


def _assert_params_close(actor, critic, ap, cp, loose=None):
    """Every element within PARAM_ATOL, but for the rows named in
    ``loose`` ({state_dict name: (row mask, tolerance)})."""
    asd, csd = params_from_jax(ap, cp)
    loose = loose or {}
    for got, want in ((actor.state_dict(), asd), (critic.state_dict(), csd)):
        for k, v in want.items():
            diff = np.abs(got[k].detach().cpu().numpy() - v.numpy())
            tol = np.full(diff.shape[:1], PARAM_ATOL)
            if k in loose:
                rows, wide = loose[k]
                tol[rows] = wide
            tol = tol.reshape((-1,) + (1,) * (diff.ndim - 1))
            assert (diff <= tol).all(), (k, float(diff.max()))


def _saturated_units(kernel, obs):
    """The first layer's units whose gradient sits at rounding level and
    differs between the packages: |a| >= 7.5 on every row (tanh'(a) <
    1.2e-6) and < 9.1 on some.  float32 tanh is +-1 exactly from 8 in XLA
    and from 9.02 in torch: past 9.1 on every row, both gradients are 0."""
    a = np.abs(obs @ np.asarray(kernel))
    return (a >= 7.5).all(0) & (a.min(0) < 9.1)


def test_update_steps_agree_with_optax():
    """K = 20 policy and value steps on one batch (old log-probs the
    policy's own, so the first KL is 0); the KL early stop of the default
    target_kl (0.01: stop where KL > 0.015) read off both sequences."""
    jcfg, cfg, (ap, cp), port_init = _carried(3)
    actor, critic = port_init(device="cpu")
    rng = np.random.default_rng(0)
    b, k_steps = 16, 20
    obs = rng.integers(0, 256, (b, 32)).astype(np.float32) / 255
    act = np.concatenate([rng.integers(0, 2, (b, 1)),
                          rng.integers(0, 4, (b, 1)),
                          rng.integers(1, 4, (b, 1)),
                          rng.integers(0, 31, (b, 3))], 1).astype(np.float32)
    adv = rng.standard_normal(b).astype(np.float32)
    ret = rng.standard_normal(b).astype(np.float32)
    logp_old = np.asarray(jm.evaluate_actions(
        jcfg, ap, jnp.asarray(obs), jnp.asarray(act))["logp"])
    j_pi, j_vf, j_pi_up, j_v_up = jp.make_update_fns(jcfg, jp.PPOConfig())
    pi_opt, vf_opt, pi_up, v_up = make_update_fns(cfg, PPOConfig())
    j_ps, j_vs = j_pi.init(ap), j_vf.init(cp)
    ps, vs = pi_opt(actor.parameters()), vf_opt(critic.parameters())
    assert (ps.defaults["lr"], ps.defaults["betas"], ps.defaults["eps"],
            ps.defaults["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0)
    assert vs.defaults["lr"] == 1e-3
    jx = [jnp.asarray(x) for x in (obs, act, adv, logp_old)]
    tx = [torch.tensor(x) for x in (obs, act, adv, logp_old)]
    want, got = [], []
    for _ in range(k_steps):
        ap, j_ps, ex = j_pi_up(ap, j_ps, *jx)
        cp, j_vs, v_l = j_v_up(cp, j_vs, jx[0], jnp.asarray(ret))
        want.append({**{k: float(v) for k, v in ex.items()},
                     "loss_v": float(v_l)})
        ex = pi_up(actor, ps, *tx)
        v_l = v_up(critic, vs, tx[0], torch.tensor(ret))
        got.append({**{k: float(v) for k, v in ex.items()},
                    "loss_v": float(v_l)})
    assert got[0]["kl"] == 0.0 and abs(want[0]["kl"]) < 1e-7
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= EXTRAS_ATOL, (i, k, g[k], w[k])
        assert g["clipfrac"] == w["clipfrac"], i
    stops = [next(i for i, r in enumerate(rows) if r["kl"] > 0.015)
             for rows in (want, got)]
    # 0.0183 at iteration 2 on both sides, clear of the line
    assert stops == [2, 2] and got[2]["kl"] > 0.015 + 1e-3
    _assert_params_close(actor, critic, ap, cp)


class _StubEnv:
    """32 observation bytes and a reward, each a fixed function of the
    actions taken; never done."""

    weights = np.random.default_rng(1).standard_normal(1 + 2 + 31)

    def __init__(self):
        self.observation_space = types.SimpleNamespace(shape=(32,))
        self.obs = None

    def seed(self, seed=None):
        return [seed]

    def reset(self):
        self.obs = np.arange(32, dtype=np.int64) * 7 % 256
        return self.obs.astype(np.uint8)

    def step(self, action):
        a = np.asarray(action, np.int64)
        reward = float(a @ self.weights)
        self.obs = (self.obs * 5 + np.resize(a, 32) * 37 + 11) % 256
        return self.obs.astype(np.uint8), reward, False, {}


def test_ppo_two_epochs_agree_with_jax(tmp_path, monkeypatch):
    jcfg, cfg, (ap, cp), port_init = _carried(5)
    monkeypatch.setattr(jp, "init_params", lambda *a, **k: (ap, cp))
    monkeypatch.setattr(port_ppo, "init_params", port_init)
    kw = dict(steps_per_epoch=4, epochs=2, train_pi_iters=6,
              train_v_iters=4, target_kl=0.05)
    j_ap, j_cp, _ = jp.ppo(_StubEnv, jp.PPOConfig(**kw), jcfg, num_envs=2,
                           output_dir=tmp_path / "jax",
                           deterministic_eval=True)
    actor, critic, _ = ppo(_StubEnv, PPOConfig(**kw), cfg, num_envs=2,
                           output_dir=tmp_path / "port",
                           deterministic_eval=True, device="cpu")

    def table(name, fname):
        rows = (tmp_path / name / fname).read_text().splitlines()
        return rows[0].split("\t"), [r.split("\t") for r in rows[1:]]

    hdr, want = table("jax", "steps.tsv")
    hdr2, got = table("port", "steps.tsv")
    assert hdr == hdr2 and len(got) == len(want) == 2 * 2 * 4
    for g, w in zip(got, want):
        for k, a, b in zip(hdr, g, w):
            if k in ("value", "logp"):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-5,
                                           atol=1e-4, err_msg=k)
            else:
                assert a == b, (k, g, w)
    hdr, want = table("jax", "progress.txt")
    hdr2, got = table("port", "progress.txt")
    assert hdr == hdr2
    col = hdr.index("StopIter")
    stop = [int(r[col]) for r in got]
    assert stop == [int(r[col]) for r in want]
    # The raw bytes the observations are (up to 255) drive a few first-
    # layer units into tanh's flat tail on every row: each weight into
    # such a unit, and its bias, may step by up to lr an Adam step on
    # either side, whatever the other does (the module docstring), so it
    # gets lr x its steps; every other element PARAM_ATOL.  At most two
    # units a layer may be such (this run: the critic's unit 9, |a| >=
    # 7.95), so the wider tolerance cannot cover a whole net.
    obs = np.concatenate([np.stack([_StubEnv().reset()] * 2)] + [
        np.frombuffer(bytes.fromhex(r[-1]), np.uint8)[None]
        for r in table("port", "steps.tsv")[1]]).astype(np.float32)
    pi_steps = sum(min(s + 1, kw["train_pi_iters"]) for s in stop)
    loose = {}
    for name, kernel, wide in (
            ("encoder.dense.0", ap["params"]["encoder"]["Dense_0"]["kernel"],
             pi_steps * 3e-4),
            ("mlp.dense.0", cp["params"]["MLP_0"]["Dense_0"]["kernel"],
             kw["epochs"] * kw["train_v_iters"] * 1e-3)):
        rows = _saturated_units(kernel, obs)
        assert rows.sum() <= 2, (name, np.flatnonzero(rows))
        loose[name + ".weight"] = loose[name + ".bias"] = (rows, wide)
    _assert_params_close(actor, critic, j_ap, j_cp, loose)


def test_vpg_two_epochs_agree_with_jax(tmp_path, monkeypatch):
    """``vpg`` for 2 epochs in both packages from the same carried weights,
    each acting by ``mode`` (``sample_step`` patched to deterministic), on
    the stub env: the same actions and rewards, so the same batches; each
    epoch's LossPi (its one policy-gradient step), LossV (after its 80
    value steps) and VVals within rtol 1e-5 + ``EXTRAS_ATOL`` (float32
    means of O(1) values; measured 1.1e-6), and every final parameter
    within ``PARAM_ATOL`` (measured 6.3e-7; no first-layer unit of this
    run saturates, so no row is loosened)."""
    jcfg, cfg, (ap, cp), port_init = _carried(7)
    monkeypatch.setattr(jv, "init_params", lambda *a, **k: (ap, cp))
    monkeypatch.setattr(jv, "sample_step", functools.partial(
        jm.sample_step, deterministic=True))
    monkeypatch.setattr(port_vpg, "init_params", port_init)
    monkeypatch.setattr(port_vpg, "sample_step", functools.partial(
        sample_step, deterministic=True))
    acts = {"jax": [], "port": []}

    def recording(side):
        class Env(_StubEnv):
            def step(self, action):
                acts[side].append(np.asarray(action, np.int64))
                return super().step(action)
        return Env

    kw = dict(steps_per_epoch=4, epochs=2)
    j_ap, j_cp, _ = jv.vpg(recording("jax"), jv.VPGConfig(**kw), jcfg,
                           output_dir=tmp_path / "jax")
    actor, critic, _ = vpg(recording("port"), VPGConfig(**kw), cfg,
                           output_dir=tmp_path / "port", device="cpu")
    assert len(acts["port"]) == len(acts["jax"]) == 2 * 4
    for g, w in zip(acts["port"], acts["jax"]):
        assert np.array_equal(g, w)

    def progress(name):
        rows = (tmp_path / name / "progress.txt").read_text().splitlines()
        hdr = rows[0].split("\t")
        return [dict(zip(hdr, r.split("\t"))) for r in rows[1:]]

    want, got = progress("jax"), progress("port")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["Epoch"] == w["Epoch"]
        assert g["AverageReward"] == w["AverageReward"]
        for k in ("LossPi", "LossV", "AverageVVals"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-5,
                                       atol=EXTRAS_ATOL, err_msg=k)
    _assert_params_close(actor, critic, j_ap, j_cp)
