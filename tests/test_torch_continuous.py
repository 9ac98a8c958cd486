"""The port's continuous-control building blocks
(``ldpc_tpu_torch/rl/continuous.py``) against the JAX package's
(``ldpc_tpu/rl/continuous.py``), on the same numpy inputs, with the flax
weights carried across by ``params_from_jax``.

Forward passes, ``log_prob``, ``kl`` and the squashed actor's action and
log-prob under the same noise agree within rtol 1e-5, atol 1e-5 (float32
matmuls summed in another order); the replay buffer samples the same rows,
the point-mass env follows the same trajectory and Polyak averaging gives
the same parameters.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ldpc_tpu.rl import continuous as jc

from ldpc_tpu_torch.rl import continuous as tc

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
OBS_DIM, ACT_DIM, B = 5, 3, 17


def _obs(seed=0, b=B, d=OBS_DIM):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(
        np.float32)


def _carried(jmodule, tmodule, *args, seed=0):
    params = jax.device_get(jmodule.init(jax.random.key(seed), *args))
    tmodule.load_state_dict(tc.params_from_jax(params))
    return params, tmodule


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act_limit", [1.0, 2.5])
def test_deterministic_actor_forward(act_limit):
    obs = _obs(1)
    p, actor = _carried(jc.DeterministicActor(ACT_DIM, act_limit),
                        tc.DeterministicActor(OBS_DIM, ACT_DIM, act_limit),
                        jnp.zeros((1, OBS_DIM)))
    want = jc.DeterministicActor(ACT_DIM, act_limit).apply(p, obs)
    _close(actor(torch.tensor(obs)), want)


def test_gaussian_actor_forward_log_prob_kl():
    obs = _obs(2)
    jm = jc.GaussianActor(ACT_DIM)
    p, actor = _carried(jm, tc.GaussianActor(OBS_DIM, ACT_DIM),
                        jnp.zeros((1, OBS_DIM)))
    assert torch.equal(actor.log_std.detach(), torch.full((ACT_DIM,), -0.5))
    mu_j, ls_j = jm.apply(p, obs)
    mu, ls = actor(torch.tensor(obs))
    _close(mu, mu_j)
    _close(ls, ls_j)
    rng = np.random.default_rng(3)
    act = rng.standard_normal((B, ACT_DIM)).astype(np.float32)
    _close(tc.GaussianActor.log_prob(mu, ls, torch.tensor(act)),
           jc.GaussianActor.log_prob(mu_j, ls_j, act))
    mu1 = rng.standard_normal((B, ACT_DIM)).astype(np.float32)
    ls1 = rng.uniform(-1, 0.5, (B, ACT_DIM)).astype(np.float32)
    _close(tc.GaussianActor.kl(mu, ls, torch.tensor(mu1), torch.tensor(ls1)),
           jc.GaussianActor.kl(mu_j, ls_j, mu1, ls1))


def test_gaussian_kl_zero_for_identical():
    mu = torch.zeros((3, 2))
    ls = torch.full((3, 2), -0.5)
    assert float(tc.GaussianActor.kl(mu, ls, mu, ls).abs().max()) < 1e-6


@pytest.mark.parametrize("act_limit", [1.0, 2.0])
def test_squashed_actor_same_noise(act_limit):
    """The action and its log-prob (with the softplus tanh correction)
    under the JAX draw, fed to the port as its noise; and the
    deterministic mode."""
    obs = _obs(4)
    jm = jc.SquashedGaussianActor(ACT_DIM, act_limit)
    p, actor = _carried(jm, tc.SquashedGaussianActor(OBS_DIM, ACT_DIM,
                                                     act_limit),
                        jnp.zeros((1, OBS_DIM)))
    key = jax.random.key(9)
    a_j, logp_j = jm.apply(p, obs, key)
    noise = np.asarray(jax.random.normal(key, (B, ACT_DIM)))
    a, logp = actor(torch.tensor(obs), noise=torch.tensor(noise))
    _close(a, a_j)
    _close(logp, logp_j)
    a_j, logp_j = jm.apply(p, obs, deterministic=True)
    a, logp = actor(torch.tensor(obs), deterministic=True)
    _close(a, a_j)
    _close(logp, logp_j)


def test_squashed_actor_clips_log_std_and_draws_from_generator():
    actor = tc.init_module(tc.SquashedGaussianActor(OBS_DIM, ACT_DIM),
                           torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        actor.log_std_head.bias.fill_(-50.0)
        actor.log_std_head.weight.zero_()
    obs = torch.tensor(_obs(5))
    det = actor(obs)[0]
    # std = exp(-20): the sample sits on the mean
    _close(actor(obs, torch.Generator().manual_seed(1))[0], det.detach())
    with torch.no_grad():
        actor.log_std_head.bias.fill_(0.0)
    a1 = actor(obs, torch.Generator().manual_seed(1))[0]
    a2 = actor(obs, torch.Generator().manual_seed(1))[0]
    assert torch.equal(a1, a2) and not torch.equal(a1, det)


@pytest.mark.parametrize("kind", ["q", "v"])
def test_critics_forward(kind):
    obs = _obs(6)
    act = _obs(7, d=ACT_DIM)
    if kind == "q":
        jm, tm = jc.QCritic(), tc.QCritic(OBS_DIM, ACT_DIM)
        args = (jnp.zeros((1, OBS_DIM)), jnp.zeros((1, ACT_DIM)))
        p, tm = _carried(jm, tm, *args)
        _close(tm(torch.tensor(obs), torch.tensor(act)),
               jm.apply(p, obs, act))
    else:
        jm, tm = jc.ValueCritic(), tc.ValueCritic(OBS_DIM)
        p, tm = _carried(jm, tm, jnp.zeros((1, OBS_DIM)))
        _close(tm(torch.tensor(obs)), jm.apply(p, obs))


@pytest.mark.parametrize("net", ["det", "gauss", "squashed", "q", "v"])
def test_params_from_jax_fills_every_entry(net):
    """Every entry of the port's state_dict comes across, with its shape,
    and nothing else."""
    o, a = jnp.zeros((1, OBS_DIM)), jnp.zeros((1, ACT_DIM))
    jm, tm, args = {
        "det": (jc.DeterministicActor(ACT_DIM),
                tc.DeterministicActor(OBS_DIM, ACT_DIM), (o,)),
        "gauss": (jc.GaussianActor(ACT_DIM),
                  tc.GaussianActor(OBS_DIM, ACT_DIM), (o,)),
        "squashed": (jc.SquashedGaussianActor(ACT_DIM),
                     tc.SquashedGaussianActor(OBS_DIM, ACT_DIM), (o,)),
        "q": (jc.QCritic(), tc.QCritic(OBS_DIM, ACT_DIM), (o, a)),
        "v": (jc.ValueCritic(), tc.ValueCritic(OBS_DIM), (o,))}[net]
    sd = tc.params_from_jax(jax.device_get(jm.init(jax.random.key(0),
                                                   *args)))
    want = tm.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in want)


def test_init_module_matches_flax_distribution():
    """lecun-normal kernels (std 1/sqrt(fan_in), truncated at 2 std) and
    zero biases, as flax's Dense: the first layer's spread within 10%."""
    actor = tc.init_module(tc.DeterministicActor(256, 1, hidden=(512, 64)),
                           torch.Generator().manual_seed(0), "cpu")
    w = actor.mlp.dense[0].weight.detach()
    assert abs(float(w.std()) * 256 ** 0.5 - 1.0) < 0.1
    assert float(w.abs().max()) <= 2 / 256 ** 0.5 / 0.8796 + 1e-6
    assert all(float(m.bias.detach().abs().max()) == 0
               for m in actor.mlp.dense)


def test_replay_buffer_samples_the_same_rows():
    jb, tb = jc.ReplayBuffer(2, 1, size=40), tc.ReplayBuffer(2, 1, size=40)
    rng = np.random.default_rng(0)
    for i in range(57):
        row = (rng.standard_normal(2), rng.standard_normal(1),
               float(rng.standard_normal()), rng.standard_normal(2),
               i % 5 == 0)
        jb.store(*row)
        tb.store(*row)
    assert (jb.ptr, jb.size) == (tb.ptr, tb.size) == (17, 40)
    want = jb.sample(np.random.RandomState(3), 64)
    got = tb.sample(np.random.RandomState(3), 64)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_replay_buffer_fifo():
    buf = tc.ReplayBuffer(2, 1, size=4)
    for i in range(6):
        buf.store(np.full(2, i), [i], i, np.full(2, i + 1), i % 2)
    assert buf.size == 4
    batch = buf.sample(np.random.RandomState(0), 8)
    assert batch["obs"].shape == (8, 2)
    assert set(batch["rew"]).issubset({2.0, 3.0, 4.0, 5.0})


def test_point_mass_env_same_trajectory():
    je, te = jc.PointMassEnv(seed=5), tc.PointMassEnv(seed=5)
    assert np.array_equal(je.reset(), te.reset())
    rng = np.random.default_rng(1)
    for _ in range(150):
        a = rng.uniform(-1.5, 1.5, 1)
        jo, jr, jd, _ = je.step(a)
        to, tr, td, _ = te.step(a)
        assert np.array_equal(jo, to) and jr == tr and jd == td
        if jd:
            assert np.array_equal(je.reset(), te.reset())


def test_polyak_update_matches():
    jm = jc.QCritic()
    o, a = jnp.zeros((1, OBS_DIM)), jnp.zeros((1, ACT_DIM))
    pt = jax.device_get(jm.init(jax.random.key(1), o, a))
    po = jax.device_get(jm.init(jax.random.key(2), o, a))
    targ = tc.QCritic(OBS_DIM, ACT_DIM)
    targ.load_state_dict(tc.params_from_jax(pt))
    online = tc.QCritic(OBS_DIM, ACT_DIM)
    online.load_state_dict(tc.params_from_jax(po))
    tc.polyak_update(targ, online, 0.995)
    want = tc.params_from_jax(jax.device_get(jc.polyak_update(pt, po,
                                                              0.995)))
    for k, v in targ.state_dict().items():
        _close(v, want[k].numpy())


class _FakeBox:
    def __init__(self, shape, high):
        self.shape, self.high = shape, np.full(shape, high, np.float32)


class _FakeGymEnv:
    """The gymnasium API the adapter reads: 5-tuple step, (obs, info)
    reset, Box spaces."""

    observation_space = _FakeBox((3,), np.inf)
    action_space = _FakeBox((1,), 2.0)

    def reset(self):
        return np.ones(3, np.float64), {}

    def step(self, action):
        assert action.shape == (1,)
        return np.full(3, float(action[0])), -1.5, False, True, {"x": 1}


def test_gymnasium_adapter_flat_api_without_gymnasium():
    env = tc.GymnasiumAdapter(_FakeGymEnv())
    assert (env.obs_dim, env.act_dim, env.act_limit) == (3, 1, 2.0)
    obs = env.reset()
    assert obs.dtype == np.float32 and obs.shape == (3,)
    obs2, r, done, info = env.step(np.array([0.5]))
    assert obs2.dtype == np.float32 and np.allclose(obs2, 0.5)
    assert r == -1.5 and done and info == {"x": 1, "truncated": True}
