"""The port's actor-critic (``ldpc_tpu_torch/rl/model.py``) against the JAX
package's flax one (``ldpc_tpu/rl/model.py``), with the flax weights
carried across by ``params_from_jax``, on the same numpy inputs.

Tolerances: ``evaluate_actions``'s log-probs and entropies agree to
``RTOL = 1e-5`` relative and ``ATOL = 1e-4`` absolute.  Both sides compute
in float32; the observations are bytes (0-255, as the env's are), so the
encoder's first layer sums 2,048 products of size up to about 10 and
rounds at about 1e-5 of a logit; a log-prob sums 18 heads of such logits
(measured: at most 1.9e-5 apart at full width).  ``mode`` and
``action_to_env_action`` are held equal.  Sampling is held to its own
``evaluate_actions`` (1e-5: the same computation) and, for the i- and
j-heads, to the heads' softmax by a chi-square test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ldpc_tpu_torch.rl import (Actor, ActorCriticConfig, Critic,
                               action_to_env_action, env_generators,
                               evaluate_actions, init_params, noise_width,
                               params_from_jax, sample_step)

jm = importlib.import_module("ldpc_tpu.rl.model")
# jitted: one compile each, not an op-by-op dispatch of the unrolled heads
jax_init = jax.jit(jm.init_params, static_argnums=(0, 1))
jax_evaluate = jax.jit(jm.evaluate_actions, static_argnums=0)
jax_step = jax.jit(jm.sample_step, static_argnums=(0, 5))

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
SMALL = dict(obs_dim=32, hidden=16, row_range=2, col_range=4, z=31,
             max_hot=3)
SIZES = {"small": SMALL, "full": {}}


@pytest.fixture(scope="module", params=list(SIZES))
def carried(request):
    """(JAX cfg, JAX params, port cfg, port actor, port critic), the port's
    weights carried across from the JAX package's."""
    kw = SIZES[request.param]
    jcfg, cfg = jm.ActorCriticConfig(**kw), ActorCriticConfig(**kw)
    ap, cp = jax.device_get(jax_init(jcfg, 3))
    asd, csd = params_from_jax(ap, cp)
    actor, critic = Actor(cfg), Critic(cfg)
    actor.load_state_dict(asd)
    critic.load_state_dict(csd)
    return jcfg, (ap, cp), cfg, actor, critic


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (b, cfg.obs_dim)).astype(np.float32)
    act = np.concatenate([rng.integers(0, cfg.row_range, (b, 1)),
                          rng.integers(0, cfg.col_range, (b, 1)),
                          rng.integers(1, cfg.max_hot + 1, (b, 1)),
                          rng.integers(0, cfg.z, (b, cfg.max_hot))], 1)
    return obs, act


def test_evaluate_actions_agrees_with_jax(carried):
    jcfg, (ap, _), cfg, actor, _ = carried
    obs, act = _batch(cfg, 8, 0)
    want = jax_evaluate(jcfg, ap, jnp.asarray(obs), jnp.asarray(act))
    got = evaluate_actions(cfg, actor, torch.tensor(obs), torch.tensor(act))
    for k in ("logp", "logp_per_head", "entropy", "entropy_per_head"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_mode_and_value_agree_with_jax(carried):
    jcfg, (ap, cp), cfg, actor, critic = carried
    obs, _ = _batch(cfg, 8, 1)
    want = jax_step(jcfg, ap, cp, jnp.asarray(obs), jax.random.key(0),
                    True)
    got = sample_step(cfg, actor, critic, torch.tensor(obs),
                      deterministic=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_sample_logp_equals_evaluate_and_ranges(carried):
    _, _, cfg, actor, critic = carried
    obs, _ = _batch(cfg, 6, 2)
    obs = torch.tensor(obs)
    ba, v, logp, ent = sample_step(cfg, actor, critic, obs,
                                   env_generators(7, 6, "cpu"))
    assert ba.shape == (6, cfg.buffer_action_dim) and v.shape == (6,)
    assert ent.shape == (6, cfg.num_entropy_heads)
    assert (ba[:, 0] < cfg.row_range).all() and (ba[:, 1] < cfg.col_range).all()
    assert ((1 <= ba[:, 2]) & (ba[:, 2] <= cfg.max_hot)).all()
    assert ((0 <= ba[:, 3:]) & (ba[:, 3:] < cfg.z)).all()
    out = evaluate_actions(cfg, actor, obs, ba)
    np.testing.assert_allclose(out["logp"].detach().numpy(), logp.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rows_draw_from_their_own_generators(carried):
    """A batch, each row with its own generator, draws what each row draws
    alone: the vector rollout's contract."""
    _, _, cfg, actor, critic = carried
    obs = torch.tensor(_batch(cfg, 4, 3)[0])
    together = sample_step(cfg, actor, critic, obs,
                           env_generators(9, 4, "cpu"))[0]
    gens = env_generators(9, 4, "cpu")
    alone = torch.cat([sample_step(cfg, actor, critic, obs[r:r + 1],
                                   [gens[r]])[0] for r in range(4)])
    assert torch.equal(together, alone)
    g = torch.Generator().manual_seed(1)
    sample_step(cfg, actor, critic, obs[:1], [g])
    # one row takes exactly noise_width uniforms of its generator
    g2 = torch.Generator().manual_seed(1)
    torch.rand(noise_width(cfg), generator=g2)
    assert torch.equal(g.get_state(), g2.get_state())
    with pytest.raises(ValueError):
        sample_step(cfg, actor, critic, obs, env_generators(9, 3, "cpu"))


def test_i_and_j_draws_follow_their_softmax():
    """4,000 draws from one observation: the i-head's counts and the
    j-head's (given each row's i) against their softmax; the chi-square
    statistic below its 1 - 1e-6 quantile (fixed seeds: deterministic)."""
    cfg = ActorCriticConfig(**SMALL)
    actor, critic = init_params(cfg, seed=4, device="cpu")
    n = 4000
    obs = torch.tensor(_batch(cfg, 1, 5)[0]).expand(n, -1).contiguous()
    ba = sample_step(cfg, actor, critic, obs, torch.Generator().manual_seed(
        8))[0]
    with torch.no_grad():
        enc = actor.encoder(obs[:1])
        p_i = torch.softmax(actor.i_head(enc), -1)[0].numpy()
        p_j = {i: torch.softmax(actor.j_head(torch.cat(
            [enc, torch.tensor([[float(i)]])], -1)), -1)[0].numpy()
            for i in range(cfg.row_range)}
    i = ba[:, 0].numpy()
    j = ba[:, 1].numpy()
    obs_i = np.bincount(i, minlength=cfg.row_range)
    chi_i = ((obs_i - n * p_i) ** 2 / (n * p_i)).sum()
    assert chi_i < stats.chi2.ppf(1 - 1e-6, cfg.row_range - 1)
    exp_j = sum(np.bincount(i, minlength=cfg.row_range)[r] * p_j[r]
                for r in range(cfg.row_range))
    obs_j = np.bincount(j, minlength=cfg.col_range)
    chi_j = ((obs_j - exp_j) ** 2 / exp_j).sum()
    assert chi_j < stats.chi2.ppf(1 - 1e-6, cfg.col_range - 1)


def test_action_to_env_action():
    cfg = ActorCriticConfig(**SMALL)
    ba = np.array([1, 2, 2, 7, 19, 3])
    env_a = action_to_env_action(cfg, ba)
    assert env_a.shape == (cfg.x_bits + cfg.y_bits + cfg.z,)
    assert env_a[:cfg.x_bits].tolist() == [1]
    assert env_a[cfg.x_bits:cfg.x_bits + cfg.y_bits].tolist() == [1, 0]
    assert set(np.flatnonzero(env_a[cfg.x_bits + cfg.y_bits:])) == {7, 19}


@pytest.mark.parametrize("size", list(SIZES))
def test_action_to_env_action_equals_jax(size):
    cfg, jcfg = ActorCriticConfig(**SIZES[size]), \
        jm.ActorCriticConfig(**SIZES[size])
    _, acts = _batch(cfg, 20, 6)
    for a in acts:
        np.testing.assert_array_equal(action_to_env_action(cfg, a),
                                      jm.action_to_env_action(jcfg, a))


def test_init_params_is_lecun_normal_with_zero_biases():
    """flax Dense's initialisation: every kernel a normal truncated at two
    standard deviations with variance 1/fan_in (so |w| sqrt(fan_in) <=
    2 / 0.8796), pooled over the full-width nets' 209,985 weights the
    variance of w sqrt(fan_in) within 2% of 1; every bias 0; the same
    draws on every call with one seed, others with another."""
    cfg = ActorCriticConfig()
    actor, critic = init_params(cfg, seed=0, device="cpu")
    scaled = []
    for net in (actor, critic):
        for layer in net.modules():
            if isinstance(layer, torch.nn.Linear):
                assert torch.count_nonzero(layer.bias) == 0
                w = layer.weight.detach() * layer.in_features ** 0.5
                assert float(w.abs().max()) <= 2 / 0.87962566103423978
                scaled.append(w.reshape(-1))
    scaled = torch.cat(scaled)
    assert abs(float(scaled.var()) - 1.0) < 0.02
    assert abs(float(scaled.mean())) < 0.01
    again = init_params(cfg, seed=0, device="cpu")[0].state_dict()
    other = init_params(cfg, seed=1, device="cpu")[0].state_dict()
    for k, v in actor.state_dict().items():
        assert torch.equal(v, again[k])
    assert not torch.equal(actor.state_dict()["encoder.dense.0.weight"],
                           other["encoder.dense.0.weight"])


def test_params_from_jax_layout():
    """Every flax leaf lands in the port's state_dict, kernels transposed."""
    jcfg = jm.ActorCriticConfig(**SMALL)
    ap, cp = jax.device_get(jax_init(jcfg, 3))
    asd, csd = params_from_jax(ap, cp)
    cfg = ActorCriticConfig(**SMALL)
    assert asd.keys() == Actor(cfg).state_dict().keys()
    assert csd.keys() == Critic(cfg).state_dict().keys()
    k = np.asarray(ap["params"]["j_head"]["Dense_0"]["kernel"])
    assert k.shape == (SMALL["hidden"] + 1, 64)
    np.testing.assert_array_equal(asd["j_head.dense.0.weight"].numpy(), k.T)
    np.testing.assert_array_equal(
        csd["mlp.dense.2.bias"].numpy(),
        np.asarray(cp["params"]["MLP_0"]["Dense_2"]["bias"]))
    # the "params" level is optional
    asd2, _ = params_from_jax(ap["params"], cp["params"])
    assert all(torch.equal(asd[k], asd2[k]) for k in asd)
