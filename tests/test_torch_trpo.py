"""The port's TRPO (``ldpc_tpu_torch/rl/trpo.py``) against the JAX
package's (``ldpc_tpu/rl/trpo.py``).

* The surrogate's gradient and the Fisher-vector product (the port's double
  backward pass against ``jax.jvp`` over ``jax.grad`` of the same mean KL)
  on one batch, from carried weights: within 1e-5 of the vector's norm
  (measured 7e-7 and 3e-7).
* Whole runs, 2 epochs of 64 steps on ``PointMassEnv``, the JAX run's own
  initial weights carried into the port (``init_nets`` patched) and JAX's
  action draws handed to the port in call order (as in
  ``test_torch_continuous_runs.py``).  With ``cg_iters=3`` every epoch's
  ``KL``, ``Surrogate``, ``LossV`` and returns agree within rtol 1e-4,
  ``BacktrackAccepted`` exactly, and the final parameters within 1e-5
  (measured 1.6e-6).
* With the default ``cg_iters=10`` the float32 conjugate gradient itself
  amplifies rounding: from a gradient and products that agree to 7e-7,
  the two packages' ten-iteration solutions differ by 1.4e-3 of their
  norm, and each differs from the same iteration carried in float64 (by
  3.6e-4, the port, and 1.7e-3, JAX).  So the default run is held looser:
  ``KL``, ``Surrogate``, ``LossV`` and returns within rtol 5e-2 (measured
  up to 1.5e-2, ``LossV`` of the second epoch), the parameters within
  5e-3 (measured 5.1e-4), ``BacktrackAccepted`` exactly.
"""

import importlib
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.utils.logging import EpochLogger as JaxLogger
from ldpc_tpu_torch.utils.logging import EpochLogger

jc, jt = (importlib.import_module(f"ldpc_tpu.rl.{m}")
          for m in ("continuous", "trpo"))
tc, tt = (importlib.import_module(f"ldpc_tpu_torch.rl.{m}")
          for m in ("continuous", "trpo"))

torch.set_num_threads(1)

SEED = 4
OBS0 = jnp.zeros((1, 2))


def _jax_trees(seed=SEED):
    """The JAX run's own initial weights (its key split in two)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    return jax.device_get((jc.GaussianActor(1).init(k1, OBS0),
                           jc.ValueCritic().init(k2, OBS0)))


def _port_actor(tree):
    actor = tc.GaussianActor(2, 1)
    actor.load_state_dict(tc.params_from_jax(tree))
    return actor


def _to_port_order(flat, tree, actor):
    """A JAX flat vector (leaf order) in the port's parameter order."""
    sd = tc.params_from_jax(jax.device_get(jt._unflat(jnp.asarray(flat),
                                                      tree)))
    return torch.cat([sd[n].reshape(-1) for n, _ in actor.named_parameters()])


def test_surrogate_grad_and_fisher_vector_product_match_jax():
    tree, _ = _jax_trees()
    actor_j = jc.GaussianActor(1)
    rng = np.random.default_rng(0)
    n = 64
    obs = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    act = rng.standard_normal((n, 1)).astype(np.float32)
    adv = rng.standard_normal(n).astype(np.float32)
    mu, ls = actor_j.apply(tree, obs)
    logp = np.asarray(jc.GaussianActor.log_prob(mu, ls, act))

    # the JAX module's formulas (trpo's surrogate, mean_kl and fvp)
    def surrogate(p):
        m, s = actor_j.apply(p, obs)
        return jnp.mean(jnp.exp(jc.GaussianActor.log_prob(m, s, act) -
                                logp) * adv)

    def mean_kl(p, p_old):
        m0, s0 = actor_j.apply(p_old, obs)
        m1, s1 = actor_j.apply(p, obs)
        return jnp.mean(jc.GaussianActor.kl(jax.lax.stop_gradient(m0),
                                            jax.lax.stop_gradient(s0),
                                            m1, s1))

    def fvp(v):
        _, hv = jax.jvp(lambda p_: jt._flat(jax.grad(mean_kl)(p_, tree)),
                        (tree,), (jt._unflat(v, tree),))
        return hv + 0.1 * v

    actor = _port_actor(tree)
    data = {k: torch.tensor(v) for k, v in
            dict(obs=obs, act=act, adv=adv, logp=logp).items()}
    g_want = _to_port_order(jt._flat(jax.grad(surrogate)(tree)), tree, actor)
    g = tt.surrogate_grad(actor, data)
    assert float((g - g_want).norm() / g_want.norm()) < 1e-5
    old = tt.old_policy(actor, data["obs"])
    tfvp = tt.fisher_vector_product(actor, data["obs"], old, 0.1)
    for seed in range(3):
        v = np.random.default_rng(seed).standard_normal(
            g.numel()).astype(np.float32)
        want = _to_port_order(fvp(jnp.asarray(v)), tree, actor)
        got = tfvp(_to_port_order(v, tree, actor))
        assert float((got - want).norm() / want.norm()) < 1e-5


def _rows(path):
    lines = (path / "progress.txt").read_text().splitlines()
    head = lines[0].split("\t")
    return [dict(zip(head, map(float, ln.split("\t")))) for ln in lines[1:]]


def _share_noise(monkeypatch) -> list:
    draws, taken = [], []
    normal = jax.random.normal

    def recorded(key, shape=(), dtype=jnp.float32):
        x = normal(key, shape, dtype)
        jax.debug.callback(lambda v: draws.append(np.array(v)), x,
                           ordered=True)
        return x

    def take(shape, generator, device):
        x = draws[len(taken)]
        assert x.shape == tuple(shape)
        taken.append(x)
        return torch.as_tensor(x, device=device)

    monkeypatch.setattr(jax.random, "normal", recorded)
    monkeypatch.setattr(tc, "gaussian_noise", take)
    return draws, taken


@pytest.mark.parametrize("cg_iters,rtol,param_atol",
                         [(3, 1e-4, 1e-5), (10, 5e-2, 5e-3)],
                         ids=["cg3", "cg10-default"])
def test_trpo_runs_agree(tmp_path, monkeypatch, cg_iters, rtol, param_atol):
    trees = _jax_trees()

    def init_nets(obs_dim, act_dim, seed, device):
        actor, critic = tc.GaussianActor(obs_dim, act_dim), tc.ValueCritic(
            obs_dim)
        for m, t in zip((actor, critic), trees):
            m.load_state_dict(tc.params_from_jax(t))
        return actor.to(device), critic.to(device)

    monkeypatch.setattr(tt, "init_nets", init_nets)
    draws, taken = _share_noise(monkeypatch)
    cfg = dict(steps_per_epoch=64, epochs=2, seed=SEED, cg_iters=cg_iters)
    with redirect_stdout(io.StringIO()):
        jlog = JaxLogger(output_dir=tmp_path / "jax")
        tlog = EpochLogger(output_dir=tmp_path / "port")
        jpi, jvf, _ = jt.trpo(lambda: jc.PointMassEnv(seed=SEED),
                              jt.TRPOConfig(**cfg), logger=jlog)
        tpi, tvf, _ = tt.trpo(lambda: tc.PointMassEnv(seed=SEED),
                              tt.TRPOConfig(**cfg), logger=tlog,
                              device="cpu")
    assert len(draws) == len(taken) == 128
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(want) == len(got) == 2
    for w, g in zip(want, got):
        assert set(w) == set(g)
        assert g["BacktrackAccepted"] == w["BacktrackAccepted"] == 1
        assert g["KL"] <= tt.TRPOConfig().delta
        for k in w:
            if k != "Time":
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                           err_msg=k)
    for module, tree in ((tpi, jpi), (tvf, jvf)):
        want = tc.params_from_jax(jax.device_get(tree))
        for k, v in module.state_dict().items():
            assert float((v - want[k]).abs().max()) <= param_atol, k
