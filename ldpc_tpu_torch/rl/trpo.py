"""TRPO, the port of ``ldpc_tpu.rl.trpo`` (the vendored Spinning Up TRPO,
``spinup/algos/tf1/trpo``; SURVEY.md §2 L4 — the reference only ships the
tf1 backend, per its ``DEFAULT_BACKEND``, user_config.py).

Natural-gradient policy step: the surrogate gradient is preconditioned by
the inverse Fisher matrix via conjugate gradients (``cg_iters``, damping
``damping``) on Hessian-vector products of the mean KL against a detached
copy of the old policy (a double backward pass), followed by a backtracking
line search (``backtrack_iters`` steps of x ``backtrack_coeff``) that
accepts a step when KL <= ``delta`` and the surrogate has not fallen; then
``train_v_iters`` Adam steps of the value function.  GAE advantages reuse
the PPO buffer (``PPOBuffer(..., num_entropy_heads=1)``).  The networks
live on ``device`` (default: the card); the actions are drawn from a
``torch.Generator`` there, seeded ``seed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from ..utils.device import resolve_device
from ..utils.logging import EpochLogger
from . import continuous
from .buffer import PPOBuffer
from .continuous import GaussianActor, ValueCritic, init_module
from .ppo import _adam, _value_update

__all__ = ["TRPOConfig", "trpo", "init_nets", "surrogate_grad",
           "old_policy", "fisher_vector_product", "policy_update"]


@dataclasses.dataclass
class TRPOConfig:
    steps_per_epoch: int = 256
    epochs: int = 10
    gamma: float = 0.99
    lam: float = 0.97
    delta: float = 0.01          # KL trust region
    vf_lr: float = 1e-3
    train_v_iters: int = 40
    cg_iters: int = 10
    backtrack_iters: int = 10
    backtrack_coeff: float = 0.8
    damping: float = 0.1
    seed: int = 0
    max_ep_len: int = 64


def init_nets(obs_dim: int, act_dim: int, seed: int, device):
    """(actor, critic): a new Gaussian actor and value net on ``device``,
    initialised in that order from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return (init_module(GaussianActor(obs_dim, act_dim), gen, device),
            init_module(ValueCritic(obs_dim), gen, device))


def _surrogate(actor, obs, act, adv, logp_old):
    mu, log_std = actor(obs)
    logp = GaussianActor.log_prob(mu, log_std, act)
    return torch.mean(torch.exp(logp - logp_old) * adv)


def _mean_kl(actor, old, obs):
    """Mean KL(old || actor) over ``obs``; ``old`` = (mu, log_std),
    detached."""
    mu1, ls1 = actor(obs)
    return torch.mean(GaussianActor.kl(old[0], old[1], mu1, ls1))


def _conjugate_gradient(ax, b, iters: int):
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rr = torch.dot(r, r)
    for _ in range(iters):
        a_p = ax(p)
        alpha = rr / (torch.dot(p, a_p) + 1e-8)
        x = x + alpha * p
        r = r - alpha * a_p
        rr_new = torch.dot(r, r)
        p = r + (rr_new / (rr + 1e-10)) * p
        rr = rr_new
    return x


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def surrogate_grad(actor: GaussianActor, data: dict) -> torch.Tensor:
    """The surrogate's gradient, flat in ``actor.parameters()`` order."""
    return _flat(torch.autograd.grad(
        _surrogate(actor, data["obs"], data["act"], data["adv"],
                   data["logp"]), list(actor.parameters())))


def old_policy(actor: GaussianActor, obs: torch.Tensor):
    """(mu, log_std) of ``obs`` under the current parameters, detached."""
    with torch.no_grad():
        return actor(obs)


def fisher_vector_product(actor: GaussianActor, obs: torch.Tensor, old,
                          damping: float):
    """``fvp(v) -> H v + damping v``, H the Hessian of the mean KL from
    ``old`` (``old_policy`` of the current parameters) at the current
    parameters, flat in ``actor.parameters()`` order: one double backward
    pass a product."""
    params = list(actor.parameters())
    kl_grad = _flat(torch.autograd.grad(_mean_kl(actor, old, obs), params,
                                        create_graph=True))

    def fvp(v):
        hv = torch.autograd.grad(torch.dot(kl_grad, v), params,
                                 retain_graph=True)
        return _flat(hv) + damping * v

    return fvp


def policy_update(actor: GaussianActor, data: dict,
                  cfg: TRPOConfig) -> dict:
    """The natural-gradient step with its line search, in place; ``data``
    holds the epoch's ``obs``, ``act``, ``adv``, ``logp`` tensors.  Returns
    the ``KL`` and ``Surrogate`` of the last candidate tried and
    ``BacktrackAccepted``."""
    obs, act, adv, logp_old = (data[k] for k in ("obs", "act", "adv",
                                                 "logp"))
    params = list(actor.parameters())
    old = old_policy(actor, obs)
    fvp = fisher_vector_product(actor, obs, old, cfg.damping)
    x = _conjugate_gradient(fvp, surrogate_grad(actor, data), cfg.cg_iters)
    shs = torch.dot(x, fvp(x))
    full_step = torch.sqrt(2 * cfg.delta / (shs + 1e-8)) * x
    flat = parameters_to_vector(params).detach()
    with torch.no_grad():
        old_sur = float(_surrogate(actor, obs, act, adv, logp_old))
        accepted = False
        coeff = 1.0
        for _ in range(cfg.backtrack_iters):
            vector_to_parameters(flat + coeff * full_step, params)
            kl = float(_mean_kl(actor, old, obs))
            sur = float(_surrogate(actor, obs, act, adv, logp_old))
            if kl <= cfg.delta and sur >= old_sur:
                accepted = True
                break
            coeff *= cfg.backtrack_coeff
        if not accepted:
            vector_to_parameters(flat, params)
    return {"KL": kl, "Surrogate": sur, "BacktrackAccepted": int(accepted)}


def trpo(env_fn: Callable, cfg: TRPOConfig | None = None, *,
         logger: EpochLogger | None = None, output_dir=None, device=None):
    """Run TRPO on ``device`` (default: the card); returns (actor, critic,
    logger)."""
    cfg = cfg or TRPOConfig()
    dev = resolve_device(device)
    env = env_fn()
    obs_dim, act_dim = env.obs_dim, env.act_dim
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    actor, critic = init_nets(obs_dim, act_dim, cfg.seed, dev)
    vf_opt = _adam(cfg.vf_lr)(critic.parameters())

    logger = logger or EpochLogger(output_dir=output_dir, exp_name="trpo")
    buf = PPOBuffer(obs_dim, act_dim, cfg.steps_per_epoch, cfg.gamma,
                    cfg.lam, num_entropy_heads=1)
    obs = env.reset()
    ep_ret, ep_len = 0.0, 0
    start = time.time()

    def value(o):
        return float(critic(torch.as_tensor(o[None], device=dev))[0])

    for epoch in range(cfg.epochs):
        for t in range(cfg.steps_per_epoch):
            with torch.no_grad():
                o = torch.as_tensor(obs[None], device=dev)
                mu, log_std = actor(o)
                a = mu + torch.exp(log_std) * continuous.gaussian_noise(
                    mu.shape, gen, dev)
                logp = GaussianActor.log_prob(mu, log_std, a)
                # one read of the action, its log-prob and the value
                a, logp, v = np.split(torch.cat([a[0], logp, critic(o)])
                                      .cpu().numpy(), [act_dim, act_dim + 1])
            obs2, r, done, _ = env.step(a)
            buf.store(obs, a, r, float(v[0]), float(logp[0]), 0.0,
                      np.zeros(1))
            obs = obs2
            ep_ret += r
            ep_len += 1
            terminal = done or ep_len >= cfg.max_ep_len
            if terminal or t == cfg.steps_per_epoch - 1:
                with torch.no_grad():
                    last_v = 0.0 if done else value(obs)
                buf.finish_path(last_v)
                if terminal:
                    logger.store(EpRet=ep_ret, EpLen=ep_len)
                    obs = env.reset()
                    ep_ret, ep_len = 0.0, 0

        data = buf.get()
        data = {k: torch.as_tensor(data[k], device=dev)
                for k in ("obs", "act", "adv", "ret", "logp")}
        stats = policy_update(actor, data, cfg)
        for _ in range(cfg.train_v_iters):
            v_l = _value_update(critic, vf_opt, data["obs"], data["ret"])

        logger.log_tabular("Epoch", epoch)
        logger.log_tabular("EpRet", with_min_and_max=True)
        for k, v in stats.items():
            logger.log_tabular(k, v)
        logger.log_tabular("LossV", float(v_l))
        logger.log_tabular("Time", time.time() - start)
        logger.dump_tabular()

    return actor, critic, logger
