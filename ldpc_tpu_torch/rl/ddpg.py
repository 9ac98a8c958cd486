"""DDPG (and its TD3 extension), the port of ``ldpc_tpu.rl.ddpg`` (the
vendored Spinning Up algorithms ``spinup/algos/pytorch/ddpg``,
``.../td3``; SURVEY.md §2 L4).

One module implements both: ``td3_mode=True`` enables the three TD3
additions — twin critics with min-target, target-policy smoothing noise,
delayed policy updates — over the DDPG baseline (deterministic actor,
polyak target networks, uniform replay, Gaussian exploration noise).

As in the JAX package, numpy's ``RandomState(seed)`` draws the warm-up
actions, the exploration noise and the replay indices, so from the same
initial weights DDPG takes the same steps in both packages.  TD3's
target-smoothing noise comes from a ``torch.Generator`` on ``device``
(default: the card), seeded ``seed``.  Every ``update_every`` env steps
(from ``update_after``) run ``update_every`` updates: each a Q step, and
under DDPG on every update, under TD3 on every ``policy_delay``-th, a
policy step and a Polyak step of all three targets.  ``torch.optim.Adam``
(b1 0.9, b2 0.999, eps 1e-8) takes optax's place.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.logging import EpochLogger
from . import continuous
from .continuous import (DeterministicActor, QCritic, ReplayBuffer,
                         init_module, polyak_update)
from .ppo import _adam

__all__ = ["DDPGConfig", "ddpg", "td3", "init_nets", "optimizers",
           "batch_tensors", "update", "q_step", "pi_step", "polyak_targets"]


@dataclasses.dataclass
class DDPGConfig:
    steps_per_epoch: int = 256
    epochs: int = 10
    replay_size: int = 100_000
    gamma: float = 0.99
    polyak: float = 0.995
    pi_lr: float = 1e-3
    q_lr: float = 1e-3
    batch_size: int = 64
    start_steps: int = 256      # uniform-random warmup actions
    update_after: int = 256
    update_every: int = 32
    act_noise: float = 0.1
    # TD3 extras (spinup td3 defaults)
    target_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    seed: int = 0


def init_nets(obs_dim: int, act_dim: int, act_limit: float, seed: int,
              device) -> dict:
    """{"pi", "q1", "q2"}: a new actor and two Q critics on ``device``,
    initialised in that order from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {"pi": init_module(DeterministicActor(obs_dim, act_dim,
                                                 act_limit), gen, device),
            "q1": init_module(QCritic(obs_dim, act_dim), gen, device),
            "q2": init_module(QCritic(obs_dim, act_dim), gen, device)}


def optimizers(nets: dict, cfg: DDPGConfig) -> dict:
    """{"pi": the actor's Adam, "q": one Adam over both critics}."""
    return {"pi": _adam(cfg.pi_lr)(nets["pi"].parameters()),
            "q": _adam(cfg.q_lr)([*nets["q1"].parameters(),
                                  *nets["q2"].parameters()])}


def batch_tensors(batch: dict, device) -> dict:
    """A replay sample (numpy) as float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _adam_step(opt, params, loss) -> None:
    """One optimiser step on ``loss``'s gradient with respect to
    ``params`` alone (the JAX update's ``grad`` of its own argument)."""
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def q_step(nets: dict, targ: dict, opt, batch: dict, cfg: DDPGConfig,
           td3_mode: bool, act_limit: float,
           generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """One Adam step of the critics on the Bellman error against the
    targets; returns the loss before the step.  TD3's smoothing noise is
    ``noise`` if given, else drawn from ``generator``."""
    obs2 = batch["obs2"]
    with torch.no_grad():
        a2 = targ["pi"](obs2)
        if td3_mode:
            if noise is None:
                noise = continuous.gaussian_noise(a2.shape, generator,
                                                  a2.device)
            eps = torch.clamp(cfg.target_noise * noise, -cfg.noise_clip,
                              cfg.noise_clip)
            a2 = torch.clamp(a2 + eps, -act_limit, act_limit)
        qt = targ["q1"](obs2, a2)
        if td3_mode:
            qt = torch.minimum(qt, targ["q2"](obs2, a2))
        backup = batch["rew"] + cfg.gamma * (1 - batch["done"]) * qt
    loss = torch.mean((nets["q1"](batch["obs"], batch["act"]) - backup) ** 2)
    params = list(nets["q1"].parameters())
    if td3_mode:
        loss = loss + torch.mean(
            (nets["q2"](batch["obs"], batch["act"]) - backup) ** 2)
        params += list(nets["q2"].parameters())
    _adam_step(opt, params, loss)
    return loss.detach()


def pi_step(nets: dict, opt, batch: dict) -> torch.Tensor:
    """One Adam step of the actor on -Q1(s, pi(s)); returns the loss
    before the step."""
    obs = batch["obs"]
    loss = -torch.mean(nets["q1"](obs, nets["pi"](obs)))
    _adam_step(opt, list(nets["pi"].parameters()), loss)
    return loss.detach()


def polyak_targets(targ: dict, nets: dict, rho: float) -> None:
    for k in targ:
        polyak_update(targ[k], nets[k], rho)


def update(nets: dict, targ: dict, opts: dict, batch: dict,
           cfg: DDPGConfig, *, td3_mode: bool, act_limit: float,
           policy: bool, generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None) -> dict:
    """One update from ``batch``: a Q step, then, where ``policy``, a
    policy step and a Polyak step of every target.  Returns {"LossQ"} and,
    with the policy step, "LossPi", each before its step."""
    losses = {"LossQ": q_step(nets, targ, opts["q"], batch, cfg, td3_mode,
                              act_limit, generator, noise)}
    if policy:
        losses["LossPi"] = pi_step(nets, opts["pi"], batch)
        polyak_targets(targ, nets, cfg.polyak)
    return losses


def ddpg(env_fn: Callable, cfg: DDPGConfig | None = None, *,
         td3_mode: bool = False, logger: EpochLogger | None = None,
         output_dir=None, device=None):
    """Run DDPG (or TD3 with td3_mode=True) on ``device`` (default: the
    card); returns ({"pi", "q1", "q2"} modules, logger)."""
    cfg = cfg or DDPGConfig()
    dev = resolve_device(device)
    env = env_fn()
    obs_dim, act_dim = env.obs_dim, env.act_dim
    act_limit = getattr(env, "act_limit", 1.0)
    rng_np = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    nets = init_nets(obs_dim, act_dim, act_limit, cfg.seed, dev)
    targ = {k: copy.deepcopy(v).requires_grad_(False)
            for k, v in nets.items()}
    opts = optimizers(nets, cfg)

    logger = logger or EpochLogger(output_dir=output_dir,
                                   exp_name="td3" if td3_mode else "ddpg")
    buf = ReplayBuffer(obs_dim, act_dim, cfg.replay_size)
    obs = env.reset()
    ep_ret, ep_len = 0.0, 0
    total_steps = cfg.steps_per_epoch * cfg.epochs
    start = time.time()
    updates_done = 0
    q_l = pi_l = 0.0

    for t in range(total_steps):
        if t < cfg.start_steps:
            a = rng_np.uniform(-act_limit, act_limit, act_dim)
        else:
            with torch.no_grad():
                a = nets["pi"](torch.as_tensor(obs[None], device=dev))
            a = np.clip(a.cpu().numpy()[0] + cfg.act_noise *
                        rng_np.randn(act_dim), -act_limit, act_limit)
        obs2, r, done, _ = env.step(a)
        buf.store(obs, a, r, obs2, done)
        obs = obs2
        ep_ret += r
        ep_len += 1
        if done:
            logger.store(EpRet=ep_ret, EpLen=ep_len)
            obs = env.reset()
            ep_ret, ep_len = 0.0, 0

        if t >= cfg.update_after and t % cfg.update_every == 0:
            for _ in range(cfg.update_every):
                batch = batch_tensors(buf.sample(rng_np, cfg.batch_size),
                                      dev)
                losses = update(
                    nets, targ, opts, batch, cfg, td3_mode=td3_mode,
                    act_limit=act_limit, generator=gen,
                    policy=(not td3_mode
                            or updates_done % cfg.policy_delay == 0))
                q_l = losses["LossQ"]
                pi_l = losses.get("LossPi", pi_l)
                updates_done += 1

        if (t + 1) % cfg.steps_per_epoch == 0:
            logger.log_tabular("Epoch", (t + 1) // cfg.steps_per_epoch)
            logger.log_tabular("EpRet", with_min_and_max=True)
            logger.log_tabular("EpLen", average_only=True)
            logger.log_tabular("LossQ", float(q_l))
            logger.log_tabular("LossPi", float(pi_l))
            logger.log_tabular("Time", time.time() - start)
            logger.dump_tabular()

    return nets, logger


def td3(env_fn: Callable, cfg: DDPGConfig | None = None, **kw):
    """TD3 = DDPG + twin critics + target smoothing + delayed policy
    updates (spinup/algos/pytorch/td3)."""
    return ddpg(env_fn, cfg, td3_mode=True, **kw)
