"""Soft Actor-Critic, the port of ``ldpc_tpu.rl.sac`` (the vendored
Spinning Up SAC, ``spinup/algos/pytorch/sac``; SURVEY.md §2 L4).

Squashed-Gaussian actor with reparameterized sampling, twin Q critics with
min-target, entropy-regularized backup, polyak target critics, uniform
replay.  Temperature ``alpha`` is fixed by default (as in the vendored
copy) or tuned automatically (``auto_alpha=True``): ``log_alpha`` is a
learned parameter minimizing ``-log_alpha * (logp + target_entropy)`` by its
own Adam, driving the policy entropy toward ``target_entropy`` (default
``-act_dim``, the SAC-v2 heuristic) — a capability the reference lacks.

numpy's ``RandomState(seed)`` draws the warm-up actions and the replay
indices, as in the JAX package; the actor's noise comes from a
``torch.Generator`` on ``device`` (default: the card), seeded ``seed``:
one draw an acting step, and separate draws for the Q step and the policy
step of an update.
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
from .continuous import (QCritic, ReplayBuffer, SquashedGaussianActor,
                         init_module)
from .ddpg import _adam_step, batch_tensors, polyak_targets
from .ppo import _adam

__all__ = ["SACConfig", "sac", "init_nets", "optimizers", "update",
           "q_step", "pi_step", "alpha_step"]


@dataclasses.dataclass
class SACConfig:
    steps_per_epoch: int = 256
    epochs: int = 10
    replay_size: int = 100_000
    gamma: float = 0.99
    polyak: float = 0.995
    lr: float = 1e-3
    alpha: float = 0.2
    batch_size: int = 64
    start_steps: int = 256
    update_after: int = 256
    update_every: int = 32
    seed: int = 0
    auto_alpha: bool = False
    target_entropy: float | None = None   # default: -act_dim


def init_nets(obs_dim: int, act_dim: int, act_limit: float, seed: int,
              device) -> dict:
    """{"pi", "q1", "q2"}: a new squashed-Gaussian actor and two Q critics
    on ``device``, initialised in that order from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return {"pi": init_module(SquashedGaussianActor(obs_dim, act_dim,
                                                    act_limit), gen, device),
            "q1": init_module(QCritic(obs_dim, act_dim), gen, device),
            "q2": init_module(QCritic(obs_dim, act_dim), gen, device)}


def optimizers(nets: dict, log_alpha: torch.Tensor, cfg: SACConfig) -> dict:
    """{"pi": the actor's Adam, "q": one Adam over both critics, "alpha":
    ``log_alpha``'s Adam}."""
    return {"pi": _adam(cfg.lr)(nets["pi"].parameters()),
            "q": _adam(cfg.lr)([*nets["q1"].parameters(),
                                *nets["q2"].parameters()]),
            "alpha": _adam(cfg.lr)([log_alpha])}


def q_step(nets: dict, targ: dict, opt, batch: dict, alpha, gamma: float,
           generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """One Adam step of both critics on the soft Bellman error (the next
    action from the current actor, ``noise`` or a draw from
    ``generator``); returns the loss before the step."""
    obs2 = batch["obs2"]
    with torch.no_grad():
        a2, logp2 = nets["pi"](obs2, generator, noise=noise)
        qt = torch.minimum(targ["q1"](obs2, a2), targ["q2"](obs2, a2))
        backup = batch["rew"] + gamma * (1 - batch["done"]) * (
            qt - alpha * logp2)
    obs, act = batch["obs"], batch["act"]
    loss = (torch.mean((nets["q1"](obs, act) - backup) ** 2) +
            torch.mean((nets["q2"](obs, act) - backup) ** 2))
    _adam_step(opt, [*nets["q1"].parameters(), *nets["q2"].parameters()],
               loss)
    return loss.detach()


def pi_step(nets: dict, opt, batch: dict, alpha,
            generator: torch.Generator | None = None,
            noise: torch.Tensor | None = None):
    """One Adam step of the actor on E[alpha logp - min Q]; returns (the
    loss, the mean log-prob), both before the step."""
    obs = batch["obs"]
    a, logp = nets["pi"](obs, generator, noise=noise)
    q = torch.minimum(nets["q1"](obs, a), nets["q2"](obs, a))
    loss = torch.mean(alpha * logp - q)
    _adam_step(opt, list(nets["pi"].parameters()), loss)
    return loss.detach(), torch.mean(logp).detach()


def alpha_step(log_alpha: torch.Tensor, opt, mean_logp,
               target_entropy: float) -> None:
    """One Adam step of ``log_alpha`` on -log_alpha (logp + H_target)."""
    _adam_step(opt, [log_alpha],
               -log_alpha * (mean_logp + target_entropy))


def update(nets: dict, targ: dict, opts: dict, log_alpha: torch.Tensor,
           batch: dict, cfg: SACConfig, act_dim: int,
           generator: torch.Generator | None = None,
           noise: tuple = (None, None)) -> dict:
    """One update from ``batch`` at the temperature ``exp(log_alpha)``: a Q
    step (its noise ``noise[0]`` or a draw from ``generator``), a policy
    step (``noise[1]`` or the next draw), with ``cfg.auto_alpha`` a step of
    ``log_alpha`` toward ``cfg.target_entropy`` (by default ``-act_dim``),
    and a Polyak step of the target critics.  Returns
    {"LossQ", "LossPi", "Entropy"}, each before its step."""
    alpha = torch.exp(log_alpha.detach())
    loss_q = q_step(nets, targ, opts["q"], batch, alpha, cfg.gamma,
                    generator, noise[0])
    loss_pi, mean_logp = pi_step(nets, opts["pi"], batch, alpha, generator,
                                 noise[1])
    if cfg.auto_alpha:
        alpha_step(log_alpha, opts["alpha"], mean_logp,
                   cfg.target_entropy if cfg.target_entropy is not None
                   else -float(act_dim))
    polyak_targets(targ, nets, cfg.polyak)
    return {"LossQ": loss_q, "LossPi": loss_pi, "Entropy": -mean_logp}


def sac(env_fn: Callable, cfg: SACConfig | None = None, *,
        logger: EpochLogger | None = None, output_dir=None, device=None):
    """Run SAC on ``device`` (default: the card); returns ({"pi", "q1",
    "q2", "log_alpha"}, logger, act_det) with ``act_det(actor, obs)`` the
    deterministic action (a CPU tensor) of ``obs`` [B, obs_dim]."""
    cfg = cfg or SACConfig()
    dev = resolve_device(device)
    env = env_fn()
    obs_dim, act_dim = env.obs_dim, env.act_dim
    act_limit = getattr(env, "act_limit", 1.0)
    rng_np = np.random.RandomState(cfg.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    nets = init_nets(obs_dim, act_dim, act_limit, cfg.seed, dev)
    targ = {k: copy.deepcopy(nets[k]).requires_grad_(False)
            for k in ("q1", "q2")}
    log_alpha = torch.tensor(np.log(cfg.alpha), dtype=torch.float32,
                             device=dev, requires_grad=True)
    opts = optimizers(nets, log_alpha, cfg)

    logger = logger or EpochLogger(output_dir=output_dir, exp_name="sac")
    buf = ReplayBuffer(obs_dim, act_dim, cfg.replay_size)
    obs = env.reset()
    ep_ret, ep_len = 0.0, 0
    start = time.time()
    q_l = pi_l = ent = 0.0

    for t in range(cfg.steps_per_epoch * cfg.epochs):
        if t < cfg.start_steps:
            a = rng_np.uniform(-act_limit, act_limit, act_dim)
        else:
            with torch.no_grad():
                a = nets["pi"](torch.as_tensor(obs[None], device=dev),
                               gen)[0]
            a = a.cpu().numpy()[0]
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
                losses = update(nets, targ, opts, log_alpha, batch, cfg,
                                act_dim, gen)
                q_l, pi_l, ent = (losses[k] for k in ("LossQ", "LossPi",
                                                      "Entropy"))

        if (t + 1) % cfg.steps_per_epoch == 0:
            logger.log_tabular("Epoch", (t + 1) // cfg.steps_per_epoch)
            logger.log_tabular("EpRet", with_min_and_max=True)
            logger.log_tabular("LossQ", float(q_l))
            logger.log_tabular("LossPi", float(pi_l))
            logger.log_tabular("Entropy", float(ent))
            logger.log_tabular("Alpha", float(torch.exp(log_alpha.detach())))
            logger.log_tabular("Time", time.time() - start)
            logger.dump_tabular()

    params = {**nets, "log_alpha": log_alpha.detach()}
    return params, logger, act_det


def act_det(actor: SquashedGaussianActor, obs) -> torch.Tensor:
    """The squashed actor's deterministic action of ``obs`` [B, obs_dim]
    (numpy or tensor), on the CPU."""
    dev = next(actor.parameters()).device
    with torch.no_grad():
        a = actor(torch.as_tensor(obs, dtype=torch.float32, device=dev),
                  deterministic=True)[0]
    return a.cpu()
