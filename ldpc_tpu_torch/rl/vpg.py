"""Vanilla Policy Gradient for LDPC code search (the port of
``ldpc_tpu.rl.vpg``).

The reference vendors the full Spinning Up algorithm suite
(``spinup/algos/pytorch/vpg``, SURVEY.md §2 L4) though only PPO is wired to
the LDPC env.  This VPG is wired: same autoregressive actor-critic, GAE
buffer and logging as ``rl/ppo.py``, with the plain policy-gradient loss
``-E[logp * adv]`` (one policy step per epoch) and multiple value steps.
The policy and value net live on ``device`` (default: the card), and the
actions are drawn from one ``torch.Generator`` there, seeded ``seed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..utils.logging import EpochLogger
from .buffer import PPOBuffer
from .model import (ActorCriticConfig, action_to_env_action,
                    evaluate_actions, init_params, sample_step)
from .ppo import (_adam, _check_env_devices, _policy_device,
                  _value_update)

__all__ = ["VPGConfig", "vpg"]


@dataclasses.dataclass
class VPGConfig:
    steps_per_epoch: int = 64
    epochs: int = 50
    gamma: float = 0.99
    pi_lr: float = 3e-4
    vf_lr: float = 1e-3
    train_v_iters: int = 80
    lam: float = 0.97
    seed: int = 30
    max_ep_len: int = 1000


def vpg(env_fn: Callable, cfg: VPGConfig | None = None,
        ac_cfg: ActorCriticConfig | None = None, *,
        logger: EpochLogger | None = None, output_dir=None, device=None):
    """Run VPG; returns (actor, critic, logger)."""
    cfg = cfg or VPGConfig()
    dev = _policy_device(device)
    env = env_fn()
    _check_env_devices([env], dev)
    obs_dim = env.observation_space.shape[0]
    if ac_cfg is None:
        ac_cfg = ActorCriticConfig(obs_dim=obs_dim,
                                   row_range=env.state.block_rows,
                                   col_range=env.state.block_cols,
                                   z=env.z)
    logger = logger or EpochLogger(output_dir=output_dir, exp_name="vpg")
    logger.save_config({"vpg": dataclasses.asdict(cfg),
                        "model": dataclasses.asdict(ac_cfg)})

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    actor, critic = init_params(ac_cfg, cfg.seed, device=dev)
    pi_opt = _adam(cfg.pi_lr)(actor.parameters())
    vf_opt = _adam(cfg.vf_lr)(critic.parameters())

    def pi_update(obs, act, adv):
        loss = -torch.mean(evaluate_actions(ac_cfg, actor, obs, act)["logp"]
                           * adv)
        pi_opt.zero_grad(set_to_none=True)
        loss.backward()
        pi_opt.step()
        return loss.detach()

    buf = PPOBuffer(obs_dim, ac_cfg.buffer_action_dim, cfg.steps_per_epoch,
                    cfg.gamma, cfg.lam,
                    num_entropy_heads=ac_cfg.num_entropy_heads)
    adim = ac_cfg.buffer_action_dim
    start = time.time()
    obs = env.reset().astype(np.float32)
    ep_ret, ep_len = 0.0, 0

    for epoch in range(cfg.epochs):
        for t in range(cfg.steps_per_epoch):
            ba, v, logp, ent = sample_step(
                ac_cfg, actor, critic,
                torch.as_tensor(obs[None], device=dev), [gen])
            # one transfer: action, value, log-prob, entropies
            packed = torch.cat([ba.to(torch.float32), v[:, None],
                                logp[:, None], ent], -1)[0].cpu().numpy()
            ba = packed[:adim].astype(np.int64)
            v, logp = float(packed[adim]), float(packed[adim + 1])
            ent = packed[adim + 2:]
            next_obs, reward, done, info = env.step(
                action_to_env_action(ac_cfg, ba))
            buf.store(obs, ba, reward, v, logp, float(ent.sum()), ent)
            logger.store(VVals=v, Reward=reward)
            obs = next_obs.astype(np.float32)
            ep_ret += reward
            ep_len += 1
            terminal = done or ep_len == cfg.max_ep_len
            if terminal or t == cfg.steps_per_epoch - 1:
                if done:
                    last_v = 0.0
                else:
                    with torch.no_grad():
                        last_v = float(critic(torch.as_tensor(
                            obs[None], device=dev))[0])
                buf.finish_path(last_v)
                if terminal:
                    logger.store(EpRet=ep_ret, EpLen=ep_len)
                    obs = env.reset().astype(np.float32)
                    ep_ret, ep_len = 0.0, 0

        data = buf.get()
        obs_b, act_b, adv_b, ret_b = (
            torch.as_tensor(data[k], device=dev)
            for k in ("obs", "act", "adv", "ret"))
        pi_l = pi_update(obs_b, act_b, adv_b)
        v_l = np.nan
        for _ in range(cfg.train_v_iters):
            v_l = _value_update(critic, vf_opt, obs_b, ret_b)
        logger.log_tabular("Epoch", epoch)
        logger.log_tabular("EpRet", with_min_and_max=True)
        logger.log_tabular("Reward", average_only=True)
        logger.log_tabular("VVals", average_only=True)
        logger.log_tabular("LossPi", float(pi_l))
        logger.log_tabular("LossV", float(v_l))
        logger.log_tabular("Time", time.time() - start)
        logger.dump_tabular()
    return actor, critic, logger
