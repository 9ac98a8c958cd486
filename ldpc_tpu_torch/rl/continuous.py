"""Shared machinery for the continuous-control algorithms (the port of
``ldpc_tpu.rl.continuous``; ``torch.nn`` in place of flax).

The reference vendors the whole Spinning Up suite (``spinup/algos``:
ppo/vpg/trpo/ddpg/td3/sac, SURVEY.md §2 L4) although only PPO is wired to
the LDPC env.  This module holds the building blocks of Spinning Up's
``core.py`` that trpo/ddpg/td3/sac use: MLP actors (deterministic,
Gaussian, squashed-Gaussian), Q and value critics, a uniform replay buffer
and Polyak averaging.  A tiny built-in point-mass env serves as the
integration-test environment (the vendored copy used CartPole / MuJoCo).

The port's own choices:

* **Layout.** torch needs each network's input width, so every network
  takes ``obs_dim`` (and the critics ``act_dim``) first; the rest of each
  signature is the JAX module's.  A network's MLP is ``mlp`` (flax
  ``MLP_0``, its ``dense[i]`` flax's ``Dense_i``); the squashed actor's two
  heads are ``mu_head`` and ``log_std_head`` (flax's top-level ``Dense_0``
  and ``Dense_1``).  ``params_from_jax`` carries a flax tree across.
* **Initialisation.** ``init_module`` draws as flax's ``Dense`` does
  (lecun-normal kernels, zero biases) from a ``torch.Generator`` on the
  CPU: JAX's distribution, not JAX's stream.
* **Noise.** Every Gaussian draw of the suite goes through
  ``gaussian_noise(shape, generator, device)``; an actor takes a
  ``generator`` on its device, or the ``noise`` tensor itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from . import model as _model

__all__ = ["MLP", "DeterministicActor", "GaussianActor",
           "SquashedGaussianActor", "QCritic", "ValueCritic",
           "ReplayBuffer", "polyak_update", "PointMassEnv",
           "GymnasiumAdapter", "gaussian_noise", "init_module",
           "params_from_jax"]

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)


def gaussian_noise(shape, generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` on ``device`` from
    ``generator`` (on that device)."""
    return torch.randn(tuple(shape), generator=generator, device=device)


class MLP(_model.MLP):
    """Hidden stack + linear out, ReLU by default (the JAX module's
    ``MLP(features, activation="relu")``); ``dense[i]`` is ``Dense_i``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: str = "relu"):
        super().__init__(in_features, features, activation)


class DeterministicActor(nn.Module):
    """tanh-squashed deterministic policy (DDPG/TD3)."""

    def __init__(self, obs_dim: int, act_dim: int, act_limit: float = 1.0,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.act_limit = act_limit
        self.mlp = MLP(obs_dim, [*hidden, act_dim])

    def forward(self, obs):
        return self.act_limit * torch.tanh(self.mlp(obs))


class GaussianActor(nn.Module):
    """Diagonal Gaussian policy with a state-independent log-std
    (TRPO/VPG style, spinup core.MLPGaussianActor)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.mlp = MLP(obs_dim, [*hidden, act_dim], activation="tanh")
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5))

    def forward(self, obs):
        mu = self.mlp(obs)
        return mu, self.log_std.expand(mu.shape)

    @staticmethod
    def log_prob(mu, log_std, act):
        pre = -0.5 * (((act - mu) / torch.exp(log_std)) ** 2 +
                      2 * log_std + _LOG_2PI)
        return pre.sum(-1)

    @staticmethod
    def kl(mu0, log_std0, mu1, log_std1):
        """KL(pi0 || pi1), diagonal Gaussians, summed over dims."""
        v0, v1 = torch.exp(2 * log_std0), torch.exp(2 * log_std1)
        return (log_std1 - log_std0 + (v0 + (mu0 - mu1) ** 2) / (2 * v1)
                - 0.5).sum(-1)


class SquashedGaussianActor(nn.Module):
    """tanh-squashed Gaussian with reparameterized sampling (SAC,
    spinup core.SquashedGaussianMLPActor)."""

    def __init__(self, obs_dim: int, act_dim: int, act_limit: float = 1.0,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.act_limit = act_limit
        self.mlp = MLP(obs_dim, [*hidden, hidden[-1]])
        self.mu_head = nn.Linear(hidden[-1], act_dim)
        self.log_std_head = nn.Linear(hidden[-1], act_dim)

    def forward(self, obs, generator: torch.Generator | None = None,
                deterministic: bool = False,
                noise: torch.Tensor | None = None):
        """(action, log-prob).  The pre-squash sample is ``mu`` when
        ``deterministic`` or when neither ``generator`` nor ``noise`` is
        given, else ``mu + std * noise`` (``noise`` drawn from
        ``generator`` unless given)."""
        net = torch.relu(self.mlp(obs))
        mu = self.mu_head(net)
        log_std = torch.clamp(self.log_std_head(net), LOG_STD_MIN,
                              LOG_STD_MAX)
        std = torch.exp(log_std)
        if deterministic or (generator is None and noise is None):
            pre = mu
        else:
            if noise is None:
                noise = gaussian_noise(mu.shape, generator, mu.device)
            pre = mu + std * noise
        logp = (-0.5 * (((pre - mu) / std) ** 2 + 2 * log_std + _LOG_2PI)
                ).sum(-1)
        # tanh correction (spinup sac core, numerically-stable form)
        logp = logp - (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))
                       ).sum(-1)
        return self.act_limit * torch.tanh(pre), logp


class QCritic(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.mlp = MLP(obs_dim + act_dim, [*hidden, 1])

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs, act], -1))[..., 0]


class ValueCritic(nn.Module):
    def __init__(self, obs_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.mlp = MLP(obs_dim, [*hidden, 1])

    def forward(self, obs):
        return self.mlp(obs)[..., 0]


def init_module(module: nn.Module, generator: torch.Generator,
                device) -> nn.Module:
    """``module`` initialised as flax's ``Dense`` layers are (lecun-normal
    kernels, zero biases; ``log_std`` keeps its -0.5), drawn from
    ``generator`` (on the CPU), then moved to ``device``."""
    _model._lecun_normal(module, generator)
    return module.to(device)


# the squashed actor's heads: flax's top-level names -> the port's
_HEADS = {"Dense_0": "mu_head", "Dense_1": "log_std_head"}


def params_from_jax(tree) -> dict:
    """A flax parameter tree of one of this module's networks (nested
    dicts of arrays, with or without the ``"params"`` level) -> its
    ``state_dict`` of float32 CPU tensors: ``MLP_0/Dense_i`` ->
    ``mlp.dense.i``, the squashed actor's ``Dense_0``/``Dense_1`` ->
    ``mu_head``/``log_std_head``, kernel ``[in, out]`` -> weight ``[out,
    in]``, ``log_std`` as it is."""
    tree = tree.get("params", tree)

    def dense(prefix, leaf):
        return {prefix + ".weight": torch.tensor(
                    np.asarray(leaf["kernel"], np.float32).T.copy()),
                prefix + ".bias": torch.tensor(
                    np.asarray(leaf["bias"], np.float32))}

    out = {}
    for name, sub in tree.items():
        if name == "log_std":
            out["log_std"] = torch.tensor(np.asarray(sub, np.float32))
        elif name == "MLP_0":
            for d, leaf in sub.items():
                out.update(dense(f"mlp.dense.{int(d[6:])}", leaf))
        else:
            out.update(dense(_HEADS[name], sub))
    return out


class ReplayBuffer:
    """Uniform FIFO replay buffer (spinup ddpg/core ReplayBuffer); numpy,
    the JAX package's indices from the same ``RandomState``."""

    def __init__(self, obs_dim: int, act_dim: int, size: int):
        self.obs = np.zeros((size, obs_dim), np.float32)
        self.obs2 = np.zeros((size, obs_dim), np.float32)
        self.act = np.zeros((size, act_dim), np.float32)
        self.rew = np.zeros(size, np.float32)
        self.done = np.zeros(size, np.float32)
        self.ptr, self.size, self.max_size = 0, 0, size

    def store(self, obs, act, rew, obs2, done):
        i = self.ptr
        self.obs[i], self.obs2[i] = obs, obs2
        self.act[i], self.rew[i], self.done[i] = act, rew, float(done)
        self.ptr = (self.ptr + 1) % self.max_size
        self.size = min(self.size + 1, self.max_size)

    def sample(self, rng: np.random.RandomState, batch_size: int) -> dict:
        idx = rng.randint(0, self.size, batch_size)
        return dict(obs=self.obs[idx], obs2=self.obs2[idx],
                    act=self.act[idx], rew=self.rew[idx],
                    done=self.done[idx])


def polyak_update(target: nn.Module, online: nn.Module, rho: float) -> None:
    """target <- rho * target + (1 - rho) * online, parameter by parameter,
    in place."""
    with torch.no_grad():
        tp = list(target.parameters())
        torch._foreach_mul_(tp, rho)
        torch._foreach_add_(tp, list(online.parameters()), alpha=1.0 - rho)


@dataclasses.dataclass
class PointMassEnv:
    """1-D point mass: drive position+velocity to the origin.

    obs = [pos, vel]; act in [-1, 1]; reward = -(pos^2 + 0.1 vel^2 +
    0.01 act^2); 64-step episodes.  The built-in stand-in for the gym
    classic-control envs the vendored algorithms were demoed on.
    """

    seed: int = 0
    horizon: int = 64
    obs_dim: int = 2
    act_dim: int = 1
    act_limit: float = 1.0

    def __post_init__(self):
        self.rng = np.random.RandomState(self.seed)
        self.reset()

    def reset(self):
        self.state = self.rng.uniform(-1, 1, 2).astype(np.float32)
        self.t = 0
        return self.state.copy()

    def step(self, action):
        a = float(np.clip(np.asarray(action).reshape(-1)[0], -1, 1))
        pos, vel = self.state
        vel = np.clip(0.95 * vel + 0.2 * a, -3.0, 3.0)
        pos = np.clip(pos + 0.2 * vel, -3.0, 3.0)
        self.state = np.array([pos, vel], np.float32)
        reward = -(pos ** 2 + 0.1 * vel ** 2 + 0.01 * a ** 2)
        self.t += 1
        done = self.t >= self.horizon
        return self.state.copy(), float(reward), bool(done), {}


class GymnasiumAdapter:
    """Adapt a gymnasium ``Env`` to the flat API the continuous suite
    uses (``obs_dim``/``act_dim``/``act_limit`` attributes,
    ``reset() -> obs``, ``step(a) -> (obs2, r, done, info)``).

    The vendored Spinning Up algorithms consumed classic gym 0.15 envs;
    gymnasium changed reset/step signatures (5-tuple step, (obs, info)
    reset).  This shim takes the env object and imports nothing of
    gymnasium, so ddpg/td3/sac/trpo here train on any gymnasium Box env:

        import gymnasium
        env_fn = lambda: GymnasiumAdapter(gymnasium.make("Pendulum-v1"))
        sac(env_fn, device="cpu")
    """

    def __init__(self, env):
        self.env = env
        space, aspace = env.observation_space, env.action_space
        self.obs_dim = int(np.prod(space.shape))
        self.act_dim = int(np.prod(aspace.shape))
        high = np.asarray(aspace.high).reshape(-1)
        self.act_limit = float(high[0])

    def reset(self):
        obs, _info = self.env.reset()
        return np.asarray(obs, np.float32).reshape(-1)

    def step(self, action):
        obs2, r, terminated, truncated, info = self.env.step(
            np.asarray(action).reshape(self.env.action_space.shape))
        # Spinning Up treats time-limit truncation as done for episode
        # bookkeeping; the algorithms here bootstrap only on env dones,
        # so expose `terminated` as done and flag truncation in info.
        info = dict(info)
        info["truncated"] = bool(truncated)
        done = bool(terminated or truncated)
        return (np.asarray(obs2, np.float32).reshape(-1), float(r),
                done, info)
