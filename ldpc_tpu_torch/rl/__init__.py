"""RL layer: the autoregressive actor-critic (``model.py``), the GAE buffer
(``buffer.py``), PPO with a vector rollout and exact resume (``ppo.py``), its
entry point (``train.py``, ``cli train``), VPG (``vpg.py``) and the
random-search baseline (``random_agent.py``), and the continuous-control
suite: DDPG/TD3 (``ddpg.py``), SAC (``sac.py``) and TRPO (``trpo.py``) over
the networks, replay buffer and point-mass env of ``continuous.py``."""

from .model import (Actor, ActorCriticConfig, Critic, MLP,
                    action_to_env_action, evaluate_actions, init_params,
                    noise_width, params_from_jax, sample_step)
from .buffer import BufferContainer, PPOBuffer, discount_cumsum
from .ppo import PPOConfig, env_generators, make_update_fns, ppo
from .random_agent import run_random_agent
from .vpg import VPGConfig, vpg
from .ddpg import DDPGConfig, ddpg, td3
from .sac import SACConfig, sac
from .trpo import TRPOConfig, trpo
from .continuous import PointMassEnv, ReplayBuffer

__all__ = [
    "Actor", "ActorCriticConfig", "Critic", "MLP", "action_to_env_action",
    "evaluate_actions", "init_params", "noise_width", "params_from_jax",
    "sample_step",
    "BufferContainer", "PPOBuffer", "discount_cumsum",
    "PPOConfig", "env_generators", "make_update_fns", "ppo",
    "run_random_agent",
    "VPGConfig", "vpg",
    "DDPGConfig", "ddpg", "td3", "SACConfig", "sac",
    "TRPOConfig", "trpo", "PointMassEnv", "ReplayBuffer",
]
