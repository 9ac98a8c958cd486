"""RL layer: so far the random-search baseline (``rl/random_agent.py``); the
actor-critic, buffers and PPO wait in ROADMAP.md Queue A item 6."""

from .random_agent import run_random_agent

__all__ = ["run_random_agent"]
