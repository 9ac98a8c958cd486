"""Random-search baseline agent (reference ``randomAgent.py:35-131``; the
port of ``ldpc_tpu.rl.random_agent``).

Uniform random actions: block row, block col, number of hot bits drawn from
a small range, then that many distinct coordinates (the reference samples
``numberOfHotBits`` from ``choice`` and coordinates without replacement).
Each step verifies the observation codec roundtrip like the reference does
(randomAgent.py checks compress/uncompress every step) and logs rewards.
"""

from __future__ import annotations

import numpy as np

from ..envs.code_search import LdpcCodeSearchEnv
from ..utils.logging import TsvLogger

__all__ = ["run_random_agent"]


def run_random_agent(env: LdpcCodeSearchEnv | None = None,
                     num_steps: int = 10,
                     seed: int = 42,
                     hot_bits_range=tuple(range(3, 8)),
                     verify_codec: bool = True,
                     log_path=None):
    """Run the baseline; returns (rewards list, env).  Without ``env`` it
    builds the default one, on the card."""
    env = env if env is not None else LdpcCodeSearchEnv()
    rng = np.random.RandomState(seed)
    tsv = TsvLogger(["step", "reward", "x", "y", "hot_bits", "done"],
                    path=log_path, print_rows=False)
    rewards = []
    obs = env.reset()
    for t in range(num_steps):
        x = rng.randint(0, env.state.block_rows)
        y = rng.randint(0, env.state.block_cols)
        k = int(rng.choice(hot_bits_range))
        coords = rng.choice(env.z, k, replace=False)
        first_row = np.zeros(env.z, np.int32)
        first_row[coords] = 1
        xb = [int(b) for b in np.binary_repr(x, env.x_bits)]
        yb = [int(b) for b in np.binary_repr(y, env.y_bits)]
        action = np.concatenate([xb, yb, first_row]).astype(np.int32)
        obs, reward, done, info = env.step(action)
        rewards.append(reward)
        tsv.log(step=t, reward=reward, x=x, y=y, hot_bits=k, done=done)
        if verify_codec:
            roundtrip = env.uncompress(obs)
            assert roundtrip.shifts == env.state.shifts, (
                "observation codec roundtrip failed")
        if done:
            obs = env.reset()
    return rewards, env
