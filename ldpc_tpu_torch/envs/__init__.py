"""Code-search environments: spaces, env, vector container.

``gym.make('gym_ldpc:ldpc-v0')`` equivalent: ``LdpcCodeSearchEnv()`` (on
the card; ``device="cpu"`` for the CPU).  A gymnasium registration is
provided when gymnasium is importable (the package itself is gym-free).
"""

from .spaces import BinarySpace, Uint8Space
from .code_search import (DEFAULT_NUM_ITERATIONS, DEFAULT_NUM_TRANSMISSIONS,
                          DEFAULT_SNR_POINTS, DEFAULT_TIME_BUDGET_S,
                          LdpcCodeSearchEnv)
from .vector import EnvironmentVector

__all__ = [
    "BinarySpace", "Uint8Space", "LdpcCodeSearchEnv", "EnvironmentVector",
    "DEFAULT_SNR_POINTS", "DEFAULT_NUM_TRANSMISSIONS",
    "DEFAULT_NUM_ITERATIONS", "DEFAULT_TIME_BUDGET_S",
    "register_gymnasium",
]


def register_gymnasium(
        env_id: str = "ldpc_tpu_torch/LdpcCodeSearch-v0") -> bool:
    """Register with gymnasium when available (gym_ldpc/__init__.py:8-14
    equivalent).  Returns True on success."""
    try:
        import gymnasium
    except ImportError:
        return False
    try:
        gymnasium.register(
            id=env_id,
            entry_point="ldpc_tpu_torch.envs.code_search:LdpcCodeSearchEnv")
    except Exception:
        return False
    return True
