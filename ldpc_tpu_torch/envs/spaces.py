"""Minimal action/observation spaces (gym-free, gym-compatible shape; copy of
``ldpc_tpu.envs.spaces``).

Equivalents of the reference's custom gym spaces: ``binarySpace``
(binarySpace.py:17-56) and ``uint8Space`` (uint8Space.py:4-43) — vectors of
{0,1} ints and of uint8 bytes with ``sample``/``contains``.  Kept
dependency-free: gym/gymnasium are not required for the RL stack (an RL
loop only needs shape/sample/contains), but the duck-typed
interface matches ``gym.spaces.Space`` so the envs plug into either.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BinarySpace", "Uint8Space"]


class _Space:
    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._rng = np.random.RandomState()

    def seed(self, seed=None):
        self._rng = np.random.RandomState(seed)
        return [seed]


class BinarySpace(_Space):
    """Vectors in {0,1}^n (binarySpace.py:17-56)."""

    def __init__(self, n: int):
        super().__init__((n,), np.int32)
        self.n = n

    def sample(self) -> np.ndarray:
        return self._rng.randint(0, 2, self.n).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and
                np.issubdtype(x.dtype, np.integer) and
                bool(np.isin(x, (0, 1)).all()))

    def __repr__(self):
        return f"BinarySpace({self.n})"


class Uint8Space(_Space):
    """Vectors in {0..255}^n (uint8Space.py:4-43)."""

    def __init__(self, n: int):
        super().__init__((n,), np.uint8)
        self.n = n

    def sample(self) -> np.ndarray:
        return self._rng.randint(0, 256, self.n).astype(np.uint8)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and x.dtype == np.uint8

    def __repr__(self):
        return f"Uint8Space({self.n})"
