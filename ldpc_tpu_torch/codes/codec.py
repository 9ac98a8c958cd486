"""Observation codec: QC code <-> bit-packed uint8 observation vector (numpy;
copy of ``ldpc_tpu.codes.codec``).

The RL environment observes a code as the first rows of its circulant grid,
bit-packed into bytes.  For the near-earth shape (2 x 16 blocks, Z = 511) this
reproduces the reference codec exactly (``ldpc_env.py:379-401``,
``common.py:349-365``): each block row's 16 first rows (16 x 511 = 8176 bits)
are padded with one zero bit after every 511 (-> 8192 bits) and packed with
``np.packbits`` into 1024 bytes; the two packed rows are concatenated into a
2048-byte observation.

The codec generalises to any (Mb, Nb, Z) while keeping the reference's
padding RULE rather than plain byte alignment: the reference pads the whole
block row (Nb * Z bits) up to the next power of two and spreads the padding
evenly, one equal zero-tail per block (near-earth: 16 * 511 = 8176 -> 8192,
i.e. one zero bit after each 511-bit first row, ldpc_env.py:379-394).  So
here a block row is padded to ``2 ** ceil(log2(Nb * Z))`` bits whenever that
is divisible by Nb (each block then carries ``padded / Nb - Z`` trailing
zeros — exactly the reference layout for the near-earth shape); when the
power of two is not divisible by Nb the even spread is impossible and the
codec falls back to byte-aligning each block's first row independently.
Either way the padded row-bit count is a multiple of 8, so ``np.packbits``
never adds bits of its own and ``compress``/``uncompress`` roundtrip for
every shape (tested against the reference's golden near-earth string).
"""

from __future__ import annotations

import numpy as np

from .qc import QCCode

__all__ = ["compress", "uncompress", "observation_bytes"]


def _padded_row_bits(block_cols: int, z: int) -> int:
    """Bits per block row after padding (near-earth: 8192 -> 512/block)."""
    total = block_cols * z
    pow2 = 1 << int(np.ceil(np.log2(total)))
    if pow2 % block_cols == 0:
        return pow2
    # fall back: byte-align each block's first row
    per_block = ((z + 7) // 8) * 8
    return per_block * block_cols


def observation_bytes(block_rows: int, block_cols: int, z: int) -> int:
    """Size in bytes of the packed observation (near-earth: 2048)."""
    return block_rows * _padded_row_bits(block_cols, z) // 8


def _mask(block_cols: int, z: int) -> np.ndarray:
    """Boolean mask of data (non-padding) bit positions within a block row.

    Matches ``LdpcEnv.compressionMask`` (ldpc_env.py:109-111): padding bits
    sit at positions ``(j + 1) * (per_block) - 1 .. `` i.e. at the tail of
    each per-block span.
    """
    padded = _padded_row_bits(block_cols, z)
    per_block = padded // block_cols
    mask = np.ones(padded, dtype=bool)
    for j in range(block_cols):
        mask[j * per_block + z: (j + 1) * per_block] = False
    return mask


def compress(code: QCCode) -> np.ndarray:
    """QCCode -> packed uint8 observation (near-earth: shape (2048,))."""
    rows = code.first_rows(dtype=np.uint8)  # [Mb, Nb, Z]
    mask = _mask(code.block_cols, code.z)
    padded = np.zeros((code.block_rows, mask.size), dtype=np.uint8)
    padded[:, mask] = rows.reshape(code.block_rows, -1)
    return np.packbits(padded, axis=1).reshape(-1)


def uncompress(observation: np.ndarray, block_rows: int, block_cols: int,
               z: int, name: str = "", message_size: int | None = None) -> QCCode:
    """Packed observation -> QCCode (inverse of :func:`compress`).

    Equivalent to the standalone ``common.uncompress`` (common.py:349-365)
    which rebuilds the full dense matrix; here we rebuild the shift table.
    """
    observation = np.asarray(observation, dtype=np.uint8)
    mask = _mask(block_cols, z)
    per_row_bytes = mask.size // 8
    if observation.size != block_rows * per_row_bytes:
        raise ValueError(
            f"observation has {observation.size} bytes, expected "
            f"{block_rows * per_row_bytes}")
    rows = np.zeros((block_rows, block_cols, z), dtype=np.int32)
    for mb in range(block_rows):
        bits = np.unpackbits(
            observation[mb * per_row_bytes:(mb + 1) * per_row_bytes])
        rows[mb] = bits[mask].reshape(block_cols, z)
    return QCCode.from_first_rows(rows, name=name, message_size=message_size)
