"""CCSDS 131.1-O near-earth (8176, 7154) QC-LDPC code.

A 2 x 16 grid of 511 x 511 circulants, each of weight 2.  The shift table
ships with this package (``ldpc_tpu_torch/data/ccsds_near_earth.json``, the
same document as the JAX package's).  The generator is not carried over: the
Monte-Carlo sweep sends the all-zero codeword.
"""

from __future__ import annotations

import functools
import pathlib

from .io import load_code_json
from .qc import QCCode

__all__ = ["near_earth_code", "Z", "BLOCK_ROWS", "BLOCK_COLS", "N", "K", "M"]

_DATA = pathlib.Path(__file__).resolve().parent.parent / "data"

Z = 511
BLOCK_ROWS = 2
BLOCK_COLS = 16
N = BLOCK_COLS * Z      # 8176
M = BLOCK_ROWS * Z      # 1022
K = 7154                # CCSDS message size (n - m = 7154)


@functools.lru_cache(maxsize=1)
def near_earth_code() -> QCCode:
    """The (8176, 7154) near-earth parity-check code as a QCCode."""
    return load_code_json(_DATA / "ccsds_near_earth.json")
