"""CCSDS 131.1-O near-earth (8176, 7154) QC-LDPC code.

A 2 x 16 grid of 511 x 511 circulants, each of weight 2.  The shift table
and the systematic generator's circulant hex rows ship with this package
(``ldpc_tpu_torch/data/ccsds_near_earth.json`` and
``ccsds_near_earth_generator.json``, the same documents as the JAX
package's; cf. the reference's ``codeMatrices/nearEarthGenerator.txt``).
The generator encodes random messages for ``codes/encode.py``.
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

from .io import generator_rows_from_hex, load_code_json
from .qc import QCCode

__all__ = ["near_earth_code", "near_earth_generator_rows",
           "near_earth_generator_dense", "Z", "BLOCK_ROWS", "BLOCK_COLS",
           "N", "K", "M"]

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


@functools.lru_cache(maxsize=1)
def near_earth_generator_rows() -> np.ndarray:
    """[14, 2, 511] circulant first rows of the dense part A of G = [I | A].

    Parsed from 128-character hex lines (512 bits; the leading pad bit is
    dropped, as ``fileHandler.hexToCirculant`` does, fileHandler.py:126-135).
    """
    doc = json.loads((_DATA / "ccsds_near_earth_generator.json").read_text())
    z = doc["z"]
    return generator_rows_from_hex(doc["hex_rows"], len(doc["hex_rows"]) // 2
                                   * z, z)


def near_earth_generator_dense(dtype=np.int8) -> np.ndarray:
    """Dense systematic generator G = [I_7154 | A], shape (7154, 8176).

    Equivalent to ``fileHandler.readMatrixFromFile(..., isGenerator=True)``
    (fileHandler.py:151-160).
    """
    rows = near_earth_generator_rows()
    kb, _, z = rows.shape
    a = np.zeros((K, N - K), dtype=dtype)
    ii = np.arange(z)
    for bi in range(kb):
        for bj in range(2):
            for s in np.flatnonzero(rows[bi, bj]):
                a[bi * z + ii, bj * z + (ii + s) % z] = 1
    g = np.zeros((K, N), dtype=dtype)
    g[:, :K] = np.eye(K, dtype=dtype)
    g[:, K:] = a
    return g
