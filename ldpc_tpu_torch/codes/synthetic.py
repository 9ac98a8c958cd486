"""Synthetic QC-LDPC codes for scale studies (numpy; copy of
``ldpc_tpu.codes.synthetic``).

Protograph-style random QC codes of any size: every block column gets
``col_weight`` distinct block rows (the classic (wc, wr)-regular
construction), each selected block one uniform shift, so the dense H has
column weight exactly ``col_weight`` and row weight
``block_cols * col_weight / block_rows`` on average.  At large circulant
sizes one word's check state outgrows a thread block's shared memory, so
these codes decode through the phase-split pair (``ops/cuda_split.py``).

Girth is whatever the draw gives (no 4-cycle elimination pass): fine for
decoder scaling and throughput studies, not a code-design tool.
"""

from __future__ import annotations

import numpy as np

from .qc import QCCode

__all__ = ["synthetic_qc_code"]


def synthetic_qc_code(z: int, block_rows: int, block_cols: int, *,
                      col_weight: int = 3, seed: int = 0,
                      name: str | None = None) -> QCCode:
    """A random (col_weight)-regular QC-LDPC code of shape
    (block_rows*z, block_cols*z); the same shifts and name as the JAX
    package's for the same arguments.

    ``col_weight`` must not exceed ``block_rows``.  Block-row loads are
    balanced (each block column takes the ``col_weight`` least-loaded rows,
    ties broken by the seeded draw), so no check row is empty.
    """
    if col_weight > block_rows:
        raise ValueError(f"col_weight {col_weight} > block_rows "
                         f"{block_rows}")
    rng = np.random.default_rng(seed)
    shifts = [[() for _ in range(block_cols)] for _ in range(block_rows)]
    load = np.zeros(block_rows, np.int64)
    for c in range(block_cols):
        order = np.lexsort((rng.random(block_rows), load))
        rows = order[:col_weight]
        load[rows] += 1
        for r in rows:
            shifts[int(r)][c] = (int(rng.integers(z)),)
    return QCCode(z=z, shifts=tuple(tuple(r) for r in shifts),
                  name=name or f"synthetic_z{z}_{block_rows}x{block_cols}"
                               f"_wc{col_weight}_s{seed}")
