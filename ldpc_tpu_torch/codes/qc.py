"""Quasi-cyclic (QC) LDPC code structures (numpy; copy of ``ldpc_tpu.codes.qc``).

A QC code is a small table of circulant *shifts*; the decoders never build the
dense parity matrix.  Dense expansion exists only for tests and interchange.
This module is numpy-only and kept identical in behaviour to the JAX
package's, so a code carried across (as numpy first rows or as the JSON dict
of ``codes.io``) compares equal field by field.

Circulant convention (matches the reference exactly):
``scipy.linalg.circulant(v).T`` is used throughout the reference
(``fileHandler.py:126-142``, ``wifiMatrices.py:25``).  That matrix has
``C[i, j] = v[(j - i) mod Z]``, i.e. row ``i`` is ``v`` left-rotated... more
usefully: ``C[i, j] = 1  iff  (j - i) mod Z in shifts`` where ``shifts`` are
the hot indices of the first row ``v``.  Equivalently, check-node lane ``i``
of a block connects to variable-node lane ``(i + s) mod Z`` for each shift
``s``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "QCCode",
    "ShiftTable",
    "edges_by_block_row",
    "edges_by_block_col",
]

# A shift table is a nested tuple: shifts[mb][nb] -> tuple of shift ints
# (possibly empty for a zero block).
ShiftTable = tuple  # tuple[tuple[tuple[int, ...], ...], ...]


def _normalise_shifts(shifts) -> ShiftTable:
    return tuple(
        tuple(tuple(int(s) for s in block) for block in row) for row in shifts
    )


@dataclasses.dataclass(frozen=True)
class QCCode:
    """A quasi-cyclic LDPC code: an (Mb x Nb) grid of Z x Z circulants.

    Attributes:
      z: circulant size (511 for CCSDS near-earth, 81 for 802.11n).
      shifts: ``shifts[mb][nb]`` is the tuple of hot first-row indices of the
        circulant at block position (mb, nb); empty tuple = all-zero block.
      name: human-readable identifier.
      message_size: k of the (n, k) code, if known (near-earth: 7154).
    """

    z: int
    shifts: ShiftTable
    name: str = ""
    message_size: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "shifts", _normalise_shifts(self.shifts))
        nb = len(self.shifts[0])
        if any(len(row) != nb for row in self.shifts):
            raise ValueError("ragged shift table")
        for row in self.shifts:
            for block in row:
                for s in block:
                    if not (0 <= s < self.z):
                        raise ValueError(f"shift {s} out of range [0, {self.z})")

    # --- shape helpers -----------------------------------------------------
    @property
    def block_rows(self) -> int:
        return len(self.shifts)

    @property
    def block_cols(self) -> int:
        return len(self.shifts[0])

    @property
    def n(self) -> int:
        """Codeword length (number of variable nodes)."""
        return self.block_cols * self.z

    @property
    def m(self) -> int:
        """Number of parity checks (rows of H)."""
        return self.block_rows * self.z

    @property
    def k(self) -> int:
        """Message size; defaults to n - m when not explicitly given."""
        return self.message_size if self.message_size is not None else self.n - self.m

    @property
    def num_block_edges(self) -> int:
        return sum(len(b) for row in self.shifts for b in row)

    @property
    def num_edges(self) -> int:
        """Edges of the Tanner graph (nnz of dense H, assuming distinct shifts)."""
        return self.num_block_edges * self.z

    def row_degrees(self) -> list[int]:
        """Check-node degree of each block row (uniform inside a block row)."""
        return [sum(len(b) for b in row) for row in self.shifts]

    def col_degrees(self) -> list[int]:
        """Variable-node degree of each block column."""
        return [
            sum(len(self.shifts[mb][nb]) for mb in range(self.block_rows))
            for nb in range(self.block_cols)
        ]

    # --- dense interchange (tests / reference parity only) ------------------
    def to_dense(self, dtype=np.int32) -> np.ndarray:
        """Expand to a dense (m x n) parity matrix.

        Matches ``fileHandler.hotLocationsToCirculant`` semantics
        (``fileHandler.py:137-142``): ``circulant(first_row).T`` per block.
        """
        z = self.z
        h = np.zeros((self.m, self.n), dtype=dtype)
        ii = np.arange(z)
        for mb, row in enumerate(self.shifts):
            for nb, block in enumerate(row):
                for s in block:
                    # C[i, (i + s) % z] = 1
                    h[mb * z + ii, nb * z + (ii + s) % z] = 1
        return h

    def first_rows(self, dtype=np.int32) -> np.ndarray:
        """[Mb, Nb, Z] binary array of circulant first rows (generators)."""
        out = np.zeros((self.block_rows, self.block_cols, self.z), dtype=dtype)
        for mb, row in enumerate(self.shifts):
            for nb, block in enumerate(row):
                for s in block:
                    out[mb, nb, s] = 1
        return out

    @staticmethod
    def from_first_rows(rows: np.ndarray, name: str = "",
                        message_size: int | None = None) -> "QCCode":
        """Build from an [Mb, Nb, Z] (or [Mb, Nb*Z]) binary first-row array."""
        rows = np.asarray(rows)
        if rows.ndim == 2:
            mb, total = rows.shape
            raise ValueError("pass a 3-D [Mb, Nb, Z] array")
        mb, nb, z = rows.shape
        shifts = tuple(
            tuple(tuple(int(s) for s in np.flatnonzero(rows[i, j])) for j in range(nb))
            for i in range(mb)
        )
        return QCCode(z=z, shifts=shifts, name=name, message_size=message_size)

    @staticmethod
    def from_dense(h: np.ndarray, z: int, name: str = "",
                   message_size: int | None = None) -> "QCCode":
        """Recover the QC structure from a dense H; verifies circulant blocks."""
        h = np.asarray(h)
        m, n = h.shape
        if m % z or n % z:
            raise ValueError("dense shape not a multiple of z")
        mb_n, nb_n = m // z, n // z
        rows = np.zeros((mb_n, nb_n, z), dtype=np.int32)
        for mb in range(mb_n):
            for nb in range(nb_n):
                rows[mb, nb] = h[mb * z, nb * z:(nb + 1) * z]
        code = QCCode.from_first_rows(rows, name=name, message_size=message_size)
        if not np.array_equal(code.to_dense(dtype=h.dtype), h):
            raise ValueError("matrix is not block-circulant with the given z")
        return code

    def replace_block(self, mb: int, nb: int, first_row) -> "QCCode":
        """Functionally replace one circulant (the env's action primitive).

        Mirrors ``LdpcEnv.replaceCirculant`` (``ldpc_env.py:293-317``) but is
        pure: returns a new QCCode.  ``first_row`` is either a binary vector of
        length Z or an iterable of hot shift indices.
        """
        fr = np.asarray(first_row)
        if fr.ndim == 1 and fr.shape[0] == self.z and set(np.unique(fr)) <= {0, 1}:
            new_shifts = tuple(int(s) for s in np.flatnonzero(fr))
        else:
            new_shifts = tuple(int(s) for s in fr)
        rows = [list(r) for r in self.shifts]
        rows[mb][nb] = new_shifts
        return dataclasses.replace(self, shifts=tuple(tuple(r) for r in rows))


def edges_by_block_row(code: QCCode) -> list[list[tuple[int, int]]]:
    """Per block row: list of (block_col, shift) edges, in column-major order."""
    return [
        [(nb, s) for nb, block in enumerate(row) for s in block]
        for row in code.shifts
    ]


def edges_by_block_col(code: QCCode) -> list[list[tuple[int, int]]]:
    """Per block col: list of (block_row, shift) edges."""
    out: list[list[tuple[int, int]]] = [[] for _ in range(code.block_cols)]
    for mb, row in enumerate(code.shifts):
        for nb, block in enumerate(row):
            for s in block:
                out[nb].append((mb, s))
    return out
