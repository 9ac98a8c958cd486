"""Matrix I/O: QC parity/generator file formats, hex codecs, the JSON code
format and code archival (numpy; the port's copy of ``ldpc_tpu.codes.io``).

Reproduces the capabilities of the reference's ``fileHandler.py``:

* hex <-> binary nibble codecs (``fileHandler.py:36-123``),
* the "hot locations" QC parity text format (``fileHandler.py:144-181``,
  ``isGenerator=False`` branch): ``Mb * Nb`` lines, line ``mb * Nb + nb``
  holds the comma-separated hot first-row indices of circulant (mb, nb),
* the hex generator format (``isGenerator=True`` branch): 2 hex lines per
  block row (each 512 bits; the leading pad bit is dropped to yield a Z=511
  first row), G = [I | A],
* saving discovered codes with evaluation stats under a content-addressed
  (SHA-224) name (``fileHandler.py:183-231``) as ``.npz`` (or the
  reference's MATLAB ``.mat``; ``load_code_instance`` reads both back).

The port reads and writes the same documents and archives as the JAX
package, so a code, or the state of a search, saved by either package loads
in the other.  ``code_to_dict`` / ``code_from_dict`` are the in-memory form
of the JSON document: the way a code is carried across from the JAX package
without going through a file.  Dense matrices are never built on the decode
path (see ``qc.QCCode``).
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

from .qc import QCCode

__all__ = [
    "FORMAT",
    "hex_to_bits",
    "bits_to_hex",
    "read_qc_parity",
    "read_qc_generator_rows",
    "generator_rows_from_hex",
    "read_dense_generator",
    "code_to_dict",
    "code_from_dict",
    "load_code_json",
    "save_code_json",
    "code_hex_name",
    "save_code_instance",
    "load_code_instance",
]

_HEX = "0123456789ABCDEF"


def hex_to_bits(hex_string: str) -> np.ndarray:
    """Hex string -> binary array, 4 bits per nibble, MSB first.

    Same mapping as ``fileHandler.hexStringToBinaryArray`` (fileHandler.py:68)
    but table-driven; non-hex characters are skipped (the reference silently
    ignores them, e.g. trailing newlines).
    """
    s = [c for c in hex_string.upper() if c in _HEX]
    if not s:
        return np.zeros(0, dtype=np.int32)
    vals = np.array([_HEX.index(c) for c in s], dtype=np.int32)
    bits = (vals[:, None] >> np.array([3, 2, 1, 0])) & 1
    return bits.reshape(-1).astype(np.int32)


def bits_to_hex(bits) -> str:
    """Binary array (length % 4 == 0) -> hex string, MSB first.

    Matches ``fileHandler.binaryArraytoHex`` (fileHandler.py:54).
    """
    bits = np.asarray(bits, dtype=np.int32)
    if bits.size % 4:
        raise ValueError("bit length must be a multiple of 4")
    nibbles = bits.reshape(-1, 4) @ np.array([8, 4, 2, 1], dtype=np.int32)
    return "".join(_HEX[v] for v in nibbles)


def read_qc_parity(path, block_rows: int, block_cols: int, z: int,
                   name: str | None = None,
                   message_size: int | None = None) -> QCCode:
    """Parse the reference's hot-locations parity format into a QCCode.

    Equivalent to ``fileHandler.readMatrixFromFile(..., isGenerator=False)``
    (fileHandler.py:161-181) without densifying: line ``mb * block_cols + nb``
    lists the hot indices of circulant (mb, nb).
    """
    path = pathlib.Path(path)
    lines = [ln.strip() for ln in path.read_text().splitlines() if ln.strip()]
    if len(lines) != block_rows * block_cols:
        raise ValueError(
            f"{path}: expected {block_rows * block_cols} lines, got {len(lines)}")
    shifts = []
    for mb in range(block_rows):
        row = []
        for nb in range(block_cols):
            entries = lines[mb * block_cols + nb].split(",")
            row.append(tuple(int(e) for e in entries if e.strip() != ""))
        shifts.append(tuple(row))
    return QCCode(z=z, shifts=tuple(shifts),
                  name=name or path.stem, message_size=message_size)


def read_qc_generator_rows(path, k: int, z: int) -> np.ndarray:
    """Parse the hex generator format into circulant first rows.

    The reference format (fileHandler.py:151-160): for each of ``k // z``
    block rows, two hex lines of ``z + pad`` bits each; the leading
    ``(4 - z % 4) % 4`` pad bits are dropped (``hexToCirculant``,
    fileHandler.py:126-135, slices ``binaryArray[1:]`` for z=511).

    Returns an ``[k // z, 2, z]`` int32 array of first rows of the dense
    (non-identity) part A, where G = [I_k | A].
    """
    lines = [ln.strip() for ln in pathlib.Path(path).read_text().splitlines()
             if ln.strip()]
    return generator_rows_from_hex(lines, k, z)


def generator_rows_from_hex(lines, k: int, z: int) -> np.ndarray:
    """The ``[k // z, 2, z]`` first rows of :func:`read_qc_generator_rows`
    from its hex lines (two a block row, ``z + pad`` bits each)."""
    pad = (4 - z % 4) % 4
    kb = k // z
    if len(lines) != 2 * kb:
        raise ValueError(f"expected {2 * kb} hex lines, got {len(lines)}")
    out = np.zeros((kb, 2, z), dtype=np.int32)
    for i in range(kb):
        for j in range(2):
            bits = hex_to_bits(lines[2 * i + j])
            if bits.size != z + pad:
                raise ValueError(f"line {2*i+j}: {bits.size} bits != {z + pad}")
            out[i, j] = bits[pad:]
    return out


def read_dense_generator(path, k: int, n: int, z: int,
                         dtype=np.int8) -> np.ndarray:
    """Expand the hex generator file to the dense systematic G = [I | A].

    Matches ``fileHandler.readMatrixFromFile(..., isGenerator=True)``
    (fileHandler.py:151-160).  Note the reference builds each A block as
    ``circulant(first_row).T`` — i.e. ``A[zb*z + i, col*z + j] = 1 iff
    (j - i) % z in hot(first_row)``.
    """
    rows = read_qc_generator_rows(path, k, z)
    kb = k // z
    a = np.zeros((k, n - k), dtype=dtype)
    ii = np.arange(z)
    for bi in range(kb):
        for bj in range(2):
            for s in np.flatnonzero(rows[bi, bj]):
                a[bi * z + ii, bj * z + (ii + s) % z] = 1
    g = np.zeros((k, n), dtype=dtype)
    g[:, :k] = np.eye(k, dtype=dtype)
    g[:, k:] = a
    return g


# --- native JSON code format -------------------------------------------------

FORMAT = "ldpc_tpu.qc_code.v1"


def code_to_dict(code: QCCode) -> dict:
    """The JSON document of a code, as a dict."""
    return {
        "format": FORMAT,
        "name": code.name,
        "z": code.z,
        "block_rows": code.block_rows,
        "block_cols": code.block_cols,
        "message_size": code.message_size,
        "shifts": [[list(b) for b in row] for row in code.shifts],
    }


def code_from_dict(doc: dict) -> QCCode:
    if doc.get("format") != FORMAT:
        raise ValueError(f"not an {FORMAT} document: {doc.get('format')!r}")
    return QCCode(z=doc["z"], shifts=doc["shifts"], name=doc.get("name", ""),
                  message_size=doc.get("message_size"))


def save_code_json(code: QCCode, path) -> None:
    """Serialise a QCCode to the JSON shift-table format."""
    pathlib.Path(path).write_text(json.dumps(code_to_dict(code)))


def load_code_json(path) -> QCCode:
    try:
        return code_from_dict(json.loads(pathlib.Path(path).read_text()))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# --- code archival (discovered-code checkpoints) -----------------------------

def code_hex_name(code: QCCode) -> str:
    """Content-addressed name: hex serialisation of the circulant first rows.

    Mirrors ``fileHandler.binaryMatrixToHexString`` (fileHandler.py:183-200):
    each first row is left-padded with ``4 - z % 4`` zero bits and hexed, rows
    concatenated in (block row, block col) order.
    """
    pad = (4 - code.z % 4) % 4
    rows = code.first_rows()
    parts = []
    for mb in range(code.block_rows):
        for nb in range(code.block_cols):
            bits = np.concatenate([np.zeros(pad, np.int32), rows[mb, nb]])
            parts.append(bits_to_hex(bits))
    return "".join(parts)


def save_code_instance(code: QCCode, path, stats=None,
                       evaluation_time: float = 0.0,
                       file_name: str | None = None,
                       fmt: str = "npz") -> str:
    """Save a code (+ optional eval stats) under a SHA-224 content name.

    Equivalent of ``fileHandler.saveCodeInstance`` (fileHandler.py:203-231):
    name = ``{z}_{Mb}_{Nb}_{sha224(hex serialisation)}``.  Stored as ``.npz``
    (default) with the shift table and, when given, the scatter/aggregate
    stats produced by ``sim.stats.BerStatistics``; ``fmt="mat"``
    writes the reference's exact MATLAB schema instead — ``parityMatrix``
    (dense H), ``fileName`` (hex serialisation), ``nonZero``, and the stats
    keys ``snrData/berData/itrData/averageSnrAxis/
    averageNumberOfIterations/evaluationTime`` (fileHandler.py:216-228) —
    for drop-in consumption by the reference's tooling.
    """
    hex_name = code_hex_name(code)
    if file_name is None:
        digest = hashlib.sha224(hex_name.encode("utf-8")).hexdigest()
        file_name = f"{code.z}_{code.block_rows}_{code.block_cols}_{digest}"
    payload = {
        "first_rows": code.first_rows(),
        "z": np.int64(code.z),
        "hex_name": np.str_(hex_name),
        "evaluation_time": np.float64(evaluation_time),
    }
    stats_v2 = stats.get_stats_v2() if stats is not None else None
    if stats_v2 is not None:
        (scatter_snr, scatter_ber, scatter_itr, snr_axis, avg_snr_axis,
         ber_data, avg_iters) = stats_v2
        payload.update(
            snrData=scatter_snr, berData=scatter_ber, itrData=scatter_itr,
            snrAxis=snr_axis, averageSnrAxis=avg_snr_axis,
            berAggregate=ber_data, averageNumberOfIterations=avg_iters,
        )
    os.makedirs(path, exist_ok=True)
    if fmt == "mat":
        from scipy.io import savemat
        dense_h = code.to_dense()
        mat_payload = {
            "parityMatrix": dense_h,
            "fileName": hex_name,
            "nonZero": np.int64(int(dense_h.sum())),
            # extra (reference consumers ignore unknown keys): the QC
            # block size, so loading never has to guess z from the dense
            # matrix or the filename
            "circulantSize": np.int64(code.z),
        }
        if stats_v2 is not None:
            (scatter_snr, scatter_ber, scatter_itr, _snr_axis, avg_snr_axis,
             _ber_data, avg_iters) = stats_v2
            mat_payload.update(
                snrData=np.asarray(scatter_snr),
                berData=np.asarray(scatter_ber),
                itrData=np.asarray(scatter_itr),
                averageSnrAxis=np.asarray(avg_snr_axis),
                averageNumberOfIterations=np.asarray(avg_iters),
                evaluationTime=np.float64(evaluation_time),
            )
        full = os.path.join(str(path), file_name + ".mat")
        savemat(full, mat_payload)
    elif fmt == "npz":
        full = os.path.join(str(path), file_name + ".npz")
        np.savez(full, **payload)
    else:
        raise ValueError(f"unknown format: {fmt}")
    return file_name


def _infer_circulant_size(h: np.ndarray) -> int:
    """Largest z dividing gcd(m, n) for which every z-block is circulant.

    Drop-in interop with reference-produced .mat files whose filenames
    don't encode z (advisor r2 finding: plain gcd is wrong for real QC
    codes — near-earth gcd(1022, 8176) = 1022 vs z = 511).  z = 1 always
    succeeds (1x1 blocks), so this terminates with a valid decomposition.
    """
    g = int(np.gcd(h.shape[0], h.shape[1]))
    for z in sorted((d for d in range(1, g + 1) if g % d == 0),
                    reverse=True):
        try:
            QCCode.from_dense(h, z=z)
            return z
        except ValueError:
            continue
    return 1


def load_code_instance(path) -> tuple[QCCode, dict]:
    """Load a saved code instance (.npz or .mat); returns
    (code, dict-of-arrays)."""
    if str(path).endswith(".mat"):
        from scipy.io import loadmat
        raw = loadmat(path)
        payload = {k: np.squeeze(v) for k, v in raw.items()
                   if not k.startswith("__")}
        # Reference schema (fileHandler.py:216-228): dense 'parityMatrix' +
        # hex 'fileName'.  Recover the QC structure from the dense matrix;
        # z comes from our explicit 'circulantSize' key when present, else
        # the filename convention '{z}_{Mb}_{Nb}_{sha}', else a search
        # over divisors of gcd(m, n) (a reference-produced .mat has
        # neither hint; gcd itself is usually NOT a valid block size —
        # e.g. gcd(1022, 8176) = 1022 vs z = 511 for near-earth).
        h = np.atleast_2d(raw["parityMatrix"])
        if "circulantSize" in payload:
            z = int(payload["circulantSize"])
        else:
            stem = pathlib.Path(path).stem
            try:
                z = int(stem.split("_")[0])
            except ValueError:
                z = _infer_circulant_size(h)
        code = QCCode.from_dense(h, z=z,
                                 name=str(payload.get("fileName", ""))[:16])
        return code, payload
    with np.load(path, allow_pickle=False) as data:
        payload = {k: data[k] for k in data.files}
    code = QCCode.from_first_rows(payload["first_rows"],
                                  name=str(payload.get("hex_name", ""))[:16])
    return code, payload
