"""The JSON shift-table format of a QC code (``ldpc_tpu.qc_code.v1``).

The port reads and writes the same documents as ``ldpc_tpu.codes.io``, so a
code saved by either package loads in the other.  ``code_to_dict`` /
``code_from_dict`` are the in-memory form of the same document: the way a
code is carried across from the JAX package without going through a file.
"""

from __future__ import annotations

import json
import pathlib

from .qc import QCCode

__all__ = ["FORMAT", "code_to_dict", "code_from_dict", "save_code_json",
           "load_code_json"]

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
