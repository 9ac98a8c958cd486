"""Artifact provenance: tie measured JSON artifacts to the port's sources.

The validation studies (``scripts/ber_parity.py`` and the others) run the
decoder engines on the card and write JSON artifacts.  If the decode-path
sources change after an artifact was recorded, its numbers no longer speak
for the code; a hash of those sources stamped into the artifact lets a
reader detect that.  Only the port's own files are hashed.
"""

from __future__ import annotations

import hashlib
import pathlib

__all__ = ["KERNEL_SOURCES", "kernel_source_hash"]

# The sources whose behaviour defines the decode path the artifacts
# measure, relative to the ldpc_tpu_torch package root.
KERNEL_SOURCES = (
    "csrc/decode.cu",
    "ops/cuda_static.py",
    "ops/decoder.py",
    "ops/plan.py",
    "sim/evaluate.py",
    "sim/channel.py",
)

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def kernel_source_hash(root=None) -> str:
    """SHA-256 over the decode-path sources (order-stable, hex digest) of
    the package at ``root`` (default: this one)."""
    root = _ROOT if root is None else pathlib.Path(root)
    h = hashlib.sha256()
    for rel in KERNEL_SOURCES:
        h.update(rel.encode())
        h.update((root / rel).read_bytes())
    return h.hexdigest()

