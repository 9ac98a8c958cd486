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

__all__ = ["KERNEL_SOURCES", "SPLIT_SOURCES", "kernel_source_hash",
           "source_file_hash"]

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

# The phase-split pair and its wrapper (tables, tile, launch arguments,
# sweep loop): what the split A/B measures beside the fused decode.  Kept
# out of KERNEL_SOURCES, whose hash the recorded artifacts carry.
SPLIT_SOURCES = ("csrc/split.cu", "ops/cuda_split.py")

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def kernel_source_hash(root=None, sources=KERNEL_SOURCES) -> str:
    """SHA-256 over ``sources`` (default: the decode path's; order-stable,
    hex digest) of the package at ``root`` (default: this one)."""
    root = _ROOT if root is None else pathlib.Path(root)
    h = hashlib.sha256()
    for rel in sources:
        h.update(rel.encode())
        h.update((root / rel).read_bytes())
    return h.hexdigest()


def source_file_hash(rel_path: str, root=None) -> str:
    """SHA-256 (hex digest) of ONE source of the package at ``root``
    (default: this one), ``rel_path`` relative to its root."""
    root = _ROOT if root is None else pathlib.Path(root)
    return hashlib.sha256((root / rel_path).read_bytes()).hexdigest()
