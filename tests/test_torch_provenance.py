"""The port's artifact provenance: a hash over its own decode-path sources,
one over the split pair's and a hash of one source, each changing with what
it covers and reading nothing of the JAX package, and the split A/B's stamp
of the first two."""

import hashlib
import json
import pathlib
import shutil

import pytest

from ldpc_tpu_torch.scripts import split_ab
from ldpc_tpu_torch.utils import provenance
from ldpc_tpu_torch.utils.provenance import (KERNEL_SOURCES, SPLIT_SOURCES,
                                             kernel_source_hash,
                                             source_file_hash)

PORT = pathlib.Path(provenance.__file__).resolve().parent.parent


def _copy(tmp_path, sources=KERNEL_SOURCES):
    root = tmp_path / "pkg"
    for rel in sources:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / rel, root / rel)
    return root


def test_hash_covers_the_port_decode_path():
    assert KERNEL_SOURCES == ("csrc/decode.cu", "ops/cuda_static.py",
                              "ops/decoder.py", "ops/plan.py",
                              "sim/evaluate.py", "sim/channel.py")
    h = kernel_source_hash()
    assert len(h) == 64 and h == kernel_source_hash(PORT)


@pytest.mark.parametrize("rel", KERNEL_SOURCES)
def test_hash_changes_when_a_listed_file_changes(tmp_path, rel):
    root = _copy(tmp_path)
    before = kernel_source_hash(root)
    assert before == kernel_source_hash()
    with open(root / rel, "ab") as f:
        f.write(b"\n")
    assert kernel_source_hash(root) != before


def test_hash_reads_no_file_of_the_jax_package(monkeypatch):
    read = []
    orig = pathlib.Path.read_bytes

    def spy(self):
        read.append(self.resolve())
        return orig(self)

    monkeypatch.setattr(pathlib.Path, "read_bytes", spy)
    kernel_source_hash()
    assert len(read) == len(KERNEL_SOURCES)
    assert all(PORT in p.parents for p in read)
    assert not any("ldpc_tpu" in p.parts for p in read)


@pytest.mark.parametrize("rel", SPLIT_SOURCES)
def test_split_hash_changes_when_the_kernels_or_their_wrapper_change(
        tmp_path, rel):
    """The split A/B measures csrc/split.cu through ops/cuda_split.py's
    tables, tile and launches: a change to either moves its stamp."""
    assert SPLIT_SOURCES == ("csrc/split.cu", "ops/cuda_split.py")
    root = _copy(tmp_path, SPLIT_SOURCES)
    before = kernel_source_hash(root, SPLIT_SOURCES)
    assert before == kernel_source_hash(sources=SPLIT_SOURCES)
    assert before != kernel_source_hash()
    with open(root / rel, "ab") as f:
        f.write(b"\n")
    assert kernel_source_hash(root, SPLIT_SOURCES) != before


# the split A/B's subject, and two of the decode path's sources
SINGLE_SOURCES = ("csrc/split.cu", "ops/cuda_split.py", "csrc/decode.cu")


@pytest.mark.parametrize("rel", SINGLE_SOURCES)
def test_source_file_hash_is_the_sha256_of_the_file(tmp_path, rel):
    data = (PORT / rel).read_bytes()
    assert source_file_hash(rel) == hashlib.sha256(data).hexdigest()
    root = tmp_path / "pkg"
    (root / rel).parent.mkdir(parents=True)
    shutil.copy(PORT / rel, root / rel)
    before = source_file_hash(rel, root)
    assert before == source_file_hash(rel)
    with open(root / rel, "ab") as f:
        f.write(b"\n")
    assert source_file_hash(rel, root) != before
    assert source_file_hash(rel, root) == \
        hashlib.sha256(data + b"\n").hexdigest()


def test_source_file_hash_reads_no_file_of_the_jax_package(monkeypatch):
    read = []
    orig = pathlib.Path.read_bytes

    def spy(self):
        read.append(self.resolve())
        return orig(self)

    monkeypatch.setattr(pathlib.Path, "read_bytes", spy)
    for rel in SINGLE_SOURCES:
        source_file_hash(rel)
    assert read == [(PORT / rel).resolve() for rel in SINGLE_SOURCES]
    assert not any("ldpc_tpu" in p.parts for p in read)


def test_split_ab_summary_carries_both_hashes(monkeypatch, capsys):
    """The split A/B on the CPU, as its docstring says: the summary stamps
    the decode path's hash and the split pair's (csrc/split.cu and
    ops/cuda_split.py), those of the current sources.  128 words: the split
    decoder's tile, its least batch."""
    monkeypatch.setenv("LDPC_TPU_PLATFORM", "cpu")
    summary = split_ab.main(["--code", "wifi", "--batch", "128", "--mi", "2",
                             "--trials", "1"])
    assert summary["kernel_hash"] == kernel_source_hash()
    h = hashlib.sha256()
    for rel in ("csrc/split.cu", "ops/cuda_split.py"):
        h.update(rel.encode())
        h.update((PORT / rel).read_bytes())
    assert summary["split_kernel_hash"] == h.hexdigest()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["kernel_hash"] == summary["kernel_hash"]
    assert printed["split_kernel_hash"] == summary["split_kernel_hash"]
