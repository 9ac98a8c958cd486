"""The port's artifact provenance: a hash over its own decode-path sources
that changes with any of them and reads nothing of the JAX package."""

import pathlib
import shutil

import pytest

from ldpc_tpu_torch.utils import provenance
from ldpc_tpu_torch.utils.provenance import KERNEL_SOURCES, kernel_source_hash

PORT = pathlib.Path(provenance.__file__).resolve().parent.parent


def _copy(tmp_path):
    root = tmp_path / "pkg"
    for rel in KERNEL_SOURCES:
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
