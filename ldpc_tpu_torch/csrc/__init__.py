"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``.

Each ``<name>.cu`` in this directory is compiled at first use for
``sm_90a`` into ``ldpc_tpu_torch/_build/lib<name>-<hash>.so``, where the
hash covers the source and the flags: an unchanged source is never rebuilt,
an edited one always is.  ``-Xptxas -v`` reports (registers, shared memory,
spills) are kept beside the library as ``.log``.  Nothing here runs when the
package is imported, so the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "load", "build_report"]

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIBS: dict[str, ctypes.CDLL] = {}
_REPORTS: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = _DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, pathlib.Path]:
    """Compile the named sources that are not built yet, all at once (one
    ``nvcc`` process per source, started together); returns their paths."""
    todo, out = [], {}
    for name in names:
        src, so = _target(name)
        out[name] = so
        if so.exists():
            _REPORTS.setdefault(name, {
                "seconds": 0.0, "cached": True,
                "ptxas": so.with_suffix(".log").read_text()
                if so.with_suffix(".log").exists() else ""})
        else:
            todo.append((name, src, so))
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += "\nnvcc timed out after 600 s"
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, so)       # atomic: a concurrent build never sees half
        so.with_suffix(".log").write_text(log)
        _REPORTS[name] = {"seconds": time.perf_counter() - t0,
                          "cached": False, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of ``<name>.cu`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)[name]))
    return lib


def build_report(name: str) -> dict:
    """Seconds the build took, whether it was cached, and nvcc's output."""
    return dict(_REPORTS[name])
