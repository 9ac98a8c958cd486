"""Count the float32 operations of the fused kernel's ``phi`` in its SASS,
on the card's toolkit.

``csrc/decode.cu``'s device function ``phi(x) = -logf(tanhf(x * 0.5f))``
is inlined wherever sum-product uses it, so this script compiles it alone:
the function's text, cut from ``decode.cu``, into a kernel
``y[k] = phi(x[k])`` beside a kernel ``y[k] = x[k]``, both with the fused
kernel's ``nvcc`` flags for ``sm_90a``, then reads both with
``cuobjdump -sass``.  ``phi``'s count is the difference of the two kernels'
counts, NOPs left out.  Its float32 operations are in the unit of the
card's float32 peak (``utils/profiling.F32_OPS_PER_S``, which counts a
fused multiply-add as 2): an FFMA counts 2, every other float32 arithmetic
instruction (add, multiply, compare, select, min/max, the special-function
unit) 1, conversions and moves 0.  Only the instructions that run for
every argument count: a predicated instruction runs for some arguments
only (with CUDA 12.9: tanhf's small-argument polynomial, a denormal
rescale, logf of an infinite argument) and is reported apart, so the count
is the least that any argument needs, as a bound wants.  ``phi`` compiles
to straight-line code; where it branches, the count raises, since it would
no longer be one path.  The bounds of the sum-product rows of
``chip_smoke.py`` count one phi as that many operations.

On the machine with the toolkit::

    python -m ldpc_tpu_torch.scripts.phi_sass

prints one JSON line: the float32 operations, those of the predicated
instructions, the instructions by opcode (``@`` marks a predicated one),
their total and ``nvcc --version``'s last line.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

from ..csrc import NVCC_FLAGS, _nvcc

_DECODE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / \
    "decode.cu"
_KERNELS = """
extern "C" __global__ void phi_only(const float* x, float* y, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) y[k] = phi(x[k]);
}
extern "C" __global__ void copy_only(const float* x, float* y, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) y[k] = x[k];
}
"""
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)(?:\.[A-Z0-9_.]+)?")
# float32 operations of an instruction, an FFMA counted as 2 as the peak
# counts it; an opcode not listed counts 0
_FLOPS = {"FFMA": 2, "FFMA32I": 2, "FADD": 1, "FADD32I": 1, "FMUL": 1,
          "FMUL32I": 1, "FMNMX": 1, "FSETP": 1, "FSET": 1, "FSEL": 1,
          "FRND": 1, "MUFU": 1}
_BRANCH = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "BSSY", "BSYNC",
           "BREAK", "WARPSYNC"}


def phi_source(path: pathlib.Path = _DECODE) -> str:
    """The text of ``phi`` in ``decode.cu``, from its signature to its
    closing brace."""
    text = path.read_text()
    start = text.index("__device__ __forceinline__ float phi(float x) {")
    end = text.index("\n}\n", start) + 3
    return text[start:end]


def sass_counts(sass: str) -> dict[str, collections.Counter]:
    """Opcodes of each function of a ``cuobjdump -sass`` listing, NOPs left
    out; a predicated instruction (``@P0``, ``@!P1``, not ``@PT``) counts
    under ``"@" + opcode``."""
    out: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.search(line)
        if m and current is not None and m.group(2) != "NOP":
            pred = m.group(1) and m.group(1).strip() != "@PT"
            current[("@" if pred else "") + m.group(2)] += 1
    return out


def flops(counts: collections.Counter) -> tuple[int, int]:
    """(float32 operations of the instructions that always run, those of the
    predicated ones) of an opcode count from ``sass_counts``."""
    always = sum(_FLOPS.get(op, 0) * c for op, c in counts.items())
    special = sum(_FLOPS.get(op[1:], 0) * c for op, c in counts.items()
                  if op.startswith("@"))
    return always, special


def _cuobjdump(nvcc: str) -> str:
    """``cuobjdump`` beside ``nvcc``, else on the PATH."""
    for cand in (str(pathlib.Path(nvcc).with_name("cuobjdump")),
                 shutil.which("cuobjdump")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found beside nvcc or on the PATH")


def _run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed:\n{out.stdout}{out.stderr}")
    return out.stdout


def count(path: pathlib.Path = _DECODE) -> dict:
    """Compile ``phi`` alone and count its instructions (see the module's
    note); raises where ``nvcc`` or ``cuobjdump`` fails."""
    nvcc = _nvcc()
    cuobjdump = _cuobjdump(nvcc)
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        src = pathlib.Path(tmp) / "phi.cu"
        src.write_text(phi_source(path) + _KERNELS)
        cubin = pathlib.Path(tmp) / "phi.cubin"
        _run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)])
        sass = _run([cuobjdump, "-sass", str(cubin)])
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    counts = sass_counts(sass)
    phi = counts["phi_only"] - counts["copy_only"]   # drops counts <= 0
    branches = sorted(op for op in phi if op.lstrip("@") in _BRANCH)
    if branches:
        raise RuntimeError(f"phi branches ({branches}): its instructions are "
                           "not one path, and the count would not be what "
                           "runs")
    total = (sum(counts["phi_only"].values()) -
             sum(counts["copy_only"].values()))
    always, special = flops(phi)
    return {"flops": always, "predicated_flops": special,
            "instructions": total, "by_opcode": dict(sorted(phi.items())),
            "kernel_instructions": {
                k: sum(v.values()) for k, v in counts.items()},
            "nvcc": version.splitlines()[-1] if version else ""}


def main(argv: list[str] | None = None) -> dict:
    res = count()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
