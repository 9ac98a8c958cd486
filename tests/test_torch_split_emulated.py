"""The phase-split pair's source (``ldpc_tpu_torch/csrc/split.cu``, kernels
``split_r`` and ``split_c``) run on the CPU, against its plain PyTorch
versions.

The CUDA source is compiled with ``g++ -std=c++20`` against the stand-in
header of ``tests/test_torch_decode_emulated.py`` (a block's 256 threads as
``std::thread``s, ``__syncthreads`` a ``std::barrier``, shared memory a
static buffer, the launch a loop over the blocks, ``__CUDA_ARCH__``
undefined so the inline-PTX helpers take their C++ branch), extended with
``__ldg`` and a launch of any argument list.  The host loop of
``ops/cuda_split.py`` is run by hand: after each launch of either kernel
the whole state (channel, totals, records, sign words past the first,
latches) must equal what the launch's plain version (``split_r_reference``
or ``split_c_reference``) makes of the same state, and the count of
latched words must equal the latches'; the decode's outputs must equal
``split_reference``'s on every word, converged or not.  Tolerance: none.
The codes take both paths of each kernel: a word's totals or records
staged in shared memory (near-earth, 802.11n, the small random codes,
whose frames are no multiple of 16 bytes, and the totals of the synthetic
codes with z > 256 but at z = 2048 in f32) or read from device memory
(those codes' records, and those totals), and the check degree above
32.  This is no stand-in for the card (``tests/test_torch_gpu.py``): it
checks the kernels' indexing, layout and arithmetic, not their
compilation for sm_90a.
"""

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import (QCCode, near_earth_code, synthetic_qc_code,
                                  wifi_code)
from ldpc_tpu_torch.ops import cuda_split
from ldpc_tpu_torch.ops.cuda_split import (SplitState, split_c_reference,
                                           split_r_reference,
                                           split_reference, split_tables)
from ldpc_tpu_torch.ops.cuda_static import _RefTables
from ldpc_tpu_torch.ops.plan import DecodePlan
from test_torch_decode_emulated import _HEADER

torch.set_num_threads(1)

_SOURCE = (pathlib.Path(__file__).resolve().parent.parent /
           "ldpc_tpu_torch" / "csrc" / "split.cu")

# what split.cu uses beyond decode.cu: __ldg, and a launch with the
# kernels' own argument list
_EXTRA = r"""
template <class T> inline T __ldg(const T* p) { return *p; }
template <class Kern, class... A>
void emulate_args(Kern kernel, int blocks, const A&... a) {
  for (int b = 0; b < blocks; ++b) {
    std::memset(g_smem, 0xcd, sizeof g_smem);
    blockIdx.x = b;
    std::barrier<> bar(256);
    g_bar = &bar;
    for (auto& o : g_or) o = 0;
    std::vector<std::thread> ts;
    for (int t = 0; t < 256; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; g_gen = 0; kernel(a...); });
    for (auto& t : ts) t.join();
  }
}
"""

_EDITS = (("#include <cuda_bf16.h>", '#include "emulation.h"'),
          ("#include <cuda_runtime.h>", ""),
          ("extern __shared__ __align__(16) unsigned char smem[];",
           "unsigned char* smem = g_smem;"),
          ("kernel<<<batch, kThreads, smem, stream>>>(g, s, it);",
           "emulate_args(kernel, batch, g, s, it);"))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("split_emulated")
    src = _SOURCE.read_text()
    for cuda, cpu in _EDITS:
        assert cuda in src, f"split.cu no longer holds {cuda!r}"
        src = src.replace(cuda, cpu)
    (out / "emulation.h").write_text(_HEADER + _EXTRA)
    (out / "split.cpp").write_text(src)
    so = out / "libsplit.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-Wno-unknown-pragmas", "-o", str(so),
                    str(out / "split.cpp"), "-lpthread"], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    cuda_split.bind(lib)
    return lib


def _assert_same_state(got: SplitState, want: SplitState, where: str):
    for f in dataclasses.fields(SplitState):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert g.dtype == w.dtype and torch.equal(g, w), f"{where}: {f.name}"


def _decode(lib, code, llr, max_iters, store):
    """The host loop on the emulated kernels, each launch held to its plain
    version on the state; returns the outputs and the iteration it
    stopped at."""
    plan = DecodePlan.from_code(code)
    tables = torch.as_tensor(split_tables(plan, store))
    t = _RefTables(plan, llr.device)
    s = SplitState.start(llr, plan, max_iters, store)
    want = SplitState.start(llr, plan, max_iters, store)
    n_ok = torch.zeros(max_iters + 1, dtype=torch.int32)
    b = llr.shape[0]
    for it in range(max_iters + 1):
        assert lib.split_launch(*cuda_split.launch_args(
            "r", s, plan, tables, n_ok, it, None)) == 0
        want = split_r_reference(want, t, it)
        _assert_same_state(s, want, f"split_r, iteration {it}")
        assert int(n_ok[it]) == int(want.success.sum())
        if it == max_iters or int(n_ok[it]) == b:
            break
        assert lib.split_launch(*cuda_split.launch_args(
            "c", s, plan, tables, n_ok, it, None)) == 0
        want = split_c_reference(want, t)
        _assert_same_state(s, want, f"split_c, iteration {it}")
    ref = split_reference(llr, plan, max_iters, store)
    got = (s.errors, s.iters, s.success.bool())
    for g, w in zip(got, ref):
        assert torch.equal(g, w)
    return got, it


def _llr(n, snrs, per, seed):
    """Finite LLRs (the split pair, as the Pallas pair, does not sanitise
    non-finite ones): ``per`` words at each SNR, the all-zero codeword sent
    (-1 a bit, positive means bit 1)."""
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    return torch.from_numpy(np.concatenate(rows).astype(np.float32))


def _high_degree_code():
    """Check degree 40-50 (> 32): two sign words per check."""
    rng = np.random.default_rng(11)
    z, nb = 9, 20
    row = tuple(tuple(sorted(rng.choice(z, size=int(rng.integers(2, 4)),
                                        replace=False).tolist()))
                for _ in range(nb))
    return QCCode(z=z, shifts=(row,), name="highdeg")


def _random_code():
    """z = 13, 3 block rows of 7 blocks of 0-2 shifts (n = 91: a frame of
    182 bytes in bf16, no multiple of 16)."""
    rng = np.random.default_rng(7)
    for z, mb, nb in [(21, 2, 6), (13, 3, 7)]:
        shifts = []
        for _ in range(mb):
            row = [tuple(sorted(rng.choice(z, size=int(rng.integers(0, 3)),
                                           replace=False).tolist()))
                   for _ in range(nb)]
            if all(len(b) == 0 for b in row):
                row[0] = (int(rng.integers(z)),)
            shifts.append(tuple(row))
    return QCCode(z=z, shifts=tuple(shifts), name="rand13")


def _staged(plan, store):
    """Which kernels stage a word in shared memory (split.cu kStageBytes)."""
    width = 2 if store == "bfloat16" else 4
    return plan.n * width <= 100 * 1024, 16 * plan.m <= 100 * 1024


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_near_earth_every_launch(lib, store, max_iters):
    """Both kernels staged; clean and noisy words, so that words latch at
    different iterations while others run on."""
    code = near_earth_code()
    assert _staged(DecodePlan.from_code(code), store) == (True, True)
    llr = _llr(code.n, (2.0, 3.0, 4.5), 2, 3)
    llr[0] = -1.0
    (_, iters, ok), _ = _decode(lib, code, llr, max_iters, store)
    if max_iters == 12:
        assert ok.any() and not ok.all()
        assert len(set(iters[ok].tolist())) > 1


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("rate", ["1/2", "5/6"])
def test_802_11n_every_launch(lib, rate, store):
    code = wifi_code(1944, 1 / 2 if rate == "1/2" else 5 / 6)
    llr = _llr(code.n, (-1.0, 1.0, 2.5, 4.0), 2, 5)
    (_, _, ok), _ = _decode(lib, code, llr, 12, store)
    assert ok.any()


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_check_degree_above_32(lib, store, max_iters):
    """The kWide instances: each check's sign words past the first are read
    and written by split_r and read by split_c for slots 32.."""
    code = _high_degree_code()
    assert DecodePlan.from_code(code).dmax_cn > 32
    _decode(lib, code, _llr(code.n, (2.0, 4.0, 6.0), 3, 9), max_iters,
            store)


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_odd_frames_and_multi_shift_blocks(lib, store):
    """Frames of 182 and 364 bytes (staged value by value, not in 16-byte
    pieces), blocks of zero, one and two shifts."""
    code = _random_code()
    assert (code.n * (2 if store == "bfloat16" else 4)) % 16
    (_, _, ok), _ = _decode(lib, code, _llr(code.n, (-2.0, 0.5, 4.0), 3, 13),
                            12, store)
    assert ok.any() and not ok.all()


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
@pytest.mark.parametrize("z", [1024, 2048])
def test_large_codes_read_device_memory(lib, z, store):
    """synthetic_qc_code(z, 8, 24) with z > 256: several items a thread;
    split_c's records (128 and 256 KB a word) are read from device memory,
    and so are split_r's totals at z = 2048 in f32 (192 KB); its other
    totals (48 to 96 KB) are staged, through the launch's opt-in above 48
    KB.  Words at 0.8 dB fail, words at 4 dB converge."""
    code = synthetic_qc_code(z, 8, 24)
    plan = DecodePlan.from_code(code)
    assert _staged(plan, store) == (
        not (z == 2048 and store == "float32"), False)
    (_, _, ok), _ = _decode(lib, code, _llr(code.n, (0.8, 4.0), 2, 10), 8,
                            store)
    assert ok.any() and not ok.all()
