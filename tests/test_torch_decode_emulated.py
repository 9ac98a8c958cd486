"""The fused kernel's source (``ldpc_tpu_torch/csrc/decode.cu``) run on the
CPU, against its plain PyTorch versions.

The CUDA source is compiled with ``g++ -std=c++20`` against the header
below, which stands in for what the kernel uses of CUDA: a block's 256
threads are ``std::thread``s, ``__syncthreads`` a ``std::barrier``, shared
memory a static buffer, the launch a loop over the blocks, and
``__CUDA_ARCH__`` is undefined, so the inline-PTX helpers take their C++
branch.  The float arithmetic is the kernel's (IEEE float32, no contraction,
bf16 rounded to nearest even), so every word of the min-sum family must
equal the plain version: converged or not, at 0, 1 and 12 iterations, on
odd batches with NaN and +-inf LLRs.  The host's ``tanhf``/``logf`` and
torch's CPU kernels differ in the last bits, so sum-product is held to a
plain version whose phi is the kernel's own ``phi`` compiled here (an
entry point the header's build adds), at the plain version's contract: at
most 0.1% of words may differ.  This is no stand-in for the card
(``tests/test_torch_gpu.py``): it checks the kernel's indexing, layout and
arithmetic, not its compilation for sm_90a.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.codes import QCCode, near_earth_code, wifi_code
from ldpc_tpu_torch.ops import cuda_static
from ldpc_tpu_torch.ops.cuda_static import (KINDS, SCHEDULES, STORES,
                                            flooding_reference,
                                            layered_reference)
from ldpc_tpu_torch.ops.plan import DecodePlan

_SOURCE = (pathlib.Path(__file__).resolve().parent.parent /
           "ldpc_tpu_torch" / "csrc" / "decode.cu")

_HEADER = r"""
#pragma once
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(x)
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::abs; using std::isnan; using std::max; using std::min;
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float __uint_as_float(unsigned u) {
  float f; std::memcpy(&f, &u, 4); return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u; std::memcpy(&u, &f, 4); return u;
}
struct __nv_bfloat16 { unsigned short v; };
inline __nv_bfloat16 __float2bfloat16_rn(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {static_cast<unsigned short>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float(static_cast<unsigned>(h.v) << 16);
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int k = 0; k < 32; ++k) r |= ((x >> k) & 1u) << (31 - k);
  return r;
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
struct Dim { unsigned x; };
inline thread_local Dim threadIdx;
inline Dim blockIdx;
inline std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline std::atomic<int> g_or[4];
inline thread_local int g_gen = 0;
inline int __syncthreads_or(int x) {
  const int g = g_gen++ & 3;
  if (x) g_or[g] = 1;
  g_bar->arrive_and_wait();
  const int r = g_or[g];
  if (threadIdx.x == 0) g_or[(g + 2) & 3] = 0;
  return r;
}
inline int g_red[256];
inline int __reduce_add_sync(unsigned, int v) {
  g_red[threadIdx.x] = v;
  g_bar->arrive_and_wait();
  int s = 0;
  for (int k = 0; k < 32; ++k) s += g_red[(threadIdx.x & ~31u) + k];
  g_bar->arrive_and_wait();
  return s;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicXor(unsigned* p, unsigned v) {
  return __atomic_fetch_xor(p, v, __ATOMIC_SEQ_CST);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
typedef struct CUstream_st* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
alignas(16) inline unsigned char g_smem[232448];
template <class Kern, class A>
void emulate(Kern kernel, int blocks, const A& a) {
  for (int b = 0; b < blocks; ++b) {
    std::memset(g_smem, 0xcd, sizeof g_smem);   // not zero, as on the card
    blockIdx.x = b;
    std::barrier<> bar(256);
    g_bar = &bar;
    for (auto& o : g_or) o = 0;
    std::vector<std::thread> ts;
    for (int t = 0; t < 256; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; g_gen = 0; kernel(a); });
    for (auto& t : ts) t.join();
  }
}
"""

# the source's CUDA-only lines and what stands in for each
_EDITS = (("#include <cuda_bf16.h>", '#include "emulation.h"'),
          ("#include <cuda_runtime.h>", ""),
          ("extern __shared__ __align__(16) unsigned char smem[];",
           "unsigned char* smem = g_smem;"),
          ("kernel<<<batch, kThreads, static_cast<size_t>(smem), stream>>>(a);",
           "emulate(kernel, batch, a);"))
# the kernel's phi, callable from the tests
_PHI_ENTRY = """
extern "C" void phi_values(const float* x, float* y, int n) {
  for (int k = 0; k < n; ++k) y[k] = phi(x[k]);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("decode_emulated")
    src = _SOURCE.read_text()
    for cuda, cpu in _EDITS:
        assert cuda in src, f"decode.cu no longer holds {cuda!r}"
        src = src.replace(cuda, cpu)
    (out / "emulation.h").write_text(_HEADER)
    (out / "decode.cpp").write_text(src + _PHI_ENTRY)
    so = out / "libdecode.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-Wno-unknown-pragmas", "-o", str(so),
                    str(out / "decode.cpp"), "-lpthread"], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_launch.argtypes = [i, i, i, i, p, i, i, i, i, i, i, i, i, i,
                                  p, i, f, f, p, p, p, p]
    lib.decode_launch.restype = i
    lib.phi_values.argtypes = [p, p, i]
    return lib


def _decode(lib, code, llr, max_iters, kind, store, schedule, popcount):
    plan = DecodePlan.from_code(code)
    tables = torch.as_tensor(cuda_static.kernel_tables(plan))
    alpha = 0.75 if kind == "normalized-min-sum" else 0.0
    beta = 0.15 if kind == "offset-min-sum" else 0.0
    b = llr.shape[0]
    out = [torch.empty(b, dtype=torch.int32) for _ in range(3)]
    rc = lib.decode_launch(
        KINDS.index(kind), list(STORES).index(store),
        SCHEDULES.index(schedule), int(popcount), llr.data_ptr(), b, plan.n,
        plan.m, plan.z, plan.block_rows, plan.block_cols, plan.dmax_cn,
        plan.dmax_vn, cuda_static._n_edges(plan), tables.data_ptr(),
        max_iters, alpha, beta, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), None)
    assert rc == 0
    ref = (layered_reference if schedule == "layered"
           else flooding_reference)(llr, plan, max_iters, kind=kind,
                                    store_dtype=store, alpha=alpha,
                                    beta=beta, popcount_sign=popcount)
    return (out[0], out[1], out[2].bool()), ref


def _llr(n, snrs, per, seed):
    rng = np.random.default_rng(seed)
    rows = [-1.0 + np.sqrt(0.5 / 10 ** (s / 10)) *
            rng.standard_normal((per, n)) for s in snrs]
    llr = np.concatenate(rows).astype(np.float32)
    llr[0, :3] = [np.nan, np.inf, -np.inf]
    return torch.from_numpy(llr)


def _high_degree_code():
    """Check degree 40-50 (> 32): two sign words per check."""
    rng = np.random.default_rng(11)
    z, nb = 9, 20
    row = tuple(tuple(sorted(rng.choice(z, size=int(rng.integers(2, 4)),
                                        replace=False).tolist()))
                for _ in range(nb))
    return QCCode(z=z, shifts=(row,), name="highdeg")


def _random_code():
    """z = 13, 3 block rows of 7 blocks of 0-2 shifts: the multi-shift code
    of tests/test_torch_layered.py, drawn from the same generator."""
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


MINSUM_VARIANTS = [(k, s, sched, pc) for k in KINDS[:3] for s in STORES
                   for sched in SCHEDULES for pc in (False, True)]


@pytest.mark.parametrize("kind,store,schedule,popcount", MINSUM_VARIANTS)
def test_every_min_sum_variant_on_802_11n(lib, kind, store, schedule,
                                          popcount):
    code = wifi_code(1944, 1 / 2)
    llr = _llr(code.n, (-1.0, 0.5, 2.0), 3, 5)
    got, want = _decode(lib, code, llr, 12, kind, store, schedule, popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any()


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("store,schedule,popcount", [
    ("bfloat16", "flooding", False), ("float32", "flooding", False),
    ("int8", "flooding", False), ("bfloat16", "flooding", True),
    ("bfloat16", "layered", False), ("float32", "layered", False),
    ("int8", "layered", False), ("bfloat16", "layered", True),
    ("float32", "layered", True), ("int8", "layered", True)])
@pytest.mark.parametrize("code", ["near-earth", "highdeg"])
def test_b1_loops_on_near_earth_and_wide_checks(lib, code, store, schedule,
                                                popcount, max_iters):
    qc, snrs = ((near_earth_code(), (2.5, 3.5)) if code == "near-earth"
                else (_high_degree_code(), (2.0, 4.0)))
    llr = _llr(qc.n, snrs, 2, 9)
    got, want = _decode(lib, qc, llr, max_iters, "min-sum", store, schedule,
                        popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("kind,store,popcount", [
    ("normalized-min-sum", "bfloat16", False),
    ("normalized-min-sum", "int8", True),
    ("offset-min-sum", "float32", False),
    ("offset-min-sum", "bfloat16", True)])
@pytest.mark.parametrize("code", ["near-earth", "highdeg"])
def test_layered_kinds_on_near_earth_and_wide_checks(lib, code, kind, store,
                                                     popcount, max_iters):
    """The layered loops (z > 256 on near-earth: two checks a thread in the
    row update; one on the d_c > 32 code) with a rebuilt magnitude."""
    qc, snrs = ((near_earth_code(), (2.5, 3.5)) if code == "near-earth"
                else (_high_degree_code(), (2.0, 4.0)))
    llr = _llr(qc.n, snrs, 2, 9)
    got, want = _decode(lib, qc, llr, max_iters, kind, store, "layered",
                        popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("kind,store,popcount", [
    ("min-sum", "bfloat16", False), ("min-sum", "int8", True),
    ("normalized-min-sum", "float32", False),
    ("offset-min-sum", "bfloat16", False)])
def test_layered_loops_on_a_multi_shift_random_code(lib, kind, store,
                                                    popcount, max_iters):
    """Blocks of zero, one and two shifts, three block rows: the (block,
    variable) items of the delta loop cover blocks of one and two slots."""
    code = _random_code()
    assert max(len(b) for row in code.shifts for b in row) == 2
    llr = _llr(code.n, (0.5, 2.0, 4.0), 3, 13)
    got, want = _decode(lib, code, llr, max_iters, kind, store, "layered",
                        popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if max_iters == 12:
        assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("max_iters", [1, 12])
@pytest.mark.parametrize("store,popcount", [("bfloat16", False),
                                            ("int8", True)])
def test_layered_loops_with_more_checks_than_threads_take(lib, store,
                                                          popcount,
                                                          max_iters):
    """z = 600: (a) folds checks i0 and i0 + 300 a thread, and threads 0-43
    take a second pair (i0 + 256); (c) takes j0 + q*150 of a block, so a
    row's 4 blocks make 600 (block, j0) items for 256 threads."""
    rng = np.random.default_rng(5)
    z = 600
    shifts = tuple(tuple(tuple(sorted(rng.choice(z, size=int(k),
                                                 replace=False).tolist()))
                         for k in row)
                   for row in ((2, 1, 1, 2), (1, 2, 2, 1)))
    code = QCCode(z=z, shifts=shifts, name="z600")
    llr = _llr(code.n, (1.0, 3.0), 2, 17)
    got, want = _decode(lib, code, llr, max_iters, "min-sum", store,
                        "layered", popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _saturating_llr(n, snrs, per, seed):
    """LLRs at 24 times the BPSK scale, so that most lie beyond the int8
    store's 15.875 (Q4.3 saturates at +-127 at entry, and the totals sum
    saturated messages); NaN and +-inf in the first word."""
    llr = _llr(n, snrs, per, seed) * 24.0
    llr[0, :3] = torch.tensor([np.nan, np.inf, -np.inf])
    return llr


@pytest.mark.parametrize("max_iters", [1, 12])
@pytest.mark.parametrize("schedule,popcount", [
    ("flooding", False), ("flooding", True), ("layered", False),
    ("layered", True)])
@pytest.mark.parametrize("code", ["wifi r1/2", "highdeg"])
def test_int8_min_sum_saturates_like_the_plain_version(lib, code, schedule,
                                                      popcount, max_iters):
    """Min-sum with int8 state runs in Q4.3 integers: totals and messages
    clamped at +-127 in phase A's fold, phase B's sums and the layered
    deltas must give every word of the plain version's f32 arithmetic."""
    qc, snrs = ((wifi_code(1944, 1 / 2), (-2.0, 0.0, 2.0)) if code[0] == "w"
                else (_high_degree_code(), (2.0, 4.0)))
    llr = _saturating_llr(qc.n, snrs, 3, 23)
    finite = llr[torch.isfinite(llr)]
    assert (finite.abs() > 15.875).float().mean() > 0.5
    got, want = _decode(lib, qc, llr, max_iters, "min-sum", "int8", schedule,
                        popcount)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the layered sweep, its totals pinned at +-127, converges no word of
    # the 802.11n batch in 12 sweeps here, in the plain version as well
    if max_iters == 12 and (schedule == "flooding" or code == "highdeg"):
        assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("max_iters", [0, 1, 12])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("code", ["wifi r5/6", "highdeg"])
def test_sum_product_meets_the_plain_versions_contract(lib, monkeypatch,
                                                       code, store,
                                                       max_iters):
    """Sum-product (A1 | A2 | B1 | B2, the kept message, 2 phi an edge) on
    true LLRs (2y/sigma^2) in the waterfall: at most 0.1% of words differ
    from the plain version with the kernel's phi (none did when this test
    was written)."""
    qc, snrs = ((wifi_code(1944, 5 / 6), (2.0, 2.5, 3.0)) if code[0] == "w"
                else (_high_degree_code(), (2.0, 4.0)))
    per = 64
    sigma = np.sqrt(0.5 / 10 ** (np.asarray(snrs) / 10))
    scale = torch.from_numpy(np.repeat(2 / sigma ** 2, per)
                             .astype(np.float32))[:, None]
    llr = (_llr(qc.n, snrs, per, 21) * scale).contiguous()

    def kernel_phi(x):
        x = x.contiguous()
        y = torch.empty_like(x)
        lib.phi_values(x.data_ptr(), y.data_ptr(), x.numel())
        return y

    monkeypatch.setattr(cuda_static, "_phi", kernel_phi)
    got, want = _decode(lib, qc, llr, max_iters, "sum-product", store,
                        "flooding", False)
    differ = (got[0] != want[0]) | (got[1] != want[1]) | (got[2] != want[2])
    assert int(differ.sum()) <= 1e-3 * llr.shape[0]
    if max_iters == 12:
        assert got[2].any() and not got[2].all()
