// The kernel microbenchmark's probes: a body run K times on a tile held in
// shared memory, written back in place after each run, then the float32 sum
// of buffer 0.  One kernel template over the seven bodies of
// scripts/kernel_microbench.py (main(), the closures p_base ... p_recon):
//   0 abs_add_baseline           |x| + 0.1
//   1 baseline+static_roll       that, then roll(., 117, axis 0), 512 rows
//   2 baseline+static_roll_1024  the same at 1024 rows
//   3 baseline+mod511_rot        that, gathered from row (i + 117) mod 511
//                                (row 511 reads row 117, as the Pallas body's
//                                two rolls and select give)
//   4 baseline+f32_to_bf16       a bf16 buffer: bf16(|f32(x)| + 0.1), half
//                                to even
//   5 twomin_edge_no_rot         3 buffers t, m1, m2: the phase-A fold of one
//                                edge
//   6 recon_no_rot               3 buffers m1, m2, am: the phase-B rebuild
//
// Replaces the Pallas TPU kernel scripts/kernel_microbench.py::_build_probe
// (`kernel`, pl.pallas_call at :63): there a [n_bufs, rows, 128] tile sits in
// VMEM and a fori_loop runs the body K times.  Here the input is
// x[G, n_bufs, rows, 128]: G = 1 is the Pallas function, and G > 1 runs the
// same function on G tiles at once, so that the card's 132 SMs are busy and
// a slope reads the per-op cost at full occupancy.  Each launch also returns
// the final buffers: a permutation leaves the sum as it was, so only the
// buffers show a wrong rotation.  K is a runtime argument, so both K values
// of a slope run one compiled binary.
//
// Layout.  Columns are independent in every body and the rotations run along
// the rows, so a block owns one 16-column strip of one tile, all its buffers
// and rows, in shared memory ([buffer][row][16]: a warp touches two rows of
// 16 columns, 32 consecutive words, one per bank).  8 blocks a tile of 256
// threads; a thread owns the elements threadIdx.x + k * 256.  Shared bytes a
// block: n_bufs * rows * 16 * sizeof(element) (f32: 32 KB at 512 rows, 64 KB
// at 1024 rows, 96 KB for the three-buffer bodies).  A rotating body reads
// the rotated row into registers, waits at a barrier, then writes; every
// body ends a run with a barrier, as the fused kernel's phases do.  The
// rotations index the row as csrc/decode.cu indexes the circulant
// (j = i + s; if (j >= z) j -= z), not with %.
//
// Rounding.  Every rounding point of the Pallas bodies is kept: __fadd_rn /
// __fsub_rn / __fmul_rn (never contracted into an FMA), the bf16 store by
// __float2bfloat16_rn; do not build with --use_fast_math.  The sum of
// buffer 0 runs in another order than the TPU's (per thread, then a warp
// tree, then the warps in order, then the strips in order), so it agrees
// with other sums only to a tolerance; the buffers agree exactly.
//
// What bounds it on an H100.  HBM traffic is the tile in and out once; the
// work is K runs of the body on every element: 2 float32 operations (abs,
// add) for bodies 0-4, 10 for the fold and 7 for the rebuild.  Each run
// also reads every buffer and writes every changed one in shared memory
// (8 bytes an element for bodies 0-3, 4 for bf16, 24 for the fold, 16 for
// the rebuild, whose unchanged m2 and am stores the compiler drops), and at
// 128 bytes a clock an SM that traffic, not the HBM or the arithmetic, is
// the ceiling: at the card-filling G the probes reach 93-97% of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;     // columns of a tile (the TPU's lanes)
constexpr int kStrip = 16;      // columns a block holds
constexpr int kStrips = kLanes / kStrip;
constexpr int kThreads = 256;
constexpr int kShift = 117;     // the probes' rotation
constexpr int kZ = 511;         // the near-earth circulant size
constexpr float kStep = 0.1f;
constexpr int kMaxTiles = 65535;  // grid.y

enum Body : int {
  kBase = 0,
  kRoll = 1,
  kRoll1024 = 2,
  kMod511 = 3,
  kBf16 = 4,
  kTwoMin = 5,
  kRecon = 6
};

template <int B>
struct Shape {
  using T = float;
  static constexpr int kBufs = 1;
  static constexpr int kRows = 512;
};
template <>
struct Shape<kRoll1024> {
  using T = float;
  static constexpr int kBufs = 1;
  static constexpr int kRows = 1024;
};
template <>
struct Shape<kBf16> {
  using T = __nv_bfloat16;
  static constexpr int kBufs = 1;
  static constexpr int kRows = 512;
};
template <>
struct Shape<kTwoMin> {
  using T = float;
  static constexpr int kBufs = 3;
  static constexpr int kRows = 512;
};
template <>
struct Shape<kRecon> {
  using T = float;
  static constexpr int kBufs = 3;
  static constexpr int kRows = 512;
};

template <int B>
constexpr bool kRotates = B == kRoll || B == kRoll1024 || B == kMod511;

__device__ __forceinline__ float ld(float x) { return x; }
__device__ __forceinline__ float ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T st(float x);
template <>
__device__ __forceinline__ float st<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float abs_add(float x) {
  return __fadd_rn(fabsf(x), kStep);
}

// The row that output row i reads.  roll(x, 117)[i] = x[(i - 117) mod rows];
// the mod-511 gather reads x[(i + 117) mod 511] for i < 511 and, with the
// same two lines, x[117] for the pad row 511.
template <int B>
__device__ __forceinline__ int source_row(int i) {
  constexpr int kRows = Shape<B>::kRows;
  constexpr int z = B == kMod511 ? kZ : kRows;
  constexpr int s = B == kMod511 ? kShift : kRows - kShift;
  int j = i + s;
  if (j >= z) j -= z;
  return j;
}

// One run of a body that does not rotate, on element e of every buffer.
template <int B, typename T>
__device__ __forceinline__ void run_in_place(T* s, int e) {
  constexpr int kPlane = Shape<B>::kRows * kStrip;
  if constexpr (B == kTwoMin) {
    const float t = ld(s[e]);
    const float m1 = ld(s[kPlane + e]);
    const float m2 = ld(s[2 * kPlane + e]);
    const float v = __fsub_rn(t, __fmul_rn(m1, 0.5f));
    const float a = fabsf(v);
    const float m2n = a < m1 ? m1 : fminf(m2, a);
    const float m1n = fminf(m1, a);
    s[e] = st<T>(v < 0.f ? -t : t);
    s[kPlane + e] = st<T>(m1n);
    s[2 * kPlane + e] = st<T>(m2n);
  } else if constexpr (B == kRecon) {
    const float m1 = ld(s[e]);
    const float m2 = ld(s[kPlane + e]);
    const float am = ld(s[2 * kPlane + e]);
    const float sgn = m1 > 1.f ? -1.f : 1.f;
    const float mag = am == 3.f ? m2 : m1;
    s[e] = st<T>(abs_add(__fmul_rn(sgn, mag)));
    s[kPlane + e] = st<T>(m2);
    s[2 * kPlane + e] = st<T>(am);
  } else {
    s[e] = st<T>(abs_add(ld(s[e])));
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    probe(const typename Shape<B>::T* __restrict__ x,
          typename Shape<B>::T* __restrict__ out,
          float* __restrict__ partial, int n_iters) {
  using T = typename Shape<B>::T;
  constexpr int kBufs = Shape<B>::kBufs;
  constexpr int kRows = Shape<B>::kRows;
  constexpr int kPlane = kRows * kStrip;   // one buffer's strip
  constexpr int kPer = kPlane / kThreads;  // elements a thread, a buffer
  static_assert(kPlane % kThreads == 0, "a strip must split evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_sums[kThreads / 32];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int strip = blockIdx.x;
  const size_t tile = static_cast<size_t>(blockIdx.y) * kBufs * kRows *
                      kLanes;
  const int col0 = strip * kStrip;

  for (int e = threadIdx.x; e < kBufs * kPlane; e += kThreads) {
    const int b = e / kPlane;
    const int r = (e - b * kPlane) / kStrip;
    const int c = e % kStrip;
    s[e] = x[tile + (static_cast<size_t>(b) * kRows + r) * kLanes + col0 + c];
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    if constexpr (kRotates<B>) {
      float o[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = threadIdx.x + k * kThreads;
        const int i = e / kStrip;
        o[k] = abs_add(ld(s[source_row<B>(i) * kStrip + (e % kStrip)]));
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        s[threadIdx.x + k * kThreads] = st<T>(o[k]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < kPer; ++k) {
        run_in_place<B>(s, threadIdx.x + k * kThreads);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < kBufs * kPlane; e += kThreads) {
    const int b = e / kPlane;
    const int r = (e - b * kPlane) / kStrip;
    const int c = e % kStrip;
    out[tile + (static_cast<size_t>(b) * kRows + r) * kLanes + col0 + c] =
        s[e];
  }

  // float32 sum of buffer 0's strip: a thread's elements in order, a warp
  // tree, the warps in order
  float acc = 0.f;
  for (int k = 0; k < kPer; ++k) {
    acc = __fadd_rn(acc, ld(s[threadIdx.x + k * kThreads]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, warp_sums[w]);
    partial[blockIdx.y * kStrips + strip] = t;
  }
}

// sums[g] = the strips' partial sums of tile g, in strip order
__global__ void tile_sums(const float* __restrict__ partial,
                          float* __restrict__ sums, int tiles) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= tiles) return;
  float t = 0.f;
  for (int k = 0; k < kStrips; ++k) t = __fadd_rn(t, partial[g * kStrips + k]);
  sums[g] = t;
}

template <int B>
constexpr int smem_bytes() {
  return Shape<B>::kBufs * Shape<B>::kRows * kStrip *
         static_cast<int>(sizeof(typename Shape<B>::T));
}

template <int B>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(probe<B>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<B>());
}

template <int B>
int launch(const void* x, void* out, float* partial, float* sums, int tiles,
           int n_iters, cudaStream_t stream) {
  using T = typename Shape<B>::T;
  cudaError_t err = allow_smem<B>();
  if (err != cudaSuccess) return static_cast<int>(err);
  probe<B><<<dim3(kStrips, tiles), kThreads, smem_bytes<B>(), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), partial, n_iters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_sums<<<(tiles + 127) / 128, 128, 0, stream>>>(partial, sums, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int occupancy(int* blocks_per_sm) {
  cudaError_t err = allow_smem<B>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, probe<B>, kThreads, smem_bytes<B>()));
}

}  // namespace

extern "C" {

// Launch probe `body` (0-6, the order above) on x[tiles, n_bufs, rows, 128]
// (float32, or bf16 for body 4), K = n_iters runs, on `stream`: the final
// buffers into out (same shape), the per-strip sums of buffer 0 into
// partial[tiles * 8] and the tile sums into sums[tiles].  Returns
// cudaGetLastError() of the launches (0 when both were accepted).  All
// pointers are device pointers; nothing is allocated here.
int microbench_launch(int body, const void* x, void* out, float* partial,
                      float* sums, int tiles, int n_iters, void* stream) {
  if (tiles <= 0 || tiles > kMaxTiles || n_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kBase:
      return launch<kBase>(x, out, partial, sums, tiles, n_iters, s);
    case kRoll:
      return launch<kRoll>(x, out, partial, sums, tiles, n_iters, s);
    case kRoll1024:
      return launch<kRoll1024>(x, out, partial, sums, tiles, n_iters, s);
    case kMod511:
      return launch<kMod511>(x, out, partial, sums, tiles, n_iters, s);
    case kBf16:
      return launch<kBf16>(x, out, partial, sums, tiles, n_iters, s);
    case kTwoMin:
      return launch<kTwoMin>(x, out, partial, sums, tiles, n_iters, s);
    case kRecon:
      return launch<kRecon>(x, out, partial, sums, tiles, n_iters, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of probe `body` that one SM holds at once; returns the CUDA error.
int microbench_occupancy(int body, int* blocks_per_sm) {
  switch (body) {
    case kBase:
      return occupancy<kBase>(blocks_per_sm);
    case kRoll:
      return occupancy<kRoll>(blocks_per_sm);
    case kRoll1024:
      return occupancy<kRoll1024>(blocks_per_sm);
    case kMod511:
      return occupancy<kMod511>(blocks_per_sm);
    case kBf16:
      return occupancy<kBf16>(blocks_per_sm);
    case kTwoMin:
      return occupancy<kTwoMin>(blocks_per_sm);
    case kRecon:
      return occupancy<kRecon>(blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
