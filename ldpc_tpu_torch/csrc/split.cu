// The phase-split min-sum decoder: two kernels an iteration, with every
// word's compressed check state in device memory between them.
//
// Replaces the Pallas TPU kernels of ldpc_tpu/ops/pallas_split.py:
//   split_r  `kernel_r` (phase A and the latches): for each check, across its
//            row edges in nb-sorted slot order, v = totals[(i + s) mod z] -
//            recon(old state, d) folds into parity, min1/min2/argmin, the
//            sign bits and the sign product; the new state is rounded to the
//            store.  Then per word the latches, check BEFORE update: a word
//            whose checks all hold gets iterations = it and success = 1;
//            errors is its count of totals < 0 over the n variables.
//   split_c  `kernel_c` (phase B): for each variable, tot = -chan, then
//            += recon(state, d) of each column edge, in column-edge order
//            (ascending block row, then slot), rounded to the store.
// The host loop (ops/cuda_split.py) runs split_r for it = 0..max_iters and
// split_c after each but the last, and stops once every word has converged.
// Min-sum flooding, bfloat16 or float32 state, as the Pallas pair.
//
// Layout: word-major.  Each plane is [B, ...] with one word's values
// contiguous: totals and channel [B, n] Store, m1, m2, argmin and sign
// product [B, m] Store, the sign words [B, m, ceil(dc/32)] uint32, the
// latches [B] int32.  One 256-thread block owns one word in each kernel, so
// the latches' sums over a word's m checks and n variables are block
// reductions, with no atomics on them and no third pass; consecutive
// threads take consecutive checks (split_r) or variables (split_c), so the
// state reads are coalesced and the (i + s) mod z reads of the totals are
// too, but at the wrap; a word's totals (16 KB for near-earth in bf16) stay
// in L1 for the dc reads of each.  The TPU's word-minor layout
// [planes, z, B] (words across the lanes) coalesces across words instead;
// tried as 32 words a block (lane = word, 8 warps over the checks or the
// variables, the per-word sums through shared memory), it decoded the
// near-earth stage-1 shape (32,768 words, 12 iterations, 3.4 dB) in 129.5
// and 133.0 ms in bf16 and 162.8 and 163.1 ms in f32, against 42.8 and 43.3
// and 40.5 and 41.0 ms for this layout, with equal outputs (kernel_ab.py,
// H100 80GB HBM3 at 700 W): a block of 32 words reads 32 words' totals
// (512 KB for near-earth), more than an SM's L1, and each word's checks run
// on one lane.  These are plain, right kernels: no wgmma, no TMA.
//
// What bounds them on an H100: bytes.  Each launch moves a live word's
// state once each way (near-earth bf16: split_r 40,892 bytes a word, split_c
// 44,968), against 8 (split_r) and 3 (split_c) float32 operations per edge:
// at 32,768 live words about 0.40 and 0.44 ms of HBM time against 0.13 and
// 0.05 ms of arithmetic.  Shared memory holds only the edge tables, so
// occupancy is set by registers, not by the state (the fused kernel,
// decode.cu, holds a word's whole state in shared memory and refuses a code
// whose state does not fit there; this pair decodes it).
//
// A converged word is skipped by both kernels: its latches are frozen and
// its state is never read again (as the Pallas pair's per-tile all_done and
// decode.cu's per-word exit).  split_r also counts, per iteration, the words
// latched so far (n_ok[it]), which the host reads to stop.  Both kernels
// update the state in place: a check's new state depends only on its own old
// state and on the totals, which split_r only reads; a variable's new total
// only on the state and the channel, which split_c only reads.
//
// Exactness against the Pallas pair, decode.cu and the plain PyTorch
// versions (ops/cuda_static.py::flooding_reference, cuda_split.py):
//   - every state write rounds to the store (__float2bfloat16_rn) and every
//     read widens to f32; arithmetic is f32;
//   - split_c sums tot = -chan, then __fadd_rn of each message in column-
//     edge order, never reassociated (each message is +-1 times a stored
//     magnitude, an exact product);
//   - a new minimum needs a strict <; the argmin is the slot index d as a
//     Store number (bf16: exact to 256);
//   - a sign word has bit d % 32 set through uint32;
//   - do not build with --use_fast_math.
// Non-finite LLRs are not sanitised, as in the Pallas pair.
//
// Tables: ops/cuda_static.py::kernel_tables, the layout of decode.cu (its
// row_base is not used here), staged into shared memory at block start.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;   // two-min fold start (pallas _BIG)

__device__ __forceinline__ float ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ld(float x) { return x; }

template <typename S>
__device__ __forceinline__ S st(float x);

template <>
__device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ float st<float>(float x) {
  return x;
}

__device__ __forceinline__ float bit_sign(uint32_t word, int r) {
  return 1.f - 2.f * static_cast<float>((word >> r) & 1u);
}

struct Geometry {
  int n, m, z, mb_n, nb_n, dc, dv;
  const int* tables;
};

template <typename S>
struct State {
  const S* chan;
  S* tot;
  S* m1;
  S* m2;
  S* am;
  S* sp;
  uint32_t* bits;
  int* errors;
  int* iters;
  int* success;
  int* n_ok;   // [max_iters + 1]: words latched after split_r of iteration it
};

__host__ __device__ __forceinline__ int table_ints(const Geometry& g) {
  return g.mb_n * (2 + 2 * g.dc) + g.nb_n * (1 + 3 * g.dv);
}

__device__ __forceinline__ void stage_tables(const Geometry& g, int* tab) {
  const int n_tab = table_ints(g);
  for (int k = threadIdx.x; k < n_tab; k += kThreads) tab[k] = g.tables[k];
  __syncthreads();
}

// kWide: check degree above 32, ceil(dc/32) sign words per check.
template <typename S, bool kWide>
__global__ void __launch_bounds__(kThreads)
    split_r(const Geometry g, const State<S> s, const int it) {
  extern __shared__ int tab[];
  __shared__ int s_errors;
  const int word = blockIdx.x;
  const int tid = threadIdx.x;
  if (s.success[word]) {   // latched: nothing to do but be counted
    if (tid == 0) atomicAdd(s.n_ok + it, 1);
    return;
  }
  if (tid == 0) s_errors = 0;
  stage_tables(g, tab);
  const int* row_deg = tab;
  const int* row_nb = tab + 2 * g.mb_n;
  const int* row_shift = row_nb + g.mb_n * g.dc;
  const int z = g.z;
  const int n_sw = kWide ? (g.dc + 31) / 32 : 1;
  const size_t wm = static_cast<size_t>(word) * g.m;
  const S* tot = s.tot + static_cast<size_t>(word) * g.n;
  int bad = 0;
  for (int c = tid; c < g.m; c += kThreads) {
    const int mb = c / z;
    const int i = c - mb * z;
    const float o1 = ld(s.m1[wm + c]);
    const float o2 = ld(s.m2[wm + c]);
    const float oam = ld(s.am[wm + c]);
    const float osp = ld(s.sp[wm + c]);
    uint32_t* cbits = s.bits + (wm + c) * n_sw;
    float n1 = kBig, n2 = kBig, nam = 0.f, nsp = 1.f;
    int par = 0;
    const int deg = row_deg[mb];
    const int* rnb = row_nb + mb * g.dc;
    const int* rsh = row_shift + mb * g.dc;
    for (int d0 = 0; d0 < deg; d0 += 32) {
      const uint32_t ob = cbits[d0 >> 5];
      uint32_t nbits = 0u;
      const int dend = kWide ? min(deg, d0 + 32) : deg;
      for (int d = d0; d < dend; ++d) {
        const int r = d - d0;
        int j = i + rsh[d];
        if (j >= z) j -= z;
        const float t = ld(tot[rnb[d] * z + j]);
        par ^= t < 0.f;
        const float mag = (oam == static_cast<float>(d)) ? o2 : o1;
        const float v = t - osp * bit_sign(ob, r) * mag;
        const float av = fabsf(v);
        const bool newmin = av < n1;
        n2 = newmin ? n1 : fminf(n2, av);
        nam = newmin ? static_cast<float>(d) : nam;
        n1 = fminf(n1, av);
        const bool neg = v < 0.f;
        nbits |= static_cast<uint32_t>(neg) << r;
        nsp = neg ? -nsp : nsp;
      }
      cbits[d0 >> 5] = nbits;
    }
    s.m1[wm + c] = st<S>(n1);
    s.m2[wm + c] = st<S>(n2);
    s.am[wm + c] = st<S>(nam);
    s.sp[wm + c] = st<S>(nsp);
    bad |= par;
  }
  const int any_bad = __syncthreads_or(bad);
  int cnt = 0;
  for (int v = tid; v < g.n; v += kThreads) cnt += ld(tot[v]) < 0.f;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((tid & 31) == 0) atomicAdd(&s_errors, cnt);
  __syncthreads();
  if (tid == 0) {
    s.errors[word] = s_errors;
    if (!any_bad) {
      s.iters[word] = it;
      s.success[word] = 1;
      atomicAdd(s.n_ok + it, 1);
    }
  }
}

template <typename S, bool kWide>
__global__ void __launch_bounds__(kThreads)
    split_c(const Geometry g, const State<S> s) {
  extern __shared__ int tab[];
  const int word = blockIdx.x;
  if (s.success[word]) return;   // latched: its totals are never read again
  stage_tables(g, tab);
  const int* col_deg = tab + g.mb_n * (2 + 2 * g.dc);
  const int* col_mb = col_deg + g.nb_n;
  const int* col_d = col_mb + g.nb_n * g.dv;
  const int* col_shift = col_d + g.nb_n * g.dv;
  const int z = g.z;
  const int n_sw = kWide ? (g.dc + 31) / 32 : 1;
  const size_t wm = static_cast<size_t>(word) * g.m;
  const size_t wn = static_cast<size_t>(word) * g.n;
  for (int v = threadIdx.x; v < g.n; v += kThreads) {
    const int nb = v / z;
    const int j = v - nb * z;
    float acc = -ld(s.chan[wn + v]);
    const int deg = col_deg[nb];
    for (int k = 0; k < deg; ++k) {
      const int e = nb * g.dv + k;
      const int d = col_d[e];
      int i = j - col_shift[e];
      if (i < 0) i += z;
      const size_t c = wm + col_mb[e] * z + i;
      const uint32_t w = s.bits[c * n_sw + (kWide ? d >> 5 : 0)];
      const float sgn = ld(s.sp[c]) * bit_sign(w, d & 31);
      const float mag =
          (ld(s.am[c]) == static_cast<float>(d)) ? ld(s.m2[c]) : ld(s.m1[c]);
      acc = __fadd_rn(acc, sgn * mag);
    }
    s.tot[wn + v] = st<S>(acc);
  }
}

template <typename S>
int launch_r(const Geometry& g, const State<S>& s, int batch, int it,
             cudaStream_t stream) {
  const size_t smem = 4u * static_cast<size_t>(table_ints(g));
  if (g.dc > 32) {
    split_r<S, true><<<batch, kThreads, smem, stream>>>(g, s, it);
  } else {
    split_r<S, false><<<batch, kThreads, smem, stream>>>(g, s, it);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_c(const Geometry& g, const State<S>& s, int batch,
             cudaStream_t stream) {
  const size_t smem = 4u * static_cast<size_t>(table_ints(g));
  if (g.dc > 32) {
    split_c<S, true><<<batch, kThreads, smem, stream>>>(g, s);
  } else {
    split_c<S, false><<<batch, kThreads, smem, stream>>>(g, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
State<S> state_of(const void* chan, void* tot, void* m1, void* m2, void* am,
                  void* sp, int* bits, int* errors, int* iters, int* success,
                  int* n_ok) {
  return State<S>{static_cast<const S*>(chan), static_cast<S*>(tot),
                  static_cast<S*>(m1),          static_cast<S*>(m2),
                  static_cast<S*>(am),          static_cast<S*>(sp),
                  reinterpret_cast<uint32_t*>(bits),
                  errors, iters, success, n_ok};
}

}  // namespace

extern "C" {

// Launch split_r (phase 0, iteration `it`) or split_c (phase 1) on `stream`
// over `batch` words; returns cudaGetLastError() (0 when the launch was
// accepted).  store: 0 bfloat16, 1 float32.  All pointers are device
// pointers to the planes described above; nothing is allocated here.
int split_launch(int phase, int store, int batch, int n, int m, int z,
                 int mb_n, int nb_n, int dc, int dv, const int* tables,
                 const void* chan, void* tot, void* m1, void* m2, void* am,
                 void* sp, int* bits, int* errors, int* iters, int* success,
                 int* n_ok, int it, void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const Geometry g{n, m, z, mb_n, nb_n, dc, dv, tables};
  if (store == 0) {
    const auto s = state_of<__nv_bfloat16>(chan, tot, m1, m2, am, sp, bits,
                                           errors, iters, success, n_ok);
    return phase == 0 ? launch_r(g, s, batch, it, strm)
                      : launch_c(g, s, batch, strm);
  }
  if (store == 1) {
    const auto s = state_of<float>(chan, tot, m1, m2, am, sp, bits, errors,
                                   iters, success, n_ok);
    return phase == 0 ? launch_r(g, s, batch, it, strm)
                      : launch_c(g, s, batch, strm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
