// Flooding min-sum decode of QC-LDPC words, one thread block per word.
//
// Replaces the Pallas TPU kernel ldpc_tpu/ops/pallas_static.py::_build_kernel
// (its `kernel` body, flooding schedule, kind="min-sum", bfloat16 state).
// Contract of decode_counts there: per word (bit errors against the all-zero
// codeword, iterations, success), check BEFORE update, max_iters + 1 bodies,
// non-converged words report the state after exactly max_iters updates.
//
// What bounds it on an H100.  HBM traffic is the float32 LLRs in (4 bytes a
// bit) and 12 bytes a word out; everything else stays in shared memory.  The
// work is about 11 float32 operations per Tanner edge and iteration (the
// two-min fold, the rebuild of the old check message, the rebuilt message
// added into the variable totals), 32,704 edges a near-earth word, so the
// kernel is bound by operations, not bytes: at 10 iterations a word moves
// 32 KB and does 3.6 M operations.
//
// Why this layout.  The TPU kernel lays 128 words across the vector lanes
// and keeps their state in VMEM.  Here one block owns one word and keeps its
// whole state in shared memory (near-earth: 44,968 bytes, plus 1,352 bytes
// of edge tables):
//   chan, totals       n   bf16 each   (variable frame)
//   m1, m2, argmin, sp m   bf16 each   (two-min check state, no per-edge
//   sign bits          m   uint32       message is stored)
// Phase A runs one thread per check (the rotation into the check frame is
// the index (i + s) mod z), phase B one thread per variable.  A word leaves
// the loop as soon as all its checks are satisfied (__syncthreads_or): the
// TPU kernel's latches freeze a converged word, so per-word exit gives the
// same outputs as its per-tile exit, and no pad row is needed since z is
// indexed exactly.  Several words per block, TMA loads and int8 state are
// later work.
//
// Exactness against the JAX kernel and the plain PyTorch version
// (ldpc_tpu_torch/ops/cuda_static.py::minsum_flooding_reference):
//   - every state write rounds to bf16 with __float2bfloat16_rn and every
//     read widens to f32; arithmetic is f32;
//   - the argmin plane holds the slot index d as a bf16 number (exact to 256);
//   - phase B sums each variable as tot = -chan, then += in the plan's
//     column-edge order (ascending block row, then slot), never reassociated;
//     the products sgn * mag are by +-1 and exact, so a contraction into an
//     FMA changes nothing; do not build with --use_fast_math;
//   - a new minimum needs a strict <; signs are bit d of a uint32.
//
// Tables (int32, one array, staged into shared memory at block start):
//   row_deg[mb_n] | row_nb[mb_n*dc] | row_shift[mb_n*dc] |
//   col_deg[nb_n] | col_mb[nb_n*dv] | col_d[nb_n*dv] | col_shift[nb_n*dv]
// Row slots d < row_deg[mb] are the plan's CN slots (d is the sign bit and
// the argmin value); column slots are in accumulation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;       // two-min fold start (pallas _BIG)
constexpr float kLlrClip = 1.0e30f;   // +-inf -> +-1e30, as at kernel entry

__device__ __forceinline__ float ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ __nv_bfloat16 st(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int table_ints(int mb_n, int nb_n, int dc,
                                                   int dv) {
  return mb_n * (1 + 2 * dc) + nb_n * (1 + 3 * dv);
}

__global__ void __launch_bounds__(kThreads)
minsum_flooding_kernel(const float* __restrict__ llr, int n, int m, int z,
                       int mb_n, int nb_n, int dc, int dv,
                       const int* __restrict__ tables, int max_iters,
                       int* __restrict__ errors, int* __restrict__ iters,
                       int* __restrict__ success) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_errors;
  const int n_tab = table_ints(mb_n, nb_n, dc, dv);
  int* tab = reinterpret_cast<int*>(smem);
  const int* row_deg = tab;
  const int* row_nb = row_deg + mb_n;
  const int* row_shift = row_nb + mb_n * dc;
  const int* col_deg = row_shift + mb_n * dc;
  const int* col_mb = col_deg + nb_n;
  const int* col_d = col_mb + nb_n * dv;
  const int* col_shift = col_d + nb_n * dv;
  uint32_t* bits = reinterpret_cast<uint32_t*>(tab + n_tab);
  __nv_bfloat16* m1 = reinterpret_cast<__nv_bfloat16*>(bits + m);
  __nv_bfloat16* m2 = m1 + m;
  __nv_bfloat16* am = m2 + m;
  __nv_bfloat16* sp = am + m;
  __nv_bfloat16* chan = sp + m;
  __nv_bfloat16* tot = chan + n;

  const int tid = threadIdx.x;
  const int word = blockIdx.x;
  for (int k = tid; k < n_tab; k += kThreads) tab[k] = tables[k];
  const float* in = llr + static_cast<size_t>(word) * n;
  for (int v = tid; v < n; v += kThreads) {
    float x = in[v];
    x = isnan(x) ? 0.f : fminf(fmaxf(x, -kLlrClip), kLlrClip);
    const __nv_bfloat16 c = st(x);
    chan[v] = c;
    tot[v] = st(-ld(c));      // decoders negate on entry
  }
  for (int c = tid; c < m; c += kThreads) {
    bits[c] = 0u;
    m1[c] = st(0.f);          // rebuilt c2v == 0 on the first iteration
    m2[c] = st(0.f);
    am[c] = st(0.f);
    sp[c] = st(1.f);
  }
  if (tid == 0) s_errors = 0;
  __syncthreads();

  int it_done = max_iters;
  int ok = 0;
  for (int it = 0;; ++it) {
    // ---- phase A: syndrome of the current totals + new two-min state ----
    int bad = 0;
    for (int c = tid; c < m; c += kThreads) {
      const int mb = c / z;
      const int i = c - mb * z;
      const float o1 = ld(m1[c]), o2 = ld(m2[c]);
      const float oam = ld(am[c]), osp = ld(sp[c]);
      const uint32_t ob = bits[c];
      float n1 = kBig, n2 = kBig, nam = 0.f, nsp = 1.f;
      uint32_t nbits = 0u;
      int par = 0;
      const int deg = row_deg[mb];
      const int* rnb = row_nb + mb * dc;
      const int* rsh = row_shift + mb * dc;
      for (int d = 0; d < deg; ++d) {
        int j = i + rsh[d];
        if (j >= z) j -= z;
        const float t = ld(tot[rnb[d] * z + j]);
        par ^= t < 0.f;
        const float sgn = osp * (1.f - 2.f * static_cast<float>((ob >> d) & 1u));
        const float mag = (oam == static_cast<float>(d)) ? o2 : o1;
        const float v = t - sgn * mag;
        const float a = fabsf(v);
        const bool newmin = a < n1;
        n2 = newmin ? n1 : fminf(n2, a);
        nam = newmin ? static_cast<float>(d) : nam;
        n1 = fminf(n1, a);
        const bool neg = v < 0.f;
        nbits |= static_cast<uint32_t>(neg) << d;
        nsp = neg ? -nsp : nsp;
      }
      m1[c] = st(n1);
      m2[c] = st(n2);
      am[c] = st(nam);
      sp[c] = st(nsp);
      bits[c] = nbits;
      bad |= par;
    }
    if (!__syncthreads_or(bad)) {
      ok = 1;
      it_done = it;
      break;
    }
    if (it == max_iters) break;
    // ---- phase B: totals = -chan + sum of the rebuilt c2v messages ----
    for (int v = tid; v < n; v += kThreads) {
      const int nb = v / z;
      const int j = v - nb * z;
      float acc = -ld(chan[v]);
      const int deg = col_deg[nb];
      for (int k = 0; k < deg; ++k) {
        const int e = nb * dv + k;
        const int d = col_d[e];
        int i = j - col_shift[e];
        if (i < 0) i += z;
        const int c = col_mb[e] * z + i;
        const float sgn =
            ld(sp[c]) * (1.f - 2.f * static_cast<float>((bits[c] >> d) & 1u));
        const float mag =
            (ld(am[c]) == static_cast<float>(d)) ? ld(m2[c]) : ld(m1[c]);
        acc = acc + sgn * mag;
      }
      tot[v] = st(acc);
    }
    __syncthreads();
  }

  // errors against the all-zero word, from the latched state's totals
  int cnt = 0;
  for (int v = tid; v < n; v += kThreads) cnt += ld(tot[v]) < 0.f;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((tid & 31) == 0) atomicAdd(&s_errors, cnt);
  __syncthreads();
  if (tid == 0) {
    errors[word] = s_errors;
    iters[word] = it_done;
    success[word] = ok;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  All pointers are device pointers; nothing is allocated here.
int minsum_flooding_launch(const float* llr, int batch, int n, int m, int z,
                           int mb_n, int nb_n, int dc, int dv,
                           const int* tables, int max_iters, int* errors,
                           int* iters, int* success, void* stream) {
  // dynamic shared memory: tables and sign words (4 bytes each), then the
  // four two-min planes and chan/totals (bf16)
  const long long smem =
      4LL * (table_ints(mb_n, nb_n, dc, dv) + m) + 2LL * (4LL * m + 2LL * n);
  cudaError_t err = cudaFuncSetAttribute(
      minsum_flooding_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  minsum_flooding_kernel<<<batch, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(
      llr, n, m, z, mb_n, nb_n, dc, dv, tables, max_iters, errors, iters,
      success);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
