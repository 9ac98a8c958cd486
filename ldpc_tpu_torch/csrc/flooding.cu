// Flooding decode of QC-LDPC words, one thread block per word: the min-sum
// family (min-sum, normalized, offset) and sum-product, with bf16 or f32
// state.  One kernel template, instantiated for the 4 kinds x 2 stores (x
// check degree up to 32, or above).
//
// Replaces the Pallas TPU kernel ldpc_tpu/ops/pallas_static.py::_build_kernel
// (its `kernel` body, flooding schedule), in these variants:
//   B1  kind="min-sum", store_dtype bfloat16 or float32 (`_st`/`_ld`);
//   B2  kind="normalized-min-sum" / "offset-min-sum" (`_recon`): the
//       magnitude is scaled by alpha, or lowered by beta and floored at 0,
//       where a message is rebuilt (phase A and phase B); the stored state
//       stays the raw two-min;
//   B4  kind="sum-product" (`_phi`, `_recon_sp`, `_row_pass_sp`): per check
//       the phi total S, the sign product and the packed edge signs, and one
//       stashed phi per (block edge, check).
// Contract of decode_counts there: per word (bit errors against the all-zero
// codeword, iterations, success), check BEFORE update, max_iters + 1 bodies,
// non-converged words report the state after exactly max_iters updates.
//
// What bounds each variant on an H100.  HBM traffic is the float32 LLRs in
// (4 bytes a bit) and 12 bytes a word out; all state stays in shared
// memory.  The min-sum family does about 11 float32 operations per Tanner
// edge and iteration (12 normalized, 13 offset); sum-product about 14 plus
// two tanhf and two logf in phase A and 8 plus one of each in phase B.
// Every variant is bound by operations, not bytes.
//
// Why this layout.  The TPU kernel lays 128 words across the vector lanes
// and keeps their state in VMEM.  Here one block owns one word and keeps its
// whole state in shared memory:
//   chan, totals       n      Store each  (variable frame)
//   min-sum family:    m1, m2, argmin, sign product: m Store each
//   sum-product:       S, sign product: m Store each; phi stash:
//                      n_edges * z Store (block edge e, check i at e*z + i)
//   edge signs         m * ceil(dc/32) uint32 (bit d%32 of word d/32)
//   edge tables        int32, below
// Bytes per block (dynamic shared memory, tables included):
//                      near-earth (n 8176, m 1022)   802.11n (n 1944), r1/2
//   min-sum, bf16      46,328                        23,568
//   min-sum, f32       87,208                        39,120
//   sum-product, bf16  107,648                       33,612
//   sum-product, f32   209,848                       59,208
// Sum-product with f32 state on near-earth leaves room for one block of 256
// threads on an SM; it is slow, and right.  Phase A runs one thread per
// check (the rotation into the check frame is the index (i + s) mod z),
// phase B one thread per variable.  A word leaves the loop as soon as all
// its checks are satisfied (__syncthreads_or): the TPU kernel's latches
// freeze a converged word, so per-word exit gives the same outputs as its
// per-tile exit, and no pad row is needed since z is indexed exactly.
//
// Exactness against the JAX kernel and the plain PyTorch version
// (ldpc_tpu_torch/ops/cuda_static.py::flooding_reference):
//   - every state write rounds to the store type (__float2bfloat16_rn for
//     bf16) and every read widens to f32; arithmetic is f32;
//   - the argmin plane holds the slot index d as a Store number (bf16:
//     exact to 256; f32: to 2^24);
//   - phase B sums each variable as tot = -chan, then += in the plan's
//     column-edge order (ascending block row, then slot), never
//     reassociated; sum-product's S sums the new phi in row-slot order
//     (ascending block column); the products sgn * x are by +-1 and exact,
//     so a contraction into an FMA changes nothing; do not build with
//     --use_fast_math;
//   - phi(x) = -logf(tanhf(x * 0.5f)): two rounded library calls, as
//     torch computes -torch.log(torch.tanh(x * 0.5)) on the card;
//   - a new minimum needs a strict <.
//
// Tables (int32, one array, staged into shared memory at block start):
//   row_deg[mb_n] | row_base[mb_n] | row_nb[mb_n*dc] | row_shift[mb_n*dc] |
//   col_deg[nb_n] | col_mb[nb_n*dv] | col_d[nb_n*dv] | col_shift[nb_n*dv]
// Row slots d < row_deg[mb] are the plan's CN slots (d is the sign bit and
// the argmin value); row_base[mb] is the index of the row's first block
// edge in the phi stash; column slots are in accumulation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;       // two-min fold start (pallas _BIG)
constexpr float kLlrClip = 1.0e30f;   // +-inf -> +-1e30, as at kernel entry
constexpr float kPhiMin = 1.0e-9f;    // phi argument clip (pallas _PHI_MIN)
constexpr float kPhiMax = 38.0f;      // (pallas _PHI_MAX); phi(38) == 0

enum Kind : int {
  kMinSum = 0,
  kNormalized = 1,
  kOffset = 2,
  kSumProduct = 3
};

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

__device__ __forceinline__ float phi(float x) {
  return -logf(tanhf(x * 0.5f));
}

__device__ __forceinline__ float clip_phi(float x) {
  return fminf(fmaxf(x, kPhiMin), kPhiMax);
}

// The rebuilt magnitude of a min-sum-family message (`_recon`).
template <int K>
__device__ __forceinline__ float adjust(float mag, float alpha, float beta) {
  if (K == kNormalized) return mag * alpha;
  if (K == kOffset) return fmaxf(mag - beta, 0.f);
  return mag;
}

__host__ __device__ __forceinline__ int table_ints(int mb_n, int nb_n, int dc,
                                                   int dv) {
  return mb_n * (2 + 2 * dc) + nb_n * (1 + 3 * dv);
}

__host__ __device__ __forceinline__ int sign_words(int dc) {
  return (dc + 31) / 32;
}

// kWide: check degree above 32, ceil(dc/32) sign words per check; without
// it the one-word layout compiles to the single-word code.
template <int K, typename S, bool kWide>
__global__ void __launch_bounds__(kThreads)
flooding_kernel(const float* __restrict__ llr, int n, int m, int z, int mb_n,
                int nb_n, int dc, int dv, int n_edges,
                const int* __restrict__ tables, int max_iters, float alpha,
                float beta, int* __restrict__ errors, int* __restrict__ iters,
                int* __restrict__ success) {
  constexpr bool kSp = K == kSumProduct;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_errors;
  const int n_tab = table_ints(mb_n, nb_n, dc, dv);
  const int n_sw = kWide ? sign_words(dc) : 1;
  int* tab = reinterpret_cast<int*>(smem);
  const int* row_deg = tab;
  const int* row_base = row_deg + mb_n;
  const int* row_nb = row_base + mb_n;
  const int* row_shift = row_nb + mb_n * dc;
  const int* col_deg = row_shift + mb_n * dc;
  const int* col_mb = col_deg + nb_n;
  const int* col_d = col_mb + nb_n * dv;
  const int* col_shift = col_d + nb_n * dv;
  uint32_t* bits = reinterpret_cast<uint32_t*>(tab + n_tab);
  // min-sum family: m1 | m2 | am | sp; sum-product: S (in m1) | sp | stash
  S* m1 = reinterpret_cast<S*>(bits + m * n_sw);
  S* m2 = m1 + m;               // sum-product: the sign product
  S* am = m2 + m;               // sum-product: the phi stash
  S* sp = kSp ? m2 : am + m;
  S* chan = kSp ? am + n_edges * z : sp + m;
  S* tot = chan + n;

  const int tid = threadIdx.x;
  const int word = blockIdx.x;
  for (int k = tid; k < n_tab; k += kThreads) tab[k] = tables[k];
  const float* in = llr + static_cast<size_t>(word) * n;
  for (int v = tid; v < n; v += kThreads) {
    float x = in[v];
    x = isnan(x) ? 0.f : fminf(fmaxf(x, -kLlrClip), kLlrClip);
    const S c = st<S>(x);
    chan[v] = c;
    tot[v] = st<S>(-ld(c));   // decoders negate on entry
  }
  for (int k = tid; k < m * n_sw; k += kThreads) bits[k] = 0u;
  for (int c = tid; c < m; c += kThreads) {
    sp[c] = st<S>(1.f);
    if (kSp) {
      m1[c] = st<S>(kPhiMax);   // S = 38 with a 0 stash rebuilds c2v == 0
    } else {
      m1[c] = st<S>(0.f);       // rebuilt c2v == 0 on the first iteration
      m2[c] = st<S>(0.f);
      am[c] = st<S>(0.f);
    }
  }
  if (kSp) {
    for (int k = tid; k < n_edges * z; k += kThreads) am[k] = st<S>(0.f);
  }
  if (tid == 0) s_errors = 0;
  __syncthreads();

  int it_done = max_iters;
  int ok = 0;
  for (int it = 0;; ++it) {
    // ---- phase A: syndrome of the current totals + new check state ----
    int bad = 0;
    for (int c = tid; c < m; c += kThreads) {
      const int mb = c / z;
      const int i = c - mb * z;
      const float o1 = ld(m1[c]);                // sum-product: S
      const float o2 = kSp ? 0.f : ld(m2[c]);
      const float oam = kSp ? 0.f : ld(am[c]);
      const float osp = ld(sp[c]);
      uint32_t* cbits = bits + c * n_sw;
      float n1 = kSp ? 0.f : kBig, n2 = kBig, nam = 0.f, nsp = 1.f;
      int par = 0;
      const int deg = row_deg[mb];
      const int* rnb = row_nb + mb * dc;
      const int* rsh = row_shift + mb * dc;
      S* stash = kSp ? am + row_base[mb] * z + i : nullptr;
      // one 32-slot sign word at a time: its old bits are all read before
      // the new word is written back
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
          const float sgn =
              osp * (1.f - 2.f * static_cast<float>((ob >> r) & 1u));
          float v;
          if (kSp) {
            v = t - sgn * phi(clip_phi(o1 - ld(stash[d * z])));
            const float ph = phi(clip_phi(fabsf(v)));
            stash[d * z] = st<S>(ph);
            n1 = n1 + ph;
          } else {
            const float mag = (oam == static_cast<float>(d)) ? o2 : o1;
            v = t - sgn * adjust<K>(mag, alpha, beta);
            const float a = fabsf(v);
            const bool newmin = a < n1;
            n2 = newmin ? n1 : fminf(n2, a);
            nam = newmin ? static_cast<float>(d) : nam;
            n1 = fminf(n1, a);
          }
          const bool neg = v < 0.f;
          nbits |= static_cast<uint32_t>(neg) << r;
          nsp = neg ? -nsp : nsp;
        }
        cbits[d0 >> 5] = nbits;
      }
      m1[c] = st<S>(n1);
      if (!kSp) {
        m2[c] = st<S>(n2);
        am[c] = st<S>(nam);
      }
      sp[c] = st<S>(nsp);
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
        const int cmb = col_mb[e];
        const int c = cmb * z + i;
        const uint32_t word =
            kWide ? bits[c * n_sw + (d >> 5)] >> (d & 31) : bits[c] >> d;
        const float sgn =
            ld(sp[c]) * (1.f - 2.f * static_cast<float>(word & 1u));
        float mag;
        if (kSp) {
          mag = phi(clip_phi(ld(m1[c]) - ld(am[(row_base[cmb] + d) * z + i])));
        } else {
          mag = adjust<K>(
              (ld(am[c]) == static_cast<float>(d)) ? ld(m2[c]) : ld(m1[c]),
              alpha, beta);
        }
        acc = acc + sgn * mag;
      }
      tot[v] = st<S>(acc);
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

template <int K, typename S>
long long smem_bytes(int n, int m, int z, int mb_n, int nb_n, int dc, int dv,
                     int n_edges) {
  const long long planes = K == kSumProduct
                               ? 2LL * m + 1LL * n_edges * z + 2LL * n
                               : 4LL * m + 2LL * n;
  return 4LL * (table_ints(mb_n, nb_n, dc, dv) + 1LL * m * sign_words(dc)) +
         static_cast<long long>(sizeof(S)) * planes;
}

template <int K, typename S>
int launch(const float* llr, int batch, int n, int m, int z, int mb_n,
           int nb_n, int dc, int dv, int n_edges, const int* tables,
           int max_iters, float alpha, float beta, int* errors, int* iters,
           int* success, cudaStream_t stream) {
  const long long smem =
      smem_bytes<K, S>(n, m, z, mb_n, nb_n, dc, dv, n_edges);
  const auto kernel = dc > 32 ? flooding_kernel<K, S, true>
                               : flooding_kernel<K, S, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, static_cast<size_t>(smem), stream>>>(
      llr, n, m, z, mb_n, nb_n, dc, dv, n_edges, tables, max_iters, alpha,
      beta, errors, iters, success);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_kind(int store, const float* llr, int batch, int n, int m, int z,
                int mb_n, int nb_n, int dc, int dv, int n_edges,
                const int* tables, int max_iters, float alpha, float beta,
                int* errors, int* iters, int* success, cudaStream_t stream) {
  if (store == 0)
    return launch<K, __nv_bfloat16>(llr, batch, n, m, z, mb_n, nb_n, dc, dv,
                                    n_edges, tables, max_iters, alpha, beta,
                                    errors, iters, success, stream);
  if (store == 1)
    return launch<K, float>(llr, batch, n, m, z, mb_n, nb_n, dc, dv, n_edges,
                            tables, max_iters, alpha, beta, errors, iters,
                            success, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  kind: 0 min-sum, 1 normalized, 2 offset, 3 sum-product;
// store: 0 bfloat16, 1 float32.  All pointers are device pointers; nothing
// is allocated here.
int flooding_launch(int kind, int store, const float* llr, int batch, int n,
                    int m, int z, int mb_n, int nb_n, int dc, int dv,
                    int n_edges, const int* tables, int max_iters,
                    float alpha, float beta, int* errors, int* iters,
                    int* success, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMinSum:
      return launch_kind<kMinSum>(store, llr, batch, n, m, z, mb_n, nb_n, dc,
                                  dv, n_edges, tables, max_iters, alpha, beta,
                                  errors, iters, success, s);
    case kNormalized:
      return launch_kind<kNormalized>(store, llr, batch, n, m, z, mb_n, nb_n,
                                      dc, dv, n_edges, tables, max_iters,
                                      alpha, beta, errors, iters, success, s);
    case kOffset:
      return launch_kind<kOffset>(store, llr, batch, n, m, z, mb_n, nb_n, dc,
                                  dv, n_edges, tables, max_iters, alpha, beta,
                                  errors, iters, success, s);
    case kSumProduct:
      return launch_kind<kSumProduct>(store, llr, batch, n, m, z, mb_n, nb_n,
                                      dc, dv, n_edges, tables, max_iters,
                                      alpha, beta, errors, iters, success, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
