// Decode of QC-LDPC words, one thread block per word, with compressed check
// state in shared memory: the min-sum family (min-sum, normalized, offset)
// under the flooding or the layered schedule, with bf16, f32 or int8 Q4.3
// state and the sign product stored or folded from the sign bits; and
// sum-product (flooding, bf16 or f32 state).  One kernel template,
// instantiated 76 times: 3 kinds x 3 stores x 2 schedules x 2 sign modes
// plus sum-product's 2 stores, each for check degree up to 32 or above.
//
// Replaces the Pallas TPU kernel ldpc_tpu/ops/pallas_static.py::_build_kernel
// (its `kernel` body), in these variants:
//   B1  kind="min-sum", flooding, store_dtype bfloat16 or float32;
//   B2  kind="normalized-min-sum" / "offset-min-sum" (`_recon`): the
//       magnitude is scaled by alpha, or lowered by beta and floored at 0,
//       where a message is rebuilt; the stored state stays the raw two-min;
//   B3  schedule="layered" (`layered_body`): a syndrome pass over the
//       totals at the start of the sweep, the latches, then block row by
//       block row the new state from the current totals, each edge's
//       delta (new c2v - old c2v) added to the totals and rounded to the
//       store, edge by edge in row-slot order;
//   B4  kind="sum-product" (`_phi`, `_recon_sp`, `_row_pass_sp`): per check
//       the phi total S, the sign product and the packed edge signs, and one
//       stashed phi per (block edge, check);
//   B5  store_dtype int8 (`_st`/`_ld`/`_st_raw`): a value is stored as
//       clip(rint(x * 8), -127, 127) and loaded as q / 8 (Q4.3; the two-min
//       start saturates to 127); the argmin plane holds the slot index
//       unscaled; the LLRs enter through the same quantizer;
//   B6  popcount_sign (`_sign_from_bits`): the sign product is the parity
//       of the xor of the check's sign words, and no sign plane is kept.
// Contract of decode_counts there: per word (bit errors against the all-zero
// codeword, iterations, success), check BEFORE update, max_iters + 1 bodies,
// non-converged words report the state after exactly max_iters updates.
//
// What bounds each variant on an H100.  HBM traffic is the float32 LLRs in
// (4 bytes a bit) and 12 bytes a word out; all state stays in shared
// memory.  The min-sum family does about 11 float32 operations per Tanner
// edge and iteration under flooding (12 normalized, 13 offset) and about 16
// under the layered schedule (a syndrome pass, the row update, and two
// rebuilt messages, a subtract and an add per edge); sum-product about 14
// plus two tanhf and two logf in phase A and 8 plus one of each in phase B.
// Every variant is bound by operations, not bytes.
//
// Why this layout.  The TPU kernel lays 128 words across the vector lanes
// and keeps their state in VMEM.  Here one block owns one word and keeps its
// whole state in shared memory:
//   chan, totals       n      Store each  (variable frame)
//   min-sum family:    m1, m2, argmin: m Store each; the sign product: m
//                      Store unless popcount_sign
//   sum-product:       S, sign product: m Store each; phi stash:
//                      n_edges * z Store (block edge e, check i at e*z + i)
//   edge signs         m * ceil(dc/32) uint32 (bit d%32 of word d/32)
//   layered row:       z * (ceil(dc/32) + 4) 32-bit words: the new state of
//                      the block row being updated (signs, then m1, m2,
//                      argmin and sign product as f32)
//   edge tables        int32, below
// Bytes per block (dynamic shared memory, tables included):
//                      near-earth (n 8176, m 1022)   802.11n (n 1944), r1/2
//   min-sum, bf16      46,328                        23,568
//   min-sum, f32       87,208                        39,120
//   min-sum, int8      25,888                        15,792
//   popcount_sign      m * sizeof(Store) less
//   layered            + 10,220                      + 1,620
//   sum-product, bf16  107,648                       33,612
//   sum-product, f32   209,848                       59,208
// Sum-product with f32 state on near-earth leaves room for one block of 256
// threads on an SM; it is slow, and right.  Flooding phase A runs one thread
// per check (the rotation into the check frame is the index (i + s) mod z),
// phase B one thread per variable.  A word leaves the loop as soon as all
// its checks are satisfied (__syncthreads_or): the TPU kernel's latches
// freeze a converged word, so per-word exit gives the same outputs as its
// per-tile exit, and no pad row is needed since z is indexed exactly.
//
// The layered hazard.  A block of the base matrix may hold several shifts
// (near-earth: two in each), so two edges of one row reach the same
// variable, and the order in which their deltas are rounded into the totals
// decides the result.  The update of a block row therefore runs in three
// steps with a barrier after the first two: (a) one thread per check builds
// the row's new state from the current totals and the old state, into the
// row scratch (f32, unrounded, as Pallas rebuilds the new messages from the
// unrounded fold); (c) one thread per (block column, variable) of the row
// applies that column's edges of the row in slot order, rounding the total
// after each; (d) each check's new state is rounded into its planes (the
// same thread owns check i in (d) and in the next row's (a), so they need no
// barrier between them).  The cost: 2 barriers per block row; near-earth
// has 2 block rows of 16 edge pairs, 802.11n rate 1/2 12 rows of 81 checks,
// which keep only 81 of 256 threads busy in (a).
//
// Exactness against the JAX kernel and the plain PyTorch version
// (ldpc_tpu_torch/ops/cuda_static.py::flooding_reference and
// layered_reference):
//   - every state write rounds to the store type (__float2bfloat16_rn for
//     bf16, rintf, which rounds half to even as jnp.round does, for int8)
//     and every read widens to f32; arithmetic is f32;
//   - the argmin plane holds the slot index d as a Store number (bf16:
//     exact to 256; f32: to 2^24; int8: unscaled, to 127);
//   - flooding phase B sums each variable as tot = -chan, then += in the
//     plan's column-edge order (ascending block row, then slot), never
//     reassociated; sum-product's S sums the new phi in row-slot order
//     (ascending block column); the products sgn * x are by +-1 and exact,
//     so a contraction into an FMA changes nothing; the other products
//     (alpha) and the layered delta and total use __fmul_rn / __fsub_rn /
//     __fadd_rn, which are never contracted; do not build with
//     --use_fast_math;
//   - phi(x) = -logf(tanhf(x * 0.5f)): two rounded library calls, as
//     torch computes -torch.log(torch.tanh(x * 0.5)) on the card;
//   - a new minimum needs a strict <;
//   - the stored and the folded sign product are the same +-1, so
//     popcount_sign changes no value anywhere.
//
// Tables (int32, one array, staged into shared memory at block start):
//   row_deg[mb_n] | row_base[mb_n] | row_nb[mb_n*dc] | row_shift[mb_n*dc] |
//   col_deg[nb_n] | col_mb[nb_n*dv] | col_d[nb_n*dv] | col_shift[nb_n*dv]
// Row slots d < row_deg[mb] are the plan's CN slots, in ascending block
// column (d is the sign bit and the argmin value); row_base[mb] is the index
// of the row's first block edge in the phi stash; column slots are in
// accumulation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;       // two-min fold start (pallas _BIG)
constexpr float kLlrClip = 1.0e30f;   // +-inf -> +-1e30, as at kernel entry
constexpr float kPhiMin = 1.0e-9f;    // phi argument clip (pallas _PHI_MIN)
constexpr float kPhiMax = 38.0f;      // (pallas _PHI_MAX); phi(38) == 0
constexpr float kQuant = 8.0f;        // Q4.3 step 1/8 (pallas _QUANT_SCALE)
constexpr float kQuantMax = 127.0f;   // symmetric int8 clip

enum Kind : int {
  kMinSum = 0,
  kNormalized = 1,
  kOffset = 2,
  kSumProduct = 3
};

// ---- the store types: st rounds an f32 into the store, ld widens it;
// st_raw / ld_raw hold the argmin plane (a slot index, never scaled) ----

__device__ __forceinline__ float ld(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ld(float x) { return x; }

__device__ __forceinline__ float ld(int8_t q) {
  return static_cast<float>(q) * (1.0f / kQuant);
}

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

// clamp in float before converting: kBig * 8 is inf and must give 127
template <>
__device__ __forceinline__ int8_t st<int8_t>(float x) {
  return static_cast<int8_t>(
      fminf(fmaxf(rintf(x * kQuant), -kQuantMax), kQuantMax));
}

template <typename S>
__device__ __forceinline__ S st_raw(float x) {
  return st<S>(x);
}

template <>
__device__ __forceinline__ int8_t st_raw<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

__device__ __forceinline__ float ld_raw(__nv_bfloat16 x) { return ld(x); }
__device__ __forceinline__ float ld_raw(float x) { return x; }
__device__ __forceinline__ float ld_raw(int8_t q) {
  return static_cast<float>(q);
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
  if (K == kNormalized) return __fmul_rn(mag, alpha);
  if (K == kOffset) return fmaxf(mag - beta, 0.f);
  return mag;
}

// +-1 from the parity of a check's sign words (`_sign_from_bits`).
template <bool kWide>
__device__ __forceinline__ float parity_sign(const uint32_t* w, int n_sw) {
  uint32_t x = w[0];
  if (kWide) {
    for (int k = 1; k < n_sw; ++k) x ^= w[k];
  }
  return 1.f - 2.f * static_cast<float>(__popc(x) & 1);
}

__device__ __forceinline__ float bit_sign(uint32_t word, int r) {
  return 1.f - 2.f * static_cast<float>((word >> r) & 1u);
}

__host__ __device__ __forceinline__ int table_ints(int mb_n, int nb_n, int dc,
                                                   int dv) {
  return mb_n * (2 + 2 * dc) + nb_n * (1 + 3 * dv);
}

__host__ __device__ __forceinline__ int sign_words(int dc) {
  return (dc + 31) / 32;
}

struct Args {
  const float* llr;
  int n, m, z, mb_n, nb_n, dc, dv, n_edges;
  const int* tables;
  int max_iters;
  float alpha, beta;
  int* errors;
  int* iters;
  int* success;
};

// The shared-memory planes of one word (see the layout above).
template <typename S>
struct Planes {
  const int* row_deg;
  const int* row_base;
  const int* row_nb;
  const int* row_shift;
  const int* col_deg;
  const int* col_mb;
  const int* col_d;
  const int* col_shift;
  uint32_t* bits;
  S* m1;     // sum-product: S
  S* m2;     // sum-product: the sign product
  S* am;     // sum-product: the phi stash
  S* sp;     // min-sum family, unless popcount_sign
  S* chan;
  S* tot;
  // layered: the new state of the row being updated (f32, unrounded)
  uint32_t* rbits;
  float* rm1;
  float* rm2;
  float* ram;
  float* rsp;
};

// Min-sum family: the new compressed state of check c from the current
// totals and the check's old state (`_row_stats`).  The new sign words go
// to out_bits (flooding: in place; an old word is read before its new one
// is written); returns the parity of the check's totals.
template <int K, typename S, bool kWide, bool kPop>
__device__ __forceinline__ int row_stats(const Planes<S>& p, const Args& a,
                                         int c, int n_sw, uint32_t* out_bits,
                                         float& n1, float& n2, float& nam,
                                         float& nsp) {
  const int mb = c / a.z;
  const int i = c - mb * a.z;
  const float o1 = ld(p.m1[c]);
  const float o2 = ld(p.m2[c]);
  const float oam = ld_raw(p.am[c]);
  const uint32_t* cbits = p.bits + c * n_sw;
  const float osp = kPop ? parity_sign<kWide>(cbits, n_sw) : ld(p.sp[c]);
  n1 = kBig;
  n2 = kBig;
  nam = 0.f;
  nsp = 1.f;
  int par = 0;
  const int deg = p.row_deg[mb];
  const int* rnb = p.row_nb + mb * a.dc;
  const int* rsh = p.row_shift + mb * a.dc;
  for (int d0 = 0; d0 < deg; d0 += 32) {
    const uint32_t ob = cbits[d0 >> 5];
    uint32_t nbits = 0u;
    const int dend = kWide ? min(deg, d0 + 32) : deg;
    for (int d = d0; d < dend; ++d) {
      const int r = d - d0;
      int j = i + rsh[d];
      if (j >= a.z) j -= a.z;
      const float t = ld(p.tot[rnb[d] * a.z + j]);
      par ^= t < 0.f;
      const float mag = (oam == static_cast<float>(d)) ? o2 : o1;
      const float v = t - osp * bit_sign(ob, r) * adjust<K>(mag, a.alpha,
                                                            a.beta);
      const float av = fabsf(v);
      const bool newmin = av < n1;
      n2 = newmin ? n1 : fminf(n2, av);
      nam = newmin ? static_cast<float>(d) : nam;
      n1 = fminf(n1, av);
      const bool neg = v < 0.f;
      nbits |= static_cast<uint32_t>(neg) << r;
      if (!kPop) nsp = neg ? -nsp : nsp;
    }
    out_bits[d0 >> 5] = nbits;
  }
  if (kPop) nsp = parity_sign<kWide>(out_bits, n_sw);
  return par;
}

// Sum-product phase A for check c (`_row_pass_sp`); returns its parity.
template <typename S, bool kWide>
__device__ __forceinline__ int row_pass_sp(const Planes<S>& p, const Args& a,
                                           int c, int n_sw) {
  const int mb = c / a.z;
  const int i = c - mb * a.z;
  const float o1 = ld(p.m1[c]);                // S
  const float osp = ld(p.m2[c]);               // the sign product
  uint32_t* cbits = p.bits + c * n_sw;
  float n1 = 0.f, nsp = 1.f;
  int par = 0;
  const int deg = p.row_deg[mb];
  const int* rnb = p.row_nb + mb * a.dc;
  const int* rsh = p.row_shift + mb * a.dc;
  S* stash = p.am + p.row_base[mb] * a.z + i;
  for (int d0 = 0; d0 < deg; d0 += 32) {
    const uint32_t ob = cbits[d0 >> 5];
    uint32_t nbits = 0u;
    const int dend = kWide ? min(deg, d0 + 32) : deg;
    for (int d = d0; d < dend; ++d) {
      const int r = d - d0;
      int j = i + rsh[d];
      if (j >= a.z) j -= a.z;
      const float t = ld(p.tot[rnb[d] * a.z + j]);
      par ^= t < 0.f;
      const float sgn = osp * bit_sign(ob, r);
      const float v = t - sgn * phi(clip_phi(o1 - ld(stash[d * a.z])));
      const float ph = phi(clip_phi(fabsf(v)));
      stash[d * a.z] = st<S>(ph);
      n1 = n1 + ph;
      const bool neg = v < 0.f;
      nbits |= static_cast<uint32_t>(neg) << r;
      nsp = neg ? -nsp : nsp;
    }
    cbits[d0 >> 5] = nbits;
  }
  p.m1[c] = st<S>(n1);
  p.m2[c] = st<S>(nsp);
  return par;
}

// The c2v message of slot d of check c from its stored state (`_recon`).
template <int K, typename S, bool kWide, bool kPop>
__device__ __forceinline__ float stored_message(const Planes<S>& p,
                                                const Args& a, int c, int d,
                                                int n_sw) {
  const uint32_t* cbits = p.bits + c * n_sw;
  const uint32_t word = kWide ? cbits[d >> 5] : cbits[0];
  const float sgn = (kPop ? parity_sign<kWide>(cbits, n_sw) : ld(p.sp[c])) *
                    bit_sign(word, d & 31);
  const float mag = (ld_raw(p.am[c]) == static_cast<float>(d)) ? ld(p.m2[c])
                                                               : ld(p.m1[c]);
  return sgn * adjust<K>(mag, a.alpha, a.beta);
}

// kWide: check degree above 32, ceil(dc/32) sign words per check; without
// it the one-word layout compiles to the single-word code.  kPop is a
// template parameter, not a flag of the launch: as a flag it halved the
// instances and the build time, but made the near-earth popcount decode 3%
// slower on an H100 (kernel_ab.py).
template <int K, typename S, bool kWide, bool kLayered, bool kPop>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  constexpr bool kSp = K == kSumProduct;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_errors;
  const int n = a.n, m = a.m, z = a.z;
  const int n_tab = table_ints(a.mb_n, a.nb_n, a.dc, a.dv);
  const int n_sw = kWide ? sign_words(a.dc) : 1;
  int* tab = reinterpret_cast<int*>(smem);
  Planes<S> p;
  p.row_deg = tab;
  p.row_base = p.row_deg + a.mb_n;
  p.row_nb = p.row_base + a.mb_n;
  p.row_shift = p.row_nb + a.mb_n * a.dc;
  p.col_deg = p.row_shift + a.mb_n * a.dc;
  p.col_mb = p.col_deg + a.nb_n;
  p.col_d = p.col_mb + a.nb_n * a.dv;
  p.col_shift = p.col_d + a.nb_n * a.dv;
  p.bits = reinterpret_cast<uint32_t*>(tab + n_tab);
  p.rbits = p.bits + m * n_sw;
  p.rm1 = reinterpret_cast<float*>(p.rbits + (kLayered ? z * n_sw : 0));
  p.rm2 = p.rm1 + z;
  p.ram = p.rm2 + z;
  p.rsp = p.ram + z;
  // min-sum family: m1 | m2 | am | sp (unless kPop); sum-product: S (in
  // m1) | sp (in m2) | stash (in am)
  p.m1 = reinterpret_cast<S*>(kLayered ? p.rsp + z
                                       : reinterpret_cast<float*>(p.rbits));
  p.m2 = p.m1 + m;
  p.am = p.m2 + m;
  p.sp = (kSp || kPop) ? nullptr : p.am + m;
  p.chan = kSp ? p.am + a.n_edges * z : p.am + (kPop ? m : 2 * m);
  p.tot = p.chan + n;

  const int tid = threadIdx.x;
  const int word = blockIdx.x;
  for (int k = tid; k < n_tab; k += kThreads) tab[k] = a.tables[k];
  const float* in = a.llr + static_cast<size_t>(word) * n;
  for (int v = tid; v < n; v += kThreads) {
    float x = in[v];
    x = isnan(x) ? 0.f : fminf(fmaxf(x, -kLlrClip), kLlrClip);
    const S c = st<S>(x);
    p.chan[v] = c;
    p.tot[v] = st<S>(-ld(c));   // decoders negate on entry
  }
  for (int k = tid; k < m * n_sw; k += kThreads) p.bits[k] = 0u;
  for (int c = tid; c < m; c += kThreads) {
    if (kSp) {
      p.m1[c] = st<S>(kPhiMax);   // S = 38 with a 0 stash rebuilds c2v == 0
      p.m2[c] = st<S>(1.f);
    } else {
      p.m1[c] = st<S>(0.f);       // rebuilt c2v == 0 on the first iteration
      p.m2[c] = st<S>(0.f);
      p.am[c] = st_raw<S>(0.f);
      if (!kPop) p.sp[c] = st<S>(1.f);
    }
  }
  if (kSp) {
    for (int k = tid; k < a.n_edges * z; k += kThreads) p.am[k] = st<S>(0.f);
  }
  if (tid == 0) s_errors = 0;
  __syncthreads();

  int it_done = a.max_iters;
  int ok = 0;
  for (int it = 0;; ++it) {
    int bad = 0;
    if (kLayered) {
      // ---- syndrome of the totals at the start of the sweep ----
      for (int c = tid; c < m; c += kThreads) {
        const int mb = c / z;
        const int i = c - mb * z;
        const int deg = p.row_deg[mb];
        const int* rnb = p.row_nb + mb * a.dc;
        const int* rsh = p.row_shift + mb * a.dc;
        int par = 0;
        for (int d = 0; d < deg; ++d) {
          int j = i + rsh[d];
          if (j >= z) j -= z;
          par ^= ld(p.tot[rnb[d] * z + j]) < 0.f;
        }
        bad |= par;
      }
    } else {
      // ---- phase A: syndrome of the current totals + new check state ----
      for (int c = tid; c < m; c += kThreads) {
        if (kSp) {
          bad |= row_pass_sp<S, kWide>(p, a, c, n_sw);
        } else {
          float n1, n2, nam, nsp;
          bad |= row_stats<K, S, kWide, kPop>(p, a, c, n_sw,
                                              p.bits + c * n_sw, n1, n2, nam,
                                              nsp);
          p.m1[c] = st<S>(n1);
          p.m2[c] = st<S>(n2);
          p.am[c] = st_raw<S>(nam);
          if (!kPop) p.sp[c] = st<S>(nsp);
        }
      }
    }
    if (!__syncthreads_or(bad)) {
      ok = 1;
      it_done = it;
      break;
    }
    if (it == a.max_iters) break;
    if (kLayered) {
      // ---- block row by block row: new state, then the deltas ----
      for (int mb = 0; mb < a.mb_n; ++mb) {
        // (a) the row's new state into the row scratch
        for (int i = tid; i < z; i += kThreads) {
          float n1, n2, nam, nsp;
          row_stats<K, S, kWide, kPop>(p, a, mb * z + i, n_sw,
                                       p.rbits + i * n_sw, n1, n2, nam, nsp);
          p.rm1[i] = n1;
          p.rm2[i] = n2;
          p.ram[i] = nam;
          p.rsp[i] = nsp;
        }
        __syncthreads();
        // (c) totals += new c2v - old c2v, edge by edge in slot order; a
        // thread owns one variable of one block column of the row
        const int deg = p.row_deg[mb];
        const int* rnb = p.row_nb + mb * a.dc;
        const int* rsh = p.row_shift + mb * a.dc;
        for (int k = tid; k < deg * z; k += kThreads) {
          const int d0 = k / z;
          const int j = k - d0 * z;
          const int nb = rnb[d0];
          if (d0 > 0 && rnb[d0 - 1] == nb) continue;  // not the block's first
          const int v = nb * z + j;
          float t = ld(p.tot[v]);
          for (int d = d0; d < deg && rnb[d] == nb; ++d) {
            int i = j - rsh[d];
            if (i < 0) i += z;
            const uint32_t* nbits = p.rbits + i * n_sw;
            const float nmag =
                (p.ram[i] == static_cast<float>(d)) ? p.rm2[i] : p.rm1[i];
            const float cn =
                p.rsp[i] * bit_sign(kWide ? nbits[d >> 5] : nbits[0], d & 31) *
                adjust<K>(nmag, a.alpha, a.beta);
            const float co =
                stored_message<K, S, kWide, kPop>(p, a, mb * z + i, d, n_sw);
            t = ld(st<S>(__fadd_rn(t, __fsub_rn(cn, co))));
          }
          p.tot[v] = st<S>(t);
        }
        __syncthreads();
        // (d) round the new state into the row's planes
        for (int i = tid; i < z; i += kThreads) {
          const int c = mb * z + i;
          p.m1[c] = st<S>(p.rm1[i]);
          p.m2[c] = st<S>(p.rm2[i]);
          p.am[c] = st_raw<S>(p.ram[i]);
          if (!kPop) p.sp[c] = st<S>(p.rsp[i]);
          for (int w = 0; w < n_sw; ++w) {
            p.bits[c * n_sw + w] = p.rbits[i * n_sw + w];
          }
        }
      }
      continue;
    }
    // ---- phase B: totals = -chan + sum of the rebuilt c2v messages ----
    for (int v = tid; v < n; v += kThreads) {
      const int nb = v / z;
      const int j = v - nb * z;
      float acc = -ld(p.chan[v]);
      const int deg = p.col_deg[nb];
      for (int k = 0; k < deg; ++k) {
        const int e = nb * a.dv + k;
        const int d = p.col_d[e];
        int i = j - p.col_shift[e];
        if (i < 0) i += z;
        const int cmb = p.col_mb[e];
        const int c = cmb * z + i;
        float msg;
        if (kSp) {
          const uint32_t w =
              kWide ? p.bits[c * n_sw + (d >> 5)] : p.bits[c];
          msg = ld(p.m2[c]) * bit_sign(w, d & 31) *
                phi(clip_phi(ld(p.m1[c]) -
                             ld(p.am[(p.row_base[cmb] + d) * z + i])));
        } else {
          msg = stored_message<K, S, kWide, kPop>(p, a, c, d, n_sw);
        }
        acc = acc + msg;
      }
      p.tot[v] = st<S>(acc);
    }
    __syncthreads();
  }

  // errors against the all-zero word, from the latched state's totals
  int cnt = 0;
  for (int v = tid; v < n; v += kThreads) cnt += ld(p.tot[v]) < 0.f;
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if ((tid & 31) == 0) atomicAdd(&s_errors, cnt);
  __syncthreads();
  if (tid == 0) {
    a.errors[word] = s_errors;
    a.iters[word] = it_done;
    a.success[word] = ok;
  }
}

template <int K, typename S, bool kLayered, bool kPop>
long long smem_bytes(const Args& a) {
  const long long sw = sign_words(a.dc);
  const long long planes =
      K == kSumProduct ? 2LL * a.m + 1LL * a.n_edges * a.z + 2LL * a.n
                       : (kPop ? 3LL : 4LL) * a.m + 2LL * a.n;
  const long long row = kLayered ? 1LL * a.z * (sw + 4) : 0;
  return 4LL * (table_ints(a.mb_n, a.nb_n, a.dc, a.dv) + a.m * sw + row) +
         static_cast<long long>(sizeof(S)) * planes;
}

template <int K, typename S, bool kLayered, bool kPop>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const long long smem = smem_bytes<K, S, kLayered, kPop>(a);
  const auto kernel = a.dc > 32 ? decode_kernel<K, S, true, kLayered, kPop>
                                : decode_kernel<K, S, false, kLayered, kPop>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, static_cast<size_t>(smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Sum-product: flooding, float stores, stored sign only.
template <int K, typename S>
int launch_schedule(int layered, int popcount, const Args& a, int batch,
                    cudaStream_t stream) {
  if constexpr (K == kSumProduct) {
    if (layered || popcount) return static_cast<int>(cudaErrorInvalidValue);
    return launch<K, S, false, false>(a, batch, stream);
  } else {
    if (layered) {
      return popcount ? launch<K, S, true, true>(a, batch, stream)
                      : launch<K, S, true, false>(a, batch, stream);
    }
    return popcount ? launch<K, S, false, true>(a, batch, stream)
                    : launch<K, S, false, false>(a, batch, stream);
  }
}

template <int K>
int launch_store(int store, int layered, int popcount, const Args& a,
                 int batch, cudaStream_t stream) {
  if (store == 0)
    return launch_schedule<K, __nv_bfloat16>(layered, popcount, a, batch,
                                             stream);
  if (store == 1)
    return launch_schedule<K, float>(layered, popcount, a, batch, stream);
  if constexpr (K != kSumProduct) {
    if (store == 2)
      return launch_schedule<K, int8_t>(layered, popcount, a, batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  kind: 0 min-sum, 1 normalized, 2 offset, 3 sum-product;
// store: 0 bfloat16, 1 float32, 2 int8 (min-sum family); schedule: 0
// flooding, 1 layered (min-sum family); popcount: 0 stored sign product, 1
// folded from the sign bits (min-sum family).  All pointers are device
// pointers; nothing is allocated here.
int decode_launch(int kind, int store, int schedule, int popcount,
                    const float* llr, int batch, int n, int m, int z,
                    int mb_n, int nb_n, int dc, int dv, int n_edges,
                    const int* tables, int max_iters, float alpha,
                    float beta, int* errors, int* iters, int* success,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{llr,    n,         m,     z,     mb_n,  nb_n,
               dc,     dv,        n_edges, tables, max_iters,
               alpha,  beta,      errors, iters, success};
  switch (kind) {
    case kMinSum:
      return launch_store<kMinSum>(store, schedule, popcount, a, batch, s);
    case kNormalized:
      return launch_store<kNormalized>(store, schedule, popcount, a, batch,
                                       s);
    case kOffset:
      return launch_store<kOffset>(store, schedule, popcount, a, batch, s);
    case kSumProduct:
      return launch_store<kSumProduct>(store, schedule, popcount, a, batch,
                                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
