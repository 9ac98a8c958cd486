// The phase-split min-sum decoder: two kernels an iteration, with every
// word's compressed check state in device memory between them.
//
// Replaces the Pallas TPU kernels of ldpc_tpu/ops/pallas_split.py:
//   split_r  `kernel_r` (phase A and the latches): for each check, across its
//            row edges in nb-sorted slot order, v = totals[(i + s) mod z] -
//            recon(old state, d) folds into parity, min1/min2/argmin, the
//            sign bits and the sign product; the new state is rounded to the
//            store.  Then per word the latches, check BEFORE update: a word
//            whose checks all hold gets iterations = it and success = 1.
//   split_c  `kernel_c` (phase B): for each variable, tot = -chan, then
//            += recon(state, d) of each column edge, in column-edge order
//            (ascending block row, then slot), rounded to the store.
// The latches' error count is the count of totals < 0 among the totals
// that split_r's fold reads: split_c counts the totals it writes (the ones
// the next split_r reads) and stores the count as the word's errors, and
// split_r counts them itself only at iteration 0, whose totals (-chan) no
// split_c wrote.  A latched word's errors are thus those of the totals it
// latched on, as in the Pallas pair.  The host loop (ops/cuda_split.py)
// runs split_r for it = 0..max_iters and split_c after each but the last;
// it enqueues iteration it + 1 before it reads iteration it's count of
// latched words, and stops when that count is the batch (the iteration
// run past it finds every word latched).  Min-sum flooding, bfloat16 or
// float32 state, as the Pallas pair.
//
// Layout: word-major.  Each array is [B, ...] with one word's values
// contiguous: totals and channel [B, n] Store; one 16-byte record a check
// [B, m] (below); the sign words past the first [B, m, ceil(dc/32) - 1]
// uint32 (check degree > 32); the latches [B] int32.  The record is the
// fused kernel's (decode.cu Rec32), in both stores: sign word 0 | m1 | m2 |
// the argmin (a slot index), m1 and m2 as the float32 bits of the store's
// values (a bf16 value is one exactly) with bit 31 set where the sign
// product is -1.  One vector load brings a check's whole state, and a
// message is the picked word with its sign bit flipped by the edge's sign
// bit.  Eight bytes do not hold it in bf16: at check degree 32
// (near-earth) the sign bits, two 15-bit magnitudes and a 5-bit argmin are
// 67 bits, so bf16 and f32 share the 16 bytes.
//
// One 256-thread block owns one word in each kernel, so the latches' sums
// over a word's checks and variables are block reductions, with no atomics
// on them and no third pass.  split_r gives a thread kChecks = 2 checks of
// one block row (i0 and i0 + ceil(z/2)); split_c gives it kVars = 8
// variables of one block column (j0 + q * ceil(z/8)).  Consecutive threads
// take consecutive checks or variables, so the record, channel and total
// accesses are coalesced, and the (i + s) mod z reads are too, but at the
// wrap.  The edge tables are packed on the host (ops/cuda_split.py::
// split_tables) with byte offsets and wrap thresholds, and read from
// device memory with __ldg: all lanes of a warp read one entry (a
// broadcast from L1), and an entry serves the thread's two checks or eight
// variables, so no edge loads a table entry of its own and no check or
// variable divides by z.  Where a word's totals (split_r) or records
// (split_c) fit in kStageBytes of shared memory (near-earth: 16 KB of
// totals in bf16, 32 KB in f32, 16 KB of records; synthetic_qc_code(2048,
// 8, 24): 96 KB of totals in bf16), the block first copies them there with
// 16-byte loads and the edge loops read shared memory; larger ones (that
// code's 192 KB of totals in f32 and 256 KB of records) are read from
// device memory through L1.  The launch picks the instance by the code's
// size.  (Staging the giant code's bf16 totals, past the 48 KB that needs
// no opt-in, made its decode faster on the H100: PERF.md.)  The TPU's
// word-minor layout [planes, z, B] (words across the lanes) coalesces
// across words instead; tried as 32 words a block (lane = word, 8 warps
// over the checks or the variables, the per-word sums through shared
// memory), it decoded the near-earth stage-1 shape (32,768 words, 12
// iterations, 3.4 dB) 3-4x slower than word-major planes (kernel_ab.py,
// H100 80GB HBM3 at 700 W): a block of 32 words reads 32 words' totals
// (512 KB for near-earth), more than an SM's L1, and each word's checks
// run on one lane.  These are plain kernels: no wgmma, no
// TMA.
//
// What bounds them on an H100: each launch moves a live word's state once
// each way (near-earth bf16: split_r 49,068 bytes a word, split_c 49,060),
// against 8 (split_r) and 3 (split_c) float32 operations per edge: at
// 32,768 live words about 0.48 ms of HBM time each against 0.13 and 0.05 ms
// of arithmetic, so bytes.  On the card they stay well above it (PERF.md):
// split_r's fold issues 24 SASS instructions an edge in bf16
// (ldpc_tpu_torch/scripts/edge_sass.py --split), and both kernels wait on
// their loads.  So a group's old records (split_r) and channel values
// (split_c) are loaded one group ahead, the first group's before the
// staging; and the fold pins each check's unpacked record in registers
// (pin): without it the compiler unpacked it again, and recomputed the
// wrap's offsets, on every slot (28 instructions an edge).
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
//     magnitude: its sign bit set, an exact product);
//   - a new minimum needs a strict <; the argmin is the slot index d;
//   - a sign word has bit d % 32 set through uint32;
//   - do not build with --use_fast_math.
// Non-finite LLRs are not sanitised, as in the Pallas pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// checks of one block row a split_r thread folds (4: more registers and
// slower), variables of one block column a split_c thread sums (4: slower
// on the H100, PERF.md)
constexpr int kChecks = 2;
constexpr int kVars = 8;
constexpr int kRecord = 16;  // bytes of a check's record
// a word's totals (split_r) or records (split_c) up to this size are staged
// in shared memory (above 48 KB the launch opts in): two blocks an SM at
// the giant code's 96 KB of bf16 totals
constexpr long long kStageBytes = 100 * 1024;
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

__device__ __forceinline__ uint32_t parity(uint32_t x) {
  return static_cast<uint32_t>(__popc(x)) & 1u;
}

// acc |= mask where x < 0 (false for -0 and NaN): a compare and a
// predicated or, where the compiler's own code adds a select
__device__ __forceinline__ void or_if_negative(uint32_t& acc, float x,
                                               uint32_t mask) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, 0f00000000;\n\t"
      "@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(acc)
      : "f"(x), "r"(mask));
#else
  if (x < 0.f) acc |= mask;
#endif
}

// acc ^= 1 where x < 0, likewise
__device__ __forceinline__ void flip_if_negative(uint32_t& acc, float x) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\tsetp.lt.f32 p, %1, 0f00000000;\n\t"
      "@p xor.b32 %0, %0, 1;\n\t}"
      : "+r"(acc)
      : "f"(x));
#else
  if (x < 0.f) acc ^= 1u;
#endif
}

// x (a magnitude, sign bit clear) negated where bit 31 of s is set: the
// product by +-1, exactly
__device__ __forceinline__ float with_sign(float x, uint32_t s) {
  return __uint_as_float(__float_as_uint(x) ^ (s & 0x80000000u));
}

// Keep x in a register through a loop: the compiler may not recompute it
// from its inputs on every pass
__device__ __forceinline__ void pin(int& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#endif
}

__device__ __forceinline__ void pin(uint32_t& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(x));
#endif
}

__device__ __forceinline__ void pin(float& x) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+f"(x));
#endif
}

__device__ __forceinline__ float magnitude(uint32_t bits) {
  return __uint_as_float(bits & 0x7fffffffu);
}

// The record of a check's new state: m1 and m2 rounded to the store, with
// the sign product's bit
template <typename S>
__device__ __forceinline__ uint4 pack(uint32_t w0, float n1, float n2, int am,
                                      uint32_t neg) {
  return make_uint4(w0, __float_as_uint(ld(st<S>(n1))) | (neg << 31),
                    __float_as_uint(ld(st<S>(n2))) | (neg << 31),
                    static_cast<uint32_t>(am));
}

// The edge tables (ops/cuda_split.py::split_tables), one int32 array:
//   ctab[nb_n * dv] int4   per (block column, column slot): the byte offset
//                          of the record of check (mb * z - s) (variable
//                          j = 0 reaches check j - s, plus z where j < s),
//                          the wrap threshold s * 16, the row slot d, and
//                          31 - d % 32 (the shift that brings bit d % 32
//                          of its sign word to bit 31)
//   rtab[mb_n * dc] int2   per (block row, slot): the byte offset of the
//                          total of variable nb * z + s (check i = 0
//                          reaches variable i + s, less z where i >= z - s)
//                          and the wrap threshold (z - s) * sizeof(Store)
//   row_deg[mb_n], col_deg[nb_n]
struct Geometry {
  int n, m, z, mb_n, nb_n, dc, dv;
  const int4* ctab;
  const int2* rtab;
  const int* row_deg;
  const int* col_deg;
};

template <typename S>
struct State {
  const S* chan;
  S* tot;
  uint4* rec;
  uint32_t* xbits;   // check degree > 32: sign words 1.. of each check
  int* errors;
  int* iters;
  int* success;
  int* n_ok;   // [max_iters + 1]: words latched after split_r of iteration it
};

// Copy count values of T from device to shared memory, the block's threads
// in turn.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int count) {
  for (int k = threadIdx.x; k < count; k += kThreads) dst[k] = src[k];
}

template <typename S, bool kStaged>
__device__ __forceinline__ float total(const unsigned char* base, int off) {
  const S* p = reinterpret_cast<const S*>(base + off);
  return ld(kStaged ? *p : __ldg(p));
}

template <bool kStaged>
__device__ __forceinline__ uint4 record(const unsigned char* base, int off) {
  const uint4* p = reinterpret_cast<const uint4*>(base + off);
  return kStaged ? *p : __ldg(p);
}

// The records of a split_r thread's group of checks (mb, i0 + q * h) (past
// z: i0's again), or nothing past the last block row.
template <int kC>
__device__ __forceinline__ void load_checks(uint4 (&r)[kC], const uint4* rec,
                                            int mb, int i0, int h, int z,
                                            int mb_n) {
  if (mb >= mb_n) return;
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const int iq = i0 + q * h;
    r[q] = rec[mb * z + (iq < z ? iq : i0)];
  }
}

// The channel values of a split_c thread's group of variables (nb, j0 + q *
// h) (past z: j0's again), or nothing past the last block column.
template <typename S, int kV>
__device__ __forceinline__ void load_vars(S (&x)[kV], const S* chan, int nb,
                                          int j0, int h, int z, int nb_n) {
  if (nb >= nb_n) return;
#pragma unroll
  for (int q = 0; q < kV; ++q) {
    const int jq = j0 + q * h;
    x[q] = chan[nb * z + (jq < z ? jq : j0)];
  }
}

// The next group of a thread whose groups are (row, i0) pairs, i0 < h,
// numbered across rows, kThreads apart.
__device__ __forceinline__ void next_group(int& row, int& i0, int h) {
  i0 += kThreads;
  while (i0 >= h) {
    i0 -= h;
    ++row;
  }
}

// A block's sum of one int a thread; every thread must call it.  Ends with
// a barrier, whose result thread 0 reads (others get their own warp's sum).
__device__ __forceinline__ int block_sum(int x, int* s_warp) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) x += s_warp[w];
  }
  return x;
}

// kWide: check degree above 32, ceil(dc/32) sign words per check.
// kStaged: the word's totals are copied into shared memory first.
template <typename S, bool kWide, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    split_r(const Geometry g, const State<S> s, const int it) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  const int word = blockIdx.x;
  const int tid = threadIdx.x;
  if (s.success[word]) {   // latched: nothing to do but be counted
    if (tid == 0) atomicAdd(s.n_ok + it, 1);
    return;
  }
  constexpr int sz = sizeof(S);
  const int z = g.z;
  uint4* rec = s.rec + static_cast<size_t>(word) * g.m;
  const int h = (z + kChecks - 1) / kChecks;
  int mb = tid / h;
  int i0 = tid - mb * h;
  // a group's old records are loaded a group ahead (the first group's
  // before the staging), so that their latency overlaps the work before
  uint4 next[kChecks];
  load_checks(next, rec, mb, i0, h, z, g.mb_n);
  const S* gtot = s.tot + static_cast<size_t>(word) * g.n;
  if (kStaged) {
    if ((g.n * sz) % 16 == 0) {
      stage(reinterpret_cast<uint4*>(smem),
            reinterpret_cast<const uint4*>(gtot), g.n * sz / 16);
    } else {
      stage(reinterpret_cast<S*>(smem), gtot, g.n);
    }
    __syncthreads();
  }
  const unsigned char* tb =
      kStaged ? smem : reinterpret_cast<const unsigned char*>(gtot);
  int cnt = 0;
  if (it == 0) {   // iteration 0's totals, -chan: no split_c counted them
    for (int v = tid; v < g.n; v += kThreads) {
      cnt += total<S, kStaged>(tb, v * sz) < 0.f;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
  }
  const int n_x = kWide ? (g.dc + 31) / 32 - 1 : 0;
  uint32_t* xw = s.xbits + static_cast<size_t>(word) * g.m * n_x;
  uint32_t bad = 0u;
  while (mb < g.mb_n) {
    uint4 cur[kChecks];
#pragma unroll
    for (int q = 0; q < kChecks; ++q) cur[q] = next[q];
    int nmb = mb, ni0 = i0;
    next_group(nmb, ni0, h);
    load_checks(next, rec, nmb, ni0, h, z, g.mb_n);
    int c[kChecks], ib[kChecks], ibw[kChecks], oam[kChecks], nam[kChecks];
    float o1[kChecks], o2[kChecks], n1[kChecks], n2[kChecks];
    uint32_t flip[kChecks], ow[kChecks], px[kChecks], w0[kChecks],
        par[kChecks];
#pragma unroll
    for (int q = 0; q < kChecks; ++q) {
      const int iq = i0 + q * h;
      const int i = iq < z ? iq : i0;   // past z: i0 again, not written
      c[q] = mb * z + i;
      ib[q] = i * sz;
      ibw[q] = (i - z) * sz;   // past the wrap
      const uint4 r = cur[q];
      o1[q] = magnitude(r.y);
      o2[q] = magnitude(r.z);
      oam[q] = static_cast<int>(r.w);
      flip[q] = static_cast<uint32_t>(static_cast<int32_t>(r.y) >> 31);
      ow[q] = r.x ^ flip[q];   // bit d: the sign of slot d's old message
      px[q] = 0u;
      par[q] = 0u;
      n1[q] = kBig;
      n2[q] = kBig;
      nam[q] = 0;
      w0[q] = 0u;
    }
    const int deg = __ldg(g.row_deg + mb);
    const int2* rt = g.rtab + mb * g.dc;
    const int passes = kWide ? (deg + 31) >> 5 : 1;
    for (int w = 0; w < passes; ++w) {
      const int d0 = 32 * w;
      if (kWide && w > 0) {
#pragma unroll
        for (int q = 0; q < kChecks; ++q) {
          ow[q] = xw[c[q] * n_x + w - 1] ^ flip[q];
        }
      }
      uint32_t nbits[kChecks];
#pragma unroll
      for (int q = 0; q < kChecks; ++q) nbits[q] = 0u;
      const int dend = kWide ? min(deg, d0 + 32) : deg;
      const int2* e = rt + d0;
      for (int d = d0; d < dend; ++d, ++e) {
#pragma unroll
        for (int q = 0; q < kChecks; ++q) {
          pin(ib[q]);
          pin(ibw[q]);
          pin(ow[q]);
          pin(o1[q]);
          pin(o2[q]);
          pin(oam[q]);
        }
        const int2 t = __ldg(e);
        // the total of check 0's edge; check i's is i further, less z
        // past the wrap
        const unsigned char* base = tb + t.x;
        const int r = d - d0;
#pragma unroll
        for (int q = 0; q < kChecks; ++q) {
          const float tv =
              total<S, kStaged>(base, ib[q] >= t.y ? ibw[q] : ib[q]);
          flip_if_negative(par[q], tv);
          const float mag = oam[q] == d ? o2[q] : o1[q];
          const float v = tv - with_sign(mag, ow[q] << (31 - r));
          const float av = fabsf(v);
          const bool newmin = av < n1[q];
          n2[q] = newmin ? n1[q] : fminf(n2[q], av);
          nam[q] = newmin ? d : nam[q];
          n1[q] = fminf(n1[q], av);
          or_if_negative(nbits[q], v, 1u << r);
        }
      }
#pragma unroll
      for (int q = 0; q < kChecks; ++q) {
        px[q] ^= nbits[q];
        if (!kWide || w == 0) {
          w0[q] = nbits[q];
        } else if (i0 + q * h < z) {
          xw[c[q] * n_x + w - 1] = nbits[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChecks; ++q) {
      bad |= par[q];
      if (i0 + q * h < z) {
        rec[c[q]] = pack<S>(w0[q], n1[q], n2[q], nam[q], parity(px[q]));
      }
    }
    mb = nmb;
    i0 = ni0;
  }
  if (it == 0 && (tid & 31) == 0) s_warp[tid >> 5] = cnt;
  const int any_bad = __syncthreads_or(static_cast<int>(bad));
  if (tid == 0) {
    if (it == 0) {
      int errors = 0;
      for (int w = 0; w < kWarps; ++w) errors += s_warp[w];
      s.errors[word] = errors;
    }
    if (!any_bad) {
      s.iters[word] = it;
      s.success[word] = 1;
      atomicAdd(s.n_ok + it, 1);
    }
  }
}

// kStaged: the word's records are copied into shared memory first.
template <typename S, bool kWide, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    split_c(const Geometry g, const State<S> s, int) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  const int word = blockIdx.x;
  if (s.success[word]) return;   // latched: its totals are never read again
  const int z = g.z;
  const S* chan = s.chan + static_cast<size_t>(word) * g.n;
  const int h = (z + kVars - 1) / kVars;
  int nb = threadIdx.x / h;
  int j0 = threadIdx.x - nb * h;
  // a group's channel values are loaded a group ahead (the first group's
  // before the staging)
  S next[kVars];
  load_vars(next, chan, nb, j0, h, z, g.nb_n);
  const uint4* grec = s.rec + static_cast<size_t>(word) * g.m;
  if (kStaged) {
    stage(reinterpret_cast<uint4*>(smem), grec, g.m);
    __syncthreads();
  }
  const unsigned char* rb =
      kStaged ? smem : reinterpret_cast<const unsigned char*>(grec);
  const int n_x = kWide ? (g.dc + 31) / 32 - 1 : 0;
  const uint32_t* xw = s.xbits + static_cast<size_t>(word) * g.m * n_x;
  S* tot = s.tot + static_cast<size_t>(word) * g.n;
  int cnt = 0;
  while (nb < g.nb_n) {
    int v[kVars], jr[kVars], jrw[kVars];
    float acc[kVars];
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      const int jq = j0 + q * h;
      const int j = jq < z ? jq : j0;   // past z: j0 again, not written
      v[q] = nb * z + j;
      jr[q] = j * kRecord;
      jrw[q] = (j + z) * kRecord;   // before the wrap
      acc[q] = -ld(next[q]);
    }
    int nnb = nb, nj0 = j0;
    next_group(nnb, nj0, h);
    load_vars(next, chan, nnb, nj0, h, z, g.nb_n);
    const int deg = __ldg(g.col_deg + nb);
    const int4* ct = g.ctab + nb * g.dv;
    for (int k = 0; k < deg; ++k, ++ct) {
      const int4 e = __ldg(ct);
      // the record of variable 0's check; variable j's is j further, plus
      // z before the wrap
      const unsigned char* base = rb + e.x;
#pragma unroll
      for (int q = 0; q < kVars; ++q) {
        const int off = jr[q] < e.y ? jrw[q] : jr[q];
        const uint4 r = record<kStaged>(base, off);
        const uint32_t sw =
            (kWide && e.z >= 32)
                ? __ldg(xw + ((e.x + off) / kRecord) * n_x + (e.z >> 5) - 1)
                : r.x;
        // m2 at the argmin, else m1, with the sign product's bit, flipped
        // by the edge's sign bit
        const uint32_t msg = (static_cast<int>(r.w) == e.z ? r.z : r.y) ^
                             ((sw << e.w) & 0x80000000u);
        acc[q] = __fadd_rn(acc[q], __uint_as_float(msg));
      }
    }
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      if (j0 + q * h < z) {
        const S t = st<S>(acc[q]);
        tot[v[q]] = t;
        cnt += ld(t) < 0.f;
      }
    }
    nb = nnb;
    j0 = nj0;
  }
  // the errors of the totals the next split_r reads
  cnt = block_sum(cnt, s_warp);
  if (threadIdx.x == 0) s.errors[word] = cnt;
}

template <typename S, bool kWide, bool kStaged>
int launch(int phase, const Geometry& g, const State<S>& s, int batch, int it,
           cudaStream_t stream) {
  const auto kernel = phase == 0 ? split_r<S, kWide, kStaged>
                                 : split_c<S, kWide, kStaged>;
  const size_t smem =
      !kStaged ? 0 : phase == 0 ? sizeof(S) * g.n : size_t{kRecord} * g.m;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch, kThreads, smem, stream>>>(g, s, it);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_store(int phase, const Geometry& g, const State<S>& s, int batch,
                 int it, cudaStream_t stream) {
  const long long bytes = phase == 0 ? static_cast<long long>(sizeof(S)) * g.n
                                     : static_cast<long long>(kRecord) * g.m;
  const bool staged = bytes <= kStageBytes;
  if (g.dc > 32) {
    return staged ? launch<S, true, true>(phase, g, s, batch, it, stream)
                  : launch<S, true, false>(phase, g, s, batch, it, stream);
  }
  return staged ? launch<S, false, true>(phase, g, s, batch, it, stream)
                : launch<S, false, false>(phase, g, s, batch, it, stream);
}

template <typename S>
State<S> state_of(const void* chan, void* tot, void* rec, void* xbits,
                  int* errors, int* iters, int* success, int* n_ok) {
  return State<S>{static_cast<const S*>(chan), static_cast<S*>(tot),
                  static_cast<uint4*>(rec), static_cast<uint32_t*>(xbits),
                  errors, iters, success, n_ok};
}

}  // namespace

extern "C" {

// Launch split_r (phase 0, iteration `it`) or split_c (phase 1) on `stream`
// over `batch` words; returns cudaGetLastError() (0 when the launch was
// accepted).  store: 0 bfloat16, 1 float32.  `tables` is split_tables' int32
// array; all pointers are device pointers to the arrays described above;
// nothing is allocated here.
int split_launch(int phase, int store, int batch, int n, int m, int z,
                 int mb_n, int nb_n, int dc, int dv, const int* tables,
                 const void* chan, void* tot, void* rec, void* xbits,
                 int* errors, int* iters, int* success, int* n_ok, int it,
                 void* stream) {
  if (batch <= 0) return 0;
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int4* ctab = reinterpret_cast<const int4*>(tables);
  const int2* rtab = reinterpret_cast<const int2*>(ctab + nb_n * dv);
  const int* row_deg = reinterpret_cast<const int*>(rtab + mb_n * dc);
  const Geometry g{n,    m,    z,    mb_n,    nb_n,
                   dc,   dv,   ctab, rtab,    row_deg,
                   row_deg + mb_n};
  if (store == 0) {
    return launch_store(phase, g,
                        state_of<__nv_bfloat16>(chan, tot, rec, xbits, errors,
                                                iters, success, n_ok),
                        batch, it, strm);
  }
  if (store == 1) {
    return launch_store(phase, g,
                        state_of<float>(chan, tot, rec, xbits, errors, iters,
                                        success, n_ok),
                        batch, it, strm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
