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
//   B3  schedule="layered" (`layered_body`): the syndrome of the totals at
//       the start of the sweep, the latches, then block row by block row
//       the new state from the current totals, each edge's delta (new c2v
//       - old c2v) added to the totals and rounded to the store, edge by
//       edge in row-slot order;
//   B4  kind="sum-product" (`_phi`, `_recon_sp`, `_row_pass_sp`): per check
//       the phi total S, the sign product and the packed edge signs, and one
//       stashed phi per (block edge, check);
//   B5  store_dtype int8 (`_st`/`_ld`/`_st_raw`): a value is stored as
//       clip(rint(x * 8), -127, 127) and loaded as q / 8 (Q4.3; the two-min
//       start saturates to 127); the argmin is the slot index unscaled;
//       the LLRs enter through the same quantizer.  Min-sum computes on
//       the Q4.3 integers themselves, which is exact (see Domain);
//   B6  popcount_sign (`_sign_from_bits`): the sign product is the parity
//       of the xor of the check's sign words, and none is stored.
// Contract of decode_counts there: per word (bit errors against the all-zero
// codeword, iterations, success), check BEFORE update, max_iters + 1 bodies,
// non-converged words report the state after exactly max_iters updates.
//
// What bounds each variant on an H100.  HBM traffic is the float32 LLRs in
// (4 bytes a bit) and 12 bytes a word out; all state stays in shared
// memory.  The min-sum family does about 11 float32 operations per Tanner
// edge and iteration under flooding (12 normalized, 13 offset) and about 16
// under the layered schedule (a syndrome pass, the row update, and two
// rebuilt messages, a subtract and an add per edge); sum-product at least
// 7 plus a phi (tanhf, logf) in phase A and 8 plus a phi in phase B.  By
// those counts every variant is bound by operations; on the card the edge
// loops are bound by the instructions they issue an edge: in the min-sum
// family those of the integer unit (compares, selects, logic, shifts,
// FMNMX; half the issue rate) and shared-memory accesses, so int8 keeps
// its arithmetic off the quarter-rate conversion unit; in sum-product
// phi's (ldpc_tpu_torch/scripts/edge_sass.py counts them).
//
// Why this layout.  The TPU kernel lays 128 words across the vector lanes
// and keeps their state in VMEM.  Here one block owns one word and keeps its
// whole state in shared memory (byte offsets in Layout, in this order):
//   edge tables        int32, as the host lays them out (below)
//   min-sum family, from a 16-byte boundary:
//     column table     flooding: int4 per (block column, column slot): the
//                      byte offset of the record of variable j = 0, the
//                      shift in record bytes, the row slot.  Layered, in
//                      its place, int4 per (block row, slot): the byte
//                      offsets of the record and of the scratch record of
//                      check i = 0 for variable j = 0 of the slot's block
//                      column (both less shift records), the wrap threshold
//                      shift * 16, the slot
//     check records    one per check, 16 bytes: sign word 0 | m1 | m2 |
//                      argmin (a slot index), with the sign product (unused
//                      with popcount_sign): bf16 and f32 keep the store's
//                      values as float32 bits, the sign product in bit 31;
//                      int8 the Q4.3 integers, negated where the sign
//                      product is -1
//     layered scratch  from a 16-byte boundary, z records of 16 bytes: the
//                      new state of the block row being updated, unrounded,
//                      in the f32 layout of the records (min-sum int8: the
//                      int8 layout, unclamped)
//     row table        int2 per (block row, slot): the byte offset of the
//                      total of check i = 0, and the wrap threshold
//                      (z - shift) * sizeof(Store)
//     layered blocks   int2 per (block row, block): the byte offset of the
//                      total of variable j = 0 of its block column, its
//                      slots d0 | d1 << 16; then int per block row: its
//                      block count
//     scratch words    layered, check degree > 32: z * (ceil(dc/32) - 1)
//                      uint32, the scratch's sign words past the first
//     sign words 1..   m * (ceil(dc/32) - 1) uint32 (check degree > 32)
//   sum-product, from a 16-byte boundary:
//     edge table       int4 per block edge e (block row, slot): the byte
//                      offset of the total of check i = 0's variable, the
//                      wrap threshold (z - shift) * sizeof(Store), the
//                      check of i = 0, the slot
//     column table     int4 per (block column, column slot): the byte
//                      offset of the plane's entry of variable j = 0 (less
//                      shift entries), the shift in entry bytes, the check
//                      of variable j = 0 less the shift
//     check records    8 bytes: sign word 0 with the sign product folded
//                      in (bit d: the sign of slot d's message), S (the
//                      store's value as float32 bits)
//     sign words 1..   m * (ceil(dc/32) - 1) uint32, likewise (dc > 32)
//     parity           m uint32: the parity of each check's totals
//     plane            n_edges * zp float32 (block edge e, check i at
//                      e*zp + i; zp = z rounded up to a multiple of 4, the
//                      entries past z padding): phi(|v|) with v's sign,
//                      then the message
//   chan, totals       n Store each (variable frame)
// Bytes per block (dynamic shared memory, tables included):
//                      near-earth        802.11n (n 1944)
//                      (n 8176, m 1022)  r1/2      r5/6
//   min-sum, bf16      51,952            32,448    17,056
//   min-sum, f32       84,656            40,224    24,832
//   min-sum, int8      35,600            28,560    13,168
//   layered            + 8,696           - 576     + 1,696
//   sum-product, bf16  179,448           58,064    42,928
//   sum-product, f32   212,152           65,840    50,704
// Near-earth min-sum leaves room for four blocks an SM in bf16 and six in
// int8 (registers allow fewer) and two in f32 (layered: three in bf16, two
// in f32); sum-product for one (slow, and right).
//
// The flooding loops of the min-sum family.  Phase A: a thread takes the
// checks i0 and i0 + h (h = ceil(z/2)) of one block row and folds both
// slot by slot; phase B: it takes the variables j0 + q*h (h = ceil(z/4),
// q < 4) of one block column and sums each one's messages.  A slot's table
// entry is thus loaded once for two checks or four variables, it is the same
// for every thread of a warp but where a warp straddles two block rows or
// columns, and it holds the address arithmetic, so a check's edge costs one
// 2-byte (bf16) load of a total and a variable's edge one vector load of a
// check record; the rotation into the check frame is the index (i + s) mod
// z, one compare and select.  802.11n (z 81, 12 block rows) still keeps all
// 256 threads busy: the (block row, i0) pairs are numbered across rows.
// A word leaves the loop as soon as all its checks are satisfied
// (__syncthreads_or): the TPU kernel's latches freeze a converged word, so
// per-word exit gives the same outputs as its per-tile exit, and no pad row
// is needed since z is indexed exactly.
//
// Sum-product.  A1: a thread takes the checks i0 + q*h (q < 4) of one
// block edge (the items numbered across block edges, so all 256 threads
// work where z is small; one edge-table entry for the four) and computes
// v = t - c2v from the total and the message kept from B1, and phi(|v|)
// into the plane with v's sign; A2: a thread per check sums S over its
// slots in row-slot order and gathers the sign words, the sign product and
// the parity of its totals; B1: per edge as A1, c2v = sgn * phi(S -
// stash) into the plane, the stash being the plane's phi(|v|) rounded to
// the store where B1 reads it; B2: a thread takes four variables of a
// block column and sums their messages in the column's order, as
// min-sum's phase B does, and a negative total flips a parity word of
// each of its checks (a shared atomic xor, in a branch that a word near
// convergence seldom takes; the entry totals' flips are made at entry).
// 2 phi an edge, not the TPU kernel's 3 (its phase A rebuilds the old
// message from the stored S, sign and stash, which phase B computed the
// iteration before), every phi on an edge item, and 4 barriers an
// iteration.
//
// The layered hazard.  A block of the base matrix may hold several shifts
// (near-earth: two in each), so two edges of one row reach the same
// variable, and the order in which their deltas are rounded into the totals
// decides the result.  The update of a block row therefore runs in steps
// with a barrier after each: (a) a thread folds checks i0 and i0 + h of the
// row (h = ceil(z/2); one check a thread where z <= 256, so that 802.11n's
// 81 checks keep 81 threads busy and not 41, and where the check degree is
// above 32) from the current totals and
// the old records, into one 16-byte scratch record each (f32, unrounded, as
// Pallas rebuilds the new messages from the unrounded fold); (c) a thread
// takes the variables j0 + q*ceil(z/4) (q < 4) of one block of the row and
// applies the block's edges in slot order, rounding the total after each:
// the total is loaded and stored once, each slot's table entry loaded once
// for the four, and an edge costs a vector load of the old record and one
// of the scratch record; (d) each check's scratch record is rounded into
// its record, by the thread that folded it, merged with the next row's (a)
// (the next sweep's row 0 after the last row), so no barrier lies between
// them.  The syndrome of the sweep's starting totals is row 0's fold's
// parity (row 0 folds first, before any delta) and a parity-only pass over
// rows 1.., two checks a thread on the row table, under one
// __syncthreads_or; a converged word drops the scratch.  The cost: 2
// barriers per block row; near-earth has 2 block rows of 16 blocks of two
// shifts, 802.11n rate 1/2 12 rows of 81 checks.
//
// Exactness against the JAX kernel and the plain PyTorch version
// (ldpc_tpu_torch/ops/cuda_static.py::flooding_reference and
// layered_reference):
//   - every state write rounds to the store type (__float2bfloat16_rn for
//     bf16, rintf, which rounds half to even as jnp.round does, for int8)
//     and every read widens to f32; arithmetic is f32;
//   - the argmin is the slot index d, exact in every store; the sign
//     product is +-1 as a bit, stored or (popcount_sign) the parity of the
//     check's sign words, and the same +-1 either way;
//   - a message is its rebuilt magnitude with the sign bit set where sign
//     product x edge sign is -1: the product by +-1, exactly;
//   - flooding phase B sums each variable as tot = -chan, then += in the
//     plan's column-edge order (ascending block row, then slot), never
//     reassociated; sum-product's S sums the new phi, unrounded, in
//     row-slot order (ascending block column), from +0, so that a phi of
//     -0 adds as +0 does; its kept message is the f32 value sgn * phi(S -
//     stash) that phase A rebuilds; the products sgn * x are by +-1 and exact,
//     so a contraction into an FMA changes nothing; the other products
//     (alpha) and the layered delta and total use __fmul_rn / __fsub_rn /
//     __fadd_rn, which are never contracted; do not build with
//     --use_fast_math;
//   - phi(x) = -logf(tanhf(x * 0.5f)): two rounded library calls, as
//     torch computes -torch.log(torch.tanh(x * 0.5)) on the card;
//   - a new minimum needs a strict <.
//
// Tables (int32, one array, staged into shared memory at block start; the
// min-sum family's packed tables are built from it there):
//   row_deg[mb_n] | row_base[mb_n] | row_nb[mb_n*dc] | row_shift[mb_n*dc] |
//   col_deg[nb_n] | col_mb[nb_n*dv] | col_d[nb_n*dv] | col_shift[nb_n*dv]
// Row slots d < row_deg[mb] are the plan's CN slots, in ascending block
// column (d is the sign bit and the argmin value); row_base[mb] is the index
// of the row's first block edge in the phi stash; column slots are in
// accumulation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// The checks of one block row that a thread folds together (flooding phase
// A, the layered parity pass, and the layered (a) where z > kThreads and
// the check degree is at most 32), and the variables of one block column
// that it sums together (flooding phase B, layered (c)); each edge-table
// entry is loaded once for all of them.
constexpr int kChecks = 2;
// The checks of one block edge that a thread of sum-product's edge steps
// (A1, B1) takes: four phi chains in flight, and the item's table entry
// and bookkeeping shared by four edges.
constexpr int kEdgeChecks = 4;
constexpr int kVars = 4;
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

// ---- the store types: st rounds an f32 into the store, ld widens it ----

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

// ---- the check record of the min-sum family: sign word 0, m1, m2 and the
// argmin (a slot index), with the sign product as a bit ----

template <typename S>
struct Rec;

// bf16 and f32: 16 bytes, word 0 | m1 | m2 | argmin, m1 and m2 as float32
// bits (a bf16 value is one exactly) with bit 31 set where the sign product
// is -1, so that a message is the picked word with one bit flipped
struct Rec32 {
  using V = uint4;
  static constexpr bool kSigned = true;
  __device__ static int am(const V& r) { return static_cast<int>(r.w); }
  // bit 31: the sign product is negative (the other bits are not a flag)
  __device__ static uint32_t negmask(const V& r) { return r.y; }
  // m2 where d is the argmin, else m1, with the sign product's bit
  __device__ static uint32_t pick(const V& r, int d) {
    return am(r) == d ? r.z : r.y;
  }
  __device__ static float mag(const V& r, int d) {
    return __uint_as_float(pick(r, d) & 0x7fffffffu);
  }
  __device__ static float m1(const V& r) {
    return __uint_as_float(r.y & 0x7fffffffu);
  }
  __device__ static float m2(const V& r) {
    return __uint_as_float(r.z & 0x7fffffffu);
  }
  __device__ static V make(uint32_t w0, float n1, float n2, int am,
                           uint32_t neg) {
    return make_uint4(w0, __float_as_uint(n1) | (neg << 31),
                      __float_as_uint(n2) | (neg << 31),
                      static_cast<uint32_t>(am));
  }
};

template <>
struct Rec<float> : Rec32 {
  __device__ static V pack(uint32_t w0, float n1, float n2, int am,
                           uint32_t neg) {
    return make(w0, n1, n2, am, neg);
  }
};

template <>
struct Rec<__nv_bfloat16> : Rec32 {
  __device__ static V pack(uint32_t w0, float n1, float n2, int am,
                           uint32_t neg) {
    return make(w0, ld(st<__nv_bfloat16>(n1)), ld(st<__nv_bfloat16>(n2)), am,
                neg);
  }
};

// int8: 16 bytes, word 0 | m1 | m2 | argmin, m1 and m2 as Q4.3 integers
// (0..127) negated where the sign product is -1 (unsigned with
// popcount_sign), so that a message of the min-sum kind is the picked
// integer, negated where the edge's sign bit is set.  The sign product is
// lost only where m1 = m2 = 0, and there every message is +-0, whose sign
// changes no total: an int8 store holds no -0.  The layered scratch of the
// integer domain has this layout too, unclamped.
template <>
struct Rec<int8_t> {
  using V = uint4;
  static constexpr bool kSigned = false;
  __device__ static int am(const V& r) { return static_cast<int>(r.w); }
  // bit 31: the sign product is negative (m2 >= m1 carries it wherever
  // the messages are not all zero)
  __device__ static uint32_t negmask(const V& r) { return r.z; }
  // the signed Q4.3 magnitude of slot d: m2 where d is the argmin, else m1
  __device__ static int pick(const V& r, int d) {
    return static_cast<int>(am(r) == d ? r.z : r.y);
  }
  __device__ static float m1(const V& r) {
    return static_cast<float>(abs(static_cast<int>(r.y))) * (1.0f / kQuant);
  }
  __device__ static float m2(const V& r) {
    return static_cast<float>(abs(static_cast<int>(r.z))) * (1.0f / kQuant);
  }
  __device__ static float mag(const V& r, int d) {
    return static_cast<float>(abs(pick(r, d))) * (1.0f / kQuant);
  }
  __device__ static V make(uint32_t w0, int q1, int q2, int am,
                           uint32_t neg) {
    const int s = -static_cast<int>(neg);   // 0, or -1 to negate
    return make_uint4(w0, static_cast<uint32_t>((q1 ^ s) - s),
                      static_cast<uint32_t>((q2 ^ s) - s),
                      static_cast<uint32_t>(am));
  }
  // from the f32 fold (normalized, offset): n1, n2 >= 0 round to 0..127
  __device__ static V pack(uint32_t w0, float n1, float n2, int am,
                           uint32_t neg) {
    return make(w0, st<int8_t>(n1), st<int8_t>(n2), am, neg);
  }
  // from the integer fold (min-sum): the two-min start saturates to 127
  __device__ static V pack_q(uint32_t w0, int n1, int n2, int am,
                             uint32_t neg) {
    return make(w0, min(n1, kQMax), min(n2, kQMax), am, neg);
  }
  static constexpr int kQMax = 127;
};

// The arithmetic of a variant: float32, or (min-sum with int8 state) the
// Q4.3 integers themselves.  Why the integers are exact: a stored total
// and a stored magnitude are multiples of 1/8 with |x| <= 15.875, so
// v = t - c2v (|v| <= 31.75), |v|, the two-min fold and phase B's sum
// (|tot| <= 15.875 * (1 + d_v)) are exact in f32, and equal the same
// operations on the integers x * 8; rounding to the store, rint(x * 8)
// clamped to +-127, is then the clamp alone.  The fold's start kBig
// rounds to 127, and so does the integer fold's start (fold_q), 2^23 - 1,
// which also saturates the layered delta t + (c2v_new - c2v_old) to the
// side that kBig takes (it is above 3 * 127).  A sign test agrees too: a
// total loads as +0 where it is 0, and x - y is -0 only for -0 - (+0), so
// no f32 value tested below is -0.  Normalized and offset multiply or
// subtract a non-dyadic alpha or beta: they keep f32 arithmetic.
template <int K, typename S>
struct Domain {
  using T = float;
  static constexpr bool kQ = false;
};

template <>
struct Domain<kMinSum, int8_t> {
  using T = int;
  static constexpr bool kQ = true;
};

// a total of the store, widened into the arithmetic's domain T
template <typename T, typename S>
__device__ __forceinline__ T load_total(const unsigned char* p) {
  if constexpr (std::is_same_v<T, int>) {
    return *reinterpret_cast<const int8_t*>(p);
  } else {
    return ld(*reinterpret_cast<const S*>(p));
  }
}

// an integer-domain total rounded into the int8 store: the clamp
__device__ __forceinline__ int8_t store_q(int x) {
  return static_cast<int8_t>(min(max(x, -Rec<int8_t>::kQMax),
                                 Rec<int8_t>::kQMax));
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

// an integer x negated where bit 31 of s is set
__device__ __forceinline__ int with_sign(int x, uint32_t s) {
  const int m = static_cast<int32_t>(s) >> 31;
  return (x ^ m) - m;
}

// acc - x where word & mask is set, else acc + x: a test and two
// predicated adds in place, where the compiler's own code broadcasts the
// bit and negates, (x ^ m) - m, in two instructions more
__device__ __forceinline__ int add_or_sub(int acc, int x, uint32_t word,
                                          uint32_t mask) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\tsetp.ne.u32 p, t, 0;\n\t"
      "@p sub.s32 %0, %0, %3;\n\t@!p add.s32 %0, %0, %3;\n\t}"
      : "+r"(acc)
      : "r"(word), "r"(mask), "r"(x));
  return acc;
#else
  return (word & mask) ? acc - x : acc + x;
#endif
}

__host__ __device__ __forceinline__ int table_ints(int mb_n, int nb_n, int dc,
                                                   int dv) {
  return mb_n * (2 + 2 * dc) + nb_n * (1 + 3 * dv);
}

__host__ __device__ __forceinline__ int sign_words(int dc) {
  return (dc + 31) / 32;
}

// sum-product: a block edge's entries in the plane, z rounded up to a
// multiple of kEdgeChecks, so that every check i0 + q*h of an edge item
// has an entry and the item writes it unconditionally (those past z are
// padding)
__host__ __device__ __forceinline__ int plane_stride(int z) {
  return kEdgeChecks * ((z + kEdgeChecks - 1) / kEdgeChecks);
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

// Byte offsets of one block's dynamic shared memory (see the layout above).
template <int K, typename S, bool kLayered>
struct Layout {
  long long ctab = 0, rec = 0, row = 0, rtab = 0, lblk = 0, lnb = 0,
            rx = 0, xbits = 0, etab = 0, par = 0, plane = 0, chan = 0,
            tot = 0, total = 0;
  __host__ __device__ explicit Layout(const Args& a) {
    const long long sz = sizeof(S);
    const long long sw = sign_words(a.dc);
    const long long edges = 1LL * a.mb_n * a.dc;   // (block row, slot)
    long long o = 4LL * table_ints(a.mb_n, a.nb_n, a.dc, a.dv);
    o = (o + 15) / 16 * 16;
    if (K == kSumProduct) {
      etab = o;
      o += 16LL * a.n_edges;
      ctab = o;
      o += 16LL * a.nb_n * a.dv;
      rec = o;
      o += 8LL * a.m;
      xbits = o;
      o += 4LL * a.m * (sw - 1);
      par = o;
      o += 4LL * a.m;
      plane = o;
      o += 4LL * a.n_edges * plane_stride(a.z);
    } else {
      ctab = o;   // the column table, or the layered (block row, slot) one
      o += 16LL * (kLayered ? edges : 1LL * a.nb_n * a.dv);
      rec = o;
      o += static_cast<long long>(sizeof(typename Rec<S>::V)) * a.m;
      if (kLayered) {
        o = (o + 15) / 16 * 16;
        row = o;
        o += 16LL * a.z;
      }
      rtab = o;
      o += 8LL * edges;
      if (kLayered) {
        lblk = o;
        o += 8LL * edges;
        lnb = o;
        o += 4LL * a.mb_n;
        rx = o;
        o += 4LL * a.z * (sw - 1);
      }
      xbits = o;
      o += 4LL * a.m * (sw - 1);
    }
    chan = o;
    o += sz * a.n;
    tot = o;
    o += sz * a.n;
    total = o;
  }
};

// The shared-memory state of one word.
template <typename S>
struct Smem {
  unsigned char* base;
  // of the edge tables as the host lays them out, the degrees and each
  // block row's first block edge
  const int* row_deg;
  const int* row_base;
  const int* col_deg;
  // min-sum family: per (block row, slot) the byte offset of the total of
  // check i = 0 and the wrap threshold (z - shift) * sizeof(S), against
  // which i * sizeof(S) is compared; per (block column, column slot) the
  // byte offset of the record of variable j = 0, the shift in record bytes
  // and the row slot (sum-product: of the plane's entry of check j = 0,
  // the shift in entry bytes)
  const int2* rtab;
  const int4* ctab;
  typename Rec<S>::V* rec;
  uint32_t* xbits;   // check degree > 32: sign words 1.. of each check
  // layered: per (block row, slot) the byte offsets of the record and of
  // the scratch record of check i = 0 for variable j = 0 (less shift
  // records), the wrap threshold shift * 16 and the slot; per (block row,
  // block) the byte offset of the total of variable j = 0 and the slots
  // d0 | d1 << 16; per block row its block count
  const int4* ltab;
  const int2* lblk;
  const int* lnb;
  // layered: the new state of the row being updated (unrounded, the
  // layout of the records: f32 bits, or the integer domain's integers)
  // and its sign words past the first
  uint4* row;
  uint32_t* rx;
  // sum-product: per block edge e the byte offset of the total of check
  // i = 0's variable, the wrap threshold (z - shift) * sizeof(S), the
  // check of i = 0 (block row * z) and the slot; per check the record
  // (sign word 0 with the sign product folded in, S as f32 bits) and the
  // parity of its totals; per (block edge, check) the plane
  const int4* etab;
  uint2* sprec;
  uint32_t* par;
  float* plane;
  S* chan;
  S* tot;
};

// The new compressed state of one check, unrounded: f32, or integers in
// the integer domain.
template <typename T>
struct Folded {
  T n1, n2;
  int am;
  uint32_t w0;    // sign word 0
  uint32_t neg;   // the new sign product is negative (parity of the words)
  uint32_t par;   // parity of the check's totals
};

// Min-sum family (`_row_stats`): the new state of the kC checks (mb, i[q])
// of one block row from the current totals and their old records, slot by
// slot in the row's order with a strict < for a new minimum.  The checks
// share each slot's table entry.  Sign words past the first (check degree
// > 32) are read from the checks' own words and written to xout[q] word by
// word: an old word is read before its new one is written.
template <int K, typename S, bool kWide, bool kPop, int kC>
__device__ __forceinline__ void fold_f(const Smem<S>& p, const Args& a,
                                       int mb, const int (&i)[kC],
                                       uint32_t* const (&xout)[kC],
                                       Folded<float> (&f)[kC]) {
  using R = Rec<S>;
  constexpr int sz = sizeof(S);
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  const int zb = a.z * sz;
  float o1[kC], o2[kC];
  int oam[kC], ib[kC];
  uint32_t flip[kC], ow[kC], px[kC];
  const uint32_t* xin[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const int c = mb * a.z + i[q];
    const typename R::V r = p.rec[c];
    xin[q] = p.xbits + c * n_x;
    o1[q] = R::m1(r);
    o2[q] = R::m2(r);
    oam[q] = R::am(r);
    if (kPop) {
      uint32_t x = r.x;
      for (int k = 0; k < n_x; ++k) x ^= xin[q][k];
      flip[q] = 0u - parity(x);
    } else {
      flip[q] = static_cast<uint32_t>(
          static_cast<int32_t>(R::negmask(r)) >> 31);
    }
    // bit r: the sign of the old message of slot r
    ow[q] = r.x ^ flip[q];
    ib[q] = i[q] * sz;
    px[q] = 0u;
    f[q].n1 = kBig;
    f[q].n2 = kBig;
    f[q].am = 0;
    f[q].w0 = 0u;
    f[q].par = 0u;
  }
  const int deg = p.row_deg[mb];
  const int2* rt = p.rtab + mb * a.dc;
  const int passes = kWide ? (deg + 31) >> 5 : 1;
  for (int w = 0; w < passes; ++w) {
    const int d0 = 32 * w;
    if (kWide && w > 0) {
#pragma unroll
      for (int q = 0; q < kC; ++q) ow[q] = xin[q][w - 1] ^ flip[q];
    }
    uint32_t nbits[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) nbits[q] = 0u;
    const int dend = kWide ? min(deg, d0 + 32) : deg;
    for (int d = d0; d < dend; ++d) {
      const int2 t = rt[d];
      const int r = d - d0;
      const uint32_t bit = 1u << r;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        const int off = ib[q] >= t.y ? t.x + ib[q] - zb : t.x + ib[q];
        const float tv = ld(*reinterpret_cast<const S*>(p.base + off));
        flip_if_negative(f[q].par, tv);
        const float mag = oam[q] == d ? o2[q] : o1[q];
        const float v = tv - with_sign(adjust<K>(mag, a.alpha, a.beta),
                                       ow[q] << (31 - r));
        const float av = fabsf(v);
        const bool newmin = av < f[q].n1;
        f[q].n2 = newmin ? f[q].n1 : fminf(f[q].n2, av);
        f[q].am = newmin ? d : f[q].am;
        f[q].n1 = fminf(f[q].n1, av);
        or_if_negative(nbits[q], v, bit);
      }
    }
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      px[q] ^= nbits[q];
      if (!kWide || w == 0) {
        f[q].w0 = nbits[q];
      } else {
        xout[q][w - 1] = nbits[q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kC; ++q) f[q].neg = parity(px[q]);
}

// (word << 1) | the sign bit of v: a funnel shift
__device__ __forceinline__ uint32_t shift_in_sign(uint32_t word, int v) {
  return __funnelshift_l(static_cast<uint32_t>(v), word, 1);
}

// The same fold in the integer domain (min-sum, int8 state), in fewer
// instructions of the integer unit, which the min-sum loops keep busiest:
// the old m1 and m2 carry the sign product (unsigned with popcount_sign),
// so v = t - (old message) is a predicated add or subtract of the picked
// integer; the minima of the keys |v| << 8 | d give the two minima with
// multiplicity and the argmin, the first of equals as a strict < gives it;
// the parity of the totals is bit 31 of their xor; and the sign bits are
// shifted in slot by slot and reversed at the end of each sign word.  The
// keys start at 2^31 - 1: an empty fold's minima are 2^23 - 1.
template <bool kWide, bool kPop, int kC>
__device__ __forceinline__ void fold_q(const Smem<int8_t>& p, const Args& a,
                                       int mb, const int (&i)[kC],
                                       uint32_t* const (&xout)[kC],
                                       Folded<int> (&f)[kC]) {
  using R = Rec<int8_t>;
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  const int z = a.z;
  int o1[kC], o2[kC], oam[kC], k1[kC], k2[kC];
  uint32_t flip[kC], ow[kC], px[kC], tx[kC];
  const uint32_t* xin[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const int c = mb * z + i[q];
    const typename R::V r = p.rec[c];
    xin[q] = p.xbits + c * n_x;
    // negated: v = t + o where the old message's sign bit is set, else
    // t - o, is t - (the old message) for o = -m
    o1[q] = -static_cast<int>(r.y);
    o2[q] = -static_cast<int>(r.z);
    oam[q] = R::am(r);
    flip[q] = 0u;
    if (kPop) {
      uint32_t x = r.x;
      for (int k = 0; k < n_x; ++k) x ^= xin[q][k];
      flip[q] = 0u - parity(x);
    }
    ow[q] = r.x ^ flip[q];
    px[q] = 0u;
    tx[q] = 0u;
    k1[q] = 0x7fffffff;
    k2[q] = 0x7fffffff;
    f[q].w0 = 0u;
  }
  const int deg = p.row_deg[mb];
  const int2* rt = p.rtab + mb * a.dc;
  const int passes = kWide ? (deg + 31) >> 5 : 1;
  for (int w = 0; w < passes; ++w) {
    const int d0 = 32 * w;
    if (kWide && w > 0) {
#pragma unroll
      for (int q = 0; q < kC; ++q) ow[q] = xin[q][w - 1] ^ flip[q];
    }
    uint32_t nbits[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) nbits[q] = 0u;
    const int dend = kWide ? min(deg, d0 + 32) : deg;
    for (int d = d0; d < dend; ++d) {
      const int2 t = rt[d];
      const uint32_t bit = 1u << (d - d0);
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        const int off = i[q] >= t.y ? t.x + i[q] - z : t.x + i[q];
        const int tv = *reinterpret_cast<const int8_t*>(p.base + off);
        tx[q] ^= static_cast<uint32_t>(tv);
        const int v =
            add_or_sub(tv, oam[q] == d ? o2[q] : o1[q], ow[q], bit);
        const int key = (abs(v) << 8) | d;
        k2[q] = min(k2[q], max(k1[q], key));
        k1[q] = min(k1[q], key);
        nbits[q] = shift_in_sign(nbits[q], v);
      }
    }
    const int n = dend - d0;
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      // slot d0 + k at bit k
      const uint32_t word = n > 0 ? __brev(nbits[q]) >> (32 - n) : 0u;
      px[q] ^= word;
      if (!kWide || w == 0) {
        f[q].w0 = word;
      } else {
        xout[q][w - 1] = word;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    f[q].n1 = k1[q] >> 8;
    f[q].n2 = k2[q] >> 8;
    f[q].am = k1[q] & 0xff;
    f[q].neg = parity(px[q]);
    f[q].par = tx[q] >> 31;
  }
}

template <int K, typename S, bool kWide, bool kPop, int kC>
__device__ __forceinline__ void fold(
    const Smem<S>& p, const Args& a, int mb, const int (&i)[kC],
    uint32_t* const (&xout)[kC], Folded<typename Domain<K, S>::T> (&f)[kC]) {
  if constexpr (Domain<K, S>::kQ) {
    fold_q<kWide, kPop, kC>(p, a, mb, i, xout, f);
  } else {
    fold_f<K, S, kWide, kPop, kC>(p, a, mb, i, xout, f);
  }
}

// The check record of a fold (flooding phase A): rounded into the store.
template <int K, typename S, bool kPop>
__device__ __forceinline__ typename Rec<S>::V pack(
    const Folded<typename Domain<K, S>::T>& f) {
  if constexpr (Domain<K, S>::kQ) {
    return Rec<S>::pack_q(f.w0, f.n1, f.n2, f.am, kPop ? 0u : f.neg);
  } else {
    return Rec<S>::pack(f.w0, f.n1, f.n2, f.am, kPop ? 0u : f.neg);
  }
}

// The c2v message of slot d from its check's record r (`_recon`); xw: the
// check's sign words past the first (check degree > 32).
template <int K, typename S, bool kWide, bool kPop>
__device__ __forceinline__ typename Domain<K, S>::T message(
    const typename Rec<S>::V& r, const uint32_t* xw, int n_x, int d,
    float alpha, float beta) {
  using R = Rec<S>;
  const uint32_t word = (kWide && d >= 32) ? xw[(d >> 5) - 1] : r.x;
  const uint32_t wsh = word << (31 - (d & 31));   // bit 31: the edge sign
  uint32_t neg = 0u;   // bit 31: the sign product is negative
  if (kPop) {
    uint32_t x = r.x;
    if (kWide) {
      for (int k = 0; k < n_x; ++k) x ^= xw[k];
    }
    neg = parity(x) << 31;
  }
  if constexpr (Domain<K, S>::kQ) {
    return with_sign(R::pick(r, d), wsh ^ neg);
  } else if constexpr (R::kSigned && !kPop && K == kMinSum) {
    return __uint_as_float(R::pick(r, d) ^ (wsh & 0x80000000u));
  } else {
    if (!kPop) neg = R::negmask(r);
    return with_sign(adjust<K>(R::mag(r, d), alpha, beta), wsh ^ neg);
  }
}

// acc + the c2v message of slot d (message); in the integer domain a
// predicated add or subtract of the picked integer
template <int K, typename S, bool kWide, bool kPop>
__device__ __forceinline__ typename Domain<K, S>::T add_message(
    typename Domain<K, S>::T acc, const typename Rec<S>::V& r,
    const uint32_t* xw, int n_x, int d, float alpha, float beta) {
  if constexpr (Domain<K, S>::kQ) {
    uint32_t word = (kWide && d >= 32) ? xw[(d >> 5) - 1] : r.x;
    if (kPop) {
      uint32_t x = r.x;
      if (kWide) {
        for (int k = 0; k < n_x; ++k) x ^= xw[k];
      }
      word ^= 0u - parity(x);
    }
    return add_or_sub(acc, Rec<S>::pick(r, d), word, 1u << (d & 31));
  } else {
    return acc + message<K, S, kWide, kPop>(r, xw, n_x, d, alpha, beta);
  }
}

// Layered (a), with (d) before it: a thread takes the checks i0 + q*h (q <
// kC, h = ceil(z/kC)) of a block row.  With prev >= 0 it first rounds the
// scratch records of those checks (block row prev's new state) into their
// records; then it folds them in block row mb from the current totals into
// the scratch.  Returns the OR of the checks' parities of the totals.
template <int K, typename S, bool kWide, bool kPop, int kC>
__device__ __forceinline__ int layered_rows(const Smem<S>& p, const Args& a,
                                            int prev, int mb) {
  using R = Rec<S>;
  constexpr bool kQ = Domain<K, S>::kQ;
  const int z = a.z;
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  const int h = (z + kC - 1) / kC;
  int bad = 0;
  for (int i0 = threadIdx.x; i0 < h; i0 += kThreads) {
    int i[kC];
    uint32_t* xo[kC];
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      const int iq = i0 + q * h;
      i[q] = iq < z ? iq : i0;   // past z: i0 again, not written
      xo[q] = p.rx + i[q] * n_x;
    }
    if (prev >= 0) {
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        const uint4 r = p.row[i[q]];
        const int c = prev * z + i[q];
        if constexpr (kQ) {
          // m2 >= m1 carries the sign product wherever it matters
          p.rec[c] = R::pack_q(r.x, abs(static_cast<int>(r.y)),
                               abs(static_cast<int>(r.z)),
                               static_cast<int>(r.w), kPop ? 0u : r.z >> 31);
        } else {
          p.rec[c] = R::pack(r.x, Rec32::m1(r), Rec32::m2(r), Rec32::am(r),
                             kPop ? 0u : r.y >> 31);
        }
        for (int w = 0; w < n_x; ++w) p.xbits[c * n_x + w] = xo[q][w];
      }
    }
    Folded<typename Domain<K, S>::T> f[kC];
    fold<K, S, kWide, kPop, kC>(p, a, mb, i, xo, f);
#pragma unroll
    for (int q = 0; q < kC; ++q) {
      bad |= f[q].par;
      if (i0 + q * h < z) {
        if constexpr (kQ) {
          p.row[i[q]] = R::make(f[q].w0, f[q].n1, f[q].n2, f[q].am,
                                f[q].neg);
        } else {
          p.row[i[q]] = Rec32::make(f[q].w0, f[q].n1, f[q].n2, f[q].am,
                                    f[q].neg);
        }
      }
    }
  }
  return bad;
}

// Layered syndrome of block rows 1..: the OR of the parities of their
// checks' totals, kChecks checks of one block row a thread (the items
// numbered across rows from `first`), each row-table entry loaded once for
// them.
template <typename S>
__device__ __forceinline__ int parity_rows(const Smem<S>& p, const Args& a,
                                           int first) {
  constexpr int sz = sizeof(S);
  const int z = a.z;
  const int zb = z * sz;
  const int h = (z + kChecks - 1) / kChecks;
  int mb = 1 + first / h;
  int i0 = first % h;
  int bad = 0;
  while (mb < a.mb_n) {
    int ib[kChecks];
    uint32_t par[kChecks];
#pragma unroll
    for (int q = 0; q < kChecks; ++q) {
      const int iq = i0 + q * h;
      ib[q] = (iq < z ? iq : i0) * sz;   // past z: i0 again
      par[q] = 0u;
    }
    const int deg = p.row_deg[mb];
    const int2* rt = p.rtab + mb * a.dc;
    for (int d = 0; d < deg; ++d) {
      const int2 t = rt[d];
#pragma unroll
      for (int q = 0; q < kChecks; ++q) {
        const int off = ib[q] >= t.y ? t.x + ib[q] - zb : t.x + ib[q];
        flip_if_negative(par[q],
                         ld(*reinterpret_cast<const S*>(p.base + off)));
      }
    }
#pragma unroll
    for (int q = 0; q < kChecks; ++q) bad |= par[q];
    i0 += kThreads;
    while (i0 >= h) {
      i0 -= h;
      ++mb;
    }
  }
  return bad;
}

// Layered (c) of block row mb: totals += new c2v - old c2v, edge by edge in
// slot order, rounded after each.  A thread takes the variables j0 + q*h
// (q < kVars, h = ceil(z/kVars)) of one block of the row (the items (block,
// j0) numbered across the row's blocks): it loads their totals once, each
// slot's table entry once for them, and per edge the old record and the
// scratch record.
template <int K, typename S, bool kWide, bool kPop>
__device__ __forceinline__ void layered_deltas(const Smem<S>& p,
                                               const Args& a, int mb) {
  using V = typename Rec<S>::V;
  using T = typename Domain<K, S>::T;
  constexpr bool kQ = Domain<K, S>::kQ;
  // the scratch's layout: the records' f32 one, or the integer domain's
  using Scratch = std::conditional_t<kQ, int8_t, float>;
  constexpr int sz = sizeof(S);
  constexpr int rb = sizeof(V);
  const int z = a.z;
  const int zr = z * rb;
  const int z16 = z * 16;
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  const int h = (z + kVars - 1) / kVars;
  const int n_blk = p.lnb[mb];
  const int2* bt = p.lblk + mb * a.dc;
  const int4* lt = p.ltab + mb * a.dc;
  int b = threadIdx.x / h;
  int j0 = threadIdx.x - b * h;
  while (b < n_blk) {
    const int2 blk = bt[b];
    int j[kVars];
    T t[kVars];
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      const int jq = j0 + q * h;
      j[q] = jq < z ? jq : j0;   // past z: j0 again, not written
      t[q] = load_total<T, S>(p.base + blk.x + j[q] * sz);
    }
    const int4* end = lt + (blk.y >> 16);
    for (const int4* e = lt + (blk.y & 0xffff); e < end; ++e) {
      const int4 te = *e;
#pragma unroll
      for (int q = 0; q < kVars; ++q) {
        const bool wrap = j[q] * 16 < te.z;
        const int on = te.y + j[q] * 16 + (wrap ? z16 : 0);
        const int oo = te.x + j[q] * rb + (wrap ? zr : 0);
        const V ro = *reinterpret_cast<const V*>(p.base + oo);
        const uint4 rn = *reinterpret_cast<const uint4*>(p.base + on);
        const uint32_t* xo = nullptr;
        const uint32_t* xn = nullptr;
        if (kWide) {
          const int i = j[q] - (te.z >> 4) + (wrap ? z : 0);
          xo = p.xbits + (mb * z + i) * n_x;
          xn = p.rx + i * n_x;
        }
        const T co = message<K, S, kWide, kPop>(ro, xo, n_x, te.w, a.alpha,
                                                 a.beta);
        const T cn = message<K, Scratch, kWide, false>(rn, xn, n_x, te.w,
                                                        a.alpha, a.beta);
        if constexpr (kQ) {
          t[q] = store_q(t[q] + (cn - co));
        } else {
          t[q] = ld(st<S>(__fadd_rn(t[q], __fsub_rn(cn, co))));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      if (j0 + q * h < z) {
        S* tot = reinterpret_cast<S*>(p.base + blk.x + j[q] * sz);
        if constexpr (kQ) {
          *tot = static_cast<S>(t[q]);
        } else {
          *tot = st<S>(t[q]);
        }
      }
    }
    j0 += kThreads;
    while (j0 >= h) {
      j0 -= h;
      ++b;
    }
  }
}

// The layered sweeps (`layered_body`) with kC checks a thread in (a);
// sets it_done and ok as the flooding loop does.
template <int K, typename S, bool kWide, bool kPop, int kC>
__device__ __forceinline__ void layered_decode(const Smem<S>& p,
                                               const Args& a, int& it_done,
                                               int& ok) {
  const int h = (a.z + kC - 1) / kC;
  // the parity items start after the threads that fold row 0's last checks
  const int first = (threadIdx.x + kThreads - h % kThreads) % kThreads;
  for (int it = 0;; ++it) {
    // (d) of the last row of the previous sweep, (a) of row 0, whose fold
    // reads the sweep's starting totals, and the parity of rows 1..
    int bad = layered_rows<K, S, kWide, kPop, kC>(
        p, a, it > 0 ? a.mb_n - 1 : -1, 0);
    bad |= parity_rows<S>(p, a, first);
    if (!__syncthreads_or(bad)) {
      ok = 1;
      it_done = it;
      return;
    }
    if (it == a.max_iters) return;
    for (int mb = 0; mb < a.mb_n; ++mb) {
      if (mb > 0) {
        layered_rows<K, S, kWide, kPop, kC>(p, a, mb - 1, mb);
        __syncthreads();
      }
      layered_deltas<K, S, kWide, kPop>(p, a, mb);
      __syncthreads();
    }
  }
}

// ---- sum-product (B4).  The plane holds one f32 per (block edge e, check
// i), at e*zp + i: from A1 to B1 phi(|v|) unrounded, with the sign of v in
// bit 31; from B1 to the next A1 the message c2v, unrounded.  So a message
// is computed once, in B1, and A1 takes it back for v = t - c2v, where the
// TPU kernel rebuilds it from the same stored S, sign and stash: 2 phi an
// edge, not 3.  The stash (phi(|v|) rounded to the store) is the plane's
// value rounded where B1 reads it. ----

// A thread of A1 and B1 takes the checks i0 + q*h (q < kEdgeChecks, h =
// ceil(z/kEdgeChecks)) of one block edge, the (block edge, i0) items numbered
// across block edges, so that every thread has work where z is small; the
// block edge's table entry is loaded once for them.
struct EdgeItems {
  int h, e, i0, de, di;
  __device__ explicit EdgeItems(int z)
      : h((z + kEdgeChecks - 1) / kEdgeChecks),
        e(static_cast<int>(threadIdx.x) / h),
        i0(static_cast<int>(threadIdx.x) - e * h),
        de(kThreads / h),
        di(kThreads - de * h) {}
  __device__ void next() {
    e += de;
    i0 += di;
    if (i0 >= h) {
      i0 -= h;
      ++e;
    }
  }
};

// A1: per edge, v = t - c2v from the total and the kept message, and
// phi(|v|) with v's sign into the plane.  Both edges' loads come first:
// a load after a store to the plane would wait for it (the compiler cannot
// tell the plane from the totals), and the two phi would run one after
// the other.
template <typename S>
__device__ __forceinline__ void sp_edges_a(const Smem<S>& p, const Args& a) {
  constexpr int sz = sizeof(S);
  const int z = a.z;
  const int zb = z * sz;
  const int zp = plane_stride(z);
  for (EdgeItems it(z); it.e < a.n_edges; it.next()) {
    const int4 te = p.etab[it.e];
    float* pl = p.plane + it.e * zp;
    float v[kEdgeChecks];
#pragma unroll
    for (int q = 0; q < kEdgeChecks; ++q) {
      // past z (padding): the total of check i0, whatever it gives
      const int i = it.i0 + q * it.h;
      const int ib = (q == 0 || i < z ? i : it.i0) * sz;
      const int off = ib >= te.y ? te.x + ib - zb : te.x + ib;
      v[q] = ld(*reinterpret_cast<const S*>(p.base + off)) - pl[i];
    }
#pragma unroll
    for (int q = 0; q < kEdgeChecks; ++q) {
      const float ph = phi(clip_phi(fabsf(v[q])));
      pl[it.i0 + q * it.h] =
          __uint_as_float((__float_as_uint(ph) & 0x7fffffffu) |
                          (v[q] < 0.f ? 0x80000000u : 0u));
    }
  }
}

// A2: per check, S = the sum of its phi(|v|) in row-slot order, the sign
// words and the sign product (folded into the words: bit d is then the
// sign of slot d's message), and the parity of its totals (flipped by B2,
// or at entry, for each negative total), which it clears.  Returns the OR
// of the parities.
template <typename S, bool kWide>
__device__ __forceinline__ int sp_checks(const Smem<S>& p, const Args& a) {
  const int z = a.z;
  const int zp = plane_stride(z);
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  int bad = 0;
  for (int c = threadIdx.x; c < a.m; c += kThreads) {
    const int mb = c / z;
    const float* pl = p.plane + p.row_base[mb] * zp + (c - mb * z);
    const int deg = p.row_deg[mb];
    uint32_t* xw = p.xbits + c * n_x;
    float s = 0.f;
    uint32_t w0 = 0u, px = 0u;
    for (int d0 = 0; d0 < deg; d0 += 32) {
      const int dend = kWide ? min(deg, d0 + 32) : deg;
      uint32_t nbits = 0u;
      for (int d = d0; d < dend; ++d) {
        const uint32_t u = __float_as_uint(pl[d * zp]);
        s = s + __uint_as_float(u & 0x7fffffffu);
        nbits = shift_in_sign(nbits, static_cast<int>(u));
      }
      // slot d0 + k at bit k
      nbits = dend > d0 ? __brev(nbits) >> (32 - (dend - d0)) : 0u;
      px ^= nbits;
      if (d0 == 0) {
        w0 = nbits;
      } else {
        xw[(d0 >> 5) - 1] = nbits;
      }
    }
    const uint32_t flip = 0u - parity(px);
    for (int k = 0; k < n_x; ++k) xw[k] ^= flip;
    p.sprec[c] = make_uint2(w0 ^ flip, __float_as_uint(ld(st<S>(s))));
    bad |= p.par[c];
    p.par[c] = 0u;
  }
  return bad;
}

// B1: per edge, c2v = sgn * phi(S - stash) into the plane; loads first,
// as in A1.
template <typename S, bool kWide>
__device__ __forceinline__ void sp_edges_b(const Smem<S>& p, const Args& a) {
  const int z = a.z;
  const int zp = plane_stride(z);
  const int n_x = kWide ? sign_words(a.dc) - 1 : 0;
  for (EdgeItems it(z); it.e < a.n_edges; it.next()) {
    const int4 te = p.etab[it.e];
    const int d = te.w;
    float* pl = p.plane + it.e * zp;
    float rest[kEdgeChecks];
    uint32_t sgn[kEdgeChecks];
#pragma unroll
    for (int q = 0; q < kEdgeChecks; ++q) {
      // past z: padding, from check i0's record
      const int i = it.i0 + q * it.h;
      const int c = te.z + (q == 0 || i < z ? i : it.i0);
      const uint2 r = p.sprec[c];
      const uint32_t word =
          (kWide && d >= 32) ? p.xbits[c * n_x + (d >> 5) - 1] : r.x;
      sgn[q] = word << (31 - (d & 31));
      rest[q] = __uint_as_float(r.y) - ld(st<S>(fabsf(pl[i])));
    }
#pragma unroll
    for (int q = 0; q < kEdgeChecks; ++q) {
      pl[it.i0 + q * it.h] = with_sign(phi(clip_phi(rest[q])), sgn[q]);
    }
  }
}

// Flip the parity of every check of variable j of block column nb (its
// total is negative): the column table's third entry is the check of
// variable 0, less the shift.
template <typename S>
__device__ __forceinline__ void sp_flip_checks(const Smem<S>& p,
                                               const Args& a, int nb, int j) {
  const int4* ct = p.ctab + nb * a.dv;
  const int deg = p.col_deg[nb];
  for (int k = 0; k < deg; ++k) {
    const int4 e = ct[k];
    atomicXor(p.par + e.z + j + (j * 4 < e.y ? a.z : 0), 1u);
  }
}

// B2: per variable, tot = -chan + its messages in the plan's column order;
// a thread takes the variables j0 + q*h (q < kVars, h = ceil(z/kVars)) of
// one block column, a slot's table entry loaded once for them.  A negative
// total flips its checks' parities for the next A2 (rare once a word
// nears convergence, so a branch and shared atomics).
template <typename S>
__device__ __forceinline__ void sp_sums(const Smem<S>& p, const Args& a) {
  const int z = a.z;
  const int zr = z * 4;
  const int h = (z + kVars - 1) / kVars;
  const int dn = kThreads / h;
  const int dj = kThreads - dn * h;
  int nb = threadIdx.x / h;
  int j0 = threadIdx.x - nb * h;
  while (nb < a.nb_n) {
    int v[kVars], jr[kVars];
    float acc[kVars];
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      const int jq = j0 + q * h;
      const int j = jq < z ? jq : j0;   // past z: j0 again, not written
      v[q] = nb * z + j;
      jr[q] = j * 4;
      acc[q] = -ld(p.chan[v[q]]);
    }
    const int deg = p.col_deg[nb];
    const int4* ct = p.ctab + nb * a.dv;
    for (int k = 0; k < deg; ++k) {
      const int4 e = ct[k];
#pragma unroll
      for (int q = 0; q < kVars; ++q) {
        const int off = jr[q] < e.y ? e.x + jr[q] + zr : e.x + jr[q];
        acc[q] = acc[q] + *reinterpret_cast<const float*>(p.base + off);
      }
    }
#pragma unroll
    for (int q = 0; q < kVars; ++q) {
      if (j0 + q * h < z) {
        const S t = st<S>(acc[q]);
        p.tot[v[q]] = t;
        if (ld(t) < 0.f) sp_flip_checks(p, a, nb, j0 + q * h);
      }
    }
    nb += dn;
    j0 += dj;
    if (j0 >= h) {
      j0 -= h;
      ++nb;
    }
  }
}

// kWide: check degree above 32, ceil(dc/32) sign words per check; without
// it the one-word layout compiles to the single-word code.  kPop is a
// template parameter, not a flag of the launch: as a flag it halved the
// instances and the build time, but made the near-earth popcount decode 3%
// slower on an H100 (kernel_ab.py).
template <int K, typename S, bool kWide, bool kLayered, bool kPop>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Args a) {
  constexpr bool kSp = K == kSumProduct;
  using R = Rec<S>;
  using V = typename R::V;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_errors;
  const int n = a.n, m = a.m, z = a.z;
  const int n_tab = table_ints(a.mb_n, a.nb_n, a.dc, a.dv);
  const int n_sw = kWide ? sign_words(a.dc) : 1;
  const int n_x = n_sw - 1;
  const Layout<K, S, kLayered> lay(a);
  int* tab = reinterpret_cast<int*>(smem);
  Smem<S> p;
  p.base = smem;
  p.row_deg = tab;
  p.row_base = p.row_deg + a.mb_n;
  p.col_deg = p.row_base + a.mb_n * (1 + 2 * a.dc);
  p.rtab = reinterpret_cast<const int2*>(smem + lay.rtab);
  p.ctab = reinterpret_cast<const int4*>(smem + lay.ctab);
  p.rec = reinterpret_cast<V*>(smem + lay.rec);
  p.xbits = reinterpret_cast<uint32_t*>(smem + lay.xbits);
  p.ltab = reinterpret_cast<const int4*>(smem + lay.ctab);
  p.lblk = reinterpret_cast<const int2*>(smem + lay.lblk);
  p.lnb = reinterpret_cast<const int*>(smem + lay.lnb);
  p.row = reinterpret_cast<uint4*>(smem + lay.row);
  p.rx = reinterpret_cast<uint32_t*>(smem + lay.rx);
  p.etab = reinterpret_cast<const int4*>(smem + lay.etab);
  p.sprec = reinterpret_cast<uint2*>(smem + lay.rec);
  p.par = reinterpret_cast<uint32_t*>(smem + lay.par);
  p.plane = reinterpret_cast<float*>(smem + lay.plane);
  p.chan = reinterpret_cast<S*>(smem + lay.chan);
  p.tot = reinterpret_cast<S*>(smem + lay.tot);

  const int tid = threadIdx.x;
  const int word = blockIdx.x;
  for (int k = tid; k < n_tab; k += kThreads) tab[k] = a.tables[k];
  // the packed tables, from the host's: row_deg | row_base at 0,
  // row_nb | row_shift at 2*mb_n, col_mb | col_d | col_shift after col_deg
  const int* g_nb = a.tables + 2 * a.mb_n;
  const int* g_rsh = g_nb + a.mb_n * a.dc;
  const int* g_cmb = g_rsh + a.mb_n * a.dc + a.nb_n;
  const int* g_cd = g_cmb + a.nb_n * a.dv;
  const int* g_csh = g_cd + a.nb_n * a.dv;
  constexpr int sz = sizeof(S);
  int4* ctab = reinterpret_cast<int4*>(smem + lay.ctab);
  if (kSp) {
    // per block edge and per (block column, column slot): see Smem
    int4* etab = reinterpret_cast<int4*>(smem + lay.etab);
    for (int k = tid; k < a.mb_n * a.dc; k += kThreads) {
      const int mb = k / a.dc;
      const int d = k - mb * a.dc;
      const int s = g_rsh[k];
      if (d < a.tables[mb]) {
        etab[a.tables[a.mb_n + mb] + d] = make_int4(
            static_cast<int>(lay.tot) + (g_nb[k] * z + s) * sz,
            (z - s) * sz, mb * z, d);
      }
    }
    for (int k = tid; k < a.nb_n * a.dv; k += kThreads) {
      const int s = g_csh[k];
      const int e = a.tables[a.mb_n + g_cmb[k]] + g_cd[k];
      ctab[k] = make_int4(
          static_cast<int>(lay.plane) + (e * plane_stride(z) - s) * 4, s * 4,
          g_cmb[k] * z - s, 0);
    }
  } else {
    constexpr int rb = sizeof(V);
    int2* rtab = reinterpret_cast<int2*>(smem + lay.rtab);
    for (int k = tid; k < a.mb_n * a.dc; k += kThreads) {
      const int s = g_rsh[k];
      rtab[k] = make_int2(static_cast<int>(lay.tot) + (g_nb[k] * z + s) * sz,
                          (z - s) * sz);
    }
    if (kLayered) {
      // per (block row, slot) and per (block row, block): see Smem
      int2* lblk = reinterpret_cast<int2*>(smem + lay.lblk);
      int* lnb = reinterpret_cast<int*>(smem + lay.lnb);
      for (int k = tid; k < a.mb_n * a.dc; k += kThreads) {
        const int mb = k / a.dc;
        const int d = k - mb * a.dc;
        const int s = g_rsh[k];
        ctab[k] = make_int4(
            static_cast<int>(lay.rec) + (mb * z - s) * rb,
            static_cast<int>(lay.row) - s * 16, s * 16, d);
        const int deg = a.tables[mb];
        const int* nb = g_nb + mb * a.dc;
        if (d < deg && (d == 0 || nb[d - 1] != nb[d])) {
          int b = 0;
          for (int e = 1; e <= d; ++e) b += nb[e] != nb[e - 1];
          int d1 = d + 1;
          while (d1 < deg && nb[d1] == nb[d]) ++d1;
          lblk[mb * a.dc + b] = make_int2(
              static_cast<int>(lay.tot) + nb[d] * z * sz, d | (d1 << 16));
        }
        if (d == 0) {
          int b = deg > 0;
          for (int e = 1; e < deg; ++e) b += nb[e] != nb[e - 1];
          lnb[mb] = b;
        }
      }
    } else {
      for (int k = tid; k < a.nb_n * a.dv; k += kThreads) {
        const int s = g_csh[k];
        ctab[k] = make_int4(
            static_cast<int>(lay.rec) + (g_cmb[k] * z - s) * rb, s * rb,
            g_cd[k], 0);
      }
    }
  }
  const float* in = a.llr + static_cast<size_t>(word) * n;
  for (int v = tid; v < n; v += kThreads) {
    float x = in[v];
    x = isnan(x) ? 0.f : fminf(fmaxf(x, -kLlrClip), kLlrClip);
    const S c = st<S>(x);
    p.chan[v] = c;
    p.tot[v] = st<S>(-ld(c));   // decoders negate on entry
  }
  if (kSp) {
    for (int c = tid; c < m; c += kThreads) p.par[c] = 0u;
    // the first messages: S = 38 with a zero stash rebuilds phi(38), +-0
    const float c0 = phi(clip_phi(ld(st<S>(kPhiMax)) - ld(st<S>(0.f))));
    for (int k = tid; k < a.n_edges * plane_stride(z); k += kThreads) {
      p.plane[k] = c0;
    }
  } else {
    // m1 = m2 = 0: the rebuilt c2v is 0 on the first iteration
    for (int c = tid; c < m; c += kThreads) {
      p.rec[c] = R::pack(0u, 0.f, 0.f, 0, 0u);
    }
    for (int k = tid; k < m * n_x; k += kThreads) p.xbits[k] = 0u;
  }
  if (tid == 0) s_errors = 0;
  __syncthreads();
  if (kSp) {
    // the parities of the checks of the entry totals (the tables and the
    // zeroed words are in place)
    for (int v = tid; v < n; v += kThreads) {
      if (ld(p.tot[v]) < 0.f) sp_flip_checks(p, a, v / z, v % z);
    }
    __syncthreads();
  }

  int it_done = a.max_iters;
  int ok = 0;
  if constexpr (kLayered) {
    // two checks a thread in (a) only where z > kThreads and the check
    // degree is at most 32: the wide instances' two-check fold spills
    // registers beside the one-check variant
    if (!kWide && z > kThreads) {
      layered_decode<K, S, kWide, kPop, kChecks>(p, a, it_done, ok);
    } else {
      layered_decode<K, S, kWide, kPop, 1>(p, a, it_done, ok);
    }
  } else if constexpr (kSp) {
    // A1 | A2 | B1 | B2, a barrier after each
    for (int it = 0;; ++it) {
      sp_edges_a<S>(p, a);
      __syncthreads();
      if (!__syncthreads_or(sp_checks<S, kWide>(p, a))) {
        ok = 1;
        it_done = it;
        break;
      }
      if (it == a.max_iters) break;
      sp_edges_b<S, kWide>(p, a);
      __syncthreads();
      sp_sums<S>(p, a);
      __syncthreads();
    }
  } else {
    using T = typename Domain<K, S>::T;
    for (int it = 0;; ++it) {
      int bad = 0;
      {
        // ---- phase A: syndrome of the current totals + new check state;
        // a thread takes the checks i0 + q*h (q < kChecks) of block row mb ----
        const int h = (z + kChecks - 1) / kChecks;
        int mb = tid / h;
        int i0 = tid - mb * h;
        while (mb < a.mb_n) {
          int i[kChecks];
          uint32_t* xo[kChecks];
#pragma unroll
          for (int q = 0; q < kChecks; ++q) {
            const int iq = i0 + q * h;
            i[q] = iq < z ? iq : i0;   // past z: i0 again, not written
            xo[q] = p.xbits + (mb * z + i[q]) * n_x;
          }
          Folded<T> f[kChecks];
          fold<K, S, kWide, kPop, kChecks>(p, a, mb, i, xo, f);
#pragma unroll
          for (int q = 0; q < kChecks; ++q) {
            bad |= f[q].par;
            if (i0 + q * h < z) p.rec[mb * z + i[q]] = pack<K, S, kPop>(f[q]);
          }
          i0 += kThreads;
          while (i0 >= h) {
            i0 -= h;
            ++mb;
          }
        }
      }
      if (!__syncthreads_or(bad)) {
        ok = 1;
        it_done = it;
        break;
      }
      if (it == a.max_iters) break;
      // ---- phase B: totals = -chan + sum of the rebuilt c2v messages ----
      {
        // a thread takes the variables j0 + q*h (q < kVars) of block column
        // nb; each sums its messages in the column's order
        constexpr int rb = sizeof(V);
        const int zr = z * rb;
        const int h = (z + kVars - 1) / kVars;
        int nb = tid / h;
        int j0 = tid - nb * h;
        while (nb < a.nb_n) {
          int v[kVars], jr[kVars];
          T acc[kVars];
#pragma unroll
          for (int q = 0; q < kVars; ++q) {
            const int jq = j0 + q * h;
            const int j = jq < z ? jq : j0;   // past z: j0 again, not written
            v[q] = nb * z + j;
            jr[q] = j * rb;
            acc[q] = -load_total<T, S>(
                reinterpret_cast<const unsigned char*>(p.chan + v[q]));
          }
          const int deg = p.col_deg[nb];
          const int4* ct = p.ctab + nb * a.dv;
          for (int k = 0; k < deg; ++k) {
            const int4 e = ct[k];
#pragma unroll
            for (int q = 0; q < kVars; ++q) {
              const int off = jr[q] < e.y ? e.x + jr[q] + zr : e.x + jr[q];
              const V r = *reinterpret_cast<const V*>(p.base + off);
              const uint32_t* xw =
                  kWide ? p.xbits + (off - static_cast<int>(lay.rec)) / rb * n_x
                        : nullptr;
              acc[q] = add_message<K, S, kWide, kPop>(acc[q], r, xw, n_x, e.z,
                                                      a.alpha, a.beta);
            }
          }
#pragma unroll
          for (int q = 0; q < kVars; ++q) {
            if (j0 + q * h < z) {
              if constexpr (Domain<K, S>::kQ) {
                p.tot[v[q]] = store_q(acc[q]);
              } else {
                p.tot[v[q]] = st<S>(acc[q]);
              }
            }
          }
          j0 += kThreads;
          while (j0 >= h) {
            j0 -= h;
            ++nb;
          }
        }
      }
      __syncthreads();
    }
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
int launch(const Args& a, int batch, cudaStream_t stream) {
  const long long smem = Layout<K, S, kLayered>(a).total;
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
