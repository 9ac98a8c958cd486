// Native CPU min-sum decoder: the host-side golden engine of the PyTorch
// port (a copy of the JAX package's native/minsum.cpp, built and loaded by
// ldpc_tpu_torch.native).
//
// The reference's CPU engine is numba-JIT-compiled Python (ldpc.py:75-337
// jitclasses).  This engine is ahead-of-time C++ exposed through a C ABI.
// It implements the update rule of ldpc_tpu_torch/ops/oracle.py: flooding
// min-sum, extrinsic two-min check-node rule, syndrome early exit,
// reference sign conventions with the internal negation documented in
// ops/decoder.py, in float64 on a dense H.  It cross-checks the card's
// decoders at scale (the numpy oracle is about 100x slower) through an
// implementation path of its own.
//
// H is passed in CSR-like row form: row_ptr[m+1] offsets into col_idx.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Decode one codeword.
//   channel: [n] float64 soft values (reference convention: >0 => bit 1)
//   row_ptr: [m+1], col_idx: [nnz] CSR structure of H
//   hard_out: [n] int64, soft_out: [n] float64
//   returns iterations used; *ok_out = 1 if syndrome satisfied
int ldpc_min_sum_decode(const double* channel, int32_t n, int32_t m,
                        const int32_t* row_ptr, const int32_t* col_idx,
                        int32_t max_iters, int64_t* hard_out,
                        double* soft_out, int32_t* ok_out) {
  const int32_t nnz = row_ptr[m];
  // internal negation: positive <=> bit 0 (see ops/decoder.py docstring)
  std::vector<double> totals(n), chan(n);
  for (int32_t i = 0; i < n; ++i) {
    chan[i] = -channel[i];
    totals[i] = chan[i];
  }
  std::vector<double> c2v(nnz, 0.0);
  std::vector<int64_t> hard(n);

  auto harden = [&]() {
    for (int32_t i = 0; i < n; ++i) hard[i] = totals[i] < 0.0 ? 1 : 0;
  };
  auto syndrome_ok = [&]() -> bool {
    for (int32_t r = 0; r < m; ++r) {
      int64_t par = 0;
      for (int32_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e)
        par ^= hard[col_idx[e]];
      if (par) return false;
    }
    return true;
  };
  auto finish = [&](int iters, bool ok) {
    for (int32_t i = 0; i < n; ++i) {
      hard_out[i] = hard[i];
      soft_out[i] = -totals[i];
    }
    *ok_out = ok ? 1 : 0;
    return iters;
  };

  harden();
  if (syndrome_ok()) return finish(0, true);

  std::vector<double> new_totals(n);
  for (int32_t it = 1; it <= max_iters; ++it) {
    std::memcpy(new_totals.data(), chan.data(), n * sizeof(double));
    for (int32_t r = 0; r < m; ++r) {
      const int32_t lo = row_ptr[r], hi = row_ptr[r + 1];
      // finite saturation (not HUGE_VAL): a degree-1 check emits
      // max() on its only edge, matching ops/oracle.py and the TPU
      // decoder's finfo-max two-min init instead of producing inf.
      const double kSat = std::numeric_limits<double>::max();
      double min1 = kSat, min2 = kSat, sprod = 1.0;
      int32_t amin = lo;
      for (int32_t e = lo; e < hi; ++e) {
        const double v = totals[col_idx[e]] - c2v[e];
        c2v[e] = v;  // stash v2c; replaced by the outgoing value below
        const double a = std::fabs(v);
        if (v < 0.0) sprod = -sprod;
        if (a < min1) {
          min2 = min1;
          min1 = a;
          amin = e;
        } else if (a < min2) {
          min2 = a;
        }
      }
      for (int32_t e = lo; e < hi; ++e) {
        const double v = c2v[e];
        const double sign = (v < 0.0 ? -sprod : sprod);
        const double mag = (e == amin ? min2 : min1);
        const double out = sign * mag;
        c2v[e] = out;
        new_totals[col_idx[e]] += out;
      }
    }
    totals.swap(new_totals);
    harden();
    if (syndrome_ok()) return finish(it, true);
  }
  return finish(max_iters, false);
}

// Batch decode: llr [batch, n] row-major; outputs per word.
void ldpc_min_sum_decode_batch(const double* channel, int32_t batch,
                               int32_t n, int32_t m, const int32_t* row_ptr,
                               const int32_t* col_idx, int32_t max_iters,
                               int64_t* hard_out, double* soft_out,
                               int32_t* iters_out, int32_t* ok_out) {
  for (int32_t b = 0; b < batch; ++b) {
    iters_out[b] = ldpc_min_sum_decode(
        channel + (int64_t)b * n, n, m, row_ptr, col_idx, max_iters,
        hard_out + (int64_t)b * n, soft_out + (int64_t)b * n, ok_out + b);
  }
}

}  // extern "C"
