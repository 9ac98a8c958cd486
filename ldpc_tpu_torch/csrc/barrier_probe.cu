// The probe of ldpc_tpu/ops/pallas_static.py::_barrier_lowers: out = a + |a|
// with a and |a| passed through a compiler barrier.  The Pallas probe wraps
// them in jax.lax.optimization_barrier, which keeps values as they are and
// lets nothing move across it; the CUDA counterpart is an empty volatile asm
// statement that takes both as read-write register operands.  The wrapper
// (ops/cuda_static.py::barrier_lowers) compares the output with x + |x|
// exactly, on an [8, 128] float32 array of linspace(-1, 1, 1024).
//
// Bound: 8 bytes a value through HBM (one float read, one written) and 2
// float32 operations; at 1,024 values the launch itself is the cost.

#include <cuda_runtime.h>

namespace {

__global__ void barrier_probe(const float* x, float* out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float a = x[k];
  float b = fabsf(a);
  asm volatile("" : "+f"(a), "+f"(b));
  out[k] = a + b;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  x and out are device pointers to n floats.
int barrier_probe_launch(const float* x, float* out, int n, void* stream) {
  constexpr int kThreads = 256;
  if (n <= 0) return 0;
  barrier_probe<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
