// The launch-cost probe, written for Hopper (sm_90a): y = x + 1 on a small
// float32 tensor, one thread per element.
//
// Replaces seq2seq_abcd_vae_tpu/utils/backend_select.py:_measure_concrete's
// `probe` (a pallas_call of `o_ref[:] = x_ref[:] + 1.0` on an (8, 128)
// array).  The kernel does no work worth the name on purpose: timed against
// torch's own `x + 1` on the same tensor (ops/probe_kernel.py), a pipelined
// run of launches measures what one hand-written launch costs beyond one of
// PyTorch's (the argument marshalling through ctypes, the launch itself).
// Its bound is the 8 KB it reads and writes; any time above that is launch
// cost, which is what the probe is for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.f;
}

}  // namespace

extern "C" {

// y[i] = x[i] + 1 for i < n, on `stream`.
int abcd_probe_add_one(const float* x, float* y, long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, y, (int64_t)n);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
