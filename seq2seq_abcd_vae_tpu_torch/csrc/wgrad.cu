// Weight-gradient reductions of the port's backward kernels, written for
// Hopper (sm_90a).
//
// The TPU backward kernels (seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:
// _bwdf_kernel and ops/decoder_pallas.py:_fused_bwd_kernel) accumulate
// every weight gradient in VMEM across their sequential grid: at each step
// dW += a_t^T dz_t over the batch rows.  CUDA blocks run in no order and a
// sum carried across blocks would need atomics, whose order changes from run
// to run.  So the recurrent backward kernels write their per-step operand
// and cotangent streams, and this kernel reduces them afterwards in a fixed
// order:
//
//     C[k][n] = sum over r of A[r][k] * B[r][n]      (r = t * batch + b)
//
// with A == nullptr meaning a column of ones (K == 1): a bias gradient, the
// column sum of B.  Each block owns a 64 x 64 tile of C and one contiguous
// split of the rows; a thread keeps a 4 x 4 tile of sums in registers, and
// the rows are staged through shared memory 16 at a time.  With more than one
// split the partial tiles land in a workspace and abcd_wgrad_sum adds them in
// split order, so a run repeats exactly.
//
// What bounds it: the rows are read once per tile column of C (the A stream
// once per 64 columns of B, and B once per 64 columns of A), so for the
// decoder's (H, 4H + 2m) product the reads dominate the arithmetic only for
// narrow C; at the publication shapes the float32 FMA rate of the SMs holding
// a tile bounds it.  A wgmma tile on bf16 operands is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;  // rows staged per pass
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) wgrad_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B,
    int ldb, float* __restrict__ out, int R, int K, int N,
    int rows_per_split) {
  __shared__ float sA[kDepth][kTile];
  __shared__ float sB[kDepth][kTile];
  const int k0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int z = blockIdx.z;
  const int r_begin = z * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int rb = r_begin; rb < r_end; rb += kDepth) {
    for (int i = tid; i < kDepth * kTile; i += kThreads) {
      const int rr = i / kTile, cc = i % kTile;
      const int r = rb + rr;
      const bool row_ok = r < r_end;
      const int k = k0 + cc, n = n0 + cc;
      float a = 0.f, b = 0.f;
      if (row_ok && k < K) a = A ? A[(int64_t)r * lda + k] : 1.f;
      if (row_ok && n < N) b = B[(int64_t)r * ldb + n];
      sA[rr][cc] = a;
      sB[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kDepth; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = out + (int64_t)z * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) dst[(int64_t)k * N + n] = acc[i][j];
    }
  }
}

// C[i] = sum over z in order of partial[z][i].
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ C, int64_t size,
                                 int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(int64_t)z * size + i];
  C[i] = s;
}

__global__ void add2_kernel(const float* __restrict__ a,
                            const float* __restrict__ b,
                            float* __restrict__ out, int64_t size) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < size) out[i] = a[i] + b[i];
}

}  // namespace

extern "C" {

// Splits of the rows for a (K, N) product over R rows: enough blocks to
// cover the card twice, at least 512 rows each.  The wrapper sizes the
// workspace (splits * K * N floats when splits > 1) from this.
int abcd_wgrad_splits(int R, int K, int N) {
  const int tiles = ((K + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  int splits = (264 + tiles - 1) / tiles;
  const int by_rows = R / 512;
  if (splits > by_rows) splits = by_rows;
  if (splits > 64) splits = 64;
  return splits < 1 ? 1 : splits;
}

// C (K, N) = A^T B over R rows (A == nullptr: a column of ones, K == 1).
// `workspace` holds splits * K * N floats and is unused when splits == 1.
int abcd_wgrad(const float* A, int lda, const float* B, int ldb, float* C,
               int R, int K, int N, int splits, float* workspace,
               void* stream) {
  if (R < 0 || K < 1 || N < 1 || splits < 1 || (!A && K != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_split = (R + splits - 1) / splits;
  const dim3 grid((N + kTile - 1) / kTile, (K + kTile - 1) / kTile, splits);
  float* out = splits == 1 ? C : workspace;
  wgrad_kernel<<<grid, kThreads, 0, s>>>(A, lda, B, ldb, out, R, K, N,
                                          rows_per_split > 0 ? rows_per_split
                                                             : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t size = (int64_t)K * N;
  split_sum_kernel<<<(unsigned)((size + 255) / 256), 256, 0, s>>>(
      workspace, C, size, splits);
  return (int)cudaGetLastError();
}

// out = a + b elementwise (the two directions' input cotangents).
int abcd_add2(const float* a, const float* b, float* out, long long size,
              void* stream) {
  if (size <= 0) return 0;
  add2_kernel<<<(unsigned)((size + 255) / 256), 256, 0,
                (cudaStream_t)stream>>>(a, b, out, size);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
