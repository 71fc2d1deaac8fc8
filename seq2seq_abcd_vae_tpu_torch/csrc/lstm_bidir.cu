// Forward pass of one masked bidirectional LSTM layer, written for Hopper
// (sm_90a).
//
// Replaces seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer_bidir_fused,
// forward (`_fwdf_call` / `_fwdf_kernel`).  For each direction d and step t
// it computes x_t @ W_ih[d] + b_ih[d] + h @ W_hh[d] + b_hh[d] inside the
// kernel (the (T, 2, B, 4H) input projection never exists in memory),
// applies the torch (i, f, g, o) gates, freezes a row's carries outside its
// span and writes outs (T, 2, B, H), h_n and c_n (2, B, H).  Direction 1
// reads x in reversed time and is active on [T - len, T) of its own flipped
// step axis (seq2seq_abcd_vae_tpu/ops/_mask_utils.py:span_mask), so its
// outs are in flipped time, as the TPU kernel writes them.
//
// What bounds it on the H100: the float32 operations are 2 * 4H * (F + H)
// multiply-adds per row, step and direction (0.77 ms at B=64, T=512, H=256,
// F=129 against 67 TFLOP/s), but the time loop is sequential and every step
// needs all of W_ih and W_hh (1.58 MB per direction at that width), far more
// than one SM holds.  In this first design the weights are re-read from L2
// at every step, so the kernel is bound by the L2 -> SM rate of the few SMs
// it occupies, not by the card's arithmetic.
//
// Design: CUDA blocks run in no order, so the time loop lives inside the
// block, as the TPU's sequential grid axis did.  One block per (direction,
// tile of kRows batch rows) owns all 4H gate columns of its rows: thread u
// owns hidden unit u and accumulates its four gates for the kRows rows in
// registers, so no gate ever leaves the thread; it keeps c for its rows in
// registers and publishes h through shared memory, where the whole block
// reads it for the next step's recurrent product.  Two barriers a step.
// Splitting W_hh across a thread-block cluster (or wgmma) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;  // batch rows per block
// One thread per hidden unit; ptxas gives the kernel 128 registers a
// thread, so 512 threads fill the SM's 64K registers.  Larger H is refused.
constexpr int kMaxHidden = 512;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxHidden) lstm_bidir_fwd_kernel(
    const float* __restrict__ x,        // (T, B, F)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // (2, F, 4H)
    const float* __restrict__ b_ih,     // (2, 4H)
    const float* __restrict__ w_hh,     // (2, H, 4H)
    const float* __restrict__ b_hh,     // (2, 4H)
    float* __restrict__ outs,           // (T, 2, B, H)
    float* __restrict__ cs,             // (T, 2, B, H) or nullptr
    float* __restrict__ h_n,            // (2, B, H)
    float* __restrict__ c_n,            // (2, B, H)
    int T, int B, int F, int H) {
  extern __shared__ float smem[];
  float* s_h = smem;               // [kRows][H]
  float* s_x = smem + kRows * H;   // [kRows][F]

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const int u = threadIdx.x;
  const bool owns = u < H;
  const int G = 4 * H;
  const float* wi = w_ih + (int64_t)d * F * G + u;
  const float* wh = w_hh + (int64_t)d * H * G + u;

  float bias_x[4], bias_h[4];
  float h[kRows], c[kRows];
  int len[kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bias_x[g] = owns ? b_ih[d * G + g * H + u] : 0.f;
    bias_h[g] = owns ? b_hh[d * G + g * H + u] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    h[r] = 0.f;
    c[r] = 0.f;
    len[r] = r < nrows ? lengths[r0 + r] : 0;
  }
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) s_h[i] = 0.f;

  // x rows of step t of this direction into s_x (zeros past the batch).
  auto stage_x = [&](int t) {
    const int tx = d == 0 ? t : T - 1 - t;
    const float* src = x + ((int64_t)tx * B + r0) * F;
    for (int i = threadIdx.x; i < kRows * F; i += blockDim.x) {
      s_x[i] = i < nrows * F ? src[i] : 0.f;
    }
  };
  stage_x(0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float ax[4][kRows], ah[4][kRows];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ax[g][r] = 0.f;
        ah[g][r] = 0.f;
      }
    }
    if (owns) {
#pragma unroll 8
      for (int k = 0; k < F; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wi + (int64_t)k * G + g * H);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = s_x[r * F + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
        }
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wh + (int64_t)k * G + g * H);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = s_h[r * H + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ah[g][r] = fmaf(hv, w[g], ah[g][r]);
        }
      }
    }
    __syncthreads();  // every read of s_h and s_x for step t is done

    if (owns) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          // the reference's association: (x W_ih + b_ih) + h W_hh + b_hh
          z[g] = ((ax[g][r] + bias_x[g]) + ah[g][r]) + bias_h[g];
        }
        const float ig = sigmoid(z[0]);
        const float fg = sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float og = sigmoid(z[3]);
        const float c2 = fg * c[r] + ig * gg;
        const float h2 = og * tanhf(c2);
        const bool active = d == 0 ? t < len[r] : t >= T - len[r];
        if (active) {
          c[r] = c2;
          h[r] = h2;
        }
        s_h[r * H + u] = h[r];
        if (r < nrows) {
          const int64_t o = (((int64_t)t * 2 + d) * B + r0 + r) * H + u;
          outs[o] = h[r];
          if (cs) cs[o] = c[r];
        }
      }
    }
    if (t + 1 < T) stage_x(t + 1);
    __syncthreads();  // s_h and s_x hold step t + 1's operands
  }

  if (owns) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const int64_t o = ((int64_t)d * B + r0 + r) * H + u;
        h_n[o] = h[r];
        c_n[o] = c[r];
      }
    }
  }
}


// Backward of the layer: the reverse-time adjoint of one direction for one
// tile of kRows batch rows (the TPU's _bwdf_kernel).  Step t of a direction
// (its own time, T - 1 down to 0) recomputes the gates from x_t and the
// saved h_{t-1}, c_{t-1} (zero at t == 0, where no saved state exists), in
// exactly the forward's order of operations, then:
//   dh = dh_carry + douts[t];  dh_step, dc_step = (dh, dc) if the row is
//   active at t, else 0 (and the carry passes through unchanged);
//   dc2 = dc_step + dh_step * o * (1 - tanh(c2)^2);  dz = gate cotangents;
//   dh_{t-1} = dz @ W_hh^T (+ dh if inactive);  dc_{t-1} = dc2 * f (or dc);
//   dx_t = dz @ W_ih^T.
// A thread owns hidden unit u: it recomputes the unit's four gates for the
// tile's rows in registers and writes dz to shared memory; after a barrier
// every thread forms columns of dz @ [W_hh | W_ih]^T from the transposed
// weights (coalesced across threads).  The weight gradients need sums over
// all (t, b): the kernel writes dz and h_{t-1} in original time order, and
// csrc/wgrad.cu reduces them (dW_ih = x^T dz, dW_hh = h_prev^T dz,
// db = sum dz).  dx of each direction goes to its own stream, indexed by
// original time; the wrapper adds the two.
__global__ void __launch_bounds__(256) lstm_bidir_bwd_kernel(
    const float* __restrict__ x,        // (T, B, F)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // (2, F, 4H)
    const float* __restrict__ b_ih,     // (2, 4H)
    const float* __restrict__ w_hh,     // (2, H, 4H)
    const float* __restrict__ b_hh,     // (2, 4H)
    const float* __restrict__ w_ihT,    // (2, 4H, F)
    const float* __restrict__ w_hhT,    // (2, 4H, H)
    const float* __restrict__ outs,     // (T, 2, B, H)
    const float* __restrict__ cs,       // (T, 2, B, H)
    const float* __restrict__ douts,    // (T, 2, B, H) or nullptr
    const float* __restrict__ dh_n,     // (2, B, H)
    const float* __restrict__ dc_n,     // (2, B, H)
    float* __restrict__ dz_s,           // (2, T, B, 4H), original time
    float* __restrict__ hp_s,           // (2, T, B, H), original time
    float* __restrict__ dx_s,           // (2, T, B, F), original time
    int T, int B, int F, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* s_x = smem;                  // [kRows][F]
  float* s_hp = s_x + kRows * F;      // [kRows][H]
  float* s_dz = s_hp + kRows * H;     // [kRows][4H]
  float* s_dh = s_dz + kRows * G;     // [kRows][H]
  float* s_dc = s_dh + kRows * H;     // [kRows][H]

  const int d = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const float* wi = w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;
  const float* wiT = w_ihT + (int64_t)d * G * F;
  const float* whT = w_hhT + (int64_t)d * G * H;

  int len[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  for (int i = tid; i < kRows * H; i += nth) {
    const int r = i / H, u = i % H;
    const bool ok = r < nrows;
    const int64_t o = ((int64_t)d * B + r0 + r) * H + u;
    s_dh[i] = ok ? dh_n[o] : 0.f;
    s_dc[i] = ok ? dc_n[o] : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    const int tx = d == 0 ? t : T - 1 - t;  // original time of this step
    // stage x_t and h_{t-1} (zero at the first step)
    const float* xsrc = x + ((int64_t)tx * B + r0) * F;
    for (int i = tid; i < kRows * F; i += nth)
      s_x[i] = i < nrows * F ? xsrc[i] : 0.f;
    for (int i = tid; i < kRows * H; i += nth) {
      const int r = i / H, u = i % H;
      float v = 0.f;
      if (t > 0 && r < nrows)
        v = outs[(((int64_t)(t - 1) * 2 + d) * B + r0 + r) * H + u];
      s_hp[i] = v;
    }
    __syncthreads();

    for (int u = tid; u < H; u += nth) {
      float ax[4][kRows], ah[4][kRows];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ax[g][r] = 0.f;
          ah[g][r] = 0.f;
        }
#pragma unroll 8
      for (int k = 0; k < F; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wi + (int64_t)k * G + g * H + u);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = s_x[r * F + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
        }
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wh + (int64_t)k * G + g * H + u);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = s_hp[r * H + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ah[g][r] = fmaf(hv, w[g], ah[g][r]);
        }
      }
      float bx[4], bh[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        bx[g] = b_ih[d * G + g * H + u];
        bh[g] = b_hh[d * G + g * H + u];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i_rh = r * H + u;
        if (r >= nrows) {
#pragma unroll
          for (int g = 0; g < 4; ++g) s_dz[r * G + g * H + u] = 0.f;
          continue;
        }
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = ((ax[g][r] + bx[g]) + ah[g][r]) + bh[g];
        const float ig = sigmoid(z[0]);
        const float fg = sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float og = sigmoid(z[3]);
        const int64_t so = (((int64_t)t * 2 + d) * B + r0 + r) * H + u;
        const float c_prev =
            t > 0 ? cs[(((int64_t)(t - 1) * 2 + d) * B + r0 + r) * H + u]
                  : 0.f;
        const bool active = d == 0 ? t < len[r] : t >= T - len[r];
        const float c2 = active ? cs[so] : fg * c_prev + ig * gg;
        const float tc = tanhf(c2);
        float dh = s_dh[i_rh];
        if (douts) dh += douts[so];
        const float dc = s_dc[i_rh];
        const float dh_step = active ? dh : 0.f;
        const float dc_step = active ? dc : 0.f;
        const float do_ = dh_step * tc;
        const float dc2 = dc_step + dh_step * og * (1.f - tc * tc);
        const float df = dc2 * c_prev;
        const float di = dc2 * gg;
        const float dg = dc2 * ig;
        s_dz[r * G + u] = di * ig * (1.f - ig);
        s_dz[r * G + H + u] = df * fg * (1.f - fg);
        s_dz[r * G + 2 * H + u] = dg * (1.f - gg * gg);
        s_dz[r * G + 3 * H + u] = do_ * og * (1.f - og);
        s_dh[i_rh] = active ? 0.f : dh;  // pass-through part of dh_{t-1}
        s_dc[i_rh] = active ? dc2 * fg : dc;
      }
    }
    __syncthreads();  // s_dz complete

    // streams for the weight gradients, in original time
    for (int i = tid; i < nrows * G; i += nth) {
      const int r = i / G, j = i % G;
      dz_s[(((int64_t)d * T + tx) * B + r0 + r) * G + j] = s_dz[i];
    }
    for (int i = tid; i < nrows * H; i += nth) {
      const int r = i / H, u = i % H;
      hp_s[(((int64_t)d * T + tx) * B + r0 + r) * H + u] = s_hp[i];
    }
    // dh_{t-1} = pass-through + dz @ W_hh^T;  dx_t = dz @ W_ih^T
    for (int col = tid; col < H + F; col += nth) {
      const bool is_h = col < H;
      const int c = is_h ? col : col - H;
      const float* wT = is_h ? whT + c : wiT + c;
      const int ld = is_h ? H : F;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float w = __ldg(wT + (int64_t)j * ld);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(s_dz[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nrows) continue;
        if (is_h) {
          s_dh[r * H + c] += acc[r];
        } else {
          dx_s[(((int64_t)d * T + tx) * B + r0 + r) * F + c] = acc[r];
        }
      }
    }
    __syncthreads();  // s_dh holds dh_{t-1}; s_x, s_hp, s_dz free again
  }
}

}  // namespace

extern "C" {

long long abcd_lstm_bidir_smem_bytes(int F, int H) {
  return (long long)kRows * (F + H) * (long long)sizeof(float);
}

// Shapes as in the comment on the kernel; every tensor contiguous float32
// (lengths int32).  Launches on `stream` and returns cudaGetLastError().
int abcd_lstm_bidir_fwd(const float* x, const int* lengths, const float* w_ih,
                        const float* b_ih, const float* w_hh,
                        const float* b_hh, float* outs, float* cs,
                        float* h_n, float* c_n, int T, int B, int F, int H,
                        void* stream) {
  if (H < 1 || H > kMaxHidden) return (int)cudaErrorInvalidValue;
  const int smem = (int)abcd_lstm_bidir_smem_bytes(F, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bidir_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const dim3 block((H + 31) / 32 * 32);
  lstm_bidir_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, h_n, c_n, T, B, F, H);
  return (int)cudaGetLastError();
}

long long abcd_lstm_bidir_bwd_smem_bytes(int F, int H) {
  return (long long)kRows * (F + 7 * H) * (long long)sizeof(float);
}

// The layer's backward (see the comment on lstm_bidir_bwd_kernel).  Shapes
// as there; douts may be nullptr (a zero cotangent: the final layer's outs
// feed nothing).  Writes the dz, h_prev and per-direction dx streams, which
// the wrapper reduces with csrc/wgrad.cu.  Returns cudaGetLastError().
int abcd_lstm_bidir_bwd(const float* x, const int* lengths,
                        const float* w_ih, const float* b_ih,
                        const float* w_hh, const float* b_hh,
                        const float* w_ihT, const float* w_hhT,
                        const float* outs, const float* cs,
                        const float* douts, const float* dh_n,
                        const float* dc_n, float* dz_s, float* hp_s,
                        float* dx_s, int T, int B, int F, int H,
                        void* stream) {
  if (H < 1 || F < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)abcd_lstm_bidir_bwd_smem_bytes(F, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bidir_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, 2);
  lstm_bidir_bwd_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, cs, douts,
      dh_n, dc_n, dz_s, hp_s, dx_s, T, B, F, H);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
