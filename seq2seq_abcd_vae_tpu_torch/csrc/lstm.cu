// Masked LSTM layers, forward and backward, written for Hopper (sm_90a).
//
// Two modes of the same kernels, chosen by a template flag:
//
// - raw input (kProj = false): both directions of one layer over raw x.
//   Replaces seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer_bidir_fused,
//   forward (`_fwdf_call` / `_fwdf_kernel`) and backward (`_bwdf_call` /
//   `_bwdf_kernel`).  For each direction d and step t the kernel computes
//   x_t @ W_ih[d] + b_ih[d] + h @ W_hh[d] + b_hh[d] itself (the (T, 2, B, 4H)
//   input projection never exists in memory).  Direction 1 reads x in
//   reversed time and is active on [T - len, T) of its own flipped step
//   axis (seq2seq_abcd_vae_tpu/ops/_mask_utils.py:span_mask), so its outs
//   are in flipped time, as the TPU kernel writes them.
// - projected input (kProj = true): a precomputed xp = x @ W_ih + b_ih.
//   One direction over xp (T, B, 4H) (kinds 2 and 3) replaces
//   seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer, forward
//   (`_fwd_call` / `_fwd_kernel`) and backward (`_bwd_call` /
//   `_bwd_kernel`); `reverse` selects the span [T - len, T) (the caller
//   flips xp in time, as models/rnn.py:run_rnn_layer does).  Both
//   directions over xp (T, 2, B, 4H) in one launch (kPair = true, kinds 4
//   and 5) replace lstm_pallas.py:lstm_layer_bidir, forward (`_fwd2_call` /
//   `_fwd2_kernel`) and backward (`_bwd2_call` / `_bwd2_kernel`): the TPU
//   kernel steps both directions' time loops in one grid, and here the two
//   directions are the y blocks of one launch; direction 1's xp is already
//   flipped in time and active on [T - len, T), as in the raw mode.  The
//   backward's dxp is its dz stream (direction-major, (D, T, B, 4H)).
//
// In both modes outs holds the MASKED carry h after each step (a row's
// carries are frozen outside its span), gates are in torch order
// (i, f, g, o), and every tensor is float32 and contiguous.
//
// What bounds it on the H100: the float32 operations are 2 * 4H * (F + H)
// (raw) or 2 * 4H * H (projected) multiply-adds per row, step and direction,
// but the time loop is sequential and every step needs all of the weights
// (1.58 MB per direction at H=256, F=129), far more than one SM holds.  In
// this first design the weights are re-read from L2 at every step, so the
// kernels are bound by the L2 -> SM rate of the few SMs they occupy, not by
// the card's arithmetic.
//
// Design: CUDA blocks run in no order, so the time loop lives inside the
// block, as the TPU's sequential grid axis did.  One block per (direction,
// tile of R batch rows) owns all 4H gate columns of its rows; R (8, 4 or 2)
// is chosen at launch so that the block's shared memory fits the card.  In
// the forward each thread owns one or more hidden units (u = tid, tid +
// blockDim, ...): it accumulates a unit's four gates for the tile's rows in
// registers, so no gate leaves the thread, and writes the new h into the
// other half of a double-buffered shared h (c lives in shared memory beside
// it, touched only by its unit's thread): one barrier a step.  Splitting
// W_hh across a thread-block cluster (or wgmma) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // forward: min(H rounded to 32, 512)
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Is step t of a row of length len active?  Forward order: t < len;
// reversed (flipped time): t >= T - len.
__device__ __forceinline__ bool span_active(int t, int T, int len, bool rev) {
  return rev ? t >= T - len : t < len;
}

template <int R, bool kProj, bool kPair = false>
__global__ void __launch_bounds__(kMaxThreads) lstm_fwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | xp (T[, 2], B, 4H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, 4H) | unused
    const float* __restrict__ b_ih,     // raw (D, 4H) | unused
    const float* __restrict__ w_hh,     // (D, H, 4H)
    const float* __restrict__ b_hh,     // (D, 4H)
    float* __restrict__ outs,           // (T, D, B, H)
    float* __restrict__ cs,             // (T, D, B, H) or nullptr
    float* __restrict__ h_n,            // (D, B, H)
    float* __restrict__ c_n,            // (D, B, H)
    int T, int B, int F, int H, int reverse) {
  extern __shared__ float smem[];
  float* s_h = smem;                // [2][R][H]  h, double-buffered
  float* s_c = s_h + 2 * R * H;     // [R][H]
  float* s_x = s_c + R * H;         // [2][R][F]  raw mode only

  const int D = gridDim.y;
  const int d = blockIdx.y;
  // the flipped span: direction 1 of a pair, or the one direction when
  // the caller asks for it
  const bool rev = (kProj && !kPair) ? reverse != 0 : d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int G = 4 * H;
  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;

  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  for (int i = tid; i < R * H; i += nth) {
    s_h[i] = 0.f;
    s_c[i] = 0.f;
  }

  // x rows of step t of this direction into buffer `buf` (zeros past the
  // batch).
  auto stage_x = [&](int t, int buf) {
    const int tx = d == 0 ? t : T - 1 - t;
    const float* src = x + ((int64_t)tx * B + r0) * F;
    float* dst = s_x + buf * R * F;
    for (int i = tid; i < R * F; i += nth) dst[i] = i < nrows * F ? src[i] : 0.f;
  };
  if (!kProj) stage_x(0, 0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* hc = s_h + cur * R * H;
    float* hn = s_h + (cur ^ 1) * R * H;
    const float* xc = s_x + cur * R * F;
    for (int u = tid; u < H; u += nth) {
      float ax[4][R], ah[4][R];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ax[g][r] = 0.f;
          ah[g][r] = 0.f;
        }
      if (kProj) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nrows) {
            const float* xp =
                x + (kPair ? ((int64_t)t * 2 + d) * B + r0 + r
                           : (int64_t)t * B + r0 + r) * G + u;
#pragma unroll
            for (int g = 0; g < 4; ++g) ax[g][r] = xp[g * H];
          }
        }
      } else {
#pragma unroll 8
        for (int k = 0; k < F; ++k) {
          float w[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g] = __ldg(wi + (int64_t)k * G + g * H + u);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xv = xc[r * F + k];
#pragma unroll
            for (int g = 0; g < 4; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
          }
        }
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wh + (int64_t)k * G + g * H + u);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hc[r * H + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ah[g][r] = fmaf(hv, w[g], ah[g][r]);
        }
      }
      float bx[4], bh[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        bx[g] = kProj ? 0.f : b_ih[d * G + g * H + u];
        bh[g] = b_hh[d * G + g * H + u];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          // the reference's association: (x W_ih + b_ih) + h W_hh + b_hh,
          // and xp + h W_hh + b_hh in the projected mode
          z[g] = kProj ? (ax[g][r] + ah[g][r]) + bh[g]
                       : ((ax[g][r] + bx[g]) + ah[g][r]) + bh[g];
        }
        const float ig = sigmoid(z[0]);
        const float fg = sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float og = sigmoid(z[3]);
        const int i = r * H + u;
        float c = s_c[i], h = hc[i];
        const float c2 = fg * c + ig * gg;
        const float h2 = og * tanhf(c2);
        if (span_active(t, T, len[r], rev)) {
          c = c2;
          h = h2;
        }
        hn[i] = h;
        s_c[i] = c;
        if (r < nrows) {
          const int64_t o = (((int64_t)t * D + d) * B + r0 + r) * H + u;
          outs[o] = h;
          if (cs) cs[o] = c;
        }
      }
    }
    if (!kProj && t + 1 < T) stage_x(t + 1, cur ^ 1);
    __syncthreads();  // hn and the next x are complete; hc and xc are free
  }

  const float* hf = s_h + (T & 1) * R * H;
  for (int i = tid; i < nrows * H; i += nth) {
    const int64_t o = ((int64_t)d * B + r0) * H + i;
    h_n[o] = hf[i];
    c_n[o] = s_c[i];
  }
}


// Backward of the layer: the reverse-time adjoint of one direction for one
// tile of R batch rows (the TPU's _bwdf_kernel / _bwd_kernel).  Step t of a
// direction (its own time, T - 1 down to 0) recomputes the gates from its
// input and the saved h_{t-1}, c_{t-1} (zero at t == 0, where no saved state
// exists), in exactly the forward's order of operations, then:
//   dh = dh_carry + douts[t];  dh_step, dc_step = (dh, dc) if the row is
//   active at t, else 0 (and the carry passes through unchanged);
//   dc2 = dc_step + dh_step * o * (1 - tanh(c2)^2);  dz = gate cotangents;
//   dh_{t-1} = dz @ W_hh^T (+ dh if inactive);  dc_{t-1} = dc2 * f (or dc);
//   raw mode: dx_t = dz @ W_ih^T  (projected mode: dxp_t = dz).
// A thread owns hidden units u = tid, tid + blockDim, ...: it recomputes a
// unit's four gates for the tile's rows in registers and writes dz to shared
// memory; after a barrier every thread forms columns of dz @ [W_hh | W_ih]^T
// from the transposed weights (coalesced across threads).  The weight
// gradients need sums over all (t, b): the kernel writes dz and h_{t-1} as
// streams, and csrc/wgrad.cu reduces them (dW_ih = x^T dz, dW_hh =
// h_prev^T dz, db = sum dz).  Raw mode writes the streams and each
// direction's dx in original time (the wrapper adds the two dx); projected
// mode writes them in xp's own time order, (D, T, B, .) direction-major.
template <int R, bool kProj, bool kPair = false>
__global__ void __launch_bounds__(kBwdThreads) lstm_bwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | xp (T[, 2], B, 4H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, 4H) | unused
    const float* __restrict__ b_ih,     // raw (D, 4H) | unused
    const float* __restrict__ w_hh,     // (D, H, 4H)
    const float* __restrict__ b_hh,     // (D, 4H)
    const float* __restrict__ w_ihT,    // raw (D, 4H, F) | unused
    const float* __restrict__ w_hhT,    // (D, 4H, H)
    const float* __restrict__ outs,     // (T, D, B, H)
    const float* __restrict__ cs,       // (T, D, B, H)
    const float* __restrict__ douts,    // (T, D, B, H) or nullptr
    const float* __restrict__ dh_n,     // (D, B, H)
    const float* __restrict__ dc_n,     // (D, B, H)
    float* __restrict__ dz_s,           // (D, T, B, 4H)
    float* __restrict__ hp_s,           // (D, T, B, H)
    float* __restrict__ dx_s,           // raw (D, T, B, F) | unused
    int T, int B, int F, int H, int reverse) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int Fx = kProj ? 0 : F;
  float* s_x = smem;                  // [R][F]  raw mode only
  float* s_hp = s_x + R * Fx;         // [R][H]
  float* s_dz = s_hp + R * H;         // [R][4H]
  float* s_dh = s_dz + R * G;         // [R][H]
  float* s_dc = s_dh + R * H;         // [R][H]

  const int D = gridDim.y;
  const int d = blockIdx.y;
  const bool rev = (kProj && !kPair) ? reverse != 0 : d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;
  const float* wiT = kProj ? nullptr : w_ihT + (int64_t)d * G * F;
  const float* whT = w_hhT + (int64_t)d * G * H;

  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  for (int i = tid; i < R * H; i += nth) {
    const int r = i / H, u = i % H;
    const bool ok = r < nrows;
    const int64_t o = ((int64_t)d * B + r0 + r) * H + u;
    s_dh[i] = ok ? dh_n[o] : 0.f;
    s_dc[i] = ok ? dc_n[o] : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    // time of this step in the streams' order
    const int tx = (kProj || d == 0) ? t : T - 1 - t;
    if (!kProj) {
      const float* xsrc = x + ((int64_t)tx * B + r0) * F;
      for (int i = tid; i < R * F; i += nth)
        s_x[i] = i < nrows * F ? xsrc[i] : 0.f;
    }
    for (int i = tid; i < R * H; i += nth) {
      const int r = i / H, u = i % H;
      float v = 0.f;
      if (t > 0 && r < nrows)
        v = outs[(((int64_t)(t - 1) * D + d) * B + r0 + r) * H + u];
      s_hp[i] = v;
    }
    __syncthreads();

    for (int u = tid; u < H; u += nth) {
      float ax[4][R], ah[4][R];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ax[g][r] = 0.f;
          ah[g][r] = 0.f;
        }
      if (kProj) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < nrows) {
            const float* xp =
                x + (kPair ? ((int64_t)t * 2 + d) * B + r0 + r
                           : (int64_t)t * B + r0 + r) * G + u;
#pragma unroll
            for (int g = 0; g < 4; ++g) ax[g][r] = xp[g * H];
          }
        }
      } else {
#pragma unroll 8
        for (int k = 0; k < F; ++k) {
          float w[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g] = __ldg(wi + (int64_t)k * G + g * H + u);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xv = s_x[r * F + k];
#pragma unroll
            for (int g = 0; g < 4; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
          }
        }
      }
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = __ldg(wh + (int64_t)k * G + g * H + u);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = s_hp[r * H + k];
#pragma unroll
          for (int g = 0; g < 4; ++g) ah[g][r] = fmaf(hv, w[g], ah[g][r]);
        }
      }
      float bx[4], bh[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        bx[g] = kProj ? 0.f : b_ih[d * G + g * H + u];
        bh[g] = b_hh[d * G + g * H + u];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i_rh = r * H + u;
        if (r >= nrows) {
#pragma unroll
          for (int g = 0; g < 4; ++g) s_dz[r * G + g * H + u] = 0.f;
          continue;
        }
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          z[g] = kProj ? (ax[g][r] + ah[g][r]) + bh[g]
                       : ((ax[g][r] + bx[g]) + ah[g][r]) + bh[g];
        const float ig = sigmoid(z[0]);
        const float fg = sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float og = sigmoid(z[3]);
        const int64_t so = (((int64_t)t * D + d) * B + r0 + r) * H + u;
        const float c_prev =
            t > 0 ? cs[(((int64_t)(t - 1) * D + d) * B + r0 + r) * H + u]
                  : 0.f;
        const bool active = span_active(t, T, len[r], rev);
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

    // streams for the weight gradients (and the projected mode's dxp)
    for (int i = tid; i < nrows * G; i += nth) {
      const int r = i / G, j = i % G;
      dz_s[(((int64_t)d * T + tx) * B + r0 + r) * G + j] = s_dz[i];
    }
    for (int i = tid; i < nrows * H; i += nth) {
      const int r = i / H, u = i % H;
      hp_s[(((int64_t)d * T + tx) * B + r0 + r) * H + u] = s_hp[i];
    }
    // dh_{t-1} = pass-through + dz @ W_hh^T;  raw mode: dx_t = dz @ W_ih^T
    for (int col = tid; col < H + Fx; col += nth) {
      const bool is_h = col < H;
      const int c = is_h ? col : col - H;
      const float* wT = is_h ? whT + c : wiT + c;
      const int ld = is_h ? H : F;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float w = __ldg(wT + (int64_t)j * ld);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dz[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
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

// kind: 0 raw forward, 1 raw backward, 2 projected forward, 3 projected
// backward (one direction), 4 projected forward, 5 projected backward (both
// directions in one launch: the kPair kernels, on a grid two blocks high).
long long smem_bytes(int kind, int rows, int F, int H) {
  const bool proj = kind >= 2;
  const long long per_row = (kind % 2 == 0)
      ? 3LL * H + (proj ? 0 : 2LL * F)   // forward: h (x2), c, x (x2)
      : 7LL * H + (proj ? 0 : F);        // backward: hp, dz (4H), dh, dc, x
  return (long long)rows * per_row * (long long)sizeof(float);
}

template <int R>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)lstm_fwd_kernel<R, false>;
    case 1: return (const void*)lstm_bwd_kernel<R, false>;
    case 2: return (const void*)lstm_fwd_kernel<R, true>;
    case 3: return (const void*)lstm_bwd_kernel<R, true>;
    case 4: return (const void*)lstm_fwd_kernel<R, true, true>;
    case 5: return (const void*)lstm_bwd_kernel<R, true, true>;
    default: return nullptr;
  }
}

const void* kernel_for(int kind, int rows) {
  switch (rows) {
    case 8: return kernel_of<8>(kind);
    case 4: return kernel_of<4>(kind);
    case 2: return kernel_of<2>(kind);
    default: return nullptr;
  }
}

// Dynamic shared memory a block of this kernel may ask for on the current
// card: the opt-in maximum less the kernel's static shared memory.
long long smem_limit(const void* fn) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, fn) != cudaSuccess) return 0;
  return (long long)optin - (long long)a.sharedSizeBytes;
}

// Sets the kernel's shared-memory allowance; cudaErrorInvalidValue when the
// row tile is not one of 8, 4, 2 or its shared memory does not fit.
cudaError_t prepare(int kind, int rows, int F, int H, int* smem_out) {
  const void* fn = kernel_for(kind, rows);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(kind, rows, F, H);
  if (smem > smem_limit(fn)) return cudaErrorInvalidValue;
  *smem_out = (int)smem;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int fwd_threads(int H) {
  const int t = (H + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <int R, bool kProj, bool kPair>
void launch_fwd(dim3 grid, int smem, cudaStream_t s, const float* x,
                const int* lengths, const float* w_ih, const float* b_ih,
                const float* w_hh, const float* b_hh, float* outs, float* cs,
                float* h_n, float* c_n, int T, int B, int F, int H,
                int reverse) {
  lstm_fwd_kernel<R, kProj, kPair><<<grid, fwd_threads(H), smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, h_n, c_n, T, B, F, H,
      reverse);
}

template <bool kProj, bool kPair = false>
void dispatch_fwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  float* outs, float* cs, float* h_n, float* c_n, int T,
                  int B, int F, int H, int reverse) {
  auto go = rows == 8   ? &launch_fwd<8, kProj, kPair>
            : rows == 4 ? &launch_fwd<4, kProj, kPair>
                        : &launch_fwd<2, kProj, kPair>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, h_n, c_n,
     T, B, F, H, reverse);
}

template <int R, bool kProj, bool kPair>
void launch_bwd(dim3 grid, int smem, cudaStream_t s, const float* x,
                const int* lengths, const float* w_ih, const float* b_ih,
                const float* w_hh, const float* b_hh, const float* w_ihT,
                const float* w_hhT, const float* outs, const float* cs,
                const float* douts, const float* dh_n, const float* dc_n,
                float* dz_s, float* hp_s, float* dx_s, int T, int B, int F,
                int H, int reverse) {
  lstm_bwd_kernel<R, kProj, kPair><<<grid, kBwdThreads, smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, cs, douts,
      dh_n, dc_n, dz_s, hp_s, dx_s, T, B, F, H, reverse);
}

template <bool kProj, bool kPair = false>
void dispatch_bwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  const float* w_ihT, const float* w_hhT, const float* outs,
                  const float* cs, const float* douts, const float* dh_n,
                  const float* dc_n, float* dz_s, float* hp_s, float* dx_s,
                  int T, int B, int F, int H, int reverse) {
  auto go = rows == 8   ? &launch_bwd<8, kProj, kPair>
            : rows == 4 ? &launch_bwd<4, kProj, kPair>
                        : &launch_bwd<2, kProj, kPair>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs,
     cs, douts, dh_n, dc_n, dz_s, hp_s, dx_s, T, B, F, H, reverse);
}

}  // namespace

extern "C" {

// The largest row tile (8, 4 or 2) whose shared memory fits the card for
// kernel `kind` (0 raw forward, 1 raw backward, 2 / 4 projected forward of
// one / both directions, 3 / 5 their backwards); 0 when none does.
int abcd_lstm_rows(int kind, int F, int H) {
  for (int rows = 8; rows >= 2; rows /= 2) {
    const void* fn = kernel_for(kind, rows);
    if (fn != nullptr && smem_bytes(kind, rows, F, H) <= smem_limit(fn))
      return rows;
  }
  return 0;
}

long long abcd_lstm_smem_bytes(int kind, int rows, int F, int H) {
  return smem_bytes(kind, rows, F, H);
}

long long abcd_lstm_smem_limit(int kind, int rows) {
  const void* fn = kernel_for(kind, rows);
  return fn == nullptr ? 0 : smem_limit(fn);
}

// Both directions over raw x (kind 0).  Shapes as in the comment on the
// kernel with D = 2; cs may be nullptr.  Launches on `stream` and returns
// cudaGetLastError().
int abcd_lstm_bidir_fwd(const float* x, const int* lengths, const float* w_ih,
                        const float* b_ih, const float* w_hh,
                        const float* b_hh, float* outs, float* cs,
                        float* h_n, float* c_n, int T, int B, int F, int H,
                        int rows, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(0, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_fwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, outs, cs, h_n, c_n, T, B, F, H,
                      0);
  return (int)cudaGetLastError();
}

// One direction over xp (T, B, 4H) (kind 2): D = 1, `reverse` selects the
// flipped span.  cs may be nullptr.
int abcd_lstm_fwd(const float* xp, const int* lengths, const float* w_hh,
                  const float* b_hh, float* outs, float* cs, float* h_n,
                  float* c_n, int T, int B, int H, int reverse, int rows,
                  void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(2, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_fwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, outs, cs, h_n, c_n, T, B,
                     0, H, reverse);
  return (int)cudaGetLastError();
}

// The raw layer's backward (kind 1; see lstm_bwd_kernel).  douts may be
// nullptr (a zero cotangent: the final layer's outs feed nothing).  Writes
// the dz, h_prev and per-direction dx streams, which the wrapper reduces
// with csrc/wgrad.cu.
int abcd_lstm_bidir_bwd(const float* x, const int* lengths,
                        const float* w_ih, const float* b_ih,
                        const float* w_hh, const float* b_hh,
                        const float* w_ihT, const float* w_hhT,
                        const float* outs, const float* cs,
                        const float* douts, const float* dh_n,
                        const float* dc_n, float* dz_s, float* hp_s,
                        float* dx_s, int T, int B, int F, int H, int rows,
                        void* stream) {
  if (H < 1 || F < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(1, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_bwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, cs, douts,
                      dh_n, dc_n, dz_s, hp_s, dx_s, T, B, F, H, 0);
  return (int)cudaGetLastError();
}

// The projected layer's backward (kind 3): writes dxp (= the dz stream,
// (T, B, 4H) in xp's time order) and the h_prev stream for dW_hh.
int abcd_lstm_bwd(const float* xp, const int* lengths, const float* w_hh,
                  const float* b_hh, const float* w_hhT, const float* outs,
                  const float* cs, const float* douts, const float* dh_n,
                  const float* dc_n, float* dxp, float* hp_s, int T, int B,
                  int H, int reverse, int rows, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(3, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_bwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, nullptr, w_hhT, outs, cs,
                     douts, dh_n, dc_n, dxp, hp_s, nullptr, T, B, 0, H,
                     reverse);
  return (int)cudaGetLastError();
}

// Both directions over xp (T, 2, B, 4H) in one launch (kind 4): direction
// 1's xp already flipped in time, active on [T - len, T).  outs / cs
// (T, 2, B, H), h_n / c_n (2, B, H); cs may be nullptr.
int abcd_lstm_bidir_proj_fwd(const float* xp, const int* lengths,
                             const float* w_hh, const float* b_hh,
                             float* outs, float* cs, float* h_n, float* c_n,
                             int T, int B, int H, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(4, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_fwd<true, true>(rows, grid, smem, (cudaStream_t)stream, xp,
                           lengths, nullptr, nullptr, w_hh, b_hh, outs, cs,
                           h_n, c_n, T, B, 0, H, 0);
  return (int)cudaGetLastError();
}

// Its backward (kind 5), one launch for both directions: writes the dz
// stream (2, T, B, 4H), which is dxp direction-major, and the h_prev
// stream (2, T, B, H) for each direction's dW_hh.
int abcd_lstm_bidir_proj_bwd(const float* xp, const int* lengths,
                             const float* w_hh, const float* b_hh,
                             const float* w_hhT, const float* outs,
                             const float* cs, const float* douts,
                             const float* dh_n, const float* dc_n,
                             float* dz_s, float* hp_s, int T, int B, int H,
                             int rows, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(5, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_bwd<true, true>(rows, grid, smem, (cudaStream_t)stream, xp,
                           lengths, nullptr, nullptr, w_hh, b_hh, nullptr,
                           w_hhT, outs, cs, douts, dh_n, dc_n, dz_s, hp_s,
                           nullptr, T, B, 0, H, 0);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
