// Masked GRU layers, forward and backward, written for Hopper (sm_90a).
//
// Two modes of the same kernels, chosen by a template flag (as in
// csrc/lstm.cu):
//
// - raw input (kProj = false): both directions of one layer over raw x.
//   Replaces seq2seq_abcd_vae_tpu/ops/gru_pallas.py:gru_layer_bidir_fused,
//   forward (`_fwdf_call` / `_fwdf_kernel`) and backward (`_bwdf_call` /
//   `_bwdf_kernel`).  The (T, 2, B, 3H) input projection never exists in
//   memory.  Direction 1 reads x in reversed time and is active on
//   [T - len, T) of its own flipped step axis
//   (seq2seq_abcd_vae_tpu/ops/_mask_utils.py:span_mask), so its outs are in
//   flipped time, as the TPU kernel writes them.
// - projected input (kProj = true): one direction over a precomputed
//   xp = x @ W_ih + b_ih (T, B, 3H).  Replaces
//   seq2seq_abcd_vae_tpu/ops/gru_pallas.py:gru_layer, forward (`_fwd_call`
//   / `_fwd_kernel`) and backward (`_bwd_call` / `_bwd_kernel`).  `reverse`
//   selects the span [T - len, T) (the caller flips xp in time, as
//   models/rnn.py:run_rnn_layer does).
//
// For each direction d and step t the kernels compute
//
//   xp = x_t @ W_ih[d] + b_ih[d] (raw) | xp[t] (projected)
//   hp = h @ W_hh[d] + b_hh[d]
//   r = sigmoid(xp_r + hp_r);  z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n);  h2 = (1 - z) * n + z * h
//
// (torch's GRU: gate order r, z, n, and b_hh inside the reset product, so
// the two biases stay apart).  outs holds the MASKED carry after each step
// (a row's h is frozen outside its span); a row of length 0 keeps h = 0.
// Every tensor is float32 and contiguous.
//
// What bounds it on the H100: the float32 operations are 2 * 3H * (F + H)
// (raw) or 2 * 3H * H (projected) multiply-adds per row, step and
// direction, but the time loop is sequential and every step needs all of a
// direction's weights (1.18 MB at H=256, F=129; 0.79 MB of W_hh alone), far
// more than one SM holds.  In this first design they are re-read from L2 at
// every step, so the L2 -> SM rate of the few SMs the kernels occupy bounds
// them, not the card's arithmetic (csrc/lstm.cu's design, with three gates
// instead of four).
//
// Design: the time loop lives inside the block (CUDA blocks run in no
// order).  One block per (direction, tile of R batch rows) owns all 3H gate
// columns of its rows; R (8, 4 or 2) is chosen at launch so that the block's
// shared memory fits the card.  In the forward each thread owns one or more
// hidden units (u = tid, tid + blockDim, ...) and accumulates a unit's three
// input and three recurrent pre-activations for the tile's rows in
// registers (the projected mode reads the input ones from xp); the new h
// goes to the other half of a double-buffered shared h, one barrier a step.
// The backward recomputes the gates from the saved h trajectory, forms the
// adjoint of `_gru_adjoint` (gru_pallas.py:67) and writes the per-step
// streams that csrc/wgrad.cu reduces into the weight gradients in a fixed
// order (no atomics).  The adjoint has two streams that differ in the
// candidate third: dxp = [drpre, dzpre, dnpre] (the cotangent of xp, which
// the projected mode returns as it is) and dhg = [drpre, dzpre, dnpre * r]
// (the cotangent of hp); the kernels write dxp whole and dhg's last third
// (dhn), and the wrapper reduces dW_hh from dxp's first two thirds and dhn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // forward: min(H rounded to 32, 512)
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Is step t of a row of length len active?  Direction 0: t < len;
// direction 1 (flipped time): t >= T - len.
__device__ __forceinline__ bool span_active(int t, int T, int len, bool rev) {
  return rev ? t >= T - len : t < len;
}

// The three input and three recurrent pre-activations of hidden unit u for
// the tile's rows: ax[g][r] = x_r @ W_ih[:, g*H+u] (raw mode; biases not
// added) or xp[r][g*H+u] (projected mode: `xp` points at the tile's first
// row of the step, rows 3H apart; 0 past the batch), ah[g][r] = h_r @
// W_hh[:, g*H+u].
template <int R, bool kProj>
__device__ __forceinline__ void gate_products(const float* __restrict__ wi,
                                              const float* __restrict__ wh,
                                              const float* s_x,
                                              const float* s_h,
                                              const float* __restrict__ xp,
                                              int nrows, int u, int F, int H,
                                              float ax[3][R],
                                              float ah[3][R]) {
  const int G = 3 * H;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      ax[g][r] = 0.f;
      ah[g][r] = 0.f;
    }
  if (kProj) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nrows)
#pragma unroll
        for (int g = 0; g < 3; ++g) ax[g][r] = xp[(int64_t)r * G + g * H + u];
  }
#pragma unroll 8
  for (int k = 0; k < (kProj ? 0 : F); ++k) {
    float w[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) w[g] = __ldg(wi + (int64_t)k * G + g * H + u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = s_x[r * F + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
    }
  }
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    float w[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) w[g] = __ldg(wh + (int64_t)k * G + g * H + u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hv = s_h[r * H + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) ah[g][r] = fmaf(hv, w[g], ah[g][r]);
    }
  }
}

template <int R, bool kProj>
__global__ void __launch_bounds__(kMaxThreads) gru_fwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | projected (T, B, 3H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, 3H) | unused
    const float* __restrict__ b_ih,     // raw (D, 3H) | unused
    const float* __restrict__ w_hh,     // (D, H, 3H)
    const float* __restrict__ b_hh,     // (D, 3H)
    float* __restrict__ outs,           // (T, D, B, H)
    float* __restrict__ h_n,            // (D, B, H)
    int T, int B, int F, int H, int reverse) {
  extern __shared__ float smem[];
  float* s_h = smem;                // [2][R][H]  h, double-buffered
  float* s_x = s_h + 2 * R * H;     // [2][R][F]  raw mode only

  const int D = gridDim.y;
  const int d = blockIdx.y;
  const bool rev = kProj ? reverse != 0 : d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int G = 3 * H;
  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;

  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  for (int i = tid; i < R * H; i += nth) s_h[i] = 0.f;

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
    const float* xp = kProj ? x + ((int64_t)t * B + r0) * G : nullptr;
    for (int u = tid; u < H; u += nth) {
      float ax[3][R], ah[3][R];
      gate_products<R, kProj>(wi, wh, xc, hc, xp, nrows, u, F, H, ax, ah);
      float bx[3], bh[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        bx[g] = kProj ? 0.f : b_ih[d * G + g * H + u];
        bh[g] = b_hh[d * G + g * H + u];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // the reference's association: (x W_ih + b_ih) + (h W_hh + b_hh),
        // xp + (h W_hh + b_hh) in the projected mode (its bx is 0)
        const float rg = sigmoid((ax[0][r] + bx[0]) + (ah[0][r] + bh[0]));
        const float zg = sigmoid((ax[1][r] + bx[1]) + (ah[1][r] + bh[1]));
        const float ng = tanhf((ax[2][r] + bx[2]) + rg * (ah[2][r] + bh[2]));
        const int i = r * H + u;
        float h = hc[i];
        const float h2 = (1.f - zg) * ng + zg * h;
        if (span_active(t, T, len[r], rev)) h = h2;
        hn[i] = h;
        if (r < nrows) outs[(((int64_t)t * D + d) * B + r0 + r) * H + u] = h;
      }
    }
    if (!kProj && t + 1 < T) stage_x(t + 1, cur ^ 1);
    __syncthreads();  // hn and the next x are complete; hc and xc are free
  }

  const float* hf = s_h + (T & 1) * R * H;
  for (int i = tid; i < nrows * H; i += nth)
    h_n[((int64_t)d * B + r0) * H + i] = hf[i];
}


// Backward: the reverse-time adjoint of one direction for one tile of R
// batch rows (the TPU's _bwdf_kernel).  Step t of a direction (its own time,
// T - 1 down to 0) recomputes r, z, n and hp_n from its input and the saved
// h_{t-1} (zero at t == 0) in the forward's order of operations, then
// (gru_pallas.py:_gru_adjoint):
//   dh = dh_carry + douts[t];  dh_step = dh if the row is active, else 0
//   dn = dh_step (1 - z);  dz = dh_step (h_{t-1} - n);  dnpre = dn (1 - n^2)
//   dr = dnpre hp_n;  drpre = dr r (1 - r);  dzpre = dz z (1 - z)
//   dxp = [drpre, dzpre, dnpre];  dhg = [drpre, dzpre, dnpre r]
//   dh_{t-1} = (dh if inactive, else 0) + dh_step z + dhg @ W_hh^T
//   raw mode: dx_t = dxp @ W_ih^T  (projected mode: dxp_t is the result).
// A thread owns hidden units and writes dxp and dhg's last third (dhn) to
// shared memory; after a barrier every thread forms columns of dhg @ W_hh^T
// (and, raw, of dxp @ W_ih^T) from the transposed weights (coalesced across
// threads).  The kernel writes the dxp, h_{t-1} and dhn streams (raw: in x's
// time order, with each direction's dx; projected: in xp's own time order,
// the dxp stream being the wrapper's dxp); the wrapper reduces
// dW_hh = h_prev^T [dxp_r, dxp_z, dhn], db_hh = sum of the same (and, raw,
// dW_ih = x^T dxp, db_ih = sum dxp) with csrc/wgrad.cu and adds the two
// directions' dx.
template <int R, bool kProj>
__global__ void __launch_bounds__(kBwdThreads) gru_bwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | projected (T, B, 3H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, 3H) | unused
    const float* __restrict__ b_ih,     // raw (D, 3H) | unused
    const float* __restrict__ w_hh,     // (D, H, 3H)
    const float* __restrict__ b_hh,     // (D, 3H)
    const float* __restrict__ w_ihT,    // raw (D, 3H, F) | unused
    const float* __restrict__ w_hhT,    // (D, 3H, H)
    const float* __restrict__ outs,     // (T, D, B, H)
    const float* __restrict__ douts,    // (T, D, B, H) or nullptr
    const float* __restrict__ dh_n,     // (D, B, H)
    float* __restrict__ dxp_s,          // (D, T, B, 3H)
    float* __restrict__ hp_s,           // (D, T, B, H)
    float* __restrict__ dhn_s,          // (D, T, B, H)
    float* __restrict__ dx_s,           // raw (D, T, B, F) | unused
    int T, int B, int F, int H, int reverse) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  const int Fx = kProj ? 0 : F;
  float* s_x = smem;                  // [R][F]  raw mode only
  float* s_hp = s_x + R * Fx;         // [R][H]
  float* s_dxp = s_hp + R * H;        // [R][3H]
  float* s_dhn = s_dxp + R * G;       // [R][H]
  float* s_dh = s_dhn + R * H;        // [R][H]

  const int D = gridDim.y;
  const int d = blockIdx.y;
  const bool rev = kProj ? reverse != 0 : d == 1;
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
    const int r = i / H;
    s_dh[i] = r < nrows ? dh_n[((int64_t)d * B + r0) * H + i] : 0.f;
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

    const float* xp = kProj ? x + ((int64_t)t * B + r0) * G : nullptr;
    for (int u = tid; u < H; u += nth) {
      float ax[3][R], ah[3][R];
      gate_products<R, kProj>(wi, wh, s_x, s_hp, xp, nrows, u, F, H, ax, ah);
      float bx[3], bh[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        bx[g] = kProj ? 0.f : b_ih[d * G + g * H + u];
        bh[g] = b_hh[d * G + g * H + u];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * H + u;
        if (r >= nrows) {
#pragma unroll
          for (int g = 0; g < 3; ++g) s_dxp[r * G + g * H + u] = 0.f;
          s_dhn[i] = 0.f;
          continue;
        }
        const float hn_pre = ah[2][r] + bh[2];
        const float rg = sigmoid((ax[0][r] + bx[0]) + (ah[0][r] + bh[0]));
        const float zg = sigmoid((ax[1][r] + bx[1]) + (ah[1][r] + bh[1]));
        const float ng = tanhf((ax[2][r] + bx[2]) + rg * hn_pre);
        const bool active = span_active(t, T, len[r], rev);
        float dh = s_dh[i];
        if (douts) dh += douts[(((int64_t)t * D + d) * B + r0 + r) * H + u];
        const float dh_step = active ? dh : 0.f;
        const float dn = dh_step * (1.f - zg);
        const float dz = dh_step * (s_hp[i] - ng);
        const float dnpre = dn * (1.f - ng * ng);
        const float dr = dnpre * hn_pre;
        s_dxp[r * G + u] = dr * rg * (1.f - rg);
        s_dxp[r * G + H + u] = dz * zg * (1.f - zg);
        s_dxp[r * G + 2 * H + u] = dnpre;
        s_dhn[i] = dnpre * rg;
        // pass-through part of dh_{t-1}
        s_dh[i] = (active ? 0.f : dh) + dh_step * zg;
      }
    }
    __syncthreads();  // s_dxp, s_dhn complete

    // streams for the weight gradients (and the projected mode's dxp)
    for (int i = tid; i < nrows * G; i += nth)
      dxp_s[(((int64_t)d * T + tx) * B + r0) * G + i] = s_dxp[i];
    for (int i = tid; i < nrows * H; i += nth) {
      const int64_t o = (((int64_t)d * T + tx) * B + r0) * H + i;
      hp_s[o] = s_hp[i];
      dhn_s[o] = s_dhn[i];
    }
    // dh_{t-1} += dhg @ W_hh^T;  raw mode: dx_t = dxp @ W_ih^T
    for (int col = tid; col < H + Fx; col += nth) {
      const bool is_h = col < H;
      const int c = is_h ? col : col - H;
      const float* wT = is_h ? whT + c : wiT + c;
      const int ld = is_h ? H : F;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < 2 * H; ++j) {
        const float w = __ldg(wT + (int64_t)j * ld);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dxp[r * G + j], w, acc[r]);
      }
      // the candidate third: dhn for the recurrent product, dnpre for x's
      const float* third = is_h ? s_dhn : s_dxp + 2 * H;
      const int ls = is_h ? H : G;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float w = __ldg(wT + (int64_t)(2 * H + j) * ld);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(third[r * ls + j], w, acc[r]);
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
    __syncthreads();  // s_dh holds dh_{t-1}; s_x, s_hp, s_dxp, s_dhn free
  }
}

// kind: 0 raw forward, 1 raw backward, 2 projected forward, 3 projected
// backward.
long long smem_bytes(int kind, int rows, int F, int H) {
  const bool proj = kind >= 2;
  const long long per_row = (kind % 2 == 0)
      ? 2LL * H + (proj ? 0 : 2LL * F)   // forward: h (x2), x (x2)
      : 6LL * H + (proj ? 0 : F);        // backward: hp, dxp (3H), dhn, dh, x
  return (long long)rows * per_row * (long long)sizeof(float);
}

template <int R>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)gru_fwd_kernel<R, false>;
    case 1: return (const void*)gru_bwd_kernel<R, false>;
    case 2: return (const void*)gru_fwd_kernel<R, true>;
    default: return (const void*)gru_bwd_kernel<R, true>;
  }
}

const void* kernel_for(int kind, int rows) {
  if (kind < 0 || kind > 3) return nullptr;
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

template <int R, bool kProj>
void launch_fwd(dim3 grid, int smem, cudaStream_t s, const float* x,
                const int* lengths, const float* w_ih, const float* b_ih,
                const float* w_hh, const float* b_hh, float* outs, float* h_n,
                int T, int B, int F, int H, int reverse) {
  gru_fwd_kernel<R, kProj><<<grid, fwd_threads(H), smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F, H, reverse);
}

template <bool kProj>
void dispatch_fwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  float* outs, float* h_n, int T, int B, int F, int H,
                  int reverse) {
  auto go = rows == 8   ? &launch_fwd<8, kProj>
            : rows == 4 ? &launch_fwd<4, kProj>
                        : &launch_fwd<2, kProj>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F,
     H, reverse);
}

template <int R, bool kProj>
void launch_bwd(dim3 grid, int smem, cudaStream_t s, const float* x,
                const int* lengths, const float* w_ih, const float* b_ih,
                const float* w_hh, const float* b_hh, const float* w_ihT,
                const float* w_hhT, const float* outs, const float* douts,
                const float* dh_n, float* dxp_s, float* hp_s, float* dhn_s,
                float* dx_s, int T, int B, int F, int H, int reverse) {
  gru_bwd_kernel<R, kProj><<<grid, kBwdThreads, smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, douts, dh_n,
      dxp_s, hp_s, dhn_s, dx_s, T, B, F, H, reverse);
}

template <bool kProj>
void dispatch_bwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  const float* w_ihT, const float* w_hhT, const float* outs,
                  const float* douts, const float* dh_n, float* dxp_s,
                  float* hp_s, float* dhn_s, float* dx_s, int T, int B, int F,
                  int H, int reverse) {
  auto go = rows == 8   ? &launch_bwd<8, kProj>
            : rows == 4 ? &launch_bwd<4, kProj>
                        : &launch_bwd<2, kProj>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs,
     douts, dh_n, dxp_s, hp_s, dhn_s, dx_s, T, B, F, H, reverse);
}

}  // namespace

extern "C" {

// The largest row tile (8, 4 or 2) whose shared memory fits the card for
// kernel `kind` (0 raw forward, 1 raw backward, 2 projected forward, 3
// projected backward); 0 when none does.
int abcd_gru_rows(int kind, int F, int H) {
  for (int rows = 8; rows >= 2; rows /= 2) {
    const void* fn = kernel_for(kind, rows);
    if (fn != nullptr && smem_bytes(kind, rows, F, H) <= smem_limit(fn))
      return rows;
  }
  return 0;
}

long long abcd_gru_smem_bytes(int kind, int rows, int F, int H) {
  return smem_bytes(kind, rows, F, H);
}

long long abcd_gru_smem_limit(int kind, int rows) {
  const void* fn = kernel_for(kind, rows);
  return fn == nullptr ? 0 : smem_limit(fn);
}

// Both directions over raw x (kind 0).  Shapes as in the comment on the
// kernel with D = 2.  Launches on `stream` and returns cudaGetLastError().
int abcd_gru_bidir_fwd(const float* x, const int* lengths, const float* w_ih,
                       const float* b_ih, const float* w_hh,
                       const float* b_hh, float* outs, float* h_n, int T,
                       int B, int F, int H, int rows, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(0, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_fwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F, H, 0);
  return (int)cudaGetLastError();
}

// One direction over xp (T, B, 3H) (kind 2): D = 1, `reverse` selects the
// flipped span.
int abcd_gru_fwd(const float* xp, const int* lengths, const float* w_hh,
                 const float* b_hh, float* outs, float* h_n, int T, int B,
                 int H, int reverse, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(2, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_fwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, outs, h_n, T, B, 0, H,
                     reverse);
  return (int)cudaGetLastError();
}

// The raw layer's backward (kind 1; see gru_bwd_kernel).  douts may be
// nullptr (a zero cotangent: the final layer's outs feed nothing).  Writes
// the dxp, h_prev and dhn streams and each direction's dx, which the
// wrapper reduces with csrc/wgrad.cu.
int abcd_gru_bidir_bwd(const float* x, const int* lengths, const float* w_ih,
                       const float* b_ih, const float* w_hh,
                       const float* b_hh, const float* w_ihT,
                       const float* w_hhT, const float* outs,
                       const float* douts, const float* dh_n, float* dxp_s,
                       float* hp_s, float* dhn_s, float* dx_s, int T, int B,
                       int F, int H, int rows, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(1, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_bwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, douts, dh_n,
                      dxp_s, hp_s, dhn_s, dx_s, T, B, F, H, 0);
  return (int)cudaGetLastError();
}

// The projected layer's backward (kind 3): writes dxp (T, B, 3H) in xp's
// time order and the h_prev and dhn streams for dW_hh and db_hh.  douts may
// be nullptr.
int abcd_gru_bwd(const float* xp, const int* lengths, const float* w_hh,
                 const float* b_hh, const float* w_hhT, const float* outs,
                 const float* douts, const float* dh_n, float* dxp,
                 float* hp_s, float* dhn_s, int T, int B, int H, int reverse,
                 int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(3, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_bwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, nullptr, w_hhT, outs,
                     douts, dh_n, dxp, hp_s, dhn_s, nullptr, T, B, 0, H,
                     reverse);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
