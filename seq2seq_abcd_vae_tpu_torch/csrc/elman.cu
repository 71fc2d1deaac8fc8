// Masked Elman (tanh RNN) layers, forward and backward, written for Hopper
// (sm_90a); with a leak below 1 they are the echo-state (ESN) layers.
//
// Two modes of the same kernels, chosen by a template flag (as in
// csrc/lstm.cu):
//
// - raw input (kProj = false): both directions of one layer over raw x.
//   Replaces seq2seq_abcd_vae_tpu/ops/elman_pallas.py:rnn_layer_bidir_fused,
//   forward (`_fwdf_call` / `_fwdf_kernel`) and backward (`_bwdf_call` /
//   `_bwdf_kernel`).  Direction 1 reads x in reversed time and is active on
//   [T - len, T) of its own flipped step axis
//   (seq2seq_abcd_vae_tpu/ops/_mask_utils.py:span_mask), so its outs are in
//   flipped time, as the TPU kernel writes them.
// - projected input (kProj = true): one direction over a precomputed
//   xp = x @ W_ih + b_ih (T, B, H) (the ESN's: x @ W_ih).  Replaces
//   seq2seq_abcd_vae_tpu/ops/elman_pallas.py:rnn_layer, forward
//   (`_fwd_call` / `_fwd_kernel`) and backward (`_bwd_call` /
//   `_bwd_kernel`).  `reverse` selects the span [T - len, T) (the caller
//   flips xp in time, as models/rnn.py:run_rnn_layer does); the backward's
//   dxp is its dpre stream.
//
// For each direction d and step t the kernels compute
//
//   u  = tanh((x_t @ W_ih[d] + b_ih[d]) + h @ W_hh[d] + b_hh[d])   (raw)
//   u  = tanh((xp[t] + h @ W_hh) + b_hh)                         (projected)
//   h2 = (1 - leak) * h + leak * u
//
// (torch.nn.RNN with the tanh nonlinearity; the ESN of the reference,
// ABCD-VAE/modules/model.py:444,529-531, passes zero biases and its leak).
// `leak` is a runtime float.  At leak == 1 the update is exactly the plain
// Elman cell's h2 = u that the TPU kernel compiles to: (1 - 1) * h is +-0
// for every finite h and adding it to u gives u, with or without a fused
// multiply-add, and h is finite since it is a convex mix of tanh values.
// outs holds the MASKED carry after each step (a row's h is frozen outside
// its span); a row of length 0 keeps h = 0.  Every tensor is float32 and
// contiguous.
//
// What bounds it on the H100: the float32 operations are 2 * H * (F + H)
// (raw) or 2 * H * H (projected) multiply-adds per row, step and direction,
// but the time loop is sequential and every step needs all of a
// direction's weights (0.39 MB at H=256, F=129; 0.26 MB of W_hh alone),
// more than one SM holds next to its working set.  In this first design
// they are re-read from L2 at every step (csrc/gru.cu's design, with one
// gate instead of three), so the L2 -> SM rate of the few SMs the kernels
// occupy bounds them, not the card's arithmetic.
//
// Design: the time loop lives inside the block (CUDA blocks run in no
// order).  One block per (direction, tile of R batch rows) owns all H
// columns of its rows; R (8, 4 or 2) is chosen at launch so that the
// block's shared memory fits the card.  In the forward each thread owns one
// or more hidden units (u = tid, tid + blockDim, ...) and accumulates a
// unit's input and recurrent pre-activations for the tile's rows in
// registers (the projected mode reads the input one from xp); the new h
// goes to the other half of a double-buffered shared h, one barrier a step.
// The backward recomputes u from the saved h trajectory, forms the adjoint
// of `_bwdf_kernel` / `_bwd_kernel` and writes the per-step streams that
// csrc/wgrad.cu reduces into the weight gradients in a fixed order (no
// atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // forward: min(H rounded to 32, 512)
constexpr int kBwdThreads = 256;

// Is step t of a row of length len active?  Direction 0: t < len;
// direction 1 (flipped time): t >= T - len.
__device__ __forceinline__ bool span_active(int t, int T, int len, bool rev) {
  return rev ? t >= T - len : t < len;
}

// acc[r] += s[r][k] * w[k][u] over k < K for the tile's rows, w row-major
// with row stride H.  The weights come in chunks of kChunk loads issued
// before their products, so a thread has kChunk L2 reads in flight and pays
// the L2 latency once a chunk rather than once a k: with one gate block per
// unit, a plain loop leaves one load in flight and the step waits on the
// latency (F + H) times.  The products keep k's order.
constexpr int kChunk = 16;

template <int R>
__device__ __forceinline__ void dot_column(const float* __restrict__ w,
                                           const float* s, int K, int H,
                                           int u, float acc[R]) {
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float wv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      wv[j] = k0 + j < K ? __ldg(w + (int64_t)(k0 + j) * H + u) : 0.f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (k0 + j < K) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(s[r * K + k0 + j], wv[j], acc[r]);
      }
    }
  }
}

// The pre-activation of hidden unit u for the tile's rows, in the TPU
// kernels' association: ((x_r @ W_ih[:, u] + b_ih[u]) + h_r @ W_hh[:, u])
// + b_hh[u] (raw mode), (xp[r][u] + h_r @ W_hh[:, u]) + b_hh[u] (projected
// mode: `xp` points at the tile's first row of the step, rows H apart; 0
// past the batch; bx is 0).
template <int R, bool kProj>
__device__ __forceinline__ void pre_activation(const float* __restrict__ wi,
                                               const float* __restrict__ wh,
                                               float bx, float bh,
                                               const float* s_x,
                                               const float* s_h,
                                               const float* __restrict__ xp,
                                               int nrows, int u, int F,
                                               int H, float pre[R]) {
  float ax[R], ah[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ax[r] = 0.f;
    ah[r] = 0.f;
  }
  if (kProj) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nrows) ax[r] = xp[(int64_t)r * H + u];
  } else {
    dot_column<R>(wi, s_x, F, H, u, ax);
  }
  dot_column<R>(wh, s_h, H, H, u, ah);
#pragma unroll
  for (int r = 0; r < R; ++r) pre[r] = ((ax[r] + bx) + ah[r]) + bh;
}

template <int R, bool kProj>
__global__ void __launch_bounds__(kMaxThreads) elman_fwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | projected (T, B, H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, H) | unused
    const float* __restrict__ b_ih,     // raw (D, H) | unused
    const float* __restrict__ w_hh,     // (D, H, H)
    const float* __restrict__ b_hh,     // (D, H)
    float* __restrict__ outs,           // (T, D, B, H)
    float* __restrict__ h_n,            // (D, B, H)
    int T, int B, int F, int H, float leak, int reverse) {
  extern __shared__ float smem[];
  float* s_h = smem;                // [2][R][H]  h, double-buffered
  float* s_x = s_h + 2 * R * H;     // [2][R][F]  raw mode only

  const int D = gridDim.y;
  const int d = blockIdx.y;
  const bool rev = kProj ? reverse != 0 : d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * H;
  const float* wh = w_hh + (int64_t)d * H * H;

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
    const float* xp = kProj ? x + ((int64_t)t * B + r0) * H : nullptr;
    for (int u = tid; u < H; u += nth) {
      float pre[R];
      pre_activation<R, kProj>(wi, wh, kProj ? 0.f : b_ih[d * H + u],
                               b_hh[d * H + u], xc, hc, xp, nrows, u, F, H,
                               pre);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * H + u;
        float h = hc[i];
        const float h2 = (1.f - leak) * h + leak * tanhf(pre[r]);
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
// T - 1 down to 0) recomputes u from its input and the saved h_{t-1} (zero
// at t == 0) in the forward's order of operations, then
//   dh = dh_carry + douts[t];  dh2 = dh if the row is active, else 0
//   dpre = leak * dh2 * (1 - u^2)
//   dh_{t-1} = (dh if inactive, else 0) + dpre @ W_hh^T + (1 - leak) dh2
//   raw mode: dx_t = dpre @ W_ih^T  (projected mode: dxp_t = dpre).
// A thread owns hidden units and writes dpre to shared memory; after a
// barrier every thread forms columns of dpre @ W_hh^T (and, raw, of
// dpre @ W_ih^T) from the transposed weights (coalesced across threads).
// The kernel writes the dpre and h_{t-1} streams (raw: in x's time order,
// with each direction's dx; projected: in xp's own time order, the dpre
// stream being the wrapper's dxp); the wrapper reduces
// dW_hh = h_prev^T dpre and db_hh = sum dpre (and, raw, dW_ih = x^T dpre
// and db_ih = db_hh) with csrc/wgrad.cu and adds the two directions' dx.
template <int R, bool kProj>
__global__ void __launch_bounds__(kBwdThreads) elman_bwd_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | projected (T, B, H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_ih,     // raw (D, F, H) | unused
    const float* __restrict__ b_ih,     // raw (D, H) | unused
    const float* __restrict__ w_hh,     // (D, H, H)
    const float* __restrict__ b_hh,     // (D, H)
    const float* __restrict__ w_ihT,    // raw (D, H, F) | unused
    const float* __restrict__ w_hhT,    // (D, H, H)
    const float* __restrict__ outs,     // (T, D, B, H)
    const float* __restrict__ douts,    // (T, D, B, H) or nullptr
    const float* __restrict__ dh_n,     // (D, B, H)
    float* __restrict__ dpre_s,         // (D, T, B, H)
    float* __restrict__ hp_s,           // (D, T, B, H)
    float* __restrict__ dx_s,           // raw (D, T, B, F) | unused
    int T, int B, int F, int H, float leak, int reverse) {
  extern __shared__ float smem[];
  const int Fx = kProj ? 0 : F;
  float* s_x = smem;                  // [R][F]  raw mode only
  float* s_hp = s_x + R * Fx;         // [R][H]
  float* s_dp = s_hp + R * H;         // [R][H]
  float* s_dh = s_dp + R * H;         // [R][H]

  const int D = gridDim.y;
  const int d = blockIdx.y;
  const bool rev = kProj ? reverse != 0 : d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * H;
  const float* wh = w_hh + (int64_t)d * H * H;
  const float* wiT = kProj ? nullptr : w_ihT + (int64_t)d * H * F;
  const float* whT = w_hhT + (int64_t)d * H * H;

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

    const float* xp = kProj ? x + ((int64_t)t * B + r0) * H : nullptr;
    for (int u = tid; u < H; u += nth) {
      float pre[R];
      pre_activation<R, kProj>(wi, wh, kProj ? 0.f : b_ih[d * H + u],
                               b_hh[d * H + u], s_x, s_hp, xp, nrows, u, F,
                               H, pre);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * H + u;
        if (r >= nrows) {
          s_dp[i] = 0.f;
          continue;
        }
        const float ug = tanhf(pre[r]);
        const bool active = span_active(t, T, len[r], rev);
        float dh = s_dh[i];
        if (douts) dh += douts[(((int64_t)t * D + d) * B + r0 + r) * H + u];
        const float dh2 = active ? dh : 0.f;
        s_dp[i] = (leak * dh2) * (1.f - ug * ug);
        // pass-through part of dh_{t-1}
        s_dh[i] = (active ? 0.f : dh) + (1.f - leak) * dh2;
      }
    }
    __syncthreads();  // s_dp complete

    // streams for the weight gradients (and the projected mode's dxp)
    for (int i = tid; i < nrows * H; i += nth) {
      const int64_t o = (((int64_t)d * T + tx) * B + r0) * H + i;
      dpre_s[o] = s_dp[i];
      hp_s[o] = s_hp[i];
    }
    // dh_{t-1} += dpre @ W_hh^T;  raw mode: dx_t = dpre @ W_ih^T
    for (int col = tid; col < H + Fx; col += nth) {
      const bool is_h = col < H;
      const int c = is_h ? col : col - H;
      const float* wT = is_h ? whT + c : wiT + c;
      const int ld = is_h ? H : F;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < H; ++j) {
        const float w = __ldg(wT + (int64_t)j * ld);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dp[r * H + j], w, acc[r]);
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
    __syncthreads();  // s_dh holds dh_{t-1}; s_x, s_hp, s_dp free
  }
}

// kind: 0 raw forward, 1 raw backward, 2 projected forward, 3 projected
// backward.
long long smem_bytes(int kind, int rows, int F, int H) {
  const bool proj = kind >= 2;
  const long long per_row = (kind % 2 == 0)
      ? 2LL * H + (proj ? 0 : 2LL * F)   // forward: h (x2), x (x2)
      : 3LL * H + (proj ? 0 : F);        // backward: hp, dpre, dh, x
  return (long long)rows * per_row * (long long)sizeof(float);
}

template <int R>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)elman_fwd_kernel<R, false>;
    case 1: return (const void*)elman_bwd_kernel<R, false>;
    case 2: return (const void*)elman_fwd_kernel<R, true>;
    default: return (const void*)elman_bwd_kernel<R, true>;
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
                int T, int B, int F, int H, float leak, int reverse) {
  elman_fwd_kernel<R, kProj><<<grid, fwd_threads(H), smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F, H, leak,
      reverse);
}

template <bool kProj>
void dispatch_fwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  float* outs, float* h_n, int T, int B, int F, int H,
                  float leak, int reverse) {
  auto go = rows == 8   ? &launch_fwd<8, kProj>
            : rows == 4 ? &launch_fwd<4, kProj>
                        : &launch_fwd<2, kProj>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F,
     H, leak, reverse);
}

template <int R, bool kProj>
void launch_bwd(dim3 grid, int smem, cudaStream_t s, const float* x,
                const int* lengths, const float* w_ih, const float* b_ih,
                const float* w_hh, const float* b_hh, const float* w_ihT,
                const float* w_hhT, const float* outs, const float* douts,
                const float* dh_n, float* dpre_s, float* hp_s, float* dx_s,
                int T, int B, int F, int H, float leak, int reverse) {
  elman_bwd_kernel<R, kProj><<<grid, kBwdThreads, smem, s>>>(
      x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, douts, dh_n,
      dpre_s, hp_s, dx_s, T, B, F, H, leak, reverse);
}

template <bool kProj>
void dispatch_bwd(int rows, dim3 grid, int smem, cudaStream_t s,
                  const float* x, const int* lengths, const float* w_ih,
                  const float* b_ih, const float* w_hh, const float* b_hh,
                  const float* w_ihT, const float* w_hhT, const float* outs,
                  const float* douts, const float* dh_n, float* dpre_s,
                  float* hp_s, float* dx_s, int T, int B, int F, int H,
                  float leak, int reverse) {
  auto go = rows == 8   ? &launch_bwd<8, kProj>
            : rows == 4 ? &launch_bwd<4, kProj>
                        : &launch_bwd<2, kProj>;
  go(grid, smem, s, x, lengths, w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs,
     douts, dh_n, dpre_s, hp_s, dx_s, T, B, F, H, leak, reverse);
}

}  // namespace

extern "C" {

// The largest row tile (8, 4 or 2) whose shared memory fits the card for
// kernel `kind` (0 raw forward, 1 raw backward, 2 projected forward, 3
// projected backward); 0 when none does.
int abcd_elman_rows(int kind, int F, int H) {
  for (int rows = 8; rows >= 2; rows /= 2) {
    const void* fn = kernel_for(kind, rows);
    if (fn != nullptr && smem_bytes(kind, rows, F, H) <= smem_limit(fn))
      return rows;
  }
  return 0;
}

long long abcd_elman_smem_bytes(int kind, int rows, int F, int H) {
  return smem_bytes(kind, rows, F, H);
}

long long abcd_elman_smem_limit(int kind, int rows) {
  const void* fn = kernel_for(kind, rows);
  return fn == nullptr ? 0 : smem_limit(fn);
}

// Both directions over raw x (kind 0).  Shapes as in the comment on the
// kernel with D = 2.  Launches on `stream` and returns cudaGetLastError().
int abcd_elman_bidir_fwd(const float* x, const int* lengths,
                         const float* w_ih, const float* b_ih,
                         const float* w_hh, const float* b_hh, float* outs,
                         float* h_n, int T, int B, int F, int H, float leak,
                         int rows, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(0, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_fwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, outs, h_n, T, B, F, H, leak, 0);
  return (int)cudaGetLastError();
}

// One direction over xp (T, B, H) (kind 2): D = 1, `reverse` selects the
// flipped span.
int abcd_elman_fwd(const float* xp, const int* lengths, const float* w_hh,
                   const float* b_hh, float* outs, float* h_n, int T, int B,
                   int H, float leak, int reverse, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(2, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_fwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, outs, h_n, T, B, 0, H,
                     leak, reverse);
  return (int)cudaGetLastError();
}

// The raw layer's backward (kind 1; see elman_bwd_kernel).  douts may be
// nullptr (a zero cotangent: the final layer's outs feed nothing).  Writes
// the dpre and h_prev streams and each direction's dx, which the wrapper
// reduces with csrc/wgrad.cu.
int abcd_elman_bidir_bwd(const float* x, const int* lengths,
                         const float* w_ih, const float* b_ih,
                         const float* w_hh, const float* b_hh,
                         const float* w_ihT, const float* w_hhT,
                         const float* outs, const float* douts,
                         const float* dh_n, float* dpre_s, float* hp_s,
                         float* dx_s, int T, int B, int F, int H, float leak,
                         int rows, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(1, rows, F, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 2);
  dispatch_bwd<false>(rows, grid, smem, (cudaStream_t)stream, x, lengths,
                      w_ih, b_ih, w_hh, b_hh, w_ihT, w_hhT, outs, douts, dh_n,
                      dpre_s, hp_s, dx_s, T, B, F, H, leak, 0);
  return (int)cudaGetLastError();
}

// The projected layer's backward (kind 3): writes dxp (= the dpre stream,
// (T, B, H) in xp's time order) and the h_prev stream for dW_hh.  douts may
// be nullptr.
int abcd_elman_bwd(const float* xp, const int* lengths, const float* w_hh,
                   const float* b_hh, const float* w_hhT, const float* outs,
                   const float* douts, const float* dh_n, float* dxp,
                   float* hp_s, int T, int B, int H, float leak, int reverse,
                   int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(3, rows, 0, H, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + rows - 1) / rows, 1);
  dispatch_bwd<true>(rows, grid, smem, (cudaStream_t)stream, xp, lengths,
                     nullptr, nullptr, w_hh, b_hh, nullptr, w_hhT, outs,
                     douts, dh_n, dxp, hp_s, nullptr, T, B, 0, H, leak,
                     reverse);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
