// The decoder's sampled time loop, written for Hopper (sm_90a): for the
// LSTM, GRU and Elman / ESN cells with the two training losses fused
// (forward and backward), as the plain sampled loop (forward and backward)
// and, for the LSTM, with the emission NLL alone fused (forward and
// backward).
//
// Replaces seq2seq_abcd_vae_tpu/ops/decoder_pallas.py:
// decoder_loop_fused_losses (`_fused_fwd_call` / `_fused_fwd_kernel` and
// `_fused_bwd_call` / `_fused_bwd_kernel`, with_offset=True),
// decoder_loop_fused_nll (the same kernels with with_offset=False,
// `_fused_loop_cvjp`), decoder_loop (`_fwd_call` / `_fwd_kernel` and
// `_bwd_call` / `_bwd_kernel`), gru_decoder_loop_fused_losses
// (`_gru_floss_fwd_call` / `_gru_floss_fwd_kernel` and `_gru_floss_bwd_call`
// / `_gru_floss_bwd_kernel`), rnn_decoder_loop_fused_losses
// (`_rnn_floss_fwd_call` / `_rnn_floss_fwd_kernel` and `_rnn_floss_bwd_call`
// / `_rnn_floss_bwd_kernel`), gru_decoder_loop (`_gru_fwd_call` /
// `_gru_fwd_kernel` and `_gru_bwd_call` / `_gru_bwd_kernel`) and
// rnn_decoder_loop (`_rnn_fwd_call` / `_rnn_fwd_kernel` and `_rnn_bwd_call`
// / `_rnn_bwd_kernel`).  Step t of the loop, in the order of the scan body
// (models/decoder.py:341-361):
//
//   big  = h @ w_cat                         w_cat = [W_hh | emission lin1]
//   emh  = tanh(big[:, GH:] + b1)            GH = 4H | 3H (GRU) | H (RNN)
//   mean = emh[:, :m] @ w2m + b2[:F];  logvar = emh[:, m:] @ w2v + b2[F:]
//   x    = mean + exp(logvar / 2) * noise[t-1]   (0 on a row's first step)
//   LSTM: gates = big[:, :4H] + x @ w_ih + bias;   c2, h2 = the LSTM cell
//   GRU:  xp = x @ w_ih + b_ih;  hp = big[:, :3H] + b_hh;
//         r, z = sigmoid(xp + hp);  n = tanh(xp_n + r * hp_n);
//         h2 = (1 - z) * n + z * h           (no c; b_hh inside the reset)
//   RNN:  u = tanh(big[:, :H] + x @ w_ih + bias);
//         h2 = (1 - leak) * h + leak * u     (no c; the ESN: its leak and a
//                                             zero bias; leak == 1 gives u)
//   h, c  = (h2, c2) while t < len, else frozen
//
// The emission at step t is position t-1's.  The fused-loss modes add
// position t-1's Gaussian NLL against targets[t-1] (gated by pmt = 1 <= t
// <= len); the caller adds position T-1's term from the last step's
// pre-mask h2.  With both losses fused, the offset MLP runs on the pre-mask
// h2 of every step and adds its BCE against (t == len - 1) while t < len,
// and only the last step's h2 is written (out_last); with the NLL alone
// (decoder_loop_fused_nll) the pre-mask h2 of step t goes to slot t of
// outs, for the caller's offset MLP.  The plain loop (decoder_loop)
// writes the pre-mask h2 of step t to slot t of outs and step t's emission
// to POSITION slot t-1 of the mean / logvar streams, step 0's parked on
// slot T-1 for the caller to overwrite.  These are exactly the TPU kernels'
// slot maps and masks (_step_masks, _offset_target, the `pos` output index
// map of `_fwd_call`).  The GRU and Elman / ESN plain loops
// (gru_decoder_loop, rnn_decoder_loop) write outs alone: their callers
// compute the emissions from outs afterwards (models/decoder.py:324-329).
//
// Design: rows are independent, so one block owns R batch rows and the
// whole time loop; no block waits for another.  R (8, 4 or 2) is chosen at
// launch so that the block's shared memory fits the card (at H=1024 the
// fused kernels take 4 rows).  Every per-step product is a loop over output
// columns (one column per thread, the tile's rows in registers) reading the
// weight row-major, so neighbouring threads read neighbouring addresses; the
// intermediates (big, x, h2, the offset hidden) live in shared memory, five
// barriers a step (three in the plain loop).  The weights (2.5 MB at the
// publication width, far more than a block holds) are re-read from L2 at
// every step by every block: with the tile's rows per weight load that L2 ->
// SM traffic, not the card's float32 rate, bounds the loop.  The loss sums
// are accumulated per thread in float64, reduced per block in a fixed order,
// and the per-block partials are added in block order by a second one-block
// kernel: no atomics, so a run repeats exactly.
//
// The backward runs the reverse-time adjoint of the step for the same tile
// of rows, recomputing the step from the saved h_{t-1}, c_{t-1} (h0, c0 at
// t == 0).  Its cotangents come in three ways, one template mode each:
// both fused losses (the loss cotangents dnll, dbce, in-register from the
// targets and the recomputed offset MLP, plus the cotangent of out_last);
// the NLL alone (dnll in-register from the targets, plus the douts stream,
// the cotangent of each step's pre-mask h2); or the plain loop's streams
// (douts and, for the LSTM, the position-indexed dmean_s / dlogvar_s: step
// t's emission reads slot t-1, nothing at t == 0; slot T-1 belongs to the
// caller's overwrite and is never read).  Weight gradients are sums over
// every (t, b): the kernel writes each step's operands and cotangents as
// streams, and csrc/wgrad.cu reduces them in a fixed order.
//
// In-kernel noise (the JAX package's SEQ2SEQ_KERNEL_RNG=1; replaces
// decoder_pallas.py:decoder_noise_dump / `_noise_dump_kernel` and the
// kernel_rng branch of the fused-loss kernels, `_kernel_noise`): with the
// kSeed template flag the fused-loss forward and backward of every cell
// take a (1, 1) float32 seed (below 2^24) in place of the (T, B, F) noise
// stream and draw position t - 1's noise of row b, column f at step t as
//
//   (w0, w1, -, -) = Philox4x32-10(counter = (t - 1, b, f, 0),
//                                  key = (seed, 0))
//   u1 = (w0 >> 8) * 2^-24 + 2^-25,   u2 = (w1 >> 8) * 2^-24
//   eps = sqrt(-2 log u1) * cos(2 pi u2)
//
// (the TPU kernel's Box-Muller over two 24-bit uniforms, on a generator a
// GPU has; the TPU's own bits cannot be had here), with IEEE logf / cosf /
// sqrtf and every product rounded on its own (no contraction), so the
// backward regenerates the forward's draws bit for bit.  Each draw depends
// on (seed, t, b, f) alone, never on the row tile, and noise_dump_kernel
// writes the same numbers out as a (T, B, F) stream, one thread per
// element.  The dump is bounded by its operations (Philox's ten rounds of
// two 32-bit multiplies each, then log, cos and sqrt), not by the bytes it
// writes; the loop kernels trade B * F loads of noise a step for as many
// draws.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr double kLog2Pi = 1.8378770664093453;

// the recurrent cell of a kernel instance
constexpr int kLSTM = 0, kGRU = 1, kRNN = 2;

// what a kernel instance computes around the loop: both training losses
// (decoder_loop_fused_losses and its GRU and Elman / ESN variants), the
// emission NLL alone (decoder_loop_fused_nll, the LSTM's), or no loss (the
// plain sampled loops, whose backward takes its outputs' cotangents)
constexpr int kFusedLosses = 0, kFusedNll = 1, kStream = 2;

__host__ __device__ constexpr int num_gates(int cell) {
  return cell == kLSTM ? 4 : cell == kGRU ? 3 : 1;
}

constexpr float kTwoPi = 6.283185307179586f;

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32 with 10
// rounds) of counter (c0, c1, c2, c3) and key (k0, k1); the four words
// go back in c.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t c1 = c[1], c3 = c[3];
    c[0] = hi1 ^ c1 ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c3 ^ k1;
    c[3] = lo0;
  }
}

// The two 24-bit integers of (seed, slot t, row b, column f) whose
// uniforms feed the Box-Muller transform: the top 24 bits of Philox's
// first two words.
__device__ __forceinline__ void noise_bits(uint32_t seed, int t, int b,
                                           int f, uint32_t* i1,
                                           uint32_t* i2) {
  uint32_t c[4] = {(uint32_t)t, (uint32_t)b, (uint32_t)f, 0u};
  philox4x32_10(c, seed, 0u);
  *i1 = c[0] >> 8;
  *i2 = c[1] >> 8;
}

// Box-Muller of the two 24-bit integers.  The _rn intrinsics keep each
// product rounded on its own.
__device__ __forceinline__ float box_muller(uint32_t i1, uint32_t i2) {
  const float u1 = __fadd_rn(__fmul_rn((float)i1, 0x1p-24f), 0x1p-25f);
  const float u2 = __fmul_rn((float)i2, 0x1p-24f);
  return __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(u1))),
                   cosf(__fmul_rn(kTwoPi, u2)));
}

// The standard normal of (seed, slot t, row b, column f): see the comment
// at the top.
__device__ __forceinline__ float kernel_noise(uint32_t seed, int t, int b,
                                              int f) {
  uint32_t i1, i2;
  noise_bits(seed, t, b, f, &i1, &i2);
  return box_muller(i1, i2);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// big[r][j] = (h @ w_cat)[r][j], with tanh(. + b1) on the emission columns
// (the columns past the GH gate columns).
template <int R>
__device__ __forceinline__ void big_product(const float* __restrict__ w_cat,
                                            const float* __restrict__ b1,
                                            const float* s_h, float* s_big,
                                            int H, int GH, int G) {
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = __ldg(w_cat + (int64_t)k * G + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_h[r * H + k], w, acc[r]);
    }
    const float bj = j < GH ? 0.f : b1[j - GH];
#pragma unroll
    for (int r = 0; r < R; ++r)
      s_big[r * G + j] = j < GH ? acc[r] : tanhf(acc[r] + bj);
  }
}

// emission mean / logvar of column f for every row of the tile.
template <int R>
__device__ __forceinline__ void emission(const float* __restrict__ w2m,
                                         const float* __restrict__ w2v,
                                         const float* __restrict__ b2,
                                         const float* s_big, int f, int F,
                                         int M, int GH, int G,
                                         float* mean, float* lv) {
  float am[R], av[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    am[r] = 0.f;
    av[r] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < M; ++k) {
    const float wm = __ldg(w2m + (int64_t)k * F + f);
    const float wv = __ldg(w2v + (int64_t)k * F + f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      am[r] = fmaf(s_big[r * G + GH + k], wm, am[r]);
      av[r] = fmaf(s_big[r * G + GH + M + k], wv, av[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mean[r] = am[r] + b2[f];
    lv[r] = av[r] + b2[F + f];
  }
}

// gates of hidden unit u: big[:, g*H+u] + x @ w_ih[:, g*H+u] + bias, for
// the NG gates of the LSTM (4) or the Elman cell (1).
template <int R, int NG>
__device__ __forceinline__ void gate_inputs(const float* __restrict__ w_ih,
                                            const float* __restrict__ bias,
                                            const float* s_x,
                                            const float* s_big, int u, int F,
                                            int H, int G,
                                            float z[NG][R]) {
  const int GH = NG * H;
  float ax[NG][R];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) ax[g][r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    float w[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) w[g] = __ldg(w_ih + (int64_t)k * GH + g * H + u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = s_x[r * F + k];
#pragma unroll
      for (int g = 0; g < NG; ++g) ax[g][r] = fmaf(xv, w[g], ax[g][r]);
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float bg = bias[g * H + u];
#pragma unroll
    for (int r = 0; r < R; ++r)
      z[g][r] = (s_big[r * G + g * H + u] + ax[g][r]) + bg;
  }
}

// GRU gate pre-activations of hidden unit u: xg = x @ w_ih[:, g*H+u] + b_ih
// and hg = big[:, g*H+u] + b_hh (kept apart: b_hh sits inside the reset
// product), for g = r, z, n.
template <int R>
__device__ __forceinline__ void gru_gate_inputs(const float* __restrict__ w_ih,
                                                const float* __restrict__ b_ih,
                                                const float* __restrict__ b_hh,
                                                const float* s_x,
                                                const float* s_big, int u,
                                                int F, int H, int G,
                                                float xg[3][R],
                                                float hg[3][R]) {
  const int G3 = 3 * H;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < R; ++r) xg[g][r] = 0.f;
#pragma unroll 4
  for (int k = 0; k < F; ++k) {
    float w[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) w[g] = __ldg(w_ih + (int64_t)k * G3 + g * H + u);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = s_x[r * F + k];
#pragma unroll
      for (int g = 0; g < 3; ++g) xg[g][r] = fmaf(xv, w[g], xg[g][r]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float bx = b_ih[g * H + u], bh = b_hh[g * H + u];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xg[g][r] += bx;
      hg[g][r] = s_big[r * G + g * H + u] + bh;
    }
  }
}

// oh[r][j] = tanh(h2 @ wo1 + bo1)
template <int R>
__device__ __forceinline__ void offset_hidden(const float* __restrict__ wo1,
                                              const float* __restrict__ bo1,
                                              const float* s_h2, float* s_oh,
                                              int H, int Mo) {
  for (int j = threadIdx.x; j < Mo; j += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float w = __ldg(wo1 + (int64_t)k * Mo + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_h2[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_oh[r * Mo + j] = tanhf(acc[r] + bo1[j]);
  }
}

__device__ __forceinline__ float offset_logit(const float* __restrict__ wo2,
                                              const float* s_oh, int r,
                                              int Mo, float bo2) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int j = lane; j < Mo; j += 32) s = fmaf(s_oh[r * Mo + j], wo2[j], s);
  return warp_sum(s) + bo2;
}

// kMode == kFusedLosses: the fused-loss forward (decoder_loop_fused_losses
// and its GRU and Elman / ESN variants).  kFusedNll: the LSTM's emission
// NLL alone (decoder_loop_fused_nll): no offset MLP, outs written as in the
// plain loop, no out_last.  kStream: the plain sampled loop (decoder_loop,
// gru_decoder_loop, rnn_decoder_loop): no targets, offset MLP or loss sums;
// it writes the pre-mask h2 of every step to outs at slot t and, when
// mean_s is given (the LSTM's loop), the emission parameters computed at
// step t to mean_s / logvar_s at POSITION slot t - 1, step 0's parked on
// slot T - 1 (the caller overwrites it).  kCell == kGRU: the GRU
// cell: w_cat is (H, 3H + 2M), `bias` is b_ih and `bias_hh` b_hh, there is
// no c.  kCell == kRNN: the Elman / ESN cell: w_cat is (H, H + 2M), `bias`
// is b_ih + b_hh (zeros for the ESN), there is no c, and `leak` mixes the
// carry into the update.  kSeed (kFusedLosses only): `noise` is the (1, 1)
// seed, and each step draws its noise in-kernel (kernel_noise).
template <int R, int kMode, int kCell, bool kSeed = false>
__global__ void __launch_bounds__(kThreads) decoder_fwd_kernel(
    const float* __restrict__ noise,    // (T, B, F), or kSeed's (1, 1)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_cat,    // (H, GH + 2M), GH = 4H | 3H | H
    const float* __restrict__ bias,     // LSTM / RNN b_ih + b_hh | GRU b_ih
    const float* __restrict__ bias_hh,  // GRU (3H,) b_hh | LSTM unused
    const float* __restrict__ b1,       // (2M,)
    const float* __restrict__ w2m,      // (M, F)
    const float* __restrict__ w2v,      // (M, F)
    const float* __restrict__ b2,       // (2F,)
    const float* __restrict__ w_ih,     // (F, GH)
    const float* __restrict__ targets,  // (T, B, F)   kLosses only
    const float* __restrict__ wo1,      // (H, Mo)     kOffset only
    const float* __restrict__ bo1,      // (Mo,)       kOffset only
    const float* __restrict__ wo2,      // (Mo,)       kOffset only
    const float* __restrict__ bo2,      // (1,)        kOffset only
    const float* __restrict__ h0,       // (B, H)
    const float* __restrict__ c0,       // (B, H)      LSTM only
    float* __restrict__ out_last,       // (B, H)      kOffset only
    float* __restrict__ hs,             // (T, B, H) or nullptr
    float* __restrict__ cs,             // (T, B, H) or nullptr (LSTM only)
    double* __restrict__ partial,       // (blocks, 2) kLosses only
    float* __restrict__ outs,           // (T, B, H)   unless kOffset
    float* __restrict__ mean_s,         // (T, B, F)   LSTM loop or nullptr
    float* __restrict__ logvar_s,       // (T, B, F)   LSTM loop or nullptr
    int T, int B, int F, int H, int M, int Mo,
    float leak) {                       // RNN only
  constexpr bool kLosses = kMode != kStream;       // the NLL sum
  constexpr bool kOffset = kMode == kFusedLosses;  // the offset MLP, BCE
  extern __shared__ float smem[];
  __shared__ double s_red[kLosses ? kThreads : 1];
  const int GH = num_gates(kCell) * H, G = GH + 2 * M;
  const int HC = kCell == kLSTM ? H : 0;   // the LSTM's c
  float* s_h = smem;             // [R][H]   carry h
  float* s_c = s_h + R * H;      // [R][HC]  carry c
  float* s_big = s_c + R * HC;   // [R][G]
  float* s_x = s_big + R * G;    // [R][F]
  float* s_h2 = s_x + R * F;     // [R][H]   pre-mask h2 (kOffset only)
  float* s_oh = s_h2 + R * H;    // [R][Mo]  (kOffset only)

  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, nwarps = nth / 32;
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  for (int i = tid; i < R * H; i += nth) {
    const int r = i / H;
    s_h[i] = r < nrows ? h0[(int64_t)r0 * H + i] : 0.f;
    if (kCell == kLSTM) s_c[i] = r < nrows ? c0[(int64_t)r0 * H + i] : 0.f;
  }
  const float bo2v = kOffset ? bo2[0] : 0.f;
  const uint32_t seed = kSeed ? (uint32_t)noise[0] : 0u;
  double nll_acc = 0.0, bce_acc = 0.0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    big_product<R>(w_cat, b1, s_h, s_big, H, GH, G);
    __syncthreads();

    const int slot = t == 0 ? T - 1 : t - 1;  // position of this emission
    for (int f = tid; f < F; f += nth) {
      float mean[R], lv[R];
      emission<R>(w2m, w2v, b2, s_big, f, F, M, GH, G, mean, lv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool pmt = t >= 1 && t - 1 < len[r];
        float x = 0.f;
        if (pmt) {
          const int64_t o = ((int64_t)(t - 1) * B + r0 + r) * F + f;
          const float eps =
              kSeed ? kernel_noise(seed, t - 1, r0 + r, f) : noise[o];
          x = mean[r] + expf(0.5f * lv[r]) * eps;
          if (kLosses) {
            const float diff = targets[o] - mean[r];
            nll_acc += (double)(0.5f * ((float)kLog2Pi + lv[r]
                                        + diff * expf(-lv[r]) * diff));
          }
        }
        s_x[r * F + f] = x;
        if (!kLosses && mean_s && r < nrows) {
          const int64_t o = ((int64_t)slot * B + r0 + r) * F + f;
          mean_s[o] = mean[r];
          logvar_s[o] = lv[r];
        }
      }
    }
    __syncthreads();

    for (int u = tid; u < H; u += nth) {
      float h2v[R], c2v[R];
      if constexpr (kCell == kGRU) {
        float xg[3][R], hg[3][R];
        gru_gate_inputs<R>(w_ih, bias, bias_hh, s_x, s_big, u, F, H, G, xg,
                           hg);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float rg = sigmoid(xg[0][r] + hg[0][r]);
          const float zg = sigmoid(xg[1][r] + hg[1][r]);
          const float ng = tanhf(xg[2][r] + rg * hg[2][r]);
          h2v[r] = (1.f - zg) * ng + zg * s_h[r * H + u];
          c2v[r] = 0.f;
        }
      } else if constexpr (kCell == kRNN) {
        float z[1][R];
        gate_inputs<R, 1>(w_ih, bias, s_x, s_big, u, F, H, G, z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          h2v[r] = (1.f - leak) * s_h[r * H + u] + leak * tanhf(z[0][r]);
          c2v[r] = 0.f;
        }
      } else {
        float z[4][R];
        gate_inputs<R, 4>(w_ih, bias, s_x, s_big, u, F, H, G, z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ig = sigmoid(z[0][r]);
          const float fg = sigmoid(z[1][r]);
          const float gg = tanhf(z[2][r]);
          const float og = sigmoid(z[3][r]);
          c2v[r] = fg * s_c[r * H + u] + ig * gg;
          h2v[r] = og * tanhf(c2v[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * H + u;
        const float h2 = h2v[r];
        if (kOffset) s_h2[i] = h2;
        if (t < len[r]) {
          s_h[i] = h2;
          if (kCell == kLSTM) s_c[i] = c2v[r];
        }
        if (r < nrows) {
          const int64_t o = ((int64_t)t * B + r0 + r) * H + u;
          if (hs) hs[o] = s_h[i];
          if (kCell == kLSTM && cs) cs[o] = s_c[i];
          if (!kOffset) outs[o] = h2;
          if (kOffset && t == T - 1) out_last[(int64_t)(r0 + r) * H + u] = h2;
        }
      }
    }
    __syncthreads();

    if (kOffset) {
      offset_hidden<R>(wo1, bo1, s_h2, s_oh, H, Mo);
      __syncthreads();

      for (int r = warp; r < R; r += nwarps) {
        const float z = offset_logit(wo2, s_oh, r, Mo, bo2v);
        if (tid % 32 == 0 && t < len[r]) {
          const float y = t == len[r] - 1 ? 1.f : 0.f;
          bce_acc += (double)(fmaxf(z, 0.f) - z * y
                              + log1pf(expf(-fabsf(z))));
        }
      }
      // The next step's first barrier orders these reads of s_oh before
      // the next writes to it.
    }
  }
  if (!kLosses) return;

  // fixed-order block reduction of the two loss sums
  __syncthreads();
  s_red[tid] = nll_acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < nth; ++i) s += s_red[i];
    partial[blockIdx.x * 2] = s;
  }
  __syncthreads();
  s_red[tid] = bce_acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < nth; ++i) s += s_red[i];
    partial[blockIdx.x * 2 + 1] = s;
  }
}

__global__ void loss_sum_kernel(const double* __restrict__ partial,
                                int blocks, float* __restrict__ losses) {
  if (threadIdx.x != 0) return;
  double nll = 0.0, bce = 0.0;
  for (int i = 0; i < blocks; ++i) {
    nll += partial[2 * i];
    bce += partial[2 * i + 1];
  }
  losses[0] = (float)nll;
  losses[1] = (float)bce;
}

// out (T, B, F) = the draws of the kSeed kernels, one thread per element;
// with `bits` (T, B, F, 2), also the two 24-bit integers of each draw (a
// check of the generator's bits; nullptr on the main path).
__global__ void noise_dump_kernel(const float* __restrict__ seed,
                                  float* __restrict__ out,
                                  int* __restrict__ bits, int T, int B,
                                  int F) {
  const int64_t n = (int64_t)T * B * F;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int f = (int)(i % F);
  const int64_t tb = i / F;
  uint32_t i1, i2;
  noise_bits((uint32_t)seed[0], (int)(tb / B), (int)(tb % B), f, &i1, &i2);
  out[i] = box_muller(i1, i2);
  if (bits != nullptr) {
    bits[2 * i] = (int)i1;
    bits[2 * i + 1] = (int)i2;
  }
}

// kCell == kGRU: the GRU cell's adjoint
// (decoder_pallas.py:_gru_floss_bwd_kernel): `bias` is b_ih, `bias_hh` b_hh,
// there is no c (c0, cs, dc0 unused); the gate part of the dbig stream is
// dhp = [drpre, dzpre, dnpre * r] (the cotangent of h @ W_hh + b_hh) and the
// extra dnp stream holds dnpre, the candidate third of dxp = [drpre, dzpre,
// dnpre] (the cotangent of x @ W_ih + b_ih).  kCell == kRNN: the Elman / ESN
// cell's adjoint (decoder_pallas.py:_rnn_floss_bwd_kernel): no c, the gate
// part of dbig is dpre = leak * dh2 * (1 - u^2) (the cotangent of the
// pre-activation, hence of bias, x @ w_ih and h @ W_hh alike) and dh_{t-1}
// gains (1 - leak) * dh2.
//
// kMode == kFusedLosses: the cotangent of each step's h2 is that of the
// recomputed offset MLP's BCE (scaled by dbce) plus, at the last step,
// dlast; the emission's is that of the NLL (scaled by dnll, from the
// targets) plus the fed-back sample's.  kFusedNll (the LSTM's): h2's
// cotangent is douts[t], the emission's as in kFusedLosses; no offset MLP.
// kStream (the plain loops' adjoints, decoder_pallas.py:_bwd_kernel,
// _gru_bwd_kernel, _rnn_bwd_kernel): h2's cotangent is douts[t]; the
// emission's is the fed-back sample's plus, for the LSTM, the caller's
// position-indexed dmean_s / dlogvar_s at slot t - 1 (none at t == 0).
// Only kFusedLosses writes the offset streams (h2_s, doh_s, oh_s, dzo_s).
// kSeed (kFusedLosses only): `noise` is the (1, 1) seed, and each step
// regenerates the forward's draws (kernel_noise).
template <int R, int kCell, int kMode, bool kSeed = false>
__global__ void __launch_bounds__(kThreads) decoder_bwd_kernel(
    const float* __restrict__ noise, const int* __restrict__ lengths,
    const float* __restrict__ w_cat, const float* __restrict__ bias,
    const float* __restrict__ bias_hh,
    const float* __restrict__ b1, const float* __restrict__ w2m,
    const float* __restrict__ w2v, const float* __restrict__ b2,
    const float* __restrict__ w_ih, const float* __restrict__ targets,
    const float* __restrict__ wo1, const float* __restrict__ bo1,
    const float* __restrict__ wo2, const float* __restrict__ bo2,
    const float* __restrict__ h0, const float* __restrict__ c0,
    const float* __restrict__ w_catT,   // (G, H)
    const float* __restrict__ w_ihT,    // (GH, F)
    const float* __restrict__ w2mT,     // (F, M)
    const float* __restrict__ w2vT,     // (F, M)
    const float* __restrict__ wo1T,     // (Mo, H)
    const float* __restrict__ hs,       // (T, B, H)
    const float* __restrict__ cs,       // (T, B, H)   LSTM only
    const float* __restrict__ dlast,    // (B, H)      kFusedLosses only
    const float* __restrict__ gscale,   // dnll, dbce (kFusedLosses), dnll
    const float* __restrict__ douts,    // (T, B, H)   unless kFusedLosses
    const float* __restrict__ dmean_up,   // (T, B, F) LSTM kStream only
    const float* __restrict__ dlogvar_up, // (T, B, F) LSTM kStream only
    float* __restrict__ dh0,            // (B, H)
    float* __restrict__ dc0,            // (B, H)      LSTM only
    float* __restrict__ hp_s,           // (T, B, H)   h_{t-1}
    float* __restrict__ dbig_s,         // (T, B, G)   [dgates | d(emh pre-tanh)]
    float* __restrict__ x_s,            // (T, B, F)   fed-back input
    float* __restrict__ emh_s,          // (T, B, 2M)
    float* __restrict__ dem_s,          // (T, B, 2F)  [dmean | dlogvar]
    float* __restrict__ h2_s,           // (T, B, H)
    float* __restrict__ doh_s,          // (T, B, Mo)
    float* __restrict__ oh_s,           // (T, B, Mo)
    float* __restrict__ dzo_s,          // (T, B)      offset-logit cotangent
    float* __restrict__ dnp_s,          // (T, B, H)   GRU only: dnpre
    int T, int B, int F, int H, int M, int Mo,
    float leak) {                       // RNN only
  constexpr bool kOffset = kMode == kFusedLosses;  // the offset MLP, BCE
  constexpr bool kTargets = kMode != kStream;      // the NLL's cotangents
  extern __shared__ float smem[];
  const int GH = num_gates(kCell) * H, G = GH + 2 * M;
  const int HC = kCell == kLSTM ? H : 0;   // the LSTM's dc
  const int HC2 = kCell == kRNN ? 0 : H;   // the width of s_c2
  float* s_hp = smem;            // [R][H]   h_{t-1}
  float* s_big = s_hp + R * H;   // [R][G]   big, then gates, then dbig
  float* s_ml = s_big + R * G;   // [R][2F]  mean|logvar, then dmean|dlogvar
  float* s_x = s_ml + R * 2 * F; // [R][F]
  float* s_c2 = s_x + R * F;     // [R][HC2] LSTM c2 | GRU hp_n, then dnpre
  float* s_h2 = s_c2 + R * HC2;  // [R][H]
  float* s_oh = s_h2 + R * H;    // [R][Mo]  oh, then doh
  float* s_dh = s_oh + R * Mo;   // [R][H]   carry cotangents
  float* s_dc = s_dh + R * H;    // [R][HC]
  float* s_zo = s_dc + R * HC;   // [R]      offset-logit cotangent

  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int warp = tid / 32, nwarps = nth / 32;
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = r < nrows ? lengths[r0 + r] : 0;
  const float gnll = kTargets ? gscale[0] : 0.f;
  const float gbce = kOffset ? gscale[1] : 0.f;
  const float bo2v = kOffset ? bo2[0] : 0.f;
  const uint32_t seed = kSeed ? (uint32_t)noise[0] : 0u;
  for (int i = tid; i < R * H; i += nth) {
    s_dh[i] = 0.f;
    if (kCell == kLSTM) s_dc[i] = 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    for (int i = tid; i < R * H; i += nth) {
      const int r = i / H;
      float v = 0.f;
      if (r < nrows)
        v = t > 0 ? hs[((int64_t)(t - 1) * B + r0) * H + i]
                  : h0[(int64_t)r0 * H + i];
      s_hp[i] = v;
    }
    __syncthreads();

    // ---- recompute the step
    big_product<R>(w_cat, b1, s_hp, s_big, H, GH, G);
    __syncthreads();

    for (int f = tid; f < F; f += nth) {
      float mean[R], lv[R];
      emission<R>(w2m, w2v, b2, s_big, f, F, M, GH, G, mean, lv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool pmt = t >= 1 && t - 1 < len[r];
        float x = 0.f;
        if (pmt) {
          const int64_t o = ((int64_t)(t - 1) * B + r0 + r) * F + f;
          const float eps =
              kSeed ? kernel_noise(seed, t - 1, r0 + r, f) : noise[o];
          x = mean[r] + expf(0.5f * lv[r]) * eps;
        }
        s_ml[r * 2 * F + f] = mean[r];
        s_ml[r * 2 * F + F + f] = lv[r];
        s_x[r * F + f] = x;
        if (r < nrows) x_s[((int64_t)t * B + r0 + r) * F + f] = x;
      }
    }
    __syncthreads();

    for (int u = tid; u < H; u += nth) {
      if constexpr (kCell == kGRU) {
        float xg[3][R], hg[3][R];
        gru_gate_inputs<R>(w_ih, bias, bias_hh, s_x, s_big, u, F, H, G, xg,
                           hg);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * H + u;
          const float rg = sigmoid(xg[0][r] + hg[0][r]);
          const float zg = sigmoid(xg[1][r] + hg[1][r]);
          const float ng = tanhf(xg[2][r] + rg * hg[2][r]);
          const float h2 = (1.f - zg) * ng + zg * s_hp[i];
          s_big[r * G + u] = rg;
          s_big[r * G + H + u] = zg;
          s_big[r * G + 2 * H + u] = ng;
          s_c2[i] = hg[2][r];
          if (kOffset) {
            s_h2[i] = h2;
            if (r < nrows) h2_s[((int64_t)t * B + r0 + r) * H + u] = h2;
          }
        }
      } else if constexpr (kCell == kRNN) {
        float z[1][R];
        gate_inputs<R, 1>(w_ih, bias, s_x, s_big, u, F, H, G, z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * H + u;
          const float ug = tanhf(z[0][r]);
          const float h2 = (1.f - leak) * s_hp[i] + leak * ug;
          s_big[r * G + u] = ug;
          if (kOffset) {
            s_h2[i] = h2;
            if (r < nrows) h2_s[((int64_t)t * B + r0 + r) * H + u] = h2;
          }
        }
      } else {
        float z[4][R];
        gate_inputs<R, 4>(w_ih, bias, s_x, s_big, u, F, H, G, z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * H + u;
          const float ig = sigmoid(z[0][r]);
          const float fg = sigmoid(z[1][r]);
          const float gg = tanhf(z[2][r]);
          const float og = sigmoid(z[3][r]);
          float c_prev = 0.f;
          if (r < nrows)
            c_prev = t > 0 ? cs[((int64_t)(t - 1) * B + r0) * H + i]
                           : c0[(int64_t)r0 * H + i];
          const float c2 = fg * c_prev + ig * gg;
          const float h2 = og * tanhf(c2);
          s_big[r * G + u] = ig;
          s_big[r * G + H + u] = fg;
          s_big[r * G + 2 * H + u] = gg;
          s_big[r * G + 3 * H + u] = og;
          s_c2[i] = c2;
          if (kOffset) {
            s_h2[i] = h2;
            if (r < nrows) h2_s[((int64_t)t * B + r0 + r) * H + u] = h2;
          }
        }
      }
    }
    __syncthreads();

    if constexpr (kOffset) {  // the offset MLP and its BCE adjoint
      offset_hidden<R>(wo1, bo1, s_h2, s_oh, H, Mo);
      __syncthreads();

      // ---- adjoint: offset BCE
      for (int r = warp; r < R; r += nwarps) {
        const float z = offset_logit(wo2, s_oh, r, Mo, bo2v);
        if (tid % 32 == 0) {
          const bool mt = t < len[r];
          const float y = t == len[r] - 1 ? 1.f : 0.f;
          const float dzo = mt ? gbce * (sigmoid(z) - y) : 0.f;
          s_zo[r] = dzo;
          if (r < nrows) dzo_s[(int64_t)t * B + r0 + r] = dzo;
        }
      }
      __syncthreads();

      for (int j = tid; j < Mo; j += nth) {
        const float w = wo2[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float oh = s_oh[r * Mo + j];
          const float doh = (s_zo[r] * w) * (1.f - oh * oh);
          s_oh[r * Mo + j] = doh;
          if (r < nrows) {
            const int64_t o = ((int64_t)t * B + r0 + r) * Mo + j;
            oh_s[o] = oh;
            doh_s[o] = doh;
          }
        }
      }
      __syncthreads();
    }

    // ---- adjoint: the cell
    for (int u = tid; u < H; u += nth) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      if constexpr (kOffset) {
#pragma unroll 4
        for (int j = 0; j < Mo; ++j) {
          const float w = __ldg(wo1T + (int64_t)j * H + u);
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = fmaf(s_oh[r * Mo + j], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * H + u;
        const bool mt = t < len[r];
        // the last step's dlast, or every step's douts
        float dl = 0.f;
        if (kOffset && t == T - 1 && r < nrows)
          dl = dlast[(int64_t)(r0 + r) * H + u];
        if (!kOffset && r < nrows)
          dl = douts[((int64_t)t * B + r0 + r) * H + u];
        const float dh_carry = s_dh[i];
        const float dh2 = (acc[r] + dl) + (mt ? dh_carry : 0.f);
        if constexpr (kCell == kRNN) {
          const float ug = s_big[r * G + u];
          s_big[r * G + u] = (leak * dh2) * (1.f - ug * ug);
          // pass-through part of dh_{t-1}
          s_dh[i] = (mt ? 0.f : dh_carry) + (1.f - leak) * dh2;
        } else if constexpr (kCell == kGRU) {
          const float rg = s_big[r * G + u];
          const float zg = s_big[r * G + H + u];
          const float ng = s_big[r * G + 2 * H + u];
          const float hn = s_c2[i];
          const float dn = dh2 * (1.f - zg);
          const float dz = dh2 * (s_hp[i] - ng);
          const float dnpre = dn * (1.f - ng * ng);
          const float dr = dnpre * hn;
          s_big[r * G + u] = dr * rg * (1.f - rg);
          s_big[r * G + H + u] = dz * zg * (1.f - zg);
          s_big[r * G + 2 * H + u] = dnpre * rg;
          s_c2[i] = dnpre;
          // pass-through part of dh_{t-1}
          s_dh[i] = (mt ? 0.f : dh_carry) + dh2 * zg;
        } else {
          const float dc_carry = s_dc[i];
          const float ig = s_big[r * G + u];
          const float fg = s_big[r * G + H + u];
          const float gg = s_big[r * G + 2 * H + u];
          const float og = s_big[r * G + 3 * H + u];
          const float tc = tanhf(s_c2[i]);
          const float do_ = dh2 * tc;
          const float dc2 = (mt ? dc_carry : 0.f) + dh2 * og * (1.f - tc * tc);
          float c_prev = 0.f;
          if (r < nrows)
            c_prev = t > 0 ? cs[((int64_t)(t - 1) * B + r0) * H + i]
                           : c0[(int64_t)r0 * H + i];
          const float df = dc2 * c_prev;
          const float di = dc2 * gg;
          const float dg = dc2 * ig;
          s_big[r * G + u] = di * ig * (1.f - ig);
          s_big[r * G + H + u] = df * fg * (1.f - fg);
          s_big[r * G + 2 * H + u] = dg * (1.f - gg * gg);
          s_big[r * G + 3 * H + u] = do_ * og * (1.f - og);
          s_dh[i] = mt ? 0.f : dh_carry;  // pass-through part of dh_{t-1}
          s_dc[i] = (mt ? 0.f : dc_carry) + dc2 * fg;
        }
      }
    }
    __syncthreads();

    // ---- adjoint: the fed-back sample and the emission NLL
    for (int f = tid; f < F; f += nth) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      // dx = dxp @ w_ih^T; the GRU's dxp differs from the gate part of
      // dbig in its candidate third (dnpre, in s_c2)
      const int JB = kCell == kGRU ? 2 * H : GH;
#pragma unroll 4
      for (int j = 0; j < JB; ++j) {
        const float w = __ldg(w_ihT + (int64_t)j * F + f);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_big[r * G + j], w, acc[r]);
      }
      if (kCell == kGRU) {
#pragma unroll 4
        for (int j = 0; j < H; ++j) {
          const float w = __ldg(w_ihT + (int64_t)(2 * H + j) * F + f);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(s_c2[r * H + j], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool pmt = t >= 1 && t - 1 < len[r];
        float dmean = 0.f, dlv = 0.f;
        if (pmt) {
          const int64_t o = ((int64_t)(t - 1) * B + r0 + r) * F + f;
          const float mean = s_ml[r * 2 * F + f];
          const float lv = s_ml[r * 2 * F + F + f];
          const float dx = acc[r];
          const float eps =
              kSeed ? kernel_noise(seed, t - 1, r0 + r, f) : noise[o];
          if constexpr (kTargets) {
            const float inv_var = expf(-lv);
            const float diff = targets[o] - mean;
            dmean = dx - gnll * diff * inv_var;
            dlv = dx * 0.5f * expf(0.5f * lv) * eps
                  + gnll * 0.5f * (1.f - diff * inv_var * diff);
          } else {
            (void)mean;
            dmean = dx;
            dlv = dx * 0.5f * expf(0.5f * lv) * eps;
          }
        }
        if (kMode == kStream && kCell == kLSTM && t >= 1 && r < nrows) {
          // the caller's cotangents of the emitted position t - 1
          const int64_t o = ((int64_t)(t - 1) * B + r0 + r) * F + f;
          dmean += dmean_up[o];
          dlv += dlogvar_up[o];
        }
        s_ml[r * 2 * F + f] = dmean;
        s_ml[r * 2 * F + F + f] = dlv;
        if (r < nrows) {
          const int64_t o = ((int64_t)t * B + r0 + r) * 2 * F;
          dem_s[o + f] = dmean;
          dem_s[o + F + f] = dlv;
        }
      }
    }
    __syncthreads();

    // ---- adjoint: the emission MLP's hidden layer
    for (int j = tid; j < 2 * M; j += nth) {
      const bool is_m = j < M;
      const float* wT = is_m ? w2mT + j : w2vT + (j - M);
      const int off = is_m ? 0 : F;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int f = 0; f < F; ++f) {
        const float w = __ldg(wT + (int64_t)f * M);
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fmaf(s_ml[r * 2 * F + off + f], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float emh = s_big[r * G + GH + j];
        s_big[r * G + GH + j] = acc[r] * (1.f - emh * emh);
        if (r < nrows) emh_s[((int64_t)t * B + r0 + r) * 2 * M + j] = emh;
      }
    }
    __syncthreads();

    // streams for the weight gradients
    for (int i = tid; i < nrows * G; i += nth)
      dbig_s[((int64_t)t * B + r0) * G + i] = s_big[i];
    for (int i = tid; i < nrows * H; i += nth) {
      hp_s[((int64_t)t * B + r0) * H + i] = s_hp[i];
      if (kCell == kGRU) dnp_s[((int64_t)t * B + r0) * H + i] = s_c2[i];
    }

    // dh_{t-1} = pass-through + dbig @ w_cat^T
    for (int u = tid; u < H; u += nth) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float w = __ldg(w_catT + (int64_t)j * H + u);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_big[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) s_dh[r * H + u] += acc[r];
    }
    __syncthreads();
  }

  for (int i = tid; i < nrows * H; i += nth) {
    dh0[(int64_t)r0 * H + i] = s_dh[i];
    if (kCell == kLSTM) dc0[(int64_t)r0 * H + i] = s_dc[i];
  }
}

// kind: 0 fused-loss forward, 1 fused-loss backward, 2 the plain loop's
// forward (the LSTM cell); 3 fused-loss forward, 4 fused-loss backward (the
// GRU cell); 5 fused-loss forward, 6 fused-loss backward (the Elman / ESN
// cell); 7 the GRU's and 8 the Elman / ESN's plain loop forward; 9, 10, 11
// the plain loop's backward (LSTM, GRU, Elman / ESN cell); 12 the fused-NLL
// forward, 13 its backward (the LSTM cell); 14-19 kinds 0, 1, 3, 4, 5 and
// 6 in seed mode (kSeed).  Floats of shared memory per row of the tile (the
// backward adds the offset-logit cotangent); the kinds without the offset
// MLP are asked with Mo = 0.
constexpr int kSeedKinds[6] = {0, 1, 3, 4, 5, 6};

long long smem_bytes(int kind, int rows, int F, int H, int M, int Mo) {
  long long per_row;
  if (kind >= 14 && kind < 20) kind = kSeedKinds[kind - 14];
  switch (kind) {
    case 0: per_row = 3LL * H + 4LL * H + 2LL * M + F + Mo; break;
    case 1: case 9: case 13:
      per_row = 5LL * H + 4LL * H + 2LL * M + 3LL * F + Mo + 1; break;
    case 2: case 12: per_row = 2LL * H + 4LL * H + 2LL * M + F; break;
    case 3: per_row = 2LL * H + 3LL * H + 2LL * M + F + Mo; break;
    case 4: case 10:
      per_row = 4LL * H + 3LL * H + 2LL * M + 3LL * F + Mo + 1; break;
    case 5: per_row = 2LL * H + 1LL * H + 2LL * M + F + Mo; break;
    case 6: case 11:
      per_row = 3LL * H + 1LL * H + 2LL * M + 3LL * F + Mo + 1; break;
    case 7: per_row = 1LL * H + 3LL * H + 2LL * M + F; break;
    default: per_row = 1LL * H + 1LL * H + 2LL * M + F;
  }
  return (long long)rows * per_row * (long long)sizeof(float);
}

template <int R>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)decoder_fwd_kernel<R, kFusedLosses, kLSTM>;
    case 1: return (const void*)decoder_bwd_kernel<R, kLSTM, kFusedLosses>;
    case 2: return (const void*)decoder_fwd_kernel<R, kStream, kLSTM>;
    case 3: return (const void*)decoder_fwd_kernel<R, kFusedLosses, kGRU>;
    case 4: return (const void*)decoder_bwd_kernel<R, kGRU, kFusedLosses>;
    case 5: return (const void*)decoder_fwd_kernel<R, kFusedLosses, kRNN>;
    case 6: return (const void*)decoder_bwd_kernel<R, kRNN, kFusedLosses>;
    case 7: return (const void*)decoder_fwd_kernel<R, kStream, kGRU>;
    case 8: return (const void*)decoder_fwd_kernel<R, kStream, kRNN>;
    case 9: return (const void*)decoder_bwd_kernel<R, kLSTM, kStream>;
    case 10: return (const void*)decoder_bwd_kernel<R, kGRU, kStream>;
    case 11: return (const void*)decoder_bwd_kernel<R, kRNN, kStream>;
    case 12: return (const void*)decoder_fwd_kernel<R, kFusedNll, kLSTM>;
    case 13: return (const void*)decoder_bwd_kernel<R, kLSTM, kFusedNll>;
    case 14:
      return (const void*)decoder_fwd_kernel<R, kFusedLosses, kLSTM, true>;
    case 15:
      return (const void*)decoder_bwd_kernel<R, kLSTM, kFusedLosses, true>;
    case 16:
      return (const void*)decoder_fwd_kernel<R, kFusedLosses, kGRU, true>;
    case 17:
      return (const void*)decoder_bwd_kernel<R, kGRU, kFusedLosses, true>;
    case 18:
      return (const void*)decoder_fwd_kernel<R, kFusedLosses, kRNN, true>;
    case 19:
      return (const void*)decoder_bwd_kernel<R, kRNN, kFusedLosses, true>;
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
cudaError_t prepare(int kind, int rows, int F, int H, int M, int Mo,
                    int* smem_out) {
  const void* fn = kernel_for(kind, rows);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(kind, rows, F, H, M, Mo);
  if (smem > smem_limit(fn)) return cudaErrorInvalidValue;
  *smem_out = (int)smem;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The kernel kinds (see smem_bytes) of a cell's forward and backward in a
// mode, with or without the seed.
constexpr int fwd_kind(int cell, int mode, bool seed) {
  return mode == kFusedNll ? 12
         : mode == kStream ? (cell == kLSTM ? 2 : cell == kGRU ? 7 : 8)
         : seed            ? (cell == kLSTM ? 14 : cell == kGRU ? 16 : 18)
                           : (cell == kLSTM ? 0 : cell == kGRU ? 3 : 5);
}
constexpr int bwd_kind(int cell, int mode, bool seed) {
  return mode == kFusedNll ? 13
         : mode == kStream ? (cell == kLSTM ? 9 : cell == kGRU ? 10 : 11)
         : seed            ? (cell == kLSTM ? 15 : cell == kGRU ? 17 : 19)
                           : (cell == kLSTM ? 1 : cell == kGRU ? 4 : 6);
}

// The forward's operands, in decoder_fwd_kernel's order.
struct FwdArgs {
  const float *noise; const int* lengths;
  const float *w_cat, *bias, *bias_hh, *b1, *w2m, *w2v, *b2, *w_ih, *targets,
      *wo1, *bo1, *wo2, *bo2, *h0, *c0;
  float *out_last, *hs, *cs;
  double* partial;
  float *outs, *mean_s, *logvar_s;
  int T, B, F, H, M, Mo;
  float leak = 1.f;
};

template <int R, int kMode, int kCell, bool kSeed>
void launch_fwd(int blocks, int smem, cudaStream_t s, const FwdArgs& a) {
  decoder_fwd_kernel<R, kMode, kCell, kSeed><<<blocks, kThreads, smem, s>>>(
      a.noise, a.lengths, a.w_cat, a.bias, a.bias_hh, a.b1, a.w2m, a.w2v,
      a.b2, a.w_ih, a.targets, a.wo1, a.bo1, a.wo2, a.bo2, a.h0, a.c0,
      a.out_last, a.hs, a.cs, a.partial, a.outs, a.mean_s, a.logvar_s, a.T,
      a.B, a.F, a.H, a.M, a.Mo, a.leak);
}

// The backward's operands, in decoder_bwd_kernel's order.
struct BwdArgs {
  const float *noise; const int* lengths;
  const float *w_cat, *bias, *bias_hh, *b1, *w2m, *w2v, *b2, *w_ih, *targets,
      *wo1, *bo1, *wo2, *bo2, *h0, *c0, *w_catT, *w_ihT, *w2mT, *w2vT, *wo1T,
      *hs, *cs, *dlast, *gscale, *douts, *dmean_up, *dlogvar_up;
  float *dh0, *dc0, *hp_s, *dbig_s, *x_s, *emh_s, *dem_s, *h2_s, *doh_s,
      *oh_s, *dzo_s, *dnp_s;
  int T, B, F, H, M, Mo;
  float leak = 1.f;
};

template <int R, int kCell, int kMode, bool kSeed>
void launch_bwd(int blocks, int smem, cudaStream_t s, const BwdArgs& a) {
  decoder_bwd_kernel<R, kCell, kMode, kSeed><<<blocks, kThreads, smem, s>>>(
      a.noise, a.lengths, a.w_cat, a.bias, a.bias_hh, a.b1, a.w2m, a.w2v,
      a.b2, a.w_ih, a.targets, a.wo1, a.bo1, a.wo2, a.bo2, a.h0, a.c0,
      a.w_catT, a.w_ihT, a.w2mT, a.w2vT, a.wo1T, a.hs, a.cs, a.dlast,
      a.gscale, a.douts, a.dmean_up, a.dlogvar_up, a.dh0, a.dc0, a.hp_s,
      a.dbig_s, a.x_s, a.emh_s, a.dem_s, a.h2_s, a.doh_s, a.oh_s, a.dzo_s,
      a.dnp_s, a.T, a.B, a.F, a.H, a.M, a.Mo, a.leak);
}

bool bad_dims(int T, int B, int F, int H, int M, int Mo, bool offset) {
  return T < 1 || B < 1 || F < 1 || H < 1 || M < 1 || (offset && Mo < 1);
}

// A forward of any cell and mode; with a loss (kFusedLosses, kFusedNll),
// then the block-order sum of the per-block loss partials into `losses`.
template <int kCell, int kMode, bool kSeed = false>
int fwd(const FwdArgs& a, float* losses, int rows, void* stream) {
  if (bad_dims(a.T, a.B, a.F, a.H, a.M, a.Mo, kMode == kFusedLosses))
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(fwd_kind(kCell, kMode, kSeed), rows, a.F, a.H,
                            a.M, a.Mo, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + rows - 1) / rows;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = rows == 8   ? &launch_fwd<8, kMode, kCell, kSeed>
            : rows == 4 ? &launch_fwd<4, kMode, kCell, kSeed>
                        : &launch_fwd<2, kMode, kCell, kSeed>;
  go(blocks, smem, s, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || kMode == kStream) return (int)err;
  loss_sum_kernel<<<1, 32, 0, s>>>(a.partial, blocks, losses);
  return (int)cudaGetLastError();
}

template <int kCell, int kMode, bool kSeed = false>
int bwd(const BwdArgs& a, int rows, void* stream) {
  if (bad_dims(a.T, a.B, a.F, a.H, a.M, a.Mo, kMode == kFusedLosses))
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = prepare(bwd_kind(kCell, kMode, kSeed), rows, a.F, a.H,
                            a.M, a.Mo, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.B + rows - 1) / rows;
  auto go = rows == 8   ? &launch_bwd<8, kCell, kMode, kSeed>
            : rows == 4 ? &launch_bwd<4, kCell, kMode, kSeed>
                        : &launch_bwd<2, kCell, kMode, kSeed>;
  go(blocks, smem, (cudaStream_t)stream, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest row tile (8, 4 or 2) whose shared memory fits the card for
// kernel `kind` (see smem_bytes); 0 when none does.
int abcd_decoder_rows(int kind, int F, int H, int M, int Mo) {
  for (int rows = 8; rows >= 2; rows /= 2) {
    const void* fn = kernel_for(kind, rows);
    if (fn != nullptr && smem_bytes(kind, rows, F, H, M, Mo) <= smem_limit(fn))
      return rows;
  }
  return 0;
}

long long abcd_decoder_smem_bytes(int kind, int rows, int F, int H, int M,
                                  int Mo) {
  return smem_bytes(kind, rows, F, H, M, Mo);
}

long long abcd_decoder_smem_limit(int kind, int rows) {
  const void* fn = kernel_for(kind, rows);
  return fn == nullptr ? 0 : smem_limit(fn);
}

// LSTM fused-loss forward (kind 0, or 14 with seed_mode; see the comment at
// the top).  hs / cs may be nullptr (no backward to follow).  `partial`
// holds 2 * ceil(B / rows) doubles; `losses` receives (nll over positions
// 0..T-2, bce over all positions).  seed_mode != 0: `noise` is the (1, 1)
// seed.  The same seed_mode argument selects the seed kinds of the GRU and
// Elman / ESN forwards and of the three backwards below.
int abcd_decoder_fwd(const float* noise, const int* lengths,
                     const float* w_cat, const float* bias, const float* b1,
                     const float* w2m, const float* w2v, const float* b2,
                     const float* w_ih, const float* targets,
                     const float* wo1, const float* bo1, const float* wo2,
                     const float* bo2, const float* h0, const float* c0,
                     float* out_last, float* hs, float* cs, double* partial,
                     float* losses, int T, int B, int F, int H, int M,
                     int Mo, int seed_mode, int rows, void* stream) {
  const FwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, wo1, bo1, wo2, bo2, h0, c0, out_last, hs,
                  cs, partial, nullptr, nullptr, nullptr, T, B, F, H, M, Mo};
  return seed_mode ? fwd<kLSTM, kFusedLosses, true>(a, losses, rows, stream)
                   : fwd<kLSTM, kFusedLosses>(a, losses, rows, stream);
}

// LSTM fused-NLL forward (kind 12): outs (T, B, H) = the pre-mask h2 of
// every step; `losses` receives (nll over positions 0..T-2, 0).  hs / cs
// may be nullptr.
int abcd_decoder_nll_fwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* bias,
                         const float* b1, const float* w2m, const float* w2v,
                         const float* b2, const float* w_ih,
                         const float* targets, const float* h0,
                         const float* c0, float* outs, float* hs, float* cs,
                         double* partial, float* losses, int T, int B,
                         int F, int H, int M, int rows, void* stream) {
  const FwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, nullptr, nullptr, nullptr, nullptr, h0, c0,
                  nullptr, hs, cs, partial, outs, nullptr, nullptr, T, B, F,
                  H, M, 0};
  return fwd<kLSTM, kFusedNll>(a, losses, rows, stream);
}

// GRU fused-loss forward (kind 3): b_ih and b_hh apart, no c0 / cs; hs may
// be nullptr.
int abcd_gru_decoder_fwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* b_ih,
                         const float* b_hh, const float* b1,
                         const float* w2m, const float* w2v, const float* b2,
                         const float* w_ih, const float* targets,
                         const float* wo1, const float* bo1, const float* wo2,
                         const float* bo2, const float* h0, float* out_last,
                         float* hs, double* partial, float* losses, int T,
                         int B, int F, int H, int M, int Mo, int seed_mode,
                         int rows, void* stream) {
  const FwdArgs a{noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
                  targets, wo1, bo1, wo2, bo2, h0, nullptr, out_last, hs,
                  nullptr, partial, nullptr, nullptr, nullptr, T, B, F, H, M,
                  Mo};
  return seed_mode ? fwd<kGRU, kFusedLosses, true>(a, losses, rows, stream)
                   : fwd<kGRU, kFusedLosses>(a, losses, rows, stream);
}

// Elman / ESN fused-loss forward (kind 5): `bias` = b_ih + b_hh (zeros for
// the ESN), no c0 / cs, `leak` in (0, 1]; hs may be nullptr.
int abcd_rnn_decoder_fwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* bias,
                         const float* b1, const float* w2m, const float* w2v,
                         const float* b2, const float* w_ih,
                         const float* targets, const float* wo1,
                         const float* bo1, const float* wo2,
                         const float* bo2, const float* h0, float* out_last,
                         float* hs, double* partial, float* losses, int T,
                         int B, int F, int H, int M, int Mo, float leak,
                         int seed_mode, int rows, void* stream) {
  const FwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, wo1, bo1, wo2, bo2, h0, nullptr, out_last,
                  hs, nullptr, partial, nullptr, nullptr, nullptr, T, B, F,
                  H, M, Mo, leak};
  return seed_mode ? fwd<kRNN, kFusedLosses, true>(a, losses, rows, stream)
                   : fwd<kRNN, kFusedLosses>(a, losses, rows, stream);
}

// The plain sampled loop's forward (kind 2): outs (T, B, H) = the pre-mask
// h2 of every step, mean_s / logvar_s (T, B, F) position-indexed (slot T - 1
// holds step 0's emission).  hs / cs may be nullptr (no backward to follow).
int abcd_decoder_loop_fwd(const float* noise, const int* lengths,
                          const float* w_cat, const float* bias,
                          const float* b1, const float* w2m,
                          const float* w2v, const float* b2,
                          const float* w_ih, const float* h0,
                          const float* c0, float* outs, float* mean_s,
                          float* logvar_s, float* hs, float* cs, int T,
                          int B, int F, int H, int M, int rows,
                          void* stream) {
  const FwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, nullptr, nullptr, nullptr, nullptr, nullptr, h0, c0,
                  nullptr, hs, cs, nullptr, outs, mean_s, logvar_s, T, B, F,
                  H, M, 0};
  return fwd<kLSTM, kStream>(a, nullptr, rows, stream);
}

// The GRU's plain sampled loop (kind 7): outs (T, B, H) = the pre-mask h2
// of every step; b_ih and b_hh apart, no c0 / cs; hs may be nullptr.
int abcd_gru_decoder_loop_fwd(const float* noise, const int* lengths,
                              const float* w_cat, const float* b_ih,
                              const float* b_hh, const float* b1,
                              const float* w2m, const float* w2v,
                              const float* b2, const float* w_ih,
                              const float* h0, float* outs, float* hs, int T,
                              int B, int F, int H, int M, int rows,
                              void* stream) {
  const FwdArgs a{noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
                  nullptr, nullptr, nullptr, nullptr, nullptr, h0, nullptr,
                  nullptr, hs, nullptr, nullptr, outs, nullptr, nullptr, T, B,
                  F, H, M, 0};
  return fwd<kGRU, kStream>(a, nullptr, rows, stream);
}

// The Elman / ESN plain sampled loop (kind 8): outs (T, B, H) = the
// pre-mask h2 of every step; `bias` = b_ih + b_hh (zeros for the ESN), no
// c0 / cs, `leak` in (0, 1]; hs may be nullptr.
int abcd_rnn_decoder_loop_fwd(const float* noise, const int* lengths,
                              const float* w_cat, const float* bias,
                              const float* b1, const float* w2m,
                              const float* w2v, const float* b2,
                              const float* w_ih, const float* h0,
                              float* outs, float* hs, int T, int B, int F,
                              int H, int M, float leak, int rows,
                              void* stream) {
  const FwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, nullptr, nullptr, nullptr, nullptr, nullptr, h0,
                  nullptr, nullptr, hs, nullptr, nullptr, outs, nullptr,
                  nullptr, T, B, F, H, M, 0, leak};
  return fwd<kRNN, kStream>(a, nullptr, rows, stream);
}

// LSTM backward (kind 1; see the comment at the top): writes dh0, dc0 and
// the streams that csrc/wgrad.cu reduces into the weight gradients.
int abcd_decoder_bwd(const float* noise, const int* lengths,
                     const float* w_cat, const float* bias, const float* b1,
                     const float* w2m, const float* w2v, const float* b2,
                     const float* w_ih, const float* targets,
                     const float* wo1, const float* bo1, const float* wo2,
                     const float* bo2, const float* h0, const float* c0,
                     const float* w_catT, const float* w_ihT,
                     const float* w2mT, const float* w2vT, const float* wo1T,
                     const float* hs, const float* cs, const float* dlast,
                     const float* gscale, float* dh0, float* dc0,
                     float* hp_s, float* dbig_s, float* x_s, float* emh_s,
                     float* dem_s, float* h2_s, float* doh_s, float* oh_s,
                     float* dzo_s, int T, int B, int F, int H, int M, int Mo,
                     int seed_mode, int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, wo1, bo1, wo2, bo2, h0, c0, w_catT, w_ihT,
                  w2mT, w2vT, wo1T, hs, cs, dlast, gscale, nullptr, nullptr,
                  nullptr, dh0, dc0, hp_s, dbig_s, x_s, emh_s, dem_s, h2_s,
                  doh_s, oh_s, dzo_s, nullptr, T, B, F, H, M, Mo};
  return seed_mode ? bwd<kLSTM, kFusedLosses, true>(a, rows, stream)
                   : bwd<kLSTM, kFusedLosses>(a, rows, stream);
}

// GRU backward (kind 4): writes dh0 and the LSTM's streams (dbig's gate
// part being dhp) plus dnp_s (T, B, H), the candidate third of dxp.
int abcd_gru_decoder_bwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* b_ih,
                         const float* b_hh, const float* b1,
                         const float* w2m, const float* w2v, const float* b2,
                         const float* w_ih, const float* targets,
                         const float* wo1, const float* bo1, const float* wo2,
                         const float* bo2, const float* h0,
                         const float* w_catT, const float* w_ihT,
                         const float* w2mT, const float* w2vT,
                         const float* wo1T, const float* hs,
                         const float* dlast, const float* gscale, float* dh0,
                         float* hp_s, float* dbig_s, float* x_s,
                         float* emh_s, float* dem_s, float* h2_s,
                         float* doh_s, float* oh_s, float* dzo_s,
                         float* dnp_s, int T, int B, int F, int H, int M,
                         int Mo, int seed_mode, int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
                  targets, wo1, bo1, wo2, bo2, h0, nullptr, w_catT, w_ihT,
                  w2mT, w2vT, wo1T, hs, nullptr, dlast, gscale, nullptr,
                  nullptr, nullptr, dh0, nullptr, hp_s, dbig_s, x_s, emh_s,
                  dem_s, h2_s, doh_s, oh_s, dzo_s, dnp_s, T, B, F, H, M, Mo};
  return seed_mode ? bwd<kGRU, kFusedLosses, true>(a, rows, stream)
                   : bwd<kGRU, kFusedLosses>(a, rows, stream);
}

// Elman / ESN backward (kind 6): writes dh0 and the LSTM's streams, the
// gate part of dbig being dpre (H wide).
int abcd_rnn_decoder_bwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* bias,
                         const float* b1, const float* w2m, const float* w2v,
                         const float* b2, const float* w_ih,
                         const float* targets, const float* wo1,
                         const float* bo1, const float* wo2,
                         const float* bo2, const float* h0,
                         const float* w_catT, const float* w_ihT,
                         const float* w2mT, const float* w2vT,
                         const float* wo1T, const float* hs,
                         const float* dlast, const float* gscale, float* dh0,
                         float* hp_s, float* dbig_s, float* x_s,
                         float* emh_s, float* dem_s, float* h2_s,
                         float* doh_s, float* oh_s, float* dzo_s, int T,
                         int B, int F, int H, int M, int Mo, float leak,
                         int seed_mode, int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, wo1, bo1, wo2, bo2, h0, nullptr, w_catT,
                  w_ihT, w2mT, w2vT, wo1T, hs, nullptr, dlast, gscale,
                  nullptr, nullptr, nullptr, dh0, nullptr, hp_s, dbig_s, x_s,
                  emh_s, dem_s, h2_s, doh_s, oh_s, dzo_s, nullptr, T, B, F, H,
                  M, Mo, leak};
  return seed_mode ? bwd<kRNN, kFusedLosses, true>(a, rows, stream)
                   : bwd<kRNN, kFusedLosses>(a, rows, stream);
}

// LSTM fused-NLL backward (kind 13): `gscale` holds dnll, `douts` (T, B, H)
// the cotangent of outs; writes dh0, dc0 and the streams hp_s, dbig_s, x_s,
// emh_s, dem_s.
int abcd_decoder_nll_bwd(const float* noise, const int* lengths,
                         const float* w_cat, const float* bias,
                         const float* b1, const float* w2m, const float* w2v,
                         const float* b2, const float* w_ih,
                         const float* targets, const float* h0,
                         const float* c0, const float* w_catT,
                         const float* w_ihT, const float* w2mT,
                         const float* w2vT, const float* hs, const float* cs,
                         const float* douts, const float* gscale, float* dh0,
                         float* dc0, float* hp_s, float* dbig_s, float* x_s,
                         float* emh_s, float* dem_s, int T, int B, int F,
                         int H, int M, int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, targets, nullptr, nullptr, nullptr, nullptr, h0, c0,
                  w_catT, w_ihT, w2mT, w2vT, nullptr, hs, cs, nullptr,
                  gscale, douts, nullptr, nullptr, dh0, dc0, hp_s, dbig_s,
                  x_s, emh_s, dem_s, nullptr, nullptr, nullptr, nullptr,
                  nullptr, T, B, F, H, M, 0};
  return bwd<kLSTM, kFusedNll>(a, rows, stream);
}

// The plain LSTM loop's backward (kind 9, decoder_pallas.py:_bwd_kernel):
// `douts` (T, B, H) the cotangent of outs, dmean_s / dlogvar_s (T, B, F)
// those of the position-indexed emission streams (slot T - 1 unread);
// writes dh0, dc0 and the streams hp_s, dbig_s, x_s, emh_s, dem_s.
int abcd_decoder_loop_bwd(const float* noise, const int* lengths,
                          const float* w_cat, const float* bias,
                          const float* b1, const float* w2m,
                          const float* w2v, const float* b2,
                          const float* w_ih, const float* h0,
                          const float* c0, const float* w_catT,
                          const float* w_ihT, const float* w2mT,
                          const float* w2vT, const float* hs,
                          const float* cs, const float* douts,
                          const float* dmean_s, const float* dlogvar_s,
                          float* dh0, float* dc0, float* hp_s,
                          float* dbig_s, float* x_s, float* emh_s,
                          float* dem_s, int T, int B, int F, int H, int M,
                          int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, nullptr, nullptr, nullptr, nullptr, nullptr, h0, c0,
                  w_catT, w_ihT, w2mT, w2vT, nullptr, hs, cs, nullptr,
                  nullptr, douts, dmean_s, dlogvar_s, dh0, dc0, hp_s, dbig_s,
                  x_s, emh_s, dem_s, nullptr, nullptr, nullptr, nullptr,
                  nullptr, T, B, F, H, M, 0};
  return bwd<kLSTM, kStream>(a, rows, stream);
}

// The GRU loop's backward (kind 10, decoder_pallas.py:_gru_bwd_kernel):
// `douts` (T, B, H); writes dh0, the streams of abcd_decoder_loop_bwd (dbig's
// gate part being dhp) and dnp_s (T, B, H), the candidate third of dxp.
int abcd_gru_decoder_loop_bwd(const float* noise, const int* lengths,
                              const float* w_cat, const float* b_ih,
                              const float* b_hh, const float* b1,
                              const float* w2m, const float* w2v,
                              const float* b2, const float* w_ih,
                              const float* h0, const float* w_catT,
                              const float* w_ihT, const float* w2mT,
                              const float* w2vT, const float* hs,
                              const float* douts, float* dh0, float* hp_s,
                              float* dbig_s, float* x_s, float* emh_s,
                              float* dem_s, float* dnp_s, int T, int B,
                              int F, int H, int M, int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, b_ih, b_hh, b1, w2m, w2v, b2, w_ih,
                  nullptr, nullptr, nullptr, nullptr, nullptr, h0, nullptr,
                  w_catT, w_ihT, w2mT, w2vT, nullptr, hs, nullptr, nullptr,
                  nullptr, douts, nullptr, nullptr, dh0, nullptr, hp_s,
                  dbig_s, x_s, emh_s, dem_s, nullptr, nullptr, nullptr,
                  nullptr, dnp_s, T, B, F, H, M, 0};
  return bwd<kGRU, kStream>(a, rows, stream);
}

// The Elman / ESN loop's backward (kind 11, decoder_pallas.py:
// _rnn_bwd_kernel): `douts` (T, B, H), `leak` in (0, 1]; writes dh0 and the
// streams of abcd_decoder_loop_bwd (dbig's gate part being dpre).
int abcd_rnn_decoder_loop_bwd(const float* noise, const int* lengths,
                              const float* w_cat, const float* bias,
                              const float* b1, const float* w2m,
                              const float* w2v, const float* b2,
                              const float* w_ih, const float* h0,
                              const float* w_catT, const float* w_ihT,
                              const float* w2mT, const float* w2vT,
                              const float* hs, const float* douts,
                              float* dh0, float* hp_s, float* dbig_s,
                              float* x_s, float* emh_s, float* dem_s, int T,
                              int B, int F, int H, int M, float leak,
                              int rows, void* stream) {
  const BwdArgs a{noise, lengths, w_cat, bias, nullptr, b1, w2m, w2v, b2,
                  w_ih, nullptr, nullptr, nullptr, nullptr, nullptr, h0,
                  nullptr, w_catT, w_ihT, w2mT, w2vT, nullptr, hs, nullptr,
                  nullptr, nullptr, douts, nullptr, nullptr, dh0, nullptr,
                  hp_s, dbig_s, x_s, emh_s, dem_s, nullptr, nullptr, nullptr,
                  nullptr, nullptr, T, B, F, H, M, 0, leak};
  return bwd<kRNN, kStream>(a, rows, stream);
}

// The (T, B, F) draws of the seed kinds for the (1, 1) float32 `seed`
// (decoder_pallas.decoder_noise_dump), into `out`; `bits` (T, B, F, 2) int32
// or nullptr receives the 24-bit integers of the uniforms.
int abcd_decoder_noise_dump(const float* seed, float* out, int* bits, int T,
                            int B, int F, void* stream) {
  if (T < 1 || B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)T * B * F;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  noise_dump_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      seed, out, bits, T, B, F);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
