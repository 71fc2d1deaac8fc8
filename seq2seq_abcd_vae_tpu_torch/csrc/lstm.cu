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
//   One direction over xp (T, B, 4H) (kind 2; its backward by the cluster
//   and grid designs below) replaces
//   seq2seq_abcd_vae_tpu/ops/lstm_pallas.py:lstm_layer, forward
//   (`_fwd_call` / `_fwd_kernel`) and backward (`_bwd_call` /
//   `_bwd_kernel`); `reverse` selects the span [T - len, T) (the caller
//   flips xp in time, as models/rnn.py:run_rnn_layer does).  Both
//   directions over xp (T, 2, B, 4H) in one launch (kPair = true, kind 4,
//   and lstm_pair_bwd_kernel, kind 5) replace lstm_pallas.py:
//   lstm_layer_bidir, forward (`_fwd2_call` / `_fwd2_kernel`) and backward
//   (`_bwd2_call` / `_bwd2_kernel`): the TPU kernel steps both directions'
//   time loops in one grid, and here the two directions are the y blocks of
//   one launch; direction 1's xp is already flipped in time and active on
//   [T - len, T), as in the raw mode.  The backwards' dxp is their dz
//   stream (direction-major, (D, T, B, 4H)).
//
// In both modes outs holds the MASKED carry h after each step (a row's
// carries are frozen outside its span), gates are in torch order
// (i, f, g, o), and every tensor is float32 and contiguous.
//
// What bounds them on the H100: the float32 operations are 2 * 4H * (F + H)
// (raw) or 2 * 4H * H (projected) multiply-adds per row, step and direction,
// but the time loop is sequential and every step needs all of the weights
// (1.58 MB per direction at H=256, F=129), far more than one SM holds.
//
// Per-tile design (lstm_fwd_kernel, kinds 0, 2 and 4; lstm_pair_bwd_kernel,
// kind 5): CUDA blocks run in no order, so the time loop lives inside the
// block, as the
// TPU's sequential grid axis did.  One block per (direction, tile of R
// batch rows) owns all 4H gate columns of its rows; R (8, 4 or 2) is chosen
// at launch so that the block's shared memory fits the card.  In the
// forward each thread owns one or more hidden units (u = tid, tid +
// blockDim, ...): it accumulates a unit's four gates for the tile's rows in
// registers, so no gate leaves the thread, and writes the new h into the
// other half of a double-buffered shared h (c lives in shared memory beside
// it, touched only by its unit's thread): one barrier a step.  The weights
// are re-read from L2 at every step and one SM does a tile's whole step, so
// a step costs ~47 us at any grid size: at the serve shape (B=64: 16
// blocks) 12% of the SMs do all the work.
//
// Cluster design of the forward (lstm_fwd_cluster_kernel; the raw forward,
// kind 0, replacing lstm_pallas.py:646 `_fwdf_call`; and, as its projected
// mode, the one-direction forward of kind 2, replacing lstm_pallas.py:149
// `_fwd_call`): the weights live in shared memory for the whole sequence,
// split across a thread-block cluster of C = 8 CTAs (the portable maximum)
// per (direction, tile of R rows).  CTA c owns hidden units
// [c H / C, (c + 1) H / C): all four gates of them, as W_ih and W_hh column
// slices loaded once with cp.async ((F + H) * 4H / C floats: 197,120 bytes
// at F=129, H=256; with h double-buffered and one step's x rows and x-half
// sums, 232,000 of the 232,448 a block may have, at R = 10).  A thread owns
// one unit's four gate columns for four of the tile's rows (h kept R
// rounded to 4 rows a k), so a warp reads a weight row as one
// conflict-free LDS.128 and h of its four rows as one broadcast LDS.128, and
// keeps the unit's c and h in registers; the loads run one group of four
// rows ahead of the FMAs.  Raw mode: two roles of 3 x 32 threads at H=256:
// the h warps run step t (ax(t) into registers, a wait on an mbarrier for
// the peers' slices of h_t, the h half of the gate sums, the gates, c and
// h, which each thread writes into the next-h buffer of its own CTA and,
// with st.async counted on the peer's mbarrier, of every peer); the x warps
// meanwhile compute the x half of step t + 1, which needs no h, stage
// x_{t+2} with cp.async, and write ax(t+1) once the h warps have taken
// ax(t).  Projected mode: no W_ih slice and no x warps (the slice is W_hh
// alone, 131,072 bytes, which leaves room for R = 36 rows); each h thread
// loads its unit's four xp values for the next step into registers while
// the step runs.  A CTA barrier ends a step; no cluster-wide barrier runs
// between the first step and the last.  Each dot product stays in one
// thread in the per-tile kernel's order (x over F, then h over H, then
// ((ax + bx) + ah) + bh, or (xp + ah) + bh), so the sums stay at the
// per-tile kernel's; the gates use the hardware reciprocal with one Newton
// step and tanh x = 2 sigmoid(2x) - 1 (within 1e-7 of expf / tanhf),
// without the branches that made them a fifth of a step.  Every CTA runs
// every step, also when its rows are past the batch.  What bounds it: a
// step's h half (256 weight rows of two LDS.128 and 16 FMAs for each h
// warp, a broadcast LDS.128 costing four shared-memory wavefronts), then
// the gates and the exchange: ~6.2 us a step at R = 10 (raw), ~5.1 us at
// R = 12 and ~11.6 us at R = 36 (projected).  The card holds 15 such
// clusters at once (cudaOccupancyMaxActiveClusters on the H100): R = 10
// puts B=64 in 14 (raw, one wave), and the projected mode's R = 36 puts
// B=512 in 15, R = 12 B=64 in 6.
//
// "Proj" design of the raw forward (kind 0's third design; replacing
// lstm_pallas.py:646 `_fwdf_call` where the raw cluster kernel's W_ih slice
// does not fit: F > 129 at H=256, so the 177 bins of 44.1 kHz, the 193 of
// 48 kHz and a second layer's F = 2H).  The per-tile kernel computes x_t
// W_ih inside its sequential loop, re-reading both weights from L2 every
// step (~47 us a step at any grid); only h_{t-1} W_hh depends on the
// previous step.  So: (a) xp = x W_ih + b_ih for every active row-step of
// both directions at once, as the raw backward's tiled FP32 product
// (lstm_gates_kernel with kXp: rows in the span prefix's order, so a
// row-step outside its span costs no product and is never written; one
// chain a dot product, x over F in order, then b_ih), into a (T, 2, B, 4H)
// buffer with direction 1 flipped in time: 268 MB at B=64, T=512 and
// 524 MB at B=512, T=125 for H=256, where the TPU kernel kept the
// projection in VMEM (seq2seq_abcd_vae_tpu/models/rnn.py:240-244); then (b)
// the recurrence over it in the cluster design's projected mode extended
// to both directions in one launch (kPair: grid z = direction), W_hh's
// slice resident (131,072 bytes a CTA at H=256, whatever F is), each sum
// (xp + h W_hh) + b_hh, so the order ((x W_ih + b_ih) + h W_hh) + b_hh of
// the other designs.  At B=64 the 12-row tile puts both directions in 12
// clusters, one wave of the 15 an H100 holds.
//
// Shape rules (ops/lstm_kernel.py, decided before the launch from the
// cudaOccupancyMaxActiveClusters queries abcd_lstm_cluster_max_active,
// abcd_lstm_pair_cluster_max_active and abcd_lstm_fwd_cluster_max_active):
// forward_design takes the raw cluster kernel when H is a multiple of C,
// its shared memory fits the card (F <= 129 at H=256: not H=1024, not
// F=177 or a second layer's F = 2H) and its grid of 2 * ceil(B / R)
// clusters runs in few enough waves of the resident clusters; else the
// "proj" design where the pair's projected mode takes H (a multiple of C up
// to 256; any F, any B), its row tile the smallest whose 2 * ceil(B / R)
// clusters fit one wave, else the widest; else the per-tile kernel (H=1024,
// H not a multiple of 8).  layer_design takes the projected mode (H a
// multiple of C up to 256) with the smallest row tile whose ceil(B / R)
// clusters fit one wave, else the widest; the per-tile kernels otherwise.
//
// Cluster design of the raw backward (kind 1's; replacing lstm_pallas.py:682
// `_bwdf_call`; lstm_gates_kernel, lstm_bwd_cluster_kernel,
// lstm_dx_kernel).  The per-tile backward carries three products through
// its time loop (the gates recomputed from x and h_{t-1}, and dz @ [W_hh |
// W_ih]^T), each pulling the weights and their transposes from L2 into one
// SM, 3.1 MB a step a direction: ~259 us a step.  Only dh_{t-1} = dz_t
// W_hh^T depends on the previous step.  So: (a) the gates of every active
// row-step of both directions at once, from x and the saved outs (h_{t-1}),
// as a tiled product with its epilogue applying the gate functions (rows
// in a span prefix's order, so no row outside its span costs a product);
// (b) the recurrence in a cluster of C = 8 CTAs per (direction, tile of R
// rows), CTA c holding the W_hh columns of its units (131,072 bytes at
// H=256) for the whole sequence: per step it forms its units' dz, then the
// partial dh_{t-1} over its own gate columns for all H units, and a
// reduce-scatter over DSMEM (st.async on the owner's mbarrier; H R floats
// out of each CTA a step, the forward's exchange volume) hands each CTA the
// C partials of its units, added in rank order so a run repeats exactly;
// (c) dx after the loop from both directions' dz as one tiled product; (d)
// the weight gradients by csrc/wgrad.cu as before.  Without W_ih in the
// loop F does not bound the design: a second layer's F = 2H is taken.  The
// products (a) and (c) run FP32 FMAs (no TF32: the port runs at the
// `highest` precision) on 8 x 8 thread tiles, since a warp's LDS.128 costs
// four wavefronts even as a broadcast.  What bounds it on the H100 (700 W)
// at B=512, T=125: (a) ~2.0 ms, (b) ~2.7 ms (R = 36, two waves of 15
// clusters, ~10.9 us a step: the product's shared-memory wavefronts, then
// the exchange), (c) ~1.0 ms, (d) ~7.5 ms.  Shape rule
// (ops/lstm_kernel.py:backward_design, from
// abcd_lstm_bwd_cluster_max_active): H a multiple of 4 C up to 256 and
// the slice fitting the card, at any batch (its 2 * ceil(B / 36) clusters
// run in waves); the grid design otherwise.  (R = 16 takes ~5.5 us a step
// against R = 36's ~10.9: it would win only at B <= 112, which no path
// trains at.)  The one-direction backward (kind 3's; replacing
// lstm_pallas.py:192 `_bwd_call`) takes the same rule and the same
// cluster recurrence with D = 1: (a) the gates from xp
// (lstm_gates_kernel's kGatesLayer mode), (b) the recurrence, whose dz is
// dxp, and (d) below.
//
// Grid design of both backwards (design "tile": H=1024, H not a multiple
// of 32; lstm_bwd_step_kernel).  Where W_hh does not fit a cluster (16 MB
// a direction at H=1024), the recurrence dh_{t-1} = dz_t W_hh^T is one
// tiled product a step over the whole grid, (B x 4H) by (4H x H) for
// every direction at once, W_hh^T read through L2 (both directions fit
// the 50 MB L2), one launch a step issued from a C loop
// (abcd_lstm_bwd_grid), the step's elementwise backward (dz_{t-1} over the
// gates, the dc carry, the pass-through of dh) in the product's epilogue.
// Rows are ordered by length, longest first, so that the rows active at a
// step are a prefix and a tile of inactive rows skips its product; a
// cluster of eight CTAs splits each tile's depth and adds the partial
// tiles in rank order over DSMEM, so the grid has 8x the CTAs as the
// active rows thin out and a run repeats bit for bit.  (a) and (c) are
// the cluster design's; (d) of both designs of the one-direction backward
// and of the raw grid design sums over the active row-steps only in the
// span prefix's order (lstm_wgrad_kernel: 8 x 8 thread tiles, [x | h_prev]
// against dz; lstm_bias_kernel: the bias row).  On the H100 (700 W) at
// B=512, T=125, F=129, H=1024: (a) ~17 ms, (b) ~29 ms (~0.24 ms a step: the
// product at about a third of the FP32 rate), (c) ~4 ms, (d) ~20 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // forward: min(H rounded to 32, 512)
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The cluster kernel's gates, without branches: 1 / (1 + e^-x) as the
// hardware reciprocal and one Newton step (within an ulp or so of the
// correctly rounded quotient), x clamped at -80 so that e^-x stays finite
// (sigmoid(-80) = 1.8e-35), and tanh x = 2 sigmoid(2x) - 1 (absolute error
// about 1e-7 where tanhf is relative).  The divisions and the branches of
// expf-based tanhf made the gates a fifth of a step.
__device__ __forceinline__ float sigmoid_fast(float x) {
  const float y = 1.f + expf(-fmaxf(x, -80.f));
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

__device__ __forceinline__ float tanh_fast(float x) {
  return fmaf(2.f, sigmoid_fast(2.f * x), -1.f);
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


// ---------------------------------------------------------------------------
// Cluster design of the forward, raw input (row 2) or projected (row 3); see
// the header
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterCtas = 8;       // C: CTAs a cluster (the portable most)
constexpr int kClusterRows = 10;      // R of the raw forward's tile
constexpr int kGroupRows = 4;         // rows a thread owns
constexpr int kClusterMaxThreads = 256;

// Rows a tile (R), rows of h kept per k (R rounded to 4), row groups of four,
// and the most threads a CTA has (the raw mode: two roles at R = 10; the
// projected mode: one role of RS / 4 row groups, one warp each at H <= 256).
template <bool kProj, int R>
struct ClusterShape {
  static_assert(kProj || R == kClusterRows, "the raw mode's x staging is "
                "laid out for 10 rows");
  static constexpr int RS = (R + 3) / 4 * 4;
  static constexpr int RG = RS / kGroupRows;
  static constexpr int kRoles = kProj ? 1 : 2;
  static constexpr int kMaxThreads = kProj ? RG * 32 : kClusterMaxThreads;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes from src, or zeros (src unread) when !ok.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes from src (16-byte aligned), or zeros (src unread) when !ok.
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Named barriers (0 is __syncthreads's): `n` threads meet at barrier `id`;
// a thread that only arrives does not wait.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of complete_tx in this phase.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// step's wait lasts microseconds; one that outlasts 2^24 polls can never
// end, and traps (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// 16 bytes into CTA `rank`'s copy of `dst` (the same offset in its shared
// memory), counted as complete_tx on its copy of `bar`.
__device__ __forceinline__ void st_async_peer(float4* dst, uint64_t* bar,
                                              int rank, float4 v) {
  uint32_t rd, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rd)
               : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(rd),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

// acc[g][q] += v.q * w.g: one k of a unit's four gates for four rows.
__device__ __forceinline__ void fma_unit(const float4& w, const float4& v,
                                         float acc[4][kGroupRows]) {
  const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    acc[g][0] = fmaf(v.x, ws[g], acc[g][0]);
    acc[g][1] = fmaf(v.y, ws[g], acc[g][1]);
    acc[g][2] = fmaf(v.z, ws[g], acc[g][2]);
    acc[g][3] = fmaf(v.w, ws[g], acc[g][3]);
  }
}

// acc[g][q] += v_q[k] * w[k ldw + g] for k = 0..n-1 in order: one unit's
// four gate columns (w, 16-byte aligned) for one row group's four rows,
// whose values at k are v[k VS .. k VS + 3] (kTwo: only two rows,
// v[k VS .. k VS + 1], the other two zero).  A warp reads a k as one
// conflict-free LDS.128 of weights and one broadcast load of v.  The loads
// run one group of four k ahead of the FMAs, in two register sets used in
// turn, so that with one warp a scheduler the shared-memory latency hides
// behind the other group's 64 FMAs.
template <int VS, bool kTwo>
__device__ __forceinline__ void unit_dot(const float* __restrict__ w,
                                         int ldw,
                                         const float* __restrict__ v, int n,
                                         float acc[4][kGroupRows]) {
  auto vload = [&](int k) {
    if (kTwo) {
      const float2 a = *reinterpret_cast<const float2*>(v + k * VS);
      return make_float4(a.x, a.y, 0.f, 0.f);
    }
    return *reinterpret_cast<const float4*>(v + k * VS);
  };
  float4 wa[4], va[4], wb[4], vb[4];
  auto load = [&](int k0, float4* wv, float4* vv) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv[j] = *reinterpret_cast<const float4*>(w + (k0 + j) * ldw);
      vv[j] = vload(k0 + j);
    }
  };
  auto fma4 = [&](const float4* wv, const float4* vv) {
#pragma unroll
    for (int j = 0; j < 4; ++j) fma_unit(wv[j], vv[j], acc);
  };
  const int groups = n / 4;
  if (groups > 0) {
    load(0, wa, va);
    int g = 0;
    for (; g + 2 < groups; g += 2) {
      load(4 * g + 4, wb, vb);
      fma4(wa, va);
      load(4 * g + 8, wa, va);
      fma4(wb, vb);
    }
    if (g + 1 < groups) {
      load(4 * g + 4, wb, vb);
      fma4(wa, va);
      fma4(wb, vb);
    } else {
      fma4(wa, va);
    }
  }
  for (int k = 4 * groups; k < n; ++k)
    fma_unit(*reinterpret_cast<const float4*>(w + k * ldw), vload(k), acc);
}

// Threads of one row group of one role: the CTA's H / C units, rounded up
// to whole warps.
__host__ __device__ inline int cluster_group_threads(int H) {
  return (H / kClusterCtas + 31) / 32 * 32;
}

template <bool kProj, int R>
__host__ __device__ inline int cluster_threads(int H) {
  using S = ClusterShape<kProj, R>;
  return S::kRoles * S::RG * cluster_group_threads(H);
}

// Floats of one step's x rows in shared memory, rounded up to whole
// float4s (the raw mode).
__host__ __device__ inline int cluster_x_floats(int F) {
  return (kClusterRows * F + 3) & ~3;
}

// Shared memory of one CTA.  Raw mode: the W_ih and W_hh slices, h
// double-buffered (RS rows a k), the x rows of one step and the x half's
// sums, and the two h buffers' mbarriers: 232,000 bytes at F=129, H=256.
// Projected mode: the W_hh slice, h double-buffered and the mbarriers.
template <bool kProj, int R>
long long cluster_smem_bytes(int F, int H) {
  using S = ClusterShape<kProj, R>;
  const long long g4 = 4LL * (H / kClusterCtas);
  long long floats = (long long)H * g4 + 2LL * H * S::RS;
  if (!kProj) floats += (long long)F * g4 + cluster_x_floats(F) + R * g4;
  return floats * (long long)sizeof(float) + 2LL * (long long)sizeof(uint64_t);
}

// Grid (C, ceil(B / R), D), cluster (C, 1, 1), cluster_threads(H) threads:
// per role, per row group of four rows, one thread per unit of the CTA's
// slice (the slice's columns 4 u .. 4 u + 3 are the unit's gates i, f, g,
// o).  Role 0 (the h warps) runs step t: it takes ax(t) into registers,
// waits on its mbarrier for the peers' slices of h_t, computes the h half
// of the sums, the gates, c and h of its unit and rows, and writes its h
// into the next-h buffer here and, with st.async, in every peer.  In the
// raw mode (D = 2, direction 1 reading x in flipped time) role 1 (the x
// warps) meanwhile computes the x half of step t + 1 from x_{t+1} in shared
// memory (the third row group holds rows 8, 9 and two rows that are never
// active), stages x_{t+2} there, and writes ax(t+1) once the h warps have
// taken ax(t).  In the projected mode (D = 1, `reverse` picking the span)
// there is no role 1: ax(t) is the unit's four xp values, which each h
// thread loads into registers one step ahead (only at its rows' active
// steps: elsewhere zeros, whose gates the span mask discards).  kPair
// (projected mode over both directions, D = 2): xp is (T, 2, B, 4H) with
// direction 1 already flipped in time and active on [T - len, T), as the
// raw mode's direction 1.  One CTA barrier ends a step; outs and cs of
// step t are stored after it.
template <bool kProj, int R, bool kPair = false>
__global__ void __launch_bounds__(ClusterShape<kProj, R>::kMaxThreads)
    lstm_fwd_cluster_kernel(
        const float* __restrict__ x,       // raw (T, B, F) | xp (T, D, B, 4H)
        const int* __restrict__ lengths,   // (B,)
        const float* __restrict__ w_ih,    // raw (2, F, 4H) | unused
        const float* __restrict__ b_ih,    // raw (2, 4H) | unused
        const float* __restrict__ w_hh,    // (D, H, 4H)
        const float* __restrict__ b_hh,    // (D, 4H)
        float* __restrict__ outs,          // (T, D, B, H)
        float* __restrict__ cs,            // (T, D, B, H) or nullptr
        float* __restrict__ h_n,           // (D, B, H)
        float* __restrict__ c_n,           // (D, B, H)
        int T, int B, int F, int H, int reverse) {
  using S = ClusterShape<kProj, R>;
  constexpr int RS = S::RS;
  constexpr int C = kClusterCtas;
  constexpr int Q = kGroupRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int U = H / C;                  // units of this CTA
  const int G4 = 4 * U;                 // gate columns of this CTA
  const int G = 4 * H;
  const int GT = cluster_group_threads(H);
  const int RT = S::RG * GT;            // threads of a role
  static_assert(kProj || !kPair, "the pair mode is a projected mode");
  constexpr int D = kProj && !kPair ? 1 : 2;  // directions: the grid's z
  const int d = blockIdx.z;
  const int r0 = blockIdx.y * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int role = kProj ? 0 : tid / RT;  // 0: h warps, 1: x warps
  const int ridx = tid - role * RT;     // index within the role
  const int rb = (ridx / GT) * Q;       // first row of this thread
  const int ul = ridx % GT;
  const bool live = ul < U;             // lanes past the slice idle
  const int ucol = 4 * (live ? ul : U - 1);  // the unit's first column
  const int unit = rank * U + ucol / 4;
  const bool rev = kProj && !kPair ? reverse != 0 : d == 1;

  extern __shared__ float4 smem4[];
  float* s_wi = reinterpret_cast<float*>(smem4);   // raw: [F][G4]
  float* s_wh = s_wi + (kProj ? 0 : F * G4);       // [H][G4]
  float* s_h = s_wh + H * G4;                      // [2][H][RS]
  // raw: x_t's rows (rows 0-3 and 4-7 as [F][4] each, rows 8-9 as [F][2])
  float* s_x = s_h + 2 * H * RS;
  float* s_ax = s_x + (kProj ? 0 : cluster_x_floats(F));  // raw: [R][G4]
  // s_full[b]: the peers' slices of the h in buffer b have landed
  uint64_t* s_full =
      reinterpret_cast<uint64_t*>(s_ax + (kProj ? 0 : R * G4));

  const float* wi = kProj ? nullptr : w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;
  for (int i = tid; i < 2 * H * RS + (kProj ? 0 : cluster_x_floats(F));
       i += nth)
    s_h[i] = 0.f;
  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the slices, once: column c of the slice is gate c % 4 of unit
  // rank * U + c / 4
  if (!kProj) {
    for (int i = tid; i < F * G4; i += nth) {
      const int k = i / G4, c = i - k * G4;
      cp_async4(s_wi + i,
                wi + (int64_t)k * G + (c & 3) * H + rank * U + (c >> 2));
    }
  }
  for (int i = tid; i < H * G4; i += nth) {
    const int k = i / G4, c = i - k * G4;
    cp_async4(s_wh + i, wh + (int64_t)k * G + (c & 3) * H + rank * U + (c >> 2));
  }
  // x_t's rows of this direction into s_x, by the x warps (rows past the
  // batch stay zero)
  auto stage_x = [&](int t) {
    const int tx = d == 0 ? t : T - 1 - t;
    const float* src = x + ((int64_t)tx * B + r0) * F;
    for (int i = ridx; i < nrows * F; i += RT) {
      const int r = i / F, k = i - r * F;
      cp_async4(s_x + (r < 8 ? (r / 4) * 4 * F + 4 * k + (r & 3)
                             : 8 * F + 2 * k + (r - 8)),
                src + i);
    }
  };
  // x half of a step's sums from s_x, into ax
  auto x_half = [&](float ax[4][Q]) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < Q; ++q) ax[g][q] = 0.f;
    if (rb < 8)
      unit_dot<4, false>(s_wi + ucol, G4, s_x + rb * F, F, ax);
    else
      unit_dot<2, true>(s_wi + ucol, G4, s_x + 8 * F, F, ax);
  };
  auto store_ax = [&](float ax[4][Q]) {
    if (live) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (rb + q < R)
          *reinterpret_cast<float4*>(s_ax + (rb + q) * G4 + ucol) =
              make_float4(ax[0][q], ax[1][q], ax[2][q], ax[3][q]);
    }
  };
  if (!kProj && role == 1) stage_x(0);
  cp_async_wait_all();
  __syncthreads();  // slices and x_0 in place
  if (!kProj && role == 1) {
    float ax[4][Q];
    x_half(ax);
    store_ax(ax);
    named_sync(4, RT);  // every x warp is done with x_0
    if (T > 1) stage_x(1);
  }
  // ax(0) is complete, and every CTA of the cluster has started (its
  // barriers initialised, its h buffers zeroed) before any writes a peer
  cluster_arrive();
  cluster_wait();
  const int tx_bytes = (C - 1) * U * S::RG * (int)sizeof(float4);

  if (role == 0) {
    int len[Q];
    float bx[4], bh[4], c[Q], h[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      len[q] = rb + q < nrows ? lengths[r0 + rb + q] : 0;
      c[q] = 0.f;
      h[q] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bx[g] = kProj ? 0.f : b_ih[d * G + g * H + unit];
      bh[g] = b_hh[d * G + g * H + unit];
    }
    // projected mode: the unit's four xp values of step t for the thread's
    // rows (zeros past the batch and at steps outside a row's span)
    auto load_xp = [&](int t, float4 v[Q]) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && rb + q < nrows && span_active(t, T, len[q], rev)) {
          const float* p =
              x + (((int64_t)t * D + d) * B + r0 + rb + q) * G + unit;
          v[q] = make_float4(p[0], p[H], p[2 * H], p[3 * H]);
        }
      }
    };
    float4 xn[Q];  // projected mode: xp of the next step, in flight
    if (kProj) load_xp(0, xn);
    for (int t = 0; t < T; ++t) {
      const int cur = t & 1;
      float* hn = s_h + (cur ^ 1) * H * RS;
      float4 ax[Q];  // ax(t), which the x warps may then overwrite
      if (kProj) {
#pragma unroll
        for (int q = 0; q < Q; ++q) ax[q] = xn[q];
        if (t + 1 < T) load_xp(t + 1, xn);
      } else {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          ax[q] = rb + q < R ? *reinterpret_cast<const float4*>(
                                   s_ax + (rb + q) * G4 + ucol)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        if (t + 1 < T) named_arrive(3, nth);
      }
      // the peers' slices of h_t: buffer cur's ((t - 1) / 2)-th phase
      if (t > 0) mbar_wait(&s_full[cur], ((t - 1) >> 1) & 1);
      float ah[4][Q];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int q = 0; q < Q; ++q) ah[g][q] = 0.f;
      unit_dot<RS, false>(s_wh + ucol, G4, s_h + cur * H * RS + rb, H, ah);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float axg[4] = {ax[q].x, ax[q].y, ax[q].z, ax[q].w};
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          // the reference's association: (x W_ih + b_ih) + h W_hh + b_hh,
          // and xp + h W_hh + b_hh in the projected mode
          z[g] = kProj ? (axg[g] + ah[g][q]) + bh[g]
                       : ((axg[g] + bx[g]) + ah[g][q]) + bh[g];
        const float ig = sigmoid_fast(z[0]);
        const float fg = sigmoid_fast(z[1]);
        const float gg = tanh_fast(z[2]);
        const float og = sigmoid_fast(z[3]);
        const float c2 = fg * c[q] + ig * gg;
        const float h2 = og * tanh_fast(c2);
        if (span_active(t, T, len[q], rev)) {
          c[q] = c2;
          h[q] = h2;
        }
      }
      // arm buffer cur ^ 1 for the peers' slices of h_{t+1} (its last
      // phase, h_{t-1}'s, completed before this step began)
      if (tid == 0 && t + 1 < T)
        mbar_arrive_expect(&s_full[cur ^ 1], tx_bytes);
      if (live) {
        // h of this unit and rows into the next-h buffer, here and at the
        // same place in every peer, counted on the peer's barrier (a peer
        // sends h_{t+2} into the other buffer only after this CTA's slice
        // of h_{t+1}, so no buffer is overwritten while it is read)
        const float4 hv = make_float4(h[0], h[1], h[2], h[3]);
        float4* mine = reinterpret_cast<float4*>(hn + unit * RS + rb);
        *mine = hv;
        if (t + 1 < T) {
#pragma unroll
          for (int p = 1; p < C; ++p)
            st_async_peer(mine, &s_full[cur ^ 1], (rank + p) % C, hv);
        }
      }
      named_sync(1, nth);  // the local slice of h_{t+1} and ax(t+1) written
      if (live) {          // outs and cs of step t, behind the next step
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (rb + q < nrows) {
            const int64_t o =
                (((int64_t)t * D + d) * B + r0 + rb + q) * H + unit;
            outs[o] = h[q];
            if (cs) cs[o] = c[q];
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (rb + q < nrows) {
          const int64_t o = ((int64_t)d * B + r0 + rb + q) * H + unit;
          h_n[o] = h[q];
          c_n[o] = c[q];
        }
      }
    }
  } else {
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) {
        cp_async_wait_all();
        named_sync(4, RT);  // x_{t+1} in place
        float ax[4][Q];
        x_half(ax);
        named_sync(4, RT);  // every x warp is done with x_{t+1}
        if (t + 2 < T) stage_x(t + 2);
        named_sync(3, nth);  // the h warps have taken ax(t)
        store_ax(ax);
      }
      named_sync(1, nth);
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Cluster design of the raw-input backward (row 2b): the gate recompute and
// dx as tiled products over all row-steps, the dh recurrence in a cluster
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 256;   // 16 x 16 threads a tile
constexpr int kGemmDepth = 16;      // k of one staged pair of tiles

// Per thread (tr, tc) of a BM x BN tile: acc[i][j] += A[k][row(i)] *
// B[k][col(j)] for the staged depth in order, A staged as [k][BM + 4] and B
// as [k][BN + 4].  The thread's rows are TM / 4 float4 chunks, chunk c at
// c BM / (TM / 4) + 4 tr (row(i) = that + i % 4 for i / 4 = c), its columns
// likewise with tc, so a quarter-warp's LDS.128 of B is contiguous.  A warp's
// LDS.128 costs four shared-memory wavefronts even when it broadcasts, so a
// thread's TM TN FMAs a k cost TM + TN wavefronts: 8 x 8 balances the FMA
// pipes (four instructions a cycle) against one wavefront a cycle, and with
// the tiles' own stores shared memory bounds the products at about half
// the FMA rate (deeper staging, 32 k or three and four stages, measured no
// faster on the H100).
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void gemm_depth(const float* __restrict__ sa,
                                           const float* __restrict__ sb,
                                           int tr, int tc,
                                           float acc[TM][TN]) {
  constexpr int LDA = BM + 4, LDB = BN + 4;
  constexpr int CA = BM / (TM / 4), CB = BN / (TN / 4);
#pragma unroll
  for (int k = 0; k < kGemmDepth; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int c = 0; c < TM / 4; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(sa + k * LDA + c * CA + 4 * tr);
      a[4 * c] = v.x, a[4 * c + 1] = v.y, a[4 * c + 2] = v.z,
      a[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const float4 v =
          *reinterpret_cast<const float4*>(sb + k * LDB + c * CB + 4 * tc);
      b[4 * c] = v.x, b[4 * c + 1] = v.y, b[4 * c + 2] = v.z,
      b[4 * c + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Row and column of a thread's acc[i][j] within its tile (gemm_depth).
template <int BM, int TM>
__device__ __forceinline__ int tile_index(int i, int t) {
  return (i / 4) * (BM / (TM / 4)) + 4 * t + (i % 4);
}

// Row m of a direction's active row-steps, in the order of the span prefix
// (prefix[b] = the active steps of rows 0..b-1): its batch row, the last b
// with prefix[b] <= m, and its index j within that row's span.
__device__ __forceinline__ void active_row(const int* __restrict__ prefix,
                                           int B, int m, int* b, int* j) {
  int lo = 0, hi = B;  // prefix[lo] <= m < prefix[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= m) lo = mid; else hi = mid;
  }
  *b = lo;
  *j = m - prefix[lo];
}

// prefix[b] = sum of min(max(lengths[r], 0), T) over r < b, for b = 0..B:
// the active steps of rows before b, in either direction (a row's span is
// [0, len) or [T - len, T)).  One block of 256 threads.
__global__ void __launch_bounds__(256) span_prefix_kernel(
    const int* __restrict__ lengths, int* __restrict__ prefix, int T,
    int B) {
  __shared__ int s_part[256];
  const int tid = threadIdx.x;
  const int per = (B + 255) / 256;
  const int lo = min(B, tid * per), hi = min(B, lo + per);
  auto len = [&](int b) { return min(max(lengths[b], 0), T); };
  int s = 0;
  for (int b = lo; b < hi; ++b) s += len(b);
  s_part[tid] = s;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < 256; ++i) {
      const int v = s_part[i];
      s_part[i] = run;
      run += v;
    }
    prefix[B] = run;
  }
  __syncthreads();
  int run = s_part[tid];
  for (int b = lo; b < hi; ++b) {
    prefix[b] = run;
    run += len(b);
  }
}

// The three modes of lstm_gates_kernel.
enum GatesMode { kGatesRaw = 0, kGatesXp = 1, kGatesLayer = 2 };

// (a) The gate recompute for every active row-step of both directions
// (grid.z = direction): Z = (x_t W_ih + b_ih + h_{t-1} W_hh) + b_hh with
// h_{t-1} = outs[t - 1] (zero at t = 0), one chain of FMAs a dot product:
// x over F in order, then b_ih, then h over H in order (the forward sums
// the h half apart and adds it: a second accumulator set would halve the
// tile), then i, f, g, o = sigmoid, sigmoid, tanh, sigmoid, written into
// the dz buffer
// at (d, original time, b, .), where the recurrence reads them and writes
// dz over them.  Rows are the active row-steps in the span prefix's order
// (grid.y covers T * B rows; blocks past a direction's count return), so
// no row outside its span costs a product.  Where hp_s is given, the
// blocks of the first column tile also write the h_prev stream (the same
// h_{t-1}) for dW_hh.
//
// kGatesXp: the raw forward's input projection instead (its "proj" design,
// part (a)): xp = x_t W_ih + b_ih (x over F in order, then b_ih) for every
// active row-step of both directions, written into `gates` as xp
// (T, 2, B, 4H) at the direction's own time (direction 1 flipped), with no
// h half, no b_hh and no gate function; w_hh, b_hh, outs and hp_s are not
// read.  Row-steps outside the spans are left unwritten: the recurrence
// loads no xp there.
//
// kGatesLayer: one direction over a precomputed xp (T, B, 4H) (row 3b's
// part (a); grid.z = 1, `reverse` picking the span [T - len, T)): Z =
// (xp_t + h_{t-1} W_hh) + b_hh, the h half one chain over H in order then
// added to xp as the forward adds it, the gate functions applied, written
// into `gates` (T, B, 4H) at xp's own time.  `x` is xp; w_ih, b_ih and
// hp_s are not read.
template <int BM, int BN, int TM, int TN, int kMode = kGatesRaw>
__global__ void __launch_bounds__(kGemmThreads) lstm_gates_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | layer: xp (T, B, 4H)
    const int* __restrict__ prefix,     // (B + 1,)
    const float* __restrict__ w_ih,     // (2, F, 4H) | layer: unused
    const float* __restrict__ b_ih,     // (2, 4H) | layer: unused
    const float* __restrict__ w_hh,     // (D, H, 4H)
    const float* __restrict__ b_hh,     // (D, 4H)
    const float* __restrict__ outs,     // (T, D, B, H)
    float* __restrict__ gates,          // (D, T, B, 4H), original time
    float* __restrict__ hp_s,           // (2, T, B, H) or nullptr
    int T, int B, int F, int H, int reverse) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "one tile a block");
  constexpr bool kXp = kMode == kGatesXp, kLayer = kMode == kGatesLayer;
  constexpr int D = kLayer ? 1 : 2;
  constexpr int LDA = BM + 4, LDB = BN + 4;
  __shared__ __align__(16) float s_a[2][kGemmDepth * LDA];
  __shared__ __align__(16) float s_b[2][kGemmDepth * LDB];
  __shared__ int s_row[BM], s_t[BM];
  // each row's x_t and h_{t-1} (nullptr: zeros, at t = 0 or past the rows)
  __shared__ const float* s_xrow[BM];
  __shared__ const float* s_hrow[BM];
  const int d = blockIdx.z;
  const bool rev = kLayer ? reverse != 0 : d == 1;
  const int rows = prefix[B];
  const int m0 = blockIdx.y * BM;
  if (m0 >= rows) return;
  const int n0 = blockIdx.x * BN;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int mcount = min(BM, rows - m0);
  if (tid < BM) {
    int b = -1, j = 0;
    if (tid < mcount) active_row(prefix, B, m0 + tid, &b, &j);
    const int len = b < 0 ? 0 : prefix[b + 1] - prefix[b];
    const int t = rev ? T - len + j : j;     // the direction's own time
    const int tx = d == 0 ? t : T - 1 - t;   // x's time
    s_row[tid] = b;
    s_t[tid] = t;
    s_xrow[tid] = kLayer || b < 0 ? nullptr : x + ((int64_t)tx * B + b) * F;
    s_hrow[tid] = kXp || b < 0 || t == 0
                      ? nullptr
                      : outs + (((int64_t)(t - 1) * D + d) * B + b) * H;
  }
  __syncthreads();

  const int kx = kLayer ? 0 : (F + kGemmDepth - 1) / kGemmDepth;
  const int kt_n = kXp ? kx : kx + (H + kGemmDepth - 1) / kGemmDepth;
  const float* wi = kLayer ? nullptr : w_ih + (int64_t)d * F * G;
  const float* wh = kXp ? wi : w_hh + (int64_t)d * H * G;
  // whole float4s of weights when the rows allow (G is a multiple of 4)
  const bool w16 = (((uintptr_t)wi | (uintptr_t)wh) & 15) == 0;
  auto load = [&](int kt, int buf) {
    const bool xpart = kt < kx;
    const int k0 = (xpart ? kt : kt - kx) * kGemmDepth;
    const int K = xpart ? F : H;
    for (int i = tid; i < BM * kGemmDepth; i += kGemmThreads) {
      const int m = i / kGemmDepth, kk = i - m * kGemmDepth;
      const float* row = xpart ? s_xrow[m] : s_hrow[m];
      const bool ok = row != nullptr && k0 + kk < K;
      cp_async4_zfill(&s_a[buf][kk * LDA + m], ok ? row + k0 + kk : x, ok);
    }
    const float* w = xpart ? wi : wh;
    if (w16) {
      for (int i = tid; i < kGemmDepth * BN / 4; i += kGemmThreads) {
        const int kk = i / (BN / 4), n = 4 * (i - kk * (BN / 4));
        const bool ok = k0 + kk < K && n0 + n < G;
        cp_async16_zfill(&s_b[buf][kk * LDB + n],
                         ok ? w + (int64_t)(k0 + kk) * G + n0 + n : w, ok);
      }
    } else {
      for (int i = tid; i < kGemmDepth * BN; i += kGemmThreads) {
        const int kk = i / BN, n = i - kk * BN;
        const bool ok = k0 + kk < K && n0 + n < G;
        cp_async4_zfill(&s_b[buf][kk * LDB + n],
                        ok ? w + (int64_t)(k0 + kk) * G + n0 + n : w, ok);
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const float* bi = kLayer ? nullptr : b_ih + d * G;
  const float* bh = b_hh + d * G;
  load(0, 0);
  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_n) {
      load(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!kLayer && kt == kx) {  // the x half is summed: b_ih, then the h half
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tile_index<BN, TN>(j, tc);
        const float bv = n < G ? bi[n] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] += bv;
      }
    }
    gemm_depth<BM, BN, TM, TN>(s_a[buf], s_b[buf], tr, tc, acc);
    __syncthreads();
  }

  if constexpr (kXp) {  // xp = x W_ih + b_ih, at the direction's own time
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_index<BM, TM>(i, tr);
      if (m >= mcount) continue;
      float* dst = gates + (((int64_t)s_t[m] * 2 + d) * B + s_row[m]) * G;
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const int n = n0 + tile_index<BN, TN>(4 * c, tc);
        if (n >= G) continue;
        *reinterpret_cast<float4*>(dst + n) = make_float4(
            acc[i][4 * c] + bi[n], acc[i][4 * c + 1] + bi[n + 1],
            acc[i][4 * c + 2] + bi[n + 2], acc[i][4 * c + 3] + bi[n + 3]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tile_index<BM, TM>(i, tr);
    if (m >= mcount) continue;
    const int b = s_row[m], t = s_t[m];
    const int tx = d == 0 ? t : T - 1 - t;
    float* dst = gates + (((int64_t)d * T + tx) * B + b) * G;
    // layer mode: the row-step's xp (xp's own time: tx == t)
    const float* xp = kLayer ? x + ((int64_t)t * B + b) * G : nullptr;
#pragma unroll
    for (int c = 0; c < TN / 4; ++c) {
      const int n = n0 + tile_index<BN, TN>(4 * c, tc);
      if (n >= G) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = kLayer ? (xp[n + e] + acc[i][4 * c + e]) + bh[n + e]
                               : acc[i][4 * c + e] + bh[n + e];
        v[e] = (n + e) / H == 2 ? tanhf(z) : sigmoid(z);
      }
      *reinterpret_cast<float4*>(dst + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (!kLayer && hp_s != nullptr && blockIdx.x == 0) {
    for (int i = tid; i < mcount * H; i += kGemmThreads) {
      const int m = i / H, k = i - m * H;
      const int b = s_row[m], t = s_t[m];
      const int tx = d == 0 ? t : T - 1 - t;
      hp_s[(((int64_t)d * T + tx) * B + b) * H + k] =
          t > 0 ? outs[(((int64_t)(t - 1) * 2 + d) * B + b) * H + k] : 0.f;
    }
  }
}

// (c) dx after the loop: dx_t = dz_{0,t} W_ih[0]^T + dz_{1,t} W_ih[1]^T,
// both directions' dz read at the same original time t from the dz stream,
// one dot product over k = 0..8H-1 in order (direction 0's gate columns,
// then direction 1's).  A row (t, b) has dz in either direction exactly when
// t < len: rows are those, in the span prefix's order, and the wrapper's
// zeros stand for the others.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads) lstm_dx_kernel(
    const float* __restrict__ dz_s,     // (2, T, B, 4H), original time
    const int* __restrict__ prefix,     // (B + 1,)
    const float* __restrict__ w_ih,     // (2, F, 4H)
    float* __restrict__ dx,             // (T, B, F)
    int T, int B, int F, int H) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "one tile a block");
  constexpr int LDA = BM + 4, LDB = BN + 4;
  __shared__ __align__(16) float s_a[2][kGemmDepth * LDA];
  __shared__ __align__(16) float s_b[2][kGemmDepth * LDB];
  __shared__ int s_row[BM], s_tx[BM];
  __shared__ const float* s_dzrow[BM];  // direction 0's dz of the row
  const int rows = prefix[B];
  const int m0 = blockIdx.y * BM;
  if (m0 >= rows) return;
  const int n0 = blockIdx.x * BN;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int mcount = min(BM, rows - m0);
  if (tid < BM) {
    int b = -1, j = 0;
    if (tid < mcount) active_row(prefix, B, m0 + tid, &b, &j);
    s_row[tid] = b;
    s_tx[tid] = j;
    s_dzrow[tid] = b < 0 ? nullptr : dz_s + ((int64_t)j * B + b) * G;
  }
  __syncthreads();

  const int kt_n = (2 * G + kGemmDepth - 1) / kGemmDepth;
  const int64_t dir_stride = (int64_t)T * B * G;
  auto load = [&](int kt, int buf) {
    const int k0 = kt * kGemmDepth;
    for (int i = tid; i < BM * kGemmDepth; i += kGemmThreads) {
      const int m = i / kGemmDepth, kk = i - m * kGemmDepth;
      const int k = k0 + kk, dd = k >= G, g = k - dd * G;
      const float* row = s_dzrow[m];
      const bool ok = row != nullptr && k < 2 * G;
      cp_async4_zfill(&s_a[buf][kk * LDA + m],
                      ok ? row + dd * dir_stride + g : dz_s, ok);
    }
    for (int i = tid; i < BN * kGemmDepth; i += kGemmThreads) {
      const int n = i / kGemmDepth, kk = i - n * kGemmDepth;
      const int k = k0 + kk, dd = k >= G, g = k - dd * G;
      const bool ok = n0 + n < F && k < 2 * G;
      cp_async4_zfill(&s_b[buf][kk * LDB + n],
                      ok ? w_ih + ((int64_t)dd * F + n0 + n) * G + g : w_ih,
                      ok);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  load(0, 0);
  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_n) {
      load(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    gemm_depth<BM, BN, TM, TN>(s_a[buf], s_b[buf], tr, tc, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tile_index<BM, TM>(i, tr);
    if (m >= mcount) continue;
    float* dst = dx + ((int64_t)s_tx[m] * B + s_row[m]) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_index<BN, TN>(j, tc);
      if (n < F) dst[n] = acc[i][j];
    }
  }
}

constexpr int kBwdClusterThreads = 256;  // 8 warps

// Shared memory of one CTA of the backward recurrence: the W_hh slice
// transposed ([4U][H]), the partial dh_{t-1} of every source rank
// double-buffered ([2][C][R][U]), the CTA's dz ([R][4U]) and two mbarriers:
// 2 H^2 + 10 H R floats' bytes, 192,528 at H=256, R=24.
long long bwd_cluster_smem_bytes(int H, int R) {
  const long long U = H / kClusterCtas;
  return ((long long)4 * U * H + 2LL * kClusterCtas * R * U + 4LL * R * U) *
             (long long)sizeof(float) +
         2LL * (long long)sizeof(uint64_t);
}

// (b) The recurrence: one cluster of C CTAs per (direction, tile of R rows),
// grid (C, ceil(B / R), D).  D = 2: both directions of the raw layer, the
// streams (T, 2, B, .) and dz_s at original time (direction 1 flipped);
// D = 1: row 3b's one direction over xp, `reverse` picking the span, every
// stream in xp's own time.  CTA c holds the W_hh slice of units
// [c U, (c + 1) U) (all four gates, U = H / C) for the whole sequence,
// transposed: column j = g U + u as a row of H floats.  Step t (T - 1 down
// to 0) runs in three phases:
//   1. one thread per (unit, row; 8 warps, rows warp + 8 q): dh = dh_carry +
//      douts[t]; from the gates of (a) (in registers, fetched a step ahead)
//      and c_t, c_{t-1}, the unit's dz (zero where the row is inactive), dc
//      and the pass-through part of dh_{t-1}; dz over the gates in the dz
//      buffer and into shared memory;
//   2. one thread per (4 consecutive k, a quarter of the rows; 8 k on 128
//      or 192 threads, fewer warps, measured slower): the partial
//      dh_{t-1}[r][k] = sum over the CTA's 4U gate columns j, in order, of
//      dz[r][j] W_hh[k][col j], for all H k; each float4 of four k goes to
//      the CTA owning those units (st.async counted on its mbarrier; its
//      own with a plain store) into the slot of this rank: a reduce-scatter,
//      H R floats out of each CTA a step;
//   3. the (unit, row) threads add the C partials in rank order, then the
//      pass-through: dh_{t-1}.
// A step in which no row of the tile is active (past the longest row)
// computes no product and exchanges nothing: dh passes through.
template <int R>
__global__ void __launch_bounds__(kBwdClusterThreads) lstm_bwd_cluster_kernel(
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_hh,     // (D, H, 4H)
    const float* __restrict__ cs,       // (T, D, B, H)
    const float* __restrict__ douts,    // (T, D, B, H) or nullptr
    const float* __restrict__ dh_n,     // (D, B, H)
    const float* __restrict__ dc_n,     // (D, B, H)
    float* __restrict__ dz_s,           // (D, T, B, 4H): gates in, dz out
    int T, int B, int H, int reverse) {
  static_assert(R % 4 == 0, "four row groups in the product");
  constexpr int C = kClusterCtas;
  constexpr int Q = (R + 7) / 8;        // rows a thread in phases 1 and 3
  constexpr int RG = R / 4;             // rows a thread in phase 2
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int U = H / C, G4 = 4 * U, G = 4 * H;
  const int D = gridDim.z, d = blockIdx.z;
  const bool rev = D == 2 ? d == 1 : reverse != 0;
  const bool flip = D == 2 && d == 1;   // dz_s at original time
  const int r0 = blockIdx.y * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int u = tid & 31, warp = tid >> 5;
  const bool ulive = u < U;
  const int unit = rank * U + (ulive ? u : 0);

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [G4][H]
  float* s_x = s_w + G4 * H;                      // [2][C][R][U]
  float* s_dz = s_x + 2 * C * R * U;              // [R][G4]
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_dz + R * G4);

  // the slice, once, transposed: row j of s_w is column (j / U) H + rank U
  // + j % U of W_hh
  const float* wh = w_hh + (int64_t)d * H * G;
  for (int i = tid; i < G4 * H; i += nth) {
    const int j = i / H, k = i - j * H;
    cp_async4(s_w + i, wh + (int64_t)k * G + (j / U) * H + rank * U + j % U);
  }
  // the tile's longest span: a step is exchanged when any row is active
  int maxlen = 0;
  for (int r = 0; r < nrows; ++r)
    maxlen = max(maxlen, min(max(lengths[r0 + r], 0), T));
  auto any_active = [&](int t) { return rev ? t >= T - maxlen : t < maxlen; };
  int n_ex = 0;
  for (int t = 1; t < T; ++t) n_ex += any_active(t) ? 1 : 0;
  const int tx_bytes = (C - 1) * R * U * (int)sizeof(float);
  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_ex > 0) mbar_arrive_expect(&s_full[0], tx_bytes);
    if (n_ex > 1) mbar_arrive_expect(&s_full[1], tx_bytes);
  }

  // phases 1 and 3: this thread's rows warp + 8 q, their carries
  int len[Q];
  float dh[Q], dc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = warp + 8 * q;
    const bool ok = ulive && r < nrows;
    len[q] = ok ? lengths[r0 + r] : 0;
    const int64_t o = ((int64_t)d * B + r0 + r) * H + unit;
    dh[q] = ok ? dh_n[o] : 0.f;
    dc[q] = ok ? dc_n[o] : 0.f;
  }
  // a step's inputs for the thread's rows, fetched one step ahead
  struct StepIn {
    float g[Q][4], c[Q], cp[Q], dout[Q];
  };
  auto fetch = [&](int t, StepIn& in) {
    const int tx = flip ? T - 1 - t : t;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + 8 * q;
      const bool ok = ulive && r < nrows;
      const bool act = ok && span_active(t, T, len[q], rev);
      const int64_t b = r0 + r;
      const float* gp = dz_s + (((int64_t)d * T + tx) * B + b) * G + unit;
#pragma unroll
      for (int g = 0; g < 4; ++g) in.g[q][g] = act ? gp[g * H] : 0.f;
      in.c[q] = act ? cs[(((int64_t)t * D + d) * B + b) * H + unit] : 0.f;
      in.cp[q] = act && t > 0
                     ? cs[(((int64_t)(t - 1) * D + d) * B + b) * H + unit]
                     : 0.f;
      in.dout[q] = ok && douts
                       ? douts[(((int64_t)t * D + d) * B + b) * H + unit]
                       : 0.f;
    }
  };
  StepIn cur, nxt;
  fetch(T - 1, cur);
  cp_async_wait_all();
  __syncthreads();  // the slice in place
  // every CTA of the cluster has initialised its barriers before any
  // writes a peer
  cluster_arrive();
  cluster_wait();

  const int KQ = H / 4;
  const int kq = tid % KQ, rg = tid / KQ;   // phase 2 (threads < H)
  int ex = 0;                               // exchanges so far
  for (int t = T - 1; t >= 0; --t) {
    const int tx = flip ? T - 1 - t : t;
    // phase 1
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + 8 * q;
      if (!ulive || r >= R) continue;
      float dz[4] = {0.f, 0.f, 0.f, 0.f};
      const float dht = douts ? dh[q] + cur.dout[q] : dh[q];
      if (span_active(t, T, len[q], rev)) {
        const float ig = cur.g[q][0], fg = cur.g[q][1], gg = cur.g[q][2],
                    og = cur.g[q][3];
        const float tc = tanhf(cur.c[q]);
        const float do_ = dht * tc;
        const float dc2 = dc[q] + dht * og * (1.f - tc * tc);
        const float df = dc2 * cur.cp[q];
        const float di = dc2 * gg;
        const float dg = dc2 * ig;
        dz[0] = di * ig * (1.f - ig);
        dz[1] = df * fg * (1.f - fg);
        dz[2] = dg * (1.f - gg * gg);
        dz[3] = do_ * og * (1.f - og);
        dh[q] = 0.f;  // the pass-through part of dh_{t-1}
        dc[q] = dc2 * fg;
      } else {
        dh[q] = dht;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) s_dz[r * G4 + g * U + u] = dz[g];
      if (r < nrows) {
        float* dst = dz_s + (((int64_t)d * T + tx) * B + r0 + r) * G + unit;
#pragma unroll
        for (int g = 0; g < 4; ++g) dst[g * H] = dz[g];
      }
    }
    if (t == 0 || !any_active(t)) {
      // no dh_{t-1} is needed, or every row passes it through
      if (t > 0) fetch(t - 1, cur);
      continue;
    }
    fetch(t - 1, nxt);  // in flight behind the product
    __syncthreads();    // s_dz complete
    const int buf = ex & 1;
    if (tid < H) {
      // phase 2
      float acc[RG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
      const float* wcol = s_w + 4 * kq;
      const float* dzr = s_dz + rg * RG * G4;
      for (int j4 = 0; j4 < U; ++j4) {
        float4 w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          w[jj] = *reinterpret_cast<const float4*>(wcol + (4 * j4 + jj) * H);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float4 z =
              *reinterpret_cast<const float4*>(dzr + r * G4 + 4 * j4);
          const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[r][0] = fmaf(zs[jj], w[jj].x, acc[r][0]);
            acc[r][1] = fmaf(zs[jj], w[jj].y, acc[r][1]);
            acc[r][2] = fmaf(zs[jj], w[jj].z, acc[r][2]);
            acc[r][3] = fmaf(zs[jj], w[jj].w, acc[r][3]);
          }
        }
      }
      const int owner = 4 * kq / U, kl = 4 * kq - owner * U;
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                     acc[r][3]);
        float4* dst = reinterpret_cast<float4*>(
            s_x + (((int64_t)buf * C + rank) * R + rg * RG + r) * U + kl);
        if (owner == rank)
          *dst = v;
        else
          st_async_peer(dst, &s_full[buf], owner, v);
      }
    }
    // the peers' partials of this exchange: buffer buf's (ex / 2)-th phase
    mbar_wait(&s_full[buf], (ex >> 1) & 1);
    __syncthreads();  // this CTA's own partials written
    // phase 3
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = warp + 8 * q;
      if (!ulive || r >= R) continue;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        s += s_x[(((int64_t)buf * C + c) * R + r) * U + u];
      dh[q] = dh[q] + s;
    }
    // re-arm buffer buf for exchange ex + 2: its phase for exchange ex is
    // complete, and no peer sends into it before this CTA's partials of
    // exchange ex + 1
    if (tid == 0 && ex + 2 < n_ex) mbar_arrive_expect(&s_full[buf], tx_bytes);
    ++ex;
    cur = nxt;
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Grid design of the backward (row 2b where the cluster recurrence does not
// take H: H=1024, H not a multiple of 32; row 3b likewise): the recurrence
// as one tiled product a step over the whole grid, the step's elementwise
// backward fused into its epilogue
// ---------------------------------------------------------------------------

// order[i] = the batch row of rank i by active steps, longest first (ties
// in row order).  A row's span is [0, len) or [T - len, T), so at any step
// of either direction the active rows are a prefix of this order.  One
// block; O(B^2) comparisons.
__global__ void __launch_bounds__(1024) length_order_kernel(
    const int* __restrict__ lengths, int* __restrict__ order, int T, int B) {
  auto len = [&](int b) { return min(max(lengths[b], 0), T); };
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int lb = len(b);
    int rank = 0;
    for (int r = 0; r < B; ++r) {
      const int lr = len(r);
      rank += lr > lb || (lr == lb && r < b);
    }
    order[rank] = b;
  }
}

// One (row, unit) of step t's elementwise backward, in the twin's order of
// operations: dh is the cotangent reaching h_t (the carry, douts[t] added),
// dc the cell carry.  An active row-step reads the activated gates at g
// (stride H), c_t and c_{t-1}, writes dz over the gates, and leaves a zero
// pass-through and dc2 * f; an inactive one writes dz = 0 and passes dh and
// dc on.  Returns the pass-through part of dh_{t-1} and stores the new dc.
__device__ __forceinline__ float step_bwd(float dh, float* dc, bool act,
                                          float* g, int H, float c,
                                          float cp) {
  if (!act) {
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q * H] = 0.f;
    return dh;
  }
  const float ig = g[0], fg = g[H], gg = g[2 * H], og = g[3 * H];
  const float tc = tanhf(c);
  const float do_ = dh * tc;
  const float dc2 = *dc + dh * og * (1.f - tc * tc);
  const float df = dc2 * cp;
  const float di = dc2 * gg;
  const float dg = dc2 * ig;
  g[0] = di * ig * (1.f - ig);
  g[H] = df * fg * (1.f - fg);
  g[2 * H] = dg * (1.f - gg * gg);
  g[3 * H] = do_ * og * (1.f - og);
  *dc = dc2 * fg;
  return 0.f;
}

// Step t of direction d for unit k of batch row b, dh the cotangent
// reaching h_t before douts[t]: the elementwise backward (step_bwd) against
// the streams, its carries into dh_s / dc_s.  Layouts as
// lstm_bwd_step_kernel's.
__device__ __forceinline__ void step_bwd_at(
    int t, int d, int D, bool rev, bool flip, int b, int k, float dh,
    float dc, const int* __restrict__ lengths, const float* __restrict__ cs,
    const float* __restrict__ douts, float* __restrict__ dz_s,
    float* __restrict__ dh_s, float* __restrict__ dc_s, int T, int B,
    int H) {
  const int64_t so = (((int64_t)t * D + d) * B + b) * H + k;
  if (douts) dh += douts[so];
  const bool act = span_active(t, T, min(max(lengths[b], 0), T), rev);
  const int tx = flip ? T - 1 - t : t;
  float* g = dz_s + (((int64_t)d * T + tx) * B + b) * (4 * H) + k;
  const float c = act ? cs[so] : 0.f;
  const float cp =
      act && t > 0 ? cs[(((int64_t)(t - 1) * D + d) * B + b) * H + k] : 0.f;
  const int64_t o = ((int64_t)d * B + b) * H + k;
  dh_s[o] = step_bwd(dh, &dc, act, g, H, c, cp);
  dc_s[o] = dc;
}

// The last step (t = T - 1) of every direction (grid.z = D) from dh_n and
// dc_n; one thread per (row, unit).
__global__ void __launch_bounds__(256) lstm_bwd_first_kernel(
    const int* __restrict__ lengths, const float* __restrict__ cs,
    const float* __restrict__ douts, const float* __restrict__ dh_n,
    const float* __restrict__ dc_n, float* __restrict__ dz_s,
    float* __restrict__ dh_s, float* __restrict__ dc_s, int T, int B, int H,
    int reverse) {
  const int D = gridDim.z, d = blockIdx.z;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * H) return;
  const int b = (int)(i / H), k = (int)(i - (int64_t)b * H);
  const int64_t o = (int64_t)d * B * H + i;
  step_bwd_at(T - 1, d, D, D == 2 ? d == 1 : reverse != 0, D == 2 && d == 1,
              b, k, dh_n[o], dc_n[o], lengths, cs, douts, dz_s, dh_s, dc_s,
              T, B, H);
}

// The per-step product's tile and split: a cluster of kStepSplit CTAs owns
// a BM x BN tile of dh_{t-1} (rows x units) of one direction, CTA r the
// r-th eighth of the depth 4H.
constexpr int kStepBM = 64, kStepBN = 128, kStepTM = 8, kStepTN = 8;
constexpr int kStepThreads = (kStepBM / kStepTM) * (kStepBN / kStepTN);
constexpr int kStepSplit = 8;

// Step s (s = T - 1 down to 1) of the recurrence for every direction at
// once (grid (kStepSplit * ceil(H / BN), ceil(B / BM), D), clusters of
// kStepSplit along x): dh_{s-1} = pass-through + dz_s W_hh^T, a (B x 4H) by
// (4H x H) product over the rows in `order` (longest first), then step
// s - 1's elementwise backward for the tile's (row, unit) pairs, which
// writes dz_{s-1} over its gates.  Each CTA sums its eighth of the depth
// (one chain of FMAs an output, k in order) on 8 x 8 thread tiles
// (gemm_depth); the cluster's eight partial tiles are then added in rank
// order over distributed shared memory, CTA r finishing rows [r BM / 8,
// (r + 1) BM / 8) of the tile: no atomics, so a run repeats bit for bit.  A
// tile whose longest row is inactive at step s has dz_s = 0: it skips the
// product.
//
// Why this tile (B=512, H=1024 on an H100, 700 W): 8 x 8 x 8 x D CTAs of
// 128 threads at full activity (three fit a SM), and 64 x D still when a
// single row tile is active, each with 512 of the 4H = 4096 deep: late in
// the backward's sweep few rows are active and a step costs one CTA's
// depth.  Against a split in four, the one-direction backward (D = 1) went
// from 20.6 to ~17.5 ms of recurrence; both directions (D = 2), which fill
// the card, stayed at ~29 ms.  A step reads 384 MB from L2 at full
// activity (each dz row's slice by the 8 column tiles, W_hh^T, 16 MB a
// direction and both in the 50 MB L2, by the 8 row tiles), below the
// product's 8.6 GFLOP at the rate the tiles reach.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kStepThreads) lstm_bwd_step_kernel(
    const int* __restrict__ lengths,    // (B,)
    const int* __restrict__ order,      // (B,)
    const float* __restrict__ w_hhT,    // (D, 4H, H)
    const float* __restrict__ cs,       // (T, D, B, H)
    const float* __restrict__ douts,    // (T, D, B, H) or nullptr
    float* __restrict__ dz_s,           // (D, T, B, 4H): gates in, dz out
    float* __restrict__ dh_s,           // (D, B, H) pass-through of dh
    float* __restrict__ dc_s,           // (D, B, H) dc carry
    int s, int T, int B, int H, int reverse) {
  static_assert((BM / TM) * (BN / TN) == kStepThreads, "one tile a CTA");
  static_assert(BM % kStepSplit == 0, "the tile's rows split evenly");
  constexpr int LDA = BM + 4, LDB = BN + 4, LDR = BN + 4;
  constexpr int kStage = 2 * kGemmDepth * (LDA + LDB);
  // the staging of the product, then the CTA's partial tile
  __shared__ __align__(16) float s_buf[kStage > BM * LDR ? kStage : BM * LDR];
  __shared__ int s_row[BM];
  __shared__ const float* s_arow[BM];
  float* s_a = s_buf;                        // [2][depth][LDA]
  float* s_b = s_buf + 2 * kGemmDepth * LDA;  // [2][depth][LDB]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int D = gridDim.z, d = blockIdx.z;
  const bool rev = D == 2 ? d == 1 : reverse != 0;
  const bool flip = D == 2 && d == 1;
  const int n0 = (blockIdx.x / kStepSplit) * BN;
  const int m0 = blockIdx.y * BM;
  const int G = 4 * H;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int txs = flip ? T - 1 - s : s;
  if (tid < BM) {
    const int b = m0 + tid < B ? order[m0 + tid] : -1;
    s_row[tid] = b;
    s_arow[tid] = b < 0 ? nullptr : dz_s + (((int64_t)d * T + txs) * B + b) * G;
  }
  // the tile's longest row decides whether any row is active at step s
  const bool active =
      span_active(s, T, min(max(lengths[order[m0]], 0), T), rev);
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (active) {
    const int chunks = (G + kGemmDepth - 1) / kGemmDepth;
    const int per = (chunks + kStepSplit - 1) / kStepSplit;
    const int kt0 = rank * per, kt1 = min(chunks, kt0 + per);
    const float* wT = w_hhT + (int64_t)d * G * H;
    const bool w16 = (H & 3) == 0 && ((uintptr_t)wT & 15) == 0;
    auto load = [&](int kt, int buf) {
      const int k0 = kt * kGemmDepth;
      float* sa = s_a + buf * kGemmDepth * LDA;
      float* sb = s_b + buf * kGemmDepth * LDB;
      for (int i = tid; i < BM * kGemmDepth; i += kStepThreads) {
        const int m = i / kGemmDepth, kk = i - m * kGemmDepth;
        const float* row = s_arow[m];
        const bool ok = row != nullptr && k0 + kk < G;
        cp_async4_zfill(&sa[kk * LDA + m], ok ? row + k0 + kk : w_hhT, ok);
      }
      if (w16) {
        for (int i = tid; i < kGemmDepth * BN / 4; i += kStepThreads) {
          const int kk = i / (BN / 4), n = 4 * (i - kk * (BN / 4));
          const bool ok = k0 + kk < G && n0 + n < H;
          cp_async16_zfill(&sb[kk * LDB + n],
                           ok ? wT + (int64_t)(k0 + kk) * H + n0 + n : wT,
                           ok);
        }
      } else {
        for (int i = tid; i < kGemmDepth * BN; i += kStepThreads) {
          const int kk = i / BN, n = i - kk * BN;
          const bool ok = k0 + kk < G && n0 + n < H;
          cp_async4_zfill(&sb[kk * LDB + n],
                          ok ? wT + (int64_t)(k0 + kk) * H + n0 + n : wT,
                          ok);
        }
      }
      cp_async_commit();
    };
    if (kt0 < kt1) load(kt0, 0);
    for (int kt = kt0; kt < kt1; ++kt) {
      const int buf = (kt - kt0) & 1;
      if (kt + 1 < kt1) {
        load(kt + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      gemm_depth<BM, BN, TM, TN>(s_a + buf * kGemmDepth * LDA,
                                 s_b + buf * kGemmDepth * LDB, tr, tc, acc);
      __syncthreads();
    }
    // the partial tile, row-major, for the peers
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = tile_index<BM, TM>(i, tr);
#pragma unroll
      for (int c = 0; c < TN / 4; ++c) {
        const int n = tile_index<BN, TN>(4 * c, tc);
        *reinterpret_cast<float4*>(&s_buf[m * LDR + n]) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
      }
    }
  }
  cluster.sync();  // every partial tile of the cluster written
  constexpr int RM = BM / kStepSplit;  // rows this CTA finishes
  const float* part[kStepSplit];
#pragma unroll
  for (int c = 0; c < kStepSplit; ++c)
    part[c] = cluster.map_shared_rank(s_buf, c);
  for (int e = tid; e < RM * BN; e += kStepThreads) {
    const int m = rank * RM + e / BN, n = e % BN;
    const int b = s_row[m], k = n0 + n;
    if (b < 0 || k >= H) continue;
    float p = 0.f;
    if (active) {
#pragma unroll
      for (int c = 0; c < kStepSplit; ++c) p += part[c][m * LDR + n];
    }
    const int64_t o = ((int64_t)d * B + b) * H + k;
    step_bwd_at(s - 1, d, D, rev, flip, b, k, dh_s[o] + p, dc_s[o], lengths,
                cs, douts, dz_s, dh_s, dc_s, T, B, H);
  }
  cluster.sync();  // no CTA leaves while a peer may read its partial tile
}

// (d) The weight gradients over the active row-steps, in the span prefix's
// order: for each direction (grid.z = D x splits) C (K x 4H) = sum over
// rows m of A_m^T dz_m with A_m = [x row | h_prev row] (raw, K = F + H) or
// the h_prev row (layer, K = H), and the bias row sum over m of dz_m (lstm_bias_kernel).  Row
// m is (b, j) of active_row at the direction's own time t (x and dz at
// original time for the raw layer's direction 1; h_prev = outs[t - 1], zero
// at t = 0), so no row-step outside its span costs a product.  Each split
// takes a contiguous run of the rows and writes its partial tile into
// `part`; lstm_wgrad_sum_kernel adds the splits in order.  8 x 8 thread
// tiles (gemm_depth), the rows staged 16 at a time.  (Summing the bias row
// here too, in the first K tile's blocks, took the kernel from 127
// registers to 241: one block a SM, and ~25% slower.)
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads) lstm_wgrad_kernel(
    const float* __restrict__ x,        // raw (T, B, F) | nullptr
    const int* __restrict__ prefix,     // (B + 1,)
    const float* __restrict__ outs,     // (T, D, B, H)
    const float* __restrict__ dz_s,     // (D, T, B, 4H)
    float* __restrict__ part,           // (splits, D, K + 1, 4H)
    int T, int B, int F, int H, int D, int reverse) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "one tile a block");
  constexpr int LDA = BM + 4, LDB = BN + 4;
  __shared__ __align__(16) float s_a[2][kGemmDepth * LDA];
  __shared__ __align__(16) float s_b[2][kGemmDepth * LDB];
  // the row pointers of a stage, found two stages ahead (three buffers)
  __shared__ const float* s_xrow[3][kGemmDepth];
  __shared__ const float* s_hrow[3][kGemmDepth];
  __shared__ const float* s_zrow[3][kGemmDepth];
  const int d = blockIdx.z % D, split = blockIdx.z / D;
  const int splits = gridDim.z / D;
  const bool rev = D == 2 ? d == 1 : reverse != 0;
  const bool flip = D == 2 && d == 1;
  const int G = 4 * H, K = F + H;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int rows = prefix[B];
  const int per = (rows + splits - 1) / splits;
  const int r_begin = min(rows, split * per), r_end = min(rows, r_begin + per);
  const int n_st = (r_end - r_begin + kGemmDepth - 1) / kGemmDepth;

  // the row pointers of stage st into buffer st % 3 (threads < depth)
  auto resolve = [&](int st) {
    if (tid < kGemmDepth) {
      const int m = r_begin + st * kGemmDepth + tid;
      const float *xr = nullptr, *hr = nullptr, *zr = nullptr;
      if (m < r_end) {
        int b, j;
        active_row(prefix, B, m, &b, &j);
        const int len = prefix[b + 1] - prefix[b];
        const int t = rev ? T - len + j : j;
        const int tx = flip ? T - 1 - t : t;
        if (x) xr = x + ((int64_t)tx * B + b) * F;
        if (t > 0) hr = outs + (((int64_t)(t - 1) * D + d) * B + b) * H;
        zr = dz_s + (((int64_t)d * T + tx) * B + b) * G;
      }
      s_xrow[st % 3][tid] = xr;
      s_hrow[st % 3][tid] = hr;
      s_zrow[st % 3][tid] = zr;
    }
  };
  // stage st's rows into buffer st & 1.  Each thread stages one column of
  // A (k) and one float4 of B (n) for every few rows, so its column's
  // source and bounds are worked out once.
  static_assert(kGemmThreads % BM == 0 && kGemmThreads % (BN / 4) == 0,
                "a thread's columns are fixed");
  const int ka = tid % BM, k = k0 + ka;
  const bool from_x = k < F, in_k = k < K;
  const int koff = from_x ? k : k - F;
  const int nb = 4 * (tid % (BN / 4));
  const bool in_n = n0 + nb < G;
  auto load = [&](int st) {
    const int buf = st & 1, pb = st % 3;
    for (int mm = tid / BM; mm < kGemmDepth; mm += kGemmThreads / BM) {
      const float* row = from_x ? s_xrow[pb][mm] : s_hrow[pb][mm];
      const bool ok = in_k && row != nullptr;
      cp_async4_zfill(&s_a[buf][mm * LDA + ka], ok ? row + koff : dz_s, ok);
    }
    for (int mm = tid / (BN / 4); mm < kGemmDepth;
         mm += kGemmThreads / (BN / 4)) {
      const float* row = s_zrow[pb][mm];
      const bool ok = in_n && row != nullptr;
      cp_async16_zfill(&s_b[buf][mm * LDB + nb], ok ? row + n0 + nb : dz_s,
                       ok);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  if (n_st > 0) {
    resolve(0);
    if (n_st > 1) resolve(1);
    __syncthreads();
    load(0);
  }
  for (int st = 0; st < n_st; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_st) {
      load(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st in place
    // the first warp finds stage st + 2's rows (its binary searches'
    // latency) while the other warps compute
    if (st + 2 < n_st) resolve(st + 2);
    gemm_depth<BM, BN, TM, TN>(s_a[buf], s_b[buf], tr, tc, acc);
    __syncthreads();  // stage st read; stage st + 2's pointers written
  }
  float* dst = part + ((int64_t)split * D + d) * (K + 1) * G;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + tile_index<BM, TM>(i, tr);
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_index<BN, TN>(j, tc);
      if (n < G) dst[(int64_t)k * G + n] = acc[i][j];
    }
  }
}

// The bias row of (d) for each direction and split (grid (ceil(4H / 64),
// 1, D x splits), 256 threads): a thread sums one column of dz over every
// fourth row of the split's run, in order, and the four partial sums are
// added in order; no atomics.
constexpr int kBiasCols = 64, kBiasGroups = 4;
__global__ void __launch_bounds__(kBiasCols * kBiasGroups) lstm_bias_kernel(
    const int* __restrict__ prefix,     // (B + 1,)
    const float* __restrict__ dz_s,     // (D, T, B, 4H)
    float* __restrict__ part,           // (splits, D, K + 1, 4H)
    int T, int B, int F, int H, int D, int reverse) {
  constexpr int kRows = kBiasCols * kBiasGroups;  // rows resolved at once
  __shared__ const float* s_zrow[kRows];
  __shared__ float s_sum[kBiasGroups][kBiasCols];
  const int d = blockIdx.z % D, split = blockIdx.z / D;
  const int splits = gridDim.z / D;
  const bool rev = D == 2 ? d == 1 : reverse != 0;
  const bool flip = D == 2 && d == 1;
  const int G = 4 * H, K = F + H;
  const int tid = threadIdx.x;
  const int c = tid % kBiasCols, grp = tid / kBiasCols;
  const int n = blockIdx.x * kBiasCols + c;
  const int rows = prefix[B];
  const int per = (rows + splits - 1) / splits;
  const int r_begin = min(rows, split * per), r_end = min(rows, r_begin + per);
  float sum = 0.f;
  for (int m0 = r_begin; m0 < r_end; m0 += kRows) {
    const int m = m0 + tid;
    const float* zr = nullptr;
    if (m < r_end) {
      int b, j;
      active_row(prefix, B, m, &b, &j);
      const int len = prefix[b + 1] - prefix[b];
      const int t = rev ? T - len + j : j;
      const int tx = flip ? T - 1 - t : t;
      zr = dz_s + (((int64_t)d * T + tx) * B + b) * G;
    }
    s_zrow[tid] = zr;
    __syncthreads();
    const int count = min(kRows, r_end - m0);
    if (n < G)
      for (int i = grp; i < count; i += kBiasGroups) sum += s_zrow[i][n];
    __syncthreads();
  }
  s_sum[grp][c] = sum;
  __syncthreads();
  if (grp == 0 && n < G) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kBiasGroups; ++g) total += s_sum[g][c];
    part[(((int64_t)split * D + d) * (K + 1) + K) * G + n] = total;
  }
}

// The splits of lstm_wgrad_kernel added in order, each row of C scattered
// to dW_ih (rows < F), dW_hh (rows F .. K - 1) or db (row K).
__global__ void __launch_bounds__(256) lstm_wgrad_sum_kernel(
    const float* __restrict__ part, int splits, int D, int F, int H,
    float* __restrict__ dw_ih, float* __restrict__ dw_hh,
    float* __restrict__ db) {
  const int G = 4 * H, K = F + H;
  const int64_t size = (int64_t)D * (K + 1) * G;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(int64_t)z * size + i];
  const int d = (int)(i / ((int64_t)(K + 1) * G));
  const int64_t r = i - (int64_t)d * (K + 1) * G;
  const int k = (int)(r / G), n = (int)(r - (int64_t)k * G);
  if (k < F)
    dw_ih[((int64_t)d * F + k) * G + n] = s;
  else if (k < K)
    dw_hh[((int64_t)d * H + k - F) * G + n] = s;
  else
    db[(int64_t)d * G + n] = s;
}

constexpr int kWgradBM = 128, kWgradBN = 128;

// Per-tile backward of both directions over xp (kind 5, lstm_layer_bidir's
// backward; the TPU's _bwd2_kernel): the reverse-time adjoint of one
// direction (grid.y; direction 1's xp already flipped in time, active on
// [T - len, T)) for one tile of R batch rows.  (The raw and one-direction
// modes of this kernel, kinds 1 and 3, gave way to the cluster and grid
// designs.)  Step t (its own time, T - 1 down to 0) recomputes the gates
// from xp and the saved h_{t-1}, c_{t-1} (zero at t == 0, where no saved
// state exists), in exactly the forward's order of operations, then:
//   dh = dh_carry + douts[t];  dh_step, dc_step = (dh, dc) if the row is
//   active at t, else 0 (and the carry passes through unchanged);
//   dc2 = dc_step + dh_step * o * (1 - tanh(c2)^2);  dz = gate cotangents
//   (= dxp_t);  dh_{t-1} = dz @ W_hh^T (+ dh if inactive);  dc_{t-1} =
//   dc2 * f (or dc).
// A thread owns hidden units u = tid, tid + blockDim, ...: it recomputes a
// unit's four gates for the tile's rows in registers and writes dz to shared
// memory; after a barrier every thread forms columns of dz @ W_hh^T from
// the transposed weights (coalesced across threads).  The weight gradients
// need sums over all (t, b): the kernel writes dz and h_{t-1} as streams in
// xp's own time order, (2, T, B, .) direction-major, and csrc/wgrad.cu
// reduces them (dW_hh = h_prev^T dz, db = sum dz).
template <int R>
__global__ void __launch_bounds__(kBwdThreads) lstm_pair_bwd_kernel(
    const float* __restrict__ xp,       // (T, 2, B, 4H)
    const int* __restrict__ lengths,    // (B,)
    const float* __restrict__ w_hh,     // (2, H, 4H)
    const float* __restrict__ b_hh,     // (2, 4H)
    const float* __restrict__ w_hhT,    // (2, 4H, H)
    const float* __restrict__ outs,     // (T, 2, B, H)
    const float* __restrict__ cs,       // (T, 2, B, H)
    const float* __restrict__ douts,    // (T, 2, B, H) or nullptr
    const float* __restrict__ dh_n,     // (2, B, H)
    const float* __restrict__ dc_n,     // (2, B, H)
    float* __restrict__ dz_s,           // (2, T, B, 4H)
    float* __restrict__ hp_s,           // (2, T, B, H)
    int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* s_hp = smem;                 // [R][H]
  float* s_dz = s_hp + R * H;         // [R][4H]
  float* s_dh = s_dz + R * G;         // [R][H]
  float* s_dc = s_dh + R * H;         // [R][H]

  constexpr int D = 2;
  const int d = blockIdx.y;
  const bool rev = d == 1;
  const int r0 = blockIdx.x * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const float* wh = w_hh + (int64_t)d * H * G;
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
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          const float* x = xp + (((int64_t)t * 2 + d) * B + r0 + r) * G + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) ax[g][r] = x[g * H];
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
      float bh[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) bh[g] = b_hh[d * G + g * H + u];
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
        for (int g = 0; g < 4; ++g) z[g] = (ax[g][r] + ah[g][r]) + bh[g];
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

    // streams for the weight gradients (dz is also dxp)
    for (int i = tid; i < nrows * G; i += nth) {
      const int r = i / G, j = i % G;
      dz_s[(((int64_t)d * T + t) * B + r0 + r) * G + j] = s_dz[i];
    }
    for (int i = tid; i < nrows * H; i += nth) {
      const int r = i / H, u = i % H;
      hp_s[(((int64_t)d * T + t) * B + r0 + r) * H + u] = s_hp[i];
    }
    // dh_{t-1} = pass-through + dz @ W_hh^T
    for (int c = tid; c < H; c += nth) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < G; ++j) {
        const float w = __ldg(whT + c + (int64_t)j * H);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_dz[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nrows) s_dh[r * H + c] += acc[r];
    }
    __syncthreads();  // s_dh holds dh_{t-1}; s_hp, s_dz free again
  }
}

// kind: 0 raw forward, 2 projected forward, 4 projected forward and 5 its
// backward (both directions in one launch: the kPair kernels and
// lstm_pair_bwd_kernel, on a grid two blocks high); kinds 1 and 3 are no
// longer built.
long long smem_bytes(int kind, int rows, int F, int H) {
  const bool proj = kind >= 2;
  const long long per_row = (kind % 2 == 0)
      ? 3LL * H + (proj ? 0 : 2LL * F)   // forward: h (x2), c, x (x2)
      : 7LL * H;                         // backward: hp, dz (4H), dh, dc
  return (long long)rows * per_row * (long long)sizeof(float);
}

template <int R>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)lstm_fwd_kernel<R, false>;
    case 2: return (const void*)lstm_fwd_kernel<R, true>;
    case 4: return (const void*)lstm_fwd_kernel<R, true, true>;
    case 5: return (const void*)lstm_pair_bwd_kernel<R>;
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

template <int R>
void launch_pair_bwd(dim3 grid, int smem, cudaStream_t s, const float* xp,
                     const int* lengths, const float* w_hh,
                     const float* b_hh, const float* w_hhT,
                     const float* outs, const float* cs, const float* douts,
                     const float* dh_n, const float* dc_n, float* dz_s,
                     float* hp_s, int T, int B, int H) {
  lstm_pair_bwd_kernel<R><<<grid, kBwdThreads, smem, s>>>(
      xp, lengths, w_hh, b_hh, w_hhT, outs, cs, douts, dh_n, dc_n, dz_s,
      hp_s, T, B, H);
}

// One cluster kernel at one row tile: its function, shared memory, threads
// at the widths given, the most threads it was built for, and the tile.
struct ClusterLaunch {
  const void* fn = nullptr;
  long long smem = 0;
  int threads = 0, max_threads = 0, rows = 0;
};

template <bool kProj, int R, bool kPair = false>
ClusterLaunch fwd_cluster(int F, int H) {
  return {(const void*)lstm_fwd_cluster_kernel<kProj, R, kPair>,
          cluster_smem_bytes<kProj, R>(F, H), cluster_threads<kProj, R>(H),
          ClusterShape<kProj, R>::kMaxThreads, R};
}

// The forward's cluster kernel: the raw mode at R = 10, the projected mode
// (one direction, or both with `pair`) at the row tiles built here;
// fn == nullptr for any other.
ClusterLaunch fwd_cluster_of(bool proj, int rows, int F, int H,
                             bool pair = false) {
  if (!proj)
    return rows == kClusterRows ? fwd_cluster<false, kClusterRows>(F, H)
                                : ClusterLaunch{};
  switch (rows) {
    case 12: return pair ? fwd_cluster<true, 12, true>(F, H)
                         : fwd_cluster<true, 12>(F, H);
    case 36: return pair ? fwd_cluster<true, 36, true>(F, H)
                         : fwd_cluster<true, 36>(F, H);
    default: return ClusterLaunch{};
  }
}

template <int R>
ClusterLaunch bwd_cluster(int H) {
  return {(const void*)lstm_bwd_cluster_kernel<R>,
          bwd_cluster_smem_bytes(H, R), kBwdClusterThreads,
          kBwdClusterThreads, R};
}

// The backward recurrence's cluster kernel at its row tile (36: two waves
// of the card's 15 resident clusters at B=512).
constexpr int kBwdClusterRows = 36;

ClusterLaunch bwd_cluster_of(int rows, int H) {
  return rows == kBwdClusterRows ? bwd_cluster<kBwdClusterRows>(H)
                                 : ClusterLaunch{};
}

// Sets a cluster kernel's shared-memory allowance; cudaErrorInvalidValue
// when the tile is not built, H is not a multiple of `quantum` (C for the
// forward; 4 C for the backward, whose float4 of four k belongs to one CTA),
// the CTA's units do not fit its warps (H > 256), or shared memory does not
// fit the card.
cudaError_t cluster_prepare(const ClusterLaunch& k, int H, int quantum) {
  if (k.fn == nullptr || H < quantum || H % quantum != 0 ||
      H / kClusterCtas > 32 || k.threads > k.max_threads ||
      k.smem > smem_limit(k.fn))
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)k.smem);
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    const ClusterLaunch& k, int B, int D, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kClusterCtas, (B + k.rows - 1) / k.rows, D);
  cfg->blockDim = dim3(k.threads);
  cfg->dynamicSmemBytes = k.smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Resident clusters of a cluster kernel on this card
// (cudaOccupancyMaxActiveClusters); 0 when it does not take these widths.
int cluster_max_active(const ClusterLaunch& k, int H, int quantum) {
  if (cluster_prepare(k, H, quantum) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, k.rows, 1, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, k.fn, &cfg) != cudaSuccess) return 0;
  return n;
}

// The two products of the cluster backward: (a) gates, (c) dx.
constexpr int kGatesBM = 128, kGatesBN = 128, kDxBM = 256, kDxBN = 64;

}  // namespace

extern "C" {

// The largest row tile (8, 4 or 2) whose shared memory fits the card for
// per-tile kernel `kind` (0 raw forward, 2 / 4 projected forward of one /
// both directions, 5 the latter's backward; kinds 1 and 3 are not built);
// 0 when none does.
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

// The cluster design of kind 0: how many of its clusters (C = 8 CTAs, R =
// 10 rows) can be resident on this card at once at widths (F, H)
// (cudaOccupancyMaxActiveClusters); 0 when the design does not take these
// widths.  The wrapper's shape rule reads it.
int abcd_lstm_cluster_max_active(int F, int H) {
  if (F < 1 || H < 1) return 0;
  return cluster_max_active(fwd_cluster_of(false, kClusterRows, F, H), H,
                            kClusterCtas);
}

// Both directions over raw x (kind 0) in the cluster design.  Arguments as
// abcd_lstm_bidir_fwd's, without the row tile; returns the launch's error.
int abcd_lstm_bidir_fwd_cluster(const float* x, const int* lengths,
                                const float* w_ih, const float* b_ih,
                                const float* w_hh, const float* b_hh,
                                float* outs, float* cs, float* h_n,
                                float* c_n, int T, int B, int F, int H,
                                void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ClusterLaunch k = fwd_cluster_of(false, kClusterRows, F, H);
  cudaError_t err = cluster_prepare(k, H, kClusterCtas);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, B, 2, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<false, kClusterRows>,
                           x, lengths, w_ih, b_ih, w_hh, b_hh, outs, cs, h_n,
                           c_n, T, B, F, H, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The projected mode's cluster design (kind 2's): resident clusters at
// hidden size H and row tile `rows`; 0 when it does not take them.
int abcd_lstm_fwd_cluster_max_active(int H, int rows) {
  if (H < 1) return 0;
  return cluster_max_active(fwd_cluster_of(true, rows, 0, H), H,
                            kClusterCtas);
}

// One direction over xp (T, B, 4H) in the cluster design: arguments as
// abcd_lstm_fwd's; `rows` is the cluster's row tile (12 or 36).
int abcd_lstm_fwd_cluster(const float* xp, const int* lengths,
                          const float* w_hh, const float* b_hh, float* outs,
                          float* cs, float* h_n, float* c_n, int T, int B,
                          int H, int reverse, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ClusterLaunch k = fwd_cluster_of(true, rows, 0, H);
  cudaError_t err = cluster_prepare(k, H, kClusterCtas);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, B, 1, (cudaStream_t)stream);
  switch (rows) {
#define ABCD_FWD_CLUSTER(RR)                                                 \
  case RR:                                                                  \
    err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<true, RR>, xp,   \
                             lengths, (const float*)nullptr,                \
                             (const float*)nullptr, w_hh, b_hh, outs, cs,   \
                             h_n, c_n, T, B, 0, H, reverse);                \
    break;
    ABCD_FWD_CLUSTER(12)
    ABCD_FWD_CLUSTER(36)
#undef ABCD_FWD_CLUSTER
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The raw forward's "proj" design, part (b): the projected mode over both
// directions (kPair) at hidden size H and row tile `rows`: resident
// clusters, 0 when it does not take them.
int abcd_lstm_pair_cluster_max_active(int H, int rows) {
  if (H < 1) return 0;
  return cluster_max_active(fwd_cluster_of(true, rows, 0, H, true), H,
                            kClusterCtas);
}

// Part (a) of the "proj" design: xp (T, 2, B, 4H) = x W_ih[d] + b_ih[d] at
// every active row-step of both directions, direction 1 at its own flipped
// time (rows in the span prefix's order; the others are left unwritten).
int abcd_lstm_bidir_xp(const float* x, const int* prefix, const float* w_ih,
                       const float* b_ih, float* xp, int T, int B, int F,
                       int H, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * H + kGatesBN - 1) / kGatesBN,
                  (T * B + kGatesBM - 1) / kGatesBM, 2);
  lstm_gates_kernel<kGatesBM, kGatesBN, 8, 8, kGatesXp>
      <<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
          x, prefix, w_ih, b_ih, w_ih, b_ih, nullptr, xp, nullptr, T, B, F,
          H, 0);
  return (int)cudaGetLastError();
}

// Part (b): both directions over that xp in the cluster design, one launch
// (grid z = direction); outs, cs (or nullptr), h_n and c_n as the raw
// forward's.  `rows` is the cluster's row tile (12 or 36).
int abcd_lstm_bidir_fwd_proj(const float* xp, const int* lengths,
                             const float* w_hh, const float* b_hh,
                             float* outs, float* cs, float* h_n, float* c_n,
                             int T, int B, int H, int rows, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ClusterLaunch k = fwd_cluster_of(true, rows, 0, H, true);
  cudaError_t err = cluster_prepare(k, H, kClusterCtas);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, B, 2, (cudaStream_t)stream);
  switch (rows) {
#define ABCD_PAIR_CLUSTER(RR)                                                \
  case RR:                                                                  \
    err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel<true, RR, true>, \
                             xp, lengths, (const float*)nullptr,            \
                             (const float*)nullptr, w_hh, b_hh, outs, cs,   \
                             h_n, c_n, T, B, 0, H, 0);                      \
    break;
    ABCD_PAIR_CLUSTER(12)
    ABCD_PAIR_CLUSTER(36)
#undef ABCD_PAIR_CLUSTER
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The raw backward's cluster recurrence: resident clusters at hidden size
// H and row tile `rows`; 0 when it does not take them.
int abcd_lstm_bwd_cluster_max_active(int H, int rows) {
  if (H < 1) return 0;
  return cluster_max_active(bwd_cluster_of(rows, H), H, 4 * kClusterCtas);
}

// prefix (B + 1) of the rows' active steps (see span_prefix_kernel).
int abcd_lstm_span_prefix(const int* lengths, int* prefix, int T, int B,
                          void* stream) {
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  span_prefix_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(lengths, prefix,
                                                          T, B);
  return (int)cudaGetLastError();
}

// (a) of the cluster backward: the activated gates of every active
// row-step of both directions into `gates` (2, T, B, 4H) at original time,
// and the h_prev stream hp_s (2, T, B, H) at those row-steps (the caller
// zeroes it: the other rows' entries meet a zero dz in dW_hh).
int abcd_lstm_bidir_gates(const float* x, const int* prefix,
                          const float* w_ih, const float* b_ih,
                          const float* w_hh, const float* b_hh,
                          const float* outs, float* gates, float* hp_s,
                          int T, int B, int F, int H, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * H + kGatesBN - 1) / kGatesBN,
                  (T * B + kGatesBM - 1) / kGatesBM, 2);
  lstm_gates_kernel<kGatesBM, kGatesBN, 8, 8>
      <<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
          x, prefix, w_ih, b_ih, w_hh, b_hh, outs, gates, hp_s, T, B, F, H,
          0);
  return (int)cudaGetLastError();
}

// (b): the recurrence over the gates that (a) left in dz_s, which it
// overwrites with dz (zeros at inactive row-steps).  douts may be nullptr.
// `rows` is the cluster's row tile (36).
int abcd_lstm_bidir_bwd_cluster(const int* lengths, const float* w_hh,
                                const float* cs, const float* douts,
                                const float* dh_n, const float* dc_n,
                                float* dz_s, int T, int B, int H, int rows,
                                void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ClusterLaunch k = bwd_cluster_of(rows, H);
  cudaError_t err = cluster_prepare(k, H, 4 * kClusterCtas);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, B, 2, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<kBwdClusterRows>,
                           lengths, w_hh, cs, douts, dh_n, dc_n, dz_s, T, B,
                           H, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Row 3b's cluster route, part (b): the same recurrence over one direction
// (D = 1; `reverse` picks the span), every stream in xp's own time: the
// gates that abcd_lstm_layer_gates left in dz_s (T, B, 4H) become dz (zeros
// at inactive row-steps), which is dxp.
int abcd_lstm_bwd_cluster(const int* lengths, const float* w_hh,
                          const float* cs, const float* douts,
                          const float* dh_n, const float* dc_n, float* dz_s,
                          int T, int B, int H, int reverse, int rows,
                          void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const ClusterLaunch k = bwd_cluster_of(rows, H);
  cudaError_t err = cluster_prepare(k, H, 4 * kClusterCtas);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, k, B, 1, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<kBwdClusterRows>,
                           lengths, w_hh, cs, douts, dh_n, dc_n, dz_s, T, B,
                           H, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// (c): dx (T, B, F) at the rows (t, b) with t < len from the dz stream;
// the caller zeroes dx (the other rows' dx is zero).
int abcd_lstm_bidir_dx(const float* dz_s, const int* prefix,
                       const float* w_ih, float* dx, int T, int B, int F,
                       int H, void* stream) {
  if (T < 1 || B < 1 || F < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + kDxBN - 1) / kDxBN, (T * B + kDxBM - 1) / kDxBM, 1);
  lstm_dx_kernel<kDxBM, kDxBN, 8, 8>
      <<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(dz_s, prefix, w_ih,
                                                        dx, T, B, F, H);
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
  auto go = rows == 8   ? &launch_pair_bwd<8>
            : rows == 4 ? &launch_pair_bwd<4>
                        : &launch_pair_bwd<2>;
  go(grid, smem, (cudaStream_t)stream, xp, lengths, w_hh, b_hh, w_hhT, outs,
     cs, douts, dh_n, dc_n, dz_s, hp_s, T, B, H);
  return (int)cudaGetLastError();
}

// Row 3b's part (a): the activated gates of every active row-step of one
// direction over xp (T, B, 4H) into `gates` (T, B, 4H) at xp's own time;
// `reverse` picks the span.
int abcd_lstm_layer_gates(const float* xp, const int* prefix,
                          const float* w_hh, const float* b_hh,
                          const float* outs, float* gates, int T, int B,
                          int H, int reverse, void* stream) {
  if (T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * H + kGatesBN - 1) / kGatesBN,
                  (T * B + kGatesBM - 1) / kGatesBM, 1);
  lstm_gates_kernel<kGatesBM, kGatesBN, 8, 8, kGatesLayer>
      <<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
          xp, prefix, nullptr, nullptr, w_hh, b_hh, outs, gates, nullptr, T,
          B, 0, H, reverse);
  return (int)cudaGetLastError();
}

// Part (b) of the grid design, for D = 2 (row 2b: the streams (T, 2, B, .)
// and dz_s (2, T, B, 4H) at original time) or D = 1 (row 3b: xp's own time,
// `reverse` picking the span): the rows ordered by length (into `order`,
// B ints), the last step's elementwise backward, then one launch of the
// per-step product a step, s = T - 1 down to 1.  w_hhT is W_hh transposed,
// (D, 4H, H); dh_s and dc_s (D, B, H) hold the carries between launches.
// The gates that part (a) left in dz_s become dz (zeros at inactive
// row-steps).  douts may be nullptr.
int abcd_lstm_bwd_grid(const int* lengths, int* order, const float* w_hhT,
                       const float* cs, const float* douts,
                       const float* dh_n, const float* dc_n, float* dz_s,
                       float* dh_s, float* dc_s, int T, int B, int H, int D,
                       int reverse, void* stream) {
  if (T < 1 || B < 1 || H < 1 || D < 1 || D > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  length_order_kernel<<<1, 1024, 0, st>>>(lengths, order, T, B);
  const long long n = (long long)B * H;
  lstm_bwd_first_kernel<<<dim3((unsigned)((n + 255) / 256), 1, D), 256, 0,
                          st>>>(lengths, cs, douts, dh_n, dc_n, dz_s, dh_s,
                                dc_s, T, B, H, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kStepSplit * ((H + kStepBN - 1) / kStepBN),
                     (B + kStepBM - 1) / kStepBM, D);
  cfg.blockDim = dim3(kStepThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kStepSplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  for (int s = T - 1; s >= 1; --s) {
    err = cudaLaunchKernelEx(
        &cfg, lstm_bwd_step_kernel<kStepBM, kStepBN, kStepTM, kStepTN>,
        lengths, (const int*)order, w_hhT, cs, douts, dz_s, dh_s, dc_s, s, T,
        B, H, reverse);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Splits of the rows for abcd_lstm_wgrad: blocks for about four waves of
// two a SM on an H100 (132 SMs), at least 1,024 row-steps each: the
// one-direction backward at H=256 has 16 tiles of C, and 62 splits took
// its weight gradients from 1.09 to 0.87 ms.  The wrapper sizes the
// workspace, splits * D * (F + H + 1) * 4H floats, from this.
int abcd_lstm_wgrad_splits(int T, int B, int F, int H, int D) {
  const int tiles = ((4 * H + kWgradBN - 1) / kWgradBN) *
                    ((F + H + kWgradBM - 1) / kWgradBM) * D;
  int splits = (4 * 264 + tiles / 2) / tiles;
  const long long by_rows = (long long)T * B / 1024;
  if (splits > by_rows) splits = (int)by_rows;
  if (splits > 64) splits = 64;
  return splits < 1 ? 1 : splits;
}

// Part (d) of the grid design and of row 3b's cluster route: over the
// active row-steps in the span prefix's order, dW_ih (D, F, 4H) = x^T dz
// (raw, D = 2; x nullptr and F = 0 for the layer, dw_ih unused), dW_hh
// (D, H, 4H) = h_prev^T dz and db (D, 4H) = the column sums of dz, in a
// fixed order.  `part` holds splits * D * (F + H + 1) * 4H floats.
int abcd_lstm_wgrad(const float* x, const int* prefix, const float* outs,
                    const float* dz_s, float* part, float* dw_ih,
                    float* dw_hh, float* db, int T, int B, int F, int H,
                    int D, int reverse, int splits, void* stream) {
  if (T < 1 || B < 1 || F < 0 || H < 1 || D < 1 || D > 2 || splits < 1 ||
      (F > 0) != (x != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((4 * H + kWgradBN - 1) / kWgradBN,
                  (F + H + kWgradBM - 1) / kWgradBM, D * splits);
  lstm_wgrad_kernel<kWgradBM, kWgradBN, 8, 8><<<grid, kGemmThreads, 0, st>>>(
      x, prefix, outs, dz_s, part, T, B, F, H, D, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_bias_kernel<<<dim3((4 * H + kBiasCols - 1) / kBiasCols, 1,
                          D * splits),
                     kBiasCols * kBiasGroups, 0, st>>>(prefix, dz_s, part, T,
                                                       B, F, H, D, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long size = (long long)D * (F + H + 1) * 4 * H;
  lstm_wgrad_sum_kernel<<<(unsigned)((size + 255) / 256), 256, 0, st>>>(
      part, splits, D, F, H, dw_ih, dw_hh, db);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
