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
// What bounds them on the H100: the float32 operations are 2 * 4H * (F + H)
// (raw) or 2 * 4H * H (projected) multiply-adds per row, step and direction,
// but the time loop is sequential and every step needs all of the weights
// (1.58 MB per direction at H=256, F=129), far more than one SM holds.
//
// Per-tile design (lstm_fwd_kernel, lstm_bwd_kernel; every kind): CUDA
// blocks run in no order, so the time loop lives inside the block, as the
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
// Cluster design (lstm_fwd_cluster_kernel; the raw forward, kind 0): the
// weights live in shared memory for the whole sequence, split across a
// thread-block cluster of C = 8 CTAs (the portable maximum) per (direction,
// tile of R = 10 rows).  CTA c owns hidden units [c H / C, (c + 1) H / C):
// all four gates of them, as W_ih and W_hh column slices loaded once with
// cp.async ((F + H) * 4H / C floats: 197,120 bytes at F=129, H=256; with h
// double-buffered and one step's x rows and x-half sums, 232,000 of the
// 232,448 a block may have).  A thread owns one unit's four gate columns
// for four of the tile's rows (h kept 12 rows a k), so a warp reads a
// weight row as one conflict-free LDS.128 and h of its four rows as one
// broadcast LDS.128, and keeps the unit's c and h in registers; the loads
// run one group of four rows ahead of the FMAs.  Two roles of 3 x 32
// threads at H=256: the h warps run step t (ax(t) into registers, a wait
// on an mbarrier for the peers' slices of h_t, the h half of the gate
// sums, the gates, c and h, which each thread writes into the next-h
// buffer of its own CTA and, with st.async counted on the peer's mbarrier,
// of every peer); the x warps meanwhile compute the x half of step t + 1,
// which needs no h, stage x_{t+2} with cp.async, and write ax(t+1) once
// the h warps have taken ax(t).  A CTA barrier ends a step; no cluster-wide
// barrier runs between the first step and the last.  Each dot product
// stays in one thread in the per-tile kernel's order (x over F, then h
// over H, then ((ax + bx) + ah) + bh), so the sums stay at the per-tile
// kernel's; the gates use the hardware reciprocal with one Newton step and
// tanh x = 2 sigmoid(2x) - 1 (within 1e-7 of expf / tanhf), without the
// branches that made them a fifth of a step.  Every CTA runs every step,
// also when its rows are past the batch.  What bounds it: a step's h half
// (256 weight rows of two LDS.128 and 16 FMAs for each h warp, one warp a
// scheduler, sharing shared-memory bandwidth with the x warps), then the
// gates and the exchange.  The card holds 15 such clusters at once
// (cudaOccupancyMaxActiveClusters on the H100): R = 10 puts B=64 in 14,
// one wave.
//
// Shape rule (ops/lstm_kernel.py:forward_design, decided before the launch
// from abcd_lstm_cluster_max_active): the cluster kernel when H is a
// multiple of C, its shared memory fits the card (F <= 129 at H=256: not
// H=1024, not a second layer's F = 2H) and its grid of 2 * ceil(B / R)
// clusters runs in few enough waves of the resident clusters; the per-tile
// kernel otherwise.

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
// Cluster design of the raw-input forward (see the header)
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kClusterCtas = 8;       // C: CTAs a cluster (the portable most)
constexpr int kClusterRows = 10;      // R: batch rows a cluster's tile
constexpr int kGroupRows = 4;         // rows a thread owns
constexpr int kRowStride = 12;        // h rows kept per k: R rounded to 4
constexpr int kRowGroups = kRowStride / kGroupRows;
constexpr int kClusterMaxThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// to whole warps.  A CTA has two roles of kRowGroups row groups.
__host__ __device__ inline int cluster_group_threads(int H) {
  return (H / kClusterCtas + 31) / 32 * 32;
}

__host__ __device__ inline int cluster_threads(int H) {
  return 2 * kRowGroups * cluster_group_threads(H);
}

// Floats of one step's x rows in shared memory, rounded up to whole
// float4s.
__host__ __device__ inline int cluster_x_floats(int F) {
  return (kClusterRows * F + 3) & ~3;
}

// Shared memory of one CTA: the W_ih and W_hh slices, h double-buffered
// (kRowStride rows a k), the x rows of one step and the x half's sums, and
// the two h buffers' mbarriers: 232,000 bytes at F=129, H=256.
long long cluster_smem_bytes(int F, int H) {
  const long long g4 = 4LL * (H / kClusterCtas);
  return ((long long)(F + H) * g4 + 2LL * H * kRowStride +
          cluster_x_floats(F) + (long long)kClusterRows * g4) *
             (long long)sizeof(float) +
         2LL * (long long)sizeof(uint64_t);
}

// Grid (C, ceil(B / R), 2), cluster (C, 1, 1), cluster_threads(H) threads:
// per role, per row group of four rows (the third holds rows 8, 9 and two
// rows that are never active), one thread per unit of the CTA's slice (the
// slice's columns 4 u .. 4 u + 3 are the unit's gates i, f, g, o).  Role 0
// (the h warps) runs step t: it takes ax(t) into registers, waits on its
// mbarrier for the peers' slices of h_t, computes the h half of the sums,
// the gates, c and h of its unit and rows, and writes its h into the
// next-h buffer here and, with st.async, in every peer.  Role 1 (the x
// warps) meanwhile computes the x half of step t + 1 from x_{t+1} in
// shared memory, stages x_{t+2} there, and writes ax(t+1) once the h warps
// have taken ax(t).  One CTA barrier ends a step; outs and cs of step t
// are stored after it.
__global__ void __launch_bounds__(kClusterMaxThreads) lstm_fwd_cluster_kernel(
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
  constexpr int R = kClusterRows;
  constexpr int RS = kRowStride;
  constexpr int C = kClusterCtas;
  constexpr int Q = kGroupRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int U = H / C;                  // units of this CTA
  const int G4 = 4 * U;                 // gate columns of this CTA
  const int G = 4 * H;
  const int GT = cluster_group_threads(H);
  const int RT = kRowGroups * GT;       // threads of a role
  const int d = blockIdx.z;
  const int r0 = blockIdx.y * R;
  const int nrows = min(R, B - r0);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int role = tid / RT;            // 0: h warps, 1: x warps
  const int ridx = tid - role * RT;     // index within the role
  const int rb = (ridx / GT) * Q;       // first row of this thread
  const int ul = ridx % GT;
  const bool live = ul < U;             // lanes past the slice idle
  const int ucol = 4 * (live ? ul : U - 1);  // the unit's first column
  const int unit = rank * U + ucol / 4;

  extern __shared__ float4 smem4[];
  float* s_wi = reinterpret_cast<float*>(smem4);   // [F][G4]
  float* s_wh = s_wi + F * G4;                     // [H][G4]
  float* s_h = s_wh + H * G4;                      // [2][H][RS]
  // x_t's rows: rows 0-3 and 4-7 as [F][4] each, rows 8-9 as [F][2]
  float* s_x = s_h + 2 * H * RS;
  float* s_ax = s_x + cluster_x_floats(F);         // [R][G4]
  // s_full[b]: the peers' slices of the h in buffer b have landed
  uint64_t* s_full = reinterpret_cast<uint64_t*>(s_ax + R * G4);

  const float* wi = w_ih + (int64_t)d * F * G;
  const float* wh = w_hh + (int64_t)d * H * G;
  for (int i = tid; i < 2 * H * RS + cluster_x_floats(F); i += nth)
    s_h[i] = 0.f;
  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the slices, once: column c of the slice is gate c % 4 of unit
  // rank * U + c / 4
  for (int i = tid; i < F * G4; i += nth) {
    const int k = i / G4, c = i - k * G4;
    cp_async4(s_wi + i, wi + (int64_t)k * G + (c & 3) * H + rank * U + (c >> 2));
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
  if (role == 1) stage_x(0);
  cp_async_wait_all();
  __syncthreads();  // slices and x_0 in place
  if (role == 1) {
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
  const int tx_bytes = (C - 1) * U * kRowGroups * (int)sizeof(float4);

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
      bx[g] = b_ih[d * G + g * H + unit];
      bh[g] = b_hh[d * G + g * H + unit];
    }
    const bool rev = d == 1;
    for (int t = 0; t < T; ++t) {
      const int cur = t & 1;
      float* hn = s_h + (cur ^ 1) * H * RS;
      float4 ax[Q];  // ax(t), which the x warps may then overwrite
#pragma unroll
      for (int q = 0; q < Q; ++q)
        ax[q] = rb + q < R ? *reinterpret_cast<const float4*>(
                                 s_ax + (rb + q) * G4 + ucol)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      if (t + 1 < T) named_arrive(3, nth);
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
          // the reference's association: (x W_ih + b_ih) + h W_hh + b_hh
          z[g] = ((axg[g] + bx[g]) + ah[g][q]) + bh[g];
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
                (((int64_t)t * 2 + d) * B + r0 + rb + q) * H + unit;
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

// Sets the cluster kernel's shared-memory allowance at these widths;
// cudaErrorInvalidValue when H is not a multiple of C or the slices do not
// fit the card's shared memory.
cudaError_t cluster_prepare(int F, int H, int* smem_out, int* threads_out) {
  const void* fn = (const void*)lstm_fwd_cluster_kernel;
  const int threads = cluster_threads(H);
  const long long smem = cluster_smem_bytes(F, H);
  if (H % kClusterCtas != 0 || threads > kClusterMaxThreads ||
      smem > smem_limit(fn))
    return cudaErrorInvalidValue;
  *smem_out = (int)smem;
  *threads_out = threads;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int B, int smem, int threads, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kClusterCtas, (B + kClusterRows - 1) / kClusterRows, 2);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterCtas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
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

// The cluster design of kind 0: how many of its clusters (C = 8 CTAs, R = 8
// rows) can be resident on this card at once at widths (F, H)
// (cudaOccupancyMaxActiveClusters); 0 when the design does not take these
// widths.  The wrapper's shape rule reads it.
int abcd_lstm_cluster_max_active(int F, int H) {
  int smem = 0, threads = 0;
  if (F < 1 || H < 1 || cluster_prepare(F, H, &smem, &threads) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, kClusterRows, smem, threads, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, (const void*)lstm_fwd_cluster_kernel, &cfg) != cudaSuccess)
    return 0;
  return n;
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
  int smem = 0, threads = 0;
  cudaError_t err = cluster_prepare(F, H, &smem, &threads);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, B, smem, threads, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, lstm_fwd_cluster_kernel, x, lengths, w_ih,
                           b_ih, w_hh, b_hh, outs, cs, h_n, c_n, T, B, F, H);
  if (err != cudaSuccess) return (int)err;
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
