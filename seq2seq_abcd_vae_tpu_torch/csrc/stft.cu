// Log-amplitude spectrogram of centred audio, written for Hopper (sm_90a).
//
// Replaces seq2seq_abcd_vae_tpu/ops/stft_pallas.py:log_spectrogram_pallas
// (its `_kernel`): frames -> windowed real DFT -> |.| -> log(x + eps) / N,
// one (B, T, bins) float32 result.  Two hand-written routes, chosen by the
// wrapper (ops/stft_kernel.py) from the frame length before the launch:
//
// - FFT route (log_spectrogram_fft_kernel), for every even frame N from
//   16 to 1024 whose M = N / 2 has no prime factor above 11.  Two instances
//   of one kernel: radix-4/2 passes only for a power-of-two M (kMixed =
//   false: 256 at 32 kHz, the publication config; 128 at 16 kHz), and a
//   mixed-radix one for any other such M (kMixed = true).  Common rates
//   (8 ms frame): 11.025 kHz N=88 (M = 4 * 11), 16 kHz 128, 22.05 kHz 176
//   (M = 8 * 11), 24 kHz 192 (M = 32 * 3), 32 kHz 256, 44.1 kHz 352 (M =
//   16 * 11), 48 kHz 384 (M = 64 * 3), 96 kHz 768 (M = 128 * 3) all take
//   it; 26 kHz's 208 (M = 8 * 13) or a prime M take the DFT route.
//   What bounds it: the function needs only the bytes of audio in and
//   spectrogram out (about 0.01 ms at B=64, T=512, fs=32 kHz against
//   3.35 TB/s); an FFT's O(N log N) operations per frame sit far below
//   that, so what is left is shared-memory traffic and the log.  Design:
//   a block owns 32 consecutive frames of one row.  It stages, coalesced,
//   the audio span of its frames once (neighbours overlap by half, since
//   frame == 2 * step), the window (column 0 of the windowed basis: cos 0 =
//   1, so it is the window exactly) and the twiddle table W_N^j =
//   exp(-2 pi i j / N), j < N (float64 on the host, rounded once,
//   ops/stft_kernel.fft_twiddles).  Each warp then takes whole frames in
//   turn: the windowed frame packed as M = N / 2 complex points z[n] =
//   x[2n] + i x[2n+1], a Stockham FFT of z in the warp's two shared buffers
//   (the passes of fft_plan: radix 4 while two factors of 2 are left, then
//   one radix-2 pass, then radix 3, 5, 7 and 11 passes; pass (R, p),
//   butterfly i, k = i mod p: inputs z[i + r M / R] times W_{pR}^{r k} =
//   W_N^{r k N / (p R)}, an R-point DFT, outputs at (i - k) R + k + q p),
//   the first pass reading the audio span directly; then the real-split step
//   X[k] = (E - i W_N^k O) / 2, E / O = Z[k] +/- conj(Z[M - k]), and
//   log(|X[k]| + eps) / N written coalesced, for 0 < k < M.  An odd
//   radix's R-point DFT pairs outputs q and R - q: with a_r = v_r +
//   v_{R-r} and b_r = v_r - v_{R-r} (0 < r <= (R - 1) / 2), y_q, y_{R-q} =
//   v_0 + sum c_{rq} a_r -/+ i sum s_{rq} b_r, c and s the cosine and sine
//   of 2 pi r q / R read from the table at W_N^{(r q mod R) N / R}: about
//   R^2 FMAs a butterfly, a quarter of the direct sum's.  The buffers are
//   padded by one complex per 16 (index + index / 16), which keeps every
//   pass's reads and all but the p = 4 pass's writes free of bank
//   conflicts for a power-of-two M; an odd radix's writes at stride R
//   (p = 1) fall two lanes to a bank pair, no worse than a float2 access
//   costs anyway, so the same pad serves it.  The two real bins, DC and
//   Nyquist (k = 0, M), are sums of +/- w[n] x[n] whose values near zero
//   are a one-dimensional Gaussian's, far likelier than a complex bin's:
//   their log is where float32 rounding shows.  Warps 0 and 1 sum them
//   directly, as the DFT route does (the basis columns 0 and M, one FMA
//   chain over n in order), lane f for frame f, each lane's chain started
//   one step after its left neighbour's so that the lanes' shared-memory
//   reads fall in distinct banks.
// - DFT route (log_spectrogram_kernel), for every other frame (208 at
//   26 kHz, a prime M): a direct DFT, 4 * N float32
//   operations per output, so it is bound by its own arithmetic, far above
//   the byte bound.  One block computes a tile of 32 bins x 32 frames of one
//   row with the windowed basis tile and the audio span staged in shared
//   memory; each warp owns 4 frames and lane j bin j of the tile.
//
// Both stay in float32 FMA on purpose: no TF32 and no tensor cores, because
// quiet bins cancel catastrophically in fewer mantissa bits
// (stft_pallas.py:56-58).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 32;           // bins per block (threadIdx.x)
constexpr int kWarps = 8;           // warps per block (threadIdx.y)
constexpr int kFramesPerWarp = 4;   // frames each warp accumulates
constexpr int kFrames = kWarps * kFramesPerWarp;

constexpr int kFftMinFrame = 16;
constexpr int kFftMaxFrame = 1024;

__global__ void __launch_bounds__(kBins * kWarps)
log_spectrogram_kernel(const float* __restrict__ audio, int64_t row_len,
                       const float* __restrict__ cos_b,
                       const float* __restrict__ sin_b,
                       float* __restrict__ out, int frame, int step,
                       int num_frames, int bins, float epsilon,
                       float inv_normalizer) {
  extern __shared__ float smem[];
  float* s_cos = smem;                    // [frame][kBins]
  float* s_sin = s_cos + frame * kBins;   // [frame][kBins]
  float* s_audio = s_sin + frame * kBins; // (kFrames - 1) * step + frame

  const int bin0 = blockIdx.x * kBins;
  const int t0 = blockIdx.y * kFrames;
  const int64_t row = blockIdx.z;
  const int tid = threadIdx.y * kBins + threadIdx.x;
  const int nthreads = kBins * kWarps;

  for (int i = tid; i < frame * kBins; i += nthreads) {
    const int k = i / kBins;
    const int f = bin0 + i % kBins;
    const bool ok = f < bins;
    s_cos[i] = ok ? cos_b[k * bins + f] : 0.f;
    s_sin[i] = ok ? sin_b[k * bins + f] : 0.f;
  }
  // Samples of the frames this block owns; frames past num_frames read
  // zeros and are never written.
  const int last = min(num_frames, t0 + kFrames) - 1;
  const int span = (last - t0) * step + frame;
  const int full = (kFrames - 1) * step + frame;
  const float* src = audio + row * row_len + (int64_t)t0 * step;
  for (int i = tid; i < full; i += nthreads) {
    s_audio[i] = i < span ? src[i] : 0.f;
  }
  __syncthreads();

  const int j = threadIdx.x;
  const int tl = threadIdx.y * kFramesPerWarp;
  float re[kFramesPerWarp];
  float im[kFramesPerWarp];
#pragma unroll
  for (int q = 0; q < kFramesPerWarp; ++q) {
    re[q] = 0.f;
    im[q] = 0.f;
  }
  const float* xs = s_audio + tl * step;
  for (int k = 0; k < frame; ++k) {
    const float c = s_cos[k * kBins + j];
    const float s = s_sin[k * kBins + j];
#pragma unroll
    for (int q = 0; q < kFramesPerWarp; ++q) {
      const float x = xs[q * step + k];
      re[q] = fmaf(x, c, re[q]);
      im[q] = fmaf(x, s, im[q]);
    }
  }
  const int f = bin0 + j;
  if (f >= bins) return;
#pragma unroll
  for (int q = 0; q < kFramesPerWarp; ++q) {
    const int t = t0 + tl + q;
    if (t < num_frames) {
      const float amp = sqrtf(re[q] * re[q] + im[q] * im[q]);
      out[(row * num_frames + t) * bins + f] =
          logf(amp + epsilon) * inv_normalizer;
    }
  }
}

// ---------------------------------------------------------------------------
// FFT route
// ---------------------------------------------------------------------------

// Padded index of complex point i in a warp's buffer: one pad per 16.
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

__host__ __device__ inline int padded_points(int m) { return m + (m >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// Samples of the span of a block's frames, rounded up to whole float4s.
__host__ __device__ inline int fft_span_floats(int frame, int step) {
  return ((kFrames - 1) * step + frame + 3) & ~3;
}

// One radix-R Stockham pass of a warp's frame (R = 2, 3, 4, 5, 7 or 11;
// see the header): butterflies i = lane, lane + 32, ... < M / R.  `in` ==
// nullptr: the first pass, reading the windowed audio at xs.  p is the
// product of the earlier passes' radices.  kPow2 (M a power of two): k =
// i mod p by a mask, and the audio read a float2 a point; otherwise by a
// division and two scalar loads (M may be odd, and a frame's span then
// starts at an odd float).
template <int R, bool kPow2>
__device__ __forceinline__ void stockham_pass(const float2* in,
                                              const float* __restrict__ xs,
                                              const float* __restrict__ s_win,
                                              float2* outb,
                                              const float2* __restrict__ s_tw,
                                              int M, int N, int p, int lane) {
  constexpr int kHalf = (R - 1) / 2;
  const int nb = M / R;               // butterflies, also the stride
  const int tw_step = N / (p * R);    // W_{pR}^{rk} = W_N^{r k tw_step}
  // an odd radix's cos and sin of 2 pi j / R, j = 1..kHalf
  float cr[kHalf > 0 ? kHalf : 1], sr[kHalf > 0 ? kHalf : 1];
  if constexpr (R % 2 == 1) {
#pragma unroll
    for (int j = 1; j <= kHalf; ++j) {
      const float2 w = s_tw[j * (N / R)];
      cr[j - 1] = w.x;
      sr[j - 1] = -w.y;
    }
  }
  for (int i = lane; i < nb; i += 32) {
    const int k = kPow2 ? i & (p - 1) : i % p;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = i + r * nb;
      if (in == nullptr) {
        const float2 a =
            kPow2 ? *reinterpret_cast<const float2*>(xs + 2 * n)
                  : make_float2(xs[2 * n], xs[2 * n + 1]);
        v[r] = make_float2(a.x * s_win[2 * n], a.y * s_win[2 * n + 1]);
      } else {
        v[r] = in[pad16(n)];
      }
      if (r > 0) v[r] = cmul(v[r], s_tw[r * k * tw_step]);
    }
    const int j = (i - k) * R + k;
    if constexpr (R == 4) {
      const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
      const float2 b = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
      const float2 c = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
      const float2 e = make_float2(v[1].x - v[3].x, v[1].y - v[3].y);
      outb[pad16(j)] = make_float2(a.x + c.x, a.y + c.y);
      outb[pad16(j + p)] = make_float2(b.x + e.y, b.y - e.x);
      outb[pad16(j + 2 * p)] = make_float2(a.x - c.x, a.y - c.y);
      outb[pad16(j + 3 * p)] = make_float2(b.x - e.y, b.y + e.x);
    } else if constexpr (R == 2) {
      outb[pad16(j)] = make_float2(v[0].x + v[1].x, v[0].y + v[1].y);
      outb[pad16(j + p)] = make_float2(v[0].x - v[1].x, v[0].y - v[1].y);
    } else {
      // y_q, y_{R-q} = v_0 + sum_r c a_r -/+ i sum_r s b_r
      float2 a[kHalf > 0 ? kHalf : 1], b[kHalf > 0 ? kHalf : 1];
      float2 y0 = v[0];
#pragma unroll
      for (int r = 1; r <= kHalf; ++r) {
        a[r - 1] = make_float2(v[r].x + v[R - r].x, v[r].y + v[R - r].y);
        b[r - 1] = make_float2(v[r].x - v[R - r].x, v[r].y - v[R - r].y);
        y0 = make_float2(y0.x + a[r - 1].x, y0.y + a[r - 1].y);
      }
      outb[pad16(j)] = y0;
#pragma unroll
      for (int q = 1; q <= kHalf; ++q) {
        float2 ac = v[0];
        float2 bs = make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 1; r <= kHalf; ++r) {
          const int m = (r * q) % R;   // a constant once unrolled
          const float c = m <= kHalf ? cr[m - 1] : cr[R - m - 1];
          const float sn = m <= kHalf ? sr[m - 1] : -sr[R - m - 1];
          ac = make_float2(fmaf(c, a[r - 1].x, ac.x),
                           fmaf(c, a[r - 1].y, ac.y));
          bs = make_float2(fmaf(sn, b[r - 1].x, bs.x),
                           fmaf(sn, b[r - 1].y, bs.y));
        }
        outb[pad16(j + q * p)] = make_float2(ac.x + bs.y, ac.y - bs.x);
        outb[pad16(j + (R - q) * p)] = make_float2(ac.x - bs.y,
                                                   ac.y + bs.x);
      }
    }
  }
}

// The passes of `plan` (fft_plan, 4 bits a radix, the first pass lowest):
// kMixed = false, radix 4 and 2 over a power-of-two M; kMixed = true, any
// radix of 2, 3, 4, 5, 7 and 11.
template <bool kMixed>
__global__ void __launch_bounds__(32 * kWarps)
log_spectrogram_fft_kernel(const float* __restrict__ audio, int64_t row_len,
                           const float* __restrict__ cos_b,
                           const float* __restrict__ sin_b,
                           const float2* __restrict__ twiddle,
                           float* __restrict__ out, int frame, int step,
                           int num_frames, int bins,
                           unsigned long long plan, float epsilon,
                           float inv_normalizer) {
  extern __shared__ float4 smem4[];
  const int N = frame;
  const int M = N >> 1;
  const int PM = padded_points(M);
  float2* s_tw = reinterpret_cast<float2*>(smem4);           // [N]
  // basis columns 0 and M: [0] cos 0 (the window), [1] sin 0, [2] cos M,
  // [3] sin M, N each
  float* s_edge = reinterpret_cast<float*>(s_tw + N);        // [4][N]
  const float* s_win = s_edge;
  float* s_audio = s_edge + 4 * N;                           // span
  float2* s_buf = reinterpret_cast<float2*>(
      s_audio + fft_span_floats(frame, step));               // [warps][2][PM]

  const int t0 = blockIdx.x * kFrames;
  const int64_t row = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < N; i += nthreads) {
    s_tw[i] = twiddle[i];
    s_edge[i] = cos_b[(int64_t)i * bins];
    s_edge[N + i] = sin_b[(int64_t)i * bins];
    s_edge[2 * N + i] = cos_b[(int64_t)i * bins + M];
    s_edge[3 * N + i] = sin_b[(int64_t)i * bins + M];
  }
  const int last = min(num_frames, t0 + kFrames) - 1;
  const int span = (last - t0) * step + frame;
  const int full = fft_span_floats(frame, step);
  const float* src = audio + row * row_len + (int64_t)t0 * step;
  for (int i = tid; i < full; i += nthreads) {
    s_audio[i] = i < span ? src[i] : 0.f;
  }
  __syncthreads();

  if (warp < 2) {
    // the real bins: warp 0 DC, warp 1 Nyquist; lane f frame f, its chain
    // over n in order, run at steps i = n + f
    const float* cb = s_edge + warp * 2 * N;
    const float* sb = cb + N;
    const float* xs = s_audio + lane * step;
    float re = 0.f, im = 0.f;
    for (int i = 0; i < N + 31; ++i) {
      const int n = i - lane;
      if (n >= 0 && n < N) {
        const float x = xs[n];
        re = fmaf(x, cb[n], re);
        im = fmaf(x, sb[n], im);
      }
    }
    const int t = t0 + lane;
    if (t < num_frames) {
      const float amp = sqrtf(re * re + im * im);
      out[(row * num_frames + t) * bins + (warp == 0 ? 0 : M)] =
          logf(amp + epsilon) * inv_normalizer;
    }
  }

  float2* buf0 = s_buf + warp * 2 * PM;
  float2* buf1 = buf0 + PM;
  for (int q = 0; q < kFramesPerWarp; ++q) {
    const int tl = warp * kFramesPerWarp + q;
    const int t = t0 + tl;
    if (t >= num_frames) break;  // warp-uniform
    const float* xs = s_audio + tl * step;

    const float2* in = nullptr;   // nullptr: the first pass reads xs
    float2* outb = buf0;
    int p = 1;
    for (unsigned long long rest = plan; rest != 0; rest >>= 4) {
      const int R = (int)(rest & 15);
      if constexpr (!kMixed) {
        if (R == 4)
          stockham_pass<4, true>(in, xs, s_win, outb, s_tw, M, N, p, lane);
        else
          stockham_pass<2, true>(in, xs, s_win, outb, s_tw, M, N, p, lane);
      } else {
        switch (R) {  // warp-uniform
          case 4:
            stockham_pass<4, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                    lane);
            break;
          case 2:
            stockham_pass<2, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                    lane);
            break;
          case 3:
            stockham_pass<3, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                    lane);
            break;
          case 5:
            stockham_pass<5, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                    lane);
            break;
          case 7:
            stockham_pass<7, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                    lane);
            break;
          default:
            stockham_pass<11, false>(in, xs, s_win, outb, s_tw, M, N, p,
                                     lane);
            break;
        }
      }
      __syncwarp();
      in = outb;
      outb = outb == buf0 ? buf1 : buf0;
      p *= R;
    }

    // real split: X[k] = (E - i W_N^k O) / 2 for 0 < k < M
    float* dst = out + (row * num_frames + t) * bins;
    for (int k = lane + 1; k < M; k += 32) {
      const float2 a = in[pad16(k)];
      const float2 zb = in[pad16(M - k)];
      const float2 e = make_float2(a.x + zb.x, a.y - zb.y);
      const float2 o = make_float2(a.x - zb.x, a.y + zb.y);
      const float2 w = s_tw[k];
      const float2 wo = cmul(o, w);
      const float xr = 0.5f * (e.x + wo.y);
      const float xi = 0.5f * (e.y - wo.x);
      const float amp = sqrtf(xr * xr + xi * xi);
      dst[k] = logf(amp + epsilon) * inv_normalizer;
    }
    __syncwarp();  // the next frame's passes overwrite both buffers
  }
}

// Bytes of dynamic shared memory one block of the FFT route needs.
long long fft_smem_bytes(int frame, int step) {
  return (long long)frame * 24 +
         (long long)fft_span_floats(frame, step) * 4 +
         (long long)kWarps * 2 * padded_points(frame / 2) * 8;
}

// The Stockham passes of an M-point FFT (ops/stft_kernel.fft_radices):
// radix 4 while two factors of 2 are left, then one radix 2, then radix 3,
// 5, 7 and 11, 4 bits a pass with the first pass lowest; 0 when M has
// another prime factor.
unsigned long long fft_plan(int m) {
  if (m < 2) return 0;
  unsigned long long plan = 0;
  int shift = 0;
  auto take = [&](int r) {
    plan |= (unsigned long long)r << shift;
    shift += 4;
    m /= r;
  };
  while (m % 4 == 0) take(4);
  if (m % 2 == 0) take(2);
  static const int kOdd[] = {3, 5, 7, 11};
  for (const int r : kOdd)
    while (m % r == 0) take(r);
  return m == 1 ? plan : 0;
}

// The frames the FFT route takes (ops/stft_kernel.fft_route): even, from
// 16 to 1024, with M = N / 2 factoring over 2, 3, 5, 7 and 11.
bool fft_frame_ok(int frame) {
  return frame >= kFftMinFrame && frame <= kFftMaxFrame && frame % 2 == 0 &&
         fft_plan(frame / 2) != 0;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the DFT route needs.
long long abcd_log_spectrogram_smem_bytes(int frame, int step) {
  return (long long)(2 * frame * kBins + (kFrames - 1) * step + frame) *
         (long long)sizeof(float);
}

// DFT route.  audio (batch, row_len) f32, cos_b/sin_b (frame, bins) f32
// with the window folded in, out (batch, num_frames, bins) f32.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int abcd_log_spectrogram(const float* audio, long long row_len,
                         const float* cos_b, const float* sin_b, float* out,
                         int batch, int frame, int step, int num_frames,
                         int bins, float epsilon, float inv_normalizer,
                         void* stream) {
  const int smem = (int)abcd_log_spectrogram_smem_bytes(frame, step);
  cudaError_t err = cudaFuncSetAttribute(
      log_spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((bins + kBins - 1) / kBins,
                  (num_frames + kFrames - 1) / kFrames, batch);
  const dim3 block(kBins, kWarps);
  log_spectrogram_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      audio, row_len, cos_b, sin_b, out, frame, step, num_frames, bins,
      epsilon, inv_normalizer);
  return (int)cudaGetLastError();
}

// FFT route: the same arguments and twiddle (frame,) complex64 W_N^j (the
// window is read from column 0 of cos_b; columns 0 and M of the basis give
// the real bins).  The radix-4/2 instance for a power-of-two M, the
// mixed-radix one otherwise.  cudaErrorInvalidValue for a frame the route
// does not take.
int abcd_log_spectrogram_fft(const float* audio, long long row_len,
                             const float* cos_b, const float* sin_b,
                             const float* twiddle, float* out, int batch,
                             int frame, int step,
                             int num_frames, int bins, float epsilon,
                             float inv_normalizer, void* stream) {
  if (!fft_frame_ok(frame) || bins != frame / 2 + 1)
    return (int)cudaErrorInvalidValue;
  const int m = frame / 2;
  const bool mixed = (m & (m - 1)) != 0;
  auto kernel = mixed ? log_spectrogram_fft_kernel<true>
                      : log_spectrogram_fft_kernel<false>;
  const int smem = (int)fft_smem_bytes(frame, step);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_frames + kFrames - 1) / kFrames, batch);
  const float2* tw = reinterpret_cast<const float2*>(twiddle);
  kernel<<<grid, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      audio, row_len, cos_b, sin_b, tw, out, frame, step, num_frames, bins,
      fft_plan(m), epsilon, inv_normalizer);
  return (int)cudaGetLastError();
}

const char* abcd_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
