// Fused log-mel: window + DFT + power + mel filterbank + log.
//
// Replaces: trt_asr_tpu/ops/pallas/mel_kernel.py:logmel_from_frames_pallas.
//   out[t, m] = log(sum_k ((f[t] . wcos[:, k])^2 + (f[t] . wsin[:, k])^2) * mel[k, m] + floor)
// with the Hann window folded into wcos/wsin [win, bins].
//
// Bound on the H100: neither bytes nor operations at streaming shapes. A
// 0.5 s push is T ~ 50 frames: 80 KB of frames, 0.8 MB of DFT basis (read
// from L2 by every block) and ~22 MFLOP, so the kernel is latency-bound.
// Design: one block per tile of MEL_TILE frames; the frames tile, the
// partial DFT sums and the power spectrum stay in shared memory (the
// spectrum never reaches device memory). Both products are split over
// their contraction so that no thread walks a long chain of dependent
// loads (the block is latency-bound): the window over MEL_NSPLIT thread
// groups, each thread owning one DFT bin of one group's share; then the
// bins over blockDim / n_mels groups, each thread owning one mel column
// for the tile's frames. Group sums are added in a fixed order.
#include "common.cuh"

namespace port {

constexpr int MEL_TILE = 4;
constexpr int MEL_BINS = 288;      // >= 257 bins: one bin per thread of a group
constexpr int MEL_NSPLIT = 3;
constexpr int MEL_THREADS = MEL_BINS * MEL_NSPLIT;

__global__ void __launch_bounds__(MEL_THREADS)
logmel_kernel(const float* __restrict__ frames, int T, int win,
              const float* __restrict__ wcos, const float* __restrict__ wsin, int nb,
              const float* __restrict__ mel, int nm, float log_floor,
              float* __restrict__ out) {
  extern __shared__ float sm[];
  float* f_s = sm;                                  // [MEL_TILE][win]
  float* p_s = f_s + MEL_TILE * win;                // [MEL_TILE][nb] power
  float* re_s = p_s + MEL_TILE * nb;                // [MEL_NSPLIT][MEL_TILE][nb]
  float* im_s = re_s + MEL_NSPLIT * MEL_TILE * nb;  // [MEL_NSPLIT][MEL_TILE][nb]
  float* q_s = re_s;                                // [G][MEL_TILE][nm] mel partials,
                                                    // after the DFT partials are used
  const int t0 = blockIdx.x * MEL_TILE;
  const int nt = min(MEL_TILE, T - t0);
  for (int i = threadIdx.x; i < MEL_TILE * win; i += blockDim.x) {
    const int r = i / win, c = i - r * win;
    f_s[i] = r < nt ? frames[(size_t)(t0 + r) * win + c] : 0.f;
  }
  __syncthreads();

  // DFT: thread (g, k) sums window samples [n0, n1) for bin k
  const int g = threadIdx.x / MEL_BINS;
  const int chunk = (win + MEL_NSPLIT - 1) / MEL_NSPLIT;
  const int n0 = g * chunk, n1 = min(win, n0 + chunk);
  for (int k = threadIdx.x - g * MEL_BINS; k < nb; k += MEL_BINS) {
    float re[MEL_TILE], im[MEL_TILE];
#pragma unroll
    for (int r = 0; r < MEL_TILE; ++r) re[r] = im[r] = 0.f;
#pragma unroll 8
    for (int n = n0; n < n1; ++n) {
      const float c = wcos[(size_t)n * nb + k], s = wsin[(size_t)n * nb + k];
#pragma unroll
      for (int r = 0; r < MEL_TILE; ++r) {
        re[r] = fmaf(f_s[r * win + n], c, re[r]);
        im[r] = fmaf(f_s[r * win + n], s, im[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < MEL_TILE; ++r) {
      re_s[(g * MEL_TILE + r) * nb + k] = re[r];
      im_s[(g * MEL_TILE + r) * nb + k] = im[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MEL_TILE * nb; i += blockDim.x) {
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int gg = 0; gg < MEL_NSPLIT; ++gg) {
      re += re_s[gg * MEL_TILE * nb + i];
      im += im_s[gg * MEL_TILE * nb + i];
    }
    p_s[i] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
  __syncthreads();

  // mel: thread (h, m) sums bins [k0, k1) of mel column m for every frame
  const int G = blockDim.x / nm;
  const int h = threadIdx.x / nm, m = threadIdx.x - h * nm;
  if (h < G) {
    const int kc = (nb + G - 1) / G;
    const int k0 = h * kc, k1 = min(nb, k0 + kc);
    float acc[MEL_TILE];
#pragma unroll
    for (int r = 0; r < MEL_TILE; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float w = mel[(size_t)k * nm + m];
#pragma unroll
      for (int r = 0; r < MEL_TILE; ++r) acc[r] = fmaf(p_s[r * nb + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MEL_TILE; ++r) q_s[(h * MEL_TILE + r) * nm + m] = acc[r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nt * nm; i += blockDim.x) {
    float acc = 0.f;
    for (int hh = 0; hh < G; ++hh) acc += q_s[hh * MEL_TILE * nm + i];
    out[(size_t)t0 * nm + i] = logf(acc + log_floor);
  }
}

}  // namespace port

using namespace port;

// frames [T, win], wcos/wsin [win, nb], mel [nb, nm] (all f32) -> out [T, nm].
extern "C" int logmel_launch(const float* frames, int T, int win, const float* wcos,
                             const float* wsin, int nb, const float* mel, int nm,
                             float log_floor, float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (T < 1) return 0;
  // the mel partials [blockDim / nm][MEL_TILE][nm] reuse the DFT partials
  if (nm > MEL_THREADS || MEL_THREADS * MEL_TILE > 2 * MEL_NSPLIT * MEL_TILE * nb)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)MEL_TILE * (win + nb + 2 * MEL_NSPLIT * nb);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  logmel_kernel<<<(T + MEL_TILE - 1) / MEL_TILE, MEL_THREADS, smem, stream>>>(
      frames, T, win, wcos, wsin, nb, mel, nm, log_floor, out);
  return (int)cudaGetLastError();
}
