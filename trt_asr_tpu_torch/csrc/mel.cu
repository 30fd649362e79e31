// Fused log-mel: window + DFT + power + mel filterbank + log, spread over
// the card in clusters of 16 blocks.
//
// Replaces: trt_asr_tpu/ops/pallas/mel_kernel.py:logmel_from_frames_pallas
// (its pallas_call at :65).
//   out[t, m] = log(sum_k ((f[t] . wcos[:, k])^2 + (f[t] . wsin[:, k])^2) * mel[k, m] + floor)
// with the Hann window folded into wcos/wsin [win, bins].
//
// Bound on the H100: neither bytes nor operations at streaming shapes. A
// 0.5 s push is T ~ 50 frames: 80 KB of frames, 0.8 MB of DFT basis and
// 0.1 MB of filterbank, ~22 MFLOP: 0.36 us at the f32 peak. The kernel is
// latency-bound, so its design spreads the work over the SMs and keeps
// every intermediate on chip.
//
// Design. One launch of (MEL_CL, frame tiles) blocks in clusters of MEL_CL
// = 16 (a non-portable cluster size): cluster ft takes frames ft * MEL_FT
// .. + MEL_FT, and its block b the b-th sixteenth of the DFT bins, bt =
// ceil(bins / 16) of them (17 at 257 bins: 16 x 7 = 112 blocks at T 50, on
// 132 SMs). A block stages its frames (zero past T), its bins' columns of
// both bases (packed once, a bin tile's contiguous and zero past the bins:
// ops/kernels/mel.py:pack_logmel_basis) and its bins' rows of the
// filterbank (zero past the bins) in shared memory, all by cp.async; then
//   (1) the DFT: thread (k, s) sums bin k over the s-th of MEL_KS runs of
//       the window, K in order (FMAs), for all the tile's frames, cos and
//       sin; the runs' sums added in order, then the power re^2 + im^2;
//   (2) the partial mel sums of its bins, bins in order, into its shared
//       memory; cluster barrier;
//   (3) block b reads the 16 blocks' partial sums of its sixteenth of the
//       mel bands out of their shared memory (distributed shared memory),
//       adds them in block order and takes the log; cluster barrier (no
//       block leaves while another reads its partials).
// Neither the spectrum nor the partial sums reach device memory. Every sum
// runs in a fixed order (no atomics): the kernel is deterministic and a
// captured CUDA graph replays it bit for bit (chip_smoke.py phase 2).
#include <cooperative_groups.h>

#include "common.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int MEL_CL = 16;                 // blocks a cluster: bin tiles of a frame tile
constexpr int MEL_FT = 8;                  // frames a tile
constexpr int MEL_KS = 20;                 // runs of the window a bin's sum is split into
constexpr int MEL_MAX_BT = 17;             // bins a tile at most (257 bins: n_fft 512)
constexpr int MEL_THREADS = (MEL_MAX_BT * MEL_KS + 31) / 32 * 32;

// Pitch of a basis row in shared memory: bt rounded up to a multiple of 4,
// and an odd number of 4-float steps, so that the two runs of the window in
// a warp (5 float4 steps apart at win 400) fall 16 banks apart
__host__ __device__ inline int mel_pitch(int bt) {
  const int p = (bt + 3) / 4 * 4;
  return p % 8 ? p : p + 4;
}

// Float offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct MelSmem {
  size_t fr, cs, ss, ml, red, pw, part, total;
};

__host__ __device__ inline MelSmem mel_smem(int win, int bt, int nm) {
  const size_t bp = mel_pitch(bt);
  MelSmem s;
  size_t o = 0;
  s.fr = o;   o += (size_t)MEL_FT * (win + 4);               // the tile's frames
  s.cs = o;   o += (size_t)win * bp;                         // its bins' cos columns
  s.ss = o;   o += (size_t)win * bp;                         // ... and sin columns
  s.ml = o;   o += (size_t)bt * nm;                          // its bins' filterbank rows
  s.red = o;  o += (size_t)2 * MEL_KS * MEL_FT * bt;         // the runs' sums, re then im
  s.pw = o;   o += (size_t)MEL_FT * bt;                      // the power
  s.part = o; o += (size_t)MEL_FT * nm;                      // its partial mel sums
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(MEL_THREADS)
logmel_kernel(const float* __restrict__ frames, int T, int win, const float* __restrict__ basis,
              int nb, const float* __restrict__ mel, int nm, float log_floor,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank(), ft = blockIdx.y;
  const int bt = (nb + MEL_CL - 1) / MEL_CL, bp = mel_pitch(bt);
  const MelSmem L = mel_smem(win, bt, nm);
  float *fr = sm + L.fr, *cs = sm + L.cs, *ss = sm + L.ss, *ml = sm + L.ml;
  float *red = sm + L.red, *pw = sm + L.pw, *part = sm + L.part;
  const int t0 = ft * MEL_FT, nt = min(MEL_FT, T - t0), k0 = b * bt;
  const int fp = win + 4, w4 = win / 4, m4 = nm / 4;

  // the tile's frames, its bins' basis columns and filterbank rows
  for (int i = threadIdx.x; i < MEL_FT * w4; i += MEL_THREADS) {
    const int r = i / w4, c = 4 * (i - r * w4);
    const bool in = r < nt;
    cp_async<16>(fr + r * fp + c, frames + (size_t)(in ? t0 + r : 0) * win + c, in ? 16 : 0);
  }
  const float* bb = basis + (size_t)b * 2 * win * bp;        // the tile's cos, then sin
  for (int i = 4 * threadIdx.x; i < 2 * win * bp; i += 4 * MEL_THREADS)
    cp_async<16>(cs + i, bb + i, 16);
  for (int i = threadIdx.x; i < bt * m4; i += MEL_THREADS) {
    const int k = i / m4, c = 4 * (i - k * m4);
    const bool in = k0 + k < nb;
    cp_async<16>(ml + k * nm + c, mel + (size_t)(in ? k0 + k : 0) * nm + c, in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // (1) the DFT of bin k over the s-th run of the window, every frame
  if (threadIdx.x < bt * MEL_KS) {
    const int k = threadIdx.x % bt, s = threadIdx.x / bt;
    const int per = (w4 + MEL_KS - 1) / MEL_KS, q0 = min(w4, s * per), q1 = min(w4, q0 + per);
    float re[MEL_FT], im[MEL_FT];
#pragma unroll
    for (int r = 0; r < MEL_FT; ++r) re[r] = im[r] = 0.f;
    for (int q = q0; q < q1; ++q) {
      float4 x[MEL_FT];
#pragma unroll
      for (int r = 0; r < MEL_FT; ++r) x[r] = *reinterpret_cast<const float4*>(fr + r * fp + 4 * q);
      const float* c = cs + 4 * q * bp + k;
      const float* sn = ss + 4 * q * bp + k;
      const float c0 = c[0], c1 = c[bp], c2 = c[2 * bp], c3 = c[3 * bp];
      const float s0 = sn[0], s1 = sn[bp], s2 = sn[2 * bp], s3 = sn[3 * bp];
#pragma unroll
      for (int r = 0; r < MEL_FT; ++r) {
        re[r] = fmaf(x[r].w, c3, fmaf(x[r].z, c2, fmaf(x[r].y, c1, fmaf(x[r].x, c0, re[r]))));
        im[r] = fmaf(x[r].w, s3, fmaf(x[r].z, s2, fmaf(x[r].y, s1, fmaf(x[r].x, s0, im[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < MEL_FT; ++r) {
      red[(s * MEL_FT + r) * bt + k] = re[r];
      red[((MEL_KS + s) * MEL_FT + r) * bt + k] = im[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MEL_FT * bt; i += MEL_THREADS) {
    float a = 0.f, c = 0.f;
    for (int u = 0; u < MEL_KS; ++u) {
      a = __fadd_rn(a, red[u * MEL_FT * bt + i]);
      c = __fadd_rn(c, red[(MEL_KS + u) * MEL_FT * bt + i]);
    }
    pw[i] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c));
  }
  __syncthreads();

  // (2) the partial mel sums of the tile's bins, bins in order: thread
  // (m, h) takes band m of frames 4h .. 4h + 3
  for (int i = threadIdx.x; i < 2 * nm; i += MEL_THREADS) {
    const int h = i / nm, m = i - h * nm;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < MEL_MAX_BT; ++kk) {
      if (kk < bt) {
        const float w = ml[kk * nm + m];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(pw[(4 * h + j) * bt + kk], w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * h + j < nt) part[(4 * h + j) * nm + m] = acc[j];
  }
  cluster.sync();

  // (3) this block's sixteenth of the mel bands: the cluster's partials
  // added in block order, then the log
  const int cm = (nm + MEL_CL - 1) / MEL_CL, m0 = b * cm, mc = max(0, min(cm, nm - m0));
  for (int i = threadIdx.x; i < nt * mc; i += MEL_THREADS) {
    const int r = i / mc, o = r * nm + m0 + i - r * mc;
    float v[MEL_CL];
#pragma unroll
    for (int j = 0; j < MEL_CL; ++j) v[j] = cluster.map_shared_rank(part, j)[o];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < MEL_CL; ++j) acc = __fadd_rn(acc, v[j]);
    out[(size_t)t0 * nm + o] = logf(acc + log_floor);
  }
  cluster.sync();
}

}  // namespace port

using namespace port;

static int mel_smem_set = -1;        // the kernel's dynamic shared memory limit, as set

// frames [T, win] (16-byte aligned, win a multiple of 4), basis: the
// window-folded DFT bases [MEL_CL][2 (cos, sin)][win][mel_pitch(bt)] with
// bt = ceil(nb / MEL_CL) bins a tile (16-byte aligned, zero past nb bins
// and in each row's pad), mel [nb, nm] (16-byte aligned, nm a multiple of
// 4), all f32 -> out [T, nm]. The plan (frame tiles ft <= 65535, smem:
// dynamic shared bytes) comes from the wrapper and is checked against this
// file's layout. Returns the CUDA error code (a cluster of 16 blocks that
// cannot be placed is a launch error).
extern "C" int logmel_launch(const float* frames, int T, int win, const float* basis, int nb,
                             const float* mel, int nm, float log_floor, int ft, int smem,
                             float* out, void* stream_ptr) {
  const int bt = (nb + MEL_CL - 1) / MEL_CL;
  if (T < 1 || win < 4 || win % 4 || nb < 1 || bt > MEL_MAX_BT || nm < 4 || nm % 4 ||
      ft != (T + MEL_FT - 1) / MEL_FT || ft > 65535 ||
      mel_smem(win, bt, nm).total * 4 != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != mel_smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    mel_smem_set = err == cudaSuccess ? smem : -1;
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(MEL_CL, ft);
  cfg.blockDim = dim3(MEL_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream_ptr;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = MEL_CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, logmel_kernel, frames, T, win, basis, nb, mel, nm, log_floor, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
