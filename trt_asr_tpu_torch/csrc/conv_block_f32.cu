// Fused conformer conv module with f32 weights (B=1 streaming chunks): one
// persistent cooperative launch a call.
//
// Replaces: trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas
// (its pallas_call at :99) with f32 weights; int8 weights take
// csrc/conv_block_q8.cu, bf16 weights the chain of csrc/conv_block.cu. For
// the Tq rows x of one layer:
//   u = LN(x); hw = u @ pw1 (D -> 2D); c = hw[:, :D] * sigmoid(hw[:, D:]) * mask
//   ext = tc ((K-1)/2 rows) ++ c ++ 0; cv[t] = sum_j ext[t + j] * dw[j]
//   a = silu((cv - m) * g * rsqrt(v + 1e-5) + b); y = x + a @ pw2
// and returns (y, c), c being the rows that feed the time cache. Everything
// is f32: nothing is rounded, and the products run on the CUDA cores (FFMA,
// no TF32: the f32 policy).
//
// Bound on the H100: memory. At a steady chunk's Tq 8 (D 1024, a 9-tap
// conv) a call reads 12.6 MB of f32 weights: 3.8 us at 3.35 TB/s, against
// 50 MFLOP (0.75 us at the f32 peak).
//
// Design. The split of csrc/conv_tail.cuh's phases (a)-(c) (the int8
// kernel's): one cooperative launch, one block an SM, 512 threads; block b
// owns cD columns of pw1 (n and its GLU gate n + D) and of pw2 over the
// whole K (cD 8, 128 blocks at full width; the wrapper's plan,
// ops/kernels/conv_block.py:conv_block_f32_plan), and
//   (a) u = LN(x) of the pass's rows, in place (every block, one warp a
//       row), x on the block's columns kept for the residual;
//   (b) pw1 on its GLU pairs, GLU, mask, c; after all passes the taps over
//       [time cache ++ c ++ 0], BN and SiLU, column-local (the conv mixes
//       rows, not columns): its columns of a to scratch [Tq, D];
//   one grid barrier;
//   (c) all of a's rows out of L2, its cD columns of a @ pw2, plus x -> y.
// No split-K: no partial sums reach device memory. A block's f32 slice (64
// KB of pw1, 32 KB of pw2 at full width) lies whole in shared memory, cut
// in pieces of CF_RUN rows of K, each on its own mbarrier:
//   Packed layout (ops/kernels/conv_block.py:pack_conv_block), a block's
//   slice contiguous: R = ceil(D / CF_RUN) pw1 pieces, piece r the K rows
//   [CF_RUN r, CF_RUN (r + 1)) as [CF_RUN / 4][2 cD][4] (a column's four
//   consecutive K values in one float4, the cD columns n, then their gates
//   n + D), then R pw2 pieces [CF_RUN / 4][cD][4], then the taps [kk][cD]
//   and BN g, b, m, v [4][cD]; zero past D and K.
// Copies, with what was seen on the H100: thread 0 issues x's rows,
// the norms, the taps and BN first (behind the weight pieces x's rows
// landed ~7 us late), then the pw1 pieces, at entry; once a pw1 piece has
// landed, the warp that sums it issues the pw2 piece of the same run
// (issued together, the two shared the memory's rate and pw1 landed ~1 us
// later); each weight piece under an L2 evict-first policy (weights read
// once). After the barrier lane 0 of each warp bulk-copies the 8 rows of
// its run of K of a out of L2 (fenced, never through a possibly stale L1
// line) as one copy: the scratch lies run by run (cf_a_at).
// Sums: warp w sums the pieces w, w + 16, ... for all 8 rows of a pass and
// the piece's columns (lane l a column and 4 rows (pw1) or 2 (pw2), K in
// order, FMAs: one weight float4 and a broadcast operand float4 a row a
// step); the pieces' sums are added in order. The sums run in another
// order than the plain version's cuBLAS products (f32 ulps apart); every
// sum runs in a fixed order (no atomics): the kernel is deterministic, and
// a captured CUDA graph replays it bit for bit (chip_smoke.py phase 2).
// Rows are taken 8 at a time, so any Tq runs; the weights stay in shared
// memory across passes. With TAIL_TIMELINE defined, thread 0 of each block
// records the phases (tail_variants.py --conv --f32).
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int CF_RUN = 64;                // K rows of a piece
constexpr int CF_ROWS1 = 4;               // rows a lane sums of a pw1 piece
constexpr int CF_ROWS2 = 2;               // of a pw2 piece

__host__ __device__ inline int cf_runs(int D) { return (D + CF_RUN - 1) / CF_RUN; }

// A block's packed slice, in floats: the R pw1 pieces at 0, the R pw2
// pieces at pw2, the taps and BN at cols
struct CfBlob {
  size_t pw2, cols, total;
};

__host__ __device__ inline CfBlob cf_blob(int D, int kk, int cD) {
  const size_t R = cf_runs(D);
  CfBlob b;
  b.pw2 = R * CF_RUN * 2 * cD;
  b.cols = b.pw2 + R * CF_RUN * cD;
  b.total = b.cols + (size_t)(kk + 4) * cD;
  return b;
}

// mbarriers: one a pw1 piece, a pw2 piece, a run of a's rows; x's rows
__host__ __device__ inline int cf_bars(int D) { return 3 * cf_runs(D) + 1; }

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
struct CfSmem {
  size_t w, xs, as, norms, red, xc, mask, ext, bars, total;
};

__host__ __device__ inline CfSmem cf_smem(int M, int D, int kk, int cD) {
  const size_t R = cf_runs(D), rows = (size_t)TL_MR * R * CF_RUN * 4;
  CfSmem s;
  size_t o = 0;
  s.w = o;     o += cf_blob(D, kk, cD).total * 4;                  // the block's slice
  s.xs = o;    o += rows;                                          // x's rows, then u's
  s.as = o;    o += rows;                                          // a's rows, [R][8][CF_RUN]
  s.norms = o; o += (size_t)2 * D * 4;                             // LN's g, b
  s.red = o;   o += R * TL_MR * 2 * cD * 4;                        // the pieces' sums
  s.xc = o;    o += tail_align((size_t)M * cD * 4);                // x on the block's columns
  s.mask = o;  o += tail_align((size_t)M * 4);
  s.ext = o;   o += tail_align((size_t)(M + kk - 1) * cD * 4);     // conv rows
  s.bars = o;  o += (size_t)cf_bars(D) * 8;
  s.total = o;
  return s;
}

struct CfArgs {
  const float* x;
  int M, D, kk, cD;
  const float *ln_g, *ln_b, *tc, *mask;
  const float* packed;                    // [blocks][cf_blob floats]
  float *y, *c;
  float* a;                               // scratch: [passes][R][8][CF_RUN], see cf_a_at
};

// Thread 0: mr rows of x (row pitch D) into rows of pitch Kp, on bar
// (whose bytes the caller expects)
__device__ __forceinline__ void cf_rows(float* dst, int Kp, const float* src, int mr, int D,
                                        uint64_t* bar) {
  if (Kp == D) {                            // the rows are contiguous both sides
    bulk_copy(dst, src, mr * D * 4, bar);
    return;
  }
  for (int t = 0; t < mr; ++t) bulk_copy(dst + (size_t)t * Kp, src + (size_t)t * D, D * 4, bar);
}

// One thread: the block's piece of `floats` floats at `off` of its slice
// into the same place of shared memory, under an L2 evict-first policy
__device__ __forceinline__ void cf_issue(float* w, const float* mine, size_t off, int floats,
                                         uint64_t* bar) {
  mbar_expect(bar, floats * 4);
  bulk_copy_hint(w + off, mine + off, floats * 4, bar, evict_first());
}

// A warp's sums of a piece: the 8 rows of `rows` (the piece's CF_RUN
// values of K of each, row pitch `pitch`) times the piece's C columns (w:
// [CF_RUN / 4][C][4]), into out [8][C]. Item i: column i % C of the RG
// rows from RG (i / C); lane l takes items l, l + 32, ..., K in order
// (FMAs).
template <int RG>
__device__ __forceinline__ void cf_sums(const float* rows, int pitch, const float* w, int C,
                                        float* out) {
  for (int i = threadIdx.x & 31; i < (TL_MR / RG) * C; i += 32) {
    const int j = i % C, t0 = (i / C) * RG;
    const float* wc = w + (size_t)j * 4;
    const float* xr = rows + (size_t)t0 * pitch;
    float acc[RG];
#pragma unroll
    for (int t = 0; t < RG; ++t) acc[t] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < CF_RUN / 4; ++k4) {
      const float4 v = *reinterpret_cast<const float4*>(wc + (size_t)k4 * C * 4);
#pragma unroll
      for (int t = 0; t < RG; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(xr + (size_t)t * pitch + 4 * k4);
        acc[t] = fmaf(a.w, v.w, fmaf(a.z, v.z, fmaf(a.y, v.y, fmaf(a.x, v.x, acc[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < RG; ++t) out[(size_t)(t0 + t) * C + j] = acc[t];
  }
}

// Row t, column j of R pieces' sums (red [R][8][C]), added in order
__device__ __forceinline__ float cf_total(const float* red, int R, int C, int t, int j) {
  float v = red[(size_t)t * C + j];
  for (int r = 1; r < R; ++r) v = __fadd_rn(v, red[((size_t)r * TL_MR + t) * C + j]);
  return v;
}

// Where a's row t, column n lies in the scratch: [pass][run][8][CF_RUN], a
// pass's 8 rows of a run of K contiguous, so that one bulk copy fetches
// them (in place of 8 row copies: 0.3-0.4 us less from the barrier to
// pw2's sums)
__device__ __forceinline__ size_t cf_a_at(int t, int n, int R) {
  return (((size_t)(t / TL_MR) * R + n / CF_RUN) * TL_MR + t % TL_MR) * CF_RUN + n % CF_RUN;
}

// Item i of the block's columns of the time cache ([(kk - 1) / 2][cD]),
// zero past D
__device__ __forceinline__ float cf_tc(const CfArgs& p, int i, int n0) {
  const int r = i / p.cD, n = n0 + i - r * p.cD;
  return n < p.D ? p.tc[(size_t)r * p.D + n] : 0.f;
}

__global__ void __launch_bounds__(TL_THREADS, 1) conv_block_f32_kernel(CfArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, kk = p.kk, cD = p.cD, R = cf_runs(D), Kp = R * CF_RUN;
  const CfSmem L = cf_smem(M, D, kk, cD);
  const CfBlob B = cf_blob(D, kk, cD);
  float* w = reinterpret_cast<float*>(smem + L.w);
  const float* dw = w + B.cols;                               // [kk][cD]
  const float* bn = dw + kk * cD;                             // [4][cD]: g, b, m, v
  float* xs = reinterpret_cast<float*>(smem + L.xs);          // [8][Kp]
  float* as = reinterpret_cast<float*>(smem + L.as);          // [R][8][CF_RUN]
  float* norms = reinterpret_cast<float*>(smem + L.norms);    // [2][D]
  float* red = reinterpret_cast<float*>(smem + L.red);        // [R][8][2 cD] or [R][8][cD]
  float* xc = reinterpret_cast<float*>(smem + L.xc);          // [M][cD]
  float* mask = reinterpret_cast<float*>(smem + L.mask);
  float* ext = reinterpret_cast<float*>(smem + L.ext);        // [M + kk - 1][cD]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* bar_x = bars + 3 * R;
  const float* mine = p.packed + (size_t)blockIdx.x * B.total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * cD, half = (kk - 1) / 2, c1 = 2 * cD;
  const int piece1 = CF_RUN * c1, piece2 = CF_RUN * cD;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  // This thread's value of the block's columns of the time cache and of the
  // mask: plain loads issued now, ahead of the weight stream, and stored to
  // shared memory after the first LN (issued behind the stream they landed
  // ~5 us late, holding up the block)
  const int ti = threadIdx.x;
  const float tc0 = ti < half * cD ? cf_tc(p, ti, n0) : 0.f;
  const float mask0 = ti < M ? p.mask[ti] : 0.f;

  // Thread 0: x's first rows, the norms, the taps and BN, ahead of the
  // weights in the copy engine's queue
  if (threadIdx.x == 0) {
    for (int i = 0; i < cf_bars(D); ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int mr = min(TL_MR, M), cb = (int)(B.total - B.cols) * 4;
    mbar_expect(bar_x, (uint32_t)((mr + 2) * D * 4 + cb));
    cf_rows(xs, Kp, p.x, mr, D, bar_x);
    bulk_copy(norms, p.ln_g, D * 4, bar_x);
    bulk_copy(norms + D, p.ln_b, D * 4, bar_x);
    bulk_copy(w + B.cols, mine + B.cols, cb, bar_x);
  }
  __syncthreads();                          // the mbarriers are ready
  // lane 0 of each warp: its pw1 pieces (issued once the time cache's
  // loads had landed they left at 2.7 us)
  if (lane == 0)
    for (int r = warp; r < R; r += TL_WARPS) cf_issue(w, mine, (size_t)r * piece1, piece1, bars + r);
  // x's rows' columns [D, Kp) meet the weights' zero rows past K; the zeros
  // past the conv's rows
  for (int i = threadIdx.x; i < TL_MR * (Kp - D); i += TL_THREADS)
    xs[(size_t)(i / (Kp - D)) * Kp + D + i % (Kp - D)] = 0.f;
  for (int i = threadIdx.x; i < half * cD; i += TL_THREADS) ext[(half + M) * cD + i] = 0.f;
  TL_MARK(1);

  // (a, b) c = GLU(LN(x) @ pw1) * mask, 8 rows a pass
  for (int m0 = 0, pass = 0; m0 < M; m0 += TL_MR, ++pass) {
    const int mr = min(TL_MR, M - m0);
    if (pass > 0 && threadIdx.x == 0) {
      // the previous pass read xs before the block barrier that ended it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(bar_x, (uint32_t)(mr * D * 4));
      cf_rows(xs, Kp, p.x + (size_t)m0 * D, mr, D, bar_x);
    }
    mbar_wait(bar_x, pass & 1);
    TL_MARK(2);
    // x on the block's columns, the residual of (c), kept before LN
    // overwrites the rows
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int t = i / cD, n = n0 + i - t * cD;
      xc[(size_t)m0 * cD + i] = n < D ? xs[(size_t)t * Kp + n] : 0.f;
    }
    __syncthreads();
    ln_rows_f32(xs, Kp, mr, D, norms, norms + D, nullptr);
    if (pass == 0) {                        // the values loaded at entry
      for (int i = ti; i < half * cD; i += TL_THREADS) ext[i] = i == ti ? tc0 : cf_tc(p, i, n0);
      for (int i = ti; i < M; i += TL_THREADS) mask[i] = i == ti ? mask0 : p.mask[i];
    }
    __syncthreads();
    TL_MARK(3);
    // pw1's sums, a piece as it lands; once it has, the warp issues the
    // pw2 piece of the same run
    for (int r = warp; r < R; r += TL_WARPS) {
      mbar_wait(bars + r);
      if (pass == 0 && lane == 0)
        cf_issue(w, mine, B.pw2 + (size_t)r * piece2, piece2, bars + R + r);
      cf_sums<CF_ROWS1>(xs + r * CF_RUN, Kp, w + (size_t)r * piece1, c1,
                        red + (size_t)r * TL_MR * c1);
    }
    TL_MARK(17);
    __syncthreads();
    TL_MARK(4);
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int t = i / cD, j = i - t * cD, n = n0 + j;
      float v = 0.f;
      if (n < D) {
        const float hv = cf_total(red, R, c1, t, j), gate = cf_total(red, R, c1, t, cD + j);
        v = __fmul_rn(__fmul_rn(hv, sigmoid_f(gate)), mask[m0 + t]);
        p.c[(size_t)(m0 + t) * D + n] = v;
      }
      ext[(half + m0 + t) * cD + j] = v;
    }
    __syncthreads();
  }
  // the depthwise taps, BN and SiLU on the block's columns: a
  for (int i = threadIdx.x; i < M * cD; i += TL_THREADS) {
    const int t = i / cD, j = i - t * cD, n = n0 + j;
    if (n >= D) continue;
    const float bscale = __fmul_rn(bn[j], rsqrtf(bn[3 * cD + j] + 1e-5f));
    float cv = __fmul_rn(ext[t * cD + j], dw[j]);
    for (int q = 1; q < kk; ++q)
      cv = __fadd_rn(cv, __fmul_rn(ext[(t + q) * cD + j], dw[q * cD + j]));
    cv = __fadd_rn(__fmul_rn(__fsub_rn(cv, bn[2 * cD + j]), bscale), bn[cD + j]);
    p.a[cf_a_at(t, n, R)] = silu_f(cv);
  }
  TL_MARK(5);
  grid.sync();
  TL_MARK(6);

  // (c) y = x + a @ pw2 on the block's columns, 8 rows a pass: lane 0 of a
  // warp copies the pass's 8 rows of its run of K of a (written by every
  // block; as [R][8][CF_RUN]) out of L2 in one piece
  for (int m0 = 0, pass = 0; m0 < M; m0 += TL_MR, ++pass) {
    const int mr = min(TL_MR, M - m0);
    for (int r = warp; r < R; r += TL_WARPS) {
      float* ar = as + (size_t)r * TL_MR * CF_RUN;
      if (lane == 0) {
        // the previous pass read as before the block barrier that ended it
        if (pass > 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_rows(ar, 0, p.a + cf_a_at(m0, r * CF_RUN, R), 0, 1, TL_MR * CF_RUN * 4,
                  bars + 2 * R + r);
      }
      mbar_wait(bars + 2 * R + r, pass & 1);
      // columns past D (the last run's, never written) meet pw2's zero rows
      for (int i = D - r * CF_RUN + lane; i < CF_RUN; i += 32)
        for (int t = 0; t < TL_MR; ++t) ar[t * CF_RUN + i] = 0.f;
      __syncwarp();
      mbar_wait(bars + R + r);
      cf_sums<CF_ROWS2>(ar, CF_RUN, w + B.pw2 + (size_t)r * piece2, cD,
                        red + (size_t)r * TL_MR * cD);
    }
    TL_MARK(19);
    __syncthreads();
    TL_MARK(7);
    for (int i = threadIdx.x; i < mr * cD; i += TL_THREADS) {
      const int t = i / cD, j = i - t * cD, n = n0 + j;
      if (n < D)
        p.y[(size_t)(m0 + t) * D + n] =
            __fadd_rn(xc[(size_t)m0 * cD + i], cf_total(red, R, cD, t, j));
    }
    __syncthreads();
  }
  TL_MARK(8);
}

}  // namespace port

using namespace port;

static int cf_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_cf_smem(int smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv_block_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cf_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y, c [M, D] f32 (16-byte aligned, D a multiple of 8); tc [(kk - 1) / 2,
// D] (the time cache); mask [M] (1 = valid step, 0 = padded); LN's g and b
// [D]; packed: the layer's weights, taps and BN, [blocks][cf_blob(D, kk,
// cD).total] f32 (ops/kernels/conv_block.py:pack_conv_block, 16-byte
// aligned). The launch plan (blocks, cD, smem: dynamic shared bytes) comes
// from the wrapper and is checked against this file's layout. scratch
// holds ceil(M / 8) * 8 * R * CF_RUN f32 (16-byte aligned; R = ceil(D /
// CF_RUN)). Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident).
extern "C" int conv_block_f32_launch(const float* x, int M, int D, int kk, const float* ln_g,
                                     const float* ln_b, const float* tc, const float* mask,
                                     const float* packed, int blocks, int cD, int smem, float* y,
                                     float* c, float* scratch, void* stream_ptr) {
  if (M < 1 || D < TL_GW || D % TL_GW || kk < 1 || kk % 2 == 0 || cD < TL_GW ||
      cD % TL_GW || blocks < 1 || (size_t)blocks * cD < (size_t)D ||
      (size_t)(blocks - 1) * cD >= (size_t)D || cf_smem(M, D, kk, cD).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != cf_smem_set) {
    const cudaError_t err = set_cf_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  CfArgs p = {x, M, D, kk, cD, ln_g, ln_b, tc, mask, packed, y, c, scratch};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)conv_block_f32_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int conv_block_f32_occupancy(int smem, int* info) {
  const cudaError_t err = set_cf_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], conv_block_f32_kernel,
                                                            TL_THREADS, (size_t)smem);
}
