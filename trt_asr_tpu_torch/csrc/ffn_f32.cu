// Fused conformer feed-forward module with f32 weights: one persistent
// cooperative launch a call, the weights streamed through shared memory.
//
// Replaces: trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas (its
// pallas_call at :115) with f32 weights; int8 weights take csrc/ffn_q8.cu,
// bf16 weights the chain of csrc/ffn.cu. For M rows x of width D and the
// expansion E:
//   y = x + scale * silu(LN(x) @ W1) @ W2
// Everything is f32: nothing is rounded, and the products run on the CUDA
// cores (FFMA, no TF32: the f32 policy).
//
// Bound on the H100: memory. At a steady chunk's M 8 (D 1024, E 4096) a call
// reads 33.55 MB of f32 weights: 10.0 us at 3.35 TB/s, against 134 MFLOP
// (2.0 us at the f32 peak).
//
// Design. The TPU kernel grids the expansion axis and carries y across its
// grid steps; here the expansion slices run side by side, one block an SM,
// 512 threads: block b owns cE expansion columns (32 at full width, 128
// blocks; the wrapper's plan, ops/kernels/ffn.py:ffn_f32_plan), and for
// them alone computes, with no grid barrier between,
//   (a) u = LN(x) of the pass's rows (every block, one warp a row);
//   (b) h_b = silu(u @ W1[:, slice]);
//   (c) P_b = h_b @ W2[slice, :], an [8, D] partial stored to scratch;
// then one grid barrier, and (d) block b loads every block's partial of its
// cD columns of y (8) and adds them in a fixed order: y = x + scale *
// sum_b P_b. A block's W1 and W2 pieces do not wait on the barrier, so the
// whole weight stream runs from entry to the last product; after it the
// blocks exchange 4 MB of partials through L2 (a split of D's columns for
// W2 would have every block read all of h, 128 KB). A block's f32 pieces
// are 256 KB at full width, more than a block's shared memory, so they
// flow through a ring of `stages` slots in pieces of FF_RUN:
//   Packed layout (ops/kernels/ffn.py:pack_ffn_f32), a block's slice
//   contiguous, in the order the ring takes it: R = ceil(D / FF_RUN) W1
//   pieces, piece r the K rows [FF_RUN r, FF_RUN (r + 1)) as [FF_RUN / 4][cE]
//   [4] (a column's four consecutive K values in one float4, the columns
//   side by side), then R W2 pieces, piece r the D columns [FF_RUN r,
//   FF_RUN (r + 1)) as [cE / 4][FF_RUN][4]; zero past D and E.
//   Piece i goes to slot i mod stages and completes on mbarrier i, used
//   once a pass; the warp that sums piece i issues piece i + stages into
//   the slot it frees. Every copy of the weights carries an L2 evict-first
//   policy (they are read once a call, and lines that must be written back
//   would share the memory's rate with the stream). x's rows and
//   the norms are copied first, ahead of the weights in the copy engine's
//   queue: behind 22 pieces they landed ~7 us later.
// Warp w sums the pieces w, w + 16, ...: a W1 piece for all 8 rows and the
// block's cE columns (a lane a column, its K in order), the pieces' sums
// added in order; a W2 piece for all 8 rows and its 64 columns over the
// block's cE expansion values (a lane two columns, K in order), stored row
// by row, whole 128-byte lines (stored in slices of the columns that (d)
// adds up, each a 32-byte piece of a line, they took 1.2 us more at full
// width: tail_variants.py --ffn --f32 --against). Rows are taken 8 at a
// time: a call of more than 8 rows streams the weights again for each
// pass, whose partials alternate between two scratch buffers (the barrier
// of pass p + 1 comes after every block has read pass p's). The sums run in
// another order than the plain version's cuBLAS products (f32 ulps apart);
// every sum runs in a fixed order (no atomics): the kernel is
// deterministic, and a captured CUDA graph replays it bit for bit
// (chip_smoke.py phase 2). With TAIL_TIMELINE defined, thread 0 of each
// block records the phases (tail_variants.py --ffn --f32).
#include <cooperative_groups.h>

#include "persistent.cuh"

namespace port {

namespace cg = cooperative_groups;

constexpr int FF_RUN = 64;                // K rows of a W1 piece, D columns of a W2 piece
constexpr int FF_SLICE = 32;              // expansion columns a lane set (cE is a multiple)
constexpr int FF_SUM_RUN = 16;            // blocks' partials a thread adds up in (d)
constexpr int FF_LOADS = 8;               // loads of partials a thread keeps in flight in (d)

// mbarriers after the pieces' (one a piece): x's rows and the LN's norms
enum { FF_X, FF_BARS };

__host__ __device__ inline int ff_runs(int D) { return (D + FF_RUN - 1) / FF_RUN; }

// floats of a piece (and of a ring slot)
__host__ __device__ inline size_t ff_slot(int cE) { return (size_t)FF_RUN * cE; }

// Byte offsets of the dynamic shared memory, mirrored by the wrapper's plan.
// The ring also stages the partials the block adds up in (d).
struct FfSmem {
  size_t ring, xs, hs, xc, red, bars, total;
};

__host__ __device__ inline FfSmem ff_smem(int D, int cE, int cD, int blocks, int stages) {
  const size_t R = ff_runs(D), ring = (size_t)stages * ff_slot(cE) * 4,
               staged = (size_t)blocks * TL_MR * cD * 4;
  FfSmem s;
  size_t o = 0;
  s.ring = o;  o += ring > staged ? ring : staged;                   // weights; partials
  s.xs = o;    o += (size_t)TL_MR * R * FF_RUN * 4;                  // x's rows, then u's
  s.hs = o;    o += (size_t)TL_MR * cE * 4;                          // h's rows
  s.xc = o;    o += (size_t)TL_MR * cD * 4;                          // x on the block's columns
  s.red = o;   o += (size_t)tail_max((int)R * TL_MR * cE, 2 * D) * 4;   // sums; LN's norms
  s.bars = o;  o += (size_t)(2 * R + FF_BARS) * 8;                   // mbarriers
  s.total = o;
  return s;
}

struct FfArgs {
  const float* x;
  int M, D, E, cE, cD, stages;
  const float *ln_g, *ln_b;
  const float* packed;                    // [blocks][2 R][FF_RUN cE]
  float scale;
  float* y;
  float* part;                            // scratch: [2][blocks][8][D], a buffer a pass
};

// Lane 0: piece i of the block's weight stream (its slice `mine`) into ring
// slot i mod stages, completing on mbarrier i
__device__ __forceinline__ void ff_issue(int i, int cE, int stages, const float* mine,
                                         float* ring, uint64_t* bars, uint64_t policy) {
  const uint32_t bytes = (uint32_t)(ff_slot(cE) * 4);
  mbar_expect(bars + i, bytes);
  bulk_copy_hint(ring + (size_t)(i % stages) * ff_slot(cE), mine + (size_t)i * ff_slot(cE),
                 bytes, bars + i, policy);
}

// A warp: once it has summed piece i, piece i + stages into the freed slot
__device__ __forceinline__ void ff_refill(int i, int pieces, int cE, int stages,
                                          const float* mine, float* ring,
                                          uint64_t* bars) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0 && i + stages < pieces) {
    // the warp's generic reads of the slot come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    ff_issue(i + stages, cE, stages, mine, ring, bars, evict_first());
  }
}

// A warp's W1 sums of piece r: rows t < 8 of xs (u's, row pitch Kp, zero in
// [D, Kp); row t read as min(t, mr - 1)) over the piece's FF_RUN rows of K
// with the block's cE columns (w: [FF_RUN / 4][cE][4]), into red [8][cE].
// Lane c takes column c0 + c of each FF_SLICE columns for all 8 rows, K in
// order (FMAs): one weight float4 (a warp reads 512 neighbouring bytes) and
// 8 operand float4s (broadcasts) a step.
__device__ __forceinline__ void ff_w1_sums(const float* xs, int Kp, int mr, const float* w,
                                           int cE, int r, float* red) {
  const int lane = threadIdx.x & 31;
  const float* rows[TL_MR];
#pragma unroll
  for (int t = 0; t < TL_MR; ++t) rows[t] = xs + (size_t)min(t, mr - 1) * Kp + r * FF_RUN;
  for (int c0 = 0; c0 < cE; c0 += FF_SLICE) {
    const float* wc = w + (size_t)(c0 + lane) * 4;
    float acc[TL_MR];
#pragma unroll
    for (int t = 0; t < TL_MR; ++t) acc[t] = 0.f;
#pragma unroll 4
    for (int k4 = 0; k4 < FF_RUN / 4; ++k4) {
      const float4 v = *reinterpret_cast<const float4*>(wc + (size_t)k4 * cE * 4);
#pragma unroll
      for (int t = 0; t < TL_MR; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(rows[t] + 4 * k4);
        acc[t] = fmaf(a.w, v.w, fmaf(a.z, v.z, fmaf(a.y, v.y, fmaf(a.x, v.x, acc[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < TL_MR; ++t) red[(size_t)t * cE + c0 + lane] = acc[t];
  }
}

// A warp's W2 partial of piece r: the 8 rows of hs ([8][cE]) over the
// block's cE expansion values with the piece's FF_RUN columns (w: [cE / 4]
// [FF_RUN][4]), stored to the block's partial (out: [8][D]) at columns
// FF_RUN r + n < D. Lane l takes columns l and l + 32 for all 8 rows, K in
// order (FMAs): two weight float4s and 8 operand float4s (broadcasts) a
// step; a warp's stores are whole 128-byte lines.
__device__ __forceinline__ void ff_w2_sums(const float* hs, int cE, const float* w, int r, int D,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  const float* w0 = w + (size_t)lane * 4;
  const float* w1 = w + (size_t)(lane + 32) * 4;
  float acc[2][TL_MR];
#pragma unroll
  for (int t = 0; t < TL_MR; ++t) acc[0][t] = acc[1][t] = 0.f;
#pragma unroll 2
  for (int j4 = 0; j4 < cE / 4; ++j4) {
    const float4 va = *reinterpret_cast<const float4*>(w0 + (size_t)j4 * FF_RUN * 4);
    const float4 vb = *reinterpret_cast<const float4*>(w1 + (size_t)j4 * FF_RUN * 4);
#pragma unroll
    for (int t = 0; t < TL_MR; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(hs + (size_t)t * cE + 4 * j4);
      acc[0][t] = fmaf(a.w, va.w, fmaf(a.z, va.z, fmaf(a.y, va.y, fmaf(a.x, va.x, acc[0][t]))));
      acc[1][t] = fmaf(a.w, vb.w, fmaf(a.z, vb.z, fmaf(a.y, vb.y, fmaf(a.x, vb.x, acc[1][t]))));
    }
  }
  const int n = r * FF_RUN + lane;
#pragma unroll
  for (int t = 0; t < TL_MR; ++t) {
    if (n < D) __stcg(out + (size_t)t * D + n, acc[0][t]);
    if (n + 32 < D) __stcg(out + (size_t)t * D + n + 32, acc[1][t]);
  }
}

// xc [8][cD] = rows t < mr of xs (x's rows, row pitch `pitch`) on the
// block's cD columns: the residual of (d), kept before the rows are
// overwritten
__device__ __forceinline__ void ff_x_cols(float* xc, const float* xs, int pitch, int mr, int D,
                                          int cD) {
  const int n0 = blockIdx.x * cD;
  for (int o = threadIdx.x; o < mr * cD; o += TL_THREADS) {
    const int t = o / cD, n = n0 + o - t * cD;
    if (n < D) xc[o] = xs[(size_t)t * pitch + n];
  }
}

// (d) after the grid barrier, rows m0 .. m0 + mr - 1 of y on the block's cD
// columns: every block's partial of them (part: [blocks][8][D]) loaded into
// staged ([blocks][8][cD]), FF_LOADS loads in flight a thread, and added up
// in a fixed order: runs of FF_SUM_RUN blocks, each in block order by a
// thread of its own, then the runs' sums in order; y = xc + scale * sum
__device__ __forceinline__ void ff_reduce(const float* part, float* staged, int m0, int mr, int D,
                                          int cD, const float* xc, float scale, float* y) {
  const int n0 = blockIdx.x * cD, blocks = gridDim.x, O = mr * cD, R = TL_MR * cD;
  const int runs = (blocks + FF_SUM_RUN - 1) / FF_SUM_RUN;
  if (n0 >= D) return;                      // a block past D's last column
  const int c4 = cD / 4, nl = blocks * TL_MR * c4;
  for (int i0 = threadIdx.x; i0 < nl; i0 += FF_LOADS * TL_THREADS) {
    float4 v[FF_LOADS];
#pragma unroll
    for (int u = 0; u < FF_LOADS; ++u) {
      const int i = i0 + u * TL_THREADS, bt = i / c4, c = n0 + 4 * (i - bt * c4);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nl && c < D)
        v[u] = __ldcg(reinterpret_cast<const float4*>(part + (size_t)bt * D + c));
    }
#pragma unroll
    for (int u = 0; u < FF_LOADS; ++u) {
      const int i = i0 + u * TL_THREADS;
      if (i < nl) reinterpret_cast<float4*>(staged)[i] = v[u];
    }
  }
  __syncthreads();
  // output o of run q: blocks [q FF_SUM_RUN, (q + 1) FF_SUM_RUN), its sum
  // stored in place of the run's first partial (read by this thread only)
  for (int i = threadIdx.x; i < O * runs; i += TL_THREADS) {
    const int q = i / O, o = i - q * O, b0 = q * FF_SUM_RUN;
    float v[FF_SUM_RUN];
#pragma unroll
    for (int u = 0; u < FF_SUM_RUN; ++u)
      v[u] = b0 + u < blocks ? staged[(size_t)(b0 + u) * R + o] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int u = 1; u < FF_SUM_RUN; ++u)
      if (b0 + u < blocks) sum = __fadd_rn(sum, v[u]);
    staged[(size_t)b0 * R + o] = sum;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < O; o += TL_THREADS) {
    const int t = o / cD, j = o - t * cD, n = n0 + j;
    if (n >= D) continue;
    float sum = staged[o];
    for (int q = 1; q < runs; ++q) sum = __fadd_rn(sum, staged[(size_t)q * FF_SUM_RUN * R + o]);
    y[(size_t)(m0 + t) * D + n] = __fadd_rn(xc[o], __fmul_rn(scale, sum));
  }
}

__global__ void __launch_bounds__(TL_THREADS, 1) ffn_f32_kernel(FfArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, D = p.D, cE = p.cE, cD = p.cD, st = p.stages;
  const int R = ff_runs(D), Kp = R * FF_RUN, pieces = 2 * R;
  const FfSmem L = ff_smem(D, cE, cD, gridDim.x, st);
  float* ring = reinterpret_cast<float*>(smem + L.ring);      // [stages][ff_slot]; partials
  float* xs = reinterpret_cast<float*>(smem + L.xs);          // [8][Kp]
  float* hs = reinterpret_cast<float*>(smem + L.hs);          // [8][cE]
  float* xc = reinterpret_cast<float*>(smem + L.xc);          // [8][cD]
  float* red = reinterpret_cast<float*>(smem + L.red);        // [R][8][cE]
  float* norms = red;                                         // [2][D], read by (a) only
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);   // the pieces'
  uint64_t* own = bars + pieces;                                  // FF_X
  const float* mine = p.packed + (size_t)blockIdx.x * pieces * ff_slot(cE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const cg::grid_group grid = cg::this_grid();
  TL_MARK(0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < pieces + FF_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                          // the mbarriers are ready
  for (int m0 = 0, pass = 0; m0 < M; m0 += TL_MR, ++pass) {
    const int mr = min(TL_MR, M - m0), parity = pass & 1;
    if (pass > 0) __syncthreads();          // the previous pass has read the ring and red
    // thread 0: the pass's x rows and the norms, ahead of the weights in the
    // copy engine's queue (behind them they land ~7 us later)
    if (threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect(own + FF_X, (uint32_t)(mr + 2) * D * 4);
      if (Kp == D)                          // the rows are contiguous both sides
        bulk_copy(xs, p.x + (size_t)m0 * D, mr * D * 4, own + FF_X);
      else
        for (int t = 0; t < mr; ++t)
          bulk_copy(xs + (size_t)t * Kp, p.x + (size_t)(m0 + t) * D, D * 4, own + FF_X);
      bulk_copy(norms, p.ln_g, D * 4, own + FF_X);
      bulk_copy(norms + D, p.ln_b, D * 4, own + FF_X);
    }
    // xs's columns [D, Kp) meet the weights' zero rows past K
    for (int i = threadIdx.x; i < TL_MR * (Kp - D); i += TL_THREADS)
      xs[(size_t)(i / (Kp - D)) * Kp + D + i % (Kp - D)] = 0.f;
    __syncthreads();
    // lane 0 of each warp: its first pieces of the weight stream (the first
    // `stages` of them)
    if (lane == 0) {
      const uint64_t once = evict_first();
      if (pass > 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = warp; i < min(st, pieces); i += TL_WARPS)
        ff_issue(i, cE, st, mine, ring, bars, once);
    }
    TL_MARK(1);
    mbar_wait(own + FF_X, parity);
    TL_MARK(2);

    // (a) u = LN(x), in place of x's rows (their block columns kept for (d))
    ff_x_cols(xc, xs, Kp, mr, D, cD);
    __syncthreads();
    ln_rows_f32(xs, Kp, mr, D, norms, norms + D, nullptr);
    __syncthreads();
    TL_MARK(3);

    // (b) the block's columns of h, a W1 piece as it lands
    for (int r = warp; r < R; r += TL_WARPS) {
      mbar_wait(bars + r, parity);
      ff_w1_sums(xs, Kp, mr, ring + (size_t)(r % st) * ff_slot(cE), cE, r,
                 red + (size_t)r * TL_MR * cE);
      ff_refill(r, pieces, cE, st, mine, ring, bars);
    }
    TL_MARK(17);
    __syncthreads();
    TL_MARK(4);
    for (int i = threadIdx.x; i < TL_MR * cE; i += TL_THREADS) {
      float v = 0.f;
      for (int r = 0; r < R; ++r) v = __fadd_rn(v, red[(size_t)r * TL_MR * cE + i]);
      hs[i] = silu_f(v);                    // zero past E: the weights' zero columns
    }
    __syncthreads();
    TL_MARK(5);

    // (c) the block's partial of every column of y, a W2 piece as it lands
    float* part = p.part + (size_t)parity * gridDim.x * TL_MR * D;
    for (int r = warp; r < R; r += TL_WARPS) {
      const int i = R + r;
      mbar_wait(bars + i, parity);
      ff_w2_sums(hs, cE, ring + (size_t)(i % st) * ff_slot(cE), r, D,
                 part + (size_t)blockIdx.x * TL_MR * D);
      ff_refill(i, pieces, cE, st, mine, ring, bars);
    }
    TL_MARK(6);
    grid.sync();
    TL_MARK(7);

    // (d) y on the block's columns, the partials staged in the ring
    ff_reduce(part, ring, m0, mr, D, cD, xc, p.scale, p.y);
    TL_MARK(8);
  }
}

}  // namespace port

using namespace port;

static int ff_smem_set = -1;         // the kernel's dynamic shared memory limit, as set

static cudaError_t set_ff_smem(int smem) {
  const cudaError_t err =
      cudaFuncSetAttribute(ffn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  ff_smem_set = err == cudaSuccess ? smem : -1;
  return err;
}

// x, y [M, D] f32 (16-byte aligned, D a multiple of 8); the LN's g, b [D];
// packed: the weights, [blocks][2 ff_runs(D)][FF_RUN cE] f32
// (ops/kernels/ffn.py:pack_ffn_f32, 16-byte aligned). The launch plan
// (blocks, cE, cD, stages, smem: dynamic shared bytes) comes from the
// wrapper and is checked against this file's layout. scratch holds 2 *
// blocks * 8 * D f32. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident).
extern "C" int ffn_f32_launch(const float* x, int M, int D, int E, const float* ln_g,
                              const float* ln_b, const float* packed, int blocks, int cE, int cD,
                              int stages, int smem, float scale, float* y, float* scratch,
                              void* stream_ptr) {
  if (M < 1 || D < TL_GW || D % TL_GW || E < 1 || cE < FF_SLICE || cE % FF_SLICE ||
      blocks < 1 || (size_t)blocks * cE < (size_t)E || (size_t)(blocks - 1) * cE >= (size_t)E ||
      cD < 4 || cD % 4 || (size_t)blocks * cD < (size_t)D || stages < 1 ||
      stages > 2 * ff_runs(D) || ff_smem(D, cE, cD, blocks, stages).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  if (smem != ff_smem_set) {
    const cudaError_t err = set_ff_smem(smem);
    if (err != cudaSuccess) return (int)err;
  }
  FfArgs p = {x, M, D, E, cE, cD, stages, ln_g, ln_b, packed, scale, y, scratch};
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ffn_f32_kernel, dim3(blocks), dim3(TL_THREADS), args, (size_t)smem,
      (cudaStream_t)stream_ptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info[0] = blocks of the kernel an SM holds with `smem` dynamic shared
// bytes (the CUDA occupancy API)
extern "C" int ffn_f32_occupancy(int smem, int* info) {
  const cudaError_t err = set_ff_smem(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], ffn_f32_kernel,
                                                            TL_THREADS, (size_t)smem);
}
