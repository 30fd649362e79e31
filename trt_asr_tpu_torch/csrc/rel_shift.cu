// Relative-position bias with the Transformer-XL shift, computed shifted.
//
// Replaces: trt_asr_tpu/ops/pallas/rel_shift_kernel.py:rel_pos_bias_shifted
// (its pallas_call at :102). For q_v [B, Tq, H, dh] and pos [R, H, dh] in
// q_v's type (R >= Tq + tkv - 1):
//   bd[b, h, t, s] = sum_d q_v[b, t, h, d] * pos[Tq - 1 - t + s, h, d]
// summed in f32 and rounded once to q_v's type; bd is [B, H, Tq, tkv].
//
// The TPU kernel forms a whole [128, R_pad] product per row block and then
// rolls, shears and slices it through VMEM, as Mosaic's layout rules demand.
// Here the shear is in the addressing: row t needs only the tkv positions
// starting at Tq - 1 - t, so a tile of rows of one (b, h) needs only a band
// of positions, each product lands in one output column, and nothing of the
// product is materialized in device memory.
//
// Bound on the H100: the bf16 case (the only one the offline path runs) is
// bound by bytes, and most of them are the write of bd: at the offline shapes
// (B 8, T 368, H 8, dh 128) q_v 6.0 MB + pos 1.5 MB + bd 17.3 MB = 24.8 MB,
// 7.4 us at 3.35 TB/s, against 2.2 GFLOP, 2.2 us at the bf16 tensor-core
// rate. The f32 case is bound by its 2 B H Tq tkv dh operations at the f32
// rate.
//
// bf16 (rel_shift_bf16_kernel): tensor cores, one pass over the band. A
// block owns RB_BT = 64 rows t0 .. t0 + 63 of one (b, h), 16 a warp (the
// m16 of mma.sync.m16n8k16: bf16 operands, f32 sums), and walks every
// column s itself. With band index j = s - r + RB_BT for tile row r (band
// position Tq - 1 - t0 - RB_BT + j), the band of the block is one run of
// consecutive positions, read in chunks of RB_NC = 64: chunk k (j in
// [64k, 64k + 64)) feeds columns [64k - 64, 64k + 63) and completes output
// tile k - 1 (columns [64(k - 1), 64k)). So each position is copied once a
// block (the TPU kernel's [128, R_pad] product, roll and slice become a
// walk along the band), and each product of a chunk is an output value but
// for the triangles at the two ends of the walk: 1.18x the products bd
// needs at T 368 (a warp skips a chunk none of whose columns lies in bd;
// skipping the n8 tiles outside [0, tkv) as well cost more in branches
// and code than it saved in products). The warp's A fragments (q_v, 32
// registers a thread at dh 128) are read once from device memory; the
// band's chunks (the col-major B operand in [pos][d] order, plain
// ldmatrix) are copied with cp.async through a three-stage ring, two chunks
// ahead of the products. A head dim that is not a multiple of 16 is
// zero-filled up to one, rows past Tq and positions outside [0, R) are
// zero; band rows are dh16 + 8 elements apart, an odd number of 16-byte
// units, so ldmatrix hits 32 distinct banks. Epilogue: each sum is rounded
// once to bf16 and stored (2 bytes) at its sheared column of a two-tile
// ring [64][2 x 64] in shared memory (a thread's pair of sums lands on an
// odd or an even column depending on its row, so it cannot go to device
// memory as one 4-byte store); after chunk k the warp writes its 16 rows of
// tile k - 1 as whole row segments with 16-byte coalesced stores (8, 4 or 2
// bytes when the rows of bd are not 16-byte aligned: tkv not a multiple of
// 8). A warp alone writes and reads its rows of the ring, so one
// __syncthreads a chunk (the band's ring) is all the block waits on. 68 KB
// of shared memory at dh 128: 3 blocks an SM, and the offline shapes' 384
// blocks are one wave on 132 SMs. What holds it back: the products are its
// largest phase, then the band's copies (each of a head's row tiles re-reads
// its band out of L2), the ring's stores and the row writes, and they
// overlap little, since every warp of an SM walks in step. wgmma
// (m64n64k16, B in its core-matrix layout, A from the same registers) was
// slower as a drop-in.

// f32 (rel_shift_f32_kernel): CUDA cores. A block stages RS_BT rows of q_v
// and the band of RS_NB = RS_BT + RS_BS - 1 positions an [RS_BT, RS_BS]
// tile needs in shared memory, computes the [RS_BT, RS_NB] product of the
// two (a quarter of it falls outside the parallelogram the tile needs and
// is dropped), and writes each product to its shifted place: band row j of
// tile row r is column j - (RS_BT - 1 - r). Warp w owns rows 4w .. 4w+3;
// lane l owns band rows l, l+32, l+64, l+96, so its 16 sums reuse each q row
// and band row it loads four times, the loads are 16 bytes along dh, and the
// 32 lanes of a warp read 32 consecutive band rows (the row pitch is an odd
// number of 16-byte units: no bank conflict). Sums run in d order. The
// stores of a warp are 32 consecutive columns of one row.
#include "common.cuh"

namespace port {

constexpr int RS_DMAX = 128;                 // largest head dim taken

// --- bf16: mma.sync + cp.async, one pass over the band -----------------------

constexpr int RB_BT = 64;                    // rows of a block
constexpr int RB_NC = RB_BT;                 // positions a chunk = columns an output tile
constexpr int RB_WARPS = RB_BT / 16;
constexpr int RB_THREADS = RB_WARPS * 32;
constexpr int RB_KS = RS_DMAX / 16;          // k16 steps of q . pos
constexpr int RB_PAD = 8;                    // row pitch of the band's stages: dh16 + 8
constexpr int RB_OLD = 2 * RB_NC + 8;        // row pitch of the output ring, elements
constexpr int RB_STAGES = 3;                 // chunks of the band in shared memory
constexpr int RB_MIN_BLOCKS = 3;             // blocks an SM (__launch_bounds__)
static_assert(RB_NC == RB_BT, "a chunk completes an output tile");

// the band's ring, the output ring
__host__ __device__ constexpr size_t rel_shift_bf16_smem(int dh) {
  return ((size_t)RB_STAGES * RB_NC * (((dh + 15) & ~15) + RB_PAD) +
          (size_t)RB_BT * RB_OLD) * sizeof(bf16);
}

// Rows row0 .. row0 + RB_NC - 1 of a row-major matrix of n rows (row i at
// src + i * step), columns 0 .. dp - 1 of which the first dh are read (dh a
// multiple of BYTES / 2), into dst with row pitch `pitch`; rows outside
// [0, n) and columns past dh are zero.
template <int BYTES>
__device__ __forceinline__ void rb_load_rows(bf16* dst, int pitch, const bf16* src, size_t step,
                                             int row0, int n, int dh, int dp) {
  constexpr int E = BYTES / 2, TPR = RS_DMAX / E, RPP = RB_THREADS / TPR;   // threads a row
  const int col = (threadIdx.x % TPR) * E;
  if (col >= dp) return;
#pragma unroll 4
  for (int r = threadIdx.x / TPR; r < RB_NC; r += RPP) {
    const int t = row0 + r;
    const bool ok = t >= 0 && t < n && col < dh;
    cp_async<BYTES>(dst + r * pitch + col, ok ? src + (ptrdiff_t)t * step + col : src,
                    ok ? BYTES : 0);
  }
}

template <int BYTES> struct StoreVec;
template <> struct StoreVec<16> { using T = uint4; };
template <> struct StoreVec<8> { using T = uint2; };
template <> struct StoreVec<4> { using T = uint32_t; };
template <> struct StoreVec<2> { using T = uint16_t; };

// The products of 16 rows (A fragments qf) with the RB_NC band positions of
// a chunk (pc), each rounded once to bf16 and stored at its sheared column
// of the output ring (o_rows: the ring's row of row 0): row r, position n
// is column s_w + n + r, stored if it lies in [0, tkv).
__device__ __forceinline__ void rb_warp_chunk(const uint32_t (&qf)[RB_KS][4], const bf16* pc,
                                              int pitch, int nks, int s_w, int tkv,
                                              bf16* o_rows) {
  // ldmatrix row addresses of this lane for the B operand (the band):
  // matrices (positions 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15),
  // i.e. two n8 tiles of one k16 step
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = lane & 8;
  float acc[RB_NC / 8][4] = {};
#pragma unroll
  for (int ks = 0; ks < RB_KS; ++ks) {
    if (ks >= nks) break;
#pragma unroll
    for (int np = 0; np < RB_NC / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, pc + (16 * np + b_row) * pitch + 16 * ks + b_col);
      mma_bf16(acc[2 * np], qf[ks], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], qf[ks], bf[2], bf[3]);
    }
  }
  // accumulator (row g (+8), columns 2c, 2c + 1 of n8 tile nt)
#pragma unroll
  for (int nt = 0; nt < RB_NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1), s = s_w + 8 * nt + 2 * c + (e & 1) + r;
      if ((unsigned)s < (unsigned)tkv)
        o_rows[r * RB_OLD + (s & (2 * RB_NC - 1))] = __float2bfloat16_rn(acc[nt][e]);
    }
}

// QB: copy width of pos rows (16 or 8 bytes); OB: store width of bd rows
// (16, 8, 4 or 2 bytes).
template <int QB, int OB>
__global__ void __launch_bounds__(RB_THREADS, RB_MIN_BLOCKS)
rel_shift_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pos, int Tq, int H,
                      int dh, int R, int tkv, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = (dh + 15) & ~15, pitch = dp + RB_PAD, nks = dp / 16;
  bf16* p_s = reinterpret_cast<bf16*>(smem);     // RB_STAGES x [RB_NC][pitch]: the band's ring
  bf16* o_s = p_s + RB_STAGES * RB_NC * pitch;   // [RB_BT][RB_OLD]: the output ring
  const int t0 = blockIdx.x * RB_BT, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const size_t step = (size_t)H * dh;            // between time steps (and positions)
  const bf16* pos_h = pos + (size_t)h * dh;
  const int pb = Tq - 1 - t0 - RB_BT;            // position of band index 0
  const int nchunks = (tkv - 1 + RB_BT) / RB_NC + 1;   // j = tkv - 1 + RB_BT is the last
  // chunk c (band positions pb + 64c ..) into stage c % RB_STAGES, one copy
  // group a chunk (empty past the last chunk, so the count stays uniform)
  auto load_chunk = [&](int c) {
    if (c < nchunks)
      rb_load_rows<QB>(p_s + (c % RB_STAGES) * RB_NC * pitch, pitch, pos_h, step,
                       pb + c * RB_NC, R, dh, dp);
    cp_async_commit();
  };
  for (int c = 0; c < RB_STAGES - 1; ++c) load_chunk(c);

  // A fragments of the warp's 16 rows, straight from q_v, zero past Tq and
  // dh: of each k16 step a thread holds rows g and g + 8 at d 2c, 2c + 1 and
  // 2c + 8, 2c + 9
  const int r0 = 16 * w;                         // first tile row of this warp
  const bool live = t0 + r0 < Tq;
  uint32_t qf[RB_KS][4];
  const bf16* q_w = q + ((size_t)b * Tq + t0 + r0) * step + (size_t)h * dh;
#pragma unroll
  for (int ks = 0; ks < RB_KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = 16 * ks + 2 * c + 8 * (i >> 1);
      qf[ks][i] = t0 + r0 + row < Tq && col < dh
                      ? *reinterpret_cast<const uint32_t*>(q_w + row * step + col) : 0u;
    }

  bf16* o_w = o_s + r0 * RB_OLD;                 // this warp's rows of the output ring
  bf16* out_w = out + ((size_t)(b * H + h) * Tq + t0 + r0) * tkv;
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<RB_STAGES - 2>();      // chunk k has landed
    __syncthreads();                     // for every thread; chunk k - 1 is done with
    load_chunk(k + RB_STAGES - 1);       // into chunk k - 1's stage
    if (!live) continue;
    const int s_w = k * RB_NC + r0 - RB_BT;      // column of (row r0, position 0)
    if (s_w < tkv)                               // else no column of the chunk is in bd
      rb_warp_chunk(qf, p_s + (k % RB_STAGES) * RB_NC * pitch, pitch, nks, s_w, tkv, o_w);
    __syncwarp();
    if (k == 0) continue;
    // the warp's rows of tile k - 1, whole now, to bd: row segments, OB
    // bytes a store (the warp alone writes and reads its rows of the ring)
    using V = typename StoreVec<OB>::T;
    constexpr int E = OB / 2, VPR = RB_NC / E;
    const int sb = (k - 1) * RB_NC;
#pragma unroll
    for (int i = lane; i < 16 * VPR; i += 32) {
      const int r = i / VPR, s = sb + (i % VPR) * E;
      if (t0 + r0 + r < Tq && s < tkv)
        *reinterpret_cast<V*>(out_w + (size_t)r * tkv + s) =
            *reinterpret_cast<const V*>(o_w + r * RB_OLD + (s & (2 * RB_NC - 1)));
    }
  }
}

template <int QB, int OB>
cudaError_t launch_rel_shift_bf16_as(const void* q, const void* pos, int B, int Tq, int H,
                                     int dh, int R, int tkv, void* out, cudaStream_t stream) {
  const size_t smem = rel_shift_bf16_smem(dh);
  cudaError_t err = cudaFuncSetAttribute(rel_shift_bf16_kernel<QB, OB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + RB_BT - 1) / RB_BT, H, B);
  rel_shift_bf16_kernel<QB, OB><<<grid, RB_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)pos, Tq, H, dh, R, tkv, (bf16*)out);
  return cudaGetLastError();
}

template <int QB>
cudaError_t launch_rel_shift_bf16_q(int ob, const void* q, const void* pos, int B, int Tq, int H,
                                    int dh, int R, int tkv, void* out, cudaStream_t stream) {
  switch (ob) {
    case 16: return launch_rel_shift_bf16_as<QB, 16>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
    case 8: return launch_rel_shift_bf16_as<QB, 8>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
    case 4: return launch_rel_shift_bf16_as<QB, 4>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
    default: return launch_rel_shift_bf16_as<QB, 2>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
  }
}

// Copy and store widths from the alignment of the rows: 16 bytes for pos
// when its rows allow it, else 8; the widest store that every row of bd
// starts on (16 bytes when tkv is a multiple of 8).
cudaError_t launch_rel_shift_bf16(const void* q, const void* pos, int B, int Tq, int H, int dh,
                                  int R, int tkv, void* out, cudaStream_t stream) {
  int ob = 16;
  while (ob > 2 && !copies_aligned(ob, {(uintptr_t)out, 2u * (uintptr_t)tkv})) ob >>= 1;
  if (copies_aligned(16, {(uintptr_t)pos, 2u * (uintptr_t)dh}))
    return launch_rel_shift_bf16_q<16>(ob, q, pos, B, Tq, H, dh, R, tkv, out, stream);
  return launch_rel_shift_bf16_q<8>(ob, q, pos, B, Tq, H, dh, R, tkv, out, stream);
}

// --- f32: CUDA cores ---------------------------------------------------------

constexpr int RS_BT = 32;                    // rows of a tile
constexpr int RS_NB = 128;                   // band rows a tile computes
constexpr int RS_BS = RS_NB - RS_BT + 1;     // columns of a tile
constexpr int RS_WARPS = 8;
constexpr int RS_RPW = RS_BT / RS_WARPS;     // rows a warp
constexpr int RS_JPL = RS_NB / 32;           // band rows a lane

__global__ void __launch_bounds__(RS_WARPS * 32)
rel_shift_f32_kernel(const float* __restrict__ q, const float* __restrict__ pos, int Tq, int H,
                     int dh, int R, int tkv, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int ld4 = pitch4(dh), nd4 = dh / 4;
  float4* q_s = smem4;                       // [RS_BT][ld4]
  float4* p_s = smem4 + RS_BT * ld4;         // [RS_NB][ld4]
  const int s0 = blockIdx.x * RS_BS, t0 = blockIdx.y * RS_BT;
  const int bh = blockIdx.z, b = bh / H, h = bh - b * H;
  const int p0 = Tq - 1 - (t0 + RS_BT - 1) + s0;    // position of band row 0

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = threadIdx.x; i < RS_BT * nd4; i += blockDim.x) {
    const int r = i / nd4, c = i - r * nd4, t = t0 + r;
    q_s[r * ld4 + c] =
        t < Tq ? load4_f(q + ((size_t)(b * Tq + t) * H + h) * dh + 4 * c) : zero;
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < RS_NB * nd4; i += blockDim.x) {
    const int j = i / nd4, c = i - j * nd4, p = p0 + j;
    p_s[j * ld4 + c] =
        (p >= 0 && p < R) ? load4_f(pos + ((size_t)p * H + h) * dh + 4 * c) : zero;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float4* qr = q_s + w * RS_RPW * ld4;
  const float4* pr = p_s + lane * ld4;
  float acc[RS_RPW][RS_JPL];
#pragma unroll
  for (int rr = 0; rr < RS_RPW; ++rr)
#pragma unroll
    for (int i = 0; i < RS_JPL; ++i) acc[rr][i] = 0.f;
  for (int d4 = 0; d4 < nd4; ++d4) {
    float4 qv[RS_RPW], pv[RS_JPL];
#pragma unroll
    for (int rr = 0; rr < RS_RPW; ++rr) qv[rr] = qr[rr * ld4 + d4];
#pragma unroll
    for (int i = 0; i < RS_JPL; ++i) pv[i] = pr[i * 32 * ld4 + d4];
#pragma unroll
    for (int rr = 0; rr < RS_RPW; ++rr)
#pragma unroll
      for (int i = 0; i < RS_JPL; ++i) acc[rr][i] = dot4(qv[rr], pv[i], acc[rr][i]);
  }
#pragma unroll
  for (int rr = 0; rr < RS_RPW; ++rr) {
    const int r = w * RS_RPW + rr, t = t0 + r;
    if (t >= Tq) continue;
    float* row = out + ((size_t)bh * Tq + t) * tkv;
#pragma unroll
    for (int i = 0; i < RS_JPL; ++i) {
      const int sl = lane + 32 * i - (RS_BT - 1 - r);   // column within the tile
      if (sl >= 0 && sl < RS_BS && s0 + sl < tkv) row[s0 + sl] = acc[rr][i];
    }
  }
}

cudaError_t launch_rel_shift_f32(const void* q, const void* pos, int B, int Tq, int H, int dh,
                                 int R, int tkv, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(RS_BT + RS_NB) * pitch4(dh) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(rel_shift_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tkv + RS_BS - 1) / RS_BS, (Tq + RS_BT - 1) / RS_BT, B * H);
  rel_shift_f32_kernel<<<grid, RS_WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)pos, Tq, H, dh, R, tkv, (float*)out);
  return cudaGetLastError();
}

}  // namespace port

using namespace port;

// q [B, Tq, H, dh], pos [R, H, dh], out [B, H, Tq, tkv], all contiguous and of
// one type: dtype 0 = f32, 1 = bf16; dh a multiple of 4, at most 128; q and
// pos aligned to four elements, out to one.
// Returns the CUDA error code.
extern "C" int rel_shift_launch(const void* q, const void* pos, int B, int Tq, int H, int dh,
                                int R, int tkv, int dtype, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || Tq < 1 || H < 1 || tkv < 1 || dh < 4 || dh % 4 != 0 || dh > RS_DMAX ||
      R < Tq + tkv - 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == W_F32)
    return (int)launch_rel_shift_f32(q, pos, B, Tq, H, dh, R, tkv, out, stream);
  if (dtype == W_BF16)
    return (int)launch_rel_shift_bf16(q, pos, B, Tq, H, dh, R, tkv, out, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 kernel at head dim dh, and how many of
// its blocks an SM holds at once; both written to info[0..1].
extern "C" int rel_shift_bf16_occupancy(int dh, int* info) {
  const size_t smem = rel_shift_bf16_smem(dh);
  cudaError_t err = cudaFuncSetAttribute(rel_shift_bf16_kernel<16, 16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[1], rel_shift_bf16_kernel<16, 16>, RB_THREADS, smem);
}
