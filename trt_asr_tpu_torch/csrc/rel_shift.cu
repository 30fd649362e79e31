// Relative-position bias with the Transformer-XL shift, computed shifted.
//
// Replaces: trt_asr_tpu/ops/pallas/rel_shift_kernel.py:rel_pos_bias_shifted
// (its pallas_call at :102). For q_v [B, Tq, H, dh] and pos [R, H, dh] in
// q_v's type (R >= Tq + tkv - 1):
//   bd[b, h, t, s] = sum_d q_v[b, t, h, d] * pos[Tq - 1 - t + s, h, d]
// summed in f32 over d in order and rounded once to q_v's type; bd is
// [B, H, Tq, tkv].
//
// The TPU kernel forms a whole [128, R_pad] product per row block and then
// rolls, shears and slices it through VMEM, as Mosaic's layout rules demand.
// Here the shear is in the addressing. Row t needs only the tkv positions
// starting at Tq - 1 - t, so a tile of RS_BT rows by RS_BS columns of one
// (b, h) needs only a band of RS_NB = RS_BT + RS_BS - 1 positions. A block
// stages its rows of q_v and that band in shared memory as f32, computes the
// [RS_BT, RS_NB] product of the two (a quarter of it falls outside the
// parallelogram the tile needs and is dropped), and writes each product to
// its shifted place: band row j of tile row r is column j - (RS_BT - 1 - r).
// Warp w owns rows 4w .. 4w+3; lane l owns band rows l, l+32, l+64, l+96, so
// its 16 sums reuse each q row and band row it loads four times, the loads
// are 16 bytes along dh, and the 32 lanes of a warp read 32 consecutive band
// rows (the row pitch is an odd number of 16-byte units: no bank conflict).
// The stores of a warp are 32 consecutive columns of one row.
//
// Bound on the H100: at the offline shapes (B 8, T 368, H 8, dh 128) the
// bf16 case is bound by bytes (writing bd: 2 B H T^2 bytes), the f32 case by
// the 2 B H T^2 dh operations at the f32 rate. This version multiplies on
// CUDA cores from shared memory; tensor cores (wgmma over the band) are later
// work.
#include "common.cuh"

namespace port {

constexpr int RS_BT = 32;                    // rows of a tile
constexpr int RS_NB = 128;                   // band rows a tile computes
constexpr int RS_BS = RS_NB - RS_BT + 1;     // columns of a tile
constexpr int RS_WARPS = 8;
constexpr int RS_RPW = RS_BT / RS_WARPS;     // rows a warp
constexpr int RS_JPL = RS_NB / 32;           // band rows a lane
constexpr int RS_DMAX = 128;                 // largest head dim taken

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(RS_WARPS * 32)
rel_shift_kernel(const T* __restrict__ q, const T* __restrict__ pos, int Tq, int H, int dh,
                 int R, int tkv, T* __restrict__ out) {
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
    T* row = out + ((size_t)bh * Tq + t) * tkv;
#pragma unroll
    for (int i = 0; i < RS_JPL; ++i) {
      const int sl = lane + 32 * i - (RS_BT - 1 - r);   // column within the tile
      if (sl >= 0 && sl < RS_BS && s0 + sl < tkv) store_as(row + s0 + sl, acc[rr][i]);
    }
  }
}

template <typename T>
cudaError_t launch_rel_shift(const void* q, const void* pos, int B, int Tq, int H, int dh,
                             int R, int tkv, void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(RS_BT + RS_NB) * pitch4(dh) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(rel_shift_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((tkv + RS_BS - 1) / RS_BS, (Tq + RS_BT - 1) / RS_BT, B * H);
  rel_shift_kernel<T><<<grid, RS_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)pos, Tq, H, dh, R, tkv, (T*)out);
  return cudaGetLastError();
}

}  // namespace port

using namespace port;

// q [B, Tq, H, dh], pos [R, H, dh], out [B, H, Tq, tkv], all contiguous and of
// one type: dtype 0 = f32, 1 = bf16; dh a multiple of 4, at most 128; q and
// pos aligned to four elements.
// Returns the CUDA error code.
extern "C" int rel_shift_launch(const void* q, const void* pos, int B, int Tq, int H, int dh,
                                int R, int tkv, int dtype, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || Tq < 1 || H < 1 || tkv < 1 || dh < 4 || dh % 4 != 0 || dh > RS_DMAX ||
      R < Tq + tkv - 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == W_F32)
    return (int)launch_rel_shift<float>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
  if (dtype == W_BF16)
    return (int)launch_rel_shift<__nv_bfloat16>(q, pos, B, Tq, H, dh, R, tkv, out, stream);
  return (int)cudaErrorInvalidValue;
}
