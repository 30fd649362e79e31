// Offline attention with a relative-position bias, online softmax.
//
// Replaces: trt_asr_tpu/ops/pallas/flash_att_kernel.py:flash_bias_attention
// (its pallas_call at :116). For q_u, k, v [B, T, H, dh] and bd [B, H, T, T]
// of one type (f32 or bf16) and kv_mask [B, T]:
//   s[t, j] = (q_u[t] . k[j] (f32) + (kv_mask[j] ? bd[t, j] : neg)) * scale
// then, over key blocks of FA_BLOCK = 128 (the TPU kernel's block):
//   m' = max(m, max_j s), a = exp(m - m'), p = exp(s - m'),
//   l = l a + sum_j p, acc = acc a + sum_j round(p) v[j]        (m from -1e30)
//   out[t] = acc / max(l, 1e-30)
// with the TPU kernel's rounding points: neg is -1e9 in the operand type and
// takes the place of bd on masked columns, p is rounded to v's type before
// p . v, and everything is summed in f32. The running max moves at the same
// key positions as on the TPU, so p rounds as it does there. out is [B, T,
// H * dh] f32, before the output projection.
//
// On the TPU the K/V axis is a sequential grid dimension that carries m, l
// and the accumulator in VMEM scratch, and the mask is folded into a padded
// bias tensor because of the (8, 128) block rule. Here one block owns FA_BQ
// query rows of one (b, h) and walks all key blocks itself, holding m, l and
// the accumulators in registers; it reads kv_mask directly and takes bd with
// its plane and row strides, so the caller's shifted view needs no copy.
// Keys past T are left out (p = 0), which equals the TPU's -1e9 padding for
// every row with a valid key. K and V pass through shared memory 32 keys at
// a time. Warp w owns rows 8w .. 8w+7; for the scores lane l takes keys
// l + 32i of the key block (16-byte loads along dh, consecutive rows a warp:
// the row pitch is an odd number of 16-byte units), for p . v lane l takes
// the four columns 4l .. 4l+3, so every load feeds 8 rows.
//
// Bound on the H100: bytes at the offline shapes (q, k, v, bd, out: ~47 MB in
// bf16 at B 8, T 368). This version multiplies on CUDA cores from shared
// memory and rereads K/V once per query tile (from L2); wgmma/TMA tiles are
// later work.
#include "common.cuh"

namespace port {

constexpr int FA_BQ = 32;                   // query rows a block
constexpr int FA_BLOCK = 128;               // keys a softmax block (the TPU's)
constexpr int FA_SUB = 32;                  // keys staged at a time, one a lane
constexpr int FA_NSUB = FA_BLOCK / FA_SUB;
constexpr int FA_WARPS = 4;
constexpr int FA_RPW = FA_BQ / FA_WARPS;    // query rows a warp
constexpr int FA_DMAX = 128;                // largest head dim taken
constexpr int FA_PLD = FA_BLOCK + 4;        // p row pitch, floats

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// rows t0 .. t0 + rows - 1 of src (rows `step` apart, dh values each) into
// dst as f32 with a row pitch of ld4 float4s; rows past Tn are zero
template <typename T>
__device__ __forceinline__ void stage_rows(float4* dst, int ld4, const T* __restrict__ src,
                                           size_t step, int t0, int rows, int Tn, int dh) {
  const int nd4 = dh / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * nd4; i += blockDim.x) {
    const int r = i / nd4, c = i - r * nd4, t = t0 + r;
    dst[r * ld4 + c] =
        t < Tn ? load4_f(src + t * step + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_att_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ bd, int bd_plane, int bd_ld,
                 const uint8_t* __restrict__ mask, int Tn, int H, int dh, float scale,
                 float neg, int round_p, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int ld4 = pitch4(dh), nd4 = dh / 4;
  float4* q_s = smem4;                       // [FA_BQ][ld4]
  float4* k_s = q_s + FA_BQ * ld4;           // [FA_SUB][ld4]
  float4* v_s = k_s + FA_SUB * ld4;          // [FA_SUB][nd4]
  float* p_s = reinterpret_cast<float*>(v_s + FA_SUB * nd4);   // [FA_BQ][FA_PLD]
  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t step = (size_t)H * dh;                        // between time steps
  const size_t base = (size_t)b * Tn * step + (size_t)h * dh;  // (b, t = 0, h, d = 0)
  const T* bd_bh = bd + (size_t)(b * H + h) * bd_plane;
  const uint8_t* mask_b = mask + (size_t)b * Tn;
  const bool owns_cols = 4 * lane < dh;

  stage_rows(q_s, ld4, q + base, step, q0, FA_BQ, Tn, dh);
  float m[FA_RPW], l[FA_RPW];
  float4 acc[FA_RPW];
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    m[rr] = -1e30f;
    l[rr] = 0.f;
    acc[rr] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* qr = q_s + w * FA_RPW * ld4;

  for (int kb = 0; kb < Tn; kb += FA_BLOCK) {
    // scores of this key block: lane l, sub-tile i -> key kb + 32 i + l
    float sc[FA_RPW][FA_NSUB];
#pragma unroll
    for (int i = 0; i < FA_NSUB; ++i) {
      __syncthreads();                       // k_s is free (and q_s staged)
      stage_rows(k_s, ld4, k + base, step, kb + i * FA_SUB, FA_SUB, Tn, dh);
      __syncthreads();
      float dot[FA_RPW];
#pragma unroll
      for (int rr = 0; rr < FA_RPW; ++rr) dot[rr] = 0.f;
      for (int d4 = 0; d4 < nd4; ++d4) {
        const float4 kv = k_s[lane * ld4 + d4];
#pragma unroll
        for (int rr = 0; rr < FA_RPW; ++rr) dot[rr] = dot4(qr[rr * ld4 + d4], kv, dot[rr]);
      }
      const int key = kb + i * FA_SUB + lane;
      const bool keep = key < Tn && mask_b[key];
#pragma unroll
      for (int rr = 0; rr < FA_RPW; ++rr) {
        const int t = min(q0 + w * FA_RPW + rr, Tn - 1);   // rows past T are not written
        const float bias = keep ? to_f(bd_bh[(size_t)t * bd_ld + key]) : neg;
        sc[rr][i] = key < Tn ? __fmul_rn(__fadd_rn(dot[rr], bias), scale) : -INFINITY;
      }
    }
    // online softmax over the block, row by row
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) {
      float mx = sc[rr][0];
#pragma unroll
      for (int i = 1; i < FA_NSUB; ++i) mx = fmaxf(mx, sc[rr][i]);
      const float m_new = fmaxf(m[rr], warp_max(mx));
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
      float* prow = p_s + (w * FA_RPW + rr) * FA_PLD;
#pragma unroll
      for (int i = 0; i < FA_NSUB; ++i) {
        const float p = expf(sc[rr][i] - m_new);        // 0 for keys past T
        psum += p;
        prow[i * FA_SUB + lane] = round_p ? round_bf16(p) : p;
      }
      l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha), warp_sum(psum));
      m[rr] = m_new;
      acc[rr].x *= alpha;
      acc[rr].y *= alpha;
      acc[rr].z *= alpha;
      acc[rr].w *= alpha;
    }
    // p . v, 32 keys at a time
#pragma unroll
    for (int i = 0; i < FA_NSUB; ++i) {
      __syncthreads();                       // v_s is free; p_s rows written
      stage_rows(v_s, nd4, v + base, step, kb + i * FA_SUB, FA_SUB, Tn, dh);
      __syncthreads();
      if (!owns_cols) continue;
      for (int j = 0; j < FA_SUB; j += 4) {
        float4 vj[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) vj[jj] = v_s[(j + jj) * nd4 + lane];
#pragma unroll
        for (int rr = 0; rr < FA_RPW; ++rr) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              p_s + (w * FA_RPW + rr) * FA_PLD + i * FA_SUB + j);
          axpy4(p4.x, vj[0], acc[rr]);
          axpy4(p4.y, vj[1], acc[rr]);
          axpy4(p4.z, vj[2], acc[rr]);
          axpy4(p4.w, vj[3], acc[rr]);
        }
      }
    }
  }

  if (!owns_cols) return;
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    const int t = q0 + w * FA_RPW + rr;
    if (t >= Tn) continue;
    const float denom = fmaxf(l[rr], 1e-30f);   // a fully masked row still has l > 0
    float4 o = acc[rr];
    o.x = __fdiv_rn(o.x, denom);
    o.y = __fdiv_rn(o.y, denom);
    o.z = __fdiv_rn(o.z, denom);
    o.w = __fdiv_rn(o.w, denom);
    *reinterpret_cast<float4*>(out + base + (size_t)t * step + 4 * lane) = o;
  }
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const void* bd,
                         int bd_plane, int bd_ld, const uint8_t* mask, int B, int Tn, int H,
                         int dh, float scale, float neg, int round_p, float* out,
                         cudaStream_t stream) {
  const int ld4 = pitch4(dh);
  const size_t smem = ((size_t)(FA_BQ + FA_SUB) * ld4 + (size_t)FA_SUB * (dh / 4)) *
                          sizeof(float4) + (size_t)FA_BQ * FA_PLD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_att_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + FA_BQ - 1) / FA_BQ, H, B);
  flash_att_kernel<T><<<grid, FA_WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bd, bd_plane, bd_ld, mask, Tn, H, dh,
      scale, neg, round_p, out);
  return cudaGetLastError();
}

}  // namespace port

using namespace port;

// q, k, v [B, T, H, dh] contiguous; bd [B, H, T, T] with unit column stride,
// row stride bd_ld (>= T) and (b, h) plane stride bd_plane (>= T * bd_ld);
// mask [B, T] bytes (0 = masked); out [B, T, H * dh] f32 (16-byte aligned).
// dtype 0 = f32, 1 = bf16 (q, k, v and bd); dh a multiple of 4, at most 128;
// q, k and v aligned to four elements; neg is -1e9 rounded to that type. Returns the CUDA error code.
extern "C" int flash_att_launch(const void* q, const void* k, const void* v, const void* bd,
                                int bd_plane, int bd_ld, const void* mask, int B, int T,
                                int H, int dh, int dtype, float scale, float neg,
                                float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B < 1 || T < 1 || H < 1 || dh < 4 || dh % 4 != 0 || dh > FA_DMAX || bd_ld < T ||
      (size_t)bd_plane < (size_t)T * bd_ld)
    return (int)cudaErrorInvalidValue;
  const uint8_t* m = (const uint8_t*)mask;
  if (dtype == W_F32)
    return (int)launch_flash<float>(q, k, v, bd, bd_plane, bd_ld, m, B, T, H, dh, scale, neg, 0,
                                    out, stream);
  if (dtype == W_BF16)
    return (int)launch_flash<__nv_bfloat16>(q, k, v, bd, bd_plane, bd_ld, m, B, T, H, dh, scale,
                                            neg, 1, out, stream);
  return (int)cudaErrorInvalidValue;
}
