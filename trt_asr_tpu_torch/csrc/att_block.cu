// Fused conformer attention block for B=1 streaming chunks.
//
// Replaces: trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas (with
// build_rel_selection). Computes, for the Tq (<= 8) new rows x of one layer:
//   u = LN(x); q, k_new, v_new = u @ Wq, u @ Wk, u @ Wv
//   per head: scores[t, s] = ((q+u_bias)[t] . k[s] + (q+v_bias)[t] . pos[r0[s]-t]) / sqrt(dh)
//             over the ring kv cache (C slots) ++ the current rows, masked,
//             softmax, context = p @ v
//   y = x + context @ Wo
// and returns (y, u, k_new, v_new).
//
// Bound on the H100: memory. Per layer at full size (D=1024, C=256, Tq=8) it
// must read the four projection matrices (16.8 MB f32, 4.2 MB int8), the kv
// cache (2.1 MB f32) and the positional table (1.1 MB f32, R=271 rows); the
// arithmetic is ~80 MFLOP, microseconds at any rate. Design: a short chain of
// launches: LayerNorm; split-K small-M products, Q, K and V in one launch
// pair and the out-projection in another, that read each weight byte once
// for all Tq rows (common.cuh); and one block per (head, query row) for the
// attention core, with scores, softmax and probabilities kept in shared
// memory. The TPU kernel's {0,1} selection matmul for the positional term
// becomes a direct index r = r0[s] - t: r0 is derived in-kernel from the
// ring cursor, cache_len and the valid step count, read from device memory
// (no host sync).
//
// Rounding points follow the TPU kernel: with bf16 or int8 weights the
// operands u, q+u_bias, q+v_bias, k, v, the positional term m, the
// probabilities and the context are rounded to bf16; accumulation is f32 and
// the int8 dequant scale multiplies the f32 accumulator. The kv cache is read
// as it is stored, f32 or bf16 (a bf16 encoder state), as the TPU kernel
// reads it: no widened copy is made.
#include "common.cuh"

namespace port {

constexpr int ATT_THREADS = 1024;
constexpr int ATT_TPS = 4;          // lanes per kv slot in the scores

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc, int bf) {
  acc = fmaf(a.x, round_op(b.x, bf), acc);
  acc = fmaf(a.y, round_op(b.y, bf), acc);
  acc = fmaf(a.z, round_op(b.z, bf), acc);
  return fmaf(a.w, round_op(b.w, bf), acc);
}

// One block per (head, query row): grid (H, tq). meta = {cursor, cache_len,
// valid_tq} (int32, device). The work is spread over the block so that each
// thread has few dependent loads in a row (the block is latency-bound):
// scores: ATT_TPS neighbouring lanes per kv slot, each lane a share of the
// slot's key and positional row in 16-byte loads, summed by shuffles;
// softmax over the block; context: thread (g, c) sums the float4 column c
// of the value rows g, g + G, ... and the G group sums are added in a fixed
// order. KT is the kv cache's storage type (float or __nv_bfloat16).
template <typename KT>
__global__ void __launch_bounds__(ATT_THREADS)
rel_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                     const float* __restrict__ v_new, const KT* __restrict__ kv_cache,
                     int C, const float* __restrict__ pos, const float* __restrict__ bias_u,
                     const float* __restrict__ bias_v, const int* __restrict__ meta,
                     int tq, int D, int H, float scale, int bf,
                     float* __restrict__ ctx) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, t = blockIdx.y;
  const int dh = D / H;
  const int S = C + tq;
  float* qu = sm;                 // [dh]
  float* qv = qu + dh;            // [dh]
  float* p = qv + dh;             // [S] scores, then probabilities
  float* red = p + ((S + 3) & ~3); // [4 * ATT_THREADS], 16-byte aligned: reductions,
                                  // context partials
  const int cursor = meta[0], cache_len = meta[1], valid_tq = meta[2];
  const int base = C + tq - 1;
  const int col = h * dh;

  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    const float qq = q[(size_t)t * D + col + d];
    qu[d] = round_op(__fadd_rn(qq, bias_u[col + d]), bf);
    qv[d] = round_op(__fadd_rn(qq, bias_v[col + d]), bf);
  }
  __syncthreads();

  const float4* qu4 = reinterpret_cast<const float4*>(qu);
  const float4* qv4 = reinterpret_cast<const float4*>(qv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % ATT_TPS;
  const int per = dh / (4 * ATT_TPS);             // float4s of a row per lane
  constexpr int SPW = 32 / ATT_TPS;               // slots per warp pass
  float lmax = -INFINITY;
  // warp-uniform loop: every lane takes part in the shuffles
  for (int s0 = warp * SPW; s0 < S; s0 += (blockDim.x >> 5) * SPW) {
    const int s = s0 + lane / ATT_TPS;
    bool ok = false;
    int r0 = 0;
    const KT* crow = nullptr;         // a cache slot's key row, or
    const float* nrow = nullptr;      // a current row's
    if (s < C) {
      const int age = ((cursor - 1 - s) % C + C) % C + 1;
      ok = age <= cache_len;
      r0 = base - age;
      crow = kv_cache + (size_t)s * 2 * D + col;
    } else if (s < S) {
      const int j = s - C;
      ok = j < valid_tq;
      r0 = base + j;
      nrow = k_new + (size_t)j * D + col;
    }
    float a = 0.f, m = 0.f;
    if (ok) {
      const float4* p4 = reinterpret_cast<const float4*>(pos + (size_t)(r0 - t) * D + col);
#pragma unroll 8
      for (int i = sub; i < per * ATT_TPS; i += ATT_TPS) {
        const float4 k = crow ? load4_f(crow + 4 * i) : load4_f(nrow + 4 * i);
        a = dot4(qu4[i], k, a, bf);
        m = dot4(qv4[i], p4[i], m, 0);
      }
    }
#pragma unroll
    for (int off = 1; off < ATT_TPS; off <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      m += __shfl_xor_sync(0xffffffffu, m, off);
    }
    if (sub == 0 && s < S) {
      const float sc = ok ? __fmul_rn(__fadd_rn(a, round_op(m, bf)), scale) : -1e30f;
      p[s] = sc;
      lmax = fmaxf(lmax, sc);
    }
  }
  const float mx = block_max(lmax, red);
  float lsum = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float e = expf(p[s] - mx);
    p[s] = e;
    lsum += e;
  }
  const float sum = block_sum(lsum, red);
  for (int s = threadIdx.x; s < S; s += blockDim.x) p[s] = round_op(p[s] / sum, bf);
  __syncthreads();

  // context = p @ v
  const int dq = dh / 4;
  const int G = blockDim.x / dq;
  const int g = threadIdx.x / dq, c4 = threadIdx.x - g * dq;
  if (g < G) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = g; s < S; s += G) {
      const float4 v = s < C ? load4_f(kv_cache + (size_t)s * 2 * D + D + col + 4 * c4)
                             : load4_f(v_new + (size_t)(s - C) * D + col + 4 * c4);
      const float ps = p[s];
      acc.x = fmaf(ps, round_op(v.x, bf), acc.x);
      acc.y = fmaf(ps, round_op(v.y, bf), acc.y);
      acc.z = fmaf(ps, round_op(v.z, bf), acc.z);
      acc.w = fmaf(ps, round_op(v.w, bf), acc.w);
    }
    reinterpret_cast<float4*>(red)[threadIdx.x] = acc;   // red[g * dh + 4 c4 ...]
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float c = 0.f;
    for (int i = 0; i < G; ++i) c += red[i * dh + d];
    ctx[(size_t)t * D + col + d] = c;
  }
}

}  // namespace port

using namespace port;

// Enqueue the attention block. Weights: wtype 0 = f32, 1 = bf16, 2 = int8
// (then s* are the per-output-channel scales, else null). kv_cache [C, 2D] is
// f32, or bf16 when kv_bf16 is set. q, ctx are [tq, D]
// scratch buffers, part is [3, ksplit, tq, D] (split-K partial sums). Returns
// the CUDA error code of the launches.
extern "C" int att_block_launch(
    const float* x, int tq, int D, int H, const float* ln_g, const float* ln_b,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const float* sq, const float* sk, const float* sv, const float* so, int wtype,
    const float* bias_u, const float* bias_v, const float* pos,
    const void* kv_cache, int kv_bf16, int C, const int* meta, float scale, int ksplit,
    float* y, float* u, float* q, float* k_new, float* v_new, float* ctx, float* part,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int dh = D / H;
  if (tq < 1 || dh * H != D) return (int)cudaErrorInvalidValue;
  // 16-byte loads of key, value and positional rows, ATT_TPS lanes a row:
  // dh % (4 ATT_TPS) == 0 and 16-byte aligned bases (the wrapper checks them)
  if (dh % (4 * ATT_TPS) != 0) return (int)cudaErrorInvalidValue;
  const int bf = wtype != W_F32;
  ArgmaxParts none = {};

  cudaError_t err = launch_layernorm(x, tq, D, ln_g, ln_b, u, stream);
  if (err != cudaSuccess) return (int)err;

  const GemmBatch qkv = {3, {wq, wk, wv}, {sq, sk, sv}, {q, k_new, v_new}};
  err = launch_small_m_gemm<false>(wtype, u, tq, D, qkv, D, ksplit, nullptr, 1.f, nullptr,
                                   ACT_NONE, bf, 0, part, none, stream);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = sizeof(float) * ((size_t)2 * dh + ((C + tq + 3) & ~3) + 4 * ATT_THREADS);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (kv_bf16)
    rel_attention_kernel<<<dim3(H, tq), ATT_THREADS, smem, stream>>>(
        q, k_new, v_new, static_cast<const __nv_bfloat16*>(kv_cache), C, pos, bias_u, bias_v,
        meta, tq, D, H, scale, bf, ctx);
  else
    rel_attention_kernel<<<dim3(H, tq), ATT_THREADS, smem, stream>>>(
        q, k_new, v_new, static_cast<const float*>(kv_cache), C, pos, bias_u, bias_v, meta,
        tq, D, H, scale, bf, ctx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // y = x + (ctx @ Wo) * so
  const GemmBatch out = {1, {wo}, {so}, {y}};
  return (int)launch_small_m_gemm<false>(wtype, ctx, tq, D, out, D, ksplit, x, 1.f, nullptr,
                                         ACT_NONE, bf, 0, part, none, stream);
}
