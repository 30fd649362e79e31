// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every library built from this directory exports a plain C interface: each
// launch function enqueues its kernels on the caller's stream and returns
// cudaGetLastError() as an int (0 = launched), which the Python wrapper turns
// into an exception. Nothing here allocates or synchronises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace port {

// weight storage types, as the Python wrappers encode them
enum WType { W_F32 = 0, W_BF16 = 1, W_I8 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

// Round an f32 value to bf16 precision (round to nearest even), kept as f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_op(float v, int bf) {
  return bf ? round_bf16(v) : v;
}

// Four consecutive values widened to f32, from a 16-byte (f32) or 8-byte
// (bf16) aligned address.
__device__ __forceinline__ float4 load4_f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Row pitch of a staged [rows, dh] f32 tile, in float4 units: odd, so that
// 8 lanes reading 8 consecutive rows at one column hit 8 distinct 16-byte
// bank groups.
__host__ __device__ __forceinline__ int pitch4(int dh) { return (dh / 4) | 1; }

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }
__device__ __forceinline__ float silu_f(float v) { return __fmul_rn(v, sigmoid_f(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum over the block; `red` holds >= 32 floats of shared memory. All threads
// get the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (lane < nw) ? red[lane] : 0.f;
  return warp_sum(t);
}

// Max over the block, as block_sum.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = (lane < nw) ? red[lane] : -INFINITY;
  return warp_max(t);
}

// (value, index) argmax step: larger value wins, and on equal values the
// smaller index wins, as jnp.argmax and torch.argmax return the first
// maximal index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

// LayerNorm over rows of D (eps 1e-5), one block a row: a whole row is
// needed for the statistics, so the products that follow read its output
// instead of recomputing it in every block.
constexpr int LN_THREADS = 256;

__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, int D, float* __restrict__ u) {
  __shared__ float red[32];
  const float* xr = x + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += xr[i];
  const float mu = block_sum(s, red) / (float)D;
  float v = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = xr[i] - mu;
    v = fmaf(d, d, v);
  }
  const float var = block_sum(v, red) / (float)D;
  const float inv = 1.0f / sqrtf(var + 1e-5f);
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float y = __fmul_rn(__fmul_rn(xr[i] - mu, inv), g[i]);
    u[(size_t)blockIdx.x * D + i] = __fadd_rn(y, b[i]);
  }
}

inline cudaError_t launch_layernorm(const float* x, int M, int D, const float* g,
                                    const float* b, float* u, cudaStream_t stream) {
  layernorm_kernel<<<M, LN_THREADS, 0, stream>>>(x, g, b, D, u);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Small-M matrix product: out[m, n] = epilogue(sum_k A[m, k] * W[k, n]).
//
// The decode and B=1 streaming shapes have few rows (M <= 8 at B=1) and a
// large weight, so the product is bound by reading W once. To approach the
// HBM rate the weight loads of the whole matrix have to be in flight at
// once, in one wave of blocks: a block owns GEMM_TN = 128 output columns
// (lane l takes the four columns 4l .. 4l + 3, read as one vector of four,
// or two of two, when N and the base allow it) and one GEMM_KSLICE-row slice
// of K; each of its GEMM_KS warps first loads its GEMM_KR rows of the slice
// into registers (widened to f32), then multiplies them with the staged rows
// of A. (Holding more rows of a narrow type packed does not pay: the
// compiler widens them early and the register file, not the loads, then
// limits the blocks in flight.)
// Pass 1 writes the block's partial sums to part[ksplit][M][N]; pass 2, one
// warp per (row, 32-column tile), adds the ksplit partials in a fixed order
// (deterministic) and applies the epilogue, in this order:
//   v = acc * scale[n]; v = addend[m, n] + alpha * v; v = v + bias[n];
//   v = act(v) (ReLU or SiLU); v = round_bf16(v)
// each step only where its pointer / flag is given. A is staged in shared
// memory, rounded to the operand type on load when round_a is set; every
// weight element is read once for all M rows.
// With ARGMAX, pass 2 also writes, per row and 32-column tile, the
// (max, first index) of the tile's columns for the token head [0, ths)
// (blank column less `penalty`) and for the duration head [ths, ths + ndur).
// One launch pair computes up to GEMM_BATCH products of the same A with
// weights of the same shape (the attention block's Q, K and V): blockIdx.z
// picks the weight, its scale and its output.
constexpr int GEMM_NV = 4;                    // columns per lane
constexpr int GEMM_TN = 32 * GEMM_NV;         // columns per block
constexpr int GEMM_KS = 8;                    // warps per block
constexpr int GEMM_KR = 8;                    // K rows per warp
constexpr int GEMM_KSLICE = GEMM_KS * GEMM_KR;
constexpr int GEMM_MR = 8;                    // rows of A per pass
constexpr int GEMM_THREADS = 32 * GEMM_KS;
constexpr int EPI_THREADS = 128;
constexpr int EPI_TILE = 32;                  // columns per epilogue warp
constexpr int GEMM_BATCH = 3;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2 };

// four (two) consecutive weights as one load
template <typename WT> struct Vec4;
template <> struct Vec4<float> { using T = float4; using H = float2; };
template <> struct Vec4<__nv_bfloat16> { using T = uint2; using H = unsigned int; };
template <> struct Vec4<int8_t> { using T = char4; using H = char2; };

__device__ __forceinline__ void unpack4(float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack4(uint2 v, float* o) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}
__device__ __forceinline__ void unpack4(char4 v, float* o) {
  o[0] = (float)v.x; o[1] = (float)v.y; o[2] = (float)v.z; o[3] = (float)v.w;
}

__device__ __forceinline__ void unpack2(float2 v, float* o) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack2(unsigned int v, float* o) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  o[0] = __low2float(b); o[1] = __high2float(b);
}
__device__ __forceinline__ void unpack2(char2 v, float* o) { o[0] = (float)v.x; o[1] = (float)v.y; }

struct GemmBatch {
  int count;                       // 1 <= count <= GEMM_BATCH
  const void* w[GEMM_BATCH];       // [K, N] each, of one storage type
  const float* scale[GEMM_BATCH];  // per-column scale or null
  float* out[GEMM_BATCH];          // [M, N] each
};

struct ArgmaxParts {
  int ths, ndur, blank_id;
  float penalty;
  int ntiles;
  float* tok_val;
  int* tok_idx;
  float* dur_val;
  int* dur_idx;
};

template <typename WT>
__global__ void __launch_bounds__(GEMM_THREADS)
small_m_gemm_partial(const float* __restrict__ A, int M, int K, GemmBatch batch,
                     int N, int round_a, float* __restrict__ part) {
  using V4 = typename Vec4<WT>::T;
  using V2 = typename Vec4<WT>::H;
  __shared__ float a_s[GEMM_MR][GEMM_KSLICE];
  __shared__ float red[GEMM_KS][GEMM_MR][GEMM_TN];
  const int lane = threadIdx.x & 31, kg = threadIdx.x >> 5;
  const int n0 = blockIdx.x * GEMM_TN;
  const int kb0 = blockIdx.y * GEMM_KSLICE;
  const WT* __restrict__ W = static_cast<const WT*>(batch.w[blockIdx.z]);
  part += (size_t)blockIdx.z * gridDim.y * M * N;

  const uintptr_t base = reinterpret_cast<uintptr_t>(W);
  const bool vec4 = N % 4 == 0 && base % sizeof(V4) == 0;
  const bool vec2 = N % 2 == 0 && base % sizeof(V2) == 0;   // e.g. V = 8198
  const int nl = n0 + GEMM_NV * lane;           // this lane's first column
  float w[GEMM_KR][GEMM_NV];
#pragma unroll
  for (int i = 0; i < GEMM_KR; ++i) {
    const int k = kb0 + kg * GEMM_KR + i;
    const WT* row = W + (size_t)k * N + nl;
    if (vec4 && k < K && nl < N) {
      unpack4(*reinterpret_cast<const V4*>(row), w[i]);
    } else if (vec2 && k < K && nl + 2 < N) {
      unpack2(reinterpret_cast<const V2*>(row)[0], w[i]);
      unpack2(reinterpret_cast<const V2*>(row)[1], w[i] + 2);
    } else {
#pragma unroll
      for (int j = 0; j < GEMM_NV; ++j) w[i][j] = (k < K && nl + j < N) ? to_f(row[j]) : 0.f;
    }
  }

  for (int m0 = 0; m0 < M; m0 += GEMM_MR) {
    const int mr = min(GEMM_MR, M - m0);
    for (int i = threadIdx.x; i < GEMM_MR * GEMM_KSLICE; i += blockDim.x) {
      const int r = i / GEMM_KSLICE, k = i - r * GEMM_KSLICE;
      const float v = (r < mr && kb0 + k < K) ? A[(size_t)(m0 + r) * K + kb0 + k] : 0.f;
      a_s[r][k] = round_a ? round_bf16(v) : v;
    }
    __syncthreads();

    float acc[GEMM_MR][GEMM_NV];
#pragma unroll
    for (int r = 0; r < GEMM_MR; ++r)
#pragma unroll
      for (int j = 0; j < GEMM_NV; ++j) acc[r][j] = 0.f;
#pragma unroll
    for (int i = 0; i < GEMM_KR; ++i) {
#pragma unroll
      for (int r = 0; r < GEMM_MR; ++r) {
        const float a = a_s[r][kg * GEMM_KR + i];
#pragma unroll
        for (int j = 0; j < GEMM_NV; ++j) acc[r][j] = fmaf(a, w[i][j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < GEMM_MR; ++r)
#pragma unroll
      for (int j = 0; j < GEMM_NV; ++j) red[kg][r][GEMM_NV * lane + j] = acc[r][j];
    __syncthreads();
    for (int o = threadIdx.x; o < mr * GEMM_TN; o += blockDim.x) {
      const int r = o / GEMM_TN, c = o - r * GEMM_TN;
      if (n0 + c < N) {
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < GEMM_KS; ++g) s += red[g][r][c];
        part[((size_t)blockIdx.y * M + m0 + r) * N + n0 + c] = s;
      }
    }
    __syncthreads();
  }
}

template <bool ARGMAX>
__global__ void __launch_bounds__(EPI_THREADS)
small_m_gemm_epilogue(const float* __restrict__ part, int ksplit, int M, int N,
                      GemmBatch batch, const float* __restrict__ addend, float alpha,
                      const float* __restrict__ bias, int act, int round_out,
                      ArgmaxParts am) {
  const float* scale = batch.scale[blockIdx.z];
  float* out = batch.out[blockIdx.z];
  part += (size_t)blockIdx.z * ksplit * M * N;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (EPI_THREADS / 32) + (threadIdx.x >> 5);
  const int m = blockIdx.y;
  const int n = tile * EPI_TILE + lane;
  if (tile * EPI_TILE >= N) return;         // whole warp past the end
  float v = 0.f;
  if (n < N) {
    float s = 0.f;
#pragma unroll 8
    for (int kb = 0; kb < ksplit; ++kb) s += part[((size_t)kb * M + m) * N + n];
    v = __fmul_rn(s, scale ? scale[n] : 1.f);
    if (addend) v = __fadd_rn(addend[(size_t)m * N + n], __fmul_rn(alpha, v));
    if (bias) v = __fadd_rn(v, bias[n]);
    if (act == ACT_RELU) v = fmaxf(v, 0.f);
    else if (act == ACT_SILU) v = silu_f(v);
    if (round_out) v = round_bf16(v);
    out[(size_t)m * N + n] = v;
  }
  if (ARGMAX) {
    float tv = -INFINITY, dv = -INFINITY;
    int ti = 0x7fffffff, di = 0x7fffffff;
    if (n < N && n < am.ths) {
      tv = (n == am.blank_id) ? __fsub_rn(v, am.penalty) : v;
      ti = n;
    }
    if (n < N && n >= am.ths && n < am.ths + am.ndur) {
      dv = v;
      di = n;
    }
    warp_argmax(tv, ti);
    warp_argmax(dv, di);
    if (lane == 0) {
      const size_t o = (size_t)m * am.ntiles + tile;
      am.tok_val[o] = tv;
      am.tok_idx[o] = ti;
      am.dur_val[o] = dv;
      am.dur_idx[o] = di;
    }
  }
}

// The caller sizes `part` as batch.count * ksplit * M * N floats with
// ksplit = ceil(K / GEMM_KSLICE) (ops/kernels/build.py:gemm_splits).
// Pass 1 alone: the split-K partial sums, for a caller whose own kernel
// reduces them (the conv module's GLU needs columns n and n + N/2 together).
inline cudaError_t launch_gemm_partial(int wtype, const float* A, int M, int K,
                                       GemmBatch batch, int N, int ksplit, int round_a,
                                       float* part, cudaStream_t stream) {
  if (ksplit != (K + GEMM_KSLICE - 1) / GEMM_KSLICE || batch.count < 1 ||
      batch.count > GEMM_BATCH || M < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((N + GEMM_TN - 1) / GEMM_TN, ksplit, batch.count);
  switch (wtype) {
    case W_F32:
      small_m_gemm_partial<float><<<grid, GEMM_THREADS, 0, stream>>>(
          A, M, K, batch, N, round_a, part);
      break;
    case W_BF16:
      small_m_gemm_partial<__nv_bfloat16><<<grid, GEMM_THREADS, 0, stream>>>(
          A, M, K, batch, N, round_a, part);
      break;
    case W_I8:
      small_m_gemm_partial<int8_t><<<grid, GEMM_THREADS, 0, stream>>>(
          A, M, K, batch, N, round_a, part);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Both passes: out = epilogue(A @ W) for each weight of the batch.
template <bool ARGMAX>
inline cudaError_t launch_small_m_gemm(int wtype, const float* A, int M, int K,
                                       GemmBatch batch, int N, int ksplit,
                                       const float* addend, float alpha, const float* bias,
                                       int act, int round_a, int round_out, float* part,
                                       ArgmaxParts am, cudaStream_t stream) {
  if (ARGMAX && batch.count != 1) return cudaErrorInvalidValue;
  cudaError_t err = launch_gemm_partial(wtype, A, M, K, batch, N, ksplit, round_a, part, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (N + EPI_TILE - 1) / EPI_TILE;
  const dim3 blocks((tiles + EPI_THREADS / 32 - 1) / (EPI_THREADS / 32), M, batch.count);
  small_m_gemm_epilogue<ARGMAX><<<blocks, EPI_THREADS, 0, stream>>>(
      part, ksplit, M, N, batch, addend, alpha, bias, act, round_out, am);
  return cudaGetLastError();
}

// Conformer FFN with a scaled residual, y = x + alpha * silu(LN(x) @ W1) @ W2,
// for M rows of width D and expansion E: LayerNorm, then two split-K
// products. With bf16 or int8 weights (bf != 0) the LN output u and
// silu(h) are rounded to bf16, the TPU kernel's operand type; x and y are
// not. u [M, D] and h [M, E] are scratch; part holds
// max(ks1 * E, ks2 * D) * M floats.
inline cudaError_t launch_ffn(const float* x, int M, int D, int E, const float* ln_g,
                              const float* ln_b, const void* w1, const float* s1,
                              const void* w2, const float* s2, int wtype, float alpha,
                              int ks1, int ks2, float* y, float* u, float* h, float* part,
                              cudaStream_t stream) {
  const int bf = wtype != W_F32;
  ArgmaxParts none = {};
  cudaError_t err = launch_layernorm(x, M, D, ln_g, ln_b, u, stream);
  if (err != cudaSuccess) return err;
  const GemmBatch up = {1, {w1}, {s1}, {h}};
  err = launch_small_m_gemm<false>(wtype, u, M, D, up, E, ks1, nullptr, 1.f, nullptr, ACT_SILU,
                                   bf, bf, part, none, stream);
  if (err != cudaSuccess) return err;
  const GemmBatch down = {1, {w2}, {s2}, {y}};
  return launch_small_m_gemm<false>(wtype, h, M, E, down, D, ks2, x, alpha, nullptr, ACT_NONE,
                                    0, 0, part, none, stream);
}

// --- bf16 tensor-core products: mma.sync, ldmatrix, cp.async ---------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// BYTES from src to dst, of which the first src_bytes are read and the rest
// zero-filled (src_bytes = 0: zeros, nothing read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half: two A-operand
// elements of one row, lo at the smaller column
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Does every copy of `bytes` from these bases, stepping by these strides
// (bytes), start on a multiple of `bytes`?
inline bool copies_aligned(int bytes, std::initializer_list<uintptr_t> at) {
  for (uintptr_t a : at)
    if (a % bytes) return false;
  return true;
}

}  // namespace port

extern "C" const char* port_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
