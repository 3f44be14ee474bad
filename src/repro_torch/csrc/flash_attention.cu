// flash_attention: blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:_flash_kernel (reached through
// flash_attention_pallas).  For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),
// q head h reading kv head h / (Hq / Hkv):
//
//   s   = (q . k^T) * scale                    in float32, from f32 inputs
//   s   = -1e30 where masked                   causal: kpos > qpos
//                                              window: kpos <= qpos - window
//   out = softmax-weighted sum of v            online: m, l, acc in float32
//   o   = acc / max(l, 1e-30), cast to the input type
//
// with qpos = q_offset + q index.  That is the Pallas kernel's function on
// jnp.repeat-expanded k and v; here GQA is read in place (k and v are never
// expanded in device memory) and q_offset shifts the query positions.
//
// What bounds it on the H100: operations.  At the serving slice's shapes
// (B 2, Hq 28, Hkv 4, S 2048, D 128, bf16, causal) the unmasked pairs need
// about 6.0e10 flops (2 D for q.k and 2 D for p.v each), 0.061 ms at
// 989 TFLOP/s, against 67 MB of q, k, v and o (0.020 ms at 3.35 TB/s).
//
// Design, simple and right first (no tensor cores, no TMA, no warp
// specialisation yet):
// * one block of 256 threads per (batch * q head, 64-row q tile); a loop
//   inside the block walks the 64-row kv tiles, replacing the TPU's
//   sequential kv grid axis; m, l and acc stay in registers in float32;
// * only the kv tiles that can contribute are visited (the Pallas rule):
//   causal stops at the tile holding the last q position of the tile, a
//   window starts at the tile holding the first q position - window + 1,
//   so causal prefill costs the causal minimum;
// * the q tile, one kv tile and the probability tile sit in shared memory
//   as float32, rows padded by one word so the row-strided reads of the
//   score loop fall in distinct banks; K and V take turns in one buffer;
// * thread (ty, tx) owns q rows 2 ty, 2 ty + 1; in q.k^T it owns kv
//   columns tx + 8 j, in p.v output columns tx + 8 j; the row max and row
//   sum reduce over the 8 lanes of tx with shuffles;
// * sequences that are not a multiple of 64 are masked at the edge: keys
//   past Skv score -inf (they add exactly 0), rows past Sq are not written;
// * head dims 32, 64, 80, 128 and 160 are compiled; others are refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile (== kBQ: one tile loader)
constexpr int kThreads = 256;  // 32 row pairs x 8 lanes
constexpr int kRows = 2;       // q rows per thread
constexpr int kCols = kBK / 8; // kv columns per thread
constexpr float kMasked = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a (n_rows, D) matrix into a (64, D + 1) float
// tile; rows past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int n_rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int g = row0 + r;
    dst[r * LD + d] = g < n_rows ? to_f32(src[int64_t(g) * D + d]) : 0.f;
  }
}

__device__ __forceinline__ float max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t(kBQ) * (D + 1) + size_t(kBK) * (D + 1) +
          size_t(kBQ) * (kBK + 1)) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Sq, int Skv, float scale, int causal, int window,
             int q_offset) {
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // (kBQ, LD)
  float* sKV = sQ + kBQ * LD;    // (kBK, LD): K, then V of the same tile
  float* sP = sKV + kBK * LD;    // (kBQ, LP)

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* qp = q + int64_t(bh) * Sq * D;
  const int64_t kv_base = (int64_t(b) * Hkv + hk) * Skv * D;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;
  T* op = o + int64_t(bh) * Sq * D;

  const int tx = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * kRows;

  load_tile<T, D>(sQ, qp, q0, Sq);

  // the kv tiles that can contribute to this q tile
  const int qpos_lo = q_offset + q0;
  const int qpos_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int kv_lo = 0;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, qpos_hi + 1);
  if (window >= 0) kv_lo = max(0, qpos_lo - window + 1);
  const int t_lo = kv_lo / kBK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + kBK - 1) / kBK : t_lo;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<T, D>(sKV, kp, k0, Skv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = sKV[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = qpos_lo + r0 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= Skv) {
          x = -CUDART_INF_F;  // past the sequence: contributes exactly 0
        } else if ((causal && kpos > qpos) ||
                   (window >= 0 && kpos <= qpos - window)) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max8(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(r0 + i) * LP + tx + 8 * j] = p;
      }
      l[i] = l[i] * alpha + sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // K is no longer read, P is complete
    load_tile<T, D>(sKV, vp, k0, Skv);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = sP[(r0 + i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = sKV[c * LD + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      op[int64_t(row) * D + tx + 8 * jj] = from_f32<T>(acc[i][jj] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
             int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, scale,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, double scale,
                 int causal, int window, int q_offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  switch (D) {
    case 32:
      return launch_d<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal,
                             window, q_offset, s);
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal,
                             window, q_offset, s);
    case 80:
      return launch_d<T, 80>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal,
                             window, q_offset, s);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal,
                              window, q_offset, s);
    case 160:
      return launch_d<T, 160>(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal,
                              window, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Sq, int Skv, int D,
                         double scale, int causal, int window, int q_offset,
                         void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale,
                                     causal, window, q_offset, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int D,
                        double scale, int causal, int window, int q_offset,
                        void* stream) {
  return launch_flash<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal,
                             window, q_offset, stream);
}

}  // extern "C"
