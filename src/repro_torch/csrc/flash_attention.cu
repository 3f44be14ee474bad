// flash_attention: blocked online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:_flash_kernel (reached through
// flash_attention_pallas).  For q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D),
// q head h reading kv head h / (Hq / Hkv):
//
//   s   = (q . k^T) * scale                    in float32
//   s   = -1e30 where masked                   causal: kpos > qpos
//                                              window: kpos <= qpos - window
//   out = softmax-weighted sum of v            online: m, l, acc in float32
//   o   = acc / max(l, 1e-30), cast to the input type
//
// with qpos = q_offset + q index.  That is the Pallas kernel's function on
// jnp.repeat-expanded k and v; here GQA is read in place (k and v are never
// expanded in device memory) and q_offset shifts the query positions.  Only
// the kv tiles that can contribute to a q tile are visited (the Pallas
// rule): causal stops at the tile holding the tile's last q position, a
// window starts at the tile holding its first q position - window + 1, so
// causal prefill costs the causal minimum.  Keys past Skv score -inf (they
// add exactly 0), rows past Sq are not written.  Head dims 32, 64, 80, 128
// and 160 are compiled; others are refused.
//
// What bounds it on the H100: operations.  At the serving slice's shapes
// (B 2, Hq 28, Hkv 4, S 2048, D 128, bf16, causal) the unmasked pairs need
// about 6.0e10 flops (2 D for q.k and 2 D for p.v each), 0.061 ms at
// 989 TFLOP/s, against 67 MB of q, k, v and o (0.020 ms at 3.35 TB/s).
//
// bf16 (flash_attention_bf16): tensor cores, TMA, warp specialisation.
// * Persistent blocks, one per SM, each walking (batch * q head, 128-row q
//   tile) work items, the q tiles last first so the longest causal rows
//   start first.  Three warpgroups: a producer (registers lowered to 24
//   with setmaxnreg) and two consumers (raised to 240), each owning 64 q
//   rows, wgmma's M.
// * One producer thread loads each item's q tile, then its K and V tiles
//   into a two-stage ring, by TMA, 128-byte swizzled, with full and empty
//   mbarriers (K and V apart, so K frees as soon as Q.K^T is done; q frees
//   after the item's last Q.K^T, and the producer runs on into the next
//   item while the consumers finish and store this one).  The tensor maps
//   are built on the host per call; the driver entry point is fetched
//   through the runtime, so no -lcuda.  D is padded to DP, a
//   multiple of 64 columns (one 128-byte swizzle row per 64), by the TMA's
//   zero fill: D 32 and 64 run at DP 64, 80 and 128 at 128, 160 at 192.
//   Zero columns add nothing to q.k, and output columns >= D are not
//   written.  kv tiles are B_K = 128 rows (64 at DP 192, so that q and two
//   K/V stages fit in 227 KB).
// * S = Q.K^T by wgmma m64nB_Kk16, both operands from shared memory, bf16
//   products accumulated in float32 (exact products: the Pallas kernel's
//   float32 q.k^T up to the order of the sums).
// * Online softmax in registers in float32 on the accumulator layout: a
//   row lives on 4 lanes; exp2 on the special function unit with
//   scale * log2(e) folded into one fma per score.  Only the tiles that
//   need it (the diagonal, the window edge, the ragged last tile) are
//   masked; interior tiles run a copy of the softmax with no mask code.
// * O += P.V by wgmma m64nDPk16: P rounded to bf16 in registers is the A
//   operand (the accumulator layout is the A-fragment layout), V is read
//   from shared memory in its stored (kv, D) layout through the transpose
//   bit.  Rounding P moves an output row by at most 2^-8 max|v|.
// * Overlap: each consumer issues tile i's Q.K^T with tile i - 1's P.V and
//   runs tile i's softmax while the P.V runs; the two consumers take turns
//   (named barriers) to issue, so one's softmax meets the other's products.
//
// float32 (flash_attention_f32): no tensor cores (TF32 cannot meet the
// 5e-4 tolerance).  One block of 256 threads per (batch * q head, 64-row q
// tile) loops over 64-row kv tiles staged in shared memory (rows padded by
// one word against bank conflicts; K and V take turns in one buffer);
// thread (ty, tx) owns q rows 2 ty, 2 ty + 1, kv columns tx + 8 j in q.k^T
// and output columns tx + 8 j in p.v, with f32 FMAs; the row max and sum
// reduce over the 8 lanes of tx with shuffles.

#include <cuda.h>
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

template <int D>
struct F32Launch {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
                 int window, int q_offset, cudaStream_t stream) {
    return launch_d<float, D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal,
                              window, q_offset, stream);
  }
};

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, one producer and two consumer warpgroups.

constexpr int kWarpgroup = 128;
constexpr int kBf16Threads = 3 * kWarpgroup;  // producer, consumer 0, 1
constexpr int kStages = 2;                    // depth of the K/V ring
constexpr double kLog2e = 1.4426950408889634;

template <int D>
struct Tiles {
  static constexpr int NC = (D + 63) / 64;  // 64-column chunks of a row
  static constexpr int DP = 64 * NC;        // D padded with zero columns
  static constexpr int BQ = 128;            // q rows per block, 64 a consumer
  static constexpr int BK = DP <= 128 ? 128 : 64;  // kv rows per tile
  static constexpr int Q_BYTES = NC * BQ * 128;
  static constexpr int KV_BYTES = NC * BK * 128;  // one K or one V tile
  static constexpr int BAR_BYTES = 8 * (2 + 4 * kStages);
  // 1024 of slack to align the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "q and two K/V stages must fit in 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of the given parity has completed; a wait that
// outlasts kWaitLimit cycles (about 2 s) traps, so that a fault in the
// pipeline becomes a launch error instead of a hung card
constexpr long long kWaitLimit = 1ll << 32;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kWaitLimit) {
      __trap();
    }
  }
}

// box (c0, c1, c2) of a 3-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of wgmma results above the wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptors, 128-byte swizzle (layout type 1 at bit
// 62), 8-row groups 1024 bytes apart (stride byte offset, bits 32-45).
// K-major (rows of 64 contiguous K elements): the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// N-major (rows of 64 contiguous N elements per k): 64-column chunks
// chunk_bytes apart (leading byte offset, bits 16-29).
__device__ __forceinline__ uint64_t desc_n_major(uint32_t addr, uint32_t chunk_bytes) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(chunk_bytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// 2^x on the special function unit (exp2f without fast math adds a
// denormal guard around it)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), A and B bf16 in shared memory,
// both K-major (no transpose); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16) . B (16 x 128), A and B bf16 in shared memory,
// both K-major (no transpose); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16) . B (16 x 64), A bf16 in registers (the
// accumulator layout), B bf16 in shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), A bf16 in registers (the
// accumulator layout), B bf16 in shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 192, f32) += A (64 x 16) . B (16 x 192), A bf16 in registers (the
// accumulator layout), B bf16 in shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// named barriers 1 and 2 pass the consumers' turn to issue wgmma back
// and forth (barrier 0 is __syncthreads): 128 threads wait, 128 arrive
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// the online softmax of one kv tile: the row max, P = exp2(s * scale_log2
// - m) into sacc (float32), m and l updated; returns the rows' rescale
// factors a0, a1.  An EDGE tile is scaled first and masked in log2 units
// (kMasked, the Pallas kernel's -1e30; -inf past Skv); an interior tile
// has no masked score and folds the scale into one fma per score.
template <int BK, bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], int k0, int qp0, int qp1,
                                             int Skv, int causal, int window,
                                             float scale_log2, float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1,
                                             int cq) {
  if (EDGE) {
    // column c = 8 j + (e & 1) of this thread's share is key k0 + cq + c:
    // past the sequence from c_past on, masked above c_hi or at or below c_lo
    const int kb = k0 + cq;
    const int c_past = Skv - kb;
    const int c_hi0 = causal ? qp0 - kb : INT32_MAX;
    const int c_hi1 = causal ? qp1 - kb : INT32_MAX;
    const int c_lo0 = window >= 0 ? qp0 - window - kb : INT32_MIN;
    const int c_lo1 = window >= 0 ? qp1 - window - kb : INT32_MIN;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1);
        const bool masked = e < 2 ? (c > c_hi0 || c <= c_lo0) : (c > c_hi1 || c <= c_lo1);
        float x = sacc[4 * j + e] * scale_log2;
        x = masked ? kMasked : x;
        x = c >= c_past ? -CUDART_INF_F : x;  // past the sequence: adds exactly 0
        sacc[4 * j + e] = x;
      }
  }
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, EDGE ? mx0 : mx0 * scale_log2);
  const float mn1 = fmaxf(m1, EDGE ? mx1 : mx1 * scale_log2);
  a0 = exp2_approx(m0 - mn0);
  a1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float sc = EDGE ? 1.f : scale_log2;
    sacc[4 * j] = exp2_approx(fmaf(sacc[4 * j], sc, -mn0));
    sacc[4 * j + 1] = exp2_approx(fmaf(sacc[4 * j + 1], sc, -mn0));
    sacc[4 * j + 2] = exp2_approx(fmaf(sacc[4 * j + 2], sc, -mn1));
    sacc[4 * j + 3] = exp2_approx(fmaf(sacc[4 * j + 3], sc, -mn1));
    s0 += sacc[4 * j] + sacc[4 * j + 1];
    s1 += sacc[4 * j + 2] + sacc[4 * j + 3];
  }
  l0 = l0 * a0 + s0;  // this thread's share of the row sum
  l1 = l1 * a1 + s1;
}

// P rounded to bf16 as wgmma's A fragments: k16 block kk is the 8-column
// blocks 2 kk (registers 0, 1) and 2 kk + 1 (registers 2, 3)
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&p)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&oacc)[DP / 2], float a0, float a1) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    oacc[4 * j] *= a0;
    oacc[4 * j + 1] *= a0;
    oacc[4 * j + 2] *= a1;
    oacc[4 * j + 3] *= a1;
  }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, int B, int Hq, int Hkv, int Sq,
                  int Skv, float scale_log2, int causal, int window,
                  int q_offset) {
  using T = Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, NC = T::NC, DP = T::DP;
  extern __shared__ __align__(1024) uint8_t tiles[];
  const uint32_t sQ = (smem_u32(tiles) + 1023u) & ~1023u;  // NC chunks of (BQ, 64)
  const uint32_t sK = sQ + T::Q_BYTES;                      // kStages tiles
  const uint32_t sV = sK + kStages * T::KV_BYTES;
  const uint32_t bar = sV + kStages * T::KV_BYTES;
  // q landed (full) and no longer read (empty); per stage the same for K, V
  const uint32_t q_full = bar, q_empty = bar + 8;
  auto full_k = [&](int s) { return bar + 8 * (2 + s); };
  auto full_v = [&](int s) { return bar + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return bar + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar + 8 * (2 + 3 * kStages + s); };

  // Persistent: block c walks work items c, 2G - 1 - c, 2G + c, ... (G
  // blocks, a snake over rounds of G, for balance).  Item w is q tile
  // n_q_tiles - 1 - w / (B Hq) of head w % (B Hq): the longest causal rows
  // first, and the q heads that share a kv head side by side.
  const int BH = B * Hq;
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int n_work = n_q_tiles * BH;
  const int G = gridDim.x;
  struct Item {
    int bh, kv_head, q0, t_lo, n_tiles;
  };
  auto item = [&](int r, Item& it) {
    const int w = (r & 1) ? r * G + G - 1 - int(blockIdx.x) : r * G + int(blockIdx.x);
    if (w >= n_work) return false;
    it.bh = w % BH;
    it.kv_head = (it.bh / Hq) * Hkv + (it.bh % Hq) / (Hq / Hkv);
    it.q0 = (n_q_tiles - 1 - w / BH) * BQ;
    // the kv tiles that can contribute to this q tile
    const int qpos_lo = q_offset + it.q0;
    const int qpos_hi = q_offset + min(it.q0 + BQ, Sq) - 1;
    int kv_lo = 0;
    int kv_hi = Skv;
    if (causal) kv_hi = min(Skv, qpos_hi + 1);
    if (window >= 0) kv_lo = max(0, qpos_lo - window + 1);
    it.t_lo = kv_lo / BK;
    it.n_tiles = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK - it.t_lo : 0;
    return true;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * kWarpgroup);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2 * kWarpgroup);
      mbar_init(empty_v(s), 2 * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // producer: one thread issues every load, running ahead into the next
    // item as soon as the consumers are done with q
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int j = 0;  // K/V tiles loaded so far: the ring position
      Item it;
      for (int r = 0, n = 0; r * G < n_work; ++r) {
        if (!item(r, it)) continue;
        mbar_wait(q_empty, (n++ & 1) ^ 1);
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(sQ + c * BQ * 128, &tm_q, q_full, 64 * c, it.q0, it.bh);
        for (int i = 0; i < it.n_tiles; ++i, ++j) {
          const int s = j % kStages;
          const uint32_t parity = ((j / kStages) & 1) ^ 1;  // round 0 passes
          const int row = (it.t_lo + i) * BK;
          mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), T::KV_BYTES);
          for (int c = 0; c < NC; ++c)
            tma_load_3d(sK + s * T::KV_BYTES + c * BK * 128, &tm_k, full_k(s), 64 * c,
                        row, it.kv_head);
          mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), T::KV_BYTES);
          for (int c = 0; c < NC; ++c)
            tma_load_3d(sV + s * T::KV_BYTES + c * BK * 128, &tm_v, full_v(s), 64 * c,
                        row, it.kv_head);
        }
      }
    }
  } else {
    // consumer: q rows [64 wg, 64 wg + 64) of each item's tile.  Tile i's
    // scores are computed while tile i - 1's P.V runs on the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / kWarpgroup - 1;
    const int tid = threadIdx.x % kWarpgroup;
    // accumulator layout: this thread holds rows r and r + 8, and in each
    // 8-column block j the columns 8 j + cq and 8 j + cq + 1
    const int r = 16 * (tid / 32) + (tid % 32) / 4;
    const int cq = 2 * (tid % 4);
    const uint32_t q_rows = sQ + 64 * wg * 128;

    float oacc[DP / 2];
    float sacc[BK / 2];
    uint32_t pa[BK / 16][4];
    float m0, m1, l0, l1, a0, a1;
    int wg_qlo, wg_qhi, qp0, qp1;

    // S = Q K^T of ring tile j (issued, not waited for)
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      mbar_wait(full_k(s), (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sacc, desc_k_major(q_rows + c * BQ * 128 + kk * 32),
                   desc_k_major(sK + s * T::KV_BYTES + c * BK * 128 + kk * 32),
                   (c | kk) != 0);
      wgmma_commit();
    };
    // O += P V of ring tile j (issued, not waited for)
    auto issue_pv = [&](int j) {
      const int s = j % kStages;
      mbar_wait(full_v(s), (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(oacc, pa[kk],
                 desc_n_major(sV + s * T::KV_BYTES + kk * 16 * 128, BK * 128));
      wgmma_commit();
    };
    // the softmax of the tile at k0, masked only if it needs the mask for
    // this warpgroup's rows
    auto softmax = [&](int k0) {
      if (k0 + BK > Skv || (causal && k0 + BK - 1 > wg_qlo) ||
          (window >= 0 && k0 <= wg_qhi - window))
        softmax_tile<BK, true>(sacc, k0, qp0, qp1, Skv, causal, window, scale_log2, m0, m1,
                               l0, l1, a0, a1, cq);
      else
        softmax_tile<BK, false>(sacc, k0, qp0, qp1, Skv, causal, window, scale_log2, m0, m1,
                                l0, l1, a0, a1, cq);
    };

    // the two consumers take turns to issue their products, so that one's
    // softmax runs while the other's products keep the tensor cores busy
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) turn_pass(1);  // consumer 0 goes first
    int j = 0;  // K/V tiles consumed so far: the ring position
    Item it;
    for (int rr = 0, n = 0; rr * G < n_work; ++rr) {
      if (!item(rr, it)) continue;
      wg_qlo = q_offset + it.q0 + 64 * wg;  // this warpgroup's positions
      wg_qhi = wg_qlo + 63;
      qp0 = wg_qlo + r;
      qp1 = qp0 + 8;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
      m0 = m1 = kMasked;
      l0 = l1 = 0.f;
      mbar_wait(q_full, n++ & 1);
      const int nt = it.n_tiles;
      if (nt > 0) {
        turn_wait(my_turn);
        issue_s(j);
        turn_pass(their_turn);
        wgmma_wait<0>();
        pin(sacc);
        mbar_arrive(empty_k(j % kStages));
        softmax(it.t_lo * BK);
        pack_p<BK>(pa, sacc);
        for (int i = 1; i < nt; ++i) {
          turn_wait(my_turn);
          issue_s(j + i);
          issue_pv(j + i - 1);
          turn_pass(their_turn);
          wgmma_wait<1>();  // S of tile i; P.V of tile i - 1 still runs
          pin(sacc);
          mbar_arrive(empty_k((j + i) % kStages));
          softmax((it.t_lo + i) * BK);
          wgmma_wait<0>();
          pin(oacc);
          mbar_arrive(empty_v((j + i - 1) % kStages));
          rescale<DP>(oacc, a0, a1);
          pack_p<BK>(pa, sacc);
        }
      }
      mbar_arrive(q_empty);  // every Q.K^T of this item is done
      if (nt > 0) {
        turn_wait(my_turn);
        issue_pv(j + nt - 1);
        turn_pass(their_turn);
        wgmma_wait<0>();
        pin(oacc);
        mbar_arrive(empty_v((j + nt - 1) % kStages));
      }
      j += nt;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f);
      const float d1 = fmaxf(l1, 1e-30f);
      const int row0 = it.q0 + 64 * wg + r;
      const int row1 = row0 + 8;
      __nv_bfloat16* op = o + int64_t(it.bh) * Sq * D;
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) {
        const int col = 8 * jj + cq;
        if (col >= D) continue;
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + int64_t(row0) * D + col) =
              __floats2bfloat162_rn(oacc[4 * jj] / d0, oacc[4 * jj + 1] / d0);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + int64_t(row1) * D + col) =
              __floats2bfloat162_rn(oacc[4 * jj + 2] / d1, oacc[4 * jj + 3] / d1);
      }
    }
    if (wg == 0) turn_wait(1);  // consumer 1's last pass
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// heads x (rows, D) bf16 as a 3-D tensor map read in boxes of box_rows rows
// by 64 columns, 128-byte swizzled; rows and columns out of range read 0
bool encode_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
                int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(D) * 2 * rows};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
                int window, int q_offset, cudaStream_t stream) {
  using T = Tiles<D>;
  const int n_q_tiles = (Sq + T::BQ - 1) / T::BQ;
  if (int64_t(n_q_tiles) * B * Hq > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(&tm_q, q, D, Sq, B * Hq, T::BQ) ||
      !encode_map(&tm_k, k, D, Skv, B * Hkv, T::BK) ||
      !encode_map(&tm_v, v, D, Skv, B * Hkv, T::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_work = int64_t(n_q_tiles) * B * Hq;
  const int grid = static_cast<int>(n_work < n_sm ? n_work : n_sm);  // persistent
  flash_bf16_kernel<D><<<grid, kBf16Threads, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B, Hq, Hkv, Sq, Skv,
      static_cast<float>(scale * kLog2e), causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
struct Bf16Launch {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
                 int window, int q_offset, cudaStream_t stream) {
    return launch_bf16<D>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, window,
                          q_offset, stream);
  }
};

// checks the shape arguments and runs Launch<D>, D one of the compiled dims
template <template <int> class Launch>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
             int Hkv, int Sq, int Skv, int D, double scale, int causal, int window,
             int q_offset, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sc = static_cast<float>(scale);
  switch (D) {
    case 32:
      return Launch<32>::run(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal, window,
                             q_offset, s);
    case 64:
      return Launch<64>::run(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal, window,
                             q_offset, s);
    case 80:
      return Launch<80>::run(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal, window,
                             q_offset, s);
    case 128:
      return Launch<128>::run(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal, window,
                              q_offset, s);
    case 160:
      return Launch<160>::run(q, k, v, o, B, Hq, Hkv, Sq, Skv, sc, causal, window,
                              q_offset, s);
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
  return dispatch<Bf16Launch>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal,
                              window, q_offset, stream);
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int D,
                        double scale, int causal, int window, int q_offset,
                        void* stream) {
  return dispatch<F32Launch>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale, causal,
                             window, q_offset, stream);
}

}  // extern "C"
