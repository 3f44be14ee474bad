// dg_volume: the DGSEM volume_loop for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dg_volume.py:_volume_kernel
// (reached through dg_volume_pallas).  Per element e, with q[e] = (E_xx, E_yy,
// E_zz, E_yz, E_xz, E_xy, v_x, v_y, v_z) on the M^3 LGL nodes:
//
//   S      = lam * tr(E) * I + 2 mu E                     (6 stored components)
//   out    = ( sym(grad v) (6) , div(S) / rho (3) )
//
// where every derivative along element axis a is the tensor-product
// application of the (M x M) LGL differentiation matrix D times the affine
// metric 2/h_a.  Field layout is the JAX package's: q (K, 9, M, M, M) with
// axes (r1, r2, r3) = (x, y, z), row-major.
//
// What bounds it on the H100: bytes.  In float64 one call reads q and writes
// out, 2 * K * 9 * M^3 * 8 B (604 MB at K = 8192, M = 8, about 0.18 ms at
// 3.35 TB/s), against about 1.4 GFLOP (18 derivatives of 2M flops per node),
// which the FP64 pipes finish in well under that time.
//
// Design: one thread block per element.  The block stages the element's
// 9 * M^3 values (36.9 KB in float64 at M = 8) and D in shared memory with
// coalesced loads, forms S in place of E there, and each thread then produces
// output nodes of all 9 fields, neighbouring threads on neighbouring nodes,
// so every global load and store is coalesced and q is read exactly once.
// The Pallas kernel's kron(I_BE, D) block-diagonal operator exists to fill
// the TPU's 128x128 MXU and is not carried over; nor is its padding of K to
// a multiple of the block (the grid is exactly K blocks).  Simple first:
// no tensor cores, no TMA, no multi-element tiles.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
volume_kernel(const T* __restrict__ q, const T* __restrict__ D,
              const T* __restrict__ rho, const T* __restrict__ lam,
              const T* __restrict__ mu, T* __restrict__ out, int M,
              T metric0, T metric1, T metric2) {
  extern __shared__ unsigned char smem_raw[];
  const int M2 = M * M;
  const int M3 = M2 * M;
  T* s = reinterpret_cast<T*>(smem_raw);  // 9 fields x M^3, S replaces E
  T* sD = s + 9 * M3;                     // D, row-major (M x M)

  const int64_t e = blockIdx.x;
  const T* qe = q + e * 9 * M3;
  T* oe = out + e * 9 * M3;

  for (int i = threadIdx.x; i < 9 * M3; i += blockDim.x) s[i] = qe[i];
  for (int i = threadIdx.x; i < M2; i += blockDim.x) sD[i] = D[i];
  const T r = rho[e];
  const T la = lam[e];
  const T two_mu = T(2) * mu[e];
  __syncthreads();

  // stress in place: each node's six strain values are read and written by
  // the one thread that owns the node
  for (int n = threadIdx.x; n < M3; n += blockDim.x) {
    const T tr = s[n] + s[M3 + n] + s[2 * M3 + n];
    s[n] = la * tr + two_mu * s[n];
    s[M3 + n] = la * tr + two_mu * s[M3 + n];
    s[2 * M3 + n] = la * tr + two_mu * s[2 * M3 + n];
    s[3 * M3 + n] = two_mu * s[3 * M3 + n];
    s[4 * M3 + n] = two_mu * s[4 * M3 + n];
    s[5 * M3 + n] = two_mu * s[5 * M3 + n];
  }
  __syncthreads();

  for (int n = threadIdx.x; n < M3; n += blockDim.x) {
    const int i = n / M2;
    const int j = (n / M) % M;
    const int k = n % M;
    const T* Di = sD + i * M;
    const T* Dj = sD + j * M;
    const T* Dk = sD + k * M;
    const T* line0 = s + j * M + k;    // axis r1: stride M^2
    const T* line1 = s + i * M2 + k;   // axis r2: stride M
    const T* line2 = s + i * M2 + j * M;  // axis r3: stride 1

    // derivative of field f at node n along each axis, times its metric
    auto d0 = [&](int f) {
      T acc = T(0);
      for (int m = 0; m < M; ++m) acc += Di[m] * line0[f * M3 + m * M2];
      return acc * metric0;
    };
    auto d1 = [&](int f) {
      T acc = T(0);
      for (int m = 0; m < M; ++m) acc += Dj[m] * line1[f * M3 + m * M];
      return acc * metric1;
    };
    auto d2 = [&](int f) {
      T acc = T(0);
      for (int m = 0; m < M; ++m) acc += Dk[m] * line2[f * M3 + m];
      return acc * metric2;
    };

    // dv_ac: derivative of v_c along axis a (v_c is field 6 + c)
    const T dv00 = d0(6), dv01 = d0(7), dv02 = d0(8);
    const T dv10 = d1(6), dv11 = d1(7), dv12 = d1(8);
    const T dv20 = d2(6), dv21 = d2(7), dv22 = d2(8);
    oe[n] = dv00;
    oe[M3 + n] = dv11;
    oe[2 * M3 + n] = dv22;
    oe[3 * M3 + n] = T(0.5) * (dv21 + dv12);
    oe[4 * M3 + n] = T(0.5) * (dv20 + dv02);
    oe[5 * M3 + n] = T(0.5) * (dv10 + dv01);
    // div S with S stored (xx, yy, zz, yz, xz, xy)
    oe[6 * M3 + n] = (d0(0) + d1(5) + d2(4)) / r;
    oe[7 * M3 + n] = (d0(5) + d1(1) + d2(3)) / r;
    oe[8 * M3 + n] = (d0(4) + d1(3) + d2(2)) / r;
  }
}

template <typename T>
int launch_volume(const void* q, const void* D, const void* rho,
                  const void* lam, const void* mu, void* out, long long K,
                  int M, double m0, double m1, double m2, void* stream) {
  if (K <= 0) return 0;
  const size_t smem = (size_t(9) * M * M * M + size_t(M) * M) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        volume_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  volume_kernel<T><<<static_cast<unsigned int>(K), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(D),
      static_cast<const T*>(rho), static_cast<const T*>(lam),
      static_cast<const T*>(mu), static_cast<T*>(out), M, static_cast<T>(m0),
      static_cast<T>(m1), static_cast<T>(m2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dg_volume_f64(const void* q, const void* D, const void* rho,
                  const void* lam, const void* mu, void* out, long long K,
                  int M, double m0, double m1, double m2, void* stream) {
  return launch_volume<double>(q, D, rho, lam, mu, out, K, M, m0, m1, m2,
                               stream);
}

int dg_volume_f32(const void* q, const void* D, const void* rho,
                  const void* lam, const void* mu, void* out, long long K,
                  int M, double m0, double m1, double m2, void* stream) {
  return launch_volume<float>(q, D, rho, lam, mu, out, K, M, m0, m1, m2,
                              stream);
}

const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
