// dg_flux: the exact (Godunov) Riemann face correction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dg_flux.py:_flux_kernel
// (reached through dg_flux_pallas).  Per face f and face node l, with the
// jumps S_j = S^- - S^+ and v_j = v^- - v^+ across a face of normal
// sign * e_axis:
//
//   k0 = 1 / (rho^- cp^- + rho^+ cp^+)
//   k1 = 1 / max(rho^- cs^- + rho^+ cs^+, 1e-300)  where mu^- > 0, else 0
//   FE (6 strain fields): nonzero only in row/column `axis`
//   Fv (3 velocity fields)
//
// The arithmetic follows the reference oracle
// src/repro/dg/operators.py:riemann_correction, including its 1e-300 clamp of
// the shear denominator (the Pallas kernel clamps at 1e-30).  In float32 the
// clamp rounds to 0, as it does in the oracle; the mu^- > 0 select keeps an
// acoustic face from ever dividing.
//
// Layout: Sm/Sp (F, 6, M*M), vm/vp (F, 3, M*M), mats (F, 8) =
// (rho-, cp-, cs-, mu-, rho+, cp+, cs+, mu+); outputs FE (F, 6, M*M) and
// Fv (F, 3, M*M), all contiguous.
//
// What bounds it on the H100: bytes.  It is pure elementwise work: the
// traction jump across a face of normal e_axis reads row `axis` of S (3 of
// the 6 stored fields) and v (3) on both sides and writes FE (6) and Fv (3).
// In float64 one call at F = 8192, M = 8 moves 21 fields x F x M^2 x 8 B
// plus the material table (88.6 MB, about 0.026 ms at 3.35 TB/s) for a few
// dozen flops per lane.
//
// Design: one thread per (face, lane); consecutive threads take consecutive
// lanes of one face, so every field load and store is coalesced, and the
// eight material scalars of a face are read by its M^2 threads from the
// same cache lines.  axis and sign are runtime arguments: the branch on axis
// is uniform across the grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flux_kernel(const T* __restrict__ Sm, const T* __restrict__ vm,
            const T* __restrict__ Sp, const T* __restrict__ vp,
            const T* __restrict__ mats, T* __restrict__ FE,
            T* __restrict__ Fv, int64_t n_lanes, int MM, int axis, T sign) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_lanes) return;
  const int64_t f = t / MM;
  const int64_t l = t % MM;

  const T* mt = mats + f * 8;
  const T rho_m = mt[0], cp_m = mt[1], cs_m = mt[2], mu_m = mt[3];
  const T rho_p = mt[4], cp_p = mt[5], cs_p = mt[6];
  const T rcp_m = rho_m * cp_m;
  const T rcs_m = rho_m * cs_m;
  const T rcp_p = rho_p * cp_p;
  const T rcs_p = rho_p * cs_p;
  const T k0 = T(1) / (rcp_m + rcp_p);
  const T denom = rcs_m + rcs_p;
  const T clamp = static_cast<T>(1e-300);
  const T k1 = mu_m > T(0) ? T(1) / (denom > clamp ? denom : clamp) : T(0);

  // stored slot of the symmetric (a, b) entry in (xx, yy, zz, yz, xz, xy):
  // a on the diagonal, 6 - a - b off it
  const int a0 = axis, a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
  const int s_aa = a0, s_a1 = 6 - a0 - a1, s_a2 = 6 - a0 - a2;

  const int64_t b6 = f * 6 * MM + l;
  const int64_t b3 = f * 3 * MM + l;
  const T S_aa = Sm[b6 + s_aa * MM] - Sp[b6 + s_aa * MM];
  const T S_a1 = Sm[b6 + s_a1 * MM] - Sp[b6 + s_a1 * MM];
  const T S_a2 = Sm[b6 + s_a2 * MM] - Sp[b6 + s_a2 * MM];
  const T v_0 = vm[b3 + a0 * MM] - vp[b3 + a0 * MM];
  const T v_1 = vm[b3 + a1 * MM] - vp[b3 + a1 * MM];
  const T v_2 = vm[b3 + a2 * MM] - vp[b3 + a2 * MM];

  const T a = k0 * (S_aa + rcp_p * sign * v_0);
  const T fe_1 = T(0.5) * k1 * (S_a1 + rcs_p * sign * v_1);
  const T fe_2 = T(0.5) * k1 * (S_a2 + rcs_p * sign * v_2);
  for (int c = 0; c < 6; ++c) {
    T val = T(0);
    if (c == s_aa) val = a;
    if (c == s_a1) val = fe_1;
    if (c == s_a2) val = fe_2;
    FE[b6 + c * MM] = val;
  }
  Fv[b3 + a0 * MM] = a * rcp_m * sign;
  Fv[b3 + a1 * MM] = k1 * rcs_m * (sign * S_a1 + rcs_p * v_1);
  Fv[b3 + a2 * MM] = k1 * rcs_m * (sign * S_a2 + rcs_p * v_2);
}

template <typename T>
int launch_flux(const void* Sm, const void* vm, const void* Sp, const void* vp,
                const void* mats, void* FE, void* Fv, long long F, int MM,
                int axis, double sign, void* stream) {
  const int64_t n_lanes = int64_t(F) * MM;
  if (n_lanes <= 0) return 0;
  if (axis < 0 || axis > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_lanes + kThreads - 1) / kThreads;
  flux_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Sm), static_cast<const T*>(vm),
      static_cast<const T*>(Sp), static_cast<const T*>(vp),
      static_cast<const T*>(mats), static_cast<T*>(FE), static_cast<T*>(Fv),
      n_lanes, MM, axis, static_cast<T>(sign));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dg_flux_f64(const void* Sm, const void* vm, const void* Sp,
                const void* vp, const void* mats, void* FE, void* Fv,
                long long F, int MM, int axis, double sign, void* stream) {
  return launch_flux<double>(Sm, vm, Sp, vp, mats, FE, Fv, F, MM, axis, sign,
                             stream);
}

int dg_flux_f32(const void* Sm, const void* vm, const void* Sp,
                const void* vp, const void* mats, void* FE, void* Fv,
                long long F, int MM, int axis, double sign, void* stream) {
  return launch_flux<float>(Sm, vm, Sp, vp, mats, FE, Fv, F, MM, axis, sign,
                            stream);
}

}  // extern "C"
