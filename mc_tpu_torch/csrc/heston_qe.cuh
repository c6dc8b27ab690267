// The QE legs of the Heston and Bates partials kernels (#12's
// heston_qe_kernel, heston_qe_kernels.cu; #16's bates_qe_kernel,
// bates_qe_kernels.cu): a step of one path's legs in lockstep (the path,
// and its antithetic twin where the kernel is the antithetic one) on the
// branch-split QE step of heston.cuh, and the payoff state a leg keeps.
//
// The uniform of the exponential sampler is drawn only where a leg takes
// that sampler (psi > 1.5 or NaN): once for the path, the twin reading 1 - u,
// as the plain version's twin does.  Under the demo dynamics (xi 0.3, kappa
// 2, theta 0.04) psi never exceeds psi(0) = xi^2 / (2 kappa theta) = 0.5625,
// so no step of the main shape draws it.
//
// The spot S = base * expf(w) is formed only where the payoff reads it:
// the legs keep their payoff state by barrier.cuh's block_below_max,
// leg_update and leg_end_spot, as the Euler kernel's do.
#pragma once

#include <cstdint>

#include "barrier.cuh"
#include "heston.cuh"
#include "payoffs.cuh"

namespace mc {

// One QE step of L legs from their normals (z_v, z_s); draw_u() gives the
// path's uniform, called only where some leg takes the exponential sampler.
template <int L, class DrawU>
__device__ __forceinline__ void qe_legs_step(const HestonParams& h, const QeConsts& c,
                                             const float (&z_v)[L], const float (&z_s)[L],
                                             DrawU draw_u, float (&w)[L], float (&v)[L]) {
  QeMoments q[L];
  bool exponential = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    q[l] = qe_moments(h, c, v[l]);
    exponential = exponential || !qe_quadratic(q[l]);
  }
  float u = 0.0f;
  if (exponential) u = draw_u();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float v_next, k0_eff;
    if (qe_quadratic(q[l])) {
      qe_quadratic_step(c, q[l], v[l], z_v[l], v_next, k0_eff);
    } else {
      qe_exponential_step(c, q[l], v[l], l == 0 ? u : 1.0f - u, v_next, k0_eff);
    }
    qe_advance(c, v[l], v_next, k0_eff, z_s[l], w[l]);
    v[l] = v_next;
  }
}

}  // namespace mc
