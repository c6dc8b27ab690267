// #33's instantiations under Heston's Euler leg: qmc_model_kernel<HestonQmcLeg,
// P> (qmc_model.cuh) for the 16 payoffs a Heston leg takes (every one but the
// two that read sigma), in a source of their own so nvcc compiles each family's
// in parallel.

#include "heston.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG HestonQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(heston, MC_HESTON_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
