// #33's instantiations under Bates's Euler leg: qmc_model_kernel<BatesQmcLeg,
// P> (qmc_model.cuh) for the 16 payoffs a Bates leg takes, in a source of their
// own so nvcc compiles each family's in parallel.

#include "bates.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG BatesQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(bates, MC_HESTON_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
