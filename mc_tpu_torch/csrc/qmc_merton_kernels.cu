// #33's instantiations under Merton's Euler leg: qmc_model_kernel<MertonQmcLeg,
// P> (qmc_model.cuh) for all 18 payoffs, in a source of their own so nvcc
// compiles each family's in parallel.

#include "merton.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG MertonQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(merton, MC_ALL_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
