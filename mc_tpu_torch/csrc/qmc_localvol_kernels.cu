// #33's instantiations under the local-vol leg:
// qmc_model_kernel<LocalVolQmcLeg, P> (qmc_model.cuh) for all 18 payoffs, in a
// source of their own so nvcc compiles each family's in parallel.

#include "localvol.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG LocalVolQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(localvol, MC_ALL_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
