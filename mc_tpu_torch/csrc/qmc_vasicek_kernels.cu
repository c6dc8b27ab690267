// #33's instantiations under the Vasicek leg: qmc_model_kernel<VasicekQmcLeg,
// P> (qmc_model.cuh) for all 18 payoffs, in a source of their own so nvcc
// compiles each family's in parallel.

#include "vasicek.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG VasicekQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(vasicek, MC_ALL_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
