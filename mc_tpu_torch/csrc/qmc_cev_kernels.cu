// #33's instantiations under the CEV leg: qmc_model_kernel<CEVQmcLeg, P>
// (qmc_model.cuh) for the 16 payoffs a CEV leg takes, in a source of their own
// so nvcc compiles each family's in parallel.

#include "cev.cuh"
#include "heston.cuh"  // MC_HESTON_PAYOFFS
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG CEVQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(cev, MC_HESTON_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
