// #33's instantiations under the SABR leg: qmc_model_kernel<SABRQmcLeg, P>
// (qmc_model.cuh) for the 16 payoffs a SABR leg takes, in a source of their own
// so nvcc compiles each family's in parallel.

#include "sabr.cuh"
#include "heston.cuh"  // MC_HESTON_PAYOFFS
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG SABRQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(sabr, MC_HESTON_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
