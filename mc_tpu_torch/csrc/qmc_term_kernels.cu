// #33's instantiations under the term curves' leg: qmc_model_kernel<TermQmcLeg,
// P> (qmc_model.cuh) for all 18 payoffs, in a source of their own so nvcc
// compiles each family's in parallel.

#include "term.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG TermQmcLeg
MC_DEFINE_QMC_MODEL_LAUNCHER(term, MC_ALL_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
