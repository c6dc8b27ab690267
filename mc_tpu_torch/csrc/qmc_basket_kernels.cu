// #33's instantiations under the basket's leg at capacity 8 (d <= 8):
// qmc_model_kernel<BasketQmcLeg<8>, P> (qmc_model.cuh) for all 18 payoffs, in a
// source of their own so nvcc compiles each family's in parallel.

#include "basket.cuh"
#include "qmc_model.cuh"

namespace mc {

#define MC_QMC_LEG BasketQmcLeg<8>
MC_DEFINE_QMC_MODEL_LAUNCHER(basket, MC_ALL_PAYOFFS)
#undef MC_QMC_LEG

}  // namespace mc
