"""mc_tpu_torch — Monte Carlo option pricing on PyTorch and CUDA (NVIDIA H100).

The port of ``mc_tpu`` (JAX/Pallas on a TPU), which stays beside it as the
reference.  This package imports ``torch`` and never ``jax`` or ``mc_tpu``.
Its kernels are CUDA C++ in ``csrc/``, built with ``nvcc`` at their first
launch; importing the package builds and loads nothing.

    from mc_tpu_torch import price, price_ladder, price_portfolio, price_nmc
    price()                        # 100k-path European call on "cuda"
    price(device="cpu")            # the plain PyTorch versions
    price(payoff="asian_call_geo_cv", control_variate=True)  # 18 payoffs
    price_ladder([90, 100, 110])   # three strikes on shared paths
    price_portfolio(OptionParams(k=np.array([95., 105.])))  # a book, CRN
    price_nmc(strategy="grid").cva(0.02)   # exposure surface -> CVA
    greeks(which=("delta", "vega"))        # the fused pathwise kernel
    chunked_price(checkpoint_path="run.npz", resume=True)  # bitwise resume
"""

from mc_tpu_torch.checkpoint import chunked_price
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (Trajectories, price, price_ladder,
                                  price_portfolio, simulate_trajectories)
from mc_tpu_torch.greeks import greeks
from mc_tpu_torch.nmc import NMCResult, price_nmc
from mc_tpu_torch.xva import (CollateralizedExposure, ExposureMetrics,
                              coupon_dates)

__all__ = ["price", "price_ladder", "price_portfolio", "price_nmc",
           "simulate_trajectories", "Trajectories", "greeks",
           "chunked_price", "NMCResult", "ExposureMetrics",
           "CollateralizedExposure", "coupon_dates", "OptionParams",
           "SimParams", "DEMO_OPTION", "DEMO_SIM"]
