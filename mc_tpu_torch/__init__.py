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
    price_heston(scheme="qe")              # Heston, Andersen QE
    price_nmc_heston().cva(0.02)           # exposure under stochastic vol
    price_merton(method="terminal")        # Merton jump-diffusion
    price_bates(scheme="qe")               # Bates SVJ (Heston + jumps)
    price_nmc_bates().cva(0.02)            # exposure under vol and jumps
    price_cev()                            # CEV local vol (the skew)
    price_localvol(surf=LocalVolSurface.demo(100))  # a sigma(S, t) smile
    price_nmc_localvol().cva(0.02)         # exposure under the smile
    price_sabr(payoff="asian_call")        # SABR, on the forward path
    price_term(term=TermStructure.from_knots([0.1, 0.05], [0.2, 0.3], 100))
    price_divs(divs=div_schedule(100, [49], [5.0]))  # a cash dividend
    price_nmc_sabr().cva(0.02)             # exposure under SABR
    price_vasicek(payoff="zcb")            # stochastic rates, pathwise discount
    price_nmc_vasicek().cva(0.02)          # exposure under Vasicek rates
    price_basket(basket=demo_basket(8, 0.3))  # a correlated 8-asset basket
    price_nmc_basket().cva(0.02)           # basket exposure, d asset grids
    price_rainbow(payoff="call_on_max")    # best-of on correlated assets
    price_nmc_rainbow().cva(0.02)          # best-of exposure
    price_fx(contract="quanto_call")       # cross-currency contracts
    price_qmc(family="sobol", bridge=True, payoff="asian_call")  # RQMC
    price_swaption(SwaptionSpec(payer=False))  # Vasicek European swaption
    price_hw_swaption(projection_curve=DiscountCurve.flat(0.045))  # on a curve
    price_g2_swaption()                    # G2++ two-factor, curve-fitted
    greeks(which=("delta", "vega"))        # the fused pathwise kernel
    chunked_price(checkpoint_path="run.npz", resume=True)  # bitwise resume
"""

from mc_tpu_torch.checkpoint import chunked_price
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (Trajectories, price, price_ladder,
                                  price_portfolio, simulate_trajectories)
from mc_tpu_torch.greeks import greeks
from mc_tpu_torch.models.basket import (DEMO_BASKET, BasketDynamics,
                                        demo_basket, price_basket)
from mc_tpu_torch.models.bates import (DEMO_BATES, BatesDynamics,
                                       bates_call_cf, price_bates)
from mc_tpu_torch.models.cev import (DEMO_CEV, CEVDynamics,
                                     cev_call_closed_form, price_cev)
from mc_tpu_torch.models.fx import DEMO_FX, FXDynamics, price_fx
from mc_tpu_torch.models.g2pp import DEMO_G2, G2Dynamics, price_g2_swaption
from mc_tpu_torch.models.hullwhite import (DEMO_CURVE, DEMO_HW, DiscountCurve,
                                           HullWhiteDynamics,
                                           price_hw_swaption)
from mc_tpu_torch.models.dividends import (bs_call_cash_div,
                                           cash_div_forward, div_schedule,
                                           price_divs)
from mc_tpu_torch.models.heston import (DEMO_HESTON, HestonDynamics,
                                        heston_call_cf, price_heston)
from mc_tpu_torch.models.localvol import (DEMO_LOCALVOL, LocalVolSurface,
                                          price_localvol)
from mc_tpu_torch.models.merton import (DEMO_MERTON, MertonDynamics,
                                        merton_call_closed_form, price_merton)
from mc_tpu_torch.models.sabr import (DEMO_SABR, SABRDynamics, price_sabr,
                                      sabr_call_hagan, sabr_implied_vol)
from mc_tpu_torch.models.rainbow import price_rainbow
from mc_tpu_torch.models.swaption import (DEMO_SWAPTION, SwaptionSpec,
                                          price_swaption)
from mc_tpu_torch.models.term import DEMO_TERM, TermStructure, price_term
from mc_tpu_torch.models.vasicek import (DEMO_VASICEK, VasicekDynamics,
                                         price_vasicek)
from mc_tpu_torch.nmc import NMCResult, price_nmc
from mc_tpu_torch.nmc_engine import price_nmc_family
from mc_tpu_torch.nmc_basket import price_nmc_basket
from mc_tpu_torch.nmc_bates import price_nmc_bates
from mc_tpu_torch.nmc_cev import price_nmc_cev
from mc_tpu_torch.nmc_heston import price_nmc_heston
from mc_tpu_torch.nmc_localvol import price_nmc_localvol
from mc_tpu_torch.nmc_merton import price_nmc_merton
from mc_tpu_torch.nmc_rainbow import price_nmc_rainbow
from mc_tpu_torch.nmc_sabr import price_nmc_sabr
from mc_tpu_torch.nmc_term import price_nmc_term
from mc_tpu_torch.nmc_vasicek import price_nmc_vasicek
from mc_tpu_torch.oracle import (bsv_call, g2_swaption, g2_swaption_multicurve,
                                 hw_swaption, hw_swaption_multicurve,
                                 margrabe, vasicek_swaption, vasicek_zcb)
from mc_tpu_torch.qmc import price_qmc, price_qmc_model
from mc_tpu_torch.xva import (CollateralizedExposure, ExposureMetrics,
                              coupon_dates)

__all__ = ["price", "price_ladder", "price_portfolio", "price_nmc",
           "price_heston", "price_nmc_heston", "price_nmc_family",
           "HestonDynamics", "DEMO_HESTON", "heston_call_cf",
           "price_merton", "price_nmc_merton", "MertonDynamics",
           "DEMO_MERTON", "merton_call_closed_form", "price_bates",
           "price_nmc_bates", "BatesDynamics", "DEMO_BATES", "bates_call_cf",
           "price_cev", "price_nmc_cev", "CEVDynamics", "DEMO_CEV",
           "cev_call_closed_form", "price_localvol", "price_nmc_localvol",
           "LocalVolSurface", "DEMO_LOCALVOL", "price_sabr",
           "price_nmc_sabr", "SABRDynamics", "DEMO_SABR", "sabr_call_hagan",
           "sabr_implied_vol", "price_term", "price_nmc_term",
           "TermStructure", "DEMO_TERM", "price_divs", "div_schedule",
           "bs_call_cash_div", "cash_div_forward", "price_vasicek",
           "price_nmc_vasicek", "VasicekDynamics", "DEMO_VASICEK",
           "vasicek_zcb", "bsv_call", "price_basket", "price_nmc_basket",
           "BasketDynamics", "DEMO_BASKET", "demo_basket", "margrabe",
           "price_rainbow", "price_nmc_rainbow", "price_fx", "FXDynamics",
           "DEMO_FX", "price_qmc", "price_qmc_model", "price_swaption",
           "SwaptionSpec", "DEMO_SWAPTION", "vasicek_swaption",
           "price_hw_swaption", "DiscountCurve", "HullWhiteDynamics",
           "DEMO_CURVE", "DEMO_HW", "hw_swaption", "hw_swaption_multicurve",
           "price_g2_swaption", "G2Dynamics", "DEMO_G2", "g2_swaption",
           "g2_swaption_multicurve",
           "simulate_trajectories", "Trajectories", "greeks",
           "chunked_price", "NMCResult", "ExposureMetrics",
           "CollateralizedExposure", "coupon_dates", "OptionParams",
           "SimParams", "DEMO_OPTION", "DEMO_SIM"]
