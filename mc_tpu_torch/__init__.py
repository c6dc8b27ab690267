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
    heston_greeks(which=("delta", "vega_v0"))  # CRN-FD over a family kernel
    rainbow_greeks()                       # per-asset delta/vega, cega matrix
    cva_greeks(hazard_rate=0.02)           # d(CVA)/d(market), forward mode
    price_nmc_book(OptionParams(k=np.array([95., 105.])))  # a netting set
    chunked_price(checkpoint_path="run.npz", resume=True)  # bitwise resume
    chunked_price(model="heston")          # chunked under a family

The names ``mc_tpu`` loads lazily (its ``__getattr__``) are here too; the
few whose module is still to port raise an AttributeError that names its
ROADMAP item.
"""

from mc_tpu_torch.checkpoint import chunked_price
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (Trajectories, price, price_ladder,
                                  price_portfolio, simulate_trajectories)
from mc_tpu_torch.greeks import (basket_greeks, cva_greeks, greeks,
                                 heston_greeks, merton_greeks, rainbow_greeks,
                                 sabr_greeks, vasicek_greeks)
from mc_tpu_torch.models.basket import (DEMO_BASKET, BasketDynamics,
                                        demo_basket, price_basket)
from mc_tpu_torch.models.bates import (DEMO_BATES, BatesDynamics,
                                       bates_call_cf, price_bates)
from mc_tpu_torch.models.cev import (DEMO_CEV, CEVDynamics,
                                     cev_call_closed_form, price_cev)
from mc_tpu_torch.models.fx import (DEMO_FX, FX_CONTRACTS, FXDynamics,
                                    price_fx, quanto_option_params)
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
from mc_tpu_torch.nmc_book import NMCBookResult, price_nmc_book
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
from mc_tpu_torch.oracle import (PriceResult, bs_call, bs_call_as,
                                 bs_delta_call, bs_digital_call,
                                 bs_down_out_call, bs_gamma, bs_implied_vol,
                                 bs_put, bs_up_out_call, bs_vega, bsv_call,
                                 cnd_as, g2_swaption, g2_swaption_multicurve,
                                 hw_swaption, hw_swaption_multicurve,
                                 margrabe, vasicek_swaption, vasicek_zcb)
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
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
           "heston_greeks", "merton_greeks", "sabr_greeks", "vasicek_greeks",
           "rainbow_greeks", "basket_greeks", "cva_greeks",
           "chunked_price", "NMCResult", "price_nmc_book", "NMCBookResult",
           "ExposureMetrics", "CollateralizedExposure", "coupon_dates",
           "OptionParams", "SimParams", "DEMO_OPTION", "DEMO_SIM",
           "PriceResult", "bs_call", "bs_put", "bs_call_as", "bs_delta_call",
           "cnd_as", "PAYOFFS", "get_payoff", "FX_CONTRACTS",
           "quanto_option_params", "bs_implied_vol", "bs_vega", "bs_gamma",
           "bs_digital_call", "bs_up_out_call", "bs_down_out_call"]

# mc_tpu's lazily loaded names whose module is still to port -> its ROADMAP
# item (ROADMAP.md, queue A).
_UNPORTED = dict.fromkeys(("price_heston_mlmc", "price_mlmc_family"), 16)
_UNPORTED.update(dict.fromkeys(("price_american", "binomial_american"), 17))
_UNPORTED.update(dict.fromkeys((
    "price_bermudan_swaption", "price_swaption_sharded", "price_swaption_qmc",
    "swaption_greeks", "swap_exposure", "bermudan_swaption_bounds",
    "price_bermudan_swaption_qmc", "swap_cva_greeks",
    "bermudan_swaption_exposure", "price_bermudan_hw_swaption",
    "bermudan_hw_swaption_bounds", "bermudan_hw_swaption_exposure",
    "price_hw_swaption_qmc", "price_hw_swaption_sharded", "price_hw_equity",
    "price_bermudan_hw_swaption_qmc", "hw_swap_exposure",
    "hw_swap_book_exposure", "hw_swap_cva_greeks", "hw_swaption_greeks",
    "price_bermudan_g2_swaption", "bermudan_g2_swaption_bounds",
    "bermudan_g2_swaption_exposure", "price_g2_swaption_sharded",
    "g2_swap_exposure", "g2_swap_book_exposure", "g2_swap_cva_greeks",
    "g2_swaption_greeks", "price_g2_swaption_qmc",
    "price_bermudan_g2_swaption_qmc"), 18))
_UNPORTED.update(dict.fromkeys(("calibrate_sabr", "hagan_iv"), 19))


def __getattr__(name):
    if name in _UNPORTED:
        raise AttributeError(
            f"mc_tpu_torch.{name} is not ported yet (ROADMAP item "
            f"{_UNPORTED[name]}); mc_tpu has it")
    raise AttributeError(f"module 'mc_tpu_torch' has no attribute {name!r}")
