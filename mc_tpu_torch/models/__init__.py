"""Model families beyond the GBM engines (port of ``mc_tpu/models/``).

``gbm``: the GBM step and terminal draw on tensors.  ``heston``: Heston
stochastic volatility, full-truncation Euler and Andersen QE, with its (S,
v, state) trajectories.  ``merton``: Merton jump-diffusion, the exact
terminal draw and the Euler loop.  ``bates``: Bates SVJ, Heston's schemes
with Merton's jump.  ``cev``: CEV local vol, level-space Euler with an
absorbing zero.  ``localvol``: a sigma(S, t) knot surface, log-Euler.
``sabr``: SABR, the log-forward under a CEV backbone and an exact lognormal
vol.  ``term``: per-step rate and vol curves.  ``dividends``: GBM with
discrete cash dividends.  ``vasicek``: equity under Vasicek short rates,
exact in law, discounted pathwise.  ``basket``: a correlated d-asset basket
(d up to 32).  ``rainbow``: payoffs on the order statistics of correlated
assets.  ``fx``: the cross-currency contracts.  ``swaption``,
``hullwhite``, ``g2pp``: the rates desks' European pricers (their
Bermudans, exposures and greeks are still to port: ROADMAP item 18).

The names below are ``mc_tpu.models``'s public names.
"""

from mc_tpu_torch.models.gbm import GBM, gbm_exact_terminal, gbm_log_euler_step
from mc_tpu_torch.models.heston import (DEMO_HESTON, HestonDynamics,
                                        heston_call_cf, price_heston)

from mc_tpu_torch.models.basket import (DEMO_BASKET, BasketDynamics,
                                        price_basket)
from mc_tpu_torch.models.bates import (DEMO_BATES, BatesDynamics,
                                       bates_call_cf, price_bates)
from mc_tpu_torch.models.cev import (DEMO_CEV, CEVDynamics,
                                     cev_call_closed_form, price_cev)
from mc_tpu_torch.models.merton import (DEMO_MERTON, MertonDynamics,
                                        merton_call_closed_form, price_merton)
from mc_tpu_torch.models.rainbow import RAINBOW_PAYOFFS, price_rainbow
from mc_tpu_torch.models.sabr import (DEMO_SABR, SABRDynamics, price_sabr,
                                      sabr_call_hagan, sabr_implied_vol)
from mc_tpu_torch.models.localvol import (DEMO_LOCALVOL, LocalVolSurface,
                                          price_localvol)
from mc_tpu_torch.models.term import DEMO_TERM, TermStructure, price_term
from mc_tpu_torch.models.vasicek import (DEMO_VASICEK, VasicekDynamics,
                                         price_vasicek)

__all__ = ["GBM", "gbm_exact_terminal", "gbm_log_euler_step",
           "HestonDynamics", "DEMO_HESTON", "heston_call_cf",
           "price_heston", "BasketDynamics", "DEMO_BASKET", "price_basket",
           "CEVDynamics", "DEMO_CEV", "cev_call_closed_form", "price_cev",
           "MertonDynamics", "DEMO_MERTON", "merton_call_closed_form",
           "price_merton", "SABRDynamics", "DEMO_SABR", "price_sabr",
           "sabr_call_hagan", "sabr_implied_vol", "price_rainbow",
           "RAINBOW_PAYOFFS", "VasicekDynamics", "DEMO_VASICEK",
           "price_vasicek", "TermStructure", "DEMO_TERM", "price_term",
           "LocalVolSurface", "DEMO_LOCALVOL", "price_localvol",
           "BatesDynamics", "DEMO_BATES", "bates_call_cf", "price_bates"]
