"""Nested Monte Carlo of rainbow contracts: exposure of best-of and
worst-of positions on correlated assets (port of ``mc_tpu/nmc_rainbow.py``).

The physics is the basket NMC's (``nmc_basket.BasketNMC``: the d asset
price grids, the inner legs resumed from w_i = log(S_i / s0_i) on the
correlated log-Euler step, the same counters); only the level the payoff
reads changes, the running order statistic max_i S_i or min_i S_i folded in
asset order in place of the weighted sum.  ``extras = (d, agg)``, agg 0 for
max and 1 for min; the kernels read the fold from the extras at run time
(``RainbowFamily`` in ``csrc/basket.cuh``, instantiated in
``csrc/rainbow_nmc_kernels.cu``), so one build serves both.

A rainbow contract is a vanilla payoff on the order statistic
(``RAINBOW_NMC_PAYOFFS``: ``call_on_max`` is ``vanilla_call`` on max_i
S_i); the registry's other payoffs price on the running max.  The EE of
the fully discounted ``call_on_max`` is flat at the Stulz (1982) price.
The LSMC hook (``lsmc_level``) waits for ROADMAP item 17.
"""

from __future__ import annotations

import torch

from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.basket import DEMO_BASKET, BasketDynamics
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_basket import BasketNMC
from mc_tpu_torch.nmc_engine import price_nmc_family, register_nmc_family

__all__ = ["RainbowNMC", "RAINBOW_NMC_PAYOFFS", "RAINBOW_NMC_TAG",
           "FAMILY_RAINBOW", "price_nmc_rainbow"]

# rng.derive_key stream tag of the rainbow NMC (mc_tpu's RainbowNMC.tag).
RAINBOW_NMC_TAG = 0x4A13
# FamilyId of csrc/family.cuh.
FAMILY_RAINBOW = 9
# the folds, as the kernels read extras i[1]
AGGS = {"max": 0, "min": 1}

# rainbow contract -> (order statistic, vanilla payoff on it)
RAINBOW_NMC_PAYOFFS = {
    "call_on_max": ("max", "vanilla_call"),
    "call_on_min": ("min", "vanilla_call"),
    "put_on_max": ("max", "vanilla_put"),
    "put_on_min": ("min", "vanilla_put"),
    "best_of_cash": ("max", "best_of_cash"),
}


class RainbowNMC(BasketNMC):
    """d-asset correlated-GBM physics with an order-statistic level:
    ``extras = (d, agg)``, agg 0 ("max") or 1 ("min")."""

    name = "rainbow"
    tag = RAINBOW_NMC_TAG
    cuda_id = FAMILY_RAINBOW

    def __init__(self, extras: tuple = ()):
        super().__init__(extras)
        if len(self.extras) != 2 or self.extras[1] not in AGGS.values():
            raise ValueError(f"RainbowNMC takes extras (d, agg) with agg 0 "
                             f"(max) or 1 (min); got {self.extras}")

    def level(self, p, lv):
        """The running best-of (agg 0) or worst-of (agg 1) price, folded
        over the assets in order; the weights are ignored."""
        fold = (torch.maximum if self.extras[1] == AGGS["max"]
                else torch.minimum)
        m = lv[0]
        for s in lv[1:]:
            m = fold(m, s)
        return m


def price_nmc_rainbow(option: OptionParams = DEMO_OPTION,
                      basket: BasketDynamics = DEMO_BASKET,
                      sim: SimParams = DEMO_SIM,
                      payoff: str = "call_on_max",
                      *,
                      strategy: str = "grid",
                      stream_outer: int = STREAM_OUTER,
                      stream_inner: int = STREAM_INNER,
                      device="cuda") -> NMCResult:
    """Nested MC surface of a rainbow contract on d correlated assets on
    ``device``: ``payoff`` takes the rainbow names (``RAINBOW_NMC_PAYOFFS``)
    or a registry payoff, which then reads the running max.  ``strategy``:
    "grid" (the generic trajectories kernel storing the d asset grids, then
    the inner kernel; the result carries S_1's grid as ``spot_surface``) or
    "fused" (one kernel); both give bitwise equal surfaces."""
    agg, po = RAINBOW_NMC_PAYOFFS.get(payoff, ("max", payoff))
    b32 = basket.as_f32()
    return price_nmc_family(RainbowNMC(extras=(b32.d, AGGS[agg])), option,
                            b32, sim, po, strategy=strategy,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _rainbow_builder(option, dyn, sim):
    b32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
    return RainbowNMC(extras=(b32.d, AGGS["max"])), b32


register_nmc_family("rainbow", price_nmc_rainbow, _rainbow_builder)
