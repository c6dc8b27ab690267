"""Nested Monte Carlo on a correlated d-asset basket
(port of ``mc_tpu/nmc_basket.py:44-280``).

The conditional value of a basket position depends on every asset level,
not just the basket level, so the engine's market grids are the d per-asset
price grids S_1..S_d (``n_grids = d``, the family's extras ``(d,)``) and the
inner legs resume each asset from w_i = log(S_i / s0_i) and rerun the
correlated log-Euler step of ``models.basket`` (``mix_step``).  The outer
grids come from the engine's generic ``family_trajectories`` (``mc_tpu``
builds them with its XLA scan); the basket level rides the outer carry, so
the outer payoff reads the level the last step fed the payoff.

Margrabe exposure falls out: weights (1, -1) and strike 0 make the basket
level S1 - S2, so ``vanilla_call`` is the exchange option and its EE profile
is flat at the Margrabe (1978) closed form.

Counters, as in ``price_basket``: outer step j takes pairs ``j*ceil(d/2) +
q``; inner leg m at point (i, j) takes pairs ``c_base + u*ceil(d/2) + q``,
``c_base = ((j+1)*n_inner + m) * n_steps*ceil(d/2)``.  At d = 1 that is one
pair a step, only its first normal used: not the GBM layout, so d = 1 agrees
with GBM NMC in law, not bit for bit.  The LSMC and rollout hooks of
``mc_tpu``'s BasketNMC are not ported (ROADMAP item 17).
"""

from __future__ import annotations

import torch

from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.basket import (DEMO_BASKET, FAMILY_BASKET,
                                        BASKET_TAG, BasketDynamics,
                                        basket_leg, basket_normals,
                                        basket_of, check_basket_params,
                                        levels, mix_step, pack_basket,
                                        unpack_basket)
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["BasketNMC", "price_nmc_basket"]


class BasketNMC(NMCFamily):
    """d-asset correlated-GBM physics for the engine: market grids (S_1,
    ..., S_d); ``extras = (d,)``."""

    name = "basket"
    tag = BASKET_TAG
    even_steps = False
    cuda_id = FAMILY_BASKET

    legs_cap8 = 2  # csrc kLegs at capacity 8; capacity 32 runs one

    @property
    def d(self) -> int:
        return self.extras[0]

    @property
    def legs(self) -> int:
        return self.legs_cap8 if self.d <= 8 else 1

    @property
    def n_grids(self) -> int:
        return self.extras[0]

    @property
    def _npps(self) -> int:
        return (self.d + 1) // 2

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * n_steps * self._npps,
                "(n_steps+1)*n_inner*n_steps*ceil(d/2)")

    def counter_stride(self, n_steps):
        return n_steps * self._npps

    def pack(self, option, dyn, n_steps, device):
        return pack_basket(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_basket(params, self.d)

    def check_params(self, params, n_steps):
        check_basket_params(params, self.d)

    def level(self, p, lv):
        """The level the payoff reads from the asset prices ``lv``: the
        weighted sum B (the rainbow NMC folds max or min instead)."""
        return basket_of(p, lv)

    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        ws = zero.expand(self.d, *zero.shape)
        return ws, self.level(p, levels(p, ws)), payoff.init(p, zero)

    def outer_draws(self, k0, k1, ids, steps):
        # step j's d normals, drawn when the step asks for them (index j)
        return (_StepNormals(k0, k1, ids, self._npps, self.d),)

    def outer_step(self, payoff, p, carry, draws):
        ws, _, state = carry
        ws = mix_step(p, ws, draws[0])
        lv = levels(p, ws)
        b = self.level(p, lv)
        state = payoff.update(state, b, p)
        word0 = state[0] if payoff.n_state else torch.zeros_like(b)
        return (ws, b, state), (*lv, word0)

    def outer_pay(self, payoff, p, carry):
        _, b, state = carry
        return payoff.terminal(state, b, p)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        ws = torch.stack([torch.log(g / p.s0s[i])
                          for i, g in enumerate(grids_j)])
        if not remaining:
            return payoff.terminal(state_j, self.level(p, levels(p, ws)), p)
        _, _, b, state = basket_leg(
            payoff, p, lambda c: basket_normals(k0, k1, ids, c, p.d), c_base,
            remaining, ws, state_j, level=self.level)
        return payoff.terminal(state, b, p)


class _StepNormals:
    """``[j]``: the (d, *ids.shape) normals of outer step j (pairs j*npps +
    q), so the plain trajectories hold one step's draws at a time."""

    def __init__(self, k0, k1, ids, npps, d):
        self.k0, self.k1, self.ids, self.npps, self.d = k0, k1, ids, npps, d

    def __getitem__(self, j):
        return basket_normals(self.k0, self.k1, self.ids, j * self.npps,
                              self.d)


def price_nmc_basket(option: OptionParams = DEMO_OPTION,
                     basket: BasketDynamics = DEMO_BASKET,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     strategy: str = "grid",
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER,
                     device="cuda") -> NMCResult:
    """Nested MC price surface on a correlated d-asset basket: every (path,
    step) point re-priced by ``sim.n_paths_inner`` inner legs resumed from
    the stored asset prices (S_1..S_d) and payoff state; weights may be
    signed (weights (1, -1) and k = 0 give Margrabe exchange exposure).
    ``strategy``: "grid" (the generic trajectories kernel storing the d
    asset grids, then the inner kernel; the result carries S_1's grid as
    ``spot_surface``) or "fused" (one kernel)."""
    b32 = basket.as_f32()
    return price_nmc_family(BasketNMC(extras=(b32.d,)), option, b32, sim,
                            payoff, strategy=strategy,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _basket_builder(option, dyn, sim):
    b32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
    return BasketNMC(extras=(b32.d,)), b32


register_nmc_family("basket", price_nmc_basket, _basket_builder)
