"""European swaptions under the Vasicek short rate
(port of the European half of ``mc_tpu/models/swaption.py``).

The Vasicek pair (x, y) = (r - b, int_0^t r du) has an exact joint Gaussian
law over any horizon, so a European swaption prices from one draw at expiry:

    x = x0 e1 + l11 z0,   y = b T + x0 B + (l21 z0 + l22 z1)
    r = x + b,            P(T, T + s) = exp(logA(s) - B(s) r)      (affine)
    pay = max(sign (1 - P_N - K tau sum_j P_j), 0) e^{-y}

with (z0, z1) the threefry-13 pair at counter (id, 0) and the discount
pathwise, so the price finishes with discount 1.  Oracle:
``oracle.vasicek_swaption`` (Jamshidian).

``pack_va_swpt`` packs the 10-float header and the per-coupon (logA_j, B_j)
tables in f32 in ``mc_tpu``'s order; its OU fields come from
``vasicek.ou_chol2``, which matches ``mc_tpu``'s jitted pack.  ``mc_tpu``
packs the swaption eagerly, whose exp, expm1 and tanh round a few ulp
elsewhere (ROADMAP C22), so the port's pack is pinned within measured ulps
and the tests carry ``mc_tpu``'s own pack across (``convert``) where they
compare per-path payoffs.  ``va_swpt_pay`` is the tile of kernel #11
(``ops/fused.py``, ``csrc/rates.cuh`` ``VaSwpt``); ``mc_tpu``'s ``engine``,
``tile_rows`` and ``interpret`` choose between TPU routes of one arithmetic
and are not ported.  The Bermudans, the QMC, the greeks and the exposures
of ``mc_tpu``'s module wait for ROADMAP item 18's second half.
"""

from __future__ import annotations

import dataclasses

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import SimParams
from mc_tpu_torch.engines import STREAM_OUTER, resolve_device
from mc_tpu_torch.models.vasicek import DEMO_VASICEK, VasicekDynamics, ou_chol2
from mc_tpu_torch.oracle import PriceResult, summarize
from mc_tpu_torch.ops.fused import fused_moment_partials
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["SwaptionSpec", "DEMO_SWAPTION", "SWAPTION_TAG", "VA_SWPT_HEADER",
           "pack_va_swpt", "va_swpt_pay", "finish_swaption",
           "price_swaption"]

# rng.derive_key stream tag of the Vasicek swaption (mc_tpu's).
SWAPTION_TAG = 0x5A97
# x0, e1, B, l11, l21, l22, b*T, K*tau, sign, b
VA_SWPT_HEADER = 10


@dataclasses.dataclass(frozen=True)
class SwaptionSpec:
    """Unit-notional swap: fixed ``k_rate`` vs float, payments at
    expiry + i*tenor (i = 1..n_payments)."""

    expiry: float = 1.0
    tenor: float = 0.5
    n_payments: int = 10
    k_rate: float = 0.05
    payer: bool = True

    def validate(self) -> "SwaptionSpec":
        if self.expiry <= 0 or self.tenor <= 0:
            raise ValueError(f"expiry/tenor must be > 0, got "
                             f"({self.expiry}, {self.tenor})")
        if self.n_payments < 1:
            raise ValueError(f"n_payments must be >= 1, "
                             f"got {self.n_payments}")
        return self


DEMO_SWAPTION = SwaptionSpec()


def _f32(v):
    return torch.tensor(float(v), dtype=torch.float32)


def pack_va_swpt(spec: SwaptionSpec, a, b, sigma_r, r0,
                 device="cpu") -> torch.Tensor:
    """The (10 + 2n,) f32 pack of ``mc_tpu``'s ``_pack_va_swpt`` on
    ``device``: the OU step to expiry (``ou_chol2``), b*T, K*tau, the payer
    sign and b; then logA(s_j) and B(s_j) at s_j = tau*j, each field in f32
    in ``mc_tpu``'s order."""
    a, b, sigma_r, r0 = (_f32(v) for v in (a, b, sigma_r, r0))
    e1, big_b, l11, l21, l22 = ou_chol2(a, sigma_r, _f32(spec.expiry))
    tau = _f32(spec.tenor)
    head = [r0 - b, e1, big_b, l11, l21, l22, b * _f32(spec.expiry),
            _f32(spec.k_rate) * tau, _f32(1.0 if spec.payer else -1.0), b]
    logas, bts = [], []
    for j in range(1, spec.n_payments + 1):
        s = tau * j
        bt = -torch.expm1(-a * s) / a
        loga = ((b - sigma_r * sigma_r / (2.0 * a * a)) * (bt - s)
                - sigma_r * sigma_r * bt * bt / (4.0 * a))
        logas.append(loga)
        bts.append(bt)
    return torch.stack(head + logas + bts).to(device)


def va_swpt_pay(n_pay: int, pv: torch.Tensor, ids, k0: int, k1: int):
    """Each path's discounted payer/receiver payoff (``mc_tpu``'s
    ``_va_swpt_tile`` op for op, ``csrc/rates.cuh`` ``VaSwpt``): the pair
    at (id, 0), then x, y, r, the bond loop, max(swap, 0) * exp(-y)."""
    z0, z1 = rng.normal_pair(k0, k1, ids, torch.zeros_like(ids))
    x0 = pv[0]
    x = x0 * pv[1] + pv[3] * z0
    y = (pv[6] + x0 * pv[2]) + (pv[4] * z0 + pv[5] * z1)
    r = x + pv[9]
    h = VA_SWPT_HEADER
    fixed = torch.zeros_like(r)
    for j in range(n_pay):
        p_j = torch.exp(pv[h + j] - pv[h + n_pay + j] * r)
        fixed = fixed + p_j
    swap = (1.0 - p_j - pv[7] * fixed) * pv[8]
    return torch.clamp(swap, min=0.0) * torch.exp(-y)


def finish_swaption(partials: torch.Tensor, n_paths: int) -> PriceResult:
    """PriceResult of a rates tile's moment rows: the discount rides each
    path, so the finish takes discount 1 (in f64)."""
    sums = finish_sum(partials)
    n = torch.tensor(float(n_paths), dtype=torch.float64,
                     device=sums.device)
    return summarize(sums[0], sums[1], n, 1.0)


def price_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                   dyn: VasicekDynamics = DEMO_VASICEK,
                   sim: SimParams = SimParams(n_paths=1 << 20, n_steps=1),
                   *,
                   r0: float = 0.05,
                   seed=None,
                   stream: int = STREAM_OUTER,
                   device="cuda") -> PriceResult:
    """European payer/receiver swaption under Vasicek on ``device``: one
    exact draw of (r, int r) at expiry, the swap's bonds in closed affine
    form, pathwise discounting; ``sim.n_steps`` is ignored.  The key is
    ``rng.derive_key(seed, stream, 0x5A97)`` (``seed`` defaults to
    ``sim.seed``), the stream ``mc_tpu.price_swaption`` draws.  Oracle:
    ``oracle.vasicek_swaption``."""
    spec = spec.validate()
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = rng.derive_key(seed, stream, SWAPTION_TAG)
    dev = resolve_device(device)
    pv = pack_va_swpt(spec, d32.a, d32.b, d32.sigma_r, r0, dev)
    return finish_swaption(fused_moment_partials(
        "va", spec.n_payments, (int(key[0]), int(key[1])), pv, sim.n_paths),
        sim.n_paths)
