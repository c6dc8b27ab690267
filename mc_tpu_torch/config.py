"""Option contract + simulation configuration (port of ``mc_tpu/config.py``).

The contract is the reference's ``OptionData`` struct (``inc/tool.cuh:13-26``)
as a frozen dataclass of plain Python floats; the simulation geometry is a
second frozen dataclass.  Nothing here is traced or learned, so both are
ordinary hashable values: the engines turn them into f32 tensors on the
requested device when they price.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "OptionParams",
    "SimParams",
    "DEMO_OPTION",
    "DEMO_SIM",
]


@dataclasses.dataclass(frozen=True)
class OptionParams:
    """Contract + market parameters.

    Mirrors the market fields of ``OptionData`` (``inc/tool.cuh:13-26``):
    ``S0, T, K, r, v, B, P1, P2``.  The barrier-window bounds ``p1``/``p2``
    are floats; they are integer step counts semantically, compared with
    ``>=``/``<=`` against an f32 step count exactly as the reference does
    (``inc/trajectories.cuh:149``).
    """

    s0: float = 100.0     # spot                  (tool.cuh:14)
    t: float = 1.0        # maturity, years       (tool.cuh:15)
    k: float = 100.0      # strike                (tool.cuh:16)
    r: float = 0.1        # risk-free rate        (tool.cuh:17)
    sigma: float = 0.2    # volatility            (tool.cuh:18 `v`)
    barrier: float = 120.0  # bullet barrier B    (tool.cuh:19)
    p1: float = 10.0      # barrier-window lower  (tool.cuh:20)
    p2: float = 50.0      # barrier-window upper  (tool.cuh:21)
    q: float = 0.0        # continuous dividend yield (beyond the reference)

    def astuple(self):
        return (self.s0, self.t, self.k, self.r, self.sigma,
                self.barrier, self.p1, self.p2, self.q)


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation geometry.

    Mirrors ``N_PATHS``, ``N_PATHS_INNER``, ``N_STEPS`` of ``OptionData``
    (``inc/tool.cuh:22-25``); ``dt`` is derived (= t / n_steps).
    """

    n_paths: int = 100_000        # hello.cu:14
    n_steps: int = 100            # hello.cu:16
    n_paths_inner: int = 1_000    # hello.cu:15
    seed: int = 1234              # wrappers.cuh:41 (outer RNG seed)

    def dt(self, t: float) -> float:
        return t / float(self.n_steps)

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


# The reference demo configuration (hello.cu:5-19): BS call ~= 13.2697.
DEMO_OPTION = OptionParams()
DEMO_SIM = SimParams()
