"""Path-simulation kernels: wrappers, plain versions, configuration
(port of ``mc_tpu/ops/path_kernels.py``).

Two kernels live in ``csrc/path_kernels.cu``:

* ``terminal_pair_partials`` (replaces the Pallas kernel at
  ``mc_tpu/ops/path_kernels.py:1015``): one threefry + Box-Muller pair per
  element prices the exact terminal paths ``2e`` and ``2e+1``.
* ``simulate_partials`` (replaces ``mc_tpu/ops/path_kernels.py:395``): the
  exact terminal draw or the log-Euler step loop, with the antithetic leg
  and the control-variate moments fused in.

Each wrapper returns ``(rows, moments)`` f64 partial sums for
``reduce.finish_sum``.  It takes the plain PyTorch version below only when
the parameter tensor it was given lies on the CPU; for a CUDA tensor it
launches the kernel or raises.  The plain versions compute the same f32
values per path as the kernels and add them in f64 per chunk of paths.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops.payoffs import PathPayoff

__all__ = ["KernelConfig", "PARAM_FIELDS", "pack_params", "unpack_params",
           "terminal_pair_partials", "simulate_partials",
           "terminal_pair_partials_plain", "simulate_partials_plain"]

# ---------------------------------------------------------------------------
# Parameter packing: the analogue of __constant__ OptionData
# (trajectories.cuh:12) is a small f32 vector on the device.
# ---------------------------------------------------------------------------

PARAM_FIELDS = (
    "s0", "k", "r", "sigma", "barrier", "p1", "p2", "t", "q",
    "dt", "drift_dt", "vol_dt", "drift_t", "vol_t", "inv_n_steps",
)

# Paths per chunk of the plain versions: bounds their temporaries.
PLAIN_CHUNK = 1 << 20

# Kernel grids are capped so a large run grid-strides; the cap depends on
# nothing but the path count, so the partials' order is fixed.
MAX_BLOCKS = 8192


def pack_params(option, n_steps: int, device="cpu") -> torch.Tensor:
    """OptionParams + derived GBM coefficients as an f32 (15,) tensor.

    Every derived field is computed in f32 in the same order as
    ``mc_tpu.ops.path_kernels.pack_params``, so both packages see the same
    constants.
    """
    s0, t, k, r, sigma, barrier, p1, p2, q = (
        torch.tensor(float(v), dtype=torch.float32) for v in option.astuple())
    n = torch.tensor(float(n_steps), dtype=torch.float32)
    dt = t / n
    vals = dict(
        s0=s0, k=k, r=r, sigma=sigma, barrier=barrier, p1=p1, p2=p2, t=t,
        q=q,
        dt=dt,
        drift_dt=(r - q - 0.5 * sigma * sigma) * dt,
        vol_dt=sigma * torch.sqrt(dt),
        drift_t=(r - q - 0.5 * sigma * sigma) * t,
        vol_t=sigma * torch.sqrt(t),
        inv_n_steps=1.0 / n,
    )
    return torch.stack([vals[name] for name in PARAM_FIELDS]).to(device)


def unpack_params(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in enumerate(PARAM_FIELDS)})


# ---------------------------------------------------------------------------
# Kernel configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False
    with_cv: bool = False         # emit control-variate moment partials
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)
    method: str = "euler"         # "euler" | "terminal"
    start_step: int = 0           # resume: not ported yet
    is_shift: float = 0.0         # importance sampling: not ported yet

    def __post_init__(self):
        if self.method not in ("euler", "terminal"):
            raise ValueError(
                f"unknown method {self.method!r} for the step-loop kernels; "
                "use 'euler' or 'terminal' (method='terminal_pair' is only "
                "available through price())")
        check_rng_source(self.rng_source)
        if self.start_step:
            raise NotImplementedError(
                "resume (start_step/s_init/state_init) is not ported to "
                "mc_tpu_torch yet")
        if self.is_shift:
            raise NotImplementedError(
                "importance sampling (is_shift) is not ported to "
                "mc_tpu_torch yet")
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    @property
    def n_moments(self) -> int:
        return 5 if self.with_cv else 2


def check_rng_source(rng_source: str) -> None:
    if rng_source == "hw":
        raise ValueError(
            "rng_source='hw' is the TPU hardware PRNG and has no counterpart "
            "in mc_tpu_torch yet; use 'threefry13' or 'threefry'")
    if rng_source not in ("threefry13", "threefry"):
        raise ValueError(f"unknown rng_source {rng_source!r}; use "
                         "'threefry13' or 'threefry' (20 rounds)")


def _check_params(params: torch.Tensor) -> None:
    if (params.dtype != torch.float32 or params.shape != (len(PARAM_FIELDS),)
            or not params.is_contiguous()):
        raise ValueError("params must be a contiguous float32 tensor of "
                         f"shape ({len(PARAM_FIELDS)},); got "
                         f"{tuple(params.shape)} {params.dtype}")
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {params.device}")


def _grid(lib, n: int) -> int:
    return min(_cuda.cdiv(n, lib.mc_block_threads()), MAX_BLOCKS)


def _bound(path_offset: int, n_paths: int, n_valid) -> int:
    """The uint32 global path-count bound (ids at or past it are masked)."""
    bound = path_offset + n_paths if n_valid is None else int(n_valid)
    return bound & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels' per-path arithmetic
# ---------------------------------------------------------------------------


def _simulate_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair):
    """Simulate one leg to maturity; returns ``(s_t, state)``.

    ``draw_pair(m) -> (z_2m, z_2m+1)``.  The step loop consumes both
    Box-Muller halves of every threefry call; an odd step count ends with
    the head half of one more pair.
    """
    if cfg.method == "terminal":
        z, _ = draw_pair(0)
        return s0 * torch.exp(p.drift_t + p.vol_t * z), ()

    state = payoff.init(p, torch.zeros_like(s0))
    w = torch.zeros_like(s0)
    s = s0

    def one_step(w, state, z):
        w = w + (p.drift_dt + p.vol_dt * z)
        s = s0 * torch.exp(w)  # log-space: one exp rounding per S_t
        return w, s, payoff.update(state, s, p)

    for m in range(cfg.n_steps // 2):
        z0, z1 = draw_pair(m)
        w, s, state = one_step(w, state, z0)
        w, s, state = one_step(w, state, z1)
    if cfg.n_steps % 2:  # odd step count: epilogue consumes the head half only
        z0, _ = draw_pair(cfg.n_steps // 2)
        w, s, state = one_step(w, state, z0)
    return s, state


def _payoff_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair):
    """One leg and its payoff: ``(payoff, S_T)``; S_T is the control."""
    s_t, state = _simulate_leg(payoff, cfg, p, s0, draw_pair)
    return payoff.terminal(state, s_t, p), s_t


def _terminal_pair_vals(payoff, p, ids_e, bound_paths: int, z0, z1):
    """Per-element [sum, sumsq] of the two terminal-path payoffs."""

    def one(z, pid):
        s_t = p.s0 * torch.exp(p.drift_t + p.vol_t * z)
        return torch.where(pid < bound_paths, payoff.terminal((), s_t, p), 0.0)

    pa = one(z0, 2 * ids_e)
    pb = one(z1, 2 * ids_e + 1)
    return [pa + pb, pa * pa + pb * pb]


def _chunk_row(vals) -> torch.Tensor:
    return torch.stack([v.double().sum() for v in vals])


def terminal_pair_partials_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                                 params: torch.Tensor, n_paths_total: int):
    """Plain version of the terminal_pair kernel: (chunks, 2) f64."""
    p = unpack_params(params)
    k0, k1 = int(key[0]), int(key[1])
    rows = []
    for start in range(0, cfg.n_paths, PLAIN_CHUNK):
        ids_e = torch.arange(start, min(start + PLAIN_CHUNK, cfg.n_paths),
                             dtype=torch.int64, device=params.device)
        z0, z1 = rng.normal_pair(k0, k1, ids_e, torch.zeros_like(ids_e),
                                 rounds=cfg.rng_rounds)
        rows.append(_chunk_row(_terminal_pair_vals(
            payoff, p, ids_e, n_paths_total, z0, z1)))
    return torch.stack(rows)


def simulate_partials_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                            params: torch.Tensor, path_offset: int = 0,
                            n_valid=None):
    """Plain version of the simulate kernel: (chunks, n_moments) f64."""
    p = unpack_params(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for start in range(0, cfg.n_paths, PLAIN_CHUNK):
        local = torch.arange(start, min(start + PLAIN_CHUNK, cfg.n_paths),
                             dtype=torch.int64, device=params.device)
        ids = (local + path_offset) & 0xFFFFFFFF  # uint32 global path ids
        valid = ids < bound

        def draw_pair(m, ids=ids):
            return rng.normal_pair(k0, k1, ids, torch.full_like(ids, m),
                                   rounds=cfg.rng_rounds)

        s0 = p.s0.expand(ids.shape)
        pay, x = _payoff_leg(payoff, cfg, p, s0, draw_pair)
        if cfg.antithetic:
            pay_n, x_n = _payoff_leg(payoff, cfg, p, s0,
                                     lambda m: tuple(-z for z in draw_pair(m)))
            pay = 0.5 * (pay + pay_n)
            x = 0.5 * (x + x_n)
        pay = torch.where(valid, pay, 0.0)
        vals = [pay, pay * pay]
        if cfg.with_cv:
            # Control variate X = terminal price (pair mean if antithetic):
            # E[X] = S0 * exp((r - q) T) exactly under the log-Euler scheme.
            x = torch.where(valid, x, 0.0)
            vals += [x, x * x, pay * x]
        rows.append(_chunk_row(vals))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def terminal_pair_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                           params: torch.Tensor, n_paths_total: int):
    """(rows, 2) f64 [sum, sumsq] over ``cfg.n_paths`` ELEMENTS (two
    terminal paths each); ``n_paths_total`` masks the trailing odd path."""
    _check_params(params)
    if not payoff.terminal_only:
        raise ValueError(f"{payoff.name} is path-dependent; terminal_pair "
                         "needs a terminal-only payoff")
    if not 0 < n_paths_total <= min(2 * cfg.n_paths, 0xFFFFFFFF):
        raise ValueError(f"n_paths_total={n_paths_total} must be in "
                         f"[1, 2 * cfg.n_paths] and below 2^32")
    if params.device.type == "cpu":
        return terminal_pair_partials_plain(payoff, cfg, key, params,
                                            n_paths_total)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_terminal_pair(
            payoff.cuda_id, cfg.rng_rounds, int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_paths, int(n_paths_total),
            partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "terminal_pair kernel")
    _cuda.count_launch("terminal_pair")
    return partials


def simulate_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                      params: torch.Tensor, path_offset: int = 0,
                      n_valid=None, s_init=None, state_init=None):
    """(rows, n_moments) f64 accumulators:
    (sum_pay, sum_pay2[, sum_x, sum_x2, sum_pay_x]).

    ``path_offset``/``n_valid``: global path-id offset of this slice and the
    global path-count bound (defaults to offset + cfg.n_paths).
    """
    _check_params(params)
    if s_init is not None or state_init is not None:
        raise NotImplementedError("resume (s_init/state_init) is not ported "
                                  "to mc_tpu_torch yet")
    if cfg.method == "terminal" and payoff.n_state:
        raise ValueError(f"{payoff.name} is path-dependent; "
                         "method='terminal' invalid")
    if params.device.type == "cpu":
        return simulate_partials_plain(payoff, cfg, key, params, path_offset,
                                       n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    partials = torch.empty((n_blocks, cfg.n_moments), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_simulate_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.method == "euler"),
            int(cfg.antithetic), int(cfg.with_cv), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound,
            partials.data_ptr(), cfg.n_moments, n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "simulate_partials kernel")
    _cuda.count_launch("simulate_partials")
    return partials
