"""Path-simulation kernels: wrappers, plain versions, configuration
(port of ``mc_tpu/ops/path_kernels.py``).

Three kernels live in ``csrc/path_kernels.cu``, two in
``csrc/batch_kernels.cu`` and one in ``csrc/greek_kernels.cu``:

* ``terminal_pair_partials`` (replaces the Pallas kernel at
  ``mc_tpu/ops/path_kernels.py:1015``): one threefry + Box-Muller pair per
  element prices the exact terminal paths ``2e`` and ``2e+1``.
* ``simulate_partials`` (replaces ``mc_tpu/ops/path_kernels.py:395``): the
  exact terminal draw or the log-Euler step loop, with the antithetic leg,
  the control-variate moments, importance sampling and resume from stored
  per-path states fused in.
* ``simulate_trajectories`` (replaces ``mc_tpu/ops/path_kernels.py:524``):
  the log-Euler loop that stores the price and payoff state after every
  step, step-major ``(n_steps, n_paths)``, plus the payoff partials.
* ``simulate_ladder_partials`` (replaces ``mc_tpu/ops/path_kernels.py:634``):
  one simulation per path, M strikes evaluated on it.
* ``simulate_book_partials`` (replaces ``mc_tpu/ops/path_kernels.py:760``):
  B contracts, each with its own parameter row, on the same draws (common
  random numbers), the draws made once and replayed for every contract.
* ``simulate_greek_partials`` (replaces ``mc_tpu/ops/path_kernels.py:932``):
  simulate's leg carrying the pathwise tangents of the payoff with respect
  to (s0, sigma, r, q), ten moments (pay, delta, vega, rho', epsilon) x
  (sum, sumsq).

Each wrapper returns f64 partial sums, one row per block (``(rows,
moments)``, or ``(rows, M|B, moments)`` for the ladder and the book), for
``reduce.finish_sum``.  It takes the plain PyTorch version below only when
the parameter tensor it was given lies on the CPU; for a CUDA tensor it
launches the kernel or raises.  The plain versions compute the same f32
values per path as the kernels and add them in f64 per chunk of paths.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops.payoffs import PATHWISE, PathPayoff

__all__ = ["KernelConfig", "PARAM_FIELDS", "pack_params", "pack_params_rows",
           "unpack_params", "terminal_pair_partials", "simulate_partials",
           "simulate_trajectories", "simulate_ladder_partials",
           "simulate_book_partials", "book_block_threads",
           "simulate_greek_partials",
           "terminal_pair_partials_plain", "simulate_partials_plain",
           "simulate_trajectories_plain", "simulate_ladder_partials_plain",
           "simulate_book_partials_plain", "simulate_greek_partials_plain",
           "path_chunks", "step_normals", "simulate_leg", "moment_row"]

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
# Bytes of the normals the plain book keeps per chunk, replayed per contract.
PLAIN_BOOK_DRAW_BYTES = 1 << 28

# The book kernel's block: its normal buffer (8 bytes per path and pair of
# steps) and its reduction buffer (5 f64 moments x 256 threads, reduce.cuh)
# must fit the 227 KB of shared memory an H100 block may hold.
BOOK_SMEM_BYTES = 232_448
BOOK_REDUCE_BYTES = 5 * 8 * 256
BOOK_MAX_THREADS = 256


def _pack(fields, n_steps: int) -> torch.Tensor:
    """The 15 packed fields from the 9 option fields (f32 tensors of one
    shape), stacked along a new last axis."""
    s0, t, k, r, sigma, barrier, p1, p2, q = fields
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
        inv_n_steps=(1.0 / n).expand(s0.shape),
    )
    return torch.stack([vals[name] for name in PARAM_FIELDS], dim=-1)


def pack_params(option, n_steps: int, device="cpu") -> torch.Tensor:
    """OptionParams + derived GBM coefficients as an f32 (15,) tensor.

    Every derived field is computed in f32 in the same order as
    ``mc_tpu.ops.path_kernels.pack_params``, so both packages see the same
    constants.  Fields are floats or 0-d tensors; a tensor that requires
    grad keeps its graph (the same f32 operations on the host, so the same
    bits as from a float).
    """
    fields = [v.to("cpu", torch.float32) if torch.is_tensor(v)
              else torch.tensor(float(v), dtype=torch.float32)
              for v in option.astuple()]
    return _pack(fields, n_steps).to(device)


def pack_params_rows(options, n_steps: int, device="cpu") -> torch.Tensor:
    """A book's parameter rows, ``(B, 15)`` f32: ``options`` is an
    OptionParams whose fields are floats or ``(B,)`` arrays or tensors
    (scalars broadcast to B).  Row b equals ``pack_params`` of contract b
    bit for bit: the same f32 operations, elementwise."""
    fields = [torch.as_tensor(v.detach().cpu() if torch.is_tensor(v) else v,
                              dtype=torch.float32).reshape(-1)
              for v in options.astuple()]
    fields = torch.broadcast_tensors(*fields)
    return _pack(fields, n_steps).contiguous().to(device)


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
    start_step: int = 0           # resume: Tk of trajectories.cuh:116-117
    # Importance sampling: shift the terminal log-price by `is_shift`
    # standard deviations (of sigma*sqrt(T)); payoffs carry the exact
    # likelihood ratio, so the estimator stays unbiased.
    is_shift: float = 0.0

    def __post_init__(self):
        if self.method not in ("euler", "terminal"):
            raise ValueError(
                f"unknown method {self.method!r} for the step-loop kernels; "
                "use 'euler' or 'terminal' (method='terminal_pair' is only "
                "available through price())")
        check_rng_source(self.rng_source)
        if self.is_shift and self.start_step:
            raise ValueError("importance sampling with resume (start_step>0) "
                             "is not supported")
        if self.start_step and not 0 < self.start_step < self.n_steps:
            raise ValueError(f"start_step must be in [0, n_steps); got "
                             f"{self.start_step} with n_steps={self.n_steps}")
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
    return min(_cuda.cdiv(n, lib.mc_block_threads()), _cuda.MAX_BLOCKS)


def _bound(path_offset: int, n_paths: int, n_valid) -> int:
    """The uint32 global path-count bound (ids at or past it are masked)."""
    bound = path_offset + n_paths if n_valid is None else int(n_valid)
    return bound & 0xFFFFFFFF


def _check_per_path(name: str, a: torch.Tensor, n_paths: int,
                    device: torch.device) -> None:
    """A per-path f32 input: ``(n_paths,)``, contiguous, on ``device``."""
    if (not torch.is_tensor(a) or a.dtype != torch.float32
            or a.shape != (n_paths,) or not a.is_contiguous()
            or a.device != device):
        raise ValueError(
            f"{name} must be a contiguous float32 tensor of shape "
            f"({n_paths},) on {device}; got "
            f"{getattr(a, 'shape', None)} {getattr(a, 'dtype', type(a))} "
            f"on {getattr(a, 'device', None)}")


def _state_tuple(payoff: PathPayoff, state_init):
    """A resume state as a tuple of ``payoff.n_state`` per-path arrays: a
    bare tensor is taken for a payoff with one state word."""
    if state_init is None or isinstance(state_init, (tuple, list)):
        return None if state_init is None else tuple(state_init)
    return (state_init,)


def _check_resume(payoff: PathPayoff, cfg: KernelConfig,
                  params: torch.Tensor, s_init, state_init) -> None:
    if s_init is None:
        if state_init is not None:
            raise ValueError("state_init needs s_init")
        return
    _check_per_path("s_init", s_init, cfg.n_paths, params.device)
    if payoff.n_state:
        if state_init is None:
            raise ValueError(f"{payoff.name} carries a path state; resume "
                             "needs state_init with s_init")
        if len(state_init) != payoff.n_state:
            raise ValueError(
                f"{payoff.name} carries {payoff.n_state} state words; "
                f"state_init has {len(state_init)} arrays (pass a tuple of "
                f"{payoff.n_state}, or a bare tensor for one word)")
        for q, a in enumerate(state_init):
            _check_per_path(f"state_init[{q}]", a, cfg.n_paths,
                            params.device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels' per-path arithmetic
# ---------------------------------------------------------------------------


def step_normals(cfg: KernelConfig, draw_pair):
    """The Euler steps' normals, ``(j, z_j)`` for j from ``cfg.start_step``
    to ``cfg.n_steps`` (``for_each_draw`` in ``csrc/payoffs.cuh``).

    ``draw_pair(m) -> (z_2m, z_2m+1)``: step j takes half j % 2 of threefry
    pair j // 2, so both Box-Muller halves of every call are used, an odd
    resume point starts on the tail half of its pair and an odd step count
    ends on the head half of one more pair.
    """
    for j in range(cfg.start_step, cfg.n_steps):
        if j % 2 == 0 or j == cfg.start_step:
            pair = draw_pair(j // 2)
        yield j, pair[j % 2]


def simulate_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair,
                 state_init=None, on_draw=None):
    """Simulate one leg to maturity; returns ``(s_t, state, weight)``.

    ``draw_pair(m) -> (z_2m, z_2m+1)``; ``s0`` is the per-path start price
    (the resume price from ``start_step`` on).  The terminal method takes
    the head half of pair 0, the Euler loop the draws of ``step_normals``;
    ``on_draw(z)``, if given, sees each draw in order before any importance
    shift.  ``weight`` is the importance-sampling likelihood ratio dP/dQ
    (None when ``cfg.is_shift`` is 0).
    """
    shift = torch.tensor(cfg.is_shift, dtype=torch.float32, device=s0.device)
    if cfg.method == "terminal":
        z, _ = draw_pair(0)
        if on_draw is not None:
            on_draw(z)
        if cfg.is_shift:
            z = z + shift
        s_t = s0 * torch.exp(p.drift_t + p.vol_t * z)
        if cfg.is_shift:
            # dP/dQ at the sampled point: exp(-shift*eps + shift^2/2).
            return s_t, (), torch.exp(-shift * z + 0.5 * shift * shift)
        return s_t, (), None

    state = (payoff.init(p, torch.zeros_like(s0)) if state_init is None
             else state_init)
    # Per-step drift shift theta = shift/sqrt(n): the terminal log-price
    # moves by sigma*sqrt(T)*shift, as under the terminal method.
    theta = shift / torch.tensor(math.sqrt(cfg.n_steps), dtype=torch.float32,
                                 device=s0.device)
    w = torch.zeros_like(s0)
    s = s0

    def one_step(w, state, z):
        if cfg.is_shift:
            z = z + theta
        w = w + (p.drift_dt + p.vol_dt * z)
        s = s0 * torch.exp(w)  # log-space: one exp rounding per S_t
        return w, s, payoff.update(state, s, p)

    for _, z in step_normals(cfg, draw_pair):
        if on_draw is not None:
            on_draw(z)
        w, s, state = one_step(w, state, z)
    if cfg.is_shift:
        # log dP/dQ = -theta * sum(eps_j) + n theta^2 / 2, the shifted
        # increments recovered from the log-price accumulator:
        # sum(eps) * vol_dt = w - n * drift_dt.
        n = torch.tensor(float(cfg.n_steps), dtype=torch.float32,
                         device=s0.device)
        sum_eps = (w - n * p.drift_dt) / p.vol_dt
        return s, state, torch.exp(-theta * sum_eps + 0.5 * n * theta * theta)
    return s, state, None


def _payoff_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair,
                state_init=None):
    """One leg, its payoff and its control variate: ``(payoff, x)``, x the
    payoff's own control where it has one, else S_T.  Under importance
    sampling both carry the likelihood ratio."""
    s_t, state, weight = simulate_leg(payoff, cfg, p, s0, draw_pair,
                                      state_init)
    pay = payoff.terminal(state, s_t, p)
    x = payoff.control(state, s_t, p) if payoff.has_control else s_t
    if weight is not None:
        return pay * weight, x * weight
    return pay, x


def _terminal_pair_vals(payoff, p, ids_e, bound_paths: int, z0, z1):
    """Per-element [sum, sumsq] of the two terminal-path payoffs."""

    def one(z, pid):
        s_t = p.s0 * torch.exp(p.drift_t + p.vol_t * z)
        return torch.where(pid < bound_paths, payoff.terminal((), s_t, p), 0.0)

    pa = one(z0, 2 * ids_e)
    pb = one(z1, 2 * ids_e + 1)
    return [pa + pb, pa * pa + pb * pb]


def moment_row(vals) -> torch.Tensor:
    """One chunk's row of partials: the f64 sum of each per-path value."""
    return torch.stack([v.double().sum() for v in vals])


def path_chunks(cfg: KernelConfig, key, params, path_offset: int = 0,
                bound=None, chunk: int = PLAIN_CHUNK):
    """Per chunk of the plain versions: ``(start, stop, ids, valid,
    draw_pair)``.  ``ids`` are the uint32 global path ids of local paths
    [start, stop), ``valid`` marks those below ``bound`` (default: the end
    of the run), and ``draw_pair(m)`` is threefry normal pair m of each
    path on ``key`` (the kernels' stream)."""
    k0, k1 = int(key[0]), int(key[1])
    if bound is None:
        bound = _bound(path_offset, cfg.n_paths, None)
    for start in range(0, cfg.n_paths, chunk):
        stop = min(start + chunk, cfg.n_paths)
        local = torch.arange(start, stop, dtype=torch.int64,
                             device=params.device)
        ids = (local + path_offset) & 0xFFFFFFFF

        def draw_pair(m, ids=ids):
            return rng.normal_pair(k0, k1, ids, torch.full_like(ids, m),
                                   rounds=cfg.rng_rounds)

        yield start, stop, ids, ids < bound, draw_pair


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
        rows.append(moment_row(_terminal_pair_vals(
            payoff, p, ids_e, n_paths_total, z0, z1)))
    return torch.stack(rows)


def simulate_partials_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                            params: torch.Tensor, path_offset: int = 0,
                            n_valid=None, s_init=None, state_init=None):
    """Plain version of the simulate kernel: (chunks, n_moments) f64."""
    state_init = _state_tuple(payoff, state_init)
    p = unpack_params(params)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for start, stop, ids, valid, draw_pair in path_chunks(
            cfg, key, params, path_offset, bound):
        if s_init is None:
            s0, st0 = p.s0.expand(ids.shape), None
        else:
            s0 = s_init[start:stop]
            st0 = (tuple(a[start:stop] for a in state_init)
                   if payoff.n_state else ())
        pay, x = _payoff_leg(payoff, cfg, p, s0, draw_pair, st0)
        if cfg.antithetic:
            # The antithetic leg negates the draw before the IS shift.
            pay_n, x_n = _payoff_leg(payoff, cfg, p, s0, _negated(draw_pair),
                                     st0)
            pay = 0.5 * (pay + pay_n)
            x = 0.5 * (x + x_n)
        pay = torch.where(valid, pay, 0.0)
        vals = [pay, pay * pay]
        if cfg.with_cv:
            # Control variate X (pair mean if antithetic): the terminal
            # price, E[X] = S0 * exp((r - q) T) exactly under the log-Euler
            # scheme, unless the payoff brings its own.
            x = torch.where(valid, x, 0.0)
            vals += [x, x * x, pay * x]
        rows.append(moment_row(vals))
    return torch.stack(rows)


def simulate_trajectories_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                                params: torch.Tensor, path_offset: int = 0,
                                n_valid=None):
    """Plain version of the trajectories kernel: ``(s_grid, state_grid,
    partials)``, the grids ``(n_steps, n_paths)`` f32 (price and payoff
    state after step j+1; zeros for a payoff without state), the partials
    (chunks, 2) f64 [sum pay, sum pay^2]."""
    p = unpack_params(params)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    s_grid = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                         device=params.device)
    st_grid = torch.zeros_like(s_grid)
    rows = []
    for start, stop, ids, valid, draw_pair in path_chunks(
            cfg, key, params, path_offset, bound):
        s0 = p.s0.expand(ids.shape)
        state = payoff.init(p, torch.zeros_like(s0))
        w = torch.zeros_like(s0)
        s = s0
        for j, z in step_normals(cfg, draw_pair):
            w = w + (p.drift_dt + p.vol_dt * z)
            s = s0 * torch.exp(w)  # log-space: one exp rounding per S_t
            state = payoff.update(state, s, p)
            s_grid[j, start:stop] = s
            if payoff.n_state:
                st_grid[j, start:stop] = state[0]
        pay = torch.where(valid, payoff.terminal(state, s, p), 0.0)
        rows.append(moment_row([pay, pay * pay]))
    return s_grid, st_grid, torch.stack(rows)


def _n_pairs(cfg: KernelConfig) -> int:
    """Normal pairs one leg draws: one for the terminal draw, one per two
    Euler steps."""
    return 1 if cfg.method == "terminal" else (cfg.n_steps + 1) // 2


def _spot_tangents(p, s, t_j, sum_z, sqrt_dt):
    """dS/d(s0, sigma, r, q) of S = s0 e^w after elapsed time t_j
    (``mc_tpu/ops/path_kernels.py:828-834``)."""
    return (s / p.s0, s * (-p.sigma * t_j + sqrt_dt * sum_z), s * t_j,
            -(s * t_j))


def _greek_leg(payoff: PathPayoff, cfg: KernelConfig, p, draw_pair, like):
    """One leg's payoff and its tangents with respect to (s0, sigma, r, q):
    ``(pay, [d_s0, d_sigma, d_r, d_q])``, by the payoff's hand-written
    ``update_jvp``/``terminal_jvp`` (the port of ``_greek_leg``,
    ``mc_tpu/ops/path_kernels.py:812-892``); ``like`` is a per-path f32
    tensor of the chunk's shape."""
    zero = torch.zeros_like(like)
    state = payoff.init(p, zero)
    dstates = [tuple(torch.zeros_like(a) for a in state)] * 4
    if cfg.method == "terminal":
        z, _ = draw_pair(0)
        s = p.s0 * torch.exp(p.drift_t + p.vol_t * z)
        ds = _spot_tangents(p, s, p.t, z, p.vol_t / p.sigma)
    else:
        sqrt_dt = p.vol_dt / p.sigma
        w, sum_z = zero, zero
        for j, z in step_normals(cfg, draw_pair):
            w = w + (p.drift_dt + p.vol_dt * z)
            sum_z = sum_z + z
            s = p.s0 * torch.exp(w)
            if payoff.n_state:
                t_j = torch.tensor(j + 1.0, dtype=torch.float32,
                                   device=w.device) * p.dt
                ds = _spot_tangents(p, s, t_j, sum_z, sqrt_dt)
                dstates = [payoff.update_jvp(state, dst, s, d, p)
                           for dst, d in zip(dstates, ds)]
            state = payoff.update(state, s, p)
        ds = _spot_tangents(p, s, p.t, sum_z, sqrt_dt)
    pay = payoff.terminal(state, s, p)
    return pay, [payoff.terminal_jvp(state, dst, s, d, p)
                 for dst, d in zip(dstates, ds)]


def _negated(draw_pair):
    """The antithetic leg's draws: the same pairs, negated."""
    return lambda m: tuple(-z for z in draw_pair(m))


def simulate_greek_partials_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                                  params: torch.Tensor):
    """Plain version of the greek kernel: (chunks, 10) f64, the sum and
    sum of squares of (pay, delta, vega, rho', epsilon) per path
    (``_greek_moment_values``, ``mc_tpu/ops/path_kernels.py:895-908``)."""
    p = unpack_params(params)
    rows = []
    for _, _, ids, valid, draw_pair in path_chunks(cfg, key, params):
        pay, (d_s0, d_sigma, d_r, d_q) = _greek_leg(
            payoff, cfg, p, draw_pair, torch.zeros_like(ids,
                                                        dtype=torch.float32))
        # rho folds the discount's derivative -T*pay; q does not enter
        # e^{-rT}, so epsilon has none.
        vals = []
        for v in (pay, d_s0, d_sigma, d_r - p.t * pay, d_q):
            v = torch.where(valid, v, 0.0)
            vals += [v, v * v]
        rows.append(moment_row(vals))
    return torch.stack(rows)


def simulate_ladder_partials_plain(payoff: PathPayoff, cfg: KernelConfig,
                                   key, params: torch.Tensor, strikes,
                                   path_offset: int = 0, n_valid=None):
    """Plain version of the ladder kernel: (chunks, M, 2) f64 [sum pay,
    sum pay^2] per strike, each path simulated once and every strike
    evaluated on it by ``payoff.terminal`` with ``k`` swapped."""
    p = unpack_params(params)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, draw_pair in path_chunks(cfg, key, params,
                                                   path_offset, bound):
        s0 = p.s0.expand(ids.shape)
        s_t, state, _ = simulate_leg(payoff, cfg, p, s0, draw_pair)
        if cfg.antithetic:
            s_n, state_n, _ = simulate_leg(payoff, cfg, p, s0,
                                           _negated(draw_pair))
        per_strike = []
        for k in strikes:
            pm = SimpleNamespace(**{**vars(p), "k": k})
            pay = payoff.terminal(state, s_t, pm)
            if cfg.antithetic:
                pay = 0.5 * (pay + payoff.terminal(state_n, s_n, pm))
            pay = torch.where(valid, pay, 0.0)
            per_strike.append(moment_row([pay, pay * pay]))
        rows.append(torch.stack(per_strike))
    return torch.stack(rows)


def simulate_book_partials_plain(payoff: PathPayoff, cfg: KernelConfig, key,
                                 params_rows: torch.Tensor,
                                 path_offset: int = 0, n_valid=None):
    """Plain version of the book kernel: (chunks, B, n_moments) f64.  A
    chunk's normals are drawn once and replayed for every contract; the
    antithetic leg negates them."""
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    n_pairs = _n_pairs(cfg)
    chunk = max(1, min(PLAIN_CHUNK, PLAIN_BOOK_DRAW_BYTES // (8 * n_pairs)))
    contracts = [unpack_params(row) for row in params_rows]
    rows = []
    for _, _, ids, valid, draw_pair in path_chunks(
            cfg, key, params_rows, path_offset, bound, chunk):
        draws = [draw_pair(m) for m in range(n_pairs)]
        per_contract = []
        for p in contracts:
            s0 = p.s0.expand(ids.shape)
            pay, x = _payoff_leg(payoff, cfg, p, s0, draws.__getitem__)
            if cfg.antithetic:
                pay_n, x_n = _payoff_leg(payoff, cfg, p, s0,
                                         _negated(draws.__getitem__))
                pay = 0.5 * (pay + pay_n)
                x = 0.5 * (x + x_n)
            pay = torch.where(valid, pay, 0.0)
            vals = [pay, pay * pay]
            if cfg.with_cv:
                x = torch.where(valid, x, 0.0)
                vals += [x, x * x, pay * x]
            per_contract.append(moment_row(vals))
        rows.append(torch.stack(per_contract))
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
    ``s_init``/``state_init``: optional per-path resume arrays, ``(n_paths,)``
    f32 on the params' device (the reference's (Sk, Ik) resume arguments,
    trajectories.cuh:116-117); ``state_init`` is a tuple of the payoff's
    ``n_state`` arrays, or a bare tensor for a payoff with one state word.
    The leg then runs from ``cfg.start_step``.
    """
    _check_params(params)
    if cfg.method == "terminal" and payoff.n_state:
        raise ValueError(f"{payoff.name} is path-dependent; "
                         "method='terminal' invalid")
    state_init = _state_tuple(payoff, state_init)
    _check_resume(payoff, cfg, params, s_init, state_init)
    if params.device.type == "cpu":
        return simulate_partials_plain(payoff, cfg, key, params, path_offset,
                                       n_valid, s_init, state_init)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    partials = torch.empty((n_blocks, cfg.n_moments), dtype=torch.float64,
                           device=params.device)
    # The state words as one (n_state, n_paths) block, word q of path i at
    # q * n_paths + i.
    block = (torch.stack(state_init).contiguous()
             if s_init is not None and payoff.n_state else None)
    st_ptr = None if block is None else block.data_ptr()
    with torch.cuda.device(params.device):
        status = lib.mc_simulate_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.method == "euler"),
            int(cfg.antithetic), int(cfg.with_cv), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.start_step, cfg.is_shift,
            cfg.n_paths, path_offset & 0xFFFFFFFF, bound,
            None if s_init is None else s_init.data_ptr(), st_ptr,
            partials.data_ptr(), cfg.n_moments, n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "simulate_partials kernel")
    _cuda.count_launch("simulate_partials")
    return partials


def simulate_trajectories(payoff: PathPayoff, cfg: KernelConfig, key,
                          params: torch.Tensor, path_offset: int = 0,
                          n_valid=None):
    """Materialize the (S, state) grids: ``(s_grid, state_grid, partials)``
    with the grids ``(n_steps, n_paths)`` f32 step-major (entry [j, i] after
    step j+1 of path i) and the partials ``(rows, 2)`` f64 [sum, sumsq] of
    the payoff.  The plain log-Euler loop only: no antithetic leg, control
    variate, importance sampling or resume."""
    _check_params(params)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if (cfg.method != "euler" or cfg.antithetic or cfg.with_cv
            or cfg.start_step or cfg.is_shift):
        raise ValueError("simulate_trajectories runs the plain log-Euler "
                         "loop: method='euler' without antithetic, CV, IS "
                         "or resume")
    if params.device.type == "cpu":
        return simulate_trajectories_plain(payoff, cfg, key, params,
                                           path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    s_grid = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                         device=params.device)
    st_grid = torch.empty_like(s_grid)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_trajectories(
            payoff.cuda_id, cfg.rng_rounds, int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, s_grid.data_ptr(),
            st_grid.data_ptr(), partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "trajectories kernel")
    _cuda.count_launch("trajectories")
    return s_grid, st_grid, partials


# (pay, delta, vega, rho', epsilon) x (sum, sumsq)
GREEK_MOMENTS = 10


def simulate_greek_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                            params: torch.Tensor):
    """(rows, 10) f64 accumulators of the pathwise greeks in one pass:
    (sum, sumsq) of the payoff and of its derivatives with respect to s0
    (delta), sigma (vega), r less T*pay (rho, the discount's derivative
    folded in) and q (epsilon), all undiscounted.  The five payoffs of
    ``PATHWISE`` only; the plain leg of ``simulate_partials`` (no
    antithetic, control variate, importance sampling or resume, as in
    ``mc_tpu``), paths 0..n_paths-1 of the key's stream."""
    _check_params(params)
    if payoff.name not in PATHWISE:
        raise ValueError(
            f"payoff {payoff.name!r} has no pathwise derivative (a "
            "discontinuous payoff); use greeks(method='lrm') or "
            "greeks(method='fd')")
    if cfg.method == "terminal" and payoff.n_state:
        raise ValueError(f"{payoff.name} is path-dependent; "
                         "method='terminal' invalid")
    if cfg.antithetic or cfg.with_cv or cfg.is_shift or cfg.start_step:
        raise ValueError("the greek kernel takes no antithetic leg, control "
                         "variate, importance sampling or resume")
    if params.device.type == "cpu":
        return simulate_greek_partials_plain(payoff, cfg, key, params)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    partials = torch.empty((n_blocks, GREEK_MOMENTS), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_greek_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.method == "euler"),
            int(key[0]), int(key[1]), params.data_ptr(), cfg.n_steps,
            cfg.n_paths, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "greek kernel")
    _cuda.count_launch("greek_partials")
    return partials


def _check_batch(payoff: PathPayoff, cfg: KernelConfig, what: str) -> None:
    if cfg.rng_source != "threefry13":
        raise ValueError(f"the {what} kernel draws the threefry-13 stream "
                         f"(price_ladder and price_portfolio); got "
                         f"rng_source={cfg.rng_source!r}")
    if cfg.start_step or cfg.is_shift:
        raise ValueError(f"the {what} kernel takes no resume or importance "
                         "sampling")
    if cfg.method == "terminal" and payoff.n_state:
        raise ValueError(f"{payoff.name} is path-dependent; "
                         "method='terminal' invalid")


def simulate_ladder_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                             params: torch.Tensor, strikes: torch.Tensor,
                             path_offset: int = 0, n_valid=None):
    """(rows, M, 2) f64 [sum, sumsq] of the payoff at each of the M
    ``strikes`` ((M,) f32 on the params' device) on shared paths: one
    simulation per path, the strike entering only ``payoff.terminal``."""
    _check_params(params)
    _check_batch(payoff, cfg, "ladder")
    if cfg.with_cv:
        raise ValueError("the ladder kernel has no control variate")
    if (not torch.is_tensor(strikes) or strikes.dtype != torch.float32
            or strikes.dim() != 1 or strikes.numel() < 1
            or not strikes.is_contiguous() or strikes.device != params.device):
        raise ValueError(
            f"strikes must be a non-empty contiguous float32 (M,) tensor on "
            f"{params.device}; got {getattr(strikes, 'shape', None)} "
            f"{getattr(strikes, 'dtype', type(strikes))}")
    if params.device.type == "cpu":
        return simulate_ladder_partials_plain(payoff, cfg, key, params,
                                              strikes, path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _cuda.cdiv(cfg.n_paths, lib.mc_ladder_block_threads())
    partials = torch.empty((n_blocks, strikes.numel(), 2),
                           dtype=torch.float64, device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_ladder_partials(
            payoff.cuda_id, int(cfg.method == "euler"), int(cfg.antithetic),
            int(key[0]), int(key[1]), params.data_ptr(), strikes.data_ptr(),
            strikes.numel(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "ladder kernel")
    _cuda.count_launch("ladder")
    return partials


def book_block_threads(cfg: KernelConfig) -> int:
    """Threads (= paths) per block of the book kernel: the largest power of
    two up to 256 whose normal buffer fits beside the block reduction in
    227 KB of shared memory (the counterpart of mc_tpu's
    ``book_tile_rows``).  Raises where even 32 do not fit."""
    n_pairs = _n_pairs(cfg)
    threads = BOOK_MAX_THREADS
    while threads >= 32:
        if 8 * n_pairs * threads + BOOK_REDUCE_BYTES <= BOOK_SMEM_BYTES:
            return threads
        threads //= 2
    raise ValueError(
        f"the book kernel keeps each path's normals in shared memory: "
        f"{cfg.n_steps} steps need {8 * n_pairs} bytes a path, and even a "
        f"block of 32 paths exceeds the {BOOK_SMEM_BYTES} bytes an H100 "
        "block may hold; price fewer steps, or the contracts one by one "
        "with price()")


def simulate_book_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                           params_rows: torch.Tensor, path_offset: int = 0,
                           n_valid=None):
    """(rows, B, n_moments) f64 accumulators of a B-contract book in one
    pass: ``params_rows`` is ``(B, 15)`` f32, one ``pack_params_rows`` row
    per contract.  Every contract runs on the same draws (common random
    numbers), drawn once per path and replayed per contract; moments as in
    ``simulate_partials``."""
    if (not torch.is_tensor(params_rows) or params_rows.dtype != torch.float32
            or params_rows.dim() != 2
            or params_rows.shape[1] != len(PARAM_FIELDS)
            or params_rows.shape[0] < 1 or not params_rows.is_contiguous()
            or params_rows.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params_rows must be a contiguous float32 (B, "
            f"{len(PARAM_FIELDS)}) tensor with B >= 1; got "
            f"{getattr(params_rows, 'shape', None)} "
            f"{getattr(params_rows, 'dtype', type(params_rows))}")
    _check_batch(payoff, cfg, "book")
    threads = book_block_threads(cfg)
    if params_rows.device.type == "cpu":
        return simulate_book_partials_plain(payoff, cfg, key, params_rows,
                                            path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _cuda.cdiv(cfg.n_paths, threads)
    n_contracts = params_rows.shape[0]
    partials = torch.empty((n_blocks, n_contracts, cfg.n_moments),
                           dtype=torch.float64, device=params_rows.device)
    with torch.cuda.device(params_rows.device):
        status = lib.mc_book_partials(
            payoff.cuda_id, int(cfg.method == "euler"), int(cfg.antithetic),
            int(cfg.with_cv), int(key[0]), int(key[1]),
            params_rows.data_ptr(), n_contracts, cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, threads, partials.data_ptr(),
            cfg.n_moments, n_blocks, _cuda.stream_handle(params_rows.device))
    _cuda.check(status, "book kernel")
    _cuda.count_launch("book")
    return partials
