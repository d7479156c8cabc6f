"""Batch-level exact iLQR on the CUDA kernels.

Counterpart of `quadrotorilqr_tpu/solver/batched.py`:

  * `solve_batch_fused` runs the reference loop (`solver.ilqr.solve_loop`)
    at the batch level, with every backward pass and line-search rollout one
    kernel launch over all scenarios (`kernels/backward.py`,
    `kernels/rollout.py`); finished or accepted lanes are masked out of the
    launches, and the operands that do not change over the solve are
    prepared once (`kernels.rollout.per_pass_kernels`).
  * `solve_batch_latency` runs the whole loop in one kernel launch:
    `kernels/solve.py` up to STREAM_HORIZON stages, `kernels/stream.py`
    (no candidate trajectory) past it; a zero-probe line search, which the
    whole-solve kernels cannot express, goes to the batch loop, and so
    does a debug record past STREAM_HORIZON stages.
  * Every solver here takes control limits (`limits=(lo, hi)`: scalars,
    (4,) or (B, 4) each) and the cost's stage weights ((N,) or (B, N)) on
    the kernels' box and weights variants: `backward.cu`, `rollout.cu`,
    `solve.cu` and `stream.cu` for the exact routes, `fddp.cu` and
    `stream_fddp.cu` for the FDDP solvers, in every phase of the
    multi-phase solve.
  * Both exact routes take the model families: `model=`, or the family the
    params type names (`solver.ilqr.resolve_model`): the quadrotor, the
    drag quadrotor, the SE(3) body wrench (u = 6) and the R-rotor
    multirotor (u = R; the kernels take R = 4, which is the quadrotor's
    kernels, 6 and 8), and `models.integrators.substepped(model, k)` of the
    quadrotor or the drag quadrotor (2 <= k <= 8 on the card). Their
    route point to the streamed kernel is the JAX package's for the
    control width (`stream_horizon`). On the card these families' kernels
    have no box, weights or record instantiation: those requests raise
    (ROADMAP Queue 1 item 11c), as do other rotor counts (11d), substeps of
    the wrench and multirotors (11a) and the FDDP solvers with such a
    family (11b). An `rk4(model)` has no kernels: both routes raise
    TypeError with it, as the JAX package's `lane_model_for` does; the
    plain `solver.ilqr.solve` takes it.
  * `solve_batch_fddp` runs the robust FDDP loop in one kernel launch:
    `kernels/fddp.py` up to STREAM_HORIZON_FDDP stages,
    `kernels/stream_fddp.py` past it; with `refine` it goes to
    `solve_batch_fddp_refine`, the multi-phase solve that may switch the
    curvature per phase (`resolve_refine_auto`) and resumes each phase
    from the last one's per-lane state, on the same engine.

The horizon routing is the JAX package's, so that every horizon runs the
engine the reference runs; every engine here takes any B and any N (no
lane padding). On CPU tensors the kernel wrappers run their plain PyTorch
versions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..costs import quadratic as qc
from ..kernels.fddp import solve_fddp_fused
from ..kernels.models import lane_model_for
from ..kernels.rollout import per_pass_kernels
from ..kernels.solve import solve_fused_whole
from ..kernels.stream import solve_fused_streamed
from ..kernels.stream_fddp import solve_fddp_streamed
from . import fddp
from .ilqr import (
    CONTINUATION_TODO,
    FAMILY_VARIANTS_TODO,
    CostHistory,
    SolveResult,
    Trajectory,
    check_supported,
    solve_loop,
)
from .options import ILQROptions


def stream_horizon(u_dim):
    """The JAX package's switch point to its streamed exact kernel for a
    control width u: max_horizon_for(u) = 256 * 112 // (48 + 16 u) stages
    (quadrotorilqr_tpu/kernels/solve.py:70-75): 256 at u = 4, 199 at 6, 162
    at 8."""
    return 256 * 112 // (48 + 16 * u_dim)


# The JAX package's switch points for the quadrotor (u = 4): max_horizon_for(4)
# = 256 stages and max_horizon_for_fddp(4) = 231 (kernels/fddp.py:125-128).
# There they are the VMEM budgets of the whole-solve kernels; here they are
# route points only, so that each horizon runs the reference's engine. On
# the H100 the streamed engines are a few percent slower than their
# whole-solve twins at these horizons (PERF.md): the route costs time until
# one engine per solver is at least as fast as both.
STREAM_HORIZON = stream_horizon(4)
STREAM_HORIZON_FDDP = 231


def _refuse(continuation, model, params):
    check_supported(model)
    if continuation:
        raise NotImplementedError(CONTINUATION_TODO)
    return lane_model_for(params, model)


def solve_batch_fused(
    params,
    cost,
    initial_trajs: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    continuation: bool = False,
    model=None,
    limits=None,
) -> SolveResult:
    """Batched iLQR, one backward and one rollout launch at a time;
    initial_trajs leaves are (B, N, ...), any N; the model family is the
    params' (or `model=`). With `limits` or stage weights each launch is the
    kernel's box or weights variant."""
    _refuse(continuation, model, params)
    backward, rollout, trajs = per_pass_kernels(
        params, cost, initial_trajs, dt_s, options.quu_reg, limits, model
    )
    return solve_loop(
        backward,
        rollout,
        lambda t: qc.trajectory_cost(cost, t.states, t.controls),
        trajs,
        options,
    )


def solve_batch_latency(
    params,
    cost,
    initial_trajs: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    continuation: bool = False,
    model=None,
    limits=None,
) -> SolveResult:
    """Batched iLQR with the whole loop in one kernel launch (the streamed
    kernel past `stream_horizon(u)` stages, STREAM_HORIZON for the
    quadrotor); lane for lane the same result as `solve_batch_fused`. Limits
    and stage weights run `solve.cu`'s box and weights variants, and past
    the route point `stream.cu`'s.

    With `options.populate_debug` the whole-solve kernel records the
    per-trip cost history, and `debug` is a CostHistory: the costs and
    valid buffers of the batch loop's IterDebug, without the trajectory
    snapshots. Past STREAM_HORIZON stages (the streamed kernel records no
    history) and for zero-probe line searches the request goes to
    `solve_batch_fused`, whose `debug` is the full IterDebug, as the JAX
    package routes it. On the card a wrench or multirotor model has no
    recorded instantiation: `populate_debug` raises with it (ROADMAP Queue 1
    item 11c)."""
    lm = _refuse(continuation, model, params)
    streamed = initial_trajs.controls.shape[1] > stream_horizon(lm.u_dim)
    on_card = initial_trajs.controls.device.type != "cpu"
    if options.populate_debug and on_card and lm.suffix != "":
        raise NotImplementedError(FAMILY_VARIANTS_TODO)
    if options.line_search_params.max_iters < 1 or (options.populate_debug and streamed):
        return solve_batch_fused(params, cost, initial_trajs, dt_s, options, model=model,
                                 limits=limits)
    if options.populate_debug:
        traj, cost_v, iterations, status, hist = solve_fused_whole(
            params, cost, initial_trajs, dt_s, options, model=model, limits=limits,
            return_history=True,
        )
        # a lane's executed updates are its first trips, so valid is
        # arange < iterations (the batch loop's valid buffer)
        slots = torch.arange(hist.shape[1], device=hist.device)
        debug = CostHistory(costs=hist, valid=slots[None, :] < iterations[:, None])
        return SolveResult(traj, cost_v, iterations, status, debug)
    if streamed:
        traj, cost_v, iterations, status = solve_fused_streamed(
            params, cost, initial_trajs, dt_s, options, model=model, limits=limits
        )
    else:
        traj, cost_v, iterations, status = solve_fused_whole(
            params, cost, initial_trajs, dt_s, options, model=model, limits=limits
        )
    return SolveResult(trajectory=traj, cost=cost_v, iterations=iterations, status=status)


def resolve_refine_auto(max_iters, ddp):
    """The default multi-phase schedule: phase boundaries at 20, 30, 40, 50,
    62.5 and 75% of the iteration budget and, with ddp=False, exact-DDP
    curvature for the phases that start at 40% of the budget or later
    (the hybrid schedule). Returns (bounds, ddp); bounds is None when the
    budget is too small to split."""
    fr = (0.2, 0.3, 0.4, 0.5, 0.625, 0.75)
    bounds = tuple(
        sorted({b for f in fr if 0 < (b := int(round(f * max_iters))) < max_iters})
    )
    if not bounds:
        return None, ddp
    if ddp is False:
        switch = int(round(0.4 * max_iters))
        ddp = tuple(s >= switch for s in (0,) + bounds)
    return bounds, ddp


def _with_max_iters(options, max_iters):
    return dataclasses.replace(
        options,
        convergence_criteria=dataclasses.replace(
            options.convergence_criteria, max_iters=max_iters
        ),
    )


def solve_batch_fddp(
    params,
    cost,
    initial_trajs: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    fddp_options=None,
    model=None,
    ddp=False,
    limits=None,
    refine=None,
) -> SolveResult:
    """Batched robust FDDP solve (solver/fddp.py semantics), the whole loop in
    one kernel launch (the streamed kernel past STREAM_HORIZON_FDDP stages);
    lane for lane the plain `solver.fddp.solve_fddp`, with `limits` and the
    cost's stage weights on the kernels' box and weights variants.

    `refine="auto"` runs the multi-phase schedule of `resolve_refine_auto`
    (and, with ddp=False, the hybrid curvature); an int or tuple passes
    through as explicit phase boundaries (`solve_batch_fddp_refine`)."""
    fo = fddp.FDDPOptions() if fddp_options is None else fddp_options
    fddp.check_supported(model, params=params)
    if refine is not None:
        bounds, ddp_r = refine, ddp
        if refine == "auto":
            bounds, ddp_r = resolve_refine_auto(
                int(options.convergence_criteria.max_iters), ddp
            )
        if bounds is not None:
            return solve_batch_fddp_refine(
                params, cost, initial_trajs, dt_s, options, fddp_options=fo,
                phase1_iters=bounds, ddp=ddp_r, limits=limits,
            )
    if isinstance(ddp, tuple):
        raise ValueError(
            "per-phase ddp tuples need refine=... (solve_batch_fddp_refine semantics)"
        )
    traj, cost_v, iterations, status = _fddp_engine(initial_trajs)(
        params, cost, initial_trajs, dt_s, options, fo, ddp=ddp, limits=limits
    )
    return SolveResult(trajectory=traj, cost=cost_v, iterations=iterations, status=status)


def _fddp_engine(trajs):
    """The FDDP kernel wrapper for this horizon."""
    streamed = trajs.controls.shape[1] > STREAM_HORIZON_FDDP
    return solve_fddp_streamed if streamed else solve_fddp_fused


def solve_batch_fddp_refine(
    params,
    cost,
    initial_trajs: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    fddp_options=None,
    phase1_iters=20,
    model=None,
    ddp=False,
    limits=None,
) -> SolveResult:
    """Multi-phase robust solve. `phase1_iters` is one phase boundary (int)
    or several (cumulative trip counts), and `ddp` one curvature flag or one
    per phase (the hybrid schedule of `resolve_refine_auto`).

    Each run of consecutive phases with the same curvature is one kernel
    launch over all lanes, left in place; the next launch resumes exactly
    from the per-lane mu, status and iterations (frozen lanes only copy
    their trajectory). Resume is exact, so the result is lane for lane the
    phase-by-phase solve, and with one curvature the single-phase
    `solve_batch_fddp`. The JAX version also moves the pending lanes to the
    front between phases, so that tiles whose lanes are all frozen skip
    their work; a CUDA thread whose lane is frozen returns at once, so
    there is nothing to compact."""
    fo = fddp.FDDPOptions() if fddp_options is None else fddp_options
    fddp.check_supported(model, params=params)
    if isinstance(ddp, tuple) and len(set(bool(f) for f in ddp)) == 1:
        ddp = bool(ddp[0])
    hybrid = isinstance(ddp, tuple)
    total = int(options.convergence_criteria.max_iters)
    bounds = (phase1_iters,) if isinstance(phase1_iters, int) else tuple(phase1_iters)
    if all(min(int(b), total) == total for b in bounds):
        if hybrid:
            raise ValueError(
                f"per-phase ddp {ddp!r} needs at least two phases; "
                f"phase1_iters={phase1_iters!r} leaves one"
            )
        return solve_batch_fddp(params, cost, initial_trajs, dt_s, options, fo, ddp=ddp,
                                limits=limits)
    budgets = []
    used = 0
    for b in bounds:
        b = min(int(b), total)
        if b > used:
            budgets.append(b - used)
            used = b
    budgets.append(total - used)
    ddp_seq = ddp if hybrid else (ddp,) * len(budgets)
    if len(ddp_seq) != len(budgets):
        raise ValueError(
            f"per-phase ddp needs one flag per phase: {len(budgets)} phases from "
            f"phase1_iters={phase1_iters!r}, got {len(ddp_seq)} flags"
        )
    launches = []  # [budget, ddp] with consecutive phases of one curvature merged
    for budget, flag in zip(budgets, ddp_seq):
        if launches and launches[-1][1] == bool(flag):
            launches[-1][0] += budget
        else:
            launches.append([budget, bool(flag)])
    engine = _fddp_engine(initial_trajs)
    traj = initial_trajs
    mu = status = iters = None
    for budget, flag in launches:
        traj, cost_v, iters, status, mu = engine(
            params, cost, traj, dt_s, _with_max_iters(options, budget), fo,
            ddp=flag, initial_mu=mu, initial_status=status, initial_iters=iters,
            return_mu=True, limits=limits,
        )
    return SolveResult(trajectory=traj, cost=cost_v, iterations=iters, status=status)
