"""Batch-level exact iLQR on the CUDA kernels.

Counterpart of `quadrotorilqr_tpu/solver/batched.py`:

  * `solve_batch_fused` runs the reference loop (`solver.ilqr.solve_loop`)
    at the batch level, with every backward pass and line-search rollout one
    kernel launch over all scenarios (`kernels/backward.py`,
    `kernels/rollout.py`); finished or accepted lanes are masked out of the
    launches.
  * `solve_batch_latency` runs the whole loop in one kernel launch
    (`kernels/solve.py`), except for a zero-probe line search, which the
    whole-solve kernel cannot express and which goes to the batch loop.

Both take any B and any N (no lane padding, no horizon routing). On CPU
tensors the kernel wrappers run their plain PyTorch versions.
"""

from __future__ import annotations

from ..costs import quadratic as qc
from ..kernels.backward import backward_pass_fused
from ..kernels.rollout import rollout_cost_fused
from ..kernels.solve import solve_fused_whole
from .ilqr import (
    CONTINUATION_TODO,
    LIMITS_TODO,
    SolveResult,
    Trajectory,
    check_supported,
    solve_loop,
)
from .options import ILQROptions


def _refuse(options, continuation, model, limits):
    check_supported(options, model)
    if continuation:
        raise NotImplementedError(CONTINUATION_TODO)
    if limits is not None:
        raise NotImplementedError(LIMITS_TODO)


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
    initial_trajs leaves are (B, N, ...)."""
    _refuse(options, continuation, model, limits)
    qc.check_supported(cost)
    return solve_loop(
        lambda t, act: backward_pass_fused(
            params, cost, t, dt_s, quu_reg=options.quu_reg, active=act
        ),
        lambda t, ks, big_ks, alpha, act: rollout_cost_fused(
            params, cost, t, ks, big_ks, alpha, dt_s, active=act
        ),
        lambda t: qc.trajectory_cost(cost, t.states, t.controls),
        initial_trajs,
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
    """Batched iLQR with the whole loop in one kernel launch; lane for lane
    the same result as `solve_batch_fused`."""
    _refuse(options, continuation, model, limits)
    if options.line_search_params.max_iters < 1:
        return solve_batch_fused(params, cost, initial_trajs, dt_s, options)
    traj, cost_v, iterations, status = solve_fused_whole(
        params, cost, initial_trajs, dt_s, options
    )
    return SolveResult(trajectory=traj, cost=cost_v, iterations=iterations, status=status)
