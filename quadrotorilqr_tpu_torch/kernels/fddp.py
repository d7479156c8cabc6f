"""The whole robust FDDP loop in one kernel: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/fddp.py:978` (`solve_fddp_fused`
over the Pallas `_fddp_kernel`). `csrc/fddp.cu` runs each scenario's whole
FDDP solve with one team of lanes of a warp per scenario (`csrc/team.cuh`):
per trip a reverse sweep that merges the previous trip's accepted
candidate, computes the defects and runs the gap-transported Riccati stage
(Gauss-Newton, or exact DDP curvature with `ddp=True`), then
the Goldstein line search with gap-contracting rollouts (probe 0 also
carries the exact quadratic model; with no probes every trip rejects), then
the per-lane mu schedule and status. Trajectories, gains and defects stay
in device memory, so any horizon fits; the batch solvers send horizons
past 231 stages to `kernels/stream_fddp.py`, the candidate-free variant, as
the JAX package routes them. `solve_fddp_fused` launches it for CUDA
tensors and takes `solve_fddp_whole_reference` (the plain loop
`solver.fddp.fddp_loop`) only for CPU tensors.
"""

from __future__ import annotations

import torch

from ..models.quadrotor import CONTROL_DIM
from ..solver import fddp
from ..solver.options import ILQROptions
from . import _build
from .backward import (
    GAINS_WIDTH,
    _check_cuda,
    _on,
    _problem_operands,
    _traj_from_lanes,
    _traj_lanes,
)


def solve_fddp_whole_reference(
    params, cost, traj, dt_s, options: ILQROptions, fddp_options, ddp=False,
    initial_mu=None, initial_status=None, initial_iters=None,
):
    """Plain PyTorch version: the batched `solver.fddp.fddp_loop`. Returns
    (Trajectory, cost, iterations int32, status int32, mu, probe sweeps,
    defect trips int32), each (B,) after the trajectory."""
    return fddp.fddp_loop(
        params, cost, traj, dt_s, options, fddp_options, ddp,
        initial_mu, initial_status, initial_iters,
    )


def _resume_row(a, batch, dtype, device):
    if a is None:
        return None
    a = _on(torch.as_tensor(a, device=device), dtype, device).reshape(-1).contiguous()
    if a.shape != (batch,):
        raise ValueError(f"resume rows must be ({batch},), got {tuple(a.shape)}")
    return a


def solve_fddp_fused(
    params, cost, traj, dt_s, options: ILQROptions, fddp_options=None, ddp=False,
    initial_mu=None, initial_status=None, initial_iters=None, return_mu=False,
    return_probes=False, model=None, limits=None,
):
    """Whole-solve FDDP for (B, N, ...) trajectories, any B and any N.

    `initial_mu` / `initial_status` / `initial_iters` ((B,) each) resume an
    interrupted solve exactly: lanes with a nonzero status are frozen (they
    copy their trajectory and report its cost); pending lanes continue their
    mu and iteration count for this call's max_iters trips.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,)
    int32), then mu (B,) with `return_mu`, and with `return_probes` the
    executed probe sweeps (B,) (stages the probes ran / N) and the trips
    whose reverse sweep computed the defects (B,) int32 (the first trip and
    each one after an accepted trip), both counted over this call."""
    fo = fddp.FDDPOptions() if fddp_options is None else fddp_options
    fddp.check_supported(cost, model, limits)
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        out = solve_fddp_whole_reference(
            params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status, initial_iters
        )
    else:
        _check_cuda(device)
        out = _launch(params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status,
                      initial_iters)
        solve_fddp_fused.launches += 1
    return out[:4] + ((out[4],) if return_mu else ()) + (out[5:] if return_probes else ())


def _launch(
    params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status, initial_iters,
    streamed=False,
):
    """Launch csrc/fddp.cu, or with `streamed` csrc/stream_fddp.cu (no
    candidate buffer; the apply sweeps each lane ran come last in the
    result). Returns (Trajectory, cost, iterations, status, mu, probe
    sweeps, defect trips[, apply sweeps])."""
    dtype = traj.controls.dtype
    device = traj.controls.device
    batch, n = traj.controls.shape[0], traj.controls.shape[1]
    cc = options.convergence_criteria
    ls = options.line_search_params
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    kw = dict(dtype=dtype, device=device)
    live = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    applies = [torch.empty((batch,), dtype=torch.int32, device=device)] if streamed else []
    cost_out, mu_out, probes = (torch.empty((batch,), **kw) for _ in range(3))
    iters, status, defect_trips = (
        torch.empty((batch,), dtype=torch.int32, device=device) for _ in range(3)
    )
    # one contiguous row per scenario and stage: k | K, and the defects
    # (csrc/team.cuh); fddp.cu also keeps the line search's candidate
    gains, defects = (torch.empty((n, batch, w), **kw) for w in (GAINS_WIDTH, 12))
    best = [] if streamed else [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    rows = [
        _resume_row(initial_mu, batch, dtype, device),
        _resume_row(initial_status, batch, torch.int32, device),
        _resume_row(initial_iters, batch, torch.int32, device),
    ]
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device), *rows, *live, cost_out, iters, status, mu_out,
         probes, gains, *best, defects, defect_trips, *applies],
        ints=[int(cc.max_iters), int(ls.max_iters), int(bool(ddp))],
        reals=[
            options.quu_reg, cc.rtol, cc.atol, ls.step_update, fddp.alpha_jump(ls.step_update),
            fo.goldstein_frac, fo.goldstein_ub, fddp.resolve_gap_tol(fo, dtype), fo.reg_init,
            fo.reg_scale_up, fo.reg_scale_down, fo.reg_min, fo.reg_max, fo.alpha_dec,
            fo.alpha_inc,
        ],
    )
    entry = "qilqr_stream_fddp" if streamed else "qilqr_fddp"
    _build.launch(entry, dtype, ops.ptrs, ops.ints, ops.reals, device)
    return (
        _traj_from_lanes(traj.times, *live), cost_out, iters, status, mu_out, probes, defect_trips,
        *applies,
    )


solve_fddp_fused.launches = 0
