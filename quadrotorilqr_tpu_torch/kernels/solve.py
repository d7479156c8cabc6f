"""The whole exact iLQR loop in one kernel: CUDA kernel and plain version.

Counterpart of `quadrotorilqr_tpu/kernels/solve.py:618` (`solve_fused_whole`
over the Pallas `_solve_kernel`). `csrc/solve.cu` runs each scenario's whole
solve (backward pass, line search, convergence checks, status and
iterations) with one team of lanes of a warp per scenario (`csrc/team.cuh`),
keeping the live, candidate and gain trajectories in device memory, so any
horizon fits; the batch solver sends horizons past 256 stages to
`kernels/stream.py`, the candidate-free variant, as the JAX package routes
them. `solve_fused_whole` launches it for CUDA tensors and takes
`solve_whole_reference` only for CPU tensors. On request the kernel also
records the per-trip cost history (the TPU kernel's `record_history` rows,
what `populate_debug` reads on the latency route) and each scenario's
backward passes and probe sweeps.
"""

from __future__ import annotations

import torch

from ..costs import quadratic as qc
from ..models.quadrotor import CONTROL_DIM
from ..solver import ilqr
from ..solver.options import ILQROptions
from . import _build
from .backward import (
    GAINS_WIDTH,
    _check_cuda,
    _problem_operands,
    _traj_from_lanes,
    _traj_lanes,
)


def counted_plain_solve(params, cost, traj, dt_s, options: ILQROptions, streamed=False,
                        history=False):
    """`solver.ilqr.solve_loop` on the plain pieces, counting per lane what
    the whole-solve kernels count: backward passes, probe sweeps and, with
    the streamed schedule (cost-only probes, one apply rollout at the alpha
    last tried), apply sweeps. Returns (SolveResult, [(B,) int32 counts])."""
    batch = traj.controls.shape[0]
    counts = [torch.zeros(batch, dtype=torch.int32, device=traj.controls.device)
              for _ in range(3 if streamed else 2)]

    def tally(i, lanes):
        counts[i] += 1 if lanes is None else lanes.to(torch.int32)

    def backward(t, act):
        tally(0, act)
        return ilqr.backward_pass(params, cost, t, dt_s, options.quu_reg)

    def probe(t, ks, big_ks, alpha, act):
        tally(1, act)
        return ilqr.rollout_cost(params, cost, t, ks, big_ks, alpha, dt_s)

    def apply(t, ks, big_ks, alpha, act):
        tally(2, act)
        return ilqr.forward_sim(params, t, ks, big_ks, alpha, dt_s)

    result = ilqr.solve_loop(
        backward, probe, lambda t: qc.trajectory_cost(cost, t.states, t.controls), traj, options,
        apply=apply if streamed else None, history=history,
    )
    return result, counts


def solve_whole_reference(params, cost, traj, dt_s, options: ILQROptions):
    """Plain PyTorch version: `solver.ilqr.solve_loop` on the plain pieces.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,) int32,
    cost history (B, max_iters), backward passes (B,) int32, probe sweeps
    (B,) int32): history slot i holds the committed cost of the lanes that
    executed an update on trip i, 0 elsewhere; the counts are per lane, as
    the kernel counts them."""
    r, counts = counted_plain_solve(params, cost, traj, dt_s, options, history=True)
    return (r.trajectory, r.cost, r.iterations, r.status, r.debug.costs, *counts)


def solve_fused_whole(
    params, cost, traj, dt_s, options: ILQROptions, continuation=False, model=None,
    limits=None, return_history=False, return_probes=False,
):
    """Whole-solve iLQR for (B, N, ...) trajectories, any B and any N.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,) int32);
    with `return_history` then the per-trip cost history (B, max_iters)
    (slot i: the committed cost of the lanes that executed an update on trip
    i, zeros otherwise: the debug record's costs buffer); with
    `return_probes` then the backward passes and probe sweeps each lane ran
    ((B,) int32 each; the JAX kernel reports one probe count per 128-lane
    tile, the count of the sweeps any lane of the tile ran)."""
    ilqr.check_supported(model)
    if continuation:
        raise NotImplementedError(ilqr.CONTINUATION_TODO)
    if limits is not None:
        raise NotImplementedError(ilqr.LIMITS_TODO)
    ls = options.line_search_params
    if int(ls.max_iters) < 1:
        # trip 0's forced full step is the first, force-accepted probe: with
        # no probes it would never run
        raise ValueError(
            "line_search_params.max_iters must be >= 1 on the whole-solve kernel; "
            "use solver.batched.solve_batch_fused (or solve_batch_latency, which "
            "routes there) for zero-probe runs"
        )
    device = traj.controls.device
    if device.type == "cpu":
        out = solve_whole_reference(params, cost, traj, dt_s, options)
    else:
        _check_cuda(device)
        out = _launch(params, cost, traj, dt_s, options, return_history, return_probes)
        solve_fused_whole.launches += 1
    return out[:4] + (out[4:5] if return_history else ()) + (out[5:] if return_probes else ())


def _launch(params, cost, traj, dt_s, options, history, probes):
    """The kernel; the history and count outputs exist only when asked for,
    and without them the kernel is the instantiation that records
    nothing."""
    dtype = traj.controls.dtype
    device = traj.controls.device
    batch, n = traj.controls.shape[0], traj.controls.shape[1]
    cc = options.convergence_criteria
    ls = options.line_search_params
    ops = _problem_operands(params, cost, batch, n, dt_s, dtype, device)
    kw = dict(dtype=dtype, device=device)
    live = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    best = [torch.empty((n, d, batch), **kw) for d in (4, 3, 6, CONTROL_DIM)]
    cost_out = torch.empty((batch,), **kw)
    iters = torch.empty((batch,), dtype=torch.int32, device=device)
    status = torch.empty((batch,), dtype=torch.int32, device=device)
    # k | K of every stage, one contiguous row per scenario (csrc/team.cuh)
    gains = torch.empty((n, batch, GAINS_WIDTH), **kw)
    # the kernel writes the rows of the trips a lane ran; the rest stay 0
    hist = torch.zeros((int(cc.max_iters), batch), **kw) if history else None
    counts = [torch.empty((batch,), dtype=torch.int32, device=device) if probes else None
              for _ in range(2)]
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device), *live, cost_out, iters, status, gains, *best, hist,
         *counts],
        ints=[int(cc.max_iters), int(ls.max_iters)],
        reals=[options.quu_reg, cc.rtol, cc.atol, ls.step_update, ls.desired_reduction_frac],
    )
    _build.launch("qilqr_solve", dtype, ops.ptrs, ops.ints, ops.reals, device)
    hist_t = hist.t() if history else None
    return (_traj_from_lanes(traj.times, *live), cost_out, iters, status, hist_t, *counts)


solve_fused_whole.launches = 0
