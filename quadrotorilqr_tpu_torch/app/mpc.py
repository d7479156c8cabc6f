"""Receding-horizon MPC on the iLQR engine (BASELINE config 4).

Counterpart of `quadrotorilqr_tpu/app/mpc.py`. Per control tick k, batched
over a fleet of B vehicles:
  1. window the desired trajectory to stages [k, k + H),
  2. solve from the plant's current state, warm-started with the previous
     solution shifted by one stage (the last stage repeated),
  3. apply the first optimized control to the plant (one Euler step, on
     the plant's own parameters when they differ from the model's),
  4. carry the shifted solution as the next warm start.

The JAX package compiles the loop into one `lax.scan`; here it is a Python
loop of ticks. The plant state, the warm start and the outputs stay on the
device: a tick reads nothing back to the host beyond what its solver syncs.
`latency_kernel=True` solves each window in one `solve.cu` launch, which
syncs nothing; the per-pass route (`latency_kernel=False`,
`solver.batched.solve_batch_fused`) syncs once per trip and once per
line-search probe, where the reference loop asks whether any lane is still
running. `stage_weights` ((H,) or (B, H); terminal emphasis [1, ..., 1,
w_T]) and `limits=(lo, hi)` (rotor saturation) run the kernels' weights and
box variants, so the applied controls respect the box by construction.
`solver="fddp"` solves each window with the robust multiple-shooting loop
(`solver.batched.solve_batch_fddp`: one `fddp.cu` launch a tick, its plain
loop on the CPU), for disturbance recovery where the exact loop's trip-0
rollout can diverge; `fddp_options` tunes it (`solver.fddp.FDDPOptions`).
"""

from __future__ import annotations

import torch

from ..costs.quadratic import QuadraticTrackingCost
from ..models import quadrotor as qm
from ..models.quadrotor import State
from ..parallel.batch import initial_trajectory_from_state
from ..solver.batched import solve_batch_fddp, solve_batch_fused, solve_batch_latency
from ..solver.ilqr import Trajectory
from ..solver.options import ILQROptions
from ..tree import tree_map


def _window(tree, k, h):
    """Stages [k, k + h) of every leaf of an unbatched (N, ...) tree."""
    return tree_map(lambda a: a[k:k + h], tree)


def _shift(traj: Trajectory) -> Trajectory:
    """Shift one stage forward, repeating the final stage (warm start)."""

    def shift_leaf(a):
        return torch.cat([a[:, 1:], a[:, -1:]], 1)

    return Trajectory(
        times=traj.times,
        states=tree_map(shift_leaf, traj.states),
        controls=shift_leaf(traj.controls),
    )


def _set_first_state(states: State, x: State) -> State:
    """(B, H, ...) states with stage 0 replaced by x (B, ...)."""
    return tree_map(lambda buf, v: torch.cat([v[:, None], buf[:, 1:]], 1), states, x)


def mpc_warm_start(desired_full: Trajectory, x0: State, horizon: int) -> Trajectory:
    """The first warm start: the desired trajectory's first window tiled over
    the batch, with the plant state at stage 0 (the solver's trip-0 rollout
    makes it feasible)."""
    return initial_trajectory_from_state(x0, _window(desired_full, 0, horizon))


def _mpc_step_impl(
    params, q_weight, r_weight, desired_full, x, warm, k, horizon, dt_s, options,
    latency_kernel=False, stage_weights=None, limits=None, solver="ilqr",
    fddp_options=None, plant_params=None,
):
    """One receding-horizon tick (shared by `run_mpc` and `mpc_step`):
    window the targets, solve warm-started, apply the first control, shift
    the solution. Returns (x_next, warm_next, u0, SolveResult)."""
    if solver not in ("ilqr", "fddp"):
        # a typo (or "fddp-ddp") must not run the exact loop in its place
        raise ValueError(f"unknown MPC solver {solver!r} (use 'ilqr' or 'fddp')")
    win = _window(desired_full, k, horizon)
    cost_k = QuadraticTrackingCost(
        Q=q_weight,
        R=r_weight,
        desired_states=win.states,
        desired_controls=win.controls,
        stage_weights=stage_weights,
    )
    init_traj = Trajectory(
        times=warm.times, states=_set_first_state(warm.states, x), controls=warm.controls
    )
    if solver == "fddp":
        res = solve_batch_fddp(params, cost_k, init_traj, dt_s, options, fddp_options,
                               limits=limits)
    else:
        engine = solve_batch_latency if latency_kernel else solve_batch_fused
        res = engine(params, cost_k, init_traj, dt_s, options, limits=limits)
    u0 = res.trajectory.controls[:, 0]
    # the plant may differ from the controller's model (parameter mismatch,
    # the condition a deployed loop runs under); None is the exact model
    x_next = qm.discrete_dynamics(params if plant_params is None else plant_params, x, u0, dt_s)
    return x_next, _shift(res.trajectory), u0, res


def mpc_step(
    params,
    q_weight,
    r_weight,
    desired_full: Trajectory,
    x: State,
    warm: Trajectory,
    k: int,
    horizon: int,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    latency_kernel: bool = False,
    stage_weights=None,
    limits=None,
    solver: str = "ilqr",
    fddp_options=None,
):
    """One tick for host-driven loops, where the per-tick latency
    distribution (p99 and max against the control period) certifies a
    control rate. Returns (x_next, warm_next, u0); keep x and warm on the
    device and read only u0 back. The plant is the controller's model."""
    x_next, warm_next, u0, _ = _mpc_step_impl(
        params, q_weight, r_weight, desired_full, x, warm, k, horizon, dt_s, options,
        latency_kernel, stage_weights, limits, solver, fddp_options,
    )
    return x_next, warm_next, u0


def run_mpc(
    params,
    q_weight,
    r_weight,
    desired_full: Trajectory,
    x0: State,
    n_steps: int,
    horizon: int,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    latency_kernel: bool = False,
    stage_weights=None,
    limits=None,
    solver: str = "ilqr",
    fddp_options=None,
    plant_params=None,
    warm0=None,
):
    """Run `n_steps` ticks of warm-started receding-horizon control.

    desired_full leaves are unbatched ((N_full, ...), N_full >= n_steps +
    horizon); x0 leaves are (B, ...), any B. Returns a dict: the applied
    controls "u" (B, K, 4), the plant translation before each tick
    "x_trans" (B, K, 3), each tick's solver "iterations", "cost" and
    "status" (B, K), the final plant state "x_final" and "warm_final", the
    shifted last solution, so that a chunked driver resumes the loop exactly
    (`warm0` overrides the cold warm start). `k` counts from 0 within one
    call: a chunked driver windows desired_full per chunk."""
    n_full = desired_full.controls.shape[0]
    if n_full < n_steps + horizon:
        # a short slice would track stale targets in the last windows
        raise ValueError(
            f"desired trajectory has {n_full} stages; receding over "
            f"{n_steps} steps with horizon {horizon} needs >= {n_steps + horizon}"
        )
    x = x0
    warm = mpc_warm_start(desired_full, x0, horizon) if warm0 is None else warm0
    batch = x0.vel.shape[0]
    kw = dict(device=x0.vel.device)
    out = {
        "u": torch.empty((batch, n_steps, 4), dtype=x0.vel.dtype, **kw),
        "x_trans": torch.empty((batch, n_steps, 3), dtype=x0.vel.dtype, **kw),
        "iterations": torch.empty((batch, n_steps), dtype=torch.int32, **kw),
        "cost": torch.empty((batch, n_steps), dtype=x0.vel.dtype, **kw),
        "status": torch.empty((batch, n_steps), dtype=torch.int32, **kw),
    }
    for k in range(n_steps):
        out["x_trans"][:, k] = x.pose.trans
        x, warm, u0, res = _mpc_step_impl(
            params, q_weight, r_weight, desired_full, x, warm, k, horizon, dt_s, options,
            latency_kernel, stage_weights, limits, solver, fddp_options, plant_params,
        )
        out["u"][:, k] = u0
        out["iterations"][:, k] = res.iterations
        out["cost"][:, k] = res.cost
        out["status"][:, k] = res.status
    out["x_final"] = x
    out["warm_final"] = warm
    return out
