"""Public API: `QuadrotorILQR`, the counterpart of `quadrotorilqr_tpu/api.py`.

The reference binding's ten-argument constructor, taking the desired
trajectory and the options as protos (`QuadrotorTrajectory`,
`ILQROptions`) or as the port's containers, and its proto-in / proto-out
`solve(traj) -> (trajectory proto, debug proto)`. `solve_pytree` is the
exact single solve on the plain loop; `solve_batch` routes a (B, N, ...)
batch as the JAX class does: `fused=True` with `latency=True` to the
whole-solve kernel, `fused=True` alone to the per-pass kernel loop,
`fused=False` to the plain batched solver. With `solver="fddp"` (or
`"fddp-ddp"`, exact curvature throughout) a float32 batch goes to the FDDP
kernel through `solve_batch_fddp(refine="auto")`, a float64 batch to the
single-phase FDDP kernel, `fused=False` and `solve_pytree` to the plain FDDP
loop. Past 256 stages (exact) and 231 (FDDP) the batch solvers take the
streamed kernels, as the JAX class's routes do: `latency=True` runs
`stream.cu`, and each FDDP launch `stream_fddp.cu`.

`stage_weights` ((N,) per-stage cost multipliers, e.g. terminal emphasis
[1, ..., 1, w_T]) weight the full stage cost on every route: the plain
loops, exact and FDDP, and every kernel's weights variant (the per-pass
kernels, `solve.cu` and `stream.cu`, `fddp.cu` and `stream_fddp.cu` in each
phase of `refine="auto"`, the exact-DDP one included). Control limits are
not an argument of the class, as in the JAX package: they go to
`solver.batched` and `app.mpc`.

`options.populate_debug` fills `SolveResult.debug`: an IterDebug (one
trajectory and cost per executed update) from `solve_pytree`, `fused=False`
and the per-pass route, a CostHistory (the costs alone, recorded by the
kernel) from `latency=True` up to 256 stages; `solve` sends the IterDebug
out as the debug proto. The FDDP solvers have no debug record and refuse
it.

Routing differences: the JAX class sends float64 batches to its XLA
solvers because the TPU kernels have no float64. The CUDA kernels take both
float32 and float64, so here both dtypes go to the kernel engines (lane for
lane the same results as the plain solvers); a float64 `latency=True` batch
with `populate_debug` therefore carries a CostHistory where the JAX class's
carries an IterDebug.

The solver runs on the CUDA card unless it is given `device="cpu"`; with no
card it refuses to start rather than carry on on the CPU. Only the proto
surface needs `google.protobuf`: `quadrotorilqr_tpu_torch.io` is imported
when a proto is passed in or `solve` is called.
"""

from __future__ import annotations

import torch

from .costs.quadratic import QuadraticTrackingCost
from .models.quadrotor import QuadrotorParams
from .solver import fddp, ilqr
from .solver.batched import solve_batch_fddp, solve_batch_fused, solve_batch_latency
from .solver.ilqr import SolveResult, Trajectory
from .solver.options import ILQROptions
from .tree import tree_map

FDDP_DEBUG = (
    "the FDDP solvers have no debug record (as in the JAX package): "
    "populate_debug needs solver='ilqr'"
)
SOLVER_TODO = "solver='ddp' is not ported yet (ROADMAP Queue 1 item 10, solver/ddp.py)"
NO_CUDA = (
    "QuadrotorILQR runs on a CUDA card by default and torch.cuda.is_available() "
    "is false; pass device='cpu' to solve on the CPU"
)


def _io():
    """The proto converters, imported on first use: they need protobuf."""
    from . import io

    return io


class QuadrotorILQR:
    """SE(3) quadrotor iLQR solver."""

    def __init__(
        self,
        mass_kg: float,
        inertia,
        arm_length_m: float,
        torque_to_thrust_ratio_m: float,
        g_mpss: float,
        Q,
        R,
        desired_traj,
        dt_s: float,
        options,
        dtype=torch.float64,
        device=None,
        stage_weights=None,
        solver: str = "ilqr",
    ):
        if solver not in ("ilqr", "ddp", "fddp", "fddp-ddp"):
            raise ValueError(f"unknown solver {solver!r}")
        if solver == "ddp":
            raise NotImplementedError(SOLVER_TODO)
        if not isinstance(options, ILQROptions):
            options = _io().options_from_proto(options)
        if options.populate_debug and solver != "ilqr":
            raise NotImplementedError(FDDP_DEBUG)
        self.solver = solver
        self.dtype = dtype
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(NO_CUDA)
            device = "cuda"
        self.device = torch.device(device)
        if not isinstance(desired_traj, Trajectory):
            desired_traj = _io().trajectory_from_proto(desired_traj, dtype, self.device)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.params = QuadrotorParams.create(
            mass_kg=mass_kg,
            inertia=as_t(inertia),
            arm_length_m=arm_length_m,
            torque_to_thrust_ratio_m=torque_to_thrust_ratio_m,
            g_mpss=g_mpss,
        ).validate()
        self.desired_traj = self._cast(desired_traj)
        self.cost = QuadraticTrackingCost(
            Q=as_t(Q),
            R=as_t(R),
            desired_states=self.desired_traj.states,
            desired_controls=self.desired_traj.controls,
            stage_weights=None if stage_weights is None else as_t(stage_weights),
        )
        self.dt_s = float(dt_s)
        self.options = options

    def _cast(self, traj: Trajectory) -> Trajectory:
        return tree_map(lambda a: a.to(dtype=self.dtype, device=self.device), traj)

    def solve(self, initial_traj):
        """The reference binding's solve: a QuadrotorTrajectory proto (or the
        port's Trajectory) in, (optimized trajectory proto, debug proto)
        out; the debug proto has one entry per executed update with
        `options.populate_debug`, none otherwise."""
        io = _io()
        if not isinstance(initial_traj, Trajectory):
            initial_traj = io.trajectory_from_proto(initial_traj, self.dtype, self.device)
        result = self.solve_pytree(initial_traj)
        return io.trajectory_to_proto(result.trajectory), io.debug_to_proto(result.debug)

    def solve_pytree(self, initial_traj: Trajectory) -> SolveResult:
        """Solve of one (N, ...) trajectory (or a (B, N, ...) batch) on the
        plain solver: the exact loop, or plain FDDP for the fddp solvers, on
        the solver's device. There is no single-solve kernel route, as the
        JAX class keeps its single solve on XLA."""
        if initial_traj.horizon != self.desired_traj.horizon:
            raise IndexError(
                f"initial trajectory length {initial_traj.horizon} != desired "
                f"{self.desired_traj.horizon}"
            )
        args = (self.params, self.cost, self._cast(initial_traj), self.dt_s, self.options)
        if self.solver in ("fddp", "fddp-ddp"):
            return fddp.solve_fddp(*args, ddp=self.solver == "fddp-ddp")
        return ilqr.solve(*args)

    def solve_batch(
        self, initial_trajs: Trajectory, fused: bool = True, latency: bool = False
    ) -> SolveResult:
        """Batched solve over a leading scenario dim (leaves (B, N, ...))."""
        trajs = self._cast(initial_trajs)
        args = (self.params, self.cost, trajs, self.dt_s, self.options)
        if self.solver in ("fddp", "fddp-ddp"):
            ddp = self.solver == "fddp-ddp"
            if not fused:
                return fddp.solve_fddp(*args, ddp=ddp)
            # float32 takes the measured-best robust schedule (Gauss-Newton,
            # then exact-DDP curvature); float64 the single-phase kernel,
            # lane for lane the JAX float64 route vmap(solve_fddp)
            refine = "auto" if self.dtype == torch.float32 else None
            return solve_batch_fddp(*args, ddp=ddp, refine=refine)
        if not fused:
            return ilqr.solve(*args)
        if latency:
            return solve_batch_latency(*args)
        return solve_batch_fused(*args)
