"""Public API: `QuadrotorILQR`, the counterpart of `quadrotorilqr_tpu/api.py`.

Same ten-argument constructor as the JAX class (the reference binding's),
taking the port's containers (not protos) for the desired trajectory and
an `ILQROptions`. `solve_pytree` is the exact single solve; `solve_batch`
routes a (B, N, ...) batch as the JAX class does: `fused=True` with
`latency=True` to the whole-solve kernel, `fused=True` alone to the
per-pass kernel loop, `fused=False` to the plain batched solver. With
`solver="fddp"` (or `"fddp-ddp"`, exact curvature throughout) a float32
batch goes to the FDDP kernel through `solve_batch_fddp(refine="auto")`,
a float64 batch to the single-phase FDDP kernel, `fused=False` and
`solve_pytree` to the plain FDDP loop. Past 256 stages (exact) and 231
(FDDP) the batch solvers take the streamed kernels, as the JAX class's
routes do: `latency=True` runs `stream.cu`, and each FDDP launch
`stream_fddp.cu`.

One routing difference: the JAX class sends float64 batches to its XLA
solvers because the TPU kernels have no float64. The CUDA kernels take both
float32 and float64, so here both dtypes go to the kernel engines (lane for
lane the same results as the plain solvers).

The solver runs on the CUDA card unless it is given `device="cpu"`; with no
card it refuses to start rather than carry on on the CPU.
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

PROTO_TODO = (
    "proto I/O is not ported yet (ROADMAP Queue 1 item 7, io/proto.py): "
    "use solve_pytree with the port's Trajectory"
)
SOLVER_TODO = "solver='ddp' is not ported yet (ROADMAP Queue 1 item 10, solver/ddp.py)"
NO_CUDA = (
    "QuadrotorILQR runs on a CUDA card by default and torch.cuda.is_available() "
    "is false; pass device='cpu' to solve on the CPU"
)


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
        desired_traj: Trajectory,
        dt_s: float,
        options: ILQROptions,
        dtype=torch.float64,
        device=None,
        stage_weights=None,
        solver: str = "ilqr",
    ):
        if solver not in ("ilqr", "ddp", "fddp", "fddp-ddp"):
            raise ValueError(f"unknown solver {solver!r}")
        if solver == "ddp":
            raise NotImplementedError(SOLVER_TODO)
        if stage_weights is not None:
            from .costs.quadratic import STAGE_WEIGHTS_TODO

            raise NotImplementedError(STAGE_WEIGHTS_TODO)
        if not isinstance(desired_traj, Trajectory) or not isinstance(options, ILQROptions):
            raise NotImplementedError(PROTO_TODO)
        ilqr.check_supported(options)
        self.solver = solver
        self.dtype = dtype
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(NO_CUDA)
            device = "cuda"
        self.device = torch.device(device)
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
        )
        self.dt_s = float(dt_s)
        self.options = options

    def _cast(self, traj: Trajectory) -> Trajectory:
        return tree_map(lambda a: a.to(dtype=self.dtype, device=self.device), traj)

    def solve(self, initial_traj):
        """The reference binding's proto-in / proto-out solve."""
        raise NotImplementedError(PROTO_TODO)

    def solve_pytree(self, initial_traj: Trajectory) -> SolveResult:
        """Solve of one (N, ...) trajectory (or a (B, N, ...) batch) on the
        plain solver: the exact loop, or plain FDDP for the fddp solvers."""
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
