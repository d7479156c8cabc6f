"""Per-pass backward Riccati sweep: CUDA kernel and its plain version.

Counterpart of `quadrotorilqr_tpu/kernels/backward.py:1062`
(`backward_pass_fused` over the Pallas `_backward_kernel`). The CUDA kernel
(`csrc/backward.cu`) runs one team of lanes of a warp per scenario
(`csrc/team.cuh`) on the scenario-minor trajectory (N, d, B) and writes the
gains as one (N, B, 52) k|K buffer, the layout the rollout kernel reads; the
public function keeps the JAX signature and hands back batch-leading
(B, N, ...) views of it (`gains_views`).

`backward_pass_fused` launches the kernel for CUDA tensors and takes the
plain version, `backward_pass_reference`, only for CPU tensors.

This module also holds the operand prep shared by every kernel
(`_prep_cost`, `_problem_operands`; JAX `_prep_cost`/`CostBatched`,
`kernels/backward.py:767-842`) and the gains layout (`gains_views`,
`gains_buffer`).
"""

from __future__ import annotations

import typing

import torch

from ..costs import quadratic as qc
from ..lie.se3 import SE3
from ..models.quadrotor import CONTROL_DIM, State
from ..solver import ilqr
from . import _build
from .models import prep_params


# a row of the gains buffer: k (4), then K (4 x 12) row-major
GAINS_WIDTH = CONTROL_DIM + CONTROL_DIM * 12


class CostBatched(typing.NamedTuple):
    """Which cost operand groups are per-scenario (B-stride 1) rather than
    shared (B-stride 0)."""

    des: bool  # desired q/t/v/u targets
    qr: bool  # Q/R weight matrices


def _check_cuda(device):
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, not {device} tensors")


def _on(a, dtype, device):
    if a.device != device:
        raise ValueError(f"operand on {a.device}, the trajectory on {device}")
    return a.to(dtype)


def _to_lanes(a, dtype, device):
    """(B, N, d...) -> contiguous (N, d..., B)."""
    return _on(a, dtype, device).movedim(0, -1).contiguous()


def _prep_cost(cost, batch, dtype, device):
    """Lane-layout cost operands: each group is per-scenario (..., B) iff a
    leaf of that group carries a leading batch dim (shared leaves of a
    batched group are broadcast up), else one shared lane (..., 1).

    Returns (des_q, des_t, des_v, des_u, Q, R, CostBatched)."""
    des = cost.desired_states
    flags = qc.cost_batched_flags(cost)
    des_b = (
        flags.desired_controls or flags.desired_states.pose.quat
        or flags.desired_states.pose.trans or flags.desired_states.vel
    )
    qr_b = flags.Q or flags.R

    def prep(a, batched):
        a = _on(a, dtype, device)
        if not batched:
            return a[..., None].contiguous()
        if a.ndim == 2:  # shared leaf in a per-scenario group
            a = a.expand((batch,) + a.shape)
        return a.movedim(0, -1).contiguous()

    return (
        prep(des.pose.quat, des_b),
        prep(des.pose.trans, des_b),
        prep(des.vel, des_b),
        prep(cost.desired_controls, des_b),
        prep(cost.Q, qr_b),
        prep(cost.R, qr_b),
        CostBatched(des_b, qr_b),
    )


class Operands(typing.NamedTuple):
    """Packed kernel arguments; `tensors` keeps the device buffers alive."""

    tensors: list
    ptrs: list
    ints: list
    reals: list

    def extend(self, tensors=(), ints=(), reals=()):
        """Append kernel-specific operands (None for a null pointer)."""
        return Operands(
            self.tensors + [t for t in tensors if t is not None],
            self.ptrs + [0 if t is None else t.data_ptr() for t in tensors],
            self.ints + list(ints),
            self.reals + [float(r) for r in reals],
        )


def _problem_operands(params, cost, batch, n, dt_s, dtype, device) -> Operands:
    """The operands every kernel reads, in csrc/quadrotor.cuh's order:
    ptrs dq dtr dv du Q R g minv ju iinv_ma inertia inertia_inv;
    ints B N s_des s_qr s_par; reals dt."""
    qc.check_supported(cost)
    if n * CONTROL_DIM * 12 * batch >= 2**31:
        raise ValueError(f"B={batch} x N={n} overflows the kernels' 32-bit buffer offsets")
    *cost_ops, cb = _prep_cost(cost, batch, dtype, device)
    *param_ops, params_batched = prep_params(params, dt_s, dtype, device)
    cores = ((n, 4), (n, 3), (n, 6), (n, CONTROL_DIM), (12, 12), (CONTROL_DIM, CONTROL_DIM))
    for op, core, batched in zip(cost_ops, cores, (cb.des,) * 4 + (cb.qr,) * 2):
        if tuple(op.shape) != core + (batch if batched else 1,):
            raise ValueError(f"cost operand of shape {tuple(op.shape)}, expected {core} by lanes")
    for op in param_ops:
        if op.shape[-1] != (batch if params_batched else 1):
            raise ValueError(f"params carry {op.shape[-1]} scenarios, the batch {batch}")
    tensors = cost_ops + param_ops
    return Operands(
        tensors,
        [t.data_ptr() for t in tensors],
        [batch, n, int(cb.des), int(cb.qr), int(params_batched)],
        [float(dt_s)],
    )


def _traj_lanes(traj, dtype, device):
    """(q, t, v, u) of a (B, N, ...) trajectory in the (N, d, B) layout."""
    s = traj.states
    batch, n = traj.controls.shape[:2]
    lanes = [
        _to_lanes(a, dtype, device)
        for a in (s.pose.quat, s.pose.trans, s.vel, traj.controls)
    ]
    for a, d in zip(lanes, (4, 3, 6, CONTROL_DIM)):
        if tuple(a.shape) != (n, d, batch):
            raise ValueError(f"trajectory leaf of lane shape {tuple(a.shape)}, expected {(n, d, batch)}")
    return lanes


def _traj_from_lanes(times, q, t, v, u):
    """(N, d, B) quat/trans/vel/control buffers -> a (B, N, ...) Trajectory."""
    q, t, v, u = (a.movedim(-1, 0) for a in (q, t, v, u))
    return ilqr.Trajectory(times=times, states=State(pose=SE3(quat=q, trans=t), vel=v), controls=u)


def gains_views(gains):
    """(ks (B, N, 4), Ks (B, N, 4, 12)): views of a (N, B, 52) k|K buffer."""
    ks = gains[..., :CONTROL_DIM].transpose(0, 1)
    big_ks = gains[..., CONTROL_DIM:].unflatten(-1, (CONTROL_DIM, 12)).transpose(0, 1)
    return ks, big_ks


def gains_buffer(ks, big_ks, dtype, device):
    """The (N, B, 52) k|K buffer of (B, N, 4) / (B, N, 4, 12) gains: the
    buffer itself, without a copy, when they are `gains_views` of one (as
    `backward_pass_fused` returns them); else the gains packed into a new
    one."""
    batch, n = ks.shape[:2]
    w = GAINS_WIDTH
    if (
        ks.dtype == big_ks.dtype == dtype and ks.device == big_ks.device == device
        and ks.stride() == (w, w * batch, 1) and big_ks.stride() == (w, w * batch, 12, 1)
        and big_ks.data_ptr() == ks.data_ptr() + CONTROL_DIM * ks.element_size()
        and ks.data_ptr() % 16 == 0  # the kernels fetch a row in 16-byte chunks
    ):
        return ks.as_strided((n, batch, w), (w * batch, w, 1))
    packed = torch.cat([_on(ks, dtype, device), _on(big_ks, dtype, device).flatten(-2)], -1)
    return packed.transpose(0, 1).contiguous()


def _active_lanes(active, batch, device):
    if active is None:
        return None
    if active.shape != (batch,) or active.device != device:
        raise ValueError(f"active mask must be ({batch},) on {device}")
    return active.to(torch.bool).contiguous()


def backward_pass_reference(params, cost, traj, dt_s, quu_reg=0.0):
    """Plain PyTorch version: the batched `solver.ilqr.backward_pass`."""
    return ilqr.backward_pass(params, cost, traj, dt_s, quu_reg)


def backward_pass_fused(params, cost, traj, dt_s, quu_reg=0.0, active=None):
    """Batched backward pass over (B, N, ...) trajectories.

    Params and cost leaves may be shared or carry a leading B. `active` (B,)
    bool marks the lanes whose outputs the caller reads (None: all); the
    kernel skips the others and leaves their outputs unset.
    Returns (ks (B, N, 4), Ks (B, N, 4, 12), QuTk (B,), kTQuuk (B,)); on the
    card ks and Ks are views of one (N, B, 52) buffer (`gains_views`)."""
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        return backward_pass_reference(params, cost, traj, dt_s, quu_reg)
    _check_cuda(device)
    batch, n = controls.shape[0], controls.shape[1]
    ops = _problem_operands(params, cost, batch, n, dt_s, controls.dtype, device)
    return _launch(ops, traj, quu_reg, active)


def _launch(ops, traj, quu_reg, active):
    """The kernel on CUDA tensors, with the Problem operands `ops` packed
    by `_problem_operands`."""
    controls = traj.controls
    dtype, device = controls.dtype, controls.device
    batch, n = controls.shape[0], controls.shape[1]
    gains = torch.empty((n, batch, GAINS_WIDTH), dtype=dtype, device=device)
    red = torch.empty((2, batch), dtype=dtype, device=device)
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device), _active_lanes(active, batch, device), gains, red],
        reals=[quu_reg],
    )
    _build.launch("qilqr_backward", dtype, ops.ptrs, ops.ints, ops.reals, device)
    backward_pass_fused.launches += 1
    return (*gains_views(gains), red[0], red[1])


backward_pass_fused.launches = 0
