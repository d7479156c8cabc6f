"""Per-pass backward Riccati sweep: CUDA kernel and its plain version.

Counterpart of `quadrotorilqr_tpu/kernels/backward.py:1062`
(`backward_pass_fused` over the Pallas `_backward_kernel`). The CUDA kernel
(`csrc/backward.cu`) runs one team of lanes of a warp per scenario
(`csrc/team.cuh`) on the scenario-minor trajectory (N, d, B) and writes the
gains as one (N, B, P) k|K buffer, the layout the rollout kernel reads (P:
the lane model's `gains_pitch`, 52 for the quadrotor's u = 4); the public
function keeps the JAX signature and hands back batch-leading (B, N, ...)
views of it (`gains_views`). The model family comes from the params type
or `model=` (`kernels.models.lane_model_for`): the wrench and the 6- and
8-rotor multirotors run their own instantiations of the kernel, without
the box and weights variants.

`backward_pass_fused` launches the kernel for CUDA tensors and takes the
plain version, `backward_pass_reference`, only for CPU tensors.

With control limits (`limits=(lo, hi)`) or stage weights on the cost the
kernel runs its box or weights variant (JAX `use_box`, `use_weights`): the
box-QP gains of `solver/constrained.py` and the weighted cost terms; the
plain version is then `constrained.backward_pass_box` or the weighted
`ilqr.backward_pass`. With the augmented-Lagrangian penalty
(`penalty=(pcx, pcu, pcxx, pcuu, pcxu)`, JAX `use_penalty`) it runs the
penalty variant, `kPen` (with or without the weights; the quadrotor's
alone, and not with limits: those raise), built as an object of its own
(`_build.PENALTY`) with the C entry `qilqr_backward_pen`; the host packs the
five operands into one scenario-major (N, B, P_pen) buffer
(`penalty_rows`, P_pen = 12 + u + 144 + u^2 + 12 u = 224 at u = 4), and the
plain version is `ilqr.backward_pass(penalty=...)`.

This module also holds the operand prep shared by every kernel
(`_prep_cost`, `_problem_operands`; JAX `_prep_cost`/`CostBatched`,
`kernels/backward.py:767-842`), the variants' operands (`_variant_operands`;
JAX `_prep_limits`, `kernels/backward.py:1039-1060`) and the gains layout
(`gains_views`, `gains_buffer`).
"""

from __future__ import annotations

import collections
import typing

import torch

from ..costs import quadratic as qc
from ..lie.se3 import SE3
from ..models.quadrotor import State
from ..solver import constrained, ilqr
from . import _build
from .models import QUADROTOR, LaneModel, lane_model_for


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
    """Packed kernel arguments; `tensors` keeps the device buffers alive.
    `variant` holds the box and weights variants' (tensors, ptrs, ints),
    which go after the kernel's own operands (a substepped model's k last
    among the ints); `lm` is the model family's
    lane model, which names the kernel instantiation; `key` names the
    instantiation a launch runs, for the launch counters: the family's
    suffix, then "_box", "_weights" or "_box_weights" for the variants."""

    tensors: list
    ptrs: list
    ints: list
    reals: list
    variant: tuple = ((), (), ())
    lm: LaneModel = QUADROTOR
    key: str = ""

    def extend(self, tensors=(), ints=(), reals=()):
        """Append kernel-specific operands (None for a null pointer), then
        the variant operands."""
        v_tensors, v_ptrs, v_ints = self.variant
        return Operands(
            self.tensors + [t for t in tensors if t is not None] + list(v_tensors),
            self.ptrs + [0 if t is None else t.data_ptr() for t in tensors] + list(v_ptrs),
            self.ints + list(ints) + list(v_ints),
            self.reals + [float(r) for r in reals],
            lm=self.lm,
            key=self.key,
        )

    def entry(self, kernel):
        """The C entry of `kernel` ("backward", ...) for the model family."""
        return f"qilqr_{kernel}{self.lm.suffix}"


def _variant_operands(cost, limits, batch, n, dtype, device, u_dim):
    """The box and weights variants' operands in csrc/team.cuh's packed
    order (`variant_from`): (tensors, ptrs lo hi w, ints s_box s_w). The
    bounds are (4,) shared or (4, B) per scenario (`constrained.prep_limits`
    broadcasts mixed shapes up), the weights (N,) shared or (N, B); a
    pointer is 0 where its variant is off."""
    lo = hi = w = None
    s_box = s_w = 0
    if limits is not None:
        lo, hi = constrained.prep_limits(limits, batch, dtype, device, u_dim)
        s_box = int(lo.ndim == 2)
        if s_box:
            lo, hi = lo.t().contiguous(), hi.t().contiguous()
    if cost.stage_weights is not None:
        w = _on(cost.stage_weights, dtype, device)
        s_w = int(w.ndim == 2)
        if tuple(w.shape) != ((batch, n) if s_w else (n,)):
            raise ValueError(f"stage weights of shape {tuple(w.shape)}: expected ({n},) or ({batch}, {n})")
        w = w.t().contiguous() if s_w else w.contiguous()
    tensors = [lo, hi, w]
    return (
        [t for t in tensors if t is not None],
        [0 if t is None else t.data_ptr() for t in tensors],
        [s_box, s_w],
    )


def variant_key(limits, cost):
    """The launch counters' name of the variants a launch runs: "", "_box",
    "_weights" or "_box_weights"."""
    return ("_box" if limits is not None else "") + (
        "_weights" if cost.stage_weights is not None else "")


def _problem_operands(
    params, cost, batch, n, dt_s, dtype, device, limits=None, model=None
) -> Operands:
    """The operands every kernel reads, in csrc/quadrotor.cuh's order:
    ptrs dq dtr dv du Q R g minv ju iinv_ma inertia inertia_inv (iinv_ma
    null for the wrench; with drag it carries the drag coefficients too);
    ints B N s_des s_qr s_par; reals dt (a substepped model's dt / k); the
    model family's lane model (`lane_model_for(params, model)`); and the box
    and weights variants' operands for `limits` and the cost's stage
    weights, which every kernel reads after its own, then a substepped
    model's k. Only the quadrotor kernels have those variants: with another
    family limits and weights raise, as do a rotor count without kernels
    and substeps that no kernel takes."""
    lm = lane_model_for(params, model)
    if lm.suffix is None:
        raise NotImplementedError(
            ilqr.SUBSTEPS_TODO if lm.substeps > 1 else ilqr.FAMILY_ROTORS_TODO)
    if (limits is not None or cost.stage_weights is not None) and lm.suffix:
        raise NotImplementedError(ilqr.FAMILY_VARIANTS_TODO)
    if n * lm.gains_pitch() * batch >= 2**31:
        raise ValueError(f"B={batch} x N={n} overflows the kernels' 32-bit buffer offsets")
    *cost_ops, cb = _prep_cost(cost, batch, dtype, device)
    *param_ops, params_batched = lm.prep(params, dt_s, dtype, device)
    u = lm.u_dim
    cores = ((n, 4), (n, 3), (n, 6), (n, u), (12, 12), (u, u))
    for op, core, batched in zip(cost_ops, cores, (cb.des,) * 4 + (cb.qr,) * 2):
        if tuple(op.shape) != core + (batch if batched else 1,):
            raise ValueError(f"cost operand of shape {tuple(op.shape)}, expected {core} by lanes")
    for op in param_ops:
        if op is not None and op.shape[-1] != (batch if params_batched else 1):
            raise ValueError(f"params carry {op.shape[-1]} scenarios, the batch {batch}")
    tensors = cost_ops + param_ops
    v_tensors, v_ptrs, v_ints = _variant_operands(cost, limits, batch, n, dtype, device, u)
    if lm.substeps > 1:
        v_ints = v_ints + [lm.substeps]
    return Operands(
        [t for t in tensors if t is not None],
        [0 if t is None else t.data_ptr() for t in tensors],
        [batch, n, int(cb.des), int(cb.qr), int(params_batched)],
        [float(dt_s) / lm.substeps],
        (v_tensors, v_ptrs, v_ints),
        lm,
        lm.suffix + variant_key(limits, cost),
    )


def _traj_lanes(traj, dtype, device, u_dim):
    """(q, t, v, u) of a (B, N, ...) trajectory in the (N, d, B) layout,
    its controls u_dim wide."""
    s = traj.states
    batch, n = traj.controls.shape[:2]
    lanes = [
        _to_lanes(a, dtype, device)
        for a in (s.pose.quat, s.pose.trans, s.vel, traj.controls)
    ]
    for a, d in zip(lanes, (4, 3, 6, u_dim)):
        if tuple(a.shape) != (n, d, batch):
            raise ValueError(f"trajectory leaf of lane shape {tuple(a.shape)}, expected {(n, d, batch)}")
    return lanes


def _traj_from_lanes(times, q, t, v, u):
    """(N, d, B) quat/trans/vel/control buffers -> a (B, N, ...) Trajectory."""
    q, t, v, u = (a.movedim(-1, 0) for a in (q, t, v, u))
    return ilqr.Trajectory(times=times, states=State(pose=SE3(quat=q, trans=t), vel=v), controls=u)


def gains_views(gains, u_dim):
    """(ks (B, N, u), Ks (B, N, u, 12)): views of a (N, B, P) k|K buffer
    (k first, then K row-major, then the row's padding up to P)."""
    ks = gains[..., :u_dim].transpose(0, 1)
    big_ks = gains[..., u_dim:13 * u_dim].unflatten(-1, (u_dim, 12)).transpose(0, 1)
    return ks, big_ks


def gains_buffer(ks, big_ks, dtype, device, pitch):
    """The (N, B, pitch) k|K buffer of (B, N, u) / (B, N, u, 12) gains: the
    buffer itself, without a copy, when they are `gains_views` of one (as
    `backward_pass_fused` returns them); else the gains packed into a new
    one, its padding zero."""
    batch, n, u = ks.shape
    w = pitch
    if (
        ks.dtype == big_ks.dtype == dtype and ks.device == big_ks.device == device
        and ks.stride() == (w, w * batch, 1) and big_ks.stride() == (w, w * batch, 12, 1)
        and big_ks.data_ptr() == ks.data_ptr() + u * ks.element_size()
        and ks.data_ptr() % 16 == 0  # the kernels fetch a row in 16-byte chunks
    ):
        return ks.as_strided((n, batch, w), (w * batch, w, 1))
    pad = torch.zeros((batch, n, w - 13 * u), dtype=dtype, device=device)
    packed = torch.cat([_on(ks, dtype, device), _on(big_ks, dtype, device).flatten(-2), pad], -1)
    return packed.transpose(0, 1).contiguous()


def count_launch(wrapper, key=""):
    """One launch of `wrapper`'s kernel: each wrapper counts its launches per
    instantiation in its Counter `launches`, by `Operands.key` (the C
    entries' family suffix, "" for the quadrotor, then the variants')."""
    wrapper.launches[key] += 1


def _active_lanes(active, batch, device):
    if active is None:
        return None
    if active.shape != (batch,) or active.device != device:
        raise ValueError(f"active mask must be ({batch},) on {device}")
    return active.to(torch.bool).contiguous()


def penalty_width(u_dim):
    """P_pen, the values of one stage's penalty row: pcx 12 | pcu u |
    pcxx 144 | pcuu u^2 | pcxu 12 u (224 at u = 4: whole 16-byte chunks)."""
    return 12 + u_dim + 144 + u_dim * u_dim + 12 * u_dim


def penalty_rows(penalty, dtype, device):
    """The (N, B, P_pen) penalty buffer of `penalty=(pcx (B, N, 12), pcu
    (B, N, u), pcxx (B, N, 12, 12), pcuu (B, N, u, u), pcxu (B, N, 12, u))`,
    each matrix row-major: one copy, and none of the transposes when the
    five are (B, N, ...) views of (N, B, ...) tensors."""
    return torch.cat(
        [_on(a, dtype, device).transpose(0, 1).flatten(2) for a in penalty], -1
    ).contiguous()


def backward_pass_reference(params, cost, traj, dt_s, quu_reg=0.0, limits=None, model=None,
                            penalty=None):
    """Plain PyTorch version: the batched `solver.ilqr.backward_pass` (with
    the augmented-Lagrangian `penalty`), or with limits
    `solver.constrained.backward_pass_box` (the stage weights ride the cost
    in both), on the params' model family (or `model`)."""
    if limits is None:
        return ilqr.backward_pass(params, cost, traj, dt_s, quu_reg, model=model,
                                  penalty=penalty)
    if penalty is not None:
        raise NotImplementedError(ilqr.PENALTY_LIMITS_TODO)
    controls = traj.controls
    box = constrained.prep_limits(
        limits, controls.shape[0], controls.dtype, controls.device, controls.shape[-1]
    )
    return constrained.backward_pass_box(params, cost, traj, dt_s, box, quu_reg, model)


def backward_pass_fused(params, cost, traj, dt_s, quu_reg=0.0, active=None, limits=None,
                        model=None, penalty=None):
    """Batched backward pass over (B, N, ...) trajectories.

    Params and cost leaves may be shared or carry a leading B; the model
    family is the params' (or `model=`). `active` (B,) bool marks the lanes
    whose outputs the caller reads (None: all); the kernel skips the others
    and leaves their outputs unset. `limits=(lo, hi)` (scalars, (4,) or
    (B, 4) each) takes the box-QP gains; stage weights come with the cost.
    `penalty=(pcx, pcu, pcxx, pcuu, pcxu)` ((B, N, ...) each) adds the
    augmented-Lagrangian quadratics (the penalty variant; not with limits).
    Returns (ks (B, N, u), Ks (B, N, u, 12), QuTk (B,), kTQuuk (B,)); on the
    card ks and Ks are views of one (N, B, P) buffer (`gains_views`)."""
    controls = traj.controls
    device = controls.device
    if device.type == "cpu":
        return backward_pass_reference(params, cost, traj, dt_s, quu_reg, limits, model, penalty)
    _check_cuda(device)
    batch, n = controls.shape[0], controls.shape[1]
    ops = _problem_operands(
        params, cost, batch, n, dt_s, controls.dtype, device, limits, model
    )
    pen = None if penalty is None else penalty_rows(penalty, controls.dtype, device)
    return _launch(ops, traj, quu_reg, active, pen)


def _check_penalty(ops, pen, batch, n, dtype):
    """The penalty variant's refusals and the (N, B, P_pen) buffer's shape,
    dtype and alignment."""
    if ops.lm.suffix:
        raise NotImplementedError(ilqr.FAMILY_VARIANTS_TODO)
    if "_box" in ops.key:
        raise NotImplementedError(ilqr.PENALTY_LIMITS_TODO)
    want = (n, batch, penalty_width(ops.lm.u_dim))
    if (tuple(pen.shape) != want or pen.dtype != dtype or not pen.is_contiguous()
            or pen.data_ptr() % 16):
        raise ValueError(f"penalty rows of shape {tuple(pen.shape)} and {pen.dtype}: expected "
                         f"contiguous {want} of {dtype}, 16-byte aligned")


def _launch(ops, traj, quu_reg, active, pen=None):
    """The kernel on CUDA tensors, with the Problem operands `ops` packed
    by `_problem_operands`; with `pen`, the (N, B, P_pen) penalty rows
    (`penalty_rows`), the penalty variant (C entry `qilqr_backward_pen`,
    counted under "_pen" or "_pen_weights")."""
    controls = traj.controls
    dtype, device = controls.dtype, controls.device
    batch, n = controls.shape[0], controls.shape[1]
    u = ops.lm.u_dim
    entry, key = ops.entry("backward"), ops.key
    if pen is not None:
        _check_penalty(ops, pen, batch, n, dtype)
        entry, key = "qilqr_backward_pen", "_pen" + ops.key
    gains = torch.empty((n, batch, ops.lm.gains_pitch()), dtype=dtype, device=device)
    red = torch.empty((2, batch), dtype=dtype, device=device)
    ops = ops.extend(
        [*_traj_lanes(traj, dtype, device, u), _active_lanes(active, batch, device), gains, red],
        reals=[quu_reg],
    )
    ptrs = ops.ptrs
    if pen is not None:
        ops.tensors.append(pen)
        ptrs = ptrs + [pen.data_ptr()]
    _build.launch(entry, dtype, ptrs, ops.ints, ops.reals, device)
    count_launch(backward_pass_fused, key)
    return (*gains_views(gains, u), red[0], red[1])


backward_pass_fused.launches = collections.Counter()
