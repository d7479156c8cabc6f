"""Proto <-> container converters (`quadrotorilqr_tpu/io/proto.py`): the
reference's converter layer, on the host in float64 numpy. Quaternions are
w, x, y, z, as in trajectory.proto.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lie.se3 import SE3
from ..models.quadrotor import State
from ..solver.ilqr import IterDebug, Trajectory
from ..solver.options import ConvergenceCriteria, ILQROptions, LineSearchParams
from ..tree import tree_map
from . import ilqr_debug_pb2, ilqr_options_pb2, trajectory_pb2


def _np64(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a, np.float64)


def trajectory_to_proto(traj: Trajectory) -> trajectory_pb2.QuadrotorTrajectory:
    """One (N, ...) trajectory as a QuadrotorTrajectory message."""
    times = _np64(traj.times)
    quat = _np64(traj.states.pose.quat)
    trans = _np64(traj.states.pose.trans)
    vel = _np64(traj.states.vel)
    controls = _np64(traj.controls)
    msg = trajectory_pb2.QuadrotorTrajectory()
    for i in range(times.shape[0]):
        pt = msg.points.add()
        pt.time_s = times[i]
        se3_msg = pt.state.inertial_from_body
        se3_msg.translation.c0, se3_msg.translation.c1, se3_msg.translation.c2 = trans[i]
        q = se3_msg.rotation.quaternion
        q.c0, q.c1, q.c2, q.c3 = quat[i]
        v = pt.state.body_velocity
        v.c0, v.c1, v.c2, v.c3, v.c4, v.c5 = vel[i]
        c = pt.control
        c.c0, c.c1, c.c2, c.c3 = controls[i]
    return msg


def trajectory_from_proto(
    msg: trajectory_pb2.QuadrotorTrajectory, dtype=torch.float64, device=None
) -> Trajectory:
    n = len(msg.points)
    times = np.zeros(n)
    quat = np.zeros((n, 4))
    trans = np.zeros((n, 3))
    vel = np.zeros((n, 6))
    controls = np.zeros((n, 4))
    for i, pt in enumerate(msg.points):
        times[i] = pt.time_s
        se3_msg = pt.state.inertial_from_body
        trans[i] = (se3_msg.translation.c0, se3_msg.translation.c1, se3_msg.translation.c2)
        q = se3_msg.rotation.quaternion
        quat[i] = (q.c0, q.c1, q.c2, q.c3)
        v = pt.state.body_velocity
        vel[i] = (v.c0, v.c1, v.c2, v.c3, v.c4, v.c5)
        controls[i] = (pt.control.c0, pt.control.c1, pt.control.c2, pt.control.c3)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return Trajectory(
        times=as_t(times),
        states=State(pose=SE3(quat=as_t(quat), trans=as_t(trans)), vel=as_t(vel)),
        controls=as_t(controls),
    )


def options_to_proto(options: ILQROptions) -> ilqr_options_pb2.ILQROptions:
    """`quu_reg` has no field in the reference schema: it does not survive a
    round trip."""
    msg = ilqr_options_pb2.ILQROptions()
    ls, cc = options.line_search_params, options.convergence_criteria
    msg.line_search_params.step_update = ls.step_update
    msg.line_search_params.desired_reduction_frac = ls.desired_reduction_frac
    msg.line_search_params.max_iters = ls.max_iters
    msg.convergence_criteria.rtol = cc.rtol
    msg.convergence_criteria.atol = cc.atol
    msg.convergence_criteria.max_iters = cc.max_iters  # a double field, as the reference's
    msg.populate_debug = options.populate_debug
    return msg


def options_from_proto(msg: ilqr_options_pb2.ILQROptions) -> ILQROptions:
    return ILQROptions(
        line_search_params=LineSearchParams(
            step_update=msg.line_search_params.step_update,
            desired_reduction_frac=msg.line_search_params.desired_reduction_frac,
            max_iters=int(msg.line_search_params.max_iters),
        ),
        convergence_criteria=ConvergenceCriteria(
            rtol=msg.convergence_criteria.rtol,
            atol=msg.convergence_criteria.atol,
            max_iters=int(msg.convergence_criteria.max_iters),
        ),
        populate_debug=bool(msg.populate_debug),
    )


def debug_to_proto(debug: IterDebug | None) -> ilqr_debug_pb2.QuadrotorILQRDebug:
    """One solve's debug record as a QuadrotorILQRDebug message, one entry
    per valid slot. None gives an empty message. A `CostHistory` carries no
    trajectories: as in the JAX package, its first valid slot raises
    AttributeError (only an IterDebug crosses the proto boundary)."""
    msg = ilqr_debug_pb2.QuadrotorILQRDebug()
    if debug is None:
        return msg
    valid = np.asarray(debug.valid.detach().cpu().numpy(), bool)
    costs = _np64(debug.costs)
    for i in range(valid.shape[0]):
        if not valid[i]:
            continue
        iter_msg = msg.iter_debugs.add()
        traj_i = tree_map(lambda leaf: leaf[i], debug.trajectories)
        iter_msg.trajectory.CopyFrom(trajectory_to_proto(traj_i))
        iter_msg.cost = costs[i]
    return msg


def debug_from_proto(msg: ilqr_debug_pb2.QuadrotorILQRDebug, dtype=torch.float64, device=None):
    """(list of Trajectory, list of float costs), one per entry."""
    trajs = [trajectory_from_proto(d.trajectory, dtype, device) for d in msg.iter_debugs]
    costs = [d.cost for d in msg.iter_debugs]
    return trajs, costs
