"""Full-DDP curvature in closed form, batched PyTorch (the analytic part of
`quadrotorilqr_tpu/solver/ddp.py`).

For the quadrotor the discrete step is a Lie-Euler pose step plus a velocity
drift [-g R^T e_z; -I^-1 (w x I w)] plus control-affine actuation, so
f_uu = f_ux = 0 and exact DDP adds two terms to the iLQR stage, both in Q_xx:

  * sum_i (v_x)_i f_xx[i] (`vfxx_analytic`), weighted by the incoming value
    gradient (FDDP passes the gap-transported one);
  * the exact state Hessian of the cost: Gauss-Newton plus the curvature of
    the Lie (-) residual in the pose block (`exact_cxx_analytic`).

Both are the formulas the CUDA kernels evaluate (kernels/csrc/quadrotor.cuh,
`kDdp`). The nested-autodiff tensors of the JAX module (`stage_curvatures`,
`stage_curvatures_joint`) and the `solver="ddp"` backward pass are not
ported; they raise, naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from ..lie import se3, so3
from ..ops.linalg import chol_solve_small

DDP_PASS_TODO = (
    "backward_pass_ddp (solver='ddp') is not ported yet (ROADMAP Queue 1 item 10, solver/ddp.py)"
)
NESTED_CURVATURE_TODO = (
    "the nested-autodiff curvature tensors are not ported; the quadrotor uses the "
    "closed forms (ROADMAP Queue 1 item 11, model families)"
)


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _ad_cotangent_matrix(w):
    """C(w) with w^T ad_u y = u^T C(w) y on se(3) ([lin, ang] order):
    [[0, -hat(w_rho)], [-hat(w_rho), -hat(w_theta)]]."""
    hr = so3.hat(w[..., 0:3])
    ht = so3.hat(w[..., 3:6])
    top = torch.cat([torch.zeros_like(hr), -hr], -1)
    bot = torch.cat([-hr, -ht], -1)
    return torch.cat([top, bot], -2)


def _sym(m):
    return 0.5 * (m + m.transpose(-1, -2))


def vfxx_analytic(dt_s, quat, vel, g_mpss, inertia, inertia_inv, v_x):
    """Closed-form sum_i (v_x)_i f_xx[i] (..., 12, 12), symmetric.

    With a = dt vel, Jr = Jr_SE3(a), Adj = Adj(Exp(a))^-1, w_p = v_x[0:6]:
      (tau_p, tau_v): dt/2 Adj^T C(w_p) Jr
      (tau_v, tau_v): dt^2 sym(Jr^T C(w_p) Jr / 2 + D[Jr^T w_p]^T)
      gravity (theta, theta): dt (-g/2) (w r^T + r w^T - 2 (w.r) I),
                              w = v_x[6:9], r = R^T e_z
      gyroscopic (omega, omega): dt (hat(y) I - I hat(y)), y = I^-1 v_x[9:12]
    `g_mpss` is (...) and the inertias (..., 3, 3), shared or per scenario."""
    a = dt_s * vel
    jr = se3.right_jacobian(a)
    adj_inv = se3.adjoint(se3.inverse(se3.exp(a)))
    w_p = v_x[..., 0:6]
    c_w = _ad_cotangent_matrix(w_p)
    g_ps = (0.5 * dt_s) * (adj_inv.transpose(-1, -2) @ c_w @ jr)
    t_hat = se3.right_jacobian_t_jac(a, w_p).transpose(-1, -2)
    g_ss = (dt_s * dt_s) * _sym(0.5 * jr.transpose(-1, -2) @ c_w @ jr + t_hat)

    ez = torch.zeros_like(vel[..., 0:3])
    ez[..., 2] = 1.0
    r_t_ez = so3.quat_rotate(so3.quat_conjugate(quat), ez)
    w_lin = v_x[..., 6:9]
    wr = (w_lin * r_t_ez).sum(-1)[..., None, None]
    eye3 = torch.eye(3, dtype=vel.dtype, device=vel.device)
    g_grav = ((dt_s * -0.5) * g_mpss)[..., None, None] * (
        w_lin[..., :, None] * r_t_ez[..., None, :]
        + r_t_ez[..., :, None] * w_lin[..., None, :]
        - 2.0 * wr * eye3
    )
    hy = so3.hat(_matvec(inertia_inv, v_x[..., 9:12]))
    g_gyro = dt_s * (hy @ inertia - inertia @ hy)

    out = torch.zeros(vel.shape[:-1] + (12, 12), dtype=vel.dtype, device=vel.device)
    out[..., 0:6, 6:12] = g_ps
    out[..., 6:12, 0:6] = g_ps.transpose(-1, -2)
    out[..., 6:12, 6:12] = g_ss
    out[..., 3:6, 3:6] = out[..., 3:6, 3:6] + g_grav
    out[..., 9:12, 9:12] = out[..., 9:12, 9:12] + g_gyro
    return out


def cxx_curvature_correction(tau_p, w_inv, qdx6):
    """Exact minus Gauss-Newton c_xx, nonzero only in the pose block:
    -(sym(C(w~)) + 2 sym(W^T D[Jr(tau_p)^T w~]^T W)), w~ = W^T z, with
    W = Jr(tau_p)^-1 and z = (Q dx)[0:6]. Returns (..., 6, 6)."""
    w_tilde = _matvec(w_inv.transpose(-1, -2), qdx6)
    c_w = _ad_cotangent_matrix(w_tilde)
    t_hat = se3.right_jacobian_t_jac(tau_p, w_tilde).transpose(-1, -2)
    inner = w_inv.transpose(-1, -2) @ t_hat @ w_inv
    return -(_sym(c_w) + 2.0 * _sym(inner))


def exact_cxx_analytic(cost, traj):
    """Exact state Hessians of the tracking cost for every stage,
    (..., N, 12, 12): the Gauss-Newton blocks with the closed-form Lie
    correction added into the pose block (the kernels' order)."""
    from ..costs.quadratic import _weights_over_stages, check_supported

    check_supported(cost)
    des = cost.desired_states
    dx_pose = se3.minus(traj.states.pose, des.pose)
    dx = torch.cat([dx_pose, traj.states.vel - des.vel], -1)
    w_inv = se3.right_jacobian_inv(dx_pose)
    q, _ = _weights_over_stages(cost)
    qdx = _matvec(q, dx)
    qjd_l = q[..., :, 0:6] @ w_inv
    qjd_r = q[..., :, 6:12].expand(qjd_l.shape[:-1] + (6,))
    qjd = torch.cat([qjd_l, qjd_r], -1)
    top = 2.0 * (w_inv.transpose(-1, -2) @ qjd[..., 0:6, :])
    corr = cxx_curvature_correction(dx_pose, w_inv, qdx[..., 0:6])
    top = torch.cat([top[..., 0:6] + corr, top[..., 6:12]], -1)
    return torch.cat([top, 2.0 * qjd[..., 6:12, :]], -2)


def curvature_params(params, dtype):
    """(g, inertia, inertia_inv) operands of `vfxx_analytic`."""
    inertia = params.inertia.to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=inertia.device).expand(inertia.shape)
    return params.g_mpss.to(dtype), inertia, chol_solve_small(inertia, eye3)


def stage_curvatures(*args, **kwargs):
    raise NotImplementedError(NESTED_CURVATURE_TODO)


def stage_curvatures_joint(*args, **kwargs):
    raise NotImplementedError(NESTED_CURVATURE_TODO)


def backward_pass_ddp(*args, **kwargs):
    raise NotImplementedError(DDP_PASS_TODO)
