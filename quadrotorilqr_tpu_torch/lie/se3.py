"""SE(3) rigid transforms, batched PyTorch, manif conventions.

Counterpart of `quadrotorilqr_tpu/lie/se3.py`. The group element is
`SE3(quat (..., 4) wxyz, trans (..., 3))`; the tangent is (..., 6) ordered
[linear, angular]. Exp/Log go through the SO(3) left Jacobian, right-plus is
`X * Exp(tau)` and right-minus is `Log(rhs^-1 * lhs)`;
Adj = [[R, hat(t) R], [0, R]] and Jl_SE3 = [[Jl, Q], [0, Jl]] with Q the
Barfoot Q-matrix.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import so3

_SMALL_ANGLE = 1e-3


@dataclass
class SE3:
    """Rigid transform: rotation as unit quaternion (wxyz) and translation."""

    quat: torch.Tensor  # (..., 4)
    trans: torch.Tensor  # (..., 3)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    return SE3(
        quat=so3.quat_identity(batch_shape, dtype, device),
        trans=torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device),
    )


def multiply(a: SE3, b: SE3) -> SE3:
    return SE3(
        quat=so3.quat_multiply(a.quat, b.quat),
        trans=a.trans + so3.quat_rotate(a.quat, b.trans),
    )


def inverse(x: SE3) -> SE3:
    qinv = so3.quat_conjugate(x.quat)
    return SE3(quat=qinv, trans=-so3.quat_rotate(qinv, x.trans))


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def exp(tau) -> SE3:
    """se(3) (..., 6) [lin, ang] -> SE(3)."""
    rho, theta = tau[..., 0:3], tau[..., 3:6]
    return SE3(quat=so3.exp(theta), trans=_matvec(so3.left_jacobian(theta), rho))


def log(x: SE3):
    """SE(3) -> se(3) (..., 6) [lin, ang]."""
    theta = so3.log(x.quat)
    rho = _matvec(so3.left_jacobian_inv(theta), x.trans)
    return torch.cat([rho, theta], -1)


def _block66(a, q, d):
    """[[a, q], [0, d]] from (..., 3, 3) blocks."""
    top = torch.cat([a, q], -1)
    bot = torch.cat([torch.zeros_like(a), d], -1)
    return torch.cat([top, bot], -2)


def adjoint(x: SE3):
    """Adj(X) (..., 6, 6) = [[R, hat(t) R], [0, R]]."""
    r = so3.quat_to_matrix(x.quat)
    return _block66(r, so3.hat(x.trans) @ r, r)


def _q_matrix(tau):
    """Barfoot Q(rho, theta), the upper-right block of Jl_SE3."""
    rho, theta = tau[..., 0:3], tau[..., 3:6]
    theta_sq = (theta * theta).sum(-1)
    small = theta_sq < _SMALL_ANGLE**2
    t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    b_exact = (t - st) / (t2 * t)
    c_exact = (1.0 - 0.5 * t2 - ct) / (t2 * t2)
    e_exact = (t - st - t2 * t / 6.0) / (t2 * t2 * t)
    b_taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    c_taylor = -1.0 / 24.0 + theta_sq / 720.0 - theta_sq * theta_sq / 40320.0
    e_taylor = -1.0 / 120.0 + theta_sq / 5040.0 - theta_sq * theta_sq / 362880.0
    b = torch.where(small, b_taylor, b_exact)[..., None, None]
    c = torch.where(small, c_taylor, c_exact)[..., None, None]
    e = torch.where(small, e_taylor, e_exact)[..., None, None]
    d = c - 3.0 * e

    v = so3.hat(rho)
    w = so3.hat(theta)
    vw = v @ w
    wv = w @ v
    wvw = wv @ w
    vww = vw @ w
    wwv = w @ wv
    return (
        0.5 * v
        + b * (wv + vw + wvw)
        - c * (wwv + vww - 3.0 * wvw)
        - 0.5 * d * (wvw @ w + w @ wvw)
    )


def _q_coeffs_du(theta_sq):
    """(db/du, dc/du, de/du) of the Q-matrix coefficients, u = |theta|^2,
    with so3._ljac_coeffs_du's wider Taylor window (u < 0.25)."""
    small = theta_sq < 0.25
    t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    u = theta_sq
    u2 = t2 * t2
    db_exact = (0.5 * (1.0 - ct) - 1.5 * (t - st) / t) / u2
    c_num = 1.0 - 0.5 * t2 - ct
    dc_exact = (0.5 * st / t - 0.5) / u2 - 2.0 * c_num / (u2 * t2)
    e_num = t - st - t2 * t / 6.0
    de_exact = ((1.0 - ct) / (2.0 * t) - 0.25 * t) / (u2 * t) - 2.5 * e_num / (u2 * t2 * t)
    db_taylor = -1.0 / 120.0 + u / 2520.0 - u * u / 120960.0 + u * u * u / 9979200.0
    dc_taylor = 1.0 / 720.0 - u / 20160.0 + u * u / 1209600.0 - u * u * u / 119750400.0
    de_taylor = (
        1.0 / 5040.0 - u / 181440.0 + u * u / 13305600.0 - u * u * u / 1556755200.0
    )
    return (
        torch.where(small, db_taylor, db_exact),
        torch.where(small, dc_taylor, dc_exact),
        torch.where(small, de_taylor, de_exact),
    )


def _q_t_jacs(tau, w):
    """(D_rho[Q^T w], D_theta[Q^T w]) for a fixed 3-cotangent w, each
    (..., 3, 3): every Q term is coeff * A(W) V B(W), so
    d/d rho [(A V B)^T w] = B^T hat(A^T w) and each W slot gives
    Y^T hat(X^T w), plus the coefficient derivatives (chain through u)."""
    rho, theta = tau[..., 0:3], tau[..., 3:6]
    theta_sq = (theta * theta).sum(-1)
    small = theta_sq < _SMALL_ANGLE**2
    t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    b_exact = (t - st) / (t2 * t)
    c_exact = (1.0 - 0.5 * t2 - ct) / (t2 * t2)
    e_exact = (t - st - t2 * t / 6.0) / (t2 * t2 * t)
    b_taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    c_taylor = -1.0 / 24.0 + theta_sq / 720.0 - theta_sq * theta_sq / 40320.0
    e_taylor = -1.0 / 120.0 + theta_sq / 5040.0 - theta_sq * theta_sq / 362880.0
    b = torch.where(small, b_taylor, b_exact)[..., None, None]
    c = torch.where(small, c_taylor, c_exact)[..., None, None]
    d = c - 3.0 * torch.where(small, e_taylor, e_exact)[..., None, None]
    db_u, dc_u, de_u = _q_coeffs_du(theta_sq)
    dd_u = dc_u - 3.0 * de_u

    v = so3.hat(rho)
    w_m = so3.hat(theta)
    ww = w_m @ w_m
    wv = w_m @ v
    vw = v @ w_m
    wvw = wv @ w_m

    h0 = so3.hat(w)
    ww_v = _matvec(w_m, w)
    w2w = _matvec(ww, w)
    vw_v = _matvec(v, w)
    vww_v = _matvec(vw, w)
    wvw_v = _matvec(wv, w)
    wvww_v = _matvec(wvw, w)
    vw2w_v = _matvec(v @ ww, w)
    h1 = so3.hat(ww_v)
    h2 = so3.hat(w2w)
    p1 = so3.hat(vw_v)
    h_vw = so3.hat(vww_v)
    h_wv = so3.hat(wvw_v)
    h_wvw = so3.hat(wvww_v)
    h_vww = so3.hat(vw2w_v)

    d_rho = (
        0.5 * h0
        + b * (-h1 - w_m @ h0 + w_m @ h1)
        - c * (h2 + ww @ h0 - 3.0 * (w_m @ h1))
        + 0.5 * d * (ww @ h1 + w_m @ h2)
    )
    mat_b = -v @ h0 - p1 + wv @ h0 + h_vw
    mat_c = vw @ h0 + v @ h1 + w_m @ p1 + h_wv - 3.0 * (wv @ h0 + h_vw)
    mat_d = ww @ (v @ h0) + w_m @ h_vw + h_wvw + wvw @ h0 + wv @ h1 + h_vww
    vb = vww_v + wvw_v - wvww_v
    vc = -_matvec(v @ ww, w) - _matvec(ww @ v, w) + 3.0 * wvww_v
    vd = _matvec(ww @ vw, w) + _matvec(w_m @ (v @ ww), w)

    def outer(vec, scal2):
        return scal2[..., None, None] * vec[..., :, None] * theta[..., None, :]

    d_theta = (
        b * mat_b
        - c * mat_c
        + 0.5 * d * mat_d
        + outer(vb, 2.0 * db_u)
        - outer(vc, 2.0 * dc_u)
        - outer(vd, dd_u)
    )
    return d_rho, d_theta


def left_jacobian_t_jac(tau, w):
    """D_tau[Jl_SE3(tau)^T w] for a fixed 6-cotangent w: (..., 6) x (..., 6)
    -> (..., 6, 6). Jl_SE3^T = [[Jl^T, 0], [Q^T, Jl^T]], so the top rows
    depend on theta only."""
    theta = tau[..., 3:6]
    w_r, w_t = w[..., 0:3], w[..., 3:6]
    top_t = so3.left_jacobian_t_jac(theta, w_r)
    dq_r, dq_t = _q_t_jacs(tau, w_r)
    bot_t = dq_t + so3.left_jacobian_t_jac(theta, w_t)
    top = torch.cat([torch.zeros_like(top_t), top_t], -1)
    bot = torch.cat([dq_r, bot_t], -1)
    return torch.cat([top, bot], -2)


def right_jacobian_t_jac(tau, w):
    """D_tau[Jr_SE3(tau)^T w] = -D[Jl^T w](-tau)."""
    return -left_jacobian_t_jac(-tau, w)


def left_jacobian(tau):
    jl = so3.left_jacobian(tau[..., 3:6])
    return _block66(jl, _q_matrix(tau), jl)


def right_jacobian(tau):
    return left_jacobian(-tau)


def left_jacobian_inv(tau):
    """Jl_SE3^-1 = [[Jl^-1, -Jl^-1 Q Jl^-1], [0, Jl^-1]]."""
    jlinv = so3.left_jacobian_inv(tau[..., 3:6])
    return _block66(jlinv, -(jlinv @ _q_matrix(tau) @ jlinv), jlinv)


def right_jacobian_inv(tau):
    return left_jacobian_inv(-tau)


def plus(x: SE3, tau) -> SE3:
    """Right-plus x * Exp(tau)."""
    return multiply(x, exp(tau))


def plus_jacobians(x: SE3, tau):
    """(x (+) tau, J_x = Adj(Exp(tau))^-1, J_tau = Jr_SE3(tau))."""
    e = exp(tau)
    return multiply(x, e), adjoint(inverse(e)), right_jacobian(tau)


def minus(lhs: SE3, rhs: SE3):
    """Right-minus Log(rhs^-1 * lhs): (..., 6)."""
    return log(multiply(inverse(rhs), lhs))


def minus_jacobians(lhs: SE3, rhs: SE3):
    """(lhs (-) rhs, Jr_SE3(tau)^-1, -Jl_SE3(tau)^-1)."""
    tau = minus(lhs, rhs)
    return tau, right_jacobian_inv(tau), -left_jacobian_inv(tau)
