"""SO(3) on unit quaternions (w, x, y, z), batched PyTorch.

Counterpart of `quadrotorilqr_tpu/lie/so3.py`, with the same manif
conventions: the tangent is the rotation vector, Log picks the angle in
(-pi, pi], Jl = I + B W + C W^2, Jr(theta) = Jl(-theta),
Jl^-1 = I - W/2 + D W^2. Every function broadcasts over leading dims and
keeps the input dtype. Below `_SMALL_ANGLE` the trig ratios switch to the
same Taylor expansions as the JAX package.
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-3


def _safe(theta_sq, small):
    """Replace tiny values with 1.0 so the exact branch never divides by ~0."""
    return torch.where(small, torch.ones_like(theta_sq), theta_sq)


def cross(a, b):
    """(..., 3) x (..., 3) -> (..., 3): entry i is a_{i+1} b_{i+2} -
    a_{i+2} b_{i+1} (indices mod 3), the products and differences of the
    component-wise formula, read from each vector written twice."""
    aa, bb = torch.cat([a, a], -1), torch.cat([b, b], -1)
    return aa[..., 1:4] * bb[..., 2:5] - aa[..., 2:5] * bb[..., 1:4]


def hat(v):
    """R^3 -> so(3): (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def quat_identity(batch_shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


_QUAT_SIGNS = {}


def _quat_signs(like):
    """The signs of the x, y and z terms of each Hamilton-product entry,
    one tensor per dtype and device."""
    key = (like.dtype, like.device)
    if key not in _QUAT_SIGNS:
        _QUAT_SIGNS[key] = torch.tensor(
            [[-1.0, 1.0, -1.0, 1.0], [-1.0, 1.0, 1.0, -1.0], [-1.0, -1.0, 1.0, 1.0]],
            dtype=like.dtype, device=like.device,
        )
    return _QUAT_SIGNS[key]


def quat_multiply(a, b):
    """Hamilton product of wxyz quaternions:
        w = aw bw - ax bx - ay by - az bz
        x = aw bx + ax bw + ay bz - az by
        y = aw by - ax bz + ay bw + az bx
        z = aw bz + ax by - ay bx + az bw
    summed left to right, as written, on all four entries at once (b's
    entries permuted by flips; a sign times a product is exact)."""
    s = _quat_signs(b)
    pairs = b.unflatten(-1, (2, 2))
    r = a[..., 0:1] * b
    r = r + a[..., 1:2] * pairs.flip(-1).flatten(-2) * s[0]  # bx bw bz by
    r = r + a[..., 2:3] * pairs.flip(-2).flatten(-2) * s[1]  # by bz bw bx
    return r + a[..., 3:4] * b.flip(-1) * s[2]  # bz by bx bw


def quat_conjugate(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], -1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4) (Rodrigues form)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def exp(theta):
    """Rotation vector (..., 3) -> unit quaternion (..., 4)."""
    theta_sq = (theta * theta).sum(-1)
    small = theta_sq < _SMALL_ANGLE**2
    angle = torch.sqrt(_safe(theta_sq, small))
    half = 0.5 * angle
    k_exact = torch.sin(half) / angle
    k_taylor = 0.5 - theta_sq / 48.0 + theta_sq * theta_sq / 3840.0
    k = torch.where(small, k_taylor, k_exact)
    w_exact = torch.cos(half)
    w_taylor = 1.0 - theta_sq / 8.0 + theta_sq * theta_sq / 384.0
    w = torch.where(small, w_taylor, w_exact)
    return torch.cat([w[..., None], k[..., None] * theta], -1)


def log(q):
    """Unit quaternion (..., 4) -> rotation vector (..., 3), angle in (-pi, pi]."""
    w = q[..., 0]
    qv = q[..., 1:4]
    sin_sq = (qv * qv).sum(-1)
    small = sin_sq < (0.5 * _SMALL_ANGLE) ** 2
    sin_angle = torch.sqrt(_safe(sin_sq, small))
    neg = w < 0
    two_angle = 2.0 * torch.atan2(
        torch.where(neg, -sin_angle, sin_angle), torch.where(neg, -w, w)
    )
    k_exact = two_angle / sin_angle
    w_safe = torch.where(small, w, torch.ones_like(w))
    r_sq = sin_sq / (w_safe * w_safe)
    k_taylor = (2.0 / w_safe) * (1.0 - r_sq / 3.0 + r_sq * r_sq / 5.0)
    k = torch.where(small, k_taylor, k_exact)
    return k[..., None] * qv


def _ljac_coeffs(theta_sq):
    """(B, C) with Jl = I + B W + C W^2."""
    small = theta_sq < _SMALL_ANGLE**2
    t2 = _safe(theta_sq, small)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    b_exact = (1.0 - ct) / t2
    c_exact = (t - st) / (t2 * t)
    b_taylor = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    c_taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    return torch.where(small, b_taylor, b_exact), torch.where(small, c_taylor, c_exact)


def _ljacinv_coeff(theta_sq):
    """D with Jl^-1 = I - W/2 + D W^2."""
    small = theta_sq < _SMALL_ANGLE**2
    t2 = _safe(theta_sq, small)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    d_exact = 1.0 / t2 - (1.0 + ct) / (2.0 * t * st)
    d_taylor = 1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0
    return torch.where(small, d_taylor, d_exact)


def _ljac_coeffs_du(theta_sq):
    """(dB/du, dC/du) with u = |theta|^2. The exact branches cancel ~1/u^2
    terms, so the Taylor window is wider than the value helpers' (u < 0.25)."""
    small = theta_sq < 0.25
    t2 = _safe(theta_sq, small)
    t = torch.sqrt(t2)
    st, ct = torch.sin(t), torch.cos(t)
    u = theta_sq
    db_exact = (0.5 * t * st - (1.0 - ct)) / (t2 * t2)
    dc_exact = (0.5 * (1.0 - ct) - 1.5 * (t - st) / t) / (t2 * t2)
    db_taylor = -1.0 / 24.0 + u / 360.0 - u * u / 13440.0 + u * u * u / 907200.0
    dc_taylor = -1.0 / 120.0 + u / 2520.0 - u * u / 120960.0 + u * u * u / 9979200.0
    return torch.where(small, db_taylor, db_exact), torch.where(small, dc_taylor, dc_exact)


def left_jacobian_t_jac(theta, w):
    """D_theta[Jl(theta)^T w] for a fixed cotangent w: (..., 3) x (..., 3)
    -> (..., 3, 3), the second differential of the exp chart behind the
    analytic DDP curvature:

        B hat(w) - 2B' (theta x w) theta^T + 2C' (theta x (theta x w)) theta^T
        - C (hat(theta x w) + hat(theta) hat(w))
    """
    theta_sq = (theta * theta).sum(-1)
    b, c = _ljac_coeffs(theta_sq)
    db, dc = _ljac_coeffs_du(theta_sq)
    tw = cross(theta, w)
    ttw = cross(theta, tw)
    hw = hat(w)
    return (
        b[..., None, None] * hw
        - (2.0 * db)[..., None, None] * tw[..., :, None] * theta[..., None, :]
        + (2.0 * dc)[..., None, None] * ttw[..., :, None] * theta[..., None, :]
        - c[..., None, None] * (hat(tw) + hat(theta) @ hw)
    )


def _eye3(like):
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-1] + (3, 3))


def left_jacobian(theta):
    """Jl(theta): (..., 3) -> (..., 3, 3)."""
    b, c = _ljac_coeffs((theta * theta).sum(-1))
    w = hat(theta)
    return _eye3(theta) + b[..., None, None] * w + c[..., None, None] * (w @ w)


def right_jacobian(theta):
    return left_jacobian(-theta)


def left_jacobian_inv(theta):
    d = _ljacinv_coeff((theta * theta).sum(-1))
    w = hat(theta)
    return _eye3(theta) - 0.5 * w + d[..., None, None] * (w @ w)


def right_jacobian_inv(theta):
    return left_jacobian_inv(-theta)
