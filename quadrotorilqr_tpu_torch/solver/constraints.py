"""Ready-made stage-constraint constructors for `solver.auglag`.

Counterpart of `quadrotorilqr_tpu/solver/constraints.py`. Every constructor
returns a function `g(x: State, u, k) -> (n_c,)` for ONE stage, feasible
where `g <= 0`, written with plain torch operations: `solver.auglag` lifts
it to the Lie tangent with `torch.func.jacfwd` and maps it over every stage
of a batch with `torch.func.vmap`, so a new constraint family needs nothing
but this value function (no in-place writes, no `.item()`, no Python `if`
on tensor values). `combine` stacks several into one vector; constraints
are per-stage uniform (use `k` inside your own function for time-varying
sets, e.g. moving obstacles). The constants are made on the stage's dtype
and device.

Keep-out distances use squared norms (r^2 - ||d||^2), not norms, so
gradients stay finite at the obstacle center an infeasible initial
trajectory may cross.
"""

from __future__ import annotations

import math

import torch


class _Const:
    """A constructor's constant, made once per dtype and device: a constant
    copied to the card at every evaluation would wait for the copy."""

    def __init__(self, value):
        self.value = value
        self.made = {}

    def like(self, a):
        key = (a.dtype, a.device)
        if key not in self.made:
            self.made[key] = torch.as_tensor(self.value, dtype=a.dtype, device=a.device)
        return self.made[key]


def combine(*constraint_fns):
    """Stack several constraint functions into one (n_c_total,) vector."""

    def g(x, u, k):
        return torch.cat([torch.atleast_1d(f(x, u, k)) for f in constraint_fns])

    return g


def sphere_keepout(center, radius):
    """Stay OUTSIDE a sphere: r^2 - ||p - c||^2 <= 0."""
    center = _Const(center)
    r2 = float(radius) ** 2

    def g(x, u, k):
        p = x.pose.trans
        d = p - center.like(p)
        return torch.atleast_1d(r2 - (d * d).sum(-1))

    return g


def ball_keepin(center, radius):
    """Stay INSIDE a ball: ||p - c||^2 - r^2 <= 0."""
    center = _Const(center)
    r2 = float(radius) ** 2

    def g(x, u, k):
        p = x.pose.trans
        d = p - center.like(p)
        return torch.atleast_1d((d * d).sum(-1) - r2)

    return g


def halfspace(normal, offset):
    """Stay on the n'p >= b side: b - n'p <= 0 (e.g. floor: n=e_z, b=0)."""
    normal = _Const(normal)

    def g(x, u, k):
        p = x.pose.trans
        return torch.atleast_1d(offset - (normal.like(p) * p).sum(-1))

    return g


def speed_limit(v_max, angular=False):
    """Body linear (or angular) speed cap: ||v||^2 - v_max^2 <= 0."""
    vmax2 = float(v_max) ** 2
    sl = slice(3, 6) if angular else slice(0, 3)

    def g(x, u, k):
        v = x.vel[..., sl]
        return torch.atleast_1d((v * v).sum(-1) - vmax2)

    return g


def tilt_limit(max_tilt_rad):
    """Attitude cone: the body z-axis stays within `max_tilt_rad` of world
    up, cos(theta_max) - (R e_z).e_z <= 0. Smooth everywhere (no acos)."""
    cos_max = math.cos(float(max_tilt_rad))

    def g(x, u, k):
        # (R e_z).e_z = R[2,2] = 1 - 2(qx^2 + qy^2) for a unit wxyz quat
        q = x.pose.quat
        r22 = 1.0 - 2.0 * (q[..., 1] * q[..., 1] + q[..., 2] * q[..., 2])
        return torch.atleast_1d(cos_max - r22)

    return g


def cylinder_keepout(center_xy, radius):
    """Stay outside an infinite vertical cylinder (no-fly column):
    r^2 - ||p_xy - c||^2 <= 0."""
    center_xy = _Const(center_xy)
    r2 = float(radius) ** 2

    def g(x, u, k):
        p = x.pose.trans[..., 0:2]
        d = p - center_xy.like(p)
        return torch.atleast_1d(r2 - (d * d).sum(-1))

    return g


def altitude_band(z_min, z_max):
    """Fly inside [z_min, z_max]: [z_min - z; z - z_max] <= 0."""

    def g(x, u, k):
        z = x.pose.trans[..., 2]
        return torch.stack([z_min - z, z - z_max], -1)

    return g


def control_box(lo, hi):
    """Elementwise control box as inequalities: [u - hi; lo - u] <= 0.

    For box-only problems prefer the exact box-QP path (`limits=` on the
    solvers); this constructor mixes boxes with state constraints in one
    augmented-Lagrangian solve."""
    lo, hi = _Const(lo), _Const(hi)

    def g(x, u, k):
        low = torch.broadcast_to(lo.like(u), u.shape)
        high = torch.broadcast_to(hi.like(u), u.shape)
        return torch.cat([u - high, low - u], -1)

    return g
