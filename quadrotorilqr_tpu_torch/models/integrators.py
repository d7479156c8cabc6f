"""Higher-order integration wrappers: substepped Lie-Euler and chart RK4,
PyTorch.

Counterpart of `quadrotorilqr_tpu/models/integrators.py`. The model
modules step once per stage (Lie-Euler). `substepped(model, k)` turns any
model module into one whose stage map is k chained Euler substeps of dt/k,

    f_k(x, u, dt) = e(e(...e(x, u, dt/k)...), u, dt/k)      (k times)

with the chain-ruled Jacobians of the base model's analytic per-substep
ones, J_x = A_k ... A_1 and J_u = sum_i A_k ... A_{i+1} B_i, by the
recurrence J_x <- A J_x, J_u <- A J_u + B (the JAX package's order, so the
plain loop computes what its XLA `solve` computes). The kernels take a
substepped quadrotor or drag quadrotor (`kernels.models.
substepped_lane_model`).

`rk4(model)` is classical RK4 on the exact chart ODE at the stage's base
point: with z(tau) = x (+) tau, d tau_pose/dt = Jr_SE3^-1(tau_pose) v_body
and d vel/dt = accel(z, u). Its Jacobians are forward-mode derivatives of
the Lie-lifted step (tau, du) -> step(x (+) tau, u + du) (-) step(x, u).
It runs on the plain loops only: no kernel takes it.

The control is held over the stage. Instances are memoized, so a wrapper
of a module is one object.
"""

from __future__ import annotations

import torch

from ..lie import se3
from ..tree import tree_map

_CACHE = {}


class _Substepped:
    """Module-like wrapper: k substeps of `base` per discrete stage."""

    def __init__(self, base, k: int):
        if k < 1:
            raise ValueError(f"substeps must be >= 1, got {k}")
        self.base = base
        self.k = k
        self.__name__ = f"{_name(base)}_sub{k}"
        # the state's group ops do not depend on the integration
        self.add = base.add
        self.add_jacobians = base.add_jacobians
        self.minus = base.minus
        self.minus_jacobians = base.minus_jacobians
        self.continuous_dynamics = base.continuous_dynamics
        self.continuous_dynamics_jacobians = base.continuous_dynamics_jacobians

    def discrete_dynamics(self, params, x, u, dt_s):
        h = dt_s / self.k
        for _ in range(self.k):
            x = self.base.discrete_dynamics(params, x, u, h)
        return x

    def dynamics_step(self, params, dt_s):
        """discrete_dynamics(params, ., ., dt_s) as a function of (x, u), on
        the base's hoisted step where it has one (the same values)."""
        h = dt_s / self.k
        base_step = getattr(self.base, "dynamics_step", None)
        step = (base_step(params, h) if base_step is not None
                else lambda x, u: self.base.discrete_dynamics(params, x, u, h))

        def stage(x, u):
            for _ in range(self.k):
                x = step(x, u)
            return x

        return stage

    def discrete_dynamics_jacobians(self, params, x, u, dt_s):
        h = dt_s / self.k
        x, j_x, j_u = self.base.discrete_dynamics_jacobians(params, x, u, h)
        for _ in range(self.k - 1):
            x, a, b = self.base.discrete_dynamics_jacobians(params, x, u, h)
            j_x = a @ j_x
            j_u = a @ j_u + b
        return x, j_x, j_u

    def __repr__(self):
        return f"substepped({_name(self.base)!r}, {self.k})"


def _name(model):
    return getattr(model, "__name__", "model")


def substepped(model, k: int):
    """The k-substep variant of `model` (memoized)."""
    key = (id(model), int(k))
    inst = _CACHE.get(key)
    if inst is None:
        inst = _Substepped(model, int(k))
        _CACHE[key] = inst
    return inst


class _RK4:
    """Module-like wrapper: classical RK4 on the exact chart ODE at the
    stage's base point (module docstring), for the SE(3) x R^6 `State` that
    every model family here shares."""

    def __init__(self, base):
        self.base = base
        self.__name__ = f"{_name(base)}_rk4"
        self.add = base.add
        self.add_jacobians = base.add_jacobians
        self.minus = base.minus
        self.minus_jacobians = base.minus_jacobians
        self.continuous_dynamics = base.continuous_dynamics
        self.continuous_dynamics_jacobians = base.continuous_dynamics_jacobians

    def _chart_vf(self, params, x, u, tau):
        """d tau/dt of the right-plus chart at x: the pose rate is
        Jr_SE3^-1(tau_pose) applied to the body twist, the velocity block the
        acceleration."""
        xdot = self.base.continuous_dynamics(params, self.base.add(x, tau), u)
        dpose = (se3.right_jacobian_inv(tau[..., 0:6]) @ xdot[..., 0:6, None])[..., 0]
        return torch.cat([dpose, xdot[..., 6:12]], -1)

    def discrete_dynamics(self, params, x, u, dt_s):
        vf = lambda tau: self._chart_vf(params, x, u, tau)  # noqa: E731
        zero = torch.zeros(u.shape[:-1] + (12,), dtype=u.dtype, device=u.device)
        k1 = vf(zero)
        k2 = vf((0.5 * dt_s) * k1)
        k3 = vf((0.5 * dt_s) * k2)
        k4 = vf(dt_s * k3)
        return self.base.add(x, (dt_s / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))

    def discrete_dynamics_jacobians(self, params, x, u, dt_s):
        """(x_next, J_x, J_u): forward-mode derivatives of the Lie-lifted
        step, every tangent and control axis at once: the step is evaluated
        on the batch with one more leading dim of 12 + m directions, each
        with its unit tangent (every stage depends on its own axes only).
        The transform runs outside inference mode, as `solver.auglag`'s."""
        m = u.shape[-1]
        with torch.inference_mode(False):
            x = _clone(x)
            u = u.clone()
            xn = self.discrete_dynamics(params, x, u, dt_s)

            def lifted(w):
                z = self.discrete_dynamics(params, self.base.add(x, w[..., 0:12]),
                                           u + w[..., 12:], dt_s)
                return self.base.minus(z, xn)

            eye = torch.eye(12 + m, dtype=u.dtype, device=u.device)
            axes = eye.reshape((12 + m,) + (1,) * (u.ndim - 1) + (12 + m,))
            axes = axes.expand((12 + m,) + u.shape[:-1] + (12 + m,))
            j = torch.func.jvp(lifted, (torch.zeros_like(axes),), (axes,))[1].movedim(0, -1)
        return _clone(xn), j[..., 0:12].clone(), j[..., 12:].clone()

    def __repr__(self):
        return f"rk4({_name(self.base)!r})"


def _clone(x):
    return tree_map(lambda a: a.clone(), x)


def rk4(model):
    """The fourth-order chart-RK4 variant of `model` (memoized)."""
    key = ("rk4", id(model))
    inst = _CACHE.get(key)
    if inst is None:
        inst = _RK4(model)
        _CACHE[key] = inst
    return inst
