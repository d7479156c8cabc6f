"""Lane models: the model families' kernel operands
(`quadrotorilqr_tpu/kernels/models.py`, its `LaneModel` protocol).

Every family is an SE(3) rigid body with an affine control-to-acceleration
map, so the discrete dynamics Jacobian j_x has the same blocks for each and
the kernels' Riccati stage is shared. A family differs in its control width
`u_dim`, its stage-constant control Jacobian j_u = dt j_cont_u with
`ju_lo`, the first of its nonzero rows (the Riccati contractions run over
rows ju_lo:12 only), and its dynamics step (csrc/quadrotor.cuh). The CUDA
kernels read the physical parameters as six operands in the scenario-minor
layout: shared parameters as one lane (trailing dim 1, read at B-stride 0),
per-scenario parameters (every leaf with a leading B) as B lanes; they are
prepared once per call on the host side, in torch.

Each family's kernels are their own instantiations of the kernel sources,
built per family (`_build.FAMILIES`) with C entries named by the lane
model's `suffix`: the quadrotor's (and a 4-rotor multirotor's, which is
the quadrotor exactly) have none.
"""

from __future__ import annotations

import typing

import torch

from ..models import multirotor as mr
from ..models import quadrotor as qm
from ..models import se3_wrench as wm
from ..ops.linalg import chol_solve_small
from ..solver import ilqr
from . import _build


class LaneModel(typing.NamedTuple):
    """A model family as the kernels see it."""

    name: str
    u_dim: int  # control width
    ju_lo: int  # first nonzero row of j_u
    # (params, dt_s, dtype, device) -> (g, m_inv, ju, extra, inertia,
    # inertia_inv, batched): extra is I^-1 MA (3, u, L), None for the wrench
    prep: typing.Callable
    suffix: str | None  # the C entries' family suffix; None: no kernel instantiation

    def gains_pitch(self):
        """A k|K row as the kernels store it: its u + 12 u values padded to a
        multiple of 4, so that a row is whole 16-byte chunks in float32 and
        float64 (csrc/team.cuh fetches rows that way): 52 at u = 4, 80 at 6,
        104 at 8."""
        return -(-13 * self.u_dim // 4) * 4


def _check_device(params, device):
    for leaf in (params.mass_kg, params.inertia, params.g_mpss):
        if leaf.device != device:
            raise ValueError(f"params live on {leaf.device}, the trajectory on {device}")


def _inertia_inv(inertia, dtype, device):
    return chol_solve_small(inertia, torch.eye(3, dtype=dtype, device=device).expand(inertia.shape))


def _lanes(batched, *ops):
    """Each operand in the lane layout: (..., B) per scenario, (..., 1) shared."""
    if batched:
        return tuple(None if a is None else a.movedim(0, -1).contiguous() for a in ops)
    return tuple(None if a is None else a[..., None].contiguous() for a in ops)


def _rotor_prep(params, ma, dt_s, dtype, device):
    """(g, m_inv, ju, iinv_ma, inertia, inertia_inv, batched) of an airframe
    with the moment map `ma` (3, R): j_u row 8 = dt/m, rows 9:12 =
    dt I^-1 MA; rows 0:8 are structural zeros (ju_lo = 8)."""
    _check_device(params, device)
    inertia = params.inertia.to(dtype)
    inertia_inv = _inertia_inv(inertia, dtype, device)
    ma = ma.to(dtype)
    # I^-1 @ MA as an elementwise sum (3x3 by 3xR, host-side prep)
    iinv_ma = (inertia_inv[..., :, :, None] * ma[..., None, :, :]).sum(-2)
    mass = params.mass_kg.to(dtype)
    ju = torch.zeros(mass.shape + (12, ma.shape[-1]), dtype=dtype, device=device)
    ju[..., 8, :] = (dt_s / mass)[..., None]
    ju[..., 9:12, :] = dt_s * iinv_ma
    g = params.g_mpss.to(dtype)
    return (*_lanes(params.batched, g, 1.0 / mass, ju, iinv_ma, inertia, inertia_inv),
            params.batched)


def _quadrotor_prep(params, dt_s, dtype, device):
    """The quadrotor's operands (JAX `_quadrotor_prep_params`, whose prep is
    `kernels/backward.py:717-764`). Lane shapes: g, m_inv (L,); ju (12, 4,
    L); iinv_ma (3, 4, L); inertia, inertia_inv (3, 3, L), with L = B for
    per-scenario params and 1 for shared ones."""
    return _rotor_prep(params, qm.moment_arms(params), dt_s, dtype, device)


def _multirotor_prep(params, dt_s, dtype, device):
    """An R-rotor airframe's operands (JAX `_multirotor_prep_params`,
    `kernels/models.py:204-244`): the quadrotor's layout with the generic
    moment map; at R = 4 with the reference airframe they are the
    quadrotor's, bit for bit."""
    return _rotor_prep(params, mr.moment_map(params), dt_s, dtype, device)


def _wrench_prep(params, dt_s, dtype, device):
    """The body wrench's operands (JAX `_wrench_prep_params`,
    `kernels/models.py:122-161`): j_u rows 6:9 = (dt/m) I3 into the force
    columns 0:3, rows 9:12 = dt I^-1 into the torque columns 3:6 (ju_lo =
    6); no I^-1 MA operand (None: a null pointer)."""
    _check_device(params, device)
    inertia = params.inertia.to(dtype)
    inertia_inv = _inertia_inv(inertia, dtype, device)
    mass = params.mass_kg.to(dtype)
    ju = torch.zeros(mass.shape + (12, 6), dtype=dtype, device=device)
    ju[..., 6:9, 0:3] = (dt_s / mass)[..., None, None] * torch.eye(3, dtype=dtype, device=device)
    ju[..., 9:12, 3:6] = dt_s * inertia_inv
    g = params.g_mpss.to(dtype)
    return (*_lanes(params.batched, g, 1.0 / mass, ju, None, inertia, inertia_inv),
            params.batched)


# the C entries' suffix of each family type the kernels are built for
_SUFFIX_OF_TYPE = {t: sfx for sfx, t in _build.FAMILIES.items()}
QUADROTOR = LaneModel("quadrotor", 4, 8, _quadrotor_prep, _SUFFIX_OF_TYPE["Quadrotor"])
SE3_WRENCH = LaneModel("se3_wrench", 6, 6, _wrench_prep, _SUFFIX_OF_TYPE["Wrench"])


def multirotor_lane_model(n_rotors: int) -> LaneModel:
    """The lane model of an R-rotor airframe; `suffix` is None for a rotor
    count without kernels (the plain versions take any). A 4-rotor airframe
    runs the quadrotor's."""
    suffix = QUADROTOR.suffix if n_rotors == 4 else _SUFFIX_OF_TYPE.get(f"Multirotor<{n_rotors}>")
    return LaneModel(f"multirotor{n_rotors}", n_rotors, 8, _multirotor_prep, suffix)


def lane_model_for(params, model=None) -> LaneModel:
    """The lane model of the params' family, or of an explicit `model=`
    module (`solver.ilqr.resolve_model`), as JAX's `lane_model_for`."""
    module = ilqr.resolve_model(params, model)
    if module is wm:
        return SE3_WRENCH
    if module is mr:
        return multirotor_lane_model(params.n_rotors)
    return QUADROTOR
