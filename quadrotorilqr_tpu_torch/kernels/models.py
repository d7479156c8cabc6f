"""Quadrotor kernel operands (`quadrotorilqr_tpu/kernels/models.py:88-114`,
the quadrotor `LaneModel`, whose prep is `kernels/backward.py:717-764`).

The CUDA kernels read the physical parameters as six operand tensors in the
scenario-minor layout: shared parameters as one lane (trailing dim 1, read at
B-stride 0), per-scenario parameters (every leaf with a leading B) as B
lanes. They are prepared once per call on the host side, in torch.
"""

from __future__ import annotations

import torch

from ..models.quadrotor import CONTROL_DIM, QuadrotorParams, moment_arms
from ..ops.linalg import chol_solve_small


def prep_params(params: QuadrotorParams, dt_s, dtype, device):
    """(g, m_inv, ju, iinv_ma, inertia, inertia_inv, batched).

    j_u = dt * j_cont_u is constant over the horizon: row 8 = dt/m, rows
    9:12 = dt I^-1 MA. Rows 0:8 are structural zeros, so the kernels contract
    j_u over rows 8:12 only (ju_lo = 8, csrc/quadrotor.cuh).
    Lane shapes: g, m_inv (L,); ju (12, 4, L);
    iinv_ma (3, 4, L); inertia, inertia_inv (3, 3, L), with L = B for
    per-scenario params and 1 for shared ones.
    """
    leaves = (
        params.mass_kg, params.inertia, params.arm_length_m,
        params.torque_to_thrust_ratio_m, params.g_mpss,
    )
    for leaf in leaves:
        if leaf.device != device:
            raise ValueError(f"params live on {leaf.device}, the trajectory on {device}")
    batched = params.batched
    inertia = params.inertia.to(dtype)
    inertia_inv = chol_solve_small(
        inertia, torch.eye(3, dtype=dtype, device=device).expand(inertia.shape)
    )
    ma = moment_arms(params).to(dtype)
    # I^-1 @ MA as an elementwise sum (3x3 by 3x4, host-side prep)
    iinv_ma = (inertia_inv[..., :, :, None] * ma[..., None, :, :]).sum(-2)
    mass = params.mass_kg.to(dtype)
    ju = torch.zeros(mass.shape + (12, CONTROL_DIM), dtype=dtype, device=device)
    ju[..., 8, :] = (dt_s / mass)[..., None]
    ju[..., 9:12, :] = dt_s * iinv_ma
    g = params.g_mpss.to(dtype)
    m_inv = 1.0 / mass
    if batched:
        lanes = lambda a: a.movedim(0, -1).contiguous()
    else:
        lanes = lambda a: a[..., None].contiguous()
    return (
        lanes(g), lanes(m_inv), lanes(ju), lanes(iinv_ma), lanes(inertia),
        lanes(inertia_inv), batched,
    )
