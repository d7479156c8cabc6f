"""Augmented-Lagrangian iLQR: general nonlinear inequality constraints.

Counterpart of `quadrotorilqr_tpu/solver/auglag.py`:

  minimize  J(traj)   s.t.  g(x_k, u_k, k) <= 0  per stage

through the PHR (Powell-Hestenes-Rockafellar) augmented cost

  phi(g; lam, mu) = (||max(0, lam + mu g)||^2 - ||lam||^2) / (2 mu)

whose gradient is Jg' z with z = max(0, lam + mu g) and whose Gauss-Newton
Hessian is mu Jg' diag(z > 0) Jg. Its quadratics (`penalty_quads`) add to
the tracking cost's differentials, with a nonzero cross term
C_xu = mu Jx' diag(z > 0) Ju that the Riccati stage carries into Q_xu.

  * Constraints are written for ONE stage, `g(x: State, u, k) -> (n_c,)`
    (`solver/constraints.py` has constructors). `eval_constraints` maps them
    over every stage of a (B, N, ...) batch with `torch.func.vmap`;
    `constraint_diffs` lifts them to the Lie tangent with
    `torch.func.jacfwd`, d/dtau g(x (+) tau, u + du) at (0, 0), so the
    Jacobians are exact and model-generic.
  * The outer multiplier loop is a Python loop of at most
    `max_outer_iters` trips with per-lane multipliers, penalty, status and
    freezing; each trip runs an inner solve on the augmented cost,
    warm-started from the last trip's trajectory, with the lanes already
    done frozen.
  * The exact inner loop is `solver.ilqr`'s reference loop (trip-0 full
    step, pre/post checks, per-lane backtracking) on the augmented cost.
    `solve_auglag_batch` runs it on the per-pass kernels
    (`kernels.rollout.per_pass_kernels`, the Problem operands packed once
    per solve): every backward pass is `backward.cu`'s penalty variant, fed
    the penalty rows of the trip's iterate, and every line-search probe is
    `rollout.cu`, to whose tracking cost the candidate's penalty value is
    added on the host side, as the JAX package adds it outside its kernel.
    `solve_auglag` runs the plain pieces on whatever device the tensors are
    on (JAX runs it in XLA, with no Pallas kernel).
  * `robust=True` swaps the inner solver for the plain FDDP loop on the
    augmented problem (`solver.fddp` `penalty_fns`: the penalty value
    folded into every candidate's cost, its quadratics, the cross term
    too, into the gap-transported backward pass and the line-search model).
    The JAX package runs it in XLA (`vmap(solve_auglag(robust=True))` for a
    batch); so does the port, on the card's tensors, the batch in one loop.

Not ported: the JAX batch driver's lane padding and its `supertile`
layout (ROADMAP "Do not port").
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.func import jacfwd, vmap

from ..costs import quadratic as qc
from ..lie.se3 import SE3
from ..models.quadrotor import State
from ..tree import tree_map
from . import fddp, ilqr
from .ilqr import STATUS_CONVERGED, Trajectory, _where_lanes
from .options import ILQROptions

# Constraint satisfied to tolerance but the last inner solve hit its
# iteration budget (solution feasible, optimality not certified).
STATUS_FEASIBLE_MAX_ITERS = 3
# Outer loop exhausted with violation above tolerance.
STATUS_INFEASIBLE = 4


@dataclass(frozen=True)
class ALOptions:
    """Outer-loop knobs (PHR multiplier method): the mu schedule (mu *=
    penalty_scale each infeasible outer trip, up to penalty_max), the max
    violation accepted as feasible, and the multiplier updates allowed."""

    penalty_init: float = 10.0
    penalty_scale: float = 10.0
    penalty_max: float = 1e8
    constraint_tol: float = 1e-6
    max_outer_iters: int = 10


@dataclass
class ALSolveResult:
    trajectory: Trajectory
    cost: torch.Tensor  # (...) TRUE (unaugmented) cost of the returned trajectory
    iterations: torch.Tensor  # (...) int32: total inner trips
    outer_iterations: torch.Tensor  # (...) int32: multiplier updates executed
    max_violation: torch.Tensor  # (...) max over stages and constraints of max(0, g)
    status: torch.Tensor  # (...) int32: STATUS_*
    multipliers: torch.Tensor  # (..., N, n_c) final lambda


def _stages(states: State, controls):
    """(q, t, v, u, k) of a (B, N, ...) batch flattened stage-major: row
    n B + b is stage n of scenario b."""
    n = controls.shape[1]

    def flat(a):
        return a.transpose(0, 1).reshape(-1, a.shape[-1])

    k = torch.arange(n, device=controls.device).repeat_interleave(controls.shape[0])
    return flat(states.pose.quat), flat(states.pose.trans), flat(states.vel), flat(controls), k


def _batch_view(a, batch, n):
    """(N B, ...) stage-major rows as a (B, N, ...) view."""
    return a.unflatten(0, (n, batch)).transpose(0, 1)


def eval_constraints(constraints, states: State, controls):
    """g of every stage of a (B, N, ...) batch: (B, N, n_c)."""
    batch, n = controls.shape[:2]
    with torch.inference_mode(False):
        stages = [a.clone() for a in _stages(states, controls)]
        g = vmap(lambda q, t, v, u, k: constraints(State(pose=SE3(quat=q, trans=t), vel=v),
                                                   u, k))(*stages)
    return _batch_view(g, batch, n)


def constraint_diffs(constraints, model, states: State, controls):
    """(g (B, N, n_c), jx (B, N, n_c, 12), ju (B, N, n_c, u)) of every
    stage, the Jacobians in the Lie tangent: d g(x (+) tau, u + du) / d tau
    and / d du at (0, 0), by forward-mode autodiff through `model.add`.

    They are evaluated in float64 and handed back in the trajectory's
    dtype: torch's forward mode (2.13) turns a float32 0-dim tensor met
    with a Python float into float64, so a float32 evaluation of the
    one-stage functions would mix dtypes. The transforms run outside
    inference mode, on copies of the stages (torch 2.11 finds no batching
    rule for a dual tensor made in inference mode), as does
    `eval_constraints`."""
    batch, n = controls.shape[:2]
    dtype = controls.dtype

    def one(q, t, v, u, k):
        x = State(pose=SE3(quat=q, trans=t), vel=v)

        def lifted(tau, du):
            g = constraints(model.add(x, tau), u + du, k)
            return g, g

        tau0 = torch.zeros(12, dtype=u.dtype, device=u.device)
        du0 = torch.zeros(u.shape[-1], dtype=u.dtype, device=u.device)
        (jx, ju), g = jacfwd(lifted, argnums=(0, 1), has_aux=True)(tau0, du0)
        return g, jx, ju

    *leaves, k = _stages(states, controls)
    with torch.inference_mode(False):
        out = vmap(one)(*(a.to(torch.float64).clone() for a in leaves), k.clone())
    return tuple(_batch_view(a.to(dtype), batch, n) for a in out)


def _constraint_count(constraints, traj: Trajectory):
    stage0 = tree_map(lambda leaf: leaf[0, 0], traj.states)
    k = torch.zeros((), dtype=torch.int64, device=traj.controls.device)
    return constraints(stage0, traj.controls[0, 0], k).shape[-1]


def _z(g, lam, mu):
    return torch.clamp(lam + mu[:, None, None] * g, min=0.0)


def phi(g, lam, mu):
    """PHR penalty value of each stage, summed over its constraints: g, lam
    (B, N, n_c), mu (B,) -> (B, N)."""
    z = _z(g, lam, mu)
    return (z * z - lam * lam).sum(-1) / (2.0 * mu[:, None])


def penalty_quads(g, gx, gu, lam, mu):
    """The PHR quadratics of every stage, (pcx (B, N, 12), pcu (B, N, u),
    pcxx (B, N, 12, 12), pcuu (B, N, u, u), pcxu (B, N, 12, u)), from the
    constraint values and Jacobians (JAX `solver/auglag.py:577-603`)."""
    z = _z(g, lam, mu)
    w = mu[:, None, None] * (z > 0).to(g.dtype)
    gxw = gx * w[..., None]
    return (
        torch.einsum("bncx,bnc->bnx", gx, z),
        torch.einsum("bncu,bnc->bnu", gu, z),
        torch.einsum("bncx,bncy->bnxy", gxw, gx),
        torch.einsum("bncu,bncv->bnuv", gu * w[..., None], gu),
        torch.einsum("bncx,bncu->bnxu", gxw, gu),
    )


def _exact_engine(params, cost, traj, dt_s, options, model, kernels):
    """(backward(t, active, penalty), rollout(t, ks, Ks, alpha, active),
    traj): the per-pass kernels (`kernels`; their plain versions for CPU
    tensors) or the plain pieces of `solver.ilqr` on any device."""
    if kernels:
        from ..kernels.rollout import per_pass_kernels

        return per_pass_kernels(params, cost, traj, dt_s, options.quu_reg, model=model)
    return (
        lambda t, act, penalty: ilqr.backward_pass(
            params, cost, t, dt_s, options.quu_reg, model=model, penalty=penalty
        ),
        lambda t, ks, big_ks, alpha, act: ilqr.rollout_cost(
            params, cost, t, ks, big_ks, alpha, dt_s, model=model
        ),
        traj,
    )


def _solve(params, cost, constraints, trajs, dt_s, options, alo, model, robust, fddp_options,
           kernels):
    """The PHR outer loop over a (B, N, ...) batch (JAX `solve_auglag_batch`
    `:725-792`, lane for lane `vmap(solve_auglag)`)."""
    model = ilqr.resolve_model(params, model)
    controls = trajs.controls
    batch, n = controls.shape[:2]
    dtype, device = controls.dtype, controls.device
    n_c = _constraint_count(constraints, trajs)

    def penalty(t, lam, mu):
        g, gx, gu = constraint_diffs(constraints, model, t.states, t.controls)
        return penalty_quads(g, gx, gu, lam, mu)

    if robust:
        fddp.check_supported(model, params)
        fo = fddp.FDDPOptions() if fddp_options is None else fddp_options

        def inner(traj, lam, mu, frozen):
            out = fddp._fddp_loop(
                params, cost, traj, dt_s, options, fo, False, None, frozen.to(torch.int32),
                None, False, None,
                (lambda s, u, args: phi(eval_constraints(constraints, s, u), *args),
                 lambda t, args: penalty(t, *args)),
                (lam, mu),
            )
            return out[0], out[2], out[3]
    else:
        backward, rollout, trajs = _exact_engine(params, cost, trajs, dt_s, options, model,
                                                 kernels)

        def inner(traj, lam, mu, frozen):
            def aug(t, base):
                return base + phi(eval_constraints(constraints, t.states, t.controls), lam,
                                  mu).sum(-1)

            def rollout_aug(t, ks, big_ks, alpha, act):
                cand, base = rollout(t, ks, big_ks, alpha, act)
                return cand, aug(cand, base)

            res = ilqr._solve_loop(
                lambda t, act: backward(t, act, penalty(t, lam, mu)),
                rollout_aug,
                lambda t: aug(t, qc.trajectory_cost(cost, t.states, t.controls)),
                traj, options, None, None, frozen,
            )
            return res.trajectory, res.iterations, res.status

    traj = trajs
    lam = torch.zeros((batch, n, n_c), dtype=dtype, device=device)
    mu = torch.full((batch,), alo.penalty_init, dtype=dtype, device=device)
    viol = torch.full((batch,), torch.inf, dtype=dtype, device=device)
    total_inner = torch.zeros(batch, dtype=torch.int32, device=device)
    outer = torch.zeros(batch, dtype=torch.int32, device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    status = torch.full((batch,), STATUS_INFEASIBLE, dtype=torch.int32, device=device)
    for _ in range(int(alo.max_outer_iters)):
        if bool(done.all()):
            break
        open_ = ~done
        traj2, inner_i, inner_status = inner(traj, lam, mu, done)
        g = eval_constraints(constraints, traj2.states, traj2.controls)
        viol2 = torch.clamp(g, min=0.0).flatten(1).amax(1)
        lam_new = _z(g, lam, mu)
        feasible = viol2 < alo.constraint_tol
        mu_new = torch.where(feasible, mu, torch.clamp(mu * alo.penalty_scale,
                                                       max=alo.penalty_max))
        converged = inner_status == STATUS_CONVERGED
        status_new = torch.where(
            feasible,
            torch.where(converged, STATUS_CONVERGED, STATUS_FEASIBLE_MAX_ITERS),
            STATUS_INFEASIBLE,
        ).to(torch.int32)
        traj = _where_lanes(open_, traj2, traj)
        lam = torch.where(open_[:, None, None], lam_new, lam)
        mu = torch.where(open_, mu_new, mu)
        viol = torch.where(open_, viol2, viol)
        total_inner = total_inner + torch.where(open_, inner_i, 0).to(torch.int32)
        done = done | (feasible & converged)
        status = torch.where(open_, status_new, status)
        outer = outer + open_.to(torch.int32)
    return ALSolveResult(
        trajectory=traj,
        cost=qc.trajectory_cost(cost, traj.states, traj.controls),
        iterations=total_inner,
        outer_iterations=outer,
        max_violation=viol,
        status=status,
        multipliers=lam,
    )


def _run(params, cost, constraints, initial_traj, dt_s, options, al_options, model, robust,
         fddp_options, kernels):
    """One scenario (N, ...) or a (B, N, ...) batch through `_solve`, in
    inference mode (the loops dispatch many small ops), handing back
    ordinary tensors."""
    single = initial_traj.controls.ndim == 2
    trajs = tree_map(lambda a: a[None], initial_traj) if single else initial_traj
    with torch.inference_mode():
        res = _solve(params, cost, constraints, trajs, dt_s, options, al_options, model, robust,
                     fddp_options, kernels)
    res = tree_map(lambda a: a.clone(), res)
    return tree_map(lambda a: a[0], res) if single else res


def solve_auglag(
    params,
    cost,
    constraints,
    initial_traj: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    al_options: ALOptions = ALOptions(),
    model=None,
    robust: bool = False,
    fddp_options=None,
) -> ALSolveResult:
    """Constrained iLQR solve of one scenario ((N, ...) leaves; a (B, N, ...)
    batch solves lane for lane) on the plain pieces, on the tensors' device.

    `constraints(x: State, u, k) -> (n_c,)` is a one-stage inequality
    vector, feasible where <= 0 (`solver/constraints.py`). Returns the TRUE
    (unaugmented) cost and the worst remaining violation; with constraints
    that never activate it is the unconstrained `solve`. The model family is
    the params' (or `model=`): quadrotor, SE(3) wrench or multirotor.
    `robust=True` runs the FDDP inner loop (`fddp_options` tunes it; the
    quadrotor only, as the port's FDDP solvers)."""
    return _run(params, cost, constraints, initial_traj, dt_s, options, al_options, model,
                robust, fddp_options, kernels=False)


def solve_auglag_batch(
    params,
    cost,
    constraints,
    initial_trajs: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    al_options: ALOptions = ALOptions(),
    model=None,
    robust: bool = False,
    fddp_options=None,
) -> ALSolveResult:
    """Batched constrained solve over (B, N, ...) trajectories, lane for
    lane `vmap(solve_auglag)`: on CUDA tensors the exact inner loop runs on
    the per-pass kernels (`backward.cu`'s penalty variant, `rollout.cu`),
    on CPU tensors on their plain versions. `robust=True` runs the plain
    FDDP inner loop on the whole batch (the JAX package has no kernel
    there). Params and cost leaves may be shared or carry a leading B."""
    return _run(params, cost, constraints, initial_trajs, dt_s, options, al_options, model,
                robust, fddp_options, kernels=True)

