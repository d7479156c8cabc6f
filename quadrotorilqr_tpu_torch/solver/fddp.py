"""Infeasible-start iLQR (FDDP-style multiple shooting) with adaptive
Levenberg regularization, batched natively over a leading scenario dim B.

Counterpart of `quadrotorilqr_tpu/solver/fddp.py`. The trajectory is a set
of shooting nodes with defects d_k = f(x_k, u_k) (-) x_{k+1}:

  * the backward pass transports the value gradient across each gap,
    v_x_eff = v_x + V_xx d_k, and solves with Quu + (quu_reg + mu) I;
  * the rollout x_{k+1} = f(x_k, u_k) (+) (-(1 - alpha) d_k) closes an
    alpha-fraction of every gap;
  * the line search is a Goldstein band on the exact quadratic model
    dJ(alpha) = alpha L1 + alpha^2 L2 of the gap-contracting step;
  * `penalty_fns=(value_fn, quads_fn)` solves an augmented problem (the
    robust inner loop of `solver.auglag`, JAX `solver/fddp.py:316-345`,
    `:415-432`, `:540-640`): `value_fn(states, controls, args)` -> (B, N)
    per-stage extra cost, folded into the seed cost and every candidate's
    cost stage by stage; `quads_fn(traj, args)` -> (pcx, pcu, pcxx, pcuu,
    pcxu) per-stage quadratics at the trip's iterate, added to the cost
    differentials with the cross term pcxu carried into the gap-transported
    stage's Q_xu and into the exact quadratic model (L2 += p'pcxu w);
  * mu falls on a long accepted step, rises on a rejected or crawling one,
    and a rejection at reg_max is terminal (LINE_SEARCH_FAILED);
  * CONVERGED needs an accepted step from an iterate whose gaps are already
    below gap_tol, plus the cost criterion;
  * control limits `limits=(lo, hi)` solve each stage's gains as the
    projected-Newton box-QP of `solver/constrained.py` (the quadratic model
    keeps the free-direction gains) and clamp every control the rollouts
    produce; the cost's stage weights ((N,) or (B, N)) scale each stage's
    cost, its differentials (the exact DDP c_xx too) and the model's terms.

`fddp_loop` runs the loop in the kernel's flattened-trip form
(kernels/fddp.py): every trip is one backward pass plus a line search; a
rejected trip leaves the lane's trajectory as it was and raises its mu, so
the next trip is JAX's adaptive-mu retry, and both forms count every trip
against `max_iters`. Lanes freeze once done. It takes optional resume rows
(initial mu, status, iterations), which the multi-phase solve
(solver/batched.solve_batch_fddp_refine) threads between phases. Costs are
summed stage by stage, `c + w_n (dx'Q dx + du'R du)` (w_n = 1 without
weights), as the kernel sums them.

Not ported (it raises, naming its ROADMAP item): the other model families.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..costs import quadratic as qc
from ..lie import se3
from ..models import quadrotor as qm
from ..tree import tree_map
from . import constrained
from . import ddp as ddp_mod
from .ilqr import (
    FAMILY_FDDP_TODO,
    STATUS_CONVERGED,
    STATUS_LINE_SEARCH_FAILED,
    SolveResult,
    Trajectory,
    _where_lanes,
    add_penalty,
    is_converged,
    quadratize,
    resolve_model,
    riccati_gains_update,
)
from .options import ILQROptions

@dataclass(frozen=True)
class FDDPOptions:
    """Robust-solver knobs, as in the JAX package. `gap_tol` None resolves
    by dtype (`resolve_gap_tol`)."""

    reg_init: float = 1e-6  # first nonzero mu after a rejection at mu == 0
    reg_scale_up: float = 10.0  # mu multiplier on rejection
    reg_scale_down: float = 0.2  # mu multiplier on acceptance
    reg_min: float = 1e-9  # below this, mu snaps back to exactly 0
    reg_max: float = 1e8  # rejection at/above this is terminal
    goldstein_frac: float = 0.1  # accept frac of a predicted decrease
    goldstein_ub: float = 2.0  # tolerated multiple of a predicted increase
    gap_tol: float | None = None  # None = dtype-resolved (resolve_gap_tol)
    alpha_dec: float = 0.5  # accepted alpha >= this decays mu
    alpha_inc: float = 0.01  # accepted alpha <= this raises mu


def resolve_gap_tol(fddp_options: FDDPOptions, dtype) -> float:
    """An explicit gap_tol verbatim, else 1e-8 in float64 and 1e-5 below it
    (the float32 gap floor from dynamics roundoff is ~1e-5)."""
    if fddp_options.gap_tol is not None:
        return float(fddp_options.gap_tol)
    return 1e-8 if dtype == torch.float64 else 1e-5


def alpha_jump(ls_step: float) -> float:
    """The backtracking factor after an exploded probe: ls_step^k with
    k = round(log 0.1 / log ls_step), at least 1 (0.125 at ls_step 0.5).
    Computed once in double on the host, so every engine multiplies by the
    same value."""
    log_s = math.log(ls_step)
    k = max(math.floor(math.log(0.1) / log_s + 0.5), 1.0)
    return math.exp(k * log_s)


def _next_alpha(alpha, cand_cost, cap, ls_step):
    """Escalated backtracking: alpha * ls_step on an ordinary rejection, a
    jump to ~0.1 alpha when the probe exploded (its cost saturated at the
    probe cap, or NaN/inf on the raw first probe)."""
    return torch.where(cand_cost < cap, alpha * ls_step, alpha * alpha_jump(ls_step))


def _probe_cap(thresh, current):
    """Saturation bound of a probe's cost fold, strictly above the Goldstein
    threshold, so a saturated candidate is always rejected."""
    return 2.0 * (torch.abs(thresh) + torch.abs(current)) + 1.0


def _saturating_stage_cost_add(c, stage_c, gdj, current, cap):
    """One step of the frozen-saturating fold: freeze at the first Goldstein
    crossing (with the accept test's own arithmetic, so freezing implies a
    rejection), else add the stage cost and saturate at cap (NaN lands on
    cap too). An accepted candidate never crosses, so its cost is the exact
    sequential sum."""
    frozen = (c - current) > gdj
    c2 = c + stage_c
    c2 = torch.where(c2 <= cap, c2, cap)
    return torch.where(frozen, c, c2)


def sequential_cost(stage_costs):
    """Sum (..., N) stage costs from stage 0 up: the kernels' order."""
    total = torch.zeros_like(stage_costs[..., 0])
    for n in range(stage_costs.shape[-1]):
        total = total + stage_costs[..., n]
    return total


def defects(params, traj: Trajectory, dt_s):
    """Multiple-shooting gaps d_k = f(x_k, u_k) (-) x_{k+1}, (..., N, 12);
    row N-1 is zero (no successor node)."""
    xs = traj.states
    x_next = qm.discrete_dynamics(
        qm.params_over_stages(params),
        tree_map(lambda leaf: leaf[..., :-1, :], xs),
        traj.controls[..., :-1, :],
        dt_s,
    )
    d = qm.minus(x_next, tree_map(lambda leaf: leaf[..., 1:, :], xs))
    return torch.cat([d, torch.zeros_like(d[..., :1, :])], -2)


def _check_quadrotor(params, model):
    """The FDDP solvers take the quadrotor model only: `model=`, or the
    family the params type names."""
    if (model is not None or params is not None) and resolve_model(params, model) is not qm:
        raise NotImplementedError(FAMILY_FDDP_TODO)


def check_supported(model=None, params=None):
    """Refuse every option outside the ported slice, naming its ROADMAP item
    (a model family other than the quadrotor's: `model=`, or the params
    type when `params` is given)."""
    _check_quadrotor(params, model)


def prep_box(limits, controls):
    """(lo, hi) for (B, N, 4) controls as `constrained.prep_limits` shapes
    them ((4,) shared or (B, 4) per scenario), or None without limits."""
    if limits is None:
        return None
    return constrained.prep_limits(
        limits, controls.shape[0], controls.dtype, controls.device, controls.shape[-1]
    )


def _stage_derivs(params, cost, traj, dt_s, ddp):
    """(j_x, j_u, c_x, c_u, c_xx, c_uu[, curv]) for every stage. With ddp the
    c_xx is the exact closed-form one, and curv carries what the recursion
    needs to evaluate the dynamics curvature inline, weighted by the
    transported value gradient: (dt, per-stage quat and vel, g, I, I^-1)."""
    j_x, j_u, c_x, c_u, c_xx, c_uu = quadratize(params, cost, traj, dt_s)
    if not ddp:
        return (j_x, j_u, c_x, c_u, c_xx, c_uu)
    c_xx = ddp_mod.exact_cxx_analytic(cost, traj)
    curv = (dt_s, traj.states.pose.quat, traj.states.vel) + ddp_mod.curvature_params(
        params, c_xx.dtype
    )
    return (j_x, j_u, c_x, c_u, c_xx, c_uu, curv)


def _backward_from_derivs(derivs, d, quu_reg, controls=None, box=None, penalty=None):
    """Gap-transported Riccati recursion and the exact quadratic model of the
    gap-contracting rollout, from a derivative bundle over (B, N, ...).
    `quu_reg` is a float or a (B,) tensor. With `box` (`prep_box`'s bounds)
    each stage's gains are the box-QP's within the bounds less the stage's
    control (`controls`, (B, N, 4)), with the general-gain value update.
    `penalty=(pcx, pcu, pcxx, pcuu, pcxu)` ((B, N, ...) each) augments the
    cost differentials, Q_xu and the model (JAX `solver/fddp.py:330-345`,
    `:415-432`).
    Returns (ks (B, N, 4), Ks (B, N, 4, 12), L1 (B,), L2 (B,)),
    dJ(alpha) = alpha L1 + alpha^2 L2."""
    j_x, j_u, c_x, c_u, c_xx, c_uu = derivs[:6]
    if penalty is not None:
        c_x, c_u, c_xx, c_uu = add_penalty(c_x, c_u, c_xx, c_uu, penalty)
    batch = c_x.shape[:-2]
    n_stages = c_x.shape[-2]
    kw = dict(dtype=c_x.dtype, device=c_x.device)
    quu_reg = torch.as_tensor(quu_reg, **kw)
    reg = quu_reg[..., None, None] * torch.eye(c_u.shape[-1], **kw)
    v_x = torch.zeros(batch + (12,), **kw)
    v_xx = torch.zeros(batch + (12, 12), **kw)
    ks = [None] * n_stages
    big_ks = [None] * n_stages
    for n in reversed(range(n_stages)):
        jx, ju = j_x[..., n, :, :], j_u[..., n, :, :]
        jxt, jut = jx.transpose(-1, -2), ju.transpose(-1, -2)
        # first-order value transport across the gap
        v_x_eff = v_x + (v_xx @ d[..., n, :, None])[..., 0]
        vxx_ju = v_xx @ ju
        q_x = c_x[..., n, :] + (jxt @ v_x_eff[..., None])[..., 0]
        q_u = c_u[..., n, :] + (jut @ v_x_eff[..., None])[..., 0]
        q_xx = c_xx[..., n, :, :] + jxt @ (v_xx @ jx)
        if len(derivs) > 6:  # exact DDP curvature
            dt_s, quat, vel, g_m, inertia, inertia_inv = derivs[6]
            q_xx = q_xx + ddp_mod.vfxx_analytic(
                dt_s, quat[..., n, :], vel[..., n, :], g_m, inertia, inertia_inv, v_x_eff
            )
        q_uu = c_uu[..., n, :, :] + jut @ vxx_ju + reg
        q_xu = jxt @ vxx_ju
        if penalty is not None:
            q_xu = q_xu + penalty[4][..., n, :, :]
        if box is None:
            k, big_k, v_x, v_xx, _, _ = riccati_gains_update(q_x, q_u, q_xx, q_uu, q_xu)
        else:
            u_n = controls[..., n, :]
            k, big_k, v_x, v_xx, _, _ = constrained.box_gains_update(
                q_x, q_u, q_xx, q_uu, q_xu, box[0] - u_n, box[1] - u_n
            )
        ks[n] = k
        big_ks[n] = big_k
    ks = torch.stack(ks, -2)
    big_ks = torch.stack(big_ks, -3)
    # exact quadratic model: dx_k = alpha p_k, du_k = alpha w_k, summed
    # stage by stage as the kernel sums it
    p = torch.zeros(batch + (12,), **kw)
    l1 = torch.zeros(batch, **kw)
    l2 = torch.zeros(batch, **kw)
    for n in range(n_stages):
        w = ks[..., n, :] + (big_ks[..., n, :, :] @ p[..., None])[..., 0]
        cxx_p = (c_xx[..., n, :, :] @ p[..., None])[..., 0]
        cuu_w = (c_uu[..., n, :, :] @ w[..., None])[..., 0]
        l1 = l1 + (c_x[..., n, :] * p).sum(-1) + (c_u[..., n, :] * w).sum(-1)
        l2_n = 0.5 * ((p * cxx_p).sum(-1) + (w * cuu_w).sum(-1))
        if penalty is not None:
            l2_n = l2_n + (p * (penalty[4][..., n, :, :] @ w[..., None])[..., 0]).sum(-1)
        l2 = l2 + l2_n
        p = (
            (j_x[..., n, :, :] @ p[..., None])[..., 0]
            + (j_u[..., n, :, :] @ w[..., None])[..., 0]
            + d[..., n, :]
        )
    return ks, big_ks, l1, l2


def backward_pass_fddp(params, cost, traj, dt_s, d, quu_reg, model=None, ddp=False, limits=None):
    """Gap-transported Riccati recursion plus the exact quadratic line-search
    model over (B, N, ...) trajectories; `limits=(lo, hi)` swaps each
    stage's gain solve for the box-QP. Returns (ks, Ks, L1, L2)."""
    check_supported(model, params)
    return _backward_from_derivs(
        _stage_derivs(params, cost, traj, dt_s, ddp), d, quu_reg, traj.controls,
        prep_box(limits, traj.controls),
    )


def rollout_gap(params, traj: Trajectory, d, ks, big_ks, alpha, dt_s, model=None, limits=None):
    """Gap-contracting closed-loop rollout over (B, N, ...) with a per-lane
    alpha (B,): u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n), clamped
    into `limits=(lo, hi)` when given, x_{n+1} = f(x_n, u_n) (+)
    (-(1 - alpha) d_n)."""
    _check_quadrotor(params, model)
    box = prep_box(limits, traj.controls)
    step = qm.dynamics_step(params, dt_s)
    # what does not depend on the carry, for every stage at once: elementwise
    # products, sums and data moves, so the same values stage by stage
    old_inv = se3.inverse(traj.states.pose)
    u_ff = traj.controls + alpha[..., None, None] * ks
    shrunk = -(1.0 - alpha[..., None, None]) * d
    state = tree_map(lambda leaf: leaf[..., 0, :], traj.states)
    states, controls = [], []
    for n in range(traj.horizon):
        inv_n = tree_map(lambda leaf: leaf[..., n, :], old_inv)
        dx = torch.cat([se3.log(se3.multiply(inv_n, state.pose)),
                        state.vel - traj.states.vel[..., n, :]], -1)
        u = u_ff[..., n, :] + (big_ks[..., n, :, :] @ dx[..., None])[..., 0]
        if box is not None:
            u = torch.clamp(u, *box)
        states.append(state)
        controls.append(u)
        state = qm.add(step(state, u), shrunk[..., n, :])
    stacked = tree_map(lambda *leaves: torch.stack(leaves, -2), *states)
    return Trajectory(times=traj.times, states=stacked, controls=torch.stack(controls, -2))


def _line_search(
    params, stage_costs, traj, d, current, ks, big_ks, l1, l2, active, options, fo, dt_s,
    keep=True, limits=None,
):
    """Goldstein backtracking for every pending lane at once, a candidate's
    per-stage costs (B, N) from `stage_costs(cand)`. Probe 0 sums its cost
    raw; later probes fold with the frozen-saturating add. Returns
    (candidate, its cost, accepted (B,), the last probe's alpha (B,), stages
    the probes ran (B,) int: the kernel stops a probe at its lane's freeze).
    With keep=False the probes are cost-only and the candidate is None."""
    ls = options.line_search_params
    n_stages = traj.horizon
    alpha = torch.ones_like(current)
    accepted = torch.zeros_like(active)
    best, best_cost = traj if keep else None, current
    stages = torch.zeros(current.shape, dtype=torch.int64, device=current.device)
    for j in range(int(ls.max_iters)):
        pending = active & ~accepted
        if not bool(pending.any()):
            break
        cand = rollout_gap(params, traj, d, ks, big_ks, alpha, dt_s, limits=limits)
        scs = stage_costs(cand)
        dj = alpha * l1 + alpha * alpha * l2
        gdj = torch.where(dj <= 0, dj.new_tensor(fo.goldstein_frac), dj.new_tensor(fo.goldstein_ub)) * dj
        cap = _probe_cap(current + gdj, current)
        if j == 0:
            c = sequential_cost(scs)
            ran = torch.full_like(stages, n_stages)
        else:
            c = torch.zeros_like(current)
            ran = torch.zeros_like(stages)
            for n in range(n_stages):
                ran = ran + (~((c - current) > gdj)).to(stages.dtype)
                c = _saturating_stage_cost_add(c, scs[..., n], gdj, current, cap)
        stages = stages + torch.where(pending, ran, torch.zeros_like(ran))
        ok = ((c - current) <= gdj) & (torch.abs(c) < math.inf)
        if keep:
            best = _where_lanes(pending, cand, best)
        best_cost = torch.where(pending, c, best_cost)
        accepted = accepted | (pending & ok)
        alpha = torch.where(accepted | ~active, alpha, _next_alpha(alpha, c, cap, ls.step_update))
    return best, best_cost, accepted, alpha, stages


def _mu_schedule(mu, accepted, alpha, fo):
    """Levenberg mu after a trip: on acceptance decay (alpha >= alpha_dec),
    raise (alpha <= alpha_inc) or keep; on rejection raise while below
    reg_max."""
    mu_dec = mu * fo.reg_scale_down
    mu_dec = torch.where(mu_dec < fo.reg_min, torch.zeros_like(mu), mu_dec)
    mu_inc = torch.where(
        mu == 0.0, torch.full_like(mu, fo.reg_init), torch.clamp(mu * fo.reg_scale_up, max=fo.reg_max)
    )
    mu_accept = torch.where(
        alpha >= fo.alpha_dec, mu_dec, torch.where(alpha <= fo.alpha_inc, mu_inc, mu)
    )
    return torch.where(accepted, mu_accept, torch.where(mu < fo.reg_max, mu_inc, mu))


def fddp_loop(
    params, cost, traj: Trajectory, dt_s, options: ILQROptions, fddp_options: FDDPOptions,
    ddp=False, initial_mu=None, initial_status=None, initial_iters=None, streamed=False,
    limits=None, penalty_fns=None, penalty_args=None,
):
    """The FDDP loop over a (B, N, ...) batch in flattened-trip form.

    Lanes whose initial status is not 0 are frozen: they keep their
    trajectory and report its cost. Pending lanes continue their mu and
    iteration count for `options`' max_iters more trips.
    Returns (Trajectory, cost (B,), iterations (B,) int32, status (B,) int32,
    mu (B,), probe sweeps (B,): stages the probes ran / N, defect trips (B,)
    int32: the trips that need the defects computed, the first and each one
    after an accepted trip).

    With `streamed` it runs the streamed kernel's schedule: the probes are
    cost-only, an accepted lane's candidate is rebuilt by one apply rollout
    at its accepted alpha (the same trajectory: rollouts are deterministic),
    and the apply sweeps (B,) int32 come last in the result.

    `limits=(lo, hi)` (scalars, (4,) or (B, 4) each) runs the box-QP stage
    and clamped rollouts; the cost's stage weights go with the cost.
    `penalty_fns=(value_fn, quads_fn)` with `penalty_args` solves the
    augmented problem of the module docstring; the cost returned is then
    the augmented one.

    The loop dispatches thousands of small ops per trip, so it runs in
    inference mode (about a third less dispatch time) and hands back
    ordinary tensors."""
    with torch.inference_mode():
        out = _fddp_loop(
            params, cost, traj, dt_s, options, fddp_options, ddp,
            initial_mu, initial_status, initial_iters, streamed, limits, penalty_fns,
            penalty_args,
        )
    return tree_map(lambda a: a.clone(), out[0]), *(a.clone() for a in out[1:])


def _fddp_loop(
    params, cost, traj, dt_s, options, fddp_options, ddp, initial_mu, initial_status,
    initial_iters, streamed, limits, penalty_fns, penalty_args,
):
    fo = fddp_options
    max_iters = int(options.convergence_criteria.max_iters)
    controls = traj.controls
    batch, n_stages = controls.shape[0], controls.shape[1]
    dtype, device = controls.dtype, controls.device

    def row(a, like):
        if a is None:
            return torch.zeros(batch, dtype=like, device=device)
        return torch.as_tensor(a, device=device).to(like).reshape(batch)

    mu = row(initial_mu, dtype)
    status = row(initial_status, torch.int32)
    iters = row(initial_iters, torch.int32)
    done = status != 0
    gap_tol = resolve_gap_tol(fo, dtype)
    box = prep_box(limits, controls)

    def stage_costs(t):
        scs = qc.per_stage_costs(cost, t.states, t.controls)
        if penalty_fns is None:
            return scs
        return scs + penalty_fns[0](t.states, t.controls, penalty_args)

    current = sequential_cost(stage_costs(traj))
    stages = torch.zeros(batch, dtype=torch.int64, device=device)
    defect_trips = torch.zeros(batch, dtype=torch.int32, device=device)
    applies = torch.zeros(batch, dtype=torch.int32, device=device)
    stale = torch.ones(batch, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        active = ~done
        d = defects(params, traj, dt_s)
        gap = d.abs().amax((-2, -1))
        derivs = _stage_derivs(params, cost, traj, dt_s, ddp)
        pen = None if penalty_fns is None else penalty_fns[1](traj, penalty_args)
        ks, big_ks, l1, l2 = _backward_from_derivs(
            derivs, d, options.quu_reg + mu, traj.controls, box, pen
        )
        cand, cand_cost, accepted, alpha, ran = _line_search(
            params, stage_costs, traj, d, current, ks, big_ks, l1, l2, active, options, fo, dt_s,
            keep=not streamed, limits=box,
        )
        stages = stages + ran
        defect_trips = defect_trips + (active & stale).to(torch.int32)
        take = active & accepted
        if streamed and bool(take.any()):
            cand = rollout_gap(params, traj, d, ks, big_ks, alpha, dt_s, limits=box)
            applies = applies + take.to(torch.int32)
        stale = torch.where(active, take, stale)
        terminal = active & ~accepted & ~(mu < fo.reg_max)
        mu = torch.where(active, _mu_schedule(mu, accepted, alpha, fo), mu)
        post_conv = take & (gap < gap_tol) & is_converged(current, cand_cost, options)
        status = torch.where(
            terminal,
            STATUS_LINE_SEARCH_FAILED,
            torch.where(post_conv, STATUS_CONVERGED, status),
        ).to(torch.int32)
        if cand is not None:  # None: a streamed trip that accepted no lane
            traj = _where_lanes(take, cand, traj)
        current = torch.where(take, cand_cost, current)
        done = done | post_conv | terminal
        iters = iters + active.to(torch.int32)
    out = (traj, current, iters, status, mu, stages.to(dtype) / n_stages, defect_trips)
    return out + (applies,) if streamed else out


def solve_fddp(
    params,
    cost,
    initial_traj: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    fddp_options: FDDPOptions = FDDPOptions(),
    model=None,
    ddp: bool = False,
    limits=None,
    penalty_fns=None,
    penalty_args=None,
) -> SolveResult:
    """Robust infeasible-start solve on the plain pieces of this module.
    `initial_traj` leaves are (B, N, ...) or one unbatched (N, ...)
    trajectory; lane for lane the result of JAX's `vmap(solve_fddp)`.
    `ddp=True` adds the exact curvature (closed form), with the adaptive mu
    absorbing the indefiniteness it can bring. `limits=(lo, hi)` ((4,)
    broadcastable bounds, or (B, 4) per scenario) runs the box-QP stage and
    clamped gap rollouts; the cost's stage weights ((N,) or (B, N)) weight
    every stage. `penalty_fns=(value_fn, quads_fn)` with `penalty_args`
    solves the augmented problem of the module docstring (batched: (B, N)
    values, (B, N, ...) quadratics; the cost returned is the augmented one).
    `options.populate_debug` is ignored: FDDP has no debug record (debug is
    None)."""
    check_supported(model, params)
    single = initial_traj.controls.ndim == 2
    traj = tree_map(lambda a: a[None], initial_traj) if single else initial_traj
    traj, cost_v, iters, status, *_ = fddp_loop(
        params, cost, traj, dt_s, options, fddp_options, ddp=ddp, limits=limits,
        penalty_fns=penalty_fns, penalty_args=penalty_args,
    )
    result = SolveResult(trajectory=traj, cost=cost_v, iterations=iters, status=status)
    return tree_map(lambda a: a[0], result) if single else result
