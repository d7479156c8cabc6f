"""Exact iLQR, batched natively over a leading scenario dim B (PyTorch).

Counterpart of `quadrotorilqr_tpu/solver/ilqr.py`. The backward pass
quadratizes all N stages at once (dense dynamics Jacobians and Gauss-Newton
cost diffs) and then runs the Riccati recursion stage by stage; the forward
rollout is a loop over stages. `solve_loop` is the per-lane outer loop of the
reference semantics (trip 0 takes a full step; later trips pre-check the
expected cost, backtrack with a per-lane step, post-check the achieved cost;
finished lanes freeze), with the per-iteration debug record of
`options.populate_debug`. `solve` runs it on the plain pieces in this
module; `solver/batched.py` runs the same loop on the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..costs import quadratic as qc
from ..lie import se3
from ..models import multirotor as mr
from ..models import quadrotor as qm
from ..models import se3_wrench as wm
from ..models.multirotor import MultirotorParams
from ..models.quadrotor import QuadrotorParams, State
from ..models.se3_wrench import WrenchParams
from ..ops.linalg import chol_solve_small
from ..tree import tree_map
from .options import ILQROptions

# Per-scenario status codes (the reference throws instead).
STATUS_MAX_ITERS = 0
STATUS_CONVERGED = 1
STATUS_LINE_SEARCH_FAILED = 2

DDP_TODO = "ddp=True is not ported yet (ROADMAP Queue 1 item 10, solver/ddp.py)"
ASSOCIATIVE_TODO = (
    "associative=True is not ported yet "
    "(ROADMAP Queue 1 item 15, solver/parallel_riccati.py)"
)
MODEL_TODO = (
    "only the quadrotor, SE(3) wrench and multirotor models are ported; drag and substeps "
    "are not (ROADMAP Queue 1 item 11a, model families)"
)
FAMILY_FDDP_TODO = (
    "the wrench and multirotor families on the FDDP solvers are not ported yet "
    "(ROADMAP Queue 1 item 11b)"
)
FAMILY_VARIANTS_TODO = (
    "control limits, stage weights and the debug record with a wrench or multirotor model "
    "are not ported to the CUDA kernels yet (ROADMAP Queue 1 item 11c)"
)
FAMILY_ROTORS_TODO = (
    "the CUDA kernels take multirotors of 4, 6 or 8 rotors; other rotor counts are not "
    "ported yet (ROADMAP Queue 1 item 11d)"
)
CONTINUATION_TODO = (
    "continuation is not ported yet (ROADMAP Queue 1 item 13, MPC warm start)"
)


@dataclass
class Trajectory:
    """Stacked trajectory: times (..., N), states (leaves (..., N, d)),
    controls (..., N, u), u the model's control width (4 rotor thrusts for
    the quadrotor, 6 for the wrench, R for an R-rotor multirotor)."""

    times: torch.Tensor
    states: State
    controls: torch.Tensor

    @property
    def horizon(self):
        return self.controls.shape[-2]


@dataclass
class IterDebug:
    """Per-iteration debug record (ilqr_debug.hh) as fixed-size buffers
    indexed by trip: slot i holds the trajectory and cost that trip i
    committed, for the lanes that executed an update on it (zeros
    elsewhere); `valid[..., i]` marks those slots."""

    trajectories: Trajectory  # leaves (..., max_iters, N, d)
    costs: torch.Tensor  # (..., max_iters)
    valid: torch.Tensor  # (..., max_iters) bool


@dataclass
class CostHistory:
    """The cost and valid buffers of IterDebug without the trajectory
    snapshots: what the whole-solve kernel records
    (`solver.batched.solve_batch_latency`)."""

    costs: torch.Tensor  # (..., max_iters)
    valid: torch.Tensor  # (..., max_iters) bool


@dataclass
class SolveResult:
    trajectory: Trajectory
    cost: torch.Tensor  # (...)
    iterations: torch.Tensor  # (...) int32: executed updates
    status: torch.Tensor  # (...) int32: STATUS_*
    debug: IterDebug | CostHistory | None = None


# the ported model modules: the solvers' `model=` (JAX's `template <class
# ModelT>`), or resolved from the params type
FAMILIES = (qm, wm, mr)
_FAMILY_OF_PARAMS = ((QuadrotorParams, qm), (WrenchParams, wm), (MultirotorParams, mr))


def resolve_model(params, model=None):
    """The model module of a solve: `model` when given (one of FAMILIES),
    else the one the params type names (QuadrotorParams -> quadrotor,
    WrenchParams -> se3_wrench, MultirotorParams -> multirotor), as the JAX
    package's `lane_model_for` resolves it."""
    if model is not None:
        if not any(model is f for f in FAMILIES):
            raise NotImplementedError(MODEL_TODO)
        return model
    for cls, module in _FAMILY_OF_PARAMS:
        if isinstance(params, cls):
            return module
    raise TypeError(f"no model family for params of type {type(params).__name__}")


def check_supported(model=None, ddp=False, associative=False):
    """Refuse every option outside the ported slice, naming its ROADMAP item."""
    if ddp:
        raise NotImplementedError(DDP_TODO)
    if associative:
        raise NotImplementedError(ASSOCIATIVE_TODO)
    if model is not None:
        resolve_model(None, model)


def quadratize(params, cost, traj: Trajectory, dt_s, model=None):
    """Stage-stacked (j_x, j_u, c_x, c_u, c_xx, c_uu) for all N stages, on the
    model's dynamics (`resolve_model`)."""
    model = resolve_model(params, model)
    _, j_x, j_u = model.discrete_dynamics_jacobians(
        qm.params_over_stages(params), traj.states, traj.controls, dt_s
    )
    _, c_x, c_u, c_xx, c_uu = qc.stage_cost_with_diffs(
        cost, traj.states, traj.controls, cost.desired_states, cost.desired_controls
    )
    c_uu = c_uu.expand(c_u.shape[:-1] + c_uu.shape[-2:])
    return j_x, j_u, c_x, c_u, c_xx, c_uu


def riccati_gains_update(q_x, q_u, q_xx, q_uu, q_xu):
    """Gain solve, value update and the per-stage symmetrization of V_xx
    (without it float32 drives Quu indefinite past N~500).

    Returns (k, K, v_x', v_xx', Qu.k, k.Quu.k)."""
    rhs = torch.cat([q_u[..., None], q_xu.transpose(-1, -2)], -1)
    sol = -chol_solve_small(q_uu, rhs)
    k = sol[..., 0]
    big_k = sol[..., 1:]
    quu_k = (q_uu @ k[..., None])[..., 0]
    big_kt = big_k.transpose(-1, -2)
    v_x_new = q_x - (big_kt @ quu_k[..., None])[..., 0]
    s = q_xx - big_kt @ q_uu @ big_k
    v_xx_new = 0.5 * (s + s.transpose(-1, -2))
    return k, big_k, v_x_new, v_xx_new, (q_u * k).sum(-1), (k * quu_k).sum(-1)


def backward_pass(params, cost, traj: Trajectory, dt_s, quu_reg=0.0, gains_update=None,
                  model=None):
    """Riccati recursion over (..., N, ...) trajectories. `gains_update(q_x,
    q_u, q_xx, q_uu, q_xu, n)` replaces `riccati_gains_update` at stage n
    (the box-QP stage of solver/constrained.py).

    Returns (ks (..., N, u), Ks (..., N, u, 12), QuTk (...), kTQuuk (...))."""
    j_x, j_u, c_x, c_u, c_xx, c_uu = quadratize(params, cost, traj, dt_s, model)
    batch = traj.controls.shape[:-2]
    kw = dict(dtype=traj.controls.dtype, device=traj.controls.device)
    v_x = torch.zeros(batch + (12,), **kw)
    v_xx = torch.zeros(batch + (12, 12), **kw)
    qutk = torch.zeros(batch, **kw)
    ktquuk = torch.zeros(batch, **kw)
    eye_u = torch.eye(c_uu.shape[-1], **kw)
    n_stages = traj.horizon
    ks = [None] * n_stages
    big_ks = [None] * n_stages
    for n in reversed(range(n_stages)):
        jx, ju = j_x[..., n, :, :], j_u[..., n, :, :]
        jxt, jut = jx.transpose(-1, -2), ju.transpose(-1, -2)
        vxx_jx = v_xx @ jx
        vxx_ju = v_xx @ ju
        q_x = c_x[..., n, :] + (jxt @ v_x[..., None])[..., 0]
        q_u = c_u[..., n, :] + (jut @ v_x[..., None])[..., 0]
        q_xx = c_xx[..., n, :, :] + jxt @ vxx_jx
        q_uu = c_uu[..., n, :, :] + jut @ vxx_ju
        if quu_reg != 0.0:
            q_uu = q_uu + quu_reg * eye_u
        q_xu = jxt @ vxx_ju
        if gains_update is None:
            out = riccati_gains_update(q_x, q_u, q_xx, q_uu, q_xu)
        else:
            out = gains_update(q_x, q_u, q_xx, q_uu, q_xu, n)
        k, big_k, v_x, v_xx, qutk_inc, ktquuk_inc = out
        qutk = qutk + qutk_inc
        ktquuk = ktquuk + ktquuk_inc
        ks[n] = k
        big_ks[n] = big_k
    return torch.stack(ks, -2), torch.stack(big_ks, -3), qutk, ktquuk


def expected_cost_reduction(qutk, ktquuk, step=1.0):
    """dJ(step) = step Qu'k + step^2 k'Quu k / 2."""
    return step * qutk + step * step * ktquuk / 2.0


def _stage(leaf, n):
    return leaf[..., n, :]


def forward_sim(params, traj: Trajectory, ks, big_ks, alpha, dt_s, limits=None, model=None):
    """Closed-loop rollout u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n),
    x_{n+1} = f(x_n, u_n) on the model's dynamics; `alpha` is per lane (...).
    With `limits=(lo, hi)` (tensors broadcasting against (..., u)) each u_n
    is clamped into [lo, hi] first (solver/constrained.py)."""
    model = resolve_model(params, model)
    if model is qm:
        step = qm.dynamics_step(params, dt_s)
    else:
        step = lambda x, u: model.discrete_dynamics(params, x, u, dt_s)  # noqa: E731
    # what does not depend on the carry, for every stage at once: elementwise
    # products, sums and data moves, so the same values stage by stage
    old_inv = se3.inverse(traj.states.pose)
    u_ff = traj.controls + alpha[..., None, None] * ks
    state = tree_map(lambda leaf: _stage(leaf, 0), traj.states)
    states, controls = [], []
    for n in range(traj.horizon):
        inv_n = tree_map(lambda leaf: _stage(leaf, n), old_inv)
        dx = torch.cat([se3.log(se3.multiply(inv_n, state.pose)),
                        state.vel - _stage(traj.states.vel, n)], -1)
        u = u_ff[..., n, :] + (big_ks[..., n, :, :] @ dx[..., None])[..., 0]
        if limits is not None:
            u = torch.clamp(u, *limits)
        states.append(state)
        controls.append(u)
        state = step(state, u)
    stacked = tree_map(lambda *leaves: torch.stack(leaves, -2), *states)
    return Trajectory(times=traj.times, states=stacked, controls=torch.stack(controls, -2))


def rollout_cost(params, cost, traj: Trajectory, ks, big_ks, alpha, dt_s, limits=None,
                 model=None):
    """forward_sim plus the new trajectory's cost: (Trajectory, cost (...))."""
    new_traj = forward_sim(params, traj, ks, big_ks, alpha, dt_s, limits, model)
    return new_traj, qc.trajectory_cost(cost, new_traj.states, new_traj.controls)


def is_converged(cost, new_cost, options: ILQROptions):
    """Relative OR absolute criterion, in the division-free form
    `diff < rtol |cost|` (a zero-cost lane falls through to atol)."""
    cc = options.convergence_criteria
    diff = torch.abs(cost - new_cost)
    return (diff < cc.rtol * torch.abs(cost)) | (diff < cc.atol)


def _where_lanes(mask, a, b):
    """Per-lane select over (B, ...) containers; mask is (B,)."""
    return tree_map(
        lambda x, y: torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, y),
        a,
        b,
    )


def backtrack(rollout, traj, current, ks, big_ks, qutk, ktquuk, active, ls, store=True):
    """The per-lane backtracking line search (ilqr.hh:174-194) over a
    (B, N, ...) batch: probe j rolls the `active` lanes still pending out at
    alpha = step_update^j and accepts a lane whose cost change falls below
    desired_reduction_frac dJ(alpha). `rollout(traj, ks, Ks, alpha, pending)`
    -> (Trajectory, cost).

    Returns (candidate, its cost, accepted, the alpha each lane last tried).
    A lane whose search runs out keeps its last (smallest-step) candidate,
    as the reference does before it throws. With `store=False` only the
    costs are kept (the candidate is the input trajectory)."""
    batch = current.shape[0]
    alpha = torch.ones(batch, dtype=current.dtype, device=current.device)
    tried = alpha
    accepted = torch.zeros_like(active)
    best, best_cost = traj, current
    for _ in range(ls.max_iters):
        pending = active & ~accepted
        if not bool(pending.any()):
            break
        cand, cand_cost = rollout(traj, ks, big_ks, alpha, pending)
        desired = ls.desired_reduction_frac * expected_cost_reduction(qutk, ktquuk, alpha)
        ok = (cand_cost - current) < desired
        if store:
            best = _where_lanes(pending, cand, best)
        tried = torch.where(pending, alpha, tried)
        best_cost = torch.where(pending, cand_cost, best_cost)
        accepted = accepted | (pending & ok)
        alpha = torch.where(accepted | ~active, alpha, alpha * ls.step_update)
    return best, best_cost, accepted, tried


def line_search(
    params, cost, traj: Trajectory, current_cost, ks, big_ks, qutk, ktquuk, dt_s,
    options: ILQROptions, model=None,
):
    """Backtracking line search on the plain pieces for one (N, ...)
    trajectory or a (B, N, ...) batch, every lane searching.

    Returns (new trajectory, new cost, ok); ok False is the reference's
    exhausted search, and the trajectory is then the last candidate."""
    check_supported(model)
    single = traj.controls.ndim == 2
    lift = (lambda a: a[None]) if single else (lambda a: a)
    current = lift(torch.as_tensor(current_cost, dtype=traj.controls.dtype))
    new_traj, new_cost, ok, _ = backtrack(
        lambda t, k, big_k, alpha, act: rollout_cost(
            params, cost, t, k, big_k, alpha, dt_s, model=model
        ),
        tree_map(lift, traj), current, lift(ks), lift(big_ks), lift(qutk), lift(ktquuk),
        torch.ones_like(current, dtype=torch.bool), options.line_search_params,
    )
    if single:
        return tree_map(lambda a: a[0], new_traj), new_cost[0], ok[0]
    return new_traj, new_cost, ok


def solve_loop(
    backward, rollout, traj_cost, initial_traj: Trajectory, options: ILQROptions, apply=None,
    history=False,
):
    """The reference outer loop over a (B, N, ...) batch, lane by lane.

    `backward(traj, active)` -> (ks, Ks, QuTk, kTQuuk);
    `rollout(traj, ks, Ks, alpha, active)` -> (Trajectory, cost);
    `traj_cost(traj)` -> cost. `active` is the (B,) mask of lanes whose
    outputs are read (None: all); kernel engines may skip the other lanes.

    With `apply(traj, ks, Ks, alpha, active)` -> Trajectory the loop runs the
    streamed kernels' schedule: the line search reads only the probes'
    costs, and each active lane's candidate is rebuilt by one apply rollout
    at the alpha it last tried (the accepted one, or the last probed when the
    search ran out). Rollouts being deterministic, the result is the same.

    `options.populate_debug` records an IterDebug in `debug` (the JAX batch
    loop's buffers: one slot per trip, the committed trajectory and cost of
    the lanes that executed an update on it, zeros for the others,
    batch-leading); otherwise `history` records a CostHistory.

    The loop dispatches thousands of small ops per trip, so it runs in
    inference mode (as `solver.fddp.fddp_loop`) and hands back ordinary
    tensors: the debug buffers are made before it (the loop writes into
    them in place), so only the solution is copied out.
    """
    debug = _debug_buffers(initial_traj, options, history)
    with torch.inference_mode():
        result = _solve_loop(backward, rollout, traj_cost, initial_traj, options, apply, debug)
    solution = tree_map(lambda a: a.clone(), dataclasses.replace(result, debug=None))
    return dataclasses.replace(solution, debug=debug)


def _debug_buffers(initial_traj, options, history):
    """Zeroed (B, max_iters, ...) buffers of the debug record asked for."""
    if not (options.populate_debug or history):
        return None
    controls = initial_traj.controls
    shape = (controls.shape[0], int(options.convergence_criteria.max_iters))
    costs = torch.zeros(shape, dtype=controls.dtype, device=controls.device)
    valid = torch.zeros(shape, dtype=torch.bool, device=controls.device)
    if not options.populate_debug:
        return CostHistory(costs, valid)
    snapshots = tree_map(lambda leaf: leaf.new_zeros(shape + leaf.shape[1:]), initial_traj)
    return IterDebug(snapshots, costs, valid)


def _solve_loop(backward, rollout, traj_cost, initial_traj, options, apply, debug):
    ls = options.line_search_params
    max_iters = int(options.convergence_criteria.max_iters)
    controls = initial_traj.controls
    batch = controls.shape[0]
    kw = dict(dtype=controls.dtype, device=controls.device)
    traj = initial_traj
    # trip 0 takes a full step whatever the initial cost: compute it only
    # when the loop never runs
    new_cost = traj_cost(traj) if max_iters == 0 else torch.zeros(batch, **kw)
    done = torch.zeros(batch, dtype=torch.bool, device=controls.device)
    status = torch.full((batch,), STATUS_MAX_ITERS, dtype=torch.int32, device=controls.device)
    iterations = torch.zeros(batch, dtype=torch.int32, device=controls.device)

    for i in range(max_iters):
        if bool(done.all()):
            break
        ks, big_ks, qutk, ktquuk = backward(traj, ~done)
        current = new_cost
        expected = current + expected_cost_reduction(qutk, ktquuk, 1.0)
        pre_conv = (i > 0) & is_converged(current, expected, options) & ~done
        active = ~(done | pre_conv)
        if i == 0:
            tried = torch.ones(batch, **kw)
            cand, cand_cost = rollout(traj, ks, big_ks, tried, None)
            ls_ok = torch.ones_like(active)
        else:
            cand, cand_cost, ls_ok, tried = backtrack(
                rollout, traj, current, ks, big_ks, qutk, ktquuk, active, ls, apply is None
            )
        if apply is not None:
            cand = apply(traj, ks, big_ks, tried, active)
        post_conv = (i > 0) & is_converged(current, cand_cost, options) & active & ls_ok
        ls_failed = active & ~ls_ok
        traj = _where_lanes(active, cand, traj)
        new_cost = torch.where(active, cand_cost, current)
        status = torch.where(
            ls_failed,
            STATUS_LINE_SEARCH_FAILED,
            torch.where(post_conv | pre_conv, STATUS_CONVERGED, status),
        ).to(torch.int32)
        done = done | pre_conv | post_conv | ls_failed
        iterations = iterations + active.to(torch.int32)
        if debug is not None:
            # one slot per executed update (ilqr.hh:78-80)
            debug.costs[:, i] = torch.where(active, new_cost, 0.0)
            debug.valid[:, i] = active
            if isinstance(debug, IterDebug):
                tree_map(
                    lambda buf, leaf: buf[:, i].copy_(
                        _where_lanes(active, leaf, torch.zeros_like(leaf))
                    ),
                    debug.trajectories,
                    traj,
                )
    return SolveResult(
        trajectory=traj, cost=new_cost, iterations=iterations, status=status, debug=debug
    )


def solve(
    params,
    cost,
    initial_traj: Trajectory,
    dt_s: float,
    options: ILQROptions = ILQROptions(),
    associative: bool = False,
    model=None,
    ddp: bool = False,
) -> SolveResult:
    """Exact iLQR on the plain pieces of this module. `initial_traj` leaves
    are (B, N, ...) or one unbatched (N, ...) trajectory; params and cost
    leaves are shared or carry the same leading B. `model` is the model
    module (None: the one the params type names, `resolve_model`)."""
    check_supported(model, ddp, associative)
    model = resolve_model(params, model)
    single = initial_traj.controls.ndim == 2
    traj = tree_map(lambda a: a[None], initial_traj) if single else initial_traj
    result = solve_loop(
        lambda t, act: backward_pass(params, cost, t, dt_s, options.quu_reg, model=model),
        lambda t, ks, big_ks, alpha, act: rollout_cost(
            params, cost, t, ks, big_ks, alpha, dt_s, model=model
        ),
        lambda t: qc.trajectory_cost(cost, t.states, t.controls),
        traj,
        options,
    )
    return tree_map(lambda a: a[0], result) if single else result


# ---- trajectory helpers (trajectory.hh: a point, equality, printing) ----


def trajectory_point(traj: Trajectory, i):
    """(time, State, control) at stage i: the reference's TrajectoryPoint."""
    state = tree_map(lambda leaf: leaf[..., i, :], traj.states)
    return traj.times[..., i], state, traj.controls[..., i, :]


def _leaves(obj, path=()):
    """[(path of field names, tensor)] of a container, depth first."""
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in _leaves(getattr(obj, f.name), path + (f.name,))]
    return [(path, obj)]


def trajectory_equal(a: Trajectory, b: Trajectory, atol: float = 0.0) -> bool:
    """Elementwise equality of two trajectories (atol > 0: within atol)."""
    leaves_a, leaves_b = _leaves(a), _leaves(b)
    if [p for p, _ in leaves_a] != [p for p, _ in leaves_b]:
        return False
    for (_, la), (_, lb) in zip(leaves_a, leaves_b):
        if la.shape != lb.shape:
            return False
        la, lb = la.detach().cpu(), lb.detach().cpu().to(la.dtype)
        if not (torch.equal(la, lb) if atol == 0.0 else torch.allclose(la, lb, rtol=0.0, atol=atol)):
            return False
    return True


def format_trajectory(traj: Trajectory, max_points: int = 5) -> str:
    """A readable summary of the first `max_points` stages."""
    n = traj.horizon
    lines = [f"Trajectory(horizon={n}, batch={tuple(traj.controls.shape[:-2])})"]
    show = min(n, max_points)
    as_np = lambda a: a.detach().cpu().numpy()
    times, controls = as_np(traj.times), as_np(traj.controls)
    trans, quat = as_np(traj.states.pose.trans), as_np(traj.states.pose.quat)
    for i in range(show):
        lines.append(
            f"  [{i}] t={times[..., i]} trans={trans[..., i, :]} "
            f"quat={quat[..., i, :]} u={controls[..., i, :]}"
        )
    if n > show:
        lines.append(f"  ... ({n - show} more)")
    return "\n".join(lines)
