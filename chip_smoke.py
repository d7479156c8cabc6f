#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `quadrotorilqr_tpu_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card (float64
lane for lane at B=300, N=40; float32 at the main paths' shapes to quality
bounds), and drives two main paths through `QuadrotorILQR.solve_batch`:

  * exact iLQR on the hover-to-waypoint bench workload (B=4096, N=100,
    tolerance 1e-6, 10 iterations, 20 line-search probes), with
    `latency=True` (the whole-solve kernel) and `fused=True` (the per-pass
    kernels);
  * robust FDDP (`solver="fddp"`, float32: the `refine="auto"` schedule,
    one FDDP kernel launch of Gauss-Newton trips and one of exact-DDP trips
    resumed from it) on the aggressive-tumble class of the robust headline
    (B=4096, N=50, dt 0.1, scale 1.8, 40 iterations); each launch is held
    against the plain FDDP loop on the same inputs and resume rows.

It checks convergence, times the kernels against their plain PyTorch
versions with CUDA events, and computes each kernel's bound (the least time
the card could take for the work this run's inputs needed).

Output: progress lines, the card's `nvidia-smi` name and power limit, a
JSON line `{"kernels": [...]}` with each kernel's launches, error and times,
and as the last line `{"ok": true, "device": {...}}`. Any failed check
raises, so the exit code is not 0. Without a CUDA device, or without the
repository beside it, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 0.02

# The least time the card could take: the larger of the operations over the
# H100's float32 rate outside the tensor cores and the bytes (each input read
# once, each output written once) over its memory rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Floating-point operations per scenario and stage, counted by hand from the
# CUDA device functions (kernels/csrc/*.cuh; a multiply-add is 2, a square
# root, sine, cosine, atan2 or division 1):
#   Riccati stage, Gauss-Newton (riccati_stage): j_x blocks 1006 + cost
#     diffs 3019 + Q-expansion 5675 + Cholesky gains 460 + value update 1914;
#   the exact-DDP additions (kDdp): c_xx correction 3064 + sum v_x f_xx 3776;
#   rollout stage (rollout_lane): state minus 227 + controls 100 + stage cost
#     566 + dynamics step 309;
#   FDDP probe stage (rollout_gap_stage): the rollout stage plus the gap
#     shrink, Exp and compose 210;
#   FDDP probe-0 model terms beyond what the Riccati stage already computed
#     at the same stage (the kernel recomputes its j_x blocks and cost
#     diffs; that is not counted): w 96, L1 32, c_xx p 276, 2R w 44, L2 33,
#     J_x p 171, J_u w 32, + d 12;
#   FDDP defect 560, counted on the trips that computed defects (the kernel
#     reports them), and value transport v_x + V_xx d 288 on every trip.
FLOPS = dict(
    riccati=12074, ddp_extra=6840, rollout=1202, gap_rollout=1412, model=696,
    defect=560, transport=288, stage_cost=566,
)


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def np_problem(seed, batch, n):
    """Random poses, velocities and controls at every stage, a shared hover
    target and per-scenario params (to exercise the B-strides), as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((batch, n, 1)), 0.3 * rng.normal(size=(batch, n, 3))], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    des_q = np.zeros((n, 4))
    des_q[:, 0] = 1.0
    scale = 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
    traj = SimpleNamespace(
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        states=SimpleNamespace(
            pose=SimpleNamespace(quat=q, trans=0.4 * rng.normal(size=(batch, n, 3))),
            vel=0.2 * rng.normal(size=(batch, n, 6)),
        ),
        controls=9.81 / 4 + 0.5 * rng.normal(size=(batch, n, 4)),
    )
    cost = SimpleNamespace(
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(4),
        desired_states=SimpleNamespace(
            pose=SimpleNamespace(quat=des_q, trans=np.zeros((n, 3))), vel=np.zeros((n, 6))
        ),
        desired_controls=np.full((n, 4), 9.81 / 4),
    )
    params = SimpleNamespace(
        mass_kg=1.3 * scale,
        inertia=(np.diag([0.4, 0.5, 0.6]) + 0.05) * scale[:, None, None],
        arm_length_m=np.full(batch, 0.2),
        torque_to_thrust_ratio_m=np.full(batch, 0.016),
        g_mpss=np.full(batch, 9.81),
    )
    return params, cost, traj


def max_abs(a, b):
    return float((a - b).abs().max())


def bit_equal(got, ref):
    """Status, iterations, cost and every trajectory leaf identical; each
    argument a SolveResult or the kernel wrapper's tuple."""
    def leaves(r):
        t, c, i, s = (r.trajectory, r.cost, r.iterations, r.status) if hasattr(r, "cost") else r[:4]
        return (s, i, c, t.controls, t.states.pose.quat, t.states.pose.trans, t.states.vel)
    return all(bool((a == b).all()) for a, b in zip(leaves(got), leaves(ref)))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "quadrotorilqr_tpu_torch", "kernels", "csrc")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from quadrotorilqr_tpu_torch import convert
    from quadrotorilqr_tpu_torch.costs.quadratic import QuadraticTrackingCost
    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.kernels import _build
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import fddp as kf
    from quadrotorilqr_tpu_torch.kernels import rollout as kr
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.solver import fddp, ilqr
    from quadrotorilqr_tpu_torch.solver.batched import (
        _with_max_iters,
        resolve_refine_auto,
        solve_batch_fddp,
        solve_batch_fused,
        solve_batch_latency,
    )
    from quadrotorilqr_tpu_torch.solver.options import (
        ConvergenceCriteria,
        ILQROptions,
        LineSearchParams,
    )

    # the plain versions use matmul: keep float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = f"[{smi}]"
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.load()
    log(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds if lib.build_seconds is None else round(lib.build_seconds, 1)} s)")
    for line in lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    wrappers = {
        "backward": kb.backward_pass_fused, "rollout": kr.rollout_cost_fused,
        "solve": ks.solve_fused_whole, "fddp": kf.solve_fddp_fused,
    }

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def time_once(fn):
        """(result, ms) of one run, CUDA events around it."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    # ---- 3. kernels against their plain versions, float64, B=300, N=40 ----
    p_np, c_np, t_np = np_problem(0, 300, 40)
    params = convert.params_from_numpy(p_np, torch.float64, dev)
    cost = convert.cost_from_numpy(c_np, torch.float64, dev)
    traj = convert.trajectory_from_numpy(t_np, torch.float64, dev)
    err = {}
    got = kb.backward_pass_fused(params, cost, traj, DT)
    ref = kb.backward_pass_reference(params, cost, traj, DT)
    torch.cuda.synchronize()
    err["backward"] = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
    rel = max(float(((g - r).abs() / r.abs()).max()) for g, r in zip(got[2:], ref[2:]))
    log(f"f64 backward: max |dk|,|dK| {err['backward']:.3e} (atol 1e-9), "
        f"max rel QuTk/kTQuuk {rel:.3e} (rtol 1e-9)")
    check(err["backward"] <= 1e-9 and rel <= 1e-9, "f64 backward kernel disagrees with plain")

    alpha = torch.linspace(0.1, 1.0, 300, dtype=torch.float64, device=dev)
    g_traj, g_cost = kr.rollout_cost_fused(params, cost, traj, ref[0], ref[1], alpha, DT)
    r_traj, r_cost = kr.rollout_cost_reference(params, cost, traj, ref[0], ref[1], alpha, DT)
    torch.cuda.synchronize()
    err["rollout"] = max(
        max_abs(g_traj.states.pose.quat, r_traj.states.pose.quat),
        max_abs(g_traj.states.pose.trans, r_traj.states.pose.trans),
        max_abs(g_traj.states.vel, r_traj.states.vel),
        max_abs(g_traj.controls, r_traj.controls),
    )
    rel = float(((g_cost - r_cost).abs() / r_cost.abs()).max())
    log(f"f64 rollout: max |dtraj| {err['rollout']:.3e} (atol 1e-10), "
        f"max rel cost {rel:.3e} (rtol 1e-10)")
    check(err["rollout"] <= 1e-10 and rel <= 1e-10, "f64 rollout kernel disagrees with plain")

    opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 6))
    got = ks.solve_fused_whole(params, cost, traj, DT, opts)
    ref = ks.solve_whole_reference(params, cost, traj, DT, opts)
    torch.cuda.synchronize()
    err["solve"] = max_abs(got[0].controls, ref[0].controls)
    rel = float(((got[1] - ref[1]).abs() / ref[1].abs()).max())
    same_status = bool((got[3] == ref[3]).all())
    same_iters = bool((got[2] == ref[2]).all())
    log(f"f64 whole solve: status equal {same_status}, iterations equal {same_iters}, "
        f"max rel cost {rel:.3e} (rtol 1e-8), max |du| {err['solve']:.3e} (atol 1e-7); "
        f"statuses {torch.bincount(ref[3], minlength=3).tolist()}")
    check(same_status and same_iters and rel <= 1e-8 and err["solve"] <= 1e-7,
          "f64 whole-solve kernel disagrees with plain")

    # FDDP, float64: tests/test_fddp_fused.py's mixed problem (even lanes
    # benign at scale 0.4, odd lanes an aggressive tumble at 1.8), dt 0.12
    mix_dt = 0.12
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.where(torch.arange(300, device=dev) % 2 == 0, 0.4, 1.8)[:, None]
    m_params, m_q, m_r, x0, desired = workloads.aggressive_tumble(
        gen, 300, n=40, dt_s=mix_dt, scale=scale.double(), dtype=torch.float64, device=dev
    )
    m_cost = QuadraticTrackingCost(
        Q=m_q, R=m_r, desired_states=desired.states, desired_controls=desired.controls
    )
    m_trajs = initial_trajectory_from_state(x0, desired)
    m_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-9, 1e-9, 25))
    fo = fddp.FDDPOptions()
    m_args = (m_params, m_cost, m_trajs, mix_dt, m_opts)
    for ddp in (False, True):
        got = kf.solve_fddp_fused(*m_args, fo, ddp=ddp)
        ref, plain_ms = time_once(lambda: kf.solve_fddp_whole_reference(*m_args, fo, ddp))
        torch.cuda.synchronize()
        same_status = (got[3] == ref[3]).float().mean().item()
        same_iters = (got[2] == ref[2]).float().mean().item()
        rel = ((got[1] - ref[1]).abs() / ref[1].abs())
        du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
        conv = ref[3] == ilqr.STATUS_CONVERGED
        if not ddp:
            err["fddp"] = float(du.max())
        log(f"f64 FDDP ddp={ddp} B=300 N=40: status equal {same_status:.4f}, iterations equal "
            f"{same_iters:.4f}, max rel cost {float(rel.max()):.3e}, max |du| {float(du.max()):.3e}; "
            f"statuses {torch.bincount(ref[3], minlength=3).tolist()}, converged {conv.float().mean().item():.3f}; "
            f"plain loop {plain_ms:.1f} ms")
        if not ddp:
            check(same_status == 1.0 and same_iters == 1.0 and float(rel.max()) <= 1e-8
                  and float(du.max()) <= 1e-7, "f64 FDDP kernel disagrees with plain")
        else:
            # exact curvature: the JAX package's own bar between its DDP
            # engines (tests/test_fddp_fused.py:382-416), since ~1e-16
            # differences in the closed forms can send a lane near an
            # accept or budget edge down another retry path
            strict = conv & (got[3] == ref[3]) & (got[2] == ref[2])
            check(same_status >= 0.98 and same_iters >= 0.95
                  and float(rel[strict].max()) <= 1e-8 and float(du[strict].max()) <= 1e-4
                  and float(rel.max()) < 2e-4, "f64 FDDP ddp kernel outside the DDP engines' bar")
    # resume rows: 7 trips, then the other 18 from the kernel's own mu,
    # status and iterations, against one launch of 25
    one = solve_batch_fddp(*m_args, fo)
    first = kf.solve_fddp_fused(*m_args[:4], _with_max_iters(m_opts, 7), fo, return_mu=True)
    two = kf.solve_fddp_fused(
        m_params, m_cost, first[0], mix_dt, _with_max_iters(m_opts, 18), fo,
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
    )
    torch.cuda.synchronize()
    exact = bit_equal(two, one)
    pending = int((first[3] == 0).sum())
    log(f"f64 FDDP two phases (boundary 7, {pending} lanes pending there) vs one: bit-equal {exact}")
    check(exact and pending > 0, "the two-phase FDDP kernel solve differs from the single phase")
    # no line-search probes: every trip rejects and only the mu schedule runs
    z_opts = ILQROptions(LineSearchParams(0.5, 0.5, 0), ConvergenceCriteria(1e-9, 1e-9, 5))
    got = kf.solve_fddp_fused(*m_args[:4], z_opts, fo, return_mu=True, return_probes=True)
    ref = kf.solve_fddp_whole_reference(*m_args[:4], z_opts, fo)
    torch.cuda.synchronize()
    exact = all(bool((g == r).all()) for g, r in zip(got[2:], ref[2:]))
    rel = float(((got[1] - ref[1]).abs() / ref[1].abs()).max())
    log(f"f64 FDDP with no line-search probes (5 trips): iterations, status, mu, probes and "
        f"defect trips equal {exact}, max rel cost {rel:.3e} (rtol 1e-12), final mu "
        f"{float(got[4].max()):.3e}")
    check(exact and rel <= 1e-12, "the zero-probe FDDP kernel disagrees with plain")
    log(f"launch counters after the comparisons: {counts()}")

    # ---- the bench workload, float32, B=4096, N=100 ----
    batch, horizon = 4096, 100
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, desired = workloads.hover_to_waypoint(
        gen, batch, n=horizon, dt_s=DT, dtype=torch.float32, pose_scale=0.3, device=dev
    )
    q_w, r_w = workloads.demo_weights(torch.float32, dev)
    bench_opts = ILQROptions(
        LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10)
    )
    api = QuadrotorILQR(
        1.0, torch.eye(3), 0.2, 0.016, 9.81, q_w, r_w, desired, DT, bench_opts,
        dtype=torch.float32, device=dev,
    )
    trajs = initial_trajectory_from_state(x0, desired)
    b_params, b_cost = api.params, api.cost

    # ---- 4. float32 at the main path's shapes: kernels vs plain, quality bounds ----
    # the per-pass kernels see the trajectory after trip 0's full step (the
    # initial one sits on the target past stage 0, where k is exactly 0)
    ones = torch.ones(batch, dtype=torch.float32, device=dev)
    k0, big_k0, _, _ = kb.backward_pass_reference(b_params, b_cost, trajs, DT)
    trajs1, _ = kr.rollout_cost_reference(b_params, b_cost, trajs, k0, big_k0, ones, DT)
    got = kb.backward_pass_fused(b_params, b_cost, trajs1, DT)
    ref = kb.backward_pass_reference(b_params, b_cost, trajs1, DT)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    scaled = max(max_abs(g, r) / float(r.abs().max()) for g, r in zip(got[:2], ref[:2]))
    log(f"f32 backward B={batch} N={horizon}: finite {finite}, "
        f"max |dk|,|dK| / max |ref| {scaled:.3e} (bound 1e-3)")
    check(finite and scaled <= 1e-3, "f32 backward kernel outside its bound")
    g_traj, g_cost = kr.rollout_cost_fused(b_params, b_cost, trajs1, ref[0], ref[1], ones, DT)
    r_traj, r_cost = kr.rollout_cost_reference(b_params, b_cost, trajs1, ref[0], ref[1], ones, DT)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(g_traj.controls).all() and torch.isfinite(g_cost).all())
    du = max_abs(g_traj.controls, r_traj.controls) / float(r_traj.controls.abs().max())
    dc = float(((g_cost - r_cost).abs() / r_cost.abs()).max())
    log(f"f32 rollout: finite {finite}, max |du| / max |u| {du:.3e} (bound 1e-3), "
        f"max rel cost {dc:.3e} (bound 1e-3)")
    check(finite and du <= 1e-3 and dc <= 1e-3, "f32 rollout kernel outside its bound")
    got = ks.solve_fused_whole(b_params, b_cost, trajs, DT, bench_opts)
    # the plain loop runs once: it is timed here
    ref, plain_solve_ms = time_once(
        lambda: ks.solve_whole_reference(b_params, b_cost, trajs, DT, bench_opts)
    )
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got[1]).all() and torch.isfinite(got[0].controls).all())
    agree = float((got[3] == ref[3]).float().mean())
    med = float(((got[1] - ref[1]).abs() / ref[1].abs()).median())
    log(f"f32 whole solve: finite {finite}, status agreement {agree:.4f} (>= 0.99), "
        f"median rel cost diff {med:.3e} (< 1e-3)")
    check(finite and agree >= 0.99 and med < 1e-3, "f32 whole-solve kernel outside its bounds")

    # ---- 5. the exact main path through the public API, counted ----
    reset_counts()
    res_whole = api.solve_batch(trajs, latency=True)
    res_loop = api.solve_batch(trajs, fused=True)
    torch.cuda.synchronize()
    launches = counts()
    log(f"exact main path launches: {launches}")
    check(all(launches[k] > 0 for k in ("backward", "rollout", "solve")),
          f"a kernel of the path never ran: {launches}")
    for name, res in (("whole-solve kernel", res_whole), ("per-pass kernels", res_loop)):
        check(res.cost.shape == (batch,) and res.trajectory.controls.shape == (batch, horizon, 4),
              f"{name}: wrong output shapes")
        check(bool(torch.isfinite(res.cost).all() and torch.isfinite(res.trajectory.controls).all()),
              f"{name}: non-finite output")
        conv = float((res.status == ilqr.STATUS_CONVERGED).float().mean())
        iters = float(res.iterations.float().mean())
        log(f"bench workload via {name}: converged {conv:.4f} (>= 0.99), mean iterations "
            f"{iters:.3f} (in [3, 4.5]), mean cost {float(res.cost.mean()):.6g}")
        check(conv >= 0.99 and 3.0 <= iters <= 4.5, f"{name}: convergence outside its bounds")

    # ---- 5b. the robust main path through the public API, counted ----
    # The aggressive-tumble class of the robust headline (benchmarks/run_all.py
    # config 6): B=4096, N=50, dt 0.1, scale 1.8, 40 iterations, tolerance
    # 1e-6; the API's FDDP options resolve gap_tol to 1e-5 in float32, the
    # value config 6 passes.
    r_batch, r_n, r_dt = 4096, 50, 0.1
    gen = torch.Generator(device=dev).manual_seed(0)
    r_params, r_q, r_r, x0, r_desired = workloads.aggressive_tumble(
        gen, r_batch, n=r_n, dt_s=r_dt, dtype=torch.float32, device=dev
    )
    r_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 40))
    r_fo = fddp.FDDPOptions(gap_tol=1e-5)
    robust = QuadrotorILQR(
        float(r_params.mass_kg), r_params.inertia, float(r_params.arm_length_m),
        float(r_params.torque_to_thrust_ratio_m), float(r_params.g_mpss), r_q, r_r,
        r_desired, r_dt, r_opts, dtype=torch.float32, device=dev, solver="fddp",
    )
    r_trajs = initial_trajectory_from_state(x0, r_desired)
    # refine="auto": phases of one curvature run as one launch, so Gauss-Newton
    # trips up to the switch, then exact-DDP trips resumed from them
    bounds, flags = resolve_refine_auto(40, False)
    edges = (0,) + bounds + (40,)
    switch = edges[flags.index(True)]
    reset_counts()
    res_robust = robust.solve_batch(r_trajs)
    torch.cuda.synchronize()
    robust_launches = counts()
    log(f"robust main path launches: {robust_launches} (Gauss-Newton trips 0-{switch}, "
        f"exact DDP {switch}-40)")
    check(robust_launches["fddp"] == 2, f"the FDDP kernel did not run twice: {robust_launches}")
    check(res_robust.cost.shape == (r_batch,) and res_robust.trajectory.controls.shape == (r_batch, r_n, 4),
          "robust path: wrong output shapes")
    leaves = (res_robust.cost, res_robust.trajectory.controls, res_robust.trajectory.states.pose.quat,
              res_robust.trajectory.states.pose.trans, res_robust.trajectory.states.vel)
    check(all(bool(torch.isfinite(a).all()) for a in leaves), "robust path: non-finite output")
    r_conv = float((res_robust.status == ilqr.STATUS_CONVERGED).float().mean())
    log(f"aggressive tumble via QuadrotorILQR(solver='fddp').solve_batch (refine auto, f32, "
        f"B={r_batch}, N={r_n}): converged {r_conv:.4f} (>= 0.97), mean iterations "
        f"{float(res_robust.iterations.float().mean()):.3f}, statuses "
        f"{torch.bincount(res_robust.status, minlength=3).tolist()}")
    check(r_conv >= 0.97, "robust path: converged fraction below 0.97")

    # the main path's two launches, each on its own, and the schedule's
    # seven phases launched one by one: the same bits as the API
    r_args = (robust.params, robust.cost, r_trajs, r_dt, r_opts, r_fo)
    rp_args = (robust.params, robust.cost)
    gn_opts, ddp_opts = _with_max_iters(r_opts, switch), _with_max_iters(r_opts, 40 - switch)
    gn_k = kf.solve_fddp_fused(*rp_args, r_trajs, r_dt, gn_opts, r_fo, return_mu=True,
                               return_probes=True)
    rows = dict(initial_mu=gn_k[4], initial_status=gn_k[3], initial_iters=gn_k[2])
    ddp_k = kf.solve_fddp_fused(*rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True, return_mu=True,
                                return_probes=True, **rows)
    out = (r_trajs, None, None, None, None)
    for lo, hi, flag in zip(edges, edges[1:], flags):
        out = kf.solve_fddp_fused(
            *rp_args, out[0], r_dt, _with_max_iters(r_opts, hi - lo), r_fo, ddp=flag,
            initial_mu=out[4], initial_status=out[3], initial_iters=out[2], return_mu=True,
        )
    torch.cuda.synchronize()
    same_two, same_seven = bit_equal(ddp_k, res_robust), bit_equal(out, res_robust)
    log(f"robust path = its two launches on their own: bit-equal {same_two}; = the "
        f"{len(flags)} phases launched one by one: bit-equal {same_seven}")
    check(same_two and same_seven, "the robust path's launches differ from its phase schedule")

    # each launch against the plain FDDP loop on the same inputs and resume
    # rows (float32: quality bounds, line-search flips are inherent)
    def conv_of(r):
        return float((r[3] == ilqr.STATUS_CONVERGED).float().mean())

    gn_p, plain_gn_ms = time_once(lambda: kf.solve_fddp_whole_reference(
        *rp_args, r_trajs, r_dt, gn_opts, r_fo))
    torch.cuda.synchronize()
    med = float(((gn_k[1] - gn_p[1]).abs() / gn_p[1].abs()).median())
    log(f"f32 FDDP Gauss-Newton launch (trips 0-{switch}) vs plain loop: converged "
        f"{conv_of(gn_k):.4f} vs {conv_of(gn_p):.4f} (within 0.01), status agreement "
        f"{float((gn_k[3] == gn_p[3]).float().mean()):.4f}, median rel cost diff {med:.3e} (< 1e-3)")
    check(abs(conv_of(gn_k) - conv_of(gn_p)) <= 0.01 and med < 1e-3,
          "f32 FDDP Gauss-Newton launch outside its bounds")
    ddp_p, plain_ddp_ms = time_once(lambda: kf.solve_fddp_whole_reference(
        *rp_args, gn_k[0], r_dt, ddp_opts, r_fo, True, gn_k[4], gn_k[3], gn_k[2]))
    torch.cuda.synchronize()
    live = gn_k[3] == 0
    rel = (ddp_k[1] - ddp_p[1]).abs() / ddp_p[1].abs()
    med = float(rel[live].median())
    conv_live = [float((r[3][live] == ilqr.STATUS_CONVERGED).float().mean()) for r in (ddp_k, ddp_p)]
    log(f"f32 FDDP exact-DDP launch (trips {switch}-40, resumed; {int(live.sum())} lanes pending "
        f"at the switch) vs plain loop on the same rows: converged {conv_of(ddp_k):.4f} vs "
        f"{conv_of(ddp_p):.4f} (within 0.01; of the pending lanes {conv_live[0]:.4f} vs "
        f"{conv_live[1]:.4f}), status agreement of the pending lanes "
        f"{float((ddp_k[3][live] == ddp_p[3][live]).float().mean()):.4f}, their median rel cost "
        f"diff {med:.3e} (< 1e-3), mean iterations {float(ddp_k[2].float().mean()):.3f} vs "
        f"{float(ddp_p[2].float().mean()):.3f}")
    check(int(live.sum()) > 0 and abs(conv_of(ddp_k) - conv_of(ddp_p)) <= 0.01 and med < 1e-3,
          "f32 FDDP exact-DDP launch outside its bounds")
    # what the two launches ran, for the bound: trips, probe sweeps, defect trips
    work_gn = (int(gn_k[2].sum()), float(gn_k[5].sum()), int(gn_k[6].sum()))
    work_ddp = (int((ddp_k[2] - gn_k[2]).sum()), float(ddp_k[5].sum()), int(ddp_k[6].sum()))
    log(f"the FDDP launches ran (trips, probe sweeps, defect trips): Gauss-Newton {work_gn}, "
        f"exact DDP {work_ddp}")
    # the single-phase kernel, for its convergence beside the schedule's
    single = kf.solve_fddp_fused(*r_args)
    torch.cuda.synchronize()
    log(f"f32 single-phase FDDP kernel (Gauss-Newton, 40 trips): converged {conv_of(single):.4f}, "
        f"mean iterations {float(single[2].float().mean()):.3f}")

    # ---- 6. timing (CUDA events, 1 warm-up, median of 5) ----
    def time_ms(fn, repeats=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    solve_args = (b_params, b_cost, trajs, DT, bench_opts)
    ms = {}
    ms["solve"] = time_ms(lambda: solve_batch_latency(*solve_args))
    ms["loop"] = time_ms(lambda: solve_batch_fused(*solve_args))
    ms["plain"] = plain_solve_ms
    for key, label in (("solve", "whole-solve kernel"), ("loop", "per-pass kernel loop"),
                       ("plain", "plain PyTorch loop")):
        log(f"{label}: {ms[key]:.3f} ms per batch solve, {batch / ms[key] * 1e3:.1f} solves/s "
            f"(B={batch}, N={horizon}, f32) {card}")
    k1, big_k1, _, _ = kb.backward_pass_reference(b_params, b_cost, trajs1, DT)
    per_kernel = {
        "backward": (
            time_ms(lambda: kb.backward_pass_fused(b_params, b_cost, trajs1, DT)),
            time_ms(lambda: kb.backward_pass_reference(b_params, b_cost, trajs1, DT)),
        ),
        "rollout": (
            time_ms(lambda: kr.rollout_cost_fused(b_params, b_cost, trajs1, k1, big_k1, ones, DT)),
            time_ms(
                lambda: kr.rollout_cost_reference(b_params, b_cost, trajs1, k1, big_k1, ones, DT)
            ),
        ),
        "solve": (ms["solve"], ms["plain"]),
    }
    # the FDDP kernel's time on the main path: its two launches, each timed
    ms["fddp_gn"] = time_ms(lambda: kf.solve_fddp_fused(*rp_args, r_trajs, r_dt, gn_opts, r_fo))
    ms["fddp_ddp"] = time_ms(lambda: kf.solve_fddp_fused(
        *rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
    per_kernel["fddp"] = (ms["fddp_gn"] + ms["fddp_ddp"], plain_gn_ms + plain_ddp_ms)
    for name, (k_ms, p_ms) in per_kernel.items():
        b_, n_ = (r_batch, r_n) if name == "fddp" else (batch, horizon)
        log(f"{name} kernel: {k_ms:.3f} ms, plain {p_ms:.3f} ms (B={b_}, N={n_}, f32) {card}")
    log(f"fddp launches: Gauss-Newton trips 0-{switch} {ms['fddp_gn']:.3f} ms (plain "
        f"{plain_gn_ms:.3f} ms), exact DDP trips {switch}-40 {ms['fddp_ddp']:.3f} ms (plain "
        f"{plain_ddp_ms:.3f} ms) {card}")
    ms_robust = time_ms(lambda: robust.solve_batch(r_trajs))
    ms_single = time_ms(lambda: kf.solve_fddp_fused(*r_args))
    log(f"robust path (refine auto, 2 FDDP launches): {ms_robust:.3f} ms per batch solve, "
        f"{r_batch / ms_robust * 1e3:.1f} solves/s; single-phase kernel {ms_single:.3f} ms "
        f"(B={r_batch}, N={r_n}, f32) {card}")

    # ---- 7. bounds: the work this run's inputs needed ----
    f = FLOPS
    word = 4  # float32
    stage = batch * horizon
    whole_trips = int(res_whole.iterations.sum())  # backward passes and probes: at least one each
    work = {
        "backward": (stage * f["riccati"], (17 + 52) * stage * word + 2 * batch * word),
        "rollout": (stage * f["rollout"], (17 + 52 + 17) * stage * word + 2 * batch * word),
        "solve": (whole_trips * horizon * (f["riccati"] + f["rollout"]),
                  2 * 17 * stage * word + 3 * batch * word),
        # the two launches: every trip transports the gradient and runs the
        # Riccati stage and the model terms (the exact-DDP launch with its
        # additions); defects only on the trips that computed them; the seed
        # cost once
        "fddp": (
            sum(
                r_n * (trips * (f["transport"] + f["riccati"] + extra + f["model"])
                       + defect_trips * f["defect"] + sweeps * f["gap_rollout"])
                for (trips, sweeps, defect_trips), extra in ((work_gn, 0), (work_ddp, f["ddp_extra"]))
            ) + r_batch * r_n * f["stage_cost"],
            2 * 17 * r_batch * r_n * word + 6 * r_batch * word,
        ),
    }
    bounds = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bounds[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        log(f"{name} bound: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB -> "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); measured {per_kernel[name][0]:.3f} ms")

    pkg = "quadrotorilqr_tpu_torch/kernels/csrc"
    replaces = {
        "backward": "quadrotorilqr_tpu/kernels/backward.py:594",
        "rollout": "quadrotorilqr_tpu/kernels/rollout.py:54",
        "solve": "quadrotorilqr_tpu/kernels/solve.py:159",
        "fddp": "quadrotorilqr_tpu/kernels/fddp.py:245",
    }
    launches["fddp"] = robust_launches["fddp"]
    # no single PyTorch call computes a Riccati sweep, a closed-loop rollout
    # or a whole solve, so there is no library time to set beside them
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"{pkg}/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": per_kernel[name][0], "plain_ms": per_kernel[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
        }
        for name in ("backward", "rollout", "solve", "fddp")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
