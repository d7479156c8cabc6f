#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `quadrotorilqr_tpu_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card (float64
lane for lane at B=300, N=40; float32 at the main path's B=4096, N=100 to
quality bounds), drives the main path (the hover-to-waypoint bench workload,
B=4096, N=100, tolerance 1e-6, 10 iterations, 20 line-search probes) through
`QuadrotorILQR.solve_batch` with `latency=True` (the whole-solve kernel) and
with `fused=True` (the per-pass kernels), checks convergence, and times the
kernel routes against the plain PyTorch loop with CUDA events.

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
    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.kernels import _build
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import rollout as kr
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.solver import ilqr
    from quadrotorilqr_tpu_torch.solver.batched import solve_batch_fused, solve_batch_latency
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

    def reset_counts():
        for fn in (kb.backward_pass_fused, kr.rollout_cost_fused, ks.solve_fused_whole):
            fn.launches = 0

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
    log(f"launch counters after the comparisons: backward {kb.backward_pass_fused.launches}, "
        f"rollout {kr.rollout_cost_fused.launches}, solve {ks.solve_fused_whole.launches}")

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
    ref = ks.solve_whole_reference(b_params, b_cost, trajs, DT, bench_opts)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got[1]).all() and torch.isfinite(got[0].controls).all())
    agree = float((got[3] == ref[3]).float().mean())
    med = float(((got[1] - ref[1]).abs() / ref[1].abs()).median())
    log(f"f32 whole solve: finite {finite}, status agreement {agree:.4f} (>= 0.99), "
        f"median rel cost diff {med:.3e} (< 1e-3)")
    check(finite and agree >= 0.99 and med < 1e-3, "f32 whole-solve kernel outside its bounds")

    # ---- 5. the main path through the public API, counted ----
    reset_counts()
    res_whole = api.solve_batch(trajs, latency=True)
    res_loop = api.solve_batch(trajs, fused=True)
    torch.cuda.synchronize()
    launches = {
        "backward": kb.backward_pass_fused.launches,
        "rollout": kr.rollout_cost_fused.launches,
        "solve": ks.solve_fused_whole.launches,
    }
    log(f"main path launches: {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel of the path never ran: {launches}")
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
    ms["plain"] = time_ms(lambda: ilqr.solve(*solve_args))
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
    for name, (k_ms, p_ms) in per_kernel.items():
        log(f"{name} kernel: {k_ms:.3f} ms, plain {p_ms:.3f} ms (B={batch}, N={horizon}, f32) {card}")

    pkg = "quadrotorilqr_tpu_torch/kernels/csrc"
    replaces = {
        "backward": "quadrotorilqr_tpu/kernels/backward.py:594",
        "rollout": "quadrotorilqr_tpu/kernels/rollout.py:54",
        "solve": "quadrotorilqr_tpu/kernels/solve.py:159",
    }
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"{pkg}/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": per_kernel[name][0], "plain_ms": per_kernel[name][1],
        }
        for name in ("backward", "rollout", "solve")
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
