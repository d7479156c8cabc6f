#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `quadrotorilqr_tpu_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card (float64
lane for lane at B=300, N=40; float32 at the main paths' shapes to quality
bounds), each streamed kernel against its whole-solve twin, the per-pass
kernels with lanes masked out against a full launch and their route
(float64) against the whole-solve kernel, and drives four main paths
through `QuadrotorILQR.solve_batch`:

  * exact iLQR on the hover-to-waypoint bench workload (B=4096, N=100,
    tolerance 1e-6, 10 iterations, 20 line-search probes), with
    `latency=True` (the whole-solve kernel) and `fused=True` (the per-pass
    kernels);
  * robust FDDP (`solver="fddp"`, float32: the `refine="auto"` schedule,
    one FDDP kernel launch of Gauss-Newton trips and one of exact-DDP trips
    resumed from it) on the aggressive-tumble class of the robust headline
    (B=4096, N=50, dt 0.1, scale 1.8, 40 iterations); each launch is held
    against the plain FDDP loop on the same inputs and resume rows;
  * the long-horizon paths on `long_horizon_problem` at B=4096: exact iLQR
    at N=1024 with `latency=True` (past 256 stages: one `stream.cu` launch;
    tolerance 1e-6, 10 iterations, 20 probes) and robust FDDP at N=512
    (past 231 stages: `refine="auto"` as two `stream_fddp.cu` launches;
    tolerance 1e-6, 12 iterations, gap_tol 1e-5), each beside its
    whole-solve twin (`solve.cu`, `fddp.cu`) on the same inputs; on these
    inputs each streamed kernel is held against its plain loop for the
    path's first LONG_PLAIN_TRIPS trips.

It checks convergence, times the kernels against their plain PyTorch
versions with CUDA events, and computes each kernel's bound (the least time
the card could take for the work this run's inputs needed).

It also times the whole-solve kernel `solve.cu` against `stream.cu` on the
bench workload's class at N = 50, 100 and 256, and the per-pass kernels'
launches alone (CUDA events around the launch, not the wrapper's operand
preparation).

The reference-parity path: BASELINE config 1 (the reference demo, float64,
N=40, rtol = atol = 1e-12) solved on the card by `QuadrotorILQR.solve(proto)`
(`solve_pytree` alone where protobuf is not installed: the plain loop with
the debug record) and by `solve_batch(latency=True)` at B=1 (`solve.cu`
recording its cost history), each against the C++ oracle
(`native/qilqr_oracle.cc`, built with g++ into `build/oracle/` and bound
here with ctypes);
BASELINE config 3 (the figure eight with per-scenario weights, B=4096,
N=200, float32) through both exact kernel routes, timed; `solve.cu`'s
recorded launch (cost history, backward passes, probe sweeps) against its
plain version in float64 and its time beside the launch without, and the
per-pass route with the debug record, timed with its peak memory.

Output: progress lines (with each compiled kernel's and never-inlined
function's ptxas registers, spill stores and stack, and the team kernels'
geometry: lanes per scenario, teams per block, shared
bytes), the card's `nvidia-smi` name and power limit, a JSON line
`{"kernels": [...]}` with each kernel's launches, error and times,
and as the last line `{"ok": true, "device": {...}}`. Any failed check
raises, so the exit code is not 0. Without a CUDA device, or without the
repository beside it, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 0.02
# The streamed kernels are held against their plain loops on the long
# paths' inputs for the paths' first trips only (the first trip's full step
# and a line-searched trip with its apply sweep): at N=1024 a plain trip
# takes 15-20 s (a backward pass, a probe and an apply sweep), and a trip
# in which some lane's line search runs out adds 20 probe sweeps
LONG_PLAIN_TRIPS = 2

# The least time the card could take: the larger of the operations over the
# H100's float32 rate outside the tensor cores and the bytes (each input read
# once, each output written once) over its memory rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Floating-point operations per scenario and stage, counted by hand from the
# CUDA device functions (kernels/csrc/*.cuh; a multiply-add is 2, a square
# root, sine, cosine, atan2 or division 1):
#   Riccati stage, Gauss-Newton (team_riccati_stage): j_x blocks 1006 + cost
#     diffs 3019 + Q-expansion 5675 + Cholesky gains 460 + value update 1914;
#   the exact-DDP additions (kDdp): c_xx correction 3064 + sum v_x f_xx 3776;
#   rollout stage (team_rollout): state minus 227 + controls 100 + stage cost
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


def start_oracle_build():
    """g++ on the C++ oracle (native/qilqr_oracle.cc: the reference loop in
    float64 on the host), started now and waited for by `load_oracle`."""
    out_dir = os.path.join(ROOT, "build", "oracle")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "libqilqr_oracle.so")
    src = os.path.join(ROOT, "native", "qilqr_oracle.cc")
    proc = subprocess.Popen(
        ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-o", path, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, path


def load_oracle(build):
    """The built oracle's `qilqr_solve`, declared for ctypes."""
    proc, path = build
    log_text = proc.communicate()[0]
    check(proc.returncode == 0, f"g++ failed on the C++ oracle:\n{log_text}")
    lib = ctypes.CDLL(path)
    d = ctypes.POINTER(ctypes.c_double)
    lib.qilqr_solve.restype = ctypes.c_int
    lib.qilqr_solve.argtypes = [
        ctypes.c_double, d, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        d, d, d, d, d, d, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        d, d, d, ctypes.POINTER(ctypes.c_int),
    ]
    return lib.qilqr_solve


def oracle_solve(solve, params, q, r, desired, initial, dt, ls, cc):
    """One solve of the C++ oracle on float64 numpy arrays: params is
    (mass, inertia, arm, torque ratio, g); desired and initial are (quat,
    trans, vel, controls) of one trajectory; ls and cc the line-search and
    convergence triples. Returns (status, iterations, cost, controls)."""
    import numpy as np

    d = ctypes.POINTER(ctypes.c_double)
    keep = []

    def ptr(a):
        a = np.ascontiguousarray(a, np.float64)
        keep.append(a)
        return a.ctypes.data_as(d)

    def packed(t):
        return np.concatenate([t[0], t[1], t[2]], -1)

    n = initial[3].shape[0]
    controls = np.zeros((n, 4))
    states = np.zeros((n, 13))
    cost = np.zeros(1)
    iters = ctypes.c_int(0)
    mass, inertia, arm, kappa, g = params
    status = solve(
        mass, ptr(inertia), arm, kappa, g, ptr(q), ptr(r), ptr(packed(desired)), ptr(desired[3]),
        ptr(packed(initial)), ptr(initial[3]), n, dt, ls[0], ls[1], int(ls[2]), cc[0], cc[1],
        int(cc[2]), states.ctypes.data_as(d), controls.ctypes.data_as(d),
        cost.ctypes.data_as(d), ctypes.byref(iters),
    )
    return status, iters.value, float(cost[0]), controls


def max_abs(a, b):
    return float((a - b).abs().max())


def bit_equal(got, ref):
    """Status, iterations, cost and every trajectory leaf identical; each
    argument a SolveResult or the kernel wrapper's tuple."""
    def leaves(r):
        t, c, i, s = (r.trajectory, r.cost, r.iterations, r.status) if hasattr(r, "cost") else r[:4]
        return (s, i, c, t.controls, t.states.pose.quat, t.states.pose.trans, t.states.vel)
    return all(bool((a == b).all()) for a, b in zip(leaves(got), leaves(ref)))


def ptxas_summary(build_log):
    """{function: (registers or None, spill store bytes, stack bytes)} from
    the build's `-Xptxas -v` lines, named as `kernel<float, ddp>`: entry
    functions with their registers, never-inlined device functions with
    their spills and stack."""
    import re

    def short(mangled):
        # the nested names after _ZN (qilqr, the team size's namespace, the
        # function), then the template arguments
        if not mangled.startswith("_ZN"):
            return mangled
        i, parts = 3, []
        while (m := re.match(r"\d+", mangled[i:])) is not None:
            i += m.end()
            parts.append(mangled[i:i + int(m.group())])
            i += int(m.group())
        name = "::".join(parts[1:] if parts[:1] == ["qilqr"] else parts)
        args = re.match(r"I([fd])(?:Lb([01])E)?", mangled[i:])
        if not args:
            return name
        parts = ["float" if args.group(1) == "f" else "double"]
        if args.group(2) is not None:
            flags = ("record", "no record") if name.endswith("solve_kernel") else (
                "ddp", "gauss-newton")
            parts.append(flags[0] if args.group(2) == "1" else flags[1])
        return f"{name}<{', '.join(parts)}>"

    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = short(m.group(1))
            out.setdefault(current, [None, 0, 0])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and current is not None:
            out[current][1], out[current][2] = int(m.group(2)), int(m.group(1))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = short(m.group(1))
            out.setdefault(current, [None, 0, 0])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            out[current][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


T0 = time.perf_counter()


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

    import numpy as np

    from quadrotorilqr_tpu_torch import convert
    from quadrotorilqr_tpu_torch.costs.quadratic import QuadraticTrackingCost
    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.kernels import _build
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import fddp as kf
    from quadrotorilqr_tpu_torch.kernels import rollout as kr
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.kernels import stream as kst
    from quadrotorilqr_tpu_torch.kernels import stream_fddp as ksf
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.tree import tree_map
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

    # ---- 2. build (the C++ oracle's g++ beside the kernels' nvcc) ----
    oracle_build = start_oracle_build()
    t0 = time.perf_counter()
    try:
        lib = _build.load()
    finally:
        oracle = load_oracle(oracle_build)
    log(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds if lib.build_seconds is None else round(lib.build_seconds, 1)} s)")
    for name, (regs, spill, stack) in ptxas_summary(lib.build_log).items():
        log(f"ptxas {name}: {'-' if regs is None else regs} registers, {spill} B spill stores, "
            f"{stack} B stack")
    # the team kernels' geometry (csrc/team.cuh): lanes per scenario, teams
    # per block, shared memory per block and per team
    team = {}
    for name in _build.TEAM_KERNELS:
        for dtype_name, f64 in (("float32", 0), ("float64", 1)):
            for strides in ((0, 0), (1, 1)):
                info = (ctypes.c_longlong * 6)()
                getattr(lib.cdll, f"qilqr_{name}_team_info")(f64, *strides, info)
                team[(name, dtype_name, strides)] = list(info)
                log(f"{name}.cu, {dtype_name}, Q/R and model parameters at B-stride "
                    f"{strides}: {info[0]} lanes per scenario, {info[1]} teams per block of "
                    f"{info[2]} threads, {info[3]} shared bytes per block ({info[5]} per "
                    f"team's state), {info[4]} ring slots")

    wrappers = {
        "backward": kb.backward_pass_fused, "rollout": kr.rollout_cost_fused,
        "solve": ks.solve_fused_whole, "fddp": kf.solve_fddp_fused,
        "stream": kst.solve_fused_streamed, "stream_fddp": ksf.solve_fddp_streamed,
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

    # the per-pass kernels with every third lane masked out: the computed
    # lanes bit-equal to the full launches'; backward's gains (views of one
    # (N, B, 52) buffer) handed to the rollout kernel without a copy
    act = torch.arange(300, device=dev) % 3 != 1
    k_full = kb.backward_pass_fused(params, cost, traj, DT)
    k_part = kb.backward_pass_fused(params, cost, traj, DT, active=act)
    r_part = kr.rollout_cost_fused(params, cost, traj, ref[0], ref[1], alpha, DT, active=act)
    real_launch, handed = _build.launch, []

    def spy(entry, *args):
        if entry == "qilqr_rollout":
            handed.append(args[1][12 + 4])  # the gains pointer, after Problem and q t v u
        return real_launch(entry, *args)

    _build.launch = spy
    try:
        kr.rollout_cost_fused(params, cost, traj, k_full[0], k_full[1], alpha, DT)
    finally:
        _build.launch = real_launch
    torch.cuda.synchronize()
    masked = all(bool((a[act] == b[act]).all()) for a, b in zip(k_part, k_full)) and all(
        bool((a[act] == b[act]).all())
        for a, b in zip((r_part[0].controls, r_part[0].states.pose.quat, r_part[1]),
                        (g_traj.controls, g_traj.states.pose.quat, g_cost))
    )
    no_copy = handed == [k_full[0].data_ptr()]
    log(f"f64 per-pass kernels with {int((~act).sum())} of 300 lanes masked out: the others "
        f"bit-equal to the full launches {masked}; backward's gains reach the rollout kernel "
        f"without a copy {no_copy}")
    check(masked and no_copy, "the per-pass kernels' masked lanes or gains hand-over are wrong")

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
    # the recorded launch (solve.cu's cost history, backward passes and
    # probe sweeps) against the plain loop's, and against the launch without
    rec = ks.solve_fused_whole(params, cost, traj, DT, opts, return_history=True,
                               return_probes=True)
    torch.cuda.synchronize()
    same_run = bit_equal(rec, got) and all(
        bool((a == b).all()) for a, b in ((rec[0].states.pose.quat, got[0].states.pose.quat),
                                          (rec[0].states.pose.trans, got[0].states.pose.trans),
                                          (rec[0].states.vel, got[0].states.vel)))
    same_counts = bool((rec[5] == ref[5]).all() and (rec[6] == ref[6]).all())
    same_slots = bool(((rec[4] == 0) == (ref[4] == 0)).all())
    filled = ref[4] != 0
    hist_rel = float(((rec[4] - ref[4]).abs() / ref[4].abs())[filled].max())
    hist_bits = int((rec[4] == ref[4])[filled].sum())
    last_bits = int((rec[4] == rec[1][:, None])[torch.arange(300, device=dev), rec[2].long() - 1].sum())
    log(f"f64 solve.cu recorded launch (history, backward passes, probe sweeps): bit-equal to the "
        f"launch without {same_run}; passes and probe sweeps equal to plain {same_counts} (sums "
        f"{int(rec[5].sum())}, {int(rec[6].sum())}); history: the same {int(filled.sum())} slots "
        f"filled {same_slots}, max rel diff {hist_rel:.3e} (rtol 1e-8), bit-equal to plain on "
        f"{hist_bits} of {int(filled.sum())} slots (the final costs on {int((got[1] == ref[1]).sum())} "
        f"of 300 lanes); each lane's last slot is its final cost on {last_bits} of 300")
    check(same_run and same_counts and same_slots and hist_rel <= 1e-8 and last_bits == 300,
          "solve.cu's recorded launch disagrees with plain or with the launch without history")
    # the per-pass route (the loop on the host, one backward or rollout
    # launch at a time) against solve.cu at the same bars
    loop = solve_batch_fused(params, cost, traj, DT, opts)
    torch.cuda.synchronize()
    same = bool((loop.status == got[3]).all() and (loop.iterations == got[2]).all())
    rel = float(((loop.cost - got[1]).abs() / got[1].abs()).max())
    du = max_abs(loop.trajectory.controls, got[0].controls)
    bits = int(((loop.status == got[3]) & (loop.iterations == got[2]) & (loop.cost == got[1])
                & (loop.trajectory.controls == got[0].controls).flatten(1).all(1)).sum())
    log(f"f64 per-pass route vs solve.cu: status and iterations equal {same}, max rel cost "
        f"{rel:.3e} (rtol 1e-8), max |du| {du:.3e} (atol 1e-7); bit-equal on {bits} of 300 lanes")
    check(same and rel <= 1e-8 and du <= 1e-7, "f64 per-pass route disagrees with solve.cu")

    def twins(got, ref, rtol=1e-12, atol=1e-10):
        """Status and iterations equal, cost within rtol, controls within
        atol: (agree, max rel cost, max |du|)."""
        rel = float(((got[1] - ref[1]).abs() / ref[1].abs()).max())
        du = max_abs(got[0].controls, ref[0].controls)
        same = bool((got[3] == ref[3]).all() and (got[2] == ref[2]).all())
        return same and rel <= rtol and du <= atol, rel, du

    # the streamed exact kernel against plain (the whole loop's plain
    # version: the streamed schedule gives its bits on the CPU,
    # tests/test_torch_stream.py) and against solve.cu, then a starved line
    # search (one probe, twice the predicted reduction) that fails lanes
    got_s = kst.solve_fused_streamed(params, cost, traj, DT, opts)
    ok_p, rel_p, err["stream"] = twins(got_s, ref)
    ok_w, rel_w, du_w = twins(got_s, got)
    starved = ILQROptions(LineSearchParams(0.5, 2.0, 1), ConvergenceCriteria(1e-12, 1e-12, 4))
    st_s = kst.solve_fused_streamed(params, cost, traj, DT, starved)
    st_w = ks.solve_fused_whole(params, cost, traj, DT, starved)
    st_p = ks.solve_whole_reference(params, cost, traj, DT, starved)
    torch.cuda.synchronize()
    ok_sp, rel_sp, du_sp = twins(st_s, st_p)
    ok_sw, rel_sw, du_sw = twins(st_s, st_w)
    failed = int((st_s[3] == 2).sum())
    # solve.cu's probes store the candidates stream.cu's apply sweeps write
    bits = bit_equal(got_s, got) and bit_equal(st_s, st_w)
    log(f"f64 streamed solve vs plain: lane for lane {ok_p} (max rel cost {rel_p:.3e}, max |du| "
        f"{err['stream']:.3e}); vs solve.cu {ok_w} ({rel_w:.3e}, {du_w:.3e}); starved line search "
        f"({failed} lanes failed) vs plain {ok_sp} ({rel_sp:.3e}, {du_sp:.3e}), vs solve.cu {ok_sw} "
        f"({rel_sw:.3e}, {du_sw:.3e}) (rtol 1e-12, atol 1e-10); stream.cu bit-equal to solve.cu "
        f"in both {bits}")
    check(ok_p and ok_w and ok_sp and ok_sw and failed > 0 and bits,
          "f64 streamed kernel disagrees with plain or solve.cu")

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
    m_refs = {}

    def ddp_bar(got, ref):
        """The JAX package's own bar between its DDP engines
        (tests/test_fddp_fused.py:382-416): ~1e-16 differences in the closed
        forms can send a lane near an accept or budget edge down another
        retry path."""
        conv = ref[3] == ilqr.STATUS_CONVERGED
        strict = conv & (got[3] == ref[3]) & (got[2] == ref[2])
        rel = (got[1] - ref[1]).abs() / ref[1].abs()
        du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
        return (float((got[3] == ref[3]).float().mean()) >= 0.98
                and float((got[2] == ref[2]).float().mean()) >= 0.95
                and float(rel[strict].max()) <= 1e-8 and float(du[strict].max()) <= 1e-4
                and float(rel.max()) < 2e-4)

    for ddp in (False, True):
        got = kf.solve_fddp_fused(*m_args, fo, ddp=ddp)
        ref, plain_ms = time_once(lambda: kf.solve_fddp_whole_reference(*m_args, fo, ddp))
        m_refs[ddp] = (got, ref)
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
            check(ddp_bar(got, ref), "f64 FDDP ddp kernel outside the DDP engines' bar")
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
    # the streamed FDDP kernel: Gauss-Newton lane for lane with plain and
    # with fddp.cu, exact DDP at the DDP bar, two resumed launches = one
    for ddp in (False, True):
        got_w, ref = m_refs[ddp]
        got_s = ksf.solve_fddp_streamed(*m_args, fo, ddp=ddp)
        torch.cuda.synchronize()
        ok_p, rel_p, du_p = twins(got_s, ref, 1e-8, 1e-7)
        ok_w, rel_w, du_w = twins(got_s, got_w)
        bits = bit_equal(got_s, got_w)
        if not ddp:
            err["stream_fddp"] = du_p
            log(f"f64 streamed FDDP Gauss-Newton vs plain: lane for lane {ok_p} (max rel cost "
                f"{rel_p:.3e}, max |du| {du_p:.3e}; rtol 1e-8, atol 1e-7); vs fddp.cu {ok_w} "
                f"({rel_w:.3e}, {du_w:.3e}; rtol 1e-12, atol 1e-10), bit-equal {bits}")
            check(ok_p and ok_w, "f64 streamed FDDP kernel disagrees with plain or fddp.cu")
        else:
            bar = ddp_bar(got_s, ref)
            log(f"f64 streamed FDDP exact DDP vs plain: within the DDP engines' bar {bar} (max rel "
                f"cost {rel_p:.3e}); vs fddp.cu lane for lane {ok_w} ({rel_w:.3e}, {du_w:.3e}), "
                f"bit-equal {bits}")
            check(bar, "f64 streamed FDDP ddp kernel outside the DDP engines' bar")
    one = ksf.solve_fddp_streamed(*m_args, fo)
    first = ksf.solve_fddp_streamed(*m_args[:4], _with_max_iters(m_opts, 7), fo, return_mu=True)
    two = ksf.solve_fddp_streamed(
        m_params, m_cost, first[0], mix_dt, _with_max_iters(m_opts, 18), fo,
        initial_mu=first[4], initial_status=first[3], initial_iters=first[2],
    )
    torch.cuda.synchronize()
    exact = bit_equal(two, one)
    log(f"f64 streamed FDDP two launches (boundary 7) vs one: bit-equal {exact}")
    check(exact, "the two-launch streamed FDDP solve differs from one launch")
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
    got_s = kst.solve_fused_streamed(b_params, b_cost, trajs, DT, bench_opts)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got_s[1]).all() and torch.isfinite(got_s[0].controls).all())
    agree = float((got_s[3] == ref[3]).float().mean())
    med = float(((got_s[1] - ref[1]).abs() / ref[1].abs()).median())
    twin = float(((got_s[3] == got[3]) & (got_s[2] == got[2])).float().mean())
    log(f"f32 streamed solve vs plain: finite {finite}, status agreement {agree:.4f} (>= 0.99), "
        f"median rel cost diff {med:.3e} (< 1e-3); lanes equal to solve.cu in status and "
        f"iterations {twin:.4f}")
    check(finite and agree >= 0.99 and med < 1e-3, "f32 streamed kernel outside its bounds")

    # ---- 5. the exact main path through the public API, counted ----
    reset_counts()
    res_whole = api.solve_batch(trajs, latency=True)
    res_loop = api.solve_batch(trajs, fused=True)
    torch.cuda.synchronize()
    launches = counts()
    log(f"exact main path launches: {launches}")
    check(all(launches[k] > 0 for k in ("backward", "rollout", "solve")),
          f"a kernel of the path never ran: {launches}")
    routes = float((res_whole.status == res_loop.status).float().mean())
    log(f"bench workload: the whole-solve and per-pass routes agree on {routes:.4f} of statuses "
        f"(>= 0.99)")
    check(routes >= 0.99, "the whole-solve and per-pass routes disagree on the bench workload")
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
        f"B={r_batch}, N={r_n}): converged {r_conv:.4f} (>= 0.97, within 0.01 of 0.9849), "
        f"mean iterations "
        f"{float(res_robust.iterations.float().mean()):.3f}, statuses "
        f"{torch.bincount(res_robust.status, minlength=3).tolist()}")
    # the converged fraction of the per-thread kernels on this path (0.9849,
    # PERF.md): the team kernels compute the same lanes
    check(r_conv >= 0.97 and abs(r_conv - 0.9849) <= 0.01,
          "robust path: converged fraction below 0.97 or more than 1 point from 0.9849")

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
    # the streamed FDDP kernel on the same two launches, inputs and resume
    # rows, against the same plain results
    gn_s = ksf.solve_fddp_streamed(*rp_args, r_trajs, r_dt, gn_opts, r_fo, return_mu=True,
                                   return_probes=True)
    ddp_s = ksf.solve_fddp_streamed(*rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True,
                                    return_mu=True, return_probes=True, **rows)
    torch.cuda.synchronize()
    for name, k_out, p_out, w_out, lanes in (
        ("Gauss-Newton", gn_s, gn_p, gn_k, torch.ones_like(live)), ("exact-DDP", ddp_s, ddp_p, ddp_k, live)
    ):
        finite = bool(torch.isfinite(k_out[1]).all() and torch.isfinite(k_out[0].controls).all())
        med = float(((k_out[1] - p_out[1]).abs() / p_out[1].abs())[lanes].median())
        twin = float(((k_out[3] == w_out[3]) & (k_out[2] == w_out[2])).float().mean())
        log(f"f32 streamed FDDP {name} launch vs plain loop on the same rows: finite {finite}, "
            f"converged {conv_of(k_out):.4f} vs {conv_of(p_out):.4f} (within 0.01), status "
            f"agreement {float((k_out[3] == p_out[3]).float().mean()):.4f}, median rel cost diff "
            f"{med:.3e} (< 1e-3); lanes equal to fddp.cu in status and iterations {twin:.4f}")
        check(finite and abs(conv_of(k_out) - conv_of(p_out)) <= 0.01 and med < 1e-3,
              f"f32 streamed FDDP {name} launch outside its bounds")
    c6_stream_work = [
        (int((k[2] - (0 if base is None else base[2])).sum()), float(k[5].sum()), int(k[6].sum()),
         int(k[7].sum()))
        for k, base in ((gn_s, None), (ddp_s, gn_k))
    ]
    log(f"the streamed FDDP launches ran (trips, probe sweeps, defect trips, apply sweeps): "
        f"Gauss-Newton {c6_stream_work[0]}, exact DDP {c6_stream_work[1]}")
    # the single-phase kernel, for its convergence beside the schedule's
    single = kf.solve_fddp_fused(*r_args)
    torch.cuda.synchronize()
    log(f"f32 single-phase FDDP kernel (Gauss-Newton, 40 trips): converged {conv_of(single):.4f}, "
        f"mean iterations {float(single[2].float().mean()):.3f}")

    # ---- 5c. the long-horizon paths at full width, counted ----
    def api_for(params, cost, trajs, opts, **kw):
        desired = ilqr.Trajectory(
            times=trajs.times[0], states=cost.desired_states, controls=cost.desired_controls
        )
        return QuadrotorILQR(
            float(params.mass_kg), params.inertia, float(params.arm_length_m),
            float(params.torque_to_thrust_ratio_m), float(params.g_mpss), cost.Q, cost.R,
            desired, DT, opts, dtype=torch.float32, device=dev, **kw,
        )

    def finite_result(res, batch, n):
        t = res.trajectory
        return (res.cost.shape == (batch,) and t.controls.shape == (batch, n, 4) and all(
            bool(torch.isfinite(a).all())
            for a in (res.cost, t.controls, t.states.pose.quat, t.states.pose.trans, t.states.vel)
        ))

    lh_batch, lh_n, rl_n = 4096, 1024, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    lh_params, lh_cost, lh_trajs = workloads.long_horizon_problem(
        gen, lh_batch, lh_n, torch.float32, DT, dev
    )
    lh_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10))
    long_api = api_for(lh_params, lh_cost, lh_trajs, lh_opts)
    reset_counts()
    res_long = long_api.solve_batch(lh_trajs, latency=True)
    torch.cuda.synchronize()
    long_launches = counts()
    lh_args = (long_api.params, long_api.cost, lh_trajs, DT, lh_opts)
    whole_long = ks.solve_fused_whole(*lh_args)
    stream_long = kst.solve_fused_streamed(*lh_args, return_probes=True)
    torch.cuda.synchronize()
    conv_long = float((res_long.status == ilqr.STATUS_CONVERGED).float().mean())
    conv_whole = conv_of(whole_long)
    log(f"long-horizon exact path launches: {long_launches}")
    log(f"long horizon via QuadrotorILQR.solve_batch(latency=True) (f32, B={lh_batch}, N={lh_n}): "
        f"converged {conv_long:.4f} (>= 0.97), mean iterations "
        f"{float(res_long.iterations.float().mean()):.3f}, statuses "
        f"{torch.bincount(res_long.status, minlength=3).tolist()}; solve.cu on the same inputs "
        f"converged {conv_whole:.4f} (within 0.01), lanes equal in status and iterations "
        f"{float(((res_long.status == whole_long[3]) & (res_long.iterations == whole_long[2])).float().mean()):.4f}")
    check(long_launches["stream"] == 1 and long_launches["solve"] == 0,
          f"the long exact path did not run stream.cu once: {long_launches}")
    check(finite_result(res_long, lh_batch, lh_n), "long exact path: wrong shapes or non-finite")
    check(conv_long >= 0.97 and abs(conv_long - conv_whole) <= 0.01,
          "long exact path: convergence outside its bounds")
    check(bit_equal(stream_long, res_long), "the long exact path differs from its stream.cu launch")
    long_work = [int(a.sum()) for a in stream_long[4:]]
    log(f"stream.cu ran (backward passes, probe sweeps, apply sweeps): {long_work}")
    # stream.cu against its plain version, the streamed plain loop, on the
    # path's inputs and options for the path's first LONG_PLAIN_TRIPS trips
    lp_opts = _with_max_iters(lh_opts, LONG_PLAIN_TRIPS)
    lp_args = lh_args[:4] + (lp_opts,)
    lp_k = kst.solve_fused_streamed(*lp_args, return_probes=True)
    lp_p, plain_long_ms = time_once(lambda: kst.solve_streamed_reference(*lp_args))
    torch.cuda.synchronize()
    # Cut at a trip budget, a lane whose convergence test falls on the last
    # trip may end CONVERGED in one engine and still pending in the other:
    # at N=1024 the f32 cost sums differ by about the 1e-6 tolerance. Such a
    # lane's cost moves by less than the tolerance, so the bar is on each
    # lane's cost: 99% of lanes within 1e-3, the median far below
    finite = bool(torch.isfinite(lp_k[1]).all() and torch.isfinite(lp_k[0].controls).all())
    rel = (lp_k[1] - lp_p[1]).abs() / lp_p[1].abs()
    med, q99 = float(rel.median()), float(rel.quantile(0.99))
    du = max_abs(lp_k[0].controls, lp_p[0].controls) / float(lp_p[0].controls.abs().max())
    long_plain_work = [int(a.sum()) for a in lp_k[4:]]
    log(f"f32 stream.cu vs its plain loop on the long exact path's inputs (B={lh_batch}, "
        f"N={lh_n}, its first {LONG_PLAIN_TRIPS} trips): finite {finite}, rel cost diff median "
        f"{med:.3e} (< 1e-3), 99th percentile {q99:.3e} (< 1e-3), max |du| / max |u| {du:.3e}; "
        f"status agreement {float((lp_k[3] == lp_p[3]).float().mean()):.4f}, converged "
        f"{conv_of(lp_k):.4f} vs {conv_of(lp_p):.4f}, lanes equal in status and iterations "
        f"{float(((lp_k[3] == lp_p[3]) & (lp_k[2] == lp_p[2])).float().mean()):.4f}; "
        f"(backward passes, probe sweeps, apply sweeps) kernel {long_plain_work}, plain "
        f"{[int(a.sum()) for a in lp_p[4:]]}; plain loop {plain_long_ms:.1f} ms")
    check(finite and med < 1e-3 and q99 < 1e-3, "f32 stream.cu outside its bounds at N=1024")

    gen = torch.Generator(device=dev).manual_seed(1)
    rl_params, rl_cost, rl_trajs = workloads.long_horizon_problem(
        gen, lh_batch, rl_n, torch.float32, DT, dev
    )
    rl_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 12))
    robust_long = api_for(rl_params, rl_cost, rl_trajs, rl_opts, solver="fddp")
    reset_counts()
    res_rl = robust_long.solve_batch(rl_trajs)
    torch.cuda.synchronize()
    rl_launches = counts()
    rl_bounds, rl_flags = resolve_refine_auto(12, False)
    rl_switch = ((0,) + rl_bounds)[rl_flags.index(True)]
    rl_p = (robust_long.params, robust_long.cost)
    rl_gn, rl_ddp = _with_max_iters(rl_opts, rl_switch), _with_max_iters(rl_opts, 12 - rl_switch)

    def two_launches(solve, **kw):
        first = solve(*rl_p, rl_trajs, DT, rl_gn, r_fo, return_mu=True, **kw)
        second = solve(*rl_p, first[0], DT, rl_ddp, r_fo, ddp=True, return_mu=True,
                       initial_mu=first[4], initial_status=first[3], initial_iters=first[2], **kw)
        return first, second

    sl_gn, sl_ddp = two_launches(ksf.solve_fddp_streamed, return_probes=True)
    wl_gn, wl_ddp = two_launches(kf.solve_fddp_fused)
    torch.cuda.synchronize()
    conv_rl = float((res_rl.status == ilqr.STATUS_CONVERGED).float().mean())
    conv_wl = conv_of(wl_ddp)
    log(f"long-horizon robust path launches: {rl_launches} (Gauss-Newton trips 0-{rl_switch}, "
        f"exact DDP {rl_switch}-12)")
    log(f"long horizon via QuadrotorILQR(solver='fddp').solve_batch (refine auto, f32, B={lh_batch}, "
        f"N={rl_n}): converged {conv_rl:.4f} (expected > 0.90), mean iterations "
        f"{float(res_rl.iterations.float().mean()):.3f}, statuses "
        f"{torch.bincount(res_rl.status, minlength=3).tolist()}; the same two launches on fddp.cu "
        f"converged {conv_wl:.4f} (within 0.01), lanes equal in status and iterations "
        f"{float(((res_rl.status == wl_ddp[3]) & (res_rl.iterations == wl_ddp[2])).float().mean()):.4f}")
    check(rl_launches["stream_fddp"] == 2 and rl_launches["fddp"] == 0,
          f"the long robust path did not run stream_fddp.cu twice: {rl_launches}")
    check(finite_result(res_rl, lh_batch, rl_n), "long robust path: wrong shapes or non-finite")
    check(abs(conv_rl - conv_wl) <= 0.01, "long robust path: convergence outside its bounds")
    check(bit_equal(sl_ddp, res_rl), "the long robust path differs from its two launches")
    long_fddp_work = [
        (int((k[2] - (0 if base is None else base[2])).sum()), float(k[5].sum()), int(k[6].sum()),
         int(k[7].sum()))
        for k, base in ((sl_gn, None), (sl_ddp, sl_gn))
    ]
    log(f"stream_fddp.cu ran (trips, probe sweeps, defect trips, apply sweeps): Gauss-Newton "
        f"{long_fddp_work[0]}, exact DDP {long_fddp_work[1]}")
    # stream_fddp.cu against the streamed plain FDDP loop on the path's
    # inputs for the first LONG_PLAIN_TRIPS trips of its Gauss-Newton launch,
    # with the same bar as stream.cu's
    lr_opts = _with_max_iters(rl_opts, LONG_PLAIN_TRIPS)
    lr_args = rl_p + (rl_trajs, DT, lr_opts, r_fo)
    rl_gk = ksf.solve_fddp_streamed(*lr_args, return_mu=True, return_probes=True)
    rl_gp, plain_rl_gn_ms = time_once(lambda: ksf.solve_fddp_streamed_reference(*lr_args))
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(rl_gk[1]).all() and torch.isfinite(rl_gk[0].controls).all())
    rel = (rl_gk[1] - rl_gp[1]).abs() / rl_gp[1].abs()
    med, q99 = float(rel.median()), float(rel.quantile(0.99))
    rl_plain_work = [(int(rl_gk[2].sum()), float(rl_gk[5].sum()), int(rl_gk[6].sum()),
                      int(rl_gk[7].sum()))]
    log(f"f32 stream_fddp.cu vs its plain loop on the long robust path's inputs (B={lh_batch}, "
        f"N={rl_n}, the first {LONG_PLAIN_TRIPS} Gauss-Newton trips): finite {finite}, rel cost "
        f"diff median {med:.3e} (< 1e-3), 99th percentile {q99:.3e} (< 1e-3); status agreement "
        f"{float((rl_gk[3] == rl_gp[3]).float().mean()):.4f}, lanes equal in status and iterations "
        f"{float(((rl_gk[3] == rl_gp[3]) & (rl_gk[2] == rl_gp[2])).float().mean()):.4f}; "
        f"(trips, probe sweeps, defect trips, apply sweeps) kernel {rl_plain_work[0]}, plain "
        f"{(int(rl_gp[2].sum()), float(rl_gp[5].sum()), int(rl_gp[6].sum()), int(rl_gp[7].sum()))}; "
        f"plain loop {plain_rl_gn_ms:.1f} ms")
    check(finite and med < 1e-3 and q99 < 1e-3,
          "f32 stream_fddp.cu outside its bounds at N=512")

    # ---- 5d. BASELINE config 1 on the card against the C++ oracle, float64 ----
    # the reference demo (quadrotor_ilqr.py): the climbing square, N=40 at
    # dt 0.1, the demo vehicle and weights, rtol = atol = 1e-12, 100
    # iterations, line search (0.5, 0.5, 100), solved from the desired
    # trajectory; the reference-parity path: the plain loop with the debug
    # record (solve(proto), which runs solve_pytree) and solve.cu recording
    # its cost history (solve_batch(latency=True) at B=1)
    t_c1 = time.perf_counter()
    c1_dt, c1_ls, c1_cc = 0.1, (0.5, 0.5, 100), (1e-12, 1e-12, 100)
    c1_desired = workloads.demo_desired_trajectory(c1_dt)
    c1_q, c1_r = workloads.demo_weights()
    c1_opts = ILQROptions(LineSearchParams(*c1_ls), ConvergenceCriteria(*c1_cc),
                          populate_debug=True)
    c1_api = QuadrotorILQR(1.0, torch.eye(3), 1.0, 0.0, 9.81, c1_q, c1_r, c1_desired, c1_dt,
                           c1_opts, device=dev)
    c1_np = [a.numpy() for a in (c1_desired.states.pose.quat, c1_desired.states.pose.trans,
                                 c1_desired.states.vel, c1_desired.controls)]
    o_status, o_iters, o_cost, o_controls = oracle_solve(
        oracle, (1.0, torch.eye(3).double().numpy(), 1.0, 0.0, 9.81), c1_q.numpy(), c1_r.numpy(),
        c1_np, c1_np, c1_dt, c1_ls, c1_cc,
    )
    log(f"config 1, C++ oracle: status {o_status}, {o_iters} iterations, cost {o_cost!r}")
    check(o_status == 1, "the C++ oracle did not converge on config 1")
    o_controls = torch.as_tensor(o_controls, device=dev)
    # the plain loop runs once: through solve(proto), the reference binding's
    # call, which runs solve_pytree (its result kept here), where protobuf
    # is installed; through solve_pytree alone where it is not
    with_protos = importlib.util.find_spec("google.protobuf") is not None
    reset_counts()
    if with_protos:
        from quadrotorilqr_tpu_torch import io as qio

        kept = []
        solve_pytree = c1_api.solve_pytree
        c1_api.solve_pytree = lambda t: kept.append(solve_pytree(t)) or kept[-1]
        (traj_msg, debug_msg), c1_plain_ms = time_once(
            lambda: c1_api.solve(qio.trajectory_to_proto(c1_desired)))
        c1_plain = kept[0]
    else:
        c1_plain, c1_plain_ms = time_once(lambda: c1_api.solve_pytree(c1_desired))
    torch.cuda.synchronize()
    c1_plain_counts = counts()
    c1_batch = tree_map(lambda a: a[None], c1_api.desired_traj)
    reset_counts()
    c1_kernel, c1_kernel_ms = time_once(lambda: c1_api.solve_batch(c1_batch, latency=True))
    torch.cuda.synchronize()
    c1_launches = counts()
    log(f"config 1 launches: plain loop {c1_plain_counts}, solve_batch(latency=True) "
        f"{c1_launches}")
    check(not any(c1_plain_counts.values()) and c1_launches["solve"] == 1
          and sum(c1_launches.values()) == 1,
          f"config 1 did not run the plain loop, then solve.cu once: {c1_launches}")
    c1_results = (("QuadrotorILQR.solve (plain loop)" if with_protos else
                   "QuadrotorILQR.solve_pytree (plain loop)", c1_plain, c1_plain_ms),
                  ("solve_batch(latency=True) (solve.cu)", tree_map(lambda a: a[0], c1_kernel),
                   c1_kernel_ms))
    for name, res, res_ms in c1_results:
        du = max_abs(res.trajectory.controls, o_controls)
        rel = abs(float(res.cost) - o_cost) / abs(o_cost)
        log(f"config 1 via {name} on the card: status {int(res.status)}, {int(res.iterations)} "
            f"iterations (oracle {o_iters}), max |du| against the oracle {du:.3e} (<= 1e-5), rel "
            f"cost {rel:.3e} (<= 1e-8), {res_ms:.1f} ms {card}")
        check(int(res.status) == 1 and int(res.iterations) == o_iters and du <= 1e-5
              and rel <= 1e-8, f"config 1 via {name} disagrees with the C++ oracle")
    hist, full = c1_kernel.debug, c1_plain.debug
    same_valid = bool((hist.valid[0] == full.valid).all())
    hist_rel = float(((hist.costs[0] - full.costs).abs() / full.costs.abs())[full.valid].max())
    log(f"config 1: solve.cu's cost history against the plain loop's debug record: "
        f"{int(full.valid.sum())} valid slots, the same slots {same_valid}, max rel cost "
        f"{hist_rel:.3e} (rtol 1e-8); status and iterations equal "
        f"{int(c1_plain.status) == int(c1_kernel.status[0])}")
    check(same_valid and hist_rel <= 1e-8 and type(hist).__name__ == "CostHistory"
          and int(c1_plain.status) == int(c1_kernel.status[0])
          and int(c1_plain.iterations) == int(c1_kernel.iterations[0]),
          "config 1: solve.cu's history disagrees with the plain loop's debug record")
    if not with_protos:
        log("config 1 through QuadrotorILQR.solve(proto): not run, google.protobuf is not "
            "installed")
    else:
        got_traj = qio.trajectory_from_proto(traj_msg, device=dev)
        du = max_abs(got_traj.controls, o_controls)
        same = bool((got_traj.controls == c1_plain.trajectory.controls).all())
        log(f"config 1 through QuadrotorILQR.solve(proto): {len(debug_msg.iter_debugs)} debug "
            f"entries (one per iteration: {o_iters}), max |du| against the oracle {du:.3e}, the "
            f"proto's controls equal to solve_pytree's {same}")
        check(len(debug_msg.iter_debugs) == o_iters and du <= 1e-5 and same,
              "config 1 through solve(proto) disagrees with the C++ oracle")
    log(f"config 1 phase took {time.perf_counter() - t_c1:.1f} s")

    # ---- 5e. BASELINE config 3 at full size, float32 ----
    # the figure eight with per-scenario Q (U(0.5, 2) x the demo Q) and R,
    # B=4096, N=200, dt 0.02, initial poses Exp(0.2 N(0, I_6)), the
    # benchmark's vehicle and options (benchmarks/run_all.py config 3)
    t_c3 = time.perf_counter()
    c3_batch, c3_n = 4096, 200
    c3_params, c3_cost, c3_trajs = workloads.figure_eight_problem(
        np.random.default_rng(3), c3_batch, c3_n, DT, torch.float32, dev
    )
    c3_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10))
    c3_api = api_for(c3_params, c3_cost, c3_trajs, c3_opts)
    reset_counts()
    res3_whole = c3_api.solve_batch(c3_trajs, latency=True)
    res3_loop = c3_api.solve_batch(c3_trajs, fused=True)
    torch.cuda.synchronize()
    c3_launches = counts()
    c3_agree = float((res3_whole.status == res3_loop.status).float().mean())
    log(f"config 3 launches: {c3_launches}")
    for name, res in (("solve.cu", res3_whole), ("the per-pass route", res3_loop)):
        log(f"config 3 via {name} (f32, B={c3_batch}, N={c3_n}, per-scenario Q/R): converged "
            f"{float((res.status == ilqr.STATUS_CONVERGED).float().mean()):.4f}, mean iterations "
            f"{float(res.iterations.float().mean()):.3f}, statuses "
            f"{torch.bincount(res.status, minlength=3).tolist()}")
        check(finite_result(res, c3_batch, c3_n), f"config 3 via {name}: wrong shapes or non-finite")
    log(f"config 3: the two exact routes agree on {c3_agree:.4f} of statuses (>= 0.99)")
    check(c3_launches["solve"] == 1 and c3_launches["backward"] > 0 and c3_launches["rollout"] > 0,
          f"config 3 did not run both exact routes: {c3_launches}")
    check(c3_agree >= 0.99, "config 3: the two exact routes disagree")
    log(f"config 3 phase took {time.perf_counter() - t_c3:.1f} s")

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
    ms["loop"] = time_ms(lambda: api.solve_batch(trajs, fused=True))
    ms["plain"] = plain_solve_ms
    for key, label in (("solve", "whole-solve kernel"),
                       ("loop", "per-pass route (QuadrotorILQR.solve_batch(fused=True))"),
                       ("plain", "plain PyTorch loop")):
        log(f"{label}: {ms[key]:.3f} ms per batch solve, {batch / ms[key] * 1e3:.1f} solves/s "
            f"(B={batch}, N={horizon}, f32) {card}")

    def launch_ms(fn, entry, repeats=5):
        """The `entry` kernel's launches alone in a call of fn: CUDA events
        around each _build.launch, not the wrapper's operand preparation;
        1 warm-up, median of `repeats` calls."""
        real = _build.launch
        spans = []

        def timed(name, *args):
            if name != entry:
                return real(name, *args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            real(name, *args)
            end.record()
            spans.append((start, end))

        _build.launch = timed
        try:
            times = []
            for _ in range(repeats + 1):
                spans.clear()
                fn()
                torch.cuda.synchronize()
                times.append(sum(a.elapsed_time(b) for a, b in spans))
        finally:
            _build.launch = real
        return statistics.median(times[1:])

    # the per-pass kernels on the gains in the layout the per-pass route
    # hands over (backward_pass_fused's, so the rollout wrapper re-lays
    # nothing): the launch alone as the kernel's time, the call beside it
    k1, big_k1, _, _ = kb.backward_pass_fused(b_params, b_cost, trajs1, DT)

    def bwd_call():
        return kb.backward_pass_fused(b_params, b_cost, trajs1, DT)

    def roll_call():
        return kr.rollout_cost_fused(b_params, b_cost, trajs1, k1, big_k1, ones, DT)

    call_ms = {"backward": time_ms(bwd_call), "rollout": time_ms(roll_call)}
    per_kernel = {
        "backward": (
            launch_ms(bwd_call, "qilqr_backward"),
            time_ms(lambda: kb.backward_pass_reference(b_params, b_cost, trajs1, DT)),
        ),
        "rollout": (
            launch_ms(roll_call, "qilqr_rollout"),
            time_ms(
                lambda: kr.rollout_cost_reference(b_params, b_cost, trajs1, k1, big_k1, ones, DT)
            ),
        ),
        "solve": (ms["solve"], ms["plain"]),
    }
    for name in ("backward", "rollout"):
        log(f"{name} kernel launch alone {per_kernel[name][0]:.3f} ms, the wrapper call "
            f"{call_ms[name]:.3f} ms (B={batch}, N={horizon}, f32) {card}")
    # the FDDP kernel's time on the main path: its two launches, each timed
    ms["fddp_gn"] = time_ms(lambda: kf.solve_fddp_fused(*rp_args, r_trajs, r_dt, gn_opts, r_fo))
    ms["fddp_ddp"] = time_ms(lambda: kf.solve_fddp_fused(
        *rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
    per_kernel["fddp"] = (ms["fddp_gn"] + ms["fddp_ddp"], plain_gn_ms + plain_ddp_ms)
    # the streamed kernels on the main path's inputs, in the calls held
    # against their plain versions: the first LONG_PLAIN_TRIPS trips at
    # N=1024 and N=512
    per_kernel["stream"] = (time_ms(lambda: kst.solve_fused_streamed(*lp_args)), plain_long_ms)
    per_kernel["stream_fddp"] = (time_ms(lambda: ksf.solve_fddp_streamed(*lr_args)), plain_rl_gn_ms)
    shapes = {"fddp": (r_batch, r_n), "stream": (lh_batch, lh_n), "stream_fddp": (lh_batch, rl_n)}
    for name, (k_ms, p_ms) in per_kernel.items():
        b_, n_ = shapes.get(name, (batch, horizon))
        log(f"{name} kernel: {k_ms:.3f} ms, plain {p_ms:.3f} ms (B={b_}, N={n_}, f32) {card}")
    log(f"fddp launches: Gauss-Newton trips 0-{switch} {ms['fddp_gn']:.3f} ms (plain "
        f"{plain_gn_ms:.3f} ms), exact DDP trips {switch}-40 {ms['fddp_ddp']:.3f} ms (plain "
        f"{plain_ddp_ms:.3f} ms) {card}")
    # the streamed kernels beside their twins at the twins' shapes
    ms["stream_bench"] = time_ms(lambda: kst.solve_fused_streamed(*solve_args))
    ms["stream_fddp_gn"] = time_ms(
        lambda: ksf.solve_fddp_streamed(*rp_args, r_trajs, r_dt, gn_opts, r_fo))
    ms["stream_fddp_ddp"] = time_ms(lambda: ksf.solve_fddp_streamed(
        *rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
    # solve.cu against stream.cu on the bench workload's class at three
    # horizons, for the exact route point (256)
    route = {}
    for n_ in (50, 100, 256):
        if n_ == horizon:
            h_args = solve_args
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            x0_n, des_n = workloads.hover_to_waypoint(
                gen, batch, n=n_, dt_s=DT, dtype=torch.float32, pose_scale=0.3, device=dev
            )
            api_n = QuadrotorILQR(1.0, torch.eye(3), 0.2, 0.016, 9.81, q_w, r_w, des_n, DT,
                                  bench_opts, dtype=torch.float32, device=dev)
            h_args = (api_n.params, api_n.cost, initial_trajectory_from_state(x0_n, des_n), DT,
                      bench_opts)
        route[n_] = (time_ms(lambda: ks.solve_fused_whole(*h_args)),
                     time_ms(lambda: kst.solve_fused_streamed(*h_args)))
        log(f"bench workload class at N={n_}: solve.cu {route[n_][0]:.3f} ms, stream.cu "
            f"{route[n_][1]:.3f} ms (B={batch}, f32) {card}")
    log(f"stream.cu on the bench workload {ms['stream_bench']:.3f} ms (solve.cu {ms['solve']:.3f}); "
        f"stream_fddp.cu on config 6's launches: Gauss-Newton {ms['stream_fddp_gn']:.3f} ms, exact "
        f"DDP {ms['stream_fddp_ddp']:.3f} ms (fddp.cu {ms['fddp_gn']:.3f}, {ms['fddp_ddp']:.3f}) "
        f"{card}")
    # the debug routes at the bench workload: solve.cu recording its history
    # and counts beside the launch without; the per-pass route with the
    # debug record (every trip's trajectory kept), with its peak memory
    ms["solve_record"] = time_ms(lambda: ks.solve_fused_whole(
        *solve_args, return_history=True, return_probes=True))
    debug_opts = dataclasses.replace(bench_opts, populate_debug=True)
    reset_counts()
    res_debug = solve_batch_fused(b_params, b_cost, trajs, DT, debug_opts)
    torch.cuda.synchronize()
    debug_launches = counts()
    log(f"per-pass route with the debug record, launches: {debug_launches}; "
        f"{int(res_debug.debug.valid.sum())} snapshots, as many as iterations "
        f"{int(res_debug.debug.valid.sum()) == int(res_debug.iterations.sum())}; bit-equal to the "
        f"route without {bit_equal(res_debug, res_loop)}")
    check(debug_launches["backward"] > 0 and debug_launches["rollout"] > 0
          and bit_equal(res_debug, res_loop), "the per-pass debug route did not run its kernels "
          "or differs from the route without the record")
    del res_debug
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms["loop_debug"] = time_ms(lambda: solve_batch_fused(b_params, b_cost, trajs, DT, debug_opts))
    peak_mb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e6
    torch.cuda.reset_peak_memory_stats()
    time_ms(lambda: api.solve_batch(trajs, fused=True), repeats=1)
    peak_plain_mb = (torch.cuda.max_memory_allocated() - base_bytes) / 1e6
    log(f"solve.cu with history and counts {ms['solve_record']:.3f} ms, without {ms['solve']:.3f} "
        f"ms; per-pass route with the debug record {ms['loop_debug']:.3f} ms, without "
        f"{ms['loop']:.3f} ms; peak memory above the inputs {peak_mb:.1f} MB with the record, "
        f"{peak_plain_mb:.1f} MB without (B={batch}, N={horizon}, f32) {card}")
    # BASELINE config 3 through both exact routes
    ms["c3_solve"] = time_ms(lambda: c3_api.solve_batch(c3_trajs, latency=True))
    ms["c3_loop"] = time_ms(lambda: c3_api.solve_batch(c3_trajs, fused=True))
    log(f"config 3 (B={c3_batch}, N={c3_n}, f32, per-scenario Q/R): solve.cu {ms['c3_solve']:.3f} "
        f"ms per batch solve, {c3_batch / ms['c3_solve'] * 1e3:.1f} solves/s; per-pass route "
        f"{ms['c3_loop']:.3f} ms {card}")
    ms_robust = time_ms(lambda: robust.solve_batch(r_trajs))
    ms_single = time_ms(lambda: kf.solve_fddp_fused(*r_args))
    log(f"robust path (refine auto, 2 FDDP launches): {ms_robust:.3f} ms per batch solve, "
        f"{r_batch / ms_robust * 1e3:.1f} solves/s; single-phase kernel {ms_single:.3f} ms "
        f"(B={r_batch}, N={r_n}, f32) {card}")
    # the long-horizon paths at full width, each beside its whole-solve twin
    # on the same inputs
    full = {
        "stream": (time_ms(lambda: long_api.solve_batch(lh_trajs, latency=True)),
                   time_ms(lambda: ks.solve_fused_whole(*lh_args)), lh_n),
        "stream_fddp": (time_ms(lambda: robust_long.solve_batch(rl_trajs)),
                        time_ms(lambda: two_launches(kf.solve_fddp_fused)), rl_n),
    }
    for name, twin in (("stream", "solve.cu"), ("stream_fddp", "fddp.cu, the same two launches")):
        k_ms, w_ms, n_ = full[name]
        log(f"long horizon {name}.cu path: {k_ms:.3f} ms per batch solve, "
            f"{lh_batch / k_ms * 1e3:.1f} solves/s; {twin} {w_ms:.3f} ms (B={lh_batch}, N={n_}, "
            f"f32) {card}")

    # ---- 7. bounds: the work this run's inputs needed ----
    f = FLOPS
    word = 4  # float32
    stage = batch * horizon
    # solve.cu's work as it reports it on the main path's inputs: every
    # backward pass and every probe sweep of every lane (its recorded launch
    # leaves the main path's bits)
    rec = ks.solve_fused_whole(*solve_args, return_probes=True)
    torch.cuda.synchronize()
    check(bit_equal(rec, res_whole), "solve.cu's counting launch differs from the main path's")
    solve_work = (int(rec[4].sum()), int(rec[5].sum()))
    log(f"solve.cu ran (backward passes, probe sweeps) on the bench workload: {solve_work}; the "
        f"slowest lane {int(rec[4].max())}, {int(rec[5].max())}")

    def stream_work(n, b_, passes, probes, applies):
        """stream.cu: every backward pass, probe sweep and apply sweep."""
        return ((passes * f["riccati"] + (probes + applies) * f["rollout"]) * n,
                2 * 17 * b_ * n * word + 6 * b_ * word)

    def fddp_work(n, b_, launches, outputs):
        """An FDDP launch pair: every trip transports the gradient and runs
        the Riccati stage and the model terms (the exact-DDP launch with its
        additions); defects only on the trips that computed them; every
        probe and apply sweep; the seed cost once."""
        flops = sum(
            n * (trips * (f["transport"] + f["riccati"] + extra + f["model"])
                 + defect_trips * f["defect"] + (sweeps + applies) * f["gap_rollout"])
            for (trips, sweeps, defect_trips, applies), extra in zip(launches, (0, f["ddp_extra"]))
        ) + b_ * n * f["stage_cost"]
        return flops, 2 * 17 * b_ * n * word + outputs * b_ * word

    work = {
        "backward": (stage * f["riccati"], (17 + 52) * stage * word + 2 * batch * word),
        "rollout": (stage * f["rollout"], (17 + 52 + 17) * stage * word + 2 * batch * word),
        "solve": ((solve_work[0] * f["riccati"] + solve_work[1] * f["rollout"]) * horizon,
                  2 * 17 * stage * word + 3 * batch * word),
        "fddp": fddp_work(r_n, r_batch, [work_gn + (0,), work_ddp + (0,)], 6),
        "stream": stream_work(lh_n, lh_batch, *long_plain_work),
        "stream_fddp": fddp_work(rl_n, lh_batch, rl_plain_work, 7),
    }
    full_work = {
        "stream": stream_work(lh_n, lh_batch, *long_work),
        "stream_fddp": fddp_work(rl_n, lh_batch, long_fddp_work, 7),
    }

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    bounds = {name: bound(*w) for name, w in work.items()}
    full_bounds = {name: bound(*w) for name, w in full_work.items()}
    for name, (flops, nbytes) in work.items():
        log(f"{name} bound: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB -> "
            f"{bounds[name][0]:.4f} ms ({bounds[name][1]}); measured {per_kernel[name][0]:.3f} ms")
    for name, (flops, nbytes) in full_work.items():
        log(f"{name} bound at full width (N={full[name][2]}): {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB -> {full_bounds[name][0]:.4f} ms ({full_bounds[name][1]}); "
            f"measured {full[name][0]:.3f} ms")

    pkg = "quadrotorilqr_tpu_torch/kernels/csrc"
    replaces = {
        "backward": "quadrotorilqr_tpu/kernels/backward.py:594",
        "rollout": "quadrotorilqr_tpu/kernels/rollout.py:54",
        "solve": "quadrotorilqr_tpu/kernels/solve.py:159",
        "fddp": "quadrotorilqr_tpu/kernels/fddp.py:245",
        "stream": "quadrotorilqr_tpu/kernels/stream.py:120",
        "stream_fddp": "quadrotorilqr_tpu/kernels/stream_fddp.py:90",
    }
    launches["fddp"] = robust_launches["fddp"]
    launches["stream"] = long_launches["stream"]
    launches["stream_fddp"] = rl_launches["stream_fddp"]
    # no single PyTorch call computes a Riccati sweep, a closed-loop rollout
    # or a whole solve, so there is no library time to set beside them. ms,
    # plain_ms and bound_ms share their inputs and work: for the streamed
    # kernels the main path's calls held against plain (above), with the
    # whole path's time and bound beside them in `full_width`
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"{pkg}/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": per_kernel[name][0], "plain_ms": per_kernel[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
        }
        for name in ("backward", "rollout", "solve", "fddp", "stream", "stream_fddp")
    ]
    # the main paths' geometry: float32, Q/R and the model parameters shared
    for k in kernels:
        g = team[(k["name"], "float32", (0, 0))]
        k["team"] = {"lanes": g[0], "teams_per_block": g[1], "smem_bytes_per_block": g[3]}
    for k in kernels[:2]:
        k["call_ms"] = call_ms[k["name"]]
        k["route_ms"] = ms["loop"]
    kernels[2]["versus_stream_ms"] = {
        str(n_): {"solve": a, "stream": b} for n_, (a, b) in route.items()
    }
    kernels[2]["record_ms"] = ms["solve_record"]
    kernels[2]["work"] = {"backward_passes": solve_work[0], "probe_sweeps": solve_work[1]}
    kernels[2]["config1_launches"] = c1_launches["solve"]
    for k in kernels[4:]:
        k_ms, w_ms, n_ = full[k["name"]]
        k["full_width"] = {"B": lh_batch, "N": n_, "ms": k_ms, "whole_twin_ms": w_ms,
                           "bound_ms": full_bounds[k["name"]][0]}
    log(f"chip_smoke took {time.perf_counter() - T0:.1f} s")
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
