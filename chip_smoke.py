#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `quadrotorilqr_tpu_torch/kernels/csrc`,
holds each kernel against its plain PyTorch version on the card (float64
lane for lane at B=300, N=40, the FDDP kernels' exact DDP for its first
FDDP_DDP_PLAIN_TRIPS trips at the JAX package's DDP bar; float32 at the
main paths' shapes to quality bounds), each streamed kernel against its whole-solve twin, the per-pass
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
    against the plain FDDP loop on the same inputs and resume rows (the
    exact-DDP one for its first C6_DDP_PLAIN_TRIPS trips);
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

BASELINE config 4, receding-horizon MPC (phase 6b): the box and weights
variants of backward.cu, rollout.cu and solve.cu (control limits, stage
weights) against their plain versions in float64 at B=300, N=40 with
shared, per-scenario and wide bounds, their per-pass route against
solve.cu, unit weights against none; then `app.mpc.run_mpc` on config 4
(fleets 1, 32 and 128, H=50, dt 0.01, 100 ticks, f32) on both exact
routes: ms a tick, the chunk slope, mean iterations, host syncs a tick and
the host-driven `mpc_step` loop's per-tick p50, p99 and max; and at fleet
128 with rotor limits (0, 2.9) and the terminal weight 20, the slice's main
path, counted, with its quality checks and its first ticks against the
plain route; the variants' kernels timed at config 4's shapes.

The model families (phase 6c): each exact kernel's instantiation for the
SE(3) body wrench (u = 6) and the 6- and 8-rotor multirotors
(`backward.cu`, `rollout.cu`, `solve.cu`, `stream.cu`, each source built
once per family) against its plain version in float64 (B=300, N=40, per-
scenario params) lane for lane, `stream.cu` and the per-pass route
bit-equal to `solve.cu`, a 4-rotor multirotor bit-equal to the quadrotor;
`app/workloads.wrench_problem` and `hexarotor_problem` (6 and 8 rotors;
B=4096, N=100, float32) through both exact routes against the plain loop,
timed, with the per-pass kernels' launches timed; each family at N=512 on
`stream.cu` beside `solve.cu`, against its plain loop for LONG_PLAIN_TRIPS
trips; then the families' main path, counted: the three families through both exact
routes at N=100 and through `solve_batch_latency` at N=512 (past their
route points: `stream.cu`), each new instantiation launched at least once.

Control limits and stage weights on the robust and long paths (phase 6d):
the box, weights and both instantiations of `fddp.cu` and `stream_fddp.cu`
(Gauss-Newton and exact DDP) against the plain FDDP loop with the same
bounds and weights in float64 (B=300, N=40, the mixed benign and tumbling
problem, for their first VARIANT_GN_TRIPS / VARIANT_DDP_TRIPS trips; exact
DDP at the DDP engines' bar; a lane that ends on the same cost with other
bookkeeping, a tie, is held to its cost), `stream_fddp.cu` against
`fddp.cu`; `stream.cu`'s at B=128, N=300 against its plain loop and
bit-equal to `solve.cu`'s at N=256; then the main path at full width in float32,
counted by instantiation: `QuadrotorILQR(solver="fddp",
stage_weights=[1, ..., 1, 20])` on config 6, the long-horizon problem with
rotor limits (0, 1.3 x hover) and w_T = 20 (exact N=1024 on `stream.cu`,
robust N=512 on `stream_fddp.cu`), `run_mpc(solver="fddp")` on config 4
with its limits and terminal weight at fleets 32 and 128, and the tumbling
fleet of 128 (`workloads.tumble_mpc_problem`) through the robust and the
exact MPC loop; each launch against its plain loop for a trip budget,
every control in its box, the tumbling fleet's bars (the JAX package's
tests/test_mpc.py:154-189); the times (CUDA events, medians of 5; ms and
host syncs a tick and the `mpc_step` loop's p50, p99 and max for the MPC
run).

Output: progress lines (with each compiled kernel's and never-inlined
function's ptxas registers, spill stores and stack, and the team kernels'
geometry: lanes per scenario, teams per block, shared
bytes), the card's `nvidia-smi` name and power limit, a JSON line
`{"kernels": [...]}` with each kernel's launches, error and times (the
model families' instantiations as `backward_wrench`, ..., `stream_rotor8`;
the box and weights variants as `*_box_weights`, fddp.cu's weights variant
on config 6 as `fddp_weights`),
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
import warnings
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 0.02
# The streamed kernels are held against their plain loops on the long
# paths' inputs for the paths' first trips only (the first trip's full step
# and a line-searched trip with its apply sweep): at N=1024 a plain trip
# takes 15-20 s (a backward pass, a probe and an apply sweep), and a trip
# in which some lane's line search runs out adds 20 probe sweeps
LONG_PLAIN_TRIPS = 2
# The float64 FDDP kernels' exact-DDP curvature is held against the plain
# DDP loop for its first trips only: the plain loop's second-order terms
# take ~5 s a trip at B=300, N=40 (125 s for 25 trips on an H100 host)
FDDP_DDP_PLAIN_TRIPS = 6
# Config 6's exact-DDP launch (its trips 16-40) is held against the plain
# loop for its first trips only: the plain loop took 145-310 s for all 24
C6_DDP_PLAIN_TRIPS = 8

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
# The model families' stages (control width u, the nonzero entries of each
# j_u column): riccati_flops and rollout_flops below, 14,133 and 1,271 for
# the wrench (u = 6; 1 in each force column, 3 in each torque column),
# 14,589 and 1,310 for the hexarotor (u = 6, 4 in each column), 17,684 and
# 1,434 for the octorotor (u = 8, 4 in each column).
FLOPS = dict(
    riccati=12074, ddp_extra=6840, rollout=1202, gap_rollout=1412, model=696,
    defect=560, transport=288, stage_cost=566,
    box_extra=3592, weights_extra=188, rollout_box_extra=8, rollout_weights_extra=1,
    model_weights_extra=16,
)
# The box and weights variants (kBox, kW; counted from team.cuh the same way):
#   box: the box-QP gains (boxqp_gains: the clipped Newton step 78, four
#     projected-Newton iterations of 226, the feedback solve 566, the bounds
#     less the control 8) replace the Cholesky gains (460): +1096; the
#     general-gain value update (v_x 288, Q_xx 3456, with Quu K 336, the
#     symmetrization 288, Quu k 28 and the two dots 14: 4410) replaces the
#     simplified one (1914): +2496; 3592 in all;
#   weights: w times c_x (12), c_xx (144), 2R in c_u (16) and in Q_uu (16);
#   rollout: the clamp, 8 comparisons; the weight, 1 multiply a stage.
# The FDDP kernels' box and weights variants (the same pieces): a reverse
# stage is the gap transport 288 and the Riccati stage with both, 15,854
# (16,142); a probe stage 1,412 + 8 + 1 = 1,421; the probe-0 model terms
# 696 + 16 (w times 2R in L2's w'2R w: the weighted c_x and c_xx come with
# the recomputed cost diffs, not counted); the seed cost 566 + 1 a stage.
# BASELINE config 4 (benchmarks/mpc_device_loop.py): warm-started 50-step
# solves at 100 Hz, 100 ticks, fleets 1, 32 and 128; its constrained variant
# adds rotor limits (0, 2.9) N and the terminal weight 20.
MPC_FLEETS, MPC_TICKS, MPC_CHUNK, MPC_DT, MPC_HORIZON = (1, 32, 128), 100, 25, 0.01, 50
MPC_PLAIN_TICKS = 5


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
    the build's `-Xptxas -v` lines, named as `kernel<float, ddp, Quadrotor>`
    (the model family last): entry functions with their registers,
    never-inlined device functions with their spills and stack."""
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
        args = re.match(r"I([fd])((?:Lb[01]E)*)", mangled[i:])
        if not args:
            return name
        parts = ["float" if args.group(1) == "f" else "double"]
        bits = re.findall(r"Lb([01])E", args.group(2))
        # the bool template flags after the type, by function: solve_kernel
        # <T, kRecord, kBox, kW>, backward_kernel / rollout_kernel /
        # stream_kernel / team_rollout <T, kBox, kW>, the FDDP kernels and
        # pieces <T, kDdp, kBox, kW>
        box = (("box", "no box"), ("weights", "no weights"))
        if name.endswith("solve_kernel"):
            names = (("record", "no record"),) + box
        elif name.endswith(("backward_kernel", "rollout_kernel", "stream_kernel", "team_rollout")):
            names = box
        else:
            names = (("ddp", "gauss-newton"),) + box
        parts += [on if bit == "1" else off for bit, (on, off) in zip(bits, names)]
        # the model family (csrc/quadrotor.cuh), the last template argument
        fam = re.search(r"\d+(Quadrotor|Wrench|Multirotor)(?:ILi(\d+)E)?", mangled[i + args.end():])
        if fam:
            parts.append(fam.group(1) + (f"<{fam.group(2)}>" if fam.group(2) else ""))
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


def mpc_phase(env):
    """Phase 6b: the box and weights variants of backward.cu, rollout.cu and
    solve.cu against their plain versions (float64, B=300, N=40: `env.f64`),
    then BASELINE config 4 through `app.mpc.run_mpc` and `mpc_step`: as
    published at fleets 1, 32 and 128 on both exact routes, and at fleet 128
    with rotor limits and the terminal weight (the slice's main path,
    counted), with its quality checks and the first ticks against the plain
    route. `env` carries the run's device, helpers and problems. Returns
    {kernel: fields of its variant's JSON entry and its work}."""
    import numpy as np
    import torch

    from quadrotorilqr_tpu_torch.app import mpc, workloads
    from quadrotorilqr_tpu_torch.costs.quadratic import QuadraticTrackingCost
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import rollout as kr
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.solver import constrained
    from quadrotorilqr_tpu_torch.solver.batched import solve_batch_fused

    e = env
    dev, card = e.dev, e.card
    f64 = torch.float64
    t_phase = time.perf_counter()

    # ---- the variants against their plain versions, float64, B=300, N=40 ----
    params, cost, traj, opts = e.f64
    batch, n = traj.controls.shape[:2]
    rng = np.random.default_rng(9)
    w_n = torch.ones(n, dtype=f64, device=dev)
    w_n[-1] = 20.0
    hover = 9.81 / 4
    per_lane = (torch.as_tensor(hover - rng.uniform(0.2, 0.6, size=(batch, 4)), device=dev),
                torch.as_tensor(hover + rng.uniform(0.2, 0.6, size=(batch, 4)), device=dev))
    cases = (
        ("shared bounds (0, 2.9) and (N,) weights [1, ..., 1, 20]", (0.0, 2.9), w_n),
        ("per-scenario (B, 4) bounds and (B, N) weights", per_lane,
         torch.as_tensor(rng.uniform(0.5, 2.0, size=(batch, n)), device=dev)),
        ("wide bounds (-1e6, 1e6) and unit weights", (-1e6, 1e6), torch.ones(n, dtype=f64, device=dev)),
    )
    err = dict(backward=0.0, rollout=0.0, solve=0.0)
    alpha = torch.linspace(0.1, 1.0, batch, dtype=f64, device=dev)

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    def in_box(u, limits):
        lo, hi = constrained.prep_limits(limits, batch, f64, dev, 4)
        lo, hi = (b[:, None] if b.ndim == 2 else b for b in (lo, hi))
        return bool(((u >= lo) & (u <= hi)).all()), int(((u == lo) | (u == hi)).sum())

    for name, limits, w in cases:
        c = dataclasses.replace(cost, stage_weights=w)
        got = kb.backward_pass_fused(params, c, traj, DT, limits=limits)
        ref = kb.backward_pass_reference(params, c, traj, DT, 0.0, limits)
        g_t, g_c = kr.rollout_cost_fused(params, c, traj, ref[0], ref[1], alpha, DT, limits=limits)
        r_t, r_c = kr.rollout_cost_reference(params, c, traj, ref[0], ref[1], alpha, DT, limits)
        g_s = ks.solve_fused_whole(params, c, traj, DT, opts, limits=limits)
        r_s = ks.solve_whole_reference(params, c, traj, DT, opts, limits)
        loop = solve_batch_fused(params, c, traj, DT, opts, limits=limits)
        torch.cuda.synchronize()
        eb, rb = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1])), max(
            rel(g, r) for g, r in zip(got[2:], ref[2:]))
        er = max(max_abs(getattr(g_t.states.pose, k), getattr(r_t.states.pose, k))
                 for k in ("quat", "trans"))
        er = max(er, max_abs(g_t.states.vel, r_t.states.vel), max_abs(g_t.controls, r_t.controls))
        rr = rel(g_c, r_c)
        same = bool((g_s[3] == r_s[3]).all() and (g_s[2] == r_s[2]).all())
        rs, du = rel(g_s[1], r_s[1]), max_abs(g_s[0].controls, r_s[0].controls)
        loop_same = bool((loop.status == g_s[3]).all() and (loop.iterations == g_s[2]).all())
        loop_rel, loop_du = rel(loop.cost, g_s[1]), max_abs(loop.trajectory.controls, g_s[0].controls)
        loop_bits = int(((loop.status == g_s[3]) & (loop.iterations == g_s[2]) & (loop.cost == g_s[1])
                         & (loop.trajectory.controls == g_s[0].controls).flatten(1).all(1)).sum())
        boxed = [in_box(u, limits) for u in (g_t.controls, g_s[0].controls, loop.trajectory.controls)]
        e.log(f"f64 variants, {name}: backward.cu max |dk|,|dK| {eb:.3e} (atol 1e-9), rel QuTk, "
              f"kTQuuk {rb:.3e} (rtol 1e-9); rollout.cu max |dtraj| {er:.3e} (atol 1e-10), rel cost "
              f"{rr:.3e} (rtol 1e-10); solve.cu vs plain: status and iterations equal {same}, rel "
              f"cost {rs:.3e} (rtol 1e-8), max |du| {du:.3e} (atol 1e-7); the per-pass route vs "
              f"solve.cu: equal {loop_same} ({loop_rel:.3e}, {loop_du:.3e}), bit-equal on "
              f"{loop_bits} of {batch} lanes; every control in its box (rollout, solve.cu, per-pass) "
              f"{[b[0] for b in boxed]}, controls on a bound {[b[1] for b in boxed]}; statuses "
              f"{torch.bincount(r_s[3], minlength=3).tolist()}")
        e.check(eb <= 1e-9 and rb <= 1e-9 and er <= 1e-10 and rr <= 1e-10 and same and rs <= 1e-8
                and du <= 1e-7 and loop_same and loop_rel <= 1e-8 and loop_du <= 1e-7
                and all(b[0] for b in boxed), f"f64 variants ({name}) disagree with plain")
        err = dict(backward=max(err["backward"], eb), rollout=max(err["rollout"], er),
                   solve=max(err["solve"], du))
    # unit weights against none: the same gains, controls and decisions (the
    # cost sums w (dx'Q dx + du'R du) against dx'Q dx + du'R du)
    ones = dataclasses.replace(cost, stage_weights=torch.ones(n, dtype=f64, device=dev))
    for limits in (None, (0.0, 2.9)):
        base = ks.solve_fused_whole(params, cost, traj, DT, opts, limits=limits)
        unit = ks.solve_fused_whole(params, ones, traj, DT, opts, limits=limits)
        torch.cuda.synchronize()
        bits = all(bool((a == b).all()) for a, b in (
            (unit[2], base[2]), (unit[3], base[3]), (unit[0].controls, base[0].controls),
            (unit[0].states.pose.quat, base[0].states.pose.quat),
            (unit[0].states.pose.trans, base[0].states.pose.trans),
            (unit[0].states.vel, base[0].states.vel)))
        e.log(f"f64 solve.cu with unit weights against none (limits {limits}): trajectory, status "
              f"and iterations bit-equal {bits}; costs bit-equal on {int((unit[1] == base[1]).sum())} "
              f"of {batch} lanes, max rel {rel(unit[1], base[1]):.3e} (<= 1e-14)")
        e.check(bits and rel(unit[1], base[1]) <= 1e-14, "unit weights differ from no weights")

    # ---- BASELINE config 4 through run_mpc and mpc_step, float32 ----
    def problem(fleet, device=dev):
        return workloads.mpc_hover_problem(np.random.default_rng(4), fleet, MPC_HORIZON, MPC_TICKS,
                                           MPC_DT, torch.float32, device)

    def run(pb, ticks, latency, limits=False, weights=None):
        weights = limits if weights is None else weights
        return mpc.run_mpc(
            pb.params, pb.q, pb.r, pb.desired, pb.x0, ticks, MPC_HORIZON, MPC_DT, pb.options,
            latency_kernel=latency, stage_weights=pb.stage_weights if weights else None,
            limits=pb.limits if limits else None, plant_params=pb.plant,
        )

    def host_syncs(fn):
        """Synchronizing CUDA operations during fn (torch's sync debug mode)."""
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    def host_loop(pb, latency, limits):
        """mpc_step driven from the host, u0 read back every tick, the plant
        the controller's model (as benchmarks/run_all.py:396-421 steps it):
        the per-tick ms of ticks 1 to MPC_TICKS - 1 (p50, p99, max)."""
        x, warm = pb.x0, mpc.mpc_warm_start(pb.desired, pb.x0, MPC_HORIZON)
        kw = dict(latency_kernel=latency,
                  stage_weights=pb.stage_weights if limits else None,
                  limits=pb.limits if limits else None)
        ticks = []
        for k in range(MPC_TICKS):
            t0 = time.perf_counter()
            x, warm, u0 = mpc.mpc_step(pb.params, pb.q, pb.r, pb.desired, x, warm, k, MPC_HORIZON,
                                       MPC_DT, pb.options, **kw)
            u0.cpu()
            if k:
                ticks.append((time.perf_counter() - t0) * 1e3)
        return tuple(float(v) for v in (np.percentile(ticks, 50), np.percentile(ticks, 99),
                                        max(ticks)))

    def measure(pb, latency, limits):
        """ms a tick (events around the MPC_TICKS run over MPC_TICKS), the
        chunk slope (against the MPC_CHUNK run), mean iterations a tick,
        host syncs a tick, the host loop's per-tick p50, p99, max; median
        of 3 after a warm-up."""
        run(pb, MPC_CHUNK, latency, limits)
        torch.cuda.synchronize()
        full, chunk = [], []
        for _ in range(3):
            res, ms_full = e.time_once(lambda: run(pb, MPC_TICKS, latency, limits))
            full.append(ms_full)
            chunk.append(e.time_once(lambda: run(pb, MPC_CHUNK, latency, limits))[1])
        t_full, t_chunk = statistics.median(full), statistics.median(chunk)
        syncs = host_syncs(lambda: run(pb, MPC_CHUNK, latency, limits)) / MPC_CHUNK
        return dict(ms_tick=t_full / MPC_TICKS,
                    slope=(t_full - t_chunk) / (MPC_TICKS - MPC_CHUNK),
                    iters=float(res["iterations"].float().mean()), syncs=syncs,
                    host=host_loop(pb, latency, limits), out=res)

    def report(what, fleet, route, m):
        p50, p99, mx = m["host"]
        e.log(f"config 4 {what}, fleet {fleet}, {route}: {m['ms_tick']:.4f} ms a tick over "
              f"{MPC_TICKS} ticks, chunk slope {m['slope']:.4f} ms a tick ({MPC_CHUNK} against "
              f"{MPC_TICKS} ticks), {m['iters']:.3f} mean iterations a tick, {m['syncs']:.2f} host "
              f"syncs a tick; host-driven mpc_step per tick p50 {p50:.4f}, p99 {p99:.4f}, max "
              f"{mx:.4f} ms (H={MPC_HORIZON}, dt {MPC_DT}, f32) {card}")

    routes = ((True, "solve.cu (latency_kernel=True)"), (False, "the per-pass route"))
    published = {}
    for fleet in MPC_FLEETS:
        pb = problem(fleet)
        for latency, route in routes:
            m = measure(pb, latency, False)
            published[(fleet, latency)] = m
            report("as published", fleet, route, m)
            u = m["out"]["u"]
            e.check(bool(torch.isfinite(u).all()) and u.shape == (fleet, MPC_TICKS, 4),
                    f"config 4 at fleet {fleet} on {route}: wrong or non-finite controls")

    # the constrained variant at fleet 128: the slice's main path, counted
    pb = problem(MPC_FLEETS[-1])
    e.reset_counts()
    main = {latency: run(pb, MPC_TICKS, latency, True) for latency, _ in routes}
    torch.cuda.synchronize()
    launches = e.counts()
    e.log(f"config 4 with limits and terminal weights (fleet {MPC_FLEETS[-1]}, {MPC_TICKS} ticks, "
          f"both routes), launches: {launches}")
    e.check(all(launches[k] > 0 for k in ("backward", "rollout", "solve")),
            f"a kernel of the MPC path never ran: {launches}")
    hi = torch.tensor(pb.limits[1], dtype=torch.float32, device=dev)
    x0_err = float(pb.x0.pose.trans.norm(dim=-1).mean())
    unweighted = {latency: run(pb, MPC_TICKS, latency, True, False) for latency, _ in routes}
    cpu_pb = problem(MPC_FLEETS[-1], "cpu")
    plain = run(cpu_pb, MPC_PLAIN_TICKS, True, True)
    for latency, route in routes:
        out = main[latency]
        u = out["u"]
        final_err = float(out["x_final"].pose.trans.norm(dim=-1).mean())
        base_err = float(unweighted[latency]["x_final"].pose.trans.norm(dim=-1).mean())
        bound_ticks = int((u == hi).any(-1).any(0).sum())
        st, c = out["status"][:, :MPC_PLAIN_TICKS].cpu(), out["cost"][:, :MPC_PLAIN_TICKS].cpu()
        agree = float((st == plain["status"]).float().mean())
        rc = (c - plain["cost"]).abs() / plain["cost"].abs()
        med, q99 = float(rc.median()), float(torch.quantile(rc.flatten().double(), 0.99))
        # per lane, the largest control difference over the ticks, against
        # the largest control: the 99th percentile over lanes
        du = (out["u"][:, :MPC_PLAIN_TICKS].cpu() - plain["u"]).abs().flatten(1).amax(1)
        du_q99 = float(torch.quantile(du.double(), 0.99)) / float(plain["u"].abs().max())
        e.log(f"config 4 with limits and terminal weights via {route}: controls in "
              f"[{float(u.min()):.4f}, {float(u.max()):.4f}] (within [0, 2.9]), the upper bound binds "
              f"on {bound_ticks} of {MPC_TICKS} ticks; mean final position error {final_err:.4f} m "
              f"against {x0_err:.4f} m at the start (< 0.8x), {base_err:.4f} m with limits and no "
              f"weights (weighted < 1.5x); statuses {torch.bincount(out['status'].flatten(), minlength=3).tolist()}; "
              f"first {MPC_PLAIN_TICKS} ticks against the plain route: status agreement {agree:.4f} "
              f"(>= 0.99), median rel cost diff {med:.3e} (< 1e-3), 99th percentile {q99:.3e} "
              f"(<= 1e-3), lanes' max |du| / max |u| 99th percentile {du_q99:.3e} (<= 1e-3)")
        e.check(float(u.min()) >= 0.0 and float(u.max()) <= float(hi) and bound_ticks > 0
                and final_err < 0.8 * x0_err and final_err < 1.5 * base_err and agree >= 0.99
                and med < 1e-3 and q99 <= 1e-3 and du_q99 <= 1e-3,
                f"config 4 with limits and terminal weights via {route} fails its checks")
    # the per-pass route runs the Riccati stage and the rollout of
    # solve.cu's sweeps (team.cuh, team_trip.cuh): bit-equal, as in float64
    routes_bits = all(bool((main[True][k] == main[False][k]).all())
                      for k in ("u", "status", "iterations", "cost"))
    e.log(f"config 4 with limits and terminal weights: the two routes' controls, statuses, "
          f"iterations and costs bit-equal {routes_bits} (required)")
    e.check(routes_bits, "config 4 with limits and terminal weights: the per-pass route differs "
            "from solve.cu")
    constrained_m = {}
    for latency, route in routes:
        constrained_m[latency] = measure(pb, latency, True)
        report("with limits and terminal weights", MPC_FLEETS[-1], route, constrained_m[latency])

    # ---- the variants' kernels at config 4's shapes (f32, B=128, N=50):
    # each against its plain version on the inputs of the first tick ----
    win = mpc._window(pb.desired, 0, MPC_HORIZON)
    plain_cost = QuadraticTrackingCost(Q=pb.q, R=pb.r, desired_states=win.states,
                                       desired_controls=win.controls)
    v_cost = dataclasses.replace(plain_cost, stage_weights=pb.stage_weights)
    warm = mpc.mpc_warm_start(pb.desired, pb.x0, MPC_HORIZON)
    b4 = warm.controls.shape[0]
    ones4 = torch.ones(b4, dtype=torch.float32, device=dev)
    lo4, hi4 = constrained.prep_limits(pb.limits, b4, torch.float32, dev, 4)
    lo4, hi4 = (b[:, None] if b.ndim == 2 else b for b in (lo4, hi4))
    # the kernels see the trajectory after trip 0's full step (the warm
    # start sits on the target past stage 0, where k is exactly 0)
    k0 = kb.backward_pass_reference(pb.params, v_cost, warm, MPC_DT, 0.0, pb.limits)
    t1, _ = kr.rollout_cost_reference(pb.params, v_cost, warm, k0[0], k0[1], ones4, MPC_DT,
                                      pb.limits)
    k1 = kb.backward_pass_fused(pb.params, v_cost, t1, MPC_DT, limits=pb.limits)
    k1_ref = kb.backward_pass_reference(pb.params, v_cost, t1, MPC_DT, 0.0, pb.limits)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(a).all()) for a in k1)
    eb32 = max(max_abs(g, r) for g, r in zip(k1[:2], k1_ref[:2]))
    scaled = max(max_abs(g, r) / float(r.abs().max()) for g, r in zip(k1[:2], k1_ref[:2]))
    clamped = int(((k1_ref[0] + t1.controls <= lo4) | (k1_ref[0] + t1.controls >= hi4)).sum())
    e.log(f"f32 backward.cu with limits and weights (B={b4}, N={MPC_HORIZON}): finite {finite}, "
          f"max |dk|,|dK| {eb32:.3e}, over max |ref| {scaled:.3e} (bound 1e-3); plain steps at a "
          f"bound {clamped}")
    e.check(finite and scaled <= 1e-3, "f32 backward.cu with limits and weights outside its bound")
    g_t, g_c = kr.rollout_cost_fused(pb.params, v_cost, t1, k1_ref[0], k1_ref[1], ones4, MPC_DT,
                                     limits=pb.limits)
    r_t, r_c = kr.rollout_cost_reference(pb.params, v_cost, t1, k1_ref[0], k1_ref[1], ones4, MPC_DT,
                                         pb.limits)
    torch.cuda.synchronize()
    g_leaves = (g_t.states.pose.quat, g_t.states.pose.trans, g_t.states.vel, g_t.controls)
    r_leaves = (r_t.states.pose.quat, r_t.states.pose.trans, r_t.states.vel, r_t.controls)
    finite = all(bool(torch.isfinite(a).all()) for a in g_leaves + (g_c,))
    er32 = max(max_abs(g, r) for g, r in zip(g_leaves, r_leaves))
    dtraj = max(max_abs(g, r) / float(r.abs().max()) for g, r in zip(g_leaves, r_leaves))
    dc = float(((g_c - r_c).abs() / r_c.abs()).max())
    boxed = bool(((g_t.controls >= lo4) & (g_t.controls <= hi4)).all())
    on_bound = int(((g_t.controls == lo4) | (g_t.controls == hi4)).sum())
    e.log(f"f32 rollout.cu with limits and weights: finite {finite}, max |dtraj| {er32:.3e}, "
          f"over max |ref| (quat, trans, vel, u) {dtraj:.3e} (bound 1e-3), max rel cost {dc:.3e} "
          f"(bound 1e-3); every control in its box {boxed}, {on_bound} on a bound")
    e.check(finite and dtraj <= 1e-3 and dc <= 1e-3 and boxed,
            "f32 rollout.cu with limits and weights outside its bound")
    solve_args = (pb.params, v_cost, warm, MPC_DT, pb.options)
    g_s = ks.solve_fused_whole(*solve_args, limits=pb.limits)
    # the plain loop runs once: it is timed here
    r_s, plain_solve_ms = e.time_once(lambda: ks.solve_whole_reference(*solve_args, pb.limits))
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(g_s[1]).all() and torch.isfinite(g_s[0].controls).all())
    agree = float((g_s[3] == r_s[3]).float().mean())
    rc = ((g_s[1] - r_s[1]).abs() / r_s[1].abs()).double()
    du_lane = (g_s[0].controls - r_s[0].controls).abs().flatten(1).amax(1).double()
    du_scale = float(r_s[0].controls.abs().max())
    es32 = float(du_lane.max())
    med, q99 = float(rc.median()), float(torch.quantile(rc, 0.99))
    du_q99 = float(torch.quantile(du_lane, 0.99)) / du_scale
    boxed = bool(((g_s[0].controls >= lo4) & (g_s[0].controls <= hi4)).all())
    e.log(f"f32 solve.cu with limits and weights vs plain on config 4's first window: finite "
          f"{finite}, status agreement {agree:.4f} (>= 0.99), rel cost diff median {med:.3e} "
          f"(< 1e-3), 99th percentile {q99:.3e} (<= 1e-3), max {float(rc.max()):.3e}; lanes' max "
          f"|du| / max |u| 99th percentile {du_q99:.3e} (<= 1e-3), max |du| {es32:.3e}; every "
          f"control in its box {boxed}")
    e.check(finite and agree >= 0.99 and med < 1e-3 and q99 <= 1e-3 and du_q99 <= 1e-3 and boxed,
            "f32 solve.cu with limits and weights outside its bounds")
    err32 = dict(backward=eb32, rollout=er32, solve=es32)
    variant = {}

    def bwd(c, limits, tr):
        return lambda: kb.backward_pass_fused(pb.params if tr is t1 else e.bench[0], c, tr,
                                              MPC_DT if tr is t1 else DT, limits=limits)

    variant["backward"] = dict(
        ms=e.launch_ms(bwd(v_cost, pb.limits, t1), "qilqr_backward"),
        plain_ms=e.time_ms(lambda: kb.backward_pass_reference(pb.params, v_cost, t1, MPC_DT, 0.0,
                                                              pb.limits)),
        unconstrained_ms=e.launch_ms(bwd(plain_cost, None, t1), "qilqr_backward"),
    )
    variant["rollout"] = dict(
        ms=e.launch_ms(lambda: kr.rollout_cost_fused(pb.params, v_cost, t1, k1[0], k1[1], ones4,
                                                     MPC_DT, limits=pb.limits), "qilqr_rollout"),
        plain_ms=e.time_ms(lambda: kr.rollout_cost_reference(pb.params, v_cost, t1, k1[0], k1[1],
                                                             ones4, MPC_DT, pb.limits)),
        unconstrained_ms=e.launch_ms(lambda: kr.rollout_cost_fused(
            pb.params, plain_cost, t1, k1[0], k1[1], ones4, MPC_DT), "qilqr_rollout"),
    )
    variant["solve"] = dict(
        ms=e.time_ms(lambda: ks.solve_fused_whole(*solve_args, limits=pb.limits)),
        plain_ms=plain_solve_ms,
        unconstrained_ms=e.time_ms(lambda: ks.solve_fused_whole(pb.params, plain_cost, warm, MPC_DT,
                                                                pb.options)),
    )
    counted = ks.solve_fused_whole(*solve_args, limits=pb.limits, return_probes=True)
    torch.cuda.synchronize()
    # at the bench workload's shapes (B=4096, N=100): the Riccati stage's
    # cost with and without the variants
    b_params, b_cost, b_traj = e.bench
    bn = b_traj.controls.shape[1]
    bw = torch.ones(bn, dtype=torch.float32, device=dev)
    bw[-1] = 20.0
    b_vcost = dataclasses.replace(b_cost, stage_weights=bw)
    bench_bwd = (e.launch_ms(bwd(b_vcost, (0.0, 2.9), b_traj), "qilqr_backward"),
                 e.launch_ms(bwd(b_cost, None, b_traj), "qilqr_backward"))
    for name in ("backward", "rollout", "solve"):
        v = variant[name]
        e.log(f"{name}.cu with limits and weights at config 4's shapes (B={b4}, N={MPC_HORIZON}, f32): "
              f"{v['ms']:.4f} ms, without either {v['unconstrained_ms']:.4f} ms "
              f"(x{v['ms'] / v['unconstrained_ms']:.3f}); plain {v['plain_ms']:.3f} ms {card}")
    e.log(f"backward.cu with limits and weights at the bench workload's shapes (B="
          f"{b_traj.controls.shape[0]}, N={bn}, f32): {bench_bwd[0]:.4f} ms, without either "
          f"{bench_bwd[1]:.4f} ms (x{bench_bwd[0] / bench_bwd[1]:.3f}) {card}")
    f, word, stage = FLOPS, 4, b4 * MPC_HORIZON
    riccati = f["riccati"] + f["box_extra"] + f["weights_extra"]
    rollout = f["rollout"] + f["rollout_box_extra"] + f["rollout_weights_extra"]
    extra_bytes = (8 + MPC_HORIZON) * word  # shared bounds and weights
    work = {
        "backward": (stage * riccati, (17 + 52) * stage * word + 2 * b4 * word + extra_bytes),
        "rollout": (stage * rollout, (17 + 52 + 17) * stage * word + 2 * b4 * word + extra_bytes),
        "solve": ((int(counted[4].sum()) * riccati + int(counted[5].sum()) * rollout) * MPC_HORIZON,
                  2 * 17 * stage * word + 3 * b4 * word + extra_bytes),
    }
    e.log(f"solve.cu with limits and weights ran (backward passes, probe sweeps) "
          f"{(int(counted[4].sum()), int(counted[5].sum()))} on config 4's first window")
    e.log(f"config 4 phase took {time.perf_counter() - t_phase:.1f} s")
    return {
        name: dict(variant[name], launches=launches[name], max_abs_err=err32[name],
                   f64_max_abs_err=err[name], f64_shape=(batch, n), work=work[name],
                   shape=(b4, MPC_HORIZON))
        for name in ("backward", "rollout", "solve")
    } | {"_mpc": dict(
        published={f"{fl}/{'solve' if lat else 'per_pass'}": {k: v for k, v in m.items() if k != "out"}
                   for (fl, lat), m in published.items()},
        constrained={("solve" if lat else "per_pass"): {k: v for k, v in m.items() if k != "out"}
                     for lat, m in constrained_m.items()},
        bench_backward_ms=bench_bwd,
    )}


# The wider-control model families (csrc/quadrotor.cuh): each exact kernel
# source's instantiation per family, with its control width u, the nonzero
# entries of each column of its j_u (the wrench's force columns 1, its
# torque columns 3; a rotor's thrust column 4: rows 8:12), and the JAX lane
# model it runs.
FAMILY_CASES = (
    ("_wrench", 6, (1, 1, 1, 3, 3, 3), "quadrotorilqr_tpu/kernels/models.py:118"),
    ("_rotor6", 6, (4,) * 6, "quadrotorilqr_tpu/kernels/models.py:247"),
    ("_rotor8", 8, (4,) * 8, "quadrotorilqr_tpu/kernels/models.py:247"),
)


def riccati_flops(ju_nnz):
    """A Gauss-Newton Riccati stage of a family with control width u =
    len(ju_nnz) whose j_u column c has ju_nnz[c] nonzero entries (z in all;
    team_riccati_stage), the u = 4 count of FLOPS with its u-dependent terms
    recounted, j_u's structural zeros left out: the j_x blocks 1006; the cost
    diffs 2971 + 3 u^2 (c_u = 2R (u - u_d)); the Q-expansion 4447 + 2 z
    (q_u) + 12 (2 z - u) (V_xx j_u) + u (2 z + 3 u) (Q_uu) + 171 u (Q_xu =
    j_x' V_xx j_u, 14.25 a 12-row column); the u x u Cholesky gains, its
    factorization sum_j (2 j + 2 + (u - 1 - j)(2 j + 1)) and 2 x 13 u^2 for
    the two triangular solves of 13 columns, with the u = 4 count's 10
    others; the value update 26 u^2 + 303 u + 286. At u = 4, z = 16:
    12074."""
    u, z = len(ju_nnz), sum(ju_nnz)
    fact = sum(2 * j + 2 + (u - 1 - j) * (2 * j + 1) for j in range(u))
    return (1006 + (2971 + 3 * u * u)
            + (4447 + 2 * z + 12 * (2 * z - u) + u * (2 * z + 3 * u) + 171 * u)
            + (10 + fact + 26 * u * u) + (26 * u * u + 303 * u + 286))


def rollout_flops(u, wrench):
    """A rollout stage (team_rollout): the state minus 227, the controls 25 u,
    the stage cost 526 + 2 u^2 + 2 u, the dynamics step 263 shared by the
    families plus the wrench's force and torque terms 21, or the rotors'
    thrust sum and moment map 7 u + 18. At u = 4 with rotors: 1202."""
    return 227 + 25 * u + (526 + 2 * u * u + 2 * u) + 263 + (21 if wrench else 7 * u + 18)


def np_family_problem(seed, batch, n, suffix):
    """As np_problem, for the family of a kernel suffix (_wrench, _rotorR):
    random stages around the family's hover control, per-scenario params
    (masses, inertias, and for the rotors the yaw ratios), and an R with
    off-diagonal terms, as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.concatenate([np.ones((batch, n, 1)), 0.3 * rng.normal(size=(batch, n, 3))], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    des_q = np.zeros((n, 4))
    des_q[:, 0] = 1.0
    scale = 1.0 + 0.2 * rng.uniform(-1, 1, size=batch)
    inertia = (np.diag([0.4, 0.5, 0.6]) + 0.03) * scale[:, None, None]
    if suffix == "_wrench":
        u, hover = 6, np.array([0.0, 0.0, 1.3 * 9.81, 0.0, 0.0, 0.0])
        params = SimpleNamespace(mass_kg=1.3 * scale, inertia=inertia, g_mpss=np.full(batch, 9.81))
    else:
        u = int(suffix[len("_rotor"):])
        hover = np.full(u, 1.5 * 9.81 / u)
        ang = 2.0 * np.pi * np.arange(u) / u
        ring = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), np.zeros(u)], -1)
        params = SimpleNamespace(
            mass_kg=1.5 * scale, inertia=inertia,
            rotor_positions_m=np.broadcast_to(ring, (batch, u, 3)),
            rotor_spin=np.broadcast_to(np.where(np.arange(u) % 2 == 0, -1.0, 1.0), (batch, u)),
            torque_to_thrust_ratio_m=0.01 + 0.02 * rng.uniform(size=batch),
            g_mpss=np.full(batch, 9.81),
        )
    cost = SimpleNamespace(
        Q=np.diag(np.concatenate([100.0 * np.ones(6), np.ones(6)])),
        R=np.eye(u) + 0.1 * np.ones((u, u)),
        desired_states=SimpleNamespace(
            pose=SimpleNamespace(quat=des_q, trans=np.zeros((n, 3))), vel=np.zeros((n, 6))
        ),
        desired_controls=np.tile(hover, (n, 1)),
    )
    traj = SimpleNamespace(
        times=np.broadcast_to(np.arange(n) * DT, (batch, n)),
        states=SimpleNamespace(
            pose=SimpleNamespace(quat=q, trans=0.4 * rng.normal(size=(batch, n, 3))),
            vel=0.2 * rng.normal(size=(batch, n, 6)),
        ),
        controls=hover + 0.5 * rng.normal(size=(batch, n, u)),
    )
    return params, cost, traj


def families_phase(env):
    """Phase 6c: the wider-control model families (the SE(3) body wrench,
    u = 6, and the 6- and 8-rotor multirotors) on backward.cu, rollout.cu,
    solve.cu and stream.cu. Every new instantiation against its plain
    version in float64 (B=300, N=40) lane for lane, stream.cu and the
    per-pass route bit-equal to solve.cu; a 4-rotor multirotor bit-equal to
    the quadrotor; each family's workload (B=4096, N=100, f32) through both
    exact routes against the plain loop, with the per-pass kernels timed;
    each family at N=512 on stream.cu beside solve.cu, against plain for
    LONG_PLAIN_TRIPS trips; then the main path, counted: the three families
    at N=100 through both routes and at N=512 through
    `solve_batch_latency` (stream.cu). Returns the new instantiations' JSON
    entries."""
    import torch

    from quadrotorilqr_tpu_torch import convert
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.kernels import _build
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import rollout as kr
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.kernels import stream as kst
    from quadrotorilqr_tpu_torch.models.multirotor import MultirotorParams
    from quadrotorilqr_tpu_torch.solver import ilqr
    from quadrotorilqr_tpu_torch.solver.batched import (
        _with_max_iters,
        solve_batch_fused,
        solve_batch_latency,
        stream_horizon,
    )
    from quadrotorilqr_tpu_torch.solver.options import (
        ConvergenceCriteria,
        ILQROptions,
        LineSearchParams,
    )

    e = env
    dev, card = e.dev, e.card
    f64, f32 = torch.float64, torch.float32
    t_phase = time.perf_counter()
    e.check([sfx for sfx, *_ in FAMILY_CASES] == [sfx for sfx in _build.FAMILIES if sfx],
            "FAMILY_CASES differs from the families the kernels are built for")
    opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 6))
    entries = {}  # name -> fields of its JSON entry

    def rel_max(a, b):
        return float(((a - b).abs() / b.abs()).max())

    def lanes(got, ref):
        """Status and iterations equal, max rel cost, max |du|."""
        same = bool((got[3] == ref[3]).all() and (got[2] == ref[2]).all())
        return same, rel_max(got[1], ref[1]), max_abs(got[0].controls, ref[0].controls)

    def problem(sfx, seed, n):
        """The family's full-width workload (B=4096, f32) at N=n."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        if sfx == "_wrench":
            return workloads.wrench_problem(gen, batch, n, DT, f32, dev)
        return workloads.hexarotor_problem(gen, batch, n, DT, f32, dev, n_rotors=int(sfx[6:]))

    # ---- every new instantiation against its plain version, float64 ----
    for sfx, u, _, _ in FAMILY_CASES:
        p_np, c_np, t_np = np_family_problem(3, 300, 40, sfx)
        params = convert.params_from_numpy(p_np, f64, dev)
        cost = convert.cost_from_numpy(c_np, f64, dev)
        traj = convert.trajectory_from_numpy(t_np, f64, dev)
        ref_b, b_plain = e.time_once(lambda: kb.backward_pass_reference(params, cost, traj, DT))
        got_b = kb.backward_pass_fused(params, cost, traj, DT)
        alpha = torch.linspace(0.1, 1.0, 300, dtype=f64, device=dev)
        (r_t, r_c), r_plain = e.time_once(
            lambda: kr.rollout_cost_reference(params, cost, traj, ref_b[0], ref_b[1], alpha, DT))
        g_t, g_c = kr.rollout_cost_fused(params, cost, traj, ref_b[0], ref_b[1], alpha, DT)
        ref_s, s_plain = e.time_once(lambda: ks.solve_whole_reference(params, cost, traj, DT, opts))
        got_s = ks.solve_fused_whole(params, cost, traj, DT, opts)
        ref_st, st_plain = e.time_once(
            lambda: kst.solve_streamed_reference(params, cost, traj, DT, opts))
        got_st = kst.solve_fused_streamed(params, cost, traj, DT, opts, return_probes=True)
        loop = solve_batch_fused(params, cost, traj, DT, opts)
        torch.cuda.synchronize()
        err_b = max(max_abs(got_b[0], ref_b[0]), max_abs(got_b[1], ref_b[1]))
        rel_b = max(rel_max(g, r) for g, r in zip(got_b[2:], ref_b[2:]))
        err_r = max(max_abs(g_t.states.pose.quat, r_t.states.pose.quat),
                    max_abs(g_t.states.pose.trans, r_t.states.pose.trans),
                    max_abs(g_t.states.vel, r_t.states.vel), max_abs(g_t.controls, r_t.controls))
        rel_r = rel_max(g_c, r_c)
        ok_s, rel_s, du_s = lanes(got_s, ref_s)
        ok_st, rel_st, du_st = lanes(got_st, ref_st)
        st_bits = bit_equal(got_st, got_s)
        pp_bits = bit_equal(loop, got_s)
        e.log(f"f64 {sfx[1:]} (u={u}, B=300, N=40): backward max |dk|,|dK| {err_b:.3e} (atol 1e-9), "
              f"rel QuTk/kTQuuk {rel_b:.3e} (rtol 1e-9); rollout max |dtraj| {err_r:.3e} (atol "
              f"1e-10), rel cost {rel_r:.3e} (rtol 1e-10); solve.cu vs plain: status and "
              f"iterations equal {ok_s}, rel cost {rel_s:.3e} (rtol 1e-8), max |du| {du_s:.3e} "
              f"(atol 1e-7), statuses {torch.bincount(ref_s[3], minlength=3).tolist()}; stream.cu "
              f"vs its plain loop {ok_st} ({rel_st:.3e}, {du_st:.3e}); stream.cu bit-equal to "
              f"solve.cu {st_bits}; the per-pass route bit-equal to solve.cu {pp_bits}")
        e.check(err_b <= 1e-9 and rel_b <= 1e-9 and err_r <= 1e-10 and rel_r <= 1e-10,
                f"f64 {sfx[1:]} per-pass kernels disagree with plain")
        e.check(ok_s and rel_s <= 1e-8 and du_s <= 1e-7 and ok_st and rel_st <= 1e-8
                and du_st <= 1e-7, f"f64 {sfx[1:]} whole-solve kernels disagree with plain")
        e.check(st_bits and pp_bits, f"f64 {sfx[1:]}: stream.cu or the per-pass route differs "
                f"from solve.cu")
        entries[f"backward{sfx}"] = dict(f64_err=err_b, f64_plain_ms=b_plain)
        entries[f"rollout{sfx}"] = dict(f64_err=err_r, f64_plain_ms=r_plain)
        entries[f"solve{sfx}"] = dict(f64_err=du_s, f64_plain_ms=s_plain)
        entries[f"stream{sfx}"] = dict(f64_err=du_st, f64_plain_ms=st_plain)

    # ---- a 4-rotor multirotor is the quadrotor: bit-equal on both routes ----
    p_np, c_np, t_np = np_problem(4, 300, 40)
    q_params = convert.params_from_numpy(p_np, f64, dev)
    arm = float(p_np.arm_length_m[0])
    ring = torch.tensor([[-arm, 0.0, 0.0], [0.0, -arm, 0.0], [arm, 0.0, 0.0], [0.0, arm, 0.0]],
                        dtype=f64, device=dev)
    m_params = MultirotorParams(
        mass_kg=q_params.mass_kg, inertia=q_params.inertia,
        rotor_positions_m=ring.expand(300, 4, 3).contiguous(),
        rotor_spin=torch.tensor([-1.0, 1.0, -1.0, 1.0], dtype=f64, device=dev).expand(300, 4)
        .contiguous(),
        torque_to_thrust_ratio_m=q_params.torque_to_thrust_ratio_m, g_mpss=q_params.g_mpss,
    )
    cost = convert.cost_from_numpy(c_np, f64, dev)
    traj = convert.trajectory_from_numpy(t_np, f64, dev)
    same = all(
        bit_equal(route(m_params, cost, traj, DT, opts), route(q_params, cost, traj, DT, opts))
        for route in (solve_batch_latency, solve_batch_fused)
    )
    torch.cuda.synchronize()
    e.log(f"f64 multirotor with R=4 (the reference airframe) vs the quadrotor, B=300, N=40: "
          f"solve.cu and the per-pass route bit-equal {same}")
    e.check(same, "the 4-rotor multirotor differs from the quadrotor")

    # ---- each family's workload, float32, B=4096, N=100, against plain ----
    batch, n = 4096, 100
    fam_opts = workloads.FAMILY_OPTIONS
    mains = {sfx: problem(sfx, 0, n) for sfx, *_ in FAMILY_CASES}
    for sfx, u, ju_nnz, _ in FAMILY_CASES:
        params, cost, trajs = mains[sfx]
        wrench = sfx == "_wrench"
        ref, plain_ms = e.time_once(lambda: ks.solve_whole_reference(params, cost, trajs, DT,
                                                                     fam_opts))
        res = {"solve.cu": solve_batch_latency(params, cost, trajs, DT, fam_opts),
               "per-pass": solve_batch_fused(params, cost, trajs, DT, fam_opts)}
        torch.cuda.synchronize()
        conv_p = float((ref[3] == ilqr.STATUS_CONVERGED).float().mean())
        for route, r in res.items():
            finite = bool(torch.isfinite(r.cost).all() and torch.isfinite(r.trajectory.controls).all())
            agree = float((r.status == ref[3]).float().mean())
            med = float(((r.cost - ref[1]).abs() / ref[1].abs()).median())
            conv = float((r.status == ilqr.STATUS_CONVERGED).float().mean())
            e.log(f"f32 {sfx[1:]} workload (B={batch}, N={n}) via {route}: finite {finite}, status "
                  f"agreement with plain {agree:.4f} (>= 0.99), median rel cost diff {med:.3e} "
                  f"(< 1e-3), converged {conv:.4f} (plain {conv_p:.4f}, within 0.01), mean "
                  f"iterations {float(r.iterations.float().mean()):.3f}, mean cost "
                  f"{float(r.cost.mean()):.6g}")
            e.check(finite and agree >= 0.99 and med < 1e-3 and abs(conv - conv_p) <= 0.01,
                    f"f32 {sfx[1:]} workload via {route} outside its bounds")
        # the per-pass kernels on the trajectory after trip 0's full step
        ones = torch.ones(batch, dtype=f32, device=dev)
        k0 = kb.backward_pass_reference(params, cost, trajs, DT)
        trajs1, _ = kr.rollout_cost_reference(params, cost, trajs, k0[0], k0[1], ones, DT)
        k1 = kb.backward_pass_fused(params, cost, trajs1, DT)
        d, stage, word = 13 + u, batch * n, 4
        passes, probes = int(ref[5].sum()), int(ref[6].sum())

        def bwd():
            return kb.backward_pass_fused(params, cost, trajs1, DT)

        def roll():
            return kr.rollout_cost_fused(params, cost, trajs1, k1[0], k1[1], ones, DT)

        timed = {
            "backward": (e.launch_ms(bwd, f"qilqr_backward{sfx}"),
                         e.time_ms(lambda: kb.backward_pass_reference(params, cost, trajs1, DT)),
                         (stage * riccati_flops(ju_nnz), (d + 13 * u) * stage * word)),
            "rollout": (e.launch_ms(roll, f"qilqr_rollout{sfx}"),
                        e.time_ms(lambda: kr.rollout_cost_reference(params, cost, trajs1, k1[0],
                                                                    k1[1], ones, DT)),
                        (stage * rollout_flops(u, wrench), (2 * d + 13 * u) * stage * word)),
            "solve": (e.time_ms(lambda: solve_batch_latency(params, cost, trajs, DT, fam_opts)),
                      plain_ms,
                      ((passes * riccati_flops(ju_nnz) + probes * rollout_flops(u, wrench)) * n,
                       2 * d * stage * word)),
        }
        per_pass_ms = e.time_ms(lambda: solve_batch_fused(params, cost, trajs, DT, fam_opts))
        e.log(f"{sfx[1:]} workload (B={batch}, N={n}, f32): solve.cu {timed['solve'][0]:.3f} ms per "
              f"batch solve ({batch / timed['solve'][0] * 1e3:.1f} solves/s), the per-pass route "
              f"{per_pass_ms:.3f} ms, the plain loop {plain_ms:.1f} ms; backward.cu launch "
              f"{timed['backward'][0]:.3f} ms (plain {timed['backward'][1]:.1f}), rollout.cu "
              f"launch {timed['rollout'][0]:.3f} ms (plain {timed['rollout'][1]:.1f}); the plain "
              f"loop ran {passes} backward passes, {probes} probe sweeps {card}")
        for kname, (ms, p_ms, work) in timed.items():
            entries[f"{kname}{sfx}"].update(
                ms=ms, plain_ms=p_ms, work=work, shape=dict(B=batch, N=n, dtype="float32"),
                per_pass_route_ms=per_pass_ms,
            )

    # ---- each family at N=512 on stream.cu, beside solve.cu, against plain ----
    long_n = 512
    longs = {sfx: problem(sfx, 1, long_n) for sfx, *_ in FAMILY_CASES}
    for sfx, u, ju_nnz, _ in FAMILY_CASES:
        l_params, l_cost, l_trajs = longs[sfx]
        l_args = (l_params, l_cost, l_trajs, DT, _with_max_iters(fam_opts, LONG_PLAIN_TRIPS))
        l_k = kst.solve_fused_streamed(*l_args, return_probes=True)
        l_p, l_plain_ms = e.time_once(lambda: kst.solve_streamed_reference(*l_args))
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(l_k[1]).all() and torch.isfinite(l_k[0].controls).all())
        rel = (l_k[1] - l_p[1]).abs() / l_p[1].abs()
        med, q99 = float(rel.median()), float(rel.quantile(0.99))
        agree = float((l_k[3] == l_p[3]).float().mean())
        l_work = [int(a.sum()) for a in l_k[4:]]
        e.log(f"f32 {sfx[1:]} stream.cu vs its plain loop (B={batch}, N={long_n}, its first "
              f"{LONG_PLAIN_TRIPS} trips): finite {finite}, rel cost diff median {med:.3e} (< 1e-3), "
              f"99th percentile {q99:.3e} (< 1e-3), status agreement {agree:.4f} (>= 0.99); "
              f"(backward passes, probe sweeps, apply sweeps) {l_work}; plain loop "
              f"{l_plain_ms:.1f} ms")
        e.check(finite and med < 1e-3 and q99 < 1e-3 and agree >= 0.99,
                f"f32 {sfx[1:]} stream.cu outside its bounds")
        full_args = (l_params, l_cost, l_trajs, DT, fam_opts)
        l_ms = e.time_ms(lambda: kst.solve_fused_streamed(*l_args))
        path_ms = e.time_ms(lambda: solve_batch_latency(*full_args))
        twin_ms = e.time_ms(lambda: ks.solve_fused_whole(*full_args))
        e.log(f"{sfx[1:]} at N={long_n} (B={batch}, f32): stream.cu {l_ms:.3f} ms for "
              f"{LONG_PLAIN_TRIPS} trips; the whole path (solve_batch_latency, past "
              f"{stream_horizon(u)} stages) {path_ms:.3f} ms, solve.cu on the same inputs "
              f"{twin_ms:.3f} ms {card}")
        passes, probes, applies = l_work
        entries[f"stream{sfx}"].update(
            ms=l_ms, plain_ms=l_plain_ms,
            shape=dict(B=batch, N=long_n, dtype="float32", trips=LONG_PLAIN_TRIPS),
            work=((passes * riccati_flops(ju_nnz)
                   + (probes + applies) * rollout_flops(u, sfx == "_wrench")) * long_n,
                  2 * (13 + u) * batch * long_n * 4),
            full_width=dict(B=batch, N=long_n, ms=path_ms, whole_twin_ms=twin_ms),
        )

    # ---- the families' main path through the batch solvers, counted ----
    e.reset_counts()
    out = {}
    for sfx, *_ in FAMILY_CASES:
        out[sfx, "solve"] = solve_batch_latency(*mains[sfx], DT, fam_opts)
        out[sfx, "per-pass"] = solve_batch_fused(*mains[sfx], DT, fam_opts)
        out[sfx, "stream"] = solve_batch_latency(*longs[sfx], DT, fam_opts)
    torch.cuda.synchronize()
    fam = e.family_counts()
    e.log(f"model families main path launches: {fam}")
    names = [f"{k}{sfx}" for sfx, *_ in FAMILY_CASES for k in ("backward", "rollout", "solve",
                                                                "stream")]
    e.check(all(fam.get(name, 0) > 0 for name in names), f"a family kernel never ran: {fam}")
    for (sfx, route), r in out.items():
        n_ = long_n if route == "stream" else n
        u = dict((s, uu) for s, uu, *_ in FAMILY_CASES)[sfx]
        ok = (r.trajectory.controls.shape == (batch, n_, u)
              and bool(torch.isfinite(r.cost).all() and torch.isfinite(r.trajectory.controls).all()))
        e.log(f"{sfx[1:]} via {route} (B={batch}, N={n_}, f32): converged "
              f"{float((r.status == ilqr.STATUS_CONVERGED).float().mean()):.4f}, mean iterations "
              f"{float(r.iterations.float().mean()):.3f}, statuses "
              f"{torch.bincount(r.status, minlength=3).tolist()}, shapes and finite {ok}")
        e.check(ok, f"{sfx[1:]} via {route}: wrong shapes or non-finite")
    for sfx, *_ in FAMILY_CASES:
        agree = float((out[sfx, "solve"].status == out[sfx, "per-pass"].status).float().mean())
        e.log(f"{sfx[1:]}: the two exact routes agree on {agree:.4f} of statuses (>= 0.99)")
        e.check(agree >= 0.99, f"{sfx[1:]}: the exact routes disagree")
    for name in names:
        entries[name]["launches"] = fam[name]
    e.log(f"model families phase took {time.perf_counter() - t_phase:.1f} s")
    return entries


# Phase 6d's plain checks, cut in depth (the plain loops set the script's
# time; with a box a plain trip costs ~5x an unconstrained one, the box-QP
# in every stage): the float64 FDDP variants for their first trips (box and
# weights together for more: (box, weights, both)), stream.cu's float64
# variant and the full-width float32 launches for a trip budget each
VARIANT_GN_TRIPS = (2, 2, 3)
VARIANT_DDP_TRIPS = 1
VARIANT_STREAM_TRIPS = 1
C6W_PLAIN_TRIPS = (4, 2)  # config 6 with w_T: the Gauss-Newton launch, the exact-DDP one
BOX_LONG_PLAIN_TRIPS = 1  # the long paths with limits (N=1024, N=512)
# the tumbling fleet the robust MPC recovers (tests/test_mpc.py:154-189 of
# the JAX package): fleet, ticks, horizon
TUMBLE_FLEET, TUMBLE_TICKS, TUMBLE_HORIZON = 128, 6, 16


def robust_variants_phase(env):
    """Phase 6d: control limits and stage weights on fddp.cu, stream_fddp.cu
    and stream.cu. Each new instantiation against its plain version in
    float64 lane for lane up to ties (the FDDP kernels' box, weights and
    both at B=300, N=40, Gauss-Newton for VARIANT_GN_TRIPS trips, exact DDP
    for VARIANT_DDP_TRIPS at the DDP engines' bar; stream.cu's box and
    weights at B=128, N=300 for VARIANT_STREAM_TRIPS), stream_fddp.cu
    against fddp.cu and stream.cu bit-equal to solve.cu at N=256; then the
    main path at full width,
    float32, counted: `QuadrotorILQR(solver="fddp", stage_weights=...)` on
    config 6 with w_T = 20, the long-horizon problem with rotor limits and
    w_T = 20 (exact N=1024 on stream.cu, robust N=512 on stream_fddp.cu),
    `run_mpc(solver="fddp")` on config 4 with its limits and terminal
    weight at fleets 32 and 128, and the tumbling fleet; each launch held
    against its plain loop for a trip budget (BOX_LONG_PLAIN_TRIPS for the
    long paths), every control in its box, the tumbling fleet's bars; the
    times. Returns the new rows' fields and the phase's numbers."""
    import numpy as np
    import torch

    from quadrotorilqr_tpu_torch import convert
    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import mpc, workloads
    from quadrotorilqr_tpu_torch.costs.quadratic import QuadraticTrackingCost
    from quadrotorilqr_tpu_torch.kernels import fddp as kf
    from quadrotorilqr_tpu_torch.kernels import solve as ks
    from quadrotorilqr_tpu_torch.kernels import stream as kst
    from quadrotorilqr_tpu_torch.kernels import stream_fddp as ksf
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.solver import constrained, fddp, ilqr
    from quadrotorilqr_tpu_torch.solver.batched import (
        _with_max_iters,
        resolve_refine_auto,
        solve_batch_fddp,
        solve_batch_latency,
    )
    from quadrotorilqr_tpu_torch.solver.options import (
        ConvergenceCriteria,
        ILQROptions,
        LineSearchParams,
    )

    e = env
    dev, card = e.dev, e.card
    f64, f32 = torch.float64, torch.float32
    t_phase = time.perf_counter()
    fo = fddp.FDDPOptions()
    rows = {}  # JSON row name -> its fields
    f, word = FLOPS, 4  # float32 at full width

    def stream_work(n_, b_, passes, probes, applies):
        """stream.cu with limits and weights: every backward pass, probe
        sweep and apply sweep; (flops, bytes), the bounds and weights read
        once."""
        riccati = f["riccati"] + f["box_extra"] + f["weights_extra"]
        rollout = f["rollout"] + f["rollout_box_extra"] + f["rollout_weights_extra"]
        return ((passes * riccati + (probes + applies) * rollout) * n_,
                2 * 17 * b_ * n_ * word + 6 * b_ * word + (8 + n_) * word)

    def fddp_work(n_, b_, launches_, box, weights, outputs):
        """An FDDP launch (or launches) with the variants: every trip
        transports the gradient and runs the Riccati stage and the model
        terms; defects on the trips that computed them; every probe and
        apply sweep; the seed cost once. `launches_` lists (trips, probe
        sweeps, defect trips, apply sweeps), Gauss-Newton only."""
        riccati = f["riccati"] + (f["box_extra"] if box else 0) + (f["weights_extra"] if weights else 0)
        model = f["model"] + (f["model_weights_extra"] if weights else 0)
        gap = f["gap_rollout"] + (f["rollout_box_extra"] if box else 0) + (
            f["rollout_weights_extra"] if weights else 0)
        flops = sum(n_ * (trips * (f["transport"] + riccati + model) + defect_trips * f["defect"]
                          + (sweeps + applies) * gap)
                    for trips, sweeps, defect_trips, applies in launches_)
        flops += b_ * n_ * (f["stage_cost"] + (1 if weights else 0))
        extra = ((8 if box else 0) + (n_ if weights else 0)) * word
        return flops, 2 * 17 * b_ * n_ * word + outputs * b_ * word + extra

    def rel(a, b):
        return (a - b).abs() / b.abs()

    def lanes(got, ref):
        """(statuses and iterations equal, max rel cost, max |du|)."""
        same = bool((got[3] == ref[3]).all() and (got[2] == ref[2]).all())
        return same, float(rel(got[1], ref[1]).max()), max_abs(got[0].controls, ref[0].controls)

    def ddp_bar(got, ref):
        """The JAX package's bar between its DDP engines
        (tests/test_fddp_fused.py:382-416), a tie (`ties`) counted as
        agreeing."""
        same, tie = ties(got, ref)
        strict = same & (ref[3] == ilqr.STATUS_CONVERGED)
        r = rel(got[1], ref[1])
        du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
        return (float(((got[3] == ref[3]) | tie).float().mean()) >= 0.98
                and float((same | tie).float().mean()) >= 0.95 and float(r.max()) < 2e-4
                and (not bool(strict.any()) or (float(r[strict].max()) <= 1e-8
                                                and float(du[strict].max()) <= 1e-4)))

    def in_box(u, limits):
        """(every control in its box, controls on a bound)."""
        lo, hi = constrained.prep_limits(limits, u.shape[0], u.dtype, u.device, 4)
        lo, hi = (b[:, None] if b.ndim == 2 else b for b in (lo, hi))
        return bool(((u >= lo) & (u <= hi)).all()), int(((u == lo) | (u == hi)).sum())

    def lanes_finite(r):
        """(B,) bool: the lanes whose cost and controls are finite."""
        cost, controls = (r.cost, r.trajectory.controls) if hasattr(r, "cost") else (r[1], r[0].controls)
        return torch.isfinite(cost) & torch.isfinite(controls).flatten(1).all(1)

    def ties(got, ref):
        """(same, tie), (B,) bool each: status and iterations equal, or not
        with the final cost equal to 1e-12. With a box (and with exact DDP)
        a lane can reach a step whose predicted change is at the rounding of
        its cost; whether the search takes it is the rounding's call, in the
        plain loop as in the kernels (PERF.md section 6): the lane
        ends on the same solution, its status, iterations, mu and counts
        told differently."""
        same = (got[3] == ref[3]) & (got[2] == ref[2])
        return same, ~same & ((got[1] - ref[1]).abs() <= 1e-12 * ref[1].abs())

    def cut_bars(got, ref, lanes_=None):
        """PERF.md section 2's bars for runs cut at a trip budget: the 99th
        percentiles of the relative cost and of each lane's max |du| over
        the largest |u| within 1e-3. Returns (ok, median, q99, du q99,
        status agreement)."""
        keep = slice(None) if lanes_ is None else lanes_
        r = rel(got[1], ref[1])[keep].double()
        du = (got[0].controls - ref[0].controls).abs().flatten(1).amax(1)[keep].double()
        du = du / float(ref[0].controls.abs().max())
        finite = bool(torch.isfinite(got[1]).all() and torch.isfinite(got[0].controls).all())
        q99, dq99 = float(torch.quantile(r, 0.99)), float(torch.quantile(du, 0.99))
        agree = float((got[3] == ref[3])[keep].float().mean())
        return finite and q99 <= 1e-3 and dq99 <= 1e-3, float(r.median()), q99, dq99, agree

    # ---- float64, lane for lane: the FDDP kernels' variants at B=300, N=40 ----
    # tests/test_fddp_fused.py's mixed problem (even lanes benign at scale
    # 0.4, odd lanes an aggressive tumble at 1.8), dt 0.12, with per-scenario
    # bounds around the hover thrust and per-scenario weights U(0.5, 2) with
    # a terminal weight of 20
    mix_dt, batch, n = 0.12, 300, 40
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.where(torch.arange(batch, device=dev) % 2 == 0, 0.4, 1.8)[:, None]
    m_params, m_q, m_r, x0, desired = workloads.aggressive_tumble(
        gen, batch, n=n, dt_s=mix_dt, scale=scale.double(), dtype=f64, device=dev)
    m_trajs = initial_trajectory_from_state(x0, desired)
    rng = np.random.default_rng(11)
    hover = 9.81 / 4
    bounds = (torch.as_tensor(hover - rng.uniform(0.5, 1.5, size=(batch, 4)), device=dev),
              torch.as_tensor(hover + rng.uniform(0.5, 1.5, size=(batch, 4)), device=dev))
    w = rng.uniform(0.5, 2.0, size=(batch, n))
    w[:, -1] = 20.0
    w = torch.as_tensor(w, device=dev)
    f_cases = {"box": (bounds, None), "weights": (None, w), "box and weights": (bounds, w)}
    f_err = {}
    for (name, (limits, weights)), gn_trips in zip(f_cases.items(), VARIANT_GN_TRIPS):
        cost = QuadraticTrackingCost(Q=m_q, R=m_r, desired_states=desired.states,
                                     desired_controls=desired.controls, stage_weights=weights)
        for ddp, trips in ((False, gn_trips), (True, VARIANT_DDP_TRIPS)):
            opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-9, 1e-9, trips))
            args = (m_params, cost, m_trajs, mix_dt, opts, fo)
            ref, plain_ms = e.time_once(
                lambda: kf.solve_fddp_whole_reference(*args, ddp, limits=limits))
            got = kf.solve_fddp_fused(*args, ddp=ddp, limits=limits, return_mu=True,
                                      return_probes=True)
            got_s = ksf.solve_fddp_streamed(*args, ddp=ddp, limits=limits, return_mu=True,
                                            return_probes=True)
            torch.cuda.synchronize()
            # a tie (`ties`) ends on the same cost with other bookkeeping;
            # every other lane is held lane for lane
            same, tie = ties(got, ref)
            r_max = float(rel(got[1], ref[1]).max())
            du = max_abs(got[0].controls, ref[0].controls)
            counts = int(((got[5] != ref[5]) | (got[6] != ref[6])).sum())
            t_same, t_tie = ties(got_s, got)
            twin_r, twin_du = float(rel(got_s[1], got[1]).max()), max_abs(got_s[0].controls,
                                                                          got[0].controls)
            twins = bit_equal(got_s, got)
            boxed = [in_box(k[0].controls, limits) for k in (got, got_s)] if limits else []
            # the box lets controls along directions the cost barely sees
            # settle ~1e-7 apart with the costs equal to the rounding:
            # controls within 1e-6 (1e-7 without the variants)
            ok = (ddp_bar(got, ref) if ddp else
                  bool((same | tie).all()) and r_max <= 1e-8 and du <= 1e-6)
            # the twins: bit-equal in Gauss-Newton; with exact DDP (whose
            # closed forms the two team sizes evaluate in different orders)
            # every lane the same or a tie, cost within 1e-12
            twin_ok = twins if not ddp else (bool((t_same | t_tie).all()) and twin_r <= 1e-12
                                             and twin_du <= 1e-6)
            e.log(f"f64 fddp.cu, {name}, {'exact DDP' if ddp else 'Gauss-Newton'} (B={batch}, "
                  f"N={n}, {trips} trips) vs plain: statuses and iterations equal on "
                  f"{int(same.sum())} lanes, ties {int(tie.sum())}, max rel cost {r_max:.3e} (rtol "
                  f"1e-8), max |du| {du:.3e} (atol 1e-6){' (held at the DDP engines bar)' if ddp else ''}"
                  f": {ok}; lanes with other probe sweeps or defect trips {counts}; stream_fddp.cu "
                  f"vs fddp.cu: bit-equal {twins}, same {int(t_same.sum())}, ties {int(t_tie.sum())}, "
                  f"({twin_r:.3e}, {twin_du:.3e}): {twin_ok}; every control in its box, on a bound "
                  f"{boxed}; statuses {torch.bincount(ref[3], minlength=3).tolist()}; plain loop "
                  f"{plain_ms:.1f} ms")
            e.check(ok and twin_ok and all(b[0] for b in boxed),
                    f"f64 FDDP kernels with {name} (ddp={ddp}) disagree with plain or each other")
            f_err[(name, ddp)] = du
    # ---- float64: stream.cu's variant at B=128, N=300 and N=256 ----
    def exact_problem(seed, b_, n_):
        p_np, c_np, t_np = np_problem(seed, b_, n_)
        return (convert.params_from_numpy(p_np, f64, dev), convert.cost_from_numpy(c_np, f64, dev),
                convert.trajectory_from_numpy(t_np, f64, dev))

    s_batch, s_n = 128, 300
    s_params, s_cost, s_traj = exact_problem(12, s_batch, s_n)
    rng = np.random.default_rng(13)
    s_hover = 1.3 * 9.81 / 4
    s_bounds = (torch.as_tensor(s_hover - rng.uniform(0.3, 0.8, size=(s_batch, 4)), device=dev),
                torch.as_tensor(s_hover + rng.uniform(0.3, 0.8, size=(s_batch, 4)), device=dev))
    s_w = torch.as_tensor(rng.uniform(0.5, 2.0, size=(s_batch, s_n)), device=dev)
    s_w[:, -1] = 20.0
    s_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-8, 1e-8, 10))
    c = dataclasses.replace(s_cost, stage_weights=s_w)
    opts = _with_max_iters(s_opts, VARIANT_STREAM_TRIPS)
    got = kst.solve_fused_streamed(s_params, c, s_traj, DT, opts, limits=s_bounds,
                                   return_probes=True)
    ref, plain_ms = e.time_once(
        lambda: kst.solve_streamed_reference(s_params, c, s_traj, DT, opts, limits=s_bounds))
    torch.cuda.synchronize()
    strict, r_max, du = lanes(got, ref)
    counts = all(bool((g == r).all()) for g, r in zip(got[4:], ref[4:]))
    boxed = in_box(got[0].controls, s_bounds)
    e.log(f"f64 stream.cu, box and weights (B={s_batch}, N={s_n}, {VARIANT_STREAM_TRIPS} trips) "
          f"vs plain: statuses and iterations equal {strict}, max rel cost {r_max:.3e} (rtol "
          f"1e-8), max |du| {du:.3e} (atol 1e-7), backward passes, probe and apply sweeps equal "
          f"{counts}; every control in its box {boxed[0]}, {boxed[1]} on a bound; plain loop "
          f"{plain_ms:.1f} ms")
    e.check(strict and r_max <= 1e-8 and du <= 1e-7 and counts and boxed[0],
            "f64 stream.cu with limits and weights disagrees with plain")
    rows["stream"] = dict(f64_err=du, f64_shape=(s_batch, s_n))
    t_params, t_cost, t_traj = exact_problem(14, s_batch, 256)
    t_cost = dataclasses.replace(t_cost, stage_weights=s_w[:, :256].contiguous())
    got = kst.solve_fused_streamed(t_params, t_cost, t_traj, DT, s_opts, limits=s_bounds)
    whole = ks.solve_fused_whole(t_params, t_cost, t_traj, DT, s_opts, limits=s_bounds)
    torch.cuda.synchronize()
    bits = bit_equal(got, whole)
    e.log(f"f64 stream.cu with limits and weights bit-equal to solve.cu's at N=256 (B={s_batch}, "
          f"10 iterations): {bits}; statuses {torch.bincount(whole[3], minlength=3).tolist()}")
    e.check(bits, "f64 stream.cu with limits and weights differs from solve.cu's at N=256")
    rows["fddp"] = dict(f64_err=f_err[("box and weights", False)], f64_shape=(batch, n))
    rows["stream_fddp"] = dict(f64_err=f_err[("box and weights", False)], f64_shape=(batch, n))
    rows["fddp_weights"] = dict(f64_err=f_err[("weights", False)], f64_shape=(batch, n))

    # ---- float32 at full width: the main path, counted ----
    # config 6 (the aggressive tumble, B=4096, N=50) with w_T = 20 through
    # the robust API (refine="auto": a Gauss-Newton launch and an exact-DDP
    # launch of fddp.cu's weights variant)
    r_batch, r_n, r_dt = 4096, 50, 0.1
    gen = torch.Generator(device=dev).manual_seed(0)
    r_params, r_q, r_r, x0, r_desired = workloads.aggressive_tumble(
        gen, r_batch, n=r_n, dt_s=r_dt, dtype=f32, device=dev)
    r_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 40))
    w_t = workloads.terminal_weights(r_n, f32, dev)
    robust = QuadrotorILQR(
        float(r_params.mass_kg), r_params.inertia, float(r_params.arm_length_m),
        float(r_params.torque_to_thrust_ratio_m), float(r_params.g_mpss), r_q, r_r, r_desired,
        r_dt, r_opts, dtype=f32, device=dev, solver="fddp", stage_weights=w_t)
    r_trajs = initial_trajectory_from_state(x0, r_desired)
    bounds_, flags = resolve_refine_auto(40, False)
    switch = ((0,) + bounds_)[flags.index(True)]
    # the long-horizon problem with rotor limits (0, 1.3 x hover) and w_T = 20
    lh_batch, lh_n, rl_n = 4096, 1024, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    lh_params, lh_cost, lh_trajs = workloads.long_horizon_problem(gen, lh_batch, lh_n, f32, DT, dev)
    lh_cost = dataclasses.replace(lh_cost,
                                  stage_weights=workloads.terminal_weights(lh_n, f32, dev))
    lh_limits = workloads.long_horizon_limits()
    lh_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10))
    gen = torch.Generator(device=dev).manual_seed(1)
    rl_params, rl_cost, rl_trajs = workloads.long_horizon_problem(gen, lh_batch, rl_n, f32, DT, dev)
    rl_cost = dataclasses.replace(rl_cost,
                                  stage_weights=workloads.terminal_weights(rl_n, f32, dev))
    rl_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 12))
    r_fo = fddp.FDDPOptions(gap_tol=1e-5)
    # config 4 with its limits and terminal weight through the robust MPC loop
    def mpc_problem(fleet):
        return workloads.mpc_hover_problem(np.random.default_rng(4), fleet, MPC_HORIZON, MPC_TICKS,
                                           MPC_DT, f32, dev)

    def run_robust_mpc(pb, ticks):
        return mpc.run_mpc(pb.params, pb.q, pb.r, pb.desired, pb.x0, ticks, MPC_HORIZON, MPC_DT,
                           pb.options, stage_weights=pb.stage_weights, limits=pb.limits,
                           solver="fddp", plant_params=pb.plant)

    tb = workloads.tumble_mpc_problem(torch.Generator(device=dev).manual_seed(2), TUMBLE_FLEET,
                                      TUMBLE_TICKS, TUMBLE_HORIZON, device=dev)

    def run_tumble(solver):
        return mpc.run_mpc(tb.params, tb.q, tb.r, tb.desired, tb.x0, TUMBLE_TICKS, TUMBLE_HORIZON,
                           0.1, tb.options, latency_kernel=True, solver=solver)

    mpc_pbs = {fleet: mpc_problem(fleet) for fleet in MPC_FLEETS[1:]}
    e.reset_counts()
    res_c6 = robust.solve_batch(r_trajs)
    res_long = solve_batch_latency(lh_params, lh_cost, lh_trajs, DT, lh_opts, limits=lh_limits)
    res_rl = solve_batch_fddp(rl_params, rl_cost, rl_trajs, DT, rl_opts, r_fo, refine="auto",
                              limits=lh_limits)
    mpc_out = {fleet: run_robust_mpc(pb, MPC_TICKS) for fleet, pb in mpc_pbs.items()}
    tumble_fddp = run_tumble("fddp")
    torch.cuda.synchronize()
    launches = e.family_counts()
    e.log(f"robust and long variants main path launches, by instantiation: "
          f"{ {k: v for k, v in launches.items() if v} }")
    want = {"fddp_weights": 2, "stream_box_weights": 1, "stream_fddp_box_weights": 2}
    e.check(all(launches.get(k, 0) == v for k, v in want.items())
            and launches.get("fddp_box_weights", 0) == MPC_TICKS * len(mpc_pbs)
            and launches.get("fddp", 0) == TUMBLE_TICKS,
            f"a variant of the robust and long paths did not run as scheduled: {launches}")
    tumble_exact = run_tumble("ilqr")
    torch.cuda.synchronize()

    def conv(r):
        s = r.status if hasattr(r, "status") else r[3]
        return float((s == ilqr.STATUS_CONVERGED).float().mean())

    def iters(r):
        return float((r.iterations if hasattr(r, "iterations") else r[2]).float().mean())

    # config 6 with w_T: finite, then each launch against the plain loop on
    # the same inputs and resume rows for a trip budget
    finite = all(bool(torch.isfinite(a).all()) for a in (res_c6.cost, res_c6.trajectory.controls))
    e.log(f"config 6 with w_T = 20 via QuadrotorILQR(solver='fddp', stage_weights).solve_batch "
          f"(f32, B={r_batch}, N={r_n}): finite {finite}, converged {conv(res_c6):.4f}, mean "
          f"iterations {iters(res_c6):.3f}, statuses "
          f"{torch.bincount(res_c6.status, minlength=3).tolist()}")
    e.check(finite and res_c6.cost.shape == (r_batch,), "config 6 with w_T: non-finite or wrong shape")
    c6_args = (robust.params, robust.cost)
    gn_cut, ddp_cut = (_with_max_iters(r_opts, t) for t in C6W_PLAIN_TRIPS)
    gn_k = kf.solve_fddp_fused(*c6_args, r_trajs, r_dt, _with_max_iters(r_opts, switch), r_fo,
                               return_mu=True, return_probes=True)
    gn_kc = kf.solve_fddp_fused(*c6_args, r_trajs, r_dt, gn_cut, r_fo, return_mu=True,
                                return_probes=True)
    gn_p, c6_gn_plain_ms = e.time_once(lambda: kf.solve_fddp_whole_reference(
        *c6_args, r_trajs, r_dt, gn_cut, r_fo))
    c6_rows = dict(initial_mu=gn_k[4], initial_status=gn_k[3], initial_iters=gn_k[2])
    ddp_kc = kf.solve_fddp_fused(*c6_args, gn_k[0], r_dt, ddp_cut, r_fo, ddp=True, return_mu=True,
                                 return_probes=True, **c6_rows)
    ddp_p, c6_ddp_plain_ms = e.time_once(lambda: kf.solve_fddp_whole_reference(
        *c6_args, gn_k[0], r_dt, ddp_cut, r_fo, True, gn_k[4], gn_k[3], gn_k[2]))
    torch.cuda.synchronize()
    live = gn_k[3] == 0
    c6_err = 0.0
    for what, k_out, p_out, keep in (("Gauss-Newton", gn_kc, gn_p, None),
                                     ("exact-DDP", ddp_kc, ddp_p, live)):
        ok, med, q99, dq99, agree = cut_bars(k_out, p_out, keep)
        if keep is None:
            c6_err = max_abs(k_out[0].controls, p_out[0].controls)
        e.log(f"f32 fddp.cu weights variant, config 6 with w_T, its {what} launch's first "
              f"{C6W_PLAIN_TRIPS[what != 'Gauss-Newton']} trips vs plain"
              f"{' (resumed; the pending lanes)' if keep is not None else ''}: rel cost median "
              f"{med:.3e}, 99th percentile {q99:.3e} (<= 1e-3), lanes' max |du| / max |u| 99th "
              f"percentile {dq99:.3e} (<= 1e-3), status agreement {agree:.4f}")
        e.check(ok, f"f32 fddp.cu weights variant ({what} launch) outside its bounds")
    # the long exact path with limits and w_T on stream.cu. A lane whose line
    # search runs out keeps the candidate of the alpha it last tried (the
    # reference's semantics), non-finite where the float32 box-QP met an
    # indefinite Q_uu: every finite lane's controls lie in the box, and
    # every non-finite lane failed its search
    finite_l = lanes_finite(res_long)
    boxed = in_box(res_long.trajectory.controls[finite_l], lh_limits)
    failed_ok = bool((res_long.status[~finite_l] == ilqr.STATUS_LINE_SEARCH_FAILED).all())
    e.log(f"long horizon with limits {tuple(round(b, 4) for b in lh_limits)} and w_T = 20 via "
          f"solve_batch_latency (stream.cu, f32, B={lh_batch}, N={lh_n}): {int((~finite_l).sum())} "
          f"non-finite lanes, all LINE_SEARCH_FAILED {failed_ok}; every control of the others in "
          f"its box {boxed[0]} ({boxed[1]} on a bound), converged {conv(res_long):.4f}, mean "
          f"iterations {iters(res_long):.3f}, statuses "
          f"{torch.bincount(res_long.status, minlength=3).tolist()}")
    e.check(failed_ok and boxed[0], "long exact path with limits and w_T: out of box, or a "
            "non-finite lane that did not fail its line search")
    lp_opts = _with_max_iters(lh_opts, BOX_LONG_PLAIN_TRIPS)
    lp_args = (lh_params, lh_cost, lh_trajs, DT, lp_opts)
    lp_k = kst.solve_fused_streamed(*lp_args, limits=lh_limits, return_probes=True)
    lp_p, long_plain_ms = e.time_once(
        lambda: kst.solve_streamed_reference(*lp_args, limits=lh_limits))
    torch.cuda.synchronize()
    # float32 with a box over 1,024 stages: the box-QP's active sets flip
    # with the rounding, and a few lanes of any two float32 engines depart
    # by O(1) (PERF.md section 6; in float64 they agree lane for lane
    # above), so the bar is the float32 whole-run one, status agreement and
    # the median
    _, med, q99, dq99, agree = cut_bars(lp_k, lp_p)
    ok = agree >= 0.99 and med < 1e-3 and lanes_finite(lp_k).all()
    boxed = in_box(lp_k[0].controls, lh_limits)
    e.log(f"f32 stream.cu box and weights vs plain on the long exact path's inputs (first "
          f"{BOX_LONG_PLAIN_TRIPS} trips): status agreement {agree:.4f} (>= 0.99), rel cost median "
          f"{med:.3e} (< 1e-3), 99th percentile {q99:.3e}, lanes' max |du| / max |u| 99th "
          f"percentile {dq99:.3e}; in its box {boxed[0]}; (backward passes, probe sweeps, apply "
          f"sweeps) kernel {[int(a.sum()) for a in lp_k[4:]]}, plain "
          f"{[int(a.sum()) for a in lp_p[4:]]}; plain loop {long_plain_ms:.1f} ms")
    e.check(ok and boxed[0], "f32 stream.cu with limits and weights outside its bounds at N=1024")
    rows["stream"].update(max_abs_err=max_abs(lp_k[0].controls, lp_p[0].controls),
                          plain_ms=long_plain_ms, shape=(lh_batch, lh_n),
                          work=stream_work(lh_n, lh_batch, *(int(a.sum()) for a in lp_k[4:])))
    rows["fddp_weights"].update(max_abs_err=c6_err, plain_ms=c6_gn_plain_ms, shape=(r_batch, r_n),
                                work=fddp_work(r_n, r_batch, [(int(gn_kc[2].sum()),
                                                              float(gn_kc[5].sum()),
                                                              int(gn_kc[6].sum()), 0)], False,
                                               True, 6))
    # the long robust path with limits and w_T on stream_fddp.cu
    finite = all(bool(torch.isfinite(a).all()) for a in (res_rl.cost, res_rl.trajectory.controls))
    boxed = in_box(res_rl.trajectory.controls, lh_limits)
    e.log(f"long horizon with limits and w_T via solve_batch_fddp(refine='auto') (stream_fddp.cu, "
          f"f32, B={lh_batch}, N={rl_n}): finite {finite}, every control in its box {boxed[0]} "
          f"({boxed[1]} on a bound), converged {conv(res_rl):.4f}, mean iterations "
          f"{iters(res_rl):.3f}")
    e.check(finite and boxed[0], "long robust path with limits and w_T: non-finite or out of box")
    lr_args = (rl_params, rl_cost, rl_trajs, DT, _with_max_iters(rl_opts, BOX_LONG_PLAIN_TRIPS),
               r_fo)
    lr_k = ksf.solve_fddp_streamed(*lr_args, limits=lh_limits, return_mu=True, return_probes=True)
    lr_p, rl_plain_ms = e.time_once(
        lambda: ksf.solve_fddp_streamed_reference(*lr_args, limits=lh_limits))
    torch.cuda.synchronize()
    ok, med, q99, dq99, agree = cut_bars(lr_k, lr_p)
    boxed = in_box(lr_k[0].controls, lh_limits)
    rl_work = (int(lr_k[2].sum()), float(lr_k[5].sum()), int(lr_k[6].sum()), int(lr_k[7].sum()))
    e.log(f"f32 stream_fddp.cu box and weights vs plain on the long robust path's inputs (first "
          f"{BOX_LONG_PLAIN_TRIPS} Gauss-Newton trips): rel cost median {med:.3e}, 99th percentile "
          f"{q99:.3e} (<= 1e-3), lanes' max |du| / max |u| 99th percentile {dq99:.3e} (<= 1e-3), "
          f"status agreement {agree:.4f}; in its box {boxed[0]}; (trips, probe sweeps, defect "
          f"trips, apply sweeps) {rl_work}; plain loop {rl_plain_ms:.1f} ms")
    e.check(ok and boxed[0], "f32 stream_fddp.cu with limits and weights outside its bounds")
    rows["stream_fddp"].update(max_abs_err=max_abs(lr_k[0].controls, lr_p[0].controls),
                               plain_ms=rl_plain_ms, shape=(lh_batch, rl_n),
                               work=fddp_work(rl_n, lh_batch, [rl_work], True, True, 7))
    # the robust MPC loop on config 4: controls in the box, then its first
    # window's solve (fddp.cu's box and weights variant) against plain
    for fleet, out in mpc_out.items():
        u = out["u"]
        boxed = in_box(u.reshape(fleet, -1, 4), mpc_pbs[fleet].limits)
        x0_err = float(mpc_pbs[fleet].x0.pose.trans.norm(dim=-1).mean())
        final_err = float(out["x_final"].pose.trans.norm(dim=-1).mean())
        e.log(f"config 4 with limits and w_T via run_mpc(solver='fddp'), fleet {fleet}: controls "
              f"in [{float(u.min()):.4f}, {float(u.max()):.4f}], every one in its box {boxed[0]} "
              f"({boxed[1]} on a bound), mean iterations a tick "
              f"{float(out['iterations'].float().mean()):.3f}, statuses "
              f"{torch.bincount(out['status'].flatten(), minlength=3).tolist()}, mean final "
              f"position error {final_err:.4f} m from {x0_err:.4f} m")
        e.check(boxed[0] and bool(torch.isfinite(u).all()),
                f"robust MPC at fleet {fleet}: non-finite or out-of-box controls")
    pb = mpc_pbs[MPC_FLEETS[-1]]
    win = mpc._window(pb.desired, 0, MPC_HORIZON)
    w_cost = QuadraticTrackingCost(Q=pb.q, R=pb.r, desired_states=win.states,
                                   desired_controls=win.controls, stage_weights=pb.stage_weights)
    warm = mpc.mpc_warm_start(pb.desired, pb.x0, MPC_HORIZON)
    m_args = (pb.params, w_cost, warm, MPC_DT, pb.options, fo)
    m_k = kf.solve_fddp_fused(*m_args, limits=pb.limits, return_mu=True, return_probes=True)
    m_p, m_plain_ms = e.time_once(lambda: kf.solve_fddp_whole_reference(*m_args,
                                                                        limits=pb.limits))
    torch.cuda.synchronize()
    ok, med, q99, dq99, agree = cut_bars(m_k, m_p)
    boxed = in_box(m_k[0].controls, pb.limits)
    m_work = (int(m_k[2].sum()), float(m_k[5].sum()), int(m_k[6].sum()), 0)
    e.log(f"f32 fddp.cu box and weights vs plain on config 4's first window (B={MPC_FLEETS[-1]}, "
          f"N={MPC_HORIZON}, {pb.options.convergence_criteria.max_iters} trips): rel cost median "
          f"{med:.3e}, 99th percentile {q99:.3e} (<= 1e-3), lanes' max |du| / max |u| 99th "
          f"percentile {dq99:.3e} (<= 1e-3), status agreement {agree:.4f}; in its box {boxed[0]}; "
          f"(trips, probe sweeps, defect trips) {m_work[:3]}; plain loop {m_plain_ms:.1f} ms")
    e.check(ok and boxed[0], "f32 fddp.cu with limits and weights outside its bounds")
    rows["fddp"].update(max_abs_err=max_abs(m_k[0].controls, m_p[0].controls), plain_ms=m_plain_ms,
                        shape=(MPC_FLEETS[-1], MPC_HORIZON),
                        work=fddp_work(MPC_HORIZON, MPC_FLEETS[-1], [m_work], True, True, 6))
    # the tumbling fleet: the exact loop loses a share of it on the first
    # window, the robust loop recovers it (the JAX package's bars)
    exact_failed = float((tumble_exact["status"][:, 0] == ilqr.STATUS_LINE_SEARCH_FAILED)
                         .float().mean())
    rob_failed = int((tumble_fddp["status"] == ilqr.STATUS_LINE_SEARCH_FAILED).sum())
    finite = bool(torch.isfinite(tumble_fddp["cost"]).all() and torch.isfinite(tumble_fddp["u"]).all())
    w0 = float(tb.x0.vel[:, 3:6].norm(dim=-1).median())
    w1 = float(tumble_fddp["x_final"].vel[:, 3:6].norm(dim=-1).median())
    e.log(f"tumbling fleet ({TUMBLE_FLEET} vehicles, {TUMBLE_TICKS} ticks, H={TUMBLE_HORIZON}, dt "
          f"0.1, f32): the exact loop fails its line search on {exact_failed:.4f} of the first "
          f"window's lanes (> 0.1); run_mpc(solver='fddp'): {rob_failed} LINE_SEARCH_FAILED "
          f"lane-ticks (0), costs and controls finite {finite}, median body rate {w1:.4f} rad/s "
          f"from {w0:.4f} (lower); statuses "
          f"{torch.bincount(tumble_fddp['status'].flatten(), minlength=3).tolist()}")
    e.check(exact_failed > 0.1 and rob_failed == 0 and finite and w1 < w0,
            "the tumbling fleet: the robust MPC loop misses the JAX package's bars")

    # ---- the times (CUDA events, medians of 5) ----
    def measure_mpc(pb):
        """ms a tick over MPC_TICKS, host syncs a tick (torch's sync debug
        mode, over MPC_CHUNK ticks), the host-driven mpc_step loop's per-tick
        p50, p99, max (u0 read back each tick, the plant the model)."""
        ms_run = e.time_ms(lambda: run_robust_mpc(pb, MPC_TICKS), repeats=3)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run_robust_mpc(pb, MPC_CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught) / MPC_CHUNK
        x, warm_ = pb.x0, mpc.mpc_warm_start(pb.desired, pb.x0, MPC_HORIZON)
        ticks = []
        for k in range(MPC_TICKS):
            t0 = time.perf_counter()
            x, warm_, u0 = mpc.mpc_step(pb.params, pb.q, pb.r, pb.desired, x, warm_, k, MPC_HORIZON,
                                        MPC_DT, pb.options, stage_weights=pb.stage_weights,
                                        limits=pb.limits, solver="fddp")
            u0.cpu()
            if k:
                ticks.append((time.perf_counter() - t0) * 1e3)
        return dict(ms_tick=ms_run / MPC_TICKS, syncs=syncs,
                    host=[float(np.percentile(ticks, 50)), float(np.percentile(ticks, 99)),
                          max(ticks)])

    mpc_numbers = {}
    for fleet, pb_ in mpc_pbs.items():
        m = mpc_numbers[fleet] = measure_mpc(pb_)
        e.log(f"config 4 with limits and w_T via run_mpc(solver='fddp'), fleet {fleet}: "
              f"{m['ms_tick']:.4f} ms a tick over {MPC_TICKS} ticks, {m['syncs']:.2f} host syncs a "
              f"tick; host-driven mpc_step per tick p50 {m['host'][0]:.4f}, p99 "
              f"{m['host'][1]:.4f}, max {m['host'][2]:.4f} ms (H={MPC_HORIZON}, f32) {card}")
    times = {
        "c6": e.time_ms(lambda: robust.solve_batch(r_trajs)),
        "long": e.time_ms(lambda: solve_batch_latency(lh_params, lh_cost, lh_trajs, DT, lh_opts,
                                                      limits=lh_limits)),
        "long_robust": e.time_ms(lambda: solve_batch_fddp(rl_params, rl_cost, rl_trajs, DT, rl_opts,
                                                          r_fo, refine="auto", limits=lh_limits)),
        "fddp": e.time_ms(lambda: kf.solve_fddp_fused(*m_args, limits=pb.limits)),
        "fddp_free": e.time_ms(lambda: kf.solve_fddp_fused(
            pb.params, dataclasses.replace(w_cost, stage_weights=None), warm, MPC_DT, pb.options, fo)),
        "stream": e.time_ms(lambda: kst.solve_fused_streamed(*lp_args, limits=lh_limits)),
        "stream_free": e.time_ms(lambda: kst.solve_fused_streamed(
            lh_params, dataclasses.replace(lh_cost, stage_weights=None), lh_trajs, DT, lp_opts)),
        "stream_fddp": e.time_ms(lambda: ksf.solve_fddp_streamed(*lr_args, limits=lh_limits)),
        "stream_fddp_free": e.time_ms(lambda: ksf.solve_fddp_streamed(
            rl_params, dataclasses.replace(rl_cost, stage_weights=None), *lr_args[2:])),
        "c6_gn_cut": e.time_ms(lambda: kf.solve_fddp_fused(*c6_args, r_trajs, r_dt, gn_cut, r_fo)),
    }
    e.log(f"config 6 with w_T through the robust API: {times['c6']:.3f} ms per batch solve "
          f"(converged {conv(res_c6):.4f}, {r_batch / times['c6'] * 1e3:.1f} solves/s); its "
          f"Gauss-Newton launch's first {C6W_PLAIN_TRIPS[0]} trips {times['c6_gn_cut']:.3f} ms "
          f"(plain {c6_gn_plain_ms:.1f} ms); long exact with limits and w_T on stream.cu "
          f"{times['long']:.3f} ms (converged {conv(res_long):.4f}); long robust on "
          f"stream_fddp.cu {times['long_robust']:.3f} ms (converged {conv(res_rl):.4f}) {card}")
    for name in ("fddp", "stream", "stream_fddp"):
        shape = rows[name]["shape"]
        e.log(f"{name}.cu with limits and weights (B={shape[0]}, N={shape[1]}, f32, the calls held "
              f"against plain): {times[name]:.3f} ms, without either {times[name + '_free']:.3f} "
              f"ms; plain {rows[name]['plain_ms']:.1f} ms {card}")
        rows[name].update(ms=times[name], without_variants_ms=times[name + "_free"],
                          launches=launches.get(f"{name}_box_weights", 0))
    rows["fddp_weights"].update(ms=times["c6_gn_cut"], launches=launches.get("fddp_weights", 0))
    e.log(f"robust and long variants phase took {time.perf_counter() - t_phase:.1f} s")
    return rows, dict(mpc={str(k): v for k, v in mpc_numbers.items()},
                      times=times, c6_converged=conv(res_c6), long_converged=conv(res_long),
                      long_robust_converged=conv(res_rl), launches=launches,
                      tumble=dict(exact_failed=exact_failed, fddp_failed=rob_failed,
                                  body_rate=(w0, w1)))


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
            fn.launches.clear()

    def counts():
        return {name: fn.launches.total() for name, fn in wrappers.items()}

    def family_counts():
        """Launches per kernel instantiation, named as their C entries:
        backward, backward_wrench, ..."""
        return {f"{name}{sfx}": n for name, fn in wrappers.items()
                for sfx, n in fn.launches.items()}

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
    # the Gauss-Newton curvature over all 25 trips, the exact DDP one over
    # FDDP_DDP_PLAIN_TRIPS
    m_cases = {False: m_args,
               True: m_args[:4] + (_with_max_iters(m_opts, FDDP_DDP_PLAIN_TRIPS),)}
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

    for ddp, args in m_cases.items():
        got = kf.solve_fddp_fused(*args, fo, ddp=ddp)
        ref, plain_ms = time_once(lambda: kf.solve_fddp_whole_reference(*args, fo, ddp))
        m_refs[ddp] = (got, ref)
        torch.cuda.synchronize()
        same_status = (got[3] == ref[3]).float().mean().item()
        same_iters = (got[2] == ref[2]).float().mean().item()
        rel = ((got[1] - ref[1]).abs() / ref[1].abs())
        du = (got[0].controls - ref[0].controls).abs().amax((1, 2))
        conv = ref[3] == ilqr.STATUS_CONVERGED
        if not ddp:
            err["fddp"] = float(du.max())
        log(f"f64 FDDP ddp={ddp} B=300 N=40 ({args[4].convergence_criteria.max_iters} trips): "
            f"status equal {same_status:.4f}, iterations equal "
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
    for ddp, args in m_cases.items():
        got_w, ref = m_refs[ddp]
        got_s = ksf.solve_fddp_streamed(*args, fo, ddp=ddp)
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
    # the exact-DDP launch cut at its first C6_DDP_PLAIN_TRIPS trips, for
    # the plain loop
    ddp_cut = _with_max_iters(r_opts, C6_DDP_PLAIN_TRIPS)
    ddp_kc = kf.solve_fddp_fused(*rp_args, gn_k[0], r_dt, ddp_cut, r_fo, ddp=True,
                                 return_mu=True, return_probes=True, **rows)
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
        *rp_args, gn_k[0], r_dt, ddp_cut, r_fo, True, gn_k[4], gn_k[3], gn_k[2]))
    torch.cuda.synchronize()
    live = gn_k[3] == 0
    rel = (ddp_kc[1] - ddp_p[1]).abs() / ddp_p[1].abs()
    med = float(rel[live].median())
    conv_live = [float((r[3][live] == ilqr.STATUS_CONVERGED).float().mean())
                 for r in (ddp_kc, ddp_p)]
    log(f"f32 FDDP exact-DDP launch (its trips {switch}-{switch + C6_DDP_PLAIN_TRIPS}, resumed; "
        f"{int(live.sum())} lanes pending at the switch) vs plain loop on the same rows: converged "
        f"{conv_of(ddp_kc):.4f} vs {conv_of(ddp_p):.4f} (within 0.01; of the pending lanes "
        f"{conv_live[0]:.4f} vs {conv_live[1]:.4f}), status agreement of the pending lanes "
        f"{float((ddp_kc[3][live] == ddp_p[3][live]).float().mean()):.4f}, their median rel cost "
        f"diff {med:.3e} (< 1e-3), mean iterations {float(ddp_kc[2].float().mean()):.3f} vs "
        f"{float(ddp_p[2].float().mean()):.3f}")
    check(int(live.sum()) > 0 and abs(conv_of(ddp_kc) - conv_of(ddp_p)) <= 0.01 and med < 1e-3,
          "f32 FDDP exact-DDP launch outside its bounds")
    # what the two launches ran, for the bound: trips, probe sweeps, defect trips
    work_gn = (int(gn_k[2].sum()), float(gn_k[5].sum()), int(gn_k[6].sum()))
    work_ddp, work_ddp_cut = (
        (int((k[2] - gn_k[2]).sum()), float(k[5].sum()), int(k[6].sum())) for k in (ddp_k, ddp_kc)
    )
    log(f"the FDDP launches ran (trips, probe sweeps, defect trips): Gauss-Newton {work_gn}, "
        f"exact DDP {work_ddp}")
    # the streamed FDDP kernel on the same two launches, inputs and resume
    # rows, against the same plain results
    gn_s = ksf.solve_fddp_streamed(*rp_args, r_trajs, r_dt, gn_opts, r_fo, return_mu=True,
                                   return_probes=True)
    ddp_sc = ksf.solve_fddp_streamed(*rp_args, gn_k[0], r_dt, ddp_cut, r_fo, ddp=True, **rows)
    ddp_s = ksf.solve_fddp_streamed(*rp_args, gn_k[0], r_dt, ddp_opts, r_fo, ddp=True,
                                    return_mu=True, return_probes=True, **rows)
    torch.cuda.synchronize()
    for name, k_out, p_out, w_out, lanes in (
        ("Gauss-Newton", gn_s, gn_p, gn_k, torch.ones_like(live)), ("exact-DDP", ddp_sc, ddp_p, ddp_kc, live)
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
    # held against plain: the Gauss-Newton launch and the exact-DDP one cut
    # at the plain loop's trips (the two whole launches in `full_width`)
    ms["fddp_ddp_cut"] = time_ms(lambda: kf.solve_fddp_fused(
        *rp_args, gn_k[0], r_dt, ddp_cut, r_fo, ddp=True, **rows))
    per_kernel["fddp"] = (ms["fddp_gn"] + ms["fddp_ddp_cut"], plain_gn_ms + plain_ddp_ms)
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
        f"{plain_gn_ms:.3f} ms), exact DDP trips {switch}-40 {ms['fddp_ddp']:.3f} ms, its first "
        f"{C6_DDP_PLAIN_TRIPS} trips {ms['fddp_ddp_cut']:.3f} ms (plain {plain_ddp_ms:.3f} ms) "
        f"{card}")
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
        "fddp": (ms["fddp_gn"] + ms["fddp_ddp"], ms["stream_fddp_gn"] + ms["stream_fddp_ddp"], r_n),
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

    # ---- 6b. BASELINE config 4 and the box and weights variants ----
    variants = mpc_phase(SimpleNamespace(
        dev=dev, card=card, log=log, check=check, f64=(params, cost, traj, opts),
        bench=(b_params, b_cost, trajs1), time_once=time_once, time_ms=time_ms,
        launch_ms=launch_ms, reset_counts=reset_counts, counts=counts,
    ))
    mpc_numbers = variants.pop("_mpc")

    # ---- 6c. the wider-control model families ----
    families = families_phase(SimpleNamespace(
        dev=dev, card=card, log=log, check=check, time_once=time_once, time_ms=time_ms,
        launch_ms=launch_ms, reset_counts=reset_counts, family_counts=family_counts,
    ))

    # ---- 6d. limits and stage weights on the robust and long paths ----
    robust_rows, robust_numbers = robust_variants_phase(SimpleNamespace(
        dev=dev, card=card, log=log, check=check, time_once=time_once, time_ms=time_ms,
        reset_counts=reset_counts, family_counts=family_counts,
    ))

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
        "fddp": fddp_work(r_n, r_batch, [work_gn + (0,), work_ddp_cut + (0,)], 6),
        "stream": stream_work(lh_n, lh_batch, *long_plain_work),
        "stream_fddp": fddp_work(rl_n, lh_batch, rl_plain_work, 7),
    }
    full_work = {
        "fddp": fddp_work(r_n, r_batch, [work_gn + (0,), work_ddp + (0,)], 6),
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
    # the box and weights variants at config 4's shapes (phase 6b's work)
    variant_bounds = {name: bound(*v["work"]) for name, v in variants.items()}
    for name, v in variants.items():
        (flops, nbytes), (b_ms, b_by) = v["work"], variant_bounds[name]
        log(f"{name} with limits and weights bound (B={v['shape'][0]}, N={v['shape'][1]}): "
            f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB -> {b_ms:.5f} ms ({b_by}); measured "
            f"{v['ms']:.4f} ms")
    log(f"config 4 numbers: {json.dumps(mpc_numbers)}")
    family_bounds = {name: bound(*v["work"]) for name, v in families.items()}
    for name, v in families.items():
        (flops, nbytes), (b_ms, b_by) = v["work"], family_bounds[name]
        log(f"{name} bound ({v['shape']}): {flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.3f} MB -> "
            f"{b_ms:.5f} ms ({b_by}); measured {v['ms']:.4f} ms")

    robust_bounds = {name: bound(*v["work"]) for name, v in robust_rows.items()}
    for name, v in robust_rows.items():
        (flops, nbytes), (b_ms, b_by) = v["work"], robust_bounds[name]
        log(f"{name} with its variants bound ({v['shape']}): {flops / 1e9:.4f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB -> {b_ms:.5f} ms ({b_by}); measured {v['ms']:.4f} ms")
    log(f"robust and long variants numbers: {json.dumps(robust_numbers)}")

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
    # plain_ms and bound_ms share their inputs and work: for fddp.cu and the
    # streamed kernels the main path's calls held against plain (above),
    # with the whole path's time and bound beside them in `full_width`
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
    # fddp.cu: the main path's two whole launches, beside stream_fddp.cu's
    k_ms, w_ms, n_ = full["fddp"]
    kernels[3]["full_width"] = {"B": r_batch, "N": n_, "ms": k_ms, "streamed_twin_ms": w_ms,
                                "bound_ms": full_bounds["fddp"][0]}
    # the box and weights instantiations of the first three, on config 4's
    # main path (the MPC loop with rotor limits and the terminal weight):
    # launches there; error (float32) and times at its shapes, beside the
    # float64 error at B=300, N=40
    kernels += [
        {
            "name": f"{name}_box_weights", "route": "cuda", "source": f"{pkg}/{name}.cu",
            "replaces": replaces[name], "launches": v["launches"], "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": variant_bounds[name][0],
            "bound_by": variant_bounds[name][1], "library_ms": None,
            "variant": "box and weights (kBox, kW)",
            "shape": {"B": v["shape"][0], "N": v["shape"][1]},
            "without_variants_ms": v["unconstrained_ms"],
            "f64_max_abs_err": v["f64_max_abs_err"], "f64_shape": {"B": v["f64_shape"][0], "N": v["f64_shape"][1]},
        }
        for name, v in variants.items()
    ]
    # the model families' instantiations of the four exact kernels, on the
    # families' main path: launches there; times at the shapes in `shape`;
    # error lane for lane against plain in float64 at B=300, N=40
    lane_models = {sfx: line for sfx, _, _, line in FAMILY_CASES}
    models = {"_wrench": "se3_wrench (u=6)", "_rotor6": "multirotor R=6", "_rotor8": "multirotor R=8"}
    for name, v in families.items():
        kernel, sfx = name.split("_", 1)
        kernels.append({
            "name": name, "route": "cuda", "source": f"{pkg}/{kernel}.cu",
            "replaces": replaces[kernel], "launches": v["launches"], "max_abs_err": v["f64_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": family_bounds[name][0],
            "bound_by": family_bounds[name][1], "library_ms": None,
            "model": models["_" + sfx], "lane_model": lane_models["_" + sfx],
            "shape": v["shape"], "max_abs_err_shape": {"B": 300, "N": 40, "dtype": "float64"},
            **{k: v[k] for k in ("per_pass_route_ms", "full_width") if k in v},
        })
    # the box and weights instantiations of rows 4-6 on phase 6d's main path
    # (launches there), error (float32) and times at the shapes in `shape`
    # on the calls held against plain, beside the float64 error; and
    # fddp.cu's weights variant on config 6 with w_T
    for name, v in robust_rows.items():
        kernel = "fddp" if name == "fddp_weights" else name
        variant = "weights (kW)" if name == "fddp_weights" else "box and weights (kBox, kW)"
        kernels.append({
            "name": name if name == "fddp_weights" else f"{name}_box_weights", "route": "cuda",
            "source": f"{pkg}/{kernel}.cu", "replaces": replaces[kernel],
            "launches": v["launches"], "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": robust_bounds[name][0],
            "bound_by": robust_bounds[name][1], "library_ms": None, "variant": variant,
            "shape": {"B": v["shape"][0], "N": v["shape"][1]},
            **({"without_variants_ms": v["without_variants_ms"]}
               if "without_variants_ms" in v else {}),
            "f64_max_abs_err": v["f64_err"],
            "f64_shape": {"B": v["f64_shape"][0], "N": v["f64_shape"][1]},
        })
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
