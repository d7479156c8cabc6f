#!/usr/bin/env python3
"""Time the kernels of several checkouts of the port side by side on one
GPU.

    python3 quadrotorilqr_tpu_torch/tools/ab_time.py [--order 0,1,1,0] \
        [--only GROUP[,GROUP]] ROOT [ROOT ...]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with `git archive` into a git-ignored directory, and this tree).
The script first builds every checkout's kernels at once, one process per
checkout, then times the checkouts one process at a time in `--order`
(indices into the ROOT list; default each once, then in reverse), so that a
drift of the card over the run shows up in both. Each timing process
imports the port from its ROOT and measures, with CUDA events after a
warm-up, the median of 5 of these groups (`--only` picks some; default
all):

  * `robust`: the aggressive tumble (B=4096, N=50, dt 0.1, scale 1.8, f32, 40
    iterations; benchmarks/run_all.py config 6) through
    `QuadrotorILQR(solver="fddp").solve_batch` (two `fddp.cu` launches), each
    of the two launches on its own, the single-phase `fddp.cu` launch, and
    the Gauss-Newton launch with one line-search probe a trip (its reverse
    sweeps and one probe sweep a trip, without the long searches of the
    slowest lanes), beside the most trips and probe sweeps one lane ran;
    and the same two launches on `stream_fddp.cu`;
  * `bench`: the bench workload (hover to waypoint, B=4096, N=100, f32, 10
    iterations) through `solve_batch_latency` (`solve.cu`), and on
    `stream.cu`;
  * `perpass`: the bench workload through the per-pass route,
    `QuadrotorILQR.solve_batch(fused=True)` (`backward.cu` and
    `rollout.cu` launched by `solver.ilqr.solve_loop`), with its launch
    counts; one backward and one rollout wrapper call on the trajectory
    after trip 0's full step, and their launches alone (CUDA events around
    `_build.launch`); and a `torch.profiler` trace of 10 wrapper calls of
    each kind and of one route solve, with the wrappers' host-side steps
    labelled (`record_function` around the module functions the calls go
    through), giving each label's and each operator's host time per call,
    the kernels' device time, and the route's device-busy share (its
    kernels' profiled device time over its unprofiled time);
  * `long`: the long-horizon paths on `long_horizon_problem` (f32,
    B=4096), as chip_smoke.py drives them: exact iLQR at N=1024 through
    `solve_batch(latency=True)` (one `stream.cu` launch; 10 iterations) and
    robust FDDP at N=512 through `solver="fddp"` (two `stream_fddp.cu`
    launches; 12 iterations); and one backward pass and one rollout sweep
    of `stream.cu` at the exact long path's shapes (B=4096, N=1024), from
    two launches in which every
    scenario does the same work: one trip (a backward pass, trip 0's
    forced probe and the apply sweep: T1 = b + 2 r) and two trips whose
    second line search can accept nothing (desired reduction 1e9 times the
    model's), so it runs out after 20 probes and applies the last
    (T2 = 2 b + 23 r); r = (T2 - 2 T1) / 19, b = T1 - 2 r. Whether every
    scenario ran those counts is reported beside them.

Each process prints one JSON line with its times and a digest of its
results (summed cost, status counts), so that the checkouts can be seen to
compute the same thing. The last line is a JSON summary: every time of
every checkout, in run order, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _import_port(root):
    sys.path.insert(0, os.path.abspath(root))
    import quadrotorilqr_tpu_torch

    got = os.path.dirname(os.path.dirname(os.path.abspath(quadrotorilqr_tpu_torch.__file__)))
    if got != os.path.abspath(root):
        raise RuntimeError(f"imported the port from {got}, not {root}")


def build(root):
    _import_port(root)
    from quadrotorilqr_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    print(json.dumps({"root": root, "build_s": time.perf_counter() - t0, "lib": lib.path.name}),
          flush=True)


GROUPS = ("robust", "bench", "perpass", "long")


def time_ms(fn, repeats=5):
    """Median of `repeats` runs of fn, CUDA events around each, after one
    warm-up run."""
    import torch

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


def digest(out):
    """[summed cost, status counts] of a SolveResult or a kernel's tuple."""
    import torch

    cost, status = (out.cost, out.status) if hasattr(out, "cost") else (out[1], out[3])
    return [float(cost.double().sum()), torch.bincount(status.long(), minlength=3).tolist()]


def launch_ms(fn, entry, repeats=5):
    """The `entry` kernel's launches alone in a call of fn: CUDA events
    around each `_build.launch` of it, summed over the call; 1 warm-up,
    median of `repeats` calls."""
    import torch

    from quadrotorilqr_tpu_torch.kernels import _build

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


# the module functions a per-pass wrapper call or route solve goes through
# (those that a checkout has), each labelled in the profile by record_function
_HOST_STEPS = (
    "_problem_operands", "_prep_cost", "prep_params", "_traj_lanes", "_to_lanes",
    "_active_lanes", "_traj_from_lanes", "gains_views", "gains_buffer", "_launch",
)


def _profile(fn, calls):
    """A torch.profiler trace of `calls` runs of fn (after a warm-up run),
    with the per-pass wrappers' host steps and `_build.launch` labelled.
    Returns {labels: {name: [count, host us per run]}, ops: the 12 operators
    of most host time, as [name, count, host us per run], kernels: the 8 of
    most device time, as [name, count, device us per run], device_us per
    run: the kernels' summed device time, wall_us per run}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from quadrotorilqr_tpu_torch.kernels import _build
    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import rollout as kr

    def labelled(tag, f):
        def run(*args, **kwargs):
            with record_function(tag):
                return f(*args, **kwargs)
        return run

    saved, labels = [], set()
    for mod, short in ((kb, "backward"), (kr, "rollout"), (_build, "_build")):
        for name in _HOST_STEPS + (("launch",) if mod is _build else ()):
            f = mod.__dict__.get(name)
            if callable(f):
                saved.append((mod, name, f))
                labels.add(f"{short}.{name}")
                setattr(mod, name, labelled(f"{short}.{name}", f))
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # a record_function range is also recorded on the device timeline (as a
    # user annotation spanning its kernels): the labels are read from the
    # host side only, the kernels without them
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA and e.key not in labels),
        key=lambda e: -device_us(e),
    )
    ops = sorted((e for e in host if e.key not in labels), key=lambda e: -e.self_cpu_time_total)
    return {
        "labels": {e.key: [e.count, e.cpu_time_total / calls] for e in host if e.key in labels},
        "ops": [[e.key, e.count, e.self_cpu_time_total / calls] for e in ops[:12]],
        "kernels": [[e.key, e.count, device_us(e) / calls] for e in kernels[:8]],
        "device_us": sum(device_us(e) for e in kernels) / calls,
        "wall_us": wall / calls,
    }


def bench_problem(n=100):
    """The bench workload (hover to waypoint, B=4096, f32, seed 0, 10
    iterations) at horizon n: (QuadrotorILQR, initial trajectories)."""
    import torch

    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.solver.options import (
        ConvergenceCriteria,
        ILQROptions,
        LineSearchParams,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, desired = workloads.hover_to_waypoint(
        gen, 4096, n=n, dt_s=0.02, dtype=torch.float32, pose_scale=0.3, device=dev
    )
    q_w, r_w = workloads.demo_weights(torch.float32, dev)
    opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, 10))
    api = QuadrotorILQR(1.0, torch.eye(3), 0.2, 0.016, 9.81, q_w, r_w, desired, 0.02, opts,
                        dtype=torch.float32, device=dev)
    return api, initial_trajectory_from_state(x0, desired)


def _perpass(api, trajs):
    """The per-pass route on the bench workload (see the module docstring)."""
    import torch

    from quadrotorilqr_tpu_torch.kernels import backward as kb
    from quadrotorilqr_tpu_torch.kernels import rollout as kr

    out = {}
    b_params, b_cost = api.params, api.cost
    kb.backward_pass_fused.launches = kr.rollout_cost_fused.launches = 0
    res = api.solve_batch(trajs, fused=True)
    out["perpass_route_launches"] = [kb.backward_pass_fused.launches,
                                     kr.rollout_cost_fused.launches]
    out["perpass_route_digest"] = digest(res)
    out["perpass_route_mean_iterations"] = float(res.iterations.float().mean())
    out["perpass_route_ms"] = time_ms(lambda: api.solve_batch(trajs, fused=True))
    # the trajectory after trip 0's full step (the initial one sits on the
    # target past stage 0, where k is exactly 0), as chip_smoke.py takes it
    ones = torch.ones(trajs.controls.shape[0], dtype=trajs.controls.dtype,
                      device=trajs.controls.device)
    k0, big_k0, _, _ = kb.backward_pass_reference(b_params, b_cost, trajs, api.dt_s)
    trajs1, _ = kr.rollout_cost_reference(b_params, b_cost, trajs, k0, big_k0, ones, api.dt_s)
    k1, big_k1, _, _ = kb.backward_pass_fused(b_params, b_cost, trajs1, api.dt_s)

    def bwd_call():
        return kb.backward_pass_fused(b_params, b_cost, trajs1, api.dt_s)

    def roll_call():
        return kr.rollout_cost_fused(b_params, b_cost, trajs1, k1, big_k1, ones, api.dt_s)

    out["backward_call_ms"] = time_ms(bwd_call)
    out["backward_launch_ms"] = launch_ms(bwd_call, "qilqr_backward")
    out["rollout_call_ms"] = time_ms(roll_call)
    out["rollout_launch_ms"] = launch_ms(roll_call, "qilqr_rollout")
    out["profile"] = {
        "backward_call": _profile(bwd_call, 10),
        "rollout_call": _profile(roll_call, 10),
        "route": _profile(lambda: api.solve_batch(trajs, fused=True), 1),
    }
    # the route's kernels' device time (profiled) over its time unprofiled:
    # the profiler's own host overhead would shrink the share
    out["perpass_route_device_busy"] = (
        out["profile"]["route"]["device_us"] / (out["perpass_route_ms"] * 1e3)
    )
    # each kernel's launch alone at three horizons of the bench workload's
    # class (the initial trajectory and its gains): its fixed cost per
    # launch and its cost per stage
    scaling = {}
    for n in (25, 100, 400):
        api_n, t = bench_problem(n)
        p, c = api_n.params, api_n.cost
        k, big_k, _, _ = kb.backward_pass_fused(p, c, t, api.dt_s)
        scaling[n] = [
            launch_ms(lambda: kb.backward_pass_fused(p, c, t, api.dt_s), "qilqr_backward"),
            launch_ms(lambda: kr.rollout_cost_fused(p, c, t, k, big_k, ones, api.dt_s),
                      "qilqr_rollout"),
        ]
    out["perpass_launch_ms_by_horizon"] = scaling
    return out


def measure(root, groups=GROUPS):
    _import_port(root)
    import torch

    from quadrotorilqr_tpu_torch.api import QuadrotorILQR
    from quadrotorilqr_tpu_torch.app import workloads
    from quadrotorilqr_tpu_torch.kernels import fddp as kf
    from quadrotorilqr_tpu_torch.kernels import stream as kst
    from quadrotorilqr_tpu_torch.kernels import stream_fddp as ksf
    from quadrotorilqr_tpu_torch.solver import ilqr
    from quadrotorilqr_tpu_torch.parallel.batch import initial_trajectory_from_state
    from quadrotorilqr_tpu_torch.solver import fddp
    from quadrotorilqr_tpu_torch.solver.batched import (
        _with_max_iters,
        resolve_refine_auto,
        solve_batch_latency,
    )
    from quadrotorilqr_tpu_torch.solver.options import (
        ConvergenceCriteria,
        ILQROptions,
        LineSearchParams,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    out = {"root": root}
    if "robust" in groups:
        # config 6, as chip_smoke.py builds it
        r_batch, r_n, r_dt, iters = 4096, 50, 0.1, 40
        gen = torch.Generator(device=dev).manual_seed(0)
        r_params, r_q, r_r, x0, r_desired = workloads.aggressive_tumble(
            gen, r_batch, n=r_n, dt_s=r_dt, dtype=torch.float32, device=dev
        )
        r_opts = ILQROptions(LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, iters))
        r_fo = fddp.FDDPOptions(gap_tol=1e-5)
        robust = QuadrotorILQR(
            float(r_params.mass_kg), r_params.inertia, float(r_params.arm_length_m),
            float(r_params.torque_to_thrust_ratio_m), float(r_params.g_mpss), r_q, r_r,
            r_desired, r_dt, r_opts, dtype=torch.float32, device=dev, solver="fddp",
        )
        r_trajs = initial_trajectory_from_state(x0, r_desired)
        bounds, flags = resolve_refine_auto(iters, False)
        switch = ((0,) + bounds)[flags.index(True)]
        p_args = (robust.params, robust.cost)
        gn_opts, ddp_opts = _with_max_iters(r_opts, switch), _with_max_iters(r_opts, iters - switch)
        gn = kf.solve_fddp_fused(*p_args, r_trajs, r_dt, gn_opts, r_fo, return_mu=True)
        rows = dict(initial_mu=gn[4], initial_status=gn[3], initial_iters=gn[2])
        out["fddp_api_ms"] = time_ms(lambda: robust.solve_batch(r_trajs))
        out["fddp_gn_ms"] = time_ms(
            lambda: kf.solve_fddp_fused(*p_args, r_trajs, r_dt, gn_opts, r_fo))
        out["fddp_ddp_ms"] = time_ms(lambda: kf.solve_fddp_fused(
            *p_args, gn[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
        out["fddp_single_ms"] = time_ms(
            lambda: kf.solve_fddp_fused(*p_args, r_trajs, r_dt, r_opts, r_fo))
        out["stream_fddp_gn_ms"] = time_ms(
            lambda: ksf.solve_fddp_streamed(*p_args, r_trajs, r_dt, gn_opts, r_fo))
        out["stream_fddp_ddp_ms"] = time_ms(lambda: ksf.solve_fddp_streamed(
            *p_args, gn[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
        # the Gauss-Newton launch with one probe a trip: every trip's reverse
        # sweep and one probe sweep, without the straggler lanes' long searches
        p1_opts = ILQROptions(
            LineSearchParams(0.5, 0.5, 1), ConvergenceCriteria(1e-6, 1e-6, switch)
        )
        out["fddp_gn_p1_ms"] = time_ms(
            lambda: kf.solve_fddp_fused(*p_args, r_trajs, r_dt, p1_opts, r_fo))
        # the slowest lanes' work in the two launches: most trips, most probe
        # sweeps (stages probed / N) of one lane
        ddp_k = kf.solve_fddp_fused(*p_args, gn[0], r_dt, ddp_opts, r_fo, ddp=True,
                                    return_probes=True, **rows)
        gn_k = kf.solve_fddp_fused(*p_args, r_trajs, r_dt, gn_opts, r_fo, return_probes=True)
        out["fddp_lane_max"] = {
            "gn_trips": int(gn_k[2].max()), "gn_probes": float(gn_k[4].max()),
            "gn_probes_mean": float(gn_k[4].mean()),
            "ddp_trips": int((ddp_k[2] - gn[2]).max()), "ddp_probes": float(ddp_k[4].max()),
            "ddp_probes_mean": float(ddp_k[4].mean()),
        }
        out["fddp_api_digest"] = digest(robust.solve_batch(r_trajs))
        out["stream_fddp_ddp_digest"] = digest(ksf.solve_fddp_streamed(
            *p_args, gn[0], r_dt, ddp_opts, r_fo, ddp=True, **rows))
        out["fddp_single_digest"] = digest(
            kf.solve_fddp_fused(*p_args, r_trajs, r_dt, r_opts, r_fo))

    if "bench" in groups or "perpass" in groups:
        api, trajs = bench_problem()
        s_args = (api.params, api.cost, trajs, 0.02, api.options)
    if "bench" in groups:
        out["solve_ms"] = time_ms(lambda: solve_batch_latency(*s_args))
        out["solve_digest"] = digest(solve_batch_latency(*s_args))
        out["stream_bench_ms"] = time_ms(lambda: kst.solve_fused_streamed(*s_args))

    if "perpass" in groups:
        out.update(_perpass(api, trajs))

    if "long" in groups:
        # the long-horizon paths, as chip_smoke.py builds them
        def api_for(params, cost, trajs, opts, **kw):
            desired = ilqr.Trajectory(
                times=trajs.times[0], states=cost.desired_states, controls=cost.desired_controls
            )
            return QuadrotorILQR(
                float(params.mass_kg), params.inertia, float(params.arm_length_m),
                float(params.torque_to_thrust_ratio_m), float(params.g_mpss), cost.Q, cost.R,
                desired, 0.02, opts, dtype=torch.float32, device=dev, **kw,
            )

        for key, seed, n, iters, kw in (
            ("long_exact", 0, 1024, 10, dict(latency=True)), ("long_robust", 1, 512, 12, {}),
        ):
            gen = torch.Generator(device=dev).manual_seed(seed)
            params, cost, trajs = workloads.long_horizon_problem(
                gen, 4096, n, torch.float32, 0.02, dev)
            opts = ILQROptions(
                LineSearchParams(0.5, 0.5, 20), ConvergenceCriteria(1e-6, 1e-6, iters))
            api_l = api_for(params, cost, trajs, opts, **({} if kw else dict(solver="fddp")))
            out[f"{key}_ms"] = time_ms(lambda: api_l.solve_batch(trajs, **kw))
            out[f"{key}_digest"] = digest(api_l.solve_batch(trajs, **kw))
            if key == "long_exact":
                l_args = (api_l.params, api_l.cost, trajs, 0.02)

        # one backward pass and one rollout sweep of stream.cu at B=4096, N=1024
        def trips(k):
            return ILQROptions(LineSearchParams(0.5, 1e9, 20), ConvergenceCriteria(1e-12, 1e-12, k))

        # every scenario ran (1, 1, 1) and (2, 21, 2) (passes, probes, applies)?
        out["split_counts_uniform"] = all(
            bool((c == w).all())
            for k, want in ((1, (1, 1, 1)), (2, (2, 21, 2)))
            for c, w in zip(
                kst.solve_fused_streamed(*l_args, trips(k), return_probes=True)[4:], want)
        )
        t1 = time_ms(lambda: kst.solve_fused_streamed(*l_args, trips(1)))
        t2 = time_ms(lambda: kst.solve_fused_streamed(*l_args, trips(2)))
        out["rollout_sweep_ms"] = (t2 - 2 * t1) / 19
        out["backward_pass_ms"] = t1 - 2 * out["rollout_sweep_ms"]
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--build":
        build(argv[1])
        return 0
    if len(argv) >= 3 and argv[0] == "--measure":
        measure(argv[1], argv[2].split(","))
        return 0
    order, groups = None, ",".join(GROUPS)
    while argv and argv[0] in ("--order", "--only"):
        if argv[0] == "--order":
            order = [int(i) for i in argv[1].split(",")]
        else:
            groups = argv[1]
            unknown = set(groups.split(",")) - set(GROUPS)
            if unknown:
                print(f"unknown groups {sorted(unknown)}; the groups are {GROUPS}", file=sys.stderr)
                return 2
        argv = argv[2:]
    roots = argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    order = order or list(range(len(roots))) + list(reversed(range(len(roots))))
    card = _card()
    print(card, flush=True)
    me = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, me, "--build", r]) for r in roots]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        print(f"a build failed: {codes}", file=sys.stderr)
        return 1
    runs = []
    for i in order:
        res = subprocess.run([sys.executable, me, "--measure", roots[i], groups],
                             capture_output=True, text=True, timeout=900)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            print(f"measuring {roots[i]} failed with code {res.returncode}", file=sys.stderr)
            return 1
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    keys = [k for k in runs[0] if k.endswith("_ms")]
    summary = {r: {k: [run[k] for run in runs if run["root"] == r] for k in keys} for r in roots}
    print(json.dumps({"card": card, "order": [roots[i] for i in order], "ms": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
