"""The whole robust FDDP loop without a candidate trajectory: CUDA kernel and
plain version.

Counterpart of `quadrotorilqr_tpu/kernels/stream_fddp.py:847`
(`solve_fddp_streamed` over the Pallas `_stream_fddp_kernel`), the engine
that `solver.batched.solve_batch_fddp` and `solve_batch_fddp_refine` take
past 231 stages, as the JAX package does. It computes what
`kernels/fddp.py` computes, lane for lane, with the streamed schedule: the
defects are recomputed on the trips that need them, the Goldstein probes sum
costs only, and one apply sweep re-rolls each accepted lane at its accepted
alpha and writes the candidate into the live trajectory (a rejected lane
keeps its trajectory for the mu retry). `csrc/stream_fddp.cu` runs it with
one team of lanes of a warp per scenario (`csrc/team.cuh`);
`solve_fddp_streamed` launches it for CUDA tensors and
takes `solve_fddp_streamed_reference` only for CPU tensors. As on
`fddp.py`, a line search with no probes rejects every trip, and control
limits and stage weights run the kernel's box and weights variants.

The JAX function's `chunk` sets the stages its TPU kernel streams through a
VMEM window at a time. Here every stage lives in device memory and the
kernel prefetches a fixed number of stages ahead into shared memory, so
there is no `chunk` parameter; `interpret` and `supertile` are TPU options
too.
"""

from __future__ import annotations

import collections

from ..solver import fddp
from ..solver.options import ILQROptions
from .backward import _check_cuda, count_launch, variant_key
from .fddp import _launch


def solve_fddp_streamed_reference(
    params, cost, traj, dt_s, options: ILQROptions, fddp_options, ddp=False,
    initial_mu=None, initial_status=None, initial_iters=None, limits=None,
):
    """Plain PyTorch version: `solver.fddp.fddp_loop` with the streamed
    schedule. Returns (Trajectory, cost, iterations int32, status int32, mu,
    probe sweeps, defect trips int32, apply sweeps int32), each (B,) after
    the trajectory."""
    return fddp.fddp_loop(
        params, cost, traj, dt_s, options, fddp_options, ddp,
        initial_mu, initial_status, initial_iters, streamed=True, limits=limits,
    )


def solve_fddp_streamed(
    params, cost, traj, dt_s, options: ILQROptions, fddp_options=None, ddp=False,
    initial_mu=None, initial_status=None, initial_iters=None, return_mu=False,
    return_probes=False, model=None, limits=None,
):
    """Whole-solve FDDP for (B, N, ...) trajectories, any B and any N, lane
    for lane `solve_fddp_fused`, with its resume rows, limits and stage
    weights. Returns (Trajectory,
    cost (B,), iterations (B,) int32, status (B,) int32), then mu (B,) with
    `return_mu`, and with `return_probes` the probe sweeps (B,) (stages the
    probes ran / N), the trips that computed the defects (B,) int32 and the
    apply sweeps (B,) int32, all counted over this call."""
    fo = fddp.FDDPOptions() if fddp_options is None else fddp_options
    fddp.check_supported(model, params=params)
    device = traj.controls.device
    if device.type == "cpu":
        out = solve_fddp_streamed_reference(
            params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status, initial_iters,
            limits,
        )
    else:
        _check_cuda(device)
        out = _launch(params, cost, traj, dt_s, options, fo, ddp, initial_mu, initial_status,
                      initial_iters, limits, streamed=True)
        count_launch(solve_fddp_streamed, variant_key(limits, cost))
    return out[:4] + ((out[4],) if return_mu else ()) + (out[5:] if return_probes else ())


solve_fddp_streamed.launches = collections.Counter()
