"""Demo driver (`quadrotorilqr_tpu/app/driver.py`, the reference application
quadrotor_ilqr.py): builds the climbing-square desired trajectory (BASELINE
config 1), solves it in float64 with the per-iteration debug record, and
renders the 7-panel temporal plots, the cost-per-iteration semilog and the
3D animation, with the reference's flags (--show_plots, --plot_iters,
--save_anim_path) and --device.

    python -m quadrotorilqr_tpu_torch.app.driver [--show_plots] [--device cpu]

It solves on the CUDA card unless given `--device cpu`. The intermediate
trajectories and costs come from the debug record's valid slots, the same
ones `io.debug_to_proto` sends out, so the driver needs no protobuf.
matplotlib is imported only to plot.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..api import QuadrotorILQR
from ..lie import so3
from ..solver.options import ConvergenceCriteria, ILQROptions, LineSearchParams
from ..tree import tree_map
from . import workloads


def _np(a):
    return a.detach().cpu().numpy()


def quat_to_euler_xyz(quat):
    """wxyz quaternion(s) -> extrinsic xyz Euler angles (for the plots)."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


def debug_iterations(debug):
    """(list of Trajectory, list of float costs) of an unbatched IterDebug's
    valid slots, one per executed update; ([], []) for None."""
    if debug is None:
        return [], []
    slots = [int(i) for i in torch.nonzero(debug.valid.cpu()).flatten()]
    costs = _np(debug.costs.to(torch.float64))
    return ([tree_map(lambda leaf: leaf[i], debug.trajectories) for i in slots],
            [float(costs[i]) for i in slots])


def plot_temporal_trajectories(traj_dict):
    """Translation, roll/pitch/yaw and controls against time."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(7, 1, figsize=(9, 12), sharex=True)
    for label, traj in traj_dict.items():
        t = _np(traj.times)
        trans = _np(traj.states.pose.trans)
        euler = quat_to_euler_xyz(_np(traj.states.pose.quat))
        ctrl = _np(traj.controls)
        for k in range(3):
            ax[k].plot(t, trans[:, k], label=label)
        ax[3].plot(t, np.unwrap(euler[:, 0]), label=label)
        ax[4].plot(t, euler[:, 1], label=label)
        ax[5].plot(t, euler[:, 2], label=label)
        ax[6].plot(t, ctrl, label=label)
    names = ["x translation [m]", "y translation [m]", "z translation [m]", "roll [rad]",
             "pitch [rad]", "yaw [rad]", "control"]
    for axis, name in zip(ax, names):
        axis.set_ylabel(name)
        axis.legend()
    fig.align_ylabels()
    ax[-1].set_xlabel("time [s]")
    return fig


def plot_costs(costs):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(9, 9))
    ax.semilogy(costs)
    ax.set_xlabel("iteration")
    ax.set_ylabel("cost")
    return fig


# The mesh drawn in the animation (the JAX package's procedurally generated
# assets/quadrotor.stl); QILQR_MESH_PATH overrides it, and without a mesh
# the animation draws a 4-arm glyph.
DEFAULT_MESH_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "quadrotor.stl"
)


def load_stl_mesh(path):
    """Binary STL -> (n_tri, 3, 3) float64 vertices: an 80-byte header, a
    uint32 triangle count, then 50-byte records (normal, 3 vertices, attr)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    n = struct.unpack("<I", data[80:84])[0]
    rec = np.dtype([("normal", "<f4", (3,)), ("verts", "<f4", (3, 3)), ("attr", "<u2")])
    tris = np.frombuffer(data, dtype=rec, count=n, offset=84)
    return tris["verts"].astype(np.float64)


def animate_trajectories(traj_dict, plot_3d_key, mesh_path=None):
    """The 3D paths and the vehicle flying `plot_3d_key`'s trajectory."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    for label, traj in traj_dict.items():
        trans = _np(traj.states.pose.trans)
        ax.plot3D(trans[:, 0], trans[:, 1], trans[:, 2], label=label)

    target = traj_dict[plot_3d_key]
    rots = _np(so3.quat_to_matrix(target.states.pose.quat.to(torch.float64)))
    trans = _np(target.states.pose.trans)
    if mesh_path is None:
        mesh_path = os.environ.get("QILQR_MESH_PATH", DEFAULT_MESH_PATH)
    mesh = load_stl_mesh(mesh_path) if mesh_path and os.path.exists(mesh_path) else None

    if mesh is not None:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        coll = Poly3DCollection(np.zeros((0, 3, 3)), facecolor="dimgray", edgecolor="none")
        ax.add_collection3d(coll)

        def update(i):
            coll.set_verts(mesh @ rots[i].T + trans[i])
            return [coll]

    else:
        arms = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], dtype=np.float64)
        lines = [ax.plot3D([], [], [], "k-", lw=2)[0] for _ in range(4)]

        def update(i):
            for j, line in enumerate(lines):
                tip = trans[i] + rots[i] @ arms[j]
                line.set_data([trans[i, 0], tip[0]], [trans[i, 1], tip[1]])
                line.set_3d_properties([trans[i, 2], tip[2]])
            return lines

    ax.legend(bbox_to_anchor=(1.5, 0.5), loc="center right", ncol=2)
    fig.tight_layout()
    return animation.FuncAnimation(fig, update, frames=rots.shape[0], blit=False)


def main(show_plots: bool = True, plot_iters: bool = False, save_anim_path: str | None = None,
         device=None):
    """Solve the reference demo (float64, rtol = atol = 1e-12, 100
    iterations, line search (0.5, 0.5, 100)) and plot it; returns the
    SolveResult."""
    dt_s = 0.1
    desired_traj = workloads.demo_desired_trajectory(dt_s=dt_s)
    options = ILQROptions(
        line_search_params=LineSearchParams(0.5, 0.5, 100),
        convergence_criteria=ConvergenceCriteria(1e-12, 1e-12, 100),
        populate_debug=True,
    )
    q, r = workloads.demo_weights()
    ilqr = QuadrotorILQR(
        mass_kg=1.0, inertia=np.eye(3), arm_length_m=1.0, torque_to_thrust_ratio_m=0.0,
        g_mpss=9.81, Q=q, R=r, desired_traj=desired_traj, dt_s=dt_s, options=options,
        device=device,
    )
    result = ilqr.solve_pytree(desired_traj)
    debug_trajs, costs = debug_iterations(result.debug)
    traj_dict = {"desired": desired_traj, "optimized": result.trajectory}
    if plot_iters:
        for i, traj in enumerate(debug_trajs):
            traj_dict[f"iter {i}"] = traj

    print(
        f"solved: cost={float(result.cost):.6e} iterations={int(result.iterations)} "
        f"status={int(result.status)} horizon={desired_traj.horizon} device={ilqr.device}"
    )

    if show_plots:
        import matplotlib.pyplot as plt

        plot_temporal_trajectories(traj_dict)
        plot_costs(costs)
        anim = animate_trajectories(traj_dict, plot_3d_key="optimized")
        if save_anim_path:
            print(f"Saving animation to {save_anim_path}...", end=" ", flush=True)
            anim.save(save_anim_path, writer="pillow", fps=int(1 / dt_s))
            print("Done!")
        plt.show()
    return result


def parse_args(args):
    parser = argparse.ArgumentParser(
        description="Run the PyTorch/CUDA Quadrotor iLQR Trajectory Generator."
    )
    parser.add_argument("--show_plots", action="store_true",
                        help="Show the plots after generating the trajectory")
    parser.add_argument("--plot_iters", action="store_true",
                        help="Plot the intermediate trajectories generated during optimization.")
    parser.add_argument("--save_anim_path", type=str, default=None,
                        help="Path to save the result animation (requires --show_plots).")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to solve on (default: the CUDA card)")
    return parser.parse_args(args)


def cli():
    parsed = parse_args(sys.argv[1:])
    main(parsed.show_plots, parsed.plot_iters, parsed.save_anim_path, parsed.device)


if __name__ == "__main__":
    cli()
