// Closed-loop rollout with the tracking cost in the same sweep, one team of
// kTeamLanes lanes per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/rollout.py:
// _rollout_kernel (called through rollout_cost_fused):
//     u_n     = u_old_n + alpha k_n + K_n (x_n (-) x_old_n)
//     x_{n+1} = f(x_n, u_n)                       (Lie-Euler step)
//     J      += (x_n (-) x_d,n)' Q (.) + (u_n - u_d,n)' R (.)
// with a per-scenario step alpha. The cost accumulates stage by stage as
// (J + dx'Q dx) + du'R du, the TPU kernel's order. The gains come as the
// backward kernel writes them, k|K (N, B, P).
//
// What bounds it on an H100: the dependent chain of one scenario's stages
// (two SE(3) logs, an exp and the dynamics step, ~1.2k operations a stage,
// each stage depending on the last), far above the bytes and operations
// bound (~3 MB and 0.5 GFLOP per sweep in float32 at B = 4096, N = 100;
// PERF.md section 6). The per-thread design ran that chain in one thread
// reading every stage operand from device memory when it needed it. What
// this design does about it (team.cuh, team_trip.cuh): the whole-solve
// kernels' rollout sweep, team_rollout, run once: a team of lanes shares
// each scenario, the stage cost's Q dx is split over the team, Q, R and the
// model parameters are read from shared memory, and each stage's
// trajectory, gains and desired operands arrive through a cp.async ring
// kRing - 1 stages ahead. team_rollout is never inlined, so these probes
// and the whole-solve kernels' probes run the same instructions.
//
// The box and weights variants (_rollout_kernel's use_box, use_weights):
// team_rollout's (kBox, kW) instantiations, picked when the bounds or the
// weights are passed: u_n clamped into [lo, hi], the cost summed as
// J + w_n (dx'Q dx + du'R du).
//
// The model families: compiled once per family, as backward.cu, each
// family's step (quadrotor.cuh dynamics_step; k of them a stage for a
// substepped family, team.cuh team_stage_step) in team_rollout; the wrench,
// the 6- and 8-rotor multirotors, the drag quadrotor and the substepped
// families without the variants.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct RolloutIO {
  Traj<T> x;                    // (N, d, B) previous trajectory
  const T* gains;               // (N, B, P): k | K
  const T* alpha;               // (B,)
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  Traj<T> out;                  // out (N, d, B)
  T* cost;                      // out (B,)
  VariantOps<T> var;            // bounds and weights of the variants
};

template <typename T, bool kBox, bool kW, class M, class IO = RolloutIO<T>>
__global__ void __launch_bounds__(kTeamThreads) rollout_kernel(Problem<T> P, IO io) {
  Team<T, M> tm;
  if (!team_setup(P, &tm)) return;
  // an inactive lane's team leaves whole, after the block-wide setup
  if (io.active != nullptr && io.active[tm.b] == 0) return;
  team_set_substeps(tm, io);
  const T cost =
      team_rollout<T, kBox, kW>(tm, P, io.x, io.out, io.gains, io.alpha[tm.b], true, io.var);
  ring_drain();
  if (tm.lane == 0) io.cost[tm.b] = cost;
}

// packed operands after the Problem block:
//   ptrs: q t v u  gains alpha active  oq ot ov ou cost  lo hi w
//   ints: s_box s_w  (a substepped family's k after them)
template <typename T, class M>
int launch_rollout(const void* const* ptrs, const long long* ints, const double* reals,
                   void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  RolloutIO<T> io;
  io.x = traj_from<T>(p);
  io.gains = static_cast<const T*>(p[4]);
  io.alpha = static_cast<const T*>(p[5]);
  io.active = static_cast<const unsigned char*>(p[6]);
  io.out = traj_from<T>(p + 7);
  io.cost = static_cast<T*>(const_cast<void*>(p[11]));
  io.var = variant_from<T>(p + 12, ints + kProblemInts);
  const size_t bytes = team_block_bytes<T, M>(P.s_qr, P.s_par);
  if constexpr (std::is_same_v<M, Quadrotor>) {
    return with_variant(io.var, [&](auto box, auto w) {
      return team_launch(rollout_kernel<T, decltype(box)::value, decltype(w)::value, M>, P.B,
                         bytes, stream, P, io);
    });
  } else {
    // the other families have no variant instantiation (the host refuses them)
    if (io.var.lo != nullptr || io.var.w != nullptr) return cudaErrorNotSupported;
    if constexpr (M::kSub) {
      WithSubsteps<RolloutIO<T>> sio;
      const int err = with_substeps<M>(io, ints + kProblemInts, &sio);
      if (err != 0) return err;
      return team_launch(rollout_kernel<T, false, false, M, WithSubsteps<RolloutIO<T>>>, P.B,
                         bytes, stream, P, sio);
    } else {
      return team_launch(rollout_kernel<T, false, false, M>, P.B, bytes, stream, P, io);
    }
  }
}

}  // namespace qilqr

extern "C" int QILQR_ENTRY(rollout, f32)(const void* const* ptrs, const long long* ints,
                                         const double* reals, void* stream) {
  return qilqr::launch_rollout<float, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(rollout, f64)(const void* const* ptrs, const long long* ints,
                                         const double* reals, void* stream) {
  return qilqr::launch_rollout<double, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(rollout, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Family>(f64, s_qr, s_par, out);
}
