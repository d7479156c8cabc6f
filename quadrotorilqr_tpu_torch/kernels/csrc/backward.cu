// Per-pass backward Riccati sweep of the exact iLQR, one team of
// kTeamLanes lanes per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/backward.py:
// _backward_kernel (called through backward_pass_fused). For every scenario
// it walks the horizon in reverse and, per stage, builds the block-sparse
// dynamics Jacobian and the Gauss-Newton cost diffs, expands Q, solves the
// 4x4 Cholesky gains and updates the symmetrized value function. Outputs:
// k|K as (N, B, 52) (k first, then K row-major: the gains scratch of the
// whole-solve kernels, which the rollout kernel fetches as it is) and
// [QuTk; kTQuuk] (2, B).
//
// What bounds it on an H100: the dependent chain of one scenario's stages.
// A Riccati stage is ~12k operations, each stage depending on the last; at
// B = 4096 the card holds every scenario at once, so a launch lasts as long
// as a scenario's chain, far above the bytes and operations bound (PERF.md
// section 6). The per-thread design ran that chain in one thread with ~400
// values of Riccati state in local memory. What this design does about it
// (team.cuh, team_trip.cuh): the reverse sweep of the whole-solve kernels,
// team_backward, run once: a team of lanes shares each scenario, the
// Riccati state lives in shared memory, the 12x12 and 12x4 products are
// split over the team by output entries, Q, R and the model parameters
// are read from shared memory, and each stage's operands arrive through a
// cp.async ring kRing - 1 stages ahead.
//
// The box and weights variants (_backward_kernel's use_box, use_weights) are
// instantiations of their own (kBox, kW), picked when the bounds or the
// weights are passed: team_backward's box-QP gains and weighted cost terms;
// without either the kernel is the exact path above.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct BackwardIO {
  Traj<T> x;                    // (N, d, B) trajectory
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  T* gains;                     // out (N, B, 52): k | K
  T* red;                       // out (2, B): QuTk, kTQuuk
  T quu_reg;
  VariantOps<T> var;            // bounds and weights of the variants
};

template <typename T, bool kBox, bool kW>
__global__ void __launch_bounds__(kTeamThreads) backward_kernel(Problem<T> P, BackwardIO<T> io) {
  Team<T> tm;
  if (!team_setup(P, &tm)) return;
  // an inactive lane's team leaves whole, after the block-wide setup
  if (io.active != nullptr && io.active[tm.b] == 0) return;
  const Problem<T> Ps = smem_problem(P, tm);
  T qutk, ktquuk;
  team_backward<T, kBox, kW>(tm, P, Ps, io.quu_reg, io.x, false, io.x, io.gains, &qutk, &ktquuk,
                             io.var);
  ring_drain();
  if (tm.lane == 0) {
    io.red[tm.b] = qutk;
    io.red[P.B + tm.b] = ktquuk;
  }
}

// packed operands after the Problem block:
//   ptrs:  q t v u  active  gains red  lo hi w
//   ints:  s_box s_w
//   reals: quu_reg
template <typename T>
int launch_backward(const void* const* ptrs, const long long* ints, const double* reals,
                    void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  BackwardIO<T> io;
  io.x = traj_from<T>(p);
  io.active = static_cast<const unsigned char*>(p[4]);
  io.gains = static_cast<T*>(const_cast<void*>(p[5]));
  io.red = static_cast<T*>(const_cast<void*>(p[6]));
  io.quu_reg = static_cast<T>(reals[kProblemReals]);
  io.var = variant_from<T>(p + 7, ints + kProblemInts);
  const size_t bytes = team_block_bytes<T>(P.s_qr, P.s_par);
  return with_variant(io.var, [&](auto box, auto w) {
    return team_launch(backward_kernel<T, decltype(box)::value, decltype(w)::value>, P.B, bytes,
                       stream, P, io);
  });
}

}  // namespace qilqr

extern "C" int qilqr_backward_f32(const void* const* ptrs, const long long* ints,
                                  const double* reals, void* stream) {
  return qilqr::launch_backward<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_backward_f64(const void* const* ptrs, const long long* ints,
                                  const double* reals, void* stream) {
  return qilqr::launch_backward<double>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_backward_team_info(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info(f64, s_qr, s_par, out);
}
