// Per-pass backward Riccati sweep of the exact iLQR, one team of
// kTeamLanes lanes per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/backward.py:
// _backward_kernel (called through backward_pass_fused). For every scenario
// it walks the horizon in reverse and, per stage, builds the block-sparse
// dynamics Jacobian and the Gauss-Newton cost diffs, expands Q, solves the
// u x u Cholesky gains and updates the symmetrized value function. Outputs:
// k|K as (N, B, P) (k first, then K row-major, padded to P values: the gains
// scratch of the whole-solve kernels, which the rollout kernel fetches as it
// is) and [QuTk; kTQuuk] (2, B).
//
// What bounds it on an H100: the dependent chain of one scenario's stages.
// A Riccati stage is ~12k operations, each stage depending on the last; at
// B = 4096 the card holds every scenario at once, so a launch lasts as long
// as a scenario's chain, far above the bytes and operations bound (PERF.md
// section 6). The per-thread design ran that chain in one thread with ~400
// values of Riccati state in local memory. What this design does about it
// (team.cuh, team_trip.cuh): the reverse sweep of the whole-solve kernels,
// team_backward, run once: a team of lanes shares each scenario, the
// Riccati state lives in shared memory, the 12x12 and 12xu products are
// split over the team by output entries, Q, R and the model parameters
// are read from shared memory, and each stage's operands arrive through a
// cp.async ring kRing - 1 stages ahead.
//
// The box and weights variants (_backward_kernel's use_box, use_weights) are
// instantiations of their own (kBox, kW), picked when the bounds or the
// weights are passed: team_backward's box-QP gains and weighted cost terms;
// without either the kernel is the exact path above.
//
// The model families (JAX kernels/models.py's lane models): this source is
// compiled once per family (kernels/_build.py FAMILIES):
// the quadrotor with its variants, and the wrench (u = 6, j_u rows 6:12)
// and the 6- and 8-rotor multirotors (j_u rows 8:12), each the plain
// instantiation alone, with C entries of their own.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct BackwardIO {
  Traj<T> x;                    // (N, d, B) trajectory
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  T* gains;                     // out (N, B, P): k | K
  T* red;                       // out (2, B): QuTk, kTQuuk
  T quu_reg;
  VariantOps<T> var;            // bounds and weights of the variants
};

template <typename T, bool kBox, bool kW, class M>
__global__ void __launch_bounds__(kTeamThreads) backward_kernel(Problem<T> P, BackwardIO<T> io) {
  Team<T, M> tm;
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
template <typename T, class M>
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
  const size_t bytes = team_block_bytes<T, M>(P.s_qr, P.s_par);
  if constexpr (std::is_same_v<M, Quadrotor>) {
    return with_variant(io.var, [&](auto box, auto w) {
      return team_launch(backward_kernel<T, decltype(box)::value, decltype(w)::value, M>, P.B,
                         bytes, stream, P, io);
    });
  } else {
    // the other families have no variant instantiation (the host refuses them)
    if (io.var.lo != nullptr || io.var.w != nullptr) return cudaErrorNotSupported;
    return team_launch(backward_kernel<T, false, false, M>, P.B, bytes, stream, P, io);
  }
}

}  // namespace qilqr

extern "C" int QILQR_ENTRY(backward, f32)(const void* const* ptrs, const long long* ints,
                                          const double* reals, void* stream) {
  return qilqr::launch_backward<float, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(backward, f64)(const void* const* ptrs, const long long* ints,
                                          const double* reals, void* stream) {
  return qilqr::launch_backward<double, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(backward, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Family>(f64, s_qr, s_par, out);
}
