// The whole exact iLQR loop in one kernel, one team of kTeamLanes lanes per
// scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/solve.py:
// _solve_kernel (called through solve_fused_whole), including its trip
// state machine _trip_gate / _ls_probe_commit / _trip_close. Each team runs
// its scenario's solve to the end: backward pass, then (trip 0) a forced
// full step or (later trips) the expected-cost pre-check, a backtracking
// line search with per-scenario alpha that stores each probe as the
// candidate, and the achieved-cost post-check. The candidate merges into the
// live trajectory inside the next trip's backward pass, whose ring fetches
// the stages from the candidate buffer (no copy sweep), or after the loop
// when the solve ends on it. A line search that runs out keeps the last
// candidate and ends with status 2. A finished scenario's team leaves the
// trip loop: its lane is frozen, which is all the TPU kernel's per-tile
// all-done flag guarantees. Status and iterations come out as int32.
//
// What bounds it on an H100: as stream.cu, the dependent chain of one
// scenario's stages (a Riccati stage ~12k operations, a rollout stage
// ~1.2k), each stage depending on the last; at B = 4096 the card holds
// every scenario at once, so a launch lasts as long as its slowest
// scenario's chain. The per-thread design ran that chain in one thread with
// ~400 values of Riccati state in local memory (0.6% of the bound, PERF.md
// section 6). What this design does about it (team.cuh, team_trip.cuh): a
// team of lanes shares each scenario, the Riccati state lives in shared
// memory, the 12x12 and 12xu products are split over the team by output
// entries, Q, R and the model parameters are read from shared memory, each
// stage's operands arrive through a cp.async ring kRing - 1 stages ahead,
// and the candidate is merged by the sweep that reads it. The cost sums in
// the per-pass rollout's order, (J + dx'Q dx) + du'R du, and stream.cu runs
// the same rollout sweep, so the two kernels add up each candidate alike.
//
// Debug outputs (solve.py's record_history ohist rows and oprob counts):
// the instantiation with kRecord writes, from lane 0 of the team after each
// trip's close, the trip's history row (the committed cost of a lane that
// executed an update on it, 0 after a pre-converged gate; the host zeroes
// the rows of trips a lane never ran) and at the end the backward passes and
// probe sweeps the lane ran. The launcher picks it only when one of those
// outputs is asked for, so a launch without them runs the instantiation that
// records nothing; the sweeps are the same never-inlined or shared functions
// in both, so the recorded launch leaves the same trajectory.
//
// The box and weights variants (solve.py's use_box, use_weights) are the
// instantiations (kBox, kW), each with and without the record, picked when
// the bounds or the weights are passed: team_backward's and team_rollout's
// variants, the seed cost weighted. The trip logic is the same.
//
// The model families (JAX solve.py's lane models, its ju_lo_row): this
// source is compiled once per family (kernels/_build.py FAMILIES): the
// quadrotor with every instantiation above, and the wrench
// (u = 6, j_u rows 6:12), the 6- and 8-rotor multirotors (j_u rows 8:12),
// the drag quadrotor and the substepped quadrotor and drag quadrotor (k
// substeps a stage, k a kernel argument), each the instantiation without
// record, box or weights alone.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct SolveIO {
  Traj<T> x0;    // (N, d, B) initial trajectory
  Traj<T> live;  // out (N, d, B): the live, then the final trajectory
  T* cost;       // out (B,)
  int* iters;    // out (B,)
  int* status;   // out (B,)
  T* gains;      // scratch (N, B, P): k | K
  Traj<T> best;  // scratch (N, d, B): the line search's candidate
  T* hist;       // out (max_iters, B) or null: the per-trip cost history
  int* passes;   // out (B,) or null: backward passes run
  int* probes;   // out (B,) or null: probe sweeps run
  int max_iters, ls_max_iters;
  T quu_reg, rtol, atol, ls_step, ls_frac;
  VariantOps<T> var;  // bounds and weights of the variants
};

template <typename T, bool kRecord, bool kBox, bool kW, class M, class IO = SolveIO<T>>
__global__ void __launch_bounds__(kTeamThreads) solve_kernel(Problem<T> P, IO io) {
  Team<T, M> tm;
  if (!team_setup(P, &tm)) return;
  team_set_substeps(tm, io);
  const Problem<T> Ps = smem_problem(P, tm);
  team_copy_traj(tm, P, io.x0, io.live);
  // the loop never runs: report the initial trajectory's true cost
  T cost = io.max_iters == 0 ? team_trajectory_cost<T, kW>(tm, P, io.live, io.var) : T(0);
  int status = 0, iters = 0, passes = 0, stages = 0;
  bool take = false;  // the candidate in best is the live trajectory, not merged yet
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass, merging the last trip's candidate ----
    T qutk, ktquuk;
    team_backward<T, kBox, kW>(tm, P, Ps, io.quu_reg, take ? io.best : io.live, take, io.live,
                               io.gains, &qutk, &ktquuk, io.var);
    take = false;
    if constexpr (kRecord) ++passes;

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = i > 0 && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- line search, each probe stored as the candidate; trip 0 force-accepts ----
    LineSearch<T> ls{false, current, T(1), 0};
    if (active) {
      ls = team_line_search<T, kBox, kW>(tm, P, io.live, io.best, true, io.gains, qutk, ktquuk,
                                         current, i == 0, io.ls_max_iters, io.ls_step,
                                         io.ls_frac, io.var);
      take = true;
      if constexpr (kRecord) stages += ls.stages;
    }
    const bool done = exact_trip_close(i == 0, pre_conv, active, ls, current, io.rtol, io.atol,
                                       &cost, &status, &iters);
    if constexpr (kRecord) {
      if (io.hist != nullptr && tm.lane == 0) {
        io.hist[static_cast<long long>(i) * P.B + tm.b] = active ? cost : T(0);
      }
    }
    if (done) break;
  }
  ring_drain();
  // the last trip's candidate was never merged by a following sweep
  if (take) team_copy_traj(tm, P, io.best, io.live);
  if (tm.lane == 0) {
    io.cost[tm.b] = cost;
    io.iters[tm.b] = iters;
    io.status[tm.b] = status;
    if constexpr (kRecord) {
      if (io.passes != nullptr) io.passes[tm.b] = passes;
      if (io.probes != nullptr) io.probes[tm.b] = stages / P.N;
    }
  }
}

// packed operands after the Problem block:
//   ptrs:  q t v u  oq ot ov ou  cost iters status  gains  bq bt bv bu  hist passes probes
//          (those three null unless asked for)  lo hi w
//   ints:  max_iters ls_max_iters  s_box s_w  (a substepped family's k after them)
//   reals: quu_reg rtol atol ls_step ls_frac
template <typename T, class M>
int launch_solve(const void* const* ptrs, const long long* ints, const double* reals,
                 void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  const long long* ip = ints + kProblemInts;
  const double* rp = reals + kProblemReals;
  auto out = [&](int i) { return const_cast<void*>(p[i]); };
  SolveIO<T> io;
  io.x0 = traj_from<T>(p);
  io.live = traj_from<T>(p + 4);
  io.cost = static_cast<T*>(out(8));
  io.iters = static_cast<int*>(out(9));
  io.status = static_cast<int*>(out(10));
  io.gains = static_cast<T*>(out(11));
  io.best = traj_from<T>(p + 12);
  io.hist = static_cast<T*>(out(16));
  io.passes = static_cast<int*>(out(17));
  io.probes = static_cast<int*>(out(18));
  io.max_iters = static_cast<int>(ip[0]);
  io.ls_max_iters = static_cast<int>(ip[1]);
  io.quu_reg = static_cast<T>(rp[0]);
  io.rtol = static_cast<T>(rp[1]);
  io.atol = static_cast<T>(rp[2]);
  io.ls_step = static_cast<T>(rp[3]);
  io.ls_frac = static_cast<T>(rp[4]);
  io.var = variant_from<T>(p + 19, ip + 2);
  const size_t bytes = team_block_bytes<T, M>(P.s_qr, P.s_par);
  const bool record = io.hist != nullptr || io.passes != nullptr || io.probes != nullptr;
  if constexpr (std::is_same_v<M, Quadrotor>) {
    return with_variant(io.var, [&](auto box, auto w) {
      constexpr bool kBox = decltype(box)::value, kW = decltype(w)::value;
      return record
                 ? team_launch(solve_kernel<T, true, kBox, kW, M>, P.B, bytes, stream, P, io)
                 : team_launch(solve_kernel<T, false, kBox, kW, M>, P.B, bytes, stream, P, io);
    });
  } else {
    // the other families have no record or variant instantiation (the host
    // refuses them)
    if (record || io.var.lo != nullptr || io.var.w != nullptr) return cudaErrorNotSupported;
    if constexpr (M::kSub) {
      WithSubsteps<SolveIO<T>> sio;
      const int err = with_substeps<M>(io, ip + 2, &sio);
      if (err != 0) return err;
      return team_launch(solve_kernel<T, false, false, false, M, WithSubsteps<SolveIO<T>>>, P.B,
                         bytes, stream, P, sio);
    } else {
      return team_launch(solve_kernel<T, false, false, false, M>, P.B, bytes, stream, P, io);
    }
  }
}

}  // namespace qilqr

extern "C" int QILQR_ENTRY(solve, f32)(const void* const* ptrs, const long long* ints,
                                       const double* reals, void* stream) {
  return qilqr::launch_solve<float, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(solve, f64)(const void* const* ptrs, const long long* ints,
                                       const double* reals, void* stream) {
  return qilqr::launch_solve<double, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(solve, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Family>(f64, s_qr, s_par, out);
}
