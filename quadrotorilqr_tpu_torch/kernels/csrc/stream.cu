// The whole exact iLQR loop in one kernel without a candidate trajectory,
// one team of kTeamLanes lanes per scenario: the batch solvers' engine past
// 256 stages.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/stream.py:
// _stream_kernel (called through solve_fused_streamed). It computes what
// solve.cu computes, lane for lane, with the TPU kernel's schedule: each
// trip runs a backward pass into the gains scratch, the trip gate, a line
// search whose probes sum costs only (trip 0 force-accepts its first
// probe), then ONE apply sweep that re-rolls the scenario at the alpha of
// its last tried probe (the accepted one, or, when the search ran out, the
// last tried, the stream.py _TRIED row, never the alpha backtracked once
// more) and writes the candidate into the live trajectory in place, then the
// trip close. The probes and the apply sweep run the same never-inlined
// sweep function with the store as a runtime flag, so the trajectory written
// is, bit for bit, the one whose cost the probe returned.
//
// What bounds it on an H100: the dependent chain of one scenario's stages.
// A Riccati stage is ~12k operations and a rollout stage ~1.2k, each stage
// depending on the last; at B = 4096 the card holds every scenario at once,
// so a launch lasts as long as its slowest scenario's chain. The per-thread
// design ran that chain in one thread, with the Riccati state spilled to
// local memory at 255 registers and every stage operand fetched from device
// memory when needed (0.2-0.85% of the bound, PERF.md section 5). What this
// design does about it (team.cuh): a team of lanes shares each scenario, the
// Riccati state lives in shared memory, the 12x12 and 12xu products are
// split over the team by output entries, Q, R and the model parameters are
// read from shared memory, and each stage's operands arrive through a
// cp.async ring kRing - 1 stages ahead (the TPU kernel's `chunk` window).
// It reports the backward passes, probe sweeps and apply sweeps each
// scenario ran.
//
// The box and weights variants (stream.py's use_box, use_weights; its
// weights ride the desired stream, here the operand ring) are the
// instantiations (kBox, kW), picked when the bounds or the weights are
// passed: solve.cu's backward pass, probes and seed cost with the variants,
// and the apply sweep is the probes' (kBox, kW) rollout, so the two kernels
// still agree bit for bit.
//
// The model families (JAX stream.py's lane models): compiled once per family
// (kernels/_build.py FAMILIES), as solve.cu; the batch solver routes a
// family here past its max_horizon_for(u) stages. The wrench, the 6- and
// 8-rotor multirotors, the drag quadrotor and the substepped quadrotor and
// drag quadrotor (k a kernel argument) have the instantiation without box or
// weights alone.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct StreamIO {
  Traj<T> x0;    // (N, d, B) initial trajectory
  Traj<T> live;  // out (N, d, B): the live, then the final trajectory
  T* cost;       // out (B,)
  int* iters;    // out (B,)
  int* status;   // out (B,)
  T* gains;      // scratch (N, B, P): k | K
  int* passes;   // out (B,): backward passes run
  int* probes;   // out (B,): probe sweeps run
  int* applies;  // out (B,): apply sweeps run
  int max_iters, ls_max_iters;
  T quu_reg, rtol, atol, ls_step, ls_frac;
  VariantOps<T> var;  // bounds and weights of the variants
};

template <typename T, bool kBox, bool kW, class M, class IO = StreamIO<T>>
__global__ void __launch_bounds__(kTeamThreads) stream_kernel(Problem<T> P, IO io) {
  Team<T, M> tm;
  if (!team_setup(P, &tm)) return;
  team_set_substeps(tm, io);
  const Problem<T> Ps = smem_problem(P, tm);
  const int N = P.N;
  team_copy_traj(tm, P, io.x0, io.live);
  // the loop never runs: report the initial trajectory's true cost
  T cost = io.max_iters == 0 ? team_trajectory_cost<T, kW>(tm, P, io.live, io.var) : T(0);
  int status = 0, iters = 0, passes = 0, stages = 0, applies = 0;
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass ----
    T qutk, ktquuk;
    team_backward<T, kBox, kW>(tm, P, Ps, io.quu_reg, io.live, false, io.live, io.gains, &qutk,
                               &ktquuk, io.var);
    ++passes;

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = i > 0 && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- cost-only probes; trip 0 force-accepts; then the apply sweep ----
    LineSearch<T> ls{false, current, T(1), 0};
    if (active) {
      ls = team_line_search<T, kBox, kW>(tm, P, io.live, io.live, false, io.gains, qutk, ktquuk,
                                         current, i == 0, io.ls_max_iters, io.ls_step,
                                         io.ls_frac, io.var);
      stages += ls.stages;
      team_rollout<T, kBox, kW>(tm, P, io.live, io.live, io.gains, ls.alpha, true, io.var);
      ++applies;
    }
    if (exact_trip_close(i == 0, pre_conv, active, ls, current, io.rtol, io.atol, &cost,
                         &status, &iters)) {
      break;
    }
  }
  ring_drain();
  if (tm.lane == 0) {
    const int b = tm.b;
    io.cost[b] = cost;
    io.iters[b] = iters;
    io.status[b] = status;
    io.passes[b] = passes;
    io.probes[b] = stages / N;
    io.applies[b] = applies;
  }
}

// packed operands after the Problem block:
//   ptrs:  q t v u  oq ot ov ou  cost iters status  gains  passes probes applies  lo hi w
//   ints:  max_iters ls_max_iters  s_box s_w  (a substepped family's k after them)
//   reals: quu_reg rtol atol ls_step ls_frac
template <typename T, class M>
int launch_stream(const void* const* ptrs, const long long* ints, const double* reals,
                  void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  const long long* ip = ints + kProblemInts;
  const double* rp = reals + kProblemReals;
  auto out = [&](int i) { return const_cast<void*>(p[i]); };
  StreamIO<T> io;
  io.x0 = traj_from<T>(p);
  io.live = traj_from<T>(p + 4);
  io.cost = static_cast<T*>(out(8));
  io.iters = static_cast<int*>(out(9));
  io.status = static_cast<int*>(out(10));
  io.gains = static_cast<T*>(out(11));
  io.passes = static_cast<int*>(out(12));
  io.probes = static_cast<int*>(out(13));
  io.applies = static_cast<int*>(out(14));
  io.max_iters = static_cast<int>(ip[0]);
  io.ls_max_iters = static_cast<int>(ip[1]);
  io.quu_reg = static_cast<T>(rp[0]);
  io.rtol = static_cast<T>(rp[1]);
  io.atol = static_cast<T>(rp[2]);
  io.ls_step = static_cast<T>(rp[3]);
  io.ls_frac = static_cast<T>(rp[4]);
  io.var = variant_from<T>(p + 15, ip + 2);
  const size_t bytes = team_block_bytes<T, M>(P.s_qr, P.s_par);
  if constexpr (std::is_same_v<M, Quadrotor>) {
    return with_variant(io.var, [&](auto box, auto w) {
      constexpr bool kBox = decltype(box)::value, kW = decltype(w)::value;
      return team_launch(stream_kernel<T, kBox, kW, M>, P.B, bytes, stream, P, io);
    });
  } else {
    // the other families have no variant instantiation (the host refuses them)
    if (io.var.lo != nullptr || io.var.w != nullptr) return cudaErrorNotSupported;
    if constexpr (M::kSub) {
      WithSubsteps<StreamIO<T>> sio;
      const int err = with_substeps<M>(io, ip + 2, &sio);
      if (err != 0) return err;
      return team_launch(stream_kernel<T, false, false, M, WithSubsteps<StreamIO<T>>>, P.B, bytes,
                         stream, P, sio);
    } else {
      return team_launch(stream_kernel<T, false, false, M>, P.B, bytes, stream, P, io);
    }
  }
}

}  // namespace qilqr

extern "C" int QILQR_ENTRY(stream, f32)(const void* const* ptrs, const long long* ints,
                                        const double* reals, void* stream) {
  return qilqr::launch_stream<float, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(stream, f64)(const void* const* ptrs, const long long* ints,
                                        const double* reals, void* stream) {
  return qilqr::launch_stream<double, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(stream, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Family>(f64, s_qr, s_par, out);
}
