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
// Riccati state lives in shared memory, the 12x12 and 12x4 products are
// split over the team by output entries, Q, R and the model parameters are
// read from shared memory, and each stage's operands arrive through a
// cp.async ring kRing - 1 stages ahead (the TPU kernel's `chunk` window).
// It reports the backward passes, probe sweeps and apply sweeps each
// scenario ran.
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
  T* gains;      // scratch (N, B, 52): k | K
  int* passes;   // out (B,): backward passes run
  int* probes;   // out (B,): probe sweeps run
  int* applies;  // out (B,): apply sweeps run
  int max_iters, ls_max_iters;
  T quu_reg, rtol, atol, ls_step, ls_frac;
};

template <typename T>
__global__ void __launch_bounds__(kTeamThreads) stream_kernel(Problem<T> P, StreamIO<T> io) {
  Team<T> tm;
  if (!team_setup(P, &tm)) return;
  const Problem<T> Ps = smem_problem(P, tm);
  const int N = P.N;
  team_copy_traj(tm, P, io.x0, io.live);
  // the loop never runs: report the initial trajectory's true cost
  T cost = io.max_iters == 0 ? team_trajectory_cost(tm, P, io.live) : T(0);
  int status = 0, iters = 0, passes = 0, stages = 0, applies = 0;
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass ----
    T qutk, ktquuk;
    team_backward(tm, P, Ps, io.quu_reg, io.live, false, io.live, io.gains, &qutk, &ktquuk);
    ++passes;

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = i > 0 && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- cost-only probes; trip 0 force-accepts; then the apply sweep ----
    LineSearch<T> ls{false, current, T(1), 0};
    if (active) {
      ls = team_line_search(tm, P, io.live, io.live, false, io.gains, qutk, ktquuk, current,
                            i == 0, io.ls_max_iters, io.ls_step, io.ls_frac);
      stages += ls.stages;
      team_rollout(tm, P, io.live, io.live, io.gains, ls.alpha, true);
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
//   ptrs:  q t v u  oq ot ov ou  cost iters status  gains  passes probes applies
//   ints:  max_iters ls_max_iters
//   reals: quu_reg rtol atol ls_step ls_frac
template <typename T>
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
  return team_launch(stream_kernel<T>, P.B, team_block_bytes<T>(P.s_qr, P.s_par), stream, P, io);
}

}  // namespace qilqr

extern "C" int qilqr_stream_f32(const void* const* ptrs, const long long* ints,
                                const double* reals, void* stream) {
  return qilqr::launch_stream<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_stream_f64(const void* const* ptrs, const long long* ints,
                                const double* reals, void* stream) {
  return qilqr::launch_stream<double>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_stream_team_info(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info(f64, s_qr, s_par, out);
}
