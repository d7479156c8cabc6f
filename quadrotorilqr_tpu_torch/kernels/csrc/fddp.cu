// The whole robust FDDP loop in one kernel, one team of kTeamLanes lanes per
// scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/fddp.py:
// _fddp_kernel (called through solve_fddp_fused), including its trip state
// machine _goldstein_probe_commit / _fddp_trip_close. Each team runs its
// scenario's solve in the flattened-trip form of solver/fddp.py; a trip is
//   1. one reverse sweep that merges the previous trip's accepted candidate
//      (its ring fetches the stages from the candidate buffer and writes
//      them into the live trajectory), computes the defects
//      d_n = f(x_n, u_n) (-) x_{n+1} and their max |d|, and runs the Riccati
//      stage on the gap-transported gradient v_x + V_xx d_n with
//      Quu + (quu_reg + mu) I (exact DDP curvature when kDdp). A retry trip
//      (the lane rejected its last one) skips merge and defects: the
//      trajectory, d and the gap are unchanged;
//   2. probe 0 at alpha = 1, whose forward sweep also carries the exact
//      quadratic model p' = J_x p + J_u w + d, dJ(alpha) = alpha L1 +
//      alpha^2 L2, and sums its cost raw;
//   3. probes 1.. with escalated backtracking and the frozen-saturating cost
//      fold (solver/fddp._saturating_stage_cost_add). Once the fold freezes
//      (its Goldstein crossing) nothing later can change it, so the team
//      stops that probe's sweep: the committed values are those of the full
//      fold. The TPU kernel stops a tile only at 8-stage checks, a tile cost
//      and no part of the semantics. Every probe stores its candidate into
//      the candidate buffer as it goes;
//   4. the close: the cost commit, the mu schedule keyed on the accepted
//      alpha, LINE_SEARCH_FAILED on a rejection at reg_max, CONVERGED on an
//      accepted step from an iterate whose gap was already below gap_tol.
// Every trip counts against max_iters. With no probes (ls_max_iters 0) every
// trip rejects, so only the mu schedule runs. The last accepted candidate
// merges after the loop. Resume rows (mu, status, iterations) continue a
// solve: a lane with a nonzero status is frozen and only copies its
// trajectory.
//
// Stage costs sum as c + (dx'Q dx + du'R du) through one non-inlined
// function, so the seed cost of a resumed phase is bit-equal to the cost
// the previous phase committed for the same trajectory. The reverse sweep,
// the line search and the gap sweep are team_trip.cuh's never-inlined
// functions, which stream_fddp.cu runs too, so in float64 the two kernels
// give the same bits.
//
// What bounds it on an H100: the dependent chain of one scenario's stages
// (a Riccati stage ~12k operations, ~19k with kDdp, a probe stage ~1.4k);
// and a launch lasts as long as its slowest scenario, so the straggler
// scenarios of the exact-DDP launch, which run ~12 probe sweeps a trip
// (PERF.md section 5), set its time. The per-thread design ran the chain in
// one thread with the Riccati state in local memory. What this design does
// about it (team.cuh): a team of lanes shares each scenario, the Riccati
// state and the curvature scratch live in shared memory, the products are
// split over the team by output entries, the stage operands arrive through
// a cp.async ring kRing - 1 stages ahead, a probe sweep stops at its
// scenario's freeze, and the candidate is merged by the sweep that reads it;
// kDdp is a template flag so the Gauss-Newton phases pay nothing for it.
// A team is 4 lanes here, 8 in the other team kernels: at config 6's N = 50
// the launch ends on a few straggler scenarios' long line searches, whose
// serial probe stages gain nothing from a wider team, and 4 lanes won both
// launches (PERF.md section 6).
//
// The box and weights variants (fddp.py's use_box, use_weights) are the
// instantiations (kBox, kW), each with and without kDdp: the reverse sweep
// runs the Riccati stage's box-QP gains and weighted cost terms, the gap
// sweeps clamp every control and weight each stage cost and the quadratic
// model's terms, the seed cost is weighted. The trip logic is the same. The
// source is compiled once per variant (team.cuh QILQR_VARIANT), and the host
// calls the entry of the variant its bounds and weights ask for.
#define QILQR_TEAM_LANES 4  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct FddpIO {
  Traj<T> x0;         // (N, d, B) initial trajectory
  const T* imu;       // (B,) initial mu, or null for zeros
  const int* istat;   // (B,) initial status, or null for zeros
  const int* iiter;   // (B,) initial iterations, or null for zeros
  Traj<T> live;       // out (N, d, B): the live, then the final trajectory
  T* cost;            // out (B,)
  int* iters;         // out (B,)
  int* status;        // out (B,)
  T* mu;              // out (B,)
  T* probes;          // out (B,): stages the probes ran / N
  int* defect_trips;  // out (B,): trips whose reverse sweep computed the defects
  T* gains;           // scratch (N, B, 52): k | K (the quadrotor's row)
  Traj<T> best;       // scratch (N, d, B): the line search's candidate
  T* d;               // scratch (N, B, 12): the defects
  FddpKnobs<T> k;
  VariantOps<T> var;  // bounds and weights of the variants
};

template <typename T, bool kDdp, bool kBox, bool kW>
__global__ void __launch_bounds__(kTeamThreads) fddp_kernel(Problem<T> P, FddpIO<T> io) {
  Team<T, Quadrotor> tm;
  if (!team_setup(P, &tm)) return;
  const int b = tm.b, N = P.N;
  team_copy_traj(tm, P, io.x0, io.live);
  T mu = io.imu != nullptr ? io.imu[b] : T(0);
  int status = io.istat != nullptr ? io.istat[b] : 0;
  int iters = io.iiter != nullptr ? io.iiter[b] : 0;
  bool done = status != 0;
  // FDDP seeds from the true (possibly infeasible) trajectory's cost
  T cost = team_fddp_cost<T, kW>(tm, P, io.live, io.var);
  bool take = false;  // the last trip accepted a candidate not yet merged
  bool stale = true;  // the defects need computing (trip 0, or after an accept)
  T gap = T(0);
  int stages_run = 0, defect_trips = 0;
  for (int i = 0; i < io.k.max_iters && !done; ++i) {
    const T current = cost;
    // ---- fused merge + defects + gap-transported backward pass ----
    defect_trips += stale ? 1 : 0;
    gap = team_fddp_reverse<T, kDdp, kBox, kW>(tm, P, io.k.quu_reg + mu,
                                               take ? io.best : io.live, take, io.live, stale,
                                               io.gains, io.d, gap, io.var);
    // ---- the line search, each probe stored as the candidate ----
    const LineSearch<T> ls = team_fddp_line_search<T, kDdp, kBox, kW>(
        tm, P, io.k, io.live, io.best, true, io.gains, io.d, current, io.var);
    stages_run += ls.stages;
    // ---- trip close (fddp.py _fddp_trip_close) ----
    done = fddp_trip_close(io.k, ls, current, gap, &cost, &mu, &status);
    iters += 1;
    take = ls.accepted;
    stale = take;
  }
  ring_drain();
  // the last trip's accepted candidate was never merged by a following sweep
  if (take) team_copy_traj(tm, P, io.best, io.live);
  if (tm.lane == 0) {
    io.cost[b] = cost;
    io.iters[b] = iters;
    io.status[b] = status;
    io.mu[b] = mu;
    io.probes[b] = static_cast<T>(stages_run) / static_cast<T>(N);
    io.defect_trips[b] = defect_trips;
  }
}

// packed operands after the Problem block:
//   ptrs:  q t v u  imu istat iiter  oq ot ov ou  cost iters status mu probes
//          gains  bq bt bv bu  d  defect_trips  lo hi w
//   ints:  max_iters ls_max_iters ddp  s_box s_w
//   reals: quu_reg rtol atol ls_step ls_jump goldstein_frac goldstein_ub gap_tol
//          reg_init reg_scale_up reg_scale_down reg_min reg_max alpha_dec alpha_inc
template <typename T, bool kBox, bool kW>
int launch_fddp(const void* const* ptrs, const long long* ints, const double* reals,
                void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  auto out = [&](int i) { return const_cast<void*>(p[i]); };
  FddpIO<T> io;
  io.x0 = traj_from<T>(p);
  io.imu = static_cast<const T*>(p[4]);
  io.istat = static_cast<const int*>(p[5]);
  io.iiter = static_cast<const int*>(p[6]);
  io.live = traj_from<T>(p + 7);
  io.cost = static_cast<T*>(out(11));
  io.iters = static_cast<int*>(out(12));
  io.status = static_cast<int*>(out(13));
  io.mu = static_cast<T*>(out(14));
  io.probes = static_cast<T*>(out(15));
  io.gains = static_cast<T*>(out(16));
  io.best = traj_from<T>(p + 17);
  io.d = static_cast<T*>(out(21));
  io.defect_trips = static_cast<int*>(out(22));
  io.k = fddp_knobs<T>(ints + kProblemInts, reals + kProblemReals);
  io.var = variant_from<T>(p + 23, ints + kProblemInts + 3);
  // the variant of this object's entries (QILQR_BOX, QILQR_WEIGHTS): the
  // host picks the entry by the operands it passes
  if ((io.var.lo != nullptr) != kBox || (io.var.w != nullptr) != kW) return cudaErrorNotSupported;
  const size_t smem = team_block_bytes<T, Quadrotor>(P.s_qr, P.s_par);
  return io.k.ddp ? team_launch(fddp_kernel<T, true, kBox, kW>, P.B, smem, stream, P, io)
                  : team_launch(fddp_kernel<T, false, kBox, kW>, P.B, smem, stream, P, io);
}

}  // namespace qilqr

#if !QILQR_BOX && !QILQR_WEIGHTS  // once in the library
extern "C" const char* qilqr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif

extern "C" int QILQR_VENTRY(fddp, f32)(const void* const* ptrs, const long long* ints,
                              const double* reals, void* stream) {
  return qilqr::launch_fddp<float, QILQR_BOX, QILQR_WEIGHTS>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_VENTRY(fddp, f64)(const void* const* ptrs, const long long* ints,
                              const double* reals, void* stream) {
  return qilqr::launch_fddp<double, QILQR_BOX, QILQR_WEIGHTS>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_VENTRY(fddp, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Quadrotor>(f64, s_qr, s_par, out);
}
