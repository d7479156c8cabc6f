// The whole robust FDDP loop in one kernel without a candidate trajectory,
// one team of kTeamLanes lanes per scenario: the batch solvers' robust
// engine past 231 stages.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/stream_fddp.py:
// _stream_fddp_kernel (called through solve_fddp_streamed). It computes what
// fddp.cu computes, lane for lane, with the TPU kernel's schedule; a trip is
//   1. one reverse sweep that, on the trips that need them (the first, and
//      each after an accept), recomputes the defects d_n = f(x_n, u_n) (-)
//      x_{n+1} from the live trajectory, and runs the gap-transported
//      Riccati stage (Gauss-Newton, or exact DDP curvature with kDdp);
//   2. probe 0 at alpha = 1 with the exact quadratic model, then Goldstein
//      probes with the frozen-saturating cost fold, each probe summing costs
//      only and stopping at its scenario's freeze;
//   3. for an accepted scenario only, ONE apply sweep over the whole horizon
//      that re-rolls the candidate at the accepted alpha and writes it into
//      the live trajectory in place; a rejected scenario keeps its
//      trajectory for the mu retry;
//   4. the close: cost commit, mu schedule, status.
// The probes and the apply sweep run the same never-inlined sweep function
// (the model terms, the saturating fold and the store are runtime flags),
// and every stage cost goes through one never-inlined function, so the
// trajectory written is, bit for bit, the one whose cost was accepted, and
// a resumed launch's seed cost equals the committed one. Resume rows (mu,
// status, iterations) continue a solve; a scenario with a nonzero status is
// frozen and only copies its trajectory. With no probes every trip rejects.
//
// What bounds it on an H100: as stream.cu, the dependent chain of one
// scenario's stages (a Riccati stage ~12k operations, ~19k with kDdp, a
// probe stage ~1.4k); and a launch lasts as long as its slowest scenario,
// so the straggler scenarios of the exact-DDP launch, which run ~12 probe
// sweeps a trip (PERF.md section 5), set its time. What the design does
// about it (team.cuh): a team of lanes shares each scenario, the Riccati
// state and the curvature scratch live in shared memory, the products
// (with kDdp also sum v_x f_xx and the c_xx correction) are split over the
// team by output entries, the stage operands (live stage, k|K, the defects,
// the desired stage) arrive through a cp.async ring kRing - 1 stages ahead,
// and a probe sweep stops at its scenario's freeze. It reports the probe
// sweeps, defect trips and apply sweeps each scenario ran.
//
// The box and weights variants (stream_fddp.py's use_box, use_weights) are
// the instantiations (kBox, kW), each with and without kDdp, one variant an
// object, as fddp.cu's: the same never-inlined sweeps.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct StreamFddpIO {
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
  int* applies;       // out (B,): apply sweeps run
  T* gains;           // scratch (N, B, 52): k | K (the quadrotor's row)
  T* d;               // scratch (N, B, 12): the defects
  FddpKnobs<T> k;
  VariantOps<T> var;  // bounds and weights of the variants
};

template <typename T, bool kDdp, bool kBox, bool kW>
__global__ void __launch_bounds__(kTeamThreads) stream_fddp_kernel(Problem<T> P,
                                                                   StreamFddpIO<T> io) {
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
  bool stale = true;  // the defects need computing (trip 0, or after an accept)
  T gap = T(0);
  int stages_run = 0, defect_trips = 0, applies = 0;
  for (int i = 0; i < io.k.max_iters && !done; ++i) {
    const T current = cost;
    // ---- defects (when stale) + gap-transported backward pass ----
    defect_trips += stale ? 1 : 0;
    gap = team_fddp_reverse<T, kDdp, kBox, kW>(tm, P, io.k.quu_reg + mu, io.live, false,
                                               io.live, stale, io.gains, io.d, gap, io.var);
    // ---- the line search, cost-only probes ----
    const LineSearch<T> ls = team_fddp_line_search<T, kDdp, kBox, kW>(
        tm, P, io.k, io.live, io.live, false, io.gains, io.d, current, io.var);
    stages_run += ls.stages;
    // ---- apply sweep: the accepted candidate into the live trajectory ----
    if (ls.accepted) {
      team_gap_sweep<T, kDdp, kBox, kW>(tm, P, io.live, io.live, io.gains, io.d, ls.alpha,
                                        false, false, T(0), T(0), T(0), true, io.var);
      ++applies;
    }
    // ---- trip close (fddp.py _fddp_trip_close) ----
    done = fddp_trip_close(io.k, ls, current, gap, &cost, &mu, &status);
    iters += 1;
    stale = ls.accepted;
  }
  ring_drain();
  if (tm.lane == 0) {
    io.cost[b] = cost;
    io.iters[b] = iters;
    io.status[b] = status;
    io.mu[b] = mu;
    io.probes[b] = static_cast<T>(stages_run) / static_cast<T>(N);
    io.defect_trips[b] = defect_trips;
    io.applies[b] = applies;
  }
}

// packed operands after the Problem block:
//   ptrs:  q t v u  imu istat iiter  oq ot ov ou  cost iters status mu probes
//          gains d  defect_trips applies  lo hi w
//   ints and reals: as fddp.cu (FddpKnobs, then s_box s_w)
template <typename T, bool kBox, bool kW>
int launch_stream_fddp(const void* const* ptrs, const long long* ints, const double* reals,
                       void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  auto out = [&](int i) { return const_cast<void*>(p[i]); };
  StreamFddpIO<T> io;
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
  io.d = static_cast<T*>(out(17));
  io.defect_trips = static_cast<int*>(out(18));
  io.applies = static_cast<int*>(out(19));
  io.k = fddp_knobs<T>(ints + kProblemInts, reals + kProblemReals);
  io.var = variant_from<T>(p + 20, ints + kProblemInts + 3);
  // the variant of this object's entries, as fddp.cu's
  if ((io.var.lo != nullptr) != kBox || (io.var.w != nullptr) != kW) return cudaErrorNotSupported;
  const size_t smem = team_block_bytes<T, Quadrotor>(P.s_qr, P.s_par);
  return io.k.ddp ? team_launch(stream_fddp_kernel<T, true, kBox, kW>, P.B, smem, stream, P, io)
                  : team_launch(stream_fddp_kernel<T, false, kBox, kW>, P.B, smem, stream, P, io);
}

}  // namespace qilqr

extern "C" int QILQR_VENTRY(stream_fddp, f32)(const void* const* ptrs, const long long* ints,
                                     const double* reals, void* stream) {
  return qilqr::launch_stream_fddp<float, QILQR_BOX, QILQR_WEIGHTS>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_VENTRY(stream_fddp, f64)(const void* const* ptrs, const long long* ints,
                                     const double* reals, void* stream) {
  return qilqr::launch_stream_fddp<double, QILQR_BOX, QILQR_WEIGHTS>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_VENTRY(stream_fddp, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Quadrotor>(f64, s_qr, s_par, out);
}
