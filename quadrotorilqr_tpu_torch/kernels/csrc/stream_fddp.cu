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
#include "team.cuh"

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
  T* gains;           // scratch (N, B, 52): k | K
  T* d;               // scratch (N, B, 12): the defects
  FddpKnobs<T> k;
};

// The team Riccati stage compiled as a function of its own, as fddp.cu
// compiles riccati_stage apart from its sweep.
template <typename T, bool kDdp>
__device__ __noinline__ void team_riccati_stage_call(Team<T> tm, Problem<T> Ps, T quu_reg,
                                                     const T* slot, T* qutk, T* ktquuk) {
  team_riccati_stage<T, kDdp>(tm, Ps, quu_reg, slot, qutk, ktquuk);
}

// One FDDP reverse sweep of the team's scenario over its live trajectory.
// With `stale` it recomputes the defects d_n = f(x_n, u_n) (-) x_{n+1}
// (d_{N-1} = 0) into d and their max |d| into *gap; otherwise it reads the
// stored defects. Every stage transports the value gradient across its gap,
// v_x + V_xx d_n, and runs the Riccati stage with quu_reg (exact DDP
// curvature when kDdp); the gains go to the gains scratch.
template <typename T, bool kDdp>
__device__ __forceinline__ void team_fddp_reverse(const Team<T>& tm, const Problem<T>& P,
                                                  const Problem<T>& Ps, T quu_reg,
                                                  const Traj<T>& live, bool stale, T* gains,
                                                  T* d, T* gap) {
  const Tile tile = team_tile();
  TeamState<T>& S = *tm.s;
  if (stale) *gap = T(0);
  team_zero_value(tm);
  T q1[4], t1[3], v1[6];  // live stage n + 1, from the step before
  ring_sweep(tm, P, RingSrc<T>{live, nullptr, stale ? nullptr : d}, true,
             [&](int n, const T* slot) {
    T q[4], t[3], v[6], u[4], dk[12];
    read_stage(slot + kSlotLive, q, t, v, u);
    if (stale) {
      if (n < P.N - 1) {
        T qn[4], tn[3], vn[6];
#pragma unroll
        for (int j = 0; j < 4; ++j) qn[j] = q[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) tn[j] = t[j];
#pragma unroll
        for (int j = 0; j < 6; ++j) vn[j] = v[j];
        dynamics_step(Ps, 0, qn, tn, vn, u);
        state_minus(qn, tn, vn, q1, t1, v1, dk);
#pragma unroll
        for (int j = 0; j < 12; ++j) *gap = nan_max(*gap, f_abs(dk[j]));
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) dk[j] = T(0);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) S.dk[j] = dk[j];
      tile.sync();
      team_put_row(tm, S.dk, scratch_row(d, P.B, n, tm.b, 12), 12);
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) dk[j] = slot[kSlotD + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) q1[j] = q[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) t1[j] = t[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) v1[j] = v[j];
    // first-order value transport across the gap
    team_each<12>(tm.lane, [&](int r) {
      T acc = S.vxx[r * 12] * dk[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc += S.vxx[r * 12 + j] * dk[j];
      S.v_x[r] = S.v_x[r] + acc;
    });
    tile.sync();
    T qutk, ktquuk;
    team_riccati_stage_call<T, kDdp>(tm, Ps, quu_reg, slot, &qutk, &ktquuk);
    team_put_row(tm, S.gains, scratch_row(gains, P.B, n, tm.b, 52), 52);
    return true;
  });
}

// What one gap-contracting sweep leaves: its cost fold, the quadratic
// model's terms (probe 0) and the stages it ran.
template <typename T>
struct GapSweep {
  T c, l1, l2;
  int stages;
};

// One gap-contracting sweep of the team's scenario from its live trajectory
// x at step alpha (rollout_gap_stage over the horizon): per stage the
// control from the carry, the stage cost summed raw or (with `sat`) with
// the frozen-saturating fold, the stage written back into x when `store`,
// then the carry stepped to f(x_n, u_n) (+) (-(1 - alpha) d_n). With `model`
// it also carries probe 0's exact quadratic model at the live stages
// (fddp_model_stage, p <- J_x p + J_u w + d_n). With `sat` it stops where
// the fold freezes: nothing later can change it. Never inlined, and the
// flags are runtime values: the probes and the apply sweep run the same
// instructions.
template <typename T, bool kDdp>
__device__ __noinline__ GapSweep<T> team_gap_sweep(Team<T> tm, Problem<T> P, Traj<T> x,
                                                   const T* gains, const T* d, T alpha,
                                                   bool model, bool sat, T gdj, T current, T cap,
                                                   bool store) {
  const Problem<T> Ps = smem_problem(P, tm);
  GapSweep<T> o{T(0), T(0), T(0), 0};
  T q[4], t[3], v[6], p[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) p[j] = T(0);
  ring_sweep(tm, P, RingSrc<T>{x, gains, d}, false, [&](int n, const T* slot) {
    if (sat && (o.c - current) > gdj) return false;  // frozen
    T qo[4], to[3], vo[6], uo[4], dx[12];
    read_stage(slot + kSlotLive, qo, to, vo, uo);
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = qo[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = to[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = vo[i];
    }
    // model terms at the live stage (not the rollout carry)
    T p2[12];
    if (model) team_model_stage<T, kDdp>(tm, Ps, slot, p, p2, &o.l1, &o.l2);
    StageVals<T> sv;
    state_minus(q, t, v, qo, to, vo, dx);
    const T* g = slot + kSlotGains;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      T fb = g[4 + a * 12] * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) fb += g[4 + a * 12 + j] * dx[j];
      sv.u[a] = (uo[a] + alpha * g[a]) + fb;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sv.q[i] = q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sv.t[i] = t[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) sv.v[i] = v[i];
    const T cs = team_fddp_stage_cost(tm.cc, slot + kSlotDes, sv);
    if (sat) {
      const bool frozen = (o.c - current) > gdj;
      T c2 = o.c + cs;
      c2 = (c2 <= cap) ? c2 : cap;
      o.c = frozen ? o.c : c2;
    } else {
      o.c = o.c + cs;
    }
    if (store) team_store_stage(tm, x, P.B, n, q, t, v, sv.u);
    dynamics_step(Ps, 0, q, t, v, sv.u);
    T tau[12], qe[4], te[3], qn[4], tn[3];
    const T shrink = -(T(1) - alpha);
#pragma unroll
    for (int i = 0; i < 12; ++i) tau[i] = shrink * slot[kSlotD + i];
    se3_exp(tau, qe, te);
    se3_multiply(q, t, qe, te, qn, tn);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = tn[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = v[i] + tau[6 + i];
    if (model) {
#pragma unroll
      for (int j = 0; j < 12; ++j) p[j] = p2[j] + slot[kSlotD + j];
    }
    ++o.stages;
    return true;
  });
  return o;
}

// The FDDP seed: the team's trajectory cost, stage costs summed from 0 up
// (fddp_cost_lane).
template <typename T>
__device__ __forceinline__ T team_fddp_cost(const Team<T>& tm, const Problem<T>& P,
                                            const Traj<T>& x) {
  T cost = T(0);
  ring_sweep(tm, P, RingSrc<T>{x, nullptr, nullptr}, false, [&](int n, const T* slot) {
    StageVals<T> sv;
    read_stage(slot + kSlotLive, sv.q, sv.t, sv.v, sv.u);
    cost = cost + team_fddp_stage_cost(tm.cc, slot + kSlotDes, sv);
    return true;
  });
  return cost;
}

// The Goldstein line search from the live trajectory x
// (fddp.py _goldstein_probe_commit): probe 0 at alpha = 1 also carries the
// exact quadratic model dJ(alpha) = alpha L1 + alpha^2 L2 and sums its cost
// raw; probes 1.. fold with the frozen-saturating add and stop at the
// freeze. A probe is accepted when its cost change is within the Goldstein
// band and finite; a rejection backtracks by ls_step, or by ls_jump when the
// probe exploded. The probes sum costs only and store nothing. With no
// probes the search rejects.
template <typename T, bool kDdp>
__device__ __forceinline__ LineSearch<T> team_fddp_line_search(const Team<T>& tm,
                                                               const Problem<T>& P,
                                                               const FddpKnobs<T>& k,
                                                               const Traj<T>& x, const T* gains,
                                                               const T* d, T current) {
  LineSearch<T> ls{false, current, T(1), 0};
  T alpha = T(1), l1 = T(0), l2 = T(0);
  if (k.ls_max_iters >= 1) {
    const GapSweep<T> o = team_gap_sweep<T, kDdp>(tm, P, x, gains, d, alpha, true, false, T(0),
                                                  current, T(0), false);
    l1 = o.l1;
    l2 = o.l2;
    const T c = o.c;
    ls.stages += P.N;
    const T dj = alpha * l1 + alpha * alpha * l2;
    const T gdj = ((dj <= T(0)) ? k.gf : k.gub) * dj;
    ls.cost = c;
    ls.accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
    const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
    if (!ls.accepted) alpha = (c < cap) ? alpha * k.ls_step : alpha * k.ls_jump;
  }
  for (int j = 1; j < k.ls_max_iters && !ls.accepted; ++j) {
    const T dj = alpha * l1 + alpha * alpha * l2;
    const T gdj = ((dj <= T(0)) ? k.gf : k.gub) * dj;
    const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
    const GapSweep<T> o = team_gap_sweep<T, kDdp>(tm, P, x, gains, d, alpha, false, true, gdj,
                                                  current, cap, false);
    const T c = o.c;
    ls.stages += o.stages;
    ls.cost = c;
    ls.accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
    if (!ls.accepted) alpha = (c < cap) ? alpha * k.ls_step : alpha * k.ls_jump;
  }
  ls.alpha = alpha;
  return ls;
}

// The FDDP trip close (fddp.py _fddp_trip_close): the cost commit on an
// accept, the mu schedule keyed on the accepted alpha, LINE_SEARCH_FAILED (2)
// on a rejection at reg_max, CONVERGED (1) on an accepted step from an
// iterate whose gap was already below gap_tol. Returns whether the lane is
// done.
template <typename T>
__device__ __forceinline__ bool fddp_trip_close(const FddpKnobs<T>& k, const LineSearch<T>& ls,
                                                T current, T gap, T* cost, T* mu, int* status) {
  if (ls.accepted) *cost = ls.cost;
  const T m = *mu;
  const bool headroom = m < k.reg_max;
  const bool terminal = !ls.accepted && !headroom;
  T mu_dec = m * k.reg_down;
  if (mu_dec < k.reg_min) mu_dec = T(0);
  T mu_inc = m * k.reg_up;
  mu_inc = (m == T(0)) ? k.reg_init : ((mu_inc > k.reg_max) ? k.reg_max : mu_inc);
  const T mu_accept = (ls.alpha >= k.a_dec) ? mu_dec : ((ls.alpha <= k.a_inc) ? mu_inc : m);
  *mu = ls.accepted ? mu_accept : (headroom ? mu_inc : m);
  const bool post_conv =
      ls.accepted && gap < k.gap_tol && converged(current, ls.cost, k.rtol, k.atol);
  *status = terminal ? 2 : (post_conv ? 1 : *status);
  return post_conv || terminal;
}

template <typename T, bool kDdp>
__global__ void __launch_bounds__(kTeamThreads) stream_fddp_kernel(Problem<T> P,
                                                                   StreamFddpIO<T> io) {
  Team<T> tm;
  if (!team_setup(P, &tm)) return;
  const Problem<T> Ps = smem_problem(P, tm);
  const int b = tm.b, N = P.N;
  team_copy_traj(tm, P, io.x0, io.live);
  T mu = io.imu != nullptr ? io.imu[b] : T(0);
  int status = io.istat != nullptr ? io.istat[b] : 0;
  int iters = io.iiter != nullptr ? io.iiter[b] : 0;
  bool done = status != 0;
  // FDDP seeds from the true (possibly infeasible) trajectory's cost
  T cost = team_fddp_cost(tm, P, io.live);
  bool stale = true;  // the defects need computing (trip 0, or after an accept)
  T gap = T(0);
  int stages_run = 0, defect_trips = 0, applies = 0;
  for (int i = 0; i < io.k.max_iters && !done; ++i) {
    const T current = cost;
    // ---- defects (when stale) + gap-transported backward pass ----
    defect_trips += stale ? 1 : 0;
    team_fddp_reverse<T, kDdp>(tm, P, Ps, io.k.quu_reg + mu, io.live, stale, io.gains, io.d,
                               &gap);
    // ---- the line search, cost-only probes ----
    const LineSearch<T> ls =
        team_fddp_line_search<T, kDdp>(tm, P, io.k, io.live, io.gains, io.d, current);
    stages_run += ls.stages;
    // ---- apply sweep: the accepted candidate into the live trajectory ----
    if (ls.accepted) {
      team_gap_sweep<T, kDdp>(tm, P, io.live, io.gains, io.d, ls.alpha, false, false, T(0),
                              T(0), T(0), true);
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
//          gains d  defect_trips applies
//   ints and reals: as fddp.cu (FddpKnobs)
template <typename T>
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
  const size_t smem = team_block_bytes<T>(P.s_qr, P.s_par);
  if (io.k.ddp) return team_launch(stream_fddp_kernel<T, true>, P.B, smem, stream, P, io);
  return team_launch(stream_fddp_kernel<T, false>, P.B, smem, stream, P, io);
}

}  // namespace qilqr

extern "C" int qilqr_stream_fddp_f32(const void* const* ptrs, const long long* ints,
                                     const double* reals, void* stream) {
  return qilqr::launch_stream_fddp<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_stream_fddp_f64(const void* const* ptrs, const long long* ints,
                                     const double* reals, void* stream) {
  return qilqr::launch_stream_fddp<double>(ptrs, ints, reals, stream);
}
