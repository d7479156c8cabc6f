// The whole robust FDDP loop in one kernel, one thread per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/fddp.py:
// _fddp_kernel (called through solve_fddp_fused), including its trip state
// machine _goldstein_probe_commit / _fddp_trip_close. Each thread runs its
// scenario's solve in the flattened-trip form of solver/fddp.py; a trip is
//   1. one reverse sweep that merges the previous trip's accepted candidate,
//      computes the defects d_n = f(x_n, u_n) (-) x_{n+1} and their max |d|,
//      and runs the Riccati stage on the gap-transported gradient
//      v_x + V_xx d_n with Quu + (quu_reg + mu) I (exact DDP curvature when
//      kDdp). A retry trip (the lane rejected its last one) skips merge and
//      defects: the trajectory, d and the gap are unchanged;
//   2. probe 0 at alpha = 1, whose forward sweep also carries the exact
//      quadratic model p' = J_x p + J_u w + d, dJ(alpha) = alpha L1 +
//      alpha^2 L2, and sums its cost raw;
//   3. probes 1.. with escalated backtracking and the frozen-saturating cost
//      fold (solver/fddp._saturating_stage_cost_add). Once the fold freezes
//      (its Goldstein crossing) nothing later can change it, so the thread
//      stops that probe's sweep: the committed values are those of the full
//      fold. The TPU kernel stops a tile only at 8-stage checks, a tile cost
//      and no part of the semantics;
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
// the previous phase committed for the same trajectory.
//
// What bounds it on an H100: as solve.cu, one thread's Riccati stage keeps
// about 400 values (more with kDdp) in local memory, and B = 4096 is about
// one warp per SM, so each thread's chain of dependent loads sets the time
// (latency-bound); the lanes also run for different numbers of trips and
// probes, and a warp lasts as long as its slowest lane. What the design does
// about it: no launch or host round trip inside the solve, scenario-minor
// buffers for coalesced loads, a probe sweep that stops at its freeze, and
// kDdp as a template flag so the Gauss-Newton phases pay nothing for it.
#include "quadrotor.cuh"

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
  T* ks;              // scratch (N, 4, B)
  T* bigks;           // scratch (N, 4, 12, B)
  Traj<T> best;       // scratch (N, d, B): the line search's candidate
  T* d;               // scratch (N, 12, B): the defects
  FddpKnobs<T> k;
};

template <typename T, bool kDdp>
__global__ void fddp_kernel(Problem<T> P, FddpIO<T> io) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const int B = P.B, N = P.N;
  copy_traj(io.x0, io.live, B, N, b);
  T mu = io.imu != nullptr ? io.imu[b] : T(0);
  int status = io.istat != nullptr ? io.istat[b] : 0;
  int iters = io.iiter != nullptr ? io.iiter[b] : 0;
  bool done = status != 0;
  // FDDP seeds from the true (possibly infeasible) trajectory's cost
  T cost = fddp_cost_lane(P, io.live, b);
  bool take = false;  // the last trip accepted a candidate not yet merged
  bool stale = true;  // the defects need computing (trip 0, or after an accept)
  T gap = T(0);
  int stages_run = 0, defect_trips = 0;
  StageScratch<T> S;
  for (int i = 0; i < io.k.max_iters && !done; ++i) {
    const T current = cost;
    const T quu_reg = io.k.quu_reg + mu;

    // ---- fused merge + defects + gap-transported backward pass ----
    if (stale) {
      gap = T(0);
      ++defect_trips;
    }
    T v_x[12], v_xx[144];
    for (int j = 0; j < 12; ++j) v_x[j] = T(0);
    for (int j = 0; j < 144; ++j) v_xx[j] = T(0);
    for (int n = N - 1; n >= 0; --n) {
      T q[4], t[3], v[6], u[4], dk[12];
      if (stale) {
        if (take) {
          load_stage(io.best, B, n, b, q, t, v, u);
          store_stage(io.live, B, n, b, q, t, v, u);
        } else {
          load_stage(io.live, B, n, b, q, t, v, u);
        }
        if (n < N - 1) {
          // stage n + 1 merged before stage n reads it
          T qn[4], tn[3], vn[6], q1[4], t1[3], v1[6], u1[4];
          for (int j = 0; j < 4; ++j) qn[j] = q[j];
          for (int j = 0; j < 3; ++j) tn[j] = t[j];
          for (int j = 0; j < 6; ++j) vn[j] = v[j];
          dynamics_step(P, b, qn, tn, vn, u);
          load_stage(io.live, B, n + 1, b, q1, t1, v1, u1);
          state_minus(qn, tn, vn, q1, t1, v1, dk);
          for (int j = 0; j < 12; ++j) gap = nan_max(gap, f_abs(dk[j]));
        } else {
          for (int j = 0; j < 12; ++j) dk[j] = T(0);
        }
        for (int j = 0; j < 12; ++j) io.d[(n * 12 + j) * B + b] = dk[j];
      } else {
        load_stage(io.live, B, n, b, q, t, v, u);
        for (int j = 0; j < 12; ++j) dk[j] = io.d[(n * 12 + j) * B + b];
      }
      // first-order value transport across the gap
      for (int r = 0; r < 12; ++r) {
        T acc = v_xx[r * 12] * dk[0];
        for (int j = 1; j < 12; ++j) acc += v_xx[r * 12 + j] * dk[j];
        v_x[r] = v_x[r] + acc;
      }
      T k[4], K[48], qutk, ktquuk;
      riccati_stage<T, kDdp>(P, quu_reg, n, b, q, t, v, u, v_x, v_xx, S, k, K, &qutk, &ktquuk);
      for (int j = 0; j < 4; ++j) io.ks[(n * 4 + j) * B + b] = k[j];
      for (int j = 0; j < 48; ++j) io.bigks[(n * 48 + j) * B + b] = K[j];
    }

    // ---- probe 0 with the exact quadratic model ----
    T alpha = T(1);
    bool accepted = false;
    T best_cost = current;
    T l1 = T(0), l2 = T(0);
    if (io.k.ls_max_iters >= 1) {
      T q[4], t[3], v[6], u[4], p[12], ju[16];
      load_stage(io.live, B, 0, b, q, t, v, u);
      for (int j = 0; j < 12; ++j) p[j] = T(0);
      for (int j = 0; j < 16; ++j) ju[j] = P.par(P.ju, 32 + j, b);
      T c = T(0);
      for (int n = 0; n < N; ++n) {
        // model terms at the live stage (not the rollout carry)
        T p2[12];
        fddp_model_stage<T, kDdp>(P, io.live, io.ks, io.bigks, io.d, n, b, S, ju, p, p2, &l1,
                                  &l2);
        c = rollout_gap_stage(P, io.live, io.ks, io.bigks, io.d, alpha, false, T(0), T(0), T(0),
                              io.best, true, n, b, q, t, v, c);
        for (int j = 0; j < 12; ++j) p[j] = p2[j] + io.d[(n * 12 + j) * B + b];
      }
      stages_run += N;
      // Goldstein accept/backtrack (fddp.py _goldstein_probe_commit)
      const T dj = alpha * l1 + alpha * alpha * l2;
      const T gdj = ((dj <= T(0)) ? io.k.gf : io.k.gub) * dj;
      best_cost = c;
      accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
      const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
      if (!accepted) alpha = (c < cap) ? alpha * io.k.ls_step : alpha * io.k.ls_jump;
    }
    for (int j = 1; j < io.k.ls_max_iters && !accepted; ++j) {
      const T dj = alpha * l1 + alpha * alpha * l2;
      const T gdj = ((dj <= T(0)) ? io.k.gf : io.k.gub) * dj;
      const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
      T q[4], t[3], v[6], u[4];
      load_stage(io.live, B, 0, b, q, t, v, u);
      T c = T(0);
      for (int n = 0; n < N; ++n) {
        if ((c - current) > gdj) break;  // frozen: the rest cannot change c
        c = rollout_gap_stage(P, io.live, io.ks, io.bigks, io.d, alpha, true, gdj, current, cap,
                              io.best, true, n, b, q, t, v, c);
        ++stages_run;
      }
      best_cost = c;
      accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
      if (!accepted) alpha = (c < cap) ? alpha * io.k.ls_step : alpha * io.k.ls_jump;
    }

    // ---- trip close (fddp.py _fddp_trip_close) ----
    take = accepted;
    if (take) cost = best_cost;
    const bool headroom = mu < io.k.reg_max;
    const bool terminal = !accepted && !headroom;
    T mu_dec = mu * io.k.reg_down;
    if (mu_dec < io.k.reg_min) mu_dec = T(0);
    T mu_inc = mu * io.k.reg_up;
    mu_inc = (mu == T(0)) ? io.k.reg_init : ((mu_inc > io.k.reg_max) ? io.k.reg_max : mu_inc);
    const T mu_accept = (alpha >= io.k.a_dec) ? mu_dec : ((alpha <= io.k.a_inc) ? mu_inc : mu);
    mu = accepted ? mu_accept : (headroom ? mu_inc : mu);
    const bool post_conv =
        take && gap < io.k.gap_tol && converged(current, best_cost, io.k.rtol, io.k.atol);
    status = terminal ? 2 : (post_conv ? 1 : status);
    done = post_conv || terminal;
    iters += 1;
    stale = take;
  }
  // the last trip's accepted candidate was never merged by a following sweep
  if (take) copy_traj(io.best, io.live, B, N, b);
  io.cost[b] = cost;
  io.iters[b] = iters;
  io.status[b] = status;
  io.mu[b] = mu;
  io.probes[b] = static_cast<T>(stages_run) / static_cast<T>(N);
  io.defect_trips[b] = defect_trips;
}

// packed operands after the Problem block:
//   ptrs:  q t v u  imu istat iiter  oq ot ov ou  cost iters status mu probes
//          ks bigks  bq bt bv bu  d  defect_trips
//   ints:  max_iters ls_max_iters ddp
//   reals: quu_reg rtol atol ls_step ls_jump goldstein_frac goldstein_ub gap_tol
//          reg_init reg_scale_up reg_scale_down reg_min reg_max alpha_dec alpha_inc
template <typename T>
int launch_fddp(const void* const* ptrs, const long long* ints, const double* reals,
                void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  const long long* ip = ints + kProblemInts;
  const double* rp = reals + kProblemReals;
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
  io.ks = static_cast<T*>(out(16));
  io.bigks = static_cast<T*>(out(17));
  io.best = traj_from<T>(p + 18);
  io.d = static_cast<T*>(out(22));
  io.defect_trips = static_cast<int*>(out(23));
  io.k = fddp_knobs<T>(ip, rp);
  if (P.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io.k.ddp) {
    fddp_kernel<T, true><<<blocks_for(P.B), kThreadsPerBlock, 0, s>>>(P, io);
  } else {
    fddp_kernel<T, false><<<blocks_for(P.B), kThreadsPerBlock, 0, s>>>(P, io);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qilqr

extern "C" int qilqr_fddp_f32(const void* const* ptrs, const long long* ints,
                              const double* reals, void* stream) {
  return qilqr::launch_fddp<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_fddp_f64(const void* const* ptrs, const long long* ints,
                              const double* reals, void* stream) {
  return qilqr::launch_fddp<double>(ptrs, ints, reals, stream);
}
