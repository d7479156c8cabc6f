// The whole robust FDDP loop in one kernel without a candidate trajectory,
// one thread per scenario: the batch solvers' robust engine past 231 stages.
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
//      only and stopping at its lane's freeze;
//   3. for an accepted lane only, ONE apply sweep over the whole horizon that
//      re-rolls the candidate at the accepted alpha and writes it into the
//      live trajectory in place; a rejected lane keeps its trajectory for the
//      mu retry;
//   4. the close: cost commit, mu schedule, status.
// The probes and the apply sweep run the same non-inlined stage function, so
// the trajectory written is, bit for bit, the one whose cost was accepted,
// and a resumed launch's seed cost equals the committed one. Resume rows
// (mu, status, iterations) continue a solve; a lane with a nonzero status is
// frozen and only copies its trajectory. With no probes every trip rejects.
// The TPU kernel streams `chunk` stages at a time through VMEM; here every
// stage already lives in device memory, so there is no window.
//
// What bounds it on an H100: as fddp.cu, the Riccati stage's values (more
// with kDdp) live in local memory at 255 registers, B = 4096 is about one
// warp per SM, and a warp lasts as long as its slowest lane, so each
// thread's chain of dependent loads sets the time (latency-bound; PERF.md
// section 5, where the robust path's exact-DDP launch spends most of its
// time in ~6 probe sweeps a trip). What the design does about it: no
// candidate buffer, so a probe stores nothing (17 values per stage saved
// per probe stage) and the merge into the live trajectory happens once, in
// the apply sweep, only for accepted lanes; probe sweeps stop at their
// freeze; one launch per curvature. It reports the probe sweeps, defect
// trips and apply sweeps each lane ran.
#include "quadrotor.cuh"

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
  T* ks;              // scratch (N, 4, B)
  T* bigks;           // scratch (N, 4, 12, B)
  T* d;               // scratch (N, 12, B): the defects
  FddpKnobs<T> k;
};

// One FDDP reverse sweep of scenario b over its live trajectory. With
// `stale` it recomputes the defects d_n = f(x_n, u_n) (-) x_{n+1}
// (d_{N-1} = 0) into d and their max |d| into *gap; otherwise it reads the
// stored defects. Every stage transports the value gradient across its gap,
// v_x + V_xx d_n, and runs the Riccati stage with quu_reg (exact DDP
// curvature when kDdp); the gains go to ks / bigks.
template <typename T, bool kDdp>
__device__ __forceinline__ void fddp_reverse_sweep(const Problem<T>& P, T quu_reg,
                                                   const Traj<T>& live, bool stale, T* ks,
                                                   T* bigks, T* d, StageScratch<T>& S, int b,
                                                   T* gap) {
  const int B = P.B, N = P.N;
  if (stale) *gap = T(0);
  T v_x[12], v_xx[144];
  for (int j = 0; j < 12; ++j) v_x[j] = T(0);
  for (int j = 0; j < 144; ++j) v_xx[j] = T(0);
  for (int n = N - 1; n >= 0; --n) {
    T q[4], t[3], v[6], u[4], dk[12];
    if (stale) {
      load_stage(live, B, n, b, q, t, v, u);
      if (n < N - 1) {
        T qn[4], tn[3], vn[6], q1[4], t1[3], v1[6], u1[4];
        for (int j = 0; j < 4; ++j) qn[j] = q[j];
        for (int j = 0; j < 3; ++j) tn[j] = t[j];
        for (int j = 0; j < 6; ++j) vn[j] = v[j];
        dynamics_step(P, b, qn, tn, vn, u);
        load_stage(live, B, n + 1, b, q1, t1, v1, u1);
        state_minus(qn, tn, vn, q1, t1, v1, dk);
        for (int j = 0; j < 12; ++j) *gap = nan_max(*gap, f_abs(dk[j]));
      } else {
        for (int j = 0; j < 12; ++j) dk[j] = T(0);
      }
      for (int j = 0; j < 12; ++j) d[(n * 12 + j) * B + b] = dk[j];
    } else {
      load_stage(live, B, n, b, q, t, v, u);
      for (int j = 0; j < 12; ++j) dk[j] = d[(n * 12 + j) * B + b];
    }
    // first-order value transport across the gap
    for (int r = 0; r < 12; ++r) {
      T acc = v_xx[r * 12] * dk[0];
      for (int j = 1; j < 12; ++j) acc += v_xx[r * 12 + j] * dk[j];
      v_x[r] = v_x[r] + acc;
    }
    T k[4], K[48], qutk, ktquuk;
    riccati_stage<T, kDdp>(P, quu_reg, n, b, q, t, v, u, v_x, v_xx, S, k, K, &qutk, &ktquuk);
    for (int j = 0; j < 4; ++j) ks[(n * 4 + j) * B + b] = k[j];
    for (int j = 0; j < 48; ++j) bigks[(n * 48 + j) * B + b] = K[j];
  }
}

// rollout_gap_stage as one never-inlined function. The probes and the apply
// sweep both run it, so the trajectory the apply sweep writes is, bit for
// bit, the one whose cost the probe accepted (fddp.cu, which keeps each
// probe's candidate, runs the stage inline).
template <typename T>
__device__ __noinline__ T rollout_gap_stage_call(const Problem<T>& P, const Traj<T>& x,
                                                 const T* ks, const T* bigks, const T* d,
                                                 T alpha, bool sat, T gdj, T current, T cap,
                                                 const Traj<T>& out, bool store, int n, int b,
                                                 T* q, T* t, T* v, T c) {
  return rollout_gap_stage(P, x, ks, bigks, d, alpha, sat, gdj, current, cap, out, store, n, b,
                           q, t, v, c);
}

// The Goldstein line search of scenario b from its live trajectory x
// (fddp.py _goldstein_probe_commit): probe 0 at alpha = 1 also carries the
// exact quadratic model dJ(alpha) = alpha L1 + alpha^2 L2 and sums its cost
// raw; probes 1.. fold with the frozen-saturating add, and once a probe's
// fold freezes (its Goldstein crossing) nothing later can change it, so the
// sweep stops there. A probe is accepted when its cost change is within
// the Goldstein band and finite; a rejection backtracks by ls_step, or by
// ls_jump when the probe exploded. The probes sum costs only, through
// rollout_gap_stage_call, and store nothing. With no probes the search
// rejects.
template <typename T, bool kDdp>
__device__ __forceinline__ LineSearch<T> fddp_line_search(const Problem<T>& P,
                                                          const FddpKnobs<T>& k, const Traj<T>& x,
                                                          const T* ks, const T* bigks, const T* d,
                                                          StageScratch<T>& S, T current, int b) {
  const int B = P.B, N = P.N;
  auto stage = [&](T alpha, bool sat, T gdj, T cap, int n, T* q, T* t, T* v, T c) {
    return rollout_gap_stage_call(P, x, ks, bigks, d, alpha, sat, gdj, current, cap, x, false, n,
                                  b, q, t, v, c);
  };
  LineSearch<T> ls{false, current, T(1), 0};
  T alpha = T(1), l1 = T(0), l2 = T(0);
  if (k.ls_max_iters >= 1) {
    T q[4], t[3], v[6], u[4], p[12], ju[16];
    load_stage(x, B, 0, b, q, t, v, u);
    for (int j = 0; j < 12; ++j) p[j] = T(0);
    for (int j = 0; j < 16; ++j) ju[j] = P.par(P.ju, 32 + j, b);
    T c = T(0);
    for (int n = 0; n < N; ++n) {
      // model terms at the live stage (not the rollout carry)
      T p2[12];
      fddp_model_stage<T, kDdp>(P, x, ks, bigks, d, n, b, S, ju, p, p2, &l1, &l2);
      c = stage(alpha, false, T(0), T(0), n, q, t, v, c);
      for (int j = 0; j < 12; ++j) p[j] = p2[j] + d[(n * 12 + j) * B + b];
    }
    ls.stages += N;
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
    T q[4], t[3], v[6], u[4];
    load_stage(x, B, 0, b, q, t, v, u);
    T c = T(0);
    for (int n = 0; n < N; ++n) {
      if ((c - current) > gdj) break;  // frozen: the rest cannot change c
      c = stage(alpha, true, gdj, cap, n, q, t, v, c);
      ++ls.stages;
    }
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
__global__ void stream_fddp_kernel(Problem<T> P, StreamFddpIO<T> io) {
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
  bool stale = true;  // the defects need computing (trip 0, or after an accept)
  T gap = T(0);
  int stages_run = 0, defect_trips = 0, applies = 0;
  StageScratch<T> S;
  for (int i = 0; i < io.k.max_iters && !done; ++i) {
    const T current = cost;
    // ---- defects (when stale) + gap-transported backward pass ----
    defect_trips += stale ? 1 : 0;
    fddp_reverse_sweep<T, kDdp>(P, io.k.quu_reg + mu, io.live, stale, io.ks, io.bigks, io.d, S,
                                b, &gap);
    // ---- the line search, cost-only probes ----
    const LineSearch<T> ls =
        fddp_line_search<T, kDdp>(P, io.k, io.live, io.ks, io.bigks, io.d, S, current, b);
    stages_run += ls.stages;
    // ---- apply sweep: the accepted candidate into the live trajectory ----
    if (ls.accepted) {
      T q[4], t[3], v[6], u[4];
      load_stage(io.live, B, 0, b, q, t, v, u);
      T c = T(0);
      for (int n = 0; n < N; ++n) {
        c = rollout_gap_stage_call(P, io.live, io.ks, io.bigks, io.d, ls.alpha, false, T(0),
                                   T(0), T(0), io.live, true, n, b, q, t, v, c);
      }
      ++applies;
    }
    // ---- trip close (fddp.py _fddp_trip_close) ----
    done = fddp_trip_close(io.k, ls, current, gap, &cost, &mu, &status);
    iters += 1;
    stale = ls.accepted;
  }
  io.cost[b] = cost;
  io.iters[b] = iters;
  io.status[b] = status;
  io.mu[b] = mu;
  io.probes[b] = static_cast<T>(stages_run) / static_cast<T>(N);
  io.defect_trips[b] = defect_trips;
  io.applies[b] = applies;
}

// packed operands after the Problem block:
//   ptrs:  q t v u  imu istat iiter  oq ot ov ou  cost iters status mu probes
//          ks bigks  d  defect_trips applies
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
  io.ks = static_cast<T*>(out(16));
  io.bigks = static_cast<T*>(out(17));
  io.d = static_cast<T*>(out(18));
  io.defect_trips = static_cast<int*>(out(19));
  io.applies = static_cast<int*>(out(20));
  io.k = fddp_knobs<T>(ints + kProblemInts, reals + kProblemReals);
  if (P.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (io.k.ddp) {
    stream_fddp_kernel<T, true><<<blocks_for(P.B), kThreadsPerBlock, 0, s>>>(P, io);
  } else {
    stream_fddp_kernel<T, false><<<blocks_for(P.B), kThreadsPerBlock, 0, s>>>(P, io);
  }
  return static_cast<int>(cudaGetLastError());
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
