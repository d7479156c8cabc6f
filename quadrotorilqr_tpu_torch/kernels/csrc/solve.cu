// The whole exact iLQR loop in one kernel, one thread per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/solve.py:
// _solve_kernel (called through solve_fused_whole), including its trip
// state machine _trip_gate / _ls_probe_commit / _trip_close. Each thread
// runs its scenario's solve to the end: backward pass, then (trip 0) a
// forced full step or (later trips) the expected-cost pre-check, a
// backtracking line search with per-scenario alpha that keeps each probe as
// the candidate, the merge of the candidate into the live trajectory, and the
// achieved-cost post-check. A line search that runs out keeps the last
// candidate and ends with status 2. A finished scenario's thread leaves the
// trip loop: its lane is frozen, which is all the TPU kernel's per-tile
// all-done flag guarantees. Status and iterations come out as int32.
//
// What bounds it on an H100: the backward stage's ~400 values per thread
// (V_xx, Q_xx, j_x blocks; see backward.cu) live in local memory, and with
// one thread per scenario B = 4096 is about one warp per SM, so the loop is
// latency-bound. The live, candidate and gain trajectories stay in device
// memory at any horizon (about 3 KB per stage per 32 scenarios in float32),
// so unlike the TPU kernel there is no horizon cap and no streamed variant.
// What the design does about it: no host round trip and no launch between
// trips (the whole solve is one launch), scenario-minor buffers for
// coalesced loads, block-sparse j_x / j_u products, and broadcast reads of
// shared operands. The cost sums in the per-pass rollout's order, (J + dx'Q
// dx) + du'R du, so the two kernel routes add up each candidate alike.
#include "quadrotor.cuh"

namespace qilqr {

template <typename T>
struct SolveIO {
  Traj<T> x0;    // (N, d, B) initial trajectory
  Traj<T> live;  // out (N, d, B): the live, then the final trajectory
  T* cost;       // out (B,)
  int* iters;    // out (B,)
  int* status;   // out (B,)
  T* ks;         // scratch (N, 4, B)
  T* bigks;      // scratch (N, 4, 12, B)
  Traj<T> best;  // scratch (N, d, B): the line search's candidate
  int max_iters, ls_max_iters;
  T quu_reg, rtol, atol, ls_step, ls_frac;
};

template <typename T>
__global__ void solve_kernel(Problem<T> P, SolveIO<T> io) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const int B = P.B, N = P.N;
  copy_traj(io.x0, io.live, B, N, b);
  T cost = T(0);
  int status = 0, iters = 0;
  if (io.max_iters == 0) {
    // the loop never runs: report the initial trajectory's true cost
    for (int n = 0; n < N; ++n) {
      T q[4], t[3], v[6], u[4], xq, ur;
      load_stage(io.live, B, n, b, q, t, v, u);
      stage_cost_terms(P, n, b, q, t, v, u, &xq, &ur);
      cost = cost + xq + ur;
    }
  }
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass ----
    T qutk, ktquuk;
    backward_lane(P, io.quu_reg, io.live, io.ks, io.bigks, b, &qutk, &ktquuk);

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const bool li_pos = i > 0;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = li_pos && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- line search (solve.py _ls_probe_commit); trip 0 force-accepts ----
    bool accepted = false;
    T best_cost = current;
    if (active) {
      T alpha = T(1);
      for (int j = 0; j < io.ls_max_iters; ++j) {
        const T cand = rollout_lane(P, io.live, io.ks, io.bigks, alpha, io.best, b);
        const T desired = io.ls_frac * (alpha * qutk + alpha * alpha * ktquuk * T(0.5));
        best_cost = cand;
        accepted = (cand - current) < desired || i == 0;
        if (accepted) break;
        alpha = alpha * io.ls_step;
      }
      copy_traj(io.best, io.live, B, N, b);
    }

    // ---- trip close (solve.py _trip_close) ----
    const bool post_conv = li_pos && converged(current, best_cost, io.rtol, io.atol) &&
                           active && accepted;
    const bool ls_failed = active && !accepted;
    cost = active ? best_cost : current;
    const bool conv = post_conv || pre_conv;
    status = ls_failed ? 2 : (conv ? 1 : status);
    iters += active ? 1 : 0;
    if (conv || ls_failed) break;
  }
  io.cost[b] = cost;
  io.iters[b] = iters;
  io.status[b] = status;
}

// packed operands after the Problem block:
//   ptrs:  q t v u  oq ot ov ou  cost iters status  ks bigks  bq bt bv bu
//   ints:  max_iters ls_max_iters
//   reals: quu_reg rtol atol ls_step ls_frac
template <typename T>
int launch_solve(const void* const* ptrs, const long long* ints, const double* reals,
                 void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  const long long* ip = ints + kProblemInts;
  const double* rp = reals + kProblemReals;
  SolveIO<T> io;
  io.x0 = traj_from<T>(p);
  io.live = traj_from<T>(p + 4);
  io.cost = static_cast<T*>(const_cast<void*>(p[8]));
  io.iters = static_cast<int*>(const_cast<void*>(p[9]));
  io.status = static_cast<int*>(const_cast<void*>(p[10]));
  io.ks = static_cast<T*>(const_cast<void*>(p[11]));
  io.bigks = static_cast<T*>(const_cast<void*>(p[12]));
  io.best = traj_from<T>(p + 13);
  io.max_iters = static_cast<int>(ip[0]);
  io.ls_max_iters = static_cast<int>(ip[1]);
  io.quu_reg = static_cast<T>(rp[0]);
  io.rtol = static_cast<T>(rp[1]);
  io.atol = static_cast<T>(rp[2]);
  io.ls_step = static_cast<T>(rp[3]);
  io.ls_frac = static_cast<T>(rp[4]);
  if (P.B == 0) return 0;
  solve_kernel<T><<<blocks_for(P.B), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      P, io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qilqr

extern "C" int qilqr_solve_f32(const void* const* ptrs, const long long* ints,
                               const double* reals, void* stream) {
  return qilqr::launch_solve<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_solve_f64(const void* const* ptrs, const long long* ints,
                               const double* reals, void* stream) {
  return qilqr::launch_solve<double>(ptrs, ints, reals, stream);
}

extern "C" const char* qilqr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
