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
// memory at any horizon (about 3 KB per stage per 32 scenarios in float32);
// the batch solvers send horizons past 256 stages to stream.cu, the
// candidate-free variant, as the JAX package routes them.
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
  // the loop never runs: report the initial trajectory's true cost
  T cost = io.max_iters == 0 ? trajectory_cost_lane(P, io.live, b) : T(0);
  int status = 0, iters = 0;
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass ----
    T qutk, ktquuk;
    backward_lane(P, io.quu_reg, io.live, io.ks, io.bigks, b, &qutk, &ktquuk);

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = i > 0 && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- line search, each probe kept as the candidate; trip 0 force-accepts ----
    LineSearch<T> ls{false, current, T(1), 0};
    if (active) {
      ls = exact_line_search(P, io.live, io.ks, io.bigks, qutk, ktquuk, current, i == 0,
                             io.ls_max_iters, io.ls_step, io.ls_frac, io.best, true, b);
      copy_traj(io.best, io.live, B, N, b);
    }
    if (exact_trip_close(i == 0, pre_conv, active, ls, current, io.rtol, io.atol, &cost,
                         &status, &iters)) {
      break;
    }
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
