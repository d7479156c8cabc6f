// The whole exact iLQR loop in one kernel without a candidate trajectory,
// one thread per scenario: the batch solvers' engine past 256 stages.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/stream.py:
// _stream_kernel (called through solve_fused_streamed). It computes what
// solve.cu computes, lane for lane, with the TPU kernel's schedule: each
// trip runs a backward pass into ks / bigks, the trip gate, a line search
// whose probes sum costs only (trip 0 force-accepts its first probe), then
// ONE apply sweep that re-rolls the lane at the alpha of its last tried
// probe (the accepted one, or, when the search ran out, the last tried, the
// stream.py _TRIED row, never the alpha backtracked once more) and writes
// the candidate into the live trajectory in place, then the trip close. The
// probe and the apply sweep run the same non-inlined sweep function, so the
// trajectory written is, bit for bit, the one whose cost the probe returned.
// The TPU kernel streams `chunk` stages at a time through VMEM; here every
// stage already lives in device memory, so there is no window.
//
// What bounds it on an H100: as solve.cu, the Riccati stage's ~400 values a
// thread live in local memory at 255 registers, and B = 4096 is about one
// warp per SM, so each thread's chain of dependent local-memory loads sets
// the time (latency-bound; PERF.md section 5). What the design does about
// it: no candidate buffer, so a probe stores nothing (17 values per stage
// saved per probe) and no copy of the candidate into the live trajectory
// follows the search; one launch for the whole solve; scenario-minor buffers
// for coalesced loads. It reports the backward passes, probe sweeps and
// apply sweeps each lane ran.
#include "quadrotor.cuh"

namespace qilqr {

template <typename T>
struct StreamIO {
  Traj<T> x0;    // (N, d, B) initial trajectory
  Traj<T> live;  // out (N, d, B): the live, then the final trajectory
  T* cost;       // out (B,)
  int* iters;    // out (B,)
  int* status;   // out (B,)
  T* ks;         // scratch (N, 4, B)
  T* bigks;      // scratch (N, 4, 12, B)
  int* passes;   // out (B,): backward passes run
  int* probes;   // out (B,): probe sweeps run
  int* applies;  // out (B,): apply sweeps run
  int max_iters, ls_max_iters;
  T quu_reg, rtol, atol, ls_step, ls_frac;
};

template <typename T>
__global__ void stream_kernel(Problem<T> P, StreamIO<T> io) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const int B = P.B, N = P.N;
  copy_traj(io.x0, io.live, B, N, b);
  // the loop never runs: report the initial trajectory's true cost
  T cost = io.max_iters == 0 ? trajectory_cost_lane(P, io.live, b) : T(0);
  int status = 0, iters = 0, passes = 0, stages = 0, applies = 0;
  for (int i = 0; i < io.max_iters; ++i) {
    // ---- backward pass ----
    T qutk, ktquuk;
    backward_lane(P, io.quu_reg, io.live, io.ks, io.bigks, b, &qutk, &ktquuk);
    ++passes;

    // ---- trip gate (solve.py _trip_gate): pre-check on the expected cost ----
    const T current = cost;
    const T expected = current + (qutk + T(0.5) * ktquuk);
    const bool pre_conv = i > 0 && converged(current, expected, io.rtol, io.atol);
    const bool active = !pre_conv;

    // ---- cost-only probes; trip 0 force-accepts; then the apply sweep ----
    LineSearch<T> ls{false, current, T(1), 0};
    if (active) {
      ls = exact_line_search(P, io.live, io.ks, io.bigks, qutk, ktquuk, current, i == 0,
                             io.ls_max_iters, io.ls_step, io.ls_frac, io.live, false, b);
      stages += ls.stages;
      rollout_lane(P, io.live, io.ks, io.bigks, ls.alpha, io.live, true, b);
      ++applies;
    }
    if (exact_trip_close(i == 0, pre_conv, active, ls, current, io.rtol, io.atol, &cost,
                         &status, &iters)) {
      break;
    }
  }
  io.cost[b] = cost;
  io.iters[b] = iters;
  io.status[b] = status;
  io.passes[b] = passes;
  io.probes[b] = stages / N;
  io.applies[b] = applies;
}

// packed operands after the Problem block:
//   ptrs:  q t v u  oq ot ov ou  cost iters status  ks bigks  passes probes applies
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
  io.ks = static_cast<T*>(out(11));
  io.bigks = static_cast<T*>(out(12));
  io.passes = static_cast<int*>(out(13));
  io.probes = static_cast<int*>(out(14));
  io.applies = static_cast<int*>(out(15));
  io.max_iters = static_cast<int>(ip[0]);
  io.ls_max_iters = static_cast<int>(ip[1]);
  io.quu_reg = static_cast<T>(rp[0]);
  io.rtol = static_cast<T>(rp[1]);
  io.atol = static_cast<T>(rp[2]);
  io.ls_step = static_cast<T>(rp[3]);
  io.ls_frac = static_cast<T>(rp[4]);
  if (P.B == 0) return 0;
  stream_kernel<T><<<blocks_for(P.B), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      P, io);
  return static_cast<int>(cudaGetLastError());
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
