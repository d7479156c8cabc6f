// Closed-loop rollout with the tracking cost in the same sweep, one thread
// per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/rollout.py:
// _rollout_kernel (called through rollout_cost_fused):
//     u_n     = u_old_n + alpha k_n + K_n (x_n (-) x_old_n)
//     x_{n+1} = f(x_n, u_n)                       (Lie-Euler step)
//     J      += (x_n (-) x_d,n)' Q (.) + (u_n - u_d,n)' R (.)
// with a per-scenario step alpha. The cost accumulates stage by stage as
// (J + dx'Q dx) + du'R du, the TPU kernel's order.
//
// What bounds it on an H100: per stage a thread reads 17 trajectory values
// and 52 gain values and writes 17; the trig of two SE(3) logs and one exp
// is the arithmetic. At one thread per scenario, B = 4096 is about one warp
// per SM, so the sweep is bound by the latency of each warp's dependent
// chain, not by bandwidth (~3 MB per sweep in float32 at N = 100).
// What the design does about it: all per-stage buffers are scenario-minor
// (N, d, B), so each warp load is one coalesced transaction; the state and
// control of the current stage stay in registers; shared operands are
// broadcast reads at B-stride 0.
#include "quadrotor.cuh"

namespace qilqr {

template <typename T>
struct RolloutIO {
  Traj<T> x;                    // (N, d, B) previous trajectory
  const T* ks;                  // (N, 4, B)
  const T* bigks;               // (N, 4, 12, B)
  const T* alpha;               // (B,)
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  Traj<T> out;                  // out (N, d, B)
  T* cost;                      // out (B,)
};

template <typename T>
__global__ void rollout_kernel(Problem<T> P, RolloutIO<T> io) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  if (io.active != nullptr && io.active[b] == 0) return;
  io.cost[b] = rollout_lane(P, io.x, io.ks, io.bigks, io.alpha[b], io.out, true, b);
}

// packed operands after the Problem block:
//   ptrs: q t v u  ks bigks alpha active  oq ot ov ou cost
template <typename T>
int launch_rollout(const void* const* ptrs, const long long* ints, const double* reals,
                   void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  RolloutIO<T> io;
  io.x = traj_from<T>(p);
  io.ks = static_cast<const T*>(p[4]);
  io.bigks = static_cast<const T*>(p[5]);
  io.alpha = static_cast<const T*>(p[6]);
  io.active = static_cast<const unsigned char*>(p[7]);
  io.out = traj_from<T>(p + 8);
  io.cost = static_cast<T*>(const_cast<void*>(p[12]));
  if (P.B == 0) return 0;
  rollout_kernel<T><<<blocks_for(P.B), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      P, io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qilqr

extern "C" int qilqr_rollout_f32(const void* const* ptrs, const long long* ints,
                                 const double* reals, void* stream) {
  return qilqr::launch_rollout<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_rollout_f64(const void* const* ptrs, const long long* ints,
                                 const double* reals, void* stream) {
  return qilqr::launch_rollout<double>(ptrs, ints, reals, stream);
}
