// Per-pass backward Riccati sweep of the exact iLQR, one thread per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/backward.py:
// _backward_kernel (called through backward_pass_fused). For every scenario
// it walks the horizon in reverse and, per stage, builds the block-sparse
// dynamics Jacobian and the Gauss-Newton cost diffs, expands Q, solves the
// 4x4 Cholesky gains and updates the symmetrized value function. Outputs:
// k (N, 4, B), K (N, 4, 12, B) and [QuTk; kTQuuk] (2, B).
//
// What bounds it on an H100: one thread holds V_xx, Q_xx, the j_x blocks
// and their products, about 400 values (3.2 KB in float64), far past the 255
// registers a thread may use, so most of it lives in local memory
// (L1-cached, spilled to L2). With one thread per scenario, B = 4096 gives
// 128 warps, about one per SM, so nothing hides that latency; the kernel
// is latency-bound, not bandwidth- or FLOP-bound.
// What the design does about it: the j_x and j_u products skip the
// structural zeros (the same block sparsity as the TPU kernel), the shared
// operands (Q, R, params, desired trajectory at B-stride 0) are read by all
// threads of a warp from one address, and the per-stage buffers are
// scenario-minor so a warp's loads coalesce. Splitting a scenario's 12x12
// products over several threads is the later work that would cut the
// per-thread state.
#include "quadrotor.cuh"

namespace qilqr {

template <typename T>
struct BackwardIO {
  Traj<T> x;                    // (N, d, B) trajectory
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  T* ks;                        // out (N, 4, B)
  T* bigks;                     // out (N, 4, 12, B)
  T* red;                       // out (2, B): QuTk, kTQuuk
  T quu_reg;
};

template <typename T>
__global__ void backward_kernel(Problem<T> P, BackwardIO<T> io) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  if (io.active != nullptr && io.active[b] == 0) return;
  backward_lane(P, io.quu_reg, io.x, io.ks, io.bigks, b, &io.red[b], &io.red[P.B + b]);
}

// packed operands after the Problem block:
//   ptrs:  q t v u  active  ks bigks red
//   reals: quu_reg
template <typename T>
int launch_backward(const void* const* ptrs, const long long* ints, const double* reals,
                    void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const void* const* p = ptrs + kProblemPtrs;
  BackwardIO<T> io;
  io.x = traj_from<T>(p);
  io.active = static_cast<const unsigned char*>(p[4]);
  io.ks = static_cast<T*>(const_cast<void*>(p[5]));
  io.bigks = static_cast<T*>(const_cast<void*>(p[6]));
  io.red = static_cast<T*>(const_cast<void*>(p[7]));
  io.quu_reg = static_cast<T>(reals[kProblemReals]);
  if (P.B == 0) return 0;
  backward_kernel<T><<<blocks_for(P.B), kThreadsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      P, io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qilqr

extern "C" int qilqr_backward_f32(const void* const* ptrs, const long long* ints,
                                  const double* reals, void* stream) {
  return qilqr::launch_backward<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_backward_f64(const void* const* ptrs, const long long* ints,
                                  const double* reals, void* stream) {
  return qilqr::launch_backward<double>(ptrs, ints, reals, stream);
}
