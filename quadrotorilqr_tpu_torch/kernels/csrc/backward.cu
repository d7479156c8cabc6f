// Per-pass backward Riccati sweep of the exact iLQR, one team of
// kTeamLanes lanes per scenario.
//
// Replaces the Pallas kernel quadrotorilqr_tpu/kernels/backward.py:
// _backward_kernel (called through backward_pass_fused). For every scenario
// it walks the horizon in reverse and, per stage, builds the block-sparse
// dynamics Jacobian and the Gauss-Newton cost diffs, expands Q, solves the
// u x u Cholesky gains and updates the symmetrized value function. Outputs:
// k|K as (N, B, P) (k first, then K row-major, padded to P values: the gains
// scratch of the whole-solve kernels, which the rollout kernel fetches as it
// is) and [QuTk; kTQuuk] (2, B).
//
// What bounds it on an H100: the dependent chain of one scenario's stages.
// A Riccati stage is ~12k operations, each stage depending on the last; at
// B = 4096 the card holds every scenario at once, so a launch lasts as long
// as a scenario's chain, far above the bytes and operations bound (PERF.md
// section 6). The per-thread design ran that chain in one thread with ~400
// values of Riccati state in local memory. What this design does about it
// (team.cuh, team_trip.cuh): the reverse sweep of the whole-solve kernels,
// team_backward, run once: a team of lanes shares each scenario, the
// Riccati state lives in shared memory, the 12x12 and 12xu products are
// split over the team by output entries, Q, R and the model parameters
// are read from shared memory, and each stage's operands arrive through a
// cp.async ring kRing - 1 stages ahead.
//
// The box and weights variants (_backward_kernel's use_box, use_weights) are
// instantiations of their own (kBox, kW), picked when the bounds or the
// weights are passed: team_backward's box-QP gains and weighted cost terms;
// without either the kernel is the exact path above.
//
// The model families (JAX kernels/models.py's lane models): this source is
// compiled once per family (kernels/_build.py FAMILIES):
// the quadrotor with its variants, and the wrench (u = 6, j_u rows 6:12),
// the 6- and 8-rotor multirotors (j_u rows 8:12), the drag quadrotor (its
// j_x velocity blocks scaled by the drag's diagonal) and the substepped
// quadrotor and drag quadrotor (k substeps a stage, k a kernel argument:
// the Riccati stage chains the substeps' j_x blocks and contracts the dense
// chained j_u over all 12 rows, team.cuh team_sub_expansion), each the
// plain instantiation alone, with C entries of their own.
//
// The penalty variant (_backward_kernel's use_penalty: the augmented-
// Lagrangian quadratics of solver/auglag.py, pcx, pcu, pcxx, pcuu and the
// cross term pcxu) is an object of its own (kernels/_build.py PENALTY,
// -DQILQR_PEN=1, the C entry qilqr_backward_pen), the quadrotor's kPen
// instantiations with and without kW, so that it compiles beside the other
// objects. What bounds it beyond the exact path: bytes. A stage's penalty
// is 224 values (team.cuh PenRow), 3.2x the 69 values the stage reads
// otherwise (its state, control and desired stage, and the k|K row it
// writes). What the design does about it: the host packs the five operands
// into one scenario-major (N, B, 224) buffer, so that a team's row is one
// contiguous run of 16-byte chunks, and the row rides a ring of its own
// kRing - 1 stages ahead of the stage being computed, beside the operand
// ring (JAX's (N, 12, 12, B) lane layout would have each team read at
// stride B); the adds go where the plain version puts them (team.cuh
// team_riccati_stage), and the kernels without the penalty keep their
// shared memory and code.
#define QILQR_TEAM_LANES 8  // lanes per scenario (PERF.md section 6)
#include "team_trip.cuh"

namespace qilqr {

template <typename T>
struct BackwardIO {
  Traj<T> x;                    // (N, d, B) trajectory
  const unsigned char* active;  // (B,) lanes to compute, or null for all
  T* gains;                     // out (N, B, P): k | K
  T* red;                       // out (2, B): QuTk, kTQuuk
  T quu_reg;
  VariantOps<T> var;            // bounds and weights of the variants
};

template <typename T, bool kBox, bool kW, class M, class IO = BackwardIO<T>>
__global__ void __launch_bounds__(kTeamThreads) backward_kernel(Problem<T> P, IO io) {
  Team<T, M> tm;
  if (!team_setup(P, &tm)) return;
  // an inactive lane's team leaves whole, after the block-wide setup
  if (io.active != nullptr && io.active[tm.b] == 0) return;
  team_set_substeps(tm, io);
  const Problem<T> Ps = smem_problem(P, tm);
  T qutk, ktquuk;
  team_backward<T, kBox, kW>(tm, P, Ps, io.quu_reg, io.x, false, io.x, io.gains, &qutk, &ktquuk,
                             io.var);
  ring_drain();
  if (tm.lane == 0) {
    io.red[tm.b] = qutk;
    io.red[P.B + tm.b] = ktquuk;
  }
}

// the BackwardIO of the packed operands after the Problem block:
//   ptrs:  q t v u  active  gains red  lo hi w
//   ints:  s_box s_w  (a substepped family's k after them)
//   reals: quu_reg
template <typename T>
BackwardIO<T> backward_io(const void* const* ptrs, const long long* ints, const double* reals) {
  const void* const* p = ptrs + kProblemPtrs;
  BackwardIO<T> io;
  io.x = traj_from<T>(p);
  io.active = static_cast<const unsigned char*>(p[4]);
  io.gains = static_cast<T*>(const_cast<void*>(p[5]));
  io.red = static_cast<T*>(const_cast<void*>(p[6]));
  io.quu_reg = static_cast<T>(reals[kProblemReals]);
  io.var = variant_from<T>(p + 7, ints + kProblemInts);
  return io;
}

#if !QILQR_PEN

template <typename T, class M>
int launch_backward(const void* const* ptrs, const long long* ints, const double* reals,
                    void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const BackwardIO<T> io = backward_io<T>(ptrs, ints, reals);
  const size_t bytes = team_block_bytes<T, M>(P.s_qr, P.s_par);
  if constexpr (std::is_same_v<M, Quadrotor>) {
    return with_variant(io.var, [&](auto box, auto w) {
      return team_launch(backward_kernel<T, decltype(box)::value, decltype(w)::value, M>, P.B,
                         bytes, stream, P, io);
    });
  } else {
    // the other families have no variant instantiation (the host refuses them)
    if (io.var.lo != nullptr || io.var.w != nullptr) return cudaErrorNotSupported;
    if constexpr (M::kSub) {
      WithSubsteps<BackwardIO<T>> sio;
      const int err = with_substeps<M>(io, ints + kProblemInts, &sio);
      if (err != 0) return err;
      return team_launch(backward_kernel<T, false, false, M, WithSubsteps<BackwardIO<T>>>, P.B,
                         bytes, stream, P, sio);
    } else {
      return team_launch(backward_kernel<T, false, false, M>, P.B, bytes, stream, P, io);
    }
  }
}

#else  // QILQR_PEN

// The penalty variant: team_backward with kPen, the team's ring of penalty
// rows after the block's other shared memory (team.cuh block_bytes).
template <typename T, bool kW>
__global__ void __launch_bounds__(kTeamThreads)
    backward_pen_kernel(Problem<T> P, BackwardIO<T> io, const T* pen_rows) {
  using M = Quadrotor;
  extern __shared__ __align__(16) unsigned char qilqr_smem[];
  Team<T, M> tm;
  if (!team_setup(P, &tm)) return;
  if (io.active != nullptr && io.active[tm.b] == 0) return;
  const Problem<T> Ps = smem_problem(P, tm);
  const size_t ring_bytes = kRing * PenRow<M>::kPitch * sizeof(T);
  PenRing<T> pen;
  pen.rows = pen_rows;
  pen.ring = reinterpret_cast<T*>(qilqr_smem + team_block_bytes<T, M>(P.s_qr, P.s_par) +
                                  team_tile().meta_group_rank() * ring_bytes);
  T qutk, ktquuk;
  team_backward<T, false, kW, true>(tm, P, Ps, io.quu_reg, io.x, false, io.x, io.gains, &qutk,
                                    &ktquuk, io.var, pen);
  ring_drain();
  if (tm.lane == 0) {
    io.red[tm.b] = qutk;
    io.red[P.B + tm.b] = ktquuk;
  }
}

// packed operands: backward_io's, then the (N, B, 224) penalty rows
//   ptrs:  ... lo hi w  pen
// (the bounds must be null: the host refuses the penalty with limits)
template <typename T>
int launch_backward_pen(const void* const* ptrs, const long long* ints, const double* reals,
                        void* stream) {
  Problem<T> P = make_problem<T>(ptrs, ints, reals);
  const BackwardIO<T> io = backward_io<T>(ptrs, ints, reals);
  const T* pen_rows = static_cast<const T*>(ptrs[kProblemPtrs + 10]);
  if (io.var.lo != nullptr || pen_rows == nullptr) return cudaErrorNotSupported;
  const size_t bytes = block_bytes<T, Quadrotor, true>(P.s_qr, P.s_par);
  return io.var.w != nullptr
             ? team_launch(backward_pen_kernel<T, true>, P.B, bytes, stream, P, io, pen_rows)
             : team_launch(backward_pen_kernel<T, false>, P.B, bytes, stream, P, io, pen_rows);
}

#endif  // QILQR_PEN

}  // namespace qilqr

#if QILQR_PEN

extern "C" int qilqr_backward_pen_f32(const void* const* ptrs, const long long* ints,
                                      const double* reals, void* stream) {
  return qilqr::launch_backward_pen<float>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_backward_pen_f64(const void* const* ptrs, const long long* ints,
                                      const double* reals, void* stream) {
  return qilqr::launch_backward_pen<double>(ptrs, ints, reals, stream);
}

extern "C" int qilqr_backward_pen_team_info(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Quadrotor, true>(f64, s_qr, s_par, out);
}

#else

extern "C" int QILQR_ENTRY(backward, f32)(const void* const* ptrs, const long long* ints,
                                          const double* reals, void* stream) {
  return qilqr::launch_backward<float, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(backward, f64)(const void* const* ptrs, const long long* ints,
                                          const double* reals, void* stream) {
  return qilqr::launch_backward<double, qilqr::Family>(ptrs, ints, reals, stream);
}

extern "C" int QILQR_ENTRY(backward, team_info)(int f64, int s_qr, int s_par, long long* out) {
  return qilqr::team_info<qilqr::Family>(f64, s_qr, s_par, out);
}

#endif  // QILQR_PEN
