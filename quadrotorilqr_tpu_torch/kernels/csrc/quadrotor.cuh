// The kernels' operands, the model families, and the serial pieces of the
// models, per thread.
//
// Counterpart of quadrotorilqr_tpu/kernels/models.py (the quadrotor, wrench
// and multirotor LaneModels), kernels/rollout.py (_dynamics_step, _state_minus) and
// kernels/backward.py (_stage_jx_blocks, _ad_cot_lanes; without the
// box/weights/drag/substep/penalty options), and the scalar trip logic of
// solve.py (_trip_close) and fddp.py (the FDDP options). team.cuh builds
// every kernel (backward.cu, rollout.cu, solve.cu, fddp.cu, stream.cu,
// stream_fddp.cu) on these pieces: each lane of a team runs them on
// identical inputs.
//
// Layout. Per-stage buffers are scenario-minor, (N, d, B): element (n, i) of
// scenario b sits at [(n * d + i) * B + b]. The operand groups that may be
// shared or per-scenario (desired trajectory, Q/R, physical params) carry a
// B-stride s: element e of scenario b sits at [e * (s ? B : 1) + b * s].
#pragma once

#include "lanes.cuh"

namespace qilqr {

// ---- the model families (kernels/models.py's lane models) ----
//
// Every family is an SE(3) rigid body with an affine control-to-acceleration
// map, so the discrete dynamics Jacobian j_x has the same blocks for each
// (stage_jx_blocks). A family differs in its control width kNu, the first
// nonzero row kJuLo of its stage-constant control Jacobian j_u = dt j_cont_u
// (the Riccati contractions run over rows kJuLo:12 only: the rows above are
// structural zeros) and its dynamics step (dynamics_step). A kernel source is
// compiled once per family (kernels/_build.py FAMILIES, the macros
// QILQR_FAMILY_T and QILQR_FAMILY); the host functions carry the family as a template argument,
// so that the families' objects link into one library.
template <int NU, int JU_LO, bool WRENCH>
struct ModelFamily {
  static constexpr int kNu = NU;
  static constexpr int kJuLo = JU_LO;
  static constexpr bool kWrench = WRENCH;  // body-wrench control: no moment map
  static constexpr int kStage = 13 + NU;   // a trajectory stage: q(4) t(3) v(6) u(NU)
  // a k|K row, k (NU) then K (NU x 12) row-major, padded to whole 16-byte
  // chunks in float32 and float64: 52 values at u = 4, 80 at 6, 104 at 8
  static constexpr int kGainsPitch = (13 * NU + 3) / 4 * 4;
};

// 4 rotor thrusts, j_u rows 8:12 (the only family with the box, weights and
// record instantiations)
struct Quadrotor : ModelFamily<4, 8, false> {};
// the fully actuated SE(3) body wrench u = [f_body, tau_body]: j_u rows 6:9
// (dt/m) I3 into the force columns, rows 9:12 dt I^-1 into the torque ones
struct Wrench : ModelFamily<6, 6, true> {};
// R rotor thrusts on any airframe: j_u rows 8:12, as the quadrotor (R = 4 is
// the quadrotor and runs its kernels)
template <int R>
struct Multirotor : ModelFamily<R, 8, false> {};

// The family a kernel source is compiled for: kernels/_build.py FAMILIES
// defines its type QILQR_FAMILY_T and the suffix QILQR_FAMILY of its C
// entries (QILQR_ENTRY: qilqr_backward_f32, qilqr_backward_wrench_f32, ...);
// without them, the quadrotor.
#ifndef QILQR_FAMILY_T
#define QILQR_FAMILY_T Quadrotor
#define QILQR_FAMILY
#endif
using Family = QILQR_FAMILY_T;
#define QILQR_ENTRY__(kernel, family, suffix) qilqr_##kernel##family##_##suffix
#define QILQR_ENTRY_(kernel, family, suffix) QILQR_ENTRY__(kernel, family, suffix)
#define QILQR_ENTRY(kernel, suffix) QILQR_ENTRY_(kernel, QILQR_FAMILY, suffix)

// Operand pointers that every kernel reads: the cost and the model.
// Order of the packed pointer / int / real arrays the host passes (see
// kernels/backward.py _problem_operands):
//   ptrs:  dq dtr dv du  Q R  g minv ju iinv_ma inertia inertia_inv
//   ints:  B N s_des s_qr s_par
//   reals: dt
constexpr int kProblemPtrs = 12;
constexpr int kProblemInts = 5;
constexpr int kProblemReals = 1;

template <typename T>
struct Problem {
  const T *dq, *dtr, *dv, *du;  // desired (N, d, B or 1), du (N, u, .)
  const T *Q, *R;               // (12, 12, .), (u, u, .)
  const T *g, *minv;            // (.)
  const T *ju;                  // (12, u, .) discrete control Jacobian dt * j_cont_u
  const T *iinv_ma;             // (3, u, .) I^-1 @ the moment map; null for the wrench
  const T *inertia, *inertia_inv;  // (3, 3, .)
  int B, N, s_des, s_qr, s_par;
  T dt;

  __device__ __forceinline__ T grp(const T* p, int e, int s, int b) const {
    return p[e * (s ? B : 1) + b * s];
  }
  __device__ __forceinline__ T des(const T* p, int d, int n, int i, int b) const {
    return grp(p, n * d + i, s_des, b);
  }
  __device__ __forceinline__ T q(int e, int b) const { return grp(Q, e, s_qr, b); }
  __device__ __forceinline__ T r(int e, int b) const { return grp(R, e, s_qr, b); }
  __device__ __forceinline__ T par(const T* p, int e, int b) const { return grp(p, e, s_par, b); }
};

template <typename T>
inline Problem<T> make_problem(const void* const* ptrs, const long long* ints,
                               const double* reals) {
  Problem<T> p;
  p.dq = static_cast<const T*>(ptrs[0]);
  p.dtr = static_cast<const T*>(ptrs[1]);
  p.dv = static_cast<const T*>(ptrs[2]);
  p.du = static_cast<const T*>(ptrs[3]);
  p.Q = static_cast<const T*>(ptrs[4]);
  p.R = static_cast<const T*>(ptrs[5]);
  p.g = static_cast<const T*>(ptrs[6]);
  p.minv = static_cast<const T*>(ptrs[7]);
  p.ju = static_cast<const T*>(ptrs[8]);
  p.iinv_ma = static_cast<const T*>(ptrs[9]);
  p.inertia = static_cast<const T*>(ptrs[10]);
  p.inertia_inv = static_cast<const T*>(ptrs[11]);
  p.B = static_cast<int>(ints[0]);
  p.N = static_cast<int>(ints[1]);
  p.s_des = static_cast<int>(ints[2]);
  p.s_qr = static_cast<int>(ints[3]);
  p.s_par = static_cast<int>(ints[4]);
  p.dt = static_cast<T>(reals[0]);
  return p;
}

// One (N, d, B) per-lane trajectory buffer set: quat, trans, vel, controls.
template <typename T>
struct Traj {
  T *q, *t, *v, *u;
};

// four consecutive packed pointers q t v u -> Traj
template <typename T>
inline Traj<T> traj_from(const void* const* p) {
  Traj<T> x;
  x.q = static_cast<T*>(const_cast<void*>(p[0]));
  x.t = static_cast<T*>(const_cast<void*>(p[1]));
  x.v = static_cast<T*>(const_cast<void*>(p[2]));
  x.u = static_cast<T*>(const_cast<void*>(p[3]));
  return x;
}

// the reference convergence test, division-free (solver/ilqr.is_converged)
template <typename T>
__device__ __forceinline__ bool converged(T cur, T next, T rtol, T atol) {
  T diff = f_abs(cur - next);
  return diff < rtol * f_abs(cur) || diff < atol;
}

// 12-tangent lhs (-) rhs = [Log(rhs^-1 lhs), v1 - v2] (rollout.py _state_minus)
template <typename T>
__device__ __forceinline__ void state_minus(const T* q1, const T* t1, const T* v1, const T* q2,
                                            const T* t2, const T* v2, T* dx) {
  T qi[4], ti[3], qr[4], tr[3];
  se3_inverse(q2, t2, qi, ti);
  se3_multiply(qi, ti, q1, t1, qr, tr);
  se3_log(qr, tr, dx);
  for (int i = 0; i < 6; ++i) dx[6 + i] = v1[i] - v2[i];
}

// One Lie-Euler step of family M (rollout.py _dynamics_step, JAX
// kernels/models.py _quadrotor_dynamics_step / _wrench_dynamics_step):
// updates q, t, v in place. The rotor families: thrust sum(u) / m along body
// z, angular I^-1 MA u - I^-1 (w x I w). The wrench (kernels/models.py
// :164-187): linear -g R^T e_z + f / m, angular I^-1 (tau - w x I w).
template <class M, typename T>
__device__ __forceinline__ void dynamics_step(const Problem<T>& P, int b, T* q, T* t, T* v,
                                              const T* u) {
  constexpr int NU = M::kNu;
  const T dt = P.dt;
  const T ez[3] = {T(0), T(0), T(1)};
  T qc[4], rtez[3];
  quat_conjugate(q, qc);
  quat_rotate(qc, ez, rtez);
  T g = P.par(P.g, 0, b);
  const T minv = P.par(P.minv, 0, b);
  T acc[6];
  T I[9], Iinv[9];
  for (int i = 0; i < 9; ++i) {
    I[i] = P.par(P.inertia, i, b);
    Iinv[i] = P.par(P.inertia_inv, i, b);
  }
  T iom[3], c[3];
  matvec<3, 3>(I, v + 3, iom);
  cross(v + 3, iom, c);
  if constexpr (M::kWrench) {
    for (int i = 0; i < 3; ++i) acc[i] = -g * rtez[i] + minv * u[i];
    T tq[3];
    for (int i = 0; i < 3; ++i) tq[i] = u[3 + i] - c[i];
    matvec<3, 3>(Iinv, tq, acc + 3);
  } else {
    T usum = u[0];
    for (int i = 1; i < NU; ++i) usum = usum + u[i];
    T thrust = usum * minv;
    for (int i = 0; i < 3; ++i) acc[i] = -g * rtez[i] + thrust * ez[i];
    T ima[3 * NU], a1[3], a2[3];
    for (int i = 0; i < 3 * NU; ++i) ima[i] = P.par(P.iinv_ma, i, b);
    matvec<3, NU>(ima, u, a1);
    matvec<3, 3>(Iinv, c, a2);
    for (int i = 0; i < 3; ++i) acc[3 + i] = a1[i] - a2[i];
  }
  T tau[6], qe[4], te[3], qn[4], tn[3];
  for (int i = 0; i < 6; ++i) tau[i] = dt * v[i];
  se3_exp(tau, qe, te);
  se3_multiply(q, t, qe, te, qn, tn);
  for (int i = 0; i < 4; ++i) q[i] = qn[i];
  for (int i = 0; i < 3; ++i) t[i] = tn[i];
  for (int i = 0; i < 6; ++i) v[i] = v[i] + dt * acc[i];
}

// Nonzero blocks of the discrete dynamics Jacobian (backward.py
// _stage_jx_blocks):
//   j_x = [[ P (6x6)     T (6x6)                 ]
//          [ 0 | G       [[I3, 0], [0, M]]        ]]   (G at rows 6:9, cols 3:6)
// P = Adj(Exp(dt v))^-1, T = dt Jr_SE3(dt v), G = -dt g hat(R^T e_z),
// M = I3 + dt D, D = -I^-1 (hat(w) I - hat(I w)).
template <typename T>
struct JxBlocks {
  T P[36], Tm[36], G[9], M[9];
};

template <typename T>
__device__ __forceinline__ void stage_jx_blocks(const Problem<T>& P, int b, const T* q,
                                                const T* v, JxBlocks<T>& J) {
  const T dt = P.dt;
  const T ez[3] = {T(0), T(0), T(1)};
  T qc[4], rtez[3], h[9];
  quat_conjugate(q, qc);
  quat_rotate(qc, ez, rtez);
  hat(rtez, h);
  T gscale = (-dt) * P.par(P.g, 0, b);
  for (int i = 0; i < 9; ++i) J.G[i] = gscale * h[i];
  T I[9], Iinv[9];
  for (int i = 0; i < 9; ++i) {
    I[i] = P.par(P.inertia, i, b);
    Iinv[i] = P.par(P.inertia_inv, i, b);
  }
  T iom[3], hw[9], hi[9], inner[9], d[9];
  matvec<3, 3>(I, v + 3, iom);
  hat(v + 3, hw);
  matmul<3, 3, 3>(hw, I, inner);
  hat(iom, hi);
  for (int i = 0; i < 9; ++i) inner[i] = inner[i] - hi[i];
  matmul<3, 3, 3>(Iinv, inner, d);
  for (int i = 0; i < 9; ++i) J.M[i] = ((i % 4 == 0) ? T(1) : T(0)) + dt * (-d[i]);
  T tau[6], qe[4], te[3], qi[4], ti[3];
  for (int i = 0; i < 6; ++i) tau[i] = dt * v[i];
  se3_exp(tau, qe, te);
  se3_inverse(qe, te, qi, ti);
  se3_adjoint(qi, ti, J.P);
  se3_right_jacobian(tau, J.Tm);
  for (int i = 0; i < 36; ++i) J.Tm[i] = dt * J.Tm[i];
}

// j_x @ p for a 12-vector (backward.py _jx_vec): the FDDP quadratic model's
// forward recursion p' = j_x p + j_u w + d.
template <typename T>
__device__ __forceinline__ void jx_vec(const JxBlocks<T>& J, const T* p, T* out) {
  T a[6], c[6], g[3], m[3];
  matvec<6, 6>(J.P, p, a);
  matvec<6, 6>(J.Tm, p + 6, c);
  matvec<3, 3>(J.G, p + 3, g);
  matvec<3, 3>(J.M, p + 9, m);
  for (int i = 0; i < 6; ++i) out[i] = a[i] + c[i];
  for (int i = 0; i < 3; ++i) out[6 + i] = g[i] + p[6 + i];
  for (int i = 0; i < 3; ++i) out[9 + i] = m[i];
}

// C(w) (6x6) with w^T ad_u y = u^T C(w) y on se(3) (backward.py
// _ad_cot_lanes): [[0, -hat(w_rho)], [-hat(w_rho), -hat(w_theta)]]
template <typename T>
__device__ __forceinline__ void ad_cot(const T* w, T* c) {
  T hr[9], ht[9];
  hat(w, hr);
  hat(w + 3, ht);
  for (int r = 0; r < 3; ++r) {
    for (int k = 0; k < 3; ++k) {
      c[r * 6 + k] = T(0);
      c[r * 6 + 3 + k] = -hr[r * 3 + k];
      c[(r + 3) * 6 + k] = -hr[r * 3 + k];
      c[(r + 3) * 6 + 3 + k] = -ht[r * 3 + k];
    }
  }
}

// ---- the line searches' result and the exact loop's trip close ----

// What a line search leaves: whether it accepted, the cost of its last probe,
// the alpha it ends on, and the probe stages it ran.
template <typename T>
struct LineSearch {
  bool accepted;
  T cost;
  T alpha;
  int stages;
};

// The exact loop's trip close (solve.py _trip_close) after a trip whose gate
// left the lane `active` (or pre-converged it): the cost commit, the
// achieved-cost convergence check (not on trip 0), LINE_SEARCH_FAILED (2) on
// a search that ran out, CONVERGED (1). Returns whether the lane is done.
template <typename T>
__device__ __forceinline__ bool exact_trip_close(bool first, bool pre_conv, bool active,
                                                 const LineSearch<T>& ls, T current, T rtol,
                                                 T atol, T* cost, int* status, int* iters) {
  const bool post_conv =
      !first && converged(current, ls.cost, rtol, atol) && active && ls.accepted;
  const bool ls_failed = active && !ls.accepted;
  *cost = active ? ls.cost : current;
  const bool conv = post_conv || pre_conv;
  *status = ls_failed ? 2 : (conv ? 1 : *status);
  *iters += active ? 1 : 0;
  return conv || ls_failed;
}

// ---- the robust FDDP loop's options (fddp.cu, stream_fddp.cu) ----

// The FDDP loop's scalar options, in the packed order the hosts pass:
//   ints:  max_iters ls_max_iters ddp
//   reals: quu_reg rtol atol ls_step ls_jump goldstein_frac goldstein_ub gap_tol
//          reg_init reg_scale_up reg_scale_down reg_min reg_max alpha_dec alpha_inc
template <typename T>
struct FddpKnobs {
  int max_iters, ls_max_iters, ddp;
  T quu_reg, rtol, atol, ls_step, ls_jump, gf, gub, gap_tol, reg_init, reg_up, reg_down,
      reg_min, reg_max, a_dec, a_inc;
};

template <typename T>
inline FddpKnobs<T> fddp_knobs(const long long* ip, const double* rp) {
  FddpKnobs<T> k;
  k.max_iters = static_cast<int>(ip[0]);
  k.ls_max_iters = static_cast<int>(ip[1]);
  k.ddp = static_cast<int>(ip[2]);
  T* reals[] = {&k.quu_reg, &k.rtol,   &k.atol,     &k.ls_step, &k.ls_jump,
                &k.gf,      &k.gub,    &k.gap_tol,  &k.reg_init, &k.reg_up,
                &k.reg_down, &k.reg_min, &k.reg_max, &k.a_dec,  &k.a_inc};
  for (int i = 0; i < 15; ++i) *reals[i] = static_cast<T>(rp[i]);
  return k;
}

// max that keeps a NaN, as jnp.maximum / torch.amax do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  return (b != b || b > a) ? b : a;
}

}  // namespace qilqr
