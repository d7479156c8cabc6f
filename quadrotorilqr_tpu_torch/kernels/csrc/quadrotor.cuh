// The quadrotor model, tracking cost and one Riccati stage, per thread.
//
// Counterpart of quadrotorilqr_tpu/kernels/models.py (the quadrotor
// LaneModel), kernels/rollout.py (_dynamics_step, _state_minus) and
// kernels/backward.py (_stage_jx_blocks, _stage_cost_diffs, _riccati_stage;
// without the box/weights/drag/substep/penalty options), and the scalar trip
// logic of solve.py (_trip_close) and fddp.py (the FDDP options). The
// per-pass kernels backward.cu and rollout.cu run these pieces one thread
// per scenario; team.cuh builds the team kernels (solve.cu, fddp.cu,
// stream.cu, stream_fddp.cu) on their serial parts.
//
// Layout. Per-stage buffers are scenario-minor, (N, d, B): element (n, i) of
// scenario b sits at [(n * d + i) * B + b], so the 32 threads of a warp read
// 32 neighbouring values. The operand groups that may be shared or
// per-scenario (desired trajectory, Q/R, physical params) carry a B-stride s:
// element e of scenario b sits at [e * (s ? B : 1) + b * s]. With s = 0 every
// thread of a warp reads one address, which the hardware broadcasts.
#pragma once

#include "lanes.cuh"

namespace qilqr {

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
  const T *dq, *dtr, *dv, *du;  // desired (N, d, B or 1)
  const T *Q, *R;               // (12, 12, .), (4, 4, .)
  const T *g, *minv;            // (.)
  const T *ju;                  // (12, 4, .) discrete control Jacobian dt * j_cont_u
  const T *iinv_ma;             // (3, 4, .) I^-1 @ moment_arms
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

// One thread per scenario. 32 threads a block spreads B = 4096 scenarios
// over 128 blocks, so that nearly every one of the 132 SMs gets a warp.
constexpr int kThreadsPerBlock = 32;

inline int blocks_for(int batch) { return (batch + kThreadsPerBlock - 1) / kThreadsPerBlock; }

template <typename T>
__device__ __forceinline__ void load_stage(const Traj<T>& x, int B, int n, int b, T* q, T* t,
                                           T* v, T* u) {
  for (int i = 0; i < 4; ++i) q[i] = x.q[(n * 4 + i) * B + b];
  for (int i = 0; i < 3; ++i) t[i] = x.t[(n * 3 + i) * B + b];
  for (int i = 0; i < 6; ++i) v[i] = x.v[(n * 6 + i) * B + b];
  for (int i = 0; i < 4; ++i) u[i] = x.u[(n * 4 + i) * B + b];
}

template <typename T>
__device__ __forceinline__ void store_stage(const Traj<T>& x, int B, int n, int b, const T* q,
                                            const T* t, const T* v, const T* u) {
  for (int i = 0; i < 4; ++i) x.q[(n * 4 + i) * B + b] = q[i];
  for (int i = 0; i < 3; ++i) x.t[(n * 3 + i) * B + b] = t[i];
  for (int i = 0; i < 6; ++i) x.v[(n * 6 + i) * B + b] = v[i];
  for (int i = 0; i < 4; ++i) x.u[(n * 4 + i) * B + b] = u[i];
}

template <typename T>
__device__ __forceinline__ void load_desired(const Problem<T>& P, int n, int b, T* q, T* t, T* v,
                                             T* u) {
  for (int i = 0; i < 4; ++i) q[i] = P.des(P.dq, 4, n, i, b);
  for (int i = 0; i < 3; ++i) t[i] = P.des(P.dtr, 3, n, i, b);
  for (int i = 0; i < 6; ++i) v[i] = P.des(P.dv, 6, n, i, b);
  for (int i = 0; i < 4; ++i) u[i] = P.des(P.du, 4, n, i, b);
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

// One Lie-Euler step (rollout.py _dynamics_step): updates q, t, v in place.
template <typename T>
__device__ __forceinline__ void dynamics_step(const Problem<T>& P, int b, T* q, T* t, T* v,
                                              const T* u) {
  const T dt = P.dt;
  const T ez[3] = {T(0), T(0), T(1)};
  T qc[4], rtez[3];
  quat_conjugate(q, qc);
  quat_rotate(qc, ez, rtez);
  T g = P.par(P.g, 0, b);
  T thrust = (u[0] + u[1] + u[2] + u[3]) * P.par(P.minv, 0, b);
  T acc[6];
  for (int i = 0; i < 3; ++i) acc[i] = -g * rtez[i] + thrust * ez[i];
  T I[9], Iinv[9], ima[12];
  for (int i = 0; i < 9; ++i) {
    I[i] = P.par(P.inertia, i, b);
    Iinv[i] = P.par(P.inertia_inv, i, b);
  }
  for (int i = 0; i < 12; ++i) ima[i] = P.par(P.iinv_ma, i, b);
  T iom[3], c[3], a1[3], a2[3];
  matvec<3, 3>(I, v + 3, iom);
  cross(v + 3, iom, c);
  matvec<3, 4>(ima, u, a1);
  matvec<3, 3>(Iinv, c, a2);
  for (int i = 0; i < 3; ++i) acc[3 + i] = a1[i] - a2[i];
  T tau[6], qe[4], te[3], qn[4], tn[3];
  for (int i = 0; i < 6; ++i) tau[i] = dt * v[i];
  se3_exp(tau, qe, te);
  se3_multiply(q, t, qe, te, qn, tn);
  for (int i = 0; i < 4; ++i) q[i] = qn[i];
  for (int i = 0; i < 3; ++i) t[i] = tn[i];
  for (int i = 0; i < 6; ++i) v[i] = v[i] + dt * acc[i];
}

// Stage cost terms (dx' Q dx, du' R du) of (x, u) against desired stage n.
template <typename T>
__device__ __forceinline__ void stage_cost_terms(const Problem<T>& P, int n, int b, const T* q,
                                                 const T* t, const T* v, const T* u, T* xq,
                                                 T* ur) {
  T dq[4], dtr[3], dv[6], du[4], dx[12];
  load_desired(P, n, b, dq, dtr, dv, du);
  state_minus(q, t, v, dq, dtr, dv, dx);
  T qdx[12];
  for (int r = 0; r < 12; ++r) {
    T acc = P.q(r * 12, b) * dx[0];
    for (int k = 1; k < 12; ++k) acc += P.q(r * 12 + k, b) * dx[k];
    qdx[r] = acc;
  }
  *xq = dot<12>(dx, qdx);
  T e[4], rdu[4];
  for (int i = 0; i < 4; ++i) e[i] = u[i] - du[i];
  for (int r = 0; r < 4; ++r) {
    T acc = P.r(r * 4, b) * e[0];
    for (int k = 1; k < 4; ++k) acc += P.r(r * 4 + k, b) * e[k];
    rdu[r] = acc;
  }
  *ur = dot<4>(e, rdu);
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

// out (12 x C) = X (12 x C) through j_x^T, one element at a time, added
// onto out: out[r][c] = out[r][c] + (j_x^T X)[r][c]  (backward.py _jxt_mat).
// Pass acc = false to overwrite instead.
template <int C, typename T>
__device__ __forceinline__ void jxt_mat(const JxBlocks<T>& J, const T* X, T* out, bool acc) {
  for (int r = 0; r < 12; ++r) {
    for (int c = 0; c < C; ++c) {
      T val;
      if (r < 6) {
        val = J.P[r] * X[c];
        for (int k = 1; k < 6; ++k) val += J.P[k * 6 + r] * X[k * C + c];
        if (r >= 3) {
          T gp = J.G[r - 3] * X[6 * C + c];
          for (int k = 1; k < 3; ++k) gp += J.G[k * 3 + r - 3] * X[(6 + k) * C + c];
          val = val + gp;
        }
      } else {
        val = J.Tm[r - 6] * X[c];
        for (int k = 1; k < 6; ++k) val += J.Tm[k * 6 + r - 6] * X[k * C + c];
        if (r < 9) {
          val = val + X[r * C + c];
        } else {
          T mp = J.M[r - 9] * X[9 * C + c];
          for (int k = 1; k < 3; ++k) mp += J.M[k * 3 + r - 9] * X[(9 + k) * C + c];
          val = val + mp;
        }
      }
      out[r * C + c] = acc ? out[r * C + c] + val : val;
    }
  }
}

// out (12 x 12) = X (12 x 12) @ j_x  (backward.py _mat_jx)
template <typename T>
__device__ __forceinline__ void mat_jx(const JxBlocks<T>& J, const T* X, T* out) {
  for (int r = 0; r < 12; ++r) {
    const T* x = X + r * 12;
    for (int c = 0; c < 12; ++c) {
      T val;
      if (c < 6) {
        val = x[0] * J.P[c];
        for (int k = 1; k < 6; ++k) val += x[k] * J.P[k * 6 + c];
        if (c >= 3) {
          T gp = x[6] * J.G[c - 3];
          for (int k = 1; k < 3; ++k) gp += x[6 + k] * J.G[k * 3 + c - 3];
          val = val + gp;
        }
      } else {
        val = x[0] * J.Tm[c - 6];
        for (int k = 1; k < 6; ++k) val += x[k] * J.Tm[k * 6 + c - 6];
        if (c < 9) {
          val = val + x[c];
        } else {
          T mp = x[9] * J.M[c - 9];
          for (int k = 1; k < 3; ++k) mp += x[9 + k] * J.M[k * 3 + c - 9];
          val = val + mp;
        }
      }
      out[r * 12 + c] = val;
    }
  }
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

// Scratch that one reverse Riccati stage needs beside the value function.
template <typename T>
struct StageScratch {
  JxBlocks<T> J;
  T X[144];    // Q J_d blocks, then V_xx j_x
  T qxx[144];  // c_xx, then Q_xx, then S
};

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

// Tracking-cost differentials of stage n (backward.py _stage_cost_diffs):
// c_x (12), c_u (4) and the Gauss-Newton c_xx into qxx (X is scratch for
// Q J_d).
template <typename T>
__device__ __forceinline__ void stage_cost_diffs(const Problem<T>& P, int n, int b, const T* q,
                                                 const T* t, const T* v, const T* u, T* X,
                                                 T* qxx, T* c_x, T* c_u) {
  T dq[4], dtr[3], dv[6], dud[4], dx[12], W[36];
  load_desired(P, n, b, dq, dtr, dv, dud);
  state_minus(q, t, v, dq, dtr, dv, dx);
  se3_right_jacobian_inv(dx, W);
  T qdx[12];
  for (int r = 0; r < 12; ++r) {
    T acc = P.q(r * 12, b) * dx[0];
    for (int kk = 1; kk < 12; ++kk) acc += P.q(r * 12 + kk, b) * dx[kk];
    qdx[r] = acc;
  }
  for (int r = 0; r < 6; ++r) {
    T acc = W[r] * qdx[0];
    for (int kk = 1; kk < 6; ++kk) acc += W[kk * 6 + r] * qdx[kk];
    c_x[r] = T(2) * acc;
  }
  for (int r = 6; r < 12; ++r) c_x[r] = T(2) * qdx[r];
  // qjd = [Q[:, 0:6] W, Q[:, 6:12]] into X
  for (int r = 0; r < 12; ++r) {
    for (int c = 0; c < 6; ++c) {
      T acc = P.q(r * 12, b) * W[c];
      for (int kk = 1; kk < 6; ++kk) acc += P.q(r * 12 + kk, b) * W[kk * 6 + c];
      X[r * 12 + c] = acc;
    }
    for (int c = 6; c < 12; ++c) X[r * 12 + c] = P.q(r * 12 + c, b);
  }
  // c_xx = [2 W^T qjd[0:6]; 2 qjd[6:12]] into qxx
  for (int r = 0; r < 6; ++r) {
    for (int c = 0; c < 12; ++c) {
      T acc = W[r] * X[c];
      for (int kk = 1; kk < 6; ++kk) acc += W[kk * 6 + r] * X[kk * 12 + c];
      qxx[r * 12 + c] = T(2) * acc;
    }
  }
  for (int i = 72; i < 144; ++i) qxx[i] = T(2) * X[i];
  T e[4];
  for (int i = 0; i < 4; ++i) e[i] = u[i] - dud[i];
  for (int r = 0; r < 4; ++r) {
    T acc = (T(2) * P.r(r * 4, b)) * e[0];
    for (int kk = 1; kk < 4; ++kk) acc += (T(2) * P.r(r * 4 + kk, b)) * e[kk];
    c_u[r] = acc;
  }
}

// One reverse Riccati stage (backward.py _riccati_stage, the exact path):
// block-sparse j_x, Gauss-Newton cost diffs, Q-expansion with j_u
// contracted over its nonzero rows 8:12 only, unregularized 4x4 Cholesky
// gains (plus quu_reg * I), symmetrized value update. Stage n of scenario b
// with state (q, t, v, u). Updates v_x, v_xx in place; writes k (4), K (4x12)
// and the stage's Qu.k and k.Quu.k.
template <typename T>
__device__ void riccati_stage(const Problem<T>& P, T quu_reg, int n, int b, const T* q,
                              const T* t, const T* v, const T* u, T* v_x, T* v_xx,
                              StageScratch<T>& S, T* k, T* K, T* qutk_inc, T* ktquuk_inc) {
  JxBlocks<T>& J = S.J;
  stage_jx_blocks(P, b, q, v, J);
  T c_x[12], c_u[4];
  stage_cost_diffs(P, n, b, q, t, v, u, S.X, S.qxx, c_x, c_u);

  // --- Q-expansion ---
  // j_u rows 8:12 (the others are structural zeros): ju[r][a], r = 0..3
  T ju[16];
  for (int i = 0; i < 16; ++i) ju[i] = P.par(P.ju, 32 + i, b);
  T q_x[12];
  jxt_mat<1>(J, v_x, q_x, false);
  for (int i = 0; i < 12; ++i) q_x[i] = c_x[i] + q_x[i];
  T q_u[4];
  for (int a = 0; a < 4; ++a) {
    T acc = ju[a] * v_x[8];
    for (int r = 1; r < 4; ++r) acc += ju[r * 4 + a] * v_x[8 + r];
    q_u[a] = c_u[a] + acc;
  }
  mat_jx(J, v_xx, S.X);          // X = V_xx j_x
  jxt_mat<12>(J, S.X, S.qxx, true);  // Q_xx = c_xx + j_x^T V_xx j_x
  T vxx_ju[48];                   // V_xx[:, 8:12] ju_lo   (12 x 4)
  for (int r = 0; r < 12; ++r) {
    for (int c = 0; c < 4; ++c) {
      T acc = v_xx[r * 12 + 8] * ju[c];
      for (int kk = 1; kk < 4; ++kk) acc += v_xx[r * 12 + 8 + kk] * ju[kk * 4 + c];
      vxx_ju[r * 4 + c] = acc;
    }
  }
  T q_uu[16];
  for (int a = 0; a < 4; ++a) {
    for (int c = 0; c < 4; ++c) {
      T acc = ju[a] * vxx_ju[32 + c];
      for (int r = 1; r < 4; ++r) acc += ju[r * 4 + a] * vxx_ju[(8 + r) * 4 + c];
      q_uu[a * 4 + c] = (T(2) * P.r(a * 4 + c, b) + acc) + quu_reg * ((a == c) ? T(1) : T(0));
    }
  }
  T q_xu[48];
  jxt_mat<4>(J, vxx_ju, q_xu, false);

  // --- gains: [k | K] = -Quu^-1 [Qu | Qxu^T] ---
  T rhs[52], sol[52];
  for (int a = 0; a < 4; ++a) {
    rhs[a * 13] = q_u[a];
    for (int c = 0; c < 12; ++c) rhs[a * 13 + 1 + c] = q_xu[c * 4 + a];
  }
  chol_solve<4, 13>(q_uu, rhs, sol);
  for (int a = 0; a < 4; ++a) {
    k[a] = -sol[a * 13];
    for (int c = 0; c < 12; ++c) K[a * 12 + c] = -sol[a * 13 + 1 + c];
  }

  // --- value update ---
  T quu_k[4];
  matvec<4, 4>(q_uu, k, quu_k);
  for (int r = 0; r < 12; ++r) {
    T acc = K[r] * quu_k[0];
    for (int a = 1; a < 4; ++a) acc += K[a * 12 + r] * quu_k[a];
    v_x[r] = q_x[r] - acc;
  }
  T quuK[48];
  matmul<4, 4, 12>(q_uu, K, quuK);
  for (int r = 0; r < 12; ++r) {
    for (int c = 0; c < 12; ++c) {
      T acc = K[r] * quuK[c];
      for (int a = 1; a < 4; ++a) acc += K[a * 12 + r] * quuK[a * 12 + c];
      S.qxx[r * 12 + c] = S.qxx[r * 12 + c] - acc;
    }
  }
  // per-stage symmetrization 0.5 (S + S^T): f32 otherwise amplifies the
  // roundoff asymmetry of V_xx until Quu turns indefinite
  for (int r = 0; r < 12; ++r) {
    for (int c = 0; c < 12; ++c) {
      v_xx[r * 12 + c] = T(0.5) * (S.qxx[r * 12 + c] + S.qxx[c * 12 + r]);
    }
  }
  *qutk_inc = dot<4>(q_u, k);
  *ktquuk_inc = dot<4>(k, quu_k);
}

// The reverse sweep of scenario b over trajectory x (backward.py
// _backward_kernel's stage loop): k, K of every stage into ks (N, 4, B) and
// bigks (N, 4, 12, B); returns QuTk and kTQuuk.
template <typename T>
__device__ void backward_lane(const Problem<T>& P, T quu_reg, const Traj<T>& x, T* ks, T* bigks,
                              int b, T* qutk, T* ktquuk) {
  const int B = P.B;
  T v_x[12], v_xx[144];
  for (int i = 0; i < 12; ++i) v_x[i] = T(0);
  for (int i = 0; i < 144; ++i) v_xx[i] = T(0);
  StageScratch<T> S;
  T sum_qutk = T(0), sum_ktquuk = T(0);
  for (int n = P.N - 1; n >= 0; --n) {
    T q[4], t[3], v[6], u[4], k[4], K[48], a, c;
    load_stage(x, B, n, b, q, t, v, u);
    riccati_stage(P, quu_reg, n, b, q, t, v, u, v_x, v_xx, S, k, K, &a, &c);
    sum_qutk = sum_qutk + a;
    sum_ktquuk = sum_ktquuk + c;
    for (int i = 0; i < 4; ++i) ks[(n * 4 + i) * B + b] = k[i];
    for (int i = 0; i < 48; ++i) bigks[(n * 48 + i) * B + b] = K[i];
  }
  *qutk = sum_qutk;
  *ktquuk = sum_ktquuk;
}

// ---- the exact loop's rollout (rollout.cu) and trip close (solve.cu, stream.cu) ----

// One closed-loop rollout stage n of scenario b (rollout.py _rollout_kernel's
// stage body): u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n) from the
// carry (q, t, v) = x_n, the running cost c + dx'Q dx + du'R du (that order),
// the stage written to `out` when `store`, then the carry stepped to
// f(x_n, u_n). `out` may be `x` itself: stage n is read before it is
// written.
template <typename T>
__device__ __forceinline__ T rollout_stage(const Problem<T>& P, const Traj<T>& x, const T* ks,
                                           const T* bigks, T alpha, const Traj<T>& out,
                                           bool store, int n, int b, T* q, T* t, T* v, T c) {
  const int B = P.B;
  T qo[4], to[3], vo[6], uo[4], dx[12], u[4];
  load_stage(x, B, n, b, qo, to, vo, uo);
  state_minus(q, t, v, qo, to, vo, dx);
  for (int a = 0; a < 4; ++a) {
    T fb = bigks[((n * 4 + a) * 12) * B + b] * dx[0];
    for (int j = 1; j < 12; ++j) fb += bigks[((n * 4 + a) * 12 + j) * B + b] * dx[j];
    u[a] = (uo[a] + alpha * ks[(n * 4 + a) * B + b]) + fb;
  }
  T xq, ur;
  stage_cost_terms(P, n, b, q, t, v, u, &xq, &ur);
  c = c + xq + ur;
  if (store) store_stage(out, B, n, b, q, t, v, u);
  dynamics_step(P, b, q, t, v, u);
  return c;
}

// Closed-loop rollout of scenario b with step alpha (rollout.py
// _rollout_kernel's stage loop), written to `out` when `store`; returns the
// new trajectory's cost.
template <typename T>
__device__ __noinline__ T rollout_lane(const Problem<T>& P, const Traj<T>& x, const T* ks,
                                       const T* bigks, T alpha, const Traj<T>& out, bool store,
                                       int b) {
  T q[4], t[3], v[6], u[4];
  load_stage(x, P.B, 0, b, q, t, v, u);
  T cost = T(0);
  for (int n = 0; n < P.N; ++n) {
    cost = rollout_stage(P, x, ks, bigks, alpha, out, store, n, b, q, t, v, cost);
  }
  return cost;
}

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
