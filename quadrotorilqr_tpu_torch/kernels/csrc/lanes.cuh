// Per-thread small-matrix and SO(3)/SE(3) math for the quadrotor kernels.
//
// Counterpart of quadrotorilqr_tpu/kernels/lanes.py. The TPU helpers work on
// (rows, cols, lanes) arrays with the scenario batch on the lane axis; here
// one CUDA thread owns one scenario, so every helper works on plain row-major
// arrays of T in that thread. The formulas, the manif conventions, the
// [lin, ang] tangent order and the small-angle Taylor branches
// (kSmallAngle = 1e-3) are the same, and every sum runs in the same order as
// lanes.py (matmul/matvec accumulate over the inner index from 0 upwards).
// atan2 is the native one: lanes.py builds its own only because the TPU
// compiler has none.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace qilqr {

constexpr double kSmallAngle = 1e-3;

__device__ __forceinline__ float f_sin(float x) { return sinf(x); }
__device__ __forceinline__ double f_sin(double x) { return sin(x); }
__device__ __forceinline__ float f_cos(float x) { return cosf(x); }
__device__ __forceinline__ double f_cos(double x) { return cos(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float f_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double f_abs(double x) { return fabs(x); }
__device__ __forceinline__ float f_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double f_atan2(double y, double x) { return atan2(y, x); }

// out (R x C) = a (R x K) @ b (K x C), all row-major
template <int R, int K, int C, typename T>
__device__ __forceinline__ void matmul(const T* a, const T* b, T* out) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T acc = a[r * K] * b[c];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += a[r * K + k] * b[k * C + c];
      out[r * C + c] = acc;
    }
  }
}

// out (R) = a (R x K) @ v (K)
template <int R, int K, typename T>
__device__ __forceinline__ void matvec(const T* a, const T* v, T* out) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    T acc = a[r * K] * v[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc += a[r * K + k] * v[k];
    out[r] = acc;
  }
}

template <int N, typename T>
__device__ __forceinline__ T dot(const T* a, const T* b) {
  T acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc += a[i] * b[i];
  return acc;
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ void hat(const T* v, T* m) {
  m[0] = T(0);  m[1] = -v[2]; m[2] = v[1];
  m[3] = v[2];  m[4] = T(0);  m[5] = -v[0];
  m[6] = -v[1]; m[7] = v[0];  m[8] = T(0);
}

// Solve a x = b for SPD a (n x n) and b (n x k) by an unrolled pivot-free
// Cholesky (lanes.py chol_solve, ops/linalg.py).
template <int NN, int KK, typename T>
__device__ __forceinline__ void chol_solve(const T* a, const T* b, T* x) {
  T l[NN][NN];
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    T s = a[j * NN + j];
#pragma unroll
    for (int kk = 0; kk < j; ++kk) s = s - l[j][kk] * l[j][kk];
    T d = f_sqrt(s);
    l[j][j] = d;
    T inv_d = T(1) / d;
#pragma unroll
    for (int i = j + 1; i < NN; ++i) {
      T si = a[i * NN + j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) si = si - l[i][kk] * l[j][kk];
      l[i][j] = si * inv_d;
    }
  }
  T y[NN][KK];
#pragma unroll
  for (int i = 0; i < NN; ++i) {
#pragma unroll
    for (int c = 0; c < KK; ++c) {
      T s = b[i * KK + c];
#pragma unroll
      for (int j = 0; j < i; ++j) s = s - l[i][j] * y[j][c];
      y[i][c] = s / l[i][i];
    }
  }
#pragma unroll
  for (int i = NN - 1; i >= 0; --i) {
#pragma unroll
    for (int c = 0; c < KK; ++c) {
      T s = y[i][c];
#pragma unroll
      for (int j = i + 1; j < NN; ++j) s = s - l[j][i] * x[j * KK + c];
      x[i * KK + c] = s / l[i][i];
    }
  }
}

// ---------------------------------------------------------------------------
// quaternions (w, x, y, z)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void quat_conjugate(const T* q, T* out) {
  out[0] = q[0]; out[1] = -q[1]; out[2] = -q[2]; out[3] = -q[3];
}

template <typename T>
__device__ __forceinline__ void quat_multiply(const T* a, const T* b, T* out) {
  T aw = a[0], ax = a[1], ay = a[2], az = a[3];
  T bw = b[0], bx = b[1], by = b[2], bz = b[3];
  out[0] = aw * bw - ax * bx - ay * by - az * bz;
  out[1] = aw * bx + ax * bw + ay * bz - az * by;
  out[2] = aw * by - ax * bz + ay * bw + az * bx;
  out[3] = aw * bz + ax * by - ay * bx + az * bw;
}

template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* out) {
  T c[3], t[3], ct[3];
  cross(q + 1, v, c);
  t[0] = T(2) * c[0]; t[1] = T(2) * c[1]; t[2] = T(2) * c[2];
  cross(q + 1, t, ct);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + ct[i];
}

template <typename T>
__device__ __forceinline__ void quat_to_matrix(const T* q, T* r) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  T xx = x * x, yy = y * y, zz = z * z;
  T wx = w * x, wy = w * y, wz = w * z;
  T xy = x * y, xz = x * z, yz = y * z;
  r[0] = T(1) - T(2) * (yy + zz); r[1] = T(2) * (xy - wz); r[2] = T(2) * (xz + wy);
  r[3] = T(2) * (xy + wz); r[4] = T(1) - T(2) * (xx + zz); r[5] = T(2) * (yz - wx);
  r[6] = T(2) * (xz - wy); r[7] = T(2) * (yz + wx); r[8] = T(1) - T(2) * (xx + yy);
}

// ---------------------------------------------------------------------------
// SO(3)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void so3_exp(const T* th, T* q) {
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T k, w;
  if (ts < T(kSmallAngle * kSmallAngle)) {
    k = T(0.5) - ts / T(48) + ts * ts / T(3840);
    w = T(1) - ts / T(8) + ts * ts / T(384);
  } else {
    T angle = f_sqrt(ts);
    T half = T(0.5) * angle;
    k = f_sin(half) / angle;
    w = f_cos(half);
  }
  q[0] = w; q[1] = k * th[0]; q[2] = k * th[1]; q[3] = k * th[2];
}

template <typename T>
__device__ __forceinline__ void so3_log(const T* q, T* th) {
  T w = q[0];
  T s2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  T k;
  if (s2 < T((0.5 * kSmallAngle) * (0.5 * kSmallAngle))) {
    T r2 = s2 / (w * w);
    k = (T(2) / w) * (T(1) - r2 / T(3) + r2 * r2 / T(5));
  } else {
    T sa = f_sqrt(s2);
    bool neg = w < T(0);
    T two_angle = T(2) * f_atan2(neg ? -sa : sa, neg ? -w : w);
    k = two_angle / sa;
  }
  th[0] = k * q[1]; th[1] = k * q[2]; th[2] = k * q[3];
}

// (B, C) with Jl = I + B W + C W^2
template <typename T>
__device__ __forceinline__ void ljac_coeffs(T ts, T* b, T* c) {
  if (ts < T(kSmallAngle * kSmallAngle)) {
    *b = T(0.5) - ts / T(24) + ts * ts / T(720);
    *c = T(1) / T(6) - ts / T(120) + ts * ts / T(5040);
  } else {
    T t = f_sqrt(ts);
    T st = f_sin(t), ct = f_cos(t);
    *b = (T(1) - ct) / ts;
    *c = (t - st) / (ts * t);
  }
}

// D with Jl^-1 = I - W/2 + D W^2
template <typename T>
__device__ __forceinline__ T ljacinv_coeff(T ts) {
  if (ts < T(kSmallAngle * kSmallAngle))
    return T(1) / T(12) + ts / T(720) + ts * ts / T(30240);
  T t = f_sqrt(ts);
  T st = f_sin(t), ct = f_cos(t);
  return T(1) / ts - (T(1) + ct) / (T(2) * t * st);
}

template <typename T>
__device__ __forceinline__ void so3_left_jacobian(const T* th, T* j) {
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T b, c;
  ljac_coeffs(ts, &b, &c);
  T w[9], w2[9];
  hat(th, w);
  matmul<3, 3, 3>(w, w, w2);
#pragma unroll
  for (int i = 0; i < 9; ++i) j[i] = ((i % 4 == 0) ? T(1) : T(0)) + b * w[i] + c * w2[i];
}

template <typename T>
__device__ __forceinline__ void so3_left_jacobian_inv(const T* th, T* j) {
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T d = ljacinv_coeff(ts);
  T w[9], w2[9];
  hat(th, w);
  matmul<3, 3, 3>(w, w, w2);
#pragma unroll
  for (int i = 0; i < 9; ++i) j[i] = ((i % 4 == 0) ? T(1) : T(0)) - T(0.5) * w[i] + d * w2[i];
}

// ---------------------------------------------------------------------------
// SE(3): tangent [lin(3), ang(3)], group (quat(4), trans(3))
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void se3_exp(const T* tau, T* q, T* t) {
  T v[9];
  so3_left_jacobian(tau + 3, v);
  so3_exp(tau + 3, q);
  matvec<3, 3>(v, tau, t);
}

template <typename T>
__device__ __forceinline__ void se3_log(const T* q, const T* t, T* tau) {
  so3_log(q, tau + 3);
  T vinv[9];
  so3_left_jacobian_inv(tau + 3, vinv);
  matvec<3, 3>(vinv, t, tau);
}

template <typename T>
__device__ __forceinline__ void se3_multiply(const T* qa, const T* ta, const T* qb,
                                             const T* tb, T* q, T* t) {
  quat_multiply(qa, qb, q);
  T r[3];
  quat_rotate(qa, tb, r);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = ta[i] + r[i];
}

template <typename T>
__device__ __forceinline__ void se3_inverse(const T* q, const T* t, T* qi, T* ti) {
  quat_conjugate(q, qi);
  T r[3];
  quat_rotate(qi, t, r);
  ti[0] = -r[0]; ti[1] = -r[1]; ti[2] = -r[2];
}

// assemble [[a, b], [0, d]] (3x3 blocks) into a row-major 6x6
template <typename T>
__device__ __forceinline__ void block66(const T* a, const T* b, const T* d, T* m) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      m[r * 6 + c] = a[r * 3 + c];
      m[r * 6 + 3 + c] = b[r * 3 + c];
      m[(r + 3) * 6 + c] = T(0);
      m[(r + 3) * 6 + 3 + c] = d[r * 3 + c];
    }
  }
}

// Adj = [[R, hat(t) R], [0, R]]
template <typename T>
__device__ __forceinline__ void se3_adjoint(const T* q, const T* t, T* adj) {
  T r[9], h[9], tr[9];
  quat_to_matrix(q, r);
  hat(t, h);
  matmul<3, 3, 3>(h, r, tr);
  block66(r, tr, r, adj);
}

// Barfoot Q-matrix, the upper-right block of Jl_SE3
template <typename T>
__device__ __forceinline__ void se3_q_matrix(const T* tau, T* qm) {
  const T* rho = tau;
  const T* th = tau + 3;
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T b, c, e;
  if (ts < T(kSmallAngle * kSmallAngle)) {
    b = T(1) / T(6) - ts / T(120) + ts * ts / T(5040);
    c = -T(1) / T(24) + ts / T(720) - ts * ts / T(40320);
    e = -T(1) / T(120) + ts / T(5040) - ts * ts / T(362880);
  } else {
    T t = f_sqrt(ts);
    T st = f_sin(t), ct = f_cos(t);
    b = (t - st) / (ts * t);
    c = (T(1) - T(0.5) * ts - ct) / (ts * ts);
    e = (t - st - ts * t / T(6)) / (ts * ts * t);
  }
  T d = c - T(3) * e;
  T v[9], w[9], vw[9], wv[9], wvw[9], vww[9], wwv[9], wvww[9], wwvw[9];
  hat(rho, v);
  hat(th, w);
  matmul<3, 3, 3>(v, w, vw);
  matmul<3, 3, 3>(w, v, wv);
  matmul<3, 3, 3>(wv, w, wvw);
  matmul<3, 3, 3>(vw, w, vww);
  matmul<3, 3, 3>(w, wv, wwv);
  matmul<3, 3, 3>(wvw, w, wvww);
  matmul<3, 3, 3>(w, wvw, wwvw);
#pragma unroll
  for (int i = 0; i < 9; ++i)
    qm[i] = T(0.5) * v[i] + b * (wv[i] + vw[i] + wvw[i]) -
            c * (wwv[i] + vww[i] - T(3) * wvw[i]) - T(0.5) * d * (wvww[i] + wwvw[i]);
}

// Jr_SE3(tau) = Jl_SE3(-tau)
template <typename T>
__device__ __forceinline__ void se3_right_jacobian(const T* tau, T* j) {
  T nt[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) nt[i] = -tau[i];
  T jl[9], qm[9];
  so3_left_jacobian(nt + 3, jl);
  se3_q_matrix(nt, qm);
  block66(jl, qm, jl, j);
}

// Jr_SE3(tau)^-1 = Jl_SE3(-tau)^-1 = [[Jl^-1, -Jl^-1 Q Jl^-1], [0, Jl^-1]]
template <typename T>
__device__ __forceinline__ void se3_right_jacobian_inv(const T* tau, T* j) {
  T nt[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) nt[i] = -tau[i];
  T jli[9], qm[9], a[9], b[9];
  so3_left_jacobian_inv(nt + 3, jli);
  se3_q_matrix(nt, qm);
  matmul<3, 3, 3>(jli, qm, a);
  matmul<3, 3, 3>(a, jli, b);
#pragma unroll
  for (int i = 0; i < 9; ++i) b[i] = -b[i];
  block66(jli, b, jli, j);
}

// ---------------------------------------------------------------------------
// D[J^T w] curvature primitives (lanes.py so3_left_jacobian_t_jac,
// _se3_q_t_jacs, se3_{left,right}_jacobian_t_jac): the exp chart's second
// differential contracted with a fixed cotangent w, behind the exact-DDP
// curvature. The coefficient derivatives take a wider Taylor window
// (u = |theta|^2 < 0.25) because their exact forms cancel ~1/u^2 terms.
// ---------------------------------------------------------------------------

// (dB/du, dC/du) of the Jl coefficients
template <typename T>
__device__ __forceinline__ void ljac_coeffs_du(T u, T* db, T* dc) {
  if (u < T(0.25)) {
    *db = T(-1.0 / 24.0) + u / T(360) - u * u / T(13440) + u * u * u / T(907200);
    *dc = T(-1.0 / 120.0) + u / T(2520) - u * u / T(120960) + u * u * u / T(9979200);
  } else {
    T t = f_sqrt(u);
    T st = f_sin(t), ct = f_cos(t);
    *db = (T(0.5) * t * st - (T(1) - ct)) / (u * u);
    *dc = (T(0.5) * (T(1) - ct) - T(1.5) * (t - st) / t) / (u * u);
  }
}

// out (3x3) = D_theta[Jl(theta)^T w]
//   = B hat(w) - 2B' (theta x w) theta^T + 2C' (theta x (theta x w)) theta^T
//     - C (hat(theta x w) + hat(theta) hat(w))
template <typename T>
__device__ __forceinline__ void so3_left_jacobian_t_jac(const T* th, const T* w, T* out) {
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T b, c, db, dc;
  ljac_coeffs(ts, &b, &c);
  ljac_coeffs_du(ts, &db, &dc);
  T tw[3], ttw[3], hw[9], htw[9], hth[9], hh[9];
  cross(th, w, tw);
  cross(th, tw, ttw);
  hat(w, hw);
  hat(tw, htw);
  hat(th, hth);
  matmul<3, 3, 3>(hth, hw, hh);
  const T db2 = T(2) * db, dc2 = T(2) * dc;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = i * 3 + j;
      out[e] = b * hw[e] - db2 * (tw[i] * th[j]) + dc2 * (ttw[i] * th[j]) - c * (htw[e] + hh[e]);
    }
  }
}

// (db/du, dc/du, de/du) of the Q-matrix coefficients
template <typename T>
__device__ __forceinline__ void q_coeffs_du(T u, T* db, T* dc, T* de) {
  if (u < T(0.25)) {
    *db = T(-1.0 / 120.0) + u / T(2520) - u * u / T(120960) + u * u * u / T(9979200);
    *dc = T(1.0 / 720.0) - u / T(20160) + u * u / T(1209600) - u * u * u / T(119750400);
    *de = T(1.0 / 5040.0) - u / T(181440) + u * u / T(13305600) - u * u * u / T(1556755200);
  } else {
    T t = f_sqrt(u);
    T st = f_sin(t), ct = f_cos(t);
    T u2 = u * u;
    *db = (T(0.5) * (T(1) - ct) - T(1.5) * (t - st) / t) / u2;
    T c_num = T(1) - T(0.5) * u - ct;
    *dc = (T(0.5) * st / t - T(0.5)) / u2 - T(2) * c_num / (u2 * u);
    T e_num = t - st - u * t / T(6);
    *de = ((T(1) - ct) / (T(2) * t) - T(0.25) * t) / (u2 * t) - T(2.5) * e_num / (u2 * u * t);
  }
}

// (D_rho[Q^T w], D_theta[Q^T w]), each 3x3, for a fixed 3-cotangent w
template <typename T>
__device__ __noinline__ void se3_q_t_jacs(const T* tau, const T* w, T* d_rho, T* d_theta) {
  const T* rho = tau;
  const T* th = tau + 3;
  T ts = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
  T b, c, e;
  if (ts < T(kSmallAngle * kSmallAngle)) {
    b = T(1) / T(6) - ts / T(120) + ts * ts / T(5040);
    c = -T(1) / T(24) + ts / T(720) - ts * ts / T(40320);
    e = -T(1) / T(120) + ts / T(5040) - ts * ts / T(362880);
  } else {
    T t = f_sqrt(ts);
    T st = f_sin(t), ct = f_cos(t);
    b = (t - st) / (ts * t);
    c = (T(1) - T(0.5) * ts - ct) / (ts * ts);
    e = (t - st - ts * t / T(6)) / (ts * ts * t);
  }
  const T d = c - T(3) * e;
  T db_u, dc_u, de_u;
  q_coeffs_du(ts, &db_u, &dc_u, &de_u);
  const T dd_u = dc_u - T(3) * de_u;

  T v[9], wm[9], ww[9], wv[9], vw[9], wvw[9], vww[9], wwv[9];
  hat(rho, v);
  hat(th, wm);
  matmul<3, 3, 3>(wm, wm, ww);
  matmul<3, 3, 3>(wm, v, wv);
  matmul<3, 3, 3>(v, wm, vw);
  matmul<3, 3, 3>(wv, wm, wvw);
  matmul<3, 3, 3>(v, ww, vww);
  matmul<3, 3, 3>(ww, v, wwv);
  T h0[9];
  hat(w, h0);
  T ww_v[3], w2w[3], vw_v[3], vww_v[3], wvw_v[3], wvww_v[3], vw2w_v[3], wwv_v[3];
  matvec<3, 3>(wm, w, ww_v);
  matvec<3, 3>(ww, w, w2w);
  matvec<3, 3>(v, w, vw_v);
  matvec<3, 3>(vw, w, vww_v);
  matvec<3, 3>(wv, w, wvw_v);
  matvec<3, 3>(wvw, w, wvww_v);
  matvec<3, 3>(vww, w, vw2w_v);
  matvec<3, 3>(wwv, w, wwv_v);
  T h1[9], h2[9], p1[9], h_vw[9], h_wv[9], h_wvw[9], h_vww[9];
  hat(ww_v, h1);
  hat(w2w, h2);
  hat(vw_v, p1);
  hat(vww_v, h_vw);
  hat(wvw_v, h_wv);
  hat(wvww_v, h_wvw);
  hat(vw2w_v, h_vww);

  // D_rho: per term B^T hat(A^T w)
  {
    T wm_h0[9], wm_h1[9], ww_h0[9], ww_h1[9], wm_h2[9];
    matmul<3, 3, 3>(wm, h0, wm_h0);
    matmul<3, 3, 3>(wm, h1, wm_h1);
    matmul<3, 3, 3>(ww, h0, ww_h0);
    matmul<3, 3, 3>(ww, h1, ww_h1);
    matmul<3, 3, 3>(wm, h2, wm_h2);
#pragma unroll
    for (int i = 0; i < 9; ++i)
      d_rho[i] = T(0.5) * h0[i] + b * (-h1[i] - wm_h0[i] + wm_h1[i]) -
                 c * (h2[i] + ww_h0[i] - T(3) * wm_h1[i]) +
                 T(0.5) * d * (ww_h1[i] + wm_h2[i]);
  }
  // D_theta: W-slot replacements plus the coefficient chain through u
  T v_h0[9], wv_h0[9], vw_h0[9], v_h1[9], wm_p1[9], ww_vh0[9], wm_hvw[9], wvw_h0[9], wv_h1[9];
  matmul<3, 3, 3>(v, h0, v_h0);
  matmul<3, 3, 3>(wv, h0, wv_h0);
  matmul<3, 3, 3>(vw, h0, vw_h0);
  matmul<3, 3, 3>(v, h1, v_h1);
  matmul<3, 3, 3>(wm, p1, wm_p1);
  matmul<3, 3, 3>(ww, v_h0, ww_vh0);
  matmul<3, 3, 3>(wm, h_vw, wm_hvw);
  matmul<3, 3, 3>(wvw, h0, wvw_h0);
  matmul<3, 3, 3>(wv, h1, wv_h1);
  T ww_vw[9], wm_vww[9], vd1[3], vd2[3];
  matmul<3, 3, 3>(ww, vw, ww_vw);
  matmul<3, 3, 3>(wm, vww, wm_vww);
  matvec<3, 3>(ww_vw, w, vd1);
  matvec<3, 3>(wm_vww, w, vd2);
  T vb[3], vc[3], vd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vb[i] = vww_v[i] + wvw_v[i] - wvww_v[i];
    vc[i] = -vw2w_v[i] - wwv_v[i] + T(3) * wvww_v[i];
    vd[i] = vd1[i] + vd2[i];
  }
  const T db2 = T(2) * db_u, dc2 = T(2) * dc_u, d5 = T(0.5) * d;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int k = i * 3 + j;
      const T mat_b = -v_h0[k] - p1[k] + wv_h0[k] + h_vw[k];
      const T mat_c = vw_h0[k] + v_h1[k] + wm_p1[k] + h_wv[k] - T(3) * (wv_h0[k] + h_vw[k]);
      const T mat_d = ww_vh0[k] + wm_hvw[k] + h_wvw[k] + wvw_h0[k] + wv_h1[k] + h_vww[k];
      d_theta[k] = b * mat_b - c * mat_c + d5 * mat_d + db2 * (vb[i] * th[j]) -
                   dc2 * (vc[i] * th[j]) - dd_u * (vd[i] * th[j]);
    }
  }
}

// out (6x6) = D_tau[Jl_SE3(tau)^T w] = [[0, D[Jl^T w_r]], [D_rho[Q^T w_r],
// D_theta[Q^T w_r] + D[Jl^T w_t]]]
template <typename T>
__device__ __forceinline__ void se3_left_jacobian_t_jac(const T* tau, const T* w, T* out) {
  T top[9], dq_r[9], dq_t[9], bt[9];
  so3_left_jacobian_t_jac(tau + 3, w, top);
  se3_q_t_jacs(tau, w, dq_r, dq_t);
  so3_left_jacobian_t_jac(tau + 3, w + 3, bt);
#pragma unroll
  for (int i = 0; i < 9; ++i) bt[i] = dq_t[i] + bt[i];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[r * 6 + c] = T(0);
      out[r * 6 + 3 + c] = top[r * 3 + c];
      out[(r + 3) * 6 + c] = dq_r[r * 3 + c];
      out[(r + 3) * 6 + 3 + c] = bt[r * 3 + c];
    }
  }
}

// D_tau[Jr_SE3(tau)^T w] = -D[Jl^T w](-tau)
template <typename T>
__device__ __forceinline__ void se3_right_jacobian_t_jac(const T* tau, const T* w, T* out) {
  T nt[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) nt[i] = -tau[i];
  se3_left_jacobian_t_jac(nt, w, out);
#pragma unroll
  for (int i = 0; i < 36; ++i) out[i] = -out[i];
}

}  // namespace qilqr
