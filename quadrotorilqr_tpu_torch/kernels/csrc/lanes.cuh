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

}  // namespace qilqr
