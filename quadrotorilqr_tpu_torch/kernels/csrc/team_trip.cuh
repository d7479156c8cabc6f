// The sweeps and line searches of the team kernels, built from team.cuh's
// stage pieces and shared by the whole-solve kernels (solve.cu, fddp.cu),
// which keep each probe's candidate in a buffer, their streamed twins
// (stream.cu, stream_fddp.cu), which store nothing while probing and re-roll
// the chosen candidate in an apply sweep, and the per-pass kernels
// (backward.cu, rollout.cu), which run one reverse or one rollout sweep.
//
//   * exact loop (solve.py / stream.py): the reverse sweep, the closed-loop
//     rollout sweep, the trajectory cost, the backtracking line search;
//   * FDDP loop (fddp.py / stream_fddp.py): the reverse sweep with defects
//     and the gap transport, the gap-contracting sweep, the seed cost, the
//     Goldstein line search, the trip close.
//
// A whole-solve kernel merges an accepted candidate into the live
// trajectory inside the next trip's reverse sweep: the ring fetches each
// stage from the candidate buffer and the lane that fetched an element
// writes it into the live trajectory (team_merge_stage). The FDDP reverse
// sweep, line search and gap sweep are never inlined, so fddp.cu and
// stream_fddp.cu compile them alike whatever surrounds them (the merge and
// the candidate stores are runtime flags), and the two kernels agree bit for
// bit in float64 where their arithmetic is the same. Each entry's sum order
// does not depend on the team size, so they agree across team sizes too.
// Every piece takes the model family M from the team's type, Team<T, M>,
// and the box and weights variants as compile-time flags kBox, kW with their
// operands in a VariantOps (the weights ride the operand ring).
#pragma once

#include "team.cuh"

namespace qilqr {
inline namespace QILQR_TEAM_NS(QILQR_TEAM_LANES) {

// ---- the exact loop ----

// The reverse sweep of the team's scenario (backward.py _backward_kernel's
// stage loop): k|K of every stage into the gains scratch; the sums of Qu.k
// and k.Quu.k. The stages come from `src`; with `merge` each is also written
// into `live` (src is then the last trip's candidate). kBox and kW run the
// Riccati stage's box and weights variants on var's operands (the weights
// ride the ring). kPen adds each stage's penalty row, fetched through `pen`
// (the per-pass kernel's penalty variant). Inlined into every kernel, with
// or without the variants: behind a never-inlined call the compiler loses
// that the team's pointers address shared memory, and a variant's sweep
// took up to twice as long (PERF.md section 6).
template <typename T, bool kBox = false, bool kW = false, bool kPen = false, class M>
__device__ __forceinline__ void team_backward(const Team<T, M>& tm, const Problem<T>& P,
                                              const Problem<T>& Ps, T quu_reg, const Traj<T>& src,
                                              bool merge, const Traj<T>& live, T* gains, T* qutk,
                                              T* ktquuk,
                                              const VariantOps<T>& var = VariantOps<T>{},
                                              const PenRing<T>& pen = PenRing<T>{}) {
  team_zero_value(tm);
  T sum_qutk = T(0), sum_ktquuk = T(0);
  const RingSrc<T> ring{src, nullptr, nullptr, kW ? var.w : nullptr, var.s_w};
  ring_sweep<kPen>(tm, P, ring, true, [&](int n, const T* slot) {
    if (merge) team_merge_stage(tm, live, P.B, n, slot);
    T a, c;
    // this stage's penalty row: ring row (sweep step N - 1 - n) % kRing
    const T* pen_row = kPen ? pen.ring + ((P.N - 1 - n) % kRing) * PenRow<M>::kPitch : nullptr;
    team_riccati_stage<T, false, kBox, kW, kPen>(tm, Ps, quu_reg, slot, &a, &c, var, pen_row);
    sum_qutk = sum_qutk + a;
    sum_ktquuk = sum_ktquuk + c;
    team_put_row(tm, tm.s->gains, scratch_row(gains, P.B, n, tm.b, M::kGainsPitch),
                 M::kGainsPitch);
    return true;
  }, pen);
  *qutk = sum_qutk;
  *ktquuk = sum_ktquuk;
}

// Closed-loop rollout of the team's scenario from x with step alpha
// (rollout.py _rollout_kernel's stage loop): per stage
// u_n = u_old_n + alpha k_n + K_n (x_n (-) x_old_n), the running cost
// c + dx'Q dx + du'R du, the stage written into `out` when `store` (out may
// be x: stage n is read before it is written), then the carry stepped.
// Never inlined, and the store is a runtime flag: a cost-only probe and a
// sweep that stores its candidate run the same instructions. The variants:
// kBox clamps u_n into var's [lo, hi]; kW sums c + w_n (dx'Q dx + du'R du)
// (rollout.py :108-128; without it the sum keeps its unweighted order).
template <typename T, bool kBox = false, bool kW = false, class M>
__device__ __noinline__ T team_rollout(Team<T, M> tm, Problem<T> P, Traj<T> x, Traj<T> out,
                                       const T* gains, T alpha, bool store,
                                       VariantOps<T> var = VariantOps<T>{}) {
  constexpr int NU = M::kNu;
  const Problem<T> Ps = smem_problem(P, tm);
  const Tile tile = team_tile();
  T q[4], t[3], v[6];
  T cost = T(0);
  const RingSrc<T> ring{x, gains, nullptr, kW ? var.w : nullptr, var.s_w};
  ring_sweep(tm, P, ring, false, [&](int n, const T* slot) {
    T qo[4], to[3], vo[6], uo[NU], dx[12], u[NU];
    read_stage<M>(slot + Slot<M>::kLive, qo, to, vo, uo);
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = qo[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = to[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = vo[i];
    }
    state_minus(q, t, v, qo, to, vo, dx);
    const T* g = slot + Slot<M>::kGains;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      T fb = g[NU + a * 12] * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) fb += g[NU + a * 12 + j] * dx[j];
      u[a] = (uo[a] + alpha * g[a]) + fb;
      if constexpr (kBox) {
        u[a] = clip(u[a], var.bound(var.lo, a, P.B, tm.b), var.bound(var.hi, a, P.B, tm.b));
      }
    }
    T xq, ur;
    team_cost_terms(tile, tm.lane, tm.cc, slot + Slot<M>::kDes, q, t, v, u, &xq, &ur);
    if constexpr (kW) {
      cost = cost + weigh<kW>(slot[Slot<M>::kW], xq + ur);
    } else {
      cost = cost + xq + ur;
    }
    if (store) team_store_stage(tm, out, P.B, n, q, t, v, u);
    team_stage_step(tm, Ps, q, t, v, u);
    return true;
  });
  return cost;
}

// The cost of the team's trajectory x, summed stage by stage as the rollout
// sums it (solve.py's seed cost), weighted with kW.
template <typename T, bool kW = false, class M>
__device__ __forceinline__ T team_trajectory_cost(const Team<T, M>& tm, const Problem<T>& P,
                                                  const Traj<T>& x,
                                                  const VariantOps<T>& var = VariantOps<T>{}) {
  const Tile tile = team_tile();
  T cost = T(0);
  const RingSrc<T> ring{x, nullptr, nullptr, kW ? var.w : nullptr, var.s_w};
  ring_sweep(tm, P, ring, false, [&](int n, const T* slot) {
    T q[4], t[3], v[6], u[M::kNu], xq, ur;
    read_stage<M>(slot + Slot<M>::kLive, q, t, v, u);
    team_cost_terms(tile, tm.lane, tm.cc, slot + Slot<M>::kDes, q, t, v, u, &xq, &ur);
    if constexpr (kW) {
      cost = cost + weigh<kW>(slot[Slot<M>::kW], xq + ur);
    } else {
      cost = cost + xq + ur;
    }
    return true;
  });
  return cost;
}

// The backtracking line search (solve.py _ls_probe_commit) from the live
// trajectory x: probe j rolls out at alpha = ls_step^j and is accepted when its cost
// change falls below ls_frac dJ(alpha), or at once with `force`. A search
// that runs out ends on the alpha it last tried. With `store` each probe
// writes its candidate into `out`; otherwise the probes sum costs only. The
// probes are team_rollout's (kBox, kW) instantiation.
template <typename T, bool kBox = false, bool kW = false, class M>
__device__ __forceinline__ LineSearch<T> team_line_search(const Team<T, M>& tm, const Problem<T>& P,
                                                          const Traj<T>& x, const Traj<T>& out,
                                                          bool store, const T* gains, T qutk,
                                                          T ktquuk, T current, bool force,
                                                          int ls_max_iters, T ls_step,
                                                          T ls_frac,
                                                          const VariantOps<T>& var =
                                                              VariantOps<T>{}) {
  LineSearch<T> ls{false, current, T(1), 0};
  T alpha = T(1);
  for (int j = 0; j < ls_max_iters; ++j) {
    const T cand = team_rollout<T, kBox, kW>(tm, P, x, out, gains, alpha, store, var);
    const T desired = ls_frac * (alpha * qutk + alpha * alpha * ktquuk * T(0.5));
    ls.cost = cand;
    ls.alpha = alpha;
    ls.stages += P.N;
    ls.accepted = (cand - current) < desired || force;
    if (ls.accepted) break;
    alpha = alpha * ls_step;
  }
  return ls;
}

// ---- the FDDP loop ----

// One FDDP reverse sweep of the team's scenario. The stages come from `src`;
// with `merge` each is also written into `live` (src is then the accepted
// candidate). With `stale` it recomputes the defects d_n = f(x_n, u_n) (-)
// x_{n+1} (d_{N-1} = 0) into d and returns their max |d|; otherwise it reads
// the stored defects and returns `gap`. Every stage transports the value
// gradient across its gap, v_x + V_xx d_n, and runs the Riccati stage with
// quu_reg (exact DDP curvature when kDdp; the box-QP gains within var's
// bounds with kBox, the stage weight with kW: fddp.py :464-476); the gains go
// to the gains scratch. Never inlined: both FDDP kernels compile it alike.
template <typename T, bool kDdp, bool kBox, bool kW, class M>
__device__ __noinline__ T team_fddp_reverse(Team<T, M> tm, Problem<T> P, T quu_reg, Traj<T> src,
                                            bool merge, Traj<T> live, bool stale, T* gains, T* d,
                                            T gap, VariantOps<T> var) {
  const Problem<T> Ps = smem_problem(P, tm);
  const Tile tile = team_tile();
  TeamState<T, M>& S = *tm.s;
  if (stale) gap = T(0);
  team_zero_value(tm);
  T q1[4], t1[3], v1[6];  // stage n + 1, from the step before
  const RingSrc<T> ring{src, nullptr, stale ? nullptr : d, kW ? var.w : nullptr, var.s_w};
  ring_sweep(tm, P, ring, true, [&](int n, const T* slot) {
    if (merge) team_merge_stage(tm, live, P.B, n, slot);
    T q[4], t[3], v[6], u[M::kNu], dk[12];
    read_stage<M>(slot + Slot<M>::kLive, q, t, v, u);
    if (stale) {
      if (n < P.N - 1) {
        T qn[4], tn[3], vn[6];
#pragma unroll
        for (int j = 0; j < 4; ++j) qn[j] = q[j];
#pragma unroll
        for (int j = 0; j < 3; ++j) tn[j] = t[j];
#pragma unroll
        for (int j = 0; j < 6; ++j) vn[j] = v[j];
        dynamics_step<M>(Ps, 0, qn, tn, vn, u);
        state_minus(qn, tn, vn, q1, t1, v1, dk);
#pragma unroll
        for (int j = 0; j < 12; ++j) gap = nan_max(gap, f_abs(dk[j]));
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) dk[j] = T(0);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) S.dk[j] = dk[j];
      tile.sync();
      team_put_row(tm, S.dk, scratch_row(d, P.B, n, tm.b, 12), 12);
    } else {
#pragma unroll
      for (int j = 0; j < 12; ++j) dk[j] = slot[Slot<M>::kD + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) q1[j] = q[j];
#pragma unroll
    for (int j = 0; j < 3; ++j) t1[j] = t[j];
#pragma unroll
    for (int j = 0; j < 6; ++j) v1[j] = v[j];
    // first-order value transport across the gap
    team_each<12>(tm.lane, [&](int r) {
      T acc = S.vxx[r * 12] * dk[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) acc += S.vxx[r * 12 + j] * dk[j];
      S.v_x[r] = S.v_x[r] + acc;
    });
    tile.sync();
    T qutk, ktquuk;
    team_riccati_stage<T, kDdp, kBox, kW>(tm, Ps, quu_reg, slot, &qutk, &ktquuk, var);
    team_put_row(tm, S.gains, scratch_row(gains, P.B, n, tm.b, M::kGainsPitch),
                 M::kGainsPitch);
    return true;
  });
  return gap;
}

// What one gap-contracting sweep leaves: its cost fold, the quadratic
// model's terms (probe 0) and the stages it ran.
template <typename T>
struct GapSweep {
  T c, l1, l2;
  int stages;
};

// One gap-contracting sweep of the team's scenario from the live trajectory
// x at step alpha (fddp.py's gap-contracting rollout): per stage the
// control from the carry, the stage cost summed raw or (with `sat`) with the
// frozen-saturating fold, the stage written into `out` when `store` (out may
// be x), then the carry stepped to f(x_n, u_n) (+) (-(1 - alpha) d_n). With
// `model` it also carries probe 0's exact quadratic model at the live stages
// (fddp.py mstage, p <- J_x p + J_u w + d_n). With `sat` it stops where
// the fold freezes: nothing later can change it. kBox clamps each control
// into var's [lo, hi] (fddp.py :515); kW weights each stage cost and the
// model's terms by the stage's weight (:370, :569-572). Never inlined, and
// the flags are runtime values: the probes and an apply sweep run the same
// instructions.
template <typename T, bool kDdp, bool kBox, bool kW, class M>
__device__ __noinline__ GapSweep<T> team_gap_sweep(Team<T, M> tm, Problem<T> P, Traj<T> x,
                                                   Traj<T> out, const T* gains, const T* d,
                                                   T alpha, bool model, bool sat, T gdj, T current,
                                                   T cap, bool store, VariantOps<T> var) {
  const Problem<T> Ps = smem_problem(P, tm);
  GapSweep<T> o{T(0), T(0), T(0), 0};
  T q[4], t[3], v[6], p[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) p[j] = T(0);
  const RingSrc<T> ring{x, gains, d, kW ? var.w : nullptr, var.s_w};
  ring_sweep(tm, P, ring, false, [&](int n, const T* slot) {
    if (sat && (o.c - current) > gdj) return false;  // frozen
    T qo[4], to[3], vo[6], uo[M::kNu], dx[12];
    read_stage<M>(slot + Slot<M>::kLive, qo, to, vo, uo);
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = qo[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = to[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = vo[i];
    }
    // model terms at the live stage (not the rollout carry)
    T p2[12];
    if (model) team_model_stage<T, kDdp, kW>(tm, Ps, slot, p, p2, &o.l1, &o.l2);
    StageVals<T, M> sv;
    state_minus(q, t, v, qo, to, vo, dx);
    const T* g = slot + Slot<M>::kGains;
#pragma unroll
    for (int a = 0; a < M::kNu; ++a) {
      T fb = g[M::kNu + a * 12] * dx[0];
#pragma unroll
      for (int j = 1; j < 12; ++j) fb += g[M::kNu + a * 12 + j] * dx[j];
      sv.u[a] = (uo[a] + alpha * g[a]) + fb;
      if constexpr (kBox) {
        sv.u[a] = clip(sv.u[a], var.bound(var.lo, a, P.B, tm.b), var.bound(var.hi, a, P.B, tm.b));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sv.q[i] = q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sv.t[i] = t[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) sv.v[i] = v[i];
    const T cs = weigh<kW>(slot[Slot<M>::kW], team_fddp_stage_cost(tm.cc, slot + Slot<M>::kDes, sv));
    if (sat) {
      const bool frozen = (o.c - current) > gdj;
      T c2 = o.c + cs;
      c2 = (c2 <= cap) ? c2 : cap;
      o.c = frozen ? o.c : c2;
    } else {
      o.c = o.c + cs;
    }
    if (store) team_store_stage(tm, out, P.B, n, q, t, v, sv.u);
    dynamics_step<M>(Ps, 0, q, t, v, sv.u);
    T tau[12], qe[4], te[3], qn[4], tn[3];
    const T shrink = -(T(1) - alpha);
#pragma unroll
    for (int i = 0; i < 12; ++i) tau[i] = shrink * slot[Slot<M>::kD + i];
    se3_exp(tau, qe, te);
    se3_multiply(q, t, qe, te, qn, tn);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = tn[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) v[i] = v[i] + tau[6 + i];
    if (model) {
#pragma unroll
      for (int j = 0; j < 12; ++j) p[j] = p2[j] + slot[Slot<M>::kD + j];
    }
    ++o.stages;
    return true;
  });
  return o;
}

// The FDDP seed: the team's trajectory cost, stage costs summed from 0 up
// (fddp.py cseed), each weighted with kW.
template <typename T, bool kW, class M>
__device__ __forceinline__ T team_fddp_cost(const Team<T, M>& tm, const Problem<T>& P,
                                            const Traj<T>& x, const VariantOps<T>& var) {
  T cost = T(0);
  const RingSrc<T> ring{x, nullptr, nullptr, kW ? var.w : nullptr, var.s_w};
  ring_sweep(tm, P, ring, false, [&](int n, const T* slot) {
    StageVals<T, M> sv;
    read_stage<M>(slot + Slot<M>::kLive, sv.q, sv.t, sv.v, sv.u);
    cost = cost + weigh<kW>(slot[Slot<M>::kW],
                            team_fddp_stage_cost(tm.cc, slot + Slot<M>::kDes, sv));
    return true;
  });
  return cost;
}

// The Goldstein line search from the live trajectory x
// (fddp.py _goldstein_probe_commit): probe 0 at alpha = 1 also carries the
// exact quadratic model dJ(alpha) = alpha L1 + alpha^2 L2 and sums its cost
// raw; probes 1.. fold with the frozen-saturating add and stop at the
// freeze. A probe is accepted when its cost change is within the Goldstein
// band and finite; a rejection backtracks by ls_step, or by ls_jump when the
// probe exploded. With `store` each probe writes its candidate into `out`
// (an accepted probe always runs the whole horizon: a frozen fold rejects);
// otherwise the probes sum costs only. With no probes the search rejects.
// The probes are team_gap_sweep's (kBox, kW) instantiation. Never inlined:
// both FDDP kernels compile it alike.
template <typename T, bool kDdp, bool kBox, bool kW, class M>
__device__ __noinline__ LineSearch<T> team_fddp_line_search(Team<T, M> tm, Problem<T> P,
                                                            FddpKnobs<T> k, Traj<T> x,
                                                            Traj<T> out, bool store,
                                                            const T* gains, const T* d,
                                                            T current, VariantOps<T> var) {
  LineSearch<T> ls{false, current, T(1), 0};
  T alpha = T(1), l1 = T(0), l2 = T(0);
  if (k.ls_max_iters >= 1) {
    const GapSweep<T> o = team_gap_sweep<T, kDdp, kBox, kW>(
        tm, P, x, out, gains, d, alpha, true, false, T(0), current, T(0), store, var);
    l1 = o.l1;
    l2 = o.l2;
    const T c = o.c;
    ls.stages += P.N;
    const T dj = alpha * l1 + alpha * alpha * l2;
    const T gdj = ((dj <= T(0)) ? k.gf : k.gub) * dj;
    ls.cost = c;
    ls.accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
    const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
    if (!ls.accepted) alpha = (c < cap) ? alpha * k.ls_step : alpha * k.ls_jump;
  }
  for (int j = 1; j < k.ls_max_iters && !ls.accepted; ++j) {
    const T dj = alpha * l1 + alpha * alpha * l2;
    const T gdj = ((dj <= T(0)) ? k.gf : k.gub) * dj;
    const T cap = T(2) * (f_abs(current + gdj) + f_abs(current)) + T(1);
    const GapSweep<T> o = team_gap_sweep<T, kDdp, kBox, kW>(
        tm, P, x, out, gains, d, alpha, false, true, gdj, current, cap, store, var);
    const T c = o.c;
    ls.stages += o.stages;
    ls.cost = c;
    ls.accepted = (c - current) <= gdj && f_abs(c) < T(INFINITY);
    if (!ls.accepted) alpha = (c < cap) ? alpha * k.ls_step : alpha * k.ls_jump;
  }
  ls.alpha = alpha;
  return ls;
}

// The FDDP trip close (fddp.py _fddp_trip_close): the cost commit on an
// accept, the mu schedule keyed on the accepted alpha, LINE_SEARCH_FAILED (2)
// on a rejection at reg_max, CONVERGED (1) on an accepted step from an
// iterate whose gap was already below gap_tol. Returns whether the lane is
// done.
template <typename T>
__device__ __forceinline__ bool fddp_trip_close(const FddpKnobs<T>& k, const LineSearch<T>& ls,
                                                T current, T gap, T* cost, T* mu, int* status) {
  if (ls.accepted) *cost = ls.cost;
  const T m = *mu;
  const bool headroom = m < k.reg_max;
  const bool terminal = !ls.accepted && !headroom;
  T mu_dec = m * k.reg_down;
  if (mu_dec < k.reg_min) mu_dec = T(0);
  T mu_inc = m * k.reg_up;
  mu_inc = (m == T(0)) ? k.reg_init : ((mu_inc > k.reg_max) ? k.reg_max : mu_inc);
  const T mu_accept = (ls.alpha >= k.a_dec) ? mu_dec : ((ls.alpha <= k.a_inc) ? mu_inc : m);
  *mu = ls.accepted ? mu_accept : (headroom ? mu_inc : m);
  const bool post_conv =
      ls.accepted && gap < k.gap_tol && converged(current, ls.cost, k.rtol, k.atol);
  *status = terminal ? 2 : (post_conv ? 1 : *status);
  return post_conv || terminal;
}

}  // namespace team
}  // namespace qilqr
