// The team stage pieces of every kernel (backward.cu, rollout.cu, solve.cu,
// fddp.cu, stream.cu, stream_fddp.cu): one scenario served by a team of
// kTeamLanes lanes of one warp. team_trip.cuh builds their sweeps and line
// searches from these pieces.
//
// Counterpart of the stage bodies of quadrotorilqr_tpu/kernels/solve.py,
// fddp.py, stream.py and stream_fddp.py; the streamed TPU kernels stream
// `chunk` stages at a time through VMEM ahead of compute. Here:
//   * the per-scenario Riccati state (V_xx, Q_xx, X = V_xx j_x, the j_x
//     blocks, k|K, V_xx j_u, the gain system's pieces) lives in shared
//     memory (TeamState), not on a thread's stack;
//   * Q, R, j_u and the model parameters are loaded into shared memory once
//     per launch: per block when their B-stride is 0, per team when it is 1;
//   * the 12x12 and 12x4 products are split over the team by output
//     entries, never by their inner sums: each lane computes whole entries,
//     each sum in one fixed order, whatever the team size. The dot
//     products that feed a branch or a cost fold (dx'Q dx, p'c_xx p) are
//     gathered with shuffles and folded in their original order;
//   * the serial pieces (SE(3) log and exp, the dynamics step, the j_x
//     blocks, the 4x4 Cholesky solve, the line-search and trip logic) run
//     in every lane of the team on identical inputs, through the per-thread
//     code of quadrotor.cuh, so every branch is team-uniform;
//   * stage operands (the live or candidate stage, k|K, the defects, the
//     desired stage) are prefetched with cp.async into a ring of kRing slots
//     in shared memory, kRing - 1 stages ahead of the stage being computed:
//     the counterpart of the TPU kernels' `chunk` window.
//
// Layout of the kernel-private scratch: k|K as (N, B, 52) (k first, then K
// row-major) and the defects as (N, B, 12), so that a team's row is one
// contiguous run of 16-byte chunks; the candidate trajectory of the
// whole-solve kernels is (N, d, B), as the live one. Every global element a
// sweep stores and a later sweep reads back is stored and read by the same
// lane (element e of a stage, or 16-byte chunk e of a row, by lane
// e % kTeamLanes).
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <stddef.h>

#include "quadrotor.cuh"

// Lanes per scenario: each kernel's source defines QILQR_TEAM_LANES before it
// includes this header, chosen for that kernel by measurement on the H100
// (PERF.md section 6). The team pieces of each size live in an inline
// namespace of their own (team4, team8, ...), so that kernels of different
// team sizes link into one library.
#ifndef QILQR_TEAM_LANES
#error "define QILQR_TEAM_LANES (lanes per scenario) before including team.cuh"
#endif
#define QILQR_TEAM_NS_(g) team##g
#define QILQR_TEAM_NS(g) QILQR_TEAM_NS_(g)

namespace qilqr {
inline namespace QILQR_TEAM_NS(QILQR_TEAM_LANES) {

namespace cg = cooperative_groups;

constexpr int kTeamLanes = QILQR_TEAM_LANES;
static_assert(kTeamLanes == 4 || kTeamLanes == 8 || kTeamLanes == 16,
              "a team is 4, 8 or 16 lanes of one warp");
constexpr int kTeamThreads = 32;  // one warp a block
constexpr int kTeamsPerBlock = kTeamThreads / kTeamLanes;
// ring slots: the stage being computed and kRing - 1 stages in flight
constexpr int kRing = 4;
// a slot: k|K, the defects, the live stage (q t v u), the desired stage
constexpr int kSlotGains = 0, kSlotD = 52, kSlotLive = 64, kSlotDes = 81, kSlot = 100;
constexpr int kStage = 17;  // q(4) t(3) v(6) u(4)

using Tile = cg::thread_block_tile<kTeamLanes>;

__device__ __forceinline__ Tile team_tile() {
  return cg::tiled_partition<kTeamLanes>(cg::this_thread_block());
}

template <typename T>
struct alignas(16) CostConsts {
  T Q[144];
  T R[16];
};

template <typename T>
struct alignas(16) ParConsts {
  T g, minv;
  T ju[48];  // (12, 4) discrete control Jacobian
  T ima[12];
  T inertia[9], inertia_inv[9];
};

// One scenario's shared-memory state.
template <typename T>
struct alignas(16) TeamState {
  alignas(16) T ring[kRing][kSlot];
  alignas(16) T gains[52];  // this stage's k | K
  alignas(16) T dk[16];     // this stage's defect (12 used)
  T vxx[144], qxx[144], X[144];
  JxBlocks<T> J;
  T W[36], qdx[12], c_x[12], q_x[12], v_x[12], quu[16];
  T vxx_ju[48], q_xu[48], quuK[48];
  T tj[36], m1[36], m2[36], gy[9];  // exact-DDP curvature scratch
};

// Shared-memory bytes of one block: the B-stride-0 operand groups once, then
// each team's state and its B-stride-1 groups.
template <typename T>
inline size_t team_block_bytes(int s_qr, int s_par) {
  const size_t blk = (s_qr ? 0 : sizeof(CostConsts<T>)) + (s_par ? 0 : sizeof(ParConsts<T>));
  const size_t team = sizeof(TeamState<T>) + (s_qr ? sizeof(CostConsts<T>) : 0) +
                      (s_par ? sizeof(ParConsts<T>) : 0);
  return blk + kTeamsPerBlock * team;
}

// What a team carries: its lane, its scenario and its shared memory.
template <typename T>
struct Team {
  int lane, b;
  TeamState<T>* s;
  const CostConsts<T>* cc;
  const ParConsts<T>* pc;
};

template <typename T>
__device__ __forceinline__ void load_cost_consts(const Problem<T>& P, CostConsts<T>* cc, int b,
                                                 int i0, int step) {
  for (int e = i0; e < 160; e += step) {
    if (e < 144) {
      cc->Q[e] = P.q(e, b);
    } else {
      cc->R[e - 144] = P.r(e - 144, b);
    }
  }
}

template <typename T>
__device__ __forceinline__ void load_par_consts(const Problem<T>& P, ParConsts<T>* pc, int b,
                                                int i0, int step) {
  for (int e = i0; e < 80; e += step) {
    T* dst;
    const T* src;
    int k;
    if (e == 0) {
      dst = &pc->g, src = P.g, k = 0;
    } else if (e == 1) {
      dst = &pc->minv, src = P.minv, k = 0;
    } else if (e < 50) {
      dst = pc->ju + (e - 2), src = P.ju, k = e - 2;
    } else if (e < 62) {
      dst = pc->ima + (e - 50), src = P.iinv_ma, k = e - 50;
    } else if (e < 71) {
      dst = pc->inertia + (e - 62), src = P.inertia, k = e - 62;
    } else {
      dst = pc->inertia_inv + (e - 71), src = P.inertia_inv, k = e - 71;
    }
    *dst = P.par(src, k, b);
  }
}

// Carves the block's shared memory, loads the operand groups (every thread
// of the block takes part, so this comes before any team leaves) and
// returns whether this thread's team has a scenario: a team beyond B exits
// whole.
template <typename T>
__device__ __forceinline__ bool team_setup(const Problem<T>& P, Team<T>* tm) {
  extern __shared__ __align__(16) unsigned char qilqr_smem[];
  cg::thread_block block = cg::this_thread_block();
  const Tile tile = team_tile();
  const int t = static_cast<int>(tile.meta_group_rank());
  unsigned char* p = qilqr_smem;
  CostConsts<T>* bcc = nullptr;
  ParConsts<T>* bpc = nullptr;
  if (!P.s_qr) {
    bcc = reinterpret_cast<CostConsts<T>*>(p);
    p += sizeof(CostConsts<T>);
  }
  if (!P.s_par) {
    bpc = reinterpret_cast<ParConsts<T>*>(p);
    p += sizeof(ParConsts<T>);
  }
  const size_t team_bytes = sizeof(TeamState<T>) + (P.s_qr ? sizeof(CostConsts<T>) : 0) +
                            (P.s_par ? sizeof(ParConsts<T>) : 0);
  p += t * team_bytes;
  tm->lane = static_cast<int>(tile.thread_rank());
  tm->b = blockIdx.x * kTeamsPerBlock + t;
  tm->s = reinterpret_cast<TeamState<T>*>(p);
  p += sizeof(TeamState<T>);
  CostConsts<T>* cc = bcc;
  if (P.s_qr) {
    cc = reinterpret_cast<CostConsts<T>*>(p);
    p += sizeof(CostConsts<T>);
  }
  ParConsts<T>* pc = P.s_par ? reinterpret_cast<ParConsts<T>*>(p) : bpc;
  tm->cc = cc;
  tm->pc = pc;
  const int tid = static_cast<int>(threadIdx.x);
  if (bcc != nullptr) load_cost_consts(P, bcc, 0, tid, kTeamThreads);
  if (bpc != nullptr) load_par_consts(P, bpc, 0, tid, kTeamThreads);
  const bool mine = tm->b < P.B;
  if (mine && P.s_qr) load_cost_consts(P, cc, tm->b, tm->lane, kTeamLanes);
  if (mine && P.s_par) load_par_consts(P, pc, tm->b, tm->lane, kTeamLanes);
  block.sync();
  return mine;
}

// The problem as the per-thread code reads it, with Q, R and the model
// parameters in shared memory (B-stride 0). The desired trajectory is read
// from the ring instead.
template <typename T>
__device__ __forceinline__ Problem<T> smem_problem(const Problem<T>& P, const Team<T>& tm) {
  Problem<T> S = P;
  S.Q = tm.cc->Q;
  S.R = tm.cc->R;
  S.g = &tm.pc->g;
  S.minv = &tm.pc->minv;
  S.ju = tm.pc->ju;
  S.iinv_ma = tm.pc->ima;
  S.inertia = tm.pc->inertia;
  S.inertia_inv = tm.pc->inertia_inv;
  S.s_qr = 0;
  S.s_par = 0;
  return S;
}

// ---- stage elements and the operand ring ----

// element e of stage n of a (N, d, B) trajectory: q (0-3), t (4-6), v (7-12), u (13-16)
template <typename T>
__device__ __forceinline__ T* traj_elem(const Traj<T>& x, int B, int n, int e, int b) {
  if (e < 4) return x.q + (n * 4 + e) * B + b;
  if (e < 7) return x.t + (n * 3 + e - 4) * B + b;
  if (e < 13) return x.v + (n * 6 + e - 7) * B + b;
  return x.u + (n * 4 + e - 13) * B + b;
}

template <typename T>
__device__ __forceinline__ const T* des_elem(const Problem<T>& P, int n, int e, int b) {
  const int s = P.s_des;
  const int stride = s ? P.B : 1;
  if (e < 4) return P.dq + (n * 4 + e) * stride + b * s;
  if (e < 7) return P.dtr + (n * 3 + e - 4) * stride + b * s;
  if (e < 13) return P.dv + (n * 6 + e - 7) * stride + b * s;
  return P.du + (n * 4 + e - 13) * stride + b * s;
}

template <typename T>
__device__ __forceinline__ void read_stage(const T* s, T* q, T* t, T* v, T* u) {
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = s[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = s[4 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = s[7 + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = s[13 + i];
}

// stage n of x <- (q, t, v, u), element e by lane e % kTeamLanes
template <typename T>
__device__ __forceinline__ void team_store_stage(const Team<T>& tm, const Traj<T>& x, int B,
                                                 int n, const T* q, const T* t, const T* v,
                                                 const T* u) {
  T vals[kStage];
#pragma unroll
  for (int i = 0; i < 4; ++i) vals[i] = q[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) vals[4 + i] = t[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) vals[7 + i] = v[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) vals[13 + i] = u[i];
#pragma unroll
  for (int e = 0; e < kStage; ++e) {
    if (e % kTeamLanes == tm.lane) *traj_elem(x, B, n, e, tm.b) = vals[e];
  }
}

template <typename T>
__device__ __forceinline__ void team_copy_traj(const Team<T>& tm, const Problem<T>& P,
                                               const Traj<T>& src, const Traj<T>& dst) {
  for (int n = 0; n < P.N; ++n) {
    for (int e = tm.lane; e < kStage; e += kTeamLanes) {
      *traj_elem(dst, P.B, n, e, tm.b) = *traj_elem(src, P.B, n, e, tm.b);
    }
  }
}

// stage n of x <- the trajectory stage a sweep fetched into `slot` (the
// merge of a candidate into the live trajectory), element e by lane
// e % kTeamLanes, the lane that fetched it
template <typename T>
__device__ __forceinline__ void team_merge_stage(const Team<T>& tm, const Traj<T>& x, int B, int n,
                                                 const T* slot) {
  for (int e = tm.lane; e < kStage; e += kTeamLanes) {
    *traj_elem(x, B, n, e, tm.b) = slot[kSlotLive + e];
  }
}

// values of T in one 16-byte chunk
template <typename T>
constexpr int kChunk = 16 / static_cast<int>(sizeof(T));

// row (n, b) of a (N, B, W) scratch buffer
template <typename T>
__device__ __forceinline__ T* scratch_row(T* base, int B, int n, int b, int width) {
  return base + (static_cast<size_t>(n) * B + b) * width;
}

// a row of `width` values from shared to global memory, chunk c by lane c % kTeamLanes
template <typename T>
__device__ __forceinline__ void team_put_row(const Team<T>& tm, const T* src, T* dst, int width) {
  for (int c = tm.lane; c < width / kChunk<T>; c += kTeamLanes) {
    *reinterpret_cast<uint4*>(dst + c * kChunk<T>) =
        *reinterpret_cast<const uint4*>(src + c * kChunk<T>);
  }
}

// Which operands a sweep fetches into the ring (a trajectory's stage and the
// desired stage always).
template <typename T>
struct RingSrc {
  Traj<T> x;       // the live trajectory, or the candidate a sweep merges
  const T* gains;  // (N, B, 52) k|K, or null
  const T* d;      // (N, B, 12) defects, or null
};

// Issues the copies of stage n's operands into `slot`: element e of the
// trajectory's and the desired stage by lane e % kTeamLanes, 16-byte chunks
// of the gains and defect rows likewise.
template <typename T>
__device__ __forceinline__ void ring_fetch(const Team<T>& tm, const Problem<T>& P,
                                           const RingSrc<T>& src, int n, T* slot) {
  const int B = P.B, b = tm.b;
  for (int e = tm.lane; e < 2 * kStage; e += kTeamLanes) {
    const T* g = e < kStage ? traj_elem(src.x, B, n, e, b) : des_elem(P, n, e - kStage, b);
    __pipeline_memcpy_async(slot + kSlotLive + e, g, sizeof(T));
  }
  if (src.gains != nullptr) {
    const T* row = src.gains + (static_cast<size_t>(n) * B + b) * 52;
    for (int c = tm.lane; c < 52 / kChunk<T>; c += kTeamLanes) {
      __pipeline_memcpy_async(slot + kSlotGains + c * kChunk<T>, row + c * kChunk<T>, 16);
    }
  }
  if (src.d != nullptr) {
    const T* row = src.d + (static_cast<size_t>(n) * B + b) * 12;
    for (int c = tm.lane; c < 12 / kChunk<T>; c += kTeamLanes) {
      __pipeline_memcpy_async(slot + kSlotD + c * kChunk<T>, row + c * kChunk<T>, 16);
    }
  }
}

// Waits for every copy in flight and for every lane's earlier stores.
__device__ __forceinline__ void ring_drain() {
  __pipeline_wait_prior(0);
  __threadfence_block();
  team_tile().sync();
}

// A sweep over the N stages, forward or in reverse, through the ring: the
// operands of the next kRing - 1 stages are in flight while body(n, slot)
// computes stage n. A body that returns false ends the sweep there.
template <typename T, class Body>
__device__ __forceinline__ void ring_sweep(const Team<T>& tm, const Problem<T>& P,
                                           const RingSrc<T>& src, bool reverse, Body&& body) {
  const int N = P.N;
  const Tile tile = team_tile();
  ring_drain();
  for (int j = 0; j < kRing - 1; ++j) {
    if (j < N) ring_fetch(tm, P, src, reverse ? N - 1 - j : j, tm.s->ring[j]);
    __pipeline_commit();
  }
  for (int i = 0; i < N; ++i) {
    const int ahead = i + kRing - 1;
    if (ahead < N) ring_fetch(tm, P, src, reverse ? N - 1 - ahead : ahead, tm.s->ring[ahead % kRing]);
    __pipeline_commit();
    __pipeline_wait_prior(kRing - 1);
    tile.sync();
    const bool go = body(reverse ? N - 1 - i : i, tm.s->ring[i % kRing]);
    tile.sync();
    if (!go) break;
  }
}

// ---- how a team splits an output over its lanes ----

// f(e) for e = lane, lane + kTeamLanes, ... < kCount: a fixed trip count,
// unrolled
template <int kCount, class F>
__device__ __forceinline__ void team_each(int lane, F&& f) {
#pragma unroll
  for (int j = 0; j < (kCount + kTeamLanes - 1) / kTeamLanes; ++j) {
    const int e = lane + j * kTeamLanes;
    if (kCount % kTeamLanes == 0 || e < kCount) f(e);
  }
}

// f(r, c) over a 12 x 12 output, column by column: c is the same in every
// lane (a compile-time constant once unrolled, so a branch on it folds) and
// the rows are split over the team
template <class F>
__device__ __forceinline__ void team_each_col(int lane, F&& f) {
#pragma unroll
  for (int c = 0; c < 12; ++c) team_each<12>(lane, [&](int r) { f(r, c); });
}

// f(r, c) over a 12 x 12 output, row by row: r the same in every lane, the
// columns split over the team
template <class F>
__device__ __forceinline__ void team_each_row(int lane, F&& f) {
#pragma unroll
  for (int r = 0; r < 12; ++r) team_each<12>(lane, [&](int c) { f(r, c); });
}

// ---- products split over the team by output entries ----

// entry (r, c) of j_x^T X for a 12 x C X (backward.py _jxt_mat), the
// nonzero blocks only
template <int C, typename T>
__device__ __forceinline__ T jxt_entry(const JxBlocks<T>& J, const T* X, int r, int c) {
  T val;
  if (r < 6) {
    val = J.P[r] * X[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) val += J.P[k * 6 + r] * X[k * C + c];
    if (r >= 3) {
      T gp = J.G[r - 3] * X[6 * C + c];
#pragma unroll
      for (int k = 1; k < 3; ++k) gp += J.G[k * 3 + r - 3] * X[(6 + k) * C + c];
      val = val + gp;
    }
  } else {
    val = J.Tm[r - 6] * X[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) val += J.Tm[k * 6 + r - 6] * X[k * C + c];
    if (r < 9) {
      val = val + X[r * C + c];
    } else {
      T mp = J.M[r - 9] * X[9 * C + c];
#pragma unroll
      for (int k = 1; k < 3; ++k) mp += J.M[k * 3 + r - 9] * X[(9 + k) * C + c];
      val = val + mp;
    }
  }
  return val;
}

// entry (r, c) of X j_x for a 12 x 12 X (backward.py _mat_jx), the nonzero
// blocks only
template <typename T>
__device__ __forceinline__ T matjx_entry(const JxBlocks<T>& J, const T* X, int r, int c) {
  const T* x = X + r * 12;
  T val;
  if (c < 6) {
    val = x[0] * J.P[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) val += x[k] * J.P[k * 6 + c];
    if (c >= 3) {
      T gp = x[6] * J.G[c - 3];
#pragma unroll
      for (int k = 1; k < 3; ++k) gp += x[6 + k] * J.G[k * 3 + c - 3];
      val = val + gp;
    }
  } else {
    val = x[0] * J.Tm[c - 6];
#pragma unroll
    for (int k = 1; k < 6; ++k) val += x[k] * J.Tm[k * 6 + c - 6];
    if (c < 9) {
      val = val + x[c];
    } else {
      T mp = x[9] * J.M[c - 9];
#pragma unroll
      for (int k = 1; k < 3; ++k) mp += x[9 + k] * J.M[k * 3 + c - 9];
      val = val + mp;
    }
  }
  return val;
}

// x' (A x) for a row-major 12 x 12 A in shared memory: the rows of A x split
// over the team, then gathered with shuffles and folded in order (dot<12>)
// in every lane
template <typename T>
__device__ __forceinline__ T team_quad12(const Tile& tile, int lane, const T* A, const T* x) {
  constexpr int kRows = (12 + kTeamLanes - 1) / kTeamLanes;
  T mine[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = lane + j * kTeamLanes;
    T acc = T(0);
    if (r < 12) {
      acc = A[r * 12] * x[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) acc += A[r * 12 + k] * x[k];
    }
    mine[j] = acc;
  }
  T dot = T(0);
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const T ar = tile.shfl(mine[r / kTeamLanes], r % kTeamLanes);
    if (r == 0) {
      dot = x[0] * ar;
    } else {
      dot += x[r] * ar;
    }
  }
  return dot;
}

// ---- the stage cost ----

// (dx'Q dx, du'R du) of (q, t, v, u) against the desired stage `des`
// (rollout.py's stage cost, with Q dx split over the team)
template <typename T>
__device__ __forceinline__ void team_cost_terms(const Tile& tile, int lane,
                                                const CostConsts<T>* cc, const T* des, const T* q,
                                                const T* t, const T* v, const T* u, T* xq, T* ur) {
  T dq[4], dtr[3], dv[6], du[4], dx[12];
  read_stage(des, dq, dtr, dv, du);
  state_minus(q, t, v, dq, dtr, dv, dx);
  *xq = team_quad12(tile, lane, cc->Q, dx);
  T e[4], rdu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = u[i] - du[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = cc->R[r * 4] * e[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc += cc->R[r * 4 + k] * e[k];
    rdu[r] = acc;
  }
  *ur = dot<4>(e, rdu);
}

template <typename T>
struct StageVals {
  T q[4], t[3], v[6], u[4];
};

// dx'Q dx + du'R du of one stage: never inlined, so the FDDP seed sweep and
// every probe evaluate it with the same instructions (fddp.py stage_cost)
template <typename T>
__device__ __noinline__ T team_fddp_stage_cost(const CostConsts<T>* cc, const T* des,
                                               StageVals<T> x) {
  const Tile tile = team_tile();
  T xq, ur;
  team_cost_terms(tile, static_cast<int>(tile.thread_rank()), cc, des, x.q, x.t, x.v, x.u, &xq,
                  &ur);
  return xq + ur;
}

// ---- the Riccati stage ----

// The stage's j_x blocks into shared memory: computed in every lane's
// registers (stage_jx_blocks scales its Tm in place), then stored by all
// lanes alike.
template <typename T>
__device__ __forceinline__ void team_jx_blocks(const Problem<T>& Ps, const T* q, const T* v,
                                               JxBlocks<T>* out) {
  JxBlocks<T> J;
  stage_jx_blocks(Ps, 0, q, v, J);
  *out = J;
}

// The exact c_xx pose-block correction (backward.py _cxx_corr_lanes) into
// S.qxx, from dx, S.W and z = S.qdx[0:6].
template <typename T>
__device__ __forceinline__ void team_cxx_correction(const Team<T>& tm, const Tile& tile,
                                                    const T* dx) {
  TeamState<T>& S = *tm.s;
  T wt[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = S.W[i] * S.qdx[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += S.W[k * 6 + i] * S.qdx[k];
    wt[i] = acc;
  }
  {
    T tj[36];
    se3_right_jacobian_t_jac(dx, wt, tj);
#pragma unroll
    for (int i = 0; i < 36; ++i) S.tj[i] = tj[i];
  }
  tile.sync();
  // Th W with Th = tj^T, into m1
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T acc = S.tj[r] * S.W[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += S.tj[k * 6 + r] * S.W[k * 6 + c];
    S.m1[e] = acc;
  });
  tile.sync();
  // W^T (Th W), into m2
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T acc = S.W[r] * S.m1[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += S.W[k * 6 + r] * S.m1[k * 6 + c];
    S.m2[e] = acc;
  });
  tile.sync();
  {
    T cw[36];
    ad_cot(wt, cw);
#pragma unroll
    for (int i = 0; i < 36; ++i) S.m1[i] = cw[i];
  }
  tile.sync();
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    const T sym_c = T(0.5) * (S.m1[r * 6 + c] + S.m1[c * 6 + r]);
    const T sym_i = T(0.5) * (S.m2[r * 6 + c] + S.m2[c * 6 + r]);
    S.qxx[r * 12 + c] = S.qxx[r * 12 + c] + -(sym_c + T(2) * sym_i);
  });
  tile.sync();
}

// Tracking-cost differentials of the stage in `slot` (backward.py
// _stage_cost_diffs): S.c_x, c_xx into S.qxx (S.X is scratch for Q J_d),
// c_u into registers.
template <typename T, bool kExact>
__device__ __forceinline__ void team_cost_diffs(const Team<T>& tm, const Tile& tile,
                                                const T* slot, const T* q, const T* t,
                                                const T* v, const T* u, T* c_u) {
  TeamState<T>& S = *tm.s;
  const T* Q = tm.cc->Q;
  const T* R = tm.cc->R;
  T dq[4], dtr[3], dv[6], dud[4], dx[12];
  read_stage(slot + kSlotDes, dq, dtr, dv, dud);
  state_minus(q, t, v, dq, dtr, dv, dx);
  {
    T W[36];
    se3_right_jacobian_inv(dx, W);
#pragma unroll
    for (int i = 0; i < 36; ++i) S.W[i] = W[i];
  }
  team_each<12>(tm.lane, [&](int r) {
    T acc = Q[r * 12] * dx[0];
#pragma unroll
    for (int k = 1; k < 12; ++k) acc += Q[r * 12 + k] * dx[k];
    S.qdx[r] = acc;
  });
  tile.sync();
  team_each<12>(tm.lane, [&](int r) {
    if (r < 6) {
      T acc = S.W[r] * S.qdx[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc += S.W[k * 6 + r] * S.qdx[k];
      S.c_x[r] = T(2) * acc;
    } else {
      S.c_x[r] = T(2) * S.qdx[r];
    }
  });
  // qjd = [Q[:, 0:6] W, Q[:, 6:12]] into X
  team_each_col(tm.lane, [&](int r, int c) {
    if (c < 6) {
      T acc = Q[r * 12] * S.W[c];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc += Q[r * 12 + k] * S.W[k * 6 + c];
      S.X[r * 12 + c] = acc;
    } else {
      S.X[r * 12 + c] = Q[r * 12 + c];
    }
  });
  tile.sync();
  // c_xx = [2 W^T qjd[0:6]; 2 qjd[6:12]] into qxx
  team_each_row(tm.lane, [&](int r, int c) {
    if (r < 6) {
      T acc = S.W[r] * S.X[c];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc += S.W[k * 6 + r] * S.X[k * 12 + c];
      S.qxx[r * 12 + c] = T(2) * acc;
    } else {
      S.qxx[r * 12 + c] = T(2) * S.X[r * 12 + c];
    }
  });
  tile.sync();
  if constexpr (kExact) team_cxx_correction(tm, tile, dx);
  T e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = u[i] - dud[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = (T(2) * R[r * 4]) * e[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc += (T(2) * R[r * 4 + k]) * e[k];
    c_u[r] = acc;
  }
}

// sum_i (v_x)_i f_xx[i] into S.qxx (backward.py _vfxx_lanes), from S.v_x
// and S.J
template <typename T>
__device__ __forceinline__ void team_add_vfxx(const Team<T>& tm, const Tile& tile,
                                              const Problem<T>& Ps, const T* q, const T* vel) {
  TeamState<T>& S = *tm.s;
  const JxBlocks<T>& J = S.J;
  const T dt = Ps.dt;
  T vx[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) vx[i] = S.v_x[i];
  {
    T cw[36];
    ad_cot(vx, cw);
#pragma unroll
    for (int i = 0; i < 36; ++i) S.m1[i] = cw[i];
  }
  tile.sync();
  // ct = C(w_p) Tm into m2
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T acc = S.m1[r * 6] * J.Tm[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += S.m1[r * 6 + k] * J.Tm[k * 6 + c];
    S.m2[e] = acc;
  });
  tile.sync();
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T acc = J.P[r] * S.m2[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += J.P[k * 6 + r] * S.m2[k * 6 + c];
    const T g_ps = T(0.5) * acc;
    S.qxx[r * 12 + 6 + c] = S.qxx[r * 12 + 6 + c] + g_ps;
    S.qxx[(6 + c) * 12 + r] = S.qxx[(6 + c) * 12 + r] + g_ps;
  });
  {
    T tau[6], tj[36];
#pragma unroll
    for (int i = 0; i < 6; ++i) tau[i] = dt * vel[i];
    se3_right_jacobian_t_jac(tau, vx, tj);
#pragma unroll
    for (int i = 0; i < 36; ++i) S.tj[i] = tj[i];
    // the gyroscopic block's hat(y) I - I hat(y), y = I^-1 v_x[9:12]
    T y[3], vx_w[3], hy[9], hy_i[9], i_hy[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) vx_w[i] = vx[9 + i];
    matvec<3, 3>(Ps.inertia_inv, vx_w, y);
    hat(y, hy);
    matmul<3, 3, 3>(hy, Ps.inertia, hy_i);
    matmul<3, 3, 3>(Ps.inertia, hy, i_hy);
#pragma unroll
    for (int i = 0; i < 9; ++i) S.gy[i] = hy_i[i] - i_hy[i];
  }
  tile.sync();
  const T dt2 = dt * dt;
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T acc = J.Tm[r] * S.m2[c];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += J.Tm[k * 6 + r] * S.m2[k * 6 + c];
    S.m1[e] = T(0.5) * acc + dt2 * S.tj[c * 6 + r];
  });
  tile.sync();
  team_each<36>(tm.lane, [&](int e) {
    const int r = e / 6, c = e % 6;
    T g_ss = T(0.5) * (S.m1[r * 6 + c] + S.m1[c * 6 + r]);
    if (r >= 3 && c >= 3) g_ss = g_ss + dt * S.gy[(r - 3) * 3 + c - 3];
    S.qxx[(6 + r) * 12 + 6 + c] = S.qxx[(6 + r) * 12 + 6 + c] + g_ss;
  });
  // gravity block: each entry by one lane
  const T ez[3] = {T(0), T(0), T(1)};
  T qc[4], r_t_ez[3];
  quat_conjugate(q, qc);
  quat_rotate(qc, ez, r_t_ez);
  const T* w_lin = vx + 6;
  const T wr = w_lin[0] * r_t_ez[0] + w_lin[1] * r_t_ez[1] + w_lin[2] * r_t_ez[2];
  const T gscale = ((T(-0.5) * dt) * Ps.g[0]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if ((r * 3 + c) % kTeamLanes == tm.lane) {
        const T g_grav = gscale * (w_lin[r] * r_t_ez[c] + r_t_ez[r] * w_lin[c] -
                                   T(2) * wr * ((r == c) ? T(1) : T(0)));
        S.qxx[(3 + r) * 12 + 3 + c] = S.qxx[(3 + r) * 12 + 3 + c] + g_grav;
      }
    }
  }
  tile.sync();
}

// One reverse Riccati stage (backward.py _riccati_stage, the exact path:
// j_u contracted over its nonzero rows 8:12 only, the 4x4 Cholesky gains
// plus quu_reg * I, the symmetrized value update) of the live stage in `slot`
// against S.v_x, S.vxx, which it updates; k|K into S.gains, and the stage's
// Qu.k and k.Quu.k. Ps is the problem with its constants in shared memory.
template <typename T, bool kDdp>
__device__ __forceinline__ void team_riccati_stage(const Team<T>& tm, const Problem<T>& Ps,
                                                   T quu_reg, const T* slot, T* qutk_inc,
                                                   T* ktquuk_inc) {
  TeamState<T>& S = *tm.s;
  const Tile tile = team_tile();
  const int lane = tm.lane;
  T q[4], t[3], v[6], u[4];
  read_stage(slot + kSlotLive, q, t, v, u);
  team_jx_blocks(Ps, q, v, &S.J);
  T c_u[4];
  team_cost_diffs<T, kDdp>(tm, tile, slot, q, t, v, u, c_u);

  // --- Q-expansion ---
  const T* ju = tm.pc->ju + 32;  // j_u rows 8:12
  team_each<12>(lane, [&](int r) { S.q_x[r] = S.c_x[r] + jxt_entry<1>(S.J, S.v_x, r, 0); });
  T q_u[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    T acc = ju[a] * S.v_x[8];
#pragma unroll
    for (int r = 1; r < 4; ++r) acc += ju[r * 4 + a] * S.v_x[8 + r];
    q_u[a] = c_u[a] + acc;
  }
  team_each_col(lane, [&](int r, int c) { S.X[r * 12 + c] = matjx_entry(S.J, S.vxx, r, c); });
  tile.sync();
  team_each_row(lane, [&](int r, int c) {
    S.qxx[r * 12 + c] = S.qxx[r * 12 + c] + jxt_entry<12>(S.J, S.X, r, c);
  });
  // V_xx[:, 8:12] ju_lo (12 x 4)
  team_each<48>(lane, [&](int e) {
    const int r = e / 4, c = e % 4;
    T acc = S.vxx[r * 12 + 8] * ju[c];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc += S.vxx[r * 12 + 8 + k] * ju[k * 4 + c];
    S.vxx_ju[e] = acc;
  });
  tile.sync();
  if constexpr (kDdp) team_add_vfxx(tm, tile, Ps, q, v);
  T q_uu[16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      T acc = ju[a] * S.vxx_ju[32 + c];
#pragma unroll
      for (int r = 1; r < 4; ++r) acc += ju[r * 4 + a] * S.vxx_ju[(8 + r) * 4 + c];
      q_uu[a * 4 + c] =
          (T(2) * tm.cc->R[a * 4 + c] + acc) + quu_reg * ((a == c) ? T(1) : T(0));
    }
  }
  team_each<48>(lane, [&](int e) { S.q_xu[e] = jxt_entry<4>(S.J, S.vxx_ju, e / 4, e % 4); });
#pragma unroll
  for (int i = 0; i < 16; ++i) S.quu[i] = q_uu[i];
  tile.sync();

  // --- gains: [k | K] = -Quu^-1 [Qu | Qxu^T], solved in every lane ---
  T k[4];
  {
    T rhs[52], sol[52];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rhs[a * 13] = q_u[a];
#pragma unroll
      for (int c = 0; c < 12; ++c) rhs[a * 13 + 1 + c] = S.q_xu[c * 4 + a];
    }
    chol_solve<4, 13>(q_uu, rhs, sol);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      k[a] = -sol[a * 13];
      S.gains[a] = k[a];
#pragma unroll
      for (int c = 0; c < 12; ++c) S.gains[4 + a * 12 + c] = -sol[a * 13 + 1 + c];
    }
  }
  T quu_k[4];
  matvec<4, 4>(q_uu, k, quu_k);
  tile.sync();

  // --- value update ---
  const T* K = S.gains + 4;
  team_each<12>(lane, [&](int r) {
    T acc = K[r] * quu_k[0];
#pragma unroll
    for (int a = 1; a < 4; ++a) acc += K[a * 12 + r] * quu_k[a];
    S.v_x[r] = S.q_x[r] - acc;
  });
  team_each<48>(lane, [&](int e) {
    const int a = e / 12, c = e % 12;
    T acc = S.quu[a * 4] * K[c];
#pragma unroll
    for (int j = 1; j < 4; ++j) acc += S.quu[a * 4 + j] * K[j * 12 + c];
    S.quuK[e] = acc;
  });
  tile.sync();
  team_each_row(lane, [&](int r, int c) {
    T acc = K[r] * S.quuK[c];
#pragma unroll
    for (int a = 1; a < 4; ++a) acc += K[a * 12 + r] * S.quuK[a * 12 + c];
    S.qxx[r * 12 + c] = S.qxx[r * 12 + c] - acc;
  });
  tile.sync();
  // per-stage symmetrization 0.5 (S + S^T)
  team_each_row(lane, [&](int r, int c) {
    S.vxx[r * 12 + c] = T(0.5) * (S.qxx[r * 12 + c] + S.qxx[c * 12 + r]);
  });
  tile.sync();
  *qutk_inc = dot<4>(q_u, k);
  *ktquuk_inc = dot<4>(k, quu_k);
}

// V_x = 0, V_xx = 0 before a reverse sweep
template <typename T>
__device__ __forceinline__ void team_zero_value(const Team<T>& tm) {
  team_each<144>(tm.lane, [&](int e) { tm.s->vxx[e] = T(0); });
  team_each<12>(tm.lane, [&](int e) { tm.s->v_x[e] = T(0); });
  team_tile().sync();
}

// The exact quadratic model's terms at the live stage in `slot`
// (fddp.py mstage): w = k + K p, L1 += c_x'p + c_u'w, L2 += (p'c_xx p +
// w'2R w) / 2, and p2 = J_x p + J_u w.
template <typename T, bool kDdp>
__device__ __forceinline__ void team_model_stage(const Team<T>& tm, const Problem<T>& Ps,
                                                 const T* slot, const T* p, T* p2, T* l1, T* l2) {
  TeamState<T>& S = *tm.s;
  const Tile tile = team_tile();
  T lq[4], lt[3], lv[6], lu[4], c_u[4];
  read_stage(slot + kSlotLive, lq, lt, lv, lu);
  team_jx_blocks(Ps, lq, lv, &S.J);
  team_cost_diffs<T, kDdp>(tm, tile, slot, lq, lt, lv, lu, c_u);
  const T* g = slot + kSlotGains;
  T wv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    T acc = g[4 + a * 12] * p[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc += g[4 + a * 12 + j] * p[j];
    wv[a] = g[a] + acc;
  }
  T c_x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) c_x[i] = S.c_x[i];
  *l1 = *l1 + dot<12>(c_x, p) + dot<4>(c_u, wv);
  const T pcp = team_quad12(tile, tm.lane, S.qxx, p);
  T r2w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = (T(2) * tm.cc->R[r * 4]) * wv[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) acc += (T(2) * tm.cc->R[r * 4 + j]) * wv[j];
    r2w[r] = acc;
  }
  *l2 = *l2 + T(0.5) * (pcp + dot<4>(wv, r2w));
  jx_vec(S.J, p, p2);
  const T* ju = tm.pc->ju + 32;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T acc = ju[r * 4] * wv[0];
#pragma unroll
    for (int a = 1; a < 4; ++a) acc += ju[r * 4 + a] * wv[a];
    p2[8 + r] = p2[8 + r] + acc;
  }
}

// The launch: B scenarios, kTeamsPerBlock a block of one warp, the shared
// memory of team_block_bytes (above 48 KB only once the kernel allows it).
template <typename Kernel, typename... Args>
inline int team_launch(Kernel kernel, int batch, size_t smem, void* stream, Args... args) {
  if (batch == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (batch + kTeamsPerBlock - 1) / kTeamsPerBlock;
  kernel<<<blocks, kTeamThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry of this team size: out = (lanes per scenario, teams per
// block, threads per block, shared bytes per block, ring slots, shared bytes
// of one team's state) for float64 (f64 != 0) or float32 and the operand
// groups' B-strides.
inline int team_info(int f64, int s_qr, int s_par, long long* out) {
  out[0] = kTeamLanes;
  out[1] = kTeamsPerBlock;
  out[2] = kTeamThreads;
  out[3] = static_cast<long long>(f64 ? team_block_bytes<double>(s_qr, s_par)
                                      : team_block_bytes<float>(s_qr, s_par));
  out[4] = kRing;
  out[5] = static_cast<long long>(f64 ? sizeof(TeamState<double>) : sizeof(TeamState<float>));
  return 0;
}

}  // namespace team
}  // namespace qilqr
