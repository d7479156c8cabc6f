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
//   * the 12x12 and 12xu products are split over the team by output
//     entries, never by their inner sums: each lane computes whole entries,
//     each sum in one fixed order, whatever the team size. The dot
//     products that feed a branch or a cost fold (dx'Q dx, p'c_xx p) are
//     gathered with shuffles and folded in their original order;
//   * the serial pieces (SE(3) log and exp, the dynamics step, the j_x
//     blocks, the u x u Cholesky solve, the line-search and trip logic) run
//     in every lane of the team on identical inputs, through the per-thread
//     code of quadrotor.cuh, so every branch is team-uniform;
//   * stage operands (the live or candidate stage, k|K, the defects, the
//     desired stage) are prefetched with cp.async into a ring of kRing slots
//     in shared memory, kRing - 1 stages ahead of the stage being computed:
//     the counterpart of the TPU kernels' `chunk` window.
//
// Every piece is generic over the model family M (quadrotor.cuh: the control
// width M::kNu, the j_u rows M::kJuLo:12 the contractions run over, the
// dynamics step), carried by the team's type Team<T, M>.
//
// Layout of the kernel-private scratch: k|K as (N, B, P) (k first, then K
// row-major, padded to P = M::kGainsPitch values: 52 for the quadrotor) and
// the defects as (N, B, 12), so that a team's row is one contiguous run of
// 16-byte chunks; the candidate trajectory of the whole-solve kernels is
// (N, d, B), as the live one. Every global element a sweep stores and a
// later sweep reads back is stored and read by the same lane (element e of a
// stage, or 16-byte chunk e of a row, by lane e % kTeamLanes).
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <stddef.h>

#include <type_traits>

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
// A ring slot of family M: k|K (its padded row), the defects, the live stage
// (q t v u), the desired stage, the stage weight (weights variant), in whole
// 16-byte chunks. The quadrotor's: 0, 52, 64, 81, 98, 100 values.
template <class M>
struct Slot {
  static constexpr int kGains = 0, kD = M::kGainsPitch, kLive = kD + 12,
                       kDes = kLive + M::kStage, kW = kDes + M::kStage,
                       kSize = (kW + 1 + 3) / 4 * 4;
};
// projected-Newton iterations of the box-QP gain solve (box variant;
// solver/constrained.py _PN_ITERS)
constexpr int kPnIters = 4;

using Tile = cg::thread_block_tile<kTeamLanes>;

__device__ __forceinline__ Tile team_tile() {
  return cg::tiled_partition<kTeamLanes>(cg::this_thread_block());
}

template <typename T, class M>
struct alignas(16) CostConsts {
  T Q[144];
  T R[M::kNu * M::kNu];
};

template <typename T, class M>
struct alignas(16) ParConsts {
  T g, minv;
  T ju[12 * M::kNu];  // (12, u) discrete control Jacobian
  T ima[3 * M::kNu];  // I^-1 MA (unused by the wrench)
  T inertia[9], inertia_inv[9];
};

// One scenario's shared-memory state.
template <typename T, class M>
struct alignas(16) TeamState {
  alignas(16) T ring[kRing][Slot<M>::kSize];
  alignas(16) T gains[M::kGainsPitch];  // this stage's k | K
  alignas(16) T dk[16];                 // this stage's defect (12 used)
  T vxx[144], qxx[144], X[144];
  JxBlocks<T> J;
  T W[36], qdx[12], c_x[12], q_x[12], v_x[12], quu[M::kNu * M::kNu];
  T vxx_ju[12 * M::kNu], q_xu[12 * M::kNu], quuK[12 * M::kNu];
  T tj[36], m1[36], m2[36], gy[9];  // exact-DDP curvature scratch
};

// Shared-memory bytes of one block: the B-stride-0 operand groups once, then
// each team's state and its B-stride-1 groups.
template <typename T, class M>
inline size_t team_block_bytes(int s_qr, int s_par) {
  const size_t cc = sizeof(CostConsts<T, M>), pc = sizeof(ParConsts<T, M>);
  const size_t blk = (s_qr ? 0 : cc) + (s_par ? 0 : pc);
  const size_t team = sizeof(TeamState<T, M>) + (s_qr ? cc : 0) + (s_par ? pc : 0);
  return blk + kTeamsPerBlock * team;
}

// The FDDP sources (fddp.cu, stream_fddp.cu) are compiled once per box and
// weights variant (kernels/_build.py VARIANTS): QILQR_BOX and QILQR_WEIGHTS
// pick the object's instantiations, QILQR_VARIANT names its C entries
// (QILQR_VENTRY: qilqr_fddp_f32, qilqr_fddp_box_f32, ...). Without them the
// object is the one without either variant.
#ifndef QILQR_VARIANT
#define QILQR_VARIANT
#define QILQR_BOX 0
#define QILQR_WEIGHTS 0
#endif
#define QILQR_VENTRY__(kernel, variant, suffix) qilqr_##kernel##variant##_##suffix
#define QILQR_VENTRY_(kernel, variant, suffix) QILQR_VENTRY__(kernel, variant, suffix)
#define QILQR_VENTRY(kernel, suffix) QILQR_VENTRY_(kernel, QILQR_VARIANT, suffix)

// The operands of the box and weights variants (backward.py
// _backward_kernel's use_box / use_weights, rollout.py's, solve.py's): the
// control bounds lo, hi (4, B or 1) and the stage weights w (N, B or 1),
// each null when its variant is off, with their B-strides. A kernel picks
// the instantiation (kBox, kW) from which are set; the instantiation without
// either never reads them.
template <typename T>
struct VariantOps {
  const T* lo = nullptr;
  const T* hi = nullptr;
  const T* w = nullptr;
  int s_box = 0, s_w = 0;

  // bound a (of lo or hi) of scenario b
  __device__ __forceinline__ T bound(const T* p, int a, int B, int b) const {
    return p[a * (s_box ? B : 1) + b * s_box];
  }
};

// a * b rounded on its own: never contracted with a following add into a
// fused multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// x scaled by the stage weight w in the weights variant, x itself otherwise.
// The product is rounded on its own (mul_rn): whether nvcc fuses a weighted
// product with the add after it depends on the code around an inlined piece,
// and the kernels that inline these pieces (solve.cu, stream.cu, the
// per-pass kernels) must compute the same bits.
template <bool kW, typename T>
__device__ __forceinline__ T weigh(T w, T x) {
  if constexpr (kW) {
    return mul_rn(w, x);
  } else {
    return x;
  }
}

// What a team carries: its lane, its scenario and its shared memory, for
// model family M.
template <typename T, class M>
struct Team {
  int lane, b;
  TeamState<T, M>* s;
  const CostConsts<T, M>* cc;
  const ParConsts<T, M>* pc;
};

template <typename T, class M>
__device__ __forceinline__ void load_cost_consts(const Problem<T>& P, CostConsts<T, M>* cc, int b,
                                                 int i0, int step) {
  for (int e = i0; e < 144 + M::kNu * M::kNu; e += step) {
    if (e < 144) {
      cc->Q[e] = P.q(e, b);
    } else {
      cc->R[e - 144] = P.r(e - 144, b);
    }
  }
}

// g, minv, j_u, I^-1 MA (not for the wrench, whose pointer is null), I,
// I^-1 as one run of elements
template <typename T, class M>
__device__ __forceinline__ void load_par_consts(const Problem<T>& P, ParConsts<T, M>* pc, int b,
                                                int i0, int step) {
  constexpr int kJu = 2, kIma = kJu + 12 * M::kNu, kI = kIma + (M::kWrench ? 0 : 3 * M::kNu),
                kIinv = kI + 9, kEnd = kIinv + 9;
  for (int e = i0; e < kEnd; e += step) {
    T* dst;
    const T* src;
    int k;
    if (e == 0) {
      dst = &pc->g, src = P.g, k = 0;
    } else if (e == 1) {
      dst = &pc->minv, src = P.minv, k = 0;
    } else if (e < kIma) {
      dst = pc->ju + (e - kJu), src = P.ju, k = e - kJu;
    } else if (e < kI) {
      dst = pc->ima + (e - kIma), src = P.iinv_ma, k = e - kIma;
    } else if (e < kIinv) {
      dst = pc->inertia + (e - kI), src = P.inertia, k = e - kI;
    } else {
      dst = pc->inertia_inv + (e - kIinv), src = P.inertia_inv, k = e - kIinv;
    }
    *dst = P.par(src, k, b);
  }
}

// Carves the block's shared memory, loads the operand groups (every thread
// of the block takes part, so this comes before any team leaves) and
// returns whether this thread's team has a scenario: a team beyond B exits
// whole.
template <typename T, class M>
__device__ __forceinline__ bool team_setup(const Problem<T>& P, Team<T, M>* tm) {
  using CC = CostConsts<T, M>;
  using PC = ParConsts<T, M>;
  extern __shared__ __align__(16) unsigned char qilqr_smem[];
  cg::thread_block block = cg::this_thread_block();
  const Tile tile = team_tile();
  const int t = static_cast<int>(tile.meta_group_rank());
  unsigned char* p = qilqr_smem;
  CC* bcc = nullptr;
  PC* bpc = nullptr;
  if (!P.s_qr) {
    bcc = reinterpret_cast<CC*>(p);
    p += sizeof(CC);
  }
  if (!P.s_par) {
    bpc = reinterpret_cast<PC*>(p);
    p += sizeof(PC);
  }
  const size_t team_bytes =
      sizeof(TeamState<T, M>) + (P.s_qr ? sizeof(CC) : 0) + (P.s_par ? sizeof(PC) : 0);
  p += t * team_bytes;
  tm->lane = static_cast<int>(tile.thread_rank());
  tm->b = blockIdx.x * kTeamsPerBlock + t;
  tm->s = reinterpret_cast<TeamState<T, M>*>(p);
  p += sizeof(TeamState<T, M>);
  CC* cc = bcc;
  if (P.s_qr) {
    cc = reinterpret_cast<CC*>(p);
    p += sizeof(CC);
  }
  PC* pc = P.s_par ? reinterpret_cast<PC*>(p) : bpc;
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
template <typename T, class M>
__device__ __forceinline__ Problem<T> smem_problem(const Problem<T>& P, const Team<T, M>& tm) {
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

// element e of stage n of a (N, d, B) trajectory of family M: q (0-3),
// t (4-6), v (7-12), u (13 to 12 + u)
template <class M, typename T>
__device__ __forceinline__ T* traj_elem(const Traj<T>& x, int B, int n, int e, int b) {
  if (e < 4) return x.q + (n * 4 + e) * B + b;
  if (e < 7) return x.t + (n * 3 + e - 4) * B + b;
  if (e < 13) return x.v + (n * 6 + e - 7) * B + b;
  return x.u + (n * M::kNu + e - 13) * B + b;
}

template <class M, typename T>
__device__ __forceinline__ const T* des_elem(const Problem<T>& P, int n, int e, int b) {
  const int s = P.s_des;
  const int stride = s ? P.B : 1;
  if (e < 4) return P.dq + (n * 4 + e) * stride + b * s;
  if (e < 7) return P.dtr + (n * 3 + e - 4) * stride + b * s;
  if (e < 13) return P.dv + (n * 6 + e - 7) * stride + b * s;
  return P.du + (n * M::kNu + e - 13) * stride + b * s;
}

template <class M, typename T>
__device__ __forceinline__ void read_stage(const T* s, T* q, T* t, T* v, T* u) {
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = s[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = s[4 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = s[7 + i];
#pragma unroll
  for (int i = 0; i < M::kNu; ++i) u[i] = s[13 + i];
}

// stage n of x <- (q, t, v, u), element e by lane e % kTeamLanes
template <typename T, class M>
__device__ __forceinline__ void team_store_stage(const Team<T, M>& tm, const Traj<T>& x, int B,
                                                 int n, const T* q, const T* t, const T* v,
                                                 const T* u) {
  T vals[M::kStage];
#pragma unroll
  for (int i = 0; i < 4; ++i) vals[i] = q[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) vals[4 + i] = t[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) vals[7 + i] = v[i];
#pragma unroll
  for (int i = 0; i < M::kNu; ++i) vals[13 + i] = u[i];
#pragma unroll
  for (int e = 0; e < M::kStage; ++e) {
    if (e % kTeamLanes == tm.lane) *traj_elem<M>(x, B, n, e, tm.b) = vals[e];
  }
}

template <typename T, class M>
__device__ __forceinline__ void team_copy_traj(const Team<T, M>& tm, const Problem<T>& P,
                                               const Traj<T>& src, const Traj<T>& dst) {
  for (int n = 0; n < P.N; ++n) {
    for (int e = tm.lane; e < M::kStage; e += kTeamLanes) {
      *traj_elem<M>(dst, P.B, n, e, tm.b) = *traj_elem<M>(src, P.B, n, e, tm.b);
    }
  }
}

// stage n of x <- the trajectory stage a sweep fetched into `slot` (the
// merge of a candidate into the live trajectory), element e by lane
// e % kTeamLanes, the lane that fetched it
template <typename T, class M>
__device__ __forceinline__ void team_merge_stage(const Team<T, M>& tm, const Traj<T>& x, int B,
                                                 int n, const T* slot) {
  for (int e = tm.lane; e < M::kStage; e += kTeamLanes) {
    *traj_elem<M>(x, B, n, e, tm.b) = slot[Slot<M>::kLive + e];
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
template <typename T, class M>
__device__ __forceinline__ void team_put_row(const Team<T, M>& tm, const T* src, T* dst,
                                             int width) {
  for (int c = tm.lane; c < width / kChunk<T>; c += kTeamLanes) {
    *reinterpret_cast<uint4*>(dst + c * kChunk<T>) =
        *reinterpret_cast<const uint4*>(src + c * kChunk<T>);
  }
}

// Which operands a sweep fetches into the ring (a trajectory's stage and the
// desired stage always).
template <typename T>
struct RingSrc {
  Traj<T> x;              // the live trajectory, or the candidate a sweep merges
  const T* gains;         // (N, B, P) k|K, or null
  const T* d;             // (N, B, 12) defects, or null
  const T* w = nullptr;   // (N, B or 1) stage weights, or null
  int s_w = 0;            // their B-stride
};

// Issues the copies of stage n's operands into `slot`: element e of the
// trajectory's and the desired stage by lane e % kTeamLanes, 16-byte chunks
// of the gains and defect rows likewise.
template <typename T, class M>
__device__ __forceinline__ void ring_fetch(const Team<T, M>& tm, const Problem<T>& P,
                                           const RingSrc<T>& src, int n, T* slot) {
  using S = Slot<M>;
  constexpr int kStage = M::kStage, kPitch = M::kGainsPitch;
  const int B = P.B, b = tm.b;
  for (int e = tm.lane; e < 2 * kStage; e += kTeamLanes) {
    const T* g =
        e < kStage ? traj_elem<M>(src.x, B, n, e, b) : des_elem<M>(P, n, e - kStage, b);
    __pipeline_memcpy_async(slot + S::kLive + e, g, sizeof(T));
  }
  if (src.gains != nullptr) {
    const T* row = src.gains + (static_cast<size_t>(n) * B + b) * kPitch;
    for (int c = tm.lane; c < kPitch / kChunk<T>; c += kTeamLanes) {
      __pipeline_memcpy_async(slot + S::kGains + c * kChunk<T>, row + c * kChunk<T>, 16);
    }
  }
  if (src.d != nullptr) {
    const T* row = src.d + (static_cast<size_t>(n) * B + b) * 12;
    for (int c = tm.lane; c < 12 / kChunk<T>; c += kTeamLanes) {
      __pipeline_memcpy_async(slot + S::kD + c * kChunk<T>, row + c * kChunk<T>, 16);
    }
  }
  // the stage weight rides with the desired stage, as element 2 kStage
  if (src.w != nullptr && tm.lane == (2 * kStage) % kTeamLanes) {
    __pipeline_memcpy_async(slot + S::kW, src.w + n * (src.s_w ? B : 1) + b * src.s_w,
                            sizeof(T));
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
template <typename T, class M, class Body>
__device__ __forceinline__ void ring_sweep(const Team<T, M>& tm, const Problem<T>& P,
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
template <typename T, class M>
__device__ __forceinline__ void team_cost_terms(const Tile& tile, int lane,
                                                const CostConsts<T, M>* cc, const T* des,
                                                const T* q, const T* t, const T* v, const T* u,
                                                T* xq, T* ur) {
  constexpr int NU = M::kNu;
  T dq[4], dtr[3], dv[6], du[NU], dx[12];
  read_stage<M>(des, dq, dtr, dv, du);
  state_minus(q, t, v, dq, dtr, dv, dx);
  *xq = team_quad12(tile, lane, cc->Q, dx);
  T e[NU], rdu[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) e[i] = u[i] - du[i];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    T acc = cc->R[r * NU] * e[0];
#pragma unroll
    for (int k = 1; k < NU; ++k) acc += cc->R[r * NU + k] * e[k];
    rdu[r] = acc;
  }
  *ur = dot<NU>(e, rdu);
}

template <typename T, class M>
struct StageVals {
  T q[4], t[3], v[6], u[M::kNu];
};

// dx'Q dx + du'R du of one stage: never inlined, so the FDDP seed sweep and
// every probe evaluate it with the same instructions (fddp.py stage_cost)
template <typename T, class M>
__device__ __noinline__ T team_fddp_stage_cost(const CostConsts<T, M>* cc, const T* des,
                                               StageVals<T, M> x) {
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
template <typename T, class M>
__device__ __forceinline__ void team_cxx_correction(const Team<T, M>& tm, const Tile& tile,
                                                    const T* dx) {
  TeamState<T, M>& S = *tm.s;
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
// c_u into registers. With kW each is scaled by the stage weight w (c_u
// through w 2R, backward.py _riccati_stage's order); the exact c_xx
// (kExact) is scaled once its Lie correction is in (solver/ddp.py
// exact_cxx_analytic's order), the Gauss-Newton one entry by entry.
template <typename T, bool kExact, bool kW = false, class M>
__device__ __forceinline__ void team_cost_diffs(const Team<T, M>& tm, const Tile& tile,
                                                const T* slot, const T* q, const T* t,
                                                const T* v, const T* u, T* c_u, T w = T(1)) {
  constexpr bool kWeighGn = kW && !kExact;
  constexpr int NU = M::kNu;
  TeamState<T, M>& S = *tm.s;
  const T* Q = tm.cc->Q;
  const T* R = tm.cc->R;
  T dq[4], dtr[3], dv[6], dud[NU], dx[12];
  read_stage<M>(slot + Slot<M>::kDes, dq, dtr, dv, dud);
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
      S.c_x[r] = weigh<kW>(w, T(2) * acc);
    } else {
      S.c_x[r] = weigh<kW>(w, T(2) * S.qdx[r]);
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
      S.qxx[r * 12 + c] = weigh<kWeighGn>(w, T(2) * acc);
    } else {
      S.qxx[r * 12 + c] = weigh<kWeighGn>(w, T(2) * S.X[r * 12 + c]);
    }
  });
  tile.sync();
  if constexpr (kExact) team_cxx_correction(tm, tile, dx);
  if constexpr (kExact && kW) {
    team_each<144>(tm.lane, [&](int e) { S.qxx[e] = weigh<kW>(w, S.qxx[e]); });
    tile.sync();
  }
  T e[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) e[i] = u[i] - dud[i];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    T acc = weigh<kW>(w, T(2) * R[r * NU]) * e[0];
#pragma unroll
    for (int k = 1; k < NU; ++k) acc += weigh<kW>(w, T(2) * R[r * NU + k]) * e[k];
    c_u[r] = acc;
  }
}

// sum_i (v_x)_i f_xx[i] into S.qxx (backward.py _vfxx_lanes), from S.v_x
// and S.J
template <typename T, class M>
__device__ __forceinline__ void team_add_vfxx(const Team<T, M>& tm, const Tile& tile,
                                              const Problem<T>& Ps, const T* q, const T* vel) {
  TeamState<T, M>& S = *tm.s;
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

// clip(x, lo, hi) as jnp.clip / torch.clamp: a NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// The projected-Newton box-QP gains of one stage (backward.py
// _boxqp_gains_lanes, solver/constrained.py _boxqp_gains): minimize
// 1/2 d'Quu d + Qu'd over lo_d <= d <= hi_d, from the clipped Newton step,
// with kPnIters masked 4x4 Cholesky solves (Quu on the free block, the
// identity on the clamped one); then k = d and K = -A^-1 (the rows of Qux of
// the free controls) on the last free set, so the rows of clamped controls
// are zero. The solves multiply by each pivot's reciprocal (chol_solve_rcp).
// Per thread: every lane of a team runs it on the same inputs, as the
// unconstrained Cholesky. q_xu is (12, 4) row-major.
template <typename T>
__device__ __forceinline__ void boxqp_gains(const T* q_uu, const T* q_u, const T* q_xu,
                                            const T* lo_d, const T* hi_d, T* k, T* big_k) {
  const T eps = sizeof(T) == 8 ? T(1e-9) : T(1e-6);
  T delta[4], free[4];
  {
    T sol[4];
    chol_solve_rcp<4, 1>(q_uu, q_u, sol);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      delta[a] = clip(-sol[a], lo_d[a], hi_d[a]);
      free[a] = T(1);
    }
  }
#pragma unroll 1
  for (int it = 0; it < kPnIters; ++it) {
    T grad[4], held[4], dh[4], qd[4], a_m[16], rhs[4], step[4];
    matvec<4, 4>(q_uu, delta, qd);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      grad[a] = q_u[a] + qd[a];
      const bool clamped = (delta[a] <= lo_d[a] + eps && grad[a] > T(0)) ||
                           (delta[a] >= hi_d[a] - eps && grad[a] < T(0));
      free[a] = clamped ? T(0) : T(1);
      held[a] = clamped ? T(1) : T(0);
      dh[a] = delta[a] * held[a];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_m[i * 4 + j] = q_uu[i * 4 + j] * free[i] * free[j] + ((i == j) ? held[i] : T(0));
      }
    }
    matvec<4, 4>(q_uu, dh, qd);
#pragma unroll
    for (int a = 0; a < 4; ++a) rhs[a] = (q_u[a] + qd[a]) * free[a];
    chol_solve_rcp<4, 1>(a_m, rhs, step);
#pragma unroll
    for (int a = 0; a < 4; ++a) delta[a] = clip(-step[a] + dh[a], lo_d[a], hi_d[a]);
  }
  T a_m[16], rhs[48], sol[48];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_m[i * 4 + j] = q_uu[i * 4 + j] * free[i] * free[j] + ((i == j) ? T(1) - free[i] : T(0));
    }
#pragma unroll
    for (int c = 0; c < 12; ++c) rhs[i * 12 + c] = q_xu[c * 4 + i] * free[i];
  }
  chol_solve_rcp<4, 12>(a_m, rhs, sol);
#pragma unroll
  for (int a = 0; a < 4; ++a) k[a] = delta[a];
#pragma unroll
  for (int e = 0; e < 48; ++e) big_k[e] = -sol[e];
}

// One reverse Riccati stage (backward.py _riccati_stage, the exact path:
// j_u contracted over its nonzero rows M::kJuLo:12 only, the u x u Cholesky
// gains plus quu_reg * I, the symmetrized value update) of the live stage in
// `slot` against S.v_x, S.vxx, which it updates; k|K into S.gains, and the
// stage's Qu.k and k.Quu.k. Ps is the problem with its constants in shared
// memory. The variants (compile-time, the quadrotor's only; without them
// this is the exact path as it was): kW scales the stage's cost terms by its
// weight slot[kW] (c_x, c_xx, c_u and the 2R of Q_uu; not quu_reg); kBox
// solves the gains as the box-QP (boxqp_gains) within var's bounds less the
// stage's control, and updates the value with the general gains
// (backward.py :550-571).
template <typename T, bool kDdp, bool kBox = false, bool kW = false, class M>
__device__ __forceinline__ void team_riccati_stage(const Team<T, M>& tm, const Problem<T>& Ps,
                                                   T quu_reg, const T* slot, T* qutk_inc,
                                                   T* ktquuk_inc,
                                                   const VariantOps<T>& var = VariantOps<T>{}) {
  static_assert(!kBox || M::kNu == 4, "the box-QP gains are the quadrotor's (u = 4)");
  constexpr int NU = M::kNu, LO = M::kJuLo, NJ = 12 - M::kJuLo;
  TeamState<T, M>& S = *tm.s;
  const Tile tile = team_tile();
  const int lane = tm.lane;
  T q[4], t[3], v[6], u[NU];
  read_stage<M>(slot + Slot<M>::kLive, q, t, v, u);
  team_jx_blocks(Ps, q, v, &S.J);
  T c_u[NU];
  const T w = kW ? slot[Slot<M>::kW] : T(1);
  team_cost_diffs<T, kDdp, kW>(tm, tile, slot, q, t, v, u, c_u, w);

  // --- Q-expansion ---
  const T* ju = tm.pc->ju + LO * NU;  // j_u rows LO:12
  team_each<12>(lane, [&](int r) { S.q_x[r] = S.c_x[r] + jxt_entry<1>(S.J, S.v_x, r, 0); });
  T q_u[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T acc = ju[a] * S.v_x[LO];
#pragma unroll
    for (int r = 1; r < NJ; ++r) acc += ju[r * NU + a] * S.v_x[LO + r];
    q_u[a] = c_u[a] + acc;
  }
  team_each_col(lane, [&](int r, int c) { S.X[r * 12 + c] = matjx_entry(S.J, S.vxx, r, c); });
  tile.sync();
  team_each_row(lane, [&](int r, int c) {
    S.qxx[r * 12 + c] = S.qxx[r * 12 + c] + jxt_entry<12>(S.J, S.X, r, c);
  });
  // V_xx[:, LO:12] ju_lo (12 x u)
  team_each<12 * NU>(lane, [&](int e) {
    const int r = e / NU, c = e % NU;
    T acc = S.vxx[r * 12 + LO] * ju[c];
#pragma unroll
    for (int k = 1; k < NJ; ++k) acc += S.vxx[r * 12 + LO + k] * ju[k * NU + c];
    S.vxx_ju[e] = acc;
  });
  tile.sync();
  if constexpr (kDdp) team_add_vfxx(tm, tile, Ps, q, v);
  T q_uu[NU * NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      T acc = ju[a] * S.vxx_ju[LO * NU + c];
#pragma unroll
      for (int r = 1; r < NJ; ++r) acc += ju[r * NU + a] * S.vxx_ju[(LO + r) * NU + c];
      q_uu[a * NU + c] = (weigh<kW>(w, T(2) * tm.cc->R[a * NU + c]) + acc) +
                         quu_reg * ((a == c) ? T(1) : T(0));
    }
  }
  team_each<12 * NU>(lane, [&](int e) { S.q_xu[e] = jxt_entry<NU>(S.J, S.vxx_ju, e / NU, e % NU); });
#pragma unroll
  for (int i = 0; i < NU * NU; ++i) S.quu[i] = q_uu[i];
  tile.sync();

  // --- gains: [k | K] = -Quu^-1 [Qu | Qxu^T], solved in every lane ---
  T k[NU];
  if constexpr (kBox) {
    T lo_d[4], hi_d[4], big_k[48];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      lo_d[a] = var.bound(var.lo, a, Ps.B, tm.b) - u[a];
      hi_d[a] = var.bound(var.hi, a, Ps.B, tm.b) - u[a];
    }
    boxqp_gains(q_uu, q_u, S.q_xu, lo_d, hi_d, k, big_k);
#pragma unroll
    for (int a = 0; a < 4; ++a) S.gains[a] = k[a];
#pragma unroll
    for (int e = 0; e < 48; ++e) S.gains[4 + e] = big_k[e];
  } else {
    T rhs[NU * 13], sol[NU * 13];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      rhs[a * 13] = q_u[a];
#pragma unroll
      for (int c = 0; c < 12; ++c) rhs[a * 13 + 1 + c] = S.q_xu[c * NU + a];
    }
    chol_solve<NU, 13>(q_uu, rhs, sol);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      k[a] = -sol[a * 13];
      S.gains[a] = k[a];
#pragma unroll
      for (int c = 0; c < 12; ++c) S.gains[NU + a * 12 + c] = -sol[a * 13 + 1 + c];
    }
  }
  T quu_k[NU];
  matvec<NU, NU>(q_uu, k, quu_k);
  tile.sync();

  // --- value update ---
  const T* K = S.gains + NU;
  if constexpr (kBox) {
    // the general gains: v_x' = q_x + K'Quu k + K'q_u + Q_xu k
    team_each<12>(lane, [&](int r) {
      T a1 = K[r] * quu_k[0], a2 = K[r] * q_u[0], a3 = S.q_xu[r * 4] * k[0];
#pragma unroll
      for (int a = 1; a < 4; ++a) {
        a1 += K[a * 12 + r] * quu_k[a];
        a2 += K[a * 12 + r] * q_u[a];
        a3 += S.q_xu[r * 4 + a] * k[a];
      }
      S.v_x[r] = ((S.q_x[r] + a1) + a2) + a3;
    });
  } else {
    team_each<12>(lane, [&](int r) {
      T acc = K[r] * quu_k[0];
#pragma unroll
      for (int a = 1; a < NU; ++a) acc += K[a * 12 + r] * quu_k[a];
      S.v_x[r] = S.q_x[r] - acc;
    });
  }
  team_each<NU * 12>(lane, [&](int e) {
    const int a = e / 12, c = e % 12;
    T acc = S.quu[a * NU] * K[c];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc += S.quu[a * NU + j] * K[j * 12 + c];
    S.quuK[e] = acc;
  });
  tile.sync();
  if constexpr (kBox) {
    // S = Q_xx + Q_xu K + K'Q_ux + K'Quu K
    team_each_row(lane, [&](int r, int c) {
      T b1 = S.q_xu[r * 4] * K[c], b2 = K[r] * S.q_xu[c * 4], b3 = K[r] * S.quuK[c];
#pragma unroll
      for (int a = 1; a < 4; ++a) {
        b1 += S.q_xu[r * 4 + a] * K[a * 12 + c];
        b2 += K[a * 12 + r] * S.q_xu[c * 4 + a];
        b3 += K[a * 12 + r] * S.quuK[a * 12 + c];
      }
      S.qxx[r * 12 + c] = ((S.qxx[r * 12 + c] + b1) + b2) + b3;
    });
  } else {
    team_each_row(lane, [&](int r, int c) {
      T acc = K[r] * S.quuK[c];
#pragma unroll
      for (int a = 1; a < NU; ++a) acc += K[a * 12 + r] * S.quuK[a * 12 + c];
      S.qxx[r * 12 + c] = S.qxx[r * 12 + c] - acc;
    });
  }
  tile.sync();
  // per-stage symmetrization 0.5 (S + S^T)
  team_each_row(lane, [&](int r, int c) {
    S.vxx[r * 12 + c] = T(0.5) * (S.qxx[r * 12 + c] + S.qxx[c * 12 + r]);
  });
  tile.sync();
  *qutk_inc = dot<NU>(q_u, k);
  *ktquuk_inc = dot<NU>(k, quu_k);
}

// V_x = 0, V_xx = 0 before a reverse sweep
template <typename T, class M>
__device__ __forceinline__ void team_zero_value(const Team<T, M>& tm) {
  team_each<144>(tm.lane, [&](int e) { tm.s->vxx[e] = T(0); });
  team_each<12>(tm.lane, [&](int e) { tm.s->v_x[e] = T(0); });
  team_tile().sync();
}

// The exact quadratic model's terms at the live stage in `slot`
// (fddp.py mstage): w = k + K p, L1 += c_x'p + c_u'w, L2 += (p'c_xx p +
// w'2R w) / 2, and p2 = J_x p + J_u w. With kW the cost terms carry the
// stage weight slot[kW] (c_x, c_xx, and 2R as w 2R: fddp.py :569-572).
template <typename T, bool kDdp, bool kW, class M>
__device__ __forceinline__ void team_model_stage(const Team<T, M>& tm, const Problem<T>& Ps,
                                                 const T* slot, const T* p, T* p2, T* l1, T* l2) {
  constexpr int NU = M::kNu, LO = M::kJuLo;
  TeamState<T, M>& S = *tm.s;
  const Tile tile = team_tile();
  T lq[4], lt[3], lv[6], lu[NU], c_u[NU];
  read_stage<M>(slot + Slot<M>::kLive, lq, lt, lv, lu);
  team_jx_blocks(Ps, lq, lv, &S.J);
  const T sw = kW ? slot[Slot<M>::kW] : T(1);
  team_cost_diffs<T, kDdp, kW>(tm, tile, slot, lq, lt, lv, lu, c_u, sw);
  const T* g = slot + Slot<M>::kGains;
  T wv[NU];
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    T acc = g[NU + a * 12] * p[0];
#pragma unroll
    for (int j = 1; j < 12; ++j) acc += g[NU + a * 12 + j] * p[j];
    wv[a] = g[a] + acc;
  }
  T c_x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) c_x[i] = S.c_x[i];
  *l1 = *l1 + dot<12>(c_x, p) + dot<NU>(c_u, wv);
  const T pcp = team_quad12(tile, tm.lane, S.qxx, p);
  T r2w[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    T acc = weigh<kW>(sw, T(2) * tm.cc->R[r * NU]) * wv[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) acc += weigh<kW>(sw, T(2) * tm.cc->R[r * NU + j]) * wv[j];
    r2w[r] = acc;
  }
  *l2 = *l2 + T(0.5) * (pcp + dot<NU>(wv, r2w));
  jx_vec(S.J, p, p2);
  const T* ju = tm.pc->ju + LO * NU;
#pragma unroll
  for (int r = 0; r < 12 - LO; ++r) {
    T acc = ju[r * NU] * wv[0];
#pragma unroll
    for (int a = 1; a < NU; ++a) acc += ju[r * NU + a] * wv[a];
    p2[LO + r] = p2[LO + r] + acc;
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

// The variant operands packed after a kernel's own: ptrs lo hi w (each null
// when its variant is off), ints s_box s_w.
template <typename T>
inline VariantOps<T> variant_from(const void* const* p, const long long* ip) {
  VariantOps<T> v;
  v.lo = static_cast<const T*>(p[0]);
  v.hi = static_cast<const T*>(p[1]);
  v.w = static_cast<const T*>(p[2]);
  v.s_box = static_cast<int>(ip[0]);
  v.s_w = static_cast<int>(ip[1]);
  return v;
}

// launch(box, w) with std::true_type / std::false_type for the variant the
// operands ask for: the bounds set (kBox), the weights set (kW).
template <typename T, class Launch>
inline int with_variant(const VariantOps<T>& v, Launch&& launch) {
  if (v.lo != nullptr) {
    return v.w != nullptr ? launch(std::true_type{}, std::true_type{})
                          : launch(std::true_type{}, std::false_type{});
  }
  return v.w != nullptr ? launch(std::false_type{}, std::true_type{})
                        : launch(std::false_type{}, std::false_type{});
}

// The launch geometry of this team size and model family: out = (lanes per
// scenario, teams per block, threads per block, shared bytes per block, ring
// slots, shared bytes of one team's state) for float64 (f64 != 0) or float32
// and the operand groups' B-strides.
template <class M>
inline int team_info(int f64, int s_qr, int s_par, long long* out) {
  out[0] = kTeamLanes;
  out[1] = kTeamsPerBlock;
  out[2] = kTeamThreads;
  out[3] = static_cast<long long>(f64 ? team_block_bytes<double, M>(s_qr, s_par)
                                      : team_block_bytes<float, M>(s_qr, s_par));
  out[4] = kRing;
  out[5] = static_cast<long long>(f64 ? sizeof(TeamState<double, M>)
                                      : sizeof(TeamState<float, M>));
  return 0;
}

}  // namespace team
}  // namespace qilqr
