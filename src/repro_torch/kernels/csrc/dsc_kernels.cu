// Hand-written Hopper (sm_90a) kernels for the DSC main path.
//
// Each kernel replaces one Pallas TPU kernel of the JAX package and keeps
// its exact semantics; the plain PyTorch version beside each wrapper
// (repro_torch/kernels/<name>/ref.py) is the oracle it is held against.
//
//   stjoin_best_match  <- repro/kernels/stjoin/stjoin.py  stjoin_pallas
//   stjoin_vote_fused  <- repro/kernels/stjoin/stjoin.py  stjoin_vote_fused_flat
//   stjoin_sim_fused   <- repro/kernels/stjoin/stjoin.py  stjoin_sim_fused_flat
//   stjoin_sim_panel_fused
//                      <- repro/kernels/stjoin/stjoin.py  stjoin_sim_panel_fused_flat
//   jaccard_window     <- repro/kernels/jaccard/jaccard.py jaccard_pallas
//   round_scan         <- repro/kernels/cluster/cluster.py round_scan_pallas
//   claim_max          <- repro/kernels/cluster/cluster.py assign_pallas
//   topk_round_scan    <- repro/kernels/cluster/cluster.py topk_round_scan_pallas
//   topk_claim_max     <- repro/kernels/cluster/cluster.py topk_assign_pallas
//   stjoin_best_match_pruned
//                      <- repro/kernels/stjoin/stjoin.py  stjoin_pallas_pruned
//   stjoin_vote_fused_pruned
//                      <- repro/kernels/stjoin/stjoin.py  stjoin_vote_fused_pruned_flat
//   stjoin_sim_fused_pruned
//                      <- repro/kernels/stjoin/stjoin.py  stjoin_sim_fused_pruned_flat
//   stjoin_sim_panel_fused_pruned
//                      <- repro/kernels/stjoin/stjoin.py  stjoin_sim_panel_fused_pruned_flat
//
// (C launchers; stjoin_best_match and its pruned twin launch one kernel,
// as do stjoin_vote_fused and its pruned twin; stjoin_sim_fused the
// forward blocks of stjoin_sim_panel_fused's kernel, stjoin_sim_fused_pruned
// those of its pruned twin's.  Two replace no TPU kernel:
// chunk_time_bounds builds the chunk time bounds that every join kernel's
// sweep reads, and sim_row_moments the row moments of alpha, which the
// reference computes in plain jnp.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (never --use_fast_math).  The arithmetic below also spells out the
// IEEE-rounded intrinsics, so no flag can contract d2 into an FMA or
// approximate a square root or a division.
//
// Every launcher has a plain C interface: raw device pointers, sizes and
// the caller's cudaStream_t.  It allocates nothing, does not synchronise,
// and returns cudaGetLastError() so the Python wrapper raises on a launch
// that was refused.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

// The blocks of the join kernels: 32 candidates (one per lane) x 8 warps.
constexpr int K1_TC = 32;    // candidates per block (threadIdx.x): a tile
constexpr int K1_TY = 8;     // warps per block (threadIdx.y)
constexpr int kThreads = K1_TC * K1_TY;

struct JoinOperands {
  const float* rx;
  const float* ry;
  const float* rt;
  const int* rid;
  const uint8_t* rok;
  const float* cx;
  const float* cy;
  const float* ct;
  const int* cid;
  const uint8_t* cok;
  int C, Mc;
  float eps_sp, eps_t;
};

// ---------------------------------------------------------------------------
// The time-window sweep shared by every join kernel: K1 and the fused
// passes K2, K4, K7, and their pruned twins K10-K13.
//
// For every (reference point p, candidate trajectory c) a sweep finds the
// best weight 1 - sqrt(d2)/eps_sp over c's points inside the (eps_sp,
// eps_t) cylinder, same-trajectory pairs skipped, the first point index
// winning a tie.  A block of 32 x 8 threads sweeps 32 candidates, one per
// lane, against groups of 8 consecutive reference points, one per warp:
// K1 / K10 one block of 64 flattened points against a tile of 32
// candidates (join_tile below); K2, K4 and K11-K12 the pairs of one row
// against a tile (the tile is one packed TSA2 word), K7 / K13 those and, in
// their reverse blocks, a few rows against the few candidates that own a
// panel slot (panel_sweep, which leaves each lane's best match per
// reference point m -- weight (0 = none) and, where slot maps are given,
// the match's cell in the pair's ms x ms block -- in [M][33] tiles of
// shared memory, for the consumers: K2's vote and words, the similarity
// scatter of K4 and K7).
//
// Bound: the pairs with |dt| <= eps_t are about 1% of the point pairs of
// the swept trajectories at dsc_brest (2.66e9 of 2.75e11 for all T x C).
// Design (sweep_window, one window of one group against one lane):
// - An exact time-window skip.  A group's points are close in time, with
//   bounds [p_min, p_max] over their valid times.  The wrapper gives the
//   min / max time over the valid points of each chunk of 8 candidate
//   points ([C, ceil(Mc/8)], chunk_bounds_kernel below, once per call or
//   dispatch).  A thread skips chunk k iff the group or the chunk holds no
//   valid time, or __fsub_rn(q_min, p_max) > eps_t, or __fsub_rn(p_min,
//   q_max) > eps_t: the pair test's own IEEE subtraction, and rounding is
//   monotone and odd, so every pair of a skipped chunk has |fl(pt - qt)| >
//   eps_t and fails the test (a NaN bound never skips).  Each lane walks
//   only its own kept chunks (the set bits of a mask) in ascending index.
// - Per kept chunk, the cylinder test of its 8 x 8 pairs sets a mask
//   (same-trajectory points masked out); the IEEE square root and division
//   of the weight then run per lane over its own passes, in ascending index
//   with a strict '>', so (best, argmax) is the plain version's bit for
//   bit.  (Inside the test loop a warp would run that branch for every
//   pair that any of its lanes passes.)
// - The block stages its lanes' candidates in shared memory, a window of
//   wp points at a time (the whole trajectory when Mc <= wp; a reverse
//   block's rows read one copy), as x, y and t with t = NaN where the
//   point is invalid, so the pair test needs no flags; invalid reference
//   points carry t = NaN too.  The launcher picks the widest window (128,
//   64 or 32 points) whose shared memory fits the card's opt-in limit and
//   refuses a shape too large for any.
// - stats (optional): the (group, chunk) pairs tested and skipped, counted
//   per thread over the whole block, summed per warp and added with 64-bit
//   integer atomics once per block (exact, any order); the plain mirrors
//   are stjoin/ops.py::join_skip_counts (K1, K10) and
//   stjoin/ref.py::panel_skip_counts_ref over the pairs of the launch
//   (stjoin/ops.py::fused_pairs, SimPanelSweep.pairs).
// ---------------------------------------------------------------------------
constexpr int kTileStride = K1_TC + 1;
constexpr int kChunk = 8;                  // candidate points per chunk
constexpr int kGroup = 8;                  // reference points per group
constexpr int kPassPts = kGroup * K1_TY;   // reference points per pass

struct PanelArgs {
  int M, ms, p0, panel;
  float delta_t;
  const int* ref_gid;      // slot maps (K4, K7, K12, K13; null for K2, K11)
  const int* cand_gid;
  const float* chunk_lo;   // [C, nch]: min / max time over each chunk's
  const float* chunk_hi;   // valid points, (+inf, -inf) where it has none
  int nch;
  int wp;                  // candidate points staged per window: 32, 64
                           // or 128
  int c_lo, c_hi;          // the candidates that own a panel slot
  int n_lane, per_block;   // reverse blocks: candidates per row, rows
  long long n_src, n_dst;
  unsigned long long* stats;   // [2]: (group, chunk) pairs swept, skipped
  float* fwd;
  float* rev;
};

// strides of the staged window: odd, so lane j's row starts in bank j
__host__ __device__ inline int panel_tile_stride(int wp) { return wp + 1; }
__host__ __device__ inline int panel_bound_stride(int wp) {
  return (wp / kChunk) | 1;
}

// floats of the staged window: x, y, t and the chunk bounds
__host__ __device__ inline long long window_floats(int wp) {
  return 3LL * K1_TC * panel_tile_stride(wp)
         + 2LL * K1_TC * panel_bound_stride(wp);
}

// The block's pairs: lane j's row (-1: no pair) and candidate, and the
// lane whose staged copy of that candidate it reads (a reverse block's
// rows share their candidates, staged once).
struct PanelLanes {
  int t[K1_TC];
  int c[K1_TC];
  int s[K1_TC];
};

struct PanelTile {
  float* x;
  float* y;
  float* t;
  float* lo;
  float* hi;
};

// The window at `base` (window_floats(wp) floats).
__device__ __forceinline__ PanelTile panel_tile(float* base, int wp) {
  const int S7 = panel_tile_stride(wp), SB = panel_bound_stride(wp);
  return PanelTile{base, base + K1_TC * S7, base + 2 * K1_TC * S7,
                   base + 3 * K1_TC * S7, base + 3 * K1_TC * S7 + K1_TC * SB};
}

// (group, chunk) pairs a thread tested and skipped
struct SweepCounts {
  unsigned swept, skipped;
};

// Every thread of the block calls it, once, at the end.
__device__ __forceinline__ void flush_stats(unsigned long long* stats,
                                            const SweepCounts& n) {
  if (stats == nullptr) return;
  unsigned long long sw = n.swept, sk = n.skipped;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sw += __shfl_down_sync(0xffffffffu, sw, off);
    sk += __shfl_down_sync(0xffffffffu, sk, off);
  }
  if (threadIdx.x == 0 && sw > 0) {
    atomicAdd(stats, sw);
    atomicAdd(stats + 1, sk);
  }
}

// Stage candidate points [w0, w0 + wp) and their chunk bounds for every
// lane jl with cand(jl) >= 0 (the candidate that lane's staged row holds;
// -1: nothing to stage); padding has t = NaN and empty bounds.  Each
// thread issues the loads of four points before it stores them (wp is a
// power of two >= 32, so 32 * wp is a multiple of 4 * 256).
template <class Cand>
__device__ __forceinline__ void stage_window(const JoinOperands& op,
                                             const PanelArgs& a, int w0,
                                             Cand cand, const PanelTile& s) {
  const int S7 = panel_tile_stride(a.wp), SB = panel_bound_stride(a.wp);
  const int lg = __ffs(a.wp) - 1;
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  for (int e0 = tid; e0 < K1_TC * a.wp; e0 += 4 * kThreads) {
    float vx[4], vy[4], vt[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kThreads;
      const int jl = e >> lg, mm = e & (a.wp - 1), m = w0 + mm;
      const int c = cand(jl);
      const bool ld = c >= 0 && m < op.Mc;
      const size_t g = (size_t)max(c, 0) * op.Mc + m;
      vx[u] = ld ? op.cx[g] : 0.f;
      vy[u] = ld ? op.cy[g] : 0.f;
      const float t = ld ? op.ct[g] : 0.f;
      vt[u] = ld && op.cok[g] ? t : CUDART_NAN_F;
      at[u] = jl * S7 + mm;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s.x[at[u]] = vx[u];
      s.y[at[u]] = vy[u];
      s.t[at[u]] = vt[u];
    }
  }
  const int k0 = w0 / kChunk, nk = a.wp / kChunk;
  for (int e = tid; e < K1_TC * nk; e += kThreads) {
    const int jl = e / nk, k = e % nk;
    const int c = cand(jl);
    const bool ld = c >= 0 && k0 + k < a.nch;
    const size_t g = (size_t)max(c, 0) * a.nch + k0 + k;
    s.lo[jl * SB + k] = ld ? a.chunk_lo[g] : CUDART_INF_F;
    s.hi[jl * SB + k] = ld ? a.chunk_hi[g] : -CUDART_INF_F;
  }
}

// A group of up to 8 consecutive reference points in registers: x, y, t
// (NaN where the point is invalid or missing) and the bounds [p_min,
// p_max] of its valid times.
struct Group {
  float px[kGroup], py[kGroup], pt[kGroup];
  float p_min, p_max;
};

// Points p .. p + n - 1 (n <= 0: an empty group).
__device__ __forceinline__ void load_group(const JoinOperands& op,
                                           long long p, int n, Group& g) {
  g.p_min = CUDART_INF_F;
  g.p_max = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const bool in = r < n;
    const float t = in && op.rok[p + r] ? op.rt[p + r] : CUDART_NAN_F;
    g.p_min = fminf(g.p_min, t);                  // fminf drops a NaN
    g.p_max = fmaxf(g.p_max, t);
    g.px[r] = in ? op.rx[p + r] : 0.f;
    g.py[r] = in ? op.ry[p + r] : 0.f;
    g.pt[r] = t;
  }
}

// The group's points that may match candidate trajectory my_cid (the
// others are the same trajectory), as a mask over sweep_window's hit bits:
// bits 8(r % 4) .. 8(r % 4) + 7 of word r / 4 for each such point r.
__device__ __forceinline__ void other_traj(const JoinOperands& op,
                                           long long p, int n, int my_cid,
                                           uint32_t (&allow)[2]) {
  allow[0] = allow[1] = 0u;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
    if (r < n && op.rid[p + r] != my_cid)
      allow[r / 4] |= 0xffu << (8 * (r % 4));
}

// The one-pass body of every sweep: one window of the lane's staged
// candidate (qx, qy, qt its points there, lo / hi its chunk bounds; w0 the
// window's first point, nchw its chunks) against the group, into the
// running (best, arg) per point (best = -1 where nothing matched yet).
// counted: the (group, candidate) pair exists; its (group, chunk) pairs go
// into n.
__device__ __forceinline__ void sweep_window(
    const JoinOperands& op, const Group& g, const uint32_t (&allow)[2],
    const float* qx, const float* qy, const float* qt, const float* lo,
    const float* hi, int w0, int nchw, bool counted, float (&best)[kGroup],
    int (&arg)[kGroup], SweepCounts& n) {
  const float eps2 = __fmul_rn(op.eps_sp, op.eps_sp);
  uint32_t keep = 0u;
  if (counted && !(g.p_min > g.p_max)) {
    for (int k = 0; k < nchw; ++k) {
      const float q_lo = lo[k], q_hi = hi[k];
      const bool skip = q_lo > q_hi || __fsub_rn(q_lo, g.p_max) > op.eps_t
                        || __fsub_rn(g.p_min, q_hi) > op.eps_t;
      keep |= (skip ? 0u : 1u) << k;
    }
  }
  if (counted) {
    n.swept += nchw;
    n.skipped += nchw - __popc(keep);
  }
  while (keep != 0u) {                            // ascending chunks
    const int k = __ffs(keep) - 1;
    keep &= keep - 1u;
    // the cylinder test of all 8 x 8 pairs, then the weight of each pair
    // that passes, per lane: a warp steps through the passes of its
    // busiest lane, not through every pair some lane passes
    uint32_t hit[2] = {0u, 0u};         // bit 8(r % 4) + mm: pair (r, mm)
#pragma unroll
    for (int mm = 0; mm < kChunk; ++mm) {
      const int q = k * kChunk + mm;
      const float cx = qx[q], cy = qy[q], ct = qt[q];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const float dx = __fsub_rn(g.px[r], cx);
        const float dy = __fsub_rn(g.py[r], cy);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float dt = fabsf(__fsub_rn(g.pt[r], ct));
        if (d2 <= eps2 && dt <= op.eps_t)
          hit[r / 4] |= 1u << (8 * (r % 4) + mm);
      }
    }
    hit[0] &= allow[0];
    hit[1] &= allow[1];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      uint32_t h = (hit[r / 4] >> (8 * (r % 4))) & 0xffu;
      while (h != 0u) {                           // ascending points
        const int q = k * kChunk + __ffs(h) - 1;
        h &= h - 1u;
        const float dx = __fsub_rn(g.px[r], qx[q]);
        const float dy = __fsub_rn(g.py[r], qy[q]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float w = __fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(d2), op.eps_sp));
        if (w > best[r]) {
          best[r] = w;
          arg[r] = w0 + q;
        }
      }
    }
  }
}

// The chunks of the window at w0: ceil(min(wp, Mc - w0) / 8).
__device__ __forceinline__ int window_chunks(const JoinOperands& op,
                                             const PanelArgs& a, int w0) {
  return (min(a.wp, op.Mc - w0) + kChunk - 1) / kChunk;
}

// ---------------------------------------------------------------------------
// K1: dense best-match join -> best_w / best_idx [P, C], (0, -1) where
// nothing matched.  K10 is the same kernel over a plan's tiles.
//
// Bound: bytes (8*P*C of output; the pairs the join needs are about 1% of
// the P*C*Mc point pairs at dsc_brest).  Design: one block per 64
// consecutive flattened reference points walks the candidate tiles in
// ascending order.  Warp w keeps the group p0 + 8w .. p0 + 8w + 7 in
// registers for the whole block (a group may straddle two rows: its
// bounds are its own valid times, so the skip stays exact and only skips
// less; the same-trajectory test stays per point).  Per tile, lane j takes
// candidate c0 + j: the block stages the tile window by window, each lane
// sweeps its candidate (sweep_window), and each thread writes its 8 (best,
// arg) from registers: every warp store is 32 consecutive outputs of one
// point.  64-bit index math only for the output offset.
//
// K10 <- stjoin_pallas_pruned: the block's K planned tiles (ascending,
// unique, -1 padded: the wrapper checks) instead of all, and (0, -1)
// written into the tiles skipped before each planned tile and after the
// last, so every output is written once, by one thread, with no fill.
// ---------------------------------------------------------------------------

// (0, -1) into the outputs of points p .. p + n - 1 for candidates
// [c_from, c_to), lane j taking c_from + j, c_from + j + 32, ...
__device__ __forceinline__ void join_clear(long long p, int n, int C,
                                           int c_from, int c_to,
                                           float* __restrict__ out_w,
                                           int* __restrict__ out_idx) {
  for (int c = c_from + threadIdx.x; c < c_to; c += K1_TC)
    for (int r = 0; r < n; ++r) {
      const long long o = (p + r) * C + c;
      out_w[o] = 0.f;
      out_idx[o] = -1;
    }
}

// The block's group against the tile of candidates c0 .. c0 + 31: stage,
// sweep, write.  Every thread of the block calls it: it synchronizes.
__device__ __forceinline__ void join_tile(const JoinOperands& op,
                                          const PanelArgs& a,
                                          const PanelTile& s, const Group& g,
                                          long long p, int n, int c0,
                                          float* __restrict__ out_w,
                                          int* __restrict__ out_idx,
                                          SweepCounts& cnt) {
  const int j = threadIdx.x;
  const int S7 = panel_tile_stride(a.wp), SB = panel_bound_stride(a.wp);
  const int c = c0 + j;
  const bool c_in = c < op.C;
  uint32_t allow[2];
  other_traj(op, p, n, c_in ? op.cid[c] : 0, allow);
  float best[kGroup];
  int arg[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    best[r] = -1.f;
    arg[r] = 0;
  }
  for (int w0 = 0; w0 < op.Mc; w0 += a.wp) {
    __syncthreads();                  // every lane has read the last window
    stage_window(op, a, w0, [&](int jl) {
      return c0 + jl < op.C ? c0 + jl : -1;
    }, s);
    __syncthreads();
    sweep_window(op, g, allow, s.x + j * S7, s.y + j * S7, s.t + j * S7,
                 s.lo + j * SB, s.hi + j * SB, w0, window_chunks(op, a, w0),
                 c_in && n > 0, best, arg, cnt);
  }
  if (!c_in) return;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    if (r < n) {
      const long long o = (p + r) * op.C + c;
      const bool matched = best[r] > 0.f;
      out_w[o] = matched ? best[r] : 0.f;
      out_idx[o] = matched ? arg[r] : -1;
    }
  }
}

// Four blocks an SM (53.9 KB of shared memory each with a 128-point
// window; ptxas then gives 64 registers and a 96-byte spill): on an H100
// SXM at dsc_brest K1 ran in 42.7-43.0 ms, against 45.2 with three blocks
// (80 registers) and 45.8 with one block per (64-point block, tile) pair,
// K10 lane-sorted in 30.6-31.0 against 32.0-32.2 and 37.7-38.2 (that
// grid over the plan's live pairs after two fills of the outputs);
// tools/panel_kernel_ms.py --only join, in turns.
__global__ void __launch_bounds__(kThreads, 4)
stjoin_best_match_kernel(JoinOperands op, PanelArgs a, long long P,
                         const int* __restrict__ tile_ids, int K,
                         float* __restrict__ out_w,
                         int* __restrict__ out_idx) {
  extern __shared__ float dyn[];
  const PanelTile s = panel_tile(dyn, a.wp);
  const long long p = (long long)blockIdx.x * kPassPts
                      + threadIdx.y * kGroup;   // the warp's group
  const int n = (int)min((long long)kGroup, P - p);   // <= 0: none
  Group g;
  load_group(op, p, n, g);
  const int* tiles = tile_ids == nullptr ? nullptr
                                         : tile_ids + (long long)blockIdx.x * K;
  const int n_tiles = tiles == nullptr ? (op.C + K1_TC - 1) / K1_TC : K;
  SweepCounts cnt{0u, 0u};
  int c_from = 0;
  for (int q = 0; q < n_tiles; ++q) {
    const int jt = tiles == nullptr ? q : tiles[q];
    if (jt < 0) break;
    const int c0 = jt * K1_TC;
    join_clear(p, n, op.C, c_from, c0, out_w, out_idx);
    join_tile(op, a, s, g, p, n, c0, out_w, out_idx, cnt);
    c_from = c0 + K1_TC;
  }
  join_clear(p, n, op.C, c_from, op.C, out_w, out_idx);
  flush_stats(a.stats, cnt);
}

// ---------------------------------------------------------------------------
// The chunk time bounds of the sweep (plain version:
// stjoin/ref.py::chunk_time_bounds): per row r of t [R, N] and run k of
// `chunk` consecutive points, the min and max over the valid non-NaN
// times, (+inf, -inf) where the run holds none.  One thread per (row,
// run); a min and a max are exact, so the bounds are the plain version's
// bit for bit.  Built on the card, the bounds cost a sweeping call no
// torch operation (a process's first such call would load their modules).
// ---------------------------------------------------------------------------
__global__ void chunk_bounds_kernel(const float* __restrict__ t,
                                    const uint8_t* __restrict__ ok,
                                    long long runs, int N, int chunk, int n,
                                    float* __restrict__ lo,
                                    float* __restrict__ hi) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= runs) return;
  const long long r = e / n;
  const int k = (int)(e - r * n);
  float a = CUDART_INF_F, b = -CUDART_INF_F;
  for (int m = k * chunk; m < min(N, k * chunk + chunk); ++m) {
    const float v = t[r * N + m];
    if (ok[r * N + m] && v == v) {
      a = v < a ? v : a;
      b = v > b ? v : b;
    }
  }
  lo[e] = a;
  hi[e] = b;
}

// The sweep of K2, K4, K7, K11-K13: leaves lane j's weights (0 = no match)
// in tw [m][33] and, if tidx is given, in tidx [m][33] the cell of each
// match in the pair's ms x ms block (-1 = none): the winning index mapped
// through the slot maps.  Thread (lane j, warp w) takes, per pass of 64
// points, the group 64s + 8w .. 64s + 8w + 7 of its lane's row.  Adds the
// thread's (group, chunk) counts to n.  Every thread calls it: it
// synchronizes.
__device__ __forceinline__ void panel_sweep(const JoinOperands& op,
                                            const PanelArgs& a,
                                            const PanelLanes& L, float* tw,
                                            int* tidx, const PanelTile& s,
                                            SweepCounts& n) {
  const int j = threadIdx.x, M = a.M;
  const int S7 = panel_tile_stride(a.wp), SB = panel_bound_stride(a.wp);
  const bool live = L.t[j] >= 0;
  const int t_j = live ? L.t[j] : 0, c_j = L.c[j], ms = a.ms;
  const long long row0 = (long long)t_j * M;
  const int my_cid = live ? op.cid[c_j] : 0;
  const bool one_window = op.Mc <= a.wp;
  const int row = L.s[j];                  // the staged copy it reads
  const auto stage = [&](int w0) {         // each live lane's own copy
    stage_window(op, a, w0, [&](int jl) {
      return L.t[jl] >= 0 && L.s[jl] == jl ? L.c[jl] : -1;
    }, s);
  };
  if (one_window) {
    stage(0);
    __syncthreads();
  }
  for (int m0 = 0; m0 < M; m0 += kPassPts) {
    const int mb = m0 + threadIdx.y * kGroup;     // this thread's group
    const int np = live ? M - mb : 0;
    Group g;
    uint32_t allow[2];
    load_group(op, row0 + mb, np, g);
    other_traj(op, row0 + mb, np, my_cid, allow);
    float best[kGroup];
    int arg[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      best[r] = -1.f;
      arg[r] = 0;
    }
    for (int w0 = 0; w0 < op.Mc; w0 += a.wp) {
      if (!one_window) {
        __syncthreads();
        stage(w0);
        __syncthreads();
      }
      sweep_window(op, g, allow, s.x + row * S7, s.y + row * S7,
                   s.t + row * S7, s.lo + row * SB, s.hi + row * SB, w0,
                   window_chunks(op, a, w0), np > 0, best, arg, n);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int m = mb + r;
      if (m < M) {
        const bool matched = best[r] > 0.f;
        tw[m * kTileStride + j] = matched ? best[r] : 0.f;
        if (tidx != nullptr) {
          // the cell of the match in the pair's ms x ms block (-1: none, or
          // a slot outside it: a sentinel), so the scatter reads no global
          // memory
          const long long i = (live ? a.ref_gid[row0 + m] : 0)
                              - (long long)t_j * ms;
          const long long k =
              (live ? a.cand_gid[(size_t)c_j * op.Mc + arg[r]] : 0)
              - (long long)c_j * ms;
          tidx[m * kTileStride + j] =
              matched && i >= 0 && i < ms && k >= 0 && k < ms
                  ? (int)(i * ms + k) : -1;
        }
      }
    }
  }
  __syncthreads();
}

// The delta_t run refine (DTJ's Refine step) of lane j's pair, over the
// weights (and cells) the sweep left for it: a run is a maximal streak of
// consecutive matched m; it survives iff max(t) - min(t) over the run is
// >= delta_t, exactly the test of repro_torch.core.geometry.filter_delta_t.
// delta_t <= 0 keeps every run.  Called by the 32 threads of threadIdx.y
// == 0; the caller synchronizes afterwards.
__device__ __forceinline__ void refine_tile(float* tw, int* tidx,
                                            const float* __restrict__ rt_row,
                                            int M, float delta_t) {
  if (!(delta_t > 0.f)) return;
  const int j = threadIdx.x;
  int m = 0;
  while (m < M) {
    if (!(tw[m * kTileStride + j] > 0.f)) {
      ++m;
      continue;
    }
    const int first = m;
    float lo = rt_row[m], hi = lo;
    while (m + 1 < M && tw[(m + 1) * kTileStride + j] > 0.f) {
      ++m;
      lo = fminf(lo, rt_row[m]);
      hi = fmaxf(hi, rt_row[m]);
    }
    if (!(__fsub_rn(hi, lo) >= delta_t)) {
      for (int k = first; k <= m; ++k) {
        tw[k * kTileStride + j] = 0.f;
        if (tidx != nullptr) tidx[k * kTileStride + j] = -1;
      }
    }
    ++m;
  }
}

// Lane j's pair: row t against candidate first + o, live up to last.
__device__ __forceinline__ void panel_lane(PanelLanes& L, bool live,
                                           long long t, int first, int last,
                                           int o) {
  const int c = first + o;
  live = live && c <= last;
  L.t[threadIdx.x] = live ? (int)t : -1;
  L.c[threadIdx.x] = live ? c : 0;
}

// ---------------------------------------------------------------------------
// K2: fused pass 1 -> vote [P] f32 and, for TSA2, the packed neighbor
// words [P, W] (W = ceil(C/32), bit j of word c0/32 = candidate c0 + j
// matched after the refine).  K11 is the same kernel over a plan's tiles.
//
// Bound: operations (the pair tests of the sweep); it writes 4*P*(1 + W)
// bytes instead of K1's 8*P*C.  Design: one block per reference row walks
// its candidate tiles in ascending order.  Per tile, lane j takes the row
// against candidate c0 + j: panel_sweep (weights only), refine_tile, then
// the thread of point m adds the tile's 32 refined weights to its running
// vote and builds the tile's word.  So vote[p] is the sum over c in
// ascending order, one rounded add at a time from +0.0 (the plain
// version's order), with no atomics; each word is written whole by one
// thread.  The running vote of point m lives in the padding column 32 of
// its row of the weight tile, so a block needs M*33 floats besides the
// window: rows of up to 1,652 points fit (with a 32-point window).
// Three blocks an SM (70.8 KB of shared memory each at M = 128; ptxas then
// gives 80 registers and a 16-byte spill): on an H100 SXM at dsc_brest
// this ran in 38.2 ms, against 46.9 ms with two blocks (90 registers) and
// 75.8 ms with the next tile staged by cp.async into a second window
// during the sweep (one block an SM); tools/panel_kernel_ms.py, in turns.
//
// K11 <- stjoin_vote_fused_pruned_flat: the row's K planned tiles
// (ascending, -1 padded) instead of all.  Vote: a skipped tile has only
// +0.0 weights, and adding +0.0 to a running sum that started at +0.0 and
// only ever adds non-negative weights changes no bit, so skipping those
// adds leaves vote bitwise K2's.  Words: the thread of point m writes 0
// into the words of the tiles skipped before each planned tile and after
// the last one, so every word is written once, by one thread, without
// atomics or a fill.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 3)
stjoin_vote_fused_kernel(JoinOperands op, PanelArgs a,
                         const int* __restrict__ tile_ids, int K,
                         float* __restrict__ vote, int* __restrict__ words,
                         int W) {
  extern __shared__ float dyn[];
  __shared__ PanelLanes L;
  const int M = a.M, tid = threadIdx.y * K1_TC + threadIdx.x;
  float* tw = dyn;                     // [M][33]; column 32: the vote
  const PanelTile s = panel_tile(dyn + M * kTileStride, a.wp);
  const long long t = blockIdx.x, row0 = t * M;
  const int* tiles = tile_ids == nullptr ? nullptr : tile_ids + t * K;
  const int n_tiles = tiles == nullptr ? (op.C + K1_TC - 1) / K1_TC : K;
  for (int m = tid; m < M; m += kThreads) tw[m * kTileStride + K1_TC] = 0.f;
  SweepCounts n{0u, 0u};
  int w_from = 0;
  for (int q = 0; q < n_tiles; ++q) {
    const int jt = tiles == nullptr ? q : tiles[q];
    if (jt < 0) break;
    const int c0 = jt * K1_TC;
    if (threadIdx.y == 0) {
      panel_lane(L, true, t, c0, min(op.C, c0 + K1_TC) - 1, threadIdx.x);
      L.s[threadIdx.x] = threadIdx.x;
    }
    __syncthreads();          // and the last tile's votes have read tw
    panel_sweep(op, a, L, tw, nullptr, s, n);
    if (threadIdx.y == 0) refine_tile(tw, nullptr, op.rt + row0, M,
                                      a.delta_t);
    __syncthreads();
    const int nc = min(K1_TC, op.C - c0);
    for (int m = tid; m < M; m += kThreads) {
      float* r = tw + m * kTileStride;
      float acc = r[K1_TC];
      uint32_t word = 0u;
      for (int j = 0; j < nc; ++j) {
        acc = __fadd_rn(acc, r[j]);
        word |= (r[j] > 0.f ? 1u : 0u) << j;
      }
      r[K1_TC] = acc;
      if (words != nullptr) {
        int* wrow = words + (size_t)(row0 + m) * W;
        for (int k = w_from; k < jt; ++k) wrow[k] = 0;
        wrow[jt] = (int)word;
      }
    }
    w_from = jt + 1;
  }
  for (int m = tid; m < M; m += kThreads) {
    vote[row0 + m] = tw[m * kTileStride + K1_TC];
    if (words != nullptr) {
      int* wrow = words + (size_t)(row0 + m) * W;
      for (int k = w_from; k < W; ++k) wrow[k] = 0;
    }
  }
  flush_stats(a.stats, n);
}

// ---------------------------------------------------------------------------
// K7: fused pass 2 for one panel of slots [p0, p0 + panel), in both
// orientations: fwd[i, j] = raw[p0 + i, j] ([panel, C*ms]) and
// rev[i, j] = raw[j, p0 + i] ([panel, T*ms]).  K4 is the same kernel's
// forward blocks over every row: the panel [0, T*ms), fwd = raw.
//
// raw [T*ms, C*ms] f32 is the un-normalized similarity scatter:
// raw[ref_gid[p], cand_gid[c, idx]] += w for every refined match.  The
// slot maps are block-structured: ref_gid of row t lies in [t*ms,
// (t+1)*ms) or is the sentinel T*ms, cand_gid of candidate c in [c*ms,
// (c+1)*ms) or the sentinel C*ms (the wrapper checks this).  So the work
// of one (row t, candidate c) pair writes one ms x ms block of raw and
// nothing else, and only few pairs reach a panel: fwd needs the rows
// t_lo..t_hi that own a panel slot against every candidate, rev every row
// against the candidates c_lo..c_hi that own one (rev[i, j] comes from the
// pair (row j / ms, candidate (p0 + i) / ms)).  The TPU kernel re-sweeps
// all T*C pairs per panel; this one sweeps about 2 * (panel / ms + 1) * T
// pairs of trajectories.
//
// Bound: bytes (the two slabs written once, 2 * panel * S * 4; K4: raw,
// T*ms * C*ms * 4).  Design:
// - One (reference row t, candidate c) pair per lane, 32 per block.
//   Forward blocks: a row that owns a panel slot against a tile of 32
//   candidates.  Reverse blocks: the n_lane panel candidates of one
//   32-candidate tile against per_block = 32 / n_lane rows, so with 16
//   panel candidates (ms = 8, panel = 128) every lane has a live pair.
// - panel_sweep with the slot maps: the weights and cells of each lane.
// - Then refine_tile on each lane's own row and the scatter: lane j adds
//   its weights in ascending m into its ms x ms block in shared memory
//   (reusing the window), one rounded add at a time from +0.0, no atomics:
//   every cell sums the same weights in the same order as the plain
//   version (the materialize path's scatter).  A block writes only the
//   cells whose slot lies inside the panel (a panel may split a
//   trajectory's slots), whole, zeros included, and between them the
//   blocks write every cell of both slabs, so neither needs a zero fill.
// ---------------------------------------------------------------------------

// Lane j (of warp 0): refine its pair's row, then add its weights in
// ascending m into its ms x ms block.
__device__ __forceinline__ void panel_scatter(const JoinOperands& op,
                                              const PanelArgs& a,
                                              const PanelLanes& L, float* tw,
                                              int* tidx, float* blk) {
  const int j = threadIdx.x, bs = a.ms * a.ms + 1;
  float* b = blk + j * bs;
  for (int e = 0; e < bs; ++e) b[e] = 0.f;
  const int t = L.t[j];
  if (t < 0) return;
  refine_tile(tw, tidx, op.rt + (long long)t * a.M, a.M, a.delta_t);
  for (int m = 0; m < a.M; ++m) {
    const float w = tw[m * kTileStride + j];
    const int cell = tidx[m * kTileStride + j];
    if (w > 0.f && cell >= 0) b[cell] = __fadd_rn(b[cell], w);
  }
}

// The cells of the block's pairs whose slot lies in the panel: a forward
// block's rows (one row, every lane live up to the last candidate), a
// reverse block's candidate slots, transposed into rev.  Consecutive
// threads write a pair's ms columns, then the next row's.
__device__ __forceinline__ void panel_write(const JoinOperands& op,
                                            const PanelArgs& a, bool forward,
                                            const PanelLanes& L,
                                            const float* blk) {
  const int ms = a.ms, bs = ms * ms + 1;
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  if (forward) {
    const long long s0 = (long long)L.t[0] * ms;
    const int c0 = L.c[0];
    const int nc = min(K1_TC, op.C - c0);
    const int i_lo = a.p0 > s0 ? (int)(a.p0 - s0) : 0;
    const int i_hi = a.p0 + a.panel < s0 + ms ? (int)(a.p0 + a.panel - s0)
                                              : ms;
    const int ncols = nc * ms;
    for (int e = tid; e < (i_hi - i_lo) * ncols; e += kThreads) {
      const int i = i_lo + e / ncols, col = e % ncols;
      const int cl = col / ms, k = col % ms;
      a.fwd[(size_t)(s0 + i - a.p0) * a.n_dst + (size_t)c0 * ms + col] =
          blk[cl * bs + i * ms + k];
    }
  } else {
    const int nl = a.n_lane, E = a.per_block;
    for (int e = tid; e < nl * ms * E * ms; e += kThreads) {
      const int i = e % ms;
      int r = e / ms;
      const int q = r % E;
      r /= E;
      const int k = r % ms, o = r / ms;
      const int jl = q * nl + o;
      const int t = L.t[jl];
      if (t < 0) continue;
      const long long slot = (long long)L.c[jl] * ms + k;
      if (slot < a.p0 || slot >= (long long)a.p0 + a.panel) continue;
      a.rev[(size_t)(slot - a.p0) * a.n_src + (size_t)t * ms + i] =
          blk[jl * bs + i * ms + k];
    }
  }
}

// One block of K4 / K7 / K12 / K13 once the lane tables are set: sweep,
// refine and scatter, write, then the block's skip counts.
__device__ __forceinline__ void panel_block(const JoinOperands& op,
                                            const PanelArgs& a, bool forward,
                                            PanelLanes& L, float* dyn) {
  float* tw = dyn;                                            // [M][33]
  int* tidx = reinterpret_cast<int*>(dyn + a.M * kTileStride);  // [M][33]
  float* tile = dyn + 2 * a.M * kTileStride;
  const PanelTile s = panel_tile(tile, a.wp);
  if (threadIdx.y == 0) {
    const int j = threadIdx.x, o = forward ? j : j % a.n_lane;
    L.s[j] = L.t[o] >= 0 && L.c[o] == L.c[j] ? o : j;
  }
  __syncthreads();
  SweepCounts n{0u, 0u};
  panel_sweep(op, a, L, tw, tidx, s, n);
  if (threadIdx.y == 0) panel_scatter(op, a, L, tw, tidx, tile);
  __syncthreads();
  panel_write(op, a, forward, L, tile);
  flush_stats(a.stats, n);
}

// Forward blocks: row t_lo + b / ntc against tile b % ntc.  Reverse
// blocks: entries e (tile-major: tile j_lo + e / T, row e % T), per_block
// of them a block, each the panel's candidates inside its tile.
__global__ void __launch_bounds__(kThreads, 2)
stjoin_sim_panel_fused_kernel(JoinOperands op, PanelArgs a, int T, int t_lo,
                              int ntc, long long n_fwd, int j_lo,
                              int n_rev_tiles) {
  extern __shared__ float dyn[];
  __shared__ PanelLanes L;
  const long long b = blockIdx.x;
  const bool forward = b < n_fwd;
  if (threadIdx.y == 0) {
    const int j = threadIdx.x;
    if (forward) {
      const int tile = (int)(b % ntc);
      panel_lane(L, true, t_lo + b / ntc, tile * K1_TC,
                 min(op.C, tile * K1_TC + K1_TC) - 1, j);
    } else {
      const long long e = (b - n_fwd) * a.per_block + j / a.n_lane;
      const int tile = j_lo + (int)(e / T);
      panel_lane(L,
                 j < a.per_block * a.n_lane && e < (long long)T * n_rev_tiles,
                 e % T, max(a.c_lo, tile * K1_TC),
                 min(a.c_hi, tile * K1_TC + K1_TC - 1), j % a.n_lane);
    }
  }
  __syncthreads();
  panel_block(op, a, forward, L, dyn);
}

// ---------------------------------------------------------------------------
// The index-pruned kernels K10-K13.  A tile plan names, per reference
// block, the ascending ids of the candidate tiles that can hold a match
// (repro_torch.index.grid; a skipped tile provably holds none).  The
// port's plans use the dense kernels' own blocks: 64 reference points x
// 32 candidates for K10 (K1's block), one reference row x 32 candidates
// for K11-K13 (K2's, K4's and K7's block), so a tile is one packed TSA2
// word.  Each pruned kernel runs its dense kernel's block body on the
// planned tiles only (K10 and K11 are K1's and K2's kernels with the
// block's tile list, K12 K13's forward blocks), so a kept tile's output is
// its dense kernel's, bit for bit; a skipped tile's output is what the
// dense kernel writes for a tile without a match: (0, -1), a zero word,
// zero cells.  K10 and K11 write those themselves; K12 and K13 launch
// blocks only for live entries (the wrapper passes the plan's live (block,
// tile) pairs as a flat int2 list, row-major, or tile-major for K13's
// reverse blocks) over a zero fill.  The candidate operands are read in
// place through the tile ids (the TPU kernels gather them to [nRb, K, bc,
// Mc] first).
//
// Bound: that of the dense kernel over the kept pairs' share of the work;
// the outputs are still written whole.
//
// K13 <- stjoin_sim_panel_fused_pruned_flat: K7 over the plan.  Forward
// blocks: K7's forward blocks of the rows t_lo..t_hi that own a panel
// slot, for their planned tiles only (fwd_pairs: the plan's row-major
// entries of those rows).  Reverse blocks: the plan's entries (row t,
// tile j) of the tiles that hold the panel's candidates c_lo..c_hi
// (rev_pairs, tile-major), per_block entries a block, each lane one of the
// panel's candidates inside its entry's tile.  A cell's sum does not
// depend on how the pairs are grouped into blocks (each lane owns one), so
// every written cell is K7's; the rest are the wrapper's zero fill of both
// slabs.  K12 <- stjoin_sim_fused_pruned_flat is its forward blocks over
// every planned entry, the panel [0, T*ms) (K4 over the plan).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2)
stjoin_sim_panel_fused_pruned_kernel(JoinOperands op, PanelArgs a,
                                     const int2* __restrict__ fwd_pairs,
                                     long long n_fwd,
                                     const int2* __restrict__ rev_pairs,
                                     long long n_rev) {
  extern __shared__ float dyn[];
  __shared__ PanelLanes L;
  const long long b = blockIdx.x;
  const bool forward = b < n_fwd;
  if (threadIdx.y == 0) {
    const int j = threadIdx.x;
    if (forward) {
      const int2 e = fwd_pairs[b];
      panel_lane(L, true, e.x, e.y * K1_TC,
                 min(op.C, e.y * K1_TC + K1_TC) - 1, j);
    } else {
      const long long q = (b - n_fwd) * a.per_block + j / a.n_lane;
      const bool live = j < a.per_block * a.n_lane && q < n_rev;
      const int2 e = live ? rev_pairs[q] : make_int2(0, 0);
      panel_lane(L, live, e.x, max(a.c_lo, e.y * K1_TC),
                 min(a.c_hi, e.y * K1_TC + K1_TC - 1), j % a.n_lane);
    }
  }
  __syncthreads();
  panel_block(op, a, forward, L, dyn);
}

// ---------------------------------------------------------------------------
// K3: TSA2's windowed Jaccard signal.
//
// d[t, m] = 1 - popc(l1 & l2) / popc(l1 | l2) with l1 the OR of the packed
// neighbor words over [m-w, m-1] and l2 over [m, m+w-1] (zeros off the
// edge and at invalid positions), 0 where the union is empty.
//
// Bound: bytes, one read of the words of the valid positions (the
// [T, M, W] words are 268 MB at dsc_brest) and of valid, one write of d.
// A warp per (t, m) ORing 2w rows read every word 2w times through the
// caches, one dependent load in flight a lane.  So:
// * a block owns one trajectory (blocks walk t by gridDim.x) and stages
//   its rows in column slabs of J words (J from the launcher, by shape:
//   the widest of 32, 16, ... 1 whose tiles fit 48 KB) into shared memory,
//   JW_UNROLL loads a thread issued before any is stored (uint4 when
//   W % 4 == 0, J % 4 == 0 and the words are 16-byte aligned: VEC;
//   4-byte loads otherwise).  An invalid position is never read: its row
//   is stored as zeros, the OR identity, so no masking pass precedes the
//   kernel;
// * every word is then combined O(1) times whatever w is (van Herk /
//   Gil-Werman): with we = min(w, M) and segments [s we, (s+1) we), a
//   thread per (column, segment) writes the suffix ORs S and, in place,
//   the prefix ORs P of its segment; then a window [a, a+we-1] is
//   S[a] | P[a+we-1] (S is 0 left of 0; past M-1, P[M-1] if the segment
//   of a+we-1 starts before M, else 0): l1[m] = P[m-1] | S[m-we],
//   l2[m] = S[m] | P[min(m+we-1, M-1)];
// * a thread per (m, part of the slab's columns) sums the popcounts and
//   adds them to per-m integer counts in shared memory (integer sums: any
//   order is exact);
// * shapes whose tiles pass the card's opt-in shared-memory limit keep
//   them in a global scratch the wrapper allocates, one per block.
// The counts are integers (exact in f32), so d is bitwise the plain
// division.  jaccard/ref.py::jaccard_schedule_ref mirrors the schedule.
// ---------------------------------------------------------------------------
constexpr int JW_THREADS = 256;
constexpr int JW_UNROLL = 4;

// 32-bit words of one block's tiles: the words / prefix ORs and the
// suffix ORs ([M][J + 1] each), the two counts [M] and the flags [M] bytes
__host__ __device__ inline size_t jaccard_words(int M, int J) {
  return (size_t)M * (2 * (J + 1) + 2) + ((size_t)M + 3) / 4;
}

template <bool VEC>
__device__ __forceinline__ void jaccard_stage(
    const uint32_t* __restrict__ row, const uint8_t* ok, int M, int W,
    int j0, int Jn, int ld, uint32_t* X) {
  constexpr int E = VEC ? 4 : 1;           // words a load
  const int per_row = Jn / E;
  const int n = M * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += JW_THREADS * JW_UNROLL) {
    uint32_t v[JW_UNROLL][E];
#pragma unroll
    for (int u = 0; u < JW_UNROLL; ++u) {
      const int i = i0 + u * JW_THREADS;
      const int m = i / per_row, q = i - m * per_row;
      if (i < n && ok[m]) {
        const uint32_t* src = row + (size_t)m * W + j0 + q * E;
        if constexpr (VEC) {
          const uint4 x = *reinterpret_cast<const uint4*>(src);
          v[u][0] = x.x;
          v[u][1] = x.y;
          v[u][2] = x.z;
          v[u][3] = x.w;
        } else {
          v[u][0] = *src;
        }
      } else {
#pragma unroll
        for (int c = 0; c < E; ++c) v[u][c] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < JW_UNROLL; ++u) {
      const int i = i0 + u * JW_THREADS;
      if (i < n) {
        const int m = i / per_row, q = i - m * per_row;
#pragma unroll
        for (int c = 0; c < E; ++c) X[m * ld + q * E + c] = v[u][c];
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(JW_THREADS)
jaccard_window_kernel(const uint32_t* __restrict__ masks,
                      const uint8_t* __restrict__ valid, int T, int M, int W,
                      int w, int J, uint32_t* __restrict__ scratch,
                      float* __restrict__ d) {
  extern __shared__ uint32_t jw_smem[];
  uint32_t* X = scratch ? scratch + blockIdx.x * jaccard_words(M, J)
                        : jw_smem;
  const int ld = J + 1;
  uint32_t* Sf = X + (size_t)M * ld;
  int* cnt_i = reinterpret_cast<int*>(Sf + (size_t)M * ld);
  int* cnt_u = cnt_i + M;
  uint8_t* ok = reinterpret_cast<uint8_t*>(cnt_u + M);
  const int we = min(w, M);
  const int tid = threadIdx.x;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const uint32_t* row = masks + (size_t)t * M * W;
    for (int m = tid; m < M; m += JW_THREADS) {
      cnt_i[m] = 0;
      cnt_u[m] = 0;
      ok[m] = valid[(size_t)t * M + m];
    }
    if (we > 0) {
      const int nseg = (M + we - 1) / we;
      const int parts = max(1, JW_THREADS / M);
      for (int j0 = 0; j0 < W; j0 += J) {
        const int Jn = min(J, W - j0);
        __syncthreads();   // flags staged; the last slab's tiles read
        jaccard_stage<VEC>(row, ok, M, W, j0, Jn, ld, X);
        __syncthreads();
        // suffix ORs into Sf, prefix ORs over X in place, per segment
        for (int i = tid; i < nseg * Jn; i += JW_THREADS) {
          const int s = i / Jn, jj = i - s * Jn;
          const int a = s * we, b = min(M, a + we);
          uint32_t acc = 0u;
          for (int k = b - 1; k >= a; --k) {
            acc |= X[k * ld + jj];
            Sf[k * ld + jj] = acc;
          }
          acc = 0u;
          for (int k = a; k < b; ++k) {
            acc |= X[k * ld + jj];
            X[k * ld + jj] = acc;
          }
        }
        __syncthreads();
        for (int i = tid; i < M * parts; i += JW_THREADS) {
          const int part = i / M, m = i - part * M;
          const int q = m + we - 1;
          const int pq = q < M ? q : ((q / we) * we <= M - 1 ? M - 1 : -1);
          int ci = 0, cu = 0;
          for (int jj = part; jj < Jn; jj += parts) {
            const uint32_t l1 = (m >= 1 ? X[(m - 1) * ld + jj] : 0u)
                                | (m >= we ? Sf[(m - we) * ld + jj] : 0u);
            const uint32_t l2 = Sf[m * ld + jj]
                                | (pq >= 0 ? X[pq * ld + jj] : 0u);
            ci += __popc(l1 & l2);
            cu += __popc(l1 | l2);
          }
          if (cu) {
            atomicAdd(&cnt_i[m], ci);
            atomicAdd(&cnt_u[m], cu);
          }
        }
      }
    }
    __syncthreads();
    for (int m = tid; m < M; m += JW_THREADS) {
      const int uni = cnt_u[m];
      d[(size_t)t * M + m] =
          uni > 0 ? __fsub_rn(1.f, __fdiv_rn((float)cnt_i[m], (float)uni))
                  : 0.f;
    }
    __syncthreads();   // the counts are read before the next t zeroes them
  }
}

// ---------------------------------------------------------------------------
// K5: one round of the round-parallel clustering engine.
//
// For every column s: OR over rows u of
//   sim[u, s] > 0 && sim[u, s] >= alpha && rank[u] < rank[s]
// masked by unresolved[u] (-> blocked[s]) and by is_rep[u] (-> claimed[s]).
//
// Bound: bytes, one read of the rows whose mask bits are set (7,056 of
// 32,768 at dsc_brest's round 0).  The card reaches its rate only with
// about 25 KB of loads in flight per SM; a thread that tests its row's
// flags before each 4-byte load keeps one load in flight.  So:
// * a block of SCAN_THREADS threads owns SCAN_COLS consecutive columns, 4
//   a thread, and one slice of the rows (gridDim.y slices, sized by the
//   launcher from the SM count: about 32 blocks an SM, at least
//   SCAN_THREADS rows a slice).  It stages its slice SCAN_CHUNK rows at a
//   time, compacting the active rows (either flag set) in row order with
//   warp ballots into a shared list of (u << 2 | flags, rank[u]); no flag
//   load and no branch remains per row, and rank keeps all its 32 bits;
// * each thread reads its 4 columns of SCAN_UNROLL listed rows before it
//   tests any of them (a warp reads 512 contiguous bytes of a row), so
//   SCAN_UNROLL x 16 bytes a thread are in flight;
// * rows are 16-byte aligned when S % 4 == 0 (and sim is): one float4 a
//   row (VEC); otherwise four scalar loads, the last group of a row cut at
//   column S.  The launcher picks the instantiation by shape.
// A slice that finds a predicate stores 1 into the zeroed output; every
// such store writes the same value, so the OR needs no atomics and is
// exact.  cluster/ref.py::round_scan_schedule_ref is the schedule's plain
// mirror.
// ---------------------------------------------------------------------------
constexpr int SCAN_THREADS = 128;
constexpr int SCAN_COLS = 4 * SCAN_THREADS;
constexpr int SCAN_CHUNK = 1024;
constexpr int SCAN_UNROLL = 4;   // 2.6% ahead of 8 over a run (PERF.md)

// Columns c0 .. c0 + 3 of one row; a column at or past S reads 0, which
// is no edge (0 > 0 is false).
template <bool VEC>
__device__ __forceinline__ float4 scan_load(const float* __restrict__ row,
                                            int c0, int S) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row + c0));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 < S) v.x = __ldg(row + c0);
  if (c0 + 1 < S) v.y = __ldg(row + c0 + 1);
  if (c0 + 2 < S) v.z = __ldg(row + c0 + 2);
  if (c0 + 3 < S) v.w = __ldg(row + c0 + 3);
  return v;
}

// ORs the listed row's flags f into bits 2q (blocked) and 2q + 1
// (claimed) of `hit` for each of the thread's columns q with an alpha-edge
// from the row (of rank rk).
__device__ __forceinline__ void scan_test(float4 v, int rk, unsigned f,
                                          float alpha, const int (&rs)[4],
                                          unsigned& hit) {
  const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (c[q] > 0.f && c[q] >= alpha && rk < rs[q]) hit |= f << (2 * q);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(SCAN_THREADS)
round_scan_kernel(const float* __restrict__ sim,
                  const int* __restrict__ rank,
                  const uint8_t* __restrict__ unresolved,
                  const uint8_t* __restrict__ is_rep,
                  const float* __restrict__ alpha_p, float alpha_v, int S,
                  int rows_per_split, uint8_t* __restrict__ blocked,
                  uint8_t* __restrict__ claimed) {
  __shared__ int list_u[SCAN_CHUNK];
  __shared__ int list_e[SCAN_CHUNK];
  __shared__ int warp_n[SCAN_THREADS / 32];
  const float alpha = alpha_p ? *alpha_p : alpha_v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * SCAN_COLS + 4 * threadIdx.x;
  int rs[4];     // a column past S has no predecessor
#pragma unroll
  for (int q = 0; q < 4; ++q) rs[q] = c0 + q < S ? rank[c0 + q] : INT_MIN;
  const int u0 = blockIdx.y * rows_per_split;
  const int u1 = min(S, u0 + rows_per_split);
  unsigned hit = 0;
  for (int base = u0; base < u1; base += SCAN_CHUNK) {
    // compaction: the chunk's active rows, in row order
    int n = 0;
    for (int k = 0; k < SCAN_CHUNK; k += SCAN_THREADS) {
      const int u = base + k + threadIdx.x;
      int f = 0;
      if (u < u1) f = (unresolved[u] != 0) | ((is_rep[u] != 0) << 1);
      const unsigned bal = __ballot_sync(0xffffffffu, f != 0);
      if (lane == 0) warp_n[warp] = __popc(bal);
      __syncthreads();
      int at = n, total = 0;
#pragma unroll
      for (int w = 0; w < SCAN_THREADS / 32; ++w) {
        at += w < warp ? warp_n[w] : 0;
        total += warp_n[w];
      }
      if (f) {
        const int i = at + __popc(bal & ((1u << lane) - 1u));
        list_u[i] = (u << 2) | f;
        list_e[i] = rank[u];
      }
      n += total;
      __syncthreads();
    }
    // the sweep over the listed rows
    if (c0 < S) {
      int k = 0;
      for (; k + SCAN_UNROLL <= n; k += SCAN_UNROLL) {
        float4 v[SCAN_UNROLL];
#pragma unroll
        for (int q = 0; q < SCAN_UNROLL; ++q)
          v[q] = scan_load<VEC>(sim + (size_t)(list_u[k + q] >> 2) * S,
                                c0, S);
#pragma unroll
        for (int q = 0; q < SCAN_UNROLL; ++q)
          scan_test(v[q], list_e[k + q], list_u[k + q] & 3, alpha, rs, hit);
      }
      for (; k < n; ++k)
        scan_test(scan_load<VEC>(sim + (size_t)(list_u[k] >> 2) * S, c0, S),
                  list_e[k], list_u[k] & 3, alpha, rs, hit);
    }
    __syncthreads();     // the next chunk rewrites the list
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((hit >> (2 * q)) & 1u) blocked[c0 + q] = 1;
    if ((hit >> (2 * q + 1)) & 1u) claimed[c0 + q] = 1;
  }
}

// ---------------------------------------------------------------------------
// K6: the claim-max over representative rows.
//
// Per valid column s: over the rows u with is_rep[u] and an alpha-edge
// (sim > 0 && sim >= alpha), the maximum weight, then the minimum rank
// among those rows, then the lowest row of that rank; best_slot = -1
// where the weight is 0.  The order (w desc, rank asc, row asc) is total
// over the rows for any int32 rank, duplicates included: a running
// (w, rank, slot) replaced only on a greater w, or an equal w with a
// smaller rank, keeps the lowest row as long as it meets the rows in row
// order, and the slices below are merged in row order.
//
// Bound: bytes (one read of the R representative rows of [S, S]; R is 8
// at dsc_brest, so at that size the launch is the floor).  Design:
// * claim_list_kernel (one block) lists the representative rows in row
//   order as (u, rank[u]) with their count R, and zeroes the slices'
//   counters: no thread of the sweep tests a flag per row;
// * claim_max_kernel: a block of CLAIM_THREADS threads owns CLAIM_COLS
//   columns, 4 a thread, and one slice of the list.  The grid has the
//   launcher's n_split slices (from the SM count); the list is cut into
//   claim_splits(R) of them, one per CLAIM_SPLIT_ROWS rows at least, and
//   the blocks of the other slices return at once.  A block stages its
//   slice CLAIM_CHUNK entries at a time into shared memory and reads its
//   4 columns of CLAIM_UNROLL listed rows before it tests any of them
//   (float4 when S % 4 == 0 and sim is 16-byte aligned, else K5's scalar
//   groups); a column past S or not valid is never a candidate;
// * one slice writes the outputs itself.  Several write partials; the
//   last of a column block's slices to finish (an integer counter, after
//   a fence) merges them in slice order with the same strict test.  No
//   float atomics; the result does not depend on the blocks' timing.
// cluster/ref.py::claim_max_schedule_ref is the schedule's plain mirror.
// ---------------------------------------------------------------------------
constexpr int LIST_THREADS = 1024;
constexpr int LIST_ROWS = 64;        // rows a thread, a pass of the list
constexpr int CLAIM_THREADS = 128;
constexpr int CLAIM_COLS = 4 * CLAIM_THREADS;
constexpr int CLAIM_CHUNK = 1024;
constexpr int CLAIM_UNROLL = 8;
constexpr int CLAIM_SPLIT_ROWS = 32;

__host__ __device__ __forceinline__ int claim_splits(int R, int n_split) {
  return max(1, min(n_split, (R + CLAIM_SPLIT_ROWS - 1) / CLAIM_SPLIT_ROWS));
}

// Bit i: is_rep[u0 + i] is set (0 past S).  Four 16-byte loads where the
// thread's rows lie whole inside S and is_rep is 16-byte aligned, else
// byte loads; either way all loads before any test.
__device__ __forceinline__ unsigned long long list_flags(
    const uint8_t* __restrict__ is_rep, int u0, int S, bool vec) {
  unsigned long long mask = 0;
  if (vec && u0 + LIST_ROWS <= S) {
    uint4 w[LIST_ROWS / 16];
#pragma unroll
    for (int j = 0; j < LIST_ROWS / 16; ++j)
      w[j] = __ldg(reinterpret_cast<const uint4*>(is_rep + u0) + j);
#pragma unroll
    for (int j = 0; j < LIST_ROWS / 16; ++j) {
      const unsigned x[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        mask |= (unsigned long long)(((x[k >> 2] >> (8 * (k & 3))) & 0xffu)
                                     != 0u) << (16 * j + k);
    }
  } else {
    uint8_t f[LIST_ROWS];
#pragma unroll
    for (int i = 0; i < LIST_ROWS; ++i)
      f[i] = u0 + i < S ? __ldg(is_rep + u0 + i) : 0;
#pragma unroll
    for (int i = 0; i < LIST_ROWS; ++i)
      mask |= (unsigned long long)(f[i] != 0) << i;
  }
  return mask;
}

__global__ void __launch_bounds__(LIST_THREADS)
claim_list_kernel(const uint8_t* __restrict__ is_rep,
                  const int* __restrict__ rank, int S, int col_blocks,
                  int2* __restrict__ list, int* __restrict__ count,
                  int* __restrict__ done) {
  __shared__ int warp_n[LIST_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(is_rep) & 15) == 0;
  for (int x = threadIdx.x; x < col_blocks; x += LIST_THREADS) done[x] = 0;
  int n = 0;
  for (int base = 0; base < S; base += LIST_THREADS * LIST_ROWS) {
    // each thread's LIST_ROWS consecutive rows
    const int u0 = base + threadIdx.x * LIST_ROWS;
    unsigned long long mask = list_flags(is_rep, u0, S, vec);
    // block-wide exclusive scan of the threads' counts, in thread order
    const int c = __popcll(mask);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = warp_n[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      warp_n[lane] = v;
    }
    __syncthreads();
    int at = n + incl - c + (warp ? warp_n[warp - 1] : 0);
    while (mask) {
      const int u = u0 + __ffsll(mask) - 1;
      mask &= mask - 1;
      list[at++] = make_int2(u, rank[u]);
    }
    n += warp_n[LIST_THREADS / 32 - 1];
    __syncthreads();     // the next pass rewrites warp_n
  }
  if (threadIdx.x == 0) *count = n;
}

// The listed row u (of rank rk) against the thread's columns: a candidate
// replaces the running (w, rank, slot) on a greater w, or an equal w with
// a smaller rank.
__device__ __forceinline__ void claim_test(float4 v, int u, int rk,
                                           float alpha, const bool (&ok)[4],
                                           float (&aw)[4], int (&ar)[4],
                                           int (&as)[4]) {
  const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (ok[q] && c[q] > 0.f && c[q] >= alpha
        && (c[q] > aw[q] || (c[q] == aw[q] && rk < ar[q]))) {
      aw[q] = c[q];
      ar[q] = rk;
      as[q] = u;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(CLAIM_THREADS)
claim_max_kernel(const float* __restrict__ sim,
                 const uint8_t* __restrict__ valid,
                 const float* __restrict__ alpha_p, float alpha_v, int S,
                 const int2* __restrict__ list, const int* __restrict__ count,
                 int* __restrict__ done, float* __restrict__ part_w,
                 int* __restrict__ part_r, int* __restrict__ part_s,
                 float* __restrict__ best_w, int* __restrict__ best_slot) {
  __shared__ int list_u[CLAIM_CHUNK];
  __shared__ int list_r[CLAIM_CHUNK];
  __shared__ int last;
  const int R = *count;
  const float alpha = alpha_p ? *alpha_p : alpha_v;
  const int n = claim_splits(R, gridDim.y);
  const int y = blockIdx.y;
  if (y >= n) return;                     // uniform across the block
  const int k0 = (int)((long long)R * y / n);
  const int k1 = (int)((long long)R * (y + 1) / n);
  const int c0 = blockIdx.x * CLAIM_COLS + 4 * threadIdx.x;
  bool ok[4];
  float aw[4];
  int ar[4], as[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ok[q] = c0 + q < S && valid[c0 + q] != 0;
    aw[q] = 0.f;
    ar[q] = INT_MAX;
    as[q] = -1;
  }
  const bool live = ok[0] || ok[1] || ok[2] || ok[3];
  for (int base = k0; base < k1; base += CLAIM_CHUNK) {
    const int m = min(CLAIM_CHUNK, k1 - base);
    for (int i = threadIdx.x; i < m; i += CLAIM_THREADS) {
      const int2 e = list[base + i];
      list_u[i] = e.x;
      list_r[i] = e.y;
    }
    __syncthreads();
    if (live) {
      int k = 0;
      for (; k + CLAIM_UNROLL <= m; k += CLAIM_UNROLL) {
        float4 v[CLAIM_UNROLL];
#pragma unroll
        for (int q = 0; q < CLAIM_UNROLL; ++q)
          v[q] = scan_load<VEC>(sim + (size_t)list_u[k + q] * S, c0, S);
#pragma unroll
        for (int q = 0; q < CLAIM_UNROLL; ++q)
          claim_test(v[q], list_u[k + q], list_r[k + q], alpha, ok, aw, ar,
                     as);
      }
      for (; k < m; ++k)
        claim_test(scan_load<VEC>(sim + (size_t)list_u[k] * S, c0, S),
                   list_u[k], list_r[k], alpha, ok, aw, ar, as);
    }
    __syncthreads();     // the next chunk rewrites the list
  }
  if (n == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < S) {
        best_w[c0 + q] = aw[q];
        best_slot[c0 + q] = aw[q] > 0.f ? as[q] : -1;
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (c0 + q < S) {
      const size_t o = (size_t)y * S + c0 + q;
      part_w[o] = aw[q];
      part_r[o] = ar[q];
      part_s[o] = as[q];
    }
  }
  __threadfence();       // the partials before the count that publishes them
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + blockIdx.x, 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (c0 + q < S) {
      float w = 0.f;
      int r = INT_MAX, s = -1;
      for (int j = 0; j < n; ++j) {      // slice order: row order
        const size_t o = (size_t)j * S + c0 + q;
        const float pw = __ldcg(part_w + o);
        const int pr = __ldcg(part_r + o);
        if (pw > w || (pw == w && pr < r)) {
          w = pw;
          r = pr;
          s = __ldcg(part_s + o);
        }
      }
      best_w[c0 + q] = w;
      best_slot[c0 + q] = w > 0.f ? s : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// K8: K5 over [S, K] neighbor lists.
//
// For every list row s: OR over its entries u = ids[s, e] of
//   u >= 0 && sims[s, e] > 0 && sims[s, e] >= alpha && rank[u] < rank[s]
// masked by unresolved[u] (-> blocked[s]) and by is_rep[u] (-> claimed[s]).
//
// Bound: bytes (one read of ids and sims).  Design: one warp per row; the
// lanes read the row's K entries coalesced and gather rank and the two
// flags at the ids (the [S] vectors stay in L2).  A warp vote gives the
// two bits and lane 0 writes both outputs whole: no atomics, no zero fill,
// exact.
// ---------------------------------------------------------------------------
__global__ void topk_round_scan_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ sims,
                                       const int* __restrict__ rank,
                                       const uint8_t* __restrict__ unresolved,
                                       const uint8_t* __restrict__ is_rep,
                                       const float* __restrict__ alpha_p,
                                       float alpha_v, int S, int K,
                                       uint8_t* __restrict__ blocked,
                                       uint8_t* __restrict__ claimed) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S) return;                  // uniform across the warp
  const int s = (int)warp;
  const float alpha = alpha_p ? *alpha_p : alpha_v;
  const int rs = rank[s];
  const size_t base = (size_t)s * K;
  bool b = false, c = false;
  for (int e = lane; e < K; e += 32) {
    const int u = ids[base + e];
    const float v = sims[base + e];
    if (u >= 0 && v > 0.f && v >= alpha && rank[u] < rs) {
      b |= unresolved[u] != 0;
      c |= is_rep[u] != 0;
    }
  }
  b = __any_sync(0xffffffffu, b);
  c = __any_sync(0xffffffffu, c);
  if (lane == 0) {
    blocked[s] = b ? 1 : 0;
    claimed[s] = c ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K9: K6 over [S, K] neighbor lists.
//
// Per valid row s: over entries u = ids[s, e] with is_rep[u] and an
// alpha-edge, the maximum weight, the minimum visit rank among ties;
// best_slot = -1 where the weight is 0.  Invalid rows give (0, -1).
//
// Bound: bytes, one read of the valid rows' ids and sims (8 bytes an
// entry; at dsc_brest's final K = 4,096 about 8,000 of the 32,768 rows).
// A warp that tested each 8-byte entry before loading the next kept one
// entry a lane in flight.  So:
// * a row belongs to L lanes of one warp (L the launcher's: the least
//   power of two, up to 32, covering the row's ceil(K / 4) groups of 4
//   entries; so 32 / L rows a warp at small K: 4 at K = 32);
// * lane l reads groups l, l + L, l + 2L, ... and loads CM_UNROLL of them
//   (an int4 of ids and a float4 of sims each when K % 4 == 0 and both
//   are 16-byte aligned: VEC; otherwise four scalar loads of each, the
//   last group cut at K) before it tests any: 64 bytes a lane in flight;
// * the test reads is_rep[u] only for an entry that passes the weight
//   test (and could still win: v >= the lane's best), rank[u] only for a
//   representative; each lane keeps a running (w, rank, slot);
// * a butterfly of shuffles over the L lanes merges them.  (w desc,
//   rank asc) is a total order (ranks are distinct), so the merge is
//   exact in any order;
// * an invalid row costs its flag load and the two stores.
// cluster/ref.py::topk_claim_max_schedule_ref mirrors the schedule.
// ---------------------------------------------------------------------------
constexpr int CM_THREADS = 256;
constexpr int CM_UNROLL = 2;   // 4.6% ahead of 4 over a run (PERF.md)

__device__ __forceinline__ void claim_test(int u, float v, float alpha,
                                           const int* __restrict__ rank,
                                           const uint8_t* __restrict__ is_rep,
                                           float& aw, int& ar, int& as) {
  if (u >= 0 && v > 0.f && v >= alpha && v >= aw && is_rep[u]) {
    const int r = rank[u];
    if (v > aw || r < ar) {
      aw = v;
      ar = r;
      as = u;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(CM_THREADS)
topk_claim_max_kernel(const int* __restrict__ ids,
                      const float* __restrict__ sims,
                      const int* __restrict__ rank,
                      const uint8_t* __restrict__ is_rep,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ alpha_p, float alpha_v, int S,
                      int K, int L, float* __restrict__ best_w,
                      int* __restrict__ best_slot) {
  const long long g = (long long)blockIdx.x * CM_THREADS + threadIdx.x;
  const long long s = g / L;               // L divides 32: a row's lanes
  const int lane = (int)(g % L);           // share one warp
  const bool live = s < S;                 // every lane reaches the merge
  float aw = 0.f;
  int ar = INT_MAX, as = -1;
  if (live && valid[s]) {
    const float alpha = alpha_p ? *alpha_p : alpha_v;
    const size_t base = (size_t)s * K;
    const int G = (K + 3) / 4;
    for (int g0 = lane; g0 < G; g0 += L * CM_UNROLL) {
      int4 iu[CM_UNROLL];
      float4 fv[CM_UNROLL];
#pragma unroll
      for (int u = 0; u < CM_UNROLL; ++u) {
        const int gi = g0 + u * L;
        iu[u] = make_int4(-1, -1, -1, -1);
        fv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gi < G) {
          const size_t e = base + 4 * (size_t)gi;
          if constexpr (VEC) {
            iu[u] = *reinterpret_cast<const int4*>(ids + e);
            fv[u] = *reinterpret_cast<const float4*>(sims + e);
          } else {
            const int n = min(4, K - 4 * gi);
            iu[u].x = ids[e];
            fv[u].x = sims[e];
            if (n > 1) { iu[u].y = ids[e + 1]; fv[u].y = sims[e + 1]; }
            if (n > 2) { iu[u].z = ids[e + 2]; fv[u].z = sims[e + 2]; }
            if (n > 3) { iu[u].w = ids[e + 3]; fv[u].w = sims[e + 3]; }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < CM_UNROLL; ++u) {
        claim_test(iu[u].x, fv[u].x, alpha, rank, is_rep, aw, ar, as);
        claim_test(iu[u].y, fv[u].y, alpha, rank, is_rep, aw, ar, as);
        claim_test(iu[u].z, fv[u].z, alpha, rank, is_rep, aw, ar, as);
        claim_test(iu[u].w, fv[u].w, alpha, rank, is_rep, aw, ar, as);
      }
    }
  }
  for (int off = L >> 1; off > 0; off >>= 1) {
    const float ow = __shfl_xor_sync(0xffffffffu, aw, off);
    const int orr = __shfl_xor_sync(0xffffffffu, ar, off);
    const int os = __shfl_xor_sync(0xffffffffu, as, off);
    if (ow > aw || (ow == aw && orr < ar)) {
      aw = ow;
      ar = orr;
      as = os;
    }
  }
  if (live && lane == 0) {
    best_w[s] = aw;
    best_slot[s] = aw > 0.f ? as : -1;
  }
}

// ---------------------------------------------------------------------------
// sim_row_moments: per-row (count, sum, sum of squares) of the positive
// entries of a [R, N] float32 matrix, the sufficient statistics of alpha.
//
// It replaces no Pallas kernel: the reference's core/similarity.py::
// sim_row_moments is plain jnp, as is the port's plain version
// (kernels/cluster/ref.py::sim_row_moments_ref).  For each row i and column
// j < N:
//   pos = sim[i, j] > 0 && row_valid[i] && col_valid[j]
//   x   = pos ? sim[i, j] : 0
// count[i] is the number of pos; sum[i] and sumsq[i] sum x and x * x, each
// along the plain version's fixed pairwise tree: the row zero-padded to a
// power of two, then adjacent pairs added level by level.
//
// Bound: bytes, one read of the valid rows (at most R * N * 4: 4.29 GB at
// dsc_brest, 1.28 ms at 3.35 TB/s); col_valid (N bytes) is read again by
// every row, from L1 / L2.
//
// How the design keeps the tree.  The tree is a complete binary tree over
// aligned power-of-two column blocks, so a schedule keeps its order where
// every partial it forms is the sum of one aligned block and it only adds
// the sums of two sibling blocks (IEEE addition is commutative: which
// sibling comes first does not matter, their grouping does).  Every x is
// +0 or positive, so a block of padding sums to +0 and adding it changes
// nothing: columns at or past N read as 0, blocks wholly past N are never
// formed.  x * x is rounded before it is added (the build's -fmad=false
// keeps the multiply and the add apart; __fmul_rn / __fadd_rn spell it
// out).  The count is an integer, summed in any order.  So:
// * one warp a row, one row a block: a row whose row_valid is false
//   writes zeros, loads nothing and frees its block at once (a quarter of
//   the rows are valid at dsc_brest and dsc_sis; there blocks of 8 rows
//   reached 68% of the bound, blocks of one 82%, PERF.md).  A sweep
//   covers MOM_SWEEP aligned columns: lane l loads the 4
//   columns at 128 u + 4 l for u < MOM_UNROLL (16-byte loads, neighbouring
//   lanes on neighbouring addresses, MOM_UNROLL loads in flight a lane; a
//   row stride or pointer that is not 16-byte aligned, and the row's last
//   group, load by scalars) and sums each group as (a + b) + (c + d);
// * shuffles at lane offsets 1, 2, 4, 8, 16 add sibling blocks of 4, 8,
//   ..., 64 columns (a butterfly: every lane ends with its 128-column
//   block's sum), then (b0 + b1) + (b2 + b3) is the sweep's block;
// * successive sweeps are blocks of one size, joined by a binary counter:
//   lane L holds the pending left block of 2^L sweeps, sweep k is added
//   to the pending blocks of k's trailing one bits, lowest first, and
//   waits at the level of k's lowest zero bit; after the last sweep the
//   pending blocks are joined from the lowest level up, each the left
//   sibling of everything after it (whose right part is padding).
// No atomics and no order that depends on scheduling: the order follows
// N alone (tests/test_torch_cluster_scan.py mirrors it on the CPU).
// ---------------------------------------------------------------------------
constexpr int MOM_UNROLL = 4;                 // 128-column groups a sweep
constexpr int MOM_SWEEP = 128 * MOM_UNROLL;
static_assert(MOM_UNROLL == 4, "a sweep's groups join as (0 + 1) + (2 + 3)");

// Columns c0 .. c0 + 3 of one row and their col_valid bytes; a column at
// or past N reads as 0.
template <bool VEC>
__device__ __forceinline__ void mom_load(const float* __restrict__ row,
                                         const uint8_t* __restrict__ cv,
                                         int c0, int N, float4& v,
                                         uchar4& m) {
  if (VEC && c0 + 4 <= N) {
    v = __ldg(reinterpret_cast<const float4*>(row + c0));
    m = __ldg(reinterpret_cast<const uchar4*>(cv + c0));
    return;
  }
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  m = make_uchar4(0, 0, 0, 0);
  if (c0 < N) { v.x = __ldg(row + c0); m.x = __ldg(cv + c0); }
  if (c0 + 1 < N) { v.y = __ldg(row + c0 + 1); m.y = __ldg(cv + c0 + 1); }
  if (c0 + 2 < N) { v.z = __ldg(row + c0 + 2); m.z = __ldg(cv + c0 + 2); }
  if (c0 + 3 < N) { v.w = __ldg(row + c0 + 3); m.w = __ldg(cv + c0 + 3); }
}

// One group of 4 aligned columns: adds its positive count to cnt and
// returns the group's (sum, sum of squares) in tree order.
__device__ __forceinline__ float2 mom_group(float4 v, uchar4 m, int& cnt) {
  const float a[4] = {v.x, v.y, v.z, v.w};
  const bool ok[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
  float x[4], xx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool pos = a[q] > 0.f && ok[q];
    x[q] = pos ? a[q] : 0.f;
    xx[q] = __fmul_rn(x[q], x[q]);
    cnt += pos;
  }
  return make_float2(__fadd_rn(__fadd_rn(x[0], x[1]), __fadd_rn(x[2], x[3])),
                     __fadd_rn(__fadd_rn(xx[0], xx[1]),
                               __fadd_rn(xx[2], xx[3])));
}

// Left + right for both sums (the pair is (sum, sum of squares)).
__device__ __forceinline__ float2 mom_add(float2 l, float2 r) {
  return make_float2(__fadd_rn(l.x, r.x), __fadd_rn(l.y, r.y));
}

__device__ __forceinline__ float2 mom_shfl(float2 v, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane));
}

template <bool VEC>
__global__ void __launch_bounds__(32)
sim_row_moments_kernel(const float* __restrict__ sim, long long ld,
                       const uint8_t* __restrict__ row_valid,
                       const uint8_t* __restrict__ col_valid, int N,
                       int* __restrict__ count, float* __restrict__ sum,
                       float* __restrict__ sumsq) {
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  int cnt = 0;
  float2 total = make_float2(0.f, 0.f);
  if (row_valid[r]) {
    const float* row = sim + (size_t)r * ld;
    const int n_sweeps = (N + MOM_SWEEP - 1) / MOM_SWEEP;
    float2 pending = make_float2(0.f, 0.f);    // lane L: level L's block
    for (int k = 0; k < n_sweeps; ++k) {
      const int c0 = k * MOM_SWEEP + 4 * lane;
      float4 v[MOM_UNROLL];
      uchar4 m[MOM_UNROLL];
#pragma unroll
      for (int u = 0; u < MOM_UNROLL; ++u)
        mom_load<VEC>(row, col_valid, c0 + 128 * u, N, v[u], m[u]);
      float2 b[MOM_UNROLL];
#pragma unroll
      for (int u = 0; u < MOM_UNROLL; ++u) {
        b[u] = mom_group(v[u], m[u], cnt);
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          b[u] = mom_add(b[u], make_float2(
              __shfl_xor_sync(0xffffffffu, b[u].x, off),
              __shfl_xor_sync(0xffffffffu, b[u].y, off)));
      }
      float2 block = mom_add(mom_add(b[0], b[1]), mom_add(b[2], b[3]));
      const int t = __ffs(~k) - 1;               // k's trailing one bits
      for (int L = 0; L < t; ++L)
        block = mom_add(mom_shfl(pending, L), block);
      if (lane == t) pending = block;
    }
    for (int L = 0; L < 31; ++L)
      if ((n_sweeps >> L) & 1) total = mom_add(mom_shfl(pending, L), total);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
  }
  if (lane == 0) {
    count[r] = cnt;
    sum[r] = total.x;
    sumsq[r] = total.y;
  }
}

int rows_per_split(int S, int n_split) {
  return (S + n_split - 1) / n_split;
}

// The staged window of the time-window sweep: the widest of 128, 64 and
// 32 candidate points (no wider than Mc needs) whose dynamic shared
// memory -- `rows` floats of the [M][33] tiles, then the window or, if
// larger, `reuse` floats that the block keeps there once the sweep is done
// -- fits the card's opt-in limit beside the static lane table.  Sets
// a.wp, *smem and the kernel's limit; a row too long for even 32 points is
// refused (cudaErrorInvalidValue, which the wrapper raises).
int sweep_setup(PanelArgs& a, int Mc, long long rows, long long reuse,
                const void* kernel, int* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const auto bytes = [&](int wp) {
    const long long w = window_floats(wp);
    return (rows + (w > reuse ? w : reuse)) * (long long)sizeof(float);
  };
  int need = K1_TC;                        // a power of two >= Mc
  while (need < Mc && need < 128) need *= 2;
  a.wp = 0;
  for (int wp = 128; wp >= 32 && a.wp == 0; wp /= 2)
    if (bytes(wp) + (long long)sizeof(PanelLanes) <= optin)
      a.wp = min(wp, need);
  if (a.wp == 0) return (int)cudaErrorInvalidValue;
  *smem = (int)bytes(a.wp);
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// The launch set-up of K4, K7, K12 and K13: the reverse lanes (n_lane
// panel candidates of one tile per row, per_block rows a block), then the
// window beside the weights and cells [M][33], reused by the ms x ms blocks
// of the scatter.
int panel_setup(PanelArgs& a, int Mc, const void* kernel, int* smem) {
  a.n_lane = 0;
  for (int j = a.c_lo / K1_TC; j <= a.c_hi / K1_TC; ++j)
    a.n_lane = max(a.n_lane, min(a.c_hi, j * K1_TC + K1_TC - 1)
                                 - max(a.c_lo, j * K1_TC) + 1);
  a.per_block = K1_TC / a.n_lane;
  return sweep_setup(a, Mc, 2LL * a.M * kTileStride,
                     (long long)K1_TC * (a.ms * a.ms + 1), kernel, smem);
}

// K2 / K11: the time-window sweep's arguments without slot maps, and the
// window beside the [M][33] weights (and votes).
int vote_setup(PanelArgs& a, int M, int Mc, float delta_t,
               const float* chunk_lo, const float* chunk_hi,
               unsigned long long* stats, int* smem) {
  a = PanelArgs{M, 0, 0, 0, delta_t, nullptr, nullptr, chunk_lo, chunk_hi,
                (Mc + kChunk - 1) / kChunk, 0, 0, 0, 0, 0, 0, 0, stats,
                nullptr, nullptr};
  return sweep_setup(a, Mc, (long long)M * kTileStride, 0,
                     (const void*)stjoin_vote_fused_kernel, smem);
}

// K1 / K10: the time-window sweep's arguments and the window alone.
int join_setup(PanelArgs& a, int Mc, const float* chunk_lo,
               const float* chunk_hi, unsigned long long* stats, int* smem) {
  a = PanelArgs{0, 0, 0, 0, 0.f, nullptr, nullptr, chunk_lo, chunk_hi,
                (Mc + kChunk - 1) / kChunk, 0, 0, 0, 0, 0, 0, 0, stats,
                nullptr, nullptr};
  return sweep_setup(a, Mc, 0, 0, (const void*)stjoin_best_match_kernel,
                     smem);
}

// K1 over every tile (tile_ids null) or K10 over a plan: one block per 64
// reference points.
int join_launch(const JoinOperands& op, long long P, const int* tile_ids,
                int K, const float* chunk_lo, const float* chunk_hi,
                unsigned long long* stats, float* out_w, int* out_idx,
                cudaStream_t stream) {
  PanelArgs a;
  int smem = 0;
  const int err = join_setup(a, op.Mc, chunk_lo, chunk_hi, stats, &smem);
  if (err != 0) return err;
  const long long blocks = (P + kPassPts - 1) / kPassPts;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  stjoin_best_match_kernel<<<(unsigned)blocks, dim3(K1_TC, K1_TY), smem,
                             stream>>>(op, a, P, tile_ids, K, out_w,
                                       out_idx);
  return (int)cudaGetLastError();
}

// K4 / K12: the panel [0, T*ms) written into raw, forward blocks only.
int sim_setup(PanelArgs& a, int T, int M, int C, int Mc, int ms,
              float delta_t, const int* ref_gid, const int* cand_gid,
              const float* chunk_lo, const float* chunk_hi,
              unsigned long long* stats, float* raw, const void* kernel,
              int* smem) {
  if ((long long)T * ms > INT_MAX) return (int)cudaErrorInvalidValue;
  a = PanelArgs{M, ms, 0, T * ms, delta_t, ref_gid, cand_gid, chunk_lo,
                chunk_hi, (Mc + kChunk - 1) / kChunk, 0, 0, C - 1, 0, 0,
                (long long)T * ms, (long long)C * ms, stats, raw, nullptr};
  return panel_setup(a, Mc, kernel, smem);
}

// K6's scratch (int32 words): the row list (S int2), its count, one
// counter a column block and, with more than one slice, the slices'
// partials (w, rank, slot); n_split from the SM count, about 16 blocks an
// SM over the column blocks (returns a CUDA error, or 0).
int claim_layout(int S, int* col_blocks, int* n_split, long long* words) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *col_blocks = max(1, (S + CLAIM_COLS - 1) / CLAIM_COLS);
  *n_split = max(1, min((S + CLAIM_SPLIT_ROWS - 1) / CLAIM_SPLIT_ROWS,
                        16 * n_sm / *col_blocks));
  *words = 2LL * S + 1 + *col_blocks
           + (*n_split > 1 ? 3LL * *n_split * S : 0);
  return 0;
}

}  // namespace

extern "C" {

int stjoin_best_match(const float* rx, const float* ry, const float* rt,
                      const int* rid, const uint8_t* rok, const float* cx,
                      const float* cy, const float* ct, const int* cid,
                      const uint8_t* cok, long long P, int C, int Mc,
                      float eps_sp, float eps_t, const float* chunk_lo,
                      const float* chunk_hi, unsigned long long* stats,
                      float* out_w, int* out_idx, cudaStream_t stream) {
  // the wrapper checks the chunk bounds' shape [C, ceil(Mc / 8)]
  if (P > 0 && C > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    return join_launch(op, P, nullptr, 0, chunk_lo, chunk_hi, stats, out_w,
                       out_idx, stream);
  }
  return (int)cudaGetLastError();
}

int stjoin_vote_fused(const float* rx, const float* ry, const float* rt,
                      const int* rid, const uint8_t* rok, const float* cx,
                      const float* cy, const float* ct, const int* cid,
                      const uint8_t* cok, int T, int M, int C, int Mc,
                      float eps_sp, float eps_t, float delta_t,
                      const float* chunk_lo, const float* chunk_hi,
                      unsigned long long* stats, float* vote, int* words,
                      int W, cudaStream_t stream) {
  // the wrapper checks the chunk bounds' shape [C, ceil(Mc / 8)]
  if (T > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    PanelArgs a;
    int smem = 0;
    const int err = vote_setup(a, M, Mc, delta_t, chunk_lo, chunk_hi, stats,
                               &smem);
    if (err != 0) return err;
    stjoin_vote_fused_kernel<<<T, dim3(K1_TC, K1_TY), smem, stream>>>(
        op, a, nullptr, 0, vote, words, W);
  }
  return (int)cudaGetLastError();
}

int stjoin_sim_fused(const float* rx, const float* ry, const float* rt,
                     const int* rid, const uint8_t* rok, const float* cx,
                     const float* cy, const float* ct, const int* cid,
                     const uint8_t* cok, const int* ref_gid,
                     const int* cand_gid, int T, int M, int C, int Mc, int ms,
                     float eps_sp, float eps_t, float delta_t,
                     const float* chunk_lo, const float* chunk_hi,
                     unsigned long long* stats, float* raw,
                     cudaStream_t stream) {
  if (T > 0 && C > 0 && ms > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const void* kernel = (const void*)stjoin_sim_panel_fused_kernel;
    PanelArgs a;
    int smem = 0;
    const int err = sim_setup(a, T, M, C, Mc, ms, delta_t, ref_gid,
                              cand_gid, chunk_lo, chunk_hi, stats, raw,
                              kernel, &smem);
    if (err != 0) return err;
    const int ntc = (C + K1_TC - 1) / K1_TC;
    const long long blocks = (long long)T * ntc;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    stjoin_sim_panel_fused_kernel<<<(unsigned)blocks, dim3(K1_TC, K1_TY),
                                    smem, stream>>>(op, a, T, 0, ntc, blocks,
                                                    0, 0);
  }
  return (int)cudaGetLastError();
}

int stjoin_sim_panel_fused(const float* rx, const float* ry,
                           const float* rt, const int* rid,
                           const uint8_t* rok, const float* cx,
                           const float* cy, const float* ct, const int* cid,
                           const uint8_t* cok, const int* ref_gid,
                           const int* cand_gid, int T, int M, int C, int Mc,
                           int ms, int p0, int panel, float eps_sp,
                           float eps_t, float delta_t, const float* chunk_lo,
                           const float* chunk_hi, unsigned long long* stats,
                           float* fwd, float* rev, cudaStream_t stream) {
  // the wrapper checks 0 <= p0, p0 + panel <= min(T, C) * ms and the chunk
  // bounds' shape [C, ceil(Mc / 8)]
  if (T > 0 && C > 0 && ms > 0 && panel > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    PanelArgs a{M, ms, p0, panel, delta_t, ref_gid, cand_gid, chunk_lo,
                chunk_hi, (Mc + kChunk - 1) / kChunk, 0, p0 / ms,
                min(C - 1, (p0 + panel - 1) / ms), 0, 0, (long long)T * ms,
                (long long)C * ms, stats, fwd, rev};
    int smem = 0;
    const int err = panel_setup(
        a, Mc, (const void*)stjoin_sim_panel_fused_kernel, &smem);
    if (err != 0) return err;
    const int t_lo = p0 / ms, t_hi = min(T - 1, (p0 + panel - 1) / ms);
    const int ntc = (C + K1_TC - 1) / K1_TC;
    const int j_lo = a.c_lo / K1_TC, n_rev_tiles = a.c_hi / K1_TC - j_lo + 1;
    const long long n_fwd = (long long)(t_hi - t_lo + 1) * ntc;
    const long long blocks =
        n_fwd + ((long long)T * n_rev_tiles + a.per_block - 1) / a.per_block;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    stjoin_sim_panel_fused_kernel<<<(unsigned)blocks, dim3(K1_TC, K1_TY),
                                    smem, stream>>>(op, a, T, t_lo, ntc,
                                                    n_fwd, j_lo, n_rev_tiles);
  }
  return (int)cudaGetLastError();
}

int stjoin_best_match_pruned(const float* rx, const float* ry,
                             const float* rt, const int* rid,
                             const uint8_t* rok, const float* cx,
                             const float* cy, const float* ct, const int* cid,
                             const uint8_t* cok, long long P, int C, int Mc,
                             float eps_sp, float eps_t, const int* tile_ids,
                             int K, const float* chunk_lo,
                             const float* chunk_hi,
                             unsigned long long* stats, float* out_w,
                             int* out_idx, cudaStream_t stream) {
  // the wrapper checks tile_ids [ceil(P / 64), K]: ids in [-1, ceil(C /
  // 32)), ascending and unique per row, -1 only after the last id
  if (P > 0 && C > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    return join_launch(op, P, tile_ids, K, chunk_lo, chunk_hi, stats, out_w,
                       out_idx, stream);
  }
  return (int)cudaGetLastError();
}

int stjoin_vote_fused_pruned(const float* rx, const float* ry,
                             const float* rt, const int* rid,
                             const uint8_t* rok, const float* cx,
                             const float* cy, const float* ct, const int* cid,
                             const uint8_t* cok, int T, int M, int C, int Mc,
                             float eps_sp, float eps_t, float delta_t,
                             const float* chunk_lo, const float* chunk_hi,
                             unsigned long long* stats, float* vote,
                             int* words, int W, const int* tile_ids, int K,
                             cudaStream_t stream) {
  if (T > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    PanelArgs a;
    int smem = 0;
    const int err = vote_setup(a, M, Mc, delta_t, chunk_lo, chunk_hi, stats,
                               &smem);
    if (err != 0) return err;
    stjoin_vote_fused_kernel<<<T, dim3(K1_TC, K1_TY), smem, stream>>>(
        op, a, tile_ids, K, vote, words, W);
  }
  return (int)cudaGetLastError();
}

int stjoin_sim_fused_pruned(const float* rx, const float* ry,
                            const float* rt, const int* rid,
                            const uint8_t* rok, const float* cx,
                            const float* cy, const float* ct, const int* cid,
                            const uint8_t* cok, const int* ref_gid,
                            const int* cand_gid, int T, int M, int C, int Mc,
                            int ms, float eps_sp, float eps_t, float delta_t,
                            const int* pairs, long long n_pairs,
                            const float* chunk_lo, const float* chunk_hi,
                            unsigned long long* stats, float* raw,
                            cudaStream_t stream) {
  if (n_pairs > 0 && ms > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const void* kernel = (const void*)stjoin_sim_panel_fused_pruned_kernel;
    PanelArgs a;
    int smem = 0;
    const int err = sim_setup(a, T, M, C, Mc, ms, delta_t, ref_gid,
                              cand_gid, chunk_lo, chunk_hi, stats, raw,
                              kernel, &smem);
    if (err != 0) return err;
    if (n_pairs > INT_MAX) return (int)cudaErrorInvalidValue;
    stjoin_sim_panel_fused_pruned_kernel<<<(unsigned)n_pairs,
                                           dim3(K1_TC, K1_TY), smem,
                                           stream>>>(
        op, a, reinterpret_cast<const int2*>(pairs), n_pairs, nullptr, 0);
  }
  return (int)cudaGetLastError();
}

int stjoin_sim_panel_fused_pruned(const float* rx, const float* ry,
                                  const float* rt, const int* rid,
                                  const uint8_t* rok, const float* cx,
                                  const float* cy, const float* ct,
                                  const int* cid, const uint8_t* cok,
                                  const int* ref_gid, const int* cand_gid,
                                  int T, int M, int C, int Mc, int ms, int p0,
                                  int panel, float eps_sp, float eps_t,
                                  float delta_t, const int* fwd_pairs,
                                  long long n_fwd, const int* rev_pairs,
                                  long long n_rev, int c_lo, int c_hi,
                                  const float* chunk_lo,
                                  const float* chunk_hi,
                                  unsigned long long* stats, float* fwd,
                                  float* rev,
                                  cudaStream_t stream) {
  // the wrapper checks 0 <= p0, p0 + panel <= min(T, C) * ms and the chunk
  // bounds, and passes c_lo = p0 / ms, c_hi = min(C - 1, (p0 + panel - 1)
  // / ms)
  if (n_fwd + n_rev > 0 && ms > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    PanelArgs a{M, ms, p0, panel, delta_t, ref_gid, cand_gid, chunk_lo,
                chunk_hi, (Mc + kChunk - 1) / kChunk, 0, c_lo, c_hi, 0, 0,
                (long long)T * ms, (long long)C * ms, stats, fwd, rev};
    int smem = 0;
    const int err = panel_setup(
        a, Mc, (const void*)stjoin_sim_panel_fused_pruned_kernel, &smem);
    if (err != 0) return err;
    const long long blocks = n_fwd + (n_rev + a.per_block - 1) / a.per_block;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    stjoin_sim_panel_fused_pruned_kernel<<<(unsigned)blocks,
                                           dim3(K1_TC, K1_TY), smem,
                                           stream>>>(
        op, a, reinterpret_cast<const int2*>(fwd_pairs), n_fwd,
        reinterpret_cast<const int2*>(rev_pairs), n_rev);
  }
  return (int)cudaGetLastError();
}

int chunk_time_bounds(const float* t, const uint8_t* ok, long long R, int N,
                      int chunk, float* lo, float* hi, cudaStream_t stream) {
  // the wrapper checks chunk >= 1
  const int n = (N + chunk - 1) / chunk;
  const long long runs = R * n;
  if (runs > 0) {
    const int threads = 256;
    const long long blocks = (runs + threads - 1) / threads;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    chunk_bounds_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        t, ok, runs, N, chunk, n, lo, hi);
  }
  return (int)cudaGetLastError();
}

int jaccard_window(const uint32_t* masks, const uint8_t* valid, int T,
                   int M, int W, int w, int J, uint32_t* scratch, int blocks,
                   float* d, cudaStream_t stream) {
  // J (a power of two up to 32) and, past the opt-in limit, the scratch of
  // `blocks` blocks come from the wrapper (jaccard/ops.py::slab_plan)
  if (J < 1 || J > 32 || (J & (J - 1))) return (int)cudaErrorInvalidValue;
  if ((long long)T * M > 0) {
    size_t smem = 0;
    unsigned grid = (unsigned)T;
    if (scratch) {
      grid = (unsigned)min(T, blocks);
    } else {
      smem = jaccard_words(M, J) * sizeof(uint32_t);
    }
    const bool vec = W % 4 == 0 && J % 4 == 0
                     && (reinterpret_cast<uintptr_t>(masks) & 15) == 0;
    const void* fn = vec ? (const void*)jaccard_window_kernel<true>
                         : (const void*)jaccard_window_kernel<false>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    if (vec) {
      jaccard_window_kernel<true><<<grid, JW_THREADS, smem, stream>>>(
          masks, valid, T, M, W, w, J, scratch, d);
    } else {
      jaccard_window_kernel<false><<<grid, JW_THREADS, smem, stream>>>(
          masks, valid, T, M, W, w, J, scratch, d);
    }
  }
  return (int)cudaGetLastError();
}

// alpha (K5, K6, K8, K9): *alpha_p on the card where alpha_p is not NULL
// (the engine's threshold, read without a host sync), else alpha_v
int round_scan(const float* sim, const int* rank, const uint8_t* unresolved,
               const uint8_t* is_rep, const float* alpha_p, float alpha_v,
               int S, uint8_t* blocked, uint8_t* claimed,
               cudaStream_t stream) {
  if (S > 0) {
    // u << 2 in the row list must not overflow
    if (S > (INT_MAX >> 2)) return (int)cudaErrorInvalidValue;
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
    // about 32 blocks an SM (four waves of eight) over the column blocks,
    // at least SCAN_THREADS rows a slice
    const int col_blocks = (S + SCAN_COLS - 1) / SCAN_COLS;
    const int n_split = max(1, min(S / SCAN_THREADS, 32 * n_sm / col_blocks));
    const dim3 grid(col_blocks, n_split);
    const int rows = rows_per_split(S, n_split);
    if (S % 4 == 0 && (reinterpret_cast<uintptr_t>(sim) & 15) == 0) {
      round_scan_kernel<true><<<grid, SCAN_THREADS, 0, stream>>>(
          sim, rank, unresolved, is_rep, alpha_p, alpha_v, S, rows, blocked,
          claimed);
    } else {
      round_scan_kernel<false><<<grid, SCAN_THREADS, 0, stream>>>(
          sim, rank, unresolved, is_rep, alpha_p, alpha_v, S, rows, blocked,
          claimed);
    }
  }
  return (int)cudaGetLastError();
}

int claim_max_scratch(int S) {
  if (S < 0 || S > (INT_MAX >> 2)) return -(int)cudaErrorInvalidValue;
  int cb = 0, ns = 0;
  long long words = 0;
  const int err = claim_layout(S, &cb, &ns, &words);
  if (err) return -err;
  return words > INT_MAX ? -(int)cudaErrorInvalidValue : (int)words;
}

// The slices claim_max_kernel cuts a list of R representative rows into
// at S columns on the current card (R = S: the launcher's n_split), or a
// negative CUDA error; cluster/ref.py::claim_splits mirrors the rule.
int claim_max_slices(int S, int R) {
  if (S < 0 || S > (INT_MAX >> 2) || R < 0 || R > S)
    return -(int)cudaErrorInvalidValue;
  int cb = 0, ns = 0;
  long long words = 0;
  const int err = claim_layout(S, &cb, &ns, &words);
  return err ? -err : claim_splits(R, ns);
}

int claim_max(const float* sim, const int* rank, const uint8_t* is_rep,
              const uint8_t* valid, const float* alpha_p, float alpha_v,
              int S, int* scratch, int words, float* best_w, int* best_slot,
              cudaStream_t stream) {
  if (S > 0) {
    if (S > (INT_MAX >> 2) || (reinterpret_cast<uintptr_t>(scratch) & 7))
      return (int)cudaErrorInvalidValue;
    int cb = 0, ns = 0;
    long long need = 0;
    const int err = claim_layout(S, &cb, &ns, &need);
    if (err) return err;
    if (need > words) return (int)cudaErrorInvalidValue;
    int2* list = reinterpret_cast<int2*>(scratch);
    int* count = scratch + 2LL * S;
    int* done = count + 1;
    int* part = done + cb;
    const size_t np = (size_t)ns * S;
    float* part_w = ns > 1 ? reinterpret_cast<float*>(part) : nullptr;
    int* part_r = ns > 1 ? part + np : nullptr;
    int* part_s = ns > 1 ? part + 2 * np : nullptr;
    claim_list_kernel<<<1, LIST_THREADS, 0, stream>>>(is_rep, rank, S, cb,
                                                      list, count, done);
    const cudaError_t lerr = cudaGetLastError();
    if (lerr != cudaSuccess) return (int)lerr;
    const dim3 grid(cb, ns);
    if (S % 4 == 0 && (reinterpret_cast<uintptr_t>(sim) & 15) == 0) {
      claim_max_kernel<true><<<grid, CLAIM_THREADS, 0, stream>>>(
          sim, valid, alpha_p, alpha_v, S, list, count, done, part_w,
          part_r, part_s, best_w, best_slot);
    } else {
      claim_max_kernel<false><<<grid, CLAIM_THREADS, 0, stream>>>(
          sim, valid, alpha_p, alpha_v, S, list, count, done, part_w,
          part_r, part_s, best_w, best_slot);
    }
  }
  return (int)cudaGetLastError();
}

int topk_round_scan(const int* ids, const float* sims, const int* rank,
                    const uint8_t* unresolved, const uint8_t* is_rep,
                    const float* alpha_p, float alpha_v, int S, int K,
                    uint8_t* blocked, uint8_t* claimed, cudaStream_t stream) {
  if (S > 0) {
    const int threads = 256;   // 8 warps, one list row each
    const long long blocks = ((long long)S * 32 + threads - 1) / threads;
    topk_round_scan_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        ids, sims, rank, unresolved, is_rep, alpha_p, alpha_v, S, K, blocked,
        claimed);
  }
  return (int)cudaGetLastError();
}

// The row stride ld is in floats (any ld >= N: a column block of a wider
// matrix needs no copy); 16-byte loads where ld, sim and col_valid allow.
int sim_row_moments(const float* sim, long long ld, const uint8_t* row_valid,
                    const uint8_t* col_valid, int R, int N, int* count,
                    float* sum, float* sumsq, cudaStream_t stream) {
  if (R > 0) {
    const bool vec = ld % 4 == 0
                     && (reinterpret_cast<uintptr_t>(sim) & 15) == 0
                     && (reinterpret_cast<uintptr_t>(col_valid) & 3) == 0;
    if (vec) {
      sim_row_moments_kernel<true><<<(unsigned)R, 32, 0, stream>>>(
          sim, ld, row_valid, col_valid, N, count, sum, sumsq);
    } else {
      sim_row_moments_kernel<false><<<(unsigned)R, 32, 0, stream>>>(
          sim, ld, row_valid, col_valid, N, count, sum, sumsq);
    }
  }
  return (int)cudaGetLastError();
}

int topk_claim_max(const int* ids, const float* sims, const int* rank,
                   const uint8_t* is_rep, const uint8_t* valid,
                   const float* alpha_p, float alpha_v, int S, int K,
                   float* best_w, int* best_slot, cudaStream_t stream) {
  if (S > 0) {
    // lanes a row: the least power of two covering its groups, up to 32
    const int G = (K + 3) / 4;
    int L = 1;
    while (L < 32 && L < G) L <<= 1;
    const long long blocks = ((long long)S * L + CM_THREADS - 1) / CM_THREADS;
    const bool vec = K % 4 == 0
                     && ((reinterpret_cast<uintptr_t>(ids)
                          | reinterpret_cast<uintptr_t>(sims)) & 15) == 0;
    if (vec) {
      topk_claim_max_kernel<true><<<(unsigned)blocks, CM_THREADS, 0,
                                    stream>>>(
          ids, sims, rank, is_rep, valid, alpha_p, alpha_v, S, K, L, best_w,
          best_slot);
    } else {
      topk_claim_max_kernel<false><<<(unsigned)blocks, CM_THREADS, 0,
                                     stream>>>(
          ids, sims, rank, is_rep, valid, alpha_p, alpha_v, S, K, L, best_w,
          best_slot);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
