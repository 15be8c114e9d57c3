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
#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// The best-match sweep shared by K1, K2 and K4.
//
// For every (reference point p, candidate trajectory c): the best weight
// 1 - sqrt(d2)/eps_sp over c's points inside the (eps_sp, eps_t) cylinder,
// same-trajectory pairs skipped, the first point index winning a tie.
//
// Bound: operations (about seven f32 instructions per (point, candidate
// point) pair).  Design: a block of 32 x 8 threads owns 64 reference
// points x 32 candidates.  threadIdx.x walks candidates; each thread keeps
// 8 reference points (p0 + threadIdx.y + 8k) in registers, and the block
// stages 32 candidate points of its 32 candidates at a time in shared
// memory ([point][candidate], padded, so both the staging stores and the
// per-point reads are conflict-free).  The candidate points are walked in
// index order with a strict '>', so the first index wins ties exactly as
// argmax does in the reference.  K1, K2 and K4 all call this one function,
// so their matches, weights and indices cannot drift apart.
// ---------------------------------------------------------------------------
constexpr int K1_TC = 32;    // candidates per block (threadIdx.x)
constexpr int K1_TY = 8;     // thread rows per block (threadIdx.y)
constexpr int K1_NP = 8;     // reference points per thread
constexpr int K1_MCH = 32;   // candidate points staged per chunk
constexpr int K1_PTS = K1_TY * K1_NP;   // reference points per sweep
constexpr int kThreads = K1_TC * K1_TY;

struct SweepSmem {
  float x[K1_MCH][K1_TC + 1];
  float y[K1_MCH][K1_TC + 1];
  float t[K1_MCH][K1_TC + 1];
  uint8_t ok[K1_MCH][K1_TC + 1];
};

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

// Every thread of the block must call it: it synchronizes.  Reference
// points p0 + threadIdx.y + 8k below p_end, candidates c0 + threadIdx.x
// below C.  Returns the running (max, argmax) per point; best = -1 where
// nothing matched.
__device__ __forceinline__ void sweep_best(SweepSmem& sm,
                                           const JoinOperands& op,
                                           long long p0, long long p_end,
                                           int c0, float (&best)[K1_NP],
                                           int (&arg)[K1_NP]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;
  const bool c_in = c < op.C;
  const int my_cid = c_in ? op.cid[c] : 0;
  const float eps2 = __fmul_rn(op.eps_sp, op.eps_sp);

  float px[K1_NP], py[K1_NP], pt[K1_NP];
  bool live[K1_NP];
#pragma unroll
  for (int k = 0; k < K1_NP; ++k) {
    const long long p = p0 + ty + (long long)k * K1_TY;
    const bool in = p < p_end;
    px[k] = in ? op.rx[p] : 0.f;
    py[k] = in ? op.ry[p] : 0.f;
    pt[k] = in ? op.rt[p] : 0.f;
    live[k] = in && c_in && op.rok[p] && op.rid[p] != my_cid;
    best[k] = -1.f;
    arg[k] = 0;
  }

  for (int m0 = 0; m0 < op.Mc; m0 += K1_MCH) {
    // stage: consecutive threads read consecutive points of one candidate
    for (int e = ty * K1_TC + tx; e < K1_MCH * K1_TC; e += kThreads) {
      const int cl = e / K1_MCH, mm = e % K1_MCH;
      const int cc = c0 + cl, m = m0 + mm;
      const bool ld = cc < op.C && m < op.Mc;
      const size_t g = (size_t)cc * op.Mc + m;
      sm.x[mm][cl] = ld ? op.cx[g] : 0.f;
      sm.y[mm][cl] = ld ? op.cy[g] : 0.f;
      sm.t[mm][cl] = ld ? op.ct[g] : 0.f;
      sm.ok[mm][cl] = ld ? op.cok[g] : 0;
    }
    __syncthreads();
    const int mend = min(K1_MCH, op.Mc - m0);
    for (int mm = 0; mm < mend; ++mm) {
      const float qx = sm.x[mm][tx], qy = sm.y[mm][tx], qt = sm.t[mm][tx];
      const bool qok = sm.ok[mm][tx] != 0;
#pragma unroll
      for (int k = 0; k < K1_NP; ++k) {
        const float dx = __fsub_rn(px[k], qx);
        const float dy = __fsub_rn(py[k], qy);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float dt = fabsf(__fsub_rn(pt[k], qt));
        if (live[k] && qok && d2 <= eps2 && dt <= op.eps_t) {
          const float w =
              __fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(d2), op.eps_sp));
          if (w > best[k]) {
            best[k] = w;
            arg[k] = m0 + mm;
          }
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K1: dense best-match join -> best_w / best_idx [P, C].
//
// Bound: operations of the sweep against 8*P*C bytes of output.  Design:
// one sweep per block (64 points x 32 candidates); each warp writes 32
// consecutive outputs of one row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stjoin_best_match_kernel(JoinOperands op, long long P,
                         float* __restrict__ out_w,
                         int* __restrict__ out_idx) {
  __shared__ SweepSmem sm;
  const long long p0 = (long long)blockIdx.x * K1_PTS;
  const int c0 = blockIdx.y * K1_TC;
  float best[K1_NP];
  int arg[K1_NP];
  sweep_best(sm, op, p0, P, c0, best, arg);

  const int c = c0 + threadIdx.x;
  if (c >= op.C) return;
#pragma unroll
  for (int k = 0; k < K1_NP; ++k) {
    const long long p = p0 + threadIdx.y + (long long)k * K1_TY;
    if (p < P) {
      const size_t o = (size_t)p * op.C + c;
      out_w[o] = best[k] > 0.f ? best[k] : 0.f;
      out_idx[o] = best[k] > 0.f ? arg[k] : -1;
    }
  }
}

// ---------------------------------------------------------------------------
// The fused passes K2 and K4 work on one reference trajectory row (its M
// points are consecutive in the flat operands) against one tile of 32
// candidates at a time.  sweep_row_tile runs the sweep over the row in
// chunks of 64 points and leaves the tile's weights (0 = no match) and
// winning indices (-1 = none) in shared memory, [m][32] padded to 33.
// refine_tile is the delta_t run refine (DTJ's Refine step): for one
// candidate, a run is a maximal streak of consecutive matched m; it
// survives iff max(t) - min(t) over the run is >= delta_t, exactly the
// test of repro_torch.core.geometry.filter_delta_t.  One thread per
// candidate walks the row in order.  delta_t <= 0 keeps every run.
// ---------------------------------------------------------------------------
constexpr int kTileStride = K1_TC + 1;

__device__ __forceinline__ void sweep_row_tile(SweepSmem& sm,
                                               const JoinOperands& op,
                                               long long row0, int M, int c0,
                                               float* tw, int* tidx) {
  for (int m0 = 0; m0 < M; m0 += K1_PTS) {
    float best[K1_NP];
    int arg[K1_NP];
    sweep_best(sm, op, row0 + m0, row0 + M, c0, best, arg);
#pragma unroll
    for (int k = 0; k < K1_NP; ++k) {
      const int m = m0 + threadIdx.y + k * K1_TY;
      if (m < M) {
        const int e = m * kTileStride + threadIdx.x;
        tw[e] = best[k] > 0.f ? best[k] : 0.f;
        if (tidx != nullptr) tidx[e] = best[k] > 0.f ? arg[k] : -1;
      }
    }
  }
  __syncthreads();
}

// Called by the 32 threads of threadIdx.y == 0 (lane j owns candidate
// c0 + j); the caller synchronizes afterwards.
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

// ---------------------------------------------------------------------------
// K2: fused pass 1 -> vote [P] f32 and, for TSA2, the packed neighbor
// words [P, W] (W = ceil(C/32), bit j of word c0/32 = candidate c0 + j
// matched after the refine).
//
// Bound: operations (the sweep); it writes 4*P*(1 + W) bytes instead of
// K1's 8*P*C.  Design: one block per reference row walks every candidate
// tile in ascending order: sweep, refine, then one thread per point adds
// the tile's 32 refined weights to its running vote and builds the tile's
// word.  So vote[p] is the sum over c in ascending order, one rounded add
// at a time, starting from +0.0 (the plain version's order), with no
// atomics; each word is written whole by one thread.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stjoin_vote_fused_kernel(JoinOperands op, int M, float delta_t,
                         float* __restrict__ vote, int* __restrict__ words,
                         int W) {
  __shared__ SweepSmem sm;
  extern __shared__ float dyn[];
  float* tw = dyn;                        // [M][33]
  float* acc = dyn + M * kTileStride;     // [M]
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  const long long row0 = (long long)blockIdx.x * M;
  for (int m = tid; m < M; m += kThreads) acc[m] = 0.f;

  for (int c0 = 0; c0 < op.C; c0 += K1_TC) {
    sweep_row_tile(sm, op, row0, M, c0, tw, nullptr);
    if (threadIdx.y == 0) refine_tile(tw, nullptr, op.rt + row0, M, delta_t);
    __syncthreads();
    const int nc = min(K1_TC, op.C - c0);
    for (int m = tid; m < M; m += kThreads) {
      float a = acc[m];
      uint32_t word = 0u;
      for (int j = 0; j < nc; ++j) {
        const float w = tw[m * kTileStride + j];
        a = __fadd_rn(a, w);
        word |= (w > 0.f ? 1u : 0u) << j;
      }
      acc[m] = a;
      if (words != nullptr)
        words[(size_t)(row0 + m) * W + c0 / K1_TC] = (int)word;
    }
    __syncthreads();
  }
  for (int m = tid; m < M; m += kThreads) vote[row0 + m] = acc[m];
}

// The scatter of one (row t, tile of candidates from c0) block of K4 and
// K7 into shared memory: blk[j][i*ms + k] (padded to ms*ms + 1 per
// candidate) sums, in ascending m, the refined weights of row t's point m
// whose ref slot is t*ms + i and whose matched point of candidate c0 + j
// has the slot (c0 + j)*ms + k.  Every thread calls it: it synchronizes.
__device__ __forceinline__ void sim_block(SweepSmem& sm,
                                          const JoinOperands& op, int M,
                                          float delta_t,
                                          const int* __restrict__ ref_gid,
                                          const int* __restrict__ cand_gid,
                                          int ms, long long t, int c0,
                                          float* dyn) {
  const int bs = ms * ms + 1;                             // padded block
  float* tw = dyn;                                        // [M][33]
  int* tidx = reinterpret_cast<int*>(dyn + M * kTileStride);  // [M][33]
  float* blk = dyn + 2 * M * kTileStride;                 // [32][bs]
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  const long long row0 = t * M;
  for (int e = tid; e < K1_TC * bs; e += kThreads) blk[e] = 0.f;

  sweep_row_tile(sm, op, row0, M, c0, tw, tidx);
  if (threadIdx.y == 0) {
    refine_tile(tw, tidx, op.rt + row0, M, delta_t);
    const int j = threadIdx.x, c = c0 + j;
    if (c < op.C) {
      float* b = blk + j * bs;
      for (int m = 0; m < M; ++m) {
        const float w = tw[m * kTileStride + j];
        if (!(w > 0.f)) continue;
        const int src = ref_gid[row0 + m];
        const int dst = cand_gid[(size_t)c * op.Mc + tidx[m * kTileStride + j]];
        const long long i = (long long)src - t * ms;      // sentinels fall
        const long long k = (long long)dst - (long long)c * ms;  // outside
        if (i < 0 || i >= ms || k < 0 || k >= ms) continue;
        b[i * ms + k] = __fadd_rn(b[i * ms + k], w);
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K4: fused pass 2 -> raw [T*ms, C*ms] f32, the un-normalized similarity
// scatter: raw[ref_gid[p], cand_gid[c, idx]] += w for every refined match.
//
// The slot maps are block-structured: ref_gid of row t lies in
// [t*ms, (t+1)*ms) or is the sentinel T*ms, cand_gid of candidate c in
// [c*ms, (c+1)*ms) or the sentinel C*ms (the wrapper checks this).  So
// the work of one (row t, candidate c) pair writes one ms x ms block of
// raw and nothing else.
//
// Bound: bytes (every cell of raw written once).  Design: one block per
// (row t, tile of 32 candidates): sweep with argmax, refine, then lane j
// owns candidate c0 + j and walks m in ascending order, adding each
// weight into its ms x ms block in shared memory (sim_block) -- each cell
// sums in the reference's flat (t, m, c) order, one rounded add at a time
// from +0.0, without atomics.  Finally the block writes its [ms, 32*ms]
// slab of raw whole (zeros included), so raw needs no zero fill.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stjoin_sim_fused_kernel(JoinOperands op, int M, float delta_t,
                        const int* __restrict__ ref_gid,
                        const int* __restrict__ cand_gid, int ms,
                        long long n_dst, float* __restrict__ raw) {
  __shared__ SweepSmem sm;
  extern __shared__ float dyn[];
  const long long t = blockIdx.x;
  const int c0 = blockIdx.y * K1_TC;
  sim_block(sm, op, M, delta_t, ref_gid, cand_gid, ms, t, c0, dyn);
  const int bs = ms * ms + 1;
  const float* blk = dyn + 2 * M * kTileStride;
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  const int ncols = min(K1_TC, op.C - c0) * ms;
  for (int e = tid; e < ms * ncols; e += kThreads) {
    const int i = e / ncols, col = e % ncols;
    const int cl = col / ms, k = col % ms;
    raw[(size_t)(t * ms + i) * n_dst + (size_t)c0 * ms + col] =
        blk[cl * bs + i * ms + k];
  }
}

// ---------------------------------------------------------------------------
// K7: fused pass 2 for one panel of slots [p0, p0 + panel), in both
// orientations: fwd[i, j] = raw[p0 + i, j] ([panel, C*ms]) and
// rev[i, j] = raw[j, p0 + i] ([panel, T*ms]), bit for bit K4's cells.
//
// With the block slot maps only few pairs reach a panel: fwd needs the
// rows t_lo..t_hi that own a panel slot against every candidate, rev
// every row against the candidates c_lo..c_hi that own one (rev[i, j]
// comes from the pair (row j / ms, candidate (p0 + i) / ms)).  The TPU
// kernel re-sweeps all T*C pairs per panel; this one sweeps about
// 2 * (panel / ms + 1) * T pairs of trajectories.
//
// Bound: bytes (the two slabs written once) or the panel's share of the
// needed pairs.  Design: one launch per panel; the first n_rows * ntc
// blocks are K4's blocks of the panel's rows (one per row and tile of 32
// candidates), the rest one per (row, tile of the panel's candidates,
// which start at c_lo).  Each runs K4's sim_block, so every cell sums the
// same weights in the same m order as K4's raw, then writes only the
// cells whose slot lies inside the panel (a panel may split a
// trajectory's slots).  Between them the blocks write every cell of both
// slabs, so neither needs a zero fill.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stjoin_sim_panel_fused_kernel(JoinOperands op, int M, float delta_t,
                              const int* __restrict__ ref_gid,
                              const int* __restrict__ cand_gid, int ms,
                              int p0, int panel, int t_lo, int ntc,
                              long long n_fwd_blocks, int c_lo, int c_hi,
                              long long n_src, long long n_dst,
                              float* __restrict__ fwd,
                              float* __restrict__ rev) {
  __shared__ SweepSmem sm;
  extern __shared__ float dyn[];
  const long long b = blockIdx.x;
  const bool forward = b < n_fwd_blocks;
  JoinOperands o = op;
  long long t;
  int c0;
  if (forward) {
    t = t_lo + b / ntc;
    c0 = (int)(b % ntc) * K1_TC;
  } else {
    const long long r = b - n_fwd_blocks;
    const int ntr = (c_hi - c_lo) / K1_TC + 1;
    t = r / ntr;
    c0 = c_lo + (int)(r % ntr) * K1_TC;
    o.C = c_hi + 1;            // the sweep stops at the panel's candidates
  }
  sim_block(sm, o, M, delta_t, ref_gid, cand_gid, ms, t, c0, dyn);
  const int bs = ms * ms + 1;
  const float* blk = dyn + 2 * M * kTileStride;
  const int tid = threadIdx.y * K1_TC + threadIdx.x;
  const int nc = min(K1_TC, o.C - c0);
  if (forward) {
    // rows i of the block whose slot t*ms + i lies in the panel
    const long long s0 = t * ms;
    const int i_lo = p0 > s0 ? (int)(p0 - s0) : 0;
    const int i_hi = p0 + panel < s0 + ms ? (int)(p0 + panel - s0) : ms;
    const int ncols = nc * ms;
    for (int e = tid; e < (i_hi - i_lo) * ncols; e += kThreads) {
      const int i = i_lo + e / ncols, col = e % ncols;
      const int cl = col / ms, k = col % ms;
      fwd[(size_t)(s0 + i - p0) * n_dst + (size_t)c0 * ms + col] =
          blk[cl * bs + i * ms + k];
    }
  } else {
    // cells (i, k) whose candidate slot (c0 + cl)*ms + k lies in the
    // panel; rev row = that slot - p0, rev column = t*ms + i
    for (int e = tid; e < nc * ms * ms; e += kThreads) {
      const int i = e % ms, k = (e / ms) % ms, cl = e / (ms * ms);
      const long long slot = (long long)(c0 + cl) * ms + k;
      if (slot < p0 || slot >= (long long)p0 + panel) continue;
      rev[(size_t)(slot - p0) * n_src + (size_t)t * ms + i] =
          blk[cl * bs + i * ms + k];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: TSA2's windowed Jaccard signal.
//
// d[t, m] = 1 - popc(l1 & l2) / popc(l1 | l2) with l1 the OR of the packed
// neighbor words over [m-w, m-1] and l2 over [m, m+w-1] (zeros off the
// edge), 0 where the union is empty.
//
// Bound: bytes (one read of the [T, M, W] words).  Design: one warp per
// (t, m); lanes walk the W words of a row, so every row read is coalesced
// and the 2w rows a warp ORs are shared with its neighbors through L1.
// The two counts are integers (exact in f32), so d is bit-identical to
// the reference's division.
// ---------------------------------------------------------------------------
__global__ void jaccard_window_kernel(const uint32_t* __restrict__ masks,
                                      int T, int M, int W, int w,
                                      float* __restrict__ d) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)T * M) return;   // uniform across the warp
  const int t = (int)(warp / M), m = (int)(warp % M);
  const uint32_t* row = masks + (size_t)t * M * W;
  const int a0 = max(m - w, 0), a1 = m - 1;
  const int b0 = m, b1 = min(m + w - 1, M - 1);
  int inter = 0, uni = 0;
  for (int j = lane; j < W; j += 32) {
    uint32_t l1 = 0u, l2 = 0u;
    for (int k = a0; k <= a1; ++k) l1 |= row[(size_t)k * W + j];
    for (int k = b0; k <= b1; ++k) l2 |= row[(size_t)k * W + j];
    inter += __popc(l1 & l2);
    uni += __popc(l1 | l2);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    inter += __shfl_xor_sync(0xffffffffu, inter, off);
    uni += __shfl_xor_sync(0xffffffffu, uni, off);
  }
  if (lane == 0) {
    d[warp] = uni > 0
        ? __fsub_rn(1.f, __fdiv_rn((float)inter, (float)max(uni, 1)))
        : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K5: one round of the round-parallel clustering engine.
//
// For every column s: OR over rows u of
//   sim[u, s] > 0 && sim[u, s] >= alpha && rank[u] < rank[s]
// masked by unresolved[u] (-> blocked[s]) and by is_rep[u] (-> claimed[s]).
//
// Bound: bytes (one read of the rows of the [S, S] matrix whose mask bits
// are set).  Design: one thread per column walks a slice of the rows, so
// a warp reads 32 consecutive floats of row u; rows with neither mask bit
// are skipped (the test is uniform across the warp).  The rows are split
// over gridDim.y slices to fill the card; a slice that finds a predicate
// stores 1 into the zeroed output, and every such store writes the same
// value, so the OR needs no atomics and is exact.
// ---------------------------------------------------------------------------
__global__ void round_scan_kernel(const float* __restrict__ sim,
                                  const int* __restrict__ rank,
                                  const uint8_t* __restrict__ unresolved,
                                  const uint8_t* __restrict__ is_rep,
                                  float alpha, int S, int rows_per_split,
                                  uint8_t* __restrict__ blocked,
                                  uint8_t* __restrict__ claimed) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int u0 = blockIdx.y * rows_per_split;
  const int u1 = min(S, u0 + rows_per_split);
  const int rs = rank[s];
  bool b = false, c = false;
  for (int u = u0; u < u1; ++u) {
    const bool fu = unresolved[u] != 0, fr = is_rep[u] != 0;
    if (!(fu || fr)) continue;
    const float v = sim[(size_t)u * S + s];
    const bool pred = v > 0.f && v >= alpha && rank[u] < rs;
    b |= pred && fu;
    c |= pred && fr;
  }
  if (b) blocked[s] = 1;
  if (c) claimed[s] = 1;
}

// ---------------------------------------------------------------------------
// K6: the claim-max over representative rows.
//
// Per column s (valid): over rows u with is_rep[u] and an alpha-edge
// (sim > 0 && sim >= alpha), the maximum weight, the minimum visit rank
// among ties; best_slot = -1 where the weight is 0.
//
// Bound: bytes (one read of the representative rows of [S, S]).  Design:
// K5's layout, with a running (w, rank, slot) per column and thread.  Each
// row slice writes its partial state to scratch; a second pass merges the
// slices per column.  (weight desc, rank asc) is a total order on the
// candidates because ranks are distinct, so the merge is exact in any
// order.
// ---------------------------------------------------------------------------
__global__ void claim_max_partial_kernel(const float* __restrict__ sim,
                                         const int* __restrict__ rank,
                                         const uint8_t* __restrict__ is_rep,
                                         const uint8_t* __restrict__ valid,
                                         float alpha, int S,
                                         int rows_per_split,
                                         float* __restrict__ part_w,
                                         int* __restrict__ part_rank,
                                         int* __restrict__ part_slot) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int u0 = blockIdx.y * rows_per_split;
  const int u1 = min(S, u0 + rows_per_split);
  float aw = 0.f;
  int ar = INT_MAX, as = -1;
  if (valid[s]) {
    for (int u = u0; u < u1; ++u) {
      if (!is_rep[u]) continue;
      const float v = sim[(size_t)u * S + s];
      if (v > 0.f && v >= alpha) {
        const int r = rank[u];
        if (v > aw || (v == aw && r < ar)) {
          aw = v;
          ar = r;
          as = u;
        }
      }
    }
  }
  const size_t o = (size_t)blockIdx.y * S + s;
  part_w[o] = aw;
  part_rank[o] = ar;
  part_slot[o] = as;
}

__global__ void claim_max_merge_kernel(const float* __restrict__ part_w,
                                       const int* __restrict__ part_rank,
                                       const int* __restrict__ part_slot,
                                       int S, int n_split,
                                       float* __restrict__ best_w,
                                       int* __restrict__ best_slot) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float aw = 0.f;
  int ar = INT_MAX, as = -1;
  for (int k = 0; k < n_split; ++k) {
    const size_t o = (size_t)k * S + s;
    const float v = part_w[o];
    const int r = part_rank[o];
    if (v > aw || (v == aw && r < ar)) {
      aw = v;
      ar = r;
      as = part_slot[o];
    }
  }
  best_w[s] = aw;
  best_slot[s] = aw > 0.f ? as : -1;
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
                                       float alpha, int S, int K,
                                       uint8_t* __restrict__ blocked,
                                       uint8_t* __restrict__ claimed) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S) return;                  // uniform across the warp
  const int s = (int)warp;
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
// best_slot = -1 where the weight is 0.
//
// Bound: bytes (one read of ids and sims).  Design: one warp per row; each
// lane keeps a running (w, rank, slot) over its entries, then a butterfly
// of shuffles merges the lanes.  (weight desc, rank asc) is a total order
// (ranks are distinct), so the merge is exact in any order.
// ---------------------------------------------------------------------------
__global__ void topk_claim_max_kernel(const int* __restrict__ ids,
                                      const float* __restrict__ sims,
                                      const int* __restrict__ rank,
                                      const uint8_t* __restrict__ is_rep,
                                      const uint8_t* __restrict__ valid,
                                      float alpha, int S, int K,
                                      float* __restrict__ best_w,
                                      int* __restrict__ best_slot) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= S) return;                  // uniform across the warp
  const int s = (int)warp;
  float aw = 0.f;
  int ar = INT_MAX, as = -1;
  if (valid[s]) {
    const size_t base = (size_t)s * K;
    for (int e = lane; e < K; e += 32) {
      const int u = ids[base + e];
      const float v = sims[base + e];
      if (u >= 0 && v > 0.f && v >= alpha && is_rep[u]) {
        const int r = rank[u];
        if (v > aw || (v == aw && r < ar)) {
          aw = v;
          ar = r;
          as = u;
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ow = __shfl_xor_sync(0xffffffffu, aw, off);
    const int orr = __shfl_xor_sync(0xffffffffu, ar, off);
    const int os = __shfl_xor_sync(0xffffffffu, as, off);
    if (ow > aw || (ow == aw && orr < ar)) {
      aw = ow;
      ar = orr;
      as = os;
    }
  }
  if (lane == 0) {
    best_w[s] = aw;
    best_slot[s] = aw > 0.f ? as : -1;
  }
}

constexpr int kColThreads = 128;

int rows_per_split(int S, int n_split) {
  return (S + n_split - 1) / n_split;
}

}  // namespace

extern "C" {

int stjoin_best_match(const float* rx, const float* ry, const float* rt,
                      const int* rid, const uint8_t* rok, const float* cx,
                      const float* cy, const float* ct, const int* cid,
                      const uint8_t* cok, long long P, int C, int Mc,
                      float eps_sp, float eps_t, float* out_w, int* out_idx,
                      cudaStream_t stream) {
  if (P > 0 && C > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const dim3 block(K1_TC, K1_TY);
    const dim3 grid((unsigned)((P + K1_PTS - 1) / K1_PTS),
                    (unsigned)((C + K1_TC - 1) / K1_TC));
    stjoin_best_match_kernel<<<grid, block, 0, stream>>>(op, P, out_w,
                                                         out_idx);
  }
  return (int)cudaGetLastError();
}

int stjoin_vote_fused(const float* rx, const float* ry, const float* rt,
                      const int* rid, const uint8_t* rok, const float* cx,
                      const float* cy, const float* ct, const int* cid,
                      const uint8_t* cok, int T, int M, int C, int Mc,
                      float eps_sp, float eps_t, float delta_t, float* vote,
                      int* words, int W, cudaStream_t stream) {
  if (T > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const int smem = M * (kTileStride + 1) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        stjoin_vote_fused_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stjoin_vote_fused_kernel<<<T, dim3(K1_TC, K1_TY), smem, stream>>>(
        op, M, delta_t, vote, words, W);
  }
  return (int)cudaGetLastError();
}

int stjoin_sim_fused(const float* rx, const float* ry, const float* rt,
                     const int* rid, const uint8_t* rok, const float* cx,
                     const float* cy, const float* ct, const int* cid,
                     const uint8_t* cok, const int* ref_gid,
                     const int* cand_gid, int T, int M, int C, int Mc, int ms,
                     float eps_sp, float eps_t, float delta_t, float* raw,
                     cudaStream_t stream) {
  if (T > 0 && C > 0 && ms > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const int smem =
        (2 * M * kTileStride + K1_TC * (ms * ms + 1)) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        stjoin_sim_fused_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)T, (unsigned)((C + K1_TC - 1) / K1_TC));
    stjoin_sim_fused_kernel<<<grid, dim3(K1_TC, K1_TY), smem, stream>>>(
        op, M, delta_t, ref_gid, cand_gid, ms, (long long)C * ms, raw);
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
                           float eps_t, float delta_t, float* fwd,
                           float* rev, cudaStream_t stream) {
  // the wrapper checks 0 <= p0 and p0 + panel <= min(T, C) * ms
  if (T > 0 && C > 0 && ms > 0 && panel > 0) {
    const JoinOperands op{rx, ry, rt, rid, rok, cx, cy, ct, cid, cok,
                          C, Mc, eps_sp, eps_t};
    const int smem =
        (2 * M * kTileStride + K1_TC * (ms * ms + 1)) * (int)sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        stjoin_sim_panel_fused_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int t_lo = p0 / ms, t_hi = min(T - 1, (p0 + panel - 1) / ms);
    const int c_lo = p0 / ms, c_hi = min(C - 1, (p0 + panel - 1) / ms);
    const int ntc = (C + K1_TC - 1) / K1_TC;
    const int ntr = (c_hi - c_lo) / K1_TC + 1;
    const long long n_fwd = (long long)(t_hi - t_lo + 1) * ntc;
    const long long blocks = n_fwd + (long long)T * ntr;
    stjoin_sim_panel_fused_kernel<<<(unsigned)blocks, dim3(K1_TC, K1_TY),
                                    smem, stream>>>(
        op, M, delta_t, ref_gid, cand_gid, ms, p0, panel, t_lo, ntc, n_fwd,
        c_lo, c_hi, (long long)T * ms, (long long)C * ms, fwd, rev);
  }
  return (int)cudaGetLastError();
}

int jaccard_window(const uint32_t* masks, int T, int M, int W, int w,
                   float* d, cudaStream_t stream) {
  const long long n = (long long)T * M;
  if (n > 0) {
    const int threads = 256;   // 8 warps, one (t, m) each
    const long long blocks = (n * 32 + threads - 1) / threads;
    jaccard_window_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        masks, T, M, W, w, d);
  }
  return (int)cudaGetLastError();
}

int round_scan(const float* sim, const int* rank, const uint8_t* unresolved,
               const uint8_t* is_rep, float alpha, int S, int n_split,
               uint8_t* blocked, uint8_t* claimed, cudaStream_t stream) {
  if (S > 0) {
    const dim3 grid((S + kColThreads - 1) / kColThreads, n_split);
    round_scan_kernel<<<grid, kColThreads, 0, stream>>>(
        sim, rank, unresolved, is_rep, alpha, S, rows_per_split(S, n_split),
        blocked, claimed);
  }
  return (int)cudaGetLastError();
}

int claim_max(const float* sim, const int* rank, const uint8_t* is_rep,
              const uint8_t* valid, float alpha, int S, float* part_w,
              int* part_rank, int* part_slot, int n_split, float* best_w,
              int* best_slot, cudaStream_t stream) {
  if (S > 0) {
    const dim3 grid((S + kColThreads - 1) / kColThreads, n_split);
    claim_max_partial_kernel<<<grid, kColThreads, 0, stream>>>(
        sim, rank, is_rep, valid, alpha, S, rows_per_split(S, n_split),
        part_w, part_rank, part_slot);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    claim_max_merge_kernel<<<(S + kColThreads - 1) / kColThreads,
                             kColThreads, 0, stream>>>(
        part_w, part_rank, part_slot, S, n_split, best_w, best_slot);
  }
  return (int)cudaGetLastError();
}

int topk_round_scan(const int* ids, const float* sims, const int* rank,
                    const uint8_t* unresolved, const uint8_t* is_rep,
                    float alpha, int S, int K, uint8_t* blocked,
                    uint8_t* claimed, cudaStream_t stream) {
  if (S > 0) {
    const int threads = 256;   // 8 warps, one list row each
    const long long blocks = ((long long)S * 32 + threads - 1) / threads;
    topk_round_scan_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        ids, sims, rank, unresolved, is_rep, alpha, S, K, blocked, claimed);
  }
  return (int)cudaGetLastError();
}

int topk_claim_max(const int* ids, const float* sims, const int* rank,
                   const uint8_t* is_rep, const uint8_t* valid, float alpha,
                   int S, int K, float* best_w, int* best_slot,
                   cudaStream_t stream) {
  if (S > 0) {
    const int threads = 256;   // 8 warps, one list row each
    const long long blocks = ((long long)S * 32 + threads - 1) / threads;
    topk_claim_max_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        ids, sims, rank, is_rep, valid, alpha, S, K, best_w, best_slot);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
