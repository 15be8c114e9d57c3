// Hand-written Hopper (sm_90a) kernels for the DSC main path.
//
// Each kernel replaces one Pallas TPU kernel of the JAX package and keeps
// its exact semantics; the plain PyTorch version beside each wrapper
// (repro_torch/kernels/<name>/ref.py) is the oracle it is held against.
//
//   stjoin_best_match  <- repro/kernels/stjoin/stjoin.py  stjoin_pallas
//   jaccard_window     <- repro/kernels/jaccard/jaccard.py jaccard_pallas
//   round_scan         <- repro/kernels/cluster/cluster.py round_scan_pallas
//   claim_max          <- repro/kernels/cluster/cluster.py assign_pallas
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
// K1: dense best-match join.
//
// For every (reference point p, candidate trajectory c): the best weight
// 1 - sqrt(d2)/eps_sp over c's points inside the (eps_sp, eps_t) cylinder,
// same-trajectory pairs skipped, the first point index winning a tie.
//
// Bound: operations (P*C*Mc pair evaluations of about seven f32 ops each,
// against 8*P*C bytes of output).  Design: a block owns 64 reference
// points x 32 candidates.  threadIdx.x walks candidates, so each warp
// writes 32 consecutive outputs of one row; each thread keeps 8 reference
// points in registers and the block stages 32 candidate points of its 32
// candidates at a time in shared memory ([point][candidate], padded, so
// both the staging stores and the per-point reads are conflict-free).
// The candidate points are walked in index order with a strict '>', so
// the first index wins ties exactly as argmax does in the reference.
// ---------------------------------------------------------------------------
constexpr int K1_TC = 32;    // candidates per block (threadIdx.x)
constexpr int K1_TY = 8;     // thread rows per block (threadIdx.y)
constexpr int K1_NP = 8;     // reference points per thread
constexpr int K1_MCH = 32;   // candidate points staged per chunk

__global__ void __launch_bounds__(K1_TC * K1_TY)
stjoin_best_match_kernel(const float* __restrict__ rx,
                         const float* __restrict__ ry,
                         const float* __restrict__ rt,
                         const int* __restrict__ rid,
                         const uint8_t* __restrict__ rok,
                         const float* __restrict__ cx,
                         const float* __restrict__ cy,
                         const float* __restrict__ ct,
                         const int* __restrict__ cid,
                         const uint8_t* __restrict__ cok,
                         long long P, int C, int Mc, float eps_sp,
                         float eps_t, float* __restrict__ out_w,
                         int* __restrict__ out_idx) {
  __shared__ float sx[K1_MCH][K1_TC + 1];
  __shared__ float sy[K1_MCH][K1_TC + 1];
  __shared__ float st[K1_MCH][K1_TC + 1];
  __shared__ uint8_t sok[K1_MCH][K1_TC + 1];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.y * K1_TC;
  const int c = c0 + tx;
  const bool c_in = c < C;
  const int my_cid = c_in ? cid[c] : 0;
  const long long p0 = (long long)blockIdx.x * (K1_TY * K1_NP) + ty;
  const float eps2 = __fmul_rn(eps_sp, eps_sp);

  float px[K1_NP], py[K1_NP], pt[K1_NP], best[K1_NP];
  int arg[K1_NP];
  bool live[K1_NP];
#pragma unroll
  for (int k = 0; k < K1_NP; ++k) {
    const long long p = p0 + (long long)k * K1_TY;
    const bool in = p < P;
    px[k] = in ? rx[p] : 0.f;
    py[k] = in ? ry[p] : 0.f;
    pt[k] = in ? rt[p] : 0.f;
    live[k] = in && c_in && rok[p] && rid[p] != my_cid;
    best[k] = -1.f;
    arg[k] = 0;
  }

  for (int m0 = 0; m0 < Mc; m0 += K1_MCH) {
    // stage: consecutive threads read consecutive points of one candidate
    for (int e = ty * K1_TC + tx; e < K1_MCH * K1_TC; e += K1_TC * K1_TY) {
      const int cl = e / K1_MCH, mm = e % K1_MCH;
      const int cc = c0 + cl, m = m0 + mm;
      const bool ld = cc < C && m < Mc;
      const size_t g = (size_t)cc * Mc + m;
      sx[mm][cl] = ld ? cx[g] : 0.f;
      sy[mm][cl] = ld ? cy[g] : 0.f;
      st[mm][cl] = ld ? ct[g] : 0.f;
      sok[mm][cl] = ld ? cok[g] : 0;
    }
    __syncthreads();
    const int mend = min(K1_MCH, Mc - m0);
    for (int mm = 0; mm < mend; ++mm) {
      const float qx = sx[mm][tx], qy = sy[mm][tx], qt = st[mm][tx];
      const bool qok = sok[mm][tx] != 0;
#pragma unroll
      for (int k = 0; k < K1_NP; ++k) {
        const float dx = __fsub_rn(px[k], qx);
        const float dy = __fsub_rn(py[k], qy);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float dt = fabsf(__fsub_rn(pt[k], qt));
        if (live[k] && qok && d2 <= eps2 && dt <= eps_t) {
          const float w = __fsub_rn(1.f, __fdiv_rn(__fsqrt_rn(d2), eps_sp));
          if (w > best[k]) {
            best[k] = w;
            arg[k] = m0 + mm;
          }
        }
      }
    }
    __syncthreads();
  }

  if (!c_in) return;
#pragma unroll
  for (int k = 0; k < K1_NP; ++k) {
    const long long p = p0 + (long long)k * K1_TY;
    if (p < P) {
      const size_t o = (size_t)p * C + c;
      out_w[o] = best[k] > 0.f ? best[k] : 0.f;
      out_idx[o] = best[k] > 0.f ? arg[k] : -1;
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
    const dim3 block(K1_TC, K1_TY);
    const dim3 grid((unsigned)((P + K1_TY * K1_NP - 1) / (K1_TY * K1_NP)),
                    (unsigned)((C + K1_TC - 1) / K1_TC));
    stjoin_best_match_kernel<<<grid, block, 0, stream>>>(
        rx, ry, rt, rid, rok, cx, cy, ct, cid, cok, P, C, Mc, eps_sp, eps_t,
        out_w, out_idx);
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

}  // extern "C"
