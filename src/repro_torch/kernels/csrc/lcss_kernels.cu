// Hand-written Hopper (sm_90a) kernel for the exact pairwise LCSS.
//
//   lcss_wavefront  <- repro/kernels/lcss/lcss.py  lcss_pallas (with the
//                      host shear_weights of the same file)
//
// What it computes, per (reference r, candidate s) pair: the weighted
// (Eq. 2) and the classical (Eq. 1) LCSS scores,
//
//   L[i, j] = max(L[i-1, j], L[i, j-1], L[i-1, j-1] + w[i, j]),  L >= 0,
//
// with L[-1, *] = L[*, -1] = 0 and, for matching points (|r_i - s_j| <=
// eps_sp, |t_i - t_j| <= eps_t, both valid), w = 1 - d / eps_sp on channel
// 0 and w = 1 on channel 1; w = NEG = -1e30 otherwise.  Output scores
// [B, 2] = L[N-1, M-1] of both channels.
//
// Bound: operations.  The TPU kernel reads a sheared weight tensor
// [B, 2, N, N+M-1] that the host built (8.6 GB at B = 32,768, N = M =
// 128): a layout for the VPU that is pure traffic here.  This kernel reads
// only the coordinates (13 bytes a point) and forms the weights in
// registers.  Any exact schedule does one maximum a channel and the time
// test on each cell whose points are both valid, the rest of the weight on
// the cells that pass it, and an add and two maxima a channel on the cells
// that match (see lcss_pair).  A row or column whose point is invalid
// matches nothing, so (L being non-decreasing along both axes) it copies
// the row above or the column before exactly and needs no arithmetic.
//
// Design: one warp per pair, the DP in registers.  Lane k owns R = 1, 2
// or 4 consecutive rows (R from N) of a strip of 32 R rows, and the lanes
// walk the candidate's columns skewed by one step a lane: at step t lane
// k computes column j = t - k of its rows, so a strip takes M + 31 steps
// (fewer when its last lanes hold no row).  A lane's top row reads
// L[i-1, j] and L[i-1, j-1] from lane k-1's bottom row by __shfl_up_sync
// (the values of the step before and of the one before that); lane 0
// reads them from the bottom row of the strip above, which lane 31 stored
// as it went (2 channels x M floats a warp, in place: column j is read at
// step j and rewritten at step j + 31).  That carried row lives in
// shared memory while LCSS_WARPS of them fit the card's opt-in limit,
// else in a per-pair global scratch that the wrapper allocates; one strip
// (N <= 128) needs none, and each strip is built for whether it reads and
// writes a carried row.  The candidate's points come through a ring of
// 64 points a warp in shared memory, refilled 32 at a time by coalesced
// loads issued a chunk of 32 steps ahead.  No __syncthreads() and no
// diagonals in memory.
//
// An exact prefilter before the weight: a cell is rejected, with w = NEG
// as in the plain version, when a point is invalid or when dt = |t_i -
// t_j| > eps_t (the plain version requires dt <= eps_t of the same
// rounded dt).  A NaN dt fails no rejecting test: it takes the full path
// and fails there, exactly as in the plain version.  At dsc_brest 98% of
// the valid cells fail the time test, so the weight's square root and
// division run on about one cell a warp-step.  (A second test, |dx| or
// |dy| above eps_sp, is exact while eps_sp >= 2^-63 but rejected only
// 2.6% of the cells past the time test there and cost more than it saved:
// PERF.md.)  kernels/lcss/ref.py::lcss_strip_ref is the schedule's plain
// mirror.
//
// Bit for bit: a cell is three exact maxima and one add, in the same
// order of operands, in the kernel, in the plain sheared wavefront and in
// the plain row scan (repro_torch/kernels/lcss/ref.py), and the weight is
// IEEE arithmetic spelled out with _rn intrinsics (no FMA contraction, a
// correctly rounded square root and division).  So all three agree bit for
// bit, and so does the transposed pair: (s, r) walks the same cells with
// the same weights (dx * dx of -dx is dx * dx).
//
// The launcher has a plain C interface: raw device pointers, sizes and the
// caller's cudaStream_t.  It allocates nothing, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float NEG = -1e30f;
constexpr int LCSS_WARPS = 4;      // pairs a block, one a warp
constexpr int RING = 64;           // candidate points a warp keeps
constexpr unsigned FULL = 0xffffffffu;

// The operands of one pair.
struct Pair {
  const float* rx;
  const float* ry;
  const float* rt;
  const uint8_t* rv;
  const float* sx;
  const float* sy;
  const float* st;
  const uint8_t* sv;
};

// The candidate point j as the ring keeps it: x, y, t and validity.
__device__ __forceinline__ float4 point(const Pair& p, int j) {
  return make_float4(p.sx[j], p.sy[j], p.st[j], p.sv[j] ? 1.f : 0.f);
}

// One strip of rows of one pair (rows s0 .. s0 + 32 R - 1) by one warp, R
// rows a lane.  ABOVE: lane 0 reads the bottom row of the strip above from
// `carry` (2 x M floats, shared or global); BELOW: lane 31 writes this
// strip's bottom row there; the last strip's lane (N-1) / R writes
// out[0..1].
//
// A cell whose points do not match (w = NEG) takes max(L[i, j-1],
// L[i-1, j]): the candidate L[i-1, j-1] + NEG is below -1e29 and every L
// is +0 or positive (a maximum with +0, never -0 or NaN), so neither it
// nor the clamp at 0 can change that maximum.  Only a matching cell
// computes the add and the two maxima after it, in the plain version's
// order.
template <int R, bool ABOVE, bool BELOW>
__device__ __forceinline__ void lcss_strip(const Pair& p, int s0, int N,
                                           int M, float eps_sp, float eps_t,
                                           float4 (&ring)[RING],
                                           float* carry,
                                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int lanes = (min(32 * R, N - s0) + R - 1) / R;
  float px[R], py[R], pt[R], lw[R], lu[R];
  bool pv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = s0 + lane * R + r;
    const bool in = i < N;
    px[r] = in ? p.rx[i] : 0.f;
    py[r] = in ? p.ry[i] : 0.f;
    pt[r] = in ? p.rt[i] : 0.f;
    pv[r] = in && p.rv[i] != 0;
    lw[r] = 0.f;                            // L[i, -1]
    lu[r] = 0.f;
  }
  float bot_w = 0.f, bot_u = 0.f;           // this lane's bottom row at j
  float dg_w = 0.f, dg_u = 0.f;             // the row above at j - 1
  const int steps = M + lanes - 1;
  // candidate points t0 + lane, loaded a chunk of 32 steps ahead
  float4 next = lane < M ? point(p, lane) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t0 = 0; t0 < steps; t0 += 32) {
    __syncwarp();
    if (t0 + lane < M) ring[(t0 + lane) & (RING - 1)] = next;
    __syncwarp();
    if (t0 + 32 + lane < M) next = point(p, t0 + 32 + lane);
    const int n = min(32, steps - t0);
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      float up_w = __shfl_up_sync(FULL, bot_w, 1);
      float up_u = __shfl_up_sync(FULL, bot_u, 1);
      if (lane == 0) {                      // the strip above, or L[-1, *]
        const bool from = ABOVE && t < M;
        up_w = from ? carry[t] : 0.f;
        up_u = from ? carry[M + t] : 0.f;
      }
      const int j = t - lane;
      if (lane < lanes && j >= 0 && j < M) {
        const float4 q = ring[j & (RING - 1)];
        float a_w = up_w, a_u = up_u;       // L[i-1, j]
        float d_w = dg_w, d_u = dg_u;       // L[i-1, j-1]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // L[i, j-1] = lw[r], L[i-1, j] = a, L[i-1, j-1] = d
          float nw = fmaxf(lw[r], a_w);
          float nu = fmaxf(lu[r], a_u);
          const float dt = fabsf(__fsub_rn(pt[r], q.z));
          if (pv[r] && q.w != 0.f && !(dt > eps_t)) {
            const float dx = __fsub_rn(px[r], q.x);
            const float dy = __fsub_rn(py[r], q.y);
            const float dist = __fsqrt_rn(
                __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
            if (dist <= eps_sp && dt <= eps_t) {
              const float w = __fsub_rn(1.f, __fdiv_rn(dist, eps_sp));
              nw = fmaxf(fmaxf(nw, __fadd_rn(d_w, w)), 0.f);
              nu = fmaxf(fmaxf(nu, __fadd_rn(d_u, 1.f)), 0.f);
            }
          }
          d_w = lw[r];
          d_u = lu[r];
          a_w = lw[r] = nw;
          a_u = lu[r] = nu;
        }
        bot_w = lw[R - 1];
        bot_u = lu[R - 1];
        if (BELOW && lane == 31) {
          carry[j] = bot_w;
          carry[M + j] = bot_u;
        }
      }
      dg_w = up_w;
      dg_u = up_u;
    }
  }
  if (!BELOW) {                             // the last strip: row N - 1
    const int last = N - 1 - s0;
    // a chain of selects, not lw[last % R]: an index the compiler cannot
    // resolve would move lw and lu to local memory
    float ow = lw[0], ou = lu[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      ow = last % R == r ? lw[r] : ow;
      ou = last % R == r ? lu[r] : ou;
    }
    if (lane == last / R) {
      out[0] = ow;
      out[1] = ou;
    }
  }
}

// The DP of one pair by one warp: its strips in order, each built for
// whether a strip lies above and below it (one strip, N <= 32 R, has
// neither and touches no carried row).
template <int R>
__device__ void lcss_pair(const Pair& p, int N, int M, float eps_sp,
                          float eps_t, float4 (&ring)[RING], float* carry,
                          float* __restrict__ out) {
  for (int s0 = 0; s0 < N; s0 += 32 * R) {
    const bool above = s0 > 0, below = s0 + 32 * R < N;
    if (above && below) {
      lcss_strip<R, true, true>(p, s0, N, M, eps_sp, eps_t, ring, carry, out);
    } else if (above) {
      lcss_strip<R, true, false>(p, s0, N, M, eps_sp, eps_t, ring, carry,
                                 out);
    } else if (below) {
      lcss_strip<R, false, true>(p, s0, N, M, eps_sp, eps_t, ring, carry,
                                 out);
    } else {
      lcss_strip<R, false, false>(p, s0, N, M, eps_sp, eps_t, ring, carry,
                                  out);
    }
    __syncwarp();                           // the next strip reads carry
  }
}

// Eight blocks an SM (at most 64 registers): at full width 0.79 against
// 0.90 ms at six (80 registers), before the strips were specialised
// (PERF.md).
template <int R>
__global__ void __launch_bounds__(32 * LCSS_WARPS, 8)
lcss_strip_kernel(const float* __restrict__ rx, const float* __restrict__ ry,
                  const float* __restrict__ rt,
                  const uint8_t* __restrict__ rv,
                  const float* __restrict__ sx, const float* __restrict__ sy,
                  const float* __restrict__ st,
                  const uint8_t* __restrict__ sv, int B, int N, int M,
                  float eps_sp, float eps_t, float* scratch,
                  float* __restrict__ out) {
  __shared__ float4 rings[LCSS_WARPS][RING];
  extern __shared__ float carried[];        // [LCSS_WARPS][2][M], if used
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * LCSS_WARPS + warp;
  if (b >= B) return;                       // whole warps only
  float* carry = scratch ? scratch + b * 2 * M : carried + warp * 2 * M;
  const Pair p{rx + b * N, ry + b * N, rt + b * N, rv + b * N,
               sx + b * M, sy + b * M, st + b * M, sv + b * M};
  lcss_pair<R>(p, N, M, eps_sp, eps_t, rings[warp], carry, out + 2 * b);
}

template <int R>
int launch_strips(const float* rx, const float* ry, const float* rt,
                  const uint8_t* rv, const float* sx, const float* sy,
                  const float* st, const uint8_t* sv, int B, int N, int M,
                  float eps_sp, float eps_t, float* scratch, float* scores,
                  cudaStream_t stream) {
  // the carried rows in shared memory: more than one strip, no scratch.
  // The default dynamic limit is 48 KB less the static rings, so the limit
  // is raised for every dynamic part, as sweep_setup does.
  const size_t smem = N > 32 * R && !scratch
      ? sizeof(float) * LCSS_WARPS * 2 * (size_t)M : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        lcss_strip_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + LCSS_WARPS - 1) / LCSS_WARPS;
  lcss_strip_kernel<R><<<blocks, 32 * LCSS_WARPS, smem, stream>>>(
      rx, ry, rt, rv, sx, sy, st, sv, B, N, M, eps_sp, eps_t, scratch,
      scores);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lcss_wavefront(const float* rx, const float* ry, const float* rt,
                   const uint8_t* rv, const float* sx, const float* sy,
                   const float* st, const uint8_t* sv, int B, int N, int M,
                   float eps_sp, float eps_t, float* scratch, float* scores,
                   cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (N <= 32) {
    return launch_strips<1>(rx, ry, rt, rv, sx, sy, st, sv, B, N, M, eps_sp,
                            eps_t, scratch, scores, stream);
  }
  if (N <= 64) {
    return launch_strips<2>(rx, ry, rt, rv, sx, sy, st, sv, B, N, M, eps_sp,
                            eps_t, scratch, scores, stream);
  }
  return launch_strips<4>(rx, ry, rt, rv, sx, sy, st, sv, B, N, M, eps_sp,
                          eps_t, scratch, scores, stream);
}

}  // extern "C"
