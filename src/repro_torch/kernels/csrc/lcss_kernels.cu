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
// only the coordinates (13 bytes a point) and forms w and the unit weight
// of each cell in registers, so its work is about 20 f32 instructions a
// cell (12 for the weight where both points are valid, 4 a channel for the
// DP) and its bytes are a hundredth of that time.
//
// Design: one block per pair; thread k owns the rows i = k, k + blockDim,
// ...  The block walks the N + M - 1 anti-diagonals d = i + j in order;
// every cell of one diagonal depends only on the two before it, so the
// three most recent diagonals of both channels live in shared memory and
// one __syncthreads() per diagonal separates them.  The candidate's
// points and the reference's points are staged in shared memory once.
// The diagonals start at 0; cells with j < 0 are written 0 (the L[*, -1]
// boundary); cells with j >= M are never read by a cell with j < M and
// are written 0 too.
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
constexpr int LCSS_THREADS = 128;

__global__ void __launch_bounds__(LCSS_THREADS)
lcss_wavefront_kernel(const float* __restrict__ rx,
                      const float* __restrict__ ry,
                      const float* __restrict__ rt,
                      const uint8_t* __restrict__ rv,
                      const float* __restrict__ sx,
                      const float* __restrict__ sy,
                      const float* __restrict__ st,
                      const uint8_t* __restrict__ sv, int N, int M,
                      float eps_sp, float eps_t, float* __restrict__ out) {
  extern __shared__ float smem[];
  // diag[k][c][i]: diagonal d = k mod 3, channel c, row i
  float* diag = smem;                       // 3 * 2 * N
  float* px = diag + 6 * N;                 // reference x, y, t, valid
  float* py = px + N;
  float* pt = py + N;
  float* pv = pt + N;
  float* qx = pv + N;                       // candidate x, y, t, valid
  float* qy = qx + M;
  float* qt = qy + M;
  float* qv = qt + M;
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long long o = b * N + i;
    px[i] = rx[o];
    py[i] = ry[o];
    pt[i] = rt[o];
    pv[i] = rv[o] ? 1.f : 0.f;
  }
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    const long long o = b * M + j;
    qx[j] = sx[o];
    qy[j] = sy[o];
    qt[j] = st[o];
    qv[j] = sv[o] ? 1.f : 0.f;
  }
  for (int i = threadIdx.x; i < 6 * N; i += blockDim.x) diag[i] = 0.f;
  __syncthreads();

  const int D = N + M - 1;
  for (int d = 0; d < D; ++d) {
    float* d0 = diag + 2 * N * (d % 3);          // written now
    const float* d1 = diag + 2 * N * ((d + 2) % 3);   // d - 1
    const float* d2 = diag + 2 * N * ((d + 1) % 3);   // d - 2
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const int j = d - i;
      if (j < 0 || j >= M) {
        d0[i] = 0.f;
        d0[N + i] = 0.f;
        continue;
      }
      float w = NEG, u = NEG;
      if (pv[i] != 0.f && qv[j] != 0.f) {
        const float dx = __fsub_rn(px[i], qx[j]);
        const float dy = __fsub_rn(py[i], qy[j]);
        const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                __fmul_rn(dy, dy)));
        const float dt = fabsf(__fsub_rn(pt[i], qt[j]));
        if (dist <= eps_sp && dt <= eps_t) {
          w = __fsub_rn(1.f, __fdiv_rn(dist, eps_sp));
          u = 1.f;
        }
      }
      // L[i, j-1] = d1[i]; L[i-1, j] = d1[i-1]; L[i-1, j-1] = d2[i-1];
      // row -1 reads 0 (shift_down of the TPU kernel)
      const bool top = i > 0;
      const float lw = fmaxf(fmaxf(d1[i], top ? d1[i - 1] : 0.f),
                             __fadd_rn(top ? d2[i - 1] : 0.f, w));
      const float lu = fmaxf(fmaxf(d1[N + i], top ? d1[N + i - 1] : 0.f),
                             __fadd_rn(top ? d2[N + i - 1] : 0.f, u));
      d0[i] = fmaxf(lw, 0.f);
      d0[N + i] = fmaxf(lu, 0.f);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float* last = diag + 2 * N * ((D - 1) % 3);
    out[2 * b] = last[N - 1];
    out[2 * b + 1] = last[2 * N - 1];
  }
}

// Shared memory of one block: three diagonals of both channels and both
// sequences' points (x, y, t, valid), in floats.
size_t lcss_smem_bytes(int N, int M) {
  return sizeof(float) * (6 * (size_t)N + 4 * (size_t)N + 4 * (size_t)M);
}

}  // namespace

extern "C" {

int lcss_wavefront(const float* rx, const float* ry, const float* rt,
                   const uint8_t* rv, const float* sx, const float* sy,
                   const float* st, const uint8_t* sv, int B, int N, int M,
                   float eps_sp, float eps_t, float* scores,
                   cudaStream_t stream) {
  if (B > 0) {
    const size_t smem = lcss_smem_bytes(N, M);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(lcss_wavefront_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    const int threads = N < LCSS_THREADS ? ((N + 31) / 32) * 32
                                         : LCSS_THREADS;
    lcss_wavefront_kernel<<<B, threads, smem, stream>>>(
        rx, ry, rt, rv, sx, sy, st, sv, N, M, eps_sp, eps_t, scores);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
