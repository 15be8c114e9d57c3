// Hand-written Hopper (sm_90a) kernel for the attention forward pass.
//
//   flash_attention_fwd  <- repro/kernels/attention/flash.py
//                           flash_attention_fwd
//
// What it computes: GQA attention, q [B, Lq, KV, G, hd] against k, v
// [B, M, KV, hd] (float32 or bfloat16), out = softmax(mask(cap(q k^T))) v
// in q's shape and type, with the mask algebra of flash.py:
//   ok = ((kp <= qp) & (kp > qp - window) | (kp < prefix) & (qp < prefix))
//        & (kp <= max_kv),
// softcap (cap * tanh(s / cap)) applied before the mask, masked scores
// -1e30 (not -inf: a row with every key masked returns the mean of v, as
// the reference does), and the online softmax of the TPU kernel: running
// (m, l, acc) in float32 and out = acc / max(l, 1e-30).  bfloat16 inputs:
// the TPU kernel's einsums return bfloat16, so each score is rounded to
// bfloat16 before the softcap and each probability before the product
// with v, as there; l sums the unrounded probabilities, as there.
//
// Bound: operations at the models' shapes (4 L^2 hd H flops, counting the
// causal half, against the f32 rate outside the tensor cores); a decode
// step (Lq = 1) is bound by the bytes of k and v.
//
// Design (simple first: CUDA cores, no tensor cores; mma / wgmma are
// later work): one block of 4 warps per (b * KV + kv head, 32 rows),
// where a row is one (query, group head) pair of that kv head, so a
// block covers the group's G query heads.  The rows' q is staged once in
// shared memory (float32, row stride padded to a multiple of 4); the kv
// sequence is walked in tiles of 32 keys, k stored transposed and v as
// is, both in float32.  Each warp owns 8 rows.  Scores: lane c computes
// the 8 scores of key c (one k value, 8 broadcast float4 q reads per 4
// dims); the tile's max and sum are warp shuffles.  Probabilities go to
// shared memory and lane h accumulates output dims h, h + 32, ... of the
// warp's 8 rows in registers.  Keys past M are skipped (their score is
// -inf, so exp gives 0 and they add nothing to l), never set to -1e30.
// No causal tile is skipped: a row whose every key is masked must still
// average all of v.  hd <= 256 (dynamic shared memory above 48 KB).
//
// The launcher has a plain C interface: raw device pointers, sizes and the
// caller's cudaStream_t.  It allocates nothing, does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 8;                    // rows per warp
constexpr int FA_BR = FA_WARPS * FA_ROWS;     // rows per block
constexpr int FA_BK = 32;                     // keys per tile (= lanes)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// the rounding of an einsum that returns T, back in float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct AttnArgs {
  int B, Lq, M, KV, G, hd;
  int window, prefix, max_kv;
  float softcap;                  // <= 0: none
};

// NCH = dims per lane in the output (hd <= 32 * NCH)
template <typename T, int NCH>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ kv_pos, AttnArgs a,
                           T* __restrict__ out) {
  extern __shared__ __align__(16) float fa_smem[];
  const int hd = a.hd;
  const int QS = (hd + 3) & ~3;               // padded row stride
  float* Qs = fa_smem;                        // [FA_BR][QS]
  float* Kt = Qs + FA_BR * QS;                // [QS][FA_BK] (transposed)
  float* Vs = Kt + QS * FA_BK;                // [FA_BK][QS]
  float* Ps = Vs + FA_BK * QS;                // [FA_BR][FA_BK]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int R = a.Lq * a.G;                   // rows of this kv head
  const int r0 = blockIdx.x * FA_BR;
  // row r = (l, g): q[b, l, kvh, g, :]
  auto q_off = [&](int r) -> long long {
    const int l = r / a.G, g = r % a.G;
    return ((((long long)b * a.Lq + l) * a.KV + kvh) * a.G + g) * hd;
  };
  auto kv_off = [&](int key) -> long long {
    return (((long long)b * a.M + key) * a.KV + kvh) * hd;
  };

  for (int i = threadIdx.x; i < FA_BR * QS; i += blockDim.x) {
    const int r = i / QS, h = i % QS;
    const int row = r0 + r;
    Qs[i] = (row < R && h < hd) ? to_f32(q[q_off(row) + h]) : 0.f;
  }

  long long qp[FA_ROWS];
  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][NCH];
#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    const int row = r0 + warp * FA_ROWS + i;
    qp[i] = row < R ? q_pos[row / a.G] : 0;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[i][c] = 0.f;
  }
  const float* Qw = Qs + warp * FA_ROWS * QS;
  float* Pw = Ps + warp * FA_ROWS * FA_BK;

  for (int kt = 0; kt < a.M; kt += FA_BK) {
    __syncthreads();                          // the last tile is consumed
    for (int i = threadIdx.x; i < FA_BK * QS; i += blockDim.x) {
      const int c = i / QS, h = i % QS;
      const int key = kt + c;
      const bool in = key < a.M && h < hd;
      Kt[h * FA_BK + c] = in ? to_f32(k[kv_off(key) + h]) : 0.f;
      Vs[i] = in ? to_f32(v[kv_off(key) + h]) : 0.f;
    }
    __syncthreads();

    // ---- scores of key kt + lane against the warp's 8 rows -------------
    float s[FA_ROWS];
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) s[i] = 0.f;
    for (int h = 0; h < QS; h += 4) {
      const float k0 = Kt[(h + 0) * FA_BK + lane];
      const float k1 = Kt[(h + 1) * FA_BK + lane];
      const float k2 = Kt[(h + 2) * FA_BK + lane];
      const float k3 = Kt[(h + 3) * FA_BK + lane];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qw + i * QS + h);
        s[i] = __fmaf_rn(qv.x, k0, s[i]);
        s[i] = __fmaf_rn(qv.y, k1, s[i]);
        s[i] = __fmaf_rn(qv.z, k2, s[i]);
        s[i] = __fmaf_rn(qv.w, k3, s[i]);
      }
    }
    const int key = kt + lane;
    const bool real = key < a.M;
    const long long kp = real ? kv_pos[key] : 0;

    // ---- online softmax, one row at a time ------------------------------
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) {
      float x = round_to<T>(s[i]);
      if (a.softcap > 0.f)
        x = __fmul_rn(a.softcap, tanhf(__fdiv_rn(x, a.softcap)));
      const bool causal = kp <= qp[i] && kp > qp[i] - a.window;
      const bool bidir = kp < a.prefix && qp[i] < a.prefix;
      x = ((causal || bidir) && kp <= a.max_kv) ? x : NEG;
      x = real ? x : -CUDART_INF_F;           // skipped, not masked
      const float m_new = fmaxf(m[i], warp_max(x));
      const float scale = expf(__fsub_rn(m[i], m_new));
      const float p = expf(__fsub_rn(x, m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], scale), warp_sum(p));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[i][c] = __fmul_rn(acc[i][c], scale);
      Pw[i * FA_BK + lane] = round_to<T>(p);
    }
    __syncwarp();

    // ---- acc += p v: lane owns dims lane, lane + 32, ... ----------------
    const int n_keys = min(FA_BK, a.M - kt);
    for (int c0 = 0; c0 < n_keys; c0 += 4) {
      float4 pr[FA_ROWS];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Pw + i * FA_BK + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vh[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int h = lane + 32 * c;
          vh[c] = h < hd ? Vs[(c0 + cc) * QS + h] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < FA_ROWS; ++i) {
          const float pk = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y
                         : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            acc[i][c] = __fmaf_rn(pk, vh[c], acc[i][c]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    const int row = r0 + warp * FA_ROWS + i;
    if (row >= R) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + q_off(row);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int h = lane + 32 * c;
      if (h < hd) o[h] = from_f32<T>(__fdiv_rn(acc[i][c], den));
    }
  }
}

template <typename T, int NCH>
int launch_fa(const void* q, const void* k, const void* v, const int* q_pos,
              const int* kv_pos, const AttnArgs& a, void* out,
              cudaStream_t stream) {
  const int QS = (a.hd + 3) & ~3;
  const size_t smem = sizeof(float) * ((size_t)FA_BR * QS + 2 * QS * FA_BK
                                       + FA_BR * FA_BK);
  auto kernel = flash_attention_fwd_kernel<T, NCH>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((unsigned)((a.Lq * a.G + FA_BR - 1) / FA_BR),
                  (unsigned)(a.B * a.KV));
  kernel<<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, a, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* q_pos, const int* kv_pos, const AttnArgs& a,
                void* out, cudaStream_t stream) {
  if (a.hd <= 32) return launch_fa<T, 1>(q, k, v, q_pos, kv_pos, a, out, stream);
  if (a.hd <= 64) return launch_fa<T, 2>(q, k, v, q_pos, kv_pos, a, out, stream);
  if (a.hd <= 128) return launch_fa<T, 4>(q, k, v, q_pos, kv_pos, a, out, stream);
  if (a.hd <= 256) return launch_fa<T, 8>(q, k, v, q_pos, kv_pos, a, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, int B, int Lq,
                        int M, int KV, int G, int hd, int window, int prefix,
                        int max_kv, float softcap, int bf16, void* out,
                        cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || KV <= 0 || G <= 0) return (int)cudaGetLastError();
  const AttnArgs a{B, Lq, M, KV, G, hd, window, prefix, max_kv, softcap};
  return bf16 ? dispatch_hd<__nv_bfloat16>(q, k, v, q_pos, kv_pos, a, out,
                                           stream)
              : dispatch_hd<float>(q, k, v, q_pos, kv_pos, a, out, stream);
}

}  // extern "C"
