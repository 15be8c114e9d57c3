// Hand-written Hopper (sm_90a) kernels for the attention forward pass.
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
// the TPU kernel's einsums return bfloat16, so each score leaves its f32
// accumulator rounded to bfloat16 before the softcap and the mask, and
// each probability is rounded to bfloat16 as the operand of the product
// with v; l sums the unrounded probabilities, as there.
//
// A row is one (query, group head) pair of a kv head, packed as r = l * G
// + g, so a block of rows shares one kv head's k and v.  One C launcher,
// three kernels picked by shape (the wrapper, kernels/attention/ops.py,
// names the path and mirrors the tile sizes):
//
//   bf16_mma   bfloat16, hd % 8 == 0, hd <= 256.  FlashAttention-2 shape on
//              the tensor cores: 4 warps, 16 rows each (64 a block); k and
//              v tiles of 64 keys (32 at hd 256) double-buffered in shared
//              memory by cp.async; q k^T and p v by mma.sync m16n8k16
//              (bf16 in, f32 accumulate) with ldmatrix; p stays in
//              registers between the two products.  The output
//              accumulator is 4 hd registers a thread, so hd 256 runs 2
//              blocks an SM.
//   f32_tiled  float32, hd % 4 == 0, hd <= 256.  Register-tiled CUDA-core
//              kernel: 256 threads, 64 rows, tiles of 64 keys (32 above hd
//              64) double-buffered by cp.async; each thread computes a 4 x
//              (BK / 16) micro-tile of scores and a 4 x (hd / 16) tile of
//              the p v update with float4 shared-memory reads.  Float32
//              FMAs only (no TF32).
//   general    any other shape (hd above 256 or not a multiple of 8 / 4,
//              unaligned operands), either type: 4 warps of 8 rows, tiles
//              of 32 keys, q k^T accumulated over 32-dim chunks, the
//              output dims chunked 256 at a time over the grid's y (each
//              chunk recomputes its scores).
//
// All three skip a (row block, key tile) pair when an interval test on
// the block's min / max query position and the tile's min / max key
// position proves every pair masked (tile_class; positions may be in any
// order).  That is exact for a row that keeps a key: a masked score adds
// exp(-1e30 - m) = 0 to l and acc and leaves m.  A row that keeps no key
// (m still -1e30 at the end) averages all of v instead, computed directly
// (v_mean): the same function the unskipped sweep gives, since every
// probability is then exp(0) = 1.  Tiles proved fully kept skip the
// per-element mask.
//
// At the models' shapes latency, not the tensor or CUDA-core rate, sets
// the tiled kernels' time, so: the next kept tile's copies start before
// the current tile is computed; each thread steps one pointer per
// copy (TileCopy); the positions a tile test needs are loaded a tile ahead
// (TileWalk); branches uniform over a tile (softcap, per-element mask)
// stay outside the element loops (inside them the compiler evaluated tanhf
// for every score).
//
// Key split (decode): when the row blocks times B * KV cannot fill the
// card, the wrapper asks for nsplit > 1: split s sweeps tiles [s * tps,
// (s + 1) * tps) and writes its (m, l, acc) to scratch the wrapper
// allocated; attn_merge_kernel combines the splits in ascending order (no
// atomics: bitwise the same from run to run).  A row whose merged max is
// still -1e30 kept no key anywhere and averages v.
//
// Bound: operations for prefill (4 hd flops per unmasked pair and head:
// bf16 against the tensor cores, f32 against the CUDA cores), bytes for a
// decode step (the k and v of the kept keys).
//
// The launcher has a plain C interface: raw device pointers, sizes and the
// caller's cudaStream_t.  It allocates nothing (split scratch and the
// optional tile counters come from the wrapper), does not synchronise, and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;

enum Path { kBf16Mma = 0, kF32Tiled = 1, kGeneral = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// the rounding of an einsum that returns T, back in float32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct AttnArgs {
  int B, Lq, M, KV, G, hd;
  int window, prefix, max_kv;
  float softcap;                  // <= 0: none
  int nsplit, tiles_per_split;    // key split (nsplit 1: none)
  int row_blocks;
};

// per split s, kv head bkv and row r: m, l at (s * B*KV + bkv) * R + r,
// acc at that index times hd
struct Partials {
  float* m;
  float* l;
  float* acc;
};

// ---- which block is this ---------------------------------------------------
struct Blk {
  int b, kvh, bkv, r0, split, t_begin, t_end;
};

template <int BR, int BK>
__device__ __forceinline__ Blk block_of(const AttnArgs& a) {
  const int BKV = a.B * a.KV;
  const long long x = blockIdx.x;
  Blk k;
  // heavy causal row blocks (the last rows) are handed out first
  const int rb = a.row_blocks - 1 - (int)(x % a.row_blocks);
  const long long rest = x / a.row_blocks;
  k.bkv = (int)(rest % BKV);
  k.split = (int)(rest / BKV);
  k.b = k.bkv / a.KV;
  k.kvh = k.bkv % a.KV;
  k.r0 = rb * BR;
  const int ntiles = (a.M + BK - 1) / BK;
  k.t_begin = k.split * a.tiles_per_split;
  k.t_end = max(k.t_begin, min(ntiles, k.t_begin + a.tiles_per_split));
  return k;
}

__device__ __forceinline__ long long q_off(const AttnArgs& a, int b, int kvh,
                                           int r) {
  const int l = r / a.G, g = r % a.G;
  return ((((long long)b * a.Lq + l) * a.KV + kvh) * a.G + g) * a.hd;
}
__device__ __forceinline__ long long kv_off(const AttnArgs& a, int b, int kvh,
                                            int key) {
  return (((long long)b * a.M + key) * a.KV + kvh) * a.hd;
}

// ---- the mask and the tile test: one place -----------------------------
__device__ __forceinline__ bool kept(long long qp, long long kp,
                                     const AttnArgs& a) {
  const bool causal = kp <= qp && kp > qp - a.window;
  const bool bidir = kp < a.prefix && qp < a.prefix;
  return (causal || bidir) && kp <= a.max_kv;
}

// 0: every pair masked (skip); 1: mixed; 2: every pair kept (no per-element
// mask).  Conservative on both sides: an interval test over the rows'
// [qmin, qmax] and the keys' [kmin, kmax].  Mirrored by ref.tile_skip_ref.
__device__ __forceinline__ int tile_class(long long qmin, long long qmax,
                                          long long kmin, long long kmax,
                                          const AttnArgs& a) {
  if (kmin > a.max_kv) return 0;
  const bool causal = kmin <= qmax && kmax > qmin - a.window;
  const bool bidir = kmin < a.prefix && qmin < a.prefix;
  if (!(causal || bidir)) return 0;
  if (kmax > a.max_kv) return 1;
  const bool all_causal = kmax <= qmin && kmin > qmax - a.window;
  const bool all_bidir = kmax < a.prefix && qmax < a.prefix;
  return (all_causal || all_bidir) ? 2 : 1;
}

// min / max of pos[i0 .. i1) over a warp (every lane gets both); i1 > i0
__device__ __forceinline__ void warp_range(const int* __restrict__ pos,
                                           int i0, int i1, int lane,
                                           int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = i0 + lane; i < i1; i += 32) {
    const int p = __ldg(pos + i);
    lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// The tiles of one block's key range, classified on the fly by each warp
// (every warp reaches the same answer).
template <int BK>
struct TileWalk {
  long long qmin, qmax;
  int skipped;

  __device__ __forceinline__ void init(const int* __restrict__ q_pos,
                                       const AttnArgs& a, int r0, int BR,
                                       int lane) {
    const int R = a.Lq * a.G;
    const int l0 = r0 / a.G, l1 = (min(r0 + BR, R) - 1) / a.G + 1;
    int lo, hi;
    warp_range(q_pos, l0, l1, lane, lo, hi);
    qmin = lo;
    qmax = hi;
    skipped = 0;
  }
  // The walk over the block's tiles, the positions of the next tile to
  // test loaded one step ahead (pos, from fetch) so that their latency
  // hides behind a tile's work: next(t) returns the first tile at
  // or after t that is not skipped (t_end if none), with its class in c,
  // testing each from pos and fetching the one after it.
  static constexpr int PER_LANE = (BK + 31) / 32;
  int pos[PER_LANE];
  __device__ __forceinline__ void fetch(const int* __restrict__ kv_pos,
                                        const AttnArgs& a, int t, int lane) {
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int key = t * BK + lane + 32 * i;
      pos[i] = key < a.M && lane + 32 * i < BK ? __ldg(kv_pos + key) : 0;
    }
  }
  __device__ __forceinline__ int next(const int* __restrict__ kv_pos,
                                              const AttnArgs& a, int t,
                                              int t_end, int lane, int& c) {
    for (; t < t_end; ++t) {
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (t * BK + lane + 32 * i < a.M && lane + 32 * i < BK) {
          lo = min(lo, pos[i]);
          hi = max(hi, pos[i]);
        }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      c = tile_class(qmin, qmax, lo, hi, a);
      if (c == 2 && a.M - t * BK < BK) c = 1;    // keys past M: per element
      fetch(kv_pos, a, t + 1, lane);
      if (c) return t;
      ++skipped;
    }
    return t;
  }
};

__device__ __forceinline__ void count_tiles(int* stats, const Blk& k,
                                            int skipped) {
  if (stats && threadIdx.x == 0 && threadIdx.y == 0 && blockIdx.y == 0) {
    atomicAdd(stats, k.t_end - k.t_begin);
    atomicAdd(stats + 1, skipped);
  }
}

// A row that kept no key: the mean of v over all M keys, dim h (the
// unskipped sweep's result: every probability exp(0) = 1, l = M).  Rare;
// kept out of line so the epilogues stay small.
template <typename T>
__device__ __noinline__ float v_mean(const T* __restrict__ v, const AttnArgs& a, int b,
                        int kvh, int h) {
  float s = 0.f;
  for (int j = 0; j < a.M; ++j)
    s = __fadd_rn(s, to_f32(v[kv_off(a, b, kvh, j) + h]));
  return __fdiv_rn(s, (float)a.M);
}

// The end of a row: the output (nsplit 1) or this split's partial.
template <typename T>
struct RowOut {
  const AttnArgs& a;
  const Blk& k;
  const T* __restrict__ v;
  T* __restrict__ out;
  Partials part;

  __device__ __forceinline__ long long pidx(int row) const {
    return ((long long)k.split * a.B * a.KV + k.bkv) * (a.Lq * a.G) + row;
  }
  // m and l (one thread per row writes them)
  __device__ __forceinline__ void stats(int row, float m, float l) const {
    if (a.nsplit > 1) {
      part.m[pidx(row)] = m;
      part.l[pidx(row)] = l;
    }
  }
  __device__ __forceinline__ void dim(int row, int h, float m, float l,
                                      float acc) const {
    if (a.nsplit > 1) {
      part.acc[pidx(row) * a.hd + h] = acc;
      return;
    }
    const float o = m == NEG ? v_mean(v, a, k.b, k.kvh, h)
                             : __fdiv_rn(acc, fmaxf(l, 1e-30f));
    out[q_off(a, k.b, k.kvh, row) + h] = from_f32<T>(o);
  }
};

// exp(d) of the online softmax, d = x - m <= 0, as exp2(d log2 e): one
// rounding of d log2 e more than expf (relative 2^-24 |d| log2 e, inside
// both gates; measured 3-8% faster at the models' shapes).  d = 0 gives
// exactly 1 and d = -inf exactly 0, as the masked and skipped keys need.
__device__ __forceinline__ float exp_of(float d) {
  return exp2f(__fmul_rn(d, 1.4426950408889634f));
}

__device__ __forceinline__ float softcap_of(float x, float cap) {
  return cap > 0.f ? __fmul_rn(cap, tanhf(__fdiv_rn(x, cap))) : x;
}

// ---- cp.async / ldmatrix / mma -------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes from global to shared; zero-filled when !in (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a b: m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Stage rows [row0, row0 + n) (rows past `rows` zero) of a [rows, hd]
// slab whose row r starts at off(r), hd padded to HD, into smem [n][LD],
// 16 bytes per cp.async (EPC elements).  For q, staged once per block.
template <int HD, int LD, int EPC, typename T, typename Off>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int row0, int n, int rows, int hd,
                                      Off off, int tid, int nthreads) {
  constexpr int CPR = HD / EPC;               // chunks per row
  for (int i = tid; i < n * CPR; i += nthreads) {
    const int r = i / CPR, h = (i % CPR) * EPC;
    const bool in = row0 + r < rows && h < hd;
    cp16(dst + r * LD + h, in ? src + off(row0 + r) + h : src, in);
  }
}

// One k or v tile, keys [key0, key0 + BK) of one kv head (row j at base +
// j * stride), into smem [BK][LD], hd padded to HD with zeros and keys
// past M zero.  Thread tid always copies the same 16-byte column h of
// rows r0, r0 + RSTEP, ...: one pointer step per copy.
template <int HD, int LD, int EPC, int BK, int NT>
struct TileCopy {
  static constexpr int CPR = HD / EPC, RSTEP = NT / CPR, N = BK / RSTEP;
  static_assert(NT % CPR == 0 && BK % RSTEP == 0, "tile copy shape");
  int r0, h;

  __device__ __forceinline__ explicit TileCopy(int tid)
      : r0(tid / CPR), h((tid % CPR) * EPC) {}
  template <typename T>
  __device__ __forceinline__ void operator()(T* dst, const T* base,
                                             long long stride, int key0,
                                             int M, int hd) const {
    const T* src = base + (long long)(key0 + r0) * stride + h;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bool in = h < hd && key0 + r0 + n * RSTEP < M;
      cp16(dst + (r0 + n * RSTEP) * LD + h,
           in ? src + (long long)n * RSTEP * stride : base, in);
    }
  }
};

// ---- bf16_mma ----------------------------------------------------------
// 4 warps of 16 rows share each k / v tile (8 warps, half the L2 traffic
// per row, measured slower: fewer warps an SM).
constexpr int MMA_WARPS = 4;
constexpr int MMA_BR = 16 * MMA_WARPS;
template <int HD> constexpr int mma_keys() { return HD <= 128 ? 64 : 32; }

// hd 64: capped at 128 registers, 4 blocks an SM (no spill; measured 5%
// faster than 148 registers and 3 blocks)
template <int HD, int BK>
__global__ void __launch_bounds__(MMA_WARPS * 32, HD <= 64 ? 4 : 1)
attn_bf16_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, AttnArgs a,
                     bf16* __restrict__ out, Partials part, int* stats) {
  constexpr int BR = MMA_BR, LD = HD + 8;     // +16 bytes: no bank conflict
  constexpr int NT = MMA_WARPS * 32;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);        // [BR][LD]
  bf16* Ks = Qs + BR * LD;                            // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                        // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Blk blk = block_of<BR, BK>(a);
  const int R = a.Lq * a.G;
  TileWalk<BK> walk;
  walk.init(q_pos, a, blk.r0, BR, lane);

  // the thread's two rows: g and g + 8 of the warp's 16
  const int row_a = blk.r0 + warp * 16 + g, row_b = row_a + 8;
  const long long qp_a = q_pos[min(row_a, R - 1) / a.G];
  const long long qp_b = q_pos[min(row_b, R - 1) / a.G];

  auto qo = [&](int r) { return q_off(a, blk.b, blk.kvh, r); };
  const TileCopy<HD, LD, 8, BK, NT> copy(tid);
  const long long kv0 = kv_off(a, blk.b, blk.kvh, 0), stride = a.KV * a.hd;
  auto load_kv = [&](int t, int buf) {
    copy(Ks + buf * BK * LD, k + kv0, stride, t * BK, a.M, a.hd);
    copy(Vs + buf * BK * LD, v + kv0, stride, t * BK, a.M, a.hd);
  };

  float O[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[d][e] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

  int c = 0;
  walk.fetch(kv_pos, a, blk.t_begin, lane);
  int t = walk.next(kv_pos, a, blk.t_begin, blk.t_end, lane, c);
  if (t < blk.t_end) {
    stage<HD, LD, 8>(Qs, q, blk.r0, BR, R, a.hd, qo, tid, NT);
    load_kv(t, 0);
  }
  cp_commit();
  int buf = 0;
  while (t < blk.t_end) {
    int cn = 0;
    const int tn = walk.next(kv_pos, a, t + 1, blk.t_end, lane, cn);
    if (tn < blk.t_end) load_kv(tn, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;

    // ---- S = q k^T (16 rows x BK keys per warp) ------------------------
    float S[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned A[4];
      ldsm_x4(A, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16
                      + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        unsigned Bf[4];
        ldsm_x4(Bf, Kb + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                        + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(S[2 * nn], A, Bf[0], Bf[1]);
        mma_bf16(S[2 * nn + 1], A, Bf[2], Bf[3]);
      }
    }

    // ---- scores: round, softcap, mask (each a uniform branch per tile) ---
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[n][e] = round_to<bf16>(S[n][e]);
    if (a.softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[n][e] = softcap_of(S[n][e], a.softcap);
    }
    if (c != 2) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * BK + n * 8 + 2 * t4 + (e & 1);
          if (key >= a.M)
            S[n][e] = -CUDART_INF_F;          // skipped, not masked
          else if (!kept(e < 2 ? qp_a : qp_b, __ldg(kv_pos + key), a))
            S[n][e] = NEG;
        }
    }
    // ---- online softmax ----------------------------------------------------
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(S[n][0], S[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(S[n][2], S[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float sc_a = exp_of(__fsub_rn(m_a, mn_a));
    const float sc_b = exp_of(__fsub_rn(m_b, mn_b));
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      S[n][0] = exp_of(__fsub_rn(S[n][0], mn_a));
      S[n][1] = exp_of(__fsub_rn(S[n][1], mn_a));
      S[n][2] = exp_of(__fsub_rn(S[n][2], mn_b));
      S[n][3] = exp_of(__fsub_rn(S[n][3], mn_b));
      sum_a = __fadd_rn(sum_a, __fadd_rn(S[n][0], S[n][1]));
      sum_b = __fadd_rn(sum_b, __fadd_rn(S[n][2], S[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, o));
      sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, o));
    }
    l_a = __fadd_rn(__fmul_rn(l_a, sc_a), sum_a);
    l_b = __fadd_rn(__fmul_rn(l_b, sc_b), sum_b);
    // once the rows' maxima settle the scale is exactly 1: skip the pass
    if (__any_sync(0xffffffffu, sc_a != 1.f || sc_b != 1.f)) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        O[d][0] = __fmul_rn(O[d][0], sc_a);
        O[d][1] = __fmul_rn(O[d][1], sc_a);
        O[d][2] = __fmul_rn(O[d][2], sc_b);
        O[d][3] = __fmul_rn(O[d][3], sc_b);
      }
    }

    // ---- O += bf16(p) v ----------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned P[4] = {pack_bf16(S[2 * kk][0], S[2 * kk][1]),
                             pack_bf16(S[2 * kk][2], S[2 * kk][3]),
                             pack_bf16(S[2 * kk + 1][0], S[2 * kk + 1][1]),
                             pack_bf16(S[2 * kk + 1][2], S[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        unsigned Bf[4];
        ldsm_x4_t(Bf, Vb + (kk * 16 + (lane & 15)) * LD + dn * 16
                          + (lane >> 4) * 8);
        mma_bf16(O[2 * dn], P, Bf[0], Bf[1]);
        mma_bf16(O[2 * dn + 1], P, Bf[2], Bf[3]);
      }
    }
    __syncthreads();                  // buf is read; the next loads may land
    t = tn;
    c = cn;
    buf ^= 1;
  }
  cp_wait<0>();

  const RowOut<bf16> ro{a, blk, v, out, part};
  if (t4 == 0) {
    if (row_a < R) ro.stats(row_a, m_a, l_a);
    if (row_b < R) ro.stats(row_b, m_b, l_b);
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int h = d * 8 + 2 * t4;
    if (h >= a.hd) continue;
    if (row_a < R) {
      ro.dim(row_a, h, m_a, l_a, O[d][0]);
      ro.dim(row_a, h + 1, m_a, l_a, O[d][1]);
    }
    if (row_b < R) {
      ro.dim(row_b, h, m_b, l_b, O[d][2]);
      ro.dim(row_b, h + 1, m_b, l_b, O[d][3]);
    }
  }
  count_tiles(stats, blk, walk.skipped);
}

// ---- f32_tiled ------------------------------------------------------------
constexpr int F32_BR = 64;

template <int HD, int BK>
__global__ void __launch_bounds__(256)
attn_f32_tiled_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, AttnArgs a,
                      float* __restrict__ out, Partials part, int* stats) {
  constexpr int BR = F32_BR, LD = HD + 4, PLD = BK + 4;
  constexpr int NJ = BK / 16, NC = HD / 64;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);      // [BR][LD]
  float* Ks = Qs + BR * LD;                           // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;                       // [2][BK][LD]
  float* Ps = Vs + 2 * BK * LD;                       // [BR][PLD]

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;   // rows ty + 16 i, keys tx + 16 j
  const Blk blk = block_of<BR, BK>(a);
  const int R = a.Lq * a.G;
  TileWalk<BK> walk;
  walk.init(q_pos, a, blk.r0, BR, lane);
  long long qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qp[i] = q_pos[min(blk.r0 + ty + 16 * i, R - 1) / a.G];

  auto qo = [&](int r) { return q_off(a, blk.b, blk.kvh, r); };
  const TileCopy<HD, LD, 4, BK, 256> copy(tid);
  const long long kv0 = kv_off(a, blk.b, blk.kvh, 0), stride = a.KV * a.hd;
  auto load_kv = [&](int t, int buf) {
    copy(Ks + buf * BK * LD, k + kv0, stride, t * BK, a.M, a.hd);
    copy(Vs + buf * BK * LD, v + kv0, stride, t * BK, a.M, a.hd);
  };

  float4 acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[i][cc] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int c = 0;
  walk.fetch(kv_pos, a, blk.t_begin, lane);
  int t = walk.next(kv_pos, a, blk.t_begin, blk.t_end, lane, c);
  if (t < blk.t_end) {
    stage<HD, LD, 4>(Qs, q, blk.r0, BR, R, a.hd, qo, tid, 256);
    load_kv(t, 0);
  }
  cp_commit();
  int buf = 0;
  const int hd4 = (a.hd + 3) & ~3;
  while (t < blk.t_end) {
    int cn = 0;
    const int tn = walk.next(kv_pos, a, t + 1, blk.t_end, lane, cn);
    if (tn < blk.t_end) load_kv(tn, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Kb = Ks + buf * BK * LD;
    const float* Vb = Vs + buf * BK * LD;

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    for (int h = 0; h < hd4; h += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kb + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = __fmaf_rn(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = __fmaf_rn(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = softcap_of(s[i][j], a.softcap);
    }
    if (c != 2) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = t * BK + tx + 16 * j;
        const long long kp = key < a.M ? __ldg(kv_pos + key) : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (key >= a.M) s[i][j] = -CUDART_INF_F;
          else if (!kept(qp[i], kp, a)) s[i][j] = NEG;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float sc = exp_of(__fsub_rn(m[i], mn));
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp_of(__fsub_rn(s[i][j], mn));
        sum = __fadd_rn(sum, p);
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      l[i] = __fadd_rn(__fmul_rn(l[i], sc), sum);
      if (__any_sync(0xffffffffu, sc != 1.f)) {     // 1: exact, skip it
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          acc[i][cc].x = __fmul_rn(acc[i][cc].x, sc);
          acc[i][cc].y = __fmul_rn(acc[i][cc].y, sc);
          acc[i][cc].z = __fmul_rn(acc[i][cc].z, sc);
          acc[i][cc].w = __fmul_rn(acc[i][cc].w, sc);
        }
      }
    }
    __syncwarp();       // a row's p is written and read by one half-warp

#pragma unroll 2
    for (int key = 0; key < BK; key += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PLD
                                                 + key);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vb + (key + kk) * LD + tx * 4 + 64 * cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = kk == 0 ? pr[i].x : kk == 1 ? pr[i].y
                          : kk == 2 ? pr[i].z : pr[i].w;
            acc[i][cc].x = __fmaf_rn(p, vv.x, acc[i][cc].x);
            acc[i][cc].y = __fmaf_rn(p, vv.y, acc[i][cc].y);
            acc[i][cc].z = __fmaf_rn(p, vv.z, acc[i][cc].z);
            acc[i][cc].w = __fmaf_rn(p, vv.w, acc[i][cc].w);
          }
        }
      }
    }
    __syncthreads();
    t = tn;
    c = cn;
    buf ^= 1;
  }
  cp_wait<0>();

  const RowOut<float> ro{a, blk, v, out, part};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = blk.r0 + ty + 16 * i;
    if (row >= R) continue;
    if (tx == 0) ro.stats(row, m[i], l[i]);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int h = tx * 4 + 64 * cc;
      const float vals[4] = {acc[i][cc].x, acc[i][cc].y, acc[i][cc].z,
                             acc[i][cc].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (h + e < a.hd) ro.dim(row, h + e, m[i], l[i], vals[e]);
    }
  }
  count_tiles(stats, blk, walk.skipped);
}

// ---- general ---------------------------------------------------------------
constexpr int GEN_WARPS = 4;
constexpr int GEN_ROWS = 8;                    // rows per warp
constexpr int GEN_BR = GEN_WARPS * GEN_ROWS;
constexpr int GEN_BK = 32;                     // keys per tile (= lanes)
constexpr int GEN_HC = 32;                     // q k^T dims per chunk
constexpr int GEN_DC = 256;                    // output dims per block

template <typename T>
__global__ void __launch_bounds__(GEN_WARPS * 32)
attn_general_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, AttnArgs a,
                    T* __restrict__ out, Partials part, int* stats) {
  __shared__ __align__(16) float Qc[GEN_BR][GEN_HC];
  __shared__ float Kt[GEN_HC][GEN_BK + 1];
  __shared__ float Vs[GEN_BK][GEN_DC];
  __shared__ __align__(16) float Ps[GEN_BR][GEN_BK];
  constexpr int NCH = GEN_DC / 32;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Blk blk = block_of<GEN_BR, GEN_BK>(a);
  const int R = a.Lq * a.G;
  const int d0 = blockIdx.y * GEN_DC;
  TileWalk<GEN_BK> walk;
  walk.init(q_pos, a, blk.r0, GEN_BR, lane);

  long long qp[GEN_ROWS];
  float m[GEN_ROWS], l[GEN_ROWS], acc[GEN_ROWS][NCH];
#pragma unroll
  for (int i = 0; i < GEN_ROWS; ++i) {
    const int row = blk.r0 + warp * GEN_ROWS + i;
    qp[i] = q_pos[min(row, R - 1) / a.G];
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) acc[i][cc] = 0.f;
  }
  float* Pw = &Ps[warp * GEN_ROWS][0];

  int c = 0;
  walk.fetch(kv_pos, a, blk.t_begin, lane);
  for (int t = walk.next(kv_pos, a, blk.t_begin, blk.t_end, lane, c);
       t < blk.t_end;
       t = walk.next(kv_pos, a, t + 1, blk.t_end, lane, c)) {
    const int key = t * GEN_BK + lane;
    float s[GEN_ROWS];
#pragma unroll
    for (int i = 0; i < GEN_ROWS; ++i) s[i] = 0.f;
    for (int hc = 0; hc < a.hd; hc += GEN_HC) {
      __syncthreads();
      for (int e = threadIdx.x; e < GEN_BR * GEN_HC; e += blockDim.x) {
        const int r = e / GEN_HC, h = e % GEN_HC, row = blk.r0 + r;
        Qc[r][h] = row < R && hc + h < a.hd
                       ? to_f32(q[q_off(a, blk.b, blk.kvh, row) + hc + h])
                       : 0.f;
      }
      for (int e = threadIdx.x; e < GEN_BK * GEN_HC; e += blockDim.x) {
        const int cc = e / GEN_HC, h = e % GEN_HC, kk = t * GEN_BK + cc;
        Kt[h][cc] = kk < a.M && hc + h < a.hd
                        ? to_f32(k[kv_off(a, blk.b, blk.kvh, kk) + hc + h])
                        : 0.f;
      }
      __syncthreads();
      const int nh = min(GEN_HC, a.hd - hc);
      for (int h = 0; h < nh; ++h) {
        const float kh = Kt[h][lane];
#pragma unroll
        for (int i = 0; i < GEN_ROWS; ++i)
          s[i] = __fmaf_rn(Qc[warp * GEN_ROWS + i][h], kh, s[i]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < GEN_BK * GEN_DC; e += blockDim.x) {
      const int cc = e / GEN_DC, h = d0 + e % GEN_DC, kk = t * GEN_BK + cc;
      Vs[cc][e % GEN_DC] = kk < a.M && h < a.hd
          ? to_f32(v[kv_off(a, blk.b, blk.kvh, kk) + h]) : 0.f;
    }
    __syncthreads();

    const bool real = key < a.M;
    const long long kp = real ? __ldg(kv_pos + key) : 0;
#pragma unroll
    for (int i = 0; i < GEN_ROWS; ++i) {
      float x = softcap_of(round_to<T>(s[i]), a.softcap);
      if (c != 2 && !kept(qp[i], kp, a)) x = NEG;
      x = real ? x : -CUDART_INF_F;           // skipped, not masked
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float sc = exp_of(__fsub_rn(m[i], mn));
      const float p = exp_of(__fsub_rn(x, mn));
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      l[i] = __fadd_rn(__fmul_rn(l[i], sc), sum);
      m[i] = mn;
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) acc[i][cc] = __fmul_rn(acc[i][cc], sc);
      Pw[i * GEN_BK + lane] = round_to<T>(p);
    }
    __syncwarp();
    for (int kk = 0; kk < GEN_BK; ++kk) {
      float vh[NCH];
#pragma unroll
      for (int cc = 0; cc < NCH; ++cc) vh[cc] = Vs[kk][lane + 32 * cc];
#pragma unroll
      for (int i = 0; i < GEN_ROWS; ++i) {
        const float pk = Pw[i * GEN_BK + kk];
#pragma unroll
        for (int cc = 0; cc < NCH; ++cc)
          acc[i][cc] = __fmaf_rn(pk, vh[cc], acc[i][cc]);
      }
    }
    __syncwarp();
  }

  const RowOut<T> ro{a, blk, v, out, part};
#pragma unroll
  for (int i = 0; i < GEN_ROWS; ++i) {
    const int row = blk.r0 + warp * GEN_ROWS + i;
    if (row >= R) continue;
    if (lane == 0 && blockIdx.y == 0) ro.stats(row, m[i], l[i]);
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      const int h = d0 + lane + 32 * cc;
      if (h < a.hd) ro.dim(row, h, m[i], l[i], acc[i][cc]);
    }
  }
  count_tiles(stats, blk, walk.skipped);
}

// ---- merge of the key splits -----------------------------------------------
// One thread per (kv head, row, dim): the splits in ascending order.
template <typename T>
__global__ void __launch_bounds__(256)
attn_merge_kernel(Partials part, const T* __restrict__ v, AttnArgs a,
                  T* __restrict__ out) {
  const long long R = (long long)a.Lq * a.G, BKV = (long long)a.B * a.KV;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BKV * R * a.hd) return;
  const int h = (int)(idx % a.hd);
  const long long rr = idx / a.hd;
  const int row = (int)(rr % R);
  const int bkv = (int)(rr / R);
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  float mg = NEG;
  for (int s = 0; s < a.nsplit; ++s)
    mg = fmaxf(mg, part.m[(s * BKV + bkv) * R + row]);
  float o;
  if (mg == NEG) {
    o = v_mean(v, a, b, kvh, h);
  } else {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const long long p = (s * BKV + bkv) * R + row;
      const float w = exp_of(__fsub_rn(part.m[p], mg));
      l = __fadd_rn(l, __fmul_rn(part.l[p], w));
      acc = __fadd_rn(acc, __fmul_rn(part.acc[p * a.hd + h], w));
    }
    o = __fdiv_rn(acc, fmaxf(l, 1e-30f));
  }
  out[q_off(a, b, kvh, row) + h] = from_f32<T>(o);
}

// ---- launch ------------------------------------------------------------------
// Dynamic shared memory above 48 KB, allowed once per kernel and device
// (a CUDA runtime call per launch would cost more than a decode step's
// kernel).
template <auto Kernel>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const int* qp,
               const int* kp, AttnArgs a, void* out, Partials part,
               int* stats, unsigned blocks, cudaStream_t stream) {
  constexpr int BK = mma_keys<HD>(), LD = HD + 8;
  const size_t smem = sizeof(bf16) * ((size_t)MMA_BR * LD + 4 * BK * LD);
  constexpr auto kernel = attn_bf16_mma_kernel<HD, BK>;
  const cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, MMA_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), qp, kp, a, static_cast<bf16*>(out), part,
      stats);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const int* qp,
               const int* kp, AttnArgs a, void* out, Partials part,
               int* stats, unsigned blocks, cudaStream_t stream) {
  constexpr int BK = HD <= 64 ? 64 : 32;
  constexpr int LD = HD + 4, PLD = BK + 4;
  const size_t smem =
      sizeof(float) * ((size_t)F32_BR * LD + 4 * BK * LD + F32_BR * PLD);
  constexpr auto kernel = attn_f32_tiled_kernel<HD, BK>;
  const cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qp, kp, a, static_cast<float*>(out),
      part, stats);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_general(const void* q, const void* k, const void* v,
                   const int* qp, const int* kp, AttnArgs a, void* out,
                   Partials part, int* stats, unsigned blocks,
                   cudaStream_t stream) {
  const dim3 grid(blocks, (unsigned)((a.hd + GEN_DC - 1) / GEN_DC));
  attn_general_kernel<T><<<grid, GEN_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qp, kp, a, static_cast<T*>(out), part,
      stats);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const AttnArgs& a, const Partials& part, const void* v,
                 void* out, cudaStream_t stream) {
  const long long n = (long long)a.B * a.KV * a.Lq * a.G * a.hd;
  attn_merge_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const T*>(v), a, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

int head_dim_class(int hd) { return hd <= 64 ? 64 : hd <= 128 ? 128 : 256; }

// rows per block of a path (ops.py's tile_shape mirrors it)
int rows_per_block(int path) {
  return path == kGeneral ? GEN_BR : path == kF32Tiled ? F32_BR : MMA_BR;
}

}  // namespace

extern "C" {

// path: 0 bf16_mma, 1 f32_tiled, 2 general (kernels/attention/ops.py picks
// it, with nsplit and tiles_per_split).  part_*: split scratch ([nsplit, B *
// KV, Lq * G] for m and l, times hd for acc), unused when nsplit is 1.
// stats (may be NULL): += the (row block, tile) pairs swept and skipped.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, int B, int Lq,
                        int M, int KV, int G, int hd, int window, int prefix,
                        int max_kv, float softcap, int bf16_in, int path,
                        int nsplit, int tiles_per_split, float* part_m,
                        float* part_l, float* part_acc, int* stats,
                        void* out, cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || KV <= 0 || G <= 0 || hd <= 0)
    return (int)cudaGetLastError();
  const bool tiled = path == kBf16Mma || path == kF32Tiled;
  if (M <= 0 || nsplit < 1 || tiles_per_split < 1
      || (path == kBf16Mma && (!bf16_in || hd % 8 || hd > 256))
      || (path == kF32Tiled && (bf16_in || hd % 4 || hd > 256))
      || (path != kGeneral && !tiled)
      || (nsplit > 1 && !(part_m && part_l && part_acc)))
    return (int)cudaErrorInvalidValue;
  const int BR = rows_per_block(path);
  const int R = Lq * G;
  AttnArgs a{B, Lq, M, KV, G, hd, window, prefix, max_kv, softcap,
             nsplit, tiles_per_split, (R + BR - 1) / BR};
  const Partials part{part_m, part_l, part_acc};
  const long long blocks = (long long)a.row_blocks * B * KV * nsplit;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned nb = (unsigned)blocks;
  int err;
  if (path == kBf16Mma) {
    const int c = head_dim_class(hd);
    err = c == 64 ? launch_mma<64>(q, k, v, q_pos, kv_pos, a, out, part,
                                   stats, nb, stream)
        : c == 128 ? launch_mma<128>(q, k, v, q_pos, kv_pos, a, out, part,
                                     stats, nb, stream)
                   : launch_mma<256>(q, k, v, q_pos, kv_pos, a, out, part,
                                     stats, nb, stream);
  } else if (path == kF32Tiled) {
    const int c = head_dim_class(hd);
    err = c == 64 ? launch_f32<64>(q, k, v, q_pos, kv_pos, a, out, part,
                                   stats, nb, stream)
        : c == 128 ? launch_f32<128>(q, k, v, q_pos, kv_pos, a, out, part,
                                     stats, nb, stream)
                   : launch_f32<256>(q, k, v, q_pos, kv_pos, a, out, part,
                                     stats, nb, stream);
  } else {
    err = bf16_in ? launch_general<bf16>(q, k, v, q_pos, kv_pos, a, out,
                                         part, stats, nb, stream)
                  : launch_general<float>(q, k, v, q_pos, kv_pos, a, out,
                                          part, stats, nb, stream);
  }
  if (err != 0 || nsplit == 1) return err;
  return bf16_in ? launch_merge<bf16>(a, part, v, out, stream)
                 : launch_merge<float>(a, part, v, out, stream);
}

}  // extern "C"
