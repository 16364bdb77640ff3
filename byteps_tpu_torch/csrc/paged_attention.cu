// Paged-attention decode kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel byteps_tpu/ops/paged_attention.py:76
// `_paged_kernel` (pallas_call at :286, wrapper `paged_decode_attention`
// at :165) in both its fp and its int8 mode; the tensor-parallel wrapper
// `paged_decode_attention_sharded` (:306) is one launch of this kernel per
// shard (ops/paged_attention.py).  Python binding, build and the plain
// PyTorch version live in byteps_tpu_torch/ops/paged_attention.py.
//
// What it computes.  q [B, tq, H, D] against flat block pools
// ck/cv [n_blocks, block, KV*D] (head-major minor axis), indexed by the
// per-slot block table table [B, max_blocks] (int32, unallocated entries =
// the null block) with per-slot cursors pos [B].  Query row (i, h) attends
// key c iff c <= pos + i and, with a window, c > pos + i - window; head h
// reads KV head h / (H / KV).  In int8 mode the pools hold s8 values and
// ksc/vsc [n_blocks, block, KV] hold their fp32 per-(position, KV head)
// scales.  Output [B, tq, H, D] in q's dtype.  Only the
// logical blocks j with j * block <= pos + tq - 1 (and, with a window, at
// or after the window's first block) are read, so the null block's padding
// is never touched.
//
// Rounding points kept from the TPU kernel so bf16 agrees with the plain
// version: q * D^-0.5 is rounded to q's dtype before the dot; scores and
// the online-softmax m / l / acc are fp32; p is rounded to v's dtype
// before the PV product; the output is acc / max(l, 1e-30).  In int8
// mode the s8 values are widened to q's dtype (exact: |x| <= 127), the
// fp32 score is multiplied by the K scale before the mask, m and l take
// the unscaled p, and p is multiplied by the V scale -- by 0 on a masked
// key, whose scale row may be a stale tenant's -- before it is rounded.
//
// What bounds it.  Decode reads every covered KV block once and does ~2
// FLOPs per byte, so it is bound by HBM bytes:
//   sum_b ceil((pos_b + tq) / block) * block * KV * (D * 2 * sizeof(elt)
//                                                  + 2 * 4 in int8 mode).
// The design keeps those reads to one pass per (slot, KV head): the CTA
// stages each physical block's [block, D] K and V slice for its head in
// shared memory once, and all G * tq query rows of the group read it
// there, so GQA costs no extra HBM traffic.  That holds while the rows fit
// one pass (G * tq <= kMaxWarps * kRowsPerWarp = 64); beyond that the pool
// is read ceil(G * tq / 64) times.
//
// Design (right and simple first):
//   * one CTA per (KV head g, slot b); up to 16 warps, each holding up to
//     4 of the G * tq query rows (m, l, acc[D] in registers per row),
//     lanes across D (element d = e * 32 + lane, so neighbouring lanes
//     read neighbouring shared-memory words);
//   * the CTA loops over its slot's logical blocks — this loop replaces
//     the TPU grid's sequential "arbitrary" axis — reading table[b, j]
//     itself (the TPU's scalar prefetch);
//   * int8 mode stages the s8 [block, D] slice (half the bytes of bf16)
//     widened to q's dtype as it lands in shared memory, and the block's
//     two [block] scale columns (strided by KV floats in the scale pools),
//     so the inner loops are the fp mode's;
//   * for each staged block every warp walks its rows in turn: the
//     block's scores by warp-shuffle reductions, masked, then the online
//     softmax update of that row's m, l, acc; finally it writes its rows.
// Not yet: wgmma, TMA, cp.async pipelining or split-K.  At B * KV = 64
// CTAs (Llama-3.2-1B, 8 slots) the card's 132 SMs are under-filled, and
// at long context each CTA walks its whole prefix serially; flash-decoding
// split-K over the block axis is the known next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 16;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxBlock = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch does
}

// a pool element as q's dtype: a copy in fp mode, exact widening of s8
template <typename T>
__device__ __forceinline__ T widen(T x) {
  return x;
}
template <typename T>
__device__ __forceinline__ T widen(int8_t x) {
  return from_f<T>(static_cast<float>(x));
}

__device__ __forceinline__ bool lane_in(int d) {
  return static_cast<int>(threadIdx.x & 31) < d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T = q's dtype, P = the pools' (T, or int8_t with the scale pools ksc /
// vsc).  D = head dim (16, 32, 64 or 128); lane l holds elements e * 32 + l,
// EPL = ceil(D / 32) of them.  At D = 16 lanes 16..31 hold none: they add
// zeros to every dot product and write nothing.
template <typename T, typename P, int D>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const P* __restrict__ ck,
    const P* __restrict__ cv, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ table,
    const int* __restrict__ pos, T* __restrict__ out, int tq, int H, int KV,
    int bs, int max_blocks, int window, float scale) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int EPL = (D + 31) / 32;
  constexpr bool kFull = D % 32 == 0;
  const bool lane_live = kFull || lane_in(D);
  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // slot
  const int G = H / KV;
  const int R = G * tq;  // query rows of this CTA, r = i * G + gi
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int KVD = KV * D;
  const int p0 = pos[b];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);          // [bs, D]
  T* vs = ks + bs * D;                              // [bs, D]
  float* pws = reinterpret_cast<float*>(vs + bs * D);  // [nwarps, kMaxBlock]
  float* pw = pws + warp * kMaxBlock;
  float* kss = pws + nwarps * kMaxBlock;            // [bs] K scales (int8)
  float* vss = kss + kMaxBlock;                     // [bs] V scales (int8)

  // logical blocks that hold a readable key for some query row; a verify
  // span that runs past the row's end reads the row's blocks only (those
  // rows are discarded), as the plain version does
  const int j_hi = min((p0 + tq - 1) / bs, max_blocks - 1);
  int j_lo = 0;
  if (window > 0) {
    const int first = p0 - window + 1;
    j_lo = first > 0 ? first / bs : 0;
  }

  // rows r = rbase + rr * nwarps + warp; one pass covers them all while
  // R <= nwarps * kRowsPerWarp, so each block is staged once
  for (int rbase = 0; rbase < R; rbase += nwarps * kRowsPerWarp) {
    float qr[kRowsPerWarp][EPL], acc[kRowsPerWarp][EPL];
    float m[kRowsPerWarp], l[kRowsPerWarp];
    int qpos[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rbase + rr * nwarps + warp;
      const bool live = r < R;  // uniform per warp
      const int i = live ? r / G : 0;
      const int h = g * G + (live ? r % G : 0);
      qpos[rr] = live ? p0 + i : -1;  // -1: no key is valid, row idles
      const T* qrow = q + ((static_cast<size_t>(b) * tq + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        // the TPU kernel's first rounding point: (q * scale) in q's dtype
        qr[rr][e] = live && lane_live
                        ? to_f(from_f<T>(to_f(qrow[e * 32 + lane]) * scale))
                        : 0.f;
        acc[rr][e] = 0.f;
      }
      m[rr] = kNegInf;
      l[rr] = 0.f;
    }

    for (int j = j_lo; j <= j_hi; ++j) {
      const size_t pid = static_cast<size_t>(
          table[static_cast<size_t>(b) * max_blocks + j]);
      __syncthreads();  // every warp is done with the previous block
      const P* kb = ck + pid * bs * KVD + g * D;
      const P* vb = cv + pid * bs * KVD + g * D;
      for (int idx = threadIdx.x; idx < bs * D; idx += blockDim.x) {
        const int t = idx / D, d = idx % D;
        ks[idx] = widen<T>(kb[static_cast<size_t>(t) * KVD + d]);
        vs[idx] = widen<T>(vb[static_cast<size_t>(t) * KVD + d]);
      }
      if (kQuant) {
        for (int t = threadIdx.x; t < bs; t += blockDim.x) {
          const size_t at = (pid * bs + t) * KV + g;
          kss[t] = ksc[at];
          vss[t] = vsc[at];
        }
      }
      __syncthreads();

#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (rbase + rr * nwarps + warp >= R) continue;  // uniform per warp
        float mblk = kNegInf;
        for (int t = 0; t < bs; ++t) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (lane_live) s += qr[rr][e] * to_f(ks[t * D + e * 32 + lane]);
          s = warp_sum(s);  // every lane holds the full dot
          if (kQuant) s *= kss[t];
          const int c = j * bs + t;
          const bool valid =
              c <= qpos[rr] && (window <= 0 || c > qpos[rr] - window);
          s = valid ? s : kNegInf;
          if (lane == 0) pw[t] = s;
          mblk = fmaxf(mblk, s);
        }
        __syncwarp();
        const float m_new = fmaxf(m[rr], mblk);
        const float alpha = expf(m[rr] - m_new);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[rr][e] *= alpha;
        float psum = 0.f;
        for (int t = 0; t < bs; ++t) {
          float p = expf(pw[t] - m_new);
          psum += p;
          if (kQuant) {
            const int c = j * bs + t;
            const bool valid =
                c <= qpos[rr] && (window <= 0 || c > qpos[rr] - window);
            p *= valid ? vss[t] : 0.f;  // mask first: 0 * a stale scale
          }
          const float pr = to_f(from_f<T>(p));  // p in v's dtype for PV
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            if (lane_live) acc[rr][e] += pr * to_f(vs[t * D + e * 32 + lane]);
        }
        l[rr] = l[rr] * alpha + psum;
        m[rr] = m_new;
        __syncwarp();  // pw is rewritten by the next row or block
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rbase + rr * nwarps + warp;
      if (r >= R) continue;
      const int i = r / G, h = g * G + r % G;
      const float den = fmaxf(l[rr], 1e-30f);
      T* orow = out + ((static_cast<size_t>(b) * tq + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (lane_live) orow[e * 32 + lane] = from_f<T>(acc[rr][e] / den);
    }
  }
}

template <typename T, typename P, int D>
int launch(const void* q, const void* ck, const void* cv, const float* ksc,
           const float* vsc, const int* table, const int* pos, void* out,
           int B, int tq, int H, int KV, int bs, int max_blocks, int window,
           float scale, cudaStream_t stream) {
  const int R = (H / KV) * tq;
  const int nwarps = R < kMaxWarps ? R : kMaxWarps;
  const size_t smem =
      2 * static_cast<size_t>(bs) * D * sizeof(T) +
      (static_cast<size_t>(nwarps) + (sizeof(P) == 1 ? 2 : 0)) * kMaxBlock *
          sizeof(float);
  auto kern = paged_attention_kernel<T, P, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, B);
  kern<<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(ck),
      static_cast<const P*>(cv), ksc, vsc, table, pos, static_cast<T*>(out),
      tq, H, KV, bs, max_blocks, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (bound with ctypes).  dtype (of q and out): 0 = float32,
// 1 = bfloat16.  quant: 0 = the pools are q's dtype (ksc, vsc unused),
// 1 = s8 pools with fp32 scale pools ksc / vsc.  window <= 0 means no
// window.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take (the Python
// wrapper checks these first).
extern "C" int bps_paged_attention(const void* q, const void* ck,
                                   const void* cv, const float* ksc,
                                   const float* vsc, const int* table,
                                   const int* pos, void* out, int B, int tq,
                                   int H, int KV, int D, int bs,
                                   int max_blocks, int window, int dtype,
                                   int quant, float scale, void* stream) {
  if (B < 1 || tq < 1 || KV < 1 || H % KV != 0 || bs < 1 ||
      bs > kMaxBlock || max_blocks < 1 ||
      (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || (quant != 0 && quant != 1) ||
      (quant == 1 && (ksc == nullptr || vsc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_PAGED_LAUNCH(TYPE, POOL, DIM)                                  \
  return launch<TYPE, POOL, DIM>(q, ck, cv, ksc, vsc, table, pos, out, B, \
                                 tq, H, KV, bs, max_blocks, window, scale, \
                                 s)
#define BPS_PAGED_DIMS(TYPE, POOL)             \
  switch (D) {                                 \
    case 16: BPS_PAGED_LAUNCH(TYPE, POOL, 16);  \
    case 32: BPS_PAGED_LAUNCH(TYPE, POOL, 32);  \
    case 64: BPS_PAGED_LAUNCH(TYPE, POOL, 64);  \
    default: BPS_PAGED_LAUNCH(TYPE, POOL, 128); \
  }
  if (dtype == 0) {
    if (quant) BPS_PAGED_DIMS(float, int8_t)
    BPS_PAGED_DIMS(float, float)
  }
  if (quant) BPS_PAGED_DIMS(__nv_bfloat16, int8_t)
  BPS_PAGED_DIMS(__nv_bfloat16, __nv_bfloat16)
#undef BPS_PAGED_DIMS
#undef BPS_PAGED_LAUNCH
}
