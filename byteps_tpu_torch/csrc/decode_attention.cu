// Decode attention for Hopper (sm_90a), hand-written CUDA C++: one query
// token against a flat KV cache, fp or int8.
//
// Replaces the TPU kernel byteps_tpu/ops/decode_attention.py:71
// `_decode_kernel` (pallas_call at :277, wrapper `decode_attention` at
// :161), both its fp mode and its int8 mode.  Python binding, build and the
// plain PyTorch version live in byteps_tpu_torch/ops/decode_attention.py.
//
// What it computes.  q [B, 1, H, D] at the absolute position pos (the same
// for every row) against the caches ck/cv [B, S, KV*D] (head-major minor
// axis: KV head g holds columns [g*D, g*D + D)), fp32 or bf16 like q, or
// int8 with per-(position, KV head) fp32 scales k_scale/v_scale [B, S, KV].
// Query head h reads KV head h / (H / KV).  Key c is attended iff c <= pos
// and, with a window, c > pos - window.  Output [B, 1, H, D] in q's dtype.
//
// Rounding points kept from the TPU kernel so bf16 agrees with the plain
// version: q * D^-0.5 is rounded to q's dtype before the dot; scores and
// the online-softmax m / l / acc are fp32; in int8 mode the K scale
// multiplies the fp32 score; l sums p before the V scale; in int8 mode p is
// multiplied by the V scale (zero on masked keys); p is rounded to q's
// dtype before the PV product; the output is acc / max(l, 1e-30).
//
// What bounds it.  Each step reads the K and V rows of the attended keys
// once and does 4 FLOPs per head per key element (QK and PV): at G = H/KV
// query heads per KV head that is about 2 G / elt FLOPs per byte, far below
// the card's balance, so it is bound by HBM bytes:
//   B * n_keys * KV * D * 2 * elt   (+ B * n_keys * KV * 8 for int8 scales).
// The TPU design (a block-diagonal [H, KV*D] query padded to 16 rows and a
// one-hot contraction that discards the cross-head columns) exists to feed
// the MXU; here the GQA group shares each staged K/V chunk instead, so the
// cache is read once and no cross-head work is done.
//
// Design (right and simple first):
//   * the S axis is cut into chunks of kChunk keys; only the chunks that
//     hold an attended key are read (the TPU kernel's clamped index map and
//     pl.when), and rows past pos (or before the window, or at or past S)
//     are never read: they are staged as zeros;
//   * flash-decoding: grid (split, KV head, slot).  Each CTA walks `per`
//     consecutive chunks with an online softmax for its G query heads and
//     writes (m, l, acc) of its split; decode_attention_combine merges the
//     splits in order.  With one split the CTA writes the output itself.
//     The split count is chosen by the wrapper to put about eight CTAs on
//     every SM, so that their chunk loads overlap (at B = 8, KV = 8 and a
//     full 2048-key cache: 16 splits of 2 chunks, 1024 CTAs);
//   * per chunk: the K and V rows of the CTA's head are staged in shared
//     memory with 16-byte loads (rows padded by one word, so the lanes of
//     a warp reading one column of 32 rows hit 32 banks); each thread
//     computes scores for (head, key) pairs; one warp per head updates its
//     m / l and writes p; each thread accumulates its (head, d) outputs.
// Not yet: cp.async / TMA double-buffering of the next chunk, tensor cores
// for large G.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 64;     // keys per chunk
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));  // nearest even, as torch
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one CTA, in floats / 32-bit words:
//   qs [G*D], acc [G*D], sc [G*kChunk], mrow, lrow, alpha [G],
//   kscale, vscale [kChunk], kst, vst [kChunk * row_words]
// where a staged row holds D cache elements in D*sizeof(C)/4 words plus one
// word of padding.
template <typename C>
__host__ __device__ __forceinline__ int row_words(int D) {
  return D * static_cast<int>(sizeof(C)) / 4 + 1;
}

template <typename C>
__host__ __device__ __forceinline__ size_t smem_bytes(int G, int D) {
  return 4 * (static_cast<size_t>(2) * G * D + static_cast<size_t>(G) * kChunk +
              3 * G + 2 * kChunk +
              static_cast<size_t>(2) * kChunk * row_words<C>(D));
}

// Q: q / output dtype (float or bf16).  C: cache dtype (Q, or int8_t with
// scales).  part_*: the split's (m, l, acc) when gridDim.x > 1.
template <typename Q, typename C>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Q* __restrict__ q, const C* __restrict__ ck,
                            const C* __restrict__ cv,
                            const float* __restrict__ ksc,
                            const float* __restrict__ vsc, Q* __restrict__ out,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int S, int H, int KV,
                            int D, int pos, int window, int c_lo, int c_hi,
                            int per, float scale) {
  constexpr bool kQuant = sizeof(C) == 1;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int B = gridDim.z;
  const int G = H / KV;
  const int GD = G * D;
  const int KVD = KV * D;
  const int rw = row_words<C>(D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the first attended key (the window's), the last is pos
  const int first = window > 0 ? max(pos - window + 1, 0) : 0;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [G][D], q * scale in Q, as fp32
  float* acc = qs + GD;             // [G][D]
  float* sc = acc + GD;             // [G][kChunk] scores, then p
  float* mrow = sc + G * kChunk;    // [G]
  float* lrow = mrow + G;           // [G]
  float* alph = lrow + G;           // [G]
  float* kscale = alph + G;         // [kChunk]
  float* vscale = kscale + kChunk;  // [kChunk]
  uint32_t* kst = reinterpret_cast<uint32_t*>(vscale + kChunk);
  uint32_t* vst = kst + kChunk * rw;

  for (int i = threadIdx.x; i < GD; i += kThreads) {
    const int h = g * G + i / D, d = i % D;
    // the TPU kernel's first rounding point: (q * scale) in q's dtype
    qs[i] = round_to<Q>(to_f(q[(static_cast<size_t>(b) * H + h) * D + d]) *
                        scale);
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < G; i += kThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }

  const int j0 = c_lo + split * per;
  const int j1 = min(c_hi + 1, j0 + per);
  const int nvec = D * static_cast<int>(sizeof(C)) / 16;  // 16 B per row
  const size_t row_stride = static_cast<size_t>(KVD);     // elements
  const C* kbase = ck + static_cast<size_t>(b) * S * row_stride + g * D;
  const C* vbase = cv + static_cast<size_t>(b) * S * row_stride + g * D;
  for (int j = j0; j < j1; ++j) {
    const int c0 = j * kChunk;
    __syncthreads();  // the previous chunk's staged rows and p are consumed
    // stage the chunk's K / V rows of head g; unattended rows are zeros
    // (unrolled so that several iterations' loads are in flight at once)
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kChunk * nvec; idx += kThreads) {
      const int t = idx / nvec, v = idx % nvec;
      const int c = c0 + t;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (c >= first && c <= pos && c < S) {
        const size_t at = static_cast<size_t>(c) * row_stride;
        kv4 = reinterpret_cast<const uint4*>(kbase + at)[v];
        vv4 = reinterpret_cast<const uint4*>(vbase + at)[v];
      }
      uint32_t* kd = kst + t * rw + v * 4;
      uint32_t* vd = vst + t * rw + v * 4;
      kd[0] = kv4.x; kd[1] = kv4.y; kd[2] = kv4.z; kd[3] = kv4.w;
      vd[0] = vv4.x; vd[1] = vv4.y; vd[2] = vv4.z; vd[3] = vv4.w;
    }
    if (kQuant) {
      for (int t = threadIdx.x; t < kChunk; t += kThreads) {
        const int c = c0 + t;
        const bool in = c >= first && c <= pos && c < S;
        const size_t at = (static_cast<size_t>(b) * S + c) * KV + g;
        kscale[t] = in ? ksc[at] : 0.f;
        vscale[t] = in ? vsc[at] : 0.f;  // zero on masked keys, as the TPU
      }
    }
    __syncthreads();

    // scores of the (head, key) pairs: key t = i % kChunk, head i / kChunk
    for (int i = threadIdx.x; i < G * kChunk; i += kThreads) {
      const int t = i % kChunk, gi = i / kChunk;
      const float* qv = qs + gi * D;
      const C* kr = reinterpret_cast<const C*>(kst + t * rw);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qv[d] * to_f(kr[d]);
      const int c = c0 + t;
      const bool valid = c >= first && c <= pos && c < S;
      if (kQuant) s *= kscale[t];
      sc[i] = valid ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per head; kChunk = 64 keys = 2 per lane
    for (int gi = warp; gi < G; gi += kWarps) {
      float* row = sc + gi * kChunk;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_old = mrow[gi];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_old - m_new);
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      if (kQuant) {
        p0 *= vscale[lane];
        p1 *= vscale[lane + 32];
      }
      // p in q's dtype for the PV product
      row[lane] = round_to<Q>(p0);
      row[lane + 32] = round_to<Q>(p1);
      if (lane == 0) {
        lrow[gi] = lrow[gi] * alpha + psum;
        mrow[gi] = m_new;
        alph[gi] = alpha;
      }
    }
    __syncthreads();

    // acc[gi][d] = acc * alpha + sum_t p[gi][t] * v[t][d]
    for (int i = threadIdx.x; i < GD; i += kThreads) {
      const int gi = i / D, d = i % D;
      const float* p = sc + gi * kChunk;
      const C* vcol = reinterpret_cast<const C*>(vst) + d;
      const int vstride = rw * (4 / static_cast<int>(sizeof(C)));
      float a = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) a += p[t] * to_f(vcol[t * vstride]);
      acc[i] = acc[i] * alph[gi] + a;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < GD; i += kThreads) {
    const int gi = i / D, d = i % D, h = g * G + gi;
    if (nsplit == 1) {
      out[(static_cast<size_t>(b) * H + h) * D + d] =
          from_f<Q>(acc[i] / fmaxf(lrow[gi], 1e-30f));
    } else {
      const size_t r = (static_cast<size_t>(split) * B + b) * H + h;
      part_acc[r * D + d] = acc[i];
      if (d == 0) {
        part_m[r] = mrow[gi];
        part_l[r] = lrow[gi];
      }
    }
  }
}

// out[b, h] = merge over the splits, in order, of (m, l, acc): one CTA per
// (slot, head), one thread per d
template <typename Q>
__global__ void decode_attention_combine(const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         const float* __restrict__ part_acc,
                                         Q* __restrict__ out, int nsplit,
                                         int BH, int D) {
  const int r = blockIdx.x, d = threadIdx.x;
  if (d >= D) return;
  float M = kNegInf;
  for (int s = 0; s < nsplit; ++s)
    M = fmaxf(M, part_m[static_cast<size_t>(s) * BH + r]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t at = static_cast<size_t>(s) * BH + r;
    const float w = expf(part_m[at] - M);
    l += part_l[at] * w;
    a += part_acc[at * D + d] * w;
  }
  out[static_cast<size_t>(r) * D + d] = from_f<Q>(a / fmaxf(l, 1e-30f));
}

template <typename Q, typename C>
int launch(const void* q, const void* ck, const void* cv, const float* ksc,
           const float* vsc, void* out, float* part_m, float* part_l,
           float* part_acc, int B, int S, int H, int KV, int D, int pos,
           int window, int c_lo, int c_hi, int nsplit, int per, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(H / KV, D);
  auto kern = decode_attention_kernel<Q, C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const C*>(ck),
      static_cast<const C*>(cv), ksc, vsc, static_cast<Q*>(out), part_m,
      part_l, part_acc, S, H, KV, D, pos, window, c_lo, c_hi, per, scale);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (nsplit > 1) {
    decode_attention_combine<Q><<<B * H, D, 0, stream>>>(
        part_m, part_l, part_acc, static_cast<Q*>(out), nsplit, B * H, D);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// Shared memory one CTA needs, bytes (the wrapper refuses what does not fit
// 227 KB).  cache_int8: 0 = the cache has q's dtype, 1 = int8.
extern "C" long long bps_decode_attention_smem(int G, int D, int dtype,
                                               int cache_int8) {
  if (cache_int8) return static_cast<long long>(smem_bytes<int8_t>(G, D));
  return static_cast<long long>(dtype ? smem_bytes<__nv_bfloat16>(G, D)
                                      : smem_bytes<float>(G, D));
}

// C interface (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16 (q,
// out and, unless cache_int8, the caches); cache_int8 = 1: ck/cv int8 with
// k_scale/v_scale [B, S, KV] fp32.  Chunks c_lo..c_hi (of kChunk keys) are
// the ones holding attended keys; the grid walks them in nsplit splits of
// `per` chunks (part_m, part_l [nsplit, B, H] and part_acc [nsplit, B, H,
// D] fp32 scratch when nsplit > 1).  window <= 0 means no window.  Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take (the Python
// wrapper checks these first).
extern "C" int bps_decode_attention(
    const void* q, const void* ck, const void* cv, const float* k_scale,
    const float* v_scale, void* out, float* part_m, float* part_l,
    float* part_acc, int B, int S, int H, int KV, int D, int pos, int window,
    int c_lo, int c_hi, int nsplit, int per, int dtype, int cache_int8,
    float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || pos < 0 || pos >= S ||
      (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || c_lo < 0 || c_hi < c_lo ||
      c_hi * kChunk > pos || nsplit < 1 || per < 1 ||
      (nsplit - 1) * per > c_hi - c_lo || nsplit > 65535 || KV > 65535 ||
      B > 65535 || (cache_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_DECODE_LAUNCH(QT, CT)                                            \
  return launch<QT, CT>(q, ck, cv, k_scale, v_scale, out, part_m, part_l,    \
                        part_acc, B, S, H, KV, D, pos, window, c_lo, c_hi,   \
                        nsplit, per, scale, s)
  if (dtype == 0) {
    if (cache_int8) BPS_DECODE_LAUNCH(float, int8_t);
    BPS_DECODE_LAUNCH(float, float);
  }
  if (cache_int8) BPS_DECODE_LAUNCH(__nv_bfloat16, int8_t);
  BPS_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef BPS_DECODE_LAUNCH
}
