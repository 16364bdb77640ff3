// Decode attention for Hopper (sm_90a), hand-written CUDA C++: one query
// token against a flat KV cache, fp or int8.
//
// Replaces the TPU kernel byteps_tpu/ops/decode_attention.py:71
// `_decode_kernel` (pallas_call at :277, wrapper `decode_attention` at
// :161), both its fp mode and its int8 mode.  Python binding, build and the
// plain PyTorch version live in byteps_tpu_torch/ops/decode_attention.py.
//
// What it computes.  q [B, 1, H, D] at the absolute position pos (one
// host int for every row, or one position a row read from the device: the
// JAX kernel's scalar prefetch, which the dense serving engine's decode
// tick needs) against the caches ck/cv [B, S, KV*D] (head-major minor
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
// Every staged K/V chunk is shared by the G query heads of its KV head, so
// the cache is read once.  To near the HBM rate an SM needs tens of KB of
// loads in flight at all times, and the per-key work must stay off the
// SM's instruction slots: the first design's scalar dots read shared
// memory about 512 times a thread a chunk.  The ring design keeps chunks
// in flight behind the one computing and puts the dots on the tensor
// cores; at the generation shape one split a KV head (64 CTAs) then takes
// the time of two (128 CTAs), so what is left to the byte bound lies
// outside the SM's instruction rate: the first chunks' latency, the split
// merge's round trips, device-memory traffic.
//
// Design for a bf16 q (decode_ring_kernel; bf16 cache, or int8 + scales),
// up to 32 query heads a KV head (`ring_ok`; the wrapper's `_ring_ok`
// states it too):
//   * the S axis is cut into chunks of kChunk = 64 keys; only the chunks
//     that hold an attended key are read, and rows past pos (or before the
//     window) are never read: cp.async zero-fills them (source size 0);
//   * grid (split, KV head, slot), each split a run of `per` chunks (the
//     wrapper's plan: about one CTA an SM, and at least 8 chunks a split
//     where the cache has them, so the ring streams); 4 warps a CTA, warp
//     w owning the split's chunks w, w + 4, ... with its own online (m, l,
//     acc) in registers;
//   * a cp.async ring of 64-key K and V chunks (rows padded by 16 bytes:
//     the eight rows of an ldmatrix, or the lanes' 4-byte reads of int8
//     rows, hit distinct banks): two stages a warp where 8 fit 160 KB
//     (every case but bf16 at head_dim 128, which keeps one), so a warp's
//     next chunk is in flight while it computes; each warp waits for its
//     own copies only (cp.async.wait_group + __syncwarp), no CTA barrier
//     in the loop.  In int8 mode the chunk's 64 K and V scales ride along
//     (4-byte copies, strided by KV);
//   * scores S = Q K^T by mma.sync.m16n8k16 (bf16 in, fp32 out): Q is the
//     group's heads, rounded to bf16 once, zero-padded to 16 rows (two row
//     tiles when G > 16, as the TPU kernel pads its heads to feed the MXU);
//     bf16 K reaches the B fragments through ldmatrix, int8 K through one
//     4-byte read of four depth values, widened to bf16 in registers
//     (exact: |x| <= 127), with Q's columns stored in the matching order;
//     the K scale multiplies the fp32 score of its column;
//   * the online softmax runs on the accumulator fragments (a row's 64
//     scores in the 4 lanes of a quad), p = 2^(s log2 e - m log2 e); p
//     times the V scale in int8 mode, rounded to bf16, is the A operand of
//     PV as it lies; V comes through ldmatrix.trans (bf16) or as 4-byte
//     reads of two keys' rows interleaved into key pairs (int8; each
//     lane's output columns are then 8 consecutive values of d);
//   * merge: the CTA merges its warps in warp order through shared memory
//     (aliasing the ring); with one split it writes the output.  Otherwise
//     each split writes (m, l, acc) of its heads, and the last CTA of the
//     (slot, KV head) -- a per-(slot, KV head) ticket in an int32 buffer
//     that the merging CTA sets back to 0 -- merges the splits in split
//     order.  One launch a call; fixed orders, so reruns are bit-identical.
//   * device positions: the plan is sized for the longest row the cache
//     (and window) allows, each CTA reads pos[b] and walks its own chunks;
//     a split with none writes an empty partial and takes its ticket, so
//     the tickets return to zero whatever the positions are.
//
// The first design, which an fp32 q (with an fp32 or int8 cache) and more
// than 32 query heads a KV head keep (decode_attention_kernel +
// decode_attention_combine):
//   * flash-decoding: grid (split, KV head, slot).  Each CTA walks `per`
//     consecutive chunks with an online softmax for its G query heads and
//     writes (m, l, acc) of its split; decode_attention_combine merges the
//     splits in order.  With one split the CTA writes the output itself.
//     The split count puts about eight CTAs on every SM;
//   * per chunk: the K and V rows of the CTA's head are staged in shared
//     memory with 16-byte loads (rows padded by one word, so the lanes of
//     a warp reading one column of 32 rows hit 32 banks); each thread
//     computes scores for (head, key) pairs in fp32 FMA; one warp per head
//     updates its m / l and writes p; each thread accumulates its (head,
//     d) outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kChunk = 64;     // keys per chunk
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

// What one slot attends: keys [first, pos] of its row, in chunks
// [c_lo, c_hi] of kChunk keys.  Every CTA derives it from its slot's
// position (the launch's one pos, or its own in the device form).
struct Span {
  int pos, first, c_lo, c_hi;
};

__host__ __device__ __forceinline__ Span span_of(int pos, int window) {
  const int first = window > 0 ? max(pos - window + 1, 0) : 0;
  return {pos, first, first / kChunk, pos / kChunk};
}

// The most chunks one row of an S-row cache can attend (all of them, or
// the (window + 62) / kChunk + 1 a misaligned window touches): what the
// device form's plan must cover, whatever the positions are.
inline int max_chunks(int S, int window) {
  const int n = (S + kChunk - 1) / kChunk;
  return window > 0 ? min(n, (window + kChunk - 2) / kChunk + 1) : n;
}

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
                            float* __restrict__ part_acc,
                            const int* __restrict__ pos_dev, int S, int H,
                            int KV, int D, int pos, int window, int per,
                            float scale) {
  constexpr bool kQuant = sizeof(C) == 1;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  // the slot's span; in the device form the CTA reads the slot's own
  // position, and the plan (per, gridDim.x) covers any row
  const Span sp = span_of(
      pos_dev != nullptr ? min(max(pos_dev[b], 0), S - 1) : pos, window);
  pos = sp.pos;
  const int first = sp.first, c_lo = sp.c_lo, c_hi = sp.c_hi;
  const int nsplit = gridDim.x;
  const int B = gridDim.z;
  const int G = H / KV;
  const int GD = G * D;
  const int KVD = KV * D;
  const int rw = row_words<C>(D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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

  // a split past its slot's last chunk (device form only) streams
  // nothing and writes an empty partial: m = -1e30, l = acc = 0
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

// Counters a call fills (the Python wrapper predicts them): kernels
// launched by design, and the launches that read the position vector.
enum Count { kCountRing, kCountFirst, kCountCombine, kCountDevicePos, kCounts };

template <typename Q, typename C>
int launch(const void* q, const void* ck, const void* cv, const float* ksc,
           const float* vsc, void* out, float* part, const int* pos_dev,
           int B, int S, int H, int KV, int D, int pos, int window,
           int nsplit, int per, float scale, int* counts,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<C>(H / KV, D);
  auto kern = decode_attention_kernel<Q, C>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t rows = static_cast<size_t>(nsplit) * B * H;
  float* part_l = part == nullptr ? nullptr : part + rows;
  float* part_acc = part == nullptr ? nullptr : part + 2 * rows;
  kern<<<dim3(nsplit, KV, B), kThreads, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const C*>(ck),
      static_cast<const C*>(cv), ksc, vsc, static_cast<Q*>(out), part,
      part_l, part_acc, pos_dev, S, H, KV, D, pos, window, per, scale);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++counts[kCountFirst];
  counts[kCountDevicePos] += pos_dev != nullptr;
  if (nsplit > 1) {
    decode_attention_combine<Q><<<B * H, D, 0, stream>>>(
        part, part_l, part_acc, static_cast<Q*>(out), nsplit, B * H, D);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    ++counts[kCountCombine];
  }
  return 0;
}

// ------------------------------------------- bf16 q: tensor cores, a ring

constexpr int kRingWarps = 4;
constexpr int kRingThreads = 32 * kRingWarps;
constexpr int kRingMaxG = 32;            // query heads a KV head: 2 row tiles
constexpr int kRingBudget = 160 * 1024;  // two stages a warp where 8 fit
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a ring CTA: Q [16 RT][D + 8] bf16, then the ring of
// kRingWarps * kPerWarp stages (K rows, V rows [kChunk][kRow] bytes, and in
// int8 mode the K and V scales [kChunk] fp32), which the warps' (m, l, acc)
// [kRingWarps][16 RT] (+ [D]) fp32 alias once every warp is done; then the
// merging CTA's flag.
template <typename C, int D, int RT>
struct RingShape {
  static constexpr int kRow = D * static_cast<int>(sizeof(C)) + 16;
  static constexpr int kStage =
      2 * kChunk * kRow + (sizeof(C) == 1 ? 2 * kChunk * 4 : 0);
  static constexpr int kPerWarp =
      2 * kRingWarps * kStage <= kRingBudget ? 2 : 1;
  static constexpr int kLdq = D + 8;
  static constexpr int kQBytes = 16 * RT * kLdq * 2;
  static constexpr int kRing = kRingWarps * kPerWarp * kStage;
  static constexpr int kMerge = kRingWarps * 16 * RT * (D + 2) * 4;
  static constexpr int kBody = kRing > kMerge ? kRing : kMerge;
  static constexpr int kSmem = kQBytes + kBody + 16;
};

struct RingArgs {
  const void* q;
  const void* ck;
  const void* cv;
  const float* ksc;
  const float* vsc;
  void* out;
  float* part;   // [nsplit, B, H] m, then l, then [nsplit, B, H, D] acc
  int* tickets;  // [B * KV], zero between launches
  const int* pos_dev;  // [B] positions on the device, or null: pos below
  int S, H, KV, pos, window, per;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; a very negative x gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the four s8 of w as two bf16 pairs (bytes 0, 1 -> lo; 2, 3 -> hi),
// exactly: x + 128 as the low bits of 2^23's mantissa, less 2^23 + 128
__device__ __forceinline__ void s8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

// Q's column of depth d in shared memory.  In int8 mode the B fragment of
// k-step kk is one 4-byte read K[key][16 kk + 4t .. + 3] of lane t: its
// low pair takes the fragment's depths 2t, 2t + 1 and its high pair 2t +
// 8, 2t + 9, so Q's depth 4t + u of each 16 lies at 2t + u (u < 2) or 8 +
// 2t + u - 2.
template <bool QUANT>
__device__ __forceinline__ int q_col(int d) {
  if (!QUANT) return d;
  const int base = d & ~15, t = (d & 15) >> 2, u = d & 3;
  return base + (u < 2 ? 2 * t + u : 8 + 2 * t + u - 2);
}

// The lane's output column d of 8-column tile jd, fragment column c (2t +
// e).  bf16: d = 8 jd + c.  int8: tile jd = E h + i of E-byte groups (E =
// 4, or 2 at D = 16) holds d = 8E h + E c + i, so a lane's columns are E
// consecutive d per tile group.
template <bool QUANT, int D>
__device__ __forceinline__ int out_col(int jd, int c) {
  if (!QUANT) return 8 * jd + c;
  constexpr int E = D >= 32 ? 4 : 2;
  return 8 * E * (jd / E) + E * c + jd % E;
}

// One warp stages chunk c0 (keys [c0, c0 + kChunk)) of its KV head into
// `st`: K rows, V rows (and the K, V scales in int8 mode); keys outside
// [first, pos] are zero-filled without a read.
template <typename C, int D, int RT>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const C* kb,
                                            const C* vb, const float* ksb,
                                            const float* vsb, int KV,
                                            size_t row_stride, int c0,
                                            int first, int pos, int lane) {
  using L = RingShape<C, D, RT>;
  constexpr int kPieces = D * static_cast<int>(sizeof(C)) / 16;
  constexpr int kElts = 16 / static_cast<int>(sizeof(C));
#pragma unroll 4
  for (int idx = lane; idx < kChunk * kPieces; idx += 32) {
    const int t = idx / kPieces, pc = idx % kPieces, c = c0 + t;
    const bool in = c >= first && c <= pos;
    const size_t at = in ? c * row_stride + pc * kElts : 0;
    cp_async16(st + t * L::kRow + pc * 16, kb + at, in ? 16 : 0);
    cp_async16(st + (kChunk + t) * L::kRow + pc * 16, vb + at, in ? 16 : 0);
  }
  if (sizeof(C) == 1) {
    float* ks = reinterpret_cast<float*>(st + 2 * kChunk * L::kRow);
    for (int t = lane; t < kChunk; t += 32) {
      const int c = c0 + t;
      const bool in = c >= first && c <= pos;
      const size_t at = in ? static_cast<size_t>(c) * KV : 0;
      cp_async4(ks + t, ksb + at, in ? 4 : 0);
      cp_async4(ks + kChunk + t, vsb + at, in ? 4 : 0);  // 0: masked key
    }
  }
}

template <typename C, int D, int RT>
__global__ void __launch_bounds__(kRingThreads, 1)
    decode_ring_kernel(const RingArgs a) {
  using L = RingShape<C, D, RT>;
  constexpr bool kQuant = sizeof(C) == 1;
  constexpr int NT = D / 8;  // 8-column tiles of the output
  constexpr int R = 16 * RT;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, B = gridDim.z;
  const int G = a.H / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragment's row, column pair
  extern __shared__ __align__(16) unsigned char ring_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(ring_smem);
  unsigned char* body = ring_smem + L::kQBytes;
  int* flag = reinterpret_cast<int*>(body + L::kBody);

  // the slot's span; in the device form the CTA reads the slot's own
  // position, and a split past it streams nothing, writes an empty partial
  // (m = -1e30, l = acc = 0) and still takes its ticket
  const Span sp = span_of(
      a.pos_dev != nullptr ? min(max(a.pos_dev[b], 0), a.S - 1) : a.pos,
      a.window);
  const int pos = sp.pos, first = sp.first;
  const int j0 = sp.c_lo + split * a.per;
  const int n = min(sp.c_hi + 1, j0 + a.per) - j0;
  const int mine = n > warp ? (n - 1 - warp) / kRingWarps + 1 : 0;
  const size_t row_stride = static_cast<size_t>(a.KV) * D;
  const C* kb = static_cast<const C*>(a.ck) +
                static_cast<size_t>(b) * a.S * row_stride + g * D;
  const C* vb = static_cast<const C*>(a.cv) +
                static_cast<size_t>(b) * a.S * row_stride + g * D;
  const float* ksb =
      kQuant ? a.ksc + static_cast<size_t>(b) * a.S * a.KV + g : nullptr;
  const float* vsb =
      kQuant ? a.vsc + static_cast<size_t>(b) * a.S * a.KV + g : nullptr;
  auto stage = [&](int k) {
    return body + (warp * L::kPerWarp + k % L::kPerWarp) * L::kStage;
  };
  auto chunk0 = [&](int k) { return (j0 + warp + kRingWarps * k) * kChunk; };

  float m[RT][2], l[RT][2], acc[RT][NT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m[rt][rr] = kNegInf;
      l[rt][rr] = 0.f;
#pragma unroll
      for (int jd = 0; jd < NT; ++jd)
        acc[rt][jd][2 * rr] = acc[rt][jd][2 * rr + 1] = 0.f;
    }

  // the warp's first kPerWarp chunks in flight (an empty group where it
  // has fewer)
#pragma unroll
  for (int k = 0; k < L::kPerWarp; ++k) {
    if (k < mine)
      stage_chunk<C, D, RT>(stage(k), kb, vb, ksb, vsb, a.KV, row_stride,
                            chunk0(k), first, pos, lane);
    cp_async_commit();
  }
  // Q, while they fly: the group's heads, (q * scale) rounded to bf16,
  // rows >= G zero
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            (static_cast<size_t>(b) * a.H + g * G) * D;
  for (int i = threadIdx.x; i < R * D; i += kRingThreads) {
    const int r = i / D, d = i % D;
    const float v = r < G ? __bfloat162float(qg[r * D + d]) * a.scale : 0.f;
    Qs[r * L::kLdq + q_col<kQuant>(d)] = __float2bfloat16(v);
  }
  __syncthreads();
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<L::kPerWarp - 1>();  // chunk k's copies of this lane
    __syncwarp();                      // ... and of every lane
    const unsigned char* st = stage(k);
    const unsigned char* Ks = st;
    const unsigned char* Vs = st + kChunk * L::kRow;
    const float* ks = reinterpret_cast<const float*>(st + 2 * kChunk * L::kRow);
    const float* vs = ks + kChunk;
    const int c0 = chunk0(k);
    const bool edge = c0 < first || c0 + kChunk - 1 > pos;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      // S = Q K^T: 16 heads x 64 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, Qs + (rt * 16 + (lane & 15)) * L::kLdq + kk * 16 +
                        (lane >> 4) * 8);
        if constexpr (kQuant) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t b0, b1;
            s8x4_bf16(*reinterpret_cast<const uint32_t*>(
                          Ks + (8 * j + gq) * L::kRow + kk * 16 + 4 * tq),
                      b0, b1);
            mma_bf16(s[j], af, b0, b1);
          }
        } else {
#pragma unroll
          for (int j2 = 0; j2 < 4; ++j2) {
            uint32_t kf[4];  // keys j2*16 + [0, 8), [8, 16); d kk*16 + 16
            ldsm_x4(kf, Ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) *
                                 L::kRow +
                            (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
            mma_bf16(s[2 * j2], af, kf[0], kf[1]);
            mma_bf16(s[2 * j2 + 1], af, kf[2], kf[3]);
          }
        }
      }
      // the K scale, then the mask (chunks at the window's or pos's edge)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * tq + (e & 1);
          float x = s[j][e];
          if (kQuant) x *= ks[key];
          if (edge && (c0 + key < first || c0 + key > pos)) x = kNegInf;
          s[j][e] = x;
        }
      // online softmax; a row's 64 scores lie in the 4 lanes of a quad
      float ms[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rt][rr];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        ms[rr] = mx * kLog2e;
        const float alpha = ex2(fmaf(m[rt][rr], kLog2e, -ms[rr]));
        m[rt][rr] = mx;
        l[rt][rr] *= alpha;
#pragma unroll
        for (int jd = 0; jd < NT; ++jd) {
          acc[rt][jd][2 * rr] *= alpha;
          acc[rt][jd][2 * rr + 1] *= alpha;
        }
      }
      // rows 8-15 of the tile are all padding when G <= 16 rt + 8: no exp
      const bool low_only = G <= rt * 16 + 8;
      uint32_t pf[8][2];  // p in bf16: [j][0] row gq, [j][1] row gq + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = e >= 2 && low_only ? 0.f
                                    : ex2(fmaf(s[j][e], kLog2e, -ms[e >> 1]));
        l[rt][0] += p[0] + p[1];  // l sums p before the V scale
        l[rt][1] += p[2] + p[3];
        if (kQuant) {
          const float v0 = vs[8 * j + 2 * tq], v1 = vs[8 * j + 2 * tq + 1];
          p[0] *= v0;
          p[1] *= v1;
          p[2] *= v0;
          p[3] *= v1;
        }
        pf[j][0] = pack_bf16(p[0], p[1]);
        pf[j][1] = pack_bf16(p[2], p[3]);
      }
      // acc += P V: P's accumulator layout is the A operand's
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t af[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
        if constexpr (kQuant) {
          constexpr int E = D >= 32 ? 4 : 2;
#pragma unroll
          for (int h = 0; h < NT / E; ++h) {
            // keys 16 kk + 2t, + 1 (b0) and + 8, + 9 (b1); E bytes of d
            const unsigned char* col =
                Vs + (kk * 16 + 2 * tq) * L::kRow + 8 * E * h + E * gq;
            uint32_t w[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const unsigned char* p = col + ((r & 1) + 8 * (r >> 1)) * L::kRow;
              w[r] = E == 4 ? *reinterpret_cast<const uint32_t*>(p)
                            : *reinterpret_cast<const uint16_t*>(p);
            }
            uint32_t b0[4], b1[4];  // [i]: d = 8E h + E gq + i
            s8x4_bf16(__byte_perm(w[0], w[1], 0x5140), b0[0], b0[1]);
            s8x4_bf16(__byte_perm(w[0], w[1], 0x7362), b0[2], b0[3]);
            s8x4_bf16(__byte_perm(w[2], w[3], 0x5140), b1[0], b1[1]);
            s8x4_bf16(__byte_perm(w[2], w[3], 0x7362), b1[2], b1[3]);
#pragma unroll
            for (int i = 0; i < E; ++i)
              mma_bf16(acc[rt][E * h + i], af, b0[i], b1[i]);
          }
        } else {
#pragma unroll
          for (int j2 = 0; j2 < NT / 2; ++j2) {
            uint32_t vf[4];  // keys kk*16 + 16; d j2*16 + [0, 8), [8, 16)
            ldsm_x4_t(vf, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   L::kRow +
                              (j2 * 16 + (lane >> 4) * 8) * 2);
            mma_bf16(acc[rt][2 * j2], af, vf[0], vf[1]);
            mma_bf16(acc[rt][2 * j2 + 1], af, vf[2], vf[3]);
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
    if (k + L::kPerWarp < mine)
      stage_chunk<C, D, RT>(stage(k + L::kPerWarp), kb, vb, ksb, vsb, a.KV,
                            row_stride, chunk0(k + L::kPerWarp), first, pos,
                            lane);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the warps' (m, l, acc) into shared memory, over the ring
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rt][rr] += __shfl_xor_sync(0xffffffffu, l[rt][rr], 1);
      l[rt][rr] += __shfl_xor_sync(0xffffffffu, l[rt][rr], 2);
    }
  __syncthreads();  // every warp is done with the ring
  float* wm = reinterpret_cast<float*>(body);  // [kRingWarps][R]
  float* wl = wm + kRingWarps * R;             // [kRingWarps][R]
  float* wacc = wl + kRingWarps * R;           // [kRingWarps][R][D]
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rt * 16 + gq + 8 * rr;
      if (r >= G) continue;
      if (tq == 0) {
        wm[warp * R + r] = m[rt][rr];
        wl[warp * R + r] = l[rt][rr];
      }
      float* row = wacc + (warp * R + r) * D;
#pragma unroll
      for (int jd = 0; jd < NT; ++jd)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          row[out_col<kQuant, D>(jd, 2 * tq + e)] = acc[rt][jd][2 * rr + e];
    }
  __syncthreads();

  // merge the warps in warp order (a warp with no chunk has l = acc = 0
  // at m = -1e30, weight 0)
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const size_t BH = static_cast<size_t>(B) * a.H;
  const size_t head0 = static_cast<size_t>(b) * a.H + g * G;
  float* part_m = a.part;
  float* part_l = part_m + nsplit * BH;
  float* part_acc = part_l + nsplit * BH;
  for (int x = threadIdx.x; x < G * D; x += kRingThreads) {
    const int r = x / D, d = x % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) M = fmaxf(M, wm[w * R + r]);
    float lsum = 0.f, v = 0.f;
#pragma unroll
    for (int w = 0; w < kRingWarps; ++w) {
      const float f = expf(wm[w * R + r] - M);
      lsum += wl[w * R + r] * f;
      v += wacc[(w * R + r) * D + d] * f;
    }
    if (nsplit == 1) {
      out[(head0 + r) * D + d] = __float2bfloat16(v / fmaxf(lsum, 1e-30f));
    } else {
      const size_t o = split * BH + head0 + r;
      part_acc[o * D + d] = v;
      if (d == 0) {
        part_m[o] = M;
        part_l[o] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  int* ticket = a.tickets + static_cast<size_t>(b) * a.KV + g;
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;  // every split has taken one

  // the last CTA merges the splits in split order, in one pass (L2 reads:
  // other SMs wrote them; unrolled, so several splits' reads fly at once)
  for (int x = threadIdx.x; x < G * D; x += kRingThreads) {
    const int r = x / D, d = x % D;
    float M = kNegInf, lsum = 0.f, v = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < nsplit; ++sp) {
      const size_t o = sp * BH + head0 + r;
      const float ms = __ldcg(part_m + o), ls = __ldcg(part_l + o);
      const float as = __ldcg(part_acc + o * D + d);
      const float mn = fmaxf(M, ms);
      const float f0 = expf(M - mn), f1 = expf(ms - mn);
      lsum = lsum * f0 + ls * f1;
      v = v * f0 + as * f1;
      M = mn;
    }
    out[(head0 + r) * D + d] = __float2bfloat16(v / fmaxf(lsum, 1e-30f));
  }
}

template <typename C, int D, int RT>
int ring_launch(const RingArgs& a, int B, int nsplit, int* counts,
                cudaStream_t stream) {
  using L = RingShape<C, D, RT>;
  static_assert(L::kSmem <= 232448, "the ring fits a Hopper block");
  auto kern = decode_ring_kernel<C, D, RT>;
  static bool allowed = false;  // the dynamic shared memory, once a kernel
  if (!allowed) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem))
      return static_cast<int>(e);
    allowed = true;
  }
  kern<<<dim3(nsplit, a.KV, B), kRingThreads, L::kSmem, stream>>>(a);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  ++counts[kCountRing];
  counts[kCountDevicePos] += a.pos_dev != nullptr;
  return 0;
}

template <typename C, int RT>
int ring_by_d(const RingArgs& a, int B, int D, int nsplit, int* counts,
              cudaStream_t s) {
  switch (D) {
    case 16: return ring_launch<C, 16, RT>(a, B, nsplit, counts, s);
    case 32: return ring_launch<C, 32, RT>(a, B, nsplit, counts, s);
    case 64: return ring_launch<C, 64, RT>(a, B, nsplit, counts, s);
    default: return ring_launch<C, 128, RT>(a, B, nsplit, counts, s);
  }
}

template <typename C, int RT>
long long ring_smem_by_d(int D) {
  switch (D) {
    case 16: return RingShape<C, 16, RT>::kSmem;
    case 32: return RingShape<C, 32, RT>::kSmem;
    case 64: return RingShape<C, 64, RT>::kSmem;
    default: return RingShape<C, 128, RT>::kSmem;
  }
}

// The rule between the two designs (`_ring_ok` in the Python wrapper
// states it too): the ring takes a bf16 q with at most kRingMaxG query
// heads a KV head.
bool ring_ok(int dtype, int G) { return dtype == 1 && G <= kRingMaxG; }

}  // namespace

// Shared memory one CTA needs, bytes (the wrapper refuses what does not fit
// 227 KB).  cache_int8: 0 = the cache has q's dtype, 1 = int8; ring: the
// design on tensor cores.
extern "C" long long bps_decode_attention_smem(int G, int D, int dtype,
                                               int cache_int8, int ring) {
  if (ring) {
    if (!ring_ok(dtype, G) || (D != 16 && D != 32 && D != 64 && D != 128))
      return -1;
    if (cache_int8)
      return G > 16 ? ring_smem_by_d<int8_t, 2>(D)
                    : ring_smem_by_d<int8_t, 1>(D);
    return G > 16 ? ring_smem_by_d<__nv_bfloat16, 2>(D)
                  : ring_smem_by_d<__nv_bfloat16, 1>(D);
  }
  if (cache_int8) return static_cast<long long>(smem_bytes<int8_t>(G, D));
  return static_cast<long long>(dtype ? smem_bytes<__nv_bfloat16>(G, D)
                                      : smem_bytes<float>(G, D));
}

// C interface (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16 (q,
// out and, unless cache_int8, the caches); cache_int8 = 1: ck/cv int8 with
// k_scale/v_scale [B, S, KV] fp32.  Each CTA derives its slot's span (the
// chunks of kChunk keys holding attended keys, span_of) and walks it in
// nsplit splits of `per` chunks: a plan that covers n chunks, none of its
// splits wholly past them (n: the span's, or max_chunks in the device
// form).  With nsplit > 1, part is fp32 scratch of nsplit * B * H * (D + 2)
// floats, and the ring design (ring = 1, which `ring_ok` must
// allow) needs tickets, B * KV int32 zeros that every launch leaves zero
// (one stream at a time).  window <= 0 means no window.
//
// The device form (pos_dev != null): pos_dev holds B int32 positions on
// the device, one a slot, and `pos` is not read; the plan covers the most
// chunks any slot can attend (max_chunks), so it is a function of shapes.
// Each CTA reads its slot's position (clamped to [0, S - 1]) and walks its
// own chunks from its own first one; splits past them write empty
// partials, so a slot's output bits do not depend on the other slots'
// positions.
//
// counts[kCounts] receives the kernels this call launched: ring, first,
// combine, and the launches that read pos_dev.  Returns cudaGetLastError()
// after the launches (0 = launched), or cudaErrorInvalidValue for a shape
// or design the kernels do not take (the Python wrapper checks these
// first).
extern "C" int bps_decode_attention(
    const void* q, const void* ck, const void* cv, const float* k_scale,
    const float* v_scale, void* out, float* part, int* tickets, int B, int S,
    int H, int KV, int D, int pos, int window, int nsplit, int per,
    int dtype, int cache_int8, int ring, float scale, const int* pos_dev,
    int* counts, void* stream) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < kCounts; ++i) counts[i] = 0;
  const bool dev = pos_dev != nullptr;
  if (!dev && (pos < 0 || pos >= S))
    return static_cast<int>(cudaErrorInvalidValue);
  // the chunks the plan must cover: the one span, or any slot's
  const Span sp = span_of(pos, window);
  const int n = dev ? max_chunks(S, window) : sp.c_hi - sp.c_lo + 1;
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 ||
      (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || nsplit < 1 || per < 1 ||
      static_cast<long long>(nsplit - 1) * per >= n ||
      static_cast<long long>(nsplit) * per < n ||
      nsplit > 65535 || KV > 65535 ||
      B > 65535 || (cache_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (nsplit > 1 && part == nullptr) ||
      (ring && (!ring_ok(dtype, H / KV) || (nsplit > 1 && tickets == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ring) {
    const RingArgs a{q,  ck, cv, k_scale, v_scale, out,    part,
                     tickets, pos_dev, S,  H,  KV,      pos, window,
                     per,     scale};
    const bool two = H / KV > 16;
    if (cache_int8)
      return two ? ring_by_d<int8_t, 2>(a, B, D, nsplit, counts, s)
                 : ring_by_d<int8_t, 1>(a, B, D, nsplit, counts, s);
    return two ? ring_by_d<__nv_bfloat16, 2>(a, B, D, nsplit, counts, s)
               : ring_by_d<__nv_bfloat16, 1>(a, B, D, nsplit, counts, s);
  }
#define BPS_DECODE_LAUNCH(QT, CT)                                             \
  return launch<QT, CT>(q, ck, cv, k_scale, v_scale, out, part, pos_dev, B,   \
                        S, H, KV, D, pos, window, nsplit, per, scale, counts, \
                        s)
  if (dtype == 0) {
    if (cache_int8) BPS_DECODE_LAUNCH(float, int8_t);
    BPS_DECODE_LAUNCH(float, float);
  }
  if (cache_int8) BPS_DECODE_LAUNCH(__nv_bfloat16, int8_t);
  BPS_DECODE_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef BPS_DECODE_LAUNCH
}
