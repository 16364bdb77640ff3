// Paged-attention decode kernel for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel byteps_tpu/ops/paged_attention.py:76
// `_paged_kernel` (pallas_call at :286, wrapper `paged_decode_attention`
// at :165) in both its fp and its int8 mode, and the tensor-parallel
// wrapper `paged_decode_attention_sharded` (:306): one launch serves every
// shard.  Python binding, build and the plain PyTorch version live in
// byteps_tpu_torch/ops/paged_attention.py.
//
// What it computes.  q [B, tq, H, D] against flat block pools
// ck/cv [tp, n_blocks, block, (KV/tp)*D] (head-major minor axis; tp = 1 is
// the unsharded pool), indexed by the per-slot block table
// table [B, max_blocks] (int32, unallocated entries = the null block) with
// per-slot cursors pos [B].  Query row (i, h) attends key c iff
// c <= pos + i and, with a window, c > pos + i - window; head h reads KV
// head g = h / (H / KV), which shard g / (KV/tp) holds as its head
// g % (KV/tp).  In int8 mode the pools hold s8 values and
// ksc/vsc [tp, n_blocks, block, KV/tp] hold their fp32 per-(position, KV
// head) scales.  Output [B, tq, H, D] in q's dtype.  Only the logical
// blocks j with j * block <= pos + tq - 1 (and, with a window, at or after
// the window's first block) are read, so the null block's padding is
// never touched.
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
// Each (slot, KV head, block) is read by exactly one CTA, once, and all
// G * tq query rows of the group read it from shared memory there, so GQA
// and the verify width cost no extra HBM traffic.
//
// Design (flash-decoding over the block table, as csrc/decode_attention.cu
// does over a flat cache):
//   * grid (split, KV head of all shards, slot).  Split s owns the logical
//     blocks [s * per, (s + 1) * per).  The plan (splits, per) comes from
//     B, the total KV and max_blocks only -- about eight CTAs per SM --
//     never from pos, which stays on the device; so the launch is the same
//     for any cursors (a CUDA graph can hold it), and for tp = 1, 2 or 4:
//     every row's arithmetic is the unsharded launch's, bit for bit.  A
//     split wholly past its slot's last readable block, or before its
//     window, exits at once: it writes nothing, since the merge reads only
//     the live splits, whose range every CTA computes from pos;
//   * per block: the physical block's [block, D] K and V slice of the
//     CTA's KV head is staged with 16-byte cp.async (rows padded by 16
//     bytes so that eight 16-byte reads of eight rows hit distinct banks),
//     double-buffered: block j + 1 loads while block j computes.  In int8
//     mode the block's two [block] scale columns are staged too (4-byte
//     cp.async, strided by KV/tp floats), and s8 is widened to fp32 as it
//     is read from shared memory;
//   * threads over (query row, key) pairs compute the scores (q * scale in
//     shared memory as fp32; each dot in four interleaved chains), a group
//     of lanes per row (as many as the block has keys, up to 32: two rows
//     a warp at block 16) updates that row's m / l and writes p, threads
//     over (row, d) accumulate acc in shared memory; all G * tq rows in one
//     pass.  Capped at 64 registers, 8 CTAs share an SM: the 1024 CTAs of
//     8 slots x 8 KV heads x 16 splits run in one wave on 132 SMs;
//   * merge: with one live split its CTA writes the output.  Otherwise each
//     live split writes (m, l, acc) of its rows, and the last to finish --
//     a per-(slot, KV head) ticket that the merging CTA sets back to 0 --
//     merges all live splits in split order (never arrival order), so
//     reruns are bit-identical; no second launch.
// Not yet: TMA; tensor cores for the scores and PV of wide G * tq (a
// verify of tq = 5 is 4x the time of tq = 1, a scalar FMA chain per row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 64;
constexpr int kMinBlocks = 8;  // CTAs an SM must hold: 64 registers a thread
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// s8 widened to q's dtype is exact, so straight to fp32
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max / sum over the L lanes of an aligned group (L a power of 2 <= 32)
__device__ __forceinline__ float group_max(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element w of a 16-byte chunk of pool elements, as fp32 (w is a
// constant after unrolling, so the chunk stays in registers)
template <typename P>
__device__ __forceinline__ float chunk_elem(const uint4& u, int w);
template <>
__device__ __forceinline__ float chunk_elem<float>(const uint4& u, int w) {
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(x[w]);
}
template <>
__device__ __forceinline__ float chunk_elem<__nv_bfloat16>(const uint4& u,
                                                           int w) {
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
  const uint32_t word = x[w >> 1];
  return __uint_as_float((w & 1) ? (word & 0xffff0000u) : (word << 16));
}
template <>
__device__ __forceinline__ float chunk_elem<int8_t>(const uint4& u, int w) {
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
  return static_cast<float>(
      static_cast<int8_t>(static_cast<uint8_t>(x[w >> 2] >> (8 * (w & 3)))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const void* q;
  const void* ck;
  const void* cv;
  const float* ksc;
  const float* vsc;
  const int* table;
  const int* pos;
  void* out;
  float* part;   // [nsplit, B, KV, R] m, then l, then [.., R, D] acc
  int* tickets;  // [B * KV], zero between launches
  int B, tq, H, KV, tp, n_blocks, bs, max_blocks, window, nsplit, per;
  float scale;
};

// Shared memory of one CTA (bytes): two stages of K and V rows (D pool
// elements + 16 bytes each), two stages of the two scale columns, then
// q * scale and acc [R, D], the scores / p [R, block], m, l, alpha [R] and
// the merge flag, all fp32.
__host__ __device__ __forceinline__ size_t smem_bytes(int R, int D, int bs,
                                                      int elt) {
  return static_cast<size_t>(4) * bs * (D * elt + 16) +
         4 * (static_cast<size_t>(4) * kMaxBlock +
              static_cast<size_t>(2) * R * D + static_cast<size_t>(R) * bs +
              3 * static_cast<size_t>(R) + 4);
}

// T = q's dtype, P = the pools' (T, or int8_t with the scale pools).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    paged_attention_kernel(const Args a) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int VEC = 16 / static_cast<int>(sizeof(P));  // elements / 16 B
  constexpr int RE = D + VEC;  // staged row stride (elements): 16 B pad
  constexpr int CH = D / VEC;  // 16-byte chunks per row
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int KVs = a.KV / a.tp, shard = g / KVs, gl = g % KVs;
  const int G = a.H / a.KV, R = G * a.tq, bs = a.bs;
  const int L = bs >= 32 ? 32 : bs >= 16 ? 16 : bs >= 8 ? 8 : bs >= 4 ? 4
              : bs >= 2 ? 2 : 1;  // lanes per row in the softmax
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = a.pos[b];

  // logical blocks that hold a readable key for some query row; a verify
  // span that runs past the row's end reads the row's blocks only (those
  // rows are discarded), as the plain version does
  const int j_hi = min((p0 + a.tq - 1) / bs, a.max_blocks - 1);
  int j_lo = 0;
  if (a.window > 0) {
    const int first = p0 - a.window + 1;
    j_lo = first > 0 ? first / bs : 0;
  }
  const int s_lo = j_lo / a.per, s_hi = j_hi / a.per;
  if (split < s_lo || split > s_hi) return;  // no block of this split read
  const int j0 = max(j_lo, split * a.per);
  const int j1 = min(j_hi, split * a.per + a.per - 1);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* kst = reinterpret_cast<P*>(smem_raw);            // [2][bs][RE]
  P* vst = kst + 2 * bs * RE;                         // [2][bs][RE]
  float* kss = reinterpret_cast<float*>(vst + 2 * bs * RE);  // [2][kMaxBlock]
  float* vss = kss + 2 * kMaxBlock;                   // [2][kMaxBlock]
  float* qs = vss + 2 * kMaxBlock;                    // [R][D]
  float* acc = qs + R * D;                            // [R][D]
  float* sc = acc + R * D;                            // [R][bs]
  float* mrow = sc + R * bs;                          // [R]
  float* lrow = mrow + R;                             // [R]
  float* alph = lrow + R;                             // [R]
  int* last = reinterpret_cast<int*>(alph + R);

  const int KVsD = KVs * D;
  const size_t shard_rows = static_cast<size_t>(a.n_blocks) * bs;
  const P* kpool = static_cast<const P*>(a.ck) + shard * shard_rows * KVsD +
                   gl * D;
  const P* vpool = static_cast<const P*>(a.cv) + shard * shard_rows * KVsD +
                   gl * D;
  const float* kspool = kQuant ? a.ksc + shard * shard_rows * KVs + gl
                               : nullptr;
  const float* vspool = kQuant ? a.vsc + shard * shard_rows * KVs + gl
                               : nullptr;
  const int* trow = a.table + static_cast<size_t>(b) * a.max_blocks;

  // block j's K / V rows (and scales) into stage st, asynchronously
  auto stage = [&](int j, int st) {
    const size_t row0 = static_cast<size_t>(trow[j]) * bs;
    P* kd = kst + st * bs * RE;
    P* vd = vst + st * bs * RE;
    for (int idx = threadIdx.x; idx < bs * CH; idx += kThreads) {
      const int t = idx / CH, c = (idx % CH) * VEC;
      const size_t at = (row0 + t) * KVsD + c;
      cp_async16(kd + t * RE + c, kpool + at);
      cp_async16(vd + t * RE + c, vpool + at);
    }
    if constexpr (kQuant) {
      for (int t = threadIdx.x; t < bs; t += kThreads) {
        const size_t at = (row0 + t) * KVs;
        cp_async4(kss + st * kMaxBlock + t, kspool + at);
        cp_async4(vss + st * kMaxBlock + t, vspool + at);
      }
    }
  };
  stage(j0, 0);
  cp_async_commit();

  // query row r = i * G + gi is head g * G + gi at position p0 + i
  const T* qp = static_cast<const T*>(a.q);
  for (int x = threadIdx.x; x < R * D; x += kThreads) {
    const int r = x / D, d = x % D;
    const int h = g * G + r % G, i = r / G;
    // the TPU kernel's first rounding point: (q * scale) in q's dtype
    qs[x] = round_to<T>(
        to_f(qp[((static_cast<size_t>(b) * a.tq + i) * a.H + h) * D + d]) *
        a.scale);
    acc[x] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kThreads) {
    mrow[r] = kNegInf;
    lrow[r] = 0.f;
  }

  for (int j = j0; j <= j1; ++j) {
    const int st = (j - j0) & 1;
    if (j < j1) {  // the next block loads while this one computes
      stage(j + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const P* kd = kst + st * bs * RE;
    const P* vd = vst + st * bs * RE;
    const float* ks = kss + st * kMaxBlock;
    const float* vs = vss + st * kMaxBlock;

    // scores of the (row, key) pairs: key t = x % bs, row x / bs
    for (int x = threadIdx.x; x < R * bs; x += kThreads) {
      const int t = x % bs, r = x / bs;
      const float* qv = qs + r * D;
      const P* kr = kd + t * RE;
      float s4[4] = {0.f, 0.f, 0.f, 0.f};  // 4 chains: a quarter the latency
#pragma unroll
      for (int c = 0; c < D; c += VEC) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + c);
#pragma unroll
        for (int w = 0; w < VEC; w += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qv + c + w);
          s4[0] += qq.x * chunk_elem<P>(u, w);
          s4[1] += qq.y * chunk_elem<P>(u, w + 1);
          s4[2] += qq.z * chunk_elem<P>(u, w + 2);
          s4[3] += qq.w * chunk_elem<P>(u, w + 3);
        }
      }
      float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      if (kQuant) s *= ks[t];  // the K scale, before the mask
      const int c = j * bs + t, qpos = p0 + r / G;
      const bool valid = c <= qpos && (a.window <= 0 || c > qpos - a.window);
      sc[x] = valid ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: a group of L lanes per row (L = the largest power
    // of 2 <= min(block, 32)), 32 / L rows a warp at once
    for (int r0 = warp * (32 / L); r0 < R; r0 += kWarps * (32 / L)) {
      const int r = min(r0 + lane / L, R - 1);  // spare lanes redo row R-1
      const bool mine = r0 + lane / L < R;
      float* row = sc + r * bs;
      float mx = kNegInf;
      for (int t = lane % L; t < bs; t += L) mx = fmaxf(mx, row[t]);
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, group_max(mx, L));
      const float alpha = expf(m_old - m_new);
      const int qpos = p0 + r / G;
      float psum = 0.f;
      __syncwarp();  // every lane has read its row's scores
      for (int t = lane % L; t < bs && mine; t += L) {
        float p = expf(row[t] - m_new);
        psum += p;
        if (kQuant) {
          const int c = j * bs + t;
          const bool valid =
              c <= qpos && (a.window <= 0 || c > qpos - a.window);
          p *= valid ? vs[t] : 0.f;  // mask first: 0 * a stale scale
        }
        row[t] = round_to<T>(p);  // p in v's dtype for the PV product
      }
      psum = group_sum(psum, L);
      if (mine && lane % L == 0) {
        lrow[r] = lrow[r] * alpha + psum;
        mrow[r] = m_new;
        alph[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc * alpha + sum_t p[r][t] * v[t][d]
    for (int x = threadIdx.x; x < R * D; x += kThreads) {
      const int r = x / D, d = x % D;
      const float* p = sc + r * bs;
      const P* vcol = vd + d;
      float s = 0.f;
      for (int t = 0; t < bs; ++t) s += p[t] * to_f(vcol[t * RE]);
      acc[x] = acc[x] * alph[r] + s;
    }
    __syncthreads();  // this stage and p are consumed
  }

  T* out = static_cast<T*>(a.out);
  auto out_at = [&](int r, int d) -> T& {
    const int h = g * G + r % G, i = r / G;
    return out[((static_cast<size_t>(b) * a.tq + i) * a.H + h) * D + d];
  };
  if (s_lo == s_hi) {  // the only live split: the output is its own
    for (int x = threadIdx.x; x < R * D; x += kThreads)
      out_at(x / D, x % D) = from_f<T>(acc[x] / fmaxf(lrow[x / D], 1e-30f));
    return;
  }

  // this split's (m, l, acc), then the ticket
  const size_t rows = static_cast<size_t>(a.nsplit) * a.B * a.KV * R;
  float* part_m = a.part;
  float* part_l = part_m + rows;
  float* part_acc = part_l + rows;
  auto at = [&](int sp) {
    return ((static_cast<size_t>(sp) * a.B + b) * a.KV + g) * R;
  };
  const size_t mine = at(split);
  for (int x = threadIdx.x; x < R * D; x += kThreads)
    part_acc[mine * D + x] = acc[x];
  for (int r = threadIdx.x; r < R; r += kThreads) {
    part_m[mine + r] = mrow[r];
    part_l[mine + r] = lrow[r];
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  int* ticket = a.tickets + static_cast<size_t>(b) * a.KV + g;
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1) == s_hi - s_lo;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;  // every live split has taken one

  // merge the live splits in split order (L2 reads: other SMs wrote them)
  for (int x = threadIdx.x; x < R * D; x += kThreads) {
    const int r = x / D, d = x % D;
    float M = kNegInf;
    for (int sp = s_lo; sp <= s_hi; ++sp)
      M = fmaxf(M, __ldcg(part_m + at(sp) + r));
    float l = 0.f, v = 0.f;
    for (int sp = s_lo; sp <= s_hi; ++sp) {
      const size_t o = at(sp) + r;
      const float w = expf(__ldcg(part_m + o) - M);
      l += __ldcg(part_l + o) * w;
      v += __ldcg(part_acc + o * D + d) * w;
    }
    out_at(r, d) = from_f<T>(v / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      smem_bytes((a.H / a.KV) * a.tq, D, a.bs, static_cast<int>(sizeof(P)));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = paged_attention_kernel<T, P, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(a.nsplit, a.KV, a.B), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA needs (bytes) for R = G * tq query rows; the
// wrapper refuses a call above 227 KB.
extern "C" long long bps_paged_attention_smem(int R, int D, int block,
                                              int pool_elt) {
  return static_cast<long long>(smem_bytes(R, D, block, pool_elt));
}

// C interface (bound with ctypes).  Pools ck / cv [tp, n_blocks, block,
// (KV/tp)*D] (tp = 1: the unsharded pool), contiguous and 16-byte aligned;
// KV is the total over the shards.  dtype (of q and out): 0 = float32,
// 1 = bfloat16.  quant: 0 = the pools are q's dtype (ksc, vsc unused),
// 1 = s8 pools with fp32 scale pools ksc / vsc [tp, n_blocks, block,
// KV/tp].  window <= 0 means no window.  The grid walks max_blocks in
// nsplit splits of `per` blocks; with nsplit > 1, part is fp32 scratch of
// nsplit * B * H * tq * (D + 2) floats and tickets B * KV int32 zeros
// (left zero by the launch).  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a shape the kernel does not
// take (the Python wrapper checks these first).
extern "C" int bps_paged_attention(
    const void* q, const void* ck, const void* cv, const float* ksc,
    const float* vsc, const int* table, const int* pos, void* out,
    float* part, int* tickets, int B, int tq, int H, int KV, int tp,
    int n_blocks, int D, int bs, int max_blocks, int window, int nsplit,
    int per, int dtype, int quant, float scale, void* stream) {
  if (B < 1 || tq < 1 || KV < 1 || tp < 1 || KV % tp != 0 || H % KV != 0 ||
      n_blocks < 1 || bs < 1 || bs > kMaxBlock || max_blocks < 1 ||
      nsplit < 1 || per < 1 || static_cast<long long>(nsplit) * per <
                                   max_blocks ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)) ||
      nsplit > 65535 || KV > 65535 || B > 65535 ||
      (D != 16 && D != 32 && D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || (quant != 0 && quant != 1) ||
      (quant == 1 && (ksc == nullptr || vsc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       ck,  cv, ksc, vsc, table,    pos,        out,
               part,    tickets, B, tq, H, KV, tp, n_blocks, bs, max_blocks,
               window,  nsplit,  per, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_PAGED_LAUNCH(TYPE, POOL, DIM) \
  return launch<TYPE, POOL, DIM>(a, s)
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
