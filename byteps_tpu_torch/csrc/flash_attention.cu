// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward
// and both backward kernels.
//
// Replaces the TPU kernels of byteps_tpu/ops/flash_attention.py:
//   * flash_fwd_mma_kernel (bf16), flash_fwd_kernel (fp32)
//       <- `_fwd_kernel` (:116, pallas_call at :288)
//   * flash_bwd_dq_mma_kernel (bf16), flash_bwd_dq_kernel (fp32)
//       <- `_bwd_dq_kernel` (:374, pallas_call at :625)
//   * flash_bwd_dkv_mma_kernel (bf16), flash_bwd_dkv_kernel (fp32)
//       <- `_bwd_dkv_kernel` (:444, pallas_call at :661)
// Python binding, build and the plain PyTorch versions live in
// byteps_tpu_torch/ops/flash_attention.py.
//
// What they compute.  q [B, T, H, D], k / v [B, T, KV, D] (H % KV == 0:
// query head h reads KV head h / (H / KV) by index, never a repeat), in
// float32 or bfloat16, D in {16, 32, 64, 128}, any T.  Scores
// s = (q . k) * scale (+ slope_h * (col - row) with ALiBi), masked where
// col > row (causal), row - col >= window (sliding window), the segment
// ids of row and col differ, or col >= T.  Masked scores take no part in
// the softmax.
//   forward: o = softmax(s) v, lse = m + log(max(l, 1e-30)) [B, H, T] fp32
//   dq:      p = exp(s - lse), ds = p (dO . v - delta), dq = scale ds k
//   dk / dv: dv = p^T dO, dk = scale ds^T q, summed over the query heads
//            of the KV head's group inside the kernel
// delta = rowsum(dO * o) (minus the lse cotangent for the lse variant) is
// computed outside, as the TPU wrapper does.
//
// Rounding points kept from the TPU kernels, so bf16 agrees with the plain
// version: the dots multiply input-dtype values (exact in fp32) and sum in
// fp32; the softmax statistics are fp32; p is rounded to v's dtype before
// the PV product, p to dO's dtype before the dV product, ds to the
// operand dtype before the dq / dk products; outputs are rounded once.
//
// What bounds them.  At the training shape (T = 2048, D = 64) attention is
// compute-bound: ~T/2 FLOPs per byte of q, k, v.  The bound is the FLOPs
// over the card's peak for the dtype (989 TFLOP/s bf16 tensor cores,
// 67 TFLOP/s fp32 FMA).
//
// Forward, bf16 (flash_fwd_mma_kernel): tensor-core tiles.
//   * one CTA of 4 warps per (query head, 64-row q tile); each warp owns 16
//     query rows.  Q K^T and P V are mma.sync.m16n8k16 bf16 products with
//     fp32 accumulators, their operands read from shared memory with
//     ldmatrix (.trans for V, whose rows are keys);
//   * K / V tiles of 64 keys are staged with 16-byte cp.async into a
//     two-stage ring, so tile j+1 loads while tile j computes; rows at or
//     past T are zero-filled by the copy's source size (0 bytes read), not
//     by branching loads.  Shared rows are padded by 16 bytes so the eight
//     row addresses of an ldmatrix hit distinct banks;
//   * S stays in registers: the online softmax runs on the accumulator
//     fragments (a row's 64 scores sit in the 4 lanes of a quad: 2 quad
//     shuffles per max) on the unscaled dots, with p = 2^(s * scale *
//     log2(e) - m * scale * log2(e)): one FMA and one ex2.approx a score
//     (lse = m * scale + log(l), natural log).  P is rounded to bf16 in
//     registers and fed as the A operand of the PV product: the same
//     rounding point as the plain version's p.to(v.dtype);
//   * Q's fragments are read from shared memory at every tile rather
//     than held in registers: the kernel then fits 128 registers with no
//     spill at D = 64, so 4 CTAs share an SM (2 at D = 128);
//   * masks come from the fragment's (row, col) lane map (lane l holds rows
//     l/4 and l/4 + 8 and columns 2 (l%4) + {0, 1} of each 8-column block)
//     and are applied only to tiles that need them: the causal diagonal,
//     the window's edge, the T tail, and every tile when segment ids are
//     given.  ALiBi's slope * (col - row) is added to every tile before
//     the mask (as (slope / scale) * (col - row) on the unscaled dot);
//   * grid (query head in its KV group, batch * KV head, q tile): the G
//     query heads of one KV head run next to each other and share its K / V
//     tiles in L2, and causal q tiles launch longest first, so the short
//     tiles of the triangle's tail fill the last wave;
//   * o is rounded once; lse = m + log(max(l, 1e-30)); a fully masked row
//     gives o = 0 and lse = -1e30 + log(1e-30), as the plain version.
// Backward, bf16 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel): the
// same building blocks, with the products arranged so that nothing
// round-trips through shared memory.
//   * dq: one CTA of 4 warps per (query head in its KV group, batch * KV
//     head, 64-row q tile), launched as the forward (causal q tiles
//     longest first; the G heads of a KV head share its tiles in L2).  Q
//     and dO are staged once; K / V tiles of 64 keys run through the
//     two-stage cp.async ring.  Per 32-key chunk: S = Q K^T and dP = dO
//     V^T by mma.sync; p = 2^(s * scale * log2(e) + bias - lse * log2(e))
//     (ex2.approx); dS = p (dP - delta) packed to bf16 in registers (the
//     plain version's ds.to(k.dtype)) is the A operand of dQ += dS K, K
//     read by ldmatrix.trans.  dQ is scaled and rounded once;
//   * dk / dv: one CTA of 4 warps per (batch * KV head, 64-row k tile) owns
//     its dK / dV rows for the whole query-head group, so no two CTAs
//     write one row: no atomics, reruns bit-identical.  K and V stay in
//     shared memory; the CTA walks (g, q tile) in a fixed order with the
//     Q / dO tiles and their 64 lse and delta values in the cp.async ring.
//     The products are the transposed ones: S^T = K Q^T and dP^T = V dO^T
//     (Q, dO by ldmatrix non-transposed), so P^T and dS^T = P^T (dP^T -
//     delta) come out in the A operand's layout for dV += P^T dO and
//     dK += dS^T Q (dO, Q by ldmatrix.trans).  lse and delta belong to the
//     columns: each lane reads its columns' values from shared memory.
//     dK and dV sum the group in fp32 registers and are rounded once (the
//     plain version's group sum).  The grid is (batch * KV head, k tile),
//     so the low k tiles, which see the most q tiles under a causal mask,
//     launch first;
//   * masks, ALiBi and the tail as in the forward, on the C fragment's
//     lane map, only on tiles that need them; in dk / dv the query rows at
//     or past T (zero-filled, with lse = delta = 0) are masked explicitly;
//   * registers: dq holds dQ plus one 32-key chunk of S and dP (128
//     registers at D = 64, 4 CTAs an SM); dk / dv holds dK and dV and
//     walks 16-row q chunks in a loop that is not unrolled (128 registers
//     at D = 64, no spill; D = 128 takes 2 CTAs an SM in both);
//   * the pair recomputes Q K^T and dO V^T in both kernels: 14 D FLOPs an
//     attended pair against 10 D for a fused backward.  Fusing dq into the
//     dk / dv kernel needs fp32 atomics on dQ, whose order changes from
//     run to run, and the port keeps reruns bit-identical.
// fp32 (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// scalar fp32 FMA.  Tensor cores would mean TF32, whose 10-bit mantissa
// moves the fp32 rounding points that the training reference holds to
// 1e-5; so fp32 keeps the scalar path (right and simple first):
//   * one CTA of 256 threads per (batch * head, 64-row q tile) for the
//     forward and dq, per (batch * KV head, 64-row k tile) for dk / dv;
//   * the loop over the other operand's 64-row tiles inside the CTA takes
//     the place of the TPU grid's sequential "arbitrary" axis; causal
//     tiles above the diagonal and window tiles left of the band are not
//     visited;
//   * tiles are staged in shared memory as fp32 (rows padded by 4 floats
//     so 16-byte reads across rows hit distinct banks); thread (ty, tx) of
//     the 16 x 16 grid computes scores of rows ty*4..ty*4+3 and columns
//     tx + 16 j, and owns output columns tx*D/16.. of the same rows, so a
//     row's softmax reduces over 16 lanes of one warp with shuffles;
//   * dk / dv: each CTA owns its k tile for the whole head group, as above;
//   * tail rows and columns (index >= T) are staged as zeros and masked.
// Not yet: TMA / wgmma with a warp-specialised producer, forward and
// backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;       // 16 x 16: thread (ty, tx)
constexpr int kPad = 4;             // shared-memory row padding (floats)
constexpr int kPLd = kTile + kPad;  // row stride of the P / dS tile
constexpr float kMasked = -1e30f;

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

// x rounded to T and back (the TPU kernels' `.astype(dtype)` before a dot)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// N consecutive floats of shared memory (16- or 8-byte reads when N
// allows; the caller keeps the address aligned to them)
template <int N>
__device__ __forceinline__ void ld_row(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * u);
      x[4 * u] = t.x;
      x[4 * u + 1] = t.y;
      x[4 * u + 2] = t.z;
      x[4 * u + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int u = 0; u < N / 2; ++u) {
      const float2 t = *reinterpret_cast<const float2*>(p + 2 * u);
      x[2 * u] = t.x;
      x[2 * u + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) x[u] = p[u];
  }
}

// reduce over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + kTile) of head `head` of a [B, T, NH, D] tensor into
// dst [kTile][D + kPad] as fp32; rows at or past T are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int head, int NH, int T_,
                                      int row0) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < kTile * V4; idx += kThreads) {
    const int r = idx / V4, c = (idx % V4) * 4;
    const int t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T_)
      v = load4(src + ((static_cast<size_t>(b) * T_ + t) * NH + head) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = v;
  }
}

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d]   (A, B: [kTile][D + kPad])
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float (&s)[4][4], int ty, int tx) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][j] += sum_c P[ty*4+i][c] * X[c][tx*DPT+j]   (P: [kTile][kPLd])
template <int D>
__device__ __forceinline__ void mm_pv(const float* P, const float* X,
                                      float (&acc)[4][D / 16], int ty,
                                      int tx) {
  constexpr int LD = D + kPad, DPT = D / 16;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty * 4 + i) * kPLd + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x[DPT];
      ld_row<DPT>(X + (c + u) * LD + tx * DPT, x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          acc[i][j] = fmaf(comp(p[i], u), x[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_r P[r][ty*4+i] * X[r][tx*DPT+j]   (the transposed P)
template <int D>
__device__ __forceinline__ void mm_tn(const float* P, const float* X,
                                      float (&acc)[4][D / 16], int ty,
                                      int tx) {
  constexpr int LD = D + kPad, DPT = D / 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(P + r * kPLd + ty * 4);
    float x[DPT];
    ld_row<DPT>(X + r * LD + tx * DPT, x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(comp(p, i), x[j], acc[i][j]);
  }
}

struct Problem {
  int T, H, KV;
  int causal, window;  // window <= 0: none
  float scale;
  const int* seg;       // [B, T] or null
  const float* slopes;  // [H] or null
};

// the scaled, biased score of (row, col) and whether it is attended
__device__ __forceinline__ float score(const Problem& P, float dot, int row,
                                       int col, int seg_row, int seg_col,
                                       float slope, bool& ok) {
  float x = dot * P.scale;
  if (P.slopes) x += slope * static_cast<float>(col - row);
  ok = row < P.T && col < P.T;
  if (P.causal) {
    ok = ok && row >= col;
    if (P.window > 0) ok = ok && row - col < P.window;
  }
  if (P.seg) ok = ok && seg_row == seg_col;
  return x;
}

// k tiles a q tile [q0, q0 + kTile) visits
__device__ __forceinline__ void k_range(const Problem& P, int q0, int& lo,
                                        int& hi) {
  lo = 0;
  hi = (P.T - 1) / kTile;
  if (P.causal) {
    hi = min(hi, min(q0 + kTile - 1, P.T - 1) / kTile);
    if (P.window > 0) {
      const int first = q0 - (P.window - 1);
      lo = first > 0 ? first / kTile : 0;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Problem P) {
  constexpr int LD = D + kPad, DPT = D / 16;
  const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int kvh = h / (P.H / P.KV);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  stage<T, D>(Qs, q, b, h, P.H, P.T, q0);
  const float slope = P.slopes ? P.slopes[h] : 0.f;
  int row[4], seg_r[4];
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    seg_r[i] = P.seg && row[i] < P.T
                   ? P.seg[static_cast<size_t>(b) * P.T + row[i]] : 0;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  k_range(P, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D>(Ks, k, b, kvh, P.KV, P.T, k0);
    stage<T, D>(Vs, v, b, kvh, P.KV, P.T, k0);
    __syncthreads();
    float s[4][4];
    mm_nt<D>(Qs, Ks, s, ty, tx);
    int col[4], seg_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = k0 + tx + 16 * j;
      seg_c[j] = P.seg && col[j] < P.T
                     ? P.seg[static_cast<size_t>(b) * P.T + col[j]] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(P, s[i][j], row[i], col[j], seg_r[i], seg_c[j],
                        slope, ok[j]);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(ty * 4 + i) * kPLd + tx + 16 * j] = rnd<T>(p);  // p in v's dtype
      }
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_pv<D>(Ps, Vs, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= P.T) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * P.T + row[i]) * P.H + h) * D +
              tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[j] = from_f<T>(acc[i][j] / den);
    if (tx == 0) lse[static_cast<size_t>(bh) * P.T + row[i]] = m[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on tensor cores

constexpr int kMmaTile = 64;      // q rows of a CTA, and keys of a K / V tile
constexpr int kMmaThreads = 128;  // 4 warps x 16 q rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// 2^x (MUFU.EX2; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats as a bf16 pair (lo in the low half: the smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [row0, row0 + kMmaTile) of head `head` of a [B, T, NH, D] bf16
// tensor into dst [kMmaTile][D + 8] with cp.async; rows at or past T are
// zero-filled (their source is row 0, of which no byte is read)
template <int D>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src, int b,
                                            int head, int NH, int T_,
                                            int row0) {
  constexpr int CH = D / 8, LD = D + 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < kMmaTile * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int t = row0 + r;
    const bool in = t < T_;
    cp_async16(dst + r * LD + c,
               src + ((static_cast<size_t>(b) * T_ + (in ? t : 0)) * NH +
                      head) * D + c,
               in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 2)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, Problem P) {
  constexpr int LD = D + 8;          // shared row stride (elements)
  constexpr int KSTEPS = D / 16;     // k-steps of Q K^T
  constexpr int NB = kMmaTile / 8;   // 8-key blocks of S
  constexpr int DB = D / 8;          // 8-column blocks of O
  const int G = P.H / P.KV;
  const int bkv = blockIdx.y, b = bkv / P.KV, kvh = bkv % P.KV;
  const int h = kvh * G + blockIdx.x;
  const int n_tiles = (P.T + kMmaTile - 1) / kMmaTile;
  const int qt = P.causal ? n_tiles - 1 - static_cast<int>(blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int q0 = qt * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kMmaTile * LD;      // [2][kMmaTile][LD]
  __nv_bfloat16* Vs = Ks + 2 * kMmaTile * LD;  // [2][kMmaTile][LD]

  int lo, hi;
  k_range(P, q0, lo, hi);
  stage_async<D>(Qs, q, b, h, P.H, P.T, q0);
  stage_async<D>(Ks, k, b, kvh, P.KV, P.T, lo * kMmaTile);
  stage_async<D>(Vs, v, b, kvh, P.KV, P.T, lo * kMmaTile);
  cp_async_commit();

  // this lane's two rows: rr = 0 -> quad_row, rr = 1 -> quad_row + 8
  int row[2], seg_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q0 + warp * 16 + quad_row + rr * 8;
    seg_r[rr] = P.seg && row[rr] < P.T
                    ? P.seg[static_cast<size_t>(b) * P.T + row[rr]] : -1;
  }
  const float sc2 = P.scale * kLog2e;
  const float sl2 = P.slopes ? P.slopes[h] / P.scale : 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const __nv_bfloat16* q_row = Qs + (warp * 16 + (lane & 15)) * LD +
                               (lane >> 4) * 8;

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt < hi) {  // the next tile loads while this one computes
      stage_async<D>(Ks + (st ^ 1) * kMmaTile * LD, k, b, kvh, P.KV, P.T,
                     (kt + 1) * kMmaTile);
      stage_async<D>(Vs + (st ^ 1) * kMmaTile * LD, v, b, kvh, P.KV, P.T,
                     (kt + 1) * kMmaTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * kMmaTile * LD;
    const __nv_bfloat16* Vt = Vs + st * kMmaTile * LD;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];  // Q from shared memory: no registers held across
      ldsm_x4(a, q_row + kk * 16);  // tiles, so 4 CTAs fit an SM at D = 64
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t kb[4];  // keys j2*16 + [0, 8) and [8, 16), d kk*16 + [0, 16)
        ldsm_x4(kb, Kt + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], a, kb[0], kb[1]);
        mma_bf16(s[2 * j2 + 1], a, kb[2], kb[3]);
      }
    }

    // ALiBi, and the mask where this tile needs one (on unscaled dots)
    const int k0 = kt * kMmaTile;
    const bool need_mask =
        P.seg != nullptr || k0 + kMmaTile > P.T ||
        (P.causal && (k0 + kMmaTile - 1 > q0 ||
                      (P.window > 0 && q0 + kMmaTile - 1 - k0 >= P.window)));
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], col = k0 + j * 8 + quad_col + (e & 1);
        float x = s[j][e];
        if (P.slopes) x += sl2 * static_cast<float>(col - r);
        if (need_mask) {
          bool ok = col < P.T;
          if (P.causal) {
            ok = ok && r >= col;
            if (P.window > 0) ok = ok && r - col < P.window;
          }
          if (P.seg)
            ok = ok && col < P.T &&
                 __ldg(P.seg + static_cast<size_t>(b) * P.T + col) ==
                     seg_r[e >> 1];
          if (!ok) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragments; a row lives in the 4 lanes of a quad
    float mu[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // mu = m * scale * log2(e); a row with nothing attended yet keeps
      // every p at 2^-inf = 0 against mu = 0
      mu[rr] = mx == -INFINITY ? 0.f : mx * sc2;
      const float alpha = ex2(m[rr] * sc2 - mu[rr]);
      m[rr] = mx;
      l[rr] *= alpha;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        acc[j][2 * rr] *= alpha;
        acc[j][2 * rr + 1] *= alpha;
      }
    }
    uint32_t pf[NB][2];  // p in bf16: [j][0] row quad_row, [j][1] row + 8
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float p0 = ex2(fmaf(s[j][0], sc2, -mu[0]));
      const float p1 = ex2(fmaf(s[j][1], sc2, -mu[0]));
      const float p2 = ex2(fmaf(s[j][2], sc2, -mu[1]));
      const float p3 = ex2(fmaf(s[j][3], sc2, -mu[1]));
      l[0] += p0 + p1;  // l sums the fp32 p, this lane's columns
      l[1] += p2 + p3;
      pf[j][0] = pack_bf16(p0, p1);
      pf[j][1] = pack_bf16(p2, p3);
    }

    // O += P V: P's accumulator layout is the A operand's
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
#pragma unroll
      for (int j2 = 0; j2 < DB / 2; ++j2) {
        uint32_t vb[4];  // keys kk*16 + [0, 16), d j2*16 + [0, 8), [8, 16)
        ldsm_x4_t(vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + j2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * j2], a, vb[0], vb[1]);
        mma_bf16(acc[2 * j2 + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    if (row[rr] >= P.T) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<size_t>(b) * P.T + row[rr]) * P.H + h) * D +
        quad_col;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * rr] / den, acc[j][2 * rr + 1] / den);
    if ((lane & 3) == 0)
      lse[(static_cast<size_t>(b) * P.H + h) * P.T + row[rr]] =
          (m[rr] == -INFINITY ? kMasked : m[rr] * P.scale) + logf(den);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Problem P) {
  constexpr int LD = D + kPad, DPT = D / 16;
  const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int kvh = h / (P.H / P.KV);
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ss = Vs + kTile * LD;  // dS

  stage<T, D>(Qs, q, b, h, P.H, P.T, q0);
  stage<T, D>(dOs, dout, b, h, P.H, P.T, q0);
  const float slope = P.slopes ? P.slopes[h] : 0.f;
  int row[4], seg_r[4];
  float lse_r[4], delta_r[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    const bool live = row[i] < P.T;
    const size_t at = static_cast<size_t>(bh) * P.T + row[i];
    seg_r[i] = P.seg && live ? P.seg[static_cast<size_t>(b) * P.T + row[i]]
                             : 0;
    lse_r[i] = live ? lse[at] : 0.f;
    delta_r[i] = live ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  k_range(P, q0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<T, D>(Ks, k, b, kvh, P.KV, P.T, k0);
    stage<T, D>(Vs, v, b, kvh, P.KV, P.T, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt<D>(Qs, Ks, s, ty, tx);
    mm_nt<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const int seg_c = P.seg && col < P.T
                            ? P.seg[static_cast<size_t>(b) * P.T + col] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const float x = score(P, s[i][j], row[i], col, seg_r[i], seg_c,
                              slope, ok);
        const float p = ok ? expf(x - lse_r[i]) : 0.f;
        Ss[(ty * 4 + i) * kPLd + tx + 16 * j] =
            rnd<T>(p * (dp[i][j] - delta_r[i]));  // ds in k's dtype
      }
    }
    __syncthreads();
    mm_pv<D>(Ss, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= P.T) continue;
    T* out = dq + ((static_cast<size_t>(b) * P.T + row[i]) * P.H + h) * D +
             tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j) out[j] = from_f<T>(acc[i][j] * P.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Problem P) {
  constexpr int LD = D + kPad, DPT = D / 16;
  const int bkv = blockIdx.y, b = bkv / P.KV, kvh = bkv % P.KV;
  const int G = P.H / P.KV;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;  // P, then dS

  stage<T, D>(Ks, k, b, kvh, P.KV, P.T, k0);
  stage<T, D>(Vs, v, b, kvh, P.KV, P.T, k0);
  int col[4], seg_c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[j] = k0 + tx + 16 * j;
    seg_c[j] = P.seg && col[j] < P.T
                   ? P.seg[static_cast<size_t>(b) * P.T + col[j]] : 0;
  }
  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  // q tiles that see this k tile
  int lo = 0, hi = (P.T - 1) / kTile;
  if (P.causal) {
    lo = k0 / kTile;
    if (P.window > 0) hi = min(hi, (k0 + kTile - 1 + P.window - 1) / kTile);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int bh = b * P.H + h;
    const float slope = P.slopes ? P.slopes[h] : 0.f;
    for (int qt = lo; qt <= hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      stage<T, D>(Qs, q, b, h, P.H, P.T, q0);
      stage<T, D>(dOs, dout, b, h, P.H, P.T, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      mm_nt<D>(Qs, Ks, s, ty, tx);    // rows: q, columns: k
      mm_nt<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        const bool live = row < P.T;
        const size_t at = static_cast<size_t>(bh) * P.T + row;
        const int seg_r =
            P.seg && live ? P.seg[static_cast<size_t>(b) * P.T + row] : 0;
        const float lse_r = live ? lse[at] : 0.f;
        const float delta_r = live ? delta[at] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bool ok;
          const float x = score(P, s[i][j], row, col[j], seg_r, seg_c[j],
                                slope, ok);
          const float p = ok ? expf(x - lse_r) : 0.f;
          Ps[(ty * 4 + i) * kPLd + tx + 16 * j] = rnd<T>(p);  // dO's dtype
          s[i][j] = p * (dp[i][j] - delta_r);                  // ds
        }
      }
      __syncthreads();
      mm_tn<D>(Ps, dOs, dv_acc, ty, tx);
      __syncthreads();  // P is consumed; the tile now takes dS
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty * 4 + i) * kPLd + tx + 16 * j] = rnd<T>(s[i][j]);
      __syncthreads();
      mm_tn<D>(Ps, Qs, dk_acc, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= P.T) continue;
    const size_t at = ((static_cast<size_t>(b) * P.T + r) * P.KV + kvh) * D +
                      tx * DPT;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[at + j] = from_f<T>(dk_acc[i][j] * P.scale);
      dv[at + j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on tensor cores

// columns of S a warp holds at once (keys in dq, query rows in dk / dv):
// the products run over the 64-column tile in chunks, so one chunk's score
// and dP fragments are all that is live beside the accumulators.  dk / dv
// hold two accumulators (dK and dV) and walk 16-row chunks in a loop that
// is not unrolled; that fits 128 registers with no spill at D = 64, so 4
// CTAs share an SM (ptxas, chip_smoke.py's "ptxas" phase)
constexpr int kDqChunk = 32;
constexpr int kDkvChunk = 16;

// lane offsets (elements) into a [rows][D + 8] bf16 tile for the ldmatrix
// reads of a 16-row block at a 16-column offset: as the B operand of a
// product whose rows are the tile's rows (non-transposed: keys of K in
// Q K^T), and transposed (the tile's rows are the product's depth: V in
// P V)
__device__ __forceinline__ int b_off(int lane, int LD) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int LD) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}
// ... and as the A operand (16 rows x 16 columns, row-major)
__device__ __forceinline__ int a_off(int lane, int LD) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}

// 4 bytes global -> shared (src_bytes = 0 writes a zero)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// acc (16 x D) += a (16 x 16 in registers) * the 16 x D tile at `t` (rows
// of `t` are the product's depth: ldmatrix.trans)
template <int D>
__device__ __forceinline__ void mma_rows_tn(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[4],
                                            const __nv_bfloat16* t) {
#pragma unroll
  for (int j2 = 0; j2 < D / 16; ++j2) {
    uint32_t bb[4];
    ldsm_x4_t(bb, t + j2 * 16);
    mma_bf16(acc[2 * j2], a, bb[0], bb[1]);
    mma_bf16(acc[2 * j2 + 1], a, bb[2], bb[3]);
  }
}

// s (16 rows x NC * 8 columns) = A (16 x D at `a_row`, ldmatrix rows) *
// B^T, B the NC * 8 rows of D at `b` (non-transposed ldmatrix offsets)
template <int D, int NC>
__device__ __forceinline__ void mma_nt(float (&s)[NC][4],
                                       const __nv_bfloat16* a_row,
                                       const __nv_bfloat16* b, int LD) {
#pragma unroll
  for (int j = 0; j < NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_row + kk * 16);
#pragma unroll
    for (int j2 = 0; j2 < NC / 2; ++j2) {
      uint32_t bb[4];
      ldsm_x4(bb, b + j2 * 16 * LD + kk * 16);
      mma_bf16(s[2 * j2], a, bb[0], bb[1]);
      mma_bf16(s[2 * j2 + 1], a, bb[2], bb[3]);
    }
  }
}

// whether query row r attends key c, leaving out the segment test
__device__ __forceinline__ bool band_ok(const Problem& P, int r, int c) {
  bool ok = r < P.T && c < P.T;
  if (P.causal) {
    ok = ok && r >= c;
    if (P.window > 0) ok = ok && r - c < P.window;
  }
  return ok;
}

// whether the (q tile, k tile) pair holds a masked entry
__device__ __forceinline__ bool tile_needs_mask(const Problem& P, int q0,
                                                int k0) {
  return P.seg != nullptr || q0 + kMmaTile > P.T || k0 + kMmaTile > P.T ||
         (P.causal && (k0 + kMmaTile - 1 > q0 ||
                       (P.window > 0 && q0 + kMmaTile - 1 - k0 >= P.window)));
}

// dq: one CTA of 4 warps per (query head in its KV group, batch * KV head,
// 64-row q tile); each warp owns 16 query rows and walks the k tiles.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 2)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, Problem P) {
  constexpr int LD = D + 8;
  constexpr int DB = D / 8;            // 8-column blocks of dQ
  constexpr int NC = kDqChunk / 8;     // 8-key blocks of a chunk
  const int G = P.H / P.KV;
  const int bkv = blockIdx.y, b = bkv / P.KV, kvh = bkv % P.KV;
  const int h = kvh * G + blockIdx.x;
  const int n_tiles = (P.T + kMmaTile - 1) / kMmaTile;
  const int qt = P.causal ? n_tiles - 1 - static_cast<int>(blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int q0 = qt * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + kMmaTile * LD;
  __nv_bfloat16* Ks = dOs + kMmaTile * LD;     // [2][kMmaTile][LD]
  __nv_bfloat16* Vs = Ks + 2 * kMmaTile * LD;  // [2][kMmaTile][LD]

  int lo, hi;
  k_range(P, q0, lo, hi);
  stage_async<D>(Qs, q, b, h, P.H, P.T, q0);
  stage_async<D>(dOs, dout, b, h, P.H, P.T, q0);
  stage_async<D>(Ks, k, b, kvh, P.KV, P.T, lo * kMmaTile);
  stage_async<D>(Vs, v, b, kvh, P.KV, P.T, lo * kMmaTile);
  cp_async_commit();

  // this lane's two rows (quad_row, quad_row + 8 of the warp's 16); a row
  // at or past T reads lse = delta = 0 and is not written
  const size_t bh = static_cast<size_t>(b) * P.H + h;
  int row[2], seg_r[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q0 + warp * 16 + quad_row + rr * 8;
    const bool live = row[rr] < P.T;
    seg_r[rr] = P.seg && live
                    ? P.seg[static_cast<size_t>(b) * P.T + row[rr]] : -1;
    lse2[rr] = live ? lse[bh * P.T + row[rr]] * kLog2e : 0.f;
    dl[rr] = live ? delta[bh * P.T + row[rr]] : 0.f;
  }
  const float sc2 = P.scale * kLog2e;
  const float sl2 = P.slopes ? P.slopes[h] / P.scale : 0.f;
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ao = (warp * 16) * LD + a_off(lane, LD);
  const int bo = b_off(lane, LD), bto = bt_off(lane, LD);

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = (kt - lo) & 1;
    if (kt < hi) {  // the next tile loads while this one computes
      stage_async<D>(Ks + (st ^ 1) * kMmaTile * LD, k, b, kvh, P.KV, P.T,
                     (kt + 1) * kMmaTile);
      stage_async<D>(Vs + (st ^ 1) * kMmaTile * LD, v, b, kvh, P.KV, P.T,
                     (kt + 1) * kMmaTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * kMmaTile * LD;
    const __nv_bfloat16* Vt = Vs + st * kMmaTile * LD;
    const int k0 = kt * kMmaTile;
    const bool need_mask = tile_needs_mask(P, q0, k0);

#pragma unroll
    for (int c = 0; c < kMmaTile; c += kDqChunk) {
      // S = Q K^T and dP = dO V^T for this chunk's keys, 16 rows a warp
      float s[NC][4], dp[NC][4];
      mma_nt<D, NC>(s, Qs + ao, Kt + c * LD + bo, LD);
      mma_nt<D, NC>(dp, dOs + ao, Vt + c * LD + bo, LD);
      // p = exp(s - lse) and dS = p (dP - delta), in bf16 as dQ's A operand
      uint32_t dsf[NC][2];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e >> 1], col = k0 + c + j * 8 + quad_col + (e & 1);
          float x = s[j][e];
          if (P.slopes) x += sl2 * static_cast<float>(col - r);
          if (need_mask) {
            bool ok = band_ok(P, r, col);
            if (P.seg)
              ok = ok && __ldg(P.seg + static_cast<size_t>(b) * P.T + col) ==
                             seg_r[e >> 1];
            if (!ok) x = -INFINITY;
          }
          const float p = ex2(fmaf(x, sc2, -lse2[e >> 1]));
          ds[e] = p * (dp[j][e] - dl[e >> 1]);
        }
        dsf[j][0] = pack_bf16(ds[0], ds[1]);
        dsf[j][1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS K: dS's accumulator layout is the A operand's
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        const uint32_t a[4] = {dsf[2 * kk][0], dsf[2 * kk][1],
                               dsf[2 * kk + 1][0], dsf[2 * kk + 1][1]};
        mma_rows_tn<D>(acc, a, Kt + (c + kk * 16) * LD + bto);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= P.T) continue;
    __nv_bfloat16* out =
        dq + ((static_cast<size_t>(b) * P.T + row[rr]) * P.H + h) * D +
        quad_col;
#pragma unroll
    for (int j = 0; j < DB; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(
          acc[j][2 * rr] * P.scale, acc[j][2 * rr + 1] * P.scale);
  }
}

// dk / dv: one CTA of 4 warps per (batch * KV head, 64-row k tile) for the
// whole query-head group; each warp owns 16 keys.  The products are the
// transposed ones (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T come out
// in the A operand's layout for dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 2)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, Problem P) {
  constexpr int LD = D + 8;
  constexpr int DB = D / 8;            // 8-column blocks of dK / dV
  constexpr int NC = kDkvChunk / 8;    // 8-row blocks of a q chunk
  const int G = P.H / P.KV;
  // grid (batch * KV head, k tile): the low k tiles, which see the most q
  // tiles under a causal mask, launch first
  const int bkv = blockIdx.x, b = bkv / P.KV, kvh = bkv % P.KV;
  const int k0 = blockIdx.y * kMmaTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + kMmaTile * LD;
  __nv_bfloat16* Qs = Vs + kMmaTile * LD;      // [2][kMmaTile][LD]
  __nv_bfloat16* dOs = Qs + 2 * kMmaTile * LD;  // [2][kMmaTile][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kMmaTile * LD);  // [2][64]
  float* Ds = Ls + 2 * kMmaTile;                                  // [2][64]

  // q tiles that see this k tile; the CTA walks (g, q tile) in this order
  int lo = 0, hi = (P.T - 1) / kMmaTile;
  if (P.causal) {
    lo = k0 / kMmaTile;
    if (P.window > 0)
      hi = min(hi, (k0 + kMmaTile - 1 + P.window - 1) / kMmaTile);
  }
  const int n_q = hi - lo + 1, n_it = G * n_q;
  // the Q and dO tiles of iteration `it`, with its rows' lse and delta
  auto stage_it = [&](int it, int st) {
    const int h = kvh * G + it / n_q, q0 = (lo + it % n_q) * kMmaTile;
    stage_async<D>(Qs + st * kMmaTile * LD, q, b, h, P.H, P.T, q0);
    stage_async<D>(dOs + st * kMmaTile * LD, dout, b, h, P.H, P.T, q0);
    const int i = threadIdx.x & (kMmaTile - 1), t = q0 + i;
    const float* src = (threadIdx.x < kMmaTile ? lse : delta) +
                       (static_cast<size_t>(b) * P.H + h) * P.T;
    float* dst = (threadIdx.x < kMmaTile ? Ls : Ds) + st * kMmaTile + i;
    cp_async4(dst, src + (t < P.T ? t : 0), t < P.T ? 4 : 0);
  };
  stage_async<D>(Ks, k, b, kvh, P.KV, P.T, k0);
  stage_async<D>(Vs, v, b, kvh, P.KV, P.T, k0);
  stage_it(0, 0);  // n_it >= 1: lo <= hi
  cp_async_commit();

  // this lane's two keys (quad_row, quad_row + 8 of the warp's 16)
  int key[2], seg_k[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    key[rr] = k0 + warp * 16 + quad_row + rr * 8;
    seg_k[rr] = P.seg && key[rr] < P.T
                    ? P.seg[static_cast<size_t>(b) * P.T + key[rr]] : -1;
  }
  const float sc2 = P.scale * kLog2e;
  float dk_acc[DB][4], dv_acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const int ao = (warp * 16) * LD + a_off(lane, LD);
  const int bo = b_off(lane, LD), bto = bt_off(lane, LD);

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {  // the next Q / dO tile loads while this computes
      stage_it(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int h = kvh * G + it / n_q, q0 = (lo + it % n_q) * kMmaTile;
    const float sl2 = P.slopes ? __ldg(P.slopes + h) / P.scale : 0.f;
    const __nv_bfloat16* Qt = Qs + st * kMmaTile * LD;
    const __nv_bfloat16* dOt = dOs + st * kMmaTile * LD;
    const float* Lt = Ls + st * kMmaTile;
    const float* Dt = Ds + st * kMmaTile;
    const bool need_mask = tile_needs_mask(P, q0, k0);

#pragma unroll 1
    for (int c = 0; c < kMmaTile; c += kDkvChunk) {
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x this chunk's q rows
      float s[NC][4], dp[NC][4];
      mma_nt<D, NC>(s, Ks + ao, Qt + c * LD + bo, LD);
      mma_nt<D, NC>(dp, Vs + ao, dOt + c * LD + bo, LD);
      // P^T and dS^T; lse and delta belong to the columns (q rows)
      uint32_t pf[NC][2], dsf[NC][2];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int ql = c + j * 8 + quad_col;  // tile row of element e & 1 = 0
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + ql);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = q0 + ql + (e & 1), kc = key[e >> 1];
          float x = s[j][e];
          if (P.slopes) x += sl2 * static_cast<float>(kc - r);
          if (need_mask) {  // rows past T too: their lse = delta = 0
            bool ok = band_ok(P, r, kc);
            if (P.seg)
              ok = ok && __ldg(P.seg + static_cast<size_t>(b) * P.T + r) ==
                             seg_k[e >> 1];
            if (!ok) x = -INFINITY;
          }
          p[e] = ex2(fmaf(x, sc2, -(e & 1 ? l2.y : l2.x) * kLog2e));
          ds[e] = p[e] * (dp[j][e] - (e & 1 ? d2.y : d2.x));
        }
        pf[j][0] = pack_bf16(p[0], p[1]);  // p in dO's dtype
        pf[j][1] = pack_bf16(p[2], p[3]);
        dsf[j][0] = pack_bf16(ds[0], ds[1]);  // ds in q's dtype
        dsf[j][1] = pack_bf16(ds[2], ds[3]);
      }
      // dV += P^T dO and dK += dS^T Q over the chunk's q rows
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        const uint32_t ap[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
        const uint32_t ad[4] = {dsf[2 * kk][0], dsf[2 * kk][1],
                                dsf[2 * kk + 1][0], dsf[2 * kk + 1][1]};
        mma_rows_tn<D>(dv_acc, ap, dOt + (c + kk * 16) * LD + bto);
        mma_rows_tn<D>(dk_acc, ad, Qt + (c + kk * 16) * LD + bto);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  // the group's fp32 sums, rounded once
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (key[rr] >= P.T) continue;
    const size_t at =
        ((static_cast<size_t>(b) * P.T + key[rr]) * P.KV + kvh) * D +
        quad_col;
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + j * 8) = pack_bf16(
          dk_acc[j][2 * rr] * P.scale, dk_acc[j][2 * rr + 1] * P.scale);
      *reinterpret_cast<uint32_t*>(dv + at + j * 8) =
          pack_bf16(dv_acc[j][2 * rr], dv_acc[j][2 * rr + 1]);
    }
  }
}

template <typename K>
int set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

constexpr size_t smem_bytes(int D, int tiles) {
  return (static_cast<size_t>(tiles) * kTile * (D + kPad) +
          static_cast<size_t>(kTile) * kPLd) *
         sizeof(float);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int B, const Problem& P, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores
    auto kern = flash_fwd_mma_kernel<D>;
    const size_t smem = static_cast<size_t>(5) * kMmaTile * (D + 8) *
                        sizeof(__nv_bfloat16);  // Q, 2 x K, 2 x V
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(P.H / P.KV, B * P.KV, (P.T + kMmaTile - 1) / kMmaTile);
    kern<<<grid, kMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, P);
    return static_cast<int>(cudaGetLastError());
  } else {  // fp32: the scalar path (tensor cores would mean TF32)
    auto kern = flash_fwd_kernel<T, D>;
    const size_t smem = smem_bytes(D, 3);
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid((P.T + kTile - 1) / kTile, B * P.H);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, P);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B,
           const Problem& P, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores
    using bf = __nv_bfloat16;
    auto kern = flash_bwd_dq_mma_kernel<D>;
    const size_t smem = static_cast<size_t>(6) * kMmaTile * (D + 8) *
                        sizeof(bf);  // Q, dO, 2 x K, 2 x V
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(P.H / P.KV, B * P.KV, (P.T + kMmaTile - 1) / kMmaTile);
    kern<<<grid, kMmaThreads, smem, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
        static_cast<bf*>(dq), P);
    return static_cast<int>(cudaGetLastError());
  } else {  // fp32: the scalar path (tensor cores would mean TF32)
    auto kern = flash_bwd_dq_kernel<T, D>;
    const size_t smem = smem_bytes(D, 4);
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid((P.T + kTile - 1) / kTile, B * P.H);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), P);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, void* dk, void* dv, int B,
            const Problem& P, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores
    using bf = __nv_bfloat16;
    auto kern = flash_bwd_dkv_mma_kernel<D>;
    const size_t smem =  // K, V, 2 x Q, 2 x dO; 2 x lse and delta rows
        static_cast<size_t>(6) * kMmaTile * (D + 8) * sizeof(bf) +
        static_cast<size_t>(4) * kMmaTile * sizeof(float);
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid(B * P.KV, (P.T + kMmaTile - 1) / kMmaTile);
    kern<<<grid, kMmaThreads, smem, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
        static_cast<bf*>(dk), static_cast<bf*>(dv), P);
    return static_cast<int>(cudaGetLastError());
  } else {  // fp32: the scalar path
    auto kern = flash_bwd_dkv_kernel<T, D>;
    const size_t smem = smem_bytes(D, 4);
    if (int e = set_smem(kern, smem)) return e;
    dim3 grid((P.T + kTile - 1) / kTile, B * P.KV);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), P);
    return static_cast<int>(cudaGetLastError());
  }
}

bool bad_shape(int B, int T, int H, int KV, int D, int dtype) {
  return B < 1 || T < 1 || KV < 1 || H % KV != 0 || B * H > 65535 ||
         (D != 16 && D != 32 && D != 64 && D != 128) ||
         (dtype != 0 && dtype != 1);
}

Problem problem(int T, int H, int KV, int causal, int window, float scale,
                const void* seg, const void* slopes) {
  return Problem{T, H, KV, causal, window, scale,
                 static_cast<const int*>(seg),
                 static_cast<const float*>(slopes)};
}

}  // namespace

// Dispatch on dtype (0 = float32, 1 = bfloat16) and head dim.
#define BPS_FLASH_DISPATCH(CALL)                    \
  switch (D * 2 + dtype) {                          \
    case 32: return CALL(float, 16);                \
    case 64: return CALL(float, 32);                \
    case 128: return CALL(float, 64);               \
    case 256: return CALL(float, 128);              \
    case 33: return CALL(__nv_bfloat16, 16);        \
    case 65: return CALL(__nv_bfloat16, 32);        \
    case 129: return CALL(__nv_bfloat16, 64);       \
    default: return CALL(__nv_bfloat16, 128);       \
  }

// C interface (bound with ctypes).  Layouts: q / o / dq [B, T, H, D],
// k / v / dk / dv [B, T, KV, D], contiguous, 16-byte aligned; lse and
// delta [B, H, T] fp32; seg [B, T] int32 or null; slopes [H] fp32 or
// null; window <= 0 means none.  Each returns cudaGetLastError() after
// its launch (0 = launched), or cudaErrorInvalidValue for a shape the
// kernels do not take (the Python wrapper checks these first).
extern "C" int bps_flash_fwd(const void* q, const void* k, const void* v,
                             const void* seg, const void* slopes, void* o,
                             float* lse, int B, int T, int H, int KV, int D,
                             int causal, int window, int dtype, float scale,
                             void* stream) {
  if (bad_shape(B, T, H, KV, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem P = problem(T, H, KV, causal, window, scale, seg, slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_CALL(TYPE, DIM) fwd<TYPE, DIM>(q, k, v, o, lse, B, P, s)
  BPS_FLASH_DISPATCH(BPS_CALL)
#undef BPS_CALL
}

extern "C" int bps_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const void* seg,
                                const void* slopes, void* dq, int B, int T,
                                int H, int KV, int D, int causal, int window,
                                int dtype, float scale, void* stream) {
  if (bad_shape(B, T, H, KV, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem P = problem(T, H, KV, causal, window, scale, seg, slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_CALL(TYPE, DIM) \
  bwd_dq<TYPE, DIM>(q, k, v, dout, lse, delta, dq, B, P, s)
  BPS_FLASH_DISPATCH(BPS_CALL)
#undef BPS_CALL
}

extern "C" int bps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const void* seg,
                                 const void* slopes, void* dk, void* dv,
                                 int B, int T, int H, int KV, int D,
                                 int causal, int window, int dtype,
                                 float scale, void* stream) {
  if (bad_shape(B, T, H, KV, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem P = problem(T, H, KV, causal, window, scale, seg, slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BPS_CALL(TYPE, DIM) \
  bwd_dkv<TYPE, DIM>(q, k, v, dout, lse, delta, dk, dv, B, P, s)
  BPS_FLASH_DISPATCH(BPS_CALL)
#undef BPS_CALL
}
