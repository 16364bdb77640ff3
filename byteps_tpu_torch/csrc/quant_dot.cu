// Int8 weight-only product for Hopper (sm_90a), hand-written CUDA C++:
// y = (x . W_int8^T) x scale (+ bias), the product of every projection of an
// int8-weight model.
//
// Replaces the TPU kernel scripts/dot_probe.py:27 `quant_dot_kernel`
// (pallas_call at :35), the probe of the product that `QuantDense`
// (byteps_tpu/models/transformer.py:218-252) computes on a quantized tree.
// Python binding, build and the plain PyTorch version live in
// byteps_tpu_torch/ops/quant_dot.py.
//
// What it computes.  x [M, K] fp32 or bf16 (the compute dtype), W [N, K]
// int8 (nn.Linear's [out, in] layout), scale [N] fp32, an optional bias [N]
// in the output dtype; out [M, N] in the output dtype (the compute dtype, or
// fp32 for a head that accumulates in fp32).  Rounding as `QuantDense`, not
// as the probe kernel: the product x . W is summed in fp32 and rounded to the
// compute dtype; the scale is rounded to the output dtype and multiplies it
// there (one rounding); the bias is added in the output dtype (another).
// The probe kernel instead scales the fp32 sum and rounds once; the two
// differ by at most one bf16 ulp of the output.
//
// What bounds it.  2 M N K FLOPs and N K bytes of int8 weights (+ the
// activations).  At decode (M = slots = 8) the weights dominate: 8 bytes of
// activations per weight byte at most, 16 FLOPs per weight byte, so the
// product is bound by HBM bytes (Llama-3.2-1B's 0.97 GB of int8 weights:
// 0.29 ms per decode step at 3.35 TB/s).  At prefill (M = 15360) it is a
// GEMM bound by the bf16 tensor-core rate.  Torch has no bf16 x int8
// product: without this kernel the weights would be widened to bf16 in
// device memory on every call, moving three times the bytes int8 saves.
//
// Three designs; one rule picks among them (`choose` here, `_design` in the
// Python wrapper, which is held to the launches this library reports):
//
// swap (bf16 x, M <= 64: decode rows).  out^T = W . x^T on mma.sync
// m16n8k16: the int8 rows of W are the A operand (16 output channels a
// fragment, so no zero rows at M = 8) and the rows of x the B operand (n8 a
// fragment: M = 8 is one, M <= 64 at most eight).
//   * A CTA of 4 warps owns 64 output channels (16 a warp) and one split of
//     K, walked in 128-deep steps through a ring of 4 shared-memory slots
//     (3 steps in flight) filled by cp.async: each lane copies 16-byte runs
//     16t and 64 + 16t of its two W rows (channels g and g + 8 of its
//     warp), so the warp's copies of a row take its 128 bytes together,
//     and the CTA copies x's rows over the step's 128 depths beside them.
//     One barrier a step; no staging phase before the first product.
//   * Each lane widens the bytes it copied to bf16 in registers, exactly
//     (`s8x2_bf16`: bit masks and one packed bf16 subtraction).  Inside a
//     16-deep product the order of K is free if the B fragment takes the
//     same order: the lane's bytes 4u .. 4u + 3 of a run are its A pairs
//     (k 2t, 2t + 1 and 2t + 8, 2t + 9) of sub-step u, and x's elements at
//     the same depths its B pairs.  Up to 4 accumulator chains a fragment
//     keep the products of a step from waiting on each other.
//   * The split plan (`_swap_plan` in the wrapper, from the shapes alone)
//     gives about one CTA an SM, at least 2 steps a split.  With one split
//     the CTA finishes its tile; otherwise each split writes its fp32
//     sums, takes a ticket, and the last CTA of the channel tile adds the
//     splits in split order, applies the epilogue and resets the ticket to
//     zero (decode_attention.cu's scheme).  One launch a call, and reruns
//     are bit-identical.
//
// tma (bf16 x, M > 64: prefill).  The mainloop of fused_cross_entropy.cu's
// kernels on TMA and wgmma, with W dequantized in registers:
//   * a persistent grid (one CTA an SM) walks 128-channel x 256-row output
//     tiles, channel tiles fastest (the CTAs resident together share x's
//     row tile; W, 16 MB at most, stays in L2); one producer warp issues the
//     TMA loads of a 4-stage ring of W [128][64] int8 (8 KB, 64-byte
//     swizzle) and x [256][64] bf16 (32 KB, 128-byte swizzle) tracked by
//     full and empty mbarriers; two consumer warpgroups own 64 channels
//     each;
//   * each consumer thread reads its two W rows of a stage (16 bytes a
//     16-deep step; the swizzle puts the 8 rows of a load in 8 bank
//     groups), picks its bytes 2t, 2t + 1, 2t + 8, 2t + 9 and widens them:
//     the register-sourced A operand of wgmma.m64n256k16; x's tile is the B
//     operand, read from shared memory through the K-major 128-byte-swizzle
//     descriptors of the fused CE.  No dequantized copy of W exists in
//     shared memory.  A warpgroup writes its A registers only while none of
//     its products runs (ptxas serializes the products otherwise): it
//     widens a stage while the other warpgroup's products run;
//   * the accumulator rows are output channels: the epilogue scales and
//     biases per row on bf16 pairs and transposes each 8 x 8 block with
//     movmatrix into the warpgroup's [256][64] output tile in shared memory
//     (128-byte swizzle), which one TMA store drains while the next tile's
//     products run (fp32 out: the threads store 8 bytes each);
//   * ragged edges are TMA's: zero fill on loads, clipped stores; no
//     split-K, no atomics.
//
// tile (the first design): fp32 x, and every shape the other two cannot
// describe (K not a multiple of 16, bases not 16-byte aligned, N not a
// multiple of 8 above 64 rows):
//   * a 128 x 128 block tile with a K loop in 32-deep steps; both operand
//     tiles are staged through shared memory and the next step's tiles are
//     loaded into registers while the current one is multiplied;
//   * the int8 W tile is dequantized while it is staged: 16 int8 values (one
//     16-byte load) become 16 bf16 values (exact: |q| <= 127) in shared
//     memory, so global memory streams 1 byte per weight;
//   * bf16: 8 warps of 64 x 32 each run mma.sync m16n8k16 (bf16 operands,
//     fp32 accumulation); fp32: fp32 FMA only (never TF32), 8 x 8 outputs a
//     thread, the int8 values widened to fp32 as they are staged;
//   * split-K when the output tiles would not fill the card: each split
//     writes its fp32 partial sums, and quant_dot_combine adds the splits in
//     order and applies the epilogue.  No atomics, so reruns are
//     bit-identical.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder
                   // is fetched with cudaGetDriverEntryPoint, so nothing
                   // links libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;        // rows of a block tile (and columns: BN)
constexpr int BK = 32;         // depth of one K step
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdH = BK + 8;   // bf16 K-contiguous tile row stride, halves
constexpr int kLdF = BM + 4;   // fp32 tile row stride (row-contiguous), floats

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));  // nearest even, as torch
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// elements of one 16-byte vector of x
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16-byte vectors of the x tile each thread carries
template <typename T>
constexpr int kNv = BM * BK / (kThreads * kVec<T>);

// shared memory of one operand tile, bytes
template <typename T>
constexpr int kTileBytes = kIsF32<T> ? BK * kLdF * 4 : BM * kLdH * 2;

// rows [m0, m0 + BM) x depth [k0, k0 + BK) of x [M, K] into registers;
// what lies outside [0, M) x [0, kend) is zero
template <typename T>
__device__ __forceinline__ void load_x(const T* x, int M, int K, int kend,
                                       bool vec, int m0, int k0,
                                       uint4 (&reg)[kNv<T>]) {
  constexpr int VEC = kVec<T>;
#pragma unroll
  for (int u = 0; u < kNv<T>; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / (BK / VEC), k = (idx % (BK / VEC)) * VEC;
    const int gr = m0 + r, gk = k0 + k;
    const long long at = static_cast<long long>(gr) * K + gk;
    if (vec && gr < M && gk + VEC <= kend) {
      reg[u] = *reinterpret_cast<const uint4*>(x + at);
    } else {
      T* e = reinterpret_cast<T*>(&reg[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        e[i] = (gr < M && gk + i < kend) ? x[at + i] : zero<T>();
    }
  }
}

// the x tile into shared memory: bf16 K-contiguous [BM][kLdH]; fp32
// row-contiguous [BK][kLdF] (transposed here)
template <typename T>
__device__ __forceinline__ void store_x(T* s, const uint4 (&reg)[kNv<T>]) {
  constexpr int VEC = kVec<T>;
#pragma unroll
  for (int u = 0; u < kNv<T>; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / (BK / VEC), k = (idx % (BK / VEC)) * VEC;
    if constexpr (kIsF32<T>) {
      const float* e = reinterpret_cast<const float*>(&reg[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[(k + i) * kLdF + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(s + r * kLdH + k) = reg[u];
    }
  }
}

// rows [n0, n0 + BM) x depth [k0, k0 + BK) of W [N, K] int8: one 16-byte
// vector a thread (128 x 32 bytes)
__device__ __forceinline__ uint4 load_w(const int8_t* w, int N, int K,
                                        int kend, bool vec, int n0, int k0) {
  const int r = threadIdx.x >> 1, k = (threadIdx.x & 1) * 16;
  const int gr = n0 + r, gk = k0 + k;
  const long long at = static_cast<long long>(gr) * K + gk;
  if (vec && gr < N && gk + 16 <= kend)
    return *reinterpret_cast<const uint4*>(w + at);
  uint4 reg;
  int8_t* e = reinterpret_cast<int8_t*>(&reg);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    e[i] = (gr < N && gk + i < kend) ? w[at + i] : static_cast<int8_t>(0);
  return reg;
}

// the W tile into shared memory, dequantized to the compute dtype (exact:
// |q| <= 127): bf16 K-contiguous [BM][kLdH] as two 16-byte stores; fp32
// row-contiguous [BK][kLdF]
template <typename T>
__device__ __forceinline__ void store_w(T* s, uint4 reg) {
  const int r = threadIdx.x >> 1, k = (threadIdx.x & 1) * 16;
  const int8_t* e = reinterpret_cast<const int8_t*>(&reg);
  if constexpr (kIsF32<T>) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s[(k + i) * kLdF + r] = static_cast<float>(e[i]);
  } else {
    uint32_t u[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // element 2i in the low half, as it lies in memory
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          static_cast<float>(e[2 * i]), static_cast<float>(e[2 * i + 1]));
      u[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    uint4* d = reinterpret_cast<uint4*>(s + r * kLdH + k);
    d[0] = make_uint4(u[0], u[1], u[2], u[3]);
    d[1] = make_uint4(u[4], u[5], u[6], u[7]);
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[rs][cs] is the output at (row_of(rs), col_of(cs)) of the block tile:
// 8 rows x 8 columns a thread in both dtypes.
//   bf16: warp (wm, wn) of 2 x 4 owns 64 x 32; slot rs = 2 mi + half holds
//         row wm*64 + mi*16 + g + 8*half, cs = 2 ni + e column
//         wn*32 + ni*8 + 2t + e (the mma.sync accumulator layout);
//   fp32: thread (ty, tx) of 16 x 16 owns rows ty*4.. and 64 + ty*4..,
//         columns tx*4.. and 64 + tx*4...
template <typename T>
__device__ __forceinline__ int row_of(int rs) {
  if constexpr (kIsF32<T>) {
    const int ty = threadIdx.x >> 4;
    return (rs < 4 ? 0 : 64) + ty * 4 + (rs & 3);
  } else {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    return (warp >> 2) * 64 + (rs >> 1) * 16 + g + (rs & 1) * 8;
  }
}

template <typename T>
__device__ __forceinline__ int col_of(int cs) {
  if constexpr (kIsF32<T>) {
    const int tx = threadIdx.x & 15;
    return (cs < 4 ? 0 : 64) + tx * 4 + (cs & 3);
  } else {
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 3;
    return (warp & 3) * 32 + (cs >> 1) * 8 + 2 * t + (cs & 1);
  }
}

// acc += the product of one staged K step (x tile rows . W tile rows)
template <typename T>
__device__ __forceinline__ void mma_step(const T* As, const T* Bs,
                                         float (&acc)[8][8]) {
  if constexpr (kIsF32<T>) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * kLdF + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * kLdF + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kLdF + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * kLdF + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const T* p = As + (wm * 64 + mi * 16 + g) * kLdH + kk + 2 * t;
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kLdH);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * kLdH + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const T* p = Bs + (wn * 32 + ni * 8 + g) * kLdH + kk + 2 * t;
        b[ni][0] = ld32(p);
        b[ni][1] = ld32(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[2 * mi][2 * ni], acc[2 * mi][2 * ni + 1],
                   acc[2 * mi + 1][2 * ni], acc[2 * mi + 1][2 * ni + 1],
                   a[mi], b[ni]);
    }
  }
}

// QuantDense's epilogue of one fp32 sum: rounded to the compute dtype T,
// times the scale in the output dtype, plus the bias in the output dtype.
// __fmul_rn / __fadd_rn keep nvcc from contracting the two into one FMA,
// which would round once where torch rounds twice.
template <typename T>
__device__ __forceinline__ float finish(float acc, int col,
                                        const float* __restrict__ scale,
                                        const void* __restrict__ bias,
                                        int out_bf16) {
  float y = kIsF32<T> ? acc : bf16_round(acc);
  if (out_bf16) {
    y = bf16_round(__fmul_rn(y, bf16_round(scale[col])));
    if (bias != nullptr)
      y = bf16_round(__fadd_rn(
          y, __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])));
  } else {
    y = __fmul_rn(y, scale[col]);
    if (bias != nullptr)
      y = __fadd_rn(y, static_cast<const float*>(bias)[col]);
  }
  return y;
}

__device__ __forceinline__ void store_out(void* out, long long at, float y,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16(y);
  else
    static_cast<float*>(out)[at] = y;
}

// Block (row tile, column tile, split) sums depth [split * kper, (split + 1)
// * kper) of its tile; with one split it applies the epilogue and writes
// out, otherwise it writes the fp32 sums to part [splits, M, N].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    quant_dot_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, void* __restrict__ out,
                     float* __restrict__ part, int M, int N, int K, int kper,
                     int out_bf16) {
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes<T>];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTileBytes<T>);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BM, split = blockIdx.z;
  const int kbeg = split * kper, kend = min(K, kbeg + kper);
  const bool xvec =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && K % kVec<T> == 0;
  const bool wvec = (reinterpret_cast<uintptr_t>(w) & 15) == 0 && K % 16 == 0;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint4 rx[kNv<T>];
  load_x<T>(x, M, K, kend, xvec, m0, kbeg, rx);
  uint4 rw = load_w(w, N, K, kend, wvec, n0, kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
    store_x<T>(As, rx);
    store_w<T>(Bs, rw);
    __syncthreads();
    if (k0 + BK < kend) {  // the next step's loads fly during the product
      load_x<T>(x, M, K, kend, xvec, m0, k0 + BK, rx);
      rw = load_w(w, N, K, kend, wvec, n0, k0 + BK);
    }
    mma_step<T>(As, Bs, acc);
  }
#pragma unroll
  for (int rs = 0; rs < 8; ++rs) {
    const int row = m0 + row_of<T>(rs);
    if (row >= M) continue;
#pragma unroll
    for (int cs = 0; cs < 8; ++cs) {
      const int col = n0 + col_of<T>(cs);
      if (col >= N) continue;
      const long long at = static_cast<long long>(row) * N + col;
      if (gridDim.z == 1)
        store_out(out, at, finish<T>(acc[rs][cs], col, scale, bias, out_bf16),
                  out_bf16);
      else
        part[static_cast<long long>(split) * M * N + at] = acc[rs][cs];
    }
  }
}

// out = the epilogue of the splits' sums, added in split order
template <typename T>
__global__ void quant_dot_combine(const float* __restrict__ part,
                                  const float* __restrict__ scale,
                                  const void* __restrict__ bias,
                                  void* __restrict__ out, int M, int N,
                                  int splits, int out_bf16) {
  const long long MN = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a += part[s * MN + i];
    store_out(out, i, finish<T>(a, static_cast<int>(i % N), scale, bias,
                                out_bf16),
              out_bf16);
  }
}

// --------------------------------------------- shared by swap and tma

// Two s8 of w as a bf16 pair, exactly: `sel` (a byte_perm selector) puts
// them at bits 0-7 and 16-23.  For a byte b of value q, 0x4300 | (b & 0x7F)
// is the bf16 of 128 + (b & 0x7F), and 0x4300 | (b & 0x80) that of 128 or,
// where the sign bit is set, 256: their difference is q, which a bf16
// holds, so the subtraction is exact.
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t w, uint32_t sel) {
  const uint32_t t = __byte_perm(w, 0, sel);
  const uint32_t a = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t b = (t & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the four s8 of w as two bf16 pairs (bytes 0, 1 -> lo; 2, 3 -> hi)
__device__ __forceinline__ void s8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  lo = s8x2_bf16(w, 0x4140);
  hi = s8x2_bf16(w, 0x4342);
}

// a row's scale in the output dtype's rounding, and its bias, as fp32
__device__ __forceinline__ float row_scale(const float* scale, int n,
                                           int out_bf16) {
  return out_bf16 ? bf16_round(scale[n]) : scale[n];
}

__device__ __forceinline__ float row_bias(const void* bias, int n,
                                          int out_bf16) {
  if (bias == nullptr) return 0.f;
  return out_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
             : static_cast<const float*>(bias)[n];
}

// ------------------------------------------------ swap: M <= 64 (decode)

constexpr int kSwapThreads = 128;   // 4 warps
constexpr int kSwapCh = 64;         // output channels of a CTA, 16 a warp
constexpr int kSwapStep = 128;      // depth of a step: 2 x 16 bytes a lane
constexpr int kSwapRing = 4;        // ring slots: 3 steps in flight
constexpr int kSwapWBytes = 2048;   // a warp's W of a step: 16 rows x 128
constexpr int kSwapXRow = (kSwapStep + 8) * 2;  // a staged x row, bytes
constexpr int kSwapMaxRows = 64;    // the largest M
constexpr int kSwapLdr = kSwapCh + 4;  // fp32 result tile row stride

// a ring slot: the 4 warps' W [warp][chunk][lane][16 bytes], then x's rows
// [8 mf][kSwapStep + 8] bf16 (16 bytes of padding a row keep the lanes'
// 16-byte reads conflict-free)
__host__ __device__ constexpr int swap_slot(int mf) {
  return 4 * kSwapWBytes + 8 * mf * kSwapXRow;
}
// the ring + the fp32 result tile [8 mf][kSwapLdr] + the merge flag
__host__ __device__ constexpr int swap_smem(int mf) {
  return kSwapRing * swap_slot(mf) + 8 * mf * kSwapLdr * 4 + 16;
}

// 16 bytes global -> shared; src_bytes = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (channel tile, split) sums depth [split * kper, (split + 1) * kper)
// of out^T's 64 channels x MF * 8 rows (rows >= M are zeros).  With one
// split it writes out; otherwise its fp32 sums go to part [splits, M, N],
// and the last block of the channel tile (by its ticket) adds the splits in
// split order and writes out.
template <int MF>
__global__ void __launch_bounds__(kSwapThreads)
    quant_swap_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale,
                      const void* __restrict__ bias, void* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ tickets,
                      int M, int N, int K, int kper, int out_bf16) {
  extern __shared__ __align__(16) unsigned char swap_raw[];
  constexpr int R = 8 * MF;
  constexpr int kSlot = swap_slot(MF);
  float* rt = reinterpret_cast<float*>(swap_raw + kSwapRing * kSlot);
  int* flag = reinterpret_cast<int*>(rt + R * kSwapLdr);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kSwapCh, split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_lo = split * kper, k_hi = min(K, k_lo + kper);
  const int steps = (k_hi - k_lo + kSwapStep - 1) / kSwapStep;

  // Step s lands in ring slot s % kSwapRing.  W: the lane's rows c0 = n0 +
  // 16 warp + g and c0 + 8, runs [16t, 16t + 16) and [64 + 16t, 80 + 16t)
  // of the step (the warp's copies of a row take its 128 bytes together;
  // K % 16 == 0, so a run is wholly inside [k_lo, k_hi) or wholly outside),
  // at [warp][chunk 2 r + h][lane] (row r of the two, run h): each lane
  // reads back what it copied.  x: rows [0, 8 MF) of the step's 128
  // depths, zeros past M and k_hi, copied by all the threads.
  const int c0 = n0 + 16 * warp + g;
  const int8_t* src[2] = {
      w + static_cast<long long>(c0 < N ? c0 : 0) * K + k_lo + 16 * t,
      w + static_cast<long long>(c0 + 8 < N ? c0 + 8 : 0) * K + k_lo + 16 * t};
  const bool live[2] = {c0 < N, c0 + 8 < N};
  auto issue = [&](int s) {
    unsigned char* slot = swap_raw + (s % kSwapRing) * kSlot;
    unsigned char* d = slot + warp * kSwapWBytes + lane * 16;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int at = s * kSwapStep + 64 * (c & 1);
      const bool in = live[c >> 1] && k_lo + at + 16 * t < k_hi;
      cp_async16(d + c * 512, in ? src[c >> 1] + at : w, in ? 16 : 0);
    }
    unsigned char* xd = slot + 4 * kSwapWBytes;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      const int v = threadIdx.x + i * kSwapThreads;  // 16 a row
      const int m = v >> 4, k = k_lo + s * kSwapStep + (v & 15) * 8;
      const bool in = m < M && k < k_hi;
      cp_async16(xd + m * kSwapXRow + (v & 15) * 16,
                 in ? x + static_cast<long long>(m) * K + k : x,
                 in ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kSwapRing - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // C chains of products a fragment, added in a fixed order at the end: a
  // step's 8 products into one accumulator would wait on each other
  constexpr int C = MF >= 4 ? 1 : 4 / MF;
  float acc[C][MF][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int f = 0; f < MF; ++f)
      acc[c][f][0] = acc[c][f][1] = acc[c][f][2] = acc[c][f][3] = 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kSwapRing - 2>();  // step s's copies of this thread
    __syncthreads();  // ... and of every thread; step s - 1 is read
    if (s + kSwapRing - 1 < steps) issue(s + kSwapRing - 1);
    cp_async_commit();
    const unsigned char* slot = swap_raw + (s % kSwapRing) * kSlot;
    const unsigned char* d = slot + warp * kSwapWBytes + lane * 16;
    // B column g of fragment f is x's row 8f + g; the lane's 16 depths of
    // run h lie at 64h + 16t
    const unsigned char* xl = slot + 4 * kSwapWBytes + g * kSwapXRow + 32 * t;
    uint4 ch[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      ch[c] = *reinterpret_cast<const uint4*>(d + c * 512);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t aw[4] = {ch[h].x, ch[h].y, ch[h].z, ch[h].w};
      const uint32_t bw[4] = {ch[2 + h].x, ch[2 + h].y, ch[2 + h].z,
                              ch[2 + h].w};
      // sub-step u: bytes 4u .. 4u + 3 of the lane's run are its A pairs
      // (rows g: a0, a2; g + 8: a1, a3)
      uint32_t af[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s8x4_bf16(aw[u], af[u][0], af[u][2]);
        s8x4_bf16(bw[u], af[u][1], af[u][3]);
      }
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        const uint4* xp = reinterpret_cast<const uint4*>(
            xl + f * 8 * kSwapXRow + 128 * h);
        const uint4 x0 = xp[0], x1 = xp[1];
        const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mma16816(acc[(4 * h + u) % C][f], af[u], xw[2 * u], xw[2 * u + 1]);
      }
    }
  }

  // the fragments into the result tile [row][channel]: acc[.][f][2h + e] is
  // (channel 16 warp + g + 8h, row 8f + 2t + e)
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[0][f][i];
#pragma unroll
      for (int c = 1; c < C; ++c) v += acc[c][f][i];
      rt[(8 * f + 2 * t + (i & 1)) * kSwapLdr + 16 * warp + g + 8 * (i >> 1)] =
          v;
    }
  __syncthreads();

  const int outs = M * kSwapCh;
  if (splits == 1) {
    for (int i = threadIdx.x; i < outs; i += kSwapThreads) {
      const int m = i / kSwapCh, c = i % kSwapCh, n = n0 + c;
      if (n < N)
        store_out(out, static_cast<long long>(m) * N + n,
                  finish<__nv_bfloat16>(rt[m * kSwapLdr + c], n, scale, bias,
                                        out_bf16),
                  out_bf16);
    }
    return;
  }
  const long long MN = static_cast<long long>(M) * N;
  for (int i = threadIdx.x; i < outs; i += kSwapThreads) {
    const int m = i / kSwapCh, c = i % kSwapCh, n = n0 + c;
    if (n < N)
      part[split * MN + static_cast<long long>(m) * N + n] =
          rt[m * kSwapLdr + c];
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0)
    *flag = atomicAdd(&tickets[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;  // every split took one
  // the last block adds the splits in split order: 4 outputs a thread at
  // a time, 8 splits' reads of them in flight together (L2 reads: other
  // SMs wrote them)
  for (int i0 = threadIdx.x; i0 < outs; i0 += 4 * kSwapThreads) {
    long long at[4];
    bool ok[4];
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kSwapThreads, n = n0 + i % kSwapCh;
      ok[j] = i < outs && n < N;
      at[j] = static_cast<long long>(i / kSwapCh) * N + n;
      a[j] = 0.f;
    }
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float v[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[q][j] = sp0 + q < splits && ok[j]
                        ? __ldcg(part + (sp0 + q) * MN + at[j])
                        : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (sp0 + q < splits) a[j] += v[q][j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[j])
        store_out(out, at[j],
                  finish<__nv_bfloat16>(a[j], static_cast<int>(at[j] % N),
                                        scale, bias, out_bf16),
                  out_bf16);
  }
}

// ---------------------------------------- tma: M > 64 (prefill), wgmma

// Shared memory of a CTA: 4 stages of an x tile [256][64] bf16 (K-major,
// 128-byte rows in TMA's 128-byte swizzle) and a W tile [128][64] int8
// (64-byte rows in TMA's 64-byte swizzle); each consumer warpgroup's bf16
// output tile [256][64] (128-byte swizzle), which a TMA store drains;
// then the stages' full and empty mbarriers.
constexpr int QM = 128;            // output channels of a tile (2 x 64)
constexpr int QN = 256;            // rows of x of a tile
constexpr int QK = 64;             // depth of a stage
constexpr int kQStages = 4;
constexpr int kQThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kQXBytes = QN * QK * 2;
constexpr int kQWBytes = QM * QK;
constexpr int kQOBytes = QN * 64 * 2;  // a warpgroup's output tile
constexpr int kQSmem = kQStages * (kQXBytes + kQWBytes) + 2 * kQOBytes +
                       2 * kQStages * 8 +
                       1024;       // + the slack to align the ring to 1024
static_assert(kQSmem <= 232448, "the ring fits a Hopper block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait past ~20 s of clock traps, so a pipeline fault ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 35)) {
      __trap();
    }
  }
}

// a shared-memory tile into the 2-D box of `map` at (inner c0, outer c1);
// what lies outside the tensor is not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until the earlier TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// one 2-D box of `map` at element coordinates (inner c0, outer c1) into
// shared memory; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory descriptor of a K-major 128-byte-swizzled tile (rows
// of 64 depth values): SBO 1024 = the next 8 rows, LBO unused (1); the k16
// step advances the start by 32 bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across the
// asynchronous products' wait
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the A registers holding their values until this point: the
// products that read them run on after the instruction that issued them
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[u][i])::"memory");
}

// d (+)= A[64 x 16] B[16 x 256] of the warpgroup: A from registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B K-major in shared
// memory; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The ring: 4 stages of x and W tiles, aligned to 1024 bytes (the period
// of the 128-byte swizzle), and their barriers: full[s] completes when the
// stage's bytes have landed (one arrival: the producer's expect_tx),
// empty[s] when both consumer warpgroups have released it.
struct QRing {
  unsigned char* x;
  unsigned char* w;
  unsigned char* o;  // the two output tiles
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ QRing qring_init(unsigned char* raw) {
  unsigned char* p = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  QRing r;
  r.x = p;
  r.w = p + kQStages * kQXBytes;
  r.o = r.w + kQStages * kQWBytes;
  r.full = reinterpret_cast<uint64_t*>(r.o + 2 * kQOBytes);
  r.empty = r.full + kQStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The position of a pipeline: stage and the parity of its round.
struct QPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kQStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Consumer warpgroup wg (0 or 1): acc = its 64 channels x 256 rows of the
// tile over nk stages.  A stage: the warpgroup's 64 W rows widened into
// the A registers (the thread's rows g and g + 8 of its warp's 16), then 4
// products of 16 depths on x's tile; the stage is released once they are
// done.  The A registers are written only while no product of this
// warpgroup runs (ptxas serializes the products otherwise): the other
// warpgroup's products keep the tensor cores busy meanwhile.
__device__ __forceinline__ void qconsume(float (&acc)[128], const QRing& r,
                                         int nk, int wg, QPos& ps) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int roff = (64 * wg + 16 * w4 + g) * QK;  // row g in a W stage
  // TMA's 64-byte swizzle: 16-byte chunk c of row r lies at c ^ (r / 2 %
  // 4), so the 8 rows a load reads take 8 different bank groups (rows g
  // and g + 8 have the same r / 2 % 4)
  const int sw = (g >> 1) & 3;
  // the thread's pairs of a 16-deep run are bytes 2t, 2t + 1 (word t / 2)
  // and 2t + 8, 2t + 9 (word 2 + t / 2), half t % 2 of each
  const bool odd = (t & 2) != 0;
  const uint32_t sel = (t & 1) ? 0x4342u : 0x4140u;
  uint32_t a[4][4];
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&r.full[ps.stage], ps.phase);
    const unsigned char* ws = r.w + ps.stage * kQWBytes + roff;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * (u ^ sw);
      const uint4 v0 = *reinterpret_cast<const uint4*>(ws + c);
      const uint4 v1 = *reinterpret_cast<const uint4*>(ws + 8 * QK + c);
      a[u][0] = s8x2_bf16(odd ? v0.y : v0.x, sel);
      a[u][2] = s8x2_bf16(odd ? v0.w : v0.z, sel);
      a[u][1] = s8x2_bf16(odd ? v1.y : v1.x, sel);
      a[u][3] = s8x2_bf16(odd ? v1.w : v1.z, sel);
    }
    const uint32_t xb = smem_u32(r.x + ps.stage * kQXBytes);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wgmma_rs(acc, a[u], sw128_desc(xb + 32 * u), (kb | u) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_a(a);
    if ((threadIdx.x & 127) == 0) mbar_arrive(&r.empty[ps.stage]);
    ps.next();
  }
  fence_acc(acc);
}

// an 8 x 8 matrix of b16 pairs transposed across the warp (lane l holds
// row l / 4, columns 2 (l % 4) and + 1, before and after)
__device__ __forceinline__ uint32_t movtrans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Tile (row tile tm, channel tile tn): out [M, N] rows tm*256.., channels
// tn*128..; acc[4j + 2h + e] of a consumer thread (warp w4 of warpgroup wg,
// lane g, t) is (channel 64 wg + 16 w4 + g + 8h, row 8j + 2t + e).
__global__ void __launch_bounds__(kQThreads, 1)
    quant_tma_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap mo,
                     const float* __restrict__ scale,
                     const void* __restrict__ bias, void* __restrict__ out,
                     int M, int N, int K, int out_bf16) {
  extern __shared__ unsigned char qsmem_raw[];
  const QRing r = qring_init(qsmem_raw);
  const int ntn = (N + QM - 1) / QM, ntm = (M + QN - 1) / QN;
  const int nk = (K + QK - 1) / QK, tiles = ntm * ntn;
  QPos ps;
  if (threadIdx.x < 128) {
    regs_dec<40>();
    if (threadIdx.x != 0) return;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tn = tile % ntn, tm = tile / ntn;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&r.empty[ps.stage], ps.phase ^ 1);
        uint64_t* full = &r.full[ps.stage];
        mbar_expect_tx(full, kQXBytes + kQWBytes);
        tma_load(r.x + ps.stage * kQXBytes, &mx, full, kb * QK, tm * QN);
        tma_load(r.w + ps.stage * kQWBytes, &mw, full, kb * QK, tn * QM);
        ps.next();
      }
    }
    return;
  }
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool has_bias = bias != nullptr;
  float acc[128];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tn = tile % ntn, tm = tile / ntn;  // channels fastest
    qconsume(acc, r, nk, wg, ps);
    const int m0 = tm * QN;
    const int cb = tn * QM + 64 * wg + 16 * w4;  // the warp's first channel
    // `finish` on pairs: the sums rounded to bf16 two at a time, the
    // bf16 product with the rounded scale rounded once (== fp32 product
    // of two bf16 values, rounded), the bias added in fp32 and rounded
    float sc[2], bi[2];
    __nv_bfloat162 sc2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cb + g + 8 * h;
      sc[h] = c < N ? row_scale(scale, c, out_bf16) : 0.f;
      bi[h] = c < N ? row_bias(bias, c, out_bf16) : 0.f;
      sc2[h] = __floats2bfloat162_rn(sc[h], sc[h]);
    }
    if (out_bf16) {
      // block j, half h: movmatrix gives lane (g, t) row 8j + g, channels
      // 8h + 2t, + 1 of the warp's 16, written into the warpgroup's
      // output tile [256][64] in TMA's 128-byte swizzle (16-byte chunk c
      // of row r at c ^ (r % 8): the 8 rows of a store take 8 chunks, so
      // the warp's 32 stores hit 32 banks); one TMA store drains the tile
      // while the next tile's products run
      unsigned char* ot = r.o + wg * kQOBytes;
      const bool lead = (threadIdx.x & 127) == 0;
      if (lead) tma_store_read_wait();  // the last tile's store has read it
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 y = __hmul2(
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]),
              sc2[h]);
          if (has_bias) {
            const float2 f = __bfloat1622float2(y);
            y = __floats2bfloat162_rn(__fadd_rn(f.x, bi[h]),
                                      __fadd_rn(f.y, bi[h]));
          }
          const int row = 8 * j + g, chunk = (2 * w4 + h) ^ g;
          *reinterpret_cast<uint32_t*>(ot + row * 128 + chunk * 16 + 4 * t) =
              movtrans(*reinterpret_cast<const uint32_t*>(&y));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if (lead) tma_store(&mo, ot, tn * QM + 64 * wg, m0);
    } else {
      // fp32: the high and the low halves transposed apart, joined again:
      // lane (g, t) holds row 8j + g, channels 8h + 2t, + 1 (8 bytes)
      float* o = static_cast<float*>(out);
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 f = __bfloat1622float2(__floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
          float y0 = __fmul_rn(f.x, sc[h]), y1 = __fmul_rn(f.y, sc[h]);
          if (has_bias) {
            y0 = __fadd_rn(y0, bi[h]);
            y1 = __fadd_rn(y1, bi[h]);
          }
          const uint32_t b0 = __float_as_uint(y0), b1 = __float_as_uint(y1);
          const uint32_t hi = movtrans(__byte_perm(b0, b1, 0x7632));
          const uint32_t lo = movtrans(__byte_perm(b0, b1, 0x5410));
          const int row = m0 + 8 * j + g, c = cb + 8 * h + 2 * t;
          if (row < M && c < N)
            *reinterpret_cast<float2*>(o + static_cast<long long>(row) * N +
                                       c) =
                make_float2(__uint_as_float(__byte_perm(lo, hi, 0x5410)),
                            __uint_as_float(__byte_perm(lo, hi, 0x7632)));
        }
    }
  }
  if (out_bf16 && (threadIdx.x & 127) == 0) tma_store_wait();
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A matrix of `outer` rows of `inner` elements, rows `ld_bytes` apart, read
// in boxes of box_outer rows of box_inner elements; what lies outside reads
// as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                long long inner, long long outer, long long ld_bytes,
                int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// SMs of the current device: the persistent grid's size
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return max(n, 1);
}

constexpr int kTile = 0, kSwap = 1, kTma = 2;
constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

// The rule among the three designs (`_design` in the Python wrapper states
// it too and is held to the launches counted here): fp32 x, K not a
// multiple of 16 or an x or W base not 16-byte aligned take the tile; else
// M <= 64 rows take swap; else N a multiple of 8 with a 16-byte-aligned
// out takes tma; else the tile.
int choose(int dtype, int M, int N, int K, const void* x, const void* w,
           const void* out) {
  if (dtype != 1 || K % 16 != 0 || !aligned16(x) || !aligned16(w))
    return kTile;
  if (M <= kSwapMaxRows) return kSwap;
  return N % 8 == 0 && aligned16(out) ? kTma : kTile;
}

// the launch just made: counted by design in the call's counts when it
// was taken
int done(int design, int* counts) {
  const cudaError_t e = cudaGetLastError();
  counts[design] += e == cudaSuccess;
  return static_cast<int>(e);
}

template <int MF>
int swap_launch(const void* x, const int8_t* w, const float* scale,
                const void* bias, void* out, float* part, int* tickets, int M,
                int N, int K, int splits, int kper, int out_bf16,
                cudaStream_t s, int* counts) {
  auto kern = quant_swap_kernel<MF>;
  static bool allowed = false;  // the dynamic shared memory, once a kernel
  if (!allowed) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            swap_smem(MF)))
      return static_cast<int>(e);
    allowed = true;
  }
  const dim3 grid((N + kSwapCh - 1) / kSwapCh, splits);
  kern<<<grid, kSwapThreads, swap_smem(MF), s>>>(
      static_cast<const __nv_bfloat16*>(x), w, scale, bias, out, part,
      tickets, M, N, K, kper, out_bf16);
  return done(kSwap, counts);
}

int swap_run(const void* x, const int8_t* w, const float* scale,
             const void* bias, void* out, float* part, int* tickets, int M,
             int N, int K, int splits, int kper, int out_bf16, cudaStream_t s,
             int* counts) {
  const int mf = (M + 7) / 8;
  if (M > kSwapMaxRows || K % 16 != 0 || !aligned16(x) || !aligned16(w) ||
      kper < kSwapStep || kper % kSwapStep != 0 ||
      static_cast<long long>(splits - 1) * kper >= K ||
      static_cast<long long>(splits) * kper < K ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return kBad;
#define BPS_SWAP(F)                                                          \
  case F:                                                                    \
    return swap_launch<F>(x, w, scale, bias, out, part, tickets, M, N, K,    \
                          splits, kper, out_bf16, s, counts)
  switch (mf) {
    BPS_SWAP(1); BPS_SWAP(2); BPS_SWAP(3); BPS_SWAP(4);
    BPS_SWAP(5); BPS_SWAP(6); BPS_SWAP(7); BPS_SWAP(8);
    default: return kBad;
  }
#undef BPS_SWAP
}

int tma_run(const void* x, const int8_t* w, const float* scale,
            const void* bias, void* out, int M, int N, int K, int out_bf16,
            cudaStream_t s, int* counts) {
  if (K % 16 != 0 || N % 8 != 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(out))
    return kBad;
  CUtensorMap mx, mw, mo = {};
  if (!tensor_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K,
                  QK, QN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K, QK, QM,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      // bf16 out leaves by TMA stores of [256][64] boxes (fp32 out by the
      // threads' own stores)
      (out_bf16 && !tensor_map(&mo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N,
                               M, 2LL * N, 64, QN,
                               CU_TENSOR_MAP_SWIZZLE_128B)))
    return kBad;
  static bool allowed = false;
  if (!allowed) {
    if (cudaError_t e = cudaFuncSetAttribute(
            quant_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kQSmem))
      return static_cast<int>(e);
    allowed = true;
  }
  const long long tiles = static_cast<long long>((M + QN - 1) / QN) *
                          ((N + QM - 1) / QM);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  quant_tma_kernel<<<grid, kQThreads, kQSmem, s>>>(mx, mw, mo, scale, bias,
                                                   out, M, N, K, out_bf16);
  return done(kTma, counts);
}

template <typename T>
int tile_run(const void* x, const int8_t* w, const float* scale,
             const void* bias, void* out, float* part, int M, int N, int K,
             int splits, int kper, int out_bf16, cudaStream_t s,
             int* counts) {
  if (kper < BK || kper % BK != 0 ||
      static_cast<long long>(splits - 1) * kper >= K ||
      static_cast<long long>(splits) * kper < K ||
      (splits > 1 && part == nullptr) || (N + BM - 1) / BM > 65535)
    return kBad;
  const dim3 grid((M + BM - 1) / BM, (N + BM - 1) / BM, splits);
  quant_dot_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), w, scale, bias, out, part, M, N, K, kper,
      out_bf16);
  if (int e = done(kTile, counts)) return e;
  if (splits > 1) {
    const long long MN = static_cast<long long>(M) * N;
    const int blocks =
        static_cast<int>(MN / 256 + 1 < 4096 ? MN / 256 + 1 : 4096);
    quant_dot_combine<T><<<blocks, 256, 0, s>>>(part, scale, bias, out, M, N,
                                                 splits, out_bf16);
    return done(kTile, counts);
  }
  return 0;
}

}  // namespace

// C interface (bound with ctypes).  dtype: the compute dtype of x, 0 =
// float32, 1 = bfloat16; out_bf16: 1 = out (and bias) bfloat16, 0 = float32
// (float32 x needs out_bf16 = 0).  x [M, K] and w [N, K] contiguous; scale
// [N] fp32; bias [N] or null.  design: -1 = the rule's choice (`choose`), 0 =
// tile, 1 = swap, 2 = tma (refused where the shape does not admit it: swap
// and tma take bf16 x only).  splits and kper are the split plan of the tile
// (kper a multiple of 32) and of swap (kper a multiple of 128), with
// (splits - 1) * kper < K <= splits * kper; tma ignores them.  splits > 1
// needs part [splits, M, N] fp32 scratch, and swap also tickets:
// ceil(N / 64) int32 zeros that every launch leaves zero (one stream at a
// time).  counts[3] receives the kernels this call launched by design.
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape or design the kernels do not take (or
// a tensor map the CUDA driver refuses).
extern "C" int bps_quant_dot(const void* x, const void* w, const float* scale,
                             const void* bias, void* out, float* part,
                             int* tickets, int M, int N, int K, int splits,
                             int kper, int dtype, int out_bf16, int design,
                             int* counts, void* stream) {
  if (counts == nullptr) return kBad;
  counts[0] = counts[1] = counts[2] = 0;
  if (M < 1 || N < 1 || K < 1 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && out_bf16) || splits < 1 || splits > 65535)
    return kBad;
  if (design < 0) design = choose(dtype, M, N, K, x, w, out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  switch (design) {
    case kTile:
      return dtype ? tile_run<__nv_bfloat16>(x, wq, scale, bias, out, part, M,
                                             N, K, splits, kper, out_bf16, s,
                                             counts)
                   : tile_run<float>(x, wq, scale, bias, out, part, M, N, K,
                                     splits, kper, 0, s, counts);
    case kSwap:
      return dtype ? swap_run(x, wq, scale, bias, out, part, tickets, M, N, K,
                              splits, kper, out_bf16, s, counts)
                   : kBad;
    case kTma:
      return dtype ? tma_run(x, wq, scale, bias, out, M, N, K, out_bf16, s,
                             counts)
                   : kBad;
    default:
      return kBad;
  }
}

// the design `choose` gives these operands (dtype as for bps_quant_dot)
extern "C" int bps_quant_dot_choose(int dtype, int M, int N, int K,
                                    const void* x, const void* w,
                                    const void* out) {
  return choose(dtype, M, N, K, x, w, out);
}
