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
// Design (right and simple first), the tile loop of fused_cross_entropy.cu:
//   * a 128 x 128 block tile with a K loop in 32-deep steps; both operand
//     tiles are staged through shared memory and the next step's tiles are
//     loaded into registers while the current one is multiplied;
//   * the int8 W tile is dequantized while it is staged: 16 int8 values (one
//     16-byte load) become 16 bf16 values (exact: |q| <= 127) in shared
//     memory, so global memory streams 1 byte per weight;
//   * bf16: 8 warps of 64 x 32 each run mma.sync m16n8k16 (bf16 operands,
//     fp32 accumulation); fp32: fp32 FMA only (never TF32), 8 x 8 outputs a
//     thread, the int8 values widened to fp32 as they are staged;
//   * split-K when the output tiles would not fill the card (decode: M = 8
//     makes one row of tiles): each split writes its fp32 partial sums, and
//     quant_dot_combine adds the splits in order and applies the epilogue.
//     No atomics, so reruns are bit-identical.
// Not yet: a 16-row tile for small M (at M = 8 the 128-row tile multiplies
// 120 zero rows), wgmma, TMA / cp.async pipelines.

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

template <typename T>
int run(const void* x, const int8_t* w, const float* scale, const void* bias,
        void* out, float* part, int M, int N, int K, int splits, int kper,
        int out_bf16, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BM - 1) / BM, splits);
  quant_dot_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), w, scale, bias, out, part, M, N, K, kper,
      out_bf16);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (splits > 1) {
    const long long MN = static_cast<long long>(M) * N;
    const int blocks =
        static_cast<int>(MN / 256 + 1 < 4096 ? MN / 256 + 1 : 4096);
    quant_dot_combine<T><<<blocks, 256, 0, s>>>(part, scale, bias, out, M, N,
                                                 splits, out_bf16);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// C interface (bound with ctypes).  dtype: the compute dtype of x, 0 =
// float32, 1 = bfloat16; out_bf16: 1 = out (and bias) bfloat16, 0 =
// float32 (float32 x needs out_bf16 = 0).  x [M, K] and w [N, K] contiguous;
// scale [N] fp32; bias [N] or null.  splits > 1 needs part [splits, M, N]
// fp32 scratch and kper (a multiple of 32) with (splits - 1) * kper < K.
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int bps_quant_dot(const void* x, const void* w, const float* scale,
                             const void* bias, void* out, float* part, int M,
                             int N, int K, int splits, int kper, int dtype,
                             int out_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && out_bf16) || splits < 1 || splits > 65535 ||
      kper < BK || kper % BK != 0 ||
      static_cast<long long>(splits - 1) * kper >= K ||
      static_cast<long long>(splits) * kper < K ||
      (splits > 1 && part == nullptr) || (N + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  return dtype ? run<__nv_bfloat16>(x, wq, scale, bias, out, part, M, N, K,
                                    splits, kper, out_bf16, s)
               : run<float>(x, wq, scale, bias, out, part, M, N, K, splits,
                            kper, 0, s);
}
