// Fused LM-head cross-entropy for Hopper (sm_90a), hand-written CUDA C++:
// the forward, the dlogits + dx backward and the dW backward.
//
// Replaces the TPU kernels of byteps_tpu/ops/fused_cross_entropy.py:
//   * fce_fwd_kernel (+ fce_fwd_combine)   <- `_fwd_kernel` (:77, pallas_call
//                                             at :184)
//   * fce_dlogits_kernel + fce_dx_kernel   <- `_dx_kernel` (:115, :265)
//   * fce_dw_kernel                        <- `_dw_kernel` (:144, :282)
// Python binding, build and the plain PyTorch versions live in
// byteps_tpu_torch/ops/fused_cross_entropy.py.
//
// What they compute.  x [N, H], the head W as [V, H] rows (row stride ldw,
// the layout of an embedding table or an nn.Linear weight), targets [N]
// (int32 or int64; a target outside [0, V) matches no column), in float32
// or bfloat16, any N, H and V.  logits = x W^T, never stored whole:
//   forward: lse = logsumexp_v logits [N] fp32, tl = logits[n, target] [N]
//            fp32 (the wrapper forms loss = where(valid, lse - tl, 0));
//   backward, for each vocabulary chunk c of Vc columns, in order:
//     dlogits_c = (exp(logits_c - lse) - onehot_c) * dl, rounded to the
//                 operand dtype, into a scratch [N, Vc];
//     dx       += dlogits_c W_c      (fp32 accumulator [N, H], read and
//                                     added in place; the last chunk writes
//                                     dx in x's dtype);
//     dW_c      = dlogits_c^T x      (complete: the contraction runs over
//                                     all N rows; written once, W's dtype).
// dl is the loss cotangent, zero on ignored rows (set by the wrapper).
//
// Why this decomposition.  The TPU dx kernel carries a [BN, H] fp32
// accumulator across the vocabulary grid and the dW kernel an [H, BV] one
// across the row grid, 2 MB each at H = 2048: VMEM holds them, a Hopper
// block (227 KB of shared memory) does not, and blocks run in no order.
// Chunking the vocabulary keeps the TPU contract (no [N, V] buffer,
// gradients from dlogits recomputed from the saved lse) with one scratch
// of N * Vc elements (134 MB in bf16 at N = 8192, Vc = 8192); dlogits is
// computed once per chunk and feeds both products, so the backward does
// 6 N V H FLOPs (the TPU's two kernels recompute the logits each: 8 N V H),
// with no atomics: every output element is owned by one block, and the
// chunks run in stream order, so reruns are bit-identical.
//
// Rounding points kept from the TPU kernels: products of input-dtype
// values summed in fp32; fp32 softmax statistics; dlogits rounded to the
// operand dtype before each product; outputs rounded once.
//
// What bounds them.  Each is a GEMM of 2 N V H FLOPs (dlogits + dx twice
// that): 4.30 TFLOP at N = 8192, H = 2048, V = 128256, ~2000 FLOPs per
// byte of x and W.  The bound is the FLOPs over the card's peak for the
// dtype: 989 TFLOP/s on bf16 tensor cores (4.35 ms; 8.7 ms for dlogits +
// dx), 67 TFLOP/s fp32 FMA.  Bytes over 3.35 TB/s (x, W, the dlogits
// scratch) are far smaller.
//
// Design (right and simple first):
//   * every product is a 128 x 128 block tile with a K loop in 32-deep
//     steps: both operand tiles are staged through shared memory, the next
//     step's tiles are loaded into registers while the current one is
//     multiplied (16-byte loads where the layout allows);
//   * bf16: 8 warps of 64 x 32 each run mma.sync m16n8k16 (bf16 operands,
//     fp32 accumulation); tiles keep their source layout in shared memory,
//     and the operands whose depth is not contiguous (W in dx, dlogits and
//     x in dW) reach the fragments through ldmatrix.trans;
//   * fp32: fp32 FMA only (never TF32), 8 x 8 outputs a thread from tiles
//     kept row-contiguous (a K-contiguous source is transposed as it is
//     staged);
//   * the forward block owns 128 rows and walks a share of the vocabulary
//     tiles (split so the grid fills the card); each thread keeps the
//     online max / sum / target logit of the rows it holds over the columns
//     it holds, combined across threads once at the end and across splits
//     by fce_fwd_combine;
//   * the ragged edges (rows >= N, columns >= V, depth >= H) are staged as
//     zeros and masked; static shared memory stays below 48 KB, so no
//     dynamic shared-memory attribute is needed.
// Not yet: wgmma, TMA / cp.async pipelines, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;        // rows of a block tile (and columns: BN)
constexpr int BK = 32;         // depth of one K step
constexpr int kThreads = 256;  // 8 warps
constexpr int kLdH = BK + 8;   // bf16 K-contiguous tile row stride, halves
constexpr int kLdM = BM + 8;   // bf16 row-contiguous tile row stride, halves
constexpr int kLdF = BM + 4;   // fp32 tile row stride (row-contiguous), floats
constexpr float kNegInf = -1e30f;

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
constexpr bool kIsF32 = std::is_same<T, float>::value;

// elements of one 16-byte vector
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// 16-byte vectors of one operand tile each thread carries
template <typename T>
constexpr int kNv = BM * BK / (kThreads * kVec<T>);

// shared memory of one operand tile, bytes (the larger bf16 layout)
template <typename T>
constexpr int kTileBytes = kIsF32<T> ? BK * kLdF * 4 : BM * kLdH * 2;
static_assert(BK * kLdM <= BM * kLdH, "bf16 tile layouts share one size");

// An operand of a product, as the block sees it: `rows` rows (M or N of the
// product) by `kdim` depth.  Element (r, k) lies at p[r * ld + k] when KC
// (the depth is contiguous) and at p[k * ld + r] otherwise.
template <typename T>
struct Operand {
  const T* p;
  long long ld;
  int rows, kdim;
  int vec;  // 16-byte loads allowed: p 16-byte aligned and ld % kVec == 0
};

template <typename T>
__device__ __forceinline__ Operand<T> operand(const T* p, long long ld,
                                              int rows, int kdim) {
  const bool v = (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                 ld % kVec<T> == 0;
  return Operand<T>{p, ld, rows, kdim, v ? 1 : 0};
}

// The vector of thread-slot u: its first element's tile coordinates.
template <typename T, bool KC>
__device__ __forceinline__ void slot(int u, int& r, int& k) {
  constexpr int VEC = kVec<T>;
  const int idx = threadIdx.x + u * kThreads;
  if (KC) {
    r = idx / (BK / VEC);
    k = (idx % (BK / VEC)) * VEC;
  } else {
    k = idx / (BM / VEC);
    r = (idx % (BM / VEC)) * VEC;
  }
}

// rows [r0, r0 + BM) x depth [k0, k0 + BK) of `op` into registers; what
// lies outside the operand is zero
template <typename T, bool KC>
__device__ __forceinline__ void load_tile(const Operand<T>& op, int r0, int k0,
                                          uint4 (&reg)[kNv<T>]) {
  constexpr int VEC = kVec<T>;
#pragma unroll
  for (int u = 0; u < kNv<T>; ++u) {
    int r, k;
    slot<T, KC>(u, r, k);
    const int gr = r0 + r, gk = k0 + k;
    const bool full = KC ? (gr < op.rows && gk + VEC <= op.kdim)
                         : (gk < op.kdim && gr + VEC <= op.rows);
    const long long at = KC ? gr * op.ld + gk : gk * op.ld + gr;
    if (full && op.vec) {
      reg[u] = *reinterpret_cast<const uint4*>(op.p + at);
    } else {
      T* e = reinterpret_cast<T*>(&reg[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const bool in = KC ? (gr < op.rows && gk + i < op.kdim)
                           : (gk < op.kdim && gr + i < op.rows);
        e[i] = in ? op.p[at + i] : from_f<T>(0.f);
      }
    }
  }
}

// registers of load_tile into the shared tile.  bf16 tiles keep the
// source layout: K-contiguous [BM][kLdH] (fragments read K pairs with
// 32-bit loads) or row-contiguous [BK][kLdM] (fragments come transposed
// through ldmatrix.trans); both are straight 16-byte copies.  fp32 tiles
// are row-contiguous [BK][kLdF] (FMA reads runs of rows); a K-contiguous
// source is transposed here.
template <typename T, bool KC>
__device__ __forceinline__ void store_tile(T* s, const uint4 (&reg)[kNv<T>]) {
#pragma unroll
  for (int u = 0; u < kNv<T>; ++u) {
    int r, k;
    slot<T, KC>(u, r, k);
    if constexpr (kIsF32<T>) {
      if (KC) {
        const float* e = reinterpret_cast<const float*>(&reg[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[(k + i) * kLdF + r] = e[i];
      } else {
        *reinterpret_cast<uint4*>(s + k * kLdF + r) = reg[u];
      }
    } else {
      *reinterpret_cast<uint4*>(s + (KC ? r * kLdH + k : k * kLdM + r)) =
          reg[u];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, transposed: lane l names row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// acc += the product of one staged K step (A tile rows x B tile rows)
template <typename T, bool AKC, bool BKC>
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
    const int g = lane >> 2, t = lane & 3, q = lane >> 3, j = lane & 7;
    const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16;
        if (AKC) {
          const T* p = As + (m + g) * kLdH + kk + 2 * t;
          a[mi][0] = ld32(p);
          a[mi][1] = ld32(p + 8 * kLdH);
          a[mi][2] = ld32(p + 8);
          a[mi][3] = ld32(p + 8 * kLdH + 8);
        } else {  // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), stored [k][m]
          ldsm_x4_trans(a[mi],
                        As + (kk + (q >> 1) * 8 + j) * kLdM + m + (q & 1) * 8);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n = wn * 32 + np * 16;
        if (BKC) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const T* p = Bs + (n + h * 8 + g) * kLdH + kk + 2 * t;
            b[2 * np + h][0] = ld32(p);
            b[2 * np + h][1] = ld32(p + 8);
          }
        } else {  // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), stored [k][n]
          uint32_t r[4];
          ldsm_x4_trans(r,
                        Bs + (kk + (q & 1) * 8 + j) * kLdM + n + (q >> 1) * 8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
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

// acc = A[m0 : m0 + BM] . B[n0 : n0 + BM]^T over the whole depth (A.kdim ==
// B.kdim); smem holds two tiles.  Ends with every thread past its last
// read of smem only after the caller's next __syncthreads().
template <typename T, bool AKC, bool BKC>
__device__ __forceinline__ void gemm_tile(const Operand<T>& A,
                                          const Operand<T>& B, int m0, int n0,
                                          float (&acc)[8][8],
                                          unsigned char* smem) {
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTileBytes<T>);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint4 ra[kNv<T>], rb[kNv<T>];
  load_tile<T, AKC>(A, m0, 0, ra);
  load_tile<T, BKC>(B, n0, 0, rb);
  for (int k0 = 0; k0 < A.kdim; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed
    store_tile<T, AKC>(As, ra);
    store_tile<T, BKC>(Bs, rb);
    __syncthreads();
    if (k0 + BK < A.kdim) {  // the next step's loads fly during the product
      load_tile<T, AKC>(A, m0, k0 + BK, ra);
      load_tile<T, BKC>(B, n0, k0 + BK, rb);
    }
    mma_step<T, AKC, BKC>(As, Bs, acc);
  }
}

__device__ __forceinline__ int target_of(const void* tgt, int tgt64, int row,
                                         int V) {
  const long long t = tgt64 ? static_cast<const long long*>(tgt)[row]
                            : static_cast<const int*>(tgt)[row];
  return (t >= 0 && t < V) ? static_cast<int>(t) : -1;
}

template <typename T>
constexpr int kSmem = 2 * kTileBytes<T>;

// (m, l, t) <- the online-softmax state of both: max, sum of exp(x - max),
// target logit
__device__ __forceinline__ void merge(float& m, float& l, float& t, float m2,
                                      float l2, float t2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
  t += t2;
}

// Forward: block (row tile, split) walks its share of the vocabulary tiles
// and writes the split's (max, sum, target logit) of each row to
// part [3][splits][N].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const void* __restrict__ tgt, int tgt64, int N, int H,
                   int V, long long ldw, int splits,
                   float* __restrict__ part) {
  __shared__ __align__(16) unsigned char smem[kSmem<T>];
  __shared__ int s_tgt[BM];
  const int m0 = blockIdx.x * BM, split = blockIdx.y;
  for (int i = threadIdx.x; i < BM; i += kThreads)
    s_tgt[i] = m0 + i < N ? target_of(tgt, tgt64, m0 + i, V) : -1;
  // s_tgt is published by gemm_tile's first __syncthreads
  const Operand<T> A = operand(x, H, N, H);
  const Operand<T> B = operand(w, ldw, V, H);
  const int nvt = (V + BM - 1) / BM, per = (nvt + splits - 1) / splits;
  const int vt0 = split * per, vt1 = min(nvt, vt0 + per);
  float m[8], l[8], tl[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    tl[i] = 0.f;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int n0 = vt * BM;
    gemm_tile<T, true, true>(A, B, m0, n0, acc, smem);
#pragma unroll
    for (int rs = 0; rs < 8; ++rs) {
      const int tg = s_tgt[row_of<T>(rs)] - n0;  // its column in this tile
      float mx = kNegInf;
#pragma unroll
      for (int cs = 0; cs < 8; ++cs) {
        const int col = col_of<T>(cs);
        if (n0 + col < V) mx = fmaxf(mx, acc[rs][cs]);
        if (col == tg) tl[rs] += acc[rs][cs];
      }
      if (mx > m[rs]) {
        l[rs] *= expf(m[rs] - mx);
        m[rs] = mx;
      }
      float sum = 0.f;
#pragma unroll
      for (int cs = 0; cs < 8; ++cs)
        if (n0 + col_of<T>(cs) < V) sum += expf(acc[rs][cs] - m[rs]);
      l[rs] += sum;
    }
  }
  // threads holding the same row: bf16 the 4 lanes of a quad (and the 4
  // warps of a warp row, below), fp32 the 16 lanes of a half warp
  constexpr int kLanes = kIsF32<T> ? 16 : 4;
  constexpr int kSlots = kIsF32<T> ? 1 : 4;
#pragma unroll
  for (int rs = 0; rs < 8; ++rs)
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[rs], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[rs], o);
      const float t2 = __shfl_xor_sync(0xffffffffu, tl[rs], o);
      merge(m[rs], l[rs], tl[rs], m2, l2, t2);
    }
  __syncthreads();  // the operand tiles are consumed: reuse for the table
  float* red = reinterpret_cast<float*>(smem);  // [3][kSlots][BM]
  const bool lead = (threadIdx.x & (kLanes - 1)) == 0;
  const int sl = kIsF32<T> ? 0 : (threadIdx.x >> 5) & 3;
  if (lead) {
#pragma unroll
    for (int rs = 0; rs < 8; ++rs) {
      const int r = row_of<T>(rs);
      red[(0 * kSlots + sl) * BM + r] = m[rs];
      red[(1 * kSlots + sl) * BM + r] = l[rs];
      red[(2 * kSlots + sl) * BM + r] = tl[rs];
    }
  }
  __syncthreads();
  const int r = threadIdx.x, row = m0 + r;
  if (r < BM && row < N) {
    float mm = kNegInf, ll = 0.f, tt = 0.f;
#pragma unroll
    for (int q = 0; q < kSlots; ++q)
      merge(mm, ll, tt, red[q * BM + r], red[(kSlots + q) * BM + r],
            red[(2 * kSlots + q) * BM + r]);
    part[(static_cast<size_t>(0) * splits + split) * N + row] = mm;
    part[(static_cast<size_t>(1) * splits + split) * N + row] = ll;
    part[(static_cast<size_t>(2) * splits + split) * N + row] = tt;
  }
}

// lse = m + log(max(l, 1e-30)) and the target logit, over the splits in
// order
__global__ void fce_fwd_combine(const float* __restrict__ part, int splits,
                                int N, float* __restrict__ lse,
                                float* __restrict__ tl) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = kNegInf, l = 0.f, t = 0.f;
  for (int s = 0; s < splits; ++s)
    merge(m, l, t, part[static_cast<size_t>(s) * N + row],
          part[static_cast<size_t>(splits + s) * N + row],
          part[static_cast<size_t>(2 * splits + s) * N + row]);
  lse[row] = m + logf(fmaxf(l, 1e-30f));
  tl[row] = t;
}

// dlogits of one vocabulary chunk (columns [c0, c0 + Vw) of W, whose rows
// start at wc): d[n, v] = (exp(logit - lse[n]) - [c0 + v == target[n]]) *
// dl[n], rounded to T, into d [N, ldd].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fce_dlogits_kernel(const T* __restrict__ x, const T* __restrict__ wc,
                       const void* __restrict__ tgt, int tgt64,
                       const float* __restrict__ lse,
                       const float* __restrict__ dl, T* __restrict__ d, int N,
                       int H, int Vw, int c0, int V, long long ldw,
                       long long ldd) {
  __shared__ __align__(16) unsigned char smem[kSmem<T>];
  __shared__ int s_tgt[BM];
  __shared__ float s_lse[BM], s_dl[BM];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BM;
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const int row = m0 + i;
    const bool live = row < N;
    // the target's column in the chunk (negative when outside it)
    s_tgt[i] = live ? target_of(tgt, tgt64, row, V) - c0 : -1;
    s_lse[i] = live ? lse[row] : 0.f;
    s_dl[i] = live ? dl[row] : 0.f;
  }
  float acc[8][8];
  gemm_tile<T, true, true>(operand(x, H, N, H), operand(wc, ldw, Vw, H), m0,
                           n0, acc, smem);
#pragma unroll
  for (int rs = 0; rs < 8; ++rs) {
    const int r = row_of<T>(rs), row = m0 + r;
    if (row >= N) continue;
    const float ls = s_lse[r], g = s_dl[r];
    const int tg = s_tgt[r] - n0;
    T* out = d + static_cast<long long>(row) * ldd + n0;
#pragma unroll
    for (int cs = 0; cs < 8; ++cs) {
      const int col = col_of<T>(cs);
      if (n0 + col >= Vw) continue;
      const float p = expf(acc[rs][cs] - ls);
      out[col] = from_f<T>((p - (col == tg ? 1.f : 0.f)) * g);
    }
  }
}

// dx over one chunk: acc_buf [N, H] (+)= d [N, Vw] . W_c [Vw, H]; the first
// chunk writes, the others read and add; the last writes dx in T instead
// (acc_buf may be dx itself when T is float)
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fce_dx_kernel(const T* __restrict__ d, const T* __restrict__ wc,
                  float* acc_buf, T* dx, int N, int H, int Vw, long long ldd,
                  long long ldw, int first, int last) {
  __shared__ __align__(16) unsigned char smem[kSmem<T>];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BM;
  float acc[8][8];
  // W_c element (h, v) lies at wc[v * ldw + h]: depth-major
  gemm_tile<T, true, false>(operand(d, ldd, N, Vw), operand(wc, ldw, H, Vw),
                            m0, n0, acc, smem);
#pragma unroll
  for (int rs = 0; rs < 8; ++rs) {
    const int row = m0 + row_of<T>(rs);
    if (row >= N) continue;
#pragma unroll
    for (int cs = 0; cs < 8; ++cs) {
      const int col = n0 + col_of<T>(cs);
      if (col >= H) continue;
      const long long at = static_cast<long long>(row) * H + col;
      const float v = acc[rs][cs] + (first ? 0.f : acc_buf[at]);
      if (last)
        dx[at] = from_f<T>(v);
      else
        acc_buf[at] = v;
    }
  }
}

// dW over one chunk: dwc [Vw, H] = d[:, :Vw]^T . x, summed over all N rows
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fce_dw_kernel(const T* __restrict__ d, const T* __restrict__ x,
                  T* __restrict__ dwc, int N, int H, int Vw, long long ldd) {
  __shared__ __align__(16) unsigned char smem[kSmem<T>];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BM;
  float acc[8][8];
  // d element (v, n) at d[n * ldd + v], x element (h, n) at x[n * H + h]
  gemm_tile<T, false, false>(operand(d, ldd, Vw, N), operand(x, H, H, N), m0,
                             n0, acc, smem);
#pragma unroll
  for (int rs = 0; rs < 8; ++rs) {
    const int row = m0 + row_of<T>(rs);
    if (row >= Vw) continue;
#pragma unroll
    for (int cs = 0; cs < 8; ++cs) {
      const int col = n0 + col_of<T>(cs);
      if (col < H)
        dwc[static_cast<long long>(row) * H + col] = from_f<T>(acc[rs][cs]);
    }
  }
}

int blocks(int n) { return (n + BM - 1) / BM; }

template <typename T>
int fwd(const void* x, const void* w, const void* tgt, int tgt64, float* part,
        float* lse, float* tl, int N, int H, int V, long long ldw, int splits,
        cudaStream_t s) {
  fce_fwd_kernel<T><<<dim3(blocks(N), splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), tgt, tgt64, N, H, V,
      ldw, splits, part);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  fce_fwd_combine<<<(N + 255) / 256, 256, 0, s>>>(part, splits, N, lse, tl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dlogits(const void* x, const void* wc, const void* tgt, int tgt64,
            const float* lse, const float* dl, void* d, int N, int H, int Vw,
            int c0, int V, long long ldw, long long ldd, cudaStream_t s) {
  fce_dlogits_kernel<T><<<dim3(blocks(N), blocks(Vw)), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), tgt, tgt64, lse,
      dl, static_cast<T*>(d), N, H, Vw, c0, V, ldw, ldd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dx_chunk(const void* d, const void* wc, float* acc, void* dx, int N, int H,
             int Vw, long long ldd, long long ldw, int first, int last,
             cudaStream_t s) {
  fce_dx_kernel<T><<<dim3(blocks(N), blocks(H)), kThreads, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wc), acc,
      static_cast<T*>(dx), N, H, Vw, ldd, ldw, first, last);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dw_chunk(const void* d, const void* x, void* dwc, int N, int H, int Vw,
             long long ldd, cudaStream_t s) {
  fce_dw_kernel<T><<<dim3(blocks(Vw), blocks(H)), kThreads, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(x),
      static_cast<T*>(dwc), N, H, Vw, ldd);
  return static_cast<int>(cudaGetLastError());
}

bool bad(int N, int H, int V, int dtype) {
  return N < 1 || H < 1 || V < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace

// C interface (bound with ctypes).  dtype 0 = float32, 1 = bfloat16 (x, W,
// dlogits, dx and dW all of it); x [N, H] and dx [N, H] contiguous; W rows
// [V, H] with row stride ldw (wc: the first row of a chunk); targets [N]
// int64 (tgt64 = 1) or int32; lse, tl, dl [N] fp32; the dlogits scratch
// d [N, ldd]; dW rows [V, H] contiguous (dwc: the chunk's first row).
// Each returns cudaGetLastError() after its launches (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.

// forward: part is scratch [3, splits, N] fp32; lse, tl out
extern "C" int bps_fce_fwd(const void* x, const void* w, const void* tgt,
                           int tgt64, float* part, float* lse, float* tl,
                           int N, int H, int V, long long ldw, int splits,
                           int dtype, void* stream) {
  if (bad(N, H, V, dtype) || splits < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? fwd<__nv_bfloat16>(x, w, tgt, tgt64, part, lse, tl, N, H, V,
                                    ldw, splits, s)
               : fwd<float>(x, w, tgt, tgt64, part, lse, tl, N, H, V, ldw,
                            splits, s);
}

// the dlogits of vocabulary columns [c0, c0 + Vw) into d
extern "C" int bps_fce_dlogits(const void* x, const void* wc, const void* tgt,
                               int tgt64, const float* lse, const float* dl,
                               void* d, int N, int H, int Vw, int c0, int V,
                               long long ldw, long long ldd, int dtype,
                               void* stream) {
  if (bad(N, H, V, dtype) || Vw < 1 || Vw > ldd || blocks(Vw) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dlogits<__nv_bfloat16>(x, wc, tgt, tgt64, lse, dl, d, N, H,
                                        Vw, c0, V, ldw, ldd, s)
               : dlogits<float>(x, wc, tgt, tgt64, lse, dl, d, N, H, Vw, c0,
                                V, ldw, ldd, s);
}

// dx over one chunk (first: acc is written, not read; last: dx is written)
extern "C" int bps_fce_dx(const void* d, const void* wc, float* acc, void* dx,
                          int N, int H, int Vw, long long ldd, long long ldw,
                          int first, int last, int dtype, void* stream) {
  if (bad(N, H, Vw, dtype) || blocks(H) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dx_chunk<__nv_bfloat16>(d, wc, acc, dx, N, H, Vw, ldd, ldw,
                                         first, last, s)
               : dx_chunk<float>(d, wc, acc, dx, N, H, Vw, ldd, ldw, first,
                                 last, s);
}

// dW rows [c0, c0 + Vw) of one chunk
extern "C" int bps_fce_dw(const void* d, const void* x, void* dwc, int N,
                          int H, int Vw, long long ldd, int dtype,
                          void* stream) {
  if (bad(N, H, Vw, dtype) || blocks(H) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dw_chunk<__nv_bfloat16>(d, x, dwc, N, H, Vw, ldd, s)
               : dw_chunk<float>(d, x, dwc, N, H, Vw, ldd, s);
}
