// Fused LM-head cross-entropy for Hopper (sm_90a), hand-written CUDA C++:
// the forward, the dlogits + dx backward and the dW backward.
//
// Replaces the TPU kernels of byteps_tpu/ops/fused_cross_entropy.py:
//   * fce_fwd_tma_kernel / fce_fwd_kernel (+ fce_fwd_combine)
//                                          <- `_fwd_kernel` (:77, pallas_call
//                                             at :184)
//   * fce_dlogits_tma_kernel + fce_dx_tma_kernel (bf16 on TMA and wgmma),
//     fce_dlogits_kernel + fce_dx_kernel   <- `_dx_kernel` (:115, :265)
//   * fce_dw_tma_kernel (bf16 on TMA and wgmma), fce_dw_kernel
//                                          <- `_dw_kernel` (:144, :282)
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
// scratch) are far smaller.  Only wgmma reaches the bf16 rate; the staged
// bytes a FLOP (85 FLOPs a staged byte in the 128 x 256 tile, 64 in the
// 128 x 128 one) then decide whether L2 keeps up.  With all four bf16
// kernels on wgmma the backward draws the card's power limit and runs at
// a lower SM clock than the first design.
//
// Design of the bf16 kernels on TMA and wgmma (forward, dlogits, dx, dW),
// which take every shape TMA can describe: bf16, H, ldw and ldd
// multiples of 8 (16-byte row strides) and 16-byte-aligned bases (`tma_ok`;
// dW takes the same rule on x, its output rows and d, with the table's
// stride, so a backward chunk runs one design throughout;
// the Python wrapper's `_tma_ok` states it too, and the wrapper checks
// every call's prediction against the launches `bps_fce_tma_launches`
// reports):
//   * one mainloop: a 128 x 256 output tile, K in 64-deep steps (128-byte
//     rows, TMA's 128-byte swizzle, read by wgmma's shared-memory
//     descriptors as they lie); a ring of 4 stages of (128 + 256) x 64 bf16
//     (192 KB of dynamic shared memory) tracked by a full and an empty
//     mbarrier each; one producer warp issues the TMA loads (its warpgroup
//     gives registers back with setmaxnreg), two consumer warpgroups each
//     own 64 x 256 of the tile with wgmma.m64n256k16 (128 fp32 accumulators
//     a thread) and release a stage once the products reading it are done;
//   * the grid is persistent: one CTA per SM walks output tiles (or, in the
//     forward, (row tile, split) units) in a fixed order, rows fastest
//     where the CTAs resident together should share W's tiles (forward,
//     dlogits: W is read from device memory about once a pass, x from L2)
//     and columns fastest in dx and dW (the CTAs of one dlogits row or
//     column block share it; dW's x, 32 MB at the training shape, stays
//     in L2);
//   * the ragged edges are TMA's: rows and columns outside a tensor map
//     arrive as zeros (d's map is Vw wide, so stale scratch columns of the
//     last chunk read as 0; W's maps end at the table's last row), and the
//     epilogues mask rows >= N (dW: >= Vw) and columns >= V, Vw or H;
//   * dx's B operand is W_c read as the [Vw, H] rows it is: N-contiguous
//     (MN-major) 64 x 64 boxes, wgmma's transpose-B mode, no copy; dW
//     reads both operands so: A = d^T as one 64(v) x 64(n) box per
//     consumer warpgroup (transpose-A), B = x as four 64(h) x 64(n) boxes,
//     K = N; one produce / consume loop serves all four kernels;
//   * epilogues on the accumulator fragments (thread of warp w, lane l of a
//     warpgroup: rows 16w + l/4 and +8, columns 8j + 2(l%4) + {0, 1}, j <
//     32): the forward folds each tile into the online (max, sum, target
//     logit) of the thread's two rows, merged across the quad once a unit
//     and across splits by fce_fwd_combine; dlogits writes
//     (exp(logit - lse) - onehot) * dl in bf16 into the same [N, ldd]
//     scratch the dW kernel reads, 16 bytes a lane after a transpose
//     within the quad (4-byte pairs take four times the store
//     instructions); dx keeps the fp32 cross-chunk sum, a row's 32
//     reads of it issued before its stores (read one by one behind the
//     stores, their latencies add up over the epilogue); dW writes its
//     bf16 rows 16 bytes a lane after the same quad transpose.
//   No split-K and no atomics: every output element is owned by one tile,
//   so reruns stay bit-identical.
//
// The first design, which fp32 (scalar FMA, never TF32) and the shapes TMA
// cannot describe keep:
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

// ------------------------------------------------ bf16 on TMA and wgmma
//
// Shared memory of a CTA: 4 stages of an A tile [128][64] and a B tile
// [256][64] bf16 (K-major: 128-byte rows in TMA's 128-byte swizzle) or,
// for dx, [64][256] as four N-contiguous [64][64] boxes; then the stages'
// full and empty mbarriers.

constexpr int TM = 128;           // rows of an output tile (2 x 64)
constexpr int TN = 256;           // columns of an output tile
constexpr int TK = 64;            // depth of one stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kTmaThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kABytes = TM * TK * 2;
constexpr int kBBytes = TN * TK * 2;
constexpr int kBoxBytes = 64 * TK * 2;  // one [64][64] box
constexpr int kTmaSmem = kStages * (kABytes + kBBytes) + 2 * kStages * 8 +
                         1024;  // + the slack to align the ring to 1024
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTmaSmem <= 232448, "the ring fits a Hopper block");

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

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle 128B.
//   K-major (rows of 64 depth values): SBO 1024 = the next 8 rows; LBO
//     unused (1); the k16 step advances the start by 32 bytes.
//   MN-major (dx's B, dW's A and B: rows of 64 M or N values, one row per
//     depth): LBO = the next 64 values (the next box, 8192 bytes; unused
//     for A's 64 rows), SBO 1024 = the next 8 depths; the k16 step
//     advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// d (+)= A[64 x 16] B[16 x 256] of the warpgroup; each operand K-major
// (TA, TB = 0) or MN-major (1: wgmma's transpose); scale_d = 0 overwrites d
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The ring: 4 stages of A and B tiles, aligned to 1024 bytes (the period
// of the 128-byte swizzle, so TMA's and wgmma's views of a tile agree),
// and their barriers: full[s] completes when the stage's bytes have
// landed (one arrival: the producer's expect_tx), empty[s] when both
// consumer warpgroups have released it.
struct Ring {
  unsigned char* a;
  unsigned char* b;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(unsigned char* raw) {
  unsigned char* p = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring r;
  r.a = p;
  r.b = p + kStages * kABytes;
  r.full = reinterpret_cast<uint64_t*>(p + kStages * (kABytes + kBBytes));
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The position of a pipeline: stage and the parity of its round.
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer (one thread): the nk stages of one output tile.  An operand
// is K-major (MN false: `rows` rows of its map from `at`, depth inner;
// A's 128, B's 256) or MN-major (MN true: depth rows of its map with the
// tile's M or N values [at, at + 128 or 256) inner, as boxes of 64, the
// boxes wholly past `end` skipped: they would feed only discarded rows or
// columns).  dx reads B MN-major, dW both.
template <bool AMN, bool BMN>
__device__ __forceinline__ void produce(const CUtensorMap* ma,
                                        const CUtensorMap* mb, const Ring& r,
                                        int nk, int a_at, int a_end, int b_at,
                                        int b_end, Pos& ps) {
  const int aboxes = AMN ? min(2, (a_end - a_at + 63) / 64) : 1;
  const int bboxes = BMN ? min(4, (b_end - b_at + 63) / 64) : 1;
  const uint32_t bytes = (AMN ? aboxes * kBoxBytes : kABytes) +
                         (BMN ? bboxes * kBoxBytes : kBBytes);
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&r.empty[ps.stage], ps.phase ^ 1);
    uint64_t* full = &r.full[ps.stage];
    mbar_expect_tx(full, bytes);
    unsigned char* a = r.a + ps.stage * kABytes;
    if (AMN) {
      for (int q = 0; q < aboxes; ++q)
        tma_load(a + q * kBoxBytes, ma, full, a_at + 64 * q, kb * TK);
    } else {
      tma_load(a, ma, full, kb * TK, a_at);
    }
    unsigned char* b = r.b + ps.stage * kBBytes;
    if (BMN) {
      for (int q = 0; q < bboxes; ++q)
        tma_load(b + q * kBoxBytes, mb, full, b_at + 64 * q, kb * TK);
    } else {
      tma_load(b, mb, full, kb * TK, b_at);
    }
    ps.next();
  }
}

// Consumer warpgroup wg (0 or 1): acc = its 64 rows of the tile's product
// over nk stages.  A stage is released once the products that read it are
// done: one wgmma group stays in flight while the next stage is waited
// for.  The warpgroup's 64 A rows lie 8192 bytes into the stage in both
// forms (64 K-major rows of 128 bytes, or its own MN-major box).
template <int TA, int TB>
__device__ __forceinline__ void consume(float (&acc)[128], const Ring& r,
                                        int nk, int wg, Pos& ps) {
  int prev = 0;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&r.full[ps.stage], ps.phase);
    const uint32_t a = smem_u32(r.a + ps.stage * kABytes) + wg * 64 * 128;
    const uint32_t b = smem_u32(r.b + ps.stage * kBBytes);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TK / 16; ++k) {
      const uint64_t da = TA ? sw128_desc(a + 2048 * k, kBoxBytes, 1024)
                             : sw128_desc(a + 32 * k, 16, 1024);
      const uint64_t db = TB ? sw128_desc(b + 2048 * k, kBoxBytes, 1024)
                             : sw128_desc(b + 32 * k, 16, 1024);
      wgmma_256<TA, TB>(acc, da, db, (kb | k) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kb > 0 && (threadIdx.x & 127) == 0) mbar_arrive(&r.empty[prev]);
    prev = ps.stage;
    ps.next();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if ((threadIdx.x & 127) == 0) mbar_arrive(&r.empty[prev]);
}

// The fragment of a consumer thread: rows row0 and row0 + 8 of the tile,
// columns col0 + 8j + {0, 1}; acc[4j + 2h + e] is (row0 + 8h, col0 + 8j +
// e).
struct Frag {
  int row0, col0;
};

__device__ __forceinline__ Frag frag(int m0, int wg) {
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  return Frag{m0 + wg * 64 + w * 16 + (lane >> 2), 2 * (lane & 3)};
}

// Fold one tile's logits (columns n0 + col0 + 8j + e) into the online
// (max m, sum l, target logit tl) of the thread's two rows; columns >= V
// (zeros from TMA) are masked when MASK.
template <bool MASK>
__device__ __forceinline__ void fold(const float (&acc)[128], const Frag& f,
                                     int n0, int V, const int (&tg)[2],
                                     float (&m)[2], float (&l)[2],
                                     float (&tl)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!MASK || n0 + f.col0 + 8 * j + e < V)
          mx = fmaxf(mx, acc[4 * j + 2 * h + e]);
    const float mn = fmaxf(m[h], mx), ms = mn * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!MASK || n0 + f.col0 + 8 * j + e < V)
          sum += ex2(fmaf(acc[4 * j + 2 * h + e], kLog2e, -ms));
    l[h] = fmaf(l[h], ex2((m[h] - mn) * kLog2e), sum);
    m[h] = mn;
    const int c = tg[h] - n0 - f.col0;  // the target's place among mine
    if (c >= 0 && c < TN && (c & 6) == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (j == (c >> 3))
          tl[h] += (c & 1) ? acc[4 * j + 2 * h + 1] : acc[4 * j + 2 * h];
    }
  }
}

// Forward: unit u = (row tile, split) walks its split's vocabulary tiles
// [split * nvt / splits, (split + 1) * nvt / splits) and writes the
// split's (max, sum, target logit) of each row to part [3][splits][N].
__global__ void __launch_bounds__(kTmaThreads, 1)
    fce_fwd_tma_kernel(const __grid_constant__ CUtensorMap mx,
                       const __grid_constant__ CUtensorMap mw,
                       const void* __restrict__ tgt, int tgt64, int N, int H,
                       int V, int splits, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int ntm = (N + TM - 1) / TM, nvt = (V + TN - 1) / TN;
  const int nk = (H + TK - 1) / TK, units = ntm * splits;
  Pos ps;
  if (threadIdx.x < 128) {
    regs_dec<40>();
    if (threadIdx.x != 0) return;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tm = u % ntm, sp = u / ntm;
      const int vt1 = static_cast<int>(static_cast<long long>(sp + 1) * nvt /
                                       splits);
      for (int vt = static_cast<int>(static_cast<long long>(sp) * nvt /
                                     splits);
           vt < vt1; ++vt)
        produce<false, false>(&mx, &mw, r, nk, tm * TM, 0, vt * TN, 0, ps);
    }
    return;
  }
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  float acc[128];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tm = u % ntm, sp = u / ntm;  // rows fastest
    const Frag f = frag(tm * TM, wg);
    int tg[2];
    float m[2], l[2], tl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      tg[h] = row < N ? target_of(tgt, tgt64, row, V) : -1;
      m[h] = kNegInf;
      l[h] = tl[h] = 0.f;
    }
    const int vt1 =
        static_cast<int>(static_cast<long long>(sp + 1) * nvt / splits);
    for (int vt = static_cast<int>(static_cast<long long>(sp) * nvt / splits);
         vt < vt1; ++vt) {
      consume<0, 0>(acc, r, nk, wg, ps);
      const int n0 = vt * TN;
      if (n0 + TN <= V)
        fold<false>(acc, f, n0, V, tg, m, l, tl);
      else
        fold<true>(acc, f, n0, V, tg, m, l, tl);
    }
    // the 4 lanes of a quad hold the same rows
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float t2 = __shfl_xor_sync(0xffffffffu, tl[h], o);
        merge(m[h], l[h], tl[h], m2, l2, t2);
      }
    if (f.col0 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = f.row0 + 8 * h;
        if (row >= N) continue;
        part[(static_cast<size_t>(0) * splits + sp) * N + row] = m[h];
        part[(static_cast<size_t>(1) * splits + sp) * N + row] = l[h];
        part[(static_cast<size_t>(2) * splits + sp) * N + row] = tl[h];
      }
    }
  }
}

// The 4 lanes of a quad hold, at v[i], the bf16 pair of columns 8(j0 + i)
// + 2 * lane; afterwards lane t holds the pairs of columns 8(j0 + t) + 2i,
// i.e. 8 consecutive columns (a 4 x 4 transpose in two butterfly steps).
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = __shfl_xor_sync(0xffffffffu, v[i ^ b], b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((i ^ t) & b) v[i] = y[i];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// dlogits of one chunk: tile (row tile, column tile of Vw) of
// (exp(x W_c^T - lse) - onehot) * dl, rounded to bf16, into d [N, ldd].
// A whole tile goes out in 16-byte stores (8 columns a lane, after a
// transpose within the quad); the chunk's last, ragged tile (MASK) in
// pairs.
template <bool MASK>
__device__ __forceinline__ void store_dlogits(
    const float (&acc)[128], const Frag& f, int n0, int N, int Vw,
    const int (&tg)[2], const float (&ls)[2], const float (&g)[2],
    __nv_bfloat16* __restrict__ d, long long ldd) {
  if (MASK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      if (row >= N) continue;
      __nv_bfloat16* out = d + static_cast<long long>(row) * ldd + n0;
      const int tc = tg[h] - n0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = f.col0 + 8 * j;
        if (n0 + c >= Vw) continue;
        const float p0 = ex2(fmaf(acc[4 * j + 2 * h], kLog2e, -ls[h]));
        const float p1 = ex2(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -ls[h]));
        const float v0 = (p0 - (c == tc ? 1.f : 0.f)) * g[h];
        const float v1 = (p1 - (c + 1 == tc ? 1.f : 0.f)) * g[h];
        if (n0 + c + 1 < Vw)
          *reinterpret_cast<__nv_bfloat162*>(out + c) =
              __floats2bfloat162_rn(v0, v1);
        else
          out[c] = __float2bfloat16(v0);
      }
    }
    return;
  }
  // every lane of the quad takes part in the transposes: rows >= N are
  // computed (from zeros) and not stored
  const int t = f.col0 >> 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = f.row0 + 8 * h;
    const bool live = row < N;
    __nv_bfloat16* out = d + static_cast<long long>(row) * ldd + n0;
    const int tc = tg[h] - n0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i, c = f.col0 + 8 * j;
        const float p0 = ex2(fmaf(acc[4 * j + 2 * h], kLog2e, -ls[h]));
        const float p1 = ex2(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -ls[h]));
        v[i] = pack_bf16((p0 - (c == tc ? 1.f : 0.f)) * g[h],
                         (p1 - (c + 1 == tc ? 1.f : 0.f)) * g[h]);
      }
      quad_transpose(v, t);
      if (live)
        *reinterpret_cast<uint4*>(out + 8 * (4 * q + t)) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__global__ void __launch_bounds__(kTmaThreads, 1)
    fce_dlogits_tma_kernel(const __grid_constant__ CUtensorMap mx,
                           const __grid_constant__ CUtensorMap mw,
                           const void* __restrict__ tgt, int tgt64,
                           const float* __restrict__ lse,
                           const float* __restrict__ dl,
                           __nv_bfloat16* __restrict__ d, int N, int H, int Vw,
                           int c0, int V, long long ldd) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int ntm = (N + TM - 1) / TM, ntn = (Vw + TN - 1) / TN;
  const int nk = (H + TK - 1) / TK, tiles = ntm * ntn;
  Pos ps;
  if (threadIdx.x < 128) {
    regs_dec<40>();
    if (threadIdx.x != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int tm = t % ntm, tn = t / ntm;
      produce<false, false>(&mx, &mw, r, nk, tm * TM, 0, tn * TN, 0, ps);
    }
    return;
  }
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  float acc[128];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tm = t % ntm, tn = t / ntm;  // rows fastest
    const Frag f = frag(tm * TM, wg);
    int tg[2];
    float ls[2], g[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      const bool live = row < N;
      // the target's column in the chunk (negative when outside it)
      tg[h] = live ? target_of(tgt, tgt64, row, V) - c0 : -1;
      ls[h] = live ? lse[row] * kLog2e : 0.f;
      g[h] = live ? dl[row] : 0.f;
    }
    consume<0, 0>(acc, r, nk, wg, ps);
    const int n0 = tn * TN;
    if (n0 + TN <= Vw)
      store_dlogits<false>(acc, f, n0, N, Vw, tg, ls, g, d, ldd);
    else
      store_dlogits<true>(acc, f, n0, N, Vw, tg, ls, g, d, ldd);
  }
}

// dx over one chunk: tile (row tile, column tile of H) of acc_buf [N, H]
// (+)= d [N, Vw] . W_c [Vw, H]; the first chunk writes, the others read
// and add, the last writes dx in bf16 instead.
__global__ void __launch_bounds__(kTmaThreads, 1)
    fce_dx_tma_kernel(const __grid_constant__ CUtensorMap md,
                      const __grid_constant__ CUtensorMap mw,
                      float* __restrict__ acc_buf,
                      __nv_bfloat16* __restrict__ dx, int N, int H, int Vw,
                      int first, int last) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int ntm = (N + TM - 1) / TM, ntn = (H + TN - 1) / TN;
  const int nk = (Vw + TK - 1) / TK, tiles = ntm * ntn;
  Pos ps;
  if (threadIdx.x < 128) {
    regs_dec<40>();
    if (threadIdx.x != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int tm = t / ntn, tn = t % ntn;
      produce<false, true>(&md, &mw, r, nk, tm * TM, 0, tn * TN, H, ps);
    }
    return;
  }
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  float acc[128];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tm = t / ntn, tn = t % ntn;  // columns fastest
    const Frag f = frag(tm * TM, wg);
    consume<0, 1>(acc, r, nk, wg, ps);
    const int n0 = tn * TN;
    // a row's 32 reads of the sum are issued together, ahead of its
    // stores, so their latencies overlap
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      if (row >= N) continue;
      const long long at0 = static_cast<long long>(row) * H + n0 + f.col0;
      float2 o[32];
      if (!first) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          o[j] = n0 + f.col0 + 8 * j < H
                     ? *reinterpret_cast<const float2*>(acc_buf + at0 + 8 * j)
                     : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + f.col0 + 8 * j;  // H is even: col + 1 < H too
        if (col >= H) continue;
        const long long at = at0 + 8 * j;
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (!first) {
          v0 += o[j].x;
          v1 += o[j].y;
        }
        if (last)
          *reinterpret_cast<__nv_bfloat162*>(dx + at) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(acc_buf + at) = make_float2(v0, v1);
      }
    }
  }
}

// dW over one chunk: tile (row tile of Vw, column tile of H) of dwc [Vw, H]
// = d[:, :Vw]^T x, the contraction over all N rows in 64-deep steps (both
// operands MN-major: d's rows hold v, x's rows h), rounded to bf16 once.
// Rows >= Vw and columns >= H are not stored (H is a multiple of 8, so a
// lane's 8 columns are all in or all out).
__global__ void __launch_bounds__(kTmaThreads, 1)
    fce_dw_tma_kernel(const __grid_constant__ CUtensorMap md,
                      const __grid_constant__ CUtensorMap mx,
                      __nv_bfloat16* __restrict__ dwc, int N, int H,
                      int Vw) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int ntm = (Vw + TM - 1) / TM, ntn = (H + TN - 1) / TN;
  const int nk = (N + TK - 1) / TK, tiles = ntm * ntn;
  Pos ps;
  if (threadIdx.x < 128) {
    regs_dec<40>();
    if (threadIdx.x != 0) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int tm = t / ntn, tn = t % ntn;
      produce<true, true>(&md, &mx, r, nk, tm * TM, Vw, tn * TN, H, ps);
    }
    return;
  }
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  float acc[128];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tm = t / ntn, tn = t % ntn;  // columns fastest
    const Frag f = frag(tm * TM, wg);
    consume<1, 1>(acc, r, nk, wg, ps);
    // 16-byte stores of 8 columns a lane, after a transpose within the
    // quad; every lane of the quad takes part, rows >= Vw store nothing
    const int n0 = tn * TN, lane_t = f.col0 >> 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = f.row0 + 8 * h;
      const bool live = row < Vw;
      __nv_bfloat16* out = dwc + static_cast<long long>(row) * H + n0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          v[i] = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        quad_transpose(v, lane_t);
        const int c = 8 * (4 * q + lane_t);
        if (live && n0 + c < H)
          *reinterpret_cast<uint4*>(out + c) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---------------------------------------------------- host side of TMA

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

// A bf16 matrix of `outer` rows of `inner` elements, rows `ld` elements
// apart, read in boxes of box_outer rows of box_inner (128 bytes) with the
// 128-byte swizzle; what lies outside reads as zeros.
bool tensor_map(CUtensorMap* map, const void* base, long long inner,
                long long outer, long long ld, int box_inner, int box_outer) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The rule between the two bf16 designs (`_tma_ok` in the Python wrapper
// states it too and is held to the launches counted here): TMA reads x [N, H], the W rows (stride ldw) and the
// dlogits scratch (stride ldd) when each base is 16-byte aligned and each
// row stride a multiple of 16 bytes.
bool tma_ok(const void* x, const void* w, const void* d, int H,
            long long ldw, long long ldd) {
  return H % 8 == 0 && ldw % 8 == 0 && ldd % 8 == 0 && aligned16(x) &&
         aligned16(w) && aligned16(d);
}

// SMs of the current device: the persistent grid's size
int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return max(n, 1);
}

// TMA kernels launched since the library was loaded: the path the bf16
// calls took, read back by the wrapper (bps_fce_tma_launches)
long long tma_launches = 0;

// the launch of a persistent TMA kernel over `work` units: its dynamic
// shared memory allowed once per kernel, at most one CTA per SM
template <typename Kernel, typename... Args>
int launch_tma(Kernel kernel, bool& allowed, int work, cudaStream_t s,
               Args... args) {
  if (!allowed) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTmaSmem))
      return static_cast<int>(e);
    allowed = true;
  }
  const int grid = max(1, min(work, sm_count()));
  kernel<<<grid, kTmaThreads, kTmaSmem, s>>>(args...);
  const cudaError_t e = cudaGetLastError();
  tma_launches += e == cudaSuccess;
  return static_cast<int>(e);
}

constexpr int kBadMap = static_cast<int>(cudaErrorInvalidValue);

int fwd_tma(const void* x, const void* w, const void* tgt, int tgt64,
            float* part, int N, int H, int V, long long ldw, int splits,
            cudaStream_t s) {
  CUtensorMap mx, mw;
  if (!tensor_map(&mx, x, H, N, H, TK, TM) ||
      !tensor_map(&mw, w, H, V, ldw, TK, TN))
    return kBadMap;
  static bool allowed = false;
  const int ntm = (N + TM - 1) / TM;
  // rows fastest: the CTAs resident together walk the same W tiles
  return launch_tma(fce_fwd_tma_kernel, allowed, ntm * splits, s, mx, mw, tgt,
                    tgt64, N, H, V, splits, part);
}

int dlogits_tma(const void* x, const void* wc, const void* tgt, int tgt64,
                const float* lse, const float* dl, void* d, int N, int H,
                int Vw, int c0, int V, long long ldw, long long ldd,
                cudaStream_t s) {
  CUtensorMap mx, mw;
  // W's map ends at the table's last row: rows past V read as zeros
  if (!tensor_map(&mx, x, H, N, H, TK, TM) ||
      !tensor_map(&mw, wc, H, V - c0, ldw, TK, TN))
    return kBadMap;
  static bool allowed = false;
  const int ntm = (N + TM - 1) / TM, ntn = (Vw + TN - 1) / TN;
  return launch_tma(fce_dlogits_tma_kernel, allowed, ntm * ntn, s, mx, mw,
                    tgt, tgt64, lse, dl, static_cast<__nv_bfloat16*>(d), N, H,
                    Vw, c0, V, ldd);
}

int dx_tma(const void* d, const void* wc, float* acc, void* dx, int N, int H,
           int Vw, long long ldd, long long ldw, int first, int last,
           cudaStream_t s) {
  CUtensorMap md, mw;
  // d's map is Vw wide: the last chunk's stale scratch columns read as
  // zeros; W_c's rows end at Vw
  if (!tensor_map(&md, d, Vw, N, ldd, TK, TM) ||
      !tensor_map(&mw, wc, H, Vw, ldw, 64, TK))
    return kBadMap;
  static bool allowed = false;
  const int ntm = (N + TM - 1) / TM, ntn = (H + TN - 1) / TN;
  // columns fastest: the CTAs of one d row block run together
  return launch_tma(fce_dx_tma_kernel, allowed, ntm * ntn, s, md, mw, acc,
                    static_cast<__nv_bfloat16*>(dx), N, H, Vw, first, last);
}

int dw_tma(const void* d, const void* x, void* dwc, int N, int H, int Vw,
           long long ldd, cudaStream_t s) {
  CUtensorMap md, mx;
  // d's map is Vw wide: the last chunk's stale scratch columns read as
  // zeros; both maps end at row N
  if (!tensor_map(&md, d, Vw, N, ldd, 64, TK) ||
      !tensor_map(&mx, x, H, N, H, 64, TK))
    return kBadMap;
  static bool allowed = false;
  const int ntm = (Vw + TM - 1) / TM, ntn = (H + TN - 1) / TN;
  // columns fastest: the CTAs of one d column block share its tiles in L2
  return launch_tma(fce_dw_tma_kernel, allowed, ntm * ntn, s, md, mx,
                    static_cast<__nv_bfloat16*>(dwc), N, H, Vw);
}

int blocks(int n) { return (n + BM - 1) / BM; }

template <typename T>
int fwd(const void* x, const void* w, const void* tgt, int tgt64, float* part,
        float* lse, float* tl, int N, int H, int V, long long ldw, int splits,
        cudaStream_t s) {
  if (!kIsF32<T> && tma_ok(x, w, x, H, ldw, 8)) {
    if (int e = fwd_tma(x, w, tgt, tgt64, part, N, H, V, ldw, splits, s))
      return e;
  } else {
    fce_fwd_kernel<T><<<dim3(blocks(N), splits), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), tgt, tgt64, N, H,
        V, ldw, splits, part);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  fce_fwd_combine<<<(N + 255) / 256, 256, 0, s>>>(part, splits, N, lse, tl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dlogits(const void* x, const void* wc, const void* tgt, int tgt64,
            const float* lse, const float* dl, void* d, int N, int H, int Vw,
            int c0, int V, long long ldw, long long ldd, cudaStream_t s) {
  if (!kIsF32<T> && tma_ok(x, wc, d, H, ldw, ldd))
    return dlogits_tma(x, wc, tgt, tgt64, lse, dl, d, N, H, Vw, c0, V, ldw,
                       ldd, s);
  fce_dlogits_kernel<T><<<dim3(blocks(N), blocks(Vw)), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wc), tgt, tgt64, lse,
      dl, static_cast<T*>(d), N, H, Vw, c0, V, ldw, ldd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dx_chunk(const void* d, const void* wc, float* acc, void* dx, int N, int H,
             int Vw, long long ldd, long long ldw, int first, int last,
             cudaStream_t s) {
  if (!kIsF32<T> && tma_ok(d, wc, d, H, ldw, ldd))
    return dx_tma(d, wc, acc, dx, N, H, Vw, ldd, ldw, first, last, s);
  fce_dx_kernel<T><<<dim3(blocks(N), blocks(H)), kThreads, 0, s>>>(
      static_cast<const T*>(d), static_cast<const T*>(wc), acc,
      static_cast<T*>(dx), N, H, Vw, ldd, ldw, first, last);
  return static_cast<int>(cudaGetLastError());
}

// dW takes the chunk's rule, the table's row stride included, so that a
// backward chunk runs one design throughout
template <typename T>
int dw_chunk(const void* d, const void* x, void* dwc, int N, int H, int Vw,
             long long ldd, long long ldw, cudaStream_t s) {
  if (!kIsF32<T> && tma_ok(x, dwc, d, H, ldw, ldd))
    return dw_tma(d, x, dwc, N, H, Vw, ldd, s);
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
// cudaErrorInvalidValue for a shape the kernels do not take (or a tensor
// map the CUDA driver refuses).  bf16 forward, dlogits, dx and dW take
// the kernels on TMA and wgmma where `tma_ok` holds, the first design
// elsewhere.

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

// the TMA kernels launched so far: the wrapper reads it around each call
extern "C" long long bps_fce_tma_launches() { return tma_launches; }

// dW rows [c0, c0 + Vw) of one chunk (ldw: the table's row stride, for
// the path rule)
extern "C" int bps_fce_dw(const void* d, const void* x, void* dwc, int N,
                          int H, int Vw, long long ldd, long long ldw,
                          int dtype, void* stream) {
  if (bad(N, H, Vw, dtype) || blocks(H) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype ? dw_chunk<__nv_bfloat16>(d, x, dwc, N, H, Vw, ldd, ldw, s)
               : dw_chunk<float>(d, x, dwc, N, H, Vw, ldd, ldw, s);
}
