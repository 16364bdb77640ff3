// byteps_tpu_torch native runtime — host-side hot loops of the async
// parameter-server tier: the port's own copy of the JAX package's
// csrc/byteps_native.cc, function for function, so a shard of either
// package sums bit for bit alike.  One line differs: the fp16 / bf16
// adds pin which NaN operand survives (add_dst_nan_first), which the
// original leaves to the compiler's operand order.
//
// The server-tier elementwise summation (reference cpu_reducer.cc:41-155 —
// the OpenMP-parallel sum the async-PS store runs), fp16 / bf16 software
// conversion (cpu_reducer.h:64-160) and the key->server sharding hash
// (global.cc:305-334).  Built at first use by native/reducer.py with the
// host compiler (no -march=native: the library may be loaded on another
// host than the one that built it).
//
// C ABI only (loaded via ctypes).

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------- reducers

void bps_sum_f32(float* dst, const float* src, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void bps_sum_f64(double* dst, const double* src, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void bps_sum_i32(int32_t* dst, const int32_t* src, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

void bps_sum_i64(int64_t* dst, const int64_t* src, int64_t n) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

// fp16 (IEEE binary16) software add: convert -> fp32 add -> convert back.
// Mirrors the reference's scalar fallback path (cpu_reducer.h:64-160); on
// x86 with F16C the compiler vectorizes the conversions.
static inline float h2f(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((man & 0x400) == 0) {
        man <<= 1;
        exp--;
      }
      man &= 0x3ff;
      f = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    f = sign | 0x7f800000u | (man << 13);
  } else {
    f = sign | ((exp + 127 - 15) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t f2h(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  uint32_t sign = (f >> 16) & 0x8000;
  int32_t exp = (int32_t)((f >> 23) & 0xff) - 127 + 15;
  uint32_t man = f & 0x7fffff;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t half = man >> shift;
    if ((man >> (shift - 1)) & 1) half++;  // round-to-nearest
    return (uint16_t)(sign | half);
  }
  if (exp >= 0x1f) {
    if (((f >> 23) & 0xff) == 0xff && man) return (uint16_t)(sign | 0x7e00);
    return (uint16_t)(sign | 0x7c00);
  }
  uint16_t out = (uint16_t)(sign | (exp << 10) | (man >> 13));
  if (man & 0x1000) out++;  // round
  return out;
}

// fp32 add whose NaN result does not depend on the operand order the
// compiler picks: a NaN operand propagates quieted, dst's first — what
// x86's addss gives with dst as its first operand, as the JAX package's
// -march=native build of this loop compiles it.  (The sum itself is the
// plain fp32 add; only which of two NaNs survives is pinned.)
static inline float add_dst_nan_first(float a, float b) {
  if (a != a || b != b) {
    uint32_t u;
    std::memcpy(&u, (a != a) ? &a : &b, 4);
    u |= 0x00400000u;  // quiet
    float out;
    std::memcpy(&out, &u, 4);
    return out;
  }
  return a + b;
}

void bps_sum_f16(uint16_t* dst, const uint16_t* src, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    dst[i] = f2h(add_dst_nan_first(h2f(dst[i]), h2f(src[i])));
}

// bf16: truncation-round add via fp32.
void bps_sum_bf16(uint16_t* dst, const uint16_t* src, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t a = (uint32_t)dst[i] << 16, b = (uint32_t)src[i] << 16;
    float fa, fb;
    std::memcpy(&fa, &a, 4);
    std::memcpy(&fb, &b, 4);
    float s = add_dst_nan_first(fa, fb);
    uint32_t u;
    std::memcpy(&u, &s, 4);
    // round-to-nearest-even on the dropped 16 bits
    uint32_t rounded = u + 0x7fff + ((u >> 16) & 1);
    dst[i] = (uint16_t)(rounded >> 16);
  }
}

// ------------------------------------------------------- key -> shard hash

// Reference server-sharding hash (global.cc:305-334): mixes the declared
// key's high and low halves; used to spread bucket ownership across async-PS
// store shards (one per host in multi-host mode).
int64_t bps_key_to_shard(uint64_t key, int64_t num_shards) {
  if (num_shards <= 0) return 0;
  uint64_t mixed = ((key >> 16) + (key % 65536)) * 9973ULL;
  return (int64_t)(mixed % (uint64_t)num_shards);
}

int bps_omp_max_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

int bps_abi_version() { return 1; }

}  // extern "C"
