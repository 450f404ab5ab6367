// Building blocks shared by the tensor-core kernels for Hopper (sm_90a):
// csrc/flash_fwd.cu (K1, K4), csrc/flash_bwd.cu (K2, K3, K2p, K3p) and
// csrc/conv_dw.cu (K5) include this file.  The (B, S, H, D) strides and the
// positional mask, and the pieces of the tensor-core routes, each for either
// 16-bit input type T (__nv_bfloat16 or __half): 16-byte and 4-byte cp.async
// with zero-fill, ldmatrix (and .trans), mma.sync.m16n8k16 T x T -> f32, the
// accumulator -> A-fragment repack (round to nearest even; in float16 a value
// past 65504 becomes +-inf, never a saturated 65504), the padded row loader,
// the lane -> ldmatrix row maps and the position loader.  ldmatrix and
// cp.async move 16-bit elements whatever they hold, so only the mma
// instruction, the packing and the widening differ between the two types. A
// tensor-core block is 4 warps of 16 rows; a streamed tile is 64 rows of D + 8
// elements (the padding keeps ldmatrix free of bank conflicts).
//
// ops/build.py hashes every header under csrc/ into each library's name,
// so an edit here rebuilds every kernel file.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

namespace {

struct Strides {  // element strides of a (B, S, H, D) tensor; D is unit
  int b, s, h;
};

struct Pos {  // K4/K2p/K3p: (S,) int32 global positions, ragged limit
  const int* q;
  const int* k;
  int kv_valid;
};

__device__ __forceinline__ bool pos_mask(int qp, int kp, int causal,
                                         int kv_valid) {
  return (!causal || qp >= kp) && kp < kv_valid;
}

__device__ __forceinline__ long long offset(const Strides& st, int b, int s,
                                            int h) {
  return (long long)b * st.b + (long long)s * st.s + (long long)h * st.h;
}

constexpr int kMmaThreads = 128;  // 4 warps, 16 of the block's rows each
constexpr int kMmaRows = 64;      // rows a block owns
constexpr int kMmaTile = 64;      // rows of a streamed tile (4 steps of 16)
constexpr int kPad = 8;           // elements of padding per shared row

using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename T>
constexpr bool kIsHalf = std::is_same<T, f16>::value;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads
// nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices, each stored as 8 rows of 8 contiguous elements
// (row addresses from lanes 8j..8j+7 for matrix j): lane l gets elements
// 2(l%4), 2(l%4)+1 of stored row l/4.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed on the way in: lane l gets stored rows 2(l%4),
// 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), T in, f32 accumulate.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  if constexpr (kIsHalf<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats as one register of two T (round to nearest even; float16
// overflows to +-inf), the first in the low half: the lower column of an
// mma fragment.
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

// The pair type of T (__nv_bfloat162 or __half2), and a pair widened
// exactly to f32 (low half first).
template <typename T>
using Pair = typename std::conditional<kIsHalf<T>, __half2,
                                       __nv_bfloat162>::type;
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 widen2(__half2 v) {
  return __half22float2(v);
}

// Two floats stored as two T at p (4-byte aligned), as pack2 rounds them.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack2<T>(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Accumulator e of an m16n8 fragment: row g (+ 8 for e >= 2), column
// 2 * (lane % 4) + (e & 1) of the n8 tile, g = lane / 4.  The two n8 tiles
// of 16 columns, times mul and rounded to T, are the A fragment of one k16
// step over those columns.
template <typename T>
__device__ __forceinline__ void to_a_fragment(unsigned (&a)[4],
                                              const float (&c)[2][4],
                                              float mul = 1.f) {
  a[0] = pack2<T>(c[0][0] * mul, c[0][1] * mul);
  a[1] = pack2<T>(c[0][2] * mul, c[0][3] * mul);
  a[2] = pack2<T>(c[1][0] * mul, c[1][1] * mul);
  a[3] = pack2<T>(c[1][2] * mul, c[1][3] * mul);
}

// Float16's range for dS, the one product operand that is neither an input
// nor bounded by 1 (p is): the power of two 2^e, e >= 0, that brings the
// largest finite |value| of a warp's 16 x 16 block below 2^15, and 0 where
// it already is or for bfloat16 (f32's exponent range).  The caller rounds
// the block times 2^-e, multiplies into zeroed accumulators and adds them
// times 2^e (both exact powers of two), so a dS of up to f32's range
// reaches the f32 sums as the f32 reference holds it, and an output
// overflows only where its own f32 value does.  Warp-uniform.
template <typename T>
__device__ __forceinline__ int range_shift(const float (&c)[2][4]) {
  if constexpr (!kIsHalf<T>) {
    return 0;
  } else {
    float m = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fabsf(c[n][e]);
        // the largest finite |value|: inf and NaN pass through as they are
        m = fmaxf(m, x <= 3.40282347e38f ? x : 0.f);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    return m >= 32768.f ? ilogbf(m) - 14 : 0;
  }
}

// acc += A B on the tensor cores, A the T-rounded fragment of c (dS) and
// mul(d, a) the caller's products of fragment a into accumulators d, with
// range_shift's scaling in float16: a block past 2^15 goes in at 2^-e
// into zeroed sums that are added to acc at 2^e.  bfloat16 takes c as it
// is.
template <typename T, int N, typename F>
__device__ __forceinline__ void mma_ranged(float (&acc)[N][4],
                                           const float (&c)[2][4], F&& mul) {
  unsigned a[4];
  if constexpr (kIsHalf<T>) {
    const int e = range_shift<T>(c);
    if (e != 0) {  // warp-uniform
      to_a_fragment<T>(a, c, ldexpf(1.f, -e));
      float part[N][4];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.f;
      mul(part, a);
      const float up = ldexpf(1.f, e);
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i] * up;
      return;
    }
  }
  to_a_fragment<T>(a, c);
  mul(acc, a);
}

// Rows [r0, r0 + kMmaTile) of a (B, S, H, D) 16-bit tensor at (b, h) into
// a shared tile, 16 bytes a copy, rows at or past S zero-filled.  Every
// thread of the block takes part; the caller commits.
template <int D, typename T>
__device__ __forceinline__ void load_rows(T (*tile)[D + kPad],
                                          const T* __restrict__ src,
                                          const Strides& st, int b, int h,
                                          int r0, int S) {
  constexpr int CH = D / 8;  // 16-byte pieces a row
  static_assert(kMmaTile * CH % kMmaThreads == 0, "tile size");
#pragma unroll
  for (int n = 0; n < kMmaTile * CH / kMmaThreads; ++n) {
    const int i = threadIdx.x + n * kMmaThreads;
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async16(smem_addr(&tile[r][c]),
               ok ? src + offset(st, b, row, h) + c : src, ok ? 16 : 0);
  }
}

// Lane l's ldmatrix row address inside a 16 x 16 block: matrix j = l / 8
// at stored row (j % 2) * 8 and column (j / 2) * 8 (the A fragment's
// order, and that of a .trans B pair over 16 k rows), or at stored row
// (j / 2) * 8 and column (j % 2) * 8 (a B pair of two n8 tiles stored n
// rows by k columns).
__device__ __forceinline__ int frag_a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int frag_a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int frag_b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_b_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// Positions [r0, r0 + kMmaTile) of an (S,) int32 vector into shared
// memory, 4 bytes a copy by the block's first kMmaTile threads, zeros past
// S.  The caller commits.
__device__ __forceinline__ void load_pos(int* dst, const int* __restrict__ src,
                                         int r0, int S) {
  const int i = threadIdx.x;
  if (i < kMmaTile) {
    const bool ok = r0 + i < S;
    cp_async4(smem_addr(dst + i), ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

}  // namespace
