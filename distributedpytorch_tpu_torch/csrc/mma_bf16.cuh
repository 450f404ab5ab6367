// Building blocks shared by the flash-attention kernels for Hopper
// (sm_90a): csrc/flash_fwd.cu (K1, K4) and csrc/flash_bwd.cu (K2, K3, K2p,
// K3p) include this file.  The (B, S, H, D) strides and the positional
// mask, and the pieces of the tensor-core routes: 16-byte and 4-byte
// cp.async with zero-fill, ldmatrix (and .trans), mma.sync.m16n8k16 bf16 ->
// f32, the accumulator -> A-fragment repack, the padded row loader, the
// lane -> ldmatrix row maps and the position loader.  A tensor-core block
// is 4 warps of 16 rows; a streamed tile is 64 rows of D + 8 bf16 (the
// padding keeps ldmatrix free of bank conflicts).
//
// ops/build.py hashes every header under csrc/ into each library's name,
// so an edit here rebuilds both kernel files.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
constexpr int kPad = 8;           // bf16 of padding per shared-memory row

using bf16 = __nv_bfloat16;

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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one register of two bf16 (round to nearest even), the
// first in the low half: the lower column of an mma fragment.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Accumulator e of an m16n8 fragment: row g (+ 8 for e >= 2), column
// 2 * (lane % 4) + (e & 1) of the n8 tile, g = lane / 4.  The two n8 tiles
// of 16 columns, rounded to bf16, are the A fragment of one k16 step over
// those columns.
__device__ __forceinline__ void to_a_fragment(unsigned (&a)[4],
                                              const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Rows [r0, r0 + kMmaTile) of a (B, S, H, D) bf16 tensor at (b, h) into a
// shared tile, 16 bytes a copy, rows at or past S zero-filled.  Every
// thread of the block takes part; the caller commits.
template <int D>
__device__ __forceinline__ void load_rows(bf16 (*tile)[D + kPad],
                                          const bf16* __restrict__ src,
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
