// Weight gradient of a 3x3 / stride-1 / SAME convolution (kernel K5) for
// Hopper, sm_90a.
//
// Replaces: distributedpytorch_tpu/ops/conv.py::_dw_kernel, launched by
// conv3x3_dw and used by conv3x3_same / Conv3x3 (SmallCNN with
// pallas_dw=True).  Same function:
//
//   dW[kh, kw, ci, co] = sum_{b, h, w} x_pad[b, h + kh, w + kw, ci]
//                                      * dy[b, h, w, co]
//
// with every product and sum in f32, written as the (9 * Ci, Co) f32 matrix
// whose row kh * 3 * Ci + kw * Ci + ci is HWIO's (kh, kw, ci).
//
// What differs from the TPU kernel:
//   * The TPU grid runs in order and sums its batch chunks into one
//     revisited output block.  Here blocks run in parallel, and the output
//     is tiny (9 * Ci * Co <= 36,864 floats on the cnn), so the parallelism
//     comes from splitting the long B*H*W contraction: each block sums the
//     rows of its split s into an f32 partial of its output tile, written
//     to a workspace; a second kernel adds the partials in split order.  No
//     atomics: the same inputs give the same bits on every run.  The number
//     of splits is a function of the shapes only (the wrapper picks it).
//   * The TPU wrapper pads x in device memory (jnp.pad).  Here nothing is
//     padded: the loaders write 0 for the taps that fall off the border.
//   * x and dy are read through their (b, h, w) strides with a unit channel
//     stride, so a channels_last NCHW tensor's NHWC view needs no copy.
//
// What bounds it on the H100: at the cnn's shapes (batch 64, bf16) x and dy
// are read once, 6.4 MB at Conv_1 (1.9 us at 3.35 TB/s), against 0.93
// GFLOP (0.94 us at the 989 TFLOP/s bf16 tensor-core peak): bytes bound
// the work, 3.67 us for the three convs of a cnn step.
//
// Two routes, chosen by the wrapper (ops/conv.py::tensor_core_route):
//
// 1. bf16 or float16 (the cnn under --precision f16) with Ci and Co multiples
//    of 8, 16-byte-aligned x and dy and (b, h, w) strides that are multiples
//    of 8 -- the cnn's main path -- runs conv_dw_mma_kernel<T, TM, TN> on the
//    tensor cores (mma16.cuh's building blocks for either type).  A block owns
//    one tap (kh, kw), a Ci tile and a Co tile (32 or 64 each) and one split.
//    For its tap the block's A operand is x[b, h + kh - 1, w + kw - 1,
//    ci-tile], a plain strided tile whose off-border rows are zero, and its B
//    operand is dy[b, h, w, co-tile]: dW_tap = A^T B over the split's pixels.
//    Both tiles arrive pixel-major with channels contiguous, so both fragments
//    load with ldmatrix .trans, and each smem row is padded by 16 bytes (an
//    80- or 144-byte stride: no bank conflicts).  Chunks of 64 pixels go
//    through two smem stages by 16-byte cp.async.cg copies: chunk k + 1 is in
//    flight while chunk k multiplies.  A copy off the border or past the
//    split's end is the zero-fill form (src-size 0), not a branch.  The pixel
//    -> (b, h, w) decode of a chunk is done once, into shared memory, one
//    chunk ahead.  4 warps, 2 x 2 over the tile, mma.sync.m16n8k16 T x T ->
//    f32.  x and dy are inputs, so float16 rounds nothing more here: every
//    product is exact in f32 and dW is summed in f32, as in bf16.  x is
//    re-read from L2 once per tap (3.2 MB at Conv_1, against 50 MB of L2): one
//    block for all nine taps over a halo strip would read it once from DRAM,
//    at the price of a harder loader (later work).  The tensor core's own f32
//    accumulation rounds differently from an FMA chain, so each chunk's mma
//    sums start from zero and are added into separate f32 registers by
//    ordinary FADDs, as fp8 GEMMs promote their partial sums.
//
// 2. Every other call -- f32, and bf16 or float16 shapes or strides the first
//    route does not take -- runs conv_dw_partial_kernel, scalar FMAs on the
//    f32 CUDA-core pipe (67 TFLOP/s, 14 us for Conv_1 alone): 256 threads own
//    a 64 (patch rows) x 32 (output channels) tile, 2 x 4 accumulators each,
//    and walk their split in chunks of 32 pixels staged in shared memory as
//    f32.  f32 stays here rather than on TF32 tensor cores: TF32 keeps about
//    three decimal digits, and the f32 cnn steps are held to the CPU with TF32
//    off; the main path is bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "mma16.cuh"

namespace {

constexpr int kTM = 64;        // patch rows (tap, ci) per block
constexpr int kTN = 32;        // output channels per block
constexpr int kTK = 32;        // pixels per shared-memory chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ ws, int H, int W, int Ci, int Co,
                       int N, int xs0, int xs1, int xs2, int ys0, int ys1,
                       int ys2, int rows_per_split) {
  __shared__ float as[kTK][kTM];
  __shared__ __align__(16) float bs[kTK][kTN];
  __shared__ int pix_b[kTK];
  __shared__ int pix_h[kTK];
  __shared__ int pix_w[kTK];

  const int tid = threadIdx.x;
  const int M = 9 * Ci;
  const int m0 = blockIdx.y * kTM;
  const int c0 = blockIdx.x * kTN;
  const int split = blockIdx.z;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);

  // The patch row this thread loads is fixed for the whole block.
  const int ar = tid % kTM;
  const int m = m0 + ar;
  const bool m_in = m < M;
  const int tap = m_in ? m / Ci : 0;
  const int ci = m_in ? m - tap * Ci : 0;
  const int dh = tap / 3 - 1;
  const int dw = tap % 3 - 1;
  // ... and so is the dy column.
  const int bc = tid % kTN;
  const int co = c0 + bc;
  const bool co_in = co < Co;

  const int ty = tid / 8;      // accumulator rows 2*ty, 2*ty + 1
  const int tx = tid % 8;      // accumulator cols 4*tx .. 4*tx + 3
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int hw_size = H * W;
  for (int n0 = n_begin; n0 < n_end; n0 += kTK) {
    __syncthreads();  // the previous chunk is no longer read
    if (tid < kTK) {
      const int n = n0 + tid;
      if (n < n_end) {
        const int b = n / hw_size;
        const int hw = n - b * hw_size;
        const int h = hw / W;
        pix_b[tid] = b;
        pix_h[tid] = h;
        pix_w[tid] = hw - h * W;
      } else {
        pix_b[tid] = -1;
      }
    }
    __syncthreads();
    for (int p = tid / kTM; p < kTK; p += kThreads / kTM) {
      float v = 0.f;
      const int b = pix_b[p];
      if (m_in && b >= 0) {
        const int hh = pix_h[p] + dh;
        const int ww = pix_w[p] + dw;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
          v = to_f32(x[(long long)b * xs0 + (long long)hh * xs1 +
                       (long long)ww * xs2 + ci]);
        }
      }
      as[p][ar] = v;
    }
    for (int p = tid / kTN; p < kTK; p += kThreads / kTN) {
      float v = 0.f;
      const int b = pix_b[p];
      if (co_in && b >= 0) {
        v = to_f32(dy[(long long)b * ys0 + (long long)pix_h[p] * ys1 +
                      (long long)pix_w[p] * ys2 + co]);
      }
      bs[p][bc] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
      const float a0 = as[k][2 * ty];
      const float a1 = as[k][2 * ty + 1];
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][4 * tx]);
      acc[0][0] += a0 * bv.x;
      acc[0][1] += a0 * bv.y;
      acc[0][2] += a0 * bv.z;
      acc[0][3] += a0 * bv.w;
      acc[1][0] += a1 * bv.x;
      acc[1][1] += a1 * bv.y;
      acc[1][2] += a1 * bv.z;
      acc[1][3] += a1 * bv.w;
    }
  }

  float* out = ws + (long long)split * M * Co;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mm = m0 + 2 * ty + i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + 4 * tx + j;
      if (cc < Co) out[(long long)mm * Co + cc] = acc[i][j];
    }
  }
}

// out[i] = sum over s = 0, 1, ..., splits - 1 of ws[s][i], in that order.
__global__ void conv_dw_reduce_kernel(const float* __restrict__ ws,
                                      float* __restrict__ out, int count,
                                      int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += ws[(long long)p * count + i];
  out[i] = s;
}

template <typename T>
void launch(const void* x, const void* dy, float* ws, float* out, int B,
            int H, int W, int Ci, int Co, const int* strides,
            int rows_per_split, int splits, cudaStream_t stream) {
  const int M = 9 * Ci;
  const int N = B * H * W;
  float* partial = splits == 1 ? out : ws;
  const dim3 grid((Co + kTN - 1) / kTN, (M + kTM - 1) / kTM, splits);
  conv_dw_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, H, W, Ci,
      Co, N, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], rows_per_split);
  if (splits > 1) {
    const int count = M * Co;
    conv_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(
        ws, out, count, splits);
  }
}


// -- route 1: tensor cores ------------------------------------------------
// (cp.async, ldmatrix .trans and mma.sync for either 16-bit type are
// mma16.cuh's; its block of kMmaThreads = 4 warps goes 2 x 2 over the
// output tile here)

constexpr int kMmaTK = 64;        // pixels per chunk (4 mma k-steps of 16)

// Block (co tile, tap * ci_tiles + ci tile, split).  TM input channels x
// TN output channels of one tap, over the split's pixels.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMmaThreads)
conv_dw_mma_kernel(const T* __restrict__ x,
                   const T* __restrict__ dy,
                   float* __restrict__ ws, int H, int W, int Ci, int Co,
                   int N, int xs0, int xs1, int xs2, int ys0, int ys1,
                   int ys2, int rows_per_split, int ci_tiles) {
  constexpr int WM = TM / 2, WN = TN / 2;  // a warp's sub-tile
  constexpr int MI = WM / 16, NI = WN / 8;  // its m16 and n8 fragments
  constexpr int AP = TM / 8, BP = TN / 8;   // 16-byte pieces per pixel
  static_assert(kMmaTK * AP % kMmaThreads == 0 &&
                    kMmaTK * BP % kMmaThreads == 0 && NI % 2 == 0,
                "tile sizes");
  __shared__ __align__(128) T a_s[2][kMmaTK][TM + kPad];
  __shared__ __align__(128) T b_s[2][kMmaTK][TN + kPad];
  __shared__ int pix_b[2][kMmaTK];
  __shared__ int pix_h[2][kMmaTK];
  __shared__ int pix_w[2][kMmaTK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.x * TN;
  const int tap = blockIdx.y / ci_tiles;
  const int m0 = (blockIdx.y - tap * ci_tiles) * TM;
  const int dh = tap / 3 - 1;
  const int dw = tap % 3 - 1;
  const int split = blockIdx.z;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int chunks = max(0, (n_end - n_begin + kMmaTK - 1) / kMmaTK);
  const int hw_size = H * W;

  // Pixel n_begin + chunk * kMmaTK + i -> (b, h, w) in pix_*[buf][i];
  // b = -1 past the split's end.
  auto decode = [&](int chunk, int buf) {
    if (tid < kMmaTK) {
      const int n = n_begin + chunk * kMmaTK + tid;
      if (n < n_end) {
        const int b = n / hw_size;
        const int hw = n - b * hw_size;
        const int h = hw / W;
        pix_b[buf][tid] = b;
        pix_h[buf][tid] = h;
        pix_w[buf][tid] = hw - h * W;
      } else {
        pix_b[buf][tid] = -1;
      }
    }
  };
  // The chunk decoded in pix_*[buf] into stage buf: the tap-shifted x tile
  // and the dy tile, 16 bytes a copy, zero-filled where out of range.
  auto load = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kMmaTK * AP / kMmaThreads; ++r) {
      const int i = tid + r * kMmaThreads;
      const int p = i / AP;
      const int ci = m0 + (i - p * AP) * 8;
      const int b = pix_b[buf][p];
      const int hh = pix_h[buf][p] + dh;
      const int ww = pix_w[buf][p] + dw;
      const bool ok = b >= 0 && ci < Ci && hh >= 0 && hh < H && ww >= 0 &&
                      ww < W;
      const T* src =
          ok ? x + (long long)b * xs0 + (long long)hh * xs1 +
                   (long long)ww * xs2 + ci
             : x;
      cp_async16(smem_addr(&a_s[buf][p][(i - p * AP) * 8]), src,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int r = 0; r < kMmaTK * BP / kMmaThreads; ++r) {
      const int i = tid + r * kMmaThreads;
      const int p = i / BP;
      const int co = c0 + (i - p * BP) * 8;
      const int b = pix_b[buf][p];
      const bool ok = b >= 0 && co < Co;
      const T* src =
          ok ? dy + (long long)b * ys0 + (long long)pix_h[buf][p] * ys1 +
                   (long long)pix_w[buf][p] * ys2 + co
             : dy;
      cp_async16(smem_addr(&b_s[buf][p][(i - p * BP) * 8]), src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  const int wm = (warp >> 1) * WM;
  const int wn = (warp & 1) * WN;
  // ldmatrix row addresses: lane l points at stored row (pixel) k and
  // column (channel) offset m / n of its 8x8 matrix.
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_m = ((lane >> 3) & 1) * 8;
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = (lane >> 4) * 8;

  // d += this warp's share of stage s's tile product, 4 k-steps of 16.
  auto multiply = [&](int s, float (&d)[MI][NI][4]) {
#pragma unroll
    for (int k0 = 0; k0 < kMmaTK; k0 += 16) {
      unsigned af[MI][4];
      unsigned bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        ldmatrix_x4_trans(af[i],
                          smem_addr(&a_s[s][k0 + a_k][wm + i * 16 + a_m]));
      }
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_addr(&b_s[s][k0 + b_k][wn + j * 8 + b_n]));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma_16816<T>(d[i][j], af[i], bf[j][0], bf[j][1]);
        }
    }
  };

  float acc[MI][NI][4];
  float part[MI][NI][4];  // this chunk's sums
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (chunks > 0) decode(0, 0);
  if (chunks > 1) decode(1, 1);
  __syncthreads();
  if (chunks > 0) load(0);
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    cp_async_wait_all();
    // Chunk c is in shared memory for every thread; every thread is done
    // with chunk c - 1's stage and with the decode that load(c) read.
    __syncthreads();
    if (c + 1 < chunks) load(s ^ 1);
    if (c + 2 < chunks) decode(c + 2, s);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    multiply(s, part);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // Accumulator e of fragment (i, j): row g (+ 8 for e >= 2), columns
  // 2 * (lane % 4) and + 1, g = lane / 4.
  const int M = 9 * Ci;
  float* out = ws + (long long)split * M * Co;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = m0 + wm + i * 16 + (lane >> 2) + half * 8;
      if (ci >= Ci) continue;
      float* row = out + (long long)(tap * Ci + ci) * Co;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int co = c0 + wn + j * 8 + 2 * (lane & 3);
        if (co < Co) {
          *reinterpret_cast<float2*>(row + co) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
    }
  }
}

template <typename T, int TM, int TN>
void launch_mma(const void* x, const void* dy, float* partial, int B, int H,
                int W, int Ci, int Co, const int* strides,
                int rows_per_split, int splits, cudaStream_t stream) {
  const int ci_tiles = (Ci + TM - 1) / TM;
  const dim3 grid((Co + TN - 1) / TN, 9 * ci_tiles, splits);
  conv_dw_mma_kernel<T, TM, TN><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, H, W,
      Ci, Co,
      B * H * W, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], rows_per_split, ci_tiles);
}

template <typename T>
bool launch_mma_tiles(int tile_ci, int tile_co, const void* x,
                      const void* dy, float* partial, int B, int H, int W,
                      int Ci, int Co, const int* strides, int rows_per_split,
                      int splits, cudaStream_t stream) {
#define DPT_MMA_CASE(TM, TN)                                             \
  if (tile_ci == TM && tile_co == TN) {                                  \
    launch_mma<T, TM, TN>(x, dy, partial, B, H, W, Ci, Co, strides,      \
                          rows_per_split, splits, stream);               \
    return true;                                                         \
  }
  DPT_MMA_CASE(32, 32)
  DPT_MMA_CASE(32, 64)
  DPT_MMA_CASE(64, 32)
  DPT_MMA_CASE(64, 64)
#undef DPT_MMA_CASE
  return false;
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
// x is (B, H, W, Ci) and dy (B, H, W, Co), read through strides (in
// elements) {x_b, x_h, x_w, dy_b, dy_h, dy_w}; both channel strides must be
// 1.  out is (9 * Ci, Co) f32.  ws holds splits * 9 * Ci * Co floats (unused
// when splits == 1).  Rows [s * rows_per_split, (s + 1) * rows_per_split) of
// the B*H*W contraction go to split s.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a dtype or split count the kernel does
// not take, without launching).
extern "C" int dpt_conv3x3_dw(const void* x, const void* dy, void* ws,
                              void* out, int B, int H, int W, int Ci, int Co,
                              const int* strides, int rows_per_split,
                              int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 65535 || rows_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* wsf = static_cast<float*>(ws);
  float* outf = static_cast<float*>(out);
  if (dtype == 0) {
    launch<float>(x, dy, wsf, outf, B, H, W, Ci, Co, strides, rows_per_split,
                  splits, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, dy, wsf, outf, B, H, W, Ci, Co, strides,
                          rows_per_split, splits, st);
  } else if (dtype == 2) {
    launch<__half>(x, dy, wsf, outf, B, H, W, Ci, Co, strides,
                   rows_per_split, splits, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Route 1, bf16 (dtype 1) or float16 (dtype 2) on the tensor cores: the
// same arguments and layout as dpt_conv3x3_dw, with tile_ci, tile_co in
// {32, 64} the block's channel tile.  Refuses (cudaErrorInvalidValue,
// nothing launched) another dtype, Ci or Co not a multiple of 8, x or dy
// not 16-byte aligned, a stride not a multiple of 8, a tile or a split
// count it does not take.
extern "C" int dpt_conv3x3_dw_mma(const void* x, const void* dy, void* ws,
                                  void* out, int B, int H, int W, int Ci,
                                  int Co, const int* strides,
                                  int rows_per_split, int splits,
                                  int tile_ci, int tile_co, int dtype,
                                  void* stream) {
  bool ok = (dtype == 1 || dtype == 2) && splits >= 1 && splits <= 65535 &&
            rows_per_split >= 1 &&
            Ci % 8 == 0 && Co % 8 == 0 &&
            reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
            reinterpret_cast<unsigned long long>(dy) % 16 == 0;
  for (int i = 0; i < 6; ++i) ok = ok && strides[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(splits == 1 ? out : ws);
  const bool launched =
      dtype == 1 ? launch_mma_tiles<bf16>(tile_ci, tile_co, x, dy, partial, B,
                                          H, W, Ci, Co, strides,
                                          rows_per_split, splits, st)
                 : launch_mma_tiles<f16>(tile_ci, tile_co, x, dy, partial, B,
                                         H, W, Ci, Co, strides,
                                         rows_per_split, splits, st);
  if (!launched) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const int count = 9 * Ci * Co;
    conv_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), count,
        splits);
  }
  return static_cast<int>(cudaGetLastError());
}
