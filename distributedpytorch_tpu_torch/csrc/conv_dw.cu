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
//     comes from splitting the long B*H*W contraction: block (j, i, s) sums
//     the rows of split s into an f32 partial of output tile (i, j), written
//     to a workspace; a second kernel adds the partials in split order.  No
//     atomics: the same inputs give the same bits on every run.  The number
//     of splits is a function of the shapes only (the wrapper picks it).
//   * The TPU wrapper pads x in device memory (jnp.pad).  Here nothing is
//     padded: the loader builds the patch tile in shared memory from the
//     raw activations and writes 0 for the taps that fall off the border.
//   * x and dy are read through their (b, h, w) strides with a unit channel
//     stride, so a channels_last NCHW tensor's NHWC view needs no copy.
//
// Block: 256 threads own a 64 (patch rows) x 32 (output channels) tile,
// 2 x 4 accumulators each, and walk their split in chunks of 32 pixels:
// the chunk's patch tile (32 x 64) and dy tile (32 x 32) are staged in
// shared memory as f32, then every thread does 32 x 8 FMAs.  Scalar FMA on
// CUDA cores, no tensor cores: a simple kernel that is right
// (mma.sync / wgmma and TMA are later work).
//
// Bound on the H100 at the cnn's shapes (batch 64, bf16): x and dy are read
// once, 6.4 MB at Conv_1 (1.9 us at 3.35 TB/s), against 0.93 GFLOP (0.94 us
// at the 989 TFLOP/s bf16 tensor-core peak): bytes bound the work.  This
// kernel runs on the f32 CUDA-core pipe (67 TFLOP/s), which alone takes
// 14 us for Conv_1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTM = 64;        // patch rows (tap, ci) per block
constexpr int kTN = 32;        // output channels per block
constexpr int kTK = 32;        // pixels per shared-memory chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
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
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
