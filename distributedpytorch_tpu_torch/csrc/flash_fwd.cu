// Flash-attention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces: distributedpytorch_tpu/ops/flash_attention.py::_fwd_kernel
// (use_pos=False), launched by _flash_fwd and wrapped by _flash and
// flash_attention.  Same function: O = softmax(Q K^T / sqrt(D), masked) V
// with an online softmax over key tiles, plus the per-row log-sum-exp.
//
// Numerics kept from the TPU kernel: q is scaled by 1/sqrt(D) in f32 before
// the product; masked scores take the finite sentinel -1e30 and their p is
// forced to 0; l is clamped at 1e-30 before the division; every sum is f32;
// O is cast to the input dtype.  lse is stored as (B*H, S) f32 (the TPU
// kernel's (bh, s, 8) lane broadcast was a Mosaic layout artifact).
//
// Not carried over from the TPU kernel: the wrapper's moveaxis to (B*H, S, D)
// and the pad of S to a multiple of 128.  This kernel reads q, k and v in
// their (B, S, H, D) layout through strides (so the qkv split of the vit
// needs no copy) and masks the ragged tail of S itself.  The TPU kernel kept
// all of K and V for one head in VMEM; here one thread block takes one
// (b*h, 64-row q tile) and streams K/V tiles of KT keys through shared
// memory (KT = 64, or 32 at D = 128 so two f32 tiles stay under 48 KB).
//
// Thread layout: 256 threads, 4 per query row.  Thread g of a row owns the
// dims d = g, g+4, g+8, ... of q and of the f32 accumulator (registers);
// a score is a partial dot product over those dims reduced across the 4
// lanes with two xor shuffles.  The running max m and sum l live in
// registers, the scores of one tile too (KT floats).  Scalar FMA, no
// tensor cores: a simple kernel that is right (wgmma and TMA are later
// work).
//
// Bound on the H100: at the vit shapes (S = 49, D = 32, B*H = 4 * bucket)
// the kernel moves q, k, v and o once (4 * B*S*H*D * 2 bytes in bf16, about
// 3.2 MB at bucket 64, ~1 us at 3.35 TB/s) against 4*B*H*S*S*D operations
// (~79 MFLOP, ~0.08 us at the bf16 tensor-core peak): bytes bound the
// work, and at these sizes launch latency bounds the kernel in practice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 64;          // query rows per thread block
constexpr int kLanes = 4;          // threads per query row
constexpr int kThreads = kRows * kLanes;
constexpr float kNeg = -1e30f;     // finite masked-score sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

template <typename T, int D, int KT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, float scale, int causal) {
  constexpr int DPT = D / kLanes;  // dims owned by one thread
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];

  const int tid = threadIdx.x;
  const int g = tid % kLanes;
  const int row = blockIdx.x * kRows + tid / kLanes;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const long long q_base = (long long)b * q_sb + (long long)h * q_sh;
  const long long k_base = (long long)b * k_sb + (long long)h * k_sh;
  const long long v_base = (long long)b * v_sb + (long long)h * v_sh;

  float qr[DPT];
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row < S
        ? to_f32(q[q_base + (long long)row * q_ss + g + kLanes * i]) * scale
        : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg;
  float l = 0.f;

  int n_tiles = (S + KT - 1) / KT;
  if (causal) {
    // tiles wholly above the diagonal of this block's last row add nothing
    const int last = min((int)(blockIdx.x + 1) * kRows, S);
    n_tiles = min(n_tiles, (last + KT - 1) / KT);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * KT;
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < KT * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      const int kj = kv0 + j;
      const bool in = kj < S;
      ks[j][d] = in ? to_f32(k[k_base + (long long)kj * k_ss + d]) : 0.f;
      vs[j][d] = in ? to_f32(v[v_base + (long long)kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[KT];
    float m_blk = kNeg;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][g + kLanes * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = kv0 + j;
      const bool valid = kj < S && (!causal || kj <= row);
      s[j] = valid ? part : kNeg;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int kj = kv0 + j;
      const bool valid = kj < S && (!causal || kj <= row);
      s[j] = valid ? expf(s[j] - m_new) : 0.f;
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) pv += s[j] * vs[j][g + kLanes * i];
      acc[i] = acc[i] * alpha + pv;
    }
    m = m_new;
  }

  if (row < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* out = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(out + g + kLanes * i, acc[i] / l_safe);
    if (g == 0) lse[(long long)bh * S + row] = m + logf(l_safe);
  }
}

template <typename T, int D, int KT>
void launch(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int S, int H, int q_sb, int q_ss, int q_sh, int k_sb,
            int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, float scale,
            int causal, cudaStream_t stream) {
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<T, D, KT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
      causal);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int D, int q_sb, int q_ss,
               int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
               int v_sh, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      launch<T, 32, 64>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
      return 0;
    case 64:
      launch<T, 64, 64>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
      return 0;
    case 128:
      launch<T, 128, 32>(q, k, v, o, lse, B, S, H, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal, stream);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Strides are in elements; the last dim of q, k and v must be contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// head dim or dtype the kernel does not take, without launching).
extern "C" int dpt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                             int k_sh, int v_sb, int v_ss, int v_sh,
                             float scale, int causal, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int bad;
  if (dtype == 0) {
    bad = dispatch_d<float>(q, k, v, o, lse, B, S, H, D, q_sb, q_ss, q_sh,
                            k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                            st);
  } else if (dtype == 1) {
    bad = dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, D, q_sb, q_ss,
                                    q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                    scale, causal, st);
  } else {
    bad = 1;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
