// Flash-attention forward (kernels K1 and K4) for Hopper, sm_90a.
//
// K1 replaces: distributedpytorch_tpu/ops/flash_attention.py::_fwd_kernel
// (use_pos=False), launched by _flash_fwd and wrapped by _flash and
// flash_attention.  Same function: O = softmax(Q K^T / sqrt(D), masked) V
// with an online softmax over key tiles, plus the per-row log-sum-exp.
//
// K4 replaces the same _fwd_kernel with use_pos=True, launched through
// flash_attention_partial (one call per ring step of _ring_local_flash):
// the K1 code with kPos set.  The mask comes from global positions,
// (!causal || q_pos[row] >= k_pos[key]) && k_pos[key] < kv_valid (the TPU
// kernel's _pos_mask), so a ring step can attend a K/V block that came from
// another rank; there is no causal early stop (positions rotate with the
// blocks, so tile order says nothing about the diagonal); O is written in
// f32 whatever the input dtype, as the caller merges the ring's partials in
// f32.  A row whose keys are all masked keeps m = -1e30 and l = 0: its O is
// 0 and its lse is -1e30 + log(1e-30), which is -1e30 again in f32, as on
// the TPU (the ring's merge then gives that partial the weight 0).
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
// K4 at the vit's ring shard (B, S, H, D) = (128, 25, 4, 32) bf16 reads
// q, k, v (3 x 0.82 MB) and writes the f32 O (1.6 MB) and lse (0.05 MB):
// 4.1 MB, 1.2 us, against 42 MFLOP (0.04 us): bytes bound it too.  Its
// design is K1's; the positions of a key tile sit in shared memory beside
// the tile, one int per key.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

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

// kPos = false: K1 (O in T, causal by index); kPos = true: K4 (O in f32,
// masks from q_pos/k_pos and kv_valid).
template <typename T, typename TO, int D, int KT, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, TO* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, int kv_valid, int S, int H,
                 int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
                 int v_sb, int v_ss, int v_sh, float scale, int causal) {
  constexpr int DPT = D / kLanes;  // dims owned by one thread
  __shared__ float ks[KT][D];
  __shared__ float vs[KT][D];
  __shared__ int kps[kPos ? KT : 1];  // the tile's key positions (K4)

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
  const int qp = kPos && row < S ? q_pos[row] : 0;

  int n_tiles = (S + KT - 1) / KT;
  if (causal && !kPos) {
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
    if constexpr (kPos) {
      for (int j = tid; j < KT; j += kThreads) {
        kps[j] = kv0 + j < S ? k_pos[kv0 + j] : 0;
      }
    }
    __syncthreads();
    // a score counts when its key is in range and the mask keeps it
    auto valid = [&](int j) {
      const int kj = kv0 + j;
      if (kj >= S) return false;
      if constexpr (kPos) {
        return (!causal || qp >= kps[j]) && kps[j] < kv_valid;
      } else {
        return !causal || kj <= row;
      }
    };

    float s[KT];
    float m_blk = kNeg;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part += qr[i] * ks[j][g + kLanes * i];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = valid(j) ? part : kNeg;
      m_blk = fmaxf(m_blk, s[j]);
    }
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      s[j] = valid(j) ? expf(s[j] - m_new) : 0.f;
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
    TO* out = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(out + g + kLanes * i, acc[i] / l_safe);
    if (g == 0) lse[(long long)bh * S + row] = m + logf(l_safe);
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void *o, *lse;
  const int *q_pos, *k_pos;  // K4 only
  int kv_valid;              // K4 only
  int B, S, H;
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, typename TO, int D, int KT, bool kPos>
void launch(const FwdArgs& a) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
  flash_fwd_kernel<T, TO, D, KT, kPos><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<TO*>(a.o),
      static_cast<float*>(a.lse), a.q_pos, a.k_pos, a.kv_valid, a.S, a.H,
      a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb, a.v_ss,
      a.v_sh, a.scale, a.causal);
}

// 0 on a launch, 1 for a head dim or dtype the kernel does not take.  K1
// writes O in the input dtype, K4 in f32.
template <bool kPos>
int dispatch(const FwdArgs& a, int D, int dtype) {
#define DPT_CASE(T, DIM, TILE)                                           \
  if (D == DIM) {                                                        \
    launch<T, typename std::conditional<kPos, float, T>::type, DIM, TILE, \
           kPos>(a);                                                     \
    return 0;                                                            \
  }
  if (dtype == 0) {
    DPT_CASE(float, 32, 64)
    DPT_CASE(float, 64, 64)
    DPT_CASE(float, 128, 32)
  } else if (dtype == 1) {
    DPT_CASE(__nv_bfloat16, 32, 64)
    DPT_CASE(__nv_bfloat16, 64, 64)
    DPT_CASE(__nv_bfloat16, 128, 32)
  }
#undef DPT_CASE
  return 1;
}

FwdArgs make_args(const void* q, const void* k, const void* v, void* o,
                  void* lse, const void* q_pos, const void* k_pos,
                  int kv_valid, int B, int S, int H, int q_sb, int q_ss,
                  int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
                  int v_sh, float scale, int causal, void* stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.kv_valid = kv_valid;
  a.B = B;
  a.S = S;
  a.H = H;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  Strides are in elements; the last dim of q, k and v must be
// contiguous.  O and lse are written contiguous: O (B, S, H, D), lse
// (B*H, S) f32.  Each returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or dtype the kernel does not take,
// without launching).

// K1: O in the input dtype.
extern "C" int dpt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                             int k_sh, int v_sb, int v_ss, int v_sh,
                             float scale, int causal, int dtype,
                             void* stream) {
  const FwdArgs a = make_args(q, k, v, o, lse, nullptr, nullptr, 0, B, S, H,
                              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                              v_sh, scale, causal, stream);
  if (dispatch<false>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: O in f32; q_pos and k_pos are (S,) int32 global positions, kv_valid
// masks keys at positions >= kv_valid (INT_MAX for none).
extern "C" int dpt_flash_fwd_pos(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* q_pos,
                                 const void* k_pos, int kv_valid, int B,
                                 int S, int H, int D, int q_sb, int q_ss,
                                 int q_sh, int k_sb, int k_ss, int k_sh,
                                 int v_sb, int v_ss, int v_sh, float scale,
                                 int causal, int dtype, void* stream) {
  const FwdArgs a = make_args(q, k, v, o, lse, q_pos, k_pos, kv_valid, B, S,
                              H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                              v_ss, v_sh, scale, causal, stream);
  if (dispatch<true>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
