// Flash-attention backward (kernels K2, K3, K2p and K3p) for Hopper,
// sm_90a.
//
// K2 replaces distributedpytorch_tpu/ops/flash_attention.py::_dq_kernel and
// K3 replaces ::_dkv_kernel (use_pos=False), both launched by
// _flash_bwd_impl, the backward of the jax.custom_vjp around _flash.  Same
// functions, with p = exp(s - lse) recomputed from K1's log-sum-exp and
// delta = rowsum(dO * O) computed by the wrapper:
//   K2: dq = scale * sum_k [p * (dO V^T - delta)] K
//   K3: dv = sum_q p^T dO,   dk = scale * sum_q [p * (dO V^T - delta)]^T Q
//
// K2p and K3p replace the same two TPU kernels with use_pos=True, launched
// by _flash_partial_bwd, the backward of flash_attention_partial (K4, one
// call per ring step).  They are K2 and K3 with kPos set:
//   - the mask comes from global positions, (!causal || q_pos >= k_pos) &&
//     k_pos < kv_valid, with no causal early stop and no tile-index start
//     (positions rotate with the ring's K/V blocks);
//   - dO is the cotangent of K4's f32 O, so it is read as f32;
//   - delta arrives as rowsum(dO * O) - dlse, the lse cotangent folded in
//     by the wrapper (a torch op, as the JAX package computes it outside
//     its kernels): d lse / d s_j = p_j, so the kernels run unchanged;
//   - as in the TPU _dkv_kernel, p is not masked again before dv: a masked
//     entry has p = exp(-1e30 - lse).  That is 0 wherever the row has a
//     key, and 1 in a row whose keys are all masked, where K4 stored
//     lse = -1e30.  Such a row's O is 0 and its lse is -1e30, so in the
//     ring its merge weight exp(-1e30 - lse_merged) is 0 and so is every
//     cotangent it receives (dO = 0, dlse = 0): its p of 1 meets dO = 0
//     and adds exactly 0 to dv, and ds is masked to 0.  Called alone with
//     a nonzero dO, such a row adds its dO to dv of every masked key, as
//     the TPU kernel does.
//
// Numerics kept from the TPU kernels: q is NOT pre-scaled (the score is
// (q . k) * scale, as the TPU backward computes it, while the forward
// scales q first); masked scores behave as the -1e30 sentinel (p and ds
// are forced to 0 there); every product is summed in f32 from inputs
// widened exactly to f32; dq and dk are scaled once at the end; outputs are
// cast to the input dtype with round-to-nearest-even.
//
// Not carried over: the wrapper's moveaxis to (B*H, S, D) and the pad of S
// to a multiple of 128.  q, k, v and dO are read in their (B, S, H, D)
// layout through strides (the head dim must be contiguous); lse and delta
// are (B*H, S) f32; dq, dk, dv are written contiguous (B, S, H, D).  The
// ragged tail of S is masked here: rows and keys at or past S read zeros,
// contribute nothing, never read lse or delta out of bounds and are never
// written.
//
// Design.  As in K1, one thread block of 256 threads takes 64 rows, four
// threads per row; thread g of a row owns the dims d = g, g+4, ... of its
// row's vectors and f32 accumulators in registers, and a dot product over
// D is a partial sum reduced across the 4 lanes with two xor shuffles.
//   K2: a block owns 64 query rows (q, dO, lse, delta in registers) and
//       streams K/V tiles of KT keys through shared memory; it stops at the
//       causal diagonal.
//   K3: a block owns 64 key rows (k, v in registers) and streams Q/dO tiles
//       of QT rows (plus their lse and delta) through shared memory,
//       starting at the q tile that holds the block's first key when
//       causal (the TPU kernel's start_qb).
// Each block writes only its own rows, so there are no atomics and the
// result is the same on every run.  KT = QT = 64, or 32 at D = 128, so two
// f32 tiles stay under 48 KB of static shared memory.  Scalar FMA, no
// tensor cores: a simple kernel that is right first (wgmma, TMA and folding
// delta into K2 are later work).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense) at the vit's
// training shape (B, S, H, D) = (64, 49, 4, 32) bf16, each input read once
// and each output written once:
//   K2 reads q, k, v, dO (4 x 0.80 MB) and lse, delta (2 x 0.05 MB) and
//      writes dq (0.80 MB): 4.1 MB, 1.2 us; 3 products of 2*B*H*S*S*D
//      operations, 118 MFLOP, 0.12 us.  Bytes bound it.
//   K3 reads the same 3.3 MB and writes dk and dv (1.6 MB): 4.9 MB,
//      1.5 us; 4 products, 157 MFLOP, 0.16 us.  Bytes bound it.
// At these sizes launch latency bounds both in practice.  K2p and K3p at
// the vit's ring shard (128, 25, 4, 32) bf16 with an f32 dO: K2p reads
// q, k, v (3 x 0.82 MB), dO (1.6 MB), lse, delta and positions and writes
// dq (0.82 MB), 5.0 MB, 1.5 us; K3p writes dk and dv, 5.8 MB, 1.7 us;
// 61 and 82 MFLOP, 0.06-0.08 us.  Bytes bound them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int kRows = 64;          // rows (queries or keys) per thread block
constexpr int kLanes = 4;          // threads per row
constexpr int kThreads = kRows * kLanes;
constexpr float kNeg = -1e30f;     // finite masked-score sentinel

struct Strides {  // element strides of a (B, S, H, D) tensor; D is unit
  int b, s, h;
};

struct Pos {  // K2p/K3p: (S,) int32 global positions and the ragged limit
  const int* q;
  const int* k;
  int kv_valid;
};

__device__ __forceinline__ bool pos_mask(int qp, int kp, int causal,
                                         int kv_valid) {
  return (!causal || qp >= kp) && kp < kv_valid;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Sum of one row's partial dot product over its kLanes threads.
__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ long long offset(const Strides& st, int b, int s,
                                            int h) {
  return (long long)b * st.b + (long long)s * st.s + (long long)h * st.h;
}

// K2 (kPos false) and K2p (kPos true, dO of type TO = float): one block
// per (64-row q tile, b*h).
template <typename T, typename TO, int D, int KT, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const TO* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int H, Strides qs, Strides ks, Strides vs, Strides os,
                Pos pos, float scale, int causal) {
  constexpr int DPT = D / kLanes;  // dims owned by one thread
  __shared__ float k_t[KT][D];
  __shared__ float v_t[KT][D];
  __shared__ int kp_t[kPos ? KT : 1];  // the tile's key positions (K2p)

  const int tid = threadIdx.x;
  const int g = tid % kLanes;
  const int row = blockIdx.x * kRows + tid / kLanes;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bool row_in = row < S;

  float qr[DPT], dor[DPT], acc[DPT];
  const long long q_at = offset(qs, b, row, h);
  const long long o_at = offset(os, b, row, h);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = row_in ? to_f32(q[q_at + g + kLanes * i]) : 0.f;
    dor[i] = row_in ? to_f32(dout[o_at + g + kLanes * i]) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = row_in ? lse[(long long)bh * S + row] : 0.f;
  const float delta_r = row_in ? delta[(long long)bh * S + row] : 0.f;
  const int qp = kPos && row_in ? pos.q[row] : 0;

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
      k_t[j][d] = in ? to_f32(k[offset(ks, b, kj, h) + d]) : 0.f;
      v_t[j][d] = in ? to_f32(v[offset(vs, b, kj, h) + d]) : 0.f;
    }
    if constexpr (kPos) {
      for (int j = tid; j < KT; j += kThreads) {
        kp_t[j] = kv0 + j < S ? pos.k[kv0 + j] : 0;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        sc += qr[i] * k_t[j][g + kLanes * i];
        dp += dor[i] * v_t[j][g + kLanes * i];
      }
      sc = lane_sum(sc);
      dp = lane_sum(dp);
      const int kj = kv0 + j;
      bool valid = row_in && kj < S;
      if constexpr (kPos) {
        valid = valid && pos_mask(qp, kp_t[j], causal, pos.kv_valid);
      } else {
        valid = valid && (!causal || kj <= row);
      }
      // K2p: a masked p only ever meets the ds mask, so 0 is the same
      const float p = valid ? expf(sc * scale - lse_r) : 0.f;
      const float ds = valid ? p * (dp - delta_r) : 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += ds * k_t[j][g + kLanes * i];
    }
  }

  if (row_in) {
    T* out = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(out + g + kLanes * i, acc[i] * scale);
  }
}

// K3 (kPos false) and K3p (kPos true, dO of type TO = float): one block
// per (64-row k tile, b*h).
template <typename T, typename TO, int D, int QT, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const TO* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H, Strides qs, Strides ks,
                 Strides vs, Strides os, Pos pos, float scale, int causal) {
  constexpr int DPT = D / kLanes;
  __shared__ float q_t[QT][D];
  __shared__ float do_t[QT][D];
  __shared__ float lse_t[QT];
  __shared__ float delta_t[QT];
  __shared__ int qp_t[kPos ? QT : 1];  // the tile's query positions (K3p)

  const int tid = threadIdx.x;
  const int g = tid % kLanes;
  const int col = blockIdx.x * kRows + tid / kLanes;  // this thread's key
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const bool col_in = col < S;

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
  const long long k_at = offset(ks, b, col, h);
  const long long v_at = offset(vs, b, col, h);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = col_in ? to_f32(k[k_at + g + kLanes * i]) : 0.f;
    vr[i] = col_in ? to_f32(v[v_at + g + kLanes * i]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int kp = kPos && col_in ? pos.k[col] : 0;

  const int n_tiles = (S + QT - 1) / QT;
  // rows before the block's first key are all masked when causal (K3; the
  // positions of K3p say nothing about tile order)
  const int t0 = causal && !kPos ? (int)(blockIdx.x * kRows) / QT : 0;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * QT;
    __syncthreads();
    for (int e = tid; e < QT * D; e += kThreads) {
      const int i = e / D;
      const int d = e % D;
      const int qi = q0 + i;
      const bool in = qi < S;
      q_t[i][d] = in ? to_f32(q[offset(qs, b, qi, h) + d]) : 0.f;
      do_t[i][d] = in ? to_f32(dout[offset(os, b, qi, h) + d]) : 0.f;
    }
    for (int e = tid; e < QT; e += kThreads) {
      const int qi = q0 + e;
      const bool in = qi < S;  // rows past S: never read out of bounds
      lse_t[e] = in ? lse[(long long)bh * S + qi] : 0.f;
      delta_t[e] = in ? delta[(long long)bh * S + qi] : 0.f;
      if constexpr (kPos) qp_t[e] = in ? pos.q[qi] : 0;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < QT; ++i) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int x = 0; x < DPT; ++x) {
        sc += kr[x] * q_t[i][g + kLanes * x];
        dp += vr[x] * do_t[i][g + kLanes * x];
      }
      sc = lane_sum(sc);
      dp = lane_sum(dp);
      const int qi = q0 + i;
      const bool in = col_in && qi < S;
      float p, ds;
      if constexpr (kPos) {
        // p is not masked again before dv, as in the TPU kernel (see the
        // note at the top): a masked score is -1e30 before the exp
        const bool keep = pos_mask(qp_t[i], kp, causal, pos.kv_valid);
        p = in ? expf((keep ? sc * scale : kNeg) - lse_t[i]) : 0.f;
        ds = in && keep ? p * (dp - delta_t[i]) : 0.f;
      } else {
        const bool valid = in && (!causal || col <= qi);
        p = valid ? expf(sc * scale - lse_t[i]) : 0.f;
        ds = valid ? p * (dp - delta_t[i]) : 0.f;
      }
#pragma unroll
      for (int x = 0; x < DPT; ++x) {
        dv_acc[x] += p * do_t[i][g + kLanes * x];
        dk_acc[x] += ds * q_t[i][g + kLanes * x];
      }
    }
  }

  if (col_in) {
    const long long at = (((long long)b * S + col) * H + h) * D;
#pragma unroll
    for (int x = 0; x < DPT; ++x) {
      store(dk + at + g + kLanes * x, dk_acc[x] * scale);
      store(dv + at + g + kLanes * x, dv_acc[x]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq (K2) or dk, dv (K3)
  int B, S, H;
  Strides qs, ks, vs, os;
  Pos pos;  // K2p/K3p only
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, typename TO, int D, int TILE, bool kPos>
void launch_dq(const Args& a) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
  flash_dq_kernel<T, TO, D, TILE, kPos><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TO*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.S, a.H, a.qs, a.ks, a.vs, a.os,
      a.pos, a.scale, a.causal);
}

template <typename T, typename TO, int D, int TILE, bool kPos>
void launch_dkv(const Args& a) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
  flash_dkv_kernel<T, TO, D, TILE, kPos><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const TO*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H,
      a.qs, a.ks, a.vs, a.os, a.pos, a.scale, a.causal);
}

// 0 on a launch, 1 for a head dim or dtype the kernels do not take.  K2/K3
// read dO in the input dtype, K2p/K3p in f32.
template <bool kDq, bool kPos>
int dispatch(const Args& a, int D, int dtype) {
#define DPT_CASE(T, DIM, TILE)                                         \
  if (D == DIM) {                                                      \
    using TO = typename std::conditional<kPos, float, T>::type;        \
    if constexpr (kDq) {                                               \
      launch_dq<T, TO, DIM, TILE, kPos>(a);                            \
    } else {                                                           \
      launch_dkv<T, TO, DIM, TILE, kPos>(a);                           \
    }                                                                  \
    return 0;                                                          \
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

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* out0, void* out1,
               int B, int S, int H, const int* strides, float scale,
               int causal, void* stream, const void* q_pos = nullptr,
               const void* k_pos = nullptr, int kv_valid = 0) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
  a.B = B;
  a.S = S;
  a.H = H;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.pos = {static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
           kv_valid};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  strides: 12 element strides, (batch, seq, head) of q, k,
// v and dO in that order; the head dim of each must be contiguous.  lse and
// delta are (B*H, S) f32.  Outputs are contiguous (B, S, H, D) in the input
// dtype.  Each returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or dtype it does not take, without
// launching).

extern "C" int dpt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S, int H,
                            int D, const int* strides, float scale,
                            int causal, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, B, S, H,
                           strides, scale, causal, stream);
  if (dispatch<true, false>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int H, int D, const int* strides,
                             float scale, int causal, int dtype,
                             void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                           strides, scale, causal, stream);
  if (dispatch<false, false>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2p and K3p: as above with dO in f32 (the cotangent of K4's f32 O),
// delta = rowsum(dO * O) - dlse, and q_pos / k_pos the (S,) int32 global
// positions of K4's call; kv_valid masks keys at positions >= kv_valid
// (INT_MAX for none).

extern "C" int dpt_flash_dq_pos(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* q_pos,
                                const void* k_pos, int kv_valid, void* dq,
                                int B, int S, int H, int D,
                                const int* strides, float scale, int causal,
                                int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, B, S, H,
                           strides, scale, causal, stream, q_pos, k_pos,
                           kv_valid);
  if (dispatch<true, true>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpt_flash_dkv_pos(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_pos,
                                 const void* k_pos, int kv_valid, void* dk,
                                 void* dv, int B, int S, int H, int D,
                                 const int* strides, float scale, int causal,
                                 int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                           strides, scale, causal, stream, q_pos, k_pos,
                           kv_valid);
  if (dispatch<false, true>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
