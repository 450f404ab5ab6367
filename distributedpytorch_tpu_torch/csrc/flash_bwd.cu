// Flash-attention backward (kernels K2, K3, K2p and K3p) for Hopper,
// sm_90a.
//
// K2 replaces distributedpytorch_tpu/ops/flash_attention.py::_dq_kernel and
// K3 replaces ::_dkv_kernel (use_pos=False), both launched by
// _flash_bwd_impl, the backward of the jax.custom_vjp around _flash.  Same
// functions, with p = exp(s - lse) recomputed from K1's log-sum-exp:
//   K2: delta = rowsum(dO * O),  dq = scale * sum_k [p * (dO V^T - delta)] K
//   K3: dv = sum_q p^T dO,   dk = scale * sum_q [p * (dO V^T - delta)]^T Q
// The TPU wrapper computes delta outside its kernels.  Here K2 computes it
// for its own rows in f32 from O and dO, uses it, and writes it to a
// (B*H, S) f32 buffer that K3, launched next on the same stream, reads.
//
// K2p and K3p replace the same two TPU kernels with use_pos=True, launched
// by _flash_partial_bwd, the backward of flash_attention_partial (K4, one
// call per ring step).  They are K2 and K3 with kPos set:
//   - the mask comes from global positions, (!causal || q_pos >= k_pos) &&
//     k_pos < kv_valid, with no causal early stop and no tile-index start
//     (positions rotate with the ring's K/V blocks);
//   - dO is the cotangent of K4's f32 O, so K2p reads dO and O as f32;
//   - K2p computes delta = rowsum(dO * O) - dlse for its rows, the lse
//     cotangent folded in as the TPU wrapper folds it outside its kernels
//     (d lse / d s_j = p_j, so the rest runs unchanged; a null dlse is
//     0), and writes it for K3p;
//   - as in the TPU _dkv_kernel, p is not masked again before dv: a masked
//     score is the -1e30 sentinel after the scale, so a masked entry has
//     p = exp(-1e30 - lse).  That is 0 wherever the row has a key, and 1
//     in a row whose keys are all masked, where K4 stored lse = -1e30.
//     Only the ragged tail (row or key >= S) has p = 0.  Such a row's O is
//     0 and its lse is -1e30, so in the ring its merge weight
//     exp(-1e30 - lse_merged) is 0 and so is every cotangent it receives
//     (dO = 0, dlse = 0): its p of 1 meets dO = 0 and adds exactly 0 to
//     dv, and ds is masked to 0.  Called alone with a nonzero dO, such a
//     row adds its dO to dv of every masked key, as the TPU kernel does.
//
// Numerics kept from the TPU kernels: q is NOT pre-scaled (the score is
// (q . k) * scale, as the TPU backward computes it, while the forward
// scales q first); masked scores behave as the -1e30 sentinel (p and ds
// are forced to 0 there, but for K3p's p before dv, above); dq and dk are
// scaled once at the end; outputs are cast to the input dtype with
// round-to-nearest-even (a float16 value past 65504 is +-inf, as the TPU
// kernels' astype gives it).  All four take f32, bf16 and float16 (the
// vit and its ring under --precision f16).
//
// Not carried over: the wrapper's moveaxis to (B*H, S, D) and the pad of S
// to a multiple of 128.  q, k, v, dO and O are read in their (B, S, H, D)
// layout through strides (the head dim must be contiguous); lse and delta
// are (B*H, S) f32; dq, dk, dv are written contiguous (B, S, H, D).  The
// ragged tail of S is masked here: rows and keys at or past S read zeros,
// contribute nothing, never read lse or delta out of bounds and are never
// written.  Each block writes only its own rows, so there are no atomics
// and the result is the same on every run.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense) at the vit's
// training shape (B, S, H, D) = (64, 49, 4, 32) bf16, each input read once
// and each output written once:
//   K2 reads q, k, v, dO, O (5 x 0.80 MB) and lse (0.05 MB) and writes dq
//      (0.80 MB) and delta (0.05 MB): 4.9 MB, 1.47 us; 3 products of
//      2*B*H*S*S*D operations, 118 MFLOP, 0.12 us.  Bytes bound it.
//   K3 reads q, k, v, dO, lse, delta (3.3 MB) and writes dk and dv
//      (1.6 MB): 4.9 MB, 1.47 us; 4 products, 157 MFLOP, 0.16 us.  Bytes
//      bound it.
// At these sizes launch and memory latency bound both in practice: a
// block does one 64-key (or 64-query) tile.  K2p and K3p at the vit's ring
// shard (128, 25, 4, 32) bf16 on the tensor-core route: K2p reads q, k, v
// (3 x 0.82 MB), the f32 dO and O (2 x 1.64 MB), lse, dlse and the
// positions and writes dq, delta and the bf16 dO (0.82 MB): 7.5 MB,
// 2.25 us; K3p reads q, k, v, the bf16 dO, lse, delta and the positions
// and writes dk and dv: 5.0 MB, 1.50 us; the pair, as one function (no
// delta or bf16 dO between them): 8.3 MB, 2.48 us.  61 and 82 MFLOP,
// 0.06-0.08 us.  Bytes bound them.  A block there holds 25 real rows of
// its 64, over B*H = 512 blocks.
//
// Two routes, chosen by the wrapper (ops/flash_attention.py::
// tensor_core_route for K2/K3, ::partial_tensor_core_route for K2p/K3p):
//
// 1. bf16 or float16 at D = 32 or 64 with 16-byte-aligned rows --
//    the vit's main path and the ring's shards -- runs flash_dq_mma_kernel
//    (K2, K2p) and flash_dkv_mma_kernel (K3, K3p) on the tensor cores,
//    mma.sync.m16n8k16 T x T -> f32 (T the input type). A block of 4 warps
//    owns 64 rows, 16 a warp: query rows for K2, key rows for K3.  Its own
//    rows (Q and dO, or K and V) arrive once by 16-byte cp.async and go into A
//    fragments by ldmatrix; the other side (K/V tiles for K2; Q/dO tiles with
//    their lse and delta for K3) streams through two cp.async stages of 64
//    rows, tile t + 1 in flight while tile t multiplies, one barrier a tile.
//    Shared rows are padded by 16 bytes, so ldmatrix is free of bank
//    conflicts.  A warp walks its tile 16 columns at a time:
//      K2: S = Q K^T and dP = dO V^T (K and V rows are already the .col B
//          operand), p = exp(s * scale - lse), ds = p (dp - delta) in f32
//          registers, masked in the accumulator layout; ds rounded to T
//          is the A fragment of dQ += dS K (the C layout of two n8 tiles is
//          the A layout of one k16 step), K through ldmatrix .trans.
//      K3: S^T = K Q^T and dP^T = V dO^T, p^T and ds^T as above with the
//          column's lse and delta, then dV += P^T dO and dK += dS^T Q, Q and
//          dO through ldmatrix .trans.
//    p and ds are rounded to T before the second products, as
//    FlashAttention-2 and SDPA's backward do; every sum is f32.  In
//    float16 that rounding would turn a |ds| past 65504 into inf where the
//    TPU kernel, which holds ds in f32, may still give a finite dq or dk
//    (the loss scale of --precision f16 puts dO near 2^15): a warp whose
//    16 x 16 block of ds reaches 2^15 rounds it times 2^-e instead, into
//    zeroed accumulators that it adds times 2^e (mma16.cuh::range_shift,
//    mma_ranged; both powers of two are exact), so an output overflows
//    only where its f32 value does.  p <= 1 needs no such care, and bf16
//    has f32's exponent range.  K2's
//    delta: two threads a row sum dO * O in f32 from 16-byte loads while
//    the first tiles are in flight.  Causal: K2 stops at the diagonal
//    tile, K3 starts at the block's first key tile, and a warp skips a
//    16-column step that lies wholly above the diagonal.
//    K2p/K3p (kPos) run every tile and every step (positions say nothing
//    of tile order).  Each stage also takes the tile's 64 key positions
//    (K2p) or query positions (K3p) into shared memory by 4-byte cp.async
//    beside its rows; a lane's own two rows' positions sit in registers,
//    and the position mask joins the ragged-tail mask in the accumulator
//    layout.  K2p's dO: the same two threads a row read their f32 dO and
//    O by 16-byte loads, sum delta, round dO to T (nearest even, as
//    torch casts) and store it as 16-byte pieces both into the stage-1
//    tile that ldmatrix turns into dP's A fragments and to a contiguous
//    (B, S, H, D) buffer of T.  Each dO row belongs to one K2p block, so
//    the copy is written once, and K3p streams it through the cp.async
//    stages unchanged (its shared memory stays at K3's, under the 48 KB
//    static limit).  The rounding adds at most 2^-9 (bf16) or 2^-12
//    (float16) relative to each dO element before the products dO V^T and
//    P^T dO; delta sums the f32 dO.  In float16 a dO element past 65504
//    rounds to inf, where the TPU kernel reads the f32 dO: the step's
//    gradients are then not finite and the loss scale skips it.  dS keeps
//    range_shift in K2p and K3p as in K2 and K3.  Rows of K2p's tile past S are zeros, and their lse and delta
//    are 0, so no NaN meets a zero-filled load.
//
// 2. Every other call -- f32, D = 128, views whose rows are not 16-byte
//    aligned -- runs flash_dq_kernel / flash_dkv_kernel, scalar FMAs: one
//    block of 256 threads takes 64 rows, four threads a row; thread g of a
//    row owns the dims d = g, g+4, ... of its row's vectors and f32
//    accumulators in registers, and a dot product over D is a partial sum
//    reduced across the 4 lanes with two xor shuffles.  K2 owns 64 query
//    rows (q, dO, lse, delta in registers; delta summed from dO and O by
//    the same shuffles, less dlse for K2p) and streams K/V tiles of KT
//    keys through shared memory, stopping at the causal diagonal; K3 owns
//    64 key rows and streams Q/dO tiles of QT rows (plus their lse and
//    delta), starting at the q tile that holds the block's first key when
//    causal (the TPU kernel's start_qb).  K2p/K3p read the f32 dO.  KT =
//    QT = 64, or 32 at D = 128, so two f32 tiles stay under 48 KB of
//    static shared memory.  Every product is summed in f32 from inputs
//    widened exactly to f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "mma16.cuh"

namespace {

constexpr int kRows = 64;          // rows (queries or keys) per thread block
constexpr int kLanes = 4;          // threads per row
constexpr int kThreads = kRows * kLanes;
constexpr float kNeg = -1e30f;     // finite masked-score sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch casts
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);  // round to nearest even, +-inf past 65504
}

// Sum of one row's partial dot product over its kLanes threads.
__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// K2 (kPos false) and K2p (kPos true: dO and O of type TO = float, and
// dlse subtracted from delta): one block per (64-row q tile, b*h).  Both
// compute delta from dO and O and write it.
template <typename T, typename TO, int D, int KT, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const TO* __restrict__ dout,
                const TO* __restrict__ o, const float* __restrict__ lse,
                const float* __restrict__ dlse, float* __restrict__ delta,
                T* __restrict__ dq, int S, int H, Strides qs, Strides ks,
                Strides vs, Strides os, Strides oos, Pos pos, float scale,
                int causal) {
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
  const long long out_at = offset(oos, b, row, h);
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    part += row_in ? dor[i] * to_f32(o[out_at + g + kLanes * i]) : 0.f;
  }
  float delta_r = lane_sum(part);
  // K2p: the lse cotangent folds into delta (d lse / d s_j = p_j)
  if (kPos && row_in && dlse != nullptr) {
    delta_r -= dlse[(long long)bh * S + row];
  }
  if (row_in && g == 0) delta[(long long)bh * S + row] = delta_r;
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


// -- route 1: tensor cores ------------------------------------------------
// (the building blocks -- cp.async, ldmatrix, mma.sync, the fragment maps,
// load_rows, load_pos and float16's range for dS -- are in mma16.cuh)

// dO and O as K2 reads them (T, the input type) and as K2p does (f32:
// K4's O and its cotangent).
template <typename T, bool kPos>
using MmaDo = typename std::conditional<kPos, float, T>::type;

// K2 (kPos false) and K2p (kPos true) on the tensor cores: one block per
// (64 query rows, b*h).  Also writes delta = rowsum(dO * O) of its rows,
// less dlse for K2p.  K2p also writes its dO rows rounded to T to
// dout16, contiguous (B, S, H, D): the dO that K3p streams.
template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const MmaDo<T, kPos>* __restrict__ dout,
                    const MmaDo<T, kPos>* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    T* __restrict__ dout16, int S, int H, Strides qs,
                    Strides ks, Strides vs, Strides os, Strides oos, Pos pos,
                    float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;  // k16 steps over D
  constexpr int ND = D / 8;   // n8 tiles over D
  // stage 1 first holds this block's Q (k_s) and dO (v_s) rows
  __shared__ __align__(128) T k_s[2][kMmaTile][LD];
  __shared__ __align__(128) T v_s[2][kMmaTile][LD];
  __shared__ float delta_s[kMmaRows];
  __shared__ __align__(16) int kp_s[kPos ? 2 : 1][kMmaTile];  // K2p

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kMmaRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  int n_tiles = (S + kMmaTile - 1) / kMmaTile;
  if (causal && !kPos) {
    // tiles wholly above the diagonal of this block's last row add nothing
    const int last = min(q0 + kMmaRows, S);
    n_tiles = min(n_tiles, (last + kMmaTile - 1) / kMmaTile);
  }

  load_rows<D>(k_s[1], q, qs, b, h, q0, S);
  if constexpr (!kPos) load_rows<D>(v_s[1], dout, os, b, h, q0, S);
  load_rows<D>(k_s[0], k, ks, b, h, 0, S);
  load_rows<D>(v_s[0], v, vs, b, h, 0, S);
  if constexpr (kPos) load_pos(kp_s[0], pos.k, 0, S);
  cp_async_commit();

  // delta while the copies fly: two threads a row, D / 2 dims each, from
  // 16-byte loads
  {
    const int r = tid >> 1;
    const int row = q0 + r;
    const int d0 = (tid & 1) * (D / 2);
    float part = 0.f;
    if constexpr (kPos) {
      // the f32 dO, rounded to T (nearest even), also goes into the
      // stage-1 tile that ldmatrix turns into dP's A fragments and out to
      // dout16; rows at or past S are zeros in the tile
      T* tile = &v_s[1][r][d0];
      T* out = dout16 + (((long long)b * S + row) * H + h) * D + d0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if (row < S) {
          const float* pd = dout + offset(os, b, row, h) + d0 + c;
          const float* po = o + offset(oos, b, row, h) + d0 + c;
          const float4 da = *reinterpret_cast<const float4*>(pd);
          const float4 db = *reinterpret_cast<const float4*>(pd + 4);
          const float4 oa = *reinterpret_cast<const float4*>(po);
          const float4 ob = *reinterpret_cast<const float4*>(po + 4);
          part += da.x * oa.x;
          part += da.y * oa.y;
          part += da.z * oa.z;
          part += da.w * oa.w;
          part += db.x * ob.x;
          part += db.y * ob.y;
          part += db.z * ob.z;
          part += db.w * ob.w;
          w = make_uint4(pack2<T>(da.x, da.y), pack2<T>(da.z, da.w),
                         pack2<T>(db.x, db.y), pack2<T>(db.z, db.w));
          *reinterpret_cast<uint4*>(out + c) = w;
        }
        *reinterpret_cast<uint4*>(tile + c) = w;
      }
    } else if (row < S) {
      const T* po = o + offset(oos, b, row, h) + d0;
      const T* pd = dout + offset(os, b, row, h) + d0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(po + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(pd + c);
        const auto* o2 = reinterpret_cast<const Pair<T>*>(&ov);
        const auto* d2 = reinterpret_cast<const Pair<T>*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 fo = widen2(o2[j]);
          const float2 fd = widen2(d2[j]);
          part += fd.x * fo.x;
          part += fd.y * fo.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    // K2p: the lse cotangent folds into delta (d lse / d s_j = p_j)
    if (kPos && row < S && dlse != nullptr) {
      part -= dlse[(long long)bh * S + row];
    }
    if ((tid & 1) == 0) {
      delta_s[r] = part;
      if (row < S) delta[(long long)bh * S + row] = part;
    }
  }

  cp_async_wait_all();
  __syncthreads();

  const int wrow = warp * 16;  // the warp's first row in the block
  const int ar = frag_a_row(lane), ac = frag_a_col(lane);
  const int br = frag_b_row(lane), bc = frag_b_col(lane);
  unsigned qf[KS][4], df[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], smem_addr(&k_s[1][wrow + ar][kk * 16 + ac]));
    ldmatrix_x4(df[kk], smem_addr(&v_s[1][wrow + ar][kk * 16 + ac]));
  }
  const int row_lo = q0 + wrow + g;  // this lane's rows: row_lo, + 8
  const float lse_lo = row_lo < S ? lse[(long long)bh * S + row_lo] : 0.f;
  const float lse_hi =
      row_lo + 8 < S ? lse[(long long)bh * S + row_lo + 8] : 0.f;
  const float delta_lo = delta_s[wrow + g];
  const float delta_hi = delta_s[wrow + g + 8];
  // K2p: the global positions of this lane's two rows
  const int qp_lo = kPos && row_lo < S ? pos.q[row_lo] : 0;
  const int qp_hi = kPos && row_lo + 8 < S ? pos.q[row_lo + 8] : 0;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int kv0 = t * kMmaTile;
    if (t > 0) cp_async_wait_all();
    // tile t is in shared memory for every thread; every thread is done
    // with stage s ^ 1 (tile t - 1, or this block's Q and dO)
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_rows<D>(k_s[s ^ 1], k, ks, b, h, kv0 + kMmaTile, S);
      load_rows<D>(v_s[s ^ 1], v, vs, b, h, kv0 + kMmaTile, S);
      if constexpr (kPos) load_pos(kp_s[s ^ 1], pos.k, kv0 + kMmaTile, S);
      cp_async_commit();
    }
#pragma unroll
    for (int c = 0; c < kMmaTile; c += 16) {
      const int col0 = kv0 + c;
      // warp-uniform; K2p's positions say nothing about tile order
      if (!kPos && causal && col0 > q0 + wrow + 15) continue;
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned r[4];
        ldmatrix_x4(r, smem_addr(&k_s[s][c + br][kk * 16 + bc]));
        mma_16816<T>(sc[0], qf[kk], r[0], r[1]);
        mma_16816<T>(sc[1], qf[kk], r[2], r[3]);
        ldmatrix_x4(r, smem_addr(&v_s[s][c + br][kk * 16 + bc]));
        mma_16816<T>(dp[0], df[kk], r[0], r[1]);
        mma_16816<T>(dp[1], df[kk], r[2], r[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_lo + (e >> 1) * 8;
          const int j = c + n * 8 + 2 * t4 + (e & 1);  // key in the tile
          const int col = kv0 + j;
          bool valid = row < S && col < S;
          if constexpr (kPos) {
            // a masked p only ever meets the ds mask, so 0 is the same
            valid = valid && pos_mask(e >> 1 ? qp_hi : qp_lo, kp_s[s][j],
                                      causal, pos.kv_valid);
          } else {
            valid = valid && (!causal || col <= row);
          }
          const float p =
              valid ? expf(sc[n][e] * scale - (e >> 1 ? lse_hi : lse_lo))
                    : 0.f;
          sc[n][e] = valid ? p * (dp[n][e] - (e >> 1 ? delta_hi : delta_lo))
                           : 0.f;
        }
      }
      // dQ += dS K, K through ldmatrix .trans
      mma_ranged<T>(acc, sc, [&](float (&d)[ND][4], const unsigned (&a)[4]) {
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, smem_addr(&k_s[s][c + ar][nd * 8 + ac]));
          mma_16816<T>(d[nd], a, r[0], r[1]);
          mma_16816<T>(d[nd + 1], a, r[2], r[3]);
        }
      });
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + half * 8;
    if (row >= S) continue;
    T* out = dq + (((long long)b * S + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store2(out + nd * 8, acc[nd][2 * half] * scale,
             acc[nd][2 * half + 1] * scale);
    }
  }
}

// K3 (kPos false) and K3p (kPos true, dO the 16-bit copy K2p wrote) on the
// tensor cores: one block per (64 key rows, b*h).
template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, Strides qs,
                     Strides ks, Strides vs, Strides os, Pos pos,
                     float scale, int causal) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  // stage 1 first holds this block's K (q_s) and V (do_s) rows
  __shared__ __align__(128) T q_s[2][kMmaTile][LD];
  __shared__ __align__(128) T do_s[2][kMmaTile][LD];
  __shared__ __align__(16) float lse_s[2][kMmaTile];
  __shared__ __align__(16) float delta_s[2][kMmaTile];
  __shared__ __align__(16) int qp_s[kPos ? 2 : 1][kMmaTile];  // K3p

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kMmaRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const int n_tiles = (S + kMmaTile - 1) / kMmaTile;
  // rows before the block's first key are all masked when causal (K3; the
  // positions of K3p say nothing about tile order)
  const int t0 = causal && !kPos ? k0 / kMmaTile : 0;

  // the Q/dO tile from row r0 into stage buf, with its lse and delta (and
  // K3p's query positions)
  auto load_tile = [&](int buf, int r0) {
    load_rows<D>(q_s[buf], q, qs, b, h, r0, S);
    load_rows<D>(do_s[buf], dout, os, b, h, r0, S);
    static_assert(2 * kMmaTile == kMmaThreads, "one row value a thread");
    const int i = tid & (kMmaTile - 1);
    const int row = r0 + i;
    const bool ok = row < S;
    const float* src = (tid < kMmaTile ? lse : delta) +
                       (ok ? (long long)bh * S + row : 0);
    cp_async4(smem_addr(tid < kMmaTile ? &lse_s[buf][i] : &delta_s[buf][i]),
              src, ok ? 4 : 0);
    if constexpr (kPos) load_pos(qp_s[buf], pos.q, r0, S);
    cp_async_commit();
  };

  load_rows<D>(q_s[1], k, ks, b, h, k0, S);
  load_rows<D>(do_s[1], v, vs, b, h, k0, S);
  load_tile(0, t0 * kMmaTile);
  cp_async_wait_all();
  __syncthreads();

  const int wrow = warp * 16;
  const int ar = frag_a_row(lane), ac = frag_a_col(lane);
  const int br = frag_b_row(lane), bc = frag_b_col(lane);
  unsigned kf[KS][4], vf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(kf[kk], smem_addr(&q_s[1][wrow + ar][kk * 16 + ac]));
    ldmatrix_x4(vf[kk], smem_addr(&do_s[1][wrow + ar][kk * 16 + ac]));
  }
  const int key_lo = k0 + wrow + g;  // this lane's keys: key_lo, + 8
  // K3p: the global positions of this lane's two keys
  const int kp_lo = kPos && key_lo < S ? pos.k[key_lo] : 0;
  const int kp_hi = kPos && key_lo + 8 < S ? pos.k[key_lo + 8] : 0;

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int s = (t - t0) & 1;
    const int r0 = t * kMmaTile;
    if (t > t0) cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(s ^ 1, r0 + kMmaTile);
#pragma unroll
    for (int c = 0; c < kMmaTile; c += 16) {
      // every query of these 16 columns before every key of the warp
      if (!kPos && causal && r0 + c + 15 < k0 + wrow) continue;  // uniform
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned r[4];
        ldmatrix_x4(r, smem_addr(&q_s[s][c + br][kk * 16 + bc]));
        mma_16816<T>(sc[0], kf[kk], r[0], r[1]);
        mma_16816<T>(sc[1], kf[kk], r[2], r[3]);
        ldmatrix_x4(r, smem_addr(&do_s[s][c + br][kk * 16 + bc]));
        mma_16816<T>(dp[0], vf[kk], r[0], r[1]);
        mma_16816<T>(dp[1], vf[kk], r[2], r[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + (e >> 1) * 8;
          const int i = c + n * 8 + 2 * t4 + (e & 1);  // query in the tile
          const int qi = r0 + i;
          const bool in = key < S && qi < S;
          float p, ds;
          if constexpr (kPos) {
            // p is not masked again before dv, as in the TPU kernel (see
            // the note at the top): a masked score is -1e30 after the
            // scale, so p is 1 in a row whose keys are all masked
            const bool keep = pos_mask(qp_s[s][i], e >> 1 ? kp_hi : kp_lo,
                                       causal, pos.kv_valid);
            p = in ? expf((keep ? sc[n][e] * scale : kNeg) - lse_s[s][i])
                   : 0.f;
            ds = in && keep ? p * (dp[n][e] - delta_s[s][i]) : 0.f;
          } else {
            const bool valid = in && (!causal || key <= qi);
            p = valid ? expf(sc[n][e] * scale - lse_s[s][i]) : 0.f;
            ds = valid ? p * (dp[n][e] - delta_s[s][i]) : 0.f;
          }
          sc[n][e] = p;
          dp[n][e] = ds;
        }
      }
      // dV += P^T dO and dK += dS^T Q, dO and Q through ldmatrix .trans
      unsigned pa[4];
      to_a_fragment<T>(pa, sc);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_addr(&do_s[s][c + ar][nd * 8 + ac]));
        mma_16816<T>(dv_acc[nd], pa, r[0], r[1]);
        mma_16816<T>(dv_acc[nd + 1], pa, r[2], r[3]);
      }
      mma_ranged<T>(dk_acc, dp,
                    [&](float (&d)[ND][4], const unsigned (&a)[4]) {
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          unsigned r[4];
          ldmatrix_x4_trans(r, smem_addr(&q_s[s][c + ar][nd * 8 + ac]));
          mma_16816<T>(d[nd], a, r[0], r[1]);
          mma_16816<T>(d[nd + 1], a, r[2], r[3]);
        }
      });
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + half * 8;
    if (key >= S) continue;
    const long long at = (((long long)b * S + key) * H + h) * D + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store2(dk + at + nd * 8, dk_acc[nd][2 * half] * scale,
             dk_acc[nd][2 * half + 1] * scale);
      store2(dv + at + nd * 8, dv_acc[nd][2 * half],
             dv_acc[nd][2 * half + 1]);
    }
  }
}


struct Args {
  const void *q, *k, *v, *dout, *o;
  const float* lse;
  const float* dlse;  // K2p only; null for a zero lse cotangent
  float* delta;       // written by K2 and K2p, read by K3 and K3p
  void *out0, *out1;  // dq (K2, K2p) or dk, dv (K3, K3p)
  void* dout16;       // K2p's tensor-core route: dO rounded to bf16
  int B, S, H;
  Strides qs, ks, vs, os, oos;  // oos: O's, K2 and K2p only
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
      static_cast<const T*>(a.v), static_cast<const TO*>(a.dout),
      static_cast<const TO*>(a.o), a.lse, a.dlse, a.delta,
      static_cast<T*>(a.out0), a.S, a.H, a.qs, a.ks, a.vs, a.os, a.oos,
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
// read dO (and K2 O) in the input dtype, K2p/K3p in f32.
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
  } else if (dtype == 2) {
    DPT_CASE(__half, 32, 64)
    DPT_CASE(__half, 64, 64)
    DPT_CASE(__half, 128, 32)
  }
#undef DPT_CASE
  return 1;
}

template <typename T, int D, bool kPos>
void launch_mma(const Args& a, bool dq) {
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if (dq) {
    using TO = MmaDo<T, kPos>;
    flash_dq_mma_kernel<T, D, kPos><<<grid, kMmaThreads, 0, a.stream>>>(
        q, k, v, static_cast<const TO*>(a.dout),
        static_cast<const TO*>(a.o), a.lse, a.dlse, a.delta,
        static_cast<T*>(a.out0), static_cast<T*>(a.dout16), a.S, a.H,
        a.qs, a.ks, a.vs, a.os, a.oos, a.pos, a.scale, a.causal);
  } else {
    flash_dkv_mma_kernel<T, D, kPos><<<grid, kMmaThreads, 0, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H,
        a.qs, a.ks, a.vs, a.os, a.pos, a.scale, a.causal);
  }
}

// The tensor-core route's own check: bf16 or float16 q, k, v at D of
// 32 or 64, every strided tensor 16-byte aligned with (b, s, h) strides that
// are whole 16-byte pieces (multiples of 8 in bf16; of 4 for K2p's f32 dO and
// O). 0 on a launch, 1 (nothing launched) for a call it does not take.
template <bool kPos>
int dispatch_mma(const Args& a, int D, int dtype, bool dq) {
  const void* ptrs[5] = {a.q, a.k, a.v, a.dout, a.o};
  const Strides* sts[5] = {&a.qs, &a.ks, &a.vs, &a.os, &a.oos};
  const int per16 = kPos && dq ? 4 : 8;  // elements of dO and O a piece
  bool ok = (dtype == 1 || dtype == 2) && (D == 32 || D == 64) &&
            (!(kPos && dq) || a.dout16 != nullptr);
  for (int i = 0; i < (dq ? 5 : 4); ++i) {
    const int m = i < 3 ? 8 : per16;
    ok = ok && reinterpret_cast<unsigned long long>(ptrs[i]) % 16 == 0 &&
         sts[i]->b % m == 0 && sts[i]->s % m == 0 && sts[i]->h % m == 0;
  }
  if (!ok) return 1;
  if (dtype == 1) {
    if (D == 32) {
      launch_mma<bf16, 32, kPos>(a, dq);
    } else {
      launch_mma<bf16, 64, kPos>(a, dq);
    }
  } else {
    if (D == 32) {
      launch_mma<f16, 32, kPos>(a, dq);
    } else {
      launch_mma<f16, 64, kPos>(a, dq);
    }
  }
  return 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* o, const void* lse, void* delta, void* out0,
               void* out1, int B, int S, int H, const int* strides,
               int n_strided, float scale, int causal, void* stream,
               const void* q_pos = nullptr, const void* k_pos = nullptr,
               int kv_valid = 0) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.o = o;
  a.lse = static_cast<const float*>(lse);
  a.dlse = nullptr;
  a.delta = static_cast<float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
  a.dout16 = nullptr;
  a.B = B;
  a.S = S;
  a.H = H;
  a.qs = {strides[0], strides[1], strides[2]};
  a.ks = {strides[3], strides[4], strides[5]};
  a.vs = {strides[6], strides[7], strides[8]};
  a.os = {strides[9], strides[10], strides[11]};
  a.oos = n_strided == 5 ? Strides{strides[12], strides[13], strides[14]}
                         : Strides{0, 0, 0};
  a.pos = {static_cast<const int*>(q_pos), static_cast<const int*>(k_pos),
           kv_valid};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

int finish(int refused) {
  return refused ? static_cast<int>(cudaErrorInvalidValue)
                 : static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  dtype: 0 = float32,
// 1 = bfloat16, 2 = float16.  lse and delta are (B*H, S) f32. Outputs
// are contiguous (B, S, H, D) in the input dtype.  Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a call the kernel does not take).
//
// K2: strides are 15 element strides, (batch, seq, head) of q, k, v, dO
// and O in that order, each with a contiguous head dim.  Writes delta =
// rowsum(dO * O) and dq.  The _mma entry point is the tensor-core route:
// bf16 or float16, D of 32 or 64, every pointer 16-byte aligned and every
// stride a multiple of 8; dpt_flash_dq takes every dtype and head dim of the
// scalar kernel.

extern "C" int dpt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* o, const void* lse,
                            void* delta, void* dq, int B, int S, int H, int D,
                            const int* strides, float scale, int causal,
                            int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, o, lse, delta, dq, nullptr, B, S,
                           H, strides, 5, scale, causal, stream);
  return finish(dispatch<true, false>(a, D, dtype));
}

extern "C" int dpt_flash_dq_mma(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, void* delta, void* dq,
                                int B, int S, int H, int D,
                                const int* strides, float scale, int causal,
                                int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, o, lse, delta, dq, nullptr, B, S,
                           H, strides, 5, scale, causal, stream);
  return finish(dispatch_mma<false>(a, D, dtype, true));
}

// K3: strides are 12, those of q, k, v and dO; delta is K2's.

extern "C" int dpt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int H, int D, const int* strides,
                             float scale, int causal, int dtype,
                             void* stream) {
  const Args a = make_args(q, k, v, dout, nullptr, lse,
                           const_cast<void*>(delta), dk, dv, B, S, H,
                           strides, 4, scale, causal, stream);
  return finish(dispatch<false, false>(a, D, dtype));
}

extern "C" int dpt_flash_dkv_mma(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int S, int H,
                                 int D, const int* strides, float scale,
                                 int causal, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, nullptr, lse,
                           const_cast<void*>(delta), dk, dv, B, S, H,
                           strides, 4, scale, causal, stream);
  return finish(dispatch_mma<false>(a, D, dtype, false));
}

// K2p and K3p: q_pos / k_pos are the (S,) int32 global positions of K4's
// call; kv_valid masks keys at positions >= kv_valid (INT_MAX for none).
//
// K2p: as dpt_flash_dq's arguments (15 strides) with dO and O in f32 (K4's
// O and its cotangent) and dlse, the (B*H, S) f32 cotangent of lse (null
// for zero).  Writes delta = rowsum(dO * O) - dlse and dq.  The _mma entry
// point, the tensor-core route (bf16 or float16 q, k, v at D of 32 or 64,
// dO and O with 16-byte-aligned pointers and strides that are multiples of
// 4), also writes dO rounded to q's type to dout16, contiguous (B, S, H,
// D).

extern "C" int dpt_flash_dq_pos(const void* q, const void* k, const void* v,
                                const void* dout, const void* o,
                                const void* lse, const void* dlse,
                                const void* q_pos, const void* k_pos,
                                int kv_valid, void* delta, void* dq, int B,
                                int S, int H, int D, const int* strides,
                                float scale, int causal, int dtype,
                                void* stream) {
  Args a = make_args(q, k, v, dout, o, lse, delta, dq, nullptr, B, S, H,
                     strides, 5, scale, causal, stream, q_pos, k_pos,
                     kv_valid);
  a.dlse = static_cast<const float*>(dlse);
  return finish(dispatch<true, true>(a, D, dtype));
}

extern "C" int dpt_flash_dq_pos_mma(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* o, const void* lse,
                                    const void* dlse, const void* q_pos,
                                    const void* k_pos, int kv_valid,
                                    void* delta, void* dq, void* dout16,
                                    int B, int S, int H, int D,
                                    const int* strides, float scale,
                                    int causal, int dtype, void* stream) {
  Args a = make_args(q, k, v, dout, o, lse, delta, dq, nullptr, B, S, H,
                     strides, 5, scale, causal, stream, q_pos, k_pos,
                     kv_valid);
  a.dlse = static_cast<const float*>(dlse);
  a.dout16 = dout16;
  return finish(dispatch_mma<true>(a, D, dtype, true));
}

// K3p: as dpt_flash_dkv's arguments (12 strides) with K2p's delta.  The
// scalar kernel reads dO in f32; the _mma entry point reads the 16-bit dO
// that dpt_flash_dq_pos_mma wrote, on the same checks as dpt_flash_dkv_mma.

extern "C" int dpt_flash_dkv_pos(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* q_pos,
                                 const void* k_pos, int kv_valid, void* dk,
                                 void* dv, int B, int S, int H, int D,
                                 const int* strides, float scale, int causal,
                                 int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, nullptr, lse,
                           const_cast<void*>(delta), dk, dv, B, S, H,
                           strides, 4, scale, causal, stream, q_pos, k_pos,
                           kv_valid);
  return finish(dispatch<false, true>(a, D, dtype));
}

extern "C" int dpt_flash_dkv_pos_mma(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     const void* q_pos, const void* k_pos,
                                     int kv_valid, void* dk, void* dv, int B,
                                     int S, int H, int D,
                                     const int* strides, float scale,
                                     int causal, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, nullptr, lse,
                           const_cast<void*>(delta), dk, dv, B, S, H,
                           strides, 4, scale, causal, stream, q_pos, k_pos,
                           kv_valid);
  return finish(dispatch_mma<true>(a, D, dtype, false));
}
