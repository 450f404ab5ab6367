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
// Two routes, chosen by the wrapper (ops/flash_attention.py::
// tensor_core_route, the rule of K2/K3 on q, k and v):
//
// 1. bf16 or float16 (the vit and its ring under --precision f16) at
//    D = 32 or 64 with 16-byte-aligned rows -- the vit's q, k, v (views
//    into one projection) and the ring's shards -- runs
//    flash_fwd_mma_kernel<T, D, kPos> on the tensor cores, mma.sync.m16n8k16
//    T x T -> f32 (T bf16 or float16), from the building blocks
//    of mma16.cuh.  A block
//    of 4 warps owns 64 query rows, 16 a warp; the grid is (ceil(S / 64),
//    B*H).  Its Q rows arrive once by 16-byte cp.async (zero-filled past S)
//    into stage 1's K buffer and go into A fragments by ldmatrix, where
//    they stay.  K/V tiles of 64 keys stream through two cp.async stages,
//    tile t + 1 in flight while tile t multiplies, one barrier a tile; K4's
//    stages also take the tile's 64 key positions by 4-byte cp.async, and a
//    lane's two query positions sit in registers.  Per tile a warp computes
//    S = Q K^T 16 keys at a time (K's stored rows are the .col B operand),
//    scales it in f32, masks it in the accumulator layout, and runs the
//    online softmax once a tile in registers: a thread holds rows g and
//    g + 8, a row's max reduces over the 4 lanes of a quad with two xor
//    shuffles, O is rescaled by exp(m - m_new) once, and l is summed per
//    lane and reduced over the quad at the end.  P rounded to T is the A
//    fragment of O += P V (the C layout of two n8 tiles is the A layout of
//    one k16 step), V through ldmatrix .trans.  K1 causal stops at the
//    block's diagonal tile, and a warp skips a 16-key step that lies wholly
//    above its rows.  Each block writes only its own rows, with no atomics,
//    so two calls are bit-identical.
//    Differs from the TPU kernel in two roundings: the score is (q . k) *
//    scale, the bf16 product summed in f32 and then scaled, where the TPU
//    kernel scales q in f32 first (the same up to f32 rounding); and p is
//    rounded to T before the P V product, as FlashAttention-2 and SDPA
//    do, which moves O by at most about 2^-9 max|v| in bf16 (2^-12 in
//    float16, whose p below 2^-14 keeps fewer bits); l sums the f32 p.
//
// 2. Every other call -- f32, D = 128, views whose rows are not 16-byte
//    aligned -- runs flash_fwd_kernel, scalar FMAs (below), in f32, bf16 or
//    float16.  K4's O is f32 in every input type.
//
// Numerics kept from the TPU kernel on both routes: masked scores take the
// finite sentinel -1e30 and their p is forced to 0 (in a row whose keys are
// all masked m stays -1e30, so exp(s - m) would be 1 there); l is clamped
// at 1e-30 before the division; every sum is f32; K1's O is cast to the
// input dtype with round-to-nearest-even (a float16 value past 65504 is
// +-inf, as the TPU kernel's astype gives), K4's is f32.  lse = m + log(l) is
// stored as (B*H, S) f32 (the TPU kernel's (bh, s, 8) lane broadcast was a
// Mosaic layout artifact).  The scalar route scales q in f32 before the
// product, as the TPU kernel does.
//
// Not carried over from the TPU kernel: the wrapper's moveaxis to (B*H, S, D)
// and the pad of S to a multiple of 128.  Both routes read q, k and v in
// their (B, S, H, D) layout through strides (so the qkv split of the vit
// needs no copy) and mask the ragged tail of S themselves.  The TPU kernel
// kept all of K and V for one head in VMEM; here one thread block takes one
// (b*h, 64-row q tile) and streams K/V tiles through shared memory.
//
// The scalar kernel: 256 threads, 4 per query row, K/V tiles of KT keys
// (KT = 64, or 32 at D = 128 so two f32 tiles stay under 48 KB).  Thread g
// of a row owns the dims d = g, g+4, g+8, ... of q and of the f32
// accumulator (registers); a score is a partial dot product over those dims
// reduced across the 4 lanes with two xor shuffles.  The running max m and
// sum l live in registers, the scores of one tile too (KT floats).
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s bf16 dense): at the vit
// shapes (S = 49, D = 32, B*H = 4 * bucket) the kernel moves q, k, v and o
// once (4 * B*S*H*D * 2 bytes in bf16, 3.2 MB at bucket 64, 0.97 us with
// lse) against 4*B*H*S*S*D operations (~79 MFLOP, ~0.08 us at the bf16
// tensor-core peak): bytes bound the work.  K4 at the vit's ring shard (B,
// S, H, D) = (128, 25, 4, 32) bf16 reads q, k, v (3 x 0.82 MB) and writes
// the f32 O (1.6 MB) and lse (0.05 MB): 4.1 MB, 1.24 us, against 42 MFLOP
// (0.04 us): bytes bound it too.  At these sizes a block holds one 64-key
// tile (49 or 25 real keys), so launch and memory latency bound both
// kernels in practice.  The tensor-core route takes 130 / 157 registers a
// thread for K1 at D = 32 / 64 and 123 / 180 for K4 (the scalar kernel:
// 128 and 200-222), with no spills, and 20.0 / 36.0 KB of static shared
// memory (K4: 20.5 / 36.5 KB), as -Xptxas=-v reports them with nvcc 12.9.
// Measured on an H100 SXM at 700 W (PERF.md): K1 5.4 us at (64, 49, 4, 32)
// bf16 against the 0.97 us bound, K4 6.0 us at the ring shard against
// 1.24.  At S = 1000 (128 blocks of 4 warps for 132 SMs, one 64-key tile
// after another) the kernel waits on each tile's loads: about 50 us.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "mma16.cuh"

namespace {

constexpr int kRows = 64;          // query rows per thread block
constexpr int kLanes = 4;          // threads per query row
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

// -- route 1: tensor cores ------------------------------------------------

// O as K1 writes it (T, the input type) and as K4 does (f32).
template <typename T, bool kPos>
using MmaOut = typename std::conditional<kPos, float, T>::type;

// Blocks an SM must hold at once: four for K4 at D = 32 (at most 128
// registers a thread, against 137 unbounded), so the ring shard's 512
// blocks run in one wave on 132 SMs (6.0 against 9.8 us on an H100 SXM at
// 700 W, PERF.md); otherwise the compiler's choice (K1's main grid, 256
// blocks, fits one wave as it is).
template <int D, bool kPos>
constexpr int kFwdMinBlocks = kPos && D == 32 ? 4 : 1;

// K1 (kPos false) and K4 (kPos true) on the tensor cores: one block per
// (64 query rows, b*h).
template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kMmaThreads, kFwdMinBlocks<D, kPos>)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, MmaOut<T, kPos>* __restrict__ o,
                     float* __restrict__ lse, int S, int H, Strides qs,
                     Strides ks, Strides vs, Pos pos, float scale,
                     int causal) {
  constexpr int LD = D + kPad;
  constexpr int KS = D / 16;             // k16 steps over D
  constexpr int ND = D / 8;              // n8 tiles over D
  constexpr int KC = kMmaTile / 16;      // 16-key steps a tile
  // stage 1 first holds this block's Q rows (k_s)
  __shared__ __align__(128) T k_s[2][kMmaTile][LD];
  __shared__ __align__(128) T v_s[2][kMmaTile][LD];
  __shared__ __align__(16) int kp_s[kPos ? 2 : 1][kMmaTile];  // K4

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
  load_rows<D>(k_s[0], k, ks, b, h, 0, S);
  load_rows<D>(v_s[0], v, vs, b, h, 0, S);
  if constexpr (kPos) load_pos(kp_s[0], pos.k, 0, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int wrow = warp * 16;  // the warp's first row in the block
  const int ar = frag_a_row(lane), ac = frag_a_col(lane);
  const int br = frag_b_row(lane), bc = frag_b_col(lane);
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], smem_addr(&k_s[1][wrow + ar][kk * 16 + ac]));
  }
  const int row_lo = q0 + wrow + g;  // this lane's rows: row_lo, + 8
  // K4: the global positions of this lane's two rows
  const int qp_lo = kPos && row_lo < S ? pos.q[row_lo] : 0;
  const int qp_hi = kPos && row_lo + 8 < S ? pos.q[row_lo + 8] : 0;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (quad-uniform) and this lane's share of the running sum
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.f, l_hi = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const int kv0 = t * kMmaTile;
    if (t > 0) cp_async_wait_all();
    // tile t is in shared memory for every thread; every thread is done
    // with stage s ^ 1 (tile t - 1, or this block's Q)
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_rows<D>(k_s[s ^ 1], k, ks, b, h, kv0 + kMmaTile, S);
      load_rows<D>(v_s[s ^ 1], v, vs, b, h, kv0 + kMmaTile, S);
      if constexpr (kPos) load_pos(kp_s[s ^ 1], pos.k, kv0 + kMmaTile, S);
      cp_async_commit();
    }
    // a 16-key step wholly above the warp's rows is all masked (K1 causal;
    // K4's positions say nothing about tile order); warp-uniform
    bool live[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      live[c] = kPos || !causal || kv0 + c * 16 <= q0 + wrow + 15;
    }
    // S = Q K^T: sc[c][n] is the n8 tile n of 16-key step c
    float sc[KC][2][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[c][n][e] = 0.f;
      if (!live[c]) continue;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned r[4];
        ldmatrix_x4(r, smem_addr(&k_s[s][c * 16 + br][kk * 16 + bc]));
        mma_16816<T>(sc[c][0], qf[kk], r[0], r[1]);
        mma_16816<T>(sc[c][1], qf[kk], r[2], r[3]);
      }
    }
    // scale, mask (bit 8c + 4n + e of keep: the score counts) and the
    // tile's row max
    unsigned keep = 0u;
    float mt_lo = kNeg, mt_hi = kNeg;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_lo + (e >> 1) * 8;
          const int j = c * 16 + n * 8 + 2 * t4 + (e & 1);  // key in tile
          const int col = kv0 + j;
          bool valid = col < S;
          if constexpr (kPos) {
            valid = valid && pos_mask(e >> 1 ? qp_hi : qp_lo, kp_s[s][j],
                                      causal, pos.kv_valid);
          } else {
            valid = valid && (!causal || col <= row);
          }
          const float x = valid ? sc[c][n][e] * scale : kNeg;
          sc[c][n][e] = x;
          keep |= valid ? 1u << (8 * c + 4 * n + e) : 0u;
          if (e >> 1) {
            mt_hi = fmaxf(mt_hi, x);
          } else {
            mt_lo = fmaxf(mt_lo, x);
          }
        }
      }
    }
    mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, 1));
    mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, 2));
    mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, 1));
    mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, 2));
    const float mn_lo = fmaxf(m_lo, mt_lo);
    const float mn_hi = fmaxf(m_hi, mt_hi);
    const float alpha_lo = expf(m_lo - mn_lo);
    const float alpha_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    // p in f32: a masked score's p is forced to 0 (in a row with no key
    // yet, m is still -1e30 and exp(s - m) would be 1)
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >> 1;
          const float p = (keep >> (8 * c + 4 * n + e)) & 1u
              ? expf(sc[c][n][e] - (hi ? mn_hi : mn_lo)) : 0.f;
          sc[c][n][e] = p;
          if (hi) {
            ps_hi += p;
          } else {
            ps_lo += p;
          }
        }
      }
    }
    l_lo = l_lo * alpha_lo + ps_lo;
    l_hi = l_hi * alpha_hi + ps_hi;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha_lo;
      acc[nd][1] *= alpha_lo;
      acc[nd][2] *= alpha_hi;
      acc[nd][3] *= alpha_hi;
    }
    // O += P V, P rounded to T, V through ldmatrix .trans
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (!live[c]) continue;
      unsigned pa[4];
      to_a_fragment<T>(pa, sc[c]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        unsigned r[4];
        ldmatrix_x4_trans(r, smem_addr(&v_s[s][c * 16 + ar][nd * 8 + ac]));
        mma_16816<T>(acc[nd], pa, r[0], r[1]);
        mma_16816<T>(acc[nd + 1], pa, r[2], r[3]);
      }
    }
  }

  // a row's sum over its quad
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + half * 8;
    if (row >= S) continue;
    const float l_safe = fmaxf(half ? l_hi : l_lo, 1e-30f);
    MmaOut<T, kPos>* out =
        o + (((long long)b * S + row) * H + h) * D + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      store2(out + nd * 8, acc[nd][2 * half] / l_safe,
             acc[nd][2 * half + 1] / l_safe);
    }
    if (t4 == 0) {
      lse[(long long)bh * S + row] = (half ? m_hi : m_lo) + logf(l_safe);
    }
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
  } else if (dtype == 2) {
    DPT_CASE(__half, 32, 64)
    DPT_CASE(__half, 64, 64)
    DPT_CASE(__half, 128, 32)
  }
#undef DPT_CASE
  return 1;
}

template <typename T, int D, bool kPos>
void launch_mma(const FwdArgs& a) {
  const dim3 grid((a.S + kMmaRows - 1) / kMmaRows, a.B * a.H);
  flash_fwd_mma_kernel<T, D, kPos><<<grid, kMmaThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<MmaOut<T, kPos>*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H,
      Strides{a.q_sb, a.q_ss, a.q_sh}, Strides{a.k_sb, a.k_ss, a.k_sh},
      Strides{a.v_sb, a.v_ss, a.v_sh}, Pos{a.q_pos, a.k_pos, a.kv_valid},
      a.scale, a.causal);
}

// The tensor-core route's own check: bf16 or float16 q, k, v
// at D of 32 or 64, each 16-byte aligned with (b, s, h) strides that are
// multiples of 8.  0 on a launch, 1 (nothing launched) for a call it does
// not take.
template <bool kPos>
int dispatch_mma(const FwdArgs& a, int D, int dtype) {
  const void* ptrs[3] = {a.q, a.k, a.v};
  const int strides[9] = {a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss,
                          a.k_sh, a.v_sb, a.v_ss, a.v_sh};
  bool ok = (dtype == 1 || dtype == 2) && (D == 32 || D == 64);
  for (int i = 0; i < 3; ++i) {
    ok = ok && reinterpret_cast<unsigned long long>(ptrs[i]) % 16 == 0;
  }
  for (int i = 0; i < 9; ++i) ok = ok && strides[i] % 8 == 0;
  if (!ok) return 1;
  if (dtype == 1) {
    if (D == 32) {
      launch_mma<bf16, 32, kPos>(a);
    } else {
      launch_mma<bf16, 64, kPos>(a);
    }
  } else {
    if (D == 32) {
      launch_mma<f16, 32, kPos>(a);
    } else {
      launch_mma<f16, 64, kPos>(a);
    }
  }
  return 0;
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
// 1 = bfloat16, 2 = float16.  Strides are in elements; the last dim
// of q, k and v must be contiguous.  O and lse are written contiguous: O (B,
// S, H, D), lse (B*H, S) f32.  Each returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a head dim or dtype the kernel does not
// take, without launching).

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

// The tensor-core route of K1 and of K4: the same arguments as
// dpt_flash_fwd and dpt_flash_fwd_pos; bf16 or float16 at D of 32 or 64,
// every pointer 16-byte aligned and every stride a multiple of 8
// (cudaErrorInvalidValue, without launching, otherwise).
extern "C" int dpt_flash_fwd_mma(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int S, int H,
                                 int D, int q_sb, int q_ss, int q_sh,
                                 int k_sb, int k_ss, int k_sh, int v_sb,
                                 int v_ss, int v_sh, float scale, int causal,
                                 int dtype, void* stream) {
  const FwdArgs a = make_args(q, k, v, o, lse, nullptr, nullptr, 0, B, S, H,
                              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                              v_sh, scale, causal, stream);
  if (dispatch_mma<false>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dpt_flash_fwd_pos_mma(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     const void* q_pos, const void* k_pos,
                                     int kv_valid, int B, int S, int H, int D,
                                     int q_sb, int q_ss, int q_sh, int k_sb,
                                     int k_ss, int k_sh, int v_sb, int v_ss,
                                     int v_sh, float scale, int causal,
                                     int dtype, void* stream) {
  const FwdArgs a = make_args(q, k, v, o, lse, q_pos, k_pos, kv_valid, B, S,
                              H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                              v_ss, v_sh, scale, causal, stream);
  if (dispatch_mma<true>(a, D, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
