// Backward of the fused QK-RMSNorm + rotate-half RoPE + masked attention
// (fused_attention.cu), straight from the flat [B, N, 3C] QKV and the
// cotangent of the [B, N, C] output to dqkv [B, N, 3C] and the two gains'
// gradients. Nothing of size [N, N] and no normed or rotated q/k reaches
// device memory.
//
// Replaces the TPU kernel vitok_tpu/ops/fused_attention.py::_fused_bwd_kernel
// (launcher _fused_bwd). Same function and the same rounding points:
//   * the caller has zeroed the cotangent on padded query rows; here dO rows
//     whose mask byte is 0 are zero-filled again on load, and such rows carry
//     p = 0 throughout, so every gradient they touch is exactly 0;
//   * qrot, krot: fp32 norm statistics, gain, cast to bf16, bf16 rotation
//     with cos/sin rounded to bf16 (norm_rope.cuh, the forward's code);
//   * logits qrot krot^T in fp32 times 1/sqrt(d) in fp32 (computed as
//     exp2 of the logits times log2(e)/sqrt(d)); key-side mask and window;
//   * p in fp32 from the full row's max and sum; delta = sum_k dp * p in fp32
//     with dp = dO v^T;
//   * p rounded to bf16 for dv = p^T dO; ds = p (dp - delta) / sqrt(d) rounded
//     to bf16 for dqrot = ds krot and dkrot = ds^T qrot; fp32 accumulation;
//   * the rotation's transpose and the RMSNorm backward in fp32 on the raw
//     q/k rows; dq, dk, dv written as bf16.
// The TPU kernel holds a head's whole [N, N] block in VMEM and forms p, dp
// and ds once. A Hopper block holds 64 rows, so two kernels run inside the
// one launch:
//   dq kernel, one block per (64-query tile, head, sample): pass 1 walks the
//     key tiles with an online max/sum and delta (products s and dp), and
//     writes each row's log-sum-exp (log2 units) and delta to two fp32
//     [B, H, N] buffers; pass 2 walks them again, forms p and ds and
//     accumulates dqrot = ds krot; the epilogue takes dqrot through the
//     rotation and norm backward to dq.
//   dk/dv kernel, one block per (64-key tile, head, sample): computes the
//     transposed logits s^T = krot qrot^T and dp^T = v dO^T, so p^T and ds^T
//     are born as mma A fragments and the row statistics are per-column
//     values from shared memory; dO and qrot feed dv and dkrot as B operands
//     through ldmatrix.trans. At d = 128 eight warps run, each group of four
//     owning a 64-channel half of dk and dv and recomputing s^T and dp^T.
// Every streamed q or k tile is normalised and rotated on the way into shared
// memory. The gains' gradients are sums over rows, heads and samples: each
// block writes its tile's fp32 partial, summed in a fixed order inside the
// block, to [B, H, tiles, D]; the caller sums that array. No atomics: two
// runs give the same bits.
//
// What bounds it on an H100: the function needs five products per (query,
// key) pair, 10 * B * H * N^2 * d operations, against 7 * C * B * N * 2 bytes
// (qkv and dO read, dqkv written): operations at N = 1024, bytes at N = 256.
// This version does nine products (s and dp are recomputed in both kernels
// and in both passes of the dq kernel), on mma.sync, single-buffered, and
// normalises K once per query tile per pass. What it does do: skips key
// (query) tiles past a sample's last valid key and tiles wholly outside the
// window; 16-byte loads and stores throughout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). One plain C entry point,
// bound with ctypes; asynchronous on the caller's stream, returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "norm_rope.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTile = 64;   // rows of every tile, on both axes
constexpr int kPad = 8;     // bf16 row padding: conflict-free fragment loads
constexpr float kNegFill = -1e30f;
constexpr float kDeadLse = 1e30f;  // a padded query row: p = exp2(x - 1e30) = 0
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int kRow = D + kPad;
  static constexpr int kStageRow = D + 4;  // fp32 staging of dqrot / dkrot
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kOwnA = 0;                       // dq: qrot; dk/dv: krot
  static constexpr size_t kOwnB = kOwnA + kTileBytes;      // dq: dO;   dk/dv: v
  static constexpr size_t kStreamA = kOwnB + kTileBytes;   // dq: krot; dk/dv: qrot
  static constexpr size_t kStreamB = kStreamA + kTileBytes;  // dq: v;  dk/dv: dO
  static constexpr size_t kGainQ = kStreamB + kTileBytes;
  static constexpr size_t kGainK = kGainQ + sizeof(float) * D;
  static constexpr size_t kLse = kGainK + sizeof(float) * D;  // 64 x row lse (log2 units)
  static constexpr size_t kDelta = kLse + sizeof(float) * kTile;
  static constexpr size_t kKeyState = kDelta + sizeof(float) * kTile;
  static constexpr size_t kBytes = kKeyState + kTile;
  // The epilogue reuses the tiles: the fp32 stage over the two streamed
  // tiles, the gain partials over the two own tiles.
  static constexpr size_t kStage = kStreamA;
  static constexpr size_t kPart = kOwnA;
  static_assert(sizeof(float) * kTile * kStageRow <= 2 * kTileBytes, "stage fits");
  static_assert(sizeof(float) * 256 * 16 <= 2 * kTileBytes, "gain partials fit");
};

// 64 rows of D channels (row stride `stride_n`, first row `row0`) into a
// shared-memory tile, 16 bytes a copy. Rows at or past N, and rows whose byte
// in `rowmask` (indexed by absolute row; may be null) is 0, are zero-filled
// and not read.
template <int D, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride_n, int row0, int N,
                                                const unsigned char* rowmask, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kRow = D + kPad;
#pragma unroll
  for (int u = 0; u < kTile * kChunks / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const int row = i / kChunks;
    const int ch = (i % kChunks) * 8;
    const int j = row0 + row;
    const bool in = j < N && (rowmask == nullptr || rowmask[j]);
    const long long jj = j < N ? j : 0;
    cp_async16(dst + row * kRow + ch, src + jj * stride_n + ch, in);
  }
}

// Gains to shared memory and, in *sKvEnd, one past the last valid key. The
// caller synchronises before it reads either.
template <int D, int THREADS>
__device__ __forceinline__ void block_setup(const float* __restrict__ q_scale,
                                            const float* __restrict__ k_scale,
                                            const unsigned char* mask_b, int N, float* sGainQ,
                                            float* sGainK, int* sKvEnd, int tid) {
  for (int i = tid; i < D; i += THREADS) {
    sGainQ[i] = q_scale[i];
    sGainK[i] = k_scale[i];
  }
  if (tid == 0) *sKvEnd = mask_b ? 0 : N;
  __syncthreads();
  if (mask_b) {
    int last = 0;
    for (int j = tid; j < N; j += THREADS)
      if (mask_b[j]) last = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(kFull, last, off));
    if ((tid & 31) == 0) atomicMax(sKvEnd, last);
  }
  __syncthreads();
}

// Zeros for rows [r0, min(r0 + 64, N)) of one head's D channels in a plane of
// dqkv, and for the block's gain partial.
template <int D, int THREADS>
__device__ __forceinline__ void write_zero_tile(__nv_bfloat16* plane, long long row_stride, int r0,
                                                int N, float* gain_grad, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kTile * kChunks; i += THREADS) {
    const int n = r0 + i / kChunks;
    if (n < N)
      *reinterpret_cast<uint4*>(plane + (long long)n * row_stride + (i % kChunks) * 8) =
          make_uint4(0, 0, 0, 0);
  }
  if (gain_grad != nullptr && tid < D) gain_grad[tid] = 0.f;
}

// ---------------------------------------------------------------------------
// dq (and the row statistics)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
fused_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ q_scale,
                    const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t,
                    const unsigned char* __restrict__ mask,  // [B, N] or null
                    const __nv_bfloat16* __restrict__ dout,  // [B, N, C]
                    __nv_bfloat16* __restrict__ dqkv,        // [B, N, 3C]
                    float* __restrict__ lse,                 // [B, H, N], log2 units
                    float* __restrict__ delta,               // [B, H, N]
                    float* __restrict__ part_q,              // [B, H, tiles, D]
                    int N, int H, int sw, float score_scale, float inv_sqrt_d) {
  using S = Smem<D>;
  constexpr int kThreads = 128;
  constexpr int kRow = S::kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kOwnA);
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + S::kOwnB);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kStreamA);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kStreamB);
  float* sGainQ = reinterpret_cast<float*>(smem + S::kGainQ);
  float* sGainK = reinterpret_cast<float*>(smem + S::kGainK);
  unsigned char* sKeyState = smem + S::kKeyState;  // 0 valid, 1 masked, 2 past N

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * row_stride;
  __nv_bfloat16* dqkv_b = dqkv + (long long)b * N * row_stride;
  const __nv_bfloat16* dout_b = dout + (long long)b * N * C + h * D;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long stat_base = ((long long)b * H + h) * N;
  float* part_out = part_q + (((long long)b * H + h) * gridDim.x + blockIdx.x) * D;

  block_setup<D, kThreads>(q_scale, k_scale, mask_b, N, sGainQ, sGainK, &sKvEnd, tid);
  const int kv_end = sKvEnd;

  // Live key tiles of this query tile. Query rows at or past kv_end are all
  // padded: their cotangent is zero and so is everything they produce.
  const int q_last = min(q0 + kTile, N) - 1;
  int lo = 0, hi = kv_end;
  if (sw >= 0) {
    lo = max(0, q0 - sw);
    hi = min(kv_end, q_last + sw + 1);
  }
  if (q0 >= kv_end) hi = lo;
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  const int r0 = warp * 16 + g;  // this thread's two rows inside the tile
  const int qrow0 = q0 + r0;
  const int qrow1 = qrow0 + 8;

  if (n_tiles == 0) {
    write_zero_tile<D, kThreads>(dqkv_b + h * D, row_stride, q0, N, part_out, tid);
    if (tid < kTile && q0 + tid < N) {
      lse[stat_base + q0 + tid] = kDeadLse;
      delta[stat_base + q0 + tid] = 0.f;
    }
    return;
  }

  // dO with padded query rows zeroed, in flight while Q is normalised.
  load_tile_async<D, kThreads>(sG, dout_b, C, q0, N, mask_b, tid);
  cp_async_commit();
  norm_rope_tile<D, kThreads>(qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b, sQ, tid);

  auto load_kv = [&](int kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of sK / sV are done
    load_tile_async<D, kThreads>(sV, qkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
    cp_async_commit();
    norm_rope_tile<D, kThreads>(qkv_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK,
                                tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      sKeyState[tid] = j >= N ? 2 : ((mask_b && !mask_b[j]) ? 1 : 0);
    }
    cp_async_wait<0>();
    __syncthreads();
  };

  // s = qrot krot^T and dp = dO v^T for this warp's 16 rows x 64 keys.
  auto products = [&](float (&s)[kTile / 8][4], float (&dp)[kTile / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      uint32_t qa[4], ga[4];
      qa[0] = ld_u32(sQ + r0 * kRow + c0);
      qa[1] = ld_u32(sQ + (r0 + 8) * kRow + c0);
      qa[2] = ld_u32(sQ + r0 * kRow + c0 + 8);
      qa[3] = ld_u32(sQ + (r0 + 8) * kRow + c0 + 8);
      ga[0] = ld_u32(sG + r0 * kRow + c0);
      ga[1] = ld_u32(sG + (r0 + 8) * kRow + c0);
      ga[2] = ld_u32(sG + r0 * kRow + c0 + 8);
      ga[3] = ld_u32(sG + (r0 + 8) * kRow + c0 + 8);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const __nv_bfloat16* krow = sK + (nt * 8 + g) * kRow + c0;
        const __nv_bfloat16* vrow = sV + (nt * 8 + g) * kRow + c0;
        mma_bf16(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
        mma_bf16(dp[nt], ga, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  };

  // Pass 1: each row's max, sum and sum of p * dp, online over the key tiles
  // (masked keys and pairs outside the window filled with -1e30, as the
  // forward does, so every sum stays finite).
  float m0 = -INFINITY, m1 = -INFINITY;
  float l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;  // this thread's shares
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (lo_tile + it) * kTile;
    load_kv(lo_tile + it);
    float s[kTile / 8][4], dp[kTile / 8][4];
    products(s, dp);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qrow = (e < 2) ? qrow0 : qrow1;
        const int state = sKeyState[col];
        float v = __fmul_rn(s[nt][e], score_scale);
        if (state == 2) {
          v = -INFINITY;
        } else if (state == 1 || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) {
          v = kNegFill;
        }
        s[nt][e] = v;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // Key k0 < N is in every tile, so the new max is finite.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float f0 = exp2f(m0 - mn0), f1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f, as0 = 0.f, as1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const float p0 = exp2f(__fsub_rn(s[nt][0], mn0));
      const float p1 = exp2f(__fsub_rn(s[nt][1], mn0));
      const float p2 = exp2f(__fsub_rn(s[nt][2], mn1));
      const float p3 = exp2f(__fsub_rn(s[nt][3], mn1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      as0 += p0 * dp[nt][0] + p1 * dp[nt][1];
      as1 += p2 * dp[nt][2] + p3 * dp[nt][3];
    }
    l0 = l0 * f0 + ls0;
    l1 = l1 * f1 + ls1;
    a0 = a0 * f0 + as0;
    a1 = a1 * f1 + as1;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
    a0 += __shfl_xor_sync(kFull, a0, off);
    a1 += __shfl_xor_sync(kFull, a1, off);
  }
  // A padded query row (or one past N) gets the dead lse: p = 0 from here on.
  const bool live0 = qrow0 < N && (mask_b == nullptr || mask_b[qrow0]);
  const bool live1 = qrow1 < N && (mask_b == nullptr || mask_b[qrow1]);
  const float lse0 = live0 ? m0 + log2f(l0) : kDeadLse;
  const float lse1 = live1 ? m1 + log2f(l1) : kDeadLse;
  const float dl0 = live0 ? a0 / l0 : 0.f;
  const float dl1 = live1 ? a1 / l1 : 0.f;
  if (t == 0) {
    if (qrow0 < N) {
      lse[stat_base + qrow0] = lse0;
      delta[stat_base + qrow0] = dl0;
    }
    if (qrow1 < N) {
      lse[stat_base + qrow1] = lse1;
      delta[stat_base + qrow1] = dl1;
    }
  }

  // Pass 2: p, ds and dqrot += ds krot.
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // This lane's ldmatrix row address inside a 16-key x 16-channel block of K.
  const int m_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int m_col = (lane >> 4) * 8;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (lo_tile + it) * kTile;
    load_kv(lo_tile + it);
    float s[kTile / 8][4], dp[kTile / 8][4];
    products(s, dp);
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qrow = (e < 2) ? qrow0 : qrow1;
        float p = exp2f(__fsub_rn(__fmul_rn(s[nt][e], score_scale), e < 2 ? lse0 : lse1));
        if (sKeyState[col] != 0 || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) p = 0.f;
        ds[e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * inv_sqrt_d;
      }
      // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
      const int j = nt >> 1;
      const int hi2 = (nt & 1) * 2;
      dsa[j][hi2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j][hi2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, sK + (j * 16 + m_key) * kRow + dt * 8 + m_col);
        mma_bf16(acc[dt], dsa[j], kb[0], kb[1]);
        mma_bf16(acc[dt + 1], dsa[j], kb[2], kb[3]);
      }
    }
  }

  // dqrot to the fp32 stage, then through the rotation and norm backward.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem + S::kStage);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(stage + r0 * S::kStageRow + col) = make_float2(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<float2*>(stage + (r0 + 8) * S::kStageRow + col) =
        make_float2(acc[dt][2], acc[dt][3]);
  }
  __syncthreads();
  norm_rope_bwd_tile<D, kThreads>(stage, qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b,
                                  dqkv_b + h * D, reinterpret_cast<float*>(smem + S::kPart),
                                  part_out, tid);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128 * (D / 64))
fused_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ q_scale,
                     const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t,
                     const unsigned char* __restrict__ mask,  // [B, N] or null
                     const __nv_bfloat16* __restrict__ dout,  // [B, N, C]
                     __nv_bfloat16* __restrict__ dqkv,        // [B, N, 3C]
                     const float* __restrict__ lse,           // [B, H, N], log2 units
                     const float* __restrict__ delta,         // [B, H, N]
                     float* __restrict__ part_k,              // [B, H, tiles, D]
                     int N, int H, int sw, float score_scale, float inv_sqrt_d) {
  using S = Smem<D>;
  constexpr int kSplit = D / 64;  // groups of four warps, one 64-channel half each
  constexpr int kThreads = 128 * kSplit;
  constexpr int kRow = S::kRow;
  constexpr int kOutTiles = 8;  // 8-channel output tiles per warp (64 channels)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kOwnA);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kOwnB);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kStreamA);
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + S::kStreamB);
  float* sGainQ = reinterpret_cast<float*>(smem + S::kGainQ);
  float* sGainK = reinterpret_cast<float*>(smem + S::kGainK);
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;     // which 16 key rows
  const int half = warp >> 2;  // which 64 output channels
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * row_stride;
  __nv_bfloat16* dqkv_b = dqkv + (long long)b * N * row_stride;
  const __nv_bfloat16* dout_b = dout + (long long)b * N * C + h * D;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long stat_base = ((long long)b * H + h) * N;
  float* part_out = part_k + (((long long)b * H + h) * gridDim.x + blockIdx.x) * D;

  block_setup<D, kThreads>(q_scale, k_scale, mask_b, N, sGainQ, sGainK, &sKvEnd, tid);
  const int kv_end = sKvEnd;

  // Live query tiles of this key tile. Query rows at or past kv_end carry a
  // zero cotangent; a key tile at or past kv_end holds no live key.
  const int k_last = min(k0 + kTile, N) - 1;
  int lo = 0, hi = kv_end;
  if (sw >= 0) {
    lo = max(0, k0 - sw);
    hi = min(kv_end, k_last + sw + 1);
  }
  if (k0 >= kv_end) hi = lo;
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  if (n_tiles == 0) {
    write_zero_tile<D, kThreads>(dqkv_b + C + h * D, row_stride, k0, N, part_out, tid);
    write_zero_tile<D, kThreads>(dqkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
    return;
  }

  const int r0 = wr * 16 + g;
  const int krow0 = k0 + r0;  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < N && (mask_b == nullptr || mask_b[krow0]);
  const bool kok1 = krow1 < N && (mask_b == nullptr || mask_b[krow1]);

  // This block's V tile, in flight while its K tile is normalised.
  load_tile_async<D, kThreads>(sV, qkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
  cp_async_commit();
  norm_rope_tile<D, kThreads>(qkv_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK, tid);

  float dk_acc[kOutTiles][4], dv_acc[kOutTiles][4];
#pragma unroll
  for (int i = 0; i < kOutTiles; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }
  // This lane's ldmatrix row address inside a 16-query x 16-channel block.
  const int m_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int m_col = (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int qt0 = (lo_tile + it) * kTile;
    __syncthreads();  // the previous tile's reads of sQ / sG and the statistics are done
    load_tile_async<D, kThreads>(sG, dout_b, C, qt0, N, mask_b, tid);
    cp_async_commit();
    norm_rope_tile<D, kThreads>(qkv_b + h * D, row_stride, qt0, N, sGainQ, cos_b, sin_b, sQ, tid);
    if (tid < kTile) {
      const int n = qt0 + tid;
      sLse[tid] = n < N ? lse[stat_base + n] : kDeadLse;
      sDelta[tid] = n < N ? delta[stat_base + n] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // s^T = krot qrot^T and dp^T = v dO^T for this warp's 16 key rows x 64 queries.
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      uint32_t ka[4], va[4];
      ka[0] = ld_u32(sK + r0 * kRow + c0);
      ka[1] = ld_u32(sK + (r0 + 8) * kRow + c0);
      ka[2] = ld_u32(sK + r0 * kRow + c0 + 8);
      ka[3] = ld_u32(sK + (r0 + 8) * kRow + c0 + 8);
      va[0] = ld_u32(sV + r0 * kRow + c0);
      va[1] = ld_u32(sV + (r0 + 8) * kRow + c0);
      va[2] = ld_u32(sV + r0 * kRow + c0 + 8);
      va[3] = ld_u32(sV + (r0 + 8) * kRow + c0 + 8);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const __nv_bfloat16* qrow = sQ + (nt * 8 + g) * kRow + c0;
        const __nv_bfloat16* grow = sG + (nt * 8 + g) * kRow + c0;
        mma_bf16(s[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
        mma_bf16(dp[nt], va, ld_u32(grow), ld_u32(grow + 8));
      }
    }

    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);  // query inside the tile
        const bool kok = (e < 2) ? kok0 : kok1;
        const int krow = (e < 2) ? krow0 : krow1;
        float x = exp2f(__fsub_rn(__fmul_rn(s[nt][e], score_scale), sLse[col]));
        if (!kok || (sw >= 0 && abs(qt0 + col - krow) > sw)) x = 0.f;
        p[e] = x;
        ds[e] = x * (dp[nt][e] - sDelta[col]) * inv_sqrt_d;
      }
      const int j = nt >> 1;
      const int hi2 = (nt & 1) * 2;
      pa[j][hi2 + 0] = pack_bf16(p[0], p[1]);
      pa[j][hi2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j][hi2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j][hi2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += p^T dO and dkrot += ds^T qrot over this warp's 64 channels; dO
    // and qrot are B operands, read by ldmatrix.trans.
#pragma unroll
    for (int dt = 0; dt < kOutTiles; dt += 2) {
      const int ch = (half * kOutTiles + dt) * 8 + m_col;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, sG + (j * 16 + m_row) * kRow + ch);
        mma_bf16(dv_acc[dt], pa[j], gb[0], gb[1]);
        mma_bf16(dv_acc[dt + 1], pa[j], gb[2], gb[3]);
        ldmatrix_x4_trans(qb, sQ + (j * 16 + m_row) * kRow + ch);
        mma_bf16(dk_acc[dt], dsa[j], qb[0], qb[1]);
        mma_bf16(dk_acc[dt + 1], dsa[j], qb[2], qb[3]);
      }
    }
  }

  // dv out; dkrot to the fp32 stage, then through the rotation and norm
  // backward on the raw k rows.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem + S::kStage);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = r ? krow1 : krow0;
    float* st = stage + (r0 + 8 * r) * S::kStageRow + half * 64 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt)
      *reinterpret_cast<float2*>(st + dt * 8) = make_float2(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
    if (krow >= N) continue;
    __nv_bfloat16* dv = dqkv_b + (long long)krow * row_stride + 2 * C + h * D + half * 64 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dv + dt * 8) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
  }
  __syncthreads();
  norm_rope_bwd_tile<D, kThreads>(stage, qkv_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b,
                                  dqkv_b + C + h * D, reinterpret_cast<float*>(smem + S::kPart),
                                  part_out, tid);
}

template <int D>
cudaError_t launch(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                   const void* sin_t, const void* mask, const void* dout, void* dqkv, void* lse,
                   void* delta, void* part_q, void* part_k, int B, int N, int H, int sw,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_d = (float)(1.0 / std::sqrt((double)D));
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_bwd_dq_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dqkv),
      static_cast<float*>(lse), static_cast<float*>(delta), static_cast<float*>(part_q), N, H, sw,
      score_scale, inv_sqrt_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_dkv_kernel<D><<<grid, 128 * (D / 64), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dqkv),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(part_k), N, H, sw, score_scale, inv_sqrt_d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; q_scale, k_scale [D] f32; cos, sin [B, N, D/2] f32;
// mask [B, N] bool bytes or null; dout [B, N, H*D] bf16, contiguous. Writes
// dqkv [B, N, 3*H*D] bf16 and the gain gradients' partials part_q, part_k
// [B, H, ceil(N / 64), D] f32 (the caller sums them over the first three
// axes); lse and delta are [B, H, N] f32 scratch, written by the first kernel
// and read by the second. sw < 0: no window. Returns the cudaError_t of the
// launches (0 = success).
int vitok_fused_attention_bwd_bf16(const void* qkv, const void* q_scale, const void* k_scale,
                                   const void* cos_t, const void* sin_t, const void* mask,
                                   const void* dout, void* dqkv, void* lse, void* delta,
                                   void* part_q, void* part_k, int B, int N, int H, int D, int sw,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(qkv, q_scale, k_scale, cos_t, sin_t, mask, dout, dqkv, lse, delta, part_q,
                      part_k, B, N, H, sw, s);
  if (D == 128)
    return launch<128>(qkv, q_scale, k_scale, cos_t, sin_t, mask, dout, dqkv, lse, delta, part_q,
                       part_k, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
