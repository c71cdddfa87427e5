// Backward of the fused QK-RMSNorm + rotate-half RoPE + masked attention
// (fused_attention_sm90.cu), redesigned for Hopper: from the flat [B, N, 3C]
// QKV, the forward's bf16 output and row log-sum-exp, and the cotangent of
// the output to dqkv [B, N, 3C] and the two gains' gradients. Nothing of
// size [N, N] reaches device memory.
//
// Replaces the TPU kernel vitok_tpu/ops/fused_attention.py::_fused_bwd_kernel
// (launcher _fused_bwd). Same function and the same rounding points, but one:
//   * the caller has zeroed the cotangent on padded query rows; here dO rows
//     whose mask byte is 0 are zero-filled again on load, and such rows carry
//     the forward's dead lse (1e30), so p = 0 and every gradient they touch
//     is exactly 0;
//   * qrot, krot: fp32 norm statistics, gain, cast to bf16, bf16 rotation
//     with cos/sin rounded to bf16 (norm_rope_tile, by the prologue
//     fused_qk_prologue_kernel of fused_attention_sm90.cu, into a bf16
//     scratch [B, N, 2C]);
//   * logits qrot krot^T in fp32; p = exp2(s * log2(e)/sqrt(d) - lse) with
//     the forward's row log-sum-exp (log2 units); key-side mask and window
//     give p = 0;
//   * delta = sum_c dO * O in fp32 from the forward's bf16 output O (the
//     prologue computes it), as the JAX package's flash backward does
//     (flash_attention.py:525-528). _fused_bwd_kernel sums dp * p over the
//     row instead: the same quantity, since O = sum_k p v, but O is rounded to
//     bf16 first, so this rounding point moved (the plain version with
//     `out=` follows it);
//   * p rounded to bf16 for dv = p^T dO; ds = p (dp - delta) / sqrt(d)
//     rounded to bf16 for dqrot = ds krot and dkrot = ds^T qrot; fp32
//     accumulation; the rotation's transpose and the RMSNorm backward in fp32
//     on the raw q/k rows (norm_rope_bwd_tile); dq, dk, dv written as bf16.
//
// What bounds it on an H100: the function needs five products per (query,
// key) pair, 10 * B * H * N^2 * d operations, against about 7 * C * 2 bytes a
// token (qkv and dO read, dqkv written, plus the forward's output): bound by
// operations at N = 1024, by bytes at N = 256. The mma.sync kernel it replaces did nine
// products (a statistics pass re-formed s and dp, and both kernels formed
// them again), on mma.sync, single-buffered, and normalised and rotated every
// streamed q or k tile on each visit (N/64 times per head).
//
// Design: three launches inside one call, in stream order.
//   prologue (fused_attention_sm90.cu): q and k normed and rotated once into
//     the scratch, delta per row; about 8 * C extra bytes a token against
//     the N/64 recomputations it removes;
//   dq kernel, one block per (64-query tile, head, sample): s = qrot krot^T
//     and dp = dO v^T (wgmma, both operands from shared memory), p and ds in
//     registers, dqrot += ds krot (wgmma, ds from registers, krot read
//     MN-major with the transpose flag): three products;
//   dk/dv kernel, one block per (64-key tile, head, sample): s^T = krot qrot^T
//     and dp^T = v dO^T, so p^T and ds^T are born as wgmma A fragments and
//     the row statistics are per-column values; dv += p^T dO and
//     dkrot += ds^T qrot read dO and qrot MN-major: four products.
// Seven products per tile pair. Each block is one warpgroup (but dk/dv at
// d = 192 and 256, below); its streamed
// tiles (K and V for dq; qrot, dO, lse and delta for dk/dv) come by 16-byte
// cp.async into a two-stage ring of 128-byte-swizzled tiles (sm90.cuh), so
// tile j + 1 is in flight while tile j's products run. At d = 64 the dk/dv
// kernel asks for three blocks an SM (at most 168 registers: a 28-byte
// spill), which measured faster on an H100 than two. Tiles past a sample's
// last valid key and tiles wholly outside the window are skipped. The gains'
// gradients are sums over rows, heads and samples: each block writes its
// tile's fp32 partial, summed in a fixed order inside the block, to
// [B, H, tiles, D]; the caller sums that array. No atomics: two runs give the
// same bits.
//
// Head dims 192 and 256 (the JAX kernel takes any multiple of 64). dq keeps
// its layout: the [64, D] fp32 accumulator is 96 / 128 registers a thread
// beside S and dP (32 each), dQ += dS K two wgmma products on K's column
// blocks (sm90.cuh's wgmma_rs), six tiles of shared memory (144 / 192 KB).
// dk/dv cannot: dv and dk together are D registers a thread, 256 before S^T
// and dP^T. So its block is two warpgroups on one 64-key tile
// (fused_bwd_dkv_split_kernel), each holding one accumulator: warpgroup 0
// forms S^T, p^T and dV += P^T dO, warpgroup 1 S^T and p^T again, dP^T,
// ds^T and dK += dS^T Q (five products a tile pair). Handing p^T from
// warpgroup 0 to warpgroup 1 through shared memory (four products) measured
// 1-9% slower on an H100 at 256 and 1024 tokens, and splitting the columns
// of both accumulators (six) slower still (PERF.md): the handoff makes
// warpgroup 1 wait for warpgroup 0's exponentials. A two-stage ring of
// qrot / dO tiles beside the block's K and V: 147 / 195 KB.
// The gain partials of a dk tile are then summed by both warpgroups
// (norm_rope_bwd_tile over 256 threads).
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
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of every tile, on both axes
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // streamed tiles in the ring
constexpr float kDeadLse = 1e30f;


template <int D>
struct TileBytes {
  static constexpr int kOne = kTile * D * 2;                         // one sw128 tile
  static constexpr int kStage = kTile * (D + 4) * 4;                 // fp32 staging of dqrot / dkrot
  static constexpr int kPart = nr_bwd_part_bytes<D, 2 * kThreads>();  // norm_rope_bwd_tile's partials
};

// Zeros for rows [r0, min(r0 + 64, N)) of one head's D channels in a plane of
// dqkv, and for the block's gain partial, over THREADS threads.
template <int D, int THREADS>
__device__ __forceinline__ void write_zero_tile(__nv_bfloat16* plane, long long row_stride, int r0, int N,
                                                float* gain_grad, int tid) {
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kTile * kChunks; i += THREADS) {
    const int n = r0 + i / kChunks;
    if (n < N)
      *reinterpret_cast<uint4*>(plane + (long long)n * row_stride + (i % kChunks) * 8) = make_uint4(0, 0, 0, 0);
  }
  if (gain_grad != nullptr)
    for (int i = tid; i < D; i += THREADS) gain_grad[i] = 0.f;
}

// The live tiles of the other axis for a tile starting at r0: rows at or
// past kv_end hold no valid key and carry a zero cotangent; with a window
// only tiles within sw of the tile's rows. Returns the count, *first the
// first tile.
__device__ __forceinline__ int live_tiles(int r0, int N, int kv_end, int sw, int* first) {
  const int r_last = min(r0 + kTile, N) - 1;
  int lo = 0, hi = kv_end;
  if (sw >= 0) {
    lo = max(0, r0 - sw);
    hi = min(kv_end, r_last + sw + 1);
  }
  if (r0 >= kv_end) hi = lo;
  *first = lo / kTile;
  return hi > lo ? (hi + kTile - 1) / kTile - *first : 0;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  using T = TileBytes<D>;
  static constexpr int kQ = 0;                         // qrot
  static constexpr int kG = kQ + T::kOne;             // dO
  static constexpr int kK = kG + T::kOne;             // kStages krot tiles
  static constexpr int kV = kK + kStages * T::kOne;   // kStages v tiles
  static constexpr int kState = kV + kStages * T::kOne;  // kStages x 64 key states
  static constexpr int kGain = kState + kStages * kTile;  // D floats
  static constexpr int kBytes = kGain + D * 4 + 1024;     // + alignment slack
  // The epilogue reuses the tiles: the fp32 stage over the ring, the gain
  // partials over qrot and dO.
  static constexpr int kStageAt = kK;
  static constexpr int kPartAt = kQ;
  static_assert(T::kStage <= 2 * kStages * T::kOne && T::kPart <= 2 * T::kOne, "epilogue fits");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fused_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,   // [B, N, 3C]
                    const __nv_bfloat16* __restrict__ qk,    // [B, N, 2C] qrot | krot
                    const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t,
                    const unsigned char* __restrict__ mask,  // [B, N] or null
                    const __nv_bfloat16* __restrict__ dout,  // [B, N, C]
                    const float* __restrict__ lse,           // [B, H, N], log2 units
                    const float* __restrict__ delta,         // [B, H, N]
                    __nv_bfloat16* __restrict__ dqkv,        // [B, N, 3C]
                    float* __restrict__ part_q,              // [B, H, tiles, D]
                    int N, int H, int sw, float score_scale, float inv_sqrt_d) {
  using S = DqSmem<D>;
  constexpr int kTB = TileBytes<D>::kOne;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sKvEnd;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sState = smem + S::kState;  // 0 valid, 1 masked, 2 past N
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);

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
  const __nv_bfloat16* q_src = qk + (long long)b * N * 2 * C + h * D;
  const __nv_bfloat16* k_src = q_src + C;
  const __nv_bfloat16* v_src = qkv_b + 2 * C + h * D;
  const __nv_bfloat16* dout_b = dout + (long long)b * N * C + h * D;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long stat_base = ((long long)b * H + h) * N;
  float* part_out = part_q + (((long long)b * H + h) * gridDim.x + blockIdx.x) * D;

  for (int i = tid; i < D; i += kThreads) sGain[i] = q_scale[i];
  block_last_valid<kThreads>(mask_b, N, &sKvEnd, tid);
  int first;
  const int n_tiles = live_tiles(q0, N, sKvEnd, sw, &first);
  if (n_tiles == 0) {  // every query row of the tile is padded
    write_zero_tile<D, kThreads>(dqkv_b + h * D, row_stride, q0, N, part_out, tid);
    return;
  }

  // qrot and dO (padded query rows zeroed), then the ring.
  load_tile_sw128<kTile, D, kThreads>(sQ, q_src, 2LL * C, q0, N, nullptr, tid);
  load_tile_sw128<kTile, D, kThreads>(sG, dout_b, C, q0, N, mask_b, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;  // this thread's two rows inside the tile
  const int qrow0 = q0 + r0;
  const int qrow1 = qrow0 + 8;
  const float lse0 = qrow0 < N ? lse[stat_base + qrow0] : kDeadLse;
  const float lse1 = qrow1 < N ? lse[stat_base + qrow1] : kDeadLse;
  const float dl0 = qrow0 < N ? delta[stat_base + qrow0] : 0.f;
  const float dl1 = qrow1 < N ? delta[stat_base + qrow1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  auto issue = [&](int kt, int stage) {
    const int k0 = kt * kTile;
    load_tile_sw128<kTile, D, kThreads>(sK + stage * kTB, k_src, 2LL * C, k0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kThreads>(sV + stage * kTB, v_src, row_stride, k0, N, nullptr, tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      sState[stage * kTile + tid] = j >= N ? 2 : ((mask_b && !mask_b[j]) ? 1 : 0);
    }
  };

  auto compute = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    const unsigned char* kt = sK + stage * kTB;
    const unsigned char* vt = sV + stage * kTB;
    const unsigned char* st = sState + stage * kTile;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kTile>(sQ, kk), kmajor_desc<kTile>(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<kTile>(sG, kk), kmajor_desc<kTile>(vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const int qrow = (e < 2) ? qrow0 : qrow1;
        float p = exp2f(__fsub_rn(__fmul_rn(s[4 * nt + e], score_scale), e < 2 ? lse0 : lse1));
        if (st[col] != 0 || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) p = 0.f;
        ds[e] = p * (dp[4 * nt + e] - (e < 2 ? dl0 : dl1)) * inv_sqrt_d;
      }
      // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
      dsa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(acc, dsa[j], mnmajor_desc<kTile>(kt, j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  };

  cp_async_ring<kStages>(n_tiles, [&](int i) { return first + i; }, issue, compute);

  // dqrot to the fp32 stage, then through the rotation and norm backward.
  float* stage = reinterpret_cast<float*>(smem + S::kStageAt);
  constexpr int kStageRow = D + 4;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(stage + r0 * kStageRow + col) = make_float2(acc[4 * dt], acc[4 * dt + 1]);
    *reinterpret_cast<float2*>(stage + (r0 + 8) * kStageRow + col) = make_float2(acc[4 * dt + 2], acc[4 * dt + 3]);
  }
  __syncthreads();
  norm_rope_bwd_tile<D, kThreads>(stage, qkv_b + h * D, row_stride, q0, N, sGain, cos_b, sin_b, dqkv_b + h * D,
                                  reinterpret_cast<float*>(smem + S::kPartAt), part_out, tid);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  using T = TileBytes<D>;
  static constexpr int kK = 0;                          // krot
  static constexpr int kV = kK + T::kOne;              // v
  static constexpr int kQ = kV + T::kOne;              // kStages qrot tiles
  static constexpr int kG = kQ + kStages * T::kOne;    // kStages dO tiles
  static constexpr int kLse = kG + kStages * T::kOne;  // kStages x 64 floats
  static constexpr int kDelta = kLse + kStages * kTile * 4;
  static constexpr int kGain = kDelta + kStages * kTile * 4;  // D floats
  static constexpr int kBytes = kGain + D * 4 + 1024;        // + alignment slack
  static constexpr int kStageAt = kQ;
  static constexpr int kPartAt = kK;
  static_assert(T::kStage <= 2 * kStages * T::kOne && T::kPart <= 2 * T::kOne, "epilogue fits");
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)  // d = 64: three blocks an SM
fused_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,   // [B, N, 3C]
                     const __nv_bfloat16* __restrict__ qk,    // [B, N, 2C] qrot | krot
                     const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t,
                     const unsigned char* __restrict__ mask,  // [B, N] or null
                     const __nv_bfloat16* __restrict__ dout,  // [B, N, C]
                     const float* __restrict__ lse,           // [B, H, N], log2 units
                     const float* __restrict__ delta,         // [B, H, N]
                     __nv_bfloat16* __restrict__ dqkv,        // [B, N, 3C]
                     float* __restrict__ part_k,              // [B, H, tiles, D]
                     int N, int H, int sw, float score_scale, float inv_sqrt_d) {
  using S = DkvSmem<D>;
  constexpr int kTB = TileBytes<D>::kOne;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sKvEnd;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * row_stride;
  __nv_bfloat16* dqkv_b = dqkv + (long long)b * N * row_stride;
  const __nv_bfloat16* q_src = qk + (long long)b * N * 2 * C + h * D;
  const __nv_bfloat16* k_src = q_src + C;
  const __nv_bfloat16* dout_b = dout + (long long)b * N * C + h * D;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;
  float* part_out = part_k + (((long long)b * H + h) * gridDim.x + blockIdx.x) * D;

  for (int i = tid; i < D; i += kThreads) sGain[i] = k_scale[i];
  block_last_valid<kThreads>(mask_b, N, &sKvEnd, tid);
  int first;
  const int n_tiles = live_tiles(k0, N, sKvEnd, sw, &first);
  if (n_tiles == 0) {  // no live key in the tile, or no live query that reaches it
    write_zero_tile<D, kThreads>(dqkv_b + C + h * D, row_stride, k0, N, part_out, tid);
    write_zero_tile<D, kThreads>(dqkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
    return;
  }

  load_tile_sw128<kTile, D, kThreads>(sK, k_src, 2LL * C, k0, N, nullptr, tid);
  load_tile_sw128<kTile, D, kThreads>(sV, qkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
  cp_async_commit();

  const int r0 = warp * 16 + g;
  const int krow0 = k0 + r0;  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < N && (mask_b == nullptr || mask_b[krow0]);
  const bool kok1 = krow1 < N && (mask_b == nullptr || mask_b[krow1]);

  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

  auto issue = [&](int qt, int stage) {
    const int qt0 = qt * kTile;
    load_tile_sw128<kTile, D, kThreads>(sQ + stage * kTB, q_src, 2LL * C, qt0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kThreads>(sG + stage * kTB, dout_b, C, qt0, N, mask_b, tid);
    if (tid < 32) {  // 16 copies of four rows' lse, then 16 of their delta (N % 8 == 0)
      const int i = (tid & 15) * 4;
      const bool in = qt0 + i < N;
      const float* src = (tid < 16 ? lse_bh : delta_bh) + (in ? qt0 + i : 0);
      cp_async16((tid < 16 ? sLse : sDelta) + stage * kTile + i, src, in);
    }
  };

  auto compute = [&](int tile, int stage) {
    const int qt0 = tile * kTile;
    const unsigned char* qt = sQ + stage * kTB;
    const unsigned char* gt = sG + stage * kTB;
    const float* sl = sLse + stage * kTile;
    const float* sd = sDelta + stage * kTile;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kTile>(sK, kk), kmajor_desc<kTile>(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<kTile>(sV, kk), kmajor_desc<kTile>(gt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);  // query inside the tile
        const bool kok = (e < 2) ? kok0 : kok1;
        const int krow = (e < 2) ? krow0 : krow1;
        float x = exp2f(__fsub_rn(__fmul_rn(s[4 * nt + e], score_scale), sl[col]));
        if (!kok || qt0 + col >= N || (sw >= 0 && abs(qt0 + col - krow) > sw)) x = 0.f;
        p[e] = x;
        ds[e] = x * (dp[4 * nt + e] - sd[col]) * inv_sqrt_d;
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      dsa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += p^T dO and dkrot += ds^T qrot: dO and qrot read MN-major.
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(dv, pa[j], mnmajor_desc<kTile>(gt, j), 1);
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(dk, dsa[j], mnmajor_desc<kTile>(qt, j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
  };

  cp_async_ring<kStages>(n_tiles, [&](int i) { return first + i; }, issue, compute);

  // dv out; dkrot to the fp32 stage, then through the rotation and norm
  // backward on the raw k rows.
  float* stage = reinterpret_cast<float*>(smem + S::kStageAt);
  constexpr int kStageRow = D + 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = r ? krow1 : krow0;
    float* st = stage + (r0 + 8 * r) * kStageRow + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(st + dt * 8) = make_float2(dk[4 * dt + 2 * r], dk[4 * dt + 2 * r + 1]);
    if (krow >= N) continue;
    __nv_bfloat16* dvp = dqkv_b + (long long)krow * row_stride + 2 * C + h * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
          __floats2bfloat162_rn(dv[4 * dt + 2 * r], dv[4 * dt + 2 * r + 1]);
  }
  __syncthreads();
  norm_rope_bwd_tile<D, kThreads>(stage, qkv_b + C + h * D, row_stride, k0, N, sGain, cos_b, sin_b,
                                  dqkv_b + C + h * D, reinterpret_cast<float*>(smem + S::kPartAt), part_out, tid);
}

// ---------------------------------------------------------------------------
// dk, dv at d = 192 and 256: two warpgroups on one key tile
// ---------------------------------------------------------------------------

template <int D>
struct DkvSplitSmem {
  using T = TileBytes<D>;
  static constexpr int kK = 0;                          // krot
  static constexpr int kV = kK + T::kOne;              // v
  static constexpr int kQ = kV + T::kOne;              // kStages qrot tiles
  static constexpr int kG = kQ + kStages * T::kOne;    // kStages dO tiles
  static constexpr int kLse = kG + kStages * T::kOne;  // kStages x 64 floats
  static constexpr int kDelta = kLse + kStages * kTile * 4;
  static constexpr int kGain = kDelta + kStages * kTile * 4;  // D floats
  static constexpr int kBytes = kGain + D * 4 + 1024;        // + alignment slack
  static constexpr int kStageAt = kQ;  // dkrot's fp32 stage over the ring
  static constexpr int kPartAt = kK;   // the gain partials over krot and v
  static_assert(T::kStage <= 2 * kStages * T::kOne && T::kPart <= 2 * T::kOne, "epilogue fits");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};

// The block of key tile blockIdx.x: warpgroup 0 holds dv, warpgroup 1 dk, and
// each forms S^T and p^T (see the top of the file).
template <int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
fused_bwd_dkv_split_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ qk,
                           const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                           float* __restrict__ part_k, int N, int H, int sw, float score_scale, float inv_sqrt_d) {
  using S = DkvSplitSmem<D>;
  constexpr int kTB = TileBytes<D>::kOne;
  constexpr int kBlockThreads = 2 * kThreads;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sKvEnd;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int wtid = tid % kThreads;
  const int g = (wtid & 31) >> 2;
  const int t = wtid & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * row_stride;
  __nv_bfloat16* dqkv_b = dqkv + (long long)b * N * row_stride;
  const __nv_bfloat16* q_src = qk + (long long)b * N * 2 * C + h * D;
  const __nv_bfloat16* k_src = q_src + C;
  const __nv_bfloat16* dout_b = dout + (long long)b * N * C + h * D;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;
  float* part_out = part_k + (((long long)b * H + h) * gridDim.x + blockIdx.x) * D;

  for (int i = tid; i < D; i += kBlockThreads) sGain[i] = k_scale[i];
  block_last_valid<kBlockThreads>(mask_b, N, &sKvEnd, tid);
  int first;
  const int n_tiles = live_tiles(k0, N, sKvEnd, sw, &first);
  if (n_tiles == 0) {  // no live key in the tile, or no live query that reaches it
    write_zero_tile<D, kBlockThreads>(dqkv_b + C + h * D, row_stride, k0, N, part_out, tid);
    write_zero_tile<D, kBlockThreads>(dqkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
    return;
  }

  load_tile_sw128<kTile, D, kBlockThreads>(sK, k_src, 2LL * C, k0, N, nullptr, tid);
  load_tile_sw128<kTile, D, kBlockThreads>(sV, qkv_b + 2 * C + h * D, row_stride, k0, N, nullptr, tid);
  cp_async_commit();

  const int r0 = (wtid >> 5) * 16 + g;
  const int krow0 = k0 + r0;  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < N && (mask_b == nullptr || mask_b[krow0]);
  const bool kok1 = krow1 < N && (mask_b == nullptr || mask_b[krow1]);

  // Warpgroup 0 holds dv, warpgroup 1 dkrot.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  auto issue = [&](int qt, int stage) {
    const int qt0 = qt * kTile;
    load_tile_sw128<kTile, D, kBlockThreads>(sQ + stage * kTB, q_src, 2LL * C, qt0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sG + stage * kTB, dout_b, C, qt0, N, mask_b, tid);
    if (tid < 32) {  // 16 copies of four rows' lse, then 16 of their delta (N % 8 == 0)
      const int i = (tid & 15) * 4;
      const bool in = qt0 + i < N;
      const float* src = (tid < 16 ? lse_bh : delta_bh) + (in ? qt0 + i : 0);
      cp_async16((tid < 16 ? sLse : sDelta) + stage * kTile + i, src, in);
    }
  };

  auto compute = [&](int tile, int stage) {
    const int qt0 = tile * kTile;
    const unsigned char* qt = sQ + stage * kTB;
    const unsigned char* gt = sG + stage * kTB;
    const float* sl = sLse + stage * kTile;
    const float* sd = sDelta + stage * kTile;
    // p^T at element e of column group nt (the wgmma C fragment) from its logit.
    auto p_of = [&](float sv, int nt, int e) {
      const int col = nt * 8 + 2 * t + (e & 1);  // query inside the tile
      const int krow = (e < 2) ? krow0 : krow1;
      float x = exp2f(__fsub_rn(__fmul_rn(sv, score_scale), sl[col]));
      if (!((e < 2) ? kok0 : kok1) || qt0 + col >= N || (sw >= 0 && abs(qt0 + col - krow) > sw)) x = 0.f;
      return x;
    };
    uint32_t xa[kTile / 16][4];
    if (wg == 0) {  // S^T = krot qrot^T, p^T; dv += p^T dO
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc<kTile>(sK, kk), kmajor_desc<kTile>(qt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * nt + e] = p_of(s[4 * nt + e], nt, e);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        xa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[4 * nt + 0], s[4 * nt + 1]);
        xa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(acc, xa[j], mnmajor_desc<kTile>(gt, j), 1);
    } else {  // S^T and p^T again; dP^T = v dO^T, ds^T = p^T (dp^T - delta) / sqrt(d); dkrot += ds^T qrot
      float dp[32], s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, kmajor_desc<kTile>(sV, kk), kmajor_desc<kTile>(gt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, kmajor_desc<kTile>(sK, kk), kmajor_desc<kTile>(qt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      fence_regs(s);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + 2 * t + (e & 1);
          ds[e] = p_of(s[4 * nt + e], nt, e) * (dp[4 * nt + e] - sd[col]) * inv_sqrt_d;
        }
        xa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        xa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(acc, xa[j], mnmajor_desc<kTile>(qt, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  };

  cp_async_ring<kStages>(n_tiles, [&](int i) { return first + i; }, issue, compute);

  // dv out (warpgroup 0); dkrot (warpgroup 1) to the fp32 stage, then both
  // warpgroups through the rotation and norm backward on the raw k rows.
  float* stage = reinterpret_cast<float*>(smem + S::kStageAt);
  constexpr int kStageRow = D + 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = r ? krow1 : krow0;
    if (wg == 1) {
      float* st = stage + (r0 + 8 * r) * kStageRow + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<float2*>(st + dt * 8) = make_float2(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
    } else if (krow < N) {
      __nv_bfloat16* dvp = dqkv_b + (long long)krow * row_stride + 2 * C + h * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
            __floats2bfloat162_rn(acc[4 * dt + 2 * r], acc[4 * dt + 2 * r + 1]);
    }
  }
  __syncthreads();
  norm_rope_bwd_tile<D, kBlockThreads>(stage, qkv_b + C + h * D, row_stride, k0, N, sGain, cos_b, sin_b,
                                       dqkv_b + C + h * D, reinterpret_cast<float*>(smem + S::kPartAt), part_out,
                                       tid);
}

template <int D, typename Kernel>
cudaError_t launch_one(Kernel kernel, int threads, int smem, dim3 grid, cudaStream_t stream, const void* qkv,
                       const void* qk, const void* gain, const void* cos_t, const void* sin_t, const void* mask,
                       const void* dout, const void* lse, const void* delta, void* dqkv, void* part, int N, int H,
                       int sw) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float inv_sqrt_d = (float)(1.0 / std::sqrt((double)D));
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(qk), static_cast<const float*>(gain),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(part), N, H, sw, score_scale, inv_sqrt_d);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* qkv, const void* qk, const void* q_scale, const void* k_scale, const void* cos_t,
                   const void* sin_t, const void* mask, const void* dout, const void* lse, const void* delta,
                   void* dqkv, void* part_q, void* part_k, int B, int N, int H, int sw, cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, H, B);
  cudaError_t err = launch_one<D>(fused_bwd_dq_kernel<D>, kThreads, DqSmem<D>::kBytes, grid, stream, qkv, qk,
                                  q_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_q, N, H, sw);
  if (err != cudaSuccess) return err;
  if constexpr (D <= 128) {
    return launch_one<D>(fused_bwd_dkv_kernel<D>, kThreads, DkvSmem<D>::kBytes, grid, stream, qkv, qk, k_scale,
                         cos_t, sin_t, mask, dout, lse, delta, dqkv, part_k, N, H, sw);
  } else {
    return launch_one<D>(fused_bwd_dkv_split_kernel<D>, 2 * kThreads, DkvSplitSmem<D>::kBytes, grid, stream, qkv,
                         qk, k_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_k, N, H, sw);
  }
}

// The kernel of vitok_fused_bwd_attributes' arguments, its threads and its
// dynamic shared memory.
template <int D>
void pick_kernel(int which, const void** fn, int* threads, int* smem) {
  if (which == 0) {
    *fn = (const void*)fused_bwd_dq_kernel<D>;
    *smem = DqSmem<D>::kBytes;
  } else if constexpr (D <= 128) {
    *fn = (const void*)fused_bwd_dkv_kernel<D>;
    *smem = DkvSmem<D>::kBytes;
  } else {
    *fn = (const void*)fused_bwd_dkv_split_kernel<D>;
    *threads = 2 * kThreads;
    *smem = DkvSplitSmem<D>::kBytes;
  }
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; qk [B, N, 2*H*D] bf16 and delta [B, H, N] f32 from
// the prologue (vitok_fused_qk_prologue_bf16); q_scale, k_scale [D] f32;
// cos, sin [B, N, D/2] f32; mask [B, N] bool bytes or null; dout
// [B, N, H*D] bf16, contiguous; lse [B, H, N] f32 from the forward. Writes
// dqkv [B, N, 3*H*D] bf16 and the gain gradients' partials part_q, part_k
// [B, H, ceil(N / 64), D] f32 (the caller sums them over the first three
// axes). sw < 0: no window. Returns the cudaError_t of the launches
// (0 = success).
int vitok_fused_attention_bwd_bf16(const void* qkv, const void* qk, const void* q_scale, const void* k_scale,
                                   const void* cos_t, const void* sin_t, const void* mask, const void* dout,
                                   const void* lse, const void* delta, void* dqkv, void* part_q, void* part_k,
                                   int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(qkv, qk, q_scale, k_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_q, part_k, B,
                      N, H, sw, s);
  if (D == 128)
    return launch<128>(qkv, qk, q_scale, k_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_q, part_k,
                       B, N, H, sw, s);
  if (D == 192)
    return launch<192>(qkv, qk, q_scale, k_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_q, part_k,
                       B, N, H, sw, s);
  if (D == 256)
    return launch<256>(qkv, qk, q_scale, k_scale, cos_t, sin_t, mask, dout, lse, delta, dqkv, part_q, part_k,
                       B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory (spills) a thread, blocks an SM and shared
// memory a block of the dq (which = 0) or dk/dv (1) kernel at head dim D,
// as the compiler and the card report them: out[0..3].
int vitok_fused_bwd_attributes(int which, int D, int* out) {
  const void* fn = nullptr;
  int threads = kThreads, smem = 0;
  if (D == 64) pick_kernel<64>(which, &fn, &threads, &smem);
  if (D == 128) pick_kernel<128>(which, &fn, &threads, &smem);
  if (D == 192) pick_kernel<192>(which, &fn, &threads, &smem);
  if (D == 256) pick_kernel<256>(which, &fn, &threads, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = smem + (int)attr.sharedSizeBytes;
  return 0;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
