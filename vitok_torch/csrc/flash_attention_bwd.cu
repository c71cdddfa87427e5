// Flash attention backward over NaFlex token sequences: dq in one kernel,
// dk and dv in another, both recomputing p = exp(s - lse) tile by tile from
// the log-sum-exp the forward saved, with the forward's key-side patch mask,
// sliding window |i - j| <= sw and block skipping.
//
// Replaces the TPU kernels vitok_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (launcher _flash_bwd). Same function and the same rounding
// points:
//   * the cotangent dO is zeroed on padded query rows before anything else;
//   * qs = bf16(float(q) * (1/sqrt(d))); s = qs k^T in fp32;
//   * p = exp(s - lse) with the natural-log lse of the forward, computed here
//     as exp2(s * log2(e) - lse * log2(e)) with lse * log2(e) taken once per
//     row; masked keys, pairs outside the window and keys past N give p = 0;
//     a row with no live key carries lse = +1e30, so its p is exactly 0;
//   * dp = dO v^T in fp32; delta = sum_d dO * O in fp32; ds = p * (dp - delta);
//   * p and ds are rounded to bf16 before the products that contract them:
//     dq = scale * ds k, dv = p^T dO, dk = scale * ds^T q, where dk contracts
//     the unscaled q; fp32 accumulators, bf16 on the way out.
// The TPU kernels recompute delta per tile in both kernels; here a small
// prologue kernel computes it once into an fp32 [B, H, N] buffer that both
// read: the value is the same. The TPU grid walks key (query) blocks in
// order with the accumulators in scratch memory; here each block owns one
// (sample, head, 64-row tile), loops over the other axis itself and keeps
// its accumulators in registers. Two kernels with private accumulators and
// no atomics: results do not change from run to run.
//
// What bounds them on an H100: operations. dq does three products per live
// (query, key) pair (s, dp, ds k), dk/dv four (s, dp, p^T dO, ds^T q), 2 * d
// flops each, against q, k, v, dO read once and one or two outputs written.
// This version runs mma.sync m16n8k16 (about half of wgmma's rate) and whole
// 64 x 64 tiles at the window's edges. What it does do: no [N, N] array in
// device memory; the streamed tiles double-buffered through cp.async; every
// tile outside the block's live range skipped (dq: keys in
// [max(0, q0 - sw), min(valid, q_last + sw + 1)); dk/dv: queries in
// [max(0, k0 - sw), min(valid, k_last + sw + 1))), with the per-sample counts
// of the forward; "easy" tiles skip the per-element mask; key tiles at or
// past a sample's valid count load nothing and write zeros.
//
// dq design: as the forward. One block per (64-query tile, head, sample),
// four warps of 16 query rows; the prescaled Q tile and the dO tile stay in
// shared memory, K/V tiles stream through a two-stage ring. ds comes out of
// the s/dp accumulators in the A-fragment layout; K feeds ds k through
// ldmatrix.trans.
//
// dk/dv design: one block per (64-key tile, head, sample). It computes the
// transposed logits s^T = k qs^T and dp^T = v dO^T, so p^T and ds^T are born
// in the A-fragment layout and lse and delta are per-column values read from
// shared memory; dO and the unscaled q feed the two output products as B
// operands through ldmatrix.trans. The streamed Q tile is kept twice, as it
// came (for dk) and prescaled (for s^T). At d = 128 the two [16, 128] fp32
// accumulators of a warp would take 128 registers a thread, so eight warps
// run: each group of four takes one 64-channel half of dk and dv and
// recomputes s^T and dp^T for its rows.
//
// Shared memory (dynamic, above the 48 KB default; the launch sets the
// attribute): dq 6 tiles, 104 KB at d = 128; dk/dv 7 tiles, 122 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; launches are asynchronous on the caller's stream and each
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;  // rows of every tile, on both axes
constexpr int kPad = 8;    // bf16 row padding: conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadLse = 1e30f;

struct Strides {  // elements between samples, tokens and heads
  long long b, n, h;
};

// 64 rows of D channels from `src` (row stride `stride_n`, first row `row0`)
// into shared memory, 16 bytes a copy. Rows at or past N, and rows whose
// byte in `rowmask` (indexed by absolute row; may be null) is 0, are
// zero-filled and not read.
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

// bf16(float(x) * scale) on eight packed values.
__device__ __forceinline__ uint4 scale_bf16x8(uint4 x, float scale) {
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x2[e]);
    x2[e] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
  }
  return x;
}

// ---------------------------------------------------------------------------
// delta[b, h, n] = sum_d dO * O in fp32, 0 on padded query rows.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                       const __nv_bfloat16* __restrict__ out, Strides gs, Strides os,
                       const unsigned char* __restrict__ mask,  // [B, N] or null
                       float* __restrict__ delta,               // [B, H, N]
                       int B, int N, int H, int D) {
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * N * H) return;
  const int h = (int)(row % H);
  const long long bn = row / H;
  const int n = (int)(bn % N);
  const int b = (int)(bn / N);
  float sum = 0.f;
  if (mask == nullptr || mask[bn]) {
    const __nv_bfloat16* g = dout + b * gs.b + n * gs.n + h * gs.h;
    const __nv_bfloat16* o = out + b * os.b + n * os.n + h * os.h;
    for (int c = lane * 2; c < D; c += 64) {
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
      sum = fmaf(gf.x, of.x, sum);
      sum = fmaf(gf.y, of.y, sum);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[((long long)b * H + h) * N + n] = sum;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct SmemDq {
  static constexpr int kRow = D + kPad;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kQ = 0;                          // prescaled Q tile
  static constexpr size_t kG = kQ + kTileBytes;            // dO tile
  static constexpr size_t kK = kG + kTileBytes;            // two K tiles
  static constexpr size_t kV = kK + 2 * kTileBytes;        // two V tiles
  static constexpr size_t kLse = kV + 2 * kTileBytes;      // 64 x lse * log2(e)
  static constexpr size_t kDelta = kLse + sizeof(float) * kTile;
  static constexpr size_t kOk = kDelta + sizeof(float) * kTile;  // two rows of key-valid bytes
  static constexpr size_t kBytes = kOk + 2 * kTile;
};

template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    Strides qs, Strides ks, Strides vs, Strides gs,
                    const float* __restrict__ lse,           // [B, H, N]
                    const float* __restrict__ delta,         // [B, H, N]
                    const unsigned char* __restrict__ mask,  // [B, N] or null
                    const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                    __nv_bfloat16* __restrict__ dq,          // [B, N, H, D]
                    int B, int N, int H, int sw, float scale) {
  using S = SmemDq<D>;
  constexpr int kThreads = 128;
  constexpr int kRow = S::kRow;
  constexpr int kChunks = D / 8;
  constexpr int kTileElems = kTile * kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + S::kG);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  unsigned char* sOk = smem + S::kOk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long row_base = ((long long)b * H + h) * N;

  // Live key range of this query tile, as in the forward. A tile whose rows
  // all lie at or past `valid` has a zero cotangent: nothing to load.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  const int q_last = min(q0 + kTile, N) - 1;
  int lo = 0, hi = valid;
  if (sw >= 0) {
    lo = max(0, q0 - sw);
    hi = min(valid, q_last + sw + 1);
  }
  if (q0 >= valid) hi = lo;
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kTile;
    load_tile_async<D, kThreads>(sK + buf * kTileElems, k_b, ks.n, k0, N, nullptr, tid);
    load_tile_async<D, kThreads>(sV + buf * kTileElems, v_b, vs.n, k0, N, nullptr, tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      sOk[buf * kTile + tid] = (j < N && (mask_b == nullptr || mask_b[j])) ? 1 : 0;
    }
    cp_async_commit();
  };

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (n_tiles > 0) {
    // dO with padded query rows zeroed, in one group with the first K/V tile.
    load_tile_async<D, kThreads>(sG, g_b, gs.n, q0, N, mask_b, tid);
    load_kv(lo_tile, 0);
    // Q prescaled in bf16 as the TPU kernel does; rows past N are zeros.
#pragma unroll
    for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int row = i / kChunks;
      const int ch = (i % kChunks) * 8;
      const int n = q0 + row;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (n < N) x = scale_bf16x8(*reinterpret_cast<const uint4*>(q_b + n * qs.n + ch), scale);
      *reinterpret_cast<uint4*>(sQ + row * kRow + ch) = x;
    }
    if (tid < kTile) {
      const int n = q0 + tid;
      sLse[tid] = __fmul_rn(n < N ? lse[row_base + n] : kDeadLse, kLog2e);
      sDelta[tid] = n < N ? delta[row_base + n] : 0.f;
    }
  }

  const int qrow0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int qrow1 = qrow0 + 8;
  const int r0 = warp * 16 + g;
  // This lane's ldmatrix row address inside a 16-key x 16-channel block of K.
  const int m_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int m_col = (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = (lo_tile + it) * kTile;
    if (it + 1 < n_tiles) {
      load_kv(lo_tile + it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + buf * kTileElems;
    const __nv_bfloat16* cV = sV + buf * kTileElems;
    const unsigned char* cOk = sOk + buf * kTile;

    // s = qs k^T and dp = dO v^T for this warp's 16 rows x 64 keys.
    float s[kTile / 8][4], dp[kTile / 8][4];
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
        const __nv_bfloat16* krow = cK + (nt * 8 + g) * kRow + c0;
        const __nv_bfloat16* vrow = cV + (nt * 8 + g) * kRow + c0;
        mma_bf16(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
        mma_bf16(dp[nt], ga, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }

    // An "easy" tile has every key valid and every pair inside the window.
    const bool easy = k0 + kTile <= lead &&
                      (sw < 0 || (k0 + kTile - 1 - q0 <= sw && q_last - k0 <= sw));
    const float l0 = sLse[r0], l1 = sLse[r0 + 8];
    const float d0 = sDelta[r0], d1 = sDelta[r0 + 8];
    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nt][e], kLog2e, e < 2 ? -l0 : -l1));
        if (!easy) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int qrow = (e < 2) ? qrow0 : qrow1;
          if (!cOk[col] || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) p = 0.f;
        }
        ds[e] = p * (dp[nt][e] - (e < 2 ? d0 : d1));
      }
      // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
      const int j = nt >> 1;
      const int hi2 = (nt & 1) * 2;
      dsa[j][hi2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j][hi2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += ds k: one ldmatrix.x4.trans gives the B fragments of two
    // 8-channel tiles for one 16-key step.
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, cK + (j * 16 + m_key) * kRow + dt * 8 + m_col);
        mma_bf16(acc[dt], dsa[j], kb[0], kb[1]);
        mma_bf16(acc[dt + 1], dsa[j], kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = r ? qrow1 : qrow0;
    if (qrow >= N) continue;
    __nv_bfloat16* dst = dq + (((long long)b * N + qrow) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(
          __fmul_rn(acc[dt][2 * r], scale), __fmul_rn(acc[dt][2 * r + 1], scale));
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct SmemDkv {
  static constexpr int kRow = D + kPad;
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kK = 0;                          // this block's K tile
  static constexpr size_t kV = kK + kTileBytes;            // and V tile
  static constexpr size_t kQ = kV + kTileBytes;            // two Q tiles, as they came
  static constexpr size_t kG = kQ + 2 * kTileBytes;        // two dO tiles
  static constexpr size_t kQs = kG + 2 * kTileBytes;       // the current Q tile, prescaled
  static constexpr size_t kLse = kQs + kTileBytes;         // two rows of 64 x lse * log2(e)
  static constexpr size_t kDelta = kLse + 2 * sizeof(float) * kTile;
  static constexpr size_t kBytes = kDelta + 2 * sizeof(float) * kTile;
};

template <int D>
__global__ void __launch_bounds__(128 * (D / 64))
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     Strides qs, Strides ks, Strides vs, Strides gs,
                     const float* __restrict__ lse,           // [B, H, N]
                     const float* __restrict__ delta,         // [B, H, N]
                     const unsigned char* __restrict__ mask,  // [B, N] or null
                     const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                     __nv_bfloat16* __restrict__ dk,          // [B, N, H, D]
                     __nv_bfloat16* __restrict__ dv,          // [B, N, H, D]
                     int B, int N, int H, int sw, float scale) {
  using S = SmemDkv<D>;
  constexpr int kSplit = D / 64;  // groups of four warps, one 64-channel half each
  constexpr int kThreads = 128 * kSplit;
  constexpr int kRow = S::kRow;
  constexpr int kChunks = D / 8;
  constexpr int kTileElems = kTile * kRow;
  constexpr int kOutTiles = 8;  // 8-channel output tiles per warp (64 channels)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + S::kG);
  __nv_bfloat16* sQs = reinterpret_cast<__nv_bfloat16*>(smem + S::kQs);
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp & 3;       // which 16 key rows
  const int half = warp >> 2;    // which 64 output channels
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long row_base = ((long long)b * H + h) * N;

  // Live query range of this key tile. Query rows at or past `valid` carry a
  // zero cotangent and are skipped; a key tile at or past `valid` holds no
  // live key, loads nothing and writes zeros.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  const int k_last = min(k0 + kTile, N) - 1;
  int lo = 0, hi = valid;
  if (sw >= 0) {
    lo = max(0, k0 - sw);
    hi = min(valid, k_last + sw + 1);
  }
  if (k0 >= valid) hi = lo;
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  const int r0 = wr * 16 + g;
  const int krow0 = k0 + r0;  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < N && (mask_b == nullptr || mask_b[krow0]);
  const bool kok1 = krow1 < N && (mask_b == nullptr || mask_b[krow1]);

  auto load_q = [&](int qt, int buf) {
    const int qt0 = qt * kTile;
    load_tile_async<D, kThreads>(sQ + buf * kTileElems, q_b, qs.n, qt0, N, nullptr, tid);
    // dO with padded query rows zeroed.
    load_tile_async<D, kThreads>(sG + buf * kTileElems, g_b, gs.n, qt0, N, mask_b, tid);
    if (tid < kTile) {
      const int n = qt0 + tid;
      sLse[buf * kTile + tid] = __fmul_rn(n < N ? lse[row_base + n] : kDeadLse, kLog2e);
      sDelta[buf * kTile + tid] = n < N ? delta[row_base + n] : 0.f;
    }
    cp_async_commit();
  };

  float dk_acc[kOutTiles][4], dv_acc[kOutTiles][4];
#pragma unroll
  for (int i = 0; i < kOutTiles; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  if (n_tiles > 0) {
    // K and V of this block, in one group with the first Q/dO tiles.
    load_tile_async<D, kThreads>(sK, k_b, ks.n, k0, N, nullptr, tid);
    load_tile_async<D, kThreads>(sV, v_b, vs.n, k0, N, nullptr, tid);
    load_q(lo_tile, 0);
  }

  // This lane's ldmatrix row address inside a 16-query x 16-channel block.
  const int m_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int m_col = (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int qt0 = (lo_tile + it) * kTile;
    if (it + 1 < n_tiles) {
      load_q(lo_tile + it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + buf * kTileElems;
    const __nv_bfloat16* cG = sG + buf * kTileElems;
    const float* cLse = sLse + buf * kTile;
    const float* cDelta = sDelta + buf * kTile;

    // The prescaled copy of this Q tile, bf16(float(q) * scale).
#pragma unroll
    for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int off = (i / kChunks) * kRow + (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(sQs + off) =
          scale_bf16x8(*reinterpret_cast<const uint4*>(cQ + off), scale);
    }
    __syncthreads();

    // s^T = k qs^T and dp^T = v dO^T for this warp's 16 key rows x 64 queries.
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
        const __nv_bfloat16* qrow = sQs + (nt * 8 + g) * kRow + c0;
        const __nv_bfloat16* grow = cG + (nt * 8 + g) * kRow + c0;
        mma_bf16(s[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
        mma_bf16(dp[nt], va, ld_u32(grow), ld_u32(grow + 8));
      }
    }

    // An "easy" tile has every key valid and every pair inside the window.
    const bool easy = k0 + kTile <= lead &&
                      (sw < 0 || (qt0 + kTile - 1 - k0 <= sw && k0 + kTile - 1 - qt0 <= sw));
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);  // query inside the tile
        float x = exp2f(fmaf(s[nt][e], kLog2e, -cLse[col]));
        if (!easy) {
          const bool kok = (e < 2) ? kok0 : kok1;
          const int krow = (e < 2) ? krow0 : krow1;
          if (!kok || (sw >= 0 && abs(qt0 + col - krow) > sw)) x = 0.f;
        }
        p[e] = x;
        ds[e] = x * (dp[nt][e] - cDelta[col]);
      }
      const int j = nt >> 1;
      const int hi2 = (nt & 1) * 2;
      pa[j][hi2 + 0] = pack_bf16(p[0], p[1]);
      pa[j][hi2 + 1] = pack_bf16(p[2], p[3]);
      dsa[j][hi2 + 0] = pack_bf16(ds[0], ds[1]);
      dsa[j][hi2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dv += p^T dO and dk += ds^T q over this warp's 64 channels; dO and the
    // unscaled q are B operands, read by ldmatrix.trans.
#pragma unroll
    for (int dt = 0; dt < kOutTiles; dt += 2) {
      const int ch = (half * kOutTiles + dt) * 8 + m_col;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, cG + (j * 16 + m_row) * kRow + ch);
        mma_bf16(dv_acc[dt], pa[j], gb[0], gb[1]);
        mma_bf16(dv_acc[dt + 1], pa[j], gb[2], gb[3]);
        ldmatrix_x4_trans(qb, cQ + (j * 16 + m_row) * kRow + ch);
        mma_bf16(dk_acc[dt], dsa[j], qb[0], qb[1]);
        mma_bf16(dk_acc[dt + 1], dsa[j], qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` and sQs before they are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int krow = r ? krow1 : krow0;
    if (krow >= N) continue;
    const long long off = (((long long)b * N + krow) * H + h) * D + half * 64 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8) = __floats2bfloat162_rn(
          __fmul_rn(dk_acc[dt][2 * r], scale), __fmul_rn(dk_acc[dt][2 * r + 1], scale));
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8) =
          __floats2bfloat162_rn(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline float q_scale_of(int D) { return (float)(1.0 / std::sqrt((double)D)); }

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, Strides qs, Strides ks, Strides vs, Strides gs, Strides os,
                      const void* lse, const void* mask, const void* counts, void* delta,
                      void* dq, int B, int N, int H, int sw, cudaStream_t stream) {
  const long long rows = (long long)B * N * H;
  const int warps = 8;
  flash_bwd_delta_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out), gs, os,
      static_cast<const unsigned char*>(mask), static_cast<float*>(delta), B, N, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = SmemDq<D>::kBytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), qs, ks, vs,
      gs, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const unsigned char*>(mask), static_cast<const int*>(counts),
      static_cast<__nv_bfloat16*>(dq), B, N, H, sw, q_scale_of(D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, Strides qs,
                       Strides ks, Strides vs, Strides gs, const void* lse, const void* delta,
                       const void* mask, const void* counts, void* dk, void* dv, int B, int N,
                       int H, int sw, cudaStream_t stream) {
  const size_t smem = SmemDkv<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kTile - 1) / kTile, H, B);
  flash_bwd_dkv_kernel<D><<<grid, 128 * (D / 64), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), qs, ks, vs,
      gs, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const unsigned char*>(mask), static_cast<const int*>(counts),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, N, H, sw,
      q_scale_of(D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout (the cotangent of the forward's output) and out (the
// forward's output): [B, N, H, D] bf16 with unit channel stride and the given
// sample, token and head strides (elements, multiples of 8; 16-byte aligned
// bases). lse [B, H, N] f32 from the forward (natural log, +1e30 on rows with
// no live key); mask [B, N] bool bytes or null; counts [2, B] int32 (one past
// the last valid key, then the number of leading valid keys) or null when
// mask is. sw < 0: no window. Each returns the cudaError_t of its launches
// (0 = success).

// Writes delta [B, H, N] f32 (sum_d dout * out, 0 on padded query rows) and
// dq [B, N, H, D] bf16 contiguous.
int vitok_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* out,
                            long long q_sb, long long q_sn, long long q_sh,
                            long long k_sb, long long k_sn, long long k_sh,
                            long long v_sb, long long v_sn, long long v_sh,
                            long long g_sb, long long g_sn, long long g_sh,
                            long long o_sb, long long o_sn, long long o_sh,
                            const void* lse, const void* mask, const void* counts, void* delta,
                            void* dq, int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const Strides gs{g_sb, g_sn, g_sh}, os{o_sb, o_sn, o_sh};
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, out, qs, ks, vs, gs, os, lse, mask, counts, delta, dq,
                         B, N, H, sw, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, out, qs, ks, vs, gs, os, lse, mask, counts, delta, dq,
                          B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// Reads the delta that vitok_flash_bwd_dq_bf16 wrote; writes dk and dv
// [B, N, H, D] bf16 contiguous (rows at or past a sample's valid count 0).
int vitok_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                             long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh,
                             long long v_sb, long long v_sn, long long v_sh,
                             long long g_sb, long long g_sn, long long g_sh,
                             const void* lse, const void* delta, const void* mask,
                             const void* counts, void* dk, void* dv, int B, int N, int H, int D,
                             int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const Strides gs{g_sb, g_sn, g_sh};
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, dv, B, N,
                          H, sw, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, dv, B,
                           N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
