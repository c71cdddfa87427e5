// Flash attention backward over NaFlex token sequences: dq in one kernel,
// dk and dv in another, both recomputing p = exp(s - lse) tile by tile from
// the log-sum-exp the forward saved, with the forward's key-side patch mask,
// sliding window |i - j| <= sw and block skipping; and the same two kernels
// in a "fold" mode that ends in the q/k RMSNorm and RoPE backward.
//
// Replaces the TPU kernels vitok_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (launcher _flash_bwd). Same function and the same rounding
// points:
//   * the cotangent dO is zeroed on padded query rows before anything else;
//   * qs = bf16(float(q) * (1/sqrt(d))); s = qs k^T in fp32;
//   * p = exp(s - lse) with the natural-log lse of the forward, computed here
//     as ex2.approx.ftz(fma(s, log2(e), -lse * log2(e))) with lse * log2(e)
//     taken once per row; masked keys, pairs outside the window and keys
//     past N give p = 0; a row with no live key carries lse = +1e30, so its
//     p is exactly 0;
//   * dp = dO v^T in fp32; delta = sum_d dO * O in fp32; ds = p * (dp - delta);
//   * p and ds are rounded to bf16 before the products that contract them:
//     dq = scale * ds k, dv = p^T dO, dk = scale * ds^T q, where dk contracts
//     the unscaled q; fp32 accumulators, bf16 on the way out.
// The TPU kernels recompute delta per tile in both kernels; here it is
// computed once into an fp32 [B, H, N] buffer that both read (by the dq
// kernel for its rows; in the fold, by the q/k prologue): the value is the
// same. The TPU grid walks key (query) blocks in order with the
// accumulators in scratch memory; here each warpgroup owns one 64-row tile
// of (sample, head), loops over the other axis itself and keeps its
// accumulators in registers. Two kernels with private accumulators and no
// atomics: results do not change from run to run.
//
// The fold (high-resolution training, ops/fused_attention.py
// _FlashQKVAttention): q and k are the q/k prologue's normed and rotated
// qrot and krot (views of its [B, N, 2C] scratch), v and the outputs views
// of the flat [B, N, 3C] qkv and dqkv. The dq kernel's dqrot and the dk/dv
// kernel's dkrot stay in fp32 and go through the rotation's transpose and
// the RMSNorm backward on the raw q or k rows (norm_rope_bwd_tile of
// norm_rope.cuh, as fused_attention_bwd.cu does), straight into dqkv; the
// gains' gradients leave as per-tile fp32 partials [B, H, tiles, D] that
// the caller sums in a fixed order. dv goes to dqkv's v plane.
//
// What bounds them on an H100: operations. dq does three products per live
// (query, key) pair (s, dp, ds k), dk/dv four (s, dp, p^T dO, ds^T q), 2 * d
// flops each, against q, k, v, dO read once and one or two outputs written:
// 350M at 2048p with sw = 1024 is 0.20 ms (dq) and 0.27 ms (dk/dv) at
// 989 TFLOP/s. Beside the products each pair costs an exp2 on the special
// function units and a few fp32 operations, which at d = 64 take about as
// long as the products (the flash forward's finding, PERF.md).
//
// Design (the wgmma products of fused_attention_bwd.cu, the ring and
// softmax of flash_attention.cu):
//   * dq: each consumer warpgroup of a block owns one 64-query tile; one
//     warpgroup a block at d = 64 (three blocks an SM), two at d = 128.
//     S = Qs K^T and dP = dO V^T are wgmma m64n64k16 with both operands from
//     shared memory; p and ds stay in registers; dQ += dS K is wgmma with
//     dS from registers as A and K read MN-major. The prescaled Q tiles and
//     the dO tiles stay resident; K/V stream through the ring.
//   * dk/dv: two warpgroups a block, each one 64-key tile. S^T = K Qs^T and
//     dP^T = V dO^T, so p^T and ds^T are born as wgmma A fragments and lse
//     and delta are per-column values; dV += P^T dO and dK += dS^T Q read dO
//     and the unscaled Q MN-major. Four products a pair at both head dims.
//     At d = 128 the two [64, 128] fp32 accumulators are 128 registers a
//     thread and S^T and dP^T 64 more: the warpgroup holds all four (one
//     block an SM; forming S^T and dP^T in 32-column halves to free
//     registers measured slower, PERF.md). At d = 64, 1/sqrt(d) = 1/8 is a
//     power of two, so bf16(q / 8) k^T = (q k^T) / 8 exactly: S^T reads the
//     streamed Q as it came and the scale folds into the exponent's fma; at
//     d = 128 each streamed Q tile is prescaled once into a tile of its own.
//   * Both: a three-stage ring of 128-byte-swizzled tiles (sm90.cuh) filled
//     by cp.async from all of the block's threads, so tiles j + 1 and j + 2
//     are in flight while tile j's products run and each streamed tile is
//     read from L2 once per kGroups x 64 rows. The block walks the union of
//     its warpgroups' live ranges (dq: keys in [max(0, q0 - sw),
//     min(valid, q_last + sw + 1)); dk/dv: queries in [max(0, k0 - sw),
//     min(valid, k_last + sw + 1))) with the per-sample counts; rows at or
//     past a sample's valid count carry no cotangent and are never walked;
//     a warpgroup skips the products of a tile outside its own range. An
//     "easy" tile (every key valid, every pair inside the window) selects
//     nothing; any other tile selects from a 64-bit mask of its live
//     columns: no branch per element.
//   * Head dims 192 and 256 (the JAX kernels take any multiple of 64): one
//     sw128 tile is 24 / 32 KB, so the rings are shallower. dq: two
//     warpgroups on a two-stage ring at d = 192, one on two stages at
//     d = 256 (192 KB either way; DqSmem), dQ += dS K two wgmma products on
//     K's column blocks (sm90.cuh's wgmma_rs). dk/dv: dk and dv together are
//     D fp32 registers a thread, 256 before S^T and dP^T, so no warpgroup
//     holds both: one 64-key tile a block, two warpgroups, warpgroup 0
//     holding dv and warpgroup 1 dk (flash_bwd_dkv_split_kernel), on a
//     two-stage Q / dO ring. Warpgroup 1 takes p^T from warpgroup 0 through
//     shared memory and a named barrier: four products a pair, as at d 64 /
//     128 (forming S^T again in warpgroup 1, five, or splitting the columns
//     of both accumulators, six, measured 3-19% slower on an H100, PERF.md).
//     At d = 256 1/sqrt(d) = 1/16, so as at d = 64 S^T reads Q as it came.
//     The fold's epilogue of a dk tile then runs over both warpgroups.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; launches are asynchronous on the caller's stream and each
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "norm_rope.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of every tile, on both axes
constexpr int kThreads = 128;  // one warpgroup
constexpr int kBarP = 1;       // named barrier of the dk/dv split's p^T handoff
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kDeadLse = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {  // elements between samples, tokens and heads
  long long b, n, h;
};

// The fold's epilogue: the raw q or k plane of qkv (sample 0, head 0,
// channel 0) and the same plane of dqkv, row stride `row_stride`; the
// gain, the RoPE tables [B, N, D/2] and the gain partials [B, H, tiles, D].
struct Fold {
  const __nv_bfloat16* raw;
  const float* gain;
  const float* cos_t;
  const float* sin_t;
  __nv_bfloat16* dst;
  float* part;
  long long row_stride;
};

// exp2 on the special-function unit alone (ex2.approx.ftz: one
// instruction; results below 2^-126 flushed to 0).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte async copy (cache at all levels); with valid == false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
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

// The live columns of one row in a 64-column tile, shifted right by 2 t so
// that bit 8 nt + (e & 1) is this thread's element e of column group nt (the
// wgmma C fragment): `cols` (bit c: column c may be live) within the window
// |row - c| <= sw (row: the row's index less the tile's first column;
// sw < 0: no window). flash_attention.cu's live_columns.
__device__ __forceinline__ uint64_t live_columns(uint64_t cols, int row, int sw) {
  if (sw >= 0) {
    const int lo = row - sw, hi = row + sw;  // the window's columns
    if (hi < 0 || lo >= kTile) return 0;
    if (lo > 0) cols &= ~0ull << lo;
    if (hi < kTile - 1) cols &= ~0ull >> (kTile - 1 - hi);
  }
  return cols >> (2 * (threadIdx.x & 3));
}

// The live range [lo, hi) of the other axis for rows [r0, r_end) of a
// sample whose rows at or past `valid` are padding (r_end <= valid: live
// rows; empty when r0 >= r_end): with a window, within sw of the rows.
__device__ __forceinline__ void live_range(int r0, int r_end, int valid, int sw, int* lo, int* hi) {
  *lo = 0;
  *hi = r0 < r_end ? valid : 0;
  if (sw >= 0 && r0 < r_end) {
    *lo = max(0, r0 - sw);
    *hi = min(valid, r_end - 1 + sw + 1);
  }
}

// The fold's epilogue for a 64-row tile starting at r0: the fp32 gradient
// of the rotated rows, acc * scale (a warpgroup's wgmma C fragment, staged by
// the threads with `staged`), through the rotation's transpose and the
// RMSNorm backward on the raw rows into the plane of dqkv, and the gain's
// partial into tile `tile` of the partials (or `spare`, shared memory, for a
// tile at or past N), over THREADS threads (a warpgroup's, or the block's
// when one warpgroup holds the tile). `stage` and `part`: fp32 scratch in
// shared memory. Every thread of the block calls it (norm_rope_bwd_tile
// synchronises the block).
template <int D, int THREADS>
__device__ __forceinline__ void fold_epilogue(const float (&acc)[D / 2], bool staged, float scale, const Fold& f,
                                              float* stage, float* part, float* spare, int b, int h, int H, int N,
                                              int r0, int tile) {
  constexpr int kRow = D + 4;
  const int wtid = threadIdx.x % kThreads;
  const int row = (wtid >> 5) * 16 + ((wtid & 31) >> 2);
  const int t = wtid & 3;
  if (staged) {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      *reinterpret_cast<float2*>(stage + row * kRow + col) =
          make_float2(__fmul_rn(acc[4 * dt], scale), __fmul_rn(acc[4 * dt + 1], scale));
      *reinterpret_cast<float2*>(stage + (row + 8) * kRow + col) =
          make_float2(__fmul_rn(acc[4 * dt + 2], scale), __fmul_rn(acc[4 * dt + 3], scale));
    }
  }
  __syncthreads();
  const int tiles = (N + kTile - 1) / kTile;
  float* gain_grad = tile < tiles ? f.part + (((long long)b * H + h) * tiles + tile) * D : spare;
  const long long plane = (long long)b * N * f.row_stride + h * D;
  norm_rope_bwd_tile<D, THREADS>(stage, f.raw + plane, f.row_stride, r0, N, f.gain,
                                 f.cos_t + (long long)b * N * (D / 2), f.sin_t + (long long)b * N * (D / 2),
                                 f.dst + plane, part, gain_grad, threadIdx.x % THREADS);
}

// The delta = sum_d dO * O of rows [r0, r0 + ROWS) of one (sample, head),
// 0 on padded rows, over THREADS threads: a row's D channels over lanes
// neighbouring threads, 8 each, D/8 rounded up to a power of two so that
// the xor butterfly stays inside the row (d = 192: 32 lanes, 24 live). Into
// sDelta[0 .. ROWS) and delta[row_base + n] for rows n < N.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void row_delta(const __nv_bfloat16* o_b, long long o_sn, const __nv_bfloat16* g_b,
                                          long long g_sn, const unsigned char* mask_b, int r0, int N,
                                          float* sDelta, float* delta, long long row_base, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  constexpr int kLanes = pow2_at_least(kChunks);
  const int lane = tid % kLanes;
  for (int row = tid / kLanes; row < ROWS; row += THREADS / kLanes) {
    const int n = r0 + row;
    float acc = 0.f;
    if (lane < kChunks && n < N && (mask_b == nullptr || mask_b[n])) {
      const uint4 o8 = *reinterpret_cast<const uint4*>(o_b + n * o_sn + lane * 8);
      const uint4 g8 = *reinterpret_cast<const uint4*>(g_b + n * g_sn + lane * 8);
      const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o8);
      const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&g8);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(g[e]), __bfloat162float(o[e]), acc);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      sDelta[row] = acc;
      if (n < N) delta[row_base + n] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  // Consumer warpgroups a block and the blocks an SM the launch bounds ask
  // for: at d = 64 one warpgroup a block, three an SM (163 registers), read
  // faster on an H100 than two a block, one an SM; at d = 128 two (PERF.md).
  // The ring: three stages (two tiles in flight) at d 64 and 128. At d 192
  // two warpgroups on two stages (eight 24 KB tiles, 192 KB: two warpgroups
  // keep eight warps on the SM, where one on three stages, the same bytes,
  // keeps four); at d 256 one warpgroup on two stages (six 32 KB tiles: two
  // Q and dO pairs beside a two-stage ring would be 256 KB).
  static constexpr int kGroups = (D == 64 || D == 256) ? 1 : 2;
  static constexpr int kMinBlocks = D == 64 ? 3 : 1;
  static constexpr int kAhead = D <= 128 ? 2 : 1;  // streamed tiles in flight ahead of the one computed
  static constexpr int kRing = kAhead + 1;
  static constexpr int kTB = kTile * D * 2;          // one sw128 tile
  static constexpr int kQ = 0;                       // kGroups prescaled Q tiles
  static constexpr int kG = kQ + kGroups * kTB;      // kGroups dO tiles
  static constexpr int kK = kG + kGroups * kTB;      // kRing K tiles
  static constexpr int kV = kK + kRing * kTB;        // kRing V tiles
  static constexpr int kEnd = kV + kRing * kTB;
  static constexpr int kBytes = kEnd + 1024;         // + alignment slack
  // The fold's epilogue reuses the tiles: per warpgroup an fp32 stage of
  // 64 rows and norm_rope_bwd_tile's partials.
  static constexpr int kStage = kTile * (D + 4) * 4;
  static constexpr int kPart = nr_bwd_part_bytes<D, kThreads>();
  static_assert(kGroups * (kStage + kPart) <= kEnd, "the fold's epilogue fits over the tiles");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};

// One key tile's products for this warpgroup's 64 query rows: S = Qs K^T and
// dP = dO V^T (wgmma, operands from shared memory), p = exp(s - lse) where
// live(nt, e), ds = p (dp - delta) rounded to bf16 as the A fragments of
// dQ += dS K (K read MN-major). nl0, nl1: -lse * log2(e) of the thread's two
// rows; d0, d1 their delta.
template <int D, typename Live>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 2], const unsigned char* sQ, const unsigned char* sG,
                                        const unsigned char* kt, const unsigned char* vt, float nl0, float nl1,
                                        float d0, float d1, Live live) {
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
      const float p = live(nt, e) ? ex2_ftz(fmaf(s[4 * nt + e], kLog2e, e < 2 ? nl0 : nl1)) : 0.f;
      ds[e] = p * (dp[4 * nt + e] - (e < 2 ? d0 : d1));
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
}

template <int D, bool kFold>
__global__ void __launch_bounds__(DqSmem<D>::kGroups * kThreads, DqSmem<D>::kMinBlocks)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    Strides qs, Strides ks, Strides vs, Strides gs,
                    const float* __restrict__ lse,           // [B, H, N]
                    float* __restrict__ delta,               // [B, H, N]: written without kFold, read with it
                    const unsigned char* __restrict__ mask,  // [B, N] or null
                    const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                    const __nv_bfloat16* __restrict__ out, Strides os,  // without kFold
                    __nv_bfloat16* __restrict__ dq, Strides dqs,        // without kFold
                    Fold fold,                                          // with kFold
                    int B, int N, int H, int sw, float scale) {
  using S = DqSmem<D>;
  constexpr int kGroups = S::kGroups;
  constexpr int kAhead = S::kAhead;
  constexpr int kRing = S::kRing;
  constexpr int kBlockThreads = kGroups * kThreads;
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  // Each slot's live keys: bit c of word c / 32 set when key k0 + c is valid.
  __shared__ uint32_t sKeyBits[kRing][2];
  __shared__ float sSpare[kGroups][D];
  __shared__ float sDelta[kGroups * kTile];

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int q0 = blockIdx.x * kGroups * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long row_base = ((long long)b * H + h) * N;

  // Keys [0, lead) are all valid, none at or past `valid` is; query rows at
  // or past `valid` are padding, with a zero cotangent and dq = 0.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int lo, hi;
  live_range(q0, min(min(q0 + kGroups * kTile, N), valid), valid, sw, &lo, &hi);
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;
  const int wq0 = q0 + wg * kTile;
  const int wq_end = min(min(wq0 + kTile, N), valid);
  int wlo, whi;
  live_range(wq0, wq_end, valid, sw, &wlo, &whi);

  // Starts the copies of the walk's i-th key tile into its slot (rows past
  // N zero-filled) and records which of its keys are valid; the mask is
  // read only between `lead` and `valid`.
  auto issue = [&](int i) {
    const int slot = i % kRing;
    const int k0 = (lo_tile + i) * kTile;
    load_tile_sw128<kTile, D, kBlockThreads>(sK + slot * S::kTB, k_b, ks.n, k0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sV + slot * S::kTB, v_b, vs.n, k0, N, nullptr, tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      const unsigned bits = __ballot_sync(kFull, j < lead || (j < valid && mask_b[j]));
      if ((tid & 31) == 0) sKeyBits[slot][tid >> 5] = bits;
    }
  };
  if (n_tiles > 0) {  // dO, padded query rows zeroed, in one group with the first key tile
#pragma unroll
    for (int w = 0; w < kGroups; ++w)
      load_tile_sw128<kTile, D, kBlockThreads>(sG + w * S::kTB, g_b, gs.n, q0 + w * kTile, N, mask_b, tid);
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }
  if (n_tiles > 0) {
    // The Q tiles, prescaled in bf16 as the TPU kernel does; rows past N are
    // zeros. The ring's proxy fence orders these writes before wgmma.
#pragma unroll
    for (int u = 0; u < kGroups * kTile * kChunks / kBlockThreads; ++u) {
      const int i = tid + u * kBlockThreads;
      const int row = i / kChunks;
      const int ch = (i % kChunks) * 8;
      const int n = q0 + row;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (n < N) x = scale_bf16x8(*reinterpret_cast<const uint4*>(q_b + n * qs.n + ch), scale);
      *reinterpret_cast<uint4*>(sQ + (row / kTile) * S::kTB + sw128_offset<kTile>(row % kTile, ch)) = x;
    }
  }

  const int wtid = tid % kThreads;
  const int qrow0 = wq0 + (wtid >> 5) * 16 + ((wtid & 31) >> 2);  // and qrow0 + 8
  const int qrow1 = qrow0 + 8;
  const float nl0 = -__fmul_rn(qrow0 < N ? lse[row_base + qrow0] : kDeadLse, kLog2e);
  const float nl1 = -__fmul_rn(qrow1 < N ? lse[row_base + qrow1] : kDeadLse, kLog2e);
  float d0, d1;
  if constexpr (kFold) {  // the q/k prologue's
    d0 = qrow0 < N ? delta[row_base + qrow0] : 0.f;
    d1 = qrow1 < N ? delta[row_base + qrow1] : 0.f;
  } else {
    // delta of the block's rows, for this kernel and the dk/dv kernel.
    row_delta<D, kGroups * kTile, kBlockThreads>(out + b * os.b + h * os.h, os.n, g_b, gs.n, mask_b, q0, N,
                                                 sDelta, delta, row_base, tid);
    __syncthreads();
    d0 = sDelta[qrow0 - q0];
    d1 = sDelta[qrow1 - q0];
  }
  const unsigned char* sQw = sQ + wg * S::kTB;
  const unsigned char* sGw = sG + wg * S::kTB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // One barrier a tile: after it every thread's copies of tile `it` have
  // landed and every warpgroup is done with tile it - 1, whose slot the
  // copies of tile it + kAhead then refill.
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kAhead < n_tiles) issue(it + kAhead);
    cp_async_commit();
    const int k0 = (lo_tile + it) * kTile;
    if (k0 >= whi || k0 + kTile <= wlo) continue;  // no key of this warpgroup's range
    const int slot = it % kRing;
    const unsigned char* kt = sK + slot * S::kTB;
    const unsigned char* vt = sV + slot * S::kTB;
    if (k0 + kTile <= lead && (sw < 0 || (k0 + kTile - 1 - wq0 <= sw && wq_end - 1 - k0 <= sw))) {
      // An easy tile: every key valid, every pair inside the window.
      dq_tile<D>(acc, sQw, sGw, kt, vt, nl0, nl1, d0, d1, [](int, int) { return true; });
    } else {
      const uint64_t keys = (uint64_t)sKeyBits[slot][1] << 32 | sKeyBits[slot][0];
      const uint64_t live0 = live_columns(keys, qrow0 - k0, sw), live1 = live_columns(keys, qrow1 - k0, sw);
      dq_tile<D>(acc, sQw, sGw, kt, vt, nl0, nl1, d0, d1,
                 [&](int nt, int e) { return (((e < 2 ? live0 : live1) >> (nt * 8 + (e & 1))) & 1) != 0; });
    }
  }
  cp_async_wait<0>();

  if constexpr (kFold) {
    __syncthreads();  // every warpgroup is done with the tiles the epilogue overwrites
    float* stage = reinterpret_cast<float*>(smem + wg * (S::kStage + S::kPart));
    fold_epilogue<D, kThreads>(acc, true, scale, fold, stage, stage + S::kStage / 4, sSpare[wg], b, h, H, N, wq0,
                               blockIdx.x * kGroups + wg);
  } else {
    const int t = tid & 3;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qrow = rr ? qrow1 : qrow0;
      if (qrow >= N) continue;
      __nv_bfloat16* dst = dq + b * dqs.b + qrow * dqs.n + h * dqs.h + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(
            __fmul_rn(acc[4 * dt + 2 * rr], scale), __fmul_rn(acc[4 * dt + 2 * rr + 1], scale));
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  // Two warpgroups a block, one block an SM (228 registers at d = 64, 255
  // at d = 128): faster on an H100 than one a block, three an SM, which
  // spills at d = 64 (PERF.md).
  static constexpr int kGroups = 2;
  static constexpr int kAhead = 2;
  static constexpr int kRing = kAhead + 1;
  static constexpr bool kPrescale = D != 64;  // d = 64: the scale folds into the exponent exactly
  static constexpr int kTB = kTile * D * 2;
  static constexpr int kK = 0;                          // kGroups K tiles
  static constexpr int kV = kK + kGroups * kTB;         // kGroups V tiles
  static constexpr int kQ = kV + kGroups * kTB;         // kRing Q tiles, as they came
  static constexpr int kG = kQ + kRing * kTB;           // kRing dO tiles
  static constexpr int kQs = kG + kRing * kTB;          // the current Q tile, prescaled
  static constexpr int kLse = kQs + (kPrescale ? kTB : 0);  // kRing x 64 lse
  static constexpr int kDelta = kLse + kRing * kTile * 4;   // kRing x 64 delta
  static constexpr int kEnd = kDelta + kRing * kTile * 4;
  static constexpr int kBytes = kEnd + 1024;
  static constexpr int kStage = kTile * (D + 4) * 4;
  static constexpr int kPart = nr_bwd_part_bytes<D, kThreads>();
  static_assert(kGroups * (kStage + kPart) <= kEnd, "the fold's epilogue fits over the tiles");
};

// One query tile's products for this warpgroup's 64 key rows: S^T = K Qs^T
// and dP^T = V dO^T (wgmma, operands from shared memory; qs is the prescaled
// Q tile, or the Q tile as it came with `c` = log2(e) / 8 at d = 64),
// p^T = exp(s - lse) where live(nt, e), ds^T = p^T (dp^T - delta), both
// rounded to bf16 as the A fragments of dV += P^T dO and dK += dS^T Q (dO and
// the unscaled Q read MN-major). sl, sd: the tile's 64 lse and delta values.
template <int D, typename Live>
__device__ __forceinline__ void dkv_tile(float (&dv)[D / 2], float (&dk)[D / 2], const unsigned char* kt,
                                         const unsigned char* vt, const unsigned char* qs, const unsigned char* qt,
                                         const unsigned char* gt, const float* sl, const float* sd, float c,
                                         Live live) {
  const int t = threadIdx.x & 3;
  float s[32], dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc<kTile>(kt, kk), kmajor_desc<kTile>(qs, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dp, kmajor_desc<kTile>(vt, kk), kmajor_desc<kTile>(gt, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int col = nt * 8 + 2 * t;  // query inside the tile
    const float nl[2] = {-__fmul_rn(sl[col], kLog2e), -__fmul_rn(sl[col + 1], kLog2e)};
    const float dl[2] = {sd[col], sd[col + 1]};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = live(nt, e) ? ex2_ftz(fmaf(s[4 * nt + e], c, nl[e & 1])) : 0.f;
      ds[e] = p[e] * (dp[4 * nt + e] - dl[e & 1]);
    }
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    dsa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
    dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(dv, pa[j], mnmajor_desc<kTile>(gt, j), 1);
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(dk, dsa[j], mnmajor_desc<kTile>(qt, j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

template <int D, bool kFold>
__global__ void __launch_bounds__(DkvSmem<D>::kGroups * kThreads, 1)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     Strides qs, Strides ks, Strides vs, Strides gs,
                     const float* __restrict__ lse,           // [B, H, N]
                     const float* __restrict__ delta,         // [B, H, N]
                     const unsigned char* __restrict__ mask,  // [B, N] or null
                     const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                     __nv_bfloat16* __restrict__ dk, Strides dks,  // without kFold
                     __nv_bfloat16* __restrict__ dv, Strides dvs,
                     Fold fold,                                    // with kFold: dk through it
                     int B, int N, int H, int sw, float scale) {
  using S = DkvSmem<D>;
  constexpr int kGroups = S::kGroups;
  constexpr int kAhead = S::kAhead;
  constexpr int kRing = S::kRing;
  constexpr int kBlockThreads = kGroups * kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  unsigned char* sQs = smem + S::kQs;
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  __shared__ float sSpare[kGroups][D];

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int wtid = tid % kThreads;
  const int t = tid & 3;
  const int k0 = blockIdx.x * kGroups * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;

  // Keys at or past `valid` are dead (dk = dv = 0); query rows at or past it
  // carry no cotangent and are never walked.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int lo, hi;
  live_range(k0, min(min(k0 + kGroups * kTile, N), valid), valid, sw, &lo, &hi);
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;
  const int wk0 = k0 + wg * kTile;
  const int wk_end = min(min(wk0 + kTile, N), valid);
  int wlo, whi;
  live_range(wk0, wk_end, valid, sw, &wlo, &whi);

  const int krow0 = wk0 + (wtid >> 5) * 16 + ((wtid & 31) >> 2);  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < valid && (krow0 < lead || mask_b[krow0]);
  const bool kok1 = krow1 < valid && (krow1 < lead || mask_b[krow1]);

  // Starts the copies of the walk's i-th query tile: Q as it came, dO with
  // padded rows zeroed, its lse and delta (rows past N: zeros, which with
  // their zero dO add nothing).
  auto issue = [&](int i) {
    const int slot = i % kRing;
    const int qt0 = (lo_tile + i) * kTile;
    load_tile_sw128<kTile, D, kBlockThreads>(sQ + slot * S::kTB, q_b, qs.n, qt0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sG + slot * S::kTB, g_b, gs.n, qt0, N, mask_b, tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile;
      const bool in = qt0 + r < N;
      const float* src = (tid < kTile ? lse_bh : delta_bh) + (in ? qt0 + r : 0);
      cp_async4((tid < kTile ? sLse : sDelta) + slot * kTile + r, src, in);
    }
  };
  if (n_tiles > 0) {  // this block's K and V tiles, in one group with the first query tile
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      load_tile_sw128<kTile, D, kBlockThreads>(sK + w * S::kTB, k_b, ks.n, k0 + w * kTile, N, nullptr, tid);
      load_tile_sw128<kTile, D, kBlockThreads>(sV + w * S::kTB, v_b, vs.n, k0 + w * kTile, N, nullptr, tid);
    }
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  const unsigned char* sKw = sK + wg * S::kTB;
  const unsigned char* sVw = sV + wg * S::kTB;
  // The exponent's factor: s^T from the prescaled Q, or at d = 64 from Q as
  // it came, (q k) / 8 = bf16(q / 8) k exactly.
  const float c = S::kPrescale ? kLog2e : __fmul_rn(kLog2e, scale);

  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kAhead < n_tiles) issue(it + kAhead);
    cp_async_commit();
    const int slot = it % kRing;
    const unsigned char* qt = sQ + slot * S::kTB;
    const unsigned char* gt = sG + slot * S::kTB;
    if constexpr (S::kPrescale) {
      // bf16(float(q) * scale), position by position (the layouts agree).
      for (int i = tid; i < S::kTB / 16; i += kBlockThreads)
        reinterpret_cast<uint4*>(sQs)[i] = scale_bf16x8(reinterpret_cast<const uint4*>(qt)[i], scale);
      fence_proxy_async();
      __syncthreads();
    }
    const int qt0 = (lo_tile + it) * kTile;
    if (qt0 >= whi || qt0 + kTile <= wlo) continue;  // no query of this warpgroup's range
    const unsigned char* qst = S::kPrescale ? sQs : qt;
    const float* sl = sLse + slot * kTile;
    const float* sd = sDelta + slot * kTile;
    if (wk0 + kTile <= lead && (sw < 0 || (qt0 + kTile - 1 - wk0 <= sw && wk0 + kTile - 1 - qt0 <= sw))) {
      dkv_tile<D>(dva, dka, sKw, sVw, qst, qt, gt, sl, sd, c, [](int, int) { return true; });
    } else {
      const uint64_t live0 = kok0 ? live_columns(~0ull, krow0 - qt0, sw) : 0;
      const uint64_t live1 = kok1 ? live_columns(~0ull, krow1 - qt0, sw) : 0;
      dkv_tile<D>(dva, dka, sKw, sVw, qst, qt, gt, sl, sd, c,
                  [&](int nt, int e) { return (((e < 2 ? live0 : live1) >> (nt * 8 + (e & 1))) & 1) != 0; });
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int krow = rr ? krow1 : krow0;
    if (krow >= N) continue;
    __nv_bfloat16* dvp = dv + b * dvs.b + krow * dvs.n + h * dvs.h + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
          __floats2bfloat162_rn(dva[4 * dt + 2 * rr], dva[4 * dt + 2 * rr + 1]);
    if constexpr (!kFold) {
      __nv_bfloat16* dkp = dk + b * dks.b + krow * dks.n + h * dks.h + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dkp + dt * 8) = __floats2bfloat162_rn(
            __fmul_rn(dka[4 * dt + 2 * rr], scale), __fmul_rn(dka[4 * dt + 2 * rr + 1], scale));
    }
  }
  if constexpr (kFold) {
    __syncthreads();  // every warpgroup is done with the tiles the epilogue overwrites
    float* stage = reinterpret_cast<float*>(smem + wg * (S::kStage + S::kPart));
    fold_epilogue<D, kThreads>(dka, true, scale, fold, stage, stage + S::kStage / 4, sSpare[wg], b, h, H, N, wk0,
                               blockIdx.x * kGroups + wg);
  }
}

// ---------------------------------------------------------------------------
// dk, dv at d = 192 and 256: two warpgroups on one key tile
// ---------------------------------------------------------------------------

template <int D>
struct DkvSplitSmem {
  // One 64-key tile a block (dk and dv together are D fp32 registers a
  // thread, 256 before S^T and dP^T: no warpgroup holds both), a two-stage
  // ring of Q / dO tiles (three do not fit beside K, V and p^T).
  static constexpr int kAhead = 1;
  static constexpr int kRing = kAhead + 1;
  // 1/sqrt(256) = 1/16 is a power of two, so at d = 256 (as at 64) the scale
  // folds into the exponent exactly and S^T reads Q as it came.
  static constexpr bool kPrescale = D != 256;
  static constexpr int kTB = kTile * D * 2;
  static constexpr int kK = 0;                              // the block's K tile
  static constexpr int kV = kK + kTB;                       // and its V tile
  static constexpr int kQ = kV + kTB;                       // kRing Q tiles, as they came
  static constexpr int kG = kQ + kRing * kTB;               // kRing dO tiles
  static constexpr int kQs = kG + kRing * kTB;              // the current Q tile, prescaled
  static constexpr int kPT = kQs + (kPrescale ? kTB : 0);   // warpgroup 0's p^T, 32 floats a thread
  static constexpr int kLse = kPT + 32 * kThreads * 4;      // kRing x 64 lse
  static constexpr int kDelta = kLse + kRing * kTile * 4;   // kRing x 64 delta
  static constexpr int kEnd = kDelta + kRing * kTile * 4;
  static constexpr int kBytes = kEnd + 1024;
  static constexpr int kStage = kTile * (D + 4) * 4;
  static constexpr int kPart = nr_bwd_part_bytes<D, 2 * kThreads>();
  static_assert(kStage + kPart <= kEnd, "the fold's epilogue fits over the tiles");
  static_assert(kBytes <= 232448, "fits an SM's shared memory");
};

// One query tile's products for the block's 64 key rows, split between its
// warpgroups: warpgroup 0 forms S^T = K Qs^T and p^T = exp(s - lse) where
// live(nt, e), and dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, ds^T = p^T
// (dp^T - delta) and dK += dS^T Q, taking p^T (fp32) from warpgroup 0 over
// `sPT` and a named barrier. Both round p and ds to bf16 where dkv_tile does.
template <int D, typename Live>
__device__ __forceinline__ void dkv_split_tile(float (&acc)[D / 2], int wg,
                                               const unsigned char* kt, const unsigned char* vt,
                                               const unsigned char* qs, const unsigned char* qt,
                                               const unsigned char* gt, const float* sl, const float* sd, float c,
                                               float* sPT, Live live) {
  const int wtid = threadIdx.x % kThreads;
  const int t = threadIdx.x & 3;
  uint32_t xa[kTile / 16][4];
  if (wg == 0) {
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kTile>(kt, kk), kmajor_desc<kTile>(qs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int col = nt * 8 + 2 * t;  // query inside the tile
      const float nl[2] = {-__fmul_rn(sl[col], kLog2e), -__fmul_rn(sl[col + 1], kLog2e)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * nt + e] = live(nt, e) ? ex2_ftz(fmaf(s[4 * nt + e], c, nl[e & 1])) : 0.f;
        sPT[(4 * nt + e) * kThreads + wtid] = s[4 * nt + e];
      }
      xa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[4 * nt + 0], s[4 * nt + 1]);
      xa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
    }
    bar_arrive(kBarP, 2 * kThreads);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(acc, xa[j], mnmajor_desc<kTile>(gt, j), 1);
  } else {
    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<kTile>(vt, kk), kmajor_desc<kTile>(gt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
    bar_sync(kBarP, 2 * kThreads);
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float dl[2] = {sd[col], sd[col + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * nt + e] = sPT[(4 * nt + e) * kThreads + wtid] * (dp[4 * nt + e] - dl[e & 1]);
      xa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(dp[4 * nt + 0], dp[4 * nt + 1]);
      xa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(dp[4 * nt + 2], dp[4 * nt + 3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(acc, xa[j], mnmajor_desc<kTile>(qt, j), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// The dk/dv kernel at d = 192 and 256 (flash_bwd_dkv_kernel's arguments and
// outputs): one block a 64-key tile, two warpgroups, warpgroup 0 holding dv
// and warpgroup 1 dk (dkv_split_tile).
template <int D, bool kFold>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_bwd_dkv_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                           Strides qs, Strides ks, Strides vs, Strides gs,
                           const float* __restrict__ lse,           // [B, H, N]
                           const float* __restrict__ delta,         // [B, H, N]
                           const unsigned char* __restrict__ mask,  // [B, N] or null
                           const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                           __nv_bfloat16* __restrict__ dk, Strides dks,  // without kFold
                           __nv_bfloat16* __restrict__ dv, Strides dvs,
                           Fold fold,                                    // with kFold: dk through it
                           int B, int N, int H, int sw, float scale) {
  using S = DkvSplitSmem<D>;
  constexpr int kAhead = S::kAhead;
  constexpr int kRing = S::kRing;
  constexpr int kBlockThreads = 2 * kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  unsigned char* sQs = smem + S::kQs;
  float* sPT = reinterpret_cast<float*>(smem + S::kPT);
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);
  __shared__ float sSpare[D];

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int wtid = tid % kThreads;
  const int t = tid & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const float* lse_bh = lse + ((long long)b * H + h) * N;
  const float* delta_bh = delta + ((long long)b * H + h) * N;

  // Keys at or past `valid` are dead (dk = dv = 0); query rows at or past it
  // carry no cotangent and are never walked.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int lo, hi;
  live_range(k0, min(min(k0 + kTile, N), valid), valid, sw, &lo, &hi);
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  const int krow0 = k0 + (wtid >> 5) * 16 + ((wtid & 31) >> 2);  // this thread's two key rows
  const int krow1 = krow0 + 8;
  const bool kok0 = krow0 < valid && (krow0 < lead || mask_b[krow0]);
  const bool kok1 = krow1 < valid && (krow1 < lead || mask_b[krow1]);

  // Starts the copies of the walk's i-th query tile: Q as it came, dO with
  // padded rows zeroed, its lse and delta (rows past N: zeros, which with
  // their zero dO add nothing).
  auto issue = [&](int i) {
    const int slot = i % kRing;
    const int qt0 = (lo_tile + i) * kTile;
    load_tile_sw128<kTile, D, kBlockThreads>(sQ + slot * S::kTB, q_b, qs.n, qt0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sG + slot * S::kTB, g_b, gs.n, qt0, N, mask_b, tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile;
      const bool in = qt0 + r < N;
      const float* src = (tid < kTile ? lse_bh : delta_bh) + (in ? qt0 + r : 0);
      cp_async4((tid < kTile ? sLse : sDelta) + slot * kTile + r, src, in);
    }
  };
  if (n_tiles > 0) {  // the block's K and V tiles, in one group with the first query tile
    load_tile_sw128<kTile, D, kBlockThreads>(sK, k_b, ks.n, k0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sV, v_b, vs.n, k0, N, nullptr, tid);
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // The exponent's factor: s^T from the prescaled Q, or at d = 256 from Q as
  // it came, (q k) / 16 = bf16(q / 16) k exactly.
  const float c = S::kPrescale ? kLog2e : __fmul_rn(kLog2e, scale);

  // Warpgroup 0 holds dv, warpgroup 1 dk.
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // One barrier a tile: after it every thread's copies of tile `it` have
  // landed and both warpgroups are done with tile it - 1 (its slot, its
  // prescaled Q and its p^T), which the copies of tile it + kAhead refill.
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kAhead < n_tiles) issue(it + kAhead);
    cp_async_commit();
    const int slot = it % kRing;
    const unsigned char* qt = sQ + slot * S::kTB;
    const unsigned char* gt = sG + slot * S::kTB;
    if constexpr (S::kPrescale) {
      // bf16(float(q) * scale), position by position (the layouts agree).
      for (int i = tid; i < S::kTB / 16; i += kBlockThreads)
        reinterpret_cast<uint4*>(sQs)[i] = scale_bf16x8(reinterpret_cast<const uint4*>(qt)[i], scale);
      fence_proxy_async();
      __syncthreads();
    }
    const int qt0 = (lo_tile + it) * kTile;
    const unsigned char* qst = S::kPrescale ? sQs : qt;
    const float* sl = sLse + slot * kTile;
    const float* sd = sDelta + slot * kTile;
    if (k0 + kTile <= lead && (sw < 0 || (qt0 + kTile - 1 - k0 <= sw && k0 + kTile - 1 - qt0 <= sw))) {
      dkv_split_tile<D>(acc, wg, sK, sV, qst, qt, gt, sl, sd, c, sPT, [](int, int) { return true; });
    } else {
      const uint64_t live0 = kok0 ? live_columns(~0ull, krow0 - qt0, sw) : 0;
      const uint64_t live1 = kok1 ? live_columns(~0ull, krow1 - qt0, sw) : 0;
      dkv_split_tile<D>(acc, wg, sK, sV, qst, qt, gt, sl, sd, c, sPT, [&](int nt, int e) {
        return (((e < 2 ? live0 : live1) >> (nt * 8 + (e & 1))) & 1) != 0;
      });
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int krow = rr ? krow1 : krow0;
    if (krow >= N) continue;
    if (wg == 0) {
      __nv_bfloat16* dvp = dv + b * dvs.b + krow * dvs.n + h * dvs.h + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
            __floats2bfloat162_rn(acc[4 * dt + 2 * rr], acc[4 * dt + 2 * rr + 1]);
    } else if constexpr (!kFold) {
      __nv_bfloat16* dkp = dk + b * dks.b + krow * dks.n + h * dks.h + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dkp + dt * 8) = __floats2bfloat162_rn(
            __fmul_rn(acc[4 * dt + 2 * rr], scale), __fmul_rn(acc[4 * dt + 2 * rr + 1], scale));
    }
  }
  if constexpr (kFold) {
    __syncthreads();  // both warpgroups are done with the tiles the epilogue overwrites
    float* stage = reinterpret_cast<float*>(smem);
    fold_epilogue<D, kBlockThreads>(acc, wg == 1, scale, fold, stage, stage + S::kStage / 4, sSpare, b, h, H, N, k0,
                                    blockIdx.x);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline float q_scale_of(int D) { return (float)(1.0 / std::sqrt((double)D)); }

template <int D, bool kFold>
cudaError_t launch_dq_kernel(const void* q, const void* k, const void* v, const void* dout, Strides qs,
                             Strides ks, Strides vs, Strides gs, const void* lse, void* delta, const void* mask,
                             const void* counts, const void* out, Strides os, void* dq, Strides dqs,
                             const Fold& fold, int B, int N, int H, int sw, cudaStream_t stream) {
  using S = DqSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, kFold>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + S::kGroups * kTile - 1) / (S::kGroups * kTile), H, B);
  flash_bwd_dq_kernel<D, kFold><<<grid, S::kGroups * kThreads, S::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), qs, ks, vs, gs,
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<const unsigned char*>(mask),
      static_cast<const int*>(counts), static_cast<const __nv_bfloat16*>(out), os, static_cast<__nv_bfloat16*>(dq),
      dqs, fold, B, N, H, sw, q_scale_of(D));
  return cudaGetLastError();
}

// The dk/dv kernel at head dim D (kFold: its fold instance), its threads,
// keys a block and dynamic shared memory: d 64 / 128 two warpgroups of 64
// keys each; d 192 / 256 one 64-key tile shared by two.
template <int D, bool kFold>
void dkv_kernel_of(const void** fn, int* keys, int* smem) {
  if constexpr (D <= 128) {
    *fn = (const void*)flash_bwd_dkv_kernel<D, kFold>;
    *keys = DkvSmem<D>::kGroups * kTile;
    *smem = DkvSmem<D>::kBytes;
  } else {
    *fn = (const void*)flash_bwd_dkv_split_kernel<D, kFold>;
    *keys = kTile;
    *smem = DkvSplitSmem<D>::kBytes;
  }
}

template <int D, bool kFold>
cudaError_t launch_dkv_kernel(const void* q, const void* k, const void* v, const void* dout, Strides qs,
                              Strides ks, Strides vs, Strides gs, const void* lse, const void* delta,
                              const void* mask, const void* counts, void* dk, Strides dks, void* dv, Strides dvs,
                              const Fold& fold, int B, int N, int H, int sw, cudaStream_t stream) {
  const void* fn = nullptr;
  int keys = 0, smem = 0;
  dkv_kernel_of<D, kFold>(&fn, &keys, &smem);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + keys - 1) / keys, H, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gp = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);
  const auto* mp = static_cast<const unsigned char*>(mask);
  const auto* cp = static_cast<const int*>(counts);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  float scale = q_scale_of(D);
  void* args[] = {&qp, &kp, &vp, &gp, &qs, &ks, &vs, &gs, &lp, &dlp, &mp, &cp, &dkp, &dks, &dvp, &dvs,
                  const_cast<Fold*>(&fold), &B, &N, &H, &sw, &scale};
  return cudaLaunchKernel(fn, grid, dim3(2 * kThreads), args, smem, stream);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* out, Strides qs,
                      Strides ks, Strides vs, Strides gs, Strides os, const void* lse, const void* mask,
                      const void* counts, void* delta, void* dq, int B, int N, int H, int sw,
                      cudaStream_t stream) {
  const Strides dqs{(long long)N * H * D, (long long)H * D, D};
  return launch_dq_kernel<D, false>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, out, os, dq, dqs,
                                    Fold{}, B, N, H, sw, stream);
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, Strides qs, Strides ks,
                       Strides vs, Strides gs, const void* lse, const void* delta, const void* mask,
                       const void* counts, void* dk, void* dv, int B, int N, int H, int sw, cudaStream_t stream) {
  const Strides os{(long long)N * H * D, (long long)H * D, D};
  return launch_dkv_kernel<D, false>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, os, dv, os,
                                     Fold{}, B, N, H, sw, stream);
}

// The fold's operands: q and k views of the prologue's [B, N, 2C] scratch,
// v of qkv [B, N, 3C], dO [B, N, C].
struct FoldViews {
  Strides qs, ks, vs, gs, dqkv;
  FoldViews(int N, int H, int D) {
    const long long C = (long long)H * D;
    qs = ks = Strides{N * 2 * C, 2 * C, D};
    vs = dqkv = Strides{N * 3 * C, 3 * C, D};
    gs = Strides{N * C, C, D};
  }
};

template <int D>
cudaError_t launch_dq_fold(const void* qkv, const void* qk, const void* q_scale, const void* cos_t,
                           const void* sin_t, const void* mask, const void* counts, const void* dout,
                           const void* lse, const void* delta, void* dqkv, void* part_q, int B, int N, int H, int sw,
                           cudaStream_t stream) {
  const long long C = (long long)H * D;
  const FoldViews w(N, H, D);
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  const auto* n = static_cast<const __nv_bfloat16*>(qk);
  const Fold fold{x, static_cast<const float*>(q_scale), static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(part_q),
                  3 * C};
  return launch_dq_kernel<D, true>(n, n + C, x + 2 * C, dout, w.qs, w.ks, w.vs, w.gs, lse, const_cast<void*>(delta),
                                   mask, counts, nullptr, Strides{}, nullptr, w.dqkv, fold, B, N, H, sw, stream);
}

template <int D>
cudaError_t launch_dkv_fold(const void* qkv, const void* qk, const void* k_scale, const void* cos_t,
                            const void* sin_t, const void* mask, const void* counts, const void* dout,
                            const void* lse, const void* delta, void* dqkv, void* part_k, int B, int N, int H, int sw,
                            cudaStream_t stream) {
  const long long C = (long long)H * D;
  const FoldViews w(N, H, D);
  const auto* x = static_cast<const __nv_bfloat16*>(qkv);
  const auto* n = static_cast<const __nv_bfloat16*>(qk);
  auto* dx = static_cast<__nv_bfloat16*>(dqkv);
  const Fold fold{x + C, static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t), dx + C, static_cast<float*>(part_k), 3 * C};
  return launch_dkv_kernel<D, true>(n, n + C, x + 2 * C, dout, w.qs, w.ks, w.vs, w.gs, lse, delta, mask, counts,
                                    nullptr, w.dqkv, dx + 2 * C, w.dqkv, fold, B, N, H, sw, stream);
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
  if (D == 192)
    return launch_dq<192>(q, k, v, dout, out, qs, ks, vs, gs, os, lse, mask, counts, delta, dq,
                          B, N, H, sw, s);
  if (D == 256)
    return launch_dq<256>(q, k, v, dout, out, qs, ks, vs, gs, os, lse, mask, counts, delta, dq,
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
  if (D == 192)
    return launch_dkv<192>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, dv, B,
                           N, H, sw, s);
  if (D == 256)
    return launch_dkv<256>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, dv, B,
                           N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// The fold (q/k RMSNorm + RoPE under the attention): qkv [B, N, 3*H*D] bf16;
// qk [B, N, 2*H*D] bf16 and delta [B, H, N] f32 from the q/k prologue
// (vitok_fused_qk_prologue_bf16 with out and dout); q_scale, k_scale [D]
// f32; cos, sin [B, N, D/2] f32; mask and counts as above; dout [B, N, H*D]
// bf16 contiguous, zero on padded rows; lse [B, H, N] f32 from the flash
// forward. The dq entry writes dqkv's q plane and part_q, the dk/dv entry
// its k and v planes and part_k: [B, H, ceil(N / 64), D] f32 partials of
// the gains' gradients (the caller sums them over the first three axes).
int vitok_flash_bwd_dq_fold_bf16(const void* qkv, const void* qk, const void* q_scale, const void* cos_t,
                                 const void* sin_t, const void* mask, const void* counts, const void* dout,
                                 const void* lse, const void* delta, void* dqkv, void* part_q, int B, int N, int H,
                                 int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq_fold<64>(qkv, qk, q_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_q, B, N,
                              H, sw, s);
  if (D == 128)
    return launch_dq_fold<128>(qkv, qk, q_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_q, B, N,
                               H, sw, s);
  if (D == 192)
    return launch_dq_fold<192>(qkv, qk, q_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_q, B, N,
                               H, sw, s);
  if (D == 256)
    return launch_dq_fold<256>(qkv, qk, q_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_q, B, N,
                               H, sw, s);
  return (int)cudaErrorInvalidValue;
}

int vitok_flash_bwd_dkv_fold_bf16(const void* qkv, const void* qk, const void* k_scale, const void* cos_t,
                                  const void* sin_t, const void* mask, const void* counts, const void* dout,
                                  const void* lse, const void* delta, void* dqkv, void* part_k, int B, int N, int H,
                                  int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv_fold<64>(qkv, qk, k_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_k, B, N,
                               H, sw, s);
  if (D == 128)
    return launch_dkv_fold<128>(qkv, qk, k_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_k, B,
                                N, H, sw, s);
  if (D == 192)
    return launch_dkv_fold<192>(qkv, qk, k_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_k, B,
                                N, H, sw, s);
  if (D == 256)
    return launch_dkv_fold<256>(qkv, qk, k_scale, cos_t, sin_t, mask, counts, dout, lse, delta, dqkv, part_k, B,
                                N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory (spills) a thread, blocks an SM and shared
// memory a block of the dq (which = 0) or dk/dv (1) kernel at head dim D
// (fold: 1 for the fold's instance), as the compiler and the card report
// them: out[0..3].
int vitok_flash_bwd_attributes(int which, int D, int fold, int* out) {
  const void* fn = nullptr;
  int threads = 0, smem = 0, keys = 0;
#define VITOK_PICK(DD)                                                                                     \
  if (D == DD) {                                                                                           \
    if (which == 0) {                                                                                      \
      fn = fold ? (const void*)flash_bwd_dq_kernel<DD, true> : (const void*)flash_bwd_dq_kernel<DD, false>; \
      threads = DqSmem<DD>::kGroups * kThreads;                                                            \
      smem = DqSmem<DD>::kBytes;                                                                           \
    } else {                                                                                               \
      if (fold)                                                                                            \
        dkv_kernel_of<DD, true>(&fn, &keys, &smem);                                                        \
      else                                                                                                 \
        dkv_kernel_of<DD, false>(&fn, &keys, &smem);                                                       \
      threads = 2 * kThreads;                                                                              \
    }                                                                                                      \
  }
  VITOK_PICK(64)
  VITOK_PICK(128)
  VITOK_PICK(192)
  VITOK_PICK(256)
#undef VITOK_PICK
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

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
