// Fused QK-RMSNorm + rotate-half 2D RoPE + masked (optionally sliding-window)
// attention from the flat [B, N, 3C] QKV projection output, redesigned for
// Hopper: a q/k prologue kernel and a wgmma attention kernel.
//
// Replaces the TPU kernel vitok_tpu/ops/fused_attention.py::_fused_kernel
// (body _attend_cell, per-head math _norm_rope_half) on the main path, in
// bf16. Same function and the same rounding points as the mma.sync kernel it
// takes over from (fused_attention.cu, kept as vitok_fused_attention_mma_bf16):
//   * q/k RMSNorm statistics in fp32, times the fp32 gain, cast to bf16; the
//     rotate-half RoPE in bf16 with the tables rounded to bf16 first
//     (norm_rope_tile of norm_rope.cuh, the same code, with each bf16 product
//     rounded before its sum as the plain version rounds it: the mma.sync
//     kernel lets the compiler contract them into an fma);
//   * logits in fp32 (bf16 products, fp32 accumulation) times
//     (1/sqrt(d)) * log2(e); key-side mask and |i - j| <= sw window filled
//     with -1e30, so a row with no valid key averages v over all N keys;
//   * exp2 against the running row max, P rounded to bf16 before PV, fp32
//     accumulation, division by the fp32 row sum at the end.
// Asked for it (training), the attention kernel also writes each row's
// log-sum-exp in log2 units, m + log2(l), as fp32 [B, H, N]; padded query
// rows get kDeadLse, so the backward (fused_attention_bwd.cu) forms p = 0
// there without a statistics pass.
//
// What bounds it on an H100: 4 * B * H * N^2 * d flops against about
// 8 * C bytes a token (qkv read, out written): at N = 1024, d = 64 about
// 256 flops a byte, near the card's ridge (~295 for bf16), so 512p is bound
// by the tensor cores and 256p by bytes. The mma.sync kernel was neither: it
// ran mma.sync, normalised every K tile once per 64-query block (N/64
// passes over K on the CUDA cores, about 40-60% of its products' time at
// d = 64) and loaded each tile synchronously before its products.
//
// Design, and why the prologue: fused_qk_prologue_kernel normalises and
// rotates k once, into a bf16 scratch [B, N, C] (for the backward q and k,
// [B, N, 2C]), with norm_rope_tile; the attention kernel normalises its own
// Q tile once per block and streams plain K tiles. Three ways were weighed
// to bring the K norm to at most once per 128 query rows:
//   * the prologue: +2C bytes written and +2C read a token (the k scratch)
//     on top of the kernel's 8C, 1.5x the bytes, so at 256p (bound by bytes)
//     the bound itself rises by half; in exchange K is normed exactly once,
//     every streamed tile is a plain copy, and the backward reuses the same
//     prologue (with q as well);
//   * two consumer warpgroups per 128 query rows sharing each normed K tile:
//     no extra bytes, but the norm stays on the critical path of every tile
//     (N/128 times per head) and needs its raw tile staged and a second
//     ring slot for the normed copy;
//   * a cluster along the query axis sharing normed tiles through DSMEM:
//     the fewest bytes, the most synchronisation (cluster barriers per tile).
// The prologue was chosen for its simplicity and because it serves both
// kernels; at 256p it costs bytes, and PERF.md records what that costs.
//
// The attention kernel: one block per (64-query tile, head, sample), one
// warpgroup of 128 threads, on the wgmma body of fused_attend_sm90.cuh
// (which the A/B kernels of fused_attention_ab_sm90.cu share). Its Q tile
// is normed into shared memory; each
// key tile's K and V come by 16-byte cp.async into a two-stage ring of
// 128-byte-swizzled tiles (sm90.cuh): tile j + 1 is in flight while tile
// j's products run.
// S = Q K^T is wgmma m64n64k16 with Q and K from shared memory (K-major);
// O += P V is wgmma m64nDk16 with P from registers (the accumulator of S,
// rounded to bf16, is the A fragment) and V from shared memory, read
// MN-major with the transpose flag. Key tiles past a sample's last valid key
// and tiles wholly outside the window are skipped; a second pass walks them
// only if some row saw no valid key (the dead-row pass of fused_attend.cuh).
// At d = 64 the launch bounds ask for four blocks an SM (at most 128
// registers: a 16-byte spill), which measured faster on an H100 than three;
// queueing a tile's S product behind the previous tile's P V in a deeper
// ring measured slower than waiting for each tile's products (PERF.md).
//
// The int8-epilogue kernel (fused_attention_q8_sm90_kernel, further down)
// replaces the TPU kernel _fused_kernel_q8 on this kernel's body; see there.
//
// Head dims: the prologue, this kernel and the int8-epilogue kernel have
// instances at D = 64, 128, 192 and 256 (the JAX gates take any multiple of
// 64; the released models use 64 and 128). At D = 192 a row's q/k norm runs
// on 16 lanes of which 12 hold its pieces (norm_rope.cuh), O += P V is two
// wgmma products on V's column blocks (n128 + n64, or n128 twice at 256:
// sm90.cuh's wgmma_rs), and o takes D / 2 fp32 registers a thread beside S's
// 32: one block an SM (the tiles alone are 120 and 160 KB), up to 255
// registers (what ptxas reports, and spills: PERF.md's kernel table). The prologue's
// delta (the backward's) sums a row over 32 lanes at d = 192 and 256 (24
// live at 192).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; asynchronous on the caller's stream, each returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend_sm90.cuh"
#include "norm_rope.cuh"

namespace {

constexpr float kDeadLse = 1e30f;  // a padded query row: p = exp2(x - 1e30) = 0

// ---------------------------------------------------------------------------
// The prologue: k (and for the backward q) normalised and rotated once;
// optionally the backward's delta = sum_c dO * O.
// ---------------------------------------------------------------------------

// Src: bf16, or int8 codes (the int8-input A/B kernel's k, parts = 1, no
// delta; fused_attention_q8in_sm90.cu), which are exact in bf16: the int8
// instance writes the bits the bf16 instance writes for bf16(code).
template <int D, typename Src>
__global__ void __launch_bounds__(kThreads)
fused_qk_prologue_kernel(const Src* __restrict__ qkv, const float* __restrict__ q_scale,
                         const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t,
                         const __nv_bfloat16* __restrict__ out,   // [B, N, C] or null
                         const __nv_bfloat16* __restrict__ dout,  // [B, N, C] or null
                         __nv_bfloat16* __restrict__ qk,          // [B, N, parts * C]
                         float* __restrict__ delta,               // [B, H, N] or null
                         int N, int H, int parts) {               // 2: q | k, 1: k
  constexpr int kRow = D + kNrPad;
  constexpr int kChunks = D / 8;
  __shared__ __align__(16) __nv_bfloat16 sT[kTile * kRow];
  __shared__ float sGain[2][D];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const Src* qkv_b = qkv + (long long)b * N * 3 * C;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  __nv_bfloat16* qk_b = qk + (long long)b * N * parts * C;
  for (int i = tid; i < D; i += kThreads) {
    sGain[0][i] = q_scale[i];
    sGain[1][i] = k_scale[i];
  }
  __syncthreads();
  for (int part = 2 - parts; part < 2; ++part) {  // q, then k
    norm_rope_tile<D, kThreads, Src, true>(qkv_b + part * C + h * D, 3LL * C, r0, N, sGain[part], cos_b, sin_b, sT,
                                            tid);
    __syncthreads();
    __nv_bfloat16* dst = qk_b + (part - (2 - parts)) * C + h * D;
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int n = r0 + row;
      if (n < N)
        *reinterpret_cast<uint4*>(dst + (long long)n * parts * C + (i % kChunks) * 8) =
            *reinterpret_cast<const uint4*>(sT + row * kRow + (i % kChunks) * 8);
    }
    __syncthreads();
  }
  if (delta != nullptr) {
    // Row r's D channels over kLanes neighbouring threads, 8 each: D/8
    // rounded up to a power of two, so the xor butterfly stays inside the
    // row (at d = 192, 32 lanes of which 24 hold channels; the others add 0).
    constexpr int kLanes = pow2_at_least(kChunks);
    const int ch = tid % kLanes;
    for (int row = tid / kLanes; row < kTile; row += kThreads / kLanes) {
      const int n = r0 + row;
      float acc = 0.f;
      if (n < N && ch < kChunks) {
        const long long at = ((long long)b * N + n) * C + h * D + ch * 8;
        const uint4 o8 = *reinterpret_cast<const uint4*>(out + at);
        const uint4 g8 = *reinterpret_cast<const uint4*>(dout + at);
        const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o8);
        const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&g8);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += __bfloat162float(o[e]) * __bfloat162float(g[e]);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (ch == 0 && n < N) delta[((long long)b * H + h) * N + n] = acc;
    }
  }
}

// The prologue's fp32 instance (the fp32 AE's high-resolution fold and its
// backward, and the fp32 fused backward): q and k normed and rotated in fp32
// with norm_rope_piece_f32 (the fp32 walker's arithmetic, no rounding to
// bf16: _norm_rope_half on f32), written as fp32 qk [B, N, parts * C];
// with out and dout (fp32) also delta = sum_c dO * O. Each thread's piece
// goes straight to device memory, so no tile is staged. A row's threads are
// its lanes (nr_lanes: at d = 192 16, of which the first 12 hold its pieces
// and the others read and write nothing and add zeros to its sum of squares).
template <int D>
__global__ void __launch_bounds__(kThreads)
fused_qk_prologue_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                             const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t,
                             const float* __restrict__ out,   // [B, N, C] or null
                             const float* __restrict__ dout,  // [B, N, C] or null
                             float* __restrict__ qk,          // [B, N, parts * C]
                             float* __restrict__ delta,       // [B, H, N] or null
                             int N, int H, int parts) {
  constexpr int kHalf = D / 2;
  constexpr int kLanes = nr_lanes<D>();  // threads per row
  constexpr int kRowsPerPass = kThreads / kLanes;
  constexpr int kChunks = D / 8;
  __shared__ float sGain[2][D];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const float* qkv_b = qkv + (long long)b * N * 3 * C;
  const float* cos_b = cos_t + (long long)b * N * kHalf;
  const float* sin_b = sin_t + (long long)b * N * kHalf;
  float* qk_b = qk + (long long)b * N * parts * C;
  for (int i = tid; i < D; i += kThreads) {
    sGain[0][i] = q_scale[i];
    sGain[1][i] = k_scale[i];
  }
  __syncthreads();
  const bool piece = nr_piece<D>(tid);
  const int c0 = piece ? (tid % kLanes) * 8 : 0;
  for (int part = 2 - parts; part < 2; ++part) {  // q, then k
    const float* gain = sGain[part];
#pragma unroll 2
    for (int p = 0; p < kTile / kRowsPerPass; ++p) {
      const int n = r0 + p * kRowsPerPass + tid / kLanes;
      float a[8], bv[8], c[8], sn[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) a[e] = bv[e] = c[e] = sn[e] = 0.f;
      if (piece && n < N) {
        const float* x = qkv_b + (long long)n * 3 * C + part * C + h * D + c0;
        ld_f4x2(a, x);
        ld_f4x2(bv, x + kHalf);
        ld_f4x2(c, cos_b + (long long)n * kHalf + c0);
        ld_f4x2(sn, sin_b + (long long)n * kHalf + c0);
      }
      float vr[8], vi[8];
      norm_rope_piece_f32<D>(a, bv, c, sn, gain + c0, gain + kHalf + c0, vr, vi);  // every thread: shuffles
      if (piece && n < N) {
        float* dst = qk_b + (long long)n * parts * C + (part - (2 - parts)) * C + h * D + c0;
        st_f4x2(dst, vr);
        st_f4x2(dst + kHalf, vi);
      }
    }
  }
  if (delta != nullptr) {
    // Row r's D channels over kDeltaLanes neighbouring threads, 8 each: D/8
    // rounded up to a power of two, as the bf16 instance (at d = 192, 32
    // lanes of which 24 hold channels; the others add 0).
    constexpr int kDeltaLanes = pow2_at_least(kChunks);
    const int ch = tid % kDeltaLanes;
    for (int row = tid / kDeltaLanes; row < kTile; row += kThreads / kDeltaLanes) {
      const int n = r0 + row;
      float acc = 0.f;
      if (n < N && ch < kChunks) {
        const long long at = ((long long)b * N + n) * C + h * D + ch * 8;
        float o[8], g[8];
        ld_f4x2(o, out + at);
        ld_f4x2(g, dout + at);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += o[e] * g[e];
      }
#pragma unroll
      for (int off = 1; off < kDeltaLanes; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (ch == 0 && n < N) delta[((long long)b * H + h) * N + n] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// The attention kernel
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kTileBytes = kTile * D * 2;  // one sw128 tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;             // kStages tiles
  static constexpr int kV = kK + kStages * kTileBytes;   // kStages tiles
  static constexpr int kState = kV + kStages * kTileBytes;  // kStages x 64 key states
  static constexpr int kGain = kState + kStages * kTile;    // q's gain, D floats
  static constexpr int kBytes = kGain + D * 4 + 1024;       // + alignment slack
  // Q is normed into a row-padded tile over the K slots before the ring
  // starts, then copied into its sw128 tile.
  static constexpr int kNormed = kK;
  static_assert(kTile * (D + kNrPad) * 2 <= kStages * kTileBytes, "the normed Q fits over the K slots");
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)  // d = 64: four blocks an SM
fused_attention_sm90_kernel(const __nv_bfloat16* __restrict__ kn,   // [B, N, C] normed k
                            const __nv_bfloat16* __restrict__ qkv,  // [B, N, 3C]: q, v
                            const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            const unsigned char* __restrict__ mask,  // [B, N] or null
                            __nv_bfloat16* __restrict__ out,        // [B, N, C]
                            float* __restrict__ lse,                // [B, H, N] or null
                            int N, int H, int sw, float score_scale) {
  using S = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sKvEnd;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sState = smem + S::kState;  // 0 valid, 1 masked, 2 past N
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * 3 * C;
  const __nv_bfloat16* k_src = kn + (long long)b * N * C + h * D;
  const __nv_bfloat16* v_src = qkv_b + 2 * C + h * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;

  // The block's own Q tile, normed and rotated here (once per block: the
  // prologue norms only k, which every query tile of the head streams).
  for (int i = tid; i < D; i += kThreads) sGain[i] = q_scale[i];
  block_last_valid<kThreads>(mask_b, N, &sKvEnd, tid);
  const int kv_end = sKvEnd;
  {
    constexpr int kRow = D + kNrPad;
    const __nv_bfloat16* normed = reinterpret_cast<const __nv_bfloat16*>(smem + S::kNormed);
    norm_rope_tile<D, kThreads, __nv_bfloat16, true>(qkv_b + h * D, 3LL * C, q0, N, sGain,
                                                      cos_t + (long long)b * N * (D / 2),
                                                      sin_t + (long long)b * N * (D / 2),
                                                      reinterpret_cast<__nv_bfloat16*>(smem + S::kNormed), tid);
    __syncthreads();
    for (int i = tid; i < kTile * D / 8; i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(sQ + sw128_offset<kTile>(row, col)) =
          *reinterpret_cast<const uint4*>(normed + row * kRow + col);
    }
    __syncthreads();  // the K slots are free for the ring; the ring's fence orders sQ before wgmma
  }

  const KeyTiles tiles = key_tiles(q0, N, kv_end, sw);
  const int qrow0 = cell_row0(q0);  // this thread's two query rows: qrow0 and qrow0 + 8
  CellRows<D> r;
  r.reset();
  auto issue = [&](int kt, int stage) {
    issue_kv_tile<D>(sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile, k_src, C,
                     v_src, 3LL * C, kt * kTile, N, true, mask_b, kv_end, false, tid);
  };
  auto compute = [&](int kt, int stage) {
    attend_kv_tile<D>(r, sQ, sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile,
                      kt * kTile, qrow0, sw, score_scale);
  };
  walk_cell<D>(tiles, r, qrow0, N, issue, compute);

  sum_rows<D>(r);
  __nv_bfloat16* out0 = out + ((long long)b * N + qrow0) * C + h * D;
  store_rows<D>(r, out0, out0 + 8LL * C, qrow0, N);
  if (lse != nullptr && (tid & 3) == 0) {
    float* lse_bh = lse + ((long long)b * H + h) * N;
    const int qrow1 = qrow0 + 8;
    if (qrow0 < N) lse_bh[qrow0] = (mask_b == nullptr || mask_b[qrow0]) ? r.m0 + log2f(r.l0) : kDeadLse;
    if (qrow1 < N) lse_bh[qrow1] = (mask_b == nullptr || mask_b[qrow1]) ? r.m1 + log2f(r.l1) : kDeadLse;
  }
}

template <int D, typename Src = __nv_bfloat16>
cudaError_t launch_prologue(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                            const void* sin_t, const void* out, const void* dout, void* qk, void* delta,
                            int B, int N, int H, int parts, cudaStream_t stream) {
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qk_prologue_kernel<D, Src><<<grid, kThreads, 0, stream>>>(
      static_cast<const Src*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(qk), static_cast<float*>(delta), N, H, parts);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_prologue_f32(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                const void* sin_t, const void* out, const void* dout, void* qk, void* delta, int B,
                                int N, int H, int parts, cudaStream_t stream) {
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qk_prologue_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<float*>(qk), static_cast<float*>(delta), N, H, parts);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_attention(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                             const void* sin_t, const void* mask, void* out, void* lse, int B, int N, int H, int sw,
                             cudaStream_t stream) {
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_attention_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(kn), static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(q_scale), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const unsigned char*>(mask), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), N, H,
      sw, score_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The int8-epilogue kernel: replaces the TPU kernel
// vitok_tpu/ops/fused_attention.py::_fused_kernel_q8. After the prologue (k
// normed once), a block runs, for each of its heads, the body of
// fused_attention_sm90_kernel above (Q normed here, walk_cell over the
// cp.async ring, sum_rows), so each bf16 value is the bits that kernel
// would write; stage_rows puts the rows into shared memory instead of device
// memory: the heads before the last into a [64, (heads - 1) * D] bf16 slab
// past the Q, K and V slots (the next head reuses those), the last head's
// into the K slots, which its finished walk leaves free (four heads of 64
// then take 68,224 bytes, three blocks an SM). The epilogue is quantize_activation over
// the C channels of a token: scale = max(absmax / 127, 1e-12) (IEEE
// division), code = clip(rint(x / scale), -127, 127). The absmax runs over
// every head of a row: the heads of a (64-query tile, sample) are shared out
// over a thread block cluster of `cs` blocks along grid y (cs divides H;
// _q8_cluster_size in vitok_torch/ops/fused_attention.py takes two heads a
// block at D = 128 and four blocks at D = 64, which read fastest on an
// H100, and at D = 192 / 256 the portable cluster nearest 4 whose heads fit:
// four heads of 192, two of 256 a block); each block takes its own row maxima and reads the other blocks' through
// distributed shared memory between two cluster barriers, then quantizes its
// slab, and rank 0 writes the scales. The bf16 result never reaches device
// memory.
//
// The body is written out here rather than shared with the forward kernel
// through a switch in its store: a template switch in the shared body slowed
// the forward and the walkers (PERF.md, PR 11).
// ---------------------------------------------------------------------------

constexpr int kSlabPad = 8;  // bf16 padding of a slab row: conflict-free fragment stores

// The forward kernel's layout, then the slab of the W = (heads - 1) * D
// channels of a block's heads before the last, and the row maxima. The
// last head's [64, D + pad] rows go over the K slots.
template <int D>
struct Q8Smem {
  static constexpr int kSlab = FwdSmem<D>::kGain + D * 4;
  static constexpr int kLast = FwdSmem<D>::kK;
  static_assert(kTile * (D + kSlabPad) * 2 <= kStages * FwdSmem<D>::kTileBytes, "the last head fits over the K slots");
  __host__ __device__ static int row_max(int W) { return kSlab + 2 * kTile * (W + kSlabPad); }
  __host__ __device__ static int bytes(int W) { return row_max(W) + 4 * kTile + 1024; }  // + alignment slack
};

// o / l of this thread's rows (after sum_rows) as bf16, the arithmetic of
// store_rows: row0 and row1 point at the head's first channel of the slab
// rows of qrow0 and qrow0 + 8.
template <int D>
__device__ __forceinline__ void stage_rows(const CellRows<D>& r, __nv_bfloat16* row0, __nv_bfloat16* row1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(row0 + col) = __floats2bfloat162_rn(r.o[4 * dt] / r.l0, r.o[4 * dt + 1] / r.l0);
    *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
        __floats2bfloat162_rn(r.o[4 * dt + 2] / r.l1, r.o[4 * dt + 3] / r.l1);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)
fused_attention_q8_sm90_kernel(const __nv_bfloat16* __restrict__ kn,   // [B, N, C] normed k
                               const __nv_bfloat16* __restrict__ qkv,  // [B, N, 3C]: q, v
                               const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t,
                               const unsigned char* __restrict__ mask,  // [B, N] or null
                               int8_t* __restrict__ out_q,              // [B, N, C]
                               float* __restrict__ out_scale,           // [B, N]
                               int N, int H, int heads_per_block, int sw, float score_scale) {
  namespace cg = cooperative_groups;
  using S = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int sKvEnd;
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sState = smem + S::kState;
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);
  const int W = (heads_per_block - 1) * D;  // the slab's channels
  const int slab_row = W + kSlabPad;
  constexpr int kLastRow = D + kSlabPad;
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem + Q8Smem<D>::kSlab);
  __nv_bfloat16* sLast = reinterpret_cast<__nv_bfloat16*>(smem + Q8Smem<D>::kLast);
  float* sRowMax = reinterpret_cast<float*>(smem + Q8Smem<D>::row_max(W));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y * heads_per_block;
  const int b = blockIdx.z;
  const int C = H * D;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * 3 * C;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;

  for (int i = tid; i < D; i += kThreads) sGain[i] = q_scale[i];
  block_last_valid<kThreads>(mask_b, N, &sKvEnd, tid);
  const int kv_end = sKvEnd;
  const KeyTiles tiles = key_tiles(q0, N, kv_end, sw);
  const int qrow0 = cell_row0(q0);  // this thread's two query rows: qrow0 and qrow0 + 8

  for (int hl = 0; hl < heads_per_block; ++hl) {
    const int h = h0 + hl;
    const __nv_bfloat16* k_src = kn + (long long)b * N * C + h * D;
    const __nv_bfloat16* v_src = qkv_b + 2 * C + h * D;
    {
      constexpr int kRow = D + kNrPad;
      const __nv_bfloat16* normed = reinterpret_cast<const __nv_bfloat16*>(smem + S::kNormed);
      norm_rope_tile<D, kThreads, __nv_bfloat16, true>(qkv_b + h * D, 3LL * C, q0, N, sGain,
                                                        cos_t + (long long)b * N * (D / 2),
                                                        sin_t + (long long)b * N * (D / 2),
                                                        reinterpret_cast<__nv_bfloat16*>(smem + S::kNormed), tid);
      __syncthreads();
      for (int i = tid; i < kTile * D / 8; i += kThreads) {
        const int row = i / (D / 8), col = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(sQ + sw128_offset<kTile>(row, col)) =
            *reinterpret_cast<const uint4*>(normed + row * kRow + col);
      }
      __syncthreads();
    }
    CellRows<D> r;
    r.reset();
    auto issue = [&](int kt, int stage) {
      issue_kv_tile<D>(sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile, k_src, C,
                       v_src, 3LL * C, kt * kTile, N, true, mask_b, kv_end, false, tid);
    };
    auto compute = [&](int kt, int stage) {
      attend_kv_tile<D>(r, sQ, sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile,
                        kt * kTile, qrow0, sw, score_scale);
    };
    walk_cell<D>(tiles, r, qrow0, N, issue, compute);
    sum_rows<D>(r);
    const bool last = hl == heads_per_block - 1;
    const int stride = last ? kLastRow : slab_row;
    __nv_bfloat16* row0 = (last ? sLast : sO + hl * D) + (qrow0 - q0) * stride;
    stage_rows<D>(r, row0, row0 + 8 * stride);
  }
  __syncthreads();

  // The 16 bytes of row rr at channel 8 ch of the block's heads.
  auto staged = [&](int rr, int ch) {
    const __nv_bfloat16* p = ch * 8 < W ? sO + rr * slab_row + ch * 8 : sLast + rr * kLastRow + (ch * 8 - W);
    return *reinterpret_cast<const uint4*>(p);
  };
  // Row maxima of this block's heads: warp w takes rows w, w + 4, ...
  constexpr int kWarps = kThreads / 32;
  const int chunks = heads_per_block * D / 8;
  for (int rr = warp; rr < kTile; rr += kWarps) {
    float amax = 0.f;
    if (q0 + rr < N) {
      for (int ch = lane; ch < chunks; ch += 32) {
        const uint4 u = staged(rr, ch);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
    amax = warp_max(amax);
    if (lane == 0) sRowMax[rr] = amax;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's maxima are written
  const unsigned ranks = cluster.num_blocks();
  for (int rr = warp; rr < kTile; rr += kWarps) {
    const int n = q0 + rr;
    if (n >= N) continue;
    float amax = 0.f;
    for (unsigned k = 0; k < ranks; ++k) amax = fmaxf(amax, cluster.map_shared_rank(sRowMax, k)[rr]);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    int8_t* dst = out_q + ((long long)b * N + n) * C + h0 * D;
    for (int ch = lane; ch < chunks; ch += 32) {
      const uint4 u = staged(rr, ch);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float qx = fminf(fmaxf(rintf(__fdiv_rn(f.x, scale)), -127.f), 127.f);
        const float qy = fminf(fmaxf(rintf(__fdiv_rn(f.y, scale)), -127.f), 127.f);
        w[e >> 1] |= (uint32_t)(uint8_t)(int8_t)qx << (16 * (e & 1));
        w[e >> 1] |= (uint32_t)(uint8_t)(int8_t)qy << (16 * (e & 1) + 8);
      }
      *reinterpret_cast<uint2*>(dst + ch * 8) = make_uint2(w[0], w[1]);
    }
    if (lane == 0 && cluster.block_rank() == 0) out_scale[(long long)b * N + n] = scale;
  }
  cluster.sync();  // no block leaves while another may still read its maxima
}

template <int D>
cudaError_t launch_q8(const void* kn, const void* qkv, const void* q_scale, const void* cos_t, const void* sin_t,
                      const void* mask, void* out_q, void* out_scale, int B, int N, int H, int cs, int sw,
                      cudaStream_t stream) {
  if (cs < 1 || cs > 16 || H % cs) return cudaErrorInvalidValue;
  const int heads_per_block = H / cs;
  const int smem = Q8Smem<D>::bytes((heads_per_block - 1) * D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_q8_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cs > 8) {  // clusters of 9-16 blocks are not portable: ask for them
    err = cudaFuncSetAttribute(fused_attention_q8_sm90_kernel<D>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, cs, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_attention_q8_sm90_kernel<D>, static_cast<const __nv_bfloat16*>(kn),
                           static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
                           static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                           static_cast<const unsigned char*>(mask), static_cast<int8_t*>(out_q),
                           static_cast<float*>(out_scale), N, H, heads_per_block, sw, score_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; q_scale, k_scale [D] f32; cos, sin [B, N, D/2] f32.
// Writes qk [B, N, parts*H*D] bf16: with parts = 2 q normed and rotated,
// then k (the backward's scratch, and the fold's); with parts = 1 k alone
// (the forward's). With out and dout ([B, N, H*D] bf16, both or neither)
// also delta [B, H, N] f32, each row's sum over a head's channels of
// dout * out. D is 64, 128, 192 or 256.
int vitok_fused_qk_prologue_bf16(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                 const void* sin_t, const void* out, const void* dout, void* qk, void* delta,
                                 int B, int N, int H, int D, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((out == nullptr) != (dout == nullptr) || (out == nullptr) != (delta == nullptr) || parts < 1 || parts > 2)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_prologue<64>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 128)
    return launch_prologue<128>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 192)
    return launch_prologue<192>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 256)
    return launch_prologue<256>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  return (int)cudaErrorInvalidValue;
}

// The prologue's fp32 instance: qkv [B, N, 3*H*D] f32, out and dout [B, N,
// H*D] f32 or both null, qk [B, N, parts*H*D] f32, delta [B, H, N] f32 or
// null, the rest as above. D is 64, 128, 192 or 256.
int vitok_fused_qk_prologue_f32(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                const void* sin_t, const void* out, const void* dout, void* qk, void* delta,
                                int B, int N, int H, int D, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((out == nullptr) != (dout == nullptr) || (out == nullptr) != (delta == nullptr) || parts < 1 || parts > 2)
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_prologue_f32<64>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 128)
    return launch_prologue_f32<128>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 192)
    return launch_prologue_f32<192>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  if (D == 256)
    return launch_prologue_f32<256>(qkv, q_scale, k_scale, cos_t, sin_t, out, dout, qk, delta, B, N, H, parts, s);
  return (int)cudaErrorInvalidValue;
}

// The prologue's int8 instance: qkv8 [B, N, 3*H*D] int8 codes; k_scale [D]
// f32; cos, sin [B, N, D/2] f32. Writes kn [B, N, H*D] bf16, the k codes
// normed and rotated (parts = 1): the bits the bf16 instance writes for
// bf16(code). The int8-input A/B kernel (fused_attention_q8in_sm90.cu) runs it
// first. D is 64, 128, 192 or 256.
int vitok_fused_k_prologue_q8(const void* qkv8, const void* k_scale, const void* cos_t, const void* sin_t, void* kn,
                              int B, int N, int H, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);  // parts = 1 reads only k's gain
  if (D == 64)
    return launch_prologue<64, int8_t>(qkv8, k_scale, k_scale, cos_t, sin_t, nullptr, nullptr, kn, nullptr, B, N, H,
                                       1, s);
  if (D == 128)
    return launch_prologue<128, int8_t>(qkv8, k_scale, k_scale, cos_t, sin_t, nullptr, nullptr, kn, nullptr, B, N,
                                        H, 1, s);
  if (D == 192)
    return launch_prologue<192, int8_t>(qkv8, k_scale, k_scale, cos_t, sin_t, nullptr, nullptr, kn, nullptr, B, N,
                                        H, 1, s);
  if (D == 256)
    return launch_prologue<256, int8_t>(qkv8, k_scale, k_scale, cos_t, sin_t, nullptr, nullptr, kn, nullptr, B, N,
                                        H, 1, s);
  return (int)cudaErrorInvalidValue;
}

// kn [B, N, H*D] bf16, k normed and rotated by the prologue (parts = 1);
// qkv [B, N, 3*H*D] bf16 (q normed here, v read); q_scale [D] f32; cos, sin
// [B, N, D/2] f32; mask [B, N] bool bytes or null; out [B, N, H*D] bf16; lse
// [B, H, N] f32 or null (inference). sw < 0: no window.
int vitok_fused_attention_sm90_bf16(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                                    const void* sin_t, const void* mask, void* out, void* lse, int B, int N, int H,
                                    int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_attention<64>(kn, qkv, q_scale, cos_t, sin_t, mask, out, lse, B, N, H, sw, s);
  if (D == 128) return launch_attention<128>(kn, qkv, q_scale, cos_t, sin_t, mask, out, lse, B, N, H, sw, s);
  if (D == 192) return launch_attention<192>(kn, qkv, q_scale, cos_t, sin_t, mask, out, lse, B, N, H, sw, s);
  if (D == 256) return launch_attention<256>(kn, qkv, q_scale, cos_t, sin_t, mask, out, lse, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// As vitok_fused_attention_sm90_bf16 (kn from the prologue, parts = 1), with
// the per-token int8 quantize over all H*D channels as the epilogue: out_q
// [B, N, H*D] int8, out_scale [B, N] f32. `cs` blocks of a cluster share a
// row's heads (cs divides H, 1 <= cs <= 16; above 8 a non-portable cluster),
// and the slab of H / cs heads must fit in shared memory beside the tiles.
int vitok_fused_attention_q8_sm90_bf16(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                                       const void* sin_t, const void* mask, void* out_q, void* out_scale, int B,
                                       int N, int H, int D, int cs, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_q8<64>(kn, qkv, q_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H, cs, sw, s);
  if (D == 128) return launch_q8<128>(kn, qkv, q_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H, cs, sw, s);
  if (D == 192) return launch_q8<192>(kn, qkv, q_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H, cs, sw, s);
  if (D == 256) return launch_q8<256>(kn, qkv, q_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H, cs, sw, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory (spills) a thread, blocks an SM and shared
// memory a block of the bf16 prologue (which = 0), the attention kernel (1),
// the int8-epilogue kernel (2, at `heads` heads a block) or the fp32
// prologue (3) at head dim D: out[0..3].
int vitok_fused_sm90_attributes(int which, int D, int heads, int* out) {
  const void* fn = nullptr;
  int smem = 0;
#define VITOK_PICK(DD)                                                              \
  if (D == DD) {                                                                    \
    if (which == 0) {                                                               \
      fn = (const void*)fused_qk_prologue_kernel<DD, __nv_bfloat16>;                \
    } else if (which == 1) {                                                        \
      fn = (const void*)fused_attention_sm90_kernel<DD>;                            \
      smem = FwdSmem<DD>::kBytes;                                                   \
    } else if (which == 3) {                                                        \
      fn = (const void*)fused_qk_prologue_f32_kernel<DD>;                           \
    } else {                                                                        \
      fn = (const void*)fused_attention_q8_sm90_kernel<DD>;                         \
      smem = Q8Smem<DD>::bytes((heads - 1) * DD);                                   \
    }                                                                               \
  }
  VITOK_PICK(64)
  VITOK_PICK(128)
  VITOK_PICK(192)
  VITOK_PICK(256)
#undef VITOK_PICK
  if (fn == nullptr || heads < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = smem + (int)attr.sharedSizeBytes;
  return 0;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
