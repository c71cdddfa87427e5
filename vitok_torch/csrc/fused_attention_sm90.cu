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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; asynchronous on the caller's stream, each returns
// cudaGetLastError().

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

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_qk_prologue_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ q_scale,
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
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * 3 * C;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);
  __nv_bfloat16* qk_b = qk + (long long)b * N * parts * C;
  for (int i = tid; i < D; i += kThreads) {
    sGain[0][i] = q_scale[i];
    sGain[1][i] = k_scale[i];
  }
  __syncthreads();
  for (int part = 2 - parts; part < 2; ++part) {  // q, then k
    norm_rope_tile<D, kThreads, __nv_bfloat16, true>(qkv_b + part * C + h * D, 3LL * C, r0, N, sGain[part],
                                                      cos_b, sin_b, sT, tid);
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
    // Row r's D channels over kChunks neighbouring threads, 8 each.
    const int ch = tid % kChunks;
    for (int row = tid / kChunks; row < kTile; row += kThreads / kChunks) {
      const int n = r0 + row;
      float acc = 0.f;
      if (n < N) {
        const long long at = ((long long)b * N + n) * C + h * D + ch * 8;
        const uint4 o8 = *reinterpret_cast<const uint4*>(out + at);
        const uint4 g8 = *reinterpret_cast<const uint4*>(dout + at);
        const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(&o8);
        const __nv_bfloat16* g = reinterpret_cast<const __nv_bfloat16*>(&g8);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += __bfloat162float(o[e]) * __bfloat162float(g[e]);
      }
#pragma unroll
      for (int off = 1; off < kChunks; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
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

template <int D>
cudaError_t launch_prologue(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                            const void* sin_t, const void* out, const void* dout, void* qk, void* delta,
                            int B, int N, int H, int parts, cudaStream_t stream) {
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_qk_prologue_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(qk), static_cast<float*>(delta), N, H, parts);
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

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; q_scale, k_scale [D] f32; cos, sin [B, N, D/2] f32.
// Writes qk [B, N, parts*H*D] bf16: with parts = 2 q normed and rotated,
// then k (the backward's scratch); with parts = 1 k alone (the forward's).
// With out and dout ([B, N, H*D] bf16, both or neither) also delta
// [B, H, N] f32, each row's sum over a head's channels of dout * out.
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
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
