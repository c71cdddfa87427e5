// Fused QK-RMSNorm + rotate-half 2D RoPE + masked (optionally sliding-window)
// attention, read straight from the flat [B, N, 3C] QKV projection output.
//
// Replaces the TPU kernel vitok_tpu/ops/fused_attention.py::_fused_kernel
// (body _attend_cell, per-head math _norm_rope_half). Same function and the
// same rounding points:
//   * q/k RMSNorm statistics in fp32, times the fp32 gain, cast to bf16;
//   * rotate-half RoPE in bf16 (each product and sum rounded to bf16), with
//     the fp32 cos/sin tables rounded to bf16 first;
//   * logits in fp32 (bf16 x bf16 products, fp32 accumulation) times
//     (1/sqrt(d)) * log2(e);
//   * key-side NaFlex mask and |i - j| <= sw window filled with -1e30 (not
//     -inf), so a row with no valid key averages v uniformly over all N keys,
//     exactly as the TPU kernel's full-row softmax does;
//   * exp2, P rounded to bf16 before PV, fp32 accumulation, division by the
//     fp32 row sum at the end.
// The TPU kernel holds the whole [N, N] score block in VMEM; here an online
// softmax walks 64-key tiles, which is the same function up to the order of
// the rescaling (P is rounded to bf16 at a running rather than the final row
// max). Padded query rows attend to the valid keys, as on the TPU.
//
// What bounds it on an H100: at the model's shapes (N <= 1024, d in {64,128})
// the work is 4*B*H*N^2*d flops against (3C + C)*B*N*2 bytes, about 256 flops
// per byte at N = 1024, d = 64: close to the card's ridge (~295 flop/byte for
// bf16), so a well-fed kernel is bound by tensor-core throughput at 512p and
// by bytes at 256p. This version is neither: it uses mma.sync (about half of
// wgmma's rate), recomputes the K norm + RoPE once per 64-query tile (N/64
// extra passes over K, served from L2), and only overlaps a tile's V copy
// with its K norm. What it does do: one pass over qkv per tile with no
// [B, H, N, N] intermediate in device memory, no separate norm/RoPE/relayout
// launches, every global load 16 bytes wide and all of a tile's loads in
// flight together, and it skips key tiles past a sample's last valid key and
// tiles wholly outside the sliding window.
//
// Design: one block per (64-query tile, head, sample), four warps of 16 query
// rows. A row of D channels is cut into D/16 pieces, one thread each: channels
// [8p, 8p + 8) and their rotate-half partners [D/2 + 8p, D/2 + 8p + 8), so the
// rotation stays in the thread and the norm's sum takes log2(D/16) shuffles.
// The Q tile is normalised and rotated into shared memory once, then held as
// mma A fragments in registers. Each 64-key tile is normalised and rotated
// into shared memory while its V tile arrives by cp.async; S = Q K^T and
// O += P V run on mma.sync m16n8k16 bf16 -> fp32, with V's B fragments read
// by ldmatrix.trans.
//
// A second instance, fused_attention_q8_kernel further down, runs the same
// body and quantizes the result per token to int8 before it leaves the chip
// (it replaces _fused_kernel_q8).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "norm_rope.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTile = 64;      // query rows per block and keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 row padding: conflict-free fragment loads
constexpr float kNegFill = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int kRow = D + kPad;          // sQ, sK, sV row stride (bf16)
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kV = kK + sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kGainQ = kV + sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kGainK = kGainQ + sizeof(float) * D;
  static constexpr size_t kKeyState = kGainK + sizeof(float) * D;
  static constexpr size_t kBytes = kKeyState + kTile;
};

// What a block sets up once: the gains in shared memory and, in *sKvEnd, one
// past the last valid key (NaFlex padding is a tail suffix, but the per-key
// mask in attend_tile keeps any mask exact; this only bounds the loop). The
// caller synchronises the block before it reads either.
template <int D>
__device__ __forceinline__ void block_setup(const float* __restrict__ q_scale,
                                            const float* __restrict__ k_scale,
                                            const unsigned char* mask_b, int N, float* sGainQ,
                                            float* sGainK, int* sKvEnd, int tid) {
  for (int i = tid; i < D; i += kThreads) {
    sGainQ[i] = q_scale[i];
    sGainK[i] = k_scale[i];
  }
  if (tid == 0) *sKvEnd = mask_b ? 0 : N;
  __syncthreads();
  if (mask_b) {
    int last = 0;
    for (int j = tid; j < N; j += kThreads)
      if (mask_b[j]) last = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      last = max(last, __shfl_xor_sync(kFull, last, off));
    if ((tid & 31) == 0) atomicMax(sKvEnd, last);
  }
}

// Attention of query rows [q0, q0 + 64) of head h of one sample (`qkv_b`,
// `cos_b`, `sin_b`, `mask_b` point at that sample): the bf16 result of row
// q0 + r goes to out_rows[r * out_stride + channel], rows at or past N are
// not written. Both kernels below run this one body, so their bf16 values
// are the same bits.
template <int D>
__device__ __forceinline__ void attend_tile(
    unsigned char* smem, const int* sKvEnd, const __nv_bfloat16* __restrict__ qkv_b,
    const float* __restrict__ cos_b, const float* __restrict__ sin_b,
    const unsigned char* __restrict__ mask_b, int q0, int h, int N, int H, int sw,
    float score_scale, __nv_bfloat16* out_rows, long long out_stride) {
  using S = Smem<D>;
  constexpr int kRow = S::kRow;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  float* sGainQ = reinterpret_cast<float*>(smem + S::kGainQ);
  float* sGainK = reinterpret_cast<float*>(smem + S::kGainK);
  unsigned char* sKeyState = smem + S::kKeyState;  // 0 valid, 1 masked, 2 past N

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id
  const int t = lane & 3;    // thread in group
  const int C = H * D;
  const long long row_stride = 3LL * C;

  norm_rope_tile<D, kThreads>(qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b, sQ, tid);
  __syncthreads();

  // Q as mma A fragments (rows warp*16 + g and + 8).
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * kRow;
    const __nv_bfloat16* r1 = r0 + 8 * kRow;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t;
      qf[kk][0] = ld_u32(r0 + c0);
      qf[kk][1] = ld_u32(r1 + c0);
      qf[kk][2] = ld_u32(r0 + c0 + 8);
      qf[kk][3] = ld_u32(r1 + c0 + 8);
    }
  }

  const int kv_end = *sKvEnd;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int q_last = min(q0 + kTile, N) - 1;
  int lo_key = 0, hi_key = kv_end;
  if (sw >= 0) {
    lo_key = max(0, q0 - sw);
    hi_key = min(kv_end, q_last + sw + 1);
  }
  int lo_tile = lo_key / kTile;
  int hi_tile = (hi_key + kTile - 1) / kTile;
  if (hi_tile <= lo_tile) lo_tile = hi_tile = 0;

  const int qrow0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int qrow1 = qrow0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sum
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  // This lane's ldmatrix row address inside a 16-key x 16-channel block of V.
  const int v_key = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  // Pass 0 walks the tiles that hold a valid key inside some row's window.
  // A row that saw none there (a padded query row beyond the window's reach,
  // or an all-padding sample) averages v uniformly over all N keys on the
  // TPU, so pass 1 then walks the skipped tiles as well; for every other row
  // their keys are all filled and add exactly zero.
  const int main_tiles = hi_tile - lo_tile;
  for (int pass = 0; pass < 2; ++pass) {
    int count = main_tiles;
    if (pass == 1) {
      const bool dead = (qrow0 < N && m0 <= kNegFill) || (qrow1 < N && m1 <= kNegFill);
      if (!__syncthreads_or(dead)) break;
      count = n_tiles - main_tiles;
    }
    for (int it = 0; it < count; ++it) {
      const int kt = pass == 0 ? lo_tile + it : (it < lo_tile ? it : it + main_tiles);
      const int k0 = kt * kTile;
      __syncthreads();  // previous tile's sK / sV reads are done
      // V tile, row-major, 16-byte copies in flight while K is normalised.
      constexpr int kChunks = D / 8;
#pragma unroll
      for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int row = i / kChunks;
        const int ch = (i % kChunks) * 8;
        const int j = k0 + row;
        __nv_bfloat16* dst = sV + row * kRow + ch;
        if (j < N)
          cp_async16(dst, qkv_b + (long long)j * row_stride + 2 * C + h * D + ch);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      norm_rope_tile<D, kThreads>(qkv_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK, tid);
      if (tid < kTile) {
        const int j = k0 + tid;
        sKeyState[tid] = j >= N ? 2 : ((mask_b && !mask_b[j]) ? 1 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 keys.
      float s[kTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* krow = sK + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[nt], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
      }

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
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
      uint32_t pa[kTile / 16][4];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const float p0 = exp2f(__fsub_rn(s[nt][0], mn0));
        const float p1 = exp2f(__fsub_rn(s[nt][1], mn0));
        const float p2 = exp2f(__fsub_rn(s[nt][2], mn1));
        const float p3 = exp2f(__fsub_rn(s[nt][3], mn1));
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
        const int j = nt >> 1;
        const int hi = (nt & 1) * 2;
        pa[j][hi + 0] = pack_bf16(p0, p1);
        pa[j][hi + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][0] *= a0;
        o[dt][1] *= a0;
        o[dt][2] *= a1;
        o[dt][3] *= a1;
      }
      // O += P V: one ldmatrix.x4.trans gives the B fragments of two
      // 8-channel tiles for one 16-key step.
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, sV + (j * 16 + v_key) * kRow + dt * 8 + v_col);
          mma_bf16(o[dt], pa[j], vb[0], vb[1]);
          mma_bf16(o[dt + 1], pa[j], vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  __nv_bfloat16* out0 = out_rows + (long long)(qrow0 - q0) * out_stride;
  __nv_bfloat16* out1 = out0 + 8 * out_stride;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (qrow0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
          __floats2bfloat162_rn(o[dt][0] / l0, o[dt][1] / l0);
    if (qrow1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
          __floats2bfloat162_rn(o[dt][2] / l1, o[dt][3] / l1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ q_scale,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       const unsigned char* __restrict__ mask,  // [B, N] or null
                       __nv_bfloat16* __restrict__ out, int N, int H,
                       int sw,  // < 0: no window
                       float score_scale) {
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  block_setup<D>(q_scale, k_scale, mask_b, N, reinterpret_cast<float*>(smem + S::kGainQ),
                 reinterpret_cast<float*>(smem + S::kGainK), &sKvEnd, threadIdx.x);
  attend_tile<D>(smem, &sKvEnd, qkv + (long long)b * N * 3 * C, cos_t + (long long)b * N * (D / 2),
                 sin_t + (long long)b * N * (D / 2), mask_b, q0, h, N, H, sw, score_scale,
                 out + ((long long)b * N + q0) * C + h * D, C);
}

// ---------------------------------------------------------------------------
// The int8-epilogue instance: replaces the TPU kernel
// vitok_tpu/ops/fused_attention.py::_fused_kernel_q8. The attention is
// attend_tile above, so each bf16 value is the bits fused_attention_kernel
// would have written; the epilogue is quantize_activation over the full C
// channels of a token: scale = max(absmax / 127, 1e-12) (IEEE division),
// code = clip(rint(x / scale), -127, 127). The bf16 result never reaches
// device memory.
//
// The absmax runs over every head of a row. The TPU revisits a VMEM scratch
// across its sequential head-group axis; here the heads of a (64-query tile,
// sample) are shared out over a thread block cluster of `cs` blocks along
// grid y (cs divides H, at most 8). Each block loops over its H / cs heads
// and keeps its [64, (H / cs) * D] bf16 slab in shared memory, takes its own
// row maxima, and reads the other blocks' maxima through distributed shared
// memory between two cluster barriers; then each quantizes its slab and
// rank 0 writes the scales.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int D>
struct SmemQ8 {
  static constexpr size_t kSlab = (Smem<D>::kBytes + 15) / 16 * 16;  // then [64, W + 8] bf16
  __host__ __device__ static size_t row_max(int W) { return kSlab + sizeof(__nv_bfloat16) * kTile * (W + kPad); }
  __host__ __device__ static size_t bytes(int W) { return row_max(W) + sizeof(float) * kTile; }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_attention_q8_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ q_scale,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          const unsigned char* __restrict__ mask,  // [B, N] or null
                          int8_t* __restrict__ out_q,              // [B, N, C]
                          float* __restrict__ out_scale,           // [B, N]
                          int N, int H, int heads_per_block,
                          int sw,  // < 0: no window
                          float score_scale) {
  namespace cg = cooperative_groups;
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  const int W = heads_per_block * D;   // this block's slab of channels
  const int slab_row = W + kPad;
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem + SmemQ8<D>::kSlab);
  float* sRowMax = reinterpret_cast<float*>(smem + SmemQ8<D>::row_max(W));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y * heads_per_block;
  const int b = blockIdx.z;
  const int C = H * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * 3 * C;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);

  block_setup<D>(q_scale, k_scale, mask_b, N, reinterpret_cast<float*>(smem + S::kGainQ),
                 reinterpret_cast<float*>(smem + S::kGainK), &sKvEnd, tid);
  for (int hl = 0; hl < heads_per_block; ++hl)
    attend_tile<D>(smem, &sKvEnd, qkv_b, cos_b, sin_b, mask_b, q0, h0 + hl, N, H, sw, score_scale,
                   sO + hl * D, slab_row);
  __syncthreads();

  // Row maxima of this block's slab: warp w takes rows w, w + 4, ...
  const int chunks = W / 8;
  for (int r = warp; r < kTile; r += kWarps) {
    float amax = 0.f;
    if (q0 + r < N) {
      for (int ch = lane; ch < chunks; ch += 32) {
        const uint4 u = *reinterpret_cast<const uint4*>(sO + r * slab_row + ch * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
    amax = warp_max(amax);
    if (lane == 0) sRowMax[r] = amax;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's maxima are written
  const unsigned ranks = cluster.num_blocks();
  for (int r = warp; r < kTile; r += kWarps) {
    const int n = q0 + r;
    if (n >= N) continue;
    float amax = 0.f;
    for (unsigned k = 0; k < ranks; ++k) amax = fmaxf(amax, cluster.map_shared_rank(sRowMax, k)[r]);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    int8_t* dst = out_q + ((long long)b * N + n) * C + h0 * D;
    for (int ch = lane; ch < chunks; ch += 32) {
      const uint4 u = *reinterpret_cast<const uint4*>(sO + r * slab_row + ch * 8);
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
cudaError_t launch(const void* qkv, const void* q_scale, const void* k_scale,
                   const void* cos_t, const void* sin_t, const void* mask,
                   void* out, int B, int N, int H, int sw, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<__nv_bfloat16*>(out), N, H, sw, score_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_q8(const void* qkv, const void* q_scale, const void* k_scale,
                      const void* cos_t, const void* sin_t, const void* mask, void* out_q,
                      void* out_scale, int B, int N, int H, int cs, int sw, cudaStream_t stream) {
  if (cs < 1 || cs > 8 || H % cs) return cudaErrorInvalidValue;
  const int heads_per_block = H / cs;
  const size_t smem = SmemQ8<D>::bytes(heads_per_block * D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_q8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(
      &cfg, fused_attention_q8_kernel<D>, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const unsigned char*>(mask), static_cast<int8_t*>(out_q),
      static_cast<float*>(out_scale), N, H, heads_per_block, sw, score_scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; q_scale, k_scale [D] f32; cos, sin [B, N, D/2] f32;
// mask [B, N] bool bytes or null; out [B, N, H*D] bf16. sw < 0: no window.
// Returns the cudaError_t of the launch (0 = success).
int vitok_fused_attention_bf16(const void* qkv, const void* q_scale,
                               const void* k_scale, const void* cos_t,
                               const void* sin_t, const void* mask, void* out,
                               int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  if (D == 128) return launch<128>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// As vitok_fused_attention_bf16, with the per-token int8 quantize over all
// H*D channels as the epilogue: out_q [B, N, H*D] int8, out_scale [B, N] f32.
// `cs` blocks of a cluster share a row's heads (cs divides H, 1 <= cs <= 8,
// and 64 * (H / cs * D + 8) * 2 bytes of slab must fit beside the tiles).
int vitok_fused_attention_q8_bf16(const void* qkv, const void* q_scale, const void* k_scale,
                                  const void* cos_t, const void* sin_t, const void* mask,
                                  void* out_q, void* out_scale, int B, int N, int H, int D,
                                  int cs, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_q8<64>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H,
                         cs, sw, s);
  if (D == 128)
    return launch_q8<128>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H,
                          cs, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
