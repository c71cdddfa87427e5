// The body of the fused QK-RMSNorm + rotate-half RoPE + masked attention:
// one 64-query tile of one head of one sample, read straight from the flat
// [B, N, 3C] QKV projection output. The kernels of the mma.sync family run
// it: fused_attention.cu (the forward in bf16 and fp32, kept off the main
// path).
//
// Rounding points of the TPU kernel (vitok_tpu/ops/fused_attention.py,
// _attend_cell and _norm_rope_half):
//   * q/k RMSNorm statistics in fp32, times the fp32 gain, cast to the input
//     type; the rotate-half RoPE in that type with the tables rounded to it;
//   * logits in fp32 times (1/sqrt(d)) * log2(e);
//   * key-side mask and |i - j| <= sw window filled with -1e30 (not -inf),
//     so a row with no valid key averages v uniformly over all N keys;
//   * exp2, P cast to the input type before PV, fp32 accumulation, division
//     by the fp32 row sum at the end.
// The TPU kernel holds the whole [N, N] score block in VMEM; here an online
// softmax walks 64-key tiles, which is the same function up to the order of
// the rescaling (in bf16 P is rounded at a running rather than the final row
// max).
//
// Thread layout: four warps of 16 query rows. Thread (g = lane / 4,
// t = lane % 4) holds rows 16 * warp + g and + 8, and in each 64-key tile the
// scores of keys 8 * nt + 2 * t + {0, 1} (nt = 0..7): the C fragment layout of
// mma.sync m16n8k16. The bf16 body runs S = Q K^T and O += P V on mma.sync
// (bf16 -> fp32, Q held as A fragments, V's B fragments by ldmatrix.trans).
// The fp32 body keeps that layout and does the products as fp32 FMA loops
// from shared memory (no tensor cores, no tf32); P reaches the lanes that
// hold the other keys of a row by warp shuffles.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "norm_rope.cuh"
#include "ptx.cuh"

namespace {

constexpr int kTile = 64;      // query rows per block and keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegFill = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one block: Q, K and V tiles of element type T (rows padded
// by 16 bytes), the two gains and the key states of a tile.
template <int D, typename T = __nv_bfloat16>
struct Smem {
  static constexpr int kRow = D + 16 / (int)sizeof(T);  // sQ, sK, sV row stride
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(T) * kTile * kRow;
  static constexpr size_t kV = kK + sizeof(T) * kTile * kRow;
  static constexpr size_t kGainQ = kV + sizeof(T) * kTile * kRow;
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
// `cos_b`, `sin_b`, `mask_b` point at that sample): the result of row q0 + r
// goes to out_rows[r * out_stride + channel], rows at or past N are not
// written. T is the compute and output type (bf16 or fp32); Src the input
// type, T.
//
// `pack` > 1 makes the sample image `self` of a pack of images that lie one
// after another: their keys are in every row's softmax, masked. They add
// exact zeros to a row that has a valid key, so only a row with none walks
// them, and averages v over the whole pack. No kernel passes a pack since
// the A/B pack moved to the walkers (fused_attention_ab_sm90.cu,
// fused_attention_ab_f32_sm90.cu); the path stays because removing it
// changes the code the compiler makes of the mma.sync kernels
// (fused_attention.cu), whose times must hold.
template <int D, typename T, typename Src>
__device__ __forceinline__ void attend_tile(
    unsigned char* smem, const int* sKvEnd, const Src* __restrict__ qkv_b,
    const float* __restrict__ cos_b, const float* __restrict__ sin_b,
    const unsigned char* __restrict__ mask_b, int q0, int h, int N, int H, int sw,
    float score_scale, T* out_rows, long long out_stride, int pack = 1, int self = 0) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(std::is_same<Src, T>::value, "bf16 reads bf16; fp32 reads fp32");
  using S = Smem<D, T>;
  constexpr int kRow = S::kRow;
  T* sQ = reinterpret_cast<T*>(smem + S::kQ);
  T* sK = reinterpret_cast<T*>(smem + S::kK);
  T* sV = reinterpret_cast<T*>(smem + S::kV);
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

  if constexpr (kF32)
    norm_rope_tile_f32<D, kThreads>(qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b, sQ, tid);
  else
    norm_rope_tile<D, kThreads>(qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b, sQ, tid);
  __syncthreads();

  // bf16: Q as mma A fragments (rows warp*16 + g and + 8).
  uint32_t qf[D / 16][4];
  if constexpr (!kF32) {
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
  // TPU, so pass 1 then walks the skipped tiles as well (and, in a pack, the
  // other images' tiles); for every other row their keys are all filled and
  // add exactly zero.
  const int main_tiles = hi_tile - lo_tile;
  const int own_rest = n_tiles - main_tiles;
  for (int pass = 0; pass < 2; ++pass) {
    int count = main_tiles;
    if (pass == 1) {
      const bool dead = (qrow0 < N && m0 <= kNegFill) || (qrow1 < N && m1 <= kNegFill);
      if (!__syncthreads_or(dead)) break;
      count = own_rest + (pack - 1) * n_tiles;
    }
    for (int it = 0; it < count; ++it) {
      int kt;
      const Src* src_b = qkv_b;
      bool foreign = false;  // a tile of another image of the pack
      if (pass == 0) {
        kt = lo_tile + it;
      } else if (it < own_rest) {
        kt = it < lo_tile ? it : it + main_tiles;
      } else {
        const int f = (it - own_rest) / n_tiles;
        kt = (it - own_rest) % n_tiles;
        src_b += (long long)((f < self ? f : f + 1) - self) * N * row_stride;
        foreign = true;
      }
      const int k0 = kt * kTile;
      __syncthreads();  // previous tile's sK / sV reads are done
      // V tile, row-major, 16-byte copies in flight while K is normalised.
      constexpr int kPer = 16 / (int)sizeof(T);  // elements a copy
      constexpr int kChunks = D / kPer;
#pragma unroll
      for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
        const int i = tid + u * kThreads;
        const int row = i / kChunks;
        const int ch = (i % kChunks) * kPer;
        const int j = k0 + row;
        T* dst = sV + row * kRow + ch;
        if (j < N)
          cp_async16(dst, src_b + (long long)j * row_stride + 2 * C + h * D + ch);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      if (!foreign) {  // another image's keys are masked: its K is never read
        if constexpr (kF32)
          norm_rope_tile_f32<D, kThreads>(src_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK, tid);
        else
          norm_rope_tile<D, kThreads>(src_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK, tid);
      }
      if (tid < kTile) {
        const int j = k0 + tid;
        sKeyState[tid] = j >= N ? 2 : ((foreign || (mask_b && !mask_b[j])) ? 1 : 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 keys.
      float s[kTile / 8][4];
      if constexpr (kF32) {
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const float* qa_row = sQ + (warp * 16 + g) * kRow;
        const float* qb_row = qa_row + 8 * kRow;
#pragma unroll 2
        for (int c = 0; c < D; c += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qa_row + c);
          const float4 qb = *reinterpret_cast<const float4*>(qb_row + c);
#pragma unroll
          for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const float4 kv = *reinterpret_cast<const float4*>(sK + (nt * 8 + 2 * t + b) * kRow + c);
              s[nt][b] = fmaf(qa.w, kv.w, fmaf(qa.z, kv.z, fmaf(qa.y, kv.y, fmaf(qa.x, kv.x, s[nt][b]))));
              s[nt][2 + b] =
                  fmaf(qb.w, kv.w, fmaf(qb.z, kv.z, fmaf(qb.y, kv.y, fmaf(qb.x, kv.x, s[nt][2 + b]))));
            }
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
          const __nv_bfloat16* krow = sK + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            mma_bf16(s[nt], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
        }
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
        if constexpr (kF32) {
          s[nt][0] = p0;
          s[nt][1] = p1;
          s[nt][2] = p2;
          s[nt][3] = p3;
        } else {
          // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
          const int j = nt >> 1;
          const int hi = (nt & 1) * 2;
          pa[j][hi + 0] = pack_bf16(p0, p1);
          pa[j][hi + 1] = pack_bf16(p2, p3);
        }
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
      if constexpr (kF32) {
        // O += P V: key 8 * nt + 2 * tp + b's probabilities come from lane
        // (g, tp); this lane adds them into its channels 8 * dt + 2 * t + {0, 1}.
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
#pragma unroll 1
            for (int tp = 0; tp < 4; ++tp) {
              const int src = (lane & ~3) | tp;
              const float p0 = __shfl_sync(kFull, s[nt][b], src);
              const float p1 = __shfl_sync(kFull, s[nt][2 + b], src);
              const float* vrow = sV + (nt * 8 + 2 * tp + b) * kRow + 2 * t;
#pragma unroll
              for (int dt = 0; dt < D / 8; ++dt) {
                const float2 v = *reinterpret_cast<const float2*>(vrow + dt * 8);
                o[dt][0] = fmaf(p0, v.x, o[dt][0]);
                o[dt][1] = fmaf(p0, v.y, o[dt][1]);
                o[dt][2] = fmaf(p1, v.x, o[dt][2]);
                o[dt][3] = fmaf(p1, v.y, o[dt][3]);
              }
            }
          }
        }
      } else {
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
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  T* out0 = out_rows + (long long)(qrow0 - q0) * out_stride;
  T* out1 = out0 + 8 * out_stride;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if constexpr (kF32) {
      if (qrow0 < N) *reinterpret_cast<float2*>(out0 + col) = make_float2(o[dt][0] / l0, o[dt][1] / l0);
      if (qrow1 < N) *reinterpret_cast<float2*>(out1 + col) = make_float2(o[dt][2] / l1, o[dt][3] / l1);
    } else {
      if (qrow0 < N)
        *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
            __floats2bfloat162_rn(o[dt][0] / l0, o[dt][1] / l0);
      if (qrow1 < N)
        *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
            __floats2bfloat162_rn(o[dt][2] / l1, o[dt][3] / l1);
    }
  }
}

}  // namespace
