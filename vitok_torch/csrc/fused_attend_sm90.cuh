// The wgmma body of the fused attention on Hopper: one 64-query tile of one
// head (a "cell") against 64-key tiles streamed through a cp.async ring of
// 128-byte-swizzled tiles (sm90.cuh). Three files' kernels run it:
// fused_attention_sm90.cu (the forward on the main path, one cell a block),
// fused_attention_ab_sm90.cu (the A/B kernels #10, #11 and #13 in bf16,
// a block that walks many cells on one ring) and, through its pieces,
// fused_attention_q8in_sm90.cu (#12, a walk of its own over int8 q and v
// tiles), so their results on a row are the same bits. The fp32 walker (fused_attend_f32_sm90.cuh) shares its
// thread layout, online softmax and the walk of a block's cells (the end of
// this file). The flash forward (flash_attention.cu) runs its own softmax
// on this file's cell layout, descriptors and row epilogue.
//
// Rounding points (those of the TPU kernel, vitok_tpu/ops/fused_attention.py
// _attend_cell): logits in fp32 (bf16 products, fp32 accumulation) times
// (1/sqrt(d)) * log2(e); a masked key, and with a window a key with
// |i - j| > sw, filled with -1e30, a key past N with -inf; exp2 against the
// running row max, P rounded to bf16 before PV, fp32 accumulation, division
// by the fp32 row sum at the end.
//
// Thread layout: one warpgroup of four warps of 16 query rows. Thread
// (g = lane / 4, t = lane % 4) of warp w holds rows 16 w + g and + 8, and in
// a key tile the scores of keys 8 nt + 2 t + {0, 1} (the wgmma C fragment,
// the same as mma.sync m16n8k16's). S = Q K^T is wgmma m64n64k16 with Q and
// K from shared memory (K-major); O += P V is wgmma m64nDk16 with P from
// registers (S's accumulator rounded to bf16 is the A fragment) and V from
// shared memory, MN-major with the transpose flag.
//
// Which key tiles a cell walks: pass 0 the tiles that hold a valid key inside
// some row's window (key_tiles); a row that saw none there (a padded query
// row beyond the window's reach, an all-padding sample) averages v over all
// N keys on the TPU, so pass 1 then walks the skipped tiles in the order of
// rest_tile. Every key of a skipped tile is filled for every row of the
// cell, so for a row with a valid key they add exactly zero, and their K is
// never needed: the score is replaced by the fill whatever it was.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>

#include "norm_rope.cuh"
#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // query rows of a cell, keys per tile
constexpr int kThreads = 128;  // one warpgroup
constexpr int kStages = 2;     // key tiles in the ring
constexpr float kNegFill = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// One thread's share of a cell's online softmax: its two rows' running max
// (log2 units), their partial row sums and o's C fragment.
template <int D>
struct CellRows {
  float m0, m1;
  float l0, l1;
  float o[D / 2];

  __device__ __forceinline__ void reset() {
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }

  // Whether a row of this thread below N saw no valid key.
  __device__ __forceinline__ bool dead(int qrow0, int N) const {
    return (qrow0 < N && m0 <= kNegFill) || (qrow0 + 8 < N && m1 <= kNegFill);
  }
};

// This thread's first query row of the cell starting at q0.
__device__ __forceinline__ int cell_row0(int q0) { return q0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2); }

// The key tiles pass 0 walks for query rows [q0, q0 + 64) of a sample whose
// valid keys end at kv_end: [lo_tile, lo_tile + main_tiles) of n_tiles.
struct KeyTiles {
  int lo_tile, main_tiles, n_tiles;
};

__device__ __forceinline__ KeyTiles key_tiles(int q0, int N, int kv_end, int sw) {
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
  return {lo_tile, hi_tile - lo_tile, n_tiles};
}

// The i-th tile of pass 1: the tiles before pass 0's, then those after.
__device__ __forceinline__ int rest_tile(int i, const KeyTiles& kt) {
  return i < kt.lo_tile ? i : i + kt.main_tiles;
}

// Each key's state of tile [k0, k0 + 64) in st: 2 past N; 1 masked (a key
// at or past kv_end, a zero byte of mask_b, or any key of another image of
// a pack: `foreign`); 0 valid.
__device__ __forceinline__ void key_states(unsigned char* st, int k0, int N, const unsigned char* mask_b, int kv_end,
                                           bool foreign, int tid) {
  if (tid < kTile) {
    const int j = k0 + tid;
    st[tid] = j >= N ? 2 : ((foreign || j >= kv_end || (mask_b && !mask_b[j])) ? 1 : 0);
  }
}

// Starts the copies of key tile [k0, k0 + 64) into one ring slot: K from
// k_src (row stride k_stride; with read_k false zero-filled and not read),
// V from v_src, and the keys' states in st (key_states).
template <int D>
__device__ __forceinline__ void issue_kv_tile(unsigned char* kt, unsigned char* vt, unsigned char* st,
                                              const __nv_bfloat16* k_src, long long k_stride,
                                              const __nv_bfloat16* v_src, long long v_stride, int k0, int N,
                                              bool read_k, const unsigned char* mask_b, int kv_end, bool foreign,
                                              int tid) {
  load_tile_sw128<kTile, D, kThreads>(kt, k_src, k_stride, k0, read_k ? N : 0, nullptr, tid);
  load_tile_sw128<kTile, D, kThreads>(vt, v_src, v_stride, k0, N, nullptr, tid);
  key_states(st, k0, N, mask_b, kv_end, foreign, tid);
}

// The online-softmax update of one key tile for this thread's rows, given
// its logits s (the C fragment of S = Q K^T, fp32): scaled, filled where a
// key is masked, past N or outside the window, the running max moved, o and
// the row sums rescaled; leaves the tile's probabilities p = exp2(s - max)
// in s, unrounded. st: the tile's key states; k0 its first key.
template <int D>
__device__ __forceinline__ void softmax_tile(CellRows<D>& r, float (&s)[32], const unsigned char* st, int k0,
                                             int qrow0, int sw, float score_scale) {
  const int t = threadIdx.x & 3;
  const int qrow1 = qrow0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      const int qrow = (e < 2) ? qrow0 : qrow1;
      const int state = st[col];
      float v = __fmul_rn(s[4 * nt + e], score_scale);
      if (state == 2) {
        v = -INFINITY;
      } else if (state == 1 || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) {
        v = kNegFill;
      }
      s[4 * nt + e] = v;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
  }
  // Key k0 < N is in every tile, so the new max is finite.
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  const float a0 = exp2f(r.m0 - mn0), a1 = exp2f(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const float p0 = exp2f(__fsub_rn(s[4 * nt], mn0));
    const float p1 = exp2f(__fsub_rn(s[4 * nt + 1], mn0));
    const float p2 = exp2f(__fsub_rn(s[4 * nt + 2], mn1));
    const float p3 = exp2f(__fsub_rn(s[4 * nt + 3], mn1));
    ls0 += p0 + p1;
    ls1 += p2 + p3;
    s[4 * nt] = p0;
    s[4 * nt + 1] = p1;
    s[4 * nt + 2] = p2;
    s[4 * nt + 3] = p3;
  }
  r.l0 = r.l0 * a0 + ls0;
  r.l1 = r.l1 * a1 + ls1;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    r.o[4 * dt] *= a0;
    r.o[4 * dt + 1] *= a0;
    r.o[4 * dt + 2] *= a1;
    r.o[4 * dt + 3] *= a1;
  }
}

// One key tile's products and online-softmax update for this thread's rows:
// sQ the cell's normed Q tile, kt / vt / st the slot's K, V and key states,
// k0 the tile's first key.
template <int D>
__device__ __forceinline__ void attend_kv_tile(CellRows<D>& r, const unsigned char* sQ, const unsigned char* kt,
                                               const unsigned char* vt, const unsigned char* st, int k0, int qrow0,
                                               int sw, float score_scale) {
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc<kTile>(sQ, kk), kmajor_desc<kTile>(kt, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile<D>(r, s, st, k0, qrow0, sw, score_scale);
  // P rounded to bf16: the C fragment of key tiles (2j, 2j+1) is the A
  // fragment of k-step j.
  uint32_t pa[kTile / 16][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[4 * nt], s[4 * nt + 1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(r.o, pa[j], mnmajor_desc<kTile>(vt, j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
}

// The row sums over the four threads that share a row; then l0, l1 are the
// rows' full sums.
template <int D>
__device__ __forceinline__ void sum_rows(CellRows<D>& r) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l0 += __shfl_xor_sync(kFull, r.l0, off);
    r.l1 += __shfl_xor_sync(kFull, r.l1, off);
  }
}

// o / l of this thread's rows (after sum_rows) as bf16: out0 points at row
// qrow0's first channel of the head, out1 at row qrow0 + 8's; rows at or past
// N are not written.
template <int D>
__device__ __forceinline__ void store_rows(const CellRows<D>& r, __nv_bfloat16* out0, __nv_bfloat16* out1, int qrow0,
                                           int N) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (qrow0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
          __floats2bfloat162_rn(r.o[4 * dt] / r.l0, r.o[4 * dt + 1] / r.l0);
    if (qrow0 + 8 < N)
      *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
          __floats2bfloat162_rn(r.o[4 * dt + 2] / r.l1, r.o[4 * dt + 3] / r.l1);
  }
}

// The same in fp32 (the fp32 walker's output).
template <int D>
__device__ __forceinline__ void store_rows(const CellRows<D>& r, float* out0, float* out1, int qrow0, int N) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (qrow0 < N) *reinterpret_cast<float2*>(out0 + col) = make_float2(r.o[4 * dt] / r.l0, r.o[4 * dt + 1] / r.l0);
    if (qrow0 + 8 < N)
      *reinterpret_cast<float2*>(out1 + col) = make_float2(r.o[4 * dt + 2] / r.l1, r.o[4 * dt + 3] / r.l1);
  }
}

// The rotation tables a thread needs to norm a Q tile in place: for each of
// its kPasses rows of [r0, r0 + 64) (norm_rope_tile's thread layout), the
// bf16 pairs of cos and sin at its eight channels (zero past N).
template <int D>
struct RopeRows {
  static constexpr int kPieces = D / 16;  // threads per row
  static constexpr int kRowsPerPass = kThreads / kPieces;
  static constexpr int kPasses = kTile / kRowsPerPass;
  __nv_bfloat162 ce[kPasses][4], se[kPasses][4];

  // Loads them from a sample's [N, D/2] fp32 tables.
  __device__ __forceinline__ void load(const float* __restrict__ cos_t, const float* __restrict__ sin_t, int r0,
                                       int N, int tid) {
    const int c0 = (tid % kPieces) * 8;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int n = r0 + p * kRowsPerPass + tid / kPieces;
      float c[8] = {}, s[8] = {};
      if (n < N) {
        ld_f4x2(c, cos_t + (long long)n * (D / 2) + c0);
        ld_f4x2(s, sin_t + (long long)n * (D / 2) + c0);
      }
      rope_pairs(c, s, ce[p], se[p]);
    }
  }
};

// Normalises and rotates, in place, an sw128 tile that holds the raw rows
// [r0, r0 + 64) of one head's q (rows at or past N zero-filled): the thread
// layout and arithmetic of norm_rope_tile<D, kThreads, bf16, true>, so its
// bits. gain: the head's fp32 gain (shared memory); rope: the rows' tables.
// A thread reads and writes only its own pieces; the caller orders the
// writes before wgmma reads them.
template <int D>
__device__ __forceinline__ void norm_rope_sw128(unsigned char* tile, const RopeRows<D>& rope, const float* gain,
                                                int tid) {
  using R = RopeRows<D>;
  constexpr int kHalf = D / 2;
  const int c0 = (tid % R::kPieces) * 8;
#pragma unroll
  for (int p = 0; p < R::kPasses; ++p) {
    const int row = p * R::kRowsPerPass + tid / R::kPieces;
    unsigned char* lo = tile + sw128_offset<kTile>(row, c0);
    unsigned char* hi = tile + sw128_offset<kTile>(row, c0 + kHalf);
    const uint4 xr = *reinterpret_cast<const uint4*>(lo);
    const uint4 xi = *reinterpret_cast<const uint4*>(hi);
    float a[8], b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      a[e] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&xr)[e]);
      b[e] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&xi)[e]);
    }
    uint4 yr, yi;
    norm_rope_piece<D, true>(a, b, rope.ce[p], rope.se[p], gain + c0, gain + kHalf + c0, yr, yi);
    *reinterpret_cast<uint4*>(lo) = yr;
    *reinterpret_cast<uint4*>(hi) = yi;
  }
}

// One cell on its own ring (the forward, one cell a block): pass 0 over the
// cell's key tiles, then pass 1 over the skipped ones if a row of the block
// saw no valid key. issue(tile, slot) and compute(tile, slot) are the
// kernel's issue_kv_tile and attend_kv_tile calls (compute updates r); ends
// with every copy landed.
template <int D, typename Issue, typename Compute>
__device__ __forceinline__ void walk_cell(const KeyTiles& kt, const CellRows<D>& r, int qrow0, int N, Issue issue,
                                          Compute compute) {
  cp_async_ring<kStages>(kt.main_tiles, [&](int i) { return kt.lo_tile + i; }, issue, compute);
  if (__syncthreads_or(r.dead(qrow0, N)))
    cp_async_ring<kStages>(kt.n_tiles - kt.main_tiles, [&](int i) { return rest_tile(i, kt); }, issue, compute);
}

// ---------------------------------------------------------------------------
// A block that walks many cells (the A/B kernels of fused_attention_ab_sm90.cu
// and fused_attention_q8in_sm90.cu, and the fp32 walker of
// fused_attend_f32_sm90.cuh): a cell is one (image,
// head) pair of the block's query tile, and the block flattens its cells x
// key tiles into one sequence of steps.
// ---------------------------------------------------------------------------

// What a block knows of sample i before its walk (sInfo[i]): x the first
// tile of pass 0, y pass 0's tile count, z the tiles of each of its cells
// (pass 0 and, where some row may see no valid key, pass 1), w the key end
// where its valid keys are a prefix [0, w), else -1 (read the mask).
// THREADS: the block's threads.
template <int THREADS = kThreads>
__device__ __forceinline__ void sample_setup(int4* sInfo, const unsigned char* __restrict__ mask, int b0, int nb,
                                             int q0, int N, int sw, bool pack, int tid) {
  for (int i = tid; i < nb; i += THREADS) sInfo[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (mask) {  // w: one past the last valid key; z: the count of valid keys
    for (int i = 0; i < nb; ++i) {
      const unsigned char* m = mask + (long long)(b0 + i) * N;
      int last = 0, count = 0;
      for (int j = tid; j < N; j += THREADS)
        if (m[j]) {
          last = j + 1;
          ++count;
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        last = max(last, __shfl_xor_sync(kFull, last, off));
        count += __shfl_xor_sync(kFull, count, off);
      }
      if ((tid & 31) == 0) {
        atomicMax(&sInfo[i].w, last);
        atomicAdd(&sInfo[i].z, count);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nb; i += THREADS) {
    const int kv_end = mask ? sInfo[i].w : N;
    const bool prefix = !mask || sInfo[i].z == kv_end;
    const KeyTiles kt = key_tiles(q0, N, kv_end, sw);
    const int q_last = min(q0 + kTile, N) - 1;
    bool rest = kv_end == 0;
    if (sw >= 0) rest = rest || !prefix || q_last - sw >= kv_end;
    const int rest_tiles = (kt.n_tiles - kt.main_tiles) + (pack ? (nb - 1) * kt.n_tiles : 0);
    sInfo[i] = make_int4(kt.lo_tile, kt.main_tiles, kt.main_tiles + (rest ? rest_tiles : 0), prefix ? kv_end : -1);
  }
  __syncthreads();
}

// Where the walk stands: cell (i, hl) (image i of the block, head hl), its
// t-th tile, and the cell's number in the walk.
struct Cursor {
  int i, hl, t, cell;

  __device__ __forceinline__ void next(const int4* sInfo, int nh) {
    if (++t == sInfo[i].z) {
      t = 0;
      ++cell;
      if (++hl == nh) {
        hl = 0;
        ++i;
      }
    }
  }
};

// The key tile of step t of a cell of the block's image i (its sample's
// sInfo entry `info`; n_tiles key tiles a sample), and in *src the block
// image whose keys it holds: i, but for pass 1 of a pack the other images,
// in order.
__device__ __forceinline__ int step_tile(const int4& info, int t, int n_tiles, int i, int* src) {
  *src = i;
  if (t < info.y) return info.x + t;
  if (t < n_tiles) return rest_tile(t - info.y, KeyTiles{info.x, info.y, n_tiles});
  const int f = (t - n_tiles) / n_tiles;
  *src = f < i ? f : f + 1;
  return (t - n_tiles) % n_tiles;
}

}  // namespace
