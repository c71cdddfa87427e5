// The fp32 walker: the fused attention's fp32 function with its products on
// the tensor cores at fp32 accuracy, for a block that walks many cells
// (fused_attention_ab_f32_sm90.cu: the fp32 forward #1 and the A/B kernels
// #10, #11 and #13 in fp32).
//
// Rounding points are those of the fp32 body (fused_attend.cuh): q/k RMSNorm
// and the rotate-half RoPE in fp32 (norm_rope_piece_f32, the arithmetic of
// norm_rope_tile_f32); logits in fp32 times (1/sqrt(d)) * log2(e); a masked
// key, and with a window a key with |i - j| > sw, filled with -1e30, a key
// past N with -inf; exp2 against the running row max; P not rounded; fp32
// accumulation; division by the fp32 row sum at the end.
//
// The products: each fp32 operand x is split exactly into three bf16 pieces,
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (8 + 8 + 8 bits
// of x's 24), and a product of two operands is the six products of pieces
// mid*mid, lo*hi, hi*lo, mid*hi, hi*mid, hi*hi, small terms first, on
// wgmma m64nNk16 (bf16 inputs, exact products, fp32 accumulators): the
// six-pass bf16 form that the JAX package calls HIGHEST precision
// (vitok_tpu/ops/fused_attention.py, _norm_rope_half). The three terms it
// drops (mid*lo, lo*mid, lo*lo) are about 2^-24 of a product. S = Q K^T
// reads Q's and K's pieces from shared memory (K-major); O += P V takes P's
// pieces from the fp32 probabilities in registers as A fragments and V's
// pieces from shared memory, MN-major with the transpose flag, as the bf16
// body does (fused_attend_sm90.cuh, whose thread layout, online softmax and
// walk this shares).
//
// Shared memory: three pieces each of Q, K and V as sw128 tiles (144 KB at
// d = 128) beside one landing slot of raw fp32 K and V tiles (66 KB): a
// second slot does not fit beside the pieces at d = 128, so one block has
// the SM (217 KB; 108 KB at d = 64). The norms and splits run on the CUDA
// cores between a tile's landing and its products, so a block has two
// warpgroups that share them (walk_cells_f32): a producer that copies K a
// step ahead and norms and splits step i + 1's Q and K while step i's
// softmax and P V run, and a consumer that copies V a step ahead, splits it
// between S = Q K^T and the softmax, and runs the products. They hand Q's and
// K's pieces over through named barriers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_attend_sm90.cuh"
#include "norm_rope.cuh"
#include "sm90.cuh"

namespace {

// Threads of a block of the fp32 walker: a consumer and a producer
// warpgroup.
constexpr int kF32Threads = 2 * kThreads;

// Product x of the split (0 hi, 1 mid, 2 lo): the pieces of its two
// operands, mid*mid, lo*hi, hi*lo, mid*hi, hi*mid, hi*hi.
__device__ constexpr int split_a(int x) { return x == 0 || x == 3 ? 1 : (x == 1 ? 2 : 0); }
__device__ constexpr int split_b(int x) { return x == 0 || x == 4 ? 1 : (x == 2 ? 2 : 0); }

// x, y as three bf16x2 pieces whose sums are x and y exactly.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float rx = __fsub_rn(x, __low2float(h)), ry = __fsub_rn(y, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(rx, __low2float(m)), __fsub_rn(ry, __high2float(m)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Eight fp32 values of row `row`, channels [col, col + 8), into the three
// sw128 piece tiles at `pieces` (one after another).
template <int D>
__device__ __forceinline__ void store_split(unsigned char* pieces, int row, int col, const float (&v)[8]) {
  constexpr int kPieceBytes = kTile * D * 2;
  uint4 h, m, l;
  uint32_t* hp = reinterpret_cast<uint32_t*>(&h);
  uint32_t* mp = reinterpret_cast<uint32_t*>(&m);
  uint32_t* lp = reinterpret_cast<uint32_t*>(&l);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_bf16x2(v[2 * e], v[2 * e + 1], hp[e], mp[e], lp[e]);
  unsigned char* at = pieces + sw128_offset<kTile>(row, col);
  *reinterpret_cast<uint4*>(at) = h;
  *reinterpret_cast<uint4*>(at + kPieceBytes) = m;
  *reinterpret_cast<uint4*>(at + 2 * kPieceBytes) = l;
}

// Normalises and rotates rows [r0, r0 + 64) of one head's q or k in fp32
// (norm_rope_tile_f32's thread layout and arithmetic) and writes their
// pieces. src points at row r0's first channel (row stride `stride`, device
// or shared memory); rows at or past N become zeros and are not read. gain:
// the head's fp32 gain (shared memory); cos_b, sin_b: the sample's tables.
// THREADS threads.
template <int D, int THREADS>
__device__ __forceinline__ void norm_rope_split(const float* src, long long stride, int r0, int N, const float* gain,
                                                const float* __restrict__ cos_b, const float* __restrict__ sin_b,
                                                unsigned char* pieces, int tid) {
  constexpr int kHalf = D / 2;
  constexpr int kPieces = D / 16;  // threads per row
  constexpr int kRowsPerPass = THREADS / kPieces;
  constexpr int kPasses = kTile / kRowsPerPass;
  const int c0 = (tid % kPieces) * 8;
#pragma unroll 2
  for (int p = 0; p < kPasses; ++p) {
    const int row = p * kRowsPerPass + tid / kPieces;
    const int n = r0 + row;
    float a[8], b[8], c[8], s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = b[e] = c[e] = s[e] = 0.f;
    if (n < N) {
      ld_f4x2(a, src + row * stride + c0);
      ld_f4x2(b, src + row * stride + c0 + kHalf);
      ld_f4x2(c, cos_b + (long long)n * kHalf + c0);
      ld_f4x2(s, sin_b + (long long)n * kHalf + c0);
    }
    float vr[8], vi[8];
    norm_rope_piece_f32<D>(a, b, c, s, gain + c0, gain + kHalf + c0, vr, vi);
    store_split<D>(pieces, row, c0, vr);
    store_split<D>(pieces, row, c0 + kHalf, vi);
  }
}

// A raw fp32 tile of 64 rows (row stride raw_row floats) into its pieces,
// THREADS threads.
template <int D, int THREADS>
__device__ __forceinline__ void split_tile(const float* raw, int raw_row, unsigned char* pieces, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int u = 0; u < kTile * kChunks / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const int row = i / kChunks, col = (i % kChunks) * 8;
    float v[8];
    ld_f4x2(v, raw + row * raw_row + col);
    store_split<D>(pieces, row, col, v);
  }
}

// Copies rows [row0, row0 + 64) of D fp32 channels (row stride `stride`)
// into a raw tile of row stride D + 4 floats, 16 bytes a copy, THREADS
// threads; rows at or past N are zero-filled and not read.
template <int D, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride, int row0, int N,
                                              int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int u = 0; u < kTile * kChunks / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const int row = i / kChunks, ch = i % kChunks;
    const int j = row0 + row;
    const bool in = j < N;
    cp_async16(dst + row * (D + 4) + ch * 4, src + (long long)(in ? j : 0) * stride + ch * 4, in);
  }
}

// Asks the L2 for rows [r0, r0 + 64) (below N) of D fp32 channels, THREADS
// threads.
template <int D, int THREADS>
__device__ __forceinline__ void prefetch_rows_l2(const float* src, long long stride, int r0, int N, int tid) {
  constexpr int kLines = D * 4 / 128;  // 128-byte lines a row
  for (int i = tid; i < kTile * kLines; i += THREADS) {
    const int j = r0 + i / kLines;
    if (j < N) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + (long long)j * stride + (i % kLines) * 32));
  }
}

// S = Q K^T for this thread's rows from the pieces of the cell's Q (sQ) and
// the tile's K (sK): the C fragment of the logits, fp32.
template <int D>
__device__ __forceinline__ void scores_split(float (&s)[32], const unsigned char* sQ, const unsigned char* sK) {
  constexpr int kPieceBytes = kTile * D * 2;
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<kTile>(sQ + split_a(x) * kPieceBytes, kk),
                   kmajor_desc<kTile>(sK + split_b(x) * kPieceBytes, kk), x > 0 || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// P's pieces from the probabilities p (the C fragment softmax_tile leaves;
// that of key tiles (2j, 2j+1) is the A fragment of k-step j).
__device__ __forceinline__ void split_p(const float (&p)[32], uint32_t (&pa)[3][kTile / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int j = nt >> 1, e = (nt & 1) * 2;
    split_bf16x2(p[4 * nt], p[4 * nt + 1], pa[0][j][e], pa[1][j][e], pa[2][j][e]);
    split_bf16x2(p[4 * nt + 2], p[4 * nt + 3], pa[0][j][e + 1], pa[1][j][e + 1], pa[2][j][e + 1]);
  }
}

// O += P V from P's pieces and the tile's V pieces (sV).
template <int D>
__device__ __forceinline__ void accumulate_pv_split(CellRows<D>& r, const uint32_t (&pa)[3][kTile / 16][4],
                                                    const unsigned char* sV) {
  constexpr int kPieceBytes = kTile * D * 2;
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j)
      wgmma_rs<D>(r.o, pa[split_a(x)][j], mnmajor_desc<kTile>(sV + split_b(x) * kPieceBytes, j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
}

template <int D>
struct WalkSmemF32 {
  static constexpr int kPieceBytes = kTile * D * 2;             // one bf16 sw128 tile
  static constexpr int kRawRow = D + 4;                         // floats a raw row (16 bytes of padding)
  static constexpr int kQ = 0;                                  // Q's three pieces
  static constexpr int kK = kQ + 3 * kPieceBytes;               // K's three pieces
  static constexpr int kV = kK + 3 * kPieceBytes;               // V's three pieces
  static constexpr int kRawK = kV + 3 * kPieceBytes;            // the landing slot: raw K
  static constexpr int kRawV = kRawK + kTile * kRawRow * 4;     // and raw V
  static constexpr int kState = kRawV + kTile * kRawRow * 4;    // two tiles' key states
  static constexpr int kGain = kState + 2 * kTile;              // q's gain, then k's: 2 x D floats
  static constexpr int kSample = kGain + 2 * D * 4;             // an int4 per sample of the block
  static constexpr size_t bytes(int nb) { return kSample + nb * sizeof(int4) + 1024; }  // + alignment slack
};

// Named barriers (0 is __syncthreads): the producer fills Q's and K's
// pieces and arrives at kFullKQ, where the consumer syncs; the consumer
// arrives at kEmptyKQ when its S = Q K^T has read them, where the producer
// syncs before it writes them again. kProducer and kConsumer order each
// warpgroup's own threads.
constexpr int kFullKQ = 1, kEmptyKQ = 2, kProducer = 3, kConsumer = 4;

// The cells of one block, as walk_cells of fused_attention_ab_sm90.cu: query
// tile blockIdx.x of images [b0, b0 + nb) x heads [h0, h0 + nh), image by
// image; with `pack` the nb images are one pack. qkv [B, N, 3C] fp32 (q and
// k normed here); out [B, N, C] fp32. Two warpgroups. The producer (threads
// 128-255) copies each step's raw K into its landing slot a step ahead, and
// norms and splits step i + 1's K (and at a cell's first step its Q) into
// their pieces while the consumer runs step i's softmax and P V. The
// consumer (threads 0-127) copies each step's raw V a step ahead, splits it
// after the step's S = Q K^T, and runs the products and the online softmax.
template <int D>
__device__ __forceinline__ void walk_cells_f32(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                               const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                               const float* __restrict__ sin_t,
                                               const unsigned char* __restrict__ mask, float* __restrict__ out,
                                               int N, int H, int b0, int nb, int h0, int nh, int sw,
                                               float score_scale, bool pack) {
  using S = WalkSmemF32<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  float* sRawK = reinterpret_cast<float*>(smem + S::kRawK);
  float* sRawV = reinterpret_cast<float*>(smem + S::kRawV);
  unsigned char* sState = smem + S::kState;
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);
  int4* sInfo = reinterpret_cast<int4*>(smem + S::kSample);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const int n_tiles = (N + kTile - 1) / kTile;
  for (int i = tid; i < D; i += kF32Threads) {
    sGain[i] = q_scale[i];
    sGain[D + i] = k_scale[i];
  }
  sample_setup<kF32Threads>(sInfo, mask, b0, nb, q0, N, sw, pack, tid);  // ends synchronised
  int steps = 0;
  for (int i = 0; i < nb; ++i) steps += nh * sInfo[i].z;
  // plane 0 q, 1 k, 2 v of head h of image b
  auto plane = [&](int b, int part, int h) { return qkv + (long long)b * N * row_stride + part * C + h * D; };
  Cursor at = {0, 0, 0, 0};  // the step this warpgroup works on
  Cursor in = {0, 0, 0, 0};  // the next step whose copies it issues

  if (tid >= kThreads) {  // the producer: Q and K
    const int ptid = tid - kThreads;
    // The copies of the next step's K (pass 0 only: pass 1's scores are all
    // filled, its K is not read), and the L2 asked for its cell's Q.
    auto issue_k = [&]() {
      const int4 info = sInfo[in.i];
      int src;
      const int tile = step_tile(info, in.t, n_tiles, in.i, &src);
      if (in.t < info.y)
        load_rows_f32<D, kThreads>(sRawK, plane(b0 + in.i, 1, h0 + in.hl), row_stride, tile * kTile, N, ptid);
      if (in.t == 0) prefetch_rows_l2<D, kThreads>(plane(b0 + in.i, 0, h0 + in.hl), row_stride, q0, N, ptid);
      cp_async_commit();
      in.next(sInfo, nh);
    };
    if (steps > 0) issue_k();
    for (int it = 0; it < steps; ++it) {
      const int4 info = sInfo[at.i];
      const int b = b0 + at.i;
      const int h = h0 + at.hl;
      const float* cos_b = cos_t + (long long)b * N * (D / 2);
      const float* sin_b = sin_t + (long long)b * N * (D / 2);
      int src;
      const int tile = step_tile(info, at.t, n_tiles, at.i, &src);
      if (it > 0) bar_sync(kEmptyKQ, kF32Threads);  // step it - 1's S has read Q and K
      cp_async_wait<0>();                           // this step's K has landed
      bar_sync(kProducer, kThreads);
      if (at.t == 0)
        norm_rope_split<D, kThreads>(plane(b, 0, h) + q0 * row_stride, row_stride, q0, N, sGain, cos_b, sin_b, sQ,
                                     ptid);
      if (at.t < info.y)
        norm_rope_split<D, kThreads>(sRawK, S::kRawRow, tile * kTile, N, sGain + D, cos_b, sin_b, sK, ptid);
      fence_proxy_async();
      bar_arrive(kFullKQ, kF32Threads);
      bar_sync(kProducer, kThreads);  // the raw K is read
      if (it + 1 < steps) issue_k();
      at.next(sInfo, nh);
    }
    return;
  }

  // The consumer: V, the products and the softmax. This thread's two query
  // rows are qrow0 and qrow0 + 8.
  const int qrow0 = cell_row0(q0);
  // The copies of the next step's V and its keys' states.
  auto issue_v = [&](int step) {
    const int4 info = sInfo[in.i];
    int src;  // the block image the key tile belongs to
    const int tile = step_tile(info, in.t, n_tiles, in.i, &src);
    load_rows_f32<D, kThreads>(sRawV, plane(b0 + src, 2, h0 + in.hl), row_stride, tile * kTile, N, tid);
    const unsigned char* mask_b = (mask && info.w < 0) ? mask + (long long)(b0 + in.i) * N : nullptr;
    key_states(sState + (step & 1) * kTile, tile * kTile, N, mask_b, info.w < 0 ? N : info.w, src != in.i, tid);
    cp_async_commit();
    in.next(sInfo, nh);
  };
  if (steps > 0) issue_v(0);
  CellRows<D> r;
  for (int it = 0; it < steps; ++it) {
    const int4 info = sInfo[at.i];
    int src;
    const int tile = step_tile(info, at.t, n_tiles, at.i, &src);
    const bool more = it + 1 < steps;
    if (at.t == 0) r.reset();
    float s[32];
    bar_sync(kFullKQ, kF32Threads);
    scores_split<D>(s, sQ, sK);
    if (more) bar_arrive(kEmptyKQ, kF32Threads);
    cp_async_wait<0>();  // this step's V and key states have landed
    bar_sync(kConsumer, kThreads);
    split_tile<D, kThreads>(sRawV, S::kRawRow, sV, tid);
    fence_proxy_async();
    bar_sync(kConsumer, kThreads);  // V's pieces are written; the raw V is read
    if (more) issue_v(it + 1);
    softmax_tile<D>(r, s, sState + (it & 1) * kTile, tile * kTile, qrow0, sw, score_scale);
    uint32_t pa[3][kTile / 16][4];
    split_p(s, pa);
    accumulate_pv_split<D>(r, pa, sV);
    if (at.t == info.z - 1) {  // the cell's last tile: its rows are done
      sum_rows<D>(r);
      float* out0 = out + ((long long)(b0 + at.i) * N + qrow0) * C + (h0 + at.hl) * D;
      store_rows<D>(r, out0, out0 + 8LL * C, qrow0, N);
    }
    at.next(sInfo, nh);
  }
}

}  // namespace
