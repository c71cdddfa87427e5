// The flash family in fp32: the forward (#4), dq (#5) and dk/dv (#6), each
// in a plain instance and, for the backward, a fold instance that ends in the
// q/k RMSNorm and RoPE backward; the fold instances also serve the fused
// attention's fp32 backward (#3), at its lse's units.
//
// Replaces, on f32, the TPU kernels vitok_tpu/ops/flash_attention.py
// ::_attn_kernel (launcher _flash_fwd), ::_dq_kernel and ::_dkv_kernel
// (launcher _flash_bwd), and vitok_tpu/ops/fused_attention.py
// ::_fused_bwd_kernel (launcher _fused_bwd). The Pallas kernels are generic
// in their dtype; on f32 their casts (qs to q's dtype, p and ds to v's) are
// no-ops, so the function is the bf16 kernels' (flash_attention.cu,
// flash_attention_bwd.cu, fused_attention_bwd.cu) with no rounding to bf16:
//   * logits s = q k^T in fp32 times scale = 1/sqrt(d), the scale folded into
//     the exponent (p = exp2(s * scale * log2(e) - m)): the TPU kernel
//     prescales q, q * scale, which in fp32 moves a logit by at most 2^-24 of
//     itself, the order of the products' own error below;
//   * a masked key, a key outside the window |i - j| <= sw and a key past N
//     give p = 0; a row with no live key gives 0 and the dead lse 1e30; padded
//     query rows are written as 0 (forward) and carry a zero cotangent
//     (backward, whose rows at or past a sample's valid count are never
//     walked);
//   * the forward's lse = m + log(l) in natural-log units; the backward's
//     p = exp(s * scale - lse), with the fused backward's lse in log2 units
//     (its forward, the fp32 walker, writes it so): lse_factor below;
//   * dp = dO v^T, ds = p (dp - delta) with delta = sum_d dO * O from the
//     forward's output; dq = scale * ds k, dv = p^T dO, dk = scale * ds^T q,
//     p and ds unrounded; fp32 accumulation and fp32 outputs.
//
// Products: the fp32 walker's scheme (fused_attend_f32_sm90.cuh): every fp32
// operand split exactly into three bf16 pieces (hi, mid, lo), each product
// the six bf16 wgmma products of pieces that the JAX package's f32 HIGHEST
// precision takes, with fp32 accumulation; the operand read from registers
// (P, dS, and in dk/dv P^T and dS^T) is split in registers, the others are
// split into sw128 piece tiles in shared memory, which serve both operand
// majors (K of S = Q K^T and of dQ += dS K; Q and dO of dK/dV).
//
// What bounds them on an H100: operations. Each product is six bf16
// products, so the forward does 6 x 2 products a live (query, key) pair, dq
// 6 x 3 and dk/dv 6 x 4, 2 * d flops each, at 989 TFLOP/s: at 350M 1024p
// with sw 1024 (B 2, N 4096, 16 heads of 64) the forward's 235M live pairs
// are 0.365 ms against 0.040 ms for its 134 MB of fp32 q, k, v and out.
//
// Design, a simple instance first (PERF.md has its times):
//   * no landing slot: a tile's fp32 rows are read from device memory (the
//     L2 asked for the next tile's lines a tile ahead) and split on the way
//     into shared memory, so the piece tiles alone hold shared memory:
//     forward Q, K, V (144 KB at d = 128), dq Q, dO, K, V and dk/dv K, V,
//     Q, dO (192 KB at d = 128);
//   * forward and dq: one warpgroup of 64 query rows a block, walking the
//     block's live key tiles: split K and V, S (and dP), the softmax (or p
//     and ds), P V (or dS K), a block barrier a tile; the forward at d = 192
//     and 256 (whole Q, K and V pieces: 217 KB, and 289 KB past a block's
//     227 KB) keeps V's pieces one 64-column slab at a time, P V a slab of
//     O's columns at a time (accumulate_pv_slab: two block barriers a slab
//     past the first);
//   * dk/dv: one block of 64 key rows, two warpgroups that share its tiles:
//     at d = 128 the two fp32 accumulators and the pieces of P^T and dS^T do
//     not fit one thread's registers, so warpgroup 0 forms S^T, p^T and
//     dV += P^T dO and hands p^T over shared memory to warpgroup 1, which
//     forms dP^T, ds^T and dK += dS^T Q: four products a tile pair, seven
//     with dq's three, as the bf16 kernels;
//   * each product read from registers (P V, dS K, P^T dO, dS^T Q) sums one
//     tile into a fresh accumulator, added to the running sum on the CUDA
//     cores (rs_split_add): summed over every tile on the tensor cores, #4
//     read about ten times its plain version's error against float64 on an
//     H100 at 2048 keys (PERF.md); dk/dv takes 64 columns a pass, since a
//     whole-width fresh accumulator spills at d = 128;
//   * the fold: q and k are the fp32 q/k prologue's qrot, krot (views of its
//     [B, N, 2C] scratch), v, dqkv views of the flat [B, N, 3C]; dq's and
//     dk's gradients of the rotated rows go through norm_rope_bwd_tile's
//     fp32 instance into dqkv, the gains' partials to [B, H, tiles, D];
//   * dq and dk/dv at d = 192 and 256 (DqWideSmem, DkvWideSmem) keep two
//     operands' pieces whole and stream the other two through 64-column
//     slabs; dk/dv forms p^T in both warpgroups (see WideSmem).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; launches are asynchronous on the caller's stream and each
// entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "fused_attend_f32_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kDeadLse = 1e30f;
constexpr int kBarP = 5;  // dk/dv: warpgroup 0's p^T is in shared memory

struct Strides {  // elements between samples, tokens and heads
  long long b, n, h;
};

// The fold's epilogue: the raw q or k plane of qkv (sample 0, head 0,
// channel 0) and the same plane of dqkv, row stride `row_stride`; the gain,
// the RoPE tables [B, N, D/2] and the gain partials [B, H, tiles, D].
struct Fold {
  const float* raw;
  const float* gain;
  const float* cos_t;
  const float* sin_t;
  float* dst;
  float* part;
  long long row_stride;
};

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc = A B^T contracted over D channels, A's and B's pieces K-major: the six
// products of pieces, issued (the caller fences, commits and waits).
template <int D>
__device__ __forceinline__ void ss_split(float (&acc)[32], const unsigned char* a, const unsigned char* b) {
  constexpr int kP = kTile * D * 2;
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(acc, kmajor_desc<kTile>(a + split_a(x) * kP, kk), kmajor_desc<kTile>(b + split_b(x) * kP, kk),
                   x > 0 || kk > 0);
}

// acc += X B, X's pieces the A fragments (split_p of a C fragment), B's
// pieces read MN-major (its 64 rows contracted), N of the D columns a pass:
// each pass sums the tile into a fresh accumulator, added to acc on the CUDA
// cores (the tensor cores' fp32 sums stay one tile long), issued and waited.
template <int D, int N>
__device__ __forceinline__ void rs_split_add(float (&acc)[D / 2], const uint32_t (&xa)[3][kTile / 16][4],
                                             const unsigned char* b) {
  constexpr int kP = kTile * D * 2;
  static_assert(N == D || N == 64, "whole sw128 slabs a pass");
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += N) {
    float part[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < 6; ++x)
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j)
        wgmma_rs<N>(part, xa[split_a(x)][j],
                    mnmajor_desc<kTile>(b + split_b(x) * kP + c0 / 64 * kTile * kSwRowBytes, j), x > 0 || j > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[c0 / 2 + i] += part[i];
  }
}

// The live range [lo, hi) of the other axis for rows [r0, r_end) of a sample
// whose rows at or past `valid` are padding (empty when r0 >= r_end): with a
// window, within sw of the rows. As tiles: the first, and how many.
__device__ __forceinline__ int live_tiles(int r0, int r_end, int valid, int sw, int* first) {
  int lo = 0, hi = r0 < r_end ? valid : 0;
  if (sw >= 0 && r0 < r_end) {
    lo = max(0, r0 - sw);
    hi = min(valid, r_end - 1 + sw + 1);
  }
  *first = lo / kTile;
  return hi > lo ? (hi + kTile - 1) / kTile - *first : 0;
}

// Bits of the valid keys of tile [k0, k0 + 64) into bits[0..1] (threads 0-63
// of the block): keys below `lead` are valid, none at or past `valid`, the
// mask decides between.
__device__ __forceinline__ void key_bits(uint32_t* bits, int k0, int lead, int valid, const unsigned char* mask_b,
                                         int tid) {
  if (tid < kTile) {
    const int j = k0 + tid;
    const unsigned v = __ballot_sync(kFull, j < lead || (j < valid && mask_b[j]));
    if ((tid & 31) == 0) bits[tid >> 5] = v;
  }
}

// Whether this thread's element e of column group nt is live: its column's
// bit in `cols` and, with a window, |row - col| <= sw (row: the element's
// row less the tile's first column).
__device__ __forceinline__ bool live_at(uint64_t cols, int nt, int e, int row0, int row1, int sw) {
  const int col = nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
  const int row = e < 2 ? row0 : row1;
  return ((cols >> col) & 1) && (sw < 0 || abs(row - col) <= sw);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Q's and K's pieces whole; V's whole up to d = 128, and at d = 192 and 256
// one 64-column slab of them at a time (217 KB at d = 256 beside Q and K,
// where whole V pieces would make 289 KB).
template <int D>
struct FwdSmem {
  static constexpr int kP = kTile * D * 2;  // one piece tile
  static constexpr int kVCols = D > 128 ? 64 : D;
  static constexpr int kQ = 0, kK = 3 * kP, kV = 6 * kP;
  static constexpr int kBytes = kV + 3 * kTile * kVCols * 2 + 1024;  // + alignment slack
};

// One key tile's online-softmax update of this thread's rows from the raw
// logits s (q k^T): dead keys -inf, the running max m in log2 units (the
// tile's raw max times c = scale * log2(e)), p = exp2(fma(s, c, -m)) left in
// s, unrounded; a row that has seen no live key keeps m = -inf and p = 0.
template <int D>
__device__ __forceinline__ void softmax_f32(CellRows<D>& r, float (&s)[32], uint64_t keys, int row0, int row1, int sw,
                                            float c) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!live_at(keys, nt, e, row0, row1, sw)) s[4 * nt + e] = -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, __fmul_rn(mx0, c)), mn1 = fmaxf(r.m1, __fmul_rn(mx1, c));
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = ex2_ftz(r.m0 - mu0), a1 = ex2_ftz(r.m1 - mu1);
  r.m0 = mn0;
  r.m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    s[4 * nt] = ex2_ftz(fmaf(s[4 * nt], c, -mu0));
    s[4 * nt + 1] = ex2_ftz(fmaf(s[4 * nt + 1], c, -mu0));
    s[4 * nt + 2] = ex2_ftz(fmaf(s[4 * nt + 2], c, -mu1));
    s[4 * nt + 3] = ex2_ftz(fmaf(s[4 * nt + 3], c, -mu1));
    ls0 += s[4 * nt] + s[4 * nt + 1];
    ls1 += s[4 * nt + 2] + s[4 * nt + 3];
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

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                           Strides qs, Strides ks, Strides vs,
                           const unsigned char* __restrict__ mask,  // [B, N] or null
                           const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                           float* __restrict__ out,                 // [B, N, H, D]
                           float* __restrict__ lse,                 // [B, H, N] or null
                           int B, int N, int H, int sw, float c) {
  using S = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  __shared__ uint32_t sKeyBits[2];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q_b = q + b * qs.b + h * qs.h;
  const float* k_b = k + b * ks.b + h * ks.h;
  const float* v_b = v + b * vs.b + h * vs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int first;
  const int n_tiles = live_tiles(q0, min(q0 + kTile, N), valid, sw, &first);

  split_rows<D, kThreads>(sQ, q_b, qs.n, q0, N, nullptr, tid);
  const int qrow0 = cell_row0(q0), qrow1 = qrow0 + 8;
  CellRows<D> r;
  r.reset();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (first + it) * kTile;
    __syncthreads();  // every warp is done with the last tile's pieces
    split_rows<D, kThreads>(sK, k_b, ks.n, k0, N, nullptr, tid);
    split_rows<S::kVCols, kThreads>(sV, v_b, vs.n, k0, N, nullptr, tid);  // wide heads: V's first slab
    key_bits(sKeyBits, k0, lead, valid, mask_b, tid);
    if (it + 1 < n_tiles) {
      prefetch_rows_l2<D, kThreads>(k_b, ks.n, k0 + kTile, N, tid);
      prefetch_rows_l2<D, kThreads>(v_b, vs.n, k0 + kTile, N, tid);
    }
    fence_proxy_async();
    __syncthreads();
    const uint64_t keys = (uint64_t)sKeyBits[1] << 32 | sKeyBits[0];
    float s[32];
    wgmma_fence();
    ss_split<D>(s, sQ, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax_f32<D>(r, s, keys, qrow0 - k0, qrow1 - k0, sw, c);
    uint32_t pa[3][kTile / 16][4];
    split_p(s, pa);
    if constexpr (D <= 128) {
      rs_split_add<D, D>(r.o, pa, sV);
    } else {  // O's columns a 64-column slab of V at a time, each into a fresh accumulator
#pragma unroll
      for (int cs = 0; cs < D / 64; ++cs) {
        if (cs > 0) {
          __syncthreads();  // every warp's products have read slab cs - 1
          split_rows<64, kThreads>(sV, v_b + cs * 64, vs.n, k0, N, nullptr, tid);
          fence_proxy_async();
          __syncthreads();
        }
        accumulate_pv_slab<D>(r.o, cs, pa, sV);
      }
    }
  }

  sum_rows<D>(r);
  const int t = tid & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qrow = rr ? qrow1 : qrow0;
    if (qrow >= N) continue;
    const float l = rr ? r.l1 : r.l0;
    const float m = rr ? r.m1 : r.m0;
    const bool keep = l > 0.f && (mask_b == nullptr || mask_b[qrow]);  // padded and dead rows: 0
    float* dst = out + (((long long)b * N + qrow) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x0 = keep ? __fdiv_rn(r.o[4 * dt + 2 * rr], l) : 0.f;
      const float x1 = keep ? __fdiv_rn(r.o[4 * dt + 2 * rr + 1], l) : 0.f;
      *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(x0, x1);
    }
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * N + qrow] = l > 0.f ? __fmul_rn(m, kLn2) + logf(l) : kDeadLse;
  }
}

// ---------------------------------------------------------------------------
// The fold's epilogue: a 64-row tile's fp32 gradient of the rotated rows,
// staged in shared memory, through the rotation's transpose and the RMSNorm
// backward into a plane of dqkv, and the gain's partial of the tile.
// ---------------------------------------------------------------------------

template <int D, int THREADS>
__device__ __forceinline__ void fold_rows(const float* stage, float* part, const Fold& f, int b, int h, int H, int N,
                                          int r0, int tile, int tid) {
  const int tiles = (N + kTile - 1) / kTile;
  const long long plane = (long long)b * N * f.row_stride + h * D;
  norm_rope_bwd_tile<D, THREADS>(stage, f.raw + plane, f.row_stride, r0, N, f.gain,
                                 f.cos_t + (long long)b * N * (D / 2), f.sin_t + (long long)b * N * (D / 2),
                                 f.dst + plane, part, f.part + (((long long)b * H + h) * tiles + tile) * D, tid);
}

// acc * scale (this warpgroup's C fragment of 64 rows x D) into the stage,
// row stride D + 4 floats.
template <int D>
__device__ __forceinline__ void stage_rows(float* stage, const float (&acc)[D / 2], float scale) {
  const int wtid = threadIdx.x % kThreads;
  const int row = (wtid >> 5) * 16 + ((wtid & 31) >> 2);
  const int t = wtid & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<float2*>(stage + row * (D + 4) + col) =
        make_float2(__fmul_rn(acc[4 * dt], scale), __fmul_rn(acc[4 * dt + 1], scale));
    *reinterpret_cast<float2*>(stage + (row + 8) * (D + 4) + col) =
        make_float2(__fmul_rn(acc[4 * dt + 2], scale), __fmul_rn(acc[4 * dt + 3], scale));
  }
}

// This warpgroup's rows of acc * scale to dst (row `krow0` and + 8 of the
// block's tile; element strides ds), rows at or past N not written.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, Strides ds, int b, int h, int row0, int N,
                                               const float (&acc)[D / 2], float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= N) continue;
    float* p = dst + b * ds.b + row * ds.n + h * ds.h + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<float2*>(p + dt * 8) =
          make_float2(__fmul_rn(acc[4 * dt + 2 * rr], scale), __fmul_rn(acc[4 * dt + 2 * rr + 1], scale));
  }
}

// ---------------------------------------------------------------------------
// The backward's layouts at d = 192 and 256
// ---------------------------------------------------------------------------
//
// The d 128 layouts hold four operands as three bf16 pieces each: 288 and
// 384 KB at d 192 and 256 against the 227 KB a block may have. There each
// kernel keeps whole the two operands that stay for its whole walk (dq its
// Q and dO rows, dk/dv its K and V rows: 144 and 192 KB) and streams the
// other two through 64-column slabs of pieces (24 KB: two slabs where they
// fit, at d 192, one at d 256). The products that contract over D (S and dP,
// or S^T and dP^T) sum a slab at a time, each slab's into a fresh accumulator
// added on the CUDA cores (ss_slab); those whose columns are D's (dQ += dS K;
// dV += P^T dO and dK += dS^T Q) take the slab of their columns so too
// (accumulate_pv_slab), so a streamed operand is split twice a tile, the
// second time from the L2 (but the slab still in a buffer). At d 256 p^T has
// no room beside a slab (K, V, a slab and p^T: 232 KB), so in dk/dv both
// warpgroups form S^T and p^T (the same products, the same bits) and
// warpgroup 1 also dP^T: five products a tile pair where d 128 has four.

template <int D>
struct WideSmem {
  static constexpr int kP = kTile * D * 2;      // one piece tile of D columns
  static constexpr int kSlab = kTile * 64 * 2;  // one of a 64-column slab
  static constexpr int kBuf = 6 * kP;           // after the two whole operands' pieces
  static constexpr int kRows = 2 * kTile * 4;   // a tile's lse and delta
  // Two slab buffers where they fit beside the rows and the alignment slack.
  static constexpr int kBufs = kBuf + 6 * kSlab + kRows + 1024 <= 232448 - 1024 ? 2 : 1;
  static constexpr int kSlabB = kBuf + (kBufs - 1) * 3 * kSlab;  // the second streamed operand's slab
  static constexpr int kLse = kBuf + kBufs * 3 * kSlab;
  static constexpr int kDelta = kLse + kTile * 4;
  static constexpr int kEnd = kDelta + kTile * 4;
  static constexpr int kBytes = kEnd + 1024;
  static constexpr int kStage = kTile * (D + 4) * 4;
  static_assert(kStage + nr_bwd_part_bytes<D, 2 * kThreads>() <= kEnd, "the fold's epilogue fits over the tiles");
  static_assert(kBytes + 512 <= 232448, "a block's shared memory");
};

// acc (+)= A B^T over slab c's 64 channels: A's pieces whole (D columns,
// its k-steps 4c to 4c + 3), B's the slab's three piece tiles, both K-major:
// the slab's six products of pieces, small terms first, into a fresh
// accumulator added to acc on the CUDA cores (first: acc is that sum);
// issued and waited. Summed on the tensor cores across slabs, a slab's small
// terms would meet the larger sum of the slabs before it: dq at d 256 read
// 2.3 times its plain version's error from float64 on an H100 so (PERF.md).
template <int D>
__device__ __forceinline__ void ss_slab(float (&acc)[32], const unsigned char* a, int c, const unsigned char* slab,
                                        bool first) {
  constexpr int kP = kTile * D * 2, kSlab = kTile * 64 * 2;
  float part[32];
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(part, kmajor_desc<kTile>(a + split_a(x) * kP, 4 * c + kk),
                   kmajor_desc<kTile>(slab + split_b(x) * kSlab, kk), x > 0 || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// delta = sum_d dO * O of rows [q0, q0 + 64), 0 on padded rows, into sDelta
// and delta_bh (the sample's and head's [N] row of delta): a row's D
// channels over kLanes neighbouring threads of the warpgroup, 8 each (D/8
// rounded up to a power of two: at d = 192 32 lanes, of which 24 hold
// channels and the others add 0).
template <int D>
__device__ __forceinline__ void rows_delta(float* sDelta, float* delta_bh, const float* o_b, Strides os,
                                           const float* g_b, Strides gs, const unsigned char* mask_b, int q0, int N,
                                           int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kLanes = pow2_at_least(kChunks);
  const int lane = tid % kLanes, ch = lane * 8;
  for (int row = tid / kLanes; row < kTile; row += kThreads / kLanes) {
    const int n = q0 + row;
    float acc = 0.f;
    if (n < N && lane < kChunks && (mask_b == nullptr || mask_b[n])) {
      float o[8], g[8];
      ld_f4x2(o, o_b + n * os.n + ch);
      ld_f4x2(g, g_b + n * gs.n + ch);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(g[e], o[e], acc);
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) {
      sDelta[row] = acc;
      if (n < N) delta_bh[n] = acc;
    }
  }
}

template <int D>
struct DqSmem {
  static constexpr int kP = kTile * D * 2;
  static constexpr int kQ = 0, kG = 3 * kP, kK = 6 * kP, kV = 9 * kP;
  static constexpr int kEnd = 12 * kP;
  static constexpr int kBytes = kEnd + 1024;
  // The fold's epilogue over the tiles: the fp32 stage, then the partials.
  static constexpr int kStage = kTile * (D + 4) * 4;
  static_assert(kStage + kThreads / (D / 16) * D * 4 <= kEnd, "the fold's epilogue fits over the tiles");
};

// At d 192 and 256: Q's and dO's pieces whole, one 64-column slab each of
// K's and V's (one buffer for both where two do not fit).
template <int D>
struct DqWideSmem : WideSmem<D> {
  using W = WideSmem<D>;
  static constexpr int kQ = 0, kG = 3 * W::kP, kK = W::kBuf, kV = W::kSlabB;
};

template <int D>
using DqLayout = std::conditional_t<(D > 128), DqWideSmem<D>, DqSmem<D>>;

// One warpgroup of 64 query rows a block. Without kFold: q, k, v, dout, out
// views; writes delta [B, H, N] (0 on padded rows) for itself and dk/dv, and
// dq. With kFold: delta given (the prologue's), dq through the fold.
// lse_factor: the stored lse times it is the exponent's (log2e: natural log;
// 1: log2 units). At d 192 and 256 on DqWideSmem: S and dP, then dQ, a slab
// at a time.
template <int D, bool kFold>
__device__ __forceinline__ void dq_body(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, const float* __restrict__ dout, Strides qs,
                                        Strides ks, Strides vs, Strides gs, const float* __restrict__ lse,
                                        float* __restrict__ delta, const unsigned char* __restrict__ mask,
                                        const int* __restrict__ counts, const float* __restrict__ out, Strides os,
                                        float* __restrict__ dq, Strides dqs, const Fold& fold, int B, int N, int H,
                                        int sw, float c, float lse_factor, float scale) {
  using S = DqLayout<D>;
  constexpr int kSlabs = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  __shared__ uint32_t sKeyBits[2];
  __shared__ float sDelta[kTile];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q_b = q + b * qs.b + h * qs.h;
  const float* k_b = k + b * ks.b + h * ks.h;
  const float* v_b = v + b * vs.b + h * vs.h;
  const float* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long row_base = ((long long)b * H + h) * N;
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int first;
  const int n_tiles = live_tiles(q0, min(min(q0 + kTile, N), valid), valid, sw, &first);
  if (n_tiles > 0) {
    split_rows<D, kThreads>(sQ, q_b, qs.n, q0, N, nullptr, tid);
    split_rows<D, kThreads>(sG, g_b, gs.n, q0, N, mask_b, tid);  // padded rows zeroed
  }

  const int qrow0 = cell_row0(q0), qrow1 = qrow0 + 8;
  const float nl0 = -__fmul_rn(qrow0 < N ? lse[row_base + qrow0] : kDeadLse, lse_factor);
  const float nl1 = -__fmul_rn(qrow1 < N ? lse[row_base + qrow1] : kDeadLse, lse_factor);
  float d0, d1;
  if constexpr (kFold) {
    d0 = qrow0 < N ? delta[row_base + qrow0] : 0.f;
    d1 = qrow1 < N ? delta[row_base + qrow1] : 0.f;
  } else {
    rows_delta<D>(sDelta, delta + row_base, out + b * os.b + h * os.h, os, g_b, gs, mask_b, q0, N, tid);
    __syncthreads();
    d0 = sDelta[qrow0 - q0];
    d1 = sDelta[qrow1 - q0];
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (first + it) * kTile;
    float s[32], dp[32];
    uint64_t keys = 0;
    if constexpr (D <= 128) {
      __syncthreads();  // every warp is done with the last tile's pieces
      split_rows<D, kThreads>(sK, k_b, ks.n, k0, N, nullptr, tid);
      split_rows<D, kThreads>(sV, v_b, vs.n, k0, N, nullptr, tid);
      key_bits(sKeyBits, k0, lead, valid, mask_b, tid);
      if (it + 1 < n_tiles) {
        prefetch_rows_l2<D, kThreads>(k_b, ks.n, k0 + kTile, N, tid);
        prefetch_rows_l2<D, kThreads>(v_b, vs.n, k0 + kTile, N, tid);
      }
      fence_proxy_async();
      __syncthreads();
      keys = (uint64_t)sKeyBits[1] << 32 | sKeyBits[0];
      wgmma_fence();
      ss_split<D>(s, sQ, sK);
      ss_split<D>(dp, sG, sV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
    } else {  // S = Q K^T and dP = dO V^T, a slab of channels at a time
#pragma unroll
      for (int cs = 0; cs < kSlabs; ++cs) {
        __syncthreads();  // every warp's products have read the slabs
        split_rows<64, kThreads>(sK, k_b + cs * 64, ks.n, k0, N, nullptr, tid);
        if constexpr (S::kBufs == 2) split_rows<64, kThreads>(sV, v_b + cs * 64, vs.n, k0, N, nullptr, tid);
        if (cs == 0) {
          key_bits(sKeyBits, k0, lead, valid, mask_b, tid);
          if (it + 1 < n_tiles) {
            prefetch_rows_l2<D, kThreads>(k_b, ks.n, k0 + kTile, N, tid);
            prefetch_rows_l2<D, kThreads>(v_b, vs.n, k0 + kTile, N, tid);
          }
        }
        fence_proxy_async();
        __syncthreads();
        if (cs == 0) keys = (uint64_t)sKeyBits[1] << 32 | sKeyBits[0];
        ss_slab<D>(s, sQ, cs, sK, cs == 0);
        if constexpr (S::kBufs == 1) {
          __syncthreads();
          split_rows<64, kThreads>(sV, v_b + cs * 64, vs.n, k0, N, nullptr, tid);
          fence_proxy_async();
          __syncthreads();
        }
        ss_slab<D>(dp, sG, cs, sV, cs == 0);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = live_at(keys, nt, e, qrow0 - k0, qrow1 - k0, sw)
                            ? ex2_ftz(fmaf(s[4 * nt + e], c, e < 2 ? nl0 : nl1)) : 0.f;
        s[4 * nt + e] = p * (dp[4 * nt + e] - (e < 2 ? d0 : d1));  // ds
      }
    uint32_t dsa[3][kTile / 16][4];
    split_p(s, dsa);
    if constexpr (D <= 128) {
      rs_split_add<D, D>(acc, dsa, sK);
    } else {  // dQ += dS K, a slab of dQ's columns at a time, the last first: with two buffers K's is still there
#pragma unroll
      for (int cs = kSlabs - 1; cs >= 0; --cs) {
        if (S::kBufs == 1 || cs < kSlabs - 1) {
          __syncthreads();
          split_rows<64, kThreads>(sK, k_b + cs * 64, ks.n, k0, N, nullptr, tid);
          fence_proxy_async();
          __syncthreads();
        }
        accumulate_pv_slab<D>(acc, cs, dsa, sK);
      }
    }
  }

  if constexpr (kFold) {
    __syncthreads();  // every warp is done with the tiles the epilogue overwrites
    float* stage = reinterpret_cast<float*>(smem);
    stage_rows<D>(stage, acc, scale);
    __syncthreads();
    fold_rows<D, kThreads>(stage, stage + S::kStage / 4, fold, b, h, H, N, q0, blockIdx.x, tid);
  } else {
    store_rows_f32<D>(dq, dqs, b, h, qrow0, N, acc, scale);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kP = kTile * D * 2;
  static constexpr int kK = 0, kV = 3 * kP, kQ = 6 * kP, kG = 9 * kP;
  static constexpr int kPT = 12 * kP;                    // warpgroup 0's p^T, 32 floats a thread
  static constexpr int kLse = kPT + 32 * kThreads * 4;   // the query tile's lse
  static constexpr int kDelta = kLse + kTile * 4;        // and delta
  static constexpr int kEnd = kDelta + kTile * 4;
  static constexpr int kBytes = kEnd + 1024;
  static constexpr int kStage = kTile * (D + 4) * 4;
  static_assert(kStage + 2 * kThreads / (D / 16) * D * 4 <= kEnd, "the fold's epilogue fits over the tiles");
};

// At d 192 and 256: K's and V's pieces whole, one 64-column slab each of
// Q's and dO's (one buffer for both where two do not fit), no p^T.
template <int D>
struct DkvWideSmem : WideSmem<D> {
  using W = WideSmem<D>;
  static constexpr int kK = 0, kV = 3 * W::kP, kQ = W::kBuf, kG = W::kSlabB;
};

template <int D>
using DkvLayout = std::conditional_t<(D > 128), DkvWideSmem<D>, DkvSmem<D>>;

// One block of 64 key rows, two warpgroups (see the top of the file; at d
// 192 and 256 on DkvWideSmem, both forming p^T). Without kFold: writes dk
// and dv; with kFold dv to dqkv's v plane (`dv`, `dvs`) and dk through the
// fold.
template <int D, bool kFold>
__device__ __forceinline__ void dkv_body(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, const float* __restrict__ dout, Strides qs,
                                         Strides ks, Strides vs, Strides gs, const float* __restrict__ lse,
                                         const float* __restrict__ delta, const unsigned char* __restrict__ mask,
                                         const int* __restrict__ counts, float* __restrict__ dk, Strides dks,
                                         float* __restrict__ dv, Strides dvs, const Fold& fold, int B, int N, int H,
                                         int sw, float c, float lse_factor, float scale) {
  using S = DkvLayout<D>;
  constexpr int kSlabs = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sG = smem + S::kG;
  float* sLse = reinterpret_cast<float*>(smem + S::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + S::kDelta);

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int wtid = tid % kThreads;
  const int t = tid & 3;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q_b = q + b * qs.b + h * qs.h;
  const float* k_b = k + b * ks.b + h * ks.h;
  const float* v_b = v + b * vs.b + h * vs.h;
  const float* g_b = dout + b * gs.b + h * gs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const long long row_base = ((long long)b * H + h) * N;
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  int first;
  const int n_tiles = live_tiles(k0, min(min(k0 + kTile, N), valid), valid, sw, &first);
  if (n_tiles > 0) {
    split_rows<D, 2 * kThreads>(sK, k_b, ks.n, k0, N, nullptr, tid);
    split_rows<D, 2 * kThreads>(sV, v_b, vs.n, k0, N, nullptr, tid);
  }
  const int kr0 = k0 + (wtid >> 5) * 16 + ((wtid & 31) >> 2), kr1 = kr0 + 8;  // this thread's key rows
  const bool kok0 = kr0 < valid && (kr0 < lead || mask_b[kr0]);
  const bool kok1 = kr1 < valid && (kr1 < lead || mask_b[kr1]);
  // The query tile's lse and delta into shared memory (threads 0-127).
  auto load_rows = [&](int qt0) {
    if (tid < kTile) {
      const int n = qt0 + tid;
      sLse[tid] = n < N ? lse[row_base + n] : kDeadLse;
    } else if (tid < 2 * kTile) {
      const int n = qt0 + tid - kTile;
      sDelta[tid - kTile] = n < N ? delta[row_base + n] : 0.f;
    }
  };
  // p^T of this thread's element e of column group nt from its S^T entry
  // st: dead keys, the window and padded queries 0.
  auto p_of = [&](float st, int qt0, int nt, int e) {
    const int col = nt * 8 + 2 * t + (e & 1);  // the query inside the tile
    const int krow = e < 2 ? kr0 : kr1;
    const bool live = (e < 2 ? kok0 : kok1) && (sw < 0 || abs(qt0 + col - krow) <= sw);
    return live ? ex2_ftz(fmaf(st, c, -__fmul_rn(sLse[col], lse_factor))) : 0.f;
  };

  float acc[D / 2];  // warpgroup 0: dv; warpgroup 1: dk
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int qt0 = (first + it) * kTile;
    uint32_t xa[3][kTile / 16][4];
    if constexpr (D <= 128) {
      float* sPT = reinterpret_cast<float*>(smem + S::kPT);
      __syncthreads();  // both warpgroups are done with the last tile's pieces and p^T
      split_rows<D, 2 * kThreads>(sQ, q_b, qs.n, qt0, N, nullptr, tid);
      split_rows<D, 2 * kThreads>(sG, g_b, gs.n, qt0, N, mask_b, tid);  // padded rows zeroed
      load_rows(qt0);
      if (it + 1 < n_tiles) {
        prefetch_rows_l2<D, 2 * kThreads>(q_b, qs.n, qt0 + kTile, N, tid);
        prefetch_rows_l2<D, 2 * kThreads>(g_b, gs.n, qt0 + kTile, N, tid);
      }
      fence_proxy_async();
      __syncthreads();
      if (wg == 0) {  // S^T = K Q^T, p^T; dV += P^T dO
        float s[32];
        wgmma_fence();
        ss_split<D>(s, sK, sQ);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = p_of(s[4 * nt + e], qt0, nt, e);
            s[4 * nt + e] = p;
            sPT[(4 * nt + e) * kThreads + wtid] = p;
          }
        bar_arrive(kBarP, 2 * kThreads);
        split_p(s, xa);
        rs_split_add<D, 64>(acc, xa, sG);  // 64 columns a pass: a whole-width one spills at d = 128
      } else {  // dP^T = V dO^T, ds^T = p^T (dp^T - delta); dK += dS^T Q
        float dp[32];
        wgmma_fence();
        ss_split<D>(dp, sV, sG);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dp);
        bar_sync(kBarP, 2 * kThreads);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * t + (e & 1);
            dp[4 * nt + e] = sPT[(4 * nt + e) * kThreads + wtid] * (dp[4 * nt + e] - sDelta[col]);
          }
        split_p(dp, xa);
        rs_split_add<D, 64>(acc, xa, sQ);
      }
    } else {
      float s[32], dp[32];
#pragma unroll
      for (int cs = 0; cs < kSlabs; ++cs) {  // S^T = K Q^T (both) and dP^T = V dO^T (warpgroup 1), a slab at a time
        __syncthreads();  // every warp's products have read the slabs, and the rows' lse and delta
        split_rows<64, 2 * kThreads>(sQ, q_b + cs * 64, qs.n, qt0, N, nullptr, tid);
        if constexpr (S::kBufs == 2) split_rows<64, 2 * kThreads>(sG, g_b + cs * 64, gs.n, qt0, N, mask_b, tid);
        if (cs == 0) {
          load_rows(qt0);
          if (it + 1 < n_tiles) {
            prefetch_rows_l2<D, 2 * kThreads>(q_b, qs.n, qt0 + kTile, N, tid);
            prefetch_rows_l2<D, 2 * kThreads>(g_b, gs.n, qt0 + kTile, N, tid);
          }
        }
        fence_proxy_async();
        __syncthreads();
        ss_slab<D>(s, sK, cs, sQ, cs == 0);
        if constexpr (S::kBufs == 1) {
          __syncthreads();
          split_rows<64, 2 * kThreads>(sG, g_b + cs * 64, gs.n, qt0, N, mask_b, tid);  // padded rows zeroed
          fence_proxy_async();
          __syncthreads();
        }
        if (wg == 1) ss_slab<D>(dp, sV, cs, sG, cs == 0);
      }
      // p^T in both warpgroups; warpgroup 1 turns it into ds^T = p^T (dp^T - delta)
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = p_of(s[4 * nt + e], qt0, nt, e);
          s[4 * nt + e] = wg == 0 ? p : p * (dp[4 * nt + e] - sDelta[nt * 8 + 2 * t + (e & 1)]);
        }
      split_p(s, xa);
      // dV += P^T dO (warpgroup 0) and dK += dS^T Q (warpgroup 1), a slab of
      // columns at a time, the last first: its dO slab (and with two buffers
      // its Q slab) is still in a buffer.
#pragma unroll
      for (int cs = kSlabs - 1; cs >= 0; --cs) {
        if (cs < kSlabs - 1) {
          __syncthreads();
          split_rows<64, 2 * kThreads>(sG, g_b + cs * 64, gs.n, qt0, N, mask_b, tid);
          if constexpr (S::kBufs == 2) split_rows<64, 2 * kThreads>(sQ, q_b + cs * 64, qs.n, qt0, N, nullptr, tid);
          fence_proxy_async();
          __syncthreads();
        }
        if constexpr (S::kBufs == 2) {
          accumulate_pv_slab<D>(acc, cs, xa, wg == 0 ? sG : sQ);
        } else {
          if (wg == 0) accumulate_pv_slab<D>(acc, cs, xa, sG);
          __syncthreads();
          split_rows<64, 2 * kThreads>(sQ, q_b + cs * 64, qs.n, qt0, N, nullptr, tid);
          fence_proxy_async();
          __syncthreads();
          if (wg == 1) accumulate_pv_slab<D>(acc, cs, xa, sQ);
        }
      }
    }
  }

  if (wg == 0) store_rows_f32<D>(dv, dvs, b, h, kr0, N, acc, 1.f);
  if constexpr (kFold) {
    __syncthreads();  // both warpgroups are done with the tiles the epilogue overwrites
    float* stage = reinterpret_cast<float*>(smem);
    if (wg == 1) stage_rows<D>(stage, acc, scale);
    __syncthreads();
    fold_rows<D, 2 * kThreads>(stage, stage + S::kStage / 4, fold, b, h, H, N, k0, blockIdx.x, tid);
  } else {
    if (wg == 1) store_rows_f32<D>(dk, dks, b, h, kr0, N, acc, scale);
  }
}

// The kernels. lse_factor: the stored lse times it is the exponent's (log2e
// for #4's natural-log lse; 1 for the fp32 walker's log2 lse, which the
// fused backward, #3, hands the fold instances).
template <int D, bool kFold>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_dq_f32_kernel(const float* q, const float* k, const float* v, const float* dout, Strides qs, Strides ks,
                        Strides vs, Strides gs, const float* lse, float* delta, const unsigned char* mask,
                        const int* counts, const float* out, Strides os, float* dq, Strides dqs, Fold fold, int B,
                        int N, int H, int sw, float c, float lse_factor, float scale) {
  dq_body<D, kFold>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, out, os, dq, dqs, fold, B, N, H, sw, c,
                    lse_factor, scale);
}

template <int D, bool kFold>
__global__ void __launch_bounds__(2 * kThreads, 1)
flash_bwd_dkv_f32_kernel(const float* q, const float* k, const float* v, const float* dout, Strides qs, Strides ks,
                         Strides vs, Strides gs, const float* lse, const float* delta, const unsigned char* mask,
                         const int* counts, float* dk, Strides dks, float* dv, Strides dvs, Fold fold, int B, int N,
                         int H, int sw, float c, float lse_factor, float scale) {
  dkv_body<D, kFold>(q, k, v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, dks, dv, dvs, fold, B, N, H, sw, c,
                     lse_factor, scale);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline float scale_of(int D) { return (float)(1.0 / std::sqrt((double)D)); }
inline float exponent_of(int D) { return (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634); }

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, int threads, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

dim3 tiles_grid(int N, int H, int B) { return dim3((N + kTile - 1) / kTile, H, B); }

// The fold's operands: q and k views of the prologue's fp32 [B, N, 2C]
// scratch, v of qkv [B, N, 3C], dO [B, N, C].
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
cudaError_t launch_fwd(const float* q, const float* k, const float* v, Strides qs, Strides ks, Strides vs,
                       const unsigned char* mask, const int* counts, float* out, float* lse, int B, int N, int H,
                       int sw, cudaStream_t s) {
  return launch(flash_attention_f32_kernel<D>, FwdSmem<D>::kBytes, tiles_grid(N, H, B), kThreads, s, q, k, v, qs, ks,
                vs, mask, counts, out, lse, B, N, H, sw, exponent_of(D));
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout, const float* out,
                      Strides qs, Strides ks, Strides vs, Strides gs, Strides os, const float* lse,
                      const unsigned char* mask, const int* counts, float* delta, float* dq, int B, int N, int H,
                      int sw, cudaStream_t s) {
  const Strides dqs{(long long)N * H * D, (long long)H * D, D};
  return launch(flash_bwd_dq_f32_kernel<D, false>, DqLayout<D>::kBytes, tiles_grid(N, H, B), kThreads, s, q, k, v,
                dout, qs, ks, vs, gs, lse, delta, mask, counts, out, os, dq, dqs, Fold{}, B, N, H, sw, exponent_of(D),
                kLog2e, scale_of(D));
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout, Strides qs, Strides ks,
                       Strides vs, Strides gs, const float* lse, const float* delta, const unsigned char* mask,
                       const int* counts, float* dk, float* dv, int B, int N, int H, int sw, cudaStream_t s) {
  const Strides os{(long long)N * H * D, (long long)H * D, D};
  return launch(flash_bwd_dkv_f32_kernel<D, false>, DkvLayout<D>::kBytes, tiles_grid(N, H, B), 2 * kThreads, s, q, k,
                v, dout, qs, ks, vs, gs, lse, delta, mask, counts, dk, os, dv, os, Fold{}, B, N, H, sw,
                exponent_of(D), kLog2e, scale_of(D));
}

// The fold instances: which = 0 dq (q plane of dqkv, part = the q gain's
// partials), 1 dk/dv (k and v planes, the k gain's).
template <int D>
cudaError_t launch_fold(int which, float lse_factor, const float* qkv, const float* qk, const float* gain,
                        const float* cos_t, const float* sin_t, const unsigned char* mask, const int* counts,
                        const float* dout, const float* lse, const float* delta, float* dqkv, float* part, int B,
                        int N, int H, int sw, cudaStream_t s) {
  const long long C = (long long)H * D;
  const FoldViews w(N, H, D);
  const float* qn = qk;
  const float* kn = qk + C;
  const float* vv = qkv + 2 * C;
  const dim3 grid = tiles_grid(N, H, B);
  const float c = exponent_of(D), sc = scale_of(D);
  if (which == 0) {
    const Fold f{qkv, gain, cos_t, sin_t, dqkv, part, 3 * C};
    return launch(flash_bwd_dq_f32_kernel<D, true>, DqLayout<D>::kBytes, grid, kThreads, s, qn, kn, vv, dout, w.qs,
                  w.ks, w.vs, w.gs, lse, const_cast<float*>(delta), mask, counts, static_cast<const float*>(nullptr),
                  Strides{}, static_cast<float*>(nullptr), Strides{}, f, B, N, H, sw, c, lse_factor, sc);
  }
  const Fold f{qkv + C, gain, cos_t, sin_t, dqkv + C, part, 3 * C};
  return launch(flash_bwd_dkv_f32_kernel<D, true>, DkvLayout<D>::kBytes, grid, 2 * kThreads, s, qn, kn, vv, dout, w.qs,
                w.ks, w.vs, w.gs, lse, delta, mask, counts, static_cast<float*>(nullptr), Strides{}, dqkv + 2 * C,
                w.dqkv, f, B, N, H, sw, c, lse_factor, sc);
}

template <typename Kernel>
cudaError_t attributes(Kernel kernel, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = smem + (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

template <int D>
cudaError_t kernel_attributes(int which, int* out) {
  switch (which) {
    case 0: return attributes(flash_attention_f32_kernel<D>, kThreads, FwdSmem<D>::kBytes, out);
    case 1: return attributes(flash_bwd_dq_f32_kernel<D, false>, kThreads, DqLayout<D>::kBytes, out);
    case 2: return attributes(flash_bwd_dkv_f32_kernel<D, false>, 2 * kThreads, DkvLayout<D>::kBytes, out);
    case 3: return attributes(flash_bwd_dq_f32_kernel<D, true>, kThreads, DqLayout<D>::kBytes, out);
    case 4: return attributes(flash_bwd_dkv_f32_kernel<D, true>, 2 * kThreads, DkvLayout<D>::kBytes, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v [B, N, H, D] f32 with unit channel stride and the given sample,
// token and head strides (elements, multiples of 4; 16-byte aligned bases);
// mask [B, N] bool bytes or null; counts [2, B] int32 (one past the last
// valid key, then the number of leading valid keys) or null when mask is;
// out [B, N, H, D] f32 contiguous; lse [B, H, N] f32 (natural log, 1e30 on
// rows with no live key) or null. sw < 0: no window. D is 64, 128, 192 or
// 256, here and in the backward's entries below. Each entry returns the
// cudaError_t of its launch (0 = success).
int vitok_flash_attention_f32(const void* q, const void* k, const void* v, long long q_sb, long long q_sn,
                              long long q_sh, long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                              long long v_sn, long long v_sh, const void* mask, const void* counts, void* out,
                              void* lse, int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* n = static_cast<const int*>(counts);
  auto* o = static_cast<float*>(out);
  auto* l = static_cast<float*>(lse);
  if (D == 64) return launch_fwd<64>(qp, kp, vp, qs, ks, vs, m, n, o, l, B, N, H, sw, s);
  if (D == 128) return launch_fwd<128>(qp, kp, vp, qs, ks, vs, m, n, o, l, B, N, H, sw, s);
  if (D == 192) return launch_fwd<192>(qp, kp, vp, qs, ks, vs, m, n, o, l, B, N, H, sw, s);
  if (D == 256) return launch_fwd<256>(qp, kp, vp, qs, ks, vs, m, n, o, l, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's plain instances: q, k, v, dout (the output's cotangent) and
// out (the forward's output) [B, N, H, D] f32 as above; lse from the
// forward. The dq entry writes delta [B, H, N] f32 (sum_d dout * out, 0 on
// padded query rows) and dq [B, N, H, D] f32 contiguous; the dk/dv entry
// reads that delta and writes dk and dv [B, N, H, D] f32 contiguous.
int vitok_flash_bwd_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* out,
                           long long q_sb, long long q_sn, long long q_sh, long long k_sb, long long k_sn,
                           long long k_sh, long long v_sb, long long v_sn, long long v_sh, long long g_sb,
                           long long g_sn, long long g_sh, long long o_sb, long long o_sn, long long o_sh,
                           const void* lse, const void* mask, const void* counts, void* delta, void* dq, int B,
                           int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const Strides gs{g_sb, g_sn, g_sh}, os{o_sb, o_sn, o_sh};
#define VITOK_ARGS                                                                                               \
  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),                     \
      static_cast<const float*>(dout), static_cast<const float*>(out), qs, ks, vs, gs, os,                        \
      static_cast<const float*>(lse), static_cast<const unsigned char*>(mask), static_cast<const int*>(counts), \
      static_cast<float*>(delta), static_cast<float*>(dq), B, N, H, sw, s
  if (D == 64) return launch_dq<64>(VITOK_ARGS);
  if (D == 128) return launch_dq<128>(VITOK_ARGS);
  if (D == 192) return launch_dq<192>(VITOK_ARGS);
  if (D == 256) return launch_dq<256>(VITOK_ARGS);
#undef VITOK_ARGS
  return (int)cudaErrorInvalidValue;
}

int vitok_flash_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* dout, long long q_sb,
                            long long q_sn, long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                            long long v_sb, long long v_sn, long long v_sh, long long g_sb, long long g_sn,
                            long long g_sh, const void* lse, const void* delta, const void* mask, const void* counts,
                            void* dk, void* dv, int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const Strides gs{g_sb, g_sn, g_sh};
#define VITOK_ARGS                                                                                               \
  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),                     \
      static_cast<const float*>(dout), qs, ks, vs, gs, static_cast<const float*>(lse),                          \
      static_cast<const float*>(delta), static_cast<const unsigned char*>(mask), static_cast<const int*>(counts), \
      static_cast<float*>(dk), static_cast<float*>(dv), B, N, H, sw, s
  if (D == 64) return launch_dkv<64>(VITOK_ARGS);
  if (D == 128) return launch_dkv<128>(VITOK_ARGS);
  if (D == 192) return launch_dkv<192>(VITOK_ARGS);
  if (D == 256) return launch_dkv<256>(VITOK_ARGS);
#undef VITOK_ARGS
  return (int)cudaErrorInvalidValue;
}

// The fold instances (q/k RMSNorm + RoPE under the attention): which = 0 the
// dq kernel (dqkv's q plane, part = the q gain's partials), 1 the dk/dv
// kernel (its k and v planes, the k gain's); lse_factor: the stored lse
// times it is the exponent in log2 units (log2(e) for #4's natural-log lse,
// 1 for the fp32 walker's log2 lse that the fused backward, #3, hands over).
// qkv [B, N, 3*H*D] f32; qk [B, N, 2*H*D] f32 and delta [B, H, N] f32 from
// the fp32 q/k prologue with out and dout; gain [D] f32 (q's or k's); cos,
// sin [B, N, D/2] f32; mask and counts as above; dout [B, N, H*D] f32
// contiguous, zero on padded rows; lse [B, H, N] f32. part [B, H,
// ceil(N / 64), D] f32 (the caller sums it over the first three axes).
int vitok_flash_bwd_fold_f32(int which, float lse_factor, const void* qkv, const void* qk, const void* gain,
                             const void* cos_t, const void* sin_t, const void* mask, const void* counts,
                             const void* dout, const void* lse, const void* delta, void* dqkv, void* part, int B,
                             int N, int H, int D, int sw, void* stream) {
  if (which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VITOK_ARGS                                                                                            \
  which, lse_factor, static_cast<const float*>(qkv), static_cast<const float*>(qk),                          \
      static_cast<const float*>(gain), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),   \
      static_cast<const unsigned char*>(mask), static_cast<const int*>(counts), static_cast<const float*>(dout), \
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dqkv),          \
      static_cast<float*>(part), B, N, H, sw, s
  if (D == 64) return launch_fold<64>(VITOK_ARGS);
  if (D == 128) return launch_fold<128>(VITOK_ARGS);
  if (D == 192) return launch_fold<192>(VITOK_ARGS);
  if (D == 256) return launch_fold<256>(VITOK_ARGS);
#undef VITOK_ARGS
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory (spills) a thread, blocks an SM and shared
// memory a block of one kernel (which: 0 the forward, 1 dq, 2 dk/dv, 3 dq's
// and 4 dk/dv's fold instances) at head dim D, as the compiler and the card
// report them: out[0..3].
int vitok_flash_f32_attributes(int which, int D, int* out) {
  if (D == 64) return kernel_attributes<64>(which, out);
  if (D == 128) return kernel_attributes<128>(which, out);
  if (D == 192) return kernel_attributes<192>(which, out);
  if (D == 256) return kernel_attributes<256>(which, out);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
