// Flash attention forward over NaFlex token sequences: key-side patch mask,
// optional sliding window |i - j| <= sw, padded query rows zeroed, and the
// per-row log-sum-exp for the backward.
//
// Replaces the TPU kernel vitok_tpu/ops/flash_attention.py::_attn_kernel
// (launcher _flash_fwd, public flash_attention). Same function and the same
// rounding points:
//   * q prescaled in bf16: bf16(float(q) * (1/sqrt(d))); the fp32 logits
//     (bf16 x bf16 products, fp32 accumulation) are scaled by log2(e) in
//     fp32 so the softmax runs on exp2 (here p = exp2(fma(s, log2(e),
//     -max)): one rounding where a multiply and a subtraction make two);
//   * masked keys, keys outside the window and keys past N contribute
//     exactly 0, so a row with no live key (a padded row beyond the window's
//     reach, an all-padding sample) gives 0, never NaN;
//   * the row sum l is taken over the fp32 p; p is rounded to bf16 before
//     PV, with fp32 accumulation; the output is acc / l;
//   * padded query rows are written as 0;
//   * lse = m + log(l) in natural-log units, +1e30 where l == 0.
// The TPU kernel walks 512-key blocks and folds all heads into one grid
// cell to amortise the cost of starting each DMA; here each block owns one
// (sample, head, 128-query tile) and walks 64-key tiles, so p is rounded at
// other running maxima: the same function up to the order of the rescaling.
//
// What bounds it on an H100: operations. At the model's shapes (d = 64,
// a window of 1024 or none, 4k-262k tokens) the work is 4 * H * d flops per
// live (query, key) pair: 350M at 2048p with sw = 1024 is 32.5M pairs per
// head, 133 GFLOP, 0.135 ms at 989 TFLOP/s, against 134 MB of q/k/v/out,
// 0.040 ms at 3.35 TB/s. Beside the tensor cores, each pair costs an exp2
// on the SM's special-function units (16 a clock) and a few fp32
// operations, which at d = 64 take about as long as its products: the
// elementwise work per pair is what the design keeps small, and it has to
// run while the tensor cores do.
//
// Design: the wgmma cell of fused_attend_sm90.cuh (#1's thread layout,
// descriptors, 128-byte-swizzled tiles and row epilogue) with a softmax of
// its own (flash_softmax: the semantics above, a select per element where
// a tile is not "easy", an fma and one ex2.approx.ftz per pair). A block is
// two consumer warpgroups of 64 query rows: S = Q K^T is wgmma m64n64k16
// with the prescaled Q and K from shared memory (K-major), O += P V wgmma
// m64nDk16 with P from registers and V read MN-major. Both warpgroups read
// one three-stage K/V ring filled by cp.async from all 256 threads: tiles
// j + 1 and j + 2 are in flight while tile j's products run, each K/V tile
// is read from L2 once per 128 query rows, not per 64, and while one
// warpgroup waits for its products the warp schedulers run the other's
// softmax (two warpgroups measured faster than one on an H100, PERF.md).
// The block walks the union of its warpgroups' live key ranges,
// [max(0, q0 - sw), min(valid, q_last + sw + 1)), with the per-sample
// counts the wrapper computes for each call (the counterpart of the TPU
// kernel's scalar-prefetched counts); a warpgroup
// skips the products of a tile that holds no key of its own range; an
// "easy" tile (every key valid, every pair inside the window) fills
// nothing, and any other tile fills from a 64-bit mask of its live keys
// (built by ballot as its copies start) and each row's window. Inputs are
// read through per-tensor strides, so q, k and v may be views (of the q/k
// prologue's scratch, of the flat [B, N, 3C] QKV output) with no copy.
// Shared memory: two Q tiles and three K/V stages, 65 KB at d = 64 (two
// blocks an SM, at most 128 registers a thread), 129 KB at d = 128, 193 KB
// at d = 192; at d = 256 three stages do not fit beside two Q tiles (257
// KB), so the ring has two (193 KB): tile j + 1 is in flight while tile j's
// products run. The other way out, one warpgroup of 64 query rows a block
// on a three-stage ring (225 KB), would read each K/V tile from L2 once per
// 64 query rows instead of 128 and lose the second warpgroup's softmax
// beside the first's products, which measured faster at d = 64 and 128.
// O += P V at d 192/256 is two wgmma products on V's column blocks
// (sm90.cuh's wgmma_rs); o is D / 2 fp32 registers a thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend_sm90.cuh"

namespace {

constexpr int kGroups = 2;                         // consumer warpgroups a block
constexpr int kBlockRows = kGroups * kTile;        // query rows a block
constexpr int kBlockThreads = kGroups * kThreads;  // 256
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kDeadLse = 1e30f;

template <int D>
struct FlashSmem {
  // K/V tiles in flight ahead of the one computed: two, but one at d = 256,
  // where two Q tiles and a three-stage ring (64 + 192 KB) pass the 227 KB a
  // block may have; two Q tiles and two stages take 192 KB.
  static constexpr int kAhead = D == 256 ? 1 : 2;
  static constexpr int kRing = kAhead + 1;                   // and the one computed
  static constexpr int kTileBytes = kTile * D * 2;           // one sw128 tile
  static constexpr int kQ = 0;                               // kGroups Q tiles
  static constexpr int kK = kQ + kGroups * kTileBytes;       // kRing K tiles
  static constexpr int kV = kK + kRing * kTileBytes;         // kRing V tiles
  static constexpr int kBytes = kV + kRing * kTileBytes + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block's shared memory on sm_90");
};

struct Strides {  // elements between samples, tokens and heads
  long long b, n, h;
};

// exp2 on the special-function unit alone (ex2.approx.ftz: one
// instruction; results below 2^-126 flushed to 0, exp2(-inf) = 0).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax update of one key tile for this thread's rows
// (fused_attend_sm90.cuh's layout: element e of column group nt is key
// 8 nt + 2 t + (e & 1) of row qrow0 + 8 (e >= 2)), given its raw logits s
// (the C fragment of S = Q K^T with the prescaled Q, fp32): a key that is
// not live (live(nt, e) false: masked, past N or outside the window) is
// -inf and adds exactly 0; the running max is taken over the raw logits and
// scaled by log2(e) once (rounding is monotonic); p = exp2(s log2(e) - max)
// is one fma and one ex2_ftz; a row that has seen no live key keeps m =
// -inf and subtracts 0 instead (p and the rescale factor stay exactly 0, no
// inf - inf), so its l stays 0. Leaves p, unrounded, in s; o and l are
// rescaled.
template <int D, typename Live>
__device__ __forceinline__ void flash_softmax(CellRows<D>& r, float (&s)[32], Live live) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * nt + e] = live(nt, e) ? s[4 * nt + e] : -INFINITY;
    mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, __fmul_rn(mx0, kLog2e)), mn1 = fmaxf(r.m1, __fmul_rn(mx1, kLog2e));
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
  const float a0 = ex2_ftz(r.m0 - mu0), a1 = ex2_ftz(r.m1 - mu1);
  r.m0 = mn0;
  r.m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    s[4 * nt] = ex2_ftz(fmaf(s[4 * nt], kLog2e, -mu0));
    s[4 * nt + 1] = ex2_ftz(fmaf(s[4 * nt + 1], kLog2e, -mu0));
    s[4 * nt + 2] = ex2_ftz(fmaf(s[4 * nt + 2], kLog2e, -mu1));
    s[4 * nt + 3] = ex2_ftz(fmaf(s[4 * nt + 3], kLog2e, -mu1));
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

// One key tile's products and softmax for this warpgroup's rows, as
// attend_kv_tile (fused_attend_sm90.cuh) runs them: S = Q K^T (wgmma, Q and
// K from shared memory), flash_softmax, P rounded to bf16 as the A
// fragments of O += P V (V from shared memory, MN-major).
template <int D, typename Live>
__device__ __forceinline__ void flash_tile(CellRows<D>& r, const unsigned char* sQ, const unsigned char* kt,
                                           const unsigned char* vt, Live live) {
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc<kTile>(sQ, kk), kmajor_desc<kTile>(kt, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  flash_softmax<D>(r, s, live);
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

// The live keys of one query row in a 64-key tile, shifted right by 2 t so
// that bit 8 nt + (e & 1) is this thread's element e of column group nt
// (flash_softmax's layout): `keys` (bit c: key c of the tile is valid) within
// the window |row - c| <= sw (row: the query's index less the tile's first
// key; sw < 0: no window).
__device__ __forceinline__ uint64_t live_columns(uint64_t keys, int row, int sw) {
  if (sw >= 0) {
    const int lo = row - sw, hi = row + sw;  // the window's columns
    if (hi < 0 || lo >= kTile) return 0;
    if (lo > 0) keys &= ~0ull << lo;
    if (hi < kTile - 1) keys &= ~0ull >> (kTile - 1 - hi);
  }
  return keys >> (2 * (threadIdx.x & 3));
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads, D == 64 ? 2 : 1)  // d = 64: 4 warpgroups an SM
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       Strides qs, Strides ks, Strides vs,
                       const unsigned char* __restrict__ mask,  // [B, N] or null
                       const int* __restrict__ counts,          // [2, B] (valid, lead) or null
                       __nv_bfloat16* __restrict__ out,         // [B, N, H, D]
                       float* __restrict__ lse,                 // [B, H, N] or null
                       int B, int N, int H,
                       int sw,  // < 0: no window
                       float q_scale) {
  using S = FlashSmem<D>;
  constexpr int kAhead = S::kAhead, kRing = S::kRing;
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  // Each slot's live keys: bit c of word c / 32 set when key k0 + c is
  // valid (and so below N).
  __shared__ uint32_t sKeyBits[kRing][2];

  const int tid = threadIdx.x;
  const int wg = tid / kThreads;
  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;

  // Keys [0, lead) are all valid, none at or past `valid` is (exact for any
  // mask; for the NaFlex tail-suffix layout the two are equal).
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;

  // The block's live key tiles: the union of its warpgroups' ranges. Tiles
  // outside it are never loaded.
  int lo = 0, hi = valid;
  if (sw >= 0) {
    lo = max(0, q0 - sw);
    hi = min(valid, min(q0 + kBlockRows, N) - 1 + sw + 1);
  }
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  // This warpgroup's rows [wq0, wq_last] and its own live key range
  // [wlo, whi) (empty when its rows all lie past N).
  const int wq0 = q0 + wg * kTile;
  const int wq_last = min(wq0 + kTile, N) - 1;
  int wlo = 0, whi = wq0 < N ? valid : 0;
  if (sw >= 0 && wq0 < N) {
    wlo = max(0, wq0 - sw);
    whi = min(valid, wq_last + sw + 1);
  }

  // Starts the copies of the walk's i-th key tile into its slot (rows past
  // N zero-filled) and records which of its keys are live; the mask is read
  // only between `lead` and `valid` (never for a tail-suffix mask).
  auto issue = [&](int i) {
    const int slot = i % kRing;
    const int k0 = (lo_tile + i) * kTile;
    load_tile_sw128<kTile, D, kBlockThreads>(sK + slot * S::kTileBytes, k_b, ks.n, k0, N, nullptr, tid);
    load_tile_sw128<kTile, D, kBlockThreads>(sV + slot * S::kTileBytes, v_b, vs.n, k0, N, nullptr, tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      const unsigned bits = __ballot_sync(kFull, j < lead || (j < valid && mask_b[j]));
      if ((tid & 31) == 0) sKeyBits[slot][tid >> 5] = bits;
    }
  };
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();
  }

  // Both Q tiles, prescaled in bf16 as the TPU kernel does; rows past N are
  // zeros. The ring's proxy fence orders these writes before wgmma.
#pragma unroll
  for (int u = 0; u < kBlockRows * kChunks / kBlockThreads; ++u) {
    const int i = tid + u * kBlockThreads;
    const int row = i / kChunks;
    const int ch = (i % kChunks) * 8;
    const int n = q0 + row;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (n < N) x = *reinterpret_cast<const uint4*>(q_b + n * qs.n + ch);
    __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(x2[e]);
      x2[e] = __floats2bfloat162_rn(__fmul_rn(f.x, q_scale), __fmul_rn(f.y, q_scale));
    }
    *reinterpret_cast<uint4*>(sQ + (row / kTile) * S::kTileBytes + sw128_offset<kTile>(row % kTile, ch)) = x;
  }

  const int qrow0 = cell_row0(q0);  // this thread's two query rows: qrow0 and qrow0 + 8
  const unsigned char* sQw = sQ + wg * S::kTileBytes;
  CellRows<D> r;
  r.reset();
  // One barrier a tile: after it every thread's copies of tile `it` have
  // landed and both warpgroups are done with tile it - 1, whose slot the
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
    const unsigned char* kt = sK + slot * S::kTileBytes;
    const unsigned char* vt = sV + slot * S::kTileBytes;
    if (k0 + kTile <= lead && (sw < 0 || (k0 + kTile - 1 - wq0 <= sw && wq_last - k0 <= sw))) {
      // An easy tile: every key valid, every pair inside the window.
      flash_tile<D>(r, sQw, kt, vt, [](int, int) { return true; });
    } else {
      const uint64_t keys = (uint64_t)sKeyBits[slot][1] << 32 | sKeyBits[slot][0];
      const uint64_t live0 = live_columns(keys, qrow0 - k0, sw), live1 = live_columns(keys, qrow0 + 8 - k0, sw);
      flash_tile<D>(r, sQw, kt, vt,
                    [&](int nt, int e) { return (((e < 2 ? live0 : live1) >> (nt * 8 + (e & 1))) & 1) != 0; });
    }
  }
  cp_async_wait<0>();

  sum_rows<D>(r);
  const int t = tid & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qrow = qrow0 + 8 * rr;
    if (qrow >= N) continue;
    const float l = rr ? r.l1 : r.l0;
    const float m = rr ? r.m1 : r.m0;
    // Padded query rows and rows with no live key are written as 0.
    const bool keep = l > 0.f && (mask_b == nullptr || mask_b[qrow]);
    __nv_bfloat16* dst = out + (((long long)b * N + qrow) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x0 = keep ? __fdiv_rn(r.o[4 * dt + 2 * rr], l) : 0.f;
      const float x1 = keep ? __fdiv_rn(r.o[4 * dt + 2 * rr + 1], l) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) = __floats2bfloat162_rn(x0, x1);
    }
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * N + qrow] = l > 0.f ? __fmul_rn(m, kLn2) + logf(l) : kDeadLse;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, Strides qs, Strides ks,
                   Strides vs, const void* mask, const void* counts, void* out, void* lse,
                   int B, int N, int H, int sw, cudaStream_t stream) {
  const int smem = FlashSmem<D>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float q_scale = (float)(1.0 / std::sqrt((double)D));
  dim3 grid((N + kBlockRows - 1) / kBlockRows, H, B);
  flash_attention_kernel<D><<<grid, kBlockThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qs, ks, vs,
      static_cast<const unsigned char*>(mask), static_cast<const int*>(counts),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, N, H, sw, q_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v [B, N, H, D] bf16 with unit channel stride and the given sample,
// token and head strides (elements, multiples of 8; 16-byte aligned bases);
// mask [B, N] bool bytes or null; counts [2, B] int32 (one past the last
// valid key, then the number of leading valid keys) or null when mask is;
// out [B, N, H, D] bf16 contiguous; lse [B, H, N] f32 or null. sw < 0: no
// window. D is 64, 128, 192 or 256. Returns the cudaError_t of the launch (0
// = success).
int vitok_flash_attention_bf16(const void* q, const void* k, const void* v,
                               long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh,
                               long long v_sb, long long v_sn, long long v_sh,
                               const void* mask, const void* counts, void* out, void* lse,
                               int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  if (D == 64) return launch<64>(q, k, v, qs, ks, vs, mask, counts, out, lse, B, N, H, sw, s);
  if (D == 128) return launch<128>(q, k, v, qs, ks, vs, mask, counts, out, lse, B, N, H, sw, s);
  if (D == 192) return launch<192>(q, k, v, qs, ks, vs, mask, counts, out, lse, B, N, H, sw, s);
  if (D == 256) return launch<256>(q, k, v, qs, ks, vs, mask, counts, out, lse, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// Registers and local memory (spills) a thread, blocks an SM and shared
// memory a block of the forward kernel at head dim D: out[0..3].
int vitok_flash_attention_attributes(int D, int* out) {
  const void* fn = nullptr;
  int smem = 0;
#define VITOK_PICK(DD)                                  \
  if (D == DD) {                                        \
    fn = (const void*)flash_attention_kernel<DD>;       \
    smem = FlashSmem<DD>::kBytes;                       \
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlockThreads, smem);
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
