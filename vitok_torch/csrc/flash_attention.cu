// Flash attention forward over NaFlex token sequences: key-side patch mask,
// optional sliding window |i - j| <= sw, padded query rows zeroed, and the
// per-row log-sum-exp for the backward.
//
// Replaces the TPU kernel vitok_tpu/ops/flash_attention.py::_attn_kernel
// (launcher _flash_fwd, public flash_attention). Same function and the same
// rounding points:
//   * q prescaled in bf16: bf16(float(q) * (1/sqrt(d))); the fp32 logits
//     (bf16 x bf16 products, fp32 accumulation) are then multiplied by
//     log2(e) in fp32 so the softmax runs on exp2;
//   * masked keys, keys outside the window and keys past N contribute
//     exactly 0, so a row with no live key (a padded row beyond the window's
//     reach, an all-padding sample) gives 0, never NaN;
//   * the row sum l is taken over the fp32 p; p is rounded to bf16 before
//     PV, with fp32 accumulation; the output is acc / l;
//   * padded query rows are written as 0;
//   * lse = m + log(l) in natural-log units, +1e30 where l == 0.
// The TPU kernel walks 512-key blocks and folds all heads into one grid
// cell to amortise the cost of starting each DMA; here each block owns one
// (sample, head, 64-query tile) and walks 64-key tiles, so p is rounded at
// other running maxima: the same function up to the order of the rescaling.
//
// What bounds it on an H100: operations. At the model's shapes (d = 64,
// a window of 1024 or none, 4k-262k tokens) the work is 4 * H * d flops per
// live (query, key) pair: 350M at 2048p with sw = 1024 is 32.5M pairs per
// head, 133 GFLOP, 0.135 ms at 989 TFLOP/s, against 134 MB of q/k/v/out,
// 0.040 ms at 3.35 TB/s. This version runs mma.sync m16n8k16 (about half of
// wgmma's rate) and computes whole 64-key tiles at the window's edges. What
// it does do: no [N, N] logits in device memory; K/V tiles double-buffered
// through cp.async (the next tile's copies in flight while this one is
// multiplied); every tile outside the block's live key range
// [max(0, q0 - sw), min(valid, q_last + sw + 1)) skipped, with the per-sample
// valid count computed once by the wrapper (the counterpart of the TPU
// kernel's scalar-prefetched counts and window-spanning KV grid axis);
// "easy" tiles (all keys valid and all pairs inside the window) skip the
// per-element mask. Inputs are read through per-tensor strides, so v may be
// a view into the flat [B, N, 3C] QKV output with no copy.
//
// Design: one block per (64-query tile, head, sample), four warps of 16
// query rows. Q is prescaled into shared memory once and held as mma A
// fragments; S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> fp32,
// with K's B fragments read as 32-bit words and V's by ldmatrix.trans.
// Shared memory: Q plus a two-stage K/V ring, 87 KB at d = 128 (dynamic,
// above the 48 KB default; the launch sets the attribute).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "ptx.cuh"

namespace {

constexpr int kTile = 64;      // query rows per block and keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 row padding: conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kDeadLse = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int kRow = D + kPad;  // sQ, sK, sV row stride (bf16)
  static constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kTile * kRow;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + kTileBytes;       // two K tiles
  static constexpr size_t kV = kK + 2 * kTileBytes;   // two V tiles
  static constexpr size_t kOk = kV + 2 * kTileBytes;  // two rows of 64 key-valid bytes
  static constexpr size_t kBytes = kOk + 2 * kTile;
};

struct Strides {  // elements between samples, tokens and heads
  long long b, n, h;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
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
  using S = Smem<D>;
  constexpr int kRow = S::kRow;
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  constexpr int kTileElems = kTile * kRow;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  unsigned char* sOk = smem + S::kOk;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id
  const int t = lane & 3;    // thread in group
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* q_b = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* k_b = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_b = v + b * vs.b + h * vs.h;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;

  // Live key range of this query tile: keys [0, lead) are all valid, none at
  // or past `valid` is (exact for any mask; for the NaFlex tail-suffix
  // layout the two are equal). Tiles outside [lo, hi) are never loaded.
  const int valid = counts ? counts[b] : N;
  const int lead = counts ? counts[B + b] : N;
  const int q_last = min(q0 + kTile, N) - 1;
  int lo = 0, hi = valid;
  if (sw >= 0) {
    lo = max(0, q0 - sw);
    hi = min(valid, q_last + sw + 1);
  }
  const int lo_tile = lo / kTile;
  const int n_tiles = hi > lo ? (hi + kTile - 1) / kTile - lo_tile : 0;

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kTile;
#pragma unroll
    for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int row = i / kChunks;
      const int ch = (i % kChunks) * 8;
      const int j = k0 + row;
      const bool in = j < N;  // keys past N are absent: zero rows, masked below
      const long long jj = in ? j : 0;
      cp_async16(sK + buf * kTileElems + row * kRow + ch, k_b + jj * ks.n + ch, in);
      cp_async16(sV + buf * kTileElems + row * kRow + ch, v_b + jj * vs.n + ch, in);
    }
    if (tid < kTile) {
      const int j = k0 + tid;
      sOk[buf * kTile + tid] = (j < N && (mask_b == nullptr || mask_b[j])) ? 1 : 0;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(lo_tile, 0);

  // Q tile, prescaled in bf16 as the TPU kernel does; rows past N are zeros.
#pragma unroll
  for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
    const int i = tid + u * kThreads;
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
    *reinterpret_cast<uint4*>(sQ + row * kRow + ch) = x;
  }
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

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = (lo_tile + it) * kTile;
    if (it + 1 < n_tiles) {
      load_tile(lo_tile + it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cK = sK + buf * kTileElems;
    const __nv_bfloat16* cV = sV + buf * kTileElems;
    const unsigned char* cOk = sOk + buf * kTile;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = cK + (nt * 8 + g) * kRow + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[nt], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
    }

    // An "easy" tile has every key valid and every pair inside the window.
    const bool easy = k0 + kTile <= lead &&
                      (sw < 0 || (k0 + kTile - 1 - q0 <= sw && q_last - k0 <= sw));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[nt][e], kLog2e);
        if (!easy) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int qrow = (e < 2) ? qrow0 : qrow1;
          if (!cOk[col] || (sw >= 0 && abs(qrow - (k0 + col)) > sw)) x = -INFINITY;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    // A row that has seen no live key yet keeps m = -inf; subtracting 0
    // instead keeps its p and alpha exactly 0 (no inf - inf).
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      const float p0 = exp2f(__fsub_rn(s[nt][0], mu0));
      const float p1 = exp2f(__fsub_rn(s[nt][1], mu0));
      const float p2 = exp2f(__fsub_rn(s[nt][2], mu1));
      const float p3 = exp2f(__fsub_rn(s[nt][3], mu1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      // C fragment of key tiles (2j, 2j+1) is the A fragment of k-step j.
      const int j = nt >> 1;
      const int hi2 = (nt & 1) * 2;
      pa[j][hi2 + 0] = pack_bf16(p0, p1);
      pa[j][hi2 + 1] = pack_bf16(p2, p3);
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
        ldmatrix_x4_trans(vb, cV + (j * 16 + v_key) * kRow + dt * 8 + v_col);
        mma_bf16(o[dt], pa[j], vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa[j], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const int C = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = r ? qrow1 : qrow0;
    if (qrow >= N) continue;
    const float l = r ? l1 : l0;
    const float m = r ? m1 : m0;
    // Padded query rows and rows with no live key are written as 0.
    const bool keep = l > 0.f && (mask_b == nullptr || mask_b[qrow]);
    __nv_bfloat16* dst = out + ((long long)b * N + qrow) * C + h * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const float x0 = keep ? __fdiv_rn(o[dt][2 * r], l) : 0.f;
      const float x1 = keep ? __fdiv_rn(o[dt][2 * r + 1], l) : 0.f;
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
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float q_scale = (float)(1.0 / std::sqrt((double)D));
  dim3 grid((N + kTile - 1) / kTile, H, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
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
// window. Returns the cudaError_t of the launch (0 = success).
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
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
