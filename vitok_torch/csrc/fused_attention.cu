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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kTile = 64;      // query rows per block and keys per tile
constexpr int kWarps = 4;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 row padding: conflict-free fragment loads
constexpr float kNegFill = -1e30f;
constexpr float kRmsEps = 1e-6f;
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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Four transposed 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Normalises and rotates rows [r0, r0 + 64) of one head's q or k channels
// (`src` points at row 0, channel 0 of that head) into `dst` (row stride
// Smem<D>::kRow). Rows at or past N become zeros. Two passes' loads are in
// flight at once: the whole tile at D = 64, half of it at D = 128.
template <int D>
__device__ __forceinline__ void norm_rope_tile(
    const __nv_bfloat16* __restrict__ src, long long row_stride, int r0, int N,
    const float* gain, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    __nv_bfloat16* dst, int tid) {
  constexpr int kHalf = D / 2;
  constexpr int kPieces = D / 16;                  // threads per row
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = kTile / kRowsPerPass;    // 2 (D = 64) or 4 (D = 128)
  constexpr int kBatch = 2;
  const int c0 = (tid % kPieces) * 8;
#pragma unroll
  for (int p0 = 0; p0 < kPasses; p0 += kBatch) {
    uint4 xr[kBatch], xi[kBatch];
    float4 cs[kBatch][2], sn[kBatch][2];
    int rows[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rows[u] = (p0 + u) * kRowsPerPass + tid / kPieces;
      const int n = r0 + rows[u];
      xr[u] = xi[u] = make_uint4(0, 0, 0, 0);
      cs[u][0] = cs[u][1] = sn[u][0] = sn[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) {
        const __nv_bfloat16* x = src + (long long)n * row_stride + c0;
        const float* c = cos_t + (long long)n * kHalf + c0;
        const float* s = sin_t + (long long)n * kHalf + c0;
        xr[u] = *reinterpret_cast<const uint4*>(x);
        xi[u] = *reinterpret_cast<const uint4*>(x + kHalf);
        cs[u][0] = *reinterpret_cast<const float4*>(c);
        cs[u][1] = *reinterpret_cast<const float4*>(c + 4);
        sn[u][0] = *reinterpret_cast<const float4*>(s);
        sn[u][1] = *reinterpret_cast<const float4*>(s + 4);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const __nv_bfloat16* hr = reinterpret_cast<const __nv_bfloat16*>(&xr[u]);
      const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(&xi[u]);
      const float* c = reinterpret_cast<const float*>(&cs[u][0]);
      const float* s = reinterpret_cast<const float*>(&sn[u][0]);
      float a[8], b[8];
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[e] = __bfloat162float(hr[e]);
        b[e] = __bfloat162float(hi[e]);
        ss = __fadd_rn(ss, __fmul_rn(a[e], a[e]));
        ss = __fadd_rn(ss, __fmul_rn(b[e], b[e]));
      }
#pragma unroll
      for (int off = 1; off < kPieces; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      const float r = rsqrtf(__fadd_rn(ss / D, kRmsEps));
      const float* gr = gain + c0;
      const float* gi = gain + kHalf + c0;
      uint32_t out_r[4], out_i[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 yr = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(a[e], r), gr[e]),
                                                        __fmul_rn(__fmul_rn(a[e + 1], r), gr[e + 1]));
        const __nv_bfloat162 yi = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(b[e], r), gi[e]),
                                                        __fmul_rn(__fmul_rn(b[e + 1], r), gi[e + 1]));
        const __nv_bfloat162 ce = __floats2bfloat162_rn(c[e], c[e + 1]);
        const __nv_bfloat162 se = __floats2bfloat162_rn(s[e], s[e + 1]);
        const __nv_bfloat162 vr = __hsub2(__hmul2(yr, ce), __hmul2(yi, se));  // xr*cos - xi*sin
        const __nv_bfloat162 vi = __hadd2(__hmul2(yr, se), __hmul2(yi, ce));  // xr*sin + xi*cos
        out_r[e / 2] = *reinterpret_cast<const uint32_t*>(&vr);
        out_i[e / 2] = *reinterpret_cast<const uint32_t*>(&vi);
      }
      __nv_bfloat16* d = dst + rows[u] * Smem<D>::kRow + c0;
      *reinterpret_cast<uint4*>(d) = make_uint4(out_r[0], out_r[1], out_r[2], out_r[3]);
      *reinterpret_cast<uint4*>(d + kHalf) = make_uint4(out_i[0], out_i[1], out_i[2], out_i[3]);
    }
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
  constexpr int kRow = S::kRow;
  constexpr int kD2 = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + S::kQ);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + S::kK);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + S::kV);
  float* sGainQ = reinterpret_cast<float*>(smem + S::kGainQ);
  float* sGainK = reinterpret_cast<float*>(smem + S::kGainK);
  unsigned char* sKeyState = smem + S::kKeyState;  // 0 valid, 1 masked, 2 past N
  __shared__ int sKvEnd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id
  const int t = lane & 3;    // thread in group
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long long row_stride = 3LL * C;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * row_stride;
  const float* cos_b = cos_t + (long long)b * N * kD2;
  const float* sin_b = sin_t + (long long)b * N * kD2;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;

  for (int i = tid; i < D; i += kThreads) {
    sGainQ[i] = q_scale[i];
    sGainK[i] = k_scale[i];
  }
  // One past the last valid key (NaFlex padding is a tail suffix, but the
  // per-key mask below keeps any mask exact; this only bounds the loop).
  if (tid == 0) sKvEnd = mask_b ? 0 : N;
  __syncthreads();
  if (mask_b) {
    int last = 0;
    for (int j = tid; j < N; j += kThreads)
      if (mask_b[j]) last = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      last = max(last, __shfl_xor_sync(kFull, last, off));
    if (lane == 0) atomicMax(&sKvEnd, last);
  }

  norm_rope_tile<D>(qkv_b + h * D, row_stride, q0, N, sGainQ, cos_b, sin_b, sQ, tid);
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

  const int kv_end = sKvEnd;
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
      norm_rope_tile<D>(qkv_b + C + h * D, row_stride, k0, N, sGainK, cos_b, sin_b, sK, tid);
      if (tid < kTile) {
        const int j = k0 + tid;
        sKeyState[tid] = j >= N ? 2 : ((mask_b && !mask_b[j]) ? 1 : 0);
      }
      cp_async_wait_all();
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
  __nv_bfloat16* out_b = out + (long long)b * N * C + h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (qrow0 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_b + (long long)qrow0 * C + col) =
          __floats2bfloat162_rn(o[dt][0] / l0, o[dt][1] / l0);
    if (qrow1 < N)
      *reinterpret_cast<__nv_bfloat162*>(out_b + (long long)qrow1 * C + col) =
          __floats2bfloat162_rn(o[dt][2] / l1, o[dt][3] / l1);
  }
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

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
