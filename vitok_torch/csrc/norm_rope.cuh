// QK-RMSNorm + rotate-half RoPE on a 64-row tile of one head's channels, and
// its backward, shared by the fused attention kernels (fused_attention.cu:
// the forward, its int8-epilogue and fp32 instances; fused_attention_bwd.cu;
// fused_attention_sm90.cu, whose q/k prologue also reads int8 codes for the
// int8-input kernel; the wgmma body of fused_attend_sm90.cuh, whose in-place
// q norm shares norm_rope_piece, as does the int8-input kernel's q norm in
// fused_attention_q8in_sm90.cu).
//
// A row of D channels is cut into D/16 pieces, one thread each: channels
// [8p, 8p + 8) and their rotate-half partners [D/2 + 8p, D/2 + 8p + 8), so
// the rotation stays in the thread. A row's threads are its lanes: D/16
// rounded up to a power of two (nr_lanes), neighbouring threads of one
// warp, so an xor butterfly over log2(lanes) shuffles reduces a row without
// mixing rows. At d = 192 a row has 16 lanes, of which the first 12 hold
// its pieces and the last 4 hold zeros (they read and write nothing). The
// order of a row's sum of squares, which the plain version _rms_inv
// (vitok_torch/ops/fused_attention.py) repeats: each thread adds its 8
// channels' squares and their partners' in turn, then the lanes' sums are
// added pairwise, neighbours first (the butterfly: the pieces padded with
// zeros to the lane count, then halved). Every lane ends with the same sum.
// Rounding points of the TPU kernels (vitok_tpu/ops/fused_attention.py,
// _norm_rope_half and _fused_bwd_kernel): statistics in fp32 with eps 1e-6,
// the normed value times the fp32 gain cast to bf16, the rotation in bf16
// with the fp32 cos/sin tables rounded to bf16 first; the backward's rotation
// transpose and norm backward in fp32 on the raw rows.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kNrTile = 64;   // rows per tile
constexpr int kNrPad = 8;     // bf16 row padding of the shared-memory tiles
constexpr float kNrEps = 1e-6f;
constexpr unsigned kNrFull = 0xffffffffu;

// The least power of two at or above x.
__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// A row's lanes: its D/16 pieces rounded up to a power of two.
template <int D>
__host__ __device__ constexpr int nr_lanes() {
  return pow2_at_least(D / 16);
}

// The sum of `v` over a row's lanes (the xor butterfly; every lane gets it).
template <int D>
__device__ __forceinline__ float nr_row_sum(float v) {
#pragma unroll
  for (int off = 1; off < nr_lanes<D>(); off <<= 1) v += __shfl_xor_sync(kNrFull, v, off);
  return v;
}

// The rotation's tables at eight channels of a row, rounded to bf16 (the
// rounding point of the rotation): four bf16 pairs each of cos and sin.
__device__ __forceinline__ void rope_pairs(const float* c, const float* s, __nv_bfloat162 (&ce)[4],
                                           __nv_bfloat162 (&se)[4]) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    ce[e / 2] = __floats2bfloat162_rn(c[e], c[e + 1]);
    se[e / 2] = __floats2bfloat162_rn(s[e], s[e + 1]);
  }
}

// One thread's piece of a row: channels [8p, 8p + 8) (raw values a) and
// their rotate-half partners (b), with the row's cos / sin at those channels
// (ce, se: rope_pairs) and the gains of the two halves (gr, gi). The row's
// sum of squares is reduced over the row's lanes (nr_row_sum; a lane that
// holds no piece passes zeros). Writes the normed, rotated bf16 values of
// both halves.
template <int D, bool RoundEach>
__device__ __forceinline__ void norm_rope_piece(const float (&a)[8], const float (&b)[8],
                                                const __nv_bfloat162 (&ce4)[4], const __nv_bfloat162 (&se4)[4],
                                                const float* gr, const float* gi, uint4& out_r, uint4& out_i) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    ss = __fadd_rn(ss, __fmul_rn(a[e], a[e]));
    ss = __fadd_rn(ss, __fmul_rn(b[e], b[e]));
  }
  ss = nr_row_sum<D>(ss);
  const float r = rsqrtf(__fadd_rn(ss / D, kNrEps));
  uint32_t* o_r = reinterpret_cast<uint32_t*>(&out_r);
  uint32_t* o_i = reinterpret_cast<uint32_t*>(&out_i);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const __nv_bfloat162 yr = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(a[e], r), gr[e]),
                                                    __fmul_rn(__fmul_rn(a[e + 1], r), gr[e + 1]));
    const __nv_bfloat162 yi = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(b[e], r), gi[e]),
                                                    __fmul_rn(__fmul_rn(b[e + 1], r), gi[e + 1]));
    const __nv_bfloat162 ce = ce4[e / 2];
    const __nv_bfloat162 se = se4[e / 2];
    __nv_bfloat162 vr, vi;
    if constexpr (RoundEach) {
      vr = __hsub2(__hmul2_rn(yr, ce), __hmul2_rn(yi, se));  // xr*cos - xi*sin
      vi = __hadd2(__hmul2_rn(yr, se), __hmul2_rn(yi, ce));  // xr*sin + xi*cos
    } else {
      vr = __hsub2(__hmul2(yr, ce), __hmul2(yi, se));
      vi = __hadd2(__hmul2(yr, se), __hmul2(yi, ce));
    }
    o_r[e / 2] = *reinterpret_cast<const uint32_t*>(&vr);
    o_i[e / 2] = *reinterpret_cast<const uint32_t*>(&vi);
  }
}

// Normalises and rotates rows [r0, r0 + 64) of one head's q or k channels
// (`src` points at row 0, channel 0 of that head) into `dst` (row stride
// D + 8). Rows at or past N become zeros. A lane past the row's pieces (d =
// 192) reads and writes nothing. Two passes' loads are in flight at once. `Src` is bf16, or int8 codes, which are exact in bf16 and are normed
// as they are (8-byte loads). With RoundEach the rotation's bf16 products
// are rounded before their sum (__hmul2_rn: no contraction into an fma), as
// the plain version's separate tensor operations round them; without it
// the compiler may contract them, which the mma.sync kernels keep for their
// bits.
template <int D, int THREADS, typename Src, bool RoundEach = false>
__device__ __forceinline__ void norm_rope_tile(
    const Src* __restrict__ src, long long row_stride, int r0, int N,
    const float* gain, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    __nv_bfloat16* dst, int tid) {
  constexpr bool kCodes = sizeof(Src) == 1;
  constexpr int kRow = D + kNrPad;
  constexpr int kHalf = D / 2;
  constexpr int kLanes = nr_lanes<D>();            // threads per row
  constexpr int kRowsPerPass = THREADS / kLanes;
  constexpr int kPasses = kNrTile / kRowsPerPass;
  constexpr int kBatch = 2;
  static_assert(kPasses % kBatch == 0, "tile passes come in pairs");
  const bool piece = tid % kLanes < D / 16;        // this lane holds a piece of its row
  const int c0 = piece ? (tid % kLanes) * 8 : 0;
#pragma unroll
  for (int p0 = 0; p0 < kPasses; p0 += kBatch) {
    uint4 xr[kBatch], xi[kBatch];
    float4 cs[kBatch][2], sn[kBatch][2];
    int rows[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      rows[u] = (p0 + u) * kRowsPerPass + tid / kLanes;
      const int n = r0 + rows[u];
      xr[u] = xi[u] = make_uint4(0, 0, 0, 0);
      cs[u][0] = cs[u][1] = sn[u][0] = sn[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (piece && n < N) {
        const Src* x = src + (long long)n * row_stride + c0;
        const float* c = cos_t + (long long)n * kHalf + c0;
        const float* s = sin_t + (long long)n * kHalf + c0;
        if constexpr (kCodes) {
          const uint2 lo = *reinterpret_cast<const uint2*>(x);
          const uint2 hi = *reinterpret_cast<const uint2*>(x + kHalf);
          xr[u] = make_uint4(lo.x, lo.y, 0, 0);
          xi[u] = make_uint4(hi.x, hi.y, 0, 0);
        } else {
          xr[u] = *reinterpret_cast<const uint4*>(x);
          xi[u] = *reinterpret_cast<const uint4*>(x + kHalf);
        }
        cs[u][0] = *reinterpret_cast<const float4*>(c);
        cs[u][1] = *reinterpret_cast<const float4*>(c + 4);
        sn[u][0] = *reinterpret_cast<const float4*>(s);
        sn[u][1] = *reinterpret_cast<const float4*>(s + 4);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      float a[8], b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (kCodes) {
          a[e] = (float)reinterpret_cast<const int8_t*>(&xr[u])[e];
          b[e] = (float)reinterpret_cast<const int8_t*>(&xi[u])[e];
        } else {
          a[e] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&xr[u])[e]);
          b[e] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&xi[u])[e]);
        }
      }
      __nv_bfloat162 ce[4], se[4];
      rope_pairs(reinterpret_cast<const float*>(&cs[u][0]), reinterpret_cast<const float*>(&sn[u][0]), ce, se);
      uint4 yr, yi;
      norm_rope_piece<D, RoundEach>(a, b, ce, se, gain + c0, gain + kHalf + c0, yr, yi);
      if (piece) {
        __nv_bfloat16* d = dst + rows[u] * kRow + c0;
        *reinterpret_cast<uint4*>(d) = yr;
        *reinterpret_cast<uint4*>(d + kHalf) = yi;
      }
    }
  }
}

// Eight floats through two 16-byte accesses (`p` 16-byte aligned).
__device__ __forceinline__ void ld_f4x2(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void st_f4x2(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// One thread's piece of a row in fp32: raw channels a ([8p, 8p + 8)) and
// their rotate-half partners b, the row's fp32 tables c, s at those channels
// and the gains of the two halves (gr, gi); the sum of squares in
// norm_rope_piece's order, reduced over the row's lanes. The normed value times the gain and the rotation stay in
// fp32, each product and sum rounded once (as the plain version's separate
// tensor operations round them): vr, vi.
template <int D>
__device__ __forceinline__ void norm_rope_piece_f32(const float (&a)[8], const float (&b)[8], const float (&c)[8],
                                                    const float (&s)[8], const float* gr, const float* gi,
                                                    float (&vr)[8], float (&vi)[8]) {
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    ss = __fadd_rn(ss, __fmul_rn(a[e], a[e]));
    ss = __fadd_rn(ss, __fmul_rn(b[e], b[e]));
  }
  ss = nr_row_sum<D>(ss);
  const float r = rsqrtf(__fadd_rn(ss / D, kNrEps));
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float yr = __fmul_rn(__fmul_rn(a[e], r), gr[e]);
    const float yi = __fmul_rn(__fmul_rn(b[e], r), gi[e]);
    vr[e] = __fsub_rn(__fmul_rn(yr, c[e]), __fmul_rn(yi, s[e]));  // xr*cos - xi*sin
    vi[e] = __fadd_rn(__fmul_rn(yr, s[e]), __fmul_rn(yi, c[e]));  // xr*sin + xi*cos
  }
}

// Whether lane `tid` of a row's nr_lanes<D>() holds one of its D/16 pieces
// (every lane but at d = 192, where 12 of 16 do).
template <int D>
__device__ __forceinline__ bool nr_piece(int tid) {
  return nr_lanes<D>() == D / 16 || tid % nr_lanes<D>() < D / 16;
}

// The fp32 instance of norm_rope_tile: the same rows, thread layout (a row's
// lanes; at d = 192 a lane past its pieces reads and writes nothing and adds
// zeros) and order of the sum of squares, norm_rope_piece_f32's arithmetic.
// `dst` has row stride D + 4 floats.
template <int D, int THREADS>
__device__ __forceinline__ void norm_rope_tile_f32(
    const float* __restrict__ src, long long row_stride, int r0, int N,
    const float* gain, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    float* dst, int tid) {
  constexpr int kRow = D + 4;
  constexpr int kHalf = D / 2;
  constexpr int kLanes = nr_lanes<D>();  // threads per row
  constexpr int kRowsPerPass = THREADS / kLanes;
  constexpr int kPasses = kNrTile / kRowsPerPass;
  const bool piece = nr_piece<D>(tid);
  const int c0 = piece ? (tid % kLanes) * 8 : 0;
#pragma unroll 2
  for (int p = 0; p < kPasses; ++p) {
    const int row = p * kRowsPerPass + tid / kLanes;
    const int n = r0 + row;
    float a[8], b[8], c[8], s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = b[e] = c[e] = s[e] = 0.f;
    if (piece && n < N) {
      const float* x = src + (long long)n * row_stride + c0;
      const float* cp = cos_t + (long long)n * kHalf + c0;
      const float* sp = sin_t + (long long)n * kHalf + c0;
      ld_f4x2(a, x);
      ld_f4x2(b, x + kHalf);
      ld_f4x2(c, cp);
      ld_f4x2(s, sp);
    }
    float vr[8], vi[8];
    norm_rope_piece_f32<D>(a, b, c, s, gain + c0, gain + kHalf + c0, vr, vi);
    if (piece) {
      float* d = dst + row * kRow + c0;
      st_f4x2(d, vr);
      st_f4x2(d + kHalf, vi);
    }
  }
}

// Backward of norm_rope_tile for rows [r0, r0 + 64): `dz` holds the fp32
// gradient of the rotated rows (row stride D + 4 floats, in shared memory).
// Applies the rotation's transpose (cos/sin rounded to bf16, then fp32
// arithmetic) and the RMSNorm backward on the raw rows re-read from `src`,
// and writes the bf16 gradient of the raw rows to `dst` (same layout as
// `src`); rows at or past N are not touched. The thread layout is
// norm_rope_tile's: a row's lanes (nr_lanes), at d = 192 16 of which 12 hold
// its pieces; the others read and write nothing and add zeros to the row's
// sums, which go over the lanes' xor butterfly (nr_row_sum). With T = float
// (the fp32 instance of norm_rope_tile_f32) the raw rows and the gradient are
// fp32 and the tables are not rounded. The gain's gradient, summed over the
// tile's rows in a fixed order, goes to gain_grad[0 .. D): `part` is a
// [THREADS / nr_lanes, D] fp32 scratch in shared memory (nr_bwd_part_bytes)
// that must not overlap `dz`. Ends with the block synchronised.
//   y = x * r * gain, r = rsqrt(mean(x^2) + eps)
//   dgain = sum_rows dy * x * r
//   dx = dy * gain * r - x * (r^3 / D) * sum_d(dy * gain * x)
template <int D, int THREADS, typename T>
__device__ __forceinline__ void norm_rope_bwd_tile(
    const float* dz, const T* __restrict__ src, long long row_stride, int r0, int N,
    const float* gain, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    T* __restrict__ dst, float* part, float* __restrict__ gain_grad, int tid) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kStage = D + 4;
  constexpr int kHalf = D / 2;
  constexpr int kLanes = nr_lanes<D>();
  constexpr int kRowsPerPass = THREADS / kLanes;
  constexpr int kPasses = kNrTile / kRowsPerPass;
  const bool piece = tid % kLanes < D / 16;  // this lane holds a piece of its row
  const int c0 = piece ? (tid % kLanes) * 8 : 0;
  const float* gr = gain + c0;
  const float* gi = gain + kHalf + c0;
  float pg_r[8], pg_i[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) pg_r[e] = pg_i[e] = 0.f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int row = p * kRowsPerPass + tid / kLanes;
    const int n = r0 + row;
    const bool live = piece && n < N;
    float a[8], b[8], c[8], s[8], zr[8], zi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = b[e] = c[e] = s[e] = zr[e] = zi[e] = 0.f;
    if (live) {
      const T* x = src + (long long)n * row_stride + c0;
      const float* cp = cos_t + (long long)n * kHalf + c0;
      const float* sp = sin_t + (long long)n * kHalf + c0;
      if constexpr (kF32) {
        ld_f4x2(a, x);
        ld_f4x2(b, x + kHalf);
        ld_f4x2(c, cp);
        ld_f4x2(s, sp);
      } else {
        const uint4 xr = *reinterpret_cast<const uint4*>(x);
        const uint4 xi = *reinterpret_cast<const uint4*>(x + kHalf);
        const __nv_bfloat16* hr = reinterpret_cast<const __nv_bfloat16*>(&xr);
        const __nv_bfloat16* hi = reinterpret_cast<const __nv_bfloat16*>(&xi);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a[e] = __bfloat162float(hr[e]);
          b[e] = __bfloat162float(hi[e]);
          c[e] = __bfloat162float(__float2bfloat16_rn(cp[e]));
          s[e] = __bfloat162float(__float2bfloat16_rn(sp[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        zr[e] = dz[row * kStage + c0 + e];
        zi[e] = dz[row * kStage + kHalf + c0 + e];
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ss = __fadd_rn(ss, __fmul_rn(a[e], a[e]));
      ss = __fadd_rn(ss, __fmul_rn(b[e], b[e]));
    }
    ss = nr_row_sum<D>(ss);
    const float r = rsqrtf(__fadd_rn(ss / D, kNrEps));
    float g_r[8], g_i[8];
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float dyr = zr[e] * c[e] + zi[e] * s[e];
      const float dyi = zi[e] * c[e] - zr[e] * s[e];
      pg_r[e] += dyr * a[e] * r;
      pg_i[e] += dyi * b[e] * r;
      g_r[e] = dyr * gr[e];
      g_i[e] = dyi * gi[e];
      dot += g_r[e] * a[e] + g_i[e] * b[e];
    }
    dot = nr_row_sum<D>(dot);
    if (live && kF32) {
      const float w = r * r * r / D * dot;
      float out_r[8], out_i[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out_r[e] = g_r[e] * r - a[e] * w;
        out_i[e] = g_i[e] * r - b[e] * w;
      }
      float* d = reinterpret_cast<float*>(dst + (long long)n * row_stride + c0);
      st_f4x2(d, out_r);
      st_f4x2(d + kHalf, out_i);
    } else if (live) {
      const float w = r * r * r / D * dot;
      uint32_t out_r[4], out_i[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 dr = __floats2bfloat162_rn(g_r[e] * r - a[e] * w,
                                                        g_r[e + 1] * r - a[e + 1] * w);
        const __nv_bfloat162 di = __floats2bfloat162_rn(g_i[e] * r - b[e] * w,
                                                        g_i[e + 1] * r - b[e + 1] * w);
        out_r[e / 2] = *reinterpret_cast<const uint32_t*>(&dr);
        out_i[e / 2] = *reinterpret_cast<const uint32_t*>(&di);
      }
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst + (long long)n * row_stride + c0);
      *reinterpret_cast<uint4*>(d) = make_uint4(out_r[0], out_r[1], out_r[2], out_r[3]);
      *reinterpret_cast<uint4*>(d + kHalf) = make_uint4(out_i[0], out_i[1], out_i[2], out_i[3]);
    }
  }
  if (piece) {
    float* mine = part + (tid / kLanes) * D;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mine[c0 + e] = pg_r[e];
      mine[kHalf + c0 + e] = pg_i[e];
    }
  }
  __syncthreads();
  for (int ch = tid; ch < D; ch += THREADS) {
    float sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < kRowsPerPass; ++j) sum += part[j * D + ch];
    gain_grad[ch] = sum;
  }
  __syncthreads();
}

// Bytes of norm_rope_bwd_tile's `part` scratch for THREADS threads.
template <int D, int THREADS>
__host__ __device__ constexpr int nr_bwd_part_bytes() {
  return THREADS / nr_lanes<D>() * D * 4;
}

}  // namespace
