// Persistent row streaming, shared by the two one-pass row kernels
// rmsnorm_quant.cu (#9) and silu_quant.cu (#8).
//
// A row group of L lanes owns one token row at a time: L = 32 is one warp a
// row, L = 64..256 spans L / 32 warps joined by one named barrier. Each lane
// owns the same P chunks of V adjacent channels in every row it processes
// (chunk u = lane + L * i), so anything per channel (#9's gain) is loaded
// once. A block of max(128, L) threads holds threads / L groups; the grid is
// the SM count times the blocks one SM hosts (one wave), and group g walks
// rows g, g + G, g + 2G, ... (G groups in all). Each group streams its rows
// through a ring of two row slots in shared memory, filled by 16-byte
// cp.async copies one row ahead of the row it reduces (one slot where two
// rows do not fit); the reductions are warp shuffles (plus the named barrier
// across a group's warps). The plan (L, V, P, stages, grid, shared bytes) is
// vitok_torch/ops/quant.py's rmsnorm_quant_plan / silu_quant_plan; the rules
// below mirror its split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;

// The blocks an SM must host for a block of `threads` threads whose lanes
// hold `words` values in registers beside about `overhead` registers of
// their own: the minimum of the kernels' __launch_bounds__. (The plan reads
// the blocks an SM does host from the runtime's occupancy query.)
constexpr int row_min_blocks(int threads, int words, int overhead) {
  const int regs = (words + overhead + 7) / 8 * 8;
  const int by_regs = 65536 / (regs * threads);
  const int by_threads = 2048 / threads;
  const int blocks = by_regs < by_threads ? by_regs : by_threads;
  return blocks < 1 ? 1 : blocks;
}

template <int L>
struct RowGroup {
  static constexpr int kThreads = L > 128 ? L : 128;
  static constexpr int kGroups = kThreads / L;
  static constexpr int kRedWarps = L > 32 ? L / 32 : 0;  // partials a group exchanges in shared memory
};

// A thread's place: its group in the block, its lane j in the group, and
// the group's index in the grid.
template <int L>
struct GroupLane {
  int tid, group, j, gid;
  __device__ __forceinline__ GroupLane()
      : tid(threadIdx.x), group(threadIdx.x / L), j(threadIdx.x % L),
        gid(blockIdx.x * RowGroup<L>::kGroups + threadIdx.x / L) {}
};

// Whether (L, P) is a split the plan can give for rows of at most kMaxUnits
// chunks when a lane holds at most kMaxP (quant.py _row_split): one warp
// any count; wider groups only where half as many lanes would need more
// than kMaxP chunks.
template <int L, int P, int kMaxP, int kMaxUnits>
constexpr bool split_ok() {
  if (P < 1 || P > kMaxP) return false;
  if (L == 32) return true;
  return 2 * P > kMaxP && (L / 2) * kMaxP < kMaxUnits;
}

template <int L, int P, int kMaxP, int kMaxUnits, typename F>
cudaError_t with_per(int per, F& f) {
  if constexpr (P > 8) {
    return cudaErrorInvalidValue;
  } else {
    if (per == P) {
      if constexpr (split_ok<L, P, kMaxP, kMaxUnits>()) return f.template run<L, P>();
      return cudaErrorInvalidValue;
    }
    return with_per<L, P + 1, kMaxP, kMaxUnits>(per, f);
  }
}

// f.run<L, P>() for the runtime split, where it is one of the instances.
template <int kMaxP, int kMaxUnits, typename F>
cudaError_t with_split(int lanes, int per, F& f) {
  switch (lanes) {
    case 32: return with_per<32, 1, kMaxP, kMaxUnits>(per, f);
    case 64: return with_per<64, 1, kMaxP, kMaxUnits>(per, f);
    case 128: return with_per<128, 1, kMaxP, kMaxUnits>(per, f);
    case 256: return with_per<256, 1, kMaxP, kMaxUnits>(per, f);
    default: return cudaErrorInvalidValue;
  }
}

// The launch on `device`, the caller's current device restored after it.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Dynamic shared memory above 48 KB for `kernel`, asked once per device and
// size (`allowed` is the instance's own record).
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

// Registers and spilled bytes a thread, blocks one SM hosts, shared bytes.
template <typename K>
cudaError_t row_attributes(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  out[3] = smem;
  return cudaSuccess;
}

// The group's barrier: the warp, or named barrier 1 + group over the group's
// warps. The ids are immediates, so a block holds only the barriers it uses
// (with an id in a register it would hold all sixteen, and fewer blocks
// would fit an SM).
template <int L>
__device__ __forceinline__ void group_bar(int group) {
  static_assert(RowGroup<L>::kGroups <= 2 || L == 32, "named barriers 1 and 2 only");
  if constexpr (L == 32) {
    __syncwarp();
  } else if (RowGroup<L>::kGroups == 1 || group == 0) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(L) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;\n" ::"n"(L) : "memory");
  }
}

// Sum over the group, the same bits in every lane (IEEE addition commutes, so
// both lanes of a butterfly pair add the same two values; the warps'
// partials are added in warp order). `red`: the group's kRedWarps slots.
template <int L>
__device__ __forceinline__ double group_sum(double v, double* red, int group, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  if constexpr (L > 32) {
    if ((tid & 31) == 0) red[(tid % L) / 32] = v;
    group_bar<L>(group);
    v = red[0];
#pragma unroll
    for (int w = 1; w < L / 32; ++w) v += red[w];
  }
  return v;
}

template <int L>
__device__ __forceinline__ float group_max(float v, float* red, int group, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  if constexpr (L > 32) {
    if ((tid & 31) == 0) red[(tid % L) / 32] = v;
    group_bar<L>(group);
    v = red[0];
#pragma unroll
    for (int w = 1; w < L / 32; ++w) v = fmaxf(v, red[w]);
  }
  return v;
}

// One chunk of V adjacent channels of T as 16-byte words.
template <typename T, int V>
struct Chunk {
  static constexpr int kQuads = V * (int)sizeof(T) / 16;
  uint4 raw[kQuads];

  __device__ __forceinline__ void load(const unsigned char* p) {
#pragma unroll
    for (int k = 0; k < kQuads; ++k) raw[k] = reinterpret_cast<const uint4*>(p)[k];
  }
  // bf16 is the upper half of an fp32: the conversion is exact.
  __device__ __forceinline__ void to_float(float (&f)[V]) const {
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const uint32_t w[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (std::is_same<T, float>::value) {
          f[4 * k + i] = __uint_as_float(w[i]);
        } else {
          f[8 * k + 2 * i] = __uint_as_float(w[i] << 16);
          f[8 * k + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  }
};

// A row's scalars by exact IEEE rounding without the division (whose slow
// path is a call, around which live registers would be saved): a result
// known within one step is corrected by comparing the exact quotient with
// the midpoints beside it. For floats a >= 0, b > 0 and a midpoint m of the
// fp32 grid (25 significant bits), m * b has at most 49 bits, so a double
// fma gives a - m b rounded once, with its sign exact; and a / b is never a
// midpoint (m b has more significant bits than a).
__device__ __forceinline__ float next_up(float x) { return __uint_as_float(__float_as_uint(x) + 1u); }
__device__ __forceinline__ float next_down(float x) { return __uint_as_float(__float_as_uint(x) - 1u); }
__device__ __forceinline__ double mid_up(float x) { return 0.5 * ((double)x + (double)next_up(x)); }
__device__ __forceinline__ double mid_down(float x) { return 0.5 * ((double)x + (double)next_down(x)); }

// a / b rounded to the nearest float (a >= 0, b > 0 finite), from c within
// one step of it.
__device__ __forceinline__ float round_quotient(float c, float a, float b) {
  const double da = a, db = b;
  if (__fma_rn(-mid_up(c), db, da) > 0.0) return next_up(c);
  if (c > 0.f && __fma_rn(-mid_down(c), db, da) < 0.0) return next_down(c);
  return c;
}

// The per-token scale max(absmax / 127, 1e-12), the division's bits.
__device__ __forceinline__ float token_scale(float amax) {
  return fmaxf(round_quotient(__fmul_rn(amax, 1.f / 127.f), amax, 127.f), 1e-12f);
}

// 1 / s within one step (the approximate reciprocal and a Newton step): the
// quantize's multiplier, s a normal float.
__device__ __forceinline__ float faithful_rcp(float s) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return __fmaf_rn(r, __fmaf_rn(-s, r, 1.f), r);
}

// A chunk's V codes clip(rint(y / scale), -127, 127), the quotient rounded
// as the IEEE division rounds it (the plain versions divide), in one store:
// 16 bytes (V = 16) or 8 (V = 8). With rcp within one step of 1 / scale,
// q = y * rcp lies within 2.7e-5 of the rounded quotient, and |q| < 127.0001
// (|y| <= absmax, scale >= absmax / 127), so q rounds to the same integer,
// within the clip, unless it lies within kTieBand of a half-integer; a chunk
// with such an element divides for all of them (one branch a chunk, none an
// element; the division's slow path, a call, stays out of the fast code).
// q + 1.5 * 2^23 rounds q to an integer (half to even) and holds it in its
// low byte.
constexpr float kTieBand = 1.f / 8192.f;
constexpr float kRoundMagic = 12582912.f;

template <int V>
__device__ __forceinline__ void store_codes(int8_t* dst, const float (&y)[V], float scale, float rcp) {
  float n[V];
  bool near_half = false;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float q = __fmul_rn(y[e], rcp);
    n[e] = __fadd_rn(q, kRoundMagic);
    near_half |= fabsf(__fsub_rn(q, __fsub_rn(n[e], kRoundMagic))) > 0.5f - kTieBand;
  }
  if (near_half) {
#pragma unroll
    for (int e = 0; e < V; ++e) n[e] = __fadd_rn(fminf(fmaxf(__fdiv_rn(y[e], scale), -127.f), 127.f), kRoundMagic);
  }
  uint32_t w[V / 4];
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    const uint32_t lo = __byte_perm(__float_as_uint(n[4 * k]), __float_as_uint(n[4 * k + 1]), 0x0040);
    const uint32_t hi = __byte_perm(__float_as_uint(n[4 * k + 2]), __float_as_uint(n[4 * k + 3]), 0x0040);
    w[k] = __byte_perm(lo, hi, 0x5410);
  }
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// The rows of group `gid` (rows gid, gid + ngroups, ...), each copied from
// `src` (row_bytes a row) into the group's ring of `stages` slots (2: the
// next row's copies in flight while this one is reduced; 1 where two rows do
// not fit), then handed to compute(row, slot). setup() runs once, after the
// first row's copies are issued (#9 stages its gain meanwhile; it may hold a
// block barrier: every thread calls it).
template <int L, typename Setup, typename Compute>
__device__ __forceinline__ void stream_rows(const unsigned char* src, int row_bytes, int rows, int gid, int ngroups,
                                            unsigned char* ring, int stages, int group, int j, Setup&& setup,
                                            Compute&& compute) {
  const int turns = gid < rows ? (rows - gid + ngroups - 1) / ngroups : 0;
  auto issue = [&](int t) {
    if (t < turns) {
      const unsigned char* s = src + (gid + (long long)t * ngroups) * row_bytes;
      unsigned char* d = ring + (t % stages) * row_bytes;
      for (int o = j * 16; o < row_bytes; o += L * 16) cp_async16(d + o, s + o);
    }
    cp_async_commit();
  };
  issue(0);
  setup();
  for (int t = 0; t < turns; ++t) {
    cp_async_wait<0>();
    group_bar<L>(group);  // the row's copies visible; every lane done with the slot refilled next
    if (stages > 1) issue(t + 1);
    compute(gid + (long long)t * ngroups, ring + (t % stages) * row_bytes);
    if (stages == 1) {
      group_bar<L>(group);
      issue(t + 1);
    }
  }
  cp_async_wait<0>();
}

}  // namespace
