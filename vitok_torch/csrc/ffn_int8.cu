// Fused int8 fc1 product (both SwiGLU halves) + dequantize + f32
// silu(g) * v + exact per-token int8 requantization.
//
// Replaces the TPU kernel vitok_tpu/ops/quant.py::_ffn_int8_kernel
// (launcher fused_ffn_int8). Same function, op for op:
//   acc_v, acc_g = hq @ W_v^T, hq @ W_g^T          (exact int32);
//   v = (float(acc_v) * hs) * sv; g = (float(acc_g) * hs) * sg;
//   t = silu(g) * v        (f32; silu(g) = g * sigmoid(g), sigmoid as PyTorch's
//                           CUDA kernel computes it, 1 / (1 + expf(-g)), so the
//                           plain version fused_ffn_int8_plain gives the same bits);
//   scale = max(absmax(t) / 127, 1e-12) over the f32 t of the whole row;
//   q = clip(rint(float(bf16(t)) * (1 / scale)), -127, 127)
// with t staged in bf16 and the multiplication by the reciprocal, as the
// TPU kernel has it (its quantize phase reads the bf16 VMEM scratch).
//
// The per-token scale spans all F' columns. On the TPU the grid runs in
// order and one row tile's whole [MT, F'] bf16 t stays in VMEM between the
// GEMM phase and the quantize phase. Hopper's blocks run in any order with
// at most 227 KB of shared memory, and a bf16 row alone is 5.6 KB at 350M
// (16.6 KB at 5B), so this version splits the work in two launches:
//   1. ffn_int8_gemm_kernel: one block per 128-row x 64-column output tile
//      computes the matching v tile AND g tile (weight rows p and F' + p),
//      so both are in registers for the epilogue; mma.sync m16n8k32 s8 ->
//      s32 fed from a 3-stage cp.async ring of 16-byte copies (hq row-major,
//      W [2F', C] K-contiguous, i.e. "col"), fragments read with ldmatrix.
//      The epilogue dequantizes, applies silu(g) * v in f32, writes bf16 t
//      to a [M, F'] workspace and folds each row's absmax of the f32 t into
//      an [M] buffer with atomicMax on the float's bits (valid for
//      non-negative floats; the wrapper zeroes the buffer).
//   2. ffn_int8_quant_kernel: reads t back and writes the int8 codes and
//      the per-token scales.
// The bf16 t goes to device memory and back once (about 92 MB each way at
// M = 16384, F' = 2816): half the bytes of the unfused [M, 2F'] chain.
// Keeping t on chip (a thread-block cluster splitting F' and exchanging the
// row absmax through distributed shared memory, with wgmma and TMA) is the
// redesign to come (ROADMAP.md).
//
// What bounds it on an H100: operations. At M = 16384, C = 1024, 2F' = 5632
// the product is 2 * M * C * 2F' = 1.89e11 int8 operations, 0.096 ms at
// 1,979 TOP/s; its bytes (hq, W, codes) take about 0.021 ms. This version
// runs mma.sync (about half of wgmma's rate) and writes t with 4-byte
// stores (half-used 32-byte sectors).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; both launches are asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kBM = 128;              // token rows per block
constexpr int kBN = 64;               // t columns per block (64 v + 64 g weight rows)
constexpr int kBK = 64;               // int8 depth per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;         // 8 warps: 4 along M (32 rows) x 2 along N (32 columns)
constexpr int kStride = kBK + 16;     // shared row stride in bytes: conflict-free ldmatrix
constexpr int kStageBytes = (kBM + 2 * kBN) * kStride;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kQuantThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Four 8x8 matrices of 16-bit elements = four 8-row x 16-byte int8 blocks;
// lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
}

__global__ void __launch_bounds__(kThreads, 2)
ffn_int8_gemm_kernel(const int8_t* __restrict__ hq,     // [M, C]
                     const float* __restrict__ hs,      // [M]
                     const int8_t* __restrict__ w,      // [2Fp, C]
                     const float* __restrict__ ws,      // [2Fp]
                     __nv_bfloat16* __restrict__ t_out, // [M, Fp]
                     int* __restrict__ amax,            // [M], float bits, zeroed
                     int M, int C, int Fp) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma group id
  const int t = lane & 3;   // thread in group
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_tiles = C / kBK;

  auto load_stage = [&](int stage, int kt) {
    uint8_t* sA = smem + stage * kStageBytes;
    uint8_t* sB = sA + kBM * kStride;
    const int k0 = kt * kBK;
#pragma unroll
    for (int u = 0; u < kBM * (kBK / 16) / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i >> 2;
      const int c = (i & 3) * 16;
      const int row = m0 + r;
      const bool valid = row < M;  // the ragged last row tile reads zeros
      cp_async16(sA + r * kStride + c, hq + (long long)(valid ? row : 0) * C + k0 + c, valid);
    }
#pragma unroll
    for (int u = 0; u < 2 * kBN * (kBK / 16) / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int r = i >> 2;
      const int c = (i & 3) * 16;
      const int wrow = r < kBN ? n0 + r : Fp + n0 + (r - kBN);
      cp_async16(sB + r * kStride + c, w + (long long)wrow * C + k0 + c);
    }
  };

  int acc_v[2][4][4], acc_g[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[mi][ni][e] = acc_g[mi][ni][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row/column of this lane: A blocks are rows (lane % 16) at
  // byte offset (lane / 16) * 16; B blocks of two 8-row n tiles are rows
  // (lane % 8) + (lane / 16) * 8 at byte offset ((lane / 8) % 2) * 16.
  const int a_row = warp_m * 32 + (lane & 15);
  const int a_col = (lane >> 4) * 16;
  const int b_row = warp_n * 32 + (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in for every thread; stage (kt - 1) % S is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const uint8_t* sA = smem + (kt % kStages) * kStageBytes;
    const uint8_t* sB = sA + kBM * kStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4], bv[4][2], bg[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], sA + (a_row + mi * 16) * kStride + kk + a_col);
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t r[4];
        ldmatrix_x4(r, sB + (b_row + pair * 16) * kStride + kk + b_col);
        bv[2 * pair][0] = r[0];
        bv[2 * pair][1] = r[1];
        bv[2 * pair + 1][0] = r[2];
        bv[2 * pair + 1][1] = r[3];
        ldmatrix_x4(r, sB + (kBN + b_row + pair * 16) * kStride + kk + b_col);
        bg[2 * pair][0] = r[0];
        bg[2 * pair][1] = r[1];
        bg[2 * pair + 1][0] = r[2];
        bg[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc_v[mi][ni], a[mi], bv[ni][0], bv[ni][1]);
          mma_s8(acc_g[mi][ni], a[mi], bg[ni][0], bg[ni][1]);
        }
    }
  }
  cp_async_wait<0>();

  // Epilogue: C fragment element e of (mi, ni) is row g + 8 * (e / 2),
  // column 2t + (e % 2) of that 16 x 8 tile.
  float sv[4][2], sg[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + warp_n * 32 + ni * 8 + 2 * t;
    const float2 a = *reinterpret_cast<const float2*>(ws + col);
    const float2 b = *reinterpret_cast<const float2*>(ws + Fp + col);
    sv[ni][0] = a.x;
    sv[ni][1] = a.y;
    sg[ni][0] = b.x;
    sg[ni][1] = b.y;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp_m * 32 + mi * 16 + g + half * 8;
      const bool in = row < M;
      const float h = in ? hs[row] : 0.f;
      float row_max = 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float tt[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc_v[mi][ni][half * 2 + e]), h), sv[ni][e]);
          const float gg = __fmul_rn(__fmul_rn(__int2float_rn(acc_g[mi][ni][half * 2 + e]), h), sg[ni][e]);
          tt[e] = __fmul_rn(silu(gg), v);
          row_max = fmaxf(row_max, fabsf(tt[e]));
        }
        if (in) {
          const int col = n0 + warp_n * 32 + ni * 8 + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(t_out + (long long)row * Fp + col) =
              __floats2bfloat162_rn(tt[0], tt[1]);
        }
      }
      row_max = fmaxf(row_max, __shfl_xor_sync(kFull, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(kFull, row_max, 2));
      if (in && t == 0) atomicMax(amax + row, __float_as_int(row_max));
    }
  }
}

// One thread per 8 columns of t: q = clip(rint(t * rcp)), rcp = 1 / scale.
__global__ void __launch_bounds__(kQuantThreads)
ffn_int8_quant_kernel(const __nv_bfloat16* __restrict__ t_in, const int* __restrict__ amax,
                      int8_t* __restrict__ q, float* __restrict__ t_scale, int M, int Fp) {
  const int chunks = Fp / 8;
  const long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
  if (i >= (long long)M * chunks) return;
  const long long row = i / chunks;
  const float scale = fmaxf(__fdiv_rn(__int_as_float(amax[row]), 127.f), 1e-12f);
  const float rcp = __fdiv_rn(1.f, scale);
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(t_in) + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    const float q0 = fminf(fmaxf(rintf(__fmul_rn(p.x, rcp)), -127.f), 127.f);
    const float q1 = fminf(fmaxf(rintf(__fmul_rn(p.y, rcp)), -127.f), 127.f);
    out[j / 2] |= ((uint32_t)(uint8_t)(int8_t)q0 | (uint32_t)(uint8_t)(int8_t)q1 << 8) << (16 * (j % 2));
  }
  reinterpret_cast<uint2*>(q)[i] = make_uint2(out[0], out[1]);
  if (i % chunks == 0) t_scale[row] = scale;
}

}  // namespace

extern "C" {

// hq [M, C] int8; hs [M] f32; w [2Fp, C] int8 (v rows, then g rows); ws
// [2Fp] f32; t [M, Fp] bf16 workspace; amax [M] int32, zeroed; q [M, Fp]
// int8; t_scale [M] f32. C a multiple of 64, Fp of 64. Returns the
// cudaError_t of the launches (0 = success).
int vitok_ffn_int8(const void* hq, const void* hs, const void* w, const void* ws, void* t,
                   void* amax, void* q, void* t_scale, int M, int C, int Fp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  if (C % kBK || Fp % kBN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Fp / kBN, (M + kBM - 1) / kBM);
  ffn_int8_gemm_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<__nv_bfloat16*>(t), static_cast<int*>(amax), M, C, Fp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)M * (Fp / 8);
  ffn_int8_quant_kernel<<<(unsigned)((n + kQuantThreads - 1) / kQuantThreads), kQuantThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(t), static_cast<const int*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(t_scale), M, Fp);
  return (int)cudaGetLastError();
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
