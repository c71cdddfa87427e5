// Fused fp32 RMSNorm x gain + per-token dynamic symmetric int8 quantize.
//
// Replaces the TPU kernel vitok_tpu/ops/quant.py::_rmsnorm_quant_kernel
// (launcher fused_rmsnorm_quant). Same function, op for op:
//   x32 = float(x); var = float(sum(x32 * x32) / C); r = 1 / sqrt(var + eps);
//   y = (x32 * r) * gain; scale = max(absmax(y) / 127, 1e-12);
//   q = clip(rint(y / scale), -127, 127)   (division, round half to even).
// The sum of squares is taken in fp64, where it is exact for these inputs
// whatever the order, and rounded once to fp32; the square root and the
// divisions are IEEE. The plain version (fused_rmsnorm_quant_plain) does the
// same, so the two give the same codes: in a 28-block int8 model, one code
// in a million off by a step moves the output by a few percent. Against
// the TPU kernel's fp32 sum a code may differ by one step where y / scale
// lies within an ulp of a half.
//
// What bounds it on an H100: bytes. It reads the bf16 row once and writes
// the int8 row and one fp32 scale: at M = 16384 tokens, C = 1024, 50.4 MB,
// about 0.015 ms at 3.35 TB/s; the arithmetic is a few flops per byte.
// The fp64 sum costs C double additions a row, far below the bytes' time.
// The design keeps each row in registers between the two reductions, so x
// is read from device memory once: one block of 128 threads per token row,
// each thread one or more 16-byte chunks of 8 channels (loaded together),
// a warp-shuffle + shared-memory sum of squares, then a second such
// reduction for the absmax, and 8-byte int8 stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one block per row (vitok_torch/ops/quant.py _NORM_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint32_t pack4_s8(const float* y, float scale) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(y[i], scale)), -127.f), 127.f);
    out |= (uint32_t)(uint8_t)(int8_t)q << (8 * i);
  }
  return out;
}

// kPer: 8-channel chunks per thread (C <= kPer * 8 * kThreads).
template <int kPer>
__global__ void __launch_bounds__(kThreads)
rmsnorm_quant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gain,
                     int8_t* __restrict__ q, float* __restrict__ scale_out, int C, float eps) {
  __shared__ double red_sum[kWarps];
  __shared__ float red_max[kWarps];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row = blockIdx.x;
  const int chunks = C / 8;
  const __nv_bfloat16* xr = x + row * C;

  uint4 xv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = tid + i * kThreads;
    xv[i] = make_uint4(0, 0, 0, 0);
    if (ch < chunks) xv[i] = __ldg(reinterpret_cast<const uint4*>(xr) + ch);
  }

  double ss = 0.0;  // exact: squares of bf16 values, summed well inside fp64's range
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float f[8];
    unpack8(xv[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += (double)f[e] * (double)f[e];
  }
  ss = warp_sum(ss);
  if (lane == 0) red_sum[warp] = ss;
  __syncthreads();
  double total = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red_sum[w];
  const float var = __double2float_rn(total / (double)C);
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = tid + i * kThreads;
    if (ch < chunks) {
      float f[8];
      unpack8(xv[i], f);
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gain) + 2 * ch);
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(gain) + 2 * ch + 1);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(__fmul_rn(__fmul_rn(f[e], r), g[e])));
    }
  }
  amax = warp_max(amax);
  if (lane == 0) red_max[warp] = amax;
  __syncthreads();
  amax = red_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red_max[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = tid + i * kThreads;
    if (ch < chunks) {
      float f[8];
      unpack8(xv[i], f);
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(gain) + 2 * ch);
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(gain) + 2 * ch + 1);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = __fmul_rn(__fmul_rn(f[e], r), g[e]);
      uint2 out;
      out.x = pack4_s8(y, scale);
      out.y = pack4_s8(y + 4, scale);
      reinterpret_cast<uint2*>(q + row * C)[ch] = out;
    }
  }
  if (tid == 0) scale_out[row] = scale;
}

template <int kPer>
cudaError_t launch(const void* x, const void* gain, void* q, void* scale, int rows, int C,
                   float eps, cudaStream_t stream) {
  rmsnorm_quant_kernel<kPer><<<rows, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gain),
      static_cast<int8_t*>(q), static_cast<float*>(scale), C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, C] bf16 (16-byte aligned); gain [C] f32; q [rows, C] int8;
// scale [rows] f32. C a multiple of 8, at most 8 * 8 * 128. Returns the
// cudaError_t of the launch (0 = success).
int vitok_rmsnorm_quant_bf16(const void* x, const void* gain, void* q, void* scale, int rows,
                             int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  const int per = (C / 8 + kThreads - 1) / kThreads;
  if (C % 8 || per > 8) return (int)cudaErrorInvalidValue;
  if (per <= 1) return launch<1>(x, gain, q, scale, rows, C, eps, s);
  if (per <= 2) return launch<2>(x, gain, q, scale, rows, C, eps, s);
  if (per <= 4) return launch<4>(x, gain, q, scale, rows, C, eps, s);
  return launch<8>(x, gain, q, scale, rows, C, eps, s);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
