// Fused SwiGLU gate + per-token dynamic symmetric int8 quantize over the
// bf16 fc1 output [M, 2F'] (v in channels [0, F'), g in [F', 2F')).
//
// Replaces the TPU kernel vitok_tpu/ops/quant.py::_silu_quant_kernel
// (launcher fused_silu_quant). Same function, op for op:
//   v, g = float(hid[:F']), float(hid[F':]); t = silu(g) * v   (f32);
//   scale = max(absmax(t) / 127, 1e-12); q = clip(rint(t / scale), -127, 127)
// with the division, as the TPU kernel has it. silu(g) = g * sigmoid(g)
// (jax.nn.silu's definition), sigmoid as PyTorch's CUDA kernel computes it,
// 1 / (1 + exp(-g)) in IEEE fp32 ops (expf, not the fast __expf), so the
// plain version (fused_silu_quant_plain) gives the same codes.
//
// What bounds it on an H100: bytes. It reads the 2F' bf16 inputs once and
// writes F' int8 codes and one fp32 scale per row: at M = 16384, F' = 2816,
// 230.7 MB, about 0.069 ms at 3.35 TB/s. The design reads each row from
// device memory once: one block of 256 threads per token row, each thread
// holding its 16-byte chunks of v and of g in registers across the block's
// absmax reduction (warp shuffles, then shared memory), recomputing t for
// the quantize pass instead of storing it, and writing int8 with 8-byte
// stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one block per row (vitok_torch/ops/quant.py _SILU_THREADS)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// t = (g * sigmoid(g)) * v for one chunk of 8 channels, in f32.
__device__ __forceinline__ void swiglu8(const uint4& vu, const uint4& gu, float (&t)[8]) {
  float v[8], g[8];
  unpack8(vu, v);
  unpack8(gu, g);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[e])));
    t[e] = __fmul_rn(__fmul_rn(g[e], sig), v[e]);
  }
}

__device__ __forceinline__ uint32_t pack4_s8(const float* t, float scale) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(t[i], scale)), -127.f), 127.f);
    out |= (uint32_t)(uint8_t)(int8_t)q << (8 * i);
  }
  return out;
}

// kPer: 8-channel chunks of each half per thread (F' <= kPer * 8 * kThreads).
template <int kPer>
__global__ void __launch_bounds__(kThreads)
silu_quant_kernel(const __nv_bfloat16* __restrict__ hid, int8_t* __restrict__ q,
                  float* __restrict__ scale_out, int Fp) {
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int chunks = Fp / 8;
  const uint4* vrow = reinterpret_cast<const uint4*>(hid + row * 2 * Fp);
  const uint4* grow = reinterpret_cast<const uint4*>(hid + row * 2 * Fp + Fp);

  uint4 vv[kPer], gg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = tid + i * kThreads;
    vv[i] = gg[i] = make_uint4(0, 0, 0, 0);
    if (ch < chunks) {
      vv[i] = __ldg(vrow + ch);
      gg[i] = __ldg(grow + ch);
    }
  }

  float amax = 0.f;  // zero chunks give t = 0
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float t[8];
    swiglu8(vv[i], gg[i], t);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(t[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, red[w]);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);

  uint2* qrow = reinterpret_cast<uint2*>(q + row * Fp);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = tid + i * kThreads;
    if (ch < chunks) {
      float t[8];
      swiglu8(vv[i], gg[i], t);
      qrow[ch] = make_uint2(pack4_s8(t, scale), pack4_s8(t + 4, scale));
    }
  }
  if (tid == 0) scale_out[row] = scale;
}

template <int kPer>
cudaError_t launch(const void* hid, void* q, void* scale, int rows, int Fp, cudaStream_t stream) {
  silu_quant_kernel<kPer><<<rows, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(hid), static_cast<int8_t*>(q),
      static_cast<float*>(scale), Fp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hid [rows, 2*Fp] bf16 (16-byte aligned); q [rows, Fp] int8; scale [rows]
// f32. Fp a multiple of 8, at most 8 * 8 * 256. Returns the cudaError_t of
// the launch (0 = success).
int vitok_silu_quant_bf16(const void* hid, void* q, void* scale, int rows, int Fp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  const int per = (Fp / 8 + kThreads - 1) / kThreads;
  if (Fp % 8 || per > 8) return (int)cudaErrorInvalidValue;
  if (per <= 1) return launch<1>(hid, q, scale, rows, Fp, s);
  if (per <= 2) return launch<2>(hid, q, scale, rows, Fp, s);
  if (per <= 4) return launch<4>(hid, q, scale, rows, Fp, s);
  return launch<8>(hid, q, scale, rows, Fp, s);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
