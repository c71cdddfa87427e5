// An attention kernel of the JAX project's A/B experiments
// (benchmarks/ab_q8_input.py) as a Hopper kernel around the mma.sync body of
// the fused forward (attend_tile, fused_attend.cuh). The other A/B kernels
// run on the walkers: #10, #11 and #13 in bf16 on the wgmma body
// (fused_attention_ab_sm90.cu), in fp32 on the fp32 walker
// (fused_attention_ab_f32_sm90.cu). The kernel here computes the function of
// the mma.sync forward (fused_attention.cu; TPU _fused_kernel) on its own
// input, so its result on a row is the bits that forward writes there.
//
// * fused_attention_q8in_kernel replaces benchmarks/ab_q8_input.py
//   _kernel_q8in: the input is int8 QKV codes [B, N, 3C] and a per-token fp32
//   scale [B, N, 1]. q and k are normed as raw codes (exact in bf16; the
//   RMSNorm cancels the scale up to eps), v is bf16(code * scale), converted
//   from 16-byte loads of codes on the way into shared memory. Its result is
//   the forward's on the assembled bf16 tensor [q codes | k codes | v * scale],
//   bit for bit. bf16 out, as in JAX. One block per (64-query tile, head,
//   sample).
//
// What bounds it on an H100: the forward's work with 3C + 4 bytes a token
// read instead of 6C, against 4 * B * H * N^2 * d products. At the recorded
// shape (C = 3072, d = 128, N = 256, B = 64) that is bytes: 0.075 ms. Like
// the mma.sync forward it recomputes each K tile's norm per query tile and
// overlaps only a tile's V copy with its K norm, so it is not near its bound.
//
// Build: as fused_attention.cu (vitok_torch/ops/_build.py); a plain C entry
// point bound with ctypes, asynchronous on the caller's stream, returning
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend.cuh"

namespace {

// The cells of one block: heads [h0, h0 + nh) of sample b's 64-query tile
// blockIdx.x.
template <int D, typename T, typename Src>
__device__ __forceinline__ void walk_cells(
    unsigned char* smem, int* sKvEnd, const Src* __restrict__ qkv, const float* __restrict__ tok_scale,
    const float* __restrict__ q_scale, const float* __restrict__ k_scale,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int N, int H, int b,
    int h0, int nh, int sw, float score_scale) {
  using S = Smem<D, T>;
  const int q0 = blockIdx.x * kTile;
  const int C = H * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  block_setup<D>(q_scale, k_scale, mask_b, N, reinterpret_cast<float*>(smem + S::kGainQ),
                 reinterpret_cast<float*>(smem + S::kGainK), sKvEnd, threadIdx.x);
  for (int hl = 0; hl < nh; ++hl)
    attend_tile<D>(smem, sKvEnd, qkv + (long long)b * N * 3 * C, cos_t + (long long)b * N * (D / 2),
                   sin_t + (long long)b * N * (D / 2), mask_b, q0, h0 + hl, N, H, sw, score_scale,
                   out + ((long long)b * N + q0) * C + (h0 + hl) * D, C,
                   tok_scale ? tok_scale + (long long)b * N : nullptr);
}

// grid (N / 64, H, B)
template <int D>
__global__ void __launch_bounds__(kThreads)
fused_attention_q8in_kernel(const int8_t* __restrict__ qkv8, const float* __restrict__ tok_scale,
                            const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                            const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                            int N, int H, int sw, float score_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  walk_cells<D, __nv_bfloat16, int8_t>(smem, &sKvEnd, qkv8, tok_scale, q_scale, k_scale, cos_t, sin_t,
                                       mask, out, N, H, blockIdx.z, blockIdx.y, 1, sw, score_scale);
}

// (1 / sqrt(d)) * log2(e), rounded once to fp32 as the forward's launch does.
template <int D>
float score_scale() {
  return (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_q8in(const void* qkv8, const void* tok, const void* qs, const void* ks,
                        const void* cos_t, const void* sin_t, const void* mask, void* out, int B, int N,
                        int H, int sw, cudaStream_t s) {
  return launch(fused_attention_q8in_kernel<D>, Smem<D>::kBytes, dim3((N + kTile - 1) / kTile, H, B), s,
                static_cast<const int8_t*>(qkv8), static_cast<const float*>(tok),
                static_cast<const float*>(qs), static_cast<const float*>(ks),
                static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                static_cast<const unsigned char*>(mask), static_cast<__nv_bfloat16*>(out), N, H, sw,
                score_scale<D>());
}

}  // namespace

extern "C" {

// qkv8 [B, N, 3*H*D] int8 codes; tok_scale [B, N] f32; q_scale, k_scale [D]
// f32; cos, sin [B, N, D/2] f32; mask [B, N] bool bytes or null; out [B, N,
// H*D] bf16. One block per (64-query tile, head, sample); sw < 0: no window.
int vitok_fused_attention_q8in(const void* qkv8, const void* tok_scale, const void* q_scale,
                               const void* k_scale, const void* cos_t, const void* sin_t,
                               const void* mask, void* out, int B, int N, int H, int D, int sw,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_q8in<64>(qkv8, tok_scale, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  if (D == 128) return launch_q8in<128>(qkv8, tok_scale, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
