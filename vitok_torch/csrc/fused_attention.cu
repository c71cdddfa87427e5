// Fused QK-RMSNorm + rotate-half 2D RoPE + masked (optionally sliding-window)
// attention, read straight from the flat [B, N, 3C] QKV projection output:
// the mma.sync family of the forward. The bf16 main path runs the Hopper
// redesign in fused_attention_sm90.cu (same function and rounding points),
// the fp32 main path the fp32 walker (fused_attention_ab_f32_sm90.cu), and
// the int8 epilogue the redesigned body (fused_attention_sm90.cu); this file
// keeps the mma.sync kernels built:
//   * vitok_fused_attention_mma_bf16, the mma.sync bf16 forward: arm B of the
//     A/B entry points (vitok_torch/benchmarks);
//   * vitok_fused_attention_f32, the fp32 instance (the TPU kernel's f32 case
//     on FMA products): arm B of the fp32 A/B legs and the closest fp32
//     reference to the plain version.
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
// The body (attend_tile) lives in fused_attend.cuh. The fp32 instance of
// fused_attention_kernel (vitok_fused_attention_f32) is the TPU kernel's f32
// case: fp32 norm and rotation, fp32 FMA products (no tensor cores, no tf32),
// P kept in fp32; it is bound by its 4-byte reads at N <= 256 and by the
// FMA rate (67 TFLOP/s) above.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend.cuh"

namespace {

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ q_scale,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       const unsigned char* __restrict__ mask,  // [B, N] or null
                       T* __restrict__ out, int N, int H,
                       int sw,  // < 0: no window
                       float score_scale) {
  using S = Smem<D, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  block_setup<D>(q_scale, k_scale, mask_b, N, reinterpret_cast<float*>(smem + S::kGainQ),
                 reinterpret_cast<float*>(smem + S::kGainK), &sKvEnd, threadIdx.x);
  attend_tile<D>(smem, &sKvEnd, qkv + (long long)b * N * 3 * C, cos_t + (long long)b * N * (D / 2),
                 sin_t + (long long)b * N * (D / 2), mask_b, q0, h, N, H, sw, score_scale,
                 out + ((long long)b * N + q0) * C + h * D, C);
}

template <int D, typename T>
cudaError_t launch(const void* qkv, const void* q_scale, const void* k_scale,
                   const void* cos_t, const void* sin_t, const void* mask,
                   void* out, int B, int N, int H, int sw, cudaStream_t stream) {
  const size_t smem = Smem<D, T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  fused_attention_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
      static_cast<T*>(out), N, H, sw, score_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] bf16; q_scale, k_scale [D] f32; cos, sin [B, N, D/2] f32;
// mask [B, N] bool bytes or null; out [B, N, H*D] bf16. sw < 0: no window.
// Returns the cudaError_t of the launch (0 = success).
int vitok_fused_attention_mma_bf16(const void* qkv, const void* q_scale,
                                   const void* k_scale, const void* cos_t,
                                   const void* sin_t, const void* mask, void* out,
                                   int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64, __nv_bfloat16>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  if (D == 128)
    return launch<128, __nv_bfloat16>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// The fp32 instance: qkv and out fp32, the other arguments as above.
int vitok_fused_attention_f32(const void* qkv, const void* q_scale,
                              const void* k_scale, const void* cos_t,
                              const void* sin_t, const void* mask, void* out,
                              int B, int N, int H, int D, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  if (D == 128) return launch<128, float>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
