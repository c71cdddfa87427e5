// Two A/B attention kernels of the JAX project in fp32, on the fp32 walker
// (fused_attend_f32_sm90.cuh): products on the tensor cores at fp32
// accuracy, a block that walks many cells.
//
// * fused_attention_bb_f32_sm90_kernel replaces benchmarks/ab_batch_block.py
//   _kernel_bb (a TPU grid cell takes `bb` batch items x `cg` channels in a
//   static loop): a block takes its 64-query tile of bb images x hpb heads,
//   each image its own softmax, with the window.
// * fused_attention_pack_f32_sm90_kernel replaces _kernel_pack: `bb` images
//   packed along the token axis of one [bb*N, bb*N] score tile, cross-image
//   and masked keys filled with -1e30, no window. A row with a valid key
//   walks only its own image's tiles (the cross-image keys add exact zeros);
//   a row of an image with no valid key averages v over all bb*N keys of the
//   pack, and only its cell walks the other images' V tiles.
// A cell's result does not depend on the block it runs in, so every split of
// either kernel gives a row the bits of the one-cell-a-block split (bb = 1,
// hpb = 1), and the pack does on images with a valid key.
//
// What bounds them on an H100: bytes, as for the fp32 forward: qkv read and
// out written, 16C bytes a token, against 4 * B * H * N^2 * d products (six
// bf16 products each on the tensor cores, 989 TFLOP/s): at the recorded fp32
// A/B shape (C 3072, d 128, N 64, B 256) 0.2429 ms. The FMA body these
// replace (fused_attend.cuh) was neither: its products ran at the CUDA
// cores' rate, and at N = 64, where a cell is one key tile, a block's setup
// and its copies' latency stood in front of each cell. The walker takes a
// block's cells in one walk, its producer warpgroup copying, norming and
// splitting the next step's tiles while its consumer warpgroup runs this
// step's products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; asynchronous on the caller's stream, each returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend_f32_sm90.cuh"

namespace {

// One block an SM: a consumer and a producer warpgroup (217 KB of shared
// memory at d = 128, 108 KB at d = 64).
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_attention_bb_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                   const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, int N, int H, int bb, int hpb, int sw, float score_scale) {
  walk_cells_f32<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb,
                    sw, score_scale, false);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_attention_pack_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                     const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                     const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                     float* __restrict__ out, int N, int H, int bb, int hpb, float score_scale) {
  walk_cells_f32<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb,
                    -1, score_scale, true);
}

// (1 / sqrt(d)) * log2(e), rounded once to fp32 as the forward's launch does.
template <int D>
float score_scale() {
  return (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads, cudaStream_t stream, Args... args) {
  if (smem > 232448) return cudaErrorInvalidValue;  // the most a block may have on sm_90
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_walk(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                        const void* sin_t, const void* mask, void* out, int B, int N, int H, int bb, int hpb, int sw,
                        bool pack, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, H / hpb, B / bb);
  const size_t smem = WalkSmemF32<D>::bytes(bb);
  const auto* q = static_cast<const float*>(qkv);
  const auto* gq = static_cast<const float*>(q_scale);
  const auto* gk = static_cast<const float*>(k_scale);
  const auto* c = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* o = static_cast<float*>(out);
  if (pack)
    return launch(fused_attention_pack_f32_sm90_kernel<D>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o, N,
                  H, bb, hpb, score_scale<D>());
  return launch(fused_attention_bb_f32_sm90_kernel<D>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o, N, H,
                bb, hpb, sw, score_scale<D>());
}

template <int D, typename Kernel>
cudaError_t attributes(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kF32Threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] f32 (q and k normed here, v read); q_scale, k_scale [D]
// f32; cos, sin [B, N, D/2] f32; mask [B, N] bool bytes or null; out [B, N,
// H*D] f32. A block takes its query tile of bb images x hpb heads (bb
// divides B, hpb divides H): with pack != 0 the bb images are one pack (no
// window: sw < 0), else each its own softmax with window sw (< 0: none).
int vitok_fused_attention_walk_f32(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                   const void* sin_t, const void* mask, void* out, int B, int N, int H, int D, int bb,
                                   int hpb, int sw, int pack, void* stream) {
  if (bb < 1 || hpb < 1 || B % bb || H % hpb || (pack && sw >= 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_walk<64>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, sw, pack, s);
  if (D == 128)
    return launch_walk<128>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, sw, pack, s);
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the card make of one instance (pack != 0: the pack
// kernel, else the batch-block one; bb images a block): out[0] registers a
// thread, out[1] local memory a thread in bytes (spills), out[2] blocks an
// SM, out[3] dynamic shared memory a block in bytes.
int vitok_fused_attention_ab_f32_sm90_attributes(int D, int pack, int bb, int* out) {
  if (bb < 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return pack ? attributes<64>(fused_attention_pack_f32_sm90_kernel<64>, WalkSmemF32<64>::bytes(bb), out)
                : attributes<64>(fused_attention_bb_f32_sm90_kernel<64>, WalkSmemF32<64>::bytes(bb), out);
  if (D == 128)
    return pack ? attributes<128>(fused_attention_pack_f32_sm90_kernel<128>, WalkSmemF32<128>::bytes(bb), out)
                : attributes<128>(fused_attention_bb_f32_sm90_kernel<128>, WalkSmemF32<128>::bytes(bb), out);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
