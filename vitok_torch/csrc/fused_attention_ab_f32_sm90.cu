// The fp32 walker's kernels (fused_attend_f32_sm90.cuh): the fused
// attention's fp32 function with its products on the tensor cores at fp32
// accuracy, a block that walks many cells. One library for the main path's
// fp32 forward (vitok_torch/ops/fused_attention.py loads it) and for three
// A/B kernels of the JAX project in fp32 (vitok_torch/benchmarks).
//
// * fused_attention_f32_sm90_kernel replaces vitok_tpu/ops/fused_attention.py
//   _fused_kernel on f32 (one TPU grid cell per sample and head group): a
//   block takes its 64-query tile of bb images x hpb heads with the window,
//   the split chosen by the wrapper (fused_attention.f32_walk_split). Its
//   kLse instance, the forward under autograd, also writes each row's
//   log-sum-exp for the fp32 backward (#3, flash_attention_f32.cu), as
//   _fused_op_fwd hands _fused_kernel's to the VJP.
// * fused_attention_bb_f32_sm90_kernel replaces benchmarks/ab_batch_block.py
//   _kernel_bb (a TPU grid cell takes `bb` batch items x `cg` channels in a
//   static loop): the same walk, the split given by the arm.
// * fused_attention_pack_f32_sm90_kernel replaces _kernel_pack: `bb` images
//   packed along the token axis of one [bb*N, bb*N] score tile, cross-image
//   and masked keys filled with -1e30, no window. A row with a valid key
//   walks only its own image's tiles (the cross-image keys add exact zeros);
//   a row of an image with no valid key averages v over all bb*N keys of the
//   pack, and only its cell walks the other images' V tiles.
// * fused_attention_contig_f32_sm90_kernel replaces benchmarks/ab_q8_input.py
//   _kernel_contig on f32 (a TPU grid cell takes one sample's tokens over all
//   heads): a block takes its query tile of one image x all H heads.
// A cell's result does not depend on the block it runs in, so every split of
// any of them gives a row the bits of the one-cell-a-block split (bb = 1,
// hpb = 1), and the pack does on images with a valid key.
//
// What bounds them on an H100: qkv read and out written, 16C bytes a token,
// against 4 * B * H * N^2 * d products, each six bf16 products on the tensor
// cores (989 TFLOP/s): at the recorded fp32 A/B shape (C 3072, d 128, N 64,
// B 256) bytes, 0.2429 ms; at the 350M width (d 64, N 256) the products.
// The FMA body these replace (fused_attend.cuh, kept as the mma.sync
// forward's fp32 instance) was neither: its products ran at the CUDA cores'
// rate, and at N = 64, where a cell is one key tile, a block's setup and its
// copies' latency stood in front of each cell. The walker takes a block's
// cells in one walk, its producer warpgroup copying, norming and splitting
// the next step's tiles while its consumer warpgroup runs this step's
// products; the split decides how many steps a block has to overlap.
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

// A consumer and a producer warpgroup a block (217 KB of shared memory at
// d = 128, 108 KB at d = 64; the wide layout 219 KB at d = 256, 171 KB at
// d = 192, every kind). Grid (N / 64, H / hpb, B / bb), or (N / 64, 1, B)
// for the contig kernel; four kernels over one walk (walk_f32: the d 64/128
// layout or the wide one), each with its own name so that a profile tells
// them apart. One block an SM, but the forward's at d = 64 takes two: held
// to 128 registers a thread, so that two blocks' walks interleave on an SM
// (the A/B kernels keep one, and their machine code).
template <int D, bool kLse>
__global__ void __launch_bounds__(kF32Threads, D == 64 ? 2 : 1)
fused_attention_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                float* __restrict__ out, float* __restrict__ lse, int N, int H, int bb, int hpb,
                                int sw, float score_scale) {
  walk_f32<D, kLse>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb,
                    sw, score_scale, false, lse);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_attention_bb_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                   const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, int N, int H, int bb, int hpb, int sw, float score_scale) {
  walk_f32<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb, sw,
              score_scale, false);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_attention_pack_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                     const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                     const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                     float* __restrict__ out, int N, int H, int bb, int hpb, float score_scale) {
  walk_f32<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb, -1,
              score_scale, true);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
fused_attention_contig_f32_sm90_kernel(const float* __restrict__ qkv, const float* __restrict__ q_scale,
                                       const float* __restrict__ k_scale, const float* __restrict__ cos_t,
                                       const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                       float* __restrict__ out, int N, int H, int sw, float score_scale) {
  walk_f32<D>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z, 1, 0, H, sw, score_scale, false);
}

// The kernels by the kind the C entries take.
enum Kind { kForward = 0, kBatchBlock = 1, kPack = 2, kContig = 3 };

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
                        const void* sin_t, const void* mask, void* out, void* lse, int B, int N, int H, int bb,
                        int hpb, int sw, int kind, cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, H / hpb, B / bb);
  const size_t smem = walk_f32_smem_bytes<D>(bb);
  const auto* q = static_cast<const float*>(qkv);
  const auto* gq = static_cast<const float*>(q_scale);
  const auto* gk = static_cast<const float*>(k_scale);
  const auto* c = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* o = static_cast<float*>(out);
  switch (kind) {
    case kForward:
      if (lse != nullptr)
        return launch(fused_attention_f32_sm90_kernel<D, true>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o,
                      static_cast<float*>(lse), N, H, bb, hpb, sw, score_scale<D>());
      return launch(fused_attention_f32_sm90_kernel<D, false>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o,
                    static_cast<float*>(nullptr), N, H, bb, hpb, sw, score_scale<D>());
    case kBatchBlock:
      return launch(fused_attention_bb_f32_sm90_kernel<D>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o, N, H,
                    bb, hpb, sw, score_scale<D>());
    case kPack:
      return launch(fused_attention_pack_f32_sm90_kernel<D>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o, N,
                    H, bb, hpb, score_scale<D>());
    case kContig:
      return launch(fused_attention_contig_f32_sm90_kernel<D>, smem, grid, kF32Threads, s, q, gq, gk, c, sn, m, o, N,
                    H, sw, score_scale<D>());
  }
  return cudaErrorInvalidValue;
}

template <typename Kernel>
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

template <int D>
cudaError_t kind_attributes(int kind, int bb, bool lse, int* out) {
  const size_t smem = walk_f32_smem_bytes<D>(bb);
  switch (kind) {
    case kForward:
      return lse ? attributes(fused_attention_f32_sm90_kernel<D, true>, smem, out)
                 : attributes(fused_attention_f32_sm90_kernel<D, false>, smem, out);
    case kBatchBlock: return attributes(fused_attention_bb_f32_sm90_kernel<D>, smem, out);
    case kPack: return attributes(fused_attention_pack_f32_sm90_kernel<D>, smem, out);
    case kContig: return attributes(fused_attention_contig_f32_sm90_kernel<D>, smem, out);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qkv [B, N, 3*H*D] f32 (q and k normed here, v read); q_scale, k_scale [D]
// f32; cos, sin [B, N, D/2] f32; mask [B, N] bool bytes or null; out [B, N,
// H*D] f32. A block takes its query tile of bb images x hpb heads (bb
// divides B, hpb divides H), each image its own softmax with window sw (< 0:
// none), on the kernel of `kind`: 0 the forward (#1), 1 the batch block
// (#10), 2 the pack (#11: the bb images are one pack, no window), 3 contig
// (#13: bb = 1, hpb = H). lse [B, H, N] f32 or null: with the forward
// (kind 0) its instance that also writes each row's log-sum-exp in log2
// units (1e30 on a padded query row), for the backward; the other kinds
// take null. D is 64, 128, 192 or 256 (at 192 and 256 every kind on the
// wide layout of fused_attend_f32_sm90.cuh).
int vitok_fused_attention_walk_f32(const void* qkv, const void* q_scale, const void* k_scale, const void* cos_t,
                                   const void* sin_t, const void* mask, void* out, void* lse, int B, int N, int H,
                                   int D, int bb, int hpb, int sw, int kind, void* stream) {
  if (bb < 1 || hpb < 1 || B % bb || H % hpb || kind < kForward || kind > kContig || (kind == kPack && sw >= 0) ||
      (kind == kContig && (bb != 1 || hpb != H)) || (lse != nullptr && kind != kForward))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    return launch_walk<decltype(d)::value>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out, lse, B, N, H, bb, hpb, sw,
                                           kind, s);
  });
}

// What the compiler and the card make of one instance (`kind` as above; bb
// images a block; lse != 0: the forward's log-sum-exp instance): out[0]
// registers a thread, out[1] local memory a thread in bytes (spills), out[2]
// blocks an SM, out[3] dynamic shared memory a block in bytes.
int vitok_fused_attention_walk_f32_attributes(int D, int kind, int bb, int lse, int* out) {
  if (bb < 1 || kind < kForward || kind > kContig || (lse && kind != kForward)) return (int)cudaErrorInvalidValue;
  return (int)with_head_dim(D, [&](auto d) { return kind_attributes<decltype(d)::value>(kind, bb, lse != 0, out); });
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
