// Fused QK-RMSNorm + rotate-half 2D RoPE + masked (optionally sliding-window)
// attention, read straight from the flat [B, N, 3C] QKV projection output:
// the mma.sync family of the forward. The bf16 main path runs the Hopper
// redesign in fused_attention_sm90.cu (same function and rounding points),
// the fp32 main path the fp32 walker (fused_attention_ab_f32_sm90.cu); this
// file keeps the mma.sync kernels built:
//   * vitok_fused_attention_mma_bf16, the mma.sync bf16 forward: arm B of the
//     A/B entry points (vitok_torch/benchmarks), and the reference the int8
//     epilogue below is held to bit for bit (both run attend_tile);
//   * vitok_fused_attention_f32, the fp32 instance (the TPU kernel's f32 case
//     on FMA products): arm B of the fp32 A/B legs and the closest fp32
//     reference to the plain version;
//   * vitok_fused_attention_q8_bf16, the int8-epilogue kernel.
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
// The body (attend_tile) lives in fused_attend.cuh, shared with the A/B
// kernels of fused_attention_ab.cu. fused_attention_q8_kernel further down
// runs it and quantizes the result per token to int8 before it leaves the
// chip (it replaces _fused_kernel_q8). The fp32 instance of
// fused_attention_kernel (vitok_fused_attention_f32) is the TPU kernel's f32
// case: fp32 norm and rotation, fp32 FMA products (no tensor cores, no tf32),
// P kept in fp32; it is bound by its 4-byte reads at N <= 256 and by the
// FMA rate (67 TFLOP/s) above.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// The int8-epilogue instance: replaces the TPU kernel
// vitok_tpu/ops/fused_attention.py::_fused_kernel_q8. The attention is
// attend_tile above, so each bf16 value is the bits fused_attention_kernel
// would have written; the epilogue is quantize_activation over the full C
// channels of a token: scale = max(absmax / 127, 1e-12) (IEEE division),
// code = clip(rint(x / scale), -127, 127). The bf16 result never reaches
// device memory.
//
// The absmax runs over every head of a row. The TPU revisits a VMEM scratch
// across its sequential head-group axis; here the heads of a (64-query tile,
// sample) are shared out over a thread block cluster of `cs` blocks along
// grid y (cs divides H, at most 8). Each block loops over its H / cs heads
// and keeps its [64, (H / cs) * D] bf16 slab in shared memory, takes its own
// row maxima, and reads the other blocks' maxima through distributed shared
// memory between two cluster barriers; then each quantizes its slab and
// rank 0 writes the scales.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int D>
struct SmemQ8 {
  static constexpr size_t kSlab = (Smem<D>::kBytes + 15) / 16 * 16;  // then [64, W + 8] bf16
  __host__ __device__ static size_t row_max(int W) { return kSlab + sizeof(__nv_bfloat16) * kTile * (W + kPad); }
  __host__ __device__ static size_t bytes(int W) { return row_max(W) + sizeof(float) * kTile; }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_attention_q8_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const float* __restrict__ q_scale,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          const unsigned char* __restrict__ mask,  // [B, N] or null
                          int8_t* __restrict__ out_q,              // [B, N, C]
                          float* __restrict__ out_scale,           // [B, N]
                          int N, int H, int heads_per_block,
                          int sw,  // < 0: no window
                          float score_scale) {
  namespace cg = cooperative_groups;
  using S = Smem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sKvEnd;
  const int W = heads_per_block * D;   // this block's slab of channels
  const int slab_row = W + kPad;
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem + SmemQ8<D>::kSlab);
  float* sRowMax = reinterpret_cast<float*>(smem + SmemQ8<D>::row_max(W));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y * heads_per_block;
  const int b = blockIdx.z;
  const int C = H * D;
  const unsigned char* mask_b = mask ? mask + (long long)b * N : nullptr;
  const __nv_bfloat16* qkv_b = qkv + (long long)b * N * 3 * C;
  const float* cos_b = cos_t + (long long)b * N * (D / 2);
  const float* sin_b = sin_t + (long long)b * N * (D / 2);

  block_setup<D>(q_scale, k_scale, mask_b, N, reinterpret_cast<float*>(smem + S::kGainQ),
                 reinterpret_cast<float*>(smem + S::kGainK), &sKvEnd, tid);
  for (int hl = 0; hl < heads_per_block; ++hl)
    attend_tile<D>(smem, &sKvEnd, qkv_b, cos_b, sin_b, mask_b, q0, h0 + hl, N, H, sw, score_scale,
                   sO + hl * D, slab_row);
  __syncthreads();

  // Row maxima of this block's slab: warp w takes rows w, w + 4, ...
  const int chunks = W / 8;
  for (int r = warp; r < kTile; r += kWarps) {
    float amax = 0.f;
    if (q0 + r < N) {
      for (int ch = lane; ch < chunks; ch += 32) {
        const uint4 u = *reinterpret_cast<const uint4*>(sO + r * slab_row + ch * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
    amax = warp_max(amax);
    if (lane == 0) sRowMax[r] = amax;
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's maxima are written
  const unsigned ranks = cluster.num_blocks();
  for (int r = warp; r < kTile; r += kWarps) {
    const int n = q0 + r;
    if (n >= N) continue;
    float amax = 0.f;
    for (unsigned k = 0; k < ranks; ++k) amax = fmaxf(amax, cluster.map_shared_rank(sRowMax, k)[r]);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    int8_t* dst = out_q + ((long long)b * N + n) * C + h0 * D;
    for (int ch = lane; ch < chunks; ch += 32) {
      const uint4 u = *reinterpret_cast<const uint4*>(sO + r * slab_row + ch * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const float qx = fminf(fmaxf(rintf(__fdiv_rn(f.x, scale)), -127.f), 127.f);
        const float qy = fminf(fmaxf(rintf(__fdiv_rn(f.y, scale)), -127.f), 127.f);
        w[e >> 1] |= (uint32_t)(uint8_t)(int8_t)qx << (16 * (e & 1));
        w[e >> 1] |= (uint32_t)(uint8_t)(int8_t)qy << (16 * (e & 1) + 8);
      }
      *reinterpret_cast<uint2*>(dst + ch * 8) = make_uint2(w[0], w[1]);
    }
    if (lane == 0 && cluster.block_rank() == 0) out_scale[(long long)b * N + n] = scale;
  }
  cluster.sync();  // no block leaves while another may still read its maxima
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

template <int D>
cudaError_t launch_q8(const void* qkv, const void* q_scale, const void* k_scale,
                      const void* cos_t, const void* sin_t, const void* mask, void* out_q,
                      void* out_scale, int B, int N, int H, int cs, int sw, cudaStream_t stream) {
  if (cs < 1 || cs > 8 || H % cs) return cudaErrorInvalidValue;
  const int heads_per_block = H / cs;
  const size_t smem = SmemQ8<D>::bytes(heads_per_block * D);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_q8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float score_scale = (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kTile - 1) / kTile, cs, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, fused_attention_q8_kernel<D>, static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const unsigned char*>(mask), static_cast<int8_t*>(out_q),
      static_cast<float*>(out_scale), N, H, heads_per_block, sw, score_scale);
  if (err != cudaSuccess) return err;
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

// As vitok_fused_attention_mma_bf16, with the per-token int8 quantize over all
// H*D channels as the epilogue: out_q [B, N, H*D] int8, out_scale [B, N] f32.
// `cs` blocks of a cluster share a row's heads (cs divides H, 1 <= cs <= 8,
// and 64 * (H / cs * D + 8) * 2 bytes of slab must fit beside the tiles).
int vitok_fused_attention_q8_bf16(const void* qkv, const void* q_scale, const void* k_scale,
                                  const void* cos_t, const void* sin_t, const void* mask,
                                  void* out_q, void* out_scale, int B, int N, int H, int D,
                                  int cs, int sw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_q8<64>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H,
                         cs, sw, s);
  if (D == 128)
    return launch_q8<128>(qkv, q_scale, k_scale, cos_t, sin_t, mask, out_q, out_scale, B, N, H,
                          cs, sw, s);
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
