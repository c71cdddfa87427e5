// Three A/B attention kernels of the JAX project (benchmarks/ab_batch_block.py
// _kernel_bb and _kernel_pack, benchmarks/ab_q8_input.py _kernel_contig) in
// bf16, on the wgmma body of the main path's forward (fused_attend_sm90.cuh),
// with a block that walks many cells on one tile ring. Their fp32 instances
// run on the fp32 walker (fused_attention_ab_f32_sm90.cu).
//
// * fused_attention_contig_sm90_kernel replaces _kernel_contig: a block per
//   (64-query tile, sample) takes all H heads of its tile, the arm's split
//   (the TPU arm reads a sample's whole [N, 3C] rows as one region).
// * fused_attention_bb_sm90_kernel replaces _kernel_bb (a TPU grid cell
//   takes `bb` batch items x `cg` channels in a static loop): a block takes
//   its query tile of bb images x hpb heads, each image its own softmax,
//   with the window, so the arms' (bb, cg) become the work a block walks.
// * fused_attention_pack_sm90_kernel replaces _kernel_pack: `bb` images
//   packed along the token axis of one [bb*N, bb*N] score tile, cross-image
//   and masked keys filled with -1e30, no window. A block takes its query
//   tile of each of the pack's bb images x hpb heads. The cross-image keys
//   add exact zeros to a row with a valid key, so such a row walks only its
//   own image's tiles and gets the forward's bits; a row of an image with no
//   valid key averages v over all bb*N keys of the pack (the TPU kernel's
//   full-row softmax over the pack): its cell walks every image's tiles.
//
// All three compute the forward's function (fused_attention_sm90.cu), with the
// same body and rounding points, so a row's result is the bits the forward
// writes there. k comes normed and rotated from the forward's prologue
// (fused_qk_prologue_kernel, parts = 1), as for the forward. A cell's raw q
// tile is one more cp.async copy of the ring, issued with the cell's first
// key tile, and is normed and rotated in place in shared memory when that
// tile's products start (norm_rope_sw128: norm_rope_tile's arithmetic, so
// the forward's bits). Taking q from the prologue as well (parts = 2) would
// make that a plain copy, at +2C bytes a token written and read; on an H100
// at the recorded A/B shape that left the walkers above the forward, and
// norming q here puts them under it (PERF.md).
//
// Design. A cell is one (image, head) pair of the block's query tile. The
// forward runs one cell a block: the block's setup (key end, Q norm) and its
// ring's fill and drain stand before and after each cell's few key tiles
// (four at N = 256). Here a block flattens its cells x key tiles into one
// sequence and drives it through one cp_async_ring (sm90.cuh): while cell c
// runs its last tile and writes its rows, cell c + 1's Q tile and first K/V
// tile are in flight. Q tiles take one buffer per cell in flight (kStages:
// every cell has at least one tile, and the ring issues kStages - 1 tiles
// ahead); a cell's Q is normed at its first tile, off the copies' path, with
// the rotation tables of the block's query rows held in registers (loaded
// once per image: once a block for contig). Which tiles a cell walks is
// decided before the walk, not after its pass 0 as in the forward, because
// the next cell's tiles are issued before the current cell ends: per sample
// of the block, pass 0's tiles
// (key_tiles) and whether pass 1 follows. Without a window that is exactly
// "the sample has no valid key"; with one, where the valid keys are a
// prefix [0, kv_end), exactly "some row r of the tile has r - sw >= kv_end";
// with a window and holes in the mask, always (pass 1's tiles add exact
// zeros to a row with a valid key, so walking them needlessly costs time,
// never bits). Pass 1's K tiles are not read (their scores are all filled).
// Key states come from the sample's key end where its valid keys are a
// prefix, so the walk reads the mask only during setup.
//
// What bounds them on an H100: the forward's, about 8C bytes a token (qkv
// read, out written) plus the prologue's k scratch, 2C written and 2C read,
// against 4 * B * H * N^2 * d products: at the recorded A/B shape (C 3072,
// d 128, N 256, B 64) bytes, 0.1227 ms without the scratch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; asynchronous on the caller's stream, each returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "fused_attend_sm90.cuh"

namespace {

template <int D>
struct WalkSmem {
  static constexpr int kTileBytes = kTile * D * 2;          // one sw128 tile
  static constexpr int kQ = 0;                              // kStages Q tiles
  static constexpr int kK = kQ + kStages * kTileBytes;      // kStages tiles
  static constexpr int kV = kK + kStages * kTileBytes;      // kStages tiles
  static constexpr int kState = kV + kStages * kTileBytes;  // kStages x 64 key states
  static constexpr int kGain = kState + kStages * kTile;    // q's gain, D floats
  static constexpr int kSample = kGain + D * 4;             // an int4 per sample of the block
  static constexpr size_t bytes(int nb) { return kSample + nb * sizeof(int4) + 1024; }  // + alignment slack
};

// The cells of one block: query tile blockIdx.x of images [b0, b0 + nb) x
// heads [h0, h0 + nh), image by image. With `pack` the nb images are one
// pack. kn [B, N, C]: k normed and rotated; qkv [B, N, 3C] (q, v).
template <int D>
__device__ __forceinline__ void walk_cells(const __nv_bfloat16* __restrict__ kn,
                                           const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ q_scale,
                                           const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                           const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                                           int N, int H, int b0, int nb, int h0, int nh, int sw, float score_scale,
                                           bool pack) {
  using S = WalkSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sK = smem + S::kK;
  unsigned char* sV = smem + S::kV;
  unsigned char* sState = smem + S::kState;
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);
  int4* sInfo = reinterpret_cast<int4*>(smem + S::kSample);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int C = H * D;
  const int qrow0 = cell_row0(q0);  // this thread's two query rows: qrow0 and qrow0 + 8
  for (int i = tid; i < D; i += kThreads) sGain[i] = q_scale[i];
  sample_setup(sInfo, mask, b0, nb, q0, N, sw, pack, tid);  // ends synchronised
  int steps = 0;
  for (int i = 0; i < nb; ++i) steps += nh * sInfo[i].z;

  const int n_tiles = (N + kTile - 1) / kTile;
  Cursor in = {0, 0, 0, 0};   // the next tile to issue
  Cursor at = {0, 0, 0, 0};   // the next tile to compute
  auto issue = [&](int, int stage) {
    const int4 info = sInfo[in.i];
    const int b = b0 + in.i;
    const int h = h0 + in.hl;
    if (in.t == 0)  // the cell's raw Q tile, with its first key tile
      load_tile_sw128<kTile, D, kThreads>(sQ + (in.cell % kStages) * S::kTileBytes,
                                          qkv + (long long)b * N * 3 * C + h * D, 3LL * C, q0, N, nullptr, tid);
    int src;  // the block image the key tile belongs to
    const int tile = step_tile(info, in.t, n_tiles, in.i, &src);
    const __nv_bfloat16* v_src = qkv + (long long)(b0 + src) * N * 3 * C + 2 * C + h * D;
    const unsigned char* mask_b = (mask && info.w < 0) ? mask + (long long)b * N : nullptr;
    issue_kv_tile<D>(sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile,
                     kn + (long long)b * N * C + h * D, C, v_src, 3LL * C, tile * kTile, N,
                     in.t < info.y, mask_b, info.w < 0 ? N : info.w, src != in.i, tid);
    in.next(sInfo, nh);
  };

  CellRows<D> r;
  RopeRows<D> rope;  // the tables of image rope_img's query rows
  int rope_img = -1;
  auto compute = [&](int, int stage) {
    const int4 info = sInfo[at.i];
    unsigned char* q_tile = sQ + (at.cell % kStages) * S::kTileBytes;
    if (at.t == 0) {  // the cell's Q has landed: norm and rotate it, then hand it to wgmma
      if (b0 + at.i != rope_img) {
        rope_img = b0 + at.i;
        rope.load(cos_t + (long long)rope_img * N * (D / 2), sin_t + (long long)rope_img * N * (D / 2), q0, N, tid);
      }
      norm_rope_sw128<D>(q_tile, rope, sGain, tid);
      fence_proxy_async();
      __syncthreads();
      r.reset();
    }
    int src;
    const int tile = step_tile(info, at.t, n_tiles, at.i, &src);
    attend_kv_tile<D>(r, q_tile, sK + stage * S::kTileBytes, sV + stage * S::kTileBytes, sState + stage * kTile,
                      tile * kTile, qrow0, sw, score_scale);
    if (at.t == info.z - 1) {  // the cell's last tile: its rows are done
      sum_rows<D>(r);
      __nv_bfloat16* out0 = out + ((long long)(b0 + at.i) * N + qrow0) * C + (h0 + at.hl) * D;
      store_rows<D>(r, out0, out0 + 8LL * C, qrow0, N);
    }
    at.next(sInfo, nh);
  };
  cp_async_ring<kStages>(steps, [](int s) { return s; }, issue, compute);
}

// Four blocks an SM fit at d = 64 by shared memory (50 KB each), two at
// d = 128 (100 KB); the launch bounds leave d = 64 up to 168 registers (four
// blocks' 128 spilled a few bytes and gained nothing clear). A ring of
// three tiles leaves one block an SM at d = 128, which measured slower on an
// H100, and gained nothing clear at d = 64.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
fused_attention_contig_sm90_kernel(const __nv_bfloat16* __restrict__ kn, const __nv_bfloat16* __restrict__ qkv,
                                   const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                                   const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                   __nv_bfloat16* __restrict__ out, int N, int H, int sw, float score_scale) {
  walk_cells<D>(kn, qkv, q_scale, cos_t, sin_t, mask, out, N, H, blockIdx.y, 1, 0, H, sw, score_scale, false);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
fused_attention_bb_sm90_kernel(const __nv_bfloat16* __restrict__ kn, const __nv_bfloat16* __restrict__ qkv,
                               const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                               __nv_bfloat16* __restrict__ out, int N, int H, int bb, int hpb, int sw,
                               float score_scale) {
  walk_cells<D>(kn, qkv, q_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb, sw,
                score_scale, false);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
fused_attention_pack_sm90_kernel(const __nv_bfloat16* __restrict__ kn, const __nv_bfloat16* __restrict__ qkv,
                                 const float* __restrict__ q_scale, const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t, const unsigned char* __restrict__ mask,
                                 __nv_bfloat16* __restrict__ out, int N, int H, int bb, int hpb, float score_scale) {
  walk_cells<D>(kn, qkv, q_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb, -1,
                score_scale, true);
}

// (1 / sqrt(d)) * log2(e), rounded once to fp32 as the forward's launch does.
template <int D>
float score_scale() {
  return (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream, Args... args) {
  if (smem > 232448) return cudaErrorInvalidValue;  // the most a block may have on sm_90
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The pack kernel (pack) or the batch-block kernel (window sw).
template <int D>
cudaError_t launch_blocks(const void* kn, const void* qkv, const void* q_scale, const void* cos_t, const void* sin_t,
                          const void* mask, void* out, int B, int N, int H, int bb, int hpb, int sw, bool pack,
                          cudaStream_t s) {
  const dim3 grid((N + kTile - 1) / kTile, H / hpb, B / bb);
  const auto* k = static_cast<const __nv_bfloat16*>(kn);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* g = static_cast<const float*>(q_scale);
  const auto* c = static_cast<const float*>(cos_t);
  const auto* sn = static_cast<const float*>(sin_t);
  const auto* m = static_cast<const unsigned char*>(mask);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (pack)
    return launch(fused_attention_pack_sm90_kernel<D>, WalkSmem<D>::bytes(bb), grid, s, k, q, g, c, sn, m, o, N, H,
                  bb, hpb, score_scale<D>());
  return launch(fused_attention_bb_sm90_kernel<D>, WalkSmem<D>::bytes(bb), grid, s, k, q, g, c, sn, m, o, N, H, bb,
                hpb, sw, score_scale<D>());
}

template <int D>
cudaError_t launch_contig(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                          const void* sin_t, const void* mask, void* out, int B, int N, int H, int sw,
                          cudaStream_t s) {
  return launch(fused_attention_contig_sm90_kernel<D>, WalkSmem<D>::bytes(1), dim3((N + kTile - 1) / kTile, B), s,
                static_cast<const __nv_bfloat16*>(kn), static_cast<const __nv_bfloat16*>(qkv),
                static_cast<const float*>(q_scale), static_cast<const float*>(cos_t),
                static_cast<const float*>(sin_t), static_cast<const unsigned char*>(mask),
                static_cast<__nv_bfloat16*>(out), N, H, sw, score_scale<D>());
}

template <typename Kernel>
cudaError_t attributes(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// kn [B, N, H*D] bf16: k normed and rotated (the prologue with parts = 1);
// qkv [B, N, 3*H*D] bf16 (q normed here, v read); q_scale [D] f32; cos, sin
// [B, N, D/2] f32; mask [B, N] bool bytes or null; out [B, N, H*D] bf16. A
// block takes its query tile of a pack of bb images x hpb heads (bb divides
// B, hpb divides H). No window.
int vitok_fused_attention_pack_sm90(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                                    const void* sin_t, const void* mask, void* out, int B, int N, int H, int D,
                                    int bb, int hpb, void* stream) {
  if (bb < 1 || hpb < 1 || B % bb || H % hpb || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_blocks<64>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, -1, true, s);
  if (D == 128) return launch_blocks<128>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, -1, true, s);
  return (int)cudaErrorInvalidValue;
}

// As vitok_fused_attention_pack_sm90 with the bb images of a block apart
// (_kernel_bb: each its own softmax) and window sw (< 0: none).
int vitok_fused_attention_bb_sm90(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                                  const void* sin_t, const void* mask, void* out, int B, int N, int H, int D, int bb,
                                  int hpb, int sw, void* stream) {
  if (bb < 1 || hpb < 1 || B % bb || H % hpb || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_blocks<64>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, sw, false, s);
  if (D == 128) return launch_blocks<128>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb, sw, false, s);
  return (int)cudaErrorInvalidValue;
}

// As vitok_fused_attention_pack_sm90 with one block per (64-query tile,
// sample) walking all H heads; sw < 0: no window.
int vitok_fused_attention_contig_sm90(const void* kn, const void* qkv, const void* q_scale, const void* cos_t,
                                      const void* sin_t, const void* mask, void* out, int B, int N, int H, int D,
                                      int sw, void* stream) {
  if (N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_contig<64>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  if (D == 128) return launch_contig<128>(kn, qkv, q_scale, cos_t, sin_t, mask, out, B, N, H, sw, s);
  return (int)cudaErrorInvalidValue;
}

// What the compiler and the card make of one instance (kind 0 contig, 1
// pack, 2 batch block; bb images a block): out[0] registers a thread,
// out[1] local memory a thread in bytes (spills), out[2] blocks an SM,
// out[3] dynamic shared memory a block in bytes.
int vitok_fused_attention_ab_sm90_attributes(int D, int kind, int bb, int* out) {
  if (bb < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (D == 64) {
    const size_t smem = WalkSmem<64>::bytes(kind == 0 ? 1 : bb);
    if (kind == 0) return attributes(fused_attention_contig_sm90_kernel<64>, smem, out);
    if (kind == 1) return attributes(fused_attention_pack_sm90_kernel<64>, smem, out);
    return attributes(fused_attention_bb_sm90_kernel<64>, smem, out);
  }
  if (D == 128) {
    const size_t smem = WalkSmem<128>::bytes(kind == 0 ? 1 : bb);
    if (kind == 0) return attributes(fused_attention_contig_sm90_kernel<128>, smem, out);
    if (kind == 1) return attributes(fused_attention_pack_sm90_kernel<128>, smem, out);
    return attributes(fused_attention_bb_sm90_kernel<128>, smem, out);
  }
  return (int)cudaErrorInvalidValue;
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
