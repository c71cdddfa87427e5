// The int8-input A/B attention kernel of the JAX project
// (benchmarks/ab_q8_input.py _kernel_q8in) in bf16 on the wgmma body of the
// main path's forward (fused_attend_sm90.cuh), with a block that walks many
// cells on one tile ring, as the bf16 walkers of fused_attention_ab_sm90.cu
// do.
//
// * fused_attention_q8in_sm90_kernel replaces _kernel_q8in: the input is the
//   QKV projection's int8 codes [B, N, 3C] and a per-token fp32 scale
//   [B, N, 1], half the bytes of bf16. q and k are normed as raw codes (the
//   per-token RMSNorm cancels the scale up to its eps; codes are exact in
//   bf16), v is bf16(code * scale), one rounded product (no fma), rounded to
//   nearest even. Its function is the redesigned forward's (the q/k prologue
//   and fused_attention_sm90_kernel, fused_attention_sm90.cu) on the
//   assembled bf16 tensor [q codes | k codes | bf16(v codes * scale)], and on
//   the card its result is that forward's bits there.
//
// k comes normed and rotated from the int8 instance of the forward's q/k
// prologue (fused_qk_prologue_kernel<D, int8_t>, fused_attention_sm90.cu,
// parts = 1): it reads the k codes (C bytes a token) and writes the bf16
// scratch the bf16 instance writes for bf16(code), since float(code) is what
// that instance reads. The walk then streams plain K tiles of that scratch.
// Per cell (one image x head of the block's query tile) and key tile, the
// ring carries:
//   * with the cell's first key tile, its raw Q tile as 64 x D codes into an
//     int8 staging slot (one per cell in flight: the ring issues kStages - 1
//     tiles ahead). At that tile the codes are normed and rotated into the
//     block's one bf16 sw128 Q tile (norm_rope_sw128's arithmetic reading
//     codes), before the tile's products start;
//   * the K tile (bf16 sw128, from the scratch);
//   * the V tile as 64 x D codes and the 64 keys' fp32 scales. While the
//     tile's S = Q K^T wgmma is in flight, the threads write
//     bf16(code * scale) into the block's one bf16 sw128 V tile, which the
//     P V wgmma then reads MN-major with the transpose flag, as the forward
//     reads V.
// Which tiles a cell walks, and the order, are the walkers' (sample_setup,
// step_tile, Cursor of fused_attend_sm90.cuh): pass 0 and, where a row may see
// no valid key, pass 1, decided before the walk. The block's split (bb
// images x hpb heads of a 64-query tile) comes from the wrapper's plan
// (vitok_torch/benchmarks/ab_q8_input.py q8in_plan).
//
// Head dims 64, 128, 192 and 256: at d = 192 and 256 P V is #1's two wgmma
// products on V's column blocks and the q norm reads each cell's rotation
// pairs from the tables as it norms (RopeRows, fused_attend_sm90.cuh), as in
// the bf16 walkers.
//
// The walk is this file's own, not an int8 branch of the walk that #1, #10,
// #11 and #13 instantiate: a template switch in a shared body slowed them by
// up to 34% on an H100 (PERF.md).
//
// What bounds it on an H100: the function's bytes, 3C + 4 a token read
// (codes and scale) and 2C written, against 4 * B * H * N^2 * d products: at
// the recorded A/B shape (C 3072, d 128, N 256, B 64) bytes, 0.0777 ms. The
// prologue's k scratch (2C written and 2C read a token) is this design's
// cost on top of that.
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
struct Q8inSmem {
  static constexpr int kTileBytes = kTile * D * 2;            // one bf16 sw128 tile
  static constexpr int kCodeBytes = kTile * D;                // one int8 tile, row-major [64, D]
  static constexpr int kQ = 0;                                // the cell's normed Q (bf16 sw128)
  static constexpr int kV = kQ + kTileBytes;                  // the tile's V in bf16 (sw128)
  static constexpr int kK = kV + kTileBytes;                  // kStages K tiles (bf16 sw128)
  static constexpr int kQ8 = kK + kStages * kTileBytes;       // kStages raw Q code tiles
  static constexpr int kV8 = kQ8 + kStages * kCodeBytes;      // kStages V code tiles
  static constexpr int kScale = kV8 + kStages * kCodeBytes;   // kStages x 64 fp32 token scales
  static constexpr int kState = kScale + kStages * kTile * 4; // kStages x 64 key states
  static constexpr int kGain = kState + kStages * kTile;      // q's gain, D floats
  static constexpr int kSample = kGain + D * 4;               // an int4 per image of the block
  static constexpr size_t bytes(int nb) { return kSample + nb * sizeof(int4) + 1024; }  // + alignment slack
};

// Four int8 codes (a 32-bit word) as exact floats without a conversion
// instruction (int-to-float conversion runs at an eighth of the fp32 rate on
// sm_90, by the CUDA programming guide's throughput table): code c + 128
// becomes the low byte of the mantissa of 2^23, and
// 2^23 + 128 is subtracted, exactly. float(c), so the bits of a (float)
// cast.
__device__ __forceinline__ void codes_to_floats(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // each c + 128 as an unsigned byte
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)), 8388736.f);
}

// Starts the copies of rows [row0, row0 + 64) of D int8 codes (row stride
// `stride` bytes) into a row-major [64, D] tile, 16 bytes a copy; rows at or
// past N are zero-filled and not read.
template <int D>
__device__ __forceinline__ void load_codes(unsigned char* tile, const int8_t* src, long long stride, int row0, int N,
                                           int tid) {
  constexpr int kChunks = D / 16;
#pragma unroll
  for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int row = i / kChunks;
    const int ch = i % kChunks;
    const int j = row0 + row;
    const bool in = j < N;
    cp_async16(tile + row * D + ch * 16, src + (long long)(in ? j : 0) * stride + ch * 16, in);
  }
}

// norm_rope_sw128 reading the raw rows as codes: normalises and rotates the
// [64, D] code tile `codes` into the bf16 sw128 tile `tile`, with the thread
// layout and arithmetic of norm_rope_sw128 (float(code) is what it reads for
// bf16(code); at d = 192 a lane without a piece adds zeros and writes
// nothing), so its bits.
template <int D>
__device__ __forceinline__ void norm_rope_codes_sw128(unsigned char* tile, const unsigned char* codes,
                                                      const RopeRows<D>& rope, const float* gain, int tid) {
  using R = RopeRows<D>;
  constexpr int kHalf = D / 2;
  const bool piece = nr_piece<D>(tid);
  const int c0 = piece ? (tid % R::kLanes) * 8 : 0;
#pragma unroll
  for (int p = 0; p < R::kPasses; ++p) {
    const int row = p * R::kRowsPerPass + tid / R::kLanes;
    float a[8] = {}, b[8] = {};
    if (piece) {
      const uint2 xr = *reinterpret_cast<const uint2*>(codes + row * D + c0);
      const uint2 xi = *reinterpret_cast<const uint2*>(codes + row * D + c0 + kHalf);
      codes_to_floats(xr.x, a);
      codes_to_floats(xr.y, a + 4);
      codes_to_floats(xi.x, b);
      codes_to_floats(xi.y, b + 4);
    }
    __nv_bfloat162 ce[4], se[4];
    rope.pass(p, tid, ce, se);
    uint4 yr, yi;
    norm_rope_piece<D, true>(a, b, ce, se, gain + c0, gain + kHalf + c0, yr, yi);
    if (piece) {
      *reinterpret_cast<uint4*>(tile + sw128_offset<kTile>(row, c0)) = yr;
      *reinterpret_cast<uint4*>(tile + sw128_offset<kTile>(row, c0 + kHalf)) = yi;
    }
  }
}

// bf16(code * scale) of a [64, D] V code tile into the bf16 sw128 V tile `vt`:
// one rounded fp32 product an element (no fma), rounded to nearest even, the
// assembled tensor's bits. scale: the 64 keys' fp32 scales. The loop stays
// rolled: unrolled, ptxas of CUDA 12.8 crashed (segmentation fault) on the
// d = 64 instance with this between S's commit and its wait (PERF.md).
template <int D>
__device__ __forceinline__ void dequantize_v(unsigned char* vt, const unsigned char* codes, const float* scale,
                                             int tid) {
  constexpr int kChunks = D / 8;  // eight channels: one 16-byte chunk of the sw128 tile
#pragma unroll 1
  for (int u = 0; u < kTile * kChunks / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int row = i / kChunks;
    const int col = (i % kChunks) * 8;
    const uint2 c8 = *reinterpret_cast<const uint2*>(codes + row * D + col);
    float c[8];
    codes_to_floats(c8.x, c);
    codes_to_floats(c8.y, c + 4);
    const float s = scale[row];
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = pack_bf16(__fmul_rn(c[2 * e], s), __fmul_rn(c[2 * e + 1], s));
    *reinterpret_cast<uint4*>(vt + sw128_offset<kTile>(row, col)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// attend_kv_tile with V arriving as codes: S = Q K^T is issued, V is
// dequantized into vt while S is in flight, then the online-softmax update
// (softmax_tile) and, once every thread's V is written, O += P V.
template <int D>
__device__ __forceinline__ void attend_q8_tile(CellRows<D>& r, const unsigned char* sQ, const unsigned char* kt,
                                               unsigned char* vt, const unsigned char* v8, const float* vscale,
                                               const unsigned char* st, int k0, int qrow0, int sw, float score_scale,
                                               int tid) {
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc<kTile>(sQ, kk), kmajor_desc<kTile>(kt, kk), kk > 0);
  wgmma_commit();
  dequantize_v<D>(vt, v8, vscale, tid);
  fence_proxy_async();  // this thread's V writes before the async proxy's reads
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile<D>(r, s, st, k0, qrow0, sw, score_scale);
  uint32_t pa[kTile / 16][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(s[4 * nt], s[4 * nt + 1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
  }
  __syncthreads();  // every thread's part of V is written
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) wgmma_rs<D>(r.o, pa[j], mnmajor_desc<kTile>(vt, j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(r.o);
}

// The cells of one block: query tile blockIdx.x of images [b0, b0 + nb) x
// heads [h0, h0 + nh), image by image. qkv8 [B, N, 3C] codes (q, v), tok
// [B, N] the tokens' scales, kn [B, N, C] k normed and rotated.
template <int D>
__device__ __forceinline__ void walk_q8in(const int8_t* __restrict__ qkv8, const float* __restrict__ tok,
                                          const __nv_bfloat16* __restrict__ kn, const float* __restrict__ q_scale,
                                          const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                          const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                                          int N, int H, int b0, int nb, int h0, int nh, int sw, float score_scale) {
  using S = Q8inSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sQ = smem + S::kQ;
  unsigned char* sV = smem + S::kV;
  unsigned char* sK = smem + S::kK;
  unsigned char* sQ8 = smem + S::kQ8;
  unsigned char* sV8 = smem + S::kV8;
  float* sScale = reinterpret_cast<float*>(smem + S::kScale);
  unsigned char* sState = smem + S::kState;
  float* sGain = reinterpret_cast<float*>(smem + S::kGain);
  int4* sInfo = reinterpret_cast<int4*>(smem + S::kSample);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTile;
  const int C = H * D;
  const long long row3 = 3LL * C;
  const int qrow0 = cell_row0(q0);  // this thread's two query rows: qrow0 and qrow0 + 8
  for (int i = tid; i < D; i += kThreads) sGain[i] = q_scale[i];
  sample_setup(sInfo, mask, b0, nb, q0, N, sw, false, tid);  // ends synchronised
  int steps = 0;
  for (int i = 0; i < nb; ++i) steps += nh * sInfo[i].z;

  const int n_tiles = (N + kTile - 1) / kTile;
  Cursor in = {0, 0, 0, 0};  // the next tile to issue
  Cursor at = {0, 0, 0, 0};  // the next tile to compute
  auto issue = [&](int, int stage) {
    const int4 info = sInfo[in.i];
    const int b = b0 + in.i;
    const int h = h0 + in.hl;
    const int8_t* qkv_b = qkv8 + (long long)b * N * row3;
    if (in.t == 0)  // the cell's raw Q codes, with its first key tile
      load_codes<D>(sQ8 + (in.cell % kStages) * S::kCodeBytes, qkv_b + h * D, row3, q0, N, tid);
    int src;  // no pack: the cell's own image
    const int k0 = step_tile(info, in.t, n_tiles, in.i, &src) * kTile;
    load_tile_sw128<kTile, D, kThreads>(sK + stage * S::kTileBytes, kn + (long long)b * N * C + h * D, C, k0,
                                        in.t < info.y ? N : 0, nullptr, tid);
    load_codes<D>(sV8 + stage * S::kCodeBytes, qkv_b + 2 * C + h * D, row3, k0, N, tid);
    if (tid < kTile / 4) {  // the keys' scales, four a copy (N is a multiple of 8: a copy is all in or all out)
      const int j = k0 + 4 * tid;
      cp_async16(sScale + stage * kTile + 4 * tid, tok + (long long)b * N + (j < N ? j : 0), j < N);
    }
    const unsigned char* mask_b = (mask && info.w < 0) ? mask + (long long)b * N : nullptr;
    key_states(sState + stage * kTile, k0, N, mask_b, info.w < 0 ? N : info.w, false, tid);
    in.next(sInfo, nh);
  };

  CellRows<D> r;
  RopeRows<D> rope;  // the tables of image rope_img's query rows
  int rope_img = -1;
  auto compute = [&](int, int stage) {
    const int4 info = sInfo[at.i];
    if (at.t == 0) {  // the cell's Q codes have landed: norm and rotate them into sQ, then hand it to wgmma
      if (b0 + at.i != rope_img) {
        rope_img = b0 + at.i;
        rope.load(cos_t + (long long)rope_img * N * (D / 2), sin_t + (long long)rope_img * N * (D / 2), q0, N, tid);
      }
      norm_rope_codes_sw128<D>(sQ, sQ8 + (at.cell % kStages) * S::kCodeBytes, rope, sGain, tid);
      fence_proxy_async();
      __syncthreads();
      r.reset();
    }
    int src;
    const int k0 = step_tile(info, at.t, n_tiles, at.i, &src) * kTile;
    attend_q8_tile<D>(r, sQ, sK + stage * S::kTileBytes, sV, sV8 + stage * S::kCodeBytes, sScale + stage * kTile,
                      sState + stage * kTile, k0, qrow0, sw, score_scale, tid);
    if (at.t == info.z - 1) {  // the cell's last tile: its rows are done
      sum_rows<D>(r);
      __nv_bfloat16* out0 = out + ((long long)(b0 + at.i) * N + qrow0) * C + (h0 + at.hl) * D;
      store_rows<D>(r, out0, out0 + 8LL * C, qrow0, N);
    }
    at.next(sInfo, nh);
  };
  cp_async_ring<kStages>(steps, [](int s) { return s; }, issue, compute);
}

// Shared memory: 49.9 KB a block at d = 64, 98.1 KB at d = 128, 146.4 KB at
// d = 192 and 194.6 KB at d = 256 (one image a block), so four, two, one and
// one blocks an SM fit; the launch bounds are the bf16 walkers'.
template <int D>
__global__ void __launch_bounds__(kThreads, walk_min_blocks<D>())
fused_attention_q8in_sm90_kernel(const int8_t* __restrict__ qkv8, const float* __restrict__ tok,
                                 const __nv_bfloat16* __restrict__ kn, const float* __restrict__ q_scale,
                                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                 const unsigned char* __restrict__ mask, __nv_bfloat16* __restrict__ out, int N,
                                 int H, int bb, int hpb, int sw, float score_scale) {
  walk_q8in<D>(qkv8, tok, kn, q_scale, cos_t, sin_t, mask, out, N, H, blockIdx.z * bb, bb, blockIdx.y * hpb, hpb, sw,
               score_scale);
}

// (1 / sqrt(d)) * log2(e), rounded once to fp32 as the forward's launch does.
template <int D>
float score_scale() {
  return (float)(1.0 / std::sqrt((double)D) * 1.4426950408889634);
}

template <int D>
cudaError_t launch_q8in(const void* qkv8, const void* tok, const void* kn, const void* q_scale, const void* cos_t,
                        const void* sin_t, const void* mask, void* out, int B, int N, int H, int bb, int hpb, int sw,
                        cudaStream_t stream) {
  const size_t smem = Q8inSmem<D>::bytes(bb);
  if (smem > 232448) return cudaErrorInvalidValue;  // the most a block may have on sm_90
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_q8in_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTile - 1) / kTile, H / hpb, B / bb);
  fused_attention_q8in_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(qkv8), static_cast<const float*>(tok), static_cast<const __nv_bfloat16*>(kn),
      static_cast<const float*>(q_scale), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const unsigned char*>(mask), static_cast<__nv_bfloat16*>(out), N, H, bb, hpb, sw, score_scale<D>());
  return cudaGetLastError();
}

template <int D>
cudaError_t attributes(int bb, int* out) {
  const size_t smem = Q8inSmem<D>::bytes(bb);
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_q8in_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_attention_q8in_sm90_kernel<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fused_attention_q8in_sm90_kernel<D>, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// qkv8 [B, N, 3*H*D] int8 codes (q and v read here); tok_scale [B, N] f32;
// kn [B, N, H*D] bf16: k normed and rotated (vitok_fused_k_prologue_q8 of
// the forward's library); q_scale [D] f32; cos, sin [B, N, D/2] f32; mask
// [B, N] bool bytes or null; out [B, N, H*D] bf16. A block takes its query
// tile of bb images x hpb heads (bb divides B, hpb divides H); sw < 0: no
// window. N a multiple of 8; D 64, 128, 192 or 256.
int vitok_fused_attention_q8in_sm90(const void* qkv8, const void* tok_scale, const void* kn, const void* q_scale,
                                    const void* cos_t, const void* sin_t, const void* mask, void* out, int B, int N,
                                    int H, int D, int bb, int hpb, int sw, void* stream) {
  if (bb < 1 || hpb < 1 || B % bb || H % hpb || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_head_dim(D, [&](auto d) {
    return launch_q8in<decltype(d)::value>(qkv8, tok_scale, kn, q_scale, cos_t, sin_t, mask, out, B, N, H, bb, hpb,
                                           sw, s);
  });
}

// What the compiler and the card make of the instance at head dim D with bb
// images a block: out[0] registers a thread, out[1] local memory a thread in
// bytes (spills), out[2] blocks an SM, out[3] dynamic shared memory a block
// in bytes.
int vitok_fused_attention_q8in_sm90_attributes(int D, int bb, int* out) {
  if (bb < 1) return (int)cudaErrorInvalidValue;
  return (int)with_head_dim(D, [&](auto d) { return attributes<decltype(d)::value>(bb, out); });
}

const char* vitok_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
