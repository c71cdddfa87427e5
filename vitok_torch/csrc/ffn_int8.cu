// Fused int8 fc1 product (both SwiGLU halves) + dequantize + f32
// silu(g) * v + exact per-token int8 requantization, in one launch.
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
// product and the quantize. Here a thread-block cluster of `cs` blocks
// (8, a portable size, or 16 where 8 cannot stage t beside a three-stage
// ring) shares one tile of BM token rows (128, or 64 where the staged t
// would not fit beside a three-stage ring) and splits F' between its
// blocks, in
// tiles of 64 t-columns: rank r owns tiles [r T / cs, (r + 1) T / cs) of
// T = F' / 64. Each block keeps its [BM, its columns] bf16 t in shared
// memory; the row maxima go over distributed shared memory between two
// cluster barriers; then every block quantizes its own columns from shared
// memory, and rank 0 writes the scales. t never reaches device memory, and
// there is one launch. Where even a cluster of 16 cannot stage t (F' above
// about 19,456), the scratch instance sends each block's bf16 t tiles
// through a device-memory scratch [M, F'] instead (L2-resident at these
// sizes), with the same cluster exchange of row maxima and the same
// quantize reading the scratch back: the JAX kernel takes any 128-aligned F'. ffn_int8_plan in vitok_torch/ops/quant.py picks BM,
// the cluster size and the ring depth from the shared memory they need
// (the smem_bytes formula below).
//
// A block: two consumer warpgroups and one producer warp. The producer's one
// thread walks the block's (tile, k-step) sequence with TMA (128-byte
// swizzle): per stage the BM x 128-byte hq box and the tile's 64 v rows and
// 64 g rows of W [2F', C] as one 128 x 128-byte B tile, on a ring of
// `stages` slots with a full and an empty mbarrier each. The consumer
// warpgroups take the block's tiles in turns, each over all BM rows: one
// wgmma m64n128k32 s8 x s8 -> s32 a k-step and 64-row sub-tile (columns
// 0-63 of the accumulator are v, 64-127 are g, so a thread holds v and g of
// the same t-column). A warpgroup releases a slot once the next stage's
// products are issued and the slot's have retired; after its tile's last
// stage it dequantizes, applies the SwiGLU, folds the row absmax and stages
// bf16 t, while the other warpgroup runs the next tile's products. Named
// barriers keep the turns in order (a warpgroup waits on a stage only once
// the other has waited on the tile before).
//
// What bounds it on an H100: operations. At M = 16384, C = 1024, 2F' = 5632
// the product is 2 * M * C * 2F' = 1.89e11 int8 operations, 0.096 ms at
// 1,979 TOP/s; its bytes (hq, W, codes) take about 0.021 ms. What holds this
// design back is the copies into shared memory: hq comes once per 64-column
// tile and W once per row tile, about 0.74 + 0.74 GB at that shape, and an
// exploratory build without the products read almost as slow. Multicasting
// the hq box over the cluster cuts the bytes read from L2 but not those that
// reach each SM, and read slower (every slot then waits for all ranks); both
// warpgroups on one tile, the epilogue not overlapped, read slower than the
// turns (PERF.md, PR 13).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError(). The tensor maps are encoded on the host
// with the driver's cuTensorMapEncodeTiled, found through the runtime
// (cudaGetDriverEntryPoint), so the library needs no link to libcuda.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTileCols = 64;   // t-columns of a tile: 64 v and 64 g rows of W, one m64n128k32 B tile
constexpr int kBK = 128;        // int8 depth of a stage: one 128-byte swizzled row
constexpr int kMaxCluster = 16;  // above 8 a non-portable cluster
constexpr int kSmemLimit = 232448;

// Shared memory of a block (from the 1024-byte aligned base): the ring,
// then the staged bf16 t ([BM, per * 64] with 16 bytes of row padding; none
// in the scratch instance, whose t goes to device memory), the two consumer
// warpgroups' row maxima and the rows' reciprocals, and the ring's full and
// empty mbarriers.
struct FfnSmem {
  int a_bytes, stage_bytes, stride, t_off, max_off, bar_off, bytes;

  __host__ __device__ FfnSmem(int rows, int cs, int stages, int Fp, bool scratch) {
    const int tiles = Fp / kTileCols;
    const int per = (tiles + cs - 1) / cs;  // the most tiles a rank owns
    a_bytes = rows * kBK;
    stage_bytes = a_bytes + 2 * kTileCols * kBK;
    stride = scratch ? 0 : per * kTileCols * 2 + 16;
    t_off = stages * stage_bytes;
    max_off = t_off + rows * stride;
    bar_off = max_off + 3 * rows * 4;
    bytes = bar_off + 2 * stages * 8 + 1024;  // + alignment slack
  }
};

__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
}

// t = silu(g) * v of one accumulator pair.
__device__ __forceinline__ float swiglu(int acc_v, int acc_g, float h, float sv, float sg) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc_v), h), sv);
  const float g = __fmul_rn(__fmul_rn(__int2float_rn(acc_g), h), sg);
  return __fmul_rn(silu(g), v);
}

__device__ __forceinline__ uint32_t quant4(const __nv_bfloat162 a, const __nv_bfloat162 b, float rcp) {
  const float2 x = __bfloat1622float2(a), y = __bfloat1622float2(b);
  const float v[4] = {x.x, x.y, y.x, y.y};
  uint32_t out = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(v[e], rcp)), -127.f), 127.f);
    out |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
  }
  return out;
}

template <int BM>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
ffn_int8_kernel(const __grid_constant__ CUtensorMap hq_map,  // hq [M, C] int8, box 128 x BM
                const __grid_constant__ CUtensorMap w_map,   // w [2Fp, C] int8, box 128 x 64
                const float* __restrict__ hs,                // [M]
                const float* __restrict__ ws,                // [2Fp]
                int8_t* __restrict__ q,                      // [M, Fp]
                float* __restrict__ t_scale,                 // [M]
                unsigned char* __restrict__ t_scratch,       // [M rounded up to BM, Fp] bf16, or null
                int M, int C, int Fp, int stages) {
  namespace cg = cooperative_groups;
  constexpr int kConsumers = 2 * 128;
  constexpr int kBlockThreads = kConsumers + 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const FfnSmem L(BM, cs, stages, Fp, t_scratch != nullptr);
  unsigned char* ring = smem;
  unsigned char* sT = smem + L.t_off;
  float* sRowMax = reinterpret_cast<float*>(smem + L.max_off);  // [2][BM]: one row a warpgroup
  float* sRcp = sRowMax + 2 * BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int tiles = Fp / kTileCols;
  const int tile_lo = rank * tiles / cs;
  const int tile_hi = (rank + 1) * tiles / cs;
  const int k_tiles = C / kBK;
  // Where this block stages its bf16 t: shared memory, or in the scratch
  // instance its own columns of the rows' scratch in device memory (L2).
  unsigned char* const t_base =
      t_scratch != nullptr ? t_scratch + ((long long)m0 * Fp + tile_lo * kTileCols) * 2 : sT;
  const long long t_stride = t_scratch != nullptr ? (long long)Fp * 2 : L.stride;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp of the warpgroup that takes the stage
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // The producer: one thread keeps the ring full.
    if (lane == 0) {
      int s = 0, phase = 0, issued = 0;
      for (int jt = tile_lo; jt < tile_hi; ++jt)
        for (int kt = 0; kt < k_tiles; ++kt, ++issued) {
          if (issued >= stages) mbar_wait(&empty[s], phase ^ 1);
          unsigned char* a = ring + s * L.stage_bytes;
          mbar_arrive_expect_tx(&full[s], L.stage_bytes);
          tma_load_2d(a, &hq_map, &full[s], kt * kBK, m0);
          tma_load_2d(a + L.a_bytes, &w_map, &full[s], kt * kBK, jt * kTileCols);
          tma_load_2d(a + L.a_bytes + kTileCols * kBK, &w_map, &full[s], kt * kBK, Fp + jt * kTileCols);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
    }
    __syncwarp();  // the warp reconverges before the cluster barrier
  } else {
    // A consumer warpgroup: the block's tiles tile_lo + wg, + 2, ... over all
    // BM rows (kSub m64 products a k-step), while the other warpgroup takes
    // the tiles between: one warpgroup's epilogue runs beside the other's
    // products. This thread holds, in each 64-row sub-tile u, rows
    // 64 u + lrow and + 8, and of each 8-column group j the columns
    // 8 j + 2 t4 + {0, 1} (j < 8: v, j >= 8: g).
    constexpr int kSub = BM / 64;
    const int wg = warp >> 2;
    const int lrow = (warp & 3) * 16 + (lane >> 2);
    const int t4 = lane & 3;
    float h[kSub][2], rmax[kSub][2];
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 64 * u + lrow + 8 * e;
        h[u][e] = row < M ? hs[row] : 0.f;
        rmax[u][e] = 0.f;
      }
    // The two warpgroups take turns: one starts waiting on its tile's stages
    // only once the other has waited on all of the tile before (named
    // barriers 1 and 2, 256 threads), so that no warpgroup waits on a slot
    // whose previous use is still pending: the parity of a phase tells only
    // the last two apart.
    for (int jt = tile_lo + wg; jt < tile_hi; jt += 2) {
      if (jt > tile_lo) bar_sync(1 + wg, 256);
      int acc[kSub][64];
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[u][i] = 0;
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int it = (jt - tile_lo) * k_tiles + kt;  // the stage's place in the block's sequence
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const unsigned char* a = ring + s * L.stage_bytes;
        const unsigned char* b = a + L.a_bytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
          for (int u = 0; u < kSub; ++u)
            wgmma_s8<128>(acc[u], kmajor_desc<64>(a + u * 64 * kBK, kk), kmajor_desc<128>(b, kk), 1);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();  // the previous stage's products have retired
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      if (jt + 1 < tile_hi) bar_arrive(2 - wg, 256);  // the other warpgroup's next tile may start
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < kSub; ++u) fence_regs(acc[u]);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue: t in f32, the row maxima, bf16 t staged.
      const int gcol = jt * kTileCols;
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        unsigned char* row0 = t_base + (64 * u + lrow) * t_stride + (jt - tile_lo) * kTileCols * 2;
        unsigned char* row1 = row0 + 8 * t_stride;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float2 sv = *reinterpret_cast<const float2*>(ws + gcol + c);
          const float2 sg = *reinterpret_cast<const float2*>(ws + Fp + gcol + c);
          const float a0 = swiglu(acc[u][4 * j], acc[u][4 * (j + 8)], h[u][0], sv.x, sg.x);
          const float a1 = swiglu(acc[u][4 * j + 1], acc[u][4 * (j + 8) + 1], h[u][0], sv.y, sg.y);
          const float b0 = swiglu(acc[u][4 * j + 2], acc[u][4 * (j + 8) + 2], h[u][1], sv.x, sg.x);
          const float b1 = swiglu(acc[u][4 * j + 3], acc[u][4 * (j + 8) + 3], h[u][1], sv.y, sg.y);
          rmax[u][0] = fmaxf(rmax[u][0], fmaxf(fabsf(a0), fabsf(a1)));
          rmax[u][1] = fmaxf(rmax[u][1], fmaxf(fabsf(b0), fabsf(b1)));
          *reinterpret_cast<__nv_bfloat162*>(row0 + c * 2) = __floats2bfloat162_rn(a0, a1);
          *reinterpret_cast<__nv_bfloat162*>(row1 + c * 2) = __floats2bfloat162_rn(b0, b1);
        }
      }
    }
    // The four threads of a row hold its columns between them; each
    // warpgroup keeps its own maxima.
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = rmax[u][e];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t4 == 0) sRowMax[wg * BM + 64 * u + lrow + 8 * e] = m;
      }
  }

  cluster.sync();  // every block's row maxima and staged t are written (the barrier orders the scratch too)
  for (int r = tid; r < BM; r += kBlockThreads) {
    float amax = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* peer = cluster.map_shared_rank(sRowMax, k);
      amax = fmaxf(amax, fmaxf(peer[r], peer[BM + r]));
    }
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
    sRcp[r] = __fdiv_rn(1.f, scale);
    if (rank == 0 && m0 + r < M) t_scale[m0 + r] = scale;
  }
  cluster.sync();  // no block reads another's maxima past here; sRcp is written

  // Quantize this block's columns, 16 a thread-step (one 16-byte store).
  const int chunks = (tile_hi - tile_lo) * kTileCols / 16;
  for (int i = tid; i < BM * chunks; i += kBlockThreads) {
    const int r = i / chunks;
    const int ch = i % chunks;
    if (m0 + r >= M) continue;
    const float rcp = sRcp[r];
    const uint4* src = reinterpret_cast<const uint4*>(t_base + r * t_stride + ch * 32);
    const uint4 u0 = src[0], u1 = src[1];
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&u0);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&u1);
    const uint4 out = make_uint4(quant4(x[0], x[1], rcp), quant4(x[2], x[3], rcp), quant4(y[0], y[1], rcp),
                                 quant4(y[2], y[3], rcp));
    *reinterpret_cast<uint4*>(q + (long long)(m0 + r) * Fp + tile_lo * kTileCols + ch * 16) = out;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                        : nullptr;
  }();
  return fn;
}

// The map of a row-major int8 matrix [rows, cols]: boxes of box_rows rows x
// 128 bytes, 128-byte swizzle, zeros outside.
bool int8_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaLaunchConfig_t launch_config(int rows, int cs, int M, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (M + rows - 1) / rows, 1);
  cfg.blockDim = dim3(2 * 128 + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool plan_ok(int rows, int cs, int stages, int M, int C, int Fp, bool scratch) {
  return (rows == 64 || rows == 128) && cs >= 1 && cs <= kMaxCluster && cs <= Fp / kTileCols && stages >= 2 &&
         M > 0 && C > 0 && C % kBK == 0 && Fp % kTileCols == 0 &&
         FfnSmem(rows, cs, stages, Fp, scratch).bytes <= kSmemLimit;
}

// The kernel's dynamic shared memory, and clusters of 9-16 blocks, which are
// not portable: ask for them.
template <int BM>
cudaError_t set_attributes(int cs, int smem) {
  cudaError_t err = cudaFuncSetAttribute(ffn_int8_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || cs <= 8) return err;
  return cudaFuncSetAttribute(ffn_int8_kernel<BM>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int BM>
cudaError_t launch(const void* hq, const void* hs, const void* w, const void* ws, void* q, void* t_scale,
                   void* t_scratch, int M, int C, int Fp, int cs, int stages, cudaStream_t stream) {
  CUtensorMap hq_map, w_map;
  if (!int8_map(&hq_map, hq, M, C, BM) || !int8_map(&w_map, w, 2 * Fp, C, kTileCols)) return cudaErrorInvalidValue;
  const int smem = FfnSmem(BM, cs, stages, Fp, t_scratch != nullptr).bytes;
  cudaError_t err = set_attributes<BM>(cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(BM, cs, M, smem, stream, attr);
  const float* hs_f = static_cast<const float*>(hs);
  const float* ws_f = static_cast<const float*>(ws);
  int8_t* q_i = static_cast<int8_t*>(q);
  float* scale_f = static_cast<float*>(t_scale);
  unsigned char* scratch_b = static_cast<unsigned char*>(t_scratch);
  void* args[] = {&hq_map, &w_map, &hs_f, &ws_f, &q_i, &scale_f, &scratch_b, &M, &C, &Fp, &stages};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(ffn_int8_kernel<BM>), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BM>
cudaError_t attributes(int cs, int stages, int Fp, bool scratch, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, ffn_int8_kernel<BM>);
  if (err != cudaSuccess) return err;
  const int smem = FfnSmem(BM, cs, stages, Fp, scratch).bytes;
  err = set_attributes<BM>(cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(BM, cs, BM * cs, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, ffn_int8_kernel<BM>, &cfg);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = clusters;
  out[3] = smem;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// hq [M, C] int8; hs [M] f32; w [2Fp, C] int8 (v rows, then g rows); ws
// [2Fp] f32; q [M, Fp] int8; t_scale [M] f32; t_scratch null, or for the
// scratch instance [M rounded up to `rows`, Fp] bf16, 16-byte aligned. The
// plan (rows 64 or 128, a cluster of cs <= 16 blocks, `stages` ring slots,
// scratch or not) is ffn_int8_plan's in vitok_torch/ops/quant.py. C a
// multiple of 128, Fp of 64; hq and w 16-byte aligned. Returns the
// cudaError_t of the launch (0 = success).
int vitok_ffn_int8(const void* hq, const void* hs, const void* w, const void* ws, void* q, void* t_scale,
                   void* t_scratch, int M, int C, int Fp, int rows, int cs, int stages, void* stream) {
  if (!plan_ok(rows, cs, stages, M, C, Fp, t_scratch != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 128) return (int)launch<128>(hq, hs, w, ws, q, t_scale, t_scratch, M, C, Fp, cs, stages, s);
  return (int)launch<64>(hq, hs, w, ws, q, t_scale, t_scratch, M, C, Fp, cs, stages, s);
}

// The kernel instance of a plan: out[0] registers a thread, out[1] local
// (spill) bytes a thread, out[2] clusters that can be resident at once
// (cudaOccupancyMaxActiveClusters), out[3] dynamic shared memory bytes.
int vitok_ffn_int8_attributes(int rows, int cs, int stages, int Fp, int scratch, int* out) {
  if (!plan_ok(rows, cs, stages, rows, kBK, Fp, scratch != 0)) return (int)cudaErrorInvalidValue;
  if (rows == 128) return (int)attributes<128>(cs, stages, Fp, scratch != 0, out);
  return (int)attributes<64>(cs, stages, Fp, scratch != 0, out);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
