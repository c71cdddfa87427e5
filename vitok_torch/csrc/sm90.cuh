// Hopper (sm_90a) building blocks for the port's wgmma kernels (the fused
// and flash attention kernels, and the int8 fc1 kernel ffn_int8.cu), as
// inline PTX:
//   * wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators: N = 64 with
//     A and B from shared memory (the logits' products), N in {64, 128} with
//     A from registers and B from shared memory (the products into d; N 192
//     and 256 as two of them on B's column blocks);
//   * wgmma.mma_async m64nNk32, int8 inputs, int32 accumulators, N in
//     {64, 128}, A and B from shared memory, both K-major;
//   * the shared-memory matrix descriptor for the 128-byte swizzle, and
//     wgmma.fence / commit_group / wait_group;
//   * the tile layout that descriptor reads, written by 16-byte cp.async
//     copies, and the proxy fence that orders those copies before wgmma;
//   * mbarriers and the 2D TMA tile load that signals one (ffn_int8.cu).
// vitok_torch/ops/_build.py hashes every header in csrc/ into every
// library's cache key, so an edit here rebuilds them all.
//
// Tile layout ("sw128 tile"): R rows of D bf16 channels (D a multiple of 64)
// are stored as D / 64 column blocks of R x 128 bytes, one after another.
// Inside a block row r starts at r * 128 and its eight 16-byte chunks c sit
// at ((c ^ (r % 8)) * 16): the 128-byte swizzle that TMA writes and wgmma
// reads (the XOR takes address bits [7, 10) into bits [4, 7)), so every block
// must start on a 1024-byte boundary. Eight rows (1024 bytes) are one
// swizzle atom. The same bytes serve both operand majors:
//   * K-major (the channels are the contracted axis: Q and K of S = Q K^T):
//     k-step kk (16 channels) starts at block kk / 4, byte (kk % 4) * 32 of
//     row 0; SBO = 1024 (next eight rows), LBO unused;
//   * MN-major (the rows are the contracted axis: V of O += P V, read with
//     the transpose flag): k-step j (16 rows) starts at byte j * 2048 of
//     block 0; SBO = 1024 (next eight rows), LBO = R * 128 (next 64 channels).
//
// The attention kernels fill their tiles by cp.async rather than TMA: every
// tile is a strided plane of [B, N, k*C] (no tensor map to encode per call),
// and rows past N or masked rows are zero-filled by the copy itself. cp.async writes
// through the generic proxy and wgmma reads through the async proxy, so the
// writer fences (fence.proxy.async) after its copies land and before the
// barrier that hands the tile to wgmma.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kSwRowBytes = 128;  // one row of a column block
constexpr int kSwAtomBytes = 1024;

// Descriptor of a 128-byte-swizzled operand starting at `p` (shared memory).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_addr(p);
  uint64_t desc = (uint64_t)((addr & 0x3FFFF) >> 4);
  desc |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  desc |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  desc |= 1ull << 62;  // layout: 128-byte swizzle
  return desc;
}

// K-major operand of an R-row tile: channels [16 kk, 16 kk + 16).
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * R * kSwRowBytes + (kk & 3) * 32, 16, kSwAtomBytes);
}

// MN-major operand of an R-row tile: rows [16 j, 16 j + 16), all channels.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int j) {
  return sw128_desc(tile + j * 16 * kSwRowBytes, R * kSwRowBytes, kSwAtomBytes);
}

// Copies rows [row0, row0 + R) of D channels (row stride `stride`
// elements) into an sw128 tile, 16 bytes a copy, THREADS threads. Rows at or
// past N, and rows whose byte in `rowmask` (absolute row index; may be null)
// is 0, are zero-filled and not read.
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_tile_sw128(unsigned char* tile, const __nv_bfloat16* src,
                                                long long stride, int row0, int N,
                                                const unsigned char* rowmask, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int u = 0; u < R * kChunks / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const int row = i / kChunks;
    const int ch = i % kChunks;
    const int j = row0 + row;
    const bool in = j < N && (rowmask == nullptr || rowmask[j]);
    unsigned char* dst = tile + (ch >> 3) * R * kSwRowBytes + row * kSwRowBytes + (((ch & 7) ^ (row & 7)) << 4);
    cp_async16(dst, src + (long long)(in ? j : 0) * stride + ch * 8, in);
  }
}

// Byte offset of element (row, col) of an R-row sw128 tile.
template <int R>
__device__ __forceinline__ int sw128_offset(int row, int col) {
  return (col >> 6) * R * kSwRowBytes + row * kSwRowBytes + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// Orders this thread's generic-proxy writes to shared memory (st.shared,
// landed cp.async copies) before later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across wgmma issue and wait points.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A * B, m64n64k16: A and B from shared memory (descriptors), both
// K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A * B, m64n64k16: A from registers (the m16n8k16 A fragment of
// this warp's 16 rows), B from shared memory, MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (+)= A * B, m64n128k16: A from registers, B from shared memory,
// MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The columns [64 j, ...) of an MN-major sw128 operand: its descriptor
// moved by j column blocks (the leading byte offset, LBO, apart). The start
// address is the descriptor's low 14 bits in 16-byte units; a shared-memory
// address stays below 2^18 bytes, so the sum does not carry out of them.
__device__ __forceinline__ uint64_t mnmajor_columns(uint64_t desc, int j) {
  return desc + (uint64_t)j * ((desc >> 16) & 0x3FFF);
}

// The C fragment of columns [64 j, 64 j + W) of an m64nN accumulator: an
// accumulator holds its columns in groups of eight, four registers a group,
// so a column slice is a run of W / 2 registers.
template <int W, int N>
__device__ __forceinline__ float (&acc_columns(float (&d)[N / 2], int j))[W / 2] {
  return *reinterpret_cast<float(*)[W / 2]>(&d[32 * j]);
}

// The N = 64, 128, 192 or 256 instance. N = 192 and 256 (head dims 192 and
// 256) are issued as n128 + n64 and n128 + n128 products on the column
// blocks of B: the same sums in the same registers, two instructions.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "wgmma width");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b, accumulate);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b, accumulate);
  } else {
    wgmma_rs_n128(acc_columns<128, N>(d, 0), a, desc_b, accumulate);
    if constexpr (N == 192)
      wgmma_rs_n64(acc_columns<64, N>(d, 2), a, mnmajor_columns(desc_b, 2), accumulate);
    else
      wgmma_rs_n128(acc_columns<128, N>(d, 2), a, mnmajor_columns(desc_b, 2), accumulate);
  }
}

// int8 products: d (+)= A * B, m64nNk32, s8 x s8 -> s32, A and B from shared
// memory (descriptors), both K-major (the only major 8-bit operands take).
// In the 128-byte swizzle a k-step is 32 bytes of a 128-byte row, so
// kmajor_desc<R>(tile, kk) addresses k-step kk of an int8 tile as well.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The N = 64 or N = 128 instance.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64)
    wgmma_s8_n64(d, desc_a, desc_b, accumulate);
  else
    wgmma_s8_n128(d, desc_a, desc_b, accumulate);
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// mbarriers in shared memory (64-bit words). A phase completes when `count`
// arrivals have been made and every byte announced with expect_tx has
// landed; mbar_wait(bar, parity) returns once the phase of that parity has
// completed (parity 1 before the first phase: at once).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible to the async proxy (TMA) and the
// cluster; the block synchronises after it.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA transfers to land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 along the inner dimension, c1 along the outer) of the
// 2D tensor map `tmap` (a __grid_constant__ kernel parameter) into `dst` in
// this block's shared memory, its bytes counted on `bar`. Elements outside
// the tensor are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A ring of STAGES tile slots filled by cp.async, over `count` tiles:
// issue(tile, slot) starts the copies of a tile, compute(tile, slot) runs its
// products; tile_at(i) is the i-th tile of the walk. Tile i + STAGES - 1 is
// issued into the slot tile i - 1 left, so STAGES - 1 tiles are in flight
// while tile i computes. Copies committed before the call (the block's own
// tiles) have landed by the first compute; none is left in flight after.
template <int STAGES, typename TileAt, typename Issue, typename Compute>
__device__ __forceinline__ void cp_async_ring(int count, TileAt tile_at, Issue issue, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) issue(tile_at(s), s);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    const int ahead = it + STAGES - 1;
    if (ahead < count) issue(tile_at(ahead), ahead % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    fence_proxy_async();
    __syncthreads();
    compute(tile_at(it), it % STAGES);
    __syncthreads();  // every warp's reads of this slot are done
  }
  cp_async_wait<0>();
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads of
// the block: bar_sync waits until all have arrived, bar_arrive counts this
// thread and goes on. Both order this thread's earlier shared-memory
// accesses before the barrier completes.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The first 1024-byte boundary at or after `p` (dynamic shared memory is
// only 16-byte aligned; the launch asks for 1 KB more).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// *out = one past the last nonzero byte of mask[0, N) (N without a mask),
// over the block's THREADS threads; ends with the block synchronised.
template <int THREADS>
__device__ __forceinline__ void block_last_valid(const unsigned char* mask, int N, int* out, int tid) {
  if (tid == 0) *out = mask ? 0 : N;
  __syncthreads();
  if (mask) {
    int last = 0;
    for (int j = tid; j < N; j += THREADS)
      if (mask[j]) last = j + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if ((tid & 31) == 0) atomicMax(out, last);
  }
  __syncthreads();
}

}  // namespace
