// #2 in fp32: the int8 epilogue of the fused attention on fp32 compute, the
// second of its two launches. The fp32 walker's forward
// (fused_attention_ab_f32_sm90.cu, kind 0) writes the attention output
// [B, N, C] f32 into a scratch, then this kernel quantizes each token row
// over all C channels:
//   scale = max(absmax(x) / 127, 1e-12); q = clip(rint(x / scale), -127, 127)
// (the division, round half to even), quantize_activation's function, op
// for op (row_stream.cuh's token_scale and store_codes), so the codes and
// scales equal quantize_activation of the walker's output bit for bit.
//
// Replaces, with the walker, the TPU kernel
// vitok_tpu/ops/fused_attention.py::_fused_kernel_q8 on fp32 compute (the
// bf16 one is fused_attention_sm90.cu's int8-epilogue kernel). The TPU
// kernel keeps a row tile of all heads in VMEM and quantizes it there; here
// the row's heads are spread over the walker's blocks, so the fp32 output
// takes one round trip through device memory (L2 at these sizes) between
// the two launches. Folding the quantize into the walker (a block that owns
// a row tile over all heads, as the contig walk does) is later work.
//
// What bounds it on an H100: bytes. It reads 4C bytes a token and writes C
// + 4: at the 350M width (C 1024) and 16 x 256 tokens, 21.0 MB, 0.0063 ms at
// 3.35 TB/s. The design (row_stream.cuh's wide rows): a block of 256
// threads takes one row at a time, each thread the 16-channel chunks
// u = tid + 256 i, two passes over the row (the absmax, then the codes), the
// second from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry points, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include "row_stream.cuh"

namespace {

template <int V>
__global__ void __launch_bounds__(kWideThreads)
quantize_rows_f32_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale_out,
                         int rows, int C) {
  __shared__ float red[2][kWideThreads / 32];  // by the parity of the block's row: one barrier a row
  const int tid = threadIdx.x;
  const int units = C / V;
  int turn = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, ++turn) {
    const unsigned char* xr = reinterpret_cast<const unsigned char*>(x + row * C);
    float amax = 0.f;
    for (int u = tid; u < units; u += kWideThreads) {
      float f[V];
      wide_chunk<float, V>(xr, u, f);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
    amax = group_max<kWideThreads>(amax, red[turn & 1], 0, tid);
    const float scale = token_scale(amax);
    const float rcp = faithful_rcp(scale);
    for (int u = tid; u < units; u += kWideThreads) {
      float f[V];
      wide_chunk<float, V>(xr, u, f);
      store_codes<V>(q + row * C + u * V, f, scale, rcp);
    }
    if (tid == 0) scale_out[row] = scale;
  }
}

template <int V>
cudaError_t launch(const void* x, void* q, void* scale, int rows, int C, int grid, cudaStream_t stream, int* attrs) {
  const auto kernel = quantize_rows_f32_kernel<V>;
  if (attrs) return row_attributes(kernel, kWideThreads, 0, attrs);
  kernel<<<grid, kWideThreads, 0, stream>>>(static_cast<const float*>(x), static_cast<int8_t*>(q),
                                            static_cast<float*>(scale), rows, C);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, void* q, void* scale, int rows, int C, int grid, cudaStream_t stream,
                     int* attrs) {
  if (C < 8 || C % 8) return cudaErrorInvalidValue;
  if (C % 16 == 0) return launch<16>(x, q, scale, rows, C, grid, stream, attrs);
  return launch<8>(x, q, scale, rows, C, grid, stream, attrs);
}

}  // namespace

extern "C" {

// x [rows, C] f32, 16-byte aligned, C a multiple of 8; q [rows, C] int8;
// scale [rows] f32. `grid` blocks of 256 threads, each walking rows
// blockIdx.x, + grid, ...; the launch runs on `device`. Returns the
// cudaError_t of the launch (0 = success).
int vitok_quantize_rows_f32(const void* x, void* q, void* scale, int rows, int C, int grid, int device,
                            void* stream) {
  if (rows < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)dispatch(x, q, scale, rows, C, grid, static_cast<cudaStream_t>(stream), nullptr);
}

// The instance for width C on the current device: out = {registers a thread,
// spilled bytes a thread, blocks an SM hosts, shared bytes a block}.
int vitok_quantize_rows_f32_attributes(int C, int* out) {
  return (int)dispatch(nullptr, nullptr, nullptr, 1, C, 1, nullptr, out);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
