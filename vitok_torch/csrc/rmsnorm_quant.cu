// Fused fp32 RMSNorm x gain + per-token dynamic symmetric int8 quantize.
//
// Replaces the TPU kernel vitok_tpu/ops/quant.py::_rmsnorm_quant_kernel
// (launcher fused_rmsnorm_quant). Same function, op for op:
//   x32 = float(x); var = float(sum(x32 * x32) / C); r = 1 / sqrt(var + eps);
//   y = (x32 * r) * gain; scale = max(absmax(y) / 127, 1e-12);
//   q = clip(rint(y / scale), -127, 127)   (division, round half to even).
// The sum of squares is taken in fp64, where the squares of bf16 and fp32
// values are exact, and rounded once to fp32; the square root and the
// divisions are IEEE. The plain version (fused_rmsnorm_quant_plain) does the
// same and adds the squares in this kernel's order (the fp64 sum of the
// squares can depend on it), so the two give the same codes: in a 28-block
// int8 model, one code in a million off by a step moves the output by a few
// percent. Against the TPU kernel's fp32 sum a code may differ by one step
// where y / scale lies within an ulp of a half.
//
// What bounds it on an H100: bytes. It reads the row once and writes the
// int8 row and one fp32 scale: at M = 16384 tokens, C = 1024, bf16, 50.4 MB,
// about 0.015 ms at 3.35 TB/s; the arithmetic is a few flops per byte.
// The design (row_stream.cuh): a persistent grid of row groups, one warp a
// row up to C 1536 (a lane holds at most 48 values of x, in fp32 registers,
// from the reduction to the quantize), wider rows over two to eight warps
// joined by a named barrier; each row copied by cp.async into one of two row
// slots in shared memory while the group reduces the row before it; the fp64
// sum of squares and the fp32 absmax as warp shuffles; the gain loaded once
// per block into shared memory, in an order in which the lanes of a warp
// read 16 consecutive bytes each; the quantize as a multiplication by 1 /
// scale, exact rounding decided without a division only for a chunk that
// holds a near-tie (row_stream.cuh, store_codes); 16-byte int8 stores where
// a lane owns 16 adjacent channels (C % 16 == 0), else 8-byte stores. No
// register array is live across the row's IEEE square root and divisions,
// whose slow paths are calls.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include "row_stream.cuh"

namespace {

constexpr int kMaxC = 8192;
constexpr int kXWords = 48;       // y values a lane holds in fp32 registers (quant.py _NORM_X_WORDS)
constexpr int kRegOverhead = 56;  // registers a thread needs beside them (the launch bounds' minimum blocks)

template <int V>
constexpr int norm_max_per() {
  return kXWords / V;
}

// Shared memory: the groups' rings, the gain, each group's fp64 and fp32
// partials (groups of several warps).
template <typename T, int V, int L, int P>
struct NormSmem {
  int ring, gain, red_sum, bytes;
  __host__ __device__ NormSmem(int C, int stages) {
    using G = RowGroup<L>;
    ring = G::kGroups * stages * C * (int)sizeof(T);
    gain = P * V * L * 4;
    red_sum = ring + gain;
    bytes = red_sum + G::kGroups * G::kRedWarps * (8 + 4);
  }
};

template <typename T, int V, int L, int P>
__global__ void __launch_bounds__(RowGroup<L>::kThreads, row_min_blocks(RowGroup<L>::kThreads, P * V, kRegOverhead))
rmsnorm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gain, int8_t* __restrict__ q,
                     float* __restrict__ scale_out, int rows, int C, float eps, int stages) {
  using G = RowGroup<L>;
  extern __shared__ __align__(16) unsigned char smem[];
  const NormSmem<T, V, L, P> lay(C, stages);
  float* gsm = reinterpret_cast<float*>(smem + lay.ring);
  double* red_sum = reinterpret_cast<double*>(smem + lay.red_sum);
  float* red_max = reinterpret_cast<float*>(red_sum + G::kGroups * G::kRedWarps);

  const GroupLane<L> me;
  const int tid = me.tid, group = me.group, j = me.j;
  const int units = C / V;
  const int row_bytes = C * (int)sizeof(T);

  // The gain, once a block, in shared memory, chunk i's float4 c of lane j
  // at ((i * V / 4 + c) * L + j): a warp reads 16 consecutive bytes a lane.
  // Staged while the first row's copies are in flight. (Held in registers,
  // it would be live across the square root and the divisions of each row,
  // whose slow paths are calls: registers would be saved around them.)
  auto stage_gain = [&]() {
    for (int k = tid; k < C / 4; k += G::kThreads) {
      const int u = k / (V / 4), c = k % (V / 4);
      reinterpret_cast<float4*>(gsm)[((u / L) * (V / 4) + c) * L + u % L] =
          __ldg(reinterpret_cast<const float4*>(gain) + k);
    }
    __syncthreads();
  };
  auto gain_of = [&](int i, float (&g)[V]) {
#pragma unroll
    for (int c = 0; c < V / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(gsm)[(i * (V / 4) + c) * L + j];
      g[4 * c] = v.x;
      g[4 * c + 1] = v.y;
      g[4 * c + 2] = v.z;
      g[4 * c + 3] = v.w;
    }
  };

  stream_rows<L>(reinterpret_cast<const unsigned char*>(x), row_bytes, rows, me.gid, gridDim.x * G::kGroups,
                 smem + group * stages * row_bytes, stages, group, j, stage_gain,
                 [&](long long row, const unsigned char* slot) {
    // Squares exact in fp64, added in the order fused_rmsnorm_quant_plain
    // follows: a lane's chunks and their channels in turn, then the
    // butterfly over the warp, then the warps' partials in warp order.
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int u = j + L * i;
      if (u < units) {
        Chunk<T, V> c;
        c.load(slot + u * V * (int)sizeof(T));
        float f[V];
        c.to_float(f);
#pragma unroll
        for (int e = 0; e < V; ++e) ss += (double)f[e] * (double)f[e];
      }
    }
    // No chunk is held across the IEEE square root and divisions (their
    // slow paths are calls): pass 2 reads the slot again.
    asm volatile("" ::: "memory");
    ss = group_sum<L>(ss, red_sum + group * G::kRedWarps, group, tid);
    const float var = __double2float_rn(ss / (double)C);
    const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

    float y[P][V];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int u = j + L * i;
      if (u < units) {
        Chunk<T, V> c;
        c.load(slot + u * V * (int)sizeof(T));
        c.to_float(y[i]);
        float g[V];
        gain_of(i, g);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          y[i][e] = __fmul_rn(__fmul_rn(y[i][e], r), g[e]);
          amax = fmaxf(amax, fabsf(y[i][e]));
        }
      }
    }
    amax = group_max<L>(amax, red_max + group * G::kRedWarps, group, tid);
    const float scale = token_scale(amax);
    const float rcp = faithful_rcp(scale);

    int8_t* qrow = q + row * C;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int u = j + L * i;
      if (u < units) store_codes<V>(qrow + u * V, y[i], scale, rcp);
    }
    if (j == 0) scale_out[row] = scale;
  });
}

struct NormArgs {
  const void* x;
  const void* gain;
  void* q;
  void* scale;
  int rows, C;
  float eps;
  int stages, grid;
  cudaStream_t stream;
  int* attrs;  // non-null: report the instance's attributes instead of launching
};

template <typename T, int V>
struct NormLaunch {
  NormArgs a;
  template <int L, int P>
  cudaError_t run() {
    static int allowed[kMaxDevices] = {};
    const auto kernel = rmsnorm_quant_kernel<T, V, L, P>;
    const int smem = NormSmem<T, V, L, P>(a.C, a.stages).bytes;
    if ((P - 1) * L * V >= a.C || P * L * V < a.C) return cudaErrorInvalidValue;  // not the plan's split
    cudaError_t err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    if (a.attrs) return row_attributes(kernel, RowGroup<L>::kThreads, smem, a.attrs);
    rmsnorm_quant_kernel<T, V, L, P><<<a.grid, RowGroup<L>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const float*>(a.gain), static_cast<int8_t*>(a.q),
        static_cast<float*>(a.scale), a.rows, a.C, a.eps, a.stages);
    return cudaGetLastError();
  }
};

template <typename T, int V>
cudaError_t dispatch(const NormArgs& a, int lanes, int per) {
  NormLaunch<T, V> f{a};
  return with_split<norm_max_per<V>(), kMaxC / V>(lanes, per, f);
}

cudaError_t dispatch(const NormArgs& a, int dtype, int lanes, int vec, int per) {
  if (a.C < 8 || a.C > kMaxC || a.C % vec || a.stages < 1 || a.stages > 2) return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 16) return dispatch<__nv_bfloat16, 16>(a, lanes, per);
  if (dtype == 0 && vec == 8) return dispatch<__nv_bfloat16, 8>(a, lanes, per);
  if (dtype == 1 && vec == 16) return dispatch<float, 16>(a, lanes, per);
  if (dtype == 1 && vec == 8) return dispatch<float, 8>(a, lanes, per);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [rows, C] bf16 (dtype 0) or f32 (dtype 1), 16-byte aligned; gain [C] f32,
// 16-byte aligned; q [rows, C] int8; scale [rows] f32. C a multiple of 8 up
// to 8192. The plan (lanes a row, vec channels a chunk, per chunks a lane,
// stages, grid) is rmsnorm_quant_plan's in vitok_torch/ops/quant.py; the
// launch runs on `device`. Returns the cudaError_t of the launch (0 =
// success).
int vitok_rmsnorm_quant(const void* x, const void* gain, void* q, void* scale, int rows, int C, float eps, int dtype,
                        int lanes, int vec, int per, int stages, int grid, int device, void* stream) {
  if (rows < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const NormArgs a{x, gain, q, scale, rows, C, eps, stages, grid, static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch(a, dtype, lanes, vec, per);
}

// The plan's kernel instance on the current device: out = {registers a
// thread, spilled bytes a thread, blocks an SM hosts, shared bytes a block}.
int vitok_rmsnorm_quant_attributes(int C, int dtype, int lanes, int vec, int per, int stages, int* out) {
  const NormArgs a{nullptr, nullptr, nullptr, nullptr, 1, C, 0.f, stages, 1, nullptr, out};
  return (int)dispatch(a, dtype, lanes, vec, per);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
