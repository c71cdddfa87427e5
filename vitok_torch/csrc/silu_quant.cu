// Fused SwiGLU gate + per-token dynamic symmetric int8 quantize over the
// fc1 output [M, 2F'] (v in channels [0, F'), g in [F', 2F')), bf16 or fp32.
//
// Replaces the TPU kernel vitok_tpu/ops/quant.py::_silu_quant_kernel
// (launcher fused_silu_quant). Same function, op for op:
//   v, g = float(hid[:F']), float(hid[F':]); t = silu(g) * v   (f32);
//   scale = max(absmax(t) / 127, 1e-12); q = clip(rint(t / scale), -127, 127)
// with the division, as the TPU kernel has it. silu(g) = g * sigmoid(g)
// (jax.nn.silu's definition), sigmoid as PyTorch's CUDA kernel computes it,
// 1 / (1 + exp(-g)) in IEEE fp32 ops (expf, not the fast __expf), so the
// plain version (fused_silu_quant_plain) gives the same codes.
//
// What bounds it on an H100: bytes. It reads the 2F' inputs once and writes
// F' int8 codes and one fp32 scale per row: at M = 16384, F' = 2816, bf16,
// 230.7 MB, about 0.069 ms at 3.35 TB/s; the exp, the reciprocal and the
// quantize take about as long. The design (row_stream.cuh): a persistent
// grid of row groups, one warp a row up to F' 2048 (a lane holds at most 64
// values of t), wider rows over two to eight warps joined by a named
// barrier; each row copied by cp.async into one of two row slots in shared
// memory while the group reduces the row before it; t computed once per
// element, from the slot, and kept in fp32 registers from the absmax to the
// quantize; the sigmoid's reciprocal from the approximate one and a Newton
// step, checked exactly, with the IEEE reciprocal only for a chunk the check
// refuses (sigmoid_rcp); the quantize as in rmsnorm_quant.cu; the absmax as
// warp shuffles; 16-byte int8 stores where a lane owns 16 adjacent channels
// (F' % 16 == 0), else 8-byte stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (vitok_torch/ops/_build.py). Plain C entry point, bound
// with ctypes; the launch is asynchronous on the caller's stream and the
// entry returns cudaGetLastError().

#include "row_stream.cuh"

namespace {

constexpr int kMaxFp = 16384;
constexpr int kTWords = 64;  // t values a lane holds in fp32 registers (quant.py _SILU_T_WORDS)
constexpr int kRegOverhead = 80;  // registers a thread needs beside its t values (the launch bounds' minimum blocks)

template <int V>
constexpr int silu_max_per() {
  return kTWords / V;
}

// 1 / d correctly rounded for the sigmoid's 1 <= d < 2^100, without the
// division's slow path: one Newton step from the approximate reciprocal
// gives r within 0.5 ulp + 2^-46 of 1 / d, so r is faithful and the residual
// e = 1 - d r is exact (one fma); r is the rounded 1 / d where |1 / d - r| =
// |e| / d is under half the gap below r (h, from the float below r: the gap
// above is as large or twice as large), an exact test as d * h is exact.
// `ok` is cleared where the test fails (and for d out of range or NaN): the
// caller then takes the IEEE reciprocal for the chunk.
__device__ __forceinline__ float sigmoid_rcp(float d, bool& ok) {
  const float r = faithful_rcp(d);
  const float e = __fmaf_rn(-d, r, 1.f);
  const float h = __uint_as_float(((__float_as_uint(r) - 1u) & 0x7f800000u) - (24u << 23));
  ok &= d < 0x1p100f && fabsf(e) < __fmul_rn(d, h);
  return r;
}

// t = (g * sigmoid(g)) * v over one chunk of the row in shared memory, with
// sigmoid(g) = rcp(1 + exp(-g)).
template <typename T, int V, typename Rcp>
__device__ __forceinline__ void swiglu(const unsigned char* vp, const unsigned char* gp, float (&t)[V], Rcp&& rcp) {
  Chunk<T, V> vc, gc;
  vc.load(vp);
  gc.load(gp);
  float v[V], g[V];
  vc.to_float(v);
  gc.to_float(g);
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = __fmul_rn(__fmul_rn(g[e], rcp(__fadd_rn(1.f, expf(-g[e])))), v[e]);
}

// Shared memory: the groups' rings, then each group's fp32 partials (groups
// of several warps).
template <typename T, int L>
__host__ __device__ inline int silu_smem_bytes(int Fp, int stages) {
  using G = RowGroup<L>;
  return G::kGroups * stages * 2 * Fp * (int)sizeof(T) + G::kGroups * G::kRedWarps * 4;
}

template <typename T, int V, int L, int P>
__global__ void __launch_bounds__(RowGroup<L>::kThreads, row_min_blocks(RowGroup<L>::kThreads, P * V, kRegOverhead))
silu_quant_kernel(const T* __restrict__ hid, int8_t* __restrict__ q, float* __restrict__ scale_out, int rows,
                  int Fp, int stages) {
  using G = RowGroup<L>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = 2 * Fp * (int)sizeof(T);
  float* red = reinterpret_cast<float*>(smem + G::kGroups * stages * row_bytes);

  const GroupLane<L> me;
  const int tid = me.tid, group = me.group, j = me.j;
  const int units = Fp / V;
  const int half = Fp * (int)sizeof(T);

  stream_rows<L>(reinterpret_cast<const unsigned char*>(hid), row_bytes, rows, me.gid, gridDim.x * G::kGroups,
                 smem + group * stages * row_bytes, stages, group, j, [] {},
                 [&](long long row, const unsigned char* slot) {
    float t[P][V];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int u = j + L * i;
      if (u < units) {
        const unsigned char* vp = slot + u * V * (int)sizeof(T);
        bool ok = true;
        swiglu<T, V>(vp, vp + half, t[i], [&](float d) { return sigmoid_rcp(d, ok); });
        if (!ok) swiglu<T, V>(vp, vp + half, t[i], [](float d) { return __frcp_rn(d); });
#pragma unroll
        for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(t[i][e]));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) t[i][e] = 0.f;
      }
    }
    amax = group_max<L>(amax, red + group * G::kRedWarps, group, tid);
    const float scale = token_scale(amax);
    const float rcp = faithful_rcp(scale);

    int8_t* qrow = q + row * Fp;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int u = j + L * i;
      if (u < units) store_codes<V>(qrow + u * V, t[i], scale, rcp);
    }
    if (j == 0) scale_out[row] = scale;
  });
}

struct SiluArgs {
  const void* hid;
  void* q;
  void* scale;
  int rows, Fp, stages, grid;
  cudaStream_t stream;
  int* attrs;  // non-null: report the instance's attributes instead of launching
};

template <typename T, int V>
struct SiluLaunch {
  SiluArgs a;
  template <int L, int P>
  cudaError_t run() {
    static int allowed[kMaxDevices] = {};
    const auto kernel = silu_quant_kernel<T, V, L, P>;
    const int smem = silu_smem_bytes<T, L>(a.Fp, a.stages);
    if ((P - 1) * L * V >= a.Fp || P * L * V < a.Fp) return cudaErrorInvalidValue;  // not the plan's split
    cudaError_t err = allow_smem(kernel, smem, allowed);
    if (err != cudaSuccess) return err;
    if (a.attrs) return row_attributes(kernel, RowGroup<L>::kThreads, smem, a.attrs);
    silu_quant_kernel<T, V, L, P><<<a.grid, RowGroup<L>::kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.hid), static_cast<int8_t*>(a.q), static_cast<float*>(a.scale), a.rows, a.Fp,
        a.stages);
    return cudaGetLastError();
  }
};

template <typename T, int V>
cudaError_t dispatch(const SiluArgs& a, int lanes, int per) {
  SiluLaunch<T, V> f{a};
  return with_split<silu_max_per<V>(), kMaxFp / V>(lanes, per, f);
}

cudaError_t dispatch(const SiluArgs& a, int dtype, int lanes, int vec, int per) {
  if (a.Fp < 8 || a.Fp > kMaxFp || a.Fp % vec || a.stages < 1 || a.stages > 2) return cudaErrorInvalidValue;
  if (dtype == 0 && vec == 16) return dispatch<__nv_bfloat16, 16>(a, lanes, per);
  if (dtype == 0 && vec == 8) return dispatch<__nv_bfloat16, 8>(a, lanes, per);
  if (dtype == 1 && vec == 16) return dispatch<float, 16>(a, lanes, per);
  if (dtype == 1 && vec == 8) return dispatch<float, 8>(a, lanes, per);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// hid [rows, 2*Fp] bf16 (dtype 0) or f32 (dtype 1), 16-byte aligned; q
// [rows, Fp] int8; scale [rows] f32. Fp a multiple of 8 up to 16384. The plan
// (lanes a row, vec channels a chunk, per chunks a lane, stages, grid) is
// silu_quant_plan's in vitok_torch/ops/quant.py; the launch runs on
// `device`. Returns the cudaError_t of the launch (0 = success).
int vitok_silu_quant(const void* hid, void* q, void* scale, int rows, int Fp, int dtype, int lanes, int vec, int per,
                     int stages, int grid, int device, void* stream) {
  if (rows < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const SiluArgs a{hid, q, scale, rows, Fp, stages, grid, static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch(a, dtype, lanes, vec, per);
}

// The plan's kernel instance on the current device: out = {registers a
// thread, spilled bytes a thread, blocks an SM hosts, shared bytes a block}.
int vitok_silu_quant_attributes(int Fp, int dtype, int lanes, int vec, int per, int stages, int* out) {
  const SiluArgs a{nullptr, nullptr, nullptr, 1, Fp, stages, 1, nullptr, out};
  return (int)dispatch(a, dtype, lanes, vec, per);
}

const char* vitok_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
