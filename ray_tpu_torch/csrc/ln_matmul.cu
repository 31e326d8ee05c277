// ln_matmul.cu — layernorm(x; g, b) . w + wb, for Hopper (sm_90a).
//
// Replaces the JAX package's block-entry Pallas kernel
//   ray_tpu/ops/fused.py::_ln_matmul_kernel
// (GPT's fused_entry_exit path: LN1 + the QKV projection, LN2 + the FC
// projection). The normalised activation never goes to device memory.
//
// Layout: x [N, D], w [D, F], out [N, F], row-major and contiguous, all of one
// type (bf16 or f32); g, b [D] and wb [F] f32 (the wrapper, ops/fused.py,
// casts them: g and b are the f32 parameters, wb a bf16 cast of one, so the
// cast is exact); stats [2, N] f32 scratch from the wrapper. The wrapper
// checks D and F multiples of 64, contiguity and 16-byte alignment; any N.
//
// Arithmetic, as in the TPU kernel: per row, mean and variance in f32,
// two-pass (the mean, then the mean of squared deviations), rstd =
// rsqrt(var + eps); h = (x - mean) * rstd * g + b in f32, rounded to w's
// type; h . w accumulated in f32; + wb in f32; one cast to x's type.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the product
// is 2*N*D*F FLOPs and the function must read x, w, g, b, wb once and write
// out once. At GPT-2 small's training shapes, x [40960, 768] bf16 with
// w [768, 2304] (QKV) or [768, 3072] (FC), that is 145 GFLOP against 255 MB
// and 193 GFLOP against 319 MB: operations bound both (0.147 and 0.195 ms,
// against 0.076 and 0.095 ms for the bytes). So the kernel has to keep the
// tensor cores busy; the layernorm is a prologue.
//
// Design: two kernels, one launch of the wrapper.
//   - ln_stats_kernel: one warp a row keeps the row in registers (up to
//     1024 bf16 or 512 f32 values; the rest of a longer row is read again)
//     and writes mean and rstd, f32, to the scratch: every row's statistics
//     once, in one read of x, instead of once for each column tile.
//   - bf16: the warp-specialised wgmma GEMM of hopper_gemm.cuh with its
//     layernorm prologue: the raw x tile arrives by TMA, and each consumer
//     normalises its rows in registers (ldmatrix, then f32 arithmetic with
//     the row statistics in registers and g, b in the stage) into the
//     register A operand of wgmma; 128 x 256 output tiles, so each x tile
//     is normalised once for 256 columns; epilogue acc + wb in f32, one
//     cast, TMA stores.
//   - f32: the FMA GEMM of tile_gemm.cuh, whose A producer normalises each
//     x chunk on its way into shared memory.

#include "hopper_gemm.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int BN = 256;         // columns of the bf16 GEMM's output tile
constexpr int STATS_WARPS = 8;
constexpr int STATS_VECS = 4;   // 16-byte pieces of a row a lane keeps

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(hopper::bf16 x) { return __bfloat162float(x); }

// The values of a 16-byte piece of a row, as f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16 / sizeof(T)]) {
  alignas(16) T h[16 / sizeof(T)];
  *reinterpret_cast<uint4*>(h) = v;
#pragma unroll
  for (int e = 0; e < 16 / static_cast<int>(sizeof(T)); ++e) f[e] = to_f(h[e]);
}

// mean and rstd of each row of x, one warp a row: lane l sums pieces l,
// l + 32, ... of the row (the first STATS_VECS of them kept in registers
// for the second pass, the rest of a longer row read again), then the
// mean of squared deviations.
template <typename T>
__global__ void __launch_bounds__(STATS_WARPS * 32)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int N, int D, float eps) {
  constexpr int EPC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * STATS_WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + static_cast<long long>(row) * D;
  uint4 v[STATS_VECS];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < STATS_VECS; ++j) {
    const int c = (lane + 32 * j) * EPC;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (c < D) v[j] = *reinterpret_cast<const uint4*>(xr + c);
    float f[EPC];
    unpack<T>(v[j], f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) s += f[e];
  }
  for (int c = (lane + 32 * STATS_VECS) * EPC; c < D; c += 32 * EPC) {
    float f[EPC];
    unpack<T>(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) s += f[e];
  }
  const float mu = warp_sum(s) / static_cast<float>(D);
  float s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < STATS_VECS; ++j) {
    if ((lane + 32 * j) * EPC >= D) continue;
    float f[EPC];
    unpack<T>(v[j], f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const float d = f[e] - mu;
      s2 = fmaf(d, d, s2);
    }
  }
  for (int c = (lane + 32 * STATS_VECS) * EPC; c < D; c += 32 * EPC) {
    float f[EPC];
    unpack<T>(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const float d = f[e] - mu;
      s2 = fmaf(d, d, s2);
    }
  }
  const float var = warp_sum(s2) / static_cast<float>(D);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(var + eps);
  }
}

// ---- f32: FMA GEMM -------------------------------------------------------------

using tile_gemm::Smem;

// This thread's share of the A chunk: x[m0.., k0:k0+BK] fetched raw into
// registers, normalised on the store into shared memory.
struct LnPrologue {
  const float* x;
  const float* g;
  const float* b;
  const float* mean;   // shared memory, the block's rows
  const float* rstd;
  int N, D, m0, tid;
  int k0;
  float4 v[Smem::A_VECS];

  __device__ __forceinline__ void fetch(int k) {
    k0 = k;
#pragma unroll
    for (int j = 0; j < Smem::A_VECS; ++j) {
      int r, c;
      tile_gemm::a_piece(tid, j, r, c);
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + r < N)
        v[j] = *reinterpret_cast<const float4*>(x + static_cast<long long>(m0 + r) * D + k0 + c);
    }
  }
  __device__ __forceinline__ void store(float* As) const {
#pragma unroll
    for (int j = 0; j < Smem::A_VECS; ++j) {
      int r, c;
      tile_gemm::a_piece(tid, j, r, c);
      float h[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
      const float mu = mean[r], rs = rstd[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float n = (h[e] - mu) * rs;
        h[e] = n * g[k0 + c + e] + b[k0 + c + e];
      }
      *reinterpret_cast<float4*>(As + r * Smem::AP + c) = make_float4(h[0], h[1], h[2], h[3]);
    }
  }
};

struct BiasEpilogue {
  const float* wb;
  __device__ __forceinline__ float operator()(float v, int row, int col) const {
    return v + wb[col];
  }
};

__global__ void __launch_bounds__(tile_gemm::THREADS, 2)
ln_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, const float* __restrict__ w,
                     const float* __restrict__ wb, const float* __restrict__ stats,
                     float* __restrict__ out, int N, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* mean = reinterpret_cast<float*>(smem + Smem::extra_off);
  float* rstd = mean + tile_gemm::BM;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * tile_gemm::BM, n0 = blockIdx.x * tile_gemm::BN;
  for (int r = tid; r < tile_gemm::BM; r += tile_gemm::THREADS) {
    const bool in = m0 + r < N;
    mean[r] = in ? stats[m0 + r] : 0.0f;
    rstd[r] = in ? stats[N + m0 + r] : 0.0f;
  }
  __syncthreads();
  LnPrologue a{x, g, b, mean, rstd, N, D, m0, tid};
  tile_gemm::gemm_tile(w, out, N, D, F, m0, n0, smem, a, BiasEpilogue{wb});
}

template <typename T>
cudaError_t run(const void* x, const void* g, const void* b, const void* w,
                const void* wb, void* stats, void* out, int N, int D, int F,
                float eps, cudaStream_t stream) {
  float* mean = static_cast<float*>(stats);
  ln_stats_kernel<T><<<(N + STATS_WARPS - 1) / STATS_WARPS, STATS_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), mean, mean + N, N, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2) {
    const hgemm::Params p{static_cast<const float*>(wb), static_cast<const float*>(g),
                          static_cast<const float*>(b), mean, N, D, F};
    return hgemm::launch<BN, true>(x, w, out, nullptr, p, stream);
  } else {
    return tile_gemm::launch(ln_matmul_f32_kernel, Smem::bytes(2 * tile_gemm::BM), N, F,
                             stream, static_cast<const float*>(x),
                             static_cast<const float*>(g), static_cast<const float*>(b),
                             static_cast<const float*>(w), static_cast<const float*>(wb),
                             static_cast<const float*>(stats), static_cast<float*>(out), N,
                             D, F);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, w and out); stats: 2 * N floats of
// scratch. Returns the first failing launch's cudaError_t (also
// cudaErrorInvalidValue when a tensor map cannot be encoded), or 0.
extern "C" int ln_matmul(const void* x, const void* g, const void* b, const void* w,
                         const void* wb, void* stats, void* out, int N, int D, int F,
                         int dtype, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<hopper::bf16>(x, g, b, w, wb, stats, out, N, D, F, eps, s);
  if (dtype == 0) return run<float>(x, g, b, w, wb, stats, out, N, D, F, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
