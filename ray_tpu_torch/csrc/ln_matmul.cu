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
// Design (simple and right first; speed is later work): two kernels, one
// launch of the wrapper.
//   - ln_stats_kernel: one warp per row reads x twice (16-byte loads) and
//     writes mean and rstd, f32, to the scratch: every row's statistics
//     once, instead of once for each of the F / 128 column tiles that
//     need them.
//   - ln_matmul_kernel: the tiled GEMM of tile_gemm.cuh (128 x 128 output
//     tiles of 8 warps, K in chunks of 32, two shared buffers and a
//     register prefetch, wmma 16x16x16 bf16 -> f32; f32 inputs: FMA
//     loops), the grid's x over column tiles so that neighbouring blocks
//     read the same rows of x from L2. Its A producer normalises each x
//     chunk in registers on the way into shared memory ((x - mean) * rstd
//     * g + b in f32, rounded to w's type), so shared memory does not grow
//     with D (a normalised [128, D] tile would not fit at GPT-2 xl's
//     D = 1600). Epilogue: acc + wb in f32, one cast, 16-byte stores.
// Not done yet, and why it is slow: wmma (mma.sync) rather than wgmma and
// TMA; a two-deep pipeline through registers rather than a ring of tiles in
// shared memory; x is renormalised for each column tile.

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

// mean and rstd of each row of x, one warp a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int N, int D, float eps) {
  constexpr int EPC = Smem<T>::EPC;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;
  const T* xr = x + static_cast<long long>(row) * D;
  float s = 0.0f;
  for (int c = lane * EPC; c < D; c += 32 * EPC) {
    alignas(16) T v[EPC];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < EPC; ++e) s += to_f(v[e]);
  }
  const float mu = warp_sum(s) / static_cast<float>(D);
  float s2 = 0.0f;
  for (int c = lane * EPC; c < D; c += 32 * EPC) {
    alignas(16) T v[EPC];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      const float d = to_f(v[e]) - mu;
      s2 = fmaf(d, d, s2);
    }
  }
  const float var = warp_sum(s2) / static_cast<float>(D);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(var + eps);
  }
}

// This thread's share of the A chunk: x[m0.., k0:k0+BK] fetched raw into
// registers, normalised on the store into shared memory.
template <typename T>
struct LnPrologue {
  using L = Smem<T>;
  const T* x;
  const float* g;
  const float* b;
  const float* mean;   // shared memory, the block's rows
  const float* rstd;
  int N, D, m0, tid;
  int k0;
  uint4 v[L::A_VECS];

  __device__ __forceinline__ void fetch(int k) {
    k0 = k;
#pragma unroll
    for (int j = 0; j < L::A_VECS; ++j) {
      int r, c;
      a_piece<T>(tid, j, r, c);
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < N)
        v[j] = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * D + k0 + c);
    }
  }
  __device__ __forceinline__ void store(T* As) const {
#pragma unroll
    for (int j = 0; j < L::A_VECS; ++j) {
      int r, c;
      a_piece<T>(tid, j, r, c);
      alignas(16) T h[L::EPC];
      *reinterpret_cast<uint4*>(h) = v[j];
      const float mu = mean[r], rs = rstd[r];
#pragma unroll
      for (int e = 0; e < L::EPC; ++e) {
        const float n = (to_f(h[e]) - mu) * rs;
        h[e] = from_f<T>(n * g[k0 + c + e] + b[k0 + c + e]);
      }
      *reinterpret_cast<uint4*>(As + r * L::AP + c) = *reinterpret_cast<const uint4*>(h);
    }
  }
};

struct BiasEpilogue {
  const float* wb;
  template <int n>
  __device__ __forceinline__ void operator()(float (&v)[n], int row, int col) const {
#pragma unroll
    for (int e = 0; e < n; ++e) v[e] += wb[col + e];
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const T* __restrict__ w,
                 const float* __restrict__ wb, const float* __restrict__ stats,
                 T* __restrict__ out, int N, int D, int F) {
  using L = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* mean = reinterpret_cast<float*>(smem + L::extra_off);
  float* rstd = mean + L::BM;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * BN;
  for (int r = tid; r < L::BM; r += THREADS) {
    const bool in = m0 + r < N;
    mean[r] = in ? stats[m0 + r] : 0.0f;
    rstd[r] = in ? stats[N + m0 + r] : 0.0f;
  }
  __syncthreads();
  LnPrologue<T> a{x, g, b, mean, rstd, N, D, m0, tid};
  gemm_tile<T>(w, out, N, D, F, m0, n0, smem, a, BiasEpilogue{wb});
}

template <typename T>
cudaError_t run(const void* x, const void* g, const void* b, const void* w,
                const void* wb, void* stats, void* out, int N, int D, int F,
                float eps, cudaStream_t stream) {
  float* mean = static_cast<float*>(stats);
  ln_stats_kernel<T><<<(N + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      static_cast<const T*>(x), mean, mean + N, N, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch<T>(ln_matmul_kernel<T>, Smem<T>::bytes(2 * Smem<T>::BM), N, F, stream,
                   static_cast<const T*>(x), static_cast<const float*>(g),
                   static_cast<const float*>(b), static_cast<const T*>(w),
                   static_cast<const float*>(wb), static_cast<const float*>(stats),
                   static_cast<T*>(out), N, D, F);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, w and out); stats: 2 * N floats of
// scratch. Returns the first failing launch's cudaError_t, or 0.
extern "C" int ln_matmul(const void* x, const void* g, const void* b, const void* w,
                         const void* wb, void* stats, void* out, int N, int D, int F,
                         int dtype, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<tile_gemm::bf16>(x, g, b, w, wb, stats, out, N, D, F, eps, s);
  if (dtype == 0) return run<float>(x, g, b, w, wb, stats, out, N, D, F, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
