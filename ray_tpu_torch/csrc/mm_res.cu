// mm_res.cu — a . w + b + res in one kernel, for Hopper (sm_90a).
//
// Replaces the JAX package's block-exit Pallas kernel
//   ray_tpu/ops/fused.py::_mm_res_kernel
// (GPT's fused_entry_exit path: the attention projection and the MLP's output
// projection, each with the residual add fused into its output store).
//
// Layout: a [N, K], w [K, F], res and out [N, F], row-major and contiguous,
// all of one type (bf16 or f32); b [F] f32 (the wrapper, ops/fused.py, casts
// the bias, a bf16 cast of an f32 parameter, so the cast is exact). The
// wrapper checks K and F multiples of 64, contiguity and 16-byte alignment;
// any N.
//
// Arithmetic, as in the TPU kernel: a . w accumulated in f32; then + b and
// + res in f32, in that order; one cast to a's type.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): the product
// is 2*N*K*F FLOPs and the function must read a, w, b, res once and write out
// once. At GPT-2 small's training shapes, all bf16: a [40960, 768] with
// w [768, 768] (attention projection) is 48 GFLOP against 190 MB, so the
// bytes bound it (0.057 ms against 0.049 ms); a [40960, 3072] with
// w [3072, 768] (MLP out) is 193 GFLOP against 382 MB, bound by the
// operations (0.195 ms against 0.114 ms).
//
// Design (simple and right first; speed is later work): the tiled wmma GEMM
// of tile_gemm.cuh (128 x 128 output tiles of 8 warps, K in chunks of 32,
// two shared buffers and a register prefetch; FMA loops for f32) with an
// epilogue that reads the bias and the residual tile and adds both in f32
// before the one cast (16-byte loads and stores of res and out).
// Not done yet, and why it is slow: as ln_matmul.cu (wmma rather than wgmma
// and TMA, a two-deep pipeline through registers).

#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

// This thread's share of the A chunk a[m0.., k0:k0+BK], rows past N as
// zeros: fetched into registers, stored into shared memory as it is.
template <typename T>
struct CopyPrologue {
  using L = Smem<T>;
  const T* a;
  int N, K, m0, tid;
  uint4 v[L::A_VECS];

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < L::A_VECS; ++j) {
      int r, c;
      a_piece<T>(tid, j, r, c);
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < N)
        v[j] = *reinterpret_cast<const uint4*>(a + static_cast<long long>(m0 + r) * K + k0 + c);
    }
  }
  __device__ __forceinline__ void store(T* As) const {
#pragma unroll
    for (int j = 0; j < L::A_VECS; ++j) {
      int r, c;
      a_piece<T>(tid, j, r, c);
      *reinterpret_cast<uint4*>(As + r * L::AP + c) = v[j];
    }
  }
};

template <typename T>
struct BiasResidualEpilogue {
  const float* b;
  const T* res;
  int F;

  template <int n>
  __device__ __forceinline__ void operator()(float (&v)[n], int row, int col) const {
    const T* r = res + static_cast<long long>(row) * F + col;
    alignas(16) T rv[n];
    if constexpr (n * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(rv) = *reinterpret_cast<const uint4*>(r);
    } else {
#pragma unroll
      for (int e = 0; e < n; ++e) rv[e] = r[e];
    }
#pragma unroll
    for (int e = 0; e < n; ++e) v[e] = (v[e] + b[col + e]) + to_f(rv[e]);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
mm_res_kernel(const T* __restrict__ a, const T* __restrict__ w,
              const float* __restrict__ b, const T* __restrict__ res,
              T* __restrict__ out, int N, int K, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * Smem<T>::BM, n0 = blockIdx.x * BN;
  CopyPrologue<T> load_a{a, N, K, m0, static_cast<int>(threadIdx.x)};
  gemm_tile<T>(w, out, N, K, F, m0, n0, smem, load_a,
               BiasResidualEpilogue<T>{b, res, F});
}

template <typename T>
cudaError_t run(const void* a, const void* w, const void* b, const void* res,
                void* out, int N, int K, int F, cudaStream_t stream) {
  return launch<T>(mm_res_kernel<T>, Smem<T>::bytes(0), N, F, stream,
                static_cast<const T*>(a), static_cast<const T*>(w),
                static_cast<const float*>(b), static_cast<const T*>(res),
                static_cast<T*>(out), N, K, F);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of a, w, res and out). Returns the
// launch's cudaError_t.
extern "C" int mm_res(const void* a, const void* w, const void* b, const void* res,
                      void* out, int N, int K, int F, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<tile_gemm::bf16>(a, w, b, res, out, N, K, F, s);
  if (dtype == 0) return run<float>(a, w, b, res, out, N, K, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
