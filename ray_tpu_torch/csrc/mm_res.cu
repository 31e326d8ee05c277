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
// The f32-output instance (out_f32 = 1) is the tensor-parallel GPT's
// row-parallel exit (models/gpt.py): each rank's partial a . w of its rows of
// the weight, accumulated and returned in f32 for the all-reduce, + b and
// + res added in f32 only where the caller passes them (tp rank 0 passes
// both, the other ranks neither); the sum is rounded once, after the
// all-reduce. At GPT-2 small's tp=2 shapes, N = 8192, with b and res: a
// [8192, 384] with w [384, 768] moves 44.7 MB (the f32 output 25.2 MB of it)
// against 4.8 GFLOP, bound by the bytes (0.013 ms against 0.005 ms); a
// [8192, 1536] with w [1536, 768] moves 65.4 MB against 19.3 GFLOP, about
// even (0.0195 ms either way).
//
// Design:
//   - bf16: the warp-specialised wgmma GEMM of hopper_gemm.cuh, both operands
//     from shared memory by TMA; the producer prefetches the residual tile
//     by TMA during the K loop (the projection has only 12 steps of K and
//     is bound by its bytes, so the residual must not be waited for after
//     the products); epilogue (acc + b) + res in f32 from the registers and
//     the staged residual, one cast, TMA stores.
//   - bf16 operands, f32 out: the same GEMM's OUT32 instance, whose epilogue
//     adds what is given and stores f32 boxes by TMA (hopper_gemm.cuh).
//   - f32: the FMA GEMM of tile_gemm.cuh with an epilogue that reads the
//     bias and the residual and adds each in f32 where it is given.

#include "hopper_gemm.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int BN = 128;         // columns of the bf16 GEMM's output tile

// ---- f32: FMA GEMM -------------------------------------------------------------

using tile_gemm::Smem;

// This thread's share of the A chunk a[m0.., k0:k0+BK], rows past N as
// zeros: fetched into registers, stored into shared memory as it is.
struct CopyPrologue {
  const float* a;
  int N, K, m0, tid;
  float4 v[Smem::A_VECS];

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < Smem::A_VECS; ++j) {
      int r, c;
      tile_gemm::a_piece(tid, j, r, c);
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + r < N)
        v[j] = *reinterpret_cast<const float4*>(a + static_cast<long long>(m0 + r) * K + k0 + c);
    }
  }
  __device__ __forceinline__ void store(float* As) const {
#pragma unroll
    for (int j = 0; j < Smem::A_VECS; ++j) {
      int r, c;
      tile_gemm::a_piece(tid, j, r, c);
      *reinterpret_cast<float4*>(As + r * Smem::AP + c) = v[j];
    }
  }
};

// (v + b[col]) + res[row, col]; a null b or res is left out.
struct BiasResidualEpilogue {
  const float* b;
  const float* res;
  int F;
  __device__ __forceinline__ float operator()(float v, int row, int col) const {
    if (b != nullptr) v += b[col];
    if (res != nullptr) v += res[static_cast<long long>(row) * F + col];
    return v;
  }
};

__global__ void __launch_bounds__(tile_gemm::THREADS, 2)
mm_res_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ res,
                  float* __restrict__ out, int N, int K, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.y * tile_gemm::BM, n0 = blockIdx.x * tile_gemm::BN;
  CopyPrologue load_a{a, N, K, m0, static_cast<int>(threadIdx.x)};
  tile_gemm::gemm_tile(w, out, N, K, F, m0, n0, smem, load_a,
                       BiasResidualEpilogue{b, res, F});
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of a, w and res). out_f32: 0 = out in
// that type, b and res both given; 1 = out float32, b and res each may be
// null (left out). Returns the launch's cudaError_t (cudaErrorInvalidValue
// also when a tensor map cannot be encoded, or for a null b or res with a
// bf16 out).
extern "C" int mm_res(const void* a, const void* w, const void* b, const void* res,
                      void* out, int N, int K, int F, int dtype, int out_f32,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const hgemm::Params p{static_cast<const float*>(b), nullptr, nullptr, nullptr, N, K, F, 0};
    if (out_f32) return hgemm::launch<BN, false, true>(a, w, out, res, p, s);
    if (b == nullptr || res == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return hgemm::launch<BN, false>(a, w, out, res, p, s);
  }
  if (dtype == 0)
    return tile_gemm::launch(mm_res_f32_kernel, Smem::bytes(0), N, F, s,
                             static_cast<const float*>(a), static_cast<const float*>(w),
                             static_cast<const float*>(b), static_cast<const float*>(res),
                             static_cast<float*>(out), N, K, F);
  return static_cast<int>(cudaErrorInvalidValue);
}
