// tile_gemm.cuh — the tiled GEMM that ln_matmul.cu and mm_res.cu share.
//
// One thread block computes one [BM, BN] tile of out = A . W (A [N, K]
// row-major, W [K, F] row-major), looping over K in chunks of BK = 32. Each
// kernel brings its own A-chunk producer (the layernorm prologue of
// ln_matmul, a plain copy in mm_res) and its own epilogue (the bias, or the
// bias and the residual, added in f32 before the one cast).
//
//   - bf16: 128 x 128 tiles; 8 warps as 2 (rows) x 4 (columns), each warp
//     owns a 64 x 32 piece as 4 x 2 nvcuda::wmma 16x16x16 fragments (bf16
//     in, f32 accumulate) held in registers across the K loop. The
//     accumulators are staged through shared memory (which then holds no
//     A or W chunk) for the epilogue, 8 columns a thread.
//   - f32: 64 x 128 tiles and plain FMA loops (the f32 contract is f32
//     arithmetic, not TF32); each thread owns 4 rows x 8 columns (columns
//     tx + 16 j) in registers.
//   - Two shared buffers per operand and a register prefetch: while the
//     block multiplies chunk c from one buffer, each thread holds its share
//     of chunk c + 1 in registers (loaded from device memory before the
//     products, so the loads are in flight during them) and stores it into
//     the other buffer after them; one barrier per chunk. The A producer
//     transforms its registers on that store (the layernorm).
//   - Rows past N are read as zeros and never stored; columns past F (F a
//     multiple of 64, so the last tile may be half full) likewise. K is a
//     multiple of 32 (the wrappers check 64).
// The kernels' own files name the TPU kernels they replace and their bounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace tile_gemm {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BN = 128;         // columns of a block's output tile
constexpr int BK = 32;          // depth of one K chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }
constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Tile shape and shared memory layout for element type T (byte offsets).
// `extra` floats follow the tiles (ln_matmul's row statistics).
template <typename T>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int BM = kBf16 ? 128 : 64;     // rows of a block's tile
  static constexpr int EPC = 16 / sizeof(T);      // elements per 16 bytes
  static constexpr int AP = BK + EPC;              // A chunk pitch (elements)
  static constexpr int BP = BN + EPC;              // W chunk pitch (elements)
  static constexpr int CP = BN + 4;                // f32 staging pitch
  static constexpr int A_ELEMS = BM * AP;          // one A buffer
  static constexpr int W_ELEMS = BK * BP;          // one W buffer
  static constexpr int A_VECS = BM * BK / EPC / THREADS;   // 16-byte loads
  static constexpr int W_VECS = BK * BN / EPC / THREADS;   // a thread, a chunk
  static constexpr size_t b_off = align128(sizeof(T) * 2 * A_ELEMS);
  static constexpr size_t tiles = b_off + sizeof(T) * 2 * W_ELEMS;
  static constexpr size_t staging = kBf16 ? sizeof(float) * BM * CP : 0;
  static constexpr size_t extra_off = align128(max_size(tiles, staging));
  static constexpr size_t bytes(int extra) { return extra_off + sizeof(float) * extra; }
};

// This thread's share of the W chunk W[k0:k0+BK, n0:n0+BN]: fetch() into
// registers, store() into a shared buffer; columns past F as zeros.
template <typename T>
struct WChunk {
  using L = Smem<T>;
  static constexpr int CPR = BN / L::EPC;          // 16-byte pieces per row
  const T* w;
  int F, n0, tid;
  uint4 v[L::W_VECS];

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < L::W_VECS; ++j) {
      const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * L::EPC;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < F)
        v[j] = *reinterpret_cast<const uint4*>(w + static_cast<long long>(k0 + r) * F + n0 + c);
    }
  }
  __device__ __forceinline__ void store(T* Ws) const {
#pragma unroll
    for (int j = 0; j < L::W_VECS; ++j) {
      const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * L::EPC;
      *reinterpret_cast<uint4*>(Ws + r * L::BP + c) = v[j];
    }
  }
};

// The A chunk's 16-byte piece j of this thread: (row in the tile, column in
// the chunk).
template <typename T>
__device__ __forceinline__ void a_piece(int tid, int j, int& r, int& c) {
  using L = Smem<T>;
  constexpr int CPR = BK / L::EPC;
  const int i = tid + j * THREADS;
  r = i / CPR;
  c = (i % CPR) * L::EPC;
}

// The block's tile of out = epi(A . W).
//   a.fetch(k0): load this thread's share of A[m0.., k0:k0+BK] into its
//     registers; a.store(As): write it, as T, into the shared A buffer
//     (pitch Smem<T>::AP).
//   epi(v, row, col): v[0..n) are f32 sums for out[row, col .. col+n); it
//     adds what the kernel adds, in f32. n is 8 (bf16) or 1 (f32).
template <typename T, class LoadA, class Epi>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ w, T* __restrict__ out,
                                          int N, int K, int F, int m0, int n0,
                                          unsigned char* smem, LoadA& a, const Epi& epi) {
  using L = Smem<T>;
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + L::b_off);
  const int tid = threadIdx.x;
  WChunk<T> wc{w, F, n0, tid};
  const int chunks = K / BK;

  a.fetch(0);
  wc.fetch(0);
  a.store(As);
  wc.store(Ws);
  __syncthreads();

  if constexpr (L::kBf16) {
    const int warp = tid / 32, wm = (warp / 4) * 64, wn = (warp % 4) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int ch = 0; ch < chunks; ++ch) {
      const int cur = ch & 1;
      const bool more = ch + 1 < chunks;
      if (more) {
        a.fetch((ch + 1) * BK);
        wc.fetch((ch + 1) * BK);
      }
      const T* Ac = As + cur * L::A_ELEMS;
      const T* Wc = Ws + cur * L::W_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(af[i], Ac + (wm + 16 * i) * L::AP + kk, L::AP);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Wc + kk * L::BP + wn + 16 * j, L::BP);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      if (more) {
        a.store(As + (cur ^ 1) * L::A_ELEMS);
        wc.store(Ws + (cur ^ 1) * L::W_ELEMS);
      }
      __syncthreads();  // the next chunk is in; this one is done with
    }
    float* Cs = reinterpret_cast<float*>(smem);  // over the A and W buffers
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * L::CP + wn + 16 * j, acc[i][j],
                                L::CP, wmma::mem_row_major);
    __syncthreads();
    constexpr int CPR = BN / 8;
    for (int i = tid; i < L::BM * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= N || col >= F) continue;
      const float4 lo = *reinterpret_cast<const float4*>(Cs + r * L::CP + c);
      const float4 hi = *reinterpret_cast<const float4*>(Cs + r * L::CP + c + 4);
      float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      epi(v, row, col);
      alignas(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * F + col) =
          *reinterpret_cast<const uint4*>(o);
    }
  } else {
    const int ty = tid / 16, tx = tid % 16;  // rows 4 ty + i, columns tx + 16 j
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int cur = ch & 1;
      const bool more = ch + 1 < chunks;
      if (more) {
        a.fetch((ch + 1) * BK);
        wc.fetch((ch + 1) * BK);
      }
      const T* Ac = As + cur * L::A_ELEMS;
      const T* Wc = Ws + cur * L::W_ELEMS;
      for (int k = 0; k < BK; ++k) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(Ac[(4 * ty + i) * L::AP + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = to_f(Wc[k * L::BP + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) {
        a.store(As + (cur ^ 1) * L::A_ELEMS);
        wc.store(Ws + (cur ^ 1) * L::W_ELEMS);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + 4 * ty + i;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col >= F) continue;
        float v[1] = {acc[i][j]};
        epi(v, row, col);
        out[static_cast<long long>(row) * F + col] = from_f<T>(v[0]);
      }
    }
  }
}

// Raise the kernel's dynamic shared memory limit, then launch it on a grid
// of (column tiles, row tiles): neighbouring blocks share A's rows.
template <typename T, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t bytes, int N, int F, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + BN - 1) / BN, (N + Smem<T>::BM - 1) / Smem<T>::BM);
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tile_gemm
