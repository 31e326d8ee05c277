// tile_gemm.cuh — the f32 tiled GEMM that ln_matmul.cu and mm_res.cu share
// (their bf16 instances run on hopper_gemm.cuh).
//
// One thread block computes one [BM, BN] tile of out = A . W (A [N, K]
// row-major, W [K, F] row-major), looping over K in chunks of BK = 32, with
// plain FMA loops: the f32 contract is f32 arithmetic, not TF32. Each
// kernel brings its own A-chunk producer (the layernorm prologue of
// ln_matmul, a plain copy in mm_res) and its own epilogue (the bias, or the
// bias and the residual, added in f32).
//
//   - 64 x 128 tiles of 8 warps; each thread owns 4 rows x 8 columns
//     (columns tx + 16 j) in registers.
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

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tile_gemm {

constexpr int BM = 64;          // rows of a block's output tile
constexpr int BN = 128;         // columns of a block's output tile
constexpr int BK = 32;          // depth of one K chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int EPC = 4;          // floats per 16 bytes

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory layout (byte offsets). `extra` floats follow the tiles
// (ln_matmul's row statistics).
struct Smem {
  static constexpr int AP = BK + EPC;              // A chunk pitch (floats)
  static constexpr int BP = BN + EPC;              // W chunk pitch (floats)
  static constexpr int A_ELEMS = BM * AP;          // one A buffer
  static constexpr int W_ELEMS = BK * BP;          // one W buffer
  static constexpr int A_VECS = BM * BK / EPC / THREADS;   // 16-byte loads
  static constexpr int W_VECS = BK * BN / EPC / THREADS;   // a thread, a chunk
  static constexpr size_t b_off = align128(sizeof(float) * 2 * A_ELEMS);
  static constexpr size_t extra_off = align128(b_off + sizeof(float) * 2 * W_ELEMS);
  static constexpr size_t bytes(int extra) { return extra_off + sizeof(float) * extra; }
};

// This thread's share of the W chunk W[k0:k0+BK, n0:n0+BN]: fetch() into
// registers, store() into a shared buffer; columns past F as zeros.
struct WChunk {
  static constexpr int CPR = BN / EPC;             // 16-byte pieces per row
  const float* w;
  int F, n0, tid;
  float4 v[Smem::W_VECS];

  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int j = 0; j < Smem::W_VECS; ++j) {
      const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * EPC;
      v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (n0 + c < F)
        v[j] = *reinterpret_cast<const float4*>(w + static_cast<long long>(k0 + r) * F + n0 + c);
    }
  }
  __device__ __forceinline__ void store(float* Ws) const {
#pragma unroll
    for (int j = 0; j < Smem::W_VECS; ++j) {
      const int i = tid + j * THREADS, r = i / CPR, c = (i % CPR) * EPC;
      *reinterpret_cast<float4*>(Ws + r * Smem::BP + c) = v[j];
    }
  }
};

// The A chunk's 16-byte piece j of this thread: (row in the tile, column in
// the chunk).
__device__ __forceinline__ void a_piece(int tid, int j, int& r, int& c) {
  constexpr int CPR = BK / EPC;
  const int i = tid + j * THREADS;
  r = i / CPR;
  c = (i % CPR) * EPC;
}

// The block's tile of out = epi(A . W).
//   a.fetch(k0): load this thread's share of A[m0.., k0:k0+BK] into its
//     registers; a.store(As): write it into the shared A buffer (pitch
//     Smem::AP).
//   epi(v, row, col): v is the f32 sum for out[row, col]; it adds what the
//     kernel adds, in f32.
template <class LoadA, class Epi>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ w, float* __restrict__ out,
                                          int N, int K, int F, int m0, int n0,
                                          unsigned char* smem, LoadA& a, const Epi& epi) {
  using L = Smem;
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + L::b_off);
  const int tid = threadIdx.x;
  WChunk wc{w, F, n0, tid};
  const int chunks = K / BK;

  a.fetch(0);
  wc.fetch(0);
  a.store(As);
  wc.store(Ws);
  __syncthreads();

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
    const float* Ac = As + cur * L::A_ELEMS;
    const float* Wc = Ws + cur * L::W_ELEMS;
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Ac[(4 * ty + i) * L::AP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Wc[k * L::BP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      a.store(As + (cur ^ 1) * L::A_ELEMS);
      wc.store(Ws + (cur ^ 1) * L::W_ELEMS);
    }
    __syncthreads();  // the next chunk is in; this one is done with
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= F) continue;
      out[static_cast<long long>(row) * F + col] = epi(acc[i][j], row, col);
    }
  }
}

// Raise the kernel's dynamic shared memory limit, then launch it on a grid
// of (column tiles, row tiles): neighbouring blocks share A's rows.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t bytes, int N, int F, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((F + BN - 1) / BN, (N + BM - 1) / BM);
  kernel<<<grid, THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace tile_gemm
