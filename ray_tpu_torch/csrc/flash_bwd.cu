// flash_bwd.cu — flash attention backward for Hopper (sm_90a).
//
// Replaces the three backward Pallas kernels of the JAX package:
//   ray_tpu/ops/flash_attention.py::_bwd_fused_kernel (one K block, S <= block_k)
//   ray_tpu/ops/flash_attention.py::_bwd_dq_kernel    (dq over K blocks)
//   ray_tpu/ops/flash_attention.py::_bwd_dkv_kernel   (dk, dv over Q blocks)
// Together they compute dq, dk, dv from (q, k, v, dO, lse, delta); the two
// kernels below compute that function for every S. The TPU's fused kernel
// exists because its grid runs in order, so dk/dv can carry in scratch
// across Q blocks; here blocks run in no order, so the work is split by
// what a block owns, with no atomics and a fixed summation order:
//   flash_bwd_dkv_kernel: one block per (batch*head, 64-row K/V tile); it
//     loops over the Q tiles from the diagonal (causal) to the end and
//     accumulates dv += P^T.dO and dk += dS^T.q;
//   flash_bwd_dq_kernel: one block per (batch*head, 64-row Q tile); it
//     loops over the K/V tiles up to the diagonal and accumulates dq += dS.k.
// Both recompute S and P, as the TPU's two-pass scheme does.
//
// Layout: q, dO, dq [B, Sq, H, D] and k, v, dk, dv [B, Sk, H, D], contiguous
// (row stride H*D elements); lse and delta [B, H, Sq] f32. The wrapper
// (ops/flash_attention.py) checks dtype (bf16 or f32), D in {32, 64, 128},
// Sq and Sk multiples of 64, contiguity and 16-byte alignment, and computes
// delta = rowsum(dO * out) in f32 before the launch, as _flash_bwd does.
//
// Arithmetic, as in the TPU kernels: s = (q*scale, rounded to the input
// dtype) . k^T in f32; masked scores are -1e30; p = exp(s - lse);
// dv = p (cast to the input dtype)^T . dO and dp = dO . v^T, accumulated in
// f32; ds = p * (dp - delta) * scale, cast to the input dtype before both
// products; dq = ds . k and dk = ds^T . q with q UNSCALED; all accumulated
// in f32 and cast to the input dtype once at the end.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a causal
// backward does five products of 2*S^2*D FLOPs per head, halved by the
// mask, so 5*B*H*S^2*D FLOPs; it must read q, k, v, dO (bf16), lse and
// delta (f32) and write dq, dk, dv (bf16). At GPT-2 small's training shape
// [40, 1024, 12, 64] that is 161 GFLOP against 0.44 GB: operations bound
// it (0.163 ms against 0.131 ms). This design runs seven products (S and
// dP are recomputed in both kernels), all on the tensor cores for bf16.
//
// Design (simple and right first; speed is later work):
//   - 4 warps per block; each warp owns 16 rows of the block's own tile
//     (K rows in the dk/dv kernel, Q rows in the dq kernel) end to end.
//   - The dk/dv kernel computes in the transposed frame: S^T = K.(q*scale)^T
//     and dP^T = V.dO^T, so P^T and dS^T come out row-major in the warp's
//     own rows and dv += P^T.dO, dk += dS^T.q need no transposed loads of P.
//     Only q*scale and dO are read as col-major fragments (of row-major
//     tiles), as flash_fwd.cu reads K.
//   - bf16: every product on the tensor cores through nvcuda::wmma 16x16x16
//     (bf16 in, f32 accumulate); the dq/dk/dv accumulators stay in wmma
//     fragments (registers) across the loop and are staged through shared
//     memory once at the end. f32: plain FMA loops, lanes over columns,
//     accumulators in registers.
//   - S, dP (f32) and P, dS (bf16) make a round trip through shared memory
//     on every tile: wmma fragments have no portable element layout.
//   - Causal: tiles past the diagonal are never loaded, and only the
//     diagonal tile applies the mask.
//   - About 98 KB of shared memory for the dk/dv kernel and 80 KB for the
//     dq kernel at D = 64 in bf16 (138 KB and 111 KB at D = 128; f32 up to
//     167 KB), so launch() first raises each kernel's dynamic limit.
// Not done yet, and why it is slow: seven products where five would do;
// S/P/dP/dS round trips through shared memory; synchronous tile loads;
// at most two blocks (8 warps) an SM. A faster version keeps S, P, dP and
// dS in registers (mma.sync or wgmma with a known layout), double-buffers
// the streamed tiles with cp.async or TMA, and folds dq into the dk/dv pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TR = 64;          // rows of every tile (Q and K/V alike)
constexpr int WARPS = 4;        // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int SP = TR + 4;      // pitch of the f32 S / dP tiles
constexpr int PP = TR + 8;      // pitch of the bf16 P / dS tiles
constexpr float NEG_INF = -1e30f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
struct Pitch {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int KP = D + 16 / sizeof(T);   // q/k/v/dO tile row pitch
  static constexpr int OP = D + 4;                // f32 staging row pitch
  static constexpr size_t tile = sizeof(T) * TR * KP;
  static constexpr size_t f32_tile = sizeof(float) * TR * SP;
  static constexpr size_t b16_tile = kBf16 ? sizeof(bf16) * TR * PP : 0;
};

// Shared memory of the dk/dv kernel (byte offsets).
template <typename T, int D>
struct DkvLayout : Pitch<T, D> {
  using P = Pitch<T, D>;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + P::tile);
  static constexpr size_t q_off = align128(v_off + P::tile);
  static constexpr size_t do_off = align128(q_off + P::tile);
  static constexpr size_t qs_off = align128(do_off + P::tile);  // bf16: q*scale
  static constexpr size_t s_off = align128(qs_off + (P::kBf16 ? P::tile : 0));
  static constexpr size_t dp_off = align128(s_off + P::f32_tile);
  static constexpr size_t p_off = align128(dp_off + P::f32_tile);
  static constexpr size_t ds_off = align128(p_off + P::b16_tile);
  static constexpr size_t lse_off = align128(ds_off + P::b16_tile);
  static constexpr size_t delta_off = lse_off + sizeof(float) * TR;
  static constexpr size_t bytes = delta_off + sizeof(float) * TR;
  static_assert(sizeof(float) * TR * P::OP <= s_off, "staging overlaps S");
};

// Shared memory of the dq kernel (byte offsets).
template <typename T, int D>
struct DqLayout : Pitch<T, D> {
  using P = Pitch<T, D>;
  static constexpr size_t qs_off = 0;                            // q*scale
  static constexpr size_t do_off = align128(qs_off + P::tile);
  static constexpr size_t k_off = align128(do_off + P::tile);
  static constexpr size_t v_off = align128(k_off + P::tile);
  static constexpr size_t s_off = align128(v_off + P::tile);
  static constexpr size_t dp_off = align128(s_off + P::f32_tile);
  static constexpr size_t ds_off = align128(dp_off + P::f32_tile);
  static constexpr size_t lse_off = align128(ds_off + P::b16_tile);
  static constexpr size_t delta_off = lse_off + sizeof(float) * TR;
  static constexpr size_t bytes = delta_off + sizeof(float) * TR;
  static_assert(sizeof(float) * TR * P::OP <= s_off, "staging overlaps S");
};

// Copy 64 rows of D elements (global row stride `stride` elements) into
// shared memory with row pitch KP, 16 bytes per thread per step.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int tid) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  constexpr int KP = Pitch<T, D>::KP;
  for (int i = tid; i < TR * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    *reinterpret_cast<uint4*>(dst + r * KP + c * EPC) =
        *reinterpret_cast<const uint4*>(src + r * stride + c * EPC);
  }
}

// 64 floats of lse/delta row statistics (contiguous in global memory).
__device__ __forceinline__ void load_rows(float* dst, const float* src, int tid) {
  if (tid < TR) dst[tid] = src[tid];
}

// out[row0:row0+16, 0:64] = A[row0:row0+16, :] . B[0:64, :]^T  (bf16 tensor
// cores; A and B are row-major tiles, B read as col-major fragments).
template <int D>
__device__ __forceinline__ void abt_mma(const bf16* A, const bf16* B, float* out,
                                        int row0) {
  constexpr int KP = Pitch<bf16, D>::KP;
  for (int n = 0; n < TR / 16; ++n) {
    Acc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, A + row0 * KP + kk * 16, KP);
      wmma::load_matrix_sync(bt, B + n * 16 * KP + kk * 16, KP);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(out + row0 * SP + n * 16, acc, SP, wmma::mem_row_major);
  }
}

// acc[n] += A[row0:row0+16, 0:64] . B[0:64, 16n:16n+16]  (bf16 tensor cores;
// A is a bf16 P/dS tile, B a row-major q/k/dO tile).
template <int D>
__device__ __forceinline__ void ab_mma(const bf16* A, const bf16* B,
                                       Acc (&acc)[D / 16], int row0) {
  constexpr int KP = Pitch<bf16, D>::KP;
#pragma unroll
  for (int kk = 0; kk < TR / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + row0 * PP + kk * 16, PP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + kk * 16 * KP + n * 16, KP);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// f32: out[r][j] = sum_d A[r][d] * (B[j][d] * b_scale) for the warp's rows r
// and lane's columns j in {lane, lane + 32}.
template <int D>
__device__ __forceinline__ void abt_fma(const float* A, const float* B, float* out,
                                        int row0, int lane, float b_scale) {
  constexpr int KP = Pitch<float, D>::KP;
  const float* b0 = B + lane * KP;
  const float* b1 = B + (lane + 32) * KP;
  for (int r = row0; r < row0 + 16; ++r) {
    const float* ar = A + r * KP;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float x = ar[d];
      a0 = fmaf(x, b0[d] * b_scale, a0);
      a1 = fmaf(x, b1[d] * b_scale, a1);
    }
    out[r * SP + lane] = a0;
    out[r * SP + lane + 32] = a1;
  }
}

// f32: acc[r][t] += sum_i A[row0 + r][i] * B[i][lane + 32 t]  (A an f32 P/dS
// tile of pitch SP, B a row-major q/k/dO tile).
template <int D>
__device__ __forceinline__ void ab_fma(const float* A, const float* B,
                                       float (&acc)[16][D / 32], int row0,
                                       int lane) {
  constexpr int KP = Pitch<float, D>::KP;
  for (int i = 0; i < TR; ++i) {
    float b[D / 32];
#pragma unroll
    for (int t = 0; t < D / 32; ++t) b[t] = B[i * KP + lane + 32 * t];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[(row0 + r) * SP + i];
#pragma unroll
      for (int t = 0; t < D / 32; ++t) acc[r][t] = fmaf(a, b[t], acc[r][t]);
    }
  }
}

// Write the warp's 16 accumulated rows to global rows g[row0..row0+15] in T.
// bf16: fragments staged through `stage` (f32, pitch OP); the caller has
// synchronised the block so that the staging area is free.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* g, long long stride, const Acc (&acc)[D / 16],
                                           float* stage, int row0, int lane) {
  constexpr int OP = Pitch<T, D>::OP;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + row0 * OP + n * 16, acc[n], OP, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, c = i % D;
    g[r * stride + c] = from_f<T>(stage[r * OP + c]);
  }
  __syncwarp();
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* g, long long stride,
                                           const float (&acc)[16][D / 32], int row0,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < D / 32; ++t)
      g[(row0 + r) * stride + lane + 32 * t] = from_f<T>(acc[r][t]);
}

// Accumulators of one warp: wmma fragments for bf16, registers for f32.
template <typename T, int D>
struct WarpAcc {
  Acc frag[D / 16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(frag[n], 0.0f);
  }
};
template <int D>
struct WarpAcc<float, D> {
  float reg[16][D / 32];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int t = 0; t < D / 32; ++t) reg[r][t] = 0.0f;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk,
                     int causal, float sm_scale) {
  using L = DkvLayout<T, D>;
  constexpr int KP = L::KP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);      // q, unscaled (for dk)
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  T* QSs = reinterpret_cast<T*>(smem + L::qs_off);    // q*scale (bf16 only)
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);    // S^T, then P^T (f32)
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);  // dP^T, then dS^T (f32)
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);      // P^T (bf16)
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);    // dS^T (bf16)
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;          // this warp's first K row in the tile
  const int kt = blockIdx.x, k0 = kt * TR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const T* qg = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const T* dog = dout + (static_cast<long long>(b) * Sq * H + h) * D;
  const long long kv_base = (static_cast<long long>(b) * Sk * H + h) * D + k0 * stride;
  const float* lse_g = lse + static_cast<long long>(bh) * Sq;
  const float* delta_g = delta + static_cast<long long>(bh) * Sq;
  // q's scale in q's dtype, as the TPU kernels do (q * asarray(scale, dtype))
  const float scale_t = to_f(from_f<T>(sm_scale));

  load_tile<T, D>(Ks, k + kv_base, stride, tid);
  load_tile<T, D>(Vs, v + kv_base, stride, tid);
  WarpAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  // causal: Q tiles before the diagonal attend to none of these keys
  for (int qt = causal ? kt : 0; qt < Sq / TR; ++qt) {
    const int q0 = qt * TR;
    __syncthreads();  // K/V visible; the previous Q tile is done with
    load_tile<T, D>(Qs, qg + q0 * stride, stride, tid);
    load_tile<T, D>(dOs, dog + q0 * stride, stride, tid);
    load_rows(lse_s, lse_g + q0, tid);
    load_rows(delta_s, delta_g + q0, tid);
    __syncthreads();
    if constexpr (L::kBf16) {
      for (int i = tid; i < TR * D; i += THREADS) {
        const int at = (i / D) * KP + i % D;
        QSs[at] = from_f<T>(to_f(Qs[at]) * scale_t);
      }
      __syncthreads();
      abt_mma<D>(Ks, QSs, Ss, row0);   // S^T  = K . (q*scale)^T
      abt_mma<D>(Vs, dOs, dPs, row0);  // dP^T = V . dO^T
    } else {
      abt_fma<D>(Ks, Qs, Ss, row0, lane, scale_t);
      abt_fma<D>(Vs, dOs, dPs, row0, lane, 1.0f);
    }
    __syncwarp();

    // rows r: keys k0 + r; columns c: queries q0 + c
    const bool diag = causal && qt == kt;
    for (int r = row0; r < row0 + 16; ++r) {
      for (int c = lane; c < TR; c += 32) {
        float s = Ss[r * SP + c];
        if (diag && c < r) s = NEG_INF;  // query before key (q0 == k0 here)
        const float p = expf(s - lse_s[c]);
        const float ds = p * (dPs[r * SP + c] - delta_s[c]) * sm_scale;
        if constexpr (L::kBf16) {
          Ps[r * PP + c] = __float2bfloat16(p);
          dSs[r * PP + c] = __float2bfloat16(ds);
        } else {
          Ss[r * SP + c] = p;
          dPs[r * SP + c] = ds;
        }
      }
    }
    __syncwarp();
    if constexpr (L::kBf16) {
      ab_mma<D>(Ps, dOs, dv_acc.frag, row0);   // dv += P^T . dO
      ab_mma<D>(dSs, Qs, dk_acc.frag, row0);   // dk += dS^T . q
    } else {
      ab_fma<D>(Ss, dOs, dv_acc.reg, row0, lane);
      ab_fma<D>(dPs, Qs, dk_acc.reg, row0, lane);
    }
  }

  T* dkg = dk + kv_base;
  T* dvg = dv + kv_base;
  if constexpr (L::kBf16) {
    __syncthreads();  // every warp is done with the tiles: reuse as staging
    float* stage = reinterpret_cast<float*>(smem);
    store_rows<T, D>(dkg, stride, dk_acc.frag, stage, row0, lane);
    store_rows<T, D>(dvg, stride, dv_acc.frag, stage, row0, lane);
  } else {
    store_rows<T, D>(dkg, stride, dk_acc.reg, row0, lane);
    store_rows<T, D>(dvg, stride, dv_acc.reg, row0, lane);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Sq, int Sk, int causal,
                    float sm_scale) {
  using L = DqLayout<T, D>;
  constexpr int KP = L::KP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* QSs = reinterpret_cast<T*>(smem + L::qs_off);    // q*scale
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);    // S, then dS (f32)
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);  // dP
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds_off);    // dS (bf16)
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;          // this warp's first Q row in the tile
  // causal blocks with the most K tiles first: the grid's tail is short work
  const int qt = Sq / TR - 1 - static_cast<int>(blockIdx.x), q0 = qt * TR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long q_base = (static_cast<long long>(b) * Sq * H + h) * D + q0 * stride;
  const T* kg = k + (static_cast<long long>(b) * Sk * H + h) * D;
  const T* vg = v + (static_cast<long long>(b) * Sk * H + h) * D;
  const float scale_t = to_f(from_f<T>(sm_scale));

  load_tile<T, D>(QSs, q + q_base, stride, tid);
  load_tile<T, D>(dOs, dout + q_base, stride, tid);
  load_rows(lse_s, lse + static_cast<long long>(bh) * Sq + q0, tid);
  load_rows(delta_s, delta + static_cast<long long>(bh) * Sq + q0, tid);
  __syncthreads();
  for (int i = tid; i < TR * D; i += THREADS) {
    T* p = QSs + (i / D) * KP + i % D;
    *p = from_f<T>(to_f(*p) * scale_t);
  }
  WarpAcc<T, D> dq_acc;
  dq_acc.zero();

  const int n_tiles = causal ? qt + 1 : Sk / TR;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // scaled q visible; the previous K/V tile is done with
    load_tile<T, D>(Ks, kg + static_cast<long long>(t) * TR * stride, stride, tid);
    load_tile<T, D>(Vs, vg + static_cast<long long>(t) * TR * stride, stride, tid);
    __syncthreads();
    if constexpr (L::kBf16) {
      abt_mma<D>(QSs, Ks, Ss, row0);   // S  = (q*scale) . K^T
      abt_mma<D>(dOs, Vs, dPs, row0);  // dP = dO . V^T
    } else {
      abt_fma<D>(QSs, Ks, Ss, row0, lane, 1.0f);
      abt_fma<D>(dOs, Vs, dPs, row0, lane, 1.0f);
    }
    __syncwarp();

    // rows r: queries q0 + r; columns c: keys t*64 + c
    const bool diag = causal && t == qt;
    for (int r = row0; r < row0 + 16; ++r) {
      for (int c = lane; c < TR; c += 32) {
        float s = Ss[r * SP + c];
        if (diag && c > r) s = NEG_INF;  // key after query (same offsets here)
        const float p = expf(s - lse_s[r]);
        const float ds = p * (dPs[r * SP + c] - delta_s[r]) * sm_scale;
        if constexpr (L::kBf16) {
          dSs[r * PP + c] = __float2bfloat16(ds);
        } else {
          Ss[r * SP + c] = ds;
        }
      }
    }
    __syncwarp();
    if constexpr (L::kBf16) {
      ab_mma<D>(dSs, Ks, dq_acc.frag, row0);   // dq += dS . k
    } else {
      ab_fma<D>(Ss, Ks, dq_acc.reg, row0, lane);
    }
  }

  if constexpr (L::kBf16) {
    __syncthreads();  // every warp is done with the tiles: reuse as staging
    store_rows<T, D>(dq + q_base, stride, dq_acc.frag, reinterpret_cast<float*>(smem),
                     row0, lane);
  } else {
    store_rows<T, D>(dq + q_base, stride, dq_acc.reg, row0, lane);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                   int B, int H, int Sq, int Sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t dkv_bytes = DkvLayout<T, D>::bytes;
  constexpr size_t dq_bytes = DqLayout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  flash_bwd_dkv_kernel<T, D><<<dim3(Sk / TR, B * H), THREADS, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), H, Sq, Sk,
      causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(Sq / TR, B * H), THREADS, dq_bytes, stream>>>(
      qt, kt, vt, dot, lf, df, static_cast<T*>(dq), H, Sq, Sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches the dk/dv kernel, then the dq
// kernel, on `stream`; returns the first cudaError_t of the launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(T, DD)                                                      \
  case DD:                                                                         \
    return launch<T, DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, causal, \
                         sm_scale, s);
  if (dtype == 1) {
    switch (D) {
      FLASH_BWD_CASE(bf16, 32)
      FLASH_BWD_CASE(bf16, 64)
      FLASH_BWD_CASE(bf16, 128)
    }
  } else if (dtype == 0) {
    switch (D) {
      FLASH_BWD_CASE(float, 32)
      FLASH_BWD_CASE(float, 64)
      FLASH_BWD_CASE(float, 128)
    }
  }
#undef FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
