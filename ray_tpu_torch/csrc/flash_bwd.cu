// flash_bwd.cu — flash attention backward for Hopper (sm_90a).
//
// Replaces the three backward Pallas kernels of the JAX package:
//   ray_tpu/ops/flash_attention.py::_bwd_fused_kernel (one K block, S <= block_k)
//   ray_tpu/ops/flash_attention.py::_bwd_dq_kernel    (dq over K blocks)
//   ray_tpu/ops/flash_attention.py::_bwd_dkv_kernel   (dk, dv over Q blocks)
// Together they compute dq, dk, dv from (q, k, v, dO, lse, delta); the two
// kernels of each path below compute that function for every S. The TPU's
// fused kernel exists because its grid runs in order, so dk/dv can carry in
// scratch across Q blocks; here blocks run in no order, so the work is split
// by what a block owns, with no atomics and a fixed summation order (the
// gradients are bitwise reproducible, as the JAX reference's are):
//   the dk/dv kernel: one block per (batch*head, K/V tile); it loops over
//     the Q tiles from the diagonal (causal) to the end and accumulates
//     dv += P^T.dO and dk += dS^T.q;
//   the dq kernel: one block per (batch*head, Q tile); it loops over the K/V
//     tiles up to the diagonal and accumulates dq += dS.k.
// Both recompute S and dP, as the TPU's two-pass scheme does: seven products
// where a kernel that sums dq across K/V tiles with atomics would need five.
//
// Layout: q, qs, dO, dq [B, Sq, H, D] and k, v, dk, dv [B, Sk, H, D],
// contiguous (row stride H*D elements); lse and delta [B, H, Sq] f32. The
// wrapper (ops/flash_attention.py) checks dtype (bf16 or f32), D in
// {32, 64, 128}, Sq and Sk multiples of 64, contiguity and 16-byte
// alignment, and computes before the launch delta = rowsum(dO * out) in f32,
// as _flash_bwd does, and qs = q * scale rounded to the input dtype, the
// rounding the TPU kernels make (q * asarray(scale, dtype)).
//
// Arithmetic, as in the TPU kernels: s = qs . k^T in f32; masked scores are
// -1e30 (p = 0); p = exp(s - lse); dv = p (cast to the input dtype)^T . dO and
// dp = dO . v^T, accumulated in f32; ds = p * (dp - delta) * scale, cast to
// the input dtype before both products; dq = ds . k and dk = ds^T . q with q
// UNSCALED; all accumulated in f32 and cast to the input dtype once at the end.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a causal
// backward needs five products of 2*S^2*D FLOPs per head, halved by the
// mask, so 5*B*H*S^2*D FLOPs; it must read q, k, v, dO (bf16), lse and
// delta (f32) and write dq, dk, dv (bf16). At GPT-2 small's training shape
// [40, 1024, 12, 64] that is 161 GFLOP against 0.44 GB: operations bound it
// (0.163 ms against 0.131 ms); the seven products of this split raise the
// floor to 0.228 ms.
//
// Design of the bf16 kernels (warp-specialised, as flash_fwd.cu):
//   - Three warpgroups a block: two consumers of 64 rows each (K/V rows in
//     the dk/dv kernel, Q rows in the dq kernel) and a producer whose one
//     thread issues every load: TMA boxes (hopper.cuh) of the block's own
//     tiles once, then the streamed tiles through a ring of three stages
//     under full and empty mbarriers (the dk/dv kernel also bulk-copies the
//     64 lse and delta values of each Q tile into the stage).
//   - Every product is a wgmma on the consumer's 64-row tile. dk/dv kernel,
//     in the transposed frame (rows are keys): S^T = K.qs^T and dP^T = V.dO^T
//     (both operands in shared memory, K-major); P^T = exp(S^T - lse) and dS^T
//     in registers, rounded to bf16, are the register A operands of
//     dV += P^T.dO and dK += dS^T.q (dO and q read MN-major through the
//     transpose bit). dq kernel: S = qs.K^T and dP = dO.V^T, then
//     dQ += dS.K (K read MN-major). S, P, dP, dS and the dK, dV, dQ
//     accumulators stay in registers; nothing goes through shared memory.
//     The loop is software-pipelined: a tile's accumulating products
//     (dV, dK or dQ) stay in flight while the next tile's S and dP are
//     issued, and its stage is released when they are done.
//   - Causal: tiles past the diagonal are never loaded, and only tiles that
//     cross it (or a ragged end) are masked. At D <= 64 a block owns two of
//     its own tiles, the longest causal one and the shortest (the last and
//     the first Q tiles in the dq kernel, the first and the last K/V tiles
//     in the dk/dv kernel; hopper.cuh), loaded at once. At D = 128 a block
//     owns one, longest first.
//   - 128 K/V rows x 64 Q rows a step in the dk/dv kernel, 128 Q rows x 128
//     K/V rows in the dq kernel (64 K/V rows at D = 128, for registers).
// The f32 kernels are not on a main path: 4 warps per 64-row tile, S and dP
// through shared memory, FMA loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---- f32: FMA loops --------------------------------------------------------------

namespace f32 {

constexpr int TR = 64;          // rows of every tile (Q and K/V alike)
constexpr int WARPS = 4;        // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr int SP = TR + 4;      // pitch of the S / dP tiles

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <int D>
struct Pitch {
  static constexpr int KP = D + 4;   // q/k/v/dO tile row pitch
  static constexpr size_t tile = sizeof(float) * TR * KP;
  static constexpr size_t s_tile = sizeof(float) * TR * SP;
};

template <int D>
struct DkvLayout : Pitch<D> {
  using P = Pitch<D>;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + P::tile);
  static constexpr size_t q_off = align128(v_off + P::tile);
  static constexpr size_t do_off = align128(q_off + P::tile);
  static constexpr size_t s_off = align128(do_off + P::tile);
  static constexpr size_t dp_off = align128(s_off + P::s_tile);
  static constexpr size_t lse_off = align128(dp_off + P::s_tile);
  static constexpr size_t delta_off = lse_off + sizeof(float) * TR;
  static constexpr size_t bytes = delta_off + sizeof(float) * TR;
};

template <int D>
struct DqLayout : Pitch<D> {
  using P = Pitch<D>;
  static constexpr size_t qs_off = 0;                            // q*scale
  static constexpr size_t do_off = align128(qs_off + P::tile);
  static constexpr size_t k_off = align128(do_off + P::tile);
  static constexpr size_t v_off = align128(k_off + P::tile);
  static constexpr size_t s_off = align128(v_off + P::tile);
  static constexpr size_t dp_off = align128(s_off + P::s_tile);
  static constexpr size_t lse_off = align128(dp_off + P::s_tile);
  static constexpr size_t delta_off = lse_off + sizeof(float) * TR;
  static constexpr size_t bytes = delta_off + sizeof(float) * TR;
};

// Copy 64 rows of D floats (global row stride `stride`) into shared memory
// with row pitch KP, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int tid) {
  constexpr int CPR = D / 4;
  constexpr int KP = Pitch<D>::KP;
  for (int i = tid; i < TR * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    *reinterpret_cast<float4*>(dst + r * KP + c * 4) =
        *reinterpret_cast<const float4*>(src + r * stride + c * 4);
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int tid) {
  if (tid < TR) dst[tid] = src[tid];
}

// out[r][j] = sum_d A[r][d] * (B[j][d] * b_scale) for the warp's rows r and
// lane's columns j in {lane, lane + 32}.
template <int D>
__device__ __forceinline__ void abt(const float* A, const float* B, float* out, int row0,
                                    int lane, float b_scale) {
  constexpr int KP = Pitch<D>::KP;
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

// acc[r][t] += sum_i A[row0 + r][i] * B[i][lane + 32 t]  (A a P/dS tile of
// pitch SP, B a row-major q/k/dO tile).
template <int D>
__device__ __forceinline__ void ab(const float* A, const float* B, float (&acc)[16][D / 32],
                                   int row0, int lane) {
  constexpr int KP = Pitch<D>::KP;
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

template <int D>
__device__ __forceinline__ void zero(float (&acc)[16][D / 32]) {
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < D / 32; ++t) acc[r][t] = 0.0f;
}

template <int D>
__device__ __forceinline__ void store_rows(float* g, long long stride,
                                           const float (&acc)[16][D / 32], int row0,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < D / 32; ++t) g[(row0 + r) * stride + lane + 32 * t] = acc[r][t];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                         int Sk, int causal, float sm_scale) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);      // q, unscaled
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);      // S^T, then P^T
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);    // dP^T, then dS^T
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;          // this warp's first K row in the tile
  const int kt = blockIdx.x, k0 = kt * TR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const float* qg = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const float* dog = dout + (static_cast<long long>(b) * Sq * H + h) * D;
  const long long kv_base = (static_cast<long long>(b) * Sk * H + h) * D + k0 * stride;
  const float* lse_g = lse + static_cast<long long>(bh) * Sq;
  const float* delta_g = delta + static_cast<long long>(bh) * Sq;

  load_tile<D>(Ks, k + kv_base, stride, tid);
  load_tile<D>(Vs, v + kv_base, stride, tid);
  float dk_acc[16][D / 32], dv_acc[16][D / 32];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  // causal: Q tiles before the diagonal attend to none of these keys
  for (int qt = causal ? kt : 0; qt < Sq / TR; ++qt) {
    const int q0 = qt * TR;
    __syncthreads();  // K/V visible; the previous Q tile is done with
    load_tile<D>(Qs, qg + q0 * stride, stride, tid);
    load_tile<D>(dOs, dog + q0 * stride, stride, tid);
    load_rows(lse_s, lse_g + q0, tid);
    load_rows(delta_s, delta_g + q0, tid);
    __syncthreads();
    abt<D>(Ks, Qs, Ss, row0, lane, sm_scale);   // S^T  = K . (q*scale)^T
    abt<D>(Vs, dOs, dPs, row0, lane, 1.0f);     // dP^T = V . dO^T
    __syncwarp();

    // rows r: keys k0 + r; columns c: queries q0 + c
    const bool diag = causal && qt == kt;
    for (int r = row0; r < row0 + 16; ++r) {
      for (int c = lane; c < TR; c += 32) {
        float s = Ss[r * SP + c];
        if (diag && c < r) s = NEG_INF;  // query before key (q0 == k0 here)
        const float p = expf(s - lse_s[c]);
        Ss[r * SP + c] = p;
        dPs[r * SP + c] = p * (dPs[r * SP + c] - delta_s[c]) * sm_scale;
      }
    }
    __syncwarp();
    ab<D>(Ss, dOs, dv_acc, row0, lane);   // dv += P^T . dO
    ab<D>(dPs, Qs, dk_acc, row0, lane);   // dk += dS^T . q
  }
  store_rows<D>(dk + kv_base, stride, dk_acc, row0, lane);
  store_rows<D>(dv + kv_base, stride, dv_acc, row0, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Sk, int causal,
                        float sm_scale) {
  using L = DqLayout<D>;
  constexpr int KP = L::KP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* QSs = reinterpret_cast<float*>(smem + L::qs_off);    // q*scale
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);      // S, then dS
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;          // this warp's first Q row in the tile
  // causal blocks with the most K tiles first: the grid's tail is short work
  const int qt = Sq / TR - 1 - static_cast<int>(blockIdx.x), q0 = qt * TR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const long long q_base = (static_cast<long long>(b) * Sq * H + h) * D + q0 * stride;
  const float* kg = k + (static_cast<long long>(b) * Sk * H + h) * D;
  const float* vg = v + (static_cast<long long>(b) * Sk * H + h) * D;

  load_tile<D>(QSs, q + q_base, stride, tid);
  load_tile<D>(dOs, dout + q_base, stride, tid);
  load_rows(lse_s, lse + static_cast<long long>(bh) * Sq + q0, tid);
  load_rows(delta_s, delta + static_cast<long long>(bh) * Sq + q0, tid);
  __syncthreads();
  for (int i = tid; i < TR * D; i += THREADS) QSs[(i / D) * KP + i % D] *= sm_scale;
  float dq_acc[16][D / 32];
  zero<D>(dq_acc);

  const int n_tiles = causal ? qt + 1 : Sk / TR;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // scaled q visible; the previous K/V tile is done with
    load_tile<D>(Ks, kg + static_cast<long long>(t) * TR * stride, stride, tid);
    load_tile<D>(Vs, vg + static_cast<long long>(t) * TR * stride, stride, tid);
    __syncthreads();
    abt<D>(QSs, Ks, Ss, row0, lane, 1.0f);   // S  = (q*scale) . K^T
    abt<D>(dOs, Vs, dPs, row0, lane, 1.0f);  // dP = dO . V^T
    __syncwarp();

    // rows r: queries q0 + r; columns c: keys t*64 + c
    const bool diag = causal && t == qt;
    for (int r = row0; r < row0 + 16; ++r) {
      for (int c = lane; c < TR; c += 32) {
        float s = Ss[r * SP + c];
        if (diag && c > r) s = NEG_INF;  // key after query (same offsets here)
        const float p = expf(s - lse_s[r]);
        Ss[r * SP + c] = p * (dPs[r * SP + c] - delta_s[r]) * sm_scale;
      }
    }
    __syncwarp();
    ab<D>(Ss, Ks, dq_acc, row0, lane);   // dq += dS . k
  }
  store_rows<D>(dq + q_base, stride, dq_acc, row0, lane);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                   int B, int H, int Sq, int Sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t dkv_bytes = DkvLayout<D>::bytes;
  constexpr size_t dq_bytes = DqLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  flash_bwd_f32_dkv_kernel<D><<<dim3(Sk / TR, B * H), THREADS, dkv_bytes, stream>>>(
      qf, kf, vf, dof, lf, df, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq,
      Sk, causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_f32_dq_kernel<D><<<dim3(Sq / TR, B * H), THREADS, dq_bytes, stream>>>(
      qf, kf, vf, dof, lf, df, static_cast<float*>(dq), H, Sq, Sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16: warp-specialised wgmma ------------------------------------------------

namespace wg {

using namespace hopper;

// Two consumer warpgroups of 64 rows and one producer warpgroup a block, one
// block an SM: the launch budget is 168 registers a thread, and setmaxnreg
// moves the producer's to the consumers (a block of one consumer, two
// blocks an SM, measured slower: each streamed tile then serves half the
// rows).
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MIN_BLOCKS = 1;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Writes a warpgroup's [64 x D] f32 accumulator (boxes of W columns) as bf16
// rows `row` and `row + 8` of a [.., H, D] tensor, rows below `rows` only.
template <int D>
__device__ __forceinline__ void store_acc(bf16* g, const float (&acc)[TileGeom<D>::BOXES]
                                                                  [TileGeom<D>::W / 2],
                                          int row, int rows, long long stride, int h,
                                          int col_lane) {
  using G = TileGeom<D>;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row + 8 * hr;
    if (r >= rows) continue;
    bf16* gr = g + r * stride + static_cast<long long>(h) * D;
#pragma unroll
    for (int x = 0; x < G::BOXES; ++x)
#pragma unroll
      for (int i = 0; i < G::W / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(gr + x * G::W + 8 * i + col_lane) =
            __floats2bfloat162_rn(acc[x][4 * i + 2 * hr], acc[x][4 * i + 2 * hr + 1]);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[TileGeom<D>::BOXES][TileGeom<D>::W / 2]) {
#pragma unroll
  for (int x = 0; x < TileGeom<D>::BOXES; ++x)
#pragma unroll
    for (int i = 0; i < TileGeom<D>::W / 2; ++i) acc[x][i] = 0.0f;
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[TileGeom<D>::BOXES][TileGeom<D>::W / 2]) {
#pragma unroll
  for (int x = 0; x < TileGeom<D>::BOXES; ++x) fence_regs(acc[x]);
}

// ---- dk/dv: a block owns K/V tiles of 128 rows, Q streamed in tiles of 64 ----

namespace dkv {

constexpr int BN = 64 * CONSUMERS;   // K/V rows per owned tile
constexpr int BM = 64;               // Q rows per streamed tile (Sq is a multiple)

template <int D>
struct Smem {
  static constexpr int ITEMS = D == 128 ? 1 : 2;              // owned K/V tiles
  static constexpr int STAGES = 3;                            // Q-side ring
  static constexpr size_t kv_tile = sizeof(bf16) * BN * D;
  static constexpr size_t q_tile = sizeof(bf16) * BM * D;
  static constexpr size_t k_off = 0;               // K, V of item i at 2i, 2i + 1 tiles
  static constexpr size_t qs_off = ITEMS * 2 * kv_tile;       // + stage * q_tile
  static constexpr size_t q_off = qs_off + STAGES * q_tile;
  static constexpr size_t do_off = q_off + STAGES * q_tile;
  static constexpr size_t lse_off = do_off + STAGES * q_tile;  // + stage * BM floats
  static constexpr size_t delta_off = lse_off + STAGES * BM * sizeof(float);
  static constexpr size_t bar_off = delta_off + STAGES * BM * sizeof(float);
  // kv_full[ITEMS], full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar_off + 8 * (ITEMS + 2 * STAGES);
  static constexpr size_t alloc = bytes + 1024;
  static constexpr uint32_t stage_tx = 3 * q_tile + 2 * BM * sizeof(float);
  static_assert(kv_tile % 1024 == 0 && q_tile % 1024 == 0, "boxes on 1024-byte lines");
};

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_qs,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                     int causal, float sm_scale) {
  using S = Smem<D>;
  using G = TileGeom<D>;
  constexpr int STAGES = S::STAGES;
  constexpr int ITEMS = S::ITEMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* KVbuf = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* QSs = reinterpret_cast<bf16*>(smem + S::qs_off);
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + S::do_off);
  float* lse_s = reinterpret_cast<float*>(smem + S::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + S::delta_off);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* full = kv_full + ITEMS;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_kv = (Sk + BN - 1) / BN;
  const int p = blockIdx.y;
  const int n_items = item_count<ITEMS>(p, n_kv);
  const int t_end = Sq / BM;
  // the first K/V tiles see the most Q tiles
  auto n0_of = [&](int item) { return item_tile(p, item, n_kv, true) * BN; };
  auto t_begin_of = [&](int n0) { return causal ? n0 / BM : 0; };

  if (threadIdx.x == 0) {
    for (int it = 0; it < ITEMS; ++it) mbar_init(&kv_full[it], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      for (int it = 0; it < n_items; ++it) {   // every owned K/V tile at once
        bf16* kb = KVbuf + it * 2 * BN * D;
        mbar_expect_tx(&kv_full[it], 2 * S::kv_tile);
        for (int x = 0; x < G::BOXES; ++x) {
          tma_load_4d(kb + x * BN * G::W, &tm_k, &kv_full[it], x * G::W, h, n0_of(it), b);
          tma_load_4d(kb + BN * D + x * BN * G::W, &tm_v, &kv_full[it], x * G::W, h,
                      n0_of(it), b);
        }
      }
      const long long stats = static_cast<long long>(bh) * Sq;
      int g = 0;                                // Q tiles issued so far
      for (int it = 0; it < n_items; ++it) {
        for (int t = t_begin_of(n0_of(it)); t < t_end; ++t, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], S::stage_tx);
          for (int x = 0; x < G::BOXES; ++x) {
            const int off = s * BM * D + x * BM * G::W;
            tma_load_4d(QSs + off, &tm_qs, &full[s], x * G::W, h, t * BM, b);
            tma_load_4d(Qs + off, &tm_q, &full[s], x * G::W, h, t * BM, b);
            tma_load_4d(dOs + off, &tm_do, &full[s], x * G::W, h, t * BM, b);
          }
          bulk_load(lse_s + s * BM, lse + stats + t * BM, BM * sizeof(float), &full[s]);
          bulk_load(delta_s + s * BM, delta + stats + t * BM, BM * sizeof(float),
                    &full[s]);
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wrow0 = wgi * 64;                           // first K/V row in the tile
    const int col_lane = 2 * (lane % 4);
    const long long stride = static_cast<long long>(H) * D;
    const long long base = static_cast<long long>(b) * Sk * stride;

    float dk_acc[G::BOXES][G::W / 2], dv_acc[G::BOXES][G::W / 2];
    float st[BM / 2], dpt[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.0f;
    uint32_t pa[BM / 16][4], da[BM / 16][4];

    int g = 0;                                            // Q tiles consumed so far
    for (int item = 0; item < n_items; ++item) {
      const int n0 = n0_of(item);
      const int key = n0 + wrow0 + warp * 16 + lane / 4;  // and key + 8
      const bf16* Ks = KVbuf + item * 2 * BN * D;
      const bf16* Vs = Ks + BN * D;
      zero_acc<D>(dk_acc);
      zero_acc<D>(dv_acc);

      // Software pipeline: tile it's dV/dK products run while tile it + 1's
      // S^T and dP^T are issued; a stage is released when its dV/dK are done.
      mbar_wait(&kv_full[item], 0);
      const int t_begin = t_begin_of(n0);
      for (int t = t_begin; t < t_end; ++t, ++g) {
        const int s = g % STAGES;
        const bf16* qst = QSs + s * BM * D;
        const bf16* qt = Qs + s * BM * D;
        const bf16* dot = dOs + s * BM * D;
        const float* lse_t = lse_s + s * BM;
        const float* delta_t = delta_s + s * BM;
        mbar_wait(&full[s], (g / STAGES) & 1);

        // S^T = K . qs^T, then dP^T = V . dO^T, two groups
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BM, 0>::ss(st, desc_k_major<D, BN>(Ks, wrow0, kk),
                           desc_k_major<D, BM>(qst, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BM, 0>::ss(dpt, desc_k_major<D, BN>(Vs, wrow0, kk),
                           desc_k_major<D, BM>(dot, 0, kk), kk > 0);
        wgmma_commit();
        if (t > t_begin) {   // the previous tile's dV/dK: done, its stage free
          wgmma_wait<2>();
          fence_acc<D>(dv_acc);
          fence_acc<D>(dk_acc);
          fence_regs(pa);
          fence_regs(da);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
        }

        // P^T = exp(S^T - lse[query]), zero where the query precedes the key
        wgmma_wait<1>();
        fence_regs(st);
        const int m0 = t * BM;
        const bool mask = causal && m0 < n0 + wrow0 + 63;
#pragma unroll
        for (int i = 0; i < BM / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * i + col_lane + (e & 1);
            float pv = ex2(fmaf(st[4 * i + e], LOG2E, -lse_t[c] * LOG2E));
            if (mask && m0 + c < key + 8 * (e >> 1)) pv = 0.0f;
            st[4 * i + e] = pv;
          }
        acc_to_a<BM>(st, pa);

        // dS^T = P^T * (dP^T - delta[query]) * scale
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < BM / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * i + col_lane + (e & 1);
            dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - delta_t[c]) * sm_scale;
          }
        acc_to_a<BM>(dpt, da);

        // dV += P^T . dO and dK += dS^T . q, left in flight
        fence_acc<D>(dv_acc);
        fence_acc<D>(dk_acc);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
          for (int x = 0; x < G::BOXES; ++x) {
            Wgmma<G::W, 1>::rs(dv_acc[x], pa[kk], desc_mn_major<D, BM>(dot, x, kk));
            Wgmma<G::W, 1>::rs(dk_acc[x], da[kk], desc_mn_major<D, BM>(qt, x, kk));
          }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc<D>(dv_acc);
      fence_acc<D>(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0 && t_end > t_begin) mbar_arrive(&empty[(g - 1) % STAGES]);

      store_acc<D>(dk + base, dk_acc, key, Sk, stride, h, col_lane);
      store_acc<D>(dv + base, dv_acc, key, Sk, stride, h, col_lane);
    }
  }
}

}  // namespace dkv

// ---- dq: a block owns Q tiles of 128 rows, K/V streamed ----

namespace dq {

constexpr int BM = 64 * CONSUMERS;   // Q rows per owned tile
template <int D>
struct Smem {
  static constexpr int ITEMS = D == 128 ? 1 : 2;   // owned Q tiles
  static constexpr int STAGES = 3;                 // K/V ring
  static constexpr int BN = D == 128 ? 64 : 128;   // K/V rows per streamed tile
  static constexpr size_t q_tile = sizeof(bf16) * BM * D;
  static constexpr size_t kv_tile = sizeof(bf16) * BN * D;
  static constexpr size_t qs_off = 0;              // qs, dO of item i at 2i, 2i + 1 tiles
  static constexpr size_t k_off = ITEMS * 2 * q_tile;          // + stage * kv_tile
  static constexpr size_t v_off = k_off + STAGES * kv_tile;
  static constexpr size_t bar_off = v_off + STAGES * kv_tile;
  // q_full[ITEMS], k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar_off + 8 * (ITEMS + 3 * STAGES);
  static constexpr size_t alloc = bytes + 1024;
  static_assert(kv_tile % 1024 == 0 && q_tile % 1024 == 0, "boxes on 1024-byte lines");
};

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_qs,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int Sq, int Sk, int causal,
                    float sm_scale) {
  using S = Smem<D>;
  using G = TileGeom<D>;
  constexpr int BN = S::BN;
  constexpr int STAGES = S::STAGES;
  constexpr int ITEMS = S::ITEMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qbuf = reinterpret_cast<bf16*>(smem + S::qs_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::v_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* k_full = q_full + ITEMS;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_m = (Sq + BM - 1) / BM;
  const int p = blockIdx.y;
  const int n_items = item_count<ITEMS>(p, n_m);
  // the last Q tiles see the most K/V tiles
  auto m0_of = [&](int item) { return item_tile(p, item, n_m, false) * BM; };
  auto tiles_of = [&](int m0) {
    const int kv_end = causal ? min(m0 + BM, Sk) : Sk;
    return (kv_end + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int it = 0; it < ITEMS; ++it) mbar_init(&q_full[it], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x % 128 == 0) {
      for (int it = 0; it < n_items; ++it) {   // every owned Q tile at once
        bf16* qb = Qbuf + it * 2 * BM * D;
        mbar_expect_tx(&q_full[it], 2 * S::q_tile);
        for (int x = 0; x < G::BOXES; ++x) {
          tma_load_4d(qb + x * BM * G::W, &tm_qs, &q_full[it], x * G::W, h, m0_of(it), b);
          tma_load_4d(qb + BM * D + x * BM * G::W, &tm_do, &q_full[it], x * G::W, h,
                      m0_of(it), b);
        }
      }
      int g = 0;                                // K/V tiles issued so far
      for (int it = 0; it < n_items; ++it) {
        const int n_tiles = tiles_of(m0_of(it));
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          bf16* kt = Ks + s * BN * D;
          bf16* vt = Vs + s * BN * D;
          mbar_expect_tx(&k_full[s], S::kv_tile);
          for (int x = 0; x < G::BOXES; ++x)
            tma_load_4d(kt + x * BN * G::W, &tm_k, &k_full[s], x * G::W, h, j * BN, b);
          mbar_expect_tx(&v_full[s], S::kv_tile);
          for (int x = 0; x < G::BOXES; ++x)
            tma_load_4d(vt + x * BN * G::W, &tm_v, &v_full[s], x * G::W, h, j * BN, b);
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wrow0 = wgi * 64;
    const int col_lane = 2 * (lane % 4);
    const long long stride = static_cast<long long>(H) * D;

    float dq_acc[G::BOXES][G::W / 2];
    float s_acc[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s_acc[i] = dp[i] = 0.0f;
    uint32_t da[BN / 16][4];

    int g = 0;                                           // K/V tiles consumed so far
    for (int item = 0; item < n_items; ++item) {
      const int m0 = m0_of(item);
      const int row = m0 + wrow0 + warp * 16 + lane / 4;  // and row + 8
      const bf16* QSs = Qbuf + item * 2 * BM * D;
      const bf16* dOs = QSs + BM * D;
      const int n_tiles = tiles_of(m0);
      float lse_l2[2], delta_r[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row + 8 * hr;
        const long long at = static_cast<long long>(bh) * Sq + r;
        lse_l2[hr] = r < Sq ? lse[at] * LOG2E : 0.0f;
        delta_r[hr] = r < Sq ? delta[at] : 0.0f;
      }
      zero_acc<D>(dq_acc);

      // Software pipeline: tile j's dQ product runs while tile j + 1's S and
      // dP are issued; a stage is released when its dQ product is done.
      mbar_wait(&q_full[item], 0);
      for (int j = 0; j < n_tiles; ++j, ++g) {
        const int s = g % STAGES, parity = (g / STAGES) & 1;
        const bf16* kt = Ks + s * BN * D;
        const bf16* vt = Vs + s * BN * D;

        // S = qs . K^T, then dP = dO . V^T, two groups
        mbar_wait(&k_full[s], parity);
        mbar_wait(&v_full[s], parity);
        fence_regs(s_acc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN, 0>::ss(s_acc, desc_k_major<D, BM>(QSs, wrow0, kk),
                           desc_k_major<D, BN>(kt, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN, 0>::ss(dp, desc_k_major<D, BM>(dOs, wrow0, kk),
                           desc_k_major<D, BN>(vt, 0, kk), kk > 0);
        wgmma_commit();
        if (j > 0) {   // the previous tile's dQ product: done, its stage free
          wgmma_wait<2>();
          fence_acc<D>(dq_acc);
          fence_regs(da);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);
        }

        // P = exp(S - lse), zero for keys past Sk or after the query
        wgmma_wait<1>();
        fence_regs(s_acc);
        const int n0 = j * BN;
        const bool mask = n0 + BN > Sk || (causal && n0 + BN - 1 > m0 + wrow0);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = ex2(fmaf(s_acc[4 * i + e], LOG2E, -lse_l2[e >> 1]));
            const int col = n0 + 8 * i + col_lane + (e & 1);
            if (mask && (col >= Sk || (causal && col > row + 8 * (e >> 1)))) pv = 0.0f;
            s_acc[4 * i + e] = pv;
          }

        // dS = P * (dP - delta) * scale
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * i + e] = s_acc[4 * i + e] * (dp[4 * i + e] - delta_r[e >> 1]) * sm_scale;
        acc_to_a<BN>(dp, da);

        // dQ += dS . K, left in flight
        fence_acc<D>(dq_acc);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < G::BOXES; ++x)
            Wgmma<G::W, 1>::rs(dq_acc[x], da[kk], desc_mn_major<D, BN>(kt, x, kk));
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc<D>(dq_acc);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(g - 1) % STAGES]);

      store_acc<D>(dq + static_cast<long long>(b) * Sq * stride, dq_acc, row, Sq, stride, h,
                   col_lane);
    }
  }
}

}  // namespace dq

template <int D>
cudaError_t launch(const void* q, const void* qs, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta, void* dq_out,
                   void* dk, void* dv, int B, int H, int Sq, int Sk, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr int BN_DQ = dq::Smem<D>::BN;
  CUtensorMap qs_dkv, q_dkv, do_dkv, k_dkv, v_dkv, qs_dq, do_dq, k_dq, v_dq;
  if (!make_bshd_map(&qs_dkv, qs, B, Sq, H, D, dkv::BM) ||
      !make_bshd_map(&q_dkv, q, B, Sq, H, D, dkv::BM) ||
      !make_bshd_map(&do_dkv, dout, B, Sq, H, D, dkv::BM) ||
      !make_bshd_map(&k_dkv, k, B, Sk, H, D, dkv::BN) ||
      !make_bshd_map(&v_dkv, v, B, Sk, H, D, dkv::BN) ||
      !make_bshd_map(&qs_dq, qs, B, Sq, H, D, dq::BM) ||
      !make_bshd_map(&do_dq, dout, B, Sq, H, D, dq::BM) ||
      !make_bshd_map(&k_dq, k, B, Sk, H, D, BN_DQ) ||
      !make_bshd_map(&v_dq, v, B, Sk, H, D, BN_DQ))
    return cudaErrorInvalidValue;
  constexpr size_t dkv_bytes = dkv::Smem<D>::alloc;
  constexpr size_t dq_bytes = dq::Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(dkv::flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq::flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  const int dkv_blocks = item_blocks(dkv::Smem<D>::ITEMS, (Sk + dkv::BN - 1) / dkv::BN);
  const int dq_blocks = item_blocks(dq::Smem<D>::ITEMS, (Sq + dq::BM - 1) / dq::BM);
  dkv::flash_bwd_dkv_kernel<D>
      <<<dim3(B * H, dkv_blocks), THREADS, dkv_bytes, stream>>>(
          qs_dkv, q_dkv, do_dkv, k_dkv, v_dkv, lf, df, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), H, Sq, Sk, causal, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq::flash_bwd_dq_kernel<D>
      <<<dim3(B * H, dq_blocks), THREADS, dq_bytes, stream>>>(
          qs_dq, do_dq, k_dq, v_dq, lf, df, static_cast<bf16*>(dq_out), H, Sq, Sk, causal,
          sm_scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches the dk/dv kernel, then the dq
// kernel, on `stream`; returns the first cudaError_t of the launches
// (cudaErrorInvalidValue also when a tensor map cannot be encoded). qs is
// q * scale rounded to the input dtype; the f32 kernels scale q themselves.
extern "C" int flash_bwd(const void* q, const void* qs, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dq,
                         void* dk, void* dv, int B, int H, int Sq, int Sk, int D,
                         int dtype, int causal, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
#define FLASH_BWD_CASE(DD) \
  case DD:                 \
    return wg::launch<DD>(q, qs, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, causal, sm_scale, s);
      FLASH_BWD_CASE(32)
      FLASH_BWD_CASE(64)
      FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
    }
  } else if (dtype == 0) {
    switch (D) {
#define FLASH_BWD_CASE(DD) \
  case DD:                 \
    return f32::launch<DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, causal, sm_scale, s);
      FLASH_BWD_CASE(32)
      FLASH_BWD_CASE(64)
      FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
