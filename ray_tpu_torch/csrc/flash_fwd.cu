// flash_fwd.cu — flash attention forward for Hopper (sm_90a).
//
// Replaces the two forward Pallas kernels of the JAX package:
//   ray_tpu/ops/flash_attention.py::_fwd_single_kernel (one K block, S <= 1024)
//   ray_tpu/ops/flash_attention.py::_fwd_kernel        (tiled online softmax)
// Both compute out = softmax(q*scale . k^T [causal mask]) . v and the per-row
// logsumexp; this one kernel computes that function for every S.
//
// Layout: q, out [B, Sq, H, D] and k, v [B, Sk, H, D], contiguous (row stride
// H*D elements, so no transpose is needed); lse [B, H, Sq] f32. The wrapper
// (ops/flash_attention.py) checks dtype (bf16 or f32), D in {32, 64, 128},
// Sq and Sk multiples of 64, contiguity and 16-byte alignment.
//
// Arithmetic, as in the TPU kernels: q is scaled in the input dtype before
// the product; scores, the running max m and sum l are f32; masked scores
// are -1e30; p is cast to the input dtype before P.V, which accumulates in
// f32; out = acc / max(l, 1e-30) in the input dtype; lse = m + log(l).
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): a causal
// forward does 2*B*H*S^2*D FLOPs (two products of 2*S^2*D FLOPs per head,
// halved by the mask) and must move 4*B*S*H*D*2 bytes (q, k, v read once,
// out written once, bf16; the f32 lse adds 4*B*H*S). At [1, 4096, 32, 128]
// that is 137 GFLOP against 134 MB: operations bound it (0.14 ms against
// 0.04 ms). At S = 1024 it is 8.6 GFLOP against 34 MB: the bytes bound it,
// barely (10 us against 9 us). So the kernel has to keep the tensor cores
// busy at long S and read each input tile few times at short S. This
// design runs both products on the tensor cores, but each 64-row Q tile
// reads every K/V tile up to its diagonal again (from L2 mostly), and the
// tensor cores stay mostly idle (see "Not done yet" below).
//
// Design (simple and right first; speed is later work):
//   - One thread block of 4 warps per (batch*head, 64-row Q tile). The TPU's
//     sequential K grid axis becomes a loop over 64-row K/V tiles inside the
//     block; blocks are independent, so nothing is carried between them.
//   - Q (scaled), the K tile and the V tile sit in shared memory, rows
//     padded by 16 bytes. Each warp owns 16 Q rows end to end: its scores,
//     its softmax statistics and its rows of the f32 accumulator O, which
//     also lives in shared memory (wmma fragments have no portable row
//     layout, so the per-row rescale by exp(m_old - m_new) is done there).
//   - bf16: S = Q.K^T and O += P.V run on the tensor cores through
//     nvcuda::wmma 16x16x16 (bf16 in, f32 accumulate). f32: plain FMA loops.
//   - Causal: tiles right of the diagonal are never loaded (the loop stops
//     at the diagonal tile), and only the diagonal tile applies the mask.
//   - About 113 KB of shared memory at D = 128 in bf16, so launch() first
//     raises the kernel's dynamic shared memory limit.
// Not done yet, and why it is slow: 113 KB of shared memory lets at most
// two blocks (8 warps) share an SM; scores and O make a round trip through
// shared memory on every tile; K/V loads are synchronous. A faster version
// keeps S, P and O in registers (mma.sync or wgmma), double-buffers K/V
// with cp.async or TMA, and gives each warpgroup a 64-row Q tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BR = 64;          // Q rows per block
constexpr int BC = 64;          // K/V rows per tile
constexpr int WARPS = 4;        // each warp owns 16 Q rows
constexpr int THREADS = WARPS * 32;
constexpr int SP = BC + 4;      // pitch of the f32 score tile
constexpr int PP = BC + 8;      // pitch of the bf16 probability tile
constexpr float NEG_INF = -1e30f;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory layout for element type T and head dim D (byte offsets).
template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int KP = D + 16 / sizeof(T);   // Q/K/V row pitch (elements)
  static constexpr int OP = D + 4;                // O row pitch (floats)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * BR * KP);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BC * KP);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * BC * KP);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * BR * SP);
  static constexpr size_t o_off =
      align128(p_off + (kBf16 ? sizeof(bf16) * BR * PP : 0));
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BR * OP);
  static constexpr size_t l_off = m_off + sizeof(float) * BR;
  static constexpr size_t a_off = l_off + sizeof(float) * BR;
  static constexpr size_t bytes = a_off + sizeof(float) * BR;
};

// Copy 64 rows of D elements (global row stride `stride` elements) into
// shared memory with row pitch KP, 16 bytes per thread per step.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int tid) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  constexpr int KP = Layout<T, D>::KP;
  for (int i = tid; i < BC * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    *reinterpret_cast<uint4*>(dst + r * KP + c * EPC) =
        *reinterpret_cast<const uint4*>(src + r * stride + c * EPC);
  }
}

// S[row0:row0+16, :] = Q[row0:row0+16, :] . K^T  (tensor cores, bf16 in).
template <int D>
__device__ __forceinline__ void scores_mma(const bf16* Qs, const bf16* Ks, float* Ss,
                                           int row0) {
  constexpr int KP = Layout<bf16, D>::KP;
  for (int n = 0; n < BC / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
      wmma::load_matrix_sync(a, Qs + row0 * KP + kk * 16, KP);
      wmma::load_matrix_sync(bt, Ks + n * 16 * KP + kk * 16, KP);
      wmma::mma_sync(acc, a, bt, acc);
    }
    wmma::store_matrix_sync(Ss + row0 * SP + n * 16, acc, SP, wmma::mem_row_major);
  }
}

// Same product for f32 inputs: lane j computes columns j and j + 32.
template <int D>
__device__ __forceinline__ void scores_fma(const float* Qs, const float* Ks, float* Ss,
                                           int row0, int lane) {
  constexpr int KP = Layout<float, D>::KP;
  const float* k0 = Ks + lane * KP;
  const float* k1 = Ks + (lane + 32) * KP;
  for (int r = row0; r < row0 + 16; ++r) {
    const float* qr = Qs + r * KP;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float x = qr[d];
      a0 = fmaf(x, k0[d], a0);
      a1 = fmaf(x, k1[d], a1);
    }
    Ss[r * SP + lane] = a0;
    Ss[r * SP + lane + 32] = a1;
  }
}

// O[row0:row0+16, :] += P[row0:row0+16, :] . V  (tensor cores, bf16 in).
template <int D>
__device__ __forceinline__ void pv_mma(const bf16* Ps, const bf16* Vs, float* Os,
                                       int row0) {
  constexpr int KP = Layout<bf16, D>::KP;
  constexpr int OP = Layout<bf16, D>::OP;
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, Os + row0 * OP + n * 16, OP, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
      wmma::load_matrix_sync(a, Ps + row0 * PP + kk * 16, PP);
      wmma::load_matrix_sync(bv, Vs + kk * 16 * KP + n * 16, KP);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(Os + row0 * OP + n * 16, acc, OP, wmma::mem_row_major);
  }
}

// Same product for f32 inputs, P held in the score tile.
template <int D>
__device__ __forceinline__ void pv_fma(const float* Ps, const float* Vs, float* Os,
                                       int row0, int lane) {
  constexpr int KP = Layout<float, D>::KP;
  constexpr int OP = Layout<float, D>::OP;
  for (int r = row0; r < row0 + 16; ++r) {
    const float* pr = Ps + r * SP;
    for (int c = lane; c < D; c += 32) {
      float acc = Os[r * OP + c];
#pragma unroll 8
      for (int j = 0; j < BC; ++j) acc = fmaf(pr[j], Vs[j * KP + c], acc);
      Os[r * OP + c] = acc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 float sm_scale) {
  using L = Layout<T, D>;
  constexpr int KP = L::KP;
  constexpr int OP = L::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* ms = reinterpret_cast<float*>(smem + L::m_off);
  float* ls = reinterpret_cast<float*>(smem + L::l_off);
  float* as = reinterpret_cast<float*>(smem + L::a_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;  // this warp's first row in the tile
  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const T* qg = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const T* kg = k + (static_cast<long long>(b) * Sk * H + h) * D;
  const T* vg = v + (static_cast<long long>(b) * Sk * H + h) * D;
  T* og = out + (static_cast<long long>(b) * Sq * H + h) * D;

  load_tile<T, D>(Qs, qg + q0 * stride, stride, tid);
  for (int i = tid; i < BR * OP; i += THREADS) Os[i] = 0.0f;
  if (tid < BR) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.0f;
  }
  __syncthreads();
  // scale q in its own dtype, as the TPU kernels do (q * asarray(scale, dtype))
  const float scale = to_f(from_f<T>(sm_scale));
  for (int i = tid; i < BR * D; i += THREADS) {
    T* p = Qs + (i / D) * KP + i % D;
    *p = from_f<T>(to_f(*p) * scale);
  }

  const int n_tiles = causal ? q0 / BC + 1 : Sk / BC;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // scaled Q visible; the previous K/V tile is done with
    load_tile<T, D>(Ks, kg + static_cast<long long>(t) * BC * stride, stride, tid);
    load_tile<T, D>(Vs, vg + static_cast<long long>(t) * BC * stride, stride, tid);
    __syncthreads();

    if constexpr (L::kBf16) {
      scores_mma<D>(Qs, Ks, Ss, row0);
    } else {
      scores_fma<D>(Qs, Ks, Ss, row0, lane);
    }
    __syncwarp();

    // online softmax over this tile, one row at a time, lanes over columns
    const bool diag = causal && t == n_tiles - 1;
    for (int r = row0; r < row0 + 16; ++r) {
      float s0 = Ss[r * SP + lane];
      float s1 = Ss[r * SP + lane + 32];
      if (diag) {
        const int qrow = q0 + r, c0 = t * BC + lane;
        if (c0 > qrow) s0 = NEG_INF;
        if (c0 + 32 > qrow) s1 = NEG_INF;
      }
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float rsum = warp_sum(p0 + p1);  // also orders every lane's read of ms[r]
      if constexpr (L::kBf16) {
        Ps[r * PP + lane] = __float2bfloat16(p0);
        Ps[r * PP + lane + 32] = __float2bfloat16(p1);
      } else {
        Ss[r * SP + lane] = p0;
        Ss[r * SP + lane + 32] = p1;
      }
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ms[r] = m_new;
        ls[r] = ls[r] * alpha + rsum;
        as[r] = alpha;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = row0 + i / D;
      Os[r * OP + i % D] *= as[r];
    }
    __syncwarp();
    if constexpr (L::kBf16) {
      pv_mma<D>(Ps, Vs, Os, row0);
    } else {
      pv_fma<D>(Ss, Vs, Os, row0, lane);
    }
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, c = i % D;
    const float l = fmaxf(ls[r], 1e-30f);
    og[static_cast<long long>(q0 + r) * stride + c] = from_f<T>(Os[r * OP + c] / l);
  }
  if (lane < 16) {
    const int r = row0 + lane;
    lse[static_cast<long long>(bh) * Sq + q0 + r] = ms[r] + logf(fmaxf(ls[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int H, int Sq, int Sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / BR, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, Sq, Sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int H, int Sq, int Sk, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch<bf16, 32>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
      case 64: return launch<bf16, 64>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
      case 128: return launch<bf16, 128>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: return launch<float, 32>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
      case 64: return launch<float, 64>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
      case 128: return launch<float, 128>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
