// flash_fwd.cu — flash attention forward for Hopper (sm_90a).
//
// Replaces the two forward Pallas kernels of the JAX package:
//   ray_tpu/ops/flash_attention.py::_fwd_single_kernel (one K block, S <= 1024)
//   ray_tpu/ops/flash_attention.py::_fwd_kernel        (tiled online softmax)
// Both compute out = softmax(q*scale . k^T [causal mask]) . v and the per-row
// logsumexp; this file computes that function for every S.
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
// out written once, bf16; the f32 lse adds 4*B*H*S). At Llama-2-7B's
// [1, 4096, 32, 128] that is 137 GFLOP against 134 MB: operations bound it
// (0.139 ms against 0.040 ms), so the tensor cores have to be kept busy. At
// GPT-2 small's training shape [40, 1024, 12, 64] it is 64 GFLOP against
// 252 MB: the bytes bound it, barely (0.076 ms against 0.065 ms), so each
// input has to be read about once and the tensor cores still kept busy.
//
// Design of the bf16 kernel (flash_fwd_wgmma_kernel):
//   - A block of three warpgroups owns Q tiles of 128 rows of one (batch,
//     head): two consumer warpgroups of 64 rows each and one producer
//     warpgroup, of which one thread issues every load (warp
//     specialisation; setmaxnreg moves registers from the producer to the
//     consumers). At D <= 64 a block owns two Q tiles, the longest causal
//     one and the shortest, loaded at once (hopper.cuh); at D = 128 shared
//     memory holds one, and blocks run longest first.
//   - Loads are TMA boxes (hopper.cuh) under mbarriers: Q once, then K and V
//     tiles of 128 rows through a ring of three stages, each with a K-full, a
//     V-full and an empty barrier, so the next tile's loads overlap this
//     tile's products.
//   - Software pipeline in each consumer: S_{j+1} = Q.K_{j+1}^T is issued
//     before O += P_j.V_j, and the softmax of S_{j+1} runs while P_j.V_j is
//     on the tensor cores; O is rescaled once P_j.V_j is done.
//   - S = Q.K^T is a wgmma with both operands in shared memory (K-major); it
//     stays in registers. The online softmax runs on those registers: the
//     4 threads that share a row reduce its max and sum with two shuffles.
//     p, rounded to bf16, is the register A operand of O += P.V (V read
//     MN-major through the transpose bit), and O stays in registers for the
//     whole K loop. Nothing of S, P or O goes through shared memory.
//   - q*scale is rounded in bf16 in shared memory by the consumers once Q
//     has arrived (then fence.proxy.async: wgmma reads through the async
//     proxy), so no extra pass over q in device memory.
//   - Causal: K/V tiles right of the diagonal are never loaded, and only the
//     tiles that cross it (or the ragged end of K) are masked. Blocks with
//     the most tiles come first. Rows past Sq (a last tile of 64 rows) read
//     zeros and are not stored.
//   - About 225 KB of shared memory at D = 128 (129 KB at D = 64): one block
//     of 384 threads an SM; its 256 consumer threads hold up to 240
//     registers each.
// The f32 kernel (flash_fwd_f32_kernel) is not on a main path: 4 warps per
// 64-row Q tile, scores and O in shared memory, FMA loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---- f32: FMA loops ------------------------------------------------------------

namespace f32 {

constexpr int BR = 64;          // Q rows per block
constexpr int BC = 64;          // K/V rows per tile
constexpr int WARPS = 4;        // each warp owns 16 Q rows
constexpr int THREADS = WARPS * 32;
constexpr int SP = BC + 4;      // pitch of the score tile

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Layout {
  static constexpr int KP = D + 4;   // Q/K/V row pitch (elements)
  static constexpr int OP = D + 4;   // O row pitch (floats)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(float) * BR * KP);
  static constexpr size_t v_off = align128(k_off + sizeof(float) * BC * KP);
  static constexpr size_t s_off = align128(v_off + sizeof(float) * BC * KP);
  static constexpr size_t o_off = align128(s_off + sizeof(float) * BR * SP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BR * OP);
  static constexpr size_t l_off = m_off + sizeof(float) * BR;
  static constexpr size_t a_off = l_off + sizeof(float) * BR;
  static constexpr size_t bytes = a_off + sizeof(float) * BR;
};

// Copy 64 rows of D floats (global row stride `stride`) into shared memory
// with row pitch KP, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  constexpr int KP = Layout<D>::KP;
  for (int i = tid; i < BC * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    *reinterpret_cast<float4*>(dst + r * KP + c * 4) =
        *reinterpret_cast<const float4*>(src + r * stride + c * 4);
  }
}

// S[row0:row0+16, :] = Q[row0:row0+16, :] . K^T: lane j computes columns j
// and j + 32.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks, float* Ss,
                                       int row0, int lane) {
  constexpr int KP = Layout<D>::KP;
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

// O[row0:row0+16, :] += P[row0:row0+16, :] . V, P held in the score tile.
template <int D>
__device__ __forceinline__ void pv(const float* Ps, const float* Vs, float* Os, int row0,
                                   int lane) {
  constexpr int KP = Layout<D>::KP;
  constexpr int OP = Layout<D>::OP;
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                     float sm_scale) {
  using L = Layout<D>;
  constexpr int KP = L::KP;
  constexpr int OP = L::OP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* ms = reinterpret_cast<float*>(smem + L::m_off);
  float* ls = reinterpret_cast<float*>(smem + L::l_off);
  float* as = reinterpret_cast<float*>(smem + L::a_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16;  // this warp's first row in the tile
  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long stride = static_cast<long long>(H) * D;
  const float* qg = q + (static_cast<long long>(b) * Sq * H + h) * D;
  const float* kg = k + (static_cast<long long>(b) * Sk * H + h) * D;
  const float* vg = v + (static_cast<long long>(b) * Sk * H + h) * D;
  float* og = out + (static_cast<long long>(b) * Sq * H + h) * D;

  load_tile<D>(Qs, qg + q0 * stride, stride, tid);
  for (int i = tid; i < BR * OP; i += THREADS) Os[i] = 0.0f;
  if (tid < BR) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < BR * D; i += THREADS) Qs[(i / D) * KP + i % D] *= sm_scale;

  const int n_tiles = causal ? q0 / BC + 1 : Sk / BC;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // scaled Q visible; the previous K/V tile is done with
    load_tile<D>(Ks, kg + static_cast<long long>(t) * BC * stride, stride, tid);
    load_tile<D>(Vs, vg + static_cast<long long>(t) * BC * stride, stride, tid);
    __syncthreads();
    scores<D>(Qs, Ks, Ss, row0, lane);
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
      Ss[r * SP + lane] = p0;
      Ss[r * SP + lane + 32] = p1;
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
    pv<D>(Ss, Vs, Os, row0, lane);
    __syncwarp();
  }

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = row0 + i / D, c = i % D;
    const float l = fmaxf(ls[r], 1e-30f);
    og[static_cast<long long>(q0 + r) * stride + c] = Os[r * OP + c] / l;
  }
  if (lane < 16) {
    const int r = row0 + lane;
    lse[static_cast<long long>(bh) * Sq + q0 + r] = ms[r] + logf(fmaxf(ls[r], 1e-30f));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int H, int Sq, int Sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Sq / BR, B * H);
  flash_fwd_f32_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse), H,
      Sq, Sk, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---- bf16: warp-specialised wgmma ------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int BM = 64 * CONSUMERS;        // Q rows per item
constexpr int BN = 128;                   // K/V rows per tile
constexpr int STAGES = 3;                 // K/V ring
constexpr int THREADS = 128 * (CONSUMERS + 1);

template <int D>
struct Smem {
  // Q tiles a block owns: two where shared memory holds both (a long causal
  // tile paired with a short one), else one
  static constexpr int ITEMS = D == 128 ? 1 : 2;
  static constexpr size_t q_tile = sizeof(bf16) * BM * D;
  static constexpr size_t tile = sizeof(bf16) * BN * D;       // one K or V tile
  static constexpr size_t q_off = 0;                          // + item * q_tile
  static constexpr size_t k_off = q_off + ITEMS * q_tile;
  static constexpr size_t v_off = k_off + STAGES * tile;
  static constexpr size_t bar_off = v_off + STAGES * tile;
  // q_full[ITEMS], k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar_off + 8 * (ITEMS + 3 * STAGES);
  static constexpr size_t alloc = bytes + 1024;               // for the alignment
  static_assert(tile % 1024 == 0 && q_tile % 1024 == 0, "boxes on 1024-byte lines");
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                       float sm_scale) {
  using S = Smem<D>;
  using G = TileGeom<D>;
  constexpr int ITEMS = S::ITEMS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qbuf = reinterpret_cast<bf16*>(smem + S::q_off);
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
  auto tiles_of = [&](int m0) {
    const int kv_end = causal ? min(m0 + BM, Sk) : Sk;
    return (kv_end + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int it = 0; it < ITEMS; ++it) mbar_init(&q_full[it], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dealloc<24>();
    if (threadIdx.x % 128 == 0) {
      for (int it = 0; it < n_items; ++it) {   // every Q tile at once
        mbar_expect_tx(&q_full[it], S::q_tile);
        for (int x = 0; x < G::BOXES; ++x)
          tma_load_4d(Qbuf + it * BM * D + x * BM * G::W, &tm_q, &q_full[it], x * G::W,
                      h, item_tile(p, it, n_m, false) * BM, b);
      }
      int g = 0;                                // K/V tiles issued so far
      for (int it = 0; it < n_items; ++it) {
        const int n_tiles = tiles_of(item_tile(p, it, n_m, false) * BM);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          bf16* kt = Ks + s * BN * D;
          bf16* vt = Vs + s * BN * D;
          mbar_expect_tx(&k_full[s], S::tile);
          for (int x = 0; x < G::BOXES; ++x)
            tma_load_4d(kt + x * BN * G::W, &tm_k, &k_full[s], x * G::W, h, j * BN, b);
          mbar_expect_tx(&v_full[s], S::tile);
          for (int x = 0; x < G::BOXES; ++x)
            tma_load_4d(vt + x * BN * G::W, &tm_v, &v_full[s], x * G::W, h, j * BN, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 Q rows of each item ----
    regs_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wrow0 = wgi * 64;                          // first row in the Q tile
    const int col_lane = 2 * (lane % 4);
    const long long stride = static_cast<long long>(H) * D;

    float o[G::BOXES][G::W / 2];
    float m_run[2], l_run[2];
    float s_acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s_acc[i] = 0.0f;
    uint32_t pa[BN / 16][4];
    const bf16* Qs = Qbuf;
    int m0 = 0, row = 0;
    int g = 0;                                           // K/V tiles consumed so far

    // S_j = (q*scale) . K_j^T, issued as one group
    auto issue_s = [&](int j) {
      const int s = (g + j) % STAGES;
      mbar_wait(&k_full[s], ((g + j) / STAGES) & 1);
      fence_regs(s_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BN, 0>::ss(s_acc, desc_k_major<D, BM>(Qs, wrow0, kk),
                         desc_k_major<D, BN>(Ks + s * BN * D, 0, kk), kk > 0);
      wgmma_commit();
    };
    // O += P_j . V_j, P_j in pa, issued as one group
    auto issue_pv = [&](int j) {
      const int s = (g + j) % STAGES;
      mbar_wait(&v_full[s], ((g + j) / STAGES) & 1);
#pragma unroll
      for (int x = 0; x < G::BOXES; ++x) fence_regs(o[x]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < G::BOXES; ++x)
          Wgmma<G::W, 1>::rs(o[x], pa[kk], desc_mn_major<D, BN>(Vs + s * BN * D, x, kk));
      wgmma_commit();
    };
    // after PV_j is done: its stage is free
    auto release = [&](int j) {
#pragma unroll
      for (int x = 0; x < G::BOXES; ++x) fence_regs(o[x]);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(g + j) % STAGES]);
    };
    // masks and the online softmax of S_j, in place: s_acc becomes p, the
    // running max and sum move on, alpha rescales the O of earlier tiles
    auto softmax = [&](int j, float (&alpha)[2]) {
      const int n0 = j * BN;
      if (n0 + BN > Sk || (causal && n0 + BN - 1 > m0 + wrow0)) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * i + col_lane + (e & 1);
            const int r = row + 8 * (e >> 1);
            if (col >= Sk || (causal && col > r)) s_acc[4 * i + e] = NEG_INF;
          }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = m_run[hr];
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
          mx = fmaxf(mx, fmaxf(s_acc[4 * i + 2 * hr], s_acc[4 * i + 2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hr] = ex2((m_run[hr] - mx) * LOG2E);
        m_run[hr] = mx;
        const float mb = mx * LOG2E;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pv = ex2(fmaf(s_acc[4 * i + 2 * hr + e], LOG2E, -mb));
            s_acc[4 * i + 2 * hr + e] = pv;
            sum += pv;
          }
        l_run[hr] = l_run[hr] * alpha[hr] + sum;   // this thread's columns only
      }
    };

    for (int it = 0; it < n_items; ++it) {
      m0 = item_tile(p, it, n_m, false) * BM;
      row = m0 + wrow0 + warp * 16 + lane / 4;           // and row + 8
      Qs = Qbuf + it * BM * D;
      const int n_tiles = tiles_of(m0);

      // q * scale, rounded in bf16, in place over this warpgroup's 64 rows
      mbar_wait(&q_full[it], 0);
      {
        const __nv_bfloat162 scale2 = __bfloat162bfloat162(__float2bfloat16(sm_scale));
        constexpr int CHUNKS = 64 * G::W / 8;             // 16-byte chunks a box
        for (int x = 0; x < G::BOXES; ++x) {
          uint4* base = reinterpret_cast<uint4*>(Qbuf + it * BM * D + x * BM * G::W +
                                                 wrow0 * G::W);
          for (int i = tid; i < CHUNKS; i += 128) {
            uint4 c = base[i];
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&c);
#pragma unroll
            for (int k = 0; k < 4; ++k) e[k] = __hmul2(e[k], scale2);
            base[i] = c;
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wgi, 128);
      }
#pragma unroll
      for (int x = 0; x < G::BOXES; ++x)
#pragma unroll
        for (int i = 0; i < G::W / 2; ++i) o[x][i] = 0.0f;
      m_run[0] = m_run[1] = NEG_INF;
      l_run[0] = l_run[1] = 0.0f;

      // Software pipeline: S_{j+1} and PV_j are in flight together, and the
      // softmax of S_{j+1} runs while PV_j does.
      float alpha[2];
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(s_acc);
      softmax(0, alpha);
      acc_to_a<BN>(s_acc, pa);
      for (int j = 1; j < n_tiles; ++j) {
        issue_s(j);
        issue_pv(j - 1);
        wgmma_wait<1>();          // S_j (the older group) is done
        fence_regs(s_acc);
        softmax(j, alpha);
        wgmma_wait<0>();          // PV_{j-1} is done
        release(j - 1);
#pragma unroll
        for (int x = 0; x < G::BOXES; ++x)
#pragma unroll
          for (int i = 0; i < G::W / 2; ++i) o[x][i] *= alpha[(i >> 1) & 1];
        acc_to_a<BN>(s_acc, pa);
      }
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      release(n_tiles - 1);
      g += n_tiles;

      // epilogue: out = O / l in bf16, lse = m + log(l), rows below Sq only
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
        l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = row + 8 * hr;
        if (r >= Sq) continue;
        const float l = fmaxf(l_run[hr], 1e-30f);
        bf16* og = out + (static_cast<long long>(b) * Sq + r) * stride +
                   static_cast<long long>(h) * D;
#pragma unroll
        for (int x = 0; x < G::BOXES; ++x)
#pragma unroll
          for (int i = 0; i < G::W / 8; ++i) {
            const int c = x * G::W + 8 * i + col_lane;
            *reinterpret_cast<__nv_bfloat162*>(og + c) = __floats2bfloat162_rn(
                o[x][4 * i + 2 * hr] / l, o[x][4 * i + 2 * hr + 1] / l);
          }
        if (lane % 4 == 0) lse[static_cast<long long>(bh) * Sq + r] = m_run[hr] + logf(l);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, void* lse,
                   int B, int H, int Sq, int Sk, int causal, float sm_scale,
                   cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_bshd_map(&tm_q, q, B, Sq, H, D, BM) || !make_bshd_map(&tm_k, k, B, Sk, H, D, BN) ||
      !make_bshd_map(&tm_v, v, B, Sk, H, D, BN))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = Smem<D>::alloc;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int n_m = (Sq + BM - 1) / BM;
  const dim3 grid(B * H, item_blocks(Smem<D>::ITEMS, n_m));
  flash_fwd_wgmma_kernel<D><<<grid, THREADS, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Sk,
      causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t
// (cudaErrorInvalidValue also when a tensor map cannot be encoded).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int H, int Sq, int Sk, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(NS, DD) \
  case DD:                     \
    return NS::launch<DD>(q, k, v, out, lse, B, H, Sq, Sk, causal, sm_scale, s);
  if (dtype == 1) {
    switch (D) {
      FLASH_FWD_CASE(wg, 32)
      FLASH_FWD_CASE(wg, 64)
      FLASH_FWD_CASE(wg, 128)
    }
  } else if (dtype == 0) {
    switch (D) {
      FLASH_FWD_CASE(f32, 32)
      FLASH_FWD_CASE(f32, 64)
      FLASH_FWD_CASE(f32, 128)
    }
  }
#undef FLASH_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
