// hopper_gemm.cuh — the bf16 GEMM main loop that ln_matmul.cu and mm_res.cu
// share on Hopper (sm_90a): out[N, F] = epi(A[N, K] . W[K, F]), f32
// accumulation, with two prologues for A and three epilogues.
//
//   LN = true  (ln_matmul): A is layernorm(x) rounded to bf16, made in
//              registers from the raw x tile (below) and fed to wgmma as its
//              register operand; epilogue acc + wb[col].
//   LN = false (mm_res):    A is `a` from shared memory; epilogue
//              (acc + b[col]) + res[row, col].
// Both add in f32 and round once to bf16.
//   LN = false, OUT32 = true (mm_res's f32 partial, the row-parallel exit
//              under tensor parallelism): the same main loop; epilogue
//              (acc + b[col]) + res[row, col], each add only where the caller
//              passes b (a null bias) or res (Params::has_res), out in f32,
//              never rounded.
//
// Design (the hopper.cuh building blocks):
//   - Persistent grid: one block an SM walks output tiles of [BM = 128, BN]
//     in row-major tile order, so the blocks in flight share A's rows (and
//     all of W) in L2.
//   - Three warpgroups: two consumers, each owning 64 rows of the tile, and
//     one producer, of which one thread issues every TMA load through a ring
//     of STAGES stages. A stage holds the A tile [128 x 64] (one box, K-major)
//     and the W tile [64 x BN] (BN / 64 boxes of 64 x 64), each with a full
//     and an empty mbarrier; ln_matmul's stages also hold g and b for the
//     64 columns (1-D bulk copies on the same barrier). setmaxnreg moves
//     registers from the producer to the consumers.
//   - W is row-major [K, F]: the reduction runs down its rows, so it is the
//     MN-major B operand, read with the transpose bit; one wgmma m64nBNk16
//     spans the tile's BN / 64 boxes (leading byte offset = one box).
//   - The accumulators stay in registers for the whole K loop. Each consumer
//     keeps one wgmma group in flight behind the one it issues, and frees a
//     stage once the group that read it is done.
//   - ln_matmul's A operand: each consumer reads its 64 raw x rows of the
//     stage with ldmatrix (the swizzled box gives conflict-free rows) into
//     the register-A fragment layout of hopper.cuh, computes
//     (x - mean) * rstd * g + b in f32 with the two rows' mean and rstd held
//     in registers for the tile, rounds to bf16 and issues the register-A
//     wgmma. Two fragment buffers: the next step's layernorm is written
//     while the current step's products are on the tensor cores. The
//     normalised activation never leaves the registers. (Normalising in
//     place in shared memory for the shared-memory form, by the consumers
//     or by other warps, measured slower: PERF.md.)
//   - mm_res's residual: the producer loads the res tile [128 x BN] by TMA
//     into the output staging buffer as soon as the ring holds the tile's
//     first stages, so it arrives during the K loop, not after it.
//   - Epilogue: each consumer adds in f32 from its accumulators (and from
//     the residual in shared memory), writes bf16 pairs into the staging
//     buffer in the swizzled box layout (conflict-free), and one thread
//     stores its 64-row boxes by TMA. The producer already streams the next
//     tile's stages meanwhile.
//   - OUT32: the f32 staging buffer is twice the bf16 one (64 KB at BN =
//     128), beside the residual's bf16 staging, so the ring holds four
//     stages, not five (224 KB in all). Its boxes are 32 columns wide (128
//     bytes of f32, the 128-byte swizzle); a consumer's float2 pairs land in
//     them with at most a two-way bank conflict. Once a consumer has read
//     its rows of the residual it frees the residual buffer, before its
//     stores.
//   - Tails: TMA reads rows past N as zeros and the stores clip them; F is a
//     multiple of 64, and boxes of a tile that lie wholly past F or N are
//     neither loaded nor stored (their columns of the accumulator are never
//     stored). K is a multiple of 64 (one stage a 64-deep step).
//   - Every output element is summed in one fixed order (no split-K, no
//     atomics), so the result is bitwise equal from run to run.

#pragma once

#include "hopper.cuh"

namespace hgemm {

using namespace hopper;

constexpr int BM = 128;                       // rows of an output tile
constexpr int BK = 64;                        // depth of one stage
constexpr int CONSUMERS = 2;                  // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);

template <int BN, bool LN, bool OUT32 = false>
struct Smem {
  static_assert(!(LN && OUT32), "the f32 output is mm_res's");
  // as shared memory allows
  static constexpr int STAGES = OUT32 ? 4 : BN == 256 ? 3 : 5;
  static constexpr int BOXES = BN / 64;       // 64-column boxes a tile
  static constexpr uint32_t a_tile = BM * BK * 2;
  static constexpr uint32_t w_box = BK * 64 * 2;
  static constexpr uint32_t stage = a_tile + BOXES * w_box;
  // bf16 staging (the output, or mm_res's residual): BOXES of these
  static constexpr uint32_t c_box = BM * 64 * 2;
  // f32 staging of the output (OUT32): 2 * BOXES boxes of 32 columns
  static constexpr uint32_t o_box = OUT32 ? BM * 32 * 4 : 0;
  static constexpr uint32_t gb_bytes = LN ? 2 * BK * 4 : 0;  // g, b of a stage
  static constexpr size_t c_off = static_cast<size_t>(STAGES) * stage;
  static constexpr size_t o_off = c_off + BOXES * c_box;
  static constexpr size_t gb_off = o_off + 2 * BOXES * o_box;
  static constexpr size_t bar_off = gb_off + STAGES * gb_bytes;
  // full[STAGES], empty[STAGES], c_full, c_empty
  static constexpr size_t bytes = bar_off + 8 * (2 * STAGES + 2);
  static constexpr size_t alloc = bytes + 1024;           // for the alignment
  static_assert(stage % 1024 == 0 && c_box % 1024 == 0 && o_box % 1024 == 0,
                "boxes on 1024-byte lines");
  static_assert(alloc <= 232448, "over the 227 KB a block may use");
};

struct Params {
  const float* bias;    // [F]: wb (ln_matmul) or b (mm_res; null: none, OUT32)
  const float* g;       // [K] (ln_matmul)
  const float* b;       // [K] (ln_matmul)
  const float* stats;   // mean [N], then rstd [N] (ln_matmul)
  int N, K, F;
  int has_res;          // mm_res: a residual is added (launch sets it)
};

// K-major A operand: rows [64 w, 64 w + 64) of the [128 x 64] tile, slice kk.
__device__ __forceinline__ uint64_t desc_a(const unsigned char* tile, int w, int kk) {
  return make_desc(tile + 64 * w * 128 + 32 * kk, 16, 1024, 1);
}
// MN-major B operand: rows [16 kk, 16 kk + 16) of the [64 x BN] W tile, all
// BN columns (boxes 8 KB apart).
template <int BN>
__device__ __forceinline__ uint64_t desc_w(const unsigned char* tile, int kk) {
  return make_desc(tile + 16 * kk * 128, Smem<BN, false>::w_box, 1024, 1);
}

template <int BN, bool LN, bool OUT32>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_out,
            const __grid_constant__ CUtensorMap tm_res, const Params p) {
  using S = Smem<BN, LN, OUT32>;
  constexpr int STAGES = S::STAGES, BOXES = S::BOXES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* cbuf = smem + S::c_off;
  unsigned char* obuf = smem + S::o_off;      // OUT32's f32 staging
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* c_full = empty + STAGES;
  uint64_t* c_empty = c_full + 1;

  const int n_cols = (p.F + BN - 1) / BN;
  const int tiles = ((p.N + BM - 1) / BM) * n_cols;
  const int ksteps = p.K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_init(c_full, 1);
    mbar_init(c_empty, CONSUMERS);
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dealloc<40>();
    if (threadIdx.x % 128 == 0) {
      int it = 0;                                // stages issued so far
      int local = 0;                             // tiles of this block so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
        const int m0 = tile / n_cols * BM, n0 = tile % n_cols * BN;
        const int boxes = min(BOXES, (p.F - n0) / 64);
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = smem + static_cast<size_t>(s) * S::stage;
          mbar_expect_tx(&full[s], S::a_tile + boxes * S::w_box + S::gb_bytes);
          tma_load_2d(st, &tm_a, &full[s], ks * BK, m0);
          for (int x = 0; x < boxes; ++x)
            tma_load_2d(st + S::a_tile + x * S::w_box, &tm_w, &full[s], n0 + 64 * x,
                        ks * BK);
          if constexpr (LN) {
            float* gb = reinterpret_cast<float*>(smem + S::gb_off) + s * 2 * BK;
            bulk_load(gb, p.g + ks * BK, BK * 4, &full[s]);
            bulk_load(gb + BK, p.b + ks * BK, BK * 4, &full[s]);
          } else if (p.has_res && ks == min(STAGES, ksteps) - 1) {
            // the residual tile, once the ring holds this tile's first
            // stages and the previous tile's epilogue is done with cbuf
            const int halves = m0 + 64 < p.N ? 2 : 1;
            mbar_wait(c_empty, (local & 1) ^ 1);
            mbar_expect_tx(c_full, halves * boxes * (S::c_box / 2));
            for (int x = 0; x < boxes; ++x)
              for (int h = 0; h < halves; ++h)
                tma_load_2d(cbuf + x * S::c_box + h * (S::c_box / 2), &tm_res, c_full,
                            n0 + 64 * x, m0 + 64 * h);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup: rows [64 wgi, 64 wgi + 64) of each tile ----
    regs_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int trow = 64 * wgi + 16 * warp + lane / 4;   // tile row; and trow + 8
    float acc[BN / 2];
    uint32_t a0[4][4], a1[4][4];                        // ln_matmul's A fragments
    float mean[2] = {0.0f, 0.0f}, rstd[2] = {0.0f, 0.0f};
    int it = 0, local = 0;

    auto release = [&](int stage_it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage_it % STAGES]);
    };
    // One 64-deep step: wait for its stage, (ln_matmul: build the A
    // fragments in `a`), issue its four wgmmas as one group, then wait for
    // the previous step's group (which read `prev`) and free its stage.
    auto step = [&](int ks, uint32_t (&a)[4][4], uint32_t (&prev)[4][4]) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = smem + static_cast<size_t>(s) * S::stage;
      if constexpr (LN) {
        const float* gb = reinterpret_cast<const float*>(smem + S::gb_off) + s * 2 * BK;
        // lane l gives row l % 8 + 8 ((l / 8) % 2) of the warp's 16 and
        // 16-byte chunk l / 16 of the slice; the box is 128-byte swizzled
        const int lrow = 64 * wgi + 16 * warp + lane % 8 + 8 * ((lane / 8) % 2);
        const unsigned char* rowp = st + lrow * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t raw[4];
          ldmatrix_x4(raw, rowp + (((2 * kk + lane / 16) ^ (lane % 8)) * 16));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int hr = j & 1, col = 16 * kk + 8 * (j >> 1) + 2 * quad;
            const float2 gg = *reinterpret_cast<const float2*>(gb + col);
            const float2 bb = *reinterpret_cast<const float2*>(gb + BK + col);
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[j]));
            a[kk][j] = pack_bf16(fmaf((xv.x - mean[hr]) * rstd[hr], gg.x, bb.x),
                                 fmaf((xv.y - mean[hr]) * rstd[hr], gg.y, bb.y));
          }
        }
        fence_regs(a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) Wgmma<BN, 1>::rs(acc, a[kk], desc_w<BN>(st + S::a_tile, kk));
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<BN, 1>::ss(acc, desc_a(st, wgi, kk), desc_w<BN>(st + S::a_tile, kk), 1);
      }
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        if constexpr (LN) fence_regs(prev);   // read until here
        release(it - 1);
      }
      ++it;
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++local) {
      const int m0 = tile / n_cols * BM, n0 = tile % n_cols * BN;
      const int boxes = min(BOXES, (p.F - n0) / 64);
      if constexpr (LN) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + trow + 8 * hr;
          mean[hr] = row < p.N ? p.stats[row] : 0.0f;
          rstd[hr] = row < p.N ? p.stats[p.N + row] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      // two steps an iteration, so that each fragment buffer is named
      // statically (a buffer is rebuilt once the group that read it is done)
      for (int ks = 0; ks < ksteps; ks += 2) {
        step(ks, a0, a1);
        if (ks + 1 < ksteps) step(ks + 1, a1, a0);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (LN) {
        fence_regs(a0);
        fence_regs(a1);
      }
      release(it - 1);

      // ---- epilogue: f32 adds, one rounding (none for OUT32), staged for
      // the TMA store ----
      if constexpr (LN || OUT32) {
        named_bar_sync(1 + wgi, 128);       // the previous store has read the staging
      }
      if constexpr (!LN) {
        // the residual tile has arrived (the bf16 mm_res always has one)
        if (p.has_res) mbar_wait(c_full, local & 1);
      }
      const bool has_bias = p.bias != nullptr;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        if (i / 8 >= boxes) continue;
        float2 bias = make_float2(0.0f, 0.0f);
        if (has_bias) bias = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 8 * i + 2 * quad));
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = trow + 8 * hr;
          uint32_t* cp = reinterpret_cast<uint32_t*>(
              cbuf + (i / 8) * S::c_box + r * 128 + (((i % 8) ^ (r % 8)) * 16) + 4 * quad);
          float v0 = acc[4 * i + 2 * hr];
          float v1 = acc[4 * i + 2 * hr + 1];
          if (has_bias) {
            v0 += bias.x;
            v1 += bias.y;
          }
          if constexpr (!LN) {
            if (p.has_res) {
              const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cp));
              v0 += res.x;
              v1 += res.y;
            }
          }
          if constexpr (OUT32) {
            // column 8 i + 2 quad: box i / 4 of 32 columns, 16-byte chunk
            // 2 (i % 4) + quad / 2 of the row, its half quad % 2
            float2* op = reinterpret_cast<float2*>(
                obuf + (i / 4) * S::o_box + r * 128 +
                (((2 * (i % 4) + quad / 2) ^ (r % 8)) * 16) + 8 * (quad % 2));
            *op = make_float2(v0, v1);
          } else {
            *cp = pack_bf16(v0, v1);
          }
        }
      }
      fence_proxy_async();                  // the staging's writes before the TMA reads
      named_bar_sync(1 + wgi, 128);
      if (tid == 0) {
        if (m0 + 64 * wgi < p.N) {
          if constexpr (OUT32) {
            for (int x = 0; x < 2 * boxes; ++x)
              tma_store_2d(&tm_out, obuf + x * S::o_box + wgi * (S::o_box / 2), n0 + 32 * x,
                           m0 + 64 * wgi);
          } else {
            for (int x = 0; x < boxes; ++x)
              tma_store_2d(&tm_out, cbuf + x * S::c_box + wgi * (S::c_box / 2), n0 + 64 * x,
                           m0 + 64 * wgi);
          }
          bulk_commit();
        }
        // OUT32: this consumer's rows of the residual were read before the
        // barrier above
        if constexpr (OUT32) {
          if (p.has_res) mbar_arrive(c_empty);
        }
        bulk_wait_read();
        if constexpr (!LN && !OUT32) mbar_arrive(c_empty);
      }
    }
  }
}

// Streaming multiprocessors of the current device (the persistent grid).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

// Encode the maps (A [N, K], W [K, F], out [N, F] (f32 for OUT32), res
// [N, F] or null), raise the kernel's shared memory limit and launch it on
// the persistent grid.
template <int BN, bool LN, bool OUT32 = false>
cudaError_t launch(const void* a, const void* w, void* out, const void* res,
                   const Params& params, cudaStream_t stream) {
  Params p = params;
  p.has_res = res != nullptr;
  CUtensorMap tm_a, tm_w, tm_out, tm_res;
  if (!make_2d_map(&tm_a, a, p.N, p.K, BM) || !make_2d_map(&tm_w, w, p.K, p.F, BK) ||
      !make_2d_map(&tm_out, out, p.N, p.F, 64, OUT32) ||
      !make_2d_map(&tm_res, res != nullptr ? res : a, p.N, p.F, 64))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = Smem<BN, LN, OUT32>::alloc;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, LN, OUT32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int tiles = ((p.N + BM - 1) / BM) * ((p.F + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<BN, LN, OUT32><<<grid, THREADS, bytes, stream>>>(tm_a, tm_w, tm_out, tm_res, p);
  return cudaGetLastError();
}

}  // namespace hgemm
