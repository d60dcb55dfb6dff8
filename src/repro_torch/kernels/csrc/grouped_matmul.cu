// Grouped (per-expert) matmul for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/grouped_matmul.py,
// `grouped_matmul` (body `_gmm_kernel`): (E, C, d) x (E, d, f) -> (E, C, f),
// one product per expert over its capacity slab, float32 accumulation,
// output in the lhs type.
//
// What bounds it on this card: the weight bytes. On the main path
// (DeepSeekMoE-16B, E = 64, d = 2048, f = 1408) one call reads
// 64 * 2048 * 1408 * 2 B = 369 MB of expert weights while C is 8 (decode,
// batch 4; the continuous chunk), 16 (a fused chunk + decode step) or 64
// (static prefill): 8 to 64 flops per weight element, far under the ~295
// flops per byte at which the card turns compute bound. So a call takes at
// least ~110 us at 3.35 TB/s, and it needs many weight bytes in flight on
// every SM to get there.
//
// bfloat16 (the serving type), variant `wgmma`: the product is computed
// transposed, out[e]^T = W[e]^T . lhs[e]^T, so the weight tile is the wgmma
// A operand (M = 64 columns of f, MN-major as W is stored, transpose bit
// set) and the capacity rows are B (N = the rows of a pass rounded up to an
// instantiated width, 8..128, K-major as stored): a decode call is
// m64n8k16 and multiplies no padding. An item is 64 or 128 f columns (one
// or two M tiles sharing the lhs tile). One producer warp keeps the plan's
// stages (4 on the main path) of (weight boxes of 64 x 64, N x 64 lhs tile)
// in flight by TMA, each stage completing on its "full" mbarrier; one
// consumer warpgroup runs wgmma on the stages that have arrived and hands
// them back through "empty" barriers. The weight tile passes through
// shared memory, where a dequant stage can later sit. Blocks are
// persistent: one per SM walks the items (expert, f tile, row pass)
// round-robin, so neighbouring blocks read neighbouring columns of the
// same weight rows at the same time (a schedule that gave each block a
// contiguous run instead lost that locality and ran 20-40% slower), and no
// block has more than one item above another. Each output element is
// summed by one warpgroup in one K order (no split-K, no atomics): two
// calls give the same bits. Tensor maps are 3-D (innermost first: W {f, d, E}, lhs
// {d, C, E}), so ragged d, C and f tiles arrive as zeros, and an empty
// capacity slot (a zero lhs row) comes out exactly zero. The launch plan
// (variant, tiles, stages, N, grid, shared memory) is made by the Python
// wrapper; this file checks it.
//
// Variant `simt`: float32 (the card tests hold f32 engines to 1e-4), and
// bfloat16 where a tensor map cannot describe the operands (d or f not a
// multiple of 8, an operand not 16-byte aligned): tiles of 32 prefetched
// into registers, the rows per pass a template parameter (8..64).
#include "common.cuh"
#include "sm90.cuh"

namespace repro {

constexpr int GMM_THREADS = 256;
constexpr int GMM_BF = 128;  // output columns per block
constexpr int GMM_BK = 32;   // contraction depth per tile (SIMT path)

// ---------------------------------------------------------------------------
// simt (float32; bf16 that TMA cannot describe): 4 columns per lane, CT rows
// per pass
// ---------------------------------------------------------------------------
template <typename T, int CT>
__global__ void __launch_bounds__(GMM_THREADS)
    grouped_matmul_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                          T* __restrict__ out, int C, int d, int f) {
  constexpr int RPT = CT / 8;  // rows per thread: 8 warps share the CT rows
  constexpr int A_PER = CT * GMM_BK / GMM_THREADS;
  constexpr int B_PER = GMM_BK * GMM_BF / GMM_THREADS;
  __shared__ float sA[CT][GMM_BK + 1];
  __shared__ float sB[GMM_BK][GMM_BF];

  const int e = blockIdx.y, f0 = blockIdx.x * GMM_BF;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const T* A = lhs + (long long)e * C * d;
  const T* W = rhs + (long long)e * d * f;
  T* O = out + (long long)e * C * f;

  for (int c0 = 0; c0 < C; c0 += CT) {
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float ra[A_PER], rb[B_PER];

    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * GMM_THREADS;
        const int r = idx / GMM_BK, k = k0 + idx % GMM_BK;
        ra[i] = (c0 + r < C && k < d) ? to_f32(A[(long long)(c0 + r) * d + k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * GMM_THREADS;
        const int k = k0 + idx / GMM_BF, col = f0 + idx % GMM_BF;
        rb[i] = (k < d && col < f) ? to_f32(W[(long long)k * f + col]) : 0.f;
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int idx = tid + i * GMM_THREADS;
        sA[idx / GMM_BK][idx % GMM_BK] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int idx = tid + i * GMM_THREADS;
        sB[idx / GMM_BF][idx % GMM_BF] = rb[i];
      }
    };

    load(0);
    store();
    __syncthreads();
    for (int k0 = 0; k0 < d; k0 += GMM_BK) {
      const bool more = k0 + GMM_BK < d;
      if (more) load(k0 + GMM_BK);  // in flight while this tile is multiplied
#pragma unroll 8
      for (int kk = 0; kk < GMM_BK; ++kk) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = sA[ty + 8 * i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
      __syncthreads();
      if (more) {
        store();
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = c0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = f0 + tx + 32 * j;
        if (row < C && col < f) O[(long long)row * f + col] = from_f32<T>(acc[i][j]);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma over a TMA ring, persistent blocks
// ---------------------------------------------------------------------------
constexpr int WG_BM = 64;   // f columns per wgmma (its M): one 128-byte TMA box
constexpr int WG_BK = 64;   // contraction depth per stage: 128-byte rows
constexpr int WG_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int WG_BOX_BYTES = WG_BK * WG_BM * 2;

// A stage holds MT weight boxes (MT * 64 f columns x 64 of d) and the lhs
// tile (N rows x 64 of d).
__host__ __device__ constexpr int wg_stage_bytes(int n, int mt) { return mt * WG_BOX_BYTES + n * WG_BK * 2; }

template <int N, int MT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    grouped_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
                                __nv_bfloat16* __restrict__ out, int E, int C, int d, int f, int stages,
                                int n_ft, int passes) {
  using namespace sm90;
  constexpr int STAGE = wg_stage_bytes(N, MT);
  constexpr int X_OFF = MT * WG_BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * STAGE);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int items = E * n_ft * passes;
  const int k_tiles = (d + WG_BK - 1) / WG_BK;
  // item i: pass i % passes of f tile (i / passes) % n_ft of expert
  // i / (passes * n_ft); block b takes items b, b + grid, ...
  if (warp == 4) {
    if (lane == 0) {
      tma_prefetch_map(&w_map);
      tma_prefetch_map(&x_map);
      int s = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int p = it % passes, ft = (it / passes) % n_ft, e = it / (passes * n_ft);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          uint8_t* st = base + s * STAGE;
          mbar_arrive_expect_tx(&full[s], STAGE);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tma_load_3d(st + mt * WG_BOX_BYTES, &w_map, &full[s], (ft * MT + mt) * WG_BM, kt * WG_BK, e);
          tma_load_3d(st + X_OFF, &x_map, &full[s], kt * WG_BK, p * N, e);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup: of each 64-column block mt, thread t holds rows
  // 16w + l/4 (+8) of the f columns and columns 8j + 2(l%4) (+1) of the N
  // capacity rows
  int s = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int p = it % passes, ft = (it / passes) % n_ft, e = it / (passes * n_ft);
    float acc[MT][Wgmma<N>::kRegs];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < Wgmma<N>::kRegs; ++i) acc[mt][i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[s], phase);
      const uint8_t* st = base + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // B: the lhs tile, N rows of 64 k: step 32 bytes along the row
        const uint64_t db = make_desc<128>(st + X_OFF + kk * 32, 16, 8 * 128);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A: a weight box, rows along k (128 B of f each): step 16 rows
          const uint64_t da = make_desc<128>(st + mt * WG_BOX_BYTES + kk * 16 * 128, WG_BOX_BYTES, 8 * 128);
          Wgmma<N>::template ss<1, 0>(acc[mt], da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
      mbar_arrive(&empty[s]);
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    // epilogue: out[e][c][f0 + m] = D[m][c], ragged rows and columns masked
    __nv_bfloat16* O = out + (long long)e * C * f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = (ft * MT + mt) * WG_BM + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = p * N + 8 * j + 2 * (lane % 4) + i, col = m0 + 8 * h;
            if (c < C && col < f) O[(long long)c * f + col] = __float2bfloat16(acc[mt][4 * j + 2 * h + i]);
          }
    }
  }
}

template <typename T>
cudaError_t launch_gmm_simt(const void* lhs, const void* rhs, void* out, int E, int C, int d, int f, int ct,
                            int grid_x, cudaStream_t stream) {
  dim3 grid(grid_x, E);
  const T* a = static_cast<const T*>(lhs);
  const T* w = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  switch (ct) {
    case 8: grouped_matmul_kernel<T, 8><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f); break;
    case 16: grouped_matmul_kernel<T, 16><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f); break;
    case 32: grouped_matmul_kernel<T, 32><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f); break;
    case 64: grouped_matmul_kernel<T, 64><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f); break;
    default: return static_cast<cudaError_t>(sm90::kPlanError);
  }
  return cudaGetLastError();
}

template <int N, int MT>
int launch_gmm_wgmma_n(const void* lhs, const void* rhs, void* out, int E, int C, int d, int f, int stages,
                       int grid_x, int smem, cudaStream_t stream) {
  const int n_ft = (f + MT * WG_BM - 1) / (MT * WG_BM), passes = (C + N - 1) / N;
  const int need = 1024 + stages * (wg_stage_bytes(N, MT) + 16);
  if (stages < 2 || smem < need || smem > 232448 || grid_x < 1) return sm90::kPlanError;
  CUtensorMap w_map, x_map;
  const uint64_t w_dims[3] = {(uint64_t)f, (uint64_t)d, (uint64_t)E};
  const uint64_t w_str[3] = {1, (uint64_t)f, (uint64_t)d * f};
  const uint32_t w_box[3] = {WG_BM, WG_BK, 1};
  const uint64_t x_dims[3] = {(uint64_t)d, (uint64_t)C, (uint64_t)E};
  const uint64_t x_str[3] = {1, (uint64_t)d, (uint64_t)C * d};
  const uint32_t x_box[3] = {WG_BK, N, 1};
  int err = sm90::encode_tile_map(&w_map, rhs, 3, w_dims, w_str, w_box, 128);
  if (err) return err;
  err = sm90::encode_tile_map(&x_map, lhs, 3, x_dims, x_str, x_box, 128);
  if (err) return err;
  static sm90::SmemOptIn opt_in;
  cudaError_t e = opt_in.ensure(grouped_matmul_wgmma_kernel<N, MT>, smem);
  if (e != cudaSuccess) return e;
  grouped_matmul_wgmma_kernel<N, MT><<<grid_x, WG_THREADS, smem, stream>>>(
      w_map, x_map, static_cast<__nv_bfloat16*>(out), E, C, d, f, stages, n_ft, passes);
  return cudaGetLastError();
}

int launch_gmm_wgmma(const void* lhs, const void* rhs, void* out, int E, int C, int d, int f, int bm, int n,
                     int stages, int grid_x, int smem, cudaStream_t stream) {
#define REPRO_GMM_N(NN)                                                                                        \
  case NN:                                                                                                     \
    return bm == WG_BM ? launch_gmm_wgmma_n<NN, 1>(lhs, rhs, out, E, C, d, f, stages, grid_x, smem, stream)    \
                       : launch_gmm_wgmma_n<NN, 2>(lhs, rhs, out, E, C, d, f, stages, grid_x, smem, stream);
  if (bm != WG_BM && bm != 2 * WG_BM) return sm90::kPlanError;
  switch (n) {
    REPRO_GMM_N(8) REPRO_GMM_N(16) REPRO_GMM_N(24) REPRO_GMM_N(32) REPRO_GMM_N(48) REPRO_GMM_N(64)
    REPRO_GMM_N(80) REPRO_GMM_N(96) REPRO_GMM_N(112) REPRO_GMM_N(128)
    default: return sm90::kPlanError;
  }
#undef REPRO_GMM_N
}

}  // namespace repro

// lhs (E, C, d), rhs (E, d, f), out (E, C, f), all dense. The launch plan
// comes from kernels/grouped_matmul.py: variant 1 = wgmma (bf16; tiles
// bm x bk = 64 or 128 x 64, n capacity rows per pass, `stages`, a 1-D persistent
// grid of grid_x blocks, `smem` dynamic bytes), 0 = simt (tiles 128 x 32,
// n rows per pass, a grid of grid_x f tiles x E). A plan this file does not
// take returns kPlanError (2000); a failed tensor-map encode 1000 + CUresult.
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs, void* out, int dtype, int E, int C, int d,
                                     int f, int variant, int bm, int bk, int n, int stages, int grid_x, int smem,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != repro::kBF16 || bk != repro::WG_BK) return repro::sm90::kPlanError;
    return repro::launch_gmm_wgmma(lhs, rhs, out, E, C, d, f, bm, n, stages, grid_x, smem, s);
  }
  if (variant != 0 || bm != repro::GMM_BF || bk != repro::GMM_BK || smem != 0) return repro::sm90::kPlanError;
  cudaError_t err = dtype == repro::kBF16
                        ? repro::launch_gmm_simt<__nv_bfloat16>(lhs, rhs, out, E, C, d, f, n, grid_x, s)
                        : repro::launch_gmm_simt<float>(lhs, rhs, out, E, C, d, f, n, grid_x, s);
  return static_cast<int>(err);
}
