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
// batch 4) or 64 (prefill, 512 tokens): 8 to 64 flops per weight element,
// well under the ~295 flops per byte at which the card turns compute bound.
// So a call takes at least 110 us at 3.35 TB/s, and a decode step's 84 calls
// at least ~9.3 ms.
//
// The design follows from that: one block per (f tile of 128 columns,
// expert) holds all C rows of its expert (up to 64 at a time; larger C
// walks in passes of 64 rows) and loops over d with the partial sums in
// registers, so each weight byte is read from device memory once per call.
// Ragged C, d and f tiles are masked; empty capacity slots hold the zero
// sentinel row and so come out zero.
//
// bfloat16 (the serving type) multiplies on the tensor cores: WMMA bf16
// fragments, 16x16x16, float32 accumulators. Each of the 8 warps owns 16 of
// the block's columns and every 16-row fragment of the pass. Tiles of 32
// along d stream in by 16-byte cp.async into two shared-memory buffers, so
// the next tile's bytes are in flight while the current one multiplies;
// where a row is not 16-byte aligned (d or f not a multiple of 8) the
// loader falls back to masked element loads. float32 has no full-precision
// WMMA fragment, so it keeps a SIMT kernel: tiles of 32 prefetched into
// registers, the rows per pass a template parameter (8..64) so a decode call
// spends no arithmetic on empty rows. wgmma and TMA are later work.
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int GMM_THREADS = 256;
constexpr int GMM_BF = 128;  // output columns per block
constexpr int GMM_BK = 32;   // contraction depth per tile (SIMT path)

// ---------------------------------------------------------------------------
// float32: SIMT, 4 columns per lane, CT rows per pass
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
// bfloat16: tensor cores through WMMA
// ---------------------------------------------------------------------------
constexpr int TC_BK = 32;           // depth per stage: two k-steps of 16
constexpr int TC_LDA = TC_BK + 8;   // padded shared rows (bf16): 80 bytes
constexpr int TC_LDB = GMM_BF + 8;  // 272 bytes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// MT 16-row fragments per pass (C <= 16 * MT, or passes of 64 rows).
template <int MT>
__global__ void __launch_bounds__(GMM_THREADS)
    grouped_matmul_tc_kernel(const __nv_bfloat16* __restrict__ lhs,
                             const __nv_bfloat16* __restrict__ rhs, __nv_bfloat16* __restrict__ out,
                             int C, int d, int f, int vec) {
  using namespace nvcuda;
  constexpr int ROWS = 16 * MT;
  __shared__ __align__(128) __nv_bfloat16 sA[2][ROWS][TC_LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[2][TC_BK][TC_LDB];
  __shared__ __align__(128) float stage[GMM_THREADS / 32][16 * 16];

  const int e = blockIdx.y, f0 = blockIdx.x * GMM_BF;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* A = lhs + (long long)e * C * d;
  const __nv_bfloat16* W = rhs + (long long)e * d * f;
  __nv_bfloat16* O = out + (long long)e * C * f;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  for (int c0 = 0; c0 < C; c0 += ROWS) {
    // one stage: rows c0.. of A and 32 rows of W, in chunks of 8 elements
    auto load = [&](int buf, int k0) {
      for (int ch = tid; ch < ROWS * (TC_BK / 8); ch += GMM_THREADS) {
        const int r = ch / (TC_BK / 8), kc = (ch % (TC_BK / 8)) * 8;
        const int row = c0 + r, k = k0 + kc;
        __nv_bfloat16* dst = &sA[buf][r][kc];
        if (vec && row < C && k + 8 <= d) {
          cp_async16(dst, A + (long long)row * d + k);
        } else {
          for (int i = 0; i < 8; ++i)
            dst[i] = (row < C && k + i < d) ? A[(long long)row * d + k + i] : zero;
        }
      }
      for (int ch = tid; ch < TC_BK * (GMM_BF / 8); ch += GMM_THREADS) {
        const int kr = ch / (GMM_BF / 8), cc = (ch % (GMM_BF / 8)) * 8;
        const int k = k0 + kr, col = f0 + cc;
        __nv_bfloat16* dst = &sB[buf][kr][cc];
        if (vec && k < d && col + 8 <= f) {
          cp_async16(dst, W + (long long)k * f + col);
        } else {
          for (int i = 0; i < 8; ++i)
            dst[i] = (k < d && col + i < f) ? W[(long long)k * f + col + i] : zero;
        }
      }
      cp_async_commit();
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) wmma::fill_fragment(acc[m], 0.f);

    const int n_tiles = (d + TC_BK - 1) / TC_BK;
    load(0, 0);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) {
        load((t + 1) & 1, (t + 1) * TC_BK);  // in flight while tile t multiplies
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int buf = t & 1;
#pragma unroll
      for (int kk = 0; kk < TC_BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &sB[buf][kk][warp * 16], TC_LDB);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, &sA[buf][m * 16][kk], TC_LDA);
          wmma::mma_sync(acc[m], a, b, acc[m]);
        }
      }
      __syncthreads();  // buffer `buf` is refilled by the next iteration's load
    }

    // epilogue: each warp stages one 16x16 fragment at a time, masked store
    float* st = stage[warp];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::store_matrix_sync(st, acc[m], 16, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 256; i += 32) {
        const int row = c0 + m * 16 + i / 16, col = f0 + warp * 16 + i % 16;
        if (row < C && col < f) O[(long long)row * f + col] = __float2bfloat16(st[i]);
      }
      __syncwarp();
    }
  }
}

cudaError_t launch_gmm_f32(const void* lhs, const void* rhs, void* out, int E, int C, int d, int f,
                           cudaStream_t stream) {
  dim3 grid((f + GMM_BF - 1) / GMM_BF, E);
  const float* a = static_cast<const float*>(lhs);
  const float* w = static_cast<const float*>(rhs);
  float* o = static_cast<float*>(out);
  if (C <= 8)
    grouped_matmul_kernel<float, 8><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f);
  else if (C <= 16)
    grouped_matmul_kernel<float, 16><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f);
  else if (C <= 32)
    grouped_matmul_kernel<float, 32><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f);
  else
    grouped_matmul_kernel<float, 64><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f);
  return cudaGetLastError();
}

cudaError_t launch_gmm_tc(const void* lhs, const void* rhs, void* out, int E, int C, int d, int f,
                          cudaStream_t stream) {
  dim3 grid((f + GMM_BF - 1) / GMM_BF, E);
  const auto* a = static_cast<const __nv_bfloat16*>(lhs);
  const auto* w = static_cast<const __nv_bfloat16*>(rhs);
  auto* o = static_cast<__nv_bfloat16*>(out);
  // 16-byte copies need every row start 16-byte aligned
  const int vec = d % 8 == 0 && f % 8 == 0 && reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
  if (C <= 16)
    grouped_matmul_tc_kernel<1><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f, vec);
  else if (C <= 32)
    grouped_matmul_tc_kernel<2><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f, vec);
  else if (C <= 48)
    grouped_matmul_tc_kernel<3><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f, vec);
  else
    grouped_matmul_tc_kernel<4><<<grid, GMM_THREADS, 0, stream>>>(a, w, o, C, d, f, vec);
  return cudaGetLastError();
}

}  // namespace repro

// lhs (E, C, d), rhs (E, d, f), out (E, C, f), all dense.
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs, void* out, int dtype, int E,
                                     int C, int d, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == repro::kBF16
                        ? repro::launch_gmm_tc(lhs, rhs, out, E, C, d, f, s)
                        : repro::launch_gmm_f32(lhs, rhs, out, E, C, d, f, s);
  return static_cast<int>(err);
}
