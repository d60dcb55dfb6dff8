// Shared device helpers of the repro_torch Hopper kernels: element-type
// conversion and the attention tile step that the flash (prefill) and the
// paged (decode) kernels both run over a K/V tile held in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Finite f32 mask value, as in the TPU kernels: a fully masked tile gives
// exp(NEG_INF - NEG_INF) = 1 (finite garbage), and the first tile with a
// valid key rescales it away with alpha = exp(NEG_INF - m) = 0 exactly.
// -inf would give NaN there. Key slots past the end of the sequence (a
// ragged last tile) get a true -inf instead, so they add exactly zero even
// to a row that has seen no valid key yet.
constexpr float NEG_INF = -2.0e38f;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Online-softmax attention over K/V tiles in shared memory.
//
// A block owns up to ATT_ROWS query rows (one head's queries: a q tile in
// the flash kernel, the C*G rows of one KV head in the paged kernel) and
// walks its keys in tiles of ATT_TILE_K. Shared memory, in floats:
//   q   [ATT_ROWS][hd]           query rows
//   k   [ATT_TILE_K][hd + 1]     key tile (padded: conflict-free column reads)
//   v   [ATT_TILE_K][hd]         value tile
//   s   [ATT_ROWS][ATT_TILE_K+1] scores, then probabilities
//   m, l, alpha [ATT_ROWS]       running max, running sum, rescale factor
//   qpos [ATT_ROWS] (int)        query positions for the causal mask
// Each thread keeps ATT_ACC (row, dim) accumulators in registers.
// ---------------------------------------------------------------------------
constexpr int ATT_THREADS = 256;
constexpr int ATT_ROWS = 64;
constexpr int ATT_TILE_K = 32;  // one key per lane in the row-statistics pass
constexpr int ATT_HD_MAX = 256;
constexpr int ATT_ACC = ATT_ROWS * ATT_HD_MAX / ATT_THREADS;

struct AttSmem {
  float* q;
  float* k;
  float* v;
  float* s;
  float* m;
  float* l;
  float* alpha;
  int* qpos;
};

__host__ __device__ inline size_t att_smem_bytes(int hd) {
  return sizeof(float) * (size_t(ATT_ROWS) * hd + size_t(ATT_TILE_K) * (hd + 1) +
                          size_t(ATT_TILE_K) * hd + size_t(ATT_ROWS) * (ATT_TILE_K + 1) +
                          3 * ATT_ROWS) +
         sizeof(int) * ATT_ROWS;
}

__device__ inline AttSmem att_smem_layout(float* base, int hd) {
  AttSmem sm;
  sm.q = base;
  sm.k = sm.q + ATT_ROWS * hd;
  sm.v = sm.k + ATT_TILE_K * (hd + 1);
  sm.s = sm.v + ATT_TILE_K * hd;
  sm.m = sm.s + ATT_ROWS * (ATT_TILE_K + 1);
  sm.l = sm.m + ATT_ROWS;
  sm.alpha = sm.l + ATT_ROWS;
  sm.qpos = reinterpret_cast<int*>(sm.alpha + ATT_ROWS);
  return sm;
}

__device__ inline void att_init(const AttSmem& sm, float* acc) {
  for (int r = threadIdx.x; r < ATT_ROWS; r += blockDim.x) {
    sm.m[r] = NEG_INF;
    sm.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ATT_ACC; ++i) acc[i] = 0.f;
}

// One tile step over query rows r_lo .. r_hi-1, for those rows r where
// active(r) holds (the others keep their m, l and accumulators): keys k0 ..
// k0+nk-1 are loaded in sm.k / sm.v (slots nk..ATT_TILE_K-1 absent). Mask:
// causal (kpos <= qpos), window > 0 limits to qpos - kpos < window. Each
// active row's arithmetic is the same whatever the other rows do, so a row
// given the same tiles in the same order gets the same bits. Ends with a
// barrier, so the caller may reload.
template <typename Active>
__device__ inline void att_tile_rows(const AttSmem& sm, float* acc, int r_lo, int r_hi, int hd,
                                     int k0, int nk, float scale, float softcap, bool causal,
                                     int window, Active active) {
  const int tid = threadIdx.x;
  // scores: one (row, key) pair per thread per step
  for (int idx = tid; idx < (r_hi - r_lo) * ATT_TILE_K; idx += ATT_THREADS) {
    const int r = r_lo + idx / ATT_TILE_K, j = idx % ATT_TILE_K;
    if (!active(r)) continue;
    float s = neg_inf();
    if (j < nk) {
      const float* qr = sm.q + r * hd;
      const float* kj = sm.k + j * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kj[d], dot);
      s = dot * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kpos = k0 + j, qpos = sm.qpos[r];
      bool ok = true;
      if (causal) {
        ok = kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
      }
      if (!ok) s = NEG_INF;
    }
    sm.s[r * (ATT_TILE_K + 1) + j] = s;
  }
  __syncthreads();
  // row statistics: one warp per row, one key per lane
  const int warp = tid / 32, lane = tid % 32;
  for (int r = r_lo + warp; r < r_hi; r += ATT_THREADS / 32) {
    if (!active(r)) continue;  // the same r for the whole warp
    float* sr = sm.s + r * (ATT_TILE_K + 1);
    const float s = sr[lane];
    const float m_prev = sm.m[r];
    const float m_cur = fmaxf(m_prev, warp_max(s));
    const float p = expf(s - m_cur);
    const float sum = warp_sum(p);
    sr[lane] = p;
    if (lane == 0) {
      const float alpha = expf(m_prev - m_cur);
      sm.alpha[r] = alpha;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_cur;
    }
  }
  __syncthreads();
  // P @ V: one (row, dim) pair per accumulator
#pragma unroll
  for (int i = 0; i < ATT_ACC; ++i) {
    const int idx = tid + i * ATT_THREADS;
    const int r = idx / hd, d = idx % hd;
    if (r >= r_lo && r < r_hi && active(r)) {
      const float* pr = sm.s + r * (ATT_TILE_K + 1);
      float o = acc[i] * sm.alpha[r];
      for (int j = 0; j < nk; ++j) o = fmaf(pr[j], sm.v[j * hd + d], o);
      acc[i] = o;
    }
  }
  __syncthreads();
}

// The tile step for all R rows of the block.
__device__ inline void att_tile(const AttSmem& sm, float* acc, int R, int hd, int k0, int nk,
                                float scale, float softcap, bool causal, int window) {
  att_tile_rows(sm, acc, 0, R, hd, k0, nk, scale, softcap, causal, window,
                [](int) { return true; });
}

// The keys a paged-decode block walks: its query rows r0 .. r0+R-1 of one
// batch row (row r is chunk token r / G) sit at positions p0 + r / G. Keys
// past the last query, and before the first query's sliding window, are
// skipped: each row keeps its own position as a valid key, so the result is
// the full walk's. Returns [begin, end) with begin a multiple of ATT_TILE_K.
__device__ inline int2 att_key_range(int p0, int r0, int R, int G, int width, int window) {
  const int c_lo = r0 / G, c_hi = (r0 + R - 1) / G;
  int k_begin = 0, k_end = width;
  if (p0 >= 0) {
    k_end = min(width, p0 + c_hi + 1);
    if (window > 0) k_begin = max(0, p0 + c_lo - window + 1);
  }
  return make_int2(k_begin - k_begin % ATT_TILE_K, k_end);
}

// Load keys k0 .. k0+nk-1 of KV head h from a block pool (N, bs, Hkv, hd)
// into sm.k / sm.v, resolving each key's page through `table` (one row of
// a block table); slots nk.. are zero. The caller syncs before using them.
template <typename T>
__device__ inline void att_load_pages(const AttSmem& sm, const T* k_pages, const T* v_pages,
                                      const int* table, int k0, int nk, int bs, int Hkv, int hd,
                                      int h) {
  const long long page_stride = (long long)bs * Hkv * hd, slot_stride = (long long)Hkv * hd;
  for (int idx = threadIdx.x; idx < ATT_TILE_K * hd; idx += ATT_THREADS) {
    const int j = idx / hd, d = idx % hd;
    float kv = 0.f, vv = 0.f;
    if (j < nk) {
      const int t = k0 + j;
      const long long a = table[t / bs] * page_stride + (t % bs) * slot_stride + h * hd + d;
      kv = to_f32(k_pages[a]);
      vv = to_f32(v_pages[a]);
    }
    sm.k[j * (hd + 1) + d] = kv;
    sm.v[j * hd + d] = vv;
  }
}

// out(r, d) = acc / max(l, 1e-30), written through a caller-given address.
template <typename T, typename Addr>
__device__ inline void att_finish(const AttSmem& sm, const float* acc, int R, int hd, T* out,
                                  Addr addr) {
#pragma unroll
  for (int i = 0; i < ATT_ACC; ++i) {
    const int idx = threadIdx.x + i * ATT_THREADS;
    const int r = idx / hd, d = idx % hd;
    if (r < R) out[addr(r, d)] = from_f32<T>(acc[i] / fmaxf(sm.l[r], 1e-30f));
  }
}

}  // namespace repro
