// Fused paged append + decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py,
// `paged_attention` (body `_paged_kernel`): write the chunk's K/V
// (B, C, Hkv, hd) into the pages at logical positions pos[b] .. pos[b]+C-1
// through each row's block table, in place, then attend the chunk's queries
// (B, C, Hq, hd) over the row's logical KV view with a float32 online
// softmax. Validity is causality alone (stale slots always sit above the
// query position); a sliding window applies when the layer is not global
// (the caller passes window 0 for a global layer); logit softcap; GQA with
// the C*G query rows of one KV head handled together.
//
// What bounds it on this card: bytes. A decode step (C = 1) reads each
// row's K and V up to its position once and does 4 flops per key element,
// far below the card's ~295 flops per byte, so the least time is the K/V
// bytes over the memory rate.
//
// The design: one block per (KV head, batch row, chunk of 64 query rows).
// The block first stores the chunk's K/V by direct indexed stores into the
// slots their positions name (the TPU kernel's one-hot MXU select is a TPU
// workaround and is not copied), then __syncthreads() makes those global
// writes visible to the whole block before any of it reads the page. It
// then walks the keys 0 .. max query position in tiles of 32, resolving
// each key's page through block_tables[b, t / bs] and loading it by its
// physical id: no gathered view is ever built. Tiling is inside pages and
// independent of the page size, because under the static engine's identity
// table a "page" is a whole row of Smax tokens (e.g. 145), which is no
// power of two; the ragged last tile is masked. Keys past the last query
// position, and before a sliding window, are skipped: each query row keeps
// its own position as a valid key, so the result is exactly the full walk's.
//
// Positions past the table width are never written (the plain-PyTorch
// reference routes them to the trash block instead), so callers compare
// outputs and live pages, never the trash page. On a block pool, drained
// rows all point at trash block 0 and may write it concurrently from
// several blocks; that race is harmless only because no live row reads a
// trash slot below its own query position.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    paged_attention_kernel(const T* __restrict__ q, T* k_pages, T* v_pages,
                           const int* __restrict__ tables, const T* __restrict__ k_new,
                           const T* __restrict__ v_new, const int* __restrict__ pos,
                           T* __restrict__ o, int C, int Hq, int Hkv, int hd, int bs,
                           int n_blocks, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const AttSmem sm = att_smem_layout(smem, hd);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int r0 = blockIdx.z * ATT_ROWS;
  const int R = min(ATT_ROWS, C * G - r0);
  const int p0 = pos[b];
  const int* table = tables + (long long)b * n_blocks;
  const int width = n_blocks * bs;  // logical positions the table covers
  const long long page_stride = (long long)bs * Hkv * hd, slot_stride = (long long)Hkv * hd;

  // 1. append the chunk: token c lands at logical position p0 + c
  for (int idx = threadIdx.x; idx < C * hd; idx += ATT_THREADS) {
    const int c = idx / hd, d = idx % hd;
    const int t = p0 + c;
    if (t >= 0 && t < width) {
      const long long dst = table[t / bs] * page_stride + (t % bs) * slot_stride + h * hd + d;
      const long long src = ((long long)(b * C + c) * Hkv + h) * hd + d;
      k_pages[dst] = k_new[src];
      v_pages[dst] = v_new[src];
    }
  }

  // 2. this block's query rows: row r0 + r is (chunk token c, group member g)
  float acc[ATT_ACC];
  att_init(sm, acc);
  for (int idx = threadIdx.x; idx < R * hd; idx += ATT_THREADS) {
    const int r = idx / hd, d = idx % hd;
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    sm.q[r * hd + d] = to_f32(q[((long long)(b * C + c) * Hq + h * G + g) * hd + d]);
  }
  for (int r = threadIdx.x; r < R; r += ATT_THREADS) sm.qpos[r] = p0 + (r0 + r) / G;
  __syncthreads();  // the appended K/V are visible to every thread below

  // 3. walk the keys that can be valid for some row of this block
  const int c_lo = r0 / G, c_hi = (r0 + R - 1) / G;
  int k_begin = 0, k_end = width;
  if (p0 >= 0) {
    k_end = min(width, p0 + c_hi + 1);
    if (window > 0) k_begin = max(0, p0 + c_lo - window + 1);
  }
  k_begin -= k_begin % ATT_TILE_K;
  for (int k0 = k_begin; k0 < k_end; k0 += ATT_TILE_K) {
    const int nk = min(ATT_TILE_K, width - k0);
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
    __syncthreads();
    att_tile(sm, acc, R, hd, k0, nk, scale, softcap, true, window);
  }
  att_finish(sm, acc, R, hd, o, [=](int r, int d) {
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    return ((long long)(b * C + c) * Hq + h * G + g) * hd + d;
  });
}

template <typename T>
cudaError_t launch_paged(const void* q, void* kp, void* vp, const int* tables, const void* kn,
                   const void* vn, const int* pos, void* o, int B, int C, int Hq, int Hkv,
                   int hd, int bs, int n_blocks, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const size_t smem = att_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = C * (Hq / Hkv);
  dim3 grid(Hkv, B, (rows + ATT_ROWS - 1) / ATT_ROWS);
  paged_attention_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kp), static_cast<T*>(vp), tables,
      static_cast<const T*>(kn), static_cast<const T*>(vn), pos, static_cast<T*>(o), C, Hq, Hkv,
      hd, bs, n_blocks, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace repro

// q/o (B, C, Hq, hd), pages (N, bs, Hkv, hd), k_new/v_new (B, C, Hkv, hd),
// all dense; tables (B, n_blocks) and pos (B,) int32. `window` is 0 for a
// global layer.
extern "C" int paged_attention_launch(const void* q, void* k_pages, void* v_pages,
                                      const void* tables, const void* k_new, const void* v_new,
                                      const void* pos, void* o, int dtype, int B, int C, int Hq,
                                      int Hkv, int hd, int bs, int n_blocks, int window,
                                      float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = repro::launch_paged<__nv_bfloat16>(q, k_pages, v_pages, t, k_new, v_new, p, o, B, C, Hq, Hkv,
                                       hd, bs, n_blocks, window, softcap, scale, s);
  else
    err = repro::launch_paged<float>(q, k_pages, v_pages, t, k_new, v_new, p, o, B, C, Hq, Hkv, hd, bs,
                               n_blocks, window, softcap, scale, s);
  return static_cast<int>(err);
}
