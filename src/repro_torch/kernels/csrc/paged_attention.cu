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
// bytes over the memory rate. At the main path's shapes that is ~1 us, below
// the launch floor: what is left is latency, so the work has to reach every
// SM at once.
//
// bfloat16, variant `split` (head dims that are multiples of 16 up to 128,
// and 256; 16-byte aligned operands): decode.cuh. One block per (KV head,
// batch row, tile of 16 query rows, split of 64 keys), a split wholly above the tile's
// last query position or before its window exiting at once; tensor-core
// products, cp.async loads, float32 partials merged in split order by a
// combine kernel. A decode step at B=4 is 4 x 16 x 3 splits = 192 blocks
// (the simt variant's 64). The appended keys are read from k_new / v_new,
// never from the pages: the block that owns a slot (its token's first query
// row's tile, the split of its position) writes it, and no block of the
// launch reads it back.
//
// float32, and the bf16 shapes the split variant does not take: variant
// `simt`, one block per (KV head, batch row, chunk of 64 query rows).
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
// The launch plan (variant, grid, shared memory, workspace) is made by the
// Python wrapper (`decode_plan`); this file checks it.
//
// Positions past the table width are never written (the plain-PyTorch
// reference routes them to the trash block instead), so callers compare
// outputs and live pages, never the trash page. On a block pool, drained
// rows all point at trash block 0 and may write it concurrently from
// several blocks; that race is harmless only because no live row reads a
// trash slot below its own query position.
#include "common.cuh"
#include "decode.cuh"
#include "sm90.cuh"

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
  const int2 keys = att_key_range(p0, r0, R, G, width, window);
  for (int k0 = keys.x; k0 < keys.y; k0 += ATT_TILE_K) {
    const int nk = min(ATT_TILE_K, width - k0);
    att_load_pages(sm, k_pages, v_pages, table, k0, nk, bs, Hkv, hd, h);
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

// The split variant (decode.cuh): block (x = tile * n_splits + s, h, b).
template <int HD>
__global__ void __launch_bounds__(dec::THREADS)
    paged_split_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* k_pages, __nv_bfloat16* v_pages,
                       const int* __restrict__ tables, const __nv_bfloat16* __restrict__ k_new,
                       const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ pos, float* ws_acc,
                       float2* ws_ml, int C, int Hq, int Hkv, int bs, int n_blocks, int window, float softcap,
                       float scale, int n_splits) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  dec::launch_dependents();
  dec::TileRows& tr = *reinterpret_cast<dec::TileRows*>(dsmem + dec::Layout<HD>::ROW_OFF);
  const int s = blockIdx.x % n_splits, tile = blockIdx.x / n_splits, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = C * G, width = n_blocks * bs;
  const int p0 = pos[b];
  if (threadIdx.x < dec::ROWS) {
    const int r = tile * dec::ROWS + threadIdx.x, c = r / G, g = r % G;
    const long long qoff = ((long long)(b * C + c) * Hq + h * G + g) * HD;
    dec::set_row(tr, threadIdx.x, r < R, qoff, (b * Hkv + h) * R + r, p0 + c, s, width, window);
  }
  __syncthreads();
  const int2 keys = dec::tile_keys(tr);
  if (keys.x > keys.y) return;  // no row of the tile reads this split
  const int* table = tables + (long long)b * n_blocks;
  dec::append_split<HD>(k_pages, v_pages, table, k_new, v_new, b, p0, C, G, Hkv, h, bs, width, tile, s);
  dec::split_tile<HD>(dsmem, tr, keys, q, k_pages, v_pages, table, k_new, v_new, b, p0, C, Hkv, h, bs, s, scale,
                      softcap, ws_acc, ws_ml, n_splits);
}

template <int HD>
int launch_paged_split(const void* q, void* kp, void* vp, const int* tables, const void* kn, const void* vn,
                       const int* pos, void* o, float* ws, int B, int C, int Hq, int Hkv, int bs, int n_blocks,
                       int window, float softcap, float scale, int grid_x, int smem, cudaStream_t stream) {
  const int R = C * (Hq / Hkv), n_splits = (n_blocks * bs + dec::SPLIT - 1) / dec::SPLIT;
  if (smem != dec::Layout<HD>::BYTES || grid_x != n_splits * ((R + dec::ROWS - 1) / dec::ROWS))
    return sm90::kPlanError;
  if (smem > 48 * 1024) {  // head dim 256: above the default dynamic shared memory
    static sm90::SmemOptIn opt_in;
    const cudaError_t e = opt_in.ensure(paged_split_kernel<HD>, smem);
    if (e != cudaSuccess) return e;
  }
  const long long rows = (long long)B * Hkv * R;
  float2* ws_ml = reinterpret_cast<float2*>(ws + rows * n_splits * HD);
  using bf = __nv_bfloat16;
  paged_split_kernel<HD><<<dim3(grid_x, Hkv, B), dec::THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<bf*>(kp), static_cast<bf*>(vp), tables, static_cast<const bf*>(kn),
      static_cast<const bf*>(vn), pos, ws, ws_ml, C, Hq, Hkv, bs, n_blocks, window, softcap, scale, n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dec::launch_combine<HD>(ws, pos, o, B, C, Hq, Hkv, n_blocks * bs, window, n_splits, stream);
}

}  // namespace repro

// q/o (B, C, Hq, hd), pages (N, bs, Hkv, hd), k_new/v_new (B, C, Hkv, hd),
// all dense; tables (B, n_blocks) and pos (B,) int32. `window` is 0 for a
// global layer. The launch plan comes from kernels/paged_attention.py
// (`decode_plan`): variant 1 = split (bf16; grid_x = splits x row tiles,
// `smem` dynamic bytes, `ws` a float32 workspace of B*Hkv*C*G*n_splits*(hd+2)
// floats; then the combine kernel), 0 = simt (grid_x = row chunks of 64, its
// own shared memory, no workspace). A plan this file does not take returns
// kPlanError (2000).
extern "C" int paged_attention_launch(const void* q, void* k_pages, void* v_pages,
                                      const void* tables, const void* k_new, const void* v_new,
                                      const void* pos, void* o, int dtype, int B, int C, int Hq,
                                      int Hkv, int hd, int bs, int n_blocks, int window,
                                      float softcap, float scale, int variant, int grid_x, int smem,
                                      void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  if (variant == 1) {
    if (dtype != repro::kBF16 || workspace == nullptr) return repro::sm90::kPlanError;
    float* ws = static_cast<float*>(workspace);
#define REPRO_PAGED_SPLIT(HD)                                                                              \
  return repro::launch_paged_split<HD>(q, k_pages, v_pages, t, k_new, v_new, p, o, ws, B, C, Hq, Hkv, bs, \
                                       n_blocks, window, softcap, scale, grid_x, smem, s);
    REPRO_DEC_HD_SWITCH(hd, REPRO_PAGED_SPLIT)
#undef REPRO_PAGED_SPLIT
  }
  const int rows = C * (Hq / Hkv);
  if (variant != 0 || smem != (int)repro::att_smem_bytes(hd) ||
      grid_x != (rows + repro::ATT_ROWS - 1) / repro::ATT_ROWS)
    return repro::sm90::kPlanError;
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = repro::launch_paged<__nv_bfloat16>(q, k_pages, v_pages, t, k_new, v_new, p, o, B, C, Hq, Hkv,
                                       hd, bs, n_blocks, window, softcap, scale, s);
  else
    err = repro::launch_paged<float>(q, k_pages, v_pages, t, k_new, v_new, p, o, B, C, Hq, Hkv, hd, bs,
                               n_blocks, window, softcap, scale, s);
  return static_cast<int>(err);
}
