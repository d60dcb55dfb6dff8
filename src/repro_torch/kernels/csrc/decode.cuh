// The bfloat16 `split` variant of the paged and prefix-paged decode
// attention kernels (paged_attention.cu, prefix_paged_attention.cu): the
// key walk split across blocks (flash-decoding), products on tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulators), K/V tiles brought in
// by 16-byte cp.async, and a combine kernel that merges each query row's
// split partials in split order.
//
// The work. A query row is (batch row b, KV head h, row r of the C*G rows of
// that head: chunk token r / G, group member r % G) at position
// p = pos[b] + r / G. Its valid keys are [lo, hi] = [max(0, p - window + 1)
// (0 for a global layer), min(p, width - 1)], width = n_blocks * bs; the
// keys are cut into splits of SPLIT = 64 aligned at position 0, and the row
// needs splits lo / SPLIT .. hi / SPLIT (none when lo > hi: a row at a
// negative position, which gives 0). A block computes one split for a tile
// of up to 16 rows: its partial (m, l, acc[hd]) per row goes to a float32
// workspace, slot (row, split). Every split a row needs holds at least one
// of its valid keys, so m is finite in every partial the combine reads.
//
// The combine kernel runs in the same call (one wrapper call, one count):
// one warp per query row merges the row's partials in split order, never
// in arrival order, so the bits do not depend on scheduling. It is launched
// as a programmatic dependent of the split kernel, so its blocks are placed
// and read their positions while the splits run, and wait for the split
// grid's results (griddepcontrol.wait) only before reading the workspace. A
// second launch measured faster than a ticket per row with the merge in the
// block that finishes the row last (its merges run one after another).
//
// Inside a block (4 warps): Q (16 rows) and the split's K arrive in one
// cp.async group, V in a second, so S = Q K^T starts while V lands. Warp w
// scores keys 16w .. 16w+15 against all 16 rows; each row's max and sum are
// reduced over the quad of lanes that holds it, then over the 4 warps in
// warp order through shared memory. P is rounded to bf16 (as the flash
// kernel's wgmma path does) and staged in shared memory; warp w then
// computes O for the 8-column tiles w, w+4, ... of hd over all 64 keys.
// Shared rows are padded by 16 bytes so that ldmatrix reads 8 rows from 8
// different bank groups.
//
// Exactness. The partial of a row depends on that row's query, the split's
// keys and values, and the row's own [lo, hi] only: an m16n8k16 product's
// row is computed from that row of A, and every reduction over a row runs
// in the same order wherever the row sits in the tile. So the paged kernel
// and the prefix kernel, which tile the rows differently, give each row the
// same bits when they give it the same splits; and the combine is one
// kernel for both.
//
// What holds it back at the main path's shapes (a few MB a call, ~1-3 us
// of bytes on an H100): latency, not bytes. A block waits on a chain of
// dependent loads (its rows' positions, the page ids, then K) before its
// first product, and the second launch costs what the programmatic launch
// does not hide.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace dec {

constexpr int ROWS = 16;   // query rows per tile: the M of m16n8k16
constexpr int SPLIT = 64;  // keys per split
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;  // bf16 elements of padding per shared row
constexpr int COMBINE_WARPS = 4;

// Which rows of a tile take part, and where they live. Built by the
// kernel's own row resolution before split_tile runs.
struct TileRows {
  long long qoff[ROWS];  // element offset of the row's query in q
  int lo[ROWS];          // valid keys [lo, hi] inside this split; lo > hi: row not computed
  int hi[ROWS];
  int ws[ROWS];  // workspace row (b * Hkv + h) * R + r, -1: not computed
};

template <int HD>
struct Layout {
  static constexpr int QS = HD + PAD;  // row stride of the Q, K and V tiles (elements)
  static constexpr int PS = SPLIT + PAD;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + 2 * ROWS * QS;
  static constexpr int V_OFF = K_OFF + 2 * SPLIT * QS;
  static constexpr int P_OFF = V_OFF + 2 * SPLIT * QS;
  static constexpr int MAX_OFF = P_OFF + 2 * ROWS * PS;
  static constexpr int SUM_OFF = MAX_OFF + 4 * WARPS * ROWS;
  static constexpr int ROW_OFF = SUM_OFF + 4 * WARPS * ROWS;
  static constexpr int BYTES = ROW_OFF + (int)sizeof(TileRows);
  static_assert(HD % 16 == 0 && HD <= 256, "head dim: a multiple of 16 up to 256");
  // above 48 KB (head dims over 136; 79 KB at 256, two blocks per SM) the
  // launchers opt the kernel in
  static_assert(BYTES <= 227 * 1024, "fits a block's shared memory");
};

// The valid keys of a query at position p: [lo, hi], empty when lo > hi.
__device__ __forceinline__ int2 row_keys(int p, int width, int window) {
  const int hi = min(p, width - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  return p < 0 ? make_int2(1, 0) : make_int2(lo, hi);
}

// Fills the tile's row r (called by one thread per row): `ok` says the row
// takes part in split s (before its own key range is checked).
__device__ __forceinline__ void set_row(TileRows& tr, int r, bool ok, long long qoff, int ws, int p, int s,
                                        int width, int window) {
  const int2 keys = row_keys(p, width, window);
  const int lo = max(keys.x, s * SPLIT), hi = min(keys.y, s * SPLIT + SPLIT - 1);
  ok = ok && lo <= hi;
  tr.qoff[r] = qoff;
  tr.lo[r] = ok ? lo : 1;
  tr.hi[r] = ok ? hi : 0;
  tr.ws[r] = ok ? ws : -1;
}

// The keys of the split that some computed row of the tile reads: [x, y],
// empty (x > y) when the tile computes no row (the block then exits).
__device__ __forceinline__ int2 tile_keys(const TileRows& tr) {
  int lo = 0x7fffffff, hi = -1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (tr.ws[r] >= 0) {
      lo = min(lo, tr.lo[r]);
      hi = max(hi, tr.hi[r]);
    }
  return make_int2(lo, hi);
}

// Programmatic dependent launch: the split kernel lets the combine kernel
// launch at once; the combine kernel waits for the split grid to complete
// and its writes to be visible before it reads them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}

// d += a b: m16n8k16, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where key t of KV head h lives: the chunk operand for the appended keys
// of row new_b (new_b < 0: none), else its page through `table`.
__device__ __forceinline__ long long key_offset(int t, const int* table, int bs, int Hkv, int h, int hd, int new_b,
                                                int new_p0, int C, bool& from_new) {
  from_new = new_b >= 0 && t >= new_p0 && t < new_p0 + C;
  if (from_new) return ((long long)(new_b * C + (t - new_p0)) * Hkv + h) * hd;
  return ((long long)table[t / bs] * bs + t % bs) * Hkv * hd + (long long)h * hd;
}

// One split of one tile: the rows in `tr` (shared memory, complete and
// synced; `keys` = tile_keys(tr), not empty), keys s*SPLIT .. s*SPLIT+63
// of KV head h through `table` (row new_b's appended keys from k_new /
// v_new). Writes each computed row's partial to the workspace: ws_ml[row * n_splits + s] = (m, l) and
// ws_acc[(row * n_splits + s) * HD + d].
template <int HD>
__device__ __forceinline__ void split_tile(unsigned char* smem, const TileRows& tr, int2 keys, const __nv_bfloat16* q,
                                           const __nv_bfloat16* k_pages, const __nv_bfloat16* v_pages,
                                           const int* table, const __nv_bfloat16* k_new,
                                           const __nv_bfloat16* v_new, int new_b, int new_p0, int C, int Hkv, int h,
                                           int bs, int s, float scale, float softcap, float* ws_acc, float2* ws_ml,
                                           int n_splits) {
  using L = Layout<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int KV_ITERS = SPLIT * CH / THREADS;
  static_assert(SPLIT * CH % THREADS == 0, "whole chunk rounds");
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* red_max = reinterpret_cast<float*>(smem + L::MAX_OFF);
  float* red_sum = reinterpret_cast<float*>(smem + L::SUM_OFF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = s * SPLIT;

  // 1. loads: Q and K (group 0), V (group 1); keys no row reads are zeros
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = tr.ws[r] >= 0;
    cp_async16(sQ + r * L::QS + c * 8, ok ? q + tr.qoff[r] + c * 8 : q, ok ? 16 : 0);
  }
  long long off[KV_ITERS];
  bool use_new[KV_ITERS], live[KV_ITERS];
#pragma unroll
  for (int it = 0; it < KV_ITERS; ++it) {
    const int i = tid + it * THREADS, j = i / CH, c = i % CH, t = k0 + j;
    live[it] = t >= keys.x && t <= keys.y;
    use_new[it] = false;
    off[it] = live[it] ? key_offset(t, table, bs, Hkv, h, HD, new_b, new_p0, C, use_new[it]) + c * 8 : 0;
    const __nv_bfloat16* src = use_new[it] ? k_new : k_pages;
    cp_async16(sK + j * L::QS + c * 8, live[it] ? src + off[it] : k_pages, live[it] ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < KV_ITERS; ++it) {
    const int i = tid + it * THREADS, j = i / CH, c = i % CH;
    const __nv_bfloat16* src = use_new[it] ? v_new : v_pages;
    cp_async16(sV + j * L::QS + c * 8, live[it] ? src + off[it] : v_pages, live[it] ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 2. S = Q K^T: warp w, keys 16w .. 16w+15 (two n8 tiles)
  float sc[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4], b[4];
    ldsm_x4(a, sQ + (lane % 16) * L::QS + ks * 16 + (lane / 16) * 8);
    ldsm_x4(b, sK + (warp * 16 + lane % 8 + (lane / 16) * 8) * L::QS + ks * 16 + ((lane / 8) % 2) * 8);
    mma_bf16(sc[0], a, b[0], b[1]);
    mma_bf16(sc[1], a, b[2], b[3]);
  }
  // scale, softcap, mask; element (j, e): row lane/4 + 8(e/2), key 16w + 8j + 2(lane%4) + e%2
  const int row0 = lane / 4;
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e / 2), key = k0 + warp * 16 + 8 * j + 2 * (lane % 4) + e % 2;
      float x = sc[j][e] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      sc[j][e] = (key >= tr.lo[row] && key <= tr.hi[row]) ? x : neg_inf();
      mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    if (lane % 4 == 0) red_max[warp * ROWS + row0 + 8 * hh] = mx[hh];
  }
  __syncthreads();

  // 3. P = exp(S - m), rounded to bf16; the row sums of the rounded values
  float m[2], sum[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    m[hh] = fmaxf(fmaxf(fmaxf(red_max[row], red_max[ROWS + row]), red_max[2 * ROWS + row]), red_max[3 * ROWS + row]);
    const float mu = m[hh] == neg_inf() ? 0.f : m[hh];  // a row with no key here: p = 0
    float pr[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat162 pb = __floats2bfloat162_rn(expf(sc[j][2 * hh] - mu), expf(sc[j][2 * hh + 1] - mu));
      *reinterpret_cast<__nv_bfloat162*>(sP + row * L::PS + warp * 16 + 8 * j + 2 * (lane % 4)) = pb;
      pr[2 * j] = __low2float(pb);
      pr[2 * j + 1] = __high2float(pb);
    }
    sum[hh] = (pr[0] + pr[1]) + (pr[2] + pr[3]);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    if (lane % 4 == 0) red_sum[warp * ROWS + row] = sum[hh];
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. each computed row's (m, l)
  if (tid < ROWS && tr.ws[tid] >= 0) {
    const int r = tid;
    const float mr =
        fmaxf(fmaxf(fmaxf(red_max[r], red_max[ROWS + r]), red_max[2 * ROWS + r]), red_max[3 * ROWS + r]);
    const float l = ((red_sum[r] + red_sum[ROWS + r]) + red_sum[2 * ROWS + r]) + red_sum[3 * ROWS + r];
    ws_ml[(long long)tr.ws[r] * n_splits + s] = make_float2(mr, l);
  }

  // 5. O = P V: warp w takes the 8-column tiles w, w+4, ... of hd
  constexpr int NT = HD / 8, NT_W = (NT + WARPS - 1) / WARPS;
  float o[NT_W][4] = {};
#pragma unroll
  for (int kk = 0; kk < SPLIT / 32; ++kk) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, sP + (lane % 16) * L::PS + kk * 32 + (lane / 16) * 8);
    ldsm_x4(a1, sP + (lane % 16) * L::PS + kk * 32 + 16 + (lane / 16) * 8);
#pragma unroll
    for (int i = 0; i < NT_W; ++i) {
      const int nt = warp + WARPS * i;
      if (nt < NT) {
        uint32_t b[4];
        ldsm_x4_t(b, sV + (kk * 32 + lane) * L::QS + nt * 8);
        mma_bf16(o[i], a0, b[0], b[1]);
        mma_bf16(o[i], a1, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT_W; ++i) {
    const int nt = warp + WARPS * i;
    if (nt < NT) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int w = tr.ws[row0 + 8 * hh];
        if (w >= 0)
          *reinterpret_cast<float2*>(ws_acc + ((long long)w * n_splits + s) * HD + nt * 8 + 2 * (lane % 4)) =
              make_float2(o[i][2 * hh], o[i][2 * hh + 1]);
      }
    }
  }
}

// Writes chunk token c of row b (the tokens whose first query row r = c*G
// lies in row tile `tile` and whose position lies in split s) into its page:
// so exactly one block of a launch writes each appended slot, and no block
// of it reads one (appended keys come from k_new / v_new).
template <int HD>
__device__ __forceinline__ void append_split(__nv_bfloat16* k_pages, __nv_bfloat16* v_pages, const int* table,
                                             const __nv_bfloat16* k_new, const __nv_bfloat16* v_new, int b,
                                             int p0, int C, int G, int Hkv, int h, int bs, int width, int tile,
                                             int s) {
  constexpr int CH = HD / 8;
  const int c_lo = max(0, max((tile * ROWS + G - 1) / G, s * SPLIT - p0));
  const int c_hi = min(C, min(((tile + 1) * ROWS + G - 1) / G, s * SPLIT + SPLIT - p0));
  for (int i = threadIdx.x; i < (c_hi - c_lo) * CH; i += THREADS) {
    const int c = c_lo + i / CH, ch = i % CH, t = p0 + c;
    if (t < 0 || t >= width) continue;
    const long long src = ((long long)(b * C + c) * Hkv + h) * HD + ch * 8;
    const long long dst = ((long long)table[t / bs] * bs + t % bs) * Hkv * HD + (long long)h * HD + ch * 8;
    *reinterpret_cast<uint4*>(k_pages + dst) = *reinterpret_cast<const uint4*>(k_new + src);
    *reinterpret_cast<uint4*>(v_pages + dst) = *reinterpret_cast<const uint4*>(v_new + src);
  }
}

// Merges each query row's split partials in split order and writes the
// row (zeros for a row with no valid key): one warp per row, rows ordered
// (b, h, r), each lane 4 columns.
template <int HD>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
    combine_kernel(const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml, const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ o, int B, int C, int Hq, int Hkv, int width, int window,
                   int n_splits) {
  const int G = Hq / Hkv, R = C * G;
  const long long row = (long long)blockIdx.x * COMBINE_WARPS + threadIdx.x / 32;
  if (row >= (long long)B * Hkv * R) return;
  const int lane = threadIdx.x % 32;
  const int r = row % R, h = (row / R) % Hkv, b = row / ((long long)R * Hkv);
  const int c = r / G, g = r % G;
  __nv_bfloat16* out = o + ((long long)(b * C + c) * Hq + h * G + g) * HD;
  const int2 keys = row_keys(pos[b] + c, width, window);
  const int s_lo = keys.x / SPLIT, s_hi = keys.x <= keys.y ? keys.y / SPLIT : s_lo - 1;
  const float2* ml = ws_ml + row * n_splits;
  wait_prerequisites();  // the split kernel's partials
  float m = neg_inf();
  for (int s = s_lo; s <= s_hi; ++s) m = fmaxf(m, ml[s].x);
  for (int d = 4 * lane; d < HD; d += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int s = s_lo; s <= s_hi; ++s) {
      const float e = expf(ml[s].x - m);
      const float4 a = *reinterpret_cast<const float4*>(ws_acc + (row * n_splits + s) * HD + d);
      l += ml[s].y * e;
      acc.x += a.x * e;
      acc.y += a.y * e;
      acc.z += a.z * e;
      acc.w += a.w * e;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(out + d + 2) = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
}

template <int HD>
cudaError_t launch_combine(const float* ws, const int* pos, void* o, int B, int C, int Hq, int Hkv, int width,
                           int window, int n_splits, cudaStream_t stream) {
  const long long rows = (long long)B * Hkv * C * (Hq / Hkv);
  const float* ws_acc = ws;
  const float2* ws_ml = reinterpret_cast<const float2*>(ws + rows * n_splits * HD);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + COMBINE_WARPS - 1) / COMBINE_WARPS));
  cfg.blockDim = dim3(32 * COMBINE_WARPS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, combine_kernel<HD>, ws_acc, ws_ml, pos, static_cast<__nv_bfloat16*>(o), B, C, Hq,
                            Hkv, width, window, n_splits);
}

}  // namespace dec
}  // namespace repro

// Dispatch over the head dims the split variant has (multiples of 16 up to
// 128, and 256); F is a macro taking the head dim as a constant.
#define REPRO_DEC_HD_SWITCH(hd, F) \
  switch (hd) {                    \
    case 16: F(16)                 \
    case 32: F(32)                 \
    case 48: F(48)                 \
    case 64: F(64)                 \
    case 80: F(80)                 \
    case 96: F(96)                 \
    case 112: F(112)               \
    case 128: F(128)               \
    case 256: F(256)               \
    default: return repro::sm90::kPlanError; \
  }
