// Prefix-group fused paged append + decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py,
// `prefix_paged_attention` (body `_prefix_kernel`): the contract of
// `paged_attention` (paged_attention.cu) plus two (B,) int32 operands.
// group_reps[b] is row b's prefix-group representative (a row outside any
// group is its own) and shared_blocks[b] the number of leading block-table
// entries row b shares with it: the same physical pages, holding a prompt
// prefix that several requests adopted from the prefix cache (DESIGN.md
// §4d). Every write lands past the shared entries (copy-on-write ran before
// the step) and a representative has shared_blocks 0. The output equals
// `paged_attention` on each row's own table, bit for bit.
//
// What bounds it on this card: bytes, as for the paged kernel (a decode
// step does 4 flops per key element). Sharing cuts them: a group's shared
// pages are read once, not once per row.
//
// The design. The TPU kernel gets its sharing from DMA revisit elision,
// with the row axis innermost in a sequential grid; blocks on the GPU run in
// no order, so here one block owns a whole group. Grid: (KV head, row b,
// chunk of 64 group query rows). A block whose row is a group member exits
// at once; the representative's blocks find the members by scanning
// group_reps with warp ballots (no host sync, no extra operand) and take
// their query rows, members x C x G, in row order. Then:
//   1. append every held member's chunk K/V into that member's own pages
//      (the indexed store of the paged kernel), then __syncthreads();
//   2. walk the shared keys through the representative's table: each
//      32-key tile is loaded into shared memory once and applied to every
//      group row that reads it there, each with its own causal mask;
//   3. walk each member's remaining keys through its own table, updating
//      only that member's rows.
// Exactness: every row gets the tiles the paged kernel would give it, the
// same 32-key tiles aligned at position 0 over the same range
// (att_key_range), in the same ascending order, through the same tile step
// (att_tile_rows), whose per-row arithmetic does not depend on other rows.
// A tile is in a row's shared walk only when it lies wholly inside the
// row's shared run; the tile that straddles the run's end belongs to the
// row's own walk. The representative's own rows take the shared walk as
// far as the group's longest shared run: those are its own pages.
//
// Writes past the table width are dropped and drained rows (all-trash
// tables, shared_blocks 0) behave as in the paged kernel. A group_reps entry
// that does not name a representative (out of range, or a row that is not
// its own representative) leaves the row in a group of its own.
#include "common.cuh"

namespace repro {

__device__ __forceinline__ int group_rep(const int* reps, int b, int B) {
  const int r = reps[b];
  return (r >= 0 && r < B && reps[r] == r) ? r : b;
}

// Extra shared memory after the attention buffers, in ints.
constexpr int PFX_INTS = 5 * ATT_ROWS + 3;

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    prefix_paged_attention_kernel(const T* __restrict__ q, T* k_pages, T* v_pages,
                                  const int* __restrict__ tables, const T* __restrict__ k_new,
                                  const T* __restrict__ v_new, const int* __restrict__ pos,
                                  const int* __restrict__ reps, const int* __restrict__ shared,
                                  T* __restrict__ o, int B, int C, int Hq, int Hkv, int hd,
                                  int bs, int n_blocks, int window, float softcap, float scale) {
  const int h = blockIdx.x, rep = blockIdx.y;
  if (group_rep(reps, rep, B) != rep) return;  // a member: its representative serves it
  extern __shared__ float smem[];
  const AttSmem sm = att_smem_layout(smem, hd);
  int* row_b = sm.qpos + ATT_ROWS;  // batch row of each query row
  int* kb = row_b + ATT_ROWS;       // the paged kernel's key range per row
  int* ke = kb + ATT_ROWS;
  int* own = ke + ATT_ROWS;  // first key walked through the row's own table
  int* mem = own + ATT_ROWS;  // the members whose rows this block holds
  int* meta = mem + ATT_ROWS;  // held members, group members, longest shared run
  const int G = Hq / Hkv, RPM = C * G;  // query rows per member
  const int g0 = blockIdx.z * ATT_ROWS;  // first group row of this block
  const int m_lo = g0 / RPM, m_hi = (g0 + ATT_ROWS - 1) / RPM;
  const int width = n_blocks * bs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // 0. the group's members in row order: warp 0 scans group_reps 32 at a time
  if (warp == 0) {
    int n = 0, longest = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      const bool member = b < B && group_rep(reps, b, B) == rep;
      const unsigned ballot = __ballot_sync(0xffffffffu, member);
      if (member) {
        const int idx = n + __popc(ballot & ((1u << lane) - 1u));
        if (idx >= m_lo && idx <= m_hi) mem[idx - m_lo] = b;
        if (b != rep) longest = max(longest, min(max(shared[b], 0), n_blocks));
      }
      n += __popc(ballot);
    }
    longest = __reduce_max_sync(0xffffffffu, longest);
    if (lane == 0) {
      meta[0] = max(0, min(m_hi, n - 1) - m_lo + 1);
      meta[1] = n;
      meta[2] = longest * bs;
    }
  }
  __syncthreads();
  const int held = meta[0];
  if (held == 0) return;  // the group has fewer rows than this block's chunk
  const int R = min(ATT_ROWS, meta[1] * RPM - g0);
  const long long page_stride = (long long)bs * Hkv * hd, slot_stride = (long long)Hkv * hd;

  // 1. append each held member's chunk through its own table
  for (int idx = tid; idx < held * C * hd; idx += ATT_THREADS) {
    const int m = idx / (C * hd), c = (idx / hd) % C, d = idx % hd;
    const int b = mem[m];
    const int t = pos[b] + c;
    if (t >= 0 && t < width) {
      const long long dst = tables[(long long)b * n_blocks + t / bs] * page_stride +
                            (t % bs) * slot_stride + h * hd + d;
      const long long src = ((long long)(b * C + c) * Hkv + h) * hd + d;
      k_pages[dst] = k_new[src];
      v_pages[dst] = v_new[src];
    }
  }

  // 2. the query rows: row r is group row g0 + r, i.e. member (g0 + r) / RPM,
  //    its query row rr = (g0 + r) % RPM = (chunk token rr / G, head rr % G)
  float acc[ATT_ACC];
  att_init(sm, acc);
  for (int idx = tid; idx < R * hd; idx += ATT_THREADS) {
    const int r = idx / hd, d = idx % hd;
    const int b = mem[(g0 + r) / RPM - m_lo], rr = (g0 + r) % RPM;
    sm.q[r * hd + d] = to_f32(q[((long long)(b * C + rr / G) * Hq + h * G + rr % G) * hd + d]);
  }
  for (int r = tid; r < R; r += ATT_THREADS) {
    const int b = mem[(g0 + r) / RPM - m_lo], rr = (g0 + r) % RPM;
    const int p0 = pos[b];
    row_b[r] = b;
    sm.qpos[r] = p0 + rr / G;
    // the range the paged kernel's block of this row (its chunk of 64) walks
    const int r0 = rr - rr % ATT_ROWS;
    const int2 keys = att_key_range(p0, r0, min(ATT_ROWS, RPM - r0), G, width, window);
    kb[r] = keys.x;
    ke[r] = keys.y;
    const int run = b == rep ? meta[2] : min(max(shared[b], 0), n_blocks) * bs;
    own[r] = run - run % ATT_TILE_K;  // whole tiles of the shared run
  }
  __syncthreads();  // the appended K/V and the row data are visible below

  // 3. the shared walk, through the representative's table
  int s_begin = width, s_end = 0;
  for (int r = 0; r < R; ++r) {
    s_begin = min(s_begin, kb[r]);
    s_end = max(s_end, min(own[r], ke[r]));
  }
  const int* rep_table = tables + (long long)rep * n_blocks;
  for (int k0 = s_begin; k0 < s_end; k0 += ATT_TILE_K) {
    const int nk = min(ATT_TILE_K, width - k0);
    att_load_pages(sm, k_pages, v_pages, rep_table, k0, nk, bs, Hkv, hd, h);
    __syncthreads();
    att_tile_rows(sm, acc, 0, R, hd, k0, nk, scale, softcap, true, window,
                  [=](int r) { return k0 < own[r] && k0 >= kb[r] && k0 < ke[r]; });
  }

  // 4. each member's own walk, through its own table, for its rows only
  for (int m = 0; m < held; ++m) {
    const int r_lo = max(0, (m_lo + m) * RPM - g0), r_hi = min(R, (m_lo + m + 1) * RPM - g0);
    int k_lo = width, k_hi = 0;
    for (int r = r_lo; r < r_hi; ++r) {
      k_lo = min(k_lo, max(kb[r], own[r]));
      k_hi = max(k_hi, ke[r]);
    }
    const int* table = tables + (long long)mem[m] * n_blocks;
    for (int k0 = k_lo; k0 < k_hi; k0 += ATT_TILE_K) {
      const int nk = min(ATT_TILE_K, width - k0);
      att_load_pages(sm, k_pages, v_pages, table, k0, nk, bs, Hkv, hd, h);
      __syncthreads();
      att_tile_rows(sm, acc, r_lo, r_hi, hd, k0, nk, scale, softcap, true, window,
                    [=](int r) { return k0 >= own[r] && k0 >= kb[r] && k0 < ke[r]; });
    }
  }
  att_finish(sm, acc, R, hd, o, [=](int r, int d) {
    const int rr = (g0 + r) % RPM;
    return ((long long)(row_b[r] * C + rr / G) * Hq + h * G + rr % G) * hd + d;
  });
}

template <typename T>
cudaError_t launch_prefix(const void* q, void* kp, void* vp, const int* tables, const void* kn,
                          const void* vn, const int* pos, const int* reps, const int* shared,
                          void* o, int B, int C, int Hq, int Hkv, int hd, int bs, int n_blocks,
                          int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(hd) + sizeof(int) * PFX_INTS;
  cudaError_t err = cudaFuncSetAttribute(prefix_paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * C * (Hq / Hkv);  // a group holds at most every row
  dim3 grid(Hkv, B, (unsigned)((rows + ATT_ROWS - 1) / ATT_ROWS));
  prefix_paged_attention_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(kp), static_cast<T*>(vp), tables,
      static_cast<const T*>(kn), static_cast<const T*>(vn), pos, reps, shared,
      static_cast<T*>(o), B, C, Hq, Hkv, hd, bs, n_blocks, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace repro

// As paged_attention_launch, plus group_reps and shared_blocks, (B,) int32.
extern "C" int prefix_paged_attention_launch(const void* q, void* k_pages, void* v_pages,
                                             const void* tables, const void* k_new,
                                             const void* v_new, const void* pos,
                                             const void* group_reps, const void* shared_blocks,
                                             void* o, int dtype, int B, int C, int Hq, int Hkv,
                                             int hd, int bs, int n_blocks, int window,
                                             float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const int* r = static_cast<const int*>(group_reps);
  const int* n = static_cast<const int*>(shared_blocks);
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = repro::launch_prefix<__nv_bfloat16>(q, k_pages, v_pages, t, k_new, v_new, p, r, n, o,
                                              B, C, Hq, Hkv, hd, bs, n_blocks, window, softcap,
                                              scale, s);
  else
    err = repro::launch_prefix<float>(q, k_pages, v_pages, t, k_new, v_new, p, r, n, o, B, C, Hq,
                                      Hkv, hd, bs, n_blocks, window, softcap, scale, s);
  return static_cast<int>(err);
}
