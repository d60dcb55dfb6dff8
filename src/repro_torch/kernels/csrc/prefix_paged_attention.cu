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
// bfloat16, variant `split` (decode.cuh, the paged kernel's split variant
// with the same splits of 64 keys, the same tile function and the same
// combine kernel). Grid (units x splits, KV head, row b), units = tiles of
// 16 of the B*C*G rows (the largest group there can be). Block (u, s, h, b):
//  - group mode, when b is a representative and split s lies wholly below
//    its position: group tile u of b's group, every member row whose
//    shared run also holds s, the keys loaded once through b's table and
//    scored against all of them (8 members x C x G rows at the main shape);
//  - own mode otherwise: row tile u of b's own rows (u below C*G/16), for
//    the splits its run does not hold, b's appended keys from k_new / v_new
//    and its appended slots written, as in the paged kernel.
// A member's run is its shared_blocks pages, cut at its position and at its
// representative's; the representative's run is every key below its
// position (all written before this launch). The split that straddles the
// end of a member's run, and every later one, is that member's own split.
// Every row's partials then go through the paged kernel's combine in split
// order, so each row gets the paged kernel's bits: its splits hold the same
// keys and values (a shared page has one physical id in both tables) and a
// row's arithmetic does not depend on the other rows of its tile. On the
// main path the grid is the paged kernel's (640 blocks); 352 of them work.
// Members are found from group_reps on the card by the warp-ballot scan
// below; nothing is read back to the host.
//
// float32, and the bf16 shapes the split variant does not take: variant
// `simt`. The TPU kernel gets its sharing from DMA revisit elision,
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
// The launch plan (variant, grid, shared memory, workspace) is made by the
// Python wrapper (`decode_plan`); this file checks it.
//
// Writes past the table width are dropped and drained rows (all-trash
// tables, shared_blocks 0) behave as in the paged kernel. A group_reps entry
// that does not name a representative (out of range, or a row that is not
// its own representative) leaves the row in a group of its own.
#include "common.cuh"
#include "decode.cuh"
#include "sm90.cuh"

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

// The members of group `rep` in row order (warp 0 scans group_reps 32 rows
// at a time): those whose index in the group lies in [m_lo, m_hi] go to
// gs.mem[index - m_lo]; gs.count is the group's size. With rep its own
// representative (group_rep(rep) == rep), row x is a member when x == rep
// or, if reps[rep] == rep (`named`), reps[x] == rep: group_rep's test with
// one load per row. The caller syncs.
struct GroupScan {
  int mem[dec::ROWS];
  int count;
};

__device__ __forceinline__ void scan_group(GroupScan& gs, const int* reps, int rep, bool named, int B, int m_lo,
                                           int m_hi) {
  const int lane = threadIdx.x % 32;
  int n = 0;
  for (int base = 0; base < B; base += 32) {
    const int x = base + lane;
    const bool member = x < B && (x == rep || (named && reps[x] == rep));
    const unsigned ballot = __ballot_sync(0xffffffffu, member);
    const int idx = n + __popc(ballot & ((1u << lane) - 1u));
    if (member && idx >= m_lo && idx <= m_hi) gs.mem[idx - m_lo] = x;
    n += __popc(ballot);
  }
  if (lane == 0) gs.count = n;
}

// The keys of a member below which its splits are group splits: its shared
// pages, cut at its position and at its representative's run.
__device__ __forceinline__ int member_run(int shared_pages, int p, int n_blocks, int bs, int rep_run) {
  return min(min(min(max(shared_pages, 0), n_blocks) * bs, max(p, 0)), rep_run);
}

// The split variant: block (x = unit * n_splits + s, h, b). When b is a
// representative and split s lies wholly in its run (every key below its
// position: all written before this launch, its own pages as they stand),
// the block holds group tile `unit` of b's group (every member row whose run
// also holds s, through b's table); otherwise row tile `unit` of b's own
// rows, for the splits its run does not hold, with b's appended keys from
// k_new / v_new. The loads that decide this are issued together, so a
// block's first key load waits on two dependent loads more than the paged
// kernel's (three in group mode).
template <int HD>
__global__ void __launch_bounds__(dec::THREADS)
    prefix_split_kernel(const __nv_bfloat16* __restrict__ q, __nv_bfloat16* k_pages, __nv_bfloat16* v_pages,
                        const int* __restrict__ tables, const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ pos,
                        const int* __restrict__ reps, const int* __restrict__ shared, float* ws_acc, float2* ws_ml,
                        int B, int C, int Hq, int Hkv, int bs, int n_blocks, int window, float softcap, float scale,
                        int n_splits) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  dec::launch_dependents();
  using L = dec::Layout<HD>;
  dec::TileRows& tr = *reinterpret_cast<dec::TileRows*>(dsmem + L::ROW_OFF);
  GroupScan& gs = *reinterpret_cast<GroupScan*>(dsmem + L::BYTES);
  const int s = blockIdx.x % n_splits, unit = blockIdx.x / n_splits, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, R = C * G, width = n_blocks * bs;
  const int named = reps[b], pb = pos[b], shared_b = shared[b];
  // group_rep(reps, b, B)
  const int rep = (named >= 0 && named < B && (named == b || reps[named] == named)) ? named : b;
  const int rep_run = min(max(rep == b ? pb : pos[rep], 0), width);
  const int split_end = (s + 1) * dec::SPLIT;
  const bool group = rep == b && split_end <= rep_run;
  const int g0 = unit * dec::ROWS;  // the tile's first row (of the group, or of b)
  if (group) {
    if (threadIdx.x < 32) scan_group(gs, reps, b, named == b, B, g0 / R, (g0 + dec::ROWS - 1) / R);
    __syncthreads();
  }
  if (threadIdx.x < dec::ROWS) {
    const int gr = g0 + threadIdx.x;
    int rb = b, r = gr, p = pb;
    bool ok;
    if (group) {  // member gr / R, its row gr % R
      ok = gr < gs.count * R;
      rb = ok ? gs.mem[gr / R - g0 / R] : b;
      r = gr % R;
      p = pos[rb];
      ok = ok && split_end <= (rb == b ? rep_run : member_run(shared[rb], p, n_blocks, bs, rep_run));
    } else {
      ok = r < R && split_end > (rep == b ? rep_run : member_run(shared_b, pb, n_blocks, bs, rep_run));
    }
    const int c = r / G, g = r % G;
    dec::set_row(tr, threadIdx.x, ok, ((long long)(rb * C + c) * Hq + h * G + g) * HD, (rb * Hkv + h) * R + r, p + c,
                 s, width, window);
  }
  __syncthreads();
  const int2 keys = dec::tile_keys(tr);
  if (keys.x > keys.y) return;  // no row of the tile reads this split here
  const int* table = tables + (long long)b * n_blocks;  // b's own table, or its group's
  if (!group) dec::append_split<HD>(k_pages, v_pages, table, k_new, v_new, b, pb, C, G, Hkv, h, bs, width, unit, s);
  // a group split lies below every position of its rows: no appended key
  dec::split_tile<HD>(dsmem, tr, keys, q, k_pages, v_pages, table, k_new, v_new, group ? -1 : b, pb, C, Hkv, h, bs,
                      s, scale, softcap, ws_acc, ws_ml, n_splits);
}

template <int HD>
int launch_prefix_split(const void* q, void* kp, void* vp, const int* tables, const void* kn, const void* vn,
                        const int* pos, const int* reps, const int* shared, void* o, float* ws, int B, int C, int Hq,
                        int Hkv, int bs, int n_blocks, int window, float softcap, float scale, int grid_x, int smem,
                        cudaStream_t stream) {
  const int R = C * (Hq / Hkv), n_splits = (n_blocks * bs + dec::SPLIT - 1) / dec::SPLIT;
  const long long n_gtiles = ((long long)B * R + dec::ROWS - 1) / dec::ROWS;  // a group of every row
  if (smem != dec::Layout<HD>::BYTES + (int)sizeof(GroupScan) || grid_x != n_splits * n_gtiles)
    return sm90::kPlanError;
  if (smem > 48 * 1024) {  // head dim 256: above the default dynamic shared memory
    static sm90::SmemOptIn opt_in;
    const cudaError_t e = opt_in.ensure(prefix_split_kernel<HD>, smem);
    if (e != cudaSuccess) return e;
  }
  const long long rows = (long long)B * Hkv * R;
  float2* ws_ml = reinterpret_cast<float2*>(ws + rows * n_splits * HD);
  using bf = __nv_bfloat16;
  prefix_split_kernel<HD><<<dim3(grid_x, Hkv, B), dec::THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<bf*>(kp), static_cast<bf*>(vp), tables, static_cast<const bf*>(kn),
      static_cast<const bf*>(vn), pos, reps, shared, ws, ws_ml, B, C, Hq, Hkv, bs, n_blocks, window, softcap, scale,
      n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return dec::launch_combine<HD>(ws, pos, o, B, C, Hq, Hkv, n_blocks * bs, window, n_splits, stream);
}

}  // namespace repro

// As paged_attention_launch, plus group_reps and shared_blocks, (B,) int32.
// Variant 1 = split: grid_x = splits x tiles of 16 of the B*C*G rows (the
// largest group there can be; a row's own tiles are the first of them),
// smem the tile's bytes plus the group scan's; 0 = simt.
extern "C" int prefix_paged_attention_launch(const void* q, void* k_pages, void* v_pages,
                                             const void* tables, const void* k_new,
                                             const void* v_new, const void* pos,
                                             const void* group_reps, const void* shared_blocks,
                                             void* o, int dtype, int B, int C, int Hq, int Hkv,
                                             int hd, int bs, int n_blocks, int window,
                                             float softcap, float scale, int variant, int grid_x,
                                             int smem, void* workspace, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const int* r = static_cast<const int*>(group_reps);
  const int* n = static_cast<const int*>(shared_blocks);
  if (variant == 1) {
    if (dtype != repro::kBF16 || workspace == nullptr) return repro::sm90::kPlanError;
    float* ws = static_cast<float*>(workspace);
#define REPRO_PREFIX_SPLIT(HD)                                                                                \
  return repro::launch_prefix_split<HD>(q, k_pages, v_pages, t, k_new, v_new, p, r, n, o, ws, B, C, Hq, Hkv, \
                                        bs, n_blocks, window, softcap, scale, grid_x, smem, s);
    REPRO_DEC_HD_SWITCH(hd, REPRO_PREFIX_SPLIT)
#undef REPRO_PREFIX_SPLIT
  }
  const long long rows = (long long)B * C * (Hq / Hkv);
  if (variant != 0 || smem != (int)(repro::att_smem_bytes(hd) + sizeof(int) * repro::PFX_INTS) ||
      grid_x != (rows + repro::ATT_ROWS - 1) / repro::ATT_ROWS)
    return repro::sm90::kPlanError;
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
