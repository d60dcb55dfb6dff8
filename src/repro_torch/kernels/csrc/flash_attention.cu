// Causal prefill attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// `flash_attention` (body `_flash_kernel`): online-softmax attention with
// queries aligned to the end of the KV sequence (q_offset = Sk - Sq), causal
// mask, sliding window, logit softcap and GQA (kv head = q head / G), all in
// float32 with the output in the input type.
//
// What bounds it on this card: at the main path's prefill shape (B=4, S=128,
// 16 heads of 128) one call moves about 8 MB and does about 0.27 GFLOP, so
// the roofline says bytes (~2.5 us); what is left is latency: one load of
// the tiles and a few dependent products per block. At head dim 256 a
// block's ring holds 161 KB of tiles, so one block runs per SM.
//
// bfloat16, variant `wgmma` (head dims that are multiples of 16 up to 128,
// and 256): one consumer warpgroup per (64-row q tile, q head, batch row),
// and a producer warp that loads the q tile once and K/V tiles of 64 keys into a
// 2-stage ring, all by TMA straight from the strided (B, S, H, hd) views
// (4-D tensor maps; rows of 128, 64 or 32 bytes, swizzled to match). S =
// Q K^T is wgmma m64n64k16 over hd/16 steps, both operands K-major in
// shared memory. Scale, softcap and the masks are applied in registers,
// then the online softmax in base 2 (exp2 on the special-function unit),
// with each row's max and sum reduced over the four threads that hold it;
// each step is straight-line code over a thread's 32 scores, and tiles
// every key of which the whole block sees skip the mask (a per-element
// branchy version spent most of a tile step here). O += P V is wgmma
// m64n{hd}k16 with P from registers (rounded to bf16: the one rounding the
// float32 path does not have) and V from shared memory, MN-major
// (transpose bit); a head of 256 dims takes two m64n128k16 products per
// k16 step, one over each 128-column half of V, into two accumulators that
// together hold the 128 floats per thread of a 64 x 256 O tile (the
// registers of an n256 product, without its 128-operand instruction). K
// and V of a stage complete on separate barriers, so S starts before V
// lands. Tiles wholly above the diagonal or before the
// window are skipped, as below, and the causal q tiles with the most keys
// are launched first. The epilogue divides by max(l, 1e-30) and writes bf16
// rows in place.
//
// float32, and bf16 head dims the wgmma variant does not take: variant
// `simt`, one block per (q tile of 64 rows, q head, batch row) keeping its q
// rows in shared memory as float32 and walking the KV sequence in tiles of
// 32 keys (common.cuh, att_tile), so K/V are read once per q tile and no
// (Sq, Sk) score matrix reaches device memory. Tiles that lie wholly above
// the diagonal, or wholly before a sliding window, are skipped: every row of
// the block keeps at least one valid key, so the online softmax gives
// exactly what visiting them would (a fully masked tile before the first
// valid one is rescaled away by alpha = 0; one after it adds exact zeros).
// The TPU kernel's largest-divisor tile rule is not ported: ragged q and KV
// tiles are masked. Strides are arguments, so the model's (B, S, H, hd)
// layout is read and written in place without a transpose copy.
//
// The launch plan (variant, tiles, stages, grid, shared memory) is made by
// the Python wrapper; this file checks it.
#include "common.cuh"
#include "sm90.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                           int Sq, int Sk, int hd, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                           long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, int causal, int window,
                           float softcap, float scale) {
  extern __shared__ float smem[];
  const AttSmem sm = att_smem_layout(smem, hd);
  const int q0 = blockIdx.x * ATT_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int R = min(ATT_ROWS, Sq - q0);
  const int q_offset = Sk - Sq;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  float acc[ATT_ACC];
  att_init(sm, acc);
  for (int idx = threadIdx.x; idx < R * hd; idx += ATT_THREADS) {
    const int r = idx / hd, d = idx % hd;
    sm.q[r * hd + d] = to_f32(qb[(q0 + r) * q_ss + d]);
  }
  for (int r = threadIdx.x; r < R; r += ATT_THREADS) sm.qpos[r] = q_offset + q0 + r;

  // key range that can hold a valid key for some row of this tile
  int k_begin = 0, k_end = Sk;
  if (causal && q_offset + q0 >= 0) {
    k_end = min(Sk, q_offset + q0 + R);
    if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  }
  k_begin -= k_begin % ATT_TILE_K;
  __syncthreads();

  for (int k0 = k_begin; k0 < k_end; k0 += ATT_TILE_K) {
    const int nk = min(ATT_TILE_K, Sk - k0);
    for (int idx = threadIdx.x; idx < ATT_TILE_K * hd; idx += ATT_THREADS) {
      const int j = idx / hd, d = idx % hd;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        kv = to_f32(kb[(k0 + j) * k_ss + d]);
        vv = to_f32(vb[(k0 + j) * v_ss + d]);
      }
      sm.k[j * (hd + 1) + d] = kv;
      sm.v[j * hd + d] = vv;
    }
    __syncthreads();
    att_tile(sm, acc, R, hd, k0, nk, scale, softcap, causal != 0, window);
  }
  T* ob = o + b * o_sb + h * o_sh;
  att_finish(sm, acc, R, hd, ob,
             [=](int r, int d) { return (long long)(q0 + r) * o_ss + d; });
}

template <typename T>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, int hd, const long long* st, int causal, int window,
                   float softcap, float scale, cudaStream_t stream) {
  const size_t smem = att_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + ATT_ROWS - 1) / ATT_ROWS, Hq, B);
  flash_attention_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], causal, window, softcap, scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA, one consumer warpgroup per 64-row q tile
// ---------------------------------------------------------------------------
constexpr int FA_BM = 64;  // q rows per block (the wgmma M)
constexpr int FA_BN = 64;  // keys per tile
constexpr int FA_STAGES = 2;
constexpr int FA_THREADS = 160;  // one consumer warpgroup + one producer warp

// A head of HD dims is loaded as HD / ATOM column blocks of ATOM elements,
// each a [64 rows][ATOM] tile with rows of 2 * ATOM bytes swizzled by as
// many bytes (128, 64 or 32).
template <int HD>
struct FaLayout {
  static constexpr int ATOM = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static constexpr int SW = 2 * ATOM;
  static constexpr int NSUB = HD / ATOM;
  static constexpr int SUB = 64 * SW;  // bytes of one column block
  static constexpr int TILE = NSUB * SUB;  // 64 rows x HD
};

// 2^x on the special-function unit (ex2.approx, flush to zero): exact 0 for
// -inf and for the finite NEG_INF of masked keys.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int fa_smem_bytes(int hd) { return 1024 + (1 + 2 * FA_STAGES) * 64 * hd * 2 + 64; }  // + 7 barriers

template <int HD>
__global__ void __launch_bounds__(FA_THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int Hq,
                                 int Hkv, int Sq, int Sk, long long o_sb, long long o_sh, long long o_ss, int causal,
                                 int window, float softcap, float scale) {
  using namespace sm90;
  using L = FaLayout<HD>;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = base;
  uint8_t* sk = sq + L::TILE;                // [stage] K tiles
  uint8_t* sv = sk + FA_STAGES * L::TILE;    // [stage] V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + FA_STAGES * L::TILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                // K and V of a stage complete apart,
  uint64_t* v_full = k_full + FA_STAGES;      // so S = Q K^T starts before V is in
  uint64_t* empty = v_full + FA_STAGES;

  // the q tiles with the most keys (causal: the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BM, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int R = min(FA_BM, Sq - q0);
  const int q_offset = Sk - Sq;
  // key range that can hold a valid key for some row of this tile
  int k_begin = 0, k_end = Sk;
  if (causal && q_offset + q0 >= 0) {
    k_end = min(Sk, q_offset + q0 + R);
    if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);
  }
  k_begin -= k_begin % FA_BN;
  const int n_tiles = (k_end - k_begin + FA_BN - 1) / FA_BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int a = 0; a < L::NSUB; ++a) tma_load_4d(sq + a * L::SUB, &q_map, q_full, a * L::ATOM, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FA_STAGES;
        mbar_wait(&empty[s], ((i / FA_STAGES) & 1) ^ 1);
        const int k0 = k_begin + i * FA_BN;
        mbar_arrive_expect_tx(&k_full[s], L::TILE);
#pragma unroll
        for (int a = 0; a < L::NSUB; ++a)
          tma_load_4d(sk + s * L::TILE + a * L::SUB, &k_map, &k_full[s], a * L::ATOM, k0, kvh, b);
        mbar_arrive_expect_tx(&v_full[s], L::TILE);
#pragma unroll
        for (int a = 0; a < L::NSUB; ++a)
          tma_load_4d(sv + s * L::TILE + a * L::SUB, &v_map, &v_full[s], a * L::ATOM, k0, kvh, b);
      }
    }
    return;
  }

  // consumer warpgroup: thread (w, l) holds q rows 16w + l/4 + 8h (h = 0, 1)
  // and, of a 64-key tile, keys 8j + 2(l%4) + c (j = 0..7, c = 0, 1).
  // Scores are kept in base 2: x * log2(e), so exp(s - m) = exp2(x - m').
  const float scale2 = scale * LOG2E;
  const float cap2 = softcap * LOG2E, scale_over_cap = softcap > 0.f ? scale / softcap : 0.f;
  const int q_lo = q_offset + q0, q_hi = q_offset + q0 + FA_BM - 1;  // the block's query positions
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = q_offset + q0 + 16 * warp + lane / 4 + 8 * hh;
  // O in parts of at most 128 columns: part p holds columns 128p ..
  // 128p + 127, element 4j + 2h + c of part p column 128p + 8j + 2(l%4) + c
  constexpr int PV_N = HD > 128 ? 128 : HD, PV_PARTS = HD / PV_N, PV_J = PV_N / 8;
  static_assert(HD % PV_N == 0 && PV_N % L::ATOM == 0, "O parts cover whole column blocks of V");
  float acc_o[PV_PARTS][Wgmma<PV_N>::kRegs];
#pragma unroll
  for (int p = 0; p < PV_PARTS; ++p)
#pragma unroll
    for (int i = 0; i < Wgmma<PV_N>::kRegs; ++i) acc_o[p][i] = 0.f;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FA_STAGES;
    const uint32_t parity = (i / FA_STAGES) & 1;
    const int k0 = k_begin + i * FA_BN;
    const uint8_t* ks = sk + s * L::TILE;
    const uint8_t* vs = sv + s * L::TILE;
    mbar_wait(&k_full[s], parity);

    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    wgmma_fence();
    fence_operands(sc);
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const int sub = (16 * t) / L::ATOM, off = ((16 * t) % L::ATOM) * 2;
      const uint64_t da = make_desc<L::SW>(sq + sub * L::SUB + off, 16, 8 * L::SW);
      const uint64_t db = make_desc<L::SW>(ks + sub * L::SUB + off, 16, 8 * L::SW);
      Wgmma<64>::template ss<0, 0>(sc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // scale and softcap, then the masks, then the online softmax per row;
    // each pass is straight-line code over all 32 scores of the thread
    if (softcap > 0.f) {
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = cap2 * tanhf(sc[r] * scale_over_cap);
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] *= scale2;
    }
    // a tile every key of which every row of the block sees needs no mask
    const bool whole = k0 + FA_BN <= Sk &&
                       (!causal || (k0 + FA_BN - 1 <= q_lo && (window <= 0 || q_hi - k0 < window)));
    if (!whole) {
      const int kb = k0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int kpos = kb + 8 * j + c, qp = qpos[hh];
            const bool ok = !causal | ((kpos <= qp) & ((window <= 0) | (qp - kpos < window)));
            float& x = sc[4 * j + 2 * hh + c];
            x = kpos < Sk ? (ok ? x : NEG_INF) : neg_inf();
          }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hh], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = fast_exp2(sc[4 * j + 2 * hh + c] - m_new);
          sc[4 * j + 2 * hh + c] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hh] = fast_exp2(m_run[hh] - m_new);
      l_run[hh] = l_run[hh] * alpha[hh] + sum;
      m_run[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc_o[j / PV_J][4 * (j % PV_J) + 0] *= alpha[0];
      acc_o[j / PV_J][4 * (j % PV_J) + 1] *= alpha[0];
      acc_o[j / PV_J][4 * (j % PV_J) + 2] *= alpha[1];
      acc_o[j / PV_J][4 * (j % PV_J) + 3] *= alpha[1];
    }
    // P in the register layout of a wgmma A operand: k16 step t holds keys
    // 16t .. 16t+15, i.e. score columns j = 2t and 2t + 1
    uint32_t pf[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pf[t][0] = pack_bf16(sc[8 * t + 0], sc[8 * t + 1]);
      pf[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
      pf[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
      pf[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
    }
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < PV_PARTS; ++p) fence_operands(acc_o[p]);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int p = 0; p < PV_PARTS; ++p) {
        // V rows are keys (K), HD contiguous (N): MN-major, 16 rows per
        // step; part p starts at V's column block p * PV_N / ATOM
        const uint64_t db =
            make_desc<L::SW>(vs + p * (PV_N / L::ATOM) * L::SUB + t * 16 * L::SW, L::SUB, 8 * L::SW);
        Wgmma<PV_N>::template rs<1>(acc_o[p], pf[t], db, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PV_PARTS; ++p) fence_operands(acc_o[p]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: O / max(l, 1e-30) as bf16 pairs
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + lane / 4 + 8 * hh;
    if (r >= R) continue;
    const float inv = 1.f / fmaxf(l_run[hh], 1e-30f);
    __nv_bfloat16* row = ob + (long long)(q0 + r) * o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int dcol = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(row + dcol) = __floats2bfloat162_rn(
          acc_o[j / PV_J][4 * (j % PV_J) + 2 * hh] * inv, acc_o[j / PV_J][4 * (j % PV_J) + 2 * hh + 1] * inv);
    }
  }
}

template <int HD>
int launch_flash_wgmma_hd(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
                          int Sk, const long long* st, int causal, int window, float softcap, float scale,
                          int grid_x, int smem, cudaStream_t stream) {
  using L = FaLayout<HD>;
  if (smem != fa_smem_bytes(HD) || grid_x != (Sq + FA_BM - 1) / FA_BM) return sm90::kPlanError;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int t = 0; t < 3; ++t) {
    const uint64_t dims[4] = {(uint64_t)HD, (uint64_t)(t ? Sk : Sq), (uint64_t)(t ? Hkv : Hq), (uint64_t)B};
    const uint64_t strides[4] = {1, (uint64_t)st[3 * t + 2], (uint64_t)st[3 * t + 1], (uint64_t)st[3 * t]};
    const uint32_t box[4] = {(uint32_t)L::ATOM, (uint32_t)(t ? FA_BN : FA_BM), 1, 1};
    const int err = sm90::encode_tile_map(&maps[t], ptrs[t], 4, dims, strides, box, L::SW);
    if (err) return err;
  }
  static sm90::SmemOptIn opt_in;
  cudaError_t e = opt_in.ensure(flash_attention_wgmma_kernel<HD>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(grid_x, Hq, B);
  flash_attention_wgmma_kernel<HD><<<grid, FA_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, st[9], st[10], st[11], causal,
      window, softcap, scale);
  return cudaGetLastError();
}

int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                       int hd, const long long* st, int causal, int window, float softcap, float scale, int grid_x,
                       int smem, cudaStream_t stream) {
#define REPRO_FA_HD(HH)                                                                                        \
  case HH:                                                                                                     \
    return launch_flash_wgmma_hd<HH>(q, k, v, o, B, Hq, Hkv, Sq, Sk, st, causal, window, softcap, scale, grid_x, \
                                     smem, stream);
  switch (hd) {
    REPRO_FA_HD(16) REPRO_FA_HD(32) REPRO_FA_HD(48) REPRO_FA_HD(64)
    REPRO_FA_HD(80) REPRO_FA_HD(96) REPRO_FA_HD(112) REPRO_FA_HD(128)
    REPRO_FA_HD(256)
    default: return sm90::kPlanError;
  }
#undef REPRO_FA_HD
}

}  // namespace repro

// q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd), o (B, Hq, Sq, hd), each given by
// its (batch, head, sequence) strides in elements; the head dim is dense.
// The launch plan comes from kernels/flash_attention.py: variant 1 = wgmma
// (bf16; block_q x block_k = 64 x 64, 2 stages, grid_x q tiles x Hq x B,
// `smem` dynamic bytes), 0 = simt (64 x 32, its own shared memory). A plan
// this file does not take returns kPlanError (2000); a failed tensor-map
// encode 1000 + CUresult.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype, int B,
                                      int Hq, int Hkv, int Sq, int Sk, int hd, long long q_sb, long long q_sh,
                                      long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                                      long long o_sh, long long o_ss, int causal, int window, float softcap,
                                      float scale, int variant, int block_q, int block_k, int stages, int grid_x,
                                      int smem, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != repro::kBF16 || block_q != repro::FA_BM || block_k != repro::FA_BN || stages != repro::FA_STAGES)
      return repro::sm90::kPlanError;
    return repro::launch_flash_wgmma(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, st, causal, window, softcap, scale, grid_x,
                                     smem, s);
  }
  if (variant != 0 || block_q != repro::ATT_ROWS || block_k != repro::ATT_TILE_K ||
      smem != (int)repro::att_smem_bytes(hd) || grid_x != (Sq + repro::ATT_ROWS - 1) / repro::ATT_ROWS)
    return repro::sm90::kPlanError;
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = repro::launch_flash<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, st, causal, window, softcap, scale,
                                             s);
  else
    err = repro::launch_flash<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, st, causal, window, softcap, scale, s);
  return static_cast<int>(err);
}
