// Causal prefill attention (flash attention) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// `flash_attention` (body `_flash_kernel`): online-softmax attention with
// queries aligned to the end of the KV sequence (q_offset = Sk - Sq), causal
// mask, sliding window, logit softcap and GQA (kv head = q head / G), all in
// float32 with the output in the input type.
//
// What bounds it on this card: at the main path's prefill shape (B=4, S=128,
// 16 heads of 128) one call moves about 2 MB and does about 0.27 GFLOP, so
// the roofline says bytes (under a microsecond); in practice the time is the
// SIMT arithmetic of the two products, since this first kernel does not use
// the tensor cores.
//
// The design: one block per (q tile of 64 rows, q head, batch row). The block
// keeps its q rows in shared memory as float32 and walks the KV sequence in
// tiles of 32 keys (common.cuh, att_tile), so K/V are read once per q tile
// and no (Sq, Sk) score matrix reaches device memory. Tiles that lie wholly
// above the diagonal, or wholly before a sliding window, are skipped: every
// row of the block keeps at least one valid key, so the online softmax gives
// exactly what visiting them would (a fully masked tile before the first
// valid one is rescaled away by alpha = 0; one after it adds exact zeros).
// The TPU kernel's largest-divisor tile rule is not ported: ragged q and KV
// tiles are masked. Strides are arguments, so the model's (B, S, H, hd)
// layout is read and written in place without a transpose copy.
#include "common.cuh"

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

}  // namespace repro

// q (B, Hq, Sq, hd), k/v (B, Hkv, Sk, hd), o (B, Hq, Sq, hd), each given by
// its (batch, head, sequence) strides in elements; the head dim is dense.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                                      long long q_sb, long long q_sh, long long q_ss,
                                      long long k_sb, long long k_sh, long long k_ss,
                                      long long v_sb, long long v_sh, long long v_ss,
                                      long long o_sb, long long o_sh, long long o_ss, int causal,
                                      int window, float softcap, float scale, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kBF16)
    err = repro::launch_flash<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, st, causal, window,
                                       softcap, scale, s);
  else
    err = repro::launch_flash<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, st, causal, window, softcap,
                               scale, s);
  return static_cast<int>(err);
}
