// Per-group INT4 dequantization for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/int4_dequant.py, `int4_dequant`
// (body `_dequant_kernel`): packed (G, gs/2) uint8, two nibbles per byte,
// low nibble first, with float32 scales and zeros (G, 1), to (G, gs)
// bfloat16 or float32 as w = scale * q + zero. It serves every expert
// matmul of resident-INT4 serving (one launch per grouped matmul, into a
// transient dense buffer) and every dense INT4 restore of the Eq.-6
// transition, where its time is T_dequant.
//
// What bounds it on this card: bytes. Each output element costs half a
// byte read, 8/gs bytes of scale and zero, 2 (bf16) or 4 (f32) bytes
// written and two flops. On the main path (one layer's expert leaf,
// G = 1,441,792 groups of 128) a launch moves 92.3 + 11.5 MB in and 369 MB
// out (bf16): 0.141 ms at 3.35 TB/s.
//
// The design follows from that: one thread per four packed bytes, read as
// one 32-bit word, written as one 16-byte (bf16) or two 16-byte (f32)
// vector stores, so every warp moves whole cache lines. The packed array
// is walked flat: byte j holds outputs 2j and 2j+1 and belongs to group
// j / (gs/2), so any G and any even gs work, gs not a multiple of 8
// included (a word may then straddle groups; each byte finds its own).
// A word that runs past the end, or buffers that are not aligned for the
// vector accesses, take a byte-by-byte path.
//
// Bit-exactness: the product and the sum are rounded separately
// (__fmul_rn then __fadd_rn, never contracted into an FMA) and the cast to
// bf16 rounds to nearest even, which is what the numpy dequant of the
// restore path and the plain version compute.
#include <cstdint>

#include "common.cuh"

namespace repro {

constexpr int DQ_THREADS = 256;
constexpr int DQ_BYTES = 4;  // packed bytes per thread

__device__ __forceinline__ float dq_value(unsigned q, float s, float z) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), s), z);
}

__device__ __forceinline__ void dq_store8(__nv_bfloat16* out, const float (&v)[8]) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void dq_store8(float* out, const float (&v)[8]) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void dq_store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void dq_store1(float* out, float v) { *out = v; }

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
    int4_dequant_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ scales,
                        const float* __restrict__ zeros, T* __restrict__ out, long long n_bytes,
                        int half, int vec) {
  const long long j0 = (static_cast<long long>(blockIdx.x) * DQ_THREADS + threadIdx.x) * DQ_BYTES;
  if (j0 >= n_bytes) return;
  long long g = j0 / half;
  int rem = static_cast<int>(j0 - g * half);
  if (vec && j0 + DQ_BYTES <= n_bytes) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(packed + j0);
    float v[2 * DQ_BYTES];
#pragma unroll
    for (int i = 0; i < DQ_BYTES; ++i) {
      if (rem == half) {  // this byte opens the next group
        ++g;
        rem = 0;
      }
      const float s = scales[g], z = zeros[g];
      const unsigned byte = (word >> (8 * i)) & 0xffu;
      v[2 * i] = dq_value(byte & 0xfu, s, z);
      v[2 * i + 1] = dq_value(byte >> 4, s, z);
      ++rem;
    }
    dq_store8(out + 2 * j0, v);
    return;
  }
  for (int i = 0; i < DQ_BYTES && j0 + i < n_bytes; ++i) {
    if (rem == half) {
      ++g;
      rem = 0;
    }
    const float s = scales[g], z = zeros[g];
    const unsigned byte = packed[j0 + i];
    dq_store1(out + 2 * (j0 + i), dq_value(byte & 0xfu, s, z));
    dq_store1(out + 2 * (j0 + i) + 1, dq_value(byte >> 4, s, z));
    ++rem;
  }
}

}  // namespace repro

// packed (G, half) uint8, scales/zeros (G, 1) float32, out (G, 2 * half) in
// `dtype` (0 float32, 1 bfloat16), all contiguous.
extern "C" int int4_dequant_launch(const void* packed, const void* scales, const void* zeros,
                                   void* out, int dtype, long long G, int half, void* stream) {
  const long long n_bytes = G * half;
  const long long threads = (n_bytes + repro::DQ_BYTES - 1) / repro::DQ_BYTES;
  const unsigned blocks = static_cast<unsigned>((threads + repro::DQ_THREADS - 1) / repro::DQ_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // word loads need 4-byte aligned packed bytes, the vector stores a
  // 16-byte aligned output (every thread's slice starts at 8 elements)
  const int vec = reinterpret_cast<uintptr_t>(packed) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* sc = static_cast<const float*>(scales);
  const auto* z = static_cast<const float*>(zeros);
  if (dtype == repro::kBF16)
    repro::int4_dequant_kernel<__nv_bfloat16><<<blocks, repro::DQ_THREADS, 0, s>>>(
        p, sc, z, static_cast<__nv_bfloat16*>(out), n_bytes, half, vec);
  else
    repro::int4_dequant_kernel<float><<<blocks, repro::DQ_THREADS, 0, s>>>(
        p, sc, z, static_cast<float*>(out), n_bytes, half, vec);
  return static_cast<int>(cudaGetLastError());
}
