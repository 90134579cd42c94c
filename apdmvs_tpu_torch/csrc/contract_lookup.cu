// H6 contract_lookup: tent or nearest lookup of every candidate along the
// resident K-columns of the weak worklist, for Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/cols.py::_contract_kernel (entry
// contract_lookup); oracle the mirrors tent_lookup / nearest_lookup. Per
// output (b, v, r), with c = cols_t[v, :, r] and kc = clip(k[b, r], 0, K-1):
//   tent:    sum_i c[i] * max(0, 1 - |kc - i|)   (only i0 = floor(kc) and
//            i0 + 1 < K can weigh; summed c0*w0 + c1*w1, weights computed as
//            the mirror computes them, not as (1-f, f))
//   nearest: c[rint(kc)]                         (half to even, as jnp.round)
// NaN: the mirrors give NaN (tent) and 0 (nearest) for a NaN k, which is
// what a zero RANSAC fit plane produces (u = 0/0). fmaxf/fminf would drop
// the NaN and read c[0], so it is tested for first. bf16 columns are
// widened to f32 exactly before the products; the library is built with
// --fmad=false, so products and the sum round as in the plain version.
//
// Bound on this card: bytes. The TPU kernel streams all K slices of a column
// for every candidate block; this one reads only the 1 (nearest) or 2 (tent)
// slices that carry weight, plus k and the output. Design: one thread per r,
// loops over b and v; loads and stores of [.., R] rows coalesce along r, and
// neighbouring worklist positions mostly look up the same slices.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_col(const uint16_t* c, long long i) {
  return __uint_as_float(((uint32_t)__ldg(c + i)) << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ float load_col(const float* c, long long i) { return __ldg(c + i); }

template <typename T, bool NEAREST>
__global__ void contract_lookup_kernel(const T* __restrict__ cols, const float* __restrict__ k,
                                       int Vs, int K, int R, int B, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long KR = (long long)K * R;
  for (int b = 0; b < B; ++b) {
    const float kr = __ldg(k + (long long)b * R + r);
    float* o = out + (long long)b * Vs * R + r;
    if (isnan(kr)) {
      const float fill = NEAREST ? 0.0f : __int_as_float(0x7fc00000);
      for (int v = 0; v < Vs; ++v) o[(long long)v * R] = fill;
      continue;
    }
    const float kc = fminf(fmaxf(kr, 0.0f), (float)(K - 1));
    if (NEAREST) {
      const long long i = (long long)rintf(kc);
      for (int v = 0; v < Vs; ++v) o[(long long)v * R] = load_col(cols, v * KR + i * R + r);
    } else {
      const int i0 = (int)floorf(kc);
      const float w0 = fmaxf(0.0f, 1.0f - fabsf(kc - (float)i0));
      const bool two = i0 + 1 < K;
      const float w1 = two ? fmaxf(0.0f, 1.0f - fabsf(kc - (float)(i0 + 1))) : 0.0f;
      for (int v = 0; v < Vs; ++v) {
        const long long base = v * KR + (long long)i0 * R + r;
        float s = load_col(cols, base) * w0;
        if (two) s = s + load_col(cols, base + R) * w1;
        o[(long long)v * R] = s;
      }
    }
  }
}

template <typename T>
static void launch(const void* cols, const float* k, int Vs, int K, int R, int B, int nearest,
                   float* out, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((R + threads - 1) / threads);
  if (nearest) {
    contract_lookup_kernel<T, true><<<blocks, threads, 0, s>>>(static_cast<const T*>(cols), k,
                                                                Vs, K, R, B, out);
  } else {
    contract_lookup_kernel<T, false><<<blocks, threads, 0, s>>>(static_cast<const T*>(cols), k,
                                                                 Vs, K, R, B, out);
  }
}

extern "C" int contract_lookup_launch(const void* cols, const float* k, int Vs, int K, int R,
                                      int B, int nearest, int bf16, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<uint16_t>(cols, k, Vs, K, R, B, nearest, out, s);
  } else {
    launch<float>(cols, k, Vs, K, R, B, nearest, out, s);
  }
  return (int)cudaGetLastError();
}
