// H8 volume_sample: per-pixel clamped linear interpolation along the slice
// axis of a plane-sweep volume, for Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/volume.py:375 _select_kernel (entry
// volume_sample, :391); oracle the mirror volume_sample_ref (:362). Per
// pixel p of E [K, H, W] and k [H, W]:
//   kc = clip(k, 0, K-1), k0 = floor(kc), k1 = min(k0 + 1, K-1), f = kc - k0
//   out = E[k0, p] * (1 - f) + E[k1, p] * f                      (f32)
// the mirror's expression in its order; the library is built with
// --fmad=false, so the two products and the sum round as in the plain
// version and the result is bit-exact with it.
// NaN: the mirror converts floor(NaN) to the integer 0 (XLA's conversion),
// reads slice 0 and returns NaN through f. fminf/fmaxf would turn a NaN k
// into a bound, so NaN is tested for first. k = +-inf clamps to K-1 / 0.
//
// Why not the TPU design: a TPU core cannot gather, so the Pallas kernel
// streams all K slices of its (8, 128) tile through VMEM and keeps the two
// wanted ones with a K-way select. This card loads by address: each thread
// reads exactly its two elements.
//
// Bound on this card: bytes (k in, two elements of E, the output out; the
// arithmetic is 5 operations a pixel). Design: one thread per pixel, pixels
// fastest, so k, the output and the reads of one slice coalesce wherever
// neighbouring pixels share a slice. Slice offsets are 64-bit: K*H*W passes
// 2^31 at real image sizes. More pixels a thread (2, 4 or 8, strided or as
// float4, for more requests in flight) measured level or slower: a call on
// one block of pixels already takes two thirds of a full call's time, the
// launch and one k -> E -> store chain, which no layout shortens.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float load_e(const uint16_t* e, long long i) {
  return __uint_as_float(((uint32_t)__ldg(e + i)) << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ float load_e(const float* e, long long i) { return __ldg(e + i); }

template <typename T>
__global__ void volume_sample_kernel(const T* __restrict__ E, const float* __restrict__ k,
                                     int K, long long P, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float kr = __ldg(k + p);
  float kc;
  int k0;
  if (isnan(kr)) {
    kc = kr;
    k0 = 0;
  } else {
    kc = fminf(fmaxf(kr, 0.0f), (float)(K - 1));
    k0 = (int)floorf(kc);
  }
  const int k1 = min(k0 + 1, K - 1);
  const float f = kc - (float)k0;
  const float e0 = load_e(E, (long long)k0 * P + p);
  const float e1 = load_e(E, (long long)k1 * P + p);
  out[p] = e0 * (1.0f - f) + e1 * f;
}

extern "C" int volume_sample_launch(const void* E, const float* k, int K, long long P, int bf16,
                                    float* out, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((P + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    volume_sample_kernel<uint16_t><<<blocks, threads, 0, s>>>(static_cast<const uint16_t*>(E), k,
                                                              K, P, out);
  } else {
    volume_sample_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(E), k, K, P,
                                                           out);
  }
  return (int)cudaGetLastError();
}
