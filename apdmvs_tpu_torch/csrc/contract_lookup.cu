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
// Bound on this card: bytes (the column elements the k touch, k, and the
// [B, Vs, R] f32 output, which is most of it). What the time goes to, at
// the C9 anchors with B=10 (NVIDIA H100 80GB HBM3, 700 W, PERF.md): the
// stores alone take ~10 us (3.2 TB/s), k and the stores ~13 us, the
// column reads the rest: lanes of a warp look up different slices (8
// anchors of 4 pixels at different depths), so a warp's load of one slice
// touches ~10 distinct 128-byte lines, and the L1 serves one line a pass.
// Design:
// - a thread owns one position and walks the candidates; lanes of a warp
//   own neighbouring positions, so every k load and result store of a
//   warp is 128 contiguous bytes;
// - the next candidate's k is loaded before the current one's columns, so
//   its latency hides behind them;
// - offsets are 64-bit (32-bit offsets inside a view, where K * R allows,
//   were measured level and not kept); the view loop is unrolled by 4, so
//   a candidate's column loads of 4 views go out together;
// - measured slower and not kept (PERF.md, Findings): staging a tile's or a
//   warp's slice range in shared memory (256 or 32 positions, cp.async,
//   one or two buffers), a window of 8 slices a position, the candidates'
//   k held in registers, 2 or 4 positions a thread with 8- or 16-byte
//   stores, and reusing the slices the last candidate read. Each cost
//   occupancy or latency that the fewer line passes did not pay back.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ float load_col(const uint16_t* c) {
  return __uint_as_float(((uint32_t)__ldg(c)) << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ float load_col(const float* c) { return __ldg(c); }

template <typename T, bool NEAREST>
__global__ void __launch_bounds__(THREADS)
contract_lookup_kernel(const T* __restrict__ cols, const float* __restrict__ k, int Vs, int K,
                       int R, int B, float* __restrict__ out) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const size_t KR = (size_t)K * R;
  const float* kr = k + r;
  const T* colr = cols + r;
  float x = __ldg(kr);
  for (int b = 0; b < B; ++b) {
    const float xn = b + 1 < B ? __ldg(kr + (size_t)(b + 1) * R) : 0.0f;  // the next k
    float* o = out + (size_t)b * Vs * R + r;
    if (isnan(x)) {
      const float fill = NEAREST ? 0.0f : __int_as_float(0x7fc00000);
      for (int v = 0; v < Vs; ++v) o[(size_t)v * R] = fill;
    } else {
      const float kc = fminf(fmaxf(x, 0.0f), (float)(K - 1));
      if (NEAREST) {
        const size_t off = (size_t)rintf(kc) * R;
#pragma unroll 4
        for (int v = 0; v < Vs; ++v) o[(size_t)v * R] = load_col(colr + (size_t)v * KR + off);
      } else {
        const int i0 = (int)floorf(kc);
        const float w0 = fmaxf(0.0f, 1.0f - fabsf(kc - (float)i0));
        const bool two = i0 + 1 < K;
        const float w1 = two ? fmaxf(0.0f, 1.0f - fabsf(kc - (float)(i0 + 1))) : 0.0f;
        const size_t off0 = (size_t)i0 * R;
        const size_t off1 = (size_t)min(i0 + 1, K - 1) * R;
#pragma unroll 4
        for (int v = 0; v < Vs; ++v) {
          const T* c = colr + (size_t)v * KR;
          const float c0 = load_col(c + off0), c1 = load_col(c + off1);
          float s = c0 * w0;
          if (two) s = s + c1 * w1;
          o[(size_t)v * R] = s;
        }
      }
    }
    x = xn;
  }
}

template <typename T>
static void launch(const void* cols, const float* k, int Vs, int K, int R, int B, int nearest,
                   float* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((R + THREADS - 1) / THREADS);
  if (nearest) {
    contract_lookup_kernel<T, true><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(cols), k, Vs, K, R, B, out);
  } else {
    contract_lookup_kernel<T, false><<<blocks, THREADS, 0, s>>>(
        static_cast<const T*>(cols), k, Vs, K, R, B, out);
  }
}

extern "C" int contract_lookup_launch(const void* cols, const float* k, int Vs, int K, int R,
                                      int B, int nearest, int bf16, float* out, void* stream) {
  if (Vs < 1 || K < 1 || R < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<uint16_t>(cols, k, Vs, K, R, B, nearest, out, s);
  } else {
    launch<float>(cols, k, Vs, K, R, B, nearest, out, s);
  }
  return (int)cudaGetLastError();
}
