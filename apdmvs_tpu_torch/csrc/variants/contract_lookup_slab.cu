// A variant of H6 contract_lookup that the package does not build: the
// slab design, where a tile's slice range is staged in shared memory and
// the lookups are served from there. It was measured slower than the kept
// kernel (csrc/contract_lookup.cu; PERF.md, Findings) and is kept so that
// the measurement can be repeated. Same function, same C interface and
// same rounding as the kept kernel, so it drops in for it. To time it
// beside the kept kernel on one card:
//
//   mkdir -p _variants/slab && cp -r apdmvs_tpu_torch _variants/slab/
//   cp apdmvs_tpu_torch/csrc/variants/contract_lookup_slab.cu \
//      _variants/slab/apdmvs_tpu_torch/csrc/contract_lookup.cu
//   for r in . _variants/slab _variants/slab .; do
//     python3 apdmvs_tpu_torch/ab_kernels.py $r h6; done
//
// ab_kernels.py holds every H6 case it times against the plain version,
// and its h6 group has a case whose lookups fit the slab everywhere
// (c9_tent_band) and one whose lookups take the direct path almost
// everywhere (c9_tent_spread).
//
// Design: a warp owns 32 neighbouring positions (the tile) and all views.
// - It reads the k of its positions once (B coalesced loads a lane) and
//   reduces them to the slices they weigh, lo .. hi (NaN k weigh none; the
//   clamp first, as the lookup does).
// - Where Vs * (hi - lo + 1) rows of 32 positions fit its SLAB_BYTES of
//   shared memory (2 KB: 32 bf16 or 16 f32 rows; 6 KB was measured too)
//   and the tile is whole, it stages those
//   rows, 16 bytes a load where the columns' base and row length allow
//   (4 lanes a bf16 row, 8 an f32 row), and serves every (b, v) lookup
//   from them. A bf16 row is 16 banks wide, so the 32 lanes' reads of
//   different rows collide at most two to a bank; f32 reads never do.
// - Otherwise (a wide range, or the last, partial tile) the warp takes
//   direct loads, as the kept kernel does, inside the same kernel.
// - Results are stored as the kept kernel stores them: a warp's store is
//   128 contiguous bytes of one (b, v) row.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#ifndef SLAB_BYTES
#define SLAB_BYTES 2048  // a warp's slab; 8 warps a block share SLAB_BYTES * 8 of shared memory
#endif

__device__ __forceinline__ float widen(uint16_t c) {
  return __uint_as_float(((uint32_t)c) << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ float widen(float c) { return c; }

template <bool SMEM, typename T>
__device__ __forceinline__ float ld(const T* p) {
  if constexpr (SMEM) {
    return widen(*p);
  } else {
    return widen(__ldg(p));
  }
}

// The lookups of one position, every candidate and view, from columns at
// c: view v's slice i at c[v * view + (i - first) * row], in the slab
// (SMEM) or in global memory.
template <typename T, bool NEAREST, bool SMEM>
__device__ __forceinline__ void serve(const T* c, size_t view, size_t row, int first,
                                      const float* kr, int Vs, int K, int R, int B, float* o) {
  for (int b = 0; b < B; ++b, o += (size_t)Vs * R) {
    const float x = __ldg(kr + (size_t)b * R);
    if (isnan(x)) {
      const float fill = NEAREST ? 0.0f : __int_as_float(0x7fc00000);
      for (int v = 0; v < Vs; ++v) o[(size_t)v * R] = fill;
      continue;
    }
    const float kc = fminf(fmaxf(x, 0.0f), (float)(K - 1));
    if (NEAREST) {
      const T* ci = c + (size_t)((int)rintf(kc) - first) * row;
#pragma unroll 4
      for (int v = 0; v < Vs; ++v) o[(size_t)v * R] = ld<SMEM>(ci + v * view);
    } else {
      const int i0 = (int)floorf(kc);
      const float w0 = fmaxf(0.0f, 1.0f - fabsf(kc - (float)i0));
      const bool two = i0 + 1 < K;
      const float w1 = two ? fmaxf(0.0f, 1.0f - fabsf(kc - (float)(i0 + 1))) : 0.0f;
      const T* c0 = c + (size_t)(i0 - first) * row;
      const T* c1 = c + (size_t)(min(i0 + 1, K - 1) - first) * row;
#pragma unroll 4
      for (int v = 0; v < Vs; ++v) {
        const float a0 = ld<SMEM>(c0 + v * view), a1 = ld<SMEM>(c1 + v * view);
        float s = a0 * w0;
        if (two) s = s + a1 * w1;
        o[(size_t)v * R] = s;
      }
    }
  }
}

template <typename T, bool NEAREST>
__global__ void __launch_bounds__(THREADS)
contract_lookup_kernel(const T* __restrict__ cols, const float* __restrict__ k, int Vs, int K,
                       int R, int B, int vec, float* __restrict__ out) {
  constexpr int ROWS = SLAB_BYTES / (32 * (int)sizeof(T));
  constexpr int PER_ROW = 32 * (int)sizeof(T) / 16;  // 16-byte vectors a row
  __shared__ __align__(16) T slab_all[WARPS][ROWS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * WARPS + warp) * 32;
  if (r0 >= R) return;  // the whole warp
  const int r = r0 + lane;
  const bool live = r < R;
  const size_t KR = (size_t)K * R;

  int lo = K, hi = -1;
  if (live) {
    for (int b = 0; b < B; ++b) {
      const float x = __ldg(k + (size_t)b * R + r);
      if (isnan(x)) continue;
      const float kc = fminf(fmaxf(x, 0.0f), (float)(K - 1));
      const int i0 = NEAREST ? (int)rintf(kc) : (int)floorf(kc);
      lo = min(lo, i0);
      hi = max(hi, NEAREST ? i0 : min(i0 + 1, K - 1));
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int span = hi - lo + 1;  // <= 0 where every k is NaN
  const bool staged = r0 + 32 <= R && span > 0 && Vs * span <= ROWS;
  T* slab = slab_all[warp];
  if (staged) {
    for (int v = 0; v < Vs; ++v) {
      const T* src = cols + v * KR + (size_t)lo * R + r0;  // row lo of view v
      T* dst = slab + v * span * 32;
      if (vec) {
        for (int i = lane; i < span * PER_ROW; i += 32) {
          const int row = i / PER_ROW, part = i % PER_ROW;
          reinterpret_cast<uint4*>(dst + row * 32)[part] =
              __ldg(reinterpret_cast<const uint4*>(src + (size_t)row * R) + part);
        }
      } else {
#pragma unroll 8
        for (int row = 0; row < span; ++row) dst[row * 32 + lane] = src[(size_t)row * R + lane];
      }
    }
    __syncwarp();
  }
  if (!live) return;

  if (staged) {
    serve<T, NEAREST, true>(slab + lane, span * 32, 32, lo, k + r, Vs, K, R, B, out + r);
  } else {
    serve<T, NEAREST, false>(cols + r, KR, R, 0, k + r, Vs, K, R, B, out + r);
  }
}

template <typename T>
static void launch(const void* cols, const float* k, int Vs, int K, int R, int B, int nearest,
                   float* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((R + THREADS - 1) / THREADS);
  const int vec = (reinterpret_cast<uintptr_t>(cols) % 16 == 0) && ((size_t)R * sizeof(T)) % 16 == 0;
  if (nearest) {
    contract_lookup_kernel<T, true><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(cols), k, Vs,
                                                               K, R, B, vec, out);
  } else {
    contract_lookup_kernel<T, false><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(cols), k,
                                                                Vs, K, R, B, vec, out);
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
