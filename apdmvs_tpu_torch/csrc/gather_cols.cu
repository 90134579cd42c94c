// H5 gather_cols: K-columns of a volume at the weak worklist's positions, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/cols.py::_make_gather_kernel (entry
// gather_rows), together with the layout work around it in
// apdmvs_tpu/weak.py::build_weak_cols (pack_volume_rows, flat_index, the
// transpose to [Vs, K, M]). Per output (p, m), p = v * K + k:
//   xi = clip(xs[m] + pad_x, 0, PW-1),  yi = clip(ys[m] + pad_y, 0, PH-1)
//   out[p, m] = vol[p, yi, xi]
// A -1 coordinate (missing anchor, worklist padding) clamps to pad-1 and
// reads a real position, as flat_index does; callers mask those columns.
// The result is a copy, so it is bit-exact with the plain version.
//
// Why in place: the TPU kernel DMAs contiguous rows of a position-major
// [PH*PW, Vs*K] table, which costs a full transposed copy of each volume a
// pass. Here each thread reads its element where it lies.
//
// Bound on this card: bytes (one element read and one written per output,
// plus the coordinates). Design: one thread per (p, m), m fastest, so the
// writes coalesce; the worklist is a raster-order compaction, so the reads
// of a warp mostly run along one image row of one slice. Plane offsets are
// 64-bit: Vs*K*PH*PW passes 2^31 at real image sizes.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void gather_cols_kernel(const T* __restrict__ vol, const int* __restrict__ xs,
                                   const int* __restrict__ ys, int P, int PH, int PW, int M,
                                   int pad_y, int pad_x, T* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int xi = min(max(__ldg(xs + m) + pad_x, 0), PW - 1);
  const int yi = min(max(__ldg(ys + m) + pad_y, 0), PH - 1);
  const long long plane = (long long)PH * PW;
  const long long pix = (long long)yi * PW + xi;
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    out[p * M + m] = __ldg(vol + p * plane + pix);
  }
}

extern "C" int gather_cols_launch(const void* vol, const int* xs, const int* ys, int P, int PH,
                                  int PW, int M, int pad_y, int pad_x, int elem_bytes, void* out,
                                  void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((M + threads - 1) / threads), (unsigned)(P < 65535 ? P : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    gather_cols_kernel<uint16_t><<<grid, threads, 0, s>>>(
        static_cast<const uint16_t*>(vol), xs, ys, P, PH, PW, M, pad_y, pad_x,
        static_cast<uint16_t*>(out));
  } else if (elem_bytes == 4) {
    gather_cols_kernel<uint32_t><<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(vol), xs, ys, P, PH, PW, M, pad_y, pad_x,
        static_cast<uint32_t*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
