// H1 build_volume: plane-sweep volume builder for Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/volume.py::_build_kernel
// (entry build_volume_pallas). Computes, for every slice k and every
// (padded) reference pixel, the source image sampled at the warp of that
// pixel by slice k's fronto-parallel homography:
//
//   dirs = ((x - cx) / fx, (y - cy) / fy, 1)
//   q    = M dirs + b u_k,   u_k = u_min + k du
//   s    = (q0 / q2, q1 / q2)            [trunc: floored]
//   out  = border-clamped bilinear of src at s (clamp before the split)
//
// in exactly the operation order of the plain version
// (ops/volume.py::build_volume_padded). Bilinear mode writes bf16 (round
// to nearest even) onto the padded grid; trunc mode writes f32 onto the
// unpadded grid (the depth volumes of geometric passes).
//
// Bound on this card: bytes. Each output element is written once (2 or 4
// bytes) and needs ~30 flops; the source image (1.2 MB at 640x480) stays
// in L2, so the volume write (142 MB bf16 per view at K=160, 640x480) sets
// the floor. Design: one thread per output element, consecutive threads on
// consecutive x so the stores coalesce; the source reads go through the
// read-only cache (__ldg). The warp constants stay in device memory, so the
// wrapper never waits for the card. No texture filtering: its fixed-point
// weights are not the f32 sampler's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <bool TRUNC>
__global__ void build_volume_kernel(const float* __restrict__ src, int SH, int SW,
                                    const float* __restrict__ p, int K, int PH, int PW,
                                    int pad_y, int pad_x, float row0, void* __restrict__ out) {
  // p: fx, fy, cx, cy, M[9], b[3], u_min, du (device memory, read by every thread)
  const float fx = __ldg(p + 0), fy = __ldg(p + 1), cx = __ldg(p + 2), cy = __ldg(p + 3);
  float M[9];
  for (int m = 0; m < 9; ++m) M[m] = __ldg(p + 4 + m);
  const float b0 = __ldg(p + 13), b1 = __ldg(p + 14), b2 = __ldg(p + 15);
  const float u_min = __ldg(p + 16), du = __ldg(p + 17);
  const long long total = (long long)K * PH * PW;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int px = (int)(i % PW);
    const int py = (int)((i / PW) % PH);
    const int k = (int)(i / ((long long)PW * PH));
    const float y = ((float)py - (float)pad_y) + row0;
    const float x = (float)px - (float)pad_x;
    const float dx = (x - cx) / fx;
    const float dy = (y - cy) / fy;
    const float u = u_min + (float)k * du;
    const float q0 = (M[0] * dx + M[1] * dy + M[2]) + b0 * u;
    const float q1 = (M[3] * dx + M[4] * dy + M[5]) + b1 * u;
    const float q2 = (M[6] * dx + M[7] * dy + M[8]) + b2 * u;
    float sx = q0 / q2;
    float sy = q1 / q2;
    if (TRUNC) {
      sx = floorf(sx);
      sy = floorf(sy);
    }
    sx = fminf(fmaxf(sx, 0.0f), (float)SW - 1.0f);
    sy = fminf(fmaxf(sy, 0.0f), (float)SH - 1.0f);
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    const float wx = sx - x0f;
    const float wy = sy - y0f;
    const int x0 = min(max((int)x0f, 0), SW - 1);
    const int x1 = min(x0 + 1, SW - 1);
    const int y0 = min(max((int)y0f, 0), SH - 1);
    const int y1 = min(y0 + 1, SH - 1);
    const float v00 = __ldg(src + (long long)y0 * SW + x0);
    const float v01 = __ldg(src + (long long)y0 * SW + x1);
    const float v10 = __ldg(src + (long long)y1 * SW + x0);
    const float v11 = __ldg(src + (long long)y1 * SW + x1);
    const float top = v00 * (1.0f - wx) + v01 * wx;
    const float bot = v10 * (1.0f - wx) + v11 * wx;
    const float val = top * (1.0f - wy) + bot * wy;
    if (TRUNC) {
      static_cast<float*>(out)[i] = val;
    } else {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(val);
    }
  }
}

extern "C" int build_volume_launch(const float* src, int SH, int SW, const float* params,
                                   int K, int PH, int PW, int pad_y, int pad_x, float row0,
                                   int trunc, void* out, void* stream) {
  const long long total = (long long)K * PH * PW;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trunc) {
    build_volume_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(src, SH, SW, params, K, PH,
                                                                   PW, pad_y, pad_x, row0, out);
  } else {
    build_volume_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(src, SH, SW, params, K, PH,
                                                                    PW, pad_y, pad_x, row0, out);
  }
  return (int)cudaGetLastError();
}
