// H1 build_volume: plane-sweep volume builder for Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/volume.py::_build_kernel
// (entry build_volume_pallas). Computes, for every slice k and every
// (padded) reference pixel, the source image sampled at the warp of that
// pixel by slice k's fronto-parallel homography:
//
//   dirs = ((x - cx) / fx, (y - cy) / fy, 1)
//   Md   = M dirs                          (once per pixel)
//   q    = Md + b u_k,   u_k = u_min + k du
//   s    = (q0 / q2, q1 / q2)            [trunc: floored]
//   out  = border-clamped bilinear of src at s (clamp before the split)
//
// in exactly the operation order of the plain version
// (ops/volume.py::build_volume_padded, which also computes Md once per
// pixel), so the result is bit-exact. Bilinear mode writes bf16 (round to
// nearest even) onto the padded grid; trunc mode writes f32 onto the
// unpadded grid (the depth volumes of geometric passes).
//
// Bound on this card: bytes by the roofline (the 142 MB bf16 volume per view
// at K=160, 640x480 is written once; the 1.2 MB source stays in L2). What
// sets its time is instruction issue: per output two IEEE divisions (~8
// instructions each with their range check), four gathered source reads
// and the bilinear arithmetic, ~60 instructions. The thread-per-element
// kernel this replaces spent as many again on 64-bit index math (a 64-bit
// % and / per element, signed offsets widened per load) and on M dirs,
// which does not depend on the slice. Design: a thread owns 4 adjacent
// pixels of one padded row and a chunk of K_CHUNK slices (blockIdx.z). It
// computes the pixel directions and Md once, then per slice only b u_k
// (shared by its 4 pixels), q, the two correctly rounded divisions (no
// reciprocal: trunc mode floors the quotient, so a 1-ulp change moves a
// pixel) and the bilinear read, whose four addresses are 32-bit unsigned
// offsets from the source (one IMAD.WIDE a load); it stores 4 outputs at
// once (8 bytes bf16, 16 bytes f32), and a warp writes 128 consecutive
// pixels of a slice row. Giving a thread pixels 32 apart instead (each
// gather of a warp on fewer cache lines) measured no faster. The slice base
// is one 64-bit multiply per slice. The source reads go through the
// read-only cache (__ldg). The warp constants stay in device memory, so the
// wrapper never waits for the card. No texture filtering: its fixed-point
// weights are not the f32 sampler's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PIX 4       // adjacent pixels of one row per thread
#define BLOCK_X 32  // threads along x: 128 pixels
#define BLOCK_Y 4   // rows per block
#define K_CHUNK 16  // slices per thread

template <bool TRUNC>
__device__ __forceinline__ float warp_sample(const float* __restrict__ src, int SH, int SW, float q0,
                                             float q1, float q2) {
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
  // sx, sy are clamped (a NaN to 0), so x0, y0 lie in the image
  const int x0 = (int)x0f;
  const int x1 = min(x0 + 1, SW - 1);
  const int y0 = (int)y0f;
  const int y1 = min(y0 + 1, SH - 1);
  const unsigned r0 = (unsigned)(y0 * SW), r1 = (unsigned)(y1 * SW);
  const float v00 = __ldg(src + (r0 + (unsigned)x0));
  const float v01 = __ldg(src + (r0 + (unsigned)x1));
  const float v10 = __ldg(src + (r1 + (unsigned)x0));
  const float v11 = __ldg(src + (r1 + (unsigned)x1));
  const float top = v00 * (1.0f - wx) + v01 * wx;
  const float bot = v10 * (1.0f - wx) + v11 * wx;
  return top * (1.0f - wy) + bot * wy;
}

template <bool TRUNC>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y)
    build_volume_kernel(const float* __restrict__ src, int SH, int SW, const float* __restrict__ p,
                        int K, int PH, int PW, int pad_y, int pad_x, float row0,
                        void* __restrict__ out) {
  const int px0 = (blockIdx.x * BLOCK_X + threadIdx.x) * PIX;
  const int py = blockIdx.y * BLOCK_Y + threadIdx.y;
  const int k_begin = blockIdx.z * K_CHUNK;
  if (px0 >= PW || py >= PH || k_begin >= K) return;
  const int k_end = min(k_begin + K_CHUNK, K);

  // p: fx, fy, cx, cy, M[9], b[3], u_min, du (device memory, read by every thread)
  const float fx = __ldg(p + 0), fy = __ldg(p + 1), cx = __ldg(p + 2), cy = __ldg(p + 3);
  float M[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) M[m] = __ldg(p + 4 + m);
  const float b0 = __ldg(p + 13), b1 = __ldg(p + 14), b2 = __ldg(p + 15);
  const float u_min = __ldg(p + 16), du = __ldg(p + 17);

  const int npix = min(PIX, PW - px0);
  const float y = ((float)py - (float)pad_y) + row0;
  const float dy = (y - cy) / fy;
  float Md0[PIX], Md1[PIX], Md2[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const float x = (float)(px0 + j) - (float)pad_x;
    const float dx = (x - cx) / fx;
    Md0[j] = (M[0] * dx + M[1] * dy) + M[2];
    Md1[j] = (M[3] * dx + M[4] * dy) + M[5];
    Md2[j] = (M[6] * dx + M[7] * dy) + M[8];
  }

  const size_t plane = (size_t)PH * PW;
  const size_t row_off = (size_t)py * PW + px0;
  // whole-vector stores need 4 pixels and 4-element alignment of every row
  const bool vec = npix == PIX && (PW % PIX) == 0;
  for (int k = k_begin; k < k_end; ++k) {
    const float u = u_min + (float)k * du;
    const float bu0 = b0 * u, bu1 = b1 * u, bu2 = b2 * u;
    float val[PIX];
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      val[j] = warp_sample<TRUNC>(src, SH, SW, Md0[j] + bu0, Md1[j] + bu1, Md2[j] + bu2);
    }
    const size_t off = (size_t)k * plane + row_off;
    if (TRUNC) {
      float* o = static_cast<float*>(out) + off;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(val[0], val[1], val[2], val[3]);
      } else {
        for (int j = 0; j < npix; ++j) o[j] = val[j];
      }
    } else {
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + off;
      if (vec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(val[0], val[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(val[2], val[3]);
        uint2 pk;
        pk.x = *reinterpret_cast<const uint32_t*>(&lo);
        pk.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(o) = pk;
      } else {
        for (int j = 0; j < npix; ++j) o[j] = __float2bfloat16_rn(val[j]);
      }
    }
  }
}

extern "C" int build_volume_launch(const float* src, int SH, int SW, const float* params,
                                   int K, int PH, int PW, int pad_y, int pad_x, float row0,
                                   int trunc, void* out, void* stream) {
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((PW + BLOCK_X * PIX - 1) / (BLOCK_X * PIX), (PH + BLOCK_Y - 1) / BLOCK_Y,
                  (K + K_CHUNK - 1) / K_CHUNK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trunc) {
    build_volume_kernel<true><<<grid, block, 0, s>>>(src, SH, SW, params, K, PH, PW, pad_y, pad_x,
                                                     row0, out);
  } else {
    build_volume_kernel<false><<<grid, block, 0, s>>>(src, SH, SW, params, K, PH, PW, pad_y, pad_x,
                                                      row0, out);
  }
  return (int)cudaGetLastError();
}
