// H4 geom_cost: geometric-consistency cost over a source view's depth
// volume, for Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/ncc_volume.py::_geom_kernel
// (entry geom_volume_cost_view); oracle geom_volume_cost_view_ref. Per
// output (c, y, x):
//   u   = -(n . dir(x, y)) / w,  k = clamp((u - u_min) / du, 0, K-1)
//   sd  = D[rint(k), y, x]        (nearest slice, half to even as jnp.round)
//   p   = warp of (x, y) into the source view at inverse depth u
//   q   = reprojection of (p, sd) into the reference view (A, t')
//   cost = min(|(x, y) - q|, 3); 3 when sd == 0 or p leaves the source.
//
// Bound on this card: bytes (16 bytes of plane, one 4-byte D value and a
// 4-byte cost per output, against ~60 f32 operations); the D load is the
// scattered one. Design: one thread per output, x fastest, so the plane
// reads and cost writes coalesce and the D loads of a warp hit one or two
// slices where the field is smooth.

#include <cuda_runtime.h>
#include <stdint.h>

#define GEOM_COST_MAX 3.0f

__global__ void geom_cost_kernel(const float* __restrict__ D, const float* __restrict__ planes,
                                 const float* __restrict__ g, int C, int H, int W, int K,
                                 float* __restrict__ out) {
  const long long hw = (long long)H * W;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)C * hw) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int c = (int)(i / hw);
  const float fx = __ldg(g + 0), fy = __ldg(g + 1), cx = __ldg(g + 2), cy = __ldg(g + 3);
  const float u_min = __ldg(g + 4), du = __ldg(g + 5);
  const float* M = g + 6;
  const float* b = g + 15;
  const float* A = g + 18;
  const float* t = g + 27;
  const float src_w = __ldg(g + 30), src_h = __ldg(g + 31), row0 = __ldg(g + 32);

  const float xs = (float)x;
  const float ys = (float)y + row0;
  const float dirx = (xs - cx) / fx;
  const float diry = (ys - cy) / fy;
  const float* pl = planes + (long long)c * 4 * hw + (long long)y * W + x;
  const float n0 = __ldg(pl), n1 = __ldg(pl + hw), n2 = __ldg(pl + 2 * hw), w = __ldg(pl + 3 * hw);
  const float u = -((n0 * dirx + n1 * diry) + n2) / w;
  const float kr = (u - u_min) / du;
  const float k = isnan(kr) ? kr : fminf(fmaxf(kr, 0.0f), (float)(K - 1));
  const float kn = rintf(k);
  const int ri = isnan(kn) ? 0 : (int)kn;
  const float sd = __ldg(D + (long long)ri * hw + (long long)y * W + x);

  const float qx = (__ldg(M + 0) * dirx + __ldg(M + 1) * diry + __ldg(M + 2)) + __ldg(b + 0) * u;
  const float qy = (__ldg(M + 3) * dirx + __ldg(M + 4) * diry + __ldg(M + 5)) + __ldg(b + 1) * u;
  const float qz = (__ldg(M + 6) * dirx + __ldg(M + 7) * diry + __ldg(M + 8)) + __ldg(b + 2) * u;
  const float px = qx / qz;
  const float py = qy / qz;
  const bool oob = (px < 0.0f) || (px >= src_w) || (py < 0.0f) || (py >= src_h);
  const float rx = (__ldg(A + 0) * px + __ldg(A + 1) * py) + __ldg(A + 2);
  const float ry = (__ldg(A + 3) * px + __ldg(A + 4) * py) + __ldg(A + 5);
  const float rz = (__ldg(A + 6) * px + __ldg(A + 7) * py) + __ldg(A + 8);
  const float bz = sd * rz + __ldg(t + 2);
  const float bx = (sd * rx + __ldg(t + 0)) / bz;
  const float by = (sd * ry + __ldg(t + 1)) / bz;
  const float ex = xs - bx;
  const float ey = ys - by;
  const float err = sqrtf(ex * ex + ey * ey);
  float cost = isnan(err) ? err : fminf(err, GEOM_COST_MAX);
  if (sd == 0.0f || oob) cost = GEOM_COST_MAX;
  out[i] = cost;
}

extern "C" int geom_cost_launch(const float* D, const float* planes, const float* gconsts, int C,
                                int H, int W, int K, float* out, void* stream) {
  const long long total = (long long)C * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  geom_cost_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, planes, gconsts, C, H, W, K, out);
  return (int)cudaGetLastError();
}
