// H2 ncc_cost: exact volume NCC cost of C plane fields vs one source view,
// for Hopper (sm_90a).
//
// Replaces five TPU kernels of apdmvs_tpu/ops/ncc_volume.py that all compute
// this one function (ncc_volume_cost_view_ref is their common oracle):
//   _kernel + _fixup_kernel  (ncc_volume_cost_view: L1 band + L2 fixup)
//   _kernel_fullk            (ncc_volume_cost_view_fullk)
//   _kernel_rb               (ncc_rebased_cost_view, through R)
//   _kernel_rb_offs          (ncc_rebased_sweep_cost_view, auto-centred bands)
// The TPU split into bands, sentinels and a fixup pass existed because a TPU
// core has no fast gather; on this card each window sample simply loads its
// two K-neighbours, so there is no band, no sentinel and no second pass.
//
// Per output (c, y, x), over the 36-sample window (radius 5, step 2):
//   u   = -(n . dir(x+dx, y+dy)) / w        (inverse depth of the plane)
//   k   = clamp((u - u_min) / du, 0, K-1)
//   sv  = lerp(E[floor k], E[min(floor k + 1, K-1)], frac k) at (x+dx, y+dy)
//   rv  = ref at (x+dx, y+dy)
// then cost = clamp(1 - cov / sqrt(var_r var_s), 0, 2); cost 2 when either
// variance is < 1e-5 or the centre warp leaves the source image. The
// operation order is that of the plain version (ops/ncc_volume.py::
// ncc_volume_cost_ref), with every product and sum separately rounded
// (built with --fmad=false), except the two variances and the covariance:
// each is one explicit fused multiply-add, as the reference computes them
// (ops/ncc_volume.py::ncc_moments says why it matters).
//
// Optional (R, bf) input: R[j, p] = E[b(p) + j - J, p] with b = bf(p). A
// sample whose slice pair lies in [b - J, b + J] reads R, otherwise E. The
// values are identical; R exists for a GPU reason: j = k - b(p) is nearly
// constant across neighbouring pixels, so a warp's R loads fall on one or
// two planes and coalesce, where its E loads scatter across K planes.
//
// Bound on this card: by the roofline, bytes (E read once, 142 MB at K=160
// and 640x480, outweighs ~1100 f32 operations per output). In practice each
// output makes 72 scattered bf16 loads of E or R through L1/L2, and that
// cache traffic sets its time; the E window a block touches (a few slices
// around the candidates' depths, +-5 px) stays in cache. Design: one thread
// per output element, x fastest so a warp reads 32 consecutive pixels of
// each slice; read-only loads (__ldg); the candidate's four plane channels
// are read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_Y 8
#define PAD_X 128
#define COST_MAX 2.0f
#define MIN_VAR 1e-5f

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__global__ void ncc_cost_kernel(const __nv_bfloat16* __restrict__ E,
                                const float* __restrict__ ref,
                                const float* __restrict__ planes,
                                const float* __restrict__ consts, int C, int H, int W,
                                int K, int radius, int increment,
                                const __nv_bfloat16* __restrict__ R,
                                const float* __restrict__ bfm, int j2,
                                float* __restrict__ out) {
  const long long total = (long long)C * H * W;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int c = (int)(i / ((long long)W * H));
  const int PH = H + 2 * PAD_Y;
  const int PW = W + 2 * PAD_X;
  const long long plane_stride = (long long)PH * PW;

  const float fx = __ldg(consts + 0), fy = __ldg(consts + 1);
  const float cx = __ldg(consts + 2), cy = __ldg(consts + 3);
  const float u_min = __ldg(consts + 4), du = __ldg(consts + 5);
  const float row0 = __ldg(consts + 20);
  const float kmax = (float)(K - 1);
  const int J = (j2 - 1) / 2;

  const long long hw = (long long)H * W;
  const float* pl = planes + (long long)c * 4 * hw + (long long)y * W + x;
  const float n0 = __ldg(pl), n1 = __ldg(pl + hw), n2 = __ldg(pl + 2 * hw),
              w = __ldg(pl + 3 * hw);

  const float xs = (float)x;
  const float ys = (float)y + row0;
  float s_r = 0.f, s_rr = 0.f, s_s = 0.f, s_ss = 0.f, s_rs = 0.f;
  int S = 0;
  for (int dx = -radius; dx <= radius; dx += increment) {
    for (int dy = -radius; dy <= radius; dy += increment) {
      ++S;
      const float dirx = ((xs + (float)dx) - cx) / fx;
      const float diry = ((ys + (float)dy) - cy) / fy;
      const float u = -((n0 * dirx + n1 * diry) + n2) / w;
      const float kr = (u - u_min) / du;
      const float k = isnan(kr) ? kr : fminf(fmaxf(kr, 0.0f), kmax);
      const float k0f = floorf(k);
      const int k0 = isnan(k0f) ? 0 : (int)k0f;
      const int k1 = min(k0 + 1, K - 1);
      const float f = k - (float)k0;
      const long long pos = (long long)(PAD_Y + y + dy) * PW + (PAD_X + x + dx);
      float e0, e1;
      bool via_r = false;
      if (R != nullptr) {
        const int b = (int)__ldg(bfm + pos);
        if (k0 >= b - J && k1 <= b + J) {
          via_r = true;
          e0 = ldbf(R + (long long)(k0 - b + J) * plane_stride + pos);
          e1 = ldbf(R + (long long)(k1 - b + J) * plane_stride + pos);
        }
      }
      if (!via_r) {
        e0 = ldbf(E + (long long)k0 * plane_stride + pos);
        e1 = ldbf(E + (long long)k1 * plane_stride + pos);
      }
      const float sv = e0 * (1.0f - f) + e1 * f;
      const float rv = __ldg(ref + pos);
      s_r = s_r + rv;
      s_rr = s_rr + rv * rv;
      s_s = s_s + sv;
      s_ss = s_ss + sv * sv;
      s_rs = s_rs + rv * sv;
    }
  }
  const float inv = (float)(1.0 / (double)S);
  const float mr = s_r * inv;
  const float ms = s_s * inv;
  const float var_r = __fmaf_rn(s_rr, inv, -(mr * mr));
  const float var_s = __fmaf_rn(s_ss, inv, -(ms * ms));
  const float cov = __fmaf_rn(s_rs, inv, -(mr * ms));
  const float prod = var_r * var_s;
  const float denom = isnan(prod) ? prod : fmaxf(prod, 1e-30f);
  const float raw = 1.0f - cov * (1.0f / sqrtf(denom));
  float cost = isnan(raw) ? raw : fminf(fmaxf(raw, 0.0f), COST_MAX);
  if (var_r < MIN_VAR || var_s < MIN_VAR) cost = COST_MAX;

  // analytic out-of-source-bounds test of the centre warp (APD.cu:546-556)
  const float dirx = (xs - cx) / fx;
  const float diry = (ys - cy) / fy;
  const float u_c = -((n0 * dirx + n1 * diry) + n2) / w;
  const float* M = consts + 6;
  const float qx = (__ldg(M + 0) * dirx + __ldg(M + 1) * diry + __ldg(M + 2)) + __ldg(consts + 15) * u_c;
  const float qy = (__ldg(M + 3) * dirx + __ldg(M + 4) * diry + __ldg(M + 5)) + __ldg(consts + 16) * u_c;
  const float qz = (__ldg(M + 6) * dirx + __ldg(M + 7) * diry + __ldg(M + 8)) + __ldg(consts + 17) * u_c;
  const float wx = qx / qz, wy = qy / qz;
  const float src_w = __ldg(consts + 18), src_h = __ldg(consts + 19);
  if (wx < 0.0f || wx >= src_w || wy < 0.0f || wy >= src_h) cost = COST_MAX;
  out[i] = cost;
}

extern "C" int ncc_cost_launch(const void* E, const float* ref, const float* planes,
                               const float* consts, int C, int H, int W, int K, int radius,
                               int increment, const void* R, const float* bfm, int j2,
                               float* out, void* stream) {
  const long long total = (long long)C * H * W;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  ncc_cost_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(E), ref, planes, consts, C, H, W, K, radius, increment,
      static_cast<const __nv_bfloat16*>(R), bfm, j2, out);
  return (int)cudaGetLastError();
}
