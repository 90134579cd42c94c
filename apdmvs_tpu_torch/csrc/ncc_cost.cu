// H2 ncc_cost: exact volume NCC cost of C plane fields against every source
// view, for Hopper (sm_90a).
//
// Replaces five TPU kernels of apdmvs_tpu/ops/ncc_volume.py that all compute
// this one function (ncc_volume_cost_view_ref is their common oracle):
//   _kernel + _fixup_kernel  (ncc_volume_cost_view: L1 band + L2 fixup)
//   _kernel_fullk            (ncc_volume_cost_view_fullk)
//   _kernel_rb               (ncc_rebased_cost_view, through a rebased R)
//   _kernel_rb_offs          (ncc_rebased_sweep_cost_view, auto-centred bands)
// The TPU split into bands, sentinels, rebased copies and a fixup pass
// existed because a TPU core has no fast gather; on this card each window
// sample loads its two K-neighbours of E by address, so there is no band, no
// rebase and no second pass. One launch evaluates all NV source views.
//
// Per output (v, c, y, x), over the NS x NS window (radius r, step inc):
//   u   = -(n . dir(x+dx, y+dy)) / w        (inverse depth of the plane)
//   k   = clamp((u - u_min) / du, 0, K-1)
//   sv  = lerp(E_v[floor k], E_v[min(floor k + 1, K-1)], frac k) at (x+dx, y+dy)
//   rv  = ref at (x+dx, y+dy)
// then cost = clamp(1 - cov / sqrt(var_r var_s), 0, 2); cost 2 when either
// variance is < 1e-5 or the centre warp leaves the source image. Every
// product and sum is separately rounded (built with --fmad=false) in the
// plain version's order (ops/ncc_volume.py::ncc_volume_cost_ref), except:
// - the two variances and the covariance: each is one explicit fused
//   multiply-add, as the reference computes them (ncc_volume.py::ncc_moments
//   says why it matters);
// - the slice coordinate. The plane is folded per output into
//   kr = c0 + c1 dirx + c2 diry, c1 = -n0/(w du), c2 = -n1/(w du),
//   c0 = (-(n2/w) - u_min)/du, evaluated as two fused multiply-adds
//   (c2 diry + (c1 dirx + c0)) instead of two divisions. It rounds
//   differently from (u - u_min)/du by a few ulp of k; the sample is
//   continuous in k, so the cost moves by ~1e-5 (the tolerance is 1e-4).
//   Where |c0| + |c1| max|dirx| + |c2| max|diry| is not below 1e30 (w = 0, a
//   NaN or infinite plane, or a sum that could overflow) the output takes
//   the plain version's divisions, NaN included. So a folded kr is finite
//   and needs no NaN test. The padding plane (0, 0, -1, 1) folds exactly.
//
// Bound on this card: by the roofline, f32 operations (~17 a window sample
// of an output; the elements of E the windows touch are a few MB). Measured,
// instruction issue sets the time, and scattered slices (random-depth
// fields) add cache misses. Design, against what the single-view,
// thread-per-output kernel spent (~90 instructions a sample):
// - a block owns a 32 x 4 tile of outputs and stages the reference window
//   (tile plus its +-r halo) in shared memory once; a thread owns one pixel
//   and loops over the views and fields, so its sums s_r, s_rr are computed
//   once per pixel (in the plain version's order) and serve NV x C outputs;
// - the direction tables, dirx per tile column in shared memory and diry per
//   thread row in registers, are computed once per view with the plain
//   version's expression, so they are exact; a sample's slice coordinate is
//   then two FMAs (one of them per column);
// - addresses are 32-bit unsigned offsets from one 64-bit view base (the
//   wrapper checks K PH PW < 2^31): one IMAD and one IMAD.WIDE a load;
// - the dx loop is unrolled by 2 and the dy loop fully, and the division
//   fallback is a separate, rolled function: the fully unrolled window (~5000
//   instructions with its fallback) ran from the instruction cache's misses
//   at 255 registers; __launch_bounds__(128, 4) keeps 16 warps an SM, which
//   was fastest at C = 9 without losing the random-depth case;
// - x fastest in a warp, so a warp's loads of one slice row coalesce; the E
//   window a block touches (a few slices around the fields' depths, +-r px)
//   stays in L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAD_Y 8
#define PAD_X 128
#define COST_MAX 2.0f
#define MIN_VAR 1e-5f
#define NCONST 21
#define BLOCK_X 32
#define BLOCK_Y 4
#define MIN_BLOCKS 4
#define FOLD_LIMIT 1e30f

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Window sums of one output from the folded plane: kr = c2 diry + (c1 dirx +
// c0). Offsets are unsigned 32-bit from the view base Ev.
template <int NS>
__device__ __forceinline__ void window_sums_folded(const __nv_bfloat16* __restrict__ Ev,
                                                   unsigned plane, int K, unsigned base,
                                                   int radius, int inc, const int (&rowoff)[NS],
                                                   const float* dirx_t, const float (&diry)[NS],
                                                   const float* ref_t, int TW, float c0,
                                                   float c1, float c2, float& s_s, float& s_ss,
                                                   float& s_rs) {
  const float kmax = (float)(K - 1);
#pragma unroll 2
  for (int i = 0; i < NS; ++i) {
    const float t = __fmaf_rn(c1, dirx_t[i * inc], c0);
    const unsigned pos_i = base + (unsigned)(i * inc - radius);
    const float* ri = ref_t + i * inc;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float kr = __fmaf_rn(c2, diry[j], t);
      const float k = fminf(fmaxf(kr, 0.0f), kmax);
      const float k0f = floorf(k);
      const int k0 = (int)k0f;
      const int k1 = min(k0 + 1, K - 1);
      const float f = k - k0f;
      const unsigned pos = pos_i + (unsigned)rowoff[j];
      const float e0 = ldbf(Ev + ((unsigned)k0 * plane + pos));
      const float e1 = ldbf(Ev + ((unsigned)k1 * plane + pos));
      const float sv = e0 * (1.0f - f) + e1 * f;
      s_s = s_s + sv;
      s_ss = s_ss + sv * sv;
      s_rs = s_rs + ri[j * inc * TW] * sv;
    }
  }
}

// The same sums with the plain version's divisions and NaN handling, for
// planes the fold cannot take. Rolled, out of line: it runs for a few
// outputs at most.
__device__ __noinline__ void window_sums_exact(const __nv_bfloat16* __restrict__ Ev,
                                               unsigned plane, int K, unsigned base, int PW,
                                               int radius, int inc, int ns,
                                               const float* dirx_t, float ys, float cy,
                                               float fy, const float* ref_t, int TW, float n0,
                                               float n1, float n2, float w, float u_min,
                                               float du, float& s_s, float& s_ss,
                                               float& s_rs) {
  const float kmax = (float)(K - 1);
#pragma unroll 1
  for (int i = 0; i < ns; ++i) {
#pragma unroll 1
    for (int j = 0; j < ns; ++j) {
      const float diry = ((ys + (float)(j * inc - radius)) - cy) / fy;
      const float u = -((n0 * dirx_t[i * inc] + n1 * diry) + n2) / w;
      const float kr = (u - u_min) / du;
      const float k = isnan(kr) ? kr : fminf(fmaxf(kr, 0.0f), kmax);
      const float k0f = floorf(k);
      const int k0 = isnan(k0f) ? 0 : (int)k0f;
      const int k1 = min(k0 + 1, K - 1);
      const float f = k - (float)k0;
      const unsigned pos = base + (unsigned)((j * inc - radius) * PW + (i * inc - radius));
      const float e0 = ldbf(Ev + ((unsigned)k0 * plane + pos));
      const float e1 = ldbf(Ev + ((unsigned)k1 * plane + pos));
      const float sv = e0 * (1.0f - f) + e1 * f;
      s_s = s_s + sv;
      s_ss = s_ss + sv * sv;
      s_rs = s_rs + ref_t[j * inc * TW + i * inc] * sv;
    }
  }
}

// The grid covers H x W exactly (multiples of BLOCK_Y and BLOCK_X), so
// every thread reaches the barriers.
template <int NS>
__global__ void __launch_bounds__(BLOCK_X* BLOCK_Y, MIN_BLOCKS)
    ncc_cost_kernel(const __nv_bfloat16* __restrict__ E, const float* __restrict__ ref,
                    const float* __restrict__ planes, const float* __restrict__ consts, int NV,
                    int C, int H, int W, int K, int radius, int inc, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int span = (NS - 1) * inc;
  const int TW = BLOCK_X + span, TH = BLOCK_Y + span;
  float* ref_tile = smem;             // [TH][TW]: the reference window of the tile
  float* dirx_tile = smem + TH * TW;  // [TW]: dirx of the tile's columns, per view
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BLOCK_X + tx;
  const int x = blockIdx.x * BLOCK_X + tx;
  const int y = blockIdx.y * BLOCK_Y + ty;
  const int PW = W + 2 * PAD_X;
  const unsigned plane = (unsigned)((H + 2 * PAD_Y) * PW);
  const unsigned base = (unsigned)((PAD_Y + y) * PW + (PAD_X + x));
  const int HW = H * W;
  const int xt = blockIdx.x * BLOCK_X - radius, yt = blockIdx.y * BLOCK_Y - radius;
  for (int t = tid; t < TH * TW; t += BLOCK_X * BLOCK_Y) {
    const int r = t / TW, col = t - r * TW;
    ref_tile[t] = __ldg(ref + (PAD_Y + yt + r) * PW + (PAD_X + xt + col));
  }
  __syncthreads();

  // the reference sums, in the plain version's order (dx outer, dy inner),
  // once per pixel for all views and fields
  const float* ref_t = ref_tile + ty * TW + tx;
  float s_r = 0.f, s_rr = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float r = ref_t[j * inc * TW + i * inc];
      s_r = s_r + r;
      s_rr = s_rr + r * r;
    }
  }
  const float inv = (float)(1.0 / (double)(NS * NS));
  const float mr = s_r * inv;
  const float var_r = __fmaf_rn(s_rr, inv, -(mr * mr));
  const float xs = (float)x;
  int rowoff[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) rowoff[j] = (j * inc - radius) * PW;

  for (int v = 0; v < NV; ++v) {
    const float* cv = consts + v * NCONST;
    const float fx = __ldg(cv + 0), fy = __ldg(cv + 1);
    const float cx = __ldg(cv + 2), cy = __ldg(cv + 3);
    const float u_min = __ldg(cv + 4), du = __ldg(cv + 5);
    const float src_w = __ldg(cv + 18), src_h = __ldg(cv + 19), row0 = __ldg(cv + 20);
    __syncthreads();  // the previous view's dirx table is no longer read
    // column xt + t is x + dx of some sample, and (float)x + dx is exact
    for (int t = tid; t < TW; t += BLOCK_X * BLOCK_Y) {
      dirx_tile[t] = ((float)(xt + t) - cx) / fx;
    }
    __syncthreads();
    const float ys = (float)y + row0;
    float diry[NS];
    float dxmax = 0.0f, dymax = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      diry[j] = ((ys + (float)(j * inc - radius)) - cy) / fy;
      dymax = fmaxf(dymax, fabsf(diry[j]));
      dxmax = fmaxf(dxmax, fabsf(dirx_tile[tx + j * inc]));
    }
    const float dirx_c = (xs - cx) / fx;
    const float diry_c = (ys - cy) / fy;
    const __nv_bfloat16* Ev = E + (size_t)v * K * plane;
    float* out_v = out + (size_t)v * C * HW + y * W + x;

    for (int c = 0; c < C; ++c) {
      const float* pl = planes + (size_t)c * 4 * HW + y * W + x;
      const float n0 = __ldg(pl), n1 = __ldg(pl + HW), n2 = __ldg(pl + 2 * HW),
                  w = __ldg(pl + 3 * HW);
      const float wdu = w * du;
      const float c1 = -n0 / wdu;
      const float c2 = -n1 / wdu;
      const float c0 = (-(n2 / w) - u_min) / du;
      float s_s = 0.f, s_ss = 0.f, s_rs = 0.f;
      // false for NaN, and where a partial sum of kr could overflow
      if (fabsf(c0) + fabsf(c1) * dxmax + fabsf(c2) * dymax < FOLD_LIMIT) {
        window_sums_folded<NS>(Ev, plane, K, base, radius, inc, rowoff, dirx_tile + tx, diry,
                               ref_t, TW, c0, c1, c2, s_s, s_ss, s_rs);
      } else {
        window_sums_exact(Ev, plane, K, base, PW, radius, inc, NS, dirx_tile + tx, ys, cy, fy,
                          ref_t, TW, n0, n1, n2, w, u_min, du, s_s, s_ss, s_rs);
      }
      const float ms = s_s * inv;
      const float var_s = __fmaf_rn(s_ss, inv, -(ms * ms));
      const float cov = __fmaf_rn(s_rs, inv, -(mr * ms));
      const float prod = var_r * var_s;
      const float denom = isnan(prod) ? prod : fmaxf(prod, 1e-30f);
      const float raw = 1.0f - cov * (1.0f / sqrtf(denom));
      float cost = isnan(raw) ? raw : fminf(fmaxf(raw, 0.0f), COST_MAX);
      if (var_r < MIN_VAR || var_s < MIN_VAR) cost = COST_MAX;

      // analytic out-of-source-bounds test of the centre warp (APD.cu:546-556)
      const float u_c = -((n0 * dirx_c + n1 * diry_c) + n2) / w;
      const float* M = cv + 6;
      const float qx = (__ldg(M + 0) * dirx_c + __ldg(M + 1) * diry_c + __ldg(M + 2)) + __ldg(cv + 15) * u_c;
      const float qy = (__ldg(M + 3) * dirx_c + __ldg(M + 4) * diry_c + __ldg(M + 5)) + __ldg(cv + 16) * u_c;
      const float qz = (__ldg(M + 6) * dirx_c + __ldg(M + 7) * diry_c + __ldg(M + 8)) + __ldg(cv + 17) * u_c;
      const float wx = qx / qz, wy = qy / qz;
      if (wx < 0.0f || wx >= src_w || wy < 0.0f || wy >= src_h) cost = COST_MAX;
      out_v[c * HW] = cost;
    }
  }
}

#define NCC_CASE(N)                                                                       \
  case N:                                                                                 \
    ncc_cost_kernel<N><<<grid, block, smem, s>>>(static_cast<const __nv_bfloat16*>(E), ref, \
                                                 planes, consts, NV, C, H, W, K, radius,  \
                                                 inc, out);                               \
    break;

// E [NV, K, H+2 PAD_Y, W+2 PAD_X] bf16, ref [H+2 PAD_Y, W+2 PAD_X] f32, planes
// [C, 4, H, W] f32, consts [NV, 21] f32 -> out [NV, C, H, W] f32. H a
// multiple of 4 and W of 32; windows of 1 to 8 samples a side. Returns
// cudaErrorInvalidValue for any other shape or window.
extern "C" int ncc_cost_launch(const void* E, const float* ref, const float* planes,
                               const float* consts, int NV, int C, int H, int W, int K,
                               int radius, int inc, float* out, void* stream) {
  if (H % BLOCK_Y != 0 || W % BLOCK_X != 0 || inc < 1) return (int)cudaErrorInvalidValue;
  const int ns = 2 * radius / inc + 1;
  const int span = (ns - 1) * inc;
  const size_t smem = ((BLOCK_Y + span) * (BLOCK_X + span) + (BLOCK_X + span)) * sizeof(float);
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid(W / BLOCK_X, H / BLOCK_Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    NCC_CASE(1)
    NCC_CASE(2)
    NCC_CASE(3)
    NCC_CASE(4)
    NCC_CASE(5)
    NCC_CASE(6)
    NCC_CASE(7)
    NCC_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
