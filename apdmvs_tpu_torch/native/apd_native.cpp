// Native host-side runtime for apdmvs_tpu_torch.
//
// The reference's host pipeline is C++ (APD.cpp); the port keeps the
// compute path in PyTorch/CUDA and implements the host-side hot loops here:
//
//  - fuse_eth_native: ETH depth-map fusion (reference RunFusion,
//    APD.cpp:826-977) with the reference's EXACT sequential raster-order
//    greedy source-pixel marking (APD.cpp:955-959), which the vectorized
//    NumPy fallback (fusion.py) can only approximate.
//  - fuse_tat_native: the k-escalating-threshold Tanks&Temples variants
//    (RunFusion_TAT_Intermediate / _advanced, APD.cpp:979-1296).
//
// Built as a plain shared library (no pybind11 in this image); bound via
// ctypes from apdmvs_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cam {
  const double *K;  // [9]
  const double *R;  // [9]
  const double *t;  // [3]
  double c[3];      // world center -R^T t
};

inline void world_center(Cam &cam) {
  for (int i = 0; i < 3; ++i) {
    cam.c[i] = -(cam.R[0 * 3 + i] * cam.t[0] + cam.R[1 * 3 + i] * cam.t[1] +
                 cam.R[2 * 3 + i] * cam.t[2]);
  }
}

// Get3DPointonWorld (APD.cpp:776-800)
inline void backproject(const Cam &cam, double x, double y, double depth,
                        double out[3]) {
  const double *K = cam.K;
  double px = depth * (x - K[2]) / K[0];
  double py = depth * (y - K[5]) / K[4];
  double p[3] = {px, py, depth};
  for (int i = 0; i < 3; ++i) {
    out[i] = cam.R[0 * 3 + i] * p[0] + cam.R[1 * 3 + i] * p[1] +
             cam.R[2 * 3 + i] * p[2] + cam.c[i];
  }
}

// ProjectCamera (APD.cpp:802-812)
inline void project(const Cam &cam, const double X[3], double &px, double &py,
                    double &depth) {
  double xc[3];
  for (int i = 0; i < 3; ++i) {
    xc[i] = cam.R[i * 3 + 0] * X[0] + cam.R[i * 3 + 1] * X[1] +
            cam.R[i * 3 + 2] * X[2] + cam.t[i];
  }
  const double *K = cam.K;
  depth = K[6] * xc[0] + K[7] * xc[1] + K[8] * xc[2];
  px = (K[0] * xc[0] + K[1] * xc[1] + K[2] * xc[2]) / depth;
  py = (K[3] * xc[0] + K[4] * xc[1] + K[5] * xc[2]) / depth;
}

// GetAngle (APD.cpp:814-823)
inline double angle_between(const float *n1, const float *n2) {
  double dot = (double)n1[0] * n2[0] + (double)n1[1] * n2[1] +
               (double)n1[2] * n2[2];
  if (dot > 1.0) dot = 1.0;
  if (dot < -1.0) dot = -1.0;
  double a = std::acos(dot);
  return std::isnan(a) ? 0.0 : a;
}

}  // namespace

extern "C" {

// ETH fusion (reference RunFusion: APD.cpp:826-977). Returns the number of
// points written (<= max_points). All views share one resolution [H, W].
// weak/state semantics: WEAK=0 (main.h:69-73). block: nullptr or [n,H,W]
// with >=128 meaning inside the ROI. src lists: src_ids[i*max_src + j],
// j < src_counts[i], values = view indices.
long long fuse_eth_native(
    int num_views, int H, int W, const double *Ks, const double *Rs,
    const double *ts, const float *depths, const float *normals,
    const unsigned char *weaks, const unsigned char *bgrs,
    const unsigned char *blocks, const int *src_ids, const int *src_counts,
    int max_src, float weak_factor, float strong_factor, float *out_xyz,
    unsigned char *out_bgr, long long max_points) {
  std::vector<Cam> cams(num_views);
  for (int v = 0; v < num_views; ++v) {
    cams[v].K = Ks + 9 * v;
    cams[v].R = Rs + 9 * v;
    cams[v].t = ts + 3 * v;
    world_center(cams[v]);
  }
  const long long npix = (long long)H * W;
  std::vector<unsigned char> masks((size_t)num_views * npix, 0);

  long long count = 0;
  std::vector<int> used_list(max_src);
  std::vector<long long> used_pix(max_src);

  for (int i = 0; i < num_views; ++i) {
    const float *depth_i = depths + i * npix;
    const float *normal_i = normals + i * npix * 3;
    const unsigned char *weak_i = weaks ? weaks + i * npix : nullptr;
    const unsigned char *block_i = blocks ? blocks + i * npix : nullptr;
    unsigned char *mask_i = masks.data() + (size_t)i * npix;
    const int ns = src_counts[i];

    for (int r = 0; r < H; ++r) {
      for (int cidx = 0; cidx < W; ++cidx) {
        const long long pix = (long long)r * W + cidx;
        const float d = depth_i[pix];
        if (d <= 0.0f || mask_i[pix]) continue;
        if (block_i && block_i[pix] < 128) continue;

        double X[3];
        backproject(cams[i], (double)cidx, (double)r, (double)d, X);

        int num_consistent = 0;
        double dyn = 0.0;
        double sum_b = bgrs[(i * npix + pix) * 3 + 0];
        double sum_g = bgrs[(i * npix + pix) * 3 + 1];
        double sum_r2 = bgrs[(i * npix + pix) * 3 + 2];
        int used_n = 0;

        for (int jj = 0; jj < ns; ++jj) {
          const int j = src_ids[(long long)i * max_src + jj];
          const float *depth_j = depths + (long long)j * npix;
          double px, py, pd;
          project(cams[j], X, px, py, pd);
          // trunc(x + 0.5) source pixel (APD.cpp:925-926)
          const long long sc = (long long)(px + 0.5);
          const long long sr = (long long)(py + 0.5);
          if (sc < 0 || sc >= W || sr < 0 || sr >= H) continue;
          const long long spix = sr * W + sc;
          if (masks[(size_t)j * npix + spix]) continue;
          const float sd = depth_j[spix];
          if (sd <= 0.0f) continue;

          double X2[3];
          backproject(cams[j], (double)sc, (double)sr, (double)sd, X2);
          double bx, by, bd;
          project(cams[i], X2, bx, by, bd);
          const double err = std::sqrt((cidx - bx) * (cidx - bx) +
                                       (r - by) * (r - by));
          const double rel = std::fabs(bd - d) / d;
          const double ang = angle_between(
              normal_i + pix * 3, normals + ((long long)j * npix + spix) * 3);
          // thresholds: 2 px, 1 %, 10 deg (APD.cpp:941-948)
          if (err < 2.0 && rel < 0.01 && ang < 0.174533) {
            dyn += std::exp(-(err + 200.0 * rel + 10.0 * ang));
            ++num_consistent;
            used_list[used_n] = j;
            used_pix[used_n] = spix;
            ++used_n;
            sum_b += bgrs[((long long)j * npix + spix) * 3 + 0];
            sum_g += bgrs[((long long)j * npix + spix) * 3 + 1];
            sum_r2 += bgrs[((long long)j * npix + spix) * 3 + 2];
          }
        }

        const float factor = (weak_i && weak_i[pix] == 0 /*WEAK*/)
                                 ? weak_factor
                                 : strong_factor;
        if (num_consistent >= 1 && dyn > factor * num_consistent) {
          if (count < max_points) {
            // reference emits the reference point's coordinates and averages
            // colors over {ref} + consistent sources (APD.cpp:952-967)
            const double inv = 1.0 / (num_consistent + 1.0);
            out_xyz[count * 3 + 0] = (float)X[0];
            out_xyz[count * 3 + 1] = (float)X[1];
            out_xyz[count * 3 + 2] = (float)X[2];
            out_bgr[count * 3 + 0] = (unsigned char)(sum_b * inv);
            out_bgr[count * 3 + 1] = (unsigned char)(sum_g * inv);
            out_bgr[count * 3 + 2] = (unsigned char)(sum_r2 * inv);
          }
          ++count;
          // greedy: mark consumed source pixels (APD.cpp:955-959)
          for (int u = 0; u < used_n; ++u) {
            masks[(size_t)used_list[u] * npix + used_pix[u]] = 1;
          }
        }
      }
    }
  }
  return count;
}

// Tanks&Temples fusion variants (APD.cpp:979-1296). advanced=0 ->
// intermediate (angle check, depth base 1/3500, color averaging);
// advanced=1 -> no angle check, depth base 1/3000, ref color only.
long long fuse_tat_native(
    int num_views, int H, int W, const double *Ks, const double *Rs,
    const double *ts, const float *depths, const float *normals,
    const unsigned char *bgrs, const unsigned char *blocks,
    const int *src_ids, const int *src_counts, int max_src, int advanced,
    float *out_xyz, unsigned char *out_bgr, long long max_points) {
  std::vector<Cam> cams(num_views);
  for (int v = 0; v < num_views; ++v) {
    cams[v].K = Ks + 9 * v;
    cams[v].R = Rs + 9 * v;
    cams[v].t = ts + 3 * v;
    world_center(cams[v]);
  }
  const long long npix = (long long)H * W;
  std::vector<unsigned char> masks((size_t)num_views * npix, 0);
  const double dist_base = 0.25;
  const double depth_base = advanced ? (1.0 / 3000.0) : (1.0 / 3500.0);
  const double angle_base = 0.06981317007977318;  // 4 deg
  const double angle_grad = 0.05235987755982988;  // 3 deg

  long long count = 0;
  std::vector<double> errs(max_src), rels(max_src), angs(max_src);
  std::vector<long long> spixs(max_src);
  std::vector<int> sview(max_src);
  std::vector<double> X2s((size_t)max_src * 3);

  for (int i = 0; i < num_views; ++i) {
    const float *depth_i = depths + (long long)i * npix;
    const float *normal_i = normals + (long long)i * npix * 3;
    const unsigned char *block_i = blocks ? blocks + (long long)i * npix : nullptr;
    const int ns = src_counts[i];

    for (int r = 0; r < H; ++r) {
      for (int cidx = 0; cidx < W; ++cidx) {
        const long long pix = (long long)r * W + cidx;
        const float d = depth_i[pix];
        if (d <= 0.0f || masks[(size_t)i * npix + pix]) continue;
        if (block_i && block_i[pix] < 128) continue;

        double X[3];
        backproject(cams[i], (double)cidx, (double)r, (double)d, X);

        int m = 0;
        for (int jj = 0; jj < ns; ++jj) {
          const int j = src_ids[(long long)i * max_src + jj];
          double px, py, pd;
          project(cams[j], X, px, py, pd);
          const long long sc = (long long)(px + 0.5);
          const long long sr = (long long)(py + 0.5);
          if (sc < 0 || sc >= W || sr < 0 || sr >= H) continue;
          const long long spix = sr * W + sc;
          if (masks[(size_t)j * npix + spix]) continue;
          const float sd = depths[(long long)j * npix + spix];
          if (sd <= 0.0f) continue;
          double X2[3];
          backproject(cams[j], (double)sc, (double)sr, (double)sd, X2);
          double bx, by, bd;
          project(cams[i], X2, bx, by, bd);
          errs[m] = std::sqrt((cidx - bx) * (cidx - bx) + (r - by) * (r - by));
          rels[m] = std::fabs(bd - d) / d;
          angs[m] = angle_between(normal_i + pix * 3,
                                  normals + ((long long)j * npix + spix) * 3);
          spixs[m] = spix;
          sview[m] = j;
          std::memcpy(&X2s[(size_t)m * 3], X2, sizeof(X2));
          ++m;
        }

        // escalate k until count >= k (APD.cpp:1080-1136)
        for (int k = 2; k <= ns; ++k) {
          int cnt = 0;
          double sb = bgrs[((long long)i * npix + pix) * 3 + 0];
          double sg = bgrs[((long long)i * npix + pix) * 3 + 1];
          double sr2 = bgrs[((long long)i * npix + pix) * 3 + 2];
          for (int u = 0; u < m; ++u) {
            bool ok = errs[u] < k * dist_base && rels[u] < k * depth_base;
            if (!advanced) ok = ok && angs[u] < (k * angle_grad + angle_base);
            if (ok) {
              ++cnt;
              sb += bgrs[((long long)sview[u] * npix + spixs[u]) * 3 + 0];
              sg += bgrs[((long long)sview[u] * npix + spixs[u]) * 3 + 1];
              sr2 += bgrs[((long long)sview[u] * npix + spixs[u]) * 3 + 2];
            }
          }
          if (cnt >= k) {
            if (count < max_points) {
              const double inv = 1.0 / (cnt + 1.0);
              out_xyz[count * 3 + 0] = (float)X[0];
              out_xyz[count * 3 + 1] = (float)X[1];
              out_xyz[count * 3 + 2] = (float)X[2];
              if (advanced) {
                out_bgr[count * 3 + 0] =
                    bgrs[((long long)i * npix + pix) * 3 + 0];
                out_bgr[count * 3 + 1] =
                    bgrs[((long long)i * npix + pix) * 3 + 1];
                out_bgr[count * 3 + 2] =
                    bgrs[((long long)i * npix + pix) * 3 + 2];
              } else {
                out_bgr[count * 3 + 0] = (unsigned char)(sb * inv);
                out_bgr[count * 3 + 1] = (unsigned char)(sg * inv);
                out_bgr[count * 3 + 2] = (unsigned char)(sr2 * inv);
              }
            }
            ++count;
            masks[(size_t)i * npix + pix] = 1;  // TAT marks the ref pixel
            break;
          }
        }
      }
    }
  }
  return count;
}

}  // extern "C"
