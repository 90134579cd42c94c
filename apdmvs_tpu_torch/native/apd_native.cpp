// Native host-side runtime for apdmvs_tpu_torch.
//
// The reference's host pipeline is C++ (APD.cpp); the port keeps the
// compute path in PyTorch/CUDA and implements the host-side hot loops here:
//
//  - fuse_eth_native: ETH depth-map fusion (reference RunFusion,
//    APD.cpp:826-977) with the reference's EXACT sequential raster-order
//    greedy source-pixel marking (APD.cpp:955-959), which the vectorized
//    NumPy fallback (fusion.py) can only approximate. The sources' tests
//    run on several threads; the marking stays sequential.
//  - fuse_tat_native: the k-escalating-threshold Tanks&Temples variants
//    (RunFusion_TAT_Intermediate / _advanced, APD.cpp:979-1296).
//
// Built as a plain shared library (no pybind11 in this image); bound via
// ctypes from apdmvs_tpu_torch/native/__init__.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <system_error>
#include <thread>
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

// One consistent source of a reference pixel: the source pixel as an index
// into the stacked views (j * H * W + pixel) and exp(-(err + 200 rel +
// 10 ang)), its term of the ETH score.
struct Cand {
  double term;
  long long src;
};

// A reference pixel that may pass the ETH test; its candidates follow the
// previous pixel's in RowBlock::cands, in source order.
struct PixelCands {
  double X[3];
  long long pix;
  int n;
};

// The candidate phase's output for kRowsPerBlock rows of one view, on a
// cache line of its own: threads filling neighbouring blocks would
// otherwise share the lines their vectors' ends are written to.
struct alignas(64) RowBlock {
  std::vector<PixelCands> pixels;
  std::vector<Cand> cands;
  long long found = 0;  // consistent sources, of kept and dropped pixels
  bool ready = false;   // evaluated; guarded by the view's mutex
};

constexpr int kRowsPerBlock = 4;

}  // namespace

extern "C" {

// ETH fusion (reference RunFusion: APD.cpp:826-977). Returns the number of
// points written (<= max_points). All views share one resolution [H, W].
// weak/state semantics: WEAK=0 (main.h:69-73). block: nullptr or [n,H,W]
// with >=128 meaning inside the ROI. src lists: src_ids[i*max_src + j],
// j < src_counts[i], values = view indices.
//
// Each reference view runs in two phases. The candidate phase evaluates
// every pixel's sources on `threads` threads, a row block at a time; it
// reads no consumed mask but the view's own as it stood when the view
// began (masks only go from 0 to 1). It keeps a pixel only if some term
// exceeds the pixel's factor: otherwise no set of surviving sources can
// pass the test, so the pixel neither emits nor marks. The commit walks
// the blocks in raster order on the calling thread, each as soon as it is
// evaluated, and replays the sequential loop on the kept candidates
// against the live masks, so the points, their order and their bytes are
// those of the one-thread loop. stats (nullptr or [3]): the threads used,
// the consistent candidates found, and those of kept pixels that the
// commit dropped because an earlier point had consumed the source pixel.
long long fuse_eth_native(
    int num_views, int H, int W, const double *Ks, const double *Rs,
    const double *ts, const float *depths, const float *normals,
    const unsigned char *weaks, const unsigned char *bgrs,
    const unsigned char *blocks, const int *src_ids, const int *src_counts,
    int max_src, float weak_factor, float strong_factor, float *out_xyz,
    unsigned char *out_bgr, long long max_points, int threads,
    long long *stats) {
  std::vector<Cam> cams(num_views);
  for (int v = 0; v < num_views; ++v) {
    cams[v].K = Ks + 9 * v;
    cams[v].R = Rs + 9 * v;
    cams[v].t = ts + 3 * v;
    world_center(cams[v]);
  }
  const long long npix = (long long)H * W;
  std::vector<unsigned char> masks((size_t)num_views * npix, 0);
  std::vector<unsigned char> start_mask(npix);
  const int nblocks = (H + kRowsPerBlock - 1) / kRowsPerBlock;
  if (threads > nblocks) threads = nblocks;
  if (threads < 1) threads = 1;
  std::vector<RowBlock> blk(nblocks);

  long long count = 0, candidates = 0, consumed = 0;
  std::vector<long long> used(max_src);

  for (int i = 0; i < num_views; ++i) {
    const float *depth_i = depths + i * npix;
    const float *normal_i = normals + i * npix * 3;
    const unsigned char *weak_i = weaks ? weaks + i * npix : nullptr;
    const unsigned char *block_i = blocks ? blocks + i * npix : nullptr;
    unsigned char *mask_i = masks.data() + (size_t)i * npix;
    const int ns = src_counts[i];
    const int *src_i = src_ids + (long long)i * max_src;
    std::memcpy(start_mask.data(), mask_i, npix);
    auto factor_of = [&](long long pix) {
      return (weak_i && weak_i[pix] == 0 /*WEAK*/) ? weak_factor : strong_factor;
    };

    // candidate phase: every test of the sequential loop but the sources'
    // consumed masks, for the rows of block b
    auto evaluate = [&](int b) {
      RowBlock &out = blk[b];
      std::vector<double> errs(ns), rels(ns);
      std::vector<long long> srcs(ns);
      out.pixels.clear();
      out.cands.clear();
      out.found = 0;
      const int r1 = std::min(H, (b + 1) * kRowsPerBlock);
      for (int r = b * kRowsPerBlock; r < r1; ++r) {
        for (int cidx = 0; cidx < W; ++cidx) {
          const long long pix = (long long)r * W + cidx;
          const float d = depth_i[pix];
          if (d <= 0.0f || start_mask[pix]) continue;
          if (block_i && block_i[pix] < 128) continue;

          PixelCands pc;
          pc.pix = pix;
          backproject(cams[i], (double)cidx, (double)r, (double)d, pc.X);
          // Every test but the angle's for each source, without branches,
          // compacting the sources that pass to the front; then GetAngle
          // and the term for those. A dot below cos(0.174533) fails the
          // angle test without the acos (acos decreases; the bound sits
          // 1e-9 below, far above the rounding of the dot and of acos).
          const size_t first = out.cands.size();
          int m = 0;
          for (int jj = 0; jj < ns; ++jj) {
            const int j = src_i[jj];
            double px, py, pd;
            project(cams[j], pc.X, px, py, pd);
            // trunc(x + 0.5) source pixel (APD.cpp:925-926)
            const long long sc = (long long)(px + 0.5);
            const long long sr = (long long)(py + 0.5);
            const bool inside = sc >= 0 && sc < W && sr >= 0 && sr < H;
            const long long src = (long long)j * npix + (inside ? sr * W + sc : 0);
            const float sd = depths[src];

            double X2[3];
            backproject(cams[j], (double)sc, (double)sr, (double)sd, X2);
            double bx, by, bd;
            project(cams[i], X2, bx, by, bd);
            const double err = std::sqrt((cidx - bx) * (cidx - bx) +
                                         (r - by) * (r - by));
            const double rel = std::fabs(bd - d) / d;
            const float *n1 = normal_i + pix * 3;
            const float *n2 = normals + src * 3;
            const double dot = (double)n1[0] * n2[0] + (double)n1[1] * n2[1] +
                               (double)n1[2] * n2[2];
            errs[m] = err;
            rels[m] = rel;
            srcs[m] = src;
            // thresholds: 2 px, 1 %, 10 deg (APD.cpp:941-948)
            m += inside & (sd > 0.0f) & (err < 2.0) & (rel < 0.01) &
                 (dot >= 0.984807739);
          }
          double best = 0.0;
          for (int u = 0; u < m; ++u) {
            const double ang = angle_between(normal_i + pix * 3, normals + srcs[u] * 3);
            if (ang < 0.174533) {
              const double term = std::exp(-(errs[u] + 200.0 * rels[u] + 10.0 * ang));
              out.cands.push_back({term, srcs[u]});
              best = std::max(best, term);
            }
          }
          pc.n = (int)(out.cands.size() - first);
          out.found += pc.n;
          // The test sums at most ns terms, each <= best, against
          // factor * count rounded to float: below a factor shrunk by 2^-20
          // no rounding lets any subset pass.
          if (best > factor_of(pix) * (1.0 - 0x1p-20)) {
            out.pixels.push_back(pc);
          } else {
            out.cands.resize(first);
          }
        }
      }
    };

    // commit: the sequential loop's decision over block b's kept pixels, in
    // raster order and source order, against the live masks. The sum stays
    // a scalar loop in source order, so it rounds as the sequential one.
    auto commit = [&](int b) {
      const RowBlock &in = blk[b];
      candidates += in.found;
      const Cand *cand = in.cands.data();
      for (const PixelCands &pc : in.pixels) {
        const Cand *c = cand;
        cand += pc.n;
        const long long pix = pc.pix;
        if (mask_i[pix]) {  // consumed by this view as its own source
          consumed += pc.n;
          continue;
        }
        int num_consistent = 0;
        double dyn = 0.0;
        for (int u = 0; u < pc.n; ++u) {
          if (masks[c[u].src]) {
            ++consumed;
            continue;
          }
          dyn += c[u].term;
          used[num_consistent++] = c[u].src;
        }
        if (num_consistent >= 1 && dyn > factor_of(pix) * num_consistent) {
          if (count < max_points) {
            // reference emits the reference point's coordinates and averages
            // colors over {ref} + consistent sources (APD.cpp:952-967)
            double sum_b = bgrs[(i * npix + pix) * 3 + 0];
            double sum_g = bgrs[(i * npix + pix) * 3 + 1];
            double sum_r2 = bgrs[(i * npix + pix) * 3 + 2];
            for (int u = 0; u < num_consistent; ++u) {
              sum_b += bgrs[used[u] * 3 + 0];
              sum_g += bgrs[used[u] * 3 + 1];
              sum_r2 += bgrs[used[u] * 3 + 2];
            }
            const double inv = 1.0 / (num_consistent + 1.0);
            out_xyz[count * 3 + 0] = (float)pc.X[0];
            out_xyz[count * 3 + 1] = (float)pc.X[1];
            out_xyz[count * 3 + 2] = (float)pc.X[2];
            out_bgr[count * 3 + 0] = (unsigned char)(sum_b * inv);
            out_bgr[count * 3 + 1] = (unsigned char)(sum_g * inv);
            out_bgr[count * 3 + 2] = (unsigned char)(sum_r2 * inv);
          }
          ++count;
          // greedy: mark consumed source pixels (APD.cpp:955-959)
          for (int u = 0; u < num_consistent; ++u) masks[used[u]] = 1;
        }
      }
    };

    // Blocks are handed out in raster order. The workers evaluate; the
    // calling thread commits each block once it is evaluated, and evaluates
    // blocks itself while the next one to commit is still in flight.
    std::atomic<int> next{0};
    std::mutex mu;
    std::condition_variable evaluated;
    for (RowBlock &b : blk) b.ready = false;
    auto work = [&]() {
      for (int b; (b = next.fetch_add(1)) < nblocks;) {
        evaluate(b);
        {
          std::lock_guard<std::mutex> lk(mu);
          blk[b].ready = true;
        }
        evaluated.notify_one();
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; ++t) {
      try {
        pool.emplace_back(work);
      } catch (const std::system_error &) {
        break;  // fewer threads: the calling thread evaluates the rest
      }
    }
    for (int b = 0; b < nblocks; ++b) {
      std::unique_lock<std::mutex> lk(mu);
      while (!blk[b].ready) {
        const int c = next.fetch_add(1);
        if (c < nblocks) {
          lk.unlock();
          evaluate(c);
          lk.lock();
          blk[c].ready = true;
        } else {
          evaluated.wait(lk, [&] { return blk[b].ready; });
        }
      }
      lk.unlock();
      commit(b);
    }
    for (std::thread &t : pool) t.join();
  }
  if (stats) {
    stats[0] = threads;
    stats[1] = candidates;
    stats[2] = consumed;
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
