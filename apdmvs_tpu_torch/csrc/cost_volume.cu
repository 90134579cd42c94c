// H9 cost_volumes: the weak machinery's plane-sweep NCC cost volumes C36
// (6 x 6 window) and C9 (3 x 3 window) of every source view in one launch,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds them as plain array code
// (apdmvs_tpu/ops/cost_volume.py::build_cost_volume), left to XLA. The
// port's plain version (ops/cost_volume.py::build_cost_volume) runs them as
// chunks of strided elementwise PyTorch operations, some 5000 launches and
// ~20 TB of traffic a 1600x1200 set; this kernel is its CUDA form, bit-equal.
// Per output (v, k, y, x) of each window (radius 5, offsets
// vals = -5, -3, -1, 1, 3, 5 for C36 and -5, 0, 5 for C9, n = len(vals)):
//   ax[r][x] = sum_{dx in vals} a[r][x + dx]          (x-sums first)
//   s_a      = sum_{dy in vals} ax[y + dy][x]         (then y-sums)
// for a = e (E[v, k] widened to f32), e*e and ref*e; with the reference's
// own s_r, s_rr (computed once a tile), inv = (float)(1 / n^2):
//   mr = s_r inv, ms = s_e inv
//   var_r = fma(s_rr, inv, -(mr mr)), var_s = fma(s_ee, inv, -(ms ms)),
//   cov = fma(s_re, inv, -(mr ms))
//   cost = clamp(1 - cov rsqrt(max(var_r var_s, 1e-30)), 0, 2),
//   COST_MAX (2) where var_r or var_s < 1e-5, rounded to bf16 (RNE).
// Rows and columns within 5 of the padded edge have zero sums in the plain
// version, so cost COST_MAX; the kernel writes COST_MAX there itself (the
// output may be a lent, unzeroed slot).
//
// Bit-equal to the plain version on the card, by construction:
// - every sum in the plain order (x then y, offsets ascending), each
//   product and sum separately rounded in f32 (--fmad=false). The plain
//   sums start from 0.0f; these start from their first term. That changes
//   a sum only where all its terms are -0 (0 + -0 = +0), and only its sign:
//   s_ee never (its terms are squares), s_e and s_r to -0 then give
//   ms ms = +0 and mr ms = +-0, and s_re or a cov of +-0 gives cost
//   1 - (+-0) r = 1 either way, so no output moves;
// - the moments as ops/ncc_volume.py::fma computes them, in float64: the
//   product of two floats is exact there, then one rounding of the sum to
//   float64 and one to float32 (not a float32 fma, which rounds once);
// - the clamps pass NaN through as torch.clamp does (max.NaN, min.NaN); the
//   reciprocal square root is the approximation torch.rsqrt runs on CUDA
//   floats (ATen's rsqrt_wrapper calls ::rsqrt, rsqrt.approx.f32), here in
//   its .ftz form, which differs only on subnormal inputs: max(prod, 1e-30)
//   is never one; the bf16 rounding is __float2bfloat16_rn, c10::BFloat16's
//   on sm_80 and later.
//
// Bound on this card: bytes by the roofline (E read once, C36 and C9 written
// once: 3 x 2 bytes an output pixel; ~90 f32 operations an output pixel set
// the second bound, below the first). What sets the time is instruction
// issue (~165 instructions an output pixel, a third of them the sums'
// adds) and shared-memory bandwidth for the window taps, at the occupancy
// that shared memory leaves (3 blocks, 12 warps an SM). Design:
// - a block owns 128 output columns x TILE_H output rows of one source view
//   and walks a run of slices; thread c owns column c and every row of the
//   tile, so each staged pixel's x-sums are computed once a block;
// - once a block: the reference tile with its 5-pixel halo goes to shared
//   memory (the .y of a float2 per pixel), and each thread computes its
//   column's reference terms mr, var_r of both windows into shared memory
//   (thread-private: no barrier);
// - per slice: the E tile (TILE_H + 10 rows x 144 columns) arrives by
//   16-byte asynchronous copies (cp.async) while the previous slice is
//   swept, and is widened to f32 into the .x of the float2, so a window
//   tap is one 8-byte load of (e, ref);
// - the sweep walks the staged rows down, fully unrolled: one row's six
//   x-sums (e, e*e, ref*e for both windows, from seven taps -5, -3, -1, 0,
//   1, 3, 5) go into a ring of the last 11 rows in registers (every ring
//   index static), and each finished row of outputs takes its y-sums from
//   the ring: C36 from rows 0, 2, .., 10 of it, C9 from 0, 5, 10. Both
//   windows come from the one staged tile. Unrolled, the loads of the next
//   rows issue ahead of the current row's arithmetic;
// - each warp stores 32 consecutive bf16 of an output row, a block 256
//   bytes a row, in both volumes, streaming (the weak machinery gathers a
//   few columns of them later; E stays in L2 for the neighbouring tiles),
//   through running row pointers and a per-row bit mask of the rows to
//   store and of the interior rows, so a store is one predicated STG.
// The variants measured against this one are listed in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define TW 128        // output columns a block (one a thread)
#define TILE_H 16     // output rows a block
#define HALO 5        // window radius
#define SR (TILE_H + 2 * HALO)  // staged rows
#define LEFT 8        // staged columns start 8 left of the tile: 16-byte aligned copies
#define SC 144        // staged columns: x0 - 8 .. x0 + 135 (taps reach x0 - 5 .. x0 + 132)
#define NCH (SC / 8)  // 8-column chunks of a staged row
#define RING 11       // rows a y-sum spans
#define MIN_BLOCKS 3  // blocks an SM (shared memory allows 3): at most 170 registers
#define COST_MAX 2.0f

__device__ __forceinline__ float moment(float s, float inv, float m1, float m2) {
  // ops/ncc_volume.py::fma(s, inv, -(m1 * m2)): exact product, float64 sum
  const float c = -__fmul_rn(m1, m2);
  return __double2float_rn(__fma_rn((double)s, (double)inv, (double)c));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float rsqrt_normal(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ncc(float s_e, float s_ee, float s_re, float mr, float var_r,
                                     float inv) {
  const float ms = __fmul_rn(s_e, inv);
  const float var_s = moment(s_ee, inv, ms, ms);
  const float cov = moment(s_re, inv, mr, ms);
  const float den = max_nan(__fmul_rn(var_r, var_s), static_cast<float>(1e-30));
  const float raw = __fsub_rn(1.0f, __fmul_rn(cov, rsqrt_normal(den)));
  const float cost = min_nan(max_nan(raw, 0.0f), COST_MAX);
  const float min_var = static_cast<float>(1e-5);
  return var_r < min_var || var_s < min_var ? COST_MAX : cost;
}

// Walks staged rows t = 0 .. SR-1: row(t, q) fills the NQ x-sums of row t
// (the first NQ/2 of C36, the rest of C9); out(y, s) gets output row
// y = t - 10's NQ window sums once row t is in.
template <int NQ, class Row, class Out>
__device__ __forceinline__ void sweep(Row&& row, Out&& out) {
  float ring[RING][NQ];
#pragma unroll
  for (int t0 = 0; t0 < SR; t0 += RING) {
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      const int t = t0 + j;  // t0 is a multiple of RING: row t sits in slot j
      if (t < SR) {
        row(t, ring[j]);
        if (t >= 2 * HALO) {
          float s[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (q < NQ / 2) {  // rows t-10, t-8, .., t
              s[q] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(
                         ring[(j + 1) % RING][q], ring[(j + 3) % RING][q]),
                         ring[(j + 5) % RING][q]), ring[(j + 7) % RING][q]),
                         ring[(j + 9) % RING][q]), ring[j][q]);
            } else {  // rows t-10, t-5, t
              s[q] = __fadd_rn(__fadd_rn(ring[(j + 1) % RING][q], ring[(j + 6) % RING][q]),
                               ring[j][q]);
            }
          }
          out(t - 2 * HALO, s);
        }
      }
    }
  }
}

// The seven taps of a staged row at column c (dx = -5, -3, -1, 0, 1, 3, 5).
__device__ __forceinline__ void taps(const float2* p, float2 (&v)[7]) {
  v[0] = p[0];
  v[1] = p[2];
  v[2] = p[4];
  v[3] = p[5];
  v[4] = p[6];
  v[5] = p[8];
  v[6] = p[10];
}

// x-sums of a (C36: taps 0, 1, 2, 4, 5, 6; C9: taps 0, 3, 6)
__device__ __forceinline__ float xsum36(const float (&a)[7]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[4]), a[5]),
                   a[6]);
}

__device__ __forceinline__ float xsum9(const float (&a)[7]) {
  return __fadd_rn(__fadd_rn(a[0], a[3]), a[6]);
}

// Copies 16 bytes (8 bf16) to shared memory asynchronously; zeros where
// !valid (nothing is read then).
__device__ __forceinline__ void copy16(uint16_t* dst, const uint16_t* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Starts the copy of slice Ek's staged rows into raw [SR][SC] bf16: 16-byte
// asynchronous copies where PW % 8 == 0 (an 8-column chunk then lies all
// inside the row or all outside), else element loads.
__device__ __forceinline__ void fetch(uint16_t* raw, const uint16_t* __restrict__ Ek, int PH,
                                      int PW, int x0, int y0, bool vec, int c) {
  if (vec) {
#pragma unroll
    for (int m = 0; m < (SR * NCH + TW - 1) / TW; ++m) {
      const int i = c + m * TW;
      if (i < SR * NCH) {
        const int t = i / NCH, ch = i % NCH;
        const int gy = y0 - HALO + t, gx = x0 - LEFT + 8 * ch;
        const bool in = gy >= 0 && gy < PH && gx >= 0 && gx < PW;
        copy16(raw + t * SC + 8 * ch, in ? Ek + (size_t)gy * PW + gx : Ek, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = c; i < SR * SC; i += TW) {
      const int t = i / SC, j = i % SC;
      const int gy = y0 - HALO + t, gx = x0 - LEFT + j;
      raw[i] = gy >= 0 && gy < PH && gx >= 0 && gx < PW ? __ldg(Ek + (size_t)gy * PW + gx)
                                                        : (uint16_t)0;
    }
  }
}

__global__ void __launch_bounds__(TW, MIN_BLOCKS)
cost_volumes_kernel(const uint16_t* __restrict__ E, const float* __restrict__ ref, int K, int PH,
                    int PW, int run, int runs, int vec, uint16_t* __restrict__ out36,
                    uint16_t* __restrict__ out9) {
  extern __shared__ float4 smem_raw[];
  float2* tile = reinterpret_cast<float2*>(smem_raw);                // [SR][SC]: (e, ref)
  float* rt = reinterpret_cast<float*>(tile + SR * SC);               // [4][TILE_H][TW]
  uint16_t* raw = reinterpret_cast<uint16_t*>(rt + 4 * TILE_H * TW);  // [SR][SC]: next slice
  const int c = threadIdx.x, lane = c & 31;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TILE_H;
  const int v = blockIdx.z / runs;
  const int k0 = (blockIdx.z % runs) * run, k1 = min(K, k0 + run);
  const int gx = x0 + c;
  // bit y: output row y0 + y of this column is stored (ok) / interior
  unsigned ok = 0, interior = 0;
  for (int y = 0; y < TILE_H; ++y) {
    const int gy = y0 + y;
    ok |= (unsigned)(gx < PW && gy < PH) << y;
    interior |= (unsigned)(gx >= HALO && gx < PW - HALO && gy >= HALO && gy < PH - HALO) << y;
  }
  const float inv36 = (float)(1.0 / 36.0), inv9 = (float)(1.0 / 9.0);
  const size_t plane = (size_t)PH * PW;
  const uint16_t* Ev = E + (size_t)v * K * plane;

  fetch(raw, Ev + (size_t)k0 * plane, PH, PW, x0, y0, vec, c);
  // the reference tile, zero outside the padded grid
  for (int t = c >> 5; t < SR; t += TW / 32) {
    const int gy = y0 - HALO + t;
    for (int j = lane; j < SC; j += 32) {
      const int gxx = x0 - LEFT + j;
      const bool in = gy >= 0 && gy < PH && gxx >= 0 && gxx < PW;
      tile[t * SC + j].y = in ? __ldg(ref + (size_t)gy * PW + gxx) : 0.0f;
    }
  }
  __syncthreads();

  // the reference terms of this thread's column, both windows
  sweep<4>(
      [&](int t, float (&q)[4]) {
        float2 p[7];
        taps(tile + t * SC + c + (LEFT - HALO), p);
        float a[7], b[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          a[i] = p[i].y;
          b[i] = __fmul_rn(a[i], a[i]);
        }
        q[0] = xsum36(a);
        q[1] = xsum36(b);
        q[2] = xsum9(a);
        q[3] = xsum9(b);
      },
      [&](int y, const float (&s)[4]) {
        const float mr36 = __fmul_rn(s[0], inv36), mr9 = __fmul_rn(s[2], inv9);
        rt[(0 * TILE_H + y) * TW + c] = mr36;
        rt[(1 * TILE_H + y) * TW + c] = moment(s[1], inv36, mr36, mr36);
        rt[(2 * TILE_H + y) * TW + c] = mr9;
        rt[(3 * TILE_H + y) * TW + c] = moment(s[3], inv9, mr9, mr9);
      });

  for (int k = k0; k < k1; ++k) {
    // slice k: raw -> the tile's e, then the copy of slice k + 1 starts
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // raw complete; every thread done with slice k - 1's tile
    {  // a warp a staged row, a lane a pixel: every load first, then every store
      constexpr int WARPS = TW / 32, NR = (SR + WARPS - 1) / WARPS, NJ = (SC + 31) / 32;
      const bool last_row = (c >> 5) < SR - (NR - 1) * WARPS;  // the warp has row NR - 1
      const bool last_col = lane < SC - (NJ - 1) * 32;          // the lane has column NJ - 1
      const uint16_t* rsrc = raw + (c >> 5) * SC + lane;
      float2* tdst = tile + (c >> 5) * SC + lane;
      uint32_t w[NR][NJ];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int m = 0; m < NJ; ++m)
          if ((i < NR - 1 || last_row) && (m < NJ - 1 || last_col))
            w[i][m] = rsrc[i * WARPS * SC + 32 * m];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int m = 0; m < NJ; ++m)
          if ((i < NR - 1 || last_row) && (m < NJ - 1 || last_col))
            tdst[i * WARPS * SC + 32 * m].x = __uint_as_float(w[i][m] << 16);
    }
    __syncthreads();
    if (k + 1 < k1) fetch(raw, Ev + (size_t)(k + 1) * plane, PH, PW, x0, y0, vec, c);
    const size_t obase = ((size_t)v * K + k) * plane + (size_t)y0 * PW + gx;
    uint16_t* o36 = out36 + obase;  // advanced a row at each output row
    uint16_t* o9 = out9 + obase;
    sweep<6>(
        [&](int t, float (&q)[6]) {
          float2 p[7];
          taps(tile + t * SC + c + (LEFT - HALO), p);
          float e[7], ee[7], re[7];
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            e[i] = p[i].x;
            ee[i] = __fmul_rn(e[i], e[i]);
            re[i] = __fmul_rn(p[i].y, e[i]);
          }
          q[0] = xsum36(e);
          q[1] = xsum36(ee);
          q[2] = xsum36(re);
          q[3] = xsum9(e);
          q[4] = xsum9(ee);
          q[5] = xsum9(re);
        },
        [&](int y, const float (&s)[6]) {
          float c36 = ncc(s[0], s[1], s[2], rt[(0 * TILE_H + y) * TW + c],
                          rt[(1 * TILE_H + y) * TW + c], inv36);
          float c9 = ncc(s[3], s[4], s[5], rt[(2 * TILE_H + y) * TW + c],
                         rt[(3 * TILE_H + y) * TW + c], inv9);
          if (!(interior >> y & 1u)) c36 = c9 = COST_MAX;
          const uint16_t b36 = __bfloat16_as_ushort(__float2bfloat16_rn(c36));
          const uint16_t b9 = __bfloat16_as_ushort(__float2bfloat16_rn(c9));
          if (ok >> y & 1u) {
            __stcs(o36, b36);
            __stcs(o9, b9);
          }
          o36 += PW;
          o9 += PW;
        });
  }
}

// E [NV, K, PH, PW] bf16, ref [PH, PW] f32 -> out36, out9 [NV, K, PH, PW]
// bf16, every element written. Returns cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int cost_volumes_launch(const void* E, const float* ref, int NV, int K, int PH,
                                   int PW, void* out36, void* out9, void* stream) {
  if (NV < 1 || K < 1 || PH < 1 || PW < 1 || (long long)PH * PW >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)SR * SC * (sizeof(float2) + sizeof(uint16_t)) +
                      4 * TILE_H * TW * sizeof(float);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cost_volumes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a block walks every slice of its tile, its reference terms computed
  // once, unless that leaves fewer than 4 waves of blocks: then K splits
  // into runs of at least 8 slices
  const long long gy = (PH + TILE_H - 1) / TILE_H;
  const long long tiles = (long long)((PW + TW - 1) / TW) * gy * NV;
  const long long want = 4LL * MIN_BLOCKS * sms;
  const int runs = (int)std::min<long long>(std::max(1LL, (want + tiles - 1) / tiles),
                                            std::max(1, K / 8));
  const int run = (K + runs - 1) / runs;
  const long long z = (long long)NV * runs;
  if (z > 65535 || gy > 65535) return (int)cudaErrorInvalidValue;
  const int vec = PW % 8 == 0 && reinterpret_cast<uintptr_t>(E) % 16 == 0;
  const dim3 grid((PW + TW - 1) / TW, (unsigned)gy, (unsigned)z);
  cost_volumes_kernel<<<grid, TW, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(E), ref, K, PH, PW, run, runs, vec,
      static_cast<uint16_t*>(out36), static_cast<uint16_t*>(out9));
  return (int)cudaGetLastError();
}
