// H3 rebase_view: rebased volume R[j, p] = E[b(p) + j - J, p], for Hopper
// (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/ncc_volume.py::_rebase_kernel
// (entry build_rebased_view), whose oracle is that function's CPU branch:
//   b  = clip(round_half_even(base_k), J, K-1-J),   J = (j2 - 1) / 2
//   R  = E[b + j - J] for j in [0, j2)
//   bf = b as f32
// Rounding is rintf (half to even, as jnp.round), never roundf. The result
// is a copy, so it is bit-exact with the plain version.
//
// Bound on this card: bytes. It reads j2 slices of E per position and
// writes j2 slices of R (2 bytes each) plus base_k and bf once. A thread a
// (j, p) spends its time on instruction issue instead: a division for p, a
// base_k load and its rounding j2 times a position, and a 2-byte store. So
// a thread owns GROUP = 8 consecutive positions and a run of at most
// RUN_MAX slices (grid: position groups on x, slice runs on y). It loads
// base_k once as two float4 and rounds the 8 bases once. Neighbouring
// positions' bases differ by at most 1 almost everywhere (a depth edge
// apart), so where they span <= 1 slice the thread loads the run's rows
// (one more where they span 1) as 16-byte loads of E, all before any
// store, and builds each slice of R from two rows with one byte permute a
// word, its selectors fixed for the thread: one 16-byte store a slice. bf
// is written by the first slice run. Offsets inside a slice are 32-bit
// (the wrapper refuses P >= 2^31), slice bases 64-bit.
//
// The 16-byte path needs every row of E and R, and base_k and bf, to
// start on a 16-byte boundary: P a multiple of 8 and all four pointers
// aligned. The wrapper decides (ops/ncc_volume.py::rebase_vector_path).
// Otherwise, and for groups whose bases span more than one slice, the
// same threads copy element by element, the last group clipped at P.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int GROUP = 8;
constexpr int RUN_MAX = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rebase_view_kernel(const uint16_t* __restrict__ E, const float* __restrict__ base_k, int K,
                   int P, int j2, int run, int vec, uint16_t* __restrict__ R,
                   float* __restrict__ bf) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (g > (P - 1) / GROUP) return;
  const int p0 = g * GROUP;
  const int J = (j2 - 1) / 2;
  const int j0 = blockIdx.y * run;
  const int n = min(run, j2 - j0);
  const int cnt = min(GROUP, P - p0);

  float b[GROUP];
  if (vec) {
    const float4 x0 = __ldg(reinterpret_cast<const float4*>(base_k + p0));
    const float4 x1 = __ldg(reinterpret_cast<const float4*>(base_k + p0) + 1);
    b[0] = x0.x; b[1] = x0.y; b[2] = x0.z; b[3] = x0.w;
    b[4] = x1.x; b[5] = x1.y; b[6] = x1.z; b[7] = x1.w;
  } else {
#pragma unroll
    for (int i = 0; i < GROUP; ++i) b[i] = i < cnt ? __ldg(base_k + p0 + i) : 0.0f;
  }
  int bi[GROUP];
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    b[i] = fminf(fmaxf(rintf(b[i]), (float)J), (float)(K - 1 - J));
    bi[i] = (int)b[i] - J;  // slice of R's row 0
  }
  if (blockIdx.y == 0) {
    if (vec) {
      reinterpret_cast<float4*>(bf + p0)[0] = make_float4(b[0], b[1], b[2], b[3]);
      reinterpret_cast<float4*>(bf + p0)[1] = make_float4(b[4], b[5], b[6], b[7]);
    } else {
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        if (i < cnt) bf[p0 + i] = b[i];
    }
  }
  int lo = bi[0], hi = bi[0];
#pragma unroll
  for (int i = 1; i < GROUP; ++i) {
    lo = min(lo, bi[i]);
    hi = max(hi, bi[i]);
  }

  if (vec && hi - lo <= 1) {
    // rows lo + j0 .. lo + j0 + n - 1 + (hi - lo) as 16-byte loads; a slice
    // of R takes each 2-byte half of a word from row t or t + 1, one byte
    // permute a word with a selector fixed for the thread
    uint32_t sel[4];
#pragma unroll
    for (int w = 0; w < 4; ++w)
      sel[w] = (bi[2 * w] > lo ? 0x54u : 0x10u) | (bi[2 * w + 1] > lo ? 0x7600u : 0x3200u);
    const int rows = n + hi - lo;
    uint4 u[RUN_MAX + 1];
#pragma unroll
    for (int t = 0; t < RUN_MAX + 1; ++t) {
      if (t < rows) {
        const uint16_t* row = E + (long long)(lo + j0 + t) * P;
        u[t] = __ldg(reinterpret_cast<const uint4*>(row + p0));
      }
    }
#pragma unroll
    for (int t = 0; t < RUN_MAX; ++t) {
      if (t < n) {
        *reinterpret_cast<uint4*>(R + (long long)(j0 + t) * P + p0) =
            make_uint4(__byte_perm(u[t].x, u[t + 1].x, sel[0]),
                       __byte_perm(u[t].y, u[t + 1].y, sel[1]),
                       __byte_perm(u[t].z, u[t + 1].z, sel[2]),
                       __byte_perm(u[t].w, u[t + 1].w, sel[3]));
      }
    }
    return;
  }
  for (int t = 0; t < n; ++t) {
    uint16_t e[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i)
      if (i < cnt) e[i] = __ldg(E + (long long)(bi[i] + j0 + t) * P + p0 + i);
    uint16_t* out = R + (long long)(j0 + t) * P + p0;
#pragma unroll
    for (int i = 0; i < GROUP; ++i)
      if (i < cnt) out[i] = e[i];
  }
}

extern "C" int rebase_view_launch(const void* E, const float* base_k, int K, int P, int j2,
                                  int vec, void* R, float* bf, void* stream) {
  // runs of equal length, each at most RUN_MAX slices
  const int runs = (j2 + RUN_MAX - 1) / RUN_MAX;
  const int run = (j2 + runs - 1) / runs;
  if (P == 0) return 0;
  const int groups = (P - 1) / GROUP + 1;
  const dim3 grid((groups + THREADS - 1) / THREADS, (j2 + run - 1) / run);
  rebase_view_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(E), base_k, K, P, j2, run, vec, static_cast<uint16_t*>(R), bf);
  return (int)cudaGetLastError();
}
