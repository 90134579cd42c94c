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
// Bound on this card: bytes. It reads j2 slices of E per pixel and writes
// j2 slices of R (2 bytes each) plus the base map once. Design: one thread
// per (j, p), p fastest, so both the E reads of a warp (one slice row,
// b(p) nearly constant across neighbours) and the R writes coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void rebase_view_kernel(const uint16_t* __restrict__ E,
                                   const float* __restrict__ base_k, int K, long long P,
                                   int j2, uint16_t* __restrict__ R, float* __restrict__ bf) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)j2 * P) return;
  const long long p = i % P;
  const int j = (int)(i / P);
  const int J = (j2 - 1) / 2;
  const float b = fminf(fmaxf(rintf(__ldg(base_k + p)), (float)J), (float)(K - 1 - J));
  const int bi = (int)b;
  R[i] = __ldg(E + (long long)(bi + j - J) * P + p);
  if (j == 0) bf[p] = b;
}

extern "C" int rebase_view_launch(const void* E, const float* base_k, int K, int PH, int PW,
                                  int j2, void* R, float* bf, void* stream) {
  const long long P = (long long)PH * PW;
  const long long total = (long long)j2 * P;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  rebase_view_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(E), base_k, K, P, j2, static_cast<uint16_t*>(R), bf);
  return (int)cudaGetLastError();
}
