// H7 gather_rows: whole rows of a position-major table at a worklist's
// indices, for Hopper (sm_90a).
//
// Replaces the TPU kernels apdmvs_tpu/ops/cols.py:151 _make_sorted_gather_kernel
// (entry gather_rows_sorted, :208) and, for the table entry point, :50
// _make_gather_kernel (entry gather_rows, :90); oracle the mirror
// gather_rows_ref. Per output row m of a [R, C] table:
//   out[m, :] = table[clip(idx[m], 0, R-1), :]
// A copy of bytes, not of values, so any element type is bit-exact.
//
// Why one kernel for both entry points: the TPU moves a row by a DMA whose
// descriptor the scalar core issues (and whose HBM slice must be aligned
// to an 8- or 16-row group), so the sorted variant saved descriptors by
// reusing the previous request's group. This card has no per-row
// descriptor cost: a warp loads its row by address, and a row that
// neighbouring requests repeat is served from L2 (50 MB). Sortedness
// changes neither the result nor the design.
//
// Bound on this card: bytes (the distinct rows read once, the output
// written once, the indices read). Design: one warp per output row; each
// lane moves 16 bytes at a time where the row size and both base addresses
// allow it (a [*, 640] bf16 row is 1280 bytes, 80 such moves), otherwise
// one element at a time; reads and writes of a warp are contiguous. Row
// offsets are 64-bit: R*C passes 2^31 at real image sizes.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ table, const long long* __restrict__ idx,
                                   long long R, long long M, long long units,
                                   U* __restrict__ out) {
  const long long m = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  long long r = __ldg(idx + m);
  r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
  const U* src = table + r * units;
  U* dst = out + m * units;
  for (long long i = lane; i < units; i += 32) dst[i] = __ldg(src + i);
}

template <typename U>
static void launch(const void* table, const long long* idx, long long R, long long M,
                   long long row_bytes, void* out, cudaStream_t s) {
  const int threads = 256;  // 8 warps, 8 rows a block
  const unsigned blocks = (unsigned)((M * 32 + threads - 1) / threads);
  gather_rows_kernel<U><<<blocks, threads, 0, s>>>(static_cast<const U*>(table), idx, R, M,
                                                   row_bytes / (long long)sizeof(U),
                                                   static_cast<U*>(out));
}

extern "C" int gather_rows_launch(const void* table, const long long* idx, long long R,
                                  long long M, long long row_bytes, int elem_bytes, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = row_bytes % 16 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (wide) {
    launch<uint4>(table, idx, R, M, row_bytes, out, s);
  } else if (elem_bytes == 8) {
    launch<unsigned long long>(table, idx, R, M, row_bytes, out, s);
  } else if (elem_bytes == 4) {
    launch<uint32_t>(table, idx, R, M, row_bytes, out, s);
  } else if (elem_bytes == 2) {
    launch<uint16_t>(table, idx, R, M, row_bytes, out, s);
  } else if (elem_bytes == 1) {
    launch<uint8_t>(table, idx, R, M, row_bytes, out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
