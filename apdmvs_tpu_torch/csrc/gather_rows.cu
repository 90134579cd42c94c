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
// descriptor cost: a thread loads by address, and a row that neighbouring
// requests repeat is served from L2 (50 MB). Sortedness changes neither
// the result nor the design.
//
// Bound on this card: bytes (the distinct rows read once, the output
// written once, the indices read). Two paths, chosen by the row's size:
// - rows of 1 to ROW_TRIPS whole warp moves of 32 x 16 bytes (a [*, 640]
//   f32 depth row is 5): a warp a row, each lane issuing all its loads
//   before its stores. The warp's trips have no idle lane;
// - any other row (a [*, 640] bf16 cost row is 80 units of 16 bytes, on
//   which a warp a row leaves 16 lanes idle on its third trip): the work
//   is flattened over (row, unit), a unit being the widest move (16, 8, 4,
//   2 or 1 bytes) that the row size and both base addresses allow. A block
//   moves CHUNK consecutive units of the output; it first reads the
//   indices of all the rows it touches in one coalesced read and keeps
//   their source offsets in shared memory, then each thread issues its
//   UNROLL loads before any store.
// Both read int32 or int64 indices as the caller has them, and store with
// the streaming hint (the kernel never reads its output back). Row
// offsets are 64-bit: R*C passes 2^31 at real image sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 4
#define CHUNK (THREADS * UNROLL)  // units a block moves
#define ROW_TRIPS 8                // most warp moves of 512 bytes in a row a warp takes

template <typename U, typename I>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const U* __restrict__ table, const I* __restrict__ idx, long long R,
                   long long M, unsigned units, U* __restrict__ out) {
  // source offset (in units) of each row the block touches: at most
  // CHUNK / units + 2 rows
  __shared__ long long src[CHUNK + 2];
  const long long base = (long long)blockIdx.x * CHUNK;
  const long long row0 = base / units;
  const unsigned rem0 = (unsigned)(base - row0 * units);
  const long long span = (long long)((rem0 + CHUNK - 1) / units) + 1;
  const unsigned nrows = (unsigned)(span < M - row0 ? span : M - row0);
  for (unsigned j = threadIdx.x; j < nrows; j += THREADS) {
    long long r = (long long)__ldg(idx + row0 + j);
    r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
    src[j] = r * units;
  }
  __syncthreads();
  const long long left = M * units - base;  // units of the output from base on
  U v[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const unsigned i = threadIdx.x + k * THREADS;
    if (i < left) {
      const unsigned t = rem0 + i;
      const unsigned r = t / units;
      v[k] = __ldg(table + src[r] + (t - r * units));
    }
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const unsigned i = threadIdx.x + k * THREADS;
    if (i < left) __stcs(out + base + i, v[k]);
  }
}

// A warp a row, for rows of 32 * trips 16-byte units (trips <= ROW_TRIPS):
// all of a lane's loads before its stores.
template <typename I>
__global__ void __launch_bounds__(THREADS)
gather_rows_warp_kernel(const uint4* __restrict__ table, const I* __restrict__ idx, long long R,
                        long long M, unsigned trips, uint4* __restrict__ out) {
  const long long m = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (m >= M) return;
  const unsigned lane = threadIdx.x & 31u;
  long long r = (long long)__ldg(idx + m);
  r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
  const uint4* s = table + r * (32LL * trips) + lane;
  uint4* d = out + m * (32LL * trips) + lane;
  uint4 v[ROW_TRIPS];
#pragma unroll
  for (int k = 0; k < ROW_TRIPS; ++k)
    if ((unsigned)k < trips) v[k] = __ldg(s + 32 * k);
#pragma unroll
  for (int k = 0; k < ROW_TRIPS; ++k)
    if ((unsigned)k < trips) __stcs(d + 32 * k, v[k]);
}

template <typename U>
static int launch(const void* table, const void* idx, int idx_bytes, long long R, long long M,
                  long long row_bytes, void* out, cudaStream_t s) {
  const long long units = row_bytes / (long long)sizeof(U);
  const long long blocks = (M * units + CHUNK - 1) / CHUNK;
  if (units >= (1LL << 31) - CHUNK || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const U* t = static_cast<const U*>(table);
  U* o = static_cast<U*>(out);
  if (idx_bytes == 8) {
    gather_rows_kernel<U, long long><<<(unsigned)blocks, THREADS, 0, s>>>(
        t, static_cast<const long long*>(idx), R, M, (unsigned)units, o);
  } else if (idx_bytes == 4) {
    gather_rows_kernel<U, int><<<(unsigned)blocks, THREADS, 0, s>>>(
        t, static_cast<const int*>(idx), R, M, (unsigned)units, o);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_launch(const void* table, const void* idx, int idx_bytes, long long R,
                                  long long M, long long row_bytes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || M < 1 || row_bytes < 1) return (int)cudaErrorInvalidValue;
  // the widest unit that divides the row and both base addresses
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  const long long trips = row_bytes / 512;
  if (align % 16 == 0 && row_bytes % 512 == 0 && trips <= ROW_TRIPS) {
    const long long warp_blocks = (M * 32 + THREADS - 1) / THREADS;
    if (warp_blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)warp_blocks;
    if (idx_bytes == 8)
      gather_rows_warp_kernel<long long><<<blocks, THREADS, 0, s>>>(
          static_cast<const uint4*>(table), static_cast<const long long*>(idx), R, M,
          (unsigned)trips, static_cast<uint4*>(out));
    else if (idx_bytes == 4)
      gather_rows_warp_kernel<int><<<blocks, THREADS, 0, s>>>(
          static_cast<const uint4*>(table), static_cast<const int*>(idx), R, M, (unsigned)trips,
          static_cast<uint4*>(out));
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  if (align % 16 == 0) return launch<uint4>(table, idx, idx_bytes, R, M, row_bytes, out, s);
  if (align % 8 == 0)
    return launch<unsigned long long>(table, idx, idx_bytes, R, M, row_bytes, out, s);
  if (align % 4 == 0) return launch<unsigned int>(table, idx, idx_bytes, R, M, row_bytes, out, s);
  if (align % 2 == 0)
    return launch<unsigned short>(table, idx, idx_bytes, R, M, row_bytes, out, s);
  return launch<unsigned char>(table, idx, idx_bytes, R, M, row_bytes, out, s);
}
