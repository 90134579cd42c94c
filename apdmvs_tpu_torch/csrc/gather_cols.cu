// H5 gather_cols: K-columns of a volume at the weak worklist's positions, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel apdmvs_tpu/ops/cols.py::_make_gather_kernel (entry
// gather_rows), together with the layout work around it in
// apdmvs_tpu/weak.py::build_weak_cols (pack_volume_rows, flat_index, the
// transpose to [Vs, K, M]). Per output (p, m), p = v * K + k:
//   xi = clip(xs[m] + pad_x, 0, PW-1),  yi = clip(ys[m] + pad_y, 0, PH-1)
//   out[p, m] = vol[p, yi, xi]
// A -1 coordinate (missing anchor, worklist padding) clamps to pad-1 and
// reads a real position, as flat_index does; callers mask those columns.
// The result is a copy, so it is bit-exact with the plain version.
//
// Why in place: the TPU kernel DMAs contiguous rows of a position-major
// [PH*PW, Vs*K] table, which costs a full transposed copy of each volume a
// pass. Here each element is read where it lies.
//
// Bound on this card: bytes (each distinct element read once, each output
// written once, the coordinates). The writes are most of it: at the C9
// anchors 196608 slots x 640 slices of 2 bytes against ~10^4 distinct
// positions. Design:
// - a thread owns G consecutive slots (G = 8 bf16 or 4 f32: one 16-byte
//   store a slice) and a run of RUN slices of the plane axis; it loads and
//   clamps its coordinates once and keeps G 32-bit pixel offsets;
// - per step it issues the loads of UNROLL slices (UNROLL * G loads in
//   flight) before their stores: one load in flight a thread (a thread an
//   element) left the card waiting on latency;
// - each slice's base is a 64-bit pointer, the pixel offset 32-bit;
// - blocks are slice-major (grid x over slots, y over slice runs), so the
//   blocks in flight read the same few slices; within a block, slots that
//   share a sector find it in L1 (a block owning 4 tiles in turn, for
//   more of that, measured slower);
// - lane l of a warp owns slots 8l..8l+7 (bf16): at the anchors that is
//   one weak pixel's 8 anchors. Scattered reads cost the L1 one pass (a
//   wavefront) per distinct 128-byte line a warp load touches, and at the
//   anchors those passes, not the bytes, set the time once enough loads
//   are in flight. So each lane sorts its 8 slots by position (a
//   19-comparator network, once), and load g reads the g-th anchor in
//   raster order of 32 neighbouring weak pixels, which share more lines
//   than their g-th anchor slots do; three byte permutes a word put the
//   values back in slot order for the store;
// - 16-byte stores where M * elem is a multiple of 16, streaming (the
//   columns are read again only by H6, later in the pass); elements at a
//   ragged end and for other M.

#include <cuda_runtime.h>
#include <stdint.h>

#define H5_RUN 8     // slices a thread moves
#define H5_UNROLL 2  // slices whose loads go out before their stores
#define THREADS 256

__device__ __forceinline__ uint4 pack16(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | ((uint32_t)v[1] << 16), v[2] | ((uint32_t)v[3] << 16),
                    v[4] | ((uint32_t)v[5] << 16), v[6] | ((uint32_t)v[7] << 16));
}

__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Sorts a lane's 8 slots by pixel offset (Batcher's 19-comparator network
// on registers), carrying each slot's index.
__device__ __forceinline__ void sort8(unsigned (&key)[8], int (&idx)[8]) {
  constexpr int net[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3}, {4, 6},
                              {5, 7}, {1, 2}, {5, 6}, {0, 4}, {1, 5}, {2, 6}, {3, 7},
                              {2, 4}, {3, 5}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
  for (int c = 0; c < 19; ++c) {
    const int a = net[c][0], b = net[c][1];
    const bool swap = key[b] < key[a];
    const unsigned ka = key[a], kb = key[b];
    const int ia = idx[a], ib = idx[b];
    key[a] = swap ? kb : ka;
    key[b] = swap ? ka : kb;
    idx[a] = swap ? ib : ia;
    idx[b] = swap ? ia : ib;
  }
}

// Byte selectors that put 8 bf16 values loaded in sorted order back in
// slot order: word w of the sorted values holds sorted entries 2w, 2w + 1;
// output word k takes slots 2k, 2k + 1 from sorted entries a, b. With one
// selector sp[k] picking entries a, b out of words 0-1 (P) and, the same
// bytes, out of words 2-3 (Q), and sf[k] taking each half from P or Q:
//   out_k = prmt(prmt(W0, W1, sp[k]), prmt(W2, W3, sp[k]), sf[k]).
__device__ __forceinline__ void unsort_selectors(const int (&idx)[8], unsigned (&sp)[4],
                                                 unsigned (&sf)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int a = 0, b = 0;  // the sorted entries of slots 2k and 2k + 1
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a = idx[i] == 2 * k ? i : a;
      b = idx[i] == 2 * k + 1 ? i : b;
    }
    const unsigned la = 2u * (a & 3), lb = 2u * (b & 3);  // byte within its word pair
    sp[k] = la | (la + 1) << 4 | lb << 8 | (lb + 1) << 12;
    sf[k] = (a < 4 ? 0x10u : 0x54u) | (b < 4 ? 0x3200u : 0x7600u);
  }
}

__device__ __forceinline__ uint4 unsort16(const uint16_t (&v)[8], const unsigned (&sp)[4],
                                          const unsigned (&sf)[4]) {
  const unsigned w0 = __byte_perm(v[0], v[1], 0x5410), w1 = __byte_perm(v[2], v[3], 0x5410);
  const unsigned w2 = __byte_perm(v[4], v[5], 0x5410), w3 = __byte_perm(v[6], v[7], 0x5410);
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = __byte_perm(__byte_perm(w0, w1, sp[k]), __byte_perm(w2, w3, sp[k]), sf[k]);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_cols_kernel(const T* __restrict__ vol, const int* __restrict__ xs,
                   const int* __restrict__ ys, int P, int PH, int PW, int M, int pad_y,
                   int pad_x, int vec, T* __restrict__ out) {
  constexpr int G = 16 / sizeof(T);
  const int m0 = (blockIdx.x * THREADS + threadIdx.x) * G;
  if (m0 >= M) return;
  unsigned pix[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int m = min(m0 + g, M - 1);  // past a ragged end: a real slot, never stored
    const int xi = min(max(__ldg(xs + m) + pad_x, 0), PW - 1);
    const int yi = min(max(__ldg(ys + m) + pad_y, 0), PH - 1);
    pix[g] = (unsigned)yi * (unsigned)PW + (unsigned)xi;
  }
  const bool full = vec && m0 + G <= M;
  // bf16 with 16-byte stores: load a lane's slots in position order, so a
  // warp load of the anchors touches fewer lines, and put them back in
  // slot order in registers before the store. A warp whose lanes are all in
  // order already (the weak pixels, a raster compaction) skips the shuffle.
  unsigned sp[4], sf[4];
  bool shuffle = false;
  if constexpr (G == 8) {
    int idx[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) idx[g] = g;
    if (full) sort8(pix, idx);
    bool in_order = true;
#pragma unroll
    for (int g = 0; g < 8; ++g) in_order &= idx[g] == g;
    shuffle = !__all_sync(__activemask(), in_order);
    if (shuffle) unsort_selectors(idx, sp, sf);
  }
  const size_t plane = (size_t)PH * PW;
  const int p0 = blockIdx.y * H5_RUN;
  const int np = min(H5_RUN, P - p0);
  const T* src = vol + (size_t)p0 * plane;
  T* dst = out + (size_t)p0 * M + m0;
  for (int s = 0; s < np; s += H5_UNROLL) {
    T v[H5_UNROLL][G];
#pragma unroll
    for (int u = 0; u < H5_UNROLL; ++u) {
      const T* sptr = src + (size_t)min(s + u, np - 1) * plane;
#pragma unroll
      for (int g = 0; g < G; ++g) v[u][g] = __ldg(sptr + pix[g]);
    }
#pragma unroll
    for (int u = 0; u < H5_UNROLL; ++u) {
      if (s + u >= np) break;
      T* dp = dst + (size_t)(s + u) * M;
      if (full) {
        uint4 w;
        if constexpr (G == 8) {
          w = shuffle ? unsort16(v[u], sp, sf) : pack16(v[u]);
        } else {
          w = pack16(v[u]);
        }
        __stcs(reinterpret_cast<uint4*>(dp), w);
      } else {  // never shuffled: slots in order
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (m0 + g < M) dp[g] = v[u][g];
      }
    }
  }
}

extern "C" int gather_cols_launch(const void* vol, const int* xs, const int* ys, int P, int PH,
                                  int PW, int M, int pad_y, int pad_x, int elem_bytes, void* out,
                                  void* stream) {
  if (P < 1 || M < 1 || PH < 1 || PW < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  const int G = 16 / elem_bytes;
  const long long threads = ((long long)M + G - 1) / G;
  const long long runs = ((long long)P + H5_RUN - 1) / H5_RUN;
  if (runs > 65535 || (long long)PH * PW >= (1LL << 32)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), (unsigned)runs);
  const int vec = ((long long)M * elem_bytes) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    gather_cols_kernel<uint16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint16_t*>(vol), xs, ys, P, PH, PW, M, pad_y, pad_x, vec,
        static_cast<uint16_t*>(out));
  } else {
    gather_cols_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint32_t*>(vol), xs, ys, P, PH, PW, M, pad_y, pad_x, vec,
        static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
