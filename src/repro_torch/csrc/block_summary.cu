// K4: per-block key summaries (paper eq. (1)).
//
// Replaces the TPU kernel
//   src/repro/kernels/block_summary.py:block_summary_pallas
//
// What it computes.  An entry names one pool block src, its valid length
// n and a target row tgt of the summaries.  It reduces the first n tokens
// of the block to their elementwise max and min per (KV head, dim), in
// fp32, and writes them to kmax[tgt] and kmin[tgt] ([*, Hk, Dh]) in place.
// n 0 gives 0 for both, as block_summary_pallas gives an empty block; an
// entry with a negative target writes nothing.  Two ways to name the
// entries share that one reduction:
//
//   paged (block_summary_paged_launch), the engine's form: the whole pool
//     k [L*NP*bs, Hk, Dh] of every layer, with the rows' page table
//     [B, NB] and their written span [start, end).  Entry (l, b, j), for
//     j < n_touch, is logical block tb = start[b] / bs + j of row b; it
//     is live iff tb < ceil(end[b] / bs) and tb < NB, its page is
//     page_table[b, tb], its valid length clamp(end[b] - tb*bs, 0, bs),
//     and its source and target are l*NP + page.  An entry that is not
//     live, or whose page is the null page 0 (or outside the pool), writes
//     nothing, so page 0 keeps its summaries (0) in every layer.  This is
//     the routing of the reference's paged_update_summaries, computed by
//     each CTA from the page table on the card: one launch covers a
//     prefill chunk or a commit in every layer.
//   routed (block_summary_launch): lists src, vlen, tgt [N] (src clipped
//     to [0, NP-1], as the TPU gathers clip).  The TPU kernel's contiguous
//     contract is the case src = tgt = arange(NB).
//
// What bounds it on the H100.  Bytes: each live block's valid tokens are
// read once and 2 * Hk * Dh fp32 are written per live entry, with one
// compare per element read.  At llama3.1-8b widths a prefill chunk touches
// 2 full blocks of 128 x 8 x 128 bf16 (256 KB) in each of 32 layers, 16.8
// MB, about 5 us at 3.35 TB/s; a commit touches one or two.
//
// The design.  One CTA of 8 warps owns one entry and one 128-byte segment
// of every token row of its block (64 bf16 or 32 fp32 columns).  In a
// warp, lane % 8 picks the 16-byte chunk of the segment and lane / 8 one
// of 4 rows, so the 32 row slots of the CTA (8 warps x 4) each read one
// whole 128-byte line per token.  A thread issues its 4 loads (tokens
// r, r+32, r+64, r+96 of a 128-token block) before any compare, so every
// load of the CTA is in flight at once.  The 32 slots' partial max/min
// meet by two shuffles in each warp and through shared memory across the
// warps.  Max and min are exact in any order, so the bits do not depend
// on the split.  The grid is (segments, entries, layers): 16 x 3 x 32 =
// 1536 CTAs for a prefill chunk, of which those of dead entries exit at
// once, and 32 CTAs even for a routed commit of two blocks.  ptxas (sm_90a):
// 52-58 registers, no spill, 4 KB (bf16) or 2 KB (fp32) of shared memory.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkLanes = 8;                  // 16-byte chunks per segment
constexpr int kSegBytes = 16 * kChunkLanes;     // 128 bytes of a token row
constexpr int kSlots = kWarps * 32 / kChunkLanes;   // row slots of a CTA
constexpr int kLoads = 4;                       // tokens a thread loads at once

struct Entry {
  size_t src;   // pool block, layer offset included
  int n;        // valid tokens
  long long tgt;   // summaries row, layer offset included; < 0 writes nothing
};

struct Routed {
  const int* src;
  const int* vlen;
  const int* tgt;
  int np, bs;
  __device__ Entry operator()(int e, int) const {
    const int id = min(max(src[e], 0), np - 1);
    return {(size_t)id, min(max(vlen[e], 0), bs), (long long)tgt[e]};
  }
};

struct Paged {
  const int* page_table;   // [B, NB]
  const int* start;        // [B]
  const int* end;          // [B]
  int np, bs, nb, n_touch;
  __device__ Entry operator()(int e, int l) const {
    const int b = e / n_touch;
    const int j = e - b * n_touch;
    const int hi = end[b];
    const int tb = start[b] / bs + j;
    Entry out{0, 0, -1};
    if (tb >= (hi + bs - 1) / bs || tb >= nb) return out;
    const int page = page_table[(size_t)b * nb + tb];
    if (page <= 0 || page >= np) return out;
    const size_t row = (size_t)l * np + page;
    out.src = row;
    out.n = min(max(hi - tb * bs, 0), bs);
    out.tgt = (long long)row;
    return out;
  }
};

template <typename T>
__device__ __forceinline__ void merge(const uint4& v, float* mx, float* mn);

template <>
__device__ __forceinline__ void merge<float>(const uint4& v, float* mx,
                                             float* mn) {
  const float x[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mx[i] = fmaxf(mx[i], x[i]);
    mn[i] = fminf(mn[i], x[i]);
  }
}

template <>
__device__ __forceinline__ void merge<__nv_bfloat16>(const uint4& v,
                                                     float* mx, float* mn) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of the fp32 with the same value
    const float lo = __uint_as_float(w[i] << 16);
    const float hi = __uint_as_float(w[i] & 0xffff0000u);
    mx[2 * i] = fmaxf(mx[2 * i], lo);
    mn[2 * i] = fminf(mn[2 * i], lo);
    mx[2 * i + 1] = fmaxf(mx[2 * i + 1], hi);
    mn[2 * i + 1] = fminf(mn[2 * i + 1], hi);
  }
}

// One CTA: entry (blockIdx.y, layer blockIdx.z), segment blockIdx.x.
template <typename T, typename Route>
__global__ void __launch_bounds__(kThreads)
block_summary_kernel(const T* __restrict__ k, Route route,
                     float* __restrict__ kmax, float* __restrict__ kmin,
                     int bs, int cols) {
  constexpr int V = 16 / sizeof(T);                 // columns per chunk
  constexpr int W = V * kChunkLanes;                // columns per segment
  __shared__ float part[2][kWarps][W];
  const Entry e = route(blockIdx.y, blockIdx.z);
  if (e.tgt < 0) return;                            // the whole CTA leaves
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp * (32 / kChunkLanes) + lane / kChunkLanes;
  const int cseg = blockIdx.x * W;
  const int c = cseg + (lane % kChunkLanes) * V;    // first column of lane
  const int n = e.n;
  float mx[V], mn[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mx[i] = -INFINITY;
    mn[i] = INFINITY;
  }
  if (c < cols) {
    const T* base = k + e.src * (size_t)bs * cols + c;
    for (int t0 = slot; t0 < n; t0 += kSlots * kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i)         // every load before a compare
        if (t0 + i * kSlots < n)
          v[i] = __ldg(reinterpret_cast<const uint4*>(
              base + (size_t)(t0 + i * kSlots) * cols));
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (t0 + i * kSlots < n) merge<T>(v[i], mx, mn);
    }
  }
  // the 4 row slots of a warp share a column: meet across lane / 8
#pragma unroll
  for (int off = kChunkLanes; off < 32; off *= 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      mn[i] = fminf(mn[i], __shfl_xor_sync(0xffffffffu, mn[i], off));
    }
  }
  if (lane < kChunkLanes) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[0][warp][lane * V + i] = mx[i];
      part[1][warp][lane * V + i] = mn[i];
    }
  }
  __syncthreads();
  // thread t < 2W writes column t % W of kmax (t < W) or kmin
  const int which = threadIdx.x / W, col = threadIdx.x % W;
  if (which < 2 && cseg + col < cols) {
    float r = part[which][0][col];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      r = which ? fminf(r, part[which][w][col]) : fmaxf(r, part[which][w][col]);
    float* out = which ? kmin : kmax;
    out[(size_t)e.tgt * cols + cseg + col] = n > 0 ? r : 0.f;
  }
}

template <typename Route>
int launch(const void* k, Route route, float* kmax, float* kmin, int entries,
           int layers, int bs, int cols, int dtype, cudaStream_t s) {
  if (entries == 0 || layers == 0) return 0;
  const int esize = dtype == 0 ? 4 : 2;
  const int segs = (cols * esize + kSegBytes - 1) / kSegBytes;
  dim3 grid(segs, entries, layers);
  if (dtype == 0)
    block_summary_kernel<float, Route><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k), route, kmax, kmin, bs, cols);
  else
    block_summary_kernel<__nv_bfloat16, Route><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k), route, kmax, kmin, bs, cols);
  return (int)cudaGetLastError();
}

// a row of Hk*Dh elements must split into whole 16-byte chunks
bool bad_shape(int np, int bs, int hk, int dh, int dtype) {
  if (dtype != 0 && dtype != 1) return true;
  const long long cols = (long long)hk * dh;
  return np < 1 || bs < 1 || cols < 1 || cols > (1 << 24) ||
         (cols * (dtype == 0 ? 4 : 2)) % 16 != 0;
}

}  // namespace

// The routed form.  dtype of k: 0 = float32, 1 = bfloat16.  Returns 0, a
// cudaError_t, or -1 for an unsupported dtype or shape.
extern "C" int block_summary_launch(const void* k, const int* src,
                                    const int* vlen, const int* tgt,
                                    float* kmax, float* kmin, int n, int np,
                                    int bs, int hk, int dh, int dtype,
                                    void* stream) {
  if (bad_shape(np, bs, hk, dh, dtype) || n < 0 || n > 65535) return -1;
  return launch(k, Routed{src, vlen, tgt, np, bs}, kmax, kmin, n, 1, bs,
                hk * dh, dtype, static_cast<cudaStream_t>(stream));
}

// The paged form over every layer: k [L*NP*bs, Hk, Dh], kmax/kmin
// [L*NP, Hk, Dh], page_table int32 [B, NB], start/end int32 [B].  Returns
// 0, a cudaError_t, or -1 for an unsupported dtype or shape.
extern "C" int block_summary_paged_launch(const void* k,
                                          const int* page_table,
                                          const int* start, const int* end,
                                          float* kmax, float* kmin,
                                          int layers, int np, int bs, int hk,
                                          int dh, int b, int nb, int n_touch,
                                          int dtype, void* stream) {
  if (bad_shape(np, bs, hk, dh, dtype) || layers < 0 || layers > 65535 ||
      b < 0 || nb < 1 || n_touch < 0 || (long long)b * n_touch > 65535)
    return -1;
  return launch(k, Paged{page_table, start, end, np, bs, nb, n_touch}, kmax,
                kmin, b * n_touch, layers, bs, hk * dh, dtype,
                static_cast<cudaStream_t>(stream));
}
