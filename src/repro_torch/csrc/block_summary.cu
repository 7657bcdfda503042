// K4: routed per-block key summaries (paper eq. (1)).
//
// Replaces the TPU kernel
//   src/repro/kernels/block_summary.py:block_summary_pallas
//
// What it computes.  The pool is flattened to k [NP*bs, Hk, Dh] (bf16 or
// fp32).  Entry e of the lists src, vlen, tgt [N] reduces the first
// vlen[e] tokens of pool block src[e] (clipped to [0, NP-1], as the TPU
// gathers clip) to their elementwise max and min per (KV head, dim), in
// fp32, and writes them to kmax[tgt[e]] and kmin[tgt[e]] ([*, Hk, Dh]) in
// place.  vlen 0 gives 0 for both, as block_summary_pallas gives an empty
// block; a negative target is skipped, which is how the wrapper keeps the
// null page's summaries at 0 without a reset.  The TPU kernel's contiguous
// contract (one row, blocks 0..NB-1 with vlen clip(length - j*bs, 0, bs))
// is the special case src = tgt = arange(NB).
//
// What bounds it on the H100.  Bytes: each listed block is read once
// (vlen * Hk * Dh elements) and 2 * Hk * Dh fp32 are written per entry;
// there is one compare per element read.  At llama3.1-8b widths a commit
// touches 2 blocks of 128 x 8 x 128 bf16 (256 KB each), so the bound is
// well under a microsecond and a launch costs more than the work.
//
// The simple design.  One thread per (entry, KV head, dim): consecutive
// threads own consecutive (hk, d) columns, so each token's row of Hk*Dh
// elements is read coalesced; the thread walks the block's valid tokens
// with the loop unrolled 8 deep so eight loads are in flight at once.
// Nothing is staged in shared memory: every element is read exactly once.
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_summary_kernel(const T* __restrict__ k, const int* __restrict__ src,
                     const int* __restrict__ vlen,
                     const int* __restrict__ tgt, float* __restrict__ kmax,
                     float* __restrict__ kmin, int np, int bs, int cols) {
  const int e = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;   // hk * Dh + d
  const int tg = tgt[e];
  if (c >= cols || tg < 0) return;
  const int id = min(max(src[e], 0), np - 1);
  const int n = min(max(vlen[e], 0), bs);
  const T* base = k + (size_t)id * bs * cols + c;
  float mx = -1e30f, mn = 1e30f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float x = to_f(base[(size_t)s * cols]);
    mx = fmaxf(mx, x);
    mn = fminf(mn, x);
  }
  const size_t o = (size_t)tg * cols + c;
  kmax[o] = n > 0 ? mx : 0.f;
  kmin[o] = n > 0 ? mn : 0.f;
}

template <typename T>
int launch(const void* k, const int* src, const int* vlen, const int* tgt,
           float* kmax, float* kmin, int n, int np, int bs, int cols,
           cudaStream_t s) {
  if (n == 0) return 0;
  dim3 grid((cols + kThreads - 1) / kThreads, n);
  block_summary_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(k), src, vlen, tgt, kmax, kmin, np, bs, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of k: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1
// for an unsupported dtype or shape.
extern "C" int block_summary_launch(const void* k, const int* src,
                                    const int* vlen, const int* tgt,
                                    float* kmax, float* kmin, int n, int np,
                                    int bs, int hk, int dh, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = hk * dh;
  if (n < 0 || n > 65535 || np < 1 || bs < 1 || cols < 1) return -1;
  if (dtype == 0)
    return launch<float>(k, src, vlen, tgt, kmax, kmin, n, np, bs, cols, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(k, src, vlen, tgt, kmax, kmin, n, np, bs,
                                 cols, s);
  return -1;
}
