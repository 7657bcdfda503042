// K3: Quest retrieval scores (paper eqs. (2)-(3), mean reduction).
//
// Replaces the TPU kernel
//   src/repro/kernels/retrieval_score.py:retrieval_score_pallas
//
// What it computes.  For batch row b, KV head hk and block n:
//   out[b, hk, n] = sum_{t, r} w[b, t] * max(q[b,t,hk*rep+r] . kmax[b,n,hk],
//                                            q[b,t,hk*rep+r] . kmin[b,n,hk])
//                   / rep / max(sum_t w[b, t], 1e-9)
// with q [B, T, H, Dh] (bf16 or fp32), kmax/kmin [B, NB, Hk, Dh] fp32 (the
// page summaries gathered through the table), q_weight [B, T] fp32 and an
// fp32 result [B, Hk, NB].  Accumulation is fp32 throughout.
//
// What bounds it on the H100.  A refresh at llama3.1-8b widths scores
// rep*T = 4*156 = 624 query rows against two summaries of each block: per
// layer and 8K context about 2*624*64*128*8*2 = 160 MFLOP against ~5 MB of
// summaries and queries, so it is bound by operations; as fp32 FMAs on
// CUDA cores (67 TFLOP/s) that is a few microseconds, well under the
// launch overhead of the surrounding refresh.
//
// The simple design.  One CTA of 8 warps per (row b, KV head, tile of 8
// blocks); warp w owns block n = tile*8 + w and keeps its kmax/kmin rows
// in shared memory (read as broadcasts).  The CTA streams the head's
// query rows through shared memory 32 at a time (fp32, row stride Dh+1 so
// lane i reading row i hits distinct banks); lane i scores row i of the
// chunk against its warp's block and accumulates w_t * max(.,.) in a
// register; a warp reduction gives the block's score.  The kernel
// allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps * 32)
retrieval_score_kernel(const T* __restrict__ q, const float* __restrict__ kmax,
                       const float* __restrict__ kmin,
                       const float* __restrict__ qw, float* __restrict__ out,
                       int t_len, int h, int hk, int nb) {
  __shared__ float qs[kRows * (DH + 1)];
  __shared__ float kx[kWarps * DH];
  __shared__ float kn[kWarps * DH];
  __shared__ float ws[kRows];

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kWarps + warp;
  const int rep = h / hk;
  const int nrows = t_len * rep;

  for (int e = threadIdx.x; e < kWarps * DH; e += blockDim.x) {
    const int w = e / DH, d = e % DH;
    const int nn = blockIdx.x * kWarps + w;
    float a = 0.f, c = 0.f;
    if (nn < nb) {
      const size_t off = (((size_t)b * nb + nn) * hk + kh) * DH + d;
      a = kmax[off];
      c = kmin[off];
    }
    kx[e] = a;
    kn[e] = c;
  }

  float wsum = 0.f;
  for (int t = lane; t < t_len; t += 32) wsum += qw[(size_t)b * t_len + t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);

  float accum = 0.f;
  for (int r0 = 0; r0 < nrows; r0 += kRows) {
    __syncthreads();
    // rows are ordered (t, r): row i -> query t = i / rep, head hk*rep + i % rep
    for (int e = threadIdx.x; e < kRows * DH; e += blockDim.x) {
      const int i = e / DH, d = e % DH;
      const int rg = r0 + i;
      float val = 0.f;
      if (rg < nrows) {
        const int tt = rg / rep, hh = kh * rep + rg % rep;
        val = to_f(q[((size_t)(b * t_len + tt) * h + hh) * DH + d]);
      }
      qs[i * (DH + 1) + d] = val;
    }
    if (threadIdx.x < kRows) {
      const int rg = r0 + threadIdx.x;
      ws[threadIdx.x] = rg < nrows ? qw[(size_t)b * t_len + rg / rep] : 0.f;
    }
    __syncthreads();
    if (n < nb) {
      const float* qr = qs + lane * (DH + 1);
      const float* ax = kx + warp * DH;
      const float* an = kn + warp * DH;
      float sx = 0.f, sn = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        sx = fmaf(qr[d], ax[d], sx);
        sn = fmaf(qr[d], an[d], sn);
      }
      accum += ws[lane] * fmaxf(sx, sn);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) accum += __shfl_xor_sync(0xffffffffu, accum, o);
  if (n < nb && lane == 0)
    out[((size_t)b * hk + kh) * nb + n] = accum / (float)rep / fmaxf(wsum, 1e-9f);
}

template <typename T>
int launch(int dh, const void* q, const float* kmax, const float* kmin,
           const float* qw, float* out, int b, int t, int h, int hk, int nb,
           cudaStream_t s) {
  dim3 grid((nb + kWarps - 1) / kWarps, hk, b);
  if (dh == 128)
    retrieval_score_kernel<T, 128><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const T*>(q), kmax, kmin, qw, out, t, h, hk, nb);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of q: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t, or -1
// for an unsupported head dim / dtype.
extern "C" int retrieval_score_launch(const void* q, const float* kmax,
                                      const float* kmin, const float* qw,
                                      float* out, int b, int t, int h, int hk,
                                      int dh, int nb, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dh, q, kmax, kmin, qw, out, b, t, h, hk, nb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dh, q, kmax, kmin, qw, out, b, t, h, hk, nb,
                                 s);
  return -1;
}
