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
// What bounds it on the H100.  Per KV head it is a small GEMM,
// Q_h [rep*T x Dh] . [Dh x 2*NB] (kmax and kmin side by side), followed by
// sum_rows w_t * max(., .).  A refresh at llama3.1-8b widths (rep*T =
// 4*156 = 624 rows, NB = 66 blocks, Dh = 128, 8 KV heads) is 169 MFLOP
// against about 1.8 MB of queries and summaries: bound by operations, as
// fp32 FMAs on the CUDA cores (67 TFLOP/s) about 2.5 us.  fp32 it stays:
// the summaries are fp32 and the scores feed a top-k whose tie order the
// port reproduces, so neither TF32 nor bf16 tensor cores are used.  What
// the design must avoid is too few CTAs for 132 SMs (one per head and
// block tile would be 24), serial passes over a head's rows, and more
// than a fraction of a shared-memory load per FMA.
//
// The design.
//   - The grid is (block tile of 32, row slice of 64, B*Hk): 3 x 10 x 8 =
//     240 CTAs of 128 threads at T = 156, NB = 66.
//   - Each CTA stages its q slice once, converted to fp32: a slice of 64
//     rows is 64/rep whole tokens (rep must be a power of two dividing
//     64), and row i is token (r0+i) >> log2(rep), head hk*rep + (i & (rep-1)),
//     so every 16-byte vector is one load with no per-element div/mod.  It
//     stages its kmax/kmin tile once too.  fp32 data goes to shared memory
//     by cp.async; bf16 q is loaded into registers (all of a thread's 8
//     vectors in flight at once) and widened.  Rows are padded to Dh + 4
//     floats.
//   - Register tiling: thread (row group tr = tid/8, block group tb =
//     tid%8) accumulates 4 rows (4tr .. 4tr+3) x 4 blocks (tb + 8j) x
//     {max, min} = 32 sums over Dh in float4 steps: 12 16-byte shared
//     loads per 128 FMAs.  The 8 lanes of a quarter-warp share tr (q loads
//     are broadcasts) and take 8 consecutive blocks, whose padded rows
//     start 4 banks apart (no conflicts).
//   - The epilogue applies w_t * max, sums the thread's 4 rows in order,
//     then the slice's 16 row groups through a fixed xor-8 / xor-16
//     shuffle tree and the 4 warps in warp order.  One partial per (slice,
//     block) goes to scratch that the wrapper allocates; the last CTA of
//     each (row, head, block tile), found through an int32 counter that the
//     wrapper owns and that CTA resets to 0, sums the slices in slice order
//     and divides by rep * max(sum w, 1e-9).  No float atomics: two calls
//     give the same bits.  A single slice takes the same path (its CTA is
//     the last).
// ptxas (sm_90a): 114 registers for bf16 q and 78 for fp32, 0 bytes
// spilled, 784 bytes of static shared memory and 67,584 of dynamic.  The
// kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 64;       // query rows per CTA (a slice)
constexpr int kBlocks = 32;     // blocks per CTA (a tile)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;         // floats of padding per staged row

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kRows + 2 * kBlocks) * (DH + kPad);
}

__device__ __forceinline__ void put4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Stage the q slice into qs [kRows][DH + kPad] in fp32.  Slice row i is
// token (r0 + i) >> lrep, head hk*rep + (i & (rep - 1)); rows past nrows
// are zero.  fp32 goes straight to shared memory with cp.async; bf16 is
// loaded as 16-byte vectors, all of a thread's loads issued before any is
// widened.
template <int DH>
__device__ __forceinline__ void stage_q(float* qs, const float* q, size_t qrow0,
                                        int h, int kh, int r0, int nrows,
                                        int lrep) {
  constexpr int kV = DH / 4;                       // vectors per row
  for (int e = threadIdx.x; e < kRows * kV; e += kThreads) {
    const int i = e / kV, c = e % kV;
    const int rg = r0 + i;
    const bool ok = rg < nrows;
    const size_t row = ok ? (qrow0 + (rg >> lrep)) * h + (kh << lrep) +
                                (rg & ((1 << lrep) - 1))
                          : 0;
    cp_async16(qs + i * (DH + kPad) + 4 * c, q + row * DH + 4 * c, ok);
  }
}
template <int DH>
__device__ __forceinline__ void stage_q(float* qs, const __nv_bfloat16* q,
                                        size_t qrow0, int h, int kh, int r0,
                                        int nrows, int lrep) {
  constexpr int kV = DH / 8;                       // vectors per row
  constexpr int kPer = kRows * kV / kThreads;      // vectors per thread
  static_assert(kRows * kV % kThreads == 0, "layout");
  uint4 raw[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int i = e / kV, c = e % kV;
    const int rg = r0 + i;
    raw[m] = make_uint4(0u, 0u, 0u, 0u);
    if (rg < nrows) {
      const size_t row = (qrow0 + (rg >> lrep)) * h + (kh << lrep) +
                         (rg & ((1 << lrep) - 1));
      raw[m] = __ldg(reinterpret_cast<const uint4*>(q + row * DH + 8 * c));
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    float* dst = qs + (e / kV) * (DH + kPad) + 8 * (e % kV);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[m]);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
    put4(dst, make_float4(a.x, a.y, b.x, b.y));
    put4(dst + 4, make_float4(c.x, c.y, d.x, d.y));
  }
}

// sum of x over the CTA in a fixed order (every thread gets it)
__device__ __forceinline__ float cta_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int wp = 0; wp < kWarps; ++wp) s += red[wp];
  return s;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
retrieval_score_kernel(const T* __restrict__ q, const float* __restrict__ kmax,
                       const float* __restrict__ kmin,
                       const float* __restrict__ qw, float* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ counters,
                       int t_len, int h, int hk, int nb, int lrep) {
  constexpr int kLd = DH + kPad;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);   // [kRows][kLd]
  float* const kx = qs + kRows * kLd;                  // [kBlocks][kLd]
  float* const kn = kx + kBlocks * kLd;
  __shared__ float ws[kRows];
  __shared__ float red[kWarps][kBlocks];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int slice = blockIdx.y;
  const int kh = blockIdx.z % hk;
  const int b = blockIdx.z / hk;
  const int rep = 1 << lrep;
  const int nrows = t_len << lrep;
  const int r0 = slice * kRows;
  const int n0 = tile * kBlocks;
  const int tid = threadIdx.x;

  // ---- stage the kmax/kmin tile and the q slice once, in fp32
  for (int e = tid; e < 2 * kBlocks * (DH / 4); e += kThreads) {
    const int m = e / (kBlocks * (DH / 4));     // 0: kmax, 1: kmin
    const int f = e % (kBlocks * (DH / 4));
    const int blk = f / (DH / 4), c = f % (DH / 4);
    const int n = n0 + blk;
    const bool ok = n < nb;
    const size_t off = ok ? (((size_t)b * nb + n) * hk + kh) * DH + 4 * c : 0;
    cp_async16((m ? kn : kx) + blk * kLd + 4 * c, (m ? kmin : kmax) + off, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_q<DH>(qs, q, (size_t)b * t_len, h, kh, r0, nrows, lrep);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < kRows) {
    const int rg = r0 + tid;
    ws[tid] = rg < nrows ? qw[(size_t)b * t_len + (rg >> lrep)] : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- 4 rows x 4 blocks x {max, min} per thread
  const int tb = tid & 7, tr = tid >> 3;
  float sx[4][4], sn[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) sx[i][jj] = sn[i][jj] = 0.f;
  const float* qrow = qs + 4 * tr * kLd;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], x[4], m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qrow + i * kLd + d);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      x[jj] = *reinterpret_cast<const float4*>(kx + (tb + 8 * jj) * kLd + d);
      m[jj] = *reinterpret_cast<const float4*>(kn + (tb + 8 * jj) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        sx[i][jj] = fmaf(a[i].x, x[jj].x, sx[i][jj]);
        sx[i][jj] = fmaf(a[i].y, x[jj].y, sx[i][jj]);
        sx[i][jj] = fmaf(a[i].z, x[jj].z, sx[i][jj]);
        sx[i][jj] = fmaf(a[i].w, x[jj].w, sx[i][jj]);
        sn[i][jj] = fmaf(a[i].x, m[jj].x, sn[i][jj]);
        sn[i][jj] = fmaf(a[i].y, m[jj].y, sn[i][jj]);
        sn[i][jj] = fmaf(a[i].z, m[jj].z, sn[i][jj]);
        sn[i][jj] = fmaf(a[i].w, m[jj].w, sn[i][jj]);
      }
  }

  // ---- the slice's weighted sum per block, in a fixed order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float p = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p = fmaf(ws[4 * tr + i], fmaxf(sx[i][jj], sn[i][jj]), p);
    p += __shfl_xor_sync(0xffffffffu, p, 8);
    p += __shfl_xor_sync(0xffffffffu, p, 16);
    if (lane < 8) red[warp][tb + 8 * jj] = p;
  }
  __syncthreads();
  float sum = 0.f;
  const int n = n0 + tid;
  const bool mine = tid < kBlocks && n < nb;
  if (tid < kBlocks) {
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum += red[wp][tid];
  }
  const size_t obase = ((size_t)b * hk + kh) * nb;

  // ---- the last CTA of this (row, head, block tile) sums the slices
  const size_t pbase = (size_t)blockIdx.z * gridDim.y * nb;
  if (mine) part[pbase + (size_t)slice * nb + n] = sum;
  __threadfence();
  __syncthreads();
  int* const ctr = counters + (size_t)blockIdx.z * gridDim.x + tile;
  if (tid == 0) {
    s_last = atomicAdd(ctr, 1) == (int)gridDim.y - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (mine) {
    // slice order; 8 loads in flight at a time
    const int ns = gridDim.y;
    sum = 0.f;
    for (int sl0 = 0; sl0 < ns; sl0 += 8) {
      float pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = sl0 + i < ns
                    ? __ldcg(part + pbase + (size_t)(sl0 + i) * nb + n)
                    : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (sl0 + i < ns) sum += pv[i];
    }
  }
  if (tid == 0) *ctr = 0;                      // ready for the next launch
  float wsum = 0.f;
  for (int t = tid; t < t_len; t += kThreads) wsum += qw[(size_t)b * t_len + t];
  wsum = cta_sum(wsum, &red[0][0]);
  if (mine) out[obase + n] = sum / (float)rep / fmaxf(wsum, 1e-9f);
}

template <typename T>
int launch(int dh, const void* q, const float* kmax, const float* kmin,
           const float* qw, float* out, float* part, int* counters, int b,
           int t, int h, int hk, int nb, int tiles, int slices,
           cudaStream_t s) {
  if (dh != 128 || hk < 1 || h < hk) return -1;
  int lrep = 0;
  while ((hk << lrep) < h) ++lrep;
  if ((hk << lrep) != h || (1 << lrep) > kRows) return -1;
  // the wrapper sized part and counters for this grid: it must be ours
  if (tiles != (nb + kBlocks - 1) / kBlocks ||
      slices != (t > 0 ? ((t << lrep) + kRows - 1) / kRows : 1))
    return -1;
  if ((long long)b * hk > 65535 || slices > 65535) return -1;
  if (part == nullptr || counters == nullptr) return -1;
  auto kern = retrieval_score_kernel<T, 128>;
  constexpr size_t smem = smem_bytes<128>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(tiles, slices, b * hk);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), kmax, kmin, qw,
                                    out, part, counters, t, h, hk, nb, lrep);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of q: 0 = float32, 1 = bfloat16.  tiles = ceil(NB / 32) and
// slices = ceil(rep*T / 64) are the grid the wrapper sized its buffers
// for; part: fp32 scratch of B * Hk * slices * NB floats and counters:
// B * Hk * tiles int32 zeros.  Returns 0, a cudaError_t, or -1 for an
// unsupported shape (head dim other than 128, rep not a power of two up
// to 64), a grid other than the kernel's, a null buffer or a dtype other
// than these.
extern "C" int retrieval_score_launch(const void* q, const float* kmax,
                                      const float* kmin, const float* qw,
                                      float* out, float* part, int* counters,
                                      int b, int t, int h, int hk, int dh,
                                      int nb, int tiles, int slices,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dh, q, kmax, kmin, qw, out, part, counters, b, t, h,
                         hk, nb, tiles, slices, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dh, q, kmax, kmin, qw, out, part, counters,
                                 b, t, h, hk, nb, tiles, slices, s);
  return -1;
}
