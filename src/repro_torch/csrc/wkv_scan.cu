// K5: the RWKV-6 (Finch) WKV recurrence.
//
// Replaces the TPU kernel
//   src/repro/kernels/wkv_scan.py:wkv_pallas
// (and the lax.scan of src/repro/models/rwkv6.py:_time_mix, which computes
// the same function).
//
// What it computes.  For batch row b and head h, with the fp32 state
// s [dk, dk] starting at s0[b, h]:
//   y_t[j] = sum_i r_t[i] * (s[i][j] + u[i] * k_t[i] * v_t[j])
//   s[i][j] <- w_t[i] * s[i][j] + k_t[i] * v_t[j]     (only if t < n_valid[b])
// for t = 0 .. T-1, one step per token.  r, k, v, w are [B, T, H, dk] fp32,
// u [H, dk], s0 [B, H, dk, dk], y [B, T, H, dk].  Unlike wkv_pallas, T is
// any length (chain verify has T = 1 + depth = 6), and each row has a
// valid prefix n_valid[b]: a step past it still gives y from its own k, v
// (as the reference's masked scan does) but leaves the state bit for bit
// as it was.  With update == 0 (read-only chain verify) the final state is
// not written.  The per-step arithmetic is the same whatever T is, so
// verifying 6 tokens and then advancing 1 + accepted tokens leaves exactly
// the state that one-token steps leave.
//
// What bounds it on the H100.  Per token and head 7 dk^2 fp32 operations
// against 5 dk fp32 loads and stores: at rwkv6-3b widths (H = 40, dk = 64)
// and T = 256 about 0.29 GFLOP and 14 MB, a few microseconds of either.
// The recurrence is sequential in t, and at batch 1 there are only 40
// (row, head) chains for 132 SMs, so the kernel is bound by the latency of
// its T dependent steps, not by bytes or operations.
//
// The simple design.  One CTA per (row, head) with dk threads; thread j
// keeps column j of the state in registers (dk floats).  Each step stages
// r_t, k_t, w_t in shared memory (u once) and thread j holds v_t[j]; y_j
// reads the state before the update, then the column is updated.  The
// next step's r, k, v, w are loaded into registers before the current
// step's math, so global latency overlaps it.  A chunked-parallel (matrix)
// form is later work.  The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>

namespace {

template <int DK>
__global__ void __launch_bounds__(DK)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           const int* __restrict__ n_valid, float* __restrict__ y,
           float* __restrict__ s_out, int t_len, int h, int update) {
  __shared__ float rs[DK], ks[DK], ws[DK], us[DK];
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const size_t sbase = ((size_t)b * h + hh) * DK * DK;
  float s[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) s[i] = s0[sbase + (size_t)i * DK + j];
  us[j] = u[hh * DK + j];
  const int nv = n_valid[b];
  const size_t tstride = (size_t)h * DK;
  size_t off = ((size_t)b * t_len * h + hh) * DK + j;
  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (t_len > 0) {
    rn = r[off]; kn = k[off]; vn = v[off]; wn = w[off];
  }
  for (int t = 0; t < t_len; ++t, off += tstride) {
    __syncthreads();              // the previous step's readers are done
    rs[j] = rn;
    ks[j] = kn;
    ws[j] = wn;
    const float vj = vn;
    if (t + 1 < t_len) {          // prefetch the next step
      rn = r[off + tstride];
      kn = k[off + tstride];
      vn = v[off + tstride];
      wn = w[off + tstride];
    }
    __syncthreads();
    float acc = 0.f;
    if (t < nv) {
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float kv = ks[i] * vj;
        acc += rs[i] * (s[i] + us[i] * kv);
        s[i] = ws[i] * s[i] + kv;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DK; ++i) {
        const float kv = ks[i] * vj;
        acc += rs[i] * (s[i] + us[i] * kv);
      }
    }
    y[off] = acc;
  }
  if (update) {
#pragma unroll
    for (int i = 0; i < DK; ++i) s_out[sbase + (size_t)i * DK + j] = s[i];
  }
}

}  // namespace

// All tensors fp32 and contiguous.  Returns 0, a cudaError_t, or -1 for an
// unsupported head size.
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u, const float* s0,
                          const int* n_valid, float* y, float* s_out, int b,
                          int t, int h, int dk, int update, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || h < 1 || t < 0) return -1;
  dim3 grid(h, b);
  if (dk == 64)
    wkv_kernel<64><<<grid, 64, 0, s>>>(r, k, v, w, u, s0, n_valid, y, s_out,
                                       t, h, update);
  else
    return -1;
  return (int)cudaGetLastError();
}
