// K1 + K2: block-list (paged / routed / causal-prefill) attention partials.
//
// Replaces the TPU kernels
//   src/repro/kernels/sparse_attention.py:sparse_verify_attention_pallas
//     (K1: Full/Refresh verification through the page table, and the
//      zero-copy Partial verification through per-head routed pages), and
//   src/repro/kernels/prefill_attention.py:paged_prefill_attention_pallas
//     (K2: the same page walk plus the absolute-position causal test
//      key j*bs+s <= query qoff+i; CAUSAL template flag below).
//
// What it computes.  For each batch row b and KV head hk, the rep*T query
// rows grouped onto that head (row r -> head hk*rep + r/T, query r%T) are
// scored against the KV blocks listed in idx[b, hk, :] (page ids into the
// flattened pool [NP*bs, Hk, Dh], clipped to [0, NP-1] as the TPU kernel
// does), each masked to its first vlen[b, hk, j] tokens.  An online softmax
// in fp32 leaves the un-normalised partials m, l [B, H, T] and
// acc [B, H, T, Dh].  Masked logits are -1e30 and p is multiplied by the
// validity mask, so a row whose blocks are all empty comes out exactly
// m = -1e30, l = 0, acc = 0 (partial rows of a fused tick and the null
// page depend on this).  q is scaled by 1/sqrt(Dh) in fp32, as the plain
// version does.
//
// What bounds it on the H100.  At llama3.1-8b widths a Full tick has
// rep*T = 4*61 = 244 query rows per KV element, about 8.2 GFLOP against
// 32 MB per layer at 8K context: close to the bf16 ridge, so a tensor-core
// kernel would be bound by bytes.  This first kernel does its products as
// fp32 FMAs on the CUDA cores (67 TFLOP/s peak), so it is bound by
// operations and sits far from the byte bound.
//
// The simple design.  One CTA of 4 warps per (row b, KV head, tile of 32
// query rows); each warp owns 8 query rows.  The CTA stages its queries
// (fp32, pre-scaled) in shared memory once, then walks its block list in
// tiles of 32 keys: a block with vlen 0 is skipped (it cannot change the
// partials), a causal CTA also skips blocks wholly after its last query.
// K and V tiles are read with 16-byte loads, converted to fp32 and kept
// row-major in shared memory (K rows padded by 4 floats, so lane i reading
// key i as float4s hits distinct banks); the next tile's loads are issued
// into registers before the current tile is computed, so global latency
// overlaps the math.  Lane i scores key i against the warp's 8 rows; for
// acc += p V each lane owns 4 consecutive dims.  The online-softmax update
// runs per tile with warp shuffles.  No tensor cores, no TMA, and no split
// of the block list across CTAs: those are later work (ROADMAP queue 2).
// The kernel allocates nothing and launches on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;   // 32 query rows
constexpr int kKeys = 32;                            // keys per tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 raw bytes -> fp32 values (4 floats, or 8 bf16 widened exactly)
__device__ __forceinline__ void unpack(const uint4& r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kRowsPerCta * DH + 2 * kKeys * (DH + 4));
}

template <typename T, int DH, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const int* __restrict__ idx, const int* __restrict__ vlen,
                       const int* __restrict__ qoff,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out,
                       int t_len, int h, int hk, int np, int bs, int nsel,
                       float scale) {
  constexpr int KS = DH + 4;                     // padded smem row stride
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int NV = kKeys * DH / VEC / kThreads;  // loads per thread
  constexpr int DPL = DH / 32;                   // dims per lane
  static_assert(NV * VEC * kThreads == kKeys * DH, "tile shape");
  static_assert(DPL == 4, "acc update reads one float4 per lane");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [32 rows][DH]
  float* ks = qs + kRowsPerCta * DH;             // [kKeys][KS]
  float* vs = ks + kKeys * KS;                   // [kKeys][KS]

  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = h / hk;
  const int nrows = rep * t_len;
  const int row0 = tile * kRowsPerCta;

  // ---- stage this tile's queries (fp32, scaled), zero for padded rows
  for (int e = threadIdx.x; e < kRowsPerCta * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int rg = row0 + r;
    float val = 0.f;
    if (rg < nrows) {
      const int hh = kh * rep + rg / t_len, tt = rg % t_len;
      val = to_f(q[((size_t)(b * t_len + tt) * h + hh) * DH + d]) * scale;
    }
    qs[e] = val;
  }

  int qpos[kRowsPerWarp];
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  const int q0 = CAUSAL ? qoff[b] : 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rg = row0 + warp * kRowsPerWarp + i;
    qpos[i] = q0 + (rg < nrows ? rg % t_len : 0);
    m_r[i] = kNeg;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }
  // the tile's last query position (causal block skipping)
  const int last_row = min(row0 + kRowsPerCta, nrows) - 1;
  int qmax = q0 + t_len - 1;
  if (CAUSAL && row0 / t_len == last_row / t_len)
    qmax = q0 + last_row % t_len;

  const int* idx_row = idx + ((size_t)b * hk + kh) * nsel;
  const int* vlen_row = vlen + ((size_t)b * hk + kh) * nsel;

  // the first live key tile at or after (j, s0): CTA-uniform
  auto find = [&](int j, int s0, int& oj, int& os, int& onv,
                  int& opage) -> bool {
    while (j < nsel) {
      int nv = vlen_row[j];
      nv = nv > bs ? bs : nv;
      const bool live = nv > 0 && !(CAUSAL && j * bs > qmax);
      if (live && s0 < nv) {
        int p = idx_row[j];
        opage = p < 0 ? 0 : (p > np - 1 ? np - 1 : p);
        oj = j;
        os = s0;
        onv = nv;
        return true;
      }
      ++j;
      s0 = 0;
    }
    return false;
  };

  uint4 kraw[NV], vraw[NV];
  auto load = [&](int page, int s0, int nv) {
    const size_t base = (size_t)page * bs;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (i * kThreads + threadIdx.x) * VEC;
      const int key = e / DH, d = e % DH;
      const int s = s0 + key;
      if (s < nv) {
        const size_t off = ((base + s) * hk + kh) * DH + d;
        kraw[i] = *reinterpret_cast<const uint4*>(kpool + off);
        vraw[i] = *reinterpret_cast<const uint4*>(vpool + off);
      } else {
        kraw[i] = make_uint4(0u, 0u, 0u, 0u);
        vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (i * kThreads + threadIdx.x) * VEC;
      const int key = e / DH, d = e % DH;
      float kf[VEC], vf[VEC];
      unpack(kraw[i], kf, T());
      unpack(vraw[i], vf, T());
#pragma unroll
      for (int c = 0; c < VEC; c += 4) {
        *reinterpret_cast<float4*>(ks + key * KS + d + c) =
            make_float4(kf[c], kf[c + 1], kf[c + 2], kf[c + 3]);
        *reinterpret_cast<float4*>(vs + key * KS + d + c) =
            make_float4(vf[c], vf[c + 1], vf[c + 2], vf[c + 3]);
      }
    }
  };

  int j = 0, s0 = 0, nv = 0, page = 0;
  bool have = find(0, 0, j, s0, nv, page);
  if (have) load(page, s0, nv);
  const float* qw = qs + warp * kRowsPerWarp * DH;
  const float* kr = ks + lane * KS;
  while (have) {
    __syncthreads();                  // the previous tile is consumed
    store();
    __syncthreads();
    int nj = 0, ns = 0, nnv = 0, npage = 0;
    const bool more = find(j, s0 + kKeys, nj, ns, nnv, npage);
    if (more) load(npage, ns, nnv);   // in flight during this tile's math

    // ---- scores: lane = key, 8 rows per warp
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * DH + d);
        sc[i] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y,
                fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, sc[i]))));
      }
    }

    // ---- online softmax per row, then acc += p V
    const int s = s0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = s < nv;
      if (CAUSAL) ok = ok && (j * bs + s <= qpos[i]);
      const float logit = ok ? sc[i] : kNeg;
      const float m_new = fmaxf(m_r[i], warp_max(logit));
      p[i] = ok ? expf(logit - m_new) : 0.f;
      const float corr = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * corr + warp_sum(p[i]);
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
    }
    const int nk = min(kKeys, nv - s0);
    for (int key = 0; key < nk; ++key) {
      const float4 vv =
          *reinterpret_cast<const float4*>(vs + key * KS + lane * DPL);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pk = __shfl_sync(0xffffffffu, p[i], key);
        acc[i][0] = fmaf(pk, vv.x, acc[i][0]);
        acc[i][1] = fmaf(pk, vv.y, acc[i][1]);
        acc[i][2] = fmaf(pk, vv.z, acc[i][2]);
        acc[i][3] = fmaf(pk, vv.w, acc[i][3]);
      }
    }
    j = nj;
    s0 = ns;
    nv = nnv;
    page = npage;
    have = more;
  }

  // ---- emit partials
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int rg = row0 + warp * kRowsPerWarp + i;
    if (rg >= nrows) continue;
    const int hh = kh * rep + rg / t_len, tt = rg % t_len;
    const size_t o = ((size_t)b * h + hh) * t_len + tt;
    if (lane == 0) {
      m_out[o] = m_r[i];
      l_out[o] = l_r[i];
    }
    *reinterpret_cast<float4*>(acc_out + o * DH + lane * DPL) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T, int DH, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const int* idx,
           const int* vlen, const int* qoff, float* m, float* l, float* acc,
           int b, int t, int h, int hk, int np, int bs, int nsel, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  auto kern = block_attention_kernel<T, DH, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (h / hk) * t;
  dim3 grid((rows + kRowsPerCta - 1) / kRowsPerCta, hk, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), idx, vlen, qoff, m, l, acc, t, h, hk, np, bs,
      nsel, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL>
int dispatch_dh(int dh, const void* q, const void* k, const void* v,
                const int* idx, const int* vlen, const int* qoff, float* m,
                float* l, float* acc, int b, int t, int h, int hk, int np,
                int bs, int nsel, float scale, cudaStream_t s) {
  if (dh == 128)
    return launch<T, 128, CAUSAL>(q, k, v, idx, vlen, qoff, m, l, acc, b, t,
                                  h, hk, np, bs, nsel, scale, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  qoff == nullptr selects K1 (no causal
// mask), otherwise K2.  Returns 0, a cudaError_t, or -1 for an unsupported
// head dim / dtype.  The pool, q and the outputs must be 16-byte aligned.
extern "C" int block_attention_launch(const void* q, const void* k,
                                      const void* v, const int* idx,
                                      const int* vlen, const int* qoff,
                                      float* m, float* l, float* acc, int b,
                                      int t, int h, int hk, int dh, int np,
                                      int bs, int nsel, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool causal = qoff != nullptr;
  if (dtype == 0)
    return causal ? dispatch_dh<float, true>(dh, q, k, v, idx, vlen, qoff, m, l,
                                             acc, b, t, h, hk, np, bs, nsel,
                                             scale, s)
                  : dispatch_dh<float, false>(dh, q, k, v, idx, vlen, qoff, m,
                                              l, acc, b, t, h, hk, np, bs,
                                              nsel, scale, s);
  if (dtype == 1)
    return causal ? dispatch_dh<__nv_bfloat16, true>(dh, q, k, v, idx, vlen,
                                                     qoff, m, l, acc, b, t, h,
                                                     hk, np, bs, nsel, scale, s)
                  : dispatch_dh<__nv_bfloat16, false>(dh, q, k, v, idx, vlen,
                                                      qoff, m, l, acc, b, t,
                                                      h, hk, np, bs, nsel,
                                                      scale, s);
  return -1;
}
