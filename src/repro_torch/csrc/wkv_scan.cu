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
// not written.
//
// The invariant the engine relies on.  Every step runs the same
// arithmetic in the same order whatever T, n_valid and update are: each
// lane's partials, the fixed tree that sums them over row groups and the
// state update are written with explicitly rounded intrinsics (__fmul_rn,
// __fmaf_rn, __fadd_rn), which the compiler neither contracts nor
// reorders.  So a read-only verify of 6 tokens followed by an advance of
// 1 + accepted tokens gives exactly the y and the state that one-token
// steps give, as the autoregressive oracle (core/reference.py) takes them.
//
// What bounds it on the H100.  Per token and head 7 dk^2 fp32 operations
// against 5 dk fp32 loads and stores: at rwkv6-3b widths (H = 40, dk = 64)
// and T = 256 about 0.29 GFLOP and 14 MB, a few microseconds of either.
// The recurrence is sequential in t, so the kernel is bound by the time of
// its T dependent steps: what the design shortens is each step's
// dependent chain and the work around it, and at batch 1 it must still
// spread the 40 heads over the 132 SMs.
//
// The design.
//   - More CTAs: a CTA owns 16 columns of one (row, head); the grid is
//     (dk/16, H, B), 160 CTAs of 64 threads at rwkv6-3b widths.
//   - A short dependent chain: lane (row group rg, column group cg) holds
//     the 4 x 4 state entries of rows 4rg .. 4rg+3 and columns 4cg ..
//     4cg+3 in registers.  A step reads 4 16-byte vectors (r, k, w of its
//     rows, v of its columns), issued one step ahead, and does 64 FMAs in
//     chains of 4; the only dependence carried from step to step is one
//     FMA per state entry.
//   - The sum over row groups leaves the step: each step stores its
//     lane's 4 partials to shared memory, and after the tile every
//     (token, column) sums its 16 row groups by a fixed pairwise tree and
//     writes y, a warp writing two 64-byte runs.  Summing with shuffles
//     inside the step would put their latency on every step's in-order
//     path (measured slower; PERF.md).
//   - Staged inputs: r, k, w (all 64 rows) and v (the CTA's 16 columns)
//     of 16-token tiles are copied to shared memory with 16-byte cp.async,
//     each thread copying one fixed chunk of every token (no div/mod),
//     into a ring of three tiles: the next two tiles' copies are in flight
//     while one tile's steps run.  There is one barrier per tile (which
//     also frees the partials of the tile before, summed right after it).
//     Rings of two or four tiles measure the same (tools/wkv_breakdown.py).
//   - s0 and s_out move as 16-byte vectors of 4 columns.
// ptxas (sm_90a, wkv_kernel<64>): 103 registers, 0 bytes spilled, 32 KB of
// static shared memory (the partials) and 40,768 bytes of dynamic (the
// staged tiles).  The kernel allocates nothing and launches on the
// caller's stream.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;               // state columns per CTA
constexpr int kSub = 4;                 // rows and columns per lane
constexpr int kColGroups = kCols / kSub;
constexpr int kTile = 16;               // tokens per staged tile
constexpr int kStages = 3;              // tiles in the staging ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N groups of copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DK>
__host__ __device__ constexpr int row_groups() { return DK / kSub; }
template <int DK>
__host__ __device__ constexpr int threads() {
  return row_groups<DK>() * kColGroups;
}
// floats of one staged token: r, k, w (dk rows each), then v (kCols)
template <int DK>
__host__ __device__ constexpr int tok_floats() { return 3 * DK + kCols; }
// dynamic shared memory: the staged tiles, and one token of slack that
// the look-ahead load past the last tile may read
template <int DK>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kStages * kTile + 1) * tok_floats<DK>();
}

// What one lane reads of a staged token: r, k, w of its 4 rows and v of
// its 4 columns.
struct Tok {
  float4 r, k, w, v;
};
template <int DK>
__device__ __forceinline__ Tok load_tok(const float* x, int i0, int j0) {
  Tok t;
  t.r = *reinterpret_cast<const float4*>(x + i0);
  t.k = *reinterpret_cast<const float4*>(x + DK + i0);
  t.w = *reinterpret_cast<const float4*>(x + 2 * DK + i0);
  t.v = *reinterpret_cast<const float4*>(x + 3 * DK + j0);
  return t;
}

// One step for one lane: its 4 rows' partials of y_t for its 4 columns
// (each a chain over the rows in order) and, with UPD, the update of its
// 4 x 4 state entries.
template <bool UPD>
__device__ __forceinline__ float4 wkv_step(const Tok& x,
                                           float (&s)[kSub][kSub],
                                           const float (&uu)[kSub]) {
  const float rr[kSub] = {x.r.x, x.r.y, x.r.z, x.r.w};
  const float kk[kSub] = {x.k.x, x.k.y, x.k.z, x.k.w};
  const float ww[kSub] = {x.w.x, x.w.y, x.w.z, x.w.w};
  const float vv[kSub] = {x.v.x, x.v.y, x.v.z, x.v.w};
  float acc[kSub] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ii = 0; ii < kSub; ++ii)
#pragma unroll
    for (int jj = 0; jj < kSub; ++jj) {
      const float kv = __fmul_rn(kk[ii], vv[jj]);
      acc[jj] = __fmaf_rn(rr[ii], __fmaf_rn(uu[ii], kv, s[ii][jj]), acc[jj]);
      if (UPD) s[ii][jj] = __fmaf_rn(ww[ii], s[ii][jj], kv);
    }
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int DK>
__global__ void __launch_bounds__(threads<DK>())
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           const int* __restrict__ n_valid, float* __restrict__ y,
           float* __restrict__ s_out, int t_len, int h, int update) {
  constexpr int kGroups = row_groups<DK>();
  constexpr int kThreads = threads<DK>();
  constexpr int kTok = tok_floats<DK>();
  // the copy layout: thread tid copies 16-byte chunk tid % 16 of r, k or
  // w (tid / 16 = 0, 1, 2) for every token, or (tid / 16 = 3) chunk
  // tid % 4 of v for every 4th token
  static_assert(kThreads == 64 && DK / 4 == 16 && kCols / 4 == 4,
                "copy layout");
  static_assert(kGroups == 16, "flush tree");
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);  // [kStages][kTile][kTok]
  // per-lane partials of y, [2][kTile][kGroups][kCols]: a separate object
  // from the staged inputs
  __shared__ __align__(16) float part[2][kTile][kGroups][kCols];

  const int c0 = blockIdx.x * kCols;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;             // columns c0 + 4cg .. +3
  const int rg = tid / kColGroups;             // rows 4rg .. 4rg+3
  const int i0 = rg * kSub, j0 = cg * kSub;
  const size_t tstride = (size_t)h * DK;
  const size_t xbase = ((size_t)b * t_len * h + hh) * DK;  // [b, 0, hh, 0]
  const size_t sbase = ((size_t)b * h + hh) * DK * DK + c0 + j0;
  const int ntiles = (t_len + kTile - 1) / kTile;

  const int arr = tid >> 4, chunk = tid & 15;
  const float* const csrc =
      arr == 3 ? v + xbase + c0 + 4 * (chunk & 3)
               : (arr == 0 ? r : arr == 1 ? k : w) + xbase + 4 * chunk;
  const int cdst = arr == 3 ? 3 * DK + 4 * (chunk & 3) : arr * DK + 4 * chunk;
  const int tok0 = arr == 3 ? chunk >> 2 : 0;
  const int tstep = arr == 3 ? 4 : 1;
  auto stage = [&](int tile) {     // one commit group per call
    if (tile < ntiles) {
      float* buf = sm + (tile % kStages) * kTile * kTok + cdst;
      const int tt0 = tile * kTile;
      const int n = min(kTile, t_len - tt0);
      for (int tok = tok0; tok < n; tok += tstep)
        cp_async16(buf + tok * kTok, csrc + (size_t)(tt0 + tok) * tstride);
    }
    cp_async_commit();
  };
  // y of a finished tile: each (token, column) sums its row groups'
  // partials by a fixed pairwise tree; a warp writes two 64-byte runs
  auto flush = [&](int tile) {
    const int tt0 = tile * kTile;
    const int n = min(kTile, t_len - tt0);
    for (int e = tid; e < n * kCols; e += kThreads) {
      const int tok = e / kCols, cc = e % kCols;
      float p[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) p[g] = part[tile & 1][tok][g][cc];
#pragma unroll
      for (int g = 0; g < 8; ++g) p[g] = __fadd_rn(p[2 * g], p[2 * g + 1]);
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g] = __fadd_rn(p[2 * g], p[2 * g + 1]);
#pragma unroll
      for (int g = 0; g < 2; ++g) p[g] = __fadd_rn(p[2 * g], p[2 * g + 1]);
      y[xbase + (size_t)(tt0 + tok) * tstride + c0 + cc] =
          __fadd_rn(p[0], p[1]);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);
  float s[kSub][kSub], uu[kSub];
#pragma unroll
  for (int ii = 0; ii < kSub; ++ii) {
    const float4 s4 = *reinterpret_cast<const float4*>(
        s0 + sbase + (size_t)(i0 + ii) * DK);
    s[ii][0] = s4.x; s[ii][1] = s4.y; s[ii][2] = s4.z; s[ii][3] = s4.w;
    uu[ii] = u[hh * DK + i0 + ii];
  }
  const int nv = n_valid[b];

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();  // this tile has landed ...
    __syncthreads();          // ... for every thread; the tile before it
                              // (inputs and partials) is no longer read
    if (tile > 0) flush(tile - 1);
    stage(tile + kStages - 1);  // into the buffer the tile before read
    const float* buf = sm + (tile % kStages) * kTile * kTok;
    const int tt0 = tile * kTile;
    const int n = min(kTile, t_len - tt0);
    const int nupd = min(max(nv - tt0, 0), n);   // steps that update
    // each step's shared loads are issued one step ahead
    Tok cur = load_tok<DK>(buf, i0, j0);
    int tok = 0;
#pragma unroll 2
    for (; tok < nupd; ++tok) {
      const Tok nxt = load_tok<DK>(buf + (tok + 1) * kTok, i0, j0);
      *reinterpret_cast<float4*>(&part[tile & 1][tok][rg][j0]) =
          wkv_step<true>(cur, s, uu);
      cur = nxt;
    }
#pragma unroll 2
    for (; tok < n; ++tok) {      // past the valid prefix: y only
      const Tok nxt = load_tok<DK>(buf + (tok + 1) * kTok, i0, j0);
      *reinterpret_cast<float4*>(&part[tile & 1][tok][rg][j0]) =
          wkv_step<false>(cur, s, uu);
      cur = nxt;
    }
  }
  if (ntiles > 0) {
    __syncthreads();
    flush(ntiles - 1);
  }
  if (update) {
#pragma unroll
    for (int ii = 0; ii < kSub; ++ii)
      *reinterpret_cast<float4*>(s_out + sbase + (size_t)(i0 + ii) * DK) =
          make_float4(s[ii][0], s[ii][1], s[ii][2], s[ii][3]);
  }
}

}  // namespace

// All tensors fp32, contiguous and 16-byte aligned.  Returns 0, a
// cudaError_t, or -1 for an unsupported shape.
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u, const float* s0,
                          const int* n_valid, float* y, float* s_out, int b,
                          int t, int h, int dk, int update, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || t < 0) return -1;
  if (dk != 64) return -1;
  auto kern = wkv_kernel<64>;
  constexpr size_t smem = smem_bytes<64>();
  // set once per process: the rwkv path launches this ~9000 times a run
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(64 / kCols, h, b);
  kern<<<grid, threads<64>(), smem, s>>>(r, k, v, w, u, s0, n_valid, y,
                                         s_out, t, h, update);
  return (int)cudaGetLastError();
}
