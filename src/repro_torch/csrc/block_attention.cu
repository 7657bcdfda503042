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
// validity mask (a block with vlen 0 is skipped), so a row whose blocks are
// all empty comes out exactly m = -1e30, l = 0, acc = 0 (partial rows of a
// fused tick and the null page depend on this).
//
// Two routes, chosen by dtype:
//
// bf16: tensor cores (block_attention_mma_kernel).  What bounds it on the
// H100 at llama3.1-8b widths (H=32, Hk=8, Dh=128, block 128):
//   - K1 routed Partial (T=61, 35 slots, 32 live): 18 MB of K/V, 244 query
//     rows per KV element, ~3.7 GFLOP: bound by bytes (~5.5 us), and at
//     batch 1 only 8 heads x 4 row tiles = 32 (row tile, head) pairs, so
//     the card is filled only by splitting each block list (split-KV);
//   - K1 Full (T=61, 8229 keys) and Refresh (T=156): the same, twice and
//     2.6x the work;
//   - K2 prefill chunk (T=256 after 7936 tokens): 1024 rows x 8192 keys,
//     ~34 GFLOP (x1.5 for the split P below): bound by tensor-core
//     operations (~0.034 ms), 16 row tiles x 8 heads = 128 CTAs.
// The design.  One CTA of 4 warps per (64 query rows, KV head, chunk, row);
// each warp owns 16 rows (rep = 4 query heads packed into the M dimension;
// padded rows are zero and never written).  Q is staged once and held as
// mma A fragments.  Keys stream in tiles of 64 (one 128-key page = 2 tiles)
// through a 3-stage ring in shared memory filled by 16-byte cp.async
// (keys past a block's valid length are zero-filled): the copies of tiles
// j+1 and j+2 are in flight during the math on tile j, with one barrier
// per tile (Q is staged in the third stage's slot until its fragments are
// in registers).  Rows are padded to 272 bytes so the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups.
//   S = Q K^T: mma.sync m16n8k16 bf16 -> fp32, 1/sqrt(Dh) applied to the
//   fp32 logits.  Online softmax in registers (base 2, on the special-
//   function unit): a row's max and sum reduce
//   over the 4 lanes of the mma fragment's quad (two shuffles), no
//   CTA-wide reduction.  P V: P is split into bf16 hi = bf16(p) and
//   lo = bf16(p - hi) and both go through the tensor cores (1.5x the
//   product work): rounding P once to bf16 misses the 1e-4 check at the
//   path's shapes, hi + lo meets it (tests/test_torch_kernels.py
//   emulates both).
// Split-KV (K1 only).  Each (row, KV head) list is cut by live rank into S
// contiguous chunks (S from the shapes, ops.kv_splits; chunk s takes live
// blocks [s*L/S, (s+1)*L/S)).  With S > 1 each CTA writes its chunk's
// partials to scratch, and the last CTA of each (row tile, head) -- counted
// through an int32 counter that the wrapper owns and the last CTA resets to
// 0 -- merges them by merge_attn_partials' rule (m = max m_s, corr_s =
// exp(m_s - m), l = sum l_s corr_s, acc = sum acc_s corr_s): one launch per
// call, no memset.  An empty chunk gives (-1e30, 0, 0) and drops out; an
// all-empty row stays exact.  K2 is not split (its rows fill the card); a
// CTA skips blocks wholly after its last query, and the row tiles with the
// most live blocks are launched first.
// What holds it back now (tools/attention_breakdown.py times the kernel
// with parts removed): not the loads -- with later tiles not copied at all
// it is only 10-25% faster -- but the math on each tile: with 16 rows per
// warp every warp reads the whole K and V tile from shared memory through
// ldmatrix, and mma.sync runs well below the tensor cores' rate.  wgmma
// (one 64-row warpgroup reading each tile once) is the next step.  The
// split's merge is a serial tail of ~10 us at the routed shape.
//
// fp32: CUDA cores (block_attention_kernel), for the fp32 losslessness runs
// and fp32 models (TF32 would meet neither the 1e-4 check nor fp32
// losslessness).  One CTA of 4 warps per (32 query rows, KV head, row);
// tiles of 32 keys in shared memory as fp32, q pre-scaled by 1/sqrt(Dh) in
// fp32 as the plain version does; lane i scores key i, each lane owns Dh/32
// dims of acc.
//
// Head dims.  Both routes are templated on Dh and built for 64 (the
// trained tiny-dense pair: H=4, Hk=2) and 128 (llama3.1-8b, qwen3-8b).  A
// tile never spans two blocks: with blocks shorter than the tile (block 16
// under 64-key or 32-key tiles) each tile holds one block's keys and the
// rest of it is zero-filled and masked, so a block of 16 costs a whole
// tile of math.  Correct, not fast: those shapes are tiny.
//
// The kernels allocate nothing and launch on the caller's stream.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;        // query rows per CTA
constexpr int kKeys = 64;                 // keys per tile
constexpr int kStages = 3;           // tiles in flight: kStages - 1
constexpr int kMaxSplits = 64;  // the merge's 2 x kRows x S floats fit the ring
constexpr int kMaxSel = 16384;  // blocks per list: 2M tokens at block 128

// The sizes that follow from the head dim DH (64 or 128).
template <int DH>
struct Shape {
  static constexpr int kLd = DH + 8;      // padded smem row (272 / 144 B)
  static constexpr int kTile = kKeys * kLd;  // elements of a K or V tile
  static constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  static constexpr int kCopies = kKeys * kChunks / kThreads;  // per thread
  static constexpr int kK16 = DH / 16;    // k-steps of Q K^T, n-pairs of P V
  static constexpr int kN8 = DH / 8;      // accumulator fragments per row
  static_assert(kRows * kChunks / kThreads == kCopies, "q tile = key tile");
  static_assert(kKeys * kChunks % kThreads == 0, "whole copies");
  static_assert(kK16 % 2 == 0, "the last P V step (odd) reads bb[1]");
  static_assert(kRows * kLd <= kTile, "Q fits a K tile");
  // the merge's 2 x kRows x kMaxSplits floats fit the K/V ring
  static_assert(2 * kRows * kMaxSplits * 4 <= 2 * kStages * kTile * 2,
                "merge scratch fits the ring");
};

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* idx;
  const int* vlen;
  const int* qoff;        // nullptr: K1; else K2 (causal)
  float* m;
  float* l;
  float* acc;
  float* part_m;          // split scratch [slots, S, kRows]
  float* part_l;
  float* part_acc;        // [slots, S, kRows, Dh]
  int* counters;          // [slots], 0 between launches
  int b, t, h, hk, np, bs, nsel, splits, ntiles;
  float scale;
};

template <int DH>
size_t mma_smem_bytes(int nsel) {
  return sizeof(bf16) * 2 * kStages * Shape<DH>::kTile +
         sizeof(int) * (size_t)nsel;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

// 2^x on the special-function unit (no denormal results)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// causal launch order: rank k -> row tile, latest queries (most live
// blocks) first
__device__ __forceinline__ int causal_tile(int k, int ntiles, int t,
                                           int rep) {
  if (t % kRows == 0) {
    const int per = t / kRows;                 // tiles per query head
    return (k % rep) * per + per - 1 - k / rep;
  }
  return ntiles - 1 - k;
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 2)
block_attention_mma_kernel(const Args a) {
  using S = Shape<DH>;
  constexpr int kDh = DH, kLd = S::kLd, kTile = S::kTile;
  constexpr int kChunks = S::kChunks, kCopies = S::kCopies;
  constexpr int kK16 = S::kK16, kN8 = S::kN8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* skv = reinterpret_cast<bf16*>(smem);         // stage s: K, V tiles
  int* list = reinterpret_cast<int*>(skv + 2 * kStages * kTile);
  // Q [kRows][kLd] sits in the last stage's K slot until its fragments
  // are in registers
  bf16* sq = skv + 2 * (kStages - 1) * kTile;
  __shared__ int s_warp[kWarps];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.h / a.hk;
  const int nrows = rep * a.t;
  int c = blockIdx.x;
  const int kh = c % a.hk;
  c /= a.hk;
  const int b = c % a.b;
  c /= a.b;
  const int split = c % a.splits;
  c /= a.splits;
  const int tile = CAUSAL ? causal_tile(c, a.ntiles, a.t, rep) : c;
  const int row0 = tile * kRows;
  const int q0 = CAUSAL ? a.qoff[b] : 0;
  // the tile's first and last query positions (causal block skipping)
  const int last = min(row0 + kRows, nrows) - 1;
  int qmin = q0, qmax = q0 + a.t - 1;
  if (row0 / a.t == last / a.t) {
    qmin = q0 + row0 % a.t;
    qmax = q0 + last % a.t;
  }
  const size_t lrow = ((size_t)b * a.hk + kh) * a.nsel;
  const int* idx_row = a.idx + lrow;
  const int* vlen_row = a.vlen + lrow;
  // keys of slot j this CTA attends to (<= 0: the block is skipped)
  auto keys_of = [&](int j) -> int {
    int nk = min(vlen_row[j], a.bs);
    if (CAUSAL) nk = min(nk, qmax - j * a.bs + 1);
    return nk;
  };

  // ---- this chunk's live blocks: ranks [lo, hi) of the row's live list
  int total = 0;
  for (int base = 0; base < a.nsel; base += kThreads) {
    const int j = base + tid;
    total += __syncthreads_count(j < a.nsel && keys_of(j) > 0);
  }
  const int lo = (int)((long long)split * total / a.splits);
  const int hi = (int)((long long)(split + 1) * total / a.splits);
  int seen = 0;
  for (int base = 0; base < a.nsel && seen < hi; base += kThreads) {
    const int j = base + tid;
    const bool live = j < a.nsel && keys_of(j) > 0;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int r = seen + __popc(bal & ((1u << lane) - 1u)), sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) r += s_warp[w];
      sum += s_warp[w];
    }
    if (live && r >= lo && r < hi) list[r - lo] = j;
    seen += sum;
    __syncthreads();
  }
  const int nlist = hi - lo;

  // ---- async copies: the Q tile, and one 64-key tile of K and V
  auto load_q = [&]() {
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = i * kThreads + tid, r = e / kChunks, ch = e % kChunks;
      const int rg = row0 + r;
      const bool ok = rg < nrows;
      const size_t off =
          ok ? (((size_t)b * a.t + rg % a.t) * a.h + kh * rep + rg / a.t) *
                   kDh
             : 0;
      cp_async16(sq + r * kLd + ch * 8, a.q + off + ch * 8, ok);
    }
  };
  auto load_kv = [&](int li, int s0, int stage) {
    const int j = list[li];
    const int nk = keys_of(j);
    int pg = idx_row[j];
    pg = pg < 0 ? 0 : (pg > a.np - 1 ? a.np - 1 : pg);
    const size_t base = ((size_t)pg * a.bs * a.hk + kh) * kDh;
    const size_t key_stride = (size_t)a.hk * kDh;
    bf16* dk = skv + 2 * stage * kTile;
    bf16* dv = dk + kTile;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int e = i * kThreads + tid, r = e / kChunks, ch = e % kChunks;
      const bool ok = s0 + r < nk;
      const size_t off = base + (ok ? s0 + r : 0) * key_stride + ch * 8;
      cp_async16(dk + r * kLd + ch * 8, a.k + off, ok);
      cp_async16(dv + r * kLd + ch * 8, a.v + off, ok);
    }
  };

  // this thread's two rows of the warp's 16: quad row g and g + 8
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = row0 + 16 * warp + (lane >> 2) + 8 * r;
    qpos[r] = q0 + (rg < nrows ? rg % a.t : a.t - 1);
  }
  // logits are kept in base 2 (scaled by log2 e) until they are written
  const float scale2 = a.scale * 1.4426950408889634f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.f, 0.f};
  float o[kN8][4];
#pragma unroll
  for (int d = 0; d < kN8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  uint32_t qf[kK16][4];

  // tile cursor: the next tile of the list after (li, s0)
  auto next_tile = [&](int& li_, int& s0_) {
    s0_ += kKeys;
    if (s0_ >= keys_of(list[li_])) {
      ++li_;
      s0_ = 0;
    }
  };
  int ili = 0, is0 = 0, istage = 0;            // the next tile to copy
  auto issue = [&]() {
    if (ili < nlist) {
      load_kv(ili, is0, istage);
      next_tile(ili, is0);
    }
    cp_async_commit();
    istage = istage == kStages - 1 ? 0 : istage + 1;
  };
  if (nlist > 0) load_q();
  for (int i = 0; i < kStages - 1; ++i) issue();   // Q and the first tiles
  int li = 0, s0 = 0, stage = 0;
  for (int it = 0; li < nlist; ++it) {
    cp_async_wait<kStages - 2>();     // this tile has landed ...
    __syncthreads();                  // ... for all; the last one is consumed
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kK16; ++kk)
        ldsm_x4(qf[kk], sq + (16 * warp + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);
      __syncthreads();                // Q is read before its slot refills
    }
    issue();                          // in flight during this tile's math
    const int j = list[li];
    const int nk = keys_of(j);
    const bf16* tk = skv + 2 * stage * kTile;
    const bf16* tv = tk + kTile;

    // ---- S = Q K^T (16 rows x 64 keys per warp)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, tk + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
    }

    // ---- scale, mask, online softmax over the quad
    const int kpos0 = j * a.bs + s0;
    const bool full =
        s0 + kKeys <= nk && (!CAUSAL || kpos0 + kKeys - 1 <= qmin);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (!full) {
          const int key = s0 + 8 * n + 2 * (lane & 3) + (e & 1);
          bool ok = key < nk;
          if (CAUSAL) ok = ok && j * a.bs + key <= qpos[e >> 1];
          x = ok ? x : kNeg;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m_r[r], mx[r]);
      corr[r] = exp2f(m_r[r] - mn);
      m_r[r] = mn;
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x > -1e29f ? ex2(x - m_r[e >> 1]) : 0.f;
        s[n][e] = p;
        l_r[e >> 1] += p;
      }
    }
#pragma unroll
    for (int d = 0; d < kN8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // ---- acc += (P_hi + P_lo) V
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
      split_bf16(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
      split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
      // hi of dims 16dp.. beside lo of dims 16(dp-1).., so the two
      // products into one accumulator are not back to back
      uint32_t bb[2][4];
#pragma unroll
      for (int dp = 0; dp < kK16; ++dp) {
        uint32_t (&bc)[4] = bb[dp & 1];
        uint32_t (&bp)[4] = bb[(dp + 1) & 1];
        ldsm_x4_t(bc, tv + (16 * kt + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               kLd +
                           dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, bc[0], bc[1]);
        mma_bf16(o[2 * dp + 1], ph, bc[2], bc[3]);
        if (dp > 0) {
          mma_bf16(o[2 * dp - 2], pl, bp[0], bp[1]);
          mma_bf16(o[2 * dp - 1], pl, bp[2], bp[3]);
        }
      }
      mma_bf16(o[kN8 - 2], pl, bb[1][0], bb[1][1]);   // kK16 - 1 is odd
      mma_bf16(o[kN8 - 1], pl, bb[1][2], bb[1][3]);
    }
    next_tile(li, s0);
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }

  // ---- emit: straight to the outputs, or this chunk's partials
  const int slot = (b * a.hk + kh) * a.ntiles + tile;
  const bool direct = a.splits == 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rl = 16 * warp + (lane >> 2) + 8 * r;
    const int rg = row0 + rl;
    if (rg >= nrows) continue;
    size_t oi;
    float *mo, *lo_out, *ao;
    if (direct) {
      oi = ((size_t)b * a.h + kh * rep + rg / a.t) * a.t + rg % a.t;
      mo = a.m;
      lo_out = a.l;
      ao = a.acc;
    } else {
      oi = ((size_t)slot * a.splits + split) * kRows + rl;
      mo = a.part_m;
      lo_out = a.part_l;
      ao = a.part_acc;
    }
    if ((lane & 3) == 0) {
      mo[oi] = m_r[r] > -1e29f ? m_r[r] * 0.6931471805599453f : kNeg;
      lo_out[oi] = l_r[r];
    }
#pragma unroll
    for (int d = 0; d < kN8; ++d)
      *reinterpret_cast<float2*>(ao + oi * kDh + 8 * d + 2 * (lane & 3)) =
          make_float2(o[d][2 * r], o[d][2 * r + 1]);
  }
  if (direct) return;

  // ---- the last CTA of this (row tile, head) merges the S chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(a.counters + slot, 1) == a.splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int vrows = min(kRows, nrows - row0);
  const int ns = a.splits;
  const size_t pbase = (size_t)slot * ns * kRows;
  // the K/V ring is free now: per (row, chunk) m, then corr, and l
  float* sm_ = reinterpret_cast<float*>(skv);
  float* sl_ = sm_ + kRows * ns;
  for (int e = tid; e < vrows * ns; e += kThreads) {
    const int rl = e / ns, sp = e % ns;
    sm_[e] = __ldcg(a.part_m + pbase + sp * kRows + rl);
    sl_[e] = __ldcg(a.part_l + pbase + sp * kRows + rl);
  }
  __syncthreads();
  for (int rl = tid; rl < vrows; rl += kThreads) {
    float mm = kNeg, ll = 0.f;
    for (int sp = 0; sp < ns; ++sp) mm = fmaxf(mm, sm_[rl * ns + sp]);
    for (int sp = 0; sp < ns; ++sp) {
      const float cr = expf(sm_[rl * ns + sp] - mm);
      ll += sl_[rl * ns + sp] * cr;
      sm_[rl * ns + sp] = cr;
    }
    const int rg = row0 + rl;
    const size_t oi =
        ((size_t)b * a.h + kh * rep + rg / a.t) * a.t + rg % a.t;
    a.m[oi] = mm;
    a.l[oi] = ll;
  }
  __syncthreads();
  constexpr int kC4 = kDh / 4;
  constexpr int kBatch = 8;                  // chunk loads in flight
  const size_t cstride = (size_t)kRows * kC4;  // float4s between chunks
  for (int e = tid; e < vrows * kC4; e += kThreads) {
    const int rl = e / kC4, c4 = e % kC4;
    const float4* src =
        reinterpret_cast<const float4*>(a.part_acc + (pbase + rl) * kDh) + c4;
    const float* cr = sm_ + rl * ns;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < ns; sp0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (sp0 + i < ns) v[i] = __ldcg(src + (sp0 + i) * cstride);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (sp0 + i < ns) {
          const float c_ = cr[sp0 + i];
          aa.x += v[i].x * c_;
          aa.y += v[i].y * c_;
          aa.z += v[i].z * c_;
          aa.w += v[i].w * c_;
        }
      }
    }
    const int rg = row0 + rl;
    const size_t oi =
        ((size_t)b * a.h + kh * rep + rg / a.t) * a.t + rg % a.t;
    reinterpret_cast<float4*>(a.acc + oi * kDh)[c4] = aa;
  }
  if (tid == 0) a.counters[slot] = 0;       // ready for the next launch
}

template <int DH, bool CAUSAL>
int launch_mma(const Args& a, cudaStream_t stream) {
  if (a.nsel > kMaxSel) return -1;
  const size_t smem = mma_smem_bytes<DH>(a.nsel);
  auto kern = block_attention_mma_kernel<DH, CAUSAL>;
  // once per kernel, for the longest list; each launch asks for its own
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem_bytes<DH>(kMaxSel));
  if (attr != cudaSuccess) return (int)attr;
  const long long grid = (long long)a.ntiles * a.splits * a.b * a.hk;
  if (grid <= 0) return 0;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kF32Rows = kF32Warps * kRowsPerWarp;   // 32 query rows
constexpr int kF32Keys = 32;                         // keys per tile

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
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kF32Rows * DH + 2 * kF32Keys * (DH + 4));
}

// DPL consecutive floats of shared or global memory, as one vector
template <int DPL>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float (&x)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
  __device__ static void store(float* p, const float (&x)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(kF32Threads)
block_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kpool,
                       const float* __restrict__ vpool,
                       const int* __restrict__ idx, const int* __restrict__ vlen,
                       const int* __restrict__ qoff,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ acc_out,
                       int t_len, int h, int hk, int np, int bs, int nsel,
                       float scale) {
  constexpr int kDh = DH;
  constexpr int KS = kDh + 4;                       // padded smem row stride
  constexpr int NV = kF32Keys * kDh / 4 / kF32Threads;  // float4 loads
  constexpr int DPL = kDh / 32;                     // dims per lane
  static_assert(DPL == 2 || DPL == 4, "acc update: a float2 or float4");
  static_assert(kF32Keys * kDh % (4 * kF32Threads) == 0, "whole loads");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [32 rows][Dh]
  float* ks = qs + kF32Rows * kDh;                 // [kF32Keys][KS]
  float* vs = ks + kF32Keys * KS;                  // [kF32Keys][KS]

  const int tile = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = h / hk;
  const int nrows = rep * t_len;
  const int row0 = tile * kF32Rows;

  // ---- stage this tile's queries (scaled), zero for padded rows
  for (int e = threadIdx.x; e < kF32Rows * kDh; e += kF32Threads) {
    const int r = e / kDh, d = e % kDh;
    const int rg = row0 + r;
    float val = 0.f;
    if (rg < nrows) {
      const int hh = kh * rep + rg / t_len, tt = rg % t_len;
      val = q[((size_t)(b * t_len + tt) * h + hh) * kDh + d] * scale;
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
  const int last_row = min(row0 + kF32Rows, nrows) - 1;
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

  float4 kraw[NV], vraw[NV];
  auto load = [&](int page, int s0, int nv) {
    const size_t base = (size_t)page * bs;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (i * kF32Threads + threadIdx.x) * 4;
      const int key = e / kDh, d = e % kDh;
      const int s = s0 + key;
      if (s < nv) {
        const size_t off = ((base + s) * hk + kh) * kDh + d;
        kraw[i] = *reinterpret_cast<const float4*>(kpool + off);
        vraw[i] = *reinterpret_cast<const float4*>(vpool + off);
      } else {
        kraw[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        vraw[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (i * kF32Threads + threadIdx.x) * 4;
      const int key = e / kDh, d = e % kDh;
      *reinterpret_cast<float4*>(ks + key * KS + d) = kraw[i];
      *reinterpret_cast<float4*>(vs + key * KS + d) = vraw[i];
    }
  };

  int j = 0, s0 = 0, nv = 0, page = 0;
  bool have = find(0, 0, j, s0, nv, page);
  if (have) load(page, s0, nv);
  const float* qw = qs + warp * kRowsPerWarp * kDh;
  const float* kr = ks + lane * KS;
  while (have) {
    __syncthreads();                  // the previous tile is consumed
    store();
    __syncthreads();
    int nj = 0, ns = 0, nnv = 0, npage = 0;
    const bool more = find(j, s0 + kF32Keys, nj, ns, nnv, npage);
    if (more) load(npage, ns, nnv);   // in flight during this tile's math

    // ---- scores: lane = key, 8 rows per warp
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDh; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * kDh + d);
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
    const int nk = min(kF32Keys, nv - s0);
    for (int key = 0; key < nk; ++key) {
      float vv[DPL];
      Vec<DPL>::load(vs + key * KS + lane * DPL, vv);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pk = __shfl_sync(0xffffffffu, p[i], key);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pk, vv[c], acc[i][c]);
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
    Vec<DPL>::store(acc_out + o * kDh + lane * DPL, acc[i]);
  }
}

template <int DH, bool CAUSAL>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DH>();
  auto kern = block_attention_kernel<DH, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = (a.h / a.hk) * a.t;
  dim3 grid((rows + kF32Rows - 1) / kF32Rows, a.hk, a.b);
  kern<<<grid, kF32Threads, smem, stream>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const float*>(a.k),
      reinterpret_cast<const float*>(a.v), a.idx, a.vlen, a.qoff, a.m, a.l,
      a.acc, a.t, a.h, a.hk, a.np, a.bs, a.nsel, a.scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const Args& a, bool causal, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return causal ? launch_f32<DH, true>(a, s) : launch_f32<DH, false>(a, s);
  if (dtype == 1)
    return causal ? launch_mma<DH, true>(a, s) : launch_mma<DH, false>(a, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// qoff == nullptr selects K1 (no causal mask), otherwise K2.  splits is
// the number of chunks each block list is cut into (bf16 K1 only; 1
// otherwise); with splits > 1, part_m/part_l [B*Hk*ntiles*splits*64],
// part_acc [that x Dh] fp32 are scratch and counters [B*Hk*ntiles] int32
// must be 0 (the kernel leaves them 0), ntiles = ceil(H/Hk*T / 64).
// Returns 0, a cudaError_t, or -1 for an unsupported head dim, dtype,
// split or list length (over kMaxSel blocks).  The pool, q and the
// outputs must be 16-byte aligned.
extern "C" int block_attention_launch(
    const void* q, const void* k, const void* v, const int* idx,
    const int* vlen, const int* qoff, float* m, float* l, float* acc,
    float* part_m, float* part_l, float* part_acc, int* counters, int b,
    int t, int h, int hk, int dh, int np, int bs, int nsel, int splits,
    int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool causal = qoff != nullptr;
  if ((dh != 64 && dh != 128) || splits < 1 || splits > kMaxSplits)
    return -1;
  if (splits > 1 && (dtype != 1 || causal || !part_m || !part_l ||
                     !part_acc || !counters))
    return -1;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), idx, vlen, qoff, m, l, acc, part_m,
         part_l, part_acc, counters, b, t, h, hk, np, bs, nsel, splits,
         ((h / hk) * t + kRows - 1) / kRows, scale};
  if (dh == 64) return launch<64>(a, causal, dtype, s);
  return launch<128>(a, causal, dtype, s);
}
