"""Public wrappers over the port's CUDA kernels (counterpart of
``repro/kernels/ops.py``), with the reference's signatures and output
contracts: fp32 (m, l, acc) partials left un-normalised, empty blocks
routed to null page 0, per-block valid lengths derived from ``length``,
and normalisation inside the prefill wrapper.

Dispatch is by the tensors' device and nothing else: CPU tensors take the
plain versions in ``kernels/ref.py``; CUDA tensors launch the kernel (built
at first use) or raise.  There is no fallback from one to the other.

Each kernel counts its launches in ``LAUNCHES`` (a plain integer per
kernel, bumped only where the kernel is launched), so a run can show
that its main path went through the kernels.  K5's launches are also
counted by shape in ``WKV_SHAPES``, keyed by (T, update).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref

KERNELS = ("sparse_verify_attention", "paged_prefill_attention",
           "retrieval_score", "block_summary", "wkv")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
WKV_SHAPES: Dict[Tuple[int, bool], int] = {}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
    WKV_SHAPES.clear()


def launch_counts() -> Tuple[Dict[str, int], Dict[Tuple[int, bool], int]]:
    """A copy of (``LAUNCHES``, ``WKV_SHAPES``)."""
    return dict(LAUNCHES), dict(WKV_SHAPES)


def set_launch_counts(counts) -> None:
    """Put back counts that ``launch_counts`` took."""
    LAUNCHES.update(counts[0])
    WKV_SHAPES.clear()
    WKV_SHAPES.update(counts[1])


def launch_count_delta(before, after):
    """The launches counted between two ``launch_counts`` snapshots, as
    (per kernel, per K5 shape), zero entries left out."""
    runs = {k: after[0][k] - before[0].get(k, 0) for k in after[0]}
    shapes = {k: n - before[1].get(k, 0) for k, n in after[1].items()}
    return ({k: n for k, n in runs.items() if n},
            {k: n for k, n in shapes.items() if n})


def add_launch_counts(launches: Dict[str, int],
                      wkv_shapes: Dict[Tuple[int, bool], int]) -> None:
    """Count launches made without their wrappers' Python running: a
    CUDA graph's replay launches what its capture recorded."""
    for k, n in launches.items():
        LAUNCHES[k] += n
    for k, n in wkv_shapes.items():
        WKV_SHAPES[k] = WKV_SHAPES.get(k, 0) + n


def _check(name, t, *, dtype=None, ndim=None, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype} not supported")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _ptr(t):
    return t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# K1 / K2: block-list attention
# ---------------------------------------------------------------------------

ROWS_PER_CTA = 64      # query rows of one CTA of the bf16 (tensor-core) route
TARGET_CTAS = 264      # two resident CTAs on each of the H100's 132 SMs
MAX_SPLITS = 64        # the kernel's bound (block_attention.cu kMaxSplits)
MIN_COUNTERS = 4096    # int32 counters allocated at least (16 KB)
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_RESERVED: set = set()     # devices whose counters may no longer move


def kv_splits(b: int, t: int, h: int, hk: int, nsel: int,
              causal: bool = False) -> int:
    """How many chunks the bf16 kernel cuts each (row, KV head) block list
    into (split-KV): enough (row tile, head, chunk) CTAs to fill the card,
    ``TARGET_CTAS // (B * Hk * row tiles)``, at least 1 and at most one
    chunk per slot and ``MAX_SPLITS``.  The causal prefill form is not
    split: its rows fill the card.  ``ref.kv_split_valid_len`` states
    which blocks each chunk takes."""
    if causal:
        return 1
    tiles = b * hk * -(-(h // hk) * t // ROWS_PER_CTA)
    return max(1, min(nsel, MAX_SPLITS, TARGET_CTAS // tiles))


def split_counter_slots(b: int, t: int, h: int, hk: int, nb: int) -> int:
    """Merge counters taken by the larger of a K1 launch of ``t`` query
    rows (one per row tile and KV head) and a K3 launch over ``nb``
    blocks (one per block tile and KV head)."""
    tiles, _, groups = score_grid(b, t, h, hk, nb)
    return max(b * hk * -(-(h // hk) * t // ROWS_PER_CTA), groups * tiles)


def _split_counters(n: int, dev) -> torch.Tensor:
    """The merge counters of the split attention kernel (K1) and of the
    retrieval-score kernel (K3): int32, zero between launches (the last
    CTA of each group resets its own), so they are zeroed once when
    allocated and never again.  One set per device, shared by both
    kernels; launches that use it run in stream order.  Once reserved
    (``reserve_split_counters``) the set never moves: a captured CUDA
    graph holds its address, so a launch that needs more raises."""
    c = _COUNTERS.get(dev)
    if c is None or c.numel() < n:
        if dev in _RESERVED:
            raise RuntimeError(
                f"a launch needs {n} merge counters and {c.numel()} are "
                f"reserved on {dev}; a captured graph holds their address, "
                f"so reserve enough before the first capture")
        c = torch.zeros(max(n, MIN_COUNTERS), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = c
    return c


def reserve_split_counters(n: int, dev) -> torch.Tensor:
    """Allocate (zeroed) the merge counters of ``dev`` for launches of up
    to ``n`` slots and fix their address from then on; called before any
    graph capture.  Raises if a set already fixed is too small."""
    c = _split_counters(n, dev)
    _RESERVED.add(dev)
    return c


def block_attention(q, k_flat, v_flat, block_idx, block_valid_len,
                    block_size: int, q_offset=None):
    """Block-list attention partials over a flattened pool.

    q: [B, T, H, Dh]; k_flat/v_flat: [NP*bs, Hk, Dh]; block_idx/
    block_valid_len: [B, Hk, N] int32; q_offset: optional [B] int32 (the
    causal paged-prefill form, K2).  Returns (m [B, H, T], l [B, H, T],
    acc [B, H, T, Dh]) fp32.  On the card bf16 runs on the tensor cores
    (K1 split over ``kv_splits`` chunks, merged in the same launch) and
    fp32 on the CUDA cores; either way one launch."""
    dev = q.device
    _check("q", q, dtype=tuple(_DTYPES), ndim=4)
    _check("k", k_flat, dtype=q.dtype, ndim=3, device=dev)
    _check("v", v_flat, dtype=q.dtype, ndim=3, device=dev)
    _check("block_idx", block_idx, ndim=3, device=dev)
    _check("block_valid_len", block_valid_len, ndim=3, device=dev)
    b, t, h, dh = q.shape
    s, hk, dh2 = k_flat.shape
    if dh2 != dh or h % hk or s % block_size or v_flat.shape != k_flat.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"pool {tuple(k_flat.shape)}, bs {block_size}")
    if block_idx.shape[:2] != (b, hk) or \
            block_valid_len.shape != block_idx.shape:
        raise ValueError(f"block tables {tuple(block_idx.shape)} / "
                         f"{tuple(block_valid_len.shape)} vs B={b}, Hk={hk}")
    if dev.type == "cpu":
        return ref.block_attention_batched(q, k_flat, v_flat, block_idx,
                                           block_valid_len, block_size,
                                           q_offset=q_offset)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for name, a in (("block_idx", block_idx),
                    ("block_valid_len", block_valid_len)):
        _check(name, a, dtype=torch.int32)
    if q_offset is not None:
        _check("q_offset", q_offset, dtype=torch.int32, ndim=1, device=dev)
        if q_offset.shape[0] != b:
            raise ValueError("q_offset must be [B]")
    if dh != 128:
        raise ValueError(f"head dim {dh}: the kernels are built for 128")
    nsel = block_idx.shape[2]
    splits = (kv_splits(b, t, h, hk, nsel, q_offset is not None)
              if q.dtype == torch.bfloat16 else 1)
    from repro_torch.kernels.build import load_library
    lib = load_library()
    m = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, h, t, dh), dtype=torch.float32, device=dev)
    part_ml = part_acc = counters = None
    if splits > 1:
        slots = b * hk * -(-(h // hk) * t // ROWS_PER_CTA)
        rows = slots * splits * ROWS_PER_CTA
        part_ml = torch.empty((2, rows), dtype=torch.float32, device=dev)
        part_acc = torch.empty((rows, dh), dtype=torch.float32, device=dev)
        counters = _split_counters(slots, dev)
    err = lib.block_attention_launch(
        _ptr(q), _ptr(k_flat), _ptr(v_flat), _ptr(block_idx),
        _ptr(block_valid_len),
        None if q_offset is None else _ptr(q_offset),
        _ptr(m), _ptr(l), _ptr(acc),
        None if part_ml is None else _ptr(part_ml[0]),
        None if part_ml is None else _ptr(part_ml[1]),
        None if part_acc is None else _ptr(part_acc),
        None if counters is None else _ptr(counters),
        b, t, h, hk, dh, s // block_size, block_size, nsel, splits,
        _DTYPES[q.dtype], 1.0 / math.sqrt(dh), _stream())
    if err != 0:
        raise RuntimeError(f"block_attention_launch failed with code {err}")
    LAUNCHES["sparse_verify_attention" if q_offset is None
             else "paged_prefill_attention"] += 1
    return m, l, acc


def _flat_pool(pool):
    np_, bs, hk, dh = pool.shape
    return pool.reshape(np_ * bs, hk, dh)


def _page_walk(page_table, end, pool_shape):
    """Per-row block list of the filled prefix ``[0, end)``: each logical
    block reads its page with ``min(end - j*bs, bs)`` valid tokens, and
    every empty block routes to the null page 0 with valid length 0.
    Returns (idx, vlen) [B, Hk, NB] int32."""
    bs, hk = pool_shape[1], pool_shape[2]
    b, nb = page_table.shape
    ar = torch.arange(nb, device=page_table.device)
    vlen = torch.clamp(end[:, None] - ar[None] * bs, 0, bs)
    routed = torch.where(vlen > 0, page_table, torch.zeros_like(page_table))
    return (routed[:, None].expand(b, hk, nb).to(torch.int32).contiguous(),
            vlen[:, None].expand(b, hk, nb).to(torch.int32).contiguous())


def paged_verify_attention(q, pool_k, pool_v, page_table, length):
    """Paged Full/Refresh verification attention over the shared block
    pool.  q: [B, T, H, Dh]; pool_k/pool_v: [NP, block, Hk, Dh];
    page_table: [B, NB]; length: [B] (the fused step passes 0 for rows
    that read the partial cache).  Rows stream only their
    ``ceil(length / block)`` filled pages: every empty block routes to
    the null page 0 with valid length 0.  Returns fp32 partials."""
    idx, vlen = _page_walk(page_table, length, pool_k.shape)
    return block_attention(q, _flat_pool(pool_k), _flat_pool(pool_v), idx,
                           vlen, pool_k.shape[1])


def routed_partial_attention(q, pool_k, pool_v, block_idx, block_valid_len):
    """Zero-copy partial verification attention: the retrieval-selected
    blocks read in place from the pool.  block_idx: [B, Hk, NSel]
    physical page ids (unused slots routed to 0); block_valid_len:
    [B, Hk, NSel] (0 masks a slot).  Returns fp32 partials."""
    bs = pool_k.shape[1]
    return block_attention(q, _flat_pool(pool_k), _flat_pool(pool_v),
                           block_idx.to(torch.int32).contiguous(),
                           block_valid_len.to(torch.int32).contiguous(), bs)


def flat_blocks(k):
    """The block pool behind a contiguous cache view, at no cost.

    k: [..., B, S, Hk, Dh], a view of the first S rows of an allocation
    [..., B, S_alloc, Hk, Dh] whose S_alloc is a multiple of the block
    (``api.init_cache`` allocates so).  Returns the allocation as one
    flat pool [prod(...) * B * S_alloc, Hk, Dh] (row b's block j is pool
    block ``b * S_alloc / bs + j``; the rows past S are never written,
    so they stay 0) and S_alloc."""
    hk, dh = k.shape[-2:]
    s_alloc = k.stride(-4) // k.stride(-3)
    lead = k.shape[:-3]
    dense = [1, dh, hk * dh, s_alloc * hk * dh]
    for n in reversed(lead[1:]):
        dense.append(dense[-1] * n)
    if (tuple(k.stride()[::-1]) != tuple(dense[: k.dim()])
            or s_alloc < k.shape[-3]):
        raise ValueError(f"not a contiguous cache view: shape "
                         f"{tuple(k.shape)}, strides {k.stride()}")
    rows = s_alloc
    for n in lead:
        rows *= n
    return k.as_strided((rows, hk, dh), (hk * dh, dh, 1)), s_alloc


def _identity_walk(b: int, hk: int, nb: int, end, s_cap: int, bs: int):
    """The page walk of a contiguous cache's filled prefix ``[0, min(end,
    s_cap))`` through the identity table: row b's logical block j is pool
    block ``b * nb + j``.  Returns (idx, vlen) [B, Hk, NB] int32."""
    table = torch.arange(b * nb, dtype=torch.int32,
                         device=end.device).view(b, nb)
    return _page_walk(table, torch.clamp(end, max=s_cap), (b * nb, bs, hk))


def contiguous_verify_attention(q, k_layer, v_layer, length, block_size: int):
    """Full/Refresh verification attention (K1) over a contiguous cache:
    the cache rows are a pool of blocks (``flat_blocks``), each row reads
    its own blocks through the identity list.  k_layer/v_layer: [B, S,
    Hk, Dh] views (the reference's S, which need not be a multiple of
    the block); length: [B].  Returns fp32 partials."""
    b, s, hk, _ = k_layer.shape
    kf, s_alloc = flat_blocks(k_layer)
    vf, _ = flat_blocks(v_layer)
    idx, vlen = _identity_walk(b, hk, s_alloc // block_size, length, s,
                               block_size)
    return block_attention(q, kf, vf, idx, vlen, block_size)


def contiguous_prefill_attention(q, k_layer, v_layer, length, t_valid,
                                 block_size: int):
    """Blockwise causal prefill attention (K2) over a contiguous cache
    whose chunk K/V are already written: the identity list of each row's
    filled prefix under the absolute-position causal mask.  Same
    contract as ``paged_prefill_attention``."""
    b, s, hk, _ = k_layer.shape
    kf, s_alloc = flat_blocks(k_layer)
    vf, _ = flat_blocks(v_layer)
    idx, vlen = _identity_walk(b, hk, s_alloc // block_size,
                               length + t_valid, s, block_size)
    qoff = length.to(torch.int32).contiguous()
    m, l, acc = block_attention(q, kf, vf, idx, vlen, block_size,
                                q_offset=qoff)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def paged_prefill_attention(q, pool_k, pool_v, page_table, length, t_valid):
    """Blockwise paged prefill attention: the chunk's K/V are already in
    the pool, so each row's context is the filled prefix of its table
    under an absolute-position causal mask.  q: [B, T, H, Dh];
    length: [B] tokens resident before the chunk; t_valid: [B] real
    chunk tokens.  Returns normalised attention [B, T, H, Dh] in q's
    dtype."""
    idx, vlen = _page_walk(page_table, length + t_valid, pool_k.shape)
    qoff = length.to(torch.int32).contiguous()
    m, l, acc = block_attention(q, _flat_pool(pool_k), _flat_pool(pool_v),
                                idx, vlen, pool_k.shape[1], q_offset=qoff)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# K3: retrieval scores
# ---------------------------------------------------------------------------

SCORE_ROWS = 64        # query rows per CTA of K3 (retrieval_score.cu kRows)
SCORE_BLOCKS = 32      # blocks per CTA of K3 (retrieval_score.cu kBlocks)


def score_grid(b: int, t: int, h: int, hk: int, nb: int):
    """K3's grid: (block tiles, row slices, B * Hk), where a slice is
    ``SCORE_ROWS`` of a head's ``rep * T`` query rows and a tile
    ``SCORE_BLOCKS`` blocks.  Each CTA leaves a partial per (slice, block)
    and the last CTA of each tile sums them.  The wrapper sizes its
    scratch and counters from this grid and passes it to the kernel, which
    refuses a grid other than its own."""
    slices = max(1, -(-(h // hk) * t // SCORE_ROWS))
    return -(-nb // SCORE_BLOCKS), slices, b * hk


def retrieval_scores(q, kmax, kmin, q_weight):
    """Batched Quest scores (paper mode, mean reduction).
    q: [B, T, H, Dh]; kmax/kmin: [B, NB, Hk, Dh] fp32; q_weight: [B, T].
    Returns [B, Hk, NB] fp32.  On the card one launch, whose slices merge
    in a fixed order (two calls give the same bits)."""
    dev = q.device
    _check("q", q, dtype=tuple(_DTYPES), ndim=4)
    _check("kmax", kmax, dtype=torch.float32, ndim=4, device=dev)
    _check("kmin", kmin, dtype=torch.float32, ndim=4, device=dev)
    _check("q_weight", q_weight, ndim=2, device=dev)
    b, t, h, dh = q.shape
    _, nb, hk, dh2 = kmax.shape
    if (dh2 != dh or h % hk or kmin.shape != kmax.shape
            or kmax.shape[0] != b or tuple(q_weight.shape) != (b, t)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"kmax {tuple(kmax.shape)}, "
                         f"q_weight {tuple(q_weight.shape)}")
    if dev.type == "cpu":
        return ref.retrieval_score_batched(q, kmax, kmin, q_weight)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    _check("q_weight", q_weight, dtype=torch.float32)
    if dh != 128:
        raise ValueError(f"head dim {dh}: the kernels are built for 128")
    rep = h // hk
    if rep & (rep - 1) or rep > SCORE_ROWS:
        raise ValueError(f"{rep} query heads per KV head: the kernel takes "
                         f"a power of two up to {SCORE_ROWS}")
    from repro_torch.kernels.build import load_library
    lib = load_library()
    out = torch.empty((b, hk, nb), dtype=torch.float32, device=dev)
    tiles, slices, groups = score_grid(b, t, h, hk, nb)
    part = torch.empty(groups * slices * nb, dtype=torch.float32, device=dev)
    counters = _split_counters(groups * tiles, dev)
    err = lib.retrieval_score_launch(
        _ptr(q), _ptr(kmax), _ptr(kmin), _ptr(q_weight), _ptr(out),
        _ptr(part), _ptr(counters), b, t, h, hk, dh, nb, tiles, slices,
        _DTYPES[q.dtype], _stream())
    if err != 0:
        raise RuntimeError(f"retrieval_score_launch failed with code {err}")
    LAUNCHES["retrieval_score"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: block summaries
# ---------------------------------------------------------------------------

def paged_block_summaries(pool, page_table, start, end, n_touch: int,
                          kmax, kmin):
    """The paged cache's summary update over every layer at once, in
    place (the reference's ``paged_update_summaries`` for each layer).

    pool: [L, NP, bs, Hk, Dh] (bf16/fp32); page_table: [B, NB] int32;
    start/end: [B] (each row wrote tokens [start, end)); kmax/kmin:
    [L, NP, Hk, Dh] fp32.  For each layer, row and j < ``n_touch``,
    logical block ``start // bs + j``, if it holds a token below ``end``
    and lies in the table, is reduced over its tokens below ``end`` into
    the summaries of its page; a block on the null page 0 writes
    nothing, so page 0 keeps its summaries (0).  On the card one launch,
    which reads the routing from the page table itself.  Returns (kmax,
    kmin)."""
    dev = pool.device
    _check("pool", pool, dtype=tuple(_DTYPES), ndim=5)
    _check("page_table", page_table, ndim=2, device=dev)
    for name, a in (("start", start), ("end", end)):
        _check(name, a, ndim=1, device=dev)
    for name, a in (("kmax", kmax), ("kmin", kmin)):
        _check(name, a, dtype=torch.float32, ndim=4, device=dev)
    layers, np_, bs, hk, dh = pool.shape
    b, nb = page_table.shape
    if (tuple(kmax.shape) != (layers, np_, hk, dh)
            or kmin.shape != kmax.shape or start.shape[0] != b
            or end.shape[0] != b or n_touch < 0):
        raise ValueError(f"shape mismatch: pool {tuple(pool.shape)}, "
                         f"table {tuple(page_table.shape)}, out "
                         f"{tuple(kmax.shape)}, n_touch {n_touch}")
    if dev.type == "cpu":
        return ref.paged_block_summaries(pool, page_table, start, end,
                                         n_touch, kmax, kmin)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    _check("page_table", page_table, dtype=torch.int32)
    if start.dtype != torch.int32 or end.dtype != torch.int32:
        start, end = start.to(torch.int32), end.to(torch.int32)
    from repro_torch.kernels.build import load_library
    lib = load_library()
    err = lib.block_summary_paged_launch(
        _ptr(pool), _ptr(page_table), _ptr(start), _ptr(end), _ptr(kmax),
        _ptr(kmin), layers, np_, bs, hk, dh, b, nb, n_touch,
        _DTYPES[pool.dtype], _stream())
    if err != 0:
        raise RuntimeError(f"block_summary_paged_launch failed with code "
                           f"{err}")
    LAUNCHES["block_summary"] += 1
    return kmax, kmin


def block_summaries_routed(k_flat, src, vlen, tgt, kmax_out, kmin_out,
                           block_size: int):
    """Routed per-block key max/min (paper eq. (1)), written in place.

    k_flat: [NP*bs, Hk, Dh] (bf16/fp32 pool); src/vlen/tgt: [N] int
    (entry e reduces the first ``vlen[e]`` tokens of pool block
    ``src[e]`` into ``kmax_out[tgt[e]]`` / ``kmin_out[tgt[e]]``, fp32
    [NP, Hk, Dh]).  Valid length 0 gives 0; entries whose target is the
    null page 0 are skipped, so its summaries stay 0.  Targets other
    than 0 must be distinct.  Returns (kmax_out, kmin_out)."""
    tgt = torch.where(tgt > 0, tgt, torch.full_like(tgt, -1))
    _summaries(k_flat, src, vlen, tgt, kmax_out, kmin_out, block_size)
    return kmax_out, kmin_out


def contiguous_block_summaries(k, start, end, n_touch: int, kmax, kmin,
                               block_size: int):
    """The contiguous cache's summary update over every layer at once, in
    place (the reference's ``update_layer_summaries`` for each layer): the
    routed form with ``src = tgt = (l*B + b)*NB + j`` over the layers'
    cache rows laid end to end as one pool (``flat_blocks``), its ids
    built on the card.

    k: [L, B, S, Hk, Dh] view; start/end: [B] (each row wrote tokens
    [start, end)); kmax/kmin: contiguous [L, B, NB, Hk, Dh] fp32.  For
    each layer and row, the blocks ``start // bs + j`` (j < ``n_touch``)
    below ``ceil(end / bs)`` are reduced over their tokens below ``end``
    (rows past S are 0, as the reference's padded view); the other
    blocks are left as they were.  One K4 launch."""
    layers, b, _, hk, dh = k.shape
    nb = kmax.shape[2]
    kf, s_alloc = flat_blocks(k)
    if (s_alloc != nb * block_size
            or tuple(kmax.shape) != (layers, b, nb, hk, dh)
            or kmin.shape != kmax.shape or not kmax.is_contiguous()
            or not kmin.is_contiguous()):
        raise ValueError(f"shape mismatch: cache {tuple(k.shape)} over "
                         f"{s_alloc} rows, summaries {tuple(kmax.shape)}")
    dev = k.device
    bs = block_size
    tb = ((start.long() // bs)[:, None]
          + torch.arange(n_touch, device=dev)[None])             # [B, NT]
    live = (tb < ((end.long() + bs - 1) // bs)[:, None]) & (tb < nb)
    tbc = torch.clamp(tb, max=nb - 1)
    vlen = torch.clamp(end.long()[:, None] - tbc * bs, 0, bs)
    ids = ((torch.arange(layers, device=dev)[:, None, None] * b
            + torch.arange(b, device=dev)[None, :, None]) * nb
           + tbc[None])                                          # [L, B, NT]
    tgt = torch.where(live[None], ids, torch.full_like(ids, -1))
    _summaries(kf, ids.reshape(-1), vlen[None].expand_as(ids).reshape(-1),
               tgt.reshape(-1), kmax.view(layers * b * nb, hk, dh),
               kmin.view(layers * b * nb, hk, dh), bs)
    return kmax, kmin


def block_summaries(k, length, block_size: int):
    """The reference's contiguous contract, batched: k [B, S, Hk, Dh];
    length [B].  Returns (kmax, kmin) [B, S // bs, Hk, Dh] fp32, blocks
    with no valid token 0.  The routed kernel with ``src = tgt = arange``
    and ``vlen = clip(length - j*bs, 0, bs)``."""
    b, s, hk, dh = k.shape
    nb = s // block_size
    dev = k.device
    ar = torch.arange(nb, device=dev)
    vlen = torch.clamp(length.long()[:, None] - ar[None] * block_size, 0,
                       block_size)
    ids = (torch.arange(b, device=dev)[:, None] * nb + ar[None]).reshape(-1)
    kmax = torch.empty((b * nb, hk, dh), dtype=torch.float32, device=dev)
    kmin = torch.empty_like(kmax)
    k_flat = k[:, : nb * block_size].reshape(b * nb * block_size, hk, dh)
    _summaries(k_flat, ids, vlen.reshape(-1), ids, kmax, kmin, block_size)
    return kmax.reshape(b, nb, hk, dh), kmin.reshape(b, nb, hk, dh)


def _summaries(k_flat, src, vlen, tgt, kmax_out, kmin_out, block_size):
    """K4 launch (negative targets skipped) or, for CPU tensors, its
    plain version."""
    dev = k_flat.device
    _check("k", k_flat, dtype=tuple(_DTYPES), ndim=3)
    for name, a in (("src", src), ("vlen", vlen), ("tgt", tgt)):
        _check(name, a, ndim=1, device=dev)
    for name, a in (("kmax", kmax_out), ("kmin", kmin_out)):
        _check(name, a, dtype=torch.float32, ndim=3, device=dev)
    s, hk, dh = k_flat.shape
    n = src.shape[0]
    if (s % block_size or vlen.shape[0] != n or tgt.shape[0] != n
            or kmax_out.shape[1:] != (hk, dh)
            or kmin_out.shape != kmax_out.shape):
        raise ValueError(f"shape mismatch: pool {tuple(k_flat.shape)}, "
                         f"bs {block_size}, lists {n}, "
                         f"out {tuple(kmax_out.shape)}")
    if dev.type == "cpu":
        ref.block_summary_routed(k_flat, src, vlen, tgt, kmax_out, kmin_out,
                                 block_size)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    src, vlen, tgt = (a.to(torch.int32).contiguous() for a in (src, vlen, tgt))
    from repro_torch.kernels.build import load_library
    lib = load_library()
    err = lib.block_summary_launch(
        _ptr(k_flat), _ptr(src), _ptr(vlen), _ptr(tgt), _ptr(kmax_out),
        _ptr(kmin_out), n, s // block_size, block_size, hk, dh,
        _DTYPES[k_flat.dtype], _stream())
    if err != 0:
        raise RuntimeError(f"block_summary_launch failed with code {err}")
    LAUNCHES["block_summary"] += 1


# ---------------------------------------------------------------------------
# K5: RWKV-6 WKV recurrence
# ---------------------------------------------------------------------------

def wkv(r, k, v, w, u, s0, n_valid=None, *, update: bool = True):
    """The Finch WKV recurrence, one step per token.

    r/k/v/w: [B, T, H, dk] fp32; u: [H, dk] fp32; s0: [B, H, dk, dk]
    fp32; n_valid: [B] int valid prefix per row (default T): later steps
    give y but leave the state.  Returns (y [B, T, H, dk] fp32, state):
    the final state as a new tensor, or ``s0`` itself when ``update`` is
    False (read-only chain verification)."""
    dev = r.device
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, a, dtype=torch.float32, ndim=4, device=dev)
    _check("u", u, dtype=torch.float32, ndim=2, device=dev)
    _check("s0", s0, dtype=torch.float32, ndim=4, device=dev)
    b, t, h, dk = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (h, dk) or tuple(s0.shape) != (b, h, dk, dk)):
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, "
                         f"u {tuple(u.shape)}, s0 {tuple(s0.shape)}")
    if n_valid is None:
        n_valid = torch.full((b,), t, dtype=torch.int32, device=dev)
    _check("n_valid", n_valid, ndim=1, device=dev)
    if n_valid.shape[0] != b:
        raise ValueError("n_valid must be [B]")
    if dev.type == "cpu":
        y, s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        return y, (s if update else s0)
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    if dk != 64:
        raise ValueError(f"head size {dk}: the kernel is built for 64")
    n_valid = n_valid.to(torch.int32).contiguous()
    from repro_torch.kernels.build import load_library
    lib = load_library()
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0) if update else s0
    err = lib.wkv_launch(_ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u),
                         _ptr(s0), _ptr(n_valid), _ptr(y), _ptr(s_out), b, t,
                         h, dk, int(update), _stream())
    if err != 0:
        raise RuntimeError(f"wkv_launch failed with code {err}")
    LAUNCHES["wkv"] += 1
    key = (t, bool(update))
    WKV_SHAPES[key] = WKV_SHAPES.get(key, 0) + 1
    return y, s_out
