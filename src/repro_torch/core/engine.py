"""SpecPV generation engine (counterpart of ``repro/core/engine.py``,
paper Algorithm 1):

  prefill (chunked) -> [ draft -> verify(mode) -> accept -> commit ]*

over the contiguous trunk cache (``paged=False``, the reference's
default) or the paged pool.  A refresh stores the retrieval-selected
logical block ids per layer and KV head (``EngineState.pkv_blocks``).
The gathered partial cache (``zero_copy=False``, the default) also
copies the selected blocks' bytes into a dense body
(``pkv_body_k/v``); zero-copy (paged only) pins their physical pages
instead and partial steps read them in place.  Either way a partial
step reads the body and a small dense tail buffer.

Mode automaton (host side, §3.3): context below the partial budget ->
Full; budget first exceeded -> Refresh; buffer has room -> Partial;
buffer would overflow -> Refresh.

Every step runs one body (``_fused_body``: ``_step_fused`` with the
tick's mode mix deciding which masked branches run; ``_state_body`` for
a state arch) that computes the next state and copies it into the
engine's static buffers (``state``), which ``prefill`` resets in place.
On the card each body, and each full prefill chunk, is captured once as
a CUDA graph and replayed: the port's counterpart of the reference's
jitted dispatch, keyed like its ``_fused_fn`` by the mode mix
(``dispatches`` counts the steps).  The host reads one packed copy per
step for the mode automaton, the page pins and the billing.
``cuda_graphs=False`` runs the same bodies eagerly on the card; the CPU
never captures.

Continuous batching (attention archs): the batch rows are independent
slots.  ``step_fused`` steps any non-empty row subset in one dispatch:
the row mask, like the per-row modes, is an operand of the graph.  An
empty or mid-prefill slot's device row is neutral (page table on the
null page, length 0), so its writes land on the null page; a live row
masked out of a step commits nothing, so its writes land at or past its
length, where its next real step writes first.  The pools therefore
need no merge after a masked step.  ``prefill_begin_slot`` /
``prefill_step_fused`` / ``prefill_finalize_slot`` prefill slots chunk
by chunk, so the serving scheduler can interleave chunks with decode
steps: one fused call advances K open cursors by one chunk each in one
ragged [K, chunk] body (a graph per K on the card), through the rows'
own page tables over the shared pools (contiguous engines: over a
carry of one block-addressed row per slot, written into the state at
finalise).  ``prefill_step_into_slot`` is the one-cursor call and
``prefill_into_slot`` runs a whole prompt.

Prefix sharing (paged engines, ``prefix_cache=True``): an admission
attaches the prompt's cached leading blocks by page-table reference and
prefills the rest, registering each block as its chunk finishes (the
boundary features stay on the card); a prompt registered whole boots
from its tail entry with no prefill.  ``fork_slot`` shares a live slot's
pages with another slot, and ``prepare_cow`` copies, before each step,
any still-shared block a forked row is about to write.

Tiered residency (paged engines, ``tiered=True``): around each step, and
outside its graph, a row about to read its full cache first gets its
host-tier pages back (``TierManager.promote_slot``), a row that just
refreshed sends its complete cold blocks to host memory
(``demote_slot``), and a partial row one step from its refresh starts
their copy back (``prefetch_slot``).

VLM and audio targets are conditioned per request (``extra``: image
patch or audio frame embeddings).  The encoder states and every cross
layer's K/V are a function of ``extra`` alone, so the engine computes
them once per request, before its first prefill chunk, and copies them
into the state's ``cross_k`` / ``cross_v`` rows in place (a slot's
rows at its admission); every prefill chunk and step then reads the
rows, and the captured graphs take no new operand.  The reference
recomputes them at every prefill chunk, to the same values.

State architectures (RWKV-6 and Griffin, ``paged=False``) have no
growing KV cache (Griffin's attention reads a rolling window of W
keys), so partial verification does not apply: each step (mode
``"state"``, ``_step_state``) drafts a chain, verifies it with a
read-only pass, accepts and advances the recurrent state over the
pending token and the accepted prefix.

Sampling (``core/sampling.py``): every slot carries its own random
stream (``EngineState.keys``, derived from the request's seed at
admission) and temperature (``temps``).  Rows at temperature 0 accept
greedily, exactly as in an all-greedy step; sampled rows draft i.i.d.
children and accept by multi-round rejection.  A slot admitted with
``draft="chain"`` verifies only the tree's rank-0 chain
(``TreeSpec.chain_mask``), so chain and tree slots, greedy and sampled,
step together.  Whether a step has sampled rows and chain rows joins
its mode mix in the graph's key; the per-row behaviour is operands.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DraftConfig, ModelConfig, SpecPVConfig
from repro_torch.core import draft as dr
from repro_torch.core import sampling as smp
from repro_torch.core import tree as tr
from repro_torch.core import verify as vf
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kvcache import cache as kvc
from repro_torch.kvcache.offload import (TierManager, TrafficMeter,
                                         full_step_bytes, partial_step_bytes,
                                         routed_refresh_bytes)
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.models import dense as dn


@dataclass
class EngineState:
    """Per-batch decode state, each row a slot with its own random stream
    (``keys``, advanced only by the steps in which the row sampled) and
    temperature (0: greedy).

    The reference keeps the gathered partial cache as one array per
    layer, [L, B, Hk, budget + buffer, Dh] with positions; the port
    keeps its body token-major (``pkv_body_k/v``: slot ``(b, j*bs + t,
    kh)`` holds token t of the block head kh selected in slot j) beside
    the selection (``pkv_blocks``, as zero-copy does), so the verify
    kernel reads it as a pool of blocks at the routed call's shape, and
    the tail buffer apart, as zero-copy does."""
    cache: Any                  # trunk cache dict (ssm: the state)
    dcache: Any                 # draft cache dict
    pkv_k: Any                  # [L, B, Hk, buffer, Dh] tail buffer
    pkv_v: Any
    pkv_pos: Any                # [L, B, Hk, buffer] int32, -1 = empty
    buf_len: Any                # [B]
    pending: Any                # [B, Pmax]
    pending_len: Any            # [B]
    seq_len: Any                # [B]
    ext_tokens: Any             # [B, E]
    ext_feats: Any              # [B, E, 3d]
    ext_len: Any                # [B]
    pkv_blocks: Any             # [B, L, Hk, NS] int32 logical ids, -1 unused
    pkv_body_k: Any             # [L, B, NS*bs, Hk, Dh] gathered body
    pkv_body_v: Any             # (size 0 on axis 2 when not gathered)
    keys: Any                   # [B, 2] int64 per-slot stream keys
    temps: Any                  # [B] float32 per-slot temperature


def request_token_need(prompt_len: int, max_new_tokens: int,
                       buffer_size: int, emax: int) -> int:
    """Tokens of full-cache capacity a request needs end to end (prompt,
    first token, budget and the commit overshoot margin)."""
    return prompt_len + 1 + max_new_tokens + buffer_size + 2 * emax + 2


MODE_FULL, MODE_REFRESH, MODE_PARTIAL = 0, 1, 2
MODE_IDS = {"full": MODE_FULL, "refresh": MODE_REFRESH,
            "partial": MODE_PARTIAL}
MODE_NAMES = {v: k for k, v in MODE_IDS.items()}


@dataclass
class StepOutput:
    tokens: np.ndarray          # [B, D+1] accepted tokens (path + bonus)
    counts: np.ndarray          # [B] number of valid tokens (= accept+1)
    accept_len: np.ndarray      # [B]
    mode: str                   # single mode name, or "fused" for a mix
    modes: Optional[np.ndarray] = None


@dataclass
class PrefillCursor:
    """Resumable prefill of one slot (the reference's cursor).

    ``off`` is the absolute offset of the next chunk; chunk boundaries
    stay absolute multiples of ``chunk``, so an interleaved prefill runs
    the chunk schedule of a blocking one.  ``row_cache`` / ``row_dcache``
    hold the slot's page-table row and length on the device (batch 1):
    over the engine's pools, or in a contiguous engine over its slot's
    rows of the prefill carry (``SpecPVEngine._slot_pools``).
    ``pt_host`` / ``dpt_host`` are the page plan allocated at begin,
    decode reserve included; the
    prefix-sharing fields record the blocks attached from the cache
    (``n_match``), the registrable full blocks (``n_full``), their chain
    keys and the entries registered so far (re-stamped as a chain).  A
    whole-prompt tail-entry hit is born exhausted: finalise boots from
    ``boot_token`` with no prefill.  ``temperature`` / ``seed`` /
    ``draft`` are the request's sampling knobs, committed to the slot at
    finalise.  ``extra`` is the request's conditioning (VLM and audio
    targets): its cross K/V went into the slot's rows at begin, and a
    cursor that carries it prefills alone (``prefill_step_into_slot``),
    as the reference's does.  In a data-parallel engine ``shard`` is the
    data shard that holds the cursor and ``slot`` its row there."""
    slot: int
    prompt: np.ndarray
    chunk: int
    off: int                            # absolute offset of the next chunk
    prev_feat: Any                      # [1, 3d] fused boundary feature
    row_cache: Dict                     # {"page_table" [1, NB], "length" [1]}
    row_dcache: Dict
    logits_last: Any = None             # last chunk's logits (first token)
    tokens: Any = None                  # the prompt on the device [S]
    pt_host: Optional[np.ndarray] = None
    dpt_host: Optional[np.ndarray] = None
    total_pages: int = 0
    n_match: int = 0                    # prefix-cache blocks attached
    n_full: int = 0                     # full prompt blocks (registrable)
    chain_keys: List[bytes] = field(default_factory=list)
    chain_entries: List[Any] = field(default_factory=list)
    boot_token: Optional[int] = None    # tail-entry hit: stored token
    temperature: float = 0.0
    seed: int = 0
    draft: str = "tree"
    extra: Optional[Dict] = None
    shard: int = 0                      # data shard (``slot`` is its row)

    @property
    def done(self) -> bool:
        return self.off >= len(self.prompt)

    @property
    def next_end(self) -> int:
        """The end of the next chunk: the next multiple of ``chunk``, or
        the prompt's end."""
        return min(len(self.prompt), (self.off // self.chunk + 1) * self.chunk)

    @property
    def next_tokens(self) -> int:
        """Tokens the next prefill step will process (0 when done)."""
        return 0 if self.done else self.next_end - self.off


# per-slot (batch-row) surgery: every EngineState field carries the batch
# on axis 0 except the cache dicts (see kvcache.cache.CACHE_BATCH_AXIS)
# and the partial-cache arrays [L, B, ...] (axis 1)
_PKV_FIELDS = ("pkv_k", "pkv_v", "pkv_pos", "pkv_body_k", "pkv_body_v")
_BODY_FIELDS = ("pkv_body_k", "pkv_body_v")
_ROW_FIELDS = ("buf_len", "pending", "pending_len", "seq_len",
               "ext_tokens", "ext_feats", "ext_len", "pkv_blocks", "keys",
               "temps")


def write_state_slot(st: EngineState, sub: EngineState,
                     slot: int) -> EngineState:
    """Write a batch-1 state `sub` into batch row `slot` of `st`, in
    place (admission after a slot prefill, or a slot reset).  Paged: the
    pools pass through; `sub` carries the per-row cache keys only."""
    kvc.write_cache_slot(st.cache, sub.cache, slot)
    kvc.write_draft_slot(st.dcache, sub.dcache, slot)
    for f in _PKV_FIELDS:
        kvc.write_row(getattr(st, f), getattr(sub, f), slot, 1)
    for f in _ROW_FIELDS:
        kvc.write_row(getattr(st, f), getattr(sub, f), slot, 0)
    return st


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1, '{item}'")


def copy_into(dst, src) -> None:
    """Copy a next-state value into its static buffer (a cache dict entry
    by entry); a value that is the buffer itself is skipped.  The launch
    steps write their state back so too."""
    if isinstance(dst, dict):
        for k, v in src.items():
            copy_into(dst[k], v)
    elif src is not dst:
        dst.copy_(src)


class CapturedGraph:
    """A captured step or prefill-chunk body.  The kernel wrappers count
    their launches in Python (``ops.LAUNCHES``, ``ops.WKV_SHAPES``,
    ``ops.WKV_HEADS``), which a replay does not run, so ``replay`` adds
    the counts its capture recorded."""

    def __init__(self, graph, launches: Dict[str, int],
                 wkv_shapes: Dict[Tuple[int, bool], int],
                 wkv_heads: Dict[int, int]):
        self.graph = graph
        self.launches = launches
        self.wkv_shapes = wkv_shapes
        self.wkv_heads = wkv_heads

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launch_counts(self.launches, self.wkv_shapes,
                              self.wkv_heads)


_WARMUP_STREAMS: Dict[Any, Any] = {}


def _warmup_stream(device):
    """The side stream every capture's warm-up runs on, one per device:
    cuBLAS keeps a workspace (32 MiB on the H100) for each stream it ever
    ran on until the process ends, so a new stream per capture would
    hold 32 MiB more after each one."""
    key = torch.device(device)
    if key not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[key] = torch.cuda.Stream(key)
    return _WARMUP_STREAMS[key]


def capture_graph(body, device, static: List[torch.Tensor],
                  pool) -> CapturedGraph:
    """Capture ``body`` as a CUDA graph in the memory pool ``pool``.  A
    warm-up run on a side stream comes first (lazy library and workspace
    set-up must not happen under capture); it writes the state in place,
    so the ``static`` tensors are copied before and restored after it,
    and the first replay is the real call.  State left out of ``static``
    must be state the body rewrites before reading it.  The kernel
    launches counted during the capture are recorded for the replays, and
    neither the warm-up's nor the capture's count.  Any error raises."""
    from repro_torch.kernels import build
    build.load_library()
    counts = ops.launch_counts()
    cur = torch.cuda.current_stream(device)
    saved = [(t, t.clone()) for t in static]
    side = _warmup_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        body()
    cur.wait_stream(side)
    for t, copy in saved:
        t.copy_(copy)
    del saved
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph, pool=pool):
        body()
    delta = ops.launch_count_delta(before, ops.launch_counts())
    ops.set_launch_counts(counts)
    return CapturedGraph(graph, *delta)


def mesh_shards(mesh, batch: int) -> Tuple[int, int]:
    """(data shards, model shards) of an engine of ``batch`` rows over
    ``mesh`` (a ``distributed.sharding.DeviceMesh``): the batch splits
    over the data axes only when they divide it, as the reference
    degrades; the ``model`` axis is tensor parallelism
    (``distributed.tensor_parallel``)."""
    model = mesh.axis_size("model")
    data = mesh.data_size
    return (data if data > 1 and batch % data == 0 else 1), model


class SpecPVEngine:
    def __new__(cls, *args, **kw):
        # a mesh that splits the batch rows builds the data-parallel
        # controller (``core.data_parallel``): one engine per data shard
        mesh = kw.get("mesh")
        if (cls is SpecPVEngine and mesh is not None
                and mesh_shards(mesh, kw["batch"])[0] > 1):
            from repro_torch.core.data_parallel import DataParallelEngine
            cls = DataParallelEngine
        return super().__new__(cls)

    def __init__(self, cfg: ModelConfig, spec: SpecPVConfig,
                 dcfg: DraftConfig, params, draft_params, *,
                 batch: int, max_len: int,
                 partial_verification: bool = True,
                 draft_chain: Optional[bool] = None,
                 temperature: float = 0.0,
                 paged: bool = False,
                 num_pages: Optional[int] = None,
                 num_draft_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 tiered: bool = False,
                 tier_lossless: bool = False,
                 tier_codec: str = "int8",
                 zero_copy: bool = False,
                 mesh=None,
                 device=None,
                 cuda_graphs: Optional[bool] = None):
        """The defaults are the reference's: the contiguous cache
        (``paged=False``) with the gathered partial cache
        (``zero_copy=False``).  Attention targets also run on the paged
        pool (``paged=True``), gathered or zero-copy (``zero_copy=True``,
        paged only), through the page table in place (``spec.use_pallas``)
        or through each layer's materialised view (the reference's data
        flow); every route runs the kernels on the card.  Dense, MoE, VLM
        and audio targets (the draft layer is dense) draft trees
        (``draft_chain=True``: chains); the state archs
        (``ssm``, ``hybrid``) run with ``paged=False`` and chain drafts,
        without partial verification.  ``temperature`` is the lock-step
        ``generate``'s (each row's stream from seed 0) and the default of
        a slot admission, which may set its own with its seed and draft
        shape; the continuous scheduler wants a greedy engine.
        ``mesh`` (``distributed.sharding.DeviceMesh``) shards the engine
        over its ``data`` axis: when the axis divides the batch, the
        constructor returns a ``DataParallelEngine``, whose shards each
        hold their rows, their range of the page pools and a weight
        replica per distinct device; otherwise (or for a mesh of one
        shard) this engine runs on the mesh's first data row.  A
        ``model`` axis of m > 1 splits the engine's weights, attention
        heads and K/V over the row's m model shards
        (``distributed.tensor_parallel``: ``self.tp``, handed to the
        model and the draft beside the whole ``params``), which must
        share one device; the engine then keeps its per-head state
        shard-stacked ([m * L, ..., Hk / m, ...], ``kv_shards`` = m when
        attention splits), and its step bodies and prefill chunks stay
        one CUDA graph each; the state archs stack the recurrent state
        their shards split (RWKV-6's ``wkv``, Griffin's ``rnn_h`` and
        ``conv``) and a cross-attention target its cross rows the same
        way.  Shards on several cards and the host tier raise
        NotImplementedError under it.
        Paged engines share block-aligned prompt prefixes copy-on-write
        across slot admissions (``prefix_cache=True``, the default here
        as in the reference; contiguous engines share nothing):
        ``prefill_begin_slot`` attaches cached leading blocks by
        page-table reference and registers freshly prefilled blocks back;
        idle cached prefixes are evicted LRU under pool pressure.
        ``num_pages`` / ``num_draft_pages`` size the trunk and draft
        pools (default: every row's whole ``max_len``, as lock-step
        ``generate`` needs; the serving scheduler allocates per request
        and gates admission on free pages).
        ``tiered=True`` (paged only) adds the host tier for cold trunk
        pages (``kvcache.offload.TierManager``): after each refresh a
        slot's committed blocks go to host memory as int8
        (``tier_codec="fp8"``: e4m3 at the same bytes;
        ``tier_lossless=True``: the raw bytes, a bit-equal round trip),
        their pages are recycled, and they come back prefetched one mode
        transition ahead of the next refresh (copied synchronously when
        a refresh comes early).  The tier's work runs between the step
        bodies, outside the captured graphs.
        A VLM or audio target (cross layers) takes each request's
        ``extra`` at ``prefill`` / ``generate`` / a slot admission; its
        slot prefills run one cursor at a time, and prefix sharing, which
        cannot key ``extra``, refuses its admissions.
        Runs on ``device`` (CUDA unless ``"cpu"`` is asked for); the
        params must live there.  On the card each step variant and the
        full prefill chunk replay a CUDA graph unless ``cuda_graphs`` is
        False; the CPU runs them eagerly."""
        self.is_attn = cfg.is_attention_arch
        kinds = cfg.layer_kinds()
        # the attention layers (K/V, partial caches) and the cross layers
        # (per-request encoder K/V rows)
        self.l_attn = dn.attn_layer_count(kinds) if self.is_attn else 0
        self.cross = self.is_attn and dn.is_cross_arch(cfg)
        if not self.is_attn and paged:
            raise ValueError("paged KV is attention-only (state archs keep "
                             "O(1) state): pass paged=False")
        if zero_copy and not paged:
            raise ValueError("zero-copy partial verification needs the "
                             "paged cache (paged=True); the contiguous "
                             "layout keeps the gather path")
        if tiered and not paged:
            raise ValueError("tiered KV residency needs the paged cache "
                             "(paged=True)")
        self.mesh = mesh
        self.data_shards = 1
        self.model_shards = 1
        if mesh is not None:
            # one data shard: the rows stay together on the mesh's first
            # device (a mesh of several devices would only replicate them)
            self.model_shards = mesh_shards(mesh, batch)[1]
            if device is not None and \
                    torch.device(device).type != mesh.devices[0].type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.spec = spec
        self.dcfg = dcfg
        self.params = params
        self.dparams = draft_params
        # tensor parallelism: the model shards' weight pieces, and how
        # many pieces the per-head state falls into
        self.tp = None
        self.kv_shards = 1
        if self.model_shards > 1:
            self._tensor_parallel(mesh, tiered)
        self.l_state = self.l_attn * self.kv_shards
        self.hk_state = cfg.num_kv_heads // self.kv_shards
        self.batch = batch
        self.max_len = max_len
        self.temperature = float(temperature)
        self._nb_seq = -(-max_len // spec.block_size)
        self.paged = bool(paged)
        self.num_pages = (num_pages if num_pages is not None
                          else batch * self._nb_seq + 1)
        self.num_draft_pages = (num_draft_pages if num_draft_pages is not None
                                else self.num_pages)
        self._page_alloc = (kvc.PageAllocator(self.num_pages)
                            if self.paged else None)
        self._draft_alloc = (kvc.PageAllocator(self.num_draft_pages)
                             if self.paged else None)
        self.traffic = TrafficMeter()
        # demote/promote bill their link bytes into the same meter
        self._tier = (TierManager(self._page_alloc, lossless=tier_lossless,
                                  codec=tier_codec, traffic=self.traffic)
                      if self.paged and tiered else None)
        self._prefix = (kvc.PrefixCache(spec.block_size)
                        if self.paged and prefix_cache else None)
        # slots with fork-derived sharing still alive: only these can
        # hold a shared page inside a write window (prompt blocks sit
        # below every window and a tail attach copies its block), so the
        # pre-step copy-on-write scans only this set
        self._forked_slots: set = set()
        self._prefill_skipped_tokens = 0
        self._prefix_dedups = 0         # duplicate blocks collapsed
        self.cow_copies = {"trunk": 0, "draft": 0}   # pre-step CoW pages
        self.partial_enabled = bool(partial_verification) and self.is_attn
        self.zero_copy = bool(zero_copy and self.partial_enabled)
        self.gathered = self.partial_enabled and not self.zero_copy
        self._ns_blocks = spec.partial_budget_tokens // spec.block_size
        if draft_chain is None:
            draft_chain = not self.is_attn
        self.tree = (tr.TreeSpec.chain(dcfg.tree_depth) if draft_chain
                     else tr.TreeSpec.from_branch(
                         dcfg.tree_branch[: dcfg.tree_depth]))
        # a slot admitted with draft="chain" masks acceptance to the
        # tree's rank-0 chain: the identity when the tree is a chain
        self._tree_branching = any(bf > 1 for bf in self.tree.branch)
        # host mirrors of the slots' temperatures and draft shapes:
        # ``step_fused`` keys its graph by whether any stepped row samples
        # or drafts a chain
        self._slot_temp = np.full((batch,), self.temperature, np.float32)
        self._slot_chain = np.zeros((batch,), bool)
        self.pmax = spec.buffer_size            # max pending (refresh input)
        self.emax = self.tree.max_path          # max draft-extend per step
        self._pkv_active = False        # lock-step automaton
        self._pkv_active_rows = np.zeros((batch,), bool)   # per slot
        self.dispatches = 0             # fused engine steps executed
        # steps by graph key (has_full, has_partial, has_refresh,
        # has_sampled, has_chain)
        self.dispatch_keys: Dict[Tuple[bool, ...], int] = {}
        self.prefill_dispatches = 0     # slot prefill chunks run
        # slot prefill chunks by (rows, width): a graph ("fused_prefill",
        # rows, chunk) replays for each full-width key
        self.prefill_keys: Dict[Tuple[int, int], int] = {}
        self.final_state = None         # the last ``generate``'s end state
        self.cuda_graphs = (self.device.type == "cuda" if cuda_graphs is None
                            else bool(cuda_graphs))
        if self.cuda_graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs run on the card; the CPU route "
                             "is eager")
        self._graphs: Dict[Any, CapturedGraph] = {}
        self._graph_pool = None
        self.capture_s = 0.0            # host seconds spent capturing
        self._init_static()

    def _tensor_parallel(self, mesh, tiered: bool) -> None:
        """Split the target and the draft over the mesh's first model row
        (``distributed.tensor_parallel.TensorParallel``).  Every shard
        must sit on the engine's device: the step bodies then run each
        shard's kernels in turn on one stream (the K1/K3 merge counters
        are shared safely so), and each stays one CUDA graph.  Shards on
        several cards would need per-card state and collectives between
        cards, which nothing here has yet."""
        from repro_torch.distributed.tensor_parallel import TensorParallel
        item = "Multi-GPU, part 4"
        m = self.model_shards
        what = f"tensor parallelism (a mesh 'model' axis of {m})"
        if tiered:
            _unsupported(f"{what} with the host tier", item)
        row = mesh.model_row(0)
        if any(d != self.device for d in row):
            _unsupported(f"{what} over several devices {row}", item)
        self.tp = TensorParallel(
            self.cfg, self.params, row,
            draft=(dr.draft_model_config(self.cfg), self.dparams))
        self.kv_shards = self.tp.kv_shards

    # ------------------------------------------------------------------
    def _init_pkv(self, b: int):
        cfg = self.cfg
        if not self.is_attn:
            z = torch.zeros((0,), device=self.device)
            return z, z.clone(), z.clone()
        # zero-copy: the retrieved body lives in the pool (routed via
        # pkv_blocks), so the dense arrays carry only the tail buffer
        shape = (self.l_state, b, self.hk_state, self.spec.buffer_size,
                 cfg.head_dim_)
        pkv_k = torch.zeros(shape, dtype=cm.dt(cfg.dtype), device=self.device)
        pkv_pos = torch.full(shape[:-1], -1, dtype=torch.int32,
                             device=self.device)
        return pkv_k, torch.zeros_like(pkv_k), pkv_pos

    def _init_pkv_body(self, b: int, static: bool = False):
        """The gathered body (k, v) [L, b, NS*bs, Hk, Dh] of zeros (size 0
        on axis 2 when not gathered; shape (0,) for a state arch): real
        buffers for the engine's state (``static``), else zero-stride
        zeros that a row write copies from."""
        cfg = self.cfg
        if not self.is_attn:
            z = torch.zeros((0,), device=self.device)
            return z, z.clone()
        p = self.spec.partial_budget_tokens if self.gathered else 0
        shape = (self.l_state, b, p, self.hk_state, cfg.head_dim_)
        dt = cm.dt(cfg.dtype)
        if static:
            return tuple(torch.zeros(shape, dtype=dt, device=self.device)
                         for _ in range(2))
        z = torch.zeros((), dtype=dt, device=self.device).expand(shape)
        return z, z

    def _init_pkv_blocks(self, b: int):
        """Selection table [B, L, Hk, NS] of -1 (unused), for both
        partial forms; [B, 0, 0, 0] for a state arch."""
        if not self.is_attn:
            return torch.zeros((b, 0, 0, 0), dtype=torch.int32,
                               device=self.device)
        return torch.full((b, self.l_state, self.hk_state,
                           self._ns_blocks), -1, dtype=torch.int32,
                          device=self.device)

    def _init_cache(self, b: int) -> Dict:
        """The trunk cache: contiguous rows, or the paged pool (page
        tables filled by ``prefill`` or a slot admission); state archs
        get their recurrent state."""
        if not self.paged:
            return api.init_cache(self.cfg, b, self.max_len, self.spec,
                                  device=self.device,
                                  kv_shards=self.kv_shards)
        return api.init_cache(self.cfg, b, self.max_len, self.spec,
                              paged=True, num_pages=self.num_pages,
                              device=self.device, kv_shards=self.kv_shards)

    def _init_dcache(self, b: int) -> Dict:
        if not self.paged:
            return dr.init_draft_cache(self.cfg, b, self.max_len, self.device)
        return dr.init_paged_draft_cache(self.cfg, b, self.max_len,
                                         self.spec.block_size,
                                         self.num_draft_pages, self.device)

    def _init_static(self) -> None:
        """The engine's one decode state (``state``) and the buffers around
        it, at addresses that never change, so that a captured graph reads
        and writes them; ``prefill`` resets them in place.  The step's
        device constants are built and the kernels' merge counters
        reserved here, before any capture."""
        cfg, b, dev = self.cfg, self.batch, self.device
        dt = cm.dt(cfg.dtype)

        def ints(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)
        pkv_k, pkv_v, pkv_pos = self._init_pkv(b)
        body_k, body_v = self._init_pkv_body(b, static=True)
        self.state = EngineState(
            cache=self._init_cache(b), dcache=self._init_dcache(b),
            pkv_k=pkv_k, pkv_v=pkv_v, pkv_pos=pkv_pos, buf_len=ints(b),
            pending=ints(b, self.pmax), pending_len=ints(b), seq_len=ints(b),
            ext_tokens=ints(b, self.emax),
            ext_feats=torch.zeros((b, self.emax, 3 * cfg.d_model), dtype=dt,
                                  device=dev),
            ext_len=ints(b), pkv_blocks=self._init_pkv_blocks(b),
            pkv_body_k=body_k, pkv_body_v=body_v, keys=ints(b, 2),
            temps=torch.zeros((b,), dtype=torch.float32, device=dev))
        # prefill: the chunk's inputs (by shape) and the carry between chunks
        self._chunk_toks: Dict[Tuple[int, int], torch.Tensor] = {}
        self._prev_feat = torch.zeros((b, 3 * cfg.d_model), dtype=dt,
                                      device=dev)
        self._logits_last = torch.zeros((b, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        # a fused slot prefill's operands for K <= batch cursors, the
        # first K rows of each (``prefill_step_fused``): the rows' page
        # tables and lengths (copied in before each chunk, the lengths
        # out after), their real token counts, the boundary features
        # carried between chunks and the last real token's logits
        nb = self._nb_seq
        self._pf_cache = dict(page_table=ints(b, nb, dtype=torch.int32),
                              length=ints(b, dtype=torch.int32))
        self._pf_dcache = dict(page_table=ints(b, nb, dtype=torch.int32),
                               length=ints(b, dtype=torch.int32))
        self._pf_tv = ints(b, dtype=torch.int32)
        self._pf_prev_feat = torch.zeros((b, 3 * cfg.d_model), dtype=dt,
                                         device=dev)
        self._pf_logits = torch.zeros((b, cfg.vocab_size),
                                      dtype=torch.float32, device=dev)
        # with prefix sharing a chunk also leaves each row's fused feature
        # at each block boundary inside it (row i, entry r: the chunk's
        # position (r + 1) * block - 1), which registration clones on the
        # card
        self._pf_block_feats = (
            torch.zeros((b, nb, 3 * cfg.d_model), dtype=dt, device=dev)
            if self._prefix is not None else None)
        # a cross-attention target's slot prefill (one cursor per round):
        # the cursor's slot's cross K/V rows, copied in before each round
        # so that one graph serves every slot
        self._pf_cross = ({n: torch.zeros_like(self.state.cache[n][:, :1])
                           for n in kvc.CROSS_KEYS} if self.cross else None)
        # contiguous engines: the prefill carry, one row of blocks per slot
        # (``_slot_pools``), allocated at the first slot prefill
        self._carry: Optional[Tuple[Dict, Dict]] = None
        # the step's row operands, one host copy per step: the per-row
        # modes, the mask of the rows that step and of the chain rows
        self._tick_in = ints(3, b, dtype=torch.int8)
        self._modes = self._tick_in[0]
        self._rows = self._tick_in[1].view(torch.bool)
        self._is_chain = self._tick_in[2].view(torch.bool)
        # what the host reads after a step, packed for one copy: tokens
        # [B, D+1], counts, accept_len, pending_len, seq_len [B] each,
        # then (attention archs) pkv_blocks, read after a Refresh
        self._io_head = b * (self.tree.depth + 1 + 4)
        self._io = ints(self._io_head + self.state.pkv_blocks.numel())
        # host mirrors of the rows' pending and sequence lengths: the
        # mode automaton reads these, never the device
        self._host_pending_len = np.ones((b,), np.int64)
        self._host_seq_len = np.zeros((b,), np.int64)
        # and of the draft-extend lengths: with the two above they give
        # each row's commit and draft-extend window starts (prepare_cow)
        self._host_ext_len = np.ones((b,), np.int64)
        self._neutral_sub: Optional[EngineState] = None
        pdev = self.params["embed"].device
        tr.tree_tensors(self.tree, pdev)
        cm.rope_inv_freq_tensor(cfg, pdev)
        cm.rope_inv_freq_tensor(dr.draft_model_config(cfg), pdev)
        if self.is_attn and pdev.type == "cuda":
            ops.reserve_split_counters(ops.split_counter_slots(
                b, self.pmax + self.tree.size, cfg.num_heads,
                cfg.num_kv_heads, self._nb_seq), pdev)

    def _static_tensors(self, pools: bool = True) -> List[torch.Tensor]:
        """Every static tensor; without the K/V of the trunk and draft
        caches and the gathered body if ``pools`` is False."""
        st = self.state
        out: List[torch.Tensor] = []

        def cache_keys(c):
            # no body writes the cross rows: they need no restore
            return [t for k, t in c.items()
                    if pools or k not in ("k", "v") + kvc.CROSS_KEYS]
        for f in fields(EngineState):
            v = getattr(st, f.name)
            if isinstance(v, dict):
                out.extend(cache_keys(v))
            elif pools or f.name not in _BODY_FIELDS:
                out.append(v)
        out += [self._prev_feat, self._logits_last, self._tick_in, self._io,
                self._pf_tv, self._pf_prev_feat, self._pf_logits]
        if self._pf_block_feats is not None:
            out.append(self._pf_block_feats)
        for c in ((self._pf_cache, self._pf_dcache) + (self._carry or ())
                  + ((self._pf_cross,) if self._pf_cross else ())):
            out += cache_keys(c)
        return out + list(self._chunk_toks.values())

    def _chunk_buf(self, b: int, chunk: int) -> torch.Tensor:
        """The static token buffer of a [b, chunk] prefill chunk."""
        toks = self._chunk_toks.get((b, chunk))
        if toks is None:
            toks = torch.zeros((b, chunk), dtype=torch.long,
                               device=self.device)
            self._chunk_toks[(b, chunk)] = toks
        return toks

    def _fill_table(self, table, al: kvc.PageAllocator) -> None:
        """Give every row its whole max_len worth of pages (lock-step
        ``generate``) and write the table in place."""
        al.reset()
        b = table.shape[0]
        if b * self._nb_seq > al.capacity:
            raise ValueError(
                f"paged generate needs {b * self._nb_seq} pages but the "
                f"pool holds {al.capacity}; raise num_pages or serve "
                f"through the continuous scheduler (per-request pages)")
        pt = np.zeros((b, self._nb_seq), np.int32)
        for i in range(b):
            pt[i] = al.alloc(i, self._nb_seq)
        table.copy_(torch.from_numpy(pt))

    def _zero_static(self) -> None:
        """Every static tensor to zero, the -1 sentinels set (Griffin's
        empty window slots among them)."""
        for t in self._static_tensors():
            t.zero_()
        if self.is_attn:
            self.state.pkv_pos.fill_(-1)
            self.state.pkv_blocks.fill_(-1)
        if "win_pos" in self.state.cache:
            self.state.cache["win_pos"].fill_(-1)

    def prefill(self, prompt: np.ndarray, chunk: int = 256,
                extra: Optional[Dict] = None) -> EngineState:
        """Whole-batch chunked prefill into the engine's state, reset in
        place; returns it as the boot state of the lock-step loop (chunk
        boundaries are absolute multiples of ``chunk``).  Every full chunk
        runs one body, captured once as a graph on the card; a short last
        chunk runs eagerly.  A VLM or audio target needs ``extra`` (batch
        rows as the prompt's), whose cross K/V are written into the
        state's rows first; other targets ignore it, as the reference's
        do."""
        assert prompt.shape[0] == self.batch
        api.require_extra(self.cfg, extra, "its prefill")
        self._pkv_active = False
        self._pkv_active_rows[:] = False
        self._slot_temp[:] = self.temperature
        self._slot_chain[:] = False
        self.final_state = None
        self._zero_static()
        st = self.state
        if self.paged:
            self._clear_prefix()        # a reset pool invalidates entries
            self._forked_slots.clear()
            self._fill_table(st.cache["page_table"], self._page_alloc)
            self._fill_table(st.dcache["page_table"], self._draft_alloc)
            if self._tier is not None:
                self._tier.reset()      # host copies of a reset pool
        s0 = prompt.shape[1]
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                   device=self.device)
        if self.cross:
            api.write_cross(self.cfg, self.params, st.cache["cross_k"],
                            st.cache["cross_v"], extra, self.tp)
        body = (lambda toks: self._prefill_body(
            toks, st.cache, st.dcache, self._prev_feat, self._logits_last))
        self._prefill_chunks(prompt_t, 0, s0, chunk, "prefill", body)
        sub = self._boot_state(st.cache, st.dcache, self._logits_last,
                               self._prev_feat, s0)
        for f in fields(EngineState):
            copy_into(getattr(st, f.name), getattr(sub, f.name))
        self._host_pending_len = np.ones((self.batch,), np.int64)
        self._host_seq_len = np.full((self.batch,), s0 + 1, np.int64)
        self._host_ext_len = np.ones((self.batch,), np.int64)
        return st

    def _prefill_chunks(self, toks_t, off: int, end: int, chunk: int,
                        name: str, body) -> None:
        """Run ``body`` over the absolute chunks of ``toks_t[:, off:end]``
        [b, S]: a full chunk replays the graph ``(name, chunk)`` over the
        static token buffer, a short one runs eagerly."""
        while off < end:
            nxt = min(end, (off // chunk + 1) * chunk)
            if nxt - off == chunk:
                toks = self._chunk_buf(toks_t.shape[0], chunk)
                toks.copy_(toks_t[:, off:nxt])
                self._run((name, chunk), lambda: body(toks))
            else:
                body(toks_t[:, off:nxt])
            off = nxt

    def _prefill_body(self, toks, cache, dcache, prev_feat,
                      logits_last, block_feats=None, t_valid=None) -> None:
        """One prefill chunk (trunk, then draft extend) into static
        buffers: the caches (their pools written in place, the lengths
        copied), the boundary feature carried to the next chunk and the
        last token's logits; with ``block_feats`` [B, NB, 3d] (chunks
        that start on a block boundary) also each row's fused feature at
        each block boundary inside its chunk.  ``t_valid`` [B]: a ragged
        chunk (the fused slot prefill, ``_prefill_chunk_fused`` in the
        reference), row b's real tokens being its first ``t_valid[b]``;
        its carried feature and logits are those of its last real
        token."""
        cfg = self.cfg
        b, t = toks.shape
        logits, feats, cache_n = api.prefill(cfg, self.params, toks, cache,
                                             spec=self.spec, t_valid=t_valid,
                                             cached_cross=self.cross,
                                             tp=self.tp)
        fused = feats.fused_input()                           # [B, T, 3d]
        shifted = torch.cat([prev_feat[:, None], fused[:, :-1]], dim=1)
        if t_valid is None:
            valid = torch.ones(toks.shape, dtype=torch.bool,
                               device=toks.device)
            last = fused[:, -1]
        else:
            valid = (torch.arange(t, device=toks.device)[None]
                     < t_valid[:, None])
            last = fused[torch.arange(b, device=toks.device),
                         torch.clamp(t_valid.long() - 1, min=0)]
        dcache_n, _, _ = dr.draft_extend(cfg, self.dcfg, self.dparams,
                                         self.params, dcache, toks, shifted,
                                         valid, tp=self.tp)
        prev_feat.copy_(last)
        logits_last.copy_(logits)
        if block_feats is not None:
            bs = self.spec.block_size
            rows = fused[:, bs - 1::bs]
            if rows.shape[1]:
                block_feats[:, : rows.shape[1]].copy_(rows)
        copy_into(cache, cache_n)
        copy_into(dcache, dcache_n)

    def _boot_state(self, cache: Dict, dcache: Dict, logits_last, prev_feat,
                    s0: int, bonus0: Optional[int] = None,
                    temperature: Optional[float] = None,
                    seed: int = 0) -> EngineState:
        """Post-prefill state of ``b`` rows: the first token (the argmax
        of ``logits_last``, or at ``temperature`` > 0 a draw from the
        rows' first-token keys, or ``bonus0`` when a tail entry stored
        it) seeds the pending and extend queues, the rows' streams come
        from ``seed``, the tail buffer and routed selection are empty.
        Shared by the lock-step prefill and the slot finalise, so both
        build the same automaton state."""
        cfg, dev = self.cfg, self.device
        b = prev_feat.shape[0]
        temp = self.temperature if temperature is None else float(temperature)
        k_first, keys = (self._to_device(k.numpy())
                         for k in smp.seed_keys(seed, b))
        if bonus0 is not None:
            bonus0 = torch.full((b,), bonus0, dtype=torch.long, device=dev)
        elif temp > 0.0:
            _, u = smp.stream_draws(k_first, 1)
            bonus0 = smp.categorical(
                torch.softmax(logits_last.float() / temp, dim=-1), u[:, 0])
        else:
            bonus0 = torch.argmax(logits_last, dim=-1)
        pending = torch.zeros((b, self.pmax), dtype=torch.long, device=dev)
        pending[:, 0] = bonus0
        ext_tokens = torch.zeros((b, self.emax), dtype=torch.long, device=dev)
        ext_tokens[:, 0] = bonus0
        ext_feats = torch.zeros((b, self.emax, 3 * cfg.d_model),
                                dtype=cm.dt(cfg.dtype), device=dev)
        ext_feats[:, 0] = prev_feat
        pkv_k, pkv_v, pkv_pos = self._init_pkv(b)
        body_k, body_v = self._init_pkv_body(b)

        def full(v):
            return torch.full((b,), v, dtype=torch.long, device=dev)
        return EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=full(0), pending=pending,
            pending_len=full(1), seq_len=full(s0 + 1), ext_tokens=ext_tokens,
            ext_feats=ext_feats, ext_len=full(1),
            pkv_blocks=self._init_pkv_blocks(b), pkv_body_k=body_k,
            pkv_body_v=body_v, keys=keys,
            temps=torch.full((b,), temp, dtype=torch.float32, device=dev))

    # ------------------------------------------------------------------
    # per-slot state (continuous batching)
    def _neutral_state(self) -> EngineState:
        """One dead row: its page tables on the null page (contiguous: its
        cache rows zero), lengths 0, one placeholder token pending so no
        index underflows, no tail buffer, body or selection.  The zero
        rows are zero-stride, so the neutral row costs no memory."""
        cfg, dev = self.cfg, self.device
        pkv_k, pkv_v, pkv_pos = self._init_pkv(1)
        body_k, body_v = self._init_pkv_body(1)

        def zeros_like_row(t, axis):
            shape = list(t.shape)
            shape[axis] = 1
            return torch.zeros((), dtype=t.dtype, device=dev).expand(shape)

        def row(cache, axes):
            if self.paged:
                out = dict(page_table=torch.zeros(
                    (1, self._nb_seq), dtype=torch.int32, device=dev))
            else:
                # a dead row's cross rows are never read into a result:
                # they stay (a slot admission writes them before this)
                out = {k: zeros_like_row(t, axes.get(k, 0))
                       for k, t in cache.items()
                       if k not in ("length",) + kvc.CROSS_KEYS}
            out["length"] = torch.zeros((1,), dtype=torch.int32, device=dev)
            return out

        def full(v, *shape):
            return torch.full(shape or (1,), v, dtype=torch.long, device=dev)
        return EngineState(
            cache=row(self.state.cache, kvc.CACHE_BATCH_AXIS),
            dcache=row(self.state.dcache, {}), pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=full(0), pending=full(0, 1, self.pmax),
            pending_len=full(1), seq_len=full(1),
            ext_tokens=full(0, 1, self.emax),
            ext_feats=torch.zeros((1, self.emax, 3 * cfg.d_model),
                                  dtype=cm.dt(cfg.dtype), device=dev),
            ext_len=full(1), pkv_blocks=self._init_pkv_blocks(1),
            pkv_body_k=body_k, pkv_body_v=body_v, keys=full(0, 1, 2),
            temps=torch.zeros((1,), dtype=torch.float32, device=dev))

    def _slots_only(self) -> None:
        if not self.is_attn:
            raise ValueError("continuous batching drives the attention "
                             "automaton; state archs serve lock-step "
                             "(ServingEngine's wave path)")

    def empty_state(self) -> EngineState:
        """The engine's state with every slot dead and both page pools
        empty (continuous-scheduler boot)."""
        self._slots_only()
        self._pkv_active = False
        self._pkv_active_rows[:] = False
        self._slot_temp[:] = 0.0
        self._slot_chain[:] = False
        self.final_state = None
        if self.paged:
            self._clear_prefix()
            self._page_alloc.reset()
            self._draft_alloc.reset()
            self._forked_slots.clear()
            if self._tier is not None:
                self._tier.reset()
        self._zero_static()
        st = self.state
        for t in (st.pending_len, st.seq_len, st.ext_len):
            t.fill_(1)
        self._host_pending_len = np.ones((self.batch,), np.int64)
        self._host_seq_len = np.ones((self.batch,), np.int64)
        self._host_ext_len = np.ones((self.batch,), np.int64)
        return st

    def _clear_prefix(self) -> None:
        if self._prefix is not None:
            self._prefix.clear(self._page_alloc, self._draft_alloc)

    def clear_slot_rows(self, st: EngineState, slot: int) -> EngineState:
        """Write the neutral row into a slot's device rows (page tables ->
        null page, lengths 0) without touching the allocators.  Every step
        runs all B rows and routes each row's writes through its own
        table, so an inactive row must never keep a stale table: a
        mid-prefill slot's table lives in its ``PrefillCursor``."""
        self._own(st)
        if self._neutral_sub is None:
            self._neutral_sub = self._neutral_state()
        self._pkv_active_rows[slot] = False
        self._slot_temp[slot] = 0.0
        self._slot_chain[slot] = False
        self._host_pending_len[slot] = 1
        self._host_seq_len[slot] = 1
        self._host_ext_len[slot] = 1
        return write_state_slot(st, self._neutral_sub, slot)

    def reset_slot(self, st: EngineState, slot: int) -> EngineState:
        """Evict a slot: release its page references and pins (pages
        still shared with another slot or held by the prefix cache stay
        resident), then neutralise its rows (pool contents are left
        stale; nothing reads them once unmapped)."""
        self.release_slot_pages(slot)
        return self.clear_slot_rows(st, slot)

    # ---- page accounting (host side) ---------------------------------
    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request needs end to end (see request_token_need),
        assuming a cold prefix cache."""
        toks = request_token_need(prompt_len, max_new_tokens, self.pmax,
                                  self.emax)
        return min(-(-toks // self.spec.block_size), self._nb_seq)

    def prefix_match_blocks(self, prompt: np.ndarray,
                            touch: bool = False,
                            shard: Optional[int] = None) -> int:
        """Probe: the leading full blocks of `prompt` the prefix cache can
        serve now (capped one block short of the prompt, so the tail
        prefill is never empty).  ``touch`` re-stamps the chain MRU;
        ``shard`` counts only what a slot of that data shard may attach
        (``_shard_chain``)."""
        if self._prefix is None:
            return 0
        bs = self.spec.block_size
        entries = self._prefix.match(np.asarray(prompt),
                                     (len(prompt) - 1) // bs,
                                     touch=touch, count=False)
        return len(self._shard_chain(entries, shard))

    def pages_needed_shared(self, prompt: np.ndarray, max_new_tokens: int,
                            touch: bool = False,
                            shard: Optional[int] = None,
                            temperature: Optional[float] = None) -> int:
        """Fresh pages the request needs now: the cold count less the
        blocks the prefix cache holds (they attach by reference).  A
        whole-prompt tail-entry hit discounts every full block and keeps
        the tail block billed (its attach copies it into a fresh page).
        ``temperature`` is the request's (default: the engine's): tail
        discounts apply to greedy requests only, as the entry stores the
        greedy first token.  ``shard`` discounts only the entries a slot
        of that data shard may attach."""
        temp = self.temperature if temperature is None else float(temperature)
        need = self.pages_needed(len(prompt), max_new_tokens)
        if self._prefix is not None and temp == 0.0:
            tail = self._prefix.match_tail(np.asarray(prompt), touch=touch,
                                           count=False)
            if tail is not None and (shard is None
                                     or self._tail_on_shard(tail, shard)):
                return max(need - len(prompt) // self.spec.block_size, 0)
        return max(need - self.prefix_match_blocks(prompt, touch=touch,
                                                   shard=shard), 0)

    def free_pages(self, shard: Optional[int] = None) -> int:
        """Fresh pages available for admission: the tighter of the trunk
        and draft pools, or of one data shard's ranges of them (a request
        admitted to a shard draws only its pages)."""
        if not self.paged:
            return 1 << 30
        if shard is None or self.data_shards == 1:
            return min(self._page_alloc.free, self._draft_alloc.free)
        return min(self._page_alloc.free_in(shard),
                   self._draft_alloc.free_in(shard))

    def page_capacity(self) -> int:
        return self._page_alloc.capacity if self.paged else 1 << 30

    def reclaim_pages(self, n: int) -> int:
        """LRU-evict idle cached prefixes until `n` trunk pages are freed
        (or no unreferenced entry is left).  Returns trunk pages freed."""
        if self._prefix is None or n <= 0:
            return 0
        return self._prefix.evict_lru(self._page_alloc, self._draft_alloc, n)

    # ---- data shards (one unless the engine is data-parallel) ---------
    def shard_of_slot(self, slot: int) -> int:
        """The data shard owning batch row `slot`: contiguous ranges, as a
        data-axis split of the batch dim places them."""
        return slot * self.data_shards // self.batch

    def shard_slots(self, shard: int) -> range:
        """The batch rows of `shard` (contiguous)."""
        b, n = self.batch, self.data_shards
        return range(shard * b // n, (shard + 1) * b // n)

    def _shard_chain(self, entries, shard: Optional[int]):
        """A matched prefix chain cut at its first entry whose page lives
        off `shard`: a slot attaches only pages its own shard holds
        (hash-equal blocks are prefilled again on each shard)."""
        if shard is None or self.data_shards == 1:
            return entries
        out = []
        for e in entries:
            if self._page_alloc.page_shard(e.page) != shard:
                break
            out.append(e)
        return out

    def _tail_on_shard(self, tail, shard: int) -> bool:
        """May this whole-prompt tail hit serve a slot of `shard`?"""
        if self.data_shards == 1:
            return True
        chain, e = tail
        return (all(self._page_alloc.page_shard(c.page) == shard
                    for c in chain)
                and self._page_alloc.page_shard(e.page) == shard)

    # ---- tiered residency (no-ops untiered) --------------------------
    @property
    def tiered(self) -> bool:
        return self._tier is not None

    def tier_stats(self) -> Dict[str, int]:
        """Demote, promote and prefetch counters ({} untiered)."""
        return self._tier.stats() if self._tier is not None else {}

    def _refresh_within(self, pending_len: int) -> bool:
        """Could this slot's automaton ask for a refresh after one more
        partial step that accepted the longest path?  The prefetch
        trigger: issued one mode transition ahead, the copy to the card
        overlaps the partial step left."""
        return self.mode_for(pending_len + self.emax + 1,
                             self.spec.partial_budget_tokens + 1,
                             True) == "refresh"

    def tier_admit_margin(self, prompt_len: int) -> int:
        """Free pages (beyond the request's own bill) a tiered admission
        must leave so that no live slot's promotion debt outgrows what
        the pool can seat again: the worst live debt less what the new
        request repays at its first refresh (``prompt_len // block``
        pages, if its prompt passes the partial budget).  Untiered: 0."""
        if self._tier is None:
            return 0
        cold_new = (prompt_len // self.spec.block_size
                    if prompt_len > self.spec.partial_budget_tokens else 0)
        return max(self._page_alloc.max_hosted() - cold_new, 0)

    def tier_ready_rows(self, rows: np.ndarray, modes: np.ndarray,
                        force: bool = True) -> Tuple[np.ndarray, int]:
        """Defer the full-cache rows whose promotion cannot be seated this
        tick: returns (rows less the deferred slots, the number deferred).
        A deferred slot skips the tick; other slots' demotions give pages
        back and ``tier_admit_margin`` bounds every debt.  If every row
        would defer and ``force`` is set, the smallest debt steps anyway
        (its promotion then reclaims idle prefixes or raises).  A caller
        whose prefill pump made progress this tick passes
        ``force=False``: an open cursor holds its whole page bill until
        its first refresh, and its completion is what frees the pool.
        Untiered: every row."""
        if self._tier is None:
            return rows, 0
        al = self._page_alloc
        budget = al.free + al.idle      # a promotion reclaims idle prefixes
        out = rows.copy()
        deferred = []
        for i in np.nonzero(rows)[0]:
            i = int(i)
            if modes[i] == MODE_PARTIAL:
                continue
            need = al.hosted_count(i)
            if need == 0:
                continue
            if need <= budget:
                budget -= need
            else:
                out[i] = False
                deferred.append((need, i))
        if deferred and not out.any() and force:
            _, i = min(deferred)
            out[i] = True
            deferred = [d for d in deferred if d[1] != i]
        return out, len(deferred)

    def _tier_promote_rows(self, st: EngineState, rows: np.ndarray,
                           modes: np.ndarray) -> None:
        """Before the dispatch: every stepping row about to read the full
        cache (Full or Refresh) gets its hosted pages seated, prefetched
        segments without waiting on the host link, the rest copied on
        the engine's stream (the early-refresh path)."""
        al = self._page_alloc
        for i in np.nonzero(rows)[0]:
            i = int(i)
            if modes[i] == MODE_PARTIAL:
                continue
            need = al.hosted_count(i)
            if need == 0:
                continue
            if need > al.free:
                self.reclaim_pages(need - al.free)
            self._tier.promote_slot(st.cache, i)

    def _tier_epilogue(self, rows: np.ndarray, modes: np.ndarray) -> None:
        """After the dispatch: rows that just refreshed go back to partial
        steps, so their committed blocks are cold: demote them (a forked
        row's pages are shared and stay).  A partial row whose automaton
        may refresh on its next step starts its prefetch.  Lengths come
        from the host mirrors the step's read-back left (trunk length =
        sequence length - pending)."""
        cache = self.state.cache
        for i in np.nonzero(rows)[0]:
            i = int(i)
            if modes[i] == MODE_REFRESH and i not in self._forked_slots:
                self._tier.demote_slot(cache, i, int(
                    self._host_seq_len[i] - self._host_pending_len[i]))
            elif (modes[i] == MODE_PARTIAL
                    and self._page_alloc.hosted_count(i)
                    and self._refresh_within(int(self._host_pending_len[i]))):
                self._tier.prefetch_slot(i)

    def release_slot_pages(self, slot: int) -> None:
        """Release an evicted slot's page references and pins (and its
        host copies) ahead of the deferred row reset, so same-tick
        admission sees them."""
        if self.paged:
            self._page_alloc.free_slot(slot)
            self._draft_alloc.free_slot(slot)
            self._forked_slots.discard(slot)
            if self._tier is not None:
                self._tier.drop_slot(slot)

    def reset_high_water(self) -> None:
        """Zero the page high-water marks (benchmark warm-up)."""
        if self.paged:
            for al in (self._page_alloc, self._draft_alloc):
                al.high_water = 0
                al.resident_high_water = 0
                al.high_water_by = [0] * al.shards

    def page_stats(self) -> Dict[str, int]:
        al = self._page_alloc
        if al is None:
            return {}
        out = dict(num_pages=self.num_pages, capacity=al.capacity,
                   in_use=al.in_use, idle=al.idle, committed=al.committed,
                   high_water=al.high_water,
                   resident_high_water=al.resident_high_water,
                   draft_num_pages=self.num_draft_pages,
                   draft_in_use=self._draft_alloc.in_use,
                   draft_high_water=self._draft_alloc.high_water,
                   contiguous_pages=self.batch * self._nb_seq,
                   block_size=self.spec.block_size,
                   pinned_pages=al.pinned_pages)
        if self.data_shards > 1:
            out["data_shards"] = self.data_shards
            out["peak_pages_per_host"] = al.peak_pages_per_host
            for sh in range(al.shards):
                out[f"high_water_shard_{sh}"] = al.high_water_by[sh]
        out.update(self.tier_stats())
        return out

    def reset_prefix_stats(self) -> None:
        """Zero the prefix-cache hit and reuse counters (benchmark
        warm-up); the cached entries stay."""
        self._prefill_skipped_tokens = 0
        self._prefix_dedups = 0
        if self._prefix is not None:
            self._prefix.reset_stats()

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache counters ({} when sharing is off): hit and seen
        blocks, tail hits, prompt tokens whose prefill was skipped,
        duplicate blocks collapsed, entries resident."""
        if self._prefix is None:
            return {}
        out = self._prefix.stats()
        out["prefill_tokens_skipped"] = self._prefill_skipped_tokens
        out["dedups"] = self._prefix_dedups
        return out

    def save_prefix_state(self, st: EngineState) -> Optional[dict]:
        """Host snapshot of the prefix cache with its pages' bytes (CPU
        tensors), for ``restore_prefix_state`` after an engine rebuild.
        None when sharing is off."""
        if self._prefix is None:
            return None
        self._own(st)

        def page_bytes(page: int, draft_page: int) -> dict:
            return {
                "trunk": {k: st.cache[k][:, page].to("cpu", copy=True)
                          for k in kvc.PAGED_POOL_KEYS},
                "draft": {k: st.dcache[k][draft_page].to("cpu", copy=True)
                          for k in kvc.DRAFT_POOL_KEYS}}
        return self._prefix.save_state(page_bytes)

    def restore_prefix_state(self, st: EngineState, snap: Optional[dict],
                             shard: int = 0) -> Tuple[EngineState, int]:
        """Re-seat a ``save_prefix_state`` snapshot: each entry whose chain
        hash re-verifies (``PrefixCache.load_state``) gets cache-only pages
        of data shard ``shard`` in both pools and its bytes written back.
        Returns (state, entries restored)."""
        if self._prefix is None or snap is None:
            return st, 0
        self._own(st)
        al, dal = self._page_alloc, self._draft_alloc

        def seat_pages(d: dict, sh: int) -> Tuple[int, int]:
            (page,) = al.alloc_cache(1, sh)
            try:
                (dpage,) = dal.alloc_cache(1, sh)
            except RuntimeError:
                al.dec_ref([page], cache=True)
                raise
            for k, blob in d["pages"]["trunk"].items():
                st.cache[k][:, page].copy_(blob)
            for k, blob in d["pages"]["draft"].items():
                st.dcache[k][dpage].copy_(blob)
            return page, dpage

        def feat(f):
            return torch.as_tensor(f).to(device=self.device,
                                         dtype=cm.dt(self.cfg.dtype))
        return st, self._prefix.load_state(snap, al, dal, seat_pages,
                                           shard=shard, feat=feat)

    # ---- resumable prefill into one slot -----------------------------
    def prefill_begin_slot(self, st: EngineState, slot: int,
                           prompt: np.ndarray, chunk: int = 256,
                           extra: Optional[Dict] = None,
                           max_new_tokens: Optional[int] = None,
                           temperature: Optional[float] = None,
                           seed: int = 0, draft: str = "tree"
                           ) -> Tuple[EngineState, PrefillCursor]:
        """Open a resumable prefill of `prompt` into batch row `slot`;
        drive it with ``prefill_step_into_slot`` (one chunk per call) and
        commit it with ``prefill_finalize_slot``.  The prefix cache is
        consulted first: a whole-prompt tail-entry hit attaches the whole
        prompt and skips prefill (``_attach_tail_slot``); otherwise the
        matched leading blocks attach by page-table reference (their
        prefill is skipped) before any reclaim, so LRU eviction for the
        fresh remainder cannot take them.  The whole page plan, fresh
        prompt blocks plus the decode reserve sized by ``max_new_tokens``
        (default: the rest of max_len), is allocated here, so later steps
        never fail on pool exhaustion; raises RuntimeError, with the
        attach rolled back, when the pools cannot cover it even after LRU
        eviction.  The slot's device rows are neutralised: decode steps
        may run between chunks.  ``temperature`` (default: the engine's),
        ``seed`` and ``draft`` ("tree" or "chain") are the request's
        sampling knobs: finalise derives the slot's stream from the seed
        alone, so its tokens do not depend on its neighbours or on when
        it was admitted.  Only a greedy request boots from a tail entry
        (the entry stores the greedy first token); a sampled one still
        attaches the prompt's cached full blocks.  A VLM or audio
        target's request brings ``extra`` (batch 1), whose cross K/V are
        written into the slot's rows here; the cursor carries it.  The
        prefix cache keys prompt tokens only, and past a cross layer the
        trunk's K/V depend on ``extra`` too, so an admission with
        ``extra`` into an engine with prefix sharing raises ValueError,
        as the reference asserts."""
        self._slots_only()
        self._own(st)
        api.require_extra(self.cfg, extra, "its prefill")
        if extra is not None and self._prefix is not None:
            raise ValueError("prefix sharing cannot key per-request `extra` "
                             "conditioning; build the engine with "
                             "prefix_cache=False")
        if draft not in ("tree", "chain"):
            raise ValueError(f"draft must be 'tree' or 'chain', not {draft!r}")
        knobs = dict(temperature=(self.temperature if temperature is None
                                  else float(temperature)),
                     seed=int(seed), draft=draft,
                     extra=extra if self.cross else None)
        prompt = np.asarray(prompt)
        if self.cross:
            # in place, into the live state's rows of the slot (dead while
            # it prefills): the graphs read these addresses
            api.write_cross(self.cfg, self.params,
                            *(st.cache[n][:, slot: slot + 1]
                              for n in kvc.CROSS_KEYS), extra, self.tp)
        if not self.paged:
            # the slot's rows of the prefill carry, from zero as a fresh
            # row cache; nothing to account
            nb = self._nb_seq
            pools, dpools = self._slot_pools(st)
            lo = 1 + slot * nb
            for a in pools.values():
                a[:, lo: lo + nb].zero_()
            for a in dpools.values():
                a[lo: lo + nb].zero_()
            rows = lo + np.arange(nb, dtype=np.int32)
            cur = PrefillCursor(
                slot=slot, prompt=prompt, chunk=chunk, off=0,
                prev_feat=torch.zeros((1, 3 * self.cfg.d_model),
                                      dtype=cm.dt(self.cfg.dtype),
                                      device=self.device),
                row_cache=self._cursor_row(rows, 0),
                row_dcache=self._cursor_row(rows, 0),
                tokens=torch.as_tensor(prompt, dtype=torch.long,
                                       device=self.device), **knobs)
            return self.clear_slot_rows(st, slot), cur
        bs = self.spec.block_size
        if self._prefix is not None and chunk % bs:
            raise ValueError(f"prefix sharing registers whole blocks per "
                             f"chunk: chunk {chunk} is not a multiple of "
                             f"the block size {bs}")
        al, dal = self._page_alloc, self._draft_alloc
        al.free_slot(slot)                      # stale pages, if any
        dal.free_slot(slot)
        self._forked_slots.discard(slot)        # a fresh request, no fork
        if self._tier is not None:
            self._tier.drop_slot(slot)          # stale host copies too
        budget = (max_new_tokens if max_new_tokens is not None
                  else max(self.max_len - len(prompt), 0))
        total = self.pages_needed(len(prompt), budget)
        tail = (self._prefix.match_tail(prompt)
                if self._prefix is not None and knobs["temperature"] == 0.0
                else None)
        if tail is not None:
            return self._attach_tail_slot(st, slot, prompt, chunk, total,
                                          tail, knobs)
        entries = (self._prefix.match(prompt, (len(prompt) - 1) // bs)
                   if self._prefix is not None else [])
        n_match = len(entries)
        pt_host = np.zeros((self._nb_seq,), np.int32)
        dpt_host = np.zeros((self._nb_seq,), np.int32)
        dev = self.device
        if n_match:
            al.attach(slot, [e.page for e in entries])
            dal.attach(slot, [e.draft_page for e in entries])
            pt_host[:n_match] = [e.page for e in entries]
            dpt_host[:n_match] = [e.draft_page for e in entries]
            # a copy: the cursor's carry is written in place every chunk
            prev_feat = entries[-1].feat[None].clone()
        else:
            prev_feat = torch.zeros((1, 3 * self.cfg.d_model),
                                    dtype=cm.dt(self.cfg.dtype), device=dev)
        fresh = total - n_match
        if fresh > self.free_pages():
            self.reclaim_pages(fresh - self.free_pages())
        if fresh > self.free_pages():
            al.free_slot(slot)                  # roll the attach back
            dal.free_slot(slot)
            raise RuntimeError(
                f"slot {slot}: request needs {fresh} fresh pages "
                f"({n_match} shared), {al.free}/{dal.free} free "
                f"(trunk/draft) of {al.capacity}")
        self._prefill_skipped_tokens += n_match * bs
        start = n_match * bs
        if fresh:                               # tail blocks + decode reserve
            pt_host[n_match:total] = al.alloc(slot, fresh)
            dpt_host[n_match:total] = dal.alloc(slot, fresh)
        n_full = len(prompt) // bs
        cur = PrefillCursor(
            slot=slot, prompt=prompt, chunk=chunk, off=start,
            prev_feat=prev_feat, row_cache=self._cursor_row(pt_host, start),
            row_dcache=self._cursor_row(dpt_host, start),
            tokens=torch.as_tensor(prompt, dtype=torch.long, device=dev),
            pt_host=pt_host, dpt_host=dpt_host, total_pages=total,
            n_match=n_match, n_full=n_full,
            chain_keys=(self._prefix.chain_keys(prompt, n_full)
                        if self._prefix is not None and n_full > n_match
                        else []),
            chain_entries=list(entries), **knobs)
        return self.clear_slot_rows(st, slot), cur

    def _cursor_row(self, pt_host: np.ndarray, length: int) -> Dict:
        """A cursor's device row: its page table and length (batch 1)."""
        dev = self.device
        return dict(page_table=torch.as_tensor(pt_host[None], device=dev),
                    length=torch.full((1,), length, dtype=torch.int32,
                                      device=dev))

    def _copy_pool_page(self, cache: Dict, src: int, dst: int, *,
                        draft: bool) -> None:
        """Copy one physical page's contents, every pool key (the trunk's
        page summaries included), from page `src` to page `dst` in place
        on the engine's stream: later writes to a freed `src` stay ordered
        after this read."""
        for n in (kvc.DRAFT_POOL_KEYS if draft else kvc.PAGED_POOL_KEYS):
            a = cache[n]
            if draft:
                a[dst].copy_(a[src])
            else:
                a[:, dst].copy_(a[:, src])

    def _attach_tail_slot(self, st: EngineState, slot: int,
                          prompt: np.ndarray, chunk: int, total: int,
                          tail, knobs: Dict
                          ) -> Tuple[EngineState, PrefillCursor]:
        """Whole-prompt tail-entry hit: attach the full-block chain by
        reference, copy the cached tail page into a fresh page of the slot
        on the card (its first decode commit writes into that block, so
        only forked slots ever hold a shared page inside a write window),
        skip prefill, and boot from the entry's boundary feature and
        greedy first token.  The tail block is billed as a fresh page, as
        ``pages_needed_shared`` counts it."""
        entries, te = tail
        al, dal = self._page_alloc, self._draft_alloc
        n_match = len(entries)
        pt_host = np.zeros((self._nb_seq,), np.int32)
        dpt_host = np.zeros((self._nb_seq,), np.int32)
        al.attach(slot, [e.page for e in entries])
        dal.attach(slot, [e.draft_page for e in entries])
        pt_host[:n_match] = [e.page for e in entries]
        dpt_host[:n_match] = [e.draft_page for e in entries]
        fresh = total - n_match                 # the tail block included
        if fresh > self.free_pages():
            self.reclaim_pages(fresh - self.free_pages())
        if fresh > self.free_pages():
            al.free_slot(slot)                  # roll the attach back
            dal.free_slot(slot)
            raise RuntimeError(
                f"slot {slot}: request needs {fresh} fresh pages "
                f"({n_match} shared), {al.free}/{dal.free} free "
                f"(trunk/draft) of {al.capacity}")
        pt_host[n_match:total] = al.alloc(slot, fresh)
        dpt_host[n_match:total] = dal.alloc(slot, fresh)
        self._copy_pool_page(st.cache, te.page, int(pt_host[n_match]),
                             draft=False)
        self._copy_pool_page(st.dcache, te.draft_page,
                             int(dpt_host[n_match]), draft=True)
        self._prefill_skipped_tokens += len(prompt)
        s0 = len(prompt)
        cur = PrefillCursor(
            slot=slot, prompt=prompt, chunk=chunk, off=s0,
            prev_feat=te.feat[None].clone(),
            row_cache=self._cursor_row(pt_host, s0),
            row_dcache=self._cursor_row(dpt_host, s0),
            pt_host=pt_host, dpt_host=dpt_host, total_pages=total,
            n_match=n_match, n_full=n_match, boot_token=te.first_token,
            **knobs)
        return self.clear_slot_rows(st, slot), cur

    def _register_tail(self, st: EngineState, cur: PrefillCursor) -> None:
        """Register a prefilled prompt's final partial block as a
        whole-prompt tail entry, then give the slot a private copy of that
        block (``cow_write`` and a page copy): its next commit writes into
        the block, and the cached bytes must stay as registered.  Skipped
        for block-aligned prompts, an incomplete chain, a sampled request
        (the entry stores the greedy first token) or no free page.  Reads
        the greedy first token to the host (once per admission)."""
        if self._prefix is None or cur.temperature != 0.0:
            return
        bs = self.spec.block_size
        prompt = cur.prompt
        n_full = len(prompt) // bs
        if len(prompt) == n_full * bs or self.free_pages() < 1:
            return
        if n_full and len(cur.chain_entries) < n_full:
            return                  # chain incomplete: the tail'd be orphaned
        al, dal = self._page_alloc, self._draft_alloc
        parent = (cur.chain_entries[-1].key if n_full
                  else kvc.PrefixCache._ROOT)
        e = self._prefix.register_tail(
            parent, prompt[n_full * bs:], n_full, int(cur.pt_host[n_full]),
            int(cur.dpt_host[n_full]), cur.prev_feat[0].clone(),
            int(torch.argmax(cur.logits_last[0])), al, dal)
        if e is None:
            return
        for ent in cur.chain_entries:   # parent never older than the tail
            ent.tick = e.tick
        old, new = al.cow_write(cur.slot, n_full)
        self._copy_pool_page(st.cache, old, new, draft=False)
        dold, dnew = dal.cow_write(cur.slot, n_full)
        self._copy_pool_page(st.dcache, dold, dnew, draft=True)
        cur.pt_host[n_full] = new
        cur.dpt_host[n_full] = dnew
        # fill_ of the one entry: an item assignment would copy a host
        # scalar and wait for the card
        cur.row_cache["page_table"][0, n_full].fill_(new)
        cur.row_dcache["page_table"][0, n_full].fill_(dnew)

    def prefill_step_into_slot(self, st: EngineState, cur: PrefillCursor
                               ) -> Tuple[EngineState, int]:
        """Advance `cur` by exactly one chunk (chunk boundaries absolute):
        ``prefill_step_fused`` over this one cursor, whose every position
        is real, so its body is the serial chunk's.  Returns (state,
        tokens processed)."""
        if cur.done:
            raise ValueError("prefill cursor already exhausted")
        return self._prefill_round(st, [cur])

    def prefill_step_fused(self, st: EngineState,
                           cursors: List[PrefillCursor]
                           ) -> Tuple[EngineState, int]:
        """Advance every open cursor of `cursors` by one chunk in one
        ragged body (``_prefill_round``).  Per-request ``extra`` cannot be
        batched (the reference asserts it): a cursor that carries it
        raises ValueError, and goes through ``prefill_step_into_slot``."""
        if any(c.extra is not None for c in cursors):
            raise ValueError("fused prefill cannot batch per-request "
                             "`extra` conditioning: step such a cursor "
                             "with prefill_step_into_slot")
        return self._prefill_round(st, cursors)

    def _prefill_round(self, st: EngineState, cursors: List[PrefillCursor]
                       ) -> Tuple[EngineState, int]:
        """Advance every open cursor of `cursors` by one chunk in one
        ragged [K, Tmax] body (the reference's ``prefill_step_fused`` and
        its jitted ``_prefill_chunk_fused``), K at most the batch.  Each
        row runs its own absolute chunk schedule (``next_end``); a row
        with a shorter chunk is packed to ``Tmax`` with pads on the right,
        which write no K/V (the null page), no summary and no length, so
        each row's caches, carried feature and logits are those of its
        serial step, with the same kernels over its own blocks.  A round
        with a full ``chunk`` replays the graph ``("fused_prefill", K,
        chunk)`` over the first K rows of the static ``_pf_*`` buffers;
        a shorter one (every row at its prompt's end, or just past a
        prefix match) runs eagerly.  The rows' page tables are copied in
        before the chunk and their lengths set after; then the prompt
        blocks each row completed are registered in the prefix cache, row
        by row in cursor order, so two cursors completing the same block
        in one call dedupe as serial steps would.  A cross-attention
        target's round takes one cursor: its slot's cross rows are copied
        into the static ``_pf_cross`` first, so the graph ``("fused_prefill",
        1, chunk)`` reads whichever slot's rows the round is for.
        Returns (state, tokens processed); ``prefill_dispatches`` counts
        the calls."""
        cursors, ctx = self._prefill_launch(st, cursors)
        for i, c in enumerate(cursors):
            self._prefill_advance(ctx, i, c)
        return st, ctx["tokens"]

    def _prefill_launch(self, st: EngineState, cursors: List[PrefillCursor]
                        ) -> Tuple[List[PrefillCursor], Dict]:
        """The device half of ``_prefill_round``: the round's body,
        launched.  Returns (the open cursors, what ``_prefill_advance``
        reads for each)."""
        self._own(st)
        cursors = [c for c in cursors if not c.done]
        if not cursors:
            raise ValueError("no open prefill cursor")
        k = len(cursors)
        chunk = cursors[0].chunk
        if k > self.batch or any(c.chunk != chunk for c in cursors):
            raise ValueError(f"a fused prefill takes at most {self.batch} "
                             f"cursors of one chunk size")
        offs = [c.off for c in cursors]
        ends = [c.next_end for c in cursors]
        nvalid = [e - o for o, e in zip(offs, ends)]
        tmax = max(nvalid)
        pools, dpools = self._slot_pools(st)
        cache = dict(pools, page_table=self._pf_cache["page_table"][:k],
                     length=self._pf_cache["length"][:k])
        if self.cross:
            if k != 1:
                raise ValueError("a cross-attention target prefills one "
                                 "cursor per round")
            sl = cursors[0].slot
            for n in kvc.CROSS_KEYS:
                self._pf_cross[n].copy_(st.cache[n][:, sl: sl + 1])
                cache[n] = self._pf_cross[n]
        dcache = dict(dpools, page_table=self._pf_dcache["page_table"][:k],
                      length=self._pf_dcache["length"][:k])
        tv, prev = self._pf_tv[:k], self._pf_prev_feat[:k]
        logits = self._pf_logits[:k]
        feats = (self._pf_block_feats[:k] if self._pf_block_feats is not None
                 else None)
        graph = tmax == chunk
        toks = (self._chunk_buf(k, chunk) if graph else
                torch.zeros((k, tmax), dtype=torch.long, device=self.device))
        # fill_ of host ints: an item assignment would wait for the card
        for i, c in enumerate(cursors):
            cache["page_table"][i].copy_(c.row_cache["page_table"][0])
            dcache["page_table"][i].copy_(c.row_dcache["page_table"][0])
            cache["length"][i].fill_(offs[i])
            dcache["length"][i].fill_(offs[i])
            tv[i].fill_(nvalid[i])
            prev[i].copy_(c.prev_feat[0])
            toks[i, : nvalid[i]].copy_(c.tokens[offs[i]: ends[i]])
            if nvalid[i] < tmax:
                toks[i, nvalid[i]:].zero_()

        def body():
            self._prefill_body(toks, cache, dcache, prev, logits, feats,
                               t_valid=tv)
        if graph:
            self._run(("fused_prefill", k, chunk), body)
        else:
            body()
        self.prefill_dispatches += 1
        self.prefill_keys[k, tmax] = self.prefill_keys.get((k, tmax), 0) + 1
        return cursors, dict(offs=offs, ends=ends, prev=prev, logits=logits,
                             feats=feats, tokens=sum(nvalid))

    def _prefill_advance(self, ctx: Dict, i: int, c: PrefillCursor) -> None:
        """Row ``i`` of a launched round: the cursor's length and carried
        feature, its completed blocks registered, its offset moved."""
        end, feats = ctx["ends"][i], ctx["feats"]
        c.row_cache["length"].fill_(end)
        c.row_dcache["length"].fill_(end)
        c.prev_feat.copy_(ctx["prev"][i: i + 1])
        self._register_blocks(c, ctx["offs"][i], end,
                              feats[i] if feats is not None else None)
        c.off = end
        if c.done:
            c.logits_last = ctx["logits"][i: i + 1].clone()

    def _slot_pools(self, st: EngineState) -> Tuple[Dict, Dict]:
        """The pools a slot prefill writes through its rows' page tables:
        the state's shared pools (paged), or (contiguous) the prefill
        carry, one row of ``NB`` blocks per slot after the null block 0
        (slot s's block j is carry block ``1 + s * NB + j``), allocated
        at first use.  Rows of several cursors never move between chunks
        and are written into the state at finalise (``_carry_rows``)."""
        if self.paged:
            return ({n: st.cache[n] for n in kvc.PAGED_POOL_KEYS},
                    {n: st.dcache[n] for n in kvc.DRAFT_POOL_KEYS})
        if self._carry is None:
            cfg, bs = self.cfg, self.spec.block_size
            n = self.batch * self._nb_seq + 1
            dt = cm.dt(cfg.dtype)
            pools = kvc.init_paged_pool(self.l_state, n, bs,
                                        self.hk_state, cfg.head_dim_, dt,
                                        self.device)
            dpools = {m: torch.zeros((n, bs, cfg.num_kv_heads,
                                      cfg.head_dim_), dtype=dt,
                                     device=self.device)
                      for m in kvc.DRAFT_POOL_KEYS}
            self._carry = (pools, dpools)
        return self._carry

    def _carry_rows(self, cur: PrefillCursor) -> Tuple[Dict, Dict]:
        """A contiguous cursor's batch-1 row caches: views of its slot's
        carry blocks, shaped as the state's rows (the first ``max_len``
        tokens)."""
        pools, dpools = self._carry
        nb, s = self._nb_seq, self.max_len
        lo = 1 + cur.slot * nb

        def tokens(a):              # [..., nb, bs, Hk, Dh] -> [..., 1, S, ...]
            a = a.narrow(-4, lo, nb)
            lead = a.shape[:-4]
            return a.reshape(lead + (1, nb * a.shape[-3]) + a.shape[-2:])[
                ..., :s, :, :]
        rows = {n: tokens(pools[n]) for n in ("k", "v")}
        rows.update({n: pools[n][:, lo: lo + nb][:, None]
                     for n in ("kmax", "kmin")})
        rows["length"] = cur.row_cache["length"]
        drows = {n: tokens(dpools[n]) for n in kvc.DRAFT_POOL_KEYS}
        drows["length"] = cur.row_dcache["length"]
        return rows, drows

    def _register_blocks(self, cur: PrefillCursor, off: int, end: int,
                         feats) -> None:
        """Register the prompt blocks the chunk ``[off, end)`` completed,
        re-stamping the whole chain with one LRU tick (a parent is never
        older than its children).  Each entry's boundary feature is a
        clone, on the card, of the cursor's row of the chunk's block
        features (``feats`` [NB, 3d]): nothing is read back.  A block a
        concurrent admission registered first under the same key is
        deduplicated (``_dedupe_block``)."""
        if self._prefix is None or not cur.n_full:
            return
        bs = self.spec.block_size
        lo, hi = off // bs, min(end // bs, cur.n_full)
        if hi <= lo:
            return
        feats = feats[: hi - lo].clone()
        tick = self._prefix.new_tick()
        for e in cur.chain_entries:
            e.tick = tick
        for j in range(lo, hi):
            e = self._prefix.insert(
                cur.chain_keys[j], j, int(cur.pt_host[j]),
                int(cur.dpt_host[j]), feats[j - lo], self._page_alloc,
                self._draft_alloc, tick=tick,
                tokens=cur.prompt[j * bs:(j + 1) * bs],
                parent=(cur.chain_keys[j - 1] if j > 0
                        else kvc.PrefixCache._ROOT))
            if e is None:
                e = self._prefix.entry(cur.chain_keys[j])
                self._dedupe_block(cur, j, e)
            cur.chain_entries.append(e)

    def _dedupe_block(self, cur: PrefillCursor, j: int, e) -> None:
        """Collapse block ``j`` of a mid-prefill cursor onto the cached
        entry of the same chain key: the slot references the entry's pages
        and releases its duplicates, and the one entry of the cursor's
        device page-table rows is written in place.  The reference holds
        hash-equal blocks bit-identical (same prefix, absolute chunk
        boundaries); in bf16 on the card that holds only when both cursors
        computed the block in chunks of the same length (ROADMAP.md queue
        3, 'Parity hazards').  An entry of another data shard (its page
        None in this shard's view, ``core.data_parallel``) is left alone:
        each shard keeps its own copy."""
        if e.page is None or int(cur.pt_host[j]) == e.page:
            return                      # another shard's, or shared already
        self._page_alloc.rebind_block(cur.slot, j, e.page)
        self._draft_alloc.rebind_block(cur.slot, j, e.draft_page)
        cur.pt_host[j] = e.page
        cur.dpt_host[j] = e.draft_page
        cur.row_cache["page_table"][0, j].fill_(e.page)
        cur.row_dcache["page_table"][0, j].fill_(e.draft_page)
        self._prefix_dedups += 1

    def prefill_finalize_slot(self, st: EngineState, cur: PrefillCursor
                              ) -> Tuple[EngineState, int]:
        """Commit an exhausted cursor: build the slot's automaton state
        from the last chunk's logits (or, after a tail-entry hit, from the
        stored first token) and write it into batch row ``cur.slot``.  A
        prefilled prompt that ends in a partial block first registers
        that block as a tail entry.  Returns (state, first token)."""
        assert cur.done, "prefill cursor still has chunks to run"
        self._own(st)
        if cur.boot_token is None:
            self._register_tail(st, cur)
        rows, drows = ((cur.row_cache, cur.row_dcache) if self.paged
                       else self._carry_rows(cur))
        sub = self._boot_state(rows, drows, cur.logits_last, cur.prev_feat,
                               len(cur.prompt), bonus0=cur.boot_token,
                               temperature=cur.temperature, seed=cur.seed)
        write_state_slot(st, sub, cur.slot)
        self._pkv_active_rows[cur.slot] = False
        self._slot_temp[cur.slot] = cur.temperature
        self._slot_chain[cur.slot] = cur.draft == "chain"
        self._host_pending_len[cur.slot] = 1
        self._host_seq_len[cur.slot] = len(cur.prompt) + 1
        self._host_ext_len[cur.slot] = 1
        first = (cur.boot_token if cur.boot_token is not None
                 else int(sub.pending[0, 0]))
        return st, first

    def prefill_into_slot(self, st: EngineState, slot: int,
                          prompt: np.ndarray, chunk: int = 256,
                          extra: Optional[Dict] = None,
                          max_new_tokens: Optional[int] = None,
                          temperature: Optional[float] = None,
                          seed: int = 0, draft: str = "tree"
                          ) -> Tuple[EngineState, int]:
        """Admit a request in one blocking call: begin, every chunk, then
        finalise.  Returns (state, first token)."""
        st, cur = self.prefill_begin_slot(
            st, slot, prompt, chunk=chunk, extra=extra,
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, draft=draft)
        while not cur.done:
            st, _ = self.prefill_step_into_slot(st, cur)
        return self.prefill_finalize_slot(st, cur)

    # ------------------------------------------------------------------
    # copy-on-write: fork and the pre-step exclusivity pass
    def _read_slot(self, st: EngineState, slot: int) -> EngineState:
        """Batch row `slot` as a batch-1 sub-state of views (the shared
        pool keys left out, as ``write_state_slot`` expects)."""
        def row(a, axis):
            return a.narrow(axis, slot, 1)
        cache = {n: row(st.cache[n], kvc.CACHE_BATCH_AXIS.get(n, 0))
                 for n in ("page_table", "length") + kvc.CROSS_KEYS
                 if n in st.cache}
        dcache = {n: row(st.dcache[n], 0) for n in ("page_table", "length")}
        kw = dict(cache=cache, dcache=dcache)
        for f in _PKV_FIELDS:
            kw[f] = row(getattr(st, f), 1)
        for f in _ROW_FIELDS:
            kw[f] = row(getattr(st, f), 0)
        return EngineState(**kw)

    def fork_slot(self, st: EngineState, src: int, dst: int) -> EngineState:
        """Copy-on-write fork: row `dst` becomes a live replica of row
        `src`, sharing all of its physical pages (references added, no
        pool bytes copied) and its pins; the row's state and its host
        mirrors are copied in place.  ``prepare_cow`` gives a stepping row
        a private copy of any still-shared block in its write windows
        before its first commit, so neither branch perturbs the other.
        The replica takes the source's stream, temperature and draft
        shape: until one is re-admitted, both emit the same tokens."""
        self._slots_only()
        self._own(st)
        assert src != dst
        if not self.paged:
            raise ValueError("fork_slot requires the refcounted paged cache")
        for al in (self._page_alloc, self._draft_alloc):
            al.free_slot(dst)                   # stale pages, if any
            al.fork(src, dst)
        if self._tier is not None:
            self._tier.drop_slot(dst)
        for mirror in (self._pkv_active_rows, self._host_pending_len,
                       self._host_seq_len, self._host_ext_len,
                       self._slot_temp, self._slot_chain):
            mirror[dst] = mirror[src]
        self._forked_slots.update((src, dst))
        return write_state_slot(st, self._read_slot(st, src), dst)

    def prepare_cow(self, st: EngineState, rows: np.ndarray) -> EngineState:
        """Pre-step copy-on-write: give each row about to step exclusive
        pages over the blocks its writes may touch (trunk: the commit
        window ``[length, length + commit_write_extent)``; draft: the
        extend window ``[length, length + emax)``), copying every shared
        block to a private page and repointing the row's table.  The
        window starts come from the host mirrors (trunk length = sequence
        length - pending, draft length = sequence length - extend length),
        never from the card.  The copies run as one index copy per pool
        key and one page-table write per cache, on the engine's stream.
        A no-op with no launch unless a stepping row was forked: prompt
        blocks shared by admission sit below every window, and a tail
        attach copies its block.  All copies are planned (and reclaimed
        for) before the allocators change, so pool exhaustion raises with
        allocators and tables consistent."""
        if not self.paged or not self._forked_slots.intersection(
                int(i) for i in np.nonzero(rows)[0]):
            return st
        bs = self.spec.block_size
        plans = (
            ("trunk", st.cache, self._page_alloc,
             self._host_seq_len - self._host_pending_len,
             vf.commit_write_extent(self.pmax, self.tree.depth)),
            ("draft", st.dcache, self._draft_alloc,
             self._host_seq_len - self._host_ext_len, self.emax),
        )
        planned = []
        for _, _, al, lengths, extent in plans:
            shared = []                         # (slot, block)
            for i in np.nonzero(rows)[0]:
                i = int(i)
                if i not in self._forked_slots or not al.count(i) \
                        or not al.slot_holds_shared(i):
                    continue
                lo = int(lengths[i]) // bs
                hi = min(-(-(int(lengths[i]) + extent) // bs), al.count(i))
                shared += [(i, j) for j in range(lo, hi)
                           if al.refcount(al.page_at(i, j)) > 1]
            if len(shared) > al.free:
                self.reclaim_pages(len(shared) - al.free)
            if len(shared) > al.free:
                raise RuntimeError(
                    f"page pool exhausted during copy-on-write: need "
                    f"{len(shared)} private pages, {al.free} free of "
                    f"{al.capacity}")
            planned.append(shared)
        for (name, cache, al, _, _), shared in zip(plans, planned):
            copies = [(i, j) + al.cow_write(i, j) for i, j in shared]
            if not copies:
                continue
            idx = self._to_device(np.asarray(copies, np.int64).T)
            sl, bl, olds, news = idx
            for n in (kvc.PAGED_POOL_KEYS if name == "trunk"
                      else kvc.DRAFT_POOL_KEYS):
                a = cache[n]
                if name == "trunk":
                    a[:, news] = a[:, olds]
                else:
                    a[news] = a[olds]
            cache["page_table"][sl, bl] = news.to(torch.int32)
            self.cow_copies[name] += sum(c[2] != c[3] for c in copies)
        return st

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the engine's device without a sync."""
        return kvc.to_device(a, self.device)

    # ------------------------------------------------------------------
    # the compiled step: one body per variant, captured once on the card
    def _run(self, key, body) -> None:
        """Run a step or prefill-chunk body: eagerly, or (``cuda_graphs``)
        by replaying its graph, captured the first time ``key`` occurs
        (the reference jits ``_fused_fn`` per mode mix the same way)."""
        if not self.cuda_graphs:
            body()
            return
        g = self._graphs.get(key)
        if g is None:
            t0 = time.perf_counter()
            g = self._capture(body)
            self._graphs[key] = g
            self.capture_s += time.perf_counter() - t0
        g.replay()

    def _capture(self, body) -> "CapturedGraph":
        """Capture ``body`` as a CUDA graph (``capture_graph``).  The K/V
        pools are left out of the state it restores after the warm-up: a
        body writes them only at its rows' next positions (``[length,
        length + W)`` of the trunk or draft cache, W fixed by the body's
        shapes), every one of which the real step writes again before
        anything reads it, and reads past ``length`` are masked."""
        if self._graph_pool is None:
            # one pool for the engine's graphs: each body leaves its
            # results in the static buffers, so no tensor of the pool is
            # read after its own replay ends, and replays never overlap
            self._graph_pool = torch.cuda.graph_pool_handle()
        return capture_graph(body, self.device,
                             self._static_tensors(pools=False),
                             self._graph_pool)

    def _fused_body(self, has_full: bool, has_partial: bool,
                    has_refresh: bool, has_sampled: bool = False,
                    has_chain: bool = False) -> None:
        nxt, out = self._step_fused(self.state, self._modes,
                                    active=self._rows,
                                    is_chain=self._is_chain,
                                    has_full=has_full,
                                    has_partial=has_partial,
                                    has_refresh=has_refresh,
                                    has_sampled=has_sampled,
                                    has_chain=has_chain)
        self._store(nxt, out)

    def _state_body(self) -> None:
        nxt, out = self._step_state(self.state)
        self._store(nxt, out)

    def _store(self, nxt: EngineState, out) -> None:
        """End of a step body: the next state into the static buffers
        (fields the step updated in place, such as the pool and its
        summaries, are those buffers and are skipped), then what the host
        reads into ``_io``."""
        st = self.state
        for f in fields(EngineState):
            copy_into(getattr(st, f.name), getattr(nxt, f.name))
        newtoks, counts, acc = out
        parts = [newtoks, counts, acc, st.pending_len, st.seq_len]
        if self.is_attn:
            parts.append(st.pkv_blocks)
        off = 0
        for p in parts:
            self._io[off: off + p.numel()].copy_(p.reshape(-1))
            off += p.numel()

    def _read_io(self, blocks: bool):
        """The step's one copy to the host: (tokens [B, D+1], counts,
        accept_len, and with ``blocks`` the pkv_blocks); the pending and
        sequence lengths stay for the mode automaton and the billing."""
        b, w = self.batch, self.tree.depth + 1
        n = self._io.numel() if blocks else self._io_head
        h = self._io[:n].to("cpu", copy=True).numpy()
        counts, acc, plen, slen = h[b * w: self._io_head].reshape(4, b)
        self._host_pending_len, self._host_seq_len = plen, slen
        pbi = (h[self._io_head:].reshape(self.state.pkv_blocks.shape)
               if blocks else None)
        return h[: b * w].reshape(b, w), counts, acc, pbi

    def _own(self, st: EngineState) -> None:
        if st is not self.state:
            raise ValueError("an engine steps its own state: the one its "
                             "prefill returned")

    # ------------------------------------------------------------------
    def _draws(self, st: EngineState, rows):
        """One step of every row's stream: (the next keys, advanced only
        where a row in ``rows`` samples; the draft's uniforms [B, T]; the
        acceptance uniforms [B, T+1], the bonus's last)."""
        t = self.tree.size
        nxt, u = smp.stream_draws(st.keys, 2 * t + 1)
        adv = rows & (st.temps > 0.0)
        return torch.where(adv[:, None], nxt, st.keys), u[:, :t], u[:, t:]

    def _accept(self, st, tree_tokens, aux, out, vin, u_acc, node_valid):
        """Greedy acceptance, and with the acceptance uniforms ``u_acc``
        (a step with sampled rows) the lossless sampled acceptance of the
        rows at temperature > 0; greedy rows keep the greedy result, as
        in an all-greedy step.  Returns (path, accept_len, bonus)."""
        tree = self.tree
        path, acc, bonus, _ = tr.greedy_tree_accept(
            tree, tree_tokens, out.logits, vin["root_slot"],
            vin["node_slots"], node_valid=node_valid)
        if u_acc is None:
            return path, acc, bonus
        sampled = st.temps > 0.0
        # greedy lanes run the sampled math at temperature 1.0, which
        # keeps their softmax finite; the row select drops them
        path_s, acc_s, bonus_s = smp.tree_speculative_sample(
            tree, tree_tokens, aux, out.logits, vin["root_slot"],
            vin["node_slots"], u_acc[:, :tree.size], u_acc[:, tree.size],
            temperature=torch.where(sampled, st.temps,
                                    torch.ones_like(st.temps)),
            node_valid=node_valid)
        return (torch.where(sampled[:, None], path_s, path),
                torch.where(sampled, acc_s, acc),
                torch.where(sampled, bonus_s, bonus))

    def _post_accept(self, st, vin, out, tree_tokens, path, acc, bonus):
        """Ext-queue + seq_len bookkeeping shared by every mode."""
        b = bonus.shape[0]
        d = self.tree.depth
        path_valid = path >= 0
        pc = torch.clamp(path, min=0)
        path_toks = torch.where(path_valid,
                                torch.gather(tree_tokens.long(), 1, pc),
                                torch.zeros_like(pc))
        newtoks = torch.zeros((b, d + 1), dtype=torch.long, device=path.device)
        newtoks[:, :d] = path_toks
        at_acc = torch.arange(d + 1, device=path.device)[None] == acc[:, None]
        newtoks = torch.where(at_acc, bonus[:, None], newtoks)
        fused = out.features.fused_input()                # [B, S, 3d]
        path_slots = torch.where(path_valid,
                                 torch.gather(vin["node_slots"], 1, pc),
                                 torch.zeros_like(pc))
        fslots = torch.cat([vin["root_slot"][:, None], path_slots], dim=1)
        ext_feats = torch.gather(
            fused, 1, fslots[..., None].expand(-1, -1, fused.shape[-1]))
        return newtoks, ext_feats, acc + 1, st.seq_len + acc + 1

    def _step_fused(self, st: EngineState, modes, *, active=None,
                    is_chain=None, has_full: bool, has_partial: bool,
                    has_refresh: bool, has_sampled: bool = False,
                    has_chain: bool = False) -> Tuple[EngineState, Tuple]:
        """One fused multi-mode step over per-row ``modes`` [B] (the
        reference's ``_step_fused``) of the rows where ``active`` [B]
        bool is set (default: every row).  ``has_sampled``: some rows
        sample (``st.temps`` > 0), so the step draws from the streams,
        drafts those rows' children i.i.d. and accepts them by
        rejection; ``has_chain``: the rows set in ``is_chain`` [B] bool
        accept within the tree's rank-0 chain.  Without either flag the
        step is the greedy body, op for op.  Returns the next state (the
        pool, its summaries and the draft pool written in place, the
        other fields new tensors) and (tokens, counts, accept_len).

        Every row computes; a row outside ``active`` is masked as in the
        reference (its draft extension writes nothing, its verify input
        has no valid pending token or query and an all-False self mask,
        so an MoE routes the reference's hidden states for it), commits
        nothing (its cache and buffer writes get count 0, so its lengths
        stay) and keeps every row field, so the next state equals the
        reference's step followed by its row merge.  Its pool writes land
        at or past its length (on the null page for a neutral row), where
        its next real step writes before anything reads."""
        cfg, spec, tree = self.cfg, self.spec, self.tree
        b, dev = self.batch, self.device
        act = (active if active is not None
               else torch.ones((b,), dtype=torch.bool, device=dev))
        keys, u_draft, u_acc = st.keys, None, None
        if has_sampled:
            keys, u_draft, u_acc = self._draws(st, act)
        dcache, tree_tokens, aux = dr.draft_phase(
            cfg, self.dcfg, self.dparams, self.params, tree, st.dcache,
            st.ext_tokens, st.ext_feats, st.ext_len, active=act, u=u_draft,
            temps=st.temps if has_sampled else None, tp=self.tp)
        node_valid = None
        if has_chain:
            node_valid = (~is_chain[:, None]
                          | tr.tree_tensors(tree, dev).chain[None, :])
        is_partial = modes == MODE_PARTIAL
        is_refresh = modes == MODE_REFRESH
        last_tok = torch.gather(
            st.pending, 1, torch.clamp(st.pending_len - 1, min=0)[:, None])[:, 0]
        ones = torch.ones((b,), dtype=torch.long, device=dev)
        if has_refresh:
            # refresh rows verify their whole pending run; everyone else
            # collapses to one pend slot holding the newest bonus
            solo = torch.zeros_like(st.pending)
            solo[:, 0] = last_tok
            pend_in = torch.where(is_refresh[:, None], st.pending, solo)
            plen_in = torch.where(is_refresh, st.pending_len, ones)
            p_eff = torch.where(is_refresh, self.pmax, 1)
        else:
            pend_in = last_tok[:, None]
            plen_in = ones
            p_eff = ones
        vin = vf.build_verify_inputs_fused(tree, pend_in, plen_in, p_eff,
                                           tree_tokens, st.seq_len,
                                           active=act)
        decode_kind = ("fused" if has_full and has_partial
                       else ("full" if has_full else "partial"))
        pkv = (st.pkv_k, st.pkv_v, st.pkv_pos)
        if self.gathered:
            pkv += (st.pkv_body_k, st.pkv_body_v)
        out = api.decode(
            cfg, self.params, vin["tokens"], vin["positions"], st.cache,
            mode=decode_kind, self_mask=vin["self_mask"], pkv=pkv, spec=spec,
            emit_queries=has_refresh,
            partial_rows=is_partial if decode_kind == "fused" else None,
            pkv_blocks=(st.pkv_blocks.movedim(0, 1) if has_partial
                        else None), tp=self.tp)
        path, acc, bonus = self._accept(st, tree_tokens, aux, out, vin,
                                        u_acc, node_valid)
        newtoks, ext_feats, ext_len, seq_len = self._post_accept(
            st, vin, out, tree_tokens, path, acc, bonus)
        slots, slot_valid = vf.commit_slots(tree, vin["pend_valid"], path,
                                            p_eff)
        ck, cv = vf.gather_new_kv(out.new_kv, slots, slot_valid)
        count = plen_in + acc

        cache = st.cache
        pkv_k, pkv_v, pkv_pos = st.pkv_k, st.pkv_v, st.pkv_pos
        pkv_blocks, buf_len = st.pkv_blocks, st.buf_len
        body_k, body_v = st.pkv_body_k, st.pkv_body_v
        if has_partial:
            # partial rows append their accepted run (at most 1 + depth
            # valid entries after compaction) to the tail buffer, which
            # lies apart from the body in both partial forms (the
            # reference's gathered array puts it past the body:
            # body_len = partial_budget_tokens there, 0 here)
            wb = 1 + tree.depth
            cpos = torch.gather(vin["positions"], 1, slots[:, :wb])
            part_rows = is_partial & act
            count_buf = torch.where(part_rows, count, torch.zeros_like(count))
            nk, nv, npos, nbl = vf.append_buffer(
                pkv_k, pkv_v, pkv_pos, 0, buf_len, ck[:, :, :wb],
                cv[:, :, :wb], cpos, count_buf)
            # every other row keeps its buffer bits
            selp = part_rows[None, :, None, None]
            pkv_k = torch.where(selp[..., None], nk, pkv_k)
            pkv_v = torch.where(selp[..., None], nv, pkv_v)
            pkv_pos = torch.where(selp, npos, pkv_pos)
            buf_len = torch.where(part_rows, nbl, buf_len)
        if has_full:
            # full/refresh rows commit exact KV; partial and inactive
            # rows pass count 0
            commit = (act & ~is_partial) if has_partial else act
            count_full = torch.where(commit, count, torch.zeros_like(count))
            cache = vf.append_full_cache(cache, ck, cv, count_full, spec)
        if has_refresh:
            # masked epilogue: Quest retrieval over the just-committed
            # cache with this step's queries, weighted by the pending
            # run and the accepted path
            t_sz = tree.size
            hit = ((torch.arange(t_sz, device=dev)[None, None, :]
                    == torch.clamp(path, min=0)[:, :, None])
                   & (path >= 0)[:, :, None])
            node_w = hit.float().sum(dim=1)                       # [B, T]
            s_all = vin["tokens"].shape[1]
            qw = torch.zeros((b, s_all), dtype=torch.float32, device=dev)
            qw[:, : pend_in.shape[1]] = vin["pend_valid"].float()
            qw.scatter_add_(1, vin["node_slots"], node_w)
            nbi = vf.refresh_partial_blocks(cfg, spec, out.queries, qw, cache)
            ref_rows = is_refresh & act
            if self.gathered:
                # the gathered refresh also copies the selected blocks'
                # bytes; other rows keep their body (written in place)
                gk, gv = dn.gather_partial_body(
                    spec, nbi, cache["k"], cache["v"],
                    cache.get("page_table"))
                selb = ref_rows[None, :, None, None, None]
                torch.where(selb, gk, body_k, out=body_k)
                torch.where(selb, gv, body_v, out=body_v)
            nbi = nbi.movedim(0, 1)                   # [B, L, Hk, NS]
            pkv_blocks = torch.where(ref_rows[:, None, None, None], nbi,
                                     pkv_blocks)
            pkv_pos = torch.where(ref_rows[None, :, None, None],
                                  torch.full_like(pkv_pos, -1), pkv_pos)
            buf_len = torch.where(ref_rows, torch.zeros_like(buf_len),
                                  buf_len)

        pending_f = torch.zeros_like(st.pending)
        pending_f[:, 0] = bonus
        if has_partial:
            # the reference's dynamic_update_slice clamps the append
            # offset into [0, Pmax - (D+1)]; update_slice_rows does too
            pending_p = cm.update_slice_rows(st.pending.clone(), newtoks,
                                             st.pending_len, axis=1)
            plen_p = st.pending_len + acc + 1
            if has_full:
                pending = torch.where(is_partial[:, None], pending_p,
                                      pending_f)
                pending_len = torch.where(is_partial, plen_p, ones)
            else:
                pending, pending_len = pending_p, plen_p
        else:
            pending, pending_len = pending_f, ones
        ext_tokens = newtoks
        if active is not None:
            # inactive rows keep their automaton (their draft length stays:
            # their extension was masked)
            def keep(new, old):
                return kvc.select_rows(active, new, old, 0)
            pending, pending_len = (keep(pending, st.pending),
                                    keep(pending_len, st.pending_len))
            seq_len = keep(seq_len, st.seq_len)
            ext_tokens = keep(newtoks, st.ext_tokens)
            ext_feats = keep(ext_feats, st.ext_feats)
            ext_len = keep(ext_len, st.ext_len)
        st2 = EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=buf_len, pending=pending,
            pending_len=pending_len, seq_len=seq_len, ext_tokens=ext_tokens,
            ext_feats=ext_feats, ext_len=ext_len, pkv_blocks=pkv_blocks,
            pkv_body_k=body_k, pkv_body_v=body_v, keys=keys, temps=st.temps)
        return st2, (newtoks, acc + 1, acc)

    def _step_state(self, st: EngineState, active=None
                    ) -> Tuple[EngineState, Tuple]:
        """One chain step of a state arch: draft a chain, verify it with a
        read-only pass over [pending token | chain], accept (greedily: the
        longest matching prefix; at the engine's temperature > 0 by
        rejection, with a draft sampled from the rows' streams), then
        advance the recurrent state over the pending token and the
        accepted tokens (``valid`` = 1 + accepted; the padded tail leaves
        the state as it was).  ``active`` [B] bool masks the draft, the
        verify input and the advance as the reference's does; a state
        arch steps lock-step, so the body passes None (every row)."""
        cfg, tree = self.cfg, self.tree
        b, dev = self.batch, self.device
        keys, u_draft, u_acc = st.keys, None, None
        sampled = self.temperature > 0.0
        if sampled:
            keys, u_draft, u_acc = self._draws(
                st, active if active is not None
                else torch.ones((b,), dtype=torch.bool, device=dev))
        dcache, tree_tokens, aux = dr.draft_phase(
            cfg, self.dcfg, self.dparams, self.params, tree, st.dcache,
            st.ext_tokens, st.ext_feats, st.ext_len, active=active,
            u=u_draft, temps=st.temps if sampled else None, tp=self.tp)
        pend_in = st.pending[:, :1]
        ones = torch.ones((b,), dtype=torch.long, device=dev)
        vin = vf.build_verify_inputs_fused(tree, pend_in, ones, ones,
                                           tree_tokens, st.seq_len,
                                           active=active)
        out = api.decode(cfg, self.params, vin["tokens"], vin["positions"],
                         st.cache, self_mask=vin["self_mask"],
                         spec=self.spec, tp=self.tp)
        path, acc, bonus = self._accept(st, tree_tokens, aux, out, vin, u_acc,
                                        None)
        newtoks, ext_feats, ext_len, seq_len = self._post_accept(
            st, vin, out, tree_tokens, path, acc, bonus)
        path_toks = torch.where(
            path >= 0, torch.gather(tree_tokens.long(), 1,
                                    torch.clamp(path, min=0)),
            torch.zeros_like(path))
        adv_toks = torch.cat([pend_in, path_toks], dim=1)
        adv_valid = (torch.arange(1 + tree.depth, device=dev)[None]
                     < (1 + acc)[:, None])
        if active is not None:
            adv_valid = adv_valid & active[:, None]
        cache = api.advance(cfg, self.params, adv_toks, st.cache, adv_valid,
                            tp=self.tp)
        pending = torch.zeros_like(st.pending)
        pending[:, 0] = bonus
        st2 = EngineState(
            cache=cache, dcache=dcache, pkv_k=st.pkv_k, pkv_v=st.pkv_v,
            pkv_pos=st.pkv_pos, buf_len=st.buf_len, pending=pending,
            pending_len=ones, seq_len=seq_len, ext_tokens=newtoks,
            ext_feats=ext_feats, ext_len=ext_len, pkv_blocks=st.pkv_blocks,
            pkv_body_k=st.pkv_body_k, pkv_body_v=st.pkv_body_v, keys=keys,
            temps=st.temps)
        return st2, (newtoks, acc + 1, acc)

    # ------------------------------------------------------------------
    def mode_for(self, pending_len: int, seq_len: int,
                 pkv_active: bool) -> str:
        """One slot's mode automaton (Full -> Refresh -> Partial* -> ...);
        a state arch always steps in mode ``"state"``."""
        if not self.is_attn:
            return "state"
        if not self.partial_enabled:
            return "full"
        if seq_len <= self.spec.partial_budget_tokens:
            return "full"
        if not pkv_active:
            return "refresh"
        if (pending_len - 1 + self.tree.max_path
                + self.spec.refresh_margin // 4 > self.spec.buffer_size):
            return "refresh"
        return "partial"

    def select_mode(self, pending_len_max: int, seq_len_min: int) -> str:
        """Lock-step automaton over the whole batch."""
        return self.mode_for(pending_len_max, seq_len_min, self._pkv_active)

    def next_mode(self) -> str:
        """The lock-step automaton's next mode, from the host's copy of
        the lengths the last step (or the prefill) left."""
        return self.select_mode(int(self._host_pending_len.max()),
                                int(self._host_seq_len.min()))

    def modes_for_rows(self, st: EngineState, rows: np.ndarray) -> np.ndarray:
        """Per-slot automaton as a mode vector [B] int8 (inactive rows
        read MODE_FULL; ``step_fused`` normalises them), from the host
        mirrors of the lengths: no read of the device."""
        self._own(st)
        out = np.full((self.batch,), MODE_FULL, np.int8)
        for i in np.nonzero(rows)[0]:
            out[i] = MODE_IDS[self.mode_for(
                int(self._host_pending_len[i]), int(self._host_seq_len[i]),
                bool(self._pkv_active_rows[i]))]
        return out

    def select_mode_rows(self, st: EngineState,
                         rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The per-slot automaton grouped by mode (the grouped scheduling
        path): {mode: [B] bool mask}."""
        modes = self.modes_for_rows(st, rows)
        out: Dict[str, np.ndarray] = {}
        for i in np.nonzero(rows)[0]:
            out.setdefault(MODE_NAMES[int(modes[i])],
                           np.zeros(self.batch, bool))[i] = True
        return out

    def step_fused(self, st: EngineState, rows: np.ndarray,
                   modes: np.ndarray) -> Tuple[EngineState, StepOutput]:
        """One fused multi-mode step of the engine's state ``st``: every
        row where `rows` is True steps in the mode `modes` gives it, in
        one dispatch (one graph replay on the card) for any mix; the
        other rows keep their state (see ``_step_fused``).  The row mask,
        the modes and the chain rows go to the card in one copy; the
        graph is keyed by the mode mix of the stepped rows and by whether
        any of them samples or drafts a chain (the host mirrors
        ``_slot_temp`` / ``_slot_chain``), so an all-greedy tree step
        replays ``(has_full, has_partial, has_refresh, False, False)``."""
        return self._step_finish(*self._step_launch(st, rows, modes))

    def _step_launch(self, st: EngineState, rows: np.ndarray,
                     modes: np.ndarray) -> Tuple:
        """The first half of ``step_fused``: everything up to the body's
        launch, nothing read back (a data-parallel tick launches every
        shard's step before it reads any)."""
        if not self.is_attn:
            raise ValueError("state archs step through step(st, 'state')")
        self._own(st)
        rows = np.asarray(rows, bool)
        modes = np.asarray(modes, np.int8)
        active_modes = modes[rows]
        if not active_modes.size:
            raise ValueError("step_fused needs at least one live row")
        has_refresh = bool(np.any(active_modes == MODE_REFRESH))
        has_full = has_refresh or bool(np.any(active_modes == MODE_FULL))
        has_partial = bool(np.any(active_modes == MODE_PARTIAL))
        has_sampled = bool(np.any(self._slot_temp[rows] > 0.0))
        # chain masking is the identity when the tree is a chain
        has_chain = bool(self._tree_branching
                         and np.any(self._slot_chain[rows]))
        # inactive rows compute in the first active mode (their results
        # are dropped), so every row runs a branch the variant has
        modes = np.where(rows, modes, active_modes[0]).astype(np.int8)
        st = self.prepare_cow(st, rows)
        if self._tier is not None:
            # seat hosted pages before any full-cache read (prefetched
            # ones land free; an early refresh pays a copy)
            self._tier_promote_rows(st, rows, modes)
        self._tick_in.copy_(torch.from_numpy(np.stack(
            [modes, rows.astype(np.int8), self._slot_chain.astype(np.int8)])))
        key = (has_full, has_partial, has_refresh, has_sampled, has_chain)
        self._run(key, lambda: self._fused_body(*key))
        self.dispatches += 1
        self.dispatch_keys[key] = self.dispatch_keys.get(key, 0) + 1
        return st, rows, modes, active_modes, has_refresh

    def _step_finish(self, st: EngineState, rows: np.ndarray,
                     modes: np.ndarray, active_modes: np.ndarray,
                     has_refresh: bool) -> Tuple[EngineState, StepOutput]:
        """The second half of ``step_fused``: the one read-back, then the
        host's bookkeeping (mirrors, pins, traffic, tiers)."""
        pin = self.zero_copy and has_refresh
        toks, counts, acc, pbi_host = self._read_io(blocks=pin)
        self._host_ext_len = np.where(rows, counts, self._host_ext_len)
        refreshed = rows & (modes == MODE_REFRESH)
        self._pkv_active_rows |= refreshed
        if pin:
            # pin the pages the refresh just routed; pin_slot_pages takes
            # the new references before dropping the previous refresh's,
            # so a page kept across refreshes never transiently frees
            al = self._page_alloc
            for i in np.nonzero(refreshed)[0]:
                i = int(i)
                blocks = np.unique(pbi_host[i][pbi_host[i] >= 0])
                nb = al.count(i)
                pages = [al.page_at(i, int(j)) for j in blocks if j < nb]
                if pages:
                    al.pin_slot_pages(i, pages)
        self._record_traffic_rows(modes, rows)
        if self._tier is not None:
            # after the pins, so demotion skips the pages a routed view
            # reads: refreshed rows' committed blocks go cold, and partial
            # rows near their refresh prefetch
            self._tier_epilogue(rows, modes)
        names = sorted({MODE_NAMES[int(m)] for m in active_modes})
        return st, StepOutput(tokens=toks, counts=np.where(rows, counts, 0),
                              accept_len=np.where(rows, acc, 0),
                              mode=names[0] if len(names) == 1 else "fused",
                              modes=modes)

    def step(self, st: EngineState, mode: str) -> Tuple[EngineState,
                                                        StepOutput]:
        """One lock-step round over the whole batch in `mode` ("state"
        for a state arch), on the engine's state ``st``."""
        if mode == "state":
            return self._state_finish(self._state_launch(st))
        if mode not in MODE_IDS:
            raise ValueError(mode)
        st, out = self.step_fused(
            st, np.ones((self.batch,), bool),
            np.full((self.batch,), MODE_IDS[mode], np.int8))
        if mode == "refresh":
            self._pkv_active = True
        return st, out

    def _state_launch(self, st: EngineState) -> EngineState:
        """The first half of a state arch's lock-step round: the chain
        step's launch (one graph replay on the card), nothing read back
        (a data-parallel round launches every shard's step before it
        reads any)."""
        if self.is_attn:
            raise ValueError("state")
        self._own(st)
        st = self.prepare_cow(st, np.ones((self.batch,), bool))
        self._run("state", self._state_body)
        self.dispatches += 1
        return st

    def _state_finish(self, st: EngineState) -> Tuple[EngineState,
                                                       StepOutput]:
        """The second half: the round's one read-back."""
        toks, counts, acc, _ = self._read_io(blocks=False)
        return st, StepOutput(tokens=toks, counts=counts, accept_len=acc,
                              mode="state")

    def step_rows(self, st: EngineState, mode: str,
                  rows: np.ndarray) -> Tuple[EngineState, StepOutput]:
        """Step only the rows where `rows` is True, all in `mode` (the
        grouped per-mode path, one dispatch per distinct mode)."""
        if mode not in MODE_IDS:
            raise ValueError(mode)
        return self.step_fused(
            st, rows, np.full((self.batch,), MODE_IDS[mode], np.int8))

    def _record_traffic_rows(self, modes: np.ndarray, rows: np.ndarray):
        """One traffic record per mode stepped, billed for its own rows."""
        for mid in (MODE_FULL, MODE_REFRESH, MODE_PARTIAL):
            sub = rows & (modes == mid)
            if sub.any():
                self._record_traffic(MODE_NAMES[mid], sub)

    def _record_traffic(self, mode: str, rows: np.ndarray):
        """Bytes of cache touched by the rows that stepped in `mode`:
        full/refresh bill the per-row sum of context, partial the budget
        plus buffer, a zero-copy refresh its routed rebuild, a gathered
        refresh its copy of the budget."""
        cfg, spec = self.cfg, self.spec
        l_attn = self.l_attn
        itemsize = 2 if cfg.dtype == "bfloat16" else 4
        nrows = int(np.sum(rows))
        if nrows == 0:
            return
        seq_sum = int(np.sum(self._host_seq_len[rows]))
        hk, dh = cfg.num_kv_heads, cfg.head_dim_
        if mode == "partial":
            nbytes = partial_step_bytes(
                l_attn, nrows, spec.partial_budget_tokens + spec.buffer_size,
                hk, dh, itemsize)
        else:
            nbytes = full_step_bytes(l_attn, 1, seq_sum, hk, dh, itemsize)
            if mode == "refresh" and self.zero_copy:
                nbytes += routed_refresh_bytes(
                    l_attn, nrows, self._nb_seq, self._ns_blocks,
                    spec.buffer_size, hk, dh, itemsize)
            elif mode == "refresh":
                nbytes += partial_step_bytes(
                    l_attn, nrows, spec.partial_budget_tokens, hk, dh,
                    itemsize)
        self.traffic.record(mode, nbytes)

    def _first_tokens(self, st: EngineState) -> np.ndarray:
        """Each row's first token after a lock-step prefill (read back)."""
        return st.pending[:, 0].cpu().numpy()

    # ------------------------------------------------------------------
    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: int = -1, prefill_chunk: int = 256,
                 extra: Optional[Dict] = None):
        """SpecPV generation at the engine's temperature (greedy at 0; row
        i's stream from seed 0's row i), conditioned on ``extra`` (VLM and
        audio targets, see ``prefill``).  Returns (tokens [B, max_new],
        stats dict with steps, mean_accept, modes, tokens_per_step and
        prefill_s: host seconds until the first token reached the host,
        which waits for the prefill on the device).  The state after the
        last step stays in ``final_state`` until the next prefill."""
        t0 = time.perf_counter()
        st = self.prefill(prompt, chunk=prefill_chunk, extra=extra)
        b = self.batch
        first = self._first_tokens(st)
        prefill_s = time.perf_counter() - t0
        out: List[List[int]] = [[int(first[i])] for i in range(b)]
        accepts: List[int] = []
        modes: List[str] = []
        steps = 0
        while min(len(o) for o in out) < max_new_tokens:
            mode = self.next_mode()
            st, so = self.step(st, mode)
            steps += 1
            modes.append(mode)
            accepts.extend(so.accept_len.tolist())
            for i in range(b):
                cnt = int(so.counts[i])
                out[i].extend(int(x) for x in so.tokens[i, :cnt])
            if eos_id >= 0 and all(eos_id in o for o in out):
                break
        self.final_state = st
        toks = np.full((b, max_new_tokens), -1, np.int64)
        for i in range(b):
            n = min(len(out[i]), max_new_tokens)
            toks[i, :n] = out[i][:n]
        stats = dict(steps=steps,
                     mean_accept=(float(np.mean(accepts)) if accepts else 0.0),
                     modes={m: modes.count(m) for m in set(modes)},
                     tokens_per_step=float(np.mean(
                         [len(o) for o in out]) / max(steps, 1)),
                     prefill_s=prefill_s)
        return toks, stats
