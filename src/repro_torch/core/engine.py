"""SpecPV generation engine (counterpart of ``repro/core/engine.py``,
paper Algorithm 1), greedy:

  prefill (chunked) -> [ draft -> verify(mode) -> accept -> commit ]*

over the paged trunk cache with zero-copy partial KV: a refresh stores
the retrieval-selected logical block ids per layer and KV head
(``EngineState.pkv_blocks``) and pins their physical pages; partial
steps read those pages in place plus a small dense tail buffer.

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
``prefill_step_into_slot`` / ``prefill_finalize_slot`` prefill one
slot chunk by chunk over the shared pools through the slot's own page
table (a 256-token chunk replays one batch-1 graph), so the serving
scheduler can interleave chunks with decode steps; ``prefill_into_slot``
runs them back to back.

State architectures (RWKV-6, ``paged=False``) have no KV cache, so
partial verification does not apply: each step (mode ``"state"``,
``_step_state``) drafts a chain, verifies it with a read-only pass,
accepts greedily and advances the recurrent state over the pending
token and the accepted prefix.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DraftConfig, ModelConfig, SpecPVConfig
from repro_torch.core import draft as dr
from repro_torch.core import tree as tr
from repro_torch.core import verify as vf
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kvcache import cache as kvc
from repro_torch.kvcache.offload import (TrafficMeter, full_step_bytes,
                                         partial_step_bytes,
                                         routed_refresh_bytes)
from repro_torch.models import api
from repro_torch.models import common as cm


@dataclass
class EngineState:
    """Per-batch decode state.  The greedy port carries no PRNG streams
    or temperatures (sampling is ROADMAP.md queue 1, 'Sampling')."""
    cache: Any                  # paged trunk cache dict (ssm: the state)
    dcache: Any                 # draft cache dict (paged; ssm contiguous)
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
    """Resumable prefill of one slot (the reference's cursor, its paged
    fields without the prefix-sharing and sampling ones).

    ``off`` is the absolute offset of the next chunk; chunk boundaries
    stay absolute multiples of ``chunk``, so an interleaved prefill runs
    the chunk schedule of a blocking one.  ``row_cache`` / ``row_dcache``
    hold the slot's page-table row and length on the device (batch 1);
    the pools live in the engine's state.  ``pt_host`` / ``dpt_host`` are
    the page plan allocated at begin, decode reserve included."""
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

    @property
    def done(self) -> bool:
        return self.off >= len(self.prompt)

    @property
    def next_tokens(self) -> int:
        """Tokens the next ``prefill_step_into_slot`` call will process
        (0 when done)."""
        if self.done:
            return 0
        end = min(len(self.prompt),
                  (self.off // self.chunk + 1) * self.chunk)
        return end - self.off


# per-slot (batch-row) surgery: every EngineState field carries the batch
# on axis 0 except the cache dicts (see kvcache.cache.CACHE_BATCH_AXIS)
# and the tail-buffer arrays [L, B, Hk, P, ...] (axis 1)
_PKV_FIELDS = ("pkv_k", "pkv_v", "pkv_pos")
_ROW_FIELDS = ("buf_len", "pending", "pending_len", "seq_len",
               "ext_tokens", "ext_feats", "ext_len", "pkv_blocks")


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


def _copy_into(dst, src) -> None:
    """Copy a next-state value into its static buffer (a cache dict entry
    by entry); a value that is the buffer itself is skipped."""
    if isinstance(dst, dict):
        for k, v in src.items():
            _copy_into(dst[k], v)
    elif src is not dst:
        dst.copy_(src)


class CapturedGraph:
    """A captured step or prefill-chunk body.  The kernel wrappers count
    their launches in Python (``ops.LAUNCHES``, ``ops.WKV_SHAPES``), which
    a replay does not run, so ``replay`` adds the counts its capture
    recorded."""

    def __init__(self, graph, launches: Dict[str, int],
                 wkv_shapes: Dict[Tuple[int, bool], int]):
        self.graph = graph
        self.launches = launches
        self.wkv_shapes = wkv_shapes

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launch_counts(self.launches, self.wkv_shapes)


class SpecPVEngine:
    def __init__(self, cfg: ModelConfig, spec: SpecPVConfig,
                 dcfg: DraftConfig, params, draft_params, *,
                 batch: int, max_len: int,
                 partial_verification: bool = True,
                 temperature: float = 0.0,
                 paged: bool = True,
                 num_pages: Optional[int] = None,
                 num_draft_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 tiered: bool = False,
                 zero_copy: bool = True,
                 mesh=None,
                 device=None,
                 cuda_graphs: Optional[bool] = None):
        """Dense targets run with ``paged=True``, ``zero_copy=True`` (when
        partial verification is on; both the defaults here, unlike the
        reference) and tree drafts; the state arch (``ssm``) runs with
        ``paged=False`` and chain drafts, without partial verification.
        Both are greedy (``temperature=0``); every other setting raises
        NotImplementedError naming the ROADMAP item that will bring it.
        ``num_pages`` / ``num_draft_pages`` size the trunk and draft
        pools (default: every row's whole ``max_len``, as lock-step
        ``generate`` needs; the serving scheduler allocates per request
        and gates admission on free pages).
        Runs on ``device`` (CUDA unless ``"cpu"`` is asked for); the
        params must live there.  On the card each step variant and the
        full prefill chunk replay a CUDA graph unless ``cuda_graphs`` is
        False; the CPU runs them eagerly."""
        if cfg.arch_type not in ("dense", "ssm"):
            _unsupported(f"arch {cfg.arch_type!r}", "Other architectures")
        self.is_attn = cfg.is_attention_arch
        if not self.is_attn and paged:
            raise ValueError("paged KV is attention-only (state archs keep "
                             "O(1) state): pass paged=False")
        if self.is_attn and not paged:
            _unsupported("the contiguous SpecPV engine",
                         "contiguous SpecPV engine")
        if temperature != 0.0:
            _unsupported("sampling (temperature > 0)", "Sampling")
        if tiered:
            _unsupported("tiered KV residency", "Tiered KV")
        if mesh is not None:
            _unsupported("mesh sharding", "Multi-GPU")
        if prefix_cache:
            _unsupported("prefix sharing", "Serving")
        if self.is_attn and not spec.use_pallas:
            _unsupported("the paged cache without the kernel route "
                         "(use_pallas=False)", "contiguous SpecPV engine")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.spec = spec
        self.dcfg = dcfg
        self.params = params
        self.dparams = draft_params
        self.batch = batch
        self.max_len = max_len
        self._nb_seq = -(-max_len // spec.block_size)
        self.paged = self.is_attn
        self.num_pages = (num_pages if num_pages is not None
                          else batch * self._nb_seq + 1)
        self.num_draft_pages = (num_draft_pages if num_draft_pages is not None
                                else self.num_pages)
        self._page_alloc = (kvc.PageAllocator(self.num_pages)
                            if self.is_attn else None)
        self._draft_alloc = (kvc.PageAllocator(self.num_draft_pages)
                             if self.is_attn else None)
        self.data_shards = 1            # no mesh: one page pool
        self.partial_enabled = bool(partial_verification) and self.is_attn
        if self.partial_enabled and not zero_copy:
            _unsupported("the gathered partial cache (zero_copy=False)",
                         "contiguous SpecPV engine")
        self.zero_copy = bool(zero_copy and self.partial_enabled)
        self._ns_blocks = spec.partial_budget_tokens // spec.block_size
        self.tree = (tr.TreeSpec.from_branch(dcfg.tree_branch[
            : dcfg.tree_depth]) if self.is_attn
            else tr.TreeSpec.chain(dcfg.tree_depth))
        self.pmax = spec.buffer_size            # max pending (refresh input)
        self.emax = self.tree.max_path          # max draft-extend per step
        self.traffic = TrafficMeter()
        self._pkv_active = False        # lock-step automaton
        self._pkv_active_rows = np.zeros((batch,), bool)   # per slot
        self.dispatches = 0             # fused engine steps executed
        self.dispatch_keys: Dict[Tuple[bool, bool, bool], int] = {}
        self.prefill_dispatches = 0     # slot prefill chunks run
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

    # ------------------------------------------------------------------
    def _init_pkv(self, b: int):
        cfg = self.cfg
        if not self.is_attn:
            z = torch.zeros((0,), device=self.device)
            return z, z.clone(), z.clone()
        # zero-copy: the retrieved body lives in the pool (routed via
        # pkv_blocks), so the dense arrays carry only the tail buffer
        shape = (cfg.num_layers, b, cfg.num_kv_heads, self.spec.buffer_size,
                 cfg.head_dim_)
        pkv_k = torch.zeros(shape, dtype=cm.dt(cfg.dtype), device=self.device)
        pkv_pos = torch.full(shape[:-1], -1, dtype=torch.int32,
                             device=self.device)
        return pkv_k, torch.zeros_like(pkv_k), pkv_pos

    def _init_pkv_blocks(self, b: int):
        """Routed-selection table [B, L, Hk, NS] of -1 (unused); [B, 0, 0,
        0] for a state arch."""
        if not self.is_attn:
            return torch.zeros((b, 0, 0, 0), dtype=torch.int32,
                               device=self.device)
        return torch.full((b, self.cfg.num_layers, self.cfg.num_kv_heads,
                           self._ns_blocks), -1, dtype=torch.int32,
                          device=self.device)

    def _init_cache(self, b: int) -> Dict:
        """The paged trunk cache (page tables filled by ``prefill`` or a
        slot admission); state archs get their recurrent state."""
        if not self.is_attn:
            return api.init_cache(self.cfg, b, self.max_len, self.spec,
                                  device=self.device)
        return api.init_cache(self.cfg, b, self.max_len, self.spec,
                              paged=True, num_pages=self.num_pages,
                              device=self.device)

    def _init_dcache(self, b: int) -> Dict:
        if not self.is_attn:
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
        self.state = EngineState(
            cache=self._init_cache(b), dcache=self._init_dcache(b),
            pkv_k=pkv_k, pkv_v=pkv_v, pkv_pos=pkv_pos, buf_len=ints(b),
            pending=ints(b, self.pmax), pending_len=ints(b), seq_len=ints(b),
            ext_tokens=ints(b, self.emax),
            ext_feats=torch.zeros((b, self.emax, 3 * cfg.d_model), dtype=dt,
                                  device=dev),
            ext_len=ints(b), pkv_blocks=self._init_pkv_blocks(b))
        # prefill: the chunk's inputs (by shape) and the carry between chunks
        self._chunk_toks: Dict[Tuple[int, int], torch.Tensor] = {}
        self._prev_feat = torch.zeros((b, 3 * cfg.d_model), dtype=dt,
                                      device=dev)
        self._logits_last = torch.zeros((b, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        # a slot prefill's batch-1 carry: the cursor's rows are copied in
        # before each chunk and out after (interleaved cursors share it)
        nb = self._nb_seq
        self._slot_cache = dict(page_table=ints(1, nb, dtype=torch.int32),
                                length=ints(1, dtype=torch.int32))
        self._slot_dcache = dict(page_table=ints(1, nb, dtype=torch.int32),
                                 length=ints(1, dtype=torch.int32))
        self._slot_prev_feat = torch.zeros((1, 3 * cfg.d_model), dtype=dt,
                                           device=dev)
        self._slot_logits = torch.zeros((1, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        # the step's row operands, one host copy per step: the per-row
        # modes and the mask of the rows that step
        self._tick_in = ints(2, b, dtype=torch.int8)
        self._modes = self._tick_in[0]
        self._rows = self._tick_in[1].view(torch.bool)
        # what the host reads after a step, packed for one copy: tokens
        # [B, D+1], counts, accept_len, pending_len, seq_len [B] each,
        # then (attention archs) pkv_blocks, read after a Refresh
        self._io_head = b * (self.tree.depth + 1 + 4)
        self._io = ints(self._io_head + self.state.pkv_blocks.numel())
        # host mirrors of the rows' pending and sequence lengths: the
        # mode automaton reads these, never the device
        self._host_pending_len = np.ones((b,), np.int64)
        self._host_seq_len = np.zeros((b,), np.int64)
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
        """Every static tensor; without the K/V pools of the trunk and
        draft caches if ``pools`` is False."""
        st = self.state
        out: List[torch.Tensor] = []
        for f in fields(EngineState):
            v = getattr(st, f.name)
            if isinstance(v, dict):
                out.extend(t for k, t in v.items()
                           if pools or k not in ("k", "v"))
            else:
                out.append(v)
        out += [self._prev_feat, self._logits_last, self._tick_in, self._io,
                self._slot_prev_feat, self._slot_logits]
        out += list(self._slot_cache.values())
        out += list(self._slot_dcache.values())
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
        """Every static tensor to zero, the -1 sentinels set."""
        for t in self._static_tensors():
            t.zero_()
        if self.is_attn:
            self.state.pkv_pos.fill_(-1)
            self.state.pkv_blocks.fill_(-1)

    def prefill(self, prompt: np.ndarray, chunk: int = 256) -> EngineState:
        """Whole-batch chunked prefill into the engine's state, reset in
        place; returns it as the boot state of the lock-step loop (chunk
        boundaries are absolute multiples of ``chunk``).  Every full chunk
        runs one body, captured once as a graph on the card; a short last
        chunk runs eagerly."""
        assert prompt.shape[0] == self.batch
        self._pkv_active = False
        self._pkv_active_rows[:] = False
        self.final_state = None
        self._zero_static()
        st = self.state
        if self.is_attn:
            self._fill_table(st.cache["page_table"], self._page_alloc)
            self._fill_table(st.dcache["page_table"], self._draft_alloc)
        s0 = prompt.shape[1]
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                   device=self.device)
        body = (lambda toks: self._prefill_body(
            toks, st.cache, st.dcache, self._prev_feat, self._logits_last))
        self._prefill_chunks(prompt_t, 0, s0, chunk, "prefill", body)
        sub = self._boot_state(st.cache, st.dcache, self._logits_last,
                               self._prev_feat, s0)
        for f in fields(EngineState):
            _copy_into(getattr(st, f.name), getattr(sub, f.name))
        self._host_pending_len = np.ones((self.batch,), np.int64)
        self._host_seq_len = np.full((self.batch,), s0 + 1, np.int64)
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
                      logits_last) -> None:
        """One prefill chunk (trunk, then draft extend) into static
        buffers: the caches (their pools written in place, the lengths
        copied), the boundary feature carried to the next chunk and the
        last token's logits."""
        cfg = self.cfg
        logits, feats, cache_n = api.prefill(cfg, self.params, toks, cache,
                                             spec=self.spec)
        fused = feats.fused_input()                           # [B, T, 3d]
        shifted = torch.cat([prev_feat[:, None], fused[:, :-1]], dim=1)
        valid = torch.ones(toks.shape, dtype=torch.bool, device=toks.device)
        dcache_n, _, _ = dr.draft_extend(cfg, self.dcfg, self.dparams,
                                         self.params, dcache, toks, shifted,
                                         valid)
        prev_feat.copy_(fused[:, -1])
        logits_last.copy_(logits)
        _copy_into(cache, cache_n)
        _copy_into(dcache, dcache_n)

    def _boot_state(self, cache: Dict, dcache: Dict, logits_last, prev_feat,
                    s0: int) -> EngineState:
        """Post-prefill state of ``b`` rows from the greedy first token:
        the pending and extend queues seeded, the tail buffer and routed
        selection empty.  Shared by the lock-step prefill and the slot
        finalise, so both build the same automaton state."""
        cfg, dev = self.cfg, self.device
        b = prev_feat.shape[0]
        bonus0 = torch.argmax(logits_last, dim=-1)
        pending = torch.zeros((b, self.pmax), dtype=torch.long, device=dev)
        pending[:, 0] = bonus0
        ext_tokens = torch.zeros((b, self.emax), dtype=torch.long, device=dev)
        ext_tokens[:, 0] = bonus0
        ext_feats = torch.zeros((b, self.emax, 3 * cfg.d_model),
                                dtype=cm.dt(cfg.dtype), device=dev)
        ext_feats[:, 0] = prev_feat
        pkv_k, pkv_v, pkv_pos = self._init_pkv(b)

        def full(v):
            return torch.full((b,), v, dtype=torch.long, device=dev)
        return EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=full(0), pending=pending,
            pending_len=full(1), seq_len=full(s0 + 1), ext_tokens=ext_tokens,
            ext_feats=ext_feats, ext_len=full(1),
            pkv_blocks=self._init_pkv_blocks(b))

    # ------------------------------------------------------------------
    # per-slot state (continuous batching)
    def _neutral_state(self) -> EngineState:
        """One dead row: its page tables on the null page, lengths 0, one
        placeholder token pending so no index underflows, no tail buffer
        or routed selection."""
        cfg, dev = self.cfg, self.device
        pkv_k, pkv_v, pkv_pos = self._init_pkv(1)

        def row():
            return dict(page_table=torch.zeros((1, self._nb_seq),
                                               dtype=torch.int32, device=dev),
                        length=torch.zeros((1,), dtype=torch.int32,
                                           device=dev))

        def full(v, *shape):
            return torch.full(shape or (1,), v, dtype=torch.long, device=dev)
        return EngineState(
            cache=row(), dcache=row(), pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=full(0), pending=full(0, 1, self.pmax),
            pending_len=full(1), seq_len=full(1),
            ext_tokens=full(0, 1, self.emax),
            ext_feats=torch.zeros((1, self.emax, 3 * cfg.d_model),
                                  dtype=cm.dt(cfg.dtype), device=dev),
            ext_len=full(1), pkv_blocks=self._init_pkv_blocks(1))

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
        self.final_state = None
        self._page_alloc.reset()
        self._draft_alloc.reset()
        self._zero_static()
        st = self.state
        for t in (st.pending_len, st.seq_len, st.ext_len):
            t.fill_(1)
        self._host_pending_len = np.ones((self.batch,), np.int64)
        self._host_seq_len = np.ones((self.batch,), np.int64)
        return st

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
        self._host_pending_len[slot] = 1
        self._host_seq_len[slot] = 1
        return write_state_slot(st, self._neutral_sub, slot)

    def reset_slot(self, st: EngineState, slot: int) -> EngineState:
        """Evict a slot: release its page references and pins, then
        neutralise its rows (pool contents are left stale; nothing reads
        them once unmapped)."""
        self.release_slot_pages(slot)
        return self.clear_slot_rows(st, slot)

    # ---- page accounting (host side) ---------------------------------
    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Pages a request needs end to end (see request_token_need)."""
        toks = request_token_need(prompt_len, max_new_tokens, self.pmax,
                                  self.emax)
        return min(-(-toks // self.spec.block_size), self._nb_seq)

    def pages_needed_shared(self, prompt: np.ndarray, max_new_tokens: int,
                            touch: bool = False,
                            shard: Optional[int] = None,
                            temperature: Optional[float] = None) -> int:
        """Fresh pages the request needs now: ``pages_needed``, since no
        prefix cache can discount blocks (prefix sharing is ROADMAP.md
        queue 1, 'Serving')."""
        return self.pages_needed(len(prompt), max_new_tokens)

    def free_pages(self, shard: Optional[int] = None) -> int:
        """Fresh pages available for admission: the tighter of the trunk
        and draft pools."""
        if not self.paged:
            return 1 << 30
        return min(self._page_alloc.free, self._draft_alloc.free)

    def page_capacity(self) -> int:
        return self._page_alloc.capacity if self.paged else 1 << 30

    def reclaim_pages(self, n: int) -> int:
        """Pages freed by evicting idle cached prefixes: none without a
        prefix cache."""
        return 0

    def shard_of_slot(self, slot: int) -> int:
        return 0

    def tier_admit_margin(self, prompt_len: int) -> int:
        """Promotion headroom a tiered pool reserves: none untiered."""
        return 0

    def tier_ready_rows(self, rows: np.ndarray, modes: np.ndarray,
                        force: bool = True) -> Tuple[np.ndarray, int]:
        """Rows whose demoted pages can be seated this tick: all of them
        untiered."""
        return rows, 0

    def release_slot_pages(self, slot: int) -> None:
        """Release an evicted slot's page references and pins ahead of
        the deferred row reset, so same-tick admission sees them."""
        if self.paged:
            self._page_alloc.free_slot(slot)
            self._draft_alloc.free_slot(slot)

    def reset_high_water(self) -> None:
        """Zero the page high-water marks (benchmark warm-up)."""
        if self.paged:
            for al in (self._page_alloc, self._draft_alloc):
                al.high_water = 0
                al.resident_high_water = 0

    def page_stats(self) -> Dict[str, int]:
        al = self._page_alloc
        if al is None:
            return {}
        return dict(num_pages=self.num_pages, capacity=al.capacity,
                    in_use=al.in_use, idle=al.idle, committed=al.committed,
                    high_water=al.high_water,
                    resident_high_water=al.resident_high_water,
                    draft_num_pages=self.num_draft_pages,
                    draft_in_use=self._draft_alloc.in_use,
                    draft_high_water=self._draft_alloc.high_water,
                    contiguous_pages=self.batch * self._nb_seq,
                    block_size=self.spec.block_size,
                    pinned_pages=al.pinned_pages)

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
        commit it with ``prefill_finalize_slot``.  The whole page plan,
        prompt blocks plus the decode reserve sized by ``max_new_tokens``
        (default: the rest of max_len), is allocated here, so later steps
        never fail on pool exhaustion; raises RuntimeError when the pools
        cannot cover it.  The slot's device rows are neutralised: decode
        steps may run between chunks."""
        self._slots_only()
        self._own(st)
        if extra is not None:
            _unsupported("per-request conditioning (extra)",
                         "Other architectures")
        if (temperature or 0.0) != 0.0 or draft != "tree":
            _unsupported("sampled or chain requests", "Sampling")
        prompt = np.asarray(prompt)
        al, dal = self._page_alloc, self._draft_alloc
        al.free_slot(slot)                      # stale pages, if any
        dal.free_slot(slot)
        budget = (max_new_tokens if max_new_tokens is not None
                  else max(self.max_len - len(prompt), 0))
        total = self.pages_needed(len(prompt), budget)
        if total > self.free_pages():
            raise RuntimeError(
                f"slot {slot}: request needs {total} fresh pages, "
                f"{al.free}/{dal.free} free (trunk/draft) of {al.capacity}")
        pt_host = np.zeros((self._nb_seq,), np.int32)
        dpt_host = np.zeros((self._nb_seq,), np.int32)
        pt_host[:total] = al.alloc(slot, total)
        dpt_host[:total] = dal.alloc(slot, total)
        dev = self.device

        def row(pt):
            return dict(page_table=torch.as_tensor(pt[None], device=dev),
                        length=torch.zeros((1,), dtype=torch.int32,
                                           device=dev))
        cur = PrefillCursor(
            slot=slot, prompt=prompt, chunk=chunk, off=0,
            prev_feat=torch.zeros((1, 3 * self.cfg.d_model),
                                  dtype=cm.dt(self.cfg.dtype), device=dev),
            row_cache=row(pt_host), row_dcache=row(dpt_host),
            tokens=torch.as_tensor(prompt, dtype=torch.long, device=dev),
            pt_host=pt_host, dpt_host=dpt_host, total_pages=total)
        return self.clear_slot_rows(st, slot), cur

    def prefill_step_into_slot(self, st: EngineState, cur: PrefillCursor
                               ) -> Tuple[EngineState, int]:
        """Advance `cur` by exactly one chunk (chunk boundaries absolute),
        over the shared pools through the cursor's own page-table rows.
        A full chunk replays the batch-1 graph ``("slot_prefill", chunk)``;
        the cursor's rows are copied into its static buffers before and
        out after.  Returns (state, tokens processed)."""
        assert not cur.done, "prefill cursor already exhausted"
        self._own(st)
        off = cur.off
        end = min(len(cur.prompt), (off // cur.chunk + 1) * cur.chunk)
        _copy_into(self._slot_cache, cur.row_cache)
        _copy_into(self._slot_dcache, cur.row_dcache)
        self._slot_prev_feat.copy_(cur.prev_feat)
        cache = dict(self._slot_cache, **{
            n: st.cache[n] for n in kvc.PAGED_POOL_KEYS})
        dcache = dict(self._slot_dcache, **{
            n: st.dcache[n] for n in kvc.DRAFT_POOL_KEYS})
        self._prefill_chunks(
            cur.tokens[None], off, end, cur.chunk, "slot_prefill",
            lambda toks: self._prefill_body(toks, cache, dcache,
                                            self._slot_prev_feat,
                                            self._slot_logits))
        self.prefill_dispatches += 1
        _copy_into(cur.row_cache, self._slot_cache)
        _copy_into(cur.row_dcache, self._slot_dcache)
        cur.prev_feat.copy_(self._slot_prev_feat)
        cur.off = end
        if cur.done:
            cur.logits_last = self._slot_logits.clone()
        return st, end - off

    def prefill_finalize_slot(self, st: EngineState, cur: PrefillCursor
                              ) -> Tuple[EngineState, int]:
        """Commit an exhausted cursor: build the slot's automaton state
        from the last chunk's logits and write it into batch row
        ``cur.slot``.  Returns (state, first token)."""
        assert cur.done, "prefill cursor still has chunks to run"
        self._own(st)
        sub = self._boot_state(cur.row_cache, cur.row_dcache,
                               cur.logits_last, cur.prev_feat,
                               len(cur.prompt))
        write_state_slot(st, sub, cur.slot)
        self._pkv_active_rows[cur.slot] = False
        self._host_pending_len[cur.slot] = 1
        self._host_seq_len[cur.slot] = len(cur.prompt) + 1
        return st, int(sub.pending[0, 0])

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
        """Capture ``body`` as a CUDA graph.  A warm-up run on a side
        stream comes first (lazy library and workspace set-up must not
        happen under capture); it writes the state in place, so a copy
        taken before restores it and the first replay is the real step.
        The K/V pools are left out of the copy: a body writes them only
        at its rows' next positions (``[length, length + W)`` of the
        trunk or draft cache, W fixed by the body's shapes), every one of
        which the real step writes again before anything reads it, and
        reads past ``length`` are masked.  The kernel launches counted
        during the capture are recorded for the replays, and neither the
        warm-up's nor the capture's count.  Any error raises."""
        from repro_torch.kernels import build
        build.load_library()
        counts = ops.launch_counts()
        cur = torch.cuda.current_stream(self.device)
        saved = [(t, t.clone()) for t in self._static_tensors(pools=False)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)
        for t, copy in saved:
            t.copy_(copy)
        del saved
        if self._graph_pool is None:
            # one pool for the engine's graphs: each body leaves its
            # results in the static buffers, so no tensor of the pool is
            # read after its own replay ends, and replays never overlap
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            body()
        delta = ops.launch_count_delta(before, ops.launch_counts())
        ops.set_launch_counts(counts)
        return CapturedGraph(graph, *delta)

    def _fused_body(self, has_full: bool, has_partial: bool,
                    has_refresh: bool) -> None:
        nxt, out = self._step_fused(self.state, self._modes,
                                    active=self._rows, has_full=has_full,
                                    has_partial=has_partial,
                                    has_refresh=has_refresh)
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
            _copy_into(getattr(st, f.name), getattr(nxt, f.name))
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
                    has_full: bool, has_partial: bool, has_refresh: bool
                    ) -> Tuple[EngineState, Tuple]:
        """One fused multi-mode greedy step over per-row ``modes`` [B]
        (the greedy body of the reference's ``_step_fused``) of the rows
        where ``active`` [B] bool is set (default: every row).  Returns
        the next state (the pool, its summaries and the draft pool
        written in place, the other fields new tensors) and (tokens,
        counts, accept_len).

        Every row computes; a row outside ``active`` commits nothing (its
        cache and buffer writes get count 0, so its lengths stay) and
        keeps every row field, so the next state equals the reference's
        step followed by its row merge.  Its pool writes land at or past
        its length (on the null page for a neutral row), where its next
        real step writes before anything reads."""
        cfg, spec, tree = self.cfg, self.spec, self.tree
        b, dev = self.batch, self.device
        act = (active if active is not None
               else torch.ones((b,), dtype=torch.bool, device=dev))
        dcache, tree_tokens, _ = dr.draft_phase(
            cfg, self.dcfg, self.dparams, self.params, tree, st.dcache,
            st.ext_tokens, st.ext_feats, st.ext_len)
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
                                           tree_tokens, st.seq_len)
        decode_kind = ("fused" if has_full and has_partial
                       else ("full" if has_full else "partial"))
        out = api.decode(
            cfg, self.params, vin["tokens"], vin["positions"], st.cache,
            mode=decode_kind, self_mask=vin["self_mask"],
            pkv=(st.pkv_k, st.pkv_v, st.pkv_pos), spec=spec,
            emit_queries=has_refresh,
            partial_rows=is_partial if decode_kind == "fused" else None,
            pkv_blocks=(st.pkv_blocks.movedim(0, 1)
                        if self.zero_copy and has_partial else None))
        path, acc, bonus, _ = tr.greedy_tree_accept(
            tree, tree_tokens, out.logits, vin["root_slot"],
            vin["node_slots"])
        newtoks, ext_feats, ext_len, seq_len = self._post_accept(
            st, vin, out, tree_tokens, path, acc, bonus)
        slots, slot_valid = vf.commit_slots(tree, vin["pend_valid"], path,
                                            p_eff)
        ck, cv = vf.gather_new_kv(out.new_kv, slots, slot_valid)
        count = plen_in + acc

        cache = st.cache
        pkv_k, pkv_v, pkv_pos = st.pkv_k, st.pkv_v, st.pkv_pos
        pkv_blocks, buf_len = st.pkv_blocks, st.buf_len
        if has_partial:
            # partial rows append their accepted run (at most 1 + depth
            # valid entries after compaction) to the tail buffer
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
            nbi = nbi.movedim(0, 1)                   # [B, L, Hk, NS]
            ref_rows = is_refresh & act
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
            # inactive rows keep their automaton and their draft length
            def keep(new, old):
                return kvc.select_rows(active, new, old, 0)
            pending, pending_len = (keep(pending, st.pending),
                                    keep(pending_len, st.pending_len))
            seq_len = keep(seq_len, st.seq_len)
            ext_tokens = keep(newtoks, st.ext_tokens)
            ext_feats = keep(ext_feats, st.ext_feats)
            ext_len = keep(ext_len, st.ext_len)
            dcache = dict(dcache, length=keep(dcache["length"],
                                              st.dcache["length"]))
        st2 = EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=buf_len, pending=pending,
            pending_len=pending_len, seq_len=seq_len, ext_tokens=ext_tokens,
            ext_feats=ext_feats, ext_len=ext_len, pkv_blocks=pkv_blocks)
        return st2, (newtoks, acc + 1, acc)

    def _step_state(self, st: EngineState) -> Tuple[EngineState, Tuple]:
        """One greedy chain step of a state arch: draft a chain, verify
        it with a read-only pass over [pending token | chain], accept
        the longest matching prefix, then advance the recurrent state
        over the pending token and the accepted tokens (``valid`` =
        1 + accepted; the padded tail leaves the state as it was)."""
        cfg, tree = self.cfg, self.tree
        b, dev = self.batch, self.device
        dcache, tree_tokens, _ = dr.draft_phase(
            cfg, self.dcfg, self.dparams, self.params, tree, st.dcache,
            st.ext_tokens, st.ext_feats, st.ext_len)
        pend_in = st.pending[:, :1]
        ones = torch.ones((b,), dtype=torch.long, device=dev)
        vin = vf.build_verify_inputs_fused(tree, pend_in, ones, ones,
                                           tree_tokens, st.seq_len)
        out = api.decode(cfg, self.params, vin["tokens"], vin["positions"],
                         st.cache, self_mask=vin["self_mask"],
                         spec=self.spec)
        path, acc, bonus, _ = tr.greedy_tree_accept(
            tree, tree_tokens, out.logits, vin["root_slot"],
            vin["node_slots"])
        newtoks, ext_feats, ext_len, seq_len = self._post_accept(
            st, vin, out, tree_tokens, path, acc, bonus)
        path_toks = torch.where(
            path >= 0, torch.gather(tree_tokens.long(), 1,
                                    torch.clamp(path, min=0)),
            torch.zeros_like(path))
        adv_toks = torch.cat([pend_in, path_toks], dim=1)
        adv_valid = (torch.arange(1 + tree.depth, device=dev)[None]
                     < (1 + acc)[:, None])
        cache = api.advance(cfg, self.params, adv_toks, st.cache, adv_valid)
        pending = torch.zeros_like(st.pending)
        pending[:, 0] = bonus
        st2 = EngineState(
            cache=cache, dcache=dcache, pkv_k=st.pkv_k, pkv_v=st.pkv_v,
            pkv_pos=st.pkv_pos, buf_len=st.buf_len, pending=pending,
            pending_len=ones, seq_len=seq_len, ext_tokens=newtoks,
            ext_feats=ext_feats, ext_len=ext_len, pkv_blocks=st.pkv_blocks)
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
        other rows keep their state (see ``_step_fused``).  The row mask
        and the modes go to the card in one copy; the graph is keyed by
        the mode mix of the stepped rows."""
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
        # inactive rows compute in the first active mode (their results
        # are dropped), so every row runs a branch the variant has
        modes = np.where(rows, modes, active_modes[0]).astype(np.int8)
        self._tick_in.copy_(torch.from_numpy(
            np.stack([modes, rows.astype(np.int8)])))
        key = (has_full, has_partial, has_refresh)
        self._run(key, lambda: self._fused_body(*key))
        self.dispatches += 1
        self.dispatch_keys[key] = self.dispatch_keys.get(key, 0) + 1
        pin = self.zero_copy and has_refresh
        toks, counts, acc, pbi_host = self._read_io(blocks=pin)
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
            if self.is_attn:
                raise ValueError(mode)
            self._own(st)
            self._run("state", self._state_body)
            self.dispatches += 1
            toks, counts, acc, _ = self._read_io(blocks=False)
            return st, StepOutput(tokens=toks, counts=counts, accept_len=acc,
                                  mode=mode)
        if mode not in MODE_IDS:
            raise ValueError(mode)
        st, out = self.step_fused(
            st, np.ones((self.batch,), bool),
            np.full((self.batch,), MODE_IDS[mode], np.int8))
        if mode == "refresh":
            self._pkv_active = True
        return st, out

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
        plus buffer, a zero-copy refresh its routed rebuild."""
        cfg, spec = self.cfg, self.spec
        l_attn = cfg.num_layers
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
            if mode == "refresh":
                nbytes += routed_refresh_bytes(
                    l_attn, nrows, self._nb_seq, self._ns_blocks,
                    spec.buffer_size, hk, dh, itemsize)
        self.traffic.record(mode, nbytes)

    # ------------------------------------------------------------------
    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: int = -1, prefill_chunk: int = 256):
        """Greedy SpecPV generation.  Returns (tokens [B, max_new], stats
        dict with steps, mean_accept, modes, tokens_per_step and
        prefill_s: host seconds until the first token reached the host,
        which waits for the prefill on the device).  The state after the
        last step stays in ``final_state`` until the next prefill."""
        t0 = time.perf_counter()
        st = self.prefill(prompt, chunk=prefill_chunk)
        b = self.batch
        first = st.pending[:, 0].cpu().numpy()
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
