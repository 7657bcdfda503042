"""SpecPV generation engine (counterpart of ``repro/core/engine.py``,
paper Algorithm 1), the lock-step greedy subset:

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
        self.num_pages = (num_pages if num_pages is not None
                          else batch * self._nb_seq + 1)
        self._page_alloc = (kvc.PageAllocator(self.num_pages)
                            if self.is_attn else None)
        self._draft_alloc = (kvc.PageAllocator(self.num_pages)
                             if self.is_attn else None)
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
        self._pkv_active = False
        self.dispatches = 0             # fused engine steps executed
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

    def _init_cache(self, b: int) -> Dict:
        """The paged trunk cache (page tables filled by ``prefill``); state
        archs get their recurrent state."""
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
                                         self.num_pages, self.device)

    def _init_static(self) -> None:
        """The engine's one decode state (``state``) and the buffers around
        it, at addresses that never change, so that a captured graph reads
        and writes them; ``prefill`` resets them in place.  The step's
        device constants are built and the kernels' merge counters
        reserved here, before any capture."""
        cfg, b, dev = self.cfg, self.batch, self.device
        dt = cm.dt(cfg.dtype)

        def ints(*shape):
            return torch.zeros(shape, dtype=torch.long, device=dev)
        pkv_k, pkv_v, pkv_pos = self._init_pkv(b)
        nbl = ((b, cfg.num_layers, cfg.num_kv_heads, self._ns_blocks)
               if self.is_attn else (b, 0, 0, 0))
        self.state = EngineState(
            cache=self._init_cache(b), dcache=self._init_dcache(b),
            pkv_k=pkv_k, pkv_v=pkv_v, pkv_pos=pkv_pos, buf_len=ints(b),
            pending=ints(b, self.pmax), pending_len=ints(b), seq_len=ints(b),
            ext_tokens=ints(b, self.emax),
            ext_feats=torch.zeros((b, self.emax, 3 * cfg.d_model), dtype=dt,
                                  device=dev),
            ext_len=ints(b),
            pkv_blocks=torch.zeros(nbl, dtype=torch.int32, device=dev))
        # prefill: the chunk's inputs and the carry between chunks
        self._chunk_toks: Dict[int, torch.Tensor] = {}
        self._prev_feat = torch.zeros((b, 3 * cfg.d_model), dtype=dt,
                                      device=dev)
        self._logits_last = torch.zeros((b, cfg.vocab_size),
                                        dtype=torch.float32, device=dev)
        self._modes = torch.zeros((b,), dtype=torch.int8, device=dev)
        # what the host reads after a step, packed for one copy: tokens
        # [B, D+1], counts, accept_len, pending_len, seq_len [B] each,
        # then (attention archs) pkv_blocks, read after a Refresh
        self._io_head = b * (self.tree.depth + 1 + 4)
        self._io = ints(self._io_head + self.state.pkv_blocks.numel())
        self._host_pending_len = np.ones((b,), np.int64)
        self._host_seq_len = np.zeros((b,), np.int64)
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
        out += [self._prev_feat, self._logits_last, self._modes, self._io]
        return out + list(self._chunk_toks.values())

    def _fill_table(self, table, al: kvc.PageAllocator) -> None:
        """Give every row its whole max_len worth of pages (lock-step
        ``generate``) and write the table in place."""
        al.reset()
        b = table.shape[0]
        if b * self._nb_seq > al.capacity:
            raise ValueError(
                f"paged generate needs {b * self._nb_seq} pages but the "
                f"pool holds {al.capacity}; raise num_pages")
        pt = np.zeros((b, self._nb_seq), np.int32)
        for i in range(b):
            pt[i] = al.alloc(i, self._nb_seq)
        table.copy_(torch.from_numpy(pt))

    def _reset(self) -> None:
        """Every static tensor back to the state of a fresh engine."""
        for t in self._static_tensors():
            t.zero_()
        st = self.state
        if self.is_attn:
            self._fill_table(st.cache["page_table"], self._page_alloc)
            self._fill_table(st.dcache["page_table"], self._draft_alloc)
            st.pkv_pos.fill_(-1)
            st.pkv_blocks.fill_(-1)

    def prefill(self, prompt: np.ndarray, chunk: int = 256) -> EngineState:
        """Whole-batch chunked prefill into the engine's state, reset in
        place; returns it as the boot state of the lock-step loop (chunk
        boundaries are absolute multiples of ``chunk``).  Every full chunk
        runs one body, captured once as a graph on the card; a short last
        chunk runs eagerly."""
        assert prompt.shape[0] == self.batch
        self._pkv_active = False
        self.final_state = None
        self._reset()
        s0 = prompt.shape[1]
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                   device=self.device)
        off = 0
        while off < s0:
            end = min(s0, (off // chunk + 1) * chunk)
            if end - off == chunk:
                toks = self._chunk_toks.get(chunk)
                if toks is None:
                    toks = torch.zeros((self.batch, chunk), dtype=torch.long,
                                       device=self.device)
                    self._chunk_toks[chunk] = toks
                toks.copy_(prompt_t[:, off:end])
                self._run(("prefill", chunk),
                          lambda: self._prefill_body(toks))
            else:
                self._prefill_body(prompt_t[:, off:end])
            off = end
        self._boot(s0)
        return self.state

    def _prefill_body(self, toks) -> None:
        """One prefill chunk (trunk, then draft extend) into the state."""
        cfg, st = self.cfg, self.state
        logits_last, feats, cache = api.prefill(
            cfg, self.params, toks, st.cache, spec=self.spec)
        fused = feats.fused_input()                           # [B, T, 3d]
        shifted = torch.cat([self._prev_feat[:, None], fused[:, :-1]], dim=1)
        valid = torch.ones(toks.shape, dtype=torch.bool, device=toks.device)
        dcache, _, _ = dr.draft_extend(cfg, self.dcfg, self.dparams,
                                       self.params, st.dcache, toks, shifted,
                                       valid)
        self._prev_feat.copy_(fused[:, -1])
        self._logits_last.copy_(logits_last)
        _copy_into(st.cache, cache)
        _copy_into(st.dcache, dcache)

    def _boot(self, s0: int) -> None:
        """Post-prefill state from the greedy first token (the reset left
        every other field as a fresh state has it)."""
        st = self.state
        bonus0 = torch.argmax(self._logits_last, dim=-1)
        st.pending[:, 0] = bonus0
        st.ext_tokens[:, 0] = bonus0
        st.ext_feats[:, 0] = self._prev_feat
        st.pending_len.fill_(1)
        st.ext_len.fill_(1)
        st.seq_len.fill_(s0 + 1)
        self._host_pending_len = np.ones((self.batch,), np.int64)
        self._host_seq_len = np.full((self.batch,), s0 + 1, np.int64)

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
                                    has_full=has_full,
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

    def _step_fused(self, st: EngineState, modes, *, has_full: bool,
                    has_partial: bool, has_refresh: bool
                    ) -> Tuple[EngineState, Tuple]:
        """One fused multi-mode greedy step over per-row ``modes`` [B]
        (the greedy body of the reference's ``_step_fused``).  Returns the
        next state (the pool, its summaries and the draft pool written in
        place, the other fields new tensors) and (tokens, counts,
        accept_len)."""
        cfg, spec, tree = self.cfg, self.spec, self.tree
        b, dev = self.batch, self.device
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
            count_buf = (torch.where(is_partial, count, torch.zeros_like(count))
                         if has_full else count)
            nk, nv, npos, nbl = vf.append_buffer(
                pkv_k, pkv_v, pkv_pos, 0, buf_len, ck[:, :, :wb],
                cv[:, :, :wb], cpos, count_buf)
            if has_full:   # non-partial rows keep their buffer bits
                selp = is_partial[None, :, None, None]
                pkv_k = torch.where(selp[..., None], nk, pkv_k)
                pkv_v = torch.where(selp[..., None], nv, pkv_v)
                pkv_pos = torch.where(selp, npos, pkv_pos)
                buf_len = torch.where(is_partial, nbl, buf_len)
            else:
                pkv_k, pkv_v, pkv_pos, buf_len = nk, nv, npos, nbl
        if has_full:
            # full/refresh rows commit exact KV; partial rows pass count 0
            count_full = (torch.where(is_partial, torch.zeros_like(count),
                                      count) if has_partial else count)
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
            pkv_blocks = torch.where(is_refresh[:, None, None, None], nbi,
                                     pkv_blocks)
            pkv_pos = torch.where(is_refresh[None, :, None, None],
                                  torch.full_like(pkv_pos, -1), pkv_pos)
            buf_len = torch.where(is_refresh, torch.zeros_like(buf_len),
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
        st2 = EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=buf_len, pending=pending,
            pending_len=pending_len, seq_len=seq_len, ext_tokens=newtoks,
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

    def step_fused(self, st: EngineState, rows: np.ndarray,
                   modes: np.ndarray) -> Tuple[EngineState, StepOutput]:
        """One fused multi-mode step of the engine's state ``st``.  The
        lock-step slice steps every row (``rows`` all True); per-slot row
        masking is ROADMAP.md queue 1, 'Serving'."""
        if not self.is_attn:
            raise ValueError("state archs step through step(st, 'state')")
        self._own(st)
        rows = np.asarray(rows, bool)
        if not rows.all():
            _unsupported("stepping a subset of rows", "Serving")
        modes = np.asarray(modes, np.int8)
        has_refresh = bool(np.any(modes == MODE_REFRESH))
        has_full = has_refresh or bool(np.any(modes == MODE_FULL))
        has_partial = bool(np.any(modes == MODE_PARTIAL))
        self._modes.copy_(torch.from_numpy(modes))
        key = (has_full, has_partial, has_refresh)
        self._run(key, lambda: self._fused_body(*key))
        self.dispatches += 1
        pin = self.zero_copy and has_refresh
        toks, counts, acc, pbi_host = self._read_io(blocks=pin)
        if pin:
            # pin the pages the refresh just routed; pin_slot_pages takes
            # the new references before dropping the previous refresh's,
            # so a page kept across refreshes never transiently frees
            al = self._page_alloc
            for i in np.nonzero(modes == MODE_REFRESH)[0]:
                i = int(i)
                blocks = np.unique(pbi_host[i][pbi_host[i] >= 0])
                nb = al.count(i)
                pages = [al.page_at(i, int(j)) for j in blocks if j < nb]
                if pages:
                    al.pin_slot_pages(i, pages)
        self._record_traffic_rows(modes)
        names = sorted({MODE_NAMES[int(m)] for m in modes})
        return st, StepOutput(tokens=toks, counts=counts, accept_len=acc,
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

    def _record_traffic_rows(self, modes: np.ndarray):
        for mid in (MODE_FULL, MODE_REFRESH, MODE_PARTIAL):
            sub = modes == mid
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
