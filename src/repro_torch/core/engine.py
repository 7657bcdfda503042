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

Every step is one call of ``_step_fused`` (the reference's one jitted
dispatch per tick; ``dispatches`` counts them), with the tick's mode mix
deciding which masked branches run.

State architectures (RWKV-6, ``paged=False``) have no KV cache, so
partial verification does not apply: each step (mode ``"state"``,
``_step_state``) drafts a chain, verifies it with a read-only pass,
accepts greedily and advances the recurrent state over the pending
token and the accepted prefix.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DraftConfig, ModelConfig, SpecPVConfig
from repro_torch.core import draft as dr
from repro_torch.core import tree as tr
from repro_torch.core import verify as vf
from repro_torch.device import resolve_device
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
                 device=None):
        """Dense targets run with ``paged=True``, ``zero_copy=True`` (when
        partial verification is on; both the defaults here, unlike the
        reference) and tree drafts; the state arch (``ssm``) runs with
        ``paged=False`` and chain drafts, without partial verification.
        Both are greedy (``temperature=0``); every other setting raises
        NotImplementedError naming the ROADMAP item that will bring it.
        Runs on ``device`` (CUDA unless ``"cpu"`` is asked for); the
        params must live there."""
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

    def _init_cache(self, b: int, *, full_alloc: bool = False) -> Dict:
        """Fresh paged cache; ``full_alloc`` gives every row its whole
        max_len worth of pages up front (lock-step ``generate``).  State
        archs get their zeroed recurrent state."""
        if not self.is_attn:
            return api.init_cache(self.cfg, b, self.max_len, self.spec,
                                  device=self.device)
        cache = api.init_cache(self.cfg, b, self.max_len, self.spec,
                               paged=True, num_pages=self.num_pages,
                               device=self.device)
        if full_alloc:
            cache["page_table"] = self._full_table(self._page_alloc, b)
        return cache

    def _init_dcache(self, b: int, *, full_alloc: bool = False) -> Dict:
        if not self.is_attn:
            return dr.init_draft_cache(self.cfg, b, self.max_len, self.device)
        dcache = dr.init_paged_draft_cache(self.cfg, b, self.max_len,
                                           self.spec.block_size,
                                           self.num_pages, self.device)
        if full_alloc:
            dcache["page_table"] = self._full_table(self._draft_alloc, b)
        return dcache

    def _full_table(self, al: kvc.PageAllocator, b: int):
        al.reset()
        if b * self._nb_seq > al.capacity:
            raise ValueError(
                f"paged generate needs {b * self._nb_seq} pages but the "
                f"pool holds {al.capacity}; raise num_pages")
        pt = np.zeros((b, self._nb_seq), np.int32)
        for i in range(b):
            pt[i] = al.alloc(i, self._nb_seq)
        return torch.as_tensor(pt, device=self.device)

    def prefill(self, prompt: np.ndarray, chunk: int = 256) -> EngineState:
        """Whole-batch chunked prefill; returns the boot state of the
        lock-step loop (chunk boundaries are absolute multiples of
        ``chunk``)."""
        assert prompt.shape[0] == self.batch
        self._pkv_active = False
        self.final_state = None         # free its cache before a new one
        return self._prefill_state(prompt, chunk)

    def _prefill_state(self, prompt: np.ndarray, chunk: int = 256
                       ) -> EngineState:
        cfg = self.cfg
        b, s0 = prompt.shape
        cache = self._init_cache(b, full_alloc=self.is_attn)
        dcache = self._init_dcache(b, full_alloc=self.is_attn)
        prev_feat = torch.zeros((b, 3 * cfg.d_model), dtype=cm.dt(cfg.dtype),
                                device=self.device)
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                   device=self.device)
        logits_last = None
        off = 0
        while off < s0:
            end = min(s0, (off // chunk + 1) * chunk)
            toks = prompt_t[:, off:end]
            logits_last, feats, cache = api.prefill(
                cfg, self.params, toks, cache, spec=self.spec)
            fused = feats.fused_input()                       # [B, T, 3d]
            shifted = torch.cat([prev_feat[:, None], fused[:, :-1]], dim=1)
            valid = torch.ones(toks.shape, dtype=torch.bool,
                               device=self.device)
            dcache, _, _ = dr.draft_extend(cfg, self.dcfg, self.dparams,
                                           self.params, dcache, toks,
                                           shifted, valid)
            prev_feat = fused[:, -1]
            off = end
        return self._boot_state(cache, dcache, logits_last, prev_feat, s0)

    def _boot_state(self, cache, dcache, logits_last, prev_feat,
                    s0: int) -> EngineState:
        """Post-prefill state from the greedy first token."""
        bonus0 = torch.argmax(logits_last, dim=-1)
        return self._boot_state_from_token(cache, dcache, bonus0, prev_feat,
                                           s0)

    def _boot_state_from_token(self, cache, dcache, bonus0, prev_feat,
                               s0: int) -> EngineState:
        cfg, dev = self.cfg, self.device
        b = prev_feat.shape[0]
        bonus0 = torch.as_tensor(bonus0, dtype=torch.long, device=dev)
        pend = torch.zeros((b, self.pmax), dtype=torch.long, device=dev)
        pend[:, 0] = bonus0
        ext_tokens = torch.zeros((b, self.emax), dtype=torch.long, device=dev)
        ext_tokens[:, 0] = bonus0
        ext_feats = torch.zeros((b, self.emax, 3 * cfg.d_model),
                                dtype=cm.dt(cfg.dtype), device=dev)
        ext_feats[:, 0] = prev_feat
        pkv_k, pkv_v, pkv_pos = self._init_pkv(b)
        ones = torch.ones((b,), dtype=torch.long, device=dev)
        return EngineState(
            cache=cache, dcache=dcache, pkv_k=pkv_k, pkv_v=pkv_v,
            pkv_pos=pkv_pos, buf_len=torch.zeros_like(ones), pending=pend,
            pending_len=ones.clone(), seq_len=torch.full_like(ones, s0 + 1),
            ext_tokens=ext_tokens, ext_feats=ext_feats, ext_len=ones.clone(),
            pkv_blocks=(torch.full((b, cfg.num_layers, cfg.num_kv_heads,
                                    self._ns_blocks), -1, dtype=torch.int32,
                                   device=dev) if self.is_attn
                        else torch.zeros((b, 0, 0, 0), dtype=torch.int32,
                                         device=dev)))

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
        (the greedy body of the reference's ``_step_fused``)."""
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

    def step_fused(self, st: EngineState, rows: np.ndarray,
                   modes: np.ndarray) -> Tuple[EngineState, StepOutput]:
        """One fused multi-mode step.  The lock-step slice steps every row
        (``rows`` all True); per-slot row masking is ROADMAP.md queue 1,
        'Serving'.  Consumes `st`."""
        if not self.is_attn:
            raise ValueError("state archs step through step(st, 'state')")
        rows = np.asarray(rows, bool)
        if not rows.all():
            _unsupported("stepping a subset of rows", "Serving")
        modes = np.asarray(modes, np.int8)
        has_refresh = bool(np.any(modes == MODE_REFRESH))
        has_full = has_refresh or bool(np.any(modes == MODE_FULL))
        has_partial = bool(np.any(modes == MODE_PARTIAL))
        st, (toks, counts, acc) = self._step_fused(
            st, torch.as_tensor(modes, device=self.device),
            has_full=has_full, has_partial=has_partial,
            has_refresh=has_refresh)
        self.dispatches += 1
        if self.zero_copy and has_refresh:
            # pin the pages the refresh just routed; pin_slot_pages takes
            # the new references before dropping the previous refresh's,
            # so a page kept across refreshes never transiently frees
            al = self._page_alloc
            pbi_host = st.pkv_blocks.cpu().numpy()
            for i in np.nonzero(modes == MODE_REFRESH)[0]:
                i = int(i)
                blocks = np.unique(pbi_host[i][pbi_host[i] >= 0])
                nb = al.count(i)
                pages = [al.page_at(i, int(j)) for j in blocks if j < nb]
                if pages:
                    al.pin_slot_pages(i, pages)
        self._record_traffic_rows(modes, st)
        names = sorted({MODE_NAMES[int(m)] for m in modes})
        return st, StepOutput(tokens=toks.cpu().numpy(),
                              counts=counts.cpu().numpy(),
                              accept_len=acc.cpu().numpy(),
                              mode=names[0] if len(names) == 1 else "fused",
                              modes=modes)

    def step(self, st: EngineState, mode: str) -> Tuple[EngineState,
                                                        StepOutput]:
        """One lock-step round over the whole batch in `mode` ("state"
        for a state arch).  Consumes `st`."""
        if mode == "state":
            if self.is_attn:
                raise ValueError(mode)
            st, (toks, counts, acc) = self._step_state(st)
            self.dispatches += 1
            return st, StepOutput(tokens=toks.cpu().numpy(),
                                  counts=counts.cpu().numpy(),
                                  accept_len=acc.cpu().numpy(), mode=mode)
        if mode not in MODE_IDS:
            raise ValueError(mode)
        st, out = self.step_fused(
            st, np.ones((self.batch,), bool),
            np.full((self.batch,), MODE_IDS[mode], np.int8))
        if mode == "refresh":
            self._pkv_active = True
        return st, out

    def _record_traffic_rows(self, modes: np.ndarray, st: EngineState):
        for mid in (MODE_FULL, MODE_REFRESH, MODE_PARTIAL):
            sub = modes == mid
            if sub.any():
                self._record_traffic(MODE_NAMES[mid], st, sub)

    def _record_traffic(self, mode: str, st: EngineState,
                        rows: Optional[np.ndarray] = None):
        """Bytes of cache touched by the rows that stepped in `mode`:
        full/refresh bill the per-row sum of context, partial the budget
        plus buffer, a zero-copy refresh its routed rebuild."""
        cfg, spec = self.cfg, self.spec
        l_attn = cfg.num_layers
        itemsize = 2 if cfg.dtype == "bfloat16" else 4
        seq_len = st.seq_len.cpu().numpy()
        if rows is None:
            rows = np.ones((self.batch,), bool)
        nrows = int(np.sum(rows))
        if nrows == 0:
            return
        seq_sum = int(np.sum(seq_len[rows]))
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
        pending_max, seq_min = 1, int(st.seq_len.min())
        accepts: List[int] = []
        modes: List[str] = []
        steps = 0
        while min(len(o) for o in out) < max_new_tokens:
            mode = self.select_mode(pending_max, seq_min)
            st, so = self.step(st, mode)
            steps += 1
            modes.append(mode)
            accepts.extend(so.accept_len.tolist())
            for i in range(b):
                cnt = int(so.counts[i])
                out[i].extend(int(x) for x in so.tokens[i, :cnt])
            pending_max = int(st.pending_len.max())
            seq_min = int(st.seq_len.min())
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
