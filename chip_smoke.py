#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, in order (any failure raises and the script exits non-zero):

1. device check (CUDA, capability 9.0) and the kernels' build from the
   sources under src/repro_torch/csrc;
2. each CUDA kernel against its plain PyTorch version on the card at the
   shapes of its path (K1-K4 at llama3.1-8b: bf16, H=32, Hk=8, Dh=128,
   block 128; K5 at rwkv6-3b: fp32, H=40, dk=64), with its time, its
   plain version's time, the least time the card could take (bound)
   and, where one PyTorch call computes the same function, that call's
   time (SDPA over the gathered keys for the verify attention and the
   paged prefill, ``torch.aminmax`` for the block summaries).  K1 and K2
   run in bf16 on the tensor-core kernel (K1 split over the block list
   and merged in the same launch) and in fp32 on the CUDA-core kernel;
   a kernel's time is the device time of every kernel one wrapper call
   launches.  K4 runs in its paged form over all 32 layers (a prefill
   chunk and a Refresh commit, routed on the card through the page
   table), in its routed form and on one contiguous cache, each bit for
   bit equal to its plain version with the null page left at 0.  K3 is
   also checked at the edges of its tiles, for one
   launch per call and for equal bits from two calls; K5 at T on both
   sides of its 16-token tiles, and for the chain engine's invariant
   (a read-only T=6 verify gives the y of six one-token steps, an
   advance with a valid prefix the state of that many one-token steps,
   bit for bit).  The serving path's inputs are checked too: a batch-4
   K1 call mixing Full rows, a routed Partial row and an empty slot, a
   batch-4 K3 call over ragged block counts, and a K4 call in which one
   row has start = end and one is a neutral slot (bit for bit); and the
   shared-prefix path's: K2 chunks (T=256 and a short T=128) whose rows'
   page tables lead with the same 48 pages, and a batch-2 routed K1 call
   whose rows select pages they share;
3. greedy SpecPV ``generate`` of the paged zero-copy engine at the full
   width of llama3.1-8b (32 layers, random weights from a seed, batch 1,
   an 8192-token prompt, 128 new tokens), twice: eagerly over the first
   16 tokens (``cuda_graphs=False``; slices 20 and 22 cut it from 128) and with
   the step variants and the 256-token prefill chunk replayed as CUDA
   graphs (the default, the main path), whose first tokens must equal
   the eager run's.  For each
   run every kernel's launch count is set to 0 just before and read just
   after (K4 must run once per prefill chunk and once per commit, over
   every layer), the prefill is timed apart from decode (host clock
   after a synchronisation), and every layer's page summaries of the
   final cache are recomputed by the plain version and held to it bit
   for bit; then, for the graph run, 3 decode steps under
   ``torch.profiler`` (device time by kernel, idle share) and one forced
   Refresh step (K3's share of its device time; slice 20 cut the window
   from 6 steps and 2 Refresh steps); the eager run is not
   profiled (slice 18 cut its 26 s window) and the graph run's fresh
   prefill runs unprofiled (slice 19 cut it), to keep the smoke inside
   its budget.  After the eager
   run, one eager run of the prefill chunk's and of each step variant's
   body under ``torch.cuda.set_sync_debug_mode("error")`` (no body may
   wait for the card or read from the host);
4. losslessness at full width, 4 layers, fp32 (TF32 off): ``generate``
   with full verification, replayed as graphs, equals the port's
   autoregressive decoding token for token, then a partial-verification
   run with graphs equals the same run done eagerly;
5. the state-architecture path: greedy chain-speculation ``generate`` of
   rwkv6-3b at full width (32 layers, d 2560, bf16, random weights,
   batch 1, an 8192-token prompt, 128 new tokens), eagerly over the
   first 16 tokens (slices 21, 22 cut it from 128) and with graphs (the graph
   run's first tokens equal the eager run's), with the launch counts set to 0
   just before and read just after each (the WKV kernel must run 32 x
   (prefill chunks + 2 x steps) times), a profiled window of its steps
   (6 with graphs, 3 eager) and, with graphs, a profiled prefill, the
   bodies under the sync check, and fp32 losslessness at
   4 layers with graphs (``generate`` equals the port's autoregressive
   decoding);
6. continuous-batching serving of llama3.1-8b at full width
   (``ServingEngine``, batch 4, a 161-page pool, six requests of 2048 to
   8192 prompt tokens arriving together, prefix sharing off so that the
   cell stays the one of its first runs), with graphs, then the two
   shortest prompts again (8 and 16 new tokens) with graphs and eagerly
   (equal tokens and launch counts), the launch counts set to 0 just before and
   read just after each run and held to what its steps' variants and
   prefill chunks imply; page stalls, mixed-mode ticks and a drained pool
   asserted; each request alone through batch-1 ``generate`` (matches
   reported); a profiled window of batch-4 Partial ticks; the serving
   bodies under the sync check; fp32 losslessness at 4 layers (batch 2,
   interleaved prefill with the serial pump: every request equals its
   solo ``generate`` and a
   blocking run);
7. serving with shared prefixes (the traffic of ``bench_serving.py
   --prefix-share``): llama3.1-8b at full width, batch 4, a 129-page
   pool, nine requests arriving together, each one of two 6144-token
   system prompts plus its own 500-token tail (the ninth repeats the
   first), 32 new tokens each, served with graphs with copy-on-write
   prefix sharing and without it in the same call: tokens/s, time to
   first token, latency, prompt tokens skipped, prefix counters, page
   stalls and high water, peak memory, launches held to the steps and
   prefill chunks (short chunks included); sharing must skip at least
   36864 prompt tokens, decode four requests at once where the unshared
   run decodes at most two, stall less, and leave no committed page or
   pin.  Then a fork at full width, with graphs and eagerly: the fork
   gives the source's tokens, the source those of a run with no fork,
   the pre-step copy-on-write copies pages in both pools bit for bit and
   under the sync check, and no page the two rows still share is written
   after the fork.  Then fp32 losslessness at 4 layers (batch 4, two
   1536-token system prompts, six requests, interleaved prefill with the
   serial pump so that
   paired cursors dedup): every request equals its solo ``generate`` and
   its tokens with sharing off;
8. the reference's default engine, ``SpecPVEngine(paged=False,
   zero_copy=False)``: the contiguous KV cache and the gathered partial
   cache.  (c) The new call forms against their plain versions, timed:
   K1 over a contiguous cache through the identity list (Full T=61 and
   Refresh T=156 at 8229 tokens) and over the gathered body, K2 over the
   contiguous cache, and K4's all-layer contiguous form at a max_len of
   8431 (not a multiple of the block), bit for bit.  (a) Full-width
   ``generate`` as in phase 3 on the contiguous engine, with graphs (128
   new tokens, profiled) and eagerly (16 new tokens, a Refresh then
   Partial steps, not profiled: phase 3 profiles the eager step): K1-K4
   launched as each run's steps and chunks imply (K4 once per prefill
   chunk and per commit over every layer), the eager tokens equal to the
   graph run's first 16, final summaries equal to the plain version, the
   bodies under the sync check; the tokens matching phase 3's are
   reported.  (b) After the same prefill the
   contiguous K/V and summaries equal the paged engine's through the
   page table bit for bit; after one Refresh each, the gathered body's
   K1 Partial result equals the routed one bit for bit.  (e) The
   reference's ``ServingConfig()`` (contiguous slots, gathered body,
   blocking admission) over phase 6's six requests at batch 4 with
   graphs, launches held to the steps and chunks, beside phase 6's
   numbers, and the serving bodies under the sync check.  (d) fp32 at 4
   layers with graphs: the contiguous gathered, paged gathered and paged
   gathered-view (``use_pallas=False``) engines give AR's tokens with
   full verification and phase 4's zero-copy tokens with partial
   verification; contiguous serving, blocking and interleaved, gives
   each request's solo ``generate``;
9. the fused multi-row prefill, ``ServingConfig.fused_prefill=True``
   (the reference's default): K2 over a ragged [4, 256] chunk of four
   rows (t_valid 256, 16, 200, 1) on the contiguous prefill carry and K4
   over 32 layers with per-row ends length + t_valid, against their
   plain versions (K4 bit for bit), timed.  (a) Phase 6's six prompts
   (8 or 16 new tokens each: the phase measures the prefill pump)
   interleaved (``prefill_budget=1024``: up to four rows per round) with
   graphs on the paged pool with the serial and the fused pump and on
   contiguous slots fused: tokens/s, time to first token, latency,
   device ms per prefill round by (rows, width), tick wall with and
   without a prefill round, prefill dispatches per tick, peak memory,
   launches held to the rounds, bf16 tokens equal to the serial run's
   (reported); one 4-row round profiled (device launches, host launch
   calls).  (b) Phase 7's shared-prefix traffic, interleaved and fused
   with sharing on: dedupes, prompt tokens skipped, round walls, no
   committed page or pin left.  (c) A short trace (three prompts of
   1024, 768 and 512 tokens arriving together, 8 new tokens each) on the
   paged pool with the fused pump, with graphs and eagerly: tokens,
   launches and rounds equal; an eager 3-row round with a padded short
   row under the sync check.  (d) fp32 at 4 layers
   with graphs: the fused pump on the paged pool with sharing (paired
   cold admissions dedupe) and on contiguous slots gives every request's
   solo ``generate`` and the serial pump's tokens;
10. training and the paper's table 1 on the card.  (a) The EAGLE-3 draft
   trained at full width (``DraftTrainer``, the paper's ``DraftConfig()``,
   TTT steps 4) against the frozen 32-layer llama3.1-8b target (bf16,
   random weights), batch 1, S = 2048 (cut from the paper's 32K): one
   warm-up and five timed steps, ms per step split into the feature pass
   (one prefill of the whole sequence: 32 K2 launches and one K4), the
   TTT loss with its backward, and clip plus AdamW (CUDA events); peak
   memory; finite losses; the feature pass against its plain route: at
   each of the 32 layers, on the plain route's hidden state entering it,
   K2's partials within 1e-4 of the plain attention's and K4's summaries
   bit-equal (the bf16 layer outputs and the whole pass's features are
   reported beside the plain route's, not held).  (b) ``Trainer`` at llama3.1-8b width cut to 4 layers (the
   AdamW state of 32 does not fit), batch 1, S = 2048: forward plus
   backward, clip plus AdamW, peak memory, finite losses.  (c) The
   reference recipe's tiny-dense pair trained on the card in fp32 (its
   wall time), then ``benchmarks/bench_table1_speedup_torch.py --quick``
   over it (contexts 192 and 384, EAGLE3-full, SpecPV-64, SpecPV-128, 32
   new tokens, graphs): the compiled AR equals the plain AR oracle,
   EAGLE3-full equals AR, ``mean_accept`` > 1 in every SpecPV row;
   alpha_wall, fwd_reduction, tau and agreement printed with
   PYTHONHASHSEED.  K1-K4 are counted over the phase.  (Phase 2 holds
   this slice's call forms: K1, K2, K3 and K4 at the pair's shapes, H=4,
   Hk=2, Dh=64, block 16, in fp32 and bf16, and K2 at T=2048 at llama
   widths, each timed beside its bound and SDPA);
11. sampled serving (slice 12).  (a) llama3.1-8b at full width (32
   layers, bf16, random weights from seed 0), ``ServingConfig()``'s
   layout (contiguous slots, gathered body), batch 4, phase 6's six
   prompts (half its new tokens) in the arms of ``bench_serving.py
   --sampled``: greedy tree,
   sampled chain and sampled tree at temperature 0.8, and a mixed arm of
   all three kinds, each on a fresh scheduler of one server: tokens/s,
   mean accept by kind, tick wall by class, dispatches per tick (one per
   decode tick, asserted), launches held to the arm's step variants and
   chunks, each arm's variants keyed by its kinds, the graphs captured,
   capture_s and peak memory; then two profiled Partial ticks per arm
   (device ms, device launches, host launch calls; the kernels a sampled
   tick adds to a greedy one) over four slots of the three kinds, and
   each sampled or chain body under the sync check.
   (b) rwkv6-3b at full width, sampled chain ``generate`` (prompt 2048,
   cut from 8192; 16 new tokens), eagerly and with graphs: equal tokens
   and launch counts, K5 32 x (prefill chunks + 2 x steps), the sampled
   state body under the sync check.  (c) fp32 at 4 layers, TF32 off: a
   greedy request beside sampled tree and chain requests equals its
   tokens in an all-greedy batch, a sampled request gives the same tokens
   alone and admitted in another order, a fork of a sampled slot replays
   its source.  (d) When phase 10 ran in the process, on its trained
   tiny pair: tau greedy and at 0.8, and 256 sampled requests against
   the port's ``autoregressive_sample`` within the reference's two-sample
   bound.  K1-K4 must be launched in (a), K5 in (b);
12. one JSON line with every kernel's numbers (each kernel's launches
   from its own path's run, ``serving_launches`` from phase 6's,
   ``prefix_serving_launches`` from phase 7's shared run,
   ``contiguous_launches`` and ``contiguous_serving_launches`` from
   phase 8's graph runs, ``fused_serving_launches``,
   ``fused_contiguous_serving_launches`` and
   ``fused_prefix_serving_launches`` from phase 9's fused graph runs,
   ``training_launches`` from phase 10, ``sampled_serving_launches``
   from phase 11 (K1-K4 its (a), K5 its (b)), ``tiered_serving_launches``
   from phase 13 (b)'s tiered run, ``moe_launches`` and
   ``moe_serving_launches`` from phase 14, ``registry_launches`` from
   phase 15 (a)'s graph run, ``griffin_launches`` (0: no kernel is on
   that path) from phase 16 (a)'s, ``audio_launches`` and
   ``vlm_launches`` from phase 17 (a) and (b)'s graph runs,
   ``family_tensor_parallel_launches`` from phase 22 (a)'s four split
   runs; phases 8 and 9's call forms and phase 2's forms of this slice
   under ``shapes``),
   the card's name and power limit, and the final ``{"ok": true, ...}``
   line.  It comes last: phases 13-17 run before it;
13. tiered KV residency (slice 13), llama3.1-8b at full width (32
   layers, bf16, random weights from seed 0) on the gathered paged
   layout.  (a) Batch 1, the 8192-token prompt, a forced schedule
   (Refresh, three Partial steps with the prefetch issued before the
   third, Refresh on the prefetch hit, Refresh right after the
   demotion, Partial) untiered and with each codec (int8, fp8,
   lossless), every tier operation under the sync check: pages demoted
   and promoted, prefetch hits and synchronous promotes, host bytes, the
   device ms of gathering and quantizing, of each host-link copy (CUDA
   events on the engine's and the side stream) and of the restore, the
   host link's GB/s, and each step's wall; lossless tokens must equal
   the untiered ones, int8 and fp8 agreement is reported; then int8 on
   the zero-copy layout (pinned and demoted pages).  (b) Phase 6's six
   prompts (half its new tokens) at batch 4 (161 trunk pages, the draft
   pool at full size)
   untiered and tiered int8, with graphs: tokens/s, page stalls, peak
   active slots, tier deferrals, demoted pages, host bytes, peak memory,
   pages high water, the tiered run's K1-K4 launches held to its steps
   and chunks, bf16 tokens against the untiered run (reported).  (c)
   fp32 at 4 layers with graphs: served tiered lossless (every request
   demotes and promotes on a prefetch hit) equals served untiered and
   each request's solo ``generate``;
14. the MoE family (slice 14): granite-moe-1b-a400m at full width and
   depth (24 layers, 32 experts top-8, H 16 / Hk 8 / Dh 64, bf16, random
   weights from seed 0, the draft from seed 1).  (a) Phase 3's
   ``generate`` on the paged zero-copy pool (8192-token prompt, 128 new
   tokens) with graphs and eagerly over the first 16 tokens (slices 21
   and 22 cut it from 128): the eager tokens equal the graph run's first ones,
   K1-K4 launched as the steps and chunks imply, final summaries equal
   to the plain version, the graph run profiled (wall and device busy ms
   per step, idle share, host launch calls), the bodies under the sync
   check; on the eager engine the dropped (token, slot) pairs of a few
   verify steps and one profiled step split into K1-K4, the MoE's
   router, top-k, dispatch, expert GEMMs and combine, the other trunk
   GEMMs and the draft.  (c) ``ServingConfig()`` serving of phase 6's
   six requests at batch 4 with graphs (launches held to the steps and
   chunks, the serving bodies under the sync check; the shortest
   request against its solo ``generate`` reported: capacity binds at
   top-8, so a request's tokens depend on its batch).  (b) fp32 (TF32
   off) at full width and depth, a 1024-token prompt: ``generate`` with
   full verification and graphs equals the port's compiled AR decoding
   (``CompiledAR``), the plain AR oracle's agreement reported.  Phase 2
   holds K1-K4 at granite's heads to their plain versions, timed;
15. the rest of the dense registry (slice 15), bf16, random weights from
   seed 0 (the draft from seed 1), the paper spec.  (a) qwen2-0.5b at
   full width and depth (24 layers, 14/2 heads: 7 query heads per KV
   head, Dh 64, QKV bias, vocab 151936 tied): phase 3's ``generate`` on
   the paged zero-copy pool (8192-token prompt, 128 new tokens), with
   graphs and eagerly over the first 16: equal tokens, each run's
   launch counts held to its steps, K1-K4 launched as
   the steps and chunks imply, the graph run profiled (wall and device
   busy ms per step, idle share, host launch calls, tokens/s, peak
   memory).  (b) deepseek-7b at full width and depth (30 layers, 32/32
   heads, Dh 128, vocab 102400 untied): the same cell with graphs,
   eagerly over the first 16 tokens.  (c) granite-3-2b at full depth (40
   layers) and qwen1.5-32b at full width (40/40 heads with QKV bias,
   vocab 152064; all 64 layers if the weights, the pool and a margin fit
   the card's free memory, which is reckoned and printed first, else 48):
   a 2048-token prompt and 32 new tokens with graphs (Full verification:
   the prompt is under the 4480-token budget), launches held to the
   steps and chunks.  (d) qwen2-0.5b fp32 (TF32 off) at full width and
   depth, a 1024-token prompt, 32 new tokens: full verification with
   graphs equals the compiled AR.  (e) rwkv6-3b at full width cut to 4
   layers: one ``train_loss`` + backward at S = 512 in bf16 (the WKV
   recurrence as the plain chunked loop under autograd), finite non-zero
   loss and gradient norm, ms per step and peak memory.  (f) Each
   target's eager step bodies under the sync check.  Phase 2 holds K1-K4
   at qwen2-0.5b's and deepseek-7b's heads, K3 at qwen1.5-32b's and K4
   over its 64 layers to their plain versions, timed;
16. Griffin (slice 16): recurrentgemma-2b, the RG-LRU and rolling-window
   hybrid trunk, on which no kernel of the port runs (the reference's
   window attention is plain jnp and its RG-LRU a ``lax.scan``).  (a) At
   full width and depth (26 layers: 8 x (rec, rec, attn) + (rec, rec),
   d 2560, 10/1 heads of Dh 256, window 2048, bf16, random weights from
   seed 0, the draft from seed 1), batch 1, a 4096-token prompt (the
   window wraps twice), 64 new tokens: greedy chain ``generate`` with
   graphs and eagerly over the first 16, equal tokens, no kernel of the port launched, the
   window holding the last token; tokens/s with the captures, prefill
   and capture seconds, peak memory; a profiled window of 3 graph steps
   (device busy ms, the five largest kernels, device launches, host
   launch calls), the idle share without the profiler; one prefill chunk
   profiled (the RG-LRU step loop's share of it) and replayed; the eager
   bodies under the sync check; the fp32 copies of ``wa`` / ``wi`` that
   a pass makes, timed.  (b) fp32 (TF32 off), full width, 5 layers (a
   superblock and the remainder), random gates, a 2304-token prompt, 32
   new tokens: chain ``generate`` with graphs equals the port's
   autoregressive decoding.  (c) Wave serving of three requests (1024,
   1024 and 1536 prompt tokens, 16 new each, batch 2) at (b)'s model:
   each equals its solo ``generate``.  (d) One ``Trainer`` step at full
   width and 3 layers (rec, rec, attn), batch 1, S = 2560 (the window
   bites), after a warm-up step: ms per step, peak memory;
17. VLM and audio (slice 17): per-request conditioning (``extra``: stub
   image patch or audio frame embeddings from a seeded generator) on the
   paged zero-copy pool with prefix sharing off (it cannot key
   ``extra``), random weights from seeds, the VLM's cross-attention
   gates drawn in [0.3, 0.7] (the reference's 0 makes a ``cross`` layer
   the identity).  (a) whisper-small at full width and depth (12
   encoder and 12 decoder layers, d 768, 12/12 heads of Dh 64, 1500
   frames, vocab 51865 tied, bf16), batch 1, an 8192-token prompt (the
   registry's rope stands in for Whisper's 448 learned positions), 128
   new tokens: ``generate(extra=)`` with graphs and eagerly over the
   first 16 (equal tokens), K1-K4 launched as each run's steps and
   chunks imply over the 12 attention layers, final summaries against the
   plain version, the graph run profiled (device busy ms and launches
   per step, host launch calls, idle share with and without the
   profiler, tokens/s, prefill s, peak memory), the request's encoding
   timed (the encoder and every cross layer's K/V, CUDA events), the
   eager bodies under the sync check.  (b) llama-3.2-vision-90b at full
   width (d 8192, 64/8 heads, d_ff 28672, vocab 128256 untied, 1600
   image tokens of width 1280) at the deepest whole number of (attn x4,
   cross) superblocks whose reckoned memory leaves 6 GiB of the card
   free (printed first): the same cell with graphs, K1-K4 over its
   attention layers, then an eager engine's bodies under the sync
   check.  (c) fp32, TF32 off, a 2304-token prompt, 32 new tokens, the
   partial budget cut to 1408 tokens: whisper-small at full depth and
   the VLM at full width with 5 layers; full verification with graphs
   equals ``autoregressive_generate(extra=)``, partial verification with
   graphs equals its eager run (agreement with AR reported), another
   ``extra`` moves the first token's logits.  (d) whisper-small fp32:
   three requests with their own frames admitted with
   ``prefill_into_slot(extra=)`` at batch 3 (the third while the first
   two decode) and stepped with ``step_fused`` to the end, with graphs,
   each equal to its solo ``generate(extra=)``.  Phase 2 holds K1-K4 at
   both models' heads to their plain versions, timed;
18. windowed dense stacks and context-parallel verification (slice 18).
   (a) llama3.1-8b at full width with ``window_size=4096`` (set by
   ``replace``), an 8192-token prompt, 48 new tokens, on the paged
   zero-copy pool: ``generate`` with graphs and eagerly (16 tokens, the
   graph run's first; launch counts held to each run's steps and
   chunks: K2 none, the
   windowed prefill being the reference's plain chunked attention;
   decode attends the whole context, as the reference's), tokens/s,
   prefill s, a profiled window of steps (device ms per step); in fp32
   at 5 layers (a 6144-token prompt) full verification with graphs
   equals the compiled AR decoding.  (b) Two ranks spawned with
   ``torch.distributed`` (gloo, both on the one card, the all-reduces
   staged through the host; NCCL, one rank per card, where there are
   two cards), each holding a contiguous half of the reference's case
   D1 (deepseek-7b's heads 32/32 of Dh 128, bf16, B = 1, T = 8, 524288
   tokens, ``SpecPVConfig()``: block 128, budget 32): each rank's
   ``cp_full_verify_attention`` and ``cp_partial_verify_attention``
   (K1's contiguous form at its shard offset, K3 over its summaries and
   K1's block-list form over its selection, one merge of the partials),
   the launch counts set to 0 just before and read just after; every
   rank bit-equal to rank 0; Full against K1's unsharded contiguous form
   over all 524288 tokens (3e-2) and, at 32768 tokens in fp32, (1e-4);
   Partial and its selections against the single-process form on the
   same shards; per rank the kernels' device ms (CUDA events) and the
   merge's all-reduce ms; the call forms against their plain versions,
   timed beside SDPA over the same keys; the traffic model at this
   shape;
19. the launch steps and the int8 resident decode cache (slice 19).  (a)
   ``repro_torch.launch.steps`` at the full width of llama3.1-8b (32
   layers, bf16, batch 1, ``SpecPVConfig()``): one ``make_prefill_step``
   call over an 8192-token prompt (K2, K4), 16 ``make_decode_step`` full
   steps (K1, K4) eagerly, each under the sync check, then replayed
   as a CUDA graph from the same state (equal tokens), one
   ``decode(select_partial=True)`` (K1, K3; its token committed, K4) and
   16 partial steps over its selection (no kernel: the reference's plain
   per-head attention) both ways; 8 state steps of rwkv6-3b at full
   width both ways (K5 twice per layer and step); one ``make_train_step``
   at 4 layers of llama width; the launch counts set to 0 just before
   and read just after each part and held to it.  (b) every case of
   ``launch.hillclimb.CASES`` (granite-3-2b verify steps at batch 8 over
   32768 tokens, full, partial and partial with an int8 partial cache;
   qwen1.5-32b int8 decode over 32768 tokens; deepseek-7b int8 partial
   decode at 524288 tokens; deepseek-7b context-parallel retrieval over
   one 524288-token layer), built at the reference's shapes with the
   cuts one card forces listed in its ``reduced``: 4 steps eagerly (each
   under the sync check) and as a CUDA graph from the same state,
   equal bit for bit, peak and state bytes and ms per step both ways;
   qwen1.5-32b's int8 read of one layer within 3e-2 of K1 over the same
   layer dequantised to bf16; the int8 partial cache's bonus tokens
   reported against the bf16 one's; each case freed and the cyclic
   collector run before the next.  (c) fp32 (TF32 off) at 4 layers: a
   prefill step and 31 full decode steps equal the port's AR oracle;
20. data-parallel serving (slice 20): ``SpecPVEngine(mesh=...)`` over a
   (2, 1) mesh whose two data shards are both ``cuda:0``, so each shard's
   rows, its half of the page pools and its CUDA graphs are its own and
   the weights one copy.  (a) llama3.1-8b at full width (bf16, random
   weights from seed 0, the draft from 1): phase 6's six requests at
   batch 4 (2 rows a shard) over its 161 pages (79 and 81 a shard),
   blocking admission, graphs: tokens/s, p50/p95 latency, each shard's
   step span per tick (CUDA events around its launch), tick wall by
   class, page stalls, captures per shard, ``peak_pages_per_host`` and
   each shard's high water against its capacity, peak memory; each
   shard's K1-K4 launches (set to 0 just before, read just after) held
   to what its own steps and chunks imply, every kernel launched on
   each shard; the bf16 agreement with phase 6's unsharded tokens when
   phase 6 ran (reported, not asserted).  (b) fp32 (TF32 off), full
   width, 2 layers, prefix sharing on: four requests (two over the
   partial budget) served on the (2, 1) mesh equal the unsharded
   engine's tokens; each shard's high water within its range; a fork
   within a shard shares its pages and one across shards raises.  (c)
   ``ServingConfig(mesh_shape=(2, 1))`` on a card count that cannot
   fill it serves unsharded, as the reference;
21. tensor parallelism (slice 21): ``SpecPVEngine(mesh=...)`` over a
   (1, 2) mesh whose two model shards are both ``cuda:0``: each shard
   holds whole query and KV heads (16 / 4 of llama's 32 / 8), half the
   MLP and half the vocabulary, its weights views of the given ones, and
   its K/V pools and summaries at Hk 4, stacked on the layer axis.  (c)
   K1 Full and routed, K2, K3 and K4 (over both shards' 64 stacked
   layers) at H 16 / Hk 4 / Dh 128 against their plain versions (K4 bit
   for bit), timed beside their bounds.  (a) llama3.1-8b at full width,
   all 32 layers, bf16: phase 3's paged zero-copy ``generate`` over its
   8192-token prompt with graphs, its launches (set to 0 just before,
   read just after) held to twice phase 3's per layer for K1-K3 and to
   one K4 launch per chunk and commit, every K1-K4 call at H 16 / Hk 4,
   the graph set and final summaries as phase 3's, a profiled window of
   3 steps, a forced Refresh and a forced Full step, the collectives'
   device ms on eager steps, peak memory, and the bf16 tokens and step
   time beside phase 3's (reported).  (b) fp32 (TF32 off), full width,
   2 layers: ``generate`` on (1, 2) equals the unsharded engine's tokens,
   and a (2, 2) mesh of four ``cuda:0`` shards serves phase 20's fp32
   trace with the unsharded engine's tokens;
22. every model family under a mesh (slice 22): the state and
   cross-attention targets on (1, 2) meshes of two ``cuda:0`` model
   shards (RWKV-6's time mixing by heads with K5 at H 20 per shard over
   its slice of the stacked ``wkv`` state and the channel mixing by
   columns; Griffin's recurrent blocks by columns, one gather of the
   conv output for the dense gates, the MLPs split, the one-KV-head
   local attention whole; the cross layers by heads over stacked cross
   rows, the encoder and projector whole) and on (2, 1) meshes of two
   data shards.  (c) K5 at H 20 (verify T=6, prefill T=256, advance
   T=6) and K1-K4 at whisper-small's (6 / 6 / 64) and the VLM's (32 / 4
   / 128) shard heads against their plain versions, timed beside their
   bounds.  (a) rwkv6-3b, recurrentgemma-2b and whisper-small at full
   width and depth with their phases' weights and prompts, and
   llama-3.2-vision-90b at full width and 10 layers (beside its own
   unsharded run there), each a 32-token ``generate`` with graphs: the
   launches held to twice the unsharded per-layer counts (K5 all at H
   20, K1-K3 at the shard's heads, one K4 per chunk and commit), one
   graph per step variant, one host launch call per graph replay and
   its copies (2 a state step, 3 an attention step), a profiled window,
   the collectives' device ms on an eager step, peak memory, and the
   bf16 tokens and step numbers beside phases 5, 16 and 17's
   (reported).  (b) fp32 (TF32 off), full width, 2 layers (Griffin 3):
   each family's (1, 2) ``generate`` equals the unsharded engine's
   tokens; on (2, 1), rwkv6-3b's wave serving and whisper-small's slot
   serving with per-request ``extra`` equal each request's solo
   ``generate``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# the port must stand without JAX and the JAX package: make both unimportable
sys.modules["jax"] = None
sys.modules["repro"] = None

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_BF16_S = 989e12            # dense bf16 tensor-core rate
PEAK_FP32_S = 67e12             # fp32 outside the tensor cores
# kernel against its plain version: both widen the same inputs to fp32,
# so they differ only by summation order (~1e-6 relative); 1e-4 of each
# tensor's largest magnitude fails a missing 32-key tile (~0.7% of l)
TOL_KERNEL = 1e-4
PROMPT_LEN = 8192               # phase 3: the paper's long-context regime
NEW_TOKENS = 128
PHASE3_EAGER_NEW = 16           # phase 3's eager run: a Refresh, then Partial
RWKV_EAGER_NEW = 16             # phase 5's eager run (slices 21, 22 cut it)
# the prompt the sync checks prefill before the eager bodies run (the
# bodies force their modes, so a short context serves)
SYNC_CHECK_PROMPT = 1024
PROFILE_STEPS = 3               # the graph runs' profiled decode window
REFRESH_PROFILE_STEPS = 1       # forced Refresh steps profiled after it
# spin before each timed call (~2 ms at the H100's clock): the host
# enqueues the call's Python work while the card spins, so the event
# window holds device time only
COVER_CYCLES = 4_000_000

KERNEL_META = {
    "sparse_verify_attention": dict(
        source="src/repro_torch/csrc/block_attention.cu",
        replaces="src/repro/kernels/sparse_attention.py:69"),
    "paged_prefill_attention": dict(
        source="src/repro_torch/csrc/block_attention.cu",
        replaces="src/repro/kernels/prefill_attention.py:79"),
    "retrieval_score": dict(
        source="src/repro_torch/csrc/retrieval_score.cu",
        replaces="src/repro/kernels/retrieval_score.py:33"),
    "block_summary": dict(
        source="src/repro_torch/csrc/block_summary.cu",
        replaces="src/repro/kernels/block_summary.py:30"),
    "wkv": dict(
        source="src/repro_torch/csrc/wkv_scan.cu",
        replaces="src/repro/kernels/wkv_scan.py:66"),
}
# the kernels each full-width path must launch
LLAMA_KERNELS = ("sparse_verify_attention", "paged_prefill_attention",
                 "retrieval_score", "block_summary")
RWKV_KERNELS = ("wkv",)
# K5's calls on the rwkv6-3b path, by their ops.WKV_SHAPES key (T, update)
WKV_PATH_SHAPES = {(256, True): "prefill T=256", (6, False): "verify T=6",
                   (6, True): "advance T=6"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


class Timer:
    """Device time of one call, averaged over ``iters`` calls.  Before
    each call the 50 MB L2 is flushed (the main path meets every layer's
    pool cold) and the card spins for ``COVER_CYCLES``; the CUDA-event
    window opens after the spin, by which time the host has enqueued the
    call, so the window holds device time and no host time.  A call
    whose host work outlasts the spin would let host time in: it is
    dropped and redone behind a spin twice as long.

    ``kernel_ms`` reads the device time of one call, summed over every
    kernel the call launches, from ``torch.profiler`` (CUPTI) over the
    same flushed calls."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
        self.per_call = 0        # kernels the last ``kernel_ms`` call saw
        self.source = ""         # where its time came from

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total, done, cycles = 0.0, 0, COVER_CYCLES
        while done < iters:
            self.flush.zero_()
            ec = torch.cuda.Event(enable_timing=True)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            ec.record()
            torch.cuda._sleep(cycles)
            e0.record()
            h0 = time.perf_counter()
            fn()
            host_ms = (time.perf_counter() - h0) * 1e3
            e1.record()
            e1.synchronize()
            if host_ms >= ec.elapsed_time(e0):
                # host time may be in this window: drop it, spin longer
                if cycles >= 64 * COVER_CYCLES:
                    raise RuntimeError(
                        f"host work {host_ms:.3f} ms outlasts the spin "
                        f"{ec.elapsed_time(e0):.3f} ms")
                cycles *= 2
                continue
            total += e0.elapsed_time(e1)
            done += 1
        return total / iters

    def wall(self, fn, iters: int = 3, warmup: int = 1) -> float:
        """CUDA-event time of one call with no spin in front: for a call
        of more launches than the card's launch queue holds (the host
        then waits on the spin), so the window holds host time too."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
        return total / iters

    def kernel_ms(self, fn, kernel: str, iters: int = 10) -> float:
        """Device time of one call of ``fn``: the durations of all the
        kernels whose names contain ``kernel`` that the call launches
        (an attention kernel and any merge kernel alike), summed.  If the
        profiler keeps no record of them in three tries (it has dropped
        every record of a 40 us kernel after many earlier profiled
        windows), the time is the call's CUDA-event time (``__call__``)
        and the launches per call are those the wrappers counted."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels import ops
        torch = self.torch
        counted = sum(ops.LAUNCHES.values())
        fn()
        torch.cuda.synchronize()
        counted = sum(ops.LAUNCHES.values()) - counted
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA
                    and kernel in e.key]
            count = sum(e.count for e in rows)
            if count and count % iters == 0:
                break
        if count == 0:
            if counted == 0:
                raise RuntimeError(f"no launch of {kernel}: the profiler saw "
                                   f"none and the wrappers counted none")
            self.per_call, self.source = counted, "events"
            ms = self(fn)
            print(f"note: profiler kept no launch of {kernel}; ms {ms:.4f} "
                  f"is the CUDA-event time of a call ({counted} counted "
                  f"launch(es) per call)", flush=True)
            return ms
        # the profiler has been seen to drop records of ~10 us kernels;
        # after three tries the mean over the records it kept is used
        per_call = -(-count // iters)
        self.per_call, self.source = per_call, "profiler"
        if count != per_call * iters:
            print(f"note: profiler kept {count} of {per_call * iters} "
                  f"launches of {kernel}; ms is their mean x {per_call}",
                  flush=True)
        return sum(_dev_us(e) for e in rows) / count * per_call / 1e3


def _close(label, got, want, tol=TOL_KERNEL):
    """|got - want| <= tol * (|want| + max |want|), over the entries that
    are not the masked sentinel -1e30, which must match exactly.
    Returns the largest relative error (to max |want|)."""
    import torch
    masked = want <= -1e29
    if not torch.equal(got[masked], want[masked]):
        raise AssertionError(f"{label}: masked entries differ")
    g, w = got[~masked], want[~masked]
    if w.numel() == 0:
        return 0.0
    scale = w.abs().max().clamp(min=1e-30)
    diff = (g - w).abs()
    if not bool(torch.all(diff <= tol * (w.abs() + scale))):
        raise AssertionError(
            f"{label}: kernel disagrees with its plain version, max abs err "
            f"{diff.max().item():.3e}, max |want| {scale.item():.3e}")
    return (diff.max() / scale).item()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _attn_case(torch, gen, *, t, ctx, routed_ns=0, causal_qoff=None,
               dtype=None, h=32, hk=8, dh=128):
    """Inputs of one K1/K2 call at llama3.1-8b shapes (or the heads
    given).  Returns the kernel's argument tuple plus the work counts
    for the bound."""
    bs = 128
    dtype = dtype or torch.bfloat16
    nb = -(-ctx // bs)
    np_ = nb + 2
    dev = "cuda"
    q = torch.randn((1, t, h, dh), generator=gen, device=dev).to(dtype)
    pool_k = torch.randn((np_, bs, hk, dh), generator=gen, device=dev).to(dtype)
    pool_v = torch.randn((np_, bs, hk, dh), generator=gen, device=dev).to(dtype)
    table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:nb] + 1)
    table = table.to(torch.int32)[None]                       # [1, NB]
    if routed_ns:
        # zero-copy partial: NS selected logical blocks per head, the last
        # few slots unused (-1), the last valid block ragged
        sel = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)
                           [:routed_ns] for _ in range(hk)])[None]
        sel[..., -3:] = -1
        sel[..., routed_ns - 4] = nb - 1
        length = torch.tensor([ctx], device=dev)
        used = sel >= 0
        idx = torch.where(used, table[0][sel.clamp(min=0)], 0)
        vlen = torch.where(used, (length[:, None, None] - sel * bs)
                           .clamp(0, bs), 0)
        qoff = None
    else:
        end = torch.tensor([ctx], device=dev)
        vl = (end[:, None] - torch.arange(nb, device=dev)[None] * bs).clamp(0, bs)
        idx = torch.where(vl > 0, table, 0)[:, None].expand(1, hk, nb)
        vlen = vl[:, None].expand(1, hk, nb)
        qoff = (torch.tensor([causal_qoff], device=dev, dtype=torch.int32)
                if causal_qoff is not None else None)
    idx = idx.to(torch.int32).contiguous()
    vlen = vlen.to(torch.int32).contiguous()
    kf = pool_k.reshape(np_ * bs, hk, dh)
    vf = pool_v.reshape(np_ * bs, hk, dh)
    # work: valid (query row, key) pairs, and the distinct KV bytes read
    keys = vlen.sum().item()                  # summed over KV heads
    rep = h // hk
    if qoff is None:
        pairs = keys * rep * t
    else:
        # key at absolute position p is seen by queries qoff+i >= p
        kpos = torch.arange(ctx, device=dev)
        qpos = causal_qoff + torch.arange(t, device=dev)
        pairs = int((kpos[None] <= qpos[:, None]).sum().item()) * hk * rep
    isz = q.element_size()
    nbytes = (q.numel() * isz + 2 * keys * dh * isz
              + 2 * idx.numel() * 4 + (2 + dh) * h * t * 4)
    flops = 4 * pairs * dh
    return (q, kf, vf, idx, vlen, bs, qoff), nbytes, flops, table, pool_k, pool_v


def _bound_ms(nbytes, flops, peak_ops):
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = flops / peak_ops * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _attn_row(torch, card, timer, label, launch, plain, nbytes=None,
              flops=None, library=None, peak=PEAK_BF16_S):
    """A K1/K2 call held to its plain version at TOL_KERNEL (m, l, acc and
    the normalised output); with ``library`` also its profiler time (at
    most 2 launches per call), plain time, bound (operations at ``peak``:
    the bf16 tensor-core rate, or the fp32 rate for the fp32 route) and
    SDPA time.  Returns the row."""
    from repro_torch.kernels import ops
    got, want = launch(), plain()
    torch.cuda.synchronize()
    out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
    out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
    rel = max(_close(f"{label} {nm}", g, w) for nm, g, w in
              (("m", got[0], want[0]), ("l", got[1], want[1]),
               ("acc", got[2], want[2]), ("out", out_g, out_w)))
    err = max((out_g - out_w).abs().max().item(),
              (got[0] - want[0]).abs().max().item())
    check = (f"kernel {label}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
             f"(tol {TOL_KERNEL} of max |plain| on m, l, acc, out)")
    if library is None:
        say(card, check)
        return dict(max_abs_err=err)
    before = dict(ops.LAUNCHES)
    ms = timer.kernel_ms(launch, "block_attention")
    if timer.per_call > 2:
        raise AssertionError(f"{label}: {timer.per_call} launches per call, "
                             f"at most 2 allowed")
    ops.LAUNCHES.update(before)        # timing launches are not the path's
    plain_ms = timer(plain, iters=3, warmup=1)
    lib_ms = timer(library)
    bound, by = _bound_ms(nbytes, flops, peak)
    say(card, f"{check} ms {ms:.4f} ({timer.source}, {timer.per_call} "
              f"launch(es) per call) plain_ms {plain_ms:.4f} bound_us "
              f"{bound * 1e3:.2f} ({by}) library_ms {lib_ms:.4f} (SDPA)")
    return dict(max_abs_err=err, ms=ms, timing=timer.source,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def _attn_check(torch, card, timer, gen, results, label, name,
                primary=False, timed=True, **kw):
    """One K1/K2 case (``_attn_case``'s keywords) held to its plain
    version; a timed case also gets its kernel, plain, bound and SDPA
    times.  The row goes to ``results[name]`` (the first, or the
    ``primary`` one; every case's error is kept)."""
    from repro_torch.kernels import ops, ref
    import torch.nn.functional as F
    args, nbytes, flops, table, pool_k, pool_v = _attn_case(torch, gen, **kw)
    q, kf, vf, idx, vlen, bs, qoff = args

    def launch():
        return ops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=qoff)

    def plain():
        return ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                           q_offset=qoff)
    if not timed:
        err = _attn_row(torch, card, timer, label, launch,
                        plain)["max_abs_err"]
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        return
    # the yardstick: one torch SDPA call over the gathered keys with the
    # same mask (GQA: the query heads of a KV head share it)
    qh = q.transpose(1, 2)
    hk_, dh_ = kf.shape[1:]
    if kw.get("routed_ns"):
        # per-head routed blocks, masked to their valid lengths
        hsel = torch.arange(hk_, device="cuda")[:, None]
        ids = idx[0].long()                                  # [Hk, NS]
        kh_ = pool_k.permute(2, 0, 1, 3)[hsel, ids].reshape(1, hk_, -1, dh_)
        vh_ = pool_v.permute(2, 0, 1, 3)[hsel, ids].reshape(1, hk_, -1, dh_)
        valid = (torch.arange(bs, device="cuda")[None, None]
                 < vlen[0][..., None]).reshape(hk_, -1)
        mask = valid.repeat_interleave(q.shape[2] // hk_, 0)[None, :, None]
    else:
        ctx = kw["ctx"]
        kh_ = pool_k[table[0].long()].reshape(1, -1, hk_, dh_)[:, :ctx] \
            .transpose(1, 2)
        vh_ = pool_v[table[0].long()].reshape(1, -1, hk_, dh_)[:, :ctx] \
            .transpose(1, 2)
        mask = None
        if qoff is not None:
            qpos = kw["causal_qoff"] + torch.arange(q.shape[1],
                                                    device="cuda")
            mask = torch.arange(ctx, device="cuda")[None] <= qpos[:, None]
    row = _attn_row(torch, card, timer, label, launch, plain, nbytes,
                    flops, lambda: F.scaled_dot_product_attention(
                        qh, kh_, vh_, attn_mask=mask, enable_gqa=True))
    prev = results.get(name)
    if prev is None or primary:
        if prev is not None:
            row["max_abs_err"] = max(row["max_abs_err"], prev["max_abs_err"])
        results[name] = row
    else:
        prev["max_abs_err"] = max(prev["max_abs_err"], row["max_abs_err"])


def phase_kernels(torch, card, timer):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    results = {}

    def attn_check(label, name, primary=False, timed=True, **kw):
        _attn_check(torch, card, timer, gen, results, label, name,
                    primary=primary, timed=timed, **kw)

    k1 = "sparse_verify_attention"
    attn_check("K1 full T=61 ctx=8229", k1, t=61, ctx=8229)
    attn_check("K1 refresh T=156 ctx=8229", k1, t=156, ctx=8229)
    attn_check("K1 routed NS=35 T=61", k1, t=61, ctx=8229, routed_ns=35,
               primary=True)
    k2 = "paged_prefill_attention"
    attn_check("K2 prefill T=256 qoff=0", k2, t=256, ctx=256, causal_qoff=0)
    attn_check("K2 prefill T=256 qoff=7936", k2, t=256, ctx=8192,
               causal_qoff=7936, primary=True)
    # the fp32 route (CUDA cores), checked only: it runs in the fp32
    # losslessness phase, not on the bf16 path
    f32 = torch.float32
    attn_check("K1 routed NS=35 T=61 fp32", k1, t=61, ctx=8229, routed_ns=35,
               dtype=f32, timed=False)
    attn_check("K1 full T=1 ctx=8229 fp32", k1, t=1, ctx=8229, dtype=f32,
               timed=False)
    attn_check("K2 prefill T=256 qoff=7936 fp32", k2, t=256, ctx=8192,
               causal_qoff=7936, dtype=f32, timed=False)

    results["retrieval_score"] = _score_checks(torch, card, timer, gen)
    results["block_summary"] = _summary_checks(torch, card, timer, gen)
    results["wkv"] = _wkv_checks(torch, card, timer, gen)
    err_k1, err_k3 = _serving_kernel_cases(torch, card, gen)
    results[k1]["max_abs_err"] = max(results[k1]["max_abs_err"], err_k1)
    results["retrieval_score"]["max_abs_err"] = max(
        results["retrieval_score"]["max_abs_err"], err_k3)
    err_k1, err_k2 = _prefix_kernel_cases(torch, card, gen)
    results[k1]["max_abs_err"] = max(results[k1]["max_abs_err"], err_k1)
    results[k2]["max_abs_err"] = max(results[k2]["max_abs_err"], err_k2)
    return results


def _shared_tables(torch, gen, np_, nb, shared):
    """Two rows' page tables [2, nb] whose first `shared` entries are the
    same pages (a prefix attached from the cache), the rest each row's
    own."""
    perm = (torch.randperm(np_ - 1, generator=gen, device="cuda") + 1).to(
        torch.int32)
    table = torch.stack([perm[:nb], perm[nb: 2 * nb]])
    table[1, :shared] = table[0, :shared]
    return table.contiguous()


def _prefix_kernel_cases(torch, card, gen):
    """The kernels' inputs on the shared-prefix path (phase 7), each
    against its plain version in bf16 and fp32: K2 prefill chunks whose
    two rows' page tables lead with the same 48 pages (a tail prefill
    after an attach: T=256 at qoff 6400 and 6144, and the short T=128
    chunk at qoff 6272 after a 49-block match), and a batch-2 routed K1
    call (T=61, NS=35) whose rows select pages they share.  Returns the
    largest abs error of (K1, K2)."""
    from repro_torch.kernels import ops, ref
    h, hk, dh, bs, nb = 32, 8, 128, 128, 66
    dev = "cuda"
    before = dict(ops.LAUNCHES)
    np_ = 2 * nb + 1
    errs = {"K1": 0.0, "K2": 0.0}

    def check(label, kind, q, kf, vf, idx, vlen, qoff=None):
        got = ops.block_attention(q, kf, vf, idx, vlen, bs, q_offset=qoff)
        want = ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                           q_offset=qoff)
        torch.cuda.synchronize()
        out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
        out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
        for nm, g, w in (("m", got[0], want[0]), ("l", got[1], want[1]),
                         ("acc", got[2], want[2]), ("out", out_g, out_w)):
            _close(f"{label} {nm}", g, w)
        errs[kind] = max(errs[kind], (out_g - out_w).abs().max().item(),
                         (got[0] - want[0]).abs().max().item())

    for dtype in (torch.bfloat16, torch.float32):
        pk = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        pv = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
        table = _shared_tables(torch, gen, np_, nb, 48)
        for t, qoffs in ((256, (6400, 6144)), (128, (6272, 6272))):
            qoff = torch.tensor(qoffs, dtype=torch.int32, device=dev)
            idx, vlen = ops._page_walk(table, qoff + t, pk.shape)
            q = torch.randn((2, t, h, dh), generator=gen,
                            device=dev).to(dtype)
            check(f"K2 shared prefix T={t} qoff={qoffs} {dtype}", "K2", q,
                  kf, vf, idx, vlen, qoff)
        # routed Partial rows over a 52-block context: most selected
        # blocks lie in the shared 48, so the rows read the same pages
        sel = torch.stack([torch.stack([
            torch.randperm(51, generator=gen, device=dev)[:35]
            for _ in range(hk)]) for _ in range(2)])       # [2, Hk, 35]
        sel[..., -3:] = -1
        sel[..., 30] = 51                              # ragged last block
        used = sel >= 0
        rows = torch.arange(2, device=dev)[:, None, None]
        idx = torch.where(used, table[rows, sel.clamp(min=0)], 0)
        vlen = torch.where(used, (6644 - sel * bs).clamp(0, bs), 0)
        idx, vlen = idx.to(torch.int32).contiguous(), vlen.to(
            torch.int32).contiguous()
        both = (idx[0][..., None] == idx[1][..., None, :]) & (idx[0] > 0)[
            ..., None]
        if not bool(both.any()):
            raise AssertionError("K1 shared case: the rows share no page")
        q = torch.randn((2, 61, h, dh), generator=gen, device=dev).to(dtype)
        check(f"K1 routed NS=35 over shared pages {dtype}", "K1", q, kf, vf,
              idx, vlen)
    say(card, f"kernel K2 over page tables leading with 48 shared pages "
              f"(T=256 qoff 6400/6144, T=128 qoff 6272) bf16 and fp32: "
              f"max_abs_err {errs['K2']:.3e}; K1 routed NS=35 T=61 over "
              f"pages both rows select: max_abs_err {errs['K1']:.3e} (tol "
              f"{TOL_KERNEL} of max |plain| on m, l, acc, out)")
    ops.LAUNCHES.update(before)
    return errs["K1"], errs["K2"]


def _serving_kernel_cases(torch, card, gen):
    """The kernels' inputs on the serving path (phase 6), each against
    its plain version: a batch-4 K1 call (T=61) whose rows mix two Full
    rows of ragged lengths, a routed Partial row and an empty slot (null
    page table, length 0), in bf16 and fp32; a batch-4 K3 call (T=156)
    over ragged block counts, an empty slot among them, two calls bit
    for bit; a K4 all-layers call over four rows of which one has start
    = end inside a block (it recomputes that block to the same bits) and
    one is a neutral slot (nothing written), bit for bit.  Returns the
    largest abs error of (K1, K3); K4's is 0."""
    from repro_torch.kernels import ops, ref
    h, hk, dh, bs, nb = 32, 8, 128, 128, 66
    dev = "cuda"
    before = dict(ops.LAUNCHES)
    np_ = 4 * nb + 1
    table = (torch.randperm(np_ - 1, generator=gen, device=dev) + 1)[
        : 4 * nb].to(torch.int32).reshape(4, nb).contiguous()
    table[2] = 0                                   # the empty slot
    # rows: Full 3000 tokens, Partial (routed, context 8229), empty, Full
    # 5555 tokens
    full_len = torch.tensor([3000, 0, 0, 5555], device=dev)
    idx, vlen = ops._page_walk(table, full_len, (np_, bs, hk, dh))
    sel = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)[:35]
                       for _ in range(hk)])             # [Hk, 35] logical
    sel[:, -3:] = -1
    sel[:, 30] = nb - 1                            # the ragged last block
    used = sel >= 0
    idx[1] = 0
    vlen[1] = 0
    idx[1, :, :35] = torch.where(used, table[1][sel.clamp(min=0)], 0)
    vlen[1, :, :35] = torch.where(used, (8229 - sel * bs).clamp(0, bs), 0)
    idx, vlen = idx.contiguous(), vlen.contiguous()
    err_k1 = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((4, 61, h, dh), generator=gen, device=dev).to(dtype)
        pk = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        pv = torch.randn((np_, bs, hk, dh), generator=gen,
                         device=dev).to(dtype)
        kf, vf = pk.reshape(-1, hk, dh), pv.reshape(-1, hk, dh)
        got = ops.block_attention(q, kf, vf, idx, vlen, bs)
        want = ref.block_attention_batched(q, kf, vf, idx, vlen, bs)
        torch.cuda.synchronize()
        out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
        out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
        for nm, g, w in (("m", got[0], want[0]), ("l", got[1], want[1]),
                         ("acc", got[2], want[2]), ("out", out_g, out_w)):
            _close(f"K1 mixed batch-4 {dtype} {nm}", g, w)
        if not (bool((got[0][2] <= -1e29).all())
                and float(got[1][2].abs().max()) == 0.0):
            raise AssertionError("K1 mixed batch-4: the empty slot is not "
                                 "masked")
        err_k1 = max(err_k1, (out_g - out_w).abs().max().item(),
                     (got[0] - want[0]).abs().max().item())
    say(card, f"kernel K1 mixed batch-4 T=61 (Full 3000, routed Partial "
              f"NS=35, empty slot, Full 5555) bf16 and fp32: max_abs_err "
              f"{err_k1:.3e} (tol {TOL_KERNEL} of max |plain|), the empty "
              f"slot all masked")
    # K3: ragged live block counts, zero summaries past them (null pages)
    t = 156
    q = torch.randn((4, t, h, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    kmax = torch.randn((4, nb, hk, dh), generator=gen, device=dev).abs()
    kmin = -torch.randn((4, nb, hk, dh), generator=gen, device=dev).abs()
    live = torch.tensor([66, 40, 0, 23], device=dev)
    keep = (torch.arange(nb, device=dev)[None] < live[:, None])[..., None,
                                                                None]
    kmax, kmin = kmax * keep, kmin * keep
    qw = (torch.rand((4, t), generator=gen, device=dev) > 0.5).float()
    qw[:, 0] = 1.0
    got = ops.retrieval_scores(q, kmax, kmin, qw)
    again = ops.retrieval_scores(q, kmax, kmin, qw)
    want = ref.retrieval_score_batched(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("K3 ragged batch-4: two calls differ")
    _close("K3 ragged batch-4", got, want)
    err_k3 = (got - want).abs().max().item()
    say(card, f"kernel K3 batch-4 T=156 NB=66 with live blocks "
              f"{live.tolist()} bf16: max_abs_err {err_k3:.3e} (tol "
              f"{TOL_KERNEL}), two calls bit-equal")
    # K4: every layer, four rows; row 1 start = end mid-block, row 2 neutral
    layers, nbk = 32, 24
    np4 = 4 * nbk + 1
    pool = torch.randn((layers, np4, bs, hk, dh), generator=gen,
                       device=dev).to(torch.bfloat16)
    tab = (torch.randperm(np4 - 1, generator=gen, device=dev) + 1).to(
        torch.int32).reshape(4, nbk).contiguous()
    tab[2] = 0
    start = torch.tensor([2600, 1000, 0, 2304], dtype=torch.int32,
                         device=dev)
    end = torch.tensor([2661, 1000, 0, 2560], dtype=torch.int32, device=dev)
    init = torch.zeros((2, layers, np4, hk, dh), device=dev)
    ref.paged_block_summaries(pool, tab, torch.zeros_like(start), start,
                              nbk, init[0], init[1])
    got, want = init.clone(), init.clone()
    ops.paged_block_summaries(pool, tab, start, end, 3, got[0], got[1])
    ref.paged_block_summaries(pool, tab, start, end, 3, want[0], want[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 four rows with start = end: kernel differs "
                             "from its plain version")
    pages1 = tab[1].long()
    if not torch.equal(got[:, :, pages1], init[:, :, pages1]):
        raise AssertionError("K4: the start = end row's summaries moved")
    if float(got[:, :, 0].abs().max()) != 0.0:
        raise AssertionError("K4 wrote the null page")
    say(card, "kernel K4 all 32 layers, rows (commit 2600-2661, start = end "
              "= 1000, neutral slot, prefill chunk 2304-2560) bf16: bit-equal "
              "to plain, the start = end row's summaries unchanged, null page "
              "0")
    ops.LAUNCHES.update(before)
    return err_k1, err_k3


def _score_inputs(torch, gen, t, nb, dtype, h=32, hk=8, dh=128):
    q = torch.randn((1, t, h, dh), generator=gen, device="cuda").to(dtype)
    kmax = torch.randn((1, nb, hk, dh), generator=gen, device="cuda").abs()
    kmin = -torch.randn((1, nb, hk, dh), generator=gen, device="cuda").abs()
    qw = (torch.rand((1, t), generator=gen, device="cuda") > 0.3).float()
    qw[0, 0] = 1.0
    return q, kmax, kmin, qw


def _score_checks(torch, card, timer, gen):
    """K3 at a refresh tick's shapes (T=156, NB=66, llama3.1-8b heads) in
    bf16 (the path's dtype, the row reported) and fp32, each timed with
    one launch per call and two calls giving equal bits; then the edges
    of its 32-block tiles and 64-row slices, checked only."""
    from repro_torch.kernels import ops, ref
    row, err_all = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        t, h, hk, dh, nb = 156, 32, 8, 128, 66
        q, kmax, kmin, qw = _score_inputs(torch, gen, t, nb, dtype)
        got = ops.retrieval_scores(q, kmax, kmin, qw)
        again = ops.retrieval_scores(q, kmax, kmin, qw)
        want = ref.retrieval_score_batched(q, kmax, kmin, qw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K3 {dtype}: two calls differ")
        err = (got - want).abs().max().item()
        err_all = max(err_all, err)
        rel = _close(f"K3 scores {dtype}", got, want)
        before = dict(ops.LAUNCHES)

        def launch():
            return ops.retrieval_scores(q, kmax, kmin, qw)
        ms = timer.kernel_ms(launch, "retrieval_score_kernel")
        if timer.per_call != 1:
            raise AssertionError(f"K3: {timer.per_call} launches per call")
        event_ms = timer(launch)
        ops.LAUNCHES.update(before)
        plain_ms = timer(lambda: ref.retrieval_score_batched(q, kmax, kmin,
                                                             qw),
                         iters=3, warmup=1)
        nbytes = q.numel() * 2 + 2 * kmax.numel() * 4 + t * 4 + hk * nb * 4
        flops = 2 * 2 * dh * (h // hk) * t * hk * nb
        bound, by = _bound_ms(nbytes, flops, PEAK_FP32_S)
        say(card, f"kernel K3 retrieval T=156 NB=66 {dtype}: max_abs_err "
                  f"{err:.3e} max_rel_err {rel:.3e} (tol {TOL_KERNEL} of max "
                  f"|plain|; two calls bit-equal) ms {ms:.4f} (profiler, 1 "
                  f"launch per call; events {event_ms:.4f}) plain_ms "
                  f"{plain_ms:.4f} bound_us {bound * 1e3:.2f} ({by}) "
                  f"library_ms none")
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=None)
    before = dict(ops.LAUNCHES)
    for dtype in (torch.bfloat16, torch.float32):
        for t in (1, 156, 157):
            for nb in (1, 33, 66):
                q, kmax, kmin, qw = _score_inputs(torch, gen, t, nb, dtype)
                got = ops.retrieval_scores(q, kmax, kmin, qw)
                again = ops.retrieval_scores(q, kmax, kmin, qw)
                want = ref.retrieval_score_batched(q, kmax, kmin, qw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K3 T={t} NB={nb} {dtype}: two "
                                         f"calls differ")
                _close(f"K3 T={t} NB={nb} {dtype}", got, want)
                err_all = max(err_all, (got - want).abs().max().item())
    ops.LAUNCHES.update(before)
    say(card, f"kernel K3 edges T in (1, 156, 157) x NB in (1, 33, 66), bf16 "
              f"and fp32: all within tol {TOL_KERNEL}, two calls bit-equal")
    row["max_abs_err"] = err_all
    return row


# K4's paged shapes on the llama path: (label, start, end, n_touch), one
# row of an 8192-token prompt in 66 table blocks of 128 tokens
K4_PAGED_SHAPES = (
    # the last prompt chunk: blocks 62 and 63, the third entry past the span
    ("all-layers prefill chunk", 7936, 8192, 3),
    # a Refresh commit of 37 tokens (width 101: n_touch 2): one ragged block
    ("all-layers Refresh commit", 8192, 8229, 2),
)


def _paged_summary_case(torch, card, timer, gen, dtype, label, start, end,
                        n_touch, layers=32, np_=70, nb=66, hk=8, dh=128,
                        bs=128):
    """One paged all-layers K4 call held to its plain version bit for bit
    (null page 0 still 0 in every layer, one launch per call), timed with
    its plain version, its bound and ``torch.aminmax`` over the same live
    blocks.  Returns the numbers of the case."""
    from repro_torch.kernels import ops, ref
    pool = torch.randn((layers, np_, bs, hk, dh), generator=gen,
                       device="cuda").to(dtype)
    perm = torch.randperm(np_ - 1, generator=gen, device="cuda") + 1
    table = perm[:nb].to(torch.int32)[None].contiguous()
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    en = torch.tensor([end], dtype=torch.int32, device="cuda")
    got = torch.zeros((2, layers, np_, hk, dh), device="cuda")
    want = torch.zeros_like(got)
    ops.paged_block_summaries(pool, table, st, en, n_touch, got[0], got[1])
    ref.paged_block_summaries(pool, table, st, en, n_touch, want[0], want[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K4 {label} {dtype}: kernel differs from its "
                             f"plain version, max abs err "
                             f"{(got - want).abs().max().item():.3e}")
    if float(got[:, :, 0].abs().max()) != 0.0:
        raise AssertionError(f"K4 {label} {dtype} wrote the null page")
    # the live entries, as the kernel routes them
    live = [(start // bs + j, min(end - (start // bs + j) * bs, bs))
            for j in range(n_touch)
            if start // bs + j < -(-end // bs) and start // bs + j < nb]
    if not float(got.abs().sum()) > 0 or not live:
        raise AssertionError(f"K4 {label}: nothing written")
    before = dict(ops.LAUNCHES)

    def launch():
        return ops.paged_block_summaries(pool, table, st, en, n_touch,
                                         got[0], got[1])
    ms = timer.kernel_ms(launch, "block_summary_kernel")
    if timer.per_call != 1:
        raise AssertionError(f"K4: {timer.per_call} launches per call")
    ops.LAUNCHES.update(before)
    plain_ms = timer(lambda: ref.paged_block_summaries(
        pool, table, st, en, n_touch, want[0], want[1]), iters=3, warmup=1)
    kb = pool.reshape(layers * np_, bs, hk, dh)
    pages = table[0, [tb for tb, _ in live]].long()
    rows = (torch.arange(layers, device="cuda")[:, None] * np_
            + pages[None]).reshape(-1)
    # the yardstick: one aminmax over the gathered live blocks
    lib_ms = timer(lambda: torch.aminmax(kb[rows], dim=1))
    n_tok = layers * sum(v for _, v in live)
    nbytes = (n_tok * hk * dh * pool.element_size()
              + 2 * layers * len(live) * hk * dh * 4 + n_touch * 4 + 8)
    bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
    say(card, f"kernel K4 paged {label} L={layers} n_touch={n_touch} "
              f"(live blocks {[v for _, v in live]} tokens) {dtype}: "
              f"bit-equal to plain, null page 0, 1 launch per call; ms "
              f"{ms:.4f} (profiler) plain_ms {plain_ms:.4f} bound_us "
              f"{bound * 1e3:.3f} ({by}) library_ms {lib_ms:.4f} "
              f"(torch.aminmax over the gathered live blocks)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def _summary_checks(torch, card, timer, gen):
    """K4 at the llama path's shapes.  The paged form over all 32 layers,
    the path's only form: a prefill chunk and a Refresh commit
    (``K4_PAGED_SHAPES``), in bf16 and fp32; the row reported is the
    bf16 prefill chunk (32 of the path's 34 launches), and ``shapes``
    holds every timed case.  Then the routed form, a commit (N=2 blocks,
    one ragged) and a prefill chunk (N=3, one entry on the null page),
    in bf16 and fp32, and one whole contiguous cache, the TPU kernel's
    own contract.  Every case is bit-equal to its plain version."""
    from repro_torch.kernels import ops, ref
    row, shapes = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, start, end, n_touch in K4_PAGED_SHAPES:
            vals = _paged_summary_case(torch, card, timer, gen, dtype, label,
                                       start, end, n_touch)
            shapes[f"{label} {str(dtype)[6:]}"] = vals
            if row is None:
                row = dict(vals)
    hk, dh, bs, np_ = 8, 128, 128, 68
    cases = [("commit N=2", [12, 40], [128, 101], [12, 40]),
             ("prefill N=3", [7, 8, 0], [128, 128, 0], [7, 8, 0])]
    for dtype in (torch.bfloat16, torch.float32):
        pool = torch.randn((np_ * bs, hk, dh), generator=gen,
                           device="cuda").to(dtype)
        for label, src, vlen, tgt in cases:
            src_t, vlen_t, tgt_t = (torch.tensor(a, dtype=torch.int32,
                                                 device="cuda")
                                    for a in (src, vlen, tgt))
            outs = [torch.zeros((np_, hk, dh), device="cuda")
                    for _ in range(4)]
            ops.block_summaries_routed(pool, src_t, vlen_t, tgt_t, outs[0],
                                       outs[1], bs)
            ref.block_summary_routed(pool, src_t, vlen_t,
                                     torch.where(tgt_t > 0, tgt_t, -1),
                                     outs[2], outs[3], bs)
            torch.cuda.synchronize()
            if not (torch.equal(outs[0], outs[2])
                    and torch.equal(outs[1], outs[3])):
                raise AssertionError(f"K4 routed {label} {dtype}: kernel "
                                     f"differs from its plain version")
            if float(outs[0][0].abs().max()) != 0.0:
                raise AssertionError("K4 wrote the null page")
            before = dict(ops.LAUNCHES)

            def launch():
                return ops.block_summaries_routed(
                    pool, src_t, vlen_t, tgt_t, outs[0], outs[1], bs)
            ms = timer.kernel_ms(launch, "block_summary_kernel")
            if timer.per_call != 1:
                raise AssertionError(f"K4: {timer.per_call} launches per "
                                     f"call")
            ops.LAUNCHES.update(before)
            plain_ms = timer(lambda: ref.block_summary_routed(
                pool, src_t, vlen_t, tgt_t, outs[2], outs[3], bs), iters=3,
                warmup=1)
            kb = pool.reshape(np_, bs, hk, dh)
            src_l = src_t.long()
            # the yardstick: one aminmax over the gathered full blocks
            lib_ms = timer(lambda: torch.aminmax(kb[src_l], dim=1))
            n_tok = int(vlen_t.sum())
            nbytes = (n_tok * hk * dh * pool.element_size()
                      + 2 * int((tgt_t > 0).sum()) * hk * dh * 4
                      + 3 * len(src) * 4)
            bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
            say(card, f"kernel K4 routed {label} {dtype}: bit-equal to "
                      f"plain, 1 launch per call; ms {ms:.4f} (profiler) "
                      f"plain_ms {plain_ms:.4f} bound_us "
                      f"{bound * 1e3:.3f} ({by}) library_ms {lib_ms:.4f} "
                      f"(torch.aminmax over gathered blocks)")
            shapes[f"routed {label} {str(dtype)[6:]}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
    # one whole contiguous cache: the TPU kernel's own contract
    k = torch.randn((1, 66 * bs, hk, dh), generator=gen,
                    device="cuda").to(torch.bfloat16)
    length = torch.tensor([8229], device="cuda")
    got = ops.block_summaries(k, length, bs)
    want = ref.block_summary_ref(k[0], 8229, bs)
    torch.cuda.synchronize()
    if not (torch.equal(got[0][0], want[0])
            and torch.equal(got[1][0], want[1])):
        raise AssertionError("K4 contiguous: kernel differs from its plain "
                             "version")
    before = dict(ops.LAUNCHES)
    ms = timer.kernel_ms(lambda: ops.block_summaries(k, length, bs),
                         "block_summary_kernel")
    ops.LAUNCHES.update(before)
    say(card, f"kernel K4 contiguous NB=66 length=8229 bf16: bit-equal to "
              f"plain; ms {ms:.4f} (profiler)")
    row["max_abs_err"] = 0.0        # every case above is bit-equal
    row["shapes"] = shapes
    return row


def _wkv_inputs(torch, gen, b, t, h=40, dk=64):
    r, k, v = (torch.randn((b, t, h, dk), generator=gen,
                           device="cuda") * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, dk), generator=gen,
                                         device="cuda") - 2.0))
    u = torch.randn((h, dk), generator=gen, device="cuda") * 0.5
    s0 = torch.randn((b, h, dk, dk), generator=gen, device="cuda")
    return r, k, v, w, u, s0


def _wkv_identity(torch, card, gen):
    """The chain engine's invariant: a read-only T=6 call gives y equal
    bit for bit to six one-token update steps, and an advance of T=6 with
    a valid leaves the state bits of a one-token steps (a = 0, 2, 6)."""
    from repro_torch.kernels import ops
    t = 6
    before = dict(ops.LAUNCHES)
    r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 1, t)
    y6, _ = ops.wkv(r, k, v, w, u, s0, update=False)
    s, ys, states = s0, [], [s0]
    for i in range(t):
        sl = slice(i, i + 1)
        y1, s = ops.wkv(r[:, sl].contiguous(), k[:, sl].contiguous(),
                        v[:, sl].contiguous(), w[:, sl].contiguous(), u, s)
        ys.append(y1)
        states.append(s)
    if not torch.equal(y6, torch.cat(ys, dim=1)):
        raise AssertionError("K5: verify T=6 y differs from 6 one-token steps")
    for a in (0, 2, 6):
        nv = torch.tensor([a], dtype=torch.int32, device="cuda")
        _, s_adv = ops.wkv(r, k, v, w, u, s0, nv)
        if not torch.equal(s_adv, states[a]):
            raise AssertionError(f"K5: advance T=6 valid={a} state differs "
                                 f"from {a} one-token steps")
    ops.LAUNCHES.update(before)
    say(card, "kernel K5 identity: verify T=6 y == 6 one-token steps, "
              "advance T=6 valid=a state == a one-token steps (a = 0, 2, 6), "
              "bit for bit")


def _wkv_checks(torch, card, timer, gen):
    """K5 at rwkv6-3b head shapes (batch 1, H 40, dk 64, fp32): a chain
    verify (T=6, read-only), a prefill chunk (T=256) and an advance with
    a padded valid prefix (T=6, 2 valid), each timed; the verify/advance
    identity; then T on both sides of the kernel's 16-token tiles with
    B=2 and a padded row, checked only.  The row reported is the chain
    verify (the most launches on the path); ``shapes`` holds every timed
    case under its ``WKV_PATH_SHAPES`` label."""
    from repro_torch.kernels import ops, ref
    h, dk = 40, 64
    row, err_all, shapes = None, 0.0, {}
    for t, nv, update in ((6, 6, False), (256, 256, True), (6, 2, True)):
        label = WKV_PATH_SHAPES[(t, update)]
        r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 1, t)
        n_valid = torch.tensor([nv], dtype=torch.int32, device="cuda")
        y, s = ops.wkv(r, k, v, w, u, s0, n_valid, update=update)
        want_y, want_s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        torch.cuda.synchronize()
        pairs = [("y", y, want_y)] + ([("s", s, want_s)] if update else [])
        rel = max(_close(f"K5 {label} {nm}", g, wv) for nm, g, wv in pairs)
        if not update and s is not s0:
            raise AssertionError("K5 read-only call replaced the state")
        err = max((g - wv).abs().max().item() for _, g, wv in pairs)
        err_all = max(err_all, err)
        before = dict(ops.LAUNCHES)

        def launch():
            return ops.wkv(r, k, v, w, u, s0, n_valid, update=update)
        ms = timer.kernel_ms(launch, "wkv_kernel")
        if timer.per_call != 1:
            raise AssertionError(f"K5: {timer.per_call} launches per call")
        ops.LAUNCHES.update(before)
        # the plain T=256 loop issues ~2000 launches, more than the launch
        # queue holds behind a spin: its window includes host time
        plain_timer = timer if t <= 6 else timer.wall
        plain_ms = plain_timer(
            lambda: ref.wkv_batched(r, k, v, w, u, s0, n_valid), iters=3,
            warmup=1)
        nbytes = (5 * t * h * dk * 4 + h * dk * 4 + 4
                  + (2 if update else 1) * h * dk * dk * 4)
        flops = 5 * t * h * dk * dk + 2 * nv * h * dk * dk
        bound, by = _bound_ms(nbytes, flops, PEAK_FP32_S)
        say(card, f"kernel K5 wkv {label} ({nv} valid): max_abs_err "
                  f"{err:.3e} max_rel_err "
                  f"{rel:.3e} (tol {TOL_KERNEL}) ms {ms:.4f} (profiler) "
                  f"plain_ms {plain_ms:.4f}"
                  f"{'' if t <= 6 else ' (events incl. host time)'} "
                  f"bound_us {bound * 1e3:.3f} ({by}) library_ms none")
        shapes[label] = dict(valid=nv, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=None)
    _wkv_identity(torch, card, gen)
    before = dict(ops.LAUNCHES)
    for t in (1, 6, 31, 33, 256, 257):
        r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 2, t)
        n_valid = torch.tensor([t, t // 2], dtype=torch.int32, device="cuda")
        y, s = ops.wkv(r, k, v, w, u, s0, n_valid)
        want_y, want_s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        torch.cuda.synchronize()
        _close(f"K5 B=2 T={t} y", y, want_y)
        _close(f"K5 B=2 T={t} s", s, want_s)
        err_all = max(err_all, (y - want_y).abs().max().item(),
                      (s - want_s).abs().max().item())
    ops.LAUNCHES.update(before)
    say(card, f"kernel K5 B=2 (one row padded to T//2) at T in (1, 6, 31, 33, "
              f"256, 257): y and state within tol {TOL_KERNEL}")
    row["max_abs_err"] = err_all
    row["shapes"] = shapes
    return row


# ---------------------------------------------------------------------------
# phase 3: full-width generate
# ---------------------------------------------------------------------------

def _full_width(torch, card, arch, dtype="bfloat16", seed=0,
                prompt_len=PROMPT_LEN, prompt_seed=0, layers=None):
    """``arch`` at full width (``layers`` cuts the depth) with random
    weights from ``seed`` (the draft from ``seed + 1``), the paper spec
    and a prompt from ``prompt_seed``."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.models.api import init_params
    cfg = get_config(arch).replace(dtype=dtype, param_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=seed + 1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"{arch} {cfg.num_layers} layers {dtype} random "
              f"weights ready in {time.perf_counter() - t0:.1f} s "
              f"({_nbytes(params) / 2**30:.2f} GiB target, "
              f"{_nbytes(dparams) / 2**30:.2f} GiB draft)")
    prompt = np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    return cfg, spec, dcfg, params, dparams, prompt


def phase_generate(torch, card):
    """Phase 3: the paged zero-copy engine.  Returns the graph run's
    launches and tokens."""
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b")
    runs = generate_runs(torch, card, cfg, spec, dcfg, params, dparams,
                         prompt, NEW_TOKENS, dict(paged=True, zero_copy=True),
                         "llama3.1-8b", eager_new=PHASE3_EAGER_NEW,
                         profile_eager=False, profile_prefill=False)
    del params, dparams
    torch.cuda.empty_cache()
    return runs["graphs"]


def generate_runs(torch, card, cfg, spec, dcfg, params, dparams, prompt,
                  new_tokens, layout, name, eager_new=None, eager_hook=None,
                  profile_eager=True, profile_prefill=True):
    """``generate`` at full width on the engine ``layout`` gives (paged
    or not, zero-copy or not), eagerly then with graphs: launches held to
    the path, final summaries to the plain version, a profiled window,
    the bodies under the sync check after the eager run, graph tokens
    and launches equal to eager.  With ``eager_new`` the eager run
    generates that many tokens only and is not profiled; its tokens are
    then held to the graph run's first ``eager_new`` and each run's
    launches to what its own steps imply.  ``eager_hook(eng, st)`` runs
    on the eager engine and the state its ``generate`` left, before the
    sync check; its result is the eager run's ``"hook"``.  The eager run's
    profiled window leaves its prefill out (profiling an eager 8192-token
    prefill took 114 s of the smoke); ``profile_eager=False`` leaves the
    eager run unprofiled, ``profile_prefill=False`` the graph run's
    prefill out too.  Returns both runs' numbers."""
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    prompt_len = prompt.shape[1]
    tree_path = dcfg.tree_depth + 1
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 tree_path)
    runs = {}
    for graphs in (False, True):
        t_run = time.perf_counter()
        label = f"{name} {RUN_LABEL[graphs]}"
        short = not graphs and eager_new is not None
        n_new = eager_new if short else new_tokens
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, device="cuda",
                           cuda_graphs=graphs, **layout)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        decode_s = wall - stats["prefill_s"]
        say(card, f"generate [{label}] ({cfg.num_layers} layers, bf16, "
                  f"random weights) prompt {prompt_len} new {n_new}: modes "
                  f"{stats['modes']} steps {stats['steps']} mean_accept "
                  f"{stats['mean_accept']:.4f} wall_s {wall:.3f} (prefill_s "
                  f"{stats['prefill_s']:.3f} decode_s {decode_s:.3f}, ms/step "
                  f"{decode_s * 1e3 / max(stats['steps'], 1):.2f}) "
                  f"tokens_per_s {n_new / wall:.2f} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} launches {launches}")
        if not (stats["modes"].get("refresh")
                and stats["modes"].get("partial")):
            raise AssertionError(f"Refresh and Partial ticks must both run: "
                                 f"{stats['modes']}")
        for k in LLAMA_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the "
                                     f"path")
        # one K1 per layer and step (the full cache or the partial body),
        # K2 per layer and prefill chunk, K3 per layer and Refresh, K4
        # once per prefill chunk and per commit over every layer
        chunks = -(-prompt_len // 256)
        refresh = stats["modes"].get("refresh", 0)
        commits = refresh + stats["modes"].get("full", 0)
        layers = cfg.num_layers
        want = {"sparse_verify_attention": layers * stats["steps"],
                "paged_prefill_attention": layers * chunks,
                "retrieval_score": layers * refresh,
                "block_summary": chunks + commits}
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"launches {got} != {want} implied by "
                                 f"{stats['steps']} steps ({stats['modes']}) "
                                 f"and {chunks} prefill chunks")
        say(card, f"launches [{label}] {got} = implied by {stats['steps']} "
                  f"steps and {chunks} prefill chunks (K4: {chunks} chunks + "
                  f"{commits} commits, each over {layers} layers)")
        # the greedy tree variants: no sampled or chain rows
        want_graphs = {("prefill", 256), (True, False, True, False, False),
                       (False, True, False, False, False)}
        if graphs and set(eng._graphs) != want_graphs:
            raise AssertionError(f"graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        if eng.paged:
            _check_final_summaries(torch, card, eng.final_state.cache)
        else:
            _check_final_contiguous_summaries(torch, card,
                                              eng.final_state.cache,
                                              spec.block_size)
        if toks.shape != (1, n_new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"tokens out of range: {toks}")
        t_prof = time.perf_counter()
        hook = None
        if not graphs and eager_hook is not None:
            hook = eager_hook(eng, eng.final_state)
        eng.final_state = None
        # a window is even (an eager one host-bound, about 130 ms a step)
        # and each profiled step costs host seconds to record and sum
        prof = {} if short or not (graphs or profile_eager) else (
            profile_steps(torch, card, eng, prompt, label=label,
                          steps=PROFILE_STEPS,
                          kernel="retrieval_score_kernel", refresh=True,
                          prefill_kernel="block_summary_kernel",
                          prefill=graphs and profile_prefill))
        t_checks = time.perf_counter()
        if not graphs:
            check_sync_free(torch, card, eng, prompt[:, :SYNC_CHECK_PROMPT])
        say(card, f"{label} took {time.perf_counter() - t_run:.1f} s "
                  f"(generate {wall:.1f} s, hook and profile "
                  f"{t_checks - t_prof:.1f} s, sync check "
                  f"{time.perf_counter() - t_checks:.1f} s)")
        runs[RUN_LABEL[graphs]] = dict(
            toks=toks, launches=launches, wall_s=wall,
            tokens_per_s=n_new / wall, prefill_s=stats["prefill_s"],
            peak_gib=peak, capture_s=eng.capture_s, steps=stats["steps"],
            hook=hook, **prof)
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, name, runs)
    return runs


RUN_LABEL = {False: "eager", True: "graphs"}


def _nbytes(obj) -> int:
    """Bytes of every tensor in a nest of dicts and lists."""
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return obj.numel() * obj.element_size() if hasattr(obj, "numel") else 0


def memory_line(torch, card, label, eng, params, dparams, peak):
    """Where a run's device memory went: the weights, the engine's static
    state, what else stays allocated after ``generate`` (the graphs'
    pool, with graphs) and the peak above that (transients: a step's
    intermediates, the warm-up copy of the state at each capture)."""
    gib = 2.0**30
    weights = (_nbytes(params) + _nbytes(dparams)) / gib
    static = sum(t.numel() * t.element_size()
                 for t in eng._static_tensors()) / gib
    held = torch.cuda.memory_allocated() / gib
    say(card, f"memory [{label}]: weights {weights:.3f} GiB, static state "
              f"{static:.3f} GiB, other held after generate "
              f"{held - weights - static:.3f} GiB, peak {peak:.3f} GiB "
              f"({peak - held:.3f} above what stays held)")


def compare_runs(card, name, runs):
    """Graphs against eager on one path: the tokens (the graph run's first
    ones when the eager run was shorter) and, for runs of one length, the
    launch counts must be equal; the numbers of both runs side by side."""
    import numpy as np
    e, g = runs["eager"], runs["graphs"]
    n = e["toks"].shape[1]
    if not np.array_equal(e["toks"], g["toks"][:, :n]):
        raise AssertionError(f"{name}: graph tokens differ from eager:\n"
                             f"{g['toks']}\n{e['toks']}")
    same_len = n == g["toks"].shape[1]
    if same_len and e["launches"] != g["launches"]:
        raise AssertionError(f"{name}: graph launch counts {g['launches']} "
                             f"!= eager {e['launches']}")
    say(card, f"{name}: graph generate == eager generate over {n} tokens"
              + (", launch counts equal" if same_len else
                 " (the eager run's first tokens; each run's launches held "
                 "to its own steps)"))
    for key in ("wall_ms_step", "tokens_per_s", "prefill_s", "idle_share",
                "idle_share_unprofiled", "busy_ms_step",
                "device_launches_step", "host_launch_calls_step",
                "host_ops_step", "prefill_device_launches_chunk",
                "prefill_host_launch_calls_chunk", "prefill_busy_ms",
                "prefill_wall_s", "peak_gib", "capture_s"):
        if key in e:
            say(card, f"{name} eager vs graphs: {key} {e[key]:.4f} -> "
                      f"{g[key]:.4f}")


def check_sync_free(torch, card, eng, prompt,
                    modes=("full", "refresh", "partial"), extra=None):
    """After a prefill of ``prompt`` (conditioned on ``extra`` for a VLM
    or audio target), one eager run of the body of each
    step variant in ``modes`` (an engine whose ``max_len`` is under the
    partial budget runs Full steps only) and of the 256-token prefill
    chunk's under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any operation that waits for the card (a host read, a copy
    from pageable memory): what a graph captures must not sync."""
    from repro_torch.core.engine import MODE_IDS
    st = eng.prefill(prompt, extra=extra)
    toks = eng._chunk_buf(eng.batch, 256)
    if eng.is_attn:
        eng._rows.fill_(True)
        bodies = [(mode, (lambda mode=mode, key=key: (
            eng._modes.fill_(MODE_IDS[mode]), eng._fused_body(*key))))
            for mode, key in (("full", (True, False, False)),
                              ("refresh", (True, False, True)),
                              ("partial", (False, True, False)))
            if mode in modes]
    else:
        bodies = [("state", eng._state_body)]
    bodies.append(("prefill chunk", lambda: eng._prefill_body(
        toks, st.cache, st.dcache, eng._prev_feat, eng._logits_last)))
    torch.cuda.synchronize()
    for label, body in bodies:
        torch.cuda.set_sync_debug_mode("error")
        try:
            body()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(card, f"sync check: the {', '.join(lb for lb, _ in bodies)} bodies "
              f"ran eagerly under set_sync_debug_mode('error') without a "
              f"sync")


def _check_final_summaries(torch, card, cache, group: int = 8):
    """Every layer's page summaries in the cache ``generate`` left,
    against the plain version recomputed from its pool: each row's
    blocks over [0, length), bit for bit, and 0 on every page no block of
    a row covers, the null page 0 among them.  The plain version runs
    ``group`` layers at a time (its fp32 temporaries of all 64 layers of
    qwen1.5-32b do not fit beside its weights)."""
    from repro_torch.kernels import ref
    pt, length = cache["page_table"], cache["length"]
    want = torch.zeros((2,) + tuple(cache["kmax"].shape), device="cuda")
    for l0 in range(0, want.shape[1], group):
        sl = slice(l0, l0 + group)
        ref.paged_block_summaries(cache["k"][sl], pt,
                                  torch.zeros_like(length), length,
                                  pt.shape[1], want[0, sl], want[1, sl])
    torch.cuda.synchronize()
    for name, w in (("kmax", want[0]), ("kmin", want[1])):
        if not torch.equal(cache[name], w):
            bad = (cache[name] != w).reshape(w.shape[0], w.shape[1], -1)
            raise AssertionError(
                f"final cache {name} differs from the plain recomputation "
                f"on (layer, page) {bad.any(-1).nonzero()[:8].tolist()}")
    if float(cache["kmax"][:, 0].abs().max()) != 0.0:
        raise AssertionError("the null page's summaries are not 0")
    say(card, f"final cache summaries ({tuple(cache['kmax'].shape)}, "
              f"length {length.tolist()}) equal the plain recomputation "
              f"bit for bit; the null page is 0 in every layer")


def _check_final_contiguous_summaries(torch, card, cache, bs):
    """The contiguous cache's summaries ``generate`` left, against the
    plain per-layer recomputation over [0, length) from its K, bit for
    bit (blocks past the length stay 0 in both)."""
    from repro_torch.kvcache.cache import update_layer_summaries
    length = cache["length"]
    zero = torch.zeros_like(length)
    for i in range(cache["k"].shape[0]):
        want = update_layer_summaries(torch.zeros_like(cache["kmax"][i]),
                                      torch.zeros_like(cache["kmin"][i]),
                                      cache["k"][i], zero, length, bs)
        for name, w in zip(("kmax", "kmin"), want):
            if not torch.equal(cache[name][i], w):
                raise AssertionError(f"final contiguous cache {name} of "
                                     f"layer {i} differs from the plain "
                                     f"recomputation")
    say(card, f"final contiguous cache summaries "
              f"({tuple(cache['kmax'].shape)}, length {length.tolist()}) "
              f"equal the plain recomputation bit for bit")


def _device_busy(prof, skip=()):
    """(busy ms, span ms) of the device events a profiler recorded (but
    those named in ``skip``, such as a ``record_function`` range's
    device-side copy): the union of their intervals, and first start to
    last end."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start
                   and e.name not in skip)
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    return busy_us / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


# the CUDA API calls (runtime and cu*) by which the host starts device work
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _launch_counts(prof):
    """(device launches, top-level host ops, host launch calls) a profiler
    recorded: every kernel, copy and set on the card (a graph's too),
    every aten op the host dispatched that no other op called, and every
    runtime call that started device work (a graph replay is one)."""
    from torch.autograd import DeviceType
    dev_n = host_n = calls = 0
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            dev_n += 1
        elif e.name in HOST_LAUNCH_CALLS:
            calls += 1
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            host_n += 1
    return dev_n, host_n, calls


def _named_ms(prof, kernel):
    """Device ms of every kernel whose name contains ``kernel``."""
    from torch.autograd import DeviceType
    return sum(_dev_us(e) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and kernel in e.key) / 1e3


def profile_steps(torch, card, eng, prompt, warm: int = 2, steps: int = 6,
                  kernel: str = "", refresh: bool = False,
                  prefill_kernel: str = "", label: str = "",
                  prefill: bool = True, extra=None, after=None):
    """Where the time goes.  The fresh prefill runs under
    ``torch.profiler`` (its device busy time and span, the device time
    of the kernels named ``prefill_kernel`` or else ``kernel``, and its
    device launches, top-level host ops and host launch calls per
    256-token chunk); then after ``warm`` steps, ``steps`` steps timed on
    the host clock, then ``steps`` more under the profiler: device time
    by CUDA kernel, and, over the profiled steps alone, the idle share =
    1 - device busy time (union of the device events' intervals) / the
    device span (first event's start to last event's end), beside the
    host clock around the same steps.  The idle share without the
    profiler is 1 - that busy time / the unprofiled host wall time per
    step (the profiler slows the host, not the card).  With ``refresh``,
    ``REFRESH_PROFILE_STEPS`` forced Refresh steps follow under the
    profiler: their device busy time and the share of it in ``kernel``.  With ``prefill=False`` the
    prefill runs unprofiled.  ``extra``: a VLM or audio target's
    conditioning.  ``after(st)`` runs last on the state the window left;
    its result is ``out["after"]``.  Returns the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if not prefill:
        out = {}
        st = eng.prefill(prompt, extra=extra)
        torch.cuda.synchronize()
    else:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            st = eng.prefill(prompt, extra=extra)
            torch.cuda.synchronize()
            pre_wall = time.perf_counter() - t0
        busy, span = _device_busy(prof)
        chunks = -(-prompt.shape[1] // 256)
        dev_n, host_n, calls_n = _launch_counts(prof)
        pk = prefill_kernel or kernel
        pk_ms = _named_ms(prof, pk)
        say(card, f"profile [{label}] prefill of {prompt.shape[1]} tokens: "
                  f"host wall_s {pre_wall:.3f} (profiled) device span_ms "
                  f"{span:.2f} device busy_ms {busy:.2f} ({pk} "
                  f"{pk_ms:.3f} ms); per chunk of 256 "
                  f"({chunks} chunks): device launches {dev_n / chunks:.1f}, "
                  f"top-level host aten ops {host_n / chunks:.1f}, host "
                  f"launch calls {calls_n / chunks:.1f}")
        out = dict(prefill_wall_s=pre_wall, prefill_busy_ms=busy,
                   prefill_span_ms=span, prefill_kernel_ms=pk_ms,
                   prefill_device_launches_chunk=dev_n / chunks,
                   prefill_host_ops_chunk=host_n / chunks,
                   prefill_host_launch_calls_chunk=calls_n / chunks)

    def run(st, n):
        modes = []
        for _ in range(n):
            st, so = eng.step(st, eng.next_mode())
            modes.append(so.mode)
        torch.cuda.synchronize()
        return st, modes

    st, _ = run(st, warm)
    t0 = time.perf_counter()
    st, modes = run(st, steps)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st, pmodes = run(st, steps)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, span_ms = _device_busy(prof)
    dev_n, host_n, calls_n = _launch_counts(prof)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _dev_us(e) > 0]
    idle_unprof = 1 - busy_ms / wall_ms
    say(card, f"profile [{label}] decode steps {modes} then {pmodes}: "
              f"unprofiled wall_ms/step {wall_ms / steps:.2f}; profiled "
              f"steps: host wall_ms/step {prof_wall_ms / steps:.2f} device "
              f"span_ms/step {span_ms / steps:.2f} device busy_ms/step "
              f"{busy_ms / steps:.2f} idle_share {1 - busy_ms / span_ms:.3f} "
              f"(unprofiled: {idle_unprof:.3f}) device launches/step "
              f"{dev_n / steps:.1f} host launch calls/step "
              f"{calls_n / steps:.1f} top-level host aten ops/step "
              f"{host_n / steps:.1f}")
    top = sorted(kernels, key=_dev_us, reverse=True)[:10]
    for e in top:
        say(card, f"profile [{label}]   {_dev_us(e) / 1e3 / steps:8.3f} "
                  f"ms/step {e.count // steps:5d} launches/step  "
                  f"{e.key[:80]}")
    out.update(top_kernels=[(e.key[:80], _dev_us(e) / 1e3 / steps,
                             e.count / steps) for e in top[:5]])
    out.update(wall_ms_step=wall_ms / steps, busy_ms_step=busy_ms / steps,
               idle_share=1 - busy_ms / span_ms,
               idle_share_unprofiled=idle_unprof,
               device_launches_step=dev_n / steps,
               host_launch_calls_step=calls_n / steps,
               host_ops_step=host_n / steps)
    if refresh:
        n = REFRESH_PROFILE_STEPS
        with profile(activities=acts) as prof:
            for _ in range(n):
                st, so = eng.step(st, "refresh")
            torch.cuda.synchronize()
        busy_ms, span_ms = _device_busy(prof)
        k_ms = _named_ms(prof, kernel)
        say(card, f"profile [{label}] {n} forced Refresh step(s): device "
                  f"busy_ms/step {busy_ms / n:.2f} span_ms/step "
                  f"{span_ms / n:.2f}; {kernel} {k_ms / n:.4f} ms/step = "
                  f"{k_ms / busy_ms:.4f} of device busy time")
        out.update(refresh_busy_ms=busy_ms / n)
    if after is not None:
        out["after"] = after(st)
    return out


# ---------------------------------------------------------------------------
# phase 4: losslessness at full width, reduced depth, fp32
# ---------------------------------------------------------------------------

LOSSLESS_PROMPT, LOSSLESS_NEW = 4800, 32


def _lossless_setup(torch, prompt_len, new_tokens):
    """The fp32 losslessness inputs of phases 4 and 8: llama3.1-8b at
    full width and 4 layers, TF32 off, seeds 2 and 3, prompt seed 1."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import request_token_need
    from repro_torch.models.api import init_params
    # fp32 results are compared: keep matmuls and convolutions out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=4, dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    return cfg, spec, dcfg, params, dparams, prompt, max_len


def phase_lossless(torch, card, prompt_len: int = LOSSLESS_PROMPT,
                   new_tokens: int = LOSSLESS_NEW):
    """Phase 4.  Returns the AR tokens and the paged zero-copy partial
    run's, which phase 8 holds its layouts to."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.core.reference import autoregressive_generate

    cfg, spec, dcfg, params, dparams, prompt, max_len = _lossless_setup(
        torch, prompt_len, new_tokens)
    t0 = time.perf_counter()
    ar = autoregressive_generate(cfg, params, prompt, new_tokens,
                                 max_len=max_len, spec=spec, device="cuda")
    full = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, paged=True, zero_copy=True,
                        partial_verification=False, device="cuda")
    toks_full, st_full = full.generate(prompt, new_tokens)
    if not full._graphs:
        raise AssertionError("the full-verification run replayed no graph")
    if not np.array_equal(toks_full, ar):
        raise AssertionError(f"full-verification SpecPV differs from AR:\n"
                             f"{toks_full}\n{ar}")
    del full
    toks_part = {}
    for graphs in (True, False):
        part = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                            max_len=max_len, paged=True, zero_copy=True,
                            device="cuda", cuda_graphs=graphs)
        toks_part[graphs], st_part = part.generate(prompt, new_tokens)
        del part
    if not np.array_equal(toks_part[True], toks_part[False]):
        raise AssertionError(f"partial-verification run: graphs differ from "
                             f"eager:\n{toks_part[True]}\n{toks_part[False]}")
    if toks_part[True].min() < 0 or toks_part[True].max() >= cfg.vocab_size:
        raise AssertionError(f"partial-verification tokens out of range")
    agree = float(np.mean(toks_part[True] == ar))
    say(card, f"lossless llama3.1-8b x4 layers fp32, graphs: full-verify == "
              f"AR over {new_tokens} tokens (modes {st_full['modes']}); "
              f"partial run modes {st_part['modes']} equals its eager run "
              f"and agrees with AR on {agree:.3f} of tokens; "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()
    return dict(ar=ar, partial=toks_part[True])


# ---------------------------------------------------------------------------
# phase 5: the state-architecture path (rwkv6-3b chain speculation)
# ---------------------------------------------------------------------------

def phase_rwkv(torch, card, prompt_len: int = PROMPT_LEN,
               new_tokens: int = NEW_TOKENS):
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    from repro_torch.models.api import init_params

    cfg = get_config("rwkv6-3b")
    spec = SpecPVConfig()
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"rwkv6-3b random weights ready in "
              f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    chunk = 256
    runs = {}
    for graphs in (False, True):
        label = RUN_LABEL[graphs]
        # the eager run is host-bound: its first RWKV_EAGER_NEW tokens
        # are held to the graph run's
        n_new = new_tokens if graphs else min(new_tokens, RWKV_EAGER_NEW)
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=False, device="cuda",
                           cuda_graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, n_new, prefill_chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        by_shape = {WKV_PATH_SHAPES.get(key, f"T={key[0]} update={key[1]}"): n
                    for key, n in ops.WKV_SHAPES.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        chunks = -(-prompt_len // chunk)
        want_wkv = cfg.num_layers * (chunks + 2 * stats["steps"])
        say(card, f"generate rwkv6-3b [{label}] ({cfg.num_layers} layers, d "
                  f"{cfg.d_model}, {cfg.dtype}, random weights, chain depth "
                  f"{dcfg.tree_depth}) prompt {prompt_len} new "
                  f"{n_new}: modes {stats['modes']} steps "
                  f"{stats['steps']} mean_accept {stats['mean_accept']:.4f} "
                  f"wall_s {wall:.3f} (prefill_s {stats['prefill_s']:.3f}) "
                  f"tokens_per_s {n_new / wall:.2f} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} wkv_launches "
                  f"{launches['wkv']} (expected {cfg.num_layers} x ({chunks} "
                  f"prefill chunks + 2 x {stats['steps']} steps) = "
                  f"{want_wkv}) launches {launches}")
        say(card, f"wkv launches by shape [{label}] (counted in ops.wkv): "
                  f"{by_shape}")
        if stats["modes"] != {"state": stats["steps"]}:
            raise AssertionError(f"state steps only: {stats['modes']}")
        if launches["wkv"] != want_wkv:
            raise AssertionError(f"WKV launches {launches['wkv']} != "
                                 f"{want_wkv}")
        # one T=256 call per layer and prefill chunk, one read-only T=6
        # verify and one T=6 advance per layer and step
        steps_n = cfg.num_layers * stats["steps"]
        want_shapes = {"prefill T=256": cfg.num_layers * chunks,
                       "verify T=6": steps_n, "advance T=6": steps_n}
        if sum(by_shape.values()) != want_wkv or by_shape != want_shapes:
            raise AssertionError(f"WKV launches by shape {by_shape} != "
                                 f"{want_shapes}")
        if graphs and set(eng._graphs) != {("prefill", 256), "state"}:
            raise AssertionError(f"graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        launches["wkv_shapes"] = by_shape
        if toks.shape != (1, n_new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"tokens out of range: {toks}")
        # the eager window is host-bound and even: 3 steps and no
        # profiled eager prefill (32 chunks of every layer's ops)
        prof = profile_steps(torch, card, eng, prompt, kernel="wkv_kernel",
                             label=label, steps=6 if graphs else 3,
                             prefill=graphs)
        if not graphs:
            check_sync_free(torch, card, eng, prompt[:, :SYNC_CHECK_PROMPT])
        runs[label] = dict(toks=toks, launches=launches, wall_s=wall,
                           tokens_per_s=n_new / wall,
                           prefill_s=stats["prefill_s"], peak_gib=peak,
                           capture_s=eng.capture_s, **prof)
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, "rwkv6-3b", runs)
    del params, dparams
    torch.cuda.empty_cache()
    rwkv_lossless(torch, card)
    g = runs["graphs"]
    # the unsharded figures phase 22 reports beside its split run
    g["launches"]["graph_run"] = dict(
        toks=g["toks"][0].tolist(), source="phase 5", layers=cfg.num_layers,
        **{k: g[k] for k in ("busy_ms_step", "device_launches_step",
                             "host_launch_calls_step", "peak_gib")})
    return g["launches"]


def rwkv_lossless(torch, card, prompt_len: int = 1024, new_tokens: int = 32):
    """fp32, 4 layers at full width: chain-speculation ``generate`` equals
    the port's autoregressive decoding (one read-only decode and one
    advance per token).  ``u``, ``lora_B`` and ``wd_B``, zero in the
    reference's init, get random values so every term of the recurrence
    and the data-dependent lerp and decay runs."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models.api import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("rwkv6-3b").replace(num_layers=4, dtype="float32",
                                         param_dtype="float32")
    spec = SpecPVConfig()
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for lp in params["layers"]:
        for name, scale in (("u", 0.5), ("lora_B", 0.1), ("wd_B", 0.1)):
            lp[name] = torch.randn(lp[name].shape, generator=gen,
                                   device="cuda") * scale
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int64)
    max_len = request_token_need(prompt_len, new_tokens, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    t0 = time.perf_counter()
    ar = autoregressive_generate(cfg, params, prompt, new_tokens,
                                 max_len=max_len, spec=spec, device="cuda")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, paged=False, device="cuda")
    toks, st = eng.generate(prompt, new_tokens)
    if set(eng._graphs) != {("prefill", 256), "state"}:
        raise AssertionError(f"graphs: {sorted(map(str, eng._graphs))}")
    if not np.array_equal(toks, ar):
        raise AssertionError(f"rwkv6-3b chain SpecPV differs from AR:\n"
                             f"{toks}\n{ar}")
    say(card, f"lossless rwkv6-3b x4 layers fp32, graphs: chain generate == "
              f"AR over {new_tokens} tokens of a {prompt_len}-token prompt "
              f"(steps "
              f"{st['steps']}, mean_accept {st['mean_accept']:.4f}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: continuous-batching serving at full width
# ---------------------------------------------------------------------------

# six requests arriving together (prompt tokens, new tokens): two under
# the 4480-token partial budget, four over it.  With random weights no
# draft token is accepted, so equal budgets would finish on one tick and
# no slot would ever free while the pool is short: the shortest request
# asks for 32 tokens, so its slot frees while the 8192-token waiters
# cannot fit (page stalls)
SERVE_REQS = ((2048, 32), (3072, 64), (4608, 64), (6144, 64), (8192, 64),
              (8192, 64))
SERVE_MAX_LEN = 8448                # 66 blocks of 128
SERVE_PAGES = 161                   # the first four fit, an 8192 does not


def _serve(torch, srv, reqs):
    """Run ``reqs`` through ``srv`` with every launch count set to 0 just
    before and read just after.  Returns (outputs by id, wall s, launch
    counts, peak GiB)."""
    from repro_torch.kernels import ops
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    outs = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {o.request_id: o for o in outs}, wall, launches, peak


def _expected_serving_launches(eng, layers):
    """K1-K4 launches implied by the engine's steps and prefill chunks
    (``_implied_launches``)."""
    return _implied_launches(eng.dispatch_keys, eng.prefill_dispatches,
                             layers)


def _implied_launches(keys, chunks, layers):
    """K1-K4 launches implied by steps counted by variant (``keys``) and
    ``chunks`` prefill chunks: per step K1 once per layer for each context
    source (full pages, routed partial), K3 once per layer with a Refresh
    row, K4 once with a committing (Full or Refresh) row; per chunk K2
    once per layer and K4 once over all layers.  Sampling and chain
    masking launch no kernel (a key's last two flags)."""
    k1 = k3 = k4 = 0
    for key, n in keys.items():
        has_full, has_partial, has_refresh = key[:3]
        k1 += layers * n * (int(has_full) + int(has_partial))
        k3 += layers * n * int(has_refresh)
        k4 += n * int(has_full)
    return {"sparse_verify_attention": k1,
            "paged_prefill_attention": layers * chunks,
            "retrieval_score": k3, "block_summary": k4 + chunks}


def _prefill_graph_keys(eng, chunk=256):
    """The graphs of the slot prefill chunks that ran at full width, one
    per row count (``SpecPVEngine.prefill_keys``)."""
    return {("fused_prefill", k, t) for k, t in eng.prefill_keys
            if t == chunk}


def _serving_requests(prompts, reqs_spec, kinds=((0.0, "tree"),)):
    """Requests arriving now; request i is of kind ``kinds[i % len]``,
    (temperature, draft), with seed i."""
    from repro_torch.serving import Request
    now = time.time()
    return [Request(request_id=f"r{i}", prompt=p, max_new_tokens=new,
                    arrival_s=now, temperature=kinds[i % len(kinds)][0],
                    seed=i, draft=kinds[i % len(kinds)][1])
            for i, (p, (_, new)) in enumerate(zip(prompts, reqs_spec))]


# phase 6's eager arm serves these requests alone (the two shortest
# prompts with fewer new tokens: the whole trace took about 32 s eagerly,
# these 96 tokens 11-12 s), and the graph server serves them again after
# its full run, for the eager-against-graphs identity
SERVE_EAGER = ((2048, 8), (3072, 16))


def phase_serving(torch, card):
    """Continuous batching of llama3.1-8b at full width (random bf16
    weights, batch 4, a 161-page pool, no prefix sharing): the six
    ``SERVE_REQS`` with graphs, then the two shortest again with graphs
    and eagerly (equal tokens and launch counts), then each request
    alone through batch-1 ``generate`` (matches reported: bf16 rows are
    not batch-invariant); a profiled window of decode ticks; the serving
    bodies under the sync check; fp32 losslessness at 4 layers."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine
    # earlier phases' engines hold their graph pools until the cyclic
    # collector runs (phase 10's finding)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    torch.cuda.synchronize()
    say(card, f"serving: llama3.1-8b random weights ready in "
              f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    scfg = ServingConfig(batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
                         num_pages=SERVE_PAGES, paged_kv=True,
                         zero_copy_partial=True, prefix_cache=False)
    runs, short = {}, {}
    few = SERVE_EAGER
    for graphs in (True, False):
        label = RUN_LABEL[graphs]
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, scfg,
                            device="cuda", cuda_graphs=graphs)
        if not graphs:
            outs, wall, launches, peak = _serve(
                torch, srv, _serving_requests(prompts, few))
            eng = srv._continuous.engine
            ntok = int(sum(len(o.tokens) for o in outs.values()))
            want = _expected_serving_launches(eng, cfg.num_layers)
            got = {k: launches[k] for k in want}
            if got != want or eng.page_stats()["in_use"]:
                raise AssertionError(f"eager serving launches {got} != "
                                     f"{want} or pages left")
            say(card, f"serving llama3.1-8b [eager] the {len(few)} "
                      f"shortest requests {[n for n, _ in few]}: tokens "
                      f"{ntok} wall_s {wall:.3f} tokens_per_s "
                      f"{ntok / wall:.2f} peak_mem_gib {peak:.2f} launches "
                      f"{got}")
            short["eager"] = dict(toks={k: o.tokens for k, o in outs.items()},
                                  launches=got, tokens_per_s=ntok / wall)
            runs[label] = dict(tokens_per_s=ntok / wall, wall_s=wall,
                               peak_gib=peak)
            del srv, eng
            torch.cuda.empty_cache()
            continue
        outs, wall, launches, peak = _serve(
            torch, srv, _serving_requests(prompts, SERVE_REQS))
        sched = srv._continuous
        eng = sched.engine
        st = srv.stats
        st_full = dict(st)          # the short rerun below resets srv.stats
        need = [eng.pages_needed(n, new) for n, new in SERVE_REQS]
        if sum(need[:4]) > eng.page_capacity() or \
                sum(need[:4]) + need[4] <= eng.page_capacity():
            raise AssertionError(f"pool of {SERVE_PAGES} pages: the first "
                                 f"four requests ({need[:4]}) must fit and "
                                 f"a fifth ({need[4]}) must not")
        toks = {k: o.tokens for k, o in outs.items()}
        for i, (n, new) in enumerate(SERVE_REQS):
            o = outs[f"r{i}"]
            if (o.finish_reason != "length" or len(o.tokens) != new
                    or o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"request r{i}: {o.finish_reason}, "
                                     f"{len(o.tokens)} tokens")
        ps = eng.page_stats()
        if not st["page_stalls"] > 0:
            raise AssertionError("no admission stalled on pages")
        if ps["pinned_pages"] or ps["in_use"] or ps["draft_in_use"]:
            raise AssertionError(f"pages left after the run: {ps}")
        if not (st["mode_rows_refresh"] and st["mode_rows_partial"]
                and st["mode_rows_full"] and st.get("ticks_modes_2")):
            raise AssertionError(f"the ticks must mix Full, Refresh and "
                                 f"Partial rows: {dict(st)}")
        want = _expected_serving_launches(eng, cfg.num_layers)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"serving launches {got} != {want} implied "
                                 f"by {eng.dispatch_keys} and "
                                 f"{eng.prefill_dispatches} prefill chunks")
        lat = np.array([o.latency_s for o in outs.values()])
        ntok = int(sum(len(t) for t in toks.values()))
        # a class's first tick may include its graph's capture: the median
        # leaves it out
        ticks = {c: (len(v), 1e3 * float(np.median(v)),
                     1e3 * float(np.mean(v)))
                 for c, v in sched.tick_wall.items()}
        say(card, f"serving llama3.1-8b [{label}] batch 4, {SERVE_PAGES} "
                  f"pages, requests {[n for n, _ in SERVE_REQS]}: answered "
                  f"{len(outs)} tokens {ntok} wall_s {wall:.3f} "
                  f"tokens_per_s {ntok / wall:.2f} latency_s p50 "
                  f"{np.percentile(lat, 50):.3f} p95 "
                  f"{np.percentile(lat, 95):.3f} steps {int(st['steps'])} "
                  f"prefill chunks {eng.prefill_dispatches} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))}")
        say(card, f"serving [{label}] tick wall ms by class (ticks: median, "
                  f"mean): " + ", ".join(
                      f"{c} {n}: {med:.2f}, {mean:.2f}"
                      for c, (n, med, mean) in sorted(ticks.items())))
        memory_line(torch, card, f"serving {label}", eng, params, dparams,
                    peak)
        say(card, f"serving [{label}] " + " ".join(
            f"{k} {int(v)}" for k, v in sorted(st.items())
            if k.startswith(("mode_rows_", "ticks_modes_"))
            or k in ("page_stalls", "admissions")))
        say(card, f"serving [{label}] page_stats {ps} variants "
                  f"{ {str(k): n for k, n in eng.dispatch_keys.items()} }")
        say(card, f"serving [{label}] launches {got} == implied by the "
                  f"steps' variants and {eng.prefill_dispatches} chunks")
        if graphs:
            want_graphs = _prefill_graph_keys(eng) | set(eng.dispatch_keys)
            if set(eng._graphs) != want_graphs:
                raise AssertionError(f"graphs {sorted(map(str, eng._graphs))}"
                                     f" != {sorted(map(str, want_graphs))}")
            prof = profile_ticks(torch, card, srv, prompts)
            check_sync_free_serving(torch, card, eng, prompts)
            srv.reset_warm()
            outs2, _, launches2, _ = _serve(
                torch, srv, _serving_requests(prompts, few))
            short["graphs"] = dict(
                toks={k: o.tokens for k, o in outs2.items()},
                launches={k: launches2[k] for k in got})
        runs[label] = dict(toks=toks, launches=got, wall_s=wall,
                           tokens_per_s=ntok / wall, peak_gib=peak,
                           ticks=ticks, stats=st_full, pages=ps,
                           p50=float(np.percentile(lat, 50)),
                           p95=float(np.percentile(lat, 95)),
                           capture_s=eng.capture_s)
        if graphs:
            runs[label].update(prof)
        del srv, sched, eng
        torch.cuda.empty_cache()
    g = runs["graphs"]
    sg, se = short["graphs"], short["eager"]
    for rid in se["toks"]:
        if not np.array_equal(sg["toks"][rid], se["toks"][rid]):
            raise AssertionError(f"serving {rid}: graph tokens differ from "
                                 f"eager")
    if sg["launches"] != se["launches"]:
        raise AssertionError(f"serving launches: graphs {sg['launches']} "
                             f"eager {se['launches']}")
    say(card, f"serving: over the {len(few)} shortest requests graph tokens "
              f"== eager tokens for every request, launch counts equal "
              f"(eager {se['tokens_per_s']:.2f} tokens/s)")
    # each request alone through batch-1 generate on one engine
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=SERVE_MAX_LEN, paged=True, zero_copy=True,
                        device="cuda")
    match, first_diff = 0, {}
    for i, ((n, new), p) in enumerate(zip(SERVE_REQS, prompts)):
        t, _ = solo.generate(p[None], new)
        d = np.nonzero(t[0] != g["toks"][f"r{i}"])[0]
        if d.size:
            first_diff[f"r{i}"] = int(d[0])
        else:
            match += 1
    say(card, f"serving bf16 vs solo batch-1 generate: {match} of "
              f"{len(SERVE_REQS)} requests equal; first diverging position "
              f"{first_diff} (not asserted: cuBLAS picks its GEMM by the row "
              f"count and the split-KV count depends on B)")
    del solo
    torch.cuda.empty_cache()
    del params, dparams
    torch.cuda.empty_cache()
    serving_lossless(torch, card)
    g["solo_match"] = match
    return g


def profile_ticks(torch, card, srv, prompts, warm: int = 3, ticks: int = 3):
    """A fresh scheduler on the graph run's engine with four requests of
    4608 tokens (the first 4608 of prompts 2-5; 4 x 38 pages fit): the
    first tick admits them (blocking prefill) and refreshes every row, then
    after ``warm`` Partial ticks ``ticks`` more on the host clock and
    ``ticks`` more under ``torch.profiler``: device busy ms, device
    launches, host launch calls and device time by kernel per batch-4
    Partial tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import ContinuousScheduler
    eng = srv._engine_for(srv.scfg.batch, paged=True)
    sched = ContinuousScheduler(eng, prefill_chunk=srv.scfg.prefill_chunk)
    four = [p[:4608] for p in prompts[2:6]]
    for r in _serving_requests(four, [(4608, 64)] * 4):
        sched.submit(r)
    for _ in range(1 + warm):
        sched.tick()
    torch.cuda.synchronize()
    parts0 = sched.stats["mode_rows_partial"]
    t0 = time.perf_counter()
    for _ in range(ticks):
        sched.tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            sched.tick()
        torch.cuda.synchronize()
    if sched.stats["mode_rows_partial"] - parts0 != 2 * ticks * 4:
        raise AssertionError(f"the profiled ticks must be batch-4 Partial "
                             f"ticks: {dict(sched.stats)}")
    busy, span = _device_busy(prof)
    dev_n, host_n, calls_n = _launch_counts(prof)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _dev_us(e) > 0]
    for e in sorted(kernels, key=_dev_us, reverse=True)[:10]:
        say(card, f"serving profile   {_dev_us(e) / 1e3 / ticks:8.3f} "
                  f"ms/tick {e.count // ticks:5d} launches/tick  "
                  f"{e.key[:80]}")
    say(card, f"serving profile: {ticks} batch-4 Partial ticks (4 x 4608 "
              f"tokens): unprofiled wall_ms/tick {wall_ms:.2f}; device "
              f"busy_ms/tick {busy / ticks:.2f} idle_share_unprofiled "
              f"{1 - busy / ticks / wall_ms:.3f} device launches/tick "
              f"{dev_n / ticks:.1f} host launch calls/tick "
              f"{calls_n / ticks:.1f} top-level host aten ops/tick "
              f"{host_n / ticks:.1f}")
    return dict(tick_wall_ms=wall_ms, tick_busy_ms=busy / ticks,
                tick_host_launch_calls=calls_n / ticks,
                tick_device_launches=dev_n / ticks)


def _no_sync(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _eager_prefill_round(torch, eng, st, cursors):
    """One ``prefill_step_fused`` round with its body run eagerly (a graph
    engine's ``_run`` replays otherwise) under the sync check: staging,
    body, copies out and block registration."""
    graphs, eng.cuda_graphs = eng.cuda_graphs, False
    try:
        return _no_sync(torch, lambda: eng.prefill_step_fused(st, cursors))
    finally:
        eng.cuda_graphs = graphs


def check_sync_free_serving(torch, card, eng, prompts):
    """On the serving engine: a slot prefill round of one cursor (staging,
    body and copies out), then with two slots decoding and two empty each
    step variant's body with the row mask [1, 1, 0, 0] (an empty slot
    among the masked rows), run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.core.engine import MODE_IDS
    st = eng.empty_state()
    st, cur = eng.prefill_begin_slot(st, 0, prompts[0], max_new_tokens=32)
    st, _ = _eager_prefill_round(torch, eng, st, [cur])
    while not cur.done:
        st, _ = eng.prefill_step_into_slot(st, cur)
    st, _ = eng.prefill_finalize_slot(st, cur)
    st, _ = eng.prefill_into_slot(st, 1, prompts[1], max_new_tokens=32)
    labels = ["slot prefill chunk"]
    for label, modes, key in (
            ("full", ["full"] * 2, (True, False, False)),
            ("refresh", ["refresh"] * 2, (True, False, True)),
            ("partial", ["partial"] * 2, (False, True, False)),
            ("partial + refresh", ["partial", "refresh"], (True, True, True))):
        eng._tick_in[:2].copy_(torch.tensor(      # modes, rows (no chain)
            [[MODE_IDS[m] for m in modes] + [0, 0], [1, 1, 0, 0]],
            dtype=torch.int8, device="cuda"))
        _no_sync(torch, lambda key=key: eng._fused_body(*key))
        labels.append(f"{label} rows [1, 1, 0, 0]")
    torch.cuda.synchronize()
    say(card, f"serving sync check: the {', '.join(labels)} bodies ran "
              f"eagerly under set_sync_debug_mode('error') without a sync")


PAGED_ZERO_COPY = dict(paged=True, zero_copy=True)


def serving_lossless(torch, card, layers: int = 4, new: int = 32,
                     layout=PAGED_ZERO_COPY):
    """fp32 at full width, ``layers`` layers: batch 2, three requests (one
    under the partial budget, two over), ``prefill_budget=512``
    (interleaved, the serial pump: phase 9 holds the fused one), with
    graphs: every request equals its solo batch-1
    ``generate`` and a blocking run of the same trace, on the engine
    ``layout`` gives."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=layers,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    spec_reqs = ((3000, new), (4800, new), (5300, new))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in spec_reqs]
    max_len = 5632
    toks = {}
    for budget in (512, None):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                            ServingConfig(
                                batch=2, max_len=max_len,
                                prefill_budget=budget,
                                fused_prefill=False,
                                paged_kv=layout["paged"],
                                zero_copy_partial=layout["zero_copy"],
                                prefix_cache=False), device="cuda")
        for r in _serving_requests(prompts, spec_reqs):
            srv.submit(r)
        srv.run()
        toks[budget] = {k: o.tokens for k, o in srv.outputs.items()}
        modes = {k: int(v) for k, v in srv.stats.items()
                 if k.startswith("mode_rows_")}
        if budget == 512 and not srv.stats["prefill_dispatches"]:
            raise AssertionError("the interleaved run pumped no chunk")
        del srv
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda", **layout)
    for i, p in enumerate(prompts):
        t, _ = solo.generate(p[None], new)
        for budget, label in ((512, "interleaved"), (None, "blocking")):
            if not np.array_equal(toks[budget][f"r{i}"], t[0]):
                raise AssertionError(f"fp32 serving r{i} ({label}) differs "
                                     f"from solo generate:\n"
                                     f"{toks[budget][f'r{i}']}\n{t[0]}")
    say(card, f"serving lossless llama3.1-8b x{layers} layers fp32, graphs, "
              f"{layout}, batch 2, prompts {[n for n, _ in spec_reqs]}: "
              f"interleaved "
              f"(prefill_budget 512) == blocking == solo generate for every "
              f"request over {new} tokens (mode rows {modes}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, solo
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: serving with shared prefixes
# ---------------------------------------------------------------------------

# the traffic of bench_serving.py --prefix-share: two 6144-token system
# prompts (48 blocks), request i one of them (same-system pairs) plus its
# own 500-token tail, so 6644 tokens: 51 full blocks and a 116-token tail
# block; a ninth request repeats the first prompt.  By request_token_need
# a request needs 54 pages cold and 6 fresh behind a 48-block match, so
# 128 allocatable pages hold two requests without sharing and four with
# 32 new tokens: 64 kept the same 54 pages a request and only added decode
# ticks (slice 22's cut)
PREFIX_SYS, PREFIX_TAIL, PREFIX_N, PREFIX_NEW = 6144, 500, 8, 32
PREFIX_PAGES = 129


class _StampedTrace(list):
    """A scheduler trace that also records the host time of each event:
    a blocking admission appends its "admit" once its prefill finalised
    and its first token reached the host."""

    def __init__(self):
        super().__init__()
        self.t = []

    def append(self, ev):
        super().append(ev)
        self.t.append(time.time())


def _prefix_prompts(np, vocab, n_sys=PREFIX_SYS, tail=PREFIX_TAIL,
                    n=PREFIX_N, seed=0, repeat=True):
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab, (n_sys,)).astype(np.int64)
               for _ in range(2)]
    prompts = [np.concatenate([systems[(i // 2) % 2],
                               rng.integers(0, vocab, (tail,))])
               for i in range(n)]
    if repeat:
        prompts.append(prompts[0].copy())
    return prompts


def _timed(eng, name, log):
    """Wrap the engine method `name` to add its host seconds and calls to
    ``log[name]``."""
    fn = getattr(eng, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        s, n = log.get(name, (0.0, 0))
        log[name] = (s + time.perf_counter() - t0, n + 1)
        return out
    setattr(eng, name, wrapped)


def phase_prefix_serving(torch, card):
    """The shared-prefix cell: the nine ``_prefix_prompts`` served at
    batch 4 on a 129-page pool with graphs, with prefix sharing and
    without, in this call (see the module docstring), then the fork check
    and the fp32 losslessness.  Returns the shared run's numbers."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.kernels import ops
    from repro_torch.models.api import init_params
    from repro_torch.serving import (ContinuousScheduler, Request,
                                     ServingConfig, ServingEngine)
    # earlier phases' engines hold their graph pools until the cyclic
    # collector runs (phase 10's finding)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    prompts = _prefix_prompts(np, cfg.vocab_size)
    runs = {}
    for share in (True, False):
        label = "shared" if share else "unshared"
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
            num_pages=PREFIX_PAGES, paged_kv=True, zero_copy_partial=True,
            prefix_cache=share), device="cuda")
        eng = srv._engine_for(4, paged=True)
        cold = eng.pages_needed(len(prompts[0]), PREFIX_NEW)
        cap = eng.page_capacity()
        if not (2 * cold <= cap < 3 * cold
                and 2 * cold + 2 * (cold - PREFIX_SYS // 128) <= cap):
            raise AssertionError(f"pool of {PREFIX_PAGES} pages: two cold "
                                 f"requests ({cold} pages each) must fit, a "
                                 f"third must not, and two shared pairs must")
        host = {}
        for name in ("_register_blocks", "_register_tail",
                     "_attach_tail_slot", "prepare_cow"):
            _timed(eng, name, host)
        sched = ContinuousScheduler(eng, prefill_chunk=256)
        sched.trace = _StampedTrace()
        srv._continuous = sched
        now = time.time()
        reqs = [Request(request_id=f"p{i}", prompt=p,
                        max_new_tokens=PREFIX_NEW, arrival_s=now)
                for i, p in enumerate(prompts)]
        outs, wall, launches, peak = _serve(torch, srv, reqs)
        st, ps, pre = srv.stats, eng.page_stats(), srv.prefix_stats()
        for rid, o in outs.items():
            if (o.finish_reason != "length" or len(o.tokens) != PREFIX_NEW
                    or o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"{label} {rid}: {o.finish_reason}, "
                                     f"{len(o.tokens)} tokens")
        want = _expected_serving_launches(eng, cfg.num_layers)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{label} launches {got} != {want} implied "
                                 f"by {eng.dispatch_keys} and "
                                 f"{eng.prefill_dispatches} prefill chunks")
        if eng.cuda_graphs and set(eng._graphs) != _prefill_graph_keys(
                eng) | set(eng.dispatch_keys):
            raise AssertionError(f"{label} graphs "
                                 f"{sorted(map(str, eng._graphs))}")
        if ps["committed"] or ps["pinned_pages"] or (
                ps["in_use"] != ps["idle"]):
            raise AssertionError(f"{label}: pages committed or pinned after "
                                 f"the run: {ps}")
        idle_left = ps["idle"]
        chunk_ms = (_short_chunk_cost(torch, card, eng, prompts) if share
                    else None)
        eng.empty_state()               # the engine's reset frees them
        if eng.page_stats()["in_use"] or eng.page_stats()["draft_in_use"]:
            raise AssertionError(f"{label}: pages left after the reset")
        if not share and idle_left:
            raise AssertionError("unshared run left idle pages")
        ttft = {rid: t - now for (ev, rid, _), t in
                zip(sched.trace, sched.trace.t) if ev == "admit"}
        lat = np.array([o.latency_s for o in outs.values()])
        tt = np.array(list(ttft.values()))
        ntok = int(sum(len(o.tokens) for o in outs.values()))
        runs[label] = dict(
            toks={k: o.tokens for k, o in outs.items()}, launches=got,
            wall_s=wall, tokens_per_s=ntok / wall, peak_gib=peak,
            ttft_p50=float(np.percentile(tt, 50)),
            ttft_p95=float(np.percentile(tt, 95)),
            p50=float(np.percentile(lat, 50)),
            p95=float(np.percentile(lat, 95)),
            stats=dict(st), pages=ps, prefix=pre, idle_left=idle_left,
            chunks=eng.prefill_dispatches, host=host, chunk_ms=chunk_ms,
            capture_s=eng.capture_s)
        say(card, f"prefix serving [{label}] llama3.1-8b batch 4, "
                  f"{PREFIX_PAGES} pages, {len(prompts)} requests of "
                  f"{len(prompts[0])} tokens (2 system prompts of "
                  f"{PREFIX_SYS}): tokens {ntok} wall_s {wall:.3f} "
                  f"tokens_per_s {ntok / wall:.2f} ttft_s p50 "
                  f"{runs[label]['ttft_p50']:.3f} p95 "
                  f"{runs[label]['ttft_p95']:.3f} latency_s p50 "
                  f"{runs[label]['p50']:.3f} p95 {runs[label]['p95']:.3f} "
                  f"steps {int(st['steps'])} prefill chunks "
                  f"{eng.prefill_dispatches} peak decoding rows "
                  f"{int(st['peak_active'])} page_stalls "
                  f"{int(st.get('page_stalls', 0))} prefix_evictions "
                  f"{int(st.get('prefix_evictions', 0))} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f}")
        say(card, f"prefix serving [{label}] prefix_stats {pre}")
        say(card, f"prefix serving [{label}] pages: high_water "
                  f"{ps['high_water']} resident_high_water "
                  f"{ps['resident_high_water']} draft_high_water "
                  f"{ps['draft_high_water']} draft resident "
                  f"{eng._draft_alloc.resident_high_water}; idle cached "
                  f"pages left {idle_left}, 0 after the engine's reset")
        say(card, f"prefix serving [{label}] launches {got} == implied by "
                  f"the steps' variants {eng.dispatch_keys} and "
                  f"{eng.prefill_dispatches} chunks (short ones eager)")
        say(card, f"prefix serving [{label}] host s, calls: " + ", ".join(
            f"{k} {v[0]:.4f} {v[1]}" for k, v in sorted(host.items())))
        del srv, sched, eng
        torch.cuda.empty_cache()
    sh, un = runs["shared"], runs["unshared"]
    skipped = sh["prefix"]["prefill_tokens_skipped"]
    if skipped < 6 * PREFIX_SYS:
        raise AssertionError(f"sharing skipped {skipped} prompt tokens, "
                             f"fewer than {6 * PREFIX_SYS}")
    if not (sh["stats"]["peak_active"] == 4
            and un["stats"]["peak_active"] <= 2):
        raise AssertionError(f"decoding at once: shared "
                             f"{sh['stats']['peak_active']}, unshared "
                             f"{un['stats']['peak_active']}")
    if not (sh["stats"].get("page_stalls", 0)
            < un["stats"].get("page_stalls", 0)):
        raise AssertionError("sharing did not stall less")
    hit = sh["prefix"]["tail_hits"] > 0
    same = sum(np.array_equal(sh["toks"][k], un["toks"][k])
               for k in sh["toks"])
    say(card, f"prefix serving: shared skipped {skipped} prompt tokens "
              f"(>= {6 * PREFIX_SYS}), decoded 4 at once against "
              f"{int(un['stats']['peak_active'])}, page stalls "
              f"{int(sh['stats'].get('page_stalls', 0))} < "
              f"{int(un['stats'].get('page_stalls', 0))}; request p8 (p0's "
              f"prompt) was a "
              f"{'tail-entry hit' if hit else 'chain match (the tail entry was evicted)'}; "
              f"bf16 shared vs unshared tokens: {same} of {len(prompts)} "
              f"requests equal (not asserted)")
    sh["fork"] = fork_check(torch, card, cfg, spec, dcfg, params, dparams)
    del params, dparams
    torch.cuda.empty_cache()
    prefix_lossless(torch, card)
    say(card, f"prefix serving phase: {time.perf_counter() - t_phase:.1f} s")
    return sh


def _short_chunk_cost(torch, card, eng, prompts):
    """Wall ms (synchronised) of the slot-prefill chunks after a match, on
    the shared run's drained engine: a prompt behind the 48-block system
    prompt runs a replayed 256-token chunk, then its short 244-token last
    chunk eagerly; one matching 49 blocks starts with a 128-token chunk
    that ends inside a chunk, run eagerly."""
    import numpy as np
    rng = np.random.default_rng(5)
    out = {}
    for label, prompt in (
            ("48-block match", np.concatenate(
                [prompts[0][:PREFIX_SYS],
                 rng.integers(0, eng.cfg.vocab_size, (PREFIX_TAIL,))])),
            ("49-block match", np.concatenate(
                [prompts[8][:49 * 128],
                 rng.integers(0, eng.cfg.vocab_size, (PREFIX_TAIL,))]))):
        st, cur = eng.prefill_begin_slot(eng.state, 0, prompt,
                                         max_new_tokens=8)
        if cur.n_match * 128 != cur.off or not cur.n_match:
            raise AssertionError(f"{label}: matched {cur.n_match} blocks")
        mine = []
        while not cur.done:
            n = cur.next_tokens
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = eng.prefill_step_into_slot(st, cur)
            torch.cuda.synchronize()
            key = f"{n} tokens ({'graph' if n == 256 else 'eager'})"
            mine.append((key, (time.perf_counter() - t0) * 1e3))
            out.setdefault(key, []).append(mine[-1][1])
        say(card, f"prefix serving chunks after a {label}: " + ", ".join(
            f"{k} {ms:.2f} ms" for k, ms in mine))
        eng.reset_slot(st, 0)
    return {k: float(np.median(v)) for k, v in out.items()}


def _pool_pages(cache, pages, draft):
    """A copy of the pool keys' bytes at `pages` (trunk: every layer)."""
    import torch
    idx = torch.as_tensor(pages, device=cache["k"].device)
    keys = ("k", "v") if draft else ("k", "v", "kmax", "kmin")
    return {k: (cache[k][idx] if draft else cache[k][:, idx]).clone()
            for k in keys}


def fork_check(torch, card, cfg, spec, dcfg, params, dparams,
               prompt_len: int = 4700, new: int = 40):
    """Fork at full width, with graphs and eagerly: admit one request of
    `prompt_len` tokens (over the partial budget) into slot 0 of a
    batch-2 engine, step it three ticks, ``fork_slot`` it into slot 1,
    copy-on-write by hand (``prepare_cow``, under the sync check on the
    eager engine, held bit for bit to a plain per-page copy), then step
    both rows four ticks.  The fork's tokens equal the source's, the
    source's equal a run of the same engine with no fork, both pools got
    copies, and every page the rows still share keeps its bytes of the
    fork point.  Returns the host ms and device launches of one copying
    ``prepare_cow``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, (prompt_len,))
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    toks_by = {}
    cost = {}
    for graphs in (True, False):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=2,
                           max_len=max_len, paged=True, zero_copy=True,
                           device="cuda", cuda_graphs=graphs)
        al, dal = eng._page_alloc, eng._draft_alloc

        def run(fork):
            st = eng.empty_state()
            st, first = eng.prefill_into_slot(st, 0, prompt,
                                              max_new_tokens=new)
            toks = {0: [first], 1: []}

            def step(rows):
                nonlocal st
                rows = np.asarray(rows, bool)
                st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
                for i in np.nonzero(rows)[0]:
                    toks[int(i)].extend(int(x) for x in
                                        so.tokens[i, :so.counts[i]])
            for _ in range(3):
                step([1, 0])
            if not fork:
                for _ in range(4):
                    step([1, 0])
                return toks, None
            st = eng.fork_slot(st, 0, 1)
            at = len(toks[0])
            pages, dpages = al.pages_of(0), dal.pages_of(0)
            snap = (_pool_pages(st.cache, pages, False),
                    _pool_pages(st.dcache, dpages, True))
            # the copy-on-write of the next tick, by hand: the copied pages
            # must hold the bytes of their sources, every other page keeps
            # its own
            before = ({k: st.cache[k].clone() for k in
                       ("k", "v", "kmax", "kmin")},
                      {k: st.dcache[k].clone() for k in ("k", "v")})
            pt0 = (st.cache["page_table"].clone(),
                   st.dcache["page_table"].clone())
            torch.cuda.synchronize()
            if graphs:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    eng.prepare_cow(st, np.array([True, True]))
                    torch.cuda.synchronize()
                cost["prepare_cow_device_launches"] = _launch_counts(prof)[0]
            else:
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    eng.prepare_cow(st, np.array([True, True]))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                cost["prepare_cow_ms"] = (time.perf_counter() - t0) * 1e3
            for old, pt, draft in ((before[0], pt0[0], False),
                                   (before[1], pt0[1], True)):
                cache = st.dcache if draft else st.cache
                moved = (cache["page_table"] != pt).nonzero().tolist()
                if not moved:
                    raise AssertionError(f"prepare_cow copied no "
                                         f"{'draft' if draft else 'trunk'} "
                                         f"page")
                news = {int(cache["page_table"][r, c]): int(pt[r, c])
                        for r, c in moved}
                for k, a in old.items():
                    want = a.clone()
                    for new_p, old_p in news.items():
                        if draft:
                            want[new_p] = a[old_p]
                        else:
                            want[:, new_p] = a[:, old_p]
                    if not torch.equal(cache[k], want):
                        raise AssertionError(f"prepare_cow {k}: not the "
                                             f"plain per-page copy")
            del before
            for _ in range(4):
                step([1, 1])
            if toks[1] != toks[0][at:]:
                raise AssertionError(f"fork tokens {toks[1]} != source "
                                     f"{toks[0][at:]}")
            for cur, old, draft, al_ in ((st.cache, snap[0], False, al),
                                         (st.dcache, snap[1], True, dal)):
                src_pages = (dpages if draft else pages)
                both = set(al_.pages_of(0)) & set(al_.pages_of(1))
                now = _pool_pages(cur, sorted(both), draft)
                pos = [src_pages.index(p) for p in sorted(both)]
                for k, v in now.items():
                    was = old[k][pos] if draft else old[k][:, pos]
                    if not torch.equal(v, was):
                        raise AssertionError(f"a page both rows share was "
                                             f"written after the fork ({k})")
            copies = dict(eng.cow_copies)
            if not (copies["trunk"] and copies["draft"]):
                raise AssertionError(f"copy-on-write copies {copies}")
            left = tuple(len(set(a.pages_of(0)) & set(a.pages_of(1)))
                         for a in (al, dal))
            return toks, (copies, left)
        forked, info = run(True)
        alone, _ = run(False)
        if forked[0] != alone[0]:
            raise AssertionError("the source's tokens differ from a run "
                                 "with no fork")
        toks_by[graphs] = forked
        say(card, f"fork [{RUN_LABEL[graphs]}] llama3.1-8b batch 2, "
                  f"{prompt_len}-token prompt: fork tokens == source tokens "
                  f"over 4 ticks, source == no-fork run, copy-on-write pages "
                  f"{info[0]} (bit-equal to a plain per-page copy), the "
                  f"{info[1][0]} trunk and {info[1][1]} draft pages still "
                  f"shared kept their bytes")
        del eng
        torch.cuda.empty_cache()
    if toks_by[True] != toks_by[False]:
        raise AssertionError("fork: graph tokens differ from eager")
    say(card, f"fork: graph tokens == eager tokens; one copying prepare_cow "
              f"(both rows): {cost['prepare_cow_device_launches']} device "
              f"launches in the profiler (graphs engine); "
              f"{cost['prepare_cow_ms']:.3f} ms until synchronised, no sync "
              f"under set_sync_debug_mode('error') (eager engine)")
    return cost


def prefix_lossless(torch, card, layers: int = 4, new: int = 32):
    """fp32 at full width, ``layers`` layers, with graphs: batch 4, two
    1536-token system prompts (12 blocks) and six requests with 116-token
    tails, interleaved prefill (``prefill_budget=512``, the serial pump:
    phase 9 holds the fused one) so that paired
    cold cursors race and dedup: every request equals its solo batch-1
    ``generate`` and its tokens with sharing off."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=layers,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    t0 = time.perf_counter()
    prompts = _prefix_prompts(np, cfg.vocab_size, n_sys=1536, tail=116, n=6,
                              seed=3, repeat=False)
    max_len = 2048
    toks, pre = {}, {}
    host = {}
    for share in (True, False):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=4, max_len=max_len, prefill_budget=512,
            fused_prefill=False, paged_kv=True,
            zero_copy_partial=True, prefix_cache=share), device="cuda")
        if share:
            eng = srv._engine_for(4, paged=True)
            for name in ("_register_blocks", "_dedupe_block"):
                _timed(eng, name, host)
        for r in _serving_requests(prompts, [(0, new)] * len(prompts)):
            srv.submit(r)
        srv.run()
        toks[share] = {k: o.tokens for k, o in srv.outputs.items()}
        pre[share] = srv.prefix_stats()
        del srv
    if not (pre[True]["dedups"] > 0 and pre[True]["blocks_matched"] > 0):
        raise AssertionError(f"fp32 shared run: {pre[True]}")
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, paged=True, zero_copy=True,
                        device="cuda")
    for i, p in enumerate(prompts):
        t, _ = solo.generate(p[None], new)
        for share in (True, False):
            if not np.array_equal(toks[share][f"r{i}"], t[0]):
                raise AssertionError(
                    f"fp32 serving r{i} (sharing {'on' if share else 'off'})"
                    f" differs from solo generate:\n{toks[share][f'r{i}']}"
                    f"\n{t[0]}")
    say(card, f"prefix lossless llama3.1-8b x{layers} layers fp32, graphs, "
              f"batch 4, 6 requests of {len(prompts[0])} tokens over two "
              f"1536-token system prompts, interleaved (prefill_budget 512): "
              f"sharing on == sharing off == solo generate for every request "
              f"over {new} tokens (dedups {pre[True]['dedups']}, "
              f"blocks_matched {pre[True]['blocks_matched']}, skipped "
              f"{pre[True]['prefill_tokens_skipped']}; host s, calls: "
              + ", ".join(f"{k} {v[0]:.4f} {v[1]}"
                          for k, v in sorted(host.items()))
              + f"); {time.perf_counter() - t0:.1f} s")
    del params, dparams, solo
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: the reference's default engine (contiguous cache, gathered body)
# ---------------------------------------------------------------------------

DEFAULT_LAYOUT = dict(paged=False, zero_copy=False)
PAGED_GATHERED = dict(paged=True, zero_copy=False)
# phase 3's max_len (request_token_need(8192, 128, 96, 6)): not a multiple
# of the 128-token block, so the contiguous rows past it are padding
CONTIG_MAX_LEN = 8431
CONTIG_EAGER_NEW = 16       # phase 8's eager generate: a Refresh, then Partial


def _attn_work(q, vlen, t, causal_pairs=None):
    """(bytes, operations) of one K1/K2 call: q, the valid keys and
    values, the block lists and the fp32 partials; 4 operations per
    (query, key) pair and head dimension."""
    b, _, h, dh = q.shape
    hk = vlen.shape[1]
    keys = int(vlen.sum().item())
    pairs = causal_pairs if causal_pairs is not None else keys * (h // hk) * t
    isz = q.element_size()
    nbytes = (q.numel() * isz + 2 * keys * dh * isz + 2 * vlen.numel() * 4
              + (2 + dh) * h * t * 4 * b)
    return nbytes, 4 * pairs * dh


def _contiguous_kernel_checks(torch, card, timer):
    """Phase 8 (c): the new call forms at llama3.1-8b shapes against their
    plain versions, timed: K1 over a contiguous cache through the
    identity list (Full T=61, Refresh T=156, 8229 tokens of a max_len-8431
    cache), K1 over the gathered body (35 selected blocks, the last three
    unused), K2 over the contiguous cache (T=256 at offset 7936), and K4's
    all-layer contiguous form (32 layers of the 8431-row cache, bit for
    bit against the plain per-layer recomputation).  Returns {kernel:
    {label: row}}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kvcache.cache import (init_contiguous_kv,
                                           update_layer_summaries)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    h, hk, dh, bs, ctx = 32, 8, 128, 128, 8229
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)
    k, v = init_contiguous_kv(1, 1, CONTIG_MAX_LEN, bs, hk, dh, bf, "cuda")
    k, v = k[0], v[0]                                   # [1, S, Hk, Dh]
    k.copy_(rnd(*k.shape))
    v.copy_(rnd(*v.shape))
    kf, rows = ops.flat_blocks(k)
    vf, _ = ops.flat_blocks(v)
    nb = rows // bs
    out = {"sparse_verify_attention": {}, "paged_prefill_attention": {},
           "block_summary": {}}
    kh = k[:, :ctx].transpose(1, 2)
    vh = v[:, :ctx].transpose(1, 2)
    for t, what in ((61, "Full"), (156, "Refresh")):
        q = rnd(1, t, h, dh)
        length = torch.tensor([ctx], dtype=torch.int32, device="cuda")
        idx, vlen = ops._identity_walk(1, hk, nb, length, CONTIG_MAX_LEN, bs)
        label = f"K1 contiguous {what} T={t} ctx={ctx}"
        out["sparse_verify_attention"][label] = _attn_row(
            torch, card, timer, label,
            lambda q=q, length=length: ops.contiguous_verify_attention(
                q, k, v, length, bs),
            lambda q=q, idx=idx, vlen=vlen: ref.block_attention_batched(
                q, kf, vf, idx, vlen, bs),
            *_attn_work(q, vlen, t),
            lambda q=q: F.scaled_dot_product_attention(
                q.transpose(1, 2), kh, vh, enable_gqa=True))
    # the gathered body: [1, NS*bs, Hk, Dh] token-major, slot j of head kh
    # holding the block it selected; block ids b*NS + j as the engine's
    ns = 35
    body_k, body_v = rnd(1, ns * bs, hk, dh), rnd(1, ns * bs, hk, dh)
    sel = torch.stack([torch.randperm(nb - 2, generator=gen, device="cuda")
                       [:ns] for _ in range(hk)])[None]
    sel[..., -3:] = -1
    sel[..., ns - 4] = ctx // bs                        # the ragged block
    length = torch.tensor([ctx], device="cuda")
    vlen = torch.where(sel >= 0, (length[:, None, None] - sel * bs)
                       .clamp(0, bs), 0).to(torch.int32).contiguous()
    idx = torch.arange(ns, device="cuda", dtype=torch.int32)[None, None] \
        .expand(1, hk, ns).contiguous()
    q = rnd(1, 61, h, dh)
    bkf = body_k.reshape(ns * bs, hk, dh)
    bvf = body_v.reshape(ns * bs, hk, dh)
    valid = (torch.arange(bs, device="cuda")[None, None] < vlen[0][..., None]
             ).reshape(hk, -1)
    mask = valid.repeat_interleave(h // hk, 0)[None, :, None]
    label = f"K1 gathered body NS={ns} T=61"
    out["sparse_verify_attention"][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.routed_partial_attention(
            q, body_k.reshape(ns, bs, hk, dh), body_v.reshape(ns, bs, hk, dh),
            idx, vlen),
        lambda: ref.block_attention_batched(q, bkf, bvf, idx, vlen, bs),
        *_attn_work(q, vlen, 61),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), body_k.transpose(1, 2),
            body_v.transpose(1, 2), attn_mask=mask, enable_gqa=True))
    # K2: the chunk [7936, 8192) over the contiguous cache's prefix
    t, qoff = 256, 7936
    q = rnd(1, t, h, dh)
    length = torch.tensor([qoff], dtype=torch.int32, device="cuda")
    tv = torch.tensor([t], dtype=torch.int32, device="cuda")
    idx2, vlen2 = ops._identity_walk(1, hk, nb, length + tv, CONTIG_MAX_LEN,
                                     bs)
    got = ops.contiguous_prefill_attention(q, k, v, length, tv, bs)
    m, l_, acc = ops.block_attention(q, kf, vf, idx2, vlen2, bs,
                                     q_offset=length)
    if not torch.equal(got, (acc / l_.clamp(min=1e-30)[..., None])
                       .transpose(1, 2).to(bf)):
        raise AssertionError("K2 contiguous: the wrapper's output is not "
                             "its launch's normalised partials")
    kpos = torch.arange(qoff + t, device="cuda")
    qpos = qoff + torch.arange(t, device="cuda")
    cmask = kpos[None] <= qpos[:, None]
    pairs = int(cmask.sum().item()) * h
    label = f"K2 contiguous T={t} qoff={qoff}"
    out["paged_prefill_attention"][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.block_attention(q, kf, vf, idx2, vlen2, bs,
                                    q_offset=length),
        lambda: ref.block_attention_batched(q, kf, vf, idx2, vlen2, bs,
                                            q_offset=length),
        *_attn_work(q, vlen2, t, causal_pairs=pairs),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, : qoff + t].transpose(1, 2),
            v[:, : qoff + t].transpose(1, 2), attn_mask=cmask,
            enable_gqa=True))
    del k, v, kf, vf, body_k, body_v
    # K4: every layer of a contiguous cache in one launch
    layers = 32
    k, _ = init_contiguous_kv(layers, 1, CONTIG_MAX_LEN, bs, hk, dh, bf,
                              "cuda")
    for i in range(layers):
        k[i].copy_(rnd(*k.shape[1:]))
    kf, _ = ops.flat_blocks(k)
    nb = -(-CONTIG_MAX_LEN // bs)
    for label, start, end, n_touch in (
            ("prefill chunk", 7936, 8192, 3), ("commit", 8250, 8340, 2),
            ("commit past max_len", 8400, 8440, 2)):
        st = torch.tensor([start], dtype=torch.int32, device="cuda")
        en = torch.tensor([end], dtype=torch.int32, device="cuda")
        got = torch.zeros((2, layers, 1, nb, hk, dh), device="cuda")
        ops.contiguous_block_summaries(k, st, en, n_touch, got[0], got[1],
                                       bs)

        def plain():
            z = torch.zeros((1, nb, hk, dh), device="cuda")
            return [update_layer_summaries(z, z, k[i], st, en, bs)
                    for i in range(layers)]
        want = plain()
        torch.cuda.synchronize()
        for i, (wx, wn) in enumerate(want):
            if not (torch.equal(got[0, i], wx) and torch.equal(got[1, i], wn)):
                raise AssertionError(f"K4 contiguous {label}: layer {i} "
                                     f"differs from the plain version")
        before = dict(ops.LAUNCHES)
        ms = timer.kernel_ms(lambda: ops.contiguous_block_summaries(
            k, st, en, n_touch, got[0], got[1], bs), "block_summary_kernel")
        if timer.per_call != 1:
            raise AssertionError(f"K4: {timer.per_call} launches per call")
        ops.LAUNCHES.update(before)
        plain_ms = timer(plain, iters=3, warmup=1)
        live = [(j, min(end - j * bs, bs)) for j in range(start // bs,
                                                          -(-end // bs))]
        blocks = (torch.arange(layers, device="cuda")[:, None] * nb
                  + torch.tensor([j for j, _ in live], device="cuda")[None]
                  ).reshape(-1)
        kb = kf.view(layers * nb, bs, hk, dh)
        lib_ms = timer(lambda: torch.aminmax(kb[blocks], dim=1))
        n_tok = layers * sum(n for _, n in live)
        nbytes = (n_tok * hk * dh * 2 + 2 * layers * len(live) * hk * dh * 4
                  + 8)
        bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
        say(card, f"kernel K4 contiguous {label} L={layers} max_len "
                  f"{CONTIG_MAX_LEN} [{start}, {end}) n_touch={n_touch}: "
                  f"bit-equal to the plain per-layer version, 1 launch; ms "
                  f"{ms:.4f} ({timer.source}) plain_ms {plain_ms:.4f} "
                  f"bound_us {bound * 1e3:.3f} ({by}) library_ms "
                  f"{lib_ms:.4f} "
                  f"(torch.aminmax over the gathered live blocks)")
        out["block_summary"][f"contiguous {label} L=32"] = dict(
            max_abs_err=0.0, ms=ms, timing=timer.source, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms)
    del k, kf
    torch.cuda.empty_cache()
    return out


def _layouts_agree(torch, card, cfg, spec, dcfg, params, dparams, prompt):
    """Phase 8 (b): after the same prefill the contiguous engine's K/V and
    summaries equal the paged zero-copy engine's through the page table,
    bit for bit; after one Refresh each, the same selection, and the
    gathered body's Partial attention (K1) equals the routed read of the
    pool, bit for bit, at three layers."""
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models import dense as dn
    con = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=CONTIG_MAX_LEN, device="cuda", **DEFAULT_LAYOUT)
    zc = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                      max_len=CONTIG_MAX_LEN, device="cuda",
                      **PAGED_ZERO_COPY)
    sc, sz = con.prefill(prompt), zc.prefill(prompt)
    torch.cuda.synchronize()
    n, bs = prompt.shape[1], spec.block_size
    nb = -(-n // bs)
    pt = sz.cache["page_table"][0].long()
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            view = sz.cache[name][i][pt].reshape(-1, hk, dh)[:n]
            if not torch.equal(sc.cache[name][i, 0, :n], view):
                raise AssertionError(f"layer {i} {name}: contiguous != paged")
        for name in ("kmax", "kmin"):
            if not torch.equal(sc.cache[name][i, 0, :nb],
                               sz.cache[name][i][pt[:nb]]):
                raise AssertionError(f"layer {i} {name}: contiguous != paged")
    sc, oc = con.step(sc, "refresh")
    sz, oz = zc.step(sz, "refresh")
    if not (torch.equal(sc.pkv_blocks, sz.pkv_blocks)
            and (oc.tokens == oz.tokens).all()):
        raise AssertionError("one Refresh: the contiguous and paged engines "
                             "select different blocks")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    q = torch.randn((1, 61, cfg.num_heads, dh), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for i in (0, cfg.num_layers // 2, cfg.num_layers - 1):
        routed = dn._partial_context(
            q, (sz.cache["k"][i], sz.cache["v"][i]), sz.cache["page_table"],
            sz.pkv_blocks[:, i], sz.cache["length"],
            (sz.pkv_k[i], sz.pkv_v[i], sz.pkv_pos[i]), bs)
        gathered = dn._partial_context(
            q, None, None, sc.pkv_blocks[:, i], sc.cache["length"],
            (sc.pkv_k[i], sc.pkv_v[i], sc.pkv_pos[i], sc.pkv_body_k[i],
             sc.pkv_body_v[i]), bs)
        for a, b in zip(gathered, routed):
            if not torch.equal(a, b):
                raise AssertionError(f"layer {i}: gathered body partial "
                                     f"attention != routed")
    say(card, f"layouts agree: after an {n}-token prefill the contiguous "
              f"K/V and summaries of all {cfg.num_layers} layers equal the "
              f"paged pool's through the page table, bit for bit; after one "
              f"Refresh each the selection is the same and the gathered "
              f"body's K1 Partial result equals the routed one bit for bit "
              f"(layers 0, {cfg.num_layers // 2}, {cfg.num_layers - 1})")
    del con, zc, sc, sz
    torch.cuda.empty_cache()


def _contiguous_serving(torch, card, cfg, spec, dcfg, params, dparams,
                        paged_run, name="llama3.1-8b"):
    """Phase 8 (e) at full width (and phase 14 (c) on ``name``): the
    reference's ``ServingConfig()`` (contiguous slots, gathered body;
    blocking admission) at batch 4 over phase 6's six requests, with
    graphs: admission by free slot, launches held to the steps' variants
    and chunks, graphs per variant, the serving bodies under the sync
    check; numbers beside phase 6's paged run.  Returns the run's
    launches and numbers (its tokens by request among them)."""
    import numpy as np
    from repro_torch.serving import ServingConfig, ServingEngine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256), device="cuda")
    outs, wall, launches, peak = _serve(
        torch, srv, _serving_requests(prompts, SERVE_REQS))
    sched = srv._continuous
    eng = sched.engine
    st = srv.stats
    if eng.paged or not eng.gathered:
        raise AssertionError("ServingConfig() must serve contiguous slots "
                             "with the gathered partial cache")
    for i, (n, new) in enumerate(SERVE_REQS):
        o = outs[f"r{i}"]
        if (o.finish_reason != "length" or len(o.tokens) != new
                or o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size):
            raise AssertionError(f"request r{i}: {o.finish_reason}, "
                                 f"{len(o.tokens)} tokens")
    if st.get("page_stalls", 0) or st["peak_active"] != 4:
        raise AssertionError(f"admission by free slot: {dict(st)}")
    if not (st["mode_rows_refresh"] and st["mode_rows_partial"]):
        raise AssertionError(f"the ticks must run Refresh and Partial rows: "
                             f"{dict(st)}")
    want = _expected_serving_launches(eng, cfg.num_layers)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"contiguous serving launches {got} != {want} "
                             f"implied by {eng.dispatch_keys} and "
                             f"{eng.prefill_dispatches} prefill chunks")
    want_graphs = _prefill_graph_keys(eng) | set(eng.dispatch_keys)
    if set(eng._graphs) != want_graphs:
        raise AssertionError(f"graphs {sorted(map(str, eng._graphs))}")
    lat = np.array([o.latency_s for o in outs.values()])
    ntok = int(sum(len(o.tokens) for o in outs.values()))
    ticks = {c: (len(v), 1e3 * float(np.median(v)))
             for c, v in sched.tick_wall.items()}
    beside = ""
    if paged_run:
        beside = (f" [phase 6 paged zero-copy: tokens_per_s "
                  f"{paged_run['tokens_per_s']:.2f} p50 "
                  f"{paged_run['p50']:.3f} p95 {paged_run['p95']:.3f} "
                  f"ticks {paged_run['ticks']}]")
    say(card, f"contiguous serving {name} [graphs] ServingConfig() "
              f"batch 4, requests {[n for n, _ in SERVE_REQS]}: tokens {ntok} "
              f"wall_s {wall:.3f} tokens_per_s {ntok / wall:.2f} latency_s "
              f"p50 {np.percentile(lat, 50):.3f} p95 "
              f"{np.percentile(lat, 95):.3f} steps {int(st['steps'])} "
              f"prefill chunks {eng.prefill_dispatches} peak_mem_gib "
              f"{peak:.2f} capture_s {eng.capture_s:.3f} tick wall ms by "
              f"class (ticks, median) {ticks}{beside}")
    say(card, f"contiguous serving launches {got} == implied by "
              f"{ {str(k): n for k, n in eng.dispatch_keys.items()} } and "
              f"{eng.prefill_dispatches} chunks")
    memory_line(torch, card, "contiguous serving", eng, params, dparams,
                peak)
    check_sync_free_serving(torch, card, eng, prompts)
    del srv, sched, eng
    torch.cuda.empty_cache()
    return got, dict(tokens_per_s=ntok / wall,
                     p50=float(np.percentile(lat, 50)),
                     p95=float(np.percentile(lat, 95)), ticks=ticks,
                     peak_gib=peak,
                     tokens={k: o.tokens for k, o in outs.items()})


def _default_lossless(torch, card, ref):
    """Phase 8 (d): fp32 at 4 layers, TF32 off, with graphs.  The
    contiguous gathered, paged gathered and paged gathered-view
    (``use_pallas=False``) engines give the port's AR tokens with full
    verification and phase 4's paged zero-copy tokens with partial
    verification (computed here when phase 4 did not run)."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.core.reference import autoregressive_generate
    cfg, spec, dcfg, params, dparams, prompt, max_len = _lossless_setup(
        torch, LOSSLESS_PROMPT, LOSSLESS_NEW)
    t0 = time.perf_counter()
    if ref is None:
        zc = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                          max_len=max_len, device="cuda", **PAGED_ZERO_COPY)
        ref = dict(ar=autoregressive_generate(
            cfg, params, prompt, LOSSLESS_NEW, max_len=max_len, spec=spec,
            device="cuda"), partial=zc.generate(prompt, LOSSLESS_NEW)[0])
        del zc
    for name, layout, sp in (
            ("contiguous gathered", DEFAULT_LAYOUT, spec),
            ("paged gathered", PAGED_GATHERED, spec),
            ("paged gathered view", PAGED_GATHERED,
             spec.replace(use_pallas=False))):
        for pv, want in ((False, ref["ar"]), (True, ref["partial"])):
            eng = SpecPVEngine(cfg, sp, dcfg, params, dparams, batch=1,
                               max_len=max_len, partial_verification=pv,
                               device="cuda", **layout)
            toks, stats = eng.generate(prompt, LOSSLESS_NEW)
            if not eng._graphs:
                raise AssertionError(f"{name}: no graph replayed")
            if not np.array_equal(toks, want):
                raise AssertionError(
                    f"fp32 {name} ({'partial' if pv else 'full'} "
                    f"verification) differs from "
                    f"{'the zero-copy run' if pv else 'AR'}:\n{toks}\n{want}")
            if pv and not (stats["modes"].get("refresh")
                           and stats["modes"].get("partial")):
                raise AssertionError(f"{name}: modes {stats['modes']}")
            del eng
    say(card, f"lossless llama3.1-8b x4 layers fp32, graphs: the contiguous "
              f"gathered, paged gathered and paged gathered-view "
              f"(use_pallas=False) engines give AR's tokens with full "
              f"verification and the paged zero-copy run's with partial "
              f"verification over {LOSSLESS_NEW} tokens; "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()


def phase_default_engine(torch, card, timer, p3=None, p4=None, p6=None):
    """Phase 8: the reference's default engine, ``SpecPVEngine(paged=False,
    zero_copy=False)``: (c) the new kernel call forms, (a) full-width
    ``generate`` eagerly and with graphs, (b) the layouts agree on the
    card, (e) contiguous continuous batching, (d) fp32 losslessness of
    the gathered layouts and of contiguous serving.  Returns the
    launches of (a)'s graph run and (e)'s, and the call forms' rows."""
    import gc
    # earlier phases' engines hold their graph pools until the cyclic
    # collector runs (phase 10's finding)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shapes = _contiguous_kernel_checks(torch, card, timer)
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b")
    # the eager run is cut to CONTIG_EAGER_NEW tokens and not profiled,
    # and the graph run's window leaves the prefill out: phase 3 profiles
    # the eager step and the graph prefill of the same model on the paged
    # layout; the eager contiguous bodies still run under the sync check
    runs = generate_runs(torch, card, cfg, spec, dcfg, params, dparams,
                         prompt, NEW_TOKENS, DEFAULT_LAYOUT,
                         "llama3.1-8b contiguous", eager_new=CONTIG_EAGER_NEW,
                         profile_prefill=False)
    g = runs["graphs"]
    if p3 is not None:
        same = int((g["toks"] == p3["toks"]).sum())
        say(card, f"contiguous gathered bf16 tokens equal to phase 3's paged "
                  f"zero-copy run: {same} of {g['toks'].size} (not asserted)")
    _layouts_agree(torch, card, cfg, spec, dcfg, params, dparams, prompt)
    serving, srv_nums = _contiguous_serving(torch, card, cfg, spec, dcfg,
                                            params, dparams, p6)
    del params, dparams
    torch.cuda.empty_cache()
    _default_lossless(torch, card, p4)
    serving_lossless(torch, card, layout=DEFAULT_LAYOUT)
    say(card, f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return dict(launches=g["launches"], serving_launches=serving,
                shapes=shapes, serving=srv_nums)


# ---------------------------------------------------------------------------
# phase 9: the fused multi-row prefill
# ---------------------------------------------------------------------------

FUSED_BUDGET = 1024     # prefill tokens per tick: up to four 256-token rows
# phase 6's prompts with fewer new tokens: the phase measures the prefill
# pump, and decode ticks of the longer budgets only added host seconds
FUSED_REQS = ((2048, 8), (3072, 16), (4608, 16), (6144, 16), (8192, 16),
              (8192, 16))
FUSED_PREFIX_NEW = 16   # (b): phase 7's shared-prefix prompts
# a ragged [4, 256] round at llama widths: (length, t_valid) per row
FUSED_ROWS = ((7936, 256), (48, 16), (0, 200), (4000, 1))
# phase 9 (c)'s short trace, served with graphs and eagerly: three prompts
# arriving together (one 3-row round within the budget), 8 new tokens each
FUSED_EAGER_REQS = ((1024, 8), (768, 8), (512, 8))


def _fused_kernel_checks(torch, card, timer):
    """Phase 9 (kernels): the call forms a fused round gives K2 and K4,
    against their plain versions and timed: K2 over four ragged rows
    (``FUSED_ROWS``) of one [4, 256] chunk through the rows' page tables,
    on the contiguous prefill carry (slot s's block j is page 1 + s*66 +
    j); K4 over 32 layers with the rows' ends at length + t_valid, bit for
    bit.  Returns {kernel: {label: row}}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    h, hk, dh, bs, t = 32, 8, 128, 128, 256
    b = len(FUSED_ROWS)
    nb = -(-max(n0 + n for n0, n in FUSED_ROWS) // bs) + 2   # 66: 8448
    npg = b * nb + 1
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)
    table = (1 + torch.arange(b * nb, device="cuda")).view(b, nb).to(
        torch.int32)
    length = torch.tensor([r[0] for r in FUSED_ROWS], dtype=torch.int32,
                          device="cuda")
    tv = torch.tensor([r[1] for r in FUSED_ROWS], dtype=torch.int32,
                      device="cuda")
    end = length + tv
    out = {"paged_prefill_attention": {}, "block_summary": {}}
    pk, pv = rnd(npg, bs, hk, dh), rnd(npg, bs, hk, dh)
    q = rnd(b, t, h, dh)
    kf, vf = pk.view(-1, hk, dh), pv.view(-1, hk, dh)
    idx, vlen = ops._page_walk(table, end, pk.shape)
    got = ops.paged_prefill_attention(q, pk, pv, table, length, tv)
    m, l_, acc = ops.block_attention(q, kf, vf, idx, vlen, bs,
                                     q_offset=length)
    if not torch.equal(got, (acc / l_.clamp(min=1e-30)[..., None])
                       .transpose(1, 2).to(bf)):
        raise AssertionError("K2 ragged: the wrapper's output is not its "
                             "launch's normalised partials")
    # the library call: SDPA over each row's keys gathered and padded,
    # masked by absolute position and the row's end
    smax = int(end.max())
    kg = pk[table.long()].flatten(1, 2)[:, :smax].transpose(1, 2)
    vg = pv[table.long()].flatten(1, 2)[:, :smax].transpose(1, 2)
    kpos = torch.arange(smax, device="cuda")
    qpos = length[:, None] + torch.arange(t, device="cuda")[None]
    mask = ((kpos[None, None] <= qpos[..., None])
            & (kpos[None, None] < end[:, None, None]))[:, None]
    # the operations this run's data needs: the real query rows only
    pairs = h * sum(sum(n0 + i + 1 for i in range(n)) for n0, n in FUSED_ROWS)
    label = "K2 ragged rows=4 T=256 (t_valid 256/16/200/1) carry"
    out["paged_prefill_attention"][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.block_attention(q, kf, vf, idx, vlen, bs,
                                    q_offset=length),
        lambda: ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                            q_offset=length),
        *_attn_work(q, vlen, t, causal_pairs=pairs),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kg, vg, attn_mask=mask, enable_gqa=True))
    del pk, pv, kf, vf, kg, vg
    torch.cuda.empty_cache()
    layers, n_touch = 32, -(-t // bs) + 1
    pool = torch.empty((layers, npg, bs, hk, dh), dtype=bf, device="cuda")
    for i in range(layers):
        pool[i].copy_(rnd(npg, bs, hk, dh))
    init = torch.rand((2, layers, npg, hk, dh), generator=gen,
                      device="cuda")
    init[:, :, 0] = 0.0
    got, want = init.clone(), init.clone()
    ops.paged_block_summaries(pool, table, length, end, n_touch, got[0],
                              got[1])
    ref.paged_block_summaries(pool, table, length, end, n_touch, want[0],
                              want[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 ragged rows: differs from the plain version")
    before = dict(ops.LAUNCHES)
    ms = timer.kernel_ms(lambda: ops.paged_block_summaries(
        pool, table, length, end, n_touch, got[0], got[1]),
        "block_summary_kernel")
    if timer.per_call != 1:
        raise AssertionError(f"K4: {timer.per_call} launches per call")
    ops.LAUNCHES.update(before)
    plain_ms = timer(lambda: ref.paged_block_summaries(
        pool, table, length, end, n_touch, want[0], want[1]), iters=3,
        warmup=1)
    live = [(r * nb + j, min(e - j * bs, bs))
            for r, (n0, n) in enumerate(FUSED_ROWS)
            for e in (n0 + n,) for j in range(n0 // bs, -(-e // bs))]
    blocks = (torch.arange(layers, device="cuda")[:, None] * npg + 1
              + torch.tensor([j for j, _ in live], device="cuda")[None]
              ).reshape(-1)
    pb = pool.view(layers * npg, bs, hk, dh)
    lib_ms = timer(lambda: torch.aminmax(pb[blocks], dim=1))
    n_tok = layers * sum(n for _, n in live)
    nbytes = n_tok * hk * dh * 2 + 2 * layers * len(live) * hk * dh * 4 + 48
    bound, by = _bound_ms(nbytes, 2 * n_tok * hk * dh, PEAK_FP32_S)
    label = "ragged rows=4 (ends length + t_valid) L=32"
    say(card, f"kernel K4 {label}: bit-equal to the plain version, 1 "
              f"launch; ms {ms:.4f} ({timer.source}) plain_ms "
              f"{plain_ms:.4f} bound_us {bound * 1e3:.3f} ({by}) library_ms "
              f"{lib_ms:.4f} (torch.aminmax over the gathered live blocks)")
    out["block_summary"][label] = dict(
        max_abs_err=0.0, ms=ms, timing=timer.source, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=lib_ms)
    del pool, init, got, want
    torch.cuda.empty_cache()
    return out


def _instrument(torch, sched):
    """Log a scheduler's ticks (host wall, with a sync at the end so that
    each tick holds its own device work, and its prefill dispatches) and
    its engine's prefill rounds (rows, width, whether the round captured
    its graph, CUDA events around each; a serial step is a one-row
    round).  Returns the log."""
    log = dict(ticks=[], rounds=[])
    eng, tick, step = sched.engine, sched.tick, sched.engine.prefill_step_fused

    def fused(st, cursors):
        live = [c for c in cursors if not c.done]
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        key = (len(live), max(c.next_tokens for c in live))
        graphs = len(eng._graphs)
        e0.record()
        out = step(st, cursors)
        e1.record()
        log["rounds"].append((key, len(eng._graphs) > graphs, e0, e1))
        return out

    def ticked():
        n0 = eng.prefill_dispatches
        t0 = time.perf_counter()
        progressed = tick()
        torch.cuda.synchronize()
        log["ticks"].append((time.perf_counter() - t0,
                             eng.prefill_dispatches - n0))
        return progressed
    eng.prefill_step_fused = fused
    sched.tick = ticked
    return log


def _fused_serve(torch, card, srv, reqs, label):
    """Serve ``reqs`` through a fresh instrumented scheduler of ``srv``'s
    configuration (launch counts set to 0 just before, read just after)
    and check them against the rounds.  Returns the run's numbers."""
    import numpy as np
    from repro_torch.serving import ContinuousScheduler
    c = srv.scfg
    eng = srv._engine_for(c.batch, paged=c.paged_kv)
    sched = ContinuousScheduler(
        eng, prefill_chunk=c.prefill_chunk, prefill_budget=c.prefill_budget,
        fused=c.fused_step, fused_prefill=c.fused_prefill)
    sched.trace = _StampedTrace()
    log = _instrument(torch, sched)
    srv._continuous = sched
    arrival = min(r.arrival_s for r in reqs)
    outs, wall, launches, peak = _serve(torch, srv, reqs)
    layers = eng.cfg.num_layers
    for r in reqs:
        o = outs[r.request_id]
        if (o.finish_reason != "length" or len(o.tokens) != r.max_new_tokens
                or o.tokens.min() < 0 or o.tokens.max() >= eng.cfg.vocab_size):
            raise AssertionError(f"{label} {r.request_id}: {o.finish_reason}, "
                                 f"{len(o.tokens)} tokens")
    want = _expected_serving_launches(eng, layers)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label} launches {got} != {want} implied by "
                             f"{eng.dispatch_keys} and "
                             f"{eng.prefill_dispatches} prefill rounds")
    if eng.cuda_graphs and set(eng._graphs) != _prefill_graph_keys(
            eng) | set(eng.dispatch_keys):
        raise AssertionError(f"{label} graphs {sorted(map(str, eng._graphs))}")
    rows = [k for k, _ in eng.prefill_keys]
    if c.fused_prefill != (max(rows) > 1):
        raise AssertionError(f"{label}: prefill rounds {eng.prefill_keys}")
    ps = eng.page_stats()
    if ps and (ps["committed"] or ps["pinned_pages"]):
        raise AssertionError(f"{label}: pages committed or pinned after the "
                             f"run: {ps}")
    ttft = np.array([t - arrival for (ev, _, _), t in
                     zip(sched.trace, sched.trace.t) if ev == "prefill_done"])
    lat = np.array([o.latency_s for o in outs.values()])
    ntok = int(sum(len(o.tokens) for o in outs.values()))
    rounds, captures = {}, 0
    for (k, n), captured, e0, e1 in log["rounds"]:
        if captured:                # the first round of a key: a capture
            captures += 1
            continue
        replay = n == 256 and eng.cuda_graphs
        cls = f"{k} rows x {n} {'graph' if replay else 'eager'}"
        rounds.setdefault(cls, []).append(e0.elapsed_time(e1))
    rounds = {cls: (len(v), float(np.median(v))) for cls, v in rounds.items()}
    ticks = {}
    for dt, d in log["ticks"]:
        ticks.setdefault("with prefill" if d else "decode only",
                         []).append(dt * 1e3)
    ticks = {cls: (len(v), float(np.median(v))) for cls, v in ticks.items()}
    per_tick = [d for _, d in log["ticks"] if d]
    dec = {cls: (len(v), 1e3 * float(np.median(v)))
           for cls, v in sched.tick_wall.items()}
    res = dict(toks={k: o.tokens for k, o in outs.items()}, launches=got,
               wall_s=wall, tokens_per_s=ntok / wall, peak_gib=peak,
               ttft_p50=float(np.percentile(ttft, 50)),
               ttft_p95=float(np.percentile(ttft, 95)),
               p50=float(np.percentile(lat, 50)),
               p95=float(np.percentile(lat, 95)), rounds=rounds,
               ticks=ticks, decode_ticks=dec,
               dispatches=eng.prefill_dispatches,
               dispatches_per_tick=(float(np.mean(per_tick)), max(per_tick)),
               keys=dict(eng.prefill_keys), capture_s=eng.capture_s,
               stats=dict(srv.stats), prefix=eng.prefix_stats(), pages=ps)
    say(card, f"fused prefill [{label}] tokens {ntok} wall_s {wall:.3f} "
              f"tokens_per_s {ntok / wall:.2f} ttft_s p50 "
              f"{res['ttft_p50']:.3f} p95 {res['ttft_p95']:.3f} latency_s "
              f"p50 {res['p50']:.3f} p95 {res['p95']:.3f} steps "
              f"{int(srv.stats['steps'])} prefill dispatches "
              f"{eng.prefill_dispatches} per prefill tick mean "
              f"{res['dispatches_per_tick'][0]:.2f} max "
              f"{res['dispatches_per_tick'][1]} peak_mem_gib {peak:.2f} "
              f"capture_s {eng.capture_s:.3f}")
    say(card, f"fused prefill [{label}] rounds (rows, width): count and "
              f"median device ms {rounds} ({captures} rounds that captured "
              f"their graph left out); tick wall ms (count, median) "
              f"{ticks}; decode tick classes {dec}")
    say(card, f"fused prefill [{label}] launches {got} == implied by the "
              f"steps' variants and {eng.prefill_dispatches} prefill rounds "
              f"{ {str(k): n for k, n in eng.prefill_keys.items()} }")
    return res, eng


def _profile_fused_round(torch, card, eng, prompts):
    """On a drained paged engine: four cursors, one full 4-row round to
    warm, then one round under ``torch.profiler``: device busy ms, device
    launches and host launch calls of a fused chunk."""
    from torch.profiler import ProfilerActivity, profile
    st = eng.empty_state()
    curs = []
    for slot in range(4):
        st, c = eng.prefill_begin_slot(st, slot, prompts[slot][:1024],
                                       max_new_tokens=8)
        curs.append(c)
    st, _ = eng.prefill_step_fused(st, curs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, _ = eng.prefill_step_fused(st, curs)
        torch.cuda.synchronize()
    busy, _ = _device_busy(prof)
    dev_n, host_n, calls_n = _launch_counts(prof)
    say(card, f"fused prefill profile: one 4-row 256-token round (graph "
              f"replay): device busy_ms {busy:.2f} device launches {dev_n} "
              f"host launch calls {calls_n} top-level host aten ops "
              f"{host_n}")
    eng.empty_state()
    return dict(busy_ms=busy, device_launches=dev_n, host_launch_calls=calls_n)


def fused_lossless(torch, card, layers: int = 4, new: int = 32):
    """Phase 9 (d): fp32 at full width, ``layers`` layers, with graphs,
    batch 4, two 1536-token system prompts and six requests with 116-token
    tails arriving together, ``prefill_budget=1024``: on the paged pool
    with sharing on (paired cold cursors race and dedupe) and on
    contiguous slots, the fused pump gives every request's solo
    ``generate`` and the serial pump's tokens."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.1-8b").replace(num_layers=layers,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    t0 = time.perf_counter()
    prompts = _prefix_prompts(np, cfg.vocab_size, n_sys=1536, tail=116, n=6,
                              seed=4, repeat=False)
    max_len = 2048
    notes = []
    for name, layout in (("paged, sharing on", PAGED_ZERO_COPY),
                         ("contiguous", DEFAULT_LAYOUT)):
        toks = {}
        for fused in (True, False):
            srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                                ServingConfig(
                                    batch=4, max_len=max_len,
                                    prefill_budget=FUSED_BUDGET,
                                    fused_prefill=fused,
                                    paged_kv=layout["paged"],
                                    zero_copy_partial=layout["zero_copy"]),
                                device="cuda")
            for r in _serving_requests(prompts, [(0, new)] * len(prompts)):
                srv.submit(r)
            srv.run()
            eng = srv._continuous.engine
            toks[fused] = {k: o.tokens for k, o in srv.outputs.items()}
            if fused:
                rows = max(k for k, _ in eng.prefill_keys)
                pre = srv.prefix_stats()
                if rows < 2 or (layout["paged"] and not pre["dedups"]):
                    raise AssertionError(f"fp32 {name}: rounds "
                                         f"{eng.prefill_keys}, {pre}")
                notes.append(f"{name}: rounds {eng.prefill_keys} dedups "
                             f"{pre.get('dedups', 0)}")
            del srv, eng
        solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                            max_len=max_len, device="cuda", **layout)
        for i, p in enumerate(prompts):
            t, _ = solo.generate(p[None], new)
            for fused in (True, False):
                if not np.array_equal(toks[fused][f"r{i}"], t[0]):
                    raise AssertionError(
                        f"fp32 {name} r{i} ({'fused' if fused else 'serial'}"
                        f" pump) differs from solo generate:\n"
                        f"{toks[fused][f'r{i}']}\n{t[0]}")
        del solo
    say(card, f"fused lossless llama3.1-8b x{layers} layers fp32, graphs, "
              f"batch 4, 6 requests of {len(prompts[0])} tokens over two "
              f"1536-token system prompts, prefill_budget {FUSED_BUDGET}: "
              f"fused pump == serial pump == solo generate for every request "
              f"over {new} tokens ({'; '.join(notes)}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()


def phase_fused_prefill(torch, card, timer):
    """Phase 9: the fused multi-row prefill (``ServingConfig.fused_prefill``
    , the reference's default) at llama3.1-8b's full width: the ragged
    K2/K4 call forms; (a) phase 6's six prompts (``FUSED_REQS``)
    interleaved
    (``prefill_budget=1024``) on the paged pool with the serial and the
    fused pump and on contiguous slots fused, with graphs, and one fused
    round profiled; (b) the shared-prefix traffic of phase 7, fused, with
    sharing on; (c) the paged fused run again eagerly (equal tokens and
    launch counts) and one eager fused round under the sync check; (d)
    fp32 losslessness.  Returns the launches and call forms."""
    import gc
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine
    # earlier phases' engines hold their graph pools until the cyclic
    # collector runs (phase 10's finding)
    gc.collect()
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    shapes = _fused_kernel_checks(torch, card, timer)
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    paged = dict(batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
                 prefill_budget=FUSED_BUDGET, num_pages=SERVE_PAGES,
                 paged_kv=True, zero_copy_partial=True, prefix_cache=False)
    runs = {}
    for label, scfg in (
            ("paged serial", ServingConfig(fused_prefill=False, **paged)),
            ("paged fused", ServingConfig(**paged)),
            ("contiguous fused", ServingConfig(
                batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
                prefill_budget=FUSED_BUDGET))):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, scfg,
                            device="cuda")
        runs[label], eng = _fused_serve(
            torch, card, srv, _serving_requests(prompts, FUSED_REQS), label)
        memory_line(torch, card, f"fused prefill {label}", eng, params,
                    dparams, runs[label]["peak_gib"])
        if label == "paged fused":
            runs[label]["profile"] = _profile_fused_round(torch, card, eng,
                                                          prompts)
        del srv, eng
        gc.collect()
        torch.cuda.empty_cache()
    ser = runs["paged serial"]["toks"]
    for label in ("paged fused", "contiguous fused"):
        same = sum(np.array_equal(runs[label]["toks"][k], ser[k]) for k in ser)
        runs[label]["same_as_serial"] = same
        say(card, f"fused prefill [{label}] bf16 tokens equal to the paged "
                  f"serial pump's: {same} of {len(ser)} requests (not "
                  f"asserted: a K-row chunk runs its GEMMs at another shape)")
    # (b) the shared-prefix traffic, interleaved and fused, sharing on
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
        prefill_budget=FUSED_BUDGET, num_pages=PREFIX_PAGES, paged_kv=True,
        zero_copy_partial=True, prefix_cache=True), device="cuda")
    pp = _prefix_prompts(np, cfg.vocab_size)
    shared, eng = _fused_serve(
        torch, card, srv,
        _serving_requests(pp, [(0, FUSED_PREFIX_NEW)] * len(pp)),
        "shared prefixes fused")
    pre, ps = shared["prefix"], shared["pages"]
    if ps["in_use"] != ps["idle"] or not pre["prefill_tokens_skipped"]:
        raise AssertionError(f"shared prefixes fused: {pre}, {ps}")
    say(card, f"fused prefill [shared prefixes fused] prefix_stats {pre}; "
              f"no committed page or pin left ({ps})")
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the paged fused pump eagerly against graphs on a short trace
    # (FUSED_EAGER_REQS: one 3-row round, then decode): equal tokens,
    # launch counts and rounds
    short = [p[:n] for p, (n, _) in zip(prompts, FUSED_EAGER_REQS)]
    both = {}
    for graphs in (True, False):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                            ServingConfig(**paged), device="cuda",
                            cuda_graphs=graphs)
        both[graphs], eng = _fused_serve(
            torch, card, srv, _serving_requests(short, FUSED_EAGER_REQS),
            f"paged fused short trace {RUN_LABEL[graphs]}")
        if graphs:
            del srv, eng
            gc.collect()
            torch.cuda.empty_cache()
    g, eager = both[True], both[False]
    for rid in g["toks"]:
        if not np.array_equal(g["toks"][rid], eager["toks"][rid]):
            raise AssertionError(f"fused prefill {rid}: graph tokens differ "
                                 f"from eager")
    if g["launches"] != eager["launches"] or g["keys"] != eager["keys"]:
        raise AssertionError(f"fused prefill launches: graphs {g['launches']}"
                             f" {g['keys']} eager {eager['launches']} "
                             f"{eager['keys']}")
    st = eng.empty_state()
    curs = []
    for slot, n in enumerate((2048, 300, 1024)):
        st, c = eng.prefill_begin_slot(st, slot, prompts[slot][:n],
                                       max_new_tokens=8)
        curs.append(c)
    st, _ = eng.prefill_step_fused(st, curs[:2])
    st, n = _eager_prefill_round(torch, eng, st, curs)
    say(card, f"fused prefill, short trace: graph tokens == eager tokens "
              f"for every request, launches and rounds {g['keys']} equal; "
              f"an eager 3-row round "
              f"({[c.off for c in curs]} after it, {n} tokens, a short row "
              f"padded) ran under set_sync_debug_mode('error') without a "
              f"sync")
    del srv, eng, params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    fused_lossless(torch, card)
    secs = time.perf_counter() - t_phase
    say(card, f"phase 9 took {secs:.1f} s")
    return dict(launches=runs["paged fused"]["launches"],
                contiguous_launches=runs["contiguous fused"]["launches"],
                prefix_launches=shared["launches"], shapes=shapes,
                runs=runs, shared=shared, seconds=secs)


# ---------------------------------------------------------------------------
# phase 10: training, and the paper's table 1 on a pair trained on the card
# ---------------------------------------------------------------------------

TRAIN_SEQ = 2048        # cut from the paper's 32K YARN recipe (App. A)
TRAIN_STEPS = 5         # timed, after one warm-up step
TARGET_TRAIN_LAYERS = 4  # 32 layers' AdamW state (~96 GB) exceeds the card
# The feature pass's kernel route differs from its plain route only in
# the attention (K2) and the summaries (K4), so it is held to the plain
# route where those run: at every layer, on the plain route's hidden
# state entering it, K2's partials within TOL_KERNEL of the plain
# attention's and K4's summaries bit-equal to the plain ones.  The bf16
# outputs themselves are reported, not held: one-ulp flips of the bf16
# attention output (K2's fp32 result is ~1e-5 from the plain one's, so
# ~0.3% of them round the other way) spread through the layer's bf16
# GEMMs, whose outputs then round the other way ever more often: up to
# 3.3e-3 in relative norm for one layer and 1.3e-2 end to end on the
# card, with random weights.


def _train_kernel_checks(torch, card, timer):
    """Phase 2, the call forms of this slice: K1 (Full T=11 and the AR's
    T=1 over 400 tokens), K2 (the 128-token second chunk of a 384-token
    prompt) and K3 (a Refresh, T=58 over 25 blocks) at the trained
    tiny-dense pair's shapes (H=4, Hk=2, Dh=64, block 16) in fp32, the
    pair's dtype, and bf16; K4's contiguous form at those shapes, bit for
    bit; and K2 as a full-width training feature pass calls it, T=2048 at
    qoff 0 over a 2048-token contiguous cache (llama3.1-8b, bf16).  Each
    against its plain version at TOL_KERNEL, timed beside its bound and
    SDPA.  Returns {kernel: {label: row}}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kvcache.cache import (init_contiguous_kv,
                                           update_layer_summaries)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2048)
    out = {"sparse_verify_attention": {}, "paged_prefill_attention": {},
           "retrieval_score": {}, "block_summary": {}}

    def rnd(dtype, *shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def contiguous(dtype, layers, max_len, hk, dh, bs):
        k, v = init_contiguous_kv(layers, 1, max_len, bs, hk, dh, dtype,
                                  "cuda")
        k.copy_(rnd(dtype, *k.shape))
        v.copy_(rnd(dtype, *v.shape))
        return k, v

    h, hk, dh, bs = 4, 2, 64, 16          # the trained tiny-dense pair's
    ctx, max_len = 400, 576
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype)[6:]
        peak = PEAK_FP32_S if dtype == torch.float32 else PEAK_BF16_S
        k, v = contiguous(dtype, 1, max_len, hk, dh, bs)
        k, v = k[0], v[0]
        kf, rows = ops.flat_blocks(k)
        vf, _ = ops.flat_blocks(v)
        nb = rows // bs
        kh, vh = k[:, :ctx].transpose(1, 2), v[:, :ctx].transpose(1, 2)
        for t in (11, 1):
            q = rnd(dtype, 1, t, h, dh)
            length = torch.tensor([ctx], dtype=torch.int32, device="cuda")
            idx, vlen = ops._identity_walk(1, hk, nb, length, max_len, bs)
            label = (f"K1 contiguous Full T={t} ctx={ctx} H=4 Hk=2 Dh=64 "
                     f"bs=16 {dn}")
            out["sparse_verify_attention"][label] = _attn_row(
                torch, card, timer, label,
                lambda q=q, length=length: ops.contiguous_verify_attention(
                    q, k, v, length, bs),
                lambda q=q, idx=idx, vlen=vlen: ref.block_attention_batched(
                    q, kf, vf, idx, vlen, bs),
                *_attn_work(q, vlen, t),
                lambda q=q: F.scaled_dot_product_attention(
                    q.transpose(1, 2), kh, vh, enable_gqa=True), peak=peak)
        t, qoff = 128, 256
        q = rnd(dtype, 1, t, h, dh)
        length = torch.tensor([qoff], dtype=torch.int32, device="cuda")
        tv = torch.tensor([t], dtype=torch.int32, device="cuda")
        idx, vlen = ops._identity_walk(1, hk, nb, length + tv, max_len, bs)
        kpos = torch.arange(qoff + t, device="cuda")
        cmask = kpos[None] <= (qoff + torch.arange(t, device="cuda"))[:, None]
        label = f"K2 contiguous T={t} qoff={qoff} H=4 Hk=2 Dh=64 bs=16 {dn}"
        out["paged_prefill_attention"][label] = _attn_row(
            torch, card, timer, label,
            lambda: ops.block_attention(q, kf, vf, idx, vlen, bs,
                                        q_offset=length),
            lambda: ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                                q_offset=length),
            *_attn_work(q, vlen, t, causal_pairs=int(cmask.sum()) * h),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, : qoff + t].transpose(1, 2),
                v[:, : qoff + t].transpose(1, 2), attn_mask=cmask,
                enable_gqa=True), peak=peak)
        # K3: a Refresh of the tiny path (pending + tree rows) over 25
        # blocks, two query heads per KV head
        label = f"K3 Refresh T=58 NB=25 H=4 Hk=2 Dh=64 {dn}"
        out["retrieval_score"][label] = _score_row(
            torch, card, timer, gen, label, 58, 25, dtype, h, hk, dh)
        # K4: the tiny pair's 4 layers, the 384-token prompt's second chunk
        layers = 4
        k4, _ = contiguous(dtype, layers, max_len, hk, dh, bs)
        nb4 = -(-max_len // bs)
        st = torch.tensor([256], dtype=torch.int32, device="cuda")
        en = torch.tensor([384], dtype=torch.int32, device="cuda")
        got4 = torch.zeros((2, layers, 1, nb4, hk, dh), device="cuda")
        ops.contiguous_block_summaries(k4, st, en, 9, got4[0], got4[1], bs)
        z = torch.zeros((1, nb4, hk, dh), device="cuda")
        for i in range(layers):
            wx, wn = update_layer_summaries(z, z, k4[i], st, en, bs)
            if not (torch.equal(got4[0, i], wx)
                    and torch.equal(got4[1, i], wn)):
                raise AssertionError(f"K4 Dh=64 bs=16 {dn}: layer {i} "
                                     f"differs from the plain version")
        before = dict(ops.LAUNCHES)
        ms = timer.kernel_ms(lambda: ops.contiguous_block_summaries(
            k4, st, en, 9, got4[0], got4[1], bs), "block_summary_kernel")
        ops.LAUNCHES.update(before)
        plain_ms = timer(lambda: [update_layer_summaries(z, z, k4[i], st, en,
                                                         bs)
                                  for i in range(layers)], iters=3, warmup=1)
        kb = ops.flat_blocks(k4)[0].view(layers * nb4, bs, hk, dh)
        blocks = (torch.arange(layers, device="cuda")[:, None] * nb4
                  + torch.arange(16, 24, device="cuda")[None]).reshape(-1)
        lib_ms = timer(lambda: torch.aminmax(kb[blocks], dim=1))
        n_tok = layers * 128
        bound, by = _bound_ms(n_tok * hk * dh * k4.element_size()
                              + 2 * layers * 8 * hk * dh * 4 + 8,
                              2 * n_tok * hk * dh, PEAK_FP32_S)
        label = f"K4 contiguous [256, 384) L=4 Hk=2 Dh=64 bs=16 {dn}"
        say(card, f"kernel {label}: bit-equal to the plain per-layer "
                  f"version; ms {ms:.4f} ({timer.source}) plain_ms "
                  f"{plain_ms:.4f} bound_us {bound * 1e3:.3f} ({by}) "
                  f"library_ms {lib_ms:.4f} (torch.aminmax)")
        out["block_summary"][label] = dict(
            max_abs_err=0.0, ms=ms, timing=timer.source, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del k, v, kf, vf, k4
    # K2 as the full-width feature pass calls it: the whole sequence
    bf = torch.bfloat16
    k, v = contiguous(bf, 1, TRAIN_SEQ, 8, 128, 128)
    k, v = k[0], v[0]
    kf, rows = ops.flat_blocks(k)
    vf, _ = ops.flat_blocks(v)
    t = TRAIN_SEQ
    q = rnd(bf, 1, t, 32, 128)
    length = torch.zeros((1,), dtype=torch.int32, device="cuda")
    tv = torch.tensor([t], dtype=torch.int32, device="cuda")
    idx, vlen = ops._identity_walk(1, 8, rows // 128, length + tv, t, 128)
    cmask = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()
    label = f"K2 contiguous T={t} qoff=0 (training feature pass, llama)"
    out["paged_prefill_attention"][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.block_attention(q, kf, vf, idx, vlen, 128,
                                    q_offset=length),
        lambda: ref.block_attention_batched(q, kf, vf, idx, vlen, 128,
                                            q_offset=length),
        *_attn_work(q, vlen, t, causal_pairs=int(cmask.sum()) * 32),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True))
    del k, v, kf, vf, q
    torch.cuda.empty_cache()
    return out


def _score_row(torch, card, timer, gen, label, t, nbs, dtype, h, hk, dh):
    """One K3 call at the heads given, against its plain version (two
    calls bit-equal, one launch), timed beside its plain version and its
    bound.  Returns the row."""
    from repro_torch.kernels import ops, ref
    q, kmax, kmin, qw = _score_inputs(torch, gen, t, nbs, dtype, h=h,
                                      hk=hk, dh=dh)
    got = ops.retrieval_scores(q, kmax, kmin, qw)
    again = ops.retrieval_scores(q, kmax, kmin, qw)
    want = ref.retrieval_score_batched(q, kmax, kmin, qw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls differ")
    _close(label, got, want)
    before = dict(ops.LAUNCHES)
    ms = timer.kernel_ms(lambda: ops.retrieval_scores(q, kmax, kmin, qw),
                         "retrieval_score_kernel")
    if timer.per_call != 1:
        raise AssertionError(f"K3: {timer.per_call} launches per call")
    ops.LAUNCHES.update(before)
    plain_ms = timer(lambda: ref.retrieval_score_batched(q, kmax, kmin, qw),
                     iters=3, warmup=1)
    nbytes = (q.numel() * q.element_size() + 2 * kmax.numel() * 4
              + t * 4 + hk * nbs * 4)
    bound, by = _bound_ms(nbytes, 2 * 2 * dh * (h // hk) * t * hk * nbs,
                          PEAK_FP32_S)
    err = (got - want).abs().max().item()
    say(card, f"kernel {label}: max_abs_err {err:.3e} (tol {TOL_KERNEL} "
              f"of max |plain|; two calls bit-equal) ms {ms:.4f} "
              f"({timer.source}) plain_ms {plain_ms:.4f} bound_us "
              f"{bound * 1e3:.3f} ({by}) library_ms none")
    return dict(max_abs_err=err, ms=ms, timing=timer.source,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def _train_steps(torch, card, label, data, pieces, steps=TRAIN_STEPS):
    """One warm-up step, then ``steps`` timed: each step runs ``pieces``
    (name, fn(tokens, carried) -> carried) in order between CUDA events.
    Returns the per-piece and whole-step device ms (means over the timed
    steps), the losses of every step and the peak memory."""
    import math
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per = {name: [] for name, _ in pieces}
    losses = []
    for i in range(steps + 1):
        tokens = next(data)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(pieces) + 1)]
        ev[0].record()
        carried = None
        for j, (name, fn) in enumerate(pieces):
            carried = fn(tokens, carried)
            ev[j + 1].record()
        torch.cuda.synchronize()
        losses.append(float(carried["loss"]))
        if i:
            for j, (name, _) in enumerate(pieces):
                per[name].append(ev[j].elapsed_time(ev[j + 1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    ms = {name: sum(v) / len(v) for name, v in per.items()}
    return dict(ms=ms, step_ms=sum(ms.values()), losses=losses,
                peak_gib=peak)


def _feature_layers_vs_plain(torch, cfg, params, tokens):
    """Every layer of the feature pass (a prefill of the whole sequence
    into a fresh contiguous cache), from the plain route's hidden state
    entering it: K2 over the layer's q, k and v against the plain
    attention at TOL_KERNEL (m, l, acc, the output; raises otherwise),
    then the layer on both routes, whose K4 summaries must be bit-equal
    to the plain ones.  Returns (K2's largest relative error, each
    layer's bf16 output relative norm error)."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.kvcache.cache import init_contiguous_kv
    from repro_torch.models import api
    from repro_torch.models import blocks as bk
    from repro_torch.models import common as cm
    from repro_torch.models import dense as dn
    one = cfg.replace(num_layers=1)
    b, s = tokens.shape
    bs, hk, dh = 128, cfg.num_kv_heads, cfg.head_dim_
    positions = torch.arange(s, device="cuda", dtype=torch.int32)[None]
    inv_freq = cm.rope_inv_freq_tensor(cfg, tokens.device)
    mscale = cm.yarn_mscale(cfg)
    length = torch.zeros((b,), dtype=torch.int32, device="cuda")
    tv = torch.full((b,), s, dtype=torch.int32, device="cuda")
    k2_err, errs = 0.0, []
    with torch.no_grad():
        h = dn.embed_tokens(cfg, params, tokens)
        for i, lp in enumerate(params["layers"]):
            x = cm.rmsnorm(h, lp["norm1"], cfg.norm_eps)
            q = bk.project_q(cfg, lp["attn"], x, positions, inv_freq,
                             mscale)
            k, v = bk.project_kv(cfg, lp["attn"], x, positions, inv_freq,
                                 mscale)
            kc, vc = init_contiguous_kv(1, b, s, bs, hk, dh, k.dtype, "cuda")
            kc[0].copy_(k)
            vc[0].copy_(v)
            kf, rows = ops.flat_blocks(kc[0])
            vf, _ = ops.flat_blocks(vc[0])
            idx, vlen = ops._identity_walk(b, hk, rows // bs, length + tv, s,
                                           bs)
            got = ops.block_attention(q, kf, vf, idx, vlen, bs,
                                      q_offset=length)
            want = ref.block_attention_batched(q, kf, vf, idx, vlen, bs,
                                               q_offset=length)
            out_g = got[2] / got[1].clamp(min=1e-30)[..., None]
            out_w = want[2] / want[1].clamp(min=1e-30)[..., None]
            k2_err = max(k2_err, *(_close(f"feature pass layer {i} K2 {nm}",
                                          g, w) for nm, g, w in (
                ("m", got[0], want[0]), ("l", got[1], want[1]),
                ("acc", got[2], want[2]), ("out", out_g, out_w))))
            outs, sums = [], []
            for plain in (True, False):
                cache = api.init_cache(one, b, s, None, device="cuda")
                outs.append(dn.trunk_fwd(
                    one, [lp], h, positions, mode="prefill", cache=cache,
                    spec=SpecPVConfig(), plain=plain,
                    collect_features=False).h.float())
                sums.append((cache["kmax"], cache["kmin"]))
            if not (torch.equal(sums[0][0], sums[1][0])
                    and torch.equal(sums[0][1], sums[1][1])):
                raise AssertionError(f"feature pass layer {i}: K4's "
                                     f"summaries differ from the plain ones")
            errs.append((torch.linalg.vector_norm(outs[1] - outs[0])
                         / torch.linalg.vector_norm(outs[0])).item())
            h = outs[0].to(h.dtype)
    return k2_err, errs


def _train_draft_full_width(torch, card):
    """(a) The EAGLE-3 draft trained at full width against the frozen
    32-layer llama3.1-8b target (bf16, random weights from seed 0), the
    paper's ``DraftConfig()`` (TTT steps 4), batch 1, S = TRAIN_SEQ."""
    from repro_torch.artifacts import corpus_for
    from repro_torch.configs import DraftConfig, get_config
    from repro_torch.data import batch_iterator
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.train.draft_train import DraftTrainConfig, DraftTrainer
    from repro_torch.train.optimizer import tree_leaves
    cfg, dcfg = get_config("llama3.1-8b"), DraftConfig()
    params = api.init_params(cfg, seed=0, device="cuda")
    dtr = DraftTrainer(cfg, dcfg, params, DraftTrainConfig(
        total_steps=TRAIN_STEPS + 1, warmup=1, log_every=1), seed=1,
        device="cuda")
    batches = batch_iterator(corpus_for(cfg), batch=1, seq_len=TRAIN_SEQ)
    data = (torch.as_tensor(b[:, :-1], device="cuda") for b in batches)
    feat_launches = []

    def feats(tokens, _):
        before = ops.launch_counts()
        f = dtr.features(tokens)
        feat_launches.append(ops.launch_count_delta(
            before, ops.launch_counts())[0])
        return dict(tokens=tokens, feats=f)

    def loss(tokens, c):
        c["loss"], c["metrics"] = dtr.loss_and_grads(tokens, c["feats"])
        return c

    def update(tokens, c):
        c["update"] = dtr.update()
        return c
    res = _train_steps(torch, card, "draft training",
                       data, [("feature pass", feats),
                              ("TTT loss + backward", loss),
                              ("clip + AdamW", update)])
    want = {"paged_prefill_attention": cfg.num_layers, "block_summary": 1}
    if any(fl != want for fl in feat_launches):
        raise AssertionError(f"feature pass launches {feat_launches} != "
                             f"{want} per pass")
    # the feature pass against the plain route; the launches of the
    # comparison are not the path's
    counts = ops.launch_counts()
    tokens = torch.as_tensor(next(batches)[:, :-1], device="cuda")
    k2_err, layer_err = _feature_layers_vs_plain(torch, cfg,
                                                 dtr.target_params, tokens)
    got = dtr.features(tokens).float()
    with torch.no_grad():
        cache = api.init_cache(cfg, 1, TRAIN_SEQ, None, device="cuda")
        _, f, _ = api.prefill(cfg, dtr.target_params, tokens, cache,
                              plain=True)
        want_f = f.fused_input().float()
    ops.set_launch_counts(counts)
    rel = (torch.linalg.vector_norm(got - want_f)
           / torch.linalg.vector_norm(want_f)).item()
    rel_max = ((got - want_f).abs().max() / want_f.abs().max()).item()
    n_draft = sum(p.numel() for p in tree_leaves(dtr.dparams))
    say(card, f"train (a) draft at full width: llama3.1-8b target 32 layers "
              f"bf16 frozen, DraftConfig() ttt_steps {dcfg.ttt_steps}, "
              f"{n_draft / 1e6:.1f} M draft params, batch 1, S {TRAIN_SEQ} "
              f"(cut from the paper's 32K): ms/step {res['step_ms']:.2f} = "
              + " + ".join(f"{k} {v:.2f}" for k, v in res["ms"].items())
              + f" (CUDA events, mean of {TRAIN_STEPS} after 1 warm-up) "
              f"peak_mem_gib {res['peak_gib']:.2f} losses "
              f"{[round(x, 4) for x in res['losses']]} feature pass "
              f"launches {feat_launches[0]} per pass; at each of the "
              f"{cfg.num_layers} layers, on the plain route's input: K2's "
              f"partials within max rel err {k2_err:.3e} of the plain "
              f"attention's (tol {TOL_KERNEL}), K4's summaries bit-equal; "
              f"not held: a layer's bf16 output against the plain route's "
              f"relative norm error at most {max(layer_err):.3e} (mean "
              f"{sum(layer_err) / len(layer_err):.3e}), the whole pass's "
              f"features {rel:.3e} (largest element {rel_max:.3e} of the "
              f"largest magnitude)")
    del dtr, params
    torch.cuda.empty_cache()
    return dict(res, feature_launches=feat_launches[0],
                feature_k2_err=k2_err, feature_layer_err=max(layer_err),
                feature_rel_err=rel,
                feature_max_rel_err=rel_max,
                draft_params=n_draft, seq=TRAIN_SEQ, ttt_steps=dcfg.ttt_steps)


def _train_target_cut(torch, card):
    """(b) Target training at llama3.1-8b width, depth cut to
    TARGET_TRAIN_LAYERS, batch 1, S = TRAIN_SEQ."""
    from repro_torch.artifacts import corpus_for
    from repro_torch.configs import get_config
    from repro_torch.data import batch_iterator
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_config("llama3.1-8b").replace(num_layers=TARGET_TRAIN_LAYERS)
    tr = Trainer(cfg, TrainConfig(total_steps=TRAIN_STEPS + 1, warmup=1,
                                  log_every=1), seed=0, device="cuda")
    batches = batch_iterator(corpus_for(cfg), batch=1, seq_len=TRAIN_SEQ)
    data = (torch.as_tensor(b, device="cuda") for b in batches)

    def loss(tokens, _):
        out, _m = tr.loss_and_grads(tokens)
        return dict(loss=out)

    def update(tokens, c):
        c["update"] = tr.update()
        return c
    res = _train_steps(torch, card, "target training", data,
                       [("forward + backward", loss),
                        ("clip + AdamW", update)])
    n = sum(p.numel() for p in tree_leaves(tr.params))
    say(card, f"train (b) target at llama3.1-8b width, {TARGET_TRAIN_LAYERS} "
              f"of 32 layers (AdamW state of 32 does not fit), "
              f"{n / 1e9:.3f} B params bf16, remat per layer, batch 1, S "
              f"{TRAIN_SEQ}: ms/step {res['step_ms']:.2f} = "
              + " + ".join(f"{k} {v:.2f}" for k, v in res["ms"].items())
              + f" (CUDA events, mean of {TRAIN_STEPS} after 1 warm-up) "
              f"peak_mem_gib {res['peak_gib']:.2f} losses "
              f"{[round(x, 4) for x in res['losses']]}")
    del tr
    torch.cuda.empty_cache()
    return dict(res, params=n, layers=TARGET_TRAIN_LAYERS)


def _load_script(rel):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(rel))[0], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table1_on_card(torch, card):
    """(c) The paper's metric on a pair trained on the card: the reference
    recipe (``get_trained_pair("tiny-dense")``, fp32, trained afresh),
    then the table-1 twin with ``--quick`` (contexts 192 and 384,
    EAGLE3-full, SpecPV-64 and SpecPV-128, 32 new tokens, graphs on)."""
    from repro_torch.artifacts import get_trained_pair
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    get_trained_pair("tiny-dense", force=True, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hashseed = os.environ.get("PYTHONHASHSEED", "unset")
    say(card, f"train (c) tiny-dense pair, the reference recipe (target 200 "
              f"steps, draft 150, batch 8, seq 128, fp32) on the card: "
              f"{train_s:.1f} s wall (corpus batches made on the host "
              f"included); PYTHONHASHSEED {hashseed}")
    t0 = time.perf_counter()
    res = _load_script("benchmarks/bench_table1_speedup_torch.py").main(
        ["--quick", "--device", "cuda"])
    twin_s = time.perf_counter() - t0
    if not all(res["ar_equal"].values()):
        raise AssertionError(f"compiled AR != plain AR oracle: "
                             f"{res['ar_equal']}")
    for d in res["details"]:
        say(card, f"table1 context {d['context']} {d['method']}: alpha_wall "
                  f"{d['alpha_wall']:.4f} fwd_reduction "
                  f"{d['fwd_reduction']:.4f} tau {d['tau']:.4f} agree "
                  f"{d['agree']:.4f} (ms {d['seconds'] * 1e3:.2f} against "
                  f"compiled AR {d['ar_seconds'] * 1e3:.2f}) modes "
                  f"{d['modes']}; PYTHONHASHSEED {hashseed}")
        if d["method"] == "EAGLE3-full" and not d["lossless"]:
            raise AssertionError(f"EAGLE3-full != AR at context "
                                 f"{d['context']} (fp32)")
        if d["method"] != "EAGLE3-full" and not d["tau"] > 1.0:
            raise AssertionError(f"{d['method']} at context {d['context']}: "
                                 f"mean_accept {d['tau']} <= 1")
    say(card, f"table1 twin --quick took {twin_s:.1f} s: compiled AR == "
              f"plain AR oracle {res['ar_equal']}, EAGLE3-full == AR, "
              f"mean_accept > 1 in every SpecPV row")
    return dict(train_s=train_s, twin_s=twin_s, details=res["details"],
                hashseed=hashseed)


def phase_train(torch, card):
    """Phase 10: (a) draft training at full width, (b) target training at
    full width and 4 layers, (c) the reference recipe's pair trained on
    the card and the table-1 twin over it."""
    import gc
    from repro_torch.kernels import ops
    # earlier phases' engines hold their CUDA graphs' pools through
    # reference cycles (bodies that close over the engine) until the
    # cyclic collector runs; training at full width needs that memory
    gc.collect()
    torch.cuda.empty_cache()
    say(card, f"phase 10 starts with "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    a = _train_draft_full_width(torch, card)
    b = _train_target_cut(torch, card)
    c = _table1_on_card(torch, card)
    launches = dict(ops.LAUNCHES)
    for k in LLAMA_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched in phase 10")
    secs = time.perf_counter() - t0
    say(card, f"phase 10 launches (feature passes, the pair's draft "
              f"training, the table-1 twin) {launches}; phase 10 took "
              f"{secs:.1f} s")
    return dict(draft=a, target=b, table1=c, launches=launches,
                seconds=secs)


# ---------------------------------------------------------------------------
# phase 11: sampled serving
# ---------------------------------------------------------------------------

SAMPLED_TEMP = 0.8
# the arms of bench_serving.py --sampled, and one mixing the three kinds in
# one batch: (temperature, draft) of request i is kinds[i % len(kinds)]
SAMPLED_ARMS = (("greedy-tree", ((0.0, "tree"),)),
                ("sampled-chain", ((SAMPLED_TEMP, "chain"),)),
                ("sampled-tree", ((SAMPLED_TEMP, "tree"),)),
                ("mixed", ((0.0, "tree"), (SAMPLED_TEMP, "chain"),
                           (SAMPLED_TEMP, "tree"))))
# the arms serve phase 6's prompts with half its new tokens (slice 22's
# cut of decode ticks)
SAMPLED_REQS = ((2048, 16), (3072, 32), (4608, 32), (6144, 32), (8192, 32),
                (8192, 32))
RWKV_SAMPLED_PROMPT = 2048      # phase 5's 8192 cut to keep the budget
RWKV_SAMPLED_NEW = 16          # eager and graphs (slice 22 cut it from 32)


def _arm_keys_ok(name, keys):
    """Each arm's steps are keyed by its kinds: (has_sampled, has_chain)
    never set for the greedy arm, both for the chain arm, the first only
    for the tree arm, both in some step of the mixed one."""
    flags = {k[3:] for k in keys}
    want = {"greedy-tree": {(False, False)}, "sampled-chain": {(True, True)},
            "sampled-tree": {(True, False)}}.get(name)
    return flags == want if want else (True, True) in flags


def _sampled_arms(torch, card, cfg, spec, dcfg, params, dparams, prompts):
    """(a): the arms on one server (``ServingConfig()``'s layout, batch 4),
    each on a fresh scheduler (captured graphs stay).  Returns (per-arm
    numbers, summed launches, the engine)."""
    import numpy as np
    from repro_torch.serving import ServingConfig, ServingEngine
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256), device="cuda")
    arms, total, peak_all, eng, toks = {}, {}, 0.0, None, {}
    for name, kinds in SAMPLED_ARMS:
        srv.reset_warm()
        keys0 = dict(eng.dispatch_keys) if eng else {}
        chunks0 = eng.prefill_dispatches if eng else 0
        graphs0 = len(eng._graphs) if eng else 0
        outs, wall, launches, peak = _serve(
            torch, srv, _serving_requests(prompts, SAMPLED_REQS, kinds))
        sched = srv._continuous
        eng, st = sched.engine, srv.stats
        if eng.paged or not eng.gathered:
            raise AssertionError("ServingConfig() serves contiguous slots "
                                 "with the gathered partial cache")
        for i, (n, new) in enumerate(SAMPLED_REQS):
            o = outs[f"r{i}"]
            if (o.finish_reason != "length" or len(o.tokens) != new
                    or o.tokens.min() < 0
                    or o.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"{name} r{i}: {o.finish_reason}, "
                                     f"{len(o.tokens)} tokens")
        keys = {k: n - keys0.get(k, 0) for k, n in eng.dispatch_keys.items()
                if n > keys0.get(k, 0)}
        want = _implied_launches(keys, eng.prefill_dispatches - chunks0,
                                 cfg.num_layers)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"{name}: launches {got} != {want} implied "
                                 f"by {keys}")
        ticks = sum(int(v) for k, v in st.items()
                    if k.startswith("ticks_wall_"))
        if st["steps"] != ticks:
            raise AssertionError(f"{name}: {st['steps']} dispatches in "
                                 f"{ticks} decode ticks")
        if not _arm_keys_ok(name, keys):
            raise AssertionError(f"{name}: step keys {keys}")
        if not (st["mode_rows_refresh"] and st["mode_rows_partial"]):
            raise AssertionError(f"{name}: the ticks must run Refresh and "
                                 f"Partial rows: {dict(st)}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        peak_all = max(peak_all, peak)
        ntok = int(sum(len(o.tokens) for o in outs.values()))
        by_kind = {}
        for i in range(len(SAMPLED_REQS)):
            by_kind.setdefault("%s-%s" % kinds[i % len(kinds)], []).append(
                outs[f"r{i}"].mean_accept)
        accept = {k: float(np.mean(v)) for k, v in by_kind.items()}
        wall_by = {c: (len(v), 1e3 * float(np.median(v)))
                   for c, v in sched.tick_wall.items()}
        toks[name] = {k: o.tokens for k, o in outs.items()}
        arms[name] = dict(tokens_per_s=ntok / wall, wall_s=wall,
                          mean_accept=accept, ticks=wall_by,
                          dispatches_per_tick=st["steps"] / ticks,
                          new_graphs=len(eng._graphs) - graphs0,
                          keys={str(k): n for k, n in keys.items()},
                          launches=got, peak_gib=peak)
        say(card, f"sampled serving [{name}] llama3.1-8b batch 4 "
                  f"ServingConfig(), kinds {kinds} (T {SAMPLED_TEMP}): "
                  f"tokens {ntok} wall_s {wall:.3f} tokens_per_s "
                  f"{ntok / wall:.2f} (graph captures of this arm's new "
                  f"variants included) mean_accept by kind {accept} tick "
                  f"wall ms by class (ticks, median) {wall_by} dispatches "
                  f"per tick {st['steps'] / ticks:.2f} new graphs "
                  f"{len(eng._graphs) - graphs0} peak_mem_gib {peak:.2f} "
                  f"launches {got} == implied by {arms[name]['keys']}")
    want_graphs = _prefill_graph_keys(eng) | set(eng.dispatch_keys)
    if set(eng._graphs) != want_graphs:
        raise AssertionError(f"graphs {sorted(map(str, eng._graphs))} != "
                             f"{sorted(map(str, want_graphs))}")
    same = {rid: bool(np.array_equal(toks["mixed"][rid],
                                     toks["greedy-tree"][rid]))
            for rid in toks["mixed"] if int(rid[1:]) % 3 == 0}
    say(card, f"sampled serving: {len(eng._graphs)} graphs captured "
              f"{sorted(map(str, eng._graphs))} capture_s "
              f"{eng.capture_s:.3f} peak_mem_gib {peak_all:.2f}; the mixed "
              f"arm's greedy rows equal the greedy arm's (bf16, reported): "
              f"{same}")
    return arms, total, eng, srv


def _profile_arm_ticks(torch, card, eng, prompts, ticks: int = 2):
    """On the arms' engine, four 4608-token slots of kinds greedy tree,
    sampled chain, sampled tree, sampled tree (seeds 0-3); then for each
    arm the rows of its kinds step (all four for the mixed arm), once to
    capture its variant, then ``ticks`` Partial ticks under
    ``torch.profiler`` (a Refresh tick runs first where the automaton
    asks for one): device busy ms, device launches and host launch calls
    per tick.  Then each sampled or chain variant's body, run eagerly
    under ``set_sync_debug_mode("error")``."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import MODE_PARTIAL
    kinds = ((0.0, "tree"), (SAMPLED_TEMP, "chain"), (SAMPLED_TEMP, "tree"),
             (SAMPLED_TEMP, "tree"))
    st = eng.empty_state()
    for i, ((t, d), p) in enumerate(zip(kinds, prompts[2:6])):
        st, _ = eng.prefill_into_slot(st, i, p[:4608], temperature=t, seed=i,
                                      draft=d, max_new_tokens=256)
    masks = {"greedy-tree": [1, 0, 0, 0], "sampled-chain": [0, 1, 0, 0],
             "sampled-tree": [0, 0, 1, 1], "mixed": [1, 1, 1, 1]}
    out, by_kernel = {}, {}
    for name, mask in masks.items():
        rows = np.asarray(mask, bool)
        st, _ = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        busy = dev_n = calls_n = 0.0
        kms = by_kernel.setdefault(name, {})
        for _ in range(ticks):
            modes = eng.modes_for_rows(st, rows)
            while not (modes[rows] == MODE_PARTIAL).all():
                st, _ = eng.step_fused(st, rows, modes)
                modes = eng.modes_for_rows(st, rows)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                st, _ = eng.step_fused(st, rows, modes)
                torch.cuda.synchronize()
            b, _ = _device_busy(prof)
            d, _, c = _launch_counts(prof)
            busy, dev_n, calls_n = busy + b, dev_n + d, calls_n + c
            for e in prof.key_averages():
                if getattr(e, "device_type", None) == DeviceType.CUDA:
                    ms, n = kms.get(e.key, (0.0, 0))
                    kms[e.key] = (ms + _dev_us(e) / 1e3 / ticks,
                                  n + e.count // ticks)
        out[name] = dict(busy_ms=busy / ticks, device_launches=dev_n / ticks,
                         host_launch_calls=calls_n / ticks)
        say(card, f"sampled profile [{name}] rows {mask}: {ticks} Partial "
                  f"ticks (4 x 4608 tokens): device busy_ms/tick "
                  f"{busy / ticks:.2f} device launches/tick "
                  f"{dev_n / ticks:.1f} host launch calls/tick "
                  f"{calls_n / ticks:.1f}")
    g, s = out["greedy-tree"]["busy_ms"], out["sampled-tree"]["busy_ms"]
    say(card, f"sampled profile: a sampled-tree Partial tick {s:.2f} device "
              f"ms against {g:.2f} greedy (+{s - g:.2f} ms, the whole batch "
              f"computes either way)")
    gk, sk = by_kernel["greedy-tree"], by_kernel["sampled-tree"]
    diff = sorted(((sk[k][0] - gk.get(k, (0.0, 0))[0],
                    sk[k][1] - gk.get(k, (0.0, 0))[1], k) for k in sk),
                  reverse=True)
    for ms, n, k in diff[:12]:
        say(card, f"sampled profile, sampled-tree minus greedy: {ms:8.3f} "
                  f"ms/tick {n:6d} launches/tick  {k[:90]}")
    # the sampled and chain bodies under the sync check, on these slots
    graphs, eng.cuda_graphs = eng.cuda_graphs, False
    bodies = []
    try:
        for key in sorted(k for k in eng.dispatch_keys if k[3] or k[4]):
            eng._tick_in.copy_(torch.tensor(
                [[MODE_PARTIAL if key[1] else 0] * 4, [1, 1, 1, 1],
                 [0, 1, 0, 0]], dtype=torch.int8, device="cuda"))
            _no_sync(torch, lambda key=key: eng._fused_body(*key))
            bodies.append(str(key))
    finally:
        eng.cuda_graphs = graphs
    torch.cuda.synchronize()
    say(card, f"sampled sync check: the bodies of {bodies} ran eagerly "
              f"under set_sync_debug_mode('error') without a sync")
    return out


def _rwkv_sampled(torch, card):
    """(b) rwkv6-3b at full width, sampled chain ``generate`` at
    temperature 0.8 (row 0 of seed 0's stream), eagerly and with graphs:
    equal tokens and launch counts, K5 32 x (prefill chunks + 2 x
    steps), the sampled state body under the sync check."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    from repro_torch.models.api import init_params
    cfg = get_config("rwkv6-3b")
    spec, dcfg = SpecPVConfig(), DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    n, new = RWKV_SAMPLED_PROMPT, RWKV_SAMPLED_NEW
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int64)
    max_len = request_token_need(n, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    runs = {}
    for graphs in (False, True):
        label = RUN_LABEL[graphs]
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=False,
                           temperature=SAMPLED_TEMP, device="cuda",
                           cuda_graphs=graphs)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = cfg.num_layers * (-(-n // 256) + 2 * stats["steps"])
        if launches["wkv"] != want or stats["modes"] != {
                "state": stats["steps"]}:
            raise AssertionError(f"rwkv sampled [{label}]: wkv "
                                 f"{launches['wkv']} != {want} or modes "
                                 f"{stats['modes']}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"rwkv sampled tokens out of range")
        say(card, f"rwkv6-3b sampled chain generate [{label}] T "
                  f"{SAMPLED_TEMP}, prompt {n} (phase 5: 8192), new {new}: "
                  f"steps {stats['steps']} mean_accept "
                  f"{stats['mean_accept']:.4f} wall_s {wall:.3f} "
                  f"tokens_per_s {new / wall:.2f} wkv launches "
                  f"{launches['wkv']} (= {cfg.num_layers} x "
                  f"({-(-n // 256)} chunks + 2 x {stats['steps']} steps)) "
                  f"graphs {sorted(map(str, eng._graphs))}")
        runs[label] = dict(toks=toks, launches=launches, wall_s=wall,
                           tokens_per_s=new / wall,
                           mean_accept=stats["mean_accept"])
        if not graphs:
            eng.prefill(prompt[:, :512])
            _no_sync(torch, eng._state_body)
            say(card, "rwkv sampled sync check: the sampled state body ran "
                      "eagerly under set_sync_debug_mode('error')")
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, "rwkv6-3b sampled", runs)
    del params, dparams
    torch.cuda.empty_cache()
    return runs["graphs"]


def _sampled_fp32_checks(torch, card, new: int = 32):
    """(c) fp32 at full width, 4 layers, TF32 off, with graphs, on
    ``ServingConfig()``'s layout at batch 3 (prompts of 3000, 4800 and
    5300 tokens: Full, Refresh and Partial ticks): the greedy request of a
    mixed batch (greedy tree, sampled tree, sampled chain) equals its
    tokens in an all-greedy batch; the sampled requests give the same
    tokens alone and admitted in another order; on the paged pool, a fork
    of a sampled slot replays its source's tokens."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, spec, dcfg, params, dparams, _, _ = _lossless_setup(torch, 16, 1)
    rng = np.random.default_rng(1)
    prompts = {r: rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for r, n in (("g", 3000), ("s", 4800), ("c", 5300))}
    kinds = {"g": (0.0, "tree"), "s": (SAMPLED_TEMP, "tree"),
             "c": (SAMPLED_TEMP, "chain")}
    seeds = {"g": 1, "s": 7, "c": 9}
    max_len = 5632
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=3, max_len=max_len), device="cuda")
    t0 = time.perf_counter()

    def serve(order, greedy=False):
        srv.reset_warm()
        for r in order:
            t, d = (0.0, "tree") if greedy else kinds[r]
            srv.submit(Request(request_id=r, prompt=prompts[r],
                               max_new_tokens=new, temperature=t,
                               seed=seeds[r], draft=d))
        srv.run()
        return {r: srv.outputs[r].tokens for r in order}
    mixed = serve(["g", "s", "c"])
    modes = {k: int(v) for k, v in srv.stats.items()
             if k.startswith("mode_rows_")}
    checks = [("the greedy row == an all-greedy batch's",
               serve(["g", "s", "c"], greedy=True)["g"], mixed["g"]),
              ("the sampled tree request alone", serve(["s"])["s"],
               mixed["s"])]
    reordered = serve(["c", "s", "g"])
    checks += [("the sampled tree request admitted second of c, s, g",
                reordered["s"], mixed["s"]),
               ("the sampled chain request admitted first",
                reordered["c"], mixed["c"])]
    for label, got, want in checks:
        if not np.array_equal(got, want):
            raise AssertionError(f"fp32 sampled serving: {label} differs:\n"
                                 f"{got}\n{want}")
    del srv
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=2,
                       max_len=max_len, paged=True, zero_copy=True,
                       device="cuda")
    st = eng.empty_state()
    st, first = eng.prefill_into_slot(st, 0, prompts["s"],
                                      temperature=SAMPLED_TEMP, seed=7)
    st = eng.fork_slot(st, 0, 1)
    rows = np.ones((2,), bool)
    toks = {0: [first], 1: [first]}
    for _ in range(8):
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in (0, 1):
            toks[i].extend(int(x) for x in so.tokens[i, :so.counts[i]])
    if toks[0] != toks[1] or len(toks[0]) < 9:
        raise AssertionError(f"fork of a sampled slot: {toks}")
    say(card, f"sampled fp32 llama3.1-8b x4 layers, graphs, ServingConfig() "
              f"batch 3, prompts 3000/4800/5300, {new} new tokens (mode rows "
              f"{modes}): " + "; ".join(lb for lb, _, _ in checks)
              + f" equal; a fork of a sampled slot replays its source "
              f"({len(toks[0])} tokens each over 8 ticks); "
              f"{time.perf_counter() - t0:.1f} s")
    del eng, params, dparams
    torch.cuda.empty_cache()


def _sampled_trained_pair(torch, card, n: int = 256, new: int = 4):
    """(d) On phase 10's trained tiny pair (fp32): tau greedy and at
    temperature 0.8 over eight 192-token corpus prompts (32 new tokens),
    and ``n`` requests of one 24-token corpus prompt at 0.8 (seeds
    0..n-1, batch 8, every tick Full) against the port's
    ``autoregressive_sample`` (seeds 10000..) by the reference's
    two-sample bound (4 sigma of the pooled frequency plus 0.02)."""
    import numpy as np
    from repro_torch.artifacts import corpus_for, get_trained_pair
    from repro_torch.configs import SpecPVConfig
    from repro_torch.core.reference import autoregressive_sample
    from repro_torch.data import continuation_task
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    cfg, dcfg, params, dparams = get_trained_pair("tiny-dense",
                                                  device="cuda")
    spec = SpecPVConfig(block_size=16, num_sink_blocks=1,
                        retrieval_budget_blocks=4, local_window_blocks=2,
                        buffer_size=48)
    corpus = corpus_for(cfg)
    prompts, _ = continuation_task(corpus, batch=8, context_len=192)
    tau = {}
    for temp in (0.0, SAMPLED_TEMP):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=8, max_len=416), device="cuda")
        for i, p in enumerate(prompts):
            srv.submit(Request(request_id=f"t{i}", prompt=p,
                               max_new_tokens=32, temperature=temp, seed=i))
        srv.run()
        tau[temp] = float(np.mean([o.mean_accept
                                   for o in srv.outputs.values()]))
        del srv
    prompt = prompts[0, :24]
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=8, max_len=128), device="cuda")
    for i in range(n):
        srv.submit(Request(request_id=f"r{i}", prompt=prompt,
                           max_new_tokens=new, temperature=SAMPLED_TEMP,
                           seed=i))
    srv.run()
    if srv.stats.get("mode_rows_refresh") or srv.stats.get(
            "mode_rows_partial"):
        raise AssertionError(f"the distribution check must verify Full "
                             f"only: {dict(srv.stats)}")
    spec_toks = np.stack([srv.outputs[f"r{i}"].tokens for i in range(n)])
    ar = autoregressive_sample(cfg, params, np.tile(prompt[None], (n, 1)),
                               new, max_len=32, temperature=SAMPLED_TEMP,
                               seeds=list(range(10_000, 10_000 + n)),
                               spec=spec, device="cuda")
    worst = 0.0
    for pos in range(new):
        fs = np.bincount(spec_toks[:, pos], minlength=cfg.vocab_size) / n
        fa = np.bincount(ar[:, pos], minlength=cfg.vocab_size) / n
        p = (fs + fa) / 2
        bound = 4 * np.sqrt(2 * p * (1 - p) / n) + 0.02
        worst = max(worst, float(np.max(np.abs(fs - fa) / bound)))
    if worst > 1.0:
        raise AssertionError(f"trained pair: sampled serving's token "
                             f"frequencies leave the two-sample bound "
                             f"(worst {worst:.3f} of it)")
    say(card, f"sampled trained tiny pair (fp32): tau greedy "
              f"{tau[0.0]:.4f}, at T {SAMPLED_TEMP} {tau[SAMPLED_TEMP]:.4f} "
              f"(8 corpus prompts of 192, 32 new tokens); {n} sampled "
              f"requests vs autoregressive_sample over {new} positions: the "
              f"largest frequency gap is {worst:.3f} of the two-sample "
              f"bound; PYTHONHASHSEED "
              f"{os.environ.get('PYTHONHASHSEED', 'unset')}")
    return dict(tau=tau, worst=worst)


def phase_sampled_serving(torch, card, trained: bool):
    """Phase 11: (a) the arms at full width with their profile and sync
    check, (b) the sampled rwkv6-3b chain, (c) the fp32 identities, (d)
    with ``trained`` (phase 10 ran in this process) its pair's tau and
    distribution check."""
    import gc
    from repro_torch.kernels import ops
    # earlier phases' engines hold their graph pools until the cyclic
    # collector runs (phase 10's finding)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, spec, dcfg, params, dparams, _ = _full_width(
        torch, card, "llama3.1-8b")
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    arms, launches, eng, srv = _sampled_arms(torch, card, cfg, spec, dcfg,
                                             params, dparams, prompts)
    prof = _profile_arm_ticks(torch, card, eng, prompts)
    for name in arms:
        arms[name].update({f"profile_{k}": v for k, v in prof[name].items()})
    del srv, eng, params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    for k in LLAMA_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched in (a)")
    rwkv = _rwkv_sampled(torch, card)
    launches["wkv"] = rwkv["launches"]["wkv"]
    if launches["wkv"] <= 0:
        raise AssertionError("K5 was not launched in (b)")
    _sampled_fp32_checks(torch, card)
    pair = _sampled_trained_pair(torch, card) if trained else None
    secs = time.perf_counter() - t_phase
    say(card, f"phase 11 launches {launches}; phase 11 took {secs:.1f} s")
    return dict(arms=arms, launches=launches, rwkv=dict(
        tokens_per_s=rwkv["tokens_per_s"], mean_accept=rwkv["mean_accept"]),
        pair=pair, seconds=secs)


# ---------------------------------------------------------------------------
# phase 13: tiered KV residency
# ---------------------------------------------------------------------------

# (name, engine keywords): the reference's default codec first
TIER_CODECS = (("int8", dict(tier_codec="int8")),
               ("fp8", dict(tier_codec="fp8")),
               ("lossless", dict(tier_lossless=True)))
# (a)'s forced schedule: a Refresh (demotes the 64 complete blocks), three
# Partial steps with the prefetch issued before the third (one transition
# ahead of the Refresh, as the automaton does), a Refresh (promotes on the
# prefetch hit, then demotes again), a Refresh right after that demotion
# (promotes synchronously) and a Partial step
TIER_SCHEDULE = ("refresh", "partial", "partial", "partial", "refresh",
                 "refresh", "partial")
TIER_PREFETCH_AFTER = 3         # steps run before the prefetch is issued
TIER_SERVE_REQS = SAMPLED_REQS  # (b): phase 6's prompts, half its tokens


def _guard_tier(torch, tm):
    """Wrap the tier manager's operations so that each runs under
    ``torch.cuda.set_sync_debug_mode("error")``: none may wait for the
    card or copy through pageable memory.  Returns {operation: [host ms
    of each call]} (the time the host spends enqueueing it, allocating
    pinned and device buffers included)."""
    host_ms = {}

    def guarded(name, fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
                torch.cuda.set_sync_debug_mode(0)
        return call
    for name in ("demote_slot", "prefetch_slot", "promote_slot"):
        setattr(tm, name, guarded(name, getattr(tm, name)))
    return host_ms


def _tier_log_ms(log):
    """Device ms and bytes of each part of the tier operations a copy log
    holds, in order: [(what, bytes, ms)]."""
    return [(what, nbytes, s.elapsed_time(e)) for what, nbytes, s, e in log]


def _tier_schedule(torch, card, eng, prompt, label):
    """(a)'s forced schedule on ``eng`` after a fresh prefill: the tokens
    and host wall of each step (no synchronisation between steps beyond
    each step's own read of its tokens, so the side stream's copies
    overlap the steps as they would in service), and the tier's counters
    and copy log."""
    tm = eng._tier
    st = eng.prefill(prompt)
    host_ms = {}
    if tm is not None:
        host_ms = _guard_tier(torch, tm)
        tm.copy_log = []
    torch.cuda.synchronize()
    toks, walls = [], []
    t_prev = time.perf_counter()
    for i, mode in enumerate(TIER_SCHEDULE):
        if i == TIER_PREFETCH_AFTER and tm is not None:
            tm.prefetch_slot(0)
        st, so = eng.step(st, mode)
        now = time.perf_counter()
        walls.append((now - t_prev) * 1e3)
        t_prev = now
        toks.append(so.tokens[0, : so.counts[0]].tolist())
    torch.cuda.synchronize()
    out = dict(toks=toks, walls=walls, host_ms=host_ms,
               stats=eng.tier_stats(), pages=eng.page_stats())
    if tm is not None:
        out["log"] = _tier_log_ms(tm.copy_log)
        tm.copy_log = None
    return out


def _tier_report(card, label, run, base):
    """Print one codec's run of (a) beside the untiered one."""
    s, log = run["stats"], run["log"]
    parts = {}
    for what, nbytes, ms in log:
        parts.setdefault(what, []).append((nbytes, ms))

    def ms(what):
        return [round(t, 3) for _, t in parts.get(what, [])]

    def rate(what):
        return [round(b / t / 1e6, 2) for b, t in parts.get(what, [])]
    host = {k: [round(x, 2) for x in v] for k, v in run["host_ms"].items()}
    flat = [t for step in run["toks"] for t in step]
    base_flat = [t for step in base["toks"] for t in step]
    n = min(len(flat), len(base_flat))
    same = sum(a == b for a, b in zip(flat[:n], base_flat[:n]))
    say(card, f"tiers (a) [{label}]: demoted {s['tier_demoted_pages']} "
              f"promoted {s['tier_promoted_pages']} prefetch hits "
              f"{s['tier_prefetch_hits']} sync promotes "
              f"{s['tier_sync_promotes']} host bytes held "
              f"{s['tier_host_bytes']} peak {s['tier_host_bytes_peak']}; "
              f"device ms: gather + quantize {ms('quantize')} copy to host "
              f"{ms('to_host')} copy to card {ms('to_device')} (the "
              f"prefetch on the side stream, then the synchronous one) "
              f"restore {ms('restore')}; host link GB/s to host "
              f"{rate('to_host')} to card {rate('to_device')}; host ms per "
              f"call {host}; step walls ms "
              f"{[round(w, 2) for w in run['walls']]} (untiered "
              f"{[round(w, 2) for w in base['walls']]}); tokens equal to "
              f"untiered {same} of {n}")
    return dict(stats=s, log=log, walls=run["walls"],
                host_ms=run["host_ms"], same=same, n=n)


def _tier_forced(torch, card, cfg, spec, dcfg, params, dparams, prompt):
    """(a): the forced schedule, batch 1, the 8192-token prompt, untiered
    and with each codec on the gathered paged layout (lossless tokens must
    equal the untiered ones), then int8 on the zero-copy layout."""
    import gc
    from repro_torch.core.engine import SpecPVEngine
    max_len = CONTIG_MAX_LEN
    runs = {}
    for label, kw in (("untiered", {}),) + TIER_CODECS:
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, device="cuda", **PAGED_GATHERED,
                           tiered=bool(kw), **kw)
        runs[label] = _tier_schedule(torch, card, eng, prompt, label)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    base = runs["untiered"]
    out = {"untiered_walls": base["walls"]}
    for label, _ in TIER_CODECS:
        out[label] = _tier_report(card, label, runs[label], base)
        s = runs[label]["stats"]
        if not (s["tier_demoted_pages"] and s["tier_prefetch_hits"] == 1
                and s["tier_sync_promotes"] == 1):
            raise AssertionError(f"tiers (a) [{label}]: the schedule must "
                                 f"demote, hit its prefetch once and promote "
                                 f"once synchronously: {s}")
    if runs["lossless"]["toks"] != base["toks"]:
        raise AssertionError(f"tiers (a): lossless tokens differ from the "
                             f"untiered run:\n{runs['lossless']['toks']}\n"
                             f"{base['toks']}")
    hit = TIER_SCHEDULE.index("refresh", 1)
    say(card, f"tiers (a): lossless tokens == untiered tokens on the forced "
              f"schedule (asserted); every tier operation ran under "
              f"set_sync_debug_mode('error'); wall ms of the Refresh after "
              f"the prefetch hit: untiered {base['walls'][hit]:.2f}, "
              + ", ".join(f"{lb} {runs[lb]['walls'][hit]:.2f}"
                          for lb, _ in TIER_CODECS)
              + f"; of the early Refresh (sync promote): untiered "
              f"{base['walls'][hit + 1]:.2f}, "
              + ", ".join(f"{lb} {runs[lb]['walls'][hit + 1]:.2f}"
                          for lb, _ in TIER_CODECS))
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, device="cuda", **PAGED_ZERO_COPY,
                       tiered=True)
    zc = _tier_schedule(torch, card, eng, prompt, "zero-copy int8")
    pins = zc["pages"]["pinned_pages"]
    say(card, f"tiers (a) [zero-copy int8]: pinned pages {pins} (the "
              f"prompt fills {prompt.shape[1] // spec.block_size} blocks), "
              f"demoted "
              f"{zc['stats']['tier_demoted_pages']} (promoted "
              f"{zc['stats']['tier_promoted_pages']}); step walls ms "
              f"{[round(w, 2) for w in zc['walls']]}")
    out["zero_copy"] = dict(pinned=pins, stats=zc["stats"])
    del eng
    torch.cuda.empty_cache()
    return out


def _tier_served(torch, card, cfg, spec, dcfg, params, dparams):
    """(b): phase 6's six prompts (``TIER_SERVE_REQS``: half its new
    tokens) at batch 4 on the gathered paged layout
    (161 trunk pages, the draft pool at full size in both arms: it is read
    every step and never tiered), untiered and tiered int8, with graphs.
    The tiered run's K1-K4 launches are counted over its run and held to
    what its steps and chunks imply.  Returns the tiered run's launches
    and both runs' numbers."""
    import numpy as np
    from repro_torch.serving import ServingConfig, ServingEngine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    nb = -(-SERVE_MAX_LEN // spec.block_size)
    runs = {}
    for label, tiered in (("untiered", False), ("tiered int8", True)):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=4, max_len=SERVE_MAX_LEN, prefill_chunk=256,
            num_pages=SERVE_PAGES, num_draft_pages=4 * nb + 1,
            paged_kv=True, zero_copy_partial=False, prefix_cache=False,
            tiered_kv=tiered), device="cuda")
        outs, wall, launches, peak = _serve(
            torch, srv, _serving_requests(prompts, TIER_SERVE_REQS))
        eng = srv._continuous.engine
        st = srv.stats
        if eng.tiered != tiered or eng.zero_copy:
            raise AssertionError("tiers (b): wrong engine layout")
        for i, (n, new) in enumerate(TIER_SERVE_REQS):
            o = outs[f"r{i}"]
            if (o.finish_reason != "length" or len(o.tokens) != new
                    or o.tokens.min() < 0
                    or o.tokens.max() >= cfg.vocab_size):
                raise AssertionError(f"tiers (b) [{label}] r{i}: "
                                     f"{o.finish_reason}, {len(o.tokens)}")
        want = _expected_serving_launches(eng, cfg.num_layers)
        got = {k: launches[k] for k in want}
        if got != want:
            raise AssertionError(f"tiers (b) [{label}] launches {got} != "
                                 f"{want} implied by {eng.dispatch_keys}")
        ps = eng.page_stats()
        if ps["in_use"] or ps.get("tier_hosted_pages"):
            raise AssertionError(f"tiers (b) [{label}]: pages left {ps}")
        ntok = int(sum(len(o.tokens) for o in outs.values()))
        lat = np.array([o.latency_s for o in outs.values()])
        ticks = {c: (len(v), round(1e3 * float(np.median(v)), 2))
                 for c, v in srv._continuous.tick_wall.items()}
        refresh_ms = [round(1e3 * w, 2)
                      for w in srv._continuous.tick_wall.get("refresh", [])]
        runs[label] = dict(
            toks={k: o.tokens for k, o in outs.items()}, launches=got,
            tokens_per_s=ntok / wall, wall_s=wall, peak_gib=peak,
            page_stalls=int(st.get("page_stalls", 0)),
            peak_active=int(st["peak_active"]),
            tier_defers=int(st.get("tier_defers", 0)),
            high_water=ps["high_water"],
            demoted=ps.get("tier_demoted_pages", 0),
            host_bytes_peak=ps.get("tier_host_bytes_peak", 0),
            p50=float(np.percentile(lat, 50)),
            p95=float(np.percentile(lat, 95)), refresh_ms=refresh_ms,
            capture_s=eng.capture_s)
        say(card, f"tiers (b) [{label}] llama3.1-8b batch 4, "
                  f"{SERVE_PAGES} trunk pages, gathered: tokens {ntok} "
                  f"wall_s {wall:.3f} tokens_per_s {ntok / wall:.2f} "
                  f"latency_s p50 {np.percentile(lat, 50):.3f} p95 "
                  f"{np.percentile(lat, 95):.3f} page_stalls "
                  f"{runs[label]['page_stalls']} peak_active "
                  f"{runs[label]['peak_active']} tier_defers "
                  f"{runs[label]['tier_defers']} demoted "
                  f"{runs[label]['demoted']} host_bytes_peak "
                  f"{runs[label]['host_bytes_peak']} peak_mem_gib "
                  f"{peak:.2f} pages high water {ps['high_water']} "
                  f"tick wall ms (ticks, median) {ticks}, each refresh "
                  f"tick {refresh_ms}, graphs captured {len(eng._graphs)} "
                  f"in {eng.capture_s:.3f} s, launches {got}")
        del srv, eng
        torch.cuda.empty_cache()
    u, t = runs["untiered"], runs["tiered int8"]
    same = {rid: int(np.sum(t["toks"][rid] == u["toks"][rid]))
            for rid in u["toks"]}
    say(card, f"tiers (b): bf16 tokens of each request equal to the "
              f"untiered run's (not asserted: the int8 round trip changes "
              f"the cold K/V): {same}")
    if not t["demoted"]:
        raise AssertionError("tiers (b): the tiered run demoted nothing")
    for r in runs.values():
        r.pop("toks")
    return t["launches"], dict(untiered=u, tiered=t, same=same)


def _tier_lossless(torch, card, layers: int = 4, new: int = 100):
    """(c): fp32 at full width, ``layers`` layers, TF32 off, with graphs:
    served tiered lossless on the gathered paged layout (batch 2, three
    requests, two over the partial budget and long enough to refresh
    twice, so each demotes and promotes on a prefetch hit) equals the
    untiered served run and each request's solo ``generate``."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config("llama3.1-8b").replace(num_layers=layers,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    spec_reqs = ((3000, new), (4800, new), (5300, new))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in spec_reqs]
    max_len = 5632
    toks, tstats = {}, None
    for tiered in (False, True):
        srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
            batch=2, max_len=max_len, paged_kv=True, prefix_cache=False,
            tiered_kv=tiered, tier_lossless=True), device="cuda")
        for r in _serving_requests(prompts, spec_reqs):
            srv.submit(r)
        srv.run()
        toks[tiered] = {k: o.tokens for k, o in srv.outputs.items()}
        if tiered:
            tstats = srv._continuous.engine.tier_stats()
        del srv
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda", **PAGED_GATHERED)
    for i, p in enumerate(prompts):
        t, _ = solo.generate(p[None], new)
        for tiered in (False, True):
            if not np.array_equal(toks[tiered][f"r{i}"], t[0]):
                raise AssertionError(f"tiers (c) fp32 r{i} (tiered "
                                     f"{tiered}) differs from solo generate")
    if not (tstats["tier_demoted_pages"] and tstats["tier_prefetch_hits"]):
        raise AssertionError(f"tiers (c): the served run must demote and "
                             f"promote on a prefetch hit: {tstats}")
    say(card, f"tiers (c) llama3.1-8b x{layers} layers fp32, graphs, batch "
              f"2, prompts {[n for n, _ in spec_reqs]}, {new} new: served "
              f"tiered lossless == served untiered == solo generate for "
              f"every request (tier stats {tstats}); "
              f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, solo
    torch.cuda.empty_cache()
    return tstats


def phase_tiers(torch, card):
    """Phase 13: (a) the forced schedule per codec and on zero-copy, (b)
    the served trace untiered against tiered int8, (c) fp32 served
    identity.  Returns (b)'s tiered launches and the numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b")
    forced = _tier_forced(torch, card, cfg, spec, dcfg, params, dparams,
                          prompt)
    launches, served = _tier_served(torch, card, cfg, spec, dcfg, params,
                                    dparams)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    for k in LLAMA_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched in (b)")
    fp32 = _tier_lossless(torch, card)
    secs = time.perf_counter() - t_phase
    say(card, f"phase 13 launches {launches}; phase 13 took {secs:.1f} s")
    return dict(launches=launches, forced=forced, served=served,
                fp32=fp32, seconds=secs)


# ---------------------------------------------------------------------------
# phase 14: the MoE family (granite-moe-1b-a400m)
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"
MOE_HEADS = dict(h=16, hk=8, dh=64)     # granite's attention heads
MOE_LOSSLESS_PROMPT, MOE_LOSSLESS_NEW = 1024, 32
MOE_DROP_STEPS = 4                      # eager steps whose drops are read
# the profiled window's ranges: the MoE's parts, the trunk and the draft
MOE_RANGES = (("moe router", "models.blocks", "_moe_router"),
              ("moe top-k", "models.blocks", "_moe_topk"),
              ("moe dispatch", "models.blocks", "_moe_dispatch"),
              ("moe expert GEMMs", "models.blocks", "_moe_experts"),
              ("moe combine", "models.blocks", "_moe_combine"),
              ("trunk", "models.dense", "trunk_fwd"),
              ("draft", "core.draft", "draft_phase"))
GEMM_NAMES = ("gemm", "xmma", "cutlass", "cublas", "splitKreduce")


def _moe_kernel_checks(torch, card, timer):
    """Phase 2, the call forms of slice 14: K1-K4 at granite-moe-1b-a400m's
    heads (H=16, Hk=8, Dh=64, block 128, bf16) over 8192 tokens: K1 Full
    T=61 and routed Partial NS=35 T=61, K2 a prefill chunk T=256 at qoff
    7936, K3 a Refresh T=156 over 66 blocks, K4's paged form over the 24
    layers (the last prompt chunk), each against its plain version (K4
    bit for bit), timed beside its bound and SDPA (K4: ``torch.aminmax``).
    Returns {kernel: {label: row}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1400)
    out = {k: {} for k in LLAMA_KERNELS}
    g = "H=16 Hk=8 Dh=64 (granite)"
    for label, name, kw in (
            (f"K1 full T=61 ctx=8229 {g}", "sparse_verify_attention",
             dict(t=61, ctx=8229)),
            (f"K1 routed NS=35 T=61 {g}", "sparse_verify_attention",
             dict(t=61, ctx=8229, routed_ns=35)),
            (f"K2 prefill T=256 qoff=7936 {g}", "paged_prefill_attention",
             dict(t=256, ctx=8192, causal_qoff=7936))):
        res = {}
        _attn_check(torch, card, timer, gen, res, label, name, **kw,
                    **MOE_HEADS)
        out[name][label] = res[name]
    label = f"K3 Refresh T=156 NB=66 {g} bf16"
    out["retrieval_score"][label] = _score_row(
        torch, card, timer, gen, label, 156, 66, torch.bfloat16, 16, 8, 64)
    k4, start, end, n_touch = K4_PAGED_SHAPES[0]
    row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16, k4,
                              start, end, n_touch, layers=24, hk=8, dh=64)
    out["block_summary"][f"K4 paged {k4} L=24 {g} bf16"] = dict(
        max_abs_err=0.0, timing="profiler", **row)
    torch.cuda.empty_cache()
    return out


def _range_kernels(e, skip=()):
    """(name, device us) of every kernel an op launched, its children's
    included, leaving out the subtrees of ops named in ``skip``."""
    out = [(k.name, k.duration) for k in getattr(e, "kernels", [])]
    for c in e.cpu_children:
        if c.name not in skip:
            out += _range_kernels(c, skip)
    return out


def _moe_breakdown(torch, card, eng, st, steps: int = 1):
    """A profiled window of ``steps`` eager steps with each of
    ``MOE_RANGES`` under ``torch.profiler.record_function``: device ms
    per step of K1-K4, of the MoE's parts, of the trunk's other GEMMs and
    other kernels, of the draft and of the rest.  Returns (numbers,
    state)."""
    import importlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    saved = []
    for label, mod, fn in MOE_RANGES:
        m = importlib.import_module(f"repro_torch.{mod}")
        orig = getattr(m, fn)

        def wrapped(*a, __orig=orig, __label=label, **kw):
            with record_function(__label):
                return __orig(*a, **kw)
        saved.append((m, fn, orig))
        setattr(m, fn, wrapped)
    try:
        modes = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                st, so = eng.step(st, eng.next_mode())
                modes.append(so.mode)
            torch.cuda.synchronize()
    finally:
        for m, fn, orig in saved:
            setattr(m, fn, orig)
    labels = {lb for lb, _, _ in MOE_RANGES}
    busy, _ = _device_busy(prof, skip=labels)
    cpu = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CPU]
    moe_names = {lb for lb in labels if lb.startswith("moe")}
    ms = {}
    for label, _, _ in MOE_RANGES:
        ks = [k for e in cpu if e.name == label for k in _range_kernels(e)]
        ms[label] = sum(d for _, d in ks) / 1e3 / steps
    trunk = [k for e in cpu if e.name == "trunk"
             for k in _range_kernels(e, moe_names)]
    every = [(e.key, _dev_us(e)) for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA]

    def named(rows, name):
        return sum(d for n, d in rows if name in n) / 1e3 / steps
    # the kernels' launches (ctypes) may not be attributed to the op
    # ranges they ran in: K1-K4 come from the whole window, by name
    k1, k1_in = named(every, "block_attention"), named(trunk,
                                                       "block_attention")
    k3, k4 = named(every, "retrieval_score"), named(every, "block_summary")
    gemm = sum(d for n, d in trunk if "block_attention" not in n
               and any(g in n for g in GEMM_NAMES)) / 1e3 / steps
    moe = sum(ms[lb] for lb in moe_names)
    out = {"busy": busy / steps, "K1": k1, "K3": k3, "K4": k4,
           **{lb: ms[lb] for lb, _, _ in MOE_RANGES if lb in moe_names},
           "moe total": moe, "trunk other GEMMs": gemm,
           "trunk other": ms["trunk"] - moe - k1_in - gemm,
           "draft": ms["draft"]}
    out["rest (accept, commit, refresh epilogue)"] = (
        out["busy"] - ms["trunk"] - (k1 - k1_in) - ms["draft"] - k3 - k4)
    say(card, f"moe breakdown, eager steps {modes}: device ms per step "
              + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out, st


def _moe_eager_extras(torch, card, eng, st):
    """On the eager engine of (a), from the state its ``generate`` left:
    the dropped (token, slot) pairs per verify step over
    ``MOE_DROP_STEPS`` steps (the counter ``blocks.MOE_DROPS``, read
    between steps), then the profiled breakdown of the next step."""
    from repro_torch.models import blocks as bk
    cfg = eng.cfg
    t1 = time.perf_counter()
    bk.MOE_DROPS = torch.zeros((), dtype=torch.long, device="cuda")
    drops = []
    try:
        for _ in range(MOE_DROP_STEPS):
            st, so = eng.step(st, eng.next_mode())
            width = (eng.pmax if so.mode == "refresh" else 1) + eng.tree.size
            pairs = width * cfg.experts_per_token * cfg.num_layers
            drops.append((so.mode, int(bk.MOE_DROPS), pairs))
            bk.MOE_DROPS.zero_()
    finally:
        bk.MOE_DROPS = None
    say(card, f"moe dropped (token, slot) pairs per verify step, over "
              f"{cfg.num_layers} layers (mode, dropped, pairs): {drops}")
    t2 = time.perf_counter()
    breakdown, _ = _moe_breakdown(torch, card, eng, st)
    say(card, f"moe eager extras: drop steps {t2 - t1:.1f} s, profiled "
              f"breakdown {time.perf_counter() - t2:.1f} s")
    return dict(drops=drops, breakdown=breakdown)


def _moe_lossless(torch, card):
    """(b): fp32, full width and depth (TF32 off), a 1024-token prompt:
    ``generate`` with full verification, with graphs, on the contiguous
    engine (the reference's default) equals the port's compiled AR
    decoding (``CompiledAR``: the same contiguous prefill chunks through
    K2 and K4); its agreement with the plain AR oracle is reported."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import (CompiledAR,
                                            autoregressive_generate)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, MOE_ARCH, "float32", seed=2,
        prompt_len=MOE_LOSSLESS_PROMPT, prompt_seed=1)
    new = MOE_LOSSLESS_NEW
    max_len = request_token_need(prompt.shape[1], new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, partial_verification=False,
                       device="cuda")
    toks, stats = eng.generate(prompt, new)
    if not eng._graphs:
        raise AssertionError("the full-verification run replayed no graph")
    del eng
    ar = CompiledAR(cfg, params, batch=1, max_len=max_len, spec=spec,
                    device="cuda").generate(prompt, new)
    if not np.array_equal(toks, ar):
        raise AssertionError(f"moe fp32 full-verification SpecPV differs "
                             f"from the compiled AR:\n{toks}\n{ar}")
    plain = autoregressive_generate(cfg, params, prompt, new,
                                    max_len=max_len, spec=spec,
                                    device="cuda")
    agree = float(np.mean(plain == ar))
    secs = time.perf_counter() - t0
    say(card, f"moe lossless {MOE_ARCH} {cfg.num_layers} layers fp32, "
              f"graphs: "
              f"full-verify == compiled AR over {new} tokens (modes "
              f"{stats['modes']}, prompt {prompt.shape[1]}); the plain AR "
              f"oracle agrees on {agree:.3f} of them; {secs:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()
    return dict(modes=stats["modes"], plain_agreement=agree, seconds=secs)


def phase_moe(torch, card):
    """Phase 14: (a) ``generate`` at full width on the paged zero-copy
    pool, eagerly and with graphs (the eager engine's drops and profiled
    breakdown), (c) ``ServingConfig()`` serving of phase 6's requests
    with graphs, (b) fp32 losslessness.  (d), the sync check, runs in
    (a) and (c).  Returns (a)'s graph launches and the numbers."""
    import gc
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, spec, dcfg, params, dparams, prompt = _full_width(torch, card,
                                                           MOE_ARCH)
    # the graph run (the main path) is profiled, its prefill apart; the
    # eager engine gives the drops and the split of the step
    runs = generate_runs(
        torch, card, cfg, spec, dcfg, params, dparams, prompt, NEW_TOKENS,
        PAGED_ZERO_COPY, MOE_ARCH, eager_new=PHASE3_EAGER_NEW,
        eager_hook=lambda eng, st: _moe_eager_extras(torch, card, eng, st),
        profile_eager=False, profile_prefill=False)
    t_a = time.perf_counter() - t_phase
    served, nums = _contiguous_serving(torch, card, cfg, spec, dcfg, params,
                                       dparams, None, name=MOE_ARCH)
    for k in LLAMA_KERNELS:
        if served[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched in serving")
    # capacity binds at top-8, so a request's tokens depend on its batch
    # (in the reference too): the shortest against its solo run is
    # reported, not held
    prompt0 = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_REQS[0][0],)).astype(np.int64)
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=SERVE_MAX_LEN, device="cuda")
    want, _ = solo.generate(prompt0[None], SERVE_REQS[0][1])
    same = float(np.mean(nums["tokens"]["r0"] == want[0]))
    say(card, f"moe served r0 against its solo generate: share of equal "
              f"tokens {same} (reported: capacity binds at top-8)")
    del solo, params, dparams
    nums.pop("tokens")
    gc.collect()
    torch.cuda.empty_cache()
    t_c = time.perf_counter() - t_phase - t_a
    fp32 = _moe_lossless(torch, card)
    secs = time.perf_counter() - t_phase
    launches = runs["graphs"]["launches"]
    say(card, f"phase 14 launches {launches}; serving launches {served}; "
              f"(a) {t_a:.1f} s, (c) {t_c:.1f} s, (b) {fp32['seconds']:.1f} "
              f"s; phase 14 took {secs:.1f} s")
    keep = ("wall_ms_step", "busy_ms_step", "idle_share",
            "idle_share_unprofiled", "device_launches_step",
            "host_launch_calls_step", "tokens_per_s", "prefill_s",
            "peak_gib", "capture_s", "steps")
    return dict(launches=launches, serving_launches=served,
                generate={lb: {k: r.get(k) for k in keep}
                          for lb, r in runs.items()},
                eager_extras=runs["eager"]["hook"], serving=nums,
                served_vs_solo=same, fp32=fp32, seconds=secs)


# ---------------------------------------------------------------------------
# phase 15: the rest of the dense registry
# ---------------------------------------------------------------------------

REG_REP7 = "qwen2-0.5b"                 # 14/2 heads: 7 per KV head, Dh 64
REG_MHA = "deepseek-7b"                 # 32/32 heads, Dh 128
REG_DEEP = "granite-3-2b"               # 40 layers, 32/8 heads, Dh 64
REG_BIG = "qwen1.5-32b"                 # 40/40 heads, QKV bias, 64 layers
REG_BIG_CUT = 48                        # its depth when 64 layers do not fit
REG_SHORT, REG_SHORT_NEW = 2048, 32     # (c)'s prompt and new tokens
REG_EAGER_NEW = 16                      # (b)'s eager run
REG_LOSSLESS_PROMPT, REG_LOSSLESS_NEW = 1024, 32
REG_TRAIN_LAYERS, REG_TRAIN_SEQ = 4, 512
# above the weights and the pool: graph pools, a step's transients and
# workspaces; all 64 layers of qwen1.5-32b peaked 1.3 GiB above the
# reckoning without it (70.85-71.07 GiB allocated)
REG_MARGIN_GIB = 4.0


def _registry_kernel_checks(torch, card, timer):
    """Phase 2, the call forms of slice 15: K1-K4 at qwen2-0.5b's heads
    (H=14, Hk=2: 7 query heads per KV head, Dh 64) and deepseek-7b's
    (H=Hk=32, Dh 128), block 128, bf16, over 8192 tokens: K1 Full T=61
    and routed Partial NS=35 T=61, K2 a prefill chunk T=256 at qoff
    7936, K3 a Refresh T=156 over 66 blocks, K4's paged form over every
    layer (24 / 30); K3 also at qwen1.5-32b's 40/40 and K4 over its 64
    layers at Hk 40 (the last chunk of a 2048-token prompt).  Each is
    held to its plain version (K4 bit for bit), timed beside its bound
    and SDPA (K4: ``torch.aminmax``).  Returns {kernel: {label: row}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1500)
    out = {k: {} for k in LLAMA_KERNELS}
    for heads, layers, tag in (((14, 2, 64), 24, "qwen2-0.5b"),
                               ((32, 32, 128), 30, "deepseek-7b")):
        h, hk, dh = heads
        g = f"H={h} Hk={hk} Dh={dh} ({tag})"
        kw = dict(h=h, hk=hk, dh=dh)
        for label, name, case in (
                (f"K1 full T=61 ctx=8229 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229)),
                (f"K1 routed NS=35 T=61 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229, routed_ns=35)),
                (f"K2 prefill T=256 qoff=7936 {g}",
                 "paged_prefill_attention",
                 dict(t=256, ctx=8192, causal_qoff=7936))):
            res = {}
            _attn_check(torch, card, timer, gen, res, label, name, **case,
                        **kw)
            out[name][label] = res[name]
        label = f"K3 Refresh T=156 NB=66 {g} bf16"
        out["retrieval_score"][label] = _score_row(
            torch, card, timer, gen, label, 156, 66, torch.bfloat16, h, hk,
            dh)
        k4, start, end, n_touch = K4_PAGED_SHAPES[0]
        row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16,
                                  k4, start, end, n_touch, layers=layers,
                                  hk=hk, dh=dh)
        out["block_summary"][f"K4 paged {k4} L={layers} {g} bf16"] = dict(
            max_abs_err=0.0, timing="profiler", **row)
        torch.cuda.empty_cache()
    g = "H=40 Hk=40 Dh=128 (qwen1.5-32b)"
    label = f"K3 Refresh T=156 NB=66 {g} bf16"
    out["retrieval_score"][label] = _score_row(
        torch, card, timer, gen, label, 156, 66, torch.bfloat16, 40, 40, 128)
    row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16,
                              "last chunk of 2048", 1792, 2048, 3, layers=64,
                              np_=20, nb=17, hk=40, dh=128)
    out["block_summary"][f"K4 paged last chunk of 2048 L=64 {g} bf16"] = \
        dict(max_abs_err=0.0, timing="profiler", **row)
    torch.cuda.empty_cache()
    return out


def _layer_params(cfg) -> int:
    """Parameters of one dense layer (``models.dense._init_layer``)."""
    d, f = cfg.d_model, cfg.d_ff
    qd, kd = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    return (d * qd + 2 * d * kd + qd * d + 3 * d * f + 2 * d
            + (qd + 2 * kd if cfg.qkv_bias else 0))


def _reckon_depth(torch, card, arch, prompt_len, new):
    """The depth ``arch`` runs at: all its layers if the weights (target
    and draft, bf16), the paged pool of one row and ``REG_MARGIN_GIB``
    fit in the card's free memory, else ``REG_BIG_CUT``.  Prints the
    reckoning.  Returns (layers, reckoning dict)."""
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import draft_model_config
    from repro_torch.core.engine import request_token_need
    cfg = get_config(arch)
    spec, dcfg = SpecPVConfig(), DraftConfig()
    gib = 2.0**30
    free, total = torch.cuda.mem_get_info()

    def need(layers):
        c = cfg.replace(num_layers=layers)
        d = c.d_model
        # bf16 target: layers, embedding (and head), final norm; the draft:
        # fuse [3d, d], in_proj [2d, d], one layer, its norm
        weights = 2 * (layers * _layer_params(c) + d + c.vocab_size * d
                       * (1 if c.tie_embeddings else 2))
        draft = 2 * (5 * d * d + _layer_params(draft_model_config(c)) + d)
        max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                     dcfg.tree_depth + 1)
        pages = -(-max_len // spec.block_size) + 1
        kv_tok = 2 * c.num_kv_heads * c.head_dim_ * 2
        pool = layers * pages * spec.block_size * kv_tok
        sums = layers * pages * 2 * c.num_kv_heads * c.head_dim_ * 4
        return dict(weights_gib=weights / gib, draft_gib=draft / gib,
                    kv_pool_gib=(pool + sums) / gib,
                    kv_mb_per_token=layers * kv_tok / 1e6,
                    margin_gib=REG_MARGIN_GIB,
                    total_gib=(weights + draft + pool + sums) / gib
                    + REG_MARGIN_GIB)
    full = need(cfg.num_layers)
    layers = (cfg.num_layers if full["total_gib"] <= free / gib
              else REG_BIG_CUT)
    say(card, f"registry: {arch} at {cfg.num_layers} layers needs "
              + ", ".join(f"{k} {v:.2f}" for k, v in full.items())
              + f" against {free / gib:.2f} GiB free of {total / gib:.2f}: "
              f"runs at {layers} layers"
              + ("" if layers == cfg.num_layers else
                 f" (cut from {cfg.num_layers})"))
    return layers, dict(full, free_gib=free / gib, layers=layers,
                        full_layers=cfg.num_layers)


def _graph_generate(torch, card, cfg, spec, dcfg, params, dparams, prompt,
                    new, name):
    """One ``generate`` with graphs on the paged zero-copy pool, the
    launch counts set to 0 just before and read just after, held to what
    its steps and chunks imply; final summaries against the plain
    version; then an eager engine's step bodies under the sync check.
    Returns the numbers."""
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    prompt_len = prompt.shape[1]
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, device="cuda", **PAGED_ZERO_COPY)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks, stats = eng.generate(prompt, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    memory_line(torch, card, f"{name} graphs", eng, params, dparams, peak)
    chunks = -(-prompt_len // 256)
    refresh = stats["modes"].get("refresh", 0)
    layers = cfg.num_layers
    want = {"sparse_verify_attention": layers * stats["steps"],
            "paged_prefill_attention": layers * chunks,
            "retrieval_score": layers * refresh,
            "block_summary": chunks + refresh + stats["modes"].get("full",
                                                                   0)}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got} != {want}")
    if not eng._graphs:
        raise AssertionError(f"{name}: no graph was replayed")
    _check_final_summaries(torch, card, eng.final_state.cache)
    if toks.shape != (1, new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{name}: tokens out of range: {toks}")
    decode_s = wall - stats["prefill_s"]
    steps = max(stats["steps"], 1)
    capture_s = eng.capture_s
    say(card, f"generate [{name} graphs] ({layers} layers, bf16, random "
              f"weights) prompt {prompt_len} new {new}: modes "
              f"{stats['modes']} wall_s {wall:.3f} (prefill_s "
              f"{stats['prefill_s']:.3f}, ms/step {decode_s * 1e3 / steps:.2f})"
              f" tokens_per_s {new / wall:.2f} peak_mem_gib {peak:.2f} "
              f"capture_s {eng.capture_s:.3f} launches {got}")
    del eng
    torch.cuda.empty_cache()
    eager = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                         max_len=max_len, device="cuda", cuda_graphs=False,
                         **PAGED_ZERO_COPY)
    # max_len is under the partial budget: the engine runs Full steps only
    check_sync_free(torch, card, eager, prompt[:, :512], modes=("full",))
    del eager
    torch.cuda.empty_cache()
    return dict(launches=launches, modes=stats["modes"], wall_s=wall,
                tokens_per_s=new / wall, ms_step=decode_s * 1e3 / steps,
                prefill_s=stats["prefill_s"], peak_gib=peak,
                capture_s=capture_s)


def _registry_lossless(torch, card):
    """(d): qwen2-0.5b in fp32 (TF32 off) at full width and depth, a
    1024-token prompt: ``generate`` with full verification, with graphs,
    on the paged zero-copy pool equals the port's compiled AR decoding
    (``CompiledAR``).  Returns the numbers."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import CompiledAR
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, REG_REP7, "float32", seed=2,
        prompt_len=REG_LOSSLESS_PROMPT, prompt_seed=1)
    new = REG_LOSSLESS_NEW
    max_len = request_token_need(prompt.shape[1], new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, partial_verification=False,
                       device="cuda", **PAGED_ZERO_COPY)
    toks, stats = eng.generate(prompt, new)
    if not eng._graphs or set(stats["modes"]) != {"full"}:
        raise AssertionError(f"{REG_REP7} fp32: graphs "
                             f"{list(eng._graphs)}, modes {stats['modes']}")
    del eng
    ar = CompiledAR(cfg, params, batch=1, max_len=max_len, spec=spec,
                    device="cuda").generate(prompt, new)
    if not np.array_equal(toks, ar):
        raise AssertionError(f"{REG_REP7} fp32 full-verification SpecPV "
                             f"differs from the compiled AR:\n{toks}\n{ar}")
    secs = time.perf_counter() - t0
    say(card, f"registry lossless {REG_REP7} {cfg.num_layers} layers fp32, "
              f"graphs: speculative (full verification) == compiled AR over "
              f"{new} tokens (modes {stats['modes']}, mean_accept "
              f"{stats['mean_accept']:.3f}, prompt {prompt.shape[1]}); "
              f"{secs:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()
    return dict(modes=stats["modes"], seconds=secs)


def _registry_rwkv_train(torch, card):
    """(e): one ``train_loss`` + backward of rwkv6-3b at full width, cut
    to ``REG_TRAIN_LAYERS`` layers, batch 1, S = ``REG_TRAIN_SEQ``, bf16
    (the WKV recurrence as the plain chunked loop under autograd): a
    warm-up step, then one step timed with CUDA events; the loss and the
    gradient norm must be finite and non-zero.  Returns the numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.train.trainer import grads_of, trainable, tree_leaves
    cfg = get_config("rwkv6-3b").replace(num_layers=REG_TRAIN_LAYERS)
    params = trainable(api.init_params(cfg, seed=0, device="cuda"))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, REG_TRAIN_SEQ)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    out = []
    for _ in range(2):
        for p in tree_leaves(params):
            p.grad = None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        loss, _ = api.train_loss(cfg, params, toks)
        loss.backward()
        e1.record()
        e1.synchronize()
        gn = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                  for g in tree_leaves(grads_of(params)))))
        out.append((float(loss.detach()), gn, e0.elapsed_time(e1)))
    if ops.launch_counts() != before:
        raise AssertionError("rwkv6 training launched a kernel wrapper")
    loss, gn, ms = out[-1]
    if not (np.isfinite(loss) and loss > 0 and np.isfinite(gn) and gn > 0):
        raise AssertionError(f"rwkv6 train step: loss {loss}, grad norm {gn}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(card, f"registry rwkv6-3b train_loss + backward ({cfg.num_layers} "
              f"layers, d {cfg.d_model}, S {REG_TRAIN_SEQ}, bf16): loss "
              f"{loss:.4f} grad norm {gn:.4f} ms per step {ms:.1f} (warm-up "
              f"{out[0][2]:.1f}) peak_mem_gib {peak:.2f}")
    del params
    torch.cuda.empty_cache()
    return dict(loss=loss, grad_norm=gn, ms_step=ms, warmup_ms=out[0][2],
                peak_gib=peak)


def phase_registry(torch, card):
    """Phase 15: (a) qwen2-0.5b's ``generate`` at full width and depth on
    the paged zero-copy pool, with graphs (eager over the first 16
    tokens); (b) deepseek-7b's,
    with graphs (eager over the first tokens); (c) granite-3-2b at full
    depth and qwen1.5-32b at full width (its depth reckoned first), a
    2048-token prompt with graphs; (d) qwen2-0.5b fp32 losslessness; (e)
    one rwkv6-3b train step; (f) every target's eager step bodies under
    the sync check, in (a)-(c).  Returns (a)'s graph launches and the
    numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs = {}
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, REG_REP7)
    runs_a = generate_runs(torch, card, cfg, spec, dcfg, params, dparams,
                           prompt, NEW_TOKENS, PAGED_ZERO_COPY, REG_REP7,
                           eager_new=PHASE3_EAGER_NEW, profile_eager=False,
                           profile_prefill=False)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    secs["a"] = time.perf_counter() - t_phase
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, REG_MHA)
    runs_b = generate_runs(torch, card, cfg, spec, dcfg, params, dparams,
                           prompt, NEW_TOKENS, PAGED_ZERO_COPY, REG_MHA,
                           eager_new=REG_EAGER_NEW, profile_eager=False,
                           profile_prefill=False)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    secs["b"] = time.perf_counter() - t_phase - secs["a"]
    short = {}
    for arch in (REG_DEEP, REG_BIG):
        t0 = time.perf_counter()
        layers, reckon = (_reckon_depth(torch, card, arch, REG_SHORT,
                                        REG_SHORT_NEW)
                          if arch == REG_BIG else (None, None))
        cfg, spec, dcfg, params, dparams, prompt = _full_width(
            torch, card, arch, prompt_len=REG_SHORT, layers=layers)
        short[arch] = _graph_generate(torch, card, cfg, spec, dcfg, params,
                                      dparams, prompt, REG_SHORT_NEW, arch)
        short[arch].update(layers=cfg.num_layers, reckoning=reckon,
                           seconds=time.perf_counter() - t0)
        del params, dparams
        gc.collect()
        torch.cuda.empty_cache()
    secs["c"] = sum(r["seconds"] for r in short.values())
    fp32 = _registry_lossless(torch, card)
    secs["d"] = fp32["seconds"]
    t0 = time.perf_counter()
    train = _registry_rwkv_train(torch, card)
    secs["e"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    launches = runs_a["graphs"]["launches"]
    big = short[REG_BIG]
    say(card, f"phase 15 launches ({REG_REP7} graphs) {launches}; "
              f"{REG_BIG} ran at {big['layers']} layers; "
              + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items())
              + f"; phase 15 took {total:.1f} s")
    keep = ("wall_ms_step", "busy_ms_step", "idle_share",
            "idle_share_unprofiled", "device_launches_step",
            "host_launch_calls_step", "tokens_per_s", "prefill_s",
            "peak_gib", "capture_s", "steps")

    def pick(runs):
        return {lb: {k: r.get(k) for k in keep} for lb, r in runs.items()}
    for r in short.values():
        r.pop("launches")
    return dict(launches=launches, generate={REG_REP7: pick(runs_a),
                                             REG_MHA: pick(runs_b)},
                short=short, fp32=fp32, train=train, seconds=secs,
                total_s=total)


# ---------------------------------------------------------------------------
# phase 16: Griffin (recurrentgemma-2b), the hybrid state trunk
# ---------------------------------------------------------------------------

GRIFFIN = "recurrentgemma-2b"
GRIFFIN_PROMPT = 4096       # the 2048-token window wraps twice
GRIFFIN_NEW = 64
GRIFFIN_PROFILE_STEPS = 3
GRIFFIN_EAGER_NEW = 16      # (a)'s eager run (slice 22's cut)
GRIFFIN_LOSSLESS_LAYERS = 5     # one (rec, rec, attn) superblock + (rec, rec)
GRIFFIN_LOSSLESS_PROMPT = 2304  # nine chunks, past the window
GRIFFIN_LOSSLESS_NEW = 32
GRIFFIN_SERVE = ((1024, 16), (1024, 16), (1536, 16))
GRIFFIN_TRAIN_LAYERS = 3        # (rec, rec, attn)
GRIFFIN_TRAIN_SEQ = 2560        # past the window, so it bites


def _griffin_gates(torch, params, seed):
    """Random ``lam``, ``ba``, ``bi`` and ``conv_b`` in every rec layer
    (the init's are constant), so every gate of the RG-LRU varies."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for lp in params["layers"]:
        if "lam" not in lp:
            continue
        w = lp["lam"].shape[0]

        def rnd(scale, like):
            return (torch.randn((w,), generator=gen, device="cuda")
                    * scale).to(like.dtype)
        lp["lam"] = torch.rand((w,), generator=gen, device="cuda") * 4 - 1
        lp["ba"], lp["bi"] = rnd(0.5, lp["ba"]), rnd(0.5, lp["bi"])
        lp["conv_b"] = rnd(0.1, lp["conv_b"])


def _profile_prefill_chunk(torch, card, eng, prompt, label):
    """One 256-token prefill chunk (a graph replay on a graph engine)
    under ``torch.profiler``: its device busy ms and launches, and the
    share of the RG-LRU's step loop (its ``addcmul`` kernels) in them."""
    from torch.profiler import ProfilerActivity, profile
    eng.prefill(prompt[:, :256])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill(prompt[:, :256])
        torch.cuda.synchronize()
    busy, span = _device_busy(prof)
    dev_n, _, calls = _launch_counts(prof)
    loop_ms = _named_ms(prof, "addcmul")
    from torch.autograd import DeviceType
    loop_n = sum(e.count for e in prof.key_averages()
                 if getattr(e, "device_type", None) == DeviceType.CUDA
                 and "addcmul" in e.key)
    say(card, f"profile [{label}] one 256-token prefill chunk: device busy "
              f"ms {busy:.3f} (span {span:.3f}), device launches {dev_n}, "
              f"host launch calls {calls}; the RG-LRU step loop "
              f"({loop_n} addcmul launches) {loop_ms:.3f} ms = "
              f"{loop_ms / busy:.4f} of the busy time")
    return dict(chunk_busy_ms=busy, chunk_device_launches=dev_n,
                chunk_host_launch_calls=calls, rglru_loop_ms=loop_ms,
                rglru_loop_launches=loop_n, rglru_loop_share=loop_ms / busy)


def _cast_cost(torch, card, params):
    """Device ms of one pass's fp32 copies of every rec layer's ``wa``
    and ``wi`` (the reference widens them at every call), CUDA events,
    and the bytes they move."""
    mats = [lp[k] for lp in params["layers"] if "wa" in lp
            for k in ("wa", "wi")]
    for m in mats:
        m.float()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for m in mats:
        m.float()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1)
    gb = sum(m.numel() * (m.element_size() + 4) for m in mats) / 1e9
    held = sum(m.numel() * 4 for m in mats) / 2**30
    say(card, f"{GRIFFIN}: fp32 copies of wa / wi over {len(mats) // 2} rec "
              f"layers: {ms:.3f} ms per pass, {gb:.2f} GB read + written "
              f"(a cached fp32 copy would hold {held:.2f} GiB more)")
    return dict(cast_ms_pass=ms, cast_gb_pass=gb, cast_cache_gib=held)


def _griffin_generate(torch, card):
    """(a) bf16, full width and depth, a 4096-token prompt: greedy chain
    ``generate`` eagerly over ``GRIFFIN_EAGER_NEW`` tokens, then with
    graphs (equal tokens over those); no kernel of the port launched; the
    graph run profiled."""
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, GRIFFIN, prompt_len=GRIFFIN_PROMPT)
    max_len = request_token_need(GRIFFIN_PROMPT, GRIFFIN_NEW,
                                 spec.buffer_size, dcfg.tree_depth + 1)
    runs = {}
    for graphs in (False, True):
        label = f"{GRIFFIN} {RUN_LABEL[graphs]}"
        n_new = GRIFFIN_NEW if graphs else GRIFFIN_EAGER_NEW
        t_run = time.perf_counter()
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, paged=False, device="cuda",
                           cuda_graphs=graphs)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        decode_s = wall - stats["prefill_s"]
        say(card, f"generate [{label}] ({cfg.num_layers} layers, d "
                  f"{cfg.d_model}, window {cfg.window_size}, bf16, random "
                  f"weights, chain depth {dcfg.tree_depth}) prompt "
                  f"{GRIFFIN_PROMPT} new {n_new}: modes {stats['modes']} "
                  f"steps {stats['steps']} mean_accept "
                  f"{stats['mean_accept']:.4f} wall_s {wall:.3f} (prefill_s "
                  f"{stats['prefill_s']:.3f} decode_s {decode_s:.3f}, ms/step "
                  f"{decode_s * 1e3 / max(stats['steps'], 1):.2f}) "
                  f"tokens_per_s {n_new / wall:.2f} peak_mem_gib "
                  f"{peak:.2f} capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} port kernel launches "
                  f"{launches}")
        if stats["modes"] != {"state": stats["steps"]}:
            raise AssertionError(f"state steps only: {stats['modes']}")
        if any(launches.values()):
            raise AssertionError(f"no kernel of the port is on Griffin's "
                                 f"path: {launches}")
        if graphs and set(eng._graphs) != {("prefill", 256), "state"}:
            raise AssertionError(f"graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        if toks.shape != (1, n_new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"tokens out of range: {toks}")
        fs = eng.final_state.cache
        if int(fs["win_pos"].max()) != int(fs["length"][0]) - 1:
            raise AssertionError("the window does not hold the last token")
        eng.final_state = None
        run = dict(toks=toks, launches=launches, wall_s=wall,
                   tokens_per_s=n_new / wall,
                   prefill_s=stats["prefill_s"], peak_gib=peak,
                   capture_s=eng.capture_s, steps=stats["steps"],
                   decode_ms_step=decode_s * 1e3 / max(stats["steps"], 1))
        if graphs:
            run.update(profile_steps(torch, card, eng, prompt, label=label,
                                     steps=GRIFFIN_PROFILE_STEPS,
                                     prefill=False))
            run.update(_profile_prefill_chunk(torch, card, eng, prompt,
                                              label))
            # the same chunk with graphs, host clock: the replay
            eng.prefill(prompt[:, :256])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill(prompt[:, :256])
            torch.cuda.synchronize()
            run["chunk_replay_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            check_sync_free(torch, card, eng, prompt[:, :512])
        say(card, f"{label} took {time.perf_counter() - t_run:.1f} s")
        runs[RUN_LABEL[graphs]] = run
        del eng
        torch.cuda.empty_cache()
    compare_runs(card, GRIFFIN, runs)
    cast = _cast_cost(torch, card, params)
    del params, dparams
    torch.cuda.empty_cache()
    return runs, cast


def _griffin_fp32(torch, card):
    """(b) fp32 (TF32 off), full width, depth 5: chain ``generate`` with
    graphs equals the port's AR decoding; (c) wave serving of three
    requests equals each one's solo ``generate``."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models.api import init_params
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(GRIFFIN).replace(num_layers=GRIFFIN_LOSSLESS_LAYERS,
                                      dtype="float32", param_dtype="float32")
    spec, dcfg = SpecPVConfig(), DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    _griffin_gates(torch, params, seed=5)
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    n, new = GRIFFIN_LOSSLESS_PROMPT, GRIFFIN_LOSSLESS_NEW
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int64)
    max_len = request_token_need(n, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    t0 = time.perf_counter()
    ar = autoregressive_generate(cfg, params, prompt, new, max_len=max_len,
                                 spec=spec, device="cuda")
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, paged=False, device="cuda")
    toks, st = eng.generate(prompt, new)
    if set(eng._graphs) != {("prefill", 256), "state"}:
        raise AssertionError(f"graphs: {sorted(map(str, eng._graphs))}")
    if not np.array_equal(toks, ar):
        raise AssertionError(f"{GRIFFIN} chain SpecPV differs from AR:\n"
                             f"{toks}\n{ar}")
    lossless_s = time.perf_counter() - t0
    say(card, f"lossless {GRIFFIN} x{cfg.num_layers} layers "
              f"{cfg.layer_kinds()} fp32, graphs: chain generate == AR over "
              f"{new} tokens of a {n}-token prompt (steps {st['steps']}, "
              f"mean_accept {st['mean_accept']:.4f}); {lossless_s:.1f} s")
    del eng
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, (p,)).astype(np.int64), k)
            for p, k in GRIFFIN_SERVE]
    serve_len = request_token_need(max(p for p, _ in GRIFFIN_SERVE),
                                   max(k for _, k in GRIFFIN_SERVE),
                                   spec.buffer_size, dcfg.tree_depth + 1)
    srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                        ServingConfig(batch=2, max_len=serve_len),
                        device="cuda")
    for i, (p, k) in enumerate(reqs):
        srv.submit(Request(request_id=f"g{i}", prompt=p, max_new_tokens=k))
    srv.run()
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=serve_len, paged=False, device="cuda")
    for i, (p, k) in enumerate(reqs):
        want, _ = solo.generate(p[None], k)
        if not np.array_equal(srv.outputs[f"g{i}"].tokens, want[0]):
            raise AssertionError(f"served request g{i} differs from its solo "
                                 f"generate")
    serve_s = time.perf_counter() - t0
    waves, tps = int(srv.stats["waves"]), srv.throughput_tok_s()
    say(card, f"serving {GRIFFIN} x{cfg.num_layers} layers fp32, graphs: "
              f"{len(reqs)} requests (prompts "
              f"{[p for p, _ in GRIFFIN_SERVE]}) in {waves} waves of batch 2 "
              f"each equal their solo generate; tokens/s {tps:.2f}; "
              f"{serve_s:.1f} s")
    del params, dparams, srv, solo
    torch.cuda.empty_cache()
    return dict(lossless_s=lossless_s, lossless_steps=st["steps"],
                serve_s=serve_s, serve_waves=waves, serve_tokens_per_s=tps)


def _griffin_train(torch, card):
    """(d) one ``Trainer`` step at full width, 3 layers (rec, rec, attn),
    batch 1, S 2560 (a warm-up step first): ms per step (CUDA events),
    peak memory, finite loss and gradient norm."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = get_config(GRIFFIN).replace(num_layers=GRIFFIN_TRAIN_LAYERS)
    tr = Trainer(cfg, TrainConfig(), seed=0, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, GRIFFIN_TRAIN_SEQ)), device="cuda")
    tr.step(toks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    m = tr.step(toks)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    if not (np.isfinite(loss) and np.isfinite(gn) and gn > 0):
        raise AssertionError(f"train step: loss {loss} grad norm {gn}")
    say(card, f"train {GRIFFIN} x{cfg.num_layers} layers {cfg.layer_kinds()} "
              f"bf16, batch 1, S {GRIFFIN_TRAIN_SEQ}: {ms:.1f} ms per Trainer "
              f"step (loss + backward + clip + AdamW), loss {loss:.4f}, "
              f"grad norm {gn:.3f}, peak {peak:.2f} GiB")
    del tr
    torch.cuda.empty_cache()
    return dict(train_ms_step=ms, train_peak_gib=peak, train_loss=loss)


def phase_griffin(torch, card):
    """Phase 16: (a) recurrentgemma-2b's chain ``generate`` at full width
    and depth, eager and with graphs; (b) fp32 losslessness at depth 5;
    (c) wave serving at depth 5; (d) a Trainer step at 3 layers.  Returns
    (a)'s graph launches and the numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs = {}
    runs, cast = _griffin_generate(torch, card)
    secs["a"] = time.perf_counter() - t_phase
    fp32 = _griffin_fp32(torch, card)
    secs["b, c"] = time.perf_counter() - t_phase - secs["a"]
    t0 = time.perf_counter()
    train = _griffin_train(torch, card)
    secs["d"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    say(card, f"phase 16: " + ", ".join(f"({k}) {v:.1f} s"
                                        for k, v in secs.items())
              + f"; phase 16 took {total:.1f} s")
    keep = ("wall_s", "tokens_per_s", "prefill_s", "capture_s", "peak_gib",
            "steps", "decode_ms_step", "wall_ms_step", "busy_ms_step",
            "idle_share", "idle_share_unprofiled", "device_launches_step",
            "host_launch_calls_step", "top_kernels", "chunk_busy_ms",
            "chunk_device_launches", "chunk_host_launch_calls",
            "rglru_loop_ms", "rglru_loop_launches", "rglru_loop_share",
            "chunk_replay_ms")
    gen = {lb: {k: r[k] for k in keep if k in r} for lb, r in runs.items()}
    return dict(launches=runs["graphs"]["launches"], generate=gen,
                tokens=runs["graphs"]["toks"][0].tolist(), cast=cast,
                fp32=fp32, train=train, seconds=secs, total_s=total)


# ---------------------------------------------------------------------------
# phase 17: VLM and audio (per-request image and frame conditioning)
# ---------------------------------------------------------------------------

AUDIO = "whisper-small"                 # 12 + 12 layers, 12/12 heads, Dh 64
VLM = "llama-3.2-vision-90b"            # 64/8 heads, Dh 128, cross every 5th
XATTN_LAYOUT = dict(paged=True, zero_copy=True, prefix_cache=False)
XATTN_PROFILE_STEPS = 4
XATTN_EAGER_NEW = 16                    # (a)'s eager run (slice 22's cut)
VLM_MARGIN_GIB = 6.0                    # the card left free at the depth run
XATTN_LOSSLESS_PROMPT, XATTN_LOSSLESS_NEW = 2304, 32
XATTN_LOSSLESS_LAYERS = 5               # the VLM's one superblock in fp32
# a partial budget of (1 + 8 + 2) blocks = 1408 tokens, under (c)'s prompt,
# so the fp32 runs Refresh and Partial steps (the paper's 4480 would not)
XATTN_LOSSLESS_RETRIEVAL = 8
XATTN_SERVE = ((1500, 24), (2000, 32), (1700, 24))


def _vlm_audio_kernel_checks(torch, card, timer):
    """Phase 2, the call forms of slice 17: K1-K4 at llama-3.2-vision-90b's
    heads (H=64, Hk=8: 8 query heads per KV head, Dh 128) and
    whisper-small's (H=Hk=12, Dh 64), block 128, bf16, over 8192 tokens:
    K1 Full T=61, Refresh T=156 and routed Partial NS=35 T=61, K2 a
    prefill chunk T=256 at qoff 7936, K3 a Refresh T=156 over 66 blocks,
    K4's paged form over every attention layer (28 of the VLM's 35, 12).
    Each is held to its plain version (K4 bit for bit), timed beside its
    bound and SDPA (K4: ``torch.aminmax``).  Returns {kernel: {label:
    row}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1700)
    out = {k: {} for k in LLAMA_KERNELS}
    for heads, layers, tag in (((64, 8, 128), 28, VLM),
                               ((12, 12, 64), 12, AUDIO)):
        h, hk, dh = heads
        g = f"H={h} Hk={hk} Dh={dh} ({tag})"
        kw = dict(h=h, hk=hk, dh=dh)
        for label, name, case in (
                (f"K1 full T=61 ctx=8229 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229)),
                (f"K1 refresh T=156 ctx=8229 {g}", "sparse_verify_attention",
                 dict(t=156, ctx=8229)),
                (f"K1 routed NS=35 T=61 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229, routed_ns=35)),
                (f"K2 prefill T=256 qoff=7936 {g}",
                 "paged_prefill_attention",
                 dict(t=256, ctx=8192, causal_qoff=7936))):
            res = {}
            _attn_check(torch, card, timer, gen, res, label, name, **case,
                        **kw)
            out[name][label] = res[name]
        label = f"K3 Refresh T=156 NB=66 {g} bf16"
        out["retrieval_score"][label] = _score_row(
            torch, card, timer, gen, label, 156, 66, torch.bfloat16, h, hk,
            dh)
        k4, start, end, n_touch = K4_PAGED_SHAPES[0]
        row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16,
                                  k4, start, end, n_touch, layers=layers,
                                  hk=hk, dh=dh)
        out["block_summary"][f"K4 paged {k4} L={layers} {g} bf16"] = dict(
            max_abs_err=0.0, timing="profiler", **row)
        torch.cuda.empty_cache()
    return out


def _set_gates(torch, params, seed):
    """The VLM's cross-attention gates from a seeded draw in [0.3, 0.7]:
    the reference initialises them to 0, which makes every ``cross``
    layer the identity and would hide the image path."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = 0
    for lp in params["layers"]:
        for name in ("gate_attn", "gate_mlp"):
            if name in lp:
                lp[name].fill_(0.3 + 0.4 * float(torch.rand(
                    (), generator=gen, device="cuda")))
                n += 1
    return n


def _xattn_model(torch, card, arch, dtype="bfloat16", layers=None, seed=0,
                 prompt_len=PROMPT_LEN, spec=None):
    """``arch`` at full width with random weights (gates set), the draft,
    a prompt and the request's stub ``extra`` from a seeded generator."""
    from repro_torch.models import api
    cfg, spec0, dcfg, params, dparams, prompt = _full_width(
        torch, card, arch, dtype, seed=seed, prompt_len=prompt_len,
        prompt_seed=seed + 1, layers=layers)
    _set_gates(torch, params, seed + 7)
    extra = api.extra_inputs_for(cfg, 1, seed=seed + 11, device="cuda")
    return cfg, spec or spec0, dcfg, params, dparams, prompt, extra


def _encoder_ms(torch, eng, extra):
    """Device ms (CUDA events, mean of 3 after a warm-up) of a request's
    encoding: the encoder (or the projector) and every cross layer's K/V,
    written into the engine's rows of slot 0 as at an admission."""
    from repro_torch.models import api
    rows = [eng.state.cache[n][:, :1] for n in ("cross_k", "cross_v")]

    def run():
        api.write_cross(eng.cfg, eng.params, *rows, extra)
    run()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        run()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / 3


def _xattn_generate(torch, card, cfg, spec, dcfg, params, dparams, prompt,
                    extra, new, name, modes=(False, True), eager_new=None):
    """``generate(extra=)`` on the paged zero-copy pool (prefix sharing
    off: it cannot key ``extra``) for each graph mode in ``modes``: K1-K4
    launches above 0 and held to the steps and chunks, final summaries to
    the plain version, tokens in range; the graph run profiled (decode
    window, prefill unprofiled), the eager one's bodies under the sync
    check; graphs == eager when both run (the graph run's first
    ``eager_new`` tokens when the eager run generates only those).
    Returns the runs' numbers."""
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    prompt_len = prompt.shape[1]
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    runs = {}
    full_new = new
    for graphs in modes:
        t_run = time.perf_counter()
        label = f"{name} {RUN_LABEL[graphs]}"
        new = full_new if graphs or eager_new is None else eager_new
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, device="cuda",
                           cuda_graphs=graphs, **XATTN_LAYOUT)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, new, extra=extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        memory_line(torch, card, label, eng, params, dparams, peak)
        decode_s = wall - stats["prefill_s"]
        steps = max(stats["steps"], 1)
        say(card, f"generate [{label}] ({cfg.num_layers} layers "
                  f"{eng.l_attn} with self-attention, {cfg.dtype}, random "
                  f"weights, extra {sorted(extra)}) prompt {prompt_len} new "
                  f"{new}: modes {stats['modes']} steps {stats['steps']} "
                  f"mean_accept {stats['mean_accept']:.4f} wall_s "
                  f"{wall:.3f} (prefill_s {stats['prefill_s']:.3f} decode_s "
                  f"{decode_s:.3f}, ms/step {decode_s * 1e3 / steps:.2f}) "
                  f"tokens_per_s {new / wall:.2f} peak_mem_gib {peak:.2f} "
                  f"capture_s {eng.capture_s:.3f} graphs "
                  f"{sorted(map(str, eng._graphs))} launches {launches}")
        if not (stats["modes"].get("refresh")
                and stats["modes"].get("partial")):
            raise AssertionError(f"{label}: Refresh and Partial steps must "
                                 f"both run: {stats['modes']}")
        chunks = -(-prompt_len // 256)
        refresh = stats["modes"].get("refresh", 0)
        commits = refresh + stats["modes"].get("full", 0)
        la = eng.l_attn
        want = {"sparse_verify_attention": la * stats["steps"],
                "paged_prefill_attention": la * chunks,
                "retrieval_score": la * refresh,
                "block_summary": chunks + commits}
        got = {k: launches[k] for k in want}
        if got != want or min(got.values()) <= 0:
            raise AssertionError(f"{label}: launches {got} != {want} implied "
                                 f"by {stats['steps']} steps and {chunks} "
                                 f"chunks over {la} attention layers")
        want_graphs = {("prefill", 256), (True, False, True, False, False),
                       (False, True, False, False, False)}
        if graphs and set(eng._graphs) != want_graphs:
            raise AssertionError(f"{label}: graphs captured: "
                                 f"{sorted(map(str, eng._graphs))}")
        _check_final_summaries(torch, card, eng.final_state.cache)
        if toks.shape != (1, new) or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{label}: tokens out of range: {toks}")
        eng.final_state = None
        enc_ms = _encoder_ms(torch, eng, extra)
        run = dict(toks=toks, launches=launches, wall_s=wall,
                   tokens_per_s=new / wall, prefill_s=stats["prefill_s"],
                   decode_ms_step=decode_s * 1e3 / steps, peak_gib=peak,
                   capture_s=eng.capture_s, steps=stats["steps"],
                   modes=stats["modes"], encoder_ms=enc_ms,
                   layers=cfg.num_layers, attn_layers=la)
        if graphs:
            run.update(profile_steps(torch, card, eng, prompt, label=label,
                                     steps=XATTN_PROFILE_STEPS,
                                     prefill=False, extra=extra))
        else:
            check_sync_free(torch, card, eng, prompt[:, :1024], extra=extra)
        say(card, f"{label}: encoder and cross K/V of one request "
                  f"{enc_ms:.3f} ms (device, CUDA events); took "
                  f"{time.perf_counter() - t_run:.1f} s")
        runs[RUN_LABEL[graphs]] = run
        del eng
        torch.cuda.empty_cache()
    if len(runs) == 2:
        compare_runs(card, name, runs)
    return runs


def _vlm_params(cfg, layers) -> int:
    """Parameters of the VLM at ``layers`` (``models.dense.init_params``:
    every layer, self or cross, is one attention block, one gated MLP
    and its norms), its embedding and head, and its projector."""
    c = cfg.replace(num_layers=layers)
    return (layers * _layer_params(c) + 2 * c.vocab_size * c.d_model
            + c.d_model + c.vision_dim * c.d_model
            + 2 * (layers // 5) * c.d_model)


def _reckon_vlm_depth(torch, card, prompt_len, new):
    """The deepest whole number of 5-layer superblocks of the VLM whose
    weights (target and draft, bf16), paged pool of one row, cross K/V
    rows and ``VLM_MARGIN_GIB`` fit the card's free memory.  Prints the
    reckoning.  Returns (layers, reckoning dict)."""
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.draft import draft_model_config
    from repro_torch.core.engine import request_token_need
    cfg = get_config(VLM)
    spec, dcfg = SpecPVConfig(), DraftConfig()
    gib = 2.0**30
    free, total = torch.cuda.mem_get_info()
    d = cfg.d_model
    draft = 2 * (5 * d * d + _layer_params(draft_model_config(cfg)) + d)
    max_len = request_token_need(prompt_len, new, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    pages = -(-max_len // spec.block_size) + 1
    kv_tok = 2 * cfg.num_kv_heads * cfg.head_dim_ * 2

    def need(layers):
        la, lc = layers - layers // 5, layers // 5
        weights = 2 * _vlm_params(cfg, layers)
        pool = (la * pages * spec.block_size * kv_tok
                + la * pages * 2 * cfg.num_kv_heads * cfg.head_dim_ * 4)
        cross = lc * cfg.num_image_tokens * kv_tok
        return dict(weights_gib=weights / gib, draft_gib=draft / gib,
                    kv_pool_gib=pool / gib, cross_rows_gib=cross / gib,
                    total_gib=(weights + draft + pool + cross) / gib)
    layers = 0
    for n in range(5, cfg.num_layers + 1, 5):
        if need(n)["total_gib"] + VLM_MARGIN_GIB <= free / gib:
            layers = n
    if not layers:
        raise AssertionError(f"{VLM}: not one superblock fits "
                             f"{free / gib:.2f} GiB free")
    got = need(layers)
    say(card, f"{VLM}: {layers} layers ({layers // 5} superblocks of (attn "
              f"x4, cross)) need " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in got.items())
              + f", leaving {free / gib - got['total_gib']:.2f} GiB of "
              f"{free / gib:.2f} free ({total / gib:.2f} total; at least "
              f"{VLM_MARGIN_GIB} asked); all {cfg.num_layers} layers would "
              f"need {need(cfg.num_layers)['total_gib']:.2f} GiB")
    return layers, dict(got, free_gib=free / gib, layers=layers,
                        full_layers=cfg.num_layers,
                        margin_gib=VLM_MARGIN_GIB)


def _xattn_lossless(torch, card):
    """(c) fp32, TF32 off, a 2304-token prompt and 32 new tokens, the
    partial budget cut to 1408 tokens: whisper-small at full depth and
    the VLM at full width with one superblock (5 layers).  Full
    verification with graphs equals ``autoregressive_generate(extra=)``;
    partial verification with graphs equals its eager run (its agreement
    with AR reported); another ``extra`` changes the first token's
    logits.  Returns the numbers."""
    import numpy as np
    from repro_torch.configs import SpecPVConfig
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = SpecPVConfig(use_pallas=True, score_mode="paper",
                        reduction="mean",
                        retrieval_budget_blocks=XATTN_LOSSLESS_RETRIEVAL)
    out = {}
    for arch, layers in ((AUDIO, None), (VLM, XATTN_LOSSLESS_LAYERS)):
        t0 = time.perf_counter()
        cfg, spec, dcfg, params, dparams, prompt, extra = _xattn_model(
            torch, card, arch, "float32", layers=layers, seed=2,
            prompt_len=XATTN_LOSSLESS_PROMPT, spec=spec)
        new = XATTN_LOSSLESS_NEW
        max_len = request_token_need(prompt.shape[1], new, spec.buffer_size,
                                     dcfg.tree_depth + 1)
        ar = autoregressive_generate(cfg, params, prompt, new,
                                     max_len=max_len, spec=spec,
                                     device="cuda", extra=extra)
        full = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                            max_len=max_len, partial_verification=False,
                            device="cuda", **XATTN_LAYOUT)
        toks_full, st_full = full.generate(prompt, new, extra=extra)
        if not full._graphs or set(st_full["modes"]) != {"full"}:
            raise AssertionError(f"{arch} fp32: graphs {list(full._graphs)}"
                                 f", modes {st_full['modes']}")
        if not np.array_equal(toks_full, ar):
            raise AssertionError(f"{arch} fp32 full-verification SpecPV "
                                 f"differs from AR:\n{toks_full}\n{ar}")
        # another clip or image: other first-token logits
        logits = []
        for ex in (extra, api.extra_inputs_for(cfg, 1, seed=99,
                                               device="cuda")):
            full.prefill(prompt[:, :256], extra=ex)
            logits.append(full._logits_last.clone())
        moved = float((logits[0] - logits[1]).abs().max())
        if not moved > 1e-3:
            raise AssertionError(f"{arch}: another extra leaves the first "
                                 f"logits ({moved:.3e})")
        del full
        part = {}
        for graphs in (True, False):
            eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                               max_len=max_len, device="cuda",
                               cuda_graphs=graphs, **XATTN_LAYOUT)
            part[graphs] = eng.generate(prompt, new, extra=extra)
            del eng
        (tg, sg), (te, _) = part[True], part[False]
        if not np.array_equal(tg, te):
            raise AssertionError(f"{arch} fp32 partial verification: graphs "
                                 f"differ from eager:\n{tg}\n{te}")
        if not (sg["modes"].get("refresh") and sg["modes"].get("partial")):
            raise AssertionError(f"{arch} fp32: modes {sg['modes']}")
        agree = float(np.mean(tg == ar))
        secs = time.perf_counter() - t0
        say(card, f"lossless {arch} x{cfg.num_layers} layers fp32 (gates "
                  f"set), graphs: full-verify == autoregressive_generate("
                  f"extra=) over {new} tokens of a {prompt.shape[1]}-token "
                  f"prompt (modes {st_full['modes']}); partial run (budget "
                  f"{spec.partial_budget_tokens}, modes {sg['modes']}) "
                  f"graphs == eager, agrees with AR on {agree:.3f} of "
                  f"tokens; another extra moves the first logits by "
                  f"{moved:.3e}; {secs:.1f} s")
        out[arch] = dict(layers=cfg.num_layers, full_modes=st_full["modes"],
                         partial_modes=sg["modes"], agree_ar=agree,
                         logit_move=moved, seconds=secs)
        if arch == AUDIO:
            out["serve"] = _xattn_served(torch, card, cfg, spec, dcfg,
                                         params, dparams)
        del params, dparams
        torch.cuda.empty_cache()
    return out


def _xattn_served(torch, card, cfg, spec, dcfg, params, dparams):
    """(d) whisper-small fp32 with graphs: three requests, each with its
    own frame embeddings, admitted with ``prefill_into_slot(extra=)`` at
    batch 3 (the third while the first two decode, so the slot prefill's
    graph replays for another slot and another clip) and stepped with
    ``step_fused`` to the end; each equals its solo ``generate(extra=)``.
    Returns the numbers."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.models import api
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, cfg.vocab_size, (p,)).astype(np.int64), k,
             api.extra_inputs_for(cfg, 1, seed=40 + i, device="cuda"))
            for i, (p, k) in enumerate(XATTN_SERVE)]
    max_len = request_token_need(max(p for p, _ in XATTN_SERVE),
                                 max(k for _, k in XATTN_SERVE),
                                 spec.buffer_size, dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=3,
                       max_len=max_len, device="cuda", **XATTN_LAYOUT)
    st = eng.empty_state()
    out = {i: [] for i in range(3)}
    ticks = 0

    def admit(i):
        nonlocal st
        p, k, ex = reqs[i]
        st, first = eng.prefill_into_slot(st, i, p, extra=ex,
                                          max_new_tokens=k)
        out[i].append(first)

    def tick():
        nonlocal st, ticks
        rows = np.asarray([len(out[i]) < reqs[i][1] if out[i] else False
                           for i in range(3)])
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        ticks += 1
        for i in np.nonzero(rows)[0]:
            out[i].extend(so.tokens[i, :so.counts[i]].tolist())
    admit(0)
    admit(1)
    for _ in range(3):
        tick()
    admit(2)
    while any(len(out[i]) < reqs[i][1] for i in range(3)):
        tick()
    graphs = sorted(map(str, eng._graphs))
    if not any("fused_prefill" in g for g in graphs):
        raise AssertionError(f"no slot-prefill graph replayed: {graphs}")
    del eng
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda", **XATTN_LAYOUT)
    for i, (p, k, ex) in enumerate(reqs):
        want, _ = solo.generate(p[None], k, extra=ex)
        if not np.array_equal(np.asarray(out[i][:k]), want[0]):
            raise AssertionError(f"served request {i} differs from its solo "
                                 f"generate:\n{out[i][:k]}\n{want[0]}")
    del solo
    secs = time.perf_counter() - t0
    say(card, f"served {AUDIO} x{cfg.num_layers} fp32, graphs {graphs}: "
              f"{len(reqs)} requests with their own frames (prompts "
              f"{[p for p, _ in XATTN_SERVE]}) at batch 3 in {ticks} ticks "
              f"each equal their solo generate(extra=); {secs:.1f} s")
    return dict(ticks=ticks, seconds=secs)


def phase_vlm_audio(torch, card):
    """Phase 17: (a) whisper-small at full width and depth, eager and with
    graphs; (b) llama-3.2-vision-90b at full width, its depth reckoned,
    with graphs; (c) fp32 losslessness of both; (d) served == solo.
    Returns each path's graph launches and the numbers."""
    import gc
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs = {}
    cfg, spec, dcfg, params, dparams, prompt, extra = _xattn_model(
        torch, card, AUDIO)
    audio = _xattn_generate(torch, card, cfg, spec, dcfg, params, dparams,
                            prompt, extra, NEW_TOKENS, AUDIO,
                            eager_new=XATTN_EAGER_NEW)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    secs["a"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    layers, reckon = _reckon_vlm_depth(torch, card, PROMPT_LEN, NEW_TOKENS)
    cfg, spec, dcfg, params, dparams, prompt, extra = _xattn_model(
        torch, card, VLM, layers=layers)
    vlm = _xattn_generate(torch, card, cfg, spec, dcfg, params, dparams,
                          prompt, extra, NEW_TOKENS, VLM, modes=(True,))
    # the eager bodies under the sync check, on (b)'s pool size
    eager = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                         max_len=request_token_need(
                             PROMPT_LEN, NEW_TOKENS, spec.buffer_size,
                             dcfg.tree_depth + 1),
                         device="cuda", cuda_graphs=False, **XATTN_LAYOUT)
    check_sync_free(torch, card, eager, prompt[:, :1024], extra=extra)
    del eager, params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp32 = _xattn_lossless(torch, card)
    secs["c, d"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    say(card, f"phase 17 launches ({AUDIO} graphs) "
              f"{audio['graphs']['launches']}, ({VLM} graphs, "
              f"{reckon['layers']} layers) {vlm['graphs']['launches']}; "
              + ", ".join(f"({k}) {v:.1f} s" for k, v in secs.items())
              + f"; phase 17 took {total:.1f} s")
    keep = ("wall_s", "tokens_per_s", "prefill_s", "decode_ms_step",
            "capture_s", "peak_gib", "steps", "modes", "encoder_ms",
            "layers", "attn_layers", "wall_ms_step", "busy_ms_step",
            "idle_share", "idle_share_unprofiled", "device_launches_step",
            "host_launch_calls_step", "top_kernels", "launches")

    def pick(runs):
        return {lb: {k: r[k] for k in keep if k in r}
                for lb, r in runs.items()}
    return dict(audio_launches=audio["graphs"]["launches"],
                vlm_launches=vlm["graphs"]["launches"],
                generate={AUDIO: pick(audio), VLM: pick(vlm)},
                tokens={AUDIO: audio["graphs"]["toks"][0].tolist()},
                vlm_reckoning=reckon, fp32=fp32, seconds=secs,
                total_s=total)


# ---------------------------------------------------------------------------
# phase 18: windowed dense stacks; context-parallel verification
# ---------------------------------------------------------------------------

WIN_SIZE = 4096                 # (a): the window, shorter than the prompt
WIN_NEW = 48
WIN_EAGER_NEW = 16              # the eager run: its prefill alone takes 19 s
WIN_PROFILE_STEPS = 3
WIN_FP32_LAYERS = 5
WIN_FP32_PROMPT = 6144          # 24 chunks, past the window
WIN_FP32_NEW = 32
CP_RANKS = 2
CP_TOKENS = 524288              # the reference's case D1 (hillclimb.py)
CP_FP32_TOKENS = 32768
CP_LENGTH_SHORT = 1000          # the rows' length: the context less this
CP_T = 8
CP_HEADS = dict(h=32, hk=32, dh=128)    # deepseek-7b's attention
CP_LAYERS = 30                  # deepseek-7b's depth, for the traffic model
CP_BF16_TOL = 3e-2              # bf16 sums reassociated across the ranks
CP_FP32_TOL = 1e-4


def _windowed_generate(torch, card):
    """(a): llama3.1-8b at full width with ``window_size`` = WIN_SIZE (set
    by ``replace``), an 8192-token prompt on the paged zero-copy pool:
    ``generate`` with graphs (launches held to the steps and chunks, K2
    none: the windowed prefill is the reference's plain chunked
    attention), a profiled window of steps, then eagerly on an engine of
    the same size for WIN_EAGER_NEW tokens (the graph run's first ones,
    launches held to its own steps and chunks).  Returns the numbers."""
    import gc
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b")
    cfg = cfg.replace(window_size=WIN_SIZE)
    max_len = request_token_need(prompt.shape[1], WIN_NEW, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    runs = {}
    for graphs in (True, False):
        new = WIN_NEW if graphs else WIN_EAGER_NEW
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, device="cuda",
                           cuda_graphs=graphs, **PAGED_ZERO_COPY)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, stats = eng.generate(prompt, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        chunks = -(-prompt.shape[1] // 256)
        refresh = stats["modes"].get("refresh", 0)
        want = {"sparse_verify_attention": cfg.num_layers * stats["steps"],
                "paged_prefill_attention": 0,
                "retrieval_score": cfg.num_layers * refresh,
                "block_summary": chunks + refresh
                + stats["modes"].get("full", 0), "wkv": 0}
        if launches != want:
            raise AssertionError(f"windowed {RUN_LABEL[graphs]}: launches "
                                 f"{launches} != {want}")
        if graphs and not eng._graphs:
            raise AssertionError("windowed: no graph was replayed")
        steps = max(stats["steps"], 1)
        decode_s = wall - stats["prefill_s"]
        run = dict(tokens=toks, modes=stats["modes"], launches=launches,
                   wall_s=wall, prefill_s=stats["prefill_s"],
                   tokens_per_s=new / wall,
                   ms_step=decode_s * 1e3 / steps, peak_gib=peak)
        say(card, f"generate [llama3.1-8b window {WIN_SIZE} "
                  f"{RUN_LABEL[graphs]}] ({cfg.num_layers} layers, bf16, "
                  f"random weights) "
                  f"prompt {prompt.shape[1]} new {new}: modes "
                  f"{stats['modes']} wall_s {wall:.3f} (prefill_s "
                  f"{stats['prefill_s']:.3f}, host ms/step "
                  f"{run['ms_step']:.2f}) tokens_per_s "
                  f"{run['tokens_per_s']:.2f} peak_mem_gib {peak:.2f} "
                  f"launches {launches} (K2 0 in the windowed prefill)")
        if graphs:
            prof = profile_steps(torch, card, eng, prompt, warm=1,
                                 steps=WIN_PROFILE_STEPS, prefill=False,
                                 label=f"llama3.1-8b window {WIN_SIZE}")
            run.update({k: prof[k] for k in (
                "busy_ms_step", "idle_share", "idle_share_unprofiled",
                "device_launches_step")})
        runs[graphs] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    first = runs[True]["tokens"][:, :WIN_EAGER_NEW]
    if not np.array_equal(first, runs[False]["tokens"]):
        raise AssertionError("windowed: graphs and eager differ:\n"
                             f"{first}\n{runs[False]['tokens']}")
    say(card, f"windowed llama3.1-8b: graphs == eager (the first "
              f"{WIN_EAGER_NEW} tokens; launches held to each run's steps "
              f"and chunks); device busy ms/step "
              f"{runs[True]['busy_ms_step']:.2f}")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return {RUN_LABEL[g]: {k: v for k, v in r.items() if k != "tokens"}
            for g, r in runs.items()}


def _windowed_fp32(torch, card):
    """(a) in fp32 (TF32 off) at full width and WIN_FP32_LAYERS layers, a
    WIN_FP32_PROMPT-token prompt: ``generate`` with full verification,
    with graphs, equals the port's compiled AR decoding (the same
    windowed prefill, then unwindowed decode, as the reference)."""
    import gc
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.core.reference import CompiledAR
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b", "float32", seed=2,
        prompt_len=WIN_FP32_PROMPT, prompt_seed=1, layers=WIN_FP32_LAYERS)
    cfg = cfg.replace(window_size=WIN_SIZE)
    max_len = request_token_need(prompt.shape[1], WIN_FP32_NEW,
                                 spec.buffer_size, dcfg.tree_depth + 1)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, partial_verification=False,
                       device="cuda", **PAGED_ZERO_COPY)
    toks, stats = eng.generate(prompt, WIN_FP32_NEW)
    if not eng._graphs or set(stats["modes"]) != {"full"}:
        raise AssertionError(f"windowed fp32: graphs {list(eng._graphs)}, "
                             f"modes {stats['modes']}")
    del eng
    ar = CompiledAR(cfg, params, batch=1, max_len=max_len, spec=spec,
                    device="cuda").generate(prompt, WIN_FP32_NEW)
    if not np.array_equal(toks, ar):
        raise AssertionError(f"windowed fp32 speculative differs from the "
                             f"compiled AR:\n{toks}\n{ar}")
    secs = time.perf_counter() - t0
    say(card, f"windowed lossless llama3.1-8b {WIN_FP32_LAYERS} layers fp32 "
              f"window {WIN_SIZE}, graphs: speculative (full verification) "
              f"== compiled AR over {WIN_FP32_NEW} tokens (prompt "
              f"{prompt.shape[1]}, modes {stats['modes']}); {secs:.1f} s")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return dict(modes=stats["modes"], seconds=secs)


def _cp_shards(torch, dtype, total, world, dev, ranks, seed=18):
    """Phase 18 (b)'s inputs at deepseek-7b's heads: q [1, T, H, Dh] (x4,
    so the softmax over half a million keys is not flat), the given
    ranks' contiguous K/V shards [1, total / world, Hk, Dh], each drawn
    from its own seed (a rank draws its own shard, the parent all of
    them, bit-equal), with their block max/min [1, blocks, Hk, Dh] fp32,
    and the rows' global length.  Returns (q, [k], [v], [kmax], [kmin],
    length)."""
    h, hk, dh = CP_HEADS["h"], CP_HEADS["hk"], CP_HEADS["dh"]
    s_loc, bs = total // world, 128
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = (torch.randn((1, CP_T, h, dh), generator=g, device=dev) * 4).to(dtype)
    ks, vs, kxs, kns = [], [], [], []
    for r in ranks:
        g.manual_seed(seed + 1 + r)
        k = torch.randn((1, s_loc, hk, dh), generator=g, device=dev,
                        dtype=dtype)
        v = torch.randn((1, s_loc, hk, dh), generator=g, device=dev,
                        dtype=dtype)
        kb = k.view(1, s_loc // bs, bs, hk, dh)
        ks.append(k)
        vs.append(v)
        kxs.append(kb.amax(dim=2).float())
        kns.append(kb.amin(dim=2).float())
    length = torch.tensor([total - CP_LENGTH_SHORT], dtype=torch.int32,
                          device=dev)
    return q, ks, vs, kxs, kns, length


def _cp_rank_times(torch, dist, rank, world, q, k, v, kx, kn, length, sel,
                   vlen, bs):
    """A rank's bf16 kernel times (CUDA events, the ``Timer``; the ranks
    in turns, so no two share the card while timed) and the merge's two
    all-reduces (host clock, both ranks calling, 10 calls)."""
    from repro_torch.distributed import psum_softmax_merge
    from repro_torch.kernels import ops
    s_loc = k.shape[1]
    local = torch.clamp(length - rank * s_loc, 0, s_loc)
    kf, _ = ops.flat_blocks(k)
    vf, _ = ops.flat_blocks(v)
    ids, vl = (a.to(torch.int32).contiguous() for a in (sel, vlen))
    qw = torch.ones((1, q.shape[1]), dtype=torch.float32, device=q.device)
    calls = {"K1 contiguous": lambda: ops.contiguous_verify_attention(
                 q, k, v, local, bs),
             "K1 block list": lambda: ops.block_attention(q, kf, vf, ids, vl,
                                                          bs),
             "K3": lambda: ops.retrieval_scores(q, kx, kn, qw)}
    timer = Timer(torch)
    times = {}
    for turn in range(world):
        dist.barrier()
        if turn == rank:
            times = {name: timer(fn) for name, fn in calls.items()}
        torch.cuda.synchronize()
    m, l, acc = calls["K1 contiguous"]()
    psum_softmax_merge(m, l, acc)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(10):
        psum_softmax_merge(m, l, acc)
    torch.cuda.synchronize()
    ar_ms = (time.perf_counter() - t0) * 1e3 / 10
    return dict(times=times, allreduce_ms=ar_ms,
                allreduce_bytes=(m.numel() + l.numel() + acc.numel()) * 4)


def _cp_rank(rank, world, backend, init_file, out_dir):
    """One rank of phase 18 (b), a spawned process: its shard through
    ``cp_full_verify_attention`` and ``cp_partial_verify_attention`` (the
    launch counts set to 0 just before and read just after), in bf16 at
    CP_TOKENS and in fp32 at CP_FP32_TOKENS; in bf16 also its kernel
    and all-reduce times.  Saves the outputs, selections, counts and
    times to ``rank<r>.pt``."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SpecPVConfig
    from repro_torch.distributed import (cp_full_verify_attention,
                                         cp_partial_verify_attention,
                                         local_selection)
    from repro_torch.kernels import build, ops
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        build.load_library()
        spec = SpecPVConfig()
        bs, budget = spec.block_size, spec.retrieval_budget_blocks
        res = dict(device=torch.cuda.get_device_name(dev))
        for dtype, total in ((torch.bfloat16, CP_TOKENS),
                             (torch.float32, CP_FP32_TOKENS)):
            q, ks, vs, kxs, kns, length = _cp_shards(torch, dtype, total,
                                                     world, dev, (rank,))
            k, v, kx, kn = ks[0], vs[0], kxs[0], kns[0]
            del ks, vs, kxs, kns

            def run():
                return (cp_full_verify_attention(q, k, v, length, bs),
                        cp_partial_verify_attention(spec, budget, q, k, v,
                                                    kx, kn, length))
            run()                           # the first collectives
            torch.cuda.synchronize()
            dist.barrier()
            ops.reset_launch_counts()
            out_f, out_p = run()
            torch.cuda.synchronize()
            launches = dict(ops.LAUNCHES)
            sel, vlen = local_selection(spec, max(1, budget // world), q, kx,
                                        kn, length, rank)
            row = dict(full=out_f.cpu(), partial=out_p.cpu(), sel=sel.cpu(),
                       launches=launches)
            if dtype == torch.bfloat16:
                row.update(_cp_rank_times(torch, dist, rank, world, q, k, v,
                                          kx, kn, length, sel, vlen, bs))
            res[str(dtype).split(".")[-1]] = row
            del q, k, v, kx, kn
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cp_spawn(torch, world, backend, timeout_s=300.0):
    """Spawn ``world`` ranks of ``_cp_rank`` over a file store in a fresh
    temporary directory, wait (killing every rank after ``timeout_s``);
    a rank's failure raises here.  Returns each rank's saved results."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="cp_ranks_")
    try:
        ctx = mp.start_processes(_cp_rank, args=(
            world, backend, os.path.join(tmp, "store"), tmp), nprocs=world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cp_close(torch, card, label, got, want, tol):
    """``allclose(got, want, rtol=tol, atol=tol)`` on the card, else
    raise.  Returns the largest absolute difference."""
    got, want = got.to(want.device).float(), want.float()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{label}: max abs err {err:.3e} over tol {tol}"
                             f" (max |want| {peak:.3e})")
    say(card, f"{label}: max abs err {err:.3e} (tol {tol}; max |want| "
              f"{peak:.3e})")
    return err


def _cp_kernel_rows(torch, card, timer, q, k, v, kx, kn, length, spec,
                    world):
    """The phase's kernel call forms on rank 0's shard (every block valid)
    against their plain versions, timed: K1's contiguous form (SDPA over
    the same shard), K1's block-list form over the shard's selection
    (SDPA over the gathered blocks) and K3 over the shard's summaries
    (no library call).  Returns {kernel: {label: row}}."""
    import torch.nn.functional as F
    from repro_torch.distributed import local_selection
    from repro_torch.kernels import ops, ref
    bs = spec.block_size
    _, s_loc, hk, dh = k.shape
    t, h = q.shape[1], q.shape[2]
    nb = s_loc // bs
    dev = q.device
    kf, _ = ops.flat_blocks(k)
    vf, _ = ops.flat_blocks(v)
    local = torch.clamp(length, 0, s_loc)
    vl = torch.clamp(local[:, None] - torch.arange(nb, device=dev) * bs, 0,
                     bs)[:, None].expand(1, hk, nb).to(torch.int32)
    vl = vl.contiguous()
    ids = torch.arange(nb, dtype=torch.int32, device=dev)[None, None] \
        .expand(1, hk, nb).contiguous()
    qh = q.transpose(1, 2)
    k1, k3 = "sparse_verify_attention", "retrieval_score"
    rows = {k1: {}, k3: {}}
    label = f"K1 CP shard contiguous T={t} S_loc={s_loc} H={h}/{hk}"
    nbytes, flops = _attn_work(q, vl, t)
    rows[k1][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.contiguous_verify_attention(q, k, v, local, bs),
        lambda: ref.block_attention_batched(q, kf, vf, ids, vl, bs),
        nbytes, flops, lambda: F.scaled_dot_product_attention(
            qh, k.transpose(1, 2), v.transpose(1, 2)))
    sel, vlen = local_selection(spec, max(1, spec.retrieval_budget_blocks
                                          // world), q, kx, kn, length, 0)
    sid, svl = (a.to(torch.int32).contiguous() for a in (sel, vlen))
    hsel = torch.arange(hk, device=dev)[:, None]
    kh_ = k.view(nb, bs, hk, dh).permute(2, 0, 1, 3)[hsel, sel[0]] \
        .reshape(1, hk, -1, dh)
    vh_ = v.view(nb, bs, hk, dh).permute(2, 0, 1, 3)[hsel, sel[0]] \
        .reshape(1, hk, -1, dh)
    label = (f"K1 CP shard selection T={t} NS={sel.shape[-1]} of {nb} "
             f"H={h}/{hk}")
    nbytes, flops = _attn_work(q, svl, t)
    rows[k1][label] = _attn_row(
        torch, card, timer, label,
        lambda: ops.block_attention(q, kf, vf, sid, svl, bs),
        lambda: ref.block_attention_batched(q, kf, vf, sid, svl, bs),
        nbytes, flops,
        lambda: F.scaled_dot_product_attention(qh, kh_, vh_))
    qw = torch.ones((1, t), dtype=torch.float32, device=dev)
    label = f"K3 CP shard scores T={t} NB={nb} H={h}/{hk}"
    got = ops.retrieval_scores(q, kx, kn, qw)
    want = ref.retrieval_score_batched(q, kx, kn, qw)
    torch.cuda.synchronize()
    _close(label, got, want)
    err = (got - want).abs().max().item()
    ms = timer.kernel_ms(lambda: ops.retrieval_scores(q, kx, kn, qw),
                         "retrieval_score_kernel")
    if timer.per_call != 1:
        raise AssertionError(f"{label}: {timer.per_call} launches per call")
    plain_ms = timer(lambda: ref.retrieval_score_batched(q, kx, kn, qw),
                     iters=3, warmup=1)
    nbytes = (q.numel() * q.element_size() + 2 * kx.numel() * 4 + t * 4
              + hk * nb * 4)
    bound, by = _bound_ms(nbytes, 2 * 2 * dh * (h // hk) * t * hk * nb,
                          PEAK_FP32_S)
    say(card, f"kernel {label}: max_abs_err {err:.3e} (tol {TOL_KERNEL} of "
              f"max |plain|) ms {ms:.4f} ({timer.source}) plain_ms "
              f"{plain_ms:.4f} bound_us {bound * 1e3:.3f} ({by}) "
              f"library_ms none")
    rows[k3][label] = dict(max_abs_err=err, ms=ms, timing=timer.source,
                           plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                           library_ms=None)
    return rows


def _cp_phase(torch, card, timer):
    """(b): CP_RANKS ranks (gloo, both on the one card, or NCCL with one
    rank per card where there are enough), each a contiguous sequence
    shard of the reference's case D1 (deepseek-7b's heads, 524288 tokens,
    B = 1, T = 8, ``SpecPVConfig()``): the ranks' Full output against K1's
    unsharded contiguous form over the whole context (bf16, and fp32 at
    CP_FP32_TOKENS), their Partial output and selections against the
    single-process form on the same shards, every rank bit-equal to rank
    0, K1 and K3 launched on every rank; the call forms against their
    plain versions, timed; the traffic model at this shape."""
    from repro_torch.configs import SpecPVConfig
    from repro_torch.distributed import (cp_partial_verify_single,
                                         merged_partials_bytes,
                                         verify_traffic_report)
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm
    world = CP_RANKS
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    where = ("gloo, both ranks on cuda:0, the all-reduces staged through "
             "the host" if backend == "gloo"
             else "NCCL, one rank per card")
    t0 = time.perf_counter()
    ranks = _cp_spawn(torch, world, backend)
    spawn_s = time.perf_counter() - t0
    k1, k3 = "sparse_verify_attention", "retrieval_score"
    for dt in ("bfloat16", "float32"):
        for r, res in enumerate(ranks):
            n = {k: v for k, v in res[dt]["launches"].items() if v}
            if n != {k1: 2, k3: 1}:
                raise AssertionError(f"CP rank {r} {dt}: launches {n}, "
                                     f"expected K1 2 (Full, Partial), K3 1")
            for key in ("full", "partial"):
                if not torch.equal(res[dt][key], ranks[0][dt][key]):
                    raise AssertionError(f"CP {dt} {key}: rank {r} is not "
                                         f"bit-equal to rank 0")
    spec = SpecPVConfig()
    bs, budget = spec.block_size, spec.retrieval_budget_blocks
    before = ops.launch_counts()
    errs = {}
    for dtype, total, tol in ((torch.bfloat16, CP_TOKENS, CP_BF16_TOL),
                              (torch.float32, CP_FP32_TOKENS, CP_FP32_TOL)):
        dt = str(dtype).split(".")[-1]
        q, ks, vs, kxs, kns, length = _cp_shards(torch, dtype, total, world,
                                                 "cuda", range(world))
        k_all, v_all = torch.cat(ks, dim=1), torch.cat(vs, dim=1)

        def unsharded():
            return ops.contiguous_verify_attention(q, k_all, v_all, length,
                                                   bs)
        whole = cm.combine_attn_parts([unsharded()], dtype)
        errs[f"full {dt}"] = _cp_close(
            torch, card, f"CP Full {dt} ({world} ranks, {total} tokens) "
                         f"vs K1 unsharded", ranks[0][dt]["full"], whole,
            tol)
        if dtype == torch.bfloat16:
            unsharded_ms = timer(unsharded, iters=3, warmup=1)
        del k_all, v_all, whole
        torch.cuda.empty_cache()
        out, sels = cp_partial_verify_single(spec, budget, q, ks, vs, kxs,
                                             kns, length)
        for r, res in enumerate(ranks):
            if not torch.equal(sels[r].cpu(), res[dt]["sel"]):
                raise AssertionError(f"CP Partial {dt}: rank {r}'s "
                                     f"selection differs from the "
                                     f"single-process form's")
        errs[f"partial {dt}"] = _cp_close(
            torch, card, f"CP Partial {dt} vs the single-process form "
                         f"(selections equal, {sels[0].shape[-1]} blocks "
                         f"per shard)", ranks[0][dt]["partial"], out, tol)
        if dtype == torch.bfloat16:
            rows = _cp_kernel_rows(torch, card, timer, q, ks[0], vs[0],
                                   kxs[0], kns[0], length, spec, world)
        del q, ks, vs, kxs, kns, out
        torch.cuda.empty_cache()
    ops.set_launch_counts(before)
    h, dh = CP_HEADS["h"], CP_HEADS["dh"]
    msg = merged_partials_bytes(1, CP_T, h, dh, 1, world) // (2 * (world - 1))
    report = verify_traffic_report(
        batch=1, q_tokens=CP_T, num_heads=h, num_kv_heads=CP_HEADS["hk"],
        head_dim=dh, num_layers=CP_LAYERS, n_shards=world,
        budget_blocks=budget, block_size=bs)
    per_rank = []
    for r, res in enumerate(ranks):
        b16 = res["bfloat16"]
        if b16["allreduce_bytes"] != msg:
            raise AssertionError(f"rank {r} all-reduced "
                                 f"{b16['allreduce_bytes']} bytes a call, "
                                 f"the traffic model's message is {msg}")
        per_rank.append(dict(device=res["device"],
                             launches=b16["launches"],
                             kernel_ms=b16["times"],
                             allreduce_ms=b16["allreduce_ms"]))
        say(card, f"CP rank {r} ({res['device']}, {where}): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in
                              b16["times"].items())
                  + f" (CUDA events, ranks timed in turns); launches "
                  f"K1 {b16['launches'][k1]} K3 {b16['launches'][k3]}; "
                  f"merge (2 all-reduces) {b16['allreduce_ms']:.3f} ms "
                  f"host clock, {b16['allreduce_bytes']} bytes a call "
                  f"(traffic model message {msg} bytes)")
    say(card, f"CP {world} ranks ({where}) over {CP_TOKENS} tokens at "
              f"deepseek-7b heads: unsharded K1 over the whole context "
              f"{unsharded_ms:.4f} ms (CUDA events); traffic model at "
              f"{CP_LAYERS} layers: merged {report['merged_partials_bytes']} "
              f"bytes vs gathered {report['gathered_blocks_bytes']} bytes a "
              f"tick, ratio {report['traffic_ratio']:.1f}; spawn to join "
              f"{spawn_s:.1f} s")
    launched = {k: sum(res["bfloat16"]["launches"][k] for res in ranks)
                for k in (k1, k3)}
    return dict(shapes=rows, cp_launches=launched,
                numbers=dict(backend=backend, ranks=per_rank,
                             unsharded_k1_ms=unsharded_ms,
                             allreduce_message_bytes=msg, traffic=report,
                             max_abs_err=errs, spawn_s=spawn_s))


def phase_windowed_cp(torch, card, timer):
    """Phase 18: (a) windowed llama3.1-8b ``generate`` (graphs, eager, a
    profiled window, fp32 losslessness); (b) context-parallel
    verification over CP_RANKS ranks.  Returns the kernel rows, the CP
    launches and the numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs = {}
    win = _windowed_generate(torch, card)
    secs["a"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    win32 = _windowed_fp32(torch, card)
    secs["a fp32"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cp = _cp_phase(torch, card, timer)
    secs["b"] = time.perf_counter() - t0
    total = time.perf_counter() - t_phase
    say(card, "phase 18 " + ", ".join(f"({k}) {v:.1f} s"
                                      for k, v in secs.items())
              + f"; phase 18 took {total:.1f} s")
    return dict(shapes=cp["shapes"], cp_launches=cp["cp_launches"],
                windowed=win, windowed_fp32=win32, cp=cp["numbers"],
                seconds=secs, total_s=total)


# ---------------------------------------------------------------------------
# phase 19: the launch steps and the int8 resident decode cache
# ---------------------------------------------------------------------------

LAUNCH_PROMPT = 8192            # (a): one prefill call over the whole prompt
LAUNCH_STEPS = 16               # (a): full and partial decode steps, each way
LAUNCH_RWKV_PROMPT = 256
LAUNCH_RWKV_STEPS = 8
LAUNCH_TRAIN_LAYERS = 4
LAUNCH_TRAIN_SEQ = 512
LAUNCH_FP32_LAYERS = 4
LAUNCH_FP32_PROMPT = 300
LAUNCH_FP32_NEW = 32
HILLCLIMB_STEPS = 4
INT8_K1_TOL = 3e-2              # int8 read against K1 over the bf16 dequant


def _zero_launches():
    from repro_torch.kernels import ops
    return {k: 0 for k in ops.KERNELS}


def _launch_step_runs(torch, card, label, body, tok, static, steps, want):
    """``steps`` calls of ``body`` (one decode step that writes its next
    token into ``tok``) eagerly, each under the sync check; then,
    from the same state (``static`` restored), the body captured as a
    CUDA graph and replayed ``steps`` times.  Each call is timed with CUDA
    events; each run's launch counts are set to 0 just before it and must
    equal ``want`` just after; the graph's tokens must equal the eager
    ones.  Returns the numbers and the launches of both runs."""
    from repro_torch.core.engine import capture_graph
    from repro_torch.kernels import ops
    snap = [t.clone() for t in static]
    runs, total = {}, _zero_launches()
    for graphs in (False, True):
        call = body
        if graphs:
            for t, c in zip(static, snap):
                t.copy_(c)
            call = capture_graph(body, tok.device, static,
                                 torch.cuda.graph_pool_handle()).replay
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        toks, evs = [], []

        def run():
            for _ in range(steps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                call()
                e1.record()
                evs.append((e0, e1))
                toks.append(tok.clone())
        if graphs:
            run()
        else:
            _no_sync(torch, run)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        if launches != want:
            raise AssertionError(f"{label} {RUN_LABEL[graphs]}: launches "
                                 f"{launches} != {want}")
        for k, n in launches.items():
            total[k] += n
        ms = sorted(a.elapsed_time(b) for a, b in evs)
        runs[graphs] = dict(tokens=torch.stack(toks).cpu(),
                            ms_median=ms[len(ms) // 2], ms_min=ms[0])
    if not torch.equal(runs[True]["tokens"], runs[False]["tokens"]):
        raise AssertionError(f"{label}: graph tokens differ from eager:\n"
                             f"{runs[True]['tokens'].T}\n"
                             f"{runs[False]['tokens'].T}")
    out = {f"{RUN_LABEL[g]}_ms": r["ms_median"] for g, r in runs.items()}
    out[f"{RUN_LABEL[True]}_ms_min"] = runs[True]["ms_min"]
    say(card, f"launch steps [{label}]: {steps} steps eager (each under the "
              f"sync check) == graph replays, token for token; device ms "
              f"per step eager {out['eager_ms']:.3f}, graphs "
              f"{out['graphs_ms']:.3f} (median of {steps}); launches per run "
              f"{want}")
    return out, total


def _launch_llama(torch, card):
    """(a) llama3.1-8b at full width (32 layers, bf16, batch 1,
    ``SpecPVConfig()``) through ``launch.steps``: one prefill call over
    LAUNCH_PROMPT tokens (K2, K4), LAUNCH_STEPS full decode steps (K1, K4)
    eager and as a graph, one ``decode(select_partial=True)`` whose token
    is committed (K1, K3, K4), then LAUNCH_STEPS partial steps over the
    selection (the plain per-head attention, no kernel) eager and as a
    graph."""
    import gc
    import numpy as np
    from repro_torch.configs import SpecPVConfig, get_config
    from repro_torch.core import verify as vf
    from repro_torch.core.engine import copy_into
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig()
    layers = cfg.num_layers
    params = api.init_params(cfg, seed=0, device=dev)
    max_len = LAUNCH_PROMPT + 4 * LAUNCH_STEPS
    cache = api.init_cache(cfg, 1, max_len, spec, device=dev)
    ops.reserve_split_counters(ops.split_counter_slots(
        1, 1, cfg.num_heads, cfg.num_kv_heads,
        -(-max_len // spec.block_size)), dev)
    prompt = torch.as_tensor(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (1, LAUNCH_PROMPT)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    num, total = {}, _zero_launches()

    def held(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got} != {want}")
        for k, n in got.items():
            total[k] += n
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tok, _ = st.make_prefill_step(cfg, spec)(params, cache, prompt, None)
    torch.cuda.synchronize()
    num["prefill_s"] = time.perf_counter() - t0
    held("prefill step", dict(ops.LAUNCHES),
         dict(_zero_launches(), paged_prefill_attention=layers,
              block_summary=1))
    say(card, f"launch steps [llama3.1-8b prefill]: one call over "
              f"{LAUNCH_PROMPT} tokens in {num['prefill_s']:.3f} s "
              f"(K2 {layers}, K4 1)")
    tokbuf = tok.clone()
    full = st.make_decode_step(cfg, spec)

    def full_body():
        tokbuf.copy_(full(params, cache, tokbuf)[0])
    num["full"], got = _launch_step_runs(
        torch, card, "llama3.1-8b full", full_body, tokbuf,
        [tokbuf, cache["length"], cache["kmax"], cache["kmin"]],
        LAUNCH_STEPS, dict(_zero_launches(),
                           sparse_verify_attention=layers * LAUNCH_STEPS,
                           block_summary=LAUNCH_STEPS))
    for k, n in got.items():
        total[k] += n
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = api.decode(cfg, params, tokbuf[:, None], cache["length"][:, None],
                     cache, mode="full", spec=spec, select_partial=True)
    copy_into(cache, vf.append_full_cache(
        cache, out.new_kv[0], out.new_kv[1],
        torch.ones((1,), dtype=torch.int32, device=dev), spec))
    tokbuf.copy_(torch.argmax(out.logits[:, 0], dim=-1).to(torch.int32))
    pk, pv, ppos, buf_len = st.partial_state(spec, out.partial)
    del out
    torch.cuda.synchronize()
    held("select_partial", dict(ops.LAUNCHES),
         dict(_zero_launches(), sparse_verify_attention=layers,
              retrieval_score=layers, block_summary=1))
    if int((ppos[:, :, :, :spec.partial_budget_tokens] >= 0).sum()) == 0:
        raise AssertionError("select_partial selected no valid token")
    partial = st.make_decode_step(cfg, spec, partial=True)

    def partial_body():
        tokbuf.copy_(partial(params, cache, pk, pv, ppos, buf_len,
                             tokbuf)[0])
    num["partial"], got = _launch_step_runs(
        torch, card, "llama3.1-8b partial", partial_body, tokbuf,
        [tokbuf, ppos, buf_len], LAUNCH_STEPS, _zero_launches())
    for k, n in got.items():
        total[k] += n
    if int(buf_len[0]) != LAUNCH_STEPS:
        raise AssertionError(f"partial steps: buf_len {int(buf_len[0])}")
    num["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params, cache, pk, pv, ppos
    gc.collect()
    torch.cuda.empty_cache()
    return num, total


def _launch_rwkv(torch, card):
    """(a) rwkv6-3b at full width (32 layers, bf16): a prefill step over
    LAUNCH_RWKV_PROMPT tokens, then LAUNCH_RWKV_STEPS state steps (a
    read-only decode and an advance each: K5 twice per layer) eager and as
    a graph."""
    import gc
    import numpy as np
    from repro_torch.configs import SpecPVConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    dev = torch.device("cuda")
    cfg = get_config("rwkv6-3b")
    spec = SpecPVConfig()
    params = api.init_params(cfg, seed=0, device=dev)
    cache = api.init_cache(cfg, 1, 1024, spec, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, LAUNCH_RWKV_PROMPT)), device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tok, _ = st.make_prefill_step(cfg, spec)(params, cache, prompt, None)
    torch.cuda.synchronize()
    total = dict(ops.LAUNCHES)
    if total != dict(_zero_launches(), wkv=cfg.num_layers):
        raise AssertionError(f"rwkv prefill step: launches {total}")
    tokbuf = tok.clone()
    step = st.make_decode_step(cfg, spec)

    def body():
        tokbuf.copy_(step(params, cache, tokbuf)[0])
    static = [tokbuf] + [v for v in cache.values() if torch.is_tensor(v)]
    num, got = _launch_step_runs(
        torch, card, "rwkv6-3b state", body, tokbuf, static,
        LAUNCH_RWKV_STEPS,
        dict(_zero_launches(), wkv=2 * cfg.num_layers * LAUNCH_RWKV_STEPS))
    for k, n in got.items():
        total[k] += n
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return num, total


def _launch_train(torch, card):
    """(a) two ``make_train_step`` calls at LAUNCH_TRAIN_LAYERS layers of
    llama3.1-8b's width (bf16, fp32 moments), a LAUNCH_TRAIN_SEQ-token
    batch: finite losses, the parameters moved in place, no kernel (the
    kernels have no backward)."""
    import gc
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    from repro_torch.train.optimizer import adamw_init
    dev = torch.device("cuda")
    cfg = get_config("llama3.1-8b").replace(num_layers=LAUNCH_TRAIN_LAYERS)
    params = api.init_params(cfg, seed=4, device=dev)
    opt = adamw_init(params)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, LAUNCH_TRAIN_SEQ + 1),
                           generator=g, device=dev)
    w0 = params["layers"][0]["attn"]["wq"].clone()
    ptr = params["layers"][0]["attn"]["wq"].data_ptr()
    step = st.make_train_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ms, losses = [], []
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, loss = step(params, opt, tokens, None)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(loss))
    launches = dict(ops.LAUNCHES)
    wq = params["layers"][0]["attn"]["wq"]
    if (not all(map(math.isfinite, losses)) or wq.data_ptr() != ptr
            or torch.equal(wq, w0) or opt.step != 2
            or launches != _zero_launches()):
        raise AssertionError(f"train step: losses {losses}, moved "
                             f"{not torch.equal(wq, w0)}, in place "
                             f"{wq.data_ptr() == ptr}, launches {launches}")
    num = dict(first_ms=ms[0], ms=ms[1], losses=losses)
    say(card, f"launch steps [train, llama3.1-8b width, "
              f"{LAUNCH_TRAIN_LAYERS} layers, {LAUNCH_TRAIN_SEQ} tokens]: "
              f"losses {[round(x, 4) for x in losses]}, {ms[1]:.1f} ms a "
              f"step (the first, with the process's autograd set-up, "
              f"{ms[0]:.1f}; CUDA events), parameters moved in place, no "
              f"kernel launch")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return num


def _launch_lossless(torch, card):
    """(c) fp32 (TF32 off) at full width and LAUNCH_FP32_LAYERS layers: a
    prefill step and LAUNCH_FP32_NEW - 1 full decode steps give the
    port's AR oracle's tokens (``core.reference.autoregressive_generate``).
    Returns the kernel launches of the steps."""
    import gc
    import numpy as np
    from repro_torch.configs import SpecPVConfig, get_config
    from repro_torch.core.reference import autoregressive_generate
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("llama3.1-8b").replace(
        num_layers=LAUNCH_FP32_LAYERS, dtype="float32",
        param_dtype="float32")
    spec = SpecPVConfig()
    params = api.init_params(cfg, seed=2, device=dev)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, LAUNCH_FP32_PROMPT)).astype(np.int64)
    max_len = LAUNCH_FP32_PROMPT + LAUNCH_FP32_NEW + 8
    cache = api.init_cache(cfg, 1, max_len, spec, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tok, _ = st.make_prefill_step(cfg, spec)(
        params, cache, torch.as_tensor(prompt, device=dev), None)
    step = st.make_decode_step(cfg, spec)
    toks = [tok]
    for _ in range(LAUNCH_FP32_NEW - 1):
        tok, _ = step(params, cache, tok)
        toks.append(tok)
    got = torch.stack(toks, dim=1).cpu().numpy()
    launches = dict(ops.LAUNCHES)
    ar = autoregressive_generate(cfg, params, prompt, LAUNCH_FP32_NEW,
                                 max_len=max_len, spec=spec, device=dev)
    if not np.array_equal(got, ar):
        raise AssertionError(f"fp32 launch steps differ from AR:\n{got}\n"
                             f"{ar}")
    say(card, f"launch steps lossless llama3.1-8b {LAUNCH_FP32_LAYERS} "
              f"layers fp32: prefill step + {LAUNCH_FP32_NEW - 1} full decode "
              f"steps == autoregressive_generate over {LAUNCH_FP32_NEW} "
              f"tokens (prompt {LAUNCH_FP32_PROMPT})")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _int8_vs_k1(torch, case):
    """B1's T = 1 context attention over layer 0 of its int8 cache
    (``dense_attn_part_quant``) against K1 over the same layer dequantised
    to bf16 (``kvcache.quant.dequantize_kv``), same random bf16 queries.
    Comparison launches are not counted.  Returns the largest abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kvcache.quant import dequantize_kv
    from repro_torch.models import common as cm
    cfg, spec = case.info["cfg"], case.info["spec"]
    cache = case.args[1]
    k, v = cache["k"][0], cache["v"][0]
    ks, vs = cache["k_scale"][0], cache["v_scale"][0]
    length = cache["length"]
    b, s = k.shape[:2]
    g = torch.Generator(device=k.device)
    g.manual_seed(7)
    q = torch.randn((b, 1, cfg.num_heads, cfg.head_dim_), generator=g,
                    device=k.device).to(torch.bfloat16)
    valid = torch.arange(s, device=k.device)[None] < length[:, None]
    got = cm.combine_attn_parts(
        [cm.dense_attn_part_quant(q, k, v, ks, vs, valid)], torch.float32)
    counts = ops.launch_counts()
    kd = dequantize_kv(k, ks, torch.bfloat16)
    vd = dequantize_kv(v, vs, torch.bfloat16)
    want = cm.combine_attn_parts(
        [ops.contiguous_verify_attention(q, kd, vd, length,
                                         spec.block_size)], torch.float32)
    torch.cuda.synchronize()
    ops.set_launch_counts(counts)
    err = float((got - want).abs().max())
    if not err <= INT8_K1_TOL:
        raise AssertionError(f"B1 int8 attention vs K1 over the dequantised "
                             f"cache: max abs err {err:.3e}")
    return err


def _launch_hillclimb(torch, card):
    """(b) every case of ``launch.hillclimb.CASES`` on the card through
    ``run_case``: built at the reference's shape (the cuts listed in its
    ``reduced``), HILLCLIMB_STEPS steps eagerly (each under the sync
    check) and replayed as a CUDA graph from the same state (equal bit for
    bit), then freed with the cyclic collector run.  B1 also holds its
    int8 read to K1 over the dequantised bf16 layer (INT8_K1_TOL); A2's
    bonus tokens are reported against A1's."""
    from repro_torch.launch import hillclimb as hc
    out, total = {}, _zero_launches()
    for name in hc.CASES:
        check = None
        if name.startswith("B1"):
            def check(case, res):
                res["int8_vs_k1_max_abs_err"] = _int8_vs_k1(torch, case)
        r = hc.run_case(name, device="cuda", steps=HILLCLIMB_STEPS,
                        check=check)
        for part in ("launches_eager", "launches_graph"):
            for k, n in r[part].items():
                total[k] += n
        keep = {k: v for k, v in r.items() if k not in ("tokens",)}
        out[name] = keep
        gib = 2.0**30
        say(card, f"hillclimb {name}: reduced {r['reduced']}; reckoned "
                  f"{ {k: round(v / 1e9, 2) for k, v in r['reckoned_bytes'].items()} } "
                  f"GB; state {r['state_bytes'] / 1e9:.2f} GB, peak "
                  f"{r['peak_bytes'] / gib:.2f} GiB; ms per step eager "
                  f"{r['eager_ms_median']:.3f}, graph "
                  f"{r['graph_ms_median']:.3f} (median of {HILLCLIMB_STEPS}, "
                  f"CUDA events); graph == eager bit for bit; launches "
                  f"eager {r['launches_eager']}; built in "
                  f"{r['build_s']:.1f} s"
                  + (f"; int8 vs K1 over bf16 max abs err "
                     f"{r['int8_vs_k1_max_abs_err']:.3e}"
                     if "int8_vs_k1_max_abs_err" in r else ""))
        if name.startswith("A1"):
            a1 = r["tokens"]
        if name.startswith("A2"):
            same = sum(x == y for sa, sb in zip(a1, r["tokens"])
                       for x, y in zip(sa, sb))
            n = sum(len(s) for s in a1)
            out[name]["bonus_equal_to_A1"] = f"{same}/{n}"
            say(card, f"hillclimb A2 against A1 (the pkv A2's was quantised "
                      f"from): {same} of {n} bonus tokens equal (reported)")
    return out, total


def phase_launch(torch, card):
    """Phase 19: ``launch.steps`` at full width, the hillclimb cases and
    the fp32 losslessness of the launch steps.  Returns the launches of
    every step the phase ran (``launch_launches``) and the numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    secs, total = {}, _zero_launches()

    def add(got):
        for k, n in got.items():
            total[k] += n
    t0 = time.perf_counter()
    llama, got = _launch_llama(torch, card)
    add(got)
    rwkv, got = _launch_rwkv(torch, card)
    add(got)
    train = _launch_train(torch, card)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases, got = _launch_hillclimb(torch, card)
    add(got)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add(_launch_lossless(torch, card))
    secs["c"] = time.perf_counter() - t0
    for name in ("sparse_verify_attention", "paged_prefill_attention",
                 "retrieval_score", "block_summary", "wkv"):
        if total[name] == 0:
            raise AssertionError(f"phase 19: {name} was never launched")
    t_total = time.perf_counter() - t_phase
    say(card, "phase 19 " + ", ".join(f"({k}) {v:.1f} s"
                                      for k, v in secs.items())
              + f"; phase 19 took {t_total:.1f} s")
    return dict(launches=total, llama=llama, rwkv=rwkv, train=train,
                hillclimb=cases, seconds=secs, total_s=t_total)


# ---------------------------------------------------------------------------
# phase 20: data-parallel serving (the engine's mesh= over two data shards)
# ---------------------------------------------------------------------------

DP_SHARDS = 2
# (b): fp32 at full width, cut to the depth that keeps it under 10 s
DP_FP32_LAYERS = 2
DP_FP32_REQS = ((1500, 16), (4700, 24), (2600, 16), (4900, 24))
DP_FP32_MAX_LEN = 5120


def _dp_timed(torch, eng):
    """Wrap each shard's step launch in CUDA events on its stream: the
    device span of each shard's part of every tick (a shard's span ends
    where the next one's begins, both shards sharing one card).  Returns
    the per-shard lists of event pairs; ``_dp_untime`` removes the
    wrappers."""
    spans = [[] for _ in eng.shards]

    def timed(s, fn):
        def run(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            spans[s].append((e0, e1))
            return out
        return run
    for s, sub in enumerate(eng.shards):
        sub._step_launch = timed(s, sub._step_launch)
    return spans


def _dp_untime(eng):
    for sub in eng.shards:
        del sub._step_launch


def _dp_serve(torch, eng, reqs):
    """Serve ``reqs`` through a fresh continuous scheduler on ``eng``
    (blocking admission, 256-token chunks) with every launch count set
    to 0 just before and read just after.  Returns (scheduler, outputs
    by id, wall s, launches, peak GiB)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ContinuousScheduler
    sched = ContinuousScheduler(eng, prefill_chunk=256)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    if hasattr(eng, "shard_launches"):
        eng.shard_launches = [{} for _ in eng.shards]
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    outs = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (sched, {o.request_id: o for o in outs}, wall,
            dict(ops.LAUNCHES), torch.cuda.max_memory_allocated() / 2**30)


def _dp_bf16(torch, card, p6):
    """(a) llama3.1-8b at full width on a (2, 1) mesh of two ``cuda:0``
    devices: phase 6's six requests at batch 4 over its 161 pages, each
    shard holding 2 rows and its half of the pool, one copy of the
    weights."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.data_parallel import DataParallelEngine
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models.api import init_params
    cfg = get_config("llama3.1-8b")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=0, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=1, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in SERVE_REQS]
    mesh = make_mesh((DP_SHARDS, 1), devices=["cuda:0"] * DP_SHARDS)
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=4,
                       max_len=SERVE_MAX_LEN, num_pages=SERVE_PAGES,
                       paged=True, zero_copy=True, prefix_cache=False,
                       mesh=mesh, device="cuda")
    if not isinstance(eng, DataParallelEngine) or eng.data_shards != 2:
        raise AssertionError(f"a (2, 1) mesh built {type(eng).__name__} "
                             f"with {eng.data_shards} shards")
    from repro_torch.train.optimizer import tree_leaves
    for sub in eng.shards:
        for mine, given in ((sub.params, params), (sub.dparams, dparams)):
            if any(a is not b for a, b in zip(tree_leaves(mine),
                                              tree_leaves(given))):
                raise AssertionError("shards on one card must share one "
                                     "copy of the weights")
    spans = _dp_timed(torch, eng)
    sched, outs, wall, launches, peak = _dp_serve(
        torch, eng, _serving_requests(prompts, SERVE_REQS))
    torch.cuda.synchronize()
    _dp_untime(eng)
    for i, (n, new) in enumerate(SERVE_REQS):
        o = outs[f"r{i}"]
        if (o.finish_reason != "length" or len(o.tokens) != new
                or o.tokens.min() < 0 or o.tokens.max() >= cfg.vocab_size):
            raise AssertionError(f"request r{i}: {o.finish_reason}, "
                                 f"{len(o.tokens)} tokens")
    st = sched.stats
    ps = eng.page_stats()
    al = eng._page_alloc
    caps = [al.shard_capacity(s) for s in range(DP_SHARDS)]
    hw = [ps[f"high_water_shard_{s}"] for s in range(DP_SHARDS)]
    if not st["page_stalls"] > 0:
        raise AssertionError("no admission stalled on a shard's pages")
    if ps["in_use"] or ps["draft_in_use"] or ps["pinned_pages"]:
        raise AssertionError(f"pages left after the run: {ps}")
    if any(not 0 < h <= c for h, c in zip(hw, caps)):
        raise AssertionError(f"a shard's high water {hw} is outside its "
                             f"capacity {caps}")
    layers = cfg.num_layers
    total = {k: 0 for k in LLAMA_KERNELS}
    per_shard = []
    for s, sub in enumerate(eng.shards):
        want = _implied_launches(sub.dispatch_keys, sub.prefill_dispatches,
                                 layers)
        got = {k: eng.shard_launches[s].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"shard {s} launches {got} != {want} "
                                 f"implied by its steps and chunks")
        if min(got.values()) <= 0:
            raise AssertionError(f"shard {s} did not launch every kernel "
                                 f"of the path: {got}")
        want_graphs = _prefill_graph_keys(sub) | set(sub.dispatch_keys)
        if set(sub._graphs) != want_graphs:
            raise AssertionError(f"shard {s} graphs "
                                 f"{sorted(map(str, sub._graphs))} != "
                                 f"{sorted(map(str, want_graphs))}")
        for k in total:
            total[k] += got[k]
        per_shard.append(got)
    got = {k: launches[k] for k in total}
    if got != total:
        raise AssertionError(f"launches {got} != the shards' sum {total}")
    shard_ms = []
    for s, sp in enumerate(spans):
        ms = [a.elapsed_time(b) for a, b in sp]
        shard_ms.append(dict(ticks=len(ms), median=float(np.median(ms)),
                             mean=float(np.mean(ms))))
    lat = np.array([o.latency_s for o in outs.values()])
    ntok = int(sum(len(o.tokens) for o in outs.values()))
    ticks = {c: (len(v), 1e3 * float(np.median(v)), 1e3 * float(np.mean(v)))
             for c, v in sched.tick_wall.items()}
    res = dict(tokens_per_s=ntok / wall, wall_s=wall,
               p50=float(np.percentile(lat, 50)),
               p95=float(np.percentile(lat, 95)), peak_gib=peak,
               page_stalls=int(st["page_stalls"]), ticks=ticks,
               shard_step_ms=shard_ms,
               graphs=[len(sub._graphs) for sub in eng.shards],
               capture_s=[sub.capture_s for sub in eng.shards],
               peak_pages_per_host=ps["peak_pages_per_host"],
               high_water=hw, capacity=caps, shard_launches=per_shard,
               launches=got)
    say(card, f"data-parallel serving llama3.1-8b [graphs] mesh (2, 1) on "
              f"cuda:0 twice, batch 4 (2 rows a shard), {SERVE_PAGES} pages "
              f"(shards {caps}), requests {[n for n, _ in SERVE_REQS]}: "
              f"tokens {ntok} wall_s {wall:.3f} tokens_per_s "
              f"{ntok / wall:.2f} latency_s p50 {res['p50']:.3f} p95 "
              f"{res['p95']:.3f} steps {int(st['steps'])} page_stalls "
              f"{res['page_stalls']} peak_mem_gib {peak:.2f}")
    say(card, f"data-parallel [graphs] per shard: step ms (CUDA events "
              f"around its launch: ticks, median, mean) "
              + "; ".join(f"shard {s} {m['ticks']}, {m['median']:.2f}, "
                          f"{m['mean']:.2f}" for s, m in enumerate(shard_ms))
              + f"; graphs {res['graphs']} capture_s "
              f"{[round(c, 3) for c in res['capture_s']]}; launches "
              f"{per_shard} (each == implied by the shard's steps and "
              f"chunks)")
    say(card, f"data-parallel [graphs] tick wall ms by class (ticks, "
              f"median, mean): " + ", ".join(
                  f"{c} {n}: {med:.2f}, {mean:.2f}"
                  for c, (n, med, mean) in sorted(ticks.items()))
              + f"; peak_pages_per_host {ps['peak_pages_per_host']} "
              f"high_water_shard {hw} of {caps}")
    if p6 is not None:
        same_req = sum(np.array_equal(outs[k].tokens, t)
                       for k, t in p6["toks"].items())
        eq = sum(int((outs[k].tokens == t).sum())
                 for k, t in p6["toks"].items())
        n = sum(len(t) for t in p6["toks"].values())
        res["phase6_equal_requests"] = int(same_req)
        res["phase6_equal_tokens"] = f"{eq}/{n}"
        say(card, f"data-parallel bf16 vs phase 6's unsharded serving: "
                  f"{same_req} of {len(SERVE_REQS)} requests equal, {eq} of "
                  f"{n} tokens (not asserted: bf16 GEMMs at 2 and 4 rows "
                  f"may round apart); phase 6: tokens_per_s "
                  f"{p6['tokens_per_s']:.2f} p50 {p6['p50']:.3f} p95 "
                  f"{p6['p95']:.3f} page_stalls "
                  f"{int(p6['stats']['page_stalls'])} ticks {p6['ticks']}")
    else:
        say(card, "data-parallel bf16: phase 6 did not run, no unsharded "
                  "tokens to compare")
    del eng, sched, params, dparams
    torch.cuda.empty_cache()
    return res


def _dp_fp32(torch, card):
    """(b) fp32 (TF32 off) at full width, ``DP_FP32_LAYERS`` layers: the
    same trace served sharded equals the unsharded engine token for
    token, each shard's high water within its range, a fork within a
    shard shares pages and one across shards raises; (c)
    ``ServingConfig(mesh_shape=(2, 1))`` on this one card serves
    unsharded, as the reference."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.data_parallel import DataParallelEngine
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models.api import init_params
    from repro_torch.serving import ServingConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config("llama3.1-8b").replace(num_layers=DP_FP32_LAYERS,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in DP_FP32_REQS]
    toks, engines = {}, {}
    for label, mesh in (("unsharded", None),
                        ("sharded", make_mesh((DP_SHARDS, 1),
                                              devices=["cuda:0"] * 2))):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=4,
                           max_len=DP_FP32_MAX_LEN, paged=True,
                           zero_copy=True, mesh=mesh, device="cuda")
        sched, outs, _, _, _ = _dp_serve(
            torch, eng, _serving_requests(prompts, DP_FP32_REQS))
        toks[label] = {k: o.tokens for k, o in outs.items()}
        modes = {k: int(v) for k, v in sched.stats.items()
                 if k.startswith("mode_rows_")}
        engines[label] = eng
    eng = engines["sharded"]
    if not isinstance(eng, DataParallelEngine):
        raise AssertionError("the (2, 1) mesh built no data-parallel engine")
    for k, t in toks["unsharded"].items():
        if not np.array_equal(toks["sharded"][k], t):
            raise AssertionError(f"fp32 {k}: sharded tokens differ from "
                                 f"the unsharded engine's:\n"
                                 f"{toks['sharded'][k]}\n{t}")
    if not (modes.get("mode_rows_refresh") and modes.get("mode_rows_partial")):
        raise AssertionError(f"(b) must run Refresh and Partial rows: {modes}")
    ps = eng.page_stats()
    al = eng._page_alloc
    hw = [ps[f"high_water_shard_{s}"] for s in range(DP_SHARDS)]
    caps = [al.shard_capacity(s) for s in range(DP_SHARDS)]
    if any(not 0 < h <= c for h, c in zip(hw, caps)):
        raise AssertionError(f"(b) high water {hw} outside {caps}")
    # forks: within shard 0 (rows 0 and 1) shared, across shards refused;
    # emptied first (a reclaim evicts LRU over both shards, as the
    # reference's, so the cached prefixes could leave shard 0 short)
    st = eng.empty_state()
    st, _ = eng.prefill_into_slot(st, 0, prompts[0][:700], max_new_tokens=8)
    free = al.free
    st = eng.fork_slot(st, 0, 1)
    if al.free != free or al.pages_of(1) != al.pages_of(0):
        raise AssertionError("a fork within a shard must share its pages")
    try:
        eng.fork_slot(st, 0, 2)
    except AssertionError as e:
        refused = "cross-shard fork" in str(e)
    else:
        refused = False
    if not refused:
        raise AssertionError("a fork across shards must raise")
    for slot in (0, 1):
        st = eng.reset_slot(st, slot)
    del engines, eng
    torch.cuda.empty_cache()
    secs_b = time.perf_counter() - t0
    say(card, f"data-parallel lossless llama3.1-8b x{DP_FP32_LAYERS} layers "
              f"fp32, graphs, paged zero-copy with prefix sharing, batch 4, "
              f"prompts {[n for n, _ in DP_FP32_REQS]}: mesh (2, 1) tokens "
              f"== unsharded engine's for every request (mode rows {modes}); "
              f"high_water_shard {hw} of {caps}; a fork within shard 0 "
              f"shares its pages, one across shards raises; {secs_b:.1f} s")
    # (c) a mesh this card count cannot fill serves unsharded
    t1 = time.perf_counter()
    srv = ServingEngine(cfg, spec, dcfg, params, dparams,
                        ServingConfig(batch=2, max_len=1024,
                                      paged_kv=True, zero_copy_partial=True,
                                      mesh_shape=(DP_SHARDS, 1)),
                        device="cuda")
    srv.submit(_serving_requests([prompts[0][:600]], ((600, 4),))[0])
    (out,) = srv.run()
    ceng = srv._continuous.engine
    n_cards = torch.cuda.device_count()
    want_shards = DP_SHARDS if n_cards >= DP_SHARDS else 1
    if ceng.data_shards != want_shards or len(out.tokens) != 4:
        raise AssertionError(f"mesh_shape (2, 1) on {n_cards} card(s): "
                             f"{ceng.data_shards} shards")
    say(card, f"data-parallel ServingConfig(mesh_shape=(2, 1)) on "
              f"{n_cards} card(s): served with {ceng.data_shards} data "
              f"shard(s) ({type(ceng).__name__}), as the reference; "
              f"{time.perf_counter() - t1:.1f} s")
    del srv, ceng, params, dparams
    torch.cuda.empty_cache()
    return dict(fp32_s=secs_b, high_water=hw, capacity=caps, modes=modes)


def phase_data_parallel(torch, card, p6=None):
    """Phase 20: the engine's ``mesh=`` as data-parallel serving.
    Returns (a)'s launches, per shard and in all, and the numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    a = _dp_bf16(torch, card, p6)
    t_a = time.perf_counter() - t_phase
    b = _dp_fp32(torch, card)
    total = time.perf_counter() - t_phase
    say(card, f"phase 20 (a) {t_a:.1f} s, (b, c) {total - t_a:.1f} s; "
              f"phase 20 took {total:.1f} s")
    return dict(launches=a.pop("launches"),
                shard_launches=a["shard_launches"], bf16=a, fp32=b,
                seconds=total)


# ---------------------------------------------------------------------------
# phase 21: tensor parallelism (the engine's mesh= over two model shards)
# ---------------------------------------------------------------------------

TP_SHARDS = 2
TP_HEADS = dict(h=16, hk=4, dh=128)     # llama3.1-8b's heads per model shard
# (b): fp32 at full width, cut to the depth that keeps it under 20 s
TP_FP32_LAYERS = 2
TP_FP32_PROMPT, TP_FP32_NEW = 4800, 32


def _tp_kernel_checks(torch, card, timer):
    """Phase 21 (c): K1-K4 at one model shard's heads of llama3.1-8b on
    two shards (H=16, Hk=4: rep 4 at Dh 128, a call form no earlier phase
    launches), block 128, bf16, over 8192 tokens: K1 Full T=61 and routed
    Partial NS=35 T=61, K2 a prefill chunk T=256 at qoff 7936, K3 a
    Refresh T=156 over 66 blocks, K4's paged form over the shard-stacked
    pool of both shards' 32 layers (one launch).  Each is held to its
    plain version (K4 bit for bit), timed beside its bound and SDPA (K4:
    ``torch.aminmax``).  Returns {kernel: {label: row}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2100)
    out = {k: {} for k in LLAMA_KERNELS}
    g = "H=16 Hk=4 Dh=128 (llama3.1-8b, one of 2 model shards)"
    for label, name, kw in (
            (f"K1 full T=61 ctx=8229 {g}", "sparse_verify_attention",
             dict(t=61, ctx=8229)),
            (f"K1 routed NS=35 T=61 {g}", "sparse_verify_attention",
             dict(t=61, ctx=8229, routed_ns=35)),
            (f"K2 prefill T=256 qoff=7936 {g}", "paged_prefill_attention",
             dict(t=256, ctx=8192, causal_qoff=7936))):
        res = {}
        _attn_check(torch, card, timer, gen, res, label, name, **kw,
                    **TP_HEADS)
        out[name][label] = res[name]
    label = f"K3 Refresh T=156 NB=66 {g} bf16"
    out["retrieval_score"][label] = _score_row(
        torch, card, timer, gen, label, 156, 66, torch.bfloat16, 16, 4, 128)
    k4, start, end, n_touch = K4_PAGED_SHAPES[0]
    row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16, k4,
                              start, end, n_touch, layers=64, hk=4, dh=128)
    out["block_summary"][f"K4 paged {k4} L=64 (2 shards x 32 layers) {g} "
                         f"bf16"] = dict(max_abs_err=0.0, timing="profiler",
                                         **row)
    torch.cuda.empty_cache()
    return out


class _LaunchShapes:
    """Record (kernel, H, Hk, Dh) of every K1-K4 wrapper call while
    installed (a graph's warm-up and capture run its body's Python, so
    the graph run's call forms are seen too)."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.seen = set()
        self.saved = {}
        for fn in ("block_attention", "retrieval_scores",
                   "paged_block_summaries"):
            orig = getattr(ops, fn)
            self.saved[fn] = orig

            def wrapped(*a, __orig=orig, __fn=fn, **kw):
                self.seen.add(self._form(__fn, a, kw))
                return __orig(*a, **kw)
            setattr(ops, fn, wrapped)

    @staticmethod
    def _form(fn, a, kw):
        if fn == "block_attention":
            q, k = a[0], a[1]
            name = ("paged_prefill_attention" if kw.get("q_offset")
                    is not None or (len(a) > 6 and a[6] is not None)
                    else "sparse_verify_attention")
            return (name, q.shape[2], k.shape[1], q.shape[3])
        if fn == "retrieval_scores":
            q, kx = a[0], a[1]
            return ("retrieval_score", q.shape[2], kx.shape[2], q.shape[3])
        pool = a[0]
        return ("block_summary", None, pool.shape[3], pool.shape[4])

    def remove(self):
        for fn, orig in self.saved.items():
            setattr(self.ops, fn, orig)


def _tp_collectives(torch, card, eng, st, steps: int = 1):
    """Eager steps of the graph engine (its graphs switched off for them)
    with ``tensor_parallel.all_reduce`` / ``all_gather`` under
    ``record_function``: the collectives' calls and device ms per step
    (on one card a sum is an add and a gather a concatenation), beside
    the step's busy time.  Returns (numbers, state)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.distributed import tensor_parallel as tpm
    saved = []
    for fn in ("all_reduce", "all_gather"):
        orig = getattr(tpm, fn)

        def wrapped(*a, __orig=orig, __fn=fn, **kw):
            with record_function(f"tp {__fn}"):
                return __orig(*a, **kw)
        saved.append((fn, orig))
        setattr(tpm, fn, wrapped)
    eng.cuda_graphs = False
    try:
        modes = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                st, so = eng.step(st, eng.next_mode())
                modes.append(so.mode)
            torch.cuda.synchronize()
    finally:
        eng.cuda_graphs = True
        for fn, orig in saved:
            setattr(tpm, fn, orig)
    labels = {"tp all_reduce", "tp all_gather"}
    busy, _ = _device_busy(prof, skip=labels)
    cpu = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CPU]
    out = {"modes": modes, "busy_ms_step": busy / steps}
    for lb in sorted(labels):
        evs = [e for e in cpu if e.name == lb]
        ks = [k for e in evs for k in _range_kernels(e)]
        out[f"{lb} calls/step"] = len(evs) / steps
        out[f"{lb} ms/step"] = sum(d for _, d in ks) / 1e3 / steps
    out["collectives ms/step"] = (out["tp all_gather ms/step"]
                                  + out["tp all_reduce ms/step"])
    say(card, f"tensor-parallel collectives, eager steps {modes} (graphs "
              f"off for them): "
              + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in out.items() if k != "modes"))
    return out, st


def _tp_forced_full(torch, card, eng, st):
    """Two forced Full steps (with graphs), so that the run holds Full,
    Refresh and Partial steps: the first captures the Full variant's
    graph, the second runs under the profiler.  Returns (busy ms,
    state)."""
    from torch.profiler import ProfilerActivity, profile
    st, _ = eng.step(st, "full")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, so = eng.step(st, "full")
        torch.cuda.synchronize()
    if so.mode != "full":
        raise AssertionError(f"a forced Full step ran {so.mode}")
    busy, _ = _device_busy(prof)
    say(card, f"tensor-parallel forced Full step [graphs, its graph "
              f"captured by the step before]: device busy_ms {busy:.2f}")
    return busy, st


def _tp_generate(torch, card, p3):
    """(a) llama3.1-8b at full width, all 32 layers, bf16, on a (1, 2) mesh
    of two ``cuda:0`` model shards: paged zero-copy ``generate`` over phase
    3's 8192-token prompt with graphs.  Launches held to twice phase 3's
    per layer (each at Hk 4), graphs and final summaries as phase 3's, a
    profiled window, a forced Full step and the collectives' device time;
    bf16 tokens against phase 3's reported."""
    import numpy as np
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import tree_leaves
    cfg, spec, dcfg, params, dparams, prompt = _full_width(
        torch, card, "llama3.1-8b")
    prompt_len = prompt.shape[1]
    max_len = request_token_need(prompt_len, NEW_TOKENS, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    mesh = make_mesh((1, TP_SHARDS), devices=["cuda:0"] * TP_SHARDS)
    t0 = time.perf_counter()
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, device="cuda", mesh=mesh, paged=True,
                       zero_copy=True)
    tp = eng.tp
    if not (tp and tp.m == 2 and tp.attn_split and tp.mlp_split
            and tp.embed_split and tp.head_split and eng.kv_shards == 2):
        raise AssertionError("a (1, 2) mesh must split llama3.1-8b's "
                             "attention, MLP, embed and head")
    # every shard piece is a view of the given weights: no copy
    given = {t.untyped_storage().data_ptr()
             for t in tree_leaves(params) + tree_leaves(dparams)}
    pieces = [t for split in (tp, tp.draft) for sh in split.shards
              for t in tree_leaves(sh.params)]
    if any(t.untyped_storage().data_ptr() not in given for t in pieces):
        raise AssertionError("a model shard holds a copy of a weight")
    strided = sum(not t.is_contiguous() for t in pieces)
    shapes = _LaunchShapes()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    try:
        toks, stats = eng.generate(prompt, NEW_TOKENS)
    finally:
        shapes.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    label = "llama3.1-8b tp (1, 2) graphs"
    memory_line(torch, card, label, eng, params, dparams, peak)
    decode_s = wall - stats["prefill_s"]
    say(card, f"generate [{label}] (32 layers, bf16, random weights, two "
              f"model shards on cuda:0, weight pieces are views: {strided} "
              f"of {len(pieces)} strided) prompt {prompt_len} new "
              f"{NEW_TOKENS}: modes {stats['modes']} steps {stats['steps']} "
              f"mean_accept {stats['mean_accept']:.4f} wall_s {wall:.3f} "
              f"(prefill_s {stats['prefill_s']:.3f} decode_s "
              f"{decode_s:.3f}, ms/step "
              f"{decode_s * 1e3 / max(stats['steps'], 1):.2f}) tokens_per_s "
              f"{NEW_TOKENS / wall:.2f} peak_mem_gib {peak:.2f} capture_s "
              f"{eng.capture_s:.3f} graphs {sorted(map(str, eng._graphs))} "
              f"launches {launches}")
    if not (stats["modes"].get("refresh") and stats["modes"].get("partial")):
        raise AssertionError(f"Refresh and Partial steps must both run: "
                             f"{stats['modes']}")
    layers, chunks = cfg.num_layers, -(-prompt_len // 256)
    refresh = stats["modes"].get("refresh", 0)
    commits = refresh + stats["modes"].get("full", 0)
    # K1-K3 once per layer and shard; K4 once per chunk and commit over
    # the shard-stacked pool (both shards' layers in one launch)
    want = {"sparse_verify_attention": 2 * layers * stats["steps"],
            "paged_prefill_attention": 2 * layers * chunks,
            "retrieval_score": 2 * layers * refresh,
            "block_summary": chunks + commits}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"tp launches {got} != {want} implied by "
                             f"{stats['steps']} steps and {chunks} chunks")
    forms = sorted(shapes.seen, key=str)
    bad = [f for f in forms if f[2] != 4 or (f[1] not in (None, 16))]
    if bad or {f[0] for f in forms} != set(LLAMA_KERNELS):
        raise AssertionError(f"tp call forms {forms}: every K1-K4 launch "
                             f"must be at H 16 / Hk 4")
    per_shard = {k: (v // 2 if k != "block_summary" else v)
                 for k, v in got.items()}
    say(card, f"launches [{label}] {got} = implied by {stats['steps']} "
              f"steps and {chunks} prefill chunks: per shard K1-K3 "
              f"{ {k: v for k, v in per_shard.items() if k != 'block_summary'} } "
              f"(2 x phase 3's per layer), K4 {got['block_summary']} "
              f"({chunks} chunks + {commits} commits, each one launch over "
              f"both shards' 64 stacked layers); call forms (kernel, H, Hk, "
              f"Dh) {forms}")
    want_graphs = {("prefill", 256), (True, False, True, False, False),
                   (False, True, False, False, False)}
    if set(eng._graphs) != want_graphs:
        raise AssertionError(f"tp graphs {sorted(map(str, eng._graphs))}")
    _check_final_summaries(torch, card, eng.final_state.cache)
    if toks.shape != (1, NEW_TOKENS) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"tokens out of range: {toks}")
    eng.final_state = None

    def after(st):
        full_ms, st = _tp_forced_full(torch, card, eng, st)
        coll, st = _tp_collectives(torch, card, eng, st)
        return dict(full_busy_ms=full_ms, **coll)
    prof = profile_steps(torch, card, eng, prompt, label=label,
                         steps=PROFILE_STEPS,
                         kernel="retrieval_score_kernel", refresh=True,
                         prefill=False, after=after)
    res = dict(toks=toks, launches=launches, per_shard=per_shard,
               wall_s=wall, tokens_per_s=NEW_TOKENS / wall,
               prefill_s=stats["prefill_s"], peak_gib=peak,
               capture_s=eng.capture_s, steps=stats["steps"],
               modes=stats["modes"], strided_pieces=strided,
               forms=[list(f) for f in forms], **prof)
    if p3 is not None:
        eq = int((toks == p3["toks"]).sum())
        res["phase3_equal_tokens"] = f"{eq}/{toks.size}"
        say(card, f"tensor-parallel bf16 vs phase 3: {eq} of {toks.size} "
                  f"tokens equal (not asserted: the split changes the bf16 "
                  f"sums' order); device busy ms/step {prof['busy_ms_step']:.2f} "
                  f"vs phase 3's {p3['busy_ms_step']:.2f} "
                  f"({prof['busy_ms_step'] / p3['busy_ms_step']:.3f}x); "
                  f"host launch calls/step {prof['host_launch_calls_step']:.1f} "
                  f"vs {p3['host_launch_calls_step']:.1f}; peak GiB "
                  f"{peak:.2f} vs {p3['peak_gib']:.2f}; tokens/s "
                  f"{NEW_TOKENS / wall:.2f} vs {p3['tokens_per_s']:.2f}")
    else:
        say(card, "tensor-parallel bf16: phase 3 did not run, no unsharded "
                  "numbers beside it")
    say(card, f"phase 21 (a) took {time.perf_counter() - t0:.1f} s")
    del eng, params, dparams
    torch.cuda.empty_cache()
    return res


def _tp_fp32(torch, card):
    """(b) fp32 (TF32 off) at full width, ``TP_FP32_LAYERS`` layers:
    ``generate`` on a (1, 2) mesh equals the unsharded engine's tokens
    (its ``pkv_blocks`` agreement reported), and a (2, 2) mesh of four
    ``cuda:0`` shards (two data shards, each a two-shard tensor-parallel
    engine) serves phase 20's fp32 trace with the unsharded engine's
    tokens."""
    import numpy as np
    from repro_torch.configs import get_config, SpecPVConfig, DraftConfig
    from repro_torch.core.data_parallel import DataParallelEngine
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.distributed.tensor_parallel import merge_heads
    from repro_torch.models.api import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = get_config("llama3.1-8b").replace(num_layers=TP_FP32_LAYERS,
                                            dtype="float32",
                                            param_dtype="float32")
    spec = SpecPVConfig(use_pallas=True, score_mode="paper", reduction="mean")
    dcfg = DraftConfig()
    params = init_params(cfg, seed=2, device="cuda")
    dparams = init_draft_params(cfg, dcfg, seed=3, device="cuda")
    prompt = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (1, TP_FP32_PROMPT)).astype(np.int64)
    max_len = request_token_need(TP_FP32_PROMPT, TP_FP32_NEW,
                                 spec.buffer_size, dcfg.tree_depth + 1)
    gen = {}
    for label, mesh in (("unsharded", None),
                        ("(1, 2)", make_mesh((1, 2),
                                             devices=["cuda:0"] * 2))):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                           max_len=max_len, device="cuda", mesh=mesh,
                           paged=True, zero_copy=True)
        toks, stats = eng.generate(prompt, TP_FP32_NEW)
        gen[label] = (toks, stats["modes"], eng.final_state.pkv_blocks,
                      eng.kv_shards)
        del eng
    (ut, um, ub, _), (st_, sm, sb, kvs) = gen["unsharded"], gen["(1, 2)"]
    if not np.array_equal(st_, ut) or sm != um:
        raise AssertionError(f"fp32 (1, 2) generate differs from the "
                             f"unsharded engine: {st_} {sm}\n{ut} {um}")
    if not (um.get("refresh") and um.get("partial")):
        raise AssertionError(f"(b) must run Refresh and Partial: {um}")
    same_blocks = float((merge_heads(sb, kvs, 1, 2) == ub).float().mean())
    say(card, f"tensor-parallel lossless llama3.1-8b x{TP_FP32_LAYERS} "
              f"layers fp32, graphs, paged zero-copy, prompt "
              f"{TP_FP32_PROMPT} new {TP_FP32_NEW}: (1, 2) tokens == "
              f"unsharded engine's (modes {um}); final pkv_blocks (the "
              f"shards' heads side by side) equal to the unsharded "
              f"engine's: share {same_blocks:.4f} (reported)")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n, _ in DP_FP32_REQS]
    toks = {}
    for label, mesh in (("unsharded", None),
                        ("(2, 2)", make_mesh((2, 2),
                                             devices=["cuda:0"] * 4))):
        eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=4,
                           max_len=DP_FP32_MAX_LEN, paged=True,
                           zero_copy=True, mesh=mesh, device="cuda")
        sched, outs, _, _, _ = _dp_serve(
            torch, eng, _serving_requests(prompts, DP_FP32_REQS))
        toks[label] = {k: o.tokens for k, o in outs.items()}
        modes = {k: int(v) for k, v in sched.stats.items()
                 if k.startswith("mode_rows_")}
        if mesh is not None and not (
                isinstance(eng, DataParallelEngine)
                and all(sub.tp is not None and sub.tp.m == 2
                        for sub in eng.shards)):
            raise AssertionError("a (2, 2) mesh must build two data shards "
                                 "of two model shards each")
        del eng, sched
    for k, t in toks["unsharded"].items():
        if not np.array_equal(toks["(2, 2)"][k], t):
            raise AssertionError(f"fp32 {k}: (2, 2) tokens differ from the "
                                 f"unsharded engine's:\n"
                                 f"{toks['(2, 2)'][k]}\n{t}")
    if not (modes.get("mode_rows_refresh") and modes.get("mode_rows_partial")):
        raise AssertionError(f"(b) serving must run Refresh and Partial "
                             f"rows: {modes}")
    secs = time.perf_counter() - t0
    say(card, f"tensor-parallel lossless serving, mesh (2, 2) on cuda:0 four "
              f"times, batch 4, prompts {[n for n, _ in DP_FP32_REQS]}: "
              f"tokens == unsharded engine's for every request (mode rows "
              f"{modes}); (b) took {secs:.1f} s")
    del params, dparams
    torch.cuda.empty_cache()
    return dict(seconds=secs, modes=modes, pkv_blocks_equal=same_blocks)


def phase_tensor_parallel(torch, card, timer, p3=None):
    """Phase 21: the engine's ``mesh=`` as tensor parallelism.  Returns
    (a)'s launches and numbers, (b)'s and (c)'s call forms."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shapes = _tp_kernel_checks(torch, card, timer)
    t_c = time.perf_counter() - t_phase
    a = _tp_generate(torch, card, p3)
    t_a = time.perf_counter() - t_phase - t_c
    gc.collect()
    torch.cuda.empty_cache()
    b = _tp_fp32(torch, card)
    total = time.perf_counter() - t_phase
    say(card, f"phase 21 (c) {t_c:.1f} s, (a) {t_a:.1f} s, (b) "
              f"{b['seconds']:.1f} s; phase 21 took {total:.1f} s")
    a.pop("toks")
    return dict(launches=a.pop("launches"), shapes=shapes, bf16=a, fp32=b,
                seconds=total)


# ---------------------------------------------------------------------------
# phase 22: every model family under a mesh (tensor parallelism of the
# state and cross-attention targets, their data-parallel serving)
# ---------------------------------------------------------------------------

FAM_NEW = 32                    # (a): tokens per target
FAM_VLM_LAYERS = 10             # (a): the VLM's two (attn x4, cross) blocks
FAM_SHARD_HEADS = (((6, 6, 64), 24, AUDIO), ((32, 4, 128), 16, VLM))
# (b): fp32 at full width; Griffin keeps one (rec, rec, attn) superblock,
# the VLM one (attn, cross) pair; the attention prompts pass the budget
FAM_FP32 = (("rwkv6-3b", 2, 512), (GRIFFIN, 3, 2304), (AUDIO, 2, 4600),
            (VLM, 2, 4600))
FAM_FP32_NEW = 24
FAM_DP_REQS = (512, 700, 300, 512)      # (b): the (2, 1) wave's prompts
FAM_DP_XATTN = (4600, 1500)             # (b): one slot a data shard


def _fam_kernel_checks(torch, card, timer):
    """Phase 22 (c): K5 at one model shard's heads of rwkv6-3b (H 20, dk
    64, fp32: the chain verify T=6, a prefill chunk T=256, an advance of
    2 valid of T=6), and K1-K4 at one model shard's heads of
    whisper-small (H=Hk=6, Dh 64) and of the VLM (H=32, Hk=4, Dh 128),
    block 128, bf16, over 8192 tokens (K1 Full T=61 and routed Partial
    NS=35 T=61, K2 T=256 at qoff 7936, K3 a Refresh T=156 over 66 blocks,
    K4's paged form over both shards' stacked attention layers).  Each is
    held to its plain version (K4 bit for bit) and timed beside its bound
    and SDPA.  Returns {kernel: {label: row}}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2200)
    out = {k: {} for k in LLAMA_KERNELS + RWKV_KERNELS}
    h, dk = 20, 64
    for t, nv, update in ((6, 6, False), (256, 256, True), (6, 2, True)):
        label = (f"K5 {WKV_PATH_SHAPES[(t, update)]} H=20 (rwkv6-3b, one "
                 f"of 2 model shards)")
        r, k, v, w, u, s0 = _wkv_inputs(torch, gen, 1, t, h=h)
        n_valid = torch.tensor([nv], dtype=torch.int32, device="cuda")
        y, s = ops.wkv(r, k, v, w, u, s0, n_valid, update=update)
        want_y, want_s = ref.wkv_batched(r, k, v, w, u, s0, n_valid)
        torch.cuda.synchronize()
        pairs = [("y", y, want_y)] + ([("s", s, want_s)] if update else [])
        rel = max(_close(f"{label} {nm}", g, wv) for nm, g, wv in pairs)
        err = max((g - wv).abs().max().item() for _, g, wv in pairs)
        before = ops.launch_counts()
        ms = timer.kernel_ms(
            lambda: ops.wkv(r, k, v, w, u, s0, n_valid, update=update),
            "wkv_kernel")
        ops.set_launch_counts(before)
        plain_timer = timer if t <= 6 else timer.wall
        plain_ms = plain_timer(
            lambda: ref.wkv_batched(r, k, v, w, u, s0, n_valid), iters=3,
            warmup=1)
        nbytes = (5 * t * h * dk * 4 + h * dk * 4 + 4
                  + (2 if update else 1) * h * dk * dk * 4)
        flops = 5 * t * h * dk * dk + 2 * nv * h * dk * dk
        bound, by = _bound_ms(nbytes, flops, PEAK_FP32_S)
        say(card, f"kernel {label} ({nv} valid): max_abs_err {err:.3e} "
                  f"max_rel_err {rel:.3e} (tol {TOL_KERNEL}) ms {ms:.4f} "
                  f"(profiler) plain_ms {plain_ms:.4f} bound_us "
                  f"{bound * 1e3:.3f} ({by}) library_ms none")
        out["wkv"][label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=None)
    for (h, hk, dh), layers, tag in FAM_SHARD_HEADS:
        g = f"H={h} Hk={hk} Dh={dh} ({tag}, one of 2 model shards)"
        kw = dict(h=h, hk=hk, dh=dh)
        for label, name, case in (
                (f"K1 full T=61 ctx=8229 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229)),
                (f"K1 routed NS=35 T=61 {g}", "sparse_verify_attention",
                 dict(t=61, ctx=8229, routed_ns=35)),
                (f"K2 prefill T=256 qoff=7936 {g}",
                 "paged_prefill_attention",
                 dict(t=256, ctx=8192, causal_qoff=7936))):
            res = {}
            _attn_check(torch, card, timer, gen, res, label, name, **case,
                        **kw)
            out[name][label] = res[name]
        label = f"K3 Refresh T=156 NB=66 {g} bf16"
        out["retrieval_score"][label] = _score_row(
            torch, card, timer, gen, label, 156, 66, torch.bfloat16, h, hk,
            dh)
        k4, start, end, n_touch = K4_PAGED_SHAPES[0]
        row = _paged_summary_case(torch, card, timer, gen, torch.bfloat16,
                                  k4, start, end, n_touch, layers=layers,
                                  hk=hk, dh=dh)
        out["block_summary"][f"K4 paged {k4} L={layers} (2 shards x "
                             f"{layers // 2} layers) {g} bf16"] = dict(
            max_abs_err=0.0, timing="profiler", **row)
        torch.cuda.empty_cache()
    return out


def _fam_model(torch, card, name):
    """(a)'s weights: each target's phase's own (the same seeds, the same
    prompt), the VLM at ``FAM_VLM_LAYERS``.  Returns (cfg, spec, dcfg,
    params, dparams, prompt, extra)."""
    from repro_torch.configs import SpecPVConfig
    if name == "rwkv6-3b":          # phase 5's
        cfg, _, dcfg, params, dparams, prompt = _full_width(
            torch, card, name)
        return cfg, SpecPVConfig(), dcfg, params, dparams, prompt, None
    if name == GRIFFIN:             # phase 16's
        cfg, spec, dcfg, params, dparams, prompt = _full_width(
            torch, card, name, prompt_len=GRIFFIN_PROMPT)
        return cfg, spec, dcfg, params, dparams, prompt, None
    return _xattn_model(torch, card, name,
                        layers=FAM_VLM_LAYERS if name == VLM else None)


def _fam_run(torch, card, name, model, mesh):
    """One target's ``generate`` of ``FAM_NEW`` tokens with graphs, over
    ``mesh`` (None: unsharded): launches, call forms, peak, a profiled
    decode window and, split, the collectives' device time.  The split's
    launches are held to twice the unsharded per-layer counts (K5 at H
    20; K1-K3 at the shard's heads; K4 once per chunk and commit over
    both shards' layers), its graphs to one per step variant.  Returns
    the numbers."""
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import tree_leaves
    cfg, spec, dcfg, params, dparams, prompt, extra = model
    state = not cfg.is_attention_arch
    prompt_len = prompt.shape[1]
    max_len = request_token_need(prompt_len, FAM_NEW, spec.buffer_size,
                                 dcfg.tree_depth + 1)
    layout = (dict(paged=False) if state
              else dict(paged=True, zero_copy=True, prefix_cache=False))
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                       max_len=max_len, device="cuda", mesh=mesh, **layout)
    label = f"{name} {'tp (1, 2)' if mesh is not None else 'unsharded'}"
    strided = 0
    if mesh is not None:
        tp = eng.tp
        flags = {k: getattr(tp, k) for k in (
            "attn_split", "mlp_split", "tmix_split", "cmix_split",
            "rec_split", "embed_split", "head_split")}
        want = {"rwkv6-3b": ("tmix_split", "cmix_split", "embed_split",
                             "head_split"),
                GRIFFIN: ("rec_split", "mlp_split", "embed_split"),
                AUDIO: ("attn_split", "mlp_split", "embed_split"),
                VLM: ("attn_split", "mlp_split", "embed_split",
                      "head_split")}[name]
        if sorted(k for k, v in flags.items() if v) != sorted(want) \
                or eng.kv_shards != 2:
            raise AssertionError(f"{label}: split {flags}, kv_shards "
                                 f"{eng.kv_shards}")
        given = {t.untyped_storage().data_ptr()
                 for t in tree_leaves(params) + tree_leaves(dparams)}
        pieces = [t for split in (tp, tp.draft) for sh in split.shards
                  for t in tree_leaves(sh.params)]
        if any(t.untyped_storage().data_ptr() not in given for t in pieces):
            raise AssertionError(f"{label}: a model shard holds a copy of a "
                                 f"weight")
        strided = sum(not t.is_contiguous() for t in pieces)
    shapes = _LaunchShapes()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        toks, stats = eng.generate(prompt, FAM_NEW, extra=extra)
    finally:
        shapes.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    heads = dict(ops.WKV_HEADS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    memory_line(torch, card, label, eng, params, dparams, peak)
    steps = stats["steps"]
    say(card, f"generate [{label}] ({cfg.num_layers} layers, bf16, random "
              f"weights{', extra' if extra else ''}, graphs) prompt "
              f"{prompt_len} new {FAM_NEW}: modes {stats['modes']} steps "
              f"{steps} wall_s {wall:.3f} (prefill_s {stats['prefill_s']:.3f})"
              f" peak_mem_gib {peak:.2f} graphs "
              f"{sorted(map(str, eng._graphs))} launches {launches} K5 by H "
              f"{heads} strided pieces {strided}")
    m = 2 if mesh is not None else 1
    chunks = -(-prompt_len // 256)
    if state:
        want = {k: 0 for k in ops.KERNELS}
        if cfg.arch_type == "ssm":
            want["wkv"] = m * cfg.num_layers * (chunks + 2 * steps)
        want_heads = ({cfg.num_heads // m: want["wkv"]} if want["wkv"]
                      else {})
        if stats["modes"] != {"state": steps} or launches != want \
                or heads != want_heads:
            raise AssertionError(f"{label}: modes {stats['modes']}, "
                                 f"launches {launches} (want {want}), K5 by "
                                 f"H {heads} (want {want_heads})")
        want_graphs = {("prefill", 256), "state"}
    else:
        la = eng.l_attn
        refresh = stats["modes"].get("refresh", 0)
        commits = refresh + stats["modes"].get("full", 0)
        want = {"sparse_verify_attention": m * la * steps,
                "paged_prefill_attention": m * la * chunks,
                "retrieval_score": m * la * refresh,
                "block_summary": chunks + commits}
        got = {k: launches[k] for k in want}
        forms = {f[1:] for f in shapes.seen if f[0] != "block_summary"}
        want_forms = {(cfg.num_heads // m, cfg.num_kv_heads // m,
                       cfg.head_dim_)}
        if got != want or not (refresh and stats["modes"].get("partial")) \
                or forms != want_forms:
            raise AssertionError(f"{label}: launches {got} != {want}, modes "
                                 f"{stats['modes']}, call forms {forms}")
        want_graphs = {("prefill", 256), (True, False, True, False, False),
                       (False, True, False, False, False)}
    if set(eng._graphs) != want_graphs:
        raise AssertionError(f"{label}: graphs "
                             f"{sorted(map(str, eng._graphs))}")
    if toks.shape != (1, FAM_NEW) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens out of range: {toks}")
    eng.final_state = None

    def after(st):
        if mesh is None:
            return {}
        coll, _ = _tp_collectives(torch, card, eng, st)
        return coll
    prof = profile_steps(torch, card, eng, prompt, label=label,
                         steps=PROFILE_STEPS, prefill=False, extra=extra,
                         after=after)
    calls = prof["host_launch_calls_step"]
    if calls != (2 if state else 3):
        raise AssertionError(f"{label}: {calls} host launch calls per step "
                             f"(one graph replay and its copies)")
    coll = prof.pop("after") or {}
    res = dict(toks=toks, launches=launches, wkv_heads=heads,
               forms=sorted(map(list, shapes.seen), key=str), steps=steps,
               modes=stats["modes"], wall_s=wall, peak_gib=peak,
               prefill_s=stats["prefill_s"], layers=cfg.num_layers,
               strided_pieces=strided,
               collectives_ms_step=coll.get("collectives ms/step", 0.0),
               collective_calls_step=(coll.get("tp all_reduce calls/step", 0)
                                      + coll.get("tp all_gather calls/step",
                                                 0)),
               **{k: prof[k] for k in (
                   "busy_ms_step", "device_launches_step",
                   "host_launch_calls_step", "idle_share", "wall_ms_step")})
    del eng
    torch.cuda.empty_cache()
    return res


def _fam_generate(torch, card, base):
    """(a) each family at full width on a (1, 2) mesh of two ``cuda:0``
    model shards (the VLM at ``FAM_VLM_LAYERS``, beside its own unsharded
    run there), beside the unsharded phase's numbers from the same call
    (``base``: phases 5, 16 and 17).  Returns {name: numbers}."""
    import gc
    import numpy as np
    from repro_torch.distributed.sharding import make_mesh
    mesh = make_mesh((1, 2), devices=["cuda:0"] * 2)
    out = {}
    for name in ("rwkv6-3b", GRIFFIN, AUDIO, VLM):
        t0 = time.perf_counter()
        model = _fam_model(torch, card, name)
        ref = base.get(name)
        if name == VLM:
            ref = _fam_run(torch, card, name, model, None)
        res = _fam_run(torch, card, name, model, mesh)
        cfg = model[0]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if ref:
            n = min(FAM_NEW, np.asarray(ref["toks"]).size)
            eq = int(np.sum(np.asarray(res["toks"]).reshape(-1)[:n]
                            == np.asarray(ref["toks"]).reshape(-1)[:n]))
            res["unsharded"] = {k: ref.get(k) for k in (
                "busy_ms_step", "device_launches_step",
                "host_launch_calls_step", "peak_gib", "layers")}
            res["equal_tokens"] = f"{eq}/{n}"
            say(card, f"family tp [{name}] ({cfg.num_layers} layers) vs "
                      f"unsharded ({ref.get('source', 'same phase')}): bf16 "
                      f"tokens equal {eq} of {n} (reported, not asserted: "
                      f"the split changes the bf16 sums' order); device "
                      f"busy ms/step {res['busy_ms_step']:.2f} vs "
                      f"{ref['busy_ms_step']:.2f}; device launches/step "
                      f"{res['device_launches_step']:.1f} vs "
                      f"{ref['device_launches_step']:.1f}; host launch "
                      f"calls/step {res['host_launch_calls_step']:.1f} vs "
                      f"{ref['host_launch_calls_step']:.1f}; collectives "
                      f"{res['collectives_ms_step']:.3f} ms/step in "
                      f"{res['collective_calls_step']:.0f} calls; peak GiB "
                      f"{res['peak_gib']:.2f} vs {ref['peak_gib']:.2f}")
        else:
            say(card, f"family tp [{name}]: its unsharded phase did not run, "
                      f"no numbers beside it")
        res["seconds"] = time.perf_counter() - t0
        res["toks"] = res["toks"][0].tolist()
        out[name] = res
    return out


def _fam_fp32(torch, card):
    """(b) fp32 (TF32 off) at full width and 2 layers (Griffin 3): each
    family's ``generate`` on a (1, 2) mesh equals the unsharded engine's
    tokens; on a (2, 1) mesh of two ``cuda:0`` data shards, rwkv6-3b's
    wave serving and whisper-small's slot serving with per-request
    ``extra`` give each request's solo ``generate``.  Returns the
    numbers."""
    import numpy as np
    from repro_torch.configs import DraftConfig, SpecPVConfig, get_config
    from repro_torch.core.data_parallel import DataParallelEngine
    from repro_torch.core.draft import init_draft_params
    from repro_torch.core.engine import SpecPVEngine, request_token_need
    from repro_torch.distributed.sharding import DeviceMesh, make_mesh
    from repro_torch.models import api
    from repro_torch.serving import Request, ServingConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dcfg = DraftConfig()
    out = {}
    models = {}
    for name, layers, plen in FAM_FP32:
        cfg = get_config(name).replace(num_layers=layers, dtype="float32",
                                       param_dtype="float32")
        if cfg.arch_type == "vlm":
            cfg = cfg.replace(cross_attn_every=2)
        spec = (SpecPVConfig(use_pallas=True, score_mode="paper",
                             reduction="mean") if cfg.is_attention_arch
                else SpecPVConfig())
        params = api.init_params(cfg, seed=4, device="cuda")
        _set_gates(torch, params, 22)
        dparams = init_draft_params(cfg, dcfg, seed=5, device="cuda")
        prompt = np.random.default_rng(22).integers(
            0, cfg.vocab_size, (1, plen)).astype(np.int64)
        extra = api.extra_inputs_for(cfg, 1, seed=23, device="cuda") or None
        max_len = request_token_need(plen, FAM_FP32_NEW, spec.buffer_size,
                                     dcfg.tree_depth + 1)
        layout = (dict(paged=False) if not cfg.is_attention_arch
                  else dict(paged=True, zero_copy=True, prefix_cache=False))
        got = {}
        for label, mesh in (("unsharded", None),
                            ("(1, 2)", make_mesh((1, 2),
                                                 devices=["cuda:0"] * 2))):
            eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                               max_len=max_len, device="cuda", mesh=mesh,
                               **layout)
            got[label] = eng.generate(prompt, FAM_FP32_NEW, extra=extra)
            del eng
        (ut, us), (tt, ts) = got["unsharded"], got["(1, 2)"]
        if not np.array_equal(tt, ut) or ts["modes"] != us["modes"]:
            raise AssertionError(f"fp32 {name}: (1, 2) tokens differ from "
                                 f"the unsharded engine's:\n{tt} "
                                 f"{ts['modes']}\n{ut} {us['modes']}")
        out[name] = dict(layers=layers, prompt=plen, modes=us["modes"])
        say(card, f"family lossless {name} x{layers} layers fp32, graphs, "
                  f"prompt {plen} new {FAM_FP32_NEW}: (1, 2) tokens == "
                  f"unsharded engine's (modes {us['modes']})")
        if name in ("rwkv6-3b", AUDIO):
            models[name] = (cfg, spec, params, dparams)
        else:
            del params, dparams
        torch.cuda.empty_cache()
    rng = np.random.default_rng(24)
    dp_mesh = DeviceMesh((2, 1), devices=["cuda:0"] * 2)
    # rwkv6-3b: the wave path's engine of a (2, 1) mesh
    cfg, spec, params, dparams = models.pop("rwkv6-3b")
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64)
               for n in FAM_DP_REQS]
    srv = ServingEngine(cfg, spec, dcfg, params, dparams, ServingConfig(
        batch=2, max_len=1024, scheduler="wave"), device="cuda")
    srv._mesh = lambda: dp_mesh         # two data shards on the one card
    for i, p in enumerate(prompts):
        srv.submit(Request(request_id=f"r{i}", prompt=p,
                           max_new_tokens=FAM_FP32_NEW, arrival_s=0.0))
    srv.run()
    eng = srv._engines[(2, False)]
    if not (isinstance(eng, DataParallelEngine) and eng.data_shards == 2
            and all(sub.dispatches for sub in eng.shards)):
        raise AssertionError("the wave path must serve on two data shards")
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=1024, device="cuda", paged=False)
    for i, p in enumerate(prompts):
        want, _ = solo.generate(p[None], FAM_FP32_NEW)
        if not np.array_equal(srv.outputs[f"r{i}"].tokens, want[0]):
            raise AssertionError(f"fp32 rwkv6-3b wave r{i} on (2, 1) differs "
                                 f"from solo generate")
    say(card, f"family data-parallel rwkv6-3b x2 fp32: wave serving of "
              f"{len(prompts)} requests (prompts {list(FAM_DP_REQS)}) on a "
              f"(2, 1) mesh == solo generate for every request; waves "
              f"{int(srv.stats['waves'])}")
    del srv, eng, solo, params, dparams
    # whisper-small: slot serving with per-request extra on (2, 1)
    cfg, spec, params, dparams = models.pop(AUDIO)
    reqs = [(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int64),
             api.extra_inputs_for(cfg, 1, seed=40 + i, device="cuda"))
            for i, n in enumerate(FAM_DP_XATTN)]
    nreq = len(reqs)
    max_len = request_token_need(max(FAM_DP_XATTN), FAM_FP32_NEW,
                                 spec.buffer_size, dcfg.tree_depth + 1)
    # every row's whole request on its shard, the null page beside it
    pages = nreq * (-(-max_len // spec.block_size) + 2) + 1
    eng = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=nreq,
                       max_len=max_len, device="cuda", paged=True,
                       zero_copy=True, prefix_cache=False, mesh=dp_mesh,
                       num_pages=pages)
    if not isinstance(eng, DataParallelEngine):
        raise AssertionError("a (2, 1) mesh must build two data shards")
    st = eng.empty_state()
    toks = {i: [] for i in range(nreq)}
    for i, (p, ex) in enumerate(reqs):
        st, first = eng.prefill_into_slot(st, i, p, extra=ex,
                                          max_new_tokens=FAM_FP32_NEW)
        toks[i].append(first)
    while min(len(v) for v in toks.values()) < FAM_FP32_NEW:
        rows = np.asarray([len(toks[i]) < FAM_FP32_NEW
                           for i in range(nreq)])
        st, so = eng.step_fused(st, rows, eng.modes_for_rows(st, rows))
        for i in np.nonzero(rows)[0]:
            toks[i].extend(so.tokens[i, :so.counts[i]].tolist())
    keys = eng.dispatch_keys
    del eng
    solo = SpecPVEngine(cfg, spec, dcfg, params, dparams, batch=1,
                        max_len=max_len, device="cuda", paged=True,
                        zero_copy=True, prefix_cache=False)
    for i, (p, ex) in enumerate(reqs):
        want, _ = solo.generate(p[None], FAM_FP32_NEW, extra=ex)
        if toks[i][:FAM_FP32_NEW] != want[0].tolist():
            raise AssertionError(f"fp32 whisper-small slot r{i} on (2, 1) "
                                 f"differs from solo generate")
    secs = time.perf_counter() - t0
    say(card, f"family data-parallel whisper-small x2 fp32: {nreq} slots "
              f"(prompts {list(FAM_DP_XATTN)}) with their own extra on a (2, "
              f"1) mesh (step keys "
              f"{ {str(k): n for k, n in keys.items()} }) == solo generate "
              f"for every request; (b) took {secs:.1f} s")
    del solo, params, dparams
    torch.cuda.empty_cache()
    return dict(tp=out, seconds=secs)


def phase_families(torch, card, timer, base):
    """Phase 22: every model family under a mesh.  (c) the kernels at the
    shards' heads, (a) the four families on (1, 2) at full width beside
    the unsharded phases (``base``), (b) the fp32 equalities on (1, 2)
    and (2, 1).  Returns (a)'s summed launches, the call forms and the
    numbers."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shapes = _fam_kernel_checks(torch, card, timer)
    t_c = time.perf_counter() - t_phase
    a = _fam_generate(torch, card, base)
    t_a = time.perf_counter() - t_phase - t_c
    gc.collect()
    torch.cuda.empty_cache()
    b = _fam_fp32(torch, card)
    total = time.perf_counter() - t_phase
    launches = {}
    for r in a.values():
        for k, n in r.pop("launches").items():
            launches[k] = launches.get(k, 0) + n
    say(card, f"phase 22 launches (the four (1, 2) runs) {launches}; (c) "
              f"{t_c:.1f} s, (a) {t_a:.1f} s, (b) {b['seconds']:.1f} s; phase "
              f"22 took {total:.1f} s")
    return dict(launches=launches, shapes=shapes, tp=a, fp32=b,
                seconds=total)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="2,3,4,5,6,7,8,9,10,11,13,14,15,16,17,18,19,"
                            "20,21,22",
                    help="comma list of phases 2 (kernels), 3 (llama "
                         "generate), 4 (llama losslessness), 5 (rwkv6-3b "
                         "generate and losslessness), 6 (llama serving), 7 "
                         "(llama serving with shared prefixes), 8 (the "
                         "reference's default engine: contiguous cache, "
                         "gathered partial cache), 9 (the fused multi-row "
                         "prefill), 10 (training and the paper's table 1), "
                         "11 (sampled serving), 13 (tiered KV residency), "
                         "14 (the MoE family, granite-moe-1b-a400m), 15 "
                         "(the rest of the dense registry), 16 (Griffin, "
                         "recurrentgemma-2b), 17 (VLM and audio: "
                         "whisper-small, llama-3.2-vision-90b), 18 "
                         "(windowed llama3.1-8b; context-parallel Full and "
                         "Partial verification over 2 ranks), 19 (the "
                         "launch steps, the hillclimb cases and the int8 "
                         "resident decode cache), 20 (data-parallel "
                         "serving over a (2, 1) mesh), 21 (tensor "
                         "parallelism over a (1, 2) mesh), 22 (the state "
                         "and cross-attention families on (1, 2) and (2, "
                         "1) meshes); 1 and 12 always run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0, found {cap}")
    say(card, f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} capability {cap}")

    from repro_torch.kernels import build, ops
    build.load_library()
    info = build.BUILD_INFO
    say(card, f"kernels built in {info['seconds']:.1f} s "
              f"(cached={info['cached']}) -> {info['path']}")
    for line in info.get("ptxas", "").splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            say(card, f"ptxas: {line.strip()}")

    timer = Timer(torch)
    secs = {}               # each phase's seconds, printed at the end

    def run(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[n] = secs.get(n, 0.0) + time.perf_counter() - t0
        return out
    kres = run(2, phase_kernels, torch, card, timer) if 2 in phases else {}
    p2t = {"shapes": (run(2, _train_kernel_checks, torch, card, timer)
                      if 2 in phases else {})}
    p2m = {"shapes": (run(2, _moe_kernel_checks, torch, card, timer)
                      if 2 in phases else {})}
    p2r = {"shapes": (run(2, _registry_kernel_checks, torch, card, timer)
                      if 2 in phases else {})}
    p2x = {"shapes": (run(2, _vlm_audio_kernel_checks, torch, card, timer)
                      if 2 in phases else {})}
    p3 = run(3, phase_generate, torch, card) if 3 in phases else None
    llama = p3["launches"] if p3 else {k: 0 for k in ops.KERNELS}
    p4 = run(4, phase_lossless, torch, card) if 4 in phases else None
    rwkv = (run(5, phase_rwkv, torch, card) if 5 in phases
            else {k: 0 for k in ops.KERNELS})
    serving = (run(6, phase_serving, torch, card) if 6 in phases
               else {"launches": {}})
    prefix = (run(7, phase_prefix_serving, torch, card) if 7 in phases
              else {"launches": {}})
    p8 = (run(8, phase_default_engine, torch, card, timer, p3, p4,
              serving if 6 in phases else None)
          if 8 in phases else {"launches": {}, "serving_launches": {},
                               "shapes": {}})
    p9 = (run(9, phase_fused_prefill, torch, card, timer) if 9 in phases
          else {"launches": {}, "contiguous_launches": {},
                "prefix_launches": {}, "shapes": {}})
    p10 = run(10, phase_train, torch, card) if 10 in phases else None
    p11 = (run(11, phase_sampled_serving, torch, card, p10 is not None)
           if 11 in phases else {"launches": {}})
    p13 = (run(13, phase_tiers, torch, card) if 13 in phases
           else {"launches": {}})
    p14 = (run(14, phase_moe, torch, card) if 14 in phases
           else {"launches": {}, "serving_launches": {}})
    p15 = (run(15, phase_registry, torch, card) if 15 in phases
           else {"launches": {}})
    p16 = (run(16, phase_griffin, torch, card) if 16 in phases
           else {"launches": {}})
    p17 = (run(17, phase_vlm_audio, torch, card) if 17 in phases
           else {"audio_launches": {}, "vlm_launches": {}})
    p18 = (run(18, phase_windowed_cp, torch, card, timer) if 18 in phases
           else {"shapes": {}, "cp_launches": {}})
    p19 = (run(19, phase_launch, torch, card) if 19 in phases
           else {"launches": {}})
    p20 = (run(20, phase_data_parallel, torch, card,
               serving if 6 in phases else None)
           if 20 in phases else {"launches": {}, "shard_launches": []})
    p21 = (run(21, phase_tensor_parallel, torch, card, timer, p3)
           if 21 in phases else {"launches": {}, "shapes": {}})
    # the unsharded figures beside phase 22's split runs (the VLM's run
    # in phase 22 itself, at its depth there)
    base = {}
    if "graph_run" in rwkv:
        base["rwkv6-3b"] = rwkv.pop("graph_run")
    if 16 in phases:
        base[GRIFFIN] = dict(p16["generate"]["graphs"], source="phase 16",
                             toks=p16["tokens"])
    if 17 in phases:
        base[AUDIO] = dict(p17["generate"][AUDIO]["graphs"],
                           source="phase 17", toks=p17["tokens"][AUDIO])
    p22 = (run(22, phase_families, torch, card, timer, base)
           if 22 in phases else {"launches": {}, "shapes": {}})
    say(card, "phase seconds " + ", ".join(f"{n}: {t:.1f}"
                                           for n, t in sorted(secs.items())))

    rows = []
    for name in ops.KERNELS:
        r = kres.get(name, {})
        path = rwkv if name in RWKV_KERNELS else llama
        rows.append(dict(name=name, route="cuda", **KERNEL_META[name],
                         launches=int(path.get(name, 0)),
                         serving_launches=int(
                             serving["launches"].get(name, 0)),
                         prefix_serving_launches=int(
                             prefix["launches"].get(name, 0)),
                         contiguous_launches=int(
                             p8["launches"].get(name, 0)),
                         contiguous_serving_launches=int(
                             p8["serving_launches"].get(name, 0)),
                         fused_serving_launches=int(
                             p9["launches"].get(name, 0)),
                         fused_contiguous_serving_launches=int(
                             p9["contiguous_launches"].get(name, 0)),
                         fused_prefix_serving_launches=int(
                             p9["prefix_launches"].get(name, 0)),
                         training_launches=int(
                             (p10 or {"launches": {}})["launches"].get(
                                 name, 0)),
                         sampled_serving_launches=int(
                             p11["launches"].get(name, 0)),
                         tiered_serving_launches=int(
                             p13["launches"].get(name, 0)),
                         moe_launches=int(p14["launches"].get(name, 0)),
                         moe_serving_launches=int(
                             p14["serving_launches"].get(name, 0)),
                         registry_launches=int(
                             p15["launches"].get(name, 0)),
                         griffin_launches=int(
                             p16["launches"].get(name, 0)),
                         audio_launches=int(
                             p17["audio_launches"].get(name, 0)),
                         vlm_launches=int(
                             p17["vlm_launches"].get(name, 0)),
                         cp_launches=int(p18["cp_launches"].get(name, 0)),
                         launch_launches=int(p19["launches"].get(name, 0)),
                         data_parallel_serving_launches=int(
                             p20["launches"].get(name, 0)),
                         data_parallel_shard_launches=[
                             int(sh.get(name, 0))
                             for sh in p20["shard_launches"]],
                         tensor_parallel_launches=int(
                             p21["launches"].get(name, 0)),
                         family_tensor_parallel_launches=int(
                             p22["launches"].get(name, 0)),
                         max_abs_err=r.get("max_abs_err"), ms=r.get("ms"),
                         plain_ms=r.get("plain_ms"),
                         bound_ms=r.get("bound_ms"),
                         bound_by=r.get("bound_by"),
                         library_ms=r.get("library_ms")))
        if "shapes" in r:      # every timed shape (K5: with its launches)
            by_shape = path.get(f"{name}_shapes")
            rows[-1]["shapes"] = []
            for label, vals in r["shapes"].items():
                sh = dict(shape=label, **vals)
                if by_shape is not None:
                    sh["launches"] = by_shape.get(label, 0)
                rows[-1]["shapes"].append(sh)
                say(card, f"kernel {name} {label}: ms {sh['ms']:.4f} "
                          f"bound_ms {sh['bound_ms']:.5f} plain_ms "
                          f"{sh['plain_ms']:.4f} library_ms "
                          f"{sh.get('library_ms')} launches on the path "
                          f"{sh.get('launches', 'not counted by shape')}")
        # phases 8, 9, 10, 14, 15, 17, 18, 21 and 22's call forms
        # (launches counted per kernel above)
        for p in (p8, p9, p2t, p2m, p2r, p2x, p18, p21, p22):
            for label, vals in p["shapes"].get(name, {}).items():
                rows[-1].setdefault("shapes", []).append(dict(shape=label,
                                                              **vals))
    if p10 is not None:
        say(card, "training " + json.dumps(p10))
    if 11 in phases:
        say(card, "sampled serving " + json.dumps(p11))
    if 13 in phases:
        say(card, "tiers " + json.dumps(p13, default=float))
    if 14 in phases:
        say(card, "moe " + json.dumps(p14, default=float))
    if 15 in phases:
        say(card, "registry " + json.dumps(p15, default=float))
    if 16 in phases:
        say(card, "griffin " + json.dumps(p16, default=float))
    if 17 in phases:
        say(card, "vlm_audio " + json.dumps(p17, default=float))
    if 18 in phases:
        say(card, "windowed_cp " + json.dumps(
            {k: v for k, v in p18.items() if k != "shapes"}, default=float))
    if 20 in phases:
        say(card, "data_parallel " + json.dumps(
            {k: v for k, v in p20.items() if k != "launches"},
            default=float))
    if 21 in phases:
        say(card, "tensor_parallel " + json.dumps(
            {k: v for k, v in p21.items() if k != "shapes"}, default=float))
    if 22 in phases:
        say(card, "families " + json.dumps(
            {k: v for k, v in p22.items() if k != "shapes"}, default=float))
    if 19 in phases:
        say(card, "launch " + json.dumps(
            {k: v for k, v in p19.items() if k != "launches"},
            default=float))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
