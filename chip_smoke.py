#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It imports neither JAX nor the JAX package.  Phases, in order; any failure
exits non-zero and prints no result:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (thirteen
   sources) with nvcc, one process per source, all at once, and check with
   ``cuobjdump -sass`` that the bf16 flash and grouped-matmul kernels run
   on the tensor cores (HMMA instructions, ``mma.sync``; the grouped
   matmul's input-gradient and weight-gradient kernels HGMMA, Hopper's
   ``wgmma``, and no HMMA), and from ``-Xptxas -v`` that the
   tensor-core flash and grouped-matmul ones and the three RG-LRU ones
   (the forward, the backward's tile aggregates and tile gradients) do not
   spill (the flash backward kernels' and the WKV6 backward kernels'
   registers and spills are printed too);
2. hold each kernel against its plain PyTorch version on the card: the
   remote-DMA kernels at the KVStore path's shapes (outputs and measured
   bytes bitwise equal, scatter collisions included), on the argument forms
   the verbs pass them (bool masks, the read verb's index one vector
   broadcast to every home with ``expand``) and on int32 masks and
   contiguous indices, all three on the verbs' forms one device operation
   per call (``torch.profiler``), the row commit also with 1-word rows,
   homes of a word count not a multiple of four, a base off 16 bytes and
   indices outside [0, slots) (one in [-slots, 0) wraps, any other is
   dropped, as the reference's oracle does), the remote-copy kernel at the ring hop's shapes (P=4 with 648 words, P=8
   with 20,488) and the bare ring entries (640 and 20,480 words) and at odd
   ones (a width not a multiple of four, a misaligned view, zero words, no
   senders, every receiver from one sender, a permutation; int64 maps,
   values an int32 cast would wrap among them), outputs and both byte
   vectors bitwise equal, and one device operation per call (no fill,
   memset or cast, by ``torch.profiler``), the attention kernels
   at the serving paths' full-width shapes (head_dim 128, and 256 with a
   2048-token window and one kv head; flash inputs as the models pass
   them, (B, H, S, D) views of (B, S, H, D) projections) and at odd ones —
   views at head_dim 64, 128, 160, 200 and 256, Sq and Sk not multiples of
   the tile, bf16 rows off 16 bytes (the flash kernel's CUDA-core route; each
   flash case checks the route taken), decode lengths 0, 1, 64, 65 and S in
   one batch, S not a multiple of the split's chunk, a sequence with one
   live chunk, a group of 20 query heads (two group tiles) — and at
   deepseek-v3's MLA shapes: the expanded prefill (4 prompts of 512 tokens,
   128 heads, q and k 192 wide, v zero-padded from 128 to 192; the padded
   output columns must be zero) and the absorbed decode (128 query heads on
   one kv head of the 576-wide latent cache, 544 slots, lengths 0, 1, 64, 65
   and S, full-width and one-live-split batches, bf16; float32 at D = 576
   must be refused) and at the cross-attention paths' (whisper's
   bidirectional encoder, 20 heads of 64 over 1,500 frames; its cross
   prefill, 224 queries over 1,500 keys; its cross decode over the full
   1,500-slot context and its self decode at lengths 224, 225, 256 and 1;
   llama-3.2-vision's cross prefill, 512 queries over 1,601 keys, 32 heads
   on 8 of 128, and its cross decode at every length 1,601: non-causal
   with Sq != Sk and a ragged last key tile) — (float32 within 2e-5,
   bfloat16 within 2e-2 of the
   float32 plain result on the same inputs), then every decode arrival
   counter is checked to be 0,
   the RG-LRU and WKV6 kernels at their serving shapes and at odd ones
   (RG-LRU also with runs of log_a = 0, strong decays, 4096 steps at full
   width, D = 2568 and a base off 16 bytes; WKV6 also with strong decays,
   w exactly 0 and 2048 steps), in float32 and bfloat16, outputs and final
   states (tolerances at ``REC_TOL``; each RG-LRU case on the copies it
   should take: 16-byte ones where every row starts on 16 bytes, else one
   element at a time; each WKV6 case on the kernel it should take: bf16 on
   the chunked tensor-core one, float32 on the sequential one), and the
   grouped matmul at llama4-maverick's expert shapes
   (prefill: 3072 slot rows in blocks of 24; decode: 1024 rows in blocks of
   8; 128 experts of 5120 x 8192 and 8192 x 5120), every row counted and
   with per-block row counts (a decode step's 4 live blocks of 128, partial
   prefill counts), at deepseek-v3's (256 experts of 7168 x 2048 and 2048 x
   7168; prefill: 20,480 slot rows in blocks of 80; decode: 2,048 in blocks
   of 8, a step's 4 tokens routed top-8), and at odd ones (all-zero
   counts, partial counts over garbage rows), in float32 and bfloat16 (tolerances at ``GMM_TOL``; each
   case on the kernel it should take, rows past the counts exactly zero);
2b. hold flash attention's backward (``csrc/flash_attention_bwd.cu`` and
   ``csrc/flash_attention_bwd_sm90.cu``) against its plain version: D 64,
   128, 192 (v zero-padded from 128, as MLA's, whose padded columns must
   get zero gradient) and 256, groups of 1, 3, 5 and 8, causal, a
   2048-token window, Sq != Sk, S 1, 17 and 4096, bidirectional, D 40,
   96, 136 and 200 (zero-filled on the tensor cores), bf16 rows off 16
   bytes at D 128 and 256 and bf16 at D 252 (the CUDA cores), bf16 and
   float32 (tolerance ``ATTN_TOL`` relative to the plain gradient's max),
   each case on the route ``_bwd_variant`` picks (bf16 rows on 16 bytes
   at D <= 128 on ``mma.sync``, above it on ``wgmma`` fed by TMA, the rest
   on the CUDA cores), the forward's log-sum-exp against the plain one's,
   two calls bitwise equal, and a call's device operations (each route's
   three kernels once each) under ``torch.profiler``;
   also at the vlm's and whisper's training shapes (whisper's encoder, 20
   heads of 64 over 1,500² frames, bidirectional; its cross-attention,
   224 queries over 1,500 keys; the vision cross layers', 512 over 1,601,
   32 heads on 8 of 128), on the tensor cores in bf16; then the grouped
   matmul's backward (``gmm_dx``: ``csrc/moe_gmm_dx.cu``, on the CUDA cores
   the forward's kernel reading w as its transpose; ``gmm_dw``:
   ``csrc/moe_gmm_dw.cu``) against its plain
   versions (``ref.gmm`` on ``w.transpose(1, 2)``, ``ref.gmm_dw``; element
   by element within ``BWD_TOL``) at llama4-maverick's and deepseek-v3's
   expert shapes at phase 7's batch (128 experts of 5120 <-> 8192, 80
   slots, top-1; 256 of 7168 <-> 2048, 320 slots, top-8), both leaf
   orientations, with a dispatch's row counts (empty, partial and full
   experts), the a2a form (every expert on two blocks), float32 at both
   widths with fewer experts, bf16 rows off 16 bytes, widths not
   multiples of 8, ragged tiles, a block of two 64-row chunks, all-zero
   counts, block_t 1 and no counts, unsorted block experts that repeat,
   counts of 63, 64, 65, 127, 128, 129 and 320, experts counted only in
   their second a2a block, a block_t of 400 (two passes of dx):
   each on the route ``_variant`` picks, dx's rows past the counts and an
   expert with no counted row's gradient exactly zero, two calls bitwise
   equal, one device operation a call;
2c. hold the recurrences' backward kernels against their plain versions
   (``ref.rglru_bwd``, ``ref.wkv6_bwd``; tolerances ``BWD_TOL``):
   ``rglru_scan_bwd`` (``csrc/rglru_scan.cu``), each case after the
   forward kernel kept its tile states (checked against
   ``ref.rglru_chunked``'s), at recurrentgemma-2b's training shape (2 x
   4,096 x 2,560) with dh_final zero and seeded, D = 100, runs of log_a =
   0, strong decays, D = 2568, S a multiple of both tiles and one off it
   either way, one tile, and a base off 16 bytes, bf16 and float32, each
   on the copies ``_variant`` picks;
   ``wkv6_bwd`` (``csrc/wkv6_bwd.cu``, chunk-parallel) in float32 at
   rwkv6-7b's (2 x 64 heads of 64 x 4,096 steps), D 16/32/48/64 with S
   off its 64-step chunk (S = 64k - 1 and 64k + 1 among them) and S = 1,
   ds_final zero and seeded, strong decays, w exactly 0 and a whole chunk
   of w = 0, and a base off 16 bytes, each on the copies ``_bwd_variant``
   picks; two calls bitwise equal, and a call's device operations (two:
   the tile aggregates, every tile's gradients; three: the chunk states,
   every chunk's gradients, du's sum) under ``torch.profiler``;
3. run the same work on the card and on the CPU: a P=4 store through 20
   windows (states and results bitwise equal after every window), a P=4
   lock-free store through the same windows and then all-UPDATE and
   pure-GET ones (its fastpath ledger rows equal too), a P=4 heat-tracked
   store under skewed readers through a rebalance and a mixed window (heat
   counters bitwise equal too), the
   smoke engine of every served architecture (llama3.2-3b, gemma-2b,
   internlm2-20b, recurrentgemma-2b, rwkv6-7b, llama4-maverick,
   deepseek-v3, whisper-large-v3 and llama-3.2-vision-11b: nine) in
   float32 with one set of weights each (equal tokens, bitwise equal
   page-table state), the smoke llama-3.2-vision and whisper models with
   the vlm's gates seeded non-zero and a random seeded context (prefill,
   three decode steps and every cache leaf within 1e-4; another context
   must move the logits), and the smoke llama3.2-3b engine with
   two page-table replicas on the remote-DMA backend, its log leader killed
   and revived (equal tokens; page table, replicas, log and detector
   bitwise equal), and one float32 training step of the smoke llama3.2-3b
   with AdamW, with Adafactor and with AdamW over 2 microbatches, and of
   the smoke recurrentgemma-2b, rwkv6-7b, llama-3.2-vision (gates seeded
   non-zero) and whisper with AdamW on the pipeline's random context (the
   loss within 1e-4, every gradient leaf within ``GRAD_TOL`` of its
   largest, the update of the same gradients within 1e-4, and for
   llama3.2-3b the step's parameters and optimizer state within 1e-4 end
   to end), and of the smoke llama4-maverick and deepseek-v3 (float32,
   AdamW) on the local path and through ``make_train_step(..., mesh=)``
   on a (1, 4) stacked mesh (the a2a block), each card step exactly 6
   ``gmm``, 3 ``gmm_dx`` and 3 ``gmm_dw`` launches a MoE layer (the
   backward's on the CUDA cores), then one ``make_grad_sync(mesh,
   compress="int8ef")`` step on a (2, 2, 2) (pod, data, model) stacked
   mesh, its int8 payloads, their scales and the synced gradients bit for
   bit equal on the card and the CPU;
4. the KVStore path — ``KVStore.op_window`` on the remote-DMA backend — at a
   deployment's size: P=8 participants, K=2**22 keys, 8-byte values,
   windows of 512 lanes per participant; prefill 80% of K, then 20 windows
   of 60/20/10/10 GET/UPDATE/INSERT/DELETE over distinct uniform keys and
   20 windows of 95/5 GET/UPDATE over zipf(0.99) keys; every GET and every
   ``found`` is checked against a numpy oracle of the window semantics;
4a. from the prefilled state on, a lock-free twin (``lockfree=True``, a
   copy of the state) runs the same windows: bitwise equal to the locked
   store after every one, oracle-checked, the fast path taken by every zipf
   window and by no mixed one (the ledger's fastpath rows), and a fast
   window's launches exactly one read verb and one write verb;
4c. the migration scenario of ``benchmarks/bench_locality.py`` on the
   final state: a heat-tracked twin with a fresh heat leaf, 10 skewed read
   windows (reader r reads zipf(0.99) keys of its shard k = r mod P, 10%
   uniform noise), up to 4 ``rebalance(max_moves=4096)`` passes (moves and
   backlog consistent with the proposals), the first read window again
   (its modeled wire bytes must fall), every GET and a mixed window after
   the migration oracle-checked;
4b. the failover scenario of ``benchmarks/bench_failover.py`` on that
   store shape: a leader and two follower stores behind a ReplicatedLog,
   the prefill (FO_FILL_WINDOWS windows, 40% of K) and 20 mixed windows
   each appended and synced, the leader
   killed (detected, a follower promoted, the in-flight window retried, a
   zombie publish fenced) and revived (replay rejoin); the leader's results
   against the oracle, every follower bitwise equal to the leader at the
   end;
4d. the channel objects' scalar verbs on the remote-DMA backend (each
   scalar read is one descriptor and one row-gather launch, each write one
   descriptor and one row-commit launch), once on the card and once on the
   CPU, bitwise equal: ``benchmarks/bench_lock.py``'s single contended
   TicketLock (P=8, 12 rounds, one holder a round) and its transfer
   transactions (P=8, 2,728 accounts in a SharedRegion, 341 locks, 12
   rounds with the lock the account's and 12 with it the account // 8's:
   balances conserved, each completed transfer moved exactly 1, exactly
   4/2/2 descriptor/gather/commit launches a round),
   ``benchmarks/bench_barrier.py``'s crossings at P = 2, 4, 8 (count =
   crossings), OwnedVar push/pull and AtomicVar fetch_add/compare_swap, the
   queue's scalar reference paths (= its B=1 windows), and
   ``repro_torch.examples.kvstore_app`` on the card on the remote-DMA
   backend with its online oracle (every map kernel launched);
4e. ``benchmarks/bench_kvstore.py``'s reference variant (P=8, 1,024 keys,
   index 4,096, 132 slots, 256 locks, windows of 32): a hash store and a
   ``reference_impl=True`` store in step through the 80% prefill, 10 mixed
   and 10 zipf(0.99) windows (results lane for lane equal, every key on
   the same home with the same value), the spec store bitwise equal on the
   card and the CPU after every window, ``op_round`` bitwise
   ``_op_round_reference`` over 6 rounds, ``migrate_window`` result for
   result ``_migrate_reference`` on a placed store; the prefill time of
   each store and their ratio are printed;
4f. the map across processes (``make_manager(P, mesh=ProcessMesh(P))``,
   one participant a rank): the KVStore path's store shape (``pallas``,
   K = 2**22, index 4·K, 4,096 locks, 512 lanes a participant) through 24
   INSERT windows, 6 mixed and 6 zipf ``get_batch`` windows and one MOVE
   window, first stacked in this process (oracle-checked), then on a
   world of 1 on NCCL and a world of 8 sharing the card over gloo, each
   spawned with the kernels built: every rank's results its rows of the
   stacked ones, its state block the stacked row by digests after the
   fill and every later window, its remote-DMA launches on its own block
   as many as the stacked store's; the world of 8 also runs the
   reference's ``tests/test_shardmap_binding.py`` programs
   (``repro_torch.examples.process_map``) against the stacked run's by
   digests; each rank's window p50 is printed, labelled as gloo on one
   card and not a number between cards;
4g. the failover scenario across processes: phase 4b's steps (the same
   code, ``failover_run``, with the binding a parameter) on the main
   path's store shape, the fill cut to 24 INSERT windows and the mixed
   windows to 12 of 20, first stacked in this process (the reference),
   then one participant a rank on a world of 8 sharing the card over gloo
   (the leader killed before mixed window 8, detected, a follower
   promoted, the in-flight window retried, a zombie fenced, the leader
   revived before window 10 and rejoined by ring-tail replay) and on a
   world of 1 on NCCL without a death: every rank's blocks of the leader,
   the followers, the log and the detector the stacked run's rows by
   digests after the fill, each mixed window, the promotion and the
   rejoin; the oracle, one failover in the same detection window with the
   same winner, the zombie fenced in the log and in rank 0's ledger, no
   acked window lost, the followers equal to the leader, checked in every
   rank; ``remote_copy_peers`` launched once for each ring publish on
   every rank; each rank's replicated window p50 / p99, detection,
   promotion and rejoin ms and GiB beside the stacked run's, labelled as
   gloo on one card;
5. the serving paths — ``ServingEngine.generate`` at full published width,
   bf16, random weights drawn on the card from a seeded generator, 8
   requests of 32 generated tokens in batches of 4 — on llama3.2-3b
   (512-token prompts), then llama3.2-3b again with two page-table replicas
   on the remote-DMA backend, 24 requests of 16 tokens, its log leader
   killed and revived (detection, promotion, the flush of buffered windows
   and a snapshot rejoin), recurrentgemma-2b (2304-token prompts, so its
   2048-token window and ring-buffer cache bind), rwkv6-7b (512-token
   prompts) at full depth, llama4-maverick-400b-a17b (512-token prompts)
   cut to 4 of its 48 layers, two [dense, MoE] periods, so that its bf16
   weights (65.3 GiB) fit the card, gemma-2b and internlm2-20b (512-token
   prompts) at full depth, and deepseek-v3-671b (512-token prompts) cut to
   5 of its 61 layers, [mla_dense] x 3 + [mla_moe] x 2 (50.9 GiB of bf16
   with its MTP weights: MLA prefill on the flash kernel, the absorbed
   decode on the decode kernel at D = 576, 256 experts top-8 on the
   grouped matmul), whisper-large-v3 at full width and depth (32 encoder
   and 32 decoder layers, 224-token prompts, half its 448-token text
   context, over 1,500 zero frames: flash per encoder layer and for each
   decoder layer's self and cross attention, decode attention twice per
   decoder layer a step) and llama-3.2-vision-11b at full width and depth
   (40 layers, [attn x 4, cross] x 8, 512-token prompts over 1,601 zero
   context tokens; its cross layers on the same kernels); one after the
   other, each engine freed before the next; page-table, locality, logit
   and launch-count checks
   (recurrentgemma-2b's RG-LRU launches all on 16-byte copies, rwkv6-7b's WKV6 launches all on the chunked kernel),
   and on the replicated path the replication checks;
5b. after the llama4-maverick and deepseek-v3 paths, on their weights (a
   second copy does not fit the card), the expert-parallel serving path:
   ``make_serve_steps`` on a (1, 8) stacked mesh, 8 model shards of 16 and
   32 experts, every MoE layer through ``make_moe_fn``'s a2a block, one
   prefill of 4 x 512 tokens and 32 greedy decode steps, each call's
   launches counted from 0 (exactly 6 grouped matmuls, the attention
   kernel's per layer), finite logits, the first MoE block with the kernel
   against the same block with ``ref.gmm`` on the card, a 64-token prefill
   at capacity n_experts against the local path, a profiled decode step,
   and the grouped matmul timed at the a2a calls and the local decode
   call, beside phase 5's numbers of the local path;
5c. the serving steps across processes: llama3.2-3b at full width and
   depth and llama4-maverick at its published widths cut to 2 of 48
   layers (one dense, one MoE; about 37 GB of bf16 weights), first
   through the unsharded path in this process (its logits and greedy
   tokens kept on the host, its weights freed), then through
   ``make_serve_steps(cfg, ProcessMesh(...))`` in worlds of ranks spawned
   from this process (``repro_torch.launch.world.spawn_world``; the
   kernels already built): a world of 1 on NCCL, mesh (1, 1), whose
   logits must be the unsharded path's bit for bit, and a world of 2
   sharing the one card over gloo (NCCL refuses two ranks on one device),
   mesh (1, 2) — about 3.2 GB of llama3.2-3b's weights and 16 GB of
   llama4's experts a rank, tensor-parallel heads and FFN columns,
   expert-parallel MoE with its two all-to-alls between the processes —
   whose logits must lie within ``PM_TP_TOL`` of the unsharded path's;
   each rank draws its blocks of the same seeded weights, prefills 4 x
   512 tokens and runs PM_DECODE decode steps of the bound decode fed the
   unsharded path's tokens; also recurrentgemma-2b (the RG-LRU
   by channels), rwkv6-7b (the time mix by heads), deepseek-v3 (MLA by
   heads, its experts' a2a), whisper-large-v3 and llama-3.2-vision-11b
   (their attention and cross attention by heads, over a seeded context,
   the cross gates seeded off zero) at published widths, depth cut
   (PM_CUT); a MoE model's ranks route each token to the unsharded
   path's experts (:class:`RouteLog`), each expert they would have
   chosen in place of one a near tie (PM_ROUTE_TIE), and at world 2
   deepseek-v3 also serves at its published capacity, drops included,
   held for launches and finite logits; every logit finite; each rank's
   flash, decode, RG-LRU, WKV6 and grouped-matmul launches, counted from
   0 over its path, as planned;
   each rank's peak memory, prefill ms and decode-step p50 printed with
   the backend, world and mesh, beside the card's name and power limit
   (world 2's labelled as on one card over gloo, not a number between
   cards); the world of 2 then builds a (2, 1) mesh over its ranks and
   serves llama3.2-3b cut to 2 layers there with ``fsdp=False`` and
   ``fsdp=True`` (each rank half the layers' and the embedding's bytes,
   each layer gathered over ``data`` as it runs): one prefill and 4 decode
   steps, the fsdp logits bit for bit the others, launches as planned,
   each run's peak memory beside the other's;
7. the training path — ``repro_torch.launch.train.run``, the code of
   ``python -m repro_torch.launch.train`` — on llama3.2-3b at full width
   and depth (28 layers, 3,212,749,824 parameters), bf16, 2 x 4096 tokens
   a step, ``remat="block"``, AdamW, 6 steps on one repeated
   SyntheticTokens batch: every loss finite, the last below the first,
   exactly 56 flash forward launches (each layer's forward and its
   recompute) and 28 backward calls a step and no other model kernel;
   step p50 / p99, tokens/s and peak memory; one more step under
   ``torch.profiler`` (device busy share, the flash forward's and
   backward's shares); then, at full width and depth, FAMILY_STEPS steps
   each of recurrentgemma-2b (2 x 4,096 tokens, AdamW: exactly 36 RG-LRU
   scans and 18 backward calls a step, all on 16-byte copies, 16 flash
   forwards and 8 backward calls on the ``wgmma`` route at D 256, and the
   flash backward's share of the profiled step), rwkv6-7b (2
   x 4,096, Adafactor: exactly 64 WKV forwards on the float32 sequential
   kernel and 32 backward calls), whisper-large-v3 (2 x 224 tokens over
   1,500 frames, AdamW: 192 flash forwards and 96 backward calls, on the
   tensor cores) and llama-3.2-vision-11b (2 x 512 over 1,601 context
   tokens, Adafactor with bf16 moments: 80 and 40), each with the
   pipeline's synthesized context where it has one, the same loss, launch
   and route checks (no gmm, no decode attention), numbers and one
   profiled step (the recurrences' forward and backward shares too);
   ``gmm``, ``decode_attention`` and the bare ``rglru_scan`` and ``wkv6``
   refusing a grad-requiring input on the card, ``RGLRUScan`` and
   ``WKV6Train`` taking one and launching their backward kernels, and
   ``gmm`` taking one through ``GroupedMatmul`` (``gmm_dx`` and ``gmm_dw``
   in its backward); the smoke llama4-maverick through the same launcher
   (bf16, 6 steps of 2 x 256 tokens; exactly 6 ``gmm``, 3 ``gmm_dx`` and 3
   ``gmm_dw`` launches a MoE layer a step, on the tensor cores; its
   published widths the launcher refuses for memory); ``moe_block_local``
   forward and backward at llama4-maverick's and deepseek-v3's published
   widths on 2 x 4,096 tokens (exactly 3 launches of each kernel, finite
   gradients, zero for an expert with no token, ms, peak memory and the
   kernels' share of the device time; at deepseek-v3's every gradient
   against the same block with the plain versions on the card); and a
   checkpoint round trip of the smoke model's bf16 state on the card,
   bitwise;
7c. the training steps across processes, ``make_train_step(cfg, tcfg,
   mesh=ProcessMesh(...))`` in worlds of ranks spawned from this process
   (the kernels already built, every rank on this card): a world of 1 on
   NCCL, mesh (1, 1), ZeRO stage 2, training llama3.2-3b at full width and
   depth (2 x 4,096 tokens) and the smoke llama4-maverick (a2a router) 3
   steps each, after the one-device step ran the same 3 steps in the rank,
   every step's losses, grad norms, parameters and moments bit for bit
   (digests of the bits); then worlds of 2 sharing the card over gloo on
   (2, 1) at stages 2 and 3 (fsdp) and on (1, 2), training llama3.2-3b at
   full width cut to 2 layers (2 x 1,024; on (1, 2) also the smoke llama4,
   expert-parallel) 3 steps, held to reference steps this process ran
   first (the first step's dp-mean gradient blocks within ``PT_GRAD_TOL``
   leaf by leaf, losses and grad norms within ``PT_LOSS_TOL``, a bf16
   control meeting both, every parameter element within the AdamW bound
   of ``PT_STEP_BOUND`` / ``PT_ULPS``); in the (2, 1) stage-3 world also
   the smoke whisper and rwkv6 (every leaf fsdp-split over ``data``, each
   layer gathered inside its ``remat`` region) held to their one-device
   steps the same way; beside the (1, 1) and (2, 1) meshes the same ranks
   as a (pod, data, model) mesh, (1, 1, 1) and (2, 1, 1), training the
   smoke llama4 (world 1) or the dense model (world 2) again from the same
   weights: every step's losses, grad norms, parameters and moments, and
   at world 2 the first dp-mean gradient's blocks, bit for bit those of
   its flat twin (at world 1 of the one-device step);
   each rank's launches of the flash forward and backward and the grouped
   matmul and its backward as ``train_launches`` plans, one profiled step
   in step on every rank (its device operations by kernel row), the
   rank's step p50, peak memory and the transports gloo used printed
   beside the card's name and power limit (world 2's not a number between
   cards); then ``run_elastic`` across processes: a world of 2 on (2, 1)
   whose rank 1 leaves without a word at step 2 (no collective, no
   ``shrink_world``), rank 0 re-forms the world alone, restores the
   checkpoint onto (1, 1) and finishes;
6. report the end-to-end numbers of every path, each kernel's launches on
   its path, its time beside its plain version's, one PyTorch call's and
   its bound (every row also with the kernel's device time per call from
   ``torch.profiler``, which tells host-bound rows from kernel-bound ones,
   the remote-DMA and recurrent rows with their device operations per
   call, the remote-DMA rows timed on the verbs' argument forms, WKV6's
   with the sequential form's bound beside the chunked one's, the
   attention rows with SDPA's, and the attention and grouped-matmul rows
   with an entry at deepseek-v3's MLA and expert shapes, the
   grouped-matmul row with phase 5b's a2a entries, the attention
   rows also at whisper's encoder and cross-decode shapes and
   llama-3.2-vision's cross prefill; the flash
   backward's row at the training shape, with the backward of SDPA's
   output beside it; the RG-LRU's and WKV6's backward rows at their
   training shapes, with their device operations a call; the flash
   backward's row also at recurrentgemma-2b's (D 256, the ``wgmma``
   route), deepseek-v3's MLA (D 192, v 128 zero-padded), whisper's
   encoder and the vision cross layers' training shapes, with SDPA's
   backward and its backend beside each, and a row of the ``wgmma``
   route's own at recurrentgemma-2b's shape; WKV6's row with
   the float32 training form at rwkv6-7b's training shape; the grouped
   matmul's backward, ``gmm_dx`` and ``gmm_dw``, at llama4-maverick's and
   deepseek-v3's training shapes with ``torch.bmm`` beside them), the
   card's name and power limit, and last the result line.

Kernel launch counts are set to 0 just before each path and read just after
it (in phases 5c and 7c in each rank), so the checks of phases 2, 2b, 2c
and 3 and the timings of phase 6 count nowhere;
the map kernels' rows carry phase 4d's and 4e's counts beside the KVStore
path's, and phase 4f's ranks' in ``launches_paths``.
On every replicated path the remote-copy kernel's launches must equal the
ring's publishes (``remote_copy_peers``' on every rank of phase 4g).
Phase 2 also runs the ring hop between processes, ``remote_copy_peers``
over CUDA IPC, on worlds of 2 and 8 ranks sharing the card over gloo: each
rank's row and byte counters bitwise its plain version's (and
``Runtime.bcast``'s where the sender map names ranks only) for broadcasts
from 0 and 5, no senders, every rank naming itself, a permutation and
out-of-range entries, at 20,488, 643 and 0 words; rank 0 of the world of 8
times it at 20,488 words (the wrapper, the device operations, the plain
version and ``Runtime.bcast`` over the same world) for phase 6's row.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# KVStore op codes (checked against repro_torch.core's at start-up)
NOP, GET, INSERT, UPDATE, DELETE, MOVE = 0, 1, 2, 3, 4, 5

# the main path's configuration (benchmarks/bench_kvstore.py's store shape)
P = 8
KEYS = 2 ** 22
B = 512
W = 2
FILL = 0.8
MIX_WINDOWS = 20
ZIPF_WINDOWS = 20
ZIPF_THETA = 0.99
SEED = 0
# phase 4c, the migration scenario of benchmarks/bench_locality.py at the
# main path's size: skewed read windows, then rebalance passes
MIGRATION_READS = 10
READ_NOISE = 0.10
REBALANCE_MOVES = 4096
REBALANCE_PASSES = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# a profiler session's counted calls: PREROLL_S of host time after the
# session starts, then LEAD_MARKS marker kernels (torch.cuda._sleep), the
# calls, one marker.  On the card a session loses a prefix of its device
# records, never a later one: most often its first record, now and then a
# few milliseconds' worth, now and then all of them.  The preroll puts the
# calls past most such losses; a lead marker seen shows that the loss
# stopped before the calls.  A session that is not whole is run again, up
# to PROFILER_SESSIONS times
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
LEAD_MARKS = 128
PREROLL_S = 0.1
PROFILER_SESSIONS = 5
# the most lead markers one profiler session lost this run, and the
# sessions that were not whole
MARKS_LOST = [0]
SESSIONS_RUN_AGAIN = [0]
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM float32 peak outside the tensor cores
F64_FLOPS = 34e12              # H100 SXM float64 peak outside the tensor cores
# float64 operations counted for each exponential of the RG-LRU kernels
# (decay() in csrc/rglru_scan.cu): an estimate of a table-free exponential
# (a range reduction and a polynomial), 17, and the square for exp(2 log_a)
EXP64_OPS = 18

# the serving paths' configurations (phase 5)
SERVE_ARCH = "llama3.2-3b"
SERVE_REQUESTS = 8
SERVE_PROMPT = 512
SERVE_GEN = 32
SERVE_BATCH = 4
RG_PROMPT = 2304               # recurrentgemma: past its 2048-token window
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_LAYERS = 4                 # of 48: two [attn_dense, attn_moe] periods
DS_ARCH = "deepseek-v3-671b"
DS_LAYERS = 5                  # of 61: [mla_dense] x 3 + [mla_moe] x 2
# whisper: 224-token prompts, half of its published 448-token text context
# (the most text it conditions on), over its 1,500 frames; llama-3.2-vision:
# 512-token prompts over its 1,601 context tokens (cross_shape reads both)
WHISPER_ARCH, WHISPER_PROMPT = "whisper-large-v3", 224
VISION_ARCH = "llama-3.2-vision-11b"
# the replicated paths: the failover phase (participant 0, the log leader,
# dies before mixed window FO_KILL and comes back before FO_REVIVE — its
# cursor gap is then the ring's capacity, so the replay rejoin runs) and
# phase 5's replicated llama3.2-3b path (48 mutation windows for 24 requests
# in batches of 4; killed before window REP_KILL, revived at REP_REVIVE, a
# gap past the engine's 3-entry ring, so the snapshot rejoin runs)
LOG_CAPACITY = 4
DETECT_THRESHOLD = 2
FO_KILL, FO_REVIVE = 8, 10
# phase 4b's fill, cut to half the main path's 80% of K (410 of
# 820 INSERT windows, each appended and synced) to keep the script inside
# its limit as phase 5c grew: the failover's steps run as before, over a
# store 40% full
FO_FILL_WINDOWS = -(-int(KEYS * FILL) // (2 * P * B))
REP_REQUESTS, REP_GEN, REP_KILL, REP_REVIVE = 24, 16, 5, 13
SERVE_PATHS = [
    dict(arch=SERVE_ARCH, prompt=SERVE_PROMPT),
    dict(arch=SERVE_ARCH, prompt=SERVE_PROMPT, requests=REP_REQUESTS,
         gen=REP_GEN, replicas=2, backend="pallas",
         plan=dict(kills={0: REP_KILL}, revives={0: REP_REVIVE})),
    dict(arch="recurrentgemma-2b", prompt=RG_PROMPT),
    dict(arch="rwkv6-7b", prompt=SERVE_PROMPT),
    dict(arch=MOE_ARCH, prompt=SERVE_PROMPT, n_layers=MOE_LAYERS, a2a=True),
    dict(arch="gemma-2b", prompt=SERVE_PROMPT),
    dict(arch="internlm2-20b", prompt=SERVE_PROMPT),
    dict(arch=DS_ARCH, prompt=SERVE_PROMPT, n_layers=DS_LAYERS, a2a=True),
    dict(arch=WHISPER_ARCH, prompt=WHISPER_PROMPT),
    dict(arch=VISION_ARCH, prompt=SERVE_PROMPT),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# phase 5b, the expert-parallel serving path: after a MoE path of phase 5,
# on its weights, make_serve_steps on a (data, model) stacked mesh of
# A2A_MESH (8 model shards: 16 of llama4's 128 experts a shard, 32 of
# deepseek's 256), one prefill of SERVE_BATCH x SERVE_PROMPT tokens, then
# A2A_DECODE greedy decode steps; the no-drop check is one prefill of
# A2A_NODROP_PROMPT tokens at capacity n_experts on both paths, its logits
# within ATTN_TOL's bf16 limit of the local path's: the same tokens reach
# the same experts, whose rows sit in other blocks of the same products,
# and the router's float32 product is batched over the shards, so the two
# differ by bf16 roundings through the layers
A2A_MESH = (1, 8)
A2A_DECODE = 32
A2A_NODROP_PROMPT = 64
# phase 5c, the serving steps across processes (make_serve_steps on a
# ProcessMesh): llama3.2-3b at full width and depth and llama4-maverick at
# its published widths cut to PM_MOE_LAYERS of 48 layers (one dense, one
# MoE), one prefill of SERVE_BATCH x SERVE_PROMPT tokens and PM_DECODE
# decode steps fed the unsharded path's greedy tokens (so one argmax tie
# cannot cascade), in each world of PM_WORLDS: (backend, (data, model)).
# The card is one, and NCCL refuses two ranks on one device, so world 2
# shares it over gloo; neither world is a number between cards.  World 1
# must give the unsharded path's logits bit for bit; world 2's row-parallel
# sums round bf16 partial products of each attention and MLP output (the
# unsharded path rounds one float32 sum), a few bf16 steps apart through
# the layers, so its logits are held within PM_TP_TOL of the unsharded
# path's (max |diff| over max(1, max |logit|), as ATTN_TOL's)
# The world of each key of PM_FSDP also builds the value's mesh over the
# same ranks and serves llama3.2-3b at full width cut to PM_FSDP_LAYERS of
# 28 layers there twice, make_serve_steps(cfg, mesh, fsdp=False) then
# fsdp=True: each rank holds its dp block of every large leaf and gathers
# each layer's over gloo as the layer runs (the embedding's once a call),
# so a decode step moves the model's bytes over the host; PM_FSDP_DECODE
# steps fed the fsdp=False run's greedy tokens.  Its logits must be the
# fsdp=False run's bit for bit.
# The five families that serve over ``model`` without training
# there join it at their published widths, depth cut in n_layers alone
# (PM_CUT: recurrentgemma-2b [rec, rec, local] over RG_PROMPT tokens, past
# its 2,048-token window; rwkv6-7b 2 blocks; deepseek-v3 [mla_dense] x 3 +
# [mla_moe]; whisper-large-v3 2 encoder and 2 decoder layers over 1,500
# frames with WHISPER_PROMPT-token prompts; llama-3.2-vision-11b
# [attn x 4, cross] over 1,601 context tokens).  The frames and the
# context are drawn from SEED on the card, and the cross layers' scalar
# gates from ±[0.3, 1.2] (pm_seed_gates): at the init's zero gates, or
# over a zero context, a cross layer is the identity and its heads would
# go unchecked.  Every model takes PM_DECODE decode steps (32 until the
# five joined; cut for the script's limit).
# deepseek-v3 is compared at the capacity that drops nothing
# (capacity_factor n_experts / top_k, so an expert's slots are the call's
# tokens) over A2A_NODROP_PROMPT-token prompts, as phase 5b's no-drop
# check: the a2a block sizes its capacity by the rank's tokens and the
# unsharded path's local block by the call's, so at the published 1.25
# the two drop different routes (the last prompt tokens first) and the
# comparison would hold the drops, not the sharding; at 512-token
# prompts the no-drop slots would be 7.5 GB a call.  On a model axis
# above 1 each rank then serves it again at the published capacity over
# SERVE_PROMPT-token prompts on the same weights (pm_capacity_run): one
# prefill and PM_DECODE steps fed its own greedy tokens, held for
# launches and finite logits, the drops those of the a2a block.
PM_MOE_LAYERS = 2
PM_DECODE = 8
PM_CUT = {"recurrentgemma-2b": dict(n_layers=3), "rwkv6-7b": dict(n_layers=2),
          DS_ARCH: dict(n_layers=4),
          WHISPER_ARCH: dict(n_layers=2, n_enc_layers=2),
          VISION_ARCH: dict(n_layers=5)}
PM_FSDP_LAYERS = 2
PM_FSDP_DECODE = 4
PM_WORLDS = (("nccl", (1, 1)), ("gloo", (1, 2)))
PM_FSDP = {(1, 2): (2, 1)}
PM_TP_TOL = 5e-2
# A MoE model's routes are a step function of x: at world 2 the bf16 sums
# over ``model`` run in another order and move x by a few roundings, and
# where a token's k-th and (k+1)-th router logits lie closer than that, a
# rank's top-k differs from the unsharded path's (deepseek-v3's top-8 of
# 256 leaves about 0.06 standard deviations between neighbours there).
# So that the logits are held to PM_TP_TOL with the same routes, every
# rank routes each of its tokens to the unsharded path's experts
# (RouteLog replays them, weighted by the rank's own router logits), and
# the routes are held apart: wherever the rank's own top-k differs, the
# replayed expert it would have left out lies within PM_ROUTE_TIE
# standard deviations of the token's float32 router logits below its own
# k-th (a wrong x moves routes by whole deviations).
PM_ROUTE_TIE = 0.05
PM_TIMEOUT_S = 600
# phase 7c, the training steps across processes (make_train_step on a
# ProcessMesh, default TrainConfig: AdamW, lr 3e-4, remat per block): a
# world of 1 on NCCL, mesh (1, 1), ZeRO stage 2, training llama3.2-3b at
# full width and depth on TRAIN_BATCH x TRAIN_SEQ tokens and the smoke
# llama4-maverick (a2a router) on TRAIN_BATCH x MOE_SMOKE_SEQ, PT_STEPS
# steps each, whose losses, grad norms, parameters and moments after each
# step must be the one-device step's bit for bit; then each world of
# PT_WORLDS, (backend, (data, model), ZeRO stage), two ranks sharing the
# card over gloo (NCCL refuses two ranks on one device; not a number
# between cards), training llama3.2-3b at full width cut to PT_LAYERS of
# 28 layers on TRAIN_BATCH x PT_SEQ tokens (and on (1, 2) the smoke
# llama4), held to the reference steps run in the parent.  The check that
# tells a wrong gradient from a right one is the first step's dp-mean
# gradient: each rank's blocks of it, as the ZeRO plan's push hands them
# to the optimizer, against the reference's gradient at the same weights
# and batch, leaf by leaf, ||got - want|| / ||want|| within PT_GRAD_TOL (a
# partial gradient, a factor of 2 or a missing sum over ``model`` puts a
# leaf 0.3 or more away).  Losses and grad norms, relative, within
# PT_LOSS_TOL.  Both limits come from readings on an NVIDIA H100 80GB
# HBM3 at 700 W and a bf16 control run in the parent on the dense model:
# the same first gradient as the float32 mean of each batch row's own
# gradient, and PT_STEPS steps with microbatches of one row, which differ
# from the reference only in the order of their bf16 roundings.  The
# control read 2.86e-3 on the gradient, 2.98e-5 on losses and 4.15e-5 on
# grad norms; the worlds read 2.86e-3 ((2, 1), stages 2 and 3), 1.21e-2
# ((1, 2)) and 1.25e-2 (llama4 on (1, 2)) on the gradient, and at most
# 3.09e-4 on losses and 2.28e-3 on grad norms (llama4's).  PT_GRAD_TOL is
# 2.4 times the largest gradient reading and a twelfth of what a planted
# fault read (the router's sum over ``model`` left out: 0.367 at smoke
# size); PT_LOSS_TOL 2.2 times the largest loss or grad-norm reading.
# The control must meet the limits too, or they sit below bf16's own
# spread.  Every
# parameter element is held, as a bound and not a test of the gradient,
# within what PT_STEPS AdamW steps can move it apart: a step moves an
# element by lr · (|m^ / (sqrt(v^) + eps)| + wd · |p|), |m^ / sqrt(v^)|
# stays below 1.2 over a few steps for beta1 0.9, beta2 0.95, and where
# the two paths' bf16 gradients of an element round apart (at |g| near
# eps, or near zero) its two moves may lie anywhere in that range, so up
# to PT_STEP_BOUND · lr · (1 + wd · |p|) apart a step; plus PT_ULPS · |p|
# for the bf16 roundings of the parameter itself (a few bf16 steps of
# 2^-8); the parameters must have moved.  Then a world of 2 on (2, 1)
# whose rank 1 leaves without a word at step 2 (``run_elastic``).
# In the (2, 1) stage-3 world the smoke whisper and rwkv6 also train
# (PT_SMOKE_SEQ tokens, their context synthesized), with FSDP_MIN_ELEMENTS
# lowered to 1 so that every leaf is split over ``data`` (at 2^20 no smoke
# leaf is), held to their one-device steps as the dense model is.  Each
# world in PT_POD, {flat mesh: (pod mesh, label of the model it trains)},
# also builds that (pod, data, model) mesh over the same ranks and trains
# the model there again from the same weights: it must step bit for bit
# as the flat mesh did (one dp group, the same ranks in the same order, so
# the same reductions).  World 1 takes the smoke llama4 (every collective
# is the identity there, and the dense model's full-depth digests cost
# seconds a step), world 2 the dense model.
PT_STEPS = 3
PT_LAYERS = 2
PT_SEQ = 1024
PT_SMOKE_SEQ = 64
PT_WORLDS = (("gloo", (2, 1), 2), ("gloo", (2, 1), 3), ("gloo", (1, 2), 2))
PT_LOSS_TOL = 5e-3
PT_GRAD_TOL = 3e-2
PT_STEP_BOUND = 2.5
PT_ULPS = 2.0 ** -6
PT_TIMEOUT_S = 900
# phase 7, the training path: llama3.2-3b at full width and depth, bf16,
# batches of TRAIN_BATCH x TRAIN_SEQ tokens (the train_4k shape's length),
# remat per block, AdamW, TRAIN_STEPS steps on one repeated batch
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6
# phase 7c's pod twins (above)
PT_POD = {(1, 1): ((1, 1, 1), f"{MOE_ARCH} smoke"),
          (2, 1): ((2, 1, 1), f"{TRAIN_ARCH} {PT_LAYERS} layers")}
# the other families' training paths, at full width and depth, batches of
# TRAIN_BATCH: recurrentgemma-2b and rwkv6-7b at train_4k's 4,096-token
# length; whisper-large-v3 with phase 5's 224-token text over its 1,500
# frames and llama-3.2-vision-11b with 512 tokens over its 1,601 context
# tokens (the pipeline's synthesized context); FAMILY_STEPS steps each
FAMILY_STEPS = 3
# the MoE family trains on the card at its smoke config (its published
# widths are refused for memory): llama4-maverick's, TRAIN_STEPS steps of
# TRAIN_BATCH x MOE_SMOKE_SEQ tokens
MOE_SMOKE_SEQ = 256
TRAIN_PATHS = [
    dict(arch=MOE_ARCH, seq=MOE_SMOKE_SEQ, optimizer="adamw", smoke=True,
         steps=TRAIN_STEPS),
    dict(arch="recurrentgemma-2b", seq=TRAIN_SEQ, optimizer="adamw"),
    dict(arch="rwkv6-7b", seq=TRAIN_SEQ, optimizer="adafactor"),
    dict(arch=WHISPER_ARCH, seq=WHISPER_PROMPT, optimizer="adamw"),
    dict(arch=VISION_ARCH, seq=SERVE_PROMPT, optimizer="adafactor",
         adam_dtype="bfloat16"),
]
# RG-LRU and WKV6 against their plain versions, as max abs error over
# max(1, max |plain|).  float32 rglru: the same operations per step (the
# decay terms from one float64 exponential rounded once on both sides, as
# ref._rglru_decay takes them on every device; the square root the
# hardware's, within an ulp), but the kernel's tiled scan
# adds each run's start state through the run's product of a (y = hl +
# A·h_in, runs of 8 or 16 steps, 8 runs folded a tile), a few more
# roundings of the size of h a step, and the recurrence contracts
# (|a| < 1), so rounding does not grow; float32 wkv6: every output sums 64
# products in another order, over a state summed across up to 512 steps;
# bfloat16 outputs add one rounding to bf16 (2^-8 relative).  Final states
# are float32 on both sides, so they take the float32 tolerance.
REC_TOL = {("rglru_scan", "float32"): 1e-5, ("wkv6", "float32"): 1e-4,
           ("rglru_scan", "bfloat16"): 1e-2, ("wkv6", "bfloat16"): 1e-2}
# The recurrences' backward kernels against their plain versions on the
# same inputs, element by element (:func:`elementwise_err`): |got - plain|
# <= rtol·|plain| + atol·s, s the root mean square of the plain output.
# Not against max |plain|: dlog_a's term a²x/b grows as 1/b where log_a
# nears 0 (b = sqrt(1 - a²) ~ 2e-4 at the training shape's smallest
# |log_a|), so its largest element is ~800x its RMS, and a limit scaled by
# it would pass a gate term wrong on every ordinary element.  atol·s: the
# float32 scans' rounding, which in dlog_a meets the 1/b factor where g is
# near 0 (an H100 reading: at most 0.2 of the limit, dlog_a at the
# training shape; dx and the WKV gradients at most 0.05).  rtol: float32
# outputs 1e-4, for reorderings of float32 sums; bf16 outputs round once
# to bf16, up to 2^-8 of the value, so 2^-7 (readings at most 0.498).
# Copies of the RG-LRU kernel with planted faults (``chip_bwd_faults.py``)
# fail it: its gate term dropped, 1% high, or 1% high only where b > 1/16,
# which the max-scaled limit passed in bf16.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 1e-4)}
# A training step's gradients, card against CPU, per leaf: max |card -
# cpu| <= 1e-4·max(1e-3, max |cpu|).  Float32 sums in other orders; the
# largest H100 reading is 1.13e-5 of the leaf's scale (rwkv6's
# ``time/wr``, through the WKV over 32 steps), 9x under the limit.
GRAD_TOL = (1e-4, 1e-3)
# The grouped matmul against its plain version on the same inputs and dtype,
# as max abs error over max(1, max |plain|): both sum up to 8192 float32
# products in other orders (rounding walks of ~2^-24·sqrt(8192) of the
# output's size); in bfloat16 each side then rounds once, so the outputs may
# differ by one bfloat16 step (2^-8 relative).
GMM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# llama4-maverick's expert shapes: d_model 5120, d_ff_expert 8192, 128
# experts; capacity 24 slots for a 4 x 512-token prefill, 8 for a decode step
MOE_D, MOE_F, MOE_E, MOE_C_PREFILL, MOE_C_DECODE = 5120, 8192, 128, 24, 8
# deepseek-v3's: d_model 7168, d_ff_expert 2048, 256 experts, top-8;
# capacity 80 slots for a 4 x 512-token prefill, 8 for a decode step; MLA
# with 128 heads: prefill q and k 128 + 64 wide, v 128; decode over the
# kv_lora 512 + rope 64 latent cache
DS_D, DS_F, DS_E, DS_K, DS_C_PREFILL, DS_C_DECODE = 7168, 2048, 256, 8, 80, 8
# their expert products at phase 7's training batch (TRAIN_BATCH x
# TRAIN_SEQ tokens): capacity 80 slots for top-1 over 128 experts, 320 for
# top-8 over 256
MOE_C_TRAIN, DS_C_TRAIN = 80, 320
# phase 3's expert-parallel smoke train steps: a (1, MOE_PARITY_TP) mesh
# (4 model shards: 1 of llama4's 4 smoke experts a shard, 2 of deepseek's 8)
MOE_PARITY_TP = 4
DS_HEADS, DS_DQK, DS_DV, DS_DLAT, DS_DROPE = 128, 192, 128, 576, 64


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sass_mma_count(_nvcc, name, kernel, op="HMMA"):
    """Tensor-core instructions in the SASS of each function of
    ``csrc/<name>.cu``'s library whose name holds ``kernel``, by
    ``cuobjdump -sass``: ``op`` HMMA (``mma.sync``) or HGMMA (Hopper's
    warpgroup ``wgmma``; the name does not hold "HMMA")."""
    lib = _nvcc.build(name)[name]
    tool = os.path.join(os.path.dirname(_nvcc._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and op in line:
            counts[fn] += 1
    return counts


def ptxas_usage(_nvcc, name, kernel):
    """Registers and spill bytes (stores, loads) of each function of
    ``csrc/<name>.cu`` whose name holds ``kernel``, from ``nvcc -Xptxas -v``:
    this process's build log, or a fresh build into a temporary file when
    the library was already built."""
    out = _nvcc.BUILD_LOGS.get(name)
    if out is None:
        tmp = _nvcc.BUILD / f"ptxas-{name}-{os.getpid()}.so"
        try:
            out = subprocess.run(
                [_nvcc._nvcc(), *_nvcc.FLAGS, "-o", str(tmp),
                 str(_nvcc.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, check=True,
                timeout=600).stdout
        finally:
            tmp.unlink(missing_ok=True)
    return parse_ptxas(out, kernel)


def parse_ptxas(out, kernel):
    """{function: [registers, spill store bytes, spill load bytes]} of the
    functions whose name holds ``kernel`` in ``-Xptxas -v`` output."""
    usage, fn = {}, None
    for line in out.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            fn = fn if kernel in fn else None
        elif fn and "spill stores" in line:
            parts = line.replace(",", "").split()
            usage[fn] = [None, int(parts[parts.index("spill") - 2]),
                         int(parts[parts.index("loads") - 3])]
        elif fn and "Used" in line and "registers" in line:
            usage[fn][0] = int(line.split("Used", 1)[1].split()[0])
            fn = None
    return usage


def check_flash_bwd_sm90_build(_nvcc):
    """Flash attention's backward at D 192 / 256
    (``csrc/flash_attention_bwd_sm90.cu``, route ``"wgmma"``): the dK/dV
    and dQ walks' two instances each run HGMMA (``wgmma``) and no HMMA,
    and none of the source's five kernels spills (``-Xptxas -v``)."""
    name = "flash_attention_bwd_sm90"
    for op, want in (("HGMMA", True), ("HMMA", False)):
        n = sass_mma_count(_nvcc, name, "_wgmma_kernelILi", op)
        check(len(n) == 4 and all((c > 0) == want for c in n.values()),
              f"the wgmma flash backward kernels' {op} counts: {n}")
        log(f"  cuobjdump -sass, {op} per wgmma flash backward kernel: {n}")
    usage = ptxas_usage(_nvcc, name, "_kernel")
    check(len(usage) == 5 and all(u[0] and not u[1] and not u[2]
                                  for u in usage.values()),
          f"the wgmma flash backward's kernels spill: {usage}")
    log("  -Xptxas -v, wgmma flash backward kernels [registers, spill "
        f"stores, spill loads]: {usage}")


def check_gmm_build(_nvcc):
    """The grouped matmul's tensor-core kernels run on the tensor cores and
    do not spill (``-Xptxas -v``): the forward's three row chunks
    (``csrc/moe_gmm.cu``, HMMA: ``mma.sync``), the input gradient's two
    instances (``csrc/moe_gmm_dx.cu``) and the weight gradient's kernel
    (``csrc/moe_gmm_dw.cu``), both HGMMA (``wgmma``) and no HMMA."""
    hmma = sass_mma_count(_nvcc, "moe_gmm", "gmm_mma")
    check(len(hmma) == 3 and all(n > 0 for n in hmma.values()),
          f"the bf16 gmm forward kernels lack tensor-core HMMA: {hmma}")
    log(f"  cuobjdump -sass, HMMA per tensor-core gmm forward kernel: "
        f"{hmma}")
    usage = ptxas_usage(_nvcc, "moe_gmm", "gmm_mma")
    check(len(usage) == 3 and all(u[0] and not u[1] and not u[2]
                                  for u in usage.values()),
          f"the tensor-core gmm kernels spill: {usage}")
    log("  -Xptxas -v, tensor-core gmm kernels [registers, spill stores, "
        f"spill loads]: {usage}")
    for name, kernel, n, what in (
            ("moe_gmm_dx", "gmm_dx_wgmma", 2, "input-gradient"),
            ("moe_gmm_dw", "gmm_dw_wgmma", 1, "weight-gradient")):
        hgmma = sass_mma_count(_nvcc, name, kernel, "HGMMA")
        hmma = sass_mma_count(_nvcc, name, kernel)
        check(len(hgmma) == n and all(c > 0 for c in hgmma.values())
              and not any(hmma.values()),
              f"the bf16 gmm {what} kernels lack wgmma (HGMMA {hgmma}, "
              f"HMMA {hmma})")
        log(f"  cuobjdump -sass, HGMMA per wgmma gmm {what} kernel: "
            f"{hgmma}")
        usage = ptxas_usage(_nvcc, name, "gmm_d")
        mma = {fn: u for fn, u in usage.items() if kernel in fn}
        check(len(mma) == n and all(u[0] and not u[1] and not u[2]
                                    for u in mma.values()),
              f"the wgmma gmm {what} kernels spill: {mma}")
        log(f"  -Xptxas -v, gmm {what} kernels [registers, spill stores, "
            f"spill loads]: {usage}")


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_calls(torch, fn, iters):
    """One ``torch.profiler`` session of ``iters`` calls of ``fn()``, after
    :data:`PREROLL_S` and :data:`LEAD_MARKS` marker kernels and before one:
    ({name: [count, total µs]} of the device operations (kernels, copies,
    fills) but the markers, lead markers seen, tail marker seen)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(PREROLL_S)
        for _ in range(LEAD_MARKS):
            torch.cuda._sleep(MARK_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    ops, marks, first = {}, [], float("inf")
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if MARK_KERNEL in e.name:
            marks.append(e.time_range.start)
            continue
        n, us = ops.get(e.name, (0, 0.0))
        ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
        first = min(first, e.time_range.start)
    lead = sum(t < first for t in marks)
    return ops, lead, len(marks) - lead


def whole_session(torch, fn, iters):
    """The operations of the first of up to :data:`PROFILER_SESSIONS`
    sessions of :func:`profiled_calls` that is whole: a lead marker and the
    tail marker seen, each operation's count a positive multiple of
    ``iters``.  Each session that is not logs its counts; when none is, the
    check fails."""
    for _session in range(PROFILER_SESSIONS):
        ops, lead, tail = profiled_calls(torch, fn, iters)
        MARKS_LOST[0] = max(MARKS_LOST[0], LEAD_MARKS - lead)
        counts = {k[:60]: n for k, (n, _us) in ops.items()}
        if lead and tail and ops \
                and not any(n % iters for n, _us in ops.values()):
            return ops
        SESSIONS_RUN_AGAIN[0] += 1
        log(f"  profiler: session of {iters} calls not whole ({lead} of "
            f"{LEAD_MARKS} lead markers, {tail} of 1 tail marker seen): "
            f"{json.dumps(counts)}")
    raise SmokeFailure(f"torch.profiler lost device records in each of "
                       f"{PROFILER_SESSIONS} sessions of {iters} calls; "
                       f"the last: {counts}")


def device_ops(torch, fn, iters):
    """The device operations of ``iters`` calls of ``fn()`` under
    ``torch.profiler``, as {name: count}, from a whole session
    (:func:`whole_session`)."""
    fn()
    return {name: n for name, (n, _us) in
            whole_session(torch, fn, iters).items()}


def device_ms(fn, iters):
    """Device time of one ``fn()`` call from ``torch.profiler`` over
    ``iters`` calls: for each kernel, copy or fill the calls ran on the
    card, its mean duration times the number of times one call runs it —
    without the host time between launches that :func:`cuda_ms` also sees
    when the calls are host-bound."""
    import torch
    for _ in range(3):
        fn()
    return sum(us / n * max(1, round(n / iters)) for n, us in
               whole_session(torch, fn, iters).values()) / 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(torch, rdma, slots):
    """Inputs at the main path's shapes: R = B request lanes per
    participant for descriptors, N = P·B served/committed lanes per home on
    a (P, slots, W+3) int32 row buffer.  Each kernel's first cases are the
    argument forms the verbs pass (``colls._serve_scatter`` and
    ``remote_write_batch``): int32 targets and indices, bool masks, the
    read verb's ``wire`` left to default to ``en``, and one index vector
    broadcast to every home with ``expand`` (row stride 0); the first case
    is the one phase 6 times.  Then int32 masks and contiguous indices,
    the row commit's indices outside [0, slots) and its odd layouts on the
    write verb's forms."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    N = P * B
    width = W + 3

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def bools(shape):
        return ints(0, 2, shape) != 0

    def verb_masks(targets, en):
        """The read verb's home mask: lane l of the P·B flattened lanes is
        served by home h iff it targets h and rides the wire."""
        homes = torch.arange(P, dtype=torch.int32, device=dev)[:, None]
        return (targets.reshape(-1)[None, :] == homes) & en.reshape(-1)[None, :]

    buf = ints(-2 ** 31, 2 ** 31 - 1, (P, slots, width))
    tg, ix = ints(0, P, (P, B)), ints(0, slots, (P, B))
    preds, remote = bools((P, B)), bools((P, B))
    cases = {
        "build_descriptors": [
            ("write verb: bool en and wire",
             (tg, ix, preds), dict(wire=preds & remote, op=rdma.OP_WRITE,
                                   row_nbytes=4 * width)),
            ("read verb: bool en, wire defaults to en",
             (tg, ix, remote), dict(op=rdma.OP_READ, row_nbytes=4 * width)),
            ("int32 masks", (ints(0, P, (P, B)), ints(0, slots, (P, B)),
                             ints(0, 2, (P, B))),
             dict(wire=ints(0, 2, (P, B)), op=rdma.OP_WRITE,
                  row_nbytes=4 * width)),
            ("bool en, int32 wire", (tg, ix, preds),
             dict(wire=ints(0, 2, (P, B)), op=rdma.OP_WRITE,
                  row_nbytes=4 * width)),
            ("no wire lane", (tg, ix, torch.zeros((P, B), dtype=torch.bool,
                                                  device=dev)),
             dict(op=rdma.OP_READ, row_nbytes=4 * width))],
        "gather_rows": [
            ("read verb: broadcast index, bool mask",
             (buf, ints(0, slots, (N,))[None, :].expand(P, -1),
              verb_masks(tg, remote)), {}),
            ("read verb: all masked",
             (buf, ints(0, slots, (N,))[None, :].expand(P, -1),
              torch.zeros((P, N), dtype=torch.bool, device=dev)), {}),
            ("int32 mask, contiguous index",
             (buf, ints(0, slots, (P, N)), ints(0, 2, (P, N))), {}),
            ("all masked, int32",
             (buf, ints(0, slots, (P, N)),
              torch.zeros((P, N), dtype=torch.int32, device=dev)), {})],
        "scatter_rows": [],
    }
    vals = ints(-2 ** 31, 2 ** 31 - 1, (P, N, width))
    # the write verb's forms: one index vector broadcast to every home,
    # bool apply and wire masks
    win = verb_masks(tg, preds)
    cases["scatter_rows"].append(
        ("write verb: broadcast index, bool masks",
         (buf, ints(0, slots, (N,))[None, :].expand(P, -1), vals, win,
          win & bools((P, N))), {}))
    for name, idx in [("random", ints(0, slots, (P, N))),
                      ("all lanes one row", torch.full((P, N), 7,
                                                       dtype=torch.int32,
                                                       device=dev)),
                      ("random duplicates", ints(0, 64, (P, N)))]:
        apply = ints(0, 2, (P, N))
        cases["scatter_rows"].append(
            (name, (buf, idx, vals, apply, apply * ints(0, 2, (P, N))), {}))
    # odd layouts on the write verb's forms: rows one word wide (the log's
    # rejoin); homes of 1023 x 5 words, not a multiple of 4, so that home
    # starts fall off 16 bytes; a buffer whose base is off 16 bytes (the
    # word-by-word route); duplicates in each
    # indices outside [0, slots): one in [-slots, 0) wraps to the end of the
    # buffer, one >= slots or < -slots is dropped; the edges -1, -slots,
    # slots, slots + 3 and -slots - 1 in every home, the rest drawn from
    # [-2 slots, 2 slots), on an int32 index and bool masks
    odd = ints(-2 * slots, 2 * slots, (P, N))
    odd[:, :5] = torch.tensor([-1, -slots, slots, slots + 3, -slots - 1],
                              dtype=torch.int32, device=dev)
    apply = bools((P, N))
    cases["scatter_rows"].append(
        ("indices outside [0, slots)",
         (buf, odd, vals, apply, apply & bools((P, N))), {}))
    for name, n_slots, width, off in [("1-word rows", slots, 1, 0),
                                      ("home words % 4 == 3", 1023, 5, 0),
                                      ("base off 16 bytes", 4099, 5, 1)]:
        flat = ints(-2 ** 31, 2 ** 31 - 1, (P * n_slots * width + off,))
        b = flat[off:].view(P, n_slots, width)
        apply = bools((P, N))
        cases["scatter_rows"].append(
            (f"write verb, {name}",
             (b, ints(0, min(n_slots, 512), (N,))[None, :].expand(P, -1),
              ints(-2 ** 31, 2 ** 31 - 1, (P, N, width)), apply,
              apply & bools((P, N))), {}))
    return cases


#: Phase-2 cases on the verbs' argument forms whose calls must each be one
#: device operation: the kernel's launch and nothing else (no cast, copy or
#: fill), by ``torch.profiler``.
ONE_OP = {"build_descriptors": ("build_desc_kernel", 2),
          "gather_rows": ("gather_rows_kernel", 2),
          "scatter_rows": ("scatter_rows_kernel", 1)}


PLAIN = {"build_descriptors": "_build_desc_ref", "gather_rows": "_gather_ref",
         "scatter_rows": "_scatter_ref"}


def plain_call(torch, rdma, name, args, kw):
    """The kernel's plain PyTorch version on the same (card) tensors."""
    if name == "build_descriptors":
        tg, ix, en = args
        return rdma._build_desc_ref(tg, ix, en, kw.get("wire", en),
                                    kw["op"], kw["row_nbytes"])
    buf = args[0]
    row_nbytes = buf.shape[2] * buf.element_size()
    return getattr(rdma, PLAIN[name])(*args, row_nbytes)


def max_abs_err(torch, got, exp):
    err = 0.0
    for a, b in zip(got, exp):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
              f"{tuple(b.shape)} {b.dtype}")
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def phase_kernels(torch, rdma, slots):
    cases = kernel_cases(torch, rdma, slots)
    errs = {}
    for name, runs in cases.items():
        kern = getattr(rdma, name)
        errs[name] = 0.0
        for label, args, kw in runs:
            before = kern.launches
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            exp = plain_call(torch, rdma, name, args, kw)
            e = max_abs_err(torch, got, exp)
            check(e == 0.0, f"{name} ({label}) differs from its plain "
                            f"version: max abs err {e}")
            errs[name] = max(errs[name], e)
            log(f"  {name} [{label}]: bitwise equal to the plain version")
    for name, (kernel, n_cases) in ONE_OP.items():
        kern = getattr(rdma, name)
        for label, args, kw in cases[name][:n_cases]:
            ops = device_ops(torch, lambda: kern(*args, **kw), 50)
            check(list(ops.values()) == [50] and kernel in next(iter(ops)),
                  f"{name} ({label}): 50 calls ran {ops} on the card, not "
                  f"one kernel each")
            log(f"  {name} [{label}]: one device operation per call "
                f"(torch.profiler, 50 calls)")
    return cases, errs


def copy_cases(torch):
    """(label, src, dst, sender) at the ring hop's shapes — the packed
    publish of the engine's log (P = 4, a 640-word entry and its metadata,
    648 words) and of the failover phase's (P = 8, 20,480 + 8 words) — at
    the bare entries, and at odd ones."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def words(n_rows, n):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, n), generator=g,
                             device="cuda", dtype=torch.int32)

    def bcast(n_rows, owner):
        s = torch.full((n_rows,), owner, dtype=torch.int32, device="cuda")
        s[owner] = -1
        return s

    cases = []
    for n_rows, n in [(4, 648), (8, 20488), (4, 640), (8, 20480), (4, 643)]:
        cases.append((f"broadcast P={n_rows} n={n}", words(n_rows, n),
                      words(n_rows, n), bcast(n_rows, 1)))
    flat_s, flat_d = words(1, 4 * 101 + 1)[0], words(1, 4 * 101 + 1)[0]
    cases.append(("misaligned view P=4 n=101", flat_s[1:].view(4, 101),
                  flat_d[1:].view(4, 101), bcast(4, 2)))
    cases.append(("n=0", words(4, 0), words(4, 0), bcast(4, 0)))
    full = (words(8, 20480), words(8, 20480))
    cases.append(("no senders", *full,
                  torch.full((8,), -1, dtype=torch.int32, device="cuda")))
    cases.append(("every receiver from one sender", *full,
                  torch.full((8,), 3, dtype=torch.int32, device="cuda")))
    cases.append(("permutation", *full,
                  torch.randperm(8, generator=g, device="cuda").to(
                      torch.int32)))
    # int64 maps, taken as they are: the hop shapes, and values that an
    # int32 cast would wrap into [0, P)
    for n_rows, n in [(8, 20488), (4, 648)]:
        cases.append((f"int64 map broadcast P={n_rows} n={n}",
                      words(n_rows, n), words(n_rows, n),
                      bcast(n_rows, 2).to(torch.int64)))
    cases.append(("int64 map past int32", *full, torch.tensor(
        [2 ** 32 + 1, -1, 2 ** 33, 1, -2 ** 32 + 3, 0, 5, 2 ** 31],
        dtype=torch.int64, device="cuda")))
    return cases


def phase_copy_kernel(torch, rdma):
    """remote_copy against _remote_copy_ref on the same card tensors:
    outputs and both byte vectors bitwise equal.  Returns the cases and
    each case's measured max abs err by label."""
    cases = copy_cases(torch)
    errs = {}
    for label, src, dst, sender in cases:
        before = rdma.remote_copy.launches
        got = rdma.remote_copy(src, dst, sender)
        torch.cuda.synchronize()
        check(rdma.remote_copy.launches == before + 1,
              "remote_copy did not launch")
        exp = rdma._remote_copy_ref(src, dst, sender)
        e = max_abs_err(torch, got, exp)
        check(e == 0.0, f"remote_copy ({label}) differs from its plain "
                        f"version: max abs err {e}")
        errs[label] = e
        log(f"  remote_copy [{label}]: bitwise equal to the plain version, "
            f"bytes included")
    for label, src, dst, sender in cases[:2] + cases[-3:-1]:
        ops = device_ops(torch, lambda: rdma.remote_copy(src, dst, sender),
                         50)
        check(list(ops.values()) == [50] and "remote_copy_kernel" in
              next(iter(ops)), f"remote_copy ({label}): 50 calls ran "
                               f"{ops} on the card, not one kernel each")
        log(f"  remote_copy [{label}]: one device operation per call "
            f"(torch.profiler, 50 calls)")
    return cases, errs


# The hop between processes (remote_copy_peers): worlds of 2 and P ranks
# sharing the card over gloo, each rank one participant, at the log entry's
# packed shape at P = 8 (20,480 words and their metadata, 20,488), an odd
# width and zero words.
PEER_WORLDS = (2, P)
PEER_SHAPES = (20488, 643, 0)
PEER_TIMEOUT_S = 300
PEER_GLOO = "gloo on one card, not a number between cards"


def peer_maps(nodes):
    """(label, sender map) of phase 2's hop between ``nodes`` ranks: a
    broadcast from 0 and from 5 (the last rank in a smaller world), nobody
    sending, every rank naming itself, a permutation, out-of-range entries
    (int32, and an int64 map past int32)."""
    rng = np.random.default_rng(SEED + 13)
    five = min(5, nodes - 1)

    def bcast(o):
        return np.asarray([-1 if q == o else o for q in range(nodes)],
                          np.int32)
    oor = np.asarray([nodes, -1, -5, 2 ** 31 - 1, 1, nodes + 3, 0, -2 ** 31]
                     [:nodes], np.int32)
    past = np.asarray([2 ** 32 + 1, -1, 2 ** 33, 1, -2 ** 32 + 3, 0, 5,
                       2 ** 31][:nodes], np.int64)
    return [("broadcast from 0", bcast(0)),
            (f"broadcast from {five}", bcast(five)),
            ("no senders", np.full(nodes, -1, np.int32)),
            ("every rank itself", np.arange(nodes, dtype=np.int32)),
            ("permutation", rng.permutation(nodes).astype(np.int32)),
            ("out of range", oor), ("int64 map past int32", past)]


def rank_device_ms(torch, rt, fn, iters):
    """:func:`device_ms` on one rank of a world whose ranks all call ``fn``
    (a collective) at once: each rank runs the same profiler sessions, a
    session is taken when it is whole on every rank (one all-reduce
    decides, so every rank runs as many sessions).  Returns (device ms a
    call, {operation: [count, device ms] a call})."""
    for _session in range(PROFILER_SESSIONS):
        ops, lead, tail = profiled_calls(torch, fn, iters)
        whole = bool(lead and tail and ops and not any(
            n % iters for n, _us in ops.values()))
        if not rt.any(not whole):
            per = {k[:60]: [n // iters, us / iters / 1e3]
                   for k, (n, us) in ops.items()}
            return sum(ms for _n, ms in per.values()), per
        SESSIONS_RUN_AGAIN[0] += 1
    raise SmokeFailure(f"torch.profiler lost device records on some rank "
                       f"in each of {PROFILER_SESSIONS} sessions")


def peer_rank(rank, nodes):
    """One rank of a phase-2 world (spawned; the kernels built): for each
    case of :func:`peer_maps` at each of PEER_SHAPES, its row of seeded
    words and its entry of the map through ``remote_copy_peers`` (one
    launch) and through its plain version on the same card tensors, and,
    where every entry names a rank, through ``Runtime.bcast``; in the world
    of P also the timing of the hop at PEER_SHAPES[0], a broadcast from 0.
    Returns each case's verdicts and the timing."""
    import torch

    import repro_torch.core as pt
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(nodes)
    rt = pt.make_manager(nodes, mesh=mesh).runtime
    windows = rdma.PeerWindows(rt)
    g = torch.Generator().manual_seed(SEED + 14)
    cases = []
    for n in PEER_SHAPES:
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (nodes, n), generator=g,
                              dtype=torch.int32)
        w = words[rank:rank + 1].to(mesh.device)
        for label, smap in peer_maps(nodes):
            s = torch.from_numpy(smap[rank:rank + 1]).to(mesh.device)
            before = rdma.remote_copy_peers.launches
            got = rdma.remote_copy_peers(w, s, windows)
            torch.cuda.synchronize()
            exp = rdma._remote_copy_peers_ref(w, s, rt)
            bcast = None
            if ((smap >= -1) & (smap < nodes)).all():
                # -1 keeps the rank's own row: the broadcast from itself
                owner = np.where(smap < 0, np.arange(nodes), smap)
                bcast = torch.equal(got[0], rt.bcast(w, torch.from_numpy(
                    owner[rank:rank + 1]).to(mesh.device)))
            cases.append(dict(label=f"{label} n={n}",
                              launched=rdma.remote_copy_peers.launches
                              - before, err=max_abs_err(torch, got, exp),
                              bcast=bcast))
    out = dict(rank=rank, cases=cases, hops=windows.hops,
               transports=dict(mesh.transports))
    if nodes == P:
        n = PEER_SHAPES[0]
        w = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, n), generator=g,
                          dtype=torch.int32).to(mesh.device)
        s = torch.tensor([-1 if rank == 0 else 0], dtype=torch.int32,
                         device=mesh.device)
        got = rdma.remote_copy_peers(w, s, windows)
        err = max_abs_err(torch, got, rdma._remote_copy_peers_ref(w, s, rt))
        dev, ops = rank_device_ms(
            torch, rt, lambda: rdma.remote_copy_peers(w, s, windows), 50)
        kernel = [ms for k, (_n, ms) in ops.items()
                  if "remote_copy_peers_kernel" in k]
        check(len(kernel) == 1, f"no remote_copy_peers_kernel among the "
                                f"hop's device operations {ops}")
        out["timing"] = dict(
            n=n, err=err, device_ms=dev, kernel_device_ms=kernel[0],
            device_ops=ops,
            ms=cuda_ms(lambda: rdma.remote_copy_peers(w, s, windows), 50),
            plain_ms=cuda_ms(lambda: rdma._remote_copy_peers_ref(w, s, rt),
                             50),
            library_ms=cuda_ms(lambda: rt.bcast(w, 0), 50),
            # one row read (the owner's window), one written, the map read
            # and the two counters written
            nbytes=2 * 4 * n + 4 * nodes + 2 * 4)
    windows.close()
    return out


def phase_peer_copy_kernel(torch, card):
    """remote_copy_peers against its plain version between processes: for
    each world of PEER_WORLDS (spawned with the kernel built), every rank's
    row and both byte counters bitwise the plain version's (a gather and a
    select, ``Runtime.bcast``) on the same card tensors, and its row
    ``Runtime.bcast``'s where the map names ranks only; one launch a hop.
    The first world is the IPC probe: two processes opening each other's
    windows.  Returns each world's cases and the world of P's rank 0
    timing."""
    from repro_torch.launch.world import spawn_world
    out = {}
    for nodes in PEER_WORLDS:
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(peer_rank, nodes, backend="gloo",
                                device=None, args=(nodes,),
                                timeout_s=PEER_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 2 remote_copy_peers, world of "
                               f"{nodes}: {e}") from None
        for r in ranks:
            for c in r["cases"]:
                what = f"remote_copy_peers world {nodes} rank {r['rank']} " \
                       f"[{c['label']}]"
                check(c["launched"] == 1, f"{what}: {c['launched']} launches")
                check(c["err"] == 0.0, f"{what}: differs from the plain "
                                       f"version, max abs err {c['err']}")
                check(c["bcast"] in (None, True),
                      f"{what}: differs from Runtime.bcast")
        n_bcast = sum(c["bcast"] is True for c in ranks[0]["cases"])
        log(f"  remote_copy_peers, world of {nodes} ({PEER_GLOO}): "
            f"{len(ranks[0]['cases'])} cases on every rank, rows and byte "
            f"counters bitwise the plain version's, {n_bcast} of them also "
            f"Runtime.bcast's; one launch a hop; transports "
            f"{ranks[0]['transports']}; {time.perf_counter() - t0:.1f} s "
            f"with start-up; {card}")
        out[nodes] = ranks
    return out


def peer_copy_report(peer, launches):
    """remote_copy_peers' row: the hop between processes at the log entry's
    packed shape at P = 8 (20,488 words), a broadcast from rank 0, timed on
    rank 0 of phase 2's world of P (over gloo on one card): the wrapper's
    time (CUDA events, the all-gather of the sender map included), the
    device time and operations a call (torch.profiler), the plain version's
    time, and ``Runtime.bcast`` over the same world as the library
    yardstick (one PyTorch all-gather and a select; the port's hop never
    calls it on the card).  Bound: one row read and one written, the map and
    the counters, at the memory rate.  ``launches``: phase 4g's ranks' by
    path."""
    t = peer[P][0]["timing"]
    m = dict(ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
             library_ms=t["library_ms"], nbytes=t["nbytes"], flops=0)
    paths = {k: v["remote_copy_peers"] for k, v in launches.items()
             if "remote_copy_peers" in v}
    row = dict(name="remote_copy_peers", route="cuda",
               source="src/repro_torch/kernels/csrc/remote_copy_peers.cu",
               replaces="src/repro/kernels/remote_dma.py:239")
    row.update(timing_row(m, paths[f"4g gloo world {P} rank 0"], t["err"],
                          F32_FLOPS))
    row["kernel_device_ms"] = t["kernel_device_ms"]
    row["device_ops_per_call"] = {k: n for k, (n, _ms) in
                                  t["device_ops"].items()}
    row["launches_paths"] = paths
    row["shape"] = f"rank 0 of {P}, n={t['n']}, broadcast from 0 " \
                   f"({PEER_GLOO})"
    log(f"  remote_copy_peers [{row['shape']}]: {t['ms']:.4f} ms/call "
        f"(device {t['device_ms']:.5f}, the kernel "
        f"{t['kernel_device_ms']:.5f}; ops {t['device_ops']}), bound "
        f"{row['bound_ms']:.6f} ms (bytes; {t['nbytes'] / 1e3:.1f} KB), "
        f"plain {t['plain_ms']:.4f} ms, Runtime.bcast "
        f"{t['library_ms']:.4f} ms, launches {paths}")
    return [row]


def copy_nbytes(sender, n):
    """Bytes remote_copy must move for ``sender`` over (P, n) int32 rows:
    each distinct row read once — a sender's row of src, and dst's row of
    each receiver that keeps its own — all P rows written once, the sender
    map read and the two (P,) byte counters written."""
    s = sender.tolist()
    P = len(s)
    peers = [v for q, v in enumerate(s) if 0 <= v < P and v != q]
    rows_read = len(set(peers)) + P - len(peers)
    return (rows_read + P) * n * 4 + 4 * P + 2 * 4 * P


def cross_shape(arch):
    """(query heads, kv heads, head dim, context tokens) of a cross family's
    published config, the shapes phase 5 serves it at."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.cross.n_context_tokens)


def attention_cases(torch):
    """(label, args, kw) per attention case: the serving paths' full-width
    shapes in bf16 and float32 — llama3.2-3b (24 query heads, 8 kv heads,
    head_dim 128; prefill of 4 prompts of 512 tokens, decode against a
    544-slot cache) and recurrentgemma-2b's local attention (10 query heads
    on 1 kv head, head_dim 256; prefill of 4 prompts of 2304 tokens with a
    2048-token window, decode against the 2048-slot ring) — then odd shapes
    and masks, then the cross-attention paths': whisper's bidirectional
    encoder (20 heads of 64 over 1,500 frames, G 1), its decoder's cross
    prefill (224 queries over 1,500 keys) and both its decodes (the full
    1,500-slot context cache; the 256-slot self cache at lengths 224, 225,
    256 and 1), and llama-3.2-vision's cross prefill (512 queries over
    1,601 context keys, 32 heads on 8) and cross decode (every length
    1,601) — non-causal with Sq ≠ Sk and a ragged last key tile (1,500 =
    11·128 + 92, 1,601 = 12·128 + 65)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    wh, wkv, wd, wctx = cross_shape(WHISPER_ARCH)
    vh, vkv, vd, vctx = cross_shape(VISION_ARCH)

    def rn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    def lens(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def bhsd(B, H, S, D, dt):
        """(B, H, S, D) view of a (B, S, H, D) projection, as the models
        pass q, k and v."""
        return rn((B, S, H, D), dt).transpose(1, 2)

    def misaligned(B, H, S, D, dt):
        """(B, H, S, D) one element into its buffer: bf16 rows off 16
        bytes, for the CUDA-core route."""
        flat = rn((B * H * S * D + 1,), dt)
        return flat[1:].view(B, H, S, D)

    def mla_v(B, H, S, D, dt):
        """MLA's prefill v: (B, H, S, 192) view of a (B, S, H, 128)
        projection zero-padded to 192, as ``mla_attention`` passes it."""
        return torch.nn.functional.pad(rn((B, S, H, DS_DV), dt),
                                       (0, D - DS_DV)).transpose(1, 2)

    flash, decode = [], []
    Bf, Hq, Hkv, D = SERVE_BATCH, 24, 8, 128
    for label, (B, hq, hkv, sq, sk, d), kw, make in [
            ("full width", (Bf, Hq, Hkv, SERVE_PROMPT, SERVE_PROMPT, D),
             dict(causal=True), bhsd),
            ("D=256 window full width", (Bf, 10, 1, RG_PROMPT, RG_PROMPT, 256),
             dict(causal=True, window=2048), bhsd),
            ("D=256 odd", (2, 10, 1, 140, 140, 200), dict(causal=True,
                                                          window=50), None),
            ("offset causal", (2, 6, 2, 100, 300, D), dict(causal=True), None),
            ("window", (2, 8, 4, 200, 200, 64), dict(causal=True, window=48),
             None),
            ("padded Sk", (1, 4, 2, 130, 130, D), dict(causal=True), None),
            ("Sq not a tile multiple", (3, 4, 4, 77, 77, 16),
             dict(causal=False), None),
            ("rows with no key", (1, 2, 1, 16, 8, 8), dict(causal=True), None),
            ("views D=64 Sq=200", (2, 8, 2, 200, 200, 64), dict(causal=True),
             bhsd),
            ("views D=128 Sq=100", (2, 8, 4, 100, 100, 128), dict(causal=True),
             bhsd),
            ("views D=256 window Sq=333", (1, 10, 1, 333, 333, 256),
             dict(causal=True, window=100), bhsd),
            ("views D=200", (2, 4, 2, 150, 150, 200), dict(causal=True), bhsd),
            ("views D=160", (2, 8, 2, 150, 150, 160), dict(causal=True), bhsd),
            ("Sk ragged", (2, 8, 4, 70, 190, 128), dict(causal=False), bhsd),
            ("Sk ragged causal", (2, 8, 4, 64, 150, 128), dict(causal=True),
             bhsd),
            ("misaligned rows", (2, 8, 4, 100, 100, 128), dict(causal=True),
             misaligned),
            ("MLA prefill full width", (Bf, DS_HEADS, DS_HEADS, SERVE_PROMPT,
                                        SERVE_PROMPT, DS_DQK),
             dict(causal=True, sm_scale=DS_DQK ** -0.5), bhsd),
            ("whisper encoder", (Bf, wh, wkv, wctx, wctx, wd),
             dict(causal=False), bhsd),
            ("whisper cross", (Bf, wh, wkv, WHISPER_PROMPT, wctx, wd),
             dict(causal=False), bhsd),
            ("vision cross", (Bf, vh, vkv, SERVE_PROMPT, vctx, vd),
             dict(causal=False), bhsd)]:
        for dt in (torch.bfloat16, torch.float32):
            if make is None:
                args = (rn((B, hq, sq, d), dt), rn((B, hkv, sk, d), dt),
                        rn((B, hkv, sk, d), dt))
            else:
                args = (make(B, hq, sq, d, dt), make(B, hkv, sk, d, dt),
                        (mla_v if label.startswith("MLA") else make)(
                            B, hkv, sk, d, dt))
            flash.append((f"{label} {str(dt)[6:]}", args, kw))
    S = SERVE_PROMPT + SERVE_GEN
    for label, (B, hq, hkv, s, d), ln in [
            ("full width", (Bf, Hq, Hkv, S, D), [0, 1, S, 300]),
            ("D=256 ring full width", (Bf, 10, 1, 2048, 256),
             [2048, 2048, 1, 1000]),
            ("D=256 odd", (3, 10, 1, 70, 136), [70, 0, 33]),
            ("smoke shapes", (2, 4, 2, 48, 12), [48, 5]),
            ("group of 16", (3, 16, 1, 100, 64), [100, 63, 64]),
            ("lengths 0 1 64 65 S, S=300", (5, 8, 2, 300, 128),
             [0, 1, 64, 65, 300]),
            ("S=1000 not a chunk multiple", (1, 10, 1, 1000, 256), [1000]),
            ("one live chunk", (2, 10, 1, 2048, 256), [50, 64]),
            ("group of 20", (3, 40, 2, 130, 128), [130, 0, 65]),
            ("MLA lengths 0 1 64 65 S", (5, DS_HEADS, 1, S, DS_DLAT),
             [0, 1, 64, 65, S]),
            ("MLA full width", (Bf, DS_HEADS, 1, S, DS_DLAT),
             [S, S - 16, 300, 1]),
            ("MLA one live chunk", (2, DS_HEADS, 1, S, DS_DLAT), [50, 64]),
            ("MLA D=300 group of 20", (2, 20, 1, 100, 300), [100, 7]),
            ("whisper cross", (Bf, wh, wkv, wctx, wd), [wctx] * Bf),
            ("whisper self", (Bf, wh, wkv, WHISPER_PROMPT + SERVE_GEN, wd),
             [WHISPER_PROMPT, WHISPER_PROMPT + 1,
              WHISPER_PROMPT + SERVE_GEN, 1]),
            ("vision cross", (Bf, vh, vkv, vctx, vd), [vctx] * Bf)]:
        # float32 past D = 256 is refused (mla_decode_f32_refused)
        for dt in (torch.bfloat16,) if d > 256 else (torch.bfloat16,
                                                     torch.float32):
            kw = dict(sm_scale=DS_DQK ** -0.5) if label.startswith("MLA") \
                else {}
            decode.append((f"{label} {str(dt)[6:]}",
                           (rn((B, hq, d), dt), rn((B, hkv, s, d), dt),
                            rn((B, hkv, s, d), dt), lens(ln)), kw))
    return {"flash_attention": flash, "decode_attention": decode}


def mla_decode_f32_refused(torch, kernels):
    """The decode kernel takes float32 only up to D = 256 (its two 64-key
    float32 tiles at D = 576 would not fit a block's shared memory): the
    wrapper must refuse MLA's latent shape in float32 with a clear error,
    and launch nothing."""
    from repro_torch.kernels import decode_attention as dec
    kern = kernels["decode_attention"]
    q = torch.zeros((1, DS_HEADS, DS_DLAT), device="cuda")
    kc = torch.zeros((1, 1, 64, DS_DLAT), device="cuda")
    ln = torch.ones(1, dtype=torch.int32, device="cuda")
    before = kern.launches
    try:
        kern(q, kc, kc, ln)
    except ValueError as e:
        check(kern.launches == before and f"<= {dec.MAX_HEAD_DIM_F32}" in
              str(e), f"decode_attention's float32 refusal: {e}")
        log(f"  decode_attention [MLA float32]: refused ({e})")
        return
    raise SmokeFailure("decode_attention took float32 at D = 576")


def flash_route(args):
    """The flash kernel the wrapper picks for these inputs."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    return fa._variant(q.dtype, q.shape[3],
                       (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]),
                       (q.data_ptr(), k.data_ptr(), v.data_ptr()))


def attention_plain(name, args, kw):
    """The kernel's plain PyTorch version, in float32, on the same (card)
    inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    if name == "flash_attention":
        q, k, v = (t.float() for t in args)
        offset = fa._padded(k.shape[2]) - fa._padded(q.shape[2])
        return ref.mha(q, k, v, offset=offset, **kw)
    q, kc, vc, ln = args
    return ref.decode_attention(q.float(), kc.float(), vc.float(), ln, **kw)


def phase_attention_kernels(torch, kernels):
    cases = attention_cases(torch)
    errs = {}
    for name, runs in cases.items():
        kern = kernels[name]
        errs[name] = 0.0
        for label, args, kw in runs:
            before = kern.launches
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            check(got.dtype == args[0].dtype and got.shape == args[0].shape,
                  f"{name} ({label}): {got.dtype} {tuple(got.shape)}")
            exp = attention_plain(name, args, kw)
            e = float((got.float() - exp).abs().max())
            tol = ATTN_TOL[str(got.dtype)[6:]]
            check(e <= tol, f"{name} ({label}) differs from its plain "
                            f"version: max abs err {e} > {tol}")
            if label.startswith("rows with no key"):
                check(not got[:, :, :8].any(), f"{name} ({label}): rows "
                                               f"with no visible key not 0")
            if label.startswith("MLA prefill"):
                check(not got[..., DS_DV:].any(), f"{name} ({label}): the "
                      f"zero-padded v gave non-zero output columns")
            route = ""
            if name == "decode_attention":
                check(not got[args[3] == 0].any(),
                      f"{name} ({label}): length-0 rows not zero")
            else:
                route = flash_route(args)
                want = "simt" if "float32" in label or "misaligned" in label \
                    or args[0].shape[3] % 8 else "mma"
                check(route == want, f"{name} ({label}) took the {route} "
                                     f"kernel, not {want}")
                route = f", {route} kernel"
            errs[name] = max(errs[name], e)
            log(f"  {name} [{label}]: max abs err {e:.3g} (tolerance {tol})"
                f"{route}")
    mla_decode_f32_refused(torch, kernels)
    from repro_torch.kernels import decode_attention as dec
    check(dec._ARRIVALS and all(not bool(b.any())
                                for b in dec._ARRIVALS.values()),
          "decode_attention left an arrival counter non-zero")
    log(f"  decode_attention arrival counters all zero "
        f"({sum(b.numel() for b in dec._ARRIVALS.values())} counters)")
    return cases, errs


def recurrent_cases(torch):
    """(label, args) per recurrent case, in bf16 and float32: the serving
    paths' full-width shapes — recurrentgemma-2b's RG-LRU over 4 prompts of
    2304 tokens and 2560 channels, rwkv6-7b's WKV over 4 prompts of 512
    tokens and 64 heads of 64, its inputs (B, H, S, D) views of (B, S, H, D)
    projections as the model passes them — then odd shapes (S not a
    multiple of any chunk; D = 100 channels; head sizes 16, 32 and 48), and
    for RG-LRU runs of log_a = 0 (a fifth of it, and steps 100-399 all 0:
    a = 1, gate 0), strong decays (log_a in [-30, -10]), 4096 steps at full
    width, D = 2568 (no multiple of the kernel's 32 channels a block, but of
    16 bytes) and x and log_a one element past 16 bytes (one-element
    copies), for WKV6 strong decays (w = exp(-exp(2 + δ))), w exactly 0 (a
    fifth of it, and one whole step) and 2048 steps at full width.  Inputs
    otherwise follow the models' ranges: log_a = -8·softplus(Λ)·r lies in
    (-0.106, 0); the decay w = exp(-exp(w0 + δ)) with w0 = -4."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def log_a(*shape):
        return -0.106 * torch.rand(shape, generator=g, device="cuda")

    def bhsd(B, H, S, D, fn=rn):
        return fn(B, S, H, D).transpose(1, 2)

    def decay(*shape):
        return torch.exp(-torch.exp(-4.0 + 0.5 * rn(*shape)))

    def strong(*shape):              # w ~ e^-7.4, from ~0.2 down to 0
        return torch.exp(-torch.exp(2.0 + 0.5 * rn(*shape)))

    def zeros(*shape):               # a fifth of w exactly 0, a step all 0
        w = decay(*shape)
        w = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.2,
                        torch.zeros_like(w), w)
        w[:, 9] = 0.0
        return w

    def log_a_zeros(*shape):         # a fifth of log_a 0, a run of steps 0
        la = log_a(*shape)
        la = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.2,
                         torch.zeros_like(la), la)
        la[:, 100:400] = 0.0
        return la

    def log_a_strong(*shape):        # a from e^-10 down to e^-30
        return -10.0 - 20.0 * torch.rand(shape, generator=g, device="cuda")

    def off16(t):                    # the same values one element past 16 B
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    rglru, wkv = [], []
    for label, (B, S, D), fn, place in [
            ("full width", (SERVE_BATCH, RG_PROMPT, 2560), log_a, None),
            ("S=37 D=100", (3, 37, 100), log_a, None),
            ("log_a = 0 runs S=600", (2, 600, 2560), log_a_zeros, None),
            ("strong decays S=300", (2, 300, 2560), log_a_strong, None),
            ("full width S=4096", (SERVE_BATCH, 4096, 2560), log_a, None),
            ("S=129 D=2568", (2, 129, 2568), log_a, None),
            ("base off 16 bytes S=200 D=256", (2, 200, 256), log_a, off16)]:
        x, la = rn(B, S, D), fn(B, S, D)
        for dt in (torch.bfloat16, torch.float32):
            args = (x.to(dt), la.to(dt))
            if place is not None:
                args = tuple(place(t) for t in args)
            rglru.append((f"{label} {str(dt)[6:]}", args))
    for label, (B, H, S, D), fn in [
            ("full width", (SERVE_BATCH, 64, 512, 64), decay),
            ("S=37", (2, 3, 37, 64), decay),
            ("S=45 D=16", (2, 4, 45, 16), decay),
            ("S=70 D=32", (2, 3, 70, 32), decay),
            ("S=23 D=48", (2, 3, 23, 48), decay),
            ("strong decays S=200", (2, 16, 200, 64), strong),
            ("w = 0 S=200", (2, 16, 200, 64), zeros),
            ("full width S=2048", (SERVE_BATCH, 64, 2048, 64), decay)]:
        r, k, v = (bhsd(B, H, S, D) for _ in range(3))
        w = bhsd(B, H, S, D, fn)
        u = 0.1 * rn(H, D)
        for dt in (torch.bfloat16, torch.float32):
            wkv.append((f"{label} {str(dt)[6:]}",
                        tuple(t.to(dt) for t in (r, k, v, w, u))))
    return {"rglru_scan": rglru, "wkv6": wkv}


def recurrent_plain(name, args):
    """The kernel's plain PyTorch version, in float32, on the same (card)
    inputs."""
    from repro_torch.kernels import ref
    fn = ref.rglru if name == "rglru_scan" else ref.wkv6
    return fn(*(t.float() for t in args))


def rel_err(got, exp):
    """max |got - exp| over max(1, max |exp|)."""
    scale = max(1.0, float(exp.abs().max()))
    return float((got.float() - exp).abs().max()) / scale


def elementwise_err(torch, got, exp, rtol, atol):
    """max over elements of |got - exp| / (rtol·|exp| + atol·s), s the root
    mean square of ``exp``: at most 1 where every element is within its
    limit.  Taken a slice of the leading dimension at a time, so that a
    full-width expert gradient (10.7 GB in bf16) needs no float32 copy."""
    if not exp.numel():
        return 0.0
    step = max(1, (1 << 26) // max(1, exp[0].numel())) if exp.dim() else 1
    parts = [(got, exp)] if exp.dim() == 0 else [
        (got[i:i + step], exp[i:i + step])
        for i in range(0, exp.shape[0], step)]
    s = (sum(float(b.double().square().sum()) for _a, b in parts)
         / exp.numel()) ** 0.5
    worst = 0.0
    for a, b in parts:
        b = b.float()
        lim = (rtol * b.abs() + atol * s).clamp_min(
            torch.finfo(torch.float32).tiny)
        worst = max(worst, float(((a.float() - b).abs() / lim).max()))
    return worst


def max_abs(t):
    """max |t|, a slice of the leading dimension at a time."""
    if not t.numel():
        return 0.0
    if t.dim() == 0:
        return float(t.float().abs())
    step = max(1, (1 << 26) // max(1, t[0].numel()))
    return max(float(t[i:i + step].float().abs().max())
               for i in range(0, t.shape[0], step))


def max_abs_diff(a, b):
    """max |a - b|, a slice of the leading dimension at a time."""
    step = max(1, (1 << 26) // max(1, b[0].numel())) if b.dim() else 1
    if not b.numel():
        return 0.0
    if b.dim() == 0:
        return float((a.float() - b.float()).abs())
    return max(float((a[i:i + step].float() - b[i:i + step].float())
                     .abs().max()) for i in range(0, b.shape[0], step))


def phase_recurrent_kernels(torch, kernels):
    cases = recurrent_cases(torch)
    errs = {}
    for name, runs in cases.items():
        kern = kernels[name]
        errs[name] = 0.0
        for label, args in runs:
            before = kern.launches
            routes = dict(getattr(kern, "routes", {}))
            out, state = kern(*args)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} did not launch")
            if name == "wkv6":
                want = "chunked" if args[0].dtype == torch.bfloat16 \
                    else "simt"
            else:        # 16-byte copies where every row starts on 16 bytes
                row = args[0].shape[2] * args[0].element_size()
                want = "scalar" if row % 16 or any(
                    t.data_ptr() % 16 for t in (*args, out)) else "vector"
            check(kern.routes[want] == routes[want] + 1,
                  f"{name} ({label}) did not take the {want} route")
            route = f", {want} route"
            exp_out, exp_state = recurrent_plain(name, args)
            check(out.dtype == args[0].dtype and out.shape == args[0].shape
                  and state.dtype == torch.float32
                  and state.shape == exp_state.shape,
                  f"{name} ({label}): {out.dtype} {tuple(out.shape)}, "
                  f"{state.dtype} {tuple(state.shape)}")
            e_out, e_state = rel_err(out, exp_out), rel_err(state, exp_state)
            tol = REC_TOL[(name, str(out.dtype)[6:])]
            tol_state = REC_TOL[(name, "float32")]
            check(e_out <= tol and e_state <= tol_state,
                  f"{name} ({label}) differs from its plain version: output "
                  f"{e_out} (tolerance {tol}), final state {e_state} "
                  f"(tolerance {tol_state}), relative to max(1, max |plain|)")
            errs[name] = max(errs[name],
                             float((out.float() - exp_out).abs().max()),
                             float((state - exp_state).abs().max()))
            log(f"  {name} [{label}]: relative err output {e_out:.3g} "
                f"(tolerance {tol}), final state {e_state:.3g} (tolerance "
                f"{tol_state}){route}")
    return cases, errs


def recurrent_bwd_cases(torch):
    """(label, args) per backward case.  rglru_scan_bwd (x, log_a, dy,
    dh_final), bf16 and float32: recurrentgemma-2b's training shape (2 x
    4,096 steps x 2,560 channels) with dh_final None and seeded, S = 37 at
    D = 100 (bf16 rows of 200 bytes take one-element copies), runs of
    log_a = 0 (a = 1, b = 0: the gate's term 0), strong decays (log_a in
    [-30, -10]), D = 2568, S = 256 (two bf16 tiles of 128, four float32
    tiles of 64) and one off it either way, one tile of each (S = 128,
    64), and a base off 16 bytes.  wkv6_bwd (r, k, v, w,
    u, dy, ds_final), float32, inputs (B, H, S, D) views of (B, S, H, D)
    memory as the model passes them: rwkv6-7b's training shape (2 x 64
    heads of 64 x 4,096 steps), D 16/32/48/64 at S off the kernels' 64-step
    chunk (S = 64k - 1 and 64k + 1 among them) with ds_final seeded and
    None, S = 1, strong decays, w exactly 0 (a fifth of it and a whole
    step), a whole chunk of w = 0, and a base off 16 bytes (4-byte
    copies).  Ranges as in :func:`recurrent_cases`."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device="cuda")

    def log_a(*shape):
        return uni(-0.106, 0.0, *shape)

    def log_a_zeros(*shape):
        la = log_a(*shape)
        la = torch.where(uni(0, 1, *shape) < 0.2, torch.zeros_like(la), la)
        la[:, 100:400] = 0.0
        return la

    def off16(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    rglru = []
    for label, (B, S, D), fn, seeded, place in [
            ("train shape", (TRAIN_BATCH, TRAIN_SEQ, 2560), log_a, False,
             None),
            ("train shape dh_final", (TRAIN_BATCH, TRAIN_SEQ, 2560), log_a,
             True, None),
            ("S=37 D=100 dh_final", (3, 37, 100), log_a, True, None),
            ("log_a = 0 runs S=600", (2, 600, 2560), log_a_zeros, True,
             None),
            ("strong decays S=300", (2, 300, 2560),
             lambda *sh: uni(-30.0, -10.0, *sh), False, None),
            ("S=129 D=2568", (2, 129, 2568), log_a, True, None),
            ("S=256 D=512 dh_final", (2, 256, 512), log_a, True, None),
            ("S=255 D=512", (2, 255, 512), log_a, False, None),
            ("S=257 D=512 dh_final", (2, 257, 512), log_a, True, None),
            ("S=128 D=2560 dh_final", (2, 128, 2560), log_a, True, None),
            ("S=64 D=2560", (2, 64, 2560), log_a, False, None),
            ("base off 16 bytes S=200 D=256", (2, 200, 256), log_a, True,
             off16)]:
        x, la, dy = rn(B, S, D), fn(B, S, D), rn(B, S, D)
        dh = rn(B, D) if seeded else None
        for dt in (torch.bfloat16, torch.float32):
            args = tuple(t.to(dt) for t in (x, la, dy))
            if place is not None:
                args = tuple(place(t) for t in args)
            rglru.append((f"{label} {str(dt)[6:]}", (*args, dh)))

    def bhsd(B, H, S, D):
        return rn(B, S, H, D).transpose(1, 2)

    wkv = []
    for label, (B, H, S, D), decay, seeded, place in [
            ("train shape", (TRAIN_BATCH, 64, TRAIN_SEQ, 64), "mild", False,
             None),
            ("S=37 D=64 ds_final", (2, 3, 37, 64), "mild", True, None),
            ("S=45 D=16 ds_final", (2, 4, 45, 16), "mild", True, None),
            ("S=70 D=32", (2, 3, 70, 32), "mild", False, None),
            ("S=23 D=48 ds_final", (2, 3, 23, 48), "mild", True, None),
            ("strong decays S=200", (2, 16, 200, 64), "strong", True, None),
            ("w = 0 S=200", (2, 16, 200, 64), "zeros", True, None),
            ("S=127 D=64 ds_final", (2, 8, 127, 64), "mild", True, None),
            ("S=129 D=64", (2, 8, 129, 64), "mild", False, None),
            ("S=63 D=32 ds_final", (2, 4, 63, 32), "mild", True, None),
            ("S=193 D=48", (2, 4, 193, 48), "mild", False, None),
            ("S=1 D=64 ds_final", (2, 8, 1, 64), "mild", True, None),
            ("S=1 D=16", (3, 4, 1, 16), "mild", False, None),
            ("a chunk of w = 0 S=200", (2, 16, 200, 64), "chunk zeros", True,
             None),
            ("base off 16 bytes S=150 D=64", (2, 8, 150, 64), "mild", True,
             off16)]:
        r, k, v, dy = (bhsd(B, H, S, D) for _ in range(4))
        delta = 0.5 * bhsd(B, H, S, D)
        w = torch.exp(-torch.exp((2.0 if decay == "strong" else -4.0)
                                 + delta))
        if decay == "zeros":        # a fifth of w exactly 0, a step all 0
            w = torch.where(uni(0, 1, *w.shape) < 0.2, torch.zeros_like(w), w)
            w[:, :, 9] = 0.0
        if decay == "chunk zeros":  # every w of the second chunk 0
            w[:, :, 64:128] = 0.0
        u = 0.1 * rn(H, D)
        ds = rn(B, H, D, D) if seeded else None
        if place is not None:
            r, k, v, w, dy = (place(t) for t in (r, k, v, w, dy))
        wkv.append((f"{label} float32", (r, k, v, w, u, dy, ds)))
    return {"rglru_scan_bwd": rglru, "wkv6_bwd": wkv}


def bits_equal(torch, a, b):
    """Two tensors equal bit for bit (bf16 compared as int16)."""
    view = (lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16
            else t)
    return torch.equal(view(a), view(b))


def rglru_bwd_call(torch, args):
    """The RG-LRU backward of a case (x, log_a, dy, dh_final) as training
    runs it: the forward kernel first keeps its tile states
    (``rglru_scan(x, log_a, carries)``), then ``rglru_scan_bwd`` starts
    each tile from them.  Returns (the backward as a call, the states)."""
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                tile_states)
    x, la, dy, dh = args
    carries = tile_states(x)
    rglru_scan(x, la, carries)
    return (lambda: rglru_scan_bwd(x, la, dy, dh, carries)), carries


def phase_recurrent_bwd_kernels(torch):
    """Each backward case against its plain version on the same (card)
    inputs in float32 (``ref.rglru_bwd``, ``ref.wkv6_bwd``), element by
    element within ``BWD_TOL``, each RG-LRU case after the forward kernel
    kept its tile states (:func:`rglru_bwd_call`; the states against
    ``ref.rglru_chunked``'s within ``REC_TOL``); each output's dtype and
    shape; a second call bitwise equal to the first; each RG-LRU case on
    the copies ``_variant`` should pick
    (16-byte where x, log_a, dy, dx and dlog_a rows all start on 16 bytes),
    and each WKV case on the copies ``_bwd_variant`` should pick (16-byte
    where every stride of r, k, v, w and dy is a multiple of 4 and every
    base on 16 bytes); and the device operations of a call under
    ``torch.profiler`` (the RG-LRU backward its two, on each route; the
    WKV backward its three, on each route).
    Returns the largest absolute errors and the operations a call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import (_variant, rglru_scan_bwd,
                                                tile_steps)
    from repro_torch.kernels.wkv6 import _bwd_variant, wkv6_bwd
    kernels = {"rglru_scan_bwd": rglru_scan_bwd, "wkv6_bwd": wkv6_bwd}
    plain = {"rglru_scan_bwd": ref.rglru_bwd, "wkv6_bwd": ref.wkv6_bwd}
    expected_ops = {"rglru_scan_bwd": 2, "wkv6_bwd": 3}
    errs, ops = {}, {}
    for name, runs in recurrent_bwd_cases(torch).items():
        kern = kernels[name]
        errs[name] = 0.0
        for label, args in runs:
            states = ""
            if name == "rglru_scan_bwd":
                call, carries = rglru_bwd_call(torch, args)
                tile = tile_steps(args[0].dtype)
                kept = ref.rglru_chunked(args[0].float(), args[1].float(),
                                         tile, tile // 8,
                                         keep_states=True)[2]
                e_kept = rel_err(carries, kept)
                tol_kept = REC_TOL[("rglru_scan", "float32")]
                check(e_kept <= tol_kept, f"{name} ({label}): the forward's "
                      f"tile states differ from ref.rglru_chunked's: "
                      f"{e_kept} (tolerance {tol_kept})")
                states = f", tile states {e_kept:.3g}"
                del kept
            else:
                def call(args=args):
                    return kern(*args)
            before = kern.launches
            routes = dict(getattr(kern, "routes", {}))
            got = call()
            torch.cuda.synchronize()
            check(kern.launches == before + 1, f"{name} ({label}) did not "
                                               f"launch")
            if name == "rglru_scan_bwd":
                x = args[0]
                want = _variant(x.dtype, x.shape[2], tuple(
                    t.data_ptr() for t in (*args[:3], *got)))
                aligned = x.shape[2] * x.element_size() % 16 == 0 and all(
                    t.data_ptr() % 16 == 0 for t in (*args[:3], *got))
                check(want == ("vector" if aligned else "scalar"),
                      f"{name} ({label}): _variant picked {want}")
            else:
                ins = (*args[:4], args[5])
                want = _bwd_variant(
                    tuple(x for t in ins for x in t.stride()[:3]),
                    tuple(t.data_ptr() for t in ins))
                aligned = all(x % 4 == 0 for t in ins
                              for x in t.stride()[:3]) and all(
                    t.data_ptr() % 16 == 0 for t in ins)
                check(want == ("vector" if aligned else "scalar"),
                      f"{name} ({label}): _bwd_variant picked {want}")
            check(kern.routes[want] == routes[want] + 1,
                  f"{name} ({label}) did not take the {want} route")
            route = f", {want} route"
            key = f"{name} {want}"
            again = call()
            check(all(bits_equal(torch, a, b) for a, b in zip(got, again)),
                  f"{name} ({label}): two calls differ")
            exp = plain[name](*(t.float() if t is not None else None
                                for t in args))
            tol = BWD_TOL[str(args[0].dtype)[6:]]
            es = []
            for i, (a, b) in enumerate(zip(got, exp)):
                like = args[i]     # dx, dlog_a; dr, dk, dv, dw, du
                check(a.dtype == like.dtype and a.shape == like.shape,
                      f"{name} ({label}) output {i}: {a.dtype} "
                      f"{tuple(a.shape)}")
                es.append(elementwise_err(torch, a, b, *tol))
                errs[name] = max(errs[name],
                                 float((a.float() - b).abs().max()))
            check(max(es) <= 1.0, f"{name} ({label}) differs from its plain "
                  f"version: {es} of the limit (rtol, atol) {tol}")
            if key not in ops:
                o = device_ops(torch, call, 5)
                check(sum(o.values()) == 5 * expected_ops[name]
                      and len(o) == expected_ops[name],
                      f"{name} ({label}): device operations of 5 calls {o}, "
                      f"expected {expected_ops[name]} kernels once a call")
                ops[key] = {k[:60]: n / 5 for k, n in o.items()}
            log(f"  {name} [{label}]: err "
                + "/".join(f"{e:.3g}" for e in es)
                + f" of the limit (rtol, atol) {tol}, two calls bitwise "
                f"equal{route}{states}")
            del got, again, exp
    log(f"  backward device operations a call: {json.dumps(ops)}")
    errs["device_ops_per_call"] = ops
    return errs


def gmm_cases():
    """(label, E, Din, Dout, T, block_t, block_expert, misaligned w, counts)
    per grouped-matmul case: llama4-maverick's expert products as its MoE
    layers make them (gate/up: 5120 -> 8192, wo: 8192 -> 5120; prefill: 128
    experts x 24 slots; decode: x 8; block i on expert i), every row counted
    and with the row counts the model passes (a decode step's 4 tokens on 4
    of the 128 blocks, one row each; partial prefill counts), then odd ones
    — ragged Din and Dout, Dout not a multiple of the 16-byte vector, a
    block of more than one chunk of rows, one-row blocks, a weight tensor
    off 16-byte alignment (the CUDA-core kernel in bf16), Din = 0, counts
    that are all zero and partial counts over garbage rows — with unsorted
    block experts that repeat.  x holds random values past every count."""
    cases = []
    for din, dout in ((MOE_D, MOE_F), (MOE_F, MOE_D)):
        for phase, c in (("prefill", MOE_C_PREFILL), ("decode", MOE_C_DECODE)):
            cases.append((f"{phase} {din}->{dout}", MOE_E, din, dout,
                          MOE_E * c, c, "arange", False, None))
    for din, dout in ((DS_D, DS_F), (DS_F, DS_D)):
        for phase, c, kind in (("prefill", DS_C_PREFILL, None),
                               ("prefill", DS_C_PREFILL, "partial"),
                               ("decode", DS_C_DECODE, "top-8 decode")):
            cases.append((f"deepseek {phase} {din}->{dout}"
                          + (f" {kind} counts" if kind else ""), DS_E, din,
                          dout, DS_E * c, c, "arange", False, kind))
    cases += [("decode 5120->8192 model counts", MOE_E, MOE_D, MOE_F,
               MOE_E * MOE_C_DECODE, MOE_C_DECODE, "arange", False,
               "model decode"),
              ("prefill 8192->5120 partial counts", MOE_E, MOE_F, MOE_D,
               MOE_E * MOE_C_PREFILL, MOE_C_PREFILL, "arange", False,
               "partial"),
              ("Din 100 Dout 77 block_t 7", 3, 100, 77, 35, 7, "random",
               False, None),
              ("Din 37 Dout 264 block_t 40", 4, 37, 264, 120, 40, "random",
               False, None),
              ("block_t 1", 5, 513, 136, 9, 1, "random", False, None),
              ("misaligned w", 3, 64, 512, 48, 8, "random", True, None),
              ("Din 0", 2, 0, 16, 16, 8, "random", False, None),
              ("all-zero counts", 4, 64, 256, 64, 16, "random", False,
               "zero"),
              ("partial counts block_t 24", 5, 136, 264, 120, 24, "random",
               False, "partial"),
              ("partial counts block_t 100", 3, 128, 136, 300, 100, "random",
               False, "partial"),
              ("partial counts Din 100 Dout 77 block_t 7", 3, 100, 77, 35, 7,
               "random", False, "partial"),
              ("partial counts misaligned w", 3, 64, 512, 48, 8, "random",
               True, "partial")]
    return cases


def gmm_counts(torch, g, kind, E, nb, bt):
    """The (nb,) int32 row counts of a case, on the card: None, all zero,
    the model's decode step (llama4: 4 blocks of one row; deepseek-v3,
    ``"top-8 decode"``: each of the step's 4 tokens on 8 distinct experts)
    or partial (0, a third, block_t, block_t - 1, then drawn)."""
    if kind is None:
        return None
    counts = torch.zeros(nb, dtype=torch.int32, device="cuda")
    if kind == "model decode":
        counts[torch.randperm(nb, generator=g, device="cuda")[:4]] = 1
    elif kind == "top-8 decode":
        for _ in range(SERVE_BATCH):
            counts[torch.randperm(nb, generator=g, device="cuda")[:DS_K]] += 1
    elif kind == "partial":
        counts = torch.randint(0, bt + 1, (nb,), generator=g, device="cuda",
                               dtype=torch.int32)
        counts[:4] = torch.tensor([0, max(1, bt // 3), bt, bt - 1])[:nb]
    return counts


def gmm_route(x, w, out):
    """The grouped-matmul kernel the wrapper picks for these tensors."""
    from repro_torch.kernels import moe_gmm
    return moe_gmm._variant(x.dtype, w.shape[1], w.shape[2],
                            (x.data_ptr(), w.data_ptr(), out.data_ptr()))


def phase_gmm_kernel(torch, kernels):
    """The grouped matmul against its plain version, on the same inputs in
    the same dtype, each case on the kernel it should take (bf16 with
    widths and pointers 16-byte copies can take on the tensor cores, the
    rest on the CUDA cores), rows past a count exactly zero; the weights of
    a full-width case (21.5 GB in float32) live only while their case
    runs."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    kern = kernels["gmm"]
    err = 0.0
    for label, E, din, dout, T, bt, order, misaligned, kind in gmm_cases():
        w32 = torch.randn((E, din, dout), generator=g, device="cuda")
        w32.mul_(1.0 / max(din, 1) ** 0.5)
        x32 = torch.randn((T, din), generator=g, device="cuda")
        be = torch.arange(E, dtype=torch.int32, device="cuda") \
            if order == "arange" else torch.randint(
                0, E, (T // bt,), generator=g, device="cuda",
                dtype=torch.int32)
        counts = gmm_counts(torch, g, kind, E, T // bt, bt)
        for dt in (torch.bfloat16, torch.float32):
            x, w = x32.to(dt), w32.to(dt)
            if misaligned:      # the same values one element into a buffer
                buf = torch.empty(w.numel() + 1, dtype=dt, device="cuda")
                buf[1:].copy_(w.view(-1))
                w = buf[1:].view(E, din, dout)
            before = kern.launches
            got = kern(x, w, be, bt, counts)
            torch.cuda.synchronize()
            check(kern.launches == before + 1, "gmm did not launch")
            exp = ref.gmm(x, w, be, bt, counts)
            what = f"gmm ({label} {str(dt)[6:]})"
            check(got.dtype == dt and got.shape == (T, dout),
                  f"{what}: {got.dtype} {tuple(got.shape)}")
            route = gmm_route(x, w, got)
            want = "mma" if dt == torch.bfloat16 and din % 8 == 0 \
                and dout % 8 == 0 and not misaligned else "simt"
            check(route == want, f"{what} took the {route} kernel, not "
                                 f"{want}")
            if counts is not None:
                past = torch.arange(bt, device="cuda")[None, :] \
                    >= counts[:, None]
                check(not got[past.reshape(-1)].any(),
                      f"{what}: rows past the counts not zero")
            e = rel_err(got, exp)
            tol = GMM_TOL[str(dt)[6:]]
            check(e <= tol, f"{what} differs from its plain version: {e} "
                            f"relative to max(1, max |plain|) > {tol}")
            err = max(err, float((got.float() - exp.float()).abs().max()))
            log(f"  gmm [{label} {str(dt)[6:]}]: relative err {e:.3g} "
                f"(tolerance {tol}), {route} kernel")
            del x, w, got, exp
        del w32, x32
        torch.cuda.empty_cache()
    return err


# ---------------------------------------------------------------------------
# phase 2b: the grouped matmul's backward against its plain versions
# ---------------------------------------------------------------------------

def dispatch_counts(torch, g, E, C, tokens, k, edges=True):
    """(E,) int32 row counts as a dispatch of ``tokens`` tokens, top-``k``,
    into C slots an expert gives them: each assignment on an expert drawn
    uniformly, min(count, C).  With ``edges`` expert 0 is empty and expert
    1 full, so that every case holds empty, partial and full experts."""
    e = torch.randint(0, E, (tokens * k,), generator=g, device="cuda")
    counts = torch.bincount(e, minlength=E).clamp_(max=C).to(torch.int32)
    if edges:
        counts[0], counts[1] = 0, C
    return counts


def gmm_bwd_cases():
    """(label, E, Din, Dout, block_t, Pd, dtype, block experts, counts,
    misaligned) per backward case.  Both leaf orientations of llama4-
    maverick's (wi: 5120 -> 8192, wo: 8192 -> 5120; 128 experts, 80 slots
    each, top-1) and deepseek-v3's (7168 <-> 2048; 256 experts, 320 slots,
    top-8) expert products at phase 7's batch of TRAIN_BATCH x TRAIN_SEQ
    tokens, row counts as a dispatch gives them (:func:`dispatch_counts`);
    the a2a form (Pd = 2 blocks on every expert, ``arange(E).repeat(2)``);
    float32 at both models' widths with fewer experts (the CUDA-core
    route); then odd ones: bf16 rows off 16 bytes and widths not multiples
    of 8 (CUDA cores), ragged tiles and a block of more than one 64-row
    chunk (tensor cores), unsorted block experts that repeat, counts all
    zero, block_t 1 and no counts; and counts at the edges of the input
    gradient's m64 tiles and 16-row boxes (63, 64, 65, 127, 128, 129 and
    320, in blocks of 320 and of 128: the two instances), an a2a form whose
    experts 0 and 2 hold counted rows only in their second block, a
    block_t of 400, above the 320 rows one pass of the input gradient
    holds (two passes), and 4,096 narrow experts of which 7 in 8 hold no
    row, so that the weight gradient's persistent clusters take many
    empty experts' marker stages in a row."""
    bf, f32 = "bfloat16", "float32"
    tk = TRAIN_BATCH * TRAIN_SEQ
    cases = []
    for din, dout in ((MOE_D, MOE_F), (MOE_F, MOE_D)):
        cases.append((f"llama4 {din}->{dout}", MOE_E, din, dout,
                      MOE_C_TRAIN, 1, bf, "arange", ("dispatch", tk, 1),
                      False))
    for din, dout in ((DS_D, DS_F), (DS_F, DS_D)):
        cases.append((f"deepseek {din}->{dout}", DS_E, din, dout,
                      DS_C_TRAIN, 1, bf, "arange", ("dispatch", tk, DS_K),
                      False))
    cases += [
        (f"llama4 a2a Pd=2 {MOE_D}->{MOE_F}", MOE_E, MOE_D, MOE_F,
         MOE_C_TRAIN, 2, bf, "arange", ("dispatch", tk, 1), False),
        (f"float32 llama4 widths a2a Pd=2 {MOE_F}->{MOE_D}", 4, MOE_F, MOE_D,
         MOE_C_TRAIN, 2, f32, "arange", ("dispatch", 4 * MOE_C_TRAIN, 1),
         False),
        (f"float32 deepseek widths {DS_D}->{DS_F}", 8, DS_D, DS_F,
         DS_C_TRAIN, 1, f32, "arange", ("dispatch", 8 * DS_C_TRAIN, 1),
         False),
        ("bf16 rows off 16 bytes a2a Pd=2", 3, 200, 136, 24, 2, bf,
         "arange", ("partial",), True),
        ("Din 100 Dout 77 block_t 7", 5, 100, 77, 7, 1, bf, "random",
         ("partial",), False),
        ("ragged tiles Din 136 Dout 264 block_t 40", 3, 136, 264, 40, 1, bf,
         "random", ("partial",), False),
        ("block_t 100 (two chunks)", 3, 128, 136, 100, 1, bf, "random",
         ("partial",), False),
        ("all-zero counts", 4, 64, 256, 16, 1, bf, "random", ("zero",),
         False),
        ("block_t 1", 5, 513, 136, 1, 1, bf, "random", ("partial",), False),
        ("no counts", 4, 256, 128, 32, 2, bf, "random", None, False),
        ("float32 no counts", 3, 100, 77, 7, 2, f32, "random", None, False),
        ("counts 63 64 65 127 128 129 320 0, block_t 320", 8, 256, 512, 320,
         1, bf, "arange", ("fixed", (63, 64, 65, 127, 128, 129, 320, 0)),
         False),
        ("counts 63 64 65 127 128 1, block_t 128", 6, 512, 256, 128, 1, bf,
         "arange", ("fixed", (63, 64, 65, 127, 128, 1)), False),
        ("a2a Pd=2, experts 0 and 2 counted in their second block only", 4,
         256, 512, 80, 2, bf, "arange", ("fixed", (0, 70, 0, 80, 33, 0, 64,
                                                   17)), False),
        ("block_t 400 (two passes)", 3, 128, 136, 400, 1, bf, "random",
         ("fixed", (400, 321, 0, 320, 399, 5)), False),
        ("4096 experts, 7 in 8 empty", 4096, 64, 128, 8, 1, bf, "arange",
         ("fixed", tuple(0 if i % 8 else 1 + i // 8 % 8
                         for i in range(4096))), False)]
    return cases


def gmm_bwd_inputs(torch, g, case):
    """x (T, Din), dy (T, Dout), w (E, Din, Dout) (None past 2^31 bytes of
    x and dy alike: only the full-width cases hold one) and the int32
    block experts and counts of a case, on the card; x and dy hold random
    values past every count."""
    label, E, din, dout, bt, pd, dt, order, kind, misaligned = case
    dt = getattr(torch, dt)
    nb = pd * E if order == "arange" else max(2 * E, 4)
    T = nb * bt

    def rn(*shape, scale=1.0):
        t = torch.randn(shape, generator=g, device="cuda").mul_(scale).to(dt)
        if misaligned:      # the same values one element into a buffer
            buf = torch.empty(t.numel() + 1, dtype=dt, device="cuda")
            buf[1:].copy_(t.view(-1))
            t = buf[1:].view(shape)
        return t
    x, dy = rn(T, din), rn(T, dout)
    w = rn(E, din, dout, scale=max(din, 1) ** -0.5)
    be = torch.arange(E, dtype=torch.int32, device="cuda").repeat(pd) \
        if order == "arange" else torch.randint(
            0, E, (nb,), generator=g, device="cuda", dtype=torch.int32)
    if kind is None:
        counts = None
    elif kind[0] == "dispatch":
        counts = torch.cat([dispatch_counts(torch, g, E, bt, kind[1],
                                            kind[2], edges=(i == 0))
                            for i in range(pd)])
    elif kind[0] == "fixed":
        check(len(kind[1]) == nb, f"{label}: {len(kind[1])} counts for "
              f"{nb} blocks")
        counts = torch.tensor(kind[1], dtype=torch.int32, device="cuda")
    else:
        counts = gmm_counts(torch, g, kind[0], E, nb, bt)
    return x, dy, w, be, bt, counts


def phase_gmm_bwd_kernels(torch):
    """Each case of :func:`gmm_bwd_cases` through ``gmm_dx`` (dy times each
    block's weights transposed: ``csrc/moe_gmm_dx.cu``, on the CUDA cores
    ``csrc/moe_gmm.cu``'s transposed instance) and ``gmm_dw``
    (``csrc/moe_gmm_dw.cu``) against their plain versions on
    the same (card) inputs in the same dtype (``ref.gmm`` on
    ``w.transpose(1, 2)``, ``ref.gmm_dw``), element by element within
    ``BWD_TOL`` (:func:`elementwise_err`); dx's rows past the counts and
    the gradient of an expert with no counted row exactly zero; each
    output's dtype and shape; a second call bitwise equal to the first;
    each call on the route ``_variant`` should pick (``gmm_dx.routes``,
    ``gmm_dw.routes``: bf16 with widths multiples of 8 and bases on 16
    bytes on the tensor cores, the rest on the CUDA cores); and a call's
    device operations under ``torch.profiler`` (one kernel), on each
    kernel and route.  Returns the largest absolute errors and the
    operations a call."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    errs, ops = {"gmm_dx": 0.0, "gmm_dw": 0.0}, {}
    for case in gmm_bwd_cases():
        label, E, din, dout, _bt, _pd, dts, _order, _kind, misaligned = case
        x, dy, w, be, bt, counts = gmm_bwd_inputs(torch, g, case)
        dt = x.dtype
        want = "mma" if dt == torch.bfloat16 and din % 8 == 0 \
            and dout % 8 == 0 and not misaligned else "simt"
        calls = {
            "gmm_dx": (lambda: moe_gmm.gmm_dx(dy, w, be, bt, counts),
                       lambda: ref.gmm(dy, w.transpose(1, 2), be, bt,
                                       counts),
                       (x.shape[0], din), (dy, w)),
            "gmm_dw": (lambda: moe_gmm.gmm_dw(x, dy, be, bt, counts, E),
                       lambda: ref.gmm_dw(x, dy, be, bt, counts, E),
                       (E, din, dout), (x, dy))}
        msg = []
        for name, (call, plain, shape, ins) in calls.items():
            kern = getattr(moe_gmm, name)
            before, routes = kern.launches, dict(kern.routes)
            got = call()
            torch.cuda.synchronize()
            what = f"{name} ({label} {dts})"
            check(kern.launches == before + 1, f"{what} did not launch")
            route = moe_gmm._variant(dt, din, dout, tuple(
                t.data_ptr() for t in (*ins, got)))
            check(route == want and kern.routes[want] == routes[want] + 1,
                  f"{what} took the {route} route, not {want}")
            check(got.dtype == dt and tuple(got.shape) == shape,
                  f"{what}: {got.dtype} {tuple(got.shape)}")
            again = call()
            check(bits_equal(torch, got, again), f"{what}: two calls differ")
            del again
            if counts is not None and name == "gmm_dx":
                past = torch.arange(bt, device="cuda")[None, :] \
                    >= counts[:, None]
                check(not got[past.reshape(-1)].any(),
                      f"{what}: rows past the counts not zero")
            if name == "gmm_dw":
                rows = torch.full((be.shape[0],), bt, device="cuda") \
                    if counts is None else counts.clamp(0, bt)
                live = torch.zeros(E, dtype=torch.int64, device="cuda")
                live.index_add_(0, be.long(), rows.long())
                dead = (live == 0).nonzero().flatten().tolist()
                check(all(not got[e].any() for e in dead),
                      f"{what}: an expert with no counted row has a "
                      f"non-zero gradient")
                if len(dead):
                    msg.append(f"{len(dead)} empty experts zero")
            exp = plain()
            tol = BWD_TOL[dts]
            e = elementwise_err(torch, got, exp, *tol)
            check(e <= 1.0, f"{what} differs from its plain version: {e} "
                            f"of the limit (rtol, atol) {tol}")
            errs[name] = max(errs[name], max_abs_diff(got, exp))
            key = f"{name} {route}"
            if key not in ops:
                o = device_ops(torch, call, 5)
                check(sum(o.values()) == 5 and len(o) == 1,
                      f"{what}: device operations of 5 calls {o}, "
                      f"expected one kernel a call")
                ops[key] = {k[:60]: n / 5 for k, n in o.items()}
            msg.append(f"{name} {e:.3g} of the limit, {route} route")
            del got, exp
        log(f"  gmm backward [{label} {dts}]: " + "; ".join(msg)
            + f", two calls bitwise equal (rtol, atol) {BWD_TOL[dts]}")
        del x, dy, w, be, counts
        torch.cuda.empty_cache()
    log(f"  gmm backward device operations a call: {json.dumps(ops)}")
    errs["device_ops_per_call"] = ops
    return errs


# ---------------------------------------------------------------------------
# phase 2b: flash attention's backward against its plain version
# ---------------------------------------------------------------------------

def flash_bwd_cases():
    """(label, (B, Hq, Hkv, Sq, Sk, D), masks and scale, v's width): the
    training shape's head width and group at S = 4096, D 64 / 128 / 192
    (MLA: v zero-padded from 128) / 256, groups of 1, 3, 5 and 8, causal,
    a 2048-token window, Sq != Sk, S = 1 and 17, bidirectional; D 40 and
    96, which the tensor-core instances at 64 and 128 take zero-filled;
    D 192 and 256, which the ``wgmma`` route takes in bf16 (its 256
    instance also a ragged Sk and a window of 100, under two query
    tiles, where each key tile's last query tile holds a third of its
    keys' pairs), and D 136 and 200, which its 192 and 256 instances take
    zero-filled; rows one element into their buffer, at D 128 and 256,
    and D 252 (bf16 rows off 16 bytes or not a multiple of 8 wide, for
    the CUDA-core route, whose 256-wide instance takes D 252 and 256);
    and the vlm's and whisper's training shapes at TRAIN_BATCH: whisper's bidirectional encoder (20 heads of 64 over
    1,500 frames) and its cross-attention (224 queries over 1,500 keys),
    the vision cross layers' (512 queries over 1,601 context tokens, 32
    heads on 8 of 128)."""
    return [
        ("train shape G=3 S=4096", (1, 6, 2, 4096, 4096, 128),
         dict(causal=True), 128),
        ("D=64 G=1", (2, 4, 4, 300, 300, 64), dict(causal=True), 64),
        ("D=128 G=8 window 2048 S=4096", (1, 8, 1, 4096, 4096, 128),
         dict(causal=True, window=2048), 128),
        ("D=256 G=5 window 2048", (1, 10, 2, 2304, 2304, 256),
         dict(causal=True, window=2048), 256),
        ("D=256 G=2 window 100", (1, 4, 2, 600, 600, 256),
         dict(causal=True, window=100), 256),
        ("MLA D=192 v padded from 128", (2, 4, 4, 512, 512, DS_DQK),
         dict(causal=True, sm_scale=DS_DQK ** -0.5), DS_DV),
        ("Sq != Sk", (2, 6, 2, 100, 300, 128), dict(causal=True), 128),
        ("S=1", (2, 4, 2, 1, 1, 64), dict(causal=True), 64),
        ("S=17 bidirectional", (1, 5, 1, 17, 17, 128), dict(causal=False),
         128),
        ("D=256 ragged Sk bidirectional", (1, 3, 1, 70, 190, 256),
         dict(causal=False), 256),
        ("D=96 G=2 zero-filled", (2, 4, 2, 200, 200, 96),
         dict(causal=True), 96),
        ("D=40 G=4 zero-filled Sq != Sk", (1, 8, 2, 60, 130, 40),
         dict(causal=True), 40),
        ("D=200 G=3 ragged Sk zero-filled", (1, 6, 2, 130, 250, 200),
         dict(causal=True), 200),
        ("D=136 G=2 zero-filled", (2, 4, 2, 200, 200, 136),
         dict(causal=True), 136),
        ("misaligned rows D=128 G=2", (2, 8, 4, 100, 100, 128),
         dict(causal=True), 128),
        ("misaligned rows D=256 G=5 window", (1, 10, 2, 600, 600, 256),
         dict(causal=True, window=300), 256),
        ("D=252 G=2 ragged Sk", (1, 4, 2, 150, 230, 252),
         dict(causal=True), 252),
        ("whisper encoder 20 of 64 1500^2 bidirectional",
         (TRAIN_BATCH, 20, 20, 1500, 1500, 64), dict(causal=False), 64),
        ("whisper cross 224 x 1500", (TRAIN_BATCH, 20, 20, WHISPER_PROMPT,
                                      1500, 64), dict(causal=False), 64),
        ("vision cross 512 x 1601 G=4", (TRAIN_BATCH, 32, 8, SERVE_PROMPT,
                                         1601, 128), dict(causal=False),
         128)]


def bwd_rel_err(got, exp, floor):
    """max |got - exp| over the plain gradient's max |exp|, or over
    ``floor`` where that is smaller: a gradient that vanishes exactly (at
    S = 1, P = 1 and dP = Dsum, so dq = dk = 0) leaves both sides with
    rounding noise alone."""
    return float((got.float() - exp).abs().max()) / max(
        float(exp.abs().max()), floor)


def phase_flash_bwd_kernel(torch):
    """Each case in bf16 and float32, inputs (B, H, S, D) views of (B, S, H,
    D) projections as the models pass them: the forward with ``lse`` (the
    training call, offset Sk - Sq) against ``ref.mha_lse``, then the
    backward kernel against ``ref.flash_attention_bwd`` on the same q, k,
    v, out, lse and dout (tolerance ``ATTN_TOL`` relative to the plain
    gradient's max), a second call bitwise equal to the first, MLA's padded
    v columns' gradient zero; and the device operations of one backward
    call under ``torch.profiler``, on each route.  Each call runs on the
    route
    ``_bwd_variant`` picks (``flash_attention_bwd.routes``): every bf16
    case with rows on 16 bytes on the tensor cores, at D <= 128 on
    ``"mma"`` (D 40 and 96 zero-filled to an instance's width) and at D
    192 and 256 on ``"wgmma"``, against both the plain version that rounds
    P and dS to bf16 as the kernels do and the unrounded one; float32 and
    bf16 rows off 16 bytes on the CUDA cores (``"simt"``, against the
    unrounded one).  The floor of the relative error's denominator is 1e-2
    of the largest |dO|·|v| product, a term of dP and Dsum; it binds only
    where a gradient vanishes (each case logs both).  Returns the largest
    relative errors."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def proj(B, S, H, width, D, dt, misaligned):
        t = torch.randn((B, S, H, width), generator=g, device="cuda").to(dt)
        t = F.pad(t, (0, D - width))
        if misaligned:
            flat = torch.empty(t.numel() + 1, dtype=dt, device="cuda")
            t = flat[1:].view(t.shape).copy_(t)
        return t.transpose(1, 2)

    errs = {"lse": 0.0, "grad": 0.0}
    ops = {}
    for label, (B, Hq, Hkv, Sq, Sk, D), kw, width in flash_bwd_cases():
        for dt in (torch.bfloat16, torch.float32):
            tag = f"{label} {str(dt)[6:]}"
            tol = ATTN_TOL[str(dt)[6:]]
            odd = "misaligned" in label
            q = proj(B, Sq, Hq, D, D, dt, odd)
            k = proj(B, Sk, Hkv, D, D, dt, odd)
            v = proj(B, Sk, Hkv, width, D, dt, odd)
            dout = proj(B, Sq, Hq, width, D, dt, odd)
            mask = dict(causal=kw["causal"], window=kw.get("window"),
                        sm_scale=kw.get("sm_scale") or D ** -0.5,
                        offset=Sk - Sq)
            before = fa.flash_attention.launches
            out, lse = fa._forward(q, k, v, mask["causal"], mask["window"],
                                   mask["sm_scale"], mask["offset"], True)
            torch.cuda.synchronize()
            check(fa.flash_attention.launches == before + 1,
                  f"flash_attention with lse ({tag}) did not launch")
            _o, lse_plain = ref.mha_lse(q.float(), k.float(), v.float(),
                                        **mask)
            live = lse_plain > -1e29
            check(torch.equal(live, lse > -1e29), f"flash lse ({tag}): rows "
                  f"with no visible key differ")
            e_lse = float((lse - lse_plain)[live].abs().max()) / max(
                1.0, float(lse_plain[live].abs().max())) if live.any() \
                else 0.0
            check(e_lse <= tol, f"flash lse ({tag}) differs from its plain "
                                f"version: {e_lse} > {tol}")

            def bwd():
                return fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                              **mask)
            route = "simt" if dt != torch.bfloat16 or odd or D % 8 else \
                "mma" if D <= fa.MMA_BWD_MAX_HEAD_DIM else "wgmma"
            picked = fa._bwd_variant(
                dt, D, [st for t in (q, k, v, out, dout)
                        for st in t.stride()[:3]],
                [t.data_ptr() for t in (q, k, v, out, dout)])
            check(picked == route, f"flash_attention_bwd ({tag}): "
                  f"_bwd_variant picked {picked}, not {route}")
            before = fa.flash_attention_bwd.launches
            routes = dict(fa.flash_attention_bwd.routes)
            got = bwd()
            torch.cuda.synchronize()
            check(fa.flash_attention_bwd.launches == before + 1,
                  f"flash_attention_bwd ({tag}) did not launch")
            check(fa.flash_attention_bwd.routes[route] == routes[route] + 1,
                  f"flash_attention_bwd ({tag}) did not run on {route}: "
                  f"{routes} -> {fa.flash_attention_bwd.routes}")
            again = bwd()
            check(all(bits_equal(torch, a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd ({tag}): two calls differ")
            plain = ref.flash_attention_bwd(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **mask)
            rounded = ref.flash_attention_bwd(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **mask, round_p=torch.bfloat16) \
                if route != "simt" else plain
            es, es_unrounded = [], []
            floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
            for name, a, b, c, like in zip(("dq", "dk", "dv"), got, rounded,
                                           plain, (q, k, v)):
                check(a.dtype == dt and a.shape == like.shape,
                      f"flash_attention_bwd ({tag}) {name}: {a.dtype} "
                      f"{tuple(a.shape)}")
                es.append(bwd_rel_err(a, b, floor))
                es_unrounded.append(bwd_rel_err(a, c, floor))
                check(max(es[-1], es_unrounded[-1]) <= tol,
                      f"flash_attention_bwd ({tag}) {name} differs from its "
                      f"plain version: {es[-1]} (rounding P and dS as the "
                      f"route does), {es_unrounded[-1]} (unrounded) > {tol}")
            if width < D:
                check(not got[2][..., width:].any(), f"flash_attention_bwd "
                      f"({tag}): the padded v columns got a gradient")
            if route not in ops:
                ops[route] = device_ops(torch, bwd, 5)
                check(sum(ops[route].values()) == 15
                      and len(ops[route]) == 3,
                      f"flash_attention_bwd ({route}): device operations "
                      f"of 5 calls {ops[route]}, expected the 3 kernels "
                      f"once a call")
            errs["lse"] = max(errs["lse"], e_lse)
            errs["grad"] = max(errs["grad"], *es, *es_unrounded)
            peaks = "/".join(f"{float(b.abs().max()):.3g}" for b in plain)
            unrounded = "" if route == "simt" else (
                " (unrounded plain: " + "/".join(
                    f"{e:.3g}" for e in es_unrounded) + ")")
            log(f"  flash_attention_bwd [{tag}, {route}]: lse err "
                f"{e_lse:.3g}, dq/dk/dv err {es[0]:.3g}/{es[1]:.3g}/"
                f"{es[2]:.3g}{unrounded} of the plain max {peaks} (floor "
                f"{floor:.3g}; tolerance {tol}), two calls bitwise equal")
    log(f"  flash_attention_bwd: device operations of 5 calls "
        f"{json.dumps(ops)}")
    errs["device_ops_per_call"] = {
        route: {k: n / 5 for k, n in o.items()} for route, o in ops.items()}
    return errs


# ---------------------------------------------------------------------------
# phase 3: the same windows on the card and on the CPU
# ---------------------------------------------------------------------------

def parity_run(torch, pt, label, cfg, steps, ledger=False):
    """Run ``steps`` — callables (store, state) -> (state, outputs) — on a
    P=4 store of ``cfg`` on the remote-DMA backend, once on the card and
    once on the CPU: every state leaf and every output bitwise equal after
    every step.  Returns {device: (store, state, manager)}."""
    stores = {}
    for dev in ("cuda", "cpu"):
        mgr = pt.make_manager(4, device=dev, backend="pallas")
        if ledger:
            mgr.traffic.enable()
        kv = pt.KVStore(None, "kv", mgr, **cfg)
        stores[dev] = [kv, kv.init_state(), mgr]
    for i, step in enumerate(steps):
        out = {}
        for dev, s in stores.items():
            s[1], res = step(s[0], s[1])
            out[dev] = (pt.state_to_numpy(s[1]), res)
        for name in pt.KVStoreState._fields:
            a = getattr(out["cuda"][0], name)
            b = getattr(out["cpu"][0], name)
            for x, y in zip(a if isinstance(a, tuple) else [a],
                            b if isinstance(b, tuple) else [b]):
                check(x.dtype == y.dtype and np.array_equal(x, y),
                      f"{label} step {i}: state leaf {name} differs cuda vs "
                      f"cpu")
        for x, y in zip(out["cuda"][1], out["cpu"][1]):
            check(torch.equal(x.cpu(), y),
                  f"{label} step {i}: result differs cuda vs cpu")
    return {dev: tuple(s) for dev, s in stores.items()}


def window_step(ops, ks, vals, **kw):
    return lambda kv, st: kv.op_window(st, ops, ks, vals, **kw)


def phase_parity(torch, pt):
    """Phase 3's map stores on the card and on the CPU: the locked store
    through 20 windows; a lock-free store through the same 20, then
    all-UPDATE and pure-GET windows (the fast path), its fastpath ledger
    rows equal too; a heat-tracked store under skewed readers, one
    rebalance, then a mixed window."""
    Pp, Bp, keys = 4, 8, np.arange(1, 41, dtype=np.uint32)
    cfg = dict(slots_per_node=8, value_width=W, num_locks=8,
               index_capacity=48)
    rng = np.random.default_rng(SEED + 1)
    windows = []
    for w in range(20):
        if w % 5 == 4:       # every lane hammers one key
            ks = np.full((Pp, Bp), keys[w % keys.size], np.uint32)
        else:
            ks = rng.choice(keys, size=(Pp, Bp)).astype(np.uint32)
        ops = rng.choice([GET, UPDATE, INSERT, DELETE, NOP],
                         size=(Pp, Bp), p=[.3, .2, .3, .1, .1]).astype(np.int32)
        vals = rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)
        windows.append((ops, ks, vals))
    stores = parity_run(torch, pt, "locked store", cfg,
                        [window_step(*w) for w in windows])
    st = pt.state_to_numpy(stores["cpu"][1])
    log(f"  20 windows bitwise equal on cuda and cpu (free slots left per "
        f"participant: {st.free_top.tolist()}, index overflow: "
        f"{st.idx_overflow.tolist()})")

    # the lock-free store: the same windows, then commuting ones
    live = keys[:16]
    fast = [(np.full((Pp, Bp), UPDATE, np.int32),
             rng.choice(live, size=(Pp, Bp)).astype(np.uint32),
             rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)),
            (np.full((Pp, Bp), GET, np.int32),
             rng.choice(keys, size=(Pp, Bp)).astype(np.uint32),
             np.zeros((Pp, Bp, W), np.int32)),
            (np.where(rng.random((Pp, Bp)) < .5, UPDATE, GET).astype(
                np.int32), np.full((Pp, Bp), live[3], np.uint32),
             rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32))]
    stores = parity_run(torch, pt, "lock-free store",
                        dict(cfg, lockfree=True),
                        [window_step(*w) for w in windows + fast],
                        ledger=True)
    rows = {dev: s[2].traffic.fastpath_summary() for dev, s in stores.items()}
    check(rows["cuda"] == rows["cpu"], f"fastpath rows differ: {rows}")
    r = rows["cuda"]["kv"]
    check(r["windows"] == len(windows) + len(fast) and
          r["fast_windows"] >= len(fast),
          f"lock-free store's fastpath rows {r}")
    log(f"  lock-free store: {len(windows) + len(fast)} windows bitwise "
        f"equal on cuda and cpu; fastpath rows equal, {r}")

    # the heat-tracked store: skewed readers, a rebalance, a mixed window
    hcfg = dict(slots_per_node=16, value_width=W, num_locks=16,
                index_capacity=128, track_heat=True)
    hkeys = np.arange(1, Pp * Bp + 1, dtype=np.uint32)
    steps = [window_step(np.full((Pp, Bp), INSERT, np.int32),
                         hkeys.reshape(Pp, Bp),
                         np.stack([hkeys * 3, hkeys * 5], -1).astype(
                             np.int32).reshape(Pp, Bp, W))]
    for _ in range(4):
        # reader r reads keys k = r mod 4, now and then another one
        rk = np.stack([rng.choice(hkeys[hkeys % Pp == r], Bp)
                       for r in range(Pp)]).astype(np.uint32)
        noise = rng.random((Pp, Bp)) < READ_NOISE
        rk[noise] = rng.choice(hkeys, int(noise.sum()))

        def read(kv, st, rk=rk):
            st, values, found = kv.get_batch(st, rk)
            return st, (values, found)
        steps.append(read)
    moved = []

    def rebalance(kv, st):
        st, n = kv.rebalance(st, 16)
        moved.append(int(n[0]))
        return st, (n,)
    steps.append(rebalance)
    mix = rng.choice([GET, UPDATE, INSERT, DELETE], size=(Pp, Bp)).astype(
        np.int32)
    steps.append(window_step(
        mix, rng.choice(np.arange(1, 49, dtype=np.uint32), (Pp, Bp)),
        rng.integers(-2 ** 31, 2 ** 31, (Pp, Bp, W)).astype(np.int32)))
    parity_run(torch, pt, "heat-tracked store", hcfg, steps)
    check(moved[0] == moved[1] > 0, f"rebalance moved {moved} rows")
    log(f"  heat-tracked store: prefill, 4 skewed read windows, a rebalance "
        f"({moved[0]} moves) and a mixed window bitwise equal on cuda and "
        f"cpu, heat counters included")


def phase_serving_parity(torch, pt):
    for arch in dict.fromkeys(path["arch"] for path in SERVE_PATHS):
        serving_parity(torch, pt, arch)


def serving_parity(torch, pt, arch):
    """The smoke engine of ``arch`` from the CPU tests, float32, one set of
    weights: generated tokens equal and the page-table state bitwise equal
    on the card and on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, max_batch=2, max_seq=48, device=dev,
                            params=tree_to(params, dev))
        out[dev] = (eng.generate(prompts, gen_len=4),
                    pt.state_to_numpy(eng._kv_state), eng.stats())
    check(out["cuda"][0] == out["cpu"][0],
          f"smoke {arch} engine tokens differ: cuda {out['cuda'][0]} vs cpu "
          f"{out['cpu'][0]}")
    for name in pt.KVStoreState._fields:
        a, b = getattr(out["cuda"][1], name), getattr(out["cpu"][1], name)
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"smoke {arch} engine page-table leaf {name} differs cuda "
                  f"vs cpu")
    check(out["cuda"][2]["kv_ops"] == out["cpu"][2]["kv_ops"],
          f"smoke {arch} engine kv_ops differ")
    log(f"  smoke {arch} engine: tokens {out['cuda'][0]} equal on cuda and "
        f"cpu, page table bitwise equal, kv_ops {out['cuda'][2]['kv_ops']}")


def cross_model_parity(torch):
    """The smoke llama-3.2-vision and whisper models in float32 on the card
    and on the CPU from one set of weights, with the vlm's gates set to
    seeded non-zero values (at the init's 0 a cross layer adds nothing) and
    a random seeded context: prefill's logits, three decode steps' logits
    and every cache leaf within 1e-4; and another context must move the
    card's logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.tree import flatten
    for arch in (VISION_ARCH, WHISPER_ARCH):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED + 12)
        for layer in params.get("layers", []):
            for name in ("gate_attn", "gate_ffn"):
                if name in layer:
                    layer[name] = torch.tensor(
                        float(rng.uniform(0.3, 1.2) * rng.choice([-1, 1])))
        B, S, s_max = 2, 10, 16
        tokens = torch.from_numpy(
            rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
        ctx, other_ctx = (torch.from_numpy(rng.standard_normal(
            (B, cfg.cross.n_context_tokens, cfg.d_model)).astype(np.float32))
            for _ in range(2))
        steps = [torch.from_numpy(rng.integers(1, cfg.vocab, (B, 1))
                                  .astype(np.int32)) for _ in range(3)]
        res = {}
        for dev in ("cuda", "cpu"):
            p = tree_to(params, dev)
            lg, cache, pos = model.prefill(
                p, {"tokens": tokens.to(dev), "context": ctx.to(dev)}, s_max)
            outs = [lg]
            for tok in steps:
                lg, cache = model.decode_step(p, tok.to(dev), cache, pos)
                pos = pos + 1
                outs.append(lg)
            res[dev] = (outs, flatten(cache))
            if dev == "cuda":
                other, _c, _p = model.prefill(
                    p, {"tokens": tokens.to(dev),
                        "context": other_ctx.to(dev)}, s_max)
                moved = float((other - outs[0]).abs().max())
                check(moved > 1e-3, f"smoke {arch}: another context moved "
                                    f"the card's logits by only {moved}")
        worst = 0.0
        for i, (a, b) in enumerate(zip(res["cuda"][0], res["cpu"][0])):
            d = float((a.cpu() - b).abs().max())
            check(d <= 1e-4, f"smoke {arch} logits {i}: cuda and cpu differ "
                             f"by {d}")
            worst = max(worst, d)
        for (path, a), (_p, b) in zip(res["cuda"][1], res["cpu"][1]):
            d = float((a.cpu() - b).abs().max())
            check(a.device.type == "cuda" and d <= 1e-4,
                  f"smoke {arch} cache {path}: {a.device}, cuda and cpu "
                  f"differ by {d}")
            worst = max(worst, d)
        log(f"  smoke {arch} model (seeded gates, random context): prefill, "
            f"3 decode steps and {len(res['cuda'][1])} cache leaves within "
            f"{worst:.3g} cuda vs cpu; another context moves the logits by "
            f"{moved:.3g}")


def np_tree(x):
    """A (nested) NamedTuple of tensors as numpy leaves, the port's int64
    uint32 holders back as uint32."""
    if isinstance(x, tuple):
        vals = [np_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    a = x.detach().cpu().numpy()
    return (a & 0xFFFFFFFF).astype(np.uint32) if a.dtype == np.int64 else a


def trees_equal(a, b):
    """Bitwise equality of two numpy trees: same structure, dtypes, bits."""
    if isinstance(a, tuple):
        return type(a) is type(b) and len(a) == len(b) and all(
            trees_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def phase_replicated_parity(torch, pt, devices=("cuda", "cpu")):
    """The smoke llama3.2-3b engine with two page-table replicas on the
    remote-DMA backend, its log leader killed before mutation window 1 and
    revived at window 6 (a cursor gap past the 3-entry ring: the snapshot
    rejoin runs), float32, one set of weights, on the card and on the CPU:
    equal tokens, and the page table, every replica, the log and the
    detector bitwise equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import FaultPlan
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = get_smoke_config(SERVE_ARCH).replace(dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    out = {}
    for dev in devices:
        eng = ServingEngine(cfg, max_batch=2, max_seq=48, replicas=2,
                            fault_plan=FaultPlan(kills={0: 1},
                                                 revives={0: 6}),
                            backend="pallas", device=dev,
                            params=tree_to(params, dev))
        toks = eng.generate(prompts, gen_len=4)
        out[dev] = (toks, np_tree((eng._kv_state, eng._rep_states,
                                   eng._log_state, eng._det_state)),
                    eng.stats()["replication"], eng.page_log.ring.publishes)
    card, cpu = (out[d] for d in devices)
    check(card[0] == cpu[0], f"replicated smoke engine tokens differ: cuda "
                             f"{card[0]} vs cpu {cpu[0]}")
    for i, part in enumerate(("page table", "replicas", "log", "detector")):
        check(trees_equal(card[1][i], cpu[1][i]),
              f"replicated smoke engine: {part} state differs cuda vs cpu")
    rep = card[2]
    check(rep == cpu[2] and card[3] == cpu[3],
          "replication stats differ cuda vs cpu")
    check(rep["detected_failovers"] == 1 and rep["rejoins_snapshot"] == 1
          and rep["diverged_leaves"] == [0, 0] and rep["dropped"] == 0,
          f"replicated smoke engine: {rep}")
    log(f"  replicated smoke {SERVE_ARCH} engine (pallas, kill 1, revive 6): "
        f"tokens {card[0]} equal on cuda and cpu; page table, replicas, log "
        f"and detector bitwise equal; {card[3]} ring publishes; replication "
        f"{rep}")


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def train_parity(torch):
    """One float32 training step from one set of weights and one batch, on
    the card and on the CPU (:func:`train_step_parity`): the smoke
    llama3.2-3b with AdamW, with Adafactor and with AdamW over 2
    microbatches, each also end to end; the smoke recurrentgemma-2b (RG-LRU
    and local attention) and rwkv6-7b (the WKV's training form), the smoke
    llama-3.2-vision (its gates seeded non-zero: at 0 a cross layer's
    weights get no gradient) and whisper on the pipeline's random context,
    with AdamW."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    for label, tkw in (("AdamW", {}),
                       ("Adafactor", dict(optimizer="adafactor")),
                       ("AdamW, microbatch=2", dict(microbatch=2))):
        cfg = get_smoke_config(TRAIN_ARCH).replace(dtype="float32")
        params0 = build_model(cfg).init(torch.Generator().manual_seed(SEED))
        train_step_parity(torch, cfg, params0, label, tkw, end_to_end=True)
    for arch in ("recurrentgemma-2b", "rwkv6-7b", VISION_ARCH,
                 WHISPER_ARCH):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        params0 = build_model(cfg).init(torch.Generator().manual_seed(SEED))
        rng = np.random.default_rng(SEED + 15)
        for layer in params0.get("layers", []):
            for name in ("gate_attn", "gate_ffn"):
                if name in layer:
                    layer[name] = torch.tensor(
                        float(rng.uniform(0.3, 1.2) * rng.choice([-1, 1])))
        train_step_parity(torch, cfg, params0, "AdamW", {})
    moe_train_parity(torch)


def moe_train_parity(torch):
    """The MoE family's training step, card against CPU
    (:func:`train_step_parity`): the smoke llama4-maverick and deepseek-v3
    in float32 with AdamW, on the local path and through
    ``make_train_step(..., mesh=)`` on a (1, ``MOE_PARITY_TP``) stacked
    mesh (``router_impl="a2a"``), each card step exactly 6 ``gmm`` (the
    forward and its ``remat="block"`` recompute), 3 ``gmm_dx`` and 3
    ``gmm_dw`` launches a MoE layer, the backward's all on the CUDA-core
    route (float32 stays exact: no TF32); then one
    ``make_grad_sync(mesh, compress="int8ef")`` step on the local path's
    card gradients (:func:`grad_sync_parity`).  The load-balance loss keeps
    its weight: card and CPU run the same path, the a2a one's aux the mean
    of the shards' (not the local path's)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import moe_gmm
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.models import build_model
    grads = None
    for arch in (MOE_ARCH, DS_ARCH):
        cfg = get_smoke_config(arch).replace(dtype="float32")
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        params0 = build_model(cfg).init(torch.Generator().manual_seed(SEED))
        want = {"gmm": 6 * n_moe, "gmm_dx": 3 * n_moe, "gmm_dw": 3 * n_moe}
        for label, mesh in (("AdamW, local", None),
                            (f"AdamW, (1, {MOE_PARITY_TP}) stacked mesh, a2a",
                             StackedMesh((1, MOE_PARITY_TP),
                                         ("data", "model")))):
            before = {n: getattr(moe_gmm, n).launches for n in want}
            routes = {n: dict(getattr(moe_gmm, n).routes)
                      for n in ("gmm_dx", "gmm_dw")}
            g = train_step_parity(torch, cfg, params0, label, {}, mesh=mesh)
            got = {n: getattr(moe_gmm, n).launches - before[n]
                   for n in want}
            simt = {n: getattr(moe_gmm, n).routes["simt"] - routes[n]["simt"]
                    for n in routes}
            check(got == want and simt == {n: want[n] for n in routes},
                  f"{arch} train step ({label}): launches {got}, expected "
                  f"{want}; CUDA-core backward launches {simt}")
            grads = g if grads is None else grads
    grad_sync_parity(torch, grads)


def grad_sync_parity(torch, grads):
    """One ``make_grad_sync(mesh, compress="int8ef")`` step on a (2, 2, 2)
    stacked (pod, data, model) mesh, on the card and on the CPU: every leaf
    of ``grads`` (float32 gradients of a card step) times (1 + 0.1·noise)
    drawn with numpy per participant, the same float32 values on both
    devices.  Every int8 payload and its scale (the values the cross-pod
    hop sends) bit for bit equal, and each synced leaf too."""
    from repro_torch.distributed.collectives import make_grad_sync
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.optim import compression as C
    mesh = StackedMesh((2, 2, 2), ("pod", "data", "model"))
    rng = np.random.default_rng(SEED + 18)
    stacked = {}
    for i, g in enumerate(grads):
        base = g.detach().float().cpu()
        noise = torch.from_numpy(rng.standard_normal(
            (*mesh.sizes, *base.shape)).astype(np.float32))
        stacked[f"leaf{i}"] = base * (1 + 0.1 * noise)
    out = {}
    for dev in ("cuda", "cpu"):
        sent, orig = [], C.int8_payload

        def spy(*a, **kw):
            q, scale = orig(*a, **kw)
            sent.append((q, scale))
            return q, scale
        C.int8_payload = spy
        try:
            synced = make_grad_sync(mesh, compress="int8ef")(
                {k: t.to(dev) for k, t in stacked.items()})
        finally:
            C.int8_payload = orig
        out[dev] = (sent, synced)
    (sent_c, synced_c), (sent_h, synced_h) = out["cuda"], out["cpu"]
    check(len(sent_c) == len(sent_h) == len(stacked),
          f"grad_sync: {len(sent_c)} / {len(sent_h)} int8 payloads for "
          f"{len(stacked)} leaves")
    for (qc, sc), (qh, sh) in zip(sent_c, sent_h):
        check(qc.device.type == "cuda" and qc.dtype == torch.int8
              and torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh),
              "grad_sync: an int8 payload or its scale differs between "
              "card and CPU")
    same = all(torch.equal(synced_c[k].cpu(), synced_h[k])
               for k in stacked)
    check(same, "grad_sync: a synced leaf differs between card and CPU")
    n_bytes = sum(q.numel() for q, _s in sent_c)
    log(f"  grad_sync on a {mesh.sizes} (pod, data, model) stacked mesh, "
        f"int8ef: {len(sent_c)} leaves, {n_bytes:,} int8 payload bytes and "
        f"their scales bit for bit equal card vs CPU, synced leaves too")


def train_step_parity(torch, cfg, params0, label, tkw, end_to_end=False,
                      mesh=None):
    """One step of ``cfg`` from ``params0`` on a 4 x 32-token pipeline
    batch (with its context, for the vlm and whisper), card against CPU:
    the loss within 1e-4 relative; every gradient leaf within ``GRAD_TOL``
    of the leaf's largest CPU gradient (what the model's kernels and their
    backward compute); every parameter and optimizer-state leaf after the
    card's update within 1e-4 of the CPU's update of the same (the card's)
    gradients; and, with ``end_to_end`` (the llama3.2-3b cases), the whole
    train step's parameters and state on each device within 1e-4, else
    that difference logged.  End to end, the other families' parameters
    are ill-conditioned in AdamW's first step: its update ``g / (|g| +
    eps)`` at |g| near eps = 1e-8 turns a gradient's float32 rounding into
    up to 2·lr (1.13e-4 on rwkv6's ``embed/head`` on an H100).  ``mesh``
    goes to ``make_train_step`` on both devices.  Returns the card's
    gradients."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens, place_batch
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, leaves, tree_map, unflatten
    batch = SyntheticTokens(cfg, 4, 32, SEED).get_batch(0)
    what = f"{cfg.name} train step ({label})"
    fresh = {dev: (lambda dev=dev: tree_map(
        lambda t: t.detach().to(dev, copy=True), params0))
        for dev in ("cuda", "cpu")}
    res = {}
    for dev in ("cuda", "cpu"):
        model, opt, step = make_train_step(
            cfg, TrainConfig(lr=1e-3, **tkw), dev, mesh=mesh)
        params = fresh[dev]()
        ps = [p.requires_grad_(True) for p in leaves(params)]
        loss, _met = model.train_loss(params, place_batch(batch, dev))
        grads = [g.detach() for g in torch.autograd.grad(loss, ps)]
        res[dev] = (float(loss.detach()), grads, opt, step)
    (loss_c, g_c, opt_c, step_c), (loss_h, g_h, opt_h, step_h) = (
        res["cuda"], res["cpu"])
    check(abs(loss_c - loss_h) <= 1e-4 * abs(loss_h),
          f"{what}: loss {loss_c} vs {loss_h}")
    worst_g = 0.0
    for (path, _t), a, b in zip(flatten(params0), g_c, g_h):
        d = float((a.cpu() - b).abs().max()) if a.numel() else 0.0
        scale = max(GRAD_TOL[1], float(b.abs().max()) if b.numel()
                    else 0.0)
        check(a.device.type == "cuda" and a.shape == b.shape
              and d <= GRAD_TOL[0] * scale,
              f"{what}: gradient {path} {a.device}, cuda and cpu differ by "
              f"{d}, past {GRAD_TOL[0]} of {scale}")
        worst_g = max(worst_g, d / scale)

    def update(opt, params, grads):
        with torch.no_grad():
            p, st, _stats = opt.update(unflatten(params, grads),
                                       opt.init(params), params)
        return flatten({"params": p, "opt": st})
    g_c_host = [g.cpu() for g in g_c]   # the update clips in place
    card = update(opt_c, fresh["cuda"](), g_c)
    same = update(opt_h, fresh["cpu"](), g_c_host)
    worst = 0.0
    for (path, a), (_p, b) in zip(card, same):
        d = float((a.detach().cpu().float() - b.float()).abs().max()) \
            if a.numel() else 0.0
        check(a.device.type == "cuda" and a.shape == b.shape and d <= 1e-4,
              f"{what}: update {path} {a.device}, cuda and cpu differ by "
              f"{d} on the same gradients")
        worst = max(worst, d)
    if end_to_end:
        pairs = []
        for dev, opt, step in (("cuda", opt_c, step_c), ("cpu", opt_h,
                                                         step_h)):
            params = fresh[dev]()
            params, state, _met = step(params, opt.init(params), batch)
            pairs.append(flatten({"params": params, "opt": state}))
    else:
        pairs = [card, update(opt_h, fresh["cpu"](), g_h)]
    e2e = 0.0
    for (path, a), (_p, b) in zip(*pairs):
        check(a.device.type == "cuda" and a.shape == b.shape,
              f"{what} {path}: {a.device} {tuple(a.shape)} vs "
              f"{tuple(b.shape)}")
        d = float((a.detach().cpu().float() - b.detach().float())
                  .abs().max()) if a.numel() else 0.0
        check(d <= 1e-4 or not end_to_end,
              f"{what} {path}: cuda and cpu differ by {d} end to end")
        e2e = max(e2e, d)
    log(f"  smoke {what}: loss {loss_c:.6f} / {loss_h:.6f}, {len(g_c)} "
        f"gradient leaves within {worst_g:.3g} of their largest, "
        f"{len(card)} parameter and state leaves after the update within "
        f"{worst:.3g} cuda vs cpu on the same gradients, {e2e:.3g} end to "
        f"end{'' if end_to_end else ' (logged, not held)'}")
    return g_c


# ---------------------------------------------------------------------------
# phase 4: the main path at a deployment's size
# ---------------------------------------------------------------------------

class Oracle:
    """Sequential replay of the window semantics: GETs see the state at the
    window start; mutations apply in (participant, lane) order; an INSERT
    takes a slot of its writer's node and fails on a present key or a full
    node."""

    def __init__(self, keys, slots, nodes=P):
        self.present = np.zeros(keys + 1, dtype=bool)
        self.value = np.zeros((keys + 1, W), dtype=np.int32)
        self.home = np.zeros(keys + 1, dtype=np.int64)
        self.free = np.full(nodes, slots, dtype=np.int64)

    def window(self, ops, keys, vals):
        """Expected (GET values, found) of one (nodes, B) window."""
        flat_k = keys.reshape(-1).astype(np.int64)
        exp_found = np.zeros(flat_k.size, dtype=bool)
        exp_val = np.zeros((flat_k.size, W), dtype=np.int32)
        lanes = ops.shape[1]
        is_get = ops.reshape(-1) == GET
        exp_found[is_get] = self.present[flat_k[is_get]]
        exp_val[is_get] = np.where(exp_found[is_get, None],
                                   self.value[flat_k[is_get]], 0)
        flat_v = vals.reshape(-1, W)
        for n in np.flatnonzero(~is_get & (ops.reshape(-1) != NOP)):
            op, k, p = ops.reshape(-1)[n], flat_k[n], n // lanes
            if op == INSERT:
                ok = not self.present[k] and self.free[p] > 0
                if ok:
                    self.present[k], self.home[k] = True, p
                    self.free[p] -= 1
            else:
                ok = bool(self.present[k])
                if ok and op == DELETE:
                    self.present[k] = False
                    self.free[self.home[k]] += 1
            if ok and op in (INSERT, UPDATE):
                self.value[k] = flat_v[n]
            exp_found[n] = ok
        return exp_val.reshape(ops.shape + (W,)), exp_found.reshape(ops.shape)

    def move(self, keys, dests):
        """Expected ``moved`` of one MOVE window of distinct keys: a present
        key moves to its destination when that node has a free slot, and a
        move to its own home succeeds with no effect."""
        flat_k = keys.reshape(-1).astype(np.int64)
        ok = np.zeros(flat_k.size, dtype=bool)
        for n, (k, d) in enumerate(zip(flat_k, dests.reshape(-1))):
            if not self.present[k]:
                continue
            if self.home[k] != d:
                if self.free[d] == 0:
                    continue
                self.free[self.home[k]] += 1
                self.free[d] -= 1
                self.home[k] = d
            ok[n] = True
        return ok.reshape(keys.shape)


def zipf_sampler(rng):
    ranks = np.arange(1, KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    scramble = rng.permutation(KEYS) + 1          # rank → key
    return lambda n: scramble[np.minimum(np.searchsorted(cdf, rng.random(n)),
                                         KEYS - 1)].astype(np.uint32)


def mixed_window(rng, w, nodes=P):
    """The examples/kvstore_app.py mix: 60/20/10/10 GET/UPDATE/INSERT/DELETE
    over nodes·B distinct uniform keys."""
    span = nodes * B
    ks = rng.choice(KEYS, size=span, replace=False).astype(np.uint32) + 1
    ops = rng.choice([GET, UPDATE, INSERT, DELETE], size=span,
                     p=[.6, .2, .1, .1]).astype(np.int32)
    vals = np.stack([ks.astype(np.int32) * 5 + w,
                     np.full(span, w, np.int32)], 1)
    return (ops.reshape(nodes, B), ks.reshape(nodes, B),
            vals.reshape(nodes, B, W))


def zipf_window(zipf, rng, w):
    """YCSB-B: 95/5 GET/UPDATE over zipf keys, duplicates allowed."""
    span = P * B
    ks = zipf(span)
    ops = np.where(rng.random(span) < 0.95, GET, UPDATE).astype(np.int32)
    vals = np.stack([ks.astype(np.int32) * 7 + w,
                     np.full(span, -w, np.int32)], 1)
    return ops.reshape(P, B), ks.reshape(P, B), vals.reshape(P, B, W)


def profiled_windows(torch, kv, st, oracle, windows, label):
    """Run ``windows`` under torch.profiler: the device's busy share of the
    wall time (kernels, copies and fills on the card), the host reads
    (``item``/``bool``, ``nonzero``) per window and the busiest device
    operations.  Every window is oracle-checked."""
    from torch.profiler import ProfilerActivity, profile
    results = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for ops, ks, vals in windows:
            st, res = kv.op_window(st, ops, ks, vals)
            results.append(res)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for i, ((ops, ks, vals), res) in enumerate(zip(windows, results)):
        verify(res, oracle.window(ops, ks, vals), f"profiled {label} {i}")
    device_us, by_name, host_reads = 0.0, {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        elif e.name in ("aten::_local_scalar_dense", "aten::nonzero"):
            host_reads[e.name] = host_reads.get(e.name, 0) + 1
    n = len(windows)
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    out = dict(windows=n, wall_ms_per_window=wall_us / n / 1e3,
               device_busy_share=(device_us / wall_us) if device_us else None,
               host_reads_per_window={k: v / n for k, v in host_reads.items()},
               top_device_ms_per_window={k[:60]: v / n / 1e3 for k, v in top})
    log(f"  profile ({label}): {json.dumps(out)}")
    return st, out


def timed_window(torch, kv, st, ops, keys, vals):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, res = kv.op_window(st, ops, keys, vals)
    torch.cuda.synchronize()
    return st, res, time.perf_counter() - t0


def verify(res, exp, what):
    exp_val, exp_found = exp
    found = res.found.cpu().numpy()
    check(np.array_equal(found, exp_found),
          f"{what}: {int((found != exp_found).sum())} lanes' found differ "
          f"from the oracle")
    check(np.array_equal(res.value.cpu().numpy(), exp_val),
          f"{what}: GET values differ from the oracle")


def tree_clone(tree):
    """A copy of every tensor of a (nested) NamedTuple state."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_clone(v) for v in tree))
    return tree.clone()


def differing_leaves(torch, a, b, prefix=""):
    """Paths of the leaves on which two states differ (bitwise, on the
    device)."""
    if isinstance(a, tuple):
        out = []
        for f in a._fields:
            out += differing_leaves(torch, getattr(a, f), getattr(b, f),
                                    f"{prefix}{f}.")
        return out
    same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return [] if same else [prefix.rstrip(".")]


def kernel_counts(rdma):
    return {k.__name__: k.launches for k in rdma.KERNELS}


def window_stats(times, span):
    return dict(p50_ms=float(np.percentile(times, 50)) * 1e3,
                p99_ms=float(np.percentile(times, 99)) * 1e3,
                ops_per_s=span * len(times) / float(np.sum(times)))


def phase_main_path(torch, pt, rdma, slots):
    """The KVStore path: the locked store and, from the prefilled state on
    (phase 4a), its lock-free twin run the same windows, the twin bitwise
    equal to the locked store after every one; then the migration scenario
    (phase 4c) on the final state.  The timed and profiled windows run with
    the traffic ledger off on both stores; the twin's fast-path rows come
    from an untimed replay of the same windows with its ledger on.  Returns
    the metrics and the remote-DMA kernels' launches, counted from 0 over
    this path alone."""
    cfg = dict(slots_per_node=slots, value_width=W, num_locks=4096,
               index_capacity=4 * KEYS)
    mgr = pt.make_manager(P, backend="pallas")
    kv = pt.KVStore(None, "kv", mgr, **cfg)
    st = kv.init_state()
    torch.cuda.synchronize()
    log(f"  store: P={P} K={KEYS} slots/node={slots} index={4 * KEYS} "
        f"locks=4096 window={B}/participant; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    rng = np.random.default_rng(SEED + 2)
    oracle = Oracle(KEYS, slots)
    span = P * B
    n_fill = int(KEYS * FILL)
    fill_keys = np.arange(1, n_fill + 1, dtype=np.uint32)
    for k in rdma.KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- prefill: 80% of K through INSERT windows
    t_fill = 0.0
    n_windows = 0
    for i in range(0, n_fill, span):
        chunk = fill_keys[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        vals = np.zeros((span, W), np.int32)
        ops[:chunk.size] = INSERT
        ks[:chunk.size] = chunk
        vals[:chunk.size, 0] = chunk.astype(np.int32) * 3
        ops, ks, vals = ops.reshape(P, B), ks.reshape(P, B), \
            vals.reshape(P, B, W)
        st, res, dt = timed_window(torch, kv, st, ops, ks, vals)
        t_fill += dt
        n_windows += 1
        verify(res, oracle.window(ops, ks, vals),
               f"prefill window {i // span}")
    check(int(oracle.present.sum()) == n_fill, "prefill lost keys")
    log(f"  prefill: {n_fill} inserts in {n_windows} windows, oracle-checked")
    # the locked store's peak over its prefill, before any twin exists
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # -- 4a: the lock-free twin, from a copy of the prefilled state
    lf_mgr = pt.make_manager(P, backend="pallas")
    lf = pt.KVStore(None, "kv", lf_mgr, lockfree=True, **cfg)
    lst = tree_clone(st)
    torch.cuda.synchronize()
    log(f"  4a: lock-free twin from the prefilled state; device memory "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")

    def both(ops, ks, vals, what, counts=None, record=None):
        """The window on the locked store, then on the twin: both
        oracle-checked, the twin's state bitwise the locked one's."""
        nonlocal st, lst
        exp = oracle.window(ops, ks, vals)
        if record is not None:
            record.append(((ops, ks, vals), exp))
        st, res, dt = timed_window(torch, kv, st, ops, ks, vals)
        verify(res, exp, what)
        before = kernel_counts(rdma)
        lst, lres, ldt = timed_window(torch, lf, lst, ops, ks, vals)
        after = kernel_counts(rdma)
        verify(lres, exp, f"lock-free {what}")
        diff = differing_leaves(torch, st, lst)
        check(not diff, f"{what}: the lock-free twin differs from the locked "
                        f"store on {diff}")
        if counts is not None:
            counts.append({k: after[k] - before[k] for k in after})
        return dt, ldt

    def fastpath_replay(start, recorded, what):
        """The recorded windows again on a copy of the twin's state from
        before them, untimed and with the twin's ledger on: every result
        oracle-checked, the end state bitwise the timed twin's.  Returns
        the twin's fastpath row over these windows."""
        lf_mgr.traffic.reset()
        lf_mgr.traffic.enable()
        rst = start
        for i, (win, exp) in enumerate(recorded):
            rst, res = lf.op_window(rst, *win)
            verify(res, exp, f"ledger replay of {what} {i}")
        lf_mgr.traffic.disable()
        diff = differing_leaves(torch, rst, lst)
        check(not diff, f"the ledger replay of the {what}s ends off the timed "
                        f"twin on {diff}")
        return lf_mgr.traffic.fastpath_summary()["kv"]

    # -- the examples/kvstore_app.py mix over distinct uniform keys
    mix_t, lf_mix_t, recorded = [], [], []
    start = tree_clone(lst)
    for w in range(MIX_WINDOWS):
        dt, ldt = both(*mixed_window(rng, w), f"mixed window {w}",
                       record=recorded)
        mix_t.append(dt)
        lf_mix_t.append(ldt)
    mix_fast = fastpath_replay(start, recorded, "mixed window")
    check(mix_fast["windows"] == MIX_WINDOWS and mix_fast["fast_rate"] == 0.0,
          f"every mixed window holds INSERT and DELETE lanes, so none may "
          f"take the fast path: {mix_fast}")
    log(f"  {MIX_WINDOWS} mixed windows oracle-checked; the lock-free twin "
        f"bitwise equal after each, fastpath {mix_fast}")

    # -- YCSB-B: 95/5 GET/UPDATE over zipf keys, duplicates allowed
    zipf = zipf_sampler(rng)
    zipf_t, lf_zipf_t, lf_counts, recorded = [], [], [], []
    start = tree_clone(lst)
    for w in range(ZIPF_WINDOWS):
        dt, ldt = both(*zipf_window(zipf, rng, w), f"zipf window {w}",
                       counts=lf_counts, record=recorded)
        zipf_t.append(dt)
        lf_zipf_t.append(ldt)
    zipf_fast = fastpath_replay(start, recorded, "zipf window")
    del start, recorded
    check(zipf_fast["windows"] == ZIPF_WINDOWS
          and zipf_fast["fast_rate"] == 1.0,
          f"every zipf window must take the fast path: {zipf_fast}")
    # a fast window's launches: the GETs' read verb (descriptors + row
    # gather) and ONE write verb (descriptors + row commit), nothing else
    one_write = {"build_descriptors": 2, "gather_rows": 1, "scatter_rows": 1}
    check(all(c == one_write for c in lf_counts),
          f"a fast zipf window's launches differ from one read verb and one "
          f"write verb: {lf_counts}")
    log(f"  {ZIPF_WINDOWS} zipf windows oracle-checked; the lock-free twin "
        f"bitwise equal after each, fastpath {zipf_fast}, launches a window "
        f"{lf_counts[0]}")

    # -- where a window's time goes: two more windows of each mix under
    # the profiler on each store (untimed above, oracle-checked, the twin
    # bitwise equal at the end)
    profiles, lf_profiles = {}, {}
    for label, gen in [("mixed", lambda w: mixed_window(rng, w)),
                       ("zipf", lambda w: zipf_window(zipf, rng, w))]:
        wins = [gen(100 + w) for w in range(2)]
        probe = Oracle.__new__(Oracle)
        probe.__dict__ = {k: v.copy() for k, v in oracle.__dict__.items()}
        st, profiles[label] = profiled_windows(torch, kv, st, oracle, wins,
                                               label)
        lst, lf_profiles[label] = profiled_windows(
            torch, lf, lst, probe, wins, f"lock-free {label}")
        diff = differing_leaves(torch, st, lst)
        check(not diff, f"profiled {label}: the twin differs on {diff}")

    # -- a final read of random keys through get_batch
    probe = rng.integers(1, KEYS + 1, size=(P, B)).astype(np.uint32)
    _st, values, found = kv.get_batch(st, probe)
    exp_found = oracle.present[probe.astype(np.int64)]
    check(np.array_equal(found.cpu().numpy(), exp_found),
          "get_batch found differs from the oracle")
    check(np.array_equal(values.cpu().numpy(),
                         np.where(exp_found[..., None],
                                  oracle.value[probe.astype(np.int64)], 0)),
          "get_batch values differ from the oracle")
    log(f"  get_batch of {P * B} random keys oracle-checked")
    del lst, _st
    torch.cuda.synchronize()
    peak_twin = torch.cuda.max_memory_allocated()

    # -- 4c: the migration scenario on the final state
    migration = phase_migration(torch, pt, cfg, st, oracle, slots)
    torch.cuda.synchronize()
    launches = kernel_counts(rdma)
    zs, lzs = window_stats(zipf_t, span), window_stats(lf_zipf_t, span)
    ms, lms = window_stats(mix_t, span), window_stats(lf_mix_t, span)
    return dict(
        prefill_ops=n_fill, prefill_windows=n_windows, prefill_s=t_fill,
        prefill_ops_per_s=n_fill / t_fill,
        mix_window_p50_ms=ms["p50_ms"], mix_window_p99_ms=ms["p99_ms"],
        mix_ops_per_s=ms["ops_per_s"],
        zipf_window_p50_ms=zs["p50_ms"], zipf_window_p99_ms=zs["p99_ms"],
        zipf_ops_per_s=zs["ops_per_s"],
        peak_device_gib=peak / 2 ** 30,
        peak_device_gib_with_twin=peak_twin / 2 ** 30, profile=profiles,
        lockfree=dict(mix=dict(lms, fastpath=mix_fast),
                      zipf=dict(lzs, fastpath=zipf_fast,
                                launches_per_window=lf_counts[0]),
                      profile=lf_profiles),
        migration=migration), launches


def reader_keys(rng, n_keys):
    """One (P, B) skewed read window (benchmarks/bench_locality.py): reader
    r draws zipf(0.99) ranks from its shard {k = r mod P}, rank i being key
    (i - 1)·P + r (key 0 read as P), and 10% of the lanes are uniform
    noise."""
    shard = n_keys // P
    ranks = np.arange(1, shard + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    rank = np.minimum(np.searchsorted(cdf, rng.random((P, B))), shard - 1)
    keys = rank.astype(np.int64) * P + np.arange(P)[:, None]
    keys = np.where(keys == 0, P, keys)
    noise = rng.random((P, B)) < READ_NOISE
    keys[noise] = rng.integers(1, n_keys + 1, size=int(noise.sum()))
    return keys.astype(np.uint32)


def phase_migration(torch, pt, cfg, st, oracle, slots):
    """Phase 4c: a heat-tracked twin of the store gets the final state's
    leaves and a fresh heat leaf; MIGRATION_READS skewed read windows feed
    the HotTracker; ``rebalance(REBALANCE_MOVES)`` runs up to
    REBALANCE_PASSES times (moves plus backlog must equal the proposals
    each pass made); the first read window is read again and its modeled
    wire bytes must fall; every GET, and a mixed window after the
    migration, are oracle-checked."""
    mgr = pt.make_manager(P, backend="pallas")
    mgr.traffic.enable()
    kv = pt.KVStore(None, "kv", mgr, track_heat=True, **cfg)
    hst = st._replace(heat=kv.hot.init_state())
    rng = np.random.default_rng(SEED + 9)
    reads = [reader_keys(rng, KEYS) for _ in range(MIGRATION_READS)]

    def read(keys, what):
        nonlocal hst
        hst, values, found = kv.get_batch(hst, keys)
        k = keys.astype(np.int64)
        exp = oracle.present[k]
        check(np.array_equal(found.cpu().numpy(), exp),
              f"{what}: found differs from the oracle")
        check(np.array_equal(values.cpu().numpy(), np.where(
            exp[..., None], oracle.value[k], 0)),
            f"{what}: values differ from the oracle")

    def wire_bytes(keys):
        """Modeled wire bytes of one read window (its state is dropped)."""
        mgr.traffic.reset()
        kv.get_batch(hst, keys)
        return mgr.traffic.total_bytes()

    wire_before = wire_bytes(reads[0])
    for i, keys in enumerate(reads):
        read(keys, f"skewed read window {i}")
    passes = []
    for i in range(REBALANCE_PASSES):
        _k, _d, valid, _a, _av = kv.rebalance_proposals(
            hst, REBALANCE_MOVES, with_alts=True)
        n_prop = int(valid.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hst, n_moved = kv.rebalance(hst, REBALANCE_MOVES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved, backlog = int(n_moved[0]), int(hst.heat.backlog[0])
        check(0 <= moved <= n_prop and moved + backlog == n_prop
              and (n_moved == moved).all(),
              f"rebalance pass {i}: {moved} moves and backlog {backlog} for "
              f"{n_prop} proposals")
        passes.append(dict(proposals=n_prop, moves=moved, backlog=backlog,
                           ms=dt * 1e3))
        if n_prop == 0:
            break
    check(sum(p["moves"] for p in passes) > 0, "rebalance moved no row")
    # the oracle follows the moves: homes and free slots from the index,
    # once the index holds exactly the oracle's keys, each in one entry
    # with a home on the cluster, and every home's free stack is its slots
    # less the rows it homes
    idx = hst.idx[0].cpu().numpy()
    used = idx[:, 0] == 1
    homes = idx[used]
    keys = homes[:, 1].astype(np.uint32).astype(np.int64)
    check(np.array_equal(np.sort(keys), np.flatnonzero(oracle.present)),
          "the index's keys differ from the oracle's across migration")
    check(bool(((homes[:, 2] >= 0) & (homes[:, 2] < P)).all()),
          "an index entry names a home off the cluster")
    free = slots - np.bincount(homes[:, 2], minlength=P)
    check(np.array_equal(hst.free_top.cpu().numpy(), free),
          f"the homes' free stacks differ from their rows: "
          f"{hst.free_top.tolist()} vs {free.tolist()}")
    oracle.home[keys] = homes[:, 2]
    oracle.free = free
    wire_after = wire_bytes(reads[0])
    read(reads[0], "skewed read window 0 after migration")
    check(wire_after < wire_before,
          f"the skewed read window's modeled wire bytes did not fall: "
          f"{wire_before} -> {wire_after}")
    ops, ks, vals = mixed_window(rng, 200)
    hst, res = kv.op_window(hst, ops, ks, vals)
    verify(res, oracle.window(ops, ks, vals), "mixed window after migration")
    out = dict(read_windows=MIGRATION_READS, passes=passes,
               moves=sum(p["moves"] for p in passes),
               backlog=passes[-1]["backlog"],
               rebalance_ms=[p["ms"] for p in passes],
               wire_bytes_before=wire_before, wire_bytes_after=wire_after)
    log(f"  4c migration: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 4b: the failover scenario on the KVStore path's store
# ---------------------------------------------------------------------------

def failover_run(torch, pt, rdma, *, nodes=P, mesh=None, fill_windows=None,
                 mix_windows=MIX_WINDOWS, digests=None):
    """Steps 1-7 of benchmarks/bench_failover.py at the KVStore path's
    store shape, on the remote-DMA backend, on one binding: the stacked one
    (``mesh`` None, the ``nodes`` participants on the card) or one
    participant a rank of ``mesh`` (a ``ProcessMesh(nodes)``; every rank
    calls this at once, and the steering reads are world-uniform).

    A leader store, two follower stores and a ReplicatedLog(window=B,
    capacity=4), a FailureDetector(threshold=2).  Prefill 80% of K (or
    ``fill_windows`` INSERT windows) and run ``mix_windows`` mixed windows,
    each appended and synced.  With more than one participant, participant
    0, the leader, dies before mixed window FO_KILL: the window before it is
    acked but unsynced; heartbeat windows run until the detector's verdict;
    a follower is promoted; the followers catch up; the in-flight window is
    retried through the new leader; a zombie publish at the stale epoch is
    fenced.  Participant 0 comes back before window FO_REVIVE with a cursor
    gap of the ring's capacity and rejoins by ring-tail replay.  A
    participant's slice of a window is NOP while it is dead or behind the
    log, and in the window before its death: a slice replayed late would
    commit in another order than on the leader.  Every GET and ``found`` of
    the leader is checked against the oracle; the followers must equal the
    leader bitwise at the end.  ``digests`` (a dict) receives, after the
    fill, every mixed window, the promotion and the rejoin, the digests of
    every held participant's blocks of the leader, the followers, the log
    and the detector.  Returns the metrics and the launches of the path's
    kernels (the ring's hop kernel ``remote_copy`` stacked,
    ``remote_copy_peers`` between ranks)."""
    from repro_torch.core import (FailureDetector, ReplicatedLog,
                                  diverging_leaves)
    mgr = pt.make_manager(nodes, backend="pallas", mesh=mesh)
    rt = mgr.runtime
    mgr.traffic.enable()
    slots = KEYS // nodes + 4
    kw = dict(slots_per_node=slots, value_width=W, num_locks=4096,
              index_capacity=4 * KEYS)
    lead = pt.KVStore(None, "fo_lead", mgr, **kw)
    fols = [pt.KVStore(None, f"fo_foll{i}", mgr, **kw) for i in range(2)]
    rlog = ReplicatedLog(None, "fo_log", mgr, store=lead, window=B,
                         capacity=LOG_CAPACITY)
    det = FailureDetector(None, "fo_det", mgr, threshold=DETECT_THRESHOLD)
    st = dict(lead=lead.init_state(),
              fols=tuple(f.init_state() for f in fols),
              log=rlog.init_state(), det=det.init_state())
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  three stores of P={nodes} K={KEYS} and a log of "
        f"{rlog.entry_width}-word entries; device memory {state_gib:.3f} "
        f"GiB" + ("" if rt.stacked else f" on rank {rt.rank}"))
    held = rt.my_id().tolist()
    alive = np.ones(nodes, bool)
    oracle = Oracle(KEYS, slots, nodes)
    rng = np.random.default_rng(SEED + 7)
    hop = rdma.remote_copy if rt.stacked else rdma.remote_copy_peers
    kernels = rdma.KERNELS + (hop,)
    for k in kernels:
        k.launches = 0
    rlog.ring.publishes = 0
    torch.cuda.reset_peak_memory_stats()
    kill = nodes > 1

    def cut(a):
        return a[held[0]:held[-1] + 1]

    def mask():
        return torch.from_numpy(alive.copy()).cuda()

    def digest(label):
        if digests is not None:
            trees = (st["lead"], *st["fols"], st["log"], st["det"])
            digests[label] = [pm4_digests(torch, trees, p - held[0])
                              for p in held]

    def apply(ops, ks, vals, what):
        st["lead"], res = lead.op_window(st["lead"], cut(ops), cut(ks),
                                         cut(vals))
        verify(res, tuple(cut(e) for e in oracle.window(ops, ks, vals)),
               what)

    def heartbeat():
        st["log"], st["det"], verdict = rlog.heartbeat_and_detect(
            st["log"], st["det"], det, pred=rt.mine(mask()))
        return verdict[0].cpu().numpy()

    def append(ops, ks, vals):
        a = mask()
        st["log"], ok = rlog.append(st["log"], cut(ops), cut(ks), cut(vals),
                                    pred=a[st["log"].ring.owner.long()])
        return bool(ok[0])

    def sync():
        st["log"], st["fols"], n = rlog.sync(st["log"], fols, st["fols"],
                                             max_entries=1,
                                             pred=rt.mine(mask()))
        return int(rt.gather(n).cpu().numpy()[alive].min())  # live lanes

    def lag():
        return int(rlog.lag(st["log"])[0])

    def converged(lanes=None):
        sel = None if lanes is None else torch.from_numpy(lanes).cuda()
        return not rt.any(any(diverging_leaves(st["lead"], f, lanes=sel,
                                               rt=rt)
                              for f in st["fols"]))

    def window(w, quiet=()):
        ops, ks, vals = mixed_window(rng, w, nodes)
        for p in quiet:
            ops[p] = NOP
        return ops, ks, vals

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. prefill through the log, each window appended and synced
    span = nodes * B
    n_fill = int(KEYS * FILL) if fill_windows is None else fill_windows * span
    fill_keys = np.arange(1, n_fill + 1, dtype=np.uint32)
    t_fill = time.perf_counter()
    n_fill_windows = 0
    for i in range(0, n_fill, span):
        chunk = fill_keys[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        vals = np.zeros((span, W), np.int32)
        ops[:chunk.size] = INSERT
        ks[:chunk.size] = chunk
        vals[:chunk.size, 0] = chunk.astype(np.int32) * 3
        ops, ks, vals = ops.reshape(nodes, B), ks.reshape(nodes, B), \
            vals.reshape(nodes, B, W)
        apply(ops, ks, vals, f"replicated prefill window {i // span}")
        check(append(ops, ks, vals), "a prefill window was not acked")
        check(sync() == 1, "a prefill window was not replayed")
        n_fill_windows += 1
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t_fill
    acked = n_fill_windows
    digest("fill")
    log(f"  replicated prefill: {n_fill} inserts in {n_fill_windows} windows "
        f"in {t_fill:.1f} s, each appended and synced, oracle-checked")

    # -- steady state: apply, heartbeat, append, sync
    def steady(w, quiet=()):
        ops, ks, vals = window(w, quiet)

        def step():
            apply(ops, ks, vals, f"mixed window {w}")
            heartbeat()
            ok = append(ops, ks, vals)
            return ok, sync()
        (ok, n), dt = timed(step)
        check(ok and n == 1 and lag() == 0,
              f"mixed window {w}: ok {ok}, replayed {n}, lag {lag()}")
        digest(f"mix {w}")
        return dt

    if not kill:
        steady_t = [steady(w) for w in range(mix_windows)]
        acked += mix_windows
        metrics = dict(detection_windows=None, promotion_ms=None,
                       catchup_syncs=None, retry_ms=None, fenced=None,
                       ledger_fenced=None, replay_rejoin_entries=None,
                       replay_rejoin_ms=None)
        winner = 0
    else:
        steady_t = [steady(w) for w in range(FO_KILL - 1)]
        acked += FO_KILL - 1

        # -- 2. the last window before the crash: acked, not synced
        ops, ks, vals = window(FO_KILL - 1, quiet=(0,))
        apply(ops, ks, vals, f"mixed window {FO_KILL - 1}")
        heartbeat()
        check(append(ops, ks, vals), "the pre-crash window must be acked")
        acked += 1
        check(lag() == 1, "the pre-crash window must stay unsynced")
        digest(f"mix {FO_KILL - 1}")

        # -- 3a. participant 0 dies: heartbeat windows until the verdict
        alive[0] = False
        detect = 0
        verdict = np.ones(nodes, bool)
        while verdict[0]:
            verdict = heartbeat()
            detect += 1
            check(detect <= 2 * DETECT_THRESHOLD,
                  "no verdict on participant 0")
        check(detect == DETECT_THRESHOLD and not verdict[0]
              and verdict[1:].all(),
              f"verdict {verdict.tolist()} after {detect} windows")

        # -- 3. promotion, driven by the verdict
        (st["log"], winner), promote_s = timed(lambda: rlog.promote(
            st["log"], torch.from_numpy(verdict.copy()).cuda()))
        winner = int(winner[0])
        check(winner == 1, f"equal cursors: rank 1 must win, got {winner}")
        digest("promote")

        # -- 4. bounded catch-up, then zero acked-window loss on the live
        # lanes
        catchup = 0
        while lag():
            sync()
            catchup += 1
            check(catchup <= LOG_CAPACITY,
                  "catch-up must be bounded by the ring")
        check(converged(lanes=alive), "a follower lost acked windows "
                                      "across the failover")

        # -- 5. the in-flight window retries through the new leader
        ops, ks, vals = window(FO_KILL, quiet=(0,))

        def retry():
            apply(ops, ks, vals, f"retried window {FO_KILL}")
            heartbeat()
            a = mask()
            st["log"], st["fols"], ok, _n = rlog.append_with_retry(
                st["log"], cut(ops), cut(ks), cut(vals), fols, st["fols"],
                max_attempts=2, pred=a[st["log"].ring.owner.long()],
                sync_pred=rt.mine(a))
            return bool(ok[0])
        ok, retry_s = timed(retry)
        check(ok and lag() == 0, "the retried window must publish and drain")
        acked += 1
        digest(f"mix {FO_KILL}")

        # -- 6. a zombie publish from the dead leader is fenced at delivery
        zops = np.full((nodes, B), NOP, np.int32)
        zops[1, 0] = UPDATE
        zks = np.ones((nodes, B), np.uint32)
        zks[1, 0] = 1
        zvals = np.full((nodes, B, W), -777, np.int32)
        st["log"], landed = rlog.zombie_publish(
            st["log"], cut(zops), cut(zks), cut(zvals), zombie=0,
            stale_epoch=0)
        check(bool(landed[0]), "the zombie write must land in the ring")
        check(sync() == 0, "a fenced entry must not apply")
        fenced = int(st["log"].fenced[0])
        check(fenced >= 1, "the zombie entry must be counted as fenced")

        # -- 7. more windows through the new leader, participant 0 still
        # dead
        steady_t += [steady(w, quiet=(0,))
                     for w in range(FO_KILL + 1, FO_REVIVE)]
        acked += FO_REVIVE - FO_KILL - 1

        # -- participant 0 comes back: replay rejoin from the ring's tail
        alive[0] = True
        check(not bool(rlog.needs_snapshot(st["log"], 0)[0]),
              "the gap must fit the ring: replay rejoin")
        # participant 1's view: a live one
        head, cursor0 = (int(rt.gather(x)[1]) for x in (
            st["log"].ring.head, st["log"].ring.acks.cached[:, 0]))
        gap = (head - cursor0) & 0xFFFFFFFF

        def rejoin():
            st["log"] = rlog.readmit(st["log"], 0)
            st["det"] = det.readmit(st["det"], 0)
            n = 0
            while lag():
                sync()
                n += 1
                check(n <= LOG_CAPACITY, "replay must be bounded by the ring")
            return n
        replayed, rejoin_s = timed(rejoin)
        check(replayed == gap == LOG_CAPACITY,
              f"replayed {replayed} entries for a gap of {gap}")
        check(converged(), "the rejoined participant's replicas differ")
        digest("rejoin")

        steady_t += [steady(w) for w in range(FO_REVIVE, mix_windows)]
        acked += mix_windows - FO_REVIVE
        ledger_fenced = sum(mgr.traffic.fenced_summary().values())
        if rt.lead:
            check(ledger_fenced >= 1, "the ledger's fenced tier must count "
                                      "the zombie")
        metrics = dict(detection_windows=detect,
                       promotion_ms=promote_s * 1e3, catchup_syncs=catchup,
                       retry_ms=retry_s * 1e3, fenced=fenced,
                       ledger_fenced=ledger_fenced,
                       replay_rejoin_entries=replayed,
                       replay_rejoin_ms=rejoin_s * 1e3)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    publishes = rlog.ring.publishes

    # -- the invariants
    lg = st["log"]
    epoch = int(rlog.epoch(lg)[0])
    check(lag() == 0 and converged(),
          "zero acked-window loss: every follower equals the leader")
    check(epoch == int(kill) and int(lg.failovers[0]) == int(kill),
          f"epoch {epoch}, failovers {int(lg.failovers[0])}")
    check(int(lg.dropped[0]) == 0, "an append was dropped")
    check(int(lg.published[0]) == acked,
          f"published {int(lg.published[0])} != acked {acked}")
    check(launches[hop.__name__] == publishes > 0,
          f"{hop.__name__} launched {launches[hop.__name__]} times for "
          f"{publishes} ring publishes")
    for name in ("build_descriptors", "gather_rows", "scatter_rows"):
        check(launches[name] > 0, f"{name} was not launched on the failover "
                                  f"path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rlog.close()
    where = "" if rt.stacked else f"rank {rt.rank}: "
    log(f"  {where}failover: epoch 0 -> {epoch}, winner {winner}, detection "
        f"in {metrics['detection_windows']} windows, promotion "
        f"{metrics['promotion_ms']} ms, catch-up {metrics['catchup_syncs']} "
        f"syncs, retry {metrics['retry_ms']} ms, fenced {metrics['fenced']} "
        f"(ledger {metrics['ledger_fenced']}), replay rejoin of "
        f"{metrics['replay_rejoin_entries']} entries in "
        f"{metrics['replay_rejoin_ms']} ms; {acked} acked windows, every "
        f"follower bitwise equal to the leader; {publishes} ring publishes; "
        f"launches {launches}")
    metrics.update(
        prefill_ops=n_fill, prefill_windows=n_fill_windows,
        prefill_s=t_fill, prefill_ops_per_s=n_fill / t_fill,
        steady_windows=len(steady_t),
        steady_window_p50_ms=float(np.percentile(steady_t, 50)) * 1e3,
        steady_window_p99_ms=float(np.percentile(steady_t, 99)) * 1e3,
        acked_windows=acked, ring_publishes=publishes, epoch=epoch,
        state_gib=state_gib, peak_device_gib=peak)
    return metrics, launches


def phase_failover(torch, pt, rdma, slots):
    """Phase 4b: :func:`failover_run` on the stacked binding at the KVStore
    path's size (P participants, FO_FILL_WINDOWS of the prefill's windows,
    MIX_WINDOWS mixed windows)."""
    check(slots == KEYS // P + 4, "4b: the KVStore path's slots")
    return failover_run(torch, pt, rdma, fill_windows=FO_FILL_WINDOWS)


# ---------------------------------------------------------------------------
# phase 4g: the failover scenario across processes
# ---------------------------------------------------------------------------

# Phase 4b's scenario, one participant a rank: a world of P sharing the card
# over gloo, with the leader's death, and a world of 1 on NCCL without (one
# participant cannot lose its leader).  The store shape is the main path's;
# cut are the fill, to FO_PM_FILL INSERT windows (phase 4f's cut), and the
# mixed windows, to FO_PM_MIX of MIX_WINDOWS.
FO_PM_WORLDS = (("nccl", 1), ("gloo", P))
FO_PM_FILL = 24
FO_PM_MIX = 12
FO_PM_TIMEOUT_S = 600


def fo_rank(rank, nodes):
    """One rank of a phase-4g world: :func:`failover_run` on
    ``ProcessMesh(nodes)``, its digests, metrics and launches."""
    import torch

    import repro_torch.core as pt
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(nodes)
    digests = {}
    metrics, launches = failover_run(
        torch, pt, rdma, nodes=nodes, mesh=mesh, fill_windows=FO_PM_FILL,
        mix_windows=FO_PM_MIX, digests=digests)
    return dict(rank=rank, device=str(mesh.device), backend=mesh.backend,
                transports=dict(mesh.transports), digests=digests,
                metrics=metrics, launches=launches)


def phase_failover_processes(torch, pt, rdma, card):
    """Phase 4g: for each world of FO_PM_WORLDS, :func:`failover_run` on the
    stacked binding of its node count on the card (the reference: oracle,
    invariants and each participant's digests after the fill, every mixed
    window, the promotion and the rejoin), then the world is spawned from
    this process with the kernels built: every rank's digests the stacked
    participant's, the same failover (detection window, winner, fenced
    zombie in the log and in rank 0's ledger, no acked window lost,
    followers equal to the leader, checked in each rank), and on every rank
    ``remote_copy_peers`` launched once for each ring publish.  Returns the
    metrics and each rank's launches by path label."""
    from repro_torch.launch.world import spawn_world
    metrics, launches = {}, {}
    for backend, nodes in FO_PM_WORLDS:
        label = f"world {nodes} on {backend}" + (
            f" ({PM4_GLOO})" if nodes > 1 else "")
        want = {}
        ref_metrics, _ref_launches = failover_run(
            torch, pt, rdma, nodes=nodes, fill_windows=FO_PM_FILL,
            mix_windows=FO_PM_MIX, digests=want)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(fo_rank, nodes, backend=backend, device=None,
                                args=(nodes,), timeout_s=FO_PM_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 4g {label}: {e}") from None
        wall = time.perf_counter() - t0
        for r in ranks:
            p, m = r["rank"], r["metrics"]
            check(sorted(r["digests"]) == sorted(want),
                  f"4g {label} rank {p}: digests taken at "
                  f"{sorted(r['digests'])}, the stacked run's at "
                  f"{sorted(want)}")
            bad = [k for k in want if r["digests"][k] != [want[k][p]]]
            check(not bad, f"4g {label} rank {p}: the blocks differ from "
                           f"the stacked run's rows at {bad}")
            for key in ("detection_windows", "epoch", "acked_windows",
                        "ring_publishes", "fenced"):
                check(m[key] == ref_metrics[key],
                      f"4g {label} rank {p}: {key} {m[key]}, the stacked "
                      f"run's {ref_metrics[key]}")
            check(r["launches"]["remote_copy_peers"] == m["ring_publishes"],
                  f"4g {label} rank {p}: remote_copy_peers launched "
                  f"{r['launches']['remote_copy_peers']} times for "
                  f"{m['ring_publishes']} ring publishes")
            launches[f"4g {backend} world {nodes} rank {p}"] = r["launches"]
        if nodes > 1:
            check(ranks[0]["metrics"]["ledger_fenced"] >= 1,
                  f"4g {label}: rank 0's ledger must count the zombie")
        keys = ("steady_window_p50_ms", "steady_window_p99_ms",
                "detection_windows", "promotion_ms", "replay_rejoin_ms",
                "prefill_s", "state_gib", "peak_device_gib")
        metrics[label] = dict(
            backend=backend, nodes=nodes, card=card, wall_s=wall,
            transports=ranks[0]["transports"],
            devices=sorted({r["device"] for r in ranks}),
            windows=dict(fill=FO_PM_FILL, mix=FO_PM_MIX),
            stacked={k: ref_metrics[k] for k in keys},
            ranks=[{k: r["metrics"][k] for k in keys} for r in ranks],
            launches=[r["launches"] for r in ranks])
        log(f"  4g {label}: {wall:.1f} s with start-up; transports "
            f"{ranks[0]['transports']}; every rank's blocks of the leader, "
            f"the followers, the log and the detector bitwise the stacked "
            f"run's rows after the fill, each mixed window"
            + (", the promotion and the rejoin" if nodes > 1 else "")
            + f"; oracle-checked; {card}")
        log(f"    stacked, {nodes} participants on the card: "
            f"{json.dumps(metrics[label]['stacked'])}")
        for r in ranks:
            log(f"    rank {r['rank']} ({r['device']}): "
                f"{json.dumps({k: r['metrics'][k] for k in keys})}"
                + (f" [{PM4_GLOO}]" if nodes > 1 else "")
                + f"; launches {r['launches']}")
    return metrics, launches


# ---------------------------------------------------------------------------
# phase 4d: the paper's channel objects' scalar verbs
# ---------------------------------------------------------------------------

# benchmarks/bench_lock.py: P = 8, 341 locks over 8 · 341 accounts, 12
# rounds; MPI-style windows couple 8 accounts to one lock
LOCK_P, N_LOCKS, LOCK_ROUNDS = 8, 341, 12
N_ACCOUNTS = LOCK_P * N_LOCKS
MPI_WINDOW = N_ACCOUNTS // N_LOCKS
# benchmarks/bench_barrier.py: crossings at P = 2, 4, 8, 20 each
BARRIER_PS, BARRIER_CROSSINGS = (2, 4, 8), 20


def reset_launches(rdma):
    for k in rdma.KERNELS:
        k.launches = 0


def equal_on_both(label, traces):
    """``traces`` {device: [numpy tree, ...]}: every step bitwise equal on
    the card and on the CPU."""
    card, cpu = traces["cuda"], traces["cpu"]
    check(len(card) == len(cpu), f"{label}: step counts differ")
    for i, (a, b) in enumerate(zip(card, cpu)):
        check(trees_equal(a, b), f"{label} step {i}: differs cuda vs cpu")


def lock_single(torch, pt, dev):
    """bench_lock.py's single contended TicketLock: every participant
    without a ticket takes one, the holder releases (global fence)."""
    mgr = pt.make_manager(LOCK_P, device=dev, backend="pallas")
    lk = pt.TicketLock(None, "single", mgr)
    st = lk.init_state()
    t = torch.full((LOCK_P,), pt.NO_TICKET, dtype=torch.int64,
                   device=mgr.device)
    trace, times = [], []
    for _ in range(LOCK_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, t2 = lk.acquire(st, want=t == pt.NO_TICKET)
        t = torch.where(t == pt.NO_TICKET, t2, t)
        holds = lk.holds(st, t)
        st = lk.release(st, holds)
        t = torch.where(holds, pt.NO_TICKET, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trace.append(np_tree((st, t, holds)))
    return trace, times


def transfers(torch, pt, rdma, dev, window):
    """bench_lock.py's transfer transactions (``_txn_round``): participant
    p moves 1 from account a to account b under the ticket locks of both,
    with two scalar reads and two scalar writes a round on a SharedRegion
    of the accounts.  ``window`` 1 is LOCO's coupling (the lock is the
    account's), 8 MPI-style (the lock is the account // 8's).  A pair whose
    two locks coincide is drawn again: bench_lock.py's round would wait for
    its own second ticket forever.  Every round: the balances against a
    numpy model of the completed transfers (so their sum never changes and
    each completed transfer moved exactly 1), and on the card the launches
    of the two reads and two writes."""
    P, slots = LOCK_P, N_ACCOUNTS // LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    locks = pt.TicketLockArray(None, "locks", mgr, num_locks=N_LOCKS)
    region = pt.SharedRegion(None, "accts", mgr, slots=slots, item_shape=(),
                             dtype=torch.int32)
    rng = np.random.default_rng(SEED + 11 + window)
    model = rng.integers(0, 1000, (P, slots)).astype(np.int32)
    total = int(model.sum())
    st_l = locks.init_state()
    st_r = region.init_state()._replace(
        buf=torch.from_numpy(model.copy()).to(mgr.device))
    nt = pt.NO_TICKET
    ta = torch.full((P,), nt, dtype=torch.int64, device=mgr.device)
    tb = ta.clone()

    def draw(n):
        a = rng.integers(0, N_ACCOUNTS, n)
        b = (a + 1 + rng.integers(0, N_ACCOUNTS - 1, n)) % N_ACCOUNTS
        same = (a // window) % N_LOCKS == (b // window) % N_LOCKS
        while same.any():
            b[same] = (a[same] + 1 + rng.integers(
                0, N_ACCOUNTS - 1, int(same.sum()))) % N_ACCOUNTS
            same = (a // window) % N_LOCKS == (b // window) % N_LOCKS
        return a, b

    aa, ab = draw(P)
    one_round = {"build_descriptors": 4, "gather_rows": 2, "scatter_rows": 2}
    trace, times, done_total = [], [], 0
    for rnd in range(LOCK_ROUNDS):
        acct_a, acct_b = aa // window, ab // window      # bench_lock.py's
        A = torch.from_numpy(acct_a).to(mgr.device)
        Bc = torch.from_numpy(acct_b).to(mgr.device)
        la, lb = A % N_LOCKS, Bc % N_LOCKS
        before = kernel_counts(rdma)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        need = ta == nt
        st_l, t1 = locks.acquire(st_l, la, need)
        st_l, t2 = locks.acquire(st_l, lb, need)
        ta, tb = torch.where(need, t1, ta), torch.where(need, t2, tb)
        holds = locks.holds(st_l, la, ta) & locks.holds(st_l, lb, tb)
        bal_a, _ = region.read(st_r, A % P, A // P)
        bal_b, _ = region.read(st_r, Bc % P, Bc // P)
        st_r, _ = region.write(st_r, A % P, A // P, bal_a - 1, pred=holds)
        st_r, _ = region.write(st_r, Bc % P, Bc // P, bal_b + 1, pred=holds)
        st_l = locks.release(st_l, la, holds)
        st_l = locks.release(st_l, lb, holds & (la != lb))
        ta = torch.where(holds, nt, ta)
        tb = torch.where(holds, nt, tb)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if dev == "cuda":
            got = {k: n - before[k] for k, n in kernel_counts(rdma).items()}
            check(got == one_round, f"transfer round {rnd} (window "
                  f"{window}): launches {got}, not one read verb and one "
                  f"write verb twice {one_round}")
        done = holds.cpu().numpy()
        for p in np.flatnonzero(done):
            model[acct_a[p] % P, acct_a[p] // P] -= 1
            model[acct_b[p] % P, acct_b[p] // P] += 1
        buf = st_r.buf.cpu().numpy()
        check(np.array_equal(buf, model) and int(buf.sum()) == total,
              f"transfer round {rnd} (window {window}): balances off the "
              f"completed transfers (sum {int(buf.sum())}, was {total})")
        done_total += int(done.sum())
        trace.append(np_tree((st_l, st_r, ta, tb, holds)))
        if done.any():
            fa, fb = draw(P)
            aa, ab = np.where(done, fa, aa), np.where(done, fb, ab)
    check(done_total > 0, f"no transfer completed (window {window})")
    return trace, times, done_total


def barrier_crossings(torch, pt, dev, P):
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    bar = pt.Barrier(None, f"bar{P}", mgr)
    st = bar.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BARRIER_CROSSINGS):
        st = bar.wait(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [np_tree(st)], dt / BARRIER_CROSSINGS


def registers(torch, pt, dev):
    """OwnedVar push and pull and AtomicVar fetch_add and compare_swap at
    P = 8 from seeded words: a 4-word owned var (checksummed) and a uint32
    atomic near its wrap."""
    P = LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    ov = pt.OwnedVar(None, "ov", mgr, owner=3, shape=(4,), dtype=torch.int32)
    av = pt.AtomicVar(None, "av", mgr, host=5, dtype=torch.uint32)
    rng = np.random.default_rng(SEED + 12)
    me = mgr.runtime.my_id()
    ost, ast = ov.init_state(), av.init_state(2 ** 32 - 20)
    trace = []
    for _ in range(4):
        v = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (P, 4)).astype(
            np.int32)).to(mgr.device)
        ost = ov.store_mine(ost, v, pred=me == 3)
        ost, _ = ov.push(ost)
        trace.append(np_tree((ost,) + ov.load(ost)))
        ost = ov.store_mine(ost, v + 1, pred=me == 3)
        ost, _ = ov.pull(ost)
        trace.append(np_tree((ost,) + ov.load(ost)))
        amt = torch.from_numpy(rng.integers(0, 9, P)).to(mgr.device)
        pred = torch.from_numpy(rng.random(P) < .7).to(mgr.device)
        ast, old, _ = av.fetch_add(ast, amt, pred=pred)
        exp = torch.where(pred, ast.official, old)
        ast, old2, ok, _ = av.compare_swap(ast, exp, old + 7, pred=~pred)
        check(int(ok.sum()) <= 1, "compare_swap: more than one winner")
        trace.append(np_tree((ast, old, old2, ok)))
    return trace


def queue_paths(torch, pt, dev, scalar):
    """SharedQueue at P = 8 through 16 rounds of pushes and pops: its scalar
    reference paths (``scalar``) or its B=1 windows."""
    P = LOCK_P
    mgr = pt.make_manager(P, device=dev, backend="pallas")
    q = pt.SharedQueue(None, "q", mgr, slots_per_node=2, width=2)
    enq = q._enqueue_reference if scalar else q.enqueue
    deq = q._dequeue_reference if scalar else q.dequeue
    rng = np.random.default_rng(SEED + 13)
    st, trace = q.init_state(), []
    for rnd in range(16):
        ew = torch.from_numpy(rng.random(P) < (.9 if rnd < 4 else .5))
        dw = torch.from_numpy(rng.random(P) < (.1 if rnd < 4 else .7))
        ev = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (P, 2)).astype(
            np.int32))
        st, g = enq(st, ev.to(mgr.device), ew.to(mgr.device))
        st, v, ok = deq(st, dw.to(mgr.device))
        trace.append(np_tree((st, g, v, ok)))
    return trace


def phase_channels(torch, pt, rdma):
    """The channel objects' scalar verbs on the remote-DMA backend, each
    run once on the card and once on the CPU with bitwise-equal states and
    results: bench_lock.py's single contended TicketLock and its transfer
    transactions in both couplings (exact launches a round, balances
    conserved), bench_barrier.py's crossings, OwnedVar and AtomicVar, the
    queue's scalar paths against its B=1 windows, and the KV-store example
    on the remote-DMA backend with its online oracle.  Returns the metrics and the remote-DMA
    kernels' launches, counted from 0 over this phase."""
    import contextlib
    import io
    from repro_torch.examples import kvstore_app
    reset_launches(rdma)
    out = {}
    traces = {}
    for dev in ("cuda", "cpu"):
        traces[dev], t = lock_single(torch, pt, dev)
        if dev == "cuda":
            out["lock_single_round_ms_p50"] = float(np.median(t)) * 1e3
    equal_on_both("single TicketLock", traces)
    served = sum(int(tr[2].sum()) for tr in traces["cuda"])
    check(all(int(tr[2].sum()) == 1 for tr in traces["cuda"]),
          "single TicketLock: a round without exactly one holder")
    log(f"  single TicketLock, P={LOCK_P}, {LOCK_ROUNDS} rounds: one holder "
        f"a round ({served} served), bitwise equal on cuda and cpu; round "
        f"p50 {out['lock_single_round_ms_p50']:.3f} ms")

    for name, window in (("loco", 1), ("mpi", MPI_WINDOW)):
        traces = {}
        for dev in ("cuda", "cpu"):
            traces[dev], t, done = transfers(torch, pt, rdma, dev, window)
            if dev == "cuda":
                out[f"txn_{name}"] = dict(
                    done=done, txn_per_round=done / LOCK_ROUNDS,
                    round_ms_p50=float(np.median(t)) * 1e3)
        equal_on_both(f"{name} transfers", traces)
        r = out[f"txn_{name}"]
        log(f"  {name} transfers (lock = account // {window}): {r['done']} "
            f"done in {LOCK_ROUNDS} rounds, balances conserved, each moved "
            f"1, launches a round 4/2/2, bitwise equal on cuda and cpu; "
            f"round p50 {r['round_ms_p50']:.3f} ms")

    for P in BARRIER_PS:
        traces = {}
        for dev in ("cuda", "cpu"):
            traces[dev], per = barrier_crossings(torch, pt, dev, P)
            if dev == "cuda":
                out[f"barrier_p{P}_ms"] = per * 1e3
        equal_on_both(f"barrier P={P}", traces)
        count = traces["cuda"][0].count
        check(np.array_equal(count, np.full(P, BARRIER_CROSSINGS)),
              f"barrier P={P}: count {count}")
    log(f"  barrier crossings ({BARRIER_CROSSINGS} each) bitwise equal on "
        f"cuda and cpu, count = crossings; ms a crossing: " + ", ".join(
            f"P={P} {out[f'barrier_p{P}_ms']:.3f}" for P in BARRIER_PS))

    equal_on_both("OwnedVar and AtomicVar",
                  {dev: registers(torch, pt, dev) for dev in ("cuda", "cpu")})
    traces = {dev: queue_paths(torch, pt, dev, True) for dev in ("cuda", "cpu")}
    equal_on_both("queue scalar paths", traces)
    equal_on_both("queue scalar paths vs B=1 windows",
                  {"cuda": traces["cuda"],
                   "cpu": queue_paths(torch, pt, "cuda", False)})
    log(f"  OwnedVar push/pull and AtomicVar fetch_add/compare_swap at "
        f"P={LOCK_P}, and the queue's scalar paths (= its B=1 windows), "
        f"bitwise equal on cuda and cpu")

    buf = io.StringIO()
    before = kernel_counts(rdma)
    with contextlib.redirect_stdout(buf):
        kvstore_app.main(device="cuda", backend="pallas")
    text = buf.getvalue()
    got = {k: n - before[k] for k, n in kernel_counts(rdma).items()}
    check("linearizability holds." in text, f"kvstore_app: {text}")
    check(all(n > 0 for n in got.values()),
          f"kvstore_app on pallas left a map kernel unlaunched: {got}")
    log("  repro_torch.examples.kvstore_app on the card (pallas): "
        + " / ".join(text.strip().splitlines()) + f"; launches {got}")
    torch.cuda.synchronize()
    return out, kernel_counts(rdma)


# ---------------------------------------------------------------------------
# phase 4e: the map's executable specification store
# ---------------------------------------------------------------------------

# benchmarks/bench_kvstore.py's reference variant: P = 8, keyspace 1024,
# index_capacity 4 · keyspace, keyspace // P + 4 slots, max(64, P · window)
# locks, windows of 32.  The flat scan is O(C) a lane, which is why the
# reference's benchmark holds the spec store at this size.
SPEC_KEYS, SPEC_B = 1024, 32
SPEC_CFG = dict(slots_per_node=SPEC_KEYS // P + 4, value_width=W,
                num_locks=max(64, P * SPEC_B), index_capacity=4 * SPEC_KEYS)
SPEC_MIX, SPEC_ZIPF = 10, 10


def spec_windows(rng):
    """(kind, ops, keys, values) windows: the 80% prefill in windows of
    P · 32 inserts, then 10 mixed (60/20/10/10 GET/UPDATE/INSERT/DELETE,
    distinct uniform keys) and 10 zipf(0.99) 95/5 GET/UPDATE."""
    span = P * SPEC_B
    out = []
    fill = np.arange(1, int(SPEC_KEYS * FILL) + 1, dtype=np.uint32)
    for i in range(0, fill.size, span):
        chunk = fill[i:i + span]
        ops = np.full(span, NOP, np.int32)
        ks = np.ones(span, np.uint32)
        ops[:chunk.size], ks[:chunk.size] = INSERT, chunk
        vals = np.stack([ks.astype(np.int32) * 3, np.zeros(span, np.int32)],
                        1)
        out.append(("prefill", ops, ks, vals))
    for w in range(SPEC_MIX):
        ks = rng.choice(SPEC_KEYS, span, replace=False).astype(np.uint32) + 1
        ops = rng.choice([GET, UPDATE, INSERT, DELETE], span,
                         p=[.6, .2, .1, .1]).astype(np.int32)
        out.append(("mixed", ops, ks, np.stack(
            [ks.astype(np.int32) * 5 + w, np.full(span, w, np.int32)], 1)))
    ranks = np.arange(1, SPEC_KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / ranks ** ZIPF_THETA)
    cdf /= cdf[-1]
    scramble = rng.permutation(SPEC_KEYS) + 1
    for w in range(SPEC_ZIPF):
        ks = scramble[np.minimum(np.searchsorted(cdf, rng.random(span)),
                                 SPEC_KEYS - 1)].astype(np.uint32)
        ops = np.where(rng.random(span) < .95, GET, UPDATE).astype(np.int32)
        out.append(("zipf", ops, ks, np.stack(
            [ks.astype(np.int32) * 7 + w, np.full(span, -w, np.int32)], 1)))
    return [(kind, o.reshape(P, SPEC_B), k.reshape(P, SPEC_B),
             v.reshape(P, SPEC_B, W)) for kind, o, k, v in out]


def phase_spec_store(torch, pt, rdma):
    """bench_kvstore.py's reference variant on the remote-DMA backend: a
    hash store and a reference-impl store (flat-scan index, sequential
    tracker sweep, one ticket served per lock a round) in step on the card
    through the prefill, the mixed and the zipf windows — results equal
    lane for lane, logical contents equal by the flat-scan lookup of every
    key — and the reference-impl store again on the CPU, bitwise equal to
    the card's after every window; then ``_op_round_reference`` against
    ``op_round`` and ``_migrate_reference`` against ``migrate_window``.
    Returns the metrics and the remote-DMA kernels' launches, counted from
    0 over this phase."""
    rng = np.random.default_rng(SEED + 14)
    windows = spec_windows(rng)
    stores = {}
    for label, dev, ref in (("hash", "cuda", False), ("spec", "cuda", True),
                            ("spec cpu", "cpu", True)):
        mgr = pt.make_manager(P, device=dev, backend="pallas")
        kv = pt.KVStore(None, "kv", mgr, reference_impl=ref, **SPEC_CFG)
        stores[label] = [kv, kv.init_state()]
    reset_launches(rdma)
    prefill_s = {"hash": 0.0, "spec": 0.0}
    for i, (kind, ops, ks, vals) in enumerate(windows):
        res = {}
        for label, s in stores.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s[1], r = s[0].op_window(s[1], ops, ks, vals)
            torch.cuda.synchronize()
            if kind == "prefill" and label in prefill_s:
                prefill_s[label] += time.perf_counter() - t0
            res[label] = np_tree(r)
        check(trees_equal(res["hash"], res["spec"]),
              f"spec store {kind} window {i}: results differ from the hash "
              f"store's")
        check(trees_equal(res["spec"], res["spec cpu"]),
              f"spec store {kind} window {i}: results differ cuda vs cpu")
        check(trees_equal(pt.state_to_numpy(stores["spec"][1]),
                          pt.state_to_numpy(stores["spec cpu"][1])),
              f"spec store {kind} window {i}: state differs cuda vs cpu")
        if kind == "prefill":
            check(bool(res["hash"].found[ops == INSERT].all()),
                  "a prefill insert failed")
    # the logical contents: every key on the same home in both indexes,
    # with the same value (slot choices differ by design)
    every = torch.arange(1, SPEC_KEYS + 1, device=stores["spec"][0].device) \
        .expand(P, SPEC_KEYS)
    looks = {label: [x.cpu().numpy() for x in stores[label][0]
                     ._index_lookup_reference(stores[label][1], every)]
             for label in ("hash", "spec")}
    fh, fs = looks["hash"][0], looks["spec"][0]
    check(np.array_equal(fh, fs) and np.array_equal(
        looks["hash"][2][fh], looks["spec"][2][fs]),
        "the flat-scan lookup of every key differs hash vs spec store")
    gets = {label: np_tree(stores[label][0].get_batch(stores[label][1],
                                                      every)[1:])
            for label in ("hash", "spec")}
    check(trees_equal(gets["hash"], gets["spec"]),
          "get_batch of every key differs hash vs spec store")
    live = int(fh[0].sum())
    ratio = prefill_s["spec"] / prefill_s["hash"]
    log(f"  {len(windows)} windows (prefill, {SPEC_MIX} mixed, {SPEC_ZIPF} "
        f"zipf) of {SPEC_B}/participant: results lane for lane the hash "
        f"store's, {live} live keys the same in both indexes, the spec "
        f"store bitwise equal on cuda and cpu after every window")
    log(f"  prefill of {int(SPEC_KEYS * FILL)} keys: hash "
        f"{prefill_s['hash'] * 1e3:.1f} ms, spec "
        f"{prefill_s['spec'] * 1e3:.1f} ms, spec/hash {ratio:.2f} "
        f"({card_line()})")

    # _op_round_reference against op_round from the hash store's state
    kv, st = stores["hash"]
    st_a = st_b = st
    for rnd in range(6):
        op = rng.choice([NOP, GET, INSERT, UPDATE, DELETE], P,
                        p=[.1, .3, .3, .15, .15]).astype(np.int32)
        key = rng.integers(1, SPEC_KEYS + 1, P).astype(np.uint32)
        val = rng.integers(-2 ** 31, 2 ** 31, (P, W)).astype(np.int32)
        st_a, ra = kv.op_round(st_a, op, key, val)
        st_b, rb = kv._op_round_reference(st_b, op, key, val)
        check(not differing_leaves(torch, st_a, st_b)
              and trees_equal(np_tree(ra), np_tree(rb)),
              f"op_round differs from _op_round_reference in round {rnd}: "
              f"{differing_leaves(torch, st_a, st_b)}")

    # _migrate_reference against migrate_window on a placed store
    mgr = pt.make_manager(P, device="cuda", backend="pallas")
    pkv = pt.KVStore(None, "kv_placed", mgr, placement="hashed", **SPEC_CFG)
    keys = np.arange(1, P * SPEC_B + 1, dtype=np.uint32).reshape(P, SPEC_B)
    pst, r = pkv.op_window(pkv.init_state(),
                           np.full((P, SPEC_B), INSERT, np.int32), keys,
                           np.stack([keys * 3, keys * 5], -1).astype(
                               np.int32))
    mk = keys[:, :4]
    dests = rng.integers(0, P, mk.shape).astype(np.int32)
    st_w, moved_w = pkv.migrate_window(pst, mk, dests)
    st_r, moved_r = pkv._migrate_reference(pst, mk, dests)
    got_w = np_tree(pkv.get_batch(st_w, keys)[1:])
    got_r = np_tree(pkv.get_batch(st_r, keys)[1:])
    check(torch.equal(moved_w, moved_r) and trees_equal(got_w, got_r),
          "migrate_window and _migrate_reference disagree")
    log(f"  op_round = _op_round_reference bitwise over 6 rounds; "
        f"migrate_window = _migrate_reference on a placed store "
        f"({int(moved_w.sum())} of {mk.size} moved)")
    torch.cuda.synchronize()
    return dict(prefill_s=prefill_s, prefill_spec_over_hash=ratio,
                windows=len(windows), live_keys=live), kernel_counts(rdma)


# ---------------------------------------------------------------------------
# phase 4f: the map across processes
# ---------------------------------------------------------------------------

# The map's process binding, one participant a rank: a world of 1 on NCCL
# and a world of P ranks sharing the card over gloo (NCCL refuses two ranks
# on one device).  The store keeps the main path's shape (pallas, K = 2**22,
# index 4·K, 4,096 locks, W = 2, B = 512 lanes a participant); what is cut
# is the prefill, to PM4_FILL_WINDOWS INSERT windows of the main path's
# ~820, and the mixed and zipf windows, to PM4_MIX and PM4_ZIPF of its 20.
PM4_WORLDS = (("nccl", 1), ("gloo", P))
PM4_FILL_WINDOWS = 24
PM4_MIX = 6
PM4_ZIPF = 6
PM4_TIMEOUT_S = 600
PM4_GLOO = "gloo on one card, not a number between cards"


def pm4_config(nodes):
    return dict(slots_per_node=KEYS // nodes + 4, value_width=W,
                num_locks=4096, index_capacity=4 * KEYS)


def pm4_windows(nodes):
    """Phase 4f's windows for ``nodes`` participants, from the seed:
    ("op", ops, keys, values) INSERT prefill windows of distinct keys, the
    main path's mixed windows (60/20/10/10 GET/UPDATE/INSERT/DELETE over
    distinct keys, half of them filled), ("get", keys) zipf windows over the
    filled keys for ``get_batch``, and one ("move", keys, dests) window of
    distinct filled keys."""
    rng = np.random.default_rng(SEED + 36)
    span = nodes * B
    n_fill = PM4_FILL_WINDOWS * span
    shape = (nodes, B)
    wins = []
    for i in range(PM4_FILL_WINDOWS):
        ks = np.arange(i * span + 1, (i + 1) * span + 1, dtype=np.uint32)
        vals = np.stack([ks.astype(np.int32) * 3, np.zeros(span, np.int32)],
                        1)
        wins.append(("op", np.full(shape, INSERT, np.int32),
                     ks.reshape(shape), vals.reshape(shape + (W,))))
    for w in range(PM4_MIX):
        ks = rng.choice(2 * n_fill, size=span, replace=False) \
            .astype(np.uint32) + 1
        ops = rng.choice([GET, UPDATE, INSERT, DELETE], size=span,
                         p=[.6, .2, .1, .1]).astype(np.int32)
        vals = np.stack([ks.astype(np.int32) * 5 + w,
                         np.full(span, w, np.int32)], 1)
        wins.append(("op", ops.reshape(shape), ks.reshape(shape),
                     vals.reshape(shape + (W,))))
    cdf = np.cumsum(1.0 / np.arange(1, n_fill + 1, dtype=np.float64)
                    ** ZIPF_THETA)
    cdf /= cdf[-1]
    scramble = rng.permutation(n_fill) + 1
    for _ in range(PM4_ZIPF):
        ks = scramble[np.minimum(np.searchsorted(cdf, rng.random(span)),
                                 n_fill - 1)].astype(np.uint32)
        wins.append(("get", ks.reshape(shape)))
    ks = rng.choice(n_fill, size=span, replace=False).astype(np.uint32) + 1
    wins.append(("move", ks.reshape(shape),
                 rng.integers(0, nodes, shape).astype(np.int32)))
    return wins


def pm4_digests(torch, tree, p=None):
    """Per-leaf digests of a (nested) tuple of tensors, each leaf's row
    ``p`` (participant p's block) when ``p`` is given."""
    if isinstance(tree, tuple):
        return [d for leaf in tree for d in pm4_digests(torch, leaf, p)]
    return [pt_digest(torch, tree if p is None else tree[p:p + 1])]


def pm4_run(torch, kv, st, wins, cut, on_window):
    """Run ``wins`` on ``kv`` from ``st``, ``cut(a)`` giving the held
    participants' block of a (nodes, ...) array on the device; after window
    i ``on_window(i, state)``.  Returns (state, the windows' results on the
    host, seconds a window)."""
    results, times = [], []
    for i, (kind, *args) in enumerate(wins):
        args = [cut(a) for a in args]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "get":
            st, values, found = kv.get_batch(st, args[0])
            res = (values, found)
        elif kind == "move":
            st, moved = kv.migrate_window(st, args[0], args[1])
            res = (moved,)
        else:
            st, r = kv.op_window(st, *args)
            res = tuple(r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        results.append(tuple(t.cpu() for t in res))
        on_window(i, st)
    return st, results, times


def pm4_kinds(wins, times):
    """Window p50 (ms) by kind: fill, mix, get, move."""
    kinds = (["fill"] * PM4_FILL_WINDOWS + ["mix"] * PM4_MIX
             + ["get"] * PM4_ZIPF + ["move"])
    check(len(kinds) == len(wins) == len(times), "4f: window count")
    return {k: 1e3 * float(np.percentile(
        [t for kk, t in zip(kinds, times) if kk == k], 50))
        for k in ("fill", "mix", "get", "move")}


def pm4_rank(rank, nodes):
    """One rank of a phase-4f world (spawned; ``init_distributed`` has
    joined it): ``make_manager(nodes, mesh=ProcessMesh(nodes))``, the
    store of ``pm4_config`` on its own block on the card, the windows of
    ``pm4_windows`` cut to its participant's rows, with its remote-DMA
    launches counted from 0 over them; digests of its state block after the
    prefill and after every later window; then, in a world of more than
    one, the reference's shard_map programs on its block."""
    import torch

    import repro_torch.core as pt
    from repro_torch.examples.process_map import shardmap_programs
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(nodes)
    mgr = pt.make_manager(nodes, mesh=mesh, backend="pallas")
    kv = pt.KVStore(None, "kv", mgr, **pm4_config(nodes))
    st = kv.init_state()
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2 ** 30
    wins = pm4_windows(nodes)
    digests = {}

    def on_window(i, s):
        if i >= PM4_FILL_WINDOWS - 1:
            digests[i] = pm4_digests(torch, s)

    reset_launches(rdma)
    st, results, times = pm4_run(
        torch, kv, st, wins,
        lambda a: torch.from_numpy(a[rank:rank + 1].copy()).to(mesh.device),
        on_window)
    out = dict(rank=rank, device=str(mesh.device), backend=mesh.backend,
               transports=dict(mesh.transports), state_gib=state_gib,
               digests=digests, results=results,
               window_p50_ms=pm4_kinds(wins, times),
               launches=kernel_counts(rdma))
    del st, kv
    if nodes > 1:
        reset_launches(rdma)
        prog = shardmap_programs(lambda: pt.make_manager(
            nodes, mesh=mesh, backend="pallas"), nodes)
        out["programs"] = {k: pm4_digests(torch, v) for k, v in prog.items()}
        out["program_launches"] = kernel_counts(rdma)
    return out


def pm4_oracle_check(oracle, wins, results, label):
    """The stacked run's results against the numpy oracle."""
    for i, ((kind, *args), res) in enumerate(zip(wins, results)):
        what = f"4f {label} window {i} ({kind})"
        if kind == "op":
            exp_val, exp_found = oracle.window(*args)
            check(np.array_equal(res[1].numpy(), exp_found),
                  f"{what}: found differs from the oracle")
            check(np.array_equal(res[0].numpy(), exp_val),
                  f"{what}: GET values differ from the oracle")
        elif kind == "get":
            ks = args[0].astype(np.int64)
            check(np.array_equal(res[1].numpy(), oracle.present[ks]),
                  f"{what}: found differs from the oracle")
            check(np.array_equal(res[0].numpy(), np.where(
                oracle.present[ks][..., None], oracle.value[ks], 0)),
                f"{what}: values differ from the oracle")
        else:
            check(np.array_equal(res[0].numpy(), oracle.move(*args)),
                  f"{what}: moved differs from the oracle")


def phase_map_processes(torch, pt, rdma, card):
    """Phase 4f: for each world of PM4_WORLDS, the stacked store of its
    node count on the card runs ``pm4_windows`` (results held against the
    numpy oracle, each participant's block digested after the prefill and
    after every later window), then the world is spawned from this process
    with the kernels already built: every rank's results its rows of the
    stacked ones, its digests the stacked participant's, its remote-DMA
    kernels launched on its own block as often as the stacked store
    launches them over all participants; the world of P also runs the
    reference's shard_map programs, each rank's states and results the
    stacked run's rows by digests.  Returns the metrics and each rank's
    launches by path label."""
    from repro_torch.examples.process_map import shardmap_programs
    from repro_torch.launch.world import spawn_world
    metrics, launches = {}, {}
    for backend, nodes in PM4_WORLDS:
        label = f"world {nodes} on {backend}" + (
            f" ({PM4_GLOO})" if nodes > 1 else "")
        wins = pm4_windows(nodes)
        mgr = pt.make_manager(nodes, backend="pallas")
        kv = pt.KVStore(None, "kv", mgr, **pm4_config(nodes))
        st = kv.init_state()
        want = {}

        def on_window(i, s):
            if i >= PM4_FILL_WINDOWS - 1:
                want[i] = [pm4_digests(torch, s, p) for p in range(nodes)]

        reset_launches(rdma)
        st, ref, ref_t = pm4_run(
            torch, kv, st, wins,
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda(),
            on_window)
        stacked_launches = kernel_counts(rdma)
        pm4_oracle_check(Oracle(KEYS, KEYS // nodes + 4, nodes), wins, ref,
                         label)
        del st, kv, mgr
        prog_want = None
        if nodes > 1:
            prog = shardmap_programs(
                lambda: pt.make_manager(nodes, backend="pallas"), nodes)
            prog_want = {k: [pm4_digests(torch, v, p) for p in range(nodes)]
                         for k, v in prog.items()}
            del prog
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(pm4_rank, nodes, backend=backend,
                                device=None, args=(nodes,),
                                timeout_s=PM4_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 4f {label}: {e}") from None
        wall = time.perf_counter() - t0
        for r in ranks:
            p = r["rank"]
            for i, (got, exp) in enumerate(zip(r["results"], ref)):
                check(len(got) == len(exp) and all(
                    torch.equal(g, e[p:p + 1]) for g, e in zip(got, exp)),
                    f"4f {label} rank {p} window {i}: results differ from "
                    f"the stacked store's rows")
            check(sorted(r["digests"]) == sorted(want),
                  f"4f {label} rank {p}: digests taken after windows "
                  f"{sorted(r['digests'])}")
            bad = [i for i in want if r["digests"][i] != want[i][p]]
            check(not bad, f"4f {label} rank {p}: the state block differs "
                  f"from the stacked store's row after windows {bad}")
            check(all(n > 0 for n in r["launches"].values()),
                  f"4f {label} rank {p}: a map kernel was not launched on "
                  f"the rank's block: {r['launches']}")
            check(r["launches"] == stacked_launches,
                  f"4f {label} rank {p}: launches {r['launches']}, the "
                  f"stacked store's (one a verb over every participant) "
                  f"{stacked_launches}")
            launches[f"4f {backend} world {nodes} rank {p}"] = r["launches"]
            if prog_want is not None:
                bad = [k for k in prog_want
                       if r["programs"][k] != prog_want[k][p]]
                check(not bad, f"4f {label} rank {p}: the shard_map "
                      f"programs' {bad} differ from the stacked run's rows")
                check(all(n > 0 for n in r["program_launches"].values()),
                      f"4f {label} rank {p}: the programs left a map "
                      f"kernel unlaunched: {r['program_launches']}")
                launches[f"4f {backend} world {nodes} rank {p} programs"] = \
                    r["program_launches"]
        metrics[label] = dict(
            backend=backend, nodes=nodes, card=card, wall_s=wall,
            transports=ranks[0]["transports"],
            devices=sorted({r["device"] for r in ranks}),
            state_gib_per_rank=[r["state_gib"] for r in ranks],
            stacked_window_p50_ms=pm4_kinds(wins, ref_t),
            rank_window_p50_ms=[r["window_p50_ms"] for r in ranks],
            launches=[r["launches"] for r in ranks],
            stacked_launches=stacked_launches,
            windows=dict(fill=PM4_FILL_WINDOWS, mix=PM4_MIX, get=PM4_ZIPF,
                         move=1),
            programs=prog_want is not None)
        log(f"  {label}: {wall:.1f} s with start-up; transports "
            f"{ranks[0]['transports']}; {len(wins)} windows of {B} lanes a "
            f"participant, every rank's results and state block (digests "
            f"after the prefill and after each later window) bitwise the "
            f"stacked store's rows, oracle-checked"
            + ("; the shard_map programs bitwise the stacked run's"
               if prog_want is not None else "") + f"; {card}")
        log(f"    stacked store, {nodes} participants on the card: window "
            f"p50 ms {metrics[label]['stacked_window_p50_ms']}; launches "
            f"{stacked_launches}, each rank's the same")
        for r in ranks:
            log(f"    rank {r['rank']} ({r['device']}, "
                f"{r['state_gib']:.3f} GiB): window p50 ms "
                f"{r['window_p50_ms']}"
                + (f" [{PM4_GLOO}]" if nodes > 1 else "")
                + f"; launches {r['launches']}")
    return metrics, launches


# ---------------------------------------------------------------------------
# phase 5: the serving path at full width
# ---------------------------------------------------------------------------

class ServeProbe:
    """Wraps a ServingEngine's prefill, decode step and page lookups: host
    clock around each call (synchronised), finite-logit checks, the
    lookups' ``found`` lanes, and ``torch.profiler`` over one decode round
    (its page lookups and its decode step)."""

    def __init__(self, torch, eng, profile_round):
        self.torch = torch
        self.prefill_s, self.decode_s, self.reads_s = [], [], []
        self.finite, self.found = [], []
        self.rounds = 0
        self.profile_round = profile_round
        self.prof = None
        self.busy = None
        p, d, r = eng._prefill, eng._decode, eng._kv_reads
        eng._prefill = lambda *a: self._timed(p, self.prefill_s, a)
        eng._decode = lambda *a: self._decode(d, a)
        eng._kv_reads = lambda keys: self._reads(r, keys)

    def _timed(self, fn, sink, args):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        self.finite.append(bool(torch.isfinite(out[0]).all()))
        return out

    def _reads(self, fn, keys):
        self.rounds += 1
        if self.rounds == self.profile_round:
            from torch.profiler import ProfilerActivity, profile
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(keys)
        self.reads_s.append(time.perf_counter() - t0)
        self.found += [bool(f) for f, _v in res]
        return res

    def _decode(self, fn, args):
        out = self._timed(fn, self.decode_s, args)
        if self.prof is not None and self.busy is None:
            self.torch.cuda.synchronize()
            wall_us = (time.perf_counter() - self.t0) * 1e6
            self.prof.__exit__(None, None, None)
            cuda = self.torch.autograd.DeviceType.CUDA
            device_us, dev_by, host_by = 0.0, {}, {}
            for e in self.prof.events():
                if e.device_type == cuda:
                    us = e.time_range.elapsed_us()
                    device_us += us
                    dev_by[e.name[:50]] = dev_by.get(e.name[:50], 0.0) + us
            for e in self.prof.key_averages():
                if e.self_cpu_time_total > 0:
                    host_by[e.key[:50]] = (e.count,
                                           e.self_cpu_time_total / 1e3)
            self.busy = dict(
                wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
                device_busy_share=device_us / wall_us,
                top_device_ms={k: v / 1e3 for k, v in sorted(
                    dev_by.items(), key=lambda kv: -kv[1])[:6]},
                top_host_ops_count_ms=dict(sorted(
                    host_by.items(), key=lambda kv: -kv[1][1])[:8]))
        return out


def expected_launches(cfg, requests, gen):
    """Each model kernel's launches on one ``generate`` of ``requests``
    prompts in batches of SERVE_BATCH: one prefill per batch (flash per
    attention layer, a vlm's cross layers among them, rglru per recurrent
    layer, wkv6 per rwkv layer; whisper: flash per encoder layer and twice
    per decoder layer, self and cross), then gen - 1 decode steps (decode
    attention per attention layer; whisper twice per decoder layer), and
    three grouped matmuls (gate, up, wo) per MoE layer in each of both."""
    from repro_torch.models.transformer import layer_kinds
    prefills = -(-requests // SERVE_BATCH)
    steps = prefills * (gen - 1)
    if cfg.family == "ssm":
        return {"wkv6": cfg.n_layers * prefills}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.n_enc_layers + 2 * cfg.n_layers)
                * prefills, "decode_attention": 2 * cfg.n_layers * steps}
    kinds = layer_kinds(cfg)
    n_rec = kinds.count("rec")
    n_moe = sum(kind.endswith("_moe") for kind in kinds)
    n_attn = len(kinds) - n_rec
    out = {"flash_attention": n_attn * prefills,
           "decode_attention": n_attn * steps}
    if n_rec:
        out["rglru_scan"] = n_rec * prefills
    if n_moe:
        out["gmm"] = 3 * n_moe * (prefills + steps)
    return out


def path_label(path):
    return path["arch"] + (" replicated" if path.get("replicas") else "")


def replication_probe(torch, eng):
    """Host clock (synchronised) around the replicated engine's promotions
    and rejoins."""
    times = {"promote": [], "rejoin": []}

    def wrap(obj, name, sink):
        fn = getattr(obj, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        setattr(obj, name, timed)

    wrap(eng.page_log, "promote", times["promote"])
    wrap(eng, "_handle_revive", times["rejoin"])
    return times


def phase_serving(torch, kernels, path, rdma):
    """One serving path: ``path["arch"]`` at full published width and depth
    (or ``path["n_layers"]`` layers, where given), bf16, random weights
    drawn on the card, ``path["requests"]`` (default SERVE_REQUESTS) prompts
    of ``path["prompt"]`` tokens, ``path["gen"]`` (SERVE_GEN) tokens each.
    With ``path["replicas"]`` the page table is replicated behind the log on
    ``path["backend"]``, and ``path["plan"]`` kills and revives the log
    leader.  Returns its metrics and every model kernel's launches (and, on
    a replicated path, the remote-DMA and remote-copy kernels'), counted
    from 0 over this path."""
    from repro_torch.configs import get_config
    from repro_torch.core.kvstore import DELETE, GET, INSERT
    from repro_torch.distributed import FaultPlan
    from repro_torch.serving import ServingEngine
    arch, prompt = path["arch"], path["prompt"]
    requests = path.get("requests", SERVE_REQUESTS)
    gen = path.get("gen", SERVE_GEN)
    replicas = path.get("replicas", 0)
    label = path_label(path)
    cfg = get_config(arch)
    if "n_layers" in path:
        cfg = cfg.replace(n_layers=path["n_layers"])
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, max_batch=SERVE_BATCH, max_seq=prompt + gen,
                        replicas=replicas,
                        fault_plan=(FaultPlan(**path["plan"])
                                    if "plan" in path else None),
                        detect_threshold=DETECT_THRESHOLD,
                        backend=path.get("backend"))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    m = cfg.mla
    heads = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}"
             if m is None else
             f"MLA {cfg.n_heads} heads (q, k {m.qk_nope_head_dim} + "
             f"{m.qk_rope_head_dim}, v {m.v_head_dim}, latent "
             f"{m.kv_lora_rank} + {m.qk_rope_head_dim})")
    if cfg.cross is not None:
        heads += (f", {cfg.n_enc_layers} encoder layers over"
                  if cfg.n_enc_layers else ", cross layers over") + \
            f" a zero context of {cfg.cross.n_context_tokens} positions"
    log(f"  {arch}: {cfg.n_layers} layers, d={cfg.d_model}, {heads}, "
        f"{cfg.dtype}, {n_params:,} parameters "
        f"({n_params * cfg.dtype_.itemsize / 2 ** 30:.1f} GiB) drawn on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, size=(prompt,)).astype(np.int32)
               for _ in range(requests)]
    probe = ServeProbe(torch, eng, profile_round=10)
    rep_times = replication_probe(torch, eng) if replicas else None
    torch.cuda.reset_peak_memory_stats()
    dma = rdma.KERNELS + (rdma.remote_copy,) if replicas else ()
    for k in list(kernels.values()) + list(dma):
        k.launches = 0
    routes = {name: dict(getattr(kernels[name], "routes", {}))
              for name in ("rglru_scan", "wkv6")}
    t0 = time.perf_counter()
    outs = eng.generate(prompts, gen_len=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    for name, want in (("rglru_scan", "vector"), ("wkv6", "chunked")):
        if routes[name]:
            n = kernels[name].routes[want] - routes[name][want]
            check(n == launches[name], f"{label}: {n} of {launches[name]} "
                  f"{name} launches took the {want} route")
    dma_launches = {k.__name__: k.launches for k in dma}
    expected = expected_launches(cfg, requests, gen)
    stats = eng.stats()
    for name, n in launches.items():
        check(n == expected.get(name, 0) and (n > 0) == (name in expected),
              f"{label}: {name} launched {n} times, expected "
              f"{expected.get(name, 0)}")
    check(len(outs) == requests and all(len(o) == gen for o in outs),
          "wrong output shape")
    check(all(0 <= t < cfg.vocab for o in outs for t in o),
          "a token lies outside the vocabulary")
    check(all(probe.finite), "a logit is not finite")
    check(stats["kv_ops"][INSERT] == stats["kv_ops"][DELETE],
          f"kv_ops INSERT != DELETE: {stats['kv_ops']}")
    check(stats["kv_ops"][GET] == requests * gen
          and len(probe.found) == requests * gen
          and all(probe.found), "a decode page lookup was not found")
    check(stats["locality"]["local_fraction"] == 1.0,
          f"local fraction {stats['locality']['local_fraction']}")
    check(probe.busy is not None, "the decode round was not profiled")
    n_prefill_tok = requests * prompt
    n_decode_tok = len(probe.decode_s) * SERVE_BATCH
    log(f"  {requests} requests x {gen} tokens in {wall:.2f} s; "
        f"kv_ops {stats['kv_ops']}, locality "
        f"{stats['locality']['local_fraction']}, all {len(probe.found)} "
        f"decode page lookups found, every logit finite; "
        f"launches {launches | dma_launches}")
    rep_metrics = {}
    if replicas:
        rep = stats["replication"]
        publishes = eng.page_log.ring.publishes
        check(rep["detected_failovers"] == 1 and rep["rejoins_snapshot"] >= 1
              and rep["dropped"] == 0 and rep["lag"] == 0
              and rep["diverged_leaves"] == [0, 0]
              and eng.replica_divergence() == [0, 0],
              f"{label}: replication {rep}")
        check(dma_launches["remote_copy"] == publishes > 0,
              f"{label}: remote_copy launched "
              f"{dma_launches['remote_copy']} times for {publishes} ring "
              f"publishes")
        for name, n in dma_launches.items():
            check(n > 0, f"{label}: {name} was not launched")
        kill = path["plan"]["kills"][0]
        rep_metrics = dict(
            replication=rep, ring_publishes=publishes,
            dma_launches=dma_launches,
            detection_windows=rep["detector"]["detections"][0] - kill,
            promotion_ms=[1e3 * t for t in rep_times["promote"]],
            snapshot_rejoin_ms=[1e3 * t for t in rep_times["rejoin"]],
            rejoin_chunks=rep["rejoin_chunks"])
        log(f"  replication: detection in "
            f"{rep_metrics['detection_windows']} windows, promotion "
            f"{rep_metrics['promotion_ms']} ms, snapshot rejoin "
            f"{rep_metrics['snapshot_rejoin_ms']} ms in "
            f"{rep['rejoin_chunks']} chunks, {publishes} ring publishes, "
            f"diverged leaves {rep['diverged_leaves']}")
    metrics = dict(
        arch=arch, n_layers=cfg.n_layers, dtype=cfg.dtype, params=n_params,
        requests=requests, prompt_len=prompt, gen_len=gen,
        max_batch=SERVE_BATCH, replicas=replicas,
        backend=stats["backend"], generate_s=wall,
        tokens_per_s=requests * gen / wall,
        prefill_calls=len(probe.prefill_s),
        prefill_tokens_per_s=n_prefill_tok / sum(probe.prefill_s),
        prefill_ms_per_call=1e3 * float(np.mean(probe.prefill_s)),
        prefill_ms_p50=1e3 * float(np.percentile(probe.prefill_s, 50)),
        prefill_ms_p99=1e3 * float(np.percentile(probe.prefill_s, 99)),
        decode_steps=len(probe.decode_s),
        decode_tokens_per_s=n_decode_tok / sum(probe.decode_s),
        decode_step_p50_ms=1e3 * float(np.percentile(probe.decode_s, 50)),
        decode_step_p99_ms=1e3 * float(np.percentile(probe.decode_s, 99)),
        page_lookup_p50_ms=1e3 * float(np.percentile(probe.reads_s, 50)),
        peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        decode_round_profile=probe.busy,
        read_cache=stats["read_cache"], locality=stats["locality"],
        **rep_metrics)
    if path.get("a2a"):
        metrics["a2a"] = phase_a2a(torch, kernels, cfg, eng.params, metrics,
                                   launches["gmm"])
    return metrics, {name: launches[name] for name in expected} \
        | dma_launches


# ---------------------------------------------------------------------------
# phase 5b: the expert-parallel serving path on a stacked mesh
# ---------------------------------------------------------------------------

def recorded_call(module, name, fn):
    """Run ``fn()`` with ``module.name`` wrapped to record its arguments;
    returns the first call's."""
    orig, calls = getattr(module, name), []

    def rec(*a):
        calls.append(a)
        return orig(*a)
    setattr(module, name, rec)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return calls[0]


def gmm_entry(torch, kern, args, launches):
    """The grouped matmul's numbers at one call's arguments (``x, w,
    block_expert, block_t, block_rows``, block i on expert i, as at P_dp =
    1): wrapper and device ms, the plain version's, one ``torch.bmm`` of the
    same (experts, block_t, d) slots by w (every expert read) as the
    library yardstick,
    operations and bytes of the counted rows (the live experts' weights,
    the counted x rows, every output row, the two index vectors)."""
    from repro_torch.kernels import ref
    x, w, be, bt, rows = args
    nb, D, F = x.shape[0] // bt, w.shape[1], w.shape[2]
    check(nb == w.shape[0], f"gmm_entry: {nb} blocks on {w.shape[0]} experts")
    xb = x.view(nb, bt, D)
    n_rows = int(rows.clamp(0, bt).sum())
    live = int((rows > 0).sum())
    return dict(
        ms=cuda_ms(lambda: kern(x, w, be, bt, rows), 20),
        device_ms=device_ms(lambda: kern(x, w, be, bt, rows), 20),
        plain_ms=cuda_ms(lambda: ref.gmm(x, w, be, bt, rows), 2),
        library_ms=cuda_ms(lambda: torch.bmm(xb, w), 20),
        flops=2 * n_rows * D * F,
        nbytes=2 * (n_rows * D + live * D * F + x.shape[0] * F) + 8 * nb,
        experts=live, rows=n_rows, blocks=nb, block_t=bt, d=D, f=F,
        launches=launches)


def phase_a2a(torch, kernels, cfg, params, local, local_gmm_launches):
    """The expert-parallel serving path of an MoE config, on the weights of
    its phase-5 path (``params``; a second copy does not fit the card):
    ``make_serve_steps(cfg, make_debug_mesh(*A2A_MESH))`` — every MoE layer
    through ``make_moe_fn``'s stacked block, its three products over every
    shard's experts at once — one prefill of SERVE_BATCH x SERVE_PROMPT
    tokens, then A2A_DECODE greedy decode steps.  Every call's model-kernel
    launches are counted from 0 and must be exactly its attention kernel's
    per layer and three ``gmm`` per MoE layer; logits finite.  Then: the
    first MoE layer's block on a prefill's and a decode step's inputs with
    the kernel against the same block with ``ref.gmm``, both on the card
    (GMM_TOL's bf16 limit); a no-drop prefill against the local path
    (ATTN_TOL's bf16 limit); one profiled decode step (busy share, gmm's
    device ms a call); and gmm's numbers at the a2a decode and prefill
    calls and at the local decode call on the same state.  Returns the
    metrics, the local path's (``local``; its ``local_gmm_launches``)
    beside them."""
    import dataclasses
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.train import make_serve_steps
    arch = cfg.name
    mesh = make_debug_mesh(*A2A_MESH)
    _m, prefill, decode, _jit = make_serve_steps(cfg, mesh)
    _ml, prefill_local, decode_local, _jit = make_serve_steps(cfg, None)
    kinds = layer_kinds(cfg)
    n_moe = sum(k.endswith("_moe") for k in kinds)
    want = {"prefill": {"flash_attention": len(kinds), "gmm": 3 * n_moe},
            "decode": {"decode_attention": len(kinds), "gmm": 3 * n_moe}}
    total = dict.fromkeys(kernels, 0)

    def counted(fn, kind, what):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items()}
        check(all(n == want[kind].get(name, 0) for name, n in got.items()),
              f"{arch} a2a {what}: launches {got}, expected {want[kind]}")
        check(bool(torch.isfinite(out[0 if kind == "prefill" else 1])
                   .all()), f"{arch} a2a {what}: a logit is not finite")
        for name, n in got.items():
            total[name] += n
        return out, dt

    rng = np.random.default_rng(SEED + 11)
    tokens = rng.integers(1, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(
        np.int32)
    s_max = SERVE_PROMPT + A2A_DECODE + 1
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (lg, caches, pos), t_prefill = counted(
            lambda: prefill(params, {"tokens": tokens}, s_max), "prefill",
            "prefill")
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        steps = []
        for i in range(A2A_DECODE):
            (tok, lg, caches, pos), dt = counted(
                lambda: decode(params, tok, caches, pos), "decode",
                f"decode step {i}")
            steps.append(dt)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {name: n for name, n in total.items() if n}
        check(launches == {"flash_attention": len(kinds),
                           "decode_attention": len(kinds) * A2A_DECODE,
                           "gmm": 3 * n_moe * (1 + A2A_DECODE)},
              f"{arch} a2a: launches {launches}")
        # the block with the kernel against the block with ref.gmm
        errs = {}
        for what, step in (
                ("prefill", lambda: prefill(params, {"tokens": tokens},
                                            s_max)),
                ("decode", lambda: decode(params, tok, caches, pos))):
            args = recorded_call(M, "moe_block_a2a", step)
            got = M.moe_block_a2a(*args)[0]
            kernel, M.gmm = M.gmm, ref.gmm
            try:
                exp = M.moe_block_a2a(*args)[0]
            finally:
                M.gmm = kernel
            errs[what] = rel_err(got, exp)
            check(errs[what] <= GMM_TOL["bfloat16"],
                  f"{arch} a2a {what} block: kernel against ref.gmm "
                  f"{errs[what]} > {GMM_TOL['bfloat16']}")
            del args, got, exp
        # gmm's numbers at the a2a calls and the local decode call
        gmm = kernels["gmm"]
        n_gmm = total["gmm"]
        timing = {
            "decode": gmm_entry(torch, gmm, recorded_call(
                M, "gmm", lambda: decode(params, tok, caches, pos)), n_gmm),
            "prefill": gmm_entry(torch, gmm, recorded_call(
                M, "gmm", lambda: prefill(params, {"tokens": tokens},
                                          s_max)), n_gmm),
            "local_decode": gmm_entry(torch, gmm, recorded_call(
                M, "gmm", lambda: decode_local(params, tok, caches, pos)),
                local_gmm_launches)}
        ops = whole_session(torch, lambda: decode(params, tok, caches, pos),
                            1)
        dev_ms = sum(us for _n, us in ops.values()) / 1e3
        gmm_dev = sum(us for name, (_n, us) in ops.items()
                      if "gmm" in name) / 1e3 / (3 * n_moe)
        # nothing dropped: the a2a prefill against the local one
        nd = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        short = {"tokens": tokens[:1, :A2A_NODROP_PROMPT]}
        lg_a2a = make_serve_steps(nd, mesh)[1](params, short,
                                               A2A_NODROP_PROMPT)[0]
        lg_loc = make_serve_steps(nd, None)[1](params, short,
                                               A2A_NODROP_PROMPT)[0]
        nodrop_err = rel_err(lg_a2a, lg_loc.float())
        check(nodrop_err <= ATTN_TOL["bfloat16"],
              f"{arch} a2a no-drop prefill against the local path: "
              f"{nodrop_err} > {ATTN_TOL['bfloat16']}")
        del caches, lg_a2a, lg_loc
    p50 = float(np.percentile(steps, 50)) * 1e3
    m = dict(
        mesh=list(A2A_MESH), experts_per_shard=cfg.moe.n_experts
        // A2A_MESH[1], prefill_ms=1e3 * t_prefill,
        prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / t_prefill,
        decode_step_p50_ms=p50,
        decode_step_p99_ms=float(np.percentile(steps, 99)) * 1e3,
        decode_tokens_per_s=SERVE_BATCH * len(steps) / sum(steps),
        peak_device_gib=peak, launches=launches,
        profiled_decode_step=dict(device_ms=dev_ms, busy_share=dev_ms / p50,
                                  gmm_device_ms_per_call=gmm_dev),
        block_vs_ref_gmm=errs, nodrop_logits_err=nodrop_err,
        gmm_timing=timing,
        local=dict(prefill_ms=local["prefill_ms_per_call"],
                   decode_step_p50_ms=local["decode_step_p50_ms"],
                   decode_step_p99_ms=local["decode_step_p99_ms"],
                   decode_tokens_per_s=local["decode_tokens_per_s"],
                   peak_device_gib=local["peak_device_gib"],
                   decode_round_busy_share=(local["decode_round_profile"]
                                            or {}).get("device_busy_share")))
    log(f"  {arch} a2a on a {A2A_MESH} stacked mesh ({m['experts_per_shard']}"
        f" experts a shard): prefill {m['prefill_ms']:.1f} ms (local "
        f"{m['local']['prefill_ms']:.1f}), decode step p50 {p50:.2f} / p99 "
        f"{m['decode_step_p99_ms']:.2f} ms (local "
        f"{m['local']['decode_step_p50_ms']:.2f} / "
        f"{m['local']['decode_step_p99_ms']:.2f}), "
        f"{m['decode_tokens_per_s']:.1f} decode tokens/s (local "
        f"{m['local']['decode_tokens_per_s']:.1f}), peak {peak:.2f} GiB "
        f"(local {m['local']['peak_device_gib']:.2f}); launches {launches}")
    log(f"  {arch} a2a profiled decode step: device {dev_ms:.3f} ms, busy "
        f"{dev_ms / p50:.3f} of the p50 (local decode round "
        f"{m['local']['decode_round_busy_share']}), gmm {gmm_dev:.4f} device "
        f"ms a call; block against ref.gmm {errs} (tolerance "
        f"{GMM_TOL['bfloat16']}); no-drop logits against the local path "
        f"{nodrop_err:.3g} (tolerance {ATTN_TOL['bfloat16']})")
    for what, t in timing.items():
        log(f"  {arch} gmm at the {what} call: {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), {t['blocks']} blocks of {t['block_t']} "
            f"rows, {t['rows']} counted on {t['experts']} experts, plain "
            f"{t['plain_ms']:.3f}, bmm {t['library_ms']:.4f} ms")
    return m


# ---------------------------------------------------------------------------
# phase 5c: the serving steps across processes
# ---------------------------------------------------------------------------

def pm_configs():
    """Phase 5c's models: llama3.2-3b whole, llama4 at PM_MOE_LAYERS, and
    the five families of PM_CUT at their published widths, depth cut
    (deepseek-v3 at the no-drop capacity)."""
    from repro_torch.configs import get_config
    out = {SERVE_ARCH: get_config(SERVE_ARCH),
           MOE_ARCH: get_config(MOE_ARCH).replace(n_layers=PM_MOE_LAYERS)}
    for arch, cut in PM_CUT.items():
        out[arch] = get_config(arch).replace(**cut)
    out[DS_ARCH] = pm_nodrop(out[DS_ARCH])
    return out


def pm_capacity_config():
    """deepseek-v3 at PM_CUT's depth and its published capacity."""
    from repro_torch.configs import get_config
    return get_config(DS_ARCH).replace(**PM_CUT[DS_ARCH])


def pm_nodrop(cfg):
    """``cfg`` at the capacity that drops no routed token: each expert's
    slots the call's tokens."""
    import dataclasses
    mo = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def pm_s_max(cfg):
    return pm_prompt_len(cfg) + PM_DECODE + 1


def pm_prompt_len(cfg):
    """SERVE_PROMPT, where the model allows it: recurrentgemma's RG_PROMPT
    reaches past its window, whisper's WHISPER_PROMPT fits its text
    context, and at the no-drop capacity A2A_NODROP_PROMPT keeps the
    slots (an expert's slots are the call's tokens) small."""
    mo = cfg.moe
    if cfg.name == "recurrentgemma-2b":
        return RG_PROMPT
    if cfg.family == "audio":
        return WHISPER_PROMPT
    if mo is not None and mo.capacity_factor * mo.top_k >= mo.n_experts:
        return A2A_NODROP_PROMPT
    return SERVE_PROMPT


def pm_prompt(cfg):
    rng = np.random.default_rng(SEED + 13)
    return rng.integers(1, cfg.vocab, (SERVE_BATCH, pm_prompt_len(cfg))
                        ).astype(np.int32)


def pm_batch(torch, cfg, device):
    """The prompt, and for the vlm and whisper a context (B, n_ctx, d)
    drawn from SEED on ``device``: the same on every rank of the card."""
    batch = {"tokens": pm_prompt(cfg)}
    if cfg.family in ("vlm", "audio"):
        g = torch.Generator(device=device).manual_seed(SEED + 15)
        batch["context"] = torch.randn(
            (SERVE_BATCH, cfg.cross.n_context_tokens, cfg.d_model),
            generator=g, dtype=cfg.dtype_, device=device)
    return batch


def pm_seed_gates(torch, params):
    """The vlm's cross layers' ``gate_attn`` / ``gate_ffn`` scalars set in
    place from ±[0.3, 1.2], drawn from SEED in the tree's order (at the
    init's zero a cross layer is the identity).  Every rank holds the
    scalars whole, so the unsharded path and every rank set the same."""
    from repro_torch.tree import flatten
    rng = np.random.default_rng(SEED + 16)
    with torch.no_grad():
        for path, t in flatten(params):
            if path.rsplit("/", 1)[-1] in ("gate_attn", "gate_ffn"):
                t.fill_(float(rng.uniform(0.3, 1.2)
                              * rng.choice([-1.0, 1.0])))
    return params


def pm_planned(cfg, n_decode=PM_DECODE):
    """Each rank's model-kernel launches on one prefill and ``n_decode``
    decode steps, as :func:`expected_launches` counts them for one batch:
    flash per attention layer (a cross layer's and whisper's encoder,
    self and cross attention among them), rglru per recurrent layer and
    wkv6 per rwkv block at the prefill, decode attention per attention
    layer a step, three grouped matmuls per MoE layer a call (on the
    rank's experts)."""
    return expected_launches(cfg, SERVE_BATCH, n_decode + 1)


def pm_cache_blocks(caches):
    """The shapes of a rank's cache leaves of its first layer (whisper's
    first decoder layer's self and cross caches)."""
    from repro_torch.tree import flatten
    return {p: list(t.shape) for p, t in flatten(caches)
            if p.split("/")[0] == "0" or p.split("/")[1:2] == ["0"]}


def pm_fsdp_config():
    from repro_torch.configs import get_config
    return get_config(SERVE_ARCH).replace(n_layers=PM_FSDP_LAYERS)


def pm_generator(torch, device):
    return torch.Generator(device=device).manual_seed(SEED + 14)


def pm_warm(torch, prefill, decode, params, cfg, s_max, device="cuda"):
    """One prefill and one decode step, untimed and uncounted: the first
    calls' one-time costs (handles, module loads) stay out of the
    numbers."""
    lg, caches, pos = prefill(params, pm_batch(torch, cfg, device), s_max)
    decode(params, torch.argmax(lg, -1).to(torch.int32)[:, None], caches,
           pos)
    torch.cuda.synchronize()


def pm_timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class RouteLog:
    """Wraps ``repro_torch.models.moe.route`` (every MoE block routes
    through it) until :meth:`close`; off, it passes each call on.  On, it
    records each call's experts (:meth:`take` brings them to the host);
    given ``replay``, the rank's block of another run's experts, one
    tensor a route call in call order (:func:`pm_route_block`), it routes
    each call's tokens to those experts instead, weighted by the softmax
    of the call's own router logits at them, and keeps on the card the
    count of tokens whose own top-k differs and the largest gap: how far
    below its own k-th logit the replayed expert it would have left out
    lies, in standard deviations of the token's float32 router logits."""

    def __init__(self, replay=()):
        import torch
        from repro_torch.models import moe as M
        self.M, self.orig, self.on, self.calls = M, M.route, False, []
        self.replay, self.replaying = list(replay), bool(replay)
        self.differ, self.gap = 0, 0.0

        def route(params, x, mo):
            w, e, logits = self.orig(params, x, mo)
            if not self.on:
                return w, e, logits
            if not self.replaying:
                self.calls.append(e.clone())
                return w, e, logits
            if not self.replay:
                raise RuntimeError("a route call past the replayed ones")
            e_u = self.replay.pop(0)
            own = logits.gather(-1, e_u)
            kth = logits.topk(mo.top_k, -1).values[..., -1]
            gap = (kth - own.min(-1).values) / logits.std(-1)
            self.gap = torch.maximum(gap.max(), torch.as_tensor(self.gap))
            self.differ = self.differ + (e.sort(-1).values != e_u.sort(
                -1).values).any(-1).sum()
            return torch.softmax(own, -1).to(x.dtype), e_u, logits
        M.route = route

    def take(self):
        """The experts of the calls since the last take, on the host."""
        calls, self.calls = self.calls, []
        return [e.cpu() for e in calls]

    def summary(self):
        """{differ, gap, left}: the replay's tokens whose own top-k
        differed, the largest gap and the replayed calls not reached."""
        return dict(differ=int(self.differ), gap=float(self.gap),
                    left=len(self.replay))

    def close(self):
        self.M.route = self.orig


def pm_route_block(calls, coords, sizes):
    """A rank's block of the unsharded path's routes, one tensor a route
    call in call order: each call's experts (B·S, k) cut to the rank's
    rows and, where the call's S divides over ``model``, its slice of S,
    as ``moe_ep._process_moe_fn`` hands the rank its tokens."""
    n_dp, n_tp = sizes
    B, j = SERVE_BATCH, coords["model"]
    r0, r1 = coords["data"] * B // n_dp, (coords["data"] + 1) * B // n_dp
    out = []
    for call in calls:
        for e in call:
            S, k = e.shape[0] // B, e.shape[-1]
            t0, t1 = (0, S) if S % n_tp else \
                (j * S // n_tp, (j + 1) * S // n_tp)
            out.append(e.view(B, S, k)[r0:r1, t0:t1].reshape(-1, k))
    return out


def pm_unsharded(torch, cfg):
    """The unsharded path (``make_serve_steps(cfg, None)``) on the weights
    every rank draws its blocks of: the logits of the prefill and of
    PM_DECODE greedy decode steps and the greedy tokens, on the host, the
    prefill's and steps' times (after one warm-up of each), and each
    call's routes (:class:`RouteLog`; none but a MoE model's)."""
    from repro_torch.train import make_serve_steps
    model, prefill, decode, _jit = make_serve_steps(cfg, None)
    torch.cuda.reset_peak_memory_stats()
    params = pm_seed_gates(torch, model.init(pm_generator(torch, "cuda")))
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_max = pm_s_max(cfg)
    routes = RouteLog()
    try:
        with torch.no_grad():
            pm_warm(torch, prefill, decode, params, cfg, s_max)
            torch.cuda.reset_peak_memory_stats()
            routes.on = True
            batch = pm_batch(torch, cfg, "cuda")
            (lg, caches, pos), t_prefill = pm_timed(
                torch, lambda: prefill(params, batch, s_max))
            logits, calls = [lg.cpu()], [routes.take()]
            tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
            toks, steps = [tok.cpu()], []
            for _ in range(PM_DECODE):
                (tok, lg, caches, pos), dt = pm_timed(
                    torch, lambda: decode(params, tok, caches, pos))
                steps.append(dt)
                logits.append(lg.cpu())
                calls.append(routes.take())
                toks.append(tok.cpu())
    finally:
        routes.close()
    del params, caches
    return logits, toks, dict(
        prefill_ms=1e3 * t_prefill,
        decode_step_p50_ms=1e3 * float(np.percentile(steps, 50)),
        decode_step_p99_ms=1e3 * float(np.percentile(steps, 99)),
        init_peak_gib=init_peak,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30), calls


def pm_rank(rank, sizes, tokens, routes):
    """One rank of a phase-5c world (spawned; ``init_distributed`` has
    joined it): each model through ``make_serve_steps(cfg,
    ProcessMesh(*sizes))`` — the rank draws its blocks of the seeded
    weights, prefills the global batch and runs PM_DECODE steps of the
    bound decode (``jit_decode``), step i fed ``tokens[arch][i]``, a MoE
    model's tokens routed to ``routes[arch]``'s experts (the unsharded
    path's; :class:`RouteLog`) — with its model-kernel launches counted
    from 0 over that path; on a model axis above 1, deepseek-v3 then at
    its published capacity (:func:`pm_capacity_run`).  Returns its
    numbers, and on the rank at coordinate 0 the logits, which every model
    rank holds whole."""
    import torch
    from repro_torch.distributed.collectives import probe_transports
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.train import make_serve_steps
    kernels = {"flash_attention": flash_attention,
               "decode_attention": decode_attention, "gmm": gmm,
               "rglru_scan": rglru_scan, "wkv6": wkv6}
    mesh = ProcessMesh(*sizes)
    fsdp_mesh = ProcessMesh(*PM_FSDP[sizes]) if sizes in PM_FSDP else None
    out = {"coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend,
           "transports": dict(probe_transports(mesh))}
    if fsdp_mesh is not None:
        probe_transports(fsdp_mesh)
    for arch, cfg in pm_configs().items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, prefill, _decode, jit_decode = make_serve_steps(cfg, mesh)
        t0 = time.perf_counter()
        params = pm_seed_gates(torch, model.init(pm_generator(
            torch, mesh.device)))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_local = sum(t.numel() for t in _leaves(params))
        s_max = pm_s_max(cfg)
        step = pm_bound_decode(torch, cfg, jit_decode, s_max)
        log_routes = RouteLog([e.to(mesh.device) for e in pm_route_block(
            routes[arch], mesh.coords, sizes)])
        try:
            with torch.no_grad():
                pm_warm(torch, prefill, step, params, cfg, s_max,
                        mesh.device)
                torch.cuda.reset_peak_memory_stats()
                for k in kernels.values():
                    k.launches = 0
                log_routes.on = True
                batch = pm_batch(torch, cfg, mesh.device)
                (lg, caches, pos), prefill_s = pm_timed(
                    torch, lambda: prefill(params, batch, s_max))
                logits, steps, agree = [lg], [], 0
                for i in range(PM_DECODE):
                    tok = tokens[arch][i].to(mesh.device)
                    (nxt, lg, caches, pos), dt = pm_timed(
                        torch, lambda: step(params, tok, caches, pos))
                    steps.append(dt)
                    logits.append(lg)
                    agree += int(torch.equal(nxt.cpu(),
                                             tokens[arch][i + 1]))
                log_routes.on = False
        finally:
            log_routes.close()
        r = dict(
            launches={name: k.launches for name, k in kernels.items()},
            finite=all(bool(torch.isfinite(t).all()) for t in logits),
            greedy_steps_agreeing=agree, params_local=n_local,
            init_s=init_s, init_peak_gib=init_peak,
            prefill_ms=1e3 * prefill_s,
            decode_step_p50_ms=1e3 * float(np.percentile(steps, 50)),
            decode_step_p99_ms=1e3 * float(np.percentile(steps, 99)),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            cache_blocks=pm_cache_blocks(caches),
            routes=log_routes.summary())
        if all(c == 0 for c in mesh.coords.values()):
            r["logits"] = [t.cpu() for t in logits]
        out[arch] = r
        del caches, logits, lg, step
        if arch == DS_ARCH and sizes[1] > 1:
            out["capacity"] = pm_capacity_run(torch, mesh, params, kernels)
        del params
        gc.collect()
    if fsdp_mesh is not None:
        out["fsdp"] = pm_fsdp_run(torch, fsdp_mesh, kernels)
    return out


def pm_bound_decode(torch, cfg, jit_decode, s_max):
    """``jit_decode`` bound to ``cfg``'s full shapes (meta tensors)."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    full = build_model(cfg)
    return jit_decode(full.init(MetaGenerator()),
                      full.init_cache(SERVE_BATCH, s_max, device="meta"),
                      torch.empty((SERVE_BATCH, 1), dtype=torch.int32,
                                  device="meta"))


def pm_capacity_run(torch, mesh, params, kernels):
    """One rank's deepseek-v3 at its published capacity
    (:func:`pm_capacity_config`) on ``params``, the rank's blocks of the
    no-drop run (the capacity changes no weight): one prefill of
    SERVE_BATCH x SERVE_PROMPT tokens and PM_DECODE steps of the bound
    decode fed its own greedy tokens (every model rank holds the logits
    whole, so every one feeds the same), the model-kernel launches
    counted from 0.  No warm-up: the times include the new shapes' first
    calls."""
    from repro_torch.train import make_serve_steps
    cfg = pm_capacity_config()
    s_max = pm_s_max(cfg)
    _model, prefill, _decode, jit_decode = make_serve_steps(cfg, mesh)
    step = pm_bound_decode(torch, cfg, jit_decode, s_max)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        batch = pm_batch(torch, cfg, mesh.device)
        (lg, caches, pos), prefill_s = pm_timed(
            torch, lambda: prefill(params, batch, s_max))
        logits, steps = [lg], []
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        for _ in range(PM_DECODE):
            (tok, lg, caches, pos), dt = pm_timed(
                torch, lambda: step(params, tok, caches, pos))
            steps.append(dt)
            logits.append(lg)
    return dict(
        launches={name: k.launches for name, k in kernels.items()},
        finite=all(bool(torch.isfinite(t).all()) for t in logits),
        prefill_ms=1e3 * prefill_s,
        decode_step_p50_ms=1e3 * float(np.percentile(steps, 50)),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def pm_fsdp_run(torch, mesh, kernels):
    """A phase-5c rank's fsdp comparison on ``mesh`` (the world's second
    mesh, PM_FSDP): :func:`pm_fsdp_config` served through
    ``make_serve_steps(cfg, mesh, fsdp=...)``, fsdp=False then fsdp=True,
    each drawing the rank's blocks of the same seeded weights, one prefill
    of the global batch and PM_FSDP_DECODE steps of the bound decode fed
    the fsdp=False run's greedy tokens, the model-kernel launches
    (``kernels``) counted from 0 over that path.  Returns whether the two
    runs' logits agree bit for bit and each run's numbers."""
    from repro_torch.train import make_serve_steps
    out = {"coords": mesh.coords, "mesh": list(mesh.sizes), "runs": {}}
    cfg = pm_fsdp_config()
    s_max = SERVE_PROMPT + PM_FSDP_DECODE + 1
    logits, feed = {}, None
    for fsdp in (False, True):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, prefill, _decode, jit_decode = make_serve_steps(
            cfg, mesh, fsdp=fsdp)
        params = model.init(pm_generator(torch, mesh.device))
        n_local = sum(t.numel() for t in _leaves(params))
        step = pm_bound_decode(torch, cfg, jit_decode, s_max)
        with torch.no_grad():
            pm_warm(torch, prefill, step, params, cfg, s_max)
            for k in kernels.values():
                k.launches = 0
            (lg, caches, pos), prefill_s = pm_timed(torch, lambda: prefill(
                params, {"tokens": pm_prompt(cfg)}, s_max))
            got, steps = [lg.cpu()], []
            toks = [torch.argmax(lg, -1).to(torch.int32)[:, None]]
            for i in range(PM_FSDP_DECODE):
                tok = toks[i] if feed is None else feed[i]
                (nxt, lg, caches, pos), dt = pm_timed(
                    torch, lambda: step(params, tok, caches, pos))
                steps.append(dt)
                got.append(lg.cpu())
                toks.append(nxt)
        logits[fsdp] = got
        feed = feed or toks
        out["runs"][fsdp] = dict(
            launches={n: k.launches for n, k in kernels.items()},
            finite=all(bool(torch.isfinite(t).all()) for t in got),
            params_local=n_local, prefill_ms=1e3 * prefill_s,
            decode_step_p50_ms=1e3 * float(np.percentile(steps, 50)),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, prefill, step, params, caches, lg
    out["bitwise"] = all(torch.equal(a, b) for a, b in
                         zip(logits[False], logits[True]))
    return out


def pm_fsdp_check(ranks, backend, card, launches):
    """Phase 5c's fsdp comparison on the world's second mesh: each rank's
    ``fsdp`` entry checked (bit for bit, launches as planned, every logit
    finite) and logged; returns its label and metrics and adds each rank's
    fsdp launches to ``launches``."""
    sizes = tuple(ranks[0]["fsdp"]["mesh"])
    label = (f"world {len(ranks)} on {backend}, mesh {sizes}, fsdp, on one "
             f"card over gloo, not a cross-card number")
    cfg = pm_fsdp_config()
    want = pm_planned(cfg, PM_FSDP_DECODE)
    log(f"  {label}: {cfg.name} at {cfg.n_layers} layers, fsdp=False then "
        f"fsdp=True, {PM_FSDP_DECODE} decode steps; {card}")
    rows = []
    for r in (x["fsdp"] for x in ranks):
        where = f"5c {label} rank {r['coords']}"
        check(r["bitwise"], f"{where}: fsdp=True logits differ from "
              f"fsdp=False's")
        for fsdp, n in r["runs"].items():
            check(n["finite"], f"{where} fsdp={fsdp}: a logit is not finite")
            got_l = {k: v for k, v in n["launches"].items() if v}
            check(got_l == want, f"{where} fsdp={fsdp}: launches {got_l}, "
                  f"planned {want}")
        a, b = r["runs"][False], r["runs"][True]
        launches[f"{SERVE_ARCH} {PM_FSDP_LAYERS} layers fsdp {backend} "
                 f"{sizes} rank {r['coords']['data']}"] = {
            k: v for k, v in b["launches"].items() if v}
        rows.append({"coords": r["coords"], "bitwise": r["bitwise"],
                     "fsdp": b, "whole": a})
        log(f"    rank {r['coords']}: fsdp {b['params_local']:,} parameters, "
            f"peak {b['peak_gib']:.2f} GiB, prefill {b['prefill_ms']:.1f} "
            f"ms, decode step p50 {b['decode_step_p50_ms']:.1f} ms; whole "
            f"over dp {a['params_local']:,} parameters, peak "
            f"{a['peak_gib']:.2f} GiB, prefill {a['prefill_ms']:.1f} ms, "
            f"decode step p50 {a['decode_step_p50_ms']:.1f} ms; logits bit "
            f"for bit at every call; launches {want}")
    return label, dict(backend=backend, world=len(ranks), mesh=list(sizes),
                       fsdp=True, card=card, n_layers=cfg.n_layers,
                       decode_steps=PM_FSDP_DECODE, planned=want, ranks=rows)


def phase_process_mesh(torch, card):
    """Phase 5c: the unsharded path of each of pm_configs() on the card
    (its logits, greedy tokens and routes kept on the host, its weights
    freed), then each world of PM_WORLDS spawned from this process with the
    kernels already built, every rank on this card: world 1's logits bit
    for bit the unsharded path's, world 2's within PM_TP_TOL, every logit
    finite, each rank's launches the planned ones, a MoE model's routes
    the unsharded path's with each one the rank would have taken in their
    place a near tie, deepseek-v3 at its published capacity finite and
    launched as planned (:func:`pm_capacity_check`); on a world's second
    mesh (PM_FSDP) the fsdp run's logits bit for bit its fsdp=False run's
    (:func:`pm_fsdp_check`).
    Returns the metrics and each rank's launches by path label."""
    from repro_torch.launch.world import spawn_world
    cfgs = pm_configs()
    ref = {}
    for arch, cfg in cfgs.items():
        t0 = time.perf_counter()
        ref[arch] = pm_unsharded(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        t = ref[arch][2]
        log(f"  {arch} ({cfg.n_layers} layers) unsharded on the card in "
            f"{time.perf_counter() - t0:.1f} s: prefill "
            f"{t['prefill_ms']:.1f} ms, decode step p50 "
            f"{t['decode_step_p50_ms']:.2f} / p99 "
            f"{t['decode_step_p99_ms']:.2f} ms, peak {t['peak_gib']:.2f} "
            f"GiB serving ({t['init_peak_gib']:.2f} drawing the weights); "
            f"the parent holds "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB after it")
    tokens = {arch: r[1] for arch, r in ref.items()}
    routes = {arch: r[3] for arch, r in ref.items()}
    metrics = {"unsharded": {arch: r[2] for arch, r in ref.items()}}
    launches = {}
    for backend, sizes in PM_WORLDS:
        world = sizes[0] * sizes[1]
        label = (f"world {world} on {backend}, mesh {sizes}" +
                 (", on one card over gloo, not a cross-card number"
                  if world > 1 else ""))
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(pm_rank, world, backend=backend, device=None,
                                args=(sizes, tokens, routes),
                                timeout_s=PM_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 5c {label}: {e}") from None
        wall = time.perf_counter() - t0
        m = dict(backend=backend, world=world, mesh=list(sizes),
                 wall_s=wall, transports=ranks[0]["transports"],
                 devices=[r["device"] for r in ranks], card=card, models={})
        log(f"  {label}: {wall:.1f} s with start-up; transports "
            f"{ranks[0]['transports']}; {card}")
        for arch, cfg in cfgs.items():
            want = pm_planned(cfg)
            lead = next(r for r in ranks if "logits" in r[arch])
            got = lead[arch]["logits"]
            exp = ref[arch][0]
            check(len(got) == len(exp) == PM_DECODE + 1,
                  f"5c {label} {arch}: {len(got)} logits calls")
            if world == 1:
                same = [torch.equal(g, e) for g, e in zip(got, exp)]
                check(all(same), f"5c {label} {arch}: logits differ from "
                      f"the unsharded path's at calls "
                      f"{[i for i, x in enumerate(same) if not x]}")
                err = 0.0
            else:
                err = max(rel_err(g, e.float()) for g, e in zip(got, exp))
                check(err <= PM_TP_TOL, f"5c {label} {arch}: logits "
                      f"{err:.4g} from the unsharded path's > {PM_TP_TOL}")
            rows = []
            for r in ranks:
                n = r[arch]
                where = f"5c {label} {arch} rank {r['coords']}"
                check(n["finite"], f"{where}: a logit is not finite")
                got_l = {k: v for k, v in n["launches"].items() if v}
                check(got_l == want, f"{where}: launches {got_l}, planned "
                      f"{want}")
                rt = n["routes"]
                check(rt["left"] == 0, f"{where}: {rt['left']} replayed "
                      f"route calls never reached")
                check(rt["gap"] <= PM_ROUTE_TIE, f"{where}: a route differs "
                      f"from the unsharded path's by {rt['gap']:.4g} router "
                      f"deviations > {PM_ROUTE_TIE}: not a near tie")
                path = f"{arch} {backend} {sizes} rank {r['coords']['model']}"
                launches[path] = got_l
                rows.append({k: v for k, v in n.items() if k != "logits"}
                            | {"coords": r["coords"]})
                log(f"    {arch} rank {r['coords']}: "
                    f"{n['params_local']:,} parameters (first layer's "
                    f"cache blocks {n['cache_blocks']}) drawn in "
                    f"{n['init_s']:.1f} s (peak {n['init_peak_gib']:.2f} "
                    f"GiB), peak {n['peak_gib']:.2f} GiB serving, "
                    f"prefill {n['prefill_ms']:.1f} ms, decode step p50 "
                    f"{n['decode_step_p50_ms']:.2f} / p99 "
                    f"{n['decode_step_p99_ms']:.2f} ms, greedy tokens "
                    f"agreeing at {n['greedy_steps_agreeing']} of "
                    f"{PM_DECODE} steps, launches {got_l}"
                    + (f"; the unsharded path's routes replayed, the "
                       f"rank's own top-k differing for {rt['differ']} "
                       f"tokens, by at most {rt['gap']:.4g} router "
                       f"deviations (limit {PM_ROUTE_TIE})"
                       if cfg.moe is not None else ""))
            log(f"    {arch}: logits against the unsharded path's: "
                + ("bit for bit at every call" if world == 1 else
                   f"max {err:.4g} (tolerance {PM_TP_TOL})"))
            m["models"][arch] = dict(n_layers=cfg.n_layers, ranks=rows,
                                     logits_err=err, planned=want,
                                     decode_steps=PM_DECODE)
        metrics[label] = m
        if "capacity" in ranks[0]:
            cap_label, metrics[cap_label] = pm_capacity_check(
                ranks, backend, sizes, card, launches)
        if "fsdp" in ranks[0]:
            fsdp_label, metrics[fsdp_label] = pm_fsdp_check(
                ranks, backend, card, launches)
    return metrics, launches


def pm_capacity_check(ranks, backend, sizes, card, launches):
    """Phase 5c's deepseek-v3 at its published capacity on a model axis
    above 1: each rank's ``capacity`` entry checked (launches as planned,
    every logit finite) and logged; returns its label and metrics and adds
    each rank's launches to ``launches``."""
    cfg = pm_capacity_config()
    label = (f"world {len(ranks)} on {backend}, mesh {sizes}, {DS_ARCH} at "
             f"capacity_factor {cfg.moe.capacity_factor}, on one card over "
             f"gloo, not a cross-card number")
    want = pm_planned(cfg)
    log(f"  {label}: {cfg.n_layers} layers, {SERVE_BATCH} x "
        f"{pm_prompt_len(cfg)} prompts, {PM_DECODE} decode steps fed its "
        f"own greedy tokens, drops those of the a2a block; {card}")
    rows = []
    for r in ranks:
        n = r["capacity"]
        where = f"5c {label} rank {r['coords']}"
        check(n["finite"], f"{where}: a logit is not finite")
        got_l = {k: v for k, v in n["launches"].items() if v}
        check(got_l == want, f"{where}: launches {got_l}, planned {want}")
        launches[f"{DS_ARCH} capacity {cfg.moe.capacity_factor} {backend} "
                 f"{sizes} rank {r['coords']['model']}"] = got_l
        rows.append(n | {"coords": r["coords"]})
        log(f"    rank {r['coords']}: prefill {n['prefill_ms']:.1f} ms and "
            f"decode step p50 {n['decode_step_p50_ms']:.2f} ms (first "
            f"calls at these shapes included), peak {n['peak_gib']:.2f} "
            f"GiB, every logit finite, launches {got_l}")
    return label, dict(backend=backend, world=len(ranks), mesh=list(sizes),
                       card=card, n_layers=cfg.n_layers,
                       capacity_factor=cfg.moe.capacity_factor,
                       prompt=pm_prompt_len(cfg), decode_steps=PM_DECODE,
                       planned=want, ranks=rows)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# phase 7: the training path at full width and depth
# ---------------------------------------------------------------------------

class RepeatedBatch:
    """A pipeline that hands the trainer ``pipe``'s step-0 batch at every
    step, so the loss must fall as the model learns it."""

    def __init__(self, pipe):
        self.batch, self.seq = pipe.batch, pipe.seq
        self._tokens = pipe.get_batch(0)

    def get_batch(self, step):
        return self._tokens


# the grouped matmul's device kernels by wrapper: a kernel is the
# wrapper's if its name contains every part of one of the wrapper's tuples
# (the forward's tensor-core kernel and the CUDA-core one's forward
# instances, kTrans false; the input gradient's wgmma kernel and the
# CUDA-core kernel's transposed instances; the weight gradient's wgmma and
# CUDA-core kernels)
GMM_KERNELS = {
    "gmm": (("::gmm_mma_kernel<",), ("::gmm_kernel<", ", false>(")),
    "gmm_dx": (("::gmm_dx_wgmma_kernel<",), ("::gmm_kernel<", ", true>(")),
    "gmm_dw": (("::gmm_dw_wgmma_kernel(",), ("::gmm_dw_kernel<",))}
# device kernels by group, as their names contain these parts
KERNEL_GROUPS = {
    "flash_fwd": ("::flash_fwd",),
    "flash_bwd": ("::dsum_kernel", "::dkdv_kernel", "::dq_kernel",
                  "::dkdv_mma_kernel", "::dq_mma_kernel",
                  "::ld_wgmma_kernel", "::dkdv_wgmma_kernel",
                  "::dq_wgmma_kernel"),
    "rglru_fwd": ("::rglru_tile_kernel",),
    "rglru_bwd": ("::rglru_bwd_",),
    "wkv6_fwd": ("::wkv6_kernel", "::wkv6_chunk_kernel"),
    "wkv6_bwd": ("::wkv6_bwd_",)}


def profiled_step(torch, train_step, params, state, batch):
    """One training step under ``torch.profiler``: its wall time, the
    device's busy share of it, and each kernel group's (``KERNEL_GROUPS``:
    the flash forward and backward, the recurrences' forward and backward)
    time and share of the device time, where the step ran it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        params, state, met = train_step(params, state, batch)
        float(met["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us, by_name = 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            device_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    check(device_us > 0, "the profiled training step recorded no device "
                         "time")
    out = dict(wall_ms=wall_us / 1e3, device_ms=device_us / 1e3,
               device_busy_share=device_us / wall_us)
    for group, parts in KERNEL_GROUPS.items():
        us = sum(t for n, t in by_name.items()
                 if any(k in n for k in parts))
        if us:
            out[f"{group}_ms"] = us / 1e3
            out[f"{group}_share"] = us / device_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out["top_device_ms"] = {k[:60]: v / 1e3 for k, v in top}
    return params, state, out


def guard_refusals(torch, kernels):
    """On the card ``decode_attention`` (no backward ported: decode is not
    trained) and the bare ``rglru_scan`` and ``wkv6`` (whose training entry
    points are the autograd Functions) refuse an input that requires grad
    while grad is enabled (their outputs would carry no gradient), and
    launch nothing; the Functions, ``RGLRUScan`` and ``WKV6Train``, take
    the same inputs and their backward launches the backward kernels; and
    ``gmm``, which refused such an input before its backward was ported,
    takes it through ``GroupedMatmul`` and launches ``gmm_dx`` and
    ``gmm_dw`` in its backward."""
    from repro_torch.kernels.moe_gmm import gmm_dw, gmm_dx
    from repro_torch.kernels.rglru_scan import RGLRUScan, rglru_scan_bwd
    from repro_torch.kernels.wkv6 import WKV6Train, wkv6_bwd
    def rn(*shape, grad=False):
        return torch.randn(shape, device="cuda").requires_grad_(grad)

    be = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    calls = {
        "rglru_scan": lambda: kernels["rglru_scan"](rn(1, 8, 32, grad=True),
                                                    -rn(1, 8, 32).abs()),
        "wkv6": lambda: kernels["wkv6"](rn(1, 2, 8, 16, grad=True),
                                        rn(1, 2, 8, 16), rn(1, 2, 8, 16),
                                        rn(1, 2, 8, 16).sigmoid(),
                                        rn(2, 16)),
        "decode_attention": lambda: kernels["decode_attention"](
            rn(2, 4, 64, grad=True), rn(2, 2, 16, 64), rn(2, 2, 16, 64),
            lens)}
    for name, call in calls.items():
        before = kernels[name].launches
        try:
            call()
        except RuntimeError as e:
            check("no backward" in str(e) and name in str(e)
                  and kernels[name].launches == before,
                  f"{name}'s refusal of a grad-requiring input: {e}")
            continue
        raise SmokeFailure(f"{name} took a grad-requiring input on the card")
    x = rn(1, 8, 32, grad=True)
    la = (-rn(1, 8, 32).abs()).requires_grad_(True)
    q = [rn(1, 2, 8, 16, grad=True) for _ in range(3)]
    w = rn(1, 2, 8, 16).sigmoid().requires_grad_(True)
    u = rn(2, 16, grad=True)
    for fn, ins, fwd, bwd in [
            (RGLRUScan.apply, (x, la), kernels["rglru_scan"],
             rglru_scan_bwd),
            (WKV6Train.apply, (*q, w, u), kernels["wkv6"], wkv6_bwd)]:
        before = (fwd.launches, bwd.launches)
        y, _state = fn(*ins)
        grads = torch.autograd.grad(y.float().sum(), ins)
        torch.cuda.synchronize()
        check((fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
              and all(torch.isfinite(g).all() for g in grads),
              f"{fn.__self__.__name__} on grad-requiring CUDA inputs: "
              f"launches {before} -> {(fwd.launches, bwd.launches)}")
    g = kernels["gmm"]
    before = (g.launches, gmm_dx.launches, gmm_dw.launches)
    xg, wg = rn(16, 32, grad=True), rn(2, 32, 32, grad=True)
    y = g(xg, wg, be, 8)
    grads = torch.autograd.grad(y.sum(), (xg, wg))
    torch.cuda.synchronize()
    after = (g.launches, gmm_dx.launches, gmm_dw.launches)
    check(type(y.grad_fn).__name__ == "GroupedMatmulBackward"
          and after == tuple(n + 1 for n in before)
          and all(torch.isfinite(t).all() for t in grads),
          f"gmm on grad-requiring CUDA inputs: launches (gmm, gmm_dx, "
          f"gmm_dw) {before} -> {after}")
    log(f"  {', '.join(calls)}: each refuses a grad-requiring CUDA input; "
        f"RGLRUScan and WKV6Train take it and run their backward kernels; "
        f"gmm takes it through GroupedMatmul and runs gmm_dx and gmm_dw")


def checkpoint_round_trip(torch):
    """The smoke llama3.2-3b's bf16 parameters and AdamW state on the card
    after one step: saved async and blocking, ``keep_last`` 1, restored
    onto the card bitwise."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, leaves
    cfg = get_smoke_config(TRAIN_ARCH)
    model, opt, step = make_train_step(cfg, TrainConfig(), "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    params, state, _m = step(params, opt.init(params),
                             SyntheticTokens(cfg, 2, 64, SEED).get_batch(0))
    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep_last=1)
        ck.save(1, tree)
        ck.save(2, tree, blocking=True)
        check(ck.steps() == [2], f"checkpoint steps {ck.steps()}")
        got = ck.restore(2, tree)
    n = 0
    for (path, a), b in zip(flatten(tree), leaves(got)):
        check(b.device == a.device and b.dtype == a.dtype
              and bits_equal(torch, a.detach(), b),
              f"checkpoint leaf {path} did not round-trip")
        n += 1
    log(f"  checkpoint of the smoke {TRAIN_ARCH} state on the card: {n} "
        f"leaves ({cfg.dtype} parameters, float32 moments) restored "
        f"bitwise")


def train_launches(cfg):
    """Each model kernel's launches a training step of ``cfg`` under
    ``remat="block"``, from its layer plan: every attention (self, local,
    cross; whisper's encoder layer once, its decoder layer twice) two flash
    forwards (the forward and its recompute) and one backward call; every
    RG-LRU layer two scans and one backward; every rwkv6 layer two WKVs
    and one backward; every MoE layer six grouped matmuls (three products,
    each recomputed), three ``gmm_dx`` and three ``gmm_dw``, on the tensor
    cores in bf16 with widths multiples of 8; nothing else.  Returns ({name: launches}, {name:
    {route: launches}}): the flash backward's calls in bf16 on ``mma`` at
    D <= 128 and on ``wgmma`` above it, else the CUDA cores; the RG-LRU's on 16-byte copies
    (its rows are 5,120 bytes); the WKV's forward on the float32
    sequential kernel."""
    from repro_torch.models.transformer import layer_kinds
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) \
        if cfg.moe is not None else 0
    if cfg.family == "audio":
        attn, rec, rwkv = cfg.n_enc_layers + 2 * cfg.n_layers, 0, 0
    elif cfg.family == "ssm":
        attn, rec, rwkv = 0, 0, cfg.n_layers
    else:
        kinds = layer_kinds(cfg)
        rec = kinds.count("rec")
        attn, rwkv = len(kinds) - rec, 0
    bwd_route = "simt" if cfg.dtype != "bfloat16" or cfg.head_dim_ % 8 \
        else "mma" if cfg.head_dim_ <= 128 else "wgmma"
    launches = {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
                "rglru_scan": 2 * rec, "rglru_scan_bwd": rec,
                "wkv6": 2 * rwkv, "wkv6_bwd": rwkv, "gmm": 6 * n_moe,
                "gmm_dx": 3 * n_moe, "gmm_dw": 3 * n_moe}
    gmm_route = "mma" if cfg.dtype == "bfloat16" and n_moe and \
        cfg.d_model % 8 == 0 and cfg.moe.d_ff_expert % 8 == 0 else "simt"
    routes = {"flash_attention_bwd": {"mma": 0, "wgmma": 0, "simt": 0} | {
        bwd_route: attn},
        "rglru_scan": {"vector": 2 * rec, "scalar": 0},
        "rglru_scan_bwd": {"vector": rec, "scalar": 0},
        "wkv6": {"chunked": 0, "simt": 2 * rwkv},
        "wkv6_bwd": {"vector": rwkv, "scalar": 0},
        "gmm_dx": {"mma": 0, "simt": 0} | {gmm_route: 3 * n_moe},
        "gmm_dw": {"mma": 0, "simt": 0} | {gmm_route: 3 * n_moe}}
    return ({k: n for k, n in launches.items() if n},
            {k: r for k, r in routes.items() if sum(r.values())})


def train_path(torch, kernels, arch, seq, steps, optimizer,
               adam_dtype="float32", smoke=False):
    """``repro_torch.launch.train.run`` on ``arch`` at full width and
    depth: bf16, TRAIN_BATCH x ``seq`` tokens a step (with the pipeline's
    context for the vlm and whisper), ``remat="block"``, ``optimizer``,
    ``steps`` steps on one repeated SyntheticTokens batch.  Every loss
    finite and the last below the first; per step exactly the launches and
    routes of :func:`train_launches` and no other model kernel (no gmm, no
    decode attention); then one more step under ``torch.profiler``.
    ``smoke`` takes the arch's smoke config (the MoE family, whose
    published widths the launcher refuses for memory).  Returns the
    metrics and the launches."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import train as launcher
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    tcfg = TrainConfig(remat="block", optimizer=optimizer,
                       adam_dtype=adam_dtype)
    pipe = RepeatedBatch(SyntheticTokens(cfg, TRAIN_BATCH, seq, SEED))
    per_step, want_routes = train_launches(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "routes"):
            k.routes = dict.fromkeys(k.routes, 0)
    t0 = time.perf_counter()
    run = launcher.run(cfg, tcfg, pipe, steps=steps, device="cuda",
                       log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    routes = {name: dict(k.routes) for name, k in kernels.items()
              if name in want_routes}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, n in launches.items():
        check(n == steps * per_step.get(name, 0), f"{arch} training: {name} "
              f"launched {n} times, expected {steps * per_step.get(name, 0)}")
    for name, r in want_routes.items():
        want = {k: steps * n for k, n in r.items()}
        check(routes[name] == want, f"{arch} training: {name} routes "
              f"{routes[name]}, expected {want}")
    losses = run["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"{arch} training losses {losses}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
                                  f"{losses}")
    step_s, n_params = run["step_s"], run["n_params"]
    tokens = TRAIN_BATCH * seq
    log(f"  {arch}: {n_params:,} parameters, {steps} steps of "
        f"{TRAIN_BATCH} x {seq} tokens in {wall:.1f} s; losses {losses}; "
        f"launches {launches}; routes {routes}; peak {peak:.2f} GiB")
    params, state, prof = profiled_step(torch, run["train_step"],
                                        run["params"], run["opt_state"],
                                        pipe.get_batch(0))
    log(f"  profiled step: {json.dumps(prof)}")
    if "flash_bwd_ms" in prof:
        log(f"  {arch}: flash attention's backward {prof['flash_bwd_ms']:.3f}"
            f" device ms of the profiled step, "
            f"{100 * prof['flash_bwd_share']:.2f}% of its device time")
    metrics = dict(
        arch=arch, smoke=smoke, n_layers=cfg.n_layers, dtype=cfg.dtype,
        params=n_params,
        batch=TRAIN_BATCH, seq=seq, steps=steps, remat=tcfg.remat,
        optimizer=tcfg.optimizer, adam_dtype=tcfg.adam_dtype, losses=losses,
        grad_norms=run["grad_norms"], first_step_ms=1e3 * step_s[0],
        step_ms_p50=1e3 * float(np.percentile(step_s, 50)),
        step_ms_p99=1e3 * float(np.percentile(step_s, 99)),
        tokens_per_s=tokens / float(np.percentile(step_s, 50)),
        peak_device_gib=peak, step_profile=prof, launches=launches,
        routes=routes, wall_s=wall)
    if cfg.cross is not None:
        metrics["context_tokens"] = cfg.cross.n_context_tokens
    del run, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, {k: n for k, n in launches.items() if n}


def phase_train(torch, kernels):
    """The training paths: the full-width MoE blocks first
    (:func:`moe_block_full_width`, llama4-maverick and deepseek-v3: the
    largest allocations, while the card holds least), then llama3.2-3b
    (TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, AdamW) and each
    of ``TRAIN_PATHS`` (FAMILY_STEPS steps unless stated) through
    :func:`train_path`; then the guard of the bare kernels and the
    Functions, and a checkpoint round trip.  Returns the metrics and the
    launches by path."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.moe_gmm import gmm_dw, gmm_dx
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    counted = dict(kernels, flash_attention_bwd=flash_attention_bwd,
                   rglru_scan_bwd=rglru_scan_bwd, wkv6_bwd=wkv6_bwd,
                   gmm_dx=gmm_dx, gmm_dw=gmm_dw)
    metrics, launches = {}, {}
    for arch in (MOE_ARCH, DS_ARCH):
        t7 = time.perf_counter()
        label = f"{arch} block"
        metrics[label], launches[label] = moe_block_full_width(
            torch, counted, arch)
        log(f"  {label} took {time.perf_counter() - t7:.1f} s")
    for path in [dict(arch=TRAIN_ARCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                      optimizer="adamw")] + TRAIN_PATHS:
        path = dict(path)
        path.setdefault("steps", FAMILY_STEPS)
        label = path["arch"] + (" smoke" if path.get("smoke") else "")
        t7 = time.perf_counter()
        metrics[label], launches[label] = train_path(torch, counted, **path)
        log(f"  {label} training path took "
            f"{time.perf_counter() - t7:.1f} s")
    guard_refusals(torch, kernels)
    checkpoint_round_trip(torch)
    return metrics, launches


def moe_block_full_width(torch, kernels, arch):
    """``moe_block_local`` forward and backward at ``arch``'s published
    widths (one MoE block, bf16, weights drawn one expert at a time as
    ``init_moe`` draws them, no optimizer) on TRAIN_BATCH x TRAIN_SEQ
    tokens, the loss a fixed random projection of the output; the
    router's column of expert 0 zeroed, so that its logit 0 never makes a
    token's top-k against the others' random ones.  Every gradient
    finite, expert 0's gradient in each expert leaf exactly zero, exactly
    3 ``gmm``, 3 ``gmm_dx`` and 3 ``gmm_dw`` launches a block; ms (host
    clock to a synchronize), peak memory and, from one profiled call (a
    whole session, :func:`whole_session`), the three kernels' shares of
    the block's device time.  At deepseek-v3's
    widths (22.6 GB a set of expert gradients: room for a second) every
    gradient against the same block with ``gmm``'s plain versions on the
    card (:class:`PlainGmm`-style Function below), within ``GMM_TOL``'s
    bf16 limit of the leaf's largest |element|.  Returns the metrics and
    the launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import moe as M
    from repro_torch.tree import flatten
    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    params = M.init_moe(gen, cfg)
    params["router"][:, 0] = 0.0
    flat = flatten(params)
    ps = [t.requires_grad_(True) for _path, t in flat]
    B, S, d = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model
    x = torch.randn((B, S, d), generator=gen, device="cuda").to(
        cfg.dtype_).requires_grad_(True)
    proj = torch.randn((B, S, d), generator=gen, device="cuda")

    def block():
        out, _aux = M.moe_block_local(params, x, cfg)
        return torch.autograd.grad((out.float() * proj).sum(), ps + [x])

    before = {n: k.launches for n, k in kernels.items()}
    t0 = time.perf_counter()
    grads = block()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    counts = {n: k.launches - before[n] for n, k in kernels.items()
              if k.launches != before[n]}
    check(counts == {"gmm": 3, "gmm_dx": 3, "gmm_dw": 3},
          f"{arch} full-width MoE block: launches {counts}, expected 3 "
          f"gmm, 3 gmm_dx, 3 gmm_dw")
    check(all(np.isfinite(max_abs(g)) for g in grads),
          f"{arch} full-width MoE block: a gradient is not finite")
    zero = [not g[0].any() for (p, _t), g in zip(flat, grads)
            if p.startswith("experts")]
    check(len(zero) == 3 and all(zero),
          f"{arch} full-width MoE block: expert 0 got no token, but its "
          f"gradient is not zero in {zero}")
    times = []
    for _ in range(3):
        del grads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = block()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del grads
    # a session that lost the first records (the forward's) is run again
    by, total = {"gmm": 0.0, "gmm_dx": 0.0, "gmm_dw": 0.0}, 0.0
    for op, (_n, us) in whole_session(torch, block, 1).items():
        total += us
        for name, kernel in GMM_KERNELS.items():
            if any(all(p in op for p in parts) for parts in kernel):
                by[name] += us
    grads = block()
    check(total > 0 and all(by.values()),
          f"{arch} full-width MoE block: profiled device time {by} of "
          f"{total} µs")
    metrics = dict(arch=arch, d_model=d, n_experts=cfg.moe.n_experts,
                   top_k=cfg.moe.top_k, d_ff_expert=cfg.moe.d_ff_expert,
                   tokens=B * S, first_ms=first_ms, ms=times,
                   ms_p50=float(np.percentile(times, 50)),
                   peak_device_gib=peak, held_before_gib=held,
                   device_ms=total / 1e3,
                   kernel_device_ms={k: v / 1e3 for k, v in by.items()},
                   kernel_share={k: v / max(total, 1e-9)
                                 for k, v in by.items()},
                   launches=counts)
    if arch == DS_ARCH:

        class Plain(torch.autograd.Function):
            """``gmm`` with its plain forward and backward on the card."""

            @staticmethod
            def forward(ctx, x_, w, be, bt, rows):
                ctx.save_for_backward(x_, w, be, rows)
                ctx.bt = bt
                return ref.gmm(x_, w, be, bt, rows)

            @staticmethod
            def backward(ctx, dy):
                x_, w, be, rows = ctx.saved_tensors
                return (ref.gmm(dy, w.transpose(1, 2), be, ctx.bt, rows),
                        ref.gmm_dw(x_, dy, be, ctx.bt, rows, w.shape[0]),
                        None, None, None)

        orig = M.gmm
        M.gmm = lambda x_, w, be, bt, rows=None: Plain.apply(x_, w, be, bt,
                                                            rows)
        try:
            plain = block()
        finally:
            M.gmm = orig
        worst = 0.0
        for (path, _t), a, b in zip(flat + [("x", x)], grads, plain):
            e = max_abs_diff(a, b) / max(max_abs(b), 1e-30)
            check(e <= GMM_TOL["bfloat16"], f"{arch} full-width MoE block: "
                  f"gradient {path} differs from the plain versions' by "
                  f"{e} of its largest (limit {GMM_TOL['bfloat16']})")
            worst = max(worst, e)
        metrics["plain_grad_max_rel_err"] = worst
        del plain
    log(f"  {arch} full-width MoE block ({B} x {S} tokens, forward and "
        f"backward): {json.dumps(metrics)}")
    del grads, params, flat, ps, x, proj
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, counts


# ---------------------------------------------------------------------------
# phase 7c: the training steps across processes
# ---------------------------------------------------------------------------

def pt_models(sizes, stage):
    """Phase 7c's models in a world of ``sizes`` at ZeRO ``stage``: (label,
    arch, smoke, layers, seq, yardstick).  World 1: llama3.2-3b at full
    width and depth on TRAIN_BATCH x TRAIN_SEQ and the smoke
    llama4-maverick on TRAIN_BATCH x MOE_SMOKE_SEQ, each against the
    one-device step bit for bit; world 2: llama3.2-3b cut to PT_LAYERS on
    TRAIN_BATCH x PT_SEQ, on (1, 2) also the smoke llama4, on (2, 1) at
    stage 3 also the smoke whisper and rwkv6 on TRAIN_BATCH x
    PT_SMOKE_SEQ, against the reference steps the parent ran (the
    one-device step; llama4's the stacked binding's on a (1, 2) mesh: its
    load-balance loss is the mean of the shards', as the reference's
    ``pmean``)."""
    if sizes == (1, 1):
        return [(TRAIN_ARCH, TRAIN_ARCH, False, 0, TRAIN_SEQ, "bitwise"),
                (f"{MOE_ARCH} smoke", MOE_ARCH, True, 0, MOE_SMOKE_SEQ,
                 "bitwise")]
    out = [(f"{TRAIN_ARCH} {PT_LAYERS} layers", TRAIN_ARCH, False,
            PT_LAYERS, PT_SEQ, "tolerance")]
    if sizes[1] > 1:
        out.append((f"{MOE_ARCH} smoke", MOE_ARCH, True, 0, MOE_SMOKE_SEQ,
                    "tolerance"))
    if sizes == (2, 1) and stage >= 3:
        out += [(f"{arch} smoke", arch, True, 0, PT_SMOKE_SEQ, "tolerance")
                for arch in ("whisper-large-v3", "rwkv6-7b")]
    return out


def pt_config(arch, smoke, layers):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return cfg.replace(n_layers=layers) if layers else cfg


def pt_batches(cfg, seq):
    """PT_STEPS batches and one for the profiled step."""
    from repro_torch.data import SyntheticTokens
    pipe = SyntheticTokens(cfg, TRAIN_BATCH, seq, SEED)
    return [pipe.get_batch(i) for i in range(PT_STEPS + 1)]


def pt_generator(torch, device):
    return torch.Generator(device=device).manual_seed(SEED + 15)


def pt_digest(torch, t):
    """A digest of ``t``'s bits: the sum of each element's bits (as a
    signed integer of its width) times 2·i + 1, i its flat index, in
    int64; equal tensors give equal digests, and one changed element
    changes it."""
    flat = t.detach().contiguous().reshape(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total, chunk = 0, 1 << 24
    for lo in range(0, bits.numel(), chunk):
        b = bits[lo:lo + chunk].long()
        w = torch.arange(lo, lo + b.numel(), device=b.device,
                         dtype=torch.long).mul_(2).add_(1)
        total += int((b * w).sum())
    return total


def pt_digests(torch, params, state):
    from repro_torch.tree import leaves
    return [pt_digest(torch, t) for t in leaves(params) + leaves(state)]


def pt_steps(torch, step, params, state, batches, digests):
    """PT_STEPS steps: (params, state, losses and grad norms as floats,
    each step's wall seconds, each step's digests where asked)."""
    losses, norms, times, dig = [], [], [], []
    for b in batches[:PT_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if digests:
            dig.append(pt_digests(torch, params, state))
    return params, state, losses, norms, times, dig


def pt_profiled(torch, mesh, fn):
    """One profiled call of ``fn`` on every rank in step: a session is kept
    when it is whole on every rank (an all-reduce of the ranks' verdicts),
    else every rank runs another, up to PROFILER_SESSIONS."""
    import torch.distributed as dist
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    for _session in range(PROFILER_SESSIONS):
        ops, lead, tail = profiled_calls(torch, fn, 1)
        torn = torch.tensor([0.0 if lead and tail and ops else 1.0],
                            device=dev)
        dist.all_reduce(torn)
        if float(torn) == 0.0:
            return ops
        SESSIONS_RUN_AGAIN[0] += 1
    raise SmokeFailure(f"torch.profiler lost device records in each of "
                       f"{PROFILER_SESSIONS} sessions of a training step")


def pt_groups(ops):
    """Device operations of a profiled step by kernel row: the flash
    forward (row 6) and backward (row 6b), ``gmm`` (row 9), ``gmm_dx`` and
    ``gmm_dw`` (row 9b)."""
    out = {}
    for group in ("flash_fwd", "flash_bwd"):
        out[group] = sum(n for name, (n, _us) in ops.items()
                         if any(k in name for k in KERNEL_GROUPS[group]))
    for wrapper, names in GMM_KERNELS.items():
        out[wrapper] = sum(n for name, (n, _us) in ops.items()
                           if any(all(p in name for p in parts)
                                  for parts in names))
    return out


def pt_within(torch, got, ref, tcfg):
    """The largest ratio over every element of |got - ref| to the most
    PT_STEPS AdamW steps can move it apart (PT_STEP_BOUND · lr · (1 + wd ·
    |ref|) a step) plus PT_ULPS · |ref| of bf16 roundings."""
    g, r = got.detach().float(), ref.to(got.device).float()
    bound = PT_STEPS * PT_STEP_BOUND * tcfg.lr * (
        1 + tcfg.weight_decay * r.abs()) + PT_ULPS * r.abs()
    return float(((g - r).abs() / bound).max())


def pt_kernels():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.moe_gmm import gmm, gmm_dw, gmm_dx
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd, "gmm": gmm,
            "gmm_dx": gmm_dx, "gmm_dw": gmm_dw,
            "decode_attention": decode_attention, "rglru_scan": rglru_scan,
            "rglru_scan_bwd": rglru_scan_bwd, "wkv6": wkv6,
            "wkv6_bwd": wkv6_bwd}


def pt_capture_push(opt, pushed):
    """Wrap ``opt``'s ZeRO push so that its first output (the first step's
    blocks of the dp-mean gradient) lands in ``pushed``, by path; returns
    the push to put back."""
    from repro_torch.tree import flatten
    push = opt.plan.grad_blocks

    def first_push(tree):
        blocks = push(tree)
        if not pushed:
            pushed.update({p: b.detach().clone() for (p, _t), b in
                           zip(flatten(tree), blocks)})
        return blocks

    opt.plan.grad_blocks = first_push
    return push


def pt_pod_twin(torch, kernels, pod, cfg, tcfg, batches, flat):
    """A model trained again on the (pod, data, model) mesh ``pod`` over
    the same ranks, from the same weights and batches: whether each
    step's losses, grad norms and digests, and the first dp-mean
    gradient's blocks (where ``flat`` kept them), are bit for bit
    ``flat``'s, with the twin's launches and step p50."""
    from repro_torch.train import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    model, opt, step, _jit = make_train_step(cfg, tcfg, mesh=pod)
    params = model.init(pt_generator(torch, pod.device))
    state = opt.init(params)
    pushed = {}
    push = pt_capture_push(opt, pushed)
    for k in kernels.values():
        k.launches = 0
    params, state, losses, norms, times, dig = pt_steps(
        torch, step, params, state, batches, True)
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    opt.plan.grad_blocks = push
    out = dict(mesh=list(pod.sizes), launches=launches,
               step_p50_ms=1e3 * float(np.percentile(times, 50)),
               bitwise_steps=[a == b for a, b in zip(flat["digests"], dig)],
               bitwise_losses=losses == flat["losses"]
               and norms == flat["norms"])
    if flat.get("pushed") is not None:
        out["bitwise_grads"] = [pt_digest(torch, b) for b in
                                pushed.values()] == flat["pushed"]
    del model, opt, step, params, state, pushed
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pt_rank(rank, sizes, stage, ref_file):
    """One rank of a phase-7c world (spawned; ``init_distributed`` has
    joined it): each of :func:`pt_models` through ``make_train_step(cfg,
    tcfg, mesh=ProcessMesh(*sizes))`` at ZeRO ``stage`` — the rank draws
    its blocks of the seeded weights, runs PT_STEPS steps on the global
    batches with its launches counted from 0, then one profiled step.  A
    bitwise model first runs the one-device step in this rank on the same
    weights and batches (then freed), and every step's losses, parameters
    and moments must be its bits (digests); a tolerance model's blocks are
    held to the parent's reference steps (``ref_file``).  Returns the
    rank's numbers."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TPL
    from repro_torch.distributed.collectives import probe_transports
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models import build_model
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten, tree_map
    kernels = pt_kernels()
    mesh = ProcessMesh(*sizes)
    pod, twin_label = PT_POD.get(sizes, (None, None))
    pod = ProcessMesh(*pod) if pod is not None else None
    out = {"coords": mesh.coords, "device": str(mesh.device),
           "backend": mesh.backend,
           "transports": dict(probe_transports(mesh)), "models": {}}
    if pod is not None:
        out["pod_transports"] = dict(probe_transports(pod))
    refs = torch.load(ref_file, weights_only=False) if ref_file else {}
    fsdp_min = SH.FSDP_MIN_ELEMENTS
    for label, arch, smoke, layers, seq, yard in pt_models(sizes, stage):
        cfg = pt_config(arch, smoke, layers)
        tcfg = TrainConfig(remat="block", zero_stage=stage)
        # a smoke model at stage 3 splits every leaf (none reaches 2^20)
        SH.FSDP_MIN_ELEMENTS = 1 if smoke and stage >= 3 else fsdp_min
        batches = pt_batches(cfg, seq)
        twin = label == twin_label
        r = {}
        gc.collect()
        torch.cuda.empty_cache()
        if yard == "bitwise":
            model, opt, step = make_train_step(cfg, tcfg, mesh.device)
            params = model.init(pt_generator(torch, mesh.device))
            state = opt.init(params)
            params, state, want_l, want_n, t_one, want_d = pt_steps(
                torch, step, params, state, batches, True)
            r["one_device_step_p50_ms"] = 1e3 * float(np.percentile(t_one,
                                                                    50))
            del model, opt, step, params, state
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt, step, _jit = make_train_step(cfg, tcfg, mesh=mesh)
        params = model.init(pt_generator(torch, mesh.device))
        state = opt.init(params)
        pushed, push = {}, opt.plan.grad_blocks
        if yard != "bitwise":
            push = pt_capture_push(opt, pushed)
        for k in kernels.values():
            k.launches = 0
        params, state, losses, norms, times, dig = pt_steps(
            torch, step, params, state, batches, yard == "bitwise" or twin)
        launches = {n: k.launches for n, k in kernels.items() if k.launches}
        opt.plan.grad_blocks = push
        r.update(losses=losses, grad_norms=norms, launches=launches,
                 step_ms=[1e3 * t for t in times],
                 step_p50_ms=1e3 * float(np.percentile(times, 50)),
                 params_local=sum(t.numel() for _p, t in flatten(params)))
        flat = dict(digests=dig, losses=losses, norms=norms,
                    pushed=[pt_digest(torch, b) for b in pushed.values()]
                    if pushed else None)
        if yard == "bitwise":
            r["bitwise_steps"] = [
                a == b for a, b in zip(want_d, dig)]
            r["bitwise_losses"] = losses == want_l and norms == want_n
        else:
            ref = refs[label]
            full = build_model(cfg).init(MetaGenerator())
            layout = TPL.param_layout(full, cfg, mesh, stage >= 3)
            spec_list = []
            tree_map(lambda _t, s: spec_list.append(tuple(s)), full, layout)
            specs = dict(zip((p for p, _ in flatten(full)), spec_list))
            worst, moved = 0.0, False
            for path, t in flatten(params):
                whole = ref["params"][path]
                want = SH.shard(whole, specs[path], mesh)
                worst = max(worst, pt_within(torch, t, want, tcfg))
                moved |= not torch.equal(t.cpu(), SH.shard(
                    ref["init"][path], specs[path], mesh))
            grad_err, grad_leaf = pt_grad_err(torch, pushed, {
                p: SH.shard(ref["grads"][p], opt.plan.spec[p], mesh)
                for p in pushed})
            del pushed
            r.update(param_ratio=worst, moved=moved, grad_err=grad_err,
                     grad_leaf=grad_leaf,
                     loss_err=max(abs(a - b) / abs(b) for a, b in
                                  zip(losses, ref["losses"])),
                     grad_norm_err=max(abs(a - b) / abs(b) for a, b in
                                       zip(norms, ref["grad_norms"])))
        r["profiled"] = pt_groups(pt_profiled(
            torch, mesh, lambda: step(params, state, batches[-1])))
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, opt, step, params, state
        if twin:
            if yard == "bitwise":     # the one-device step's bits
                flat.update(digests=want_d, losses=want_l, norms=want_n)
            r["pod"] = pt_pod_twin(torch, kernels, pod, cfg, tcfg, batches,
                                   flat)
        out["models"][label] = r
        gc.collect()
        torch.cuda.empty_cache()
    SH.FSDP_MIN_ELEMENTS = fsdp_min
    return out


def pt_grads(torch, model, params, batch, rows=False):
    """The gradient of ``model``'s loss at ``params`` on ``batch``, by
    path, on the host; with ``rows`` the float32 mean of each batch row's
    own gradient (the same gradient, each row's loss a mean over as many
    tokens, rounded in another order: phase 7c's bf16 control)."""
    from repro_torch.data.pipeline import place_batch
    from repro_torch.tree import flatten, leaves
    paths = [p for p, _ in flatten(params)]
    ps = leaves(params)
    for t in ps:
        t.requires_grad_(True)
    batch = place_batch(batch, ps[0].device)
    parts = ([{k: v[i:i + 1] for k, v in batch.items()}
              for i in range(TRAIN_BATCH)] if rows else [batch])
    acc = None
    for part in parts:
        loss, _m = model.train_loss(params, part)
        g = torch.autograd.grad(loss, ps)
        if acc is None:
            acc = [x.float() if rows else x for x in g]
        else:
            for a, x in zip(acc, g):
                a.add_(x.float())
        del loss, g
    for t in ps:
        t.requires_grad_(False)
    if rows:
        acc = [(a / len(parts)).to(t.dtype) for a, t in zip(acc, ps)]
    return {p: a.detach().cpu() for p, a in zip(paths, acc)}


def pt_grad_err(torch, got, want):
    """The largest over leaves of ||got - want|| / ||want|| (float32), and
    that leaf's path; ``got`` and ``want`` by path, ``want`` on the host
    (each leaf, or each block, as ``got`` holds it)."""
    worst, where = 0.0, None
    for path, g in got.items():
        w = want[path].to(g.device).float()
        d = float((g.float() - w).norm())
        n = float(w.norm())
        e = d / n if n else (0.0 if d == 0 else float("inf"))
        if e >= worst:
            worst, where = e, path
    return worst, where


def pt_reference(torch, label, arch, smoke, layers, seq):
    """The reference steps of a tolerance model, on the card in this
    process: the losses, grad norms and final parameters (on the host) of
    PT_STEPS steps on the seeded weights — the one-device step, or for
    the MoE smoke config its stacked binding's on a (1, 2) mesh — the
    initial parameters, and the first step's gradient.  For the dense
    model also the bf16 control: the same first gradient as the mean of
    each batch row's (:func:`pt_grads`) and PT_STEPS steps of the
    one-device step with microbatches of one row, their distances from
    the reference's by phase 7c's measures."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.train import make_train_step
    from repro_torch.tree import flatten
    cfg = pt_config(arch, smoke, layers)
    tcfg = TrainConfig(remat="block", zero_stage=2)
    mesh = StackedMesh((1, 2), ("data", "model")) if cfg.moe else None
    control_too = cfg.moe is None and not smoke
    batches = pt_batches(cfg, seq)
    model, opt, step = make_train_step(cfg, tcfg, "cuda", mesh=mesh)
    params = model.init(pt_generator(torch, "cuda"))
    init = {p: t.detach().cpu() for p, t in flatten(params)}
    grads = pt_grads(torch, model, params, batches[0])
    control = {}
    if control_too:
        control["grad_err"], control["grad_leaf"] = pt_grad_err(
            torch, pt_grads(torch, model, params, batches[0], rows=True),
            grads)
    state = opt.init(params)
    params, state, losses, norms, times, _d = pt_steps(
        torch, step, params, state, batches, False)
    out = dict(losses=losses, grad_norms=norms, init=init, grads=grads,
               params={p: t.detach().cpu() for p, t in flatten(params)},
               step_p50_ms=1e3 * float(np.percentile(times, 50)))
    del model, opt, step, params, state
    gc.collect()
    torch.cuda.empty_cache()
    if control_too:
        model, opt, step = make_train_step(
            cfg, TrainConfig(remat="block", zero_stage=2,
                             microbatch=TRAIN_BATCH), "cuda")
        params = model.init(pt_generator(torch, "cuda"))
        state = opt.init(params)
        _p, _s, c_losses, c_norms, _t, _d = pt_steps(
            torch, step, params, state, batches, False)
        control.update(
            loss_err=max(abs(a - b) / abs(b) for a, b in
                         zip(c_losses, losses)),
            grad_norm_err=max(abs(a - b) / abs(b) for a, b in
                              zip(c_norms, norms)))
        del model, opt, step, params, state, _p, _s
        gc.collect()
        torch.cuda.empty_cache()
    out["control"] = control
    return out


def pt_elastic_rank(rank, ckpt_dir):
    """A world of 2 on (2, 1) training the smoke llama3.2-3b (bf16) that
    loses rank 1 at step 2: two steps, a checkpoint at step 1, then
    ``run_elastic`` to step 4 with a failure at step 2 that rank 0 alone
    sees — rank 1 leaves its world there without a word (its sockets
    closed, no collective, no ``shrink_world``), as a rank that died; rank
    0 re-forms the world alone on (1, 1), restores step 1 onto its new
    blocks and trains steps 2 and 3."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed import ElasticMeshSpec, run_elastic
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import state_shardings
    cfg = get_smoke_config(TRAIN_ARCH)
    tcfg = TrainConfig(remat="block")
    pipe = SyntheticTokens(cfg, TRAIN_BATCH, 64, SEED)
    ckpt = CheckpointManager(ckpt_dir, keep_last=2)
    spec = ElasticMeshSpec(shapes=[(2, 1), (1, 1)],
                           axis_names=("data", "model"), binding="process")
    meshes, losses = [], []

    def build(mesh):
        meshes.append(dict(mesh.shape))
        model, opt, train_step, _jit = make_train_step(cfg, tcfg, mesh=mesh)
        params = model.init(pt_generator(torch, mesh.device))
        state = {"params": params, "opt": opt.init(params)}

        def step_fn(state, batch):
            p, o, m = train_step(state["params"], state["opt"], batch)
            losses.append((len(meshes) - 1, float(m["loss"])))
            return {"params": p, "opt": o}, m

        return state, step_fn, lambda m: state_shardings(cfg, tcfg, m)

    mesh = spec.mesh_for(0)
    state, step_fn, shard_fn = build(mesh)
    for s in range(2):
        state, _m = step_fn(state, pipe.get_batch(s))
    ckpt.save(1, state, shardings=shard_fn(mesh))
    gone = []

    def get_batch(s):
        if rank == 1 and s == 2:
            dist.destroy_process_group()
            gone.append(s)
            raise SmokeFailure("rank 1 left")
        return pipe.get_batch(s)

    t0 = time.perf_counter()
    try:
        final, history = run_elastic(
            spec, build, ckpt, total_steps=4, get_batch=get_batch,
            inject_failure_at={2: True} if rank == 0 else {},
            log=lambda *_a: None)
    except SmokeFailure:
        if not gone:
            raise
        return dict(history=[], meshes=meshes, losses=losses, left=True,
                    elastic_s=time.perf_counter() - t0)
    return dict(history=history, meshes=meshes, losses=losses,
                left=final is None, elastic_s=time.perf_counter() - t0)


def phase_train_process_mesh(torch, card):
    """Phase 7c: the training steps across processes.  First the reference
    steps of world 2's models in this process (their final parameters kept
    on the host, in a file the ranks read), then each world spawned from
    this process with the kernels already built, every rank on this card:
    world 1 on NCCL, then the PT_WORLDS over gloo, each after its ranks'
    bytes are reckoned; then the elastic world.  Returns the metrics and
    each rank's launches by path label."""
    import tempfile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import StackedMesh
    from repro_torch.launch.train import memory_reckoning
    from repro_torch.launch.world import spawn_world
    from repro_torch.models.transformer import layer_kinds
    metrics, launches = {"card": card}, {}
    have = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory(prefix="phase7c-") as tmp:
        refs = {}
        for sizes, stage in sorted({(s, z) for _b, s, z in PT_WORLDS}):
            for label, arch, smoke, layers, seq, yard in pt_models(sizes,
                                                                   stage):
                if yard == "tolerance" and label not in refs:
                    refs[label] = pt_reference(torch, label, arch, smoke,
                                               layers, seq)
                    c = refs[label]["control"]
                    log(f"  reference {label}: losses "
                        f"{refs[label]['losses']}, step p50 "
                        f"{refs[label]['step_p50_ms']:.1f} ms" + (
                            f"; bf16 control: first gradient "
                            f"{c['grad_err']:.3g} (worst leaf "
                            f"{c['grad_leaf']}), losses "
                            f"{c['loss_err']:.3g}, grad norms "
                            f"{c['grad_norm_err']:.3g}" if c else ""))
                    if c:
                        check(c["grad_err"] <= PT_GRAD_TOL and
                              c["loss_err"] <= PT_LOSS_TOL and
                              c["grad_norm_err"] <= PT_LOSS_TOL,
                              f"7c {label}: the bf16 control {c} exceeds "
                              f"PT_GRAD_TOL {PT_GRAD_TOL} / PT_LOSS_TOL "
                              f"{PT_LOSS_TOL}: a limit below bf16's own "
                              f"spread")
                        metrics.setdefault("controls", {})[label] = c
        ref_file = os.path.join(tmp, "reference.pt")
        torch.save(refs, ref_file)
        del refs
        gc.collect()
        for backend, sizes, stage in (("nccl", (1, 1), 2),) + PT_WORLDS:
            world = sizes[0] * sizes[1]
            label = (f"world {world} on {backend}, mesh {sizes}, ZeRO stage "
                     f"{stage}" + (", on one card over gloo, not a "
                                   "cross-card number" if world > 1 else ""))
            need = 0
            for _l, arch, smoke, layers, _s, _y in pt_models(sizes, stage):
                cfg = pt_config(arch, smoke, layers)
                need = max(need, world * memory_reckoning(
                    cfg, TrainConfig(zero_stage=stage),
                    StackedMesh(sizes, ("data", "model")))["total"])
            check(need < have, f"7c {label}: its ranks need {need / 1e9:.1f} "
                  f"GB, more than the card's {have / 1e9:.1f}")
            t0 = time.perf_counter()
            try:
                ranks = spawn_world(pt_rank, world, backend=backend,
                                    device=None,
                                    args=(sizes, stage,
                                          ref_file if world > 1 else None),
                                    timeout_s=PT_TIMEOUT_S)
            except RuntimeError as e:
                raise SmokeFailure(f"phase 7c {label}: {e}") from None
            wall = time.perf_counter() - t0
            log(f"  {label}: {wall:.1f} s with start-up; the ranks' floor "
                f"{need / 1e9:.1f} GB; transports {ranks[0]['transports']}; "
                f"{card}")
            m = dict(backend=backend, world=world, mesh=list(sizes),
                     stage=stage, wall_s=wall, need_gb=need / 1e9,
                     transports=ranks[0]["transports"], models={})
            for mlabel, arch, smoke, layers, seq, yard in pt_models(sizes,
                                                                    stage):
                cfg = pt_config(arch, smoke, layers)
                per_step, _routes = train_launches(cfg)
                want = {k: PT_STEPS * n for k, n in per_step.items()}
                rows = []
                for r in ranks:
                    n = r["models"][mlabel]
                    where = f"7c {label} {mlabel} rank {r['coords']}"
                    check(all(np.isfinite(n["losses"])), f"{where}: losses "
                          f"{n['losses']}")
                    check(n["launches"] == want, f"{where}: launches "
                          f"{n['launches']}, planned {want}")
                    prof = n["profiled"]
                    for name, group in (("flash_attention", "flash_fwd"),
                                        ("flash_attention_bwd", "flash_bwd"),
                                        ("gmm", "gmm"), ("gmm_dx", "gmm_dx"),
                                        ("gmm_dw", "gmm_dw")):
                        check(bool(prof[group]) == bool(per_step.get(name)),
                              f"{where}: the profiled step's {group} device "
                              f"operations {prof[group]}, planned launches "
                              f"{per_step.get(name, 0)}")
                    if yard == "bitwise":
                        check(all(n["bitwise_steps"]) and n["bitwise_losses"],
                              f"{where}: not bit for bit the one-device "
                              f"step: steps {n['bitwise_steps']}, losses "
                              f"{n['bitwise_losses']}")
                    else:
                        check(n["moved"] and n["param_ratio"] <= 1.0,
                              f"{where}: parameters {n['param_ratio']:.3g} "
                              f"of their bound from the reference's "
                              f"(moved: {n['moved']})")
                        check(n["loss_err"] <= PT_LOSS_TOL and
                              n["grad_norm_err"] <= PT_LOSS_TOL,
                              f"{where}: losses {n['loss_err']:.3g}, grad "
                              f"norms {n['grad_norm_err']:.3g} from the "
                              f"reference's > {PT_LOSS_TOL}")
                        check(n["grad_err"] <= PT_GRAD_TOL,
                              f"{where}: the first step's dp-mean gradient "
                              f"{n['grad_err']:.3g} from the reference's "
                              f"at {n['grad_leaf']} > {PT_GRAD_TOL}")
                    path = (f"{mlabel} {backend} {sizes} stage {stage} "
                            f"rank {r['coords']['data']},"
                            f"{r['coords']['model']}")
                    launches[path] = n["launches"]
                    if "pod" in n:
                        t = n["pod"]
                        check(all(t["bitwise_steps"]) and t["bitwise_losses"]
                              and t.get("bitwise_grads", True),
                              f"{where}: the pod mesh {tuple(t['mesh'])} is "
                              f"not bit for bit its flat twin: steps "
                              f"{t['bitwise_steps']}, losses "
                              f"{t['bitwise_losses']}, first gradient "
                              f"{t.get('bitwise_grads')}")
                        check(t["launches"] == want, f"{where}: the pod "
                              f"mesh's launches {t['launches']}, planned "
                              f"{want}")
                        launches[path.replace(str(sizes), str(tuple(
                            t["mesh"])))] = t["launches"]
                        log(f"    {mlabel} rank {r['coords']} on the pod "
                            f"mesh {tuple(t['mesh'])}: bit for bit "
                            + ("the one-device step" if yard == "bitwise"
                               else f"the {sizes} mesh (its first gradient's "
                               "blocks too)")
                            + f" at every step, step p50 "
                            f"{t['step_p50_ms']:.1f} ms, launches "
                            f"{t['launches']}")
                    rows.append({k: v for k, v in n.items()} |
                                {"coords": r["coords"]})
                    log(f"    {mlabel} rank {r['coords']}: "
                        f"{n['params_local']:,} parameters, step p50 "
                        f"{n['step_p50_ms']:.1f} ms ({n['step_ms']}), peak "
                        f"{n['peak_gib']:.2f} GiB, losses {n['losses']}, "
                        f"launches {n['launches']}, profiled step's device "
                        f"operations {prof}" + (
                            "; bit for bit the one-device step at every "
                            f"step (its p50 {n['one_device_step_p50_ms']:.1f}"
                            " ms in the rank)" if yard == "bitwise" else
                            f"; first gradient {n['grad_err']:.3g} from the "
                            f"reference's (worst leaf {n['grad_leaf']}), "
                            f"parameters at {n['param_ratio']:.3g} of their "
                            f"bound, losses {n['loss_err']:.3g} and grad "
                            f"norms {n['grad_norm_err']:.3g} from the "
                            f"reference's"))
                m["models"][mlabel] = dict(n_layers=cfg.n_layers, seq=seq,
                                           yardstick=yard, ranks=rows,
                                           planned=want, kinds=len(
                                               layer_kinds(cfg)))
            metrics[label] = m
        t0 = time.perf_counter()
        try:
            r0, r1 = spawn_world(pt_elastic_rank, 2, backend="gloo",
                                 device=None,
                                 args=(os.path.join(tmp, "elastic"),),
                                 timeout_s=PT_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(f"phase 7c elastic: {e}") from None
        wall = time.perf_counter() - t0
        check(r0["history"] == [(2, 1), (3, 1)] and not r0["left"]
              and r1["left"] and r1["history"] == []
              and r0["meshes"] == [{"data": 2, "model": 1}] * 2
              + [{"data": 1, "model": 1}]
              and all(np.isfinite(v) for _b, v in r0["losses"]),
              f"7c elastic: rank 0 {r0['history']} {r0['meshes']} "
              f"{r0['losses']}, rank 1 {r1['history']} left {r1['left']}")
        log(f"  elastic, a world of 2 on (2, 1) whose rank 1 left without a "
            f"word at step 2: rank 0 re-formed the world alone, restored "
            f"step 1 onto (1, 1) and trained steps 2-3 "
            f"(history {r0['history']}, losses {r0['losses']}); rank 1 "
            f"left; {wall:.1f} s with start-up")
        metrics["elastic"] = dict(history=r0["history"], losses=r0["losses"],
                                  wall_s=wall, elastic_s=r0["elastic_s"])
    return metrics, launches


# ---------------------------------------------------------------------------
# phase 6: per-kernel numbers
# ---------------------------------------------------------------------------

def footprint(t):
    """Bytes of ``t``'s distinct elements: a dimension of stride 0 (a
    broadcast with ``expand``) is read once, not once per index."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def kernel_bytes(name, args, kw):
    """Least bytes the function must move on these inputs: each input read
    once and each output written once, counting only the rows this data
    needs (served rows of a gather, committed rows of a scatter), a mask at
    its own width (a bool is one byte) and a broadcast index once."""
    if name == "build_descriptors":
        tg, ix, en = args
        wire = kw.get("wire", en)
        masks = footprint(en) + (footprint(wire) if wire is not en else 0)
        return footprint(tg) + footprint(ix) + masks + tg.numel() * 32 + P * 4
    if name == "gather_rows":
        buf, idx, mask = args
        row = buf.shape[2] * buf.element_size()
        served = int((mask != 0).sum())
        return footprint(idx) + footprint(mask) + served * row \
            + idx.numel() * row + P * 4
    buf, idx, vals, apply, wire = args
    row = buf.shape[2] * buf.element_size()
    # the function returns a new buffer: read the old one, write the new
    return 2 * buf.numel() * buf.element_size() + footprint(idx) \
        + footprint(apply) + footprint(wire) \
        + int((apply != 0).sum()) * row + P * 4


def phase_report(torch, rdma, cases, errs, launches, other_paths,
                 rank_paths):
    """Rows of the three map kernels, each timed on its first phase-2 case
    (the arguments the verbs pass; ``build_descriptors`` the write verb's,
    with the read verb's in its ``read_verb`` entry): the wrapper's time,
    the device time and the device operations per call (``torch.profiler``),
    the plain version's time and the bound at the memory rate.  No one
    PyTorch call computes any of the three functions, so there is no
    library yardstick.  ``launches`` are the KVStore path's;
    ``other_paths`` ({path: launches}) are the scalar-verb phases', each
    under ``launches_<path>``; ``rank_paths`` ({path: launches}) are phase
    4f's ranks', under ``launches_paths``."""
    rows = []
    replaces = {"build_descriptors": 94, "gather_rows": 149,
                "scatter_rows": 209}

    def measure(name, args, kw):
        kern = getattr(rdma, name)
        ops = device_ops(torch, lambda: kern(*args, **kw), 50)
        nbytes = kernel_bytes(name, args, kw)
        return dict(
            launches=launches[name], max_abs_err=errs[name],
            ms=cuda_ms(lambda: kern(*args, **kw), 200),
            device_ms=device_ms(lambda: kern(*args, **kw), 200),
            # per operation, its count over the calls, rounded: a profiler run
            # may drop some device records (as device_ms allows for)
            device_ops_per_call=sum(max(1, round(n / 50))
                                    for n in ops.values()),
            plain_ms=cuda_ms(lambda: plain_call(torch, rdma, name, args, kw),
                             10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)

    for name, runs in cases.items():
        label, args, kw = runs[0]
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/csrc/remote_dma.cu",
                   replaces=f"src/repro/kernels/remote_dma.py:"
                            f"{replaces[name]}")
        row.update(measure(name, args, kw))
        row["args"] = label
        for path, counts in other_paths.items():
            row[f"launches_{path}"] = counts[name]
        row["launches_paths"] = {path: counts[name]
                                 for path, counts in rank_paths.items()}
        if name == "build_descriptors":
            row["read_verb"] = measure(name, *runs[1][1:])
            row["read_verb"]["args"] = runs[1][0]
        rows.append(row)
        for r in (row, row.get("read_verb")):
            if r is not None:
                log(f"  {name} [{r['args']}]: {r['ms']:.4f} ms/call (device "
                    f"{r['device_ms']:.5f}, {r['device_ops_per_call']} "
                    f"device ops a call), bound {r['bound_ms']:.6f} ms "
                    f"(bytes), plain {r['plain_ms']:.4f} ms, launches "
                    f"{r['launches']}")
    return rows


def attention_timings(torch, kernels, B, Hq, Hkv, D, S, window, slots, L):
    """Per-call times of both attention kernels in bf16 at one serving
    path's shapes: prefill's causal attention over B prompts of S tokens
    (over the last ``window`` keys, if any), and a decode step against
    ``slots``-slot caches holding L positions each.  The library yardstick
    is one ``scaled_dot_product_attention`` call (with a window or length
    mask where the kernel masks); the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    q, k, v = rn(B, Hq, S, D), rn(B, Hkv, S, D), rn(B, Hkv, S, D)
    fa = kernels["flash_attention"]
    visible = np.arange(1, S + 1) if window is None \
        else np.minimum(np.arange(1, S + 1), window)
    pairs = B * Hq * int(visible.sum())        # visible (query, key) pairs
    iters = 50 if S * S * D <= 2 ** 26 else 10
    if window is None:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    else:
        pos = torch.arange(S, device="cuda")
        wmask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=wmask,
                                                  enable_gqa=True)
    def kernel():
        return fa(q, k, v, causal=True, window=window)
    flash = dict(
        ms=cuda_ms(kernel, iters), device_ms=device_ms(kernel, iters),
        plain_ms=cuda_ms(lambda: ref.mha(q, k, v, causal=True,
                                         window=window), max(iters // 5, 2)),
        library_ms=cuda_ms(library, iters),
        library_device_ms=device_ms(library, iters),
        flops=4 * D * pairs, nbytes=2 * (2 * q.numel() + k.numel()
                                         + v.numel()))

    qd, kc, vc = rn(B, Hq, D), rn(B, Hkv, slots, D), rn(B, Hkv, slots, D)
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    mask = (torch.arange(slots, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    da = kernels["decode_attention"]

    def sdpa_decode():
        return F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
    decode = dict(
        ms=cuda_ms(lambda: da(qd, kc, vc, lens), 200),
        device_ms=device_ms(lambda: da(qd, kc, vc, lens), 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, vc, lens), 20),
        library_ms=cuda_ms(sdpa_decode, 200),
        library_device_ms=device_ms(sdpa_decode, 200),
        flops=4 * Hq * D * B * L,
        nbytes=2 * (2 * B * Hkv * L * D + 2 * qd.numel()) + 4 * B)
    return {"flash_attention": flash, "decode_attention": decode}


def mla_attention_timings(torch, kernels):
    """Per-call times of both attention kernels in bf16 at deepseek-v3's
    MLA shapes: the expanded prefill (4 prompts of 512 tokens, 128 heads, q
    and k 192 wide, v zero-padded from 128 to 192, as ``mla_attention``
    passes them) and the absorbed decode step (128 query heads on one kv
    head of the 576-wide latent cache, 544 slots holding 528 positions,
    scale 1/sqrt(192), the cache passed as keys and values as
    ``mla_decode`` passes it).  Bounds count what the function needs, not
    the port's padding: q and k 192 wide, v and the output 128 wide, QK
    192 and PV 128 deep for the prefill; q, the latent cache rows up to
    each length read once, the output 512 wide, QK 576 and PV 512 deep for
    the decode.  The library yardsticks are one
    ``scaled_dot_product_attention`` call each: causal over the unpadded
    128-wide v, and the decode query against the latent cache, its first
    512 columns as values, with ``enable_gqa`` and a length mask; the port
    never calls them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    B, H, S = SERVE_BATCH, DS_HEADS, SERVE_PROMPT
    scale = DS_DQK ** -0.5
    q, k = (rn(B, S, H, DS_DQK).transpose(1, 2) for _ in range(2))
    v = rn(B, S, H, DS_DV)
    vp = F.pad(v, (0, DS_DQK - DS_DV)).transpose(1, 2)
    v = v.transpose(1, 2)
    fa = kernels["flash_attention"]
    pairs = B * H * S * (S + 1) // 2

    def prefill():
        return fa(q, k, vp, causal=True, sm_scale=scale)

    def prefill_library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    flash = dict(
        ms=cuda_ms(prefill, 10), device_ms=device_ms(prefill, 10),
        plain_ms=cuda_ms(lambda: ref.mha(q, k, vp, causal=True,
                                         sm_scale=scale), 2),
        library_ms=cuda_ms(prefill_library, 10),
        library_device_ms=device_ms(prefill_library, 10),
        flops=2 * (DS_DQK + DS_DV) * pairs,
        nbytes=2 * B * H * S * (2 * DS_DQK + 2 * DS_DV))

    slots, L = SERVE_PROMPT + SERVE_GEN, SERVE_PROMPT + SERVE_GEN // 2
    qd, kc = rn(B, H, DS_DLAT), rn(B, 1, slots, DS_DLAT)
    vc = kc[..., :DS_DLAT - DS_DROPE]
    lens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    mask = (torch.arange(slots, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    da = kernels["decode_attention"]

    def step():
        return da(qd, kc, kc, lens, sm_scale=scale)

    def step_library():
        return F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True,
            scale=scale)
    decode = dict(
        ms=cuda_ms(step, 200), device_ms=device_ms(step, 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, kc, lens,
                                                      sm_scale=scale), 20),
        library_ms=cuda_ms(step_library, 200),
        library_device_ms=device_ms(step_library, 200),
        flops=2 * H * (2 * DS_DLAT - DS_DROPE) * B * L,
        nbytes=2 * (B * L * DS_DLAT + qd.numel() + B * H * vc.shape[-1])
        + 4 * B)
    return {"flash_attention": flash, "decode_attention": decode}


def cross_attention_timings(torch, kernels):
    """Per-call times of both attention kernels in bf16 at the
    cross-attention paths' shapes, inputs as the models pass them ((B, H,
    S, D) views of (B, S, H, D) projections; decode caches contiguous):
    flash ``whisper_encoder`` (4 x 20 heads of 64, 1,500 frames,
    bidirectional), flash ``vision_cross`` (4 x 32 query heads on 8, 512
    queries over 1,601 context keys, head_dim 128, non-causal) and decode
    ``whisper_cross`` (4 x 20 heads of 64 against the full 1,500-slot
    context cache).  The library yardstick is one
    ``scaled_dot_product_attention`` call on the same inputs (no mask:
    every key is visible); the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    def bhsd(B, H, S, D):
        return rn(B, S, H, D).transpose(1, 2)

    out = {}
    fa = kernels["flash_attention"]
    wh, wkv, wd, wctx = cross_shape(WHISPER_ARCH)
    vh, vkv, vd, vctx = cross_shape(VISION_ARCH)
    for key, (B, Hq, Hkv, Sq, Sk, D) in [
            ("whisper_encoder", (SERVE_BATCH, wh, wkv, wctx, wctx, wd)),
            ("vision_cross", (SERVE_BATCH, vh, vkv, SERVE_PROMPT, vctx,
                              vd))]:
        q, k, v = bhsd(B, Hq, Sq, D), bhsd(B, Hkv, Sk, D), bhsd(B, Hkv, Sk, D)

        def kernel(q=q, k=k, v=v):
            return fa(q, k, v, causal=False)

        def library(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
        out[key] = dict(
            ms=cuda_ms(kernel, 20), device_ms=device_ms(kernel, 20),
            plain_ms=cuda_ms(lambda: ref.mha(q, k, v, causal=False), 3),
            library_ms=cuda_ms(library, 20),
            library_device_ms=device_ms(library, 20),
            flops=4 * D * B * Hq * Sq * Sk,
            nbytes=2 * (2 * q.numel() + k.numel() + v.numel()))
    B, H, S, D = SERVE_BATCH, wh, wctx, wd
    qd, kc, vc = rn(B, H, D), rn(B, H, S, D), rn(B, H, S, D)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    da = kernels["decode_attention"]

    def step():
        return da(qd, kc, vc, lens)

    def step_library():
        return F.scaled_dot_product_attention(qd[:, :, None], kc, vc)
    out["whisper_cross"] = dict(
        ms=cuda_ms(step, 200), device_ms=device_ms(step, 200),
        plain_ms=cuda_ms(lambda: ref.decode_attention(qd, kc, vc, lens), 20),
        library_ms=cuda_ms(step_library, 200),
        library_device_ms=device_ms(step_library, 200),
        flops=4 * H * D * B * S,
        nbytes=2 * (kc.numel() + vc.numel() + 2 * qd.numel()) + 4 * B)
    return out


def timing_row(m, launches, err, peak):
    """The JSON line's numbers for one kernel at one set of shapes; the
    bound is the larger of bytes at the memory rate and operations at
    ``peak`` (or ``m["ops_ms"]``, for operations of more than one type)."""
    t_ops = m.get("ops_ms", m["flops"] / peak * 1e3)
    t_bytes = m["nbytes"] / HBM_BYTES_PER_S * 1e3
    row = dict(launches=launches, max_abs_err=err, ms=m["ms"],
               plain_ms=m["plain_ms"], bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops > t_bytes else "bytes",
               library_ms=m["library_ms"])
    for key in ("device_ms", "library_device_ms"):
        if key in m:
            row[key] = m[key]
    return row


def attention_report(torch, kernels, errs, launches):
    """Rows of both attention kernels at llama3.2-3b's shapes (head_dim 128:
    4 prompts of 512 tokens; a decode step mid-path, every cache holding 528
    positions of 544), each with a ``d256`` entry of the same numbers at
    recurrentgemma-2b's (head_dim 256, 10 query heads on 1 kv head: 4
    prompts of 2304 tokens under a 2048-token window; a decode step against
    the full 2048-slot ring), and an ``mla`` entry at deepseek-v3's MLA
    shapes (:func:`mla_attention_timings`); the flash row also has
    ``whisper_encoder`` and ``vision_cross`` entries and the decode row a
    ``whisper_cross`` one at the cross-attention paths' shapes
    (:func:`cross_attention_timings`).  ``ms`` and ``library_ms`` are
    wrapper times (CUDA events around a loop of calls, host work included);
    ``device_ms`` and ``library_device_ms`` the device time per call from
    ``torch.profiler``.  A row whose ``ms`` is well above its
    ``device_ms`` is host-bound.  ``launches`` maps each serving path to
    its kernels' launches: the row's are llama3.2-3b's, each entry's its
    model's, and ``launches_paths`` lists every path's."""
    d128 = attention_timings(torch, kernels, SERVE_BATCH, 24, 8, 128,
                             SERVE_PROMPT, None, SERVE_PROMPT + SERVE_GEN,
                             SERVE_PROMPT + SERVE_GEN // 2)
    d256 = attention_timings(torch, kernels, SERVE_BATCH, 10, 1, 256,
                             RG_PROMPT, 2048, 2048, 2048)
    mla = mla_attention_timings(torch, kernels)
    cross = cross_attention_timings(torch, kernels)
    entries = {"flash_attention": [("whisper_encoder", WHISPER_ARCH),
                                   ("vision_cross", VISION_ARCH)],
               "decode_attention": [("whisper_cross", WHISPER_ARCH)]}
    rows = []
    for name, line in [("flash_attention", 82), ("decode_attention", 63)]:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{name}.cu",
                   replaces=f"src/repro/kernels/{name}.py:{line}")
        row.update(timing_row(d128[name], launches[SERVE_ARCH][name],
                              errs[name], BF16_FLOPS))
        row["d256"] = timing_row(d256[name],
                                 launches["recurrentgemma-2b"][name],
                                 errs[name], BF16_FLOPS)
        row["mla"] = timing_row(mla[name], launches[DS_ARCH][name],
                                errs[name], BF16_FLOPS)
        for key, arch in entries[name]:
            row[key] = timing_row(cross[key], launches[arch][name],
                                  errs[name], BF16_FLOPS)
        row["launches_paths"] = {path: n[name] for path, n in
                                 launches.items() if name in n}
        rows.append(row)
        for label, m, r in [("D=128", d128[name], row),
                            ("D=256", d256[name], row["d256"]),
                            ("MLA", mla[name], row["mla"])] + [
                (key, cross[key], row[key]) for key, _a in entries[name]]:
            log(f"  {name} {label}: {m['ms']:.4f} ms/call (device "
                f"{m['device_ms']:.4f}), bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{m['flops'] / 1e9:.2f} GFLOP, {m['nbytes'] / 1e6:.2f} MB),"
                f" plain {m['plain_ms']:.4f} ms, sdpa {m['library_ms']:.4f} "
                f"ms (device {m['library_device_ms']:.4f}), launches "
                f"{r['launches']}")
    return rows


# row 6b's entries at the other families' training shapes: (key, arch,
# (B, Hq, Hkv, Sq, Sk, D), causal, window, v's width); deepseek-v3's MLA
# at its published width (128 heads, q.k 192, v 128 zero-padded to 192)
# at the training batch, a shape no training path of this script runs
FLASH_BWD_ENTRIES = [
    ("recurrentgemma_d256", "recurrentgemma-2b",
     (TRAIN_BATCH, 10, 1, TRAIN_SEQ, TRAIN_SEQ, 256), True, 2048, 256),
    ("mla", DS_ARCH, (TRAIN_BATCH, DS_HEADS, DS_HEADS, TRAIN_SEQ, TRAIN_SEQ,
                      DS_DQK), True, None, DS_DV),
    ("whisper_encoder", WHISPER_ARCH,
     (TRAIN_BATCH, 20, 20, 1500, 1500, 64), False, None, 64),
    ("vision_cross", VISION_ARCH,
     (TRAIN_BATCH, 32, 8, SERVE_PROMPT, 1601, 128), False, None, 128)]


def sdpa_backend(names):
    """The backend SDPA took, from the names of the device kernels one call
    ran: cuDNN's, the FlashAttention one, the memory-efficient (cutlass
    ``fmha``) one, else the math path's separate products and softmax."""
    joined = " ".join(names).lower()
    for part, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                          ("fmha", "efficient"), ("efficient", "efficient")):
        if part in joined:
            return backend
    return "math"


def plain_bwd_by_kv_heads(torch, ref, q, k, v, out, lse, dout, mask,
                          round_p=None, dtype=None, max_bytes=2 ** 31):
    """``ref.flash_attention_bwd`` over runs of kv heads (each with its G
    query heads), as many a run as keep its (B, heads, Sq, Sk) float32
    scores under ``max_bytes``, the runs' gradients concatenated: one
    call's values (a head's gradients depend on its own heads alone), at
    shapes whose one call would not fit the card (MLA's 128 heads at S
    4,096).  ``dtype`` casts the inputs first (float32: gradients in
    float32)."""
    B, Hq, Sq = q.shape[:3]
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    per = max(1, max_bytes // (4 * B * G * Sq * Sk))
    parts = []
    for h0 in range(0, Hkv, per):
        kv, qh = slice(h0, min(Hkv, h0 + per)), slice(
            h0 * G, min(Hkv, h0 + per) * G)
        ins = [q[:, qh], k[:, kv], v[:, kv], out[:, qh], dout[:, qh]]
        if dtype is not None:
            ins = [t.to(dtype) for t in ins]
        parts.append(ref.flash_attention_bwd(
            *ins[:4], lse[:, qh], ins[4], **mask, round_p=round_p))
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(t, dim=1) for t in zip(*parts))


def flash_bwd_entry(torch, g, shape, causal, window, width):
    """Row 6b's numbers at one training shape in bf16: q, k, v and dout (B,
    H, S, D) views of (B, S, H, D) memory (v's and dout's columns from
    ``width`` on zeros, as MLA pads v), out and lse from the forward
    kernel; the backward kernel's wrapper and device time, its route, its
    largest error against the plain version (rounding P and dS to bf16 as
    the tensor-core routes do, and unrounded; relative to the plain
    gradient's max, floor as in phase 2b), the padded columns' gradient
    zero, and the plain version's time; the bound's operations (10 * D
    FLOP a visible (query, key) pair a head) and bytes (as the
    training-shape row counts them); and ``torch.autograd.grad`` through
    one ``scaled_dot_product_attention`` output with the same mask (v
    unpadded), with the backend it took."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, Hq, Hkv, Sq, Sk, D = shape

    def bhsd(H, S, w=D):
        t = torch.randn((B, S, H, w), generator=g, device="cuda").to(
            torch.bfloat16)
        return F.pad(t, (0, D - w)).transpose(1, 2)

    q, k = bhsd(Hq, Sq), bhsd(Hkv, Sk)
    v, dout = bhsd(Hkv, Sk, width), bhsd(Hq, Sq, width)
    scale = D ** -0.5
    out, lse = fa._forward(q, k, v, causal, window, scale, Sk - Sq, True)
    mask = dict(causal=causal, window=window, sm_scale=scale,
                offset=Sk - Sq)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, **mask)

    routes = dict(fa.flash_attention_bwd.routes)
    got = kernel()
    route = [r for r, n in fa.flash_attention_bwd.routes.items()
             if n != routes[r]]
    check(len(route) == 1, f"flash_attention_bwd at {shape}: routes "
          f"{routes} -> {fa.flash_attention_bwd.routes}")
    floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
    check(width == D or not got[2][..., width:].any(), f"flash_attention_bwd"
          f" at {shape}: the padded v columns got a gradient")
    err = 0.0
    for round_p in ((torch.bfloat16, None) if route[0] != "simt"
                    else (None,)):
        exp = plain_bwd_by_kv_heads(torch, ref, q, k, v, out, lse, dout,
                                    mask, round_p, torch.float32)
        for name, a, b in zip(("dq", "dk", "dv"), got, exp):
            e = bwd_rel_err(a, b, floor)
            check(e <= ATTN_TOL["bfloat16"], f"flash_attention_bwd at "
                  f"{shape}: {name} differs from its plain version "
                  f"(round_p {round_p}): {e} > {ATTN_TOL['bfloat16']}")
            err = max(err, e)
        del exp
    del got
    pos_q = torch.arange(Sq, device="cuda")[:, None] + (Sk - Sq)
    pos_k = torch.arange(Sk, device="cuda")[None, :]
    attn_mask = None
    if causal:
        attn_mask = pos_k <= pos_q
        if window is not None:
            attn_mask &= pos_k > pos_q - window
    visible = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda") \
        if attn_mask is None else attn_mask
    pairs = B * Hq * int(visible.sum())
    # a plain causal mask goes to SDPA as is_causal (its fastest backends)
    sdpa_mask = dict(attn_mask=attn_mask)
    if causal and window is None and Sq == Sk:
        sdpa_mask = dict(is_causal=True)
    del visible, attn_mask
    qg, kg, vg = (t.detach().requires_grad_(True)
                  for t in (q, k, v[..., :width]))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa_mask,
                                             enable_gqa=True, scale=scale)

    def library():
        return torch.autograd.grad(lib_out, (qg, kg, vg),
                                   dout[..., :width], retain_graph=True)
    m = dict(ms=cuda_ms(kernel, 5), device_ms=device_ms(kernel, 5),
             plain_ms=cuda_ms(lambda: plain_bwd_by_kv_heads(
                 torch, ref, q, k, v, out, lse, dout, mask), 1),
             library_ms=cuda_ms(library, 5),
             library_device_ms=device_ms(library, 5),
             sdpa_backend=sdpa_backend(device_ops(torch, library, 3)),
             # S, dQ and dK at D; dP and dV at v's width
             flops=2 * pairs * (3 * D + 2 * width),
             nbytes=2 * (3 * q.numel() + 2 * out.numel() + 2 * k.numel()
                         + 2 * v.numel()) + 4 * lse.numel(),
             route=route[0], err=err)
    del q, k, v, dout, out, lse, qg, kg, vg, lib_out
    torch.cuda.empty_cache()
    return m


def flash_bwd_report(torch, errs, launches, wgmma_launches):
    """The backward kernel's row at llama3.2-3b's training shape (B
    TRAIN_BATCH, 24 query heads on 8 kv heads, S TRAIN_SEQ, D 128, bf16,
    causal; q, k, v and dout (B, H, S, D) views of (B, S, H, D) memory, out
    and lse from the forward kernel).  Bound: the five products of the
    backward over the visible half, 10 * D FLOP a visible (query, key) pair
    a head at the bf16 tensor-core peak, against each input read once and
    each gradient written once.  The library yardstick is
    ``torch.autograd.grad`` through one ``scaled_dot_product_attention``
    output (causal, GQA); the port never calls it.  ``variant`` is the
    route the calls took (``flash_attention_bwd.routes``).  One call is
    first held against the plain version that rounds P and dS to bf16 and
    the unrounded one (``ATTN_TOL``, relative to the plain gradient's max,
    floor as in phase 2b): ``max_abs_err`` is that error,
    ``cases_max_rel_err`` phase 2b's largest.  The entries of
    ``FLASH_BWD_ENTRIES`` (:func:`flash_bwd_entry`) are the same numbers at
    recurrentgemma-2b's training shape (D 256 under a 2,048-token window),
    deepseek-v3's MLA (D 192, v 128 zero-padded; no path here trains it),
    whisper's encoder and the vision cross layers', each with its route,
    SDPA's backend and its family's launches.  A second row,
    ``flash_attention_bwd_wgmma``, is the ``"wgmma"`` route's kernels
    (``csrc/flash_attention_bwd_sm90.cu``) at recurrentgemma-2b's shape,
    with the MLA entry; its launches are the calls each training path
    made on that route (``wgmma_launches``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    B, Hq, Hkv, S, D = TRAIN_BATCH, 24, 8, TRAIN_SEQ, 128

    def bhsd(H):
        return torch.randn((B, S, H, D), generator=g, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    q, k, v, dout = bhsd(Hq), bhsd(Hkv), bhsd(Hkv), bhsd(Hq)
    out, lse = fa._forward(q, k, v, True, None, D ** -0.5, 0, True)

    def kernel():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)

    def library():
        return torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                   retain_graph=True)
    pairs = B * Hq * S * (S + 1) // 2
    routes = dict(fa.flash_attention_bwd.routes)
    got = kernel()
    floor = 1e-2 * float(dout.abs().max()) * float(v.abs().max())
    err = 0.0
    for round_p in (torch.bfloat16, None):
        exp = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=True, round_p=round_p)
        for name, a, b in zip(("dq", "dk", "dv"), got, exp):
            e = bwd_rel_err(a, b, floor)
            check(e <= ATTN_TOL["bfloat16"], f"flash_attention_bwd at the "
                  f"training shape: {name} differs from its plain version "
                  f"(round_p {round_p}): {e} > {ATTN_TOL['bfloat16']}")
            err = max(err, e)
        del exp
    del got
    m = dict(ms=cuda_ms(kernel, 5), device_ms=device_ms(kernel, 5),
             plain_ms=cuda_ms(lambda: ref.flash_attention_bwd(
                 q, k, v, out, lse, dout, causal=True,
                 round_p=torch.bfloat16), 1),
             library_ms=cuda_ms(library, 5),
             library_device_ms=device_ms(library, 5),
             flops=10 * D * pairs,
             nbytes=2 * (3 * q.numel() + 2 * out.numel() + 2 * k.numel()
                         + 2 * v.numel()) + 4 * lse.numel())
    variant = [r for r, n in fa.flash_attention_bwd.routes.items()
               if n != routes[r]]
    check(variant == ["mma"], f"flash_attention_bwd at the training shape "
          f"ran on {variant}, not the tensor cores")
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               replaces="src/repro/models/flash_xla.py:112",
               variant=variant[0])
    row.update(timing_row(m, launches[f"{TRAIN_ARCH} train"], err,
                          BF16_FLOPS))
    row["cases_max_rel_err"] = errs["grad"]
    row["launches_paths"] = launches
    row["device_ops_per_call"] = errs["device_ops_per_call"]
    row["lse_max_rel_err"] = errs["lse"]
    del q, k, v, dout, out, lse, qg, kg, vg, lib_out
    torch.cuda.empty_cache()
    for key, arch, shape, causal, window, width in FLASH_BWD_ENTRIES:
        e = flash_bwd_entry(torch, g, shape, causal, window, width)
        entry = row[key] = timing_row(e, launches.get(f"{arch} train", 0),
                                      e["err"], BF16_FLOPS)
        entry.update(variant=e["route"], sdpa_backend=e["sdpa_backend"],
                     shape=list(shape), window=window, v_width=width)
        log(f"  flash_attention_bwd {key} {shape} ({e['route']}): "
            f"{e['ms']:.4f} ms/call (device {e['device_ms']:.4f}), bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
            f"{e['flops'] / 1e9:.1f} GFLOP, {e['nbytes'] / 1e6:.1f} MB), "
            f"plain {e['plain_ms']:.4f} ms, sdpa backward "
            f"{e['library_ms']:.4f} ms (device {e['library_device_ms']:.4f}, "
            f"{e['sdpa_backend']}), err {e['err']:.3g}, launches "
            f"{entry['launches']}")
    log(f"  flash_attention_bwd train shape ({variant[0]}): dq/dk/dv err "
        f"{err:.3g} of the plain max, rounded and unrounded (tolerance "
        f"{ATTN_TOL['bfloat16']}); {m['ms']:.4f} ms/call (device "
        f"{m['device_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}; {m['flops'] / 1e9:.1f} GFLOP, "
        f"{m['nbytes'] / 1e6:.1f} MB), plain {m['plain_ms']:.4f} ms, sdpa "
        f"backward {m['library_ms']:.4f} ms (device "
        f"{m['library_device_ms']:.4f}), launches {launches}")
    for key in ("recurrentgemma_d256", "mla"):
        check(row[key]["variant"] == "wgmma", f"flash_attention_bwd {key} "
              f"ran on {row[key]['variant']}, not the wgmma route")
    n = wgmma_launches.get("recurrentgemma-2b train", 0)
    check(n > 0, "the wgmma flash backward was not launched on "
                 "recurrentgemma-2b's training path")
    wrow = dict(name="flash_attention_bwd_wgmma", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "flash_attention_bwd_sm90.cu",
                replaces="src/repro/models/flash_xla.py:112",
                variant="wgmma", shape=row["recurrentgemma_d256"]["shape"],
                window=2048)
    wrow.update({k: v for k, v in row["recurrentgemma_d256"].items()
                 if k not in ("variant", "shape", "window", "v_width")})
    wrow.update(launches=n, launches_paths=wgmma_launches, mla=row["mla"],
                device_ops_per_call={
                    k: v for k, v in errs["device_ops_per_call"].items()
                    if k.startswith("wgmma")})
    return [row, wrow]


def wkv6_ops(B, H, S, D):
    """(tensor-core, CUDA-core) operations of the chunked WKV6 form on these
    shapes, per chunk of 16 steps and head: the read-out (r ⊙ P)ᵀ S0 and
    the update (k ⊙ Q) vᵀ, 2·16·D² each, and A·V, 2·16²·D, on the tensor
    cores; the scores A in float32, 3 operations (r·k, the product with
    the decays, the next decay) per channel for each of the 120 pairs s < t
    and 16 diagonal ones, and the decay products P and Q, 2 per step and
    channel, on the CUDA cores."""
    chunks = B * H * -(-S // 16)
    return (chunks * (4 * 16 * D * D + 2 * 16 * 16 * D),
            chunks * (3 * 136 * D + 2 * 16 * D))


def recurrent_report(torch, kernels, errs, launches, train):
    """Rows of the RG-LRU and WKV6 kernels at their serving paths' shapes in
    bf16: recurrentgemma-2b's scan over 4 prompts of 2304 tokens and 2560
    channels, rwkv6-7b's WKV over 4 prompts of 512 tokens and 64 heads of
    64 (inputs as (B, H, S, D) views of (B, S, H, D) projections).  The
    RG-LRU's operations are elementwise, on the CUDA cores: eight float32
    ones an element (the gate's difference and square root, the update,
    the run's product, the fold) at the float32 peak, and a float64
    exponential (``EXP64_OPS``) at the float64 peak.  WKV6's bound is the
    least of the two forms
    the card could run: its bytes against the chunked form's operations
    (:func:`wkv6_ops`, tensor-core ones at the bf16 peak plus CUDA-core
    ones at the float32 peak); ``bound_sequential_ms`` beside it is the
    sequential form's 5·D² + 5·D operations per step and head (the
    read-out r·S, the update w·S + k·vᵀ, the bonus) at the float32 peak,
    the bound of the CUDA-core kernel.  Both rows also carry the device
    operations a call (``torch.profiler``).  WKV6's ``train_form`` entry
    is the float32 training form (``WKV6Train``'s forward: the sequential
    CUDA-core kernel) at rwkv6-7b's training shape (B TRAIN_BATCH, 64
    heads of 64, S TRAIN_SEQ, (B, H, S, D) views of (B, S, H, D) memory),
    with the training path's launches (``train``): its bound the larger of
    its bytes (r, k, v, w and u read, y and the final state written, in
    float32) and the sequential form's operations at the float32 peak.
    No PyTorch call computes either recurrence, so there is no library
    yardstick."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    B, S, D = SERVE_BATCH, RG_PROMPT, 2560
    x = rn(B, S, D).to(torch.bfloat16)
    la = (-0.106 * torch.rand((B, S, D), generator=g, device="cuda")).to(
        torch.bfloat16)
    rg = kernels["rglru_scan"]
    m_rg = dict(ms=cuda_ms(lambda: rg(x, la), 50),
                device_ms=device_ms(lambda: rg(x, la), 20),
                ops=device_ops(torch, lambda: rg(x, la), 20),
                plain_ms=cuda_ms(lambda: ref.rglru(x, la), 2),
                library_ms=None, flops=8 * x.numel(),
                ops_ms=(8 / F32_FLOPS + EXP64_OPS / F64_FLOPS) * x.numel()
                * 1e3,
                nbytes=3 * 2 * x.numel() + 4 * B * D)

    B, H, S, D = SERVE_BATCH, 64, SERVE_PROMPT, 64
    r, k, v = (rn(B, S, H, D).to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * rn(B, S, H, D))).to(
        torch.bfloat16).transpose(1, 2)
    u = (0.1 * rn(H, D)).to(torch.bfloat16)
    wk = kernels["wkv6"]
    tc, cc = wkv6_ops(B, H, S, D)
    m_wk = dict(ms=cuda_ms(lambda: wk(r, k, v, w, u), 50),
                device_ms=device_ms(lambda: wk(r, k, v, w, u), 20),
                ops=device_ops(torch, lambda: wk(r, k, v, w, u), 20),
                plain_ms=cuda_ms(lambda: ref.wkv6(r, k, v, w, u), 2),
                library_ms=None, flops=tc + cc,
                ops_ms=(tc / BF16_FLOPS + cc / F32_FLOPS) * 1e3,
                nbytes=5 * 2 * r.numel() + 2 * u.numel() + 4 * B * H * D * D)
    seq_ms = B * H * S * (5 * D * D + 5 * D) / F32_FLOPS * 1e3
    del r, k, v, w, u
    B, S = TRAIN_BATCH, TRAIN_SEQ
    r, k, v = (rn(B, S, H, D).transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * rn(B, S, H, D))).transpose(1, 2)
    u = 0.1 * rn(H, D)
    before = dict(wk.routes)
    wk(r, k, v, w, u)
    check(wk.routes["simt"] == before["simt"] + 1,
          "the float32 WKV training form did not take the sequential "
          "kernel")
    m_tf = dict(ms=cuda_ms(lambda: wk(r, k, v, w, u), 5),
                device_ms=device_ms(lambda: wk(r, k, v, w, u), 5),
                ops=device_ops(torch, lambda: wk(r, k, v, w, u), 5),
                plain_ms=cuda_ms(lambda: ref.wkv6(r, k, v, w, u), 1),
                library_ms=None, flops=B * H * S * (5 * D * D + 5 * D),
                nbytes=4 * (5 * r.numel() + u.numel() + B * H * D * D))
    del r, k, v, w, u
    rows = []
    for name, m, arch, line in [
            ("rglru_scan", m_rg, "recurrentgemma-2b", 46),
            ("wkv6", m_wk, "rwkv6-7b", 55)]:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{name}.cu",
                   replaces=f"src/repro/kernels/{name}.py:{line}")
        row.update(timing_row(m, launches[arch][name], errs[name],
                              F32_FLOPS))
        row["device_ops_per_call"] = sum(max(1, round(n / 20))
                                         for n in m["ops"].values())
        row["launches_paths"] = {path: n[name] for path, n in
                                 launches.items() if n.get(name)}
        extra = ""
        if name == "wkv6":
            n_train = train["rwkv6-7b"]["wkv6"]
            tf = row["train_form"] = timing_row(m_tf, n_train, errs[name],
                                                F32_FLOPS)
            tf["device_ops_per_call"] = sum(max(1, round(n / 5))
                                            for n in m_tf["ops"].values())
            log(f"  wkv6 train_form (float32, sequential kernel, B "
                f"{TRAIN_BATCH} H 64 S {TRAIN_SEQ} D 64): "
                f"{m_tf['ms']:.4f} ms/call (device {m_tf['device_ms']:.4f}, "
                f"{tf['device_ops_per_call']} device ops a call), bound "
                f"{tf['bound_ms']:.4f} ms ({tf['bound_by']}; "
                f"{m_tf['flops'] / 1e9:.2f} GFLOP, "
                f"{m_tf['nbytes'] / 1e9:.3f} GB), plain "
                f"{m_tf['plain_ms']:.4f} ms, launches {n_train} on the "
                f"rwkv6-7b training path")
            row["bound_sequential_ms"] = seq_ms
            extra = (f"; sequential form {seq_ms:.4f} ms (operations); "
                     f"chunked {tc / 1e9:.2f} GFLOP on tensor cores, "
                     f"{cc / 1e9:.3f} on CUDA cores")
        rows.append(row)
        log(f"  {name}: {m['ms']:.4f} ms/call (device "
            f"{m['device_ms']:.4f}, {row['device_ops_per_call']} device "
            f"ops a call: {m['ops']}), bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']}; {m['flops'] / 1e9:.2f} GFLOP, "
            f"{m['nbytes'] / 1e6:.2f} MB{extra}), plain "
            f"{m['plain_ms']:.4f} ms, library none, launches "
            f"{row['launches']}")
    return rows


def recurrent_bwd_report(torch, errs, launches):
    """Rows of the two backward kernels at their training paths' shapes:
    ``rglru_scan_bwd`` at recurrentgemma-2b's (B TRAIN_BATCH, S TRAIN_SEQ,
    2,560 channels, bf16, dh_final None as the model leaves it, on the
    tile states the forward kernel kept), bound by its bytes (x, log_a, dy
    and the tile states read once, dx and dlog_a written once) and its
    operations: 23 float32 ones an element (the tile aggregates' scan, the
    runs forward and back twice, the gate's difference and square root,
    a²x/b, dx and dlog_a) and two float64 exponentials (one in each
    kernel, ``EXP64_OPS`` each) at the float64 rate; ``wkv6_bwd`` at
    rwkv6-7b's (B TRAIN_BATCH, 64 heads of 64, S TRAIN_SEQ, float32, inputs
    (B, H, S, D) views of (B, S, H, D) memory), bound by its bytes (r, k,
    v, w, dy and u read, the five gradients written) and its 12·D²
    float32 operations a step and head (the updates of S and G and the
    four products dr, dk, dv, dw).  No PyTorch call computes either
    backward, so there is no library yardstick.  ``launches`` is the
    kernel's count on its training path; ``max_abs_err`` phase 2c's
    largest."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6_bwd
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    B, S, D = TRAIN_BATCH, TRAIN_SEQ, 2560
    x, dy = (rn(B, S, D).to(torch.bfloat16) for _ in range(2))
    la = (-0.106 * torch.rand((B, S, D), generator=g, device="cuda")).to(
        torch.bfloat16)

    rg, carries = rglru_bwd_call(torch, (x, la, dy, None))
    m_rg = dict(ms=cuda_ms(rg, 20), device_ms=device_ms(rg, 10),
                ops=device_ops(torch, rg, 10),
                plain_ms=cuda_ms(lambda: ref.rglru_bwd(x, la, dy), 1),
                library_ms=None, flops=23 * x.numel(),
                ops_ms=(23 / F32_FLOPS + 2 * EXP64_OPS / F64_FLOPS)
                * x.numel() * 1e3,
                nbytes=5 * 2 * x.numel() + 4 * carries.numel())
    del x, dy, la, carries, rg

    H, D = 64, 64

    def bhsd():
        return rn(B, S, H, D).transpose(1, 2)
    r, k, v, dy = (bhsd() for _ in range(4))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * bhsd()))
    u = 0.1 * rn(H, D)

    def wk():
        return wkv6_bwd(r, k, v, w, u, dy)
    m_wk = dict(ms=cuda_ms(wk, 5), device_ms=device_ms(wk, 5),
                ops=device_ops(torch, wk, 5),
                plain_ms=cuda_ms(lambda: ref.wkv6_bwd(r, k, v, w, u, dy), 1),
                library_ms=None, flops=12 * B * H * S * D * D,
                nbytes=4 * (9 * r.numel() + 2 * u.numel()))
    rows = []
    for name, m, arch, replaces, n_ops in [
            ("rglru_scan_bwd", m_rg, "recurrentgemma-2b",
             "src/repro/kernels/ref.py:83", 10),
            ("wkv6_bwd", m_wk, "rwkv6-7b", "src/repro/models/rwkv6.py:233",
             5)]:
        source = "rglru_scan.cu" if name == "rglru_scan_bwd" else \
            "wkv6_bwd.cu"
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{source}",
                   replaces=replaces)
        row.update(timing_row(m, launches[arch][name], errs[name],
                              F32_FLOPS))
        row["device_ops_per_call"] = sum(max(1, round(n / n_ops))
                                         for n in m["ops"].values())
        row["launches_paths"] = {f"{arch} train": launches[arch][name]}
        rows.append(row)
        log(f"  {name}: {m['ms']:.4f} ms/call (device "
            f"{m['device_ms']:.4f}, {row['device_ops_per_call']} device "
            f"ops a call: {m['ops']}), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; {m['flops'] / 1e9:.2f} GFLOP, "
            f"{m['nbytes'] / 1e6:.2f} MB), plain {m['plain_ms']:.4f} ms, "
            f"library none, launches {row['launches']}")
    return rows


def gmm_report(torch, kernels, err, launches, a2a):
    """The grouped matmul's row at llama4-maverick's gate/up product in
    bf16: 128 experts of 5120 x 8192, block i of the slot rows on expert i.
    The row is the prefill shape (24 slots per expert, every row counted:
    each call reads every expert's weights once, 10.7 GB); its ``decode``
    entry is a decode step as the model makes it (8 slots per expert, the
    step's 4 tokens on 4 experts, one row each, the other slot rows zero and
    past their counts), bound by the bytes of the 4 experts' weights, the
    whole output and the live x rows; its ``decode_full`` entry is the
    decode shape with every row counted, as this row's earlier decode
    entry was timed.  Operations are counted at the bf16 tensor-core peak.
    The library yardstick is one ``torch.bmm`` of the (E, C, 5120) slots by
    the (E, 5120, 8192) weights — the same function when block i takes
    expert i and the rows past the counts are zeros; it reads every expert.
    The port never calls it.  The ``deepseek_prefill`` and
    ``deepseek_decode`` entries are the same numbers at deepseek-v3's gate
    product (256 experts of 7168 x 2048; prefill: 80 slots each, every row
    counted; decode: 8 slots each, the step's 4 tokens on 8 experts each),
    with deepseek-v3's launches.  The ``llama4_a2a`` and ``deepseek_a2a``
    entries (and ``*_a2a_prefill``) are phase 5b's (``a2a``: each arch's
    :func:`gmm_entry` numbers at the expert-parallel path's gate product, a
    block of 8 x C rows an expert, each expert's rows compacted to its
    front), with that path's launches; ``*_local_decode`` the local path's
    decode call on the same state.  ``launches_paths`` lists every serving
    path's launches and every training path's (``… train``: phase 7's and
    each phase-7c rank's)."""
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    kern = kernels["gmm"]
    m = {}
    for arch, E, D, F, phases in (
            (MOE_ARCH, MOE_E, MOE_D, MOE_F,
             (("prefill", MOE_C_PREFILL, None),
              ("decode", MOE_C_DECODE, "model decode"),
              ("decode_full", MOE_C_DECODE, None))),
            (DS_ARCH, DS_E, DS_D, DS_F,
             (("deepseek_prefill", DS_C_PREFILL, None),
              ("deepseek_decode", DS_C_DECODE, "top-8 decode")))):
        w = torch.randn((E, D, F), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(D ** -0.5)
        be = torch.arange(E, dtype=torch.int32, device="cuda")
        for phase, c, kind in phases:
            T = E * c
            x = torch.randn((T, D), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            counts = gmm_counts(torch, g, kind, E, E, c)
            if counts is None:
                rows, experts = T, E
            else:              # zeros past the counts, as dispatch leaves x
                live = torch.arange(c, device="cuda")[None, :] \
                    < counts[:, None]
                x.mul_(live.reshape(-1, 1))
                rows = int(counts.sum())
                experts = int((counts > 0).sum())
            xe = x.view(E, c, D)

            def kernel():
                return kern(x, w, be, c, counts)
            m[phase] = dict(
                ms=cuda_ms(kernel, 20), device_ms=device_ms(kernel, 20),
                plain_ms=cuda_ms(lambda: ref.gmm(x, w, be, c, counts), 2),
                library_ms=cuda_ms(lambda: torch.bmm(xe, w), 20),
                flops=2 * rows * D * F,
                nbytes=2 * (rows * D + experts * D * F + T * F)
                + 4 * E * (1 + (counts is not None)),
                experts=experts, launches=launches[arch]["gmm"])
        del w
        torch.cuda.empty_cache()
    row = dict(name="gmm", route="cuda",
               source="src/repro_torch/kernels/csrc/moe_gmm.cu",
               replaces="src/repro/kernels/moe_gmm.py:37")
    row.update(timing_row(m["prefill"], m["prefill"]["launches"], err,
                          BF16_FLOPS))
    subs = ("decode", "decode_full", "deepseek_prefill", "deepseek_decode")
    for phase in subs:
        row[phase] = timing_row(m[phase], m[phase]["launches"], err,
                                BF16_FLOPS)
    for arch, tag in ((MOE_ARCH, "llama4"), (DS_ARCH, "deepseek")):
        for what, suffix in (("decode", "_a2a"), ("prefill", "_a2a_prefill"),
                             ("local_decode", "_local_decode")):
            t = a2a[arch][what]
            row[tag + suffix] = timing_row(t, t["launches"], err, BF16_FLOPS)
            r = row[tag + suffix]
            log(f"  gmm {tag}{suffix}: {t['ms']:.4f} ms/call (device "
                f"{t['device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {t['experts']} experts read, "
                f"{t['rows']} rows, {t['nbytes'] / 1e9:.3f} GB), plain "
                f"{t['plain_ms']:.4f} ms, bmm {t['library_ms']:.4f} ms, "
                f"launches {t['launches']}")
    row["launches_paths"] = {path: n["gmm"] for path, n in launches.items()
                             if "gmm" in n}
    for phase, r in (("prefill", row),) + tuple((p, row[p]) for p in subs):
        mm = m[phase]
        log(f"  gmm {phase}: {mm['ms']:.4f} ms/call (device "
            f"{mm['device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {mm['experts']} experts read, "
            f"{mm['flops'] / 1e9:.2f} GFLOP, {mm['nbytes'] / 1e9:.3f} GB), "
            f"plain {mm['plain_ms']:.4f} ms, bmm {mm['library_ms']:.4f} ms, "
            f"launches {mm['launches']}")
    return [row]


def gmm_bwd_report(torch, errs, launches):
    """Row 9b, the grouped matmul's backward: ``gmm_dx`` and ``gmm_dw`` at
    llama4-maverick's gate/up product at phase 7's batch (128 experts of
    5120 x 8192, 80 slots each, the counts of a top-1 dispatch of
    TRAIN_BATCH x TRAIN_SEQ tokens on experts drawn uniformly; x and dy
    zero past the counts, as the block leaves them), each with a
    ``deepseek`` entry at deepseek-v3's (256 of 7168 x 2048, 320 slots,
    top-8), in bf16 (the tensor-core route).  Bound: bytes (dx: the live
    experts' weights, the counted dy rows, every dx row written, the index
    vectors; dw: the counted x and dy rows, every expert's gradient
    written) against operations (2 · counted rows · Din · Dout at the bf16
    tensor-core peak), the larger.  The library yardstick is one
    ``torch.bmm`` over the (E, C, ·) slots, every slot and expert read:
    dy by wᵀ for dx, xᵀ by dy for dw; the port never calls it.
    ``launches`` is the kernel's count on the MoE smoke training path;
    ``launches_paths`` every training path's and the full-width blocks';
    ``max_abs_err`` phase 2b's largest."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    m = {"gmm_dx": {}, "gmm_dw": {}}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for tag, E, D, F, C, k in (
            ("llama4", MOE_E, MOE_D, MOE_F, MOE_C_TRAIN, 1),
            ("deepseek", DS_E, DS_D, DS_F, DS_C_TRAIN, DS_K)):
        w = torch.randn((E, D, F), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(D ** -0.5)
        wt = w.transpose(1, 2)
        be = torch.arange(E, dtype=torch.int32, device="cuda")
        counts = dispatch_counts(torch, g, E, C, tokens, k, edges=False)
        T = E * C
        live = (torch.arange(C, device="cuda")[None, :]
                < counts[:, None]).reshape(-1, 1)
        x = torch.randn((T, D), generator=g, device="cuda",
                        dtype=torch.bfloat16).mul_(live)
        dy = torch.randn((T, F), generator=g, device="cuda",
                         dtype=torch.bfloat16).mul_(live)
        xe, dye = x.view(E, C, D), dy.view(E, C, F)
        rows, experts = int(counts.sum()), int((counts > 0).sum())

        def dx():
            return moe_gmm.gmm_dx(dy, w, be, C, counts)

        def dw():
            return moe_gmm.gmm_dw(x, dy, be, C, counts, E)
        m["gmm_dx"][tag] = dict(
            ms=cuda_ms(dx, 10), device_ms=device_ms(dx, 10),
            ops=device_ops(torch, dx, 5),
            plain_ms=cuda_ms(lambda: ref.gmm(dy, wt, be, C, counts), 1),
            library_ms=cuda_ms(lambda: torch.bmm(dye, wt), 10),
            flops=2 * rows * D * F,
            nbytes=2 * (experts * D * F + rows * F + T * D) + 8 * E,
            experts=experts, rows=rows)
        m["gmm_dw"][tag] = dict(
            ms=cuda_ms(dw, 10), device_ms=device_ms(dw, 10),
            ops=device_ops(torch, dw, 5),
            plain_ms=cuda_ms(lambda: ref.gmm_dw(x, dy, be, C, counts, E), 1),
            library_ms=cuda_ms(lambda: torch.bmm(xe.transpose(1, 2), dye),
                               10),
            flops=2 * rows * D * F,
            nbytes=2 * (rows * (D + F) + E * D * F) + 8 * E,
            experts=experts, rows=rows)
        del w, wt, x, dy, xe, dye
        gc.collect()
        torch.cuda.empty_cache()
    main = f"{MOE_ARCH} smoke"
    rows_out = []
    for name, source in (("gmm_dx", "moe_gmm_dx.cu"),
                         ("gmm_dw", "moe_gmm_dw.cu")):
        mm = m[name]
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{source}",
                   replaces="src/repro/models/moe.py:95")
        row.update(timing_row(mm["llama4"], launches[main][name],
                              errs[name], BF16_FLOPS))
        row["deepseek"] = timing_row(mm["deepseek"], launches[main][name],
                                     errs[name], BF16_FLOPS)
        for r, t in ((row, mm["llama4"]), (row["deepseek"], mm["deepseek"])):
            r["device_ops_per_call"] = sum(max(1, round(n / 5))
                                           for n in t["ops"].values())
        row["launches_paths"] = {f"{path} train": n[name]
                                 for path, n in launches.items()
                                 if name in n}
        rows_out.append(row)
        for tag, r in (("llama4", row), ("deepseek", row["deepseek"])):
            t = mm[tag]
            log(f"  {name} {tag}: {t['ms']:.4f} ms/call (device "
                f"{t['device_ms']:.4f}, {r['device_ops_per_call']} device "
                f"ops a call), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {t['experts']} experts, {t['rows']} "
                f"rows, {t['flops'] / 1e12:.3f} TFLOP, "
                f"{t['nbytes'] / 1e9:.3f} GB), plain {t['plain_ms']:.4f} "
                f"ms, bmm {t['library_ms']:.4f} ms, launches "
                f"{row['launches_paths']}")
    return rows_out


def copy_report(torch, rdma, cases, errs, launches):
    """remote_copy's row: at the failover phase's hop (P = 8, a 20,480-word
    entry packed with its metadata into 20,488 words), with a ``serving``
    entry at the replicated engine's (P = 4, 648 words), each a broadcast
    from one owner.  Bound: :func:`copy_nbytes` of the timed sender map
    ((P + 2)·n·4 bytes for a broadcast, plus the map and the counters) at
    the memory rate; max_abs_err is phase 2's at the same case.  The
    library yardstick is ``src.index_select(0, sender.clamp(min=0))``, one
    PyTorch call that moves the same rows; the port never calls it.
    ``launches`` maps each path to the kernel's launches there."""
    m = {}
    for label, src, dst, sender in cases[:2]:
        n_rows, n = src.shape
        m[n_rows] = dict(
            ms=cuda_ms(lambda: rdma.remote_copy(src, dst, sender), 200),
            device_ms=device_ms(lambda: rdma.remote_copy(src, dst, sender),
                                200),
            plain_ms=cuda_ms(lambda: rdma._remote_copy_ref(src, dst, sender),
                             50),
            library_ms=cuda_ms(lambda: src.index_select(
                0, sender.clamp(min=0)), 200),
            nbytes=copy_nbytes(sender, n), flops=0, err=errs[label],
            shape=label)
    row = dict(name="remote_copy", route="cuda",
               source="src/repro_torch/kernels/csrc/remote_copy.cu",
               replaces="src/repro/kernels/remote_dma.py:239")
    row.update(timing_row(m[8], launches["failover"], m[8]["err"],
                          F32_FLOPS))
    row["serving"] = timing_row(m[4], launches["serving"], m[4]["err"],
                                F32_FLOPS)
    for n_rows, r in ((8, row), (4, row["serving"])):
        mm = m[n_rows]
        log(f"  remote_copy {mm['shape']}: {mm['ms']:.4f} ms/call (device "
            f"{mm['device_ms']:.5f}), bound "
            f"{r['bound_ms']:.6f} ms (bytes; {mm['nbytes'] / 1e3:.1f} KB), "
            f"plain {mm['plain_ms']:.4f} ms, index_select "
            f"{mm['library_ms']:.4f} ms, launches {r['launches']}")
    return [row]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import repro_torch.core as pt
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels import remote_dma as rdma
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.wkv6 import wkv6
    model_kernels = {"flash_attention": flash_attention,
                     "decode_attention": decode_attention,
                     "rglru_scan": rglru_scan, "wkv6": wkv6, "gmm": gmm}
    if (NOP, GET, INSERT, UPDATE, DELETE, MOVE) != (
            pt.NOP, pt.GET, pt.INSERT, pt.UPDATE, pt.DELETE, pt.MOVE):
        print("chip_smoke: op codes differ from repro_torch.core's",
              file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots = KEYS // P + 4
    t0 = time.perf_counter()
    try:
        log("phase 1: build")
        _nvcc.build("remote_dma", "flash_attention", "flash_attention_bwd",
                    "flash_attention_bwd_sm90", "decode_attention",
                    "rglru_scan", "wkv6", "wkv6_bwd", "moe_gmm",
                    "moe_gmm_dx", "moe_gmm_dw", "remote_copy",
                    "remote_copy_peers")
        for name, out in _nvcc.BUILD_LOGS.items():
            log(f"  nvcc {name}.cu:\n" + "\n".join(
                "    " + ln for ln in out.strip().splitlines()))
        log(f"  built in {time.perf_counter() - t0:.1f} s")
        hmma = sass_mma_count(_nvcc, "flash_attention", "flash_fwd_mma")
        check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
              f"the bf16 flash kernels lack tensor-core HMMA: {hmma}")
        log(f"  cuobjdump -sass, HMMA per tensor-core flash kernel: {hmma}")
        usage = ptxas_usage(_nvcc, "flash_attention", "flash_fwd_mma")
        check(len(usage) == 4 and all(u[0] and not u[1] and not u[2]
                                      for u in usage.values()),
              f"the tensor-core flash kernels spill: {usage}")
        log("  -Xptxas -v, tensor-core flash kernels [registers, spill "
            f"stores, spill loads]: {usage}")
        check_gmm_build(_nvcc)
        usage = ptxas_usage(_nvcc, "rglru_scan", "rglru_")
        check(len(usage) == 12 and all(u[0] and not u[1]
                                       for u in usage.values()),
              f"the RG-LRU kernels spill: {usage}")
        log("  -Xptxas -v, RG-LRU kernels (the forward, the backward's tile "
            "aggregates and gradients) [registers, spill stores, spill "
            f"loads]: {usage}")
        usage = ptxas_usage(_nvcc, "wkv6_bwd", "wkv6_bwd_")
        d64 = {fn: u for fn, u in usage.items() if "ILi64E" in fn}
        check(len(d64) == 4 and all(u[0] and not u[1] for u in d64.values()),
              f"the D = 64 WKV6 backward kernels spill: {d64}")
        log("  -Xptxas -v, WKV6 backward kernels [registers, spill stores, "
            f"spill loads]: {usage}")
        hmma = sass_mma_count(_nvcc, "flash_attention_bwd", "mma_kernel")
        check(len(hmma) == 4 and all(n > 0 for n in hmma.values()),
              f"the bf16 flash backward kernels lack tensor-core HMMA: "
              f"{hmma}")
        log("  cuobjdump -sass, HMMA per tensor-core flash backward kernel: "
            f"{hmma}")
        usage = ptxas_usage(_nvcc, "flash_attention_bwd", "_kernel")
        mma = {fn: u for fn, u in usage.items() if "mma_kernel" in fn}
        check(len(mma) == 4 and all(u[0] and not u[1] and not u[2]
                                    for u in mma.values()),
              f"the tensor-core flash backward kernels spill: {mma}")
        log("  -Xptxas -v, flash backward kernels [registers, spill stores, "
            f"spill loads]: {usage}")
        check_flash_bwd_sm90_build(_nvcc)
        log("phase 2: kernels against their plain versions")
        cases, errs = phase_kernels(torch, rdma, slots)
        copy_cases_, copy_errs = phase_copy_kernel(torch, rdma)
        t2 = time.perf_counter()
        peer = phase_peer_copy_kernel(torch, card)
        log(f"  the hop between processes took {time.perf_counter() - t2:.1f} "
            f"s")
        _attn_cases, attn_errs = phase_attention_kernels(torch,
                                                         model_kernels)
        _rec_cases, rec_errs = phase_recurrent_kernels(torch, model_kernels)
        gmm_err = phase_gmm_kernel(torch, model_kernels)
        log("phase 2b: flash attention's backward against its plain version")
        bwd_errs = phase_flash_bwd_kernel(torch)
        log("phase 2b: the grouped matmul's backward against its plain "
            "versions")
        gmm_bwd_errs = phase_gmm_bwd_kernels(torch)
        log("phase 2c: the recurrences' backward against their plain "
            "versions")
        rec_bwd_errs = phase_recurrent_bwd_kernels(torch)
        log("phase 3: the same work on cuda and cpu")
        phase_parity(torch, pt)
        phase_serving_parity(torch, pt)
        cross_model_parity(torch)
        phase_replicated_parity(torch, pt)
        train_parity(torch)
        log("phase 4: the KVStore path (4a: its lock-free twin; 4c: the "
            "migration scenario)")
        t4 = time.perf_counter()
        metrics, launches = phase_main_path(torch, pt, rdma, slots)
        log(f"  KVStore path took {time.perf_counter() - t4:.1f} s")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the KVStore path")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4b: the failover scenario on the KVStore path's store")
        t4 = time.perf_counter()
        fo_metrics, fo_launches = phase_failover(torch, pt, rdma, slots)
        log(f"  failover path took {time.perf_counter() - t4:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4d: the channel objects' scalar verbs")
        t4 = time.perf_counter()
        chan_metrics, chan_launches = phase_channels(torch, pt, rdma)
        log(f"  channel phase took {time.perf_counter() - t4:.1f} s; "
            f"launches {chan_launches}")
        log("phase 4e: the map's executable specification store")
        t4 = time.perf_counter()
        spec_metrics, spec_launches = phase_spec_store(torch, pt, rdma)
        log(f"  spec store phase took {time.perf_counter() - t4:.1f} s; "
            f"launches {spec_launches}")
        for label, counts in (("channel", chan_launches),
                              ("spec store", spec_launches)):
            for name, n in counts.items():
                check(n > 0, f"{name} was not launched in the {label} phase")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4f: the map across processes")
        t4 = time.perf_counter()
        map_metrics, map_launches = phase_map_processes(torch, pt, rdma,
                                                        card)
        log(f"  map across processes took {time.perf_counter() - t4:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 4g: the failover scenario across processes")
        t4 = time.perf_counter()
        fo_pm_metrics, fo_pm_launches = phase_failover_processes(
            torch, pt, rdma, card)
        log(f"  failover across processes took "
            f"{time.perf_counter() - t4:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 5: the serving paths")
        serve_metrics, serve_launches = {}, {}
        for path in SERVE_PATHS:
            t5 = time.perf_counter()
            label = path_label(path)
            serve_metrics[label], serve_launches[label] = phase_serving(
                torch, model_kernels, path, rdma)
            if "a2a" in serve_metrics[label]:
                serve_launches[f"{label} a2a"] = \
                    serve_metrics[label]["a2a"]["launches"]
            log(f"  {label} serving path took "
                f"{time.perf_counter() - t5:.1f} s")
            gc.collect()                 # the engine's weights go first
            torch.cuda.empty_cache()
        log("phase 5c: the serving steps across processes")
        t5 = time.perf_counter()
        pm_metrics, pm_launches = phase_process_mesh(torch, card)
        serve_metrics["process_mesh"] = pm_metrics
        serve_launches.update(pm_launches)
        log(f"  process-mesh paths took {time.perf_counter() - t5:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 7: the training paths")
        t7 = time.perf_counter()
        train_metrics, train_launches = phase_train(torch, model_kernels)
        log(f"  training paths took {time.perf_counter() - t7:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 7c: the training steps across processes")
        t7 = time.perf_counter()
        pt_metrics, pt_launches = phase_train_process_mesh(torch, card)
        train_metrics["process_mesh"] = pt_metrics
        train_launches.update(pt_launches)
        log(f"  process-mesh training took {time.perf_counter() - t7:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        log("phase 6: report")
        kernels = phase_report(torch, rdma, cases, errs, launches,
                               {"channels": chan_launches,
                                "spec_store": spec_launches}, map_launches)
        kernels += attention_report(
            torch, model_kernels, attn_errs,
            serve_launches | {
                f"{arch} train": {"flash_attention": n["flash_attention"]}
                for arch, n in train_launches.items()
                if "flash_attention" in n})
        kernels += flash_bwd_report(torch, bwd_errs, {
            f"{arch} train": n["flash_attention_bwd"]
            for arch, n in train_launches.items()
            if "flash_attention_bwd" in n}, {
            f"{arch} train": m["routes"]["flash_attention_bwd"]["wgmma"]
            for arch, m in train_metrics.items()
            if "flash_attention_bwd" in m.get("routes", {})})
        kernels += recurrent_bwd_report(torch, rec_bwd_errs, train_launches)
        kernels += recurrent_report(torch, model_kernels, rec_errs,
                                    serve_launches, train_launches)
        kernels += gmm_report(torch, model_kernels, gmm_err,
                              serve_launches | {
                                  f"{path} train": n
                                  for path, n in train_launches.items()
                                  if "gmm" in n},
                              {arch: serve_metrics[arch]["a2a"]["gmm_timing"]
                               for arch in (MOE_ARCH, DS_ARCH)})
        kernels += gmm_bwd_report(torch, gmm_bwd_errs, train_launches)
        kernels += copy_report(torch, rdma, copy_cases_, copy_errs, {
            "failover": fo_launches["remote_copy"],
            "serving": serve_launches[path_label(SERVE_PATHS[1])][
                "remote_copy"]})
        kernels += peer_copy_report(peer, fo_pm_launches)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"  profiler: at most {MARKS_LOST[0]} of {LEAD_MARKS} lead marker "
        f"records lost by one session; {SESSIONS_RUN_AGAIN[0]} sessions "
        f"not whole, run again")
    log(json.dumps(dict(kvstore=metrics, failover=fo_metrics,
                        channels=chan_metrics, spec_store=spec_metrics,
                        map_processes=map_metrics,
                        failover_processes=fo_pm_metrics,
                        serving=serve_metrics, training=train_metrics,
                        profiler_marks_lost=MARKS_LOST[0],
                        profiler_sessions_run_again=SESSIONS_RUN_AGAIN[0],
                        card=card,
                        total_s=time.perf_counter() - t0)))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
