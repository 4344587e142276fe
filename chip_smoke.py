#!/usr/bin/env python3
"""Chip smoke of the deepspeed_tpu_torch port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_CHECKOUT

Run from the root of a checkout. ``--ab`` times only the kernels at the
main paths' shapes (K1-fwd and K2 at head dims 64 and 128, K3 and
K3-int8 at the llama-7b decode
shape and in their verify modes at the llama-7b verify shape, K4 at M =
8, 1 and 256 with the two layer sums, K5), on the kernels
of another checkout (A) and of this one (B) in turns, A B B A, through
this script's cases and timers on both sides, and prints both sides'
times per row. Without arguments, each
phase prints one JSON line:

1. ``env``: the card's name and power limit, torch and CUDA versions, the
   nvcc build of every kernel (seconds; registers, shared memory and
   spills from ``-Xptxas -v``).
2. ``kernel``: each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes and a few variants (max-abs error, and
   the error relative to the output's own scale: per query row for
   K1-fwd, per slot for K3, so that rows or slots with small outputs
   are held as tightly as the rest), with its time
   (CUDA events over many launches after warm-up), the plain version's
   time, the time of one PyTorch library call computing the same function
   (``scaled_dot_product_attention``, and its backward through autograd
   for the backward kernels; ``torch.matmul`` on the weight already
   dequantized to bf16 for K4; SDPA with a boolean mask for K5; a
   yardstick only, never called by the port)
   and the least time the card could take (bound). K1-fwd, K2, K3 and K5
   rows also name the design that ran (``mma``: tensor cores, bf16 and
   fp16, and K3's verify mode there; ``fma``: CUDA cores, float32, and
   K3's decode mode), the achieved TFLOP/s and ``vs_library``
   (kernel ms / library ms); a call that may be shorter than ~50 us is
   timed by CUDA graph replay (``device_ms``), the kernel and SDPA alike,
   and the row says which (``timed_by``): K3's rows (kernel and SDPA)
   and K4's (over rotating weights) are always graph replay. K5's
   tensor-core rows also give the work list
   (CTAs per batch row, row groups whose union was split over CTAs). The
   env line fails the run if ptxas reports a spill in the tensor-core
   K2-dq or K5 at head dims 64 and 128, or in any instance of K3's split,
   verify and combine kernels or K4's tensor-core kernels; it lists the kernels
   where ptxas serialized ``wgmma`` (``wgmma_serialized``). K2-dq and
   K2-dkv are
   held against the plain backward formulas on the forward kernel's own
   ``o`` and ``lse``, each gradient by its largest error and relative to
   each row's own scale, and two launches must give the same bits.
   The head dims beyond 64 and 128 (each its own build): K1-fwd, K2-dq
   and K2-dkv at gpt2-4b's training shape (32 heads of 72), K1-fwd at
   gpt2-8b's prefill (32 heads of 96), K3 and K3-int8 at gpt2-8b's decode
   and verify shapes, llama-tiny's GQA at 32, with masks, float16 and
   float32 beside them; K3's int8-pool mode with a float16 q at the
   llama-7b decode and verify shapes. The env line fails on a spill in
   any width's tensor-core K1-fwd and K2-dq too. The ring modes of
   K1-fwd, K2-dq and K2-dkv (``-DDS_RING``, built up front at head dim
   128 and checked for spills as the others) at one rank's llama-7b
   attention block (1 x 4096 x 32 heads of 128, bf16, fp32 gradients):
   hop 0 (causal) and the windowed ring's hop 1 (q_off 4096, window
   1024), each against its plain version and beside SDPA with the same
   boolean mask (forward) and its autograd backward.
3. ``serve``: the main path at full width. llama-7b (16 of its 32
   layers, cut for the run's time; random bf16 weights from seed 0; the
   engine of the serving extensions' phases below): ``generate`` on 4
   prompts of 512 tokens,
   then a ``ServingEngine`` draining 16 seeded requests (prompts of 64 to
   1024 tokens, 64 new tokens each) through 8 slots with chunked prefill.
   Each of the two paths is driven with both launch counters set to 0
   just before it and read just after: ``generate`` must launch K1-fwd
   (its static prefill) and the serving drain must launch K3 (its
   decode steps; its paged prefill is plain PyTorch, as in the JAX
   package). The first 4 served streams are compared with a solo
   ``generate``. ``generate_fused`` on the same prompts (its decode loop
   captured once into a CUDA graph, then replayed) must give
   ``generate``'s tokens bit for bit, on its first call and on a replay;
   ``forward``'s last-position logits are held to the bf16 tolerance
   against the static prefill's (the head's product runs at another
   shape), and ``decode_per_token`` is reported beside
   ``decode_per_token_fused``.
   ``trace``: 4 steady 8-slot decode steps through
   ``ServingEngine.capture_profile`` (the port's trace capture), read
   back from the Chrome trace it wrote (device busy and idle share, top
   device kernels and host ops); the K3 kernels in the trace must be the
   launches K3's counters saw in the window.
   ``agreement``: the same comparison for 4 of the requests with a
   float32 llama-7b cut to 16 layers, where rounding cannot flip a
   near-tie the way bf16 does; every stream must agree in full.
   ``horizon``: the serve phase's 16 requests (four with a two-token stop taken
   from their serve-phase streams, four sampled) drained at decode horizons 1
   and 4 (N = 8 cut for the run's time; the card tests hold it): every
   stream and logprob at 4 equals N = 1's, K3 runs once
   per layer and decode iteration; then ``trace`` at N = 4 (wall, device-
   busy and host CPU ms and aten calls per emitted token; the serve phase's
   ``trace`` is N = 1). ``host_tier``: the prefix cache with the host tier off
   and on, 24 requests over 4 system prompts of 512 tokens in a 160-block pool
   with a 1 GiB host budget: the same streams, restores on; then a corrupted
   host entry on a request's chain, which re-prefills (one restore failure) and
   gives the tier-off stream; then the spill's and restore's ms and GB/s per
   block, the CRC32's share, against re-prefilling 32 blocks.
   ``serve_int8``: the int8 serving path at full width, 8 of llama-7b's
   32 layers (cut for the run's time; ``horizon_int8``,
   ``host_tier_int8`` and ``spec_int8`` run on this engine): the weights
   through ``init_inference(dtype=torch.int8)`` (weight-only int8,
   bf16 activations), the same ``generate`` and the same 16 requests
   through a ``ServingEngine(kv_quant="int8")`` (int8 KV blocks with
   per-(block, kv head) scales). ``generate`` must launch K1-fwd and K4
   and neither K3 mode; the drain must launch K4 and K3-int8 and float K3
   never. Its greedy agreement with the same int8 weights served over a
   bf16 cache is reported; ``trace`` repeats for its decode step.
   ``prefix``: the shared-prefix cache on the serve phase's engine: 16
   requests sharing a 512-token system prompt (32 full blocks) with
   seeded suffixes of 64-512 tokens, 64 new tokens, drained with the cache
   off and on: TTFT and TPOT p50/p99 (TPOT per request, first to last
   token), tokens/s, prefix hits and tokens saved, copy-on-write copies,
   peak used blocks, and the bf16 agreement of the two runs' streams
   (reported). ``spec``: speculative decode on the same engine: 8
   prompts (cut for the run's time) of 64-1024 tokens built from
   repeated spans, spec_k 4 with the
   n-gram drafter, drained with speculation off and on, and on with a
   drafter that proposes the on run's own streams (what speculation
   gives when drafts are right: random weights rarely continue a repeated
   span); every step of the second is a verify, which must launch K3 in its verify mode
   (``K3-verify``, q_len 5) and never its decode mode; the acceptance
   rate, tokens per verify step and the ``spec_*`` stats. Then a short
   drain with a ``ModelDraft`` over a 2-layer llama-7b-width draft from
   seed 1 (its ``generate`` launches K1-fwd) and one of sampled requests
   (temperature 0.8), both with finite logprobs. ``spec_int8``: the int8
   engine with speculation and the prefix cache together (12 requests
   sharing a 256-token system prompt), against both off, and with the
   on run's streams as drafts:
   ``K3-int8-verify`` and K4 launched, float K3 never. ``horizon_int8``
   and ``host_tier_int8``: the horizon (N = 1 and 4) and the host tier
   on the int8 engine with int8 KV (the scales spilled and restored with
   the codes); K3-int8 and K4 counted. Telemetry: the N = 4 drains of
   ``horizon`` and ``horizon_int8`` run with ``telemetry=True`` (their
   streams equal N = 1's, which runs with it off), and their rows'
   ``telemetry`` entries check the stats view against the registry and
   the tracer's counts, one ``finish`` per request and no dropped record,
   the footprints summing to the cost totals, and the exported trace read
   back; ``trace`` runs again at N = 1 with telemetry on, and
   ``telemetry_cost`` times two warm 8-slot engines, telemetry off and
   on, in alternating windows of 4 decode steps (3 pairs): wall and host
   CPU ms per token per window, the on/off ratio per pair, the two
   traces' aten calls per token, and the breakdown's phase shares over
   the sampled steps inside the windows.
   ``serve_fp16``: llama-7b at full width cut to 4 layers, the same
   weights in float16 and bf16: 4 requests, 32 new tokens; K3's float16
   mode once per layer and decode step, the fp16/bf16 agreement
   (reported), the first-step logits against float32 on the host; then
   the float16 engine over int8 KV blocks, a drain and a speculative
   drain: K3's int8-pool modes with a float16 q, no float K3 mode.
   ``serve_8b`` and ``serve_8b_int8``: gpt2-8b at full width (32 heads of
   96) cut to 4 layers, bf16: ``generate`` (K1-fwd at 96), an 8-slot
   drain of 8 requests (K3 at 96, once per layer and decode step) and a
   speculative drain of 4 (its verify mode), over float and int8 pools.
   ``chaos`` (after ``spec``, on the serve phase's engine): faults in a
   drain of 8 of the serve phase's requests (32 new tokens, greedy, with
   logprobs), each drain with the launch counters at 0: a fault-free
   drain; device errors at ``serving.prefill``, ``serving.decode``
   (twice) and ``engine.decode``, retried, with the same streams and
   logprobs bit for bit, 4 retries, the fault-free drain's K3 launches
   and the trace's ``fault`` records at the fired visits; a horizon (N =
   4) faulted twice at ``serving.horizon``, 2 fallbacks and the same
   streams; a queue of 4 with 8 submits and two deadlines 12 ticks out (4
   ``shed``, 2 ``timeout`` with prefixes of their streams, backpressure 0
   after); the watchdog (0.5 s budget, two 1.5 s ``slow`` faults) with
   the flight recorder: a DegradedError whose artifact (bytes and dump
   time reported) the port's postmortem reader verifies and analyses
   (its faults the fired log, backend ``gpu``), the degraded engine
   drained to the fault-free streams, and its snapshot resumed in a fresh
   engine (every request to its budget once; the agreement with the
   fault-free streams reported). ``chaos_int8`` (after ``spec_int8``):
   device errors at ``cache.quantize`` and ``engine.decode`` on the int8
   engine, the same streams and the same K3-int8 and K4 launches.
   ``lora`` (right after ``serve``, on its engine): multi-tenant LoRA
   serving at full width. Four seeded adapters in the ``runtime/lora.py``
   export format (ranks 8, 8, 16, 16, all five dense targets, each delta
   ~0.1 of its projection's RMS, measured), a pool of 6 rank blocks of 8;
   the serve phase's 16 prompts, 12 naming the adapters round-robin and 4
   base-only, drained with the launch counters at 0: every base-only
   stream and logprob bit for bit the serve drain's (the pool's zero block
   adds exactly +0.0), every adapter stream different from its base
   stream, every kernel launched as often as in the serve drain, 4 loads
   and 8 hits, the pool 7 blocks of (in + out) x 8 x 2 bytes per target
   and layer, every pin dropped after; tokens/s, TTFT and TPOT against
   the serve drain's; then LoRA off and on in alternating 4-step windows
   of a steady 8-slot decode (3 pairs) and one profiled step of each
   (``lora_cost``: wall and host CPU ms per token, device busy, idle
   share, aten calls). ``lora_int8`` (after ``serve_int8``): the same on
   the int8 engine with the adapters cut to its 8 layers, against the
   int8 drain (K4 and K3-int8 launched as often).
4. ``parity``: llama-7b width at 2 layers in float32, the same weights on
   the card and on the host: teacher-forced prefill and 8 decode steps
   through the paged path, and the static prefill, logits compared.
   ``parity_int8``: the same with int8 weights and int8 KV blocks (K4 and
   K3-int8 on the card, their plain versions on the host); the int8 pools
   are compared code by code as well. ``spec_parity``: the same width in
   float32: greedy streams served on the card with speculation on, with
   the prefix cache on and with both equal the host's spec-off,
   prefix-off streams, and ``generate_speculative`` on the card (a
   1-layer draft) equals the target's ``generate``. Its ``chaos_fp32``:
   on that engine a ``cache.ensure`` exhaustion (an eviction and a
   re-prefill), faulted ``cache.match`` and ``cache.cow`` with the prefix
   cache, faulted ``serving.spec_draft`` and ``engine.verify`` with
   speculation (K3's verify mode runs, four steps degrade to plain
   decode), and a faulted ``cache.restore`` and a ``cache.host_corrupt``
   with the host tier (8 requests over two 64-token system prompts, one
   at a time, in a 24-block pool under constant spill pressure): each
   greedy stream equals the fault-free one exactly. ``lora_parity``: LoRA
   at that width in float32, with float and int8 pools: streams under
   the adapters against each adapter merged into the weights (a parting
   only at a near-tie of the reference's logits: 1e-4 of their scale,
   one int8 code step with int8 pools), the unmerged ``add_lora`` tree's
   ``generate`` (K1-fwd) against its merge, eviction and reload in a
   3-block pool, speculation under adapters (K3's verify modes counted),
   the horizon at N = 4, and a faulted adapter load of each kind (the
   request retires ``error``, the pool's stats and bytes unchanged).
   The replica router (slice 11), on the serve phase's engine after
   ``chaos``: ``router``, two mixed replicas of the serve geometry, the
   16 serve requests at 32 new tokens (every request done, K3 launched,
   requests per replica, TTFT and TPOT, bf16 agreement with the serve
   drain reported), then 8 of them with a ``router.step`` crash
   mid-decode (drained, one trip) and ``restart_replica`` with a probe
   (back to healthy); ``router_lora``, two LoRA replicas and two of the
   lora phase's adapters: follow-ups on their tenant's replica, a pool
   hit, base-only streams and logprobs bit for bit the lora phase's;
   ``disagg``, a prefill and a decode replica, 8 serve requests: 8
   migrations and no fallback, each landed chain byte-equal to its
   source, no device allocation inside a migration, ms per block and
   GB/s of each half and the CRC32's share, then a corrupted host block
   refused by its CRC32 (a cold fallback, the request done);
   ``autoscale``, a seeded ``chat`` drive with a spike under an
   ``SLOController`` (one replica to at most 3, sharing the engine):
   scale-ups, then idle ticks to a retire, the decision list rebuilt
   from the exported trace by ``telemetry.read_fleet_trace``.
   ``disagg_int8`` (after ``chaos_int8``): the same on the int8 engine
   (scales migrate, K4 and K3-int8 launched). ``router_parity`` (after
   ``lora_parity``, float32, 2 layers): three replicas under the JAX
   router tests' faults and a prefill/decode pair with each migrate site
   faulted, float and int8 pools, every stream equal to one engine's
   fault-free drain exactly.
5. ``train``: the training path at full width and depth. gpt2-1.5b (48
   layers, d_model 1600, random weights from seed 0) through
   ``deepspeed_tpu_torch.initialize`` and ``engine.train_batch``: bf16 with
   bf16 masters and moments (``bf16.memory_efficient``), AdamW, full
   activation checkpointing, the chunked loss, batch 16 of 1024 tokens, one
   warm-up and five timed steps; then fp32 masters with the selective
   policy and a warm-up schedule on batch 8 of documents packed by
   ``pack_documents``, five steps. Per step: ms, tokens/s, MFU against
   989 TFLOP/s, peak memory, the loss (finite, and lower at the last step than at the first on the
   repeated batch), and the launch counts of this path alone: K1-fwd,
   K2-dq and K2-dkv above zero, K3 zero, K1-fwd ``L * steps`` under the
   selective policy and ``2 * L * steps`` under the full one.
   ``train_trace``: one step through ``start_trace`` (the port's trace
   capture), read back from its Chrome trace: one ``ds.train_batch``
   range, the flash kernels the counters saw.
   ``remat``: what the forward leaves allocated for the backward, and the
   peak memory of one step, without checkpointing and under the three
   policies (each strictly decreasing in that order), and their losses and
   gradient norms equal at 2 layers in float32.
   ``train_parity``: gpt2-1.5b width, 2 layers, sequences of 128 (cut
   for the run's time), float32, the same weights
   on the card (kernels) and on the host (plain versions): the loss and
   every gradient leaf of a plain and a packed batch, then two
   ``train_batch`` steps with each of AdamW, SGD (momentum 0.9, Nesterov)
   and Adagrad, parameters compared. ``train_4b``: gpt2-4b at full width
   (32 heads of 72) cut to 4 layers, bf16 memory-efficient, AdamW, full
   remat, batch 16 x 1024, 1 warm-up and 2 steps: K1-fwd twice and K2
   once per layer and step at head dim 72; then float32 at 2 layers,
   card against host, the loss and every gradient leaf.
6. ``sparse``: the block-sparse attention path at bert-large's attention
   width (16 heads of 64, B = 4, S = 4096, bf16): a ``sparse_attention``
   config section (the default fixed layout, block 16) through
   ``DeepSpeedConfig``, ``build_sparsity_config`` and
   ``SparseSelfAttention``, a forward and backward through 24 calls, for
   bidirectional and then unidirectional attention, each pass with the
   launch counters at 0: K5 once per call (the backward recomputes
   through the gather version, as the JAX package's does). The K5
   ``kernel`` lines hold it against the gather version for every layout
   family, blocks 16 and 64, head dims 32 to 128, bf16 and float32, and
   time SDPA with the layout as a boolean mask beside it.
   ``bert``: BERT-large pretraining at full width and depth (24 layers,
   d_model 1024, random weights from seed 0), the JAX package's
   ``tools/bert_bench.py`` headline: seq 512, batch 32, bf16, AdamW, ZeRO
   stage 1, full checkpointing, the chunked MLM loss, NSP labels, token
   types and a quarter of the rows padded (K1-fwd and K2 run non-causal
   with the padding mask as their key mask); then LAMB, fp32 masters, the
   selective policy and dropout 0.1 (attention takes the masked softmax,
   no flash launch), batch 16, and one SQuAD step. Per run: ms per step,
   samples/s, MFU against 989 TFLOP/s, peak memory, the loss (finite, and
   falling on the repeated batch) and the launch counts. ``bert_trace``:
   one step of the first run through ``start_trace``. ``bert_parity``:
   bert-large width, 2 layers, float32, card vs host loss and every
   gradient leaf, unpadded and padded. ``bert_infer``: encoder inference,
   ``init_inference(model=(BertConfig, params))`` at bert-large's full
   width and depth, bf16, ``forward`` on 32 x 512 tokens (MLM logits;
   K1-fwd non-causal once per layer), then float32 at 2 layers, card
   against host, the MLM logits.
   ``bf16_parity``: gpt2-1.5b and bert-large width at 2 layers in bf16 on
   the card (the tensor-core designs) against float32 on the host, on the
   same bf16-rounded weights: the loss and every gradient leaf, each held
   to twice the host's own bf16 distance from float32 on that leaf plus
   0.01; the worst leaf and the worst attention leaf are reported.

7. ``resume``: gpt2-1.5b at full width, 4 of its 48 layers (cut for the run's
   time), in the first ``train`` configuration: four uninterrupted
   steps against two steps, ``save_checkpoint``, a fresh engine from other
   random weights, ``load_checkpoint`` and two more steps; the four losses
   and every parameter and moment leaf must be equal bit for bit. The
   checkpoint's bytes, the seconds and GB/s of the save (write, CRC32,
   fsync), of a CRC32 pass alone and of the load (validate, read). Then the
   resumed engine saves again (``latest`` moves to it), ``save_16bit_model``
   (read back bit for bit) and
   ``init_inference(config=, checkpoint=)``: ``generate`` (K1-fwd) on 4
   prompts of 256 tokens for 32 tokens and a serving drain of the same
   prompts (K3) must give the streams of the same weights handed over as
   ``(cfg, params)``. ``train_features``: gpt2-1.5b at full width and
   depth through ``initialize(training_data=)``, ``RepeatingLoader`` and
   ``PrefetchLoader``, six steps with a fixed_linear seqlen curriculum
   (lengths 568 to 816, off the 64 grid but one), progressive layer drop
   at theta 0.5, the CSV/JSONL monitor, the timers and the flops profiler
   at step 3. Per step: the length, ms, the kept layers (the step's draws
   replayed from the generator's state), and the launch counts, which
   must be K1-fwd twice and K2-dq and K2-dkv once per kept layer (full
   checkpointing), K3 none; the monitor, flushed every third step, must
   have one header and one row per step, and the profiler's report its
   MFU line and the analytic FLOPs of the layers that ran at step 3.
   ``host_sync``: gpt2-small, batch 8 of 512, runs of 20 free-running
   steps with the throughput meter reporting every 1000 steps against
   every step (a wait for the device at each), 2 pairs: ms per step.
   ``zero`` (last but one): data parallelism with ZeRO through one NCCL
   rank in this process (``init_distributed(dist_backend="nccl")``, a
   world of 1; the engine runs its collectives): float32 at 2 layers of
   gpt2-1.5b's width, one step at each of stages 0-3 on the rank against
   the same engine without a process group, bit for bit; then gpt2-1.5b's
   full width at 4 of its 48 layers, 16 x 1024, bf16, full remat, one
   step at stages 0, 1, 3 and two at stage 2, K1-fwd twice and K2 once
   per layer and step (counters zeroed before each stage), with the
   collectives' calls and bytes, peak memory, optimizer-state and master
   bytes. ``zero_ranks`` (in the ``--ring-rank`` processes below, before
   the ring variants): two ``gloo`` ranks on ``cuda:0``, 8 of the 16 rows
   each, stages 2 and 3, two steps, in bf16 and in float32 at 2 layers:
   losses
   within 2e-2 and 1e-4 of ``zero``'s one-rank runs, K1-fwd and K2 on
   each rank, each rank's peak memory, optimizer-state and master bytes,
   ms per step and the collectives' bytes and seconds (timed with the
   device synchronised around each; gloo through the host on one card,
   not NCCL). The bf16 stage-3 run starts from ``zero.Init``'s shards
   (the leaves drawn one at a time on the card by ``gpt.init_leaves``),
   with the card's peak during ``zero.Init`` beside the shards', the
   whole tree's and the largest leaf's bytes. ``ring_ranks`` (last):
   sequence parallelism at llama-7b's full width (2 of its 32 layers),
   one row of 8,192 tokens, bf16 compute over fp32 masters, one step:
   the one-rank engine without sequence parallelism first (the plain
   row, the windowed model, a packed row), then two ``gloo`` ranks on
   ``cuda:0`` (``--ring-rank``), 4,096 tokens each, through ring
   contiguous, zigzag, windowed (window 1024: hop 1 at q_off 4096 on
   rank 1), packed documents and Ulysses: losses and gradient norms
   within 2e-2 of the
   one-rank run, the ring-mode kernels' launches on each rank as the
   hops count them (Ulysses: the flash kernels), the rotations (staged
   through pinned host buffers: gloo's send/recv take host memory),
   all-to-alls and all-reduces with their bytes and seconds, and each
   rank's peak memory beside the one-rank run's. ``tp_ranks`` (in the same
   two ranks, after the ring variants): tensor parallelism at llama-7b's
   full width, 16 of its 32 heads and a ``d_ff`` of 5,504 a rank
   (``init_inference(mp_size=2)``, the ``ServingEngine`` over it,
   ``initialize`` with ``tensor_parallel_size`` 2), against the same runs
   on one rank made before the spawn: float32 at 2 layers (the greedy
   streams equal, the logits within 1e-4), bf16 at 4 layers (``generate``
   with K1-fwd once a layer, a drain of ``serve``'s first 8 prompts at 32
   new tokens with K3 once a layer and decode step; the two ranks'
   streams identical, agreement with one rank reported and its partings
   held to rounding by ``partings``; weight and pool bytes against one
   rank's; TPOT; the TP all-reduces' calls, bytes and seconds a token),
   int8 weights and KV at 4 layers (K4 five times a layer and dispatch,
   K3-int8), and two training steps at 2 layers, 4 x 1,024, bf16 over
   fp32 masters, ZeRO 1 (losses within 2e-2 of one rank's, K1-fwd and K2
   once a layer and step, peak memory, the collectives' share of a step).
   The kernels at one rank's shapes are ``kernel`` rows of their own
   (``tp_kernel_cases``: K1-fwd and K2 at 4 x 1,024 with 16 heads, K3 and
   K3-int8 at 16 kv heads, K4 at the four shard projections and their
   layer), listed as ``K1-fwd@tp`` etc. in the kernel summary.
   ``pipe_ranks`` (in the same two ranks, after ``tp_ranks``): pipeline
   parallelism at gpt2-1.5b's full width (tied embeddings), 4 of its 48
   layers, 2 a stage, 8 rows of 1,024 tokens in 4 microbatches, bf16 over
   fp32 masters, two steps under each of GPipe, 1F1B and interleaved 1F1B
   (2 chunks a stage), against the engine without a pipeline on one rank
   made before the spawn: losses and gradient norms within 2e-2, K1-fwd
   and K2 on each rank as ``pipe_expected`` counts them from the
   schedule, the sends and receives as the schedule's tables give them;
   per rank the step's ms, the receives' wait beside the fill-drain
   bubble, the sends', the tied all-reduce's bytes and seconds, and the
   peak beside GPipe's.

Every JSON line carries ``t_s``, the seconds since the start: the
difference between two lines' stamps is what the work between them
cost. The two lines before the last are the kernel summary and the card as
``nvidia-smi --query-gpu=name,power.limit`` reports it; the last line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
nonzero exit code and without that line. Without a CUDA card, or outside
a checkout of the repository, it exits nonzero at once.
"""

import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float16": 989e12,
              "float32": 67e12}       # CUDA cores, no tensor cores
TOL = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# float16 serving against float32 on the same weights: the first step's
# logits within this share of their largest magnitude
FP16_TOL = 5e-3
LSE_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


T_START = time.perf_counter()


def emit(obj):
    """One JSON line, stamped with the seconds since the start (``t_s``):
    the difference between two lines' stamps is what the work between
    them cost, so a run's time can be split by phase and by kernel row."""
    obj = dict(obj, t_s=round(time.perf_counter() - T_START, 3))
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# a port kernel's name inside a mangled symbol (after its length digits)
KERNEL = r"(?<=\d)((?:flash|paged|i8mm|blocksparse)_\w*?_kernel)"
_TYPE_NAMES = {"__nv_bfloat16": "bf16", "__half": "f16", "f": "f32",
               "a": "int8"}
# a bool template argument that is true, by kernel family
_FLAGS = {"paged": "int8", "blocksparse": "causal", "flash": "segs"}


def template_args(s):
    """The template arguments of a mangled ``I...E`` list (``s`` starts
    after the ``I``): types as bf16/f16/f32/int8, integers as digits, a
    true bool as ``b1``, a repeated type (``S.._``) as the type before."""
    out, i = [], 0
    while i < len(s) and s[i] != "E":
        if s[i] == "L":
            j = s.index("E", i)
            out.append(("b" if s[i + 1] == "b" else "") + s[i + 2:j])
            i = j + 1
        elif s[i].isdigit():
            n = re.match(r"\d+", s[i:]).group()
            name = s[i + len(n):i + len(n) + int(n)]
            out.append(_TYPE_NAMES.get(name, name))
            i += len(n) + int(n)
        elif s[i] == "S":
            i = s.index("_", i) + 1
            out.append(out[-1] if out else "?")
        else:
            out.append(_TYPE_NAMES.get(s[i], s[i]))
            i += 1
    return out


def ptxas_summary(log):
    """{kernel template: {registers, smem_bytes, spill_bytes}}, and under
    ``"wgmma_serialized"`` the kernels ptxas says it serialized wgmma in."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            km = re.search(KERNEL + r"(I)?", name)
            if km:
                args = template_args(name[km.end():]) if km.group(2) else []
                family = km.group(1).split("_")[0]
                args = [_FLAGS[family] if a == "b1" else a for a in args
                        if a != "b0"]
                name = km.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
        m = re.search(r"wgmma.mma_async instructions are serialized.*"
                      r"function '(\w+)'", line)
        if m:
            km = re.search(KERNEL + r"I", m.group(1))
            out.setdefault("wgmma_serialized", []).append(
                km.group(1) + "<" + ",".join(template_args(
                    m.group(1)[km.end():])) + ">" if km else m.group(1))
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters):
    """Mean ms of ``fn()`` over ``iters`` launches after a warm-up, by CUDA
    events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


_CAPTURE_STREAM = []


def graph_ms(torch, fn, iters):
    """Mean device ms of ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed, so that the host's cost of each call (the Python
    wrapper, the allocator) stays out of a launch of a few tens of
    microseconds, which ``time_ms`` would measure instead. Warm-up and
    capture share one side stream for the whole run, so cuBLAS sets up
    its workspace for that stream once, outside any capture."""
    if not _CAPTURE_STREAM:
        _CAPTURE_STREAM.append(torch.cuda.Stream())
    side = _CAPTURE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / iters


SHORT_MS = 0.05


def device_ms(torch, fn, iters):
    """(ms, how) of ``fn()`` on the device: ``time_ms``, the mean of one
    run of CUDA events over eager calls, or, where a call may be shorter
    than ~50 us and the host's cost of each call would be timed instead,
    ``graph_ms`` when it reads below that."""
    ms = time_ms(torch, fn, iters)
    if ms < 2 * SHORT_MS:
        replay = graph_ms(torch, fn, max(iters, 20))
        if replay < SHORT_MS:
            return replay, "graph"
    return ms, "events"


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


class Rotor:
    """Cycles through copies of a call's inputs, enough of them to exceed
    the 50 MB L2 cache, so that each timed launch reads its weight from
    device memory as a decode step's layer-by-layer walk does."""

    def __init__(self, make, nbytes, total=200 * 2**20):
        self.copies = [make() for _ in range(max(1, -(-total // nbytes)))]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


def packed_segments(torch, B, S, n_seg, dev):
    """[B, S] int32 segment ids: every row cut into ``n_seg`` documents at
    seeded places, as ``pack_documents`` would pack them."""
    rng = np.random.default_rng(2)
    segs = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), n_seg - 1, replace=False))
        segs[b] = np.searchsorted(cuts, np.arange(S), side="right")
    return torch.from_numpy(segs).to(dev)


def attention_problem(torch, B, S, H, Hkv, D, dtype, window, pad, n_seg,
                      causal=True, lengths=None):
    """Seeded q, k, v, the mask arguments, and the boolean [B, S, S] map of
    the (query, key) pairs that attend. ``pad``: left-padded keys per row
    (generation); ``lengths``: valid keys per row, the rest a padded tail
    (BERT batches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(dtype)
    mask = segs = None
    rows = torch.arange(S, device=dev)
    allowed = (rows[None, :] <= rows[:, None]) if causal else \
        torch.ones((S, S), dtype=torch.bool, device=dev)
    allowed = allowed[None].expand(B, S, S)
    if window is not None:
        allowed = allowed & (rows[:, None] - rows[None, :] < window)[None]
    if pad is not None:
        pads = torch.tensor(pad, device=dev)
        mask = (rows[None] >= pads[:, None]).float()
        allowed = allowed & (mask[:, None, :] > 0)
    if lengths is not None:
        lens = torch.tensor(lengths, device=dev)
        mask = (rows[None] < lens[:, None]).to(torch.int32)
        allowed = allowed & (mask[:, None, :] > 0)
    if n_seg:
        segs = packed_segments(torch, B, S, n_seg, dev)
        allowed = allowed & (segs[:, :, None] == segs[:, None, :])
    kw = dict(causal=causal, kv_mask=mask, window=window, segment_ids=segs)
    return q, k, v, kw, allowed


def sdpa_mask_of(allowed, kw):
    """SDPA's arguments for the same problem: the boolean map when a mask
    argument is set, else the causal flag."""
    if kw["kv_mask"] is not None or kw["window"] or \
            kw["segment_ids"] is not None:
        return dict(attn_mask=allowed[:, None], is_causal=False)
    return dict(attn_mask=None, is_causal=kw["causal"])


def padded_tails(lengths, S):
    """How many rows of a ``lengths`` problem end in padding."""
    return 0 if lengths is None else sum(int(n) < S for n in lengths)


def design_of(module, key):
    """The design a kernel runs, from its module's ``DESIGN`` table
    (``flash``: by (kernel, dtype); ``blocksparse``: by dtype; ``paged``:
    by (mode, dtype, pool)); a checkout from before the tensor-core
    designs (``--ab``) has no table and runs the module's kernels on the
    CUDA cores."""
    table = getattr(module, "DESIGN", None)
    return "fma" if table is None else table[key]


def flash_case(torch, F, flash, name, B, S, H, Hkv, D, dtype, window=None,
               pad=None, n_seg=0, iters=20, causal=True, lengths=None):
    q, k, v, kw, allowed = attention_problem(torch, B, S, H, Hkv, D, dtype,
                                             window, pad, n_seg, causal,
                                             lengths)
    mask = kw["kv_mask"]
    o, lse = flash.flash_attention(q, k, v, **kw)
    o_ref, lse_ref = flash.mha_reference(q.float(), k.float(), v.float(), **kw)
    valid = allowed.any(-1)                   # rows with a valid key
    diff = (o.float() - o_ref).abs()[valid]   # [rows, H, D]
    err = diff.max().item()
    rel = (diff.amax(-1) / o_ref.abs()[valid].amax(-1)).max().item()
    lse_err = (lse - lse_ref).abs().transpose(1, 2)[valid].max().item()
    dn = str(dtype).split(".")[-1]
    check(err <= TOL[dn] and rel <= TOL[dn] and lse_err <= LSE_TOL,
          f"flash {name}: max |o - plain| {err}, per row relative {rel} "
          f"(tol {TOL[dn]}), max |lse - plain| {lse_err} (tol {LSE_TOL})")
    ms, ms_by = device_ms(torch, lambda: flash.flash_attention(q, k, v, **kw),
                          iters)
    plain_ms = time_ms(torch, lambda: flash.mha_reference(q, k, v, **kw),
                       max(2, iters // 4))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_by = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_mask_of(allowed, kw), enable_gqa=H != Hkv), iters)
    pairs = int(allowed.sum().item()) * H     # (row, col) pairs computed
    flops = 4.0 * D * pairs
    # q read and o written, k and v read once, lse written, mask and
    # segment ids read
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + B * H * S * 4 + (mask.numel() * 4 if mask is not None else 0) \
        + (B * S * 4 if n_seg else 0)
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel="K1-fwd", case=name, dtype=dn,
               shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window,
                          pad=pad, segments=n_seg, causal=causal,
                          padded_tails=padded_tails(lengths, S)),
               max_abs_err=err, max_rel_err_per_row=rel,
               lse_max_abs_err=lse_err, tol=TOL[dn],
               design=design_of(flash, ("K1-fwd", dtype)),
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               timed_by=ms_by, library_timed_by=lib_by,
               tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


def grad_errors(torch, got, ref, valid):
    """(max-abs error, the bound it is held to, the largest error relative
    to a row's own scale) of one gradient [B, S, heads, D] on the rows of
    ``valid`` [B, S]. A gradient is a sum over up to S terms, so the
    max-abs error is held relative to the largest entry; the row scale is
    floored at 1e-3 of it (dq of a row that sees one key is zero but for
    rounding noise)."""
    top = ref.abs().max().item()
    diff = (got.float() - ref).abs()[valid]
    scale = ref.abs()[valid].amax(-1).clamp_min(1e-3 * top)
    return diff.max().item(), max(1.0, top), \
        (diff.amax(-1) / scale).max().item()


def flash_bwd_case(torch, F, flash, name, B, S, H, Hkv, D, dtype, window=None,
                   pad=None, n_seg=0, iters=10, causal=True, lengths=None):
    """K2-dq and K2-dkv against the plain backward formulas on the same q,
    k, v, do and the forward kernel's o and lse. Returns the two rows."""
    q, k, v, kw, allowed = attention_problem(torch, B, S, H, Hkv, D, dtype,
                                             window, pad, n_seg, causal,
                                             lengths)
    g = torch.Generator(device=q.device).manual_seed(3)
    do = torch.randn(q.shape, generator=g, device=q.device).to(dtype)
    valid = allowed.any(-1)                   # rows with a valid key
    do = do * valid[:, :, None, None]         # the loss masks the others
    mask = kw["kv_mask"]
    o, lse = flash.flash_attention(q, k, v, **kw)
    delta = flash.attention_delta(o, do)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    again = (flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    ref = flash.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), **kw)
    dn = str(dtype).split(".")[-1]
    errs = {}
    for gname, got, got2, r in zip(("dq", "dk", "dv"), (dq, dk, dv), again,
                                   ref):
        check(torch.equal(got, got2),
              f"flash bwd {name}: {gname} differs between two launches")
        err, top, rel = grad_errors(torch, got, r, valid)
        check(err <= TOL[dn] * top and rel <= TOL[dn],
              f"flash bwd {name}: max |{gname} - plain| {err} (held to "
              f"{TOL[dn]} x {top}), per row relative {rel} (tol {TOL[dn]})")
        errs[gname] = (err, rel)
    del ref, again
    dq_ms, dq_by = device_ms(torch, lambda: flash.flash_bwd_dq(
        q, k, v, do, lse, delta, **kw), iters)
    dkv_ms, dkv_by = device_ms(torch, lambda: flash.flash_bwd_dkv(
        q, k, v, do, lse, delta, **kw), iters)
    # the plain formulas give all three gradients in one call: its time
    # stands beside both kernels
    plain_ms = time_ms(torch, lambda: flash.flash_attention_bwd_reference(
        q, k, v, o, lse, do, **kw), 2)
    # library yardstick: the backward of SDPA through autograd (dq, dk and
    # dv in one call), timed only
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa_mask_of(allowed, kw), enable_gqa=H != Hkv)
    dot = do.transpose(1, 2)
    lib_ms, lib_by = device_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    pairs = int(allowed.sum().item()) * H     # (row, col) pairs computed
    esz = q.element_size()
    # both read q, k, v, do, lse, delta, the mask and the segment ids once
    # (the dk/dv kernel sums each group's heads in registers, so there is
    # no buffer of partials); dq writes dq, dkv writes dk and dv
    read = (2 * q.numel() + k.numel() + v.numel()) * esz + 2 * B * H * S * 4 \
        + (mask.numel() * 4 if mask is not None else 0) \
        + (B * S * 4 if n_seg else 0)
    rows = []
    for kernel, ms, ms_by, products, written, keys in (
            ("K2-dq", dq_ms, dq_by, 3, q.numel() * esz, ("dq",)),
            ("K2-dkv", dkv_ms, dkv_by, 4, 2 * k.numel() * esz,
             ("dk", "dv"))):
        flops = 2.0 * products * D * pairs
        bound_ms, by = bound(flops, read + written, dn)
        row = dict(phase="kernel", kernel=kernel, case=name, dtype=dn,
                   shape=dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window,
                              pad=pad, segments=n_seg, causal=causal,
                              padded_tails=padded_tails(lengths, S)),
                   max_abs_err=max(errs[x][0] for x in keys),
                   max_rel_err_per_row=max(errs[x][1] for x in keys),
                   tol=TOL[dn], design=design_of(flash, (kernel, dtype)),
                   kernel_ms=ms,
                   plain_ms=plain_ms, plain_is="dq, dk and dv together",
                   library_ms=lib_ms,
                   library_is="SDPA backward (dq, dk, dv) through autograd",
                   timed_by=ms_by, library_timed_by=lib_by,
                   tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
                   bound_us=bound_ms * 1e3, bound_by=by)
        emit(row)
        rows.append(row)
    return rows


def flash_main_cases(torch, F, flash):
    """K1-fwd and K2 in bf16 at the main paths' shapes, each held to its
    plain version and timed: the llama-7b prefill, the gpt2-1.5b training
    step, and the BERT path's mode (non-causal, with the padding mask of
    its batch, a quarter of the rows ending in padding, as the key mask, at
    bert-large's attention, 16 heads of 64, seq 512, batch 32), and K2 at
    head dim 128 (llama-7b's width). The main run and ``--ab`` both time
    these rows."""
    bf16 = torch.bfloat16
    bert_lengths = mlm_batch(np.random.default_rng(0), 30522, 32, 512)[
        "attention_mask"].sum(-1).tolist()
    return {
        "llama": flash_case(torch, F, flash, "llama-7b prefill", 4, 512, 32,
                            32, 128, bf16),
        "gpt2": flash_case(torch, F, flash, "gpt2-1.5b train", 16, 1024, 25,
                           25, 64, bf16, iters=10),
        "gpt2 bwd": flash_bwd_case(torch, F, flash, "gpt2-1.5b train", 16,
                                   1024, 25, 25, 64, bf16),
        "bert": flash_case(torch, F, flash, "bert-large train, padded tails",
                           32, 512, 16, 16, 64, bf16, iters=10, causal=False,
                           lengths=bert_lengths),
        "bert bwd": flash_bwd_case(torch, F, flash, "bert-large train, "
                                   "padded tails", 32, 512, 16, 16, 64, bf16,
                                   causal=False, lengths=bert_lengths),
        "llama bwd": flash_bwd_case(torch, F, flash, "llama-7b width", 2,
                                    2048, 32, 32, 128, bf16)}


def plan_of(int8mm, M, N, K, dtype):
    """K4's plan for this shape on this card, where the checkout's wrapper
    has one (``--ab`` may time one that has not)."""
    if not hasattr(int8mm, "plan"):
        return None
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int8mm.plan(M, N, K, 0 if dtype == torch.float32 else 1,
                       sms)._asdict()


def int8mm_case(torch, int8mm, name, M, K, N, dtype, iters=50):
    """K4 on x [M, K] and a weight quantized from normal(0, 0.02) as
    ``quantize_weights_int8`` does, against its plain version in float32;
    timed over rotating weight copies (cold in L2, as in a decode step),
    by ``graph_ms`` (a decode launch takes less time on the card than its
    wrapper takes on the host); ``kernel_ms_eager`` is ``time_ms``'s
    reading of the same launches, host included."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)

    def make():
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        scale = w.abs().amax(0, keepdim=True) / 127.0 + 1e-12
        q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
        return q, scale, (q.to(dtype) * scale.to(dtype))
    weights = Rotor(make, K * N * (1 + dtype.itemsize))
    q, scale, _ = weights.copies[0]
    out = int8mm.int8_matmul(x, q, scale)
    again = int8mm.int8_matmul(x, q, scale)
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"int8_matmul {name}: two launches give different bits")
    ref = int8mm.int8_matmul_reference(x.float(), q, scale)
    diff = (out.float() - ref).abs()
    err, top = diff.max().item(), ref.abs().max().item()
    rel = (diff.amax(1) / ref.abs().amax(1)).max().item()
    dn = str(dtype).split(".")[-1]
    # a sum over K products: the largest error is held relative to the
    # largest output, as for the gradients of K2
    check(err <= TOL[dn] * max(1.0, top) and rel <= TOL[dn],
          f"int8_matmul {name}: max |out - plain| {err} (held to {TOL[dn]} x "
          f"{max(1.0, top)}), per row relative {rel} (tol {TOL[dn]})")

    def kern():
        qq, ss, _ = weights.next()
        return int8mm.int8_matmul(x, qq, ss)

    def plain():
        qq, ss, _ = weights.next()
        return int8mm.int8_matmul_reference(x, qq, ss)

    def library():
        return torch.matmul(x, weights.next()[2])
    eager_ms = time_ms(torch, kern, iters)
    ms = graph_ms(torch, kern, iters)
    plain_ms = graph_ms(torch, plain, max(2, iters // 5))
    lib_ms = graph_ms(torch, library, iters)
    torch.cuda.empty_cache()
    esz = x.element_size()
    # x read, the int8 weight and its scales read, out written, once each
    nbytes = M * K * esz + K * N + N * 4 + M * N * esz
    bound_ms, by = bound(2.0 * M * N * K, nbytes, dn)
    row = dict(phase="kernel", kernel="K4", case=name, dtype=dn,
               shape=dict(M=M, K=K, N=N), max_abs_err=err,
               max_rel_err_per_row=rel, largest_output=top, tol=TOL[dn],
               kernel_ms=ms, kernel_ms_eager=eager_ms, plain_ms=plain_ms,
               library_ms=lib_ms, timed_by="graph", library_timed_by="graph",
               tflops=2.0 * M * N * K / ms / 1e9, vs_library=ms / lib_ms,
               plan=plan_of(int8mm, M, N, K, dtype),
               library_is="torch.matmul on the weight dequantized to "
                          f"{dn}", weight_copies=len(weights.copies),
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


def bs_case(torch, F, sa, name, section, B, S, H, D, dtype, iters=10):
    """K5 against the gather version (float32, on the same inputs) for the
    layout that an engine config's ``sparse_attention`` section builds:
    the largest error and the error per query row relative to its own
    scale; two launches must give the same bits. Timed against the gather
    version in the input dtype and against SDPA with the layout expanded
    to a boolean [H, S, S] mask (what ``blocksparse_reference`` computes),
    the kernel and SDPA by ``device_ms`` alike; the bound counts the
    (query, key) pairs the layout keeps. The tensor-core design's row also
    gives its work list: CTAs per batch row and the row groups whose
    union was split over CTAs."""
    from deepspeed_tpu_torch.ops.sparse_attention.blocksparse import \
        blocksparse_attention_gather
    from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig
    cfg = sa.build_sparsity_config(SparseAttentionConfig.from_dict(section),
                                   num_heads=H)
    causal = getattr(cfg, "attention", "bidirectional") == "unidirectional"
    layout = cfg.make_layout(S)
    block = cfg.block
    lut, valid = sa.make_lut(layout)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)
               for _ in range(3))

    def kern():
        return sa.blocksparse_attention_kernel(q, k, v, lut, valid, block,
                                               causal=causal)
    o, again = kern(), kern()
    torch.cuda.synchronize()
    check(torch.equal(o, again),
          f"blocksparse {name}: two launches give different bits")
    ref = blocksparse_attention_gather(q.float(), k.float(), v.float(),
                                       lut, valid, block, causal=causal)
    diff = (o.float() - ref).abs()
    err = diff.max().item()
    rel = (diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-6)).max().item()
    dn = str(dtype).split(".")[-1]
    check(err <= TOL[dn] and rel <= TOL[dn],
          f"blocksparse {name}: max |o - plain| {err}, per row relative "
          f"{rel} (tol {TOL[dn]})")
    del ref, diff, again
    ms, ms_by = device_ms(torch, kern, iters)
    plain_ms = time_ms(torch, lambda: blocksparse_attention_gather(
        q, k, v, lut, valid, block, causal=causal), 2)
    lay = torch.from_numpy(layout).to(dev).bool()
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    pairs = int(mask.sum().item()) * B        # (row, col) pairs kept
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms, lib_by = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None]), iters)
    del mask
    design = design_of(sa.blocksparse, dtype)
    work = {}
    if design == "mma":
        plan = sa.blocksparse.block_table(lut, valid).plan(block)
        work = dict(ctas_per_batch_row=len(plan.work),
                    split_groups=plan.split_groups,
                    row_groups=int(plan.unnz.size),
                    median_union_blocks=float(np.median(plan.unnz)))
    # q, k, v read and o written once, the table and the counts read
    nbytes = 4 * q.numel() * q.element_size() + lut.nbytes \
        + lut.shape[0] * lut.shape[1] * 4
    flops = 4.0 * D * pairs
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel="K5", case=name, dtype=dn,
               shape=dict(B=B, S=S, H=H, D=D, block=block, causal=causal,
                          L=int(lut.shape[-1]),
                          mean_active_blocks_per_row=float(
                              valid.sum(-1).mean())),
               section=section, density=float(sa.sparse_density(layout)),
               max_abs_err=err, max_rel_err_per_row=rel, tol=TOL[dn],
               design=design, **work,
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_is="SDPA with the layout as a boolean [H, S, S] mask",
               timed_by=ms_by, library_timed_by=lib_by,
               tflops=flops / ms / 1e9, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by, gflop=flops / 1e9)
    emit(row)
    return row


def paged_case(torch, F, paged, gpt, name, B, Hkv, group, D, bs, lengths,
               dtype, q_len=1, window=None, NB=128, iters=50, int8=False):
    """K3 against its plain version; ``int8``: int8 pools with random
    positive per-(block, head) scales (the int8-pool mode). The kernel and
    SDPA are timed by CUDA graph replay (``graph_ms``): a decode-step
    launch is about as short on the card as its wrapper on the host, so
    events over eager calls would time the host (``device_ms`` flips
    between the two timers at these lengths); the row names the timer."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N = B * NB + 1
    kp = torch.randn((N, bs, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((N, bs, Hkv, D), generator=g, device=dev).to(dtype)
    q = torch.randn((B, q_len, Hkv, group, D), generator=g,
                    device=dev).to(dtype)
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = perm.reshape(B, NB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    kw = dict(scale=scale, window=window)
    if int8:
        kp, vp = (torch.randint(-127, 128, (N, bs, Hkv, D), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        kw.update(k_scale=(0.5 + torch.rand((N, Hkv), generator=g,
                                            device=dev)) / 127.0,
                  v_scale=(0.5 + torch.rand((N, Hkv), generator=g,
                                            device=dev)) / 127.0)
    f32 = (lambda t: t) if int8 else (lambda t: t.float())
    if q_len == 1:
        def kern():
            return paged.paged_decode_attention(q[:, 0], kp, vp, tables, lens,
                                                **kw)

        def plain(qq=q, kk=kp, vv=vp):
            return paged.paged_decode_reference(qq[:, 0], kk, vv, tables,
                                                lens, **kw)
    else:
        def kern():
            return paged.paged_verify_attention(q, kp, vp, tables, lens, **kw)

        def plain(qq=q, kk=kp, vv=vp):
            return paged.paged_verify_reference(qq, kk, vv, tables, lens,
                                                **kw)
    out = kern()
    ref = plain(q.float(), f32(kp), f32(vp))

    def slot_rel(x):          # per slot, relative to that slot's scale
        d = (x.float() - ref).abs().reshape(B, -1).amax(1)
        return (d / ref.abs().reshape(B, -1).amax(1)).max().item()
    err = (out.float() - ref).abs().max().item()
    rel = slot_rel(out)
    # the plain version in the kernel's dtype, against the same fp32
    # reading: the rounding a bf16 path shows anyway (information)
    plain_rel = slot_rel(plain())
    dn = str(dtype).split(".")[-1]
    kname = "K3-int8" if int8 else "K3"
    design = design_of(paged, ("verify" if q_len > 1 else "decode", dtype,
                               "int8" if int8 else "float"))
    check(err <= TOL[dn] and rel <= TOL[dn],
          f"paged {kname} {name}: max |out - plain| {err}, per slot relative "
          f"{rel} (tol {TOL[dn]}; the plain version in {dn}: {plain_rel})")
    ms = graph_ms(torch, kern, iters)
    plain_ms = time_ms(torch, plain, max(2, iters // 10))
    # library yardstick: SDPA over the cache gathered through the tables
    # (and dequantized to q's dtype), gathered before the timing
    H = Hkv * group

    def gathered(pool, spool):
        c = pool[tables.long()]
        if int8:
            c = c.float() * spool[tables.long()][:, :, None, :, None]
        return c.to(dtype).reshape(B, NB * bs, Hkv, D).transpose(1, 2)
    kc = gathered(kp, kw.get("k_scale"))
    vc = gathered(vp, kw.get("v_scale"))
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, H, q_len, D)
    col = torch.arange(NB * bs, device=dev)
    qpos = lens[:, None].long() + torch.arange(q_len, device=dev)[None]
    allowed = col[None, None] <= qpos[:, :, None]
    if window is not None:
        allowed = allowed & (col[None, None] > qpos[:, :, None] - window)
    lib_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=allowed[:, None], scale=scale,
        enable_gqa=group > 1), iters)
    # work this run's data needs: blocks lo..hi of every slot
    blocks = tokens = 0
    for L in lengths:
        hi = min((L + q_len - 1) // bs, NB - 1)
        lo = 0 if window is None else min(max((L - window + 1) // bs, 0),
                                          NB - 1)
        blocks += hi - lo + 1
        tokens += (hi - lo + 1) * bs
    # one layer of this geometry: K+V of the occupied blocks, read once,
    # then q read and out written, the table entries and lengths read
    layer = gpt.GPTConfig(n_layers=1, n_heads=Hkv * group, n_kv_heads=Hkv,
                          d_model=Hkv * group * D)
    nbytes = paged.paged_hbm_bytes_per_token(
        layer, 1, tokens, kp.dtype, block_size=bs,
        scale_bytes_per_block=2 * Hkv * 4 if int8 else 0) \
        + 2 * q.numel() * q.element_size() + blocks * 4 + B * 4
    flops = 4.0 * tokens * Hkv * group * q_len * D
    bound_ms, by = bound(flops, nbytes, dn)
    row = dict(phase="kernel", kernel=kname, case=name, dtype=dn,
               design=design,
               shape=dict(B=B, Hkv=Hkv, group=group, D=D, block=bs, NB=NB,
                          q_len=q_len, window=window, lengths=list(lengths)),
               max_abs_err=err, max_rel_err_per_slot=rel,
               plain_max_rel_err_per_slot=plain_rel, tol=TOL[dn],
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               timed_by="graph", library_timed_by="graph",
               gb_per_s=nbytes / ms / 1e6, vs_library=ms / lib_ms,
               bound_us=bound_ms * 1e3, bound_by=by)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

# the serve phase's llama-7b depth, shared by the phases on its engine
# (lora, horizon, prefix, host_tier, spec, chaos and the router's): 16 of
# 32 layers, for the run's time
SERVE_LAYERS = 16


def serve_phase(torch, flash, paged, gpt, init_inference, serving):
    cfg = gpt.preset("llama-7b", n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng = init_inference(model=(cfg, params), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()

    def launches():
        return kernel_launches(flash, paged)

    # generate: 4 prompts of 512 tokens, 32 new
    prompts = rng.integers(1, cfg.vocab_size, (4, 512)).astype(np.int32)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = launches()
    check(gen.shape == (4, 544), f"generate returned {gen.shape}")
    check(gen_launches["K1-fwd"] > 0 and gen_launches["K3"] == 0,
          f"generate should launch K1-fwd and not K3: {gen_launches}")

    # serving: 16 requests through 8 slots, chunked prefill
    lens = rng.integers(64, 1025, 16)
    reqs = [serving.ServeRequest(
        rid=i, prompt=rng.integers(1, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=64, logprobs=True) for i, n in enumerate(lens)]
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256)
    reset_launches(flash, paged)
    t_submit = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    step_end = []                  # wall instant each scheduler step ended
    while srv.busy:
        srv.step()                 # tokens are stamped with the step index
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
    serve_s = step_end[-1] - t_submit
    serve_launches = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # after the drain's peak is read: the capture keeps a static cache
    fused = fused_generate(torch, flash, paged, eng, prompts, gen)

    done = {r.rid: r for r in srv.finished}
    check(len(done) == 16, f"{len(done)} of 16 requests finished")
    short = [r.rid for r in reqs if len(r.out) != 64]
    check(not short, f"requests {short} did not produce 64 tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), "non-finite logprobs (logits) in serving")
    check(serve_launches["K3"] > 0,
          f"the serving drain never launched K3: {serve_launches}")
    with torch.inference_mode():
        logits, _ = eng._prefill_fn(torch.as_tensor(prompts[:1].astype(
            np.int64), device=eng.device))
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    ttft = [step_end[int(r.first_token_at)] - t_submit for r in reqs]
    tpot = [step_end[int(b)] - step_end[int(a)] for r in reqs
            for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)

    # greedy agreement of the first 4 served streams with a solo generate
    # (4 of the 16: cut for the run's time)
    agree = []
    for r in reqs[:4]:
        ref = eng.generate(r.prompt[None], max_new_tokens=64)[0, len(r.prompt):]
        same = np.asarray(r.out) == ref
        agree.append(int(np.argmin(same)) if not same.all() else 64)
    row = dict(phase="serve", model="llama-7b", layers=cfg.n_layers,
               dtype="bfloat16", params=gpt.num_params(cfg),
               init_s=init_s, generate=dict(batch=4, prompt=512, new=32,
                                            seconds=gen_s,
                                            tokens_per_s=4 * 32 / gen_s,
                                            launches=gen_launches),
               generate_fused=fused,
               requests=16, prompt_lens=[int(x) for x in lens],
               new_tokens=n_tok, seconds=serve_s,
               tokens_per_s=n_tok / serve_s,
               ttft_s_p50=float(np.percentile(ttft, 50)),
               ttft_s_p99=float(np.percentile(ttft, 99)),
               tpot_s_p50=float(np.percentile(tpot, 50)),
               tpot_s_p99=float(np.percentile(tpot, 99)),
               peak_mem_gib=peak_gb, launches=serve_launches,
               stats=dict(srv.stats), cache=srv.cache.stats(),
               greedy_prefix_agreement_first_4=agree,
               greedy_full_agreement_first_4=sum(a == 64 for a in agree))
    emit(row)
    del srv
    off = trace_phase(torch, eng, serving, rng)
    on = trace_phase(torch, eng, serving, rng, telemetry=True,
                     what="llama-7b bf16, telemetry on")
    telemetry_cost_phase(torch, eng, serving, rng, off, on)
    # each kernel's count from the path that runs it; the engine and the
    # requests stay for the lora, horizon, prefix, host-tier and spec
    # phases, the drain as the lora phase's LoRA-off side
    base = dict(reqs=reqs, launches=serve_launches,
                drain=drain_row(step_end, t_submit, reqs))
    return {"K1-fwd": gen_launches["K1-fwd"],
            "K3": serve_launches["K3"]}, eng, reqs, base


def fused_generate(torch, flash, paged, eng, prompts, gen):
    """``generate_fused`` on ``generate``'s prompts: its first call
    captures the 31-step decode loop into a CUDA graph, the second only
    replays it; each must give ``generate``'s tokens ``gen`` bit for bit
    (the same launches replay). ``forward``'s last-position logits against
    the static prefill's, to the bf16 tolerance (its head runs the same
    weights at another product shape). The engine's ``latency_ms`` after
    each call; the capture's buffers (a static cache of ~4.3 GB) are freed
    after."""
    out, ms = [], []
    for _ in range(2):
        reset_launches(flash, paged)
        out.append(eng.generate_fused(prompts, max_new_tokens=32))
        torch.cuda.synchronize()
        ms.append(dict(eng.latency_ms, launches=kernel_launches(flash, paged)))
    for i, got in enumerate(out):
        check(np.array_equal(got, gen),
              f"generate_fused call {i + 1}: its tokens part from generate's "
              f"at {int(np.argmin((got == gen).all(0)))}")
    check(len(eng._fused) == 1, f"generate_fused kept {len(eng._fused)} "
          f"captures for one key")
    with torch.inference_mode():
        tok = torch.as_tensor(prompts.astype(np.int64), device=eng.device)
        full = eng.forward(prompts)[:, -1].float()
        last = eng._prefill_fn(tok)[0][:, -1].float()
    check(tuple(full.shape) == (4, eng.cfg.vocab_size)
          and bool(torch.isfinite(full).all()), "non-finite forward logits")
    rel = ((full - last).abs().max() / last.abs().max()).item()
    check(rel <= TOL["bfloat16"], f"forward's last logits {rel} of their "
          f"scale from the prefill's (tol {TOL['bfloat16']})")
    eng._fused.clear()
    torch.cuda.empty_cache()
    return dict(tokens_equal_generate=True, first_call=ms[0],
                replay_call=ms[1],
                forward_ms=eng.latency_ms["forward"],
                forward_last_logits_rel_to_prefill=rel,
                forward_last_logits_bit_equal=bool(torch.equal(full, last)),
                decode_per_token_ms=ms[1]["decode_per_token"],
                decode_per_token_fused_ms=ms[1]["decode_per_token_fused"])


def warm_decoder(torch, serving, eng, rng, new, adapters=None, **kw):
    """An 8-slot engine over ``eng`` with 8 requests of 512 seeded tokens
    and ``new`` new tokens each, stepped until every slot decodes and
    once more. ``adapters`` (``{id: export}``): LoRA serving on with them
    registered, 6 of the 8 slots under them (``lora_requests``).
    Returns (server, requests)."""
    V = eng.cfg.vocab_size
    if adapters is not None:
        kw = dict(kw, lora_pool_blocks=6, **LORA_POOL)
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, **kw)
    prompts = [rng.integers(1, V, 512).astype(np.int32) for i in range(8)]
    if adapters is None:
        reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
    else:
        for aid, sd in adapters.items():
            srv.register_adapter(aid, sd)
        reqs = lora_requests(serving, prompts, sorted(adapters), new=new)
    for r in reqs:
        srv.submit(r)
    while not all(r is not None and r.state == "decode" for r in srv.slots):
        srv.step()
    srv.step()
    torch.cuda.synchronize()
    return srv, reqs


def timed_steps(torch, srv, reqs, steps, want):
    """``steps`` scheduler steps, waited for: (wall s, host CPU s, tokens
    emitted), which must be ``want``."""
    n0 = sum(len(r.out) for r in reqs)
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(steps):
        srv.step()
    torch.cuda.synchronize()
    wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    n = sum(len(r.out) for r in reqs) - n0
    check(n == want, f"a timed window emitted {n} tokens, not {want}")
    return wall, cpu, n


TRACE_DIR = os.path.join(REPO, "build", "chip_smoke_traces")
# the device's events in a Chrome trace of torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# K3's launches in a trace: its split and verify kernels (the combine
# kernel follows some of them and is not counted by the wrapper either)
K3_KERNELS = ("paged_split_kernel", "paged_verify_mma_kernel")


def read_trace(path):
    """The complete events (``ph`` X) of a Chrome trace the port wrote."""
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def trace_summary(events, per=1):
    """What a traced window's events say, per ``per`` (steps): its wall
    (first event to the end of the last, host and device), the device's
    busy time (the sum of its events' own time), its events and top
    kernels, the aten calls on the host and the top ones by calls (their
    times include their children's), and K3's launches."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    wall_ms = (max(e["ts"] + e.get("dur", 0) for e in events)
               - min(e["ts"] for e in events)) / 1e3
    busy_ms = sum(e.get("dur", 0) for e in dev) / 1e3
    check(busy_ms > 0, "the trace holds no device time")

    def top(evs, n):
        by = {}
        for e in evs:
            t = by.setdefault(e["name"][:80], [0.0, 0])
            t[0] += e.get("dur", 0) / 1e3
            t[1] += 1
        return sorted(by.items(), key=lambda kv: (-kv[1][0], kv[0]))[:n]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                device_events_per_step=len(dev) / per,
                aten_calls_per_step=len(ops) / per,
                k3_launches=sum(any(k in e["name"] for k in K3_KERNELS)
                                for e in dev),
                top_device=[dict(name=k, ms_per_step=ms / per,
                                 calls_per_step=n / per)
                            for k, (ms, n) in top(dev, 10)],
                top_host=[dict(op=k, ms_per_step_with_children=ms / per,
                               calls_per_step=n / per)
                          for k, (ms, n) in sorted(
                              top(ops, 10 ** 6),
                              key=lambda kv: (-kv[1][1], kv[0]))[:10]])


def profiled_steps(torch, srv, reqs, steps, want):
    """``steps`` scheduler steps inside ``srv.capture_profile`` (the
    port's trace capture), read back from the Chrome trace it wrote: the
    window's wall, tokens, device busy ms (the device events' own time),
    and per step the device events, the aten calls and the top device
    kernels and host ops. The K3 kernels in the trace must be the
    launches K3's counters saw in the window."""
    from deepspeed_tpu_torch.ops.attention import paged
    n0 = sum(len(r.out) for r in reqs)
    counters = ("launches", "int8_launches", "verify_launches",
                "int8_verify_launches")
    k0 = sum(getattr(paged.paged_attention, c) for c in counters)
    srv.capture_profile(steps, TRACE_DIR)
    k3 = sum(getattr(paged.paged_attention, c) for c in counters) - k0
    tokens = sum(len(r.out) for r in reqs) - n0
    check(tokens == want, f"a traced window emitted {tokens} tokens, not "
                          f"{want}")
    t = trace_summary(read_trace(srv.last_trace), per=steps)
    check(t["k3_launches"] == k3 > 0,
          f"the trace of {steps} decode steps holds {t['k3_launches']} K3 "
          f"kernels, the counters saw {k3}")
    return dict(steps=steps, tokens=tokens, trace=srv.last_trace,
                wall_ms_per_step=t["wall_ms"] / steps,
                device_busy_ms_per_step=t["device_busy_ms"] / steps,
                device_idle_share=t["device_idle_share"],
                device_events_per_step=t["device_events_per_step"],
                aten_calls_per_step=t["aten_calls_per_step"],
                wall_ms_per_token=t["wall_ms"] / tokens,
                device_busy_ms_per_token=t["device_busy_ms"] / tokens,
                aten_calls_per_token=t["aten_calls_per_step"] * steps
                / tokens,
                k3_launches_in_trace=t["k3_launches"], k3_launches_counted=k3,
                top_device=t["top_device"], top_host=t["top_host"])


def trace_phase(torch, eng, serving, rng, steps=4, kv_quant="off",
                what="llama-7b bf16", decode_horizon=1, telemetry=False):
    """Where a steady decode step's time goes: 8 slots decoding at ~520
    tokens each, ``steps`` scheduler steps (each a horizon of
    ``decode_horizon`` tokens per slot) first untraced (wall and host CPU
    time per emitted token), then under torch.profiler; device busy time
    is the sum of the device events' own time. ``telemetry``: the serving
    telemetry on, its breakdown sampling every 4th step. Returns the
    row."""
    from deepspeed_tpu_torch.telemetry import Telemetry
    N = decode_horizon
    srv, reqs = warm_decoder(
        torch, serving, eng, rng, (2 * steps + 4) * N + 4,
        kv_quant=kv_quant, decode_horizon=N,
        telemetry=Telemetry(sample_every=4) if telemetry else False)
    plain_wall, plain_cpu, plain_tokens = timed_steps(torch, srv, reqs,
                                                      steps, 8 * N * steps)
    row = dict(phase="trace", what="steady decode step, 8 slots, ~520 "
                                   f"tokens each, {what}",
               telemetry=telemetry, decode_horizon=N,
               **profiled_steps(torch, srv, reqs, steps, 8 * N * steps),
               untraced=dict(wall_ms_per_token=plain_wall * 1e3
                             / plain_tokens,
                             host_cpu_ms_per_token=plain_cpu * 1e3
                             / plain_tokens,
                             wall_ms_per_step=plain_wall * 1e3 / steps))
    emit(row)
    del srv
    return row


def telemetry_cost_phase(torch, eng, serving, rng, off_trace, on_trace,
                         pairs=3, steps=4):
    """What the serving telemetry costs a steady decode step on the host:
    two 8-slot engines over the serve phase's weights, telemetry off and
    on (the breakdown sampling every 4th step), both decoding at ~520
    tokens, timed in windows of ``steps`` steps in turns, ``pairs`` pairs
    (which side goes first alternates, as the host's speed drifts): wall
    and host CPU ms per emitted token per window, the on/off ratio of each
    pair. Aten calls per token come from the two ``trace`` rows (the
    profiler's count), the breakdown's phase shares from the on side's
    sampled steps inside the windows."""
    from deepspeed_tpu_torch.telemetry import PHASES, Telemetry
    V = eng.cfg.vocab_size
    sides = {}
    for on in (False, True):
        srv = serving.ServingEngine(
            eng, num_slots=8, block_size=16, num_blocks=8 * 40,
            prefill_chunk=256,
            telemetry=Telemetry(sample_every=4) if on else False)
        reqs = [serving.ServeRequest(
            rid=i, prompt=rng.integers(1, V, 512).astype(np.int32),
            max_new_tokens=pairs * steps + 8) for i in range(8)]
        for r in reqs:
            srv.submit(r)
        while not all(s is not None and s.state == "decode"
                      for s in srv.slots):
            srv.step()
        srv.step()
        sides[on] = (srv, reqs)
    hists = sides[True][0].metrics._histograms
    sums0 = {ph: hists[f"serving_step_{ph}_s"].sum for ph in PHASES}
    n_sampled0 = hists["serving_step_s"].count
    torch.cuda.synchronize()
    per = {False: [], True: []}
    for p in range(pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            srv, reqs = sides[on]
            n0 = sum(len(r.out) for r in reqs)
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(steps):
                srv.step()
            torch.cuda.synchronize()
            n = sum(len(r.out) for r in reqs) - n0
            check(n == 8 * steps, f"telemetry_cost: a window emitted {n} "
                  f"tokens, not {8 * steps}")
            per[on].append(((time.perf_counter() - t0) * 1e3 / n,
                            (time.process_time() - c0) * 1e3 / n))
    sums = {ph: hists[f"serving_step_{ph}_s"].sum - sums0[ph]
            for ph in PHASES}
    total = sum(sums.values())
    check(total > 0, "telemetry_cost: no sampled step inside the windows")
    wall = {on: [w for w, _ in per[on]] for on in per}
    cpu = {on: [c for _, c in per[on]] for on in per}
    ratios = [a / b for a, b in zip(wall[True], wall[False])]
    emit(dict(phase="telemetry_cost", decode_horizon=1, pairs=pairs,
              steps_per_window=steps, sample_every=4,
              wall_ms_per_token_off=wall[False],
              wall_ms_per_token_on=wall[True],
              host_cpu_ms_per_token_off=cpu[False],
              host_cpu_ms_per_token_on=cpu[True],
              median_wall_ms_per_token_off=float(np.median(wall[False])),
              median_wall_ms_per_token_on=float(np.median(wall[True])),
              median_host_cpu_ms_per_token_off=float(np.median(cpu[False])),
              median_host_cpu_ms_per_token_on=float(np.median(cpu[True])),
              wall_on_over_off_per_pair=ratios,
              median_wall_on_over_off=float(np.median(ratios)),
              pairs_on_slower=sum(r > 1.0 for r in ratios),
              aten_calls_per_token_off=off_trace["aten_calls_per_token"],
              aten_calls_per_token_on=on_trace["aten_calls_per_token"],
              sampled_steps_in_windows=hists["serving_step_s"].count
              - n_sampled0,
              breakdown_shares={ph: v / total for ph, v in sums.items()}))
    del sides


def agreement_phase(torch, gpt, init_inference, serving):
    """The same model in float32 (the bf16 weights are its rounding):
    served streams against solo generate, where rounding noise is ~1e-7
    instead of bf16's ~4e-3, to tell numeric divergence from a bug. At
    16 of llama-7b's 32 layers (cut for the run's time)."""
    cfg = gpt.preset("llama-7b", n_layers=16)
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    eng = init_inference(model=(cfg, params), dtype=torch.float32)
    rng = np.random.default_rng(0)
    rng.integers(1, cfg.vocab_size, (4, 512))      # the phase-3 draws, in order
    lens = rng.integers(64, 1025, 16)[:4]
    reqs = [serving.ServeRequest(
        rid=i, prompt=rng.integers(1, cfg.vocab_size, n).astype(np.int32),
        max_new_tokens=32) for i, n in enumerate(lens)]
    srv = serving.ServingEngine(eng, num_slots=4, block_size=16,
                                prefill_chunk=256)
    srv.run(reqs)
    refs = [eng.generate(r.prompt[None], max_new_tokens=32)[0] for r in reqs]
    agree = [agreed(r.out, ref[len(r.prompt):]) for r, ref in zip(reqs, refs)]
    check(all(len(r.out) == 32 for r in reqs), "fp32 serving lost tokens")
    check(all(a == 32 for a in agree),
          f"fp32 served streams differ from solo generate after "
          f"{agree} of 32 tokens")
    # the verify mode at full depth: speculation with a drafter proposing
    # the solo streams, one token changed in turn (whole, partial and no
    # acceptance), gives the solo streams too
    sreqs = [serving.ServeRequest(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=32) for r in reqs]
    srv = serving.ServingEngine(eng, num_slots=4, block_size=16,
                                prefill_chunk=256, spec_decode=True,
                                spec_k=4,
                                spec_draft=StreamDraft(refs, cfg.vocab_size))
    srv.run(sreqs)
    spec_agree = agreement(reqs, sreqs)
    check(all(len(r.out) == 32 for r in sreqs)
          and srv.stats["spec_accepted"] > 0,
          f"fp32 speculative serving lost tokens or accepted nothing: "
          f"{spec_stats(srv)}")
    check(all(a == 32 for a in spec_agree),
          f"fp32 speculative streams differ from solo generate after "
          f"{spec_agree} of 32 tokens")
    emit(dict(phase="agreement", model="llama-7b", layers=cfg.n_layers,
              dtype="float32",
              requests=4, new_tokens=32, greedy_prefix_agreement=agree,
              greedy_full_agreement=sum(a == 32 for a in agree),
              spec=dict(spec_k=4, drafter="the solo streams, one token "
                                          "changed in turn",
                        greedy_prefix_agreement=spec_agree,
                        stats=spec_stats(srv))))
    del eng, params, srv
    torch.cuda.empty_cache()


def serve_fp16_phase(torch, flash, paged, gpt, init_inference, serving,
                     tree):
    """K3's float16 mode on a serving path: llama-7b at full width cut to
    4 of its 32 layers (for the run's time), one set of random weights
    from seed 0 served in float16 and in bfloat16, 4 requests with the
    serve phase's first prompt lengths, 32 new tokens, 4 slots. Each
    drain runs with the launch counters zeroed just before it; the
    float16 one must launch K3 once per layer and decode step and no other
    K3 mode; the float16 engine over int8 KV blocks (a drain and a
    speculative drain) K3's int8-pool modes with a float16 q only. Its
    streams' agreement with the bfloat16 ones is reported (two roundings
    of the same model). The first step's logits (the static
    prefill of a 64-token prompt) in float16 on the card are held to
    FP16_TOL of their scale against float32 on the host, same weights;
    bfloat16's distance is reported beside them."""
    cfg = gpt.preset("llama-7b", n_layers=4)
    L, V = cfg.n_layers, cfg.vocab_size
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    engines = {name: init_inference(model=(cfg, params),
                                    dtype=getattr(torch, name))
               for name in ("float16", "bfloat16")}
    rng = np.random.default_rng(0)
    rng.integers(1, V, (4, 512))           # the serve phase's draws, in order
    lens = rng.integers(64, 1025, 16)[:4]
    prompts = [rng.integers(1, V, n).astype(np.int32) for n in lens]
    runs, streams = {}, {}
    for name, eng in engines.items():
        reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=32,
                                     logprobs=True)
                for i, p in enumerate(prompts)]
        srv = serving.ServingEngine(eng, num_slots=4, block_size=16,
                                    prefill_chunk=256)
        check(srv.cache.k.dtype == getattr(torch, name),
              f"{name} serving built {srv.cache.k.dtype} pools")
        reset_launches(flash, paged)
        step_end, t_submit = drain(torch, srv, reqs)
        launches = kernel_launches(flash, paged)
        lps = np.array([lp for r in reqs for lp in r.out_logprobs])
        check(all(len(r.out) == 32 for r in reqs) and np.isfinite(lps).all(),
              f"{name} serving lost tokens or gave non-finite logprobs")
        n_dec = srv.stats["decode_steps"]
        others = {k: v for k, v in launches.items()
                  if k.startswith("K3") and k != "K3" and v}
        check(launches["K3"] == L * n_dec > 0 and not others,
              f"{name} drain: K3 launched {launches['K3']} times for "
              f"{n_dec} decode steps of {L} layers; others {others}")
        runs[name] = dict(drain_row(step_end, t_submit, reqs),
                          decode_steps=n_dec, launches=launches)
        streams[name] = reqs
        del srv
    agree = agreement(streams["float16"], streams["bfloat16"])
    # K3-fp16's verify mode on a path: a speculative drain (n-gram, spec_k
    # 4) of four prompts of repeated spans on the float16 engine
    srng = np.random.default_rng(4)
    sprompts = [repeating(srng, V, n) for n in srng.integers(64, 513, 4)]
    sreqs, srv, spec_row, spec_launches = serve_drain(
        torch, flash, paged, serving, engines["float16"], sprompts, new=32,
        spec_decode=True, spec_k=4)
    others = {k: v for k, v in spec_launches.items()
              if k.startswith("K3") and k not in ("K3", "K3-verify") and v}
    check(spec_launches["K3-verify"] > 0 and not others,
          f"the float16 spec drain should launch K3's float16 verify mode: "
          f"{spec_launches}")
    runs["float16_spec"] = dict(spec_row, launches=spec_launches,
                                stats=spec_stats(srv), requests=4)
    del srv
    # K3's int8-pool mode with a float16 q on a path: the float16 engine
    # over int8 KV blocks, the same 4 requests (its decode mode) and the
    # same speculative drain (its verify mode); no float K3 mode
    int8_launches = {}
    for name, drain_prompts, kw in (
            ("float16_int8", prompts, {}),
            ("float16_int8_spec", sprompts,
             dict(spec_decode=True, spec_k=4))):
        ireqs, srv, row, launches = serve_drain(
            torch, flash, paged, serving, engines["float16"], drain_prompts,
            new=32, kv_quant="int8", **kw)
        want = "K3-int8-verify" if kw else "K3-int8"
        others = {k: v for k, v in launches.items() if k.startswith("K3")
                  and k not in (want, "K3-int8") and v}
        check(srv.cache.k.dtype == torch.int8 and launches[want] > 0
              and not others,
              f"the float16 {name} drain should launch {want} only: "
              f"{launches}")
        runs[name] = dict(row, launches=launches, requests=len(ireqs))
        if not kw:
            runs[name]["greedy_prefix_agreement_with_float16_pools"] = \
                agreement(ireqs, streams["float16"])
        int8_launches[want] = launches[want]
        del srv
    host = init_inference(
        model=(cfg, tree.tree_map(lambda t: t.cpu(), params)),
        dtype=torch.float32, device="cpu")
    tok = prompts[0][None, :64].astype(np.int64)
    with torch.inference_mode():
        ref = host._prefill_fn(torch.as_tensor(tok))[0][0, -1].float()
        rel = {}
        for name, eng in engines.items():
            got = eng._prefill_fn(torch.as_tensor(tok, device=eng.device))
            got = got[0][0, -1].float().cpu()
            check(bool(torch.isfinite(got).all()),
                  f"{name}: non-finite first-step logits")
            rel[name] = ((got - ref).abs().max() / ref.abs().max()).item()
    check(rel["float16"] <= FP16_TOL,
          f"float16 first-step logits: {rel['float16']} of their scale from "
          f"float32 (tol {FP16_TOL})")
    emit(dict(phase="serve_fp16", model="llama-7b", layers=L,
              dtype="float16", requests=4, prompt_lens=[int(x) for x in lens],
              new_tokens=32, float16=runs["float16"],
              bfloat16=runs["bfloat16"], float16_spec=runs["float16_spec"],
              float16_int8=runs["float16_int8"],
              float16_int8_spec=runs["float16_int8_spec"],
              greedy_prefix_agreement_fp16_vs_bf16=agree,
              greedy_full_agreement_fp16_vs_bf16=sum(a == 32 for a in agree),
              first_step_logits_rel_to_fp32_host=rel, tol=FP16_TOL))
    del engines, host, params
    torch.cuda.empty_cache()
    return {"K3-fp16": runs["float16"]["launches"]["K3"],
            "K3-fp16-verify": spec_launches["K3-verify"],
            "K3-int8-fp16": int8_launches["K3-int8"],
            "K3-int8-fp16-verify": int8_launches["K3-int8-verify"]}


def drain(torch, srv, reqs):
    """Submit ``reqs`` and step ``srv`` until idle, synchronising after
    each step; returns (wall instant of the end of the step that each
    tick of the scheduler clock belongs to, submit instant). Tokens are
    stamped with the clock, which a step advances by one, or by the
    tokens a horizon produced."""
    t_submit = time.perf_counter()
    for r in reqs:
        srv.submit(r)
    step_end = []
    while srv.busy:
        tick = srv._step_clock
        srv.step()
        torch.cuda.synchronize()
        step_end += [time.perf_counter()] * (srv._step_clock - tick)
    return step_end, t_submit


def serve_int8_phase(torch, flash, paged, gpt, init_inference, serving):
    """The int8 serving path: weight-only int8 (K4 in every block
    projection) and int8 KV blocks (K3-int8 in every decode step) on the
    serve phase's model, prompts and requests, at 8 of llama-7b's 32
    layers (cut for the run's time; the int8 phases after it share this
    engine)."""
    cfg = gpt.preset("llama-7b", n_layers=8)
    t0 = time.perf_counter()
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng = init_inference(model=(cfg, params), dtype=torch.int8)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    check(eng.quantized and eng.dtype == torch.bfloat16,
          f"init_inference(dtype=int8) gave {eng.dtype}")
    weights_gib = torch.cuda.memory_allocated() / 2**30
    int8_gib = sum(t.numel() for t in (eng.params["lm_head"]["q"],
                                       *(v["q"] for v in
                                         eng.params["block"].values()
                                         if "q" in v))) / 2**30
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (4, 512)).astype(np.int32)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = kernel_launches(flash, paged)
    check(gen.shape == (4, 544), f"int8 generate returned {gen.shape}")
    check(gen_launches["K1-fwd"] > 0 and gen_launches["K4"] > 0
          and gen_launches["K3"] == 0 and gen_launches["K3-int8"] == 0,
          f"int8 generate should launch K1-fwd and K4 and neither K3 mode: "
          f"{gen_launches}")

    lens = rng.integers(64, 1025, 16)
    prompt_of = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                 for n in lens]

    def requests():
        return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=64,
                                     logprobs=True)
                for i, p in enumerate(prompt_of)]
    reqs = requests()
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, kv_quant="int8")
    cache = srv.cache
    pool_gib = sum(t.numel() * t.element_size() for t in
                   (cache.k, cache.v, cache.k_scale, cache.v_scale)) / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_launches(flash, paged)
    step_end, t_submit = drain(torch, srv, reqs)
    serve_launches = kernel_launches(flash, paged)
    serve_s = step_end[-1] - t_submit
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(len(srv.finished) == 16 and all(len(r.out) == 64 for r in reqs),
          "int8 serving lost requests or tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), "non-finite logprobs in int8 serving")
    check(serve_launches["K4"] > 0 and serve_launches["K3-int8"] > 0
          and serve_launches["K3"] == 0,
          f"the int8 drain should launch K4 and K3-int8 and never float K3: "
          f"{serve_launches}")
    stats = cache.stats()
    ttft = [step_end[int(r.first_token_at)] - t_submit for r in reqs]
    tpot = [step_end[int(b)] - step_end[int(a)] for r in reqs
            for a, b in zip(r.token_times, r.token_times[1:])]
    n_tok = sum(len(r.out) for r in reqs)
    del srv

    # the same int8 weights over a bf16 cache: agreement is reported, not
    # asserted (random weights give near-tied bf16 logits)
    ref_reqs = requests()
    ref_end, ref_submit = drain(torch, serving.ServingEngine(
        eng, num_slots=8, block_size=16, prefill_chunk=256), ref_reqs)
    ref_tpot = [ref_end[int(b)] - ref_end[int(a)] for r in ref_reqs
                for a, b in zip(r.token_times, r.token_times[1:])]
    agree = []
    for r, f in zip(reqs, ref_reqs):
        same = np.asarray(r.out) == np.asarray(f.out)
        agree.append(int(np.argmin(same)) if not same.all() else 64)
    emit(dict(phase="serve_int8", model="llama-7b", layers=cfg.n_layers,
              weights="int8 (weight-only), bf16 activations",
              kv_cache="int8 blocks, fp32 scale per (block, kv head)",
              init_s=init_s, weights_gib_after_init=weights_gib,
              int8_weight_gib=int8_gib,
              generate=dict(batch=4, prompt=512, new=32, seconds=gen_s,
                            tokens_per_s=4 * 32 / gen_s,
                            launches=gen_launches),
              requests=16, new_tokens=n_tok, seconds=serve_s,
              tokens_per_s=n_tok / serve_s,
              ttft_s_p50=float(np.percentile(ttft, 50)),
              ttft_s_p99=float(np.percentile(ttft, 99)),
              tpot_s_p50=float(np.percentile(tpot, 50)),
              tpot_s_p99=float(np.percentile(tpot, 99)),
              peak_mem_gib=peak_gb, kv_pool_gib=pool_gib,
              kv_bytes_per_token=stats["kv_bytes_per_token"],
              kv_bytes_per_token_bf16=gpt.kv_bytes_per_token(cfg),
              launches=serve_launches, cache=stats,
              bf16_cache_drain=dict(
                  seconds=ref_end[-1] - ref_submit,
                  tokens_per_s=sum(len(r.out) for r in ref_reqs)
                  / (ref_end[-1] - ref_submit),
                  tpot_s_p50=float(np.percentile(ref_tpot, 50))),
              greedy_prefix_agreement_vs_bf16_cache=agree,
              greedy_full_agreement_vs_bf16_cache=sum(a == 64 for a in agree)))
    trace_phase(torch, eng, serving, rng, kv_quant="int8",
                what="llama-7b int8 weights, int8 KV")
    # the engine and the requests stay for lora_int8, horizon_int8,
    # host_tier_int8 and spec_int8; the drain is lora_int8's LoRA-off side
    base = dict(reqs=reqs, launches=serve_launches,
                drain=drain_row(step_end, t_submit, reqs))
    return {"K4": serve_launches["K4"], "K3-int8": serve_launches["K3-int8"],
            "K4-generate": gen_launches["K4"]}, eng, reqs, base


# ---------------------------------------------------------------------------
# phase 3b: the serving extensions (prefix cache, speculative decode)
# ---------------------------------------------------------------------------

def drain_row(step_end, t_submit, reqs):
    """Latency and throughput of one drain: TTFT from submission to the
    end of the step that emitted the first token; TPOT per request, the
    time from its first to its last token over the tokens between (a
    speculative step emits several tokens at one instant)."""
    ttft = [step_end[int(r.first_token_at)] - t_submit for r in reqs]
    tpot = [(step_end[int(r.token_times[-1])]
             - step_end[int(r.token_times[0])]) / (len(r.out) - 1)
            for r in reqs if len(r.out) > 1]
    n_tok = sum(len(r.out) for r in reqs)
    seconds = step_end[-1] - t_submit
    return dict(seconds=seconds, new_tokens=n_tok,
                tokens_per_s=n_tok / seconds,
                ttft_s_p50=float(np.percentile(ttft, 50)),
                ttft_s_p99=float(np.percentile(ttft, 99)),
                tpot_s_p50=float(np.percentile(tpot, 50)),
                tpot_s_p99=float(np.percentile(tpot, 99)))


def agreed(a, b):
    """The tokens two streams of one length agree on before they part."""
    same = np.asarray(a) == np.asarray(b)
    return int(np.argmin(same)) if not same.all() else len(same)


def agreement(a_reqs, b_reqs):
    """Per request, the tokens two drains agree on before they part."""
    return [agreed(a.out, b.out) for a, b in zip(a_reqs, b_reqs)]


def spec_stats(srv):
    st = srv.stats
    return dict({k: st[k] for k in st if k.startswith("spec_")},
                acceptance=st["spec_accepted"] / max(1, st["spec_proposed"]),
                tokens_per_slot_verify=st["spec_emitted"]
                / max(1, st["spec_slot_steps"]),
                tokens_per_verify_step=st["spec_emitted"]
                / max(1, st["spec_steps"]))


def repeating(rng, vocab, n):
    """A seeded span of 8-32 tokens repeated to ``n`` tokens: prompt
    lookup finds earlier occurrences to propose from."""
    return np.resize(rng.integers(1, vocab, int(rng.integers(8, 33))),
                     int(n)).astype(np.int32)


def serve_drain(torch, flash, paged, serving, eng, prompts, new=64, **kw):
    """One 8-slot drain of ``prompts`` with the launch counters zeroed just
    before it: (requests, server, drain row, launches)."""
    reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new,
                                 logprobs=True) for i, p in enumerate(prompts)]
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, **kw)
    reset_launches(flash, paged)
    step_end, t_submit = drain(torch, srv, reqs)
    launches = kernel_launches(flash, paged)
    check(len(srv.finished) == len(reqs)
          and all(len(r.out) == new for r in reqs),
          f"serving {kw} lost requests or tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(len(lps) == len(reqs) * new and np.isfinite(lps).all(),
          f"serving {kw}: missing or non-finite logprobs")
    return reqs, srv, drain_row(step_end, t_submit, reqs), launches


def prefix_phase(torch, flash, paged, serving, eng):
    """The shared-prefix cache at full width: 16 requests sharing a
    512-token system prompt (32 full blocks), seeded suffixes of 64-512
    tokens, 64 new tokens each, drained with the cache off and on."""
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(2)
    system = rng.integers(1, V, 512)
    prompts = [np.concatenate([system, rng.integers(1, V, n)]).astype(
        np.int32) for n in rng.integers(64, 513, 16)]
    runs, reqs = {}, {}
    for on in (False, True):
        reqs[on], srv, row, launches = serve_drain(
            torch, flash, paged, serving, eng, prompts, prefix_cache=on)
        cache = srv.cache.stats()
        runs["on" if on else "off"] = dict(
            row, launches=launches, prefix_hits=srv.stats["prefix_hits"],
            prefix_tokens_saved=srv.stats["prefix_tokens_saved"],
            prefill_chunks=srv.stats["prefill_chunks"],
            cow_copies=cache["cow_copies"],
            peak_used_blocks=cache["peak_used_blocks"],
            cached_blocks_after=cache["cached_blocks"])
        check(launches["K3"] > 0, f"the prefix drain never launched K3: "
              f"{launches}")
        del srv
    check(runs["on"]["prefix_hits"] > 0
          and runs["on"]["prefix_tokens_saved"] >= 512
          and runs["off"]["prefix_hits"] == 0,
          f"prefix cache: {runs}")
    agree = agreement(reqs[False], reqs[True])
    emit(dict(phase="prefix", model="llama-7b", dtype="bfloat16",
              requests=16, system_prompt=512,
              prompt_lens=[int(len(p)) for p in prompts], new_tokens=64,
              off=runs["off"], on=runs["on"],
              greedy_prefix_agreement_on_vs_off=agree,
              greedy_full_agreement_on_vs_off=sum(a == 64 for a in agree)))


def horizon_requests(serving, prompts, stops):
    """The serve phase's 16 prompts, 64 new tokens each: four carry a
    two-token stop (``stops``), four are sampled with their own seeds."""
    return [serving.ServeRequest(
        rid=i, prompt=p, max_new_tokens=64, logprobs=True,
        stop=stops.get(i), temperature=0.8 if i >= 12 else None,
        top_p=0.95 if i >= 12 else None, seed=i)
        for i, p in enumerate(prompts)]


def stops_from(reqs):
    """Two-token stops for requests 0-3 from their own streams, at tokens
    10, 19, 28 and 37."""
    return {i: [list(reqs[i].out[10 + 9 * i:12 + 9 * i])] for i in range(4)}


def telemetry_checks(srv, reqs, name):
    """What a telemetry-on drain recorded, checked against what the drain
    did: the stats view equals the registry's counters and the tracer's
    counts (prefill chunks, decode dispatches, tokens), the tracer holds
    one ``finish`` per request and dropped nothing, the footprints of the
    requests (and the system's) sum to the accountant's class totals, and
    the exported trace is JSON that ``telemetry.read_serving_trace`` loads
    with every request done. Returns the row's ``telemetry`` entry."""
    from deepspeed_tpu_torch.telemetry import costs, read_serving_trace
    st, tel = srv.stats, srv.telemetry
    counters = srv.metrics.snapshot()["counters"]
    check(all(counters[f"serving_{k}"] == st[k] for k in st
              if f"serving_{k}" in counters),
          f"{name}: the stats view differs from the registry")
    recs = tel.tracer.records()
    n_of = {}
    for r in recs:
        n_of[r[1]] = n_of.get(r[1], 0) + 1
    finishes = [r[2] for r in recs if r[1] == "finish"]
    check(tel.tracer.dropped == 0
          and sorted(finishes, key=str) == sorted((r.rid for r in reqs),
                                                  key=str),
          f"{name}: {tel.tracer.dropped} records dropped, finishes "
          f"{finishes}")
    # a horizon drain: one horizon_step per decode dispatch, and every
    # token but each request's first (from its prefill) produced by one
    # (a stop the device does not model drops a horizon's surplus)
    produced = sum(sum(r[5]["produced"].values()) for r in recs
                   if r[1] == "horizon_step")
    check(n_of.get("prefill_chunk", 0) == st["prefill_chunks"]
          and n_of.get("horizon_step", 0) == st["decode_steps"]
          and n_of.get("first_token", 0) == len(reqs)
          and produced + len(reqs) >= sum(len(r.out) for r in reqs),
          f"{name}: tracer counts {n_of} against stats {dict(st)}")
    fps = [r.cost for r in reqs] + [srv.costs.system]
    for cls in costs.DISPATCH_CLASSES:
        for k in ("flops", "hbm_bytes", "dispatches"):
            check(sum(fp[cls][k] for fp in fps) == srv.costs.totals[cls][k],
                  f"{name}: {cls} {k} footprints do not sum to the total")
    snap = srv.costs.snapshot()
    check(counters["serving_flops_total"] == snap["flops_total"]
          and sum(costs.footprint_totals(fp)["block_seconds"] for fp in fps)
          == snap["block_seconds_total"],
          f"{name}: cost counters {counters} against {snap}")
    path = os.path.join(REPO, "build", f"chip_smoke_trace_{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    summary = read_serving_trace(tel.export_trace(path))
    check(len(summary["requests"]) == len(reqs)
          and all(r["state"] == "done"
                  for r in summary["requests"].values()),
          f"{name}: the exported trace reads {summary['requests']}")
    hist = srv.metrics.snapshot()["histograms"]
    return dict(records=len(recs), dropped=tel.tracer.dropped,
                events=n_of, trace_events=summary["n_events"],
                sampled_phase_us=summary["phase_us"],
                flops_total=snap["flops_total"],
                hbm_bytes_total=snap["hbm_bytes_total"],
                block_seconds_total=snap["block_seconds_total"],
                ttft_steps=hist["serving_ttft"],
                tpot_steps=hist["serving_tpot"],
                horizon_tokens=hist.get("serving_horizon_tokens"))


def horizon_drains(torch, flash, paged, serving, eng, prompts, stops,
                   horizons, kv_quant="off", telemetry_at=4):
    """One 8-slot drain of the horizon requests per decode horizon, with
    the launch counters zeroed just before each: {N: (streams, row)}. K3
    (or K3-int8) must run once per layer and decode iteration, and with
    int8 weights K4 five times per layer and iteration or prefill
    chunk. The drain at N = ``telemetry_at`` runs with telemetry on, so
    its streams equal to N = 1's (telemetry off) hold on against off too;
    its row carries ``telemetry_checks``."""
    L = eng.cfg.n_layers
    k3 = "K3-int8" if kv_quant == "int8" else "K3"
    out = {}
    for n in horizons:
        reqs = horizon_requests(serving, prompts, stops)
        srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                    prefill_chunk=256, kv_quant=kv_quant,
                                    decode_horizon=n,
                                    telemetry=n == telemetry_at)
        reset_launches(flash, paged)
        step_end, t_submit = drain(torch, srv, reqs)
        launches = kernel_launches(flash, paged)
        st = srv.stats
        check(len(srv.finished) == 16, f"horizon {n}: requests lost")
        check(launches[k3] == L * srv.decode_iterations,
              f"horizon {n}: {k3} launched {launches[k3]} times for "
              f"{srv.decode_iterations} decode iterations of {L} layers")
        if eng.quantized:
            want = 5 * L * (srv.decode_iterations + st["prefill_chunks"])
            check(launches["K4"] == want,
                  f"horizon {n}: K4 launched {launches['K4']}, not {want}")
        lps = np.array([lp for r in reqs for lp in r.out_logprobs])
        check(np.isfinite(lps).all(), f"horizon {n}: non-finite logprobs")
        out[n] = ([(r.out, r.out_logprobs) for r in reqs], dict(
            drain_row(step_end, t_submit, reqs), decode_horizon=n,
            decode_dispatches=st["decode_steps"],
            decode_iterations=srv.decode_iterations, steps=st["steps"],
            stop_hits=st["stop_hits"], sampled_tokens=st["sampled_tokens"],
            launches=launches))
        if srv.telemetry.enabled:
            out[n][1]["telemetry"] = telemetry_checks(
                srv, reqs, f"horizon{n}_{kv_quant}")
        del srv
    ref = out[horizons[0]]
    check(ref[1]["stop_hits"] == 4, f"the stops did not all hit: {ref[1]}")
    for n in horizons[1:]:
        same = [a[0] == b[0] for a, b in zip(out[n][0], ref[0])]
        check(all(same), f"horizon {n}: streams "
              f"{np.nonzero(~np.array(same))[0]} differ from N = "
              f"{horizons[0]}")
        same_lp = all(a[1] == b[1] for a, b in zip(out[n][0], ref[0]))
        check(same_lp, f"horizon {n}: the logprobs differ from "
              f"N = {horizons[0]}")
        check(out[n][1]["stop_hits"] == ref[1]["stop_hits"],
              f"horizon {n}: stop hits {out[n][1]}")
    return {n: row for n, (_, row) in out.items()}


def horizon_phase(torch, flash, paged, serving, eng, serve_reqs):
    """The multi-step decode horizon on llama-7b bf16: the serve phase's
    16 requests (four with two-token stops from their own serve-phase
    streams, four sampled) drained at N = 1 and 4 (no N = 8 drain: cut
    for the run's time; the card test
    ``test_horizon_on_card_equals_one_token_decode`` holds N = 8), every
    stream and logprob equal to N = 1's; then a traced steady step at N = 4
    (wall, device-busy, host CPU ms and aten calls per emitted token;
    N = 1 is the serve phase's ``trace``)."""
    prompts = [r.prompt for r in serve_reqs]
    rows = horizon_drains(torch, flash, paged, serving, eng, prompts,
                          stops_from(serve_reqs), (1, 4))
    emit(dict(phase="horizon", model="llama-7b", dtype="bfloat16",
              requests=16, new_tokens=64, stop_requests=4,
              sampled_requests=4, runs={str(n): r for n, r in rows.items()},
              streams_equal_to_n1=True))
    # N = 1 is the serve phase's trace; one step of a horizon of 4 emits
    # the 32 tokens of its 4 steps (no N = 8 trace: cut for the run's
    # time)
    trace_phase(torch, eng, serving, np.random.default_rng(8), steps=1,
                decode_horizon=4, what="llama-7b bf16, decode horizon 4")
    return {f"K3-N{n}": r["launches"]["K3"] for n, r in rows.items()}


def horizon_int8_phase(torch, flash, paged, serving, eng, serve_reqs):
    """The horizon with int8 weights and int8 KV: the same requests (the
    stops from the int8 serve drain's streams) at N = 1 and 4, streams
    and logprobs equal; K3-int8 and K4 counted."""
    prompts = [r.prompt for r in serve_reqs]
    rows = horizon_drains(torch, flash, paged, serving, eng, prompts,
                          stops_from(serve_reqs), (1, 4), kv_quant="int8")
    emit(dict(phase="horizon_int8", model="llama-7b",
              layers=eng.cfg.n_layers,
              weights="int8 (weight-only), bf16 activations",
              kv_cache="int8 blocks", requests=16, new_tokens=64,
              runs={str(n): r for n, r in rows.items()},
              streams_equal_to_n1=True))
    return {"K3-int8-N4": rows[4]["launches"]["K3-int8"],
            "K4-N4": rows[4]["launches"]["K4"]}


# the host tier's pool: room for a few live requests beside an idle
# system chain or two, so that chains leave the card and come back (a
# pool that keeps every chain restores nothing)
HOST_TIER_BLOCKS = 160


def host_tier_prompts(V):
    """4 system prompts of 512 tokens (32 blocks), 6 requests each in
    round robin, seeded suffixes of 64-256 tokens."""
    rng = np.random.default_rng(7)
    systems = [rng.integers(1, V, 512) for _ in range(4)]
    return [np.concatenate([systems[i % 4], rng.integers(
        1, V, int(rng.integers(64, 257)))]).astype(np.int32)
        for i in range(24)]


def median_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def transfer_bench(torch, srv, eng):
    """The host tier's transfers on the drained cache, per block: a
    spill (the gather of ``transfer_blocks`` blocks and its copy to the
    pinned buffers on the copy stream, waited for), the host's store of
    a block (copy and CRC32) and the CRC32 alone; a restore (the CRC32
    check, then the copy through the pinned buffer, waited for, into the
    trash block), and the re-prefill of 32 blocks (512 tokens in two
    chunks of 256) that a restore of a system chain saves."""
    import zlib
    from deepspeed_tpu_torch.inference import host_tier
    from deepspeed_tpu_torch.inference.paged_cache import (gather_blocks,
                                                           to_numpy)
    cache = srv.cache
    cache.abort_transfers()
    T = cache.transfer_blocks
    nbytes = cache.block_size * cache.bytes_per_token \
        + cache.scale_bytes_per_block
    ids = torch.arange(1, T + 1, device=cache.device)

    def spill():
        cache._copy_to_pinned(gather_blocks(cache._pools(), ids)) \
            .synchronize()
    spill()
    spill_ms = median_ms(spill) / T
    payload = tuple(np.ascontiguousarray(to_numpy(b)[:, 0])
                    for b in cache._pinned)
    crc_ms = median_ms(lambda: [zlib.crc32(a) for a in payload])
    pool = host_tier.HostBlockPool(1 << 34)
    put_ms = median_ms(lambda: pool.put(payload))
    key = pool.put(payload)
    get_ms = median_ms(lambda: pool.get(key))

    def h2d():
        cache._scatter(payload, 0)
        torch.cuda.synchronize()
    h2d()
    h2d_ms = median_ms(h2d)
    chunk = np.arange(1, 257, dtype=np.int32)

    def reprefill():
        cache.allocate(0, 512)
        for start in (0, 256):
            eng.prefill_into_slot(cache.k, cache.v, cache.tables[0], chunk,
                                  start, 256, k_scale=cache.k_scale,
                                  v_scale=cache.v_scale)
        torch.cuda.synchronize()
        cache.free(0)
    reprefill()
    prefill_ms = median_ms(reprefill, reps=3)
    gb = nbytes / 1e9
    return dict(
        block_bytes=nbytes, transfer_blocks=T,
        spill_ms_per_block=spill_ms, spill_gb_per_s=gb / (spill_ms / 1e3),
        store_ms_per_block=put_ms, crc_ms_per_block=crc_ms,
        spill_crc_share=crc_ms / (spill_ms + put_ms),
        restore_crc_check_ms=get_ms, restore_copy_ms=h2d_ms,
        restore_ms_per_block=get_ms + h2d_ms,
        restore_gb_per_s=gb / ((get_ms + h2d_ms) / 1e3),
        restore_copy_gb_per_s=gb / (h2d_ms / 1e3),
        restore_crc_share=get_ms / (get_ms + h2d_ms),
        reprefill_32_blocks_ms=prefill_ms,
        restore_32_blocks_ms=32 * (get_ms + h2d_ms))


def host_tier_phase(torch, flash, paged, serving, eng, kv_quant="off"):
    """The host-DRAM KV tier on llama-7b with the prefix cache: 24
    requests over 4 system prompts of 512 tokens (``host_tier_prompts``),
    32 new tokens, 8 slots, ``HOST_TIER_BLOCKS`` blocks, a 1 GiB host
    budget, drained with the tier off and on: the same streams, restores
    on. Then one host entry on a request's chain is corrupted: that
    request re-prefills its chain (``host_restore_failures`` + 1) and
    gives the tier-off stream. Then the transfers' costs per block."""
    V = eng.cfg.vocab_size
    prompts = host_tier_prompts(V)
    runs, outs = {}, {}
    for tier in (False, True):
        reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=32)
                for i, p in enumerate(prompts)]
        srv = serving.ServingEngine(
            eng, num_slots=8, block_size=16, prefill_chunk=256,
            num_blocks=HOST_TIER_BLOCKS, kv_quant=kv_quant,
            prefix_cache=True, host_tier=tier, host_budget_bytes=1 << 30)
        reset_launches(flash, paged)
        step_end, t_submit = drain(torch, srv, reqs)
        launches = kernel_launches(flash, paged)
        check(len(srv.finished) == 24 and all(len(r.out) == 32
                                              for r in reqs),
              f"host tier {tier}: lost requests or tokens")
        st, c = srv.stats, srv.cache
        restore_ms = c.drain_restore_ms()
        outs[tier] = [r.out for r in reqs]
        runs["on" if tier else "off"] = dict(
            drain_row(step_end, t_submit, reqs), launches=launches,
            **{k: st[k] for k in ("prefill_chunks", "prefix_hits",
                                  "prefix_tokens_saved", "host_spills",
                                  "host_restores", "host_restore_failures",
                                  "decode_steps", "steps")},
            host_spill_aborts=c.host_spill_aborts,
            host_budget_refusals=c.host_budget_refusals,
            cache_block_evictions=c.cache_block_evictions,
            restore_host_ms_mean=float(np.mean(restore_ms))
            if restore_ms else None)
    on = runs["on"]
    check(outs[True] == outs[False], "host tier: the tier-on streams "
          "differ from the tier-off ones")
    check(on["host_restores"] > 0 and on["host_restore_failures"] == 0,
          f"host tier: {on}")
    # a corrupted entry on the first host link of a last-wave request's
    # chain: its restore fails its CRC, the chain re-prefills
    cache = srv.cache
    pick = None
    for i in range(20, 24):
        m = cache.index.match(prompts[i], max_tokens=len(prompts[i]) - 1,
                              touch=False)
        if "host" in m.tiers:
            pick = (i, m.block_ids[m.tiers.index("host")],
                    m.tiers.index("host"))
            break
    check(pick is not None and cache.free_blocks > 0,
          "host tier: no last-wave chain reaches the host")
    i, key, depth = pick
    fail0, chunks0 = cache.host_restore_failures, srv.stats["prefill_chunks"]
    cache.host_pool.corrupt(key)
    again = serving.ServeRequest(rid="again", prompt=prompts[i],
                                 max_new_tokens=32)
    srv.run([again])
    check(cache.host_restore_failures == fail0 + 1,
          f"host tier: the corrupted entry gave "
          f"{cache.host_restore_failures - fail0} restore failures")
    check(again.out == outs[False][i], "host tier: the request over the "
          "corrupted entry gave another stream")
    corrupt = dict(request=i, host_link=depth,
                   prefill_chunks=srv.stats["prefill_chunks"] - chunks0,
                   restore_failures=cache.host_restore_failures - fail0)
    bench = transfer_bench(torch, srv, eng)
    emit(dict(phase="host_tier" + ("_int8" if kv_quant == "int8" else ""),
              model="llama-7b", layers=eng.cfg.n_layers,
              kv_cache="int8 blocks" if kv_quant == "int8" else "bfloat16",
              requests=24, system_prompts=4, system_prompt=512,
              new_tokens=32, num_blocks=HOST_TIER_BLOCKS,
              host_budget_bytes=1 << 30, off=runs["off"], on=on,
              streams_equal=True, corrupted=corrupt, transfers=bench))
    del srv
    torch.cuda.empty_cache()
    k3 = "K3-int8" if kv_quant == "int8" else "K3"
    return {k3: on["launches"][k3], "K4": on["launches"]["K4"]}


def mode_logits(torch, eng, serving, ctx, drafts, kv_quant, lora=None):
    """The logits for the token after ``ctx`` three ways, each over the
    same one-slot cache that a chunked prefill of ``ctx[:-1]`` wrote:
    the decode mode (K3, q_len 1), the verify mode (row 0 of the chunk
    ``[ctx[-1]] + drafts``, K3 at q_len len(drafts) + 1) and a prefill
    chunk (K1-fwd). ``lora``: the slot's adapter operand
    (``AdapterPool.lora_args`` of its row), for all three. float32 host
    arrays [V] each."""
    G = len(drafts) + 1
    cache = serving.PagedKVCache(
        eng.cfg, num_slots=1, block_size=16, dtype=eng.dtype,
        max_seq_len=eng.max_seq_len, device=eng.device, kv_quant=kv_quant,
        watermark=0)
    cache.allocate(0, len(ctx) + G)
    quant = cache.quantized
    scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    n, C = len(ctx) - 1, 256
    for done in range(0, n, C):
        m = min(C, n - done)
        chunk = np.zeros((C,), np.int32)
        chunk[:m] = ctx[done:done + m]
        out = eng.prefill_into_slot(cache.k, cache.v, cache.tables[0], chunk,
                                    done, m, lora=lora, **scales)
        cache.k, cache.v = out[1:3]
        if quant:
            cache.k_scale, cache.v_scale = out[3:5]
            scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
        cache.advance(0, m)
    pools = [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
             if t is not None]
    snapshot = [t.clone() for t in pools]
    tables, lengths = cache.tables, cache.lengths
    active = np.ones((1,), bool)

    def restore():
        for t, saved in zip(pools, snapshot):
            t.copy_(saved)

    dec = eng.decode_slots(cache.k, cache.v, tables, lengths,
                           np.asarray([ctx[-1]], np.int32), active,
                           lora=lora, **scales)[0][0, -1]
    dec = dec.float().cpu().numpy()
    restore()
    chunk = np.asarray([[ctx[-1], *drafts]], np.int32)
    ver = eng.verify_slots(cache.k, cache.v, tables, lengths, chunk, active,
                           lora=lora, **scales)[0][0, 0].float().cpu().numpy()
    restore()
    chunk = np.zeros((C,), np.int32)
    chunk[0] = ctx[-1]
    pre = eng.prefill_into_slot(cache.k, cache.v, tables[0], chunk, n, 1,
                                lora=lora, **scales)[0][0, -1].float().cpu(
                                    ).numpy()
    del cache, pools, snapshot
    return dec, ver, pre


def partings(torch, eng, serving, off_reqs, on_reqs, kv_quant, spec_k=4,
             lora_of=None):
    """Where a greedy spec-on stream parts from the spec-off one, whether
    the off run's choice there was a near-tie that rounding flips or a
    fault of the verify mode. At each request's first differing token the
    logits of the shared context are taken in the decode mode (the off
    run's), the verify mode (the on run's) and by a prefill chunk
    (``mode_logits``). The rounding scale R of this run is the largest
    decode-vs-prefill distance over the partings, and no less than one
    bf16 step (ulp) of the largest logit: two paths the float32 tiers hold
    exact, so R is what bf16 (and int8 KV) rounding alone costs here. The
    verify mode must lie within 4 R of the decode mode, and at the parting
    the off run's top-1/top-2 margin and its lead of the off token over
    the on token within 4 R: a verify fault at full depth moves the
    logits by their own spread (they reach 4-8 here), far past R.
    ``lora_of(request)``: the request's adapter operand for
    ``mode_logits`` (None: the base model)."""
    rows = []
    for a, b in zip(off_reqs, on_reqs):
        same = np.asarray(a.out) == np.asarray(b.out)
        if same.all():
            continue
        p = int(np.argmin(same))
        ctx = np.concatenate([a.prompt, np.asarray(a.out[:p], np.int32)])
        drafts = np.resize(np.asarray(b.out[p:p + spec_k], np.int32), spec_k)
        dec, ver, pre = mode_logits(
            torch, eng, serving, ctx, drafts, kv_quant,
            lora=None if lora_of is None else lora_of(b))
        top = np.sort(dec)[-2:]
        big = float(np.abs(dec).max())
        rows.append(dict(
            rid=a.rid, at=p, off_token=int(a.out[p]), on_token=int(b.out[p]),
            margin=float(top[1] - top[0]),
            gap_off_on=float(dec[a.out[p]] - dec[b.out[p]]),
            verify_vs_decode=float(np.abs(ver - dec).max()),
            prefill_vs_decode=float(np.abs(pre - dec).max()),
            ulp=float(2.0 ** (np.floor(np.log2(big)) - 7)),
            decode_picks_off=bool(np.argmax(dec) == a.out[p]),
            verify_picks_on=bool(np.argmax(ver) == b.out[p])))
    if not rows:
        return dict(partings=0, rows=[])
    R = max(max(r["prefill_vs_decode"], r["ulp"]) for r in rows)
    bad = [r for r in rows if max(r["verify_vs_decode"], r["margin"],
                                  r["gap_off_on"]) > 4 * R]
    check(not bad, f"spec-on streams part from spec-off ones beyond "
          f"rounding (R = {R}): {bad}")
    return dict(partings=len(rows), rounding_R=R,
                max_margin=max(r["margin"] for r in rows),
                max_verify_vs_decode=max(r["verify_vs_decode"]
                                         for r in rows),
                rows=rows)


def spec_phase(torch, flash, paged, gpt, init_inference, serving, eng):
    """Speculative decode at full width: 8 seeded prompts of 64-1024
    tokens (cut for the run's time) built from repeated spans, 64 new
    tokens, spec_k 4 with the
    n-gram drafter, drained with speculation off and on (every decode
    step of the second is a verify: K3 in its verify mode, q_len 5); then
    two short drains: a ModelDraft over a 2-layer llama-7b-width draft
    (its generate runs K1-fwd) and sampled requests (temperature 0.8)."""
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(3)
    prompts = [repeating(rng, V, n) for n in rng.integers(64, 1025, 16)][:8]
    runs, reqs = {}, {}
    for on in (False, True):
        reqs[on], srv, row, launches = serve_drain(
            torch, flash, paged, serving, eng, prompts, spec_decode=on,
            spec_k=4)
        runs["on" if on else "off"] = dict(row, launches=launches,
                                           stats=spec_stats(srv),
                                           decode_steps=srv.stats[
                                               "decode_steps"])
        del srv
    on_launches = runs["on"]["launches"]
    check(on_launches["K3-verify"] > 0 and on_launches["K3"] == 0,
          f"the spec drain should launch K3 in its verify mode only: "
          f"{on_launches}")
    check(runs["off"]["launches"]["K3-verify"] == 0,
          f"the spec-off drain launched the verify mode: {runs['off']}")
    agree = agreement(reqs[False], reqs[True])
    parted = partings(torch, eng, serving, reqs[False], reqs[True], "off")
    # random weights rarely continue a repeated span, so prompt lookup is
    # rarely accepted; what speculation gives when drafts are right: a
    # drafter proposing the spec-on run's own streams (the spec-off ones
    # part from them where bf16 rounds the verify and decode modes
    # differently)
    # (the first 4 requests: the drain is cut for the run's time)
    oracle = StreamDraft([r.tokens for r in reqs[True][:4]], V, mutate=False)
    oreqs, srv, row, launches = serve_drain(
        torch, flash, paged, serving, eng, prompts[:4], spec_decode=True,
        spec_k=4, spec_draft=oracle)
    runs["oracle"] = dict(row, launches=launches, stats=spec_stats(srv),
                          decode_steps=srv.stats["decode_steps"],
                          requests=8,
                          greedy_prefix_agreement_vs_on=agreement(
                              reqs[True][:4], oreqs))
    del srv
    # a model drafter: 2 layers of llama-7b width from seed 1
    dcfg = gpt.preset("llama-7b", n_layers=2)
    draft = init_inference(model=(dcfg, gpt.init_params(
        dcfg, seed=1, dtype=torch.bfloat16)), dtype=torch.bfloat16)
    short = [p[:256] for p in prompts[:4]]
    _, srv, model_row, model_launches = serve_drain(
        torch, flash, paged, serving, eng, short, new=16, spec_decode=True,
        spec_k=4, spec_draft=draft)
    check(model_launches["K1-fwd"] > 0 and model_launches["K3-verify"] > 0,
          f"the ModelDraft drain should launch K1-fwd (the draft's "
          f"generate) and K3-verify: {model_launches}")
    model_row.update(launches=model_launches, stats=spec_stats(srv))
    del srv, draft
    sreqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=16,
                                  temperature=0.8, seed=i, logprobs=True)
             for i, p in enumerate(short)]
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, spec_decode=True, spec_k=4)
    srv.run(sreqs)
    lps = np.array([lp for r in sreqs for lp in r.out_logprobs])
    check(all(len(r.out) == 16 for r in sreqs) and len(lps) == 64
          and np.isfinite(lps).all() and srv.stats["spec_steps"] > 0,
          "sampled speculative serving lost tokens or logprobs")
    sampled = dict(stats=spec_stats(srv),
                   sampled_tokens=srv.stats["sampled_tokens"])
    del srv
    torch.cuda.empty_cache()
    emit(dict(phase="spec", model="llama-7b", dtype="bfloat16", spec_k=4,
              drafter="ngram", requests=16,
              prompt_lens=[int(len(p)) for p in prompts], new_tokens=64,
              off=runs["off"], on=runs["on"], oracle_draft=runs["oracle"],
              greedy_prefix_agreement_on_vs_off=agree,
              greedy_full_agreement_on_vs_off=sum(a == 64 for a in agree),
              partings=parted,
              model_draft=dict(model_row, draft="llama-7b width, 2 layers, "
                                                "seed 1", requests=4,
                               prompt=256, new_tokens=16),
              sampled=dict(sampled, temperature=0.8, requests=4,
                           new_tokens=16)))
    return {"K3-verify": on_launches["K3-verify"],
            "K1-fwd-draft": model_launches["K1-fwd"]}


# cut from 16 for the run's time (pipe_ranks): the 4 after the first wave
# of 8 slots read the system prompt from the prefix cache
SPEC_INT8_REQUESTS = 12


def spec_int8_phase(torch, flash, paged, serving, eng):
    """The serve_int8 configuration (int8 weights and KV) with speculative
    decode and the prefix cache together: ``SPEC_INT8_REQUESTS`` requests
    sharing a 256-token system prompt of repeated spans, suffixes of
    64-512 tokens, 64 new tokens; drained with both off and both on."""
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(4)
    system = repeating(rng, V, 256)
    prompts = [np.concatenate([system, repeating(rng, V, n)])
               for n in rng.integers(64, 513, 16)[:SPEC_INT8_REQUESTS]]
    runs, reqs = {}, {}
    for on in (False, True):
        reqs[on], srv, row, launches = serve_drain(
            torch, flash, paged, serving, eng, prompts, kv_quant="int8",
            spec_decode=on, spec_k=4, prefix_cache=on)
        runs["on" if on else "off"] = dict(
            row, launches=launches, stats=spec_stats(srv),
            prefix_hits=srv.stats["prefix_hits"],
            prefix_tokens_saved=srv.stats["prefix_tokens_saved"],
            cow_copies=srv.cache.cow_copies,
            peak_used_blocks=srv.cache.peak_used_blocks)
        del srv
    on_launches = runs["on"]["launches"]
    check(on_launches["K3-int8-verify"] > 0 and on_launches["K4"] > 0
          and on_launches["K3-verify"] == 0 and on_launches["K3"] == 0,
          f"the int8 spec drain should launch K3-int8-verify and K4 only: "
          f"{on_launches}")
    check(runs["on"]["prefix_hits"] > 0, f"int8 prefix cache: {runs['on']}")
    agree = agreement(reqs[False], reqs[True])
    parted = partings(torch, eng, serving, reqs[False], reqs[True], "int8")
    oracle = StreamDraft([r.tokens for r in reqs[True][:4]], V, mutate=False)
    oreqs, srv, row, launches = serve_drain(
        torch, flash, paged, serving, eng, prompts[:4], kv_quant="int8",
        spec_decode=True, spec_k=4, prefix_cache=True, spec_draft=oracle)
    runs["oracle"] = dict(row, launches=launches, stats=spec_stats(srv),
                          requests=8,
                          greedy_prefix_agreement_vs_on=agreement(
                              reqs[True][:4], oreqs))
    del srv
    emit(dict(phase="spec_int8", model="llama-7b", layers=eng.cfg.n_layers,
              weights="int8 (weight-only), bf16 activations",
              kv_cache="int8 blocks", spec_k=4, drafter="ngram",
              requests=SPEC_INT8_REQUESTS, system_prompt=256,
              prompt_lens=[int(len(p)) for p in prompts], new_tokens=64,
              off=runs["off"], on=runs["on"], oracle_draft=runs["oracle"],
              greedy_prefix_agreement_on_vs_off=agree,
              greedy_full_agreement_on_vs_off=sum(a == 64 for a in agree),
              partings=parted))
    return {"K3-int8-verify": on_launches["K3-int8-verify"],
            "K4-spec": on_launches["K4"]}


# ---------------------------------------------------------------------------
# chaos: the fault-tolerance layer on the card
# ---------------------------------------------------------------------------

CHAOS_NEW = 32
CHAOS_FLIGHT_DIR = os.path.join(REPO, "build", "chip_smoke_flight")


def chaos_requests(serving, prompts, new=CHAOS_NEW):
    return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new,
                                 logprobs=True)
            for i, p in enumerate(prompts)]


def chaos_streams(reqs):
    """{rid: (tokens, logprobs)} of the requests a drain retired."""
    return {r.rid: (list(r.out), list(r.out_logprobs)) for r in reqs}


def chaos_run(torch, flash, paged, faults, make, reqs, spec=""):
    """Drain ``reqs`` through ``make()``'s engine, built and run with the
    ``spec`` faults as the ambient injector (so the ``engine.*`` and
    ``cache.quantize`` sites see them too) and the launch counters zeroed
    just before. A DegradedError is caught and returned without its
    traceback (whose frames would keep the engine and its pools alive).
    The engines of earlier drains, which hold cycles (a recorder's
    sections, the breakdown's barrier), are collected first, so the card
    holds one drain's pools at a time. Returns (engine, error or None,
    launches, fired log, seconds)."""
    gc.collect()
    torch.cuda.empty_cache()
    err = None
    with faults.injected(*faults.parse_spec(spec)) as inj:
        srv = make()
        reset_launches(flash, paged)
        t0 = time.perf_counter()
        try:
            srv.run(reqs)
        except Exception as e:
            if type(e).__name__ != "DegradedError":
                raise
            err = e.with_traceback(None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernel_launches(flash, paged)
    return srv, err, launches, list(inj.fired), secs


def chaos_row(name, srv, launches, fired, secs, **extra):
    st = srv.stats
    row = dict(drain=name, seconds=secs, retries=st["retries"],
               spec_fallbacks=st["spec_fallbacks"],
               horizon_fallbacks=st["horizon_fallbacks"],
               timeouts=st["timeouts"], shed=st["shed"],
               watchdog_trips=st["watchdog_trips"],
               evictions=st["evictions"], launches=launches,
               fired=[list(f) for f in fired],
               device_time_s=srv.device_time_snapshot())
    row.update(extra)
    return row


def fault_records(srv):
    """The tracer's ``fault`` records as (site, kind, visit)."""
    return [(d["site"], d["kind"], d["visit"])
            for _, etype, _, _, _, d in srv.telemetry.tracer.records()
            if etype == "fault"]


def chaos_phase(torch, flash, paged, serving, eng, serve_reqs):
    """Faults injected into the main serving path at full width and depth
    (llama-7b, bf16, the serve phase's engine): 8 of the serve phase's
    prompts, 32 new tokens, greedy, 8 slots, block 16, chunk 256.
    Retries give the fault-free streams and logprobs bit for bit and the
    fault-free K3 launches (a retry launches nothing twice); a faulted
    horizon degrades to one token with the same streams; deadlines and a
    bounded queue retire requests as ``timeout`` and ``shed``; the
    watchdog raises DegradedError after writing a postmortem artifact the
    port's reader verifies, the degraded engine drains to the fault-free
    streams, and its snapshot resumes in a fresh engine."""
    from deepspeed_tpu_torch.tools import postmortem
    from deepspeed_tpu_torch.utils import faults
    t_phase = time.perf_counter()
    prompts = [r.prompt for r in serve_reqs[:8]]

    def make(**kw):
        return lambda: serving.ServingEngine(eng, num_slots=8, block_size=16,
                                             prefill_chunk=256, **kw)

    def run(spec="", reqs=None, **kw):
        return chaos_run(torch, flash, paged, faults, make(**kw),
                         reqs or chaos_requests(serving, prompts), spec)

    rows = []
    base, _, base_l, _, secs = run()
    ref = chaos_streams(base.finished)
    check(len(ref) == 8 and all(len(t) == CHAOS_NEW for t, _ in ref.values()),
          "chaos: the fault-free drain did not finish 8 requests")
    check(base_l["K3"] > 0, f"chaos: no K3 launch: {base_l}")
    rows.append(chaos_row("fault-free", base, base_l, [], secs))
    del base

    # 1. retries: 4 device errors at the prefill and decode dispatches and
    # in the decode slot program
    spec = ("serving.prefill:device_error@1;serving.decode:device_error@2*2;"
            "engine.decode:device_error@5")
    srv, _, lau, fired, secs = run(spec, max_retries=3,
                                   retry_backoff_s=0.001, telemetry=True)
    rids = [r.rid for r in srv.finished]
    check(chaos_streams(srv.finished) == ref, "chaos retries: streams or "
          "logprobs differ from the fault-free drain")
    check(len(fired) == 4 and srv.stats["retries"] == 4,
          f"chaos retries: {srv.stats['retries']} retries for {fired}")
    check(lau["K3"] == base_l["K3"], f"chaos retries: K3 {lau['K3']} "
          f"launches against the fault-free {base_l['K3']}")
    check(sorted(rids) == list(range(8)) and {r.state for r in srv.finished}
          == {"done"}, f"chaos retries: terminal states {rids}")
    check(fault_records(srv) == fired, f"chaos retries: trace fault records "
          f"{fault_records(srv)} against {fired}")
    rows.append(chaos_row("retries", srv, lau, fired, secs, spec=spec))

    # 2. the horizon degraded to one token twice
    spec = "serving.horizon:device_error@1*2"
    srv, _, lau, fired, secs = run(spec, decode_horizon=4, telemetry=True)
    check(srv.stats["horizon_fallbacks"] == 2, f"chaos horizon: "
          f"{srv.stats['horizon_fallbacks']} fallbacks")
    check(chaos_streams(srv.finished) == ref, "chaos horizon: streams or "
          "logprobs differ from the fault-free drain")
    rows.append(chaos_row("horizon", srv, lau, fired, secs, spec=spec,
                          decode_horizon=4))

    # 3. expiry and shedding: a queue of 4 sheds the last 4 of 8 submits;
    # two admitted requests have deadlines 12 ticks out
    reqs = chaos_requests(serving, prompts)
    for r in reqs[:2]:
        r.deadline = 12.0
    srv, _, lau, fired, secs = run(reqs=reqs, max_queue=4, telemetry=True)
    states = {r.rid: r.state for r in srv.finished}
    check(states == {0: "timeout", 1: "timeout", 2: "done", 3: "done",
                     4: "shed", 5: "shed", 6: "shed", 7: "shed"},
          f"chaos expiry: states {states}")
    for r in reqs[:2]:
        check(0 < len(r.out) < CHAOS_NEW and r.out == ref[r.rid][0][
            :len(r.out)], f"chaos expiry: request {r.rid}'s {len(r.out)} "
              f"tokens are no prefix of its fault-free stream")
    check(srv.stats["backpressure"] == 0.0 and srv.stats["shed"] == 4,
          f"chaos expiry: backpressure {srv.stats['backpressure']}, shed "
          f"{srv.stats['shed']}")
    rows.append(chaos_row("expiry_shed", srv, lau, fired, secs,
                          timed_out_tokens=[len(r.out) for r in reqs[:2]]))

    # 4. the watchdog with the flight recorder: two decode dispatches
    # over a 0.5 s budget (1.5 s slow faults; a step takes ~0.05-0.1 s)
    dump_s = []

    def watched():
        srv = make(step_time_budget_s=0.5, watchdog_grace=2, telemetry=True,
                   flight_recorder=True, flight_dir=CHAOS_FLIGHT_DIR)()
        dump = srv.flight.dump

        def timed(reason, extra=None):
            t0 = time.perf_counter()
            path = dump(reason, extra)
            dump_s.append(time.perf_counter() - t0)
            return path
        srv.flight.dump = timed
        return srv
    spec = "serving.decode:slow@4*2~1.5"
    srv, err, lau, fired, secs = chaos_run(
        torch, flash, paged, faults, watched,
        chaos_requests(serving, prompts), spec)
    check(err is not None and "over budget" in str(err),
          f"chaos watchdog: no DegradedError ({err!r})")
    trips = [(r[3], r[5]["elapsed_s"]) for r in srv.telemetry.tracer.records()
             if r[1] == "watchdog"]
    check(err.pending and srv.stats["watchdog_trips"] == 2,
          f"chaos watchdog: pending {len(err.pending)}, trips "
          f"{srv.stats['watchdog_trips']} (step, elapsed s: {trips})")
    path = srv.flight.dumps[-1]
    with open(path) as f:
        postmortem.verify_artifact(json.load(f))
    body = postmortem.load_artifact(path)
    summary = postmortem.analyze_postmortem(body)
    check([tuple(f) for f in summary["faults"]] == fired,
          f"chaos watchdog: the postmortem's faults {summary['faults']} "
          f"against {fired}")
    check(summary["identity"]["backend"] == "gpu",
          f"chaos watchdog: identity {summary['identity']}")
    srv.run()
    check(chaos_streams(srv.finished) == ref, "chaos watchdog: the degraded "
          "engine drained to other streams than the fault-free drain's")
    watch_row = chaos_row("watchdog", srv, lau, fired, secs)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    # the snapshot resumed in a fresh engine: every request reaches its
    # budget exactly once (bf16 re-prefill rounds differently: agreement
    # reported)
    fresh = make()()
    fresh.run([serving.ServeRequest.from_snapshot(s) for s in err.pending])
    resumed = {r.rid: list(r.out) for r in err.finished + fresh.finished}
    rids = [r.rid for r in err.finished + fresh.finished]
    check(sorted(rids) == list(range(8)) and all(
        len(t) == CHAOS_NEW for t in resumed.values()),
          f"chaos resume: {sorted(rids)} with lengths "
          f"{[len(t) for t in resumed.values()]}")
    watch_row.update(
        spec=spec, budget_s=0.5,
        pending=len(err.pending), artifact_bytes=os.path.getsize(path),
        dump_s=dump_s, artifact_sections=sorted(body),
        resumed_agreement=[agreed(resumed[i], ref[i][0]) for i in range(8)])
    rows.append(watch_row)
    emit(dict(phase="chaos", model="llama-7b", layers=eng.cfg.n_layers,
              dtype="bfloat16", requests=8, new_tokens=CHAOS_NEW,
              drains=rows, seconds=time.perf_counter() - t_phase))
    return {"K3": base_l["K3"], "K3-retries": rows[1]["launches"]["K3"]}


def chaos_int8_phase(torch, flash, paged, serving, eng, serve_reqs):
    """Device errors at ``cache.quantize`` and ``engine.decode`` on the
    int8 engine (int8 weights and KV): the fault-free streams and
    logprobs, and its K3-int8 and K4 launches."""
    from deepspeed_tpu_torch.utils import faults
    t_phase = time.perf_counter()
    prompts = [r.prompt for r in serve_reqs[:8]]

    def make():
        return serving.ServingEngine(eng, num_slots=8, block_size=16,
                                     prefill_chunk=256, kv_quant="int8",
                                     retry_backoff_s=0.001)
    base, _, base_l, _, s0 = chaos_run(torch, flash, paged, faults, make,
                                       chaos_requests(serving, prompts))
    spec = "cache.quantize:device_error@3;engine.decode:device_error@6"
    srv, _, lau, fired, secs = chaos_run(torch, flash, paged, faults, make,
                                         chaos_requests(serving, prompts),
                                         spec)
    check(chaos_streams(srv.finished) == chaos_streams(base.finished),
          "chaos int8: streams or logprobs differ from the fault-free drain")
    check(len(fired) == 2 and srv.stats["retries"] == 2,
          f"chaos int8: {srv.stats['retries']} retries for {fired}")
    for k in ("K3-int8", "K4"):
        check(lau[k] == base_l[k] > 0, f"chaos int8: {k} {lau[k]} launches "
              f"against the fault-free {base_l[k]}")
    emit(dict(phase="chaos_int8", model="llama-7b", layers=eng.cfg.n_layers,
              dtype="int8 weights, int8 KV", requests=8,
              new_tokens=CHAOS_NEW,
              drains=[chaos_row("fault-free", base, base_l, [], s0),
                      chaos_row("retries", srv, lau, fired, secs,
                                spec=spec)],
              seconds=time.perf_counter() - t_phase))


def chaos_fp32(torch, paged, serving, gpu, prompts, stream):
    """The exactness tier of the chaos contract on the card (float32,
    llama-7b width, 2 layers): cache exhaustion that evicts and
    re-prefills, a faulted prefix match and copy-on-write, faulted drafts
    and verifies (K3's verify mode runs, then the steps degrade), a
    faulted host-tier restore and a corrupted host block each give the
    fault-free greedy streams exactly."""
    from deepspeed_tpu_torch.utils import faults
    V = gpu.cfg.vocab_size

    def serve(spec="", one_at_a_time=None, **kw):
        with faults.injected(*faults.parse_spec(spec)) as inj:
            srv = serving.ServingEngine(gpu, num_slots=2, block_size=16,
                                        prefill_chunk=32,
                                        retry_backoff_s=0.001, **kw)
            if one_at_a_time is None:
                out = srv.run([serving.ServeRequest(
                    rid=i, prompt=p, max_new_tokens=24)
                    for i, p in enumerate(prompts)])
            else:
                out = {}
                for i, p in enumerate(one_at_a_time):
                    out.update(srv.run([serving.ServeRequest(
                        rid=i, prompt=p, max_new_tokens=8)]))
        return {k: v.tolist() for k, v in out.items()}, srv, list(inj.fired)

    rng = np.random.default_rng(11)
    sys_a, sys_b = repeating(rng, V, 64), repeating(rng, V, 64)
    tier = [np.concatenate([s, repeating(rng, V, 8)])
            for s in (sys_a,) * 3 + (sys_b,) * 3 + (sys_a,) * 2]
    ref, _, _ = serve()
    tier_ref, _, _ = serve(one_at_a_time=tier)
    # a small pool under constant spill pressure: family A's chain is on
    # the host when A returns
    tier_kw = dict(prefix_cache=True, host_tier=True, num_blocks=24,
                   spill_watermark=99)
    cases = {
        "evict": ("cache.ensure:cache_exhausted@5", {}, None),
        "prefix": ("cache.match:cache_exhausted@1;"
                   "cache.cow:cache_exhausted@0",
                   dict(prefix_cache=True), None),
        "spec": ("serving.spec_draft:device_error@1*2;"
                 "engine.verify:device_error@3*2",
                 dict(spec_decode=True, spec_k=4, spec_draft=stream), None),
        "restore": ("cache.restore:cache_exhausted@0", tier_kw, tier),
        "corrupt": ("cache.host_corrupt:cache_exhausted@0", tier_kw, tier)}
    rows = {}
    for name, (spec, kw, seq) in cases.items():
        v0 = paged.paged_attention.verify_launches
        out, srv, fired = serve(spec, one_at_a_time=seq, **kw)
        want = {f.site for f in faults.parse_spec(spec)}
        check({s for s, _, _ in fired} == want,
              f"chaos_fp32 {name}: fired {fired}, wanted {want}")
        check(out == (ref if seq is None else tier_ref),
              f"chaos_fp32 {name}: streams differ from the fault-free ones")
        st = srv.stats
        rows[name] = dict(spec=spec, fired=[list(f) for f in fired],
                          evictions=st["evictions"],
                          prefix_hits=st["prefix_hits"],
                          cow_copies=srv.cache.cow_copies,
                          spec_fallbacks=st["spec_fallbacks"],
                          verify_launches=paged.paged_attention
                          .verify_launches - v0,
                          host_restores=st["host_restores"],
                          host_restore_failures=st["host_restore_failures"])
    check(rows["evict"]["evictions"] >= 1 and rows["spec"][
        "spec_fallbacks"] == 4 and rows["spec"]["verify_launches"] > 0
          and rows["restore"]["host_restore_failures"] >= 1
          and rows["corrupt"]["host_restore_failures"] >= 1,
          f"chaos_fp32: a degrade path did not run: {rows}")
    return rows


class StreamDraft:
    """A drafter that proposes the continuation of known reference
    streams; an unknown context repeats its last token. With ``mutate``
    one of its k tokens is changed in turn (none every (k + 1)-th call),
    so that whole, partial and no acceptance all occur."""

    def __init__(self, refs, vocab, mutate=True):
        self.refs = [np.asarray(r) for r in refs]
        self.vocab = vocab
        self.mutate = mutate

    def propose(self, context, k):
        ctx = np.asarray(context)
        for ref in self.refs:
            if ctx.size < ref.size and np.array_equal(ref[:ctx.size], ctx):
                out = np.resize(ref[ctx.size:ctx.size + k], k).astype(
                    np.int32)
                j = ctx.size % (k + 1)
                if self.mutate and j < k:
                    out[j] = (out[j] + 1) % self.vocab
                return out
        return np.full((k,), ctx[-1], np.int32)


# new tokens per request in spec_parity (cut from 24 for the run's time)
SPEC_PARITY_NEW = 16


def spec_parity_phase(torch, paged, gpt, InferenceEngine, serving,
                      speculative, cfg, params):
    """The card-side exactness tier of the slice: llama-7b width at 2
    layers in float32. Greedy streams on the card with speculation on,
    with the prefix cache on and with both are identical to spec-off,
    prefix-off serving on the card and on the host; generate_speculative
    on the card equals the target's generate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cpu")
    gpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cuda")
    V = cfg.vocab_size
    rng = np.random.default_rng(5)
    system = repeating(rng, V, 40)
    prompts = [np.concatenate([system, repeating(rng, V, n)])
               for n in (9, 30, 21)]

    def serve(e, **kw):
        srv = serving.ServingEngine(e, num_slots=2, block_size=16,
                                    prefill_chunk=32, **kw)
        out = srv.run([serving.ServeRequest(rid=i, prompt=p,
                                            max_new_tokens=SPEC_PARITY_NEW)
                       for i, p in enumerate(prompts)])
        return out, srv.stats
    host, _ = serve(cpu)
    # the n-gram drafter's proposals are rarely accepted by random weights;
    # the stream drafter's are, in part
    stream = StreamDraft(host.values(), V)
    modes = {"off": {}, "spec": dict(spec_decode=True, spec_k=4),
             "spec_stream": dict(spec_decode=True, spec_k=4,
                                 spec_draft=stream),
             "prefix": dict(prefix_cache=True),
             "both": dict(spec_decode=True, spec_k=4, spec_draft=stream,
                          prefix_cache=True)}
    rows = {}
    for name, kw in modes.items():
        out, st = serve(gpu, **kw)
        same = [bool(np.array_equal(out[i], host[i])) for i in host]
        rows[name] = dict(identical_to_host=same,
                          spec_proposed=st["spec_proposed"],
                          spec_accepted=st["spec_accepted"],
                          prefix_hits=st["prefix_hits"])
        check(all(same), f"spec_parity: card {name} streams differ from the "
              f"host's spec-off, prefix-off streams: {same}")
    check(rows["spec_stream"]["spec_accepted"] > 0
          and rows["both"]["spec_accepted"] > 0
          and rows["both"]["prefix_hits"] > 0,
          f"spec_parity drove no accepted draft or no sharing: {rows}")
    chaos = chaos_fp32(torch, paged, serving, gpu, prompts, stream)
    dcfg = gpt.preset("llama-7b", n_layers=1)
    draft = InferenceEngine((dcfg, gpt.init_params(
        dcfg, seed=2, device="cpu", dtype=torch.float32)),
        dtype=torch.float32, device="cuda")
    toks = np.stack([repeating(rng, V, 32) for _ in range(2)])
    ref = gpu.generate(toks, max_new_tokens=16)
    got, st = speculative.generate_speculative(gpu, draft, toks,
                                               max_new_tokens=16, gamma=4,
                                               return_stats=True)
    check(np.array_equal(got, ref), "generate_speculative on the card differs "
          "from the target's generate")
    check(np.array_equal(ref, cpu.generate(toks, max_new_tokens=16)),
          "generate on the card differs from the host's")
    emit(dict(phase="spec_parity", model="llama-7b width, 2 layers",
              dtype="float32", requests=3, new_tokens=SPEC_PARITY_NEW,
              card=rows,
              generate_speculative=dict(batch=2, prompt=32, new=16,
                                        gamma=4, stats=st,
                                        equals_generate=True),
              chaos_fp32=chaos))
    del cpu, gpu, draft, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3d: multi-tenant LoRA serving
# ---------------------------------------------------------------------------

LORA_RANKS = (8, 8, 16, 16)
LORA_TARGETS = ("qkv", "attn_out", "mlp_in", "mlp_gate", "mlp_out")
# the adapter pool of the LoRA phases: rank blocks of 8 up to rank 16
LORA_POOL = dict(lora_serve=True, lora_max_rank=16, lora_rank_block=8)
# an adapter's delta over its base projection, by RMS
LORA_DELTA = 0.1
# where two float32 streams may part: the two tokens' logits within this
# share of the logits' largest magnitude (a near-tie rounding flips);
# with int8 pools one code step, 1/127, as ``parity_int8`` holds them
TIE_TOL = {"off": 1e-4, "int8": 1.0 / 127}


def lora_exports(eng, seed=0):
    """Four seeded adapters (ranks ``LORA_RANKS``) on the five dense
    targets of the bf16 engine ``eng``, in the ``runtime/lora.py`` export
    format (float32 numpy): A ~ N(0, 1/r) as ``add_lora`` draws it, the
    scale alpha / r = 2, and B noise of std ``LORA_DELTA`` sigma_W / 2, so
    that for an input h the delta h A B s has about ``LORA_DELTA`` of the
    RMS of the projection h W (sigma_W: the std of the target's layer-0
    kernel; ``delta_ratios`` measures it)."""
    block = eng.params["block"]
    rng = np.random.default_rng(seed)
    sig = {t: float(block[t]["kernel"][0].float().std())
           for t in LORA_TARGETS}
    out = {}
    for i, r in enumerate(LORA_RANKS):
        sd = {}
        for t in LORA_TARGETS:
            L, din, dout = block[t]["kernel"].shape
            sd[f"block/{t}/lora_a"] = rng.standard_normal(
                (L, din, r), np.float32) / np.float32(np.sqrt(r))
            sd[f"block/{t}/lora_b"] = rng.standard_normal(
                (L, r, dout), np.float32) * np.float32(
                    LORA_DELTA * sig[t] / 2.0)
            sd[f"block/{t}/lora_scale"] = np.full((L,), 2.0, np.float32)
        out[f"tenant{i}"] = sd
    return out


def cut_exports(exports, n_layers):
    """The adapters of ``exports`` on their first ``n_layers`` layers."""
    return {aid: {k: v[:n_layers] for k, v in sd.items()}
            for aid, sd in exports.items()}


def delta_ratios(torch, eng, sd, n=64):
    """Per target, RMS(h A B s) / RMS(h W) on layer 0 for ``n`` standard
    normal inputs, float32 on the card: the adapter's delta against the
    projection it adapts."""
    g = torch.Generator(device=eng.device).manual_seed(0)
    out = {}
    for t in LORA_TARGETS:
        w = eng.params["block"][t]["kernel"][0].float()
        h = torch.randn(n, w.shape[0], generator=g, device=eng.device)
        a, b = (torch.from_numpy(sd[f"block/{t}/lora_{x}"][0]).to(eng.device)
                for x in "ab")
        d = (h @ a) @ b * float(sd[f"block/{t}/lora_scale"][0])
        out[t] = float(d.pow(2).mean().sqrt() / (h @ w).pow(2).mean().sqrt())
    return out


def lora_requests(serving, prompts, aids, new=64):
    """One greedy request per prompt with logprobs: every fourth
    base-only, the others naming ``aids`` round-robin."""
    reqs, k = [], 0
    for i, p in enumerate(prompts):
        aid = None
        if i % 4 != 3:
            aid, k = aids[k % len(aids)], k + 1
        reqs.append(serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new,
                                         logprobs=True, adapter_id=aid))
    return reqs


def lora_cost(torch, serving, eng, exports, pairs=3, steps=4, **kw):
    """What LoRA serving costs a steady decode step: two warm 8-slot
    engines over ``eng`` and the same prompts (~520 tokens), LoRA off and
    on (6 of the 8 slots under ``exports``), timed in windows of
    ``steps`` steps in turns, ``pairs`` pairs (which side goes first
    alternates, as the host's speed drifts): wall and host CPU ms per
    emitted token per window and the on/off ratio of each pair. Then one
    profiled step of each side (the ``trace`` step: wall, device busy,
    idle share, aten calls). Returns the row."""
    new = (2 * pairs + 1) * steps + 8
    sides = {on: warm_decoder(torch, serving, eng,
                              np.random.default_rng(14), new,
                              adapters=exports if on else None, **kw)
             for on in (False, True)}
    per = {False: [], True: []}
    for p in range(pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            wall, cpu, n = timed_steps(torch, *sides[on], steps, 8 * steps)
            per[on].append((wall * 1e3 / n, cpu * 1e3 / n))
    traced = {on: profiled_steps(torch, *sides[on], 1, 8)
              for on in (False, True)}
    wall = {on: [w for w, _ in per[on]] for on in per}
    cpu = {on: [c for _, c in per[on]] for on in per}
    ratios = [a / b for a, b in zip(wall[True], wall[False])]
    del sides
    gc.collect()
    return dict(pairs=pairs, steps_per_window=steps,
                wall_ms_per_token_off=wall[False],
                wall_ms_per_token_on=wall[True],
                host_cpu_ms_per_token_off=cpu[False],
                host_cpu_ms_per_token_on=cpu[True],
                median_wall_ms_per_token_off=float(np.median(wall[False])),
                median_wall_ms_per_token_on=float(np.median(wall[True])),
                wall_on_over_off_per_pair=ratios,
                median_wall_on_over_off=float(np.median(ratios)),
                pairs_on_slower=sum(r > 1.0 for r in ratios),
                trace_off={k: v for k, v in traced[False].items()
                           if not k.startswith("top_")},
                trace_on=traced[True],
                aten_calls_per_step_added=traced[True]["aten_calls_per_step"]
                - traced[False]["aten_calls_per_step"])


def lora_phase(torch, flash, paged, serving, eng, exports, base, name,
               ratios=None, **kw):
    """LoRA serving at full width on the serve (or serve_int8) engine: the
    base phase's 16 prompts, 12 requests under the four adapters
    round-robin and every fourth base-only, 64 new tokens, 8 slots,
    block 16, chunk 256, a pool of 6 rank blocks of 8 (the four adapters
    exactly: no eviction), against the base phase's LoRA-off drain of the
    same requests (``base``: its requests, launches and drain row). Every
    base-only stream and its logprobs bit for bit, every adapter stream
    different from its base stream, the same launches of every kernel
    (the delta is a torch product), 4 loads, 8 hits, no error, the pool
    7 blocks (the zero block and 6) and every pin dropped after. Then ``lora_cost``: LoRA off and on in alternating windows of
    steady decode steps, and one profiled step of each. ``ratios``:
    ``delta_ratios`` of the adapters, for the row. Returns the drain's
    launches."""
    cfg = eng.cfg
    aids = sorted(exports)
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, lora_pool_blocks=6,
                                **LORA_POOL, **kw)
    t0 = time.perf_counter()
    for aid in aids:
        srv.register_adapter(aid, exports[aid])
    register_s = time.perf_counter() - t0
    off_reqs = base["reqs"]
    reqs = lora_requests(serving, [r.prompt for r in off_reqs], aids)
    torch.cuda.synchronize()
    reset_launches(flash, paged)
    step_end, t_submit = drain(torch, srv, reqs)
    launches = kernel_launches(flash, paged)
    check(len(srv.finished) == 16 and all(len(r.out) == 64 for r in reqs),
          f"{name}: lost requests or tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), f"{name}: non-finite logprobs")
    same = {r.rid: (r.out == o.out, r.out_logprobs == o.out_logprobs)
            for r, o in zip(reqs, off_reqs) if r.adapter_id is None}
    check(all(a and b for a, b in same.values()),
          f"{name}: base-only streams or logprobs differ from the LoRA-off "
          f"drain's: {same}")
    differ = {r.rid: agreed(r.out, o.out) for r, o in zip(reqs, off_reqs)
              if r.adapter_id is not None}
    check(all(n < 64 for n in differ.values()),
          f"{name}: an adapter stream equals its base stream: {differ}")
    check(launches == base["launches"],
          f"{name}: launches {launches} differ from the LoRA-off drain's "
          f"{base['launches']}")
    st = srv.stats
    counts = {k: st[k] for k in st if k.startswith("adapter_")}
    check(counts == dict(adapter_hits=8, adapter_loads=4,
                         adapter_evictions=0, adapter_load_errors=0),
          f"{name}: adapter stats {counts}")
    pool = srv.adapters
    block_bytes = cfg.n_layers * 8 * eng.dtype.itemsize * sum(
        sum(eng.params["block"][t].get("kernel", eng.params["block"][t].get(
            "q")).shape[1:]) for t in LORA_TARGETS)
    check(pool._block_bytes == block_bytes
          and pool.pool_bytes == 7 * block_bytes
          and pool.stats()["resident"] == 4
          and all(pool.refcount(a) == 0 for a in aids)
          and not srv._slot_arows.any(),
          f"{name}: pool {pool.stats()}, block bytes {pool._block_bytes} "
          f"(want {block_bytes})")
    row = drain_row(step_end, t_submit, reqs)
    del srv
    gc.collect()
    cost = lora_cost(torch, serving, eng, exports, **kw)
    emit(dict(phase=name, model="llama-7b", layers=cfg.n_layers,
              dtype=str(eng.dtype).replace("torch.", ""),
              weights="int8" if eng.quantized else "bf16",
              kv_cache=kw.get("kv_quant", "off"),
              adapters=dict(ranks=list(LORA_RANKS), targets=LORA_TARGETS,
                            pool_blocks=6, rank_block=8,
                            block_bytes=block_bytes,
                            pool_bytes=pool.pool_bytes,
                            register_s=register_s,
                            delta_over_base_rms=ratios),
              requests=16, under_adapters=12, new_tokens=64,
              lora_on=row, lora_off=base["drain"],
              tokens_per_s_on_over_off=row["tokens_per_s"]
              / base["drain"]["tokens_per_s"],
              base_only_bit_for_bit=len(same),
              adapter_streams_agree_with_base_for=differ,
              stats=counts, pool=pool.stats(), launches=launches,
              cost=cost))
    return launches


def lora_parity_phase(torch, flash, paged, InferenceEngine, serving, lora,
                      faults, cfg, params, exports):
    """The exactness tier of LoRA serving on the card: llama-7b width at 2
    layers in float32 (the weights of ``parity`` and ``spec_parity``),
    the lora phase's adapters on those 2 layers, 4 tenant and 2 base-only
    requests of 29-64 tokens built from repeated spans, 32 new tokens,
    4 slots. Each stream, float and int8 pools, is held to its reference
    where a parting may only sit at a near-tie (``TIE_TOL``, judged on
    the reference engine's decode-mode logits of the shared context):

    - served under adapters: each adapter merged into the weights
      (``merge_lora``) and ``generate``d; base-only requests, the base
      ``generate``, and bit for bit the LoRA-off drain's streams;
    - the unmerged ``add_lora`` tree through ``generate`` (K1-fwd and the
      ``lora_a`` branch) against its merged tree;
    - a pool of 3 blocks over the 4 adapters with one slot, the four and
      the first again: admissions evict and the first reloads (5 loads,
      3 evictions);
    - speculation (spec_k 4, n-gram) against spec off (K3's verify mode
      counted; with int8 pools ``partings`` holds the verify mode to the
      decode mode's rounding), and the horizon N = 4 equal to N = 1;
    - with int8 pools the references are the merged engines served over
      int8 pools;
    - a ``cache.adapter_load`` fault of each kind retires its request
      ``error``, the base-only stream beside it is the fault-free one bit
      for bit, and the pool's ``stats()`` and bytes are unchanged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cuda")
    ex = cut_exports(exports, cfg.n_layers)
    aids = sorted(ex)
    V, NEW = cfg.vocab_size, 32
    rng = np.random.default_rng(7)
    jobs = list(zip([repeating(rng, V, n) for n in (40, 57, 33, 64, 48, 29)],
                    aids + [None, None]))

    def attach(sd):
        block = {t: dict(e) for t, e in gpu.params["block"].items()}
        for key, v in sd.items():
            _, t, leaf = key.split("/")
            block[t][leaf] = torch.from_numpy(v).to(gpu.device)
        return dict(gpu.params, block=block)
    merged = {aid: InferenceEngine((cfg, lora.merge_lora(attach(ex[aid]))),
                                   dtype=torch.float32, device="cuda")
              for aid in aids}
    merged[None] = gpu

    def serve(order, kv_quant="off", pool_blocks=6, num_slots=4, on=True,
              **kw):
        srv = serving.ServingEngine(
            gpu, num_slots=num_slots, block_size=16, prefill_chunk=32,
            kv_quant=kv_quant, **(dict(LORA_POOL, lora_pool_blocks=pool_blocks)
                                  if on else {}), **kw)
        for aid in aids if on else ():
            srv.register_adapter(aid, ex[aid])
        reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=NEW,
                                     adapter_id=aid if on else None)
                for i, (p, aid) in enumerate(order)]
        srv.run(reqs)
        check(all(r.state == "done" and len(r.out) == NEW for r in reqs),
              f"lora_parity: lost requests or tokens ({kv_quant}, {kw})")
        return srv, reqs

    def ties(what, reqs, refs, kv_quant="off", arbiter=None):
        """Where each stream parts from its reference: the two tokens'
        gap in the decode-mode logits of the reference engine (the
        request's merged engine, or ``arbiter``), over their largest
        magnitude."""
        rows = []
        for r, ref in zip(reqs, refs):
            a, b = np.asarray(ref), np.asarray(r.out)
            if np.array_equal(a, b):
                continue
            p = int(np.argmin(a == b))
            ctx = np.concatenate([r.prompt, a[:p]]).astype(np.int32)
            eng = merged[r.adapter_id] if arbiter is None else arbiter
            dec = mode_logits(torch, eng, serving, ctx, [0], kv_quant)[0]
            scale = float(np.abs(dec).max())
            top = np.sort(dec)[-2:]
            rows.append(dict(rid=r.rid, adapter=r.adapter_id, at=p,
                             gap=float(abs(dec[a[p]] - dec[b[p]])) / scale,
                             margin=float(top[1] - top[0]) / scale))
        bad = [x for x in rows if x["gap"] > TIE_TOL[kv_quant]]
        check(not bad, f"lora_parity {what}: streams part beyond a "
              f"near-tie (tol {TIE_TOL[kv_quant]}): {bad}")
        return rows

    refs = [merged[aid].generate(p[None], max_new_tokens=NEW)[0, len(p):]
            for p, aid in jobs]
    row = {}
    for kq in ("off", "int8"):
        out, t_mode = {}, time.perf_counter()
        if kq == "int8":
            # the references: each merged engine served over int8 pools
            refs = []
            for p, aid in jobs:
                r = serving.ServeRequest(rid=0, prompt=p, max_new_tokens=NEW)
                serving.ServingEngine(merged[aid], num_slots=4, block_size=16,
                                      prefill_chunk=32,
                                      kv_quant="int8").run([r])
                refs.append(r.out)
        srv, reqs = serve(jobs, kq)
        out["served"] = ties(f"served {kq}", reqs, refs, kq)
        check(srv.stats["adapter_loads"] == 4, f"{srv.stats}")
        _, off = serve(jobs, kq, on=False)
        base_same = [r.out == o.out for r, o in zip(reqs, off)
                     if r.adapter_id is None]
        check(all(base_same), f"lora_parity {kq}: base-only streams differ "
              f"from the LoRA-off drain's")
        # eviction: one slot, 3 blocks, the four tenants and the first
        # again (1, 1, 2 and 2 blocks: the third evicts the first, the
        # fourth the second and third, the first reloads)
        order = [jobs[i % 4] for i in range(5)]
        ev, ev_reqs = serve(order, kq, pool_blocks=3, num_slots=1)
        counts = {k: ev.stats[f"adapter_{k}"]
                  for k in ("loads", "evictions", "hits")}
        check(counts == dict(loads=5, evictions=3, hits=0),
              f"lora_parity {kq}: eviction counts {counts}")
        out["eviction"] = dict(counts, partings=ties(
            f"eviction {kq}", ev_reqs, [refs[i % 4] for i in range(5)], kq))
        # speculation against spec off, the verify launches counted
        key = "K3-int8-verify" if kq == "int8" else "K3-verify"
        reset_launches(flash, paged)
        sp, sp_reqs = serve(jobs, kq, spec_decode=True, spec_k=4)
        verify = kernel_launches(flash, paged)[key]
        check(verify > 0 and sp.stats["spec_steps"] > 0,
              f"lora_parity {kq}: no verify under adapters ({verify})")
        if kq == "off":
            spec = ties("spec", sp_reqs, [r.out for r in reqs], kq)
        else:
            pool = srv.adapters
            spec = partings(torch, gpu, serving, reqs, sp_reqs, "int8",
                            lora_of=lambda r: None if r.adapter_id is None
                            else pool.lora_args(pool._row(r.adapter_id)))
        out["spec"] = dict(launches={key: verify},
                           proposed=sp.stats["spec_proposed"],
                           accepted=sp.stats["spec_accepted"], partings=spec)
        # the horizon: N = 4 gives the N = 1 streams
        hz, hz_reqs = serve(jobs, kq, decode_horizon=4)
        check([r.out for r in hz_reqs] == [r.out for r in reqs],
              f"lora_parity {kq}: the N = 4 streams differ from N = 1's")
        out["horizon_n4_equal"] = True
        out["horizon_decode_steps"] = [hz.stats["decode_steps"],
                                       srv.stats["decode_steps"]]
        # a faulted adapter load of each kind
        (bp, _), (tp, tenant) = jobs[4], jobs[0]
        _, (clean,) = serve([(bp, None)], kq)
        faulted = {}
        for kind in ("cache_exhausted", "device_error"):
            inj = faults.FaultInjector([faults.Fault("cache.adapter_load",
                                                     kind, step=0)])
            f_srv = serving.ServingEngine(
                gpu, num_slots=4, block_size=16, prefill_chunk=32,
                kv_quant=kq, faults=inj, lora_pool_blocks=6, **LORA_POOL)
            for aid in aids:
                f_srv.register_adapter(aid, ex[aid])
            before = f_srv.adapters.stats()
            pools = [t.clone() for t in (*f_srv.adapters.a_pool.values(),
                                         *f_srv.adapters.b_pool.values())]
            bad = serving.ServeRequest(rid="bad", prompt=tp,
                                       max_new_tokens=NEW, adapter_id=tenant)
            ok = serving.ServeRequest(rid="ok", prompt=bp, max_new_tokens=NEW)
            f_srv.run([bad, ok])
            check(bad.state == "error" and ok.state == "done"
                  and ok.out == clean.out
                  and f_srv.adapters.stats() == before
                  and f_srv.stats["adapter_load_errors"] == 1
                  and inj.fired == [("cache.adapter_load", kind, 0)]
                  and all(torch.equal(a, b) for a, b in zip(
                      pools, (*f_srv.adapters.a_pool.values(),
                              *f_srv.adapters.b_pool.values()))),
                  f"lora_parity {kq}: a {kind} load fault: {bad.state}, "
                  f"{ok.state}, {f_srv.adapters.stats()} vs {before}")
            again = serving.ServeRequest(rid="again", prompt=tp,
                                         max_new_tokens=NEW,
                                         adapter_id=tenant)
            f_srv.run([again])
            faulted[kind] = dict(states=[bad.state, ok.state, again.state],
                                 partings=ties(f"{kind} retry", [again],
                                               [refs[0]], kq))
        out["faults"] = faulted
        out["seconds"] = time.perf_counter() - t_mode
        row[kq] = out
    # the unmerged add_lora tree through generate against its merge
    g = torch.Generator(device=gpu.device).manual_seed(3)
    tree = lora.add_lora(gpu.params, g, rank=8, alpha=16.0)
    for t in LORA_TARGETS:
        e = tree["block"][t]
        e["lora_b"] = torch.randn(e["lora_b"].shape, generator=g,
                                  device=gpu.device) * (
            LORA_DELTA * float(e["kernel"][0].std()) / 2.0)
    unmerged = InferenceEngine((cfg, tree), dtype=torch.float32,
                               device="cuda")
    m_eng = InferenceEngine((cfg, lora.merge_lora(tree)),
                            dtype=torch.float32, device="cuda")
    toks = np.stack([repeating(rng, V, 48) for _ in range(2)])
    reset_launches(flash, paged)
    got = unmerged.generate(toks, max_new_tokens=NEW)
    k1 = kernel_launches(flash, paged)["K1-fwd"]
    check(k1 == cfg.n_layers, f"lora_parity: the unmerged generate launched "
          f"K1-fwd {k1} times")
    want = m_eng.generate(toks, max_new_tokens=NEW)
    gen_reqs = [serving.ServeRequest(rid=i, prompt=toks[i],
                                     max_new_tokens=NEW)
                for i in range(2)]
    for r, out in zip(gen_reqs, got):
        r.out = [int(t) for t in out[48:]]
    row["unmerged_generate"] = dict(
        launches={"K1-fwd": k1},
        partings=ties("unmerged generate", gen_reqs,
                      [w[48:] for w in want], arbiter=m_eng))
    emit(dict(phase="lora_parity", model="llama-7b width, 2 layers",
              dtype="float32", requests=6, under_adapters=4, new_tokens=NEW,
              tie_tol=TIE_TOL, **row))
    del gpu, merged, unmerged, m_eng, tree
    gc.collect()
    torch.cuda.empty_cache()
    return {"K1-fwd": k1,
            "K3-verify": row["off"]["spec"]["launches"]["K3-verify"],
            "K3-int8-verify":
            row["int8"]["spec"]["launches"]["K3-int8-verify"]}


# ---------------------------------------------------------------------------
# slice 11: the replica router, the disaggregated fleet, the autoscaler
# ---------------------------------------------------------------------------

ROUTER_NEW = 32
# the migration staging pool's budget (DS_KV_HOST_BUDGET_MB, MiB): the
# 256 MiB default holds about 60 blocks of the serve engine's 16
# llama-7b layers (4.2 MB each), short of a 1024-token prompt's 64
MIGRATION_BUDGET_MB = "1024"
# the router.step visit the router phase's crash fires at: two replicas
# step per router step, so visit 20 is router step 10, inside the decode
ROUTER_CRASH_VISIT = 20


@contextlib.contextmanager
def env_flag(name, value):
    """The environment flag ``name`` set to ``value`` inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def fleet_drain(torch, router, reqs):
    """``drain`` for a router: submit ``reqs`` and step the fleet until
    idle, waiting for the card after each step. The router's clock ticks
    once per step and stamps every replica's tokens, so ``drain_row``
    reads the result."""
    t_submit = time.perf_counter()
    for r in reqs:
        router.submit(r)
    step_end = []
    while router.busy:
        router.step()
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
    return step_end, t_submit


def serve_replica(serving, eng, **kw):
    """A replica in the serve phase's geometry: 8 slots, block 16, chunk
    256."""
    return serving.ServingEngine(eng, num_slots=8, block_size=16,
                                 prefill_chunk=256, **kw)


def pool_bytes(srv):
    return sum(t.nbytes for t in srv.cache._pools())


def fleet_finished(router):
    """{rid: the request in its terminal state}: a drained request is
    resumed as a new object on a survivor, so the caller's is stale."""
    out = {r.rid: r for r in router._finished}
    for rep in router.replicas:
        out.update({r.rid: r for r in rep.srv.finished})
    return out


def router_phase(torch, flash, paged, serving, router_lib, faults, eng,
                 serve_reqs):
    """The replica router at full width: two mixed replicas of the serve
    geometry sharing the serve phase's llama-7b engine. The 16 serve
    requests at ``ROUTER_NEW`` new tokens through the router (launch
    counters at 0 just before): every request done, K3 launched, the
    requests per replica, affinity hits, TTFT and TPOT, and the tokens
    each stream agrees with the serve drain's (bf16: reported). Then 8
    of them on a fresh fleet with a ``router.step`` crash mid-decode:
    every request done, requests drained, one breaker trip; then
    ``restart_replica`` through a factory sharing the engine, and a
    probe that returns the rebuilt replica to ``healthy``. Returns the
    fault-free drain's launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    router = router_lib.ReplicaRouter(
        [serve_replica(serving, eng), serve_replica(serving, eng)],
        telemetry=True)
    per_replica_bytes = pool_bytes(router.replicas[0].srv)
    reqs = [serving.ServeRequest(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=ROUTER_NEW, logprobs=True)
            for r in serve_reqs]
    reset_launches(flash, paged)
    step_end, t_submit = fleet_drain(torch, router, reqs)
    launches = kernel_launches(flash, paged)
    peak_gib = (torch.cuda.max_memory_allocated() - m0) / 2**30
    check(all(r.state == "done" and len(r.out) == ROUTER_NEW for r in reqs),
          "router: lost requests or tokens")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), "router: non-finite logprobs")
    check(launches["K3"] > 0, f"router: K3 never launched: {launches}")
    per_replica = [len(rep.srv.finished) for rep in router.replicas]
    check(sum(per_replica) == 16 and min(per_replica) > 0,
          f"router: requests per replica {per_replica}")
    agree = [agreed(r.out, o.out[:ROUTER_NEW])
             for r, o in zip(reqs, serve_reqs)]
    row = dict(phase="router", model="llama-7b", layers=eng.cfg.n_layers,
               dtype="bfloat16", replicas=2, roles=["mixed", "mixed"],
               requests=16, new_tokens=ROUTER_NEW,
               requests_per_replica=per_replica,
               stats=dict(router.stats), launches=launches,
               drain=drain_row(step_end, t_submit, reqs),
               agreement_with_serve=agree,
               full_agreement_with_serve=sum(a == ROUTER_NEW for a in agree),
               pool_bytes_per_replica=per_replica_bytes,
               peak_mem_gib_over_engine=peak_gib)
    del router
    gc.collect()

    # a crash mid-decode, the drain, the warm restart
    inj = faults.FaultInjector([faults.Fault("router.step", "crash",
                                             step=ROUTER_CRASH_VISIT)])
    router = router_lib.ReplicaRouter(
        [serve_replica(serving, eng), serve_replica(serving, eng)],
        faults=inj, telemetry=True,
        replica_factory=lambda idx, tag: serve_replica(serving, eng))
    creqs = [serving.ServeRequest(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=ROUTER_NEW)
             for r in serve_reqs[:8]]
    t0 = time.perf_counter()
    router.run(creqs)
    torch.cuda.synchronize()
    crash_s = time.perf_counter() - t0
    st = router.stats
    done = fleet_finished(router)
    check(inj.fired == [("router.step", "crash", ROUTER_CRASH_VISIT)]
          and all(done[r.rid].state == "done"
                  and len(done[r.rid].out) == ROUTER_NEW for r in creqs)
          and st["drained_requests"] >= 1 and st["breaker_trips"] == 1
          and router.health().count("broken") == 1,
          f"router crash: {dict(st)}, {router.health()}, "
          f"{[done[r.rid].state for r in creqs if r.rid in done]}")
    broken = router.health().index("broken")
    crash = dict(fired=[list(f) for f in inj.fired], seconds=crash_s,
                 stats=dict(st), health=router.health(),
                 agreement_with_serve=[agreed(done[r.rid].out,
                                              o.out[:ROUTER_NEW])
                                       for r, o in zip(creqs, serve_reqs)])
    tag = router.restart_replica(broken)
    recovering = router.health()
    gc.collect()
    V = eng.cfg.vocab_size
    rng = np.random.default_rng(15)
    router.replicas[1 - broken].srv.submit(serving.ServeRequest(
        rid="ballast", prompt=rng.integers(1, V, 64).astype(np.int32),
        max_new_tokens=4))
    probe = serving.ServeRequest(
        rid="probe", prompt=rng.integers(1, V, 64).astype(np.int32),
        max_new_tokens=4)
    router.submit(probe)
    on_rebuilt = any(r is probe for r in router.replicas[broken].srv.queue)
    router.run()
    check(recovering[broken] == "recovering" and on_rebuilt
          and probe.state == "done"
          and router.health() == ["healthy", "healthy"]
          and router.stats["restarts"] == 1,
          f"router restart: {recovering} -> {router.health()}, probe on "
          f"the rebuilt replica {on_rebuilt}, {probe.state}")
    crash["restart"] = dict(replica=broken, tag=tag, health_after_restart=
                            recovering, health_after_probe=router.health())
    row["crash"] = crash
    emit(row)
    del router
    gc.collect()
    return launches


def router_lora_phase(torch, flash, paged, serving, router_lib, eng, exports,
                      serve_reqs):
    """Adapter affinity at full width: two replicas with LoRA serving
    (the lora phase's pool: 6 rank blocks of 8) and two of its adapters
    registered; per tenant a request and a follow-up, and two base-only
    requests (serve requests 3 and 7, base-only in the lora phase), 16
    new tokens. Each follow-up lands on its tenant's first replica, that
    replica's pool serves it as a hit, and the base-only streams and
    logprobs are bit for bit the first 16 of the lora phase's (which
    that phase holds to the serve drain's)."""
    aids = sorted(exports)[:2]
    fleet = [serve_replica(serving, eng, lora_pool_blocks=6, **LORA_POOL)
             for _ in range(2)]
    for srv in fleet:
        for aid in aids:
            srv.register_adapter(aid, exports[aid])
    router = router_lib.ReplicaRouter(fleet, telemetry=True)
    new = 16
    jobs = [("t0a", 0, aids[0]), ("t1a", 1, aids[1]), ("b3", 3, None),
            ("t0b", 4, aids[0]), ("t1b", 5, aids[1]), ("b7", 7, None)]
    reqs = [serving.ServeRequest(rid=rid, prompt=serve_reqs[i].prompt,
                                 max_new_tokens=new, logprobs=True,
                                 adapter_id=aid) for rid, i, aid in jobs]
    reset_launches(flash, paged)
    step_end, t_submit = fleet_drain(torch, router, reqs)
    launches = kernel_launches(flash, paged)
    home = {r.rid: rep.idx for rep in router.replicas
            for r in rep.srv.finished}
    check(all(r.state == "done" and len(r.out) == new for r in reqs)
          and launches["K3"] > 0,
          f"router_lora: {[r.state for r in reqs]}, {launches}")
    check(home["t0a"] == home["t0b"] and home["t1a"] == home["t1b"]
          and router.stats["adapter_affinity_hits"] >= 1,
          f"router_lora: follow-ups off their home replica: {home}, "
          f"{dict(router.stats)}")
    pools = [srv.adapters.stats() for srv in fleet]
    check(pools[home["t0a"]]["hits"] >= 1, f"router_lora: pools {pools}")
    base = {r.rid: (r.out == serve_reqs[i].out[:new],
                    r.out_logprobs == serve_reqs[i].out_logprobs[:new])
            for r, (_, i, aid) in zip(reqs, jobs) if aid is None}
    check(all(a and b for a, b in base.values()),
          f"router_lora: base-only streams or logprobs differ from the "
          f"lora phase's: {base}")
    emit(dict(phase="router_lora", model="llama-7b", dtype="bfloat16",
              replicas=2, adapters=aids, requests=len(reqs), new_tokens=new,
              replica_of=home, stats=dict(router.stats), pools=pools,
              base_only_bit_for_bit=len(base), launches=launches,
              drain=drain_row(step_end, t_submit, reqs)))
    del router, fleet
    gc.collect()


def migration_spy(torch, router):
    """Wrap every replica cache's ``migrate_gather`` and ``land_parked``:
    each half waited for and timed, the caching allocator's allocations
    inside it counted, and each landed chain held byte for byte to the
    source chain (every pool: K, V and, with int8 pools, the scales).
    The CRC32 of the first migration's host blocks is timed once, apart.
    Returns the list of per-migration rows it fills."""
    rows, pending = [], {}

    def allocs():
        return torch.cuda.memory_stats()["allocation.all.allocated"]
    for rep in router.replicas:
        cache = rep.srv.cache

        def gather(slot, pool, _c=cache, _orig=cache.migrate_gather):
            torch.cuda.synchronize()
            n0, t0 = allocs(), time.perf_counter()
            handle = _orig(slot, pool)
            pending[tuple(handle["keys"])] = (
                _c, list(_c._owned[slot]), time.perf_counter() - t0,
                allocs() - n0)
            return handle

        def land(rid, keys, pool, length, _c=cache, _orig=cache.land_parked):
            src, chain, gather_s, g_allocs = pending.pop(tuple(keys))
            crc_s = None
            if not rows:
                t0 = time.perf_counter()
                for k in keys:
                    for a in pool._entries[k][0]:
                        zlib.crc32(a)
                crc_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            n0, t0 = allocs(), time.perf_counter()
            n = _orig(rid, keys, pool, length)
            torch.cuda.synchronize()
            land_s = time.perf_counter() - t0
            l_allocs = allocs() - n0
            ids = _c._parked[rid][0]
            rows.append(dict(
                rid=rid, blocks=n, gather_s=gather_s, land_s=land_s,
                crc_one_pass_s=crc_s, allocations=g_allocs + l_allocs,
                equal=all(torch.equal(a[:, chain], b[:, ids])
                          for a, b in zip(src._pools(), _c._pools()))))
            return n
        cache.migrate_gather, cache.land_parked = gather, land
    return rows


def disagg_phase(torch, flash, paged, serving, router_lib, faults, eng,
                 serve_reqs, name, kv_quant="off"):
    """The disaggregated fleet at full width: a ``prefill`` and a
    ``decode`` replica of the serve geometry on the phase's engine (the
    serve engine, or with int8 pools the int8 engine), 8 of the serve
    requests at ``ROUTER_NEW`` new tokens (launch counters at 0 just
    before): 8 migrations and no fallback, every landed chain (K, V and
    the int8 scales) byte-equal to its source, no device allocation
    inside a migration, the ms per block and GB/s of each half and the
    CRC32's share, TTFT and TPOT, the streams' agreement with the serve
    drain (reported). Then a ``router.migrate_corrupt`` on one request:
    the landing's CRC32 check refuses it, it falls back cold and ends
    done. Returns the drain's launches."""
    fleet = [serve_replica(serving, eng, kv_quant=kv_quant)
             for _ in range(2)]
    with env_flag("DS_KV_HOST_BUDGET_MB", MIGRATION_BUDGET_MB):
        router = router_lib.ReplicaRouter(fleet, roles=["prefill", "decode"],
                                          telemetry=True)
    spy = migration_spy(torch, router)
    reqs = [serving.ServeRequest(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=ROUTER_NEW, logprobs=True)
            for r in serve_reqs[:8]]
    reset_launches(flash, paged)
    step_end, t_submit = fleet_drain(torch, router, reqs)
    launches = kernel_launches(flash, paged)
    st = router.stats
    falls = [r[5].get("reason") for r in router.telemetry.tracer.records()
             if r[1] == "migrate" and not r[5].get("ok")]
    check(all(r.state == "done" and len(r.out) == ROUTER_NEW for r in reqs)
          and st["migrations"] == 8 and st["migration_fallbacks"] == 0
          and len(spy) == 8,
          f"{name}: {dict(st)}, {[r.state for r in reqs]}, {len(spy)} "
          f"landings, fallbacks {falls}")
    lps = np.array([lp for r in reqs for lp in r.out_logprobs])
    check(np.isfinite(lps).all(), f"{name}: non-finite logprobs")
    check(all(m["equal"] for m in spy),
          f"{name}: a landed chain differs from its source: "
          f"{[m['rid'] for m in spy if not m['equal']]}")
    check(all(m["allocations"] == 0 for m in spy),
          f"{name}: device allocations inside migrations: "
          f"{[m['allocations'] for m in spy]}")
    want = ["K3-int8" if kv_quant == "int8" else "K3"] + (
        ["K4"] if eng.quantized else [])
    check(all(launches[k] > 0 for k in want),
          f"{name}: {want} not all launched: {launches}")
    block_bytes = sum(t[:, 0].nbytes for t in fleet[0].cache._pools())
    blocks = sum(m["blocks"] for m in spy)
    gather_s = sum(m["gather_s"] for m in spy)
    land_s = sum(m["land_s"] for m in spy)
    first = spy[0]
    migration = dict(
        migrations=len(spy), blocks=blocks, block_bytes=block_bytes,
        gather_ms_per_block=gather_s * 1e3 / blocks,
        land_ms_per_block=land_s * 1e3 / blocks,
        gather_gb_per_s=blocks * block_bytes / gather_s / 1e9,
        land_gb_per_s=blocks * block_bytes / land_s / 1e9,
        s_per_request=(gather_s + land_s) / len(spy),
        crc_share=2 * first["crc_one_pass_s"]
        / (first["gather_s"] + first["land_s"]),
        allocations=sum(m["allocations"] for m in spy),
        byte_equal=len(spy))
    row = dict(phase=name, model="llama-7b", layers=eng.cfg.n_layers,
               dtype=str(eng.dtype).replace("torch.", ""),
               weights="int8" if eng.quantized else "bf16",
               kv_cache=kv_quant, roles=["prefill", "decode"], requests=8,
               new_tokens=ROUTER_NEW, stats=dict(st),
               staging_budget_mb=float(MIGRATION_BUDGET_MB),
               parked=[{k: v for k, v in f.cache.stats().items()
                        if k.startswith("parked_")} for f in fleet],
               migration=migration, launches=launches,
               drain=drain_row(step_end, t_submit, reqs),
               agreement_with_serve=[agreed(r.out, o.out[:ROUTER_NEW])
                                     for r, o in zip(reqs, serve_reqs)],
               pool_bytes_per_replica=pool_bytes(fleet[0]))
    # a corrupted host block: refused by the landing's CRC32
    inj = faults.FaultInjector([faults.Fault("router.migrate_corrupt",
                                             "cache_exhausted", step=0)])
    with env_flag("DS_KV_HOST_BUDGET_MB", MIGRATION_BUDGET_MB):
        router = router_lib.ReplicaRouter(fleet, roles=["prefill", "decode"],
                                          faults=inj, telemetry=True)
    req = serving.ServeRequest(rid="corrupt", prompt=serve_reqs[0].prompt,
                               max_new_tokens=8)
    router.run([req])
    falls = [r[5] for r in router.telemetry.tracer.records()
             if r[1] == "migrate" and not r[5].get("ok")]
    check(req.state == "done" and len(req.out) == 8
          and router.stats["migration_fallbacks"] == 1
          and router.stats["migrations"] == 0 and len(falls) == 1
          and "CRC32" in falls[0]["reason"] and len(router._mig_pool) == 0
          and fleet[1].cache.stats()["parked_blocks"] == 0,
          f"{name} corrupt: {req.state}, {dict(router.stats)}, {falls}")
    row["corrupt"] = dict(fired=[list(f) for f in inj.fired],
                          reason=falls[0]["reason"],
                          stats=dict(router.stats),
                          agreement_with_serve=agreed(
                              req.out, serve_reqs[0].out[:8]))
    emit(row)
    del router, fleet
    gc.collect()
    return launches


def autoscale_phase(torch, flash, paged, serving, router_lib, autoscale_lib,
                    load_gen, telemetry, eng):
    """The SLO autoscaler at full width: a seeded open-loop ``chat`` drive
    from the port's ``load_gen`` with a spike (scheduler clock units)
    against a fleet that starts at one replica of 2 slots over the serve
    phase's engine, under an ``SLOController`` (at most 3 replicas) whose
    factory shares the engine; then idle ticks until it retires. At least
    one scale-up and one retire; every request terminal; the controller's
    decision list equal to what ``read_fleet_trace`` rebuilds from the
    exported trace. Returns the drive's launches."""
    tel = telemetry.Telemetry()

    def replica(*_):
        return serving.ServingEngine(eng, num_slots=2, block_size=16,
                                     prefill_chunk=256, telemetry=tel)
    ctrl = autoscale_lib.SLOController(
        ttft_slo=2.0, window=8.0, eval_every=1, cooldown=2.0,
        max_replicas=3, min_samples=2, queue_high=1.5, idle_to_retire=4.0)
    router = router_lib.ReplicaRouter([replica()], replica_factory=replica,
                                      telemetry=tel, autoscale=ctrl)
    entries = load_gen.make_requests(seed=0, mix="chat",
                                     phases=[(6, 0.3), (6, 2.0), (8, 0.3)],
                                     vocab_size=eng.cfg.vocab_size)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    res = load_gen.drive(router, entries, mode="open", slo_ttft=2.0)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches = kernel_launches(flash, paged)
    states = [r["state"] for r in res["per_request"]]
    check(all(s in ("done", "shed") for s in states) and "done" in states
          and launches["K3"] > 0,
          f"autoscale: states {states}, launches {launches}")
    ups = router.stats["scale_ups"]
    t = max(d["at"] for d in ctrl.decisions) + 1.0
    idle = 0
    while router.stats["retires"] == 0 and idle < 32:
        router.step(t)
        t, idle = t + 1.0, idle + 1
    check(ups >= 1 and router.stats["retires"] >= 1,
          f"autoscale: {ups} scale-ups, {router.stats['retires']} retires "
          f"after {idle} idle ticks")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    path = tel.export_trace(os.path.join(REPO, "build",
                                         "chip_smoke_trace_autoscale.json"))
    summary = telemetry.read_fleet_trace(path)
    traced = summary["autoscale"]["decisions"]
    check(len(traced) == len(ctrl.decisions)
          and all({k: t[k] for k in want} == want
                  for t, want in zip(traced, ctrl.decisions)),
          f"autoscale: the trace's {len(traced)} decisions differ from the "
          f"controller's {len(ctrl.decisions)}")
    emit(dict(phase="autoscale", model="llama-7b", dtype="bfloat16",
              mix="chat", seed=0, phases=[[6, 0.3], [6, 2.0], [8, 0.3]],
              requests=len(entries), slots_per_replica=2, max_replicas=3,
              ttft_slo=2.0, drive_s=drive_s, steps=res["steps"],
              states={s: states.count(s) for s in set(states)},
              ttft_p50=res["ttft_p50"], ttft_p99=res["ttft_p99"],
              tpot_p50=res["tpot_p50"], tpot_p99=res["tpot_p99"],
              slo_attainment=res["slo_attainment"],
              by_action=summary["autoscale"]["by_action"],
              decisions_rebuilt=len(traced), idle_ticks=idle,
              stats=dict(router.stats), health=router.health(),
              launches=launches))
    del router
    gc.collect()
    return launches


def router_parity_phase(torch, flash, paged, InferenceEngine, serving,
                        router_lib, faults, cfg, params):
    """The exactness tier of the router on the card: llama-7b width at 2
    layers in float32 (the parity weights), 6 requests of 20-51 tokens,
    8 new, replicas of 2 slots, block 16, 24 blocks, chunk 32. The
    reference is one serving engine's fault-free drain (its agreement
    with a solo ``generate`` reported). Three replicas under the JAX
    router tests' faults (a crash mid-decode, a device-error burst,
    dispatch-site and drain-site faults), and a prefill and a decode
    replica fault-free and with each migrate site faulted, float and
    int8 pools: every stream equals the reference of its pool mode
    exactly, and the fleet's counters move as in JAX."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 37, 51, 28, 44, 33)]
    new = 8
    kw = dict(num_slots=2, block_size=16, num_blocks=24, prefill_chunk=32)

    def reqs():
        return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]

    def streams(out):
        return {k: [int(t) for t in v] for k, v in out.items()}
    refs = {kq: streams(serving.ServingEngine(gpu, kv_quant=kq, **kw)
                        .run(reqs())) for kq in ("off", "int8")}
    gen = [gpu.generate(p[None], max_new_tokens=new)[0].tolist()
           for p in prompts]
    row = dict(generate_agreement=[agreed(refs["off"][i], gen[i])
                                   for i in range(len(prompts))])
    reset_launches(flash, paged)
    chaos = {
        "crash_mid_decode": [("router.step", "crash", 7)],
        "device_error_burst": [("router.step", "device_error", 6, 7)],
        "dispatch_site": [("router.dispatch", "device_error", 1),
                          ("router.dispatch", "crash", 4)],
        "drain_site": [("router.step", "crash", 7),
                       ("router.drain", "device_error", 0)]}
    for name, spec in chaos.items():
        inj = faults.FaultInjector([faults.Fault(*f) for f in spec])
        router = router_lib.ReplicaRouter(
            [serving.ServingEngine(gpu, faults=inj, **kw) for _ in range(3)],
            faults=inj)
        out = streams(router.run(reqs()))
        st = router.stats
        ok = {"crash_mid_decode": st["breaker_trips"] == 1
              and st["drained_requests"] >= 1,
              "device_error_burst": st["breaker_trips"] >= 1
              and st["drained_requests"] >= 1,
              "dispatch_site": st["redispatches"] >= 1
              and router.health().count("broken") == 1,
              "drain_site": st["drained_requests"] >= 1}[name]
        check(inj.fired and ok and out == refs["off"],
              f"router_parity {name}: {dict(st)}, streams equal "
              f"{out == refs['off']}")
        row[name] = dict(fired=[list(f) for f in inj.fired],
                         stats=dict(st), health=router.health())
    sites = [(None, None), ("router.migrate_gather", "device_error"),
             ("router.migrate_scatter", "device_error"),
             ("router.migrate_corrupt", "cache_exhausted"),
             ("router.migrate_gather", "crash"),
             ("router.migrate_scatter", "crash")]
    for kq in ("off", "int8"):
        for site, kind in sites:
            inj = faults.FaultInjector([faults.Fault(site, kind)]
                                       if site else [])
            roles = ["prefill", "decode", "decode"] if kind == "crash" \
                else ["prefill", "decode"]
            router = router_lib.ReplicaRouter(
                [serving.ServingEngine(gpu, kv_quant=kq, **kw)
                 for _ in roles], roles=roles, faults=inj)
            spy = migration_spy(torch, router)
            out = streams(router.run(reqs()))
            st = router.stats
            clean = all(
                rep.srv.cache.stats()["parked_blocks"] == 0
                and not rep.srv.cache._in_transfer
                for rep in router.replicas) and len(router._mig_pool) == 0
            ok = (st["migrations"] == 6 and st["migration_fallbacks"] == 0
                  if site is None else st["migration_fallbacks"] >= 1
                  and inj.fired)
            check(ok and clean and out == refs[kq]
                  and all(m["equal"] for m in spy),
                  f"router_parity disagg {kq} {site}:{kind}: {dict(st)}, "
                  f"pools clean {clean}, streams equal {out == refs[kq]}")
            row[f"disagg_{kq}_{site or 'clean'}_{kind or ''}".rstrip("_")] = \
                dict(stats={k: st[k] for k in ("migrations",
                                               "migration_fallbacks",
                                               "breaker_trips")},
                     landed_byte_equal=len(spy))
    launches = kernel_launches(flash, paged)
    check(launches["K3"] > 0 and launches["K3-int8"] > 0,
          f"router_parity: {launches}")
    emit(dict(phase="router_parity", model="llama-7b width, 2 layers",
              dtype="float32", requests=len(prompts), new_tokens=new,
              launches=launches, **row))
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# phase 4: the card against the host, float32
# ---------------------------------------------------------------------------

def parity_params(torch, gpt):
    """llama-7b width at 2 layers, float32 weights from seed 1 on the host:
    the model of ``parity``, ``parity_int8`` and ``spec_parity``, made
    once for the three (cut for the run's time)."""
    cfg = gpt.preset("llama-7b", n_layers=2)
    return cfg, gpt.init_params(cfg, seed=1, device="cpu",
                                dtype=torch.float32)


def parity_phase(torch, gpt, InferenceEngine, cfg, params):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cpu")
    gpu = InferenceEngine((cfg, params), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(1)
    bs, C = 16, 32
    NB = gpt.decode_geometry(cfg, bs)[0]
    shape = (cfg.n_layers, 2 * NB + 1, bs, cfg.kv_heads, cfg.head_dim)
    pools = {e: (torch.zeros(shape, device=e.device),
                 torch.zeros(shape, device=e.device)) for e in (cpu, gpu)}
    tables = np.arange(1, 2 * NB + 1, dtype=np.int32).reshape(2, NB)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (45, 70)]
    worst = 0.0

    def compare(a, b):
        nonlocal worst
        a, b = a.float().cpu(), b.float().cpu()
        check(bool(torch.isfinite(a).all()), "non-finite card logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= 1e-3, f"card vs host logits: relative max-abs {rel}")

    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            out = {e: e.prefill_into_slot(*pools[e], tables[slot], chunk,
                                          start, n)[0] for e in (cpu, gpu)}
            compare(out[gpu], out[cpu])
    lengths = np.array([len(p) for p in prompts], np.int32)
    forced = rng.integers(1, cfg.vocab_size, (8, 2)).astype(np.int32)
    for step in range(8):
        out = {e: e.decode_slots(*pools[e], tables, lengths, forced[step],
                                 np.array([True, True]))[0]
               for e in (cpu, gpu)}
        compare(out[gpu], out[cpu])
        lengths = lengths + 1
    static = rng.integers(1, cfg.vocab_size, (2, 96)).astype(np.int64)
    out = {e: e._prefill_fn(torch.as_tensor(static, device=e.device))[0]
           for e in (cpu, gpu)}
    compare(out[gpu], out[cpu])
    row = dict(phase="parity", model="llama-7b width, 2 layers",
               dtype="float32", prefill_chunks=sum(-(-len(p) // C)
                                                   for p in prompts),
               decode_steps=8, static_prefill=list(static.shape),
               worst_relative_max_abs=worst, tol=1e-3)
    emit(row)


def parity_int8_phase(torch, gpt, InferenceEngine, cfg, params):
    """int8 weights and int8 KV blocks, float32 activations: the host
    quantizes llama-7b width at 2 layers, and the same int8 tree runs on
    the card (K4, K3-int8) and on the host (plain versions) through a
    teacher-forced prefill and 2 decode steps (cut from 8 for the run's
    time).

    A float32 difference of ~1e-6 between the two sums can move a K/V
    value that sits on a rounding edge to the next code when its block is
    requantized. The logits are held to 1/127 relative: one code step is
    1/127 of its block's largest value, the most a single flipped code
    moves the K or V row it sits in (the float32 kernels alone agree to
    ~6e-6, ``parity``). The pools may differ in at most 1% of their entries
    (block 0, the trash block, is left out): by one step in layer 0, whose
    K/V come from the same embeddings through one projection; by two in
    the layers above, whose inputs already carry the flipped codes below
    them: a value off by the 1/127 relative of the logits' tolerance is off
    by up to 127 / 127 = 1 step before its own rounding edge adds one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = InferenceEngine((cfg, params), dtype=torch.int8, device="cpu")
    gpu = InferenceEngine((cfg, cpu.params), dtype=torch.float32,
                          device="cuda")
    rng = np.random.default_rng(1)
    bs, C = 16, 32
    NB = gpt.decode_geometry(cfg, bs)[0]
    N = 2 * NB + 1
    shape = (cfg.n_layers, N, bs, cfg.kv_heads, cfg.head_dim)
    sshape = (cfg.n_layers, N, cfg.kv_heads)
    pools = {e: [torch.zeros(shape, dtype=torch.int8, device=e.device),
                 torch.zeros(shape, dtype=torch.int8, device=e.device),
                 torch.zeros(sshape, device=e.device),
                 torch.zeros(sshape, device=e.device)] for e in (cpu, gpu)}
    tables = np.arange(1, N, dtype=np.int32).reshape(2, NB)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (45, 70)]
    tol = 1.0 / 127
    worst = 0.0

    def compare(a, b):
        nonlocal worst
        a, b = a.float().cpu(), b.float().cpu()
        check(bool(torch.isfinite(a).all()), "non-finite card logits (int8)")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        worst = max(worst, rel)
        check(rel <= tol, f"int8 card vs host logits: relative max-abs {rel}")

    def run(e, fn, *args):
        p = pools[e]
        out = fn(p[0], p[1], *args, k_scale=p[2], v_scale=p[3])
        pools[e] = list(out[1:])
        return out[0]

    for slot, p in enumerate(prompts):
        for start in range(0, len(p), C):
            n = min(C, len(p) - start)
            chunk = np.zeros(C, np.int32)
            chunk[:n] = p[start:start + n]
            out = {e: run(e, e.prefill_into_slot, tables[slot], chunk, start,
                          n) for e in (cpu, gpu)}
            compare(out[gpu], out[cpu])
    lengths = np.array([len(p) for p in prompts], np.int32)
    forced = rng.integers(1, cfg.vocab_size, (8, 2)).astype(np.int32)
    for step in range(2):
        out = {e: run(e, e.decode_slots, tables, lengths, forced[step],
                      np.array([True, True])) for e in (cpu, gpu)}
        compare(out[gpu], out[cpu])
        lengths = lengths + 1
    codes = {}
    for i, name in enumerate(("k", "v")):
        d = (pools[gpu][i].cpu()[:, 1:].int() - pools[cpu][i][:, 1:].int()).abs()
        sc, sh = pools[gpu][i + 2].cpu()[:, 1:], pools[cpu][i + 2][:, 1:]
        codes[name] = [dict(max_step=int(d[l].max()),
                            differing=int((d[l] > 0).sum()),
                            entries=d[l].numel(),
                            scale_relative_max_abs=(
                                (sc[l] - sh[l]).abs().max()
                                / sh[l].abs().max()).item())
                       for l in range(cfg.n_layers)]
    emit(dict(phase="parity_int8", model="llama-7b width, 2 layers",
              weights="int8", kv_cache="int8", activations="float32",
              prefill_chunks=sum(-(-len(p) // C) for p in prompts),
              decode_steps=2, worst_relative_max_abs=worst, tol=tol,
              pools_per_layer=codes))
    for name, layers in codes.items():
        for l, c in enumerate(layers):
            check(c["max_step"] <= (1 if l == 0 else 2)
                  and c["differing"] <= 0.01 * c["entries"]
                  and c["scale_relative_max_abs"] <= tol,
                  f"int8 {name} pool of layer {l}, card vs host: {c}")


# ---------------------------------------------------------------------------
# phase 5: the training path at full width and depth
# ---------------------------------------------------------------------------

def kernel_launches(flash, paged):
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul
    from deepspeed_tpu_torch.ops.sparse_attention import (
        blocksparse_attention_kernel)
    return {"K1-fwd": flash.flash_attention.launches,
            "K2-dq": flash.flash_attention.bwd_dq_launches,
            "K2-dkv": flash.flash_attention.bwd_dkv_launches,
            "K3": paged.paged_attention.launches,
            "K3-int8": paged.paged_attention.int8_launches,
            "K3-verify": paged.paged_attention.verify_launches,
            "K3-int8-verify": paged.paged_attention.int8_verify_launches,
            "K4": int8_matmul.launches,
            "K5": blocksparse_attention_kernel.launches}


def reset_launches(flash, paged):
    from deepspeed_tpu_torch.ops.int8_matmul import int8_matmul
    from deepspeed_tpu_torch.ops.sparse_attention import (
        blocksparse_attention_kernel)
    blocksparse_attention_kernel.launches = 0
    flash.flash_attention.launches = 0
    flash.flash_attention.bwd_dq_launches = 0
    flash.flash_attention.bwd_dkv_launches = 0
    paged.paged_attention.launches = 0
    paged.paged_attention.int8_launches = 0
    paged.paged_attention.verify_launches = 0
    paged.paged_attention.int8_verify_launches = 0
    int8_matmul.launches = 0


def seeded_documents(rng, vocab, n_rows, seq_len, lo=64, hi=1024):
    """Documents of lo..hi seeded tokens, enough to pack n_rows rows."""
    docs, total = [], 0
    while total < 2 * n_rows * seq_len:
        docs.append(rng.integers(1, vocab, int(rng.integers(lo, hi + 1))))
        total += len(docs[-1])
    return docs


def run_steps(torch, eng, batch, steps, warmup):
    """(ms per timed step, loss of every step incl. warm-up)."""
    ms, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"train step {i}: loss {losses[-1]}, grad norm "
              f"{float(m['grad_norm'])}")
    return ms, losses


def train_phase(torch, flash, paged, gpt, initialize, pack_documents):
    """gpt2-1.5b through initialize -> train_batch, twice: the
    memory-efficient bf16 configuration under full checkpointing, then
    fp32 masters under the selective policy on packed documents. Returns
    the launch counts of the first run (the main path)."""
    S, L = 1024, 48
    adamw = {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}}
    runs = (
        dict(name="bf16 memory-efficient, full remat, chunked loss",
             policy="full", batch=16, steps=5, warmup=1, packed=False,
             config={"bf16": {"enabled": True, "memory_efficient": True}}),
        # a log warm-up over 10 steps, as such a run is really started:
        # Adam's first full-rate steps from random weights overshoot
        dict(name="bf16 compute, fp32 masters, selective remat, packed, "
                  "WarmupLR", policy="selective", batch=8, steps=5, warmup=0,
             packed=True,
             config={"bf16": {"enabled": True},
                     "scheduler": {"type": "WarmupLR", "params": {
                         "warmup_max_lr": 1e-4, "warmup_num_steps": 10}}}),
    )
    main_launches = None
    for run in runs:
        cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                         remat_policy=run["policy"], loss_chunk=2048)
        check(cfg.n_layers == L and cfg.d_model == 1600,
              "gpt2-1.5b preset changed")
        rng = np.random.default_rng(0)
        if run["packed"]:
            packed = pack_documents(
                seeded_documents(rng, cfg.vocab_size, run["batch"], S + 1),
                S + 1)
            batch = {k: v[:run["batch"]] for k, v in packed.items()}
            tokens = int(batch["loss_mask"].sum())
        else:
            batch = {"tokens": rng.integers(
                1, cfg.vocab_size, (run["batch"], S + 1)).astype(np.int32)}
            tokens = run["batch"] * S
        t0 = time.perf_counter()
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": run["batch"], "optimizer": adamw,
                    "steps_per_print": 1000, **run["config"]})
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = eng._to_device(batch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        ms, losses = run_steps(torch, eng, batch, run["steps"], run["warmup"])
        counts = kernel_launches(flash, paged)
        n = run["steps"] + run["warmup"]
        k1_want = (2 if run["policy"] == "full" else 1) * L * n
        check(counts["K1-fwd"] == k1_want and counts["K2-dq"] == L * n
              and counts["K2-dkv"] == L * n and counts["K3"] == 0,
              f"train ({run['name']}): launches {counts}, expected K1-fwd "
              f"{k1_want}, K2-dq and K2-dkv {L * n}, K3 0")
        check(losses[-1] < losses[0],
              f"train ({run['name']}): the loss did not fall on the "
              f"repeated batch: {losses}")
        step_ms = float(np.median(ms))
        flops = gpt.train_flops_per_token(cfg, S) * run["batch"] * S
        emit(dict(phase="train", model="gpt2-1.5b", layers=L,
                  params=eng.num_parameters, run=run["name"],
                  batch=run["batch"], seq_len=S, loss_tokens=tokens,
                  init_s=init_s, step_ms=ms, step_ms_median=step_ms,
                  tokens_per_s=run["batch"] * S / step_ms * 1e3,
                  mfu_vs_989_tflops=flops / (step_ms / 1e3) / 989e12,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=losses, launches=counts,
                  launches_per_step={k: v / n for k, v in counts.items()}))
        if main_launches is None:
            main_launches = counts
            train_trace(torch, flash, eng, batch, "one training step, "
                        "gpt2-1.5b, "
                        "bf16 memory-efficient, full remat, batch 16 x 1024")
        del eng, batch
        torch.cuda.empty_cache()
    return main_launches


def train_trace(torch, flash, eng, batch, what, phase="train_trace"):
    """One training step under the engine's ``start_trace`` (the port's
    trace capture), read back from the Chrome trace it wrote: the
    device's busy share and its top operations, the share of the flash
    kernels, and one ``ds.train_batch`` range; the flash kernels in the
    trace must be the launches the counters saw."""
    fa = flash.flash_attention

    def counts():
        return fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches
    n0 = counts()
    eng.start_trace(TRACE_DIR, steps=1)
    eng.train_batch(batch)
    n = [b - a for a, b in zip(n0, counts())]
    events = read_trace(eng.last_trace)
    t = trace_summary(events)
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "ds.train_batch"]
    check(len(steps) == 1, f"{len(steps)} ds.train_batch ranges in a "
                           f"one-step trace")
    in_trace = [sum(e.get("cat") == "kernel" and k in e["name"]
                    for e in events)
                for k in ("flash_fwd_", "flash_bwd_dq_", "flash_bwd_dkv_")]
    # a step of ~14,000 kernels may lose a record or two of CUPTI's (the
    # 48-layer step's trace held 95 of its 96 K1-fwd launches once); a
    # decode step's window is held exactly (profiled_steps)
    check(all(0 < t <= c for t, c in zip(in_trace, n))
          and sum(in_trace) >= 0.99 * sum(n),
          f"flash kernels in the trace {in_trace}, counted {n}")
    busy = t["device_busy_ms"]

    def share(word):
        return sum(e.get("dur", 0) for e in events
                   if e.get("cat") in DEVICE_CATS and word in e["name"]) \
            / 1e3 / busy
    emit(dict(phase=phase, what=what, trace=eng.last_trace,
              wall_ms=t["wall_ms"], step_range_ms=steps[0]["dur"] / 1e3,
              device_busy_ms=busy, device_idle_share=t["device_idle_share"],
              device_events=t["device_events_per_step"],
              flash_kernels_in_trace=in_trace, flash_launches_counted=n,
              share_flash_fwd=share("flash_fwd_"),     # both designs
              share_flash_bwd_dq=share("flash_bwd_dq_"),
              share_flash_bwd_dkv=share("flash_bwd_dkv_"),
              top_device=[dict(r, share=r["ms_per_step"] / busy)
                          for r in t["top_device"]]))


def remat_phase(torch, gpt, initialize, tree):
    """What each checkpointing policy costs in memory at full depth, and
    that none changes the result. Two readings per policy: what the
    forward leaves allocated for the backward (the policy's contract), and
    the peak of a whole ``train_batch`` step. Batch 12, not the training
    run's 16: without checkpointing 16 rows do not fit the card."""
    S, B = 1024, 12
    settings = (("none", dict(remat=False)),
                ("selective", dict(remat=True, remat_policy="selective")),
                ("flash_only", dict(remat=True, remat_policy="flash_only")),
                ("full", dict(remat=True, remat_policy="full")))
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 50304, (B, S + 1)).astype(np.int32)
    kept, peaks, ms = {}, {}, {}
    for name, fields in settings:
        cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, loss_chunk=2048,
                         **fields)
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": B, "steps_per_print": 1000,
                    "bf16": {"enabled": True, "memory_efficient": True},
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
        del params
        batch = eng._to_device({"tokens": tokens})
        leaves = tree.tree_map(lambda t: t.detach().requires_grad_(),
                               eng.params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = gpt.loss_fn(leaves, batch, None, cfg, deterministic=True)
        torch.cuda.synchronize()
        kept[name] = (torch.cuda.memory_allocated() - before) / 2**30
        del loss, leaves
        eng.train_batch(batch)                  # warm-up, allocator settled
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        check(np.isfinite(float(m["loss"])), f"remat {name}: loss not finite")
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        del eng, batch
        torch.cuda.empty_cache()
    for what, got in (("kept between forward and backward", kept),
                      ("peak memory of a step", peaks)):
        order = [got[n] for n, _ in settings]
        check(all(a > b for a, b in zip(order, order[1:])),
              f"{what} should fall from no checkpointing through selective "
              f"and flash_only to full: {got}")

    # the same loss and gradient under every policy: 2 layers, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {}
    for name, fields in settings:
        cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=256,
                         dtype=torch.float32, **fields)
        params = gpt.init_params(cfg, seed=2, dtype=torch.float32)
        eng, _, _, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            config={"train_batch_size": 2, "steps_per_print": 1000,
                    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
        m = eng.train_batch({"tokens": tokens[:2, :257]})
        small[name] = (float(m["loss"]), float(m["grad_norm"]))
        del eng, params
    base = small["none"]
    for name, (loss, gnorm) in small.items():
        check(abs(loss - base[0]) <= 1e-6 * abs(base[0])
              and abs(gnorm - base[1]) <= 1e-5 * abs(base[1]),
              f"remat {name}: loss, grad norm {loss, gnorm} against "
              f"{base} without checkpointing")
    torch.cuda.empty_cache()
    emit(dict(phase="remat", model="gpt2-1.5b", layers=48, batch=B,
              seq_len=S, config="bf16 memory-efficient, chunked loss",
              kept_after_forward_gib=kept, peak_mem_gib=peaks, step_ms=ms,
              fp32_2_layers_loss_and_grad_norm=small))


def train_parity_phase(torch, gpt, initialize, pack_documents, tree):
    """The card (kernels) against the host (plain versions), float32,
    gpt2-1.5b width at 2 layers, sequences of 128 (cut from 256 for the
    run's time: the host's float32 steps take most of it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    S, B = 128, 2
    rng = np.random.default_rng(3)
    plain = {"tokens": rng.integers(1, 50304, (B, S + 1)).astype(np.int32)}
    packed = pack_documents(seeded_documents(rng, 50304, B, S + 1, 16, 120),
                            S + 1)
    packed = {k: v[:B] for k, v in packed.items()}
    worst = {}
    for name, batch, chunk in (("plain", plain, 0), ("packed", packed, 200)):
        cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=S + 1,
                         dtype=torch.float32, loss_chunk=chunk)
        host = gpt.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
        grads = {}
        for dev in ("cpu", "cuda"):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in tree.tree_leaves(host)]
            params = tree.tree_unflatten(host, leaves)
            loss = gpt.loss_fn(params, {k: torch.as_tensor(v).to(dev)
                                        for k, v in batch.items()}, None, cfg)
            grads[dev] = (loss.item(), [g.cpu() for g in
                                        torch.autograd.grad(loss, leaves)])
        (lh, gh), (lc, gc) = grads["cpu"], grads["cuda"]
        rel = max([abs(lc - lh) / abs(lh)]
                  + [((c - h).abs().max() / h.abs().max()).item()
                     for c, h in zip(gc, gh)])
        check(np.isfinite(lc) and rel <= 1e-3,
              f"train parity ({name}): card vs host loss {lc} vs {lh}, "
              f"worst relative gradient error {rel}")
        worst[name] = rel

    # two train_batch steps on both devices, for each optimizer. Adam's and
    # Adagrad's eps are raised to 1e-3: with the default 1e-8 an entry
    # whose gradient is rounding noise (the key bias, whose gradient is
    # zero in exact arithmetic) is normalised to a full +-lr step, and the
    # two devices' noise differs
    cfg = gpt.preset("gpt2-1.5b", n_layers=2, max_seq_len=S + 1,
                     dtype=torch.float32)
    host = gpt.init_params(cfg, seed=4, device="cpu", dtype=torch.float32)
    optimizers = {
        "adamw": {"type": "AdamW", "params": {
            "lr": 1e-3, "weight_decay": 0.1, "eps": 1e-3}},
        "sgd-nesterov": {"type": "sgd", "params": {
            "lr": 1e-2, "momentum": 0.9, "nesterov": True}},
        "adagrad": {"type": "adagrad", "params": {
            "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-3}}}
    steps = {}
    for name, opt in optimizers.items():
        engines = [initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=host, device=dev,
            config={"train_batch_size": B, "gradient_clipping": 1.0,
                    "steps_per_print": 1000, "optimizer": opt})[0]
            for dev in ("cpu", "cuda")]
        for _ in range(2):
            losses = [float(e.train_batch(packed)["loss"]) for e in engines]
        prel = max(((c.cpu() - h).abs().max() / h.abs().max()).item()
                   for h, c in zip(*(tree.tree_leaves(e.params)
                                     for e in engines)))
        check(prel <= 1e-4 and abs(losses[0] - losses[1])
              <= 1e-4 * losses[0],
              f"train parity ({name}): parameters after two steps differ "
              f"by {prel} relative, losses {losses}")
        steps[name] = dict(worst_relative_parameter=prel,
                           loss_host_card=losses)
        del engines
    emit(dict(phase="train_parity", model="gpt2-1.5b width, 2 layers",
              dtype="float32", batch=B, seq_len=S,
              worst_relative_loss_or_gradient=worst, tol=1e-3,
              two_steps=steps, param_tol=1e-4,
              seconds=time.perf_counter() - t_phase))


# ---------------------------------------------------------------------------
# slice 5: checkpoints and resume, the loaders and the engine's features
# ---------------------------------------------------------------------------

def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def serve_streams(serving, eng, prompts, new):
    """Greedy streams of ``prompts`` drained through a ServingEngine."""
    srv = serving.ServingEngine(eng, num_slots=len(prompts), block_size=16,
                                prefill_chunk=256)
    reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    while srv.busy:
        srv.step()
    return np.array([r.out for r in reqs])


def resume_phase(torch, flash, paged, gpt, initialize, init_inference,
                 serving, tree, ckpt):
    """gpt2-1.5b at full width, cut to 4 of its 48 layers for the run's
    time, in the ``train`` phase's first configuration: four uninterrupted
    steps against two steps, a save, a fresh engine from other weights, the
    load and two more steps, which must agree bit for bit (the bf16 stochastic
    rounding makes this a test of the saved generator state). The resumed
    engine saves again (``latest`` moves to it); then the 16-bit model file,
    and serving from the checkpoint: ``generate`` (K1-fwd) and a serving drain
    (K3) from ``init_inference(config=, checkpoint=)`` must give the streams of
    the resumed engine's weights handed over directly."""
    import tempfile
    t_phase = time.perf_counter()
    S, B = 1024, 16
    cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                     remat_policy="full", loss_chunk=2048, n_layers=4)
    L = cfg.n_layers
    config = {"train_batch_size": B, "steps_per_print": 1000,
              "bf16": {"enabled": True, "memory_efficient": True},
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 1e-4, "weight_decay": 0.1}}}
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(1, cfg.vocab_size, (B, S + 1))
                .astype(np.int32)} for _ in range(4)]

    def engine(seed):
        params = gpt.init_params(cfg, seed=seed, dtype=torch.bfloat16)
        return initialize(model=gpt.make_loss_fn(cfg),
                          model_parameters=params, config=config)[0]

    def steps(eng, todo):
        out = []
        for b in todo:
            out.append(float(eng.train_batch(b)["loss"]))
            check(np.isfinite(out[-1]), f"resume: loss {out[-1]}")
        return out

    whole = engine(0)
    want = steps(whole, batches)
    work = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        first = engine(0)
        got = steps(first, batches[:2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save_checkpoint(work, tag="step2")
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(os.path.join(work, "step2"))
        t0 = time.perf_counter()
        check(ckpt.validate_tag(work, "step2"), "resume: tag not valid")
        crc_s = time.perf_counter() - t0
        del first
        torch.cuda.empty_cache()
        resumed = engine(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, _ = resumed.load_checkpoint(work, strict=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(path is not None and resumed.global_steps == 2,
              f"resume: load gave {path}, step {resumed.global_steps}")
        got += steps(resumed, batches[2:])
        check(got == want, f"resume: losses {got}, uninterrupted {want}")
        differ = [name for name, a, b in (
            [("params", a, b) for a, b in zip(
                tree.tree_leaves(resumed.params),
                tree.tree_leaves(whole.params))]
            + [(f"opt {k}", a, b) for k in ("mu", "nu") for a, b in zip(
                tree.tree_leaves(resumed.opt_state[k]),
                tree.tree_leaves(whole.opt_state[k]))])
            if not torch.equal(a, b)]
        check(not differ and resumed.opt_state["count"]
              == whole.opt_state["count"] == 4,
              f"resume: {len(differ)} leaves differ from the uninterrupted "
              f"run ({differ[:4]})")
        check(torch.equal(resumed.rng.get_state(), whole.rng.get_state()),
              "resume: generator states differ")
        del whole
        torch.cuda.empty_cache()
        # the resumed engine's own checkpoint, which `latest` now names:
        # the weights served below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.save_checkpoint(work, tag="step4")
        save2_s = time.perf_counter() - t0
        check(ckpt.get_latest_tag(work) == "step4", "resume: latest moved "
              "to " + str(ckpt.get_latest_tag(work)))

        t0 = time.perf_counter()
        resumed.save_16bit_model(work, "model_16bit.npz")
        save16_s = time.perf_counter() - t0
        npz = os.path.join(work, "model_16bit.npz")
        back = ckpt.load_16bit_model(npz)
        check(all(torch.equal(a, b.cpu()) for a, b in zip(
            tree.tree_leaves(back), tree.tree_leaves(resumed.params))),
            "resume: the 16-bit model file does not hold the parameters")
        del back

        icfg = gpt.preset("gpt2-1.5b", max_seq_len=S, n_layers=L)
        prompts = rng.integers(1, cfg.vocab_size, (4, 256)).astype(np.int32)
        t0 = time.perf_counter()
        from_ckpt = init_inference(config=icfg, checkpoint=work,
                                   dtype=torch.bfloat16)
        torch.cuda.synchronize()
        serve_init_s = time.perf_counter() - t0
        direct = init_inference(model=(icfg, resumed.params),
                                dtype=torch.bfloat16)
        reset_launches(flash, paged)
        streams = from_ckpt.generate(prompts, max_new_tokens=32)
        drained = serve_streams(serving, from_ckpt, list(prompts), 32)
        counts = kernel_launches(flash, paged)
        check(counts["K1-fwd"] > 0 and counts["K3"] > 0,
              f"resume: serving from the checkpoint launched {counts}")
        check(np.array_equal(streams, direct.generate(prompts, 32)),
              "resume: generate from the checkpoint differs from generate "
              "on the engine's parameters")
        check(np.array_equal(drained, serve_streams(
            serving, direct, list(prompts), 32)),
            "resume: the serving drain from the checkpoint differs")
        emit(dict(phase="resume", model="gpt2-1.5b", layers=L, batch=B,
                  seq_len=S, config="bf16 memory-efficient, AdamW, full "
                  "remat, chunked loss", losses=got, bit_identical=True,
                  checkpoint_bytes=nbytes, save_s=save_s,
                  save_gb_per_s=nbytes / save_s / 1e9,
                  crc32_pass_s=crc_s, crc32_gb_per_s=nbytes / crc_s / 1e9,
                  load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
                  resumed_save_s=save2_s,
                  resumed_save_gb_per_s=nbytes / save2_s / 1e9,
                  model_16bit_bytes=os.path.getsize(npz),
                  save_16bit_s=save16_s, serve_init_from_checkpoint_s=
                  serve_init_s, generate_identical=True,
                  drain_identical=True, serving_launches=counts,
                  seconds=time.perf_counter() - t_phase))
        del from_ckpt, direct, resumed
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def train_features_phase(torch, flash, paged, gpt, initialize, dataloader,
                         pld_lib):
    """gpt2-1.5b at full width and depth fed by ``initialize(
    training_data=)`` through RepeatingLoader and PrefetchLoader, six
    steps with a fixed_linear seqlen curriculum (lengths off the 64 grid),
    progressive layer drop at theta 0.5, the monitor, the timers and the
    flops profiler at step 3. Under full remat each step launches K1-fwd
    twice and K2-dq and K2-dkv once per kept layer, K3 never."""
    import tempfile
    t_phase = time.perf_counter()
    S, B, n_steps = 1024, 16, 6
    cfg = gpt.preset("gpt2-1.5b", max_seq_len=S, remat=True,
                     remat_policy="full", loss_chunk=2048)
    L = cfg.n_layers
    pld = {"enabled": True, "theta": 0.5, "gamma": 1.0}
    rng = np.random.default_rng(6)
    rows = rng.integers(1, cfg.vocab_size, (B * n_steps, S + 1)).astype(
        np.int32)
    data = [{"tokens": r[:S], "targets": r[1:]} for r in rows]
    work = tempfile.mkdtemp(prefix="chip_smoke_features_")
    try:
        profile = os.path.join(work, "flops_profile.txt")
        # the monitor's buffer and the throughput meter flush every third
        # step: one write carries three steps
        config = {
            "train_batch_size": B, "steps_per_print": 3,
            "bf16": {"enabled": True, "memory_efficient": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "wall_clock_breakdown": True,
            "tensorboard": {"enabled": True, "output_path": work,
                            "job_name": "train_features"},
            "flops_profiler": {"enabled": True, "profile_step": 3,
                               "output_file": profile},
            "progressive_layer_drop": pld,
            "curriculum_learning": {
                "enabled": True, "curriculum_type": "seqlen",
                "min_difficulty": 520, "max_difficulty": S,
                "schedule_type": "fixed_linear",
                "schedule_config": {"total_curriculum_step": 10,
                                    "difficulty_step": 8}}}
        params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
        eng, _, loader, _ = initialize(
            model=gpt.make_loss_fn(cfg), model_parameters=params,
            training_data=data, config=config)
        del params
        batches = iter(dataloader.PrefetchLoader(
            dataloader.RepeatingLoader(loader), eng))
        per_step = []
        reset_launches(flash, paged)
        before = kernel_launches(flash, paged)
        for _ in range(n_steps):
            # the step's layer-drop draws, replayed from the generator's
            # state: the model draws them first thing in its forward
            gen = torch.Generator(device=eng.device)
            gen.set_state(eng.rng.get_state())
            theta = pld_lib.theta_schedule(eng.step_count, pld["theta"],
                                           pld["gamma"])
            kept = sum(gpt.pld_keep(theta, L, gen))
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = eng.train_batch(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = kernel_launches(flash, paged)
            step = {k: after[k] - before[k] for k in after}
            before = after
            seq = eng.curriculum_scheduler.get_current_difficulty()
            loss = float(m["loss"])
            per_step.append(dict(seq_len=seq, ms=ms, kept_layers=kept,
                                 theta=theta, loss=loss, launches=step))
            check(np.isfinite(loss), f"train_features: loss {loss}")
            check(step["K1-fwd"] == 2 * kept and step["K2-dq"] == kept
                  and step["K2-dkv"] == kept and step["K3"] == 0,
                  f"train_features: step at S={seq} kept {kept} layers "
                  f"and launched {step}")
        counts = kernel_launches(flash, paged)
        seqs = [r["seq_len"] for r in per_step]
        check(sum(x % 64 != 0 for x in seqs) >= 2,
              f"train_features: lengths {seqs} stay on the 64 grid")
        check(min(r["kept_layers"] for r in per_step) < L,
              "train_features: layer drop dropped no layer")
        eng.destroy()
        with open(os.path.join(work, "train_features", "scalars.csv")) as f:
            lines = f.read().splitlines()
        csv_rows = lines[1:]
        check(lines[0].startswith("step,")
              and [int(r.split(",")[0]) for r in csv_rows]
              == [B * (i + 1) for i in range(n_steps)],
              f"train_features: the monitor's CSV is not one header and "
              f"one row per step: {lines}")
        with open(profile) as f:
            report = f.read()
        mfu = [line for line in report.splitlines()
               if line.startswith("MFU:")]
        check(mfu, f"train_features: no MFU line in the profile: {report}")
        # the profile counts the layers that ran at step 3, not all L
        third = per_step[2]
        want = gpt.train_flops_per_token(
            gpt.preset("gpt2-1.5b", n_layers=third["kept_layers"]),
            third["seq_len"]) * B * third["seq_len"]
        counted = float(report.split("step flops:")[1].split("(")[1]
                        .split(")")[0])
        check(f"micro step ran: [{third['kept_layers']}]" in report
              and abs(counted - want) <= 1e-9 * want,
              f"train_features: profile counted {counted} FLOPs, the "
              f"{third['kept_layers']} layers that ran make {want}: "
              f"{report}")
        step_timer = eng.timers("train_batch").elapsed_records
        check(len(step_timer) == n_steps,
              f"train_features: {len(step_timer)} train_batch timings")
        emit(dict(phase="train_features", model="gpt2-1.5b", layers=L,
                  batch=B, steps=per_step, launches=counts,
                  monitor_rows=len(csv_rows),
                  profile=[line for line in report.splitlines()
                           if ":" in line],
                  train_batch_timer_ms=[t * 1e3 for t in step_timer],
                  seconds=time.perf_counter() - t_phase))
        del eng, batches, loader
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def host_sync_phase(torch, gpt, initialize, timer):
    """What a wait for the device in every step costs where the host can
    run ahead: gpt2-small (124 M parameters), bf16, batch 8 of 512 tokens,
    runs of 20 free-running steps (one wait at the end of each run), the
    engine's throughput meter reporting every 1000 steps (no wait inside
    the run) against every step (a wait at each step's end, what a meter
    that times each step costs), in 2 pairs (4 until the router's slice
    cut them for the run's time), alternating which side runs first."""
    t_phase = time.perf_counter()
    S, B, steps = 512, 8, 20
    cfg = gpt.preset("gpt2-small", max_seq_len=S)
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng, _, _, _ = initialize(
        model=gpt.make_loss_fn(cfg), model_parameters=params,
        config={"train_batch_size": B, "steps_per_print": 1000,
                "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}})
    del params
    batch = eng._to_device({"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S + 1)).astype(np.int32)})
    for _ in range(3):                  # warm-up
        eng.train_batch(batch)

    def run(every):
        eng.tput_timer = timer.ThroughputTimer(
            B, steps_per_output=every, logging_fn=lambda msg: None,
            device=eng.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            m = eng.train_batch(batch)
        torch.cuda.synchronize()
        check(np.isfinite(float(m["loss"])), f"host_sync: loss {m['loss']}")
        return (time.perf_counter() - t0) * 1e3 / steps
    ms = {1000: [], 1: []}
    for pair in range(2):
        for every in ((1000, 1) if pair % 2 == 0 else (1, 1000)):
            ms[every].append(run(every))
    cost = [w - f for w, f in zip(ms[1], ms[1000])]
    emit(dict(phase="host_sync", model="gpt2-small", batch=B, seq_len=S,
              steps_per_run=steps, ms_per_step_meter_every_1000=ms[1000],
              ms_per_step_meter_every_step=ms[1],
              median_ms_meter_every_1000=float(np.median(ms[1000])),
              median_ms_meter_every_step=float(np.median(ms[1])),
              quartile_spread_ms_meter_every_1000=float(
                  np.subtract(*np.percentile(ms[1000], [75, 25]))),
              pairs_waiting_slower=sum(c > 0 for c in cost),
              wait_cost_ms_per_step_median=float(np.median(cost)),
              seconds=time.perf_counter() - t_phase))
    del eng, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 4: block-sparse attention and BERT-large pretraining
# ---------------------------------------------------------------------------

def sparse_phase(torch, flash, paged, sa, DeepSpeedConfig):
    """The ``sparse_attention`` path at bert-large's attention width (16
    heads of 64; B = 4, S = 4096, bf16): the config section -> the engine
    config -> ``build_sparsity_config`` -> ``SparseSelfAttention``, then a
    forward and backward through 24 calls (bert-large's depth), for
    bidirectional and unidirectional attention. Each pass is run with the
    launch counters at 0 and read just after: K5 launches once per call.
    Returns the launch counts of the two passes together."""
    B, S, H, D, depth = 4, 4096, 16, 64, 24
    dev = torch.device("cuda")
    total = {}
    for attention in ("bidirectional", "unidirectional"):
        section = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
                   "num_global_blocks": 1, "attention": attention}
        ds = DeepSpeedConfig({"train_batch_size": B,
                              "sparse_attention": section})
        attn = sa.SparseSelfAttention(
            sa.build_sparsity_config(ds.sparse_attention, num_heads=H),
            max_seq_length=S)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn((B, S, H, D), generator=g, device=dev).to(
            torch.bfloat16).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        t0 = time.perf_counter()
        h = x
        for _ in range(depth):         # a residual stack kept at unit scale
            h = 0.5 * (h + attn(h, h, h))
        loss = h.float().square().mean()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        counts_fwd = kernel_launches(flash, paged)
        t0 = time.perf_counter()
        (gx,) = torch.autograd.grad(loss, (x,))
        torch.cuda.synchronize()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_launches(flash, paged)
        check(counts["K5"] == depth and counts_fwd["K5"] == depth
              and counts["K1-fwd"] == 0,
              f"sparse ({attention}): launches {counts}, expected K5 "
              f"{depth} (once per call, none in the gather backward)")
        check(tuple(h.shape) == (B, S, H, D)
              and bool(torch.isfinite(loss)) and
              bool(torch.isfinite(gx).all()) and gx.abs().max().item() > 0,
              f"sparse ({attention}): loss {loss.item()}, gradient finite "
              f"{bool(torch.isfinite(gx).all())}")
        _, lut, valid = attn.layout_for(S)
        emit(dict(phase="sparse", attention=attention, section=section,
                  shape=dict(B=B, S=S, H=H, D=D, calls=depth),
                  lut_slots=int(lut.shape[-1]),
                  mean_active_blocks_per_row=float(valid.sum(-1).mean()),
                  forward_ms=fwd_ms, backward_ms=bwd_ms,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=loss.item(), launches=counts))
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        del attn, x, h, loss, gx
        torch.cuda.empty_cache()
    return total


def mlm_batch(rng, vocab, B, S):
    """Seeded MLM pretraining rows: 15% of the tokens labelled, NSP labels,
    token types (segment B from a seeded split), and a quarter of the rows
    with a padded tail in ``attention_mask`` (their tail unlabelled)."""
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    types = (np.arange(S)[None] >= rng.integers(S // 4, 3 * S // 4,
                                                (B, 1))).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(0, B, 4):
        mask[b, rng.integers(S // 2, S):] = 0
    labels = np.where((rng.random((B, S)) < 0.15) & (mask > 0), tokens, -1)
    return {"tokens": tokens, "mlm_labels": labels.astype(np.int32),
            "token_type_ids": types, "attention_mask": mask,
            "nsp_labels": rng.integers(0, 2, B).astype(np.int32)}


def bert_phase(torch, flash, paged, bert, initialize):
    """BERT-large pretraining at full width and depth (24 layers, d_model
    1024, 16 heads of 64, vocab 30522, random weights from seed 0), the
    JAX package's ``tools/bert_bench.py`` headline: seq 512, batch 32,
    bf16, AdamW lr 1e-4, ZeRO stage 1, full checkpointing, the chunked
    loss; 1 warm-up and 5 steps on one repeated batch. Then LAMB with fp32
    masters, the selective policy and dropout 0.1 (attention takes the
    masked softmax, as the layer routes it), batch 16, and one SQuAD step.
    Returns the launch counts of the first run."""
    S, L = 512, 24
    runs = (
        dict(name="bf16, AdamW, ZeRO stage 1, full remat, chunked loss",
             batch=32, policy="full", dropout=0.0,
             optimizer={"type": "AdamW", "params": {"lr": 1e-4}},
             config={"zero_optimization": {"stage": 1}}),
        dict(name="bf16, LAMB, fp32 masters, selective remat, dropout 0.1",
             batch=16, policy="selective", dropout=0.1,
             optimizer={"type": "LAMB", "params": {"lr": 1e-4,
                                                   "weight_decay": 0.01}},
             config={}),
    )
    main_launches = None
    for run in runs:
        cfg = bert.preset("bert-large", max_seq_len=S, dropout=run["dropout"],
                          dtype=torch.bfloat16, remat=True,
                          remat_policy=run["policy"], loss_chunk=2048)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) ==
              (L, 1024, 16, 30522), "bert-large preset changed")
        B = run["batch"]
        batch = mlm_batch(np.random.default_rng(0), cfg.vocab_size, B, S)
        config = {"train_batch_size": B, "bf16": {"enabled": True},
                  "optimizer": run["optimizer"], "steps_per_print": 1000,
                  **run["config"]}
        t0 = time.perf_counter()
        params = bert.init_params(cfg, seed=0)
        eng, _, _, _ = initialize(model=bert.make_loss_fn(cfg),
                                  model_parameters=params, config=config)
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = eng._to_device(batch)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash, paged)
        ms, losses = run_steps(torch, eng, batch, 5, 1)
        counts = kernel_launches(flash, paged)
        n = 6
        if run["dropout"] == 0.0:
            want = {"K1-fwd": 2 * L * n, "K2-dq": L * n, "K2-dkv": L * n}
        else:
            want = {"K1-fwd": 0, "K2-dq": 0, "K2-dkv": 0}
        check(all(counts[k] == v for k, v in want.items())
              and counts["K3"] == counts["K5"] == 0,
              f"bert ({run['name']}): launches {counts}, expected {want} "
              f"and no K3, K5")
        check(losses[-1] < losses[0],
              f"bert ({run['name']}): the loss did not fall on the "
              f"repeated batch: {losses}")
        step_ms = float(np.median(ms))
        flops = bert.train_flops_per_sample(cfg, S) * B
        emit(dict(phase="bert", model="bert-large", layers=L,
                  params=eng.num_parameters, run=run["name"], batch=B,
                  seq_len=S, padded_rows=int((batch["attention_mask"]
                                              .min(-1).values == 0).sum()),
                  init_s=init_s, step_ms=ms, step_ms_median=step_ms,
                  samples_per_s=B / step_ms * 1e3,
                  mfu_vs_989_tflops=flops / (step_ms / 1e3) / 989e12,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  loss=losses, launches=counts))
        if main_launches is None:
            main_launches = counts
            train_trace(torch, flash, eng, batch, "one training step, "
                        "bert-large, "
                        "bf16, AdamW, full remat, batch 32 x 512, a quarter "
                        "of the rows padded", phase="bert_trace")
        del eng, batch
        torch.cuda.empty_cache()

    # one SQuAD fine-tuning step on the second run's configuration
    params = bert.init_params(cfg, seed=0)
    params["qa"] = bert.init_squad_head(cfg, seed=1)
    eng, _, _, _ = initialize(model=bert.make_squad_loss_fn(cfg),
                              model_parameters=params, config=config)
    del params
    rng = np.random.default_rng(1)
    squad = {k: v for k, v in mlm_batch(rng, cfg.vocab_size, B, S).items()
             if k in ("tokens", "token_type_ids", "attention_mask")}
    squad["start_positions"] = rng.integers(0, S // 2, B).astype(np.int32)
    squad["end_positions"] = squad["start_positions"] + rng.integers(
        0, 30, B).astype(np.int32)
    m = eng.train_batch(squad)
    loss = float(m["loss"])
    check(np.isfinite(loss) and np.isfinite(float(m["grad_norm"])),
          f"bert squad step: loss {loss}")
    emit(dict(phase="bert_squad", model="bert-large", batch=B, seq_len=S,
              optimizer="LAMB", loss=loss, grad_norm=float(m["grad_norm"])))
    del eng
    torch.cuda.empty_cache()
    return main_launches


def bert_parity_phase(torch, bert, tree):
    """The card (the flash kernels, non-causal with the padding mask as
    their key mask) against the host (their plain versions), float32,
    bert-large width at 2 layers: the MLM+NSP loss and every gradient leaf
    of an unpadded and a padded batch, dense and chunked loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S, B = 256, 2
    worst = {}
    for name, chunk, pad in (("unpadded, dense loss", 0, False),
                             ("padded, chunked loss", 200, True)):
        cfg = bert.preset("bert-large", n_layers=2, max_seq_len=S,
                          dropout=0.0, dtype=torch.float32, loss_chunk=chunk)
        batch = mlm_batch(np.random.default_rng(5), cfg.vocab_size, B, S)
        if not pad:
            batch["attention_mask"][:] = 1
        host = bert.init_params(cfg, seed=4, device="cpu")
        grads = {}
        for dev in ("cpu", "cuda"):
            leaves = [t.detach().to(dev).requires_grad_()
                      for t in tree.tree_leaves(host)]
            params = tree.tree_unflatten(host, leaves)
            loss = bert.loss_fn(params, {k: torch.as_tensor(v).to(dev)
                                         for k, v in batch.items()},
                                None, cfg)
            grads[dev] = (loss.item(), [g.cpu() for g in
                                        torch.autograd.grad(loss, leaves)])
        (lh, gh), (lc, gc) = grads["cpu"], grads["cuda"]
        rel = max([abs(lc - lh) / abs(lh)]
                  + [((c - h).abs().max() / h.abs().max()).item()
                     for c, h in zip(gc, gh)])
        check(np.isfinite(lc) and rel <= 1e-3,
              f"bert parity ({name}): card vs host loss {lc} vs {lh}, "
              f"worst relative gradient error {rel}")
        worst[name] = rel
    emit(dict(phase="bert_parity", model="bert-large width, 2 layers",
              dtype="float32", batch=B, seq_len=S,
              worst_relative_loss_or_gradient=worst, tol=1e-3))


# bf16 training check, leaf by leaf: on the loss and on every gradient
# leaf, the card's distance from float32 (relative for the loss, max-abs
# relative to the leaf's largest entry for a gradient) is held to
# BF16_FACTOR times the host's own bf16 distance on that same leaf, plus
# BF16_FLOOR (~5 bf16 roundings of the leaf's largest entry) for leaves
# that bf16 happens to leave almost exact. The host's bf16 distance is
# what rounding costs: it differs by leaf by two orders (bert-large's
# token-type embedding gradient, a sum over every position that mostly
# cancels, reaches ~0.12), so one limit over all leaves would be as loose
# as the worst of them.
BF16_FACTOR = 2.0
BF16_FLOOR = 0.01
# the leaves whose gradients pass through K2 (q/k/v projection) and
# through K1-fwd's output alone (the attention's output projection)
ATTENTION_LEAVES = ("block/qkv/", "block/attn_out/")


def leaf_paths(tree):
    """'/'-joined key paths of a nested dict, in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [""]
    return [f"{k}/{p}".rstrip("/") for k in sorted(tree)
            for p in leaf_paths(tree[k])]


def loss_and_grads(torch, tree, loss_of, host, dev):
    """(loss, every gradient leaf as float32 on the host) of
    ``loss_of(params, dev)`` at ``host``'s parameters moved to ``dev``."""
    leaves = [t.detach().to(dev).requires_grad_()
              for t in tree.tree_leaves(host)]
    loss = loss_of(tree.tree_unflatten(host, leaves), dev)
    return loss.item(), [g.float().cpu() for g in
                         torch.autograd.grad(loss, leaves)]


def distances(got, ref):
    """[the loss's relative error] + each gradient leaf's max-abs error
    relative to that leaf's largest entry."""
    (lg, gg), (lr, gr) = got, ref
    return [abs(lg - lr) / abs(lr)] + [
        ((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gg, gr)]


def bf16_parity_phase(torch, flash, paged, gpt, bert, tree):
    """The tensor-core designs inside the training models: gpt2-1.5b
    and bert-large width at 2 layers, the loss and every gradient leaf in
    bf16 on the card (K1-fwd, K2-dq and K2-dkv on the tensor cores) against
    float32 on the host (plain versions) at the same weights. The host
    also runs the same bf16 model: its distance from float32 on each leaf
    is what bf16 rounding itself costs there (weights, activations, p and
    ds rounded at the same places), and the card's distance on that leaf
    is held to BF16_FACTOR times it (the kernels sum in another order:
    noise of the same size) plus BF16_FLOOR. The present ``train_parity``
    and ``bert_parity`` run in float32, which takes the CUDA-core
    designs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    S, B = 256, 2
    gpt_batch = {"tokens": np.random.default_rng(6).integers(
        1, 50304, (B, S + 1)).astype(np.int32)}
    bert_batch = mlm_batch(np.random.default_rng(7), 30522, B, S)
    out = {}
    for name in ("gpt2-1.5b", "bert-large"):
        def loss_of(dtype, name=name):
            def fn(params, dev):
                if name == "gpt2-1.5b":
                    cfg = gpt.preset(name, n_layers=2, max_seq_len=S + 1,
                                     dtype=dtype)
                    return gpt.loss_fn(params, {
                        k: torch.as_tensor(v).to(dev)
                        for k, v in gpt_batch.items()}, None, cfg)
                cfg = bert.preset(name, n_layers=2, max_seq_len=S,
                                  dropout=0.0, dtype=dtype)
                return bert.loss_fn(params, {
                    k: torch.as_tensor(v).to(dev)
                    for k, v in bert_batch.items()}, None, cfg)
            return fn
        if name == "gpt2-1.5b":
            host = gpt.init_params(gpt.preset(name, n_layers=2,
                                              max_seq_len=S + 1),
                                   seed=4, device="cpu", dtype=torch.float32)
        else:
            host = bert.init_params(bert.preset(name, n_layers=2,
                                                max_seq_len=S),
                                    seed=4, device="cpu")
        # the weights rounded to bf16 once; float32 computes on the same
        # values
        rounded = [t.to(torch.bfloat16) for t in tree.tree_leaves(host)]
        w16 = tree.tree_unflatten(host, rounded)
        w32 = tree.tree_unflatten(host, [t.float() for t in rounded])
        truth = loss_and_grads(torch, tree, loss_of(torch.float32), w32,
                               "cpu")
        host_bf16 = loss_and_grads(torch, tree, loss_of(torch.bfloat16),
                                   w16, "cpu")
        reset_launches(flash, paged)
        card = loss_and_grads(torch, tree, loss_of(torch.bfloat16), w16,
                              "cuda")
        counts = kernel_launches(flash, paged)
        names = ["loss"] + leaf_paths(host)
        d_card, d_host = distances(card, truth), distances(host_bf16, truth)
        ratio = [c / (BF16_FACTOR * h + BF16_FLOOR)
                 for c, h in zip(d_card, d_host)]
        worst = int(np.argmax(ratio))
        attn = max((i for i, n in enumerate(names)
                    if n.startswith(ATTENTION_LEAVES)), key=lambda i: ratio[i])
        out[name] = dict(
            loss_host_fp32=truth[0], loss_card_bf16=card[0],
            loss_host_bf16=host_bf16[0],
            card_bf16_vs_host_fp32=max(d_card),
            host_bf16_vs_host_fp32=max(d_host),
            worst_leaf=dict(name=names[worst], card=d_card[worst],
                            host=d_host[worst], of_limit=ratio[worst]),
            worst_attention_leaf=dict(name=names[attn], card=d_card[attn],
                                      host=d_host[attn], of_limit=ratio[attn]),
            leaves={n: [c, h] for n, c, h in zip(names, d_card, d_host)},
            launches={k: counts[k] for k in ("K1-fwd", "K2-dq", "K2-dkv")})
    emit(dict(phase="bf16_parity", models="gpt2-1.5b and bert-large width, "
              "2 layers", batch=B, seq_len=S,
              design={k: flash.DESIGN[(k, torch.bfloat16)]
                      for k in ("K1-fwd", "K2-dq", "K2-dkv")},
              factor=BF16_FACTOR, floor=BF16_FLOOR,
              leaves_are="[card bf16, host bf16] distance from host float32",
              **out))
    for name, r in out.items():
        check(all(n > 0 for n in r["launches"].values()),
              f"bf16 parity ({name}): the card run did not launch every "
              f"flash kernel: {r['launches']}")
        w = r["worst_leaf"]
        check(np.isfinite(r["loss_card_bf16"]) and w["of_limit"] <= 1.0,
              f"bf16 parity ({name}): {w['name']}: card bf16 vs host "
              f"float32 {w['card']}, above {BF16_FACTOR} x the host's own "
              f"bf16 distance {w['host']} + {BF16_FLOOR}")


# ---------------------------------------------------------------------------
# --ab: the kernels of two checkouts, timed the same way
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# slice 13: head dims 32, 72 and 96 on the main paths, encoder inference
# ---------------------------------------------------------------------------

TRAIN_4B_LAYERS = 4      # of gpt2-4b's 64, cut for the run's time
SERVE_8B_LAYERS = 4      # of gpt2-8b's 72


def card_vs_host(torch, tree, loss_of, host, what, tol=1e-3):
    """float32, the same parameters on the card (kernels) and on the host
    (plain versions): the loss and every gradient leaf, each within
    ``tol`` of its scale. Returns the worst."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = [loss_and_grads(torch, tree, loss_of, host, dev)
           for dev in ("cuda", "cpu")]
    worst = max(distances(*got))
    check(np.isfinite(got[0][0]) and worst <= tol,
          f"{what}: card vs host, worst relative loss or gradient error "
          f"{worst} (tol {tol})")
    return worst


def train_4b_phase(torch, flash, paged, gpt, initialize, tree):
    """gpt2-4b training at full width (d_model 2304, 32 heads of 72:
    K1-fwd, K2-dq and K2-dkv at head dim 72), cut to TRAIN_4B_LAYERS
    layers: bf16 with bf16 masters and moments, AdamW, full remat, the
    chunked loss, batch 16 x 1024, one warm-up and two timed steps with
    the launch counters zeroed before; then float32 at 2 layers, card
    against host, the loss and every gradient leaf. Returns the launches."""
    S, L = 1024, TRAIN_4B_LAYERS
    cfg = gpt.preset("gpt2-4b", n_layers=L, max_seq_len=S, remat=True,
                     remat_policy="full", loss_chunk=2048)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim) == (2304, 32, 72),
          f"gpt2-4b preset changed: {cfg}")
    batch = {"tokens": np.random.default_rng(0).integers(
        1, cfg.vocab_size, (16, S + 1)).astype(np.int32)}
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng, _, _, _ = initialize(
        model=gpt.make_loss_fn(cfg), model_parameters=params,
        config={"train_batch_size": 16, "steps_per_print": 1000,
                "optimizer": {"type": "AdamW", "params": {
                    "lr": 1e-4, "weight_decay": 0.1}},
                "bf16": {"enabled": True, "memory_efficient": True}})
    del params
    batch = eng._to_device(batch)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(flash, paged)
    ms, losses = run_steps(torch, eng, batch, 2, 1)
    counts = kernel_launches(flash, paged)
    n = 3
    check(counts["K1-fwd"] == 2 * L * n and counts["K2-dq"] == L * n
          and counts["K2-dkv"] == L * n and counts["K3"] == 0,
          f"train_4b: launches {counts}, expected K1-fwd {2 * L * n}, K2 "
          f"{L * n}")
    check(losses[-1] < losses[0], f"train_4b: the loss did not fall on the "
                                  f"repeated batch: {losses}")
    step_ms = float(np.median(ms))
    flops = gpt.train_flops_per_token(cfg, S) * 16 * S
    peak = torch.cuda.max_memory_allocated() / 2**30
    del eng, batch
    torch.cuda.empty_cache()
    cfg2 = gpt.preset("gpt2-4b", n_layers=2, max_seq_len=129,
                      dtype=torch.float32)
    host = gpt.init_params(cfg2, seed=4, device="cpu", dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(1, cfg2.vocab_size, (2, 129))
    worst = card_vs_host(
        torch, tree, lambda p, dev: gpt.loss_fn(
            p, {"tokens": torch.as_tensor(tokens).to(dev)}, None, cfg2),
        host, "train_4b parity")
    emit(dict(phase="train_4b", model="gpt2-4b", layers=L, d_model=2304,
              heads=32, head_dim=72, dtype="bfloat16", batch=16, seq_len=S,
              step_ms=ms, step_ms_median=step_ms,
              tokens_per_s=16 * S / step_ms * 1e3,
              mfu_vs_989_tflops=flops / (step_ms / 1e3) / 989e12,
              peak_mem_gib=peak, loss=losses, launches=counts,
              parity=dict(layers=2, batch=2, seq_len=128, dtype="float32",
                          worst_relative_loss_or_gradient=worst, tol=1e-3)))
    return counts


def serve_8b_phase(torch, flash, paged, gpt, init_inference, serving):
    """gpt2-8b serving at full width (d_model 3072, 32 heads of 96), cut to
    SERVE_8B_LAYERS layers, bf16: ``generate`` on 4 prompts of 512 tokens
    (K1-fwd at head dim 96), then per pool mode (``serve_8b`` float,
    ``serve_8b_int8`` int8 KV blocks) an 8-slot drain of 8 requests of
    64-512 tokens, 32 new (K3's decode mode at 96, once per layer and
    decode step), and a speculative drain of 4 prompts of repeated spans,
    spec_k 4 (its verify mode at 96); each with the launch counters zeroed
    before. Returns the launches."""
    cfg = gpt.preset("gpt2-8b", n_layers=SERVE_8B_LAYERS)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim) == (3072, 32, 96),
          f"gpt2-8b preset changed: {cfg}")
    L, V = cfg.n_layers, cfg.vocab_size
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    eng = init_inference(model=(cfg, params), dtype=torch.bfloat16)
    del params
    rng = np.random.default_rng(8)
    prompts = rng.integers(1, V, (4, 512)).astype(np.int32)
    reset_launches(flash, paged)
    t0 = time.perf_counter()
    gen = eng.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = kernel_launches(flash, paged)
    check(gen.shape == (4, 528) and gen_launches["K1-fwd"] == L,
          f"gpt2-8b generate: {gen.shape}, launches {gen_launches}")
    reqs_prompts = [rng.integers(1, V, n).astype(np.int32)
                    for n in rng.integers(64, 513, 8)]
    spec_prompts = [repeating(rng, V, n) for n in rng.integers(64, 513, 4)]
    out = {"K1-fwd": gen_launches["K1-fwd"]}
    for kv_quant, tag in (("off", ""), ("int8", "-int8")):
        reqs, srv, row, launches = serve_drain(
            torch, flash, paged, serving, eng, reqs_prompts, new=32,
            kv_quant=kv_quant)
        n_dec = srv.stats["decode_steps"]
        others = {k: v for k, v in launches.items()
                  if k.startswith("K3") and k != f"K3{tag}" and v}
        check(launches[f"K3{tag}"] == L * n_dec > 0 and not others,
              f"gpt2-8b {kv_quant} drain: K3{tag} {launches[f'K3{tag}']} for "
              f"{n_dec} decode steps of {L} layers; others {others}")
        del srv
        sreqs, srv, spec_row, spec_launches = serve_drain(
            torch, flash, paged, serving, eng, spec_prompts, new=32,
            kv_quant=kv_quant, spec_decode=True, spec_k=4)
        check(spec_launches[f"K3{tag}-verify"] > 0,
              f"gpt2-8b {kv_quant} spec drain launched no verify: "
              f"{spec_launches}")
        emit(dict(phase=f"serve_8b{tag.replace('-', '_')}", model="gpt2-8b",
                  layers=L, d_model=3072, heads=32, head_dim=96,
                  dtype="bfloat16", kv_quant=kv_quant,
                  generate=dict(batch=4, prompt=512, new=16, seconds=gen_s,
                                launches=gen_launches) if not tag else None,
                  requests=8, new_tokens=32, drain=row, decode_steps=n_dec,
                  launches=launches, spec=dict(spec_row, requests=4,
                                               stats=spec_stats(srv),
                                               launches=spec_launches)))
        out[f"K3{tag}"] = launches[f"K3{tag}"]
        out[f"K3{tag}-verify"] = spec_launches[f"K3{tag}-verify"]
        del srv
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def bert_infer_phase(torch, flash, paged, bert, init_inference, tree):
    """Encoder inference: ``init_inference(model=(BertConfig, params))``
    at bert-large's full width and depth (24 layers, 16 heads of 64),
    bf16, ``forward`` on 32 sequences of 512 tokens (unmasked, K1-fwd
    non-causal once per layer), MLM logits [32, 512, 30522]: a warm-up and
    3 timed forwards with the launch counters zeroed before. Then float32
    at 2 layers, card against host, the MLM logits within 1e-4 of their
    scale at S = 256 (K1-fwd on the card, its plain version on the
    host). Returns the launches."""
    cfg = bert.preset("bert-large", max_seq_len=512, dropout=0.0)
    L = cfg.n_layers
    eng = init_inference(model=(cfg, bert.init_params(cfg, seed=0)),
                         dtype=torch.bfloat16)
    check(eng.is_encoder and eng.cfg.dtype == torch.bfloat16,
          "bert-large did not build an encoder engine in bf16")
    tokens = np.random.default_rng(9).integers(1, cfg.vocab_size, (32, 512))
    out = eng.forward(tokens)
    check(tuple(out.shape) == (32, 512, cfg.vocab_size)
          and bool(torch.isfinite(out).all()),
          f"bert forward: {tuple(out.shape)} or non-finite logits")
    del out
    reset_launches(flash, paged)
    ms = []
    for _ in range(3):
        eng.forward(tokens)
        ms.append(eng.latency_ms["forward"])
    launches = kernel_launches(flash, paged)
    check(launches["K1-fwd"] == 3 * L and launches["K2-dq"] == 0,
          f"bert forward: launches {launches}, expected K1-fwd {3 * L}")
    del eng
    torch.cuda.empty_cache()
    cfg2 = bert.preset("bert-large", n_layers=2, max_seq_len=256,
                       dropout=0.0, dtype=torch.float32)
    host = bert.init_params(cfg2, seed=4, device="cpu")
    small = tokens[:2, :256]
    logits = {}
    for dev in ("cpu", "cuda"):
        e = init_inference(model=(cfg2, host), dtype=torch.float32,
                           device=dev)
        logits[dev] = e.forward(small).float().cpu()
    rel = ((logits["cuda"] - logits["cpu"]).abs().max()
           / logits["cpu"].abs().max()).item()
    check(rel <= 1e-4, f"bert forward, card vs host: {rel} of the logits' "
                       f"scale (tol 1e-4)")
    emit(dict(phase="bert_infer", model="bert-large", layers=L,
              dtype="bfloat16", batch=32, seq_len=512,
              forward_ms=ms, forward_ms_median=float(np.median(ms)),
              sequences_per_s=32 / float(np.median(ms)) * 1e3,
              launches=launches,
              parity=dict(layers=2, batch=2, seq_len=256, dtype="float32",
                          mlm_logits_rel=rel, tol=1e-4)))
    return launches


ZERO_LAYERS = 4          # gpt2-1.5b's width at 4 of its 48 layers
ZERO_BATCH, ZERO_SEQ = 16, 1024
ZERO32_BATCH, ZERO32_SEQ = 8, 256      # float32, 2 layers
ZERO_STEPS = 2          # cut from 3 for the run's time


def zero_model(gpt, layers, seq, dtype):
    cfg = gpt.preset("gpt2-1.5b", n_layers=layers, max_seq_len=seq,
                     remat=True, remat_policy="full", loss_chunk=2048,
                     dtype=dtype)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim) == (1600, 25, 64),
          f"gpt2-1.5b preset changed: {cfg}")
    return cfg


def zero_config(stage, batch, bf16):
    cfg = {"train_batch_size": batch, "steps_per_print": 1000,
           "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                                     "weight_decay": 0.1}},
           "zero_optimization": {"stage": stage}}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def zero_batches(vocab):
    """(the bf16 run's batch, the float32 run's), from seed 0."""
    rng = np.random.default_rng(0)
    return ({"tokens": rng.integers(1, vocab, (ZERO_BATCH, ZERO_SEQ + 1))},
            {"tokens": rng.integers(1, vocab, (ZERO32_BATCH,
                                               ZERO32_SEQ + 1))})


def opt_bytes(torch, eng):
    return sum(t.numel() * t.element_size()
               for t in _tensor_leaves(torch, eng.opt_state))


def _tensor_leaves(torch, tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensor_leaves(torch, tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def zero_run(torch, flash, paged, eng, batch, steps, comm):
    """Steps with the launch counters and the collectives' counters zeroed
    just before: (per step ms, losses, launches, collectives with the
    seconds of each step's collectives)."""
    batch = eng._to_device(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(flash, paged)
    comm.reset_stats()
    ms, losses, coll_ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        before = sum(v["seconds"] for v in comm.stats().values())
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append((sum(v["seconds"] for v in comm.stats().values())
                        - before) * 1e3)
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"])),
              f"zero step: loss {losses[-1]}")
    colls = comm.stats()
    colls["ms_per_step"] = coll_ms
    return ms, losses, kernel_launches(flash, paged), colls


def zero_phase(torch, flash, paged, gpt, initialize, dist_lib, mesh_lib,
               comm):
    """ZeRO through one NCCL rank in this process
    (``init_distributed(dist_backend="nccl")``, a world of 1): first
    float32 at 2 layers, each stage's step on the rank against the same
    engine without a process group (``mesh=make_mesh(world_size=1)``), bit
    for bit, then ZERO_STEPS steps of the latter (zero_ranks' float32
    reference); then gpt2-1.5b's full width at ZERO_LAYERS layers, 16 x
    1024, bf16, full remat: one step at stages 0, 1 and 3 and ZERO_STEPS
    at stage 2 (zero_ranks' bf16 reference), the launches and collectives of
    each. Returns (launches of all four stages, the references)."""
    f32, bf16 = torch.float32, torch.bfloat16
    import socket
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    dist_lib.init_distributed(dist_backend="nccl",
                              init_method=f"tcp://localhost:{port}",
                              num_processes=1, process_id=0)
    try:
        check(dist_lib.get_world_size() == 1 and
              torch.distributed.get_backend() == "nccl",
              "zero: the NCCL world of one did not form")
        cfg32 = zero_model(gpt, 2, ZERO32_SEQ, f32)
        batch, batch32 = zero_batches(cfg32.vocab_size)
        params32 = gpt.init_params(cfg32, seed=0, dtype=f32)
        exact = {}
        for stage in range(4):
            got = []
            for mesh in (mesh_lib.make_mesh(world_size=1), None):
                eng = initialize(model=gpt.make_loss_fn(cfg32),
                                 model_parameters=params32,
                                 config=zero_config(stage, ZERO32_BATCH,
                                                    False), mesh=mesh)[0]
                check(eng.mesh.ranked == (mesh is None),
                      f"zero: mesh ranked {eng.mesh.ranked}")
                m = eng.train_batch(batch32)
                got.append((float(m["loss"]), float(m["grad_norm"]),
                            [t.clone() for t in _tensor_leaves(
                                torch, eng.params)]))
                del eng
            same = got[0][:2] == got[1][:2] and all(
                torch.equal(a, b) for a, b in zip(got[0][2], got[1][2]))
            check(same, f"zero: stage {stage} float32 step on one NCCL rank "
                        f"differs from the one-process engine: "
                        f"{got[0][:2]} vs {got[1][:2]}")
            exact[stage] = got[0][:2]
            del got
        eng = initialize(model=gpt.make_loss_fn(cfg32),
                         model_parameters=params32,
                         config=zero_config(2, ZERO32_BATCH, False),
                         mesh=mesh_lib.make_mesh(world_size=1))[0]
        ref32 = [float(eng.train_batch(batch32)["loss"])
                 for _ in range(ZERO_STEPS)]
        del eng, params32
        torch.cuda.empty_cache()

        cfg = zero_model(gpt, ZERO_LAYERS, ZERO_SEQ, bf16)
        params = gpt.init_params(cfg, seed=0, dtype=f32)
        rows, total = {}, {}
        ref16 = None
        for stage in range(4):
            eng = initialize(model=gpt.make_loss_fn(cfg),
                             model_parameters=params,
                             config=zero_config(stage, ZERO_BATCH, True))[0]
            steps = ZERO_STEPS if stage == 2 else 1
            ms, losses, counts, colls = zero_run(torch, flash, paged, eng,
                                                 batch, steps, comm)
            L = ZERO_LAYERS * steps
            check(counts["K1-fwd"] == 2 * L and counts["K2-dq"] == L
                  and counts["K2-dkv"] == L,
                  f"zero stage {stage}: launches {counts}, expected "
                  f"K1-fwd {2 * L}, K2 {L}")
            check(colls["all_reduce"]["calls"] > 0,
                  f"zero stage {stage}: no collective ran: {colls}")
            if stage == 2:
                ref16 = losses
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            rows[stage] = dict(
                step_ms=ms, loss=losses, launches=counts, collectives=colls,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                opt_state_gb=opt_bytes(torch, eng) / 1e9,
                master_gb=sum(t.numel() * t.element_size() for t in
                              _tensor_leaves(torch, eng.params)) / 1e9)
            del eng
            torch.cuda.empty_cache()
        n_params = sum(t.numel() for t in _tensor_leaves(torch, params))
        del params
        torch.cuda.empty_cache()
        emit(dict(phase="zero", backend="nccl", world=1, model="gpt2-1.5b",
                  layers=ZERO_LAYERS, params=n_params, batch=ZERO_BATCH,
                  seq_len=ZERO_SEQ, dtype="bfloat16", remat="full",
                  stages=rows, float32_bit_exact=dict(
                      layers=2, batch=ZERO32_BATCH, seq_len=ZERO32_SEQ,
                      loss_and_grad_norm=exact)))
    finally:
        dist_lib.destroy()
    return total, dict(bf16=ref16, float32=ref32)


def zero_runs(torch, world):
    """zero_ranks' runs on one of ``world`` gloo ranks on cuda:0 (the
    ``--ring-rank`` processes, before the ring variants): stages 2 and 3,
    bf16 at full width (its rows of the zero phase's batch) and float32 at
    2 layers, ZERO_STEPS steps each, the collectives timed (the device
    synchronised around each one); returns its rows."""
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch import initialize, zero
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.attention import flash, paged
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    f32, bf16 = torch.float32, torch.bfloat16
    cfg = zero_model(gpt, ZERO_LAYERS, ZERO_SEQ, bf16)
    cfg32 = zero_model(gpt, 2, ZERO32_SEQ, f32)
    batch, batch32 = zero_batches(cfg.vocab_size)
    rows = {}
    for name, c, b, n, dt, bf in (
            ("bf16", cfg, batch, ZERO_BATCH, bf16, True),
            ("float32", cfg32, batch32, ZERO32_BATCH, f32, False)):
        params = gpt.init_params(c, seed=0, dtype=f32)
        for stage in (2, 3):
            init = None
            if name == "bf16" and stage == 3:
                init, start = zero_init(torch, zero, mesh_lib,
                                        DeepSpeedConfig, gpt, c, n, bf)
            eng = initialize(model=gpt.make_loss_fn(c),
                             model_parameters=params if init is None
                             else start,
                             config=zero_config(stage, n, bf))[0]
            start = None
            check(eng.device == torch.device("cuda", 0) and
                  eng.dp_world_size == int(world),
                  f"zero rank: device {eng.device}, dp {eng.dp_world_size}")
            ms, losses, counts, colls = zero_run(torch, flash, paged, eng,
                                                 b, ZERO_STEPS, comm)
            rows[f"{name}_stage{stage}"] = dict(
                step_ms=ms, loss=losses, launches=counts, collectives=colls,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                opt_state_gb=opt_bytes(torch, eng) / 1e9,
                master_gb=sum(t.numel() * t.element_size() for t in
                              _tensor_leaves(torch, eng.params)) / 1e9,
                mesh=eng.mesh.shape, zero_init=init)
            del eng
            torch.cuda.empty_cache()
        del params
    return rows


def zero_init(torch, zero, mesh_lib, DeepSpeedConfig, gpt, cfg, batch, bf):
    """zero.Init at stage 3 on this rank: the model's leaves drawn one at
    a time on the card (``gpt.init_leaves``, the values of
    ``init_params``), this rank's slice of each kept. (its row: the
    card's peak during the call over what was allocated before, the
    shards' and the whole tree's bytes, the largest leaf's; the shards)."""
    mesh = mesh_lib.mesh_from_config(DeepSpeedConfig(zero_config(3, batch,
                                                                 bf)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shards = zero.Init(lambda seed: gpt.init_leaves(cfg, seed=seed), 0, mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sizes = [t.numel() * t.element_size() for t in _tensor_leaves(
        torch, shards.shapes)]
    row = dict(peak_gb=peak / 1e9,
               shards_gb=sum(t.numel() * t.element_size() for t in
                             _tensor_leaves(torch, shards)) / 1e9,
               whole_tree_gb=sum(sizes) / 1e9, largest_leaf_gb=max(sizes) / 1e9)
    check(peak < sum(sizes) and row["shards_gb"] < 0.6 * row["whole_tree_gb"],
          f"zero.Init: {row}")
    return row, shards


def zero3_state_bounds(gpt, layers, world):
    """GB of a ZeRO-3 rank's state at gpt2-1.5b's width over ``world``
    ranks, activations left out, from the leaf shapes (meta tensors):
    ``whole_tree_gather`` as the step holds it now (master, moments and
    gradient slices in fp32, plus the whole compute tree in bf16, its
    bf16 gradients and their fp32 accumulator) against
    ``per_layer_gather`` (the same slices, plus the embeddings whole in
    bf16 with their fp32 gradient, two layers' bf16 weights: the one in
    use and the next, and one layer's fp32 gradient before its
    reduce-scatter)."""
    from deepspeed_tpu_torch.runtime.zero.init import abstract_shapes
    from deepspeed_tpu_torch.tree import tree_paths
    cfg = zero_model(gpt, layers, ZERO_SEQ, None)
    shapes, _, _ = abstract_shapes(
        lambda seed: gpt.init_leaves(cfg, seed=seed, device="cpu"), 0)
    sizes = [(p, t.numel()) for p, t in tree_paths(shapes)]
    total = sum(n for _, n in sizes)
    layer = sum(n for p, n in sizes if p.startswith("block/")) / layers
    rest = total - layer * layers
    slices = 4 * 4 * total / world        # master, two moments, gradient
    gb = 1e-9
    return dict(params=total, layers=layers, world=world,
                slices_gb=slices * gb,
                whole_tree_gather_gb=(slices + (2 + 2 + 4) * total) * gb,
                per_layer_gather_gb=(slices + (2 + 4) * rest
                                     + 2 * 2 * layer + 4 * layer) * gb)


def zero_check(refs, ranks):
    """Holds the two ``--ring-rank`` ranks' ``zero_runs`` (8 of the 16 rows
    each: stages 2 and 3, ZERO_STEPS steps) to the zero phase's one-rank
    runs (bf16 to 2e-2, float32 at 2 layers to 1e-4), K1-fwd and K2
    launched on each rank, and emits the ``zero_ranks`` row: per rank its
    peak memory, optimizer-state and master bytes, ms per step and each
    collective's bytes and seconds (gloo through the host on one card,
    not NCCL). Returns the launches summed over the ranks."""
    total = {}
    for r, rows in enumerate(ranks):
        for key, row in rows.items():
            ref = refs["bf16" if key.startswith("bf16") else "float32"]
            tol = 2e-2 if key.startswith("bf16") else 1e-4
            err = max(abs(a - b) / abs(b) for a, b in zip(row["loss"], ref))
            row["loss_rel_err_vs_one_rank"] = err
            check(err <= tol, f"zero_ranks rank {r} {key}: losses "
                              f"{row['loss']} vs one rank {ref} ({err})")
            L = (ZERO_LAYERS if key.startswith("bf16") else 2) * ZERO_STEPS
            c = row["launches"]
            check(c["K1-fwd"] == 2 * L and c["K2-dq"] == L
                  and c["K2-dkv"] == L, f"zero_ranks rank {r} {key}: "
                                        f"launches {c}, expected 2x{L}, {L}")
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
            # the steps after the first (its gloo connections and the
            # process's first kernels): the collectives' share
            coll = row["collectives"]["ms_per_step"][1:]
            row["collective_share_of_step"] = sum(coll) / sum(
                row["step_ms"][1:])
    from deepspeed_tpu_torch.models import gpt
    emit(dict(phase="zero_ranks", backend="gloo", world=2, device="cuda:0",
              model="gpt2-1.5b", layers=ZERO_LAYERS, batch=ZERO_BATCH,
              rows_per_rank=ZERO_BATCH // 2, seq_len=ZERO_SEQ,
              one_rank_loss=refs, ranks=ranks,
              zero3_state_bounds=[zero3_state_bounds(gpt, n, 2)
                                  for n in (ZERO_LAYERS, 48)],
              note="collectives are gloo through the host, both ranks on "
                   "one card: not NCCL"))
    return total


# ---------------------------------------------------------------------------
# slice 15: sequence parallelism (ring attention, Ulysses)
# ---------------------------------------------------------------------------

RING_S_LOC, RING_H, RING_D = 4096, 32, 128     # one rank's llama-7b tokens
RING_WINDOW = 1024
RING_LAYERS = 2          # llama-7b's full width at 2 of its 32 layers
RING_SEQ = 2 * RING_S_LOC
RING_STEPS = 1           # cut from 2 for the run's time (tp_ranks)
# (name, sp_impl, sp_layout, attn_window, packed documents)
RING_VARIANTS = (
    ("contiguous", "ring", "contiguous", None, False),
    ("zigzag", "ring", "zigzag", None, False),
    ("window", "ring", "contiguous", RING_WINDOW, False),
    ("packed", "ring", "contiguous", None, True),
    ("ulysses", "ulysses", "contiguous", None, False))


def ring_problem(torch, q_off, window):
    """One rank's llama-7b attention block: bf16 q, k, v, do [1, 4096, 32,
    128] from seed 7, the q rows ``q_off`` tokens after the keys; the
    boolean map [1, S, Skv] of the pairs that attend (causal, and the
    window), and the rows and keys that have one (the other rows' do is
    zero: garbage by contract)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (1, RING_S_LOC, RING_H, RING_D)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(4))
    rows = torch.arange(RING_S_LOC, device=dev)[:, None] + q_off
    cols = torch.arange(RING_S_LOC, device=dev)[None]
    allowed = cols <= rows
    if window is not None:
        allowed = allowed & (rows - cols < window)
    allowed = allowed[None]
    rows_ok, keys_ok = allowed.any(-1), allowed.any(1)
    return q, k, v, do * rows_ok[:, :, None, None], allowed, rows_ok, keys_ok


def ring_kernel_cases(torch, F, flash, name, q_off, window, iters=10):
    """K1-fwd, K2-dq and K2-dkv in their ring modes (``flash_block_fwd``,
    ``flash_block_bwd_dq``, ``flash_block_bwd_dkv``: the ``-DDS_RING``
    build) at one rank's llama-7b attention block, bf16, fp32 gradients,
    each against its plain version (float32 on the same inputs) and timed
    beside it, beside SDPA with the same boolean mask (forward) and its
    autograd backward (dq, dk, dv in one call). Returns the three rows."""
    q, k, v, do, allowed, rows_ok, keys_ok = ring_problem(torch, q_off,
                                                          window)
    kw = dict(causal=True, window=window, q_off=q_off)
    fb = flash.flash_block_fwd
    o, lse = fb(q, k, v, **kw)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = flash.mha_reference(f[0], f[1], f[2], **kw)
    err = (o.float() - o_ref).abs()[rows_ok].max().item()
    lse_err = (lse - lse_ref).abs().transpose(1, 2)[rows_ok].max().item()
    check(err <= TOL["bfloat16"] and lse_err <= LSE_TOL,
          f"ring {name}: max |o - plain| {err}, |lse - plain| {lse_err}")
    del o_ref, lse_ref
    delta = flash.attention_delta(o, do)
    bargs = (q, k, v, do, lse, delta)
    dq = flash.flash_block_bwd_dq(*bargs, **kw)
    dk, dv = flash.flash_block_bwd_dkv(*bargs, **kw)
    check(dq.dtype == dk.dtype == dv.dtype == torch.float32,
          f"ring {name}: gradients {dq.dtype}, {dk.dtype}, {dv.dtype}")
    ref = flash._bwd_reference(f[0], f[1], f[2], lse, delta, f[3], True,
                               RING_D ** -0.5, None, window, None, q_off,
                               None, out_fp32=True)
    errs = {}
    for gname, got, r, ok in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                 (rows_ok, keys_ok, keys_ok)):
        gerr, top, rel = grad_errors(torch, got, r, ok)
        check(gerr <= TOL["bfloat16"] * top and rel <= TOL["bfloat16"],
              f"ring {name}: max |{gname} - plain| {gerr} (x {top}), per "
              f"row relative {rel}")
        errs[gname] = gerr
    del ref, f
    fwd_ms, fwd_by = device_ms(torch, lambda: fb(q, k, v, **kw), iters)
    dq_ms, dq_by = device_ms(torch, lambda: flash.flash_block_bwd_dq(
        *bargs, **kw), iters)
    dkv_ms, dkv_by = device_ms(torch, lambda: flash.flash_block_bwd_dkv(
        *bargs, **kw), iters)
    plain_fwd = time_ms(torch, lambda: flash.mha_reference(q, k, v, **kw), 2)
    plain_bwd = time_ms(torch, lambda: flash._bwd_reference(
        q, k, v, lse, delta, do, True, RING_D ** -0.5, None, window, None,
        q_off, None, out_fp32=True), 2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = allowed[:, None]
    lib_fwd, lib_fwd_by = device_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask), iters)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(1, 2)
    lib_bwd, lib_bwd_by = device_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters)
    pairs = int(allowed.sum().item()) * RING_H
    esz = q.element_size()
    n_q = q.numel()
    stats = 2 * RING_H * RING_S_LOC * 4          # lse, delta (fp32)
    rows = []
    for kernel, ms, by, flops, nbytes, plain, lib, lib_by, gerr in (
            ("K1-fwd-ring", fwd_ms, fwd_by, 4.0 * RING_D * pairs,
             4 * n_q * esz + stats // 2, plain_fwd, lib_fwd, lib_fwd_by,
             err),
            # q, k, v, do read, lse and delta read, dq written in fp32
            ("K2-dq-ring", dq_ms, dq_by, 6.0 * RING_D * pairs,
             4 * n_q * esz + stats + 4 * n_q, plain_bwd, lib_bwd,
             lib_bwd_by, errs["dq"]),
            ("K2-dkv-ring", dkv_ms, dkv_by, 8.0 * RING_D * pairs,
             4 * n_q * esz + stats + 2 * 4 * n_q, plain_bwd, lib_bwd,
             lib_bwd_by, max(errs["dk"], errs["dv"]))):
        bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
        row = dict(phase="kernel", kernel=kernel, case=name,
                   dtype="bfloat16", shape=dict(
                       B=1, S=RING_S_LOC, Skv=RING_S_LOC, H=RING_H,
                       Hkv=RING_H, D=RING_D, q_off=q_off, window=window),
                   max_abs_err=gerr, tol=TOL["bfloat16"],
                   gradients="float32" if kernel != "K1-fwd-ring" else None,
                   design=design_of(flash, (kernel[:-5], torch.bfloat16)),
                   kernel_ms=ms, plain_ms=plain,
                   plain_is=None if kernel == "K1-fwd-ring"
                   else "dq, dk and dv together",
                   library_ms=lib, timed_by=by, library_timed_by=lib_by,
                   library_is="SDPA, boolean attn_mask" + (
                       "" if kernel == "K1-fwd-ring"
                       else ", backward (dq, dk, dv) through autograd"),
                   tflops=flops / ms / 1e9, vs_library=ms / lib,
                   bound_us=bound_ms * 1e3, bound_by=bound_by)
        emit(row)
        rows.append(row)
    return rows


def ring_model(gpt, torch, impl="ring", layout="contiguous", window=None,
               sequence_parallel=True):
    cfg = gpt.preset("llama-7b", n_layers=RING_LAYERS, max_seq_len=RING_SEQ,
                     dtype=torch.bfloat16, attn_window=window,
                     sequence_parallel=sequence_parallel, sp_impl=impl,
                     sp_layout=layout)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ffn_dim,
           cfg.vocab_size) == (4096, 32, 128, 11008, 32000),
          f"llama-7b preset changed: {cfg}")
    return cfg


def ring_config(sp):
    cfg = {"train_batch_size": 1, "steps_per_print": 1000,
           "gradient_clipping": 1.0, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                                     "weight_decay": 0.1}}}
    if sp > 1:
        cfg["mesh"] = {"sequence_parallel_size": sp}
    return cfg


def ring_batches(pack_documents, zigzag_batch):
    """{"plain", "packed", "zigzag"}: one row of 8,193 seeded tokens (seed
    0), seeded documents of 512-3,000 tokens packed into one row (segment
    ids, positions, loss mask), and the plain row laid out for the zigzag
    layout over 2 ranks."""
    rng = np.random.default_rng(0)
    plain = {"tokens": rng.integers(1, 32000, (1, RING_SEQ + 1))}
    docs = seeded_documents(rng, 32000, 1, RING_SEQ + 1, lo=512, hi=3000)
    packed = {k: v[:1] for k, v in pack_documents(docs, RING_SEQ + 1).items()}
    return dict(plain=plain, packed=packed, zigzag=zigzag_batch(plain, 2))


def ring_launches(flash):
    fb, bb, fa = flash.flash_block_fwd, flash.flash_block_bwd, \
        flash.flash_attention
    return {"K1-fwd-ring": fb.launches, "K1-fwd-ring q_off>0":
            fb.offset_launches, "K2-dq-ring": bb.dq_launches,
            "K2-dkv-ring": bb.dkv_launches,
            "K2-ring q_off>0": bb.offset_launches, "K1-fwd": fa.launches,
            "K2-dq": fa.bwd_dq_launches, "K2-dkv": fa.bwd_dkv_launches}


def reset_ring_launches(flash):
    fb, bb, fa = flash.flash_block_fwd, flash.flash_block_bwd, \
        flash.flash_attention
    fb.launches = fb.offset_launches = 0
    bb.dq_launches = bb.dkv_launches = bb.offset_launches = 0
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def ring_steps(torch, eng, batch, steps):
    """(ms per step, losses, grad norms) of ``steps`` steps on the card."""
    batch = eng._to_device(batch)
    ms, losses, norms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        check(np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
              f"ring step: loss {losses[-1]}, grad norm {norms[-1]}")
    return ms, losses, norms


def ring_rank_main(world, rank, store, out):
    """One of ring_ranks' gloo ranks on cuda:0 (``python3 chip_smoke.py
    --ring-rank WORLD RANK STORE OUT``): first ``zero_ranks``' runs
    (``zero_runs``), then each variant of RING_VARIANTS as
    an engine with ``sequence_parallel_size`` WORLD over the same seeded
    llama-7b weights, RING_STEPS steps, with the ring-mode and flash
    kernels' launches, the collectives (timed, the device synchronised
    around each) and the card's peak; then ``tp_ranks``' runs at model
    degree WORLD (``tp_runs``) and ``pipe_ranks``' (``pipe_runs``); writes
    its rows to OUT as JSON."""
    import torch
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.dataloader import (pack_documents,
                                                         zigzag_batch)
    from deepspeed_tpu_torch.utils import distributed as dist_lib
    dist_lib.init_distributed(dist_backend="gloo",
                              init_method=f"file://{store}",
                              num_processes=int(world), process_id=int(rank))
    comm.timed(True)
    # ZeRO stages 2 and 3 in the same world first (one start-up of torch
    # and CUDA a rank for the four phases)
    rows = {"zero": zero_runs(torch, int(world))}
    batches = ring_batches(pack_documents, zigzag_batch)
    params = gpt.init_params(ring_model(gpt, torch), seed=0,
                             dtype=torch.float32)
    for name, impl, layout, window, packed in RING_VARIANTS:
        cfg = ring_model(gpt, torch, impl, layout, window)
        eng = initialize(model=gpt.make_loss_fn(cfg), model_parameters=params,
                         config=ring_config(int(world)))[0]
        check(eng.sp_world_size == int(world) and eng.dp_world_size == 1,
              f"ring rank: sp {eng.sp_world_size}, dp {eng.dp_world_size}")
        batch = batches["packed" if packed else
                        "zigzag" if layout == "zigzag" else "plain"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_ring_launches(flash)
        comm.reset_stats()
        ms, losses, norms = ring_steps(torch, eng, batch, RING_STEPS)
        rows[name] = dict(step_ms=ms, loss=losses, grad_norm=norms,
                          launches=ring_launches(flash),
                          collectives=comm.stats(),
                          peak_mem_gib=torch.cuda.max_memory_allocated()
                          / 2**30)
        del eng
        torch.cuda.empty_cache()
    # tensor parallelism in the same world (one start-up of torch and
    # CUDA a rank for both phases): the collectives timed as above
    rows["tp"] = tp_runs(torch, int(world), os.path.join(
        os.path.dirname(out), "tp_logits.npy"))
    # pipeline parallelism in the same world
    rows["pipe"] = pipe_runs(torch, int(world))
    with open(out, "w") as f:
        json.dump(rows, f)
    dist_lib.destroy()
    return 0


def ring_expected(name, rank):
    """Per rank, the launches of a variant: the ring's forward and
    backward blocks per layer and step (contiguous: rank r holds r + 1
    live hops, the other block lies in its future; zigzag: two on each
    rank; the window: hop 1 at q_off 4096 on rank 1 only), and Ulysses'
    flash kernels. The selective remat keeps the attention's output, so a
    recompute launches no forward."""
    per = RING_LAYERS * RING_STEPS
    hops = 2 if name == "zigzag" else 1 + rank
    if name == "ulysses":
        return {"K1-fwd-ring": 0, "K2-dq-ring": 0, "K1-fwd": per,
                "K2-dq": per, "K2-dkv": per}
    out = {"K1-fwd-ring": hops * per, "K2-dq-ring": hops * per,
           "K2-dkv-ring": hops * per, "K1-fwd": 0, "K2-dq": 0}
    out["K1-fwd-ring q_off>0"] = rank * per if name == "window" else 0
    return out


def ring_ranks_phase(torch, gpt, initialize, pack_documents, zigzag_batch,
                     serving, init_inference, zero_refs):
    """Sequence parallelism at llama-7b's full width (2 of 32 layers), one
    row of 8,192 tokens, bf16 compute over fp32 masters: first the
    one-rank engine without sequence parallelism on the card (the plain
    row, the windowed model, the packed row), then two gloo ranks on
    cuda:0 (``--ring-rank``), 4,096 tokens each, through the five
    RING_VARIANTS. Each variant's loss and gradient norm within 2e-2 of
    its one-rank run, the launches on each rank as ``ring_expected``
    counts them, and per
    rank the rotations, all-to-alls and all-reduces with their bytes and
    seconds and the peak memory beside the one-rank run's. The same two
    ranks then run ``tp_ranks`` (``tp_runs`` at degree 2, held by
    ``tp_check`` to the one-rank runs made here before the spawn). Returns
    the ring-mode launches summed over the ranks and variants, and the TP
    path's."""
    batches = ring_batches(pack_documents, zigzag_batch)
    refs = {}
    for key, window, batch in (("plain", None, "plain"),
                               ("window", RING_WINDOW, "plain"),
                               ("packed", None, "packed")):
        cfg = ring_model(gpt, torch, window=window, sequence_parallel=False)
        params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
        eng = initialize(model=gpt.make_loss_fn(cfg), model_parameters=params,
                         config=ring_config(1))[0]
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses, norms = ring_steps(torch, eng, batches[batch],
                                       RING_STEPS)
        refs[key] = dict(step_ms=ms, loss=losses, grad_norm=norms,
                         peak_mem_gib=torch.cuda.max_memory_allocated()
                         / 2**30)
        del eng
        torch.cuda.empty_cache()
    work = os.path.join(REPO, "build", "ring_ranks")
    os.makedirs(work, exist_ok=True)
    tp_ref = tp_runs(torch, 1, os.path.join(work, "tp_logits.npy"))
    pipe_ref = pipe_runs(torch, 1)
    store = os.path.join(work, f"store{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    outs = [os.path.join(work, f"rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ring-rank", "2",
         str(r), store, outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=500)
            errs.append((p.returncode, err))
            if p.returncode:
                break
    finally:
        for p in procs:      # a failed or hung rank must not outlive this
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, err) in enumerate(errs):
        check(rc == 0, f"ring_ranks: rank {r} exited {rc}:\n{err[-3000:]}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    zero_total = zero_check(zero_refs, [rows.pop("zero") for rows in ranks])
    tp_total = tp_check(torch, serving, gpt, init_inference, tp_ref,
                        [rows.pop("tp") for rows in ranks])
    pipe_total = pipe_check(pipe_ref, [rows.pop("pipe") for rows in ranks])
    total = {}
    for r, rows in enumerate(ranks):
        for name, impl, layout, window, packed in RING_VARIANTS:
            row = rows[name]
            ref = refs["packed" if packed else
                       "window" if window else "plain"]
            err = max(abs(a - b) / abs(b) for a, b in zip(row["loss"],
                                                        ref["loss"]))
            row["loss_rel_err_vs_one_rank"] = err
            check(err <= 2e-2, f"ring_ranks rank {r} {name}: losses "
                               f"{row['loss']} vs one rank {ref['loss']}")
            # one step: its gradient norm holds the reduced gradients
            gerr = max(abs(a - b) / abs(b) for a, b in zip(
                row["grad_norm"], ref["grad_norm"]))
            row["grad_norm_rel_err_vs_one_rank"] = gerr
            check(gerr <= 2e-2, f"ring_ranks rank {r} {name}: gradient "
                  f"norms {row['grad_norm']} vs one rank "
                  f"{ref['grad_norm']}")
            got = row["launches"]
            want = ring_expected(name, r)
            check(all(got[k] == v for k, v in want.items()),
                  f"ring_ranks rank {r} {name}: launches {got}, expected "
                  f"{want}")
            c = row["collectives"]
            if impl == "ring":
                check(c["rotate"]["calls"] > 0 and c["rotate"]["staged"]
                      == c["rotate"]["calls"], f"ring_ranks rank {r} "
                      f"{name}: rotations {c['rotate']}")
            else:
                # q, k, v and the output each way in the forward, again in
                # the remat recompute (the kept output skips the kernel,
                # not the exchanges), and in the backward
                check(c["all_to_all"]["calls"] == 12 * RING_LAYERS
                      * RING_STEPS, f"ring_ranks rank {r} {name}: "
                      f"all-to-alls {c['all_to_all']}")
            row["peak_vs_one_rank"] = row["peak_mem_gib"] / ref[
                "peak_mem_gib"]
            for k in ("K1-fwd-ring", "K2-dq-ring", "K2-dkv-ring"):
                total[k] = total.get(k, 0) + got[k]
    check(total["K1-fwd-ring"] > 0, "ring_ranks: no ring-mode launch")
    emit(dict(phase="ring_ranks", backend="gloo", world=2, device="cuda:0",
              model="llama-7b", layers=RING_LAYERS, batch=1,
              seq_len=RING_SEQ, tokens_per_rank=RING_S_LOC,
              dtype="bfloat16", masters="float32", steps=RING_STEPS,
              variants=[v[0] for v in RING_VARIANTS], one_rank=refs,
              ranks=ranks,
              note="collectives are gloo through the host, both ranks on "
                   "one card: not NCCL; gloo's send/recv take host "
                   "memory, so the rotations are staged through pinned "
                   "buffers"))
    return total, zero_total, tp_total, pipe_total


# tensor parallelism: llama-7b's full width on two gloo ranks of cuda:0
TP_FP32_LAYERS = 2       # the float32 streams and logits
TP_SERVE_LAYERS = 4      # the bf16 and int8 drains, of llama-7b's 32
TP_TRAIN_LAYERS = 2
TP_TRAIN_ROWS, TP_TRAIN_SEQ = 4, 1024
TP_NEW = 32
TP_STEPS = 2
TP_LOGITS_TOL = 1e-4
# K4 at one rank's llama-7b projections at model degree 2: qkv and the MLP
# inputs split by columns, attn_out and mlp_out by rows
TP_PROJ = (("qkv", 4096, 6144), ("attn_out", 2048, 4096),
           ("mlp_in", 4096, 5504), ("mlp_out", 5504, 4096))


def tp_model(gpt, torch, layers, dtype, **kw):
    cfg = gpt.preset("llama-7b", n_layers=layers, dtype=dtype, **kw)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.ffn_dim,
           cfg.vocab_size) == (4096, 32, 128, 11008, 32000),
          f"llama-7b preset changed: {cfg}")
    return cfg


def tp_inputs():
    """The phase's seeded inputs: two float32 prompts of 128 tokens,
    ``serve``'s ``generate`` prompts (4 x 512) and its first 8 requests'
    prompts (64-1,024 tokens, the same draws from seed 0), and a training
    batch of 4 x 1,025 tokens (seed 21)."""
    rng = np.random.default_rng(0)
    gen = rng.integers(1, 32000, (4, 512)).astype(np.int32)
    lens = rng.integers(64, 1025, 16)
    serve = [rng.integers(1, 32000, n).astype(np.int32) for n in lens][:8]
    rng = np.random.default_rng(21)
    return dict(fp32=rng.integers(1, 32000, (2, 128)).astype(np.int32),
                gen=gen, serve=serve,
                train={"tokens": rng.integers(1, 32000, (TP_TRAIN_ROWS,
                                                         TP_TRAIN_SEQ + 1))})


def tp_bytes(tree):
    from deepspeed_tpu_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_drain(torch, flash, paged, comm, serving, eng, prompts, **kw):
    """One greedy drain of ``prompts`` (8 slots, block 16, chunk 256, TP_NEW
    new tokens each) with its launches and the all-reduces per token."""
    srv = serving.ServingEngine(eng, num_slots=8, block_size=16,
                                prefill_chunk=256, **kw)
    reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=TP_NEW)
            for i, p in enumerate(prompts)]
    reset_launches(flash, paged)
    comm.reset_stats()
    step_end, t_submit = drain(torch, srv, reqs)
    got = kernel_launches(flash, paged)
    n_tok = sum(len(r.out) for r in reqs)
    check(n_tok == TP_NEW * len(reqs), f"tp drain: {n_tok} tokens")
    c = comm.stats()["tp_all_reduce"]
    return dict(streams=[[int(t) for t in r.out] for r in reqs],
                launches=got, stats=dict(srv.stats),
                pool_bytes=tp_bytes({"k": srv.cache.k, "v": srv.cache.v}),
                pool_kv_heads=int(srv.cache.k.shape[3]),
                tp_all_reduce=dict(c, per_token={
                    k: c[k] / n_tok for k in ("calls", "bytes", "seconds")}),
                **drain_row(step_end, t_submit, reqs))


def tp_runs(torch, mp, logits_path):
    """The phase's runs at model degree ``mp``: 1 in chip_smoke's own
    process (the references), 2 on each ``--ring-rank`` (after the ring
    variants, in the same spawned world). float32 at 2 layers: generate
    (16 new) and forward's logits (saved at 1, held to them at 2); bf16 at
    4 layers: generate (K1-fwd) and the drain of the 8 serve prompts (K3),
    weight and pool bytes, TPOT and the all-reduces per token; int8
    weights and KV at 4 layers (K4, K3-int8); two training steps at 2
    layers, 4 x 1,024, bf16 over fp32 masters, ZeRO 1 (K1-fwd, K2)."""
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch import init_inference, initialize
    from deepspeed_tpu_torch.inference import serving
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.attention import flash, paged
    from deepspeed_tpu_torch.parallel import comm
    inp = tp_inputs()
    out = {}
    cfg = tp_model(gpt, torch, TP_FP32_LAYERS, torch.float32)
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    eng = init_inference(model=(cfg, params), mp_size=mp,
                         dtype=torch.float32)
    del params
    gen = eng.generate(inp["fp32"], max_new_tokens=16)
    logits = eng.forward(inp["fp32"][:1, :64]).float().cpu().numpy()
    out["fp32"] = dict(gen=gen.tolist(), kv_heads=eng.kv_heads)
    if mp == 1:
        np.save(logits_path, logits)
    else:
        ref = np.load(logits_path)
        out["fp32"].update(logits_err=float(np.abs(logits - ref).max()),
                           logits_max=float(np.abs(ref).max()))
    del eng
    torch.cuda.empty_cache()

    cfg = tp_model(gpt, torch, TP_SERVE_LAYERS, torch.bfloat16)
    params = gpt.init_params(cfg, seed=0, dtype=torch.bfloat16)
    for dtype, kv in ((torch.bfloat16, "off"), (torch.int8, "int8")):
        eng = init_inference(model=(cfg, params), mp_size=mp, dtype=dtype)
        name = "bf16" if kv == "off" else "int8"
        row = dict(weight_bytes=tp_bytes(eng.params))
        if kv == "off":
            reset_launches(flash, paged)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(inp["gen"], max_new_tokens=TP_NEW)
            torch.cuda.synchronize()
            row["generate"] = dict(seconds=time.perf_counter() - t0,
                                   launches=kernel_launches(flash, paged))
        row.update(tp_drain(torch, flash, paged, comm, serving, eng,
                            inp["serve"], kv_quant=kv))
        out[name] = row
        del eng
        torch.cuda.empty_cache()
    del params

    cfg = tp_model(gpt, torch, TP_TRAIN_LAYERS, torch.bfloat16,
                   max_seq_len=TP_TRAIN_SEQ)
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    config = {"train_batch_size": TP_TRAIN_ROWS, "steps_per_print": 1000,
              "gradient_clipping": 1.0, "bf16": {"enabled": True},
              "zero_optimization": {"stage": 1},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                                        "weight_decay": 0.1}}}
    if mp > 1:
        config["mesh"] = {"tensor_parallel_size": mp}
    eng = initialize(model=gpt.make_loss_fn(cfg), model_parameters=params,
                     config=config, partition_rules=gpt.gpt_partition_rules()
                     if mp > 1 else None)[0]
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(flash, paged)
    comm.reset_stats()
    ms, losses, norms = ring_steps(torch, eng, inp["train"], TP_STEPS)
    c = comm.stats()
    out["train"] = dict(
        step_ms=ms, loss=losses, grad_norm=norms,
        launches=kernel_launches(flash, paged),
        master_bytes=tp_bytes(eng.params),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        collectives={k: c[k] for k in ("tp_all_reduce", "all_reduce")},
        collective_share=sum(c[k]["seconds"] for k in c) / (sum(ms) / 1e3))
    del eng
    torch.cuda.empty_cache()
    return out


def tp_check(torch, serving, gpt, init_inference, ref, ranks):
    """Holds the two ranks' ``tp_runs`` to the one-rank run's and emits
    the ``tp_ranks`` row; returns the launches on the TP path summed over
    the ranks."""
    for r, got in enumerate(ranks):
        f = got["fp32"]
        check(f["gen"] == ref["fp32"]["gen"], f"tp_ranks rank {r}: float32 "
              f"streams differ from the one-rank engine's")
        check(f["logits_err"] <= TP_LOGITS_TOL * max(1.0, f["logits_max"]),
              f"tp_ranks rank {r}: float32 logits {f['logits_err']} from "
              f"one rank's")
        check(f["kv_heads"] == 16, f"tp_ranks rank {r}: {f['kv_heads']} kv "
              f"heads")
        for name in ("bf16", "int8"):
            g = got[name]
            L, st = TP_SERVE_LAYERS, g["stats"]
            check(g["streams"] == ranks[0][name]["streams"],
                  f"tp_ranks: the ranks' {name} streams differ")
            check(g["pool_kv_heads"] == 16 and g["pool_bytes"] * 2
                  == ref[name]["pool_bytes"], f"tp_ranks rank {r} {name}: "
                  f"pools of {g['pool_kv_heads']} heads, {g['pool_bytes']} "
                  f"bytes")
            k3 = "K3" if name == "bf16" else "K3-int8"
            check(g["launches"][k3] == L * st["decode_steps"] > 0,
                  f"tp_ranks rank {r} {name}: {k3} {g['launches']}, "
                  f"{st['decode_steps']} decode steps")
            if name == "int8":
                want = 5 * L * (st["decode_steps"] + st["prefill_chunks"])
                check(g["launches"]["K4"] == want, f"tp_ranks rank {r}: K4 "
                      f"{g['launches']['K4']}, expected {want}")
            g["agreement_vs_one_rank"] = [
                agreed(a, b) for a, b in zip(g["streams"],
                                             ref[name]["streams"])]
            g["weight_bytes_vs_one_rank"] = g["weight_bytes"] / ref[name][
                "weight_bytes"]
            g["tpot_vs_one_rank"] = g["tpot_s_p50"] / ref[name]["tpot_s_p50"]
        k1 = got["bf16"]["generate"]["launches"]
        check(k1["K1-fwd"] == TP_SERVE_LAYERS and k1["K3"] == 0,
              f"tp_ranks rank {r}: generate launched {k1}")
        t = got["train"]
        err = max(abs(a - b) / abs(b) for a, b in zip(t["loss"],
                                                    ref["train"]["loss"]))
        t["loss_rel_err_vs_one_rank"] = err
        check(err <= 2e-2, f"tp_ranks rank {r}: losses {t['loss']} vs one "
              f"rank {ref['train']['loss']}")
        n = TP_TRAIN_LAYERS * TP_STEPS
        check(all(t["launches"][k] == n for k in ("K1-fwd", "K2-dq",
                                                  "K2-dkv")),
              f"tp_ranks rank {r}: training launched {t['launches']}")
        t["peak_vs_one_rank"] = t["peak_mem_gib"] / ref["train"][
            "peak_mem_gib"]
    # where the bf16 streams part from one rank's: a near-tie that
    # rounding flips, held by spec's check on the one-rank engine
    cfg = tp_model(gpt, torch, TP_SERVE_LAYERS, torch.bfloat16)
    eng = init_inference(model=(cfg, gpt.init_params(
        cfg, seed=0, dtype=torch.bfloat16)), dtype=torch.bfloat16)
    inp = tp_inputs()

    def reqs(streams):
        return [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=TP_NEW,
                                     out=list(s))
                for i, (p, s) in enumerate(zip(inp["serve"], streams))]
    parted = partings(torch, eng, serving, reqs(ref["bf16"]["streams"]),
                      reqs(ranks[0]["bf16"]["streams"]), "off")
    del eng
    torch.cuda.empty_cache()
    emit(dict(phase="tp_ranks", backend="gloo", world=2, device="cuda:0",
              model="llama-7b", fp32_layers=TP_FP32_LAYERS,
              serve_layers=TP_SERVE_LAYERS, train_layers=TP_TRAIN_LAYERS,
              heads_per_rank=16, d_ff_per_rank=5504, new=TP_NEW,
              train_batch=[TP_TRAIN_ROWS, TP_TRAIN_SEQ], steps=TP_STEPS,
              one_rank=ref, ranks=ranks, bf16_partings=parted,
              note="the all-reduces are gloo through the host, both ranks "
                   "on one card: not NCCL over NVLink"))
    total = {}
    for got in ranks:
        for key, src, row in (
                ("K1-fwd", got["train"], "K1-fwd@tp"),
                ("K2-dq", got["train"], "K2-dq@tp"),
                ("K2-dkv", got["train"], "K2-dkv@tp"),
                ("K3", got["bf16"], "K3@tp"),
                ("K3-int8", got["int8"], "K3-int8@tp"),
                ("K4", got["int8"], "K4@tp"),
                ("K1-fwd", got["bf16"]["generate"], "K1-fwd generate")):
            total[row] = total.get(row, 0) + src["launches"][key]
    return total


# pipeline parallelism: gpt2-1.5b's full width (tied embeddings) on two
# gloo ranks of cuda:0, each stage 2 of the 4 layers kept of its 48
PIPE_LAYERS = 4
PIPE_ROWS, PIPE_SEQ = 8, 1024
PIPE_MICRO = 4
PIPE_STEPS = 2
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))


def pipe_model(gpt, torch):
    cfg = gpt.preset("gpt2-1.5b", n_layers=PIPE_LAYERS, max_seq_len=PIPE_SEQ,
                     dtype=torch.bfloat16)
    check((cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.tie_embeddings,
           cfg.use_flash_attention) == (1600, 25, 64, True, True),
          f"gpt2-1.5b preset changed: {cfg}")
    return cfg


def pipe_runs(torch, world):
    """``PIPE_STEPS`` steps of 8 rows of 1,024 tokens, bf16 compute over
    fp32 masters, from the same seeded weights: at ``world`` 1 (in
    chip_smoke's own process, before the spawn) the engine without a
    pipeline, the reference; above 1 (on each ``--ring-rank``, after
    ``tp_ranks``) the pipelined loss over a ``pipe`` axis of ``world``
    under each of PIPE_SCHEDULES, ``PIPE_MICRO`` microbatches. Per run the
    step times, losses, gradient norms, K1-fwd and K2 launches, the
    card's peak over the memory held before the steps, and for the last
    step the sends, the receives (their seconds: the stage waiting for
    its neighbour, transfer and bubble) and the tied all-reduce, timed
    with the device synchronised around each."""
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops.attention import flash
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    cfg = pipe_model(gpt, torch)
    params = gpt.init_params(cfg, seed=0, dtype=torch.float32)
    batch = {"tokens": np.random.default_rng(3).integers(
        1, 50257, (PIPE_ROWS, PIPE_SEQ + 1))}
    config = {"train_batch_size": PIPE_ROWS, "steps_per_print": 1000,
              "gradient_clipping": 1.0, "bf16": {"enabled": True},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                                        "weight_decay": 0.1}}}
    mesh = None
    runs = [("one_rank", None, 1)]
    if world > 1:
        mesh = mesh_lib.make_mesh(mesh_lib.MeshSpec(pipe=world, data=1))
        config["mesh"] = {"pipeline_parallel_size": world}
        runs = [(s, s, v) for s, v in PIPE_SCHEDULES]
    out = {}
    for name, schedule, v in runs:
        loss = gpt.make_loss_fn(cfg) if schedule is None else \
            gpt.make_pipeline_loss_fn(cfg, mesh, world, PIPE_MICRO,
                                      schedule=schedule, virtual_chunks=v)
        eng = initialize(model=loss, model_parameters=params, config=config,
                         mesh=mesh, partition_rules=None if mesh is None
                         else gpt.gpt_pipeline_partition_rules())[0]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa = flash.flash_attention
        fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
        ms, losses, norms = ring_steps(torch, eng, batch, PIPE_STEPS - 1)
        comm.reset_stats()
        last = ring_steps(torch, eng, batch, 1)
        c = comm.stats()
        ms, losses, norms = ms + last[0], losses + last[1], norms + last[2]
        out[name] = dict(
            step_ms=ms, loss=losses, grad_norm=norms,
            launches={"K1-fwd": fa.launches, "K2-dq": fa.bwd_dq_launches,
                      "K2-dkv": fa.bwd_dkv_launches},
            held_gib=held / 2**30,
            peak_over_held_gib=(torch.cuda.max_memory_allocated() - held)
            / 2**30,
            stage=0 if mesh is None else mesh.coord["pipe"],
            stats=dict(getattr(loss, "stats", {})),
            last_step={k: c[k] for k in ("pipe_send", "pipe_recv",
                                         "tied_all_reduce", "all_reduce")})
        del eng, loss
        torch.cuda.empty_cache()
    return out


def pipe_expected(schedule, v, stage, P=2):
    """Per rank, the flash kernels' launches of ``PIPE_STEPS`` steps: a
    virtual stage reruns its layers from the saved input at its backward
    (K1-fwd twice, K2 once per layer and microbatch), but the last, whose
    layers and head run once, with the graph, at its backward."""
    Lv, V = PIPE_LAYERS // (P * v), P * v
    k1 = PIPE_MICRO * Lv * sum(1 if c * P + stage == V - 1 else 2
                               for c in range(v))
    k2 = PIPE_MICRO * Lv * v
    return {"K1-fwd": k1 * PIPE_STEPS, "K2-dq": k2 * PIPE_STEPS,
            "K2-dkv": k2 * PIPE_STEPS}


def pipe_check(ref, ranks):
    """Holds the two ranks' ``pipe_runs`` to the one-rank run (losses and
    gradient norms within 2e-2), their launches to ``pipe_expected`` and
    their messages to the schedule's tables, and emits the ``pipe_ranks``
    row: per rank and schedule the step, the receives' wait beside the
    fill-drain bubble (P - 1) / (M + P - 1), the sends, the tied
    all-reduce, and the peak beside GPipe's. Returns the launches summed
    over the ranks and schedules."""
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.runtime.pipe import engine as pipe_lib
    from deepspeed_tpu_torch.runtime.pipe.schedule import (
        interleaved_1f1b_tables)
    P, M = len(ranks), PIPE_MICRO
    one = ref["one_rank"]
    total = {}
    for r, rows in enumerate(ranks):
        for schedule, v in PIPE_SCHEDULES:
            row = rows[schedule]
            s = row["stage"]
            for key in ("loss", "grad_norm"):
                err = max(abs(a - b) / abs(b) for a, b in zip(row[key],
                                                            one[key]))
                row[f"{key}_rel_err_vs_one_rank"] = err
                check(err <= 2e-2, f"pipe_ranks rank {r} {schedule}: {key} "
                      f"{row[key]} vs one rank {one[key]}")
            want = pipe_expected(schedule, v, s, P)
            check(row["launches"] == want, f"pipe_ranks rank {r} "
                  f"{schedule}: launches {row['launches']}, expected {want}")
            tab = {"gpipe": lambda: pipe_lib.gpipe_tables(P, M),
                   "1f1b": lambda: pipe_lib.one_f_one_b_tables(P, M),
                   "interleaved": lambda: interleaved_1f1b_tables(P, v, M)
                   }[schedule]()
            sends = sum(len(pipe_lib.messages(tab, P, v, s, t)[0])
                        for t in range(tab["fwd_c"].shape[1]))
            # the interleaved loss moves one chunk's rows each way, and
            # its gradient back
            sends += 2 if v > 1 else 0
            c = row["last_step"]
            check(c["pipe_send"]["calls"] == sends == c["pipe_recv"]["calls"]
                  and c["pipe_send"]["staged"] == sends
                  and c["tied_all_reduce"]["calls"] == 1,
                  f"pipe_ranks rank {r} {schedule}: messages {c}, "
                  f"expected {sends} each way")
            step_ms = row["step_ms"][-1]
            row["wait_ms"] = c["pipe_recv"]["seconds"] * 1e3
            row["wait_share"] = row["wait_ms"] / step_ms
            row["fill_drain_bubble_share"] = (P - 1) / (M + P - 1)
            row["send_ms"] = c["pipe_send"]["seconds"] * 1e3
            row["tied_ms"] = c["tied_all_reduce"]["seconds"] * 1e3
            row["tied_bytes"] = c["tied_all_reduce"]["bytes"]
            row["peak_vs_gpipe"] = row["peak_over_held_gib"] / rows[
                "gpipe"]["peak_over_held_gib"]
            for k, n in row["launches"].items():
                total[k] = total.get(k, 0) + n
    emit(dict(phase="pipe_ranks", backend="gloo", world=P, device="cuda:0",
              model="gpt2-1.5b", layers=PIPE_LAYERS, layers_per_stage=
              PIPE_LAYERS // P, batch=[PIPE_ROWS, PIPE_SEQ],
              microbatches=M, dtype="bfloat16", masters="float32",
              steps=PIPE_STEPS, schedules=[s for s, _ in PIPE_SCHEDULES],
              one_rank=one, ranks=ranks,
              note="the sends, receives and the tied all-reduce are gloo "
                   "through pinned host buffers, both ranks on one card: "
                   "not NCCL over NVLink"))
    return total


def tp_kernel_cases(torch, F, flash, paged, gpt, int8mm):
    """The kernels at one model rank's llama-7b shapes (degree 2): K1-fwd
    and K2 at the training shape (4 x 1,024, 16 heads), K3 and K3-int8 at
    the decode shape (16 kv heads), K4 at the four shard projections at
    M = 8 and their layer sum. Returns the rows by name."""
    bf16 = torch.bfloat16
    rows = {"K1-fwd@tp": flash_case(torch, F, flash,
                                    "llama-7b train, one rank of 2", 4,
                                    1024, 16, 16, 128, bf16)}
    rows["K2-dq@tp"], rows["K2-dkv@tp"] = flash_bwd_case(
        torch, F, flash, "llama-7b train, one rank of 2", 4, 1024, 16, 16,
        128, bf16)
    for int8 in (False, True):
        rows["K3-int8@tp" if int8 else "K3@tp"] = paged_case(
            torch, F, paged, gpt, "llama-7b decode, one rank of 2", 8, 16, 1,
            128, 16, SPREAD, bf16, int8=int8)
    k4 = {}
    for pname, K, N in TP_PROJ:
        k4[8, pname] = int8mm_case(torch, int8mm, f"llama-7b {pname} shard "
                                   f"of 2, M=8", 8, K, N, bf16)
    rows["K4@tp"] = k4_layer_row(k4, 8, "llama-7b layer, one rank of 2")
    return rows


def width_cases(torch, F, flash, paged, gpt):
    """K1-fwd, K2-dq, K2-dkv and K3 at the head dims the presets add to 64
    and 128 (each its own build; 72 in 80-wide tensor-core tiles), in bf16
    at the main paths' shapes: gpt2-4b's training step (32 heads of 72),
    gpt2-8b's prefill, decode and verify (32 heads of 96), llama-tiny's GQA
    (8 heads of 32 over 4), and the masks, fp16 and float32 beside them;
    then K3's int8-pool mode with a float16 q at the llama-7b decode and
    verify shapes. Returns the rows the kernel summary takes."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    rows = {
        "K1-fwd@72": flash_case(torch, F, flash, "gpt2-4b train", 16, 1024,
                                32, 32, 72, bf16, iters=10),
        "K1-fwd@96": flash_case(torch, F, flash, "gpt2-8b prefill", 4, 512,
                                32, 32, 96, bf16)}
    rows["K2-dq@72"], rows["K2-dkv@72"] = flash_bwd_case(
        torch, F, flash, "gpt2-4b train", 16, 1024, 32, 32, 72, bf16)
    flash_case(torch, F, flash, "llama-tiny GQA, 4 segments", 8, 256, 8, 4,
               32, bf16, n_seg=4)
    flash_case(torch, F, flash, "head dim 72, left-pad kv_mask, float16", 4,
               512, 32, 32, 72, f16, pad=[0, 17, 200, 511])
    flash_case(torch, F, flash, "head dim 96, window", 2, 1024, 32, 32, 96,
               bf16, window=256)
    flash_case(torch, F, flash, "head dim 72, GQA, segments, float32", 2, 300,
               8, 2, 72, f32, n_seg=3, iters=5)
    flash_bwd_case(torch, F, flash, "gpt2-8b width", 2, 1024, 32, 32, 96,
                   bf16)
    flash_bwd_case(torch, F, flash, "llama-tiny GQA, segments", 4, 256, 8, 4,
                   32, bf16, n_seg=3)
    flash_bwd_case(torch, F, flash, "head dim 72, ragged S, window, float32",
                   2, 300, 8, 2, 72, f32, window=100, iters=5)
    for int8 in (False, True):
        tag = "-int8" if int8 else ""
        rows[f"K3{tag}@96"] = paged_case(
            torch, F, paged, gpt, "gpt2-8b decode", 8, 32, 1, 96, 16, SPREAD,
            bf16, int8=int8)
        rows[f"K3{tag}-verify@96"] = paged_case(
            torch, F, paged, gpt, "gpt2-8b verify, 8 slots, q_len 5", 8, 32,
            1, 96, 16, VERIFY_LENS, bf16, q_len=5, int8=int8)
        paged_case(torch, F, paged, gpt, "gpt2-4b decode", 8, 32, 1, 72, 16,
                   SPREAD, bf16, int8=int8)
        paged_case(torch, F, paged, gpt, "head dim 72, verify q_len 4, "
                   "group 2", 8, 16, 2, 72, 16, [x - 4 for x in SPREAD[1:]]
                   + [2044], f16, q_len=4, int8=int8)
        paged_case(torch, F, paged, gpt, "llama-tiny GQA verify, q_len 5", 8,
                   4, 2, 32, 16, VERIFY_LENS, bf16, q_len=5, int8=int8,
                   window=300)
        paged_case(torch, F, paged, gpt, "head dim 96, float32", 4, 8, 2, 96,
                   16, [3, 700, 1500, 2047], f32, int8=int8)
    # the int8-pool mode with a float16 q: decode on the CUDA cores, verify
    # on the tensor cores with the codes exact in fp16
    rows["K3-int8-fp16"] = paged_case(
        torch, F, paged, gpt, "llama-7b decode, float16 q", 8, 32, 1, 128,
        16, SPREAD, f16, int8=True)
    rows["K3-int8-fp16-verify"] = paged_case(
        torch, F, paged, gpt, "llama-7b verify, 8 slots, q_len 5, float16 q",
        8, 32, 1, 128, 16, VERIFY_LENS, f16, q_len=5, int8=True)
    return rows


def bs_ab_cases(torch, F, sa):
    """K5 at the sparse path's shape (the fixed layout, bidirectional and
    unidirectional) and at BigBird's (S = 2048, global rows), bf16: the
    rows ``--ab`` times."""
    bf16 = torch.bfloat16
    fixed = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
             "num_global_blocks": 1, "attention": "bidirectional"}
    return [
        bs_case(torch, F, sa, "bert-large sparse, fixed bidirectional",
                fixed, 4, 4096, 16, 64, bf16),
        bs_case(torch, F, sa, "fixed unidirectional",
                dict(fixed, attention="unidirectional"), 4, 4096, 16, 64,
                bf16),
        bs_case(torch, F, sa, "bigbird", {"mode": "bigbird", "block": 16,
                                          "num_random_blocks": 1}, 2, 2048,
                16, 64, bf16)]


SPREAD = [5, 16, 100, 511, 1024, 1535, 1600, 2047]   # partial/mid/full
# K4's llama-7b projections (qkv, attn_out, mlp_in = mlp_gate, mlp_out)
PROJ = (("qkv", 4096, 12288), ("attn_out", 4096, 4096),
        ("mlp_in", 4096, 11008), ("mlp_out", 11008, 4096))
LAYER = ("qkv", "attn_out", "mlp_in", "mlp_in", "mlp_out")


def k4_layer_row(k4, M, what="llama-7b layer"):
    """One llama-7b layer of K4 at M rows: the five launches of a block
    (mlp_gate has mlp_in's shape), summed, as a ``kernel`` row."""
    layer = [k4[M, n] for n in LAYER]
    row = dict(phase="kernel", kernel="K4",
               case=f"{what} (qkv, attn_out, mlp_in, mlp_gate, "
                    f"mlp_out), M={M}", dtype="bfloat16",
               bound_by=layer[0]["bound_by"], timed_by="graph",
               library_timed_by="graph",
               **{k: sum(r[k] for r in layer) for k in (
                   "kernel_ms", "plain_ms", "library_ms", "bound_us")})
    row["max_abs_err"] = max(r["max_abs_err"] for r in layer)
    flops = sum(2.0 * M * r["shape"]["K"] * r["shape"]["N"] for r in layer)
    row.update(tflops=flops / row["kernel_ms"] / 1e9,
               vs_library=row["kernel_ms"] / row["library_ms"])
    emit(row)
    return row


# the spec path's verify: spec_k 4, so q_len 5, and each slot's length
# five below the decode shape's next one
VERIFY_LENS = [x - 5 for x in SPREAD[1:]] + [2043]


def decode_ab_cases(torch, F, paged, gpt, int8mm):
    """K3 and K3-int8 at the llama-7b decode shape (8 slots of lengths
    5-2047, 32 heads of 128, block 16, bf16) and in their verify modes at
    the spec path's shape (q_len 5, group 1, lengths 11-2043), then K4 at
    the llama-7b projections at M = 8 (decode slots), 1 and 256 (a
    prefill chunk), and the M = 8 and M = 256 layers summed: the rows the
    main run and ``--ab`` both time, in this order."""
    bf16 = torch.bfloat16
    k3 = paged_case(torch, F, paged, gpt, "llama-7b decode", 8, 32, 1, 128,
                    16, SPREAD, bf16)
    k3_int8 = paged_case(torch, F, paged, gpt, "llama-7b decode", 8, 32, 1,
                         128, 16, SPREAD, bf16, int8=True)
    k3v, k3v_int8 = (paged_case(
        torch, F, paged, gpt, "llama-7b verify, 8 slots, q_len 5", 8, 32, 1,
        128, 16, VERIFY_LENS, bf16, q_len=5, int8=q) for q in (False, True))
    k4 = {}
    for M in (8, 1, 256):
        for pname, K, N in PROJ:
            k4[M, pname] = int8mm_case(torch, int8mm,
                                       f"llama-7b {pname}, M={M}", M, K, N,
                                       bf16)
    return (k3, k3_int8, k3v, k3v_int8, k4, k4_layer_row(k4, 8),
            k4_layer_row(k4, 256))


def ab_run(tree):
    """One side of ``--ab``: ``flash_main_cases``, ``decode_ab_cases`` and
    ``bs_ab_cases`` of this script (its cases, checks and timers) on the
    kernels of the checkout at ``tree``, built into that checkout's own
    ``build/``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import int8_matmul as int8mm
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.attention import flash, paged
    for mod in (flash, sa, paged, int8mm):
        check(mod.__file__.startswith(tree + os.sep),
              f"--ab: imported {mod.__file__}, not the checkout at {tree}")
    info = _build.build(["flash_fwd", "flash_bwd", "blocksparse_fwd",
                         "paged_decode", "int8_matmul"])
    emit(dict(phase="env", tree=tree, gpu=gpu_line(),
              build={n: ptxas_summary(i["ptxas"]) for n, i in info.items()}))
    flash_main_cases(torch, F, flash)
    decode_ab_cases(torch, F, paged, gpt, int8mm)
    bs_ab_cases(torch, F, sa)
    return 0


def ab_main(other):
    """Times K1-fwd, K2, K3, K3-int8, K4 and K5 at the main paths' shapes
    on the kernels of the checkout at ``other`` (A) and of this one (B), in
    turns A B B A, each in a process of its own, all through this script's
    cases and timers, so that the two sides differ only in their kernels.
    Prints each run's lines, then one line per row: both sides' times, the
    timer of each run and B / A."""
    runs = []
    for tree in (other, REPO, REPO, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-run", tree], capture_output=True,
                             text=True, timeout=1200)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append([json.loads(line) for line in out.stdout.splitlines()
                     if line.startswith('{"phase": "kernel"')])
    for a1, b1, b2, a2 in zip(*runs):
        a_ms = [a1["kernel_ms"], a2["kernel_ms"]]
        b_ms = [b1["kernel_ms"], b2["kernel_ms"]]
        emit(dict(phase="ab", kernel=a1["kernel"], case=a1["case"],
                  a=os.path.abspath(other), a_design=a1.get("design"),
                  b_design=b1.get("design"), a_ms=a_ms, b_ms=b_ms,
                  timed_by=[r.get("timed_by") for r in (a1, b1, b2, a2)],
                  library_ms=[r["library_ms"] for r in (a1, b1, b2, a2)],
                  b_over_a=sum(b_ms) / sum(a_ms)))
    print(gpu_line(), flush=True)
    return 0


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(deepspeed_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from deepspeed_tpu_torch import init_inference, initialize, telemetry, tree
    from deepspeed_tpu_torch.inference import autoscale as autoscale_lib
    from deepspeed_tpu_torch.inference import router as router_lib
    from deepspeed_tpu_torch.inference import serving, speculative
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models import gpt
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops import int8_matmul as int8mm
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.attention import flash, paged
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt
    from deepspeed_tpu_torch.runtime import dataloader
    from deepspeed_tpu_torch.runtime import lora as lora_lib
    from deepspeed_tpu_torch.runtime import progressive_layer_drop as pld_lib
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.dataloader import pack_documents
    from deepspeed_tpu_torch.tools import load_gen
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel import mesh as mesh_lib
    from deepspeed_tpu_torch.utils import distributed as dist_lib
    from deepspeed_tpu_torch.utils import faults as faults_lib
    from deepspeed_tpu_torch.utils import timer

    t_start = time.perf_counter()
    card = gpu_line()
    # every library up front, the ring modes' at llama-7b's head dim with
    # them (one nvcc each, all started together)
    info = _build._build([*_build._libraries(_build.SIGNATURES),
                          *_build.ring_libraries([RING_D])])
    emit(dict(phase="env", gpu=card, torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              device_count=torch.cuda.device_count(),
              build={n: dict(seconds=i["seconds"],
                             kernels=ptxas_summary(i["ptxas"]))
                     for n, i in info.items()}))
    # every instance ptxas must build without a spill, by library (a
    # cached build has no report to read): the tensor-core K1-fwd and K2-dq
    # at every head dim, K5's at 64 and 128; K3's CUDA-core kernel by q
    # dtype, pool type, head dim and row capacity, its tensor-core verify
    # kernel by head dim and m16 tiles, its combine; K4's wgmma kernel by
    # rows of x per CTA
    lib = _build.library
    want = {"blocksparse_fwd": [f"blocksparse_fwd_mma_kernel<bf16,{d}"
                                for d in (64, 128)],
            "int8_matmul": ["i8mm_dec_kernel", "i8mm_wg_kernel<128>",
                            "i8mm_wg_kernel<256>"]}
    for d in _build.HEAD_DIMS:
        want[lib("flash_fwd", d)] = [f"flash_fwd_mma_kernel<bf16,{d}"]
        want[lib("flash_bwd", d)] = [f"flash_bwd_dq_mma_kernel<bf16,{d}"]
        want[lib("paged_decode", d)] = [
            f"paged_split_kernel<{t},{k},{d},{rt}>"
            for t, k in (("f32", "f32"), ("f32", "int8"), ("bf16", "bf16"),
                         ("bf16", "int8"), ("f16", "f16"), ("f16", "int8"))
            for rt in (1, 4, 16)] + [
            f"paged_verify_mma_kernel<{t},{k},{d},{mt}>"
            for t, k in (("bf16", "bf16"), ("f16", "f16"), ("bf16", "int8"),
                         ("f16", "int8")) for mt in paged.MMA_TILES[d]] + [
            f"paged_combine_kernel<{t},{d}>" for t in ("f32", "bf16", "f16")]
    want[lib("flash_fwd", RING_D, False, True)] = [
        f"flash_fwd_mma_kernel<bf16,{RING_D}"]
    want[lib("flash_bwd", RING_D, False, True)] = [
        f"flash_bwd_dq_mma_kernel<bf16,{RING_D}"]
    for name, kernels in want.items():
        if info[name]["ptxas"] == "(cached)":
            continue
        report = ptxas_summary(info[name]["ptxas"])
        for k in kernels:   # a name ending in "," or "<d" is a prefix
            found = {n: r for n, r in report.items()
                     if n == k or (not k.endswith(">") and n.startswith(k))}
            check(found and all(r.get("spill_bytes", 0) == 0
                                for r in found.values()),
                  f"{name}: {k} missing or spilling in ptxas's report: "
                  f"{found}")

    bf16, f32 = torch.bfloat16, torch.float32
    main_rows = flash_main_cases(torch, F, flash)
    width_rows = width_cases(torch, F, flash, paged, gpt)
    k1, k1_train, k1_bert = (main_rows[k] for k in ("llama", "gpt2", "bert"))
    k2_dq, k2_dkv = main_rows["gpt2 bwd"]
    k2_bert = main_rows["bert bwd"]
    flash_case(torch, F, flash, "llama-7b prefill, 2 segments", 4, 512, 32, 32,
               128, bf16, n_seg=2)
    flash_case(torch, F, flash, "gqa", 4, 512, 32, 8, 128, bf16)
    flash_case(torch, F, flash, "left-pad kv_mask", 4, 512, 32, 32, 128,
               bf16, pad=[0, 17, 200, 511])
    flash_case(torch, F, flash, "window", 2, 1024, 32, 32, 128, bf16,
               window=256)
    flash_case(torch, F, flash, "head_dim 64", 4, 512, 16, 16, 64, bf16)
    flash_case(torch, F, flash, "float32", 1, 512, 32, 32, 128, f32, iters=5)
    flash_case(torch, F, flash, "gpt2-1.5b train, 4 segments", 16, 1024, 25,
               25, 64, bf16, n_seg=4, iters=10)
    flash_case(torch, F, flash, "segments, GQA, window, float32", 2, 300, 8,
               2, 64, f32, window=100, n_seg=3, iters=5)
    flash_bwd_case(torch, F, flash, "gpt2-1.5b train, 4 segments", 16, 1024,
                   25, 25, 64, bf16, n_seg=4)
    flash_bwd_case(torch, F, flash, "gqa", 2, 2048, 32, 8, 128, bf16)
    flash_bwd_case(torch, F, flash, "window", 2, 2048, 32, 32, 128, bf16,
                   window=256)
    flash_bwd_case(torch, F, flash, "left-pad kv_mask", 4, 512, 32, 32, 128,
                   bf16, pad=[0, 17, 200, 511])
    flash_bwd_case(torch, F, flash, "float32, ragged S, segments", 2, 500, 8,
                   4, 64, f32, n_seg=3, iters=5)
    ring_hop0 = ring_kernel_cases(torch, F, flash, "llama-7b ring hop 0, "
                                  "causal", 0, None)
    ring_rows = ring_kernel_cases(torch, F, flash, "llama-7b ring hop 1, "
                                  "q_off 4096, window 1024", RING_S_LOC,
                                  RING_WINDOW)
    k3, k3_int8, k3v, k3v_int8, k4, k4_layer, k4_prefill = decode_ab_cases(
        torch, F, paged, gpt, int8mm)
    tp_rows = tp_kernel_cases(torch, F, flash, paged, gpt, int8mm)
    spread = SPREAD
    paged_case(torch, F, paged, gpt, "gqa", 8, 8, 4, 128, 16, spread, bf16)
    paged_case(torch, F, paged, gpt, "window", 8, 32, 1, 128, 16, spread,
               bf16, window=300)
    paged_case(torch, F, paged, gpt, "verify q_len=4", 8, 8, 4, 128, 16,
               [x - 4 for x in spread[1:]] + [2044], bf16, q_len=4)
    paged_case(torch, F, paged, gpt, "float32 head_dim 64", 4, 8, 2, 64, 16,
               [3, 700, 1500, 2047], f32)
    paged_case(torch, F, paged, gpt, "gqa", 8, 8, 4, 128, 16, spread, bf16,
               int8=True)
    paged_case(torch, F, paged, gpt, "window", 8, 32, 1, 128, 16, spread,
               bf16, window=300, int8=True)
    paged_case(torch, F, paged, gpt, "verify q_len=4", 8, 8, 4, 128, 16,
               [x - 4 for x in spread[1:]] + [2044], bf16, q_len=4, int8=True)
    paged_case(torch, F, paged, gpt, "float32 head_dim 64", 4, 8, 2, 64, 16,
               [3, 700, 1500, 2047], f32, int8=True)
    # the tensor-core verify tier at GQA verify (group 8 x q_len 5 = 40
    # rows: one CTA of four m16 tiles at head dim 64, two passes of 32
    # rows at 128), in both pool modes
    for D in (64, 128):
        for q in (False, True):
            paged_case(torch, F, paged, gpt, "gqa verify, group 8, q_len 5",
                       8, 4, 8, D, 16, VERIFY_LENS, bf16, q_len=5, int8=q,
                       window=None if D == 64 else 300)
    # K3's float16 mode (float16 pools) at the decode shape, and its verify
    # mode at the spec path's shape
    f16 = torch.float16
    k3_fp16 = paged_case(torch, F, paged, gpt, "llama-7b decode", 8, 32, 1,
                         128, 16, SPREAD, f16)
    k3v_fp16 = paged_case(torch, F, paged, gpt,
                          "llama-7b verify, 8 slots, q_len 5", 8, 32, 1, 128,
                          16, VERIFY_LENS, f16, q_len=5)
    int8mm_case(torch, int8mm, "llama-7b qkv, M=8, float32", 8, 4096, 12288,
                f32, iters=10)
    int8mm_case(torch, int8mm, "ragged M=37 K=1000 N=1000", 37, 1000, 1000,
                bf16)
    int8mm_case(torch, int8mm, "generate prompt, qkv M=2048", 2048, 4096,
                12288, bf16, iters=10)
    # K5 at the sparse path's shape (bert-large attention, the JAX and
    # reference default fixed layout, S = 4096), its causal mode, the other
    # layout families (at S <= 2048: BigBird's and BSLongformer's global
    # rows attend every block, and the gather version's temporaries grow
    # with the longest row), blocks 16 and 64, head dims 32, 64 and 128,
    # bf16 and float32
    fixed = {"mode": "fixed", "block": 16, "num_local_blocks": 4,
             "num_global_blocks": 1, "attention": "bidirectional"}
    k5, k5_uni, k5_bigbird = bs_ab_cases(torch, F, sa)
    bs_case(torch, F, sa, "bslongformer", {"mode": "bslongformer",
                                           "block": 16}, 2, 2048, 16, 64,
            bf16)
    bs_case(torch, F, sa, "variable", {
        "mode": "variable", "block": 16, "num_random_blocks": 2,
        "local_window_blocks": [4], "global_block_indices": [0]}, 2, 2048,
        16, 64, bf16)
    bs_case(torch, F, sa, "fixed, block 64, head dim 128",
            dict(fixed, block=64), 2, 2048, 8, 128, bf16)
    bs_case(torch, F, sa, "fixed unidirectional, head dim 32, float32",
            dict(fixed, attention="unidirectional"), 2, 1024, 8, 32, f32)
    bs_case(torch, F, sa, "variable unidirectional, block 64, float32", {
        "mode": "variable", "block": 64, "num_random_blocks": 1,
        "attention": "unidirectional"}, 1, 1024, 4, 64, f32)

    launches, eng, serve_reqs, serve_base = serve_phase(
        torch, flash, paged, gpt, init_inference, serving)
    exports = lora_exports(eng)
    lora_launches = lora_phase(
        torch, flash, paged, serving, eng, exports, serve_base, "lora",
        ratios={aid: delta_ratios(torch, eng, sd)
                for aid, sd in exports.items()})
    del serve_base
    horizon_launches = horizon_phase(torch, flash, paged, serving, eng,
                                     serve_reqs)
    prefix_phase(torch, flash, paged, serving, eng)
    tier_launches = host_tier_phase(torch, flash, paged, serving, eng)
    spec_launches = spec_phase(torch, flash, paged, gpt, init_inference,
                               serving, eng)
    chaos_launches = chaos_phase(torch, flash, paged, serving, eng,
                                 serve_reqs)
    router_launches = router_phase(torch, flash, paged, serving, router_lib,
                                   faults_lib, eng, serve_reqs)
    router_lora_phase(torch, flash, paged, serving, router_lib, eng, exports,
                      serve_reqs)
    disagg_launches = disagg_phase(torch, flash, paged, serving, router_lib,
                                   faults_lib, eng, serve_reqs, "disagg")
    autoscale_launches = autoscale_phase(
        torch, flash, paged, serving, router_lib, autoscale_lib, load_gen,
        telemetry, eng)
    del eng
    gc.collect()          # serving engines hold cycles (see chaos_run)
    torch.cuda.empty_cache()
    agreement_phase(torch, gpt, init_inference, serving)
    fp16_launches = serve_fp16_phase(torch, flash, paged, gpt,
                                     init_inference, serving, tree)
    serve_8b_launches = serve_8b_phase(torch, flash, paged, gpt,
                                       init_inference, serving)
    int8_launches, eng, serve_reqs, int8_base = serve_int8_phase(
        torch, flash, paged, gpt, init_inference, serving)
    lora_int8_launches = lora_phase(
        torch, flash, paged, serving, eng,
        cut_exports(exports, eng.cfg.n_layers), int8_base, "lora_int8",
        kv_quant="int8")
    del int8_base
    horizon_int8_launches = horizon_int8_phase(torch, flash, paged, serving,
                                               eng, serve_reqs)
    tier_int8_launches = host_tier_phase(torch, flash, paged, serving, eng,
                                         kv_quant="int8")
    spec_int8_launches = spec_int8_phase(torch, flash, paged, serving, eng)
    chaos_int8_phase(torch, flash, paged, serving, eng, serve_reqs)
    disagg_int8_launches = disagg_phase(
        torch, flash, paged, serving, router_lib, faults_lib, eng,
        serve_reqs, "disagg_int8", kv_quant="int8")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    cfg2, params2 = parity_params(torch, gpt)
    parity_phase(torch, gpt, InferenceEngine, cfg2, params2)
    parity_int8_phase(torch, gpt, InferenceEngine, cfg2, params2)
    spec_parity_phase(torch, paged, gpt, InferenceEngine, serving,
                      speculative, cfg2, params2)
    lora_parity_launches = lora_parity_phase(
        torch, flash, paged, InferenceEngine, serving, lora_lib, faults_lib,
        cfg2, params2, exports)
    router_parity_launches = router_parity_phase(
        torch, flash, paged, InferenceEngine, serving, router_lib, faults_lib,
        cfg2, params2)
    del params2, exports
    train_launches = train_phase(torch, flash, paged, gpt, initialize,
                                 pack_documents)
    remat_phase(torch, gpt, initialize, tree)
    train_parity_phase(torch, gpt, initialize, pack_documents, tree)
    train_4b_launches = train_4b_phase(torch, flash, paged, gpt, initialize,
                                       tree)
    resume_launches = resume_phase(torch, flash, paged, gpt, initialize,
                                   init_inference, serving, tree, ckpt)
    features_launches = train_features_phase(
        torch, flash, paged, gpt, initialize, dataloader, pld_lib)
    host_sync_phase(torch, gpt, initialize, timer)
    sparse_launches = sparse_phase(torch, flash, paged, sa, DeepSpeedConfig)
    bert_launches = bert_phase(torch, flash, paged, bert, initialize)
    bert_parity_phase(torch, bert, tree)
    bert_infer_launches = bert_infer_phase(torch, flash, paged, bert,
                                           init_inference, tree)
    bf16_parity_phase(torch, flash, paged, gpt, bert, tree)
    zero_launches, zero_refs = zero_phase(torch, flash, paged, gpt,
                                          initialize, dist_lib, mesh_lib,
                                          comm)
    (ring_ranks_launches, zero_ranks_launches, tp_launches,
     pipe_launches) = ring_ranks_phase(
        torch, gpt, initialize, pack_documents, dataloader.zigzag_batch,
        serving, init_inference, zero_refs)

    # every kernel at the shape of the path that drives it: K1-fwd and K2
    # at the gpt2-1.5b training shape with the training run's launch
    # counts (their BERT shape and count ride along), K3 at the llama-7b
    # decode shape with the serving drain's, K4 (one decode layer; the
    # prefill chunk's layer rides along) and K3-int8 with the int8
    # drain's, K5 at the sparse path's shape with its two passes' count;
    # K1-fwd's serving shape and its count in generate ride along
    fwd_src = "deepspeed_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "deepspeed_tpu_torch/csrc/flash_bwd.cu"
    jflash = "deepspeed_tpu/ops/attention/flash.py"
    kernels = []
    for row, src, rep, n in (
            (k1_train, fwd_src, f"{jflash}:142", train_launches["K1-fwd"]),
            (k2_dq, bwd_src, f"{jflash}:380", train_launches["K2-dq"]),
            (k2_dkv, bwd_src, f"{jflash}:317", train_launches["K2-dkv"]),
            (k3, "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139", launches["K3"]),
            (k4_layer, "deepspeed_tpu_torch/csrc/int8_matmul.cu",
             "deepspeed_tpu/ops/int8_matmul.py:33", int8_launches["K4"]),
            (k3_int8, "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139",
             int8_launches["K3-int8"]),
            (k5, "deepspeed_tpu_torch/csrc/blocksparse_fwd.cu",
             "deepspeed_tpu/ops/sparse_attention/blocksparse.py:148",
             sparse_launches["K5"])):
        check(n > 0, f"{row['kernel']} was never launched on its path")
        kernels.append(dict(
            name=row["kernel"], route="cuda", source=src, replaces=rep,
            launches=n, max_abs_err=row["max_abs_err"],
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_us"] / 1e3, bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["case"]))
        kernels[-1].update(timed_by=row["timed_by"],
                           vs_library=row["vs_library"])
        if "design" in row:     # K1-fwd, K2, K3 and K5: the design that ran
            kernels[-1].update(design=row["design"])
        if "tflops" in row:     # K1-fwd, K2, K4 and K5
            kernels[-1].update(tflops=row["tflops"])
        if "gb_per_s" in row:   # K3 and K3-int8
            kernels[-1].update(gb_per_s=row["gb_per_s"])
    # the slice-5 paths: training with the curriculum and layer drop, and
    # serving from the resumed checkpoint
    for i, name in enumerate(("K1-fwd", "K2-dq", "K2-dkv")):
        kernels[i].update(launches_in_train_features=features_launches[name])
    kernels[0].update(launches_serving_from_checkpoint=resume_launches[
        "K1-fwd"])
    kernels[3].update(launches_serving_from_checkpoint=resume_launches["K3"])
    # the slice-9 path: the fault-free and the retried chaos drains
    kernels[3].update(launches_in_chaos=chaos_launches)
    kernels[0].update(launches_in_generate=launches["K1-fwd"],
                      serving_shape=k1["case"], serving_ms=k1["kernel_ms"],
                      serving_bound_ms=k1["bound_us"] / 1e3,
                      serving_plain_ms=k1["plain_ms"],
                      serving_library_ms=k1["library_ms"],
                      serving_tflops=k1["tflops"],
                      serving_vs_library=k1["vs_library"],
                      serving_timed_by=k1["timed_by"])
    for i, (name, row) in enumerate(zip(("K1-fwd", "K2-dq", "K2-dkv"),
                                        (k1_bert, *k2_bert))):
        check(bert_launches[name] > 0, f"{name} was never launched on the "
              f"BERT path")
        kernels[i].update(launches_in_bert=bert_launches[name],
                          bert_shape=row["case"],
                          bert_max_abs_err=row["max_abs_err"],
                          bert_ms=row["kernel_ms"],
                          bert_bound_ms=row["bound_us"] / 1e3,
                          bert_bound_by=row["bound_by"],
                          bert_plain_ms=row["plain_ms"],
                          bert_library_ms=row["library_ms"],
                          bert_tflops=row["tflops"],
                          bert_vs_library=row["vs_library"])
    # K4: the prefill chunk's layer (M = 256) beside the decode layer
    kernels[4].update(launches_in_generate=int8_launches["K4-generate"],
                      tflops=k4_layer["tflops"],
                      prefill_shape=k4_prefill["case"],
                      prefill_max_abs_err=k4_prefill["max_abs_err"],
                      prefill_ms=k4_prefill["kernel_ms"],
                      prefill_plain_ms=k4_prefill["plain_ms"],
                      prefill_library_ms=k4_prefill["library_ms"],
                      prefill_bound_ms=k4_prefill["bound_us"] / 1e3,
                      prefill_bound_by=k4_prefill["bound_by"],
                      prefill_tflops=k4_prefill["tflops"],
                      prefill_vs_library=k4_prefill["vs_library"])
    # K5: the work list of its main shape, and its causal and BigBird
    # shapes beside it
    kernels[6].update(split_groups=k5.get("split_groups"),
                      ctas_per_batch_row=k5.get("ctas_per_batch_row"))
    for tag, row in (("unidirectional", k5_uni), ("bigbird", k5_bigbird)):
        kernels[6].update({
            f"{tag}_shape": row["case"], f"{tag}_ms": row["kernel_ms"],
            f"{tag}_library_ms": row["library_ms"],
            f"{tag}_bound_ms": row["bound_us"] / 1e3,
            f"{tag}_tflops": row["tflops"],
            f"{tag}_vs_library": row["vs_library"],
            f"{tag}_split_groups": row.get("split_groups")})
    # the slice-6 paths: K1-fwd in the ModelDraft's generate, K4 in the
    # int8 spec drain, and K3's verify mode in both pool modes
    kernels[0].update(launches_in_model_draft=spec_launches["K1-fwd-draft"])
    kernels[4].update(launches_in_spec_int8=spec_int8_launches["K4-spec"])
    # the slice-7 paths: the decode horizon and the host tier's drains
    kernels[3].update(launches_in_horizon={
        n: horizon_launches[f"K3-N{n}"] for n in (1, 4)},
        launches_in_host_tier=tier_launches["K3"])
    kernels[5].update(launches_in_horizon_n4=horizon_int8_launches[
        "K3-int8-N4"], launches_in_host_tier=tier_int8_launches["K3-int8"])
    kernels[4].update(launches_in_horizon_n4=horizon_int8_launches["K4-N4"],
                      launches_in_host_tier=tier_int8_launches["K4"])
    for row, name, n in ((k3v, "K3-verify", spec_launches["K3-verify"]),
                         (k3v_int8, "K3-int8-verify",
                          spec_int8_launches["K3-int8-verify"])):
        check(n > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/paged_decode.cu",
            replaces="deepspeed_tpu/ops/attention/paged.py:139",
            launches=n, max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_us"] / 1e3,
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["case"], timed_by=row["timed_by"],
            vs_library=row["vs_library"], gb_per_s=row["gb_per_s"],
            design=row["design"]))
    # the slice-10 paths: LoRA serving at full width (K3; K3-int8 and K4
    # on the int8 engine), the unmerged tree's generate (K1-fwd) and
    # speculation under adapters (both verify modes) in float32
    kernels[0].update(launches_in_lora_generate=lora_parity_launches[
        "K1-fwd"])
    kernels[3].update(launches_in_lora=lora_launches["K3"])
    kernels[4].update(launches_in_lora_int8=lora_int8_launches["K4"])
    kernels[5].update(launches_in_lora_int8=lora_int8_launches["K3-int8"])
    kernels[7].update(launches_in_lora_parity=lora_parity_launches[
        "K3-verify"])
    kernels[8].update(launches_in_lora_parity=lora_parity_launches[
        "K3-int8-verify"])
    # the slice-11 paths: the router's fleet, the disaggregated fleet (K3;
    # K3-int8 and K4 on the int8 engine), the autoscaler's drive, and the
    # float32 fleets of router_parity
    kernels[3].update(launches_in_router=router_launches["K3"],
                      launches_in_disagg=disagg_launches["K3"],
                      launches_in_autoscale=autoscale_launches["K3"],
                      launches_in_router_parity=router_parity_launches["K3"])
    kernels[4].update(launches_in_disagg=disagg_int8_launches["K4"])
    kernels[5].update(launches_in_disagg=disagg_int8_launches["K3-int8"],
                      launches_in_router_parity=router_parity_launches[
                          "K3-int8"])
    # the slice-8 path: K3's float16 mode in the float16 drain,
    # and its verify mode in the float16 spec drain
    for name, row in (("K3-fp16", k3_fp16), ("K3-fp16-verify", k3v_fp16)):
        check(fp16_launches[name] > 0, f"{name} was never launched on its "
              f"path")
        kernels.append(dict(
            name=name, route="cuda",
            source="deepspeed_tpu_torch/csrc/paged_decode.cu",
            replaces="deepspeed_tpu/ops/attention/paged.py:139",
            launches=fp16_launches[name], max_abs_err=row["max_abs_err"],
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_us"] / 1e3, bound_by=row["bound_by"],
            library_ms=row["library_ms"], shape=row["case"],
            timed_by=row["timed_by"], vs_library=row["vs_library"],
            gb_per_s=row["gb_per_s"], design=row["design"]))
    # the slice-13 paths: K1-fwd and K2 at head dim 72 (gpt2-4b's
    # training), K1-fwd and K3 at 96 in both pool modes and both K3 modes
    # (gpt2-8b's serving), K3's int8-pool modes with a float16 q
    # (serve_fp16), and the encoder's K1-fwd (bert_infer)
    kernels[0].update(launches_in_bert_infer=bert_infer_launches["K1-fwd"])
    for name, src, rep, n in (
            ("K1-fwd@72", fwd_src, f"{jflash}:142",
             train_4b_launches["K1-fwd"]),
            ("K2-dq@72", bwd_src, f"{jflash}:380", train_4b_launches["K2-dq"]),
            ("K2-dkv@72", bwd_src, f"{jflash}:317",
             train_4b_launches["K2-dkv"]),
            ("K1-fwd@96", fwd_src, f"{jflash}:142",
             serve_8b_launches["K1-fwd"]),
            *((k, "deepspeed_tpu_torch/csrc/paged_decode.cu",
               "deepspeed_tpu/ops/attention/paged.py:139", serve_8b_launches[
                   k.split("@")[0]])
              for k in ("K3@96", "K3-verify@96", "K3-int8@96",
                        "K3-int8-verify@96")),
            *((k, "deepspeed_tpu_torch/csrc/paged_decode.cu",
               "deepspeed_tpu/ops/attention/paged.py:139", fp16_launches[k])
              for k in ("K3-int8-fp16", "K3-int8-fp16-verify"))):
        row = width_rows[name]
        check(n > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_us"] / 1e3,
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["case"], dtype=row["dtype"], timed_by=row["timed_by"],
            vs_library=row["vs_library"], design=row["design"]))
    # the slice-14 paths: ZeRO stages 0-3 on one NCCL rank, and stages 2
    # and 3 on two gloo ranks sharing the card (summed over the ranks)
    for i, name in enumerate(("K1-fwd", "K2-dq", "K2-dkv")):
        kernels[i].update(launches_in_zero=zero_launches[name],
                          launches_in_zero_ranks=zero_ranks_launches[name])
    # the slice-15 path: the ring modes of K1-fwd, K2-dq and K2-dkv in the
    # two sequence ranks' steps (summed over the ranks and variants), at
    # the windowed hop (q_off 4096) with hop 0 beside it
    for row, hop0, src, rep in zip(
            ring_rows, ring_hop0, (fwd_src, bwd_src, bwd_src),
            (f"{jflash}:142", f"{jflash}:380", f"{jflash}:317")):
        name = row["kernel"]
        n = ring_ranks_launches[name]
        check(n > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_us"] / 1e3,
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["case"], dtype=row["dtype"], timed_by=row["timed_by"],
            vs_library=row["vs_library"], design=row["design"],
            tflops=row["tflops"], hop0_shape=hop0["case"],
            hop0_max_abs_err=hop0["max_abs_err"], hop0_ms=hop0["kernel_ms"],
            hop0_plain_ms=hop0["plain_ms"],
            hop0_library_ms=hop0["library_ms"],
            hop0_bound_ms=hop0["bound_us"] / 1e3,
            hop0_bound_by=hop0["bound_by"], hop0_tflops=hop0["tflops"],
            hop0_vs_library=hop0["vs_library"]))
    # the slice-16 path: tensor parallelism on two gloo ranks, each rank's
    # kernels at its shapes (16 of 32 heads, the shard projections):
    # launches summed over the ranks; the serving prefill's K1-fwd (its
    # generate) on K1-fwd's row
    kernels[0].update(launches_in_tp_generate=tp_launches["K1-fwd generate"])
    for i, name in ((0, "K1-fwd"), (1, "K2-dq"), (2, "K2-dkv"), (3, "K3"),
                    (4, "K4"), (5, "K3-int8")):
        kernels[i].update(launches_in_tp_ranks=tp_launches[f"{name}@tp"])
    for name, src, rep in (
            ("K1-fwd@tp", fwd_src, f"{jflash}:142"),
            ("K2-dq@tp", bwd_src, f"{jflash}:380"),
            ("K2-dkv@tp", bwd_src, f"{jflash}:317"),
            ("K3@tp", "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139"),
            ("K3-int8@tp", "deepspeed_tpu_torch/csrc/paged_decode.cu",
             "deepspeed_tpu/ops/attention/paged.py:139"),
            ("K4@tp", "deepspeed_tpu_torch/csrc/int8_matmul.cu",
             "deepspeed_tpu/ops/int8_matmul.py:33")):
        row, n = tp_rows[name], tp_launches[name]
        check(n > 0, f"{name} was never launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=row["max_abs_err"], ms=row["kernel_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_us"] / 1e3,
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["case"], dtype=row["dtype"], timed_by=row["timed_by"],
            vs_library=row["vs_library"]))
        for key in ("design", "tflops", "gb_per_s"):
            if key in row:
                kernels[-1][key] = row[key]
    # the slice-17 path: pipeline parallelism on two gloo ranks, each
    # stage's layers at the microbatch's shape (2 rows of 1,024, 25 heads
    # of 64): launches summed over the ranks and the three schedules
    for i, name in enumerate(("K1-fwd", "K2-dq", "K2-dkv")):
        check(pipe_launches[name] > 0, f"{name} was never launched on the "
              f"pipeline path")
        kernels[i].update(launches_in_pipe_ranks=pipe_launches[name])
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-run"] and len(sys.argv) == 3:
        sys.exit(ab_run(sys.argv[2]))
    if sys.argv[1:2] == ["--ring-rank"] and len(sys.argv) == 6:
        sys.exit(ring_rank_main(*sys.argv[2:]))
    if len(sys.argv) > 1:
        sys.exit("usage: python3 chip_smoke.py [--ab OTHER_CHECKOUT]")
    sys.exit(main())
