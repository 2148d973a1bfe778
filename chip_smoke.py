#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases
(any failure exits non-zero before the last line):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the twelve attention kernels and W1, the int8-weight product
   (``csrc/*.cu``), compile with nvcc for sm_90a, in parallel;
3. kernels: each kernel, at its main-path shapes (the nano tier's for the
   ragged decode, causal prefill and paged chunk kernels; the orin tier's
   for the ragged verify and the int8 ragged decode and verify kernels),
   is held against its plain PyTorch version on the same inputs (every
   output row within KERNEL_REL_TOL of the plain version in float32), and
   timed beside the plain version, one PyTorch library call computing the
   same function (SDPA on the gathered, dequantized K/V, timed here only)
   and the card's bound (bytes at 3.35 TB/s, operations at the bf16 rate
   of 989 TFLOP/s: the card's peaks from
   ``utils.roofline.chip_peaks``); all three as replayed CUDA graphs (device time), with
   the eager single call beside them; each is also checked at its other
   instantiations (head dim, block, group, verify width; the split-K
   verify, ragged decode (bf16 and int8), paged decode (bf16 and int8)
   and contiguous decode kernels also on tables and windows spanning
   several of their splits, with frontiers on and one key past a split
   boundary; the ragged decode also at the bench's orin tier (orin_8b's
   width, 4 slots over the whole context, frontiers on and one key past
   its own plan's split boundaries, a tile short outside the bound); the
   paged decode kernels also at windows of one block and of
   the whole table; the pool kernels, the causal prefill and the paged
   chunk also at head dim 16 and block 16, the tiny test presets'
   instances, the ragged decode, causal prefill and paged chunk at those
   presets' own shapes with a tile short outside the bound; the verify
   kernels timed
   at a short shape too; the bf16 contiguous chunk kernel on both of its
   routes, the split kernel for a few rows and the tensor-core kernel for
   wide chunks, at each side of the boundary between them; the causal
   prefill also at the orin tier's width and at 2048 rows, and against
   the paged chunk kernel, which is the same kernel with another tile
   source: a prompt's rows must get the same bits from the cold prefill
   and from a prefix hit's suffix); the dense windowed tick's paged
   decode kernels (bf16 at the nano tier's shape, int8 at the orin
   tier's, each through a column slice of the full table) and the
   contiguous-cache decode and chunk kernels of the sequential engines
   (bf16 and int8) likewise, at their serving shapes; W1
   (``ops.quant.w8_matmul``) at every projection shape of nano_1b and
   orin_8b for 1, 4, 8, 20, 40 and 64 rows (its decode regime) and 128,
   256, 512, 1024 and 2048 (its wide regime), single and grouped
   (q/k/v, gate/up: each output bit for bit its lone launch's), each row
   within KERNEL_REL_TOL of the plain version in float32, each launch's
   graph-replayed output bit for bit its eager one, each timed beside the
   cast route (cast, ``torch.matmul``, scale), cuBLAS bf16 on the
   unquantized weight and the bound, with one decode step's products
   summed per model and its W1 launches (``launches_per_step``), the
   step also replayed as one graph over distinct per-layer weights, both
   repeated within the run, and split launches that overlap on two
   streams (one replayed, one eager) each bit for bit the lone one's;
4. serve nano: the default nano tier (nano_1b at full width, seeded
   random weights) under EngineManager behind the /query server on
   127.0.0.1; cold, chunked, prefix-hit, concurrent and streaming
   requests go over HTTP;
5. serve orin, bf16 KV, with nano_1b drafting (batched speculation), and
6. serve orin, int8 KV, drafting with itself: orin_8b at full width and
   depth, the same requests plus a sampled one; 6b. ``orin_w8``: orin_8b
   with int8 weights and the nano_1b draft (int8 weights too), so the
   decode, verify and draft rows run through W1;
7. serve orin sequentially (``decode_batch=1``: InferenceEngine over the
   contiguous bf16 cache), 8. the same with the nano_1b draft
   (SpeculativeEngine), 9. nano_1b sequentially with the int8 cache and
   9b. ``nano_seq_w8``: nano_1b sequentially with int8 weights (W1 at one
   row), at full width and depth: a short prompt, one past the 2048 bucket, a
   multi-turn follow-up, 3 concurrent (serialized) requests, a stream
   and a sampled request (which the speculative tier refuses with the
   JAX package's 500 / 501), and on the plain engine a conversation
   that outgrows its cache rung (a 675-token turn, then a follow-up
   past the 1024 rung: the parked cache grows into the 8192 one).  Every
   prefill, suffix, chunk, grow, decode segment and speculative round
   replays a CUDA graph captured at warmup (JAX's warm set) or, for the
   grow copies JAX never warms, at first use; the admission audit
   watches these engines too.  ``seq_graph_check`` runs one decode
   segment (one round, speculating) through the replayed program and
   its body eagerly from the same live cache (tokens ``torch.equal``)
   and times both; ``copy_check`` holds and times the prefix cache's
   park and load copies of the 8192 rung; ``first_use_check`` serves a
   greedy request again with every program dropped, so its programs are
   captured mid-request as an engine without warmup captures them, and
   the tokens must equal the warmed programs'; ``loop_vs_round`` times
   the speculative engine's fused loop against its round program on one
   request; each phase reports its programs and capture seconds;
10. the two-tier ``/chat`` service: ``create_app`` over a production-mode
   Router (``BASE_CONFIG``) of nano_1b (8 slots, bf16 pool) and orin_8b
   (4 slots, int8 pool), both on the dense windowed tick, over HTTP;
   every routing strategy in turn sends a concurrent burst, a repeated
   query (a response-cache hit), follow-up turns and streams.  Then the
   obs layer over what was served: ``GET /metrics`` parses as Prometheus
   text and counts every request sent, and one TTFT for each that made a
   token; ``GET /debug/trace`` has one thread per tier, ticks in order;
   each tier's stamped phase self-time covers >= 0.95 of its ticks' wall;
   the requests' attributed device time is within 5% of each tier's
   decode self-time; ``GET /stats?debug=1`` carries the flight recorder,
   ``slo`` and ``cost``.  A per-kernel capture (``torch.profiler``) of
   orin's served ticks splits a tick into its GEMMs, its attention kernel
   and the rest, and nano's chunked prefill beside orin's ticks into its
   own kernels, orin's kernels inside it and host; the profiler's
   overhead is measured (tick p50 and wall per tick, on and off, back to
   back; reported, not gated); each tier's memory budget must equal its
   engine's weight and pool bytes, and orin's tier with half its
   footprint as ``hbm_gb_per_chip`` must be refused;
11. the bench: ``bench.headline.run`` in process over the bench cluster
   (nano_1b with 8 slots and orin_8b with 4, int8 weights, the ragged
   tick: one repeat of the five-strategy sweep with 4 closed-loop
   clients, the trend leg on the tiny tiers, the long-context and orin
   prefix probes, the batched nano engine with bf16 and int8 KV, the
   ``speculative`` and ``quant`` legs on the sequential engines, the
   ``flagship`` section and the ``spec_multiturn`` leg, the engine legs
   ``skew``, ``spec_phase``, ``mixed`` and ``shared``, the
   ``openloop`` leg and the fleet legs at the JAX bench's pinned
   configurations, the open-loop leg on a BENCH_OPENLOOP_S budget), then
   the
   canonical tester once (heuristic,
   cache off, general_knowledge).
   Every strategy must serve with no concurrent error, no section hold
   an error, every MFU and device-memory utilization lie in (0, 1.05],
   the trend leg run on the card, each batched tier time one decode
   phase per tick, the ragged decode (bf16 and int8), causal prefill and
   paged chunk kernels and W1 launch, no plain attention version run,
   the quant and speculative legs and both flagship tiers decode, the
   spec_multiturn leg report both follow-up TTFTs, and the tester's CSVs carry the JAX package's headers with one row per query
   and each serving tier's mean power draw (its energy columns
   integrate the card's draw) reads 10-1000 W.  Every strategy carries
   the trace-derived TTFT columns, counting every request it served, and
   the ``profile`` and ``spill`` sections (the tick profiler and the host
   spill tier on the tiny cluster) hold no error (the spill leg's outputs
   identical across budgets, its hit rate monotone, its race observed),
   the legs hold their invariants (one ragged decode program, the
   speculative programs within the γ-bucket family, shared peak blocks
   under 0.6 x exclusive, a knee) with outputs identical across each
   leg's modes or every flip a near-tie, and the dense decode and the
   verify kernels launch too;
12. the constrained pool (``pressure_phase``): nano_1b (8 slots, bf16
   pool, ragged tick) with ``kv_pool_blocks=96`` (of 1024 at full
   residency), then orin_8b with int8 weights, an int8 pool, 4 slots and
   the nano_1b draft with 36 (of 512), each over HTTP: 2 short prompts,
   then prompts of about 900 tokens at once, each with a 256-token
   budget, overrun the pool.  At least one preemption and one cancelled chunked
   prefill; every request answered, none truncated; each request's
   greedy tokens equal the same requests' on a full-residency engine, or
   first differ at a near-tie (``near_tie``: at the first differing
   position the two picks' logit gap, from a decode step on the state the
   engine's own chunked prefill rebuilds, within twice
   ``logits_check``'s tolerance);
   the phase's kernels launched and no plain attention version ran;
   ``tick_graph_check`` passes after the preemptions; every block free
   at the end.  Each replay's wall time is reported;
13. the host spill tier (``spill_chip_phase``): the bench's spill leg at
   full width, nano_1b with an 80-block pool, 16 sessions of about 1000
   tokens revisited with the spill OFF and at budgets of 4 and 32
   sessions: ``warm_hit_rate`` monotone, outputs identical across the
   three, the race sub-check's fallback observed, demotions and
   promotions at the large budget, K1-K3 launched; it prints the
   promoted revisits' TTFT beside the cold ones, the co-tenant's TBT p95
   ratio, the demote and promote counts and the host bytes held;
14. the trained tiny /chat (``trained_chat_phase``): the repo's trained
   nano_test and orin_test (``with_default_checkpoints(
   tiny_batched_cluster())``, head dim 16, 16-token blocks) behind
   ``create_app`` on the card over HTTP; each turn's greedy reply must
   equal the port's own on the CPU (float32 presets, the plain versions)
   or differ at a near-tie (``near_tie``, margin printed); the ragged
   decode, causal prefill and paged chunk kernels launch;
15. the bench's legs at full width (``legs_phase``): ``skew``, ``mixed``
   (its long prompt in the 1792 bucket) and ``shared`` on nano_1b,
   ``spec_phase`` on orin_8b with the nano_1b draft, ``openloop`` on the
   bench cluster; each leg's kernels launch (skew: the dense and ragged
   decode and the prefill; spec: the verify; mixed and shared: the paged
   chunk; openloop: W1), its invariants hold and its modes' outputs are
   identical or differ only at near-ties;
16. the fleet (``fleet_phase``), three main paths: (a) the bench cluster
   behind a Router with a ``FaultInjector`` and a fast breaker under the
   bench's chaos schedule (nano flaps 3 times, an orin latency spike), 4
   clients per strategy (heuristic, hybrid, perf): no client hangs or
   raises; availability, MTTR, p50 TTFT under faults, breaker openings and
   degraded answers reported; then a stream whose nano tier dies after
   its first delta fails over to orin mid-stream and replays its prefix;
   (b) nano_1b with ``replicas=2`` behind a Router whose HealthMonitor
   probes every FLEET_HEALTH_S: a prefix demoted to r0's host tier,
   greedy streams in flight on r0, ``crash_replica_engine`` on r0; every
   stream finishes with no error and no re-emitted delta, its tokens
   those of an uninterrupted run or first differing at a near-tie, the
   demoted prefix promotes warm on the restarted r0
   (``dllm_spill_reattach_total`` grows by 1), the dead engine is
   collected and the device memory after the restart is within
   FLEET_MEMORY_SLACK of before; it reports ``rescue_mttr_ms`` and the
   new engine's programs and capture seconds; (c) the bench's replica
   leg at nano_1b's width: one ragged decode program per replica,
   outputs identical across
   replica counts and policies or every flip a near-tie.  K1, K2 and K3
   launch in each part, W1 too in (a), and no plain attention runs.
   Phase 11's bench runs the same legs (and ``pressure`` and
   ``perf_steering``) at the JAX bench's pinned tiny configurations;
17. the fleet's second half (``fleet2_phase``), four main paths, each
   with its kernels launched and no plain attention: (a) the bench's
   noisy leg on the bench cluster: a flooding tenant (quota
   ``max_inflight=1, max_queued=0, weight=0.25`` on both tiers, long
   prompts, closed loop) beside a quiet one, quotas off and on; the
   quiet tenant's p95 solo and under flood, ``quiet_p95_ratio``,
   ``flood_shed_precision`` and the ``dllm_tenant_*`` samples printed;
   the sequential greedy probes through a quotas-off and a non-binding
   quotas-on engine ``torch.equal``; K1, K2, K3 and W1 launch; (b) the
   elastic leg on nano_1b (2 slots a replica, a host spill tier): the
   seeded diurnal ramp under static-min, static-max and autoscaled
   membership in [1, 2]; the scale events, goodput per replica-second
   (one card: a cost account, not added throughput) and the flap bound
   (no up-down-up inside a cooldown, at most 4 events); the handoff
   sub-check's answers identical across 2 -> 1 or flips at near-ties,
   and one ragged decode program in each replica, the one minted
   mid-flight included; (c) the chaos2 leg on nano_1b (2 replicas, the
   autoscaler armed, the HealthMonitor in the loop, a replica's loop
   killed twice mid-ramp): availability >= 0.99, no cross-tier
   failover, ``rescue_mttr_ms``, the rescue sub-check; (d) nano as a
   remote tier (``serving/remote.py``) whose ``spawn_cmd`` starts the
   port's ``gpu_api`` for nano_1b in a child process on the card, orin_8b
   local: readiness polled, ``/chat`` turns and one ``/chat/stream``
   routed to the child, each reply the in-process nano_1b's or a
   near-tie, the hop's overhead (client TTFT less the child's), the
   child killed, turns failing over to orin, the HealthMonitor's respawn
   serving again (spawn-to-ready and kill-to-serving seconds); the
   child is put down on every exit.  The bystander orin of (b) and (c)
   is a 2-slot nano_1b: those parts route nano's short queries only.
   Phase 11's bench runs the noisy, elastic and chaos2 legs at the JAX
   bench's pinned tiny configurations.
18. The edges (``edges``): (a) a reference-style program (the reduction
   of ``tests/test_compat.py`` and a reference-shaped Flask app over the
   port's ``utils/webapp.py`` registered as ``flask``) in a child process
   on the card, with ``reference_compat/`` first on ``PYTHONPATH`` and no
   prelude: three ``/chat`` turns of one session on the bench cluster,
   the second a prefix hit; a runner in the child prints its launch
   counts (W1, K1 and K2 must launch, K3 on the follow-up); (b) ``python
   -m distributed_llm_tpu_torch.serving.cli`` with three turns on stdin
   and ``exit``: it drains and exits 0; (c) ``python -m
   distributed_llm_tpu_torch`` on a free port: ``/health``, one
   ``/chat``, SIGTERM drains, exit 0; (d) the v1 tester
   (``bench/legacy_tester.py``) on the first 4 ``general_knowledge``
   queries at thresholds 100 and 1000 (its CSV header is ``HEADERS``,
   each tier that served a nonzero average power from the card's draw),
   the canonical tester on the same queries and ``bench/analysis.py``'s
   report over its CSVs; (e) the C++ featurizer and BPE loop against
   their Python twins on every query of the query sets (bit-identical
   features, identical ids, host microseconds per query); (f) the
   encoder's training on the card (200 steps, written under ``build/``)
   and its evaluation beside the committed weights'; (g) ``bench.tune``'s
   table derived from phase 11's headline (printed, not written); (h)
   ``bench.ab_kernels`` micro on nano_1b over a short ladder (uncounted:
   it compares kernels with their plain versions).  The phase's launches
   are the parent's (d) and the child's (a).
19. MoE (``moe``): moe_8x1b (8 experts of nano_1b's width, 16 layers,
   about 6.6 B parameters) at ``ep = 1`` on the default nano tier's
   fields; its memory budget first (every part must fit the card), then
   the tier behind its /query server four ways, each a serve phase with
   its requests, kernels, admission audit and checks: the batched engine
   on the ragged tick with a bf16 pool, with an int8 pool, the
   sequential engine (bf16 cache) and int8 weights (W1 per expert up to
   64 rows).  The logits checks keep the kernels' run's experts in all
   three runs (``pinned_routes``): a router choice the other runs would
   make differently must be a near-tie (its log-probability gap within
   twice the router's drift between the runs);
20. training (``train``): (a) K2 under autograd (``FlashCausal``) at
   nano_1b's width (B 4, S 256): output and q/k/v gradients against
   float32 autograd of the plain version, every row within
   KERNEL_REL_TOL, timed beside the plain version (uncounted); (b)
   ``training.pretrain`` of nano_1b at full width, 10 steps at batch 8
   and seq 256 from seed 0: finite losses, ms a step and tokens/s; the
   saved root served through ``checkpoint_path`` behind /query (the
   engine holds the saved weights; K1 and K2 launch) and scored by
   ``evaluate.eval_checkpoint``; (c) nano_test for 100 steps and (d)
   moe_test for 50 (batch 16, seq 128): the last 25-step window's mean
   loss below the first's, and moe_test's load-balance loss above 0.  K2
   launches in every training run; the plain causal attention runs only
   as K2's backward;
21. tensor parallelism (``tp``), over a group of the card repeated (the
   port's single controller runs every head shard there, one after
   another: the numbers are the cost of sharding on one card, not a
   multi-card speedup): (a) ``flagship_cluster(5)``'s orin, orin_8b bf16
   at tp=4 on the batched engine (ragged tick, chunked prefill, prefix
   hits) behind /query, and (b) orin_8b with int8 weights and an int8
   pool at tp=2 with the nano_1b draft (int8 weights too), each built,
   warmed (capture seconds and the graph pool's memory), driven over
   HTTP (``drive``), one tick replayed against its body
   (``tick_graph_check``: the tick's ms), then three probes (cold,
   chunked, a prefix hit) held against the same tier at tp=1: tokens
   equal or a near-tie (``near_tie`` on the tp=1 engine), and the cold
   one's prefill logits within LOGITS_RTOL of their scale of a float32
   run of the same weights, above tp=1's own distance to it; (c)
   orin_8b on the sequential engine at tp=4, its probes likewise against
   tp=1 (a flip judged by the prefill logits' gap,
   ``seq_near_tie``); (d) the bench's ``multichip`` section on two slots
   of the card (mini_bench's capacity verdicts, spec at tp=2); (e) a
   perf Router's ``health_mesh``: the monitor's ``allgather_health``
   rows equal the strategy's windows.  Each part's kernels must launch
   on every shard (``ops/launches.on_shard``); the kernel table lists
   the launches by part and shard (``launches_by_shard``);
22. sequence and expert parallelism (``sp_ep``), over groups of the card
   repeated, each part built on the weights of the same tier unsharded
   and held against it on the same probes (cold, long, a prefix hit)
   in the same call: tokens equal or a near-tie, the cold probe's
   prefill logits by 21's rule against float32 (a MoE model's experts
   pinned to the unsharded run's routes, once per tensor shard): (a)
   orin_8b bf16 on the sequential engine at sp=4, a prompt of about
   6000 tokens past the tier's largest bucket prefilled as ONE ring call
   on the extended ladder (8192) and decoded over the sequence-split
   cache (the ring and the sp partials are plain by design; counters
   show they ran), with the ring's prefill ms against the unsharded
   tier's K2 at 2048 and its chunked long prefill, and the decode step
   against K9's; (b) the same at sp=2 x tp=2 on the cold and hit probes
   (its ring timed at 2048); (c) moe_8x1b at ep=4 on
   the batched engine (bf16 pool: K1, K2, K3 on the tensor shard) and
   on the sequential engine with int8 weights (every ep slot's experts
   launch W1); (d) moe_8x1b at tp=2 with the int8 pool (K2 and K5 on
   both shards).  Each part prints its capture seconds and graph pools,
   peak memory and launches by slot; (a) and (c) first run the
   multichip section's capacity check for sp and ep (``sp_ep_budget``:
   the one-device tier refused by the manager, the group's fitting);
23. training over groups of the card repeated (``train_mesh``; the
   costs of sharding on one card, not a speedup), each part from the
   same weights and batches as the unsharded trainer in the same call:
   (a) nano_1b at full width over ``training_mesh`` of 4 slots (tp=4),
   (b) over ('dp', 'sp', 'tp') = (2, 2, 2) (FSDP, the ring and TP in
   one step), (c) ``PipelineTrainer`` at pp=2 with 4 microbatches, (d)
   moe_8x1b's widths cut to 4 of its 16 layers (a depth cut: full depth
   with its AdamW state is about 53 GB before activations) over
   ``moe_training_mesh`` of 8 slots (ep=8), each for three steps: the
   first step's loss, pre-clip grad norm and weights within twice the
   unsharded bf16 run's distance to a float32 run of the same weights
   (above a floor of one bf16 rounding of the float32 value), every loss
   finite, K2 on every dp/tp slot and pp stage (``launches.on_shard``),
   the ring's calls in (b), every ep slot's experts in (d); ms a step
   beside the unsharded trainer's, tokens/s, peak GB and launches by
   slot; (e) (b)'s checkpoint restored onto one device and onto (a)'s
   group, the leaves equal bit for bit, one more step finite on each.
24. the port's lint (``lint``): ``python -m distributed_llm_tpu_torch.lint``
   over the port as a subprocess, which must exit 0 with zero findings
   (its files, findings, suppressions and seconds on a line of their
   own), and beside it the transfer rule's twin on the card: nano_1b on
   the batched engine with every slot decoding and none queued, watched
   for LINT_WINDOW_TICKS steady ticks under PyTorch's sync check, where
   every synchronizing call must pass through ``_fetch_tick`` and K1
   must launch (an event wait escapes the check: the static rule stays
   the authority).

Phases 11, 15, 17 and 18 were cut in depth to pay for 19 and 20,
phases 11 and 17 again for 21, 15 again for 22, 20 for 23, and 10, 15,
16, 17 and 18 for W1's wide shapes (every path kept): phase 20 trains its
tiny presets TRAIN_TINY_STEPS steps,
the bench's sweep serves the first BENCH_QUERIES queries a strategy with
BENCH_TREND_REPEATS trend repeats and runs its tiny tenant and
autoscaler legs at BENCH_LEG_DEPTH, the legs' open-loop budget is
LEG_OPENLOOP_S, phase 17's load and ramps are FLEET2_NOISY_LOAD_S,
FLEET2_ELASTIC_PERIOD_S and FLEET2_CHAOS2_PERIOD_S and its remote tier
serves FLEET2_REMOTE_TURNS turns, phase 16's replica leg serves
FLEET_REPLICA_REQUESTS requests, the encoder trains EDGES_ENCODER_STEPS
steps, phase 10 runs the profiler's on/off bursts twice each way, and
W1's timings average W8_ITERS replays.

``python3 chip_smoke.py --only=pressure_nano,pressure_orin,spill`` (any of
those three, ``w8`` (W1's check and times), ``orin_spec_bf16``,
``orin_w8``, of the sequential phases ``orin_seq_bf16``,
``orin_seq_spec``, ``nano_seq_int8``, ``nano_seq_w8``, or ``trained_chat``,
``legs``, ``bench``, ``fleet``, ``fleet2``, ``edges``, ``moe``,
``train``, ``tp``, ``sp_ep``, ``train_mesh``, ``lint``) builds the kernels and runs
only those phases,
printing each one's numbers (each also to ``only_<name>.json`` in the
report directory), with no kernel table and no last line: a debugging
run.

The sequential engines (phases 7-9b and the bench's sequential legs)
run every device stage as a CUDA graph too (``engine/programs.py``), one
per JAX program key and cache rung.  The batched engines (phases 4-6
and 10-13) run every device stage as a CUDA graph captured once per
program (the ragged tick, each dense window
rung, each γ bucket's speculative round; an admission's cold prefill per
bucket and its writer, each chunk (width, window), the copy-on-write
copies, the draft's prefill, writer and chunk) and replayed; the
kernels' launch counts count replays.  An admission audit watches every
batched engine those phases build: on each main path no program body
may run outside a capture, and no chunk, prefix-hit or copy program may
be captured after the engine's warmup (only prefill buckets, a
replay's among them, writers and dense rungs are built on first use);
the host spill tier's copies run eagerly by design and are listed apart
(no spill copy may become a program); it reports each engine's device
memory before and after its warmup.  In each batched serve phase and in /chat
every admission program family is captured with one prompt, replayed
with another and held against its bodies run eagerly on the second
(``prefill_graph_check``: first tokens equal, the written pool rows
within one bf16 step, their max abs diff printed).

Each serve phase sets every kernel's launch count and every plain
version's call count to 0 before its requests and reads them after: the
phase's kernels must have launched and no plain attention version may
have run (the /chat phase: no ragged decode kernel either, and both tiers
must have served).  Then, on the live pool or cache, the decode step's logits
with the kernel and with the plain attention (in bf16 and in float32)
must agree (speculating tiers: the verify's rows against as many
sequential decode steps, and the verify with the kernel against the
verify with the plain attention), and one decode step (and, speculating,
one verify step) is timed eager and as a replayed CUDA graph.  On each
batched engine one tick runs through the program the engine replays and
through the program's body eagerly, from the same live state: their
tokens must be ``torch.equal``; the replayed tick is timed beside the
engine's program keys and served tick quantiles.

It prints the serving numbers as one JSON line, the /chat phase's numbers
per strategy as another, its obs numbers (``chat_obs``: each tier's
phase self-time table, coverage and attribution, the profiler's
overhead, the budgets) and its per-kernel capture
(``per_kernel_capture``) as two more, the bench's per-strategy req/s and
p50 TTFT, trace columns, profile section, utilization and wall time as
another, the pressure phases' and the spill phase's numbers as two more,
the trained /chat turns and the legs' numbers (phase 15's and phase 11's)
as two more, the fleet's, the fleet's second half's and the edges' as three more,
MoE's, training's, tensor parallelism's, sequence and expert
parallelism's, the training groups' and the lint's as six more (each
with the card's name and power limit), every phase's wall seconds as one more, the card's name and power
limit, the kernel table as one JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

# The card's peaks (device-memory bytes/s, dense bf16 FLOP/s), from the
# port's table (``utils.roofline.chip_peaks``), set in main().
PEAKS: dict = {}
REPO = os.path.dirname(os.path.abspath(__file__))
REPORT_DIR = os.path.join(REPO, "chiprun_out")

# Kernel vs plain, bf16 inputs drawn N(0, 1).  Every output row (one
# query head's D values) of the kernel is held against the same row of
# the plain version run in float32 on the same inputs (bf16 widened
# exactly, int8 dequantized in float32): ||kernel - plain32|| / ||plain32||
# <= KERNEL_REL_TOL.  The kernels round P and their output to bf16: their
# worst rows read 0.0019-0.0046 on an H100, the plain
# versions in bf16 0.005-0.019 (they round the logits and, for int8, the
# dequantized K/V to bf16).  A row's output shrinks as its
# frontier N grows (it averages N random values, about sqrt(e / N)), so
# the bound is relative to each row: a row that misses one 64-position
# tile moves by about sqrt(64 / N) of itself, 9% at N = 8192, and every
# kernel row asserts that the plain version one tile short lands outside
# the bound at its timed shapes.  The plain version in
# bf16 against float32 (``plain_rel_err``) is reported beside it.
KERNEL_REL_TOL = 1e-2
TOL = f"per-row ||kernel - plain32|| / ||plain32|| <= {KERNEL_REL_TOL:g}"
KV_TILE = 64                     # positions per staged K/V tile (K9-K12)
# Decode (and verify) logits after 16 or 32 bf16 layers, the kernel in
# every layer against the plain attention, in bf16 and in float32: the
# few-ulp attention differences pass through every later layer, and a
# model of seeded random weights amplifies them (its matrices have a gain
# above 1), the more the deeper it is.  So the bound is LOGITS_RTOL of the
# logits' own scale above the model's rounding floor, measured on the
# same state: how far the plain attention in bf16 lands from the same in
# float32.  A fault in the path (a wrong layer, table,
# position or scale plane) moves the logits by their whole scale.
LOGITS_RTOL = 0.05
SERVE_MAX_NEW = 32               # random weights rarely stop at EOS
# Graph-replayed times of redesigned kernels' previous design (one
# CUDA-core block per (kv head, slot), the retired ``ragged_paged.cuh``)
# at the same timed shapes, on an NVIDIA H100 80GB HBM3 at 700.00 W: kept
# in the report beside this run's time, never printed on the kernels line.
PREVIOUS_DESIGN_MS = {
    "ragged_decode": {"design": "ragged_paged.cuh", "ms": 0.556,
                      "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
    "paged_decode": {"design": "ragged_paged.cuh", "ms": 0.1439,
                     "eager_ms": 0.1840,
                     "card": "NVIDIA H100 80GB HBM3, 700.00 W"},
    "paged_decode_q8": {"design": "ragged_paged.cuh", "ms": 0.213,
                        "card": "NVIDIA H100 80GB HBM3, 700.00 W"}}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- timing ------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, each timed
    by CUDA events; ``flush`` (run untimed before each call) evicts L2 so
    every call finds its inputs cold, as the serving path does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def graph_ms(torch, fn, iters: int = 20, flush=None, out=None,
             times=None) -> float:
    """Device time of ``fn`` in ms: ``fn`` captured once as a CUDA graph
    (after a warm-up on a side stream), then ``iters`` replays, each after
    ``flush`` and between two CUDA events, all enqueued before one
    synchronize.  Replaying a graph takes the host a few microseconds,
    less than the device's flush, so the host stays ahead of the device
    and no host time falls between a replay's events: neither the
    wrapper's Python (which outlasts a kernel of tens of microseconds)
    nor the host's own jitter, which a synchronize per replay lets in.
    ``out``, a list, receives ``fn``'s captured output; ``times``, a list,
    each replay's ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = fn()
    graph.replay()                           # the first replay uploads it
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        if flush is not None:
            flush()
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    if out is not None:
        out.append(res)                      # what the replays wrote
    each = [start.elapsed_time(end) for start, end in events]
    if times is not None:
        times.extend(each)
    return sum(each) / iters


def timed(torch, calls: dict, flush) -> dict:
    """Each of ``calls`` (key -> fn: the kernel's wrapper, its plain
    version, the library call) timed as a replayed CUDA graph
    (``graph_ms``: device time, what the row reports) and as an eager
    single call (``time_ms``: the wrapper's host time included where it
    outlasts the kernel), kept beside it under ``eager``."""
    return {**{k: graph_ms(torch, fn, flush=flush) for k, fn in calls.items()},
            "eager": {k: time_ms(torch, fn, flush=flush)
                      for k, fn in calls.items()}}


def widen(args):
    """``args`` with every bf16 tensor as float32 (exact); int8 caches,
    float32 scales, tables and positions as they are."""
    return [a.float() if hasattr(a, "is_floating_point")
            and a.is_floating_point() and a.element_size() == 2 else a
            for a in args]


def row_rel_err(a, b) -> float:
    """The worst row's ||a - b|| / ||b||, a row being the last dim."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


NO_ERR = {"max_abs_err": 0.0, "rel_err": 0.0, "plain_rel_err": 0.0}


def compare(out, plain, args, rows=None) -> dict:
    """A kernel's ``out`` against ``plain(*args)`` and against ``plain``
    on the float32-widened ``args``, over the first ``rows`` rows of dim
    1: the max abs error against the plain version, the worst row's
    relative error against it in float32 (``rel_err``, the one held to
    KERNEL_REL_TOL) and the plain version's own (``plain_rel_err``)."""
    ref, ref32 = plain(*args), plain(*widen(args))
    if rows is not None:
        out, ref, ref32 = (x[:, :rows] for x in (out, ref, ref32))
    return {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "rel_err": row_rel_err(out, ref32),
            "plain_rel_err": row_rel_err(ref, ref32)}


def worst(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def agrees(name: str, res: dict, where: str = "") -> None:
    require(res["rel_err"] <= KERNEL_REL_TOL,
            f"{name} disagrees with its plain version{where}: {res}")


def one_tile_short(name: str, plain, args, at: int, tile: int = KV_TILE):
    """The bound's resolution: ``plain`` in float32 on ``args`` against the
    same with every frontier (``args[at]``, positions [B]) one ``tile``
    short, over the slots whose frontier is at least one tile.  Fails if
    that lands within KERNEL_REL_TOL; returns the worst row's error, or
    None where no slot's frontier reaches a whole tile."""
    pos = args[at]
    long_slots = pos >= tile
    if not bool(long_slots.any()):
        return None
    args32 = widen(args)
    short = list(args32)
    short[at] = pos - tile
    err = row_rel_err(plain(*short)[long_slots], plain(*args32)[long_slots])
    require(err > KERNEL_REL_TOL,
            f"{name}: a missed tile would pass at this shape ({err})")
    return err


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAKS["peak_hbm_bytes_per_s"] * 1e3
    t_ops = flops / PEAKS["peak_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels ----------------------------------------------------------

def kernel_phase(torch, cfg, orin_cfg, bs: int):
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nq // nkv
    mb = -(-cfg.max_seq_len // bs)
    n_slots = 8
    nb = n_slots * mb + 1
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
    rows = []

    # K1: ragged decode, 8 slots of skewed length, slot 0 idle (trash).
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = perm[:n_slots * mb].reshape(n_slots, mb).to(torch.int32)
    tables[0] = 0
    pos = torch.tensor([0, 40, 200, 700, 1500, 3000, 5000,
                        cfg.max_seq_len - 1], dtype=torch.int32, device=dev)
    q = randn(n_slots, nq, d)
    out = TR.ragged_paged_decode_attention(q, k_pool, v_pool, tables, pos)
    torch.cuda.synchronize()
    a1 = compare(out, TA._gather_decode_paged, (q, k_pool, v_pool, tables, pos))
    agrees("ragged_decode", a1)
    a1["one_tile_short_rel_err"] = one_tile_short(
        "ragged_decode", TA._gather_decode_paged,
        (q, k_pool, v_pool, tables, pos), 4)
    k_seq, v_seq = TA._gather_pool_seq(k_pool, v_pool, tables)
    k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    cols = torch.arange(mb * bs, device=dev)
    mask = (cols[None, :] <= pos[:, None])[:, None, None, :]
    q_l = q[:, :, None, :]
    pos_h = pos.tolist()
    blocks = sum(p // bs + 1 for p in pos_h)
    b1, by1 = bound(2 * blocks * nkv * bs * d * 2 + 2 * q.numel() * 2
                    + tables.numel() * 4 + pos.numel() * 4,
                    sum(4 * nq * (p + 1) * d for p in pos_h))
    rows.append({
        "name": "ragged_decode", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "distributed_llm_tpu/ops/ragged_attention.py:59",
        "shape": f"B={n_slots} Nq={nq} Nkv={nkv} D={d} bs={bs} MB={mb} "
                 f"NB={nb} pos={pos_h}",
        **a1, "tol": TOL,
        **timed(torch, {
            "ms": lambda: TR.ragged_paged_decode_attention(
                q, k_pool, v_pool, tables, pos),
            "plain_ms": lambda: TA._gather_decode_paged(
                q, k_pool, v_pool, tables, pos),
            "library_ms": lambda: F.scaled_dot_product_attention(
                q_l, k_l, v_l, attn_mask=mask)}, flush),
        "bound_ms": b1, "bound_by": by1,
        "previous_design": PREVIOUS_DESIGN_MS["ragged_decode"]})
    rows[-1].update(bench_decode_check(torch, gen))

    # K2: causal prefill; checked at every cold bucket up to a chunk and at
    # a length that is no multiple of a tile, at the nano tier's width and
    # the orin tier's (D=128), timed at nano's 256 (the largest monolithic
    # prefill of the default tier) and, under ``timings``, at nano's 2048
    # and orin's 256 and 2048.
    a2, k2_timings = NO_ERR, []
    for pcfg in (cfg, orin_cfg):
        pnq, pnkv, pd = pcfg.num_heads, pcfg.num_kv_heads, pcfg.head_dim
        for s in (256, 2048, 64, 128, 200):
            qc, kc, vc = (randn(1, s, pnq, pd), randn(1, s, pnkv, pd),
                          randn(1, s, pnkv, pd))
            out = TF.flash_causal_attention(qc, kc, vc)
            torch.cuda.synchronize()
            res = compare(out, TA.causal_attention, (qc, kc, vc))
            a2 = worst(a2, res)
            if s not in (256, 2048):
                continue
            # The bound's resolution: every row from position 64 on one
            # tile short (the plain chunk attention at positions - 64).
            short = torch.arange(s, device=dev, dtype=torch.int32)[None] - KV_TILE
            args32 = widen((qc, kc, vc))
            res["one_tile_short_rel_err"] = row_rel_err(
                TA.chunk_attention(*args32, short)[:, KV_TILE:],
                TA.causal_attention(*args32)[:, KV_TILE:])
            require(res["one_tile_short_rel_err"] > KERNEL_REL_TOL,
                    f"flash_causal: a missed tile would pass at S={s}: {res}")
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qc, kc, vc))
            pg = pnq // pnkv
            ks, vs = ks.repeat_interleave(pg, 1), vs.repeat_interleave(pg, 1)
            b2, by2 = bound(2 * (2 * qc.numel() + kc.numel() + vc.numel()),
                            4 * pnq * pd * s * (s + 1) // 2)
            k2_timings.append({
                "shape": f"{pcfg.name} B=1 S={s} Nq={pnq} Nkv={pnkv} D={pd}",
                **res,
                **timed(torch, {
                    "ms": lambda: TF.flash_causal_attention(qc, kc, vc),
                    "plain_ms": lambda: TA.causal_attention(qc, kc, vc),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=True)}, flush),
                "bound_ms": b2, "bound_by": by2})
            del qs, ks, vs
    agrees("flash_causal", a2)
    first = k2_timings[0]
    rows.append({
        "name": "flash_causal", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/flash_causal.cu",
        "replaces": "distributed_llm_tpu/ops/pallas_attention.py:57",
        "shape": first["shape"] + " (checked at S=64,128,200,256,2048, "
                 "D=64 and 128)",
        **a2, "tol": TOL,
        **{k: first[k] for k in ("ms", "plain_ms", "library_ms", "eager",
                                 "bound_ms", "bound_by",
                                 "one_tile_short_rel_err")},
        "timings": k2_timings})

    # K3: paged chunk.  Checked at a prefix hit (64 rows at start 37,
    # window 256) and timed at the long prompt's second chunk (256 rows at
    # start 256, window 1024).
    table = (torch.randperm(nb - 1, generator=gen, device=dev)[:mb] + 1).to(
        torch.int32)
    a3 = NO_ERR
    for start, s_c, window, true_len in ((37, 64, 256, 38), (256, 256, 1024, 512)):
        qc = randn(1, s_c, nq, d)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                            max=true_len - 1)[None]
        out = TF.paged_chunk_attention(qc, k_pool, v_pool, table, st, window)
        torch.cuda.synchronize()
        a3 = worst(a3, compare(out, TA._gather_chunk_paged,
                               (qc, k_pool, v_pool, table, q_pos, window),
                               rows=true_len - start))
    agrees("paged_chunk", a3)
    wb = window // bs
    kw = k_pool[:, table[:wb].long()].reshape(nkv, window, d)
    vw = v_pool[:, table[:wb].long()].reshape(nkv, window, d)
    kw = kw.repeat_interleave(g, 0)[None].contiguous()
    vw = vw.repeat_interleave(g, 0)[None].contiguous()
    qs = qc.transpose(1, 2).contiguous()
    wcols = torch.arange(window, device=dev)
    wmask = (wcols[None, :] <= (start + torch.arange(s_c, device=dev))[:, None])
    last = start + s_c - 1
    b3, by3 = bound(2 * (last // bs + 1) * nkv * bs * d * 2 + 2 * qc.numel() * 2
                    + table.numel() * 4,
                    sum(4 * nq * d * (start + r + 1) for r in range(s_c)))
    rows.append({
        "name": "paged_chunk", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/paged_chunk.cu",
        "replaces": "distributed_llm_tpu/ops/pallas_attention.py:571",
        "shape": f"S_c={s_c} start={start} window={window} Nq={nq} Nkv={nkv} "
                 f"D={d} bs={bs} (checked at S_c=64 start=37 window=256 too)",
        **a3, "tol": TOL,
        **timed(torch, {
            "ms": lambda: TF.paged_chunk_attention(
                qc, k_pool, v_pool, table, st, window),
            "plain_ms": lambda: TA._gather_chunk_paged(
                qc, k_pool, v_pool, table, q_pos, window),
            "library_ms": lambda: F.scaled_dot_product_attention(
                qs, kw, vw, attn_mask=wmask[None, None])}, flush),
        "bound_ms": b3, "bound_by": by3})
    # K2 and K3 are one kernel with two tile sources, so a row gets the
    # same bits from both: a 256-position prompt prefilled cold (K2 over
    # its fresh K/V) against its suffix from position 100 on a prefix hit
    # (K3 over the same K/V in scattered pool blocks).  The served path
    # relies on it: a repeated greedy prompt takes the prefix hit.
    s, m = 256, 100
    qc, kc, vc = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
    hit_table = (torch.randperm(nb - 1, generator=gen, device=dev)[:s // bs]
                 + 1).to(torch.int32)
    for pool, x in ((k_pool, kc), (v_pool, vc)):
        pool[:, hit_table.long()] = x[0].reshape(s // bs, bs, nkv, d).permute(
            2, 0, 1, 3)
    cold = TF.flash_causal_attention(qc, kc, vc)
    hit = TF.paged_chunk_attention(
        qc[:, m:].contiguous(), k_pool, v_pool, hit_table,
        torch.tensor([m], dtype=torch.int32, device=dev), s)
    torch.cuda.synchronize()
    require(torch.equal(hit, cold[:, m:]),
            "paged_chunk and flash_causal give a row different bits")
    rows[-1]["same_bits_as_flash_causal"] = True
    del flush_buf, k_pool, v_pool
    note_variants(rows, variant_checks(torch, gen))
    small = variant_checks(torch, gen, SMALL_SHAPES)
    tiny, short = tiny_preset_checks(torch, gen)
    note_variants(rows, {n: worst(small[n], tiny[n]) for n in small},
                  prefix="d16_", short=short)
    torch.cuda.empty_cache()
    return rows


def bench_decode_check(torch, gen) -> dict:
    """The ragged decode at the bench's orin tier (``bench_cluster``: a
    bf16 pool of its 4 slots over orin_8b's whole context, as phase 11
    serves it): slot 0 idle, the others' frontiers on and one key past the
    boundaries of the kernel's own split plan (``ragged_decode_split_plan``
    over the 4 x MB table), near the long-context probe's 2100 and at
    the context's end.  Each set held to KERNEL_REL_TOL, with the plain
    version one tile short outside it.  Returns the report keys."""
    from distributed_llm_tpu_torch.config import bench_cluster
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    tier = bench_cluster().orin
    cfg, bs, b = tier.model(), tier.kv_block_size, tier.decode_batch
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mb = -(-cfg.max_seq_len // bs)
    nb = b * mb + 1
    kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
    tables = (torch.randperm(nb - 1, generator=gen, device=dev)
              + 1).reshape(b, mb).to(torch.int32)
    tables[0] = 0
    blocks, splits = TR.ragged_decode_split_plan(mb, b, nkv)
    edge = blocks * bs                      # positions a split covers
    sets = ((edge - 1, edge, cfg.max_seq_len - 1),
            (4 * edge - 1, 4 * edge, 2100),
            ((splits - 1) * edge - 1, (splits - 1) * edge, 2 * edge + 37))
    res, short = NO_ERR, float("inf")
    for live in sets:
        pos = torch.tensor((0,) + live, dtype=torch.int32, device=dev)
        require(len(pos) == b, "bench_decode_check: one position a slot")
        q = randn(b, nq, d)
        args = (q, kp, vp, tables, pos)
        out = TR.ragged_paged_decode_attention(*args)
        torch.cuda.synchronize()
        res = worst(res, compare(out, TA._gather_decode_paged, args))
        short = min(short, one_tile_short(
            "ragged_decode", TA._gather_decode_paged, args, 4, tile=bs))
    agrees("ragged_decode", res, " at the bench's orin shape")
    return {"bench_orin_shape": f"B={b} Nq={nq} Nkv={nkv} D={d} bs={bs} "
                                f"MB={mb} plan=({blocks}, {splits}) "
                                f"pos={[(0,) + x for x in sets]}",
            "bench_orin_max_abs_err": res["max_abs_err"],
            "bench_orin_rel_err": res["rel_err"],
            "bench_orin_one_tile_short_rel_err": short}


def note_variants(rows, errs: dict, prefix: str = "variants_",
                  short=None) -> None:
    """Each row's kernel must have agreed at its other instantiations
    (under ``variants_``), or at the head-dim-16 / block-16 ones (under
    ``d16_``, with the one-tile-short error at the tiny presets' shapes
    from ``short``)."""
    for row in rows:
        res = errs.get(row["name"])
        if res is None:
            continue
        row[prefix + "max_abs_err"] = res["max_abs_err"]
        row[prefix + "rel_err"] = res["rel_err"]
        if short is not None and row["name"] in short:
            row[prefix + "one_tile_short_rel_err"] = short[row["name"]]
        agrees(row["name"], res, " at another instantiation")


# The instantiations the kernels gained for the tiny test presets
# (``nano_test``, ``orin_test``: head dim 16, 16-token blocks), as
# (head dim, block size): head dim 16 at every block, block 16 at the
# other head dims.  The serving instantiations are the product of
# (64, 128) and (32, 64, 128).
SMALL_SHAPES = ((16, 16), (16, 32), (16, 64), (16, 128), (64, 16), (128, 16))
SERVING_SHAPES = tuple((d, bs) for d in (64, 128) for bs in (32, 64, 128))


def tiny_preset_checks(torch, gen):
    """The ragged decode, the causal prefill and the paged chunk at the
    tiny presets' shapes (nano_test: Nq 4, Nkv 2; orin_test: Nq 8, Nkv 4;
    head dim 16, 16-token blocks, 256 positions; draft_test, the bench's
    spec leg's draft: Nq 4, Nkv 2, head dim 8, served by the 16 instance
    on zero-padded inputs), as the trend and spec legs serve them: K1 on 4 slots (one idle) up to the last position, K2 at 16-256
    rows, K3 at a prefix hit's 64 rows from position 100; each held to
    KERNEL_REL_TOL, with the plain version one 64-position tile short
    outside it, and K2 against K3 bit for bit.  Returns (worst
    ``compare`` per kernel, the worst one-tile-short error per kernel)."""
    from distributed_llm_tpu_torch.config import MODEL_PRESETS
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("ragged_decode", "flash_causal", "paged_chunk")}
    short = {n: float("inf") for n in errs}
    bs = 16
    for preset in ("nano_test", "orin_test", "draft_test"):
        cfg = MODEL_PRESETS[preset]
        nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        span = cfg.max_seq_len
        b, mb = 4, span // bs
        nb = b * mb + 1
        kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
        tables = (torch.randperm(nb - 1, generator=gen, device=dev)
                  + 1)[:b * mb].reshape(b, mb).to(torch.int32)
        tables[0] = 0
        pos = torch.tensor([0, 40, 130, span - 1], dtype=torch.int32,
                           device=dev)
        q = randn(b, nq, d)
        args = (q, kp, vp, tables, pos)
        res = compare(TR.ragged_paged_decode_attention(*args),
                      TA._gather_decode_paged, args)
        errs["ragged_decode"] = worst(errs["ragged_decode"], res)
        short["ragged_decode"] = min(short["ragged_decode"], one_tile_short(
            "ragged_decode", TA._gather_decode_paged, args, 4))
        for s in (16, 64, 256):
            qc, kc, vc = randn(1, s, nq, d), randn(1, s, nkv, d), \
                randn(1, s, nkv, d)
            res = compare(TF.flash_causal_attention(qc, kc, vc),
                          TA.causal_attention, (qc, kc, vc))
            errs["flash_causal"] = worst(errs["flash_causal"], res)
        rows = torch.arange(s, device=dev, dtype=torch.int32)[None]
        args32 = widen((qc, kc, vc))
        err = row_rel_err(TA.chunk_attention(*args32, rows - KV_TILE)[:, KV_TILE:],
                          TA.causal_attention(*args32)[:, KV_TILE:])
        require(err > KERNEL_REL_TOL,
                f"flash_causal: a missed tile would pass at {preset}: {err}")
        short["flash_causal"] = min(short["flash_causal"], err)
        # K3: the last prompt's suffix from position 100 on a prefix hit,
        # its K/V in scattered pool blocks; rows must match K2's bits.
        m = 100
        hit = (torch.randperm(nb - 1, generator=gen, device=dev)[:s // bs]
               + 1).to(torch.int32)
        for pool, x in ((kp, kc), (vp, vc)):
            pool[:, hit.long()] = x[0].reshape(s // bs, bs, nkv, d).permute(
                2, 0, 1, 3)
        st = torch.tensor([m], dtype=torch.int32, device=dev)
        qs = qc[:, m:].contiguous()
        out = TF.paged_chunk_attention(qs, kp, vp, hit, st, s)
        q_pos = (m + torch.arange(s - m, device=dev))[None]
        res = compare(out, TA._gather_chunk_paged,
                      (qs, kp, vp, hit, q_pos, s))
        errs["paged_chunk"] = worst(errs["paged_chunk"], res)
        args32 = widen((qs, kp, vp, hit, q_pos, s))
        err = row_rel_err(TA._gather_chunk_paged(*args32[:4], q_pos - KV_TILE,
                                                 s),
                          TA._gather_chunk_paged(*args32))
        require(err > KERNEL_REL_TOL,
                f"paged_chunk: a missed tile would pass at {preset}: {err}")
        short["paged_chunk"] = min(short["paged_chunk"], err)
        cold = TF.flash_causal_attention(qc, kc, vc)
        torch.cuda.synchronize()
        require(torch.equal(out, cold[:, m:]),
                f"paged_chunk and flash_causal give a row different bits "
                f"at {preset}")
    return errs, short


def variant_checks(torch, gen, shapes=SERVING_SHAPES) -> dict:
    """Each kernel against its plain version at the other instantiations
    it accepts (``shapes``: head dim and block pairs; GQA group 1/4/8) on
    small ragged shapes: idle slot, partial tiles, padded chunk rows; the
    ragged decode also at the boundaries of its own split plan
    (``ragged_decode_split_plan``: 1 or 2 blocks a split on 5 x 20
    tables), a frontier on split 0's last key, on split 1's first key,
    one block past it and at the table's end; the causal prefill also on a
    grid past the card's SM count.  Returns the worst ``compare`` per
    kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("ragged_decode", "flash_causal", "paged_chunk")}

    def note(name, out, plain, *args, rows=None):
        errs[name] = worst(errs[name], compare(out, plain, args, rows))

    for d, bs in shapes:
        for nq, nkv in ((32, 8), (16, 2), (8, 8)):
            b, mb = 4, 12
            nb = b * mb + 1
            kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
            tables = (torch.randperm(nb - 1, generator=gen, device=dev)
                      + 1)[:b * mb].reshape(b, mb).to(torch.int32)
            tables[1] = 0
            pos = torch.tensor([mb * bs - 1, 0, 5, 100], dtype=torch.int32,
                               device=dev)
            q = randn(b, nq, d)
            note("ragged_decode",
                 TR.ragged_paged_decode_attention(q, kp, vp, tables, pos),
                 TA._gather_decode_paged, q, kp, vp, tables, pos)
            sb, smb = 5, 20
            snb = sb * smb + 1
            skp, svp = randn(nkv, snb, bs, d), randn(nkv, snb, bs, d)
            stables = (torch.randperm(snb - 1, generator=gen, device=dev)
                       + 1).reshape(sb, smb).to(torch.int32)
            stables[1] = 0
            edge = TR.ragged_decode_split_plan(smb, sb, nkv)[0] * bs
            spos = torch.tensor([edge - 1, 0, edge, edge + bs,
                                 smb * bs - 1], dtype=torch.int32,
                                device=dev)
            sq = randn(sb, nq, d)
            note("ragged_decode",
                 TR.ragged_paged_decode_attention(sq, skp, svp, stables,
                                                  spos),
                 TA._gather_decode_paged, sq, skp, svp, stables, spos)
            # K2 at S=100 runs on at most 132 blocks (two warps a
            # slab), at S=1100 on more (one warp a slab).
            for s in (100, 1100) if bs == 64 else (100,):
                qc, kc, vc = randn(2, s, nq, d), randn(2, s, nkv, d), \
                    randn(2, s, nkv, d)
                note("flash_causal", TF.flash_causal_attention(qc, kc, vc),
                     TA.causal_attention, qc, kc, vc)
            start, s_c, true_len = 20, 70, 80
            table = tables[0].contiguous()
            qq = randn(1, s_c, nq, d)
            st = torch.tensor([start], dtype=torch.int32, device=dev)
            q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                                max=true_len - 1)[None]
            window = max(4 * bs, 128)         # the chunk's rows inside it
            note("paged_chunk",
                 TF.paged_chunk_attention(qq, kp, vp, table, st, window),
                 TA._gather_chunk_paged, qq, kp, vp, table, q_pos, window,
                 rows=true_len - start)
    return errs


# -- phase 3, continued: the speculation and int8 kernels ----------------------

def verify_bound(cfg, pos_h, g: int, bs: int, kv_bytes: float, q_bytes: int,
                 table_bytes: int):
    """Bytes: each slot's own ceil((pos + g) / bs) blocks of K and V once
    (``kv_bytes`` per position and kv head, scales included), q and out
    once, the tables and positions; operations: QK and PV multiply-adds
    of every query row over the keys it sees."""
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    blocks = sum((p + g - 1) // bs + 1 for p in pos_h)
    return bound(blocks * nkv * bs * kv_bytes + 2 * q_bytes + table_bytes,
                 sum(4 * nq * d * (p + r + 1) for p in pos_h for r in range(g)))


def spec_kernel_phase(torch, cfg, draft_cfg, bs: int, n_slots: int):
    """The ragged verify kernel (bf16) and the int8 ragged decode and
    verify kernels at the orin tier's shapes: 4 slots at positions 0
    (idle, trash row), 100, 3000 and the context's end, the pool of a
    4-slot orin engine ([8, 513, 64, 128]), verify widths G = 2, 3, 5 (the
    γ buckets 1, 2, 4) checked and G = 5 timed, with the plain version
    one tile short outside the bound, and timed again at a short shape
    (4 live slots at 100-400, the row's ``short``); the int8 decode at D=128
    (self-draft, γ=0 ticks) timed and at D=64 (the nano draft's pool)
    checked.  The bf16 ragged decode is also checked at the nano draft's
    shape (B=4, D=64, 513 blocks).  Returns the three rows and the bf16
    decode's error at the draft shape."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    grp = nq // nkv
    mb = -(-cfg.max_seq_len // bs)
    nb = n_slots * mb + 1
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    def slot_tables(n_blocks, idle=True):
        perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
        t = perm[:n_slots * mb].reshape(n_slots, mb).to(torch.int32)
        if idle:
            t[0] = 0                                # idle slot: trash row
        return t.contiguous()

    def positions(g):
        return torch.tensor([0, 100, 3000, cfg.max_seq_len - g],
                            dtype=torch.int32, device=dev)

    k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
    kq, ks = quant.quantize_kv_rows(k_pool)
    vq, vs = quant.quantize_kv_rows(v_pool)
    tables = slot_tables(nb)
    table_bytes = tables.numel() * 4 + n_slots * 4
    rows = []

    def sdpa_inputs(q, pool, tbl, pos):
        """[B, Nq, G, D] q, GQA-expanded gathered (dequantized) K/V and
        the per-row causal mask, for one SDPA call (the gather is not
        timed)."""
        g = q.shape[1]
        k_seq, v_seq = TA._gather_pool_seq(pool[0], pool[1], tbl, pool[2],
                                           pool[3], bf)
        k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
        v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
        cols = torch.arange(k_seq.shape[1], device=dev)
        rowpos = pos.long()[:, None] + torch.arange(g, device=dev)[None]
        mask = (cols[None, None, :] <= rowpos[:, :, None])[:, None]
        return q.permute(0, 2, 1, 3).contiguous(), k_l, v_l, mask

    # K4 / K6: ragged verify over the bf16 and the int8 pool, timed at the
    # skewed shape and at a short one (4 live slots at 100-400, one split
    # each: the split and merge overhead where splitting buys nothing).
    short_tables = slot_tables(nb, idle=False)
    short_pos = torch.tensor([100, 200, 300, 400], dtype=torch.int32,
                             device=dev)
    for name, src, replaces, pool, kv_bytes in (
            ("ragged_verify", "ragged_verify.cu", "ragged_attention.py:170",
             (k_pool, v_pool, None, None), 2 * d * 2),
            ("ragged_verify_q8", "ragged_verify_q8.cu",
             "ragged_attention.py:389", (kq, vq, ks, vs), 2 * (d + 4))):
        q8 = pool[2] is not None
        kern = (TR.ragged_paged_verify_attention_q8 if q8
                else TR.ragged_paged_verify_attention)
        agree = NO_ERR
        for g in (2, 3, 5):
            pos = positions(g)
            q = randn(n_slots, g, nq, d)
            kargs = ((q, *pool, tables, pos) if q8
                     else (q, pool[0], pool[1], tables, pos))
            out = kern(*kargs)
            torch.cuda.synchronize()
            agree = worst(agree, compare(
                out, TA._gather_verify_paged,
                (q, pool[0], pool[1], tables, pos, pool[2], pool[3])))
        agrees(name, agree)
        agree["one_tile_short_rel_err"] = one_tile_short(
            name, TA._gather_verify_paged,
            (q, pool[0], pool[1], tables, pos, pool[2], pool[3]), 4, bs)
        by_shape = {}
        for label, tbl, tpos in (("", tables, pos),
                                 ("short", short_tables, short_pos)):
            targs = (q, *pool, tbl, tpos) if q8 else (q, pool[0], pool[1],
                                                      tbl, tpos)
            lib = sdpa_inputs(q, pool, tbl, tpos)
            b_ms, b_by = verify_bound(cfg, tpos.tolist(), g, bs, kv_bytes,
                                      q.numel() * 2, table_bytes)
            calls = {"ms": lambda: kern(*targs),
                     "plain_ms": lambda: TA._gather_verify_paged(
                         q, pool[0], pool[1], tbl, tpos, pool[2], pool[3]),
                     "library_ms": lambda: F.scaled_dot_product_attention(
                         lib[0], lib[1], lib[2], attn_mask=lib[3])}
            by_shape[label] = {
                "shape": f"B={n_slots} G={g} Nq={nq} Nkv={nkv} D={d} bs={bs} "
                         f"MB={mb} NB={nb} pos={tpos.tolist()}",
                **timed(torch, calls, flush),
                "bound_ms": b_ms, "bound_by": b_by}
            del lib, calls
        main = by_shape.pop("")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_tpu/ops/{replaces}",
            **main, "shape": main["shape"] + " (checked at G=2,3,5)",
            **agree, "tol": TOL, "short": by_shape["short"]})

    # K5: int8 ragged decode, timed at the orin pool (D=128), checked at the
    # nano draft's pool (D=64) too.
    pos = positions(1)
    q = randn(n_slots, nq, d)
    args = (q, kq, vq, ks, vs, tables, pos)
    out = TR.ragged_paged_decode_attention_q8(*args)
    torch.cuda.synchronize()
    a5 = compare(out, TA._gather_decode_paged,
                 (q, kq, vq, tables, pos, ks, vs))
    dnq, dnkv, dd = draft_cfg.num_heads, draft_cfg.num_kv_heads, \
        draft_cfg.head_dim
    dk, dv = randn(dnkv, nb, bs, dd), randn(dnkv, nb, bs, dd)
    dkq, dks = quant.quantize_kv_rows(dk)
    dvq, dvs = quant.quantize_kv_rows(dv)
    dq = randn(n_slots, dnq, dd)
    out = TR.ragged_paged_decode_attention_q8(dq, dkq, dvq, dks, dvs, tables,
                                              pos)
    torch.cuda.synchronize()
    a5 = worst(a5, compare(out, TA._gather_decode_paged,
                           (dq, dkq, dvq, tables, pos, dks, dvs)))
    agrees("ragged_decode_q8", a5)
    a5["one_tile_short_rel_err"] = one_tile_short(
        "ragged_decode_q8", TA._gather_decode_paged,
        (q, kq, vq, tables, pos, ks, vs), 4, bs)
    # K1 at the nano draft's shape (bf16 pool of a 4-slot engine).
    out = TR.ragged_paged_decode_attention(dq, dk, dv, tables, pos)
    torch.cuda.synchronize()
    a1 = compare(out, TA._gather_decode_paged, (dq, dk, dv, tables, pos))
    agrees("ragged_decode", a1, " at the draft shape")
    pos_h = pos.tolist()
    lib = sdpa_inputs(q[:, None], (kq, vq, ks, vs), tables, pos)
    b_ms, b_by = verify_bound(cfg, pos_h, 1, bs, 2 * (d + 4), q.numel() * 2,
                              table_bytes)
    rows.append({
        "name": "ragged_decode_q8", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/ragged_decode_q8.cu",
        "replaces": "distributed_llm_tpu/ops/ragged_attention.py:285",
        "shape": f"B={n_slots} Nq={nq} Nkv={nkv} D={d} bs={bs} MB={mb} "
                 f"NB={nb} pos={pos_h} (checked at the nano draft's "
                 f"Nq={dnq} D={dd} too)",
        **a5, "tol": TOL,
        **timed(torch, {
            "ms": lambda: TR.ragged_paged_decode_attention_q8(*args),
            "plain_ms": lambda: TA._gather_decode_paged(
                q, kq, vq, tables, pos, ks, vs),
            "library_ms": lambda: F.scaled_dot_product_attention(
                lib[0], lib[1], lib[2], attn_mask=lib[3])}, flush),
        "bound_ms": b_ms, "bound_by": b_by})
    del lib, flush_buf, k_pool, v_pool, kq, vq, dk, dv, dkq, dvq
    note_variants(rows, spec_variant_checks(torch, gen))
    note_variants(rows, spec_variant_checks(torch, gen, SMALL_SHAPES),
                  prefix="d16_")
    torch.cuda.empty_cache()
    return rows, a1


def spec_variant_checks(torch, gen, shapes=SERVING_SHAPES) -> dict:
    """The verify kernels (bf16, int8) at every instantiation they accept
    (``shapes``: head dim and block pairs; GQA group 1/4/8, G 1..5) and the
    int8 decode kernel (G=1) on small ragged shapes that span several
    splits of the verify kernels' plan (``split_plan``: 8 tiles a split
    at these 20-block tables): a chunk ending at the table's end (three
    splits, the last of four tiles), an idle slot, a frontier ending
    exactly on a split boundary, one ending one tile past it (a last
    split of a single tile) and a chunk whose G rows straddle a boundary
    (rows before it leave an empty partial in the live split after it).
    The int8 decode kernel is also held at the boundaries of its own plan
    (``ragged_decode_split_plan``: 1 or 2 blocks a split here): a
    frontier on a split's last key, on the next split's first key and one
    block past it.  Returns the worst ``compare`` per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("ragged_verify", "ragged_verify_q8",
                                "ragged_decode_q8")}

    def note(name, out, plain, *args):
        errs[name] = worst(errs[name], compare(out, plain, args))

    for d, bs in shapes:
        for nq, nkv in ((32, 8), (16, 2), (8, 8)):
            b, mb = 5, 20
            nb = b * mb + 1
            tiles, splits = TR.split_plan(mb, b, nkv)
            require(splits >= 3, f"the variant tables span {splits} "
                    f"splits of {tiles} tiles, not 3")
            edge = tiles * bs               # first key of split 1
            kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
            kq, ks = quant.quantize_kv_rows(kp)
            vq, vs = quant.quantize_kv_rows(vp)
            tables = (torch.randperm(nb - 1, generator=gen, device=dev)
                      + 1)[:b * mb].reshape(b, mb).to(torch.int32)
            tables[1] = 0
            for g in range(1, 6):
                pos = torch.tensor([mb * bs - g, 0, edge - g,
                                    edge + bs // 2 - g + 1, 2 * edge - 2],
                                   dtype=torch.int32, device=dev)
                q = randn(b, g, nq, d)
                note("ragged_verify",
                     TR.ragged_paged_verify_attention(q, kp, vp, tables,
                                                      pos),
                     TA._gather_verify_paged, q, kp, vp, tables, pos)
                note("ragged_verify_q8",
                     TR.ragged_paged_verify_attention_q8(
                         q, kq, vq, ks, vs, tables, pos),
                     TA._gather_verify_paged, q, kq, vq, tables, pos, ks,
                     vs)
                if g == 1:
                    q1 = q[:, 0].contiguous()
                    dedge = TR.ragged_decode_split_plan(mb, b, nkv)[0] * bs
                    for dpos in (pos, torch.tensor(
                            [dedge - 1, 0, dedge, dedge + bs, mb * bs - 1],
                            dtype=torch.int32, device=dev)):
                        note("ragged_decode_q8",
                             TR.ragged_paged_decode_attention_q8(
                                 q1, kq, vq, ks, vs, tables, dpos),
                             TA._gather_decode_paged, q1, kq, vq, tables,
                             dpos, ks, vs)
    return errs


# -- phase 3, continued: the contiguous-cache kernels (sequential engines) ----

def contiguous_cases(nano, orin):
    """K9-K12 at the sequential engines' shapes, (kernel, q8, cfg, cache
    length, window, start, rows): decode at the end of the 8192 cache, at
    the served long prompt's position 2255 in it and at 700 in a 1024
    cache (D=128 orin, D=64 nano); chunks as the 5-row
    verify at 3000 in an 8192 cache (D=128), a 256-row prefix-hit suffix
    at 768 in a 1024 cache and a long prompt's 2048-row chunk at 2048
    against a 4096 window of an 8192 cache.  The first case of each
    kernel is its row's timed shape (int8 chunks are the nano int8
    tier's, D=64)."""
    dec = [(orin, 8192, 8192, 8191, 1), (orin, 8192, 8192, 2255, 1),
           (orin, 1024, 1024, 700, 1), (nano, 8192, 8192, 8191, 1),
           (nano, 1024, 1024, 700, 1)]
    verify = (orin, 8192, 8192, 3000, 5)
    return {
        "flash_decode": (False, dec),
        "flash_decode_q8": (True, dec),
        "flash_chunk": (False, [verify, (orin, 1024, 1024, 768, 256),
                                (orin, 8192, 4096, 2048, 2048)]),
        "flash_chunk_q8": (True, [(nano, 1024, 1024, 768, 256),
                                  (nano, 8192, 4096, 2048, 2048), verify]),
    }


def contiguous_kernel_phase(torch, nano, orin):
    """K9-K12 against their plain versions at ``contiguous_cases``, each
    timed beside its plain version, one SDPA call on the dequantized,
    GQA-expanded window with the per-row causal mask (timed here only)
    and the card's bound: bytes at 3.35 TB/s (each sequence's own
    frontier+1 cache rows of K and V once, scales included, plus q and
    out) or operations at 989 TFLOP/s.  K11 at each shape takes its
    route (``chunk_route``); where that is the split route (the 5-row
    verify), the tensor-core route is also held and timed there
    (``tc_route``).  Then every kernel at its other instantiations
    (``contiguous_variant_checks``)."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    bf = torch.bfloat16
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    wrappers = kernel_wrappers()
    plain = {"flash_decode": TA._decode_contiguous,
             "flash_decode_q8": TA._decode_contiguous_q8,
             "flash_chunk": TA._chunk_contiguous,
             "flash_chunk_q8": TA._chunk_contiguous_q8}
    replaces = {"flash_decode": "pallas_attention.py:877",
                "flash_decode_q8": "pallas_attention.py:994",
                "flash_chunk": "pallas_attention.py:153",
                "flash_chunk_q8": "pallas_attention.py:358"}

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    rows = []
    for name, (q8, cases) in contiguous_cases(nano, orin).items():
        timings, agree = [], NO_ERR
        for cfg, s_max, w, start, s_c in cases:
            nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            k, v = randn(1, s_max, nkv, d), randn(1, s_max, nkv, d)
            cache = ((*quant.quantize_kv_rows(k), *quant.quantize_kv_rows(v))
                     if q8 else (k, None, v, None))
            kc, ks, vc, vs = (None if t is None else t[:, :w] for t in cache)
            window = (kc, vc, ks, vs) if q8 else (kc, vc)
            positions = start + torch.arange(s_c, device=dev, dtype=torch.int32)
            if name.startswith("flash_decode"):
                q, pos = randn(1, nq, d), positions
            else:
                q, pos = randn(1, s_c, nq, d), positions[None]
            args = (q, *window, pos)
            out = wrappers[name](*args)
            torch.cuda.synchronize()
            res = compare(out, plain[name], args)
            agree = worst(agree, res)
            # The bound's resolution: every row's frontier one tile short.
            res["one_tile_short_rel_err"] = row_rel_err(
                plain[name](*widen((*args[:-1], pos - KV_TILE))),
                plain[name](*widen(args)))
            require(res["one_tile_short_rel_err"] > KERNEL_REL_TOL,
                    f"{name}: a missed tile would pass at this shape: {res}")
            if name == "flash_chunk":
                res["route"] = TF.chunk_route(s_c, nq, nkv)
            if res.get("route") == "split":
                # The other route on the same inputs (wide chunks take
                # only the tensor-core one).
                def tc_call():
                    return TF._tc_chunk(TF.flash_chunk_attention,
                                        "flash_chunk", q, kc, vc, None, None,
                                        pos)
                res_tc = compare(tc_call(), plain[name], args)
                agree = worst(agree, res_tc)
                res["tc_route"] = {**res_tc, "ms": graph_ms(torch, tc_call,
                                                            flush=flush)}
            kd, vd = ((TA._dequant_cache(kc, vc, ks, vs, bf)) if q8
                      else (kc, vc))
            grp = nq // nkv
            k_l = kd.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            v_l = vd.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            q_l = q.reshape(1, -1, nq, d).permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(w, device=dev)[None, :]
                    <= positions[:, None])[None, None]
            kv_row = nkv * (d + 4) if q8 else nkv * d * 2
            b_ms, b_by = bound(2 * (start + s_c) * kv_row + 2 * q.numel() * 2
                               + positions.numel() * 4,
                               sum(4 * nq * d * (start + r + 1)
                                   for r in range(s_c)))
            timings.append({
                "shape": f"{cfg.name} Nq={nq} Nkv={nkv} D={d} S={s_max} "
                         f"W={w} rows={s_c} start={start}",
                **res,
                **timed(torch, {
                    "ms": lambda: wrappers[name](*args),
                    "plain_ms": lambda: plain[name](*args),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        q_l, k_l, v_l, attn_mask=mask)}, flush),
                "bound_ms": b_ms, "bound_by": b_by})
            del k, v, cache, kc, vc, ks, vs, window, args, kd, vd, k_l, v_l
        agrees(name, agree)
        first = timings[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{name}.cu",
            "replaces": f"distributed_llm_tpu/ops/{replaces[name]}",
            "shape": first["shape"] + f" (checked at {len(timings)} shapes)",
            **agree, "tol": TOL,
            **{k: first[k] for k in ("ms", "plain_ms", "library_ms", "eager",
                                     "bound_ms", "bound_by")},
            "timings": timings})
    del flush_buf
    note_variants(rows, contiguous_variant_checks(torch, gen))
    tiny, short = tiny_cache_checks(torch, gen)
    note_variants(rows, tiny, prefix="d16_", short=short)
    torch.cuda.empty_cache()
    return rows


def tiny_cache_checks(torch, gen):
    """K9-K12 at the tiny presets' sequential tiers (nano_test: Nq 4, Nkv
    2; orin_test: Nq 8, Nkv 4; head dim 16 through the 64 instance on
    zero-padded copies, ``flash_attention._CACHE_PADDED_D``; a 256-position
    cache), as the bench's perf-steering leg serves them: decode at
    positions 0, 100 and 255 of two sequences, chunks of 5 rows (K11's
    split route) and 64 rows (the tensor-core route) from position 100,
    each held to KERNEL_REL_TOL with every frontier one tile short outside
    it.  Returns (worst ``compare`` per kernel, the worst one-tile-short
    error per kernel)."""
    from distributed_llm_tpu_torch.config import MODEL_PRESETS
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    kernels = {"flash_decode": (TF.flash_decode_attention,
                                TA._decode_contiguous, False),
               "flash_decode_q8": (TF.flash_decode_attention_q8,
                                   TA._decode_contiguous_q8, True),
               "flash_chunk": (TF.flash_chunk_attention,
                               TA._chunk_contiguous, False),
               "flash_chunk_q8": (TF.flash_chunk_attention_q8,
                                  TA._chunk_contiguous_q8, True)}
    errs = {n: NO_ERR for n in kernels}
    short = {n: float("inf") for n in kernels}
    for preset in ("nano_test", "orin_test"):
        cfg = MODEL_PRESETS[preset]
        nq, nkv, d, w = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.max_seq_len)
        k, v = randn(2, w, nkv, d), randn(2, w, nkv, d)
        (kq, ks), (vq, vs) = quant.quantize_kv_rows(k), \
            quant.quantize_kv_rows(v)
        for name, (kernel, plain, q8) in kernels.items():
            window = (kq, vq, ks, vs) if q8 else (k, v)
            if name.startswith("flash_decode"):
                cases = [(randn(2, nq, d), torch.tensor(
                    p, dtype=torch.int32, device=dev))
                    for p in ((0, 100), (100, 255))]
            else:
                cases = [(randn(2, s_c, nq, d), (100 + torch.arange(
                    s_c, device=dev, dtype=torch.int32))[None].repeat(2, 1))
                    for s_c in (5, 64)]
            for q, pos in cases:
                args = (q, *window, pos)
                res = compare(kernel(*args), plain, args)
                errs[name] = worst(errs[name], res)
                err = row_rel_err(plain(*widen((*args[:-1], pos - KV_TILE))),
                                  plain(*widen(args)))
                require(err > KERNEL_REL_TOL,
                        f"{name}: a missed tile would pass at {preset}: {err}")
                short[name] = min(short[name], err)
    return errs, short


def contiguous_variant_checks(torch, gen) -> dict:
    """K9-K12 at every instantiation they accept (head dim 64/128, GQA
    group 1/4/8, B 1-4) over windows of a longer cache (a batch stride
    that is not W's, a partial last tile); returns the worst ``compare``
    per kernel.  The decode kernels (K9, K10) on W=2200 of S=2300, which
    spans at least three splits of their plan (``decode_split_plan``: 1,
    2 or 3 tiles a split at these shapes), with frontiers on the first
    split boundary (its last key), one tile past it, at 0 (an idle row)
    and at W-1; the chunk kernels (K11, K12) on W=200 of S=300, chunk rows
    1-5, 20, 37 and 64 clamped to a true length, K12 also with its last
    row's frontier on and one key past a 64- and a 128-key tile boundary,
    and 600 rows over W=1000 of S=1100 at B=4 (a grid past the card's SM
    count).  K11 takes its route by shape (``chunk_route``) and every
    chunk that fits the split route is also held on the tensor-core
    route; it is held too at each side of the boundary between them
    (48 / group rows and one more), its first sequence's rows passing
    W - 1 and each sequence's last row clamped onto the one before."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    wrappers = kernel_wrappers()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("flash_decode", "flash_decode_q8",
                                "flash_chunk", "flash_chunk_q8")}

    def note(name, plain, *args):
        errs[name] = worst(errs[name],
                           compare(wrappers[name](*args), plain, args))

    def note_chunk(qc, k, v, q_pos):
        """K11 through its wrapper (the route its shape takes) and, where
        that is the split route, on the tensor-core route too."""
        args = (qc, k, v, q_pos)
        note("flash_chunk", TA._chunk_contiguous, *args)
        nq, nkv = qc.shape[2], k.shape[2]
        if TF.chunk_route(qc.shape[1], nq, nkv) == "split":
            out = TF._tc_chunk(TF.flash_chunk_attention, "flash_chunk", qc, k,
                               v, None, None, q_pos)
            errs["flash_chunk"] = worst(errs["flash_chunk"], compare(
                out, TA._chunk_contiguous, args))

    def windows(b, nkv, d, s_max, w):
        k, v = randn(b, s_max, nkv, d), randn(b, s_max, nkv, d)
        kq, ks = quant.quantize_kv_rows(k)
        vq, vs = quant.quantize_kv_rows(v)
        return ((k[:, :w], v[:, :w]),
                (kq[:, :w], vq[:, :w], ks[:, :w], vs[:, :w]))

    for d in (64, 128):
        for nq, nkv in ((32, 8), (16, 2), (8, 8)):
            for b in (1, 2, 3, 4):
                s_max, w = 2300, 2200
                tiles, splits = TR.decode_split_plan(w, b, nkv)
                require(splits >= 3, f"the decode variant window spans "
                        f"{splits} splits of {tiles} tiles, not 3")
                edge = tiles * KV_TILE             # first key of split 1
                pos = torch.tensor([edge - 1, 0, edge + KV_TILE, w - 1][:b],
                                   dtype=torch.int32, device=dev)
                bf_win, q8_win = windows(b, nkv, d, s_max, w)
                q = randn(b, nq, d)
                note("flash_decode", TA._decode_contiguous, q, *bf_win, pos)
                note("flash_decode_q8", TA._decode_contiguous_q8, q, *q8_win,
                     pos)
                bf_win, q8_win = windows(b, nkv, d, 300, 200)
                for s_c in (1, 2, 3, 4, 5, 20, 37, 64):
                    starts = torch.tensor([0, 37, 130, 136][:b],
                                          device=dev)[:, None]
                    rows = torch.arange(s_c, device=dev)[None]
                    q_pos = torch.minimum(starts + rows, starts + max(1, s_c - 2)
                                          ).to(torch.int32)
                    qc = randn(b, s_c, nq, d)
                    note_chunk(qc, *bf_win, q_pos)
                    note("flash_chunk_q8", TA._chunk_contiguous_q8, qc,
                         *q8_win, q_pos)
                    # The int8 chunk with its last row's frontier on a tile
                    # boundary (63 | 64 and 127 | 128: the ends of a 64-
                    # and a 128-key tile) and one key past it.
                    ends = torch.tensor([63, 64, 127, 128][:b], device=dev)
                    q_pos = (ends[:, None] - s_c + 1 + rows).clamp_min(0).to(
                        torch.int32)
                    note("flash_chunk_q8", TA._chunk_contiguous_q8, qc,
                         *q8_win, q_pos)
                # K11 at each side of its route boundary: the first
                # sequence's rows at 196 on pass W - 1 = 199, and every
                # sequence's last row is clamped onto the one before it.
                fit = TF.SPLIT_MAX_ROWS // (nq // nkv)
                for s_c in (fit, fit + 1):
                    starts = torch.tensor([196, 0, 37, 130][:b],
                                          device=dev)[:, None]
                    q_pos = (starts + torch.arange(s_c, device=dev)[None]).to(
                        torch.int32)
                    q_pos[:, -1] = q_pos[:, -2]
                    note_chunk(randn(b, s_c, nq, d), *bf_win, q_pos)
            # The int8 chunk on a grid past the card's SM count (one warp a
            # slab): 600 rows at 300-399 over W=1000 of S=1100.
            b = 4
            _, q8_win = windows(b, nkv, d, 1100, 1000)
            q_pos = (torch.tensor([300, 333, 366, 399], device=dev)[:, None]
                     + torch.arange(600, device=dev)[None]).to(torch.int32)
            qc = randn(b, 600, nq, d)
            note("flash_chunk_q8", TA._chunk_contiguous_q8, qc, *q8_win, q_pos)
    return errs


# -- phase 3, continued: the dense windowed tick's paged decode kernels ------

def paged_decode_cases(nano, orin):
    """K7 and K8 at the dense tick's shapes, (kernel, cfg, slots,
    positions, window blocks of 64): K7 at the nano tier's 8 slots in a
    2048 window (timed: 4 blocks a split) and at K1's timed shape, the
    full 8192 table (wb = MB, for a direct comparison with K1); K8 at the
    orin tier's 4 slots in a 2048 window (timed: 2 blocks a split).  Each
    also with frontiers on the last key of a split and one key past it,
    and in a window of one block; K8 in the whole table too.  Slot 0 is
    idle (its whole row on the trash block)."""
    return {
        "paged_decode": [
            (nano, 8, [0, 40, 200, 700, 1500, 1900, 1100, 2047], 32),
            (nano, 8, [0, 40, 200, 700, 1500, 3000, 5000, 8191], 128),
            (nano, 8, [0, 255, 256, 511, 512, 1023, 1024, 2047], 32),
            (nano, 8, [0, 5, 40, 63, 1, 17, 32, 62], 1)],
        "paged_decode_q8": [(orin, 4, [0, 100, 700, 1900], 32),
                            (orin, 4, [0, 127, 128, 2047], 32),
                            (orin, 4, [0, 5, 40, 63], 1),
                            (orin, 4, [0, 100, 4000, 8191], 128)],
    }


def paged_decode_kernel_phase(torch, nano, orin, bs: int = 64):
    """K7 (bf16 pool) and K8 (int8 pool) at ``paged_decode_cases``, each
    window a column slice of a full [B, 128] table (the kernel reads it
    through its row stride, as the engine passes it): every output row
    within KERNEL_REL_TOL of the plain version in float32, the plain
    version with every frontier one 64-position tile short outside it,
    then timed beside the plain version, one SDPA call on the gathered
    (dequantized), GQA-expanded window with the per-slot mask (timed here
    only) and the byte bound at 3.35 TB/s.  Then both kernels at their
    other instantiations (``paged_decode_variant_checks``)."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf = torch.bfloat16
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    wrappers = kernel_wrappers()

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    rows = []
    for name, cases in paged_decode_cases(nano, orin).items():
        q8 = name.endswith("_q8")
        timings, agree = [], NO_ERR
        for cfg, b, pos_h, wb in cases:
            nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            mb = -(-cfg.max_seq_len // bs)
            nb = b * mb + 1
            k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
            if q8:
                kq, ks = quant.quantize_kv_rows(k_pool)
                vq, vs = quant.quantize_kv_rows(v_pool)
                pool = (kq, vq, ks, vs)
            else:
                pool = (k_pool, v_pool)
            full = (torch.randperm(nb - 1, generator=gen, device=dev)[:b * mb]
                    + 1).reshape(b, mb).to(torch.int32)
            full[0] = 0
            window = full[:, :wb]
            pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
            q = randn(b, nq, d)
            args = (q, *pool, window, pos)
            out = wrappers[name](*args)
            torch.cuda.synchronize()
            plain_args = (q, pool[0], pool[1], window, pos, *pool[2:])
            res = compare(out, TA._gather_decode_windowed, plain_args)
            agree = worst(agree, res)
            res["one_tile_short_rel_err"] = one_tile_short(
                name, TA._gather_decode_windowed, plain_args, 4)
            k_seq, v_seq = TA._gather_pool_seq(pool[0], pool[1], window,
                                               *pool[2:], dtype=bf)
            grp = nq // nkv
            k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            mask = (torch.arange(wb * bs, device=dev)[None, :]
                    <= pos[:, None])[:, None, None, :]
            q_l = q[:, :, None, :]
            kv_bytes = 2 * (d + 4) if q8 else 2 * d * 2
            blocks = sum(p // bs + 1 for p in pos_h)
            b_ms, b_by = bound(blocks * nkv * bs * kv_bytes + 2 * q.numel() * 2
                               + window.numel() * 4 + pos.numel() * 4,
                               sum(4 * nq * d * (p + 1) for p in pos_h))
            timings.append({
                "shape": f"{cfg.name} B={b} Nq={nq} Nkv={nkv} D={d} bs={bs} "
                         f"window={wb * bs} (table stride {mb}) NB={nb} "
                         f"pos={pos_h}",
                **res,
                **timed(torch, {
                    "ms": lambda: wrappers[name](*args),
                    "plain_ms": lambda: TA._gather_decode_windowed(
                        *plain_args),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        q_l, k_l, v_l, attn_mask=mask)}, flush),
                "bound_ms": b_ms, "bound_by": b_by})
            del k_pool, v_pool, pool, args, plain_args, k_seq, v_seq, k_l, v_l
        agrees(name, agree)
        first = timings[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{name}.cu",
            "replaces": ("distributed_llm_tpu/ops/pallas_attention.py:"
                         + ("776" if q8 else "673")),
            "shape": first["shape"] + f" (checked at {len(timings)} shapes)",
            **agree, "tol": TOL,
            **{k: first[k] for k in ("ms", "plain_ms", "library_ms", "eager",
                                     "bound_ms", "bound_by",
                                     "one_tile_short_rel_err")},
            "timings": timings,
            **({"previous_design": PREVIOUS_DESIGN_MS[name]}
               if name in PREVIOUS_DESIGN_MS else {})})
    del flush_buf
    note_variants(rows, paged_decode_variant_checks(torch, gen))
    note_variants(rows, paged_decode_variant_checks(torch, gen, SMALL_SHAPES),
                  prefix="d16_")
    torch.cuda.empty_cache()
    return rows


def paged_decode_variant_checks(torch, gen, shapes=SERVING_SHAPES) -> dict:
    """K7 and K8 at every instantiation they take (``shapes``: head dim and
    block pairs; GQA group 1/4/8) on small windows (1-3 of 24 table columns,
    read through the row stride, and all 24): an idle slot, position 0,
    mid-block and the window's last position; then frontiers on the last
    key of K8's first split (``ragged_decode_split_plan`` over the window:
    1 or 2 blocks a split here) and on the first key past it.  Returns the
    worst ``compare`` per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    wrappers = kernel_wrappers()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("paged_decode", "paged_decode_q8")}
    for d, bs in shapes:
        for nq, nkv in ((32, 8), (16, 2), (8, 8)):
            b, mb = 4, 24
            nb = b * mb + 1
            kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
            kq, ks = quant.quantize_kv_rows(kp)
            vq, vs = quant.quantize_kv_rows(vp)
            full = (torch.randperm(nb - 1, generator=gen, device=dev)
                    + 1)[:b * mb].reshape(b, mb).to(torch.int32)
            full[0] = 0
            q = randn(b, nq, d)
            for wb in (1, 2, 3, mb):
                window = full[:, :wb]
                edge = TR.ragged_decode_split_plan(wb, b, nkv)[0] * bs
                last = wb * bs - 1
                for pos_h in ([0, 0, (wb - 1) * bs + bs // 2, last],
                              [0, min(edge - 1, last), min(edge, last),
                               last]):
                    pos = torch.tensor(pos_h, dtype=torch.int32,
                                       device=dev)
                    for name, pool in (("paged_decode", (kp, vp)),
                                       ("paged_decode_q8",
                                        (kq, vq, ks, vs))):
                        out = wrappers[name](q, *pool, window, pos)
                        errs[name] = worst(errs[name], compare(
                            out, TA._gather_decode_windowed,
                            (q, pool[0], pool[1], window, pos,
                             *pool[2:])))
    return errs


# -- W1: the int8-weight product ------------------------------------------------

# The products' row counts: one row (the sequential engines), orin's 4 and
# nano's 8 slots, orin's verify round (4 x 5), two rounds' worth and the
# decode regime's 64; then the wide regime's: the prefill buckets and the
# 256-row chunks.
W8_ROWS = (1, 4, 8, 20, 40, 64, 128, 256, 512, 1024, 2048)
W8_TIMED = ("orin_8b", "w_gate/w_up", 4)       # decode's headline shape
W8_WIDE_TIMED = ("orin_8b", "w_gate/w_up", 256)  # wide's: one 256-row chunk
# Products of each shape in one layer of a decode step's body, and the
# layer's W1 launches (q/k/v grouped, wo, gate/up grouped, down).
W8_PER_LAYER = {"wq/wo": 2, "wk/wv": 2, "w_gate/w_up": 2, "w_down": 1}
W8_LAUNCHES_PER_LAYER = 4
# Replays a W1 timing averages (graph_ms's default is 20; 132 launches of
# 88 shapes and 44 groups are timed three ways).
W8_ITERS = 10
# Repeats of a decode step's timings within one run (``w8_step_times``).
W8_STEP_REPEATS = 5
# Rounds of the overlapping-launch check (``w8_overlap_check``).
W8_OVERLAP_ROUNDS = 20


def w8_shapes(cfg) -> dict:
    """A model's projection shapes (K, N), each named by the weights that
    share it (nano_1b's and orin_8b's query width is their hidden width)."""
    h, f = cfg.hidden_size, cfg.ffn_size
    require(cfg.num_heads * cfg.head_dim == h, f"{cfg.name}: wq is not square")
    return {"wq/wo": (h, h), "wk/wv": (h, cfg.num_kv_heads * cfg.head_dim),
            "w_gate/w_up": (h, f), "w_down": (f, h)}


def w8_kernel_phase(torch, nano, orin):
    """W1 (``ops.quant.w8_matmul``, ``csrc/w8_matmul.cu``) at every
    full-width projection shape of nano_1b and orin_8b for every row count
    of W8_ROWS (the decode regime up to 64 rows, the wide one above): x
    bf16 N(0, 1), a bf16 N(0, 0.02) weight quantized by
    ``quant.quantize_tensor``; every output row within KERNEL_REL_TOL of
    the plain version in float32 ((x @ q) * s in float32), and the output
    of the launch replayed in a CUDA graph equal bit for bit to the eager
    one.  The grouped launches (``quant.w8_matmul_many``: q/k/v, gate/up)
    at every row count: each output equal bit for bit to its lone launch,
    eagerly and replayed.  Each shape and row count is timed as a replayed
    CUDA graph beside the cast route (cast + ``torch.matmul`` + scale,
    ``plain_ms``), cuBLAS bf16 on the unquantized weight
    (``cublas_bf16_ms``) and the bound: bytes (K N + 2 N + 2 M K + 2 M N)
    at 3.35 TB/s or operations (2 M K N) at 989 TFLOP/s.  The headlines
    are orin_8b's w_gate at 4 rows (decode) and at 256 (wide), with eager
    times and, where this torch has it on the card, one
    ``torch._weight_int8pack_mm`` call on the transposed int8 weight as
    the library yardstick (timed here only).  Also one decode step's
    products per model at its tier's slots, launched as the port launches
    them (grouped) and one by one, with the launches a step takes."""
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    bf = torch.bfloat16
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def replayed(fn):
        """(graph ms, the replays' output) of ``fn``."""
        out = []
        ms = graph_ms(torch, fn, iters=W8_ITERS, flush=flush, out=out)
        return ms, out[0]

    shapes, groups, errs, timed = [], [], NO_ERR, {}
    for cfg in (nano, orin):
        weights = {}
        for name, (k, n) in w8_shapes(cfg).items():
            weights[name] = quant.quantize_tensor(
                (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(bf))
        for name, (k, n) in w8_shapes(cfg).items():
            w = weights[name]
            wb = quant.dequantize(w)
            for m in W8_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).to(bf)
                out = quant.w8_matmul(x, w.q, w.s)
                torch.cuda.synchronize()
                res = compare(out, quant._matmul_plain, (x, w.q, w.s))
                where = f" at {cfg.name} {name} M={m}"
                agrees("w8_matmul", res, where)
                errs = worst(errs, res)
                b, by = bound(k * n + 2 * n + 2 * m * k + 2 * m * n,
                              2 * m * k * n)
                ms, rep = replayed(lambda: quant.w8_matmul(x, w.q, w.s))
                require(torch.equal(rep, out),
                        f"w8_matmul: replayed output differs{where}")
                calls = {"plain_ms": lambda: quant._matmul_plain(x, w.q, w.s),
                         "cublas_bf16_ms": lambda: x @ wb}
                plan = quant.w8_plan(m, [(k, n)], quant._sm_count(dev))
                entry = {"model": cfg.name, "weight": name, "K": k, "N": n,
                         "M": m, "regime": quant.w8_route(x),
                         "plan": {"tile": [plan.bm, plan.bn],
                                  "chunks": list(plan.chunks[0]),
                                  "items": plan.total_items,
                                  "grid": plan.grid},
                         "ms": ms,
                         **{key: graph_ms(torch, fn, iters=W8_ITERS,
                                          flush=flush)
                            for key, fn in calls.items()},
                         "bound_ms": b, "bound_by": by, **res}
                shapes.append(entry)
                for head in (W8_TIMED, W8_WIDE_TIMED):
                    if (cfg.name, name, m) == head:
                        timed[head] = dict(entry, res=res, eager={
                            key: time_ms(torch, fn, flush=flush)
                            for key, fn in (("ms", lambda: quant.w8_matmul(
                                x, w.q, w.s)), *calls.items())},
                            library=w8_library(torch, x, w, flush))
            del wb
        # The grouped launches: q/k/v (wk's weight twice for wk and wv)
        # and gate/up (the gate weight twice).
        for gname, names in (("qkv", ("wq/wo", "wk/wv", "wk/wv")),
                             ("gate_up", ("w_gate/w_up", "w_gate/w_up"))):
            pairs = [(weights[nm].q, weights[nm].s) for nm in names]
            k = pairs[0][0].shape[0]
            for m in W8_ROWS:
                x = torch.randn(m, k, generator=gen, device=dev).to(bf)
                outs = quant.w8_matmul_many(x, pairs)
                lone = [quant.w8_matmul(x, q, s) for q, s in pairs]
                torch.cuda.synchronize()
                where = f" at {cfg.name} {gname} M={m}"
                require(all(torch.equal(a, b) for a, b in zip(outs, lone)),
                        f"w8_matmul: a grouped output differs from its lone "
                        f"launch{where}")
                ms, rep = replayed(lambda: quant.w8_matmul_many(x, pairs))
                require(all(torch.equal(a, b) for a, b in zip(rep, outs)),
                        f"w8_matmul: replayed grouped output differs{where}")
                if (cfg is nano and gname == "qkv" and m == 8):
                    w8_overlap_check(torch, quant, x, pairs, outs)
                at = {e["weight"]: e["ms"] for e in shapes
                      if e["model"] == cfg.name and e["M"] == m}
                groups.append({"model": cfg.name, "group": gname, "M": m,
                               "ms": ms,
                               "lone_ms": sum(at[nm] for nm in names)})
        del weights
    steps = {}
    for cfg, m in ((nano, 8), (orin, 4)):
        at = {e["weight"]: e for e in shapes
              if e["model"] == cfg.name and e["M"] == m}
        grp = {g["group"]: g["ms"] for g in groups
               if g["model"] == cfg.name and g["M"] == m}
        steps[cfg.name] = {
            "M": m,
            "ms": cfg.num_layers * (grp["qkv"] + at["wq/wo"]["ms"]
                                    + grp["gate_up"] + at["w_down"]["ms"]),
            "lone_ms": cfg.num_layers * sum(
                W8_PER_LAYER[w] * at[w]["ms"] for w in W8_PER_LAYER),
            "launches_per_step": cfg.num_layers * W8_LAUNCHES_PER_LAYER,
            **{key: cfg.num_layers * sum(
                W8_PER_LAYER[w] * at[w][key] for w in W8_PER_LAYER)
                for key in ("plain_ms", "cublas_bf16_ms", "bound_ms")}}
        steps[cfg.name].update(w8_step_times(torch, quant, cfg, m, gen,
                                             flush))
    del flush_buf
    torch.cuda.empty_cache()

    def headline(t):
        lib_ms, lib_eager, lib_err = t["library"]
        return {"shape": f"{t['model']} {t['weight']} K={t['K']} N={t['N']} "
                         f"M={t['M']}",
                **t["res"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "cublas_bf16_ms": t["cublas_bf16_ms"], "library_ms": lib_ms,
                "library_rel_err": lib_err,
                "eager": dict(t["eager"], library_ms=lib_eager),
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "plan": t["plan"]}

    dec = headline(timed[W8_TIMED])
    wide = headline(timed[W8_WIDE_TIMED])
    return {
        "name": "w8_matmul", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/w8_matmul.cu",
        "replaces": "distributed_llm_tpu/ops/quant.py:77",
        "replaces_note": "W1: the port's counterpart of XLA's fused "
                         "convert-and-dot in quant.matmul; no Pallas kernel",
        **dec, "tol": TOL,
        "shape": f"{dec['shape']} (checked at every projection of nano_1b "
                 f"and orin_8b, M in {list(W8_ROWS)}, single and grouped, "
                 f"eager and replayed)",
        "wide": wide,
        "variants_max_abs_err": errs["max_abs_err"],
        "variants_rel_err": errs["rel_err"],
        "replay_bit_equal": True, "grouped_bit_equal": True,
        "decode_step_products": steps, "shapes": shapes, "groups": groups}


def w8_overlap_check(torch, quant, x, pairs, want):
    """Split launches that overlap on the card: a grouped launch captured
    as a CUDA graph and replayed on one stream while the same launch runs
    eagerly on another, W8_OVERLAP_ROUNDS rounds, every output equal bit
    for bit to ``want``.  Each launch's fix-up counters are its own (from
    the allocator, or the graph's pool), so no interleaving of the two
    streams' blocks can mix their counts."""
    plan = quant.w8_plan(x.shape[0], [tuple(q.shape) for q, _ in pairs],
                         quant._sm_count(x.device))
    require(plan.part_floats > 0, "w8_matmul: the overlap check's launch "
            "does not split")
    cur = torch.cuda.current_stream()
    side_a, side_b = torch.cuda.Stream(), torch.cuda.Stream()
    side_a.wait_stream(cur)
    with torch.cuda.stream(side_a):
        quant.w8_matmul_many(x, pairs)
    cur.wait_stream(side_a)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rep = quant.w8_matmul_many(x, pairs)
    torch.cuda.synchronize()
    replays, eager = [], []
    side_a.wait_stream(cur)
    side_b.wait_stream(cur)
    for _ in range(W8_OVERLAP_ROUNDS):
        with torch.cuda.stream(side_a):
            graph.replay()
            replays.append([y.clone() for y in rep])
        with torch.cuda.stream(side_b):
            eager.append(quant.w8_matmul_many(x, pairs))
    torch.cuda.synchronize()
    del graph
    for i, outs in enumerate(replays + eager):
        require(all(torch.equal(a, b) for a, b in zip(outs, want)),
                f"w8_matmul: an overlapping launch's output differs "
                f"(round {i % W8_OVERLAP_ROUNDS}, "
                f"{'replayed' if i < W8_OVERLAP_ROUNDS else 'eager'})")


def w8_step_times(torch, quant, cfg, m, gen, flush):
    """A decode step's W1 products at ``m`` rows, timed two ways, each
    repeated W8_STEP_REPEATS times in this run.  ``step_graph_ms``: the
    step's 4 L launches (q/k/v grouped, wo, gate/up grouped, down) over L
    = ``cfg.num_layers`` layers of distinct random int8 weights, so each
    layer reads its own bytes as a served step does, captured as one CUDA
    graph and replayed W8_ITERS times after one L2 flush each; the min,
    median and max over every replay, and each repeat's mean.
    ``summed_ms_repeats``: the summed method of ``decode_step_products``
    (L times the four launches of one layer, each its own graph, replayed
    after a flush each), repeated.  The graph's outputs equal the eager
    launches' bit for bit."""
    h, f = cfg.hidden_size, cfg.ffn_size
    dev = torch.device("cuda")
    bf = torch.bfloat16
    widths = {"wq": h, "wk": cfg.num_kv_heads * cfg.head_dim,
              "wo": h, "w_gate": f, "w_down": h}
    widths["wv"], widths["w_up"] = widths["wk"], widths["w_gate"]

    def weight(k, n):
        q = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                          generator=gen, device=dev)
        s = (torch.rand(1, n, generator=gen, device=dev) * 1e-3
             + 1e-4).to(bf)
        return q, s

    layers = [{name: weight(f if name == "w_down" else h, n)
               for name, n in widths.items()}
              for _ in range(cfg.num_layers)]
    x = torch.randn(m, h, generator=gen, device=dev).to(bf)
    xf = torch.randn(m, f, generator=gen, device=dev).to(bf)

    def layer_launches(lw):
        return [lambda: quant.w8_matmul_many(
                    x, [lw["wq"], lw["wk"], lw["wv"]]),
                lambda: [quant.w8_matmul(x, *lw["wo"])],
                lambda: quant.w8_matmul_many(x, [lw["w_gate"], lw["w_up"]]),
                lambda: [quant.w8_matmul(xf, *lw["w_down"])]]

    def step():
        return [y for lw in layers for fn in layer_launches(lw)
                for y in fn()]

    want = step()
    replays, means, summed = [], [], []
    for _ in range(W8_STEP_REPEATS):
        out = []
        means.append(graph_ms(torch, step, iters=W8_ITERS, flush=flush,
                              out=out, times=replays))
        require(all(torch.equal(a, b) for a, b in zip(out[0], want)),
                f"w8_matmul: {cfg.name}'s replayed step differs from its "
                f"eager launches")
        summed.append(cfg.num_layers * sum(
            graph_ms(torch, fn, iters=W8_ITERS, flush=flush)
            for fn in layer_launches(layers[0])))
    del layers, want
    ordered = sorted(replays)
    return {"step_graph_ms": {"min": ordered[0],
                              "median": statistics.median(ordered),
                              "max": ordered[-1], "repeats": means},
            "summed_ms_repeats": summed}


def w8_library(torch, x, w, flush):
    """One PyTorch call computing W1's function: ``_weight_int8pack_mm``
    on the transposed int8 weight and the scales, where this torch has it
    on the card.  Returns (graph ms, eager ms, worst-row error against the
    float32 plain version) or Nones."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, None, None
    qt, s = w.q.t().contiguous(), w.s.reshape(-1).contiguous()
    try:
        out = fn(x, qt, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"w8_matmul: no library yardstick ({type(exc).__name__}: "
            f"{str(exc)[:120]})")
        return None, None, None
    ref = (x.float() @ w.q.float()) * w.s.float()
    return (graph_ms(torch, lambda: fn(x, qt, s), flush=flush),
            time_ms(torch, lambda: fn(x, qt, s), flush=flush),
            row_rel_err(out, ref))


def serve_summary(serve: dict) -> dict:
    """A served phase's numbers a debugging run prints."""
    return {k: serve[k] for k in (
        "cold_ttft_ms", "chunked_ttft_ms", "long_prompt_tokens", "w8_routes",
        "launches_per_request", "plain_calls", "main_path_s")}


def w8_summary(row: dict) -> dict:
    """The W1 row's numbers a debugging run prints: the headlines, the
    decode steps, and each shape's ms, cast-route ms, cuBLAS bf16 ms and
    bound."""
    keys = ("ms", "plain_ms", "cublas_bf16_ms", "library_ms", "bound_ms",
            "rel_err", "plan")
    return {"decode": {k: row[k] for k in keys}, "wide": {
        k: row["wide"][k] for k in keys},
        "steps": row["decode_step_products"],
        "shapes": [[e["model"], e["weight"], e["M"], round(e["ms"], 4),
                    round(e["plain_ms"], 4), round(e["cublas_bf16_ms"], 4),
                    round(e["bound_ms"], 4)] for e in row["shapes"]],
        "groups": [[g["model"], g["group"], g["M"], round(g["ms"], 4),
                    round(g["lone_ms"], 4)] for g in row["groups"]]}


# -- phases 4-6: serve ------------------------------------------------------------

def post(url: str, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def query(base: str, q, **extra) -> dict:
    status, text = post(base + "/query", {"query": q, "stats": True,
                                          "num_predict": SERVE_MAX_NEW, **extra})
    require(status == 200, f"/query returned {status}: {text}")
    body = json.loads(text)
    require(isinstance(body.get("response"), str) and body["response"].strip(),
            f"/query returned an empty reply: {body}")
    return body


WORDS = ("rivers lakes mountains oceans deltas weather systems clouds rain "
         "snow glaciers valleys forests deserts islands coasts tides storms "
         "winds seasons").split()


def words(n: int, offset: int = 0) -> str:
    return " ".join(WORDS[(i + offset) % len(WORDS)] for i in range(n))


def kernel_wrappers():
    """Every kernel's wrapper, by the kernel's name (its source's stem)."""
    from distributed_llm_tpu_torch.ops import launches
    return launches.wrappers()


def plain_versions():
    """The plain version of every kernel (none may run on a main path):
    the plain paths but the int8 suffix chunk, which has no kernel."""
    from distributed_llm_tpu_torch.ops import launches
    return tuple(fn for name, fn in launches.plain_paths().items()
                 if name != "_dequant_chunk_paged")


@contextlib.contextmanager
def http_served(app):
    """``app`` behind a threaded WSGI server on 127.0.0.1: yields its base
    URL, then shuts the server down."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from distributed_llm_tpu_torch.utils.webapp import _ThreadingWSGIServer

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):       # no per-request access log
            pass

    server = make_server("127.0.0.1", 0, app, server_class=_ThreadingWSGIServer,
                         handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def fresh_peak(torch, on_card: bool) -> None:
    """Collect the previous phase's engines, so the peak-memory count that
    follows is this phase's."""
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def served(torch, tier, device: str = "cuda"):
    """``tier`` built and warmed under EngineManager (startup timed) behind
    its /query app on 127.0.0.1: yields (engine, base URL, startup
    seconds), then stops the server and the engine."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app

    fresh_peak(torch, device == "cuda")
    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, device=device)
    manager.start_server()                   # build + warm (one request)
    startup_s = time.perf_counter() - t0
    try:
        with http_served(create_tier_app(tier.name, manager=manager)) as base:
            yield manager.engine(), base, startup_s
    finally:
        manager.stop_server()


# The admission stages' programs: the stages a chunk or a prefix hit runs
# (JAX warms all of them), and every stage an admission runs.
WARM_STAGES = ("chunk_prefill", "writer:cow_copy", "writer:cow_copy_draft",
               "draft:chunk")
ADMISSION_STAGES = ("prefill", "chunk_prefill", "writer", "draft")
# The sequential engines' programs JAX leaves out of its warm set, so the
# only ones that may be built after ``warmup()``: the grow copies (JAX
# compiles ``_grow_fn`` at a conversation's first outgrown rung).
SEQ_COLD_STAGES = ("grow",)


def _stage_name(stage: str, key) -> str:
    """``stage``, or ``stage:kind`` for the named keys (the copies, the
    draft's stages)."""
    if isinstance(key, str):
        return f"{stage}:{key}"
    if isinstance(key, tuple) and isinstance(key[0], str):
        return f"{stage}:{key[0]}"
    return stage


def _seq_stage(key) -> str:
    """A sequential engine's program family by its JAX key: ``decode``
    (a rung), ``prefill`` ((bucket, rung)), or the key's kind (``init``,
    ``grow``, ``suffix``, ``loop``, ``round``)."""
    if isinstance(key, int):
        return "decode"
    return "prefill" if isinstance(key[0], int) else key[0]


class AdmissionAudit:
    """What the engines built inside ``admission_audit`` did: each
    program body run eagerly outside a capture (by stage), each program
    built (tier, stage, key, whether its engine is sequential and had
    warmed up), each spill copy's key first seen (``_note_spill``), each
    engine's device memory before and after its warmup, and the seconds
    each tier's captures took."""

    def __init__(self):
        self.eager: dict = {}
        self.built: list = []
        self.spill: list = []
        self.warmup: list = []
        # The engines themselves, weakly: an engine built later may take a
        # dead warmed engine's id(), and its first-use builds must not
        # count as built after a warmup it never ran.
        self.warmed = weakref.WeakSet()
        self.capture_s: dict = {}
        self._mark = (0, {}, 0)

    def mark(self) -> None:
        """The main path starts: what follows is read by ``main_path``."""
        self._mark = (len(self.built), dict(self.eager), len(self.spill))

    def main_path(self, on_card: bool) -> dict:
        """Since ``mark``: the bodies run eagerly, the programs built after
        their engine's warmup and the spill copies' keys.  On the card, no
        body may have run outside a capture (every admission stage, tick
        and sequential stage replayed a graph) and no chunk, prefix-hit or
        copy-on-write program of a batched engine, nor any sequential
        program but SEQ_COLD_STAGES', may have been built mid-serve
        (warmup builds JAX's warm set).  A batched prefill bucket, a
        writer or a dense rung built on first use is allowed (a replay's
        bucket among them), as the JAX engine compiles them.  The spill
        copies (demote gathers, promote writes) run eagerly by design:
        they are no program, so none may reach ``_note_compile``, and
        they are listed apart."""
        n, eager0, n_spill = self._mark
        eager = {k: v - eager0.get(k, 0) for k, v in self.eager.items()
                 if v != eager0.get(k, 0)}
        mid = [b for b in self.built[n:] if b["after_warmup"]]
        late = [b for b in mid if (b["stage"] not in SEQ_COLD_STAGES
                                   if b["sequential"]
                                   else b["stage"] in WARM_STAGES)]
        require(not [b for b in self.built if b["stage"] == "spill"],
                "a spill copy was built as a program")
        if on_card:
            require(not eager, f"program bodies ran eagerly on the main "
                    f"path: {eager}")
            require(not late, f"warm-set programs built mid-serve: {late}")
        return {"eager_body_runs": eager,
                "built_mid_serve": [f"{b['tier']} {b['stage']} {b['key']}"
                                    for b in mid],
                "jax_cold_stages": list(SEQ_COLD_STAGES),
                "spill_copies": len(self.spill) - n_spill,
                "spill_keys": sorted({f"{s['tier']} {s['key']}"
                                      for s in self.spill[n_spill:]})}


@contextlib.contextmanager
def admission_audit(torch, on_card: bool):
    """Watch the batched and sequential engines built inside
    (``AdmissionAudit``)."""
    from distributed_llm_tpu_torch.engine import batching
    from distributed_llm_tpu_torch.engine.inference import InferenceEngine
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine

    names = ("_body", "_capture", "_note_compile", "warmup")
    real = {(cls, name): getattr(cls, name)
            for cls in (batching.ContinuousBatchingEngine, InferenceEngine,
                        SpeculativeEngine)
            for name in names + (("_note_spill",)
                                 if cls is batching.ContinuousBatchingEngine
                                 else ())}
    audit = AdmissionAudit()
    local = threading.local()

    def memory():
        if not on_card:
            return None
        return {"allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}

    def patches(cls, seq: bool) -> dict:
        def stage_of(args):
            return (_seq_stage(args[0]) if seq
                    else _stage_name(args[0], args[1]))

        def body(self, *args):
            fn = real[cls, "_body"](self, *args)
            stage = _seq_stage(args[0]) if seq else args[0]

            def run():
                if not getattr(local, "capturing", False):
                    audit.eager[stage] = audit.eager.get(stage, 0) + 1
                return fn()
            return run

        def capture(self, fn):
            local.capturing = True
            t0 = time.perf_counter()
            try:
                return real[cls, "_capture"](self, fn)
            finally:
                local.capturing = False
                name = self.tier.name
                audit.capture_s[name] = (audit.capture_s.get(name, 0.0)
                                         + time.perf_counter() - t0)

        def note_compile(self, *args):
            audit.built.append({"tier": self.tier.name,
                                "stage": stage_of(args), "key": args[0],
                                "sequential": seq,
                                "after_warmup": self in audit.warmed})
            return real[cls, "_note_compile"](self, *args)

        def warmup(self):
            before = memory()
            real[cls, "warmup"](self)
            audit.warmed.add(self)
            audit.warmup.append({"tier": self.tier.name,
                                 "model": self.tier.model_preset,
                                 "before": before, "after": memory(),
                                 "programs": len(self._programs)})

        out = {"_body": body, "_capture": capture,
               "_note_compile": note_compile, "warmup": warmup}
        if not seq:
            def note_spill(self, kind, n):
                audit.spill.append({"tier": self.tier.name, "key": (kind, n)})
                return real[cls, "_note_spill"](self, kind, n)
            out["_note_spill"] = note_spill
        return out

    own = {(cls, name) for cls, name in real if name in vars(cls)}
    for cls in {cls for cls, _ in real}:
        seq = cls is not batching.ContinuousBatchingEngine
        for name, fn in patches(cls, seq).items():
            setattr(cls, name, fn)
    try:
        yield audit
    finally:
        for (cls, name), fn in real.items():
            if (cls, name) in own:
                setattr(cls, name, fn)
            else:                       # inherited: uncover the base's
                delattr(cls, name)


# W1's launches by regime, summed over every main path ``read_counts``
# reads (the kernel row's ``launches_by_route``), and the last one read.
W8_ROUTES = {"decode": 0, "wide": 0}
W8_LAST = {"decode": 0, "wide": 0}


def reset_counts() -> None:
    """Every kernel's launch count (the bf16 chunk kernel's by route and
    W1's by regime too) and every plain version's call count (the int8
    suffix chunk's and W1's cast route's too) set to 0, just before a main
    path."""
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import launches
    from distributed_llm_tpu_torch.ops import quant as TQ
    for fn in kernel_wrappers().values():
        fn.launches = 0
    TF.flash_chunk_attention.route_launches = {"split": 0, "tc": 0}
    TQ.w8_matmul.route_launches = {"decode": 0, "wide": 0}
    for fn in launches.plain_paths().values():
        fn.calls = 0


def read_counts(expect, on_card: bool):
    """(launches by kernel, calls by plain version) since ``reset_counts``:
    every kernel in ``expect`` must have launched and, on the card, no
    plain version may have run (W1's cast route, ``_matmul_plain`` on a
    CUDA tensor, among them)."""
    from distributed_llm_tpu_torch.ops import quant as TQ
    launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
    plain_calls = {fn.__name__: fn.calls for fn in plain_versions()}
    require(all(launches[name] > 0 for name in expect),
            f"a kernel did not run on the main path: {launches}")
    require(not on_card or not any(plain_calls.values()),
            f"a plain version ran on the main path: {plain_calls}")
    for route, n in TQ.w8_matmul.route_launches.items():
        W8_ROUTES[route] += n
        W8_LAST[route] = n
    return launches, plain_calls


def drive(base: str, *, long_words: int, lengths, hits=None,
          repeat: bool = False) -> dict:
    """The main path's requests over HTTP: /health, a cold prompt (with
    ``repeat``, twice: greedy must repeat itself), a prompt of
    ``long_words`` words, a multi-turn follow-up of the first (``hits()``,
    where given, must grow across it: the parked prefix was reused),
    ``len(lengths)`` concurrent requests of skewed length and one stream.
    Returns the replies, the burst's wall time and the request count."""
    with urllib.request.urlopen(base + "/health", timeout=30) as resp:
        require(resp.status == 200 and json.loads(resp.read())["ok"],
                "/health not ok")
    turn1 = [{"role": "user", "content": "tell me about " + words(12)}]
    first = query(base, turn1)
    if repeat:
        again = query(base, turn1)
        require(first["response"] == again["response"],
                "the same greedy prompt gave two different replies")
    long_reply = query(base, "summarise: " + words(long_words, 3))
    hits0 = hits() if hits else 0
    turn2 = turn1 + [{"role": "assistant", "content": first["response"]},
                     {"role": "user", "content": "and " + words(6, 5) + "?"}]
    query(base, turn2)
    require(hits is None or hits() > hits0,
            "the follow-up did not reuse the parked prefix")
    results = [None] * len(lengths)

    def worker(i, n):
        results[i] = query(base, f"request {i}: " + words(n, i))

    threads = [threading.Thread(target=worker, args=(i, n))
               for i, n in enumerate(lengths)]
    t_burst = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    burst_s = time.perf_counter() - t_burst
    require(all(r is not None for r in results),
            "a concurrent request did not complete")
    status, text = post(base + "/query/stream",
                        {"query": "stream about " + words(10, 7),
                         "num_predict": SERVE_MAX_NEW})
    events = [json.loads(line[6:]) for line in text.split("\n")
              if line.startswith("data: ")]
    require(status == 200 and events and events[-1].get("done")
            and events[-1]["tokens"] > 0
            and "".join(e.get("delta", "") for e in events).strip(),
            f"/query/stream failed: {text[:500]}")
    return {"first": first, "long": long_reply, "burst": results,
            "burst_s": burst_s, "requests": 4 + int(repeat) + len(lengths)}


def serve_numbers(tier, engine, startup_s: float, main_s: float, drove: dict,
                  launches: dict, plain_calls: dict) -> dict:
    """What every serve phase reports of its main path."""
    results, n = drove["burst"], drove["requests"]
    gen_tokens = sum(r["stats"]["gen_tokens"] for r in results)
    ttfts = [r["stats"]["ttft_ms"] for r in results]
    decode_tps = [(r["stats"]["gen_tokens"] - 1) * 1e3
                  / (r["stats"]["total_ms"] - r["stats"]["ttft_ms"])
                  for r in results if r["stats"]["gen_tokens"] > 1]
    return {
        "tier": tier.name, "model": tier.model_preset,
        "engine": type(engine).__name__, "quantize": tier.quantize,
        "kv_quantize": tier.kv_quantize,
        "startup_s": startup_s, "main_path_s": main_s,
        "requests": n, "launches": launches, "plain_calls": plain_calls,
        "launches_per_request": {k: v / n for k, v in launches.items() if v},
        "w8_routes": dict(W8_LAST),
        "concurrent": {"requests": len(results), "wall_s": drove["burst_s"],
                       "gen_tokens": gen_tokens,
                       "tokens_per_s": gen_tokens / drove["burst_s"],
                       "decode_tokens_per_s": decode_tps,
                       "p50_ttft_ms": statistics.median(ttfts),
                       "ttft_ms": ttfts,
                       "prompt_tokens": [r["stats"]["prompt_tokens"]
                                         for r in results]},
        "cold_ttft_ms": drove["first"]["stats"]["ttft_ms"],
        "chunked_ttft_ms": drove["long"]["stats"]["ttft_ms"],
        "long_prompt_tokens": drove["long"]["stats"]["prompt_tokens"],
    }


def peak_memory_gb(torch, on_card: bool):
    return torch.cuda.max_memory_allocated() / 1e9 if on_card else None


def serve_phase(torch, tier, *, lengths, expect, repeat=False, sampled=False,
                device: str = "cuda"):
    """Serve a batched tier over HTTP (``drive``: the long prompt is past
    one 256-token chunk, the follow-up hits the parked blocks) and, with
    ``sampled``, one request at temperature 0.8.  Every kernel in
    ``expect`` must launch and no plain version may run; with speculation
    on, drafts must have been made.  Then the numerics checks on the live
    pool and the decode step's breakdown.  Returns (serve numbers,
    launches by kernel)."""
    from distributed_llm_tpu_torch.ops import attention as TA

    on_card = device == "cuda"
    with admission_audit(torch, on_card) as audit, \
            served(torch, tier, device) as (engine, base, startup_s):
        reset_counts()
        audit.mark()
        spec0 = engine.spec_stats()
        t_main = time.perf_counter()
        drove = drive(base, long_words=420, lengths=lengths, repeat=repeat,
                      hits=lambda: engine.prefix_cache.stats()["hits_shared"])
        require(drove["long"]["stats"]["prompt_tokens"] > 256,
                f"long prompt only {drove['long']['stats']['prompt_tokens']} "
                f"tokens")
        if sampled:
            # A sampled request rides γ=0 beside the greedy slots.
            query(base, "imagine " + words(8, 2), temperature=0.8)
            drove["requests"] += 1
        main_s = time.perf_counter() - t_main
        launches, plain_calls = read_counts(expect, on_card)
        admission = audit.main_path(on_card)
        int8_chunk_calls = TA._dequant_chunk_paged.calls
        spec = engine.spec_stats()
        drafted = spec["drafted_total"] - spec0["drafted_total"]
        accepted = spec["accepted_total"] - spec0["accepted_total"]
        if engine.spec:
            require(drafted > 0, f"speculation drafted nothing: {spec}")
        serve = serve_numbers(tier, engine, startup_s, main_s, drove, launches,
                              plain_calls)
        serve.update({
            "draft": tier.draft_preset if engine.spec else None,
            "int8_chunk_calls": int8_chunk_calls,
            "tick_stats": engine.tick_stats(),
            "spec": ({"drafted": drafted, "accepted": accepted,
                      "accept_ratio": accepted / drafted if drafted else None,
                      "slot_gammas_at_end": spec["slot_gammas"]}
                     if engine.spec else None),
            "decode_logits_check": logits_check(torch, engine),
            "verify_check": verify_check(torch, engine) if engine.spec else None,
            "decode_step": paged_step_breakdown(torch, engine) if on_card else None,
            "tick_graph_check": tick_graph_check(torch, engine),
            "prefill_graph_check": prefill_graph_check(torch, engine),
            "admission": dict(admission, warmup_memory=audit.warmup),
            "verify_step": (verify_step_breakdown(torch, engine)
                            if on_card and engine.spec else None),
            "peak_memory_gb": peak_memory_gb(torch, on_card)})
        return serve, launches


def _live_decode_state(torch, engine, spare=()):
    """Every slot continuing the longest parked conversation by one token:
    (tables, pos, cur, length) for decode_step_paged on the live pool;
    ``spare`` blocks follow the parked ones in every table row."""
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    blocks = list(entry.cache["blocks"]) + list(spare)
    n = len(entry.ids)
    b = engine.paged.max_slots
    tables = torch.zeros((b, engine.paged.blocks_per_slot), dtype=torch.int32)
    tables[:, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    pos = torch.full((b,), n - 1, dtype=torch.int32)
    cur = torch.full((b,), entry.ids[-1], dtype=torch.long)
    return (tables.to(engine.device), pos.to(engine.device),
            cur.to(engine.device), n)


@contextlib.contextmanager
def live_tick_state(torch, engine):
    """``engine``'s host state set for one tick continuing its longest
    parked conversation (every slot greedy, two spare blocks after the
    parked ones taking the new positions) and the tick's program (the
    speculative round at the top γ bucket on a speculating engine), its
    inputs staged: yields (program, restore_pools, stage, key, steps,
    position), where ``restore_pools`` puts the live pools (the target's
    and the draft's) back; the host state, the pools and the spare blocks are
    restored after."""
    from distributed_llm_tpu_torch.models.transformer import kv_shards

    spare = engine.allocator.alloc(2)
    require(spare is not None, "no spare blocks for the tick check")
    # Every pool, a sharded one's shards each.
    pools = kv_shards(engine.pool) + (kv_shards(engine.pool_d)
                                      if engine.spec else [])
    live = [kv_clone(p) for p in pools]
    host = [a.copy() for a in (engine._tables, engine._pos, engine._cur,
                               engine._temps, engine._caps)]

    def restore_pools():
        for pool, saved in zip(pools, live):
            for k in pool:
                pool[k].copy_(saved[k])

    try:
        tables, pos, cur, n = _live_decode_state(torch, engine, spare)
        for ix, row in enumerate(tables.cpu().numpy()):
            engine._set_table_row(ix, row)
        engine._pos[:] = n - 1
        engine._cur[:] = int(cur[0])
        engine._temps[:] = 0.0
        if engine.spec:
            stage, key = "spec", engine._gamma_buckets[-1]
            engine._caps[:] = key
            steps = key + 1
        else:
            stage, key = "decode", engine._tick_rung()
            steps = engine.steps_per_tick
        yield (engine._program(stage, key), restore_pools, stage, key, steps,
               n - 1)
        restore_pools()
    finally:
        for arr, saved in zip((engine._tables, engine._pos, engine._cur,
                               engine._temps, engine._caps), host):
            arr[:] = saved
        engine._tables_dirty = True
        engine.allocator.free(spare)
        del live


def tick_graph_check(torch, engine) -> dict:
    """One tick of ``engine`` through the tick program the engine replays
    and through the program's body run eagerly, from the same state and
    the same static inputs (``live_tick_state``).  Each run starts from
    the live pools, restored after; the tokens must be ``torch.equal``.
    On the card the replayed tick is then timed (10 replays between two
    CUDA events, and on the host's clock) beside the engine's program
    keys; ``step_replay_ms`` is a tick's device time over its steps."""
    progs = engine.tick_stats()["compiled"]
    with live_tick_state(torch, engine) as (prog, restore_pools, stage, key,
                                            steps, position):
        replayed = prog.run().clone()
        restore_pools()
        eager = prog.body().clone()
        restore_pools()
        require(torch.equal(replayed, eager),
                f"{engine.tier.name}: the replayed {stage} program "
                f"{key} gave other tokens than its body run eagerly")
        res = {"stage": stage, "key": key, "position": position,
               "graph": prog.graph is not None,
               "tokens_equal": True, "programs": progs}
        if engine.device.type == "cuda":
            iters = 10
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(iters):
                prog.run()
            end.record()
            end.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            res.update({"tick_replay_ms": start.elapsed_time(end) / iters,
                        "tick_replay_wall_ms": wall_ms, "steps": steps})
            res["step_replay_ms"] = res["tick_replay_ms"] / steps
    return res


# The admission programs' pool rows, replayed against their bodies run
# eagerly on the same inputs: the same kernels on the same bytes, so 0 is
# expected; the bound is one bf16 rounding step of the rows' largest
# magnitude (int8 values: one step).
ROW_ULP = 2.0 ** -8


def prefill_graph_check(torch, engine) -> dict:
    """Every admission program family of ``engine`` (the cold prefill of
    its smallest bucket with its writer, the cold chunk family's second
    chunk, the copy-on-write copy; each with the draft's twins on a
    speculating engine) built anew (captured, on the card) with prompt A
    staged, replayed with prompt B staged (another length, blocks, chunk
    frontier and copy pair), and its bodies run eagerly with B staged.
    The first tokens must be equal and the pool rows the family wrote
    within ROW_ULP of the eager ones (their max abs diff printed); the
    copy must have copied B's source block.  The pools and the engine's
    own programs are restored after each run."""
    from distributed_llm_tpu_torch.engine.batching import TickProgram

    bs = engine.paged.block_size
    bucket = engine._buckets[0]
    width = (engine.chunk_tokens if engine._chunk_gate(engine._buckets[-1])
             else engine._reuse_buckets[-1])
    start = width
    window = next(w for w in engine._chunk_windows if w >= start + width)
    nb = -(-(start + width) // bs)
    spare = engine.allocator.alloc(2 * nb)
    require(spare is not None, "no spare blocks for the prefill check")
    pools = [engine.pool] + ([engine.pool_d] if engine.spec else [])
    live = [{k: v.clone() for k, v in p.items()} for p in pools]

    def restore():
        for pool, saved in zip(pools, live):
            for k in pool:
                pool[k].copy_(saved[k])

    def rows(blocks):
        ix = torch.tensor(blocks, device=engine.device)
        return [p[name].index_select(2, ix) for p in pools
                for name in sorted(p)]

    reqs = []
    for i, (n_prompt, extra) in enumerate(((bucket * 5 // 8, width // 3),
                                           (bucket - 3, width - 5))):
        ids = engine.tokenizer.encode("explain " + words(2 * start, 5 * i))
        require(len(ids) >= start + extra, "the check's prompt is too short")
        reqs.append({"ids": ids, "n_prompt": n_prompt, "n": start + extra,
                     "blocks": spare[i * nb:(i + 1) * nb]})
    families = {
        "prefill": (
            lambda r: engine._prefill_first(r["ids"][:r["n_prompt"]], bucket,
                                            0.0, r["blocks"]),
            lambda r: r["blocks"][:bucket // bs]),
        "chunk": (
            lambda r: engine._chunk_first(r["ids"][start:r["n"]], width,
                                          start, r["n"], r["blocks"],
                                          window, 0.0, draft=engine.spec),
            lambda r: r["blocks"][start // bs:]),
        "cow": (
            lambda r: engine._cow_copy(r["blocks"][0], r["blocks"][1]),
            lambda r: [r["blocks"][1]])}
    programs, make = engine._programs, engine._make_program
    engine._note_compile = lambda stage, key: None
    out = {"bucket": bucket, "chunk": [width, window, start],
           "graph": engine.device.type == "cuda",
           "bound": f"|replay - eager| <= {ROW_ULP:g} x max|eager| "
                    "(int8 values: 1)"}
    try:
        for name, (run, written) in families.items():
            a, b = reqs
            engine._programs = {}
            run(a)                       # built with A's inputs staged
            keys = sorted(map(str, engine._programs))
            restore()
            got = run(b)                 # the same programs, B's inputs
            got_rows = rows(written(b))
            if name == "cow":
                src = rows([b["blocks"][0]])
                require(all(torch.equal(g, s) for g, s in zip(got_rows, src)),
                        f"{engine.tier.name}: the copy-on-write program "
                        "did not copy B's source block")
            restore()
            engine._programs, engine._make_program = {}, TickProgram
            want = run(b)                # the bodies, run eagerly
            want_rows = rows(written(b))
            restore()
            engine._make_program = make
            require(got == want, f"{engine.tier.name}: the {name} programs "
                    f"replayed for B gave {got}, their bodies {want}")
            diff, ok = 0.0, True
            for g, w in zip(got_rows, want_rows):
                d = (g.float() - w.float()).abs().max().item()
                lim = (1.0 if w.dtype == torch.int8
                       else ROW_ULP * w.float().abs().max().item())
                diff, ok = max(diff, d), ok and d <= lim
            require(ok, f"{engine.tier.name}: the {name} programs' pool rows "
                    f"are {diff} from their bodies'")
            out[name] = {"programs": keys, "first": got,
                         "max_abs_diff": diff, "rows": len(written(b)) * bs}
    finally:
        engine._programs, engine._make_program = programs, make
        del engine._note_compile
        restore()
        engine.allocator.free(spare)
    return out


def step_breakdown(torch, step, attn, layers: int) -> dict:
    """Where one decode step's time goes: ``step()``'s eager wall time
    (enqueue and run, then synchronize) against the same step captured
    once as a CUDA graph and replayed, which is its device time with no
    host launch gaps (their ratio is the device's idle share in eager
    mode); and the attention kernel's part, ``attn()`` (one layer's
    launch, graph-replayed, L2 flushed before each as the step finds each
    layer's cache cold) times ``layers``, and its share of the
    graph-replayed step; and W1's launches in one eager step
    (``w8_launches``: 0 on bf16 weights)."""
    from distributed_llm_tpu_torch.ops import quant as TQ

    before = TQ.w8_matmul.launches
    step()
    torch.cuda.synchronize()
    w8_launches = TQ.w8_matmul.launches - before
    iters = 10
    step_graph_ms = graph_ms(torch, step, iters=iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    attn_ms = layers * graph_ms(torch, attn, flush=flush_buf.zero_)
    del flush_buf
    return {"wall_ms": wall_ms, "graph_ms": step_graph_ms,
            "attention_ms": attn_ms,
            "attention_share": attn_ms / step_graph_ms,
            "device_idle_share": max(0.0, 1.0 - step_graph_ms / wall_ms),
            "w8_launches": w8_launches}


def paged_step_breakdown(torch, engine) -> dict:
    """``step_breakdown`` of one batched decode step on a copy of the live
    pool, every slot at the longest parked conversation's end; the
    attention is the ragged decode kernel."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged
    from distributed_llm_tpu_torch.models.transformer import layer_scales
    from distributed_llm_tpu_torch.ops import attention as TA

    tables, pos, cur, n = _live_decode_state(torch, engine)
    pool = {k: v.clone() for k, v in engine.pool.items()}
    cfg = engine.cfg
    q = torch.randn((engine.paged.max_slots, cfg.num_heads, cfg.head_dim),
                    device=engine.device).to(engine.model.final_ln.dtype)
    res = step_breakdown(
        torch, lambda: decode_step_paged(cfg, engine.model, cur, pos, pool,
                                         tables),
        lambda: TA.ragged_decode(q, pool["k"][0], pool["v"][0], tables, pos,
                                 *layer_scales(pool, 0)), cfg.num_layers)
    del pool
    return {"slots": engine.paged.max_slots, "position": n - 1, **res}


def verify_step_breakdown(torch, engine) -> dict:
    """``step_breakdown`` of one batched verify step at the top γ bucket
    (G rows a slot) on a copy of the live pool, every slot at the longest
    parked conversation's end (two spare blocks after the parked ones
    take the new rows); the attention is the ragged verify kernel."""
    from distributed_llm_tpu_torch.engine.paged_kv import verify_step_paged
    from distributed_llm_tpu_torch.models.transformer import layer_scales
    from distributed_llm_tpu_torch.ops import attention as TA

    g = engine.spec_gamma_max + 1
    spare = engine.allocator.alloc(2)
    require(spare is not None, "no spare blocks for the verify step")
    try:
        tables, pos, cur, n = _live_decode_state(torch, engine, spare)
        pool = {k: v.clone() for k, v in engine.pool.items()}
        cfg = engine.cfg
        chunk = cur[:, None].expand(-1, g).contiguous()
        q = torch.randn((engine.paged.max_slots, g, cfg.num_heads,
                         cfg.head_dim), device=engine.device
                        ).to(engine.model.final_ln.dtype)
        res = step_breakdown(
            torch, lambda: verify_step_paged(cfg, engine.model, chunk, pos,
                                             pool, tables),
            lambda: TA.ragged_verify(q, pool["k"][0], pool["v"][0], tables,
                                     pos, *layer_scales(pool, 0)),
            cfg.num_layers)
        del pool
    finally:
        engine.allocator.free(spare)
    return {"slots": engine.paged.max_slots, "rows": g, "position": n - 1,
            **res}


def seq_step_breakdown(torch, engine) -> dict:
    """``step_breakdown`` of one B=1 decode step on a copy of the live
    cache of the longest parked conversation (the long prompt's, at
    about position 2255 in an 8192 cache for orin); the attention is the
    contiguous decode kernel (K9 bf16, K10 int8) at that position."""
    from distributed_llm_tpu_torch.models import transformer as TT
    from distributed_llm_tpu_torch.ops import attention as TA

    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    n = len(entry.ids)
    cache = {k: v.clone() for k, v in entry.cache.items()}
    cur = torch.tensor([entry.ids[-1]], device=engine.device)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=engine.device)
    cfg = engine.cfg
    q = torch.randn((1, cfg.num_heads, cfg.head_dim), device=engine.device
                    ).to(engine.model.final_ln.dtype)
    res = step_breakdown(
        torch, lambda: TT.decode_step(cfg, engine.model, cur, pos, cache),
        lambda: TA.decode(q, cache["k"][0], cache["v"][0], pos,
                          *TT.layer_scales(cache, 0)), cfg.num_layers)
    del cache
    return {"position": n - 1, "cache_len": int(entry.cache["k"].shape[2]),
            **res}


# -- numerics on live state ----------------------------------------------------

@contextlib.contextmanager
def plain_attention(float32: bool = False):
    """The model's attention dispatchers (``attention.decode``, ``chunk``,
    ``ragged_decode`` and ``ragged_verify``) swapped for the kernels'
    plain versions, run on float32-widened inputs when asked (the output
    cast back to q's dtype): for the numerics checks only, after a main
    path's counts were read."""
    from distributed_llm_tpu_torch.ops import attention as TA

    def run(plain, q, *args):
        return plain(*(widen((q, *args)) if float32 else (q, *args))
                     ).to(q.dtype)

    def decode(q, k, v, pos, ks=None, vs=None):
        return (run(TA._decode_contiguous, q, k, v, pos) if ks is None
                else run(TA._decode_contiguous_q8, q, k, v, ks, vs, pos))

    def chunk(q, k, v, q_pos, ks=None, vs=None):
        return (run(TA._chunk_contiguous, q, k, v, q_pos) if ks is None
                else run(TA._chunk_contiguous_q8, q, k, v, ks, vs, q_pos))

    def ragged_decode(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_decode_paged, q, k, v, tables, pos, ks, vs)

    def paged_decode(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_decode_windowed, q, k, v, tables, pos, ks, vs)

    def ragged_verify(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_verify_paged, q, k, v, tables, pos, ks, vs)

    swapped = {"decode": decode, "chunk": chunk,
               "ragged_decode": ragged_decode, "paged_decode": paged_decode,
               "ragged_verify": ragged_verify}
    saved = {name: getattr(TA, name) for name in swapped}
    for name, fn in swapped.items():
        setattr(TA, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(TA, name, fn)


@contextlib.contextmanager
def pinned_routes(routes: list, record: bool):
    """A MoE model's expert choice (``models.moe._top2_gates``), call by
    call: recorded into ``routes`` (each call's chosen experts and router
    log-probabilities) when ``record``, else replayed from it in the same
    order, each row's gates renormalised over the recorded experts from
    this run's own probabilities.  A replayed call whose own top-2 differs
    in some row (a router near-tie crossed by the two runs' rounding) is
    noted: the gap between its own weakest pick and the recorded weakest
    pick in log-probability, and the router's drift between the runs at
    that call (the largest log-probability change of any row).  Yields
    the notes.  Dense models never call it."""
    from distributed_llm_tpu_torch.models import moe

    real = moe._top2_gates
    calls = iter(list(routes))
    flips = []

    def gates(router_logits):
        g, probs = real(router_logits)
        lp = probs.clamp_min(1e-30).log()
        mask = g > 0
        if record:
            routes.append((mask, lp))
            return g, probs
        want, lp_rec = next(calls)
        differ = (mask != want).any(dim=-1)
        if bool(differ.any()):
            inf = float("inf")
            gap = (lp.masked_fill(~mask, inf).amin(-1)
                   - lp.masked_fill(~want, inf).amin(-1))[differ]
            flips.append({"rows": int(differ.sum()),
                          "gap": gap.max().item(),
                          "drift": (lp - lp_rec).abs().max().item()})
        pinned = probs * want
        return pinned / pinned.sum(-1, keepdim=True).clamp_min(1e-9), probs

    moe._top2_gates = gates
    try:
        yield flips
    finally:
        moe._top2_gates = real


def kv_clone(state):
    """A copy of a KV cache or pool, or of a sharded one (a list of them,
    one per head shard)."""
    if isinstance(state, list):
        return [kv_clone(part) for part in state]
    return {k: v.clone() for k, v in state.items()}


def three_ways(fn, state: dict):
    """``fn(copy)`` on its own copy of ``state`` (a KV cache or pool) with
    the kernels, with the plain attention and with the plain attention in
    float32.  A MoE model's expert choice is the kernels' run's in all
    three (``pinned_routes``), so the logits compare the attention paths
    and not a router near-tie; each such tie the other runs crossed must
    be one: its gap within twice the router's drift at that layer
    (``three_ways.routes`` holds the notes)."""
    out, routes, notes = [], [], []
    for i, ctx in enumerate((contextlib.nullcontext(), plain_attention(),
                             plain_attention(float32=True))):
        copy = kv_clone(state)
        with ctx, pinned_routes(routes, record=i == 0) as flips:
            out.append(fn(copy))
        notes += flips
        del copy
    three_ways.routes = {"calls": len(routes), "flips": notes}
    require(all(f["gap"] <= 2 * f["drift"] for f in notes),
            f"a router choice differs beyond a near-tie: {notes}")
    return out


def check_three(res: dict, kernel, plain, ref, also=()) -> dict:
    """``res`` with the logits of the kernels against the plain attention
    and against it in float32, each within LOGITS_RTOL of the logits'
    scale above the model's rounding floor (how far the plain attention
    in bf16 lands from the same in float32); so must be every key of
    ``res`` named in ``also``."""
    scale = ref.abs().max().item()
    floor = (plain - ref).abs().max().item()
    res.update({"kernel_vs_plain_max_abs_err": (kernel - plain).abs().max().item(),
                "kernel_vs_float32_max_abs_err": (kernel - ref).abs().max().item(),
                "plain_vs_float32_max_abs_err": floor,
                "logits_max_abs": scale, "tol": LOGITS_RTOL * scale + floor})
    if three_ways.routes["calls"]:
        res["routes"] = three_ways.routes
    for key in ("kernel_vs_plain_max_abs_err",
                "kernel_vs_float32_max_abs_err", *also):
        require(res[key] <= res["tol"], f"logits disagree ({key}): {res}")
    return res


def logits_check(torch, engine) -> dict:
    """Decode-step logits on the live pool: the parked prefix of the
    served conversation, continued by one token, ``three_ways``."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, _ = _live_decode_state(torch, engine)
    kernel, plain, ref = three_ways(lambda pool: decode_step_paged(
        engine.cfg, engine.model, cur, pos, pool, tables)[0], engine.pool)
    return check_three({}, kernel, plain, ref)


def verify_check(torch, engine) -> dict:
    """The verify step on the live pool at the top γ bucket (G rows),
    ``three_ways``, its kernel logits also against G sequential greedy
    decode steps from the same state (two spare blocks after the parked
    ones hold the new rows)."""
    from distributed_llm_tpu_torch.engine.paged_kv import (decode_step_paged,
                                                           verify_step_paged)

    g = engine.spec_gamma_max + 1
    spare = engine.allocator.alloc(2)
    require(spare is not None, "no spare blocks for the verify check")
    try:
        tables, pos, cur, _ = _live_decode_state(torch, engine, spare)
        cfg, model = engine.cfg, engine.model
        pool = {k: v.clone() for k, v in engine.pool.items()}
        seq, toks, p = [], [cur], pos
        for _ in range(g):
            logits = decode_step_paged(cfg, model, toks[-1], p, pool, tables)
            seq.append(logits)
            toks.append(logits.argmax(dim=-1))
            p = p + 1
        seq = torch.stack(seq, dim=1)                       # [B, G, V]
        del pool
        chunk = torch.stack(toks[:g], dim=1)                # [B, G]
        kernel, plain, ref = three_ways(lambda pool: verify_step_paged(
            cfg, model, chunk, pos, pool, tables), engine.pool)
    finally:
        engine.allocator.free(spare)
    return check_three(
        {"rows": g,
         "verify_vs_sequential_max_abs_err": (kernel - seq).abs().max().item(),
         "argmax_agree": (kernel.argmax(-1) == seq.argmax(-1)).float()
         .mean().item()},
        kernel, plain, ref, also=("verify_vs_sequential_max_abs_err",))


def seq_logits_check(torch, engine) -> dict:
    """Decode-step logits on a live cache: the long prompt served again
    (and parked), continued by one token, ``three_ways``."""
    from distributed_llm_tpu_torch.models import transformer as TT

    engine.generate("summarise: " + words(LONG_WORDS, 3), max_new_tokens=2)
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    n = len(entry.ids)
    cur = torch.tensor([entry.ids[-1]], device=engine.device)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=engine.device)
    kernel, plain, ref = three_ways(lambda c: TT.decode_step(
        engine.cfg, engine.model, cur, pos, c)[0], entry.cache)
    return check_three({"position": n - 1,
                        "cache_len": int(entry.cache["k"].shape[2])},
                       kernel, plain, ref)


def seq_verify_check(torch, engine) -> dict:
    """The target's γ+1-row ``decode_chunk`` on a live prefill (a
    675-token prompt), ``three_ways``, its kernel logits also against γ+1
    sequential greedy ``decode_step``s from the same state."""
    from distributed_llm_tpu_torch.engine.speculative import decode_chunk
    from distributed_llm_tpu_torch.models import transformer as TT

    first, cache, _, _, n, _, _, _ = engine._prepare_and_prefill(
        "summarise: " + words(300, 3), SERVE_MAX_NEW)
    g = engine.gamma + 1
    seq_cache = {k: v.clone() for k, v in cache.items()}
    toks = [torch.tensor([first], device=engine.device)]
    seq = []
    for i in range(g):
        pos = torch.tensor([n + i], dtype=torch.int32, device=engine.device)
        seq.append(TT.decode_step(engine.cfg_t, engine.model_t, toks[-1], pos,
                                  seq_cache)[0])
        toks.append(seq[-1].argmax(-1)[None])
    seq = torch.stack(seq)                                   # [G, V]
    del seq_cache
    chunk = torch.cat(toks[:g])[None]                        # [1, G]
    start = torch.tensor([n], dtype=torch.int32, device=engine.device)
    kernel, plain, ref = three_ways(lambda c: decode_chunk(
        engine.cfg_t, engine.model_t, chunk, start, c)[0], cache)
    return check_three(
        {"rows": g, "position": n,
         "verify_vs_sequential_max_abs_err": (kernel - seq).abs().max().item(),
         "argmax_agree": (kernel.argmax(-1) == seq.argmax(-1)).float()
         .mean().item()},
        kernel, plain, ref, also=("verify_vs_sequential_max_abs_err",))


# -- phases 7-9: serve the sequential engines ---------------------------------------

LONG_WORDS = 1000            # about 2250 tokens: past the 2048 bucket


def post_status(url: str, body: dict):
    """(status, text) of a POST, error statuses included."""
    try:
        return post(url, body)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8")


def seq_graph_check(torch, engine) -> dict:
    """One decode segment of the plain engine (the rung's decode program,
    SEGMENT steps continuing the longest parked conversation: the long
    prompt's, at about position 2255 on the 8192 rung for orin), or one
    round of the speculative engine (its ``("round", rung)`` program from
    a live prefill of the long prompt, cut to the 2048 bucket), through
    the program the engine replays and through its body run eagerly,
    from the same live cache and the same staged state: the tokens must
    be ``torch.equal``.  On the card both are then timed between CUDA
    events from that state (10 replays, 3 eager runs): the replayed and
    the eager step (a segment's over its SEGMENT steps; a round's
    whole)."""
    from distributed_llm_tpu_torch.engine.inference import SEGMENT
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine

    if isinstance(engine, SpeculativeEngine):
        first, _, _, rung, n, _, _, _ = engine._prepare_and_prefill(
            "summarise: " + words(LONG_WORDS, 3), SERVE_MAX_NEW)
        key, steps, position = ("round", rung), 1, n
        state = dict(cur=first, pos=n)
        caches = list(engine._cache(rung))
    else:
        entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
        rung = engine._load(entry.cache)
        n = len(entry.ids)
        key, steps, position = rung, SEGMENT, n - 1
        state = dict(cur=entry.ids[-1], pos=n - 1, done=False, made=1,
                     budget=SEGMENT + 1, temp=0.0)
        caches = [engine._cache(rung)]
    prog = engine._built(key, rung)
    live = [{k: v.clone() for k, v in c.items()} for c in caches]

    def reset():
        for cache, saved in zip(caches, live):
            for k in cache:
                cache[k].copy_(saved[k])
        engine._stage(**state)

    reset()
    replayed = prog.run().clone()
    reset()
    eager = prog.body().clone()
    require(torch.equal(replayed, eager),
            f"{engine.tier.name}: the replayed program {key} gave "
            f"{replayed.tolist()}, its body run eagerly {eager.tolist()}")
    res = {"program": str(key), "rung": rung, "position": position,
           "graph": prog.graph is not None, "tokens_equal": True,
           "tokens": replayed.tolist()}
    if engine.device.type == "cuda":
        def device_ms(run, iters):
            reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                run()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters

        replay_ms = device_ms(prog.run, 10)
        eager_ms = device_ms(prog.body, 3)
        res.update({"replay_ms": replay_ms, "eager_ms": eager_ms,
                    "steps": steps, "step_replay_ms": replay_ms / steps,
                    "step_eager_ms": eager_ms / steps})
    for cache, saved in zip(caches, live):
        for k in cache:
            cache[k].copy_(saved[k])
    del live
    return res


def copy_check(torch, engine) -> dict:
    """The prefix cache's copies on the largest parked cache (the long
    prompt's rung): parking (``_park``, a clone of the rung's working
    cache) and a hit's load (``_load``, the parked entry copied back into
    it), each held bit for bit and, on the card, timed between CUDA
    events (3 runs each) beside the bytes copied."""
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    rung = engine._load(entry.cache)
    parked = engine._park(rung)
    require(all(torch.equal(parked[k], entry.cache[k]) for k in parked),
            f"{engine.tier.name}: a parked copy differs from its cache")
    nbytes = sum(x.numel() * x.element_size() for x in parked.values())
    del parked
    res = {"rung": rung, "bytes": nbytes}
    if engine.device.type == "cuda":
        for name, run in (("park_ms", lambda: engine._park(rung)),
                          ("load_ms", lambda: engine._load(entry.cache))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(3):
                run()
            end.record()
            end.synchronize()
            res[name] = start.elapsed_time(end) / 3
        res["load_gb_per_s"] = 2 * nbytes / res["load_ms"] / 1e6
    return res


def first_use_check(torch, engine) -> dict:
    """Programs captured at their first use, in the middle of a request,
    as an engine without ``warmup()`` captures them (the ``/query`` app's
    and the bench's): a cold greedy request served by the warmed programs,
    then again with every program dropped, so its prefill and its decode
    program (the speculative engine's fused loop; its round program for a
    stream of the same prompt) are captured as the request meets them.
    A capture's warm run must not disturb the request it serves: the
    tokens must be equal.  The prefix cache is off meanwhile (both runs
    cold), and the warmed programs are put back after."""
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine

    prompt = "describe: " + words(150, 5)
    spec = isinstance(engine, SpeculativeEngine)
    cache, saved = getattr(engine, "prefix_cache", None), engine._programs

    def serve():
        out = [engine.generate(prompt, SERVE_MAX_NEW, 0.0).token_ids]
        if spec:
            stream = engine.generate_stream(prompt, SERVE_MAX_NEW, 0.0)
            "".join(stream)
            out.append(stream.result.token_ids)
        return out

    if not spec:
        engine.prefix_cache = None
    try:
        warmed = serve()
        engine._programs = {}
        fresh = serve()
        built = sorted(str(k) for k in engine._programs)
    finally:
        engine._programs = saved
        if not spec:
            engine.prefix_cache = cache
    require(fresh == warmed and len(warmed[0]) > 1,
            f"{engine.tier.name}: programs captured at first use gave "
            f"{fresh}, the warmed programs {warmed}")
    return {"tokens_equal": True, "tokens": len(warmed[0]),
            "captured_mid_request": built}


def loop_vs_round(torch, engine) -> dict:
    """The speculative engine's fused loop program (``generate``,
    LOOP_ROUNDS rounds a replay and host read) against its round program
    (``generate_stream``, one round a replay and host read) on the same
    greedy request: the decode ms (total less TTFT) of each, 3 runs each
    alternated, with the tokens equal."""
    from distributed_llm_tpu_torch.engine.speculative import LOOP_ROUNDS

    prompt = "explain: " + words(150, 6)
    runs = {"loop": [], "round": []}
    toks = {}
    for _ in range(3):
        res = engine.generate(prompt, SERVE_MAX_NEW)
        runs["loop"].append(res.total_ms - res.ttft_ms)
        toks["loop"] = res.token_ids
        stream = engine.generate_stream(prompt, SERVE_MAX_NEW)
        "".join(stream)
        res = stream.result
        runs["round"].append(res.total_ms - res.ttft_ms)
        toks["round"] = res.token_ids
    require(toks["loop"] == toks["round"],
            f"{engine.tier.name}: the loop and round programs disagree")
    return {"loop_rounds": LOOP_ROUNDS, "tokens": len(toks["loop"]),
            "loop_decode_ms": runs["loop"], "round_decode_ms": runs["round"]}


def serve_sequential_phase(torch, tier, *, expect, device: str = "cuda"):
    """Serve a ``decode_batch=1`` tier over HTTP (the sequential
    InferenceEngine, or SpeculativeEngine with a draft): ``drive`` with
    a long prompt past the 2048 bucket (chunk stride; the speculative
    engine cuts it to the bucket, as the JAX one does) and 3 concurrent
    requests (serialized by the app), then one request at temperature
    0.8 (200 on the plain engine; the speculative engine answers the JAX
    package's 500 on /query and 501 on /query/stream), and on the plain
    engine a conversation that outgrows its rung (a 675-token turn on the
    1024 rung, then a follow-up past it: the parked cache grows into the
    8192 rung).  Every kernel in ``expect`` must launch, counted by the
    programs' replays, and no plain version may run; the admission audit
    fails the phase if a program body ran outside a capture or a program
    was built after ``warmup()``, SEQ_COLD_STAGES' apart.  Then
    ``seq_graph_check``, the numerics checks on live caches, the prefix
    copies (``copy_check``) and, for the plain engine on the card, the
    decode step's eager breakdown.  Returns (serve numbers, launches by
    kernel)."""
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
    from distributed_llm_tpu_torch.ops import flash_attention as TF

    on_card = device == "cuda"
    with admission_audit(torch, on_card) as audit, \
            served(torch, tier, device) as (engine, base, startup_s):
        spec = isinstance(engine, SpeculativeEngine)
        warm = len(engine._programs)
        warm_capture_s = audit.capture_s.get(tier.name, 0.0)
        reset_counts()
        audit.mark()
        t_main = time.perf_counter()
        drove = drive(base, long_words=LONG_WORDS, lengths=(4, 60, 150),
                      hits=None if spec else
                      (lambda: engine.prefix_cache.stats()["hits"]))
        n_long = drove["long"]["stats"]["prompt_tokens"]
        top = max(tier.prefill_buckets)
        require(n_long == top if spec else n_long > top,
                f"long prompt served at {n_long} tokens")
        sampled = {"query": "imagine " + words(8, 2), "temperature": 0.8,
                   "num_predict": SERVE_MAX_NEW}
        grow = None
        if spec:
            got = (post_status(base + "/query", sampled)[0],
                   post_status(base + "/query/stream", sampled)[0])
            require(got == (500, 501), f"sampled request on the speculative "
                    f"tier answered {got}, not the JAX package's (500, 501)")
        else:
            query(base, sampled["query"], temperature=0.8)
            turn1 = [{"role": "user", "content": "summarise: " + words(300)}]
            first = query(base, turn1)
            follow = query(base, turn1 + [
                {"role": "assistant", "content": first["response"]},
                {"role": "user", "content": "and " + words(60, 9) + "?"}])
            grown = sorted(k for k in engine.program_shapes()
                           if isinstance(k, tuple) and k[0] == "grow")
            require(not on_card or grown, "the follow-up did not grow its "
                    "parked cache into a longer rung")
            grow = {"prompt_tokens": [first["stats"]["prompt_tokens"],
                                      follow["stats"]["prompt_tokens"]],
                    "followup_ttft_ms": follow["stats"]["ttft_ms"],
                    "programs": [str(k) for k in grown]}
            drove["requests"] += 3
        main_s = time.perf_counter() - t_main
        launches, plain_calls = read_counts(expect, on_card)
        admission = audit.main_path(on_card)
        serve = serve_numbers(tier, engine, startup_s, main_s, drove, launches,
                              plain_calls)
        serve.update({
            "flash_chunk_routes": dict(TF.flash_chunk_attention.route_launches),
            "draft": tier.draft_preset if spec else None,
            "spec": ({"rounds": len(engine.accept_history),
                      "acceptance_rate": engine.acceptance_rate}
                     if spec else None),
            "grow": grow,
            "admission": admission,
            "programs": {"warm": warm, "warm_set": len(engine.warm_set()),
                         "after_main_path": len(engine._programs),
                         "warmup_capture_s": warm_capture_s,
                         "capture_s": audit.capture_s.get(tier.name, 0.0)},
            # Serves the long prompt again (parked: the checks below
            # continue it at about position 2255).
            "decode_logits_check": None if spec else seq_logits_check(torch,
                                                                      engine),
            "seq_graph_check": seq_graph_check(torch, engine),
            "copies": None if spec else copy_check(torch, engine),
            "first_use_check": first_use_check(torch, engine),
            "loop_vs_round": loop_vs_round(torch, engine) if spec else None,
            "verify_check": seq_verify_check(torch, engine) if spec else None,
            "decode_step": (seq_step_breakdown(torch, engine)
                            if on_card and not spec else None),
            "peak_memory_gb": peak_memory_gb(torch, on_card)})
        return serve, launches


# -- phase 10: the two-tier /chat service ---------------------------------------

# A few general_knowledge queries of the JAX package's bench query sets
# (copied here: the port reads nothing of that package), and two long or
# code prompts.
CHAT_QUERIES = [
    "What is the capital of Japan?",
    "How many continents are there?",
    "Name the largest ocean on Earth.",
    "What year did the first person walk on the moon?",
    "What is photosynthesis?",
    "Define the word 'ephemeral'.",
    "Explain in detail how plate tectonics drives earthquakes, volcanic "
    "arcs, and mountain building, and compare the mechanisms at divergent, "
    "convergent, and transform boundaries with concrete examples of each.",
    "Implement a thread-safe LRU cache in Python with O(1) get and put:\n"
    "```python\nclass LRUCache:\n    def __init__(self, capacity: int):\n"
    "        ...\n```\nthen analyze its time and space complexity and "
    "debug the race condition in this version:\nif key in self.map: "
    "self.map[key] = value; self.order.remove(key)",
]
STRATEGIES = ("token", "semantic", "heuristic", "hybrid", "perf")
CHAT_KEYS = {"reply", "device", "reasoning", "method", "confidence",
             "cache_hit", "tokens"}


CHAT_MAX_NEW = 64


def chat_cluster(nano, orin):
    """The /chat phase's tiers: nano at its default 8 slots and orin at 4
    (``tp=1``, int8 KV), both on the dense windowed tick, with a decode
    cap of CHAT_MAX_NEW tokens (random weights rarely stop at EOS; a
    follow-up's suffix, the reply plus the new turn, then fits the
    prefix-reuse buckets)."""
    from distributed_llm_tpu_torch.config import ClusterConfig
    return ClusterConfig(
        nano=dataclasses.replace(nano, attention_ragged=False,
                                 max_new_tokens=CHAT_MAX_NEW),
        orin=dataclasses.replace(orin, tp=1, attention_ragged=False,
                                 kv_quantize="int8",
                                 max_new_tokens=CHAT_MAX_NEW))


def chat_post(base: str, path: str, body: dict) -> dict:
    status, text = post(base + path, body)
    require(status == 200, f"{path} returned {status}: {text[:300]}")
    return json.loads(text)


def chat_stream(base: str, body: dict) -> dict:
    """One /chat/stream request read as it arrives: the meta event, the
    client-side time to the first delta, the done event and the text."""
    req = urllib.request.Request(base + "/chat/stream",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    meta, ttft_ms, text, done = None, None, "", None
    with urllib.request.urlopen(req, timeout=600) as resp:
        require(resp.status == 200, f"/chat/stream returned {resp.status}")
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if not line.startswith("data: "):
                continue
            event = json.loads(line[6:])
            require("error" not in event, f"/chat/stream failed: {event}")
            if event.get("meta"):
                meta = event
            elif "delta" in event:
                if ttft_ms is None:
                    ttft_ms = (time.perf_counter() - t0) * 1e3
                text += event["delta"]
            elif event.get("done"):
                done = event
    require(meta is not None and done is not None and done["tokens"] > 0
            and text.strip(), f"/chat/stream incomplete: {meta} {done}")
    return {"meta": meta, "ttft_ms": ttft_ms, "done": done, "text": text}


def drive_chat(base: str, strategy: str, burst: int, streams: int) -> dict:
    """One strategy's traffic: ``burst`` concurrent /chat requests (each
    its own session), a repeated query (a response-cache hit), two
    follow-up turns (a nano one and a code one, each first turn made
    unique so the response cache cannot answer it: prefix hits on both
    tiers) and ``streams`` /chat/stream requests."""
    results = [None] * burst

    def worker(i):
        results[i] = chat_post(base, "/chat", {
            "message": CHAT_QUERIES[i % len(CHAT_QUERIES)],
            "strategy": strategy, "session_id": f"{strategy}-burst-{i}"})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(burst)]
    t_burst = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    burst_s = time.perf_counter() - t_burst
    require(all(r is not None for r in results),
            "a concurrent /chat request did not complete")
    replies = list(results)
    again = chat_post(base, "/chat", {"message": CHAT_QUERIES[0],
                                      "strategy": strategy,
                                      "session_id": f"{strategy}-again"})
    require(again["cache_hit"] is True,
            f"the repeated query missed the response cache: {again}")
    replies.append(again)
    for k, (first, follow) in enumerate((
            (CHAT_QUERIES[1], "And how many oceans?"),
            (CHAT_QUERIES[-1], "Now write unit tests for it and analyze "
                               "the time complexity of each test."))):
        session = f"{strategy}-follow-{k}"
        for message in (f"{first} ({strategy})", follow):
            replies.append(chat_post(base, "/chat", {
                "message": message, "strategy": strategy,
                "session_id": session}))
    for r in replies:
        require(set(r) == CHAT_KEYS and r["device"] in ("nano", "orin"),
                f"/chat broke the contract: {r}")
    streamed = [chat_stream(base, {
        "message": CHAT_QUERIES[(i * 6) % len(CHAT_QUERIES)],
        "strategy": strategy, "session_id": f"{strategy}-stream-{i}"})
        for i in range(streams)]
    devices = [r["device"] for r in replies] + [s["meta"]["device"]
                                                for s in streamed]
    ttfts = [s["ttft_ms"] for s in streamed]
    return {"requests": len(replies) + streams,
            "burst_requests": burst, "burst_s": burst_s,
            "burst_req_per_s": burst / burst_s,
            "p50_stream_ttft_ms": statistics.median(ttfts),
            "stream_ttft_ms": ttfts,
            "nano": devices.count("nano"), "orin": devices.count("orin"),
            "p50_routing_overhead_ms": statistics.median(
                s["meta"]["routing_overhead_ms"] for s in streamed),
            "methods": sorted({r["method"] for r in replies}),
            "cache_hits": sum(1 for r in replies if r["cache_hit"])}


def routing_device_check(device: str) -> dict:
    """The routing layer's device path in the production config's hybrid
    space (the trained encoder with the hashed n-grams): embeddings of
    the chat queries on ``device`` against the same on the CPU (max abs
    within 1e-4: another float32 summation order), and every strategy's
    decision on ``device`` equal to the CPU's."""
    import numpy as np

    from distributed_llm_tpu_torch.config import PRODUCTION_CFG
    from distributed_llm_tpu_torch.routing.embedder import get_embedder
    from distributed_llm_tpu_torch.routing.strategies import (
        AVAILABLE_STRATEGIES)

    name = PRODUCTION_CFG["embedding_model"]
    err = float(np.abs(get_embedder(name, device).encode(CHAT_QUERIES)
                       - get_embedder(name, "cpu").encode(CHAT_QUERIES)).max())
    require(err <= 1e-4, f"the {name} embedding on {device} is off by {err}")
    decisions = {}
    for strategy, cls in AVAILABLE_STRATEGIES.items():
        embeds = strategy in ("semantic", "hybrid")
        got = [cls(dict(PRODUCTION_CFG), **({"device": device} if embeds
                                            else {})).route(q)
               for q in CHAT_QUERIES]
        want = [cls(dict(PRODUCTION_CFG), **({"device": "cpu"} if embeds
                                             else {})).route(q)
                for q in CHAT_QUERIES]
        require([(d.device, d.method) for d in got]
                == [(d.device, d.method) for d in want],
                f"{strategy} decides otherwise on {device}")
        decisions[strategy] = [d.device for d in got]
    return {"embedding_model": name, "max_abs_err_vs_cpu": err,
            "decisions": decisions}


def dense_logits_check(torch, engine) -> dict:
    """The dense tick's decode-step logits on the live pool, every slot
    continuing the longest parked conversation through the window its
    tick would take, ``three_ways``."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, n = _live_decode_state(torch, engine)
    wb = engine._suffix_window(n + engine.steps_per_tick) \
        // engine.paged.block_size
    kernel, plain, ref = three_ways(lambda pool: decode_step_paged(
        engine.cfg, engine.model, cur, pos, pool, tables[:, :wb],
        ragged=False)[0], engine.pool)
    return check_three({"position": n - 1, "window": wb *
                        engine.paged.block_size}, kernel, plain, ref)


# -- phase 10, continued: the obs layer --------------------------------------

def http_get(base: str, path: str) -> str:
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        require(resp.status == 200, f"GET {path} returned {resp.status}")
        return resp.read().decode("utf-8")


def parse_prometheus(text: str) -> dict:
    """Prometheus text -> {metric name: [(labels dict, value)]}; fails on a
    line that is neither a comment nor a sample."""
    import re
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = sample.match(line)
        require(m is not None, f"/metrics: not Prometheus text: {line!r}")
        labels = dict(label.findall(m.group(2) or ""))
        out.setdefault(m.group(1), []).append((labels, float(m.group(3))))
    return out


def obs_checks(router, base: str, by_strategy: dict) -> dict:
    """The obs layer over what the phase's main path served: ``/metrics``
    parses as Prometheus text, its request count equals the requests sent
    and its TTFT histogram holds one observation per request that
    produced a token (every request but the response-cache hits);
    ``/debug/trace`` round-trips as JSON with one thread per tier and each
    tier's ticks in order; each tier's stamped phase self-time covers >=
    0.95 of its ticks' wall; the requests' attributed device time is
    within 5% of each tier's lifetime decode self-time; ``/stats?debug=1``
    carries the flight recorder (every request recorded: ``slow_ms`` 0),
    ``slo`` and ``cost``.  Returns each tier's phase self-time table."""
    sent = sum(v["requests"] for v in by_strategy.values())
    cached = sum(v["cache_hits"] for v in by_strategy.values())
    metrics = parse_prometheus(http_get(base, "/metrics"))
    requests = sum(v for _, v in metrics["dllm_requests_total"])
    ttft_n = sum(v for _, v in metrics["dllm_ttft_ms_count"])
    require(requests == sent, f"/metrics counts {requests} requests of "
            f"{sent} sent")
    require(ttft_n == sent - cached, f"/metrics holds {ttft_n} TTFTs for "
            f"{sent} requests, {cached} of them cache hits")

    doc = json.loads(http_get(base, "/debug/trace"))
    events = doc["traceEvents"]
    threads = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    require(sorted(threads.values()) == ["tier:nano", "tier:orin"],
            f"/debug/trace threads {threads}")
    for tid, name in threads.items():
        ticks = [e for e in events
                 if e["tid"] == tid and e["ph"] == "X" and e["name"] == "tick"]
        require(ticks and all(a["ts"] <= b["ts"]
                              and a["args"]["seq"] < b["args"]["seq"]
                              for a, b in zip(ticks, ticks[1:])),
                f"/debug/trace: {name}'s ticks are not in order")

    fam = router.obs.metrics.get("dllm_device_time_ms_total")
    billed: dict = {}
    for key, child in fam.children().items():
        billed[key[0]] = billed.get(key[0], 0.0) + child.value
    tiers = {}
    for name, tier in router.tiers.items():
        prof = tier.server_manager.engine().profiler
        st = prof.phase_stats()
        decode_ms = prof.total_ms("decode") + prof.total_ms("verify")
        ratio = billed.get(name, 0.0) / decode_ms if decode_ms else None
        require(st["coverage"] is not None and st["coverage"] >= 0.95,
                f"{name}: stamped phases cover {st['coverage']} of the tick "
                "wall (< 0.95)")
        require(ratio is not None and abs(ratio - 1.0) <= 0.05,
                f"{name}: attributed device time {billed.get(name)} ms "
                f"against {decode_ms} ms of decode self-time")
        tiers[name] = {"coverage": st["coverage"], "ticks": st["ticks"],
                       "phases": st["phases"], "totals": st["totals"],
                       "attributed_device_ms": billed.get(name, 0.0),
                       "decode_self_ms": decode_ms,
                       "attribution_ratio": ratio}

    stats = json.loads(http_get(base, "/stats?debug=1"))
    require(stats.get("flight_recorder") and stats.get("slo") is not None
            and stats.get("cost"),
            "/stats?debug=1 lacks flight_recorder, slo or cost: "
            f"{sorted(stats)}")
    entry = stats["flight_recorder"][0]
    require(entry["trace"]["spans"]["children"],
            f"a flight-recorder entry has no spans: {entry}")
    return {"requests": requests, "ttft_n": ttft_n, "trace_events":
            len(events), "tiers": tiers, "slo": {
                k: stats["slo"][k] for k in ("observed_total", "good_total",
                                             "goodput_lifetime",
                                             "violations")},
            "cost_rows": len(stats["cost"]),
            "flight_recorded_total": stats["flight_recorded_total"]}


# Kernel classes of a served tick: the attention kernel (the split-K
# kernel and its merge, K8 on orin's int8 dense tick), the matrix products
# (cuBLAS GEMM and GEMV kernels) and everything else.
ATTENTION_KERNELS = ("split_verify_kernel", "split_merge")
GEMM_KERNELS = ("gemm", "gemv", "nvjet", "cutlass", "xmma")


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ATTENTION_KERNELS):
        return "attention"
    if any(k in low for k in GEMM_KERNELS):
        return "gemm"
    return "other"


def _union_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (µs in, ms out)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _window_events(trace, name: str = "dllm_window"):
    """(window start, end in µs, device events in it, correlation ->
    (runtime call name, calling thread)) of a Chrome trace from
    ``profiler_trace``."""
    window = next(e for e in trace if e.get("name") == name
                  and e.get("cat") == "user_annotation")
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    runtime = {e["args"].get("correlation"): (e["name"], e.get("tid"))
               for e in trace
               if e.get("cat") == "cuda_runtime" and "args" in e}
    device = [e for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    return w0, w1, device, runtime


def _replayed(e, runtime) -> bool:
    """Whether a device event ran inside a replayed CUDA graph: its
    correlation id is the graph launch's."""
    return runtime.get(e.get("args", {}).get("correlation"), ("", None))[
        0].startswith("cudaGraphLaunch")


def _busiest_thread(runtime, call, exclude=None):
    """The trace's thread id that made the most runtime calls named
    ``call`` (a name's start, or a tuple of them) besides ``exclude``."""
    counts: dict = {}
    for name, tid in runtime.values():
        if name.startswith(call) and tid != exclude:
            counts[tid] = counts.get(tid, 0) + 1
    return max(counts, key=counts.get) if counts else None


def _launcher(e, runtime, tiers: dict):
    """The tier whose scheduler thread launched device event ``e``
    (through its correlation id's runtime call), or None."""
    tid = runtime.get(e.get("args", {}).get("correlation"), (None, None))[1]
    return tiers.get(tid)


def _clip(events, a: float, b: float):
    return [(max(e["ts"], a), min(e["ts"] + e["dur"], b)) for e in events
            if e["ts"] < b and e["ts"] + e["dur"] > a]


def kernel_table(device, w0: float, w1: float) -> dict:
    """The ten CUDA kernels with the most device time among ``device``,
    with their launches, and the device-busy share of [w0, w1)."""
    by_name: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            acc = by_name.setdefault(e["name"], [0, 0.0])
            acc[0] += 1
            acc[1] += e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    busy = _union_ms(_clip(device, w0, w1))
    return {"top_kernels": [{"name": n[:120], "launches": c,
                             "device_ms": ms} for n, (c, ms) in top],
            "kernels": sum(c for c, _ in by_name.values()),
            "window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / ((w1 - w0) / 1e3)}


def tick_split(kernels, ticks: int) -> dict:
    """Device time of ``kernels`` by class (GEMMs, the attention kernel,
    everything else), in all and per tick, and each class's share."""
    split = {"gemm": 0.0, "attention": 0.0, "other": 0.0}
    for e in kernels:
        split[kernel_class(e["name"])] += e["dur"] / 1e3
    total = max(1e-9, sum(split.values()))
    return {"kernels": len(kernels), "ticks": ticks, "device_ms": split,
            "per_tick_ms": {k: v / max(1, ticks) for k, v in split.items()},
            "share": {k: v / total for k, v in split.items()}}


def _served_window(torch, router, asks, log_dir: str):
    """Serve ``asks`` [(tier, prompt)] concurrently through the tier
    clients under the profiler, inside a "dllm_window" annotation whose
    host clock start is returned beside the trace's events."""
    from distributed_llm_tpu_torch.utils.telemetry import profiler_trace

    replies = {}

    def ask(i: int, tier: str, text: str):
        replies[i] = router.tiers[tier].process(
            [{"role": "user", "content": text}])

    threads = [threading.Thread(target=ask, args=(i, tier, text))
               for i, (tier, text) in enumerate(asks)]
    with profiler_trace(log_dir):
        t_enter = time.perf_counter()
        with torch.profiler.record_function("dllm_window"):
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            torch.cuda.synchronize()
    require(len(replies) == len(asks)
            and all("response" in r for r in replies.values()),
            f"the capture window's requests failed: {replies}")
    with open(os.path.join(log_dir, "trace.json")) as f:
        return t_enter, json.load(f)["traceEvents"]


def per_kernel_capture(torch, router, out_dir: str) -> dict:
    """Two windows of served ticks under ``utils.telemetry.profiler_trace``
    (``torch.profiler``, CPU and CUDA activity).

    1. orin alone: its tier client serves 4 concurrent requests.  The ten
       CUDA kernels with the most device time and their launches, the
       window's device-busy share, and orin's tick split into its GEMMs,
       its attention kernel (K8: the split-K kernel and its merge) and
       everything else, per tick, over the kernels of its replayed
       graphs (a graph replay's kernels carry its launch's correlation
       id).  If the replays' kernels do not appear as records, the tick
       program's body runs eagerly from the live state under the
       profiler instead (``view`` says which).
    2. nano's chunked prefill beside orin's decode: nano serves a prompt
       long enough to prefill in chunks while orin serves 4 requests.
       Each ``chunk_prefill`` phase of nano's profiler (its host clock,
       placed on the trace's by the window's start) is split into the
       device time of the kernels nano's scheduler thread launched (the
       chunk's own), of the kernels orin's thread launched (its
       prefills and replayed ticks, queued on the same stream: the wait
       behind the other tier) and the rest (host: the chunk's launches
       and its waits for the interpreter lock).  Kernels are assigned
       to a tier by the thread of the runtime call their correlation id
       names: orin's is the thread that replayed graphs in window 1, nano's
       the other thread launching kernels in window 2;
       ``attributed_share`` says how many found one."""
    orin = router.tiers["orin"].server_manager.engine()
    nano = router.tiers["nano"].server_manager.engine()
    slots = orin.paged.max_slots

    ticks0 = orin.ticks_total
    _, trace = _served_window(torch, router, [
        ("orin", f"explain {words(40, i)}") for i in range(slots)],
        os.path.join(out_dir, "orin_ticks"))
    ticks = orin.ticks_total - ticks0
    w0, w1, device, runtime = _window_events(trace)
    # Orin serves alone here: the thread that replays graphs is orin's.
    orin_tid = _busiest_thread(runtime, "cudaGraphLaunch")
    res = {"orin_window": kernel_table(device, w0, w1), "view": "served"}
    graph_k = [e for e in device if e["cat"] == "kernel"
               and _replayed(e, runtime)]
    res["orin_tick"] = tick_split(graph_k, ticks)
    if len(graph_k) < ticks:
        res["view"] = "eager_body"
        res["orin_tick"] = eager_tick_split(torch, orin, os.path.join(
            out_dir, "orin_eager"))

    n0 = len(nano.profiler.records())
    seq0 = nano.profiler.records()[-1]["seq"] if n0 else 0
    t_enter, trace = _served_window(torch, router, [
        ("nano", "summarize " + words(1200))] + [
        ("orin", f"describe {words(30, i)}") for i in range(slots)],
        os.path.join(out_dir, "nano_chunks"))
    w0, w1, device, runtime = _window_events(trace)
    kernels = [e for e in device if e["cat"] == "kernel"]
    # The other thread launching kernels (its chunks replay graphs) is
    # nano's.
    nano_tid = _busiest_thread(runtime, ("cudaGraphLaunch",
                                         "cudaLaunchKernel"),
                               exclude=orin_tid)
    tiers = {orin_tid: "orin", nano_tid: "nano"}
    by_tier = {"nano": [], "orin": []}
    for e in kernels:
        tier = _launcher(e, runtime, tiers)
        if tier is not None:
            by_tier[tier].append(e)
    own_k, other_k = by_tier["nano"], by_tier["orin"]
    chunks = []
    for rec in nano.profiler.records():
        if rec["seq"] <= seq0:
            continue
        for name, rel_ms, dur_ms, _self in rec["spans"]:
            if name == "chunk_prefill":
                a = w0 + (rec["t0"] - t_enter) * 1e6 + rel_ms * 1e3
                chunks.append((a, a + dur_ms * 1e3))
    require(chunks, "nano's long prompt took no chunked prefill")
    per_chunk = [((b - a) / 1e3, _union_ms(_clip(own_k, a, b)),
                  _union_ms(_clip(other_k, a, b))) for a, b in chunks]
    # The launches each chunk made from nano's thread: graph replays and
    # kernels launched one by one.
    calls = [e for e in trace if e.get("cat") == "cuda_runtime"
             and e.get("tid") == nano_tid]
    launches_per_chunk = [
        {kind: sum(1 for e in calls if a <= e["ts"] < b
                   and e["name"].startswith(kind))
         for kind in ("cudaGraphLaunch", "cudaLaunchKernel")}
        for a, b in chunks]
    wall, own, behind = (sum(c[i] for c in per_chunk) for i in range(3))
    res["nano_chunk"] = {"chunks": len(chunks), "wall_ms": wall,
                         "own_device_ms": own, "behind_orin_ms": behind,
                         "host_ms": max(0.0, wall - own - behind),
                         "attributed_share": (len(own_k) + len(other_k))
                         / max(1, len(kernels)),
                         "per_chunk_wall_own_behind_ms": [
                             [round(x, 3) for x in c] for c in per_chunk],
                         "launches_per_chunk": launches_per_chunk,
                         "window": kernel_table(device, w0, w1)}
    res["runtime_calls"] = len(runtime)
    return res


def eager_tick_split(torch, engine, log_dir: str) -> dict:
    """The fallback view: ``engine``'s tick program body run eagerly three
    times under the profiler, from the live state ``live_tick_state``
    sets up (the pools restored after each run); every kernel in the
    window is the tick's."""
    from distributed_llm_tpu_torch.utils.telemetry import profiler_trace

    with live_tick_state(torch, engine) as (prog, restore_pools, *_):
        with profiler_trace(log_dir):
            with torch.profiler.record_function("dllm_window"):
                for _ in range(3):
                    prog.body()
                    torch.cuda.synchronize()
                    restore_pools()
    with open(os.path.join(log_dir, "trace.json")) as f:
        w0, w1, device, _ = _window_events(json.load(f)["traceEvents"])
    return tick_split([e for e in device if e["cat"] == "kernel"], 3)


def profiler_overhead(router, n: int = 2) -> dict:
    """Tick p50 (the decode phase) and the wall per tick of the same burst
    with each engine's profiler on and with ``NULL_PROFILER``, back to
    back on one engine, ``n`` times each way (reported, not gated)."""
    from distributed_llm_tpu_torch.obs.profiler import NULL_PROFILER

    out = {}
    for name, tier in router.tiers.items():
        engine = tier.server_manager.engine()
        live = engine.profiler
        runs = {"on": [], "off": []}
        for mode in ("on", "off") * n:
            engine.profiler = live if mode == "on" else NULL_PROFILER
            ticks0 = engine.ticks_total
            t0 = time.perf_counter()
            threads = [threading.Thread(target=tier.process, args=(
                [{"role": "user", "content": f"overhead {mode} {i} "
                  + words(30, i)}],)) for i in range(engine.paged.max_slots)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            ticks = engine.ticks_total - ticks0
            recent = list(engine.tick_ms)[-ticks:] if ticks else []
            runs[mode].append({"ticks": ticks,
                               "tick_p50_ms": statistics.median(recent)
                               if recent else None,
                               "wall_per_tick_ms": wall * 1e3 / max(1, ticks)})
            # The profiler is swapped only between passes: let the last
            # pass of the burst commit its record first.
            while engine.pending_work():
                time.sleep(0.01)
            time.sleep(0.1)
        engine.profiler = live
        out[name] = {mode: {
            "tick_p50_ms": statistics.median(
                r["tick_p50_ms"] for r in rs if r["tick_p50_ms"] is not None),
            "wall_per_tick_ms": statistics.median(
                r["wall_per_tick_ms"] for r in rs),
            "runs": rs} for mode, rs in runs.items()}
    return out


def hbm_budget_check(torch, router, on_card: bool) -> dict:
    """Each tier's budget (``utils.hbm_budget.tier_hbm_budget``, built on
    the meta device) against its engine's own tensors: the weight bytes
    must equal its weights' (parameters and buffers) and the KV bytes its
    pool's, with the
    peak device memory beside them; and orin's tier with an
    ``hbm_gb_per_chip`` that holds half its footprint (beside the
    headroom) is refused by the manager before it builds."""
    from distributed_llm_tpu_torch.engine.manager import (
        EngineManager, TierOverCapacityError)
    from distributed_llm_tpu_torch.utils.hbm_budget import (model_bytes,
                                                            tensor_bytes,
                                                            tier_hbm_budget)

    out = {}
    for name, tier in router.tiers.items():
        engine = tier.server_manager.engine()
        budget = tier_hbm_budget(engine.tier, hbm_per_chip_gb=80.0)
        params = model_bytes(engine.model)
        pool = tensor_bytes(engine.pool.values())
        require(budget["params_bytes"] == params
                and budget["kv_bytes"] == pool,
                f"{name}: budget {budget} against the engine's {params} "
                f"weight and {pool} pool bytes")
        out[name] = {"budget": budget, "engine_params_bytes": params,
                     "engine_pool_bytes": pool}
    orin = out["orin"]["budget"]
    small = dataclasses.replace(
        router.tiers["orin"].tier,
        hbm_gb_per_chip=(orin["params_bytes"] + orin["kv_bytes"]) / 2e9
        + 0.75)
    try:
        EngineManager(small, device=router.device).start_server()
    except TierOverCapacityError as exc:
        out["refused"] = str(exc)
    else:
        fail("a tier over its hbm_gb_per_chip budget was built")
    out["peak_memory_gb"] = peak_memory_gb(torch, on_card)
    return out


def chat_phase(torch, cluster, *, burst: int = len(CHAT_QUERIES),
               streams: int = 2,
               expect=(), device: str = "cuda"):
    """Serve ``create_app`` over a production-mode Router (``BASE_CONFIG``)
    of ``cluster`` over HTTP, and drive every routing strategy
    (``drive_chat``, the strategy selected per request; the routing cache
    is cleared before each strategy, so each one's split of traffic is its
    own decisions, not the previous strategy's cached ones).  Both tiers must
    serve, the kernels in ``expect`` launch, the ragged decode kernels
    and every plain version stay at 0 and, with the orin tier on an int8
    pool, the int8 suffix chunk run.  Then the obs layer over what was
    served (``obs_checks``: /metrics, /debug/trace, phase coverage,
    attribution, the flight recorder; the router's own registry, its
    recorder keeping every request), and, on the card, a per-kernel
    capture of served ticks (``per_kernel_capture``) and the profiler's
    overhead (``profiler_overhead``); the memory budget against the
    engines' tensors (``hbm_budget_check``); the dense tick's logits on
    both live pools.  Returns (numbers, launches by kernel)."""
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.app import BASE_CONFIG, create_app
    from distributed_llm_tpu_torch.serving.router import Router

    on_card = device == "cuda"
    fresh_peak(torch, on_card)
    with admission_audit(torch, on_card) as audit:
        t0 = time.perf_counter()
        router = Router(strategy="hybrid", config=dict(BASE_CONFIG),
                        cluster=cluster, device=device,
                        observability=Observability(slow_ms=0.0))
        for tier in router.tiers.values():
            tier.server_manager.start_server()      # build + warm
        startup_s = time.perf_counter() - t0
        try:
            with http_served(create_app(router=router)) as base:
                return chat_traffic(torch, router, cluster, base, burst,
                                    streams, expect, on_card, startup_s,
                                    audit)
        finally:
            router.drain(timeout_s=30)


def chat_traffic(torch, router, cluster, base: str, burst: int,
                 streams: int, expect, on_card: bool, startup_s: float,
                 audit: AdmissionAudit):
    """``chat_phase``'s main path and checks against the served app."""
    from distributed_llm_tpu_torch.ops import attention as TA

    with urllib.request.urlopen(base + "/health", timeout=30) as resp:
        require(resp.status == 200, "/health not ok")
    reset_counts()
    audit.mark()
    t_main = time.perf_counter()
    by_strategy = {}
    for st in STRATEGIES:
        router.query_router.clear_cache()
        by_strategy[st] = drive_chat(base, st, burst, streams)
    main_s = time.perf_counter() - t_main
    launches, plain_calls = read_counts(expect, on_card)
    admission = audit.main_path(on_card)
    int8_chunk_calls = TA._dequant_chunk_paged.calls
    require(launches["ragged_decode"] == 0
            and launches["ragged_decode_q8"] == 0,
            f"a ragged decode kernel ran on the dense tick: {launches}")
    nano_n = sum(v["nano"] for v in by_strategy.values())
    orin_n = sum(v["orin"] for v in by_strategy.values())
    require(nano_n > 0 and orin_n > 0,
            f"a tier served no traffic (nano {nano_n}, orin {orin_n})")
    if cluster.orin.kv_quantize == "int8":
        require(int8_chunk_calls > 0, "the int8 suffix chunk did not run")
    obs = obs_checks(router, base, by_strategy)
    capture = overhead = None
    if on_card:
        capture = per_kernel_capture(torch, router, os.path.join(
            REPO, "build", "traces"))
        overhead = profiler_overhead(router)
    budget = hbm_budget_check(torch, router, on_card)
    engines = {n: t.server_manager.engine() for n, t in
               router.tiers.items()}
    numbers = {
        "obs": obs, "per_kernel_capture": capture,
        "profiler_overhead": overhead, "hbm_budget": budget,
        "startup_s": startup_s, "main_path_s": main_s,
        "tiers": {n: {"model": e.tier.model_preset, "slots":
                      e.paged.max_slots, "kv_quantize": e.tier.kv_quantize,
                      "ragged": e.ragged, "tick_stats": e.tick_stats()}
                  for n, e in engines.items()},
        "by_strategy": by_strategy, "launches": launches,
        "plain_calls": plain_calls, "int8_chunk_calls": int8_chunk_calls,
        "cache": router.query_router.get_cache_stats()["hit_rate"],
        "dense_logits_check": {n: dense_logits_check(torch, e)
                               for n, e in engines.items()},
        "tick_graph_check": {n: tick_graph_check(torch, e)
                             for n, e in engines.items()},
        "prefill_graph_check": {n: prefill_graph_check(torch, e)
                                for n, e in engines.items()},
        "admission": dict(admission, warmup_memory=audit.warmup),
        "routing_device_check": routing_device_check(
            "cuda" if on_card else "cpu"),
        "peak_memory_gb": peak_memory_gb(torch, on_card)}
    return numbers, launches


# -- phase 11: the bench --------------------------------------------------------

# What phase 11 gives the headline: its wall-clock budget (the sweep gets
# 45%, so a repeat of the five strategies fits), one repeat, 4 clients.
# -- phases 12-13: the constrained pool and the host spill tier --------------

PRESSURE_NEW = 256               # decode budget of every pressure request
PRESSURE_WORDS = 400             # about 900 tokens a long prompt


def near_tie(torch, engine, ids, want, got) -> dict:
    """Where ``got`` first differs from ``want`` (the unpreempted run's
    tokens after prompt ``ids``), and how near a tie the two picks were
    there.  The state: ids + want[:p] but its last token, chunk-prefilled
    by the engine's own chunk path into scratch blocks of its pool, then
    one decode step at the last position, run three ways (``three_ways``: the
    kernels, the plain attention, the plain attention in float32) as
    ``logits_check`` runs it.  Two correct paths' logits each lie within
    ``tol`` = LOGITS_RTOL x scale + floor of the float32 ones
    (``check_three``'s bound), so the gap between the two picks may move
    by up to 2 tol from one path to the other: ``near_tie`` when the
    kernel logits' gap logit[want] - logit[got] is at most that.  The
    paths differ on the card: a replay's K/V comes from a prefill (products
    of many rows) where the first run's came from decode ticks (1-8 rows),
    and a slot's step may run in a plain tick or a speculative round's
    wider verify, with other slots beside it (another split-K plan)."""
    from distributed_llm_tpu_torch.engine.paged_kv import (
        chunk_prefill_paged, decode_step_paged)

    p = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    seq = list(ids) + list(want[:p])
    n, c, bs = len(seq), engine.chunk_tokens, engine.paged.block_size
    blocks = engine._alloc_evicting(-(-n // bs))   # parked prefixes go
    require(blocks is not None, "no scratch blocks for the near-tie check")
    dev = engine.device
    row = torch.from_numpy(engine._table_row(blocks)).to(dev)
    try:
        with torch.no_grad():
            for start in range(0, n - 1, c):
                toks = torch.full((1, c), engine.tokenizer.pad_id,
                                  dtype=torch.long)
                chunk = seq[start:min(start + c, n - 1)]
                toks[0, :len(chunk)] = torch.tensor(chunk)
                window = next(w for w in engine._chunk_windows
                              if w >= start + c)
                chunk_prefill_paged(
                    engine.cfg, engine.model, toks.to(dev),
                    torch.tensor([start], dtype=torch.int32, device=dev),
                    torch.tensor([n - 1], dtype=torch.int32, device=dev),
                    engine.pool, row, window)
            cur = torch.tensor([seq[-1]], device=dev)
            pos = torch.tensor([n - 1], dtype=torch.int32, device=dev)
            kernel, plain, ref = three_ways(lambda pool: decode_step_paged(
                engine.cfg, engine.model, cur, pos, pool, row[None])[0].float(),
                engine.pool)
    finally:
        engine.allocator.free(blocks)
    scale = ref.abs().max().item()
    floor = (plain - ref).abs().max().item()
    tol = LOGITS_RTOL * scale + floor
    top2 = kernel.topk(2)
    out = {"position": p, "of": len(want),
           "want": want[p] if p < len(want) else None,
           "got": got[p] if p < len(got) else None,
           "top2": [int(i) for i in top2.indices],
           "top2_gap": float(top2.values[0] - top2.values[1]),
           "scale": scale, "floor": floor, "tol": tol,
           "kernel_vs_float32": (kernel - ref).abs().max().item(),
           "near_tie": False}
    if p < min(len(want), len(got)):
        out["pick_gap"] = float(kernel[want[p]] - kernel[got[p]])
        out["got_rank"] = int((kernel > kernel[got[p]]).sum())
        out["near_tie"] = abs(out["pick_gap"]) <= 2 * tol
    return out


def pressure_phase(torch, tier, *, pool_blocks: int, n_long: int,
                   n_short: int, expect, device: str = "cuda"):
    """A constrained pool under load: ``n_short`` short prompts, then, once
    they decode, ``n_long`` prompts of about 900 tokens at once, each with
    a 256-token budget, sent over HTTP to ``tier`` with
    ``kv_pool_blocks=pool_blocks`` (which they overrun).  First the same requests on the same tier at
    full residency (no preemption: the reference, not the main path).
    There must be at least one preemption and one cancelled chunked
    prefill; every request is answered with no error and no truncation;
    each request's tokens equal the reference's or differ first at a
    near-tie (``near_tie``); every kernel in ``expect`` launched and no
    plain attention version ran; ``tick_graph_check`` passes on the
    engine after its preemptions; and with the prefix cache cleared at
    the end every block is back on the free list.  Reports the
    preemptions (and those in a speculative round's growth), the
    cancelled prefills, each replay's wall time from its first
    re-admission try to its slot going live, and the serving numbers.
    Returns (numbers, launches by kernel)."""
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine)
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt
    from distributed_llm_tpu_torch.engine.paged_kv import pool_block_bytes

    on_card = device == "cuda"
    tier = dataclasses.replace(tier, max_new_tokens=PRESSURE_NEW)
    prompts = ([f"long {i}: " + words(PRESSURE_WORDS, 3 * i)
                for i in range(n_long)]
               + [f"short {i}: " + words(24, 7 * i) for i in range(n_short)])
    fresh_peak(torch, on_card)
    ref = ContinuousBatchingEngine(tier, seed=0, device=device)
    try:
        reqs = [ref.submit(p, max_new_tokens=PRESSURE_NEW) for p in prompts]
        for r in reqs:
            require(r.done.wait(timeout=600) and r.error is None,
                    f"{tier.name} pressure reference failed: {r.error}")
        want = {p: r.result.token_ids for p, r in zip(prompts, reqs)}
        ref_preempted = ref.preempted_total
    finally:
        ref.stop()
    del ref, reqs
    require(ref_preempted == 0, "the full-residency reference preempted")

    ctier = dataclasses.replace(tier, kv_pool_blocks=pool_blocks)
    with admission_audit(torch, on_card) as audit, \
            served(torch, ctier, device) as (engine, base, startup_s):
        submitted, replays, spec_preempts, preempted_at = [], {}, [0], {}
        real = {name: getattr(engine, name) for name in (
            "submit", "_admit_replay", "_slot_go_live", "_ensure_growth",
            "_preempt")}

        def preempt(ix):
            preempted_at.setdefault(id(engine._slots[ix].request),
                                    len(engine._slots[ix].tokens))
            real["_preempt"](ix)

        def submit(*a, **k):
            req = real["submit"](*a, **k)
            submitted.append(req)
            return req

        def admit_replay(req, *a):
            episode = replays.setdefault(id(req), [])
            if not episode or "ms" in episode[-1]:
                episode.append({"t0": time.perf_counter(),
                                "generated": len(req.replay_tokens)})
            return real["_admit_replay"](req, *a)

        def go_live(req, *a, gen=None, **k):
            if gen is not None:
                ep = replays[id(req)][-1]
                ep["ms"] = (time.perf_counter() - ep.pop("t0")) * 1e3
                ep["chunked"] = engine._chunk_gate(next(
                    bb for bb in engine._buckets
                    if bb >= k["prompt_len"] + len(gen) - 1))
            return real["_slot_go_live"](req, *a, gen=gen, **k)

        def ensure_growth(active, spec_gb=None):
            before = engine.preempted_total
            real["_ensure_growth"](active, spec_gb)
            if spec_gb is not None:
                spec_preempts[0] += engine.preempted_total - before

        engine.submit, engine._admit_replay = submit, admit_replay
        engine._slot_go_live, engine._ensure_growth = go_live, ensure_growth
        engine._preempt = preempt
        preempted0 = engine.preempted_total
        cancelled0 = engine.prefill_cancelled_total
        reset_counts()
        audit.mark()
        results = [None] * len(prompts)

        def worker(i, p):
            results[i] = query(base, p, num_predict=PRESSURE_NEW)

        t_main = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i, p))
                   for i, p in enumerate(prompts)]
        # The short requests first (they decode, and speculate on a tier
        # with a draft), then the long ones at once: the youngest victim
        # is then a long request, whose replay is a chunked prefill that
        # the decoders' growth can cancel.
        for t in threads[n_long:]:
            t.start()
        deadline = time.monotonic() + 30
        while (sum(s is not None for s in engine._slots) < n_short
               and time.monotonic() < deadline):
            time.sleep(0.002)
        for t in threads[:n_long]:
            t.start()
        for t in threads:
            t.join(timeout=900)
        main_s = time.perf_counter() - t_main
        launches, plain_calls = read_counts(expect, on_card)
        admission = audit.main_path(on_card)
        for name in real:
            delattr(engine, name)
        require(all(r is not None for r in results),
                f"{tier.name}: a pressure request was not answered")
        preempted = engine.preempted_total - preempted0
        cancelled = engine.prefill_cancelled_total - cancelled0
        seen = json.dumps({
            "preempted": preempted, "cancelled": cancelled,
            "requests": [(r.result.prompt_tokens, r.result.gen_tokens,
                          r.preempt_count, round(r.result.ttft_ms, 1))
                          for r in submitted if r.result is not None],
            "kv": engine.kv_stats()})
        require(preempted >= 1, f"{tier.name}: no preemption on a pool of "
                f"{pool_blocks} blocks: {seen}")
        require(cancelled >= 1, f"{tier.name}: no chunked prefill was "
                f"cancelled: {seen}")
        require(len(submitted) == len(prompts), "the requests went astray")
        tick = tick_graph_check(torch, engine)   # on a parked conversation
        identical, ties = 0, []
        for req in submitted:
            got, w = req.result.token_ids, want[req.history]
            require(req.error is None, f"{tier.name}: {req.error}")
            if got == w:
                identical += 1
                continue
            require(len(got) >= len(w) or got != w[:len(got)],
                    f"{tier.name}: a request was truncated at {len(got)} "
                    f"of {len(w)} tokens")
            ids, _ = prepare_prompt(engine.tokenizer, req.history,
                                    ctier.prefill_buckets,
                                    engine.cfg.max_seq_len,
                                    ctier.max_new_tokens)
            tie = near_tie(torch, engine, ids, w, got)
            tie["preempted"] = req.preempt_count
            tie["preempted_at"] = preempted_at.get(id(req))
            ties.append(tie)
            require(tie["near_tie"], f"{tier.name}: a request's tokens "
                    f"left the unpreempted run's away from a near-tie: {tie}"
                    f" {seen}")
        engine.prefix_cache.clear()
        require(engine.allocator.available == engine.paged.num_blocks - 1,
                f"{tier.name}: {engine.allocator.available} of "
                f"{engine.paged.num_blocks - 1} blocks free at the end")
        stats = [r["stats"] for r in results]
        replayed = [ep for eps in replays.values() for ep in eps if "ms" in ep]
        require(replayed, f"{tier.name}: no replay went live")
        out = {
            "tier": tier.name, "model": tier.model_preset,
            "draft": tier.draft_preset if engine.spec else None,
            "quantize": tier.quantize, "kv_quantize": tier.kv_quantize,
            "slots": tier.decode_batch, "pool_blocks": pool_blocks,
            "pool_block_bytes": pool_block_bytes(
                engine.cfg, ctier.kv_block_size, ctier.kv_quantize),
            "full_residency_blocks": engine.paged.max_slots
            * engine.paged.blocks_per_slot,
            "requests": len(prompts), "startup_s": startup_s,
            "main_path_s": main_s, "preempted": preempted,
            "preempted_in_spec_growth": spec_preempts[0],
            "prefill_cancelled": cancelled,
            "preempt_counts": sorted(r.preempt_count for r in submitted),
            "replays": replayed, "tokens_identical": identical,
            "near_ties": ties,
            "near_tie_bound": f"|logit[want] - logit[got]| <= 2 x "
                              f"({LOGITS_RTOL:g} x max|logit| + floor)",
            "gen_tokens": sum(s["gen_tokens"] for s in stats),
            "tokens_per_s": sum(s["gen_tokens"] for s in stats) / main_s,
            "p50_ttft_ms": statistics.median(s["ttft_ms"] for s in stats),
            "launches": launches, "plain_calls": plain_calls,
            "tick_stats": engine.tick_stats(), "tick_graph_check": tick,
            "admission": dict(admission, warmup_memory=audit.warmup),
            "peak_memory_gb": peak_memory_gb(torch, on_card)}
    return out, launches


SPILL_WORDS = 440                # about 1000 tokens a session prompt


def spill_chip_phase(torch, nano, *, expect, device: str = "cuda"):
    """The host spill tier at full width: the bench's spill leg
    (``bench.headline.spill_phase``) on nano_1b with an 80-block pool
    (about 4 parked sessions of 16 blocks), 16 sessions of about 1000
    tokens, host budgets OFF, 4 sessions' worth and 32 sessions' worth.
    ``warm_hit_rate`` must be monotone over the three, the outputs
    identical across them and the race sub-check must observe its
    fallback (the leg's own ``error`` rules); the large budget must have
    demoted and promoted; every kernel in ``expect`` launched and no plain
    attention version ran; no spill copy was a program.  Reports the TTFT
    of the promoted revisits beside the cold ones, the co-tenant's TBT p95
    ratio, the demote and promote counts and the host bytes held."""
    from distributed_llm_tpu_torch.bench import headline

    on_card = device == "cuda"
    base = dataclasses.replace(nano, max_new_tokens=6, decode_batch=4,
                               prefix_cache_entries=32, kv_pool_blocks=80)
    fresh_peak(torch, on_card)
    with admission_audit(torch, on_card) as audit:
        reset_counts()
        audit.mark()
        t0 = time.perf_counter()
        out = headline.spill_phase(device, n_sessions=16, base=base,
                                   filler=words(SPILL_WORDS), entry_blocks=16)
        wall_s = time.perf_counter() - t0
        launches, plain_calls = read_counts(expect, on_card)
        admission = audit.main_path(on_card)
    require("error" not in out, f"spill phase: {out.get('error')}")
    large, off = out["large"], out["off"]
    require(large["demotions_total"] and large["promotions"] > 0,
            f"spill phase: nothing demoted or promoted: {large}")
    require(admission["spill_copies"] > 0,
            f"spill phase: no spill copy was recorded: {admission}")
    out.update({"wall_s": wall_s, "launches": launches,
                "plain_calls": plain_calls, "admission": admission,
                "promoted_ttft_p50_ms": large.get("promoted_ttft_p50_ms"),
                "cold_ttft_p50_ms": off.get("cold_ttft_p50_ms"),
                "host_bytes_large": large.get("host_bytes"),
                "peak_memory_gb": peak_memory_gb(torch, on_card)})
    return out, launches


# -- phases 14-15: the trained tiny /chat and the bench's engine legs -------

@contextlib.contextmanager
def uncounted():
    """Kernel launches (by shard too) and plain-version calls made inside
    are taken back: a near-tie check compares paths, it is no main
    path."""
    from distributed_llm_tpu_torch.ops import launches
    saved = (launches.counts(), launches.call_counts(),
             launches.route_counts(), launches.shard_counts())
    try:
        yield
    finally:
        for name, fn in kernel_wrappers().items():
            fn.launches = saved[0][name]
        for name, fn in launches.plain_paths().items():
            fn.calls = saved[1][name]
        launches.add_routes(launches.since(saved[2], launches.route_counts()),
                            -1)
        launches.reset_shards()
        launches.add_shards(saved[3])


def tie_checker(torch):
    """``near_tie`` as the bench legs' ``tie_check``, uncounted."""
    def check(engine, ids, want, got):
        with uncounted():
            return near_tie(torch, engine, ids, want, got)
    return check


@contextlib.contextmanager
def float32_presets(names):
    """The named model presets at float32 inside (the CPU reference)."""
    from distributed_llm_tpu_torch import config as C
    saved = {n: C.MODEL_PRESETS[n] for n in names}
    for n, cfg in saved.items():
        C.MODEL_PRESETS[n] = dataclasses.replace(cfg, dtype="float32")
    try:
        yield
    finally:
        C.MODEL_PRESETS.update(saved)


# (session, message): two turns nano answers, one orin answers, then a
# follow-up in the first session (a prefix hit: the paged suffix chunk).
TRAINED_CHAT = (
    ("t0", "hello there"),
    ("t1", "what is 2+2"),
    ("t2", "Implement a dynamic-programming solution to the knapsack "
           "problem and analyze its complexity"),
    ("t0", "tell me about the tallest mountains"),
)


def chat_turns(router, post_chat) -> list:
    """TRAINED_CHAT through ``post_chat(body) -> reply dict``, one turn at
    a time: each turn's device and reply, the serving tier's token ids and
    the history the router gave that tier."""
    sent = {}
    for name, client in router.tiers.items():
        def process(history, real=client.process, name=name):
            sent[name] = [dict(m) for m in history]
            return real(history)
        client.process = process
    turns = []
    for session, message in TRAINED_CHAT:
        reply = post_chat({"message": message, "session_id": session})
        tier = reply["device"]
        turns.append({"session": session, "device": tier,
                      "reply": reply["reply"],
                      "tokens": list(router.tiers[tier].last_result.token_ids),
                      "history": sent[tier]})
    return turns


def trained_chat_phase(torch, *, expect, device: str = "cuda"):
    """The repo's trained tiny tiers (``with_default_checkpoints(
    tiny_batched_cluster())``: nano_test v500, orin_test v320, head dim
    16, 16-token blocks, the ragged tick) behind ``create_app`` on
    ``device``, over HTTP: the greedy /chat replies of TRAINED_CHAT must
    equal the port's own replies on the CPU (float32 presets, the plain
    versions), turn for turn, device and text.  A reply that differs must
    trace to a near-tie (``near_tie`` on the card's engine, at the first
    token where the card's tier and the CPU's part); a later turn of that
    session is then not compared (its history holds the other reply).
    The kernels in ``expect`` launch and no plain version runs."""
    from distributed_llm_tpu_torch.config import (tiny_batched_cluster,
                                                  with_default_checkpoints)
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt
    from distributed_llm_tpu_torch.serving.app import create_app

    on_card = device == "cuda"
    cluster = with_default_checkpoints(tiny_batched_cluster())
    require(all(t.checkpoint_path for t in cluster.tiers()),
            f"no trained checkpoint in {cluster}")
    presets = [t.model_preset for t in cluster.tiers()]
    with float32_presets(presets):
        app = create_app(cluster=cluster, device="cpu")
        ref_router = app.extensions["dllm_state"]["router"]
        client = app.test_client()
        try:
            want = chat_turns(ref_router, lambda body: json.loads(
                client.post("/chat", json=body).body))
        finally:
            ref_router.drain(timeout_s=10.0)
    fresh_peak(torch, on_card)
    with admission_audit(torch, on_card) as audit:
        t0 = time.perf_counter()
        app = create_app(cluster=cluster, device=device)
        router = app.extensions["dllm_state"]["router"]
        for tier in router.tiers.values():
            tier.server_manager.start_server()       # build + warm
        startup_s = time.perf_counter() - t0
        with http_served(app) as base:
            reset_counts()
            audit.mark()
            t0 = time.perf_counter()
            got = chat_turns(router, lambda body: chat_post(base, "/chat",
                                                            body))
            main_s = time.perf_counter() - t0
            launches, plain_calls = read_counts(expect, on_card)
            admission = audit.main_path(on_card)
    try:
        turns, parted = [], set()
        for w, g in zip(want, got):
            entry = {"session": g["session"], "device": g["device"],
                     "reply": g["reply"], "tokens": len(g["tokens"])}
            if w["session"] in parted:
                entry["compared"] = "no: an earlier turn differed"
            else:
                require(g["device"] == w["device"],
                        f"trained /chat routed {g} to {g['device']}, the "
                        f"CPU to {w['device']}")
                entry["identical"] = g["reply"] == w["reply"]
                if not entry["identical"]:
                    tier = router.tiers[g["device"]].tier
                    engine = router.tiers[g["device"]].server_manager.engine()
                    ids, _ = prepare_prompt(engine.tokenizer, g["history"],
                                            tier.prefill_buckets,
                                            engine.cfg.max_seq_len,
                                            tier.max_new_tokens)
                    with uncounted():
                        tie = near_tie(torch, engine, ids, w["tokens"],
                                       g["tokens"])
                    require(tie["near_tie"],
                            f"trained /chat reply differs from the CPU's "
                            f"beyond a near-tie: {g['reply']!r} against "
                            f"{w['reply']!r}: {tie}")
                    entry["near_tie"] = tie
                    parted.add(w["session"])
            turns.append(entry)
        require(any(t.get("identical") for t in turns),
                f"no trained /chat reply equals the CPU's: {turns}")
    finally:
        router.drain(timeout_s=30.0)
    return {"cluster": {t.name: [t.model_preset, t.checkpoint_path]
                        for t in cluster.tiers()},
            "turns": turns, "startup_s": startup_s, "main_path_s": main_s,
            "launches": launches, "plain_calls": plain_calls,
            "admission": admission,
            "peak_memory_gb": peak_memory_gb(torch, on_card)}, launches


# The legs phase at full width: the speculative leg's γ cap (orin_8b's
# group of 4 heads keeps γ + 1 = 9 verify rows a head group within the
# verify kernel's 40), the shared leg's system prompt (about 1600 tokens,
# 25 of nano_1b's 64-token blocks, so the shared prefix dominates as the
# tiny leg's does in 16-token blocks) and the open-loop leg's budget (the
# bench cluster's start and warmup included; cut from 75 s to 40 to pay
# for phases 19 and 20, each rate point 1.26 s, not 2.37; to 32 for
# phase 22; and to 24 for W1's wide shapes, each point 1.0 s).
LEG_GAMMA_MAX = 8
LEG_SHARED_PREFIX = "system: " + words(700) + ". answer in one sentence."
LEG_OPENLOOP_S = 24.0


def legs_phase(torch, nano, orin, *, device: str = "cuda"):
    """The bench's engine legs and the open-loop leg at full width:
    ``skew``, ``mixed`` and ``shared`` on nano_1b (``mixed`` with the
    buckets (64, 1792): its long prompt goes in the 1792 bucket), ``spec``
    on orin_8b with the nano_1b draft, ``openloop`` on the bench cluster
    with a LEG_OPENLOOP_S budget.  Each leg's counts are set to 0 just
    before it and read just after: its kernels must launch and no plain
    version may run; its admission programs are audited.  Each leg's hard
    invariants hold (one ragged decode program, the speculative program
    family, peak blocks shared under 0.6 x exclusive, a knee), and greedy
    outputs are identical across each leg's modes or every flip is a
    near-tie (``tie_checker``).  Returns (numbers by leg, launches summed
    over the legs)."""
    from distributed_llm_tpu_torch.bench import legs, openloop
    from distributed_llm_tpu_torch.config import bench_cluster

    on_card = device == "cuda"
    tie = tie_checker(torch)
    plain = dict(max_new_tokens=24, enable_prefix_cache=False)
    runs = {
        "skew": (lambda: legs.skew_phase(
            device, tier=dataclasses.replace(nano, **plain), tie_check=tie),
            ("paged_decode", "ragged_decode", "flash_causal")),
        "spec_phase": (lambda: legs.spec_phase(
            device, gamma_max=LEG_GAMMA_MAX, tie_check=tie,
            tier=dataclasses.replace(orin, draft_preset=nano.model_preset,
                                     **plain)),
            ("ragged_verify", "ragged_decode", "flash_causal")),
        "mixed": (lambda: legs.mixed_phase(
            device, tie_check=tie, tier=dataclasses.replace(
                nano, decode_batch=2, decode_steps_per_tick=1,
                max_new_tokens=64, prefill_buckets=(64, 1792),
                enable_prefix_cache=False)),
            ("flash_causal", "paged_chunk", "ragged_decode")),
        "shared": (lambda: legs.shared_prefix_phase(
            4, device=device, prefix=LEG_SHARED_PREFIX, tie_check=tie,
            tier=dataclasses.replace(nano, max_new_tokens=6)),
            ("paged_chunk", "flash_causal", "ragged_decode")),
        "openloop": (lambda: openloop.openloop_phase(
            budget_s=LEG_OPENLOOP_S, device=device, cluster=bench_cluster()),
            ("w8_matmul", "ragged_decode", "flash_causal", "paged_chunk")),
    }
    out = {}
    total = {name: 0 for name in kernel_wrappers()}
    for name, (run, expect) in runs.items():
        fresh_peak(torch, on_card)
        with admission_audit(torch, on_card) as audit:
            reset_counts()
            audit.mark()
            t0 = time.perf_counter()
            res = run()
            wall_s = time.perf_counter() - t0
            launches, plain_calls = read_counts(expect if on_card else (),
                                                on_card)
            admission = audit.main_path(on_card)
        require("error" not in res, f"{name} leg: {res.get('error')}")
        if name != "openloop":
            require(res["outputs_identical"] or (
                res.get("flips") and all(f["near_tie"]
                                         for f in res["flips"])),
                f"{name} leg: outputs differ beyond a near-tie: "
                f"{res.get('flips')}")
        res.update({"wall_s": wall_s, "launches": launches,
                    "plain_calls": plain_calls, "admission": admission,
                    "peak_memory_gb": peak_memory_gb(torch, on_card)})
        out[name] = res
        for k, n in launches.items():
            total[k] += n
        log(f"leg {name} run in {wall_s:.1f}s")
    require(out["skew"]["ragged"]["compiled_decode_programs"] == 1,
            f"skew leg: {out['skew']['ragged']}")
    spec_on = out["spec_phase"]["on"]
    require(0 < spec_on["verify_programs"] <= len(spec_on["gamma_buckets"])
            and spec_on["drafted_total"] > 0,
            f"spec leg: {spec_on}")
    require(out["shared"]["peak_ratio"] < 0.6,
            f"shared leg: peak ratio {out['shared'].get('peak_ratio')}")
    for mode in ("monolithic", "chunked"):
        require("error" not in out["mixed"][mode] and not
                out["mixed"][mode]["errors"],
                f"mixed leg {mode}: {out['mixed'][mode]}")
    require((out["openloop"].get("knee_req_per_s") or 0) > 0,
            f"openloop leg: no knee: {out['openloop']}")
    return out, total


def leg_summary(res: dict) -> dict:
    """One leg's card numbers for the printed line (full detail in the
    report)."""
    pick = {
        "skew": lambda r: {
            "tick_p50_ratio_ragged_over_dense":
                r.get("tick_p50_ratio_ragged_over_dense"),
            **{m: {k: r[m][k] for k in ("decode_tick_p50_ms",
                                        "decode_tick_p95_ms", "req_per_s",
                                        "compiled_decode_programs")}
               for m in ("dense", "ragged")}},
        "spec_phase": lambda r: {
            "tok_ratio": r.get("tok_ratio"),
            "wall_tok_ratio": r.get("wall_tok_ratio"),
            **{m: {k: r[m][k] for k in ("tok_per_s", "accept_ratio",
                                        "per_slot_accept", "verify_programs",
                                        "gamma_buckets")}
               for m in ("off", "on")}},
        "mixed": lambda r: {m: {k: r[m][k] for k in (
            "tbt95_ratio", "stall_max_ms", "stall_calm_ms", "long_ttft_ms",
            "short_tbt_p95_ms", "calm_tbt_p95_ms")}
            for m in ("monolithic", "chunked")},
        "shared": lambda r: {
            "peak_ratio": r.get("peak_ratio"),
            "ttft_p50_ratio": r.get("ttft_p50_ratio"),
            **{m: {k: r[m][k] for k in ("peak_resident_blocks",
                                        "warm_ttft_p50_ms",
                                        "tokens_saved_shared",
                                        "tokens_saved_exclusive")}
               for m in ("on", "off")}},
        "openloop": lambda r: {k: r.get(k) for k in (
            "base_seq_req_per_s", "point_s", "knee_req_per_s",
            "goodput_at_knee", "slo_attainment")}
            | {"overload": {k: (r.get("overload") or {}).get(k) for k in (
                "offered_req_per_s", "availability", "slo_attainment",
                "hung_clients", "incidents_recorded")}},
    }
    return {name: {**fn(res[name]),
                   "outputs_identical": res[name].get("outputs_identical"),
                   "flips": [{k: f.get(k) for k in ("request", "position",
                                                    "top2_gap", "pick_gap",
                                                    "tol", "near_tie")}
                             for f in res[name].get("flips", ())],
                   "wall_s": res[name].get("wall_s")}
            for name, fn in pick.items() if isinstance(res.get(name), dict)}


# -- phase 16: the fleet (fault injection, health monitor, replicas) --------

# Part (b): the decode watchdog's deadline and the HealthMonitor's period,
# the streams in flight on r0 at the kill and their budget (random weights
# rarely stop at EOS: they are still decoding when the loop dies).
FLEET_WATCHDOG_S = 4.0
FLEET_HEALTH_S = 0.5
FLEET_STREAMS = 6
FLEET_STREAM_TOKENS = 192
# Part (c): the replica leg's requests (the bench's default is 48; its
# speedup is reported, not enforced).
FLEET_REPLICA_REQUESTS = 32
# The rescued replica's device memory after the restart and a collection
# may exceed the memory before the kill by at most this share (the same
# pool and weights are rebuilt; a dead engine left alive would double
# them).
FLEET_MEMORY_SLACK = 0.05


def _fleet_part(torch, name: str, run, expect, on_card: bool) -> tuple:
    """Run one part of the fleet phase as a main path: counts set to 0
    just before, read just after (every kernel in ``expect`` launched, no
    plain attention version ran), every engine built inside audited.
    Returns (numbers, launches)."""
    fresh_peak(torch, on_card)
    with admission_audit(torch, on_card) as audit:
        reset_counts()
        audit.mark()
        t0 = time.perf_counter()
        res = run(audit)
        wall_s = time.perf_counter() - t0
        launches, plain_calls = read_counts(expect if on_card else (),
                                            on_card)
        admission = audit.main_path(on_card)
    res.update({"wall_s": wall_s, "launches": launches,
                "plain_calls": plain_calls, "admission": admission,
                "peak_memory_gb": peak_memory_gb(torch, on_card)})
    log(f"fleet {name} run in {wall_s:.1f}s")
    return res, launches


def fleet_chaos(torch, cluster, device: str = "cuda") -> dict:
    """Part (a): the bench cluster (nano_1b and orin_8b, int8 weights)
    behind a Router with a ``FaultInjector`` and the chaos leg's fast
    breaker (2 failures, 0.4 s), under the chaos leg's schedule (nano
    flaps 3 times, 1.0 s period, 0.45 s down; a 50 ms orin latency spike)
    with 4 clients per strategy (heuristic, hybrid, perf).  Then one
    stream whose nano tier dies after its first delta must fail over to
    orin mid-stream and replay its prefix: what follows equals orin's own
    answer past the prefix.  No client may hang or raise."""
    from distributed_llm_tpu_torch.bench import fleet
    from distributed_llm_tpu_torch.serving.router import Router
    from distributed_llm_tpu_torch.utils.faults import FaultInjector

    fi = FaultInjector()
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=fleet.chaos_cluster(cluster),
                    fault_injector=fi, device=device)
    try:
        t0 = time.perf_counter()
        for tier in router.tiers.values():
            tier.server_manager.start_server()
        startup_s = time.perf_counter() - t0
        out = fleet.chaos_on(router, fi)
        for name in router.tiers:
            router.breaker.reset(name)
        hist = [{"role": "user", "content": "hi"}]
        expected = "".join(router.tiers["orin"].process_stream(hist))
        fi.fail_stream_after("nano", 1)
        routed = router.route_query_stream(hist)
        it = iter(routed)
        prefix = next(it)
        rest = "".join(it)
        out["mid_stream"] = {
            "device": routed.device, "prefix_chars": len(prefix),
            "chars": len(prefix) + len(rest),
            "replayed": rest == expected[len(prefix):]}
        out["startup_s"] = startup_s
    finally:
        for tier in router.tiers.values():
            tier.server_manager.stop_server()
    for strategy in ("heuristic", "hybrid", "perf"):
        st = out[strategy]
        require(st["requests"] > 0 and not st["errors"]
                and not st["hung_clients"],
                f"fleet chaos {strategy}: {st}")
    ms = out["mid_stream"]
    require(ms["device"] == "orin" and ms["replayed"],
            f"fleet chaos: the mid-stream failover did not replay the "
            f"prefix on orin: {ms}")
    return out


def fleet_rescue(torch, cluster, audit, device: str = "cuda") -> dict:
    """Part (b): nano_1b with ``replicas=2`` (8 slots each, a host spill
    tier, the decode watchdog at FLEET_WATCHDOG_S) behind a Router whose
    HealthMonitor probes every FLEET_HEALTH_S.  A prompt's prefix is
    demoted to r0's host tier; FLEET_STREAMS greedy streams run on r1
    uninterrupted (the reference), then the same on r0, where
    ``crash_replica_engine`` kills the loop once every stream is primed.
    The monitor reads r0 wedged and restarts it through
    ``restart_replica``: every stream must finish with no error and no
    re-emitted delta (its text is its final tokens' clipped text), each
    one's tokens equal to the reference's or first differing at a
    near-tie; the demoted prefix must promote warm on the restarted r0
    (``dllm_spill_reattach_total`` grows by 1); the dead engine must be
    collected and the device memory after the restart and a collection
    within FLEET_MEMORY_SLACK of the memory before the kill."""
    from distributed_llm_tpu_torch.config import BENCHMARK_CFG
    from distributed_llm_tpu_torch.engine.paged_kv import pool_block_bytes
    from distributed_llm_tpu_torch.serving.router import Router
    from distributed_llm_tpu_torch.serving.turns import clip_turn
    from distributed_llm_tpu_torch.utils.faults import crash_replica_engine

    on_card = device == "cuda"
    nano = cluster.nano
    tier = dataclasses.replace(
        nano, replicas=2, watchdog_stall_s=FLEET_WATCHDOG_S,
        max_new_tokens=FLEET_STREAM_TOKENS,
        host_kv_bytes=64 * pool_block_bytes(nano.model(), nano.kv_block_size,
                                            nano.kv_quantize))
    cluster = dataclasses.replace(cluster, nano=tier)
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=cluster, device=device,
                    config=dict(BENCHMARK_CFG, enable_health_monitor=True,
                                health_interval_s=FLEET_HEALTH_S))
    client = router.tiers["nano"]
    r0, r1 = client._members
    warm = [{"role": "user", "content": "session warm: " + words(300)}]
    prompts = [[{"role": "user", "content": f"stream {i}: "
                 + words(40 + 30 * i, offset=7 * i)}]
               for i in range(FLEET_STREAMS)]
    out: dict = {"replicas": 2, "slots": tier.decode_batch,
                 "streams": FLEET_STREAMS, "budget": FLEET_STREAM_TOKENS,
                 "watchdog_s": FLEET_WATCHDOG_S,
                 "health_interval_s": FLEET_HEALTH_S}

    def run_streams(rep):
        handles = [rep.client.process_stream(p) for p in prompts]
        require(all(not isinstance(h, dict) for h in handles),
                f"fleet rescue: a stream was refused: {handles}")
        return handles

    def consume(handles):
        box = [None] * len(handles)

        def take(i, h):
            try:
                box[i] = ("".join(h), h.result)
            except Exception as exc:
                box[i] = (exc, None)
        threads = [threading.Thread(target=take, args=(i, h), daemon=True)
                   for i, h in enumerate(handles)]
        for t in threads:
            t.start()
        return threads, box

    # The counters live in the router's registry (here the process-global
    # one, which other phases' routers feed too): this part reads their
    # deltas.
    m = router.obs.m
    outcomes = ("sibling", "requeue", "failed")
    reattach0 = m.spill_reattach.labels("nano").value
    rescues0 = {o: m.replica_rescues.labels("nano", o).value
                for o in outcomes}
    try:
        client.server_manager.start_server()
        e0 = r0.mgr._engine
        # Park, then demote, the warm prompt's prefix on r0.
        first = r0.client.process(warm)
        require("response" in first, f"fleet rescue: warm request: {first}")
        while e0.prefix_cache.pop_oldest() is not None:
            pass
        require(e0.kv_spill.flush(10.0), "fleet rescue: demotion hung")
        spill = e0.kv_spill
        host = spill.stats()
        require(host["resident_entries"] >= 1,
                f"fleet rescue: nothing demoted: {host}")
        # The reference: the same streams, uninterrupted, on r1.
        threads, ref = consume(run_streams(r1))
        for t in threads:
            t.join(timeout=300)
        require(all(res is not None and res[1] is not None for res in ref),
                f"fleet rescue: a reference stream failed: {ref}")
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        mem_before = (torch.cuda.memory_allocated() if on_card else None)
        capture_before = audit.capture_s.get(f"{tier.name}/r0", 0.0)
        handles = run_streams(r0)
        threads, got = consume(handles)
        del handles
        active = e0.slot_stats()["active_slots"]
        t_kill = time.monotonic()
        require(crash_replica_engine(e0), "fleet rescue: no loop to kill")
        dead = weakref.ref(e0)
        del e0
        deadline = t_kill + 180.0
        while time.monotonic() < deadline:
            eng = r0.mgr._engine
            if eng is not None and eng is not dead():
                break
            time.sleep(0.01)
        mttr_ms = (time.monotonic() - t_kill) * 1000.0
        new = r0.mgr._engine
        require(new is not None and new is not dead(),
                "fleet rescue: r0 was not restarted")
        for t in threads:
            t.join(timeout=300)
        require(not any(t.is_alive() for t in threads),
                "fleet rescue: a rescued stream hung")
        flips = []
        tie = tie_checker(torch)
        ref_engine = r1.mgr._engine
        for i, ((ref_text, ref_res), (text, res)) in enumerate(zip(ref, got)):
            require(res is not None,
                    f"fleet rescue: stream {i} failed: {text!r}")
            # A re-emitted (or lost) delta shows in the stream's text against
            # its own final tokens, and against the reference's stream.
            require(text.strip() == clip_turn(res.text).strip(),
                    f"fleet rescue: stream {i} re-emitted or lost a delta")
            if list(res.token_ids) == list(ref_res.token_ids):
                require(text == ref_text,
                        f"fleet rescue: stream {i}'s deltas differ from the "
                        f"reference's on the same tokens")
            else:
                ids = ref_engine.affinity_token_ids(prompts[i])
                flip = tie(ref_engine, ids, list(ref_res.token_ids),
                           list(res.token_ids))
                flips.append({"stream": i, **flip})
        require(all(f["near_tie"] for f in flips),
                f"fleet rescue: a rescued stream differs beyond a near-tie: "
                f"{flips}")
        # The demoted prefix, warm on the restarted r0.
        promoted_before = spill.stats()["promotions_total"]
        second = r0.client.process(warm)
        require(second.get("response") == first["response"]
                and new.kv_spill is spill
                and spill.stats()["promotions_total"] > promoted_before,
                f"fleet rescue: the demoted prefix did not promote warm on "
                f"the restarted r0: {spill.stats()}")
        reattached = m.spill_reattach.labels("nano").value - reattach0
        require(reattached == 1,
                f"fleet rescue: dllm_spill_reattach_total grew by "
                f"{reattached}")
        rescues = {o: m.replica_rescues.labels("nano", o).value - rescues0[o]
                   for o in outcomes}
        monitor = router.health_monitor.snapshot()
        del ref, got, ref_engine, new
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        mem_after = torch.cuda.memory_allocated() if on_card else None
        require(dead() is None, "fleet rescue: the dead engine is alive")
        if on_card:
            require(mem_after <= mem_before * (1 + FLEET_MEMORY_SLACK),
                    f"fleet rescue: device memory {mem_after} after the "
                    f"restart against {mem_before} before the kill")
        out.update({
            "active_slots_at_kill": active,
            "rescue_mttr_ms": mttr_ms,
            "rescues": rescues,
            "restarts": monitor.get(f"{tier.name}/r0", {}).get("restarts"),
            "flips": [{k: f.get(k) for k in ("stream", "position",
                                             "pick_gap", "tol", "near_tie")}
                      for f in flips],
            "tokens_identical": not flips,
            "spill_reattached": reattached,
            "host_entries_at_kill": host["resident_entries"],
            "new_engine_programs": len(r0.mgr._engine._programs),
            "new_engine_capture_s": (audit.capture_s.get(f"{tier.name}/r0",
                                                         0.0)
                                     - capture_before),
            "memory_before_kill_gb": (mem_before / 1e9 if on_card
                                      else None),
            "memory_after_restart_gb": (mem_after / 1e9 if on_card
                                        else None)})
        require(active > 0 and rescues["sibling"] >= 1,
                f"fleet rescue: nothing was in flight on r0 or rescued to "
                f"r1: {active} active, {rescues}")
    finally:
        router.drain(timeout_s=10.0)
    return out


def fleet_phase(torch, nano, orin, *, device: str = "cuda", cluster=None):
    """Phase 16, the fleet: (a) ``fleet_chaos`` on ``cluster`` (default
    the bench cluster), (b) ``fleet_rescue`` on ``nano`` (a replicated
    copy of it, beside the cluster's orin, which it never starts), (c)
    the bench's replica leg (``bench.fleet.replica_phase``) at nano_1b's
    width (2 slots a replica, 8 decode steps a tick, 24 new tokens): its
    invariants hold (one ragged decode program per replica) and its
    outputs are identical across replica counts and policies, or every
    flip is a near-tie.  Each part is a main path of its own (``_fleet_part``):
    K1, K2 and K3 launch in each, W1 too in (a).  Returns (numbers by
    part, launches summed over the parts)."""
    from distributed_llm_tpu_torch.bench import fleet
    from distributed_llm_tpu_torch.config import bench_cluster

    on_card = device == "cuda"
    cluster = cluster or bench_cluster()
    base = ("ragged_decode", "flash_causal", "paged_chunk")
    parts = {
        "chaos": (lambda audit: fleet_chaos(torch, cluster, device),
                  base + ("w8_matmul",)),
        "rescue": (lambda audit: fleet_rescue(
            torch, dataclasses.replace(cluster, nano=nano), audit, device),
            base),
        "replica": (lambda audit: fleet.replica_phase(
            device, n_requests=FLEET_REPLICA_REQUESTS,
            tie_check=tie_checker(torch),
            tier=dataclasses.replace(nano, decode_batch=2,
                                     decode_steps_per_tick=8,
                                     max_new_tokens=24)), base),
    }
    out = {}
    total = {name: 0 for name in kernel_wrappers()}
    for name, (run, expect) in parts.items():
        out[name], launches = _fleet_part(torch, name, run, expect, on_card)
        for k, n in launches.items():
            total[k] += n
    rep = out["replica"]
    require("error" not in rep, f"fleet replica: {rep.get('error')}")
    require(all(p["compiled"] == 1
                for p in rep["decode_programs_per_replica"].values()),
            f"fleet replica: {rep['decode_programs_per_replica']}")
    return out, total


def fleet_summary(res: dict) -> dict:
    """The fleet phase's card numbers for the printed line."""
    chaos, rescue, rep = res["chaos"], res["rescue"], res["replica"]
    return {
        "chaos": {**{s: {k: chaos[s][k] for k in (
            "requests", "availability", "mttr_s",
            "p50_ttft_ms_under_faults", "hung_clients", "breaker_opened",
            "degraded_served")} for s in ("heuristic", "hybrid", "perf")},
            "mid_stream": chaos["mid_stream"], "wall_s": chaos["wall_s"]},
        "rescue": {k: rescue.get(k) for k in (
            "active_slots_at_kill", "rescue_mttr_ms", "rescues", "restarts",
            "tokens_identical", "flips", "spill_reattached",
            "new_engine_programs", "new_engine_capture_s",
            "memory_before_kill_gb", "memory_after_restart_gb", "wall_s")},
        "replica": {k: rep.get(k) for k in (
            "closed_loop_speedup", "speedup_ok", "single_device",
            "affinity_hit_retention", "random_hit_retention",
            "dilution_resident_ratio", "decode_programs_per_replica",
            "outputs_identical", "wall_s")}
        | {"flips": [{k: f.get(k) for k in ("mode", "request", "position",
                                             "pick_gap", "tol", "near_tie")}
                     for f in rep.get("flips", ())]},
    }


# Phase 17, the fleet's second half.  (a) The noisy leg's load window;
# (b) the elastic leg's ramp; (c) chaos2's ramp; (d) the remote tier's
# turns and the bound on kill-to-serving (the child imports torch, builds
# and warms nano_1b).
# Cut from 2.5, 12 and 16 s to 2, 8 and 10 s to pay for phases 19 and 20,
# then to the CPU tests' 1, 6 and 8 s (the same bars) to pay for phase 21.
FLEET2_NOISY_LOAD_S = 1.0
FLEET2_ELASTIC_PERIOD_S = 6.0
FLEET2_CHAOS2_PERIOD_S = 8.0
FLEET2_REMOTE_TURNS = 2
FLEET2_REVIVE_S = 180.0
TENANT_COUNTERS = ("dllm_tenant_device_time_ms_total",
                   "dllm_tenant_kv_block_ticks_total",
                   "dllm_tenant_rejected_total")
TENANT_GAUGES = ("dllm_tenant_inflight", "dllm_tenant_goodput")


def _tenant_samples() -> dict:
    """Every ``dllm_tenant_*`` sample of the process-global registry (the
    tier clients' quota layer and the legs' routers write there)."""
    from distributed_llm_tpu_torch.obs import get_observability
    reg = get_observability().metrics
    return {name: {"/".join(k): c.value
                   for k, c in reg.get(name).children().items()}
            for name in TENANT_COUNTERS + TENANT_GAUGES}


def bystander_orin(nano):
    """The second tier of the elastic and chaos2 parts, which route only
    nano's short queries (failover off in elastic; chaos2 must see none):
    a 2-slot nano_1b with int8 weights in orin's place, so the four
    routers those parts build do not each load orin_8b."""
    return dataclasses.replace(nano, name="orin", decode_batch=2,
                               quantize="int8", max_new_tokens=32)


def fleet2_noisy(torch, cluster, device: str = "cuda") -> dict:
    """Part (a): the bench's noisy leg on ``cluster`` (the bench cluster:
    nano_1b with 8 slots and orin_8b with 4, int8 weights): the flooder's
    quota ``max_inflight=1, max_queued=0, weight=0.25`` on both tiers, the
    quiet tenant on the default quota, JAX's closed-loop flood beside the
    quiet tenant's short mix with quotas off and on.  JAX's prompts are
    short and prefill in one shot, so one long turn of the quiet tenant
    then goes through a Router with the quotas on: orin's chunked prefill
    (K3) on the tenant path.  Hard: the sequential greedy probes through
    a quotas-off and a non-binding quotas-on engine give the same token
    ids (``torch.equal``: the same batch composition on the same kernels,
    so no near-tie allowance); no request failed but by a tenant refusal;
    with quotas on every tenant refusal lands on the flooder and the
    flooder is served fewer turns than with quotas off; the
    ``dllm_tenant_*`` families gained samples for both tenants."""
    from distributed_llm_tpu_torch.bench import elastic
    from distributed_llm_tpu_torch.config import TenantQuota
    from distributed_llm_tpu_torch.serving.router import Router

    before = _tenant_samples()
    out = elastic.noisy_phase(load_s=FLEET2_NOISY_LOAD_S, device=device,
                              cluster=cluster)
    quotas = {"flood": TenantQuota(weight=0.25, max_inflight=1,
                                   max_queued=0)}
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=dataclasses.replace(
                        cluster,
                        nano=dataclasses.replace(cluster.nano,
                                                 tenant_quotas=quotas),
                        orin=dataclasses.replace(cluster.orin,
                                                 tenant_quotas=quotas)),
                    device=device)
    try:
        for tc in router.tiers.values():
            tc.server_manager.start_server()
        resp, tokens, which = router.route_query(
            [{"role": "user", "content": "explain in detail: " + words(400)}],
            tenant_id="quiet")
    finally:
        for tc in router.tiers.values():
            tc.server_manager.stop_server()
    out["long_turn"] = {"device": which, "tokens": tokens,
                        "ok": bool(resp.get("ok"))}
    require(which == "orin" and resp.get("ok"),
            f"fleet2 noisy: the quiet tenant's long turn: {out['long_turn']}")
    after = _tenant_samples()
    samples = {name: {k: round(v - before[name].get(k, 0.0), 3)
                      for k, v in after[name].items()
                      if v != before[name].get(k, 0.0)}
               for name in TENANT_COUNTERS}
    samples.update({name: {k: v for k, v in after[name].items()
                           if k.split("/")[-1] in ("quiet", "flood")}
                    for name in TENANT_GAUGES})
    out["tenant_samples"] = samples
    require("error" not in out, f"fleet2 noisy: {out.get('error')}")
    require(all(out[m]["other_errors"] == {"quiet": 0, "flood": 0}
                for m in ("solo", "off", "on")),
            f"fleet2 noisy: failures other than tenant refusals: "
            f"{ {m: out[m]['other_errors'] for m in ('solo', 'off', 'on')} }")
    require(out["outputs_identical"] is True,
            "fleet2 noisy: quotas off and on gave different tokens")
    rej = out["on"]["tenant_rejected"]
    require(rej["flood"] > 0 and rej["quiet"] == 0,
            f"fleet2 noisy: quota refusals {rej}")
    require(out["on"]["quiet_served"] > 0 and out["on"]["flood_served"] > 0,
            f"fleet2 noisy: {out['on']}")
    # The in-flight cap binds: one seat a tier serves fewer flood turns
    # than the unbounded closed loop.
    require(out["on"]["flood_served"] < out["off"]["flood_served"],
            f"fleet2 noisy: the flood's cap did not bind: on "
            f"{out['on']['flood_served']}, off {out['off']['flood_served']}")
    billed = {k.split("/")[-1]
              for k in samples["dllm_tenant_device_time_ms_total"]}
    shed = {k.split("/")[-1] for k in samples["dllm_tenant_rejected_total"]}
    require({"quiet", "flood"} <= billed and shed == {"flood"},
            f"fleet2 noisy: tenant samples {samples}")
    return out


def fleet2_elastic(torch, nano, cluster, device: str = "cuda") -> dict:
    """Part (b): the bench's elastic leg on nano_1b (2 slots a replica, 8
    decode steps a tick, 48-token generations, a 64-block host spill
    tier): JAX's diurnal ramp (``bench/scenarios.py``) under static-min,
    static-max and autoscaled membership in [1, 2] through the Router and
    ``/chat``.  Hard: the flap bound (no up-down-up inside one cooldown,
    at most 4 effective events: 2 an inflection), the handoff sub-check
    (scale to 2, then down to 1 with the victim's parked prefixes demoted
    and handed to the survivor: the same prompts give the same tokens, or
    flip at a near-tie), and one ragged decode program in each replica,
    the one minted mid-flight included.  One card: the replicas share it,
    so replica-seconds are a cost account, not added throughput."""
    from distributed_llm_tpu_torch.bench import elastic
    from distributed_llm_tpu_torch.engine.paged_kv import pool_block_bytes

    blk = pool_block_bytes(nano.model(), nano.kv_block_size,
                           nano.kv_quantize)
    tier = dataclasses.replace(nano, decode_batch=2, host_kv_bytes=64 * blk)
    out = elastic.elastic_phase(
        period_s=FLEET2_ELASTIC_PERIOD_S, device=device,
        cluster=dataclasses.replace(cluster, nano=tier,
                                    orin=bystander_orin(nano)),
        tie_check=tie_checker(torch))
    require("error" not in out, f"fleet2 elastic: {out.get('error')}: "
            f"{out.get('handoff')}")
    programs = out["handoff"]["decode_programs_per_replica"]
    require(len(programs) == 2 and all(
        p["compiled"] == 1 and p["gauge"] == 1.0 for p in programs.values()),
        f"fleet2 elastic: decode programs {programs}")
    require(out["single_device"] is True and out["flap_count"] == 0
            and out["scale_events"] <= 4, f"fleet2 elastic: {out}")
    return out


def fleet2_chaos2(torch, nano, cluster, device: str = "cuda") -> dict:
    """Part (c): the bench's chaos2 leg on nano_1b: 2 replicas of 8
    slots, the autoscaler armed in [1, 2], the HealthMonitor in the loop,
    the scheduler loop of a live replica killed (``crash_replica_engine``)
    at 35% and 65% of the ramp.  Hard (JAX's bars): availability >= 0.99,
    no cross-tier failover, no captured request failed; and the kills
    captured work that a sibling or the rebuilt replica resumed; the rescue
    sub-check's rescued stream equals the uninterrupted run (or flips at a
    near-tie) and the demoted prefix promotes warm on the rebuilt
    engine."""
    from distributed_llm_tpu_torch.bench import elastic

    out = elastic.chaos2_phase(
        period_s=FLEET2_CHAOS2_PERIOD_S, device=device,
        cluster=dataclasses.replace(cluster, nano=nano,
                                    orin=bystander_orin(nano)),
        tier=nano, tie_check=tie_checker(torch))
    require("error" not in out, f"fleet2 chaos2: {out.get('error')}: "
            f"{out.get('subcheck')}")
    require(out["availability"] >= 0.99 and out["failovers"] == 0
            and len(out["kills"]) == 2, f"fleet2 chaos2: {out}")
    rescued = out["rescues"]
    require(rescued["failed"] == 0
            and rescued["sibling"] + rescued["requeue"] > 0,
            f"fleet2 chaos2: the kills rescued no captured request: "
            f"{rescued}")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reply_check(torch, engine, tier, msg: str, got: str) -> dict:
    """A remote reply against the in-process engine's greedy reply to the
    same single-turn history: identical text, or the first difference a
    near-tie (the remote text re-encoded: its token ids do not cross the
    wire).  Uncounted."""
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt
    from distributed_llm_tpu_torch.serving.turns import clip_turn
    hist = [{"role": "user", "content": msg}]
    got = clip_turn(got)             # a stream's deltas keep the lead space
    with uncounted():
        res = engine.generate(hist)
        out = {"identical": clip_turn(res.text) == got}
        if not out["identical"]:
            ids, _ = prepare_prompt(engine.tokenizer, hist,
                                    tier.prefill_buckets,
                                    engine.cfg.max_seq_len,
                                    tier.max_new_tokens)
            out.update(near_tie(torch, engine, ids, list(res.token_ids),
                                list(engine.tokenizer.encode(
                                    got, add_bos=False))))
    return out


def fleet2_remote(torch, cluster, device: str = "cuda") -> dict:
    """Part (d): nano as a remote tier behind the Router, orin local
    (``cluster``: the Router's default cluster, the one the child serves:
    on the card the bench cluster, orin_8b with int8 weights).  The
    Router's nano tier starts the child with ``spawn_cmd =
    (sys.executable, "-m", "distributed_llm_tpu_torch.serving.gpu_api",
    "--tier", "nano", "--port", P)``: nano_1b on the card in its own
    process, polled for readiness (spawn-to-ready timed).
    FLEET2_REMOTE_TURNS ``/chat`` turns route to nano and one
    ``/chat/stream`` streams through the remote SSE; each reply equals an
    in-process nano_1b's at the same configuration (uncounted), or first
    differs at a near-tie.  The ``stats`` extension carries the child's
    TTFT: the hop's overhead is the client's TTFT of the stream less the
    child's.  A long turn routes to orin (a chunked prefill).  Then the
    child is killed: turns fail over to orin, the HealthMonitor (every
    FLEET_HEALTH_S) finds the remote dead and respawns it through
    ``start_server``, and a turn routed to nano is served again
    (kill-to-serving timed).  The child is put down on every exit.  The
    kernels counted are the parent's, orin's (K1, K2, K3, W1): the child's
    launches cannot be counted from here; its ``/query`` path is the one
    phases 4-6 check."""
    from distributed_llm_tpu_torch.config import BENCHMARK_CFG
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.serving.app import create_app
    from distributed_llm_tpu_torch.serving.router import Router

    port = _free_port()
    spawn_cmd = (sys.executable, "-m",
                 "distributed_llm_tpu_torch.serving.gpu_api", "--tier",
                 "nano", "--port", str(port))
    if device != "cuda":
        spawn_cmd += ("--device", device)
    local = cluster.nano
    remote_nano = dataclasses.replace(
        local, endpoint=f"http://127.0.0.1:{port}", spawn_cmd=spawn_cmd)
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=dataclasses.replace(cluster, nano=remote_nano),
                    device=device,
                    config=dict(BENCHMARK_CFG, enable_health_monitor=True,
                                health_interval_s=FLEET_HEALTH_S))
    remote = router.tiers["nano"]
    mgr = remote.server_manager
    ref_mgr = EngineManager(local, seed=cluster.seed, device=device)
    out: dict = {"spawn_cmd": ["python"] + list(spawn_cmd[1:])}
    topics = ("a river", "a lake", "a cloud", "snow", "a tide", "a valley")
    try:
        t0 = time.perf_counter()
        mgr.start_server()
        out["spawn_to_ready_s"] = round(time.perf_counter() - t0, 3)
        router.tiers["orin"].server_manager.start_server()
        with uncounted():
            ref_mgr.start_server()
        engine = ref_mgr.engine()
        with http_served(create_app(router=router)) as base:
            checks = []
            for i, topic in enumerate(topics[:FLEET2_REMOTE_TURNS]):
                msg = f"remote turn {i}: what is {topic}?"
                got = chat_post(base, "/chat", {"message": msg,
                                                "strategy": "heuristic",
                                                "session_id": f"remote-{i}"})
                require(got["device"] == "nano",
                        f"fleet2 remote: turn {i} went to {got['device']}")
                checks.append({"message": msg, **_reply_check(
                    torch, engine, local, msg, got["reply"])})
            out["child_ttft_ms"] = remote.last_result.ttft_ms
            msg = "remote stream: what is a delta?"
            stream = chat_stream(base, {"message": msg,
                                        "strategy": "heuristic",
                                        "session_id": "remote-stream"})
            require(stream["meta"]["device"] == "nano",
                    f"fleet2 remote: the stream went to {stream['meta']}")
            checks.append({"message": msg, "stream": True, **_reply_check(
                torch, engine, local, msg, stream["text"])})
            child_ttft = stream["done"].get("ttft_ms") or 0.0
            out["stream"] = {"client_ttft_ms": stream["ttft_ms"],
                             "child_ttft_ms": child_ttft,
                             "tokens": stream["done"]["tokens"],
                             "hop_overhead_ms": stream["ttft_ms"] - child_ttft}
            out["replies"] = len(checks)
            out["replies_identical"] = sum(c["identical"] for c in checks)
            out["flips"] = [c for c in checks if not c["identical"]]
            require(all(c.get("near_tie") for c in out["flips"]),
                    f"fleet2 remote: replies differ beyond a near-tie: "
                    f"{out['flips']}")
            # A long turn: heuristic routes it to orin, which prefills it
            # in chunks.
            got = chat_post(base, "/chat", {
                "message": "explain in detail: " + words(400),
                "strategy": "heuristic", "session_id": "remote-long"})
            require(got["device"] == "orin",
                    f"fleet2 remote: the long turn went to {got['device']}")
            # Kill the child: failover to orin, the monitor's respawn,
            # nano serving again.
            proc = mgr._proc
            require(proc is not None and proc.poll() is None,
                    "fleet2 remote: no live child to kill")
            proc.kill()
            proc.wait(timeout=30)
            t_kill = time.perf_counter()
            failed_over = 0
            served_again = False
            while time.perf_counter() - t_kill < FLEET2_REVIVE_S:
                got = chat_post(base, "/chat", {
                    "message": f"after the kill {failed_over}: what is "
                               "rain?", "strategy": "heuristic",
                    "session_id": f"revive-{failed_over}"})
                if got["device"] == "nano":
                    served_again = True
                    break
                require(got["device"] == "orin" and got["reply"],
                        f"fleet2 remote: no answer after the kill: {got}")
                failed_over += 1
                time.sleep(0.5)
            out["kill_to_serving_s"] = round(time.perf_counter() - t_kill, 3)
            out["failed_over_turns"] = failed_over
            require(served_again and mgr._proc is not None
                    and mgr._proc is not proc,
                    f"fleet2 remote: the child was not respawned and "
                    f"serving within {FLEET2_REVIVE_S:.0f} s: {out}")
            out["monitor_restarts"] = dict(router.health_monitor._restarts)
            stats = json.loads(http_get(base, "/stats"))
            out["stats_nano_ok"] = stats["tiers"]["nano"].get("ok")
    finally:
        try:
            router.drain(timeout_s=10.0)
        finally:
            mgr.stop_server()
            ref_mgr.stop_server()
    require(mgr._proc is None, "fleet2 remote: the child outlived the phase")
    return out


def fleet2_phase(torch, nano, orin, *, device: str = "cuda", cluster=None):
    """Phase 17, the fleet's second half, four main paths (``_fleet_part``
    each: counts reset and read, its kernels launched, no plain
    attention): (a) ``fleet2_noisy`` on ``cluster`` (default the Router's
    default cluster, on the card the bench cluster; K1, K2, K3, W1), (b)
    ``fleet2_elastic`` and (c) ``fleet2_chaos2`` on ``nano`` (K1, K2,
    K3), (d) ``fleet2_remote`` on ``cluster`` (orin's K1, K2, K3, W1).
    Returns (numbers by part, launches summed over the parts)."""
    from distributed_llm_tpu_torch.serving.router import default_cluster

    on_card = device == "cuda"
    cluster = cluster or default_cluster(device)
    base = ("ragged_decode", "flash_causal", "paged_chunk")
    w8 = ("w8_matmul",) if cluster.orin.quantize == "int8" else ()
    parts = {
        "noisy": (lambda audit: fleet2_noisy(torch, cluster, device),
                  base + w8),
        "elastic": (lambda audit: fleet2_elastic(torch, nano, cluster,
                                                 device), base),
        "chaos2": (lambda audit: fleet2_chaos2(torch, nano, cluster,
                                               device), base),
        "remote": (lambda audit: fleet2_remote(torch, cluster, device),
                   base + w8),
    }
    out = {}
    total = {name: 0 for name in kernel_wrappers()}
    for name, (run, expect) in parts.items():
        out[name], launches = _fleet_part(torch, name, run, expect, on_card)
        for k, n in launches.items():
            total[k] += n
    return out, total


def fleet2_summary(res: dict) -> dict:
    """Phase 17's card numbers for the printed line."""
    nz, el, c2, rm = (res["noisy"], res["elastic"], res["chaos2"],
                      res["remote"])
    return {
        "noisy": {k: nz.get(k) for k in (
            "quiet_p95_ratio", "flood_shed_precision", "outputs_identical",
            "tenant_samples", "long_turn", "wall_s")}
        | {m: {k: nz[m].get(k) for k in (
            "quiet_served", "flood_served", "quiet_p95_ms", "flood_p95_ms",
            "quiet_p95_ratio", "tenant_rejected")}
           for m in ("solo", "off", "on")},
        "elastic": {k: el.get(k) for k in (
            "single_device", "capacity_req_per_s", "schedule",
            "goodput_per_replica_s", "goodput_vs_max", "gprs_vs_max",
            "goodput_ok", "gprs_ok", "scale_events", "flap_count",
            "outputs_identical", "wall_s")}
        | {"events": el["auto"].get("events"),
           "replica_s": {m: el[m].get("replica_s")
                         for m in ("static_min", "static_max", "auto")},
           "gprs": {m: el[m].get("goodput_per_replica_s")
                    for m in ("static_min", "static_max", "auto")},
           "handoff": {k: el["handoff"].get(k) for k in (
               "victim", "demoted_entries", "handed_off", "identical",
               "decode_programs_per_replica", "flips")}},
        "chaos2": {k: c2.get(k) for k in (
            "availability", "rescue_mttr_ms", "failovers", "requests",
            "kills", "rescues", "monitor_restarts",
            "p50_ttft_ms_under_kills", "outputs_identical", "warm_hit",
            "single_device", "wall_s")}
        | {"subcheck": {k: c2["subcheck"].get(k) for k in (
            "rescue_ms", "outcome", "identical", "warm_hit", "flip")}},
        "remote": {k: rm.get(k) for k in (
            "spawn_cmd", "spawn_to_ready_s", "child_ttft_ms", "stream",
            "replies", "replies_identical", "flips", "kill_to_serving_s",
            "failed_over_turns", "monitor_restarts", "wall_s")},
    }


# -- phase 18: the edges -------------------------------------------------------

# The reduction of tests/test_compat.py (its JAX prelude line aside): a
# program written against the reference's bare modules.
REFERENCE_REDUCTION = '''
from router import Router
from query_router_engine import QueryRouter, BENCHMARK_CFG, PRODUCTION_CFG
from query_sets import query_sets
from cache import QueryCache
from token_counter import TokenCounter

router = Router(strategy="heuristic", config=dict(BENCHMARK_CFG),
                threshold_fallback=1000, benchmark_mode=True)
history = [{"role": "user", "content": query_sets["general_knowledge"][0]["query"]}]
response, tokens, device = router.route_query(history)
assert device in ("nano", "orin"), device
assert isinstance(response, dict) and "response" in response
router.nano.server_manager.stop_server()
router.orin.server_manager.stop_server()
print("COMPAT_OK", device, tokens)
'''

# A reference-shaped app (src/app.py's shape): one Router, a history per
# session, POST /chat -> the reply JSON.  Three turns of one session: the
# second and third extend the first's history, so nano finds its parked
# prefix.
REFERENCE_APP = '''
import json
from flask import Flask, jsonify, request

app = Flask(__name__)
chat_router = Router(strategy="token", config=dict(BENCHMARK_CFG),
                     threshold_fallback=1000, benchmark_mode=True)
histories = {}


@app.route("/chat", methods=["POST"])
def chat():
    data = request.get_json()
    history = histories.setdefault(data.get("session_id", "default"), [])
    history.append({"role": "user", "content": data["message"]})
    response, tokens, device = chat_router.route_query(history)
    reply = response.get("response", "")
    history.append({"role": "assistant", "content": reply})
    return jsonify({"reply": reply, "device": device,
                    "reasoning": response.get("reasoning"),
                    "method": response.get("method"),
                    "confidence": response.get("confidence"),
                    "cache_hit": response.get("cache_hit", False),
                    "tokens": tokens})


client = app.test_client()
for message in MESSAGES:
    r = client.post("/chat", json={"message": message, "session_id": "s1"})
    assert r.status_code == 200, r.status_code
    print("CHAT", json.dumps(r.get_json()))
chat_router.drain()
'''

# The port's counterpart of the JAX tests' jax_platforms prelude: the one
# line a CPU run puts before the program.
CPU_PRELUDE = ('from distributed_llm_tpu_torch.device import '
               'set_default_device; set_default_device("cpu")\n')

# Runs the program in the child (argv[1]; argv[2] the messages as JSON):
# the port's utils/webapp.py registered as flask, every route_query's
# kernel launches and plain-version calls recorded, printed after the
# program returns.
REFERENCE_RUNNER = '''
import json, sys, types
from distributed_llm_tpu_torch.utils import webapp
flask = types.ModuleType("flask")
flask.Flask, flask.request, flask.jsonify = (webapp.Flask, webapp.request,
                                             webapp.jsonify)
sys.modules["flask"] = flask
from distributed_llm_tpu_torch.ops import launches
from distributed_llm_tpu_torch.serving.router import Router
per_call = []
real = Router.route_query
def counted(self, *a, **kw):
    k0, c0 = launches.counts(), launches.call_counts()
    try:
        return real(self, *a, **kw)
    finally:
        per_call.append({"launches": launches.since(k0),
                         "calls": launches.since(c0, launches.call_counts())})
Router.route_query = counted
program = open(sys.argv[1]).read()
exec(compile(program, "reference_app.py", "exec"),
     {"__name__": "__main__", "MESSAGES": json.loads(sys.argv[2])})
print("LAUNCHES " + json.dumps({"total": launches.counts(),
                                "calls": launches.call_counts(),
                                "per_call": per_call}))
'''

def edges_messages(device: str = "cuda") -> tuple:
    """(a)'s three turns.  The first is a few blocks long on the card;
    the tiny CPU tiers keep only a prompt's last 64 tokens (their largest
    bucket), so there the whole session must fit in 64."""
    first = words(60 if device == "cuda" else 6)
    return (f"tell me about {first}, and keep it short please",
            "and what about the deltas, then?",
            "one more thing: how do glaciers move?")
EDGES_REPL_TURNS = ("hello there", "what is the capital of france?",
                    "explain how rivers form deltas near the sea")
EDGES_QUERIES = 4                 # the first general_knowledge queries (d)
EDGES_THRESHOLDS = (100, 1000)
EDGES_ENCODER_STEPS = 100         # the JAX package's default is 600
EDGES_AB_LENGTHS = (256, 2048)
EDGES_AB_BATCHES = (1, 8)
EDGES_CHILD_S = 600.0


def reference_program(device: str = "cuda") -> dict:
    """(a): the reference-style program in a child process with
    ``reference_compat/`` first on ``PYTHONPATH`` (and, off the card, the
    CPU prelude): its ``COMPAT_OK`` line, its three ``/chat`` replies, and
    the child's launch counts in total and per ``route_query`` (the
    reduction's, then the app's three turns)."""
    import tempfile
    compat = os.path.join(REPO, "distributed_llm_tpu_torch",
                          "reference_compat")
    program = ("" if device == "cuda" else CPU_PRELUDE) + \
        REFERENCE_REDUCTION + REFERENCE_APP
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [compat, REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        for name, text in (("runner.py", REFERENCE_RUNNER),
                           ("reference_app.py", program)):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(text)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(tmp, "runner.py"),
             os.path.join(tmp, "reference_app.py"),
             json.dumps(edges_messages(device))],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=EDGES_CHILD_S)
        wall_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"edges (a): the reference program failed: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    compat_ok = [ln.split() for ln in lines if ln.startswith("COMPAT_OK")]
    chats = [json.loads(ln[5:]) for ln in lines if ln.startswith("CHAT ")]
    counts = json.loads(next(ln for ln in lines
                             if ln.startswith("LAUNCHES "))[9:])
    require(len(compat_ok) == 1 and compat_ok[0][1] in ("nano", "orin"),
            f"edges (a): no COMPAT_OK line: {proc.stdout[-2000:]}")
    require(len(chats) == len(edges_messages(device))
            and all(c["device"] == "nano" and c["reply"]
                    and CHAT_KEYS <= set(c) for c in chats),
            f"edges (a): /chat turns {chats}")
    per_call = counts["per_call"]
    require(len(per_call) == 1 + len(edges_messages(device)),
            f"edges (a): {len(per_call)} route_query calls")
    follow_up = per_call[2]
    if device == "cuda":
        total = counts["total"]
        require(all(total[k] > 0 for k in ("w8_matmul", "ragged_decode",
                                            "flash_causal")),
                f"edges (a): W1, K1 and K2 must launch: {total}")
        require(follow_up["launches"].get("paged_chunk", 0) > 0,
                f"edges (a): K3 did not launch on the follow-up: {per_call}")
        require(not any(counts["calls"].values()),
                f"edges (a): plain attention ran: {counts['calls']}")
    else:
        require(follow_up["calls"].get("_gather_chunk_paged", 0) > 0,
                f"edges (a): the follow-up was no prefix hit: {per_call}")
    return {"compat_ok": compat_ok[0][1:], "chats": chats,
            "launches": counts["total"], "per_call": per_call,
            "wall_s": wall_s}


def repl_child(device: str = "cuda") -> dict:
    """(b): ``python -m distributed_llm_tpu_torch.serving.cli`` with
    EDGES_REPL_TURNS on stdin, then ``exit``."""
    cmd = [sys.executable, "-m", "distributed_llm_tpu_torch.serving.cli"]
    if device != "cuda":
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          input="\n".join(EDGES_REPL_TURNS + ("exit",)) + "\n",
                          timeout=EDGES_CHILD_S)
    wall_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    replies = [ln.split("> ")[-1] for ln in lines
               if "[nano] " in ln or "[orin] " in ln]
    require(proc.returncode == 0 and len(replies) == len(EDGES_REPL_TURNS)
            and lines[-1].endswith("Tier engines stopped. Bye."),
            f"edges (b): the REPL (exit {proc.returncode}): "
            f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return {"replies": replies, "wall_s": wall_s}


def main_child(device: str = "cuda") -> dict:
    """(c): ``python -m distributed_llm_tpu_torch`` on a free port:
    ``/health`` polled until it answers, one ``/chat``, then SIGTERM,
    which must drain and exit 0."""
    import signal
    port = _free_port()
    cmd = [sys.executable, "-m", "distributed_llm_tpu_torch", "--host",
           "127.0.0.1", "--port", str(port)]
    if device != "cuda":
        cmd += ["--device", device]
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    out: dict = {}
    try:
        health = None
        while (time.perf_counter() - t0 < EDGES_CHILD_S
               and proc.poll() is None):
            try:
                health = json.loads(http_get(base, "/health"))
                break
            except OSError:
                time.sleep(0.5)
        require(health is not None, f"edges (c): /health never answered "
                f"(exit {proc.poll()})")
        out["startup_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        got = chat_post(base, "/chat", {"message": "hello there",
                                        "session_id": "main"})
        out["chat_ms"] = (time.perf_counter() - t1) * 1e3
        require(got["device"] in ("nano", "orin") and got["reply"],
                f"edges (c): /chat {got}")
        out["chat"] = {k: got[k] for k in ("device", "tokens", "method")}
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    require(proc.returncode == 0 and "draining" in stderr,
            f"edges (c): SIGTERM gave exit {proc.returncode}: "
            f"{stderr[-2000:]}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def testers(device: str = "cuda", out_dir: str = REPORT_DIR) -> dict:
    """(d): the v1 tester, then the canonical tester on the same queries
    and the analysis report over its CSVs (the v1 CSV has the notebook's
    headers, which the report does not read, in either package)."""
    import csv

    from distributed_llm_tpu_torch.bench import analysis, legacy_tester
    from distributed_llm_tpu_torch.bench import tester as canonical
    from distributed_llm_tpu_torch.bench.query_sets import query_sets

    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"edges_{k}")
             for k in ("final_results.csv", "summary.csv", "per_query.csv",
                       "report.md")}
    for path in paths.values():
        if os.path.exists(path):
            os.unlink(path)
    items = query_sets["general_knowledge"][:EDGES_QUERIES]
    t0 = time.perf_counter()
    legacy_tester.ChatbotTester(items, EDGES_THRESHOLDS, device=device).run(
        "general_knowledge", paths["final_results.csv"])
    legacy_s = time.perf_counter() - t0
    with open(paths["final_results.csv"], newline="") as f:
        rows = list(csv.reader(f))
    require(rows and rows[0] == legacy_tester.HEADERS
            and len(rows) == 1 + len(EDGES_THRESHOLDS),
            f"edges (d): the v1 CSV {rows}")
    power = {}
    for row in rows[1:]:
        rec = dict(zip(rows[0], row))
        for tier in ("Nano", "Orin"):
            if int(rec[f"{tier} Tokens Generated"]) > 0:
                watts = float(rec[f"{tier} Avg Power (W)"])
                power[f"{tier.lower()}@{rec['Context Threshold']}"] = watts
                require(device != "cuda" or watts > 0,
                        f"edges (d): {tier} served at zero power: {rec}")
    require(power, f"edges (d): no tier served: {rows}")
    t0 = time.perf_counter()
    canonical.run_experiment(
        canonical.normalize_query_set(items), canonical.RunConfig(
            query_set_name="general_knowledge", thresholds=[1000],
            strategies=["heuristic"], cache_modes=["off"],
            fixed_threshold_for_non_token=1000,
            output_csv=paths["summary.csv"],
            output_per_query_csv=paths["per_query.csv"],
            router_kwargs={"device": device}))
    report = analysis.markdown_report(
        analysis.Table.read_csv(paths["summary.csv"]),
        analysis.Table.read_csv(paths["per_query.csv"]))
    with open(paths["report.md"], "w") as f:
        f.write(report)
    require("## general_knowledge" in report
            and "## Device split per strategy" in report,
            f"edges (d): the analysis report {report[:500]}")
    return {"v1_rows": rows, "avg_power_w": power, "legacy_s": legacy_s,
            "canonical_s": time.perf_counter() - t0,
            "report_lines": len(report.splitlines())}


def native_vs_python() -> dict:
    """(e): the C++ featurizer and merge loop against their Python twins
    on every query of the query sets: bit-identical, and the host time of
    each per query (one text at a time; the Python merge loop on a fresh
    tokenizer, its per-chunk cache cold)."""
    import numpy as np

    from distributed_llm_tpu_torch import native
    from distributed_llm_tpu_torch.bench.query_sets import query_sets
    from distributed_llm_tpu_torch.engine import bpe
    from distributed_llm_tpu_torch.routing import embedder

    texts = [(i["query"] if isinstance(i, dict) else i).lower()
             for items in query_sets.values() for i in items]
    dim = embedder.FEATURE_DIM
    feats = native.featurize_batch(texts, dim)
    require(np.array_equal(feats, np.stack([embedder._features(t)
                                            for t in texts])),
            "edges (e): native features differ from the Python twin's")
    tok = bpe.load_default()
    handle = tok._native_handle()
    ascii_texts = [t for t in texts if t.isascii()]
    fresh = bpe.BPETokenizer(merges=tok.merges, vocab_size=tok.vocab_size)

    def python_ids(t):
        return [i for m in bpe._CHUNK_RE.finditer(t)
                for i in fresh._encode_chunk(m.group())]

    def us_per(fn, items):
        t0 = time.perf_counter()
        out = [fn(t) for t in items]
        return (time.perf_counter() - t0) * 1e6 / len(items), out

    res = {"queries": len(texts), "ascii_queries": len(ascii_texts)}
    res["featurize_native_us"], _ = us_per(
        lambda t: native.featurize_batch([t], dim), texts)
    res["featurize_python_us"], _ = us_per(embedder._features, texts)
    res["bpe_native_us"], got = us_per(
        lambda t: native.bpe_encode(handle, t), ascii_texts)
    res["bpe_python_cold_us"], want = us_per(python_ids, ascii_texts)
    require(got == want, "edges (e): native BPE ids differ from the Python "
            "loop's")
    return res


def encoder_training(device: str = "cuda") -> dict:
    """(f): ``encoder_train.train`` (EDGES_ENCODER_STEPS steps) into
    ``build/edges/``, its evaluation beside the committed weights'."""
    from distributed_llm_tpu_torch.routing import encoder, encoder_train
    out = os.path.join(REPO, "build", "edges", "encoder_weights.npz")
    require(os.path.abspath(out) != os.path.abspath(encoder._DEFAULT_WEIGHTS),
            "edges (f): would overwrite the committed weights")
    lines = []
    t0 = time.perf_counter()
    trained = encoder_train.train(out, steps=EDGES_ENCODER_STEPS,
                                  device=device, log=lines.append)
    train_s = time.perf_counter() - t0
    committed = encoder_train.evaluate(encoder._DEFAULT_WEIGHTS,
                                       device=device, log=lines.append)
    loss = trained["final_train_loss"]
    require(loss == loss and abs(loss) < 1e6 and os.path.isfile(out),
            f"edges (f): training gave loss {loss}")
    keys = ("encoder_pos_mean", "encoder_neg_mean", "encoder_sep_acc",
            "encoder_best_threshold", "hashed_sep_acc")
    return {"steps": EDGES_ENCODER_STEPS, "train_s": train_s,
            "final_train_loss": loss, "first_log": lines[1] if len(lines) > 1
            else None, "trained": {k: trained[k] for k in keys},
            "committed": {k: committed[k] for k in keys}}


def tune_table(out_dir: str = REPORT_DIR) -> dict:
    """(g): ``tune.derive`` over phase 11's headline (its sections in
    ``bench_partial.json``), printed and not written."""
    from distributed_llm_tpu_torch.bench import tune
    path = os.path.join(out_dir, "bench_partial.json")
    if not os.path.exists(path):
        return {"table": None, "note": "no headline: phase 11 did not run"}
    headline = tune.read_result(path)
    table = tune.derive(headline)
    require(table["backend"] == headline.get("backend"),
            f"edges (g): {table}")
    return {"table": table, "quant": headline.get("quant")}


def ab_micro(device: str = "cuda") -> dict:
    """(h): ``ab_kernels.micro_ab`` on nano_1b over EDGES_AB_LENGTHS at
    EDGES_AB_BATCHES, uncounted; no case may raise or mismatch."""
    from distributed_llm_tpu_torch.bench import ab_kernels
    with uncounted():
        res = ab_kernels.micro_ab("nano", repeat=10, lengths=EDGES_AB_LENGTHS,
                                  batches=EDGES_AB_BATCHES, device=device,
                                  log=lambda line: None)
    bad = [c for c in res["cases"] if c.get("numerics_mismatch")
           or "kernel_error" in c or "plain_error" in c]
    require(not bad, f"edges (h): {bad}")
    require({c["kind"] for c in res["cases"]} == ab_kernels.ALL_KINDS,
            f"edges (h): kinds {sorted({c['kind'] for c in res['cases']})}")
    return res


def edges_phase(torch, nano, orin, *, device: str = "cuda",
                out_dir: str = REPORT_DIR):
    """Phase 18, (a)-(h) (see the module docstring).  Launches: the
    parent's over (d) plus the child's over (a); the children of (b) and
    (c) serve the same paths and are checked by their exits."""
    on_card = device == "cuda"
    t_all = time.perf_counter()
    fresh_peak(torch, on_card)
    out: dict = {}
    out["reference"] = reference_program(device)
    out["repl"] = repl_child(device)
    out["main"] = main_child(device)
    fresh_peak(torch, on_card)
    reset_counts()
    out["testers"] = testers(device, out_dir)
    launches, _ = read_counts(("w8_matmul", "ragged_decode", "flash_causal")
                              if on_card else (), on_card)
    out["native"] = native_vs_python()
    out["encoder"] = encoder_training(device)
    out["tune"] = tune_table(out_dir)
    out["ab_kernels"] = ab_micro(device)
    out["wall_s"] = time.perf_counter() - t_all
    child = out["reference"]["launches"]
    return out, {k: n + child.get(k, 0) for k, n in launches.items()}


def edges_summary(res: dict) -> dict:
    ab = {}
    for c in res["ab_kernels"]["cases"]:
        key = f"{c['kind']}@{c['length']}x{c.get('batch', 1)}"
        ab[key] = [round(c["kernel_ms"], 4), round(c["plain_ms"], 4)]
    ref = res["reference"]
    return {
        "reference": {"compat_ok": ref["compat_ok"],
                      "devices": [c["device"] for c in ref["chats"]],
                      "launches": {k: ref["launches"][k] for k in (
                          "w8_matmul", "ragged_decode", "flash_causal",
                          "paged_chunk")},
                      "follow_up_launches": ref["per_call"][2]["launches"],
                      "wall_s": ref["wall_s"]},
        "repl": res["repl"], "main": res["main"],
        "testers": {k: res["testers"][k] for k in (
            "avg_power_w", "legacy_s", "canonical_s", "report_lines")},
        "native": res["native"], "encoder": res["encoder"],
        "tune": res["tune"]["table"],
        "ab_kernels_ms_kernel_plain": ab, "wall_s": res["wall_s"]}


# The late phases, by name: each (torch, nano tier, orin tier) ->
# (numbers, launches by kernel).
# -- phase 19: MoE at ep = 1 -------------------------------------------------------

MOE_LENGTHS = (4, 60, 150, 240)
# The MoE tier's four ways of serving: (the tier from the base tier, the
# kernels that must launch).  The int8 pool's suffix chunk has no kernel
# (plain by design, as JAX's is XLA); the sequential engine keeps a bf16
# cache for MoE.
MOE_PARTS = {
    "bf16_pool": (lambda t: t, ("ragged_decode", "flash_causal",
                                "paged_chunk")),
    "int8_pool": (lambda t: dataclasses.replace(t, kv_quantize="int8"),
                  ("flash_causal", "ragged_decode_q8")),
    "sequential": (lambda t: dataclasses.replace(t, decode_batch=1),
                   ("flash_causal", "flash_decode", "flash_chunk")),
    "int8_weights": (lambda t: dataclasses.replace(t, quantize="int8"),
                     ("ragged_decode", "flash_causal", "paged_chunk",
                      "w8_matmul")),
}


def moe_tier(nano):
    """moe_8x1b (8 experts of nano_1b's width, 16 layers, about 6.6 B
    parameters) on the default nano tier's fields: 8 slots, a bf16 pool,
    the ragged tick, ep = 1."""
    return dataclasses.replace(nano, name="moe", model_preset="moe_8x1b")


def moe_phase(torch, nano, orin, *, device: str = "cuda"):
    """Phase 19: moe_8x1b at full width and depth on the one card.  Its
    memory budget comes first (each part against the card's memory, and
    the budget's weight bytes against the engine's own); then the tier
    behind its /query server: the batched engine on the ragged tick with
    a bf16 pool (``serve_phase``: cold, chunked, prefix-hit, concurrent
    and streaming requests), with an int8 pool, the sequential engine
    (``serve_sequential_phase``) and int8 weights through the batched
    engine.  Each part's kernels launch, no plain attention runs, and its
    decode-step logits hold ``three_ways`` against the plain path.
    Returns (numbers by part, launches summed over the parts)."""
    from distributed_llm_tpu_torch.utils.hbm_budget import tier_hbm_budget

    on_card = device == "cuda"
    card_gb = (torch.cuda.get_device_properties(0).total_memory / 1e9
               if on_card else 80.0)
    base = moe_tier(nano)
    budget = {name: tier_hbm_budget(make(base), hbm_per_chip_gb=card_gb)
              for name, (make, _) in MOE_PARTS.items()}
    require(all(b["fits"] for b in budget.values()),
            f"moe_8x1b does not fit the card: {budget}")
    parts, total = {}, {}
    for name, (make, expect) in MOE_PARTS.items():
        tier = make(base)
        t0 = time.perf_counter()
        if tier.decode_batch == 1:
            res, launches = serve_sequential_phase(torch, tier, expect=expect,
                                                   device=device)
        else:
            res, launches = serve_phase(torch, tier, lengths=MOE_LENGTHS,
                                        expect=expect, device=device)
        res["wall_s"] = time.perf_counter() - t0
        res["budget"] = {k: budget[name][k] for k in (
            "params_gb_per_chip", "kv_gb_per_chip", "total_gb_per_chip",
            "fits")}
        parts[name] = res
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"moe {name} served in {res['wall_s']:.1f}s")
    return parts, total


def moe_summary(parts: dict) -> dict:
    """What phase 19 prints of each part: launches, the ms a tick and a
    step, TTFT, the logits checks and the budget."""
    out = {}
    for name, r in parts.items():
        step = r.get("decode_step") or {}
        ticks = r.get("tick_stats") or {}
        out[name] = {
            "engine": r["engine"], "launches": {k: v for k, v in
                                                r["launches"].items() if v},
            "tick_ms_p50": ticks.get("p50_ms"),
            "step_graph_ms": step.get("graph_ms"),
            "step_wall_ms": step.get("wall_ms"),
            "cold_ttft_ms": r["cold_ttft_ms"],
            "chunked_ttft_ms": r["chunked_ttft_ms"],
            "p50_ttft_ms": r["concurrent"]["p50_ttft_ms"],
            "tokens_per_s": r["concurrent"]["tokens_per_s"],
            "logits_check": {k: (r.get("decode_logits_check") or {}).get(k)
                             for k in ("kernel_vs_plain_max_abs_err",
                                       "kernel_vs_float32_max_abs_err",
                                       "tol", "routes")},
            "budget": r["budget"], "peak_memory_gb": r["peak_memory_gb"],
            "wall_s": r["wall_s"]}
    return out


# -- phase 20: training -------------------------------------------------------------

TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_train")
TRAIN_1B_STEPS = 10
TRAIN_1B_BATCH, TRAIN_1B_SEQ = 8, 256
# 300 and 100 steps until cut for phase 23: both still learn (the last
# 25-step window below the first).
TRAIN_TINY_STEPS = {"nano_test": 100, "moe_test": 50}
TRAIN_TINY_BATCH, TRAIN_TINY_SEQ, TRAIN_WINDOW = 16, 128, 25


def k2_grad_check(torch, cfg, b: int = 4, s: int = 256) -> dict:
    """(a) K2 under autograd (``FlashCausal``) at ``cfg``'s width, B x S
    bf16 q/k/v: the output and the q, k and v gradients against autograd
    of the plain causal attention in float32, every row within
    KERNEL_REL_TOL (plain bf16 autograd's own errors beside them), and
    forward + backward timed eagerly against the plain version's.
    Uncounted: a comparison, no main path."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    d = cfg.head_dim
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, s, cfg.num_heads, d),
                                      (b, s, cfg.num_kv_heads, d),
                                      (b, s, cfg.num_kv_heads, d),
                                      (b, s, cfg.num_heads, d)))

    def run(fn, dtype=None):
        leaves = [(t.to(dtype) if dtype else t).clone().requires_grad_(True)
                  for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(g.to(out.dtype))
        return [out.detach()] + [t.grad for t in leaves]

    names = ("out", "dq", "dk", "dv")
    with uncounted():
        kernel = run(TF.flash_causal_attention)
        plain = run(TA.causal_attention)
        ref = run(TA.causal_attention, torch.float32)
        res = {n: row_rel_err(a, r) for n, a, r in zip(names, kernel, ref)}
        res_plain = {n: row_rel_err(a, r) for n, a, r in zip(names, plain,
                                                             ref)}
        ms = time_ms(torch, lambda: run(TF.flash_causal_attention), iters=5)
        plain_ms = time_ms(torch, lambda: run(TA.causal_attention), iters=5)
    require(all(e <= KERNEL_REL_TOL for e in res.values()),
            f"K2's autograd Function disagrees with plain float32 "
            f"autograd: {res} (plain bf16: {res_plain})")
    return {"shape": [b, s, cfg.num_heads, cfg.num_kv_heads, d],
            "rel_err": res, "plain_rel_err": res_plain, "tol": TOL,
            "fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain_ms}


def read_train_counts(on_card: bool) -> tuple:
    """(launches, plain calls) since ``reset_counts`` for a training run:
    K2 must launch; the only plain version allowed is the causal
    attention, which is K2's backward by design (JAX's ``_flash_bwd``)."""
    from distributed_llm_tpu_torch.ops import launches as L
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()}
    plain_calls = L.call_counts()
    require(launches["flash_causal"] > 0, f"K2 did not launch: {launches}")
    other = {k: v for k, v in plain_calls.items()
             if v and k != "causal_attention"}
    require(not on_card or not other,
            f"plain attention other than K2's backward ran: {other}")
    return launches, plain_calls


def train_phase(torch, nano, orin, *, device: str = "cuda"):
    """Phase 20: (a) ``k2_grad_check`` at nano_1b's width; (b)
    ``training.pretrain`` on nano_1b at full width (TRAIN_1B_STEPS steps
    at batch 8, seq 256, from seed 0): finite losses, ms a step and
    tokens/s; the saved root served through ``checkpoint_path`` behind
    /query (the engine's weights are the saved ones; K1 and K2 launch)
    and scored by ``evaluate.eval_checkpoint``; (c) nano_test for
    TRAIN_TINY_STEPS steps and (d) moe_test: the last window's mean loss
    below the
    first's, and moe_test's load-balance loss above 0.  Training runs are
    counted (K2 forward and its remat recompute; the plain causal
    attention is its backward).  Returns (numbers, launches)."""
    import shutil

    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.config import MODEL_PRESETS
    from distributed_llm_tpu_torch.engine.bpe import load_default
    from distributed_llm_tpu_torch.models.checkpoint import (
        load_params_for_tier)
    from distributed_llm_tpu_torch.training import evaluate, pretrain
    from distributed_llm_tpu_torch.training.data import batches

    on_card = device == "cuda"
    out = {"k2_grad": k2_grad_check(torch, nano.model())}
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    root = os.path.join(TRAIN_DIR, nano.model_preset)
    fresh_peak(torch, on_card)
    reset_counts()
    res = pretrain.pretrain(nano.model_preset, root,
                            batch_size=TRAIN_1B_BATCH, seq_len=TRAIN_1B_SEQ,
                            max_steps=TRAIN_1B_STEPS, eval_every=5,
                            patience=TRAIN_1B_STEPS, seed=0, device=device,
                            log=log)
    launches, plain_calls = read_train_counts(on_card)
    add(launches)
    require(res["steps"] == TRAIN_1B_STEPS and all(
        math.isfinite(x) for x in res["losses"]),
        f"nano_1b pretraining: {res['losses']}")
    steady = res["step_ms"][1:]
    out["nano_1b"] = {
        "steps": res["steps"], "losses": res["losses"],
        "step_ms": res["step_ms"],
        "steady_ms_per_step": statistics.median(steady),
        "tokens_per_s": TRAIN_1B_BATCH * TRAIN_1B_SEQ * 1e3
        / statistics.median(steady),
        "seconds": res["seconds"], "launches": launches,
        "plain_calls": plain_calls,
        "peak_memory_gb": peak_memory_gb(torch, on_card)}
    tier = dataclasses.replace(nano, checkpoint_path=root)
    with served(torch, tier, device) as (engine, base, startup_s):
        saved = torch.load(os.path.join(root, "latest", "params.pt"),
                           map_location="cpu", weights_only=True)
        last = f"layers.{len(engine.model.layers) - 1}.wq"
        require(torch.equal(engine.model.layers[-1].wq.cpu(), saved[last]),
                "the served engine does not hold the trained weights")
        del saved
        reset_counts()
        t0 = time.perf_counter()
        first = query(base, "user: tell me about " + words(12))
        stream_status, _ = post(base + "/query/stream", {
            "query": "stream about " + words(10, 7), "num_predict": 16})
        require(stream_status == 200, "/query/stream on the trained root "
                f"answered {stream_status}")
        main_s = time.perf_counter() - t0
        launches, _ = read_counts(("ragged_decode", "flash_causal"), on_card)
        add(launches)
    out["served"] = {"startup_s": startup_s, "main_path_s": main_s,
                     "ttft_ms": first["stats"]["ttft_ms"],
                     "gen_tokens": first["stats"]["gen_tokens"],
                     "launches": launches}
    reset_counts()
    out["eval"] = evaluate.eval_checkpoint(nano.model_preset, root,
                                           device=device, n_batches=2,
                                           batch_size=TRAIN_1B_BATCH,
                                           seq_len=TRAIN_1B_SEQ)
    launches, _ = read_counts(("flash_causal",), on_card)
    add(launches)
    require(math.isfinite(out["eval"]["eval_loss"]),
            f"eval_checkpoint: {out['eval']}")
    shutil.rmtree(root, ignore_errors=True)

    for preset, steps in TRAIN_TINY_STEPS.items():
        tiny_root = os.path.join(TRAIN_DIR, preset)
        reset_counts()
        res = pretrain.pretrain(preset, tiny_root,
                                batch_size=TRAIN_TINY_BATCH,
                                seq_len=TRAIN_TINY_SEQ, max_steps=steps,
                                eval_every=TRAIN_WINDOW, patience=steps,
                                seed=0, device=device, log=log)
        launches, _ = read_train_counts(on_card)
        add(launches)
        losses = res["losses"]
        first_w = statistics.fmean(losses[:TRAIN_WINDOW])
        last_w = statistics.fmean(losses[-TRAIN_WINDOW:])
        entry = {"steps": res["steps"], "first_window_loss": first_w,
                 "last_window_loss": last_w,
                 "steady_ms_per_step": statistics.median(res["step_ms"][1:]),
                 "seconds": res["seconds"], "launches": launches}
        require(res["steps"] == steps and all(math.isfinite(x) for x in losses)
                and last_w < first_w,
                f"{preset} pretraining did not learn: {entry}")
        if MODEL_PRESETS[preset].num_experts > 1:
            cfg = MODEL_PRESETS[preset]
            model = load_params_for_tier(tiny_root, cfg, device=device)
            toks, _ = next(batches(TRAIN_TINY_BATCH, TRAIN_TINY_SEQ,
                                   seed=1, tokenizer=load_default()))
            tokens = torch.as_tensor(toks, dtype=torch.long, device=device)
            positions = torch.arange(TRAIN_TINY_SEQ, device=device)[None]
            with uncounted():
                entry["aux"] = float(models.moe.prefill(
                    cfg, model, tokens, positions.expand_as(tokens))[2])
            require(entry["aux"] > 0, f"{preset}: aux loss {entry['aux']}")
        out[preset] = entry
        shutil.rmtree(tiny_root, ignore_errors=True)
    return out, total


def _seq(tier, **kw):
    return dataclasses.replace(tier, decode_batch=1, **kw)


# -- phase 21: tensor parallelism --------------------------------------------------

# The card repeated stands in for a group of cards: every shard of a tp
# group runs on it, one after another (the port's single controller).
TP_LENGTHS = (4, 60, 150, 240)   # (a)'s and (b)'s concurrent requests
TP_NEW = 24                      # the probes' greedy decode budget
# (name, tp, what every shard must launch, what must launch at all).
TP_BATCHED = {
    "flagship_tp4": (4, ("ragged_decode", "flash_causal", "paged_chunk"),
                     ("ragged_decode", "flash_causal", "paged_chunk")),
    "orin_w8_tp2": (2, ("flash_causal", "ragged_verify_q8", "w8_matmul"),
                    ("flash_causal", "ragged_verify_q8", "ragged_decode_q8",
                     "w8_matmul")),
}
TP_SEQ_EXPECT = ("flash_causal", "flash_decode", "flash_chunk")
# (d) the multichip section's tp=2 engines: plain ticks, prefills and the
# spec rounds' verify (draft_test's decode runs unsharded).
TP_MC_EXPECT = ("ragged_decode", "flash_causal", "ragged_verify")


def tp_tiers(orin, nano):
    """(a) ``flagship_cluster(5)``'s orin: orin_8b bf16 over tp=4, the
    ragged tick, chunked prefill, prefix hits; (b) orin_8b with int8
    weights and an int8 pool over tp=2 with the nano_1b draft (int8
    weights too); (c) orin_8b bf16 on the sequential engine over tp=4."""
    from distributed_llm_tpu_torch.config import flagship_cluster
    flag = flagship_cluster(5).orin
    return {
        "flagship_tp4": flag,
        "orin_w8_tp2": dataclasses.replace(
            orin, tp=2, quantize="int8", kv_quantize="int8",
            draft_preset=nano.model_preset),
        "seq_tp4": _seq(flag),
    }


def tp_probes(engine, tier) -> list:
    """(name, prompt ids) of the probes held against tp=1: a cold prompt,
    one past a 256-token chunk (chunked on the batched engine, a long
    prefill on the sequential one) and the cold one's follow-up (a
    prefix hit)."""
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt
    cold = "tell me about " + words(12, 4)
    out = []
    for name, text in (("cold", cold), ("long", "summarise: " + words(300, 9)),
                       ("hit", cold + " and " + words(6, 5) + "?")):
        ids, _ = prepare_prompt(engine.tokenizer, text, tier.prefill_buckets,
                                engine.cfg.max_seq_len, TP_NEW)
        out.append((name, text, ids))
    return out


def tp_run_probes(torch, engine, tier) -> dict:
    """Each probe's greedy tokens, and the cold probe's prefill logits
    (last row, float32, on the host)."""
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.models import transformer
    tokens = {}
    for name, text, ids in tp_probes(engine, tier):
        tokens[name] = (list(ids), list(engine.generate(
            text, max_new_tokens=TP_NEW, temperature=0.0).token_ids))
    ids = tokens["cold"][0]
    dev = engine.device
    with torch.no_grad():
        hidden, _ = models.serving_prefill(
            engine.cfg, engine.model, torch.tensor([ids], device=dev),
            torch.arange(len(ids), device=dev)[None])
        logits = transformer.logits_from_hidden(engine.model, hidden[0, -1])
    return {"tokens": tokens, "logits": logits.float().cpu()}


def f32_logits(torch, engine, ids):
    """The prefill logits (last row) of ``ids`` by a float32 copy of
    ``engine``'s unsharded weights (int8 ones dequantized) with the plain
    causal attention in float32: the reference both bf16 runs are held
    to, as ``check_three`` holds a kernel to float32."""
    import operator
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.models import transformer
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    dev = engine.device
    m32 = transformer.Transformer(dataclasses.replace(engine.cfg,
                                                      dtype="float32"),
                                  device=dev)
    with torch.no_grad():
        for name, p in m32.named_parameters():
            p.copy_(quant.dequantize(operator.attrgetter(name)(
                engine.model)).float())
    causal = TA.causal
    TA.causal = TA.causal_attention
    try:
        with uncounted(), torch.no_grad():
            hidden, _ = models.serving_prefill(
                m32.cfg, m32, torch.tensor([ids], device=dev),
                torch.arange(len(ids), device=dev)[None])
            return transformer.logits_from_hidden(m32, hidden[0, -1]).cpu()
    finally:
        TA.causal = causal
        del m32


def logits_against(got, want, ref) -> dict:
    """The tp run's logits against float32 (``ref``) within LOGITS_RTOL of
    their scale above tp=1's own distance to float32 (the bf16 floor),
    ``check_three``'s bound; their distance to tp=1's beside it."""
    scale = ref.abs().max().item()
    floor = (want - ref).abs().max().item()
    res = {"tp_vs_float32_max_abs_err": (got - ref).abs().max().item(),
           "tp1_vs_float32_max_abs_err": floor,
           "tp_vs_tp1_max_abs_err": (got - want).abs().max().item(),
           "logits_max_abs": scale, "tol": LOGITS_RTOL * scale + floor}
    require(res["tp_vs_float32_max_abs_err"] <= res["tol"],
            f"tp prefill logits disagree with float32: {res}")
    return res


def tp_against_tp1(torch, got: dict, want: dict, engine) -> dict:
    """The tp>1 run's probes against tp=1's (``engine`` the tp=1 engine):
    tokens equal, or their first difference a near-tie (``near_tie`` on
    the tp=1 engine); the cold probe's prefill logits by
    ``logits_against``."""
    flips = []
    for name, (ids, w) in want["tokens"].items():
        g = got["tokens"][name][1]
        if g != w:
            with uncounted():
                flips.append({"probe": name, **near_tie(torch, engine, ids,
                                                        w, g)})
    require(all(f["near_tie"] for f in flips),
            f"tp tokens differ from tp=1 beyond a near-tie: {flips}")
    ref = f32_logits(torch, engine, want["tokens"]["cold"][0])
    return {"tokens_identical": not flips, "flips": flips,
            **logits_against(got["logits"], want["logits"], ref)}


def tp_shard_launches(before: dict, tp: int, every) -> dict:
    """Each shard's launches since ``before`` (a ``shard_counts()``); every
    kernel in ``every`` must have launched on every one of ``tp`` shards."""
    from distributed_llm_tpu_torch.ops import launches as L
    per = L.shard_since(before)
    missing = [(s, k) for s in range(tp) for k in every
               if not per.get(s, {}).get(k)]
    require(not missing, f"kernels did not launch on every shard: "
            f"{missing} ({per})")
    return {str(s): dict(sorted(per.get(s, {}).items())) for s in range(tp)}


def tp_batched_part(torch, tier, tp: int, every, expect, *, device: str):
    """A batched tier over a tp group of the card repeated: built, then
    warmed (the capture seconds: every program of the warm set, each
    holding every shard's launches), served over HTTP (``drive``, and a
    sampled request when it speculates), each shard's launches, one tick
    replayed against its body (``tick_graph_check``: the tick's ms), the
    probes; then the same tier at tp=1 on the same probes."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.ops import launches as L
    from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
    from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app

    on_card = device == "cuda"
    group = tp_mesh([device] * tp, tp)
    fresh_peak(torch, on_card)
    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, group=group, warmup_on_start=False)
    manager.start_server()
    engine = manager.engine()
    build_s = time.perf_counter() - t0
    mem0 = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    engine.warmup()
    capture_s = time.perf_counter() - t0
    graph_gb = ((torch.cuda.memory_allocated() - mem0) / 1e9
                if on_card else None)
    try:
        require(engine.tp == tp and engine.ragged,
                f"{tier.name}: tp={engine.tp} ragged={engine.ragged}")
        with http_served(create_tier_app(tier.name, manager=manager)) as base:
            reset_counts()
            shards0 = L.shard_counts()
            t_main = time.perf_counter()
            drove = drive(base, long_words=420, lengths=TP_LENGTHS,
                          hits=lambda: engine.prefix_cache.stats()[
                              "hits_shared"])
            if engine.spec:
                query(base, "imagine " + words(8, 2), temperature=0.8)
            main_s = time.perf_counter() - t_main
            launches, plain_calls = read_counts(expect, on_card)
            per_shard = tp_shard_launches(shards0, tp, every)
        tick = tick_graph_check(torch, engine)
        got = tp_run_probes(torch, engine, tier)
        res = {"model": tier.model_preset, "tp": tp,
               "quantize": tier.quantize, "kv_quantize": tier.kv_quantize,
               "draft": tier.draft_preset if engine.spec else None,
               "build_s": build_s, "capture_s": capture_s,
               "graph_pool_gb": graph_gb, "main_path_s": main_s,
               "requests": drove["requests"],
               "launches": {k: v for k, v in launches.items() if v},
               "launches_by_shard": per_shard,
               "tick_replay_ms": tick.get("tick_replay_ms"),
               "tick_stage": [tick["stage"], tick["key"]],
               "programs": tick["programs"],
               "spec": engine.spec_stats() if engine.spec else None,
               "peak_memory_gb": peak_memory_gb(torch, on_card)}
    finally:
        manager.stop_server()
        del engine, manager
    fresh_peak(torch, on_card)
    ref = EngineManager(tier, seed=0, device=device, warmup_on_start=False)
    ref.start_server()
    try:
        with uncounted():
            want = tp_run_probes(torch, ref.engine(), tier)
            res["against_tp1"] = tp_against_tp1(torch, got, want,
                                                ref.engine())
            # The same tick at tp=1 in this call (its longest parked
            # conversation, a probe's, sits at another position).
            tick1 = tick_graph_check(torch, ref.engine())
            res["tp1_tick_replay_ms"] = tick1.get("tick_replay_ms")
            res["tick_position"] = [tick["position"], tick1["position"]]
    finally:
        ref.stop_server()
    return res, launches


def tp_sequential_part(torch, tier, tp: int, *, device: str):
    """The sequential engine over a tp group of the card repeated: built,
    warmed (its warm set captured, every shard in each program), the
    probes as its main path (a cold prefill, a long one, a prefix hit's
    suffix, decode segments), each shard's launches, then tp=1 on the
    same probes."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.ops import launches as L
    from distributed_llm_tpu_torch.parallel.mesh import tp_mesh

    on_card = device == "cuda"
    fresh_peak(torch, on_card)
    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, group=tp_mesh([device] * tp, tp),
                            warmup_on_start=False)
    manager.start_server()
    engine = manager.engine()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.warmup()
    capture_s = time.perf_counter() - t0
    try:
        require(engine.group is not None and engine.group.tp == tp,
                f"{tier.name}: the sequential engine is not at tp={tp}")
        reset_counts()
        shards0 = L.shard_counts()
        t_main = time.perf_counter()
        got = tp_run_probes(torch, engine, tier)
        main_s = time.perf_counter() - t_main
        launches, _ = read_counts(TP_SEQ_EXPECT, on_card)
        res = {"model": tier.model_preset, "tp": tp, "engine":
               type(engine).__name__, "build_s": build_s,
               "capture_s": capture_s, "main_path_s": main_s,
               "launches": {k: v for k, v in launches.items() if v},
               "launches_by_shard": tp_shard_launches(shards0, tp,
                                                      TP_SEQ_EXPECT),
               "programs": {str(k): sorted(v) for k, v in
                            engine.program_shapes().items()},
               "peak_memory_gb": peak_memory_gb(torch, on_card)}
    finally:
        manager.stop_server()
        del engine, manager
    fresh_peak(torch, on_card)
    ref = EngineManager(tier, seed=0, device=device, warmup_on_start=False)
    ref.start_server()
    try:
        with uncounted():
            want = tp_run_probes(torch, ref.engine(), tier)
            ref32 = f32_logits(torch, ref.engine(), want["tokens"]["cold"][0])
            logits = logits_against(got["logits"], want["logits"], ref32)
            flips = [{"probe": n, **seq_near_tie(torch, ref.engine(), ids, w,
                                                 got["tokens"][n][1],
                                                 logits["tol"])}
                     for n, (ids, w) in want["tokens"].items()
                     if got["tokens"][n][1] != w]
    finally:
        ref.stop_server()
    require(all(f["near_tie"] for f in flips),
            f"sequential tp tokens differ from tp=1 beyond a near-tie: "
            f"{flips}")
    res["against_tp1"] = {"tokens_identical": not flips, "flips": flips,
                          **logits}
    return res, launches


def seq_near_tie(torch, engine, ids, want, got, tol: float) -> dict:
    """``near_tie`` for the sequential engine, which has no pool to replay
    in: the prefill logits (K2) of the prompt and ``want`` up to the
    first difference, last row; a near-tie when the gap between the two
    picks there is within 2 ``tol``, the drift the tp and tp=1 logits
    may each show from float32 (``logits_against``'s bound)."""
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.models import transformer
    p = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    out = {"position": p, "of": len(want), "tol": tol, "near_tie": False}
    if p >= min(len(want), len(got)):
        return out
    seq = list(ids) + list(want[:p])
    dev = engine.device
    with torch.no_grad():
        hidden, _ = models.serving_prefill(
            engine.cfg, engine.model, torch.tensor([seq], device=dev),
            torch.arange(len(seq), device=dev)[None])
        logits = transformer.logits_from_hidden(engine.model,
                                                hidden[0, -1]).float()
    out["pick_gap"] = float(logits[want[p]] - logits[got[p]])
    out["got_rank"] = int((logits > logits[got[p]]).sum())
    out["near_tie"] = abs(out["pick_gap"]) <= 2 * tol
    return out


def tp_health_part(torch, *, device: str) -> dict:
    """(e) A Router with the perf strategy and a ``health_mesh`` of the
    card repeated twice over the tiny tiers: after a few routed turns the
    monitor's exchange all-gathers each tier's perf row over the group,
    equal to the strategy's own window (every row this process's)."""
    from distributed_llm_tpu_torch.config import (BENCHMARK_CFG,
                                                  tiny_batched_cluster)
    from distributed_llm_tpu_torch.parallel.collectives import (
        summarize_perf_window)
    from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
    from distributed_llm_tpu_torch.serving.router import Router

    group = tp_mesh([device] * 2, 2)
    router = Router(strategy="perf", benchmark_mode=True,
                    cluster=tiny_batched_cluster(), device=device,
                    sample_ms=0, config=dict(
                        BENCHMARK_CFG, enable_health_monitor=True,
                        health_interval_s=3600.0, health_mesh=group))
    try:
        for q in ("hello there", "compare rivers and lakes in detail",
                  "what is two plus two?"):
            router.route_query([{"role": "user", "content": q}])
        monitor = router.health_monitor
        require(monitor.mesh is group, "the monitor did not get the group")
        perf = monitor._perf_strategy()
        out = monitor.exchange_health()
        rows = {}
        for name, got in out.items():
            want = summarize_perf_window(list(perf.samples[name]))
            require(got.shape == (2, 4) and (got == want).all(),
                    f"allgather_health rows for {name}: {got} != {want}")
            rows[name] = got[0].tolist()
        return {"rows": rows, "group": [str(d) for d in group.devices]}
    finally:
        router.drain(timeout_s=30)


def tp_phase(torch, nano, orin, *, device: str = "cuda"):
    """Phase 21: tensor parallelism over a group of the card repeated (the
    port's single controller runs every shard on it; the numbers are the
    cost of sharding on one card, not a multi-card speedup).  (a) the
    flagship's orin at tp=4 and (b) orin_8b int8 at tp=2 with the nano_1b
    draft on the batched engine, (c) orin_8b on the sequential engine at
    tp=4, each held against tp=1 on the same probes; (d) the bench's
    ``multichip`` section on two slots of the card; (e) the health
    exchange through a Router's ``health_mesh``.  Every kernel of a part
    launches on every shard.  Returns (numbers, launches summed)."""
    from distributed_llm_tpu_torch.bench import headline
    from distributed_llm_tpu_torch.ops import launches as L

    tiers = tp_tiers(orin, nano)
    parts, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for name, (tp, every, expect) in TP_BATCHED.items():
        t0 = time.perf_counter()
        parts[name], launches = tp_batched_part(
            torch, tiers[name], tp, every, expect, device=device)
        parts[name]["wall_s"] = time.perf_counter() - t0
        add(launches)
        log(f"tp {name} in {parts[name]['wall_s']:.1f}s")
    t0 = time.perf_counter()
    parts["seq_tp4"], launches = tp_sequential_part(
        torch, tiers["seq_tp4"], 4, device=device)
    parts["seq_tp4"]["wall_s"] = time.perf_counter() - t0
    add(launches)
    log(f"tp seq_tp4 in {parts['seq_tp4']['wall_s']:.1f}s")
    # (d) the multichip section, its kernels counted on its shards.
    t0 = time.perf_counter()
    reset_counts()
    shards0 = L.shard_counts()
    mc = headline.multichip_phase(devices=[device] * 2,
                                  tie_check=tie_checker(torch))
    require("error" not in mc and not mc.get("skipped"),
            f"the multichip section failed: {mc}")
    launches, _ = read_counts(TP_MC_EXPECT, device == "cuda")
    mc["launches"] = {k: v for k, v in launches.items() if v}
    mc["launches_by_shard"] = tp_shard_launches(shards0, 2, TP_MC_EXPECT)
    mc["wall_s"] = time.perf_counter() - t0
    parts["multichip"] = mc
    add(launches)
    log(f"tp multichip in {mc['wall_s']:.1f}s")
    t0 = time.perf_counter()
    parts["health"] = tp_health_part(torch, device=device)
    parts["health"]["wall_s"] = time.perf_counter() - t0
    return parts, total


def tp_summary(parts: dict) -> dict:
    """What phase 21 prints of each part."""
    out = {}
    for name, r in parts.items():
        out[name] = {k: r.get(k) for k in (
            "tp", "build_s", "capture_s", "graph_pool_gb", "main_path_s",
            "tick_replay_ms", "tp1_tick_replay_ms", "tick_position",
            "tick_stage", "launches_by_shard",
            "against_tp1", "peak_memory_gb", "wall_s", "tp_ratio",
            "spec_tok_ratio", "single_device", "outputs_identical",
            "capacity", "rows") if r.get(k) is not None}
    return out


# -- phase 22: sequence and expert parallelism -----------------------------------

# The card repeated stands in for the group, as in phase 21.
SP_EP_NEW = 16                   # the probes' greedy decode budget
SP_EP_PROBES = ("cold", "long", "hit")
SP_LONG_WORDS = 2650             # about 5950 orin_8b tokens: past 2048
MOE_LONG_WORDS = 300             # about 680 tokens: two 256-token chunks
# What every slot of a part launches, and what the part launches at all
# (parts (a) and (b) run the ring and the sp partials: plain by design,
# as they are XLA in the JAX package, so nothing of theirs launches).
SP_EP_EXPECT = {
    "orin_sp4": ((), ()),
    "orin_sp2_tp2": ((), ()),
    "moe_ep4_batched": ((), ("ragged_decode", "flash_causal", "paged_chunk")),
    "moe_ep4_seq_w8": (("w8_matmul",), ("flash_causal", "flash_decode",
                                        "flash_chunk", "w8_matmul")),
    "moe_tp2_int8_pool": (("flash_causal", "ragged_decode_q8"),
                          ("flash_causal", "ragged_decode_q8")),
}


def sp_ep_probes(engine, tier, long_words: int, seq: bool) -> list:
    """(name, text, ids) of a part's probes: a cold prompt, a long one and
    the cold one's follow-up (a prefix hit where the prefix cache is on).
    The ids are the engine's own (a sequential engine keeps a long prompt
    whole; the batched engine chunks it)."""
    from distributed_llm_tpu_torch.engine.inference import prepare_prompt
    cold = "tell me about " + words(12, 4)
    buckets = engine._buckets if seq else tier.prefill_buckets
    out = []
    for name, text in (("cold", cold),
                       ("long", "summarise: " + words(long_words, 9)),
                       ("hit", cold + " and " + words(6, 5) + "?")):
        ids, _ = prepare_prompt(engine.tokenizer, text, buckets,
                                engine.cfg.max_seq_len, tier.max_new_tokens,
                                allow_long=seq)
        out.append((name, text, ids))
    return out


def sp_ep_run(torch, engine, probes, routes=None, repeat: int = 1) -> dict:
    """Each probe's greedy tokens and TTFT, and the cold probe's prefill
    logits (last row, float32, uncounted), its experts pinned to
    ``routes`` (recorded when empty; each entry served ``repeat`` times:
    a MoE model split over tp shards routes once per shard)."""
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.models import transformer
    out = {"tokens": {}, "ttft_ms": {}}
    for name, text, ids in probes:
        r = engine.generate(text, max_new_tokens=SP_EP_NEW, temperature=0.0)
        out["tokens"][name] = (list(ids), list(r.token_ids))
        out["ttft_ms"][name] = r.ttft_ms
    ids = out["tokens"]["cold"][0]
    dev = engine.device
    pins = routes if routes is not None else []
    record = not pins
    replay = [r for r in pins for _ in range(repeat)]
    # An sp engine's prompt padded to its bucket, through its own prefill
    # attention (the ring); the row of the last id.
    sp_attn = engine._sp_attn if getattr(engine, "_sp", 1) > 1 else None
    width = (next(b for b in engine._buckets if b >= len(ids))
             if sp_attn else len(ids))
    toks = list(ids) + [engine.tokenizer.pad_id] * (width - len(ids))
    with uncounted(), torch.no_grad(), pinned_routes(
            pins if record else replay, record=record) as flips:
        hidden, _ = models.serving_prefill(
            engine.cfg, engine.model, torch.tensor([toks], device=dev),
            torch.arange(width, device=dev)[None],
            attn=sp_attn(width) if sp_attn else None)
        out["logits"] = transformer.logits_from_hidden(
            engine.model, hidden[0, len(ids) - 1]).float().cpu()
    out["route_flips"] = list(flips)
    out["routes"] = pins
    return out


def seq_program_ms(torch, engine, key, rung: int, stage: dict,
                   iters: int) -> float:
    """Device ms of one replay of a sequential engine's program ``key`` on
    ``rung`` (built here if it is not), from ``stage``'s inputs, between
    CUDA events; uncounted."""
    with uncounted():
        engine._stage(**stage)
        prog = engine._built(key, rung)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            engine._stage(**stage)
            prog.run()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def seq_times(torch, engine, long_ids, long_bucket: bool = True) -> dict:
    """A sequential engine's prefill of the 2048 bucket and of the long
    probe's bucket (the sp ladder's 8192, unless not ``long_bucket``;
    none on an unsharded tier, whose long prompt chunks), one replay each
    after their capture, and a decode step (a segment over its SEGMENT
    steps, three replays) on the long probe's rung."""
    from distributed_llm_tpu_torch.engine.inference import SEGMENT
    rung = engine._pick_cache_len(len(long_ids) + engine.tier.max_new_tokens)
    out = {}
    for bucket in sorted({2048, engine._buckets[-1] if long_bucket
                          else 2048}):
        if bucket not in engine._buckets:
            continue
        r = engine._pick_cache_len(bucket + engine.tier.max_new_tokens)
        out[f"prefill_{bucket}_ms"] = seq_program_ms(
            torch, engine, (bucket, r), r,
            dict(tokens=long_ids[:bucket], width=bucket, true_len=min(
                bucket, len(long_ids)), temp=0.0), iters=1)
    out["step_ms"] = seq_program_ms(
        torch, engine, rung, rung,
        dict(cur=long_ids[-1], pos=len(long_ids) - 1, done=False, made=1,
             budget=SEGMENT + 1, temp=0.0), iters=3) / SEGMENT
    out["rung"] = rung
    return out


@contextlib.contextmanager
def timed_captures(torch, on_card: bool):
    """Seconds spent capturing programs inside, and the device memory the
    captures kept (their graph pools), in the yielded dict."""
    from distributed_llm_tpu_torch.engine import batching, programs
    real = programs.capture_program
    out = {"capture_s": 0.0, "graph_pool_gb": 0.0, "captures": 0}

    def timed(*a, **kw):
        m0 = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            out["capture_s"] += time.perf_counter() - t0
            out["captures"] += 1
            if on_card:
                out["graph_pool_gb"] += (torch.cuda.memory_allocated()
                                         - m0) / 1e9

    programs.capture_program = batching.capture_program = timed
    try:
        yield out
    finally:
        programs.capture_program = batching.capture_program = real


@contextlib.contextmanager
def sp_ep_counters():
    """Calls of the ring (``ring_attention.ring``) and of the sp decode
    (``sp_attention.sp_decode``) made inside, by name: a captured program
    makes its calls once, at capture."""
    from distributed_llm_tpu_torch.engine import inference
    from distributed_llm_tpu_torch.parallel import sp_attention
    calls = {"ring": 0, "sp_decode": 0}
    saved = (inference.ring, sp_attention.sp_decode)

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    inference.ring = count("ring", saved[0])
    sp_attention.sp_decode = count("sp_decode", saved[1])
    try:
        yield calls
    finally:
        inference.ring, sp_attention.sp_decode = saved


def sp_ep_budget(torch, tier, wide, group) -> dict:
    """The multichip section's capacity check for sp and ep: a per-device
    budget between the tier's footprint on one device and on ``group``
    (``wide``: the tier at the group's degree) refuses the one-device
    tier in ``EngineManager.start_server`` (nothing built) and fits the
    group's, which the part then serves."""
    from distributed_llm_tpu_torch.engine.manager import (
        EngineManager, TierOverCapacityError)
    from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
    from distributed_llm_tpu_torch.utils.hbm_budget import tier_hbm_budget
    one = tier_hbm_budget(tier, mesh=tp_mesh(["cuda"], 1))
    many = tier_hbm_budget(wide, mesh=group)
    hbm = round((one["total_gb_per_chip"] + many["total_gb_per_chip"]) / 2
                + 0.75, 4)
    out = {"hbm_gb_per_chip": hbm, "one_gb": one["total_gb_per_chip"],
           "group_gb": many["total_gb_per_chip"], "chips": many["chips"]}
    mgr = EngineManager(dataclasses.replace(tier, hbm_gb_per_chip=hbm),
                        device="cuda", warmup_on_start=False)
    try:
        mgr.start_server()
        out["one_refused"] = False
        mgr.stop_server()
    except TierOverCapacityError:
        out["one_refused"] = True
    out["group_fits"] = tier_hbm_budget(
        dataclasses.replace(wide, hbm_gb_per_chip=hbm),
        hbm_per_chip_gb=hbm, mesh=group)["fits"]
    require(out["one_refused"] and out["group_fits"],
            f"{tier.name}: the sp/ep capacity check failed: {out}")
    return out


def sp_ep_part(torch, name, tier, group, ref, want, *, seq: bool,
               long_words: int, device: str, probes=("cold", "long", "hit")):
    """One part: ``tier`` over ``group`` (the card repeated), built on the
    reference engine's weights (``ref``: the same tier on one device,
    whose probe results are ``want``), its ``probes`` as the main path
    (counts reset before, read after; each slot's launches), its timings,
    then held against ``want``: tokens equal or each flip explained
    (``sp_ep_flip``), the cold probe's logits by ``logits_against``
    (float32 from the reference's weights), the experts pinned to the
    reference's routes."""
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine)
    from distributed_llm_tpu_torch.engine.inference import InferenceEngine
    from distributed_llm_tpu_torch.ops import launches as L

    on_card = device == "cuda"
    every, expect = SP_EP_EXPECT[name]
    fresh_peak(torch, on_card)
    res = {"model": tier.model_preset, "shape": group.shape,
           "quantize": tier.quantize, "kv_quantize": tier.kv_quantize}
    t0 = time.perf_counter()
    engine = (InferenceEngine if seq else ContinuousBatchingEngine)(
        tier, seed=0, params=ref.model, group=group)
    res["build_s"] = time.perf_counter() - t0
    try:
        run = [p for p in sp_ep_probes(engine, tier, long_words, seq)
               if p[0] in probes]
        reset_counts()
        shards0 = L.shard_counts()
        with timed_captures(torch, on_card) as cap, sp_ep_counters() as calls:
            t0 = time.perf_counter()
            got = sp_ep_run(torch, engine, run, want["routes"],
                            repeat=engine.model.tp)
            res["main_path_s"] = time.perf_counter() - t0
        launches, _ = read_counts(expect, on_card)
        res["launches_by_slot"] = tp_shard_launches(shards0, group.size,
                                                    every)
        res.update(cap)
        res["launches"] = {k: v for k, v in launches.items() if v}
        res["calls"] = calls
        if group.sp > 1:
            require(calls["ring"] > 0 and calls["sp_decode"] > 0
                    and engine._sp_shard,
                    f"{name}: the ring or the sp decode did not run: {calls}")
        res["ttft_ms"] = got["ttft_ms"]
        if on_card:
            if seq:
                res["times"] = seq_times(torch, engine,
                                         want["tokens"]["long"][0],
                                         long_bucket="long" in probes)
            else:
                res["times"] = {"tick_ms": tick_graph_check(
                    torch, engine).get("tick_replay_ms")}
        res["peak_memory_gb"] = peak_memory_gb(torch, on_card)
        flips = [sp_ep_flip(torch, ref, engine, probe, ids, w,
                            got["tokens"][probe][1], want, seq=seq)
                 for probe, (ids, w) in want["tokens"].items()
                 if probe in probes and got["tokens"][probe][1] != w]
    finally:
        stop = getattr(engine, "stop", None)
        if stop:
            stop()
        del engine
    fresh_peak(torch, on_card)
    require(all(f["near_tie"] for f in flips),
            f"{name}: tokens differ from the unsharded tier beyond a "
            f"near-tie: {flips}")
    path = [f for f in flips if f.get("path_dependent")]
    res["against_unsharded"] = {
        "tokens_identical": not flips, "flips": flips,
        "path_dependent": len(path),
        "path_dependent_max_gap": max((-f["pick_gap"] for f in path),
                                      default=None),
        "route_flips": got["route_flips"],
        **logits_against(got["logits"], want["logits"], want["ref32"])}
    return res, launches


def sp_ep_flip(torch, ref, engine, probe, ids, want_toks, got_toks, want,
               *, seq: bool) -> dict:
    """Where the sharded engine's tokens first differ from the unsharded
    tier's, and why.  A near-tie of the two picks (``near_tie`` on the
    unsharded batched engine, ``seq_near_tie`` on the sequential one).
    A MoE model also passes (``path_dependent``, counted and printed
    per part) when the unsharded model's own replay of the same tokens
    (a prefill, whose expert capacity drops other tokens than the served
    path's) ranks the sharded engine's token first, or when
    the replay routes some row to other experts in the two models at a
    router near-tie (``pinned_routes``: the sharded model run on the
    unsharded one's routes; each differing row's gap within twice the
    router's drift) while, routes pinned, their logits agree within
    ``tol``.  Uncounted."""
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.models import transformer
    with uncounted():
        tie = (seq_near_tie(torch, ref, ids, want_toks, got_toks, want["tol"])
               if seq else near_tie(torch, ref, ids, want_toks, got_toks))
        out = {"probe": probe, **tie}
        if tie["near_tie"] or ref.cfg.num_experts == 1:
            return out
        if tie.get("pick_gap", 0) < 0 and tie.get("got_rank") == 0:
            out["near_tie"] = out["path_dependent"] = True
            return out
        p = tie["position"]
        toks = list(ids) + list(want_toks[:p])
        dev = ref.device
        t = torch.tensor([toks], device=dev)
        pos = torch.arange(len(toks), device=dev)[None]
        routes, logits = [], []
        for model, record in ((ref.model, True), (engine.model, False)):
            pins = routes if record else [
                r for r in routes for _ in range(engine.model.tp)]
            with torch.no_grad(), pinned_routes(pins, record) as notes:
                hidden, _ = models.serving_prefill(ref.cfg, model, t, pos)
                logits.append(transformer.logits_from_hidden(
                    model, hidden[0, -1]).float())
        err = (logits[0] - logits[1]).abs().max().item()
        router_tie = bool(notes) and all(n["gap"] <= 2 * n["drift"]
                                         for n in notes)
        out.update({"route_flips": list(notes), "pinned_max_abs_err": err,
                    "router_tie": router_tie})
        out["near_tie"] = router_tie and err <= want["tol"]
    return out


def sp_ep_reference(torch, tier, *, seq: bool, long_words: int,
                    device: str):
    """The unsharded tier (one device): its engine, its probe results
    (routes recorded for a MoE model), their times and the float32
    logits of the cold probe."""
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine)
    from distributed_llm_tpu_torch.engine.inference import InferenceEngine
    engine = (InferenceEngine if seq else ContinuousBatchingEngine)(
        tier, seed=0, device=device)
    with uncounted():
        want = sp_ep_run(torch, engine,
                         sp_ep_probes(engine, tier, long_words, seq))
        if device == "cuda":
            want["times"] = (seq_times(torch, engine,
                                       want["tokens"]["long"][0]) if seq
                             else {"tick_ms": tick_graph_check(
                                 torch, engine).get("tick_replay_ms")})
        with pinned_routes(list(want["routes"]), record=False):
            want["ref32"] = f32_logits(torch, engine,
                                       want["tokens"]["cold"][0])
    scale = want["ref32"].abs().max().item()
    want["tol"] = LOGITS_RTOL * scale + (want["logits"]
                                         - want["ref32"]).abs().max().item()
    return engine, want


def sp_ep_phase(torch, nano, orin, *, device: str = "cuda"):
    """Phase 22: sequence and expert parallelism over groups of the card
    repeated, each part held against the unsharded tier on the same
    probes in the same call.  (a) orin_8b bf16 on the sequential engine
    at sp=4: a prompt of about 6000 tokens, past the tier's largest
    bucket, prefills as one ring call on the extended ladder and decodes
    over the sequence-split cache; (b) the same at sp=2 x tp=2 (the
    cold and hit probes); (c)
    moe_8x1b at ep=4 on the batched engine (bf16 pool) and on the
    sequential engine (int8 weights: each ep slot's experts run W1);
    (d) moe_8x1b at tp=2 with the int8 pool.  (a) and (c) also run the
    multichip section's capacity check for sp and ep (``sp_ep_budget``).
    Returns (numbers by part, launches summed over the parts)."""
    from distributed_llm_tpu_torch.parallel.mesh import (ep_tp_mesh,
                                                         sp_tp_mesh, tp_mesh)
    on_card = device == "cuda"
    parts, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def group_of(sp=1, ep=1, tp=1):
        if sp > 1:
            return sp_tp_mesh([device] * sp * tp, sp, tp)
        if ep > 1:
            return ep_tp_mesh([device] * ep * tp, ep, tp)
        return tp_mesh([device] * tp, tp)

    moe = moe_tier(nano)
    plan = [
        # (reference tier, sequential, long words, [(part, degrees)])
        (_seq(orin), True, SP_LONG_WORDS,
         [("orin_sp4", dict(sp=4), SP_EP_PROBES),
          # (b) skips the long probe (a)'s ring already prefilled at 8192.
          ("orin_sp2_tp2", dict(sp=2, tp=2), ("cold", "hit"))]),
        (moe, False, MOE_LONG_WORDS,
         [("moe_ep4_batched", dict(ep=4), SP_EP_PROBES)]),
        (_seq(moe, quantize="int8"), True, MOE_LONG_WORDS,
         [("moe_ep4_seq_w8", dict(ep=4), SP_EP_PROBES)]),
        (dataclasses.replace(moe, kv_quantize="int8"), False, MOE_LONG_WORDS,
         [("moe_tp2_int8_pool", dict(tp=2), SP_EP_PROBES)]),
    ]
    for base, seq, long_words, runs in plan:
        fresh_peak(torch, on_card)
        t0 = time.perf_counter()
        ref, want = sp_ep_reference(torch, base, seq=seq,
                                    long_words=long_words, device=device)
        ref_s = time.perf_counter() - t0
        try:
            for name, degrees, probes in runs:
                t0 = time.perf_counter()
                tier = dataclasses.replace(base, **degrees)
                group = group_of(**degrees)
                budget = (sp_ep_budget(torch, base, tier, group)
                          if on_card and name in ("orin_sp4",
                                                  "moe_ep4_batched")
                          else None)
                parts[name], launches = sp_ep_part(
                    torch, name, tier, group, ref, want, seq=seq,
                    long_words=long_words, device=device, probes=probes)
                parts[name]["unsharded"] = {
                    "ttft_ms": want["ttft_ms"], "times": want.get("times"),
                    "build_and_probes_s": ref_s}
                if budget:
                    parts[name]["budget"] = budget
                parts[name]["wall_s"] = time.perf_counter() - t0
                add(launches)
                log(f"sp_ep {name} in {parts[name]['wall_s']:.1f}s")
        finally:
            stop = getattr(ref, "stop", None)
            if stop:
                stop()
            del ref
    return parts, total


def sp_ep_summary(parts: dict) -> dict:
    """What phase 22 prints of each part."""
    out = {}
    for name, r in parts.items():
        out[name] = {k: r.get(k) for k in (
            "shape", "build_s", "capture_s", "captures", "graph_pool_gb",
            "main_path_s", "ttft_ms", "times", "unsharded", "calls",
            "launches_by_slot", "against_unsharded", "budget",
            "peak_memory_gb", "wall_s") if r.get(k) is not None}
    return out


# -- phase 23: training over groups of the card repeated ---------------------------

TRAIN_MESH_DIR = os.path.join(REPO, "build", "chip_smoke_train_mesh")
TRAIN_MESH_DENSE = "nano_1b"
TRAIN_MESH_MOE = "moe_8x1b"
# moe_8x1b cut to 4 of its 16 layers: full depth with its AdamW state is
# about 53 GB before activations, and the phase holds three trainers.
TRAIN_MESH_MOE_LAYERS = 4
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ = 8, 256
TRAIN_MESH_MOE_BATCH, TRAIN_MESH_MOE_SEQ = 4, 128
TRAIN_MESH_MICRO = 4
TRAIN_MESH_STEPS = 3             # the first held to float32, all finite
# The floor of the float32 rule, relative to the float32 value's scale
# (one bf16 rounding).
TRAIN_MESH_FLOOR = 2.0 ** -8


def train_mesh_tc(batch: int, seq: int):
    """A warmup of 0, so the first update moves the weights."""
    from distributed_llm_tpu_torch.training.trainer import TrainConfig
    return TrainConfig(batch_size=batch, seq_len=seq, warmup_steps=0,
                       decay_steps=10, seed=0)


def state_of(trainer) -> dict:
    """A copy of a trainer's weights, whole, on its lead device (on one
    device ``model`` is the live module, which later steps update)."""
    if hasattr(trainer, "export_params"):
        return trainer.export_params().state_dict()
    if trainer.placement.model is not None:
        return {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return trainer.model.state_dict()


def state_dist(torch, a: dict, b: dict) -> float:
    """The float32 L2 distance between two states."""
    return math.sqrt(sum(float(torch.sum((a[k].float() - b[k].float()) ** 2))
                         for k in b))


def against_f32(got: float, bf16: float, scale: float, what: str) -> dict:
    """Phase 21's rule: a sharded run's distance to the unsharded float32
    run at most twice the unsharded bf16 run's own, above
    TRAIN_MESH_FLOOR of the float32 value's scale."""
    res = {"vs_float32": got, "unsharded_vs_float32": bf16,
           "tol": 2 * bf16 + TRAIN_MESH_FLOOR * scale}
    require(got <= res["tol"], f"{what} disagrees with float32: {res}")
    return res


def train_mesh_refs(torch, cfg, weights, stream, tc, device: str) -> dict:
    """The unsharded runs on ``weights``, uncounted: the trainer in bf16
    (K2) over every batch of ``stream`` (its ms a step past the first
    beside the sharded parts'), and a float32 copy with the plain causal
    attention in float32 for the first (the reference); their first
    metrics and weights after the first step."""
    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.training.trainer import Trainer
    out = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    for name, c, steps in (("float32", cfg32, stream[:1]),
                           ("bf16", cfg, stream)):
        params = models.transformer.Transformer(c, device="meta")
        params.load_state_dict({k: v.to(models.transformer.torch_dtype(c),
                                        copy=True)
                                for k, v in weights.items()}, assign=True)
        causal = TA.causal
        if name == "float32":
            TA.causal = TA.causal_attention
        try:
            with uncounted():
                tr = Trainer(c, tc, params=params, device=device)
                step_ms = []
                for tokens, mask in steps:
                    t0 = time.perf_counter()
                    metrics = tr.train_step(tokens, mask)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    if len(step_ms) == 1:
                        out[name] = {"metrics": metrics, "state": state_of(tr)}
                out[name]["step_ms"] = step_ms
        finally:
            TA.causal = causal
        del tr, params
        gc.collect()
    out["step_norm"] = state_dist(torch, out["float32"]["state"], weights)
    return out


@contextlib.contextmanager
def train_mesh_counters():
    """The ring's calls (``trainer.ring``) and, by slot, the expert slices
    a MoE layer ran (``on_shard`` inside ``moe._over_slices``)."""
    from distributed_llm_tpu_torch.models import moe
    from distributed_llm_tpu_torch.ops import launches as L
    from distributed_llm_tpu_torch.training import trainer as T
    calls = {"ring": 0, "expert_slots": {}}
    saved = (T.ring, moe._over_slices, L.on_shard)
    inside = []

    def ring(*a, **kw):
        calls["ring"] += 1
        return saved[0](*a, **kw)

    def over_slices(*a, **kw):
        inside.append(1)
        try:
            return saved[1](*a, **kw)
        finally:
            inside.pop()

    def on_shard(index):
        if inside:
            slots = calls["expert_slots"]
            slots[index] = slots.get(index, 0) + 1
        return saved[2](index)

    T.ring, moe._over_slices, L.on_shard = ring, over_slices, on_shard
    try:
        yield calls
    finally:
        T.ring, moe._over_slices, L.on_shard = saved


def train_mesh_part(torch, name: str, make, stream, refs: dict,
                    *, every=(), device: str) -> tuple:
    """One sharded trainer (``make()``) for TRAIN_MESH_STEPS steps of
    ``stream``: its first loss, pre-clip grad norm and weights after the
    step by phase 21's rule against ``refs``, every loss finite, ms a
    step (the median past the first), tokens/s, peak memory and the
    launches by slot; K2 must launch on every slot in ``every``.
    Returns (numbers, trainer)."""
    from distributed_llm_tpu_torch.ops import launches as L
    on_card = device == "cuda"
    fresh_peak(torch, on_card)
    reset_counts()
    before = L.shard_counts()
    with train_mesh_counters() as calls:
        t0 = time.perf_counter()
        tr = make()
        build_s = time.perf_counter() - t0
        metrics, step_ms = [], []
        for tokens, mask in stream:
            t0 = time.perf_counter()
            metrics.append(tr.train_step(tokens, mask))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(metrics) == 1:
                with uncounted():
                    state = state_of(tr)
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()}
    per = L.shard_since(before)
    require(all(math.isfinite(m["loss"]) for m in metrics),
            f"{name}: a loss is not finite: {metrics}")
    f32, bf16 = refs["float32"], refs["bf16"]
    res = {"loss": against_f32(
        abs(metrics[0]["loss"] - f32["metrics"]["loss"]),
        abs(bf16["metrics"]["loss"] - f32["metrics"]["loss"]),
        abs(f32["metrics"]["loss"]), f"{name} loss"),
        "grad_norm": against_f32(
        abs(metrics[0]["grad_norm"] - f32["metrics"]["grad_norm"]),
        abs(bf16["metrics"]["grad_norm"] - f32["metrics"]["grad_norm"]),
        abs(f32["metrics"]["grad_norm"]), f"{name} grad norm"),
        "weights": against_f32(
        state_dist(torch, state, f32["state"]),
        state_dist(torch, bf16["state"], f32["state"]),
        refs["step_norm"], f"{name} weights after the first step")}
    del state
    missing = [s for s in every if not per.get(s, {}).get("flash_causal")]
    require(not on_card or not missing,
            f"{name}: K2 did not launch on slots {missing} ({per})")
    steady = statistics.median(step_ms[1:])
    unsharded = statistics.median(refs["bf16"]["step_ms"][1:])
    tokens = stream[0][0].size
    out = {"group": dict(tr.mesh.shape), "build_s": build_s,
           "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "first_step": res, "step_ms": step_ms,
           "steady_ms_per_step": steady,
           "tokens_per_s": tokens * 1e3 / steady,
           "unsharded_ms_per_step": unsharded,
           "vs_unsharded": steady / unsharded,
           "unsharded_step_ms": {k: refs[k]["step_ms"]
                                 for k in ("bf16", "float32")},
           "peak_memory_gb": peak_memory_gb(torch, on_card),
           "launches": launches, "ring_calls": calls["ring"],
           "expert_slots": calls["expert_slots"],
           "launches_by_slot": {str(s): dict(sorted(d.items()))
                                for s, d in sorted(per.items())}}
    return out, tr


def train_mesh_stream(cfg, batch: int, seq: int) -> list:
    from distributed_llm_tpu_torch.engine.tokenizer import get_tokenizer
    from distributed_llm_tpu_torch.training.data import batches
    stream = batches(batch, seq, seed=0, tokenizer=get_tokenizer(cfg))
    return [next(stream) for _ in range(TRAIN_MESH_STEPS)]


def train_mesh_phase(torch, nano, orin, *, device: str = "cuda"):
    """Phase 23: training over groups of the card repeated (the costs of
    sharding on one card, not a speedup), each part from the same
    weights and batches as the unsharded trainer in this call: (a)
    TRAIN_MESH_DENSE at full width over ``training_mesh`` of 4 slots
    (JAX's rule: tp=4); (b) over ('dp', 'sp', 'tp') = (2, 2, 2): FSDP,
    the ring and TP in one step; (c) ``PipelineTrainer`` at pp=2 with
    TRAIN_MESH_MICRO microbatches; (d) TRAIN_MESH_MOE at its widths cut
    to TRAIN_MESH_MOE_LAYERS layers over ``moe_training_mesh`` of 8
    slots (ep=8); (e) (b)'s checkpoint restored onto one device and onto
    (a)'s group, the leaves equal bit for bit and one more step finite on
    each.  Returns (numbers, launches)."""
    import shutil

    from distributed_llm_tpu_torch import models
    from distributed_llm_tpu_torch.config import MODEL_PRESETS
    from distributed_llm_tpu_torch.parallel.mesh import (
        DeviceGroup, moe_training_mesh, training_mesh)
    from distributed_llm_tpu_torch.training import PipelineTrainer
    from distributed_llm_tpu_torch.training.trainer import Trainer

    on_card = device == "cuda"
    slots = [device] * 8
    out, total = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def whole(weights, cfg):
        def make_params():
            m = models.transformer.Transformer(cfg, device="meta")
            m.load_state_dict({k: v.clone() for k, v in weights.items()},
                              assign=True)
            return m
        return make_params

    cfg = MODEL_PRESETS[TRAIN_MESH_DENSE]
    tc = train_mesh_tc(TRAIN_MESH_BATCH, TRAIN_MESH_SEQ)
    stream = train_mesh_stream(cfg, TRAIN_MESH_BATCH, TRAIN_MESH_SEQ)
    weights = models.init_params(cfg, seed=0, device=device).state_dict()
    params = whole(weights, cfg)
    refs = train_mesh_refs(torch, cfg, weights, stream, tc, device)
    mesh_a = training_mesh(slots[:4], num_kv_heads=cfg.num_kv_heads,
                           seq_len=TRAIN_MESH_SEQ)
    out["a_training_mesh"], tr = train_mesh_part(
        torch, "a", lambda: Trainer(cfg, tc, mesh_a, params=params()),
        stream, refs, every=range(mesh_a.size), device=device)
    add(out["a_training_mesh"]["launches"])
    del tr
    mesh_b = DeviceGroup(tuple(slots), ("dp", "sp", "tp"), (2, 2, 2))
    out["b_dp_sp_tp"], tr_b = train_mesh_part(
        torch, "b", lambda: Trainer(cfg, tc, mesh_b, params=params()),
        stream, refs, device=device)
    add(out["b_dp_sp_tp"]["launches"])
    require(out["b_dp_sp_tp"]["ring_calls"] > 0, "(b): the ring did not run")

    # (e) (b)'s state through a checkpoint onto one device and (a)'s group.
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    root = tr_b.save(TRAIN_MESH_DIR)
    save_s = time.perf_counter() - t0
    with uncounted():
        saved = state_of(tr_b)
    del tr_b
    ckpt_out = {"save_s": save_s}
    for name, group in (("one_device", None), ("a_group", mesh_a)):
        fresh_peak(torch, on_card)
        other = models.init_params(cfg, seed=1, device=device)
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc, group, params=other, device=device)
        tr.load(root)
        load_s = time.perf_counter() - t0
        restored_step = tr.step_count
        with uncounted():
            got = state_of(tr)
            equal = all(torch.equal(got[k], v) for k, v in saved.items())
            del got
            after = tr.train_step(*stream[0])
        require(equal and restored_step == TRAIN_MESH_STEPS,
                f"(e) {name}: the restored leaves or step ({restored_step}) "
                "differ from (b)'s")
        require(math.isfinite(after["loss"]),
                f"(e) {name}: the next step's loss {after}")
        ckpt_out[name] = {"load_s": load_s, "equal": equal,
                          "next_loss": after["loss"]}
        del tr, other
    out["e_checkpoint"] = ckpt_out
    del saved
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)

    pp = DeviceGroup(tuple(slots[:2]), ("pp",))
    out["c_pipeline"], tr = train_mesh_part(
        torch, "c", lambda: PipelineTrainer(cfg, tc, pp, TRAIN_MESH_MICRO,
                                            params=params()),
        stream, refs, every=range(2), device=device)
    add(out["c_pipeline"]["launches"])
    del tr, refs, weights, params
    gc.collect()

    moe_cfg = dataclasses.replace(MODEL_PRESETS[TRAIN_MESH_MOE],
                                  num_layers=TRAIN_MESH_MOE_LAYERS)
    moe_tc = train_mesh_tc(TRAIN_MESH_MOE_BATCH, TRAIN_MESH_MOE_SEQ)
    moe_stream = train_mesh_stream(moe_cfg, TRAIN_MESH_MOE_BATCH,
                                   TRAIN_MESH_MOE_SEQ)
    fresh_peak(torch, on_card)
    moe_weights = models.init_params(moe_cfg, seed=0,
                                     device=device).state_dict()
    moe_refs = train_mesh_refs(torch, moe_cfg, moe_weights, moe_stream,
                               moe_tc, device)
    mesh_d = moe_training_mesh(slots, num_experts=moe_cfg.num_experts)
    out["d_moe"], tr = train_mesh_part(
        torch, "d", lambda: Trainer(moe_cfg, moe_tc, mesh_d,
                                    params=whole(moe_weights, moe_cfg)()),
        moe_stream, moe_refs,
        every=[mesh_d.index(dp=d) for d in range(mesh_d.dp)], device=device)
    add(out["d_moe"]["launches"])
    out["d_moe"]["layers"] = f"{TRAIN_MESH_MOE_LAYERS} of " \
        f"{MODEL_PRESETS[TRAIN_MESH_MOE].num_layers} (depth cut)"
    ran = out["d_moe"]["expert_slots"]
    require(all(ran.get(mesh_d.index(ep=e)) for e in range(mesh_d.ep)),
            f"(d): an ep slot ran no experts: {ran}")
    del tr, moe_refs, moe_weights
    gc.collect()
    return out, total


def train_mesh_summary(parts: dict) -> dict:
    keys = ("group", "losses", "grad_norms", "first_step",
            "steady_ms_per_step", "tokens_per_s", "unsharded_ms_per_step",
            "vs_unsharded", "unsharded_step_ms",
            "peak_memory_gb", "ring_calls", "expert_slots",
            "launches_by_slot")
    return {name: ({k: p[k] for k in keys if k in p}
                   if "launches_by_slot" in p else p)
            for name, p in parts.items()}


# -- phase 24: the port's lint, and its transfer rule's twin on the card -----

# The steady ticks watched for host syncs, after every slot is decoding.
LINT_WINDOW_TICKS = 24
LINT_SETTLE_TICKS = 2
# A request's budget: 64 ticks of 4 steps, so no slot ends in the window.
LINT_MAX_NEW = 256


def sync_watch(torch, thread):
    """A context that records every synchronizing CUDA call PyTorch
    reports (``torch.cuda.set_sync_debug_mode("warn")``) on the engine's
    scheduler ``thread``, with whether it ran inside ``_fetch_tick``:
    yields the dict it fills, ``fetch`` (a count), ``outside`` (the
    innermost repo frames of each other sync) and ``other_threads`` (a
    count of syncs elsewhere: the window's own opening, outside any
    tick)."""
    import traceback
    import warnings

    seen = {"fetch": 0, "outside": [], "other_threads": 0}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        if threading.current_thread() is not thread:
            seen["other_threads"] += 1
            return
        stack = traceback.extract_stack()
        if any(f.name == "_fetch_tick" for f in stack):
            seen["fetch"] += 1
            return
        seen["outside"].append([f"{os.path.relpath(f.filename, REPO)}:"
                                f"{f.lineno} {f.name}" for f in stack
                                if f.filename.startswith(REPO)][-4:])

    @contextlib.contextmanager
    def watching():
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield seen
            finally:
                torch.cuda.set_sync_debug_mode(0)

    return watching()


def lint_phase(torch, nano, orin, *, device: str = "cuda"):
    """(a) ``python -m distributed_llm_tpu_torch.lint`` over the port, as
    a subprocess on the card's machine: exit 0 and zero findings; its
    files, findings, suppressions and seconds.  (b) The transfer rule's
    twin on the card: nano_1b at full width on the batched engine (8
    slots, the ragged tick), every slot decoding and none queued, watched
    for LINT_WINDOW_TICKS steady ticks under PyTorch's sync check.  Every
    synchronizing call must pass through ``_fetch_tick`` (the tick's one
    sanctioned sync), and K1 (``ragged_decode``) must have launched.  An
    event or stream wait (``Event.synchronize()``) escapes PyTorch's
    check, so this twin sees less than the static rule, which stays the
    authority; the two run side by side, the lint in its own process."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager

    on_card = device == "cuda"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_llm_tpu_torch.lint", "--json"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tier = dataclasses.replace(nano, max_new_tokens=LINT_MAX_NEW,
                                   enable_prefix_cache=False)
        fresh_peak(torch, on_card)
        manager = EngineManager(tier, seed=0, device=device,
                                warmup_on_start=False)
        manager.start_server()
        engine = manager.engine()
        try:
            reqs = [engine.submit(words(40, offset=13 * i),
                                  max_new_tokens=LINT_MAX_NEW)
                    for i in range(tier.decode_batch)]
            deadline = time.monotonic() + 120
            while (engine.queue_depth() or any(s is None
                                               for s in engine._slots)):
                require(time.monotonic() < deadline,
                        "lint phase: the slots never all decoded")
                require(not any(r.done.is_set() for r in reqs),
                        "lint phase: a request ended before the window")
                time.sleep(0.005)
            settle = engine.ticks_total + LINT_SETTLE_TICKS
            while engine.ticks_total < settle:
                time.sleep(0.002)
            with sync_watch(torch, engine._thread) as syncs:
                reset_counts()
                start = engine.ticks_total
                while engine.ticks_total < start + LINT_WINDOW_TICKS:
                    require(time.monotonic() < deadline,
                            "lint phase: the ticks stalled")
                    time.sleep(0.002)
                ticks = engine.ticks_total - start
                launches, plain_calls = read_counts(("ragged_decode",),
                                                    on_card)
            active = sum(1 for s in engine._slots if s is not None)
            queued = engine.queue_depth()
        finally:
            manager.stop_server()
        require(not syncs["outside"],
                f"lint phase: {len(syncs['outside'])} synchronizing calls "
                f"outside _fetch_tick over {ticks} steady ticks: "
                f"{syncs['outside'][:4]}")
        require(syncs["fetch"] >= ticks - 1,
                f"lint phase: the sync check saw {syncs['fetch']} "
                f"_fetch_tick syncs over {ticks} ticks")
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lint_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"lint phase: the lint exited {proc.returncode}: "
            f"{out[-2000:]} {err[-2000:]}")
    payload = json.loads(out)
    require(payload["ok"] and payload["counts"]["findings"] == 0,
            f"lint phase: findings: {[f for f in payload['findings'] if not f['suppressed']]}")
    files = sum(1 for d, _, fs in os.walk(os.path.join(
        REPO, "distributed_llm_tpu_torch")) if "__pycache__" not in d
        for f in fs if f.endswith(".py"))
    lint = {"files": files, "findings": payload["counts"]["findings"],
            "suppressed": payload["counts"]["suppressed"],
            "wall_s": lint_s}
    log(f"lint: {files} files, {lint['findings']} findings, "
        f"{lint['suppressed']} suppressed, {lint_s:.2f}s (beside the "
        f"sync watch)")
    return {"lint": lint,
            "sync_watch": {"ticks": ticks, "fetch_syncs": syncs["fetch"],
                           "outside_syncs": len(syncs["outside"]),
                           "other_thread_syncs": syncs["other_threads"],
                           "active_slots": active, "queued": queued},
            "launches": launches, "plain_calls": plain_calls}, launches


# Phases 7-9b, the sequential engines at full width and depth (also
# ``--only``-able): (tier of (nano, orin), the kernels that must launch).
SEQ_PHASES = {
    "orin_seq_bf16": (lambda nano, orin: _seq(orin),
                      ("flash_causal", "flash_decode", "flash_chunk")),
    "orin_seq_spec": (lambda nano, orin: _seq(
        orin, draft_preset=nano.model_preset),
        ("flash_causal", "flash_decode", "flash_chunk")),
    "nano_seq_int8": (lambda nano, orin: _seq(nano, kv_quantize="int8"),
                      ("flash_causal", "flash_decode_q8", "flash_chunk_q8")),
    "nano_seq_w8": (lambda nano, orin: _seq(nano, quantize="int8"),
                    ("flash_causal", "flash_decode", "flash_chunk",
                     "w8_matmul")),
}

ORIN_LENGTHS = (4, 60, 150, 240)


def orin_w8_phase(torch, nano, orin):
    """6b: orin_8b with int8 weights and the nano_1b draft (int8 weights
    too), batched: the decode, verify and draft rows through W1's decode
    regime, the prefills and the long prompt's four 256-row chunks through
    its wide regime, and no cast route."""
    serve, launches = serve_phase(
        torch, dataclasses.replace(orin, quantize="int8",
                                   draft_preset=nano.model_preset),
        lengths=ORIN_LENGTHS, sampled=True,
        expect=("ragged_decode", "flash_causal", "paged_chunk",
                "ragged_verify", "w8_matmul"))
    require(all(serve["w8_routes"].values()),
            f"orin_w8: a regime of W1 never ran: {serve['w8_routes']}")
    return serve, launches


LATE_PHASES = {
    "w8": lambda torch, nano, orin: (w8_kernel_phase(
        torch, nano.model(), orin.model()), {}),
    "orin_spec_bf16": lambda torch, nano, orin: serve_phase(
        torch, dataclasses.replace(orin, draft_preset=nano.model_preset),
        lengths=ORIN_LENGTHS, sampled=True,
        expect=("ragged_decode", "flash_causal", "paged_chunk",
                "ragged_verify")),
    "orin_w8": orin_w8_phase,
    **{name: (lambda torch, nano, orin, make=make, expect=expect:
              serve_sequential_phase(torch, make(nano, orin), expect=expect))
       for name, (make, expect) in SEQ_PHASES.items()},
    # nano_1b, 8 slots, bf16 pool, ragged tick: 8 prompts of about 900
    # tokens (and 2 short) with a 256-token budget overrun 96 blocks of 2
    # MiB (full residency: 1024).
    "pressure_nano": lambda torch, nano, orin: pressure_phase(
        torch, nano, pool_blocks=96, n_long=8, n_short=2,
        expect=("ragged_decode", "flash_causal", "paged_chunk")),
    # orin_8b with int8 weights and an int8 pool, 4 slots, the nano_1b
    # draft (int8 weights too): 36 blocks of 4.1 MiB (full residency:
    # 512).  Two long requests admit at 15 blocks each and grow to 19.
    "pressure_orin": lambda torch, nano, orin: pressure_phase(
        torch, dataclasses.replace(orin, quantize="int8", kv_quantize="int8",
                                   draft_preset=nano.model_preset),
        pool_blocks=36, n_long=4, n_short=2,
        expect=("flash_causal", "ragged_decode_q8", "ragged_verify_q8",
                "w8_matmul")),
    "spill": lambda torch, nano, orin: spill_chip_phase(
        torch, nano, expect=("ragged_decode", "flash_causal",
                             "paged_chunk")),
    # The trained tiny tiers behind /chat (head dim 16, 16-token blocks).
    "trained_chat": lambda torch, nano, orin: trained_chat_phase(
        torch, expect=("ragged_decode", "flash_causal", "paged_chunk")),
    "legs": lambda torch, nano, orin: legs_phase(torch, nano, orin),
    "fleet": lambda torch, nano, orin: fleet_phase(torch, nano, orin),
    "fleet2": lambda torch, nano, orin: fleet2_phase(torch, nano, orin),
    "edges": lambda torch, nano, orin: edges_phase(torch, nano, orin),
    "moe": lambda torch, nano, orin: moe_phase(torch, nano, orin),
    "train": lambda torch, nano, orin: train_phase(torch, nano, orin),
    "tp": lambda torch, nano, orin: tp_phase(torch, nano, orin),
    "sp_ep": lambda torch, nano, orin: sp_ep_phase(torch, nano, orin),
    "train_mesh": lambda torch, nano, orin: train_mesh_phase(torch, nano,
                                                             orin),
    "lint": lambda torch, nano, orin: lint_phase(torch, nano, orin),
    "bench": lambda torch, nano, orin: bench_phase(torch),
}


BENCH_BUDGET_S = 600.0
# The open-loop leg's share of it (the JAX bench gives it up to 120 s;
# 40 s is its least, which keeps the whole script inside its limit).
BENCH_OPENLOOP_S = 40.0
# The sweep's depth: the first 4 of the 12 general_knowledge queries a
# strategy (both legs, every strategy), and 3 trend repeats, not 5; the
# tiny tiers' tenant and autoscaler legs at the CPU tests' depth (the
# noisy load 1.0 s, not 2.5; the elastic ramp 6 s and the chaos2 ramp
# 8 s, not 20 and 16): cut to pay for phases 19, 20 and 21.
BENCH_QUERIES = 4
BENCH_TREND_REPEATS = 3
BENCH_LEG_DEPTH = {"noisy_phase": {"load_s": 1.0},
                   "elastic_phase": {"period_s": 6.0},
                   "chaos2_phase": {"period_s": 8.0}}


@contextlib.contextmanager
def leg_depth(module, depth: dict):
    """``module``'s leg functions called with ``depth``'s keyword
    arguments inside (the headline calls them by module attribute)."""
    saved = {name: getattr(module, name) for name in depth}
    for name, kw in depth.items():
        setattr(module, name, lambda *a, _fn=saved[name], _kw=kw, **k:
                _fn(*a, **{**_kw, **k}))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
BENCH_KERNELS = ("ragged_decode", "flash_causal", "paged_chunk",
                 "ragged_decode_q8", "w8_matmul", "paged_decode",
                 "ragged_verify")
TESTER_ROWS = 12                  # the general_knowledge set, one config


def check_utilization(util: dict) -> None:
    """Every MFU and device-memory utilization in (0, 1.05]: past 1.05 a
    byte count or a phase time is wrong."""
    for ph in ("prefill", "decode"):
        for key in ("mfu", "hbm_util"):
            val = (util.get(ph) or {}).get(key)
            require(val is not None and 0.0 < val <= 1.05,
                    f"bench utilization {ph}.{key} = {val} is outside "
                    f"(0, 1.05]: {util}")


def bench_phase(torch, device: str = "cuda", out_dir: str = REPORT_DIR,
                budget_s: float = BENCH_BUDGET_S, expect=BENCH_KERNELS):
    """The port's bench on ``device``: ``bench.headline.run`` on the bench
    cluster (one repeat, 4 clients; its JSON lines go to
    ``bench_stdout.txt`` under ``out_dir``), then the canonical tester
    once (heuristic, cache off, general_knowledge; CSVs under
    ``out_dir``).  Every strategy must serve with no concurrent error, no
    section may hold an error, the utilizations lie in (0, 1.05], the
    trend leg ran on ``device``, each batched tier timed one decode phase
    per tick, the kernels in ``expect`` launched and no plain attention
    version ran; the tester's CSVs carry the JAX package's headers and
    one row per query, each with a TTFT, and on the card each serving
    tier's mean power draw reads 10-1000 W.  Returns (numbers, launches by
    kernel)."""
    import csv

    from distributed_llm_tpu_torch.bench import elastic, headline, tester

    on_card = device == "cuda"
    fresh_peak(torch, on_card)
    os.makedirs(out_dir, exist_ok=True)
    summary_csv = os.path.join(out_dir, "bench_tester_summary.csv")
    per_query_csv = os.path.join(out_dir, "bench_tester_per_query.csv")
    progress = headline.Progress(os.path.join(out_dir, "bench_partial.json"))
    # Each section's wall seconds: the time since the previous one closed.
    section_s = {}
    marks = [time.perf_counter()]
    real_section = progress.section

    def section(name, value):
        now = time.perf_counter()
        section_s[name] = round(now - marks[0], 2)
        marks[0] = now
        real_section(name, value)

    progress.section = section
    reset_counts()
    t0 = marks[0] = time.perf_counter()
    with admission_audit(torch, on_card) as audit, \
            open(os.path.join(out_dir, "bench_stdout.txt"), "w") as out, \
            contextlib.redirect_stdout(out), \
            leg_depth(elastic, BENCH_LEG_DEPTH):
        result = headline.run(
            device, repeats=1, clients=4, n_queries=BENCH_QUERIES,
            trend_repeats=BENCH_TREND_REPEATS, progress=progress,
            budget=headline.Budget(budget_s),
            tie_check=tie_checker(torch), openloop_budget_s=BENCH_OPENLOOP_S)
        headline_s = time.perf_counter() - t0
        tester.main(["--query-set", "general_knowledge", "--strategies",
                     "heuristic", "--cache-modes", "off", "--device", device,
                     "--output-csv", summary_csv,
                     "--output-per-query-csv", per_query_csv])
    wall_s = time.perf_counter() - t0
    launches, _ = read_counts(expect, on_card)
    admission = audit.main_path(on_card)

    per = result["per_strategy"]
    require(set(per) == set(headline.STRATEGIES),
            f"bench strategies {sorted(per)}")
    for name, entry in per.items():
        require(entry["req_per_s"] > 0 and entry["p50_ttft_ms"] is not None
                and not entry.get("concurrent_errors"),
                f"bench strategy {name}: {entry}")
    require(result["concurrent_errors"] == 0,
            f"bench concurrent errors: {result['concurrent_errors']}")
    errors = headline.section_errors(result)
    require(not errors, f"bench sections with an error: {errors}")
    # The trace-derived columns count every request each strategy served:
    # both legs of each repeat, perf's warm pass and, for the first
    # strategy, the calibration request.
    reps = result["req_per_s_stats"]["n"]
    n_q = result["budget"]["queries_per_strategy"]
    for name, entry in per.items():
        served_n = (reps * n_q * (3 if name == "perf" else 2)
                    + (name == headline.STRATEGIES[0]))
        require(entry.get("trace_p50_ttft_ms") is not None
                and entry.get("trace_ttft_n") == served_n,
                f"bench strategy {name}: trace columns {entry} against "
                f"{served_n} requests served")
    require("error" not in result["profile"] and "coverage"
            in result["profile"],
            f"bench profile section: {result['profile']}")
    spill = result["spill"]
    require(spill.get("outputs_identical") and spill.get("hit_rate_monotone")
            and (spill.get("race") or {}).get("observed"),
            f"bench spill section: {spill}")
    if on_card:
        check_utilization(result["utilization"])
    trend = result["trend"]
    require(str(trend.get("device", "")).startswith(device),
            f"the trend leg did not run on {device}: {trend}")
    for name, entry in result["tiers"].items():
        require(entry["phases"]["decode"]["count"] == entry["tick"]["ticks"],
                f"bench tier {name}: decode phases "
                f"{entry['phases']['decode']} against ticks {entry['tick']}")
    # The features and flagship legs: each ran (no budget skip on the
    # card) and decoded.
    quant_legs = result["quant"]
    require(set(quant_legs) == {"nano", "orin"} and all(
        leg.get("int8_decode_tok_per_s", 0) > 0 for leg in quant_legs.values()),
        f"bench quant section: {quant_legs}")
    require(result["speculative"].get("spec_decode_tok_per_s", 0) > 0,
            f"bench speculative section: {result['speculative']}")
    if on_card:
        require(all(result["flagship"].get(label, {}).get("decode_tok_per_s")
                    for label in ("nano_1b", "orin_8b_int8")),
                f"bench flagship section: {result['flagship']}")
    # The engine legs and the open-loop leg at the JAX bench's pinned
    # configurations: their invariants, identity or near-ties only.
    require(result["skew"]["ragged"]["compiled_decode_programs"] == 1,
            f"bench skew section: {result['skew']}")
    spec_on = result["spec_phase"]["on"]
    require(0 < spec_on["verify_programs"] <= len(spec_on["gamma_buckets"]),
            f"bench spec_phase section: {spec_on}")
    require(result["shared"]["peak_ratio"] < 0.6,
            f"bench shared section: {result['shared']}")
    for leg in ("skew", "spec_phase", "mixed", "shared"):
        sec = result[leg]
        require(sec["outputs_identical"] or (
            sec.get("flips") and all(f["near_tie"] for f in sec["flips"])),
            f"bench {leg} section: outputs differ beyond a near-tie: "
            f"{sec.get('flips')}")
    require((result["openloop"].get("knee_req_per_s") or 0) > 0,
            f"bench openloop section: {result['openloop']}")
    # The fleet legs at the JAX bench's pinned configurations: no client
    # hung, the drain finished its stragglers and then refused, and the
    # replica leg held its invariants (identity or near-ties).
    for strategy in ("heuristic", "hybrid", "perf"):
        st = result["chaos"][strategy]
        require(st["requests"] > 0 and not st["hung_clients"]
                and not st["errors"],
                f"bench chaos section {strategy}: {st}")
    pressure = result["pressure"]
    require(not pressure["load"]["hung_clients"]
            and pressure["drain"]["finished_ok"] == 2
            and pressure["drain"]["post_drain_rejected"]
            and pressure["replay_identity"]["preemptions"] >= 1
            and pressure["replay_identity"]["pool_freed"],
            f"bench pressure section: {pressure}")
    require(all(p["compiled"] == 1 for p in
                result["replica"]["decode_programs_per_replica"].values()),
            f"bench replica section: {result['replica']}")
    require("verdict" in result["perf_steering"],
            f"bench perf_steering section: {result['perf_steering']}")
    # The tenant and autoscaler legs (their hard invariants are section
    # errors, checked above): each ran and served.
    noisy, elastic_sec, chaos2 = (result["noisy"], result["elastic"],
                                  result["chaos2"])
    require(noisy.get("outputs_identical") is True
            and (noisy.get("on") or {}).get("quiet_served", 0) > 0,
            f"bench noisy section: {noisy}")
    require(elastic_sec.get("flap_count") == 0
            and (elastic_sec.get("auto") or {}).get("arrivals", 0) > 0,
            f"bench elastic section: {elastic_sec}")
    require(chaos2.get("availability", 0) >= 0.99
            and chaos2.get("failovers") == 0,
            f"bench chaos2 section: {chaos2}")
    # The spec_multiturn leg: both engines' follow-up TTFT and the cost.
    require(all(result["spec_multiturn"].get(k, 0) > 0 for k in (
        "plain_followup_ttft_ms", "spec_followup_ttft_ms",
        "spec_followup_ttft_cost")),
        f"bench spec_multiturn section: {result['spec_multiturn']}")

    with open(summary_csv, newline="") as f:
        summary_rows = list(csv.reader(f))
    with open(per_query_csv, newline="") as f:
        query_rows = list(csv.reader(f))
    require(summary_rows[0] == tester.SUMMARY_HEADERS
            and query_rows[0] == tester.PER_QUERY_HEADERS,
            "the tester's CSV headers are not the JAX package's")
    ttft = tester.PER_QUERY_HEADERS.index("ttft_ms")
    require(len(summary_rows) == 2 and len(query_rows) == TESTER_ROWS + 1
            and all(float(r[ttft] or 0) > 0 for r in query_rows[1:]),
            f"the tester wrote {len(summary_rows) - 1} summary and "
            f"{len(query_rows) - 1} per-query rows")
    summary = dict(zip(summary_rows[0], summary_rows[1]))
    if on_card:
        # The energy columns integrate the card's power draw (mW x s):
        # each serving tier's mean draw must read as a card's, 10-1000 W.
        for tier in ("nano", "orin"):
            if float(summary[f"{tier}_total_latency_ms"] or 0) > 0:
                mw = float(summary[f"{tier}_avg_power_mW"] or 0)
                require(1e4 <= mw <= 1e6,
                        f"the tester's {tier}_avg_power_mW = {mw} is no "
                        f"card's draw: {summary}")
    return {
        "wall_s": wall_s, "headline_s": headline_s, "section_s": section_s,
        "value": result["value"],
        "per_strategy": {name: {k: entry.get(k) for k in (
            "req_per_s", "p50_ttft_ms", "concurrent_p50_ttft_ms",
            "sequential_req_per_s", "routing_accuracy", "orin_queries",
            "trace_p50_ttft_ms", "trace_p95_ttft_ms", "trace_ttft_n",
            "trace_p50_tbt_ms", "trace_p95_tbt_ms", "trace_tbt_n")}
            for name, entry in per.items()},
        "profile": result["profile"],
        "p50_ttft_ms": result["p50_ttft_ms"],
        "concurrent_p50_ttft_ms": result["concurrent_p50_ttft_ms"],
        "utilization": result["utilization"],
        "tiers": {name: {"phases": entry["phases"], "work": entry["work"],
                         "utilization": entry.get("utilization"),
                         "tick": entry["tick"]}
                  for name, entry in result["tiers"].items()},
        "budget": result["budget"],
        "trend": result["trend"],
        "long_context": result["long_context"],
        "orin_prefix": result["orin_prefix"],
        "continuous_batching": result["continuous_batching"],
        "speculative": result["speculative"], "quant": result["quant"],
        "flagship": result["flagship"], "spill": result["spill"],
        "spec_multiturn": result["spec_multiturn"],
        **{leg: result[leg] for leg in ("skew", "spec_phase", "mixed",
                                        "shared", "openloop", "chaos",
                                        "pressure", "replica",
                                        "perf_steering", "noisy",
                                        "elastic", "chaos2")},
        "tester_summary": summary,
        "admission": dict(admission, warmup_memory=audit.warmup),
    }, launches


def note_phase_times(phase_s: dict, t_all: float) -> None:
    """Each phase's wall seconds so far, written to the report directory
    as they come (a run cut short still tells where its time went)."""
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "phase_times.json"), "w") as f:
        json.dump({**phase_s, "elapsed_s": time.perf_counter() - t_all}, f,
                  indent=1)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(REPO, "distributed_llm_tpu_torch")):
        fail("run from the root of a checkout: distributed_llm_tpu_torch/ "
             "is missing")
    sys.path.insert(0, REPO)
    t_all = time.perf_counter()

    # 1. Environment.
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"card: {card}")
    from distributed_llm_tpu_torch.utils import roofline
    peaks = roofline.chip_peaks("cuda")
    require(peaks is not None, f"no published peaks for {card} in "
            "distributed_llm_tpu_torch/utils/roofline.py's CARD_PEAKS")
    PEAKS.update(peaks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. Build.
    from distributed_llm_tpu_torch.config import ClusterConfig
    from distributed_llm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        with open(path + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln
                           or "spill" in ln]
    log(f"built {sorted(paths)} in {build_s:.1f}s")
    phase_s = {"build": build_s}
    lap = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - lap[0]
        lap[0] = now
        note_phase_times(phase_s, t_all)

    cluster = ClusterConfig()
    nano, orin = cluster.nano, cluster.orin
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    if only:
        # A debugging run: only the named late phases, no kernel table and
        # no last line.
        os.makedirs(REPORT_DIR, exist_ok=True)
        for name in only[0]:
            t0 = time.perf_counter()
            numbers = LATE_PHASES[name](torch, nano, orin)[0]
            with open(os.path.join(REPORT_DIR, f"only_{name}.json"),
                      "w") as f:
                json.dump(numbers, f, indent=1, default=str)
            log(json.dumps({name: (leg_summary(numbers) if name in (
                "legs", "bench") else w8_summary(numbers) if name == "w8"
                else serve_summary(numbers) if name in ("orin_w8",
                                                        "orin_spec_bf16")
                else fleet_summary(numbers)
                if name == "fleet" else fleet2_summary(numbers)
                if name == "fleet2" else edges_summary(numbers)
                if name == "edges" else moe_summary(numbers)
                if name == "moe" else tp_summary(numbers)
                if name == "tp" else sp_ep_summary(numbers)
                if name == "sp_ep" else train_mesh_summary(numbers)
                if name == "train_mesh" else numbers), "card": card,
                "wall_s": time.perf_counter() - t0}, default=str))
        return

    # 3. Kernels.  First the floor of a graph-replayed time: a graph of one
    # and of two kernels that touch 4 bytes, timed as the rows are.
    tiny = torch.zeros(1, device="cuda")
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    graph_floor_ms = {n: graph_ms(torch, lambda n=n: [tiny.add_(1)
                                                      for _ in range(n)],
                                  flush=flush_buf.zero_) for n in (1, 2)}
    del tiny, flush_buf
    log(f"graph-replay floor (1, 2 kernels): {graph_floor_ms} ms")
    rows = kernel_phase(torch, nano.model(), orin.model(), nano.kv_block_size)
    spec_rows, draft_shape = spec_kernel_phase(
        torch, orin.model(), nano.model(), orin.kv_block_size,
        orin.decode_batch)
    rows[0]["draft_shape"] = draft_shape
    rows += spec_rows
    rows += paged_decode_kernel_phase(torch, nano.model(), orin.model())
    rows += contiguous_kernel_phase(torch, nano.model(), orin.model())
    rows.append(w8_kernel_phase(torch, nano.model(), orin.model()))
    log(f"kernels checked in {time.perf_counter() - t_all:.1f}s")
    mark("kernels")

    # 4-6. Serve: nano; orin with bf16 KV and the nano_1b draft; orin with
    # int8 KV drafting with itself.
    phases = {}
    phases["nano"], nano_launches = serve_phase(
        torch, nano, lengths=(4, 20, 45, 80, 120, 160, 200, 240),
        expect=("ragged_decode", "flash_causal", "paged_chunk"), repeat=True)
    log(f"nano served in {time.perf_counter() - t_all:.1f}s")
    mark("nano")
    orin_lengths = ORIN_LENGTHS
    phases["orin_spec_bf16"], spec_launches = LATE_PHASES["orin_spec_bf16"](
        torch, nano, orin)
    log(f"orin (bf16 KV, nano_1b draft) served in "
        f"{time.perf_counter() - t_all:.1f}s")
    mark("orin_spec_bf16")
    phases["orin_spec_int8"], int8_launches = serve_phase(
        torch, dataclasses.replace(orin, draft_preset=orin.model_preset,
                                   kv_quantize="int8"),
        lengths=orin_lengths, sampled=True,
        expect=("flash_causal", "ragged_decode_q8", "ragged_verify_q8"))
    require(phases["orin_spec_int8"]["int8_chunk_calls"] > 0,
            "the int8 suffix chunk did not run")
    log(f"orin (int8 KV, self-draft) served in "
        f"{time.perf_counter() - t_all:.1f}s")
    mark("orin_spec_int8")
    # 6b. orin_8b with int8 weights and the nano_1b draft (int8 weights
    # too): the decode, verify and draft rows through W1.
    phases["orin_w8"], w8_launches = LATE_PHASES["orin_w8"](torch, nano,
                                                             orin)
    log(f"orin (int8 weights, nano_1b draft) served in "
        f"{time.perf_counter() - t_all:.1f}s")
    log(json.dumps({"chunked_ttft_ms": {
        p: phases[p]["chunked_ttft_ms"] for p in ("orin_spec_bf16",
                                                  "orin_w8")}}))
    mark("orin_w8")

    # 7-9b. Serve the sequential engines (decode_batch=1): orin_8b with
    # bf16 KV; orin_8b with the nano_1b draft; nano_1b with int8 KV;
    # nano_1b with int8 weights (W1 at one row).
    seq_launches = {}
    for name in SEQ_PHASES:
        phases[name], seq_launches[name] = LATE_PHASES[name](torch, nano,
                                                             orin)
        log(f"{name} served in {time.perf_counter() - t_all:.1f}s")
        mark(name)

    # 10. The two-tier /chat service on the dense windowed tick: nano_1b
    # (bf16 pool) and orin_8b (int8 pool) behind the Router, every
    # routing strategy.
    chat, chat_launches = chat_phase(
        torch, chat_cluster(nano, orin),
        expect=("flash_causal", "paged_chunk", "paged_decode",
                "paged_decode_q8"))
    log(f"/chat served in {time.perf_counter() - t_all:.1f}s")
    mark("chat")

    # 11. The bench: the headline over the bench cluster (nano_1b and
    # orin_8b with int8 weights on the ragged tick) with its features and
    # flagship sections, then the canonical tester.
    bench, bench_launches = bench_phase(torch)
    log(f"bench run in {time.perf_counter() - t_all:.1f}s")
    mark("bench")

    # 12-13. The constrained pool (nano_1b, then orin_8b int8 with the
    # nano_1b draft) and the host spill tier (nano_1b).
    late = {}
    late_launches = {}
    # 14-15. The trained tiny tiers behind /chat; the bench's engine legs
    # and the open-loop leg at full width.
    # 16. The fleet: chaos on the bench cluster, a crashed replica rescued,
    # the replica leg at nano_1b's width.
    # 17. The fleet's second half: tenants on the bench cluster, elastic
    # membership and chaos2 on nano_1b, a remote nano tier.
    # 18. The edges: the reference-style program, the REPL and python -m
    # in child processes, the testers and the analysis, the host loops,
    # the encoder's training, tune and the kernel A/B.
    # 19. MoE: moe_8x1b served four ways.  20. Training: K2's Function,
    # nano_1b pretrained, saved, served and scored; nano_test and moe_test
    # learning.
    # 21. Tensor parallelism over a group of the card repeated: the
    # flagship's orin at tp=4 and orin_8b int8 at tp=2 (batched), orin_8b
    # at tp=4 (sequential), each against tp=1; the bench's multichip
    # section; the health exchange over a Router's health_mesh.
    # 22. Sequence and expert parallelism over groups of the card
    # repeated: orin_8b at sp=4 and sp=2 x tp=2 (sequential), moe_8x1b at
    # ep=4 (batched and sequential) and tp=2 (int8 pool), each against
    # the unsharded tier; the capacity check for sp and ep.
    # 23. Training over groups of the card repeated: nano_1b over
    # training_mesh (tp=4) and (dp, sp, tp) = (2, 2, 2), the pipeline at
    # pp=2, moe_8x1b (4 layers) at ep=8, each against the unsharded
    # trainer and float32; a checkpoint moved between groups.
    # 24. The port's lint over its tree, beside the steady ticks of the
    # batched nano_1b watched for syncs outside _fetch_tick.
    for name in ("pressure_nano", "pressure_orin", "spill", "trained_chat",
                 "legs", "fleet", "fleet2", "edges", "moe", "train", "tp",
                 "sp_ep", "train_mesh", "lint"):
        late[name], late_launches[name] = LATE_PHASES[name](torch, nano, orin)
        log(f"{name} run in {time.perf_counter() - t_all:.1f}s")
        mark(name)
    by_phase = {"nano": nano_launches, "orin_spec_bf16": spec_launches,
                "orin_spec_int8": int8_launches, "orin_w8": w8_launches,
                **seq_launches, "chat": chat_launches,
                "bench": bench_launches, **late_launches}
    for row in rows:
        row["launches_by_phase"] = {p: n[row["name"]]
                                    for p, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        row["kernel_ms"] = row["ms"]
        # Phases 21-23's launches by part and group slot.
        row["launches_by_shard"] = {
            part: {s: n.get(row["name"])
                   for s, n in (r.get("launches_by_shard")
                                or r["launches_by_slot"]).items()
                   if n.get(row["name"])}
            for part, r in [*late["tp"].items(), *late["sp_ep"].items(),
                            *late["train_mesh"].items()]
            if "launches_by_shard" in r or "launches_by_slot" in r}
        row["launches_by_shard"] = {p: v for p, v in
                                    row["launches_by_shard"].items() if v}
    require(all(row["launches"] > 0 for row in rows),
            "a kernel never launched on a main path")
    # K11's two routes are one kernel; each must have run on a main path
    # (the sequential speculative verify takes the split route, the long
    # prompt's 2048-row chunks the tensor-core route).
    chunk_routes = {p: phases[p]["flash_chunk_routes"]
                    for p in ("orin_seq_bf16", "orin_seq_spec")}
    require(all(sum(r[k] for r in chunk_routes.values()) > 0
                for k in ("split", "tc")),
            f"a route of flash_chunk never ran on a main path: {chunk_routes}")
    next(row for row in rows
         if row["name"] == "flash_chunk")["launches_by_route"] = chunk_routes
    # W1's two regimes are one kernel: each must have run on the main
    # paths, and the sequential int8-weight tier's long prompt takes the
    # wide one as orin_w8's does (no cast route ran: read_counts).
    require(all(phases["nano_seq_w8"]["w8_routes"].values()),
            f"nano_seq_w8: a regime of W1 never ran: "
            f"{phases['nano_seq_w8']['w8_routes']}")
    require(all(W8_ROUTES.values()),
            f"a regime of w8_matmul never ran on a main path: {W8_ROUTES}")
    w8_row = next(row for row in rows if row["name"] == "w8_matmul")
    w8_row["launches_by_route"] = dict(W8_ROUTES)
    # A served decode step's W1 launches: one a layer's q/k/v, wo,
    # gate/up and down each (orin_w8 batched, nano_seq_w8 sequential).
    for model, phase in (("orin_8b", "orin_w8"), ("nano_1b", "nano_seq_w8")):
        step = w8_row["decode_step_products"][model]
        step["launches_per_served_step"] = (
            phases[phase]["decode_step"] or {}).get("w8_launches")
        require(step["launches_per_served_step"] == step["launches_per_step"],
                f"{phase}: W1 launched {step['launches_per_served_step']} "
                f"times a decode step, not {step['launches_per_step']}")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "graph_floor_ms": graph_floor_ms,
              "kernels": rows, "serve": phases, "chat": chat,
              "bench": bench, **late, "phase_s": phase_s,
              "total_s": time.perf_counter() - t_all}
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "rel_err", "plain_rel_err", "tol", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "eager", "shape",
            "variants_max_abs_err", "variants_rel_err")
    summary = {}
    for name, serve in phases.items():
        summary[name] = {k: serve[k] for k in (
            "model", "engine", "draft", "quantize", "kv_quantize", "requests",
            "launches_per_request", "int8_chunk_calls", "cold_ttft_ms",
            "chunked_ttft_ms", "w8_routes", "flash_chunk_routes",
            "tick_stats", "spec",
            "decode_step", "tick_graph_check", "prefill_graph_check",
            "seq_graph_check", "copies", "programs", "grow",
            "first_use_check", "loop_vs_round", "admission", "verify_step",
            "decode_logits_check", "verify_check", "peak_memory_gb")
            if k in serve}
        summary[name]["concurrent"] = {
            k: serve["concurrent"][k] for k in ("requests", "gen_tokens",
                                                "tokens_per_s", "p50_ttft_ms")}
    log(json.dumps({"card": card, "serve": summary,
                    "graph_floor_ms": graph_floor_ms,
                    "total_s": report["total_s"]}))
    log(json.dumps({"chat": {
        "startup_s": chat["startup_s"], "main_path_s": chat["main_path_s"],
        "by_strategy": {st: {k: v[k] for k in (
            "requests", "burst_req_per_s", "p50_stream_ttft_ms", "nano",
            "orin", "p50_routing_overhead_ms")}
            for st, v in chat["by_strategy"].items()},
        "int8_chunk_calls": chat["int8_chunk_calls"],
        "tiers": chat["tiers"],
        "tick_graph_check": chat["tick_graph_check"],
        "prefill_graph_check": chat["prefill_graph_check"],
        "admission": chat["admission"],
        "dense_logits_check": chat["dense_logits_check"],
        "routing_device_check": chat["routing_device_check"],
        "peak_memory_gb": chat["peak_memory_gb"]}}))
    log(json.dumps({"chat_obs": {
        "metrics": {k: chat["obs"][k] for k in ("requests", "ttft_n",
                                                "trace_events", "slo",
                                                "cost_rows",
                                                "flight_recorded_total")},
        "tiers": {n: {k: t[k] for k in ("coverage", "ticks",
                                        "attribution_ratio",
                                        "attributed_device_ms",
                                        "decode_self_ms", "phases")}
                  for n, t in chat["obs"]["tiers"].items()},
        "profiler_overhead": {n: {m: {k: v[k] for k in ("tick_p50_ms",
                                                        "wall_per_tick_ms")}
                                  for m, v in t.items()}
                              for n, t in chat["profiler_overhead"].items()},
        "hbm_budget": chat["hbm_budget"]}}))
    log(json.dumps({"per_kernel_capture": chat["per_kernel_capture"]}))
    log(json.dumps({"bench": {
        "wall_s": bench["wall_s"], "section_s": bench["section_s"],
        "value": bench["value"],
        "by_strategy": {st: {k: v[k] for k in ("req_per_s", "p50_ttft_ms",
                                               "concurrent_p50_ttft_ms")}
                        for st, v in bench["per_strategy"].items()},
        "utilization": bench["utilization"],
        "trend_req_per_s": bench["trend"]["trend_req_per_s"],
        "trace_columns": {st: {k: v.get(k) for k in (
            "trace_p50_ttft_ms", "trace_p95_ttft_ms", "trace_ttft_n",
            "trace_p50_tbt_ms")} for st, v in bench["per_strategy"].items()},
        "profile": {k: bench["profile"].get(k) for k in (
            "coverage", "attribution_ratio", "trace_events", "requests",
            "trace_schema_ok")},
        "speculative": bench["speculative"], "quant": bench["quant"],
        "flagship": bench["flagship"],
        "spec_multiturn": bench["spec_multiturn"],
        "spill": {k: bench["spill"].get(k) for k in (
            "warm_hit_rate", "hit_rate_monotone", "tbt_ratio",
            "outputs_identical", "race")}
        | {m: {k: bench["spill"][m].get(k) for k in (
            "warm_hit_rate", "promotions", "demotions_total",
            "revisit_ttft_p50_ms")} for m in ("off", "small", "large")},
        "fleet_legs": {
            "chaos": {s: {k: bench["chaos"][s][k] for k in (
                "requests", "availability", "mttr_s",
                "p50_ttft_ms_under_faults", "breaker_opened")}
                for s in ("heuristic", "hybrid", "perf")},
            "pressure": {k: bench["pressure"][k] for k in (
                "replay_identity", "load", "drain")},
            "replica": {k: bench["replica"].get(k) for k in (
                "closed_loop_speedup", "speedup_ok",
                "affinity_hit_retention", "random_hit_retention",
                "dilution_resident_ratio", "outputs_identical", "flips")},
            "perf_steering": bench["perf_steering"]["verdict"],
            "noisy": {k: bench["noisy"].get(k) for k in (
                "quiet_p95_ratio", "flood_shed_precision",
                "outputs_identical")},
            "elastic": {k: bench["elastic"].get(k) for k in (
                "goodput_per_replica_s", "gprs_vs_max", "goodput_vs_max",
                "scale_events", "flap_count", "outputs_identical")},
            "chaos2": {k: bench["chaos2"].get(k) for k in (
                "availability", "rescue_mttr_ms", "failovers",
                "outputs_identical", "warm_hit")}},
        "admission": bench["admission"]}}))
    log(json.dumps({"card": card, "pressure": {
        name: {k: late[name][k] for k in (
            "model", "draft", "quantize", "kv_quantize", "slots",
            "pool_blocks", "full_residency_blocks", "requests",
            "preempted", "preempted_in_spec_growth", "prefill_cancelled",
            "preempt_counts", "tokens_identical", "near_ties",
            "near_tie_bound", "tokens_per_s", "p50_ttft_ms", "main_path_s")}
        | {"replay_ms": [round(ep["ms"], 3) for ep in late[name]["replays"]],
           "replay_chunked": [ep["chunked"] for ep in late[name]["replays"]],
           "tick_replay_ms": late[name]["tick_graph_check"].get(
               "tick_replay_ms")}
        for name in ("pressure_nano", "pressure_orin")}}))
    sp = late["spill"]
    log(json.dumps({"card": card, "spill": {
        "warm_hit_rate": {m: sp[m]["warm_hit_rate"]
                          for m in ("off", "small", "large")},
        "served": {m: sp[m]["served"] for m in ("off", "small", "large")},
        "promoted_ttft_p50_ms": sp["promoted_ttft_p50_ms"],
        "cold_ttft_p50_ms": sp["cold_ttft_p50_ms"],
        "revisit_ttft_p50_ms": {m: sp[m]["revisit_ttft_p50_ms"]
                                for m in ("off", "small", "large")},
        "tbt_ratio": sp.get("tbt_ratio"),
        "cotenant_tbt_p95_ms": {m: sp[m]["cotenant_tbt_p95_ms"]
                                for m in ("off", "large")},
        "demotions": sp["large"]["demotions_total"],
        "promotions": sp["large"]["promotions"],
        "host_bytes": sp["host_bytes_large"],
        "outputs_identical": sp["outputs_identical"], "race": sp["race"],
        "spill_copies": sp["admission"]["spill_copies"],
        "wall_s": sp["wall_s"]}}))
    tc = late["trained_chat"]
    log(json.dumps({"card": card, "trained_chat": {
        k: tc[k] for k in ("cluster", "turns", "startup_s", "main_path_s")}}))
    log(json.dumps({"card": card, "legs": leg_summary(late["legs"]),
                    "bench_legs": leg_summary(bench)}))
    log(json.dumps({"card": card, "fleet": fleet_summary(late["fleet"])}))
    log(json.dumps({"card": card, "fleet2": fleet2_summary(late["fleet2"])},
                   default=str))
    log(json.dumps({"card": card, "edges": edges_summary(late["edges"])},
                   default=str))
    log(json.dumps({"card": card, "moe": moe_summary(late["moe"])},
                   default=str))
    tr = late["train"]
    log(json.dumps({"card": card, "train": {
        "k2_grad": tr["k2_grad"],
        "nano_1b": {k: tr["nano_1b"][k] for k in (
            "steps", "losses", "steady_ms_per_step", "tokens_per_s",
            "peak_memory_gb")},
        "served": tr["served"], "eval": tr["eval"],
        **{p: tr[p] for p in TRAIN_TINY_STEPS}}}, default=str))
    log(json.dumps({"card": card, "tp": tp_summary(late["tp"])},
                   default=str))
    log(json.dumps({"card": card, "sp_ep": sp_ep_summary(late["sp_ep"])},
                   default=str))
    log(json.dumps({"card": card, "train_mesh": train_mesh_summary(
        late["train_mesh"])}, default=str))
    log(json.dumps({"card": card, "lint": {
        k: late["lint"][k] for k in ("lint", "sync_watch")}}))
    log(json.dumps({"card": card, "phase_s": phase_s,
                    "total_s": report["total_s"]}))
    log(f"{card}")
    log(json.dumps({"kernels": [{**{k: row[k] for k in keys},
                                 **{k: row[k] for k in (
                                     "one_tile_short_rel_err", "short",
                                     "launches_by_route", "launches_by_shard",
                                     "cublas_bf16_ms",
                                     "library_rel_err", "wide",
                                     "decode_step_products")
                                    if k in row}} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
