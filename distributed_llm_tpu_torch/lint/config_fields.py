"""The port's copy of the JAX package's config one-liners.

The config-drift checker holds every ``TierConfig``/``ClusterConfig``
field of the port's ``config.py`` against this table, both ways.  The
table is the JAX package's ``CONFIG_FIELDS``
(``distributed_llm_tpu/config_registry.py``), copied, because the port
imports nothing of the JAX package; the full rationale of each field
lives at its declaration in the port's ``config.py``.

``ENV_VARS`` is empty: the port reads no ``DLLM_*`` environment
variable, so every such read is a ``config-env-unregistered`` finding.
"""

from __future__ import annotations

from typing import Dict

# The port has no env knobs: what JAX reads from ``DLLM_*`` the port
# takes as an argument (ROADMAP.md, section C).
ENV_VARS: Dict[str, object] = {}

CONFIG_FIELDS: Dict[str, str] = {
    'TierConfig.name': "Tier identity ('nano' | 'orin' | ...).",
    'TierConfig.model_preset':
        "Key into MODEL_PRESETS for this tier's architecture.",
    'TierConfig.tp': 'Tensor-parallel degree (submesh size).',
    'TierConfig.sp':
        'Sequence-parallel degree for prefill (ring attention over the '
        "'sp' axis; dense only).",
    'TierConfig.ep':
        'Expert-parallel degree for MoE tiers (whole experts sharded '
        "over 'ep').",
    'TierConfig.hbm_gb_per_chip':
        'Per-chip HBM budget (GB): when set, start_server eval_shape-'
        'budgets params + KV against the deployed submesh and refuses '
        "cleanly (TierOverCapacityError) when it doesn't fit; None = no"
        ' admission budget.',
    'TierConfig.max_new_tokens':
        'Decode cap per request (reference num_predict).',
    'TierConfig.temperature':
        'Sampling temperature; 0 = greedy (reference default).',
    'TierConfig.prefill_buckets':
        'Padded prompt-length rungs, one compiled program each.',
    'TierConfig.decode_batch':
        '>1 serves through the continuous-batching engine with that '
        'many concurrent slots.',
    'TierConfig.kv_block_size':
        'Paged KV pool block granularity (engine/paged_kv.py).',
    'TierConfig.decode_steps_per_tick':
        'Sequential decode steps fused into one device call per tick.',
    'TierConfig.attention_ragged':
        'Batched decode tick runs ONE fused ragged paged-attention call'
        ' over full block tables with per-slot lengths (no bucketed '
        'window rungs); qualifying TP meshes run it under shard_map '
        'over the kv-head axis.',
    'TierConfig.prefill_chunk_tokens':
        'Cold prompts past one chunk prefill in fixed chunks of this '
        'many tokens interleaved with decode ticks (multiple of '
        'kv_block_size); 0/None = monolithic one-shot prefill.',
    'TierConfig.prefill_chunk_budget':
        'Prefill tokens one scheduler tick may spend advancing the in-'
        'flight prefill (whole chunks); None = one chunk per tick.',
    'TierConfig.admission_max_queue':
        'Max requests waiting beyond the slots before fail-fast; None '
        'disables admission control.',
    'TierConfig.kv_admission':
        'Gate admission on projected KV block demand vs free + '
        'reclaimable parked blocks; False = slot/queue admission only.',
    'TierConfig.kv_pool_blocks':
        'Paged KV pool size override in blocks; None = full per-slot '
        'residency (no pressure possible).',
    'TierConfig.overflow_policy':
        "Over-length prompt policy at the router: 'reject' fails fast, "
        "'truncate_left' drops oldest turns (surfaced in the response).",
    'TierConfig.drain_timeout_s':
        'Graceful-drain deadline: in-flight requests get this long to '
        'finish after admission stops.',
    'TierConfig.checkpoint_path':
        'Checkpoint dir to serve trained weights from; None = deterministic '
        'random init.',
    'TierConfig.draft_preset':
        'Draft model preset for speculative decoding; None = plain '
        'decoding.',
    'TierConfig.speculative_gamma':
        'Draft tokens proposed per speculative round (sequential '
        'decode_batch=1 engine).',
    'TierConfig.spec_decode':
        'Batched speculative decoding on the ragged paged kernel '
        '(decode_batch>1 + draft_preset): per-slot drafts verified in '
        'ONE fused ragged_verify call, greedy acceptance, rejected-tail'
        ' frontier rewind; byte-identical greedy outputs. Tri-state: '
        'None=AUTO (EngineManager arms it on batched draft tiers), '
        'True=force on, False=operator kill switch (draft tier serves '
        'plain batched decode).',
    'TierConfig.spec_gamma_max':
        'Per-slot adaptive γ cap for batched speculation: slots start '
        'here, an acceptance EWMA scales each down (γ=0 = plain ragged '
        'decode); the compiled draft/verify family is the power-of-two '
        'bucket ladder up to it.',
    'TierConfig.enable_prefix_cache':
        "Park finished requests' KV for suffix-only re-prefill (multi-"
        'turn chats).',
    'TierConfig.prefix_cache_entries':
        'Parked KV prefixes kept per tier (each pins HBM).',
    'TierConfig.share_prefix_kv':
        'Prefix-cache hits on batched paged engines map the parked '
        'blocks read-only into N concurrent slots (refcounted, copy-on-'
        'write at the boundary block) instead of taking exclusive '
        'ownership; False restores one-live-session-per-prefix.',
    'TierConfig.host_kv_bytes':
        'Host-RAM byte budget of the hierarchical KV spill tier '
        '(demoted prefix-cache entries; async copies off the tick '
        'path); 0/None disables it.',
    'TierConfig.host_kv_promote_share':
        'Fraction of the per-tick chunked-prefill budget promotion '
        'host→device grants may spend (floored at one block per tick).',
    'TierConfig.host_kv_copier_depth':
        'Spill copier queue depth (pending demote snapshots); a full '
        'queue drops further demotions instead of backing up the '
        'scheduler.',
    'TierConfig.quantize':
        "Weight-only serving quantization ('none' | 'int8').",
    'TierConfig.kv_quantize':
        "KV-cache quantization ('none' | 'int8'); dense family only.",
    'TierConfig.endpoint':
        'Base URL of a cross-host gpu_api server; set = no local engine'
        ' is built.',
    'TierConfig.spawn_cmd':
        'Supervisor argv that (re)starts the remote tier process (must '
        'kill-then-start).',
    'TierConfig.request_timeout_s':
        'Per-request wall cap; past it the reference error shape '
        'returns and the worker is abandoned.',
    'TierConfig.slo_ttft_ms':
        'TTFT SLO target (ms) for the goodput monitor; None disables '
        'the criterion.',
    'TierConfig.slo_tbt_ms':
        'Per-request p95 time-between-tokens SLO target (ms); None '
        'disables the criterion.',
    'TierConfig.watchdog_stall_s':
        'Decode-watchdog deadline: pending work with no step progress '
        'for this long reads as wedged.',
    'TierConfig.replicas':
        '>1 gives the tier that many data-parallel engine replicas (own'
        ' queue/breaker/watchdog/drain each; health and KV stats '
        'aggregate with per-replica breakdown).',
    'TierConfig.replica_affinity':
        'Route requests to the replica already holding their parked KV '
        'prefix (select_reuse matching); False = pure least-loaded '
        'dispatch.',
    'TierConfig.replica_affinity_min_tokens':
        'Minimum parked-prefix token match that binds a request to a '
        'replica.',
    'TierConfig.replica_affinity_override_s':
        "Affinity yields to least-loaded when the affine replica's "
        "predicted queue wait exceeds the best replica's by more than "
        'this many seconds.',
    'TierConfig.tenant_quotas':
        'Per-tenant isolation budgets (tenant name → TenantQuota): '
        'admission caps, a device-time-rate token bucket billed from '
        'measured cost, DWRR weights, resident-KV block budgets at '
        '1/refcount, and speculative γ caps; None = quotas OFF (byte-'
        'identical pre-tenant behavior).',
    'TierConfig.autoscale':
        'Arms the per-tier SLO-driven replica autoscaler '
        '(serving/autoscaler.py); False = static membership, byte-'
        'identical to the replicated-tier path (pinned).  '
        'Router(autoscale=False) disarms every tier.',
    'TierConfig.autoscale_min_replicas':
        'Membership floor the autoscaler never scales below (also the '
        'initial size when larger than replicas).',
    'TierConfig.autoscale_max_replicas':
        'Membership ceiling the autoscaler never scales above.',
    'TierConfig.autoscale_interval_s':
        'Controller cadence: one signal read + decision per interval.',
    'TierConfig.autoscale_goodput_floor':
        'Scale-up trigger: windowed SLO goodput sustained below this '
        'fraction breaches.',
    'TierConfig.autoscale_queue_high':
        'Scale-up trigger: queue depth sustained above this many '
        'requests per live replica breaches.',
    'TierConfig.autoscale_breach_window_s':
        'How long a breach must persist before scale-up fires '
        '(hysteresis).',
    'TierConfig.autoscale_idle_window_s':
        'How long the tier must be fully idle before scale-down fires.',
    'TierConfig.autoscale_up_cooldown_s':
        'Minimum seconds after any membership event before the next '
        'scale-up.',
    'TierConfig.autoscale_down_cooldown_s':
        'Minimum seconds after any membership event before the next '
        'scale-down.',
    'TierConfig.autoscale_warm_pool':
        'True pre-warms min..max standby replicas at tier start and '
        'parks drained replicas, so scale-up publishes a warm standby '
        'in milliseconds; False builds/destroys engines at actuation '
        'time.',
    'TierConfig.replica_rescue':
        'Crash rescue: a replica restart captures its queued + in-'
        'flight requests and re-dispatches them to a sibling (or '
        'requeues on the restarted engine), resuming byte-identically '
        'under greedy; False fails them with the engine-stopped shape.',
    'TierConfig.spill_survive_restart':
        'Host KV spill store outlives a replica restart and re-attaches'
        ' to the rebuilt engine (or hands entries to a survivor), so '
        'restart cost is warm-TTFT promotion, not cold prefill; False '
        'stops the store with the engine.',
    'ClusterConfig.nano': "The weak/cheap tier's TierConfig.",
    'ClusterConfig.orin': "The strong/costly tier's TierConfig.",
    'ClusterConfig.seed': 'Deterministic init seed shared by both tiers.',
    'ClusterConfig.breaker_failures':
        "Consecutive error-shaped results that open a tier's circuit; 0"
        ' disables the breaker.',
    'ClusterConfig.breaker_cooldown_s':
        'Open-circuit cooldown before a half-open canary.',
    'ClusterConfig.retry_attempts':
        'Bounded same-tier retries for transient error shapes.',
    'ClusterConfig.retry_backoff_s':
        'Initial jittered backoff between transient retries.',
}
