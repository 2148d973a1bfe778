"""The bench's second fleet legs: ``noisy``, ``elastic`` and ``chaos2``.

Counterparts of the root ``bench.py``'s ``noisy_neighbor_phase`` (:1047),
``elastic_phase`` (:2675, with ``_elastic_handoff_subcheck`` :2591) and
``chaos2_phase`` (:3052), with their keys, budgets and verdicts:

- ``noisy_phase``: a flooding tenant (closed loop, no think time) beside
  a quiet tenant, tenant quotas OFF and ON at one seed: the quiet tenant's
  p95 solo and under flood (``quiet_p95_ratio``), and the share of tenant
  refusals that land on the flooder (``flood_shed_precision``).  HARD:
  sequential greedy probes through a quotas-off and a non-binding
  quotas-on engine give the same token ids;
- ``elastic_phase``: one seeded diurnal ramp (bench/scenarios.py)
  replayed through the Router and the ``/chat`` edge under static-min (1
  replica), static-max (2) and the autoscaler in [1, 2]:
  goodput per replica-second.  HARD: the flap bound (no up-down-up inside
  one cooldown, at most 4 effective events on the ramp's two
  inflections) and the scale-down handoff sub-check (2 -> 1 with the
  victim's parked prefixes demoted and handed to the survivor, the same
  answers after, one ragged decode program per replica minted
  mid-flight);
- ``chaos2_phase``: the ramp against 2 autoscale-armed replicas with the
  HealthMonitor in the loop while a fault actor kills a replica's
  scheduler loop twice mid-ramp: availability >= 0.99, no cross-tier
  failover, ``rescue_mttr_ms``; then ``fleet._chaos2_rescue_subcheck``.

Each serves JAX's pinned tiny configuration by default; ``cluster``
(noisy, chaos2) or ``tier`` (elastic, chaos2) serves another, as
chip_smoke does at full width, and ``device`` runs it on the CPU here.
On one card the replicas share the device (``single_device``): replica
seconds are a cost account there, not added throughput.  Greedy outputs
compared across two modes may flip at a near-tie in bf16 on the card:
with ``tie_check`` (chip_smoke's ``near_tie``) each flip is judged and
listed under ``flips``; the noisy leg's quotas-off/on probes run the same
batch composition on the same kernels and are held equal outright.

JAX's noisy leg reads its "p95" with ``_pct(values, 95)``, which the
nearest-rank rule clamps to the maximum; the port reads the 0.95
quantile.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import threading
import time
from typing import Callable, Optional

from .fleet import _TokenLog, _chaos2_rescue_subcheck, _mttr_s
from .legs import _flips, _pct

def noisy_phase(load_s: float = 2.5, beat=lambda: None, device=None,
                cluster=None) -> dict:
    """The noisy-neighbor leg.  The flooder gets ``max_inflight=1,
    max_queued=0, weight=0.25`` on BOTH tiers (failover cannot launder
    the flood); the quiet tenant rides the default (unlimited) quota.
    ``cluster``: default JAX's tiny batched tiers at 2+2 slots, 48-token
    generations, speculation off."""
    from ..config import TenantQuota, tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine
    from ..serving.router import Router

    print("[bench] noisy-neighbor leg", file=sys.stderr, flush=True)
    flood_quota = {"flood": TenantQuota(weight=0.25, max_inflight=1,
                                        max_queued=0)}
    if cluster is None:
        # 2+2 slots and 48-token generations: the closed-loop flood
        # saturates the quotas-off cluster.  Speculation off: the leg
        # isolates admission and scheduling.
        base = tiny_batched_cluster(nano_slots=2, orin_slots=2)
        base = dataclasses.replace(
            base,
            nano=dataclasses.replace(base.nano, max_new_tokens=48,
                                     spec_gamma_max=0),
            orin=dataclasses.replace(base.orin, max_new_tokens=48,
                                     spec_gamma_max=0))
    else:
        base = cluster
    on_cluster = dataclasses.replace(
        base,
        nano=dataclasses.replace(base.nano, tenant_quotas=flood_quota),
        orin=dataclasses.replace(base.orin, tenant_quotas=flood_quota))
    out: dict = {"load_s": load_s,
                 "flood_quota": "max_inflight=1 max_queued=0 weight=0.25"}

    # -- identity sub-check (deterministic, sequential) -------------------
    probes = (("quiet", "tell me about rivers and lakes and streams "
                        "and oceans please"),
              ("flood", "what is the tallest mountain on the continent "
                        "of asia today"))
    ids: dict = {}
    for mode, tier in (("off", base.nano), ("on", on_cluster.nano)):
        eng = ContinuousBatchingEngine(tier, seed=1, device=device)
        try:
            ids[mode] = [tuple(eng.generate(q, tenant=t).token_ids)
                         for t, q in probes]
        finally:
            eng.stop()
        beat()
    out["outputs_identical"] = ids["off"] == ids["on"]
    if not out["outputs_identical"]:
        out["error"] = ("quotas on/off outputs diverged for completed "
                        "requests: the quotas-off identity contract is "
                        "broken")

    def run_mode(mode_cluster, flood: bool) -> dict:
        router = Router(strategy="heuristic", benchmark_mode=True,
                        cluster=mode_cluster, device=device)
        lat: dict = {"quiet": [], "flood": []}
        served: dict = {"quiet": 0, "flood": 0}
        tenant_rej: dict = {"quiet": 0, "flood": 0}
        other_err: dict = {"quiet": 0, "flood": 0}
        try:
            for tc in router.tiers.values():
                tc.server_manager.start_server()
                beat()
            router.route_query([{"role": "user",
                                 "content": "noisy warmup turn about "
                                            "rivers and mountains"}])
            beat()
            state = {"until": 0.0, "record": False}

            def client(tenant, i, think_s):
                turn = 0
                content = (f"flood client {i}: quick question about "
                           f"rocks and sand, variant {i}"
                           if tenant == "flood" else
                           f"quiet client {i}: short question about "
                           f"topic {i}")
                while time.monotonic() < state["until"]:
                    t0 = time.perf_counter()
                    try:
                        resp, _, _dev = router.route_query(
                            [{"role": "user",
                              "content": f"{content} turn {turn}"}],
                            tenant_id=tenant)
                    except BaseException:
                        other_err[tenant] += 1
                        break
                    dt = (time.perf_counter() - t0) * 1000.0
                    raw = resp.get("raw")
                    err = str(raw.get("error")
                              if isinstance(raw, dict) else "")
                    if resp.get("ok") or resp.get("degraded"):
                        if state["record"]:
                            served[tenant] += 1
                            lat[tenant].append(dt)
                    elif "tenant '" in err:
                        if state["record"]:
                            tenant_rej[tenant] += 1
                        hint = 0.25
                        try:
                            hint = float(raw.get("retry_after_s", hint))
                        except (TypeError, ValueError):
                            pass
                        # A shed client honors the retry hint, with
                        # per-client jitter against a synchronized herd.
                        time.sleep(min(max(hint, 0.05), 1.0)
                                   * (0.6 + 0.05 * i))
                    elif state["record"]:
                        other_err[tenant] += 1
                    turn += 1
                    if think_s:
                        time.sleep(think_s)

            def run_load(duration: float, record: bool) -> None:
                state["until"] = time.monotonic() + duration
                state["record"] = record
                threads = [threading.Thread(target=client,
                                            args=("quiet", i, 0.06),
                                            daemon=True) for i in range(2)]
                if flood:
                    threads += [threading.Thread(target=client,
                                                 args=("flood", i, 0.0),
                                                 daemon=True)
                                for i in range(16)]
                for t in threads:
                    t.start()
                deadline = time.monotonic() + duration + 60
                for t in threads:
                    t.join(timeout=max(0.0, deadline - time.monotonic()))
                beat()

            # An unrecorded pass of the exact workload first: every
            # first-use program is built before the clock starts, alike
            # in every mode.
            run_load(min(2.0, load_s), record=False)
            run_load(load_s, record=True)
            return {
                "quiet_served": served["quiet"],
                "flood_served": served["flood"],
                "quiet_p95_ms": (round(_pct(lat["quiet"], 0.95), 1)
                                 if lat["quiet"] else None),
                "flood_p95_ms": (round(_pct(lat["flood"], 0.95), 1)
                                 if lat["flood"] else None),
                "tenant_rejected": dict(tenant_rej),
                "other_errors": dict(other_err),
            }
        finally:
            for tc in router.tiers.values():
                tc.server_manager.stop_server()

    out["solo"] = run_mode(on_cluster, flood=False)
    out["off"] = run_mode(base, flood=True)
    out["on"] = run_mode(on_cluster, flood=True)

    solo_p95 = out["solo"].get("quiet_p95_ms")
    for mode in ("off", "on"):
        p95 = out[mode].get("quiet_p95_ms")
        if solo_p95 and p95:
            out[mode]["quiet_p95_ratio"] = round(p95 / solo_p95, 3)
    out["quiet_p95_ratio"] = out["on"].get("quiet_p95_ratio")
    rej = out["on"]["tenant_rejected"]
    total_rej = rej["quiet"] + rej["flood"]
    out["flood_shed_precision"] = (round(rej["flood"] / total_rej, 4)
                                   if total_rej else None)
    return out


def _decode_programs(client) -> dict:
    """Each live replica's ragged decode programs: the engine's program
    set and the ``dllm_compiled_programs{tier="nano/rN"}`` gauge."""
    from ..obs import get_observability
    programs: dict = {}
    for key, eng in client.server_manager.live_engines():
        programs[key] = {
            "compiled": len(eng._compiled.get("decode", ())),
            "gauge": get_observability().m.compiled_programs.labels(
                eng.tier.name, "decode").value}
    return programs


def _elastic_handoff_subcheck(base_cl, tier, beat=lambda: None,
                              device=None,
                              tie_check: Optional[Callable] = None) -> dict:
    """The deterministic scale-down check: a client scaled 1 -> 2 answers
    K sessions, scales down to 1 (the victim's sole-owner parked prefixes
    demoted through the host spill tier and handed to the survivor's
    store), then answers the SAME prompts again: the answers must match
    (scale-down costs warm TTFT, never correctness).  The replica minted
    by the scale-up must land with exactly one ragged decode program, its
    gauge agreeing.  With ``tie_check`` a divergence is judged
    (``flips``)."""
    from ..engine.paged_kv import pool_block_bytes
    from ..serving.replicas import ReplicatedTierClient

    blk = pool_block_bytes(tier.model(), tier.kv_block_size,
                           tier.kv_quantize)
    s_tier = dataclasses.replace(
        tier, replicas=1, enable_prefix_cache=True,
        prefix_cache_entries=8,
        # JAX's 16 on its 16-token blocks: one block a chunk.
        prefill_chunk_tokens=tier.kv_block_size,
        # Every demoted session fits: nothing limits the handoff.
        host_kv_bytes=blk * 64)
    prompts = [f"session {n} tell me about rivers in one short sentence"
               for n in ("alpha", "bravo", "charlie", "delta",
                         "echo", "foxtrot")]
    out: dict = {}
    tokens = _TokenLog()
    client = ReplicatedTierClient(
        s_tier, dataclasses.replace(base_cl, nano=s_tier), device=device,
        seed=base_cl.seed)
    try:
        client.server_manager.start_server()
        beat()
        up = client.scale_to(2, reason="subcheck")
        beat()
        out["scale_up_errors"] = [str(e)[:120] for e in up["errors"]]
        for _key, eng in client.server_manager.live_engines():
            tokens.watch(eng)
        programs = _decode_programs(client)
        out["decode_programs_per_replica"] = programs
        if s_tier.attention_ragged and any(
                p["compiled"] != 1
                or (p["gauge"] is not None and p["gauge"] != 1.0)
                for p in programs.values()):
            out["error"] = (f"scaled-up replica minted != 1 decode "
                            f"program: {programs}")
        pre = [client.process(p) for p in prompts]
        pre_ids = [tokens.ids.get(p) for p in prompts]
        beat()
        tokens.ids.clear()
        down = client.scale_to(1, reason="subcheck")
        beat()
        removed = (down.get("removed") or [{}])[0]
        out["victim"] = removed.get("replica")
        out["demoted_entries"] = removed.get("demoted_entries")
        out["handed_off"] = removed.get("handed_off")
        post = [client.process(p) for p in prompts]
        post_ids = [tokens.ids.get(p) for p in prompts]
        beat()
        pre_txt = [r.get("response") if isinstance(r, dict) else None
                   for r in pre]
        post_txt = [r.get("response") if isinstance(r, dict) else None
                    for r in post]
        out["identical"] = pre_txt == post_txt and None not in pre_txt
        near_ties = False
        if not out["identical"] and tie_check is not None:
            if None in pre_ids or None in post_ids:
                out["flips"] = [{"near_tie": False,
                                 "error": "token ids missing"}]
            else:
                out["flips"] = _flips(s_tier, prompts, pre_ids, post_ids,
                                      tie_check, base_cl.seed, device)
            near_ties = bool(out["flips"]) and all(
                f.get("near_tie") for f in out["flips"])
        if not out["identical"] and not near_ties and "error" not in out:
            out["error"] = ("scale-down changed answers: same prompts "
                            "diverged across the 2->1 transition")
    finally:
        client.server_manager.stop_server()
    return out


def elastic_phase(period_s: float = 20.0, beat=lambda: None, device=None,
                  cluster=None, tier=None,
                  tie_check: Optional[Callable] = None) -> dict:
    """The elastic-capacity leg: the same seeded diurnal ramp through the
    Router and the ``/chat`` edge under static-min, static-max and the
    autoscaler in [1, 2].  Headline: goodput per replica-second (the
    autoscaled run's replica-seconds integrated from its decision ledger,
    the static runs' count x wall); ``goodput_ok`` (at least 0.9 of
    static-max) and ``gprs_ok`` (strictly above static-max) are reported.
    ``cluster``: the two tiers (default JAX's tiny batched, nano at 2
    slots); ``tier``: the elastic nano tier (default the cluster's nano
    at 8 decode steps a tick, 48-token generations and a 64-deep
    admission queue, JAX's)."""
    from ..config import tiny_batched_cluster
    from ..obs import Observability
    from ..serving.app import create_app
    from ..serving.router import Router
    from .scenarios import diurnal_ramp, run_schedule, schedule, \
        total_duration_s

    print("[bench] elastic capacity leg", file=sys.stderr, flush=True)
    base_cl = cluster or tiny_batched_cluster(nano_slots=2)
    if tier is None:
        tier = dataclasses.replace(base_cl.nano, decode_steps_per_tick=8,
                                   max_new_tokens=48,
                                   admission_max_queue=64)
    # Windows and cooldowns sized to the compressed "day" (JAX's).
    auto_tier = dataclasses.replace(
        tier, autoscale=True,
        autoscale_min_replicas=1, autoscale_max_replicas=2,
        autoscale_interval_s=0.2, autoscale_breach_window_s=0.4,
        autoscale_idle_window_s=1.5, autoscale_up_cooldown_s=1.5,
        autoscale_down_cooldown_s=4.0, autoscale_queue_high=2.0,
        autoscale_goodput_floor=0.5)
    out: dict = {"period_s": period_s,
                 "slots_per_replica": tier.decode_batch,
                 # One device: the replicas share it (module note).
                 "single_device": True}
    # Short everyday queries: heuristic routes them to nano, in the
    # smallest prefill bucket.
    prompts = [f"q{i} rivers?" for i in range(32)]
    arrivals: list = []

    def run_mode(label: str, mode_tier) -> dict:
        nonlocal arrivals
        cl = dataclasses.replace(base_cl, nano=mode_tier)
        obs = Observability(slow_ms=None)
        # Failover off: a shed fails fast and scores as not good; the
        # productive answer to overload is the policy under test.
        router = Router(strategy="heuristic", benchmark_mode=True,
                        cluster=cl, observability=obs, device=device,
                        config={"enable_failover": False})
        http = create_app(router=router).test_client()
        res: dict = {"replicas_static": mode_tier.replicas}
        try:
            for tc in router.tiers.values():
                tc.server_manager.start_server()
                beat()
            http.post("/chat", json={"message": prompts[0],
                                     "strategy": "heuristic",
                                     "session_id": "el-warm"})
            beat()
            if not arrivals:
                # Closed-loop sustained calibration on the first mode
                # (static-min): a few workers re-posting back to back
                # measure one replica's steady completion rate.
                cal_w, cal_s = 4, 3.5
                t_stop = time.perf_counter() + cal_s
                done = [0] * cal_w

                def _cal(w):
                    i = 0
                    while time.perf_counter() < t_stop:
                        http.post("/chat", json={
                            "message": prompts[(w * 7 + i) % len(prompts)],
                            "strategy": "heuristic",
                            "session_id": f"el-cal-{w}-{i}"})
                        done[w] += 1
                        i += 1

                cal = [threading.Thread(target=_cal, args=(w,),
                                        daemon=True)
                       for w in range(cal_w)]
                t0c = time.perf_counter()
                for t in cal:
                    t.start()
                for t in cal:
                    t.join(timeout=120.0)
                    beat()
                cap = sum(done) / max(time.perf_counter() - t0c, 1e-3)
                # Base at a true idle floor, peak at a mild 1.15x one
                # replica: the queue grows through the plateau while its
                # wait stays inside the TTFT budget.
                segs = diurnal_ramp(
                    base_rate=max(0.2, 0.05 * cap),
                    peak_rate=min(60.0, max(1.5, 1.15 * cap)),
                    period_s=period_s, steps=6)
                arrivals = schedule(segs, label="elastic-diurnal",
                                    seed=18, max_arrivals=600)
                out["capacity_req_per_s"] = round(cap, 3)
                out["schedule"] = {
                    "arrivals": len(arrivals),
                    "base_rate": round(segs[0].rate_req_per_s, 3),
                    "peak_rate": round(max(s.rate_req_per_s
                                           for s in segs), 3),
                    "scheduled_s": round(total_duration_s(segs), 2),
                }

            def fire(a):
                # Stateless unit work: one fresh session per arrival.
                try:
                    http.post("/chat", json={
                        "message": prompts[a.index % len(prompts)],
                        "strategy": "heuristic",
                        "session_id": f"el-{a.index}"})
                except Exception:
                    pass

            g0 = router.slo.good_total
            o0 = router.slo.observed_total
            t0_wall = time.time()
            rep = run_schedule(fire, arrivals, beat=beat,
                               join_grace_s=20.0, label=label)
            wall = max(rep["wall_s"], 1e-6)
            res.update({
                "arrivals": rep["arrivals"],
                "hung_clients": rep["hung_clients"],
                "wall_s": rep["wall_s"],
                "goodput_total": router.slo.good_total - g0,
                "observed_total": router.slo.observed_total - o0,
            })
            scaler = router.autoscalers.get("nano")
            if scaler is not None:
                # Replica-seconds integrated from the decision ledger
                # over the replay; effective events only.
                snap = scaler.snapshot()
                t_end = t0_wall + wall
                events = [e for e in snap["ledger"]
                          if e.get("ok")
                          and e["from_replicas"] != e["to_replicas"]
                          and t0_wall <= e["ts"] <= t_end]
                n0 = (events[0]["from_replicas"] if events
                      else router.tiers["nano"].replica_count())
                rs, cur, t_prev = 0.0, n0, t0_wall
                for e in events:
                    ts = min(max(e["ts"], t0_wall), t_end)
                    rs += cur * (ts - t_prev)
                    cur, t_prev = e["to_replicas"], ts
                rs += cur * (t_end - t_prev)
                res["replica_s"] = round(rs, 2)
                res["scale_events"] = len(events)
                res["max_replicas"] = max([e["to_replicas"]
                                           for e in events] + [n0])
                res["events"] = [{"t": round(e["ts"] - t0_wall, 2),
                                  "dir": e["direction"],
                                  "reason": e["reason"],
                                  "to": e["to_replicas"]}
                                 for e in events]
                # A flap: a full reversal pair inside one combined
                # cooldown window.
                window = (mode_tier.autoscale_up_cooldown_s
                          + mode_tier.autoscale_down_cooldown_s)
                res["flap_count"] = sum(
                    1 for a_e, b_e, c_e in zip(events, events[1:],
                                               events[2:])
                    if a_e["direction"] != b_e["direction"]
                    and b_e["direction"] != c_e["direction"]
                    and (c_e["ts"] - a_e["ts"]) < window)
            else:
                res["replica_s"] = round(mode_tier.replicas * wall, 2)
            res["goodput_per_replica_s"] = round(
                res["goodput_total"] / max(res["replica_s"], 1e-6), 4)
        finally:
            try:
                router.drain(timeout_s=10.0)
            except Exception:
                for tc in router.tiers.values():
                    tc.server_manager.stop_server()
        beat()
        return res

    out["static_min"] = run_mode("static-min",
                                 dataclasses.replace(tier, replicas=1))
    out["static_max"] = run_mode("static-max",
                                 dataclasses.replace(tier, replicas=2))
    out["auto"] = run_mode("auto", auto_tier)

    auto, smax = out["auto"], out["static_max"]
    out["goodput_per_replica_s"] = auto.get("goodput_per_replica_s")
    out["scale_events"] = auto.get("scale_events")
    out["flap_count"] = auto.get("flap_count")
    if smax.get("goodput_total"):
        out["goodput_vs_max"] = round(
            auto["goodput_total"] / smax["goodput_total"], 3)
    if smax.get("goodput_per_replica_s"):
        out["gprs_vs_max"] = round(
            auto["goodput_per_replica_s"] / smax["goodput_per_replica_s"],
            3)
    out["goodput_ok"] = (out.get("goodput_vs_max") is not None
                         and out["goodput_vs_max"] >= 0.9)
    out["gprs_ok"] = (out.get("gprs_vs_max") is not None
                      and out["gprs_vs_max"] > 1.0)
    # HARD: the flap bound (two inflections on the ramp).
    if (out.get("flap_count") or 0) > 0:
        out["error"] = (f"autoscaler flapped: {out['flap_count']} "
                        f"reversal pairs inside one cooldown window "
                        f"({auto.get('events')})")
    elif (out.get("scale_events") or 0) > 4:
        out["error"] = (f"autoscaler over-actuated: "
                        f"{out['scale_events']} scale events on a "
                        f"2-inflection ramp ({auto.get('events')})")

    try:
        hand = _elastic_handoff_subcheck(base_cl, tier, beat=beat,
                                         device=device, tie_check=tie_check)
    except Exception as exc:
        hand = {"error": str(exc)[:200]}
    out["handoff"] = hand
    out["outputs_identical"] = bool(hand.get("identical"))
    if hand.get("error") and "error" not in out:
        out["error"] = f"handoff sub-check: {hand['error']}"
    return out


def chaos2_phase(period_s: float = 16.0, beat=lambda: None, device=None,
                 cluster=None, tier=None,
                 tie_check: Optional[Callable] = None) -> dict:
    """The crash-rescue chaos leg: the seeded diurnal ramp against a
    2-replica nano tier, autoscaler armed in [1, 2], the HealthMonitor in
    the loop, while a fault actor kills a live replica's scheduler loop
    at 35% and 65% of the schedule.  The watchdog flips the member
    wedged, the monitor restarts it through ``restart_replica`` and the
    captured work resumes on the sibling: the kill must not show at the
    tier boundary.  Headline: ``availability``, ``rescue_mttr_ms`` (kill
    to the victim serving on a fresh engine) and ``failovers`` (cross-tier,
    which must stay 0).  ``cluster``/``tier``: default JAX's tiny batched
    tiers, nano at 2 slots."""
    from ..config import tiny_batched_cluster
    from ..obs import Observability
    from ..serving.health import HealthMonitor
    from ..serving.router import Router
    from ..utils.faults import crash_replica_engine
    from .scenarios import diurnal_ramp, run_schedule, schedule, \
        total_duration_s

    print("[bench] chaos2 crash-rescue leg", file=sys.stderr, flush=True)
    base_cl = cluster or tiny_batched_cluster(nano_slots=2)
    base_tier = tier or base_cl.nano
    # 2 replicas, autoscaler armed in [1, 2] (the kill composes with live
    # scale events), a watchdog deadline that fits the compressed day.
    c_tier = dataclasses.replace(
        base_tier, replicas=2, decode_steps_per_tick=8,
        admission_max_queue=64, watchdog_stall_s=1.0,
        autoscale=True, autoscale_min_replicas=1,
        autoscale_max_replicas=2, autoscale_interval_s=0.2,
        autoscale_breach_window_s=0.4, autoscale_idle_window_s=1.5,
        autoscale_up_cooldown_s=1.5, autoscale_down_cooldown_s=4.0,
        autoscale_queue_high=2.0, autoscale_goodput_floor=0.5)
    cl = dataclasses.replace(base_cl, nano=c_tier)
    obs = Observability(slow_ms=None)
    # Failover stays on: the claim is that it does not fire.
    router = Router(strategy="heuristic", benchmark_mode=True, cluster=cl,
                    observability=obs, device=device)
    mon = HealthMonitor(router, interval_s=0.3, auto_restart=True)
    segs = diurnal_ramp(base_rate=1.5, peak_rate=6.0, period_s=period_s,
                        steps=6)
    arrivals = schedule(segs, label="chaos2-diurnal", seed=20,
                        max_arrivals=400)
    sched_s = total_duration_s(segs)
    out: dict = {"period_s": period_s, "arrivals": len(arrivals),
                 "scheduled_s": round(sched_s, 2),
                 "single_device": True}
    prompts = [f"q{i} rivers?" for i in range(32)]
    records: list = []
    rec_lock = threading.Lock()
    kills: list = []
    kill_err: list = []

    def fire(a):
        try:
            resp, _, _dev = router.route_query(
                [{"role": "user",
                  "content": prompts[a.index % len(prompts)]}])
            ok = bool(resp.get("ok")) or bool(resp.get("degraded"))
            raw = resp.get("raw")
            ttft = raw.get("ttft_ms") if isinstance(raw, dict) else None
            with rec_lock:
                records.append((time.monotonic(), ok, ttft))
        except Exception:
            with rec_lock:
                records.append((time.monotonic(), False, None))

    def killer(t_start):
        """Kill a live replica at 35% and 65% of the schedule, then time
        kill -> a fresh serving engine."""
        nano = router.tiers["nano"]
        for frac in (0.35, 0.65):
            wait = t_start + frac * sched_s - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            victim = next((r for r in list(nano._members)
                           if r.mgr.is_server_running()), None)
            if victim is None:
                kill_err.append("no live replica to kill")
                continue
            old_eng = victim.mgr._engine
            if not crash_replica_engine(old_eng):
                kill_err.append(f"{victim.name}: loop already dead")
                continue
            t_kill = time.monotonic()
            restored = None
            while time.monotonic() - t_kill < 30.0:
                cur = getattr(victim.mgr, "_engine", None)
                if (cur is not None and cur is not old_eng
                        and victim.mgr.is_server_running()):
                    restored = time.monotonic()
                    break
                if victim not in list(nano._members):
                    # Scale-down retired the victim mid-rescue: the
                    # membership change is the recovery.
                    restored = time.monotonic()
                    break
                time.sleep(0.02)
            kills.append({
                "replica": victim.name,
                "t_s": round(t_kill - t_start, 2),
                "mttr_ms": (round((restored - t_kill) * 1000.0, 1)
                            if restored is not None else None),
            })
            if restored is None:
                kill_err.append(f"{victim.name}: never restored")

    # The Router hands its registry to the replicated tier client, so the
    # rescue and reattach counters land in this run's own, beside the
    # failovers (read as deltas, as JAX's leg reads the global one).
    gm = obs.m
    outcomes = ("sibling", "requeue", "failed")
    rescues0 = {o: gm.replica_rescues.labels("nano", o).value
                for o in outcomes}
    reattach0 = gm.spill_reattach.labels("nano").value
    try:
        for tc in router.tiers.values():
            tc.server_manager.start_server()
            beat()
        for i in range(2):
            router.route_query([{"role": "user", "content": prompts[i]}])
            beat()
        mon.start()
        t_start = time.monotonic()
        kthread = threading.Thread(target=killer, args=(t_start,),
                                   name="chaos2-killer", daemon=True)
        kthread.start()
        rep = run_schedule(fire, arrivals, beat=beat, join_grace_s=30.0,
                           label="chaos2")
        kthread.join(timeout=45.0)
        beat()
        out["hung_clients"] = rep["hung_clients"]
        n = len(records)
        out["requests"] = n
        out["availability"] = (round(sum(1 for _, a, _ in records if a)
                                     / n, 4) if n else 0.0)
        out["mttr_s"] = _mttr_s([(t, a) for t, a, _ in records])
        ttfts = [x for _, _, x in records if x]
        out["p50_ttft_ms_under_kills"] = (
            round(statistics.median(ttfts), 2) if ttfts else None)
        out["kills"] = kills
        mttrs = [k["mttr_ms"] for k in kills if k["mttr_ms"] is not None]
        out["rescue_mttr_ms"] = (round(statistics.mean(mttrs), 1)
                                 if mttrs else None)
        out["failovers"] = int(sum(
            c.value for c in obs.m.failovers.children().values()))
        out["rescues"] = {
            o: int(gm.replica_rescues.labels("nano", o).value
                   - rescues0[o]) for o in outcomes}
        out["spill_reattached_total"] = int(
            gm.spill_reattach.labels("nano").value - reattach0)
        out["monitor_restarts"] = dict(mon._restarts)
        out["kill_errors"] = kill_err
        if kill_err:
            out["error"] = f"kill/restore: {kill_err[0]}"
        elif out["availability"] < 0.99:
            out["error"] = (f"availability {out['availability']} < 0.99 "
                            f"under replica kills")
        elif out["failovers"] > 0:
            out["error"] = (f"{out['failovers']} cross-tier failovers "
                            f"fired with a live sibling: the replica "
                            f"boundary leaked into tier failover")
        elif out["rescues"]["failed"] > 0:
            out["error"] = (f"{out['rescues']['failed']} captured "
                            f"requests failed instead of resuming")
    finally:
        mon.stop()
        try:
            router.drain(timeout_s=10.0)
        except Exception:
            for tc in router.tiers.values():
                tc.server_manager.stop_server()
    beat()

    try:
        sub = _chaos2_rescue_subcheck(base_cl, base_tier, beat=beat,
                                      device=device, tie_check=tie_check)
    except Exception as exc:
        sub = {"error": str(exc)[:200]}
    out["subcheck"] = sub
    out["outputs_identical"] = bool(sub.get("identical"))
    out["warm_hit"] = bool(sub.get("warm_hit"))
    if sub.get("error") and "error" not in out:
        out["error"] = f"rescue sub-check: {sub['error']}"
    return out
