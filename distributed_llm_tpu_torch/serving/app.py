"""The two-tier chat API, the reference contract:

  POST /chat       {message, strategy, session_id, tenant_id} ->
                   {reply, device, reasoning, method, confidence,
                    cache_hit, tokens}
  POST /chat/stream  the same request -> SSE meta / delta / done events
  GET  /history    ?session_id=...   -> [messages]
  DELETE /history  ?session_id=...   -> {"cleared": session_id}
  GET  /health, GET /stats (?debug=1 adds the flight recorder,
                   ?timeline=1 the state sampler's ring)
  GET  /metrics      Prometheus text of the serving metrics
  GET  /debug/trace  Chrome-trace JSON of the engines' tick phases
  and the frontend under /ui

Counterpart of ``distributed_llm_tpu/serving/app.py`` over the port's
Router, on the card unless ``device="cpu"``.  Kept from the reference:
the UI strategy name "token-counting" maps to "token"; a strategy switch
goes through QueryRouter.change_strategy, so cache and perf state
survive; each session keeps its last 10 messages, behind a lock; the
user turn is rolled back if routing raises.  While the router drains,
/chat and /health answer 503 with a retry hint.  A session's id keys
its requests' cost attribution; ``tenant_id`` (at most 64 printable
characters; absent = the ``default`` tenant) keys the tenant quotas and
billing.  /stats carries each quota-on tier's ``tenants`` block and the
``autoscaler`` block, and JAX's ``measured_tables``: which measured tables
steer serving on this backend.  ``backend`` is the router's device type;
``dispatch`` is always "none", since the port has no attention dispatch
table (each attention path has one kernel, routed by shape); ``tuning``
is the backend where ``bench.tune.load_tuning`` finds a tuning table
measured on it (``bench_cluster()`` overlays it), else "none".

    python -m distributed_llm_tpu_torch.serving.app      # port 8000
    python -m distributed_llm_tpu_torch [--port N] [--device cpu]
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Dict, List, Optional

from ..config import ClusterConfig
from ..device import DeviceLike
from ..utils.http_compat import (Flask, enable_cors, jsonify, request,
                                 sse_done_event, sse_event, static_response,
                                 streaming_response)
from .router import Router

logger = logging.getLogger(__name__)

HISTORY_LIMIT = 10

# Input-hardening cap on one /chat message, in characters.
MAX_MESSAGE_CHARS = 65536

# The defaults the reference app passes to its router.
BASE_CONFIG: Dict[str, Any] = {
    "cache_enabled": True,
    "enable_response_cache": True,
    "enable_failover": True,
    "weights": {"token": 0.25, "semantic": 0.45, "heuristic": 0.30},
}


def create_app(router: Optional[Router] = None,
               cluster: Optional[ClusterConfig] = None,
               device: DeviceLike = None) -> Flask:
    """The app over ``router``, or over a new hybrid Router with
    ``BASE_CONFIG`` on ``cluster`` and ``device``."""
    app = Flask("distributed_llm_tpu_torch")
    enable_cors(app)

    state_lock = threading.Lock()
    if router is None:
        router = Router(strategy="hybrid", config=dict(BASE_CONFIG),
                        cluster=cluster, device=device)
    state = {
        "router": router,
        "strategy": router.query_router.strategy,
        "histories": {},      # session_id -> List[message]
    }
    app.extensions["dllm_state"] = state

    @app.route("/chat", methods=["POST"])
    def chat():
        err, turn, requested, session_id, tenant_id, history, snapshot = \
            _begin_chat_turn()
        if err is not None:
            return err

        try:
            response_data, tokens, device = state["router"].route_query(
                snapshot, session_id=session_id, tenant_id=tenant_id)

            if isinstance(response_data, dict):
                reply = response_data.get("response", "")
                reasoning = response_data.get(
                    "routing_reasoning", f"Method: {requested}")
                method = response_data.get("routing_method", requested)
                confidence = response_data.get("routing_confidence", 0.0)
                cache_hit = response_data.get("cache_hit", False)
            else:
                reply = str(response_data)
                reasoning, method = "Direct response", requested
                confidence, cache_hit = 0.0, False

            _commit_assistant_turn(history, session_id, reply)

            return jsonify({
                "reply": reply,
                "device": device,
                "reasoning": reasoning,
                "method": method,
                "confidence": confidence,
                "cache_hit": cache_hit,
                "tokens": tokens,
            })

        except Exception as exc:
            logger.exception("Error during routing")
            _rollback_user_turn(history, turn)
            return jsonify({
                "reply": "System Error: The router encountered an issue.",
                "device": "error",
                "reasoning": str(exc),
                "method": requested,
                "confidence": 0.0,
                "cache_hit": False,
                "tokens": 0,
            }), 500

    def _bad_request(msg: str):
        """One 400 shape for every input-hardening rejection (reference
        error dict, like the original missing-message branch)."""
        return ((jsonify({"error": msg}), 400),
                None, None, None, None, None, None)

    def _begin_chat_turn():
        """Shared /chat + /chat/stream front half: parse AND VALIDATE the
        request, hot-swap the strategy, append the user turn.  Returns
        (error_response | None, user turn, requested, session_id,
        tenant_id, history, snapshot).  Bad JSON, a non-object body, a
        non-string or oversized message, a non-string strategy or
        session_id, and a tenant_id that is empty, not a string, over 64
        characters or holds control characters (it becomes a metric label
        and a quota key) are all 400 with the reference error shape."""
        if getattr(state["router"], "draining", False):
            # Graceful drain: the edge stops admitting FIRST.  503 + the
            # sanctioned retry hint; in-flight requests keep finishing.
            return ((jsonify({
                "error": "Request failed: server is draining "
                         "(graceful shutdown in progress)",
                "retry_after_s": state["router"].drain_retry_after_s(),
            }), 503), None, None, None, None, None, None)
        data = request.get_json(silent=True)
        if data is None:
            return _bad_request("Request failed: body must be valid JSON")
        if not isinstance(data, dict):
            return _bad_request("Request failed: body must be a JSON "
                                "object")
        user_input = data.get("message", "")
        requested = data.get("strategy", "hybrid")
        session_id = data.get("session_id", "default")
        tenant_id = data.get("tenant_id", "default")
        if not isinstance(user_input, str):
            return _bad_request("Request failed: 'message' must be a "
                                "string")
        if len(user_input) > MAX_MESSAGE_CHARS:
            return _bad_request(f"Request failed: 'message' exceeds "
                                f"{MAX_MESSAGE_CHARS} characters")
        if not isinstance(requested, str) or not isinstance(session_id,
                                                            str):
            return _bad_request("Request failed: 'strategy' and "
                                "'session_id' must be strings")
        if not isinstance(tenant_id, str) or not tenant_id:
            return _bad_request("Request failed: 'tenant_id' must be a "
                                "non-empty string")
        if len(tenant_id) > 64:
            return _bad_request("Request failed: 'tenant_id' exceeds "
                                "64 characters")
        if any(ord(c) < 32 or ord(c) == 127 for c in tenant_id):
            return _bad_request("Request failed: 'tenant_id' must not "
                                "contain control characters")
        if requested == "token-counting":   # UI dropdown name
            requested = "token"
        if not user_input.strip():
            return _bad_request("No message provided")
        with state_lock:
            if requested != state["strategy"]:
                logger.info("Switching strategy: %s -> %s",
                            state["strategy"], requested)
                try:
                    state["router"].query_router.change_strategy(requested)
                    state["strategy"] = requested
                except Exception as exc:
                    return ((jsonify({"error":
                                      f"Failed to switch strategy: {exc}"}),
                             500), None, None, None, None, None, None)
            history = state["histories"].setdefault(session_id, [])
            turn = {"role": "user", "content": user_input}
            history.append(turn)
            snapshot = list(history)
        return (None, turn, requested, session_id, tenant_id, history,
                snapshot)

    def _rollback_user_turn(history, turn):
        """Remove THIS request's user turn by identity — popping the tail
        would delete a different request's turn when two land on the same
        session concurrently (streams hold the window open for seconds)."""
        with state_lock:
            for i in range(len(history) - 1, -1, -1):
                if history[i] is turn:
                    del history[i]
                    break

    def _commit_assistant_turn(history, session_id, reply):
        """Append the assistant turn and trim IN PLACE: replacing the list
        object would orphan the reference every other in-flight request on
        this session holds — and NO re-bind, which would resurrect a
        session cleared (or replaced) while this request was in flight."""
        with state_lock:
            history.append({"role": "assistant", "content": reply})
            if len(history) > HISTORY_LIMIT:
                del history[:len(history) - HISTORY_LIMIT]

    @app.route("/chat/stream", methods=["POST"])
    def chat_stream():
        """SSE chat: one ``meta`` event with the routing decision, then
        ``delta`` events as tokens decode, then ``done``; built on
        Router.route_query_stream (the sync path's decision stage,
        failover and perf feedback; no response cache)."""
        err, turn, requested, session_id, tenant_id, history, snapshot = \
            _begin_chat_turn()
        if err is not None:
            return err

        try:
            routed = state["router"].route_query_stream(
                snapshot, session_id=session_id, tenant_id=tenant_id)
        except Exception as exc:
            logger.exception("stream routing failed")
            _rollback_user_turn(history, turn)
            return jsonify({"error": f"Routing failed: {exc}"}), 500

        def events():
            pieces: List[str] = []
            committed = False
            try:
                yield sse_event({"meta": True, **routed.meta})
                for delta in routed:
                    pieces.append(delta)
                    yield sse_event({"delta": delta})
                _commit_assistant_turn(history, session_id, "".join(pieces))
                committed = True
                yield sse_done_event(routed.result)
            except Exception as exc:
                logger.exception("stream failed mid-flight")
                yield sse_event({"error": str(exc)})
            finally:
                # Covers errors AND client disconnects (GeneratorExit
                # skips except-Exception): an uncommitted turn must not
                # leave the session history with this request's dangling
                # user message.
                if not committed:
                    _rollback_user_turn(history, turn)

        return streaming_response(events())

    # -- the frontend at the checkout's root (the same /chat contract, so
    # the reference React app also works pointed at this server) ---------
    frontend_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "frontend")
    ui_files = {                  # fixed allowlist: no path traversal
        "/ui": ("index.html", "text/html; charset=utf-8"),
        "/ui/app.js": ("app.js", "application/javascript; charset=utf-8"),
        "/ui/style.css": ("style.css", "text/css; charset=utf-8"),
    }

    def _serve_ui(route: str):
        fname, ctype = ui_files[route]
        path = os.path.join(frontend_dir, fname)
        if not os.path.exists(path):
            return jsonify({"error": "frontend not bundled"}), 404
        with open(path, "rb") as f:
            return static_response(f.read(), ctype)

    def _make_ui_view(route: str):
        def view():
            return _serve_ui(route)
        # Distinct names: real Flask derives its endpoint from __name__.
        view.__name__ = "ui_" + ui_files[route][0].replace(".", "_")
        return view

    for route in ui_files:
        app.route(route, methods=["GET"])(_make_ui_view(route))

    @app.route("/health", methods=["GET"])
    def health():
        """Process liveness for load balancers and drain orchestration:
        ``status`` is ``draining`` (503) once a graceful drain started,
        else ``ok``; per-tier snapshots (lock-free) ride along."""
        router_ = state["router"]
        draining = bool(router_.draining)
        tiers = {}
        for name, tier in router_.tiers.items():
            try:
                tiers[name] = tier.server_manager.health()
            except Exception as exc:
                tiers[name] = {"ok": False, "detail": str(exc)[:200]}
        payload = {"status": "draining" if draining else "ok",
                   "draining": draining,
                   "tiers": tiers}
        if draining:
            payload["retry_after_s"] = router_.drain_retry_after_s()
            return jsonify(payload), 503
        return jsonify(payload)

    @app.route("/metrics", methods=["GET"])
    def metrics():
        """Prometheus text exposition of the router's metric registry
        (obs/metrics.py)."""
        body = state["router"].obs.metrics.render().encode("utf-8")
        return static_response(
            body, "text/plain; version=0.0.4; charset=utf-8")

    @app.route("/debug/trace", methods=["GET"])
    def debug_trace():
        """Chrome-trace JSON of every live batched engine's tick-phase
        profiler (obs/profiler.py): ticks as slices, phases as nested
        slices with their self-times, compile and host-sync instants.
        Load it in chrome://tracing or ui.perfetto.dev.  Empty
        traceEvents when no profiler is live (sequential tiers,
        profile=False)."""
        return jsonify(state["router"].profiler_trace())

    @app.route("/stats", methods=["GET"])
    def stats():
        """Routing-cache health, per-tier engine state (health, phase
        timings and roofline work, prefix cache, KV pool, decode ticks,
        speculation), the breaker, the SLO monitor and the cost ledger;
        ``?timeline=1`` adds the state sampler's ring and ``?debug=1`` the
        flight recorder's."""
        from ..bench.tune import load_tuning
        from ..utils.telemetry import device_memory_snapshot
        from ..utils.telemetry import engine_stats
        with state_lock:
            router_ = state["router"]
            strategy = state["strategy"]
            sessions = len(state["histories"])
        tiers = {}
        for name, tier in router_.tiers.items():
            mgr = tier.server_manager
            entry = dict(mgr.health())
            subs = getattr(mgr, "live_engines", None)
            if callable(subs):
                # A replicated tier: each live replica's engine stats under
                # its key, the summed pool picture at tier level.
                entry["replica_engines"] = {
                    key: engine_stats(engine) for key, engine in subs()}
                agg = mgr.kv_stats()
                if agg:
                    entry["kv"] = agg
            else:
                # Never lazy-starts; a remote tier has no local engine.
                engine = getattr(mgr, "_engine", None)
                entry.update(engine_stats(engine))
                for key in ("tick_stats", "spec_stats"):
                    fn = getattr(engine, key, None)
                    if callable(fn):
                        entry[key[:-len("_stats")]] = fn()
            # A quota-on tier's tenant state: active counts, bucket
            # levels, admit and reject totals.
            tq = getattr(tier, "tenants", None)
            if tq is not None:
                entry["tenants"] = tq.snapshot()
            tiers[name] = entry
        backend = router_.device.type
        payload = {
            "strategy": strategy,
            "sessions": sessions,
            "cache": router_.query_router.get_cache_stats(),
            "tiers": tiers,
            "devices": device_memory_snapshot(router_.device),
            "measured_tables": {
                "backend": backend, "dispatch": "none",
                "tuning": backend if load_tuning(backend) else "none"},
            "prefix_affinity_overrides": router_.prefix_affinity_overrides,
            "breaker": (router_.breaker.snapshot()
                        if router_.breaker is not None else None),
            "degraded_served": router_.degraded_served,
            "draining": {
                name: bool(getattr(t.server_manager, "draining", False))
                for name, t in router_.tiers.items()},
            # Windowed goodput and incident state, and who pays for the
            # ticks (the attributed cost ledger).
            "slo": router_.slo.snapshot(),
            # Elastic capacity: per armed tier, membership, streaks and the
            # bounded decision ledger (None when no tier is armed).
            "autoscaler": router_.autoscaler_snapshot(),
            "cost": router_.cost_snapshot(),
        }
        if request.args.get("timeline") == "1":
            payload["timeline"] = router_.timeline_snapshot()
            sampler = router_.sampler
            if sampler is not None:
                payload["timeline_meta"] = {
                    "period_s": sampler.period_s,
                    "capacity": sampler.capacity,
                    "samples_total": sampler.samples_total,
                    "sample_cost_ms": (round(sampler.sample_cost_ms, 4)
                                       if sampler.sample_cost_ms is not None
                                       else None),
                    "running": sampler.running,
                }
        if request.args.get("debug") == "1":
            payload["flight_recorder"] = router_.obs.recorder.snapshot()
            payload["flight_recorded_total"] = \
                router_.obs.recorder.recorded_total
        return jsonify(payload)

    @app.route("/history", methods=["GET"])
    def get_history():
        session_id = request.args.get("session_id", "default")
        with state_lock:
            return jsonify(state["histories"].get(session_id, []))

    @app.route("/history", methods=["DELETE"])
    def clear_history():
        session_id = request.args.get("session_id", "default")
        with state_lock:
            state["histories"].pop(session_id, None)
        return jsonify({"cleared": session_id})

    return app


def install_drain_handler(router: Router, exit_after: bool = True) -> bool:
    """SIGTERM -> graceful drain: stop admitting (the edge 503s, /health
    reads ``draining``), let in-flight requests finish under each tier's
    ``drain_timeout_s``, stop the engines, then exit.  False when no
    handler could be installed (not the main thread)."""
    import signal

    def _on_sigterm(signum, frame):
        logger.warning("SIGTERM: draining before exit")
        try:
            router.drain()
        finally:
            if exit_after:
                raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
        return True
    except ValueError:            # not the main thread
        return False


def main(argv: Optional[List[str]] = None) -> None:
    """Serve ``/chat`` on ``--port`` (default 8000, the reference's) on
    the card, or on the CPU with ``--device cpu``; SIGTERM drains."""
    import argparse
    p = argparse.ArgumentParser(description="the two-tier /chat service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="cpu runs the plain PyTorch path (default: the card)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    router = Router(strategy="hybrid", config=dict(BASE_CONFIG),
                    device=args.device)
    app = create_app(router=router)
    install_drain_handler(router)
    print(f"API running on http://{args.host}:{args.port}", flush=True)
    app.run(host=args.host, port=args.port, threaded=True)


if __name__ == "__main__":
    main()
