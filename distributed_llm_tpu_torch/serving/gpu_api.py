"""Per-tier device-server HTTP surface on the GPU.

Counterpart of ``distributed_llm_tpu/serving/tpu_api.py``, with the
same JSON contract and error codes:

  GET  /              liveness text
  GET  /health        {"ok": true} ({"ok": false, "wedged": true, ...}
                      once the decode watchdog fires)
  POST /query         {"query": list[{role, content}] | str,
                       "num_predict": int (optional, -1 = tier cap),
                       "temperature": float (optional),
                       "stats": bool (optional)} -> {"response": text}
                      errors: 400 bad input, 500 engine failure,
                      504 past the tier's request_timeout_s
  POST /query/stream  the same body -> SSE `data: {"delta"}` events, then
                      `data: {"done", "tokens", "ttft_ms", "total_ms"}`;
                      501 when the engine refuses the request's sampling
                      (the speculative engine is greedy-only)

Both routes are gated by the tier's admission controller
(``serving/tiers.AdmissionController``, which ``build_tiers`` registers
on the manager): a refused request is answered 503 with the JAX
package's text, ``"Request failed: <tier> admission rejected: ..."``,
and an admitted one releases its slot on every exit.  A stream's release
sits in its generator, and ``_ReleaseOnce`` runs it when a stream that
never started is dropped; a ``/query`` that timed out (504) keeps its
slot until the engine really finishes it.  A manager passed in without
a controller is not gated, as in the JAX package.

A batched tier's engine takes concurrent requests itself.  The
sequential engines (``decode_batch=1``) assume serialized callers, so
the app runs their calls one at a time under one lock (the JAX
package's ``TierClient`` engine lock): a ``/query`` waits for it within
the tier's ``request_timeout_s`` (504 past it), and a stream holds it
from its first read to its end.

Run one tier's server on the card:

    python -m distributed_llm_tpu_torch.serving.gpu_api --tier nano
    python -m distributed_llm_tpu_torch.serving.gpu_api --tier orin

``--port`` overrides the tier's port (nano 5001, orin 5000) and
``--device cpu`` serves on the CPU.  A router reaches such a server as a
remote tier (``TierConfig.endpoint``, serving/remote.py), and with the
tier's ``spawn_cmd`` starts and revives it itself.
"""

from __future__ import annotations

import argparse
import logging
import threading
import time
from typing import Any, Dict, Optional

from ..config import ClusterConfig
from ..device import DeviceLike
from ..engine.batching import StreamHandle, _Request
from ..engine.manager import EngineManager
from ..utils.http_compat import (Flask, StreamingResponse, jsonify, request,
                                 sse_done_event, sse_event)
from .router import default_cluster
from .tiers import build_tiers
from .turns import ClippedStream, clip_turn

logger = logging.getLogger(__name__)

DEFAULT_NUM_PREDICT = -1
DEFAULT_TEMPERATURE = 0.0

TIER_PORTS = {"nano": 5001, "orin": 5000}


def _validate_history(query) -> Optional[str]:
    """None = well-formed; else the 400 message."""
    if isinstance(query, str):
        return None
    for m in query:
        if not isinstance(m, dict):
            return ("Invalid history entry: expected "
                    "{role, content} objects")
        if not isinstance(m.get("role", ""), str) \
                or not isinstance(m.get("content", ""), str):
            return "Invalid history entry: role/content must be strings"
    return None


def _parse_sampling(data: Dict[str, Any]):
    """(max_new_tokens or None, temperature); raises ValueError/TypeError."""
    num_predict = int(data.get("num_predict") or DEFAULT_NUM_PREDICT)
    temperature = float(data.get("temperature") or DEFAULT_TEMPERATURE)
    return (num_predict if num_predict > 0 else None), temperature


class _ReleaseOnce:
    """Call ``fn`` exactly once: explicitly, or when collected.  A
    stream's admission release sits in its generator's ``finally``, but
    the WSGI layer may drop a response without ever starting the
    generator (the client gone before the first byte), and closing a
    generator that never started runs none of its body.  Only the
    generator holds this object, so its collection is the backstop."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self) -> None:
        fn, self._fn = self._fn, None
        if fn is not None:
            fn()

    def __del__(self):
        self()


def create_tier_app(tier_name: str, cluster: Optional[ClusterConfig] = None,
                    manager: Optional[EngineManager] = None,
                    device: DeviceLike = None) -> Flask:
    """The tier's app.  Without ``manager`` one is built (lazily started)
    through ``build_tiers`` from ``cluster``'s tier ``tier_name`` (default
    ``default_cluster(device)``, as the JAX package's tier app) on
    ``device`` (default: the card), with its admission controller."""
    app = Flask(f"dllm_gpu_{tier_name}")
    if manager is None:
        tiers = build_tiers(cluster or default_cluster(device), device=device,
                            warmup_on_start=False)
        if tier_name not in tiers:
            raise ValueError(f"unknown tier {tier_name!r}")
        manager = tiers[tier_name].server_manager
    app.extensions["dllm_manager"] = manager
    timeout_s = manager.tier.request_timeout_s
    # A remote router POSTs here directly: without the gate a saturated
    # tier would queue without bound.  A manager passed in without a
    # controller is not gated.
    admission = getattr(manager, "admission", None)

    def admit():
        """None when admitted (or ungated), else the 503 response."""
        if admission is None:
            return None
        err = admission.try_admit()
        if err is None:
            return None
        return jsonify({"error": f"Request failed: {tier_name} admission "
                                 f"rejected: {err}"}), 503

    def release(service_s: Optional[float] = None) -> None:
        if admission is not None:
            admission.release(service_s)
    # Serializes calls into a sequential engine (see the module note).
    engine_lock = threading.Lock()

    def submit(engine, query, max_new, temperature) -> _Request:
        """The batched engine's own submit, or the sequential engine's
        generate on a worker thread under the engine lock: either way a
        request whose ``done`` the caller waits on.  A timed-out wait
        leaves the worker to finish and release the lock."""
        if hasattr(engine, "submit"):
            return engine.submit(query, max_new_tokens=max_new,
                                 temperature=temperature)
        req = _Request(history=query, max_new_tokens=max_new,
                       temperature=temperature)

        def work():
            try:
                with engine_lock:
                    req.result = engine.generate(
                        query, max_new_tokens=max_new, temperature=temperature)
            except Exception as exc:        # reported by the waiting handler
                req.error = exc
            finally:
                req.done.set()

        threading.Thread(target=work, daemon=True,
                         name=f"query-{manager.tier.name}").start()
        return req

    def serialized(engine, handle: StreamHandle) -> StreamHandle:
        """A sequential engine's stream, read under the engine lock from
        its first read to its end (released on exhaustion, error or
        close)."""
        if hasattr(engine, "submit"):
            return handle

        def locked():
            if not engine_lock.acquire(timeout=-1 if timeout_s is None
                                       else timeout_s):
                raise TimeoutError("Inference timed out waiting for the "
                                   "engine")
            try:
                yield from handle
            finally:
                engine_lock.release()

        return StreamHandle(locked(), handle.request)

    @app.route("/")
    def home():
        return "Server is running!\n", 200

    @app.route("/health", methods=["GET"])
    def health():
        """Lock-free: a lazily not-yet-started engine is healthy; a wedged
        decode loop (no progress past the watchdog deadline) is not."""
        stall = getattr(manager._engine, "progress_stall_s", None)
        deadline = manager.tier.watchdog_stall_s
        if callable(stall) and deadline is not None:
            stall_s = stall()
            if stall_s > deadline:
                return jsonify({
                    "ok": False, "wedged": True,
                    "error": (f"decode watchdog: no step progress for "
                              f"{stall_s:.1f}s (deadline {deadline:.0f}s)")}), 200
        return jsonify({"ok": True}), 200

    @app.route("/query", methods=["POST"])
    def process_query():
        data: Dict[str, Any] = request.get_json(silent=True) or {}
        query = data.get("query")
        if not query:
            return jsonify({"error": "No query provided"}), 400
        if not isinstance(query, (list, str)):
            return jsonify({"error": "Invalid query format. "
                                     "Expect list[role/content] or string."}), 400
        bad = _validate_history(query)
        if bad is not None:
            return jsonify({"error": bad}), 400
        try:
            max_new, temperature = _parse_sampling(data)
        except (TypeError, ValueError):
            return jsonify({"error": "num_predict/temperature must be numeric"}), 400
        refused = admit()
        if refused is not None:
            return refused
        t0 = time.perf_counter()
        held = False
        try:
            req = submit(manager.engine(), query, max_new, temperature)
            if not req.done.wait(timeout=timeout_s):
                # The engine finishes the abandoned request on its own,
                # and its slot is released then.
                held = True
                threading.Thread(
                    target=lambda: (req.done.wait(),
                                    release(time.perf_counter() - t0)),
                    daemon=True).start()
                return jsonify({"error": "Inference timed out"}), 504
            if req.error is not None:
                raise req.error
            result = req.result
            payload: Dict[str, Any] = {"response": clip_turn(result.text)}
            if data.get("stats"):
                payload["stats"] = {
                    "prompt_tokens": result.prompt_tokens,
                    "gen_tokens": result.gen_tokens,
                    "ttft_ms": round(result.ttft_ms, 3),
                    "total_ms": round(result.total_ms, 3),
                }
            return jsonify(payload)
        except Exception as exc:
            logger.exception("inference failed")
            return jsonify({"error": f"Inference failed: {exc}"}), 500
        finally:
            if not held:
                release(time.perf_counter() - t0)

    @app.route("/query/stream", methods=["POST"])
    def process_query_stream():
        data: Dict[str, Any] = request.get_json(silent=True) or {}
        query = data.get("query")
        if not query or not isinstance(query, (list, str)):
            return jsonify({"error": "No/invalid query provided"}), 400
        bad = _validate_history(query)
        if bad is not None:
            return jsonify({"error": bad}), 400
        try:
            max_new, temperature = _parse_sampling(data)
        except (TypeError, ValueError):
            return jsonify({"error": "num_predict/temperature must be "
                                     "numeric"}), 400
        refused = admit()
        if refused is not None:
            return refused
        t0 = time.perf_counter()
        try:
            engine = manager.engine()
            handle = ClippedStream(serialized(engine, engine.generate_stream(
                query, max_new_tokens=max_new, temperature=temperature)))
        except NotImplementedError as exc:
            release()
            return jsonify({"error": str(exc)}), 501
        except Exception as exc:
            logger.exception("stream setup failed")
            release()
            return jsonify({"error": f"Inference failed: {exc}"}), 500

        def release_slot() -> None:
            # The engine's own time when the stream completed, the wall
            # time otherwise (a client gone mid-generation).
            result = getattr(handle, "result", None)
            engine_ms = getattr(result, "total_ms", 0) if result else 0
            release(engine_ms / 1000.0 if engine_ms
                    else time.perf_counter() - t0)

        once = _ReleaseOnce(release_slot)

        def events():
            try:
                for delta in handle:
                    yield sse_event({"delta": delta})
                yield sse_done_event(handle.result)
            except Exception as exc:
                yield sse_event({"error": str(exc)})
            finally:
                # Exactly once: exhaustion, a client gone (the generator
                # closed) or, for a generator never started, collection.
                once()

        return StreamingResponse(events())

    return app


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Serve one tier's /query API on the GPU.")
    parser.add_argument("--tier", choices=sorted(TIER_PORTS), default="nano")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' serves "
                             "the tiny trained tiers)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    app = create_tier_app(args.tier, device=args.device)
    t0 = time.perf_counter()
    app.extensions["dllm_manager"].start_server()
    logger.info("tier %s ready in %.1fs", args.tier, time.perf_counter() - t0)
    port = args.port if args.port is not None else TIER_PORTS[args.tier]
    app.run(host=args.host, port=port, threaded=True)


if __name__ == "__main__":
    main()
