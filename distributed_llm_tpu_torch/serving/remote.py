"""Remote tier client: a tier served by a ``/query`` server elsewhere.

Counterpart of ``distributed_llm_tpu/serving/remote.py``.  The reference
router POSTs the chat history as JSON to a per-device HTTP server
(src/models/nano.py:23-28); a tier with ``TierConfig.endpoint`` does the
same against the port's ``/query`` + ``/health`` contract
(serving/gpu_api.py, the same contract as the JAX package's tpu_api), in
another process on the same card or on another host.

As the JAX client, and unlike the reference's:

- Both tiers get (connect, read) timeouts (the reference's Orin client
  has none, src/models/orin.py:26).
- ``RemoteServerManager.start_server`` starts the server process when the
  tier carries a ``spawn_cmd`` (the reference's SSH bootstrap as an argv
  the deployment chooses), then polls ``GET /health`` for readiness (15 x
  1 s, or ``SPAWN_READY_ATTEMPTS`` for a fresh child) and raises if the
  server never comes up.  Without a ``spawn_cmd`` the remote host owns
  the lifecycle and ``stop_server`` is a no-op.
- ``process`` asks for ``/query``'s ``stats`` extension, so the router's
  perf strategy and TTFT accounting see engine-true numbers.

Error dicts have the reference's shapes, so the Router's failover treats a
remote tier as a local one.  To serve a tier remotely from the router's
own machine, give it, for example::

    TierConfig(name="nano", model_preset="nano_1b", decode_batch=8,
               endpoint="http://127.0.0.1:5001",
               spawn_cmd=(sys.executable, "-m",
                          "distributed_llm_tpu_torch.serving.gpu_api",
                          "--tier", "nano", "--port", "5001"))
"""

from __future__ import annotations

import json
import logging
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Union

from ..engine.inference import GenerationResult
from ..utils.faults import FaultInjector, maybe_break_stream

logger = logging.getLogger(__name__)

History = Union[str, List[Dict[str, Any]]]

HEALTH_POLL_ATTEMPTS = 15          # reference: 15 x 1 s (server_manager.py:128)
HEALTH_POLL_INTERVAL_S = 1.0
SPAWN_READY_ATTEMPTS = 120         # a spawned child imports torch, builds
SPAWN_GRACE_S = 180.0              # its engine; a live child younger than
                                   # the grace is starting, not wedged
CONNECT_TIMEOUT_S = 5.0            # reference nano.py:28 (5, 180)
READ_TIMEOUT_S = 180.0
CONNECT_RETRY_ATTEMPTS = 3         # connection refused while a spawned
CONNECT_RETRY_BACKOFF_S = 0.2      # server binds its port: a short retry


def _http_json(url: str, payload: Optional[Dict[str, Any]] = None,
               timeout: float = READ_TIMEOUT_S) -> Dict[str, Any]:
    """POST (GET when ``payload`` is None) expecting a JSON body; a
    non-JSON reply raises ValueError (the reference's content-type guard,
    src/models/nano.py:30-33)."""
    data = None if payload is None else json.dumps(payload).encode("utf-8")
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        ctype = resp.headers.get("Content-Type", "")
        body = resp.read()
    if "application/json" not in ctype:
        raise ValueError(f"non-JSON response (Content-Type {ctype!r})")
    return json.loads(body.decode("utf-8"))


class RemoteServerManager:
    """The ServerManager surface over a tier server in another process.

    With a ``spawn_cmd`` it owns the process: ``start_server`` launches
    the argv when /health is dead and polls readiness; ``stop_server``
    puts down a process it spawned.  The command must replace any
    existing instance (``terminate`` reaches only the local process)."""

    # The HealthMonitor's contract: a tier seen running whose /health then
    # stops answering has died (nothing stops a remote on purpose), and is
    # revived through start_server (serving/health.py).
    remote_lifecycle = True

    def __init__(self, base_url: str,
                 connect_timeout: float = CONNECT_TIMEOUT_S,
                 spawn_cmd: Optional[Sequence[str]] = None,
                 spawn_ready_attempts: int = SPAWN_READY_ATTEMPTS,
                 spawn_grace_s: float = SPAWN_GRACE_S):
        self.base_url = base_url.rstrip("/")
        self.connect_timeout = connect_timeout
        self.spawn_cmd = tuple(spawn_cmd) if spawn_cmd else None
        self.spawn_ready_attempts = spawn_ready_attempts
        self.spawn_grace_s = spawn_grace_s
        self._proc = None
        self._spawned_at: Optional[float] = None

    def is_server_running(self) -> bool:
        try:
            return bool(self.health().get("ok"))
        except Exception:
            return False

    def health(self) -> Dict[str, Any]:
        return _http_json(f"{self.base_url}/health",
                          timeout=self.connect_timeout)

    def _spawn(self) -> None:
        """Launch the argv detached (the reference's ``nohup ... &``): no
        inherited stdio, its own session."""
        import subprocess
        logger.info("spawning remote tier server: %s",
                    " ".join(self.spawn_cmd))
        self._proc = subprocess.Popen(
            list(self.spawn_cmd), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True)
        self._spawned_at = time.monotonic()

    def start_server(self, beat=None) -> None:
        """Revive the remote tier if needed, then wait for readiness (a
        fresh child gets ``spawn_ready_attempts`` polls).  ``beat`` feeds
        a caller's watchdog through the wait."""
        attempts = HEALTH_POLL_ATTEMPTS
        if self.spawn_cmd and not self.is_server_running():
            child_alive = self._proc is not None and self._proc.poll() is None
            if not child_alive:
                self._spawn()              # never spawned, or it died
            elif (self._spawned_at is not None
                  and time.monotonic() - self._spawned_at > self.spawn_grace_s):
                # Unhealthy past the startup grace: wedged.  Inside it the
                # child is still loading, and killing it would loop.
                self._put_down(self._proc)
                self._spawn()
            attempts = max(attempts, self.spawn_ready_attempts)
        for attempt in range(attempts):
            if self.is_server_running():
                return
            if beat is not None:
                beat()
            if attempt < attempts - 1:
                time.sleep(HEALTH_POLL_INTERVAL_S)
        raise TimeoutError(
            f"remote tier at {self.base_url} not healthy after "
            f"{attempts} attempts")

    @staticmethod
    def _put_down(proc) -> None:
        """Terminate, kill, reap: an unreaped child stays a zombie, and a
        successor spawned before the old one released its port would lose
        the bind."""
        proc.terminate()
        try:
            proc.wait(timeout=5)
            return
        except Exception:
            pass
        proc.kill()
        try:
            proc.wait(timeout=5)
        except Exception:
            pass

    def stop_server(self) -> None:
        """Put down a process this manager spawned; a no-op otherwise."""
        if self._proc is not None and self._proc.poll() is None:
            self._put_down(self._proc)
        self._proc = None
        self._spawned_at = None


class RemoteTierClient:
    """The TierClient surface (``process``, ``process_stream``,
    ``server_manager``, ``last_result``) over a remote ``/query``."""

    def __init__(self, name: str, base_url: str,
                 fault_injector: Optional[FaultInjector] = None,
                 read_timeout: float = READ_TIMEOUT_S,
                 spawn_cmd: Optional[Sequence[str]] = None):
        self.name = name
        self.tier = None                   # no local TierConfig
        self.base_url = base_url.rstrip("/")
        self.read_timeout = read_timeout
        self.server_manager = RemoteServerManager(self.base_url,
                                                  spawn_cmd=spawn_cmd)
        self.faults = fault_injector
        self.last_result: Optional[GenerationResult] = None

    def _intercept(self) -> Optional[Dict[str, Any]]:
        if self.faults is not None:
            return self.faults.intercept(self.name)
        return None

    def _probe(self) -> None:
        """A TCP connect under the connect timeout before the request
        (urllib has one timeout, and inference may take the whole read
        timeout), so a dead host fails fast into the router's failover.
        Connection refused is retried briefly (a spawned server binding
        its port); a timeout is not."""
        parts = urllib.parse.urlsplit(self.base_url)
        port = parts.port or (443 if parts.scheme == "https" else 80)
        for attempt in range(CONNECT_RETRY_ATTEMPTS):
            try:
                conn = socket.create_connection(
                    (parts.hostname, port),
                    timeout=self.server_manager.connect_timeout)
                conn.close()
                return
            except ConnectionRefusedError:
                if attempt == CONNECT_RETRY_ATTEMPTS - 1:
                    raise
                logger.info("tier %s: connection refused, connect retry "
                            "%d/%d", self.name, attempt + 1,
                            CONNECT_RETRY_ATTEMPTS - 1)
                time.sleep(CONNECT_RETRY_BACKOFF_S * (attempt + 1))

    def process(self, history: History) -> Dict[str, Any]:
        fault = self._intercept()
        if fault is not None:
            return fault
        try:
            self._probe()
            payload = _http_json(f"{self.base_url}/query",
                                 {"query": history, "stats": True},
                                 timeout=self.read_timeout)
        except (urllib.error.URLError, socket.timeout, TimeoutError,
                ValueError, OSError) as exc:
            return {"error": f"Request failed: {exc}"}
        stats = payload.pop("stats", None)
        if isinstance(stats, dict):
            self.last_result = GenerationResult(
                text=payload.get("response", ""), token_ids=[],
                prompt_tokens=int(stats.get("prompt_tokens", 0)),
                gen_tokens=int(stats.get("gen_tokens", 0)),
                ttft_ms=float(stats.get("ttft_ms", 0.0)),
                total_ms=float(stats.get("total_ms", 0.0)))
        return payload

    def process_stream(self, history: History):
        """Consume the remote ``/query/stream`` SSE as a stream handle
        (deltas, ``.result`` from the terminal event).  A setup failure
        (unreachable host, a non-SSE reply, an error event before the
        first delta) returns the reference error shape, the router's
        stream-failover window."""
        fault = self._intercept()
        if fault is not None:
            return fault
        resp = None
        try:
            self._probe()
            data = json.dumps({"query": history}).encode("utf-8")
            req = urllib.request.Request(
                f"{self.base_url}/query/stream", data=data,
                headers={"Content-Type": "application/json"})
            resp = urllib.request.urlopen(req, timeout=self.read_timeout)
            ctype = resp.headers.get("Content-Type", "")
            if "text/event-stream" not in ctype:
                body = resp.read(2048).decode("utf-8", "replace")
                return {"error": f"Request failed: non-SSE reply "
                                 f"({ctype!r}): {body[:200]}"}
            handle = _RemoteStream(resp)
            handle.prime()
            resp = None                  # the handle owns the connection
            return maybe_break_stream(self.faults, self.name, handle)
        except (urllib.error.URLError, socket.timeout, TimeoutError,
                ValueError, OSError, RuntimeError) as exc:
            return {"error": f"Request failed: {exc}"}
        finally:
            if resp is not None:
                resp.close()


class _RemoteStream:
    """The client side of the ``/query/stream`` SSE contract: iterates
    text deltas; ``.result`` comes from the terminal ``done`` event
    (engine-true tokens, TTFT and generation time)."""

    def __init__(self, resp):
        self._resp = resp
        self._buf = b""
        self._queued: List[str] = []
        self._done = False
        self.result: Optional[GenerationResult] = None
        self._text_parts: List[str] = []

    def _read_frames(self) -> bool:
        """Read until one SSE frame is handled or the connection ends;
        True if a frame was handled."""
        while not self._done:
            sep = self._buf.find(b"\n\n")
            if sep >= 0:
                frame = self._buf[:sep].decode("utf-8", "replace")
                self._buf = self._buf[sep + 2:]
                if not frame.startswith("data: "):
                    continue
                ev = json.loads(frame[len("data: "):])
                if "delta" in ev:
                    self._queued.append(ev["delta"])
                    self._text_parts.append(ev["delta"])
                    return True
                if ev.get("done"):
                    self._done = True
                    self.result = GenerationResult(
                        text="".join(self._text_parts), token_ids=[],
                        prompt_tokens=0,
                        gen_tokens=int(ev.get("tokens", 0)),
                        ttft_ms=float(ev.get("ttft_ms") or 0.0),
                        total_ms=float(ev.get("total_ms") or 0.0))
                    self._resp.close()
                    return True
                if "error" in ev:
                    self._done = True
                    self._resp.close()
                    raise RuntimeError(ev["error"])
                continue
            chunk = (self._resp.read1(65536) if hasattr(self._resp, "read1")
                     else self._resp.read(65536))
            if not chunk:
                self._done = True
                self._resp.close()
                return False
            self._buf += chunk
        return False

    def prime(self) -> None:
        """Pull the first event, so a setup error raises here."""
        if not self._queued and not self._done:
            self._read_frames()

    def close(self) -> None:
        """Drop the connection (a mid-stream kill, a consumer leaving)."""
        self._done = True
        try:
            self._resp.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            while self._queued:
                yield self._queued.pop(0)
            if self._done:
                return
            if not self._read_frames() and self._done:
                return
