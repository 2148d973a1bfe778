"""Minimal stdlib-only WSGI web framework with a Flask-compatible surface.

The port's own copy of ``distributed_llm_tpu/utils/webapp.py``: the
machine with the card has no Flask, so the port serves through this
subset (``Flask``, ``@app.route``, ``jsonify``, the ``request`` proxy's
``get_json`` and ``args``, tuple ``(response, status)`` returns, CORS
preflight answers, ``app.test_client()`` and a threaded ``app.run()`` on
wsgiref).
"""

from __future__ import annotations

import json
import threading
from socketserver import ThreadingMixIn
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit
from wsgiref.simple_server import WSGIServer, make_server

_local = threading.local()


class Request:
    def __init__(self, method: str, path: str, body: bytes,
                 content_type: str = "application/json", query: str = ""):
        self.method = method
        self.path = path
        self.args = _Args(parse_qs(query))
        self._body = body
        self.content_type = content_type

    def get_json(self, silent: bool = False) -> Optional[Any]:
        try:
            return json.loads(self._body.decode("utf-8")) if self._body else None
        except (ValueError, UnicodeDecodeError):
            if silent:
                return None
            raise


class _Args:
    def __init__(self, parsed: Dict[str, List[str]]):
        self._parsed = parsed

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        vals = self._parsed.get(key)
        return vals[0] if vals else default


class _RequestProxy:
    """Thread-local stand-in for flask.request."""

    def __getattr__(self, name: str) -> Any:
        req = getattr(_local, "request", None)
        if req is None:
            raise RuntimeError("no request context")
        return getattr(req, name)


request = _RequestProxy()


class Response:
    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = "application/json"):
        self.body = body
        self.status_code = status
        self.content_type = content_type

    def get_json(self) -> Any:
        return json.loads(self.body.decode("utf-8")) if self.body else None

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")


def jsonify(obj: Any = None, **kwargs: Any) -> Response:
    payload = kwargs if kwargs else obj
    return Response(json.dumps(payload).encode("utf-8"))


class StreamingResponse(Response):
    """Chunked response: body is produced by an iterator of str/bytes
    (used for SSE streaming; WSGI yields each chunk as it arrives)."""

    def __init__(self, chunks: Iterable[Any],
                 content_type: str = "text/event-stream"):
        super().__init__(b"", 200, content_type)
        self.chunks = chunks

    def iter_encoded(self) -> Iterable[bytes]:
        for chunk in self.chunks:
            yield chunk.encode("utf-8") if isinstance(chunk, str) else chunk

    @property
    def text(self) -> str:
        # Draining for tests: consume the iterator once.
        if not self.body:
            self.body = b"".join(self.iter_encoded())
        return self.body.decode("utf-8", errors="replace")


def _coerce(rv: Any) -> Response:
    status = 200
    if isinstance(rv, tuple):
        rv, status = rv
    if isinstance(rv, Response):
        rv.status_code = status if status != 200 else rv.status_code
        return rv
    if isinstance(rv, (dict, list)):
        resp = jsonify(rv)
        resp.status_code = status
        return resp
    if isinstance(rv, str):
        return Response(rv.encode("utf-8"), status, "text/plain; charset=utf-8")
    if isinstance(rv, bytes):
        return Response(rv, status, "application/octet-stream")
    raise TypeError(f"unsupported view return type: {type(rv)}")


class Flask:
    def __init__(self, name: str):
        self.name = name
        self.extensions: Dict[str, Any] = {}
        self._routes: Dict[Tuple[str, str], Callable[[], Any]] = {}

    def route(self, path: str, methods: Optional[Iterable[str]] = None):
        methods = [m.upper() for m in (methods or ["GET"])]

        def deco(fn: Callable[[], Any]):
            for m in methods:
                self._routes[(m, path)] = fn
            return fn
        return deco

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, req: Request) -> Response:
        fn = self._routes.get((req.method, req.path))
        if fn is None:
            methods = sorted({m for (m, p) in self._routes if p == req.path})
            if req.method == "OPTIONS" and methods:
                # CORS preflight of a browser frontend on another origin.
                resp = Response(b"", 204)
                resp.allow_methods = ", ".join(methods + ["OPTIONS"])
                return resp
            if methods:
                return Response(b'{"error": "method not allowed"}', 405)
            return Response(b'{"error": "not found"}', 404)
        _local.request = req
        try:
            return _coerce(fn())
        except Exception as exc:
            return Response(
                json.dumps({"error": f"internal error: {exc}"}).encode(), 500)
        finally:
            _local.request = None

    # -- WSGI --------------------------------------------------------------

    def __call__(self, environ, start_response):
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        body = environ["wsgi.input"].read(length) if length else b""
        req = Request(
            method=environ.get("REQUEST_METHOD", "GET").upper(),
            path=environ.get("PATH_INFO", "/"),
            body=body,
            content_type=environ.get("CONTENT_TYPE", ""),
            query=environ.get("QUERY_STRING", ""),
        )
        resp = self._dispatch(req)
        streaming = isinstance(resp, StreamingResponse)
        headers = [("Content-Type", resp.content_type),
                   ("Access-Control-Allow-Origin", "*"),
                   ("Access-Control-Allow-Headers", "Content-Type")]
        allow = getattr(resp, "allow_methods", None)
        if allow:
            headers.append(("Access-Control-Allow-Methods", allow))
        if not streaming:
            headers.append(("Content-Length", str(len(resp.body))))
        start_response(
            f"{resp.status_code} {_STATUS.get(resp.status_code, 'OK')}",
            headers)
        if streaming:
            return resp.iter_encoded()
        return [resp.body]

    def run(self, host: str = "127.0.0.1", port: int = 8000,
            threaded: bool = True, debug: bool = False) -> None:
        server_cls = _ThreadingWSGIServer if threaded else WSGIServer
        with make_server(host, port, self, server_class=server_cls) as httpd:
            httpd.serve_forever()

    # -- test client (flask-compatible subset) -----------------------------

    def test_client(self) -> "TestClient":
        return TestClient(self)


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class TestClient:
    def __init__(self, app: Flask):
        self.app = app

    def open(self, path: str, method: str = "GET",
             json_body: Any = None) -> Response:
        body = (json.dumps(json_body).encode("utf-8")
                if json_body is not None else b"")
        split = urlsplit(path)
        req = Request(method=method.upper(), path=split.path, body=body,
                      query=split.query)
        return self.app._dispatch(req)

    def get(self, path: str, **kw) -> Response:
        return self.open(path, "GET", kw.get("json"))

    def post(self, path: str, **kw) -> Response:
        return self.open(path, "POST", kw.get("json"))

    def delete(self, path: str, **kw) -> Response:
        return self.open(path, "DELETE", kw.get("json"))


_STATUS = {200: "OK", 204: "No Content", 400: "Bad Request",
           404: "Not Found", 405: "Method Not Allowed",
           500: "Internal Server Error", 501: "Not Implemented",
           503: "Service Unavailable", 504: "Gateway Timeout"}
