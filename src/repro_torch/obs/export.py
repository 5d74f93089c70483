"""HTTP export surface: /metrics, /healthz, /traces on a stdlib server.

One `ThreadingHTTPServer` serving three read-only endpoints:

- ``/metrics``  — Prometheus text exposition from a MetricsRegistry.
- ``/healthz``  — ``ok`` + 200 while the server is up (liveness only;
  readiness is the caller's business).
- ``/traces``   — recent finished traces as JSONL, newest last;
  ``?n=K`` limits to the last K, ``?id=T`` returns one trace.

Runs on a daemon thread; ``port=0`` binds an ephemeral port (the bound
port is on ``server.port``), which is what tests and the serve smoke
use.  No auth, no TLS — bind to localhost unless you mean it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .metrics import MetricsRegistry
from .trace import Tracer

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve a registry (+ optional tracer) over HTTP.  Context manager:
    ``with MetricsServer(reg, tracer, port=0) as srv: ... srv.port``."""

    def __init__(self, registry: MetricsRegistry,
                 tracer: Tracer | None = None, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.registry = registry
        self.tracer = tracer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: per-request stderr logging would swamp the loadgen
            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._send(200, outer.registry.render(),
                                   PROM_CONTENT_TYPE)
                    elif url.path == "/healthz":
                        self._send(200, "ok\n", "text/plain")
                    elif url.path == "/traces":
                        self._traces(parse_qs(url.query))
                    else:
                        self._send(404, "not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as exc:  # surface, don't kill the thread
                    self._send(500, f"error: {exc!r}\n", "text/plain")

            def _traces(self, q):
                if outer.tracer is None:
                    self._send(404, "no tracer attached\n", "text/plain")
                    return
                if "id" in q:
                    tr = outer.tracer.get(int(q["id"][0]))
                    if tr is None:
                        self._send(404, "trace not in ring\n",
                                   "text/plain")
                        return
                    body = json.dumps(tr.to_dict(), separators=(",", ":"))
                    self._send(200, body + "\n", "application/json")
                    return
                n = int(q["n"][0]) if "n" in q else None
                body = outer.tracer.to_jsonl(n)
                self._send(200, body + ("\n" if body else ""),
                           "application/x-ndjson")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
