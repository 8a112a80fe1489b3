"""HTTP ``/metrics`` endpoint, ``/healthz``, and the trace ring's
``/debug/trace`` dump (Chrome trace-event JSON).

A copy of flow_pipeline_tpu/obs/server.py (stdlib only).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import REGISTRY, MetricsRegistry


def reply_json(handler: BaseHTTPRequestHandler, obj,
               code: int = 200, default=None) -> None:
    """Write one JSON response on a BaseHTTPRequestHandler. ``default``
    passes through to json.dumps for payloads with non-JSON leaves."""
    body = json.dumps(obj, default=default).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class MetricsServer:
    """Background /metrics server. Port 0 picks a free port (tests)."""

    def __init__(self, port: int = 8081, registry: MetricsRegistry = REGISTRY,
                 host: str = "127.0.0.1"):
        registry_ref = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/debug/trace":
                    # flight-recorder snapshot: the last ring's worth of
                    # per-chunk spans across the pipeline threads, with
                    # this process's wall clock at the fetch
                    import time

                    from .trace import TRACER

                    doc = TRACER.chrome_trace()
                    doc["otherData"]["now"] = time.time()
                    reply_json(self, doc)
                    return
                if self.path == "/healthz":
                    # liveness for compose healthchecks / orchestrators
                    reply_json(self, {"ok": True})
                    return
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = registry_ref.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-http", daemon=True
        )

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
