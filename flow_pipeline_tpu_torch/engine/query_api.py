"""Live query API: aggregates served straight off a running worker's
models, the window still open included.

Counterpart of flow_pipeline_tpu/engine/query_api.py for one worker (the
mesh is not ported):

    GET /healthz            liveness and progress counters
    GET /topk?model=X&k=N   the open window's top-K from the sketch
    GET /windows?model=X    open exact-window slots and their row counts
    GET /alerts?limit=N     recent DDoS alerts

Handlers take the worker's lock (held across each step), so a query sees
consistent state and never races a flush. On the card ``/topk`` reads
the model's state there (``model.top``), as the window close does. With
``serve`` (the serving tier's SnapshotStore, ``-serve.addr``) ``/topk``
first tries the newest snapshot WITHOUT the lock: a snapshot that covers
the exact consumed point (its ``flows_seen`` equals the worker's) answers
what the locked read would, word for word; anything staler falls back to
the locked path.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..models.ddos import DDoSDetector
from ..models.window_agg import WindowAggregator
from ..obs.server import reply_json
from ..sink.base import rows_to_records
from .windowed import WindowedHeavyHitter

log = logging.getLogger("flow_pipeline_tpu_torch.query")


class QueryServer:
    """HTTP query endpoint over a StreamWorker's models (port 0 picks a
    free port: ``.port``)."""

    def __init__(self, worker, port: int = 8082, host: str = "127.0.0.1",
                 serve=None):
        self.worker = worker
        self.serve = serve
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    handler = {
                        "/healthz": outer._healthz,
                        "/topk": outer._topk,
                        "/windows": outer._windows,
                        "/alerts": outer._alerts,
                    }.get(url.path)
                    if handler is None:
                        reply_json(self, {"error":
                                          f"unknown path {url.path}"}, 404)
                        return
                    if url.path == "/topk":
                        # the snapshot first, outside the lock: a fresh one
                        # answers without stalling (or being stalled by)
                        # the worker
                        result = outer._topk_from_snapshot(q)
                        if result is not None:
                            reply_json(self, result, default=str)
                            return
                    with outer.worker.lock:  # a consistent view
                        result = handler(q)
                    reply_json(self, result, default=str)
                except (KeyError, ValueError) as e:
                    # malformed parameters and unknown models: 400
                    reply_json(self, {"error": str(e)}, 400)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="query-http",
            daemon=True)

    # ---- endpoints --------------------------------------------------------

    def _healthz(self, q) -> dict:
        return {
            "ok": True,
            "flows_seen": self.worker.flows_seen,
            "batches_seen": self.worker.batches_seen,
            "models": list(self.worker.models),
        }

    def _model(self, q, want_type):
        name = q.get("model")
        if name:
            model = self.worker.models.get(name)
            if model is None:
                raise KeyError(f"no model named {name!r}")
            return name, model
        for name, model in self.worker.models.items():
            if isinstance(model, want_type):
                return name, model
        raise KeyError(f"no model of kind {want_type.__name__} configured")

    def _topk_from_snapshot(self, q):
        """Lock-free /topk off the serving tier's snapshot, or None when
        the snapshot cannot answer VERBATIM what the locked path would:
        it must cover the exact consumed point (``flows_seen``: reading
        the worker's counter is one attribute load), know the requested
        model, and hold at least k extracted rows. The dict is shaped
        exactly like the locked ``_topk``'s."""
        if self.serve is None:
            return None
        snap = self.serve.current
        if snap is None or snap.source != "worker" or \
                snap.flows_seen != self.worker.flows_seen:
            return None
        name = q.get("model")
        if name:
            fam = snap.families.get(name)
        else:
            fam = next(iter(snap.families.values()), None)
        k = int(q.get("k", 10))
        if fam is None or k < 0 or k > fam.depth:
            # the locked path serves (or errors) instead: a negative k
            # would slice from the END here but not there
            return None
        rows = {col: arr[:k] for col, arr in fam.rows.items()}
        return {
            "model": fam.name,
            "window_start": fam.window_start,
            "rows": rows_to_records(rows),
        }

    def _topk(self, q) -> dict:
        name, model = self._model(q, WindowedHeavyHitter)
        if not isinstance(model, WindowedHeavyHitter):
            raise ValueError(f"model {name!r} has no top-K surface")
        # the host sketch backend keeps state in its engine between syncs
        self.worker.sync_sketch_states()
        k = int(q.get("k", 10))
        top = model.model.top(k)
        return {
            "model": name,
            "window_start": model.current_slot,
            "rows": rows_to_records(top),
        }

    def _windows(self, q) -> dict:
        name, model = self._model(q, WindowAggregator)
        if not isinstance(model, WindowAggregator):
            raise ValueError(f"model {name!r} is not a window aggregator")
        model._drain()
        return {
            "model": name,
            "watermark": model.watermark,
            "open_windows": [
                {"timeslot": slot, "groups": len(store)}
                for slot, store in sorted(model.windows.items())
            ],
        }

    def _alerts(self, q) -> dict:
        limit = int(q.get("limit", 50))
        out = []
        for name, model in self.worker.models.items():
            if isinstance(model, DDoSDetector):
                # `recent` is kept for queries; `alerts` drains to sinks
                out.extend({**a, "model": name}
                           for a in list(model.recent)[-limit:])
        return {"alerts": rows_to_records(out)}

    # ---- lifecycle --------------------------------------------------------

    def start(self) -> "QueryServer":
        self._thread.start()
        log.info("query api on http://%s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
