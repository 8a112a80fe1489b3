"""The mesh over HTTP: the coordinator protocol across processes.

Counterpart of flow_pipeline_tpu/mesh/server.py. The in-process objects
(MeshCoordinator, MeshMember) speak method calls; this module carries
the same calls over HTTP, so a coordinator and N member processes run
the identical protocol:

    POST /mesh/join    {"member": id, "state_url": url|null,
                        "trace_url": url|null}
    POST /mesh/sync    {"member": id, "clock": {offset, rtt}|null}
    POST /mesh/submit?member=id   (octet-stream: a mesh/codec envelope)
    POST /mesh/leave   {"member": id}
    GET  /topk?model=M&k=N        the merged open window (fan-out)
    GET  /debug/lineage?model=M&slot=S   the window lineage ledger
    GET  /debug/trace             one clock-aligned Chrome trace of the
                                  mesh (the coordinator's lane and one
                                  per member, fetched from its
                                  /debug/trace)
    GET  /healthz /state          liveness and the protocol's state

``RemoteCoordinator`` stands in for a MeshCoordinator inside a member,
and ``MemberStateServer`` is the member's /meshstate endpoint that the
coordinator's /topk fan-out reads. Every outbound request has a timeout:
a peer may hang exactly when the mesh churns.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..obs.server import reply_json
from ..obs.trace import TRACER
from . import codec, scope
from .coordinator import MeshCoordinator

log = logging.getLogger("flow_pipeline_tpu_torch.mesh")

# one member's state or trace fetch; the trace fan-out's worker bound
FETCH_TIMEOUT = 5
TRACE_FANOUT = 8


def _url_provider(state_url: str):
    """A member's /meshstate URL as a coordinator provider: the codec
    bytes of its open window, or None (204) without one."""
    def provider(model: str):
        req = urllib.request.Request(
            f"{state_url}?model={urllib.parse.quote(model)}")
        with urllib.request.urlopen(req, timeout=FETCH_TIMEOUT) as resp:
            if resp.status == 204:
                return None
            return resp.read()
    return provider


class MeshCoordinatorServer:
    """The HTTP front of one MeshCoordinator, and the heartbeat expiry
    sweep (thread ``mesh-expiry``, every max(0.5, heartbeat / 2) s)."""

    def __init__(self, coordinator: MeshCoordinator, port: int = 8090,
                 host: str = "127.0.0.1"):
        self.coordinator = coordinator
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                url = urlparse(self.path)
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b""
                try:
                    if url.path == "/mesh/submit":
                        q = {k: v[0] for k, v in
                             parse_qs(url.query).items()}
                        out = outer.coordinator.submit(q["member"], body)
                    elif url.path in ("/mesh/join", "/mesh/sync",
                                      "/mesh/leave"):
                        req = json.loads(body or b"{}")
                        member = req["member"]
                        if url.path == "/mesh/join":
                            provider = (_url_provider(req["state_url"])
                                        if req.get("state_url") else None)
                            out = outer.coordinator.join(
                                member, provider=provider,
                                trace_url=req.get("trace_url"))
                        elif url.path == "/mesh/sync":
                            out = outer.coordinator.sync(
                                member, clock=req.get("clock"))
                        else:
                            outer.coordinator.leave(member)
                            out = {}
                    else:
                        self._reply(404, {"error": url.path})
                        return
                    self._reply(200, out)
                except (KeyError, ValueError) as e:
                    self._reply(400, {"error": str(e)})

            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    if url.path == "/topk":
                        k = int(q["k"]) if "k" in q else None
                        out = outer.coordinator.query_topk(
                            q.get("model"), k)
                    elif url.path == "/debug/lineage":
                        slot = int(q["slot"]) if "slot" in q else None
                        out = outer.coordinator.lineage(
                            q.get("model"), slot)
                    elif url.path == "/debug/trace":
                        out = outer.aggregated_trace()
                    elif url.path == "/healthz":
                        st = outer.coordinator.status()
                        out = {"ok": True, "epoch": st["epoch"],
                               "members": len(st["members"])}
                    elif url.path == "/state":
                        out = outer.coordinator.status()
                    else:
                        self._reply(404, {"error": url.path})
                        return
                    self._reply(200, out)
                except (KeyError, ValueError) as e:
                    # a malformed parameter (/topk?k=abc) is a 400
                    self._reply(400, {"error": str(e)})

            def _reply(self, code, obj):
                reply_json(self, obj, code, default=str)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mesh-http",
            daemon=True)
        self._sweep_stop = threading.Event()
        self._sweeper = threading.Thread(
            target=self._sweep, name="mesh-expiry", daemon=True)

    def _sweep(self) -> None:
        period = max(0.5, self.coordinator.heartbeat_timeout / 2)
        while not self._sweep_stop.wait(period):
            for mid in self.coordinator.expire():
                log.warning("mesh expiry: fenced silent member %s", mid)

    def aggregated_trace(self) -> dict:
        """One clock-aligned Chrome trace of the mesh: the coordinator's
        own ring is the reference lane; every live member that advertised
        a trace URL at join is fetched (at most TRACE_FANOUT at once,
        each within FETCH_TIMEOUT s) and aligned by its heartbeat clock
        offset, or without one by an estimate from this fetch's round
        trip (mesh/scope.py). A member that cannot be reached is logged
        and left out: it degrades the answer, never blanks it."""
        def fetch(source):
            mid, trace_url, offset, rtt = source
            t0 = time.time()
            try:
                with urllib.request.urlopen(
                        trace_url, timeout=FETCH_TIMEOUT) as resp:
                    tr = json.loads(resp.read().decode())
            except (OSError, ValueError) as e:
                log.warning("mesh trace: member %s trace fetch failed "
                            "(%s); aggregating without it", mid, e)
                return None
            t1 = time.time()
            if offset is None:
                now = (tr.get("otherData") or {}).get("now")
                if now is not None:
                    offset, rtt = scope.estimate_offset(t0, t1,
                                                        float(now))
                else:
                    offset, rtt = 0.0, 0.0
            return scope.TraceLane(mid, tr, offset, rtt)

        lanes = [scope.TraceLane("coordinator", TRACER.chrome_trace())]
        sources = self.coordinator.trace_sources()
        if sources:
            # concurrent: serial fetches would stack one timeout per dead
            # member onto the handler thread, during churn, when the
            # trace is wanted most
            with ThreadPoolExecutor(
                    max_workers=min(TRACE_FANOUT, len(sources))) as pool:
                lanes += [lane for lane in pool.map(fetch, sources)
                          if lane is not None]
        return scope.aggregate_traces(lanes)

    def start(self) -> "MeshCoordinatorServer":
        self._thread.start()
        self._sweeper.start()
        log.info("mesh coordinator on http://%s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._sweep_stop.set()
        self._server.shutdown()
        self._server.server_close()


class RemoteCoordinator:
    """A MeshCoordinator for a MeshMember, over HTTP."""

    def __init__(self, base_url: str, state_url: str | None = None,
                 timeout: float = 10.0,
                 trace_url: str | None = None):
        self.base_url = base_url.rstrip("/")
        self.state_url = state_url
        self.trace_url = trace_url
        self.timeout = timeout

    def _post_json(self, path: str, obj: dict) -> dict:
        req = urllib.request.Request(
            self.base_url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    def join(self, member_id: str, provider=None,
             trace_url: str | None = None) -> dict:
        # a provider callable cannot cross HTTP: the member's state URL
        # (MemberStateServer) takes its place, and the trace URL is where
        # the coordinator's /debug/trace fans out to
        return self._post_json("/mesh/join", {
            "member": member_id, "state_url": self.state_url,
            "trace_url": trace_url or self.trace_url})

    def sync(self, member_id: str, clock: dict | None = None) -> dict:
        return self._post_json("/mesh/sync",
                               {"member": member_id, "clock": clock})

    def leave(self, member_id: str) -> None:
        self._post_json("/mesh/leave", {"member": member_id})

    def submit(self, member_id: str, payload: bytes) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}/mesh/submit?member="
            f"{urllib.parse.quote(member_id)}",
            data=payload,
            headers={"Content-Type": "application/octet-stream"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())


class MemberStateServer:
    """A member's /meshstate endpoint for the coordinator's /topk
    fan-out (thread ``mesh-state``): ``?model=M`` answers the codec
    bytes of the member's open window, 204 without one, 404 without
    ``model``; /healthz answers liveness. The state is read under the
    member's worker lock (MeshMember._query_state)."""

    def __init__(self, member, port: int = 0, host: str = "127.0.0.1"):
        outer_member = member

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path == "/healthz":
                    reply_json(self, {"ok": True})
                    return
                if url.path != "/meshstate" or "model" not in q:
                    self.send_response(404)
                    self.end_headers()
                    return
                state = outer_member._query_state(q["model"])
                if state is None:
                    self.send_response(204)
                    self.end_headers()
                    return
                body = codec.encode(state)
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}/meshstate"
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mesh-state",
            daemon=True)

    def start(self) -> "MemberStateServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
