"""gRPC batch feed: external producers -> a colocated worker.

Counterpart of flow_pipeline_tpu/transport/feed.py, the same wire
contract without generated code (a raw bytes codec, so any language can
call it):

    service: /flowtpu.Feed/Publish   (unary)
      request:  a concatenation of length-prefixed FlowMessage frames
                (the -proto.fixedlen wire format producers already speak)
      response: 8-byte big-endian count of frames accepted

The server lands frames on an InProcessBus topic, where the normal
Consumer/StreamWorker loop reads them (``processor -listen.feed``): the
gRPC hop replaces Kafka for a colocated deployment, with the same
at-least-once offsets downstream.
"""

from __future__ import annotations

import logging
import struct
from concurrent import futures
from typing import Optional

from ..obs.metrics import REGISTRY
from ..schema import wire
from .bus import InProcessBus

log = logging.getLogger("flow_pipeline_tpu_torch.feed")

METHOD = "/flowtpu.Feed/Publish"

_IMPORT_ERROR: Optional[str] = None
try:  # the grpcio package is optional
    import grpc
except Exception as e:  # noqa: BLE001
    grpc = None
    _IMPORT_ERROR = str(e)


def available() -> bool:
    return grpc is not None


class FeedServer:
    """Receives frame blobs over gRPC and produces them onto a bus topic
    (port 0 in ``address`` picks a free port: ``.port``)."""

    def __init__(self, bus: InProcessBus, topic: str = "flows",
                 address: str = "127.0.0.1:0", max_workers: int = 4):
        if not available():
            raise RuntimeError(f"grpcio not importable ({_IMPORT_ERROR})")
        self.bus = bus
        self.topic = topic
        bus.create_topic(topic)
        self.m_frames = REGISTRY.counter("feed_frames_total",
                                         "frames accepted over the feed")
        self.m_bytes = REGISTRY.counter("feed_bytes_total",
                                        "payload bytes over the feed")

        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != METHOD:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    outer._publish, request_deserializer=None,
                    response_serializer=None)

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((Handler(),))
        self.port = self._server.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"feed could not bind {address!r}")

    def _publish(self, request: bytes, context) -> bytes:
        # validate the whole stream before producing anything: a malformed
        # tail must not leave a partial batch on the bus (the client
        # retries the whole blob)
        try:
            frames = list(wire.iter_raw_frames(request))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"malformed frame stream: {e}")
        self.bus.produce_many(self.topic, frames)
        self.m_frames.inc(len(frames))
        self.m_bytes.inc(len(request))
        return struct.pack(">Q", len(frames))

    def start(self) -> "FeedServer":
        self._server.start()
        log.info("feed listening on port %d", self.port)
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait()


class FeedClient:
    """Publishes frames or columnar batches to a FeedServer."""

    def __init__(self, target: str):
        if not available():
            raise RuntimeError(f"grpcio not importable ({_IMPORT_ERROR})")
        self._channel = grpc.insecure_channel(target)
        self._publish = self._channel.unary_unary(
            METHOD, request_serializer=None, response_deserializer=None)

    def publish_frames(self, data: bytes) -> int:
        """Send pre-framed bytes; returns the frames accepted."""
        return struct.unpack(">Q", self._publish(data))[0]

    def publish_batch(self, batch) -> int:
        """A columnar batch as one frame stream."""
        return self.publish_frames(batch.to_wire())

    def close(self) -> None:
        self._channel.close()
