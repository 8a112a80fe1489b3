"""Schema core: FlowMessage, its protobuf wire codec, the columnar
FlowBatch layout, and the murmur3 key hash (copies of the JAX package's
numpy modules, plus a torch ``hash_words``)."""

from .message import FlowMessage, FlowType, FIELDS
from .wire import (
    encode_message,
    decode_message,
    encode_frame,
    decode_frames,
    encode_stream,
)
from .batch import FlowBatch, COLUMNS

__all__ = [
    "FlowMessage",
    "FlowType",
    "FIELDS",
    "encode_message",
    "decode_message",
    "encode_frame",
    "decode_frames",
    "encode_stream",
    "FlowBatch",
    "COLUMNS",
]
