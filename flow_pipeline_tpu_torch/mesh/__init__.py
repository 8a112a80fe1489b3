"""The mesh's state codec (codec.py), the part the serving tier's
subscription feed (gateway/delta.py) needs. The rest of the reference's
flow_pipeline_tpu/mesh (merge, journal, runtime, coordinator, members)
is not ported yet."""

from .codec import capture_model, decode, encode

__all__ = ["capture_model", "decode", "encode"]
