"""The host sketch dataplane (``-sketch.backend host``).

Counterpart of flow_pipeline_tpu/hostsketch/: the heavy-hitter families
run on the host in uint64 C++ (native/hostsketch.cc, through the port's
ctypes layer), driven through the group tables the host-grouped pipeline
builds (engine/hostfused.py) or in one fused native pass per family tree
(native/flowfused.cc, ``-ingest.fused``); only the dense port scatters
and the DDoS accumulate stay on the models' device. The numpy twins in
engine.py are the plain versions the native kernels are held against.
State converts losslessly to and from the models' (state.py), so a
checkpoint written under either backend, by either package, restores
under the other.
"""

from .engine import HostSketchEngine, sketch_backend_available
from .pipeline import HostSketchPipeline
from .state import HostHHState, HostInvState

__all__ = ["HostHHState", "HostInvState", "HostSketchEngine",
           "HostSketchPipeline", "sketch_backend_available"]
