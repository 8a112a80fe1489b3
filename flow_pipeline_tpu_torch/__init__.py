"""PyTorch + CUDA port of flow_pipeline_tpu.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and is held against it by the tests. This package
imports torch and numpy and nothing of the JAX package.

What is ported so far is the processor's per-model path with the
reference's default model set (frames -> bus -> consumer -> StreamWorker
-> flows_5m, the heavy-hitter families, the port tables and the DDoS
detector -> sqlite), with both count-min updates as hand-written CUDA
kernels (ops/cms_cuda.py; csrc/cms_conservative.cu on the default path,
csrc/cms_linear.cu for families built with conservative=False).
ROADMAP.md lists what is still to come.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
