"""PyTorch + CUDA port of flow_pipeline_tpu.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and is held against it by the tests. This package
imports torch and numpy and nothing of the JAX package.

What is ported so far is the per-model heavy-hitter path of the
processor (frames -> bus -> consumer -> StreamWorker ->
WindowedHeavyHitter -> HeavyHitterModel -> sqlite), with the conservative
count-min update as a hand-written CUDA kernel (ops/cms_cuda.py,
csrc/cms_conservative.cu). ROADMAP.md lists what is still to come.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
