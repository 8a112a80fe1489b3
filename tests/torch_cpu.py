"""Torch on the CPU in the port's tests: one intra-op thread.

The tier-1 suite runs six worker processes at once. Torch's intra-op
pool (a thread per core by default) then oversubscribes the cores
several times over, and its threads spin between parallel regions. The
port's tests work on tensors of a few thousand rows, where one thread is
as fast as the pool alone and several times faster under the suite's
load. Every port test file that runs on the CPU imports this module.
"""

import torch

torch.set_num_threads(1)
