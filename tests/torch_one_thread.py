"""The port's CPU tests run PyTorch's operators on one thread.

They drive reduced models whose tensors hold a few KB, where intra-op
threads cost more than they save: a reduced olmo-1b train step took 0.61 s
at PyTorch's default of 8 threads and 0.041 s at one, on an 8-core host.
Under pytest-xdist each worker would start a pool as wide as the host, and
the pools of the workers and of the spawned rank worlds compete for the
same cores.  Every ``tests/test_torch_*.py`` that uses PyTorch imports this
module, so a worker sets it while it collects; spawned ranks already run on
one thread (``repro_torch.launch.mesh.run_world``).
"""

import torch

torch.set_num_threads(1)
