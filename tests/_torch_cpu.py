"""Imported by the port's CPU tests: torch runs its CPU ops on one thread.

The tier-1 command runs the suite in six pytest-xdist workers at once. At
the tiny model's sizes a torch op is microseconds of work, and a pool of
intra-op threads in every worker, each waiting at every op's barrier while
the other workers hold the cores, made the port's engine tests many times
slower than on one thread: under eight busy processes, the penalties-routing
test of ``test_torch_heads_engine.py`` took 36 s on torch's default threads
and 1.4 s on one.
"""

import torch

torch.set_num_threads(1)
