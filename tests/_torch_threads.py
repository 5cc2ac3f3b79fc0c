"""The torch thread count of the port's tests, set once per process by
importing this module (every ``tests/test_torch_*.py`` does).

The tier-1 run has 6 xdist workers on an 8-core host, each also running the
reference's XLA programs. At torch's default of one intra-op thread per core,
each worker's OpenMP pool spun over the same cores as the others': six
heavy port files took 530.6 s of wall time together under ``-n 6`` on such
a host, and 131.4 s with 2 threads (135.7 s with 1). The rank and worker
processes the tests start set ``OMP_NUM_THREADS=1`` themselves.
"""
import torch

THREADS = 2
torch.set_num_threads(THREADS)
