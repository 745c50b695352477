"""The PyTorch port's CPU tests run with one intra-op thread a process.

The tier-1 command runs the suite in six xdist workers on an eight-core
host. Each worker's PyTorch would start an OpenMP pool of one thread a
core, and the port's tests are many small-tensor operations: six such
pools oversubscribe the cores, and their threads spin while waiting. With
one thread a worker, six of the heaviest port test files
(`test_torch_{twophase,train,model,multi_task,lightconv,ctc}.py`, 162
tests, `-n 6 --dist load`) took 185.5 s where they took 221.4 s with the
default pools, on the same host one after the other.

Every worker imports every test module when it collects, so the setting
below holds for the whole worker process, whichever tests it runs."""

import torch

torch.set_num_threads(1)


def test_one_intra_op_thread_a_worker():
    assert torch.get_num_threads() == 1
