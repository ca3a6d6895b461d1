"""Torch's CPU threads when pytest-xdist runs the suite in several workers.

Each worker process starts with torch's default of one intra-op thread a
core, so ``-n 6`` on 8 cores keeps 48 threads busy and the port's CPU
tests, which are torch-bound, wait on one another: a test that takes
0.4 s alone took 150 s in the suite. ``share_cores`` gives a worker its
share of the cores (at least one thread); a run in one process keeps
torch's default."""

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
