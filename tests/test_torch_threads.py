"""torch's CPU threads in each pytest-xdist worker: the cores over the workers.

torch keeps one intra-op thread a core by default. Under ``-n W`` every one
of the W workers would do so, and W workers each running a thread a core
spin against each other: two KIVI prefill cases that take 3 s with one
thread a worker took 525 s each with six workers at eight threads on eight
cores. Every xdist worker imports every test file when it collects, before
any test runs, so setting the count here, at import, caps it for the whole
run; without xdist (W = 1) the count stays one thread a core.
"""

import os

import torch


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity query on this platform
        return os.cpu_count() or 1


CORES = _cores()
WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, CORES // WORKERS)
torch.set_num_threads(THREADS)


def test_torch_threads_are_the_cores_over_the_workers():
    assert torch.get_num_threads() == THREADS
    assert THREADS * WORKERS <= max(CORES, WORKERS)
