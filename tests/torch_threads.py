"""Caps torch's CPU threads in a test process at the cores shared among the
pytest-xdist workers: one thread each under ``-n 6`` on 8 cores, every core
when the tests run serially.

Every ``tests/test_torch_*.py`` imports this module before any torch work.
At torch's default of one OpenMP thread a core, six workers ran 48 spinning
threads on 8 cores, and a port test file that takes ~10 s alone took over
600 s among them.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))
