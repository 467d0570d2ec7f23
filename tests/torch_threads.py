"""One intra-op thread for the port's CPU tests.

The suite runs its files in parallel worker processes on a few cores.
There torch's intra-op threads only contend: each operation large enough
to be split waits for threads that the other workers hold, and the
kernels' plain versions (thousands of small operations a render) or a
model's layers then run many times slower than on one thread. Each
tests/test_torch_*.py module imports `one_intra_op_thread`, which pytest
then uses for that module (autouse), restoring the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
