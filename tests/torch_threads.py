"""One intra-op thread for the port's tests of many small ops.

PyTorch starts as many intra-op threads as the machine has cores in every
process. The tier-1 run holds several test workers at once, and a file of
small ops (a trainer at E = 2, h = 16) then spends its time with those
threads waiting on each other: such a file ran 12× slower beside five
other workers than alone. Import ``one_torch_thread`` into a test module
to run its tests on one thread; the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
