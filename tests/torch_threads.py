"""A fixture that runs a test with two torch intra-op threads.

The tier-1 command runs six pytest workers on one host; torch's default of
one thread per core in every worker oversubscribes the CPU several times
over, and the port's heavier CPU tests (ICP sweeps, HEM, the CLI flow's 80
photometric steps) then slow every worker down. Test modules opt in with
`pytestmark = pytest.mark.usefixtures("two_torch_threads")` after importing
the fixture.
"""

import pytest
import torch


@pytest.fixture
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)
