"""An autouse fixture that gives torch one intra-op thread while a test
module runs. Import it into a module to apply it there:

    from torch_threads import one_torch_thread  # noqa: F401

The port's CPU tests run models a few layers wide, where torch's thread
pool buys nothing, and when several test processes share the cores its
spinning threads slow them by orders of magnitude: six copies of
test_torch_spec_decode.py's sampling test on 8 cores took ~835 s each at
torch's default of 8 threads and ~4 s each at 1."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
