"""The ``one_thread`` fixture, shared by the port's test files that drive
many small torch ops (the engine, the streaming driver, the launcher,
the trainer and the examples): torch's CPU ops run on one intra-op
thread while the module's tests run, and on as many as before after.

Beside the suite's other workers, torch's default intra-op threads
oversubscribe the cores, and a step of many small ops waits on their
barriers: an engine test that takes ~1.7 s alone took minutes under
that load, and well under a second on one thread. Import the fixture
into a test module to apply it there (it is autouse)::

    from torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
