"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers on one host.  When each worker's
torch thread pool spans every core, the port's many small CPU ops spend
their time contending for the cores: a test that takes 1 s alone took
100 s under the 6-worker Tier-1 run.  Every ``tests/test_torch_*.py`` file
imports ``one_torch_thread`` (an autouse fixture, so importing it turns it
on for that module): torch runs one intra-op thread for the module, and the
processes the module spawns (CLI subprocesses, ``run_ranks``'s ranks) get
``OMP_NUM_THREADS=1``.  What a test computes does not change."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env


def test_one_torch_thread_in_this_module():
    assert torch.get_num_threads() == 1 and os.environ["OMP_NUM_THREADS"] == "1"
