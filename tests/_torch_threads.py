"""A module fixture for the port's heavier test files: torch's CPU threads
held at THREADS while the module runs, then given back.

The suite runs in several worker processes on one host. torch's default
team of one thread per core in every worker oversubscribes the host many
times over, and its OpenMP threads spin while they wait, so a file that
takes a minute alone takes several beside the others. A module imports
`few_threads` (autouse) only where every comparison it makes is within this
process or against mmtpu at tolerances far above a change of summation
order: the thread count moves a float32 result by an ulp or so, and a
comparison with ranks that a launch starts at their own thread count would
see it. Processes the module starts inherit OMP_WAIT_POLICY=PASSIVE, which
changes how their threads wait, not what they compute."""

import contextlib
import os

import pytest
import torch

THREADS = 2


@contextlib.contextmanager
def _passive_waits():
    policy = os.environ.get("OMP_WAIT_POLICY")
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    try:
        yield
    finally:
        if policy is None:
            os.environ.pop("OMP_WAIT_POLICY", None)
        else:
            os.environ["OMP_WAIT_POLICY"] = policy


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with _passive_waits():
            yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def passive_children():
    """Only the processes the module starts wait passively (their thread
    counts, hence their arithmetic, stay as they were)."""
    with _passive_waits():
        yield
