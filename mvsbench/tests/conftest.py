"""Fixtures of the benchmark's CPU tests."""
import pytest
import torch

from mvsbench import files

from inline_cvp import CVP_CONFIG, cvp_cell


@pytest.fixture
def cvp(monkeypatch) -> dict:
    """The CVP cell; `files.config` finds its inline configuration."""
    config = files.config
    monkeypatch.setattr(files, "config", lambda name: (
        dict(CVP_CONFIG) if name == CVP_CONFIG["name"] else config(name)))
    return cvp_cell()


@pytest.fixture
def one_thread():
    """One intra-op thread: CPU results in the last bits depend on the
    thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
