"""Multi-host initialization of the port (``parallel/multihost.py``):
``init_multihost`` is a no-op on one process and forms the default group
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) on a spawned gloo world of 2 ranks
(``tests/_torch_dist.py``; the rendezvous on 127.0.0.1), where one
all-reduce then runs; a second call returns the same (rank, world)."""

import socket

import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one torch thread per worker)
from tests._torch_dist import run_worlds
from wrinklefree_tpu_torch.parallel.multihost import init_multihost


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world():
    return run_worlds((2,), "mesh_cases", dict(local_world=2, port=_free_port()))[2]


def test_init_multihost_noop_without_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_multihost() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_multihost() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_init_multihost_needs_rank(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        init_multihost()


def test_init_multihost_from_torchrun_env(world):
    for r, out in enumerate(world):
        assert out["init"] == (r, 2) and out["again"] == (r, 2)
        assert out["init_sum"] == 2.0


def test_world_of_two_mesh(world):
    """LOCAL_WORLD_SIZE 2: the default global mesh of 2 ranks is 1 x 2."""
    for r, out in enumerate(world):
        shape, d, m, model_ranks, data_ranks, leader = out["default"]
        assert shape == {"data": 1, "model": 2} and (d, m) == (0, r)
        assert model_ranks == (0, 1) and data_ranks == (r,) and leader == 0
        assert out["model_psum"] == 1.0 and out["gather"] == [[0.0, 1.0]] * 2
