"""utils/device.resolve_device under a process group, with ``torch.cuda``
mocked (this host has no card): a rank takes the card ``rank %
device_count`` and makes it current before anything is allocated; an index
nobody asked for is refused. And parallel/distributed.initialize's mapping
of ``--fwt_hosts/--fwt_host_id/--fwt_coordinator`` onto
``torch.distributed.init_process_group``."""

import datetime

import pytest
import torch

from fwumious_wabbit_tpu_torch.parallel import distributed
from fwumious_wabbit_tpu_torch.utils import device as dev


@pytest.fixture
def two_cards(monkeypatch):
    """A host of two cards; the list of set_device calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(dev, "_local_index", None)
    return calls


def test_rank_one_of_a_two_card_host_gets_cuda_1(two_cards):
    assert dev.resolve_device("cuda", rank=1) == torch.device("cuda:1")
    assert two_cards == [1]
    # afterwards the asked-for index is this process's card
    assert dev.resolve_device() == torch.device("cuda:1")
    assert dev.resolve_device("cuda:1") == torch.device("cuda:1")
    with pytest.raises(ValueError, match="cuda:1"):
        dev.resolve_device("cuda:0")


def test_ranks_wrap_around_the_cards(two_cards):
    assert dev.resolve_device(None, rank=2) == torch.device("cuda:0")
    assert dev.resolve_device("gpu", rank=3) == torch.device("cuda:1")
    assert two_cards == [0, 1]


def test_an_index_nobody_asked_for_is_refused(two_cards):
    with pytest.raises(ValueError, match="a process runs on one card"):
        dev.resolve_device("cuda:1")
    assert dev.resolve_device("cuda") == torch.device("cuda:0")
    assert two_cards == []  # no process group asked: the current card stays


def test_the_cpu_takes_no_card(two_cards):
    assert dev.resolve_device("cpu") == torch.device("cpu")
    assert two_cards == []


def test_initialize_maps_the_flags(two_cards, monkeypatch):
    seen = {}
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: seen["backend"])
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    assert distributed.initialize("host0:7755", 4, 3, None) == torch.device("cuda:1")
    assert seen == {"backend": "nccl", "init_method": "tcp://host0:7755",
                    "world_size": 4, "rank": 3,
                    "timeout": datetime.timedelta(seconds=300),
                    "device_id": torch.device("cuda:1")}
    assert two_cards == [1]
    assert distributed.initialize("host0:7755", 4, 2, "cpu") == torch.device("cpu")
    assert seen["backend"] == "gloo" and seen["rank"] == 2
    assert seen["device_id"] is None
    with pytest.raises(ValueError, match="--fwt_host_id 4"):
        distributed.initialize("host0:7755", 4, 4, "cpu")
    with pytest.raises(ValueError, match="--fwt_coordinator"):
        distributed.initialize(None, 4, 0, "cpu")
    assert distributed.wanted("h:1", None) and distributed.wanted(None, 2)
    assert not distributed.wanted(None, None) and not distributed.wanted(None, 1)
