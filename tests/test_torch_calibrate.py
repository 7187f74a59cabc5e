"""The port's `CapsCalibrator` (`repro_torch.batching.calibrate`) keys and
stores caps as the reference's does: `graph_fingerprint`, the cache key
and the calibrated caps equal the reference's on tiny, a caps file
written by either package hits in the other, and a corrupt file or entry
is a cache miss that recalibrates (tests/test_resilience_gnn.py:302-335).
"""
import json
import os

import pytest

from repro.batching import CapsCalibrator as CapsCalibratorJ
from repro.batching import graph_fingerprint as graph_fingerprint_j
from repro.batching import make_policy as make_policy_j
from repro.core import minibatch as mb_j
from repro_torch.batching import (CapsCalibrator, graph_fingerprint,
                                  make_policy)
from repro_torch.core import minibatch as mb
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic

B, FANOUTS = 256, (5, 5)


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


def _no_probe(*a, **k):
    raise AssertionError("a cache hit must not recalibrate")


def test_graph_fingerprint_equals_reference(tiny_graph, tiny_t):
    assert graph_fingerprint(tiny_t) == graph_fingerprint_j(tiny_graph)


@pytest.mark.parametrize("policy", ["rand", "comm_rand"])
def test_key_and_caps_equal_reference(tiny_graph, tiny_t, policy):
    cal, cal_j = CapsCalibrator(n_probe=2, seed=1), \
        CapsCalibratorJ(n_probe=2, seed=1)
    assert cal.key(tiny_t, make_policy(policy), B, FANOUTS) == \
        cal_j.key(tiny_graph, make_policy_j(policy), B, FANOUTS)
    assert cal.caps_for(tiny_t, make_policy(policy), B, FANOUTS) == \
        cal_j.caps_for(tiny_graph, make_policy_j(policy), B, FANOUTS)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_caps_file_hits_in_the_other_package(tiny_graph, tiny_t, tmp_path,
                                             monkeypatch, writer):
    path = str(tmp_path / "caps.json")
    port = CapsCalibrator(cache_path=path, n_probe=2, seed=0)
    ref = CapsCalibratorJ(cache_path=path, n_probe=2, seed=0)
    if writer == "port":
        caps = port.caps_for(tiny_t, make_policy("comm_rand"), B, FANOUTS)
        monkeypatch.setattr(mb_j, "calibrate_caps", _no_probe)
        got = ref.caps_for(tiny_graph, make_policy_j("comm_rand"), B,
                           FANOUTS)
    else:
        caps = ref.caps_for(tiny_graph, make_policy_j("comm_rand"), B,
                            FANOUTS)
        monkeypatch.setattr(mb, "calibrate_caps", _no_probe)
        got = port.caps_for(tiny_t, make_policy("comm_rand"), B, FANOUTS)
    assert got == caps
    with open(path) as f:
        assert list(json.load(f)) == [port.key(tiny_t, "comm_rand", B,
                                               FANOUTS)]
    assert not [x for x in os.listdir(tmp_path) if x.startswith(".caps_")]


@pytest.mark.parametrize("payload", [
    b"{ not json", b"\xff\xfe garbage \x00", b"[1, 2, 3]", b""])
def test_corrupt_caps_file_recalibrates(tiny_t, tmp_path, payload):
    """A corrupt caps file is a cache miss, not a crash: discard,
    recalibrate, and the rewrite leaves a valid file behind."""
    path = str(tmp_path / "caps.json")
    with open(path, "wb") as f:
        f.write(payload)
    cal = CapsCalibrator(cache_path=path, n_probe=2, seed=0)
    caps = cal.caps_for(tiny_t, make_policy("rand"), B, FANOUTS)
    assert len(caps) == len(FANOUTS) and all(c > 0 for c in caps)
    with open(path) as f:
        assert isinstance(json.load(f), dict)      # healthy again
    assert cal.caps_for(tiny_t, make_policy("rand"), B, FANOUTS) == caps


@pytest.mark.parametrize("bad", [["x", "y"], [1], [0, -5], "nope"])
def test_corrupt_caps_entry_recalibrates(tiny_t, tmp_path, bad):
    """Valid JSON whose ENTRY is garbage (wrong arity, non-ints, non-
    positive) falls through to a reprobe instead of returning it."""
    path = str(tmp_path / "caps.json")
    cal = CapsCalibrator(cache_path=path, n_probe=2, seed=0)
    pol = make_policy("rand")
    caps = cal.caps_for(tiny_t, pol, B, FANOUTS)
    with open(path, "w") as f:
        json.dump({cal.key(tiny_t, pol, B, FANOUTS): bad}, f)
    assert cal.caps_for(tiny_t, pol, B, FANOUTS) == caps
