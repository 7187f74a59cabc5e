"""The CLOCK walk's kernel decomposition on the CPU
(`kernels/clock_refill/ref.py`): the runs of equal candidate frequency,
the windowed walk (`clock_walk_windows`: a window of visits decided at
once, runs taken in bulk, the exact 2C stop, the victim list) and the
parallel apply stage (`clock_apply`), held for windows of 1, 32, 128
and 256 visits (the kernel's) against the one-step plain walk
(`clock_refill_ref`), the reference's numpy oracle `refill_np` and its
jitted `refill`, slot for slot: residency, rows, bits (those a failed pass clears too), hand,
admissions and steps. The states cover C = 1, C below the window, C at
the warp's width (31, 32, 33), every bit set, no slot colder than any
candidate (a failing first pass), frequency ties, every candidate
admitted (K = C) and walks of three or more rotations."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.featcache import dynamic as dynamic_j
from repro.featcache.dynamic import DynamicCacheState as DynamicCacheStateJ
from repro_torch.featcache import dynamic
from repro_torch.featcache.dynamic import DynamicCacheState
from repro_torch.kernels.clock_refill import kernel as walk_kernel
from repro_torch.kernels.clock_refill import ops as refill_ops
from repro_torch.kernels.clock_refill.ref import (clock_apply,
                                                  clock_refill_ref,
                                                  clock_refill_windowed,
                                                  clock_runs, clock_state,
                                                  clock_walk_windows,
                                                  walk_args)
from test_torch_dynamic_cache import TIES, _tie_state

# 256: the kernel's window (`kernel.window()`, checked on the card)
WINDOWS = (1, 32, 128, 256)
WALK_FIELDS = ("pos", "slot_ids", "refbit", "slot_freq", "hand")


def _fields(seed, n, c, max_freq, kind="random", f=3):
    """A CLOCK state at an epoch's end as numpy fields, and its feature
    matrix. `kind`: "random" bits and counts; "all_bits" every bit set;
    "no_victim" every slot as hot as `max_freq`, above every candidate;
    "admit_all" every slot clear and cold, every node missed (K = C
    candidates, all admitted); "rotations" every bit set and few cold
    slots, so the hand goes round three times or more."""
    rng = np.random.default_rng((seed, 17))
    feats = rng.normal(size=(n, f)).astype(np.float32)
    ids = np.sort(rng.choice(n, size=c, replace=False))
    pos = np.full(n, -1, np.int32)
    pos[ids] = np.arange(c, dtype=np.int32)
    refbit = rng.integers(0, 2, c).astype(np.int32)
    slot_freq = rng.integers(0, max_freq, c).astype(np.int32)
    freq = rng.integers(0, max_freq, n).astype(np.int32)
    if kind == "all_bits":
        refbit[:] = 1
    elif kind == "no_victim":
        slot_freq[:] = max_freq
    elif kind == "admit_all":
        refbit[:] = 0
        slot_freq[:] = 0
        freq = rng.integers(1, max_freq + 1, n).astype(np.int32)
    elif kind == "rotations":
        refbit[:] = 1
        slot_freq[:] = max_freq
        slot_freq[rng.choice(c, size=max(1, c // 8), replace=False)] = 0
        freq = rng.integers(1, max_freq + 1, n).astype(np.int32)
    else:
        assert kind == "random"
    fields = {"cache": feats[ids], "pos": pos,
              "slot_ids": ids.astype(np.int32), "refbit": refbit,
              "slot_freq": slot_freq, "freq": freq,
              "hand": np.asarray(int(rng.integers(0, c)), np.int32)}
    return fields, feats


def _walk_args(fields):
    st = {k: torch.as_tensor(np.array(fields[k])) for k in fields}
    cand = refill_ops.refill_candidates(st["pos"], st["freq"],
                                        len(fields["slot_ids"]))
    return [st[k] for k in WALK_FIELDS] + list(cand)


def _assert_walks_equal(got, want):
    n = int(want.n_admitted)
    assert int(got.n_admitted) == n
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f.startswith("adm"):
            a, b = a[:n], b[:n]
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _port_state(fields):
    return DynamicCacheState(**{k: torch.as_tensor(np.array(v))
                                for k, v in fields.items()},
                             capacity=len(fields["slot_ids"]), policy="t")


def _ref_state(fields):
    return DynamicCacheStateJ(**{k: jnp.asarray(v) for k, v in fields.items()},
                              capacity=len(fields["slot_ids"]), policy="t")


# (N, C, max_freq, kind, seed)
CASES = [(12, 1, 3, "random", 0), (40, 1, 2, "all_bits", 1),
         (40, 5, 3, "random", 2), (60, 20, 4, "random", 3),
         (90, 31, 4, "random", 4), (90, 32, 4, "random", 5),
         (90, 33, 4, "random", 6), (90, 32, 3, "all_bits", 7),
         (70, 33, 5, "no_victim", 8), (40, 5, 2, "no_victim", 9),
         (80, 31, 6, "admit_all", 10), (64, 32, 2, "admit_all", 11),
         (90, 33, 6, "rotations", 12), (60, 16, 4, "rotations", 13),
         (200, 140, 3, "random", 14), (300, 150, 9, "all_bits", 15)]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n,c,max_freq,kind,seed", CASES)
def test_windowed_walk_equals_the_plain_walk(n, c, max_freq, kind, seed,
                                             window):
    """The windowed walk then the apply stage equal the one-step walk,
    every field, and no slot is admitted twice."""
    fields, _ = _fields(seed, n, c, max_freq, kind)
    args = _walk_args(fields)
    want = clock_refill_ref(*args)
    got = clock_refill_windowed(*args, window=window)
    _assert_walks_equal(got, want)
    adm = int(got.n_admitted)
    slots = got.adm_slots[:adm]
    assert len(torch.unique(slots)) == adm
    if kind == "no_victim":
        assert adm == 0 and int(got.steps) == 2 * c
        assert int(got.refbit.sum()) == 0
    if kind == "admit_all":
        assert adm == c
    if kind == "rotations":
        assert int(got.steps) + adm >= 3 * c


@pytest.mark.parametrize("n,c,max_freq,kind,seed", CASES)
def test_no_slot_is_admitted_twice_in_one_refill(n, c, max_freq, kind,
                                                 seed):
    """The premise of the parallel apply: an admitted slot holds f_k >=
    every later candidate's f, so the one-step walk never takes it again;
    its victims are distinct, and so are the nodes they evict."""
    fields, _ = _fields(seed, n, c, max_freq, kind)
    want = clock_refill_ref(*_walk_args(fields))
    adm = int(want.n_admitted)
    slots = want.adm_slots[:adm].numpy()
    assert len(np.unique(slots)) == adm
    evicted = fields["slot_ids"][slots]
    assert len(np.unique(evicted)) == adm
    assert not np.isin(want.adm_nodes[:adm].numpy(), evicted).any()


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n,c,max_freq,kind,seed",
                         [x for x in CASES if x[1] < 100])
def test_windowed_refill_equals_oracle_and_reference(
        monkeypatch, n, c, max_freq, kind, seed, window):
    """`dynamic.refill` with the windowed walk in the kernel's place equals
    `refill_np` and the reference's jitted `refill` slot for slot, rows
    included."""
    monkeypatch.setattr(refill_ops, "walk", functools.partial(
        clock_refill_windowed, window=window))
    fields, feats = _fields(seed, n, c, max_freq, kind)
    state = _port_state(fields)
    got, adm = dynamic.refill(state, torch.as_tensor(feats))
    oracle, adm_np = dynamic.refill_np(dynamic.state_to_np(state), feats)
    ref, adm_j = dynamic_j.refill(_ref_state(fields), jnp.asarray(feats))
    for want in (oracle, dynamic_j.state_to_np(ref)):
        for k, v in dynamic.state_to_np(got).items():
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    assert adm == adm_np == int(adm_j)
    assert dynamic.integrity_ok(got)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("case", range(len(TIES)))
def test_windowed_walk_breaks_ties_as_the_reference(monkeypatch, case,
                                                    window):
    """The tie-breaking states of `tests/test_torch_dynamic_cache.py`:
    the windowed walk's refill equals the jitted reference's."""
    fields, feats = _tie_state(*TIES[case][0])
    monkeypatch.setattr(refill_ops, "walk", functools.partial(
        clock_refill_windowed, window=window))
    got, adm = dynamic.refill(_port_state(fields), torch.as_tensor(feats))
    ref, adm_j = dynamic_j.refill(_ref_state(fields), jnp.asarray(feats))
    for k, v in dynamic.state_to_np(got).items():
        np.testing.assert_array_equal(v, np.asarray(
            dynamic_j.state_to_np(ref)[k]), err_msg=k)
    assert adm == int(adm_j) == TIES[case][1]
    assert got.slot_ids.tolist() == TIES[case][2]


@pytest.mark.parametrize("n,c,max_freq,kind,seed", CASES[::3])
def test_apply_stage_alone_rebuilds_the_plain_walks_state(n, c, max_freq,
                                                          kind, seed):
    """`clock_apply` fed the one-step walk's own victims and visit count
    rebuilds that walk's state."""
    fields, _ = _fields(seed, n, c, max_freq, kind)
    args = _walk_args(fields)
    want = clock_refill_ref(*args)
    adm = int(want.n_admitted)
    plan = clock_walk_windows(args[2].numpy(), args[3].numpy(),
                              int(args[4]), args[6].numpy(), WINDOWS[-1])
    plan = plan._replace(adm_slots=want.adm_slots[:adm].numpy().astype(
        np.int64), visits=int(want.steps) + adm)
    _assert_walks_equal(clock_apply(*args, plan), want)


def test_window_counts_shrink_with_the_window():
    """A wider window decides the same visits in fewer rounds: the runs of
    equal frequency are taken in bulk."""
    fields, _ = _fields(3, 400, 200, 4, "random")
    args = _walk_args(fields)
    plans = {w: clock_walk_windows(args[2].numpy(), args[3].numpy(),
                                   int(args[4]), args[6].numpy(), w)
             for w in WINDOWS}
    assert len({p.visits for p in plans.values()}) == 1
    assert plans[1].windows == plans[1].visits
    assert plans[128].windows < plans[32].windows < plans[1].windows


def test_runs_of_equal_frequency():
    fs = np.array([9, 9, 7, 7, 7, 3, 1, 0, 0])
    run_f, run_end = clock_runs(fs)
    assert run_f.tolist() == [9, 7, 3, 1]
    assert run_end.tolist() == [2, 5, 6, 7]
    for empty in ([], [0, 0], [-1]):
        assert [len(x) for x in clock_runs(np.array(empty, int))] == [0, 0]
    with pytest.raises(ValueError, match="sorted"):
        clock_runs(np.array([3, 5, 1]))


def test_unsorted_candidates_raise_on_the_cpu_path():
    """The kernel takes runs of candidates sorted high to low (the card
    traps on others); the CPU path raises ValueError, as
    `gather_sorted_rows` does."""
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        walk_kernel.clock_refill(
            torch.tensor([0, 1, -1, -1], **i32), torch.tensor([0, 1], **i32),
            torch.tensor([0, 0], **i32), torch.tensor([0, 0], **i32),
            torch.tensor(0, **i32), torch.tensor([2, 3], **i32),
            torch.tensor([1, 2], **i32))


def test_the_cpu_path_counts_no_rounds():
    """Only the card's kernel decides windows: asked for its round count,
    the CPU path raises instead of inventing one."""
    fields, _ = _fields(0, 40, 5, 3)
    with pytest.raises(ValueError, match="rounds"):
        walk_kernel.clock_refill(*_walk_args(fields),
                                 rounds=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("kind", ["random", "all_bits", "no_victim"])
def test_seeded_clock_states(kind):
    """`ref.clock_state`, the card tests' and the smoke run's states: the
    same seed gives the same state; residency is consistent; the kinds
    set every bit or leave no slot colder than any candidate."""
    a, b = (clock_state(500, 60, 5, 1, "cpu", kind) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    ids = a["slot_ids"].long()
    assert torch.equal(a["pos"][ids], torch.arange(60, dtype=torch.int32))
    assert int((a["pos"] >= 0).sum()) == 60
    if kind == "all_bits":
        assert bool((a["refbit"] == 1).all())
    if kind == "no_victim":
        walk = clock_refill_ref(*walk_args(a))
        assert int(walk.n_admitted) == 0 and int(walk.steps) == 2 * 60
    with pytest.raises(ValueError, match="kind"):
        clock_state(500, 60, 5, 1, "cpu", "warm")
