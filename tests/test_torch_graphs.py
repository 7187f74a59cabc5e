"""Graph substrate parity: the port's copied numpy pipeline (SBM
generator, Louvain, community reordering, intra-first layout) gives the
reference's arrays exactly, and `DeviceGraph` holds the same values."""
import dataclasses

import numpy as np
import pytest

from repro.core.reorder import prepare as prepare_j
from repro.graphs import synthetic as synthetic_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph

_FIELDS = ("indptr", "indices", "features", "labels", "train_ids", "val_ids",
           "test_ids", "communities", "n_intra", "name")


def _assert_graphs_equal(a, b):
    for f in _FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        elif isinstance(va, str):
            assert va == vb, f
        else:
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)


def test_dataset_registry_is_a_copy():
    assert {k: dataclasses.asdict(v) for k, v in synthetic.DATASETS.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in synthetic_j.DATASETS.items()}


def test_generate_equal():
    _assert_graphs_equal(synthetic.load("tiny"), synthetic_j.load("tiny"))


@pytest.mark.parametrize("oracle", [True, False])
def test_prepare_equal(oracle):
    """oracle=False runs the Louvain detector (the example's default)."""
    a = prepare(synthetic.load("tiny"), oracle=oracle)
    b = prepare_j(synthetic_j.load("tiny"), oracle=oracle)
    _assert_graphs_equal(a, b)


def test_device_graph_fields_equal(tiny_graph):
    gt = DeviceGraph.from_graph(prepare(synthetic.load("tiny")),
                                device="cpu")
    gj = DeviceGraphJ.from_graph(tiny_graph)
    for f in ("indptr", "indices", "n_intra", "communities", "degrees"):
        t, j = getattr(gt, f).numpy(), np.asarray(getattr(gj, f))
        assert t.dtype == j.dtype == np.int32, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    assert (gt.num_nodes, gt.max_degree) == (gj.num_nodes, gj.max_degree)
