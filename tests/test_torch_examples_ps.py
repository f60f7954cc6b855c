"""The port's parameter-server, pipeline and fleet examples against the
reference's on the CPU, at small flags: the same text once
``torch_examples.mask_example_text`` has masked the wall-clock figures and the
losses (see ``tests/test_torch_examples.py``)."""

from test_torch_examples import (assert_same_masked, own_group,  # noqa: F401
                                 te)


def test_edge_ps_prints_the_reference_text(own_group):
    text = assert_same_masked("edge_ps", te.EXAMPLES["edge_ps"])
    assert "segment -> shard routing: pulls (0, 1), pushes (1, 0)" in text
    assert "8 accepted / 0 stale-rejected pushes; max staleness 0 <= k=1" \
        in text


def test_dynamic_ps_prints_the_reference_text(own_group):
    text = assert_same_masked("dynamic_ps",
                              te.EXAMPLES["dynamic_ps"])
    assert "2 pull / 3 push segments (coll 2 ag/3 rs) re-segmented" in text
    assert "8 pushes in 2 BSP rounds" in text


def test_edge_pipeline_prints_the_reference_text(own_group):
    text = assert_same_masked("edge_pipeline",
                              te.EXAMPLES["edge_pipeline"])
    assert "partition (by profiled fc+bc): [[1, 2], [3, 4]]" in text
    assert "ledger: 10 pulls (2.10 MB activations)" in text


def test_elastic_fleet_prints_the_reference_text(own_group):
    text = assert_same_masked("elastic_fleet",
                              te.EXAMPLES["elastic_fleet"])
    assert "resumed-from-checkpoint tail bit-identical" in text
    assert "drift re-plans: 1, stall evictions: 1" in text
