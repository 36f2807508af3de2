"""The reader of ``meta_reuse.compact``: the share of the table layer's
metadata entries written without being encoded anew, from the program's
counters ``lst.meta.snapshots_written`` and ``lst.meta.snapshots_encoded``;
None on a program that records neither (one that encodes every entry of
every metadata file, as the table layer did before it kept each
snapshot's JSON)."""

import pytest

from portbench import registry
from portbench.records import Records
from repro_torch import obs
from test_portbench_spans import recorder, traced  # noqa: F401


def read(rec):
    return registry.metric_reader("meta_reuse.compact").read(rec)


@pytest.mark.parametrize("written,encoded,share", [
    (259560, 720, 100.0 * (1 - 720 / 259560)),     # a 720-commit table
    (21, 6, 100.0 * (1 - 6 / 21)),
    (10, 10, 0.0),                                 # every entry encoded
])
def test_share_from_planted_counters(written, encoded, share):
    obs.count("lst.meta.snapshots_written", written)
    obs.count("lst.meta.snapshots_encoded", encoded)
    assert read(traced()) == pytest.approx(share)


def test_no_metadata_counters_read_nothing():
    assert read(traced()) is None
    assert read(Records(tracing=False)) is None
    obs.count("attn.pairs_computed", 10)
    assert read(traced()) is None


def test_host_smoke_run_reads_the_share():
    """A traced smoke run of the cell: every commit encodes its own
    snapshot, so the share is a number, above 0, below 100."""
    from test_portbench_cells import run

    obs.disable()
    obs.clear()
    out = run("compact-cdc", trace=True)
    assert out["correct"], out["checks"]
    share = out["metrics"]["meta_reuse.compact"]["value"]
    assert 0.0 < share < 100.0
    assert out["metrics"]["meta_reuse.compact"]["unit"] == "%"
