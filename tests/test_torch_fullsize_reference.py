"""The record of ``repro``'s full-size results (``tests/data/repro_fullsize.json``,
written by ``tests/repro_fullsize_record.py`` on a CPU with JAX), which
``chip_smoke.py`` holds the card's phases 9-12 to field for field:

* the record parses and has an entry, or a listed reason, for every path
  of ``PATHS``, the one list that ``chip_smoke.py`` reads, and every
  full-size run that ``chip_smoke.py`` names is one of them;
* ``item`` digests a result of ``repro`` and of the CPU port alike on the
  same small graph (rmat-er at scale 0.02, default and classic options);
* a tampered entry is reported with the first field that differs.
"""
import copy
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import repro_fullsize_record as R  # noqa: E402


@pytest.fixture(scope="module")
def record():
    return R.load()


def test_record_parses_and_covers_every_path(record):
    assert [e for e in record] == [p.key for p in R.PATHS if p.key in record]
    for p in R.PATHS:
        entry = record[p.key]
        assert entry["phase"] == p.phase and entry["recipe"] == R.GRAPHS[p.graph][0]
        assert entry["options"] == dict(p.options)
        if "results" not in entry:
            assert entry["reason"], p.key
            continue
        assert entry["results"], p.key
        for it in entry["results"]:
            assert set(it) == {"label", "graph_sha256", "colors_sha256", *R.FIELDS}
            assert len(it["graph_sha256"]) == len(it["colors_sha256"]) == 64
            assert it["num_colors"] > 0


def test_chip_smokes_full_runs_are_the_records_paths():
    sys.path.insert(0, ROOT)
    import chip_smoke

    named = {label: 9 for label, *_ in chip_smoke.FULL_RUNS}
    named |= {label: 10 for label, *_ in chip_smoke.D2_FULL_RUNS}
    named |= {f"{a} {g}": 11 for a, *_ in chip_smoke.BASELINE_RUNS for g in chip_smoke.PAPER}
    assert {k: R.BY_KEY[k].phase for k in named} == named
    assert chip_smoke.BATCH_SEEDS == R.BATCH_SEEDS


@pytest.mark.parametrize("options", [{}, {"engine": "classic"}], ids=["default", "classic"])
def test_digest_alike_for_repro_and_the_port(options):
    import repro
    import repro_torch
    from repro.graphs import build_graph
    from repro_torch.graphs import build_graph as port_graph

    g, pg = build_graph("rmat-er", 0.02), port_graph("rmat-er", 0.02)
    want = R.item(g, repro.color(g, **options), "graph")
    got = R.item(pg, repro_torch.color(pg, device="cpu", **options), "graph")
    assert R.first_difference(want, got) is None, (want, got)
    assert R.check({"k": {"results": [want]}}, "k", [got])


def test_a_tampered_entry_names_the_field(record):
    key = next(p.key for p in R.PATHS if "results" in record[p.key])
    good = record[key]["results"]
    assert R.check(record, key, copy.deepcopy(good))
    for field, value in (("iterations", -1), ("class_cells", [[0, 0]]),
                         ("colors_sha256", "0" * 64), ("graph_sha256", "f" * 64)):
        bad = copy.deepcopy(good)
        bad[-1][field] = value
        with pytest.raises(R.Mismatch, match=f"{key} .*: {field} differs"):
            R.check(record, key, bad)
    # the graph's digest is compared first: a different graph reads as one
    bad = copy.deepcopy(good)
    bad[0]["graph_sha256"], bad[0]["iterations"] = "f" * 64, -1
    with pytest.raises(R.Mismatch, match="graph_sha256 differs"):
        R.check(record, key, bad)
    with pytest.raises(R.Mismatch, match="no entry"):
        R.check({}, key, good)


def test_digest_is_of_little_endian_int32():
    a = np.arange(5, dtype=np.int64)
    assert R.sha256_i32(a) == R.sha256_i32(a.astype(">i4")) == R.sha256_i32(list(range(5)))
