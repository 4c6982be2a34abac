"""The record of ``repro``'s dry-run counts at full size
(``tests/data/repro_dryrun_fullsize.json``, written by
``tests/repro_dryrun_record.py`` on a CPU with JAX), which the port's trace
is held to where JAX is not installed:

* the record has an entry for every cell ``plan_cells`` plans on
  ``single`` and on ``pod``, with ``repro``'s counts for each runnable
  cell and the skip reason for the others, and one for each reduced case
  the tests pin;
* every cell it holds to an accounted gap, a bound or a collective count
  is recorded, and ``differs`` holds the gaps exactly and bounds the rest.

The full-size traces themselves are not run here (minutes a cell)."""
import os
import sys

import pytest

from repro_torch.launch.dryrun import plan_cells

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import repro_dryrun_record as R  # noqa: E402

PLANNED = [(a, s, sk) for a, s, sk in plan_cells()]


@pytest.fixture(scope="module")
def record():
    return R.load()


@pytest.mark.parametrize("arch,shape,skip", PLANNED, ids=[f"{a}-{s}" for a, s, _ in PLANNED])
def test_record_has_every_planned_cell(record, arch, shape, skip):
    for mesh in R.MESHES:
        entry = record[f"{arch} {shape} {mesh}"]
        if skip:
            assert entry == {"reason": skip}
            continue
        assert entry["mesh"] == "x".join(map(str, R.MESHES[mesh])) and entry["full"]
        assert entry["flops"] > 0 and entry["collective_bytes"] > 0 and entry["traffic"] > 0


def test_record_lists_only_cells_and_reduced_cases(record):
    assert set(record) - {"_about"} == set(R.cells())
    assert record["_about"]["jax"]


def test_held_cells_are_recorded(record):
    """Every cell with an accounted gap, a bound or a held collective count
    has repro's counts in the record, and each gap is less than them."""
    for key in set(R.GAPS) | R.NEAR | R.COLLECTIVE_HELD:
        assert record[key]["flops"] > R.GAPS.get(key, 0) >= 0, key
        assert record[key]["collective_bytes"] > 0, key


WANT = {"flops": 1_000_000.0, "collective_bytes": 1000.0}
HELD = [  # (key, the port's FLOPs, its collective bytes, held)
    ("qwen3-4b train_4k single", 1_000_000, 5000.0, True),
    ("qwen3-4b train_4k single", 999_999, 1000.0, False),
    ("mixtral-8x22b decode_32k pod", 981_000, 1000.0, True),
    ("mixtral-8x22b decode_32k pod", 979_000, 1000.0, False),
    ("rwkv6-1.6b long_500k single", 1_000_000, 1150.0, True),
    ("rwkv6-1.6b long_500k single", 1_000_000, 1151.0, False),
    ("F18 qwen3-4b 1x4 d_model 640", 1_000_000 - R.GAPS["F18 qwen3-4b 1x4 d_model 640"],
     1000.0, True),
    ("F18 qwen3-4b 1x4 d_model 640", 1_000_000, 1000.0, False),
]


@pytest.mark.parametrize("key,flops,coll,held", HELD)
def test_differs_holds_gaps_exactly_and_bounds_the_rest(key, flops, coll, held):
    """``--check-port`` and chip_smoke.py hold a cell's FLOPs to repro's
    less its accounted gap exactly (``NEAR``'s within 2%), and the F17
    cells' and reduced cases' collective bytes within 1.15x."""
    why = R.differs(key, {"flops": flops, "collective_bytes": coll}, WANT)
    assert (why is None) == held, why
