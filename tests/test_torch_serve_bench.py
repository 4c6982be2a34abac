"""``benchmarks/port_serve.py`` and the two service examples of the port
(``examples/port_batch_serve.py``, ``examples/port_stream_serve.py``) at a
tiny size on the CPU: they run end to end and write or print what they
promise.  Their numbers are CPU numbers and nothing here reads them as
card numbers.  Their imports leave JAX and ``repro`` out
(``tests/test_torch_service.py::test_import_loads_neither_jax_nor_repro``).
"""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_serve_writes_its_record(tmp_path):
    bench = _load("benchmarks/port_serve.py")
    out = tmp_path / "serve.json"
    bench.main(["--device", "cpu", "--scale", "0.05", "--requests", "12",
                "-o", str(out)])
    doc = json.loads(out.read_text())
    assert doc["device"] == "cpu" and doc["backend"] == "torch"
    assert doc["card"] == "not measured (cpu)"
    serve = doc["serve"]
    assert set(serve) == {"config", "warmup", "steady", "steady_phases",
                          "after_warmup", "overload", "metrics", "traced",
                          "direct"}
    for key in ("requests", "p50_ms", "p99_ms", "rejection_rate", "rate_hz",
                "queue_peak", "jit_misses_after_warmup", "failed"):
        assert key in serve["steady"], key
    assert len(serve["steady_phases"]) == 3
    assert serve["steady"]["failed"] == 0
    assert serve["steady"]["completed"] + serve["steady"]["rejected"] \
        == serve["steady"]["submitted"] == 12
    after = serve["after_warmup"]
    assert after["bucket_jit_misses"] == serve["steady"]["jit_misses_after_warmup"]
    for key in ("allocator_segments", "alloc_retries", "kernel_libraries_loaded"):
        assert after[key] == "not measured (cpu)", key
    o = serve["overload"]
    assert o["rejected"] > 0 and o["queue_peak"] <= o["queue_limit"] == 32
    assert o["completed"] + o["rejected"] == o["submitted"] == 96
    m = serve["metrics"]
    assert m["failed"] == 0 and m["pool_occupancy"] == 4
    tr = serve["traced"]
    assert tr["busy_share"] == "not measured (cpu)"
    share = tr["padded_slot_share"]
    assert 0 < share["real_vertices"] < share["slots"]
    assert share["share"] == share["real_vertices"] / share["slots"]
    assert "serve_microbatch" in tr["spans"] and "serve_request" in tr["spans"]
    assert serve["direct"]["calls"] == 16


@pytest.mark.parametrize("rel,argv", [
    ("examples/port_batch_serve.py",
     ["--device", "cpu", "--requests", "6", "--waves", "1", "--scale", "0.1"]),
    ("examples/port_stream_serve.py",
     ["--device", "cpu", "--rounds", "2", "--scale", "0.02"]),
], ids=["batch_serve", "stream_serve"])
def test_port_examples_run_on_the_cpu(rel, argv, capsys):
    assert _load(rel).main(argv)
    out = capsys.readouterr().out
    assert "device cpu" in out
