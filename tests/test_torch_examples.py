"""The port's examples (``examples/port_*.py``) with ``--device cpu`` against
``repro``'s (``examples/*.py``), mirroring ``test_system.py``'s
``test_quickstart_example``.

Both run in this process at small sizes.  Their printed lines must be equal
once the timings (``12.3ms``, ``(3s)``) and quickstart's speedup column,
which divides two timings, are taken out: colours, iterations, validity,
group and round counts, the chromatic Gauss-Seidel residual.  The training
example's losses come from the port's own initialisation, so only its
parameter count is held against ``repro``'s configuration.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as repro_config

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TIME = re.compile(r" *\d+\.\d+ms|\(\d+s\)")
SPEEDUP = re.compile(r"ms +\d+\.\d\d valid=")


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def deterministic(text: str) -> list[str]:
    return [TIME.sub(" <t>", SPEEDUP.sub("ms <x> valid=", line))
            for line in text.splitlines()]


@pytest.mark.parametrize("name,args", [
    ("quickstart", ["--n", "3000"]),
    ("color_suite", ["--scale", "0.02"]),
    ("jacobian_compression", ["--n", "400"]),
    ("chromatic_a2a", ["--devices", "8"]),
    ("chromatic_a2a", ["--devices", "5"]),
])
def test_coloring_example_matches_repro(name, args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    load(name).main()
    want = capsys.readouterr().out
    load(f"port_{name}").main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert "valid=False" not in got and "finite=False" not in got
    assert deterministic(got) == deterministic(want)
    assert len(got.splitlines()) >= 4


def test_port_examples_need_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, args in [("port_quickstart", ["--n", "200"]),
                       ("port_color_suite", ["--scale", "0.01"]),
                       ("port_jacobian_compression", ["--n", "100"]),
                       ("port_chromatic_a2a", ["--devices", "3"]),
                       ("port_train_lm", ["--steps", "1"])]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(name).main(args)


def test_train_lm_example(capsys, tmp_path):
    """``port_train_lm.py --preset 10m --steps 3 --device cpu``: repro's
    presets, the parameter count of repro's configuration, finite losses and
    a checkpoint of the last step."""
    mine, ref = load("port_train_lm"), load("train_lm")
    assert mine.PRESETS == ref.PRESETS
    out = mine.main(["--preset", "10m", "--steps", "3", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    rcfg = dataclasses.replace(repro_config("qwen3-4b"), qk_norm=True, vocab_pad_to=256,
                               **ref.PRESETS["10m"])
    total, _ = rcfg.params_estimate()
    assert lines[0] == f"[train_lm] qwen3-example-10m: ~{total/1e6:.0f}M params"
    assert lines[-1].startswith("[train_lm] loss ") and "in 3 steps" in lines[-1]
    assert out["steps"] == 3 and out["final_loss"] == out["final_loss"]   # not NaN
    assert (tmp_path / "step_3").exists()
