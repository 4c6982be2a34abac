"""Four more families' training path against ``repro``'s on the CPU (MoE,
RG-LRU hybrid, VLM, encoder): step-0 gradients and three train steps, with
the tolerances and the shared ``repro`` run of ``test_torch_training.py``
(a file of its own so that each stays near 40 s under ``--dist loadfile``)."""
import pytest

from test_torch_training import (
    FAMILIES,
    PARITY_HERE,
    Run,
    check_step0_gradients,
    check_train_steps,
)

ARCHS = [a for a in FAMILIES if a not in PARITY_HERE]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Run(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_gradients_match_repro(runs, arch):
    check_step0_gradients(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_repro(runs, arch):
    check_train_steps(runs(arch))
