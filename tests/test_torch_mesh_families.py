"""Every architecture's reduced config on a 2x2 ``DeviceMesh`` of four CPU
processes (gloo), the model built with the mesh, so ``shard_heads``, the
residual constrainer and the local-shard products all run: one loss and
backward, one prefill and one decode step, each held against the same path
without a mesh (``tests/mesh_families_probe.py``).  Tolerance: the loss,
every gradient and the logits within ``1e-4`` of each tensor's max, the
step-0 tolerance of the mesh training tests."""
import os
import sys

import pytest

from repro_torch.configs import list_archs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import mesh_families_probe  # noqa: E402

TOL = 1e-4
PATHS = ("loss+backward", "prefill+decode")


@pytest.fixture(scope="module")
def probe():
    return mesh_families_probe.run(list_archs())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", list_archs())
def test_mesh_path_matches_the_run_without_a_mesh(probe, arch, path):
    assert (arch, "build") not in probe, probe.get((arch, "build"))
    got = probe[(arch, path)]
    assert not isinstance(got, str), got
    if got is None:          # an encoder has no cache to prefill or decode
        assert path == "prefill+decode" and arch == "hubert-xlarge"
        return
    assert got <= TOL, got
