"""The port's dry run (`launch/dryrun.py`)
on the 2x16x16 multi-pod mesh (512 ranks) under the "fake" process group: every arch x input shape, on the
reduced configs and 32-token shapes substituted into the module (the
CLI is the reference's), gives status ok, or the reference's
seamless-m4t-medium x long_500k skip; its argument bytes equal the
bytes the JAX package's own specs imply for rank 0; FLOPs are counted
and the collectives are non-zero (every config splits a dim on this
mesh). See `dryrun_parity.py`."""
import pytest

from repro_torch.configs import INPUT_SHAPES, list_archs

import dryrun_parity

MULTI_POD = True


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return dryrun_parity.run_cli(mp, tmp_path_factory.mktemp("dry"),
                                     MULTI_POD)
    finally:
        mp.undo()


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_dryrun_multi_pod(records, arch, shape):
    dryrun_parity.check(records, arch, shape, MULTI_POD)
