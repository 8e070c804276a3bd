"""The port's multi-device dry run (entry.py:dryrun_multichip, the
counterpart of __graft_entry__.py's) on gloo ranks of the CPU: the tensor-
and data-parallel encoder held to the unsharded one (1e-5, fp32), db- and
query-sharded ids equal to the unsharded one-shot search (values within
1e-6), and the sharded flat (pod mesh), graph, IVF and LSH indexes and a
ShardSweep each equal to their goldens. Every check raises inside the
ranks."""

import pytest
import torch

from knn_for_homology_tpu_torch.entry import dryrun_multichip


@pytest.mark.parametrize("n_devices", [4, 3])
def test_dryrun_multichip_on_cpu_ranks(n_devices):
    out = dryrun_multichip(n_devices, device="cpu")
    assert out["steps"] == 7
    assert out["encoder_max_abs"] <= 1e-5


def test_dryrun_on_cuda_needs_the_card_or_gloo():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a card")
    with pytest.raises(RuntimeError):
        dryrun_multichip(2, device="cuda")
