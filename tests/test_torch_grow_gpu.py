"""The mesh-growing hot-add and the multichip dryrun on a CUDA card.

``entry.grow_check`` at ``train_check``'s dialect (d_head 32), from a
(1, 2) to a (2, 2) ("data", "model") mesh of ranks that share the card
over gloo (NCCL refuses two ranks on one device): the restored shards of
params and AdamW moments bit-equal to ``shard_params`` of what was packed,
gathered again bit-equal, and the grown world's first step held against
one process from the same state; each rank launches each training kernel
n_layers times a step. Then ``entry.dryrun_multichip(4)``, its 16-rank
stretch over the H100 plan included. These need the card and skip
elsewhere. On the card:

    python -m pytest tests/test_torch_grow_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.entry import (SHARDED_LOSS_ATOL, TRAIN_GRAD_ATOL, check_config,
                                        dryrun_multichip, grow_check)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    return torch.device("cuda")


def test_grow_check_on_the_card(cuda, tmp_path):
    steps = (2, 2)
    result = grow_check((1, 2), (2, 2), backend="gloo", path=str(tmp_path / "ckpt"),
                        steps=steps, timeout_s=300.0)
    n_layers = check_config().n_layers
    for world, n_steps in (("old", steps[0]), ("new", steps[1])):
        for rank in result[world]:
            assert rank["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"),
                                                     n_layers * n_steps)
    assert len({tuple(rank["losses"]) for rank in result["new"]}) == 1


def test_dryrun_multichip_on_the_card(cuda):
    result = dryrun_multichip(4, backend="gloo", timeout_s=300.0)
    n_layers = check_config().n_layers
    sp = result["seq_shape"][1]
    for r in result["sections"]:
        assert r["tp"]["max_grad_err"] < TRAIN_GRAD_ATOL
        assert r["tp"]["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"), n_layers)
        c = r["rank"] % sp
        assert r["seq"]["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"),
                                                     (c + 1) * n_layers)
        pipe = r["pipeline"]
        assert pipe["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"), pipe["n_micro"] * 2)
    for r in result["stretch"]:
        assert r["loss_err"] < SHARDED_LOSS_ATOL
        assert r["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"), n_layers)
