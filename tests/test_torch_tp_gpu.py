"""The dryrun's sharded sections on a CUDA card, through the kernels.

``entry.tp_train_check`` on a 1 x 2 and a 2 x 2 ("data", "model") mesh of
ranks that share the card over gloo (NCCL refuses two ranks on one device):
one dp x tp SGD step at ``train_check``'s dialect, every rank's kernels
launched n_layers times on its H/tp q heads and H_kv/tp kv heads, the
grads through the kernels within the reference's 5e-3 of those through
the plain attention on the mesh, the collectives of ``step_collectives``,
the MoE flagship over the same mesh and ``make_moe_step`` over ("data",
"expert"). These need the card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_tp_gpu.py -q -m gpu
"""

from __future__ import annotations

import math

import pytest
import torch

from gpumounter_tpu_torch.entry import TRAIN_GRAD_ATOL, check_config, tp_train_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_train_check_on_the_card(cuda, shape):
    result = tp_train_check(*shape, backend="gloo", timeout_s=300.0)
    cfg = check_config()
    n_layers, tp = cfg.n_layers, shape[1]
    assert len(result["ranks"]) == shape[0] * shape[1]
    for rank in result["ranks"]:
        assert math.isfinite(rank["loss"]) and math.isfinite(rank["moe_loss"])
        assert rank["launches"] == rank["moe_launches"] == dict.fromkeys(
            ("flash_fwd", "dq", "dkv"), n_layers)
        assert rank["heads"] == [(cfg.n_heads // tp, cfg.kv_heads // tp)] * n_layers
        assert rank["collectives"]["calls"]["model"] == 4 * n_layers
        assert all(map(math.isfinite, rank["moe_step_losses"]))
    assert result["max_grad_err"] < TRAIN_GRAD_ATOL
