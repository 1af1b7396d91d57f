"""The hot-add handoff on a CUDA card, through the kernels.

The case of ``test_torch_handoff.py`` at a size the kernels take (d_head
32, bf16): 2 AdamW steps in a child process, ``handoff`` to a new image of
it (same PID), 1 more step there; the params and losses equal to the bit
to the same 3 steps run here without a handoff, and each image's launch
counts those of its own steps. These need the card and skip elsewhere. On
the card:

    python -m pytest tests/test_torch_handoff_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.models import probe as tprobe
from torch_handoff_child import (STEPS_AFTER, STEPS_BEFORE, assert_handoff_results,
                                 run_handoff_child, uninterrupted)

pytestmark = pytest.mark.gpu

CONFIGS = {
    "dense": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                                      window=24, rope=True, d_ff=256, max_len=96),
    "moe": tprobe.TransformerConfig(n_layers=2, d_model=128, n_heads=4, rope=True,
                                    d_ff=256, max_len=96, n_experts=4),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_handoff_on_the_card_matches_the_uninterrupted_run(tmp_path, cuda, name):
    cfg, shape = CONFIGS[name], (2, 64)
    params = tprobe.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    results, pid, out = run_handoff_child(tmp_path, cfg, params, "cuda", shape)
    params, losses = uninterrupted(cfg, params, cuda, shape)
    assert_handoff_results(results, pid, out, params, losses)
    first, new = ({key: int(n) for key, n in counts.items()}
                  for counts in results["launches"])
    assert first == dict.fromkeys(first, cfg.n_layers * STEPS_BEFORE)
    assert new == dict.fromkeys(new, cfg.n_layers * STEPS_AFTER)
    assert set(first) == {"flash_fwd", "dq", "dkv"}
