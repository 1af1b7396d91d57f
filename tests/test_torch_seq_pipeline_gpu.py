"""The dryrun's dp x sp, ring and pipeline sections on a CUDA card.

``entry.seq_pipeline_check`` on a 2 x 2 and a 1 x 4 ("data", "seq") mesh
of ranks that share the card over gloo (NCCL refuses two ranks on one
device), at ``train_check``'s dialect (d_head 32): one dp x sp SGD step,
its loss within the dryrun's 1e-2 of the unsharded loss, the rank at seq
coordinate c launching each training kernel (c + 1)·n_layers times (the
causal ring skips the chunks from later coordinates); ring attention
against the one-process oracle with a finite gradient; then on a ("pipe",)
mesh of the same 4 ranks GPipe on tanh stages and one interleaved pipeline
step (2 chunks a rank, n_micro 4), its loss within 1e-2 of the unsharded
loss, each kernel launched n_micro·2 times on every rank. These need the
card and skip elsewhere. On the card:

    python -m pytest tests/test_torch_seq_pipeline_gpu.py -q -m gpu
"""

from __future__ import annotations

import pytest
import torch

from gpumounter_tpu_torch.entry import SHARDED_LOSS_ATOL, check_config, seq_pipeline_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_seq_pipeline_check_on_the_card(cuda, shape):
    results = seq_pipeline_check(*shape, backend="gloo", timeout_s=300.0)
    n_layers = check_config().n_layers
    assert len(results) == shape[0] * shape[1]
    for rank, result in enumerate(results):
        seq, pipe = result["seq"], result["pipeline"]
        c = rank % shape[1]
        assert seq["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"), (c + 1) * n_layers)
        assert seq["loss_err"] < SHARDED_LOSS_ATOL
        assert pipe["launches"] == dict.fromkeys(("flash_fwd", "dq", "dkv"), pipe["n_micro"] * 2)
        assert pipe["loss_err"] < SHARDED_LOSS_ATOL and pipe["gpipe_err"] <= 1e-6
