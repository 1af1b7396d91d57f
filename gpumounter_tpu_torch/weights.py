"""Carry the reference's probe weights into the port.

The JAX ``init_params`` pytree, turned into numpy arrays (``np.asarray`` on
each leaf), becomes the port's params dict: same keys, same (in, out)
layout, same values bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from gpumounter_tpu_torch._device import resolve_device
from gpumounter_tpu_torch.models.probe import TransformerConfig

_BLOCK_KEYS = ("wqkv", "wo", "ln1", "ln2", "w1", "w2")


def _tensor(arr, cfg: TransformerConfig, device, name: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects. Widening to
        # float32 and narrowing back is exact: every bf16 is an f32.
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if t.dtype != cfg.dtype:
        raise ValueError(f"{name} is {t.dtype}, config says {cfg.dtype}")
    return t.to(device)


def params_from_jax(tree: dict, cfg: TransformerConfig, device="cuda") -> dict:
    """The port's params from the reference's (numpy-leaved) params tree.

    Keys: ``embed``, ``pos`` (absent with rope), and ``blocks[i]`` with
    ``wqkv``, ``wo``, ``ln1``, ``ln2``, ``w1``, ``w2``.
    """
    device = resolve_device(device)
    if ("pos" in tree) == cfg.rope:
        raise ValueError(f"params {'have' if 'pos' in tree else 'lack'} a "
                         f"learned position table but rope={cfg.rope}")
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks, config says "
                         f"{cfg.n_layers}")
    params = {"embed": _tensor(tree["embed"], cfg, device, "embed"),
              "blocks": []}
    if not cfg.rope:
        params["pos"] = _tensor(tree["pos"], cfg, device, "pos")
    for i, blk in enumerate(tree["blocks"]):
        if set(blk) != set(_BLOCK_KEYS):
            raise ValueError(f"blocks[{i}] has keys {sorted(blk)}, expected "
                             f"the dense block {sorted(_BLOCK_KEYS)}")
        params["blocks"].append({
            key: _tensor(blk[key], cfg, device, f"blocks[{i}].{key}")
            for key in _BLOCK_KEYS})
    return params
