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
# An MoE block: a router (d_model, E), always float32, and w1, w2 stacked
# over the experts (3-D).
_MOE_BLOCK_KEYS = ("wqkv", "wo", "ln1", "ln2", "router", "w1", "w2")


def _tensor(arr, dtype: torch.dtype, device, name: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects. Widening to
        # float32 and narrowing back is exact: every bf16 is an f32.
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, config says {dtype}")
    return t.to(device)


def params_from_jax(tree: dict, cfg: TransformerConfig, device="cuda") -> dict:
    """The port's params from the reference's (numpy-leaved) params tree.

    Keys: ``embed``, ``pos`` (absent with rope), and ``blocks[i]`` with
    ``wqkv``, ``wo``, ``ln1``, ``ln2``, ``w1``, ``w2``, and ``router`` when
    cfg.n_experts is set. Every leaf is in cfg.dtype but the router, which
    is float32.
    """
    device = resolve_device(device)
    if ("pos" in tree) == cfg.rope:
        raise ValueError(f"params {'have' if 'pos' in tree else 'lack'} a "
                         f"learned position table but rope={cfg.rope}")
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks, config says "
                         f"{cfg.n_layers}")
    params = {"embed": _tensor(tree["embed"], cfg.dtype, device, "embed"),
              "blocks": []}
    if not cfg.rope:
        params["pos"] = _tensor(tree["pos"], cfg.dtype, device, "pos")
    keys = _BLOCK_KEYS if cfg.n_experts is None else _MOE_BLOCK_KEYS
    for i, blk in enumerate(tree["blocks"]):
        if set(blk) != set(keys):
            raise ValueError(
                f"blocks[{i}] has keys {sorted(blk)}; n_experts="
                f"{cfg.n_experts} expects the "
                f"{'dense' if cfg.n_experts is None else 'MoE'} block "
                f"(dense {sorted(_BLOCK_KEYS)}, MoE {sorted(_MOE_BLOCK_KEYS)})")
        block = {key: _tensor(blk[key], torch.float32 if key == "router" else cfg.dtype,
                              device, f"blocks[{i}].{key}") for key in keys}
        if cfg.n_experts is not None and (
                block["router"].shape[1] != cfg.n_experts or block["w1"].dim() != 3
                or block["w2"].dim() != 3):
            raise ValueError(f"blocks[{i}]: router {tuple(block['router'].shape)}, w1 "
                             f"{tuple(block['w1'].shape)}, w2 {tuple(block['w2'].shape)} "
                             f"are not {cfg.n_experts} stacked experts")
        params["blocks"].append(block)
    return params
