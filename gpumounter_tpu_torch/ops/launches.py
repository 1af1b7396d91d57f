"""The hand-written kernels' launch counts, read and reset in one place.

Each kernel's wrapper adds one to its own count where it launches its
kernel, and nowhere else: ``flash_attention_kernel.launches``,
``flash_attention_bwd_kernel.dq_launches`` and ``.dkv_launches``,
``flash_decode_kernel.launches``. A check that holds a path to its kernels
sets the counts to 0 just before it drives the path and reads them just
after; a counter added to a wrapper is added here once.
"""

from __future__ import annotations

from gpumounter_tpu_torch.ops.flash_attention import (flash_attention_bwd_kernel,
                                                      flash_attention_kernel)
from gpumounter_tpu_torch.ops.flash_decode import flash_decode_kernel

#: every kernel's count, by the name the chip's kernels line gives it:
#: (the wrapper, the attribute that holds its count)
COUNTERS = {"flash_fwd": (flash_attention_kernel, "launches"),
            "dq": (flash_attention_bwd_kernel, "dq_launches"),
            "dkv": (flash_attention_bwd_kernel, "dkv_launches"),
            "flash_decode": (flash_decode_kernel, "launches")}
#: the training step's kernels: the forward and the two backward kernels
TRAINING = ("flash_fwd", "dq", "dkv")


def launch_counts(names=tuple(COUNTERS)) -> dict:
    """The launch counts of the kernels `names` (all four by default) in
    this process."""
    return {name: getattr(*COUNTERS[name]) for name in names}


def reset_launch_counts(names=tuple(COUNTERS)) -> None:
    """Set the counts of the kernels `names` (all four by default) to 0."""
    for name in names:
        setattr(*COUNTERS[name], 0)
