"""CUDA graphs of the port's kernels, with launch counts that follow replays.

Each kernel wrapper adds one to a plain integer where it launches its kernel
(``flash_attention_kernel.launches``, ``flash_attention_bwd_kernel``'s
``dq_launches`` and ``dkv_launches``, ``flash_decode_kernel.launches``). A
capture calls the wrappers, so they count, but it runs nothing; a replay runs
the captured kernels again without calling any wrapper. ``counted_replay``
keeps the counts true: it takes the capture's increments back out and adds
them once per replay.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.ops.flash_attention import (flash_attention_bwd_kernel,
                                                      flash_attention_kernel)
from gpumounter_tpu_torch.ops.flash_decode import flash_decode_kernel

COUNTERS = ((flash_attention_kernel, "launches"),
            (flash_attention_bwd_kernel, "dq_launches"),
            (flash_attention_bwd_kernel, "dkv_launches"),
            (flash_decode_kernel, "launches"))


def _counts() -> list[int]:
    return [getattr(fn, name) for fn, name in COUNTERS]


def counted_replay(graph, record):
    """Run record(), which captures kernels into `graph` and launches none,
    and return a function that replays `graph` and adds to each counter
    what the capture added to it. The counters are left as they were
    before the capture."""
    before = _counts()
    record()
    per_replay = [after - was for after, was in zip(_counts(), before)]
    for (fn, name), was in zip(COUNTERS, before):
        setattr(fn, name, was)

    def replay():
        graph.replay()
        for (fn, name), n in zip(COUNTERS, per_replay):
            setattr(fn, name, getattr(fn, name) + n)

    return replay


def capture(fn, generators=()):
    """(graph, replay, out): fn() run once eagerly on the capture stream,
    then one more call of fn captured as a CUDA graph.

    The eager call is a real call (its effects stay); it also loads the
    kernels' modules and the capture stream's cuBLAS workspace, which the
    capture must not allocate. `generators` (CUDA ``torch.Generator``s fn
    draws from; the default one is registered by torch itself) advance on
    every replay as they would on an eager call. replay() is
    ``counted_replay``'s; out is the captured call's output, in the graph's
    memory, rewritten by every replay. A host read of a device value inside
    fn makes the capture raise; so does another thread's CUDA work during
    it.
    """
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    context = torch.cuda.graph(graph)
    stream = context.capture_stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    out = []

    def record():
        with context:
            out.append(fn())

    return graph, counted_replay(graph, record), out[0]
