"""CUDA graphs of the port's programs: captured once per key, then replayed.

The reference runs its main path as compiled programs, each built once per
set of static arguments and shapes and reused (``jax.jit``'s cache). The
port's counterpart is a cache of CUDA graphs: a program (``forward``, the
train step, ``generate``'s prefill and decode step) is captured on its first
call for a key and replayed on every later call with that key. The key
(``graph_key``) is what jit keys on: the static arguments and the inputs'
shapes, strides, dtypes and devices, plus the storage of every tensor the
graph reads in place (a graph reads fixed addresses). A tensor the program
copies into a static buffer of its own adds only its layout. An entry's
bodies hold what they read in place, so while the entry lives no address
in its key can come to name another tensor.

Each program holds one entry (``lookup``, ``store``): a new key evicts the
old one, and with it its graphs and their private memory pools, which the
next capture's ``torch.cuda.empty_cache`` (``torch.cuda.graph``'s) hands
back. ``clear_graphs`` drops every entry, as ``jax.clear_caches`` does.
``capture.captures`` counts every capture, so checks can tell a capture
from a replay.

Launch counts: each kernel wrapper adds one to a plain integer where it
launches its kernel (``flash_attention_kernel.launches``,
``flash_attention_bwd_kernel``'s ``dq_launches`` and ``dkv_launches``,
``flash_decode_kernel.launches``). A capture calls the wrappers, so they
count, but it runs nothing; a replay runs the captured kernels again without
calling any wrapper. ``counted_replay`` keeps the counts true: it takes the
capture's increments back out and adds them once per replay. A capture's
eager warm-up is the program's first real call and counts as one, so a
cached program counts what its eager body would.
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
    """(graph, replay, out, first): fn() run once eagerly on the capture
    stream (first is its result), then one more call of fn captured as a
    CUDA graph. Adds one to ``capture.captures``.

    The eager call is a real call (its effects stay); it also loads the
    kernels' modules and the capture stream's cuBLAS workspace, which the
    capture must not allocate. `generators` (CUDA ``torch.Generator``s fn
    draws from; the default one is registered by torch itself) advance on
    every replay as they would on an eager call. replay() is
    ``counted_replay``'s; out is the captured call's output, in the graph's
    memory, rewritten by every replay. A host read of a device value inside
    fn makes the capture raise; so does another thread's CUDA work during
    it. Nothing catches either.
    """
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    context = torch.cuda.graph(graph)
    stream = context.capture_stream
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        first = fn()
    torch.cuda.current_stream().wait_stream(stream)
    out = []

    def record():
        with context:
            out.append(fn())

    replay = counted_replay(graph, record)
    capture.captures += 1
    return graph, replay, out[0], first


capture.captures = 0


def leaves(tree) -> list:
    """The tensors of a tree of dicts (keys sorted), lists and tuples."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in leaves(item)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, item) for item in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype, t.device


def graph_key(static: tuple, copied=(), read=()) -> tuple:
    """A program's cache key: the static arguments `static` (hashable:
    configs, rates, counts, modes); the layout (shape, strides, dtype,
    device) of each tensor in the trees `copied`, which the program copies
    into static buffers of its own; and the layout and address of each
    tensor in the trees `read`, which its graph reads in place."""
    return (static, tuple(_layout(t) for t in leaves(copied)),
            tuple((t.data_ptr(), *_layout(t)) for t in leaves(read)))


#: program name -> (key, entry): one entry a program
_PROGRAMS: dict = {}


def lookup(program: str, key: tuple):
    """The entry cached for `program` under `key`, or None; an entry under
    another key is evicted (its graphs and pools go with it)."""
    held = _PROGRAMS.get(program)
    if held is not None and held[0] == key:
        return held[1]
    _PROGRAMS.pop(program, None)
    return None


def store(program: str, key: tuple, entry) -> None:
    """Cache `entry` (what holds a program's graphs and static buffers) for
    `program` under `key`, in place of any other."""
    _PROGRAMS[program] = (key, entry)


def cached(program: str):
    """The entry cached for `program` under whatever key, or None."""
    held = _PROGRAMS.get(program)
    return None if held is None else held[1]


def clear_graphs() -> None:
    """Drop every cached program: its graphs, its static buffers and its
    graphs' memory pools, which go back to the device. The counterpart of
    ``jax.clear_caches()``."""
    _PROGRAMS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class _Replayed:
    """A pure program's graph: the static buffers it reads (`inputs`), its
    counted replay and its output in the graph's memory."""

    def __init__(self, graph, replay, out, inputs):
        self.graph, self.replay, self.out, self.inputs = graph, replay, out, inputs


def replayed(program: str, key: tuple, fn, inputs: tuple):
    """fn(*inputs) as the CUDA graph cached for `program` under `key`. fn
    is pure: it reads its arguments and what its closure holds, and returns
    a tree of new tensors.

    inputs: trees of CUDA tensors, copied into static buffers that the
    graph reads (the key holds their layouts; what fn reads in place
    belongs in the key's `read`). A miss makes the buffers, runs fn on them
    eagerly and returns that result (the program's first call), then
    captures one more call. A hit copies the inputs in and replays. Either
    way the returned tensors are the caller's: a later call rewrites none
    of them, and the caller's inputs are only read.
    """
    entry = lookup(program, key)
    if entry is None:
        static = _tree_map(torch.clone, inputs)
        graph, replay, out, first = capture(lambda: fn(*static))
        store(program, key, _Replayed(graph, replay, out, leaves(static)))
        return first
    for buffer, value in zip(entry.inputs, leaves(inputs), strict=True):
        buffer.copy_(value)
    entry.replay()
    return _tree_map(torch.clone, entry.out)
