"""Carry a training state across a change of the device set.

CUDA enumerates its devices once, when a process first initialises it, so
a GPU mounted into a running container is invisible to a process that has
touched CUDA. Hot-adding a GPU to a PyTorch job is therefore

    state = HotResumable.pack(params, optimizer_state_tree(opt))  # device → host
    visibility.handoff(state, path, env=new_env)  # save, exec a fresh image
    # ... in the new image:
    wait_for_gpus(expected)
    params, opt_tree = HotResumable.load(path).restore("cuda")     # host → device

The on-disk layout is the JAX package's (``jaxside/resume.py``): the same
``structure.json`` skeleton, ``v-<uuid>`` version directories, an atomic
``LATEST`` pointer, the same fsync order and sweep, an advisory ``flock``
and a loader that retries while a concurrent save moves the pointer. One
part differs by design: the leaves. The reference writes them through
orbax, which needs JAX; here each leaf is one ``leaves/l%06d.npy``, read
back with ``allow_pickle=False``. numpy has no bfloat16, so a bf16 tensor
is stored as its raw bits (uint16), and ``leaves/dtypes.json`` records
every leaf's torch dtype. Nothing in a checkpoint is a pickle.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from gpumounter_tpu_torch._device import resolve_device

logger = logging.getLogger(__name__)

#: the sidecar in ``leaves/`` naming each leaf's torch dtype
DTYPES_FILE = "dtypes.json"


@dataclass
class HotResumable:
    """Host-memory snapshot of a tree of tensors: nested dict, list, tuple,
    namedtuple and None containers, with tensors, numpy arrays and Python
    scalars as leaves. On the host every leaf is a CPU tensor (numpy holds
    no bfloat16); a Python scalar becomes a 0-d tensor of numpy's dtype for
    it (float64, int64, bool)."""

    host_state: Any

    @classmethod
    def pack(cls, *trees: Any) -> "HotResumable":
        """Copy every leaf to host memory (the copy survives the process
        image that made it, through ``save``)."""
        host = tuple(_map_tree(_to_host, tree) for tree in trees)
        logger.debug("packed %d tree(s) to host", len(trees))
        return cls(host_state=host)

    def restore(self, device="cuda", specs: Any = None) -> tuple:
        """Copy every leaf onto `device` (default the current CUDA device;
        raises when CUDA is not available, unless the caller asks for the
        CPU). Returns the packed trees as a tuple.

        Sharded restore, over a device mesh with one placement per leaf,
        comes with multi-GPU parallelism over torch.distributed
        (ROADMAP.md §1, item 6); a non-None `specs` raises until then."""
        if specs is not None:
            raise NotImplementedError(
                "sharded restore (a device mesh and per-leaf specs) comes with "
                "multi-GPU parallelism over torch.distributed (ROADMAP.md §1, "
                "item 6: parallel/ across several GPUs); restore takes one "
                "device")
        device = resolve_device(device)
        out = tuple(_map_tree(lambda t: t.to(device, copy=True), tree)
                    for tree in self.host_state)
        logger.info("restored %d tree(s) onto %s", len(out), device)
        return out

    def save(self, path: str) -> None:
        """Durable on-disk checkpoint: survives process death and node power
        loss. The properties are the reference's:

          * the tree's structure round-trips through a JSON skeleton
            (``structure.json``), never a pickle. Dict keys must be str
            (save raises otherwise) and dicts come back in sorted-key
            order;
          * crash-safe overwrite: every save writes a fresh version
            directory, then atomically ``os.replace``s a ``LATEST``
            pointer;
          * power-loss safety: every file and directory of the new version
            is fsynced before the pointer swap, the temporary pointer
            before the rename, and the checkpoint directory after it;
          * after the pointer moves, every other ``v-*`` directory and
            stale ``.LATEST.*`` pointer is swept; concurrent savers to one
            path are serialised by an advisory ``flock`` on
            ``<path>/.lock`` (a reader that races a save retries, see
            ``load``).
        """
        import fcntl
        import shutil
        import uuid

        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        stamp = f"v-{uuid.uuid4().hex}"
        target = os.path.join(path, stamp)
        with open(os.path.join(path, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            flat, skeleton = _encode_tree(self.host_state)
            _write_leaves(os.path.join(target, "leaves"), flat)
            _write_fsynced(os.path.join(target, "structure.json"),
                           _json_dumps(skeleton).encode())
            _fsync_dir_tree(target)             # leaves + dirs durable
            latest = os.path.join(path, "LATEST")
            tmp = os.path.join(path, f".LATEST.{stamp}")
            _write_fsynced(tmp, stamp.encode())
            os.replace(tmp, latest)             # the atomic commit
            _fsync_path(path)                   # the rename itself
            for entry in os.listdir(path):      # sweep ALL stale junk
                stale_version = (entry.startswith("v-")
                                 and entry != stamp)
                stale_tmp_pointer = entry.startswith(".LATEST.")
                if stale_version:
                    shutil.rmtree(os.path.join(path, entry),
                                  ignore_errors=True)
                elif stale_tmp_pointer:
                    try:
                        os.unlink(os.path.join(path, entry))
                    except OSError:
                        pass
        logger.info("checkpointed %d leaves to %s (%s)",
                    len(flat), path, stamp)

    @classmethod
    def load(cls, path: str) -> "HotResumable":
        """Inverse of save(); restore() then puts the state on a device of
        the (possibly new) process.

        If the version LATEST named is swept by a concurrent save between
        reading the pointer and reading the files, re-read LATEST and
        retry. The loop converges on the stamp: it retries only while each
        failed attempt resolved a different version than the previous one
        (the writer moved the pointer); an unchanged stamp means the files
        are missing, and the first error surfaces. A swept leaf surfaces
        here as FileNotFoundError and only that is retried; any ValueError
        (the legacy format, a forged ``structure.json``) is deterministic
        and raised at once. A bounded attempt cap guards against a writer
        that outraces a slow reader forever.
        """
        path = os.path.abspath(path)
        last_stamp = None
        first_err = None
        for _ in range(8):
            with open(os.path.join(path, "LATEST")) as f:
                stamp = f.read().strip()
            if first_err is not None and stamp == last_stamp:
                raise first_err
            last_stamp = stamp
            try:
                return cls._load_once(path, stamp)
            except FileNotFoundError as err:
                # Version swept between pointer read and file read.
                first_err = first_err or err
        raise first_err

    @classmethod
    def _load_once(cls, path: str, stamp: str) -> "HotResumable":
        target = os.path.join(path, stamp)
        if (not os.path.exists(os.path.join(target, "structure.json"))
                and os.path.exists(os.path.join(target, "treedef.pkl"))):
            # The oldest layout pickled the tree structure. Checkpoint
            # directories may be attacker-writable, so it is never
            # unpickled: fail with an actionable message instead of a bare
            # FileNotFoundError on structure.json.
            raise ValueError(
                f"checkpoint {target} is in the legacy treedef.pkl "
                f"format; load it with the release that wrote it and "
                f"re-save to migrate (this loader never unpickles)")
        flat = _read_leaves(os.path.join(target, "leaves"))
        with open(os.path.join(target, "structure.json")) as f:
            skeleton = json.load(f)
        return cls(host_state=_decode_tree(skeleton, flat))


# --- leaves ---

def _to_host(x) -> torch.Tensor:
    """pack's leaf copy: a CPU tensor that shares no memory with `x`."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x))


def _leaf_file(i: int) -> str:
    return f"l{i:06d}"


def _write_leaves(leaves_dir: str, flat: list) -> None:
    """One ``.npy`` a leaf and the dtype sidecar; the caller fsyncs."""
    os.makedirs(leaves_dir)
    dtypes = {}
    for i, leaf in enumerate(flat):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else _to_host(leaf)
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()  # raises TypeError for a dtype numpy lacks
        np.save(os.path.join(leaves_dir, _leaf_file(i) + ".npy"), arr,
                allow_pickle=False)
        dtypes[_leaf_file(i)] = str(t.dtype).removeprefix("torch.")
    with open(os.path.join(leaves_dir, DTYPES_FILE), "w") as f:
        json.dump(dtypes, f, separators=(",", ":"))


def _read_leaves(leaves_dir: str) -> list[torch.Tensor]:
    """The leaves in index order, as CPU tensors of their recorded dtypes."""
    with open(os.path.join(leaves_dir, DTYPES_FILE)) as f:
        dtypes = json.load(f)
    flat = []
    for i in range(len(dtypes)):
        name = _leaf_file(i)
        want = dtypes.get(name)
        arr = np.load(os.path.join(leaves_dir, name + ".npy"),
                      allow_pickle=False)
        if want == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if str(t.dtype).removeprefix("torch.") != want:
            raise ValueError(f"checkpoint leaf {name}: stored as {arr.dtype}, "
                             f"{DTYPES_FILE} records {want!r}")
        flat.append(t)
    return flat


# --- durable-write helpers ---

def _write_fsynced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _fsync_path(path: str) -> None:
    """fsync a file or directory by fd (directories need O_RDONLY)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir_tree(root: str) -> None:
    """fsync every file and directory under root, bottom-up — after
    this returns, the whole version directory is on stable storage."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            _fsync_path(os.path.join(dirpath, name))
        _fsync_path(dirpath)


# --- tree structure codec (pickle-free) ---
#
# The skeleton is plain JSON; leaves are referenced by flatten index.
# Namedtuple nodes record module + qualname and are re-imported on load,
# restricted to _TRUSTED_MODULE_PREFIXES — the trust model is "the
# checkpoint dir may be attacker-writable": a forged structure.json can at
# worst import an already-installed torch or port attribute, never run
# embedded code the way a pickle would.

_TRUSTED_MODULE_PREFIXES = ("torch", "gpumounter_tpu_torch", "collections",
                            "builtins")

_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _check_leaf(node) -> None:
    if not isinstance(node, _LEAF_TYPES):
        raise TypeError(
            f"checkpoint contains a {type(node).__module__}."
            f"{type(node).__qualname__} node; the durable format supports "
            f"dict/list/tuple/namedtuple/None containers with tensor, numpy "
            f"or Python-number leaves only — convert other objects to a "
            f"state dict first")


def _map_tree(fn, tree):
    """`tree` with fn applied to every leaf; dicts come back in sorted-key
    order, namedtuples as their own class."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_tree(fn, tree[key]) for key in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, x) for x in tree)
    if isinstance(tree, list):
        return [_map_tree(fn, x) for x in tree]
    _check_leaf(tree)
    return fn(tree)


def _encode_tree(tree):
    """(leaves, skeleton): walk `tree` depositing leaves in order (dict
    keys sorted, matching the load-side walk)."""
    leaves: list = []

    def enc(node):
        if node is None:
            return {"t": "none"}
        if isinstance(node, dict):
            keys = sorted(node)
            if any(not isinstance(key, str) for key in keys):
                raise TypeError("checkpoint dict keys must be str, got "
                                f"{[type(key).__name__ for key in keys]}")
            return {"t": "dict", "keys": keys,
                    "vals": [enc(node[key]) for key in keys]}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            cls = type(node)
            return {"t": "namedtuple", "module": cls.__module__,
                    "qualname": cls.__qualname__,
                    "fields": list(node._fields),
                    "items": [enc(x) for x in node]}
        if isinstance(node, tuple):
            return {"t": "tuple", "items": [enc(x) for x in node]}
        if isinstance(node, list):
            return {"t": "list", "items": [enc(x) for x in node]}
        _check_leaf(node)
        leaves.append(node)
        return {"t": "leaf", "i": len(leaves) - 1}

    return leaves, enc(tree)


def _resolve_namedtuple(module: str, qualname: str, fields: list):
    import importlib
    root = module.split(".")[0]
    if root not in _TRUSTED_MODULE_PREFIXES:
        raise ValueError(
            f"checkpoint references namedtuple {module}.{qualname} "
            f"outside the trusted prefixes {_TRUSTED_MODULE_PREFIXES}; "
            f"refusing to import it")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not (isinstance(obj, type) and issubclass(obj, tuple)
            and getattr(obj, "_fields", None) is not None):
        raise ValueError(f"{module}.{qualname} is not a namedtuple class")
    if list(obj._fields) != list(fields):
        raise ValueError(
            f"namedtuple {module}.{qualname} fields changed: checkpoint "
            f"has {fields}, installed class has {list(obj._fields)} — "
            f"library version mismatch")
    return obj


def _decode_tree(skeleton, flat):
    def dec(node):
        kind = node["t"]
        if kind == "none":
            return None
        if kind == "leaf":
            return flat[node["i"]]
        if kind == "dict":
            return {key: dec(val)
                    for key, val in zip(node["keys"], node["vals"])}
        if kind == "tuple":
            return tuple(dec(x) for x in node["items"])
        if kind == "list":
            return [dec(x) for x in node["items"]]
        if kind == "namedtuple":
            cls = _resolve_namedtuple(node["module"], node["qualname"],
                                      node["fields"])
            return cls(*(dec(x) for x in node["items"]))
        raise ValueError(f"unknown skeleton node type {kind!r}")

    return dec(skeleton)


def _json_dumps(skeleton) -> str:
    return json.dumps(skeleton, separators=(",", ":"))


# --- optimizer state ---

def optimizer_state_tree(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` as a tree the codec takes: ``state`` keyed by
    the str of each parameter index (the codec refuses int keys), and
    ``param_groups`` as they are. A tensor-valued hyperparameter (a tensor
    lr, say) is refused: ``load_optimizer_state`` gives every
    ``param_groups`` leaf back as a Python scalar."""
    sd = opt.state_dict()

    def check(x):
        if isinstance(x, torch.Tensor):
            raise TypeError("optimizer_state_tree carries Python-scalar "
                            "hyperparameters only; a param group holds a "
                            f"tensor {tuple(x.shape)}")
        return x

    groups = [_map_tree(check, group) for group in sd["param_groups"]]
    return {"state": {str(key): val for key, val in sd["state"].items()},
            "param_groups": groups}


def load_optimizer_state(opt: torch.optim.Optimizer, tree: dict) -> None:
    """Load a tree of ``optimizer_state_tree``'s shape, after pack, save,
    load and restore, into `opt` (built over the restored parameters, in
    the same order). The ``param_groups`` leaves, which come back as 0-d
    tensors, become Python scalars again (float, int or bool by dtype).
    Each ``step`` goes back to the CPU, where torch.optim keeps it unless
    the group is ``capturable`` or ``fused`` (``load_state_dict`` then
    moves it to the parameter's device itself)."""
    def scalar(x):
        return x.item() if hasattr(x, "item") else x

    state = {}
    for key, val in tree["state"].items():
        val = dict(val)
        if isinstance(val.get("step"), torch.Tensor):
            val["step"] = val["step"].cpu()
        state[int(key)] = val
    groups = [_map_tree(scalar, group) for group in tree["param_groups"]]
    opt.load_state_dict({"state": state, "param_groups": groups})
