"""The port's HotResumable against the JAX package's, on the CPU.

The same trees, made from numpy seeds, are written by both packages: the
``structure.json`` skeletons must be byte-equal and the loaded leaves
equal to the bit. The leaf store differs by design (orbax there, one
``.npy`` a leaf here, bf16 as its raw bits), so a checkpoint is not
loaded across packages. The reference's durable-write cases
(``tests/test_jaxside.py``) run here against the port, ``slow`` where
they are slow there.
"""

from __future__ import annotations

import json
import pathlib
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpumounter_tpu.jaxside.resume import HotResumable as JaxResumable
from gpumounter_tpu_torch.torchside import resume as resume_mod
from gpumounter_tpu_torch.torchside.resume import (HotResumable,
                                                   load_optimizer_state,
                                                   optimizer_state_tree)

REPO_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)

# A two-field namedtuple each package trusts on load: optax's for the
# reference, torch's for the port. Saving does not resolve the class, so
# the skeleton test uses one class for both.
PortPair = torch.nn.modules.module._IncompatibleKeys
JaxPair = optax.ScaleByLionState


def _arrays(seed: int):
    """(f32 matrix, bf16 bits of another, f32 0-d), from a numpy seed."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf16_bits = torch.from_numpy(rng.standard_normal((5, 2)).astype(np.float32)
                                 ).bfloat16().view(torch.int16).numpy().view(np.uint16)
    return f32, bf16_bits, np.float32(rng.standard_normal())


def _tree(seed: int, side: str, pair=None):
    """One tree for either package: nested dict, list, tuple, None, a
    namedtuple, f32, bf16 and 0-d leaves, and Python scalars."""
    f32, bits, zero_d = _arrays(seed)
    if side == "jax":
        w, b16, z = f32, bits.view(jnp.bfloat16), zero_d
    else:
        w = torch.from_numpy(f32.copy())
        b16 = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
        z = torch.tensor(zero_d)
    pair = pair or (JaxPair if side == "jax" else PortPair)
    inner = pair(w, z)
    return {"params": {"w": w, "b16": b16}, "zero_d": z,
            "opt": [inner, (1e-3, 0.9), None],
            "step": 7, "flag": True, "lr": 2.5e-4,
            "nested": {"a": [z, {"b": (b16, 3.0)}]}}


def _leaf_bits(x) -> tuple[str, bytes]:
    """A leaf's dtype name and raw bytes, whichever package loaded it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def _flatten(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _flatten(x)]
    return [tree]


def _latest(path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path / (path / "LATEST").read_text().strip()


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_structure_json_is_the_reference_s_byte_for_byte(tmp_path, seed):
    JaxResumable.pack(_tree(seed, "jax", PortPair), {"more": [1, 2]}).save(
        str(tmp_path / "jax"))
    HotResumable.pack(_tree(seed, "torch", PortPair), {"more": [1, 2]}).save(
        str(tmp_path / "torch"))
    want = (_latest(tmp_path / "jax") / "structure.json").read_bytes()
    got = (_latest(tmp_path / "torch") / "structure.json").read_bytes()
    assert got == want
    assert json.loads(got)["t"] == "tuple"


@pytest.mark.parametrize("seed", SEEDS)
def test_loaded_leaves_equal_the_reference_s_to_the_bit(tmp_path, seed):
    JaxResumable.pack(_tree(seed, "jax")).save(str(tmp_path / "jax"))
    HotResumable.pack(_tree(seed, "torch")).save(str(tmp_path / "torch"))
    want = _flatten(JaxResumable.load(str(tmp_path / "jax")).host_state)
    got = _flatten(HotResumable.load(str(tmp_path / "torch")).host_state)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want, strict=True):
        assert _leaf_bits(g) == _leaf_bits(w)
    # Every host leaf is a CPU tensor; Python scalars took numpy's dtypes.
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" for g in got)
    (loaded,) = HotResumable.load(str(tmp_path / "torch")).host_state
    assert isinstance(loaded["opt"][0], PortPair)
    assert loaded["opt"][2] is None and isinstance(loaded["opt"][1], tuple)
    assert (loaded["step"].dtype, loaded["flag"].dtype, loaded["lr"].dtype) == (
        torch.int64, torch.bool, torch.float64)


def test_leaf_store_is_npy_with_a_dtype_sidecar(tmp_path):
    """One .npy a leaf, bf16 stored as uint16 bits, the dtypes beside them
    in leaves/ and never in structure.json; nothing needs a pickle."""
    HotResumable.pack(_tree(0, "torch")).save(str(tmp_path))
    leaves = _latest(tmp_path) / "leaves"
    dtypes = json.loads((leaves / "dtypes.json").read_text())
    assert sorted(p.name for p in leaves.glob("*.npy")) == [f"l{i:06d}.npy" for i in range(13)]
    bf16 = [name for name, dtype in dtypes.items() if dtype == "bfloat16"]
    assert len(bf16) == 2 and dtypes["l000000"] == "bool"
    for name in bf16:
        assert np.load(leaves / f"{name}.npy", allow_pickle=False).dtype == np.uint16
    assert "dtype" not in (_latest(tmp_path) / "structure.json").read_text()


def test_bf16_and_adamw_state_round_trip_exactly(tmp_path):
    """A bf16 model's params and its AdamW state (bf16 moments, the f32
    step) through pack, save, load, restore: every tensor equal to the
    bit, the hyperparameters Python scalars again, and the next step equal
    to the uninterrupted optimizer's."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(4, 8, generator=gen).bfloat16().requires_grad_()
              for _ in range(3)]
    opt = torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)
    for _ in range(2):
        opt.zero_grad()
        sum((p.float() ** 2).sum() for p in params).backward()
        opt.step()
    HotResumable.pack(params, optimizer_state_tree(opt)).save(str(tmp_path))
    new_params, tree = HotResumable.load(str(tmp_path)).restore("cpu")
    new_params = [p.requires_grad_() for p in new_params]
    for p, q in zip(params, new_params):
        assert q.dtype == torch.bfloat16 and torch.equal(p.detach(), q.detach())
    new_opt = torch.optim.AdamW(new_params, lr=5.0)
    load_optimizer_state(new_opt, tree)
    want, got = opt.state_dict(), new_opt.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for key, value in got["param_groups"][0].items():
        assert type(value) is type(want["param_groups"][0][key]), key
    for i in want["state"]:
        for name, t in want["state"][i].items():
            g = got["state"][i][name]
            assert g.dtype == t.dtype and g.device == t.device and torch.equal(g, t)
    for o, ps in ((opt, params), (new_opt, new_params)):
        o.zero_grad()
        sum((p.float() ** 2).sum() for p in ps).backward()
        o.step()
    for p, q in zip(params, new_params):
        assert torch.equal(p.detach(), q.detach())


def test_optimizer_state_tree_refuses_tensor_hyperparameters():
    p = torch.zeros(2, requires_grad=True)
    opt = torch.optim.SGD([p], lr=torch.tensor(0.1))
    with pytest.raises(TypeError, match="Python-scalar"):
        optimizer_state_tree(opt)


def test_save_refuses_non_str_keys_and_unknown_leaves(tmp_path):
    with pytest.raises(TypeError, match="keys must be str"):
        HotResumable.pack({0: torch.zeros(1)}).save(str(tmp_path / "a"))
    with pytest.raises(TypeError, match="state dict first"):
        HotResumable.pack({"x": object()})
    with pytest.raises(TypeError, match="state dict first"):
        HotResumable(host_state=({"x": "text"},)).save(str(tmp_path / "b"))


def test_restore_takes_one_device(tmp_path):
    state = HotResumable.pack({"w": torch.ones(2)})
    with pytest.raises(NotImplementedError, match="item 6"):
        state.restore("cpu", specs=({"w": None},))
    (tree,) = state.restore("cpu")
    tree["w"].add_(1)  # a copy: the snapshot is not touched
    assert torch.equal(state.host_state[0]["w"], torch.ones(2))


def test_restore_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; restore('cuda') works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HotResumable.pack({"w": torch.ones(2)}).restore()


# --- the reference's durable-write cases (tests/test_jaxside.py) ---

@pytest.mark.slow
def test_checkpoint_survives_process_boundary(tmp_path):
    """save() then load() in a fresh process: values and the tree's
    structure round-trip exactly, including an AdamW state carried by
    optimizer_state_tree."""
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": 7.0}
    p = torch.zeros(3, 4, requires_grad=True)
    opt = torch.optim.AdamW([p], lr=1e-3)
    p.sum().backward()
    opt.step()
    snap = HotResumable.pack(state, optimizer_state_tree(opt))
    ckpt = str(tmp_path / "ckpt")
    snap.save(ckpt)
    snap.save(ckpt)  # overwrite: pointer moves, old version pruned

    prog = f"""
import sys
sys.path.insert(0, {REPO_ROOT!r})
import torch
from gpumounter_tpu_torch.torchside.resume import HotResumable, load_optimizer_state
state, tree = HotResumable.load({ckpt!r}).restore("cpu")
assert torch.equal(state["w"], torch.arange(12, dtype=torch.float32).reshape(3, 4))
assert state["b"].item() == 7.0
p = torch.zeros(3, 4, requires_grad=True)
opt = torch.optim.AdamW([p], lr=5.0)
load_optimizer_state(opt, tree)
group = opt.state_dict()["param_groups"][0]
assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999), group
assert opt.state_dict()["state"][0]["step"].item() == 1.0
print("CKPT_OK")
"""
    out = subprocess.run([sys.executable, "-c", prog],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CKPT_OK" in out.stdout
    entries = [e for e in (tmp_path / "ckpt").iterdir()
               if e.name.startswith("v-")]
    assert len(entries) == 1, entries


def test_checkpoint_torn_write_restores_previous(tmp_path):
    """Crash between the version write and the pointer swap: LATEST still
    names the old complete version; load() returns it, and the next save()
    sweeps the orphaned partial version."""
    ckpt = tmp_path / "ckpt"
    HotResumable.pack({"w": np.float32(1.0)}).save(str(ckpt))
    torn = ckpt / "v-torn0000"
    torn.mkdir()
    (torn / "garbage").write_bytes(b"\x00" * 16)

    loaded = HotResumable.load(str(ckpt))
    assert float(loaded.host_state[0]["w"]) == 1.0

    HotResumable.pack({"w": np.float32(2.0)}).save(str(ckpt))
    versions = [e.name for e in ckpt.iterdir() if e.name.startswith("v-")]
    assert len(versions) == 1, versions  # torn orphan swept
    assert float(HotResumable.load(str(ckpt)).host_state[0]["w"]) == 2.0


@pytest.mark.slow
def test_checkpoint_survives_kill9_mid_save(tmp_path):
    """SIGKILL a process mid-save loop; LATEST still names a complete
    checkpoint (one of the fully-written versions)."""
    ckpt = str(tmp_path / "ckpt")
    prog = f"""
import sys
sys.path.insert(0, {REPO_ROOT!r})
import numpy as np
from gpumounter_tpu_torch.torchside.resume import HotResumable
i = 0
while True:
    i += 1
    HotResumable.pack({{"step": np.int64(i),
                        "w": np.full((64, 64), i, np.float32)}}).save({ckpt!r})
    print(i, flush=True)
"""
    proc = subprocess.Popen([sys.executable, "-c", prog],
                            stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert line.strip()
    time.sleep(0.45)  # land mid-save with high probability
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)

    loaded = HotResumable.load(ckpt)
    step = int(loaded.host_state[0]["step"])
    assert step >= 1
    assert torch.equal(loaded.host_state[0]["w"],
                       torch.full((64, 64), float(step)))


def test_checkpoint_refuses_untrusted_namedtuple(tmp_path):
    """structure.json is data, not code: a forged namedtuple node pointing
    outside the trusted module prefixes is refused, never imported."""
    ckpt = tmp_path / "ckpt"
    HotResumable.pack({"w": np.float32(1.0)}).save(str(ckpt))
    sj = _latest(ckpt) / "structure.json"
    skel = json.loads(sj.read_text())
    evil = {"t": "namedtuple", "module": "os.path", "qualname": "join",
            "fields": [], "items": []}
    sj.write_text(json.dumps({"t": "tuple", "items": [evil, skel]}))
    with pytest.raises(ValueError, match="trusted"):
        HotResumable.load(str(ckpt))


def test_checkpoint_legacy_treedef_pkl_clear_error(tmp_path):
    """A legacy checkpoint (pickled treedef, no structure.json) fails with
    an actionable message, and is never unpickled."""
    import pickle

    ckpt = tmp_path / "ckpt"
    legacy = ckpt / "v-legacy00"
    legacy.mkdir(parents=True)
    payload = (b"cbuiltins\nexec\n"
               b"(Vraise SystemError('treedef.pkl was unpickled')\n"
               b"tR.")
    with pytest.raises(SystemError):  # the payload is really armed
        pickle.loads(payload)
    (legacy / "treedef.pkl").write_bytes(payload)
    (ckpt / "LATEST").write_text("v-legacy00")
    with pytest.raises(ValueError, match="legacy treedef.pkl"):
        HotResumable.load(str(ckpt))


@pytest.mark.parametrize("swept", ["l000000.npy", "dtypes.json", "structure.json"])
def test_checkpoint_load_retries_after_concurrent_sweep(tmp_path, monkeypatch,
                                                        swept):
    """If a concurrent save() sweeps the version LATEST named between the
    pointer read and the file reads, load() re-reads LATEST and retries;
    with no writer moving the pointer the original error surfaces after
    one re-read."""
    ckpt = tmp_path / "ckpt"
    HotResumable.pack({"w": np.float32(3.0)}).save(str(ckpt))

    real_once = HotResumable._load_once.__func__
    calls = {"n": 0}
    stamps = []

    def racy_once(cls, path, stamp):
        calls["n"] += 1
        stamps.append(stamp)
        if calls["n"] == 1:
            # The writer commits a new (identical) version, then sweeps
            # part of the one this reader resolved.
            import shutil
            shutil.copytree(str(ckpt / stamp), str(ckpt / "v-recommit0"))
            (ckpt / "LATEST").write_text("v-recommit0")
            victim = ckpt / stamp / ("leaves" if swept != "structure.json" else "") / swept
            victim.unlink()
        return real_once(cls, path, stamp)

    monkeypatch.setattr(resume_mod.HotResumable, "_load_once",
                        classmethod(racy_once))
    loaded = HotResumable.load(str(ckpt))
    assert float(loaded.host_state[0]["w"]) == 3.0
    assert calls["n"] == 2
    assert stamps[0] != stamps[1]  # the retry resolved the NEW version

    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "LATEST").write_text("v-gone")
    with pytest.raises(FileNotFoundError):
        HotResumable.load(str(empty))


def test_checkpoint_load_deterministic_valueerror_not_retried(
        tmp_path, monkeypatch):
    """A ValueError (forged structure.json, legacy format) is
    deterministic: load() raises it at once, without reading the leaves
    again."""
    ckpt = tmp_path / "ckpt"
    HotResumable.pack({"w": np.float32(1.0)}).save(str(ckpt))
    calls = {"n": 0}

    def once(cls, path, stamp):
        calls["n"] += 1
        raise ValueError("namedtuple evil.mod outside trusted prefixes")

    monkeypatch.setattr(resume_mod.HotResumable, "_load_once",
                        classmethod(once))
    with pytest.raises(ValueError, match="trusted"):
        HotResumable.load(str(ckpt))
    assert calls["n"] == 1
