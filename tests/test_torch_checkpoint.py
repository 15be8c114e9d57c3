"""PyTorch port: the checkpoint store held against the JAX package's.

A tree saved by one package restores in the other, bitwise: the same
manifest (leaf paths in the reference's flattening order — dict keys
sorted, paths joined with ``/`` — shapes, dtypes, CRCs) and the same leaf
files byte for byte.  The CRC and truncation failures, the dtype and
shape checks, keep-N, ``latest`` and ``checkpoint_meta`` behave as the
reference's.  No tolerance: every comparison is bitwise.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.run.faults import FaultInjector as JInjector
from repro.run.faults import FaultPlan as JFaultPlan
from repro_torch.checkpoint import (CheckpointManager, checkpoint_meta,
                                    latest_step, load_checkpoint,
                                    load_checkpoint_flat, save_checkpoint)
from repro_torch.run.faults import FaultInjector, FaultPlan


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "z": rng.standard_normal((3, 4)).astype(np.float32),
        "a": {"ids": rng.integers(-5, 9, (5, 2)).astype(np.int32),
              "mask": rng.random((4,)) < 0.5,
              "big": rng.integers(0, 1 << 40, (3,)).astype(np.int64)},
        "m": {"words": rng.integers(0, 1 << 32, (2, 3), dtype=np.uint32),
              "scalar": np.asarray(3.5, np.float32)},
        "b/c": np.linspace(0.0, 1.0, 4, dtype=np.float32),
    }


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else
                (torch.from_numpy(v.view(np.int32)) if v.dtype == np.uint32
                 else torch.from_numpy(np.array(v))))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        p = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _same(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_port_save_matches_reference_save_byte_for_byte(tmp_path):
    """Same tree, both packages: equal manifests and leaf files."""
    tree = _arrays()
    jck.save_checkpoint(tmp_path / "j", 7, jnp_tree(tree),
                        meta={"schema": 1})
    save_checkpoint(tmp_path / "t", 7, tree, meta={"schema": 1})
    for root in ("j", "t"):
        assert (tmp_path / root / "latest").read_text() == "7"
    mj = json.loads((tmp_path / "j/step_000000007/manifest.json")
                    .read_text())
    mt = json.loads((tmp_path / "t/step_000000007/manifest.json")
                    .read_text())
    assert mt == mj
    assert [e["path"] for e in mt["leaves"]] == list(_flat(tree))
    for e in mt["leaves"]:
        assert ((tmp_path / "t/step_000000007" / e["file"]).read_bytes()
                == (tmp_path / "j/step_000000007" / e["file"]).read_bytes())


def jnp_tree(tree):
    """JAX arrays, int64 leaves left in numpy (jax without x64 would
    narrow them; the reference's stream snapshots keep them in numpy)."""
    return {k: (jnp_tree(v) if isinstance(v, dict) else
                v if v.dtype == np.int64 else jnp.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_port_save_restores_in_reference(tmp_path, leaves):
    """Nested dicts of int, bool, float and packed-word leaves (numpy, or
    torch tensors with the words as int32 bit patterns) saved by the port;
    the reference's ``load_checkpoint_flat`` reads them back bitwise."""
    tree = _arrays(1)
    save_checkpoint(tmp_path, 3, tree if leaves == "numpy"
                    else _torch_tree(tree))
    got, step = jck.load_checkpoint_flat(tmp_path)
    assert step == 3
    want = _flat(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        if leaves == "torch" and v.dtype == np.uint32:
            v = v.view(np.int32)
        _same(got[k], v)


def test_reference_save_restores_in_port(tmp_path):
    """A JAX tree saved by the reference: the port's flat restore and its
    structured restore (into tensors and into numpy) read it bitwise."""
    tree = _arrays(2)
    jck.save_checkpoint(tmp_path, 5, jnp_tree(tree), meta={"fp": "x"})
    got, step = load_checkpoint_flat(tmp_path)
    assert step == 5 and latest_step(tmp_path) == 5
    for k, v in _flat(tree).items():
        _same(got[k], v)
    like = {k: v for k, v in tree.items() if k != "m"}
    back, _ = load_checkpoint(tmp_path, like)
    for k, v in _flat(like).items():
        _same(_flat(back)[k], v)
    tlike = _torch_tree(like)
    tback, _ = load_checkpoint(tmp_path, tlike, device="cpu")
    for k, v in _flat(like).items():
        t = _flat(tback)[k]
        assert torch.is_tensor(t) and t.device.type == "cpu"
        _same(t.numpy(), v)
    assert checkpoint_meta(tmp_path) == {"fp": "x"}
    assert jck.checkpoint_meta(tmp_path) == checkpoint_meta(tmp_path)


def test_lists_and_none_flatten_as_the_reference(tmp_path):
    """Lists and tuples number their items; ``None`` holds no leaf."""
    tree = {"l": [np.arange(3, dtype=np.int32), np.ones(2, np.float32)],
            "t": (np.zeros(1, np.int64),), "n": None}
    jck.save_checkpoint(tmp_path / "j", 1,
                        {"l": [jnp.asarray(v) for v in tree["l"]],
                         "t": (jnp.asarray(tree["t"][0]),), "n": None})
    save_checkpoint(tmp_path / "t", 1, tree)
    mj, _ = jck.load_checkpoint_flat(tmp_path / "j")
    mt, _ = load_checkpoint_flat(tmp_path / "t")
    assert list(mt) == list(mj) == ["l/0", "l/1", "t/0"]
    back, _ = load_checkpoint(tmp_path / "t", tree)
    assert back["n"] is None and isinstance(back["t"], tuple)
    _same(back["l"][1], tree["l"][1])


@pytest.mark.parametrize("saver", ["port", "reference"])
@pytest.mark.parametrize("loader", ["port", "reference"])
def test_crc_detects_bitrot_both_ways(tmp_path, saver, loader):
    """The fault injector's flipped bytes fail the other package's CRC
    gate too; ``verify=False`` reads the damaged bytes."""
    x = np.arange(64, dtype=np.float64)
    (save_checkpoint if saver == "port" else jck.save_checkpoint)(
        tmp_path, 1, {"x": x})
    inj = (FaultInjector(FaultPlan(corrupt_stage="join"))
           if saver == "port" else
           JInjector(JFaultPlan(corrupt_stage="join")))
    assert inj.on_checkpoint_written("join", tmp_path / "step_000000001")
    load = (load_checkpoint_flat if loader == "port"
            else jck.load_checkpoint_flat)
    with pytest.raises(IOError, match="checksum mismatch"):
        load(tmp_path, step=1)
    got, _ = load(tmp_path, step=1, verify=False)
    assert got["x"].shape == (64,)


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_truncated_leaf_fails_the_load(tmp_path, saver):
    import os
    (save_checkpoint if saver == "port" else jck.save_checkpoint)(
        tmp_path, 1, {"x": np.arange(256, dtype=np.float32)})
    leaf = tmp_path / "step_000000001" / "leaf_00000.npy"
    os.truncate(leaf, leaf.stat().st_size // 2)
    for load in (load_checkpoint_flat, jck.load_checkpoint_flat):
        with pytest.raises((IOError, EOFError, ValueError)):
            load(tmp_path, step=1)


def test_dtype_and_shape_mismatch_raise(tmp_path):
    save_checkpoint(tmp_path, 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(tmp_path, {"x": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="dtype"):
        load_checkpoint(tmp_path, {"x": np.zeros(4, np.int32)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, {"x": torch.zeros(5)})


def test_save_async_copies_before_returning(tmp_path):
    """The host copy is taken on the calling thread: changing the tensor
    after ``save_async`` returns does not reach the checkpoint."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    mgr = CheckpointManager(tmp_path, keep_n=2)
    mgr.save_async(1, {"x": x, "n": {"y": torch.ones(3, dtype=torch.bool)}})
    x.zero_()
    mgr.wait()
    got, _ = mgr.restore_flat(1)
    _same(got["x"], np.arange(1 << 16, dtype=np.float32))
    assert got["n/y"].dtype == np.bool_ and got["n/y"].all()


def test_keep_n_latest_and_meta(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2)
    for s in (1, 2, 3):
        mgr.save(s, {"v": np.full(2, s, np.int32)}, meta={"s": s})
    assert mgr.available_steps() == [2, 3]
    assert jck.CheckpointManager(tmp_path).available_steps() == [2, 3]
    assert latest_step(tmp_path) == 3 == jck.latest_step(tmp_path)
    assert checkpoint_meta(tmp_path, 2) == {"s": 2}
    back, step = mgr.restore({"v": torch.zeros(2, dtype=torch.int32)}, 2)
    assert step == 2 and back["v"].tolist() == [2, 2]
    with pytest.raises(FileNotFoundError):
        load_checkpoint_flat(tmp_path / "none")
