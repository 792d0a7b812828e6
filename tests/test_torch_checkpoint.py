"""Sharded checkpoints of the PyTorch port (cora_tpu_torch.parallel.checkpoint,
on torch.distributed.checkpoint) on the CPU.

A world of 2 gloo ranks saves a tree of DTensors (sharded over rows and
over columns), a numpy array and a plain tensor, and a Map container whose
dataset is a DTensor; worlds of 4 and of 1 restore them onto other
placements, and without a mesh, bit for bit (tests/torch_dist_worker.py:
subprocesses, a file:// rendezvous, 170 s per world).  In this process,
with no process group: round trips of tensors and numpy arrays, the
restore template, the container sidecar (ndarray attrs, dataset attrs,
index maps, the class restored by name) and the refusal to overwrite.
"""

import os

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint.api import CheckpointException

import torch_dist_worker as worker
from cora_tpu_torch.core.containers import Map
from cora_tpu_torch.parallel import checkpoint as ck

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("checkpoint"))
    ckpt = os.path.join(out, "ck")
    res = {"save": worker.run_world(2, "checkpoint_save", out, ckpt=ckpt)}
    for w in (4, 1):
        res[w] = worker.run_world(w, "checkpoint_restore", out, ckpt=ckpt)
    return res


def test_each_rank_writes_its_own_shards(worlds):
    files = list(worlds["save"]["files"])
    assert ".metadata" in files
    assert sum(f.endswith(".distcp") for f in files) == 2


@pytest.mark.parametrize("world", [4, 1])
def test_tree_restores_across_world_sizes_bit_for_bit(worlds, world):
    r, t = worlds[world], worker.checkpoint_tree()
    for k in ("x", "y", "host"):
        assert r[k].dtype == t[k].dtype
        np.testing.assert_array_equal(r[k], t[k])
    np.testing.assert_array_equal(r["z"], t["nested"]["z"])
    np.testing.assert_array_equal(r["x_plain"], t["x"])
    assert bool(r["host_is_numpy"])
    # x was saved sharded over rows, restored sharded over columns
    assert tuple(r["x_local_shape"]) == (8, -(-6 // world))


@pytest.mark.parametrize("world", [4, 1])
def test_container_restores_across_world_sizes(worlds, world):
    r = worlds[world]
    cont, sky = worker.checkpoint_map()
    np.testing.assert_array_equal(r["map"], sky)
    np.testing.assert_array_equal(r["map_sharded"], sky)
    assert tuple(r["map_local_shape"]) == (8, 1, 192 // world)
    assert str(r["map_class"]) == "cora_tpu_torch.core.containers.Map"
    assert str(r["map_tag"]) == "testmap" and str(r["map_units"]) == "K"
    np.testing.assert_array_equal(r["map_vec"], cont.attrs["vec"])
    np.testing.assert_array_equal(r["map_freq"], cont.index_map["freq"])
    np.testing.assert_array_equal(r["map_pol"], cont.index_map["pol"])
    assert int(r["map_nside"]) == 4


def test_roundtrip_without_a_process_group(tmp_path):
    t = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
         "b": np.linspace(0.0, 1.0, 7), "c": {"d": torch.ones(2, dtype=torch.int64)}}
    path = ck.save_sharded(tmp_path / "ck", t)
    assert os.path.isabs(path)
    out = ck.restore_sharded(path, t)
    assert torch.equal(out["a"], t["a"]) and torch.equal(out["c"]["d"], t["c"]["d"])
    assert isinstance(out["b"], np.ndarray)
    np.testing.assert_array_equal(out["b"], t["b"])
    with pytest.raises(FileExistsError):
        ck.save_sharded(tmp_path / "ck", t, overwrite=False)
    t["a"] = t["a"] + 1
    ck.save_sharded(tmp_path / "ck", t)  # overwrite replaces the checkpoint
    assert torch.equal(ck.restore_sharded(path, t)["a"], t["a"])


def test_abstract_like_allocates_nothing_and_keeps_placement():
    t = {"a": torch.zeros(3, 4, dtype=torch.float64), "b": np.zeros(5, np.float32)}
    spec = ck.abstract_like(t)
    assert spec["a"] == ck.ArraySpec((3, 4), torch.float64, device=torch.device("cpu"))
    assert spec["b"] == ck.ArraySpec((5,), torch.float32, host=True)


def test_container_roundtrip_without_a_process_group(tmp_path):
    cont, sky = worker.checkpoint_map()
    cont.datasets["map"] = torch.from_numpy(sky)
    ck.save_container(tmp_path / "map", cont)
    back = ck.load_container(tmp_path / "map", device="cpu")
    assert type(back) is Map
    assert torch.equal(back["map"], cont["map"])
    assert back.attrs["tag"] == "testmap" and back._dataset_attrs("map")["units"] == "K"
    np.testing.assert_array_equal(back.attrs["vec"], cont.attrs["vec"])
    np.testing.assert_array_equal(back.index_map["freq"], cont.index_map["freq"])
    assert back.nside == cont.nside and list(back.index_map["pol"]) == ["I"]
    other = ck.load_container(tmp_path / "map", cls=Map, device="cpu")
    assert torch.equal(other["map"], cont["map"])


def test_restore_into_a_wrong_shape_raises(tmp_path):
    path = ck.save_sharded(tmp_path / "ck", {"a": torch.zeros(3, 4)})
    with pytest.raises(CheckpointException):
        ck.restore_sharded(path, {"a": torch.empty(4, 4)})
