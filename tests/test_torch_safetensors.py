"""The port's safetensors reader and writer (spatialvla_tpu_torch/convert/
safetensors_io.py) against the ``safetensors`` package, both ways: what the
port writes the package reads back equal (and byte for byte as the package
writes it), what the package writes the port reads back equal, for every
dtype the checkpoints use, bf16 through ``safetensors.torch``, in one file
and in sharded directories with ``model.safetensors.index.json``."""
import json
import os

import numpy as np
import pytest
import torch

from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as pt_load_file
from safetensors.torch import save_file as pt_save_file

from spatialvla_tpu_torch.convert import safetensors_io as sio

NP_DTYPES = {"F32": np.float32, "F16": np.float16, "I8": np.int8, "U8": np.uint8,
             "I32": np.int32, "I64": np.int64, "BOOL": np.bool_}


def _np_tensors(seed=0):
    """One tensor of each numpy dtype, odd shapes, an empty one and a scalar."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, (name, dt) in enumerate(NP_DTYPES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), (1, 9), (4, 1), (5, 2), (6,)][i]
        if dt is np.bool_:
            out[f"t.{name}"] = rng.rand(*shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            out[f"t.{name}"] = rng.randint(max(info.min, -1000), min(info.max, 1000),
                                           size=shape).astype(dt)
        else:
            out[f"t.{name}"] = (rng.randn(*shape) * 3).astype(dt)
    out["empty"] = np.zeros((0, 4), np.float32)
    out["scalar"] = np.array(2.5, np.float32)
    return out


def _bf16_tensors(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"a.bf16": (torch.randn(4, 6, generator=g) * 100).to(torch.bfloat16),
            "b.f32": torch.randn(3, generator=g), "c.i8": torch.arange(-5, 5, dtype=torch.int8)}


@pytest.mark.parametrize("name", list(NP_DTYPES))
def test_port_writes_what_the_package_reads(tmp_path, name):
    arrays = {k: v for k, v in _np_tensors().items() if k.endswith(name) or k == "empty"}
    path = str(tmp_path / "port.safetensors")
    sio.save_file({k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}, path,
                  metadata={"kind": "test"})
    back = np_load_file(path)
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)
    with safe_open(path, framework="np") as f:
        assert f.metadata() == {"kind": "test"}
    # laid out as the package lays it out: the same bytes
    np_save_file(arrays, str(tmp_path / "pkg.safetensors"), metadata={"kind": "test"})
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "pkg.safetensors").read_bytes()


def test_package_writes_what_the_port_reads(tmp_path):
    arrays = _np_tensors(seed=2)
    path = str(tmp_path / "pkg.safetensors")
    np_save_file(arrays, path, metadata={"a": "1", "b": "two"})
    f = sio.SafetensorsFile(path)
    assert f.metadata() == {"a": "1", "b": "two"}
    back = sio.load_file(path)
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        t = back[k]
        assert t.shape == tuple(v.shape) and t.dtype == torch.from_numpy(np.array(v)).dtype
        np.testing.assert_array_equal(t.numpy(), v)


def test_bf16_both_ways_through_safetensors_torch(tmp_path):
    tensors = _bf16_tensors()
    sio.save_file(tensors, str(tmp_path / "port.safetensors"))
    pt_save_file(tensors, str(tmp_path / "pkg.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "pkg.safetensors").read_bytes()
    for a, b in ((pt_load_file(str(tmp_path / "port.safetensors")), tensors),
                 (sio.load_file(str(tmp_path / "pkg.safetensors")), tensors)):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
    # read straight into bf16, into a tensor of its own (writes leave the file)
    t = sio.load_file(str(tmp_path / "pkg.safetensors"))["a.bf16"]
    assert t.dtype == torch.bfloat16
    t.add_(1)
    assert torch.equal(sio.load_file(str(tmp_path / "pkg.safetensors"))["a.bf16"],
                       tensors["a.bf16"])


@pytest.mark.parametrize("writer", ["port", "package"])
def test_sharded_directories(tmp_path, writer):
    """A sharded directory (shards + index) and an unsharded one, written by
    either side, read by both with the same tensors."""
    tensors = {f"layer.{i}.w": torch.full((4, 8), float(i)) for i in range(5)}
    tensors.update(_bf16_tensors())
    sharded, single = tmp_path / "sharded", tmp_path / "single"
    save = sio.save_file if writer == "port" else pt_save_file
    keys = sorted(tensors)
    groups = [keys[:3], keys[3:6], keys[6:]]
    os.makedirs(sharded)
    weight_map = {}
    for i, g in enumerate(groups):
        fn = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        save({k: tensors[k] for k in g}, str(sharded / fn))
        weight_map.update({k: fn for k in g})
    (sharded / sio.INDEX_FILE).write_text(json.dumps({"weight_map": weight_map}))
    os.makedirs(single)
    save(tensors, str(single / "model.safetensors"))
    assert len(sio.safetensors_files(str(sharded))) == 3
    assert sio.safetensors_files(str(single)) == ["model.safetensors"]
    index = json.loads((sharded / sio.INDEX_FILE).read_text())
    assert sorted(index["weight_map"]) == sorted(tensors)
    for d in (sharded, single):
        lazy = sio.lazy_safetensors_dir(str(d))
        assert len(lazy) == len(tensors) and sorted(lazy) == sorted(tensors)
        eager = sio.load_safetensors_dir(str(d))
        for k, v in tensors.items():
            assert lazy[k].dtype == v.dtype and torch.equal(lazy[k], v)
            assert torch.equal(eager[k], v)
        pkg = {}
        for fn in sio.safetensors_files(str(d)):
            pkg.update(pt_load_file(str(d / fn)))
        assert sorted(pkg) == sorted(tensors)
        for k, v in tensors.items():
            assert pkg[k].dtype == v.dtype and torch.equal(pkg[k], v)


def test_malformed_files_raise(tmp_path):
    path = tmp_path / "bad.safetensors"
    pt_save_file({"w": torch.ones(4)}, str(path))
    raw = bytearray(path.read_bytes())
    path.write_bytes(bytes(raw[:-4]))  # the data cut short
    with pytest.raises(ValueError, match="do not fit"):
        sio.SafetensorsFile(str(path))
    path.write_bytes(b"\x01")
    with pytest.raises(ValueError, match="not a safetensors file"):
        sio.SafetensorsFile(str(path))
    with pytest.raises(ValueError, match="no dtype"):
        sio.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, str(tmp_path / "c"))
    assert not list(tmp_path.glob(".tmp-*"))  # a failed write leaves no file behind
