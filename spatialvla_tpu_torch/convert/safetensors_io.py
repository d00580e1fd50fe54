"""The safetensors file format, read and written without the ``safetensors``
package (the card's machine does not have it).

A file is an 8-byte little-endian header length n, n bytes of JSON, then the
raw little-endian bytes of every tensor. The header maps each tensor's name
to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold ``"__metadata__"``, a dict of strings.
The writer lays a file out as the package does: ``__metadata__`` first, the
tensors ordered by dtype (widest first) then name, compact JSON padded with
spaces so the data starts at a multiple of 8 bytes. So the package reads
what it writes, and the other way round.

Reading: ``SafetensorsFile.get_tensor`` reads one tensor's bytes from the
file straight into a new CPU tensor of the stored dtype (bf16 into
``torch.bfloat16``, no float32 copy), so a process that reads tensor after
tensor and drops each one holds about one tensor in host memory. (A memory
map does not: on the card's machine the pages a map had touched stayed in
the process's resident set, even after ``madvise(MADV_DONTNEED)``, so
loading the 8 GB checkpoint that way raised the RSS by the whole file.)
``LazySafetensorsDict`` gives a read-only Mapping over a directory of such
files, unsharded or sharded with ``model.safetensors.index.json``. Writes go
to a temporary file that is renamed into place, ``WRITE_CHUNK_BYTES`` a
system call, so that a write on a background thread does not hold the
process's address space for a whole tensor's copy at a time.
"""
from __future__ import annotations

import json
import os
import struct
import tempfile
from collections.abc import Mapping
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# the most bytes one write() system call of save_file copies (0: a tensor a
# call). On the H100's machine a training step beside a background write of
# 18.7 GB took 2.8-4.6 s at a tensor a call, 0.69-1.40 s at 64 MiB and
# 0.49-0.75 s at 8 MiB, against 0.34-0.68 s alone, the write no longer.
WRITE_CHUNK_BYTES = 8 << 20

# dtype name -> torch dtype, in the package's order (narrowest first): a
# file's tensors are laid out by this rank, widest first
DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8, "I16": torch.int16,
    "F16": torch.float16, "BF16": torch.bfloat16, "I32": torch.int32, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64,
}
_RANK = {name: i for i, name in enumerate(DTYPES)}
_NAMES = {dt: name for name, dt in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
_MAX_HEADER = 100 << 20  # the package's own limit


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"safetensors has no dtype for {dtype}") from None


class SafetensorsFile:
    """One safetensors file: ``keys()``, ``metadata()``, ``get_tensor(name)``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            if n > _MAX_HEADER:
                raise ValueError(f"{path}: header of {n} bytes is larger than {_MAX_HEADER}")
            header = json.loads(f.read(n))
            size = os.fstat(f.fileno()).st_size
        self._metadata = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._entries: Dict[str, Tuple[torch.dtype, List[int], int, int]] = {}
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, which is not read here")
            dtype, shape = DTYPES[e["dtype"]], [int(d) for d in e["shape"]]
            begin, end = (int(o) for o in e["data_offsets"])
            numel = 1
            for d in shape:
                numel *= d
            if end - begin != numel * dtype.itemsize or self._start + end > size or begin < 0:
                raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not fit "
                                 f"{e['dtype']} {shape} in a file of {size} bytes")
            self._entries[name] = (dtype, shape, begin, end)

    def keys(self) -> List[str]:
        return list(self._entries)

    def metadata(self) -> Dict[str, str]:
        return dict(self._metadata)

    def get_tensor(self, name: str) -> torch.Tensor:
        """A new CPU tensor holding the stored bytes, read from the file."""
        dtype, shape, begin, end = self._entries[name]
        out = torch.empty(shape, dtype=dtype)
        if end > begin:
            view = memoryview(out.reshape(-1).view(torch.uint8).numpy())
            with open(self.path, "rb") as f:
                f.seek(self._start + begin)
                got = 0
                while got < end - begin:
                    n = f.readinto(view[got:])
                    if not n:
                        raise ValueError(f"{self.path}: {name} ends past the end of the file")
                    got += n
        return out


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, by name, as CPU tensors."""
    f = SafetensorsFile(path)
    return {k: f.get_tensor(k) for k in f.keys()}


def _header(tensors: Mapping, metadata: Optional[Dict[str, str]]):
    """(the padded header bytes, the names in file order)."""
    names = sorted(tensors, key=lambda k: (-_RANK[dtype_name(tensors[k].dtype)], k))
    header = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise ValueError("safetensors metadata must map strings to strings")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for k in names:
        t = tensors[k]
        size = t.numel() * t.element_size()
        header[k] = {"dtype": dtype_name(t.dtype), "shape": list(t.shape),
                     "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    return struct.pack("<Q", len(raw)) + raw, names


def save_file(tensors: Mapping, path: str, metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (name -> tensor on any device) to ``path``, one
    tensor at a time through host memory; returns the bytes written."""
    header, names = _header(tensors, metadata)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-", suffix=".safetensors")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(header)
            total = len(header)
            for k in names:
                t = tensors[k].detach()
                if t.numel():
                    data = memoryview(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
                    step = WRITE_CHUNK_BYTES or len(data)
                    for i in range(0, len(data), step):
                        f.write(data[i:i + step])
                    total += len(data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return total


def safetensors_files(directory: str) -> List[str]:
    """The tensor files of a checkpoint directory: the shards an index names,
    or every ``*.safetensors`` file."""
    index_path = os.path.join(directory, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        return sorted(set(index["weight_map"].values()))
    return [fn for fn in sorted(os.listdir(directory)) if fn.endswith(".safetensors")]


class LazySafetensorsDict(Mapping):
    """Read-only Mapping over a (possibly sharded) safetensors directory that
    reads each tensor from its file on ``__getitem__``: nothing is
    resident until asked for, and nothing is cached here. A converter that
    takes one tensor at a time, moves it to its device and drops it keeps
    host memory at about one tensor (``convert/params.py``)."""

    def __init__(self, directory: str):
        self._by_key: Dict[str, SafetensorsFile] = {}
        for fn in safetensors_files(directory):
            handle = SafetensorsFile(os.path.join(directory, fn))
            for key in handle.keys():
                self._by_key[key] = handle

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._by_key[key].get_tensor(key)

    def __iter__(self) -> Iterable[str]:
        return iter(self._by_key)

    def __len__(self) -> int:
        return len(self._by_key)


def load_safetensors_dir(directory: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory, by name, as CPU tensors."""
    lazy = LazySafetensorsDict(directory)
    return {k: lazy[k] for k in lazy}


def lazy_safetensors_dir(directory: str) -> LazySafetensorsDict:
    """Lazy per-tensor view of a checkpoint directory (``LazySafetensorsDict``)."""
    return LazySafetensorsDict(directory)
