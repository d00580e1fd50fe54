"""ctypes bindings for the native data loader (the package's own
csrc/rlds_reader.cc).

Auto-builds the shared library into the package's _build/ on first use if a
host C++ compiler is present; falls back to the pure-Python implementations
(tfrecord.py / example_proto.py / PIL decode) otherwise. All public helpers
keep the same interface either way so the pipeline is oblivious to which
path is active.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Iterator, List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "rlds_reader.cc")
_LIB_PATH = os.path.join(_PKG, "_build", "libspatialvla_data.so")
# the flags of the reader's build: -march=native because the library is
# built on the host that runs it (crc32c needs >= SSE4.2); -ffast-math
# vectorizes the photometric augment (outputs within 1 u8 LSB of strict math)
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-march=native",
             "-funroll-loops", "-ffast-math", "-shared")
_lib = None


_load_failed = False


def _build() -> None:
    """Compile the reader into _build/ (atomic rename, so concurrent
    processes never load a partial file)."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), *_CXXFLAGS, _SRC, "-ljpeg", "-o", tmp],
        check=True, capture_output=True, timeout=120,
    )
    os.replace(tmp, _LIB_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:  # don't re-spawn the compiler per frame on toolchain-less hosts
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            _build()
        except Exception:
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _load_failed = True
        return None
    lib.rlds_reader_open.restype = ctypes.c_void_p
    lib.rlds_reader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.rlds_reader_next.restype = ctypes.c_long
    lib.rlds_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.rlds_reader_close.argtypes = [ctypes.c_void_p]
    lib.rlds_parse.restype = ctypes.c_void_p
    lib.rlds_parse.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.rlds_feature_info.restype = ctypes.c_int
    lib.rlds_feature_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_long)]
    lib.rlds_feature_floats.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.rlds_feature_ints.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong)]
    lib.rlds_feature_bytes_len.restype = ctypes.c_long
    lib.rlds_feature_bytes_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rlds_feature_bytes.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.rlds_parsed_free.argtypes = [ctypes.c_void_p]
    lib.rlds_decode_jpeg_resize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    if hasattr(lib, "rlds_augment"):
        lib.rlds_augment.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
    # fused read+parse / batched-extraction entry points (guarded so a stale
    # prebuilt library still loads with the slow path)
    if hasattr(lib, "rlds_reader_next_parsed"):
        lib.rlds_reader_next_parsed.restype = ctypes.c_void_p
        lib.rlds_reader_next_parsed.argtypes = [ctypes.c_void_p]
        lib.rlds_reader_open_parsed.restype = ctypes.c_void_p
        lib.rlds_reader_open_parsed.argtypes = lib.rlds_reader_open.argtypes
        lib.rlds_keys.restype = ctypes.c_long
        lib.rlds_keys.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ]
        lib.rlds_feature_bytes_lens.restype = ctypes.c_long
        lib.rlds_feature_bytes_lens.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.rlds_feature_bytes_concat.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# record iteration
# ---------------------------------------------------------------------------

def iter_records(
    paths: List[str], *, n_threads: int = 2, queue_capacity: int = 64,
    verify_crc: bool = False,
) -> Iterator[bytes]:
    """Threaded prefetching iterator over TFRecord shards (native), or the
    pure-Python fallback."""
    lib = _load()
    if lib is None:
        from .tfrecord import read_records

        for p in paths:
            yield from read_records(p, verify_crc=verify_crc)
        return

    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.rlds_reader_open(arr, len(paths), n_threads, queue_capacity,
                                  int(verify_crc))
    try:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = lib.rlds_reader_next(handle, ctypes.byref(ptr))
            if n < 0:
                return
            yield ctypes.string_at(ptr, n)
    finally:
        lib.rlds_reader_close(handle)


# ---------------------------------------------------------------------------
# example parsing
# ---------------------------------------------------------------------------

def _native_keys(lib, pe) -> List[str]:
    """Feature-key list straight from the native parser (one crossing)."""
    cap = 4096
    while True:
        buf = (ctypes.c_uint8 * cap)()
        need = lib.rlds_keys(pe, buf, cap)
        if need <= cap:
            return bytes(buf[:need]).decode().split("\n")[:-1]
        cap = need


def _extract_all(lib, pe) -> Dict:
    if hasattr(lib, "rlds_keys"):
        keys = _native_keys(lib, pe)
    else:  # stale prebuilt library: python proto walk for the key list only
        raise RuntimeError(f"rebuild {_LIB_PATH} (delete it; the next load rebuilds it)")
    return {key: _extract(lib, pe, key) for key in keys}


def parse_example(payload: bytes) -> Dict:
    """Parse a serialized tf.Example into {key: list | np.ndarray}."""
    lib = _load()
    if lib is None or not hasattr(lib, "rlds_keys"):
        from .example_proto import parse_example as py_parse

        return py_parse(payload)

    # np.frombuffer is zero-copy (the C++ side copies into its own buffer)
    buf = np.frombuffer(payload, dtype=np.uint8)
    pe = lib.rlds_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(payload)
    )
    try:
        return _extract_all(lib, pe)
    finally:
        lib.rlds_parsed_free(pe)


def _extract(lib, pe, key: str):
    kb = key.encode()
    count = ctypes.c_long()
    t = lib.rlds_feature_info(pe, kb, ctypes.byref(count))
    n = count.value
    if t == 2:
        arr = np.empty(n, dtype=np.float32)
        lib.rlds_feature_floats(pe, kb, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return arr
    if t == 3:
        arr = np.empty(n, dtype=np.int64)
        lib.rlds_feature_ints(pe, kb, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
        return arr
    if t == 1:
        if hasattr(lib, "rlds_feature_bytes_lens"):
            # two crossings for the whole list (lens + concat payload); one
            # C->Python copy total, then a bytes() slice per value
            lens = np.empty(n, dtype=np.int64)
            total = lib.rlds_feature_bytes_lens(
                pe, kb, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
            )
            flat = bytearray(int(total))
            lib.rlds_feature_bytes_concat(
                pe, kb, (ctypes.c_uint8 * len(flat)).from_buffer(flat)
            )
            view = memoryview(flat)
            out, off = [], 0
            for ln in lens.tolist():
                out.append(bytes(view[off : off + ln]))
                off += ln
            return out
        vals = []
        for i in range(n):
            ln = lib.rlds_feature_bytes_len(pe, kb, i)
            b = (ctypes.c_uint8 * ln)()
            lib.rlds_feature_bytes(pe, kb, i, b)
            vals.append(bytes(b))
        return vals
    return None


def iter_parsed(
    paths: List[str], *, n_threads: int = 2, queue_capacity: int = 64,
    verify_crc: bool = False,
) -> Iterator[Dict]:
    """Fused native read+parse stream: one crossing pops-and-parses each
    TFRecord (the payload bytes never round-trip through Python), then
    batched feature extraction. Falls back to iter_records + parse_example
    when the native library (or the fused entry point) is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rlds_reader_next_parsed"):
        for payload in iter_records(
            paths, n_threads=n_threads, queue_capacity=queue_capacity,
            verify_crc=verify_crc,
        ):
            yield parse_example(payload)
        return

    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    opener = getattr(lib, "rlds_reader_open_parsed", lib.rlds_reader_open)
    handle = opener(arr, len(paths), n_threads, queue_capacity, int(verify_crc))
    try:
        while True:
            pe = lib.rlds_reader_next_parsed(handle)
            if not pe:
                return
            try:
                yield _extract_all(lib, pe)
            finally:
                lib.rlds_parsed_free(pe)
    finally:
        lib.rlds_reader_close(handle)


def parse_example_keys(payload: bytes, keys: List[str]) -> Dict:
    """Selective native extraction of the given keys (fast path: no Python
    proto walk)."""
    lib = _load()
    if lib is None:
        from .example_proto import parse_example as py_parse

        full = py_parse(payload)
        return {k: full.get(k) for k in keys}
    buf = np.frombuffer(payload, dtype=np.uint8)
    pe = lib.rlds_parse(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(payload)
    )
    try:
        return {k: _extract(lib, pe, k) for k in keys}
    finally:
        lib.rlds_parsed_free(pe)


# ---------------------------------------------------------------------------
# image decode
# ---------------------------------------------------------------------------

def decode_jpeg_resize(jpeg_bytes: bytes, out_h: int, out_w: int) -> np.ndarray:
    """JPEG -> (out_h, out_w, 3) uint8 RGB, native decode + box resize;
    PIL fallback."""
    lib = _load()
    if lib is not None:
        src = np.frombuffer(jpeg_bytes, dtype=np.uint8)  # zero-copy view
        out = np.empty((out_h, out_w, 3), dtype=np.uint8)
        rc = lib.rlds_decode_jpeg_resize(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(jpeg_bytes), out_h, out_w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc == 0:
            return out
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(jpeg_bytes)).convert("RGB")
    img = img.resize((out_w, out_h), Image.BILINEAR)
    return np.asarray(img)


def augment_native(
    img: np.ndarray, crop_yxhw, b_delta: float, c_factor: float,
    s_factor: float, h_delta: float,
) -> Optional[np.ndarray]:
    """Fused crop-resize + photometric augmentation in C++ (single pass);
    returns None when the native lib is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "rlds_augment"):
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    out = np.empty_like(img)
    rc = lib.rlds_augment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(crop_yxhw[0]), int(crop_yxhw[1]), int(crop_yxhw[2]), int(crop_yxhw[3]),
        float(b_delta), float(c_factor), float(s_factor), float(h_delta),
    )
    return out if rc == 0 else None
