"""The port's checkpoints: one safetensors file a tree, and step-numbered
checkpoints of a train state with retention and resume.

The JAX package saves its trees with Orbax (spatialvla_tpu/train/
checkpoints.py: ``CheckpointManager`` :15, ``save_params`` :107,
``load_params`` :119), which needs jax; the port writes its own format
instead, read and written by ``convert/safetensors_io`` (no ``safetensors``
package needed):

    <directory>/params.safetensors   every tensor leaf under its path, keys
                                     joined with "/" ("lm/layers/attn/qkv/qt")
    <directory>/config.json          the SpatialVLAConfig, when given

Every dtype is kept as it is (int8 codes, uint8 int4 nibbles, f32 scales,
bf16 and f32 leaves), so a tree comes back bit for bit. The header's
``__metadata__`` holds the tree's nesting (dicts and lists) as JSON, so a
tree loads without a template. Format version 2 also stores int, float,
bool and None leaves in that nesting (an optimizer's step count, a train
state's step) and takes dict keys that contain "/" (the LoRA factor tree is
keyed by flat paths); version 1 files, which have neither, still load. A JAX
(Orbax) checkpoint directory is not read here: ``load_params`` says so.

``CheckpointManager`` keeps ``<directory>/<step>/params.safetensors`` per
saved step, each written into a temporary directory and renamed into place
(a crash mid-save leaves the last good step, as Orbax's do), with Orbax's
save interval and retention and the JAX manager's JSON sidecars. Writes run
in the background, as Orbax's do with ``enable_async_checkpointing``:
``save`` copies the state into host buffers (kept and reused from one save
to the next) and returns, and a writer thread writes the step, renames it
into place, writes the sidecars and applies retention. One write is in
flight at a time (a ``save`` first waits for the one before), a step in
flight counts as saved, ``wait`` joins the writer, and an error of the
writer is raised at the next ``save``, ``wait`` or ``close``.
``save_params`` (a one-shot export) writes synchronously. In a run of
several processes every process calls ``save`` and process 0 writes (the
JAX manager's sidecars, checkpoints.py:41, 50); a state cut over model and
fsdp (``shards``, ``parallel.TrainShards``) is joined whole first, so the
file is the one an unsharded run writes, and a restore cuts each process's
shards of it again: a checkpoint of a 4-rank run restores in one process.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..convert.params import target_device
from ..convert.safetensors_io import SafetensorsFile, save_file
from ..parallel.mesh import process_count, process_index

PARAMS_FILE = "params.safetensors"
FORMAT = "spatialvla_tpu_torch.tree"
FORMAT_VERSION = "2"
READ_VERSIONS = ("1", "2")
_SCALARS = (bool, int, float, type(None))


def _flatten(tree, path: tuple, leaves: Dict[str, torch.Tensor]):
    """The tree's nesting as JSON: a dict, a list, a tensor's name or a
    scalar leaf, filling ``leaves``."""
    where = "/".join(path) or "the root"
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or not k:
                raise ValueError(f"tree key {k!r} under {where!r}: keys must be non-empty strings")
        return {k: _flatten(v, path + (k,), leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, path + (str(i),), leaves) for i, v in enumerate(tree)]
    if isinstance(tree, _SCALARS):
        return tree
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"leaf {where!r} is a {type(tree).__name__}, not a tensor or a number")
    name = "/".join(path)
    if name in leaves:  # keys with "/" can spell another leaf's path
        raise ValueError(f"two tensor leaves have the path {name!r}")
    leaves[name] = tree
    return name


def save_params(directory: str, params, *, config_json: Optional[str] = None) -> int:
    """Write ``params`` (a nested dict / list of tensors on any device, and
    of int, float, bool or None leaves) and, when given, ``config.json``;
    returns the bytes of the tensor file."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    leaves: Dict[str, torch.Tensor] = {}
    spec = _flatten(params, (), leaves)
    metadata = {"format": FORMAT, "format_version": FORMAT_VERSION, "tree": json.dumps(spec)}
    nbytes = save_file(leaves, os.path.join(directory, PARAMS_FILE), metadata)
    if config_json is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(config_json)
    return nbytes


def _open(directory: str):
    """(the tensor file, the tree's nesting) of a checkpoint directory."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, PARAMS_FILE)
    if not os.path.exists(path):
        if os.path.isdir(os.path.join(directory, "params")):
            raise ValueError(
                f"{directory} holds an Orbax checkpoint ('params/'), which the JAX package "
                "writes; the port reads its own format (params.safetensors). Export it from "
                "the JAX package as an HF checkpoint (convert.export_hf_checkpoint) and load "
                "that with SpatialVLAPolicy.from_hf_checkpoint")
        raise FileNotFoundError(f"{path} not found: not a checkpoint of the port")
    f = SafetensorsFile(path)
    meta = f.metadata()
    if meta.get("format") != FORMAT or meta.get("format_version") not in READ_VERSIONS:
        raise ValueError(f"{path}: format {meta.get('format')!r} version "
                         f"{meta.get('format_version')!r}, not {FORMAT!r} "
                         f"{' or '.join(READ_VERSIONS)}")
    return f, json.loads(meta["tree"])


def load_params(directory: str, *, device="cuda", float_dtype=None) -> Dict[str, Any]:
    """The tree ``save_params`` wrote, each tensor moved to ``device`` once as
    it is read. ``float_dtype`` casts the floating leaves outside quantized
    ``{"qt", "scale"}`` leaves (None keeps every stored dtype)."""
    f, spec = _open(directory)
    dev = target_device(device)

    def cast(tree, quantized=False):
        if isinstance(tree, dict):
            q = quantized or ("qt" in tree and "scale" in tree)
            return {k: cast(v, q) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, quantized) for v in tree]
        if not isinstance(tree, str):
            return tree  # a scalar leaf
        t = f.get_tensor(tree).to(dev)
        if float_dtype is not None and t.is_floating_point() and not quantized:
            t = t.to(float_dtype)
        return t.contiguous()

    return cast(spec)


def restore_params(directory: str, like, *, cut=None):
    """The tree ``save_params`` wrote, read into the tensors of ``like`` IN
    PLACE (on their devices, in their dtypes; ``requires_grad`` and every
    other reference to them stay valid). Scalar leaves come from the file.
    Returns a tree of ``like``'s structure: its tensors and the stored
    scalars. The nesting, and each tensor's shape, must be ``like``'s, after
    ``cut(path, tensor)`` (a rank's shard of a whole stored tensor) when
    given."""
    f, spec = _open(directory)

    def fill(like, spec, where):
        if isinstance(like, dict):
            if not isinstance(spec, dict) or set(spec) != set(like):
                raise ValueError(f"{directory}: the keys under {where or 'the root'!r} differ "
                                 "from the state's")
            return {k: fill(v, spec[k], f"{where}/{k}" if where else k) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            if not isinstance(spec, list) or len(spec) != len(like):
                raise ValueError(f"{directory}: the list at {where!r} differs from the state's")
            return type(like)(fill(v, s, f"{where}/{i}") for i, (v, s) in enumerate(zip(like, spec)))
        if isinstance(like, torch.Tensor):
            if not isinstance(spec, str):
                raise ValueError(f"{directory}: {where!r} is not a tensor in the checkpoint")
            src = f.get_tensor(spec)
            if cut is not None:
                src = cut(where, src)
            if src.shape != like.shape:
                raise ValueError(f"{directory}: {where!r} has shape {tuple(src.shape)}, the "
                                 f"state's {tuple(like.shape)}")
            with torch.no_grad():
                like.copy_(src)
            return like
        if isinstance(spec, (str, dict, list)):
            raise ValueError(f"{directory}: {where!r} is a scalar in the state, not in the "
                             "checkpoint")
        return spec

    return fill(like, spec, "")


def _barrier():
    if process_count() > 1:
        torch.distributed.barrier()


class CheckpointManager:
    """Step-numbered checkpoints of a whole train state plus sidecar JSON
    artifacts (model config, processor state): the interface of the JAX
    package's Orbax manager (train/checkpoints.py:15), written in the
    background.

    A step is saved when it is forced, or when no step is kept yet, or when
    it is past the latest and a multiple of ``save_interval_steps`` (Orbax's
    decision); after each save only the ``max_to_keep`` newest steps stay
    (None keeps all). ``all_steps`` counts a step in flight and the
    retention its write will apply. ``writes`` records each save: the
    seconds ``save`` blocked the caller (``blocked_s``: the gather and the
    copy to host memory), then, once written, the seconds of the write
    (``write_s``) and its bytes."""

    _TMP = ".tmp-"
    # the writer threads of this process by directory, so that another
    # manager of the same directory waits for them before it cleans up
    _writers: Dict[str, threading.Thread] = {}
    _writers_lock = threading.Lock()

    def __init__(self, directory: str, *, save_interval_steps: int = 1,
                 max_to_keep: Optional[int] = 3, shards=None):
        self.directory = os.path.abspath(directory)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.shards = shards
        self.writes: List[Dict[str, Any]] = []
        self._pending: Optional[int] = None  # the step in flight (every process)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: Dict[tuple, torch.Tensor] = {}  # the host buffers, by leaf path
        with self._writers_lock:
            other = self._writers.get(self.directory)
        if other is not None:
            other.join()
        if process_index() == 0:
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):  # steps an earlier run left half-written
                if self._TMP in name:
                    shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        _barrier()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _disk_steps(self) -> List[int]:
        """The steps on disk, oldest first (directories that hold a whole step)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, PARAMS_FILE)))

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first: those on disk and the one in
        flight, less those that its retention removes."""
        steps = self._disk_steps()
        if self._pending is None:
            return steps
        steps = sorted(set(steps) | {self._pending})
        return steps if self.max_to_keep is None else steps[-self.max_to_keep:]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return latest is None or (latest < step and step % self.save_interval_steps == 0)

    def save(self, step: int, state: Dict[str, Any], *, sidecar: Optional[Dict] = None,
             force: bool = False) -> bool:
        """Start writing ``state`` as ``step``; False when the step is already
        saved or in flight (e.g. the final save of a run that ended on an
        interval) or, without ``force``, not due. Returns once the state is
        copied to host memory: the caller may update its tensors in place."""
        if step in self.all_steps() or not (force or self.should_save(step)):
            return False
        t0 = time.perf_counter()
        self._join()  # one write in flight; raises the last write's error
        if self.shards is not None:  # every rank takes part in the gather
            state = self.shards.gather_state(state)
        self._pending = step
        writer = process_index() == 0
        snapshot = self._snapshot(state, ()) if writer else None
        record = {"step": step, "blocked_s": time.perf_counter() - t0}
        self.writes.append(record)
        if writer:
            self._thread = threading.Thread(target=self._write, name=f"checkpoint-{step}",
                                            args=(step, snapshot, sidecar, record))
            with self._writers_lock:
                self._writers[self.directory] = self._thread
            self._thread.start()
        return True

    def _snapshot(self, tree, path: tuple):
        """``tree`` with each tensor copied into this manager's host buffer
        for its path (made on the first save, reused after)."""
        if isinstance(tree, dict):
            return {k: self._snapshot(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._snapshot(v, path + (i,)) for i, v in enumerate(tree)]
        if not isinstance(tree, torch.Tensor):
            return tree
        buf = self._host.get(path)
        if buf is None or buf.shape != tree.shape or buf.dtype != tree.dtype:
            buf = self._host[path] = torch.empty(tree.shape, dtype=tree.dtype, device="cpu")
        with torch.no_grad():
            buf.copy_(tree.detach())  # from the card: returns once the copy is done
        return buf

    def _write(self, step: int, state, sidecar, record):
        """The writer thread: the step into a temporary directory, renamed
        into place, the sidecars, retention. An error is kept for the next
        ``save`` / ``wait`` / ``close``."""
        try:
            t0 = time.perf_counter()
            tmp = tempfile.mkdtemp(dir=self.directory, prefix=f"{step}{self._TMP}")
            try:
                record["bytes"] = save_params(tmp, state)
                os.rename(tmp, self._step_dir(step))
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            if sidecar:
                # step-scoped sidecar so restore(step) pairs the state with THAT
                # step's artifacts (processor state can change mid-run); the
                # unscoped copy stays as the latest for consumers that just
                # want the newest
                for path in (self._sidecar_path(step),
                             os.path.join(self.directory, "artifacts.json")):
                    with open(path, "w") as f:
                        json.dump(sidecar, f, indent=2)
            self._apply_retention()
            self._prune_sidecars(keep_extra={step})
            record["write_s"] = time.perf_counter() - t0
        except Exception as e:  # raised again in the caller's thread
            self._error = e

    def writing(self) -> bool:
        """Whether this process's writer is writing a step now."""
        thread = self._thread
        return thread is not None and thread.is_alive()

    def _join(self):
        """Wait for the write in flight (this process's writer), then raise
        its error, if any."""
        if self._thread is not None:
            self._thread.join()
            with self._writers_lock:
                if self._writers.get(self.directory) is self._thread:
                    del self._writers[self.directory]
            self._thread = None
        self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _apply_retention(self):
        steps = self._disk_steps()
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        for step in steps[:-self.max_to_keep]:
            # renamed first, so a crash mid-delete leaves no partial step
            doomed = tempfile.mkdtemp(dir=self.directory, prefix=f"{step}{self._TMP}")
            os.replace(self._step_dir(step), os.path.join(doomed, "step"))
            shutil.rmtree(doomed, ignore_errors=True)

    def _prune_sidecars(self, keep_extra=()):
        """Delete artifacts-<step>.json for steps that retention already
        removed, so sidecars never accumulate or pair with a deleted
        checkpoint."""
        kept = set(self._disk_steps()) | set(keep_extra)
        for name in os.listdir(self.directory):
            if name.startswith("artifacts-") and name.endswith(".json"):
                try:
                    step = int(name[len("artifacts-"):-len(".json")])
                except ValueError:
                    continue
                if step not in kept:
                    try:
                        os.remove(os.path.join(self.directory, name))
                    except OSError:
                        pass

    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self.directory, f"artifacts-{step}.json")

    def load_sidecar(self, step: Optional[int] = None) -> Optional[Dict]:
        """The sidecar saved WITH the given (default latest) step, falling
        back to the directory-level latest copy (after the write in flight)."""
        self._join()
        step = step if step is not None else self.latest_step()
        for path in ([] if step is None else [self._sidecar_path(step)]) + [
                os.path.join(self.directory, "artifacts.json")]:
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        return None

    def restore(self, state_like: Dict[str, Any], step: Optional[int] = None):
        """The state saved at ``step`` (default the latest), read into the
        tensors of ``state_like`` in place (``restore_params``; with
        ``shards``, each rank's shards of the stored tensors), after the
        write in flight; None when no step is saved."""
        self._join()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        cut = None if self.shards is None else self.shards.cut_state_leaf
        return restore_params(self._step_dir(step), state_like, cut=cut)

    def wait(self):
        """Wait for the write in flight (raising its error), then for every
        process."""
        self._join()
        _barrier()

    def close(self):
        """``wait``, then let go of the host buffers (a state's size)."""
        self.wait()
        self._host.clear()
