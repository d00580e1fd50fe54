"""The RLDS/OXE input pipeline: shards -> episodes -> canonical trajs ->
chunked frames -> interleaved, shuffled, augmented, tokenized batches.

tf.data-free re-design of the reference pipeline (data/rlds.py:
make_dataset_from_rlds / apply_trajectory_transforms /
apply_frame_transforms / build_interleaved_dataset) on top of the native
shard reader: episode parsing happens in the C++ loader, transforms are
vectorized numpy on the host, and the output is fixed-shape numpy batches
ready for the device.

Per-rank sharding: each host takes every world_size-th *shard file*
(deterministic by seed), mirroring the reference's per-rank
shuffle_seed = 3407 * rank semantics (data/dataset.py:82).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import random as _random
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import native, tfds_schema
from .oxe_registry import (
    ActionEncoding,
    OXEDatasetConfig,
    get_config,
    resolve_mixture,
)
from .standardize import CHUNK_FILTERS, STANDARDIZE_FNS
from .statistics import compute_dataset_statistics, save_dataset_statistics
from .augment import DEFAULT_AUGMENT_KWARGS, augment_image
from .transforms import (
    add_pad_mask_dict,
    chunk_act_obs,
    delete_task_conditioning,
    normalize_action_and_proprio,
    subsample,
    uniform_goal_relabel,
)

Traj = Dict[str, Any]


@dataclasses.dataclass
class TrajTransformConfig:
    backward_window_size: int = 0
    backward_delta: int = 1
    forward_window_size: int = 3  # action chunking (chunk = fwd + 1)
    skip_unlabeled: bool = True
    goal_relabeling: Optional[str] = "uniform"
    max_action: Optional[float] = None
    max_proprio: Optional[float] = None
    subsample_length: Optional[int] = None  # random traj subsample (train)
    task_augment_keep_image_prob: Optional[float] = None  # image/lang dropout


@dataclasses.dataclass
class FrameTransformConfig:
    resize_size: Tuple[int, int] = (224, 224)
    augment: bool = True
    augment_kwargs: Dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_AUGMENT_KWARGS)
    )
    # decode/augment worker threads (the native C calls release the GIL, so
    # this scales with host cores like tf.data's num_parallel_calls)
    num_workers: int = 8
    prefetch: int = 32


# ---------------------------------------------------------------------------
# single-dataset episode source
# ---------------------------------------------------------------------------

class RLDSDataSource:
    """Reads one TFDS/RLDS dataset directory and yields canonical trajs."""

    def __init__(
        self,
        name: str,
        data_dir: str,
        *,
        config: Optional[OXEDatasetConfig] = None,
        split: str = "train",
        load_camera_views: Sequence[str] = ("primary",),
        load_depth: bool = False,
        seed: int = 0,
        shard_by_rank: Tuple[int, int] = (0, 1),  # (rank, world)
        n_read_threads: int = 2,
    ):
        self.load_depth = load_depth
        self.name = name
        self.dataset_dir = os.path.join(data_dir, name)
        self.config = config or get_config(name)
        self.split = split
        self.views = tuple(load_camera_views)
        self.seed = seed
        self.rank, self.world = shard_by_rank
        self.n_read_threads = n_read_threads
        self.schema = tfds_schema.load_schema(self.dataset_dir)
        shards = tfds_schema.list_shards(self.dataset_dir, split)
        if not shards:
            raise FileNotFoundError(f"no shards for {name} [{split}] in {self.dataset_dir}")
        self.all_shards = shards  # statistics always cover the FULL dataset
        if len(shards) >= self.world:
            self.shards = shards[self.rank :: self.world]
        else:
            # fewer shard files than hosts: file-striding would hand some
            # ranks one shard and (with a naive fallback) others the whole
            # dataset, skewing the mixture. Give EVERY rank all shards with
            # its own shuffle seed instead — the reference's seed-based
            # per-rank sharding semantics (data/dataset.py:82).
            if self.world > 1 and self.rank == 0:
                print(
                    f"WARNING: {name} has {len(shards)} shard file(s) for "
                    f"{self.world} hosts; every host streams the full "
                    "dataset with a per-rank shuffle seed"
                )
            self.shards = shards
        self.standardize_fn = STANDARDIZE_FNS.get(name)
        if self.standardize_fn is None:
            raise KeyError(f"no standardize fn registered for {name}")
        if self.config.action_encoding not in (ActionEncoding.EEF_POS, ActionEncoding.EEF_R6):
            raise ValueError(f"{name}: only EEF_POS/EEF_R6 actions supported")

    # -- restructure (data/rlds.py:130-191) -----------------------------
    def _restructure(self, raw: Traj) -> Optional[Traj]:
        traj = self.standardize_fn(raw)
        if "observation" not in traj or "action" not in traj:
            return None
        T = len(traj["action"])
        old_obs = traj["observation"]
        new_obs: Dict[str, Any] = {}
        for view in self.views:
            img_key = self.config.image_obs_keys.get(view)
            imgs = old_obs[img_key] if img_key else [b""] * T
            # encoded images become object arrays so time-indexing/chunking
            # (fancy gather) works uniformly with numeric tensors
            new_obs[f"image_{view}"] = _as_object_array(imgs)
            depth_key = self.config.depth_obs_keys.get(view)
            if self.load_depth and depth_key:
                new_obs[f"depth_{view}"] = _as_object_array(old_obs[depth_key])
        if any(k is not None for k in self.config.state_obs_keys):
            parts = []
            for key in self.config.state_obs_keys:
                if key is None:
                    parts.append(np.zeros((T, 1), dtype=np.float32))
                else:
                    v = np.asarray(old_obs[key], dtype=np.float32)
                    parts.append(v if v.ndim == 2 else v[:, None])
            new_obs["proprio"] = np.concatenate(parts, axis=1)
        new_obs["timestep"] = np.arange(T)

        task: Dict[str, Any] = {}
        lang = self.config.language_key
        if lang is not None and lang in traj:
            task["language_instruction"] = _as_str_array(traj[lang])

        out: Traj = {
            "observation": new_obs,
            "task": task,
            "action": np.asarray(traj["action"], dtype=np.float32),
            "dataset_name": self.name,
        }
        # gripper dim is absolute; translation/rotation are relative
        # (data/oxe/__init__.py:30-37)
        mask = np.zeros((T, out["action"].shape[-1]), dtype=bool)
        mask[:, -1] = True
        out["absolute_action_mask"] = mask
        return out

    def iter_raw_episodes(
        self, repeat: bool = False, *, all_shards: bool = False
    ) -> Iterator[Traj]:
        epoch = 0
        while True:
            order = list(self.all_shards if all_shards else self.shards)
            rng = _random.Random(self.seed + epoch)
            rng.shuffle(order)
            for feats in native.iter_parsed(order, n_threads=self.n_read_threads):
                ep = tfds_schema.decode_episode(feats, self.schema)
                # flatten to the dlimp trajectory view: steps/* at top level,
                # episode metadata under traj_metadata
                traj = dict(ep.get("steps", ep))
                if "episode_metadata" in ep:
                    traj["traj_metadata"] = ep["episode_metadata"]
                yield traj
            if not repeat:
                return
            epoch += 1

    def iter_canonical(
        self, repeat: bool = False, *, all_shards: bool = False
    ) -> Iterator[Traj]:
        for raw in self.iter_raw_episodes(repeat, all_shards=all_shards):
            traj = self._restructure(raw)
            if traj is not None:
                yield traj

    def statistics(self, *, force: bool = False, cache_dir: Optional[str] = None) -> Dict:
        """Normalization statistics over the FULL dataset (all shards), not
        this rank's subset — every host must normalize identically and the
        disk cache is rank-independent (reference: get_dataset_statistics
        runs on the unsharded dataset, data/utils/data_utils.py:244-341)."""
        return compute_dataset_statistics(
            self.iter_canonical(repeat=False, all_shards=True),
            dataset_name=self.name,
            state_obs_keys=self.config.state_obs_keys,
            transform_name=self.standardize_fn.__name__,
            cache_dir=cache_dir,
            force=force,
        )


def _as_object_array(v) -> np.ndarray:
    if isinstance(v, np.ndarray) and v.dtype != object and v.dtype.kind not in ("U", "S"):
        return v  # already a decoded numeric tensor
    arr = np.empty(len(v), dtype=object)
    for i, x in enumerate(v):
        arr[i] = x
    return arr


def _as_str_array(v) -> np.ndarray:
    if isinstance(v, list):
        return np.asarray([b.decode("utf-8") if isinstance(b, bytes) else b for b in v])
    return np.asarray(v)


# ---------------------------------------------------------------------------
# trajectory -> frames
# ---------------------------------------------------------------------------

def apply_trajectory_transforms(
    traj: Traj,
    stats: Dict,
    cfg: TrajTransformConfig,
    rng: np.random.Generator,
) -> Optional[Traj]:
    """Normalization + filtering + relabeling + chunking
    (data/rlds.py:246-348 semantics)."""
    lang = traj["task"].get("language_instruction")
    if cfg.skip_unlabeled and (lang is None or not np.any(lang != "")):
        return None
    if cfg.max_action is not None and np.abs(traj["action"]).max() > cfg.max_action:
        return None
    proprio = traj["observation"].get("proprio")
    if (
        cfg.max_proprio is not None
        and proprio is not None
        and np.abs(proprio).max() > cfg.max_proprio
    ):
        return None

    traj = normalize_action_and_proprio(traj, stats, "bounds_q99")
    traj = add_pad_mask_dict(traj)
    if cfg.goal_relabeling == "uniform":
        traj = uniform_goal_relabel(traj, rng)
    # task augmentation runs before chunking (it can move goal timesteps);
    # subsampling after (data/rlds.py:309-346)
    if cfg.task_augment_keep_image_prob is not None:
        traj = delete_task_conditioning(traj, cfg.task_augment_keep_image_prob, rng)
    traj = chunk_act_obs(
        traj,
        backward_window_size=cfg.backward_window_size,
        backward_delta=cfg.backward_delta,
        forward_window_size=cfg.forward_window_size,
    )
    if cfg.subsample_length is not None:
        traj = subsample(traj, cfg.subsample_length, rng)
    return traj


def traj_to_frames(traj: Traj, chunk_filter: Optional[Callable] = None) -> Iterator[Dict]:
    """Flatten a chunked trajectory to per-frame samples.

    Every loaded camera view (image_primary / image_secondary / image_wrist)
    and depth obs reaches the frame (reference obs handling:
    data/obs_transforms.py:47-113). A backward window of size 1 yields a
    single image per view; k > 1 yields the k-image observation window
    (oldest first) which the batcher stacks into the model's (B, k, H, W, 3)
    multi-obs path."""
    T = len(traj["action"])
    obs = traj["observation"]
    lang = traj["task"].get("language_instruction")
    vis_keys = [
        k for k in obs if k.startswith("image_") or k.startswith("depth_")
    ]
    for t in range(T):
        if chunk_filter is not None and not chunk_filter(traj["action"][t]):
            continue
        frame = {
            "action": traj["action"][t],  # (chunk, 7)
            "language_instruction": (lang[t] if lang is not None else ""),
            "dataset_name": traj["dataset_name"],
            "proprio": obs.get("proprio", [None] * T)[t],
            "pad_mask": obs["pad_mask"][t],
        }
        for k in vis_keys:
            window = obs[k][t]
            frame[k] = window[-1] if len(window) == 1 else list(window)
        yield frame


# ---------------------------------------------------------------------------
# interleaved multi-dataset stream
# ---------------------------------------------------------------------------

def compute_balanced_weights(
    sizes: List[int], weights: List[float], balance: bool = True
) -> np.ndarray:
    """balance_weights semantics (data/rlds.py:444-452): weights multiplied
    by dataset size, then normalized."""
    w = np.asarray(weights, dtype=np.float64)
    if balance:
        w = w * np.asarray(sizes, dtype=np.float64)
    return w / w.sum()


def expected_epoch_length(sizes: List[int], norm_weights: np.ndarray, raw_weights: List[float]) -> int:
    """Effective epoch length = max over weight-1.0 datasets of
    size / normalized-weight (data/rlds.py:454-462)."""
    lens = [
        s / w for s, w, rw in zip(sizes, norm_weights, raw_weights) if rw == 1.0
    ]
    if not lens:
        lens = [s / w for s, w in zip(sizes, norm_weights)]
    return int(max(lens))


class InterleavedRLDSDataset:
    """Weighted sample-level interleave of per-dataset frame streams with a
    shuffle buffer and frame transforms — the reference's
    build_interleaved_dataset (data/rlds.py:464-573), tf-free."""

    def __init__(
        self,
        mixture,
        data_dir: str,
        *,
        traj_config: TrajTransformConfig = TrajTransformConfig(),
        frame_config: FrameTransformConfig = FrameTransformConfig(),
        shuffle_buffer_size: int = 8192,
        balance_weights: bool = True,
        seed: int = 0,
        shard_by_rank: Tuple[int, int] = (0, 1),
        split: str = "train",
        statistics_override: Optional[Dict[str, Dict]] = None,
        load_camera_views: Sequence[str] = ("primary",),
        load_depth: bool = False,
    ):
        spec = resolve_mixture(mixture)
        # dedupe (reference get_oxe_dataset_kwargs_and_weights)
        seen = {}
        for name, w in spec:
            if name in seen:
                raise ValueError(f"duplicate dataset {name} in mixture")
            seen[name] = w
        self.names = list(seen.keys())
        self.raw_weights = [seen[n] for n in self.names]
        self.traj_config = traj_config
        self.frame_config = frame_config
        self.shuffle_buffer_size = shuffle_buffer_size
        self.seed = seed

        self.sources = [
            RLDSDataSource(
                n, data_dir, seed=seed + i, shard_by_rank=shard_by_rank,
                split=split, load_camera_views=load_camera_views,
                load_depth=load_depth,
            )
            for i, n in enumerate(self.names)
        ]
        self.statistics = {}
        for src in self.sources:
            if statistics_override and src.name in statistics_override:
                self.statistics[src.name] = statistics_override[src.name]
            else:
                self.statistics[src.name] = src.statistics()
        sizes = [self.statistics[n]["num_transitions"] for n in self.names]
        self.sample_weights = compute_balanced_weights(
            sizes, self.raw_weights, balance_weights
        )
        self.epoch_length = expected_epoch_length(
            sizes, self.sample_weights, self.raw_weights
        )
        self._print_mixture_summary(sizes)

    def _print_mixture_summary(self, sizes):
        """Mixture pretty-printer (reference: data_utils.py:193-207)."""
        width = max(len(n) for n in self.names)
        print("#" * (width + 40))
        print(f"# {'Dataset':<{width}} {'transitions':>12} {'weight':>8}  #")
        for n, s, w in zip(self.names, sizes, self.sample_weights):
            print(f"# {n:<{width}} {s:>12} {w:>8.4f}  #")
        print(f"# effective epoch length: {self.epoch_length:<{width + 10}} #")
        print("#" * (width + 40))

    def _frame_stream(self, idx: int) -> Iterator[Dict]:
        src = self.sources[idx]
        rng = np.random.default_rng(self.seed * 7919 + idx)
        chunk_filter = (
            CHUNK_FILTERS.get(src.config.chunk_filter) if src.config.chunk_filter else None
        )
        for traj in src.iter_canonical(repeat=True):
            traj = apply_trajectory_transforms(
                traj, self.statistics[src.name], self.traj_config, rng
            )
            if traj is None:
                continue
            yield from traj_to_frames(traj, chunk_filter)

    def frames(self) -> Iterator[Dict]:
        """Infinite interleaved + shuffled + decoded frame stream. Decode +
        augmentation run on a thread pool (native code releases the GIL)."""
        rng = np.random.default_rng(self.seed)
        streams = [self._frame_stream(i) for i in range(len(self.sources))]
        buffer: List[Dict] = []
        H, W = self.frame_config.resize_size

        def decode_one(img, seed: int, crops_out=None) -> np.ndarray:
            if isinstance(img, bytes):
                if len(img) == 0:
                    arr = np.zeros((H, W, 3), dtype=np.uint8)
                else:
                    arr = native.decode_jpeg_resize(img, H, W)
            else:
                arr = np.asarray(img)
                if arr.shape[:2] != (H, W):
                    from .augment import _resize_bilinear

                    arr = np.clip(_resize_bilinear(arr, H, W), 0, 255).astype(np.uint8)
            if self.frame_config.augment and arr.any():
                # one shared seed per frame: every view/window image gets the
                # same augmentation draw (reference obs_transforms.py:17-44)
                from .augment import sample_augment_params

                p = sample_augment_params(
                    arr.shape[:2], np.random.default_rng(seed),
                    self.frame_config.augment_kwargs,
                )
                if crops_out is not None:
                    cy, cx, ch, cw = p["crop"]
                    crops_out.append(
                        (cy / arr.shape[0], cx / arr.shape[1],
                         ch / arr.shape[0], cw / arr.shape[1])
                    )
                arr = augment_image(
                    arr, np.random.default_rng(seed),
                    self.frame_config.augment_kwargs, params=p,
                )
            return arr

        def decode_depth_one(d, crop_frac=None) -> np.ndarray:
            arr = np.asarray(d, dtype=np.float32)
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            if crop_frac is not None:
                # the SAME fractional crop region the view's RGB got, so
                # backprojected depth stays aligned with the patches
                fy, fx, fh, fw = crop_frac
                h, w = arr.shape[:2]
                y0, x0 = int(round(fy * h)), int(round(fx * w))
                hh = max(1, int(round(fh * h)))
                ww = max(1, int(round(fw * w)))
                arr = arr[y0 : min(y0 + hh, h), x0 : min(x0 + ww, w)]
            if arr.shape[:2] != (H, W):
                from .augment import _resize_bilinear

                arr = _resize_bilinear(arr[..., None], H, W)[..., 0]
            return arr

        def decode(frame: Dict, seed: int) -> Dict:
            frame = dict(frame)
            view_crop: Dict[str, tuple] = {}
            for key in list(frame):  # images first: record per-view crops
                v = frame[key]
                if key.startswith("image_"):
                    crops: List[tuple] = []
                    frame[key] = (
                        np.stack([decode_one(x, seed, crops) for x in v])
                        if isinstance(v, list)
                        else decode_one(v, seed, crops)
                    )
                    if crops:
                        view_crop[key[len("image_"):]] = crops[0]
            for key in list(frame):
                v = frame[key]
                if key.startswith("depth_"):
                    cf = view_crop.get(key[len("depth_"):])
                    frame[key] = (
                        np.stack([decode_depth_one(x, cf) for x in v])
                        if isinstance(v, list)
                        else decode_depth_one(v, cf)
                    )
            return frame

        BLOCK = 1024  # pre-drawn randomness (per-frame rng calls are ~30 us)

        def sampled() -> Iterator[Dict]:
            n, cap = len(streams), self.shuffle_buffer_size
            while True:
                idxs = rng.choice(n, size=BLOCK, p=self.sample_weights)
                swaps = rng.integers(0, max(cap, 1), size=BLOCK)
                for idx, swap in zip(idxs.tolist(), swaps.tolist()):
                    try:
                        frame = next(streams[idx])
                    except StopIteration:
                        continue
                    if cap <= 0:  # shuffling disabled
                        yield frame
                        continue
                    if len(buffer) < cap:
                        buffer.append(frame)
                        continue
                    out, buffer[swap] = buffer[swap], frame
                    yield out

        def seeds() -> Iterator[int]:
            while True:
                yield from rng.integers(0, 2**31, size=BLOCK).tolist()

        src = sampled()
        seed_it = seeds()
        n_workers = self.frame_config.num_workers
        if n_workers <= 0:
            for frame in src:
                yield decode(frame, next(seed_it))
            return

        import collections
        import itertools as _it
        from concurrent.futures import ThreadPoolExecutor

        def decode_many(frames: List[Dict], seed_list: List[int]) -> List[Dict]:
            return [decode(f, s) for f, s in zip(frames, seed_list)]

        # frames are submitted in small groups: one future per GROUP frames
        # divides the executor/future overhead without adding latency at the
        # decode rates involved (a group is a few ms of work)
        GROUP = 8
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            pending = collections.deque()
            depth = max(self.frame_config.prefetch // GROUP, n_workers, 2)
            while True:
                group = list(_it.islice(src, GROUP))
                if not group:
                    break
                pending.append(
                    pool.submit(
                        decode_many, group,
                        [next(seed_it) for _ in range(len(group))],
                    )
                )
                if len(pending) >= depth:
                    yield from pending.popleft().result()
            while pending:
                yield from pending.popleft().result()

    def __len__(self):
        return self.epoch_length
