#!/usr/bin/env python3
"""Input-pipeline throughput of the port's data layer: the native shard
reader, the trajectory and frame transforms, JPEG decode and augmentation,
in frames/s (the JAX package's counterpart is scripts/bench_data.py; the
BASELINE.md target is above 2k frames/s a host). Prints one JSON line with
the decode route in use (``data/native.decode_path()``). Imports nothing of
jax and, on its default data, needs no PIL.

    python scripts/bench_data_torch.py [--data_root_dir DIR] [--n_frames 2000] \\
        [--workers N] [--no_augment]

The default data is the committed fixture ``tests/fixtures_rlds``
(bridge_orig, 256 x 256 frames; scripts/make_rlds_fixture_torch.py), read
over and over. ``--workers N`` > 0 measures the process-sharded loader
(data/mploader.py) with N worker processes instead of the in-process
pipeline's threads.
"""
import argparse
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "fixtures_rlds")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_root_dir", default=FIXTURE)
    p.add_argument("--dataset", default="bridge_orig/1.0.0")
    p.add_argument("--n_frames", type=int, default=2000)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--threads", type=int, default=8,
                   help="decode / augment threads of the in-process pipeline")
    p.add_argument("--workers", type=int, default=0)
    args = p.parse_args(argv)

    from spatialvla_tpu_torch.data import (FrameTransformConfig, InterleavedRLDSDataset,
                                           TrajTransformConfig, native)

    frame_config = FrameTransformConfig(resize_size=(args.image_size, args.image_size),
                                        augment=not args.no_augment, num_workers=args.threads)
    traj_config = TrajTransformConfig(forward_window_size=3)
    ds = InterleavedRLDSDataset([(args.dataset, 1.0)], args.data_root_dir,
                                traj_config=traj_config, frame_config=frame_config,
                                shuffle_buffer_size=256)
    loader = None
    if args.workers > 0:
        from spatialvla_tpu_torch.data.mploader import ProcessShardedFrameLoader

        loader = ProcessShardedFrameLoader(dict(
            mixture=[(args.dataset, 1.0)], data_dir=args.data_root_dir, traj_config=traj_config,
            frame_config=frame_config, shuffle_buffer_size=256,
            statistics_override=ds.statistics), num_workers=args.workers)
        it = loader.frames()
    else:
        it = ds.frames()
    try:
        next(it)  # warm: the first decode builds the reader's state
        t0 = time.perf_counter()
        for _ in itertools.islice(it, args.n_frames):
            pass
        dt = time.perf_counter() - t0
    finally:
        if loader is not None:
            loader.close()
    result = {"metric": "frames/s", "frames_per_s": args.n_frames / dt, "seconds": dt,
              "n_frames": args.n_frames, "image_size": args.image_size,
              "augment": not args.no_augment,
              "pipeline": f"{args.workers} worker processes" if args.workers > 0
              else f"single process, {args.threads} threads",
              "decode_path": native.decode_path(), "host_cores": os.cpu_count(),
              "data_root_dir": args.data_root_dir}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
