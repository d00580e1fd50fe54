#!/usr/bin/env python
"""Fit the per-dimension Gaussian action statistics used by the adaptive
bin policy (the gs_*.json artifacts) with the port's data layer: a copy of
scripts/fit_gaussian.py that imports nothing of jax (reference:
scripts/gs_bridge.json etc. produced from mixture-wide normalized action
distributions, with the tokenizer-fit exclusion list of
data/oxe/mixtures.py OXE_EXCLUDE_MIXTURE).

Usage:
    python scripts/fit_gaussian_torch.py --data_root_dir /data/oxe \\
        --mixture oxe_spatial_vla_plus --output gs_custom.json
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root_dir", required=True)
    p.add_argument("--mixture", default="bridge")
    p.add_argument("--output", required=True)
    p.add_argument("--exclude", default="tokenizer_gaussian",
                   choices=["tokenizer_gaussian", "no_exclude"])
    p.add_argument("--max_transitions_per_dataset", type=int, default=2_000_000)
    args = p.parse_args(argv)

    from spatialvla_tpu_torch.data import resolve_mixture
    from spatialvla_tpu_torch.data.oxe_registry import EXCLUDE_MIXTURES
    from spatialvla_tpu_torch.data.pipeline import (RLDSDataSource, TrajTransformConfig,
                                                    apply_trajectory_transforms)
    from spatialvla_tpu_torch.data.statistics import fit_gaussian_params

    exclude = set(EXCLUDE_MIXTURES[args.exclude])
    spec = [(n, w) for n, w in resolve_mixture(args.mixture) if n not in exclude]

    actions = []
    rng = np.random.default_rng(0)
    for name, _ in spec:
        src = RLDSDataSource(name, args.data_root_dir)
        stats = src.statistics()
        n = 0
        cfg = TrajTransformConfig(goal_relabeling=None, skip_unlabeled=False)
        for traj in src.iter_canonical():
            traj = apply_trajectory_transforms(traj, stats, cfg, rng)
            if traj is None:
                continue
            actions.append(np.asarray(traj["action"][:, 0], np.float32))
            n += len(traj["action"])
            if n >= args.max_transitions_per_dataset:
                break
        print(f"{name}: {n} transitions")

    gs = fit_gaussian_params(np.concatenate(actions))
    with open(args.output, "w") as f:
        json.dump(gs, f, indent=2)
    print(f"wrote {args.output}")
    return gs


if __name__ == "__main__":
    main()
