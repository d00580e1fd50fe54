"""LIBERO closed-loop evaluation CLI for the PyTorch port (the jax-free twin
of scripts/run_libero_eval.py).

Runs the four LIBERO suites the reference reports (LIBERO-Spatial / Object /
Goal / Long + Average with binomial SEs — reference README.md:579-590)
against a checkpoint through the port's policy (``spatialvla_tpu_torch``)
and emits the README-shaped table + a JSON artifact. Requires the `libero`
package (LIBERO benchmark repo); the driver itself is sim-agnostic and is
exercised in tests with fake envs (tests/test_torch_eval.py).

Usage:
  python scripts/run_libero_eval_torch.py \\
      --checkpoint_dir /path/to/ckpt [--hf] \\
      [--suites libero_spatial libero_object] [--episodes_per_task 50] \\
      [--unnorm_key libero_spatial_no_noops/1.0.0] [--out results.json] \\
      [--parallel_envs 8] [--device cuda]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--hf", action="store_true",
                    help="checkpoint_dir is a reference-format HF directory (else the port's "
                         "own format, SpatialVLAPolicy.load)")
    ap.add_argument("--suites", nargs="+",
                    default=["libero_spatial", "libero_object", "libero_goal", "libero_10"])
    ap.add_argument("--episodes_per_task", type=int, default=None)
    ap.add_argument("--unnorm_key", default=None)
    ap.add_argument("--quantize_bits", type=int, default=8,
                    help="0 disables weight quantization")
    ap.add_argument("--parallel_envs", type=int, default=1,
                    help="N env instances per task whose policy queries batch through one "
                         "ServingEngine")
    ap.add_argument("--out", default="libero_eval_results.json")
    ap.add_argument("--device", default="cuda",
                    help="where the policy runs (cuda raises without a card; cpu)")
    args = ap.parse_args(argv)

    try:
        from libero.libero import benchmark as libero_benchmark
        from libero.libero import get_libero_path
        from libero.libero.envs import OffScreenRenderEnv
    except ImportError:
        print("libero is not installed: install the LIBERO benchmark repo "
              "to run the sims. The driver + adapter are tested sim-free in "
              "tests/test_torch_eval.py.")
        return 2

    from spatialvla_tpu_torch.eval.driver import (LIBERO_SUITES, evaluate_libero,
                                                  format_libero_table)
    from spatialvla_tpu_torch.inference import SpatialVLAPolicy

    load = SpatialVLAPolicy.from_hf_checkpoint if args.hf else SpatialVLAPolicy.load
    policy = load(args.checkpoint_dir, device=args.device)
    if args.quantize_bits:
        policy.quantize(bits=args.quantize_bits)

    def task_factory(suite):
        bench = libero_benchmark.get_benchmark_dict()[suite.benchmark]()
        bddl_dir = get_libero_path("bddl_files")
        for task_id in range(bench.n_tasks):
            task = bench.get_task(task_id)

            def make_env(task=task):  # zero-arg factory: the driver makes
                # one env per parallel worker (a fresh env serially too)
                return OffScreenRenderEnv(
                    bddl_file_name=os.path.join(bddl_dir, task.problem_folder, task.bddl_file),
                    camera_heights=256, camera_widths=256)

            yield task.language, make_env

    suites = [s for s in LIBERO_SUITES if s.benchmark in args.suites]
    results = evaluate_libero(policy, suites, task_factory=task_factory,
                              episodes_per_task=args.episodes_per_task,
                              unnorm_key=args.unnorm_key, parallel_envs=args.parallel_envs)
    print(format_libero_table(results))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"saved: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
