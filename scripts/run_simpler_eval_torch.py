"""SimplerEnv closed-loop evaluation CLI for the PyTorch port (the jax-free
twin of scripts/run_simpler_eval.py).

Runs the reference's reported suites (Google-robot Visual Matching /
Variant Aggregation, WidowX — README.md:206-495) against a checkpoint
through the port's policy (``spatialvla_tpu_torch``) and emits the
README-shaped SR table + a JSON artifact. Requires the `simpler_env` package
(the reference's SimplerEnv-OpenVLA fork); the driver itself is sim-agnostic
and is exercised in tests with a fake env (tests/test_torch_eval.py).

Usage:
  python scripts/run_simpler_eval_torch.py \\
      --checkpoint_dir /path/to/ckpt [--hf] \\
      --suites widowx google_vm [--episodes 24] [--parallel_envs 8] \\
      [--out results.json] [--device cuda]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--hf", action="store_true",
                    help="checkpoint_dir is a reference-format HF directory (else the port's "
                         "own format, SpatialVLAPolicy.load)")
    ap.add_argument("--suites", nargs="+", default=["google_vm", "widowx"],
                    help="any of google_vm, google_va, widowx. google_va runs the "
                         "Variant-Aggregation matrix (eval/driver.py GOOGLE_ROBOT_VA_TASKS)")
    ap.add_argument("--episodes", type=int, default=None,
                    help="override episodes per task (default: task setting)")
    ap.add_argument("--parallel_envs", type=int, default=1,
                    help="N env instances per task on N threads; their policy queries "
                         "coalesce into batched predicts through a shared ServingEngine")
    ap.add_argument("--quantize_bits", type=int, default=8,
                    help="0 disables weight quantization")
    ap.add_argument("--out", default="simpler_eval_results.json")
    ap.add_argument("--device", default="cuda",
                    help="where the policy runs (cuda raises without a card; cpu)")
    args = ap.parse_args(argv)

    try:
        import simpler_env  # noqa: F401
    except ImportError:
        print("simpler_env is not installed: install the SimplerEnv-OpenVLA "
              "fork (reference README.md:154-161) to run the sims. The "
              "driver + adapters are tested sim-free in tests/test_torch_eval.py.")
        return 2

    from spatialvla_tpu_torch.eval.driver import (SUITES, evaluate, format_table,
                                                  make_simpler_env, save_results)
    from spatialvla_tpu_torch.inference import SpatialVLAPolicy

    load = SpatialVLAPolicy.from_hf_checkpoint if args.hf else SpatialVLAPolicy.load
    policy = load(args.checkpoint_dir, device=args.device)
    if args.quantize_bits:
        policy.quantize(bits=args.quantize_bits)

    tasks = [t for s in args.suites for t in SUITES[s]]
    results = evaluate(policy, tasks, env_factory=make_simpler_env, episodes=args.episodes,
                       parallel_envs=args.parallel_envs)
    print(format_table(results))
    save_results(args.out, results)
    print(f"saved: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
