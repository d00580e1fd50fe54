"""The port's closed-loop evaluation (spatialvla_tpu_torch/eval, copies of the
JAX package's driver and adapters) with the port's tiny policy and fake
SimplerEnv- and LIBERO-shaped sims, and its jax-free CLIs
(scripts/run_simpler_eval_torch.py, run_libero_eval_torch.py,
eval_quant_torch.py) with fake simulator modules and without them.

The fake envs' outcomes depend only on their thresholds (0: the first step
succeeds; inf: never), so the aggregates are exact: the port's equal the
JAX package's on the same checkpoint, and a run with parallel_envs (the
episodes' queries batched through the port's ServingEngine) equals the
serial one."""
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from spatialvla_tpu_torch.eval.driver import (LIBERO_SUITES, SUITES, EvalTask, LiberoSuite,
                                              evaluate, evaluate_libero, evaluate_task,
                                              format_libero_table, format_table, run_episode,
                                              save_results)
from tests.test_eval_driver import FakeEnv, FakeLiberoEnv, fake_image_getter
from tests.test_hf_checkpoint import _build_reference_style_checkpoint

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDOWX = {"widowx_spoon_on_towel": 0.0, "widowx_carrot_on_plate": np.inf,
          "widowx_stack_cube": 0.0, "widowx_put_eggplant_in_basket": np.inf}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    _build_reference_style_checkpoint(d)
    return str(d)


@pytest.fixture(scope="module")
def policy(ckpt):
    from spatialvla_tpu_torch.inference import SpatialVLAPolicy

    return SpatialVLAPolicy.from_hf_checkpoint(ckpt, device="cpu", param_dtype=None)


def widowx_tasks(episodes, max_steps=4):
    return [EvalTask(t.label, t.env_id, t.suite, t.policy_setup, t.unnorm_key,
                     episodes=episodes, max_steps=max_steps, partial_key=t.partial_key)
            for t in SUITES["widowx"]]


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_episode_with_the_port_policy(policy):
    from spatialvla_tpu_torch.eval import SimplerEnvPolicyAdapter

    adapter = SimplerEnvPolicyAdapter(policy, unnorm_key="bridge_orig/1.0.0",
                                      policy_setup="widowx_bridge")
    ep = run_episode(FakeEnv("widowx_spoon_on_towel", threshold=0.0), adapter, max_steps=4,
                     image_getter=fake_image_getter)
    assert ep["success"] is True and ep["steps"] == 1
    env = FakeEnv("widowx_carrot_on_plate", threshold=np.inf)
    ep = run_episode(env, adapter, max_steps=5, image_getter=fake_image_getter)
    assert ep["success"] is False and ep["steps"] == 5 and env.t == 5


def test_evaluate_matches_the_jax_driver_and_policy(policy, ckpt):
    """The same tasks, fake envs and checkpoint through the JAX package's
    driver and policy: the same rows, suite averages and table."""
    from spatialvla_tpu.eval.driver import evaluate as j_evaluate
    from spatialvla_tpu.inference import SpatialVLAPolicy as JaxPolicy

    tasks = widowx_tasks(episodes=2, max_steps=3)
    out = {}
    for name, fn, pol in (("port", evaluate, policy),
                          ("jax", j_evaluate, JaxPolicy.from_hf_checkpoint(ckpt,
                                                                           param_dtype=None))):
        out[name] = fn(pol, tasks, env_factory=lambda t: FakeEnv(t.env_id, WIDOWX[t.env_id]),
                       image_getter=fake_image_getter)
    assert out["port"] == out["jax"]
    assert out["port"]["suites"]["widowx"] == pytest.approx(0.5)
    assert format_table(out["port"]) == format_table(out["jax"])


def test_evaluate_parallel_envs_matches_serial(policy):
    """parallel_envs=2: each task's episodes run on 2 env instances whose
    queries coalesce through the port's ServingEngine; the aggregates equal
    the serial run's and every episode is handed out exactly once (mirrors
    tests/test_eval_driver.py's test of the JAX driver)."""
    tasks = widowx_tasks(episodes=5)
    made = []

    def factory(task):
        env = FakeEnv(task.env_id, WIDOWX[task.env_id], seed=len(made))
        made.append(env)
        return env

    serial = evaluate(policy, tasks, env_factory=factory, image_getter=fake_image_getter)
    n_serial = len(made)
    parallel = evaluate(policy, tasks, env_factory=factory, image_getter=fake_image_getter,
                        parallel_envs=2)
    assert n_serial == 4 and len(made) - n_serial == 8
    assert parallel == serial
    resets = {}
    for env in made[n_serial:]:
        resets[env.env_id] = resets.get(env.env_id, 0) + env.n_resets
    assert all(v == 5 for v in resets.values())


def test_evaluate_task_batches_through_the_engine(policy, monkeypatch):
    """With parallel_envs the driver builds the port's ServingEngine and
    shuts it down; its queries arrive there."""
    from spatialvla_tpu_torch import serve

    engines = []
    real = serve.ServingEngine

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(serve, "ServingEngine", Recording)
    task = widowx_tasks(episodes=4)[1]  # never succeeds: every step queries
    row = evaluate_task(task, policy, env_factory=lambda t: FakeEnv(t.env_id, np.inf),
                        image_getter=fake_image_getter, parallel_envs=4)
    assert row["episodes"] == 4 and row["success_rate"] == 0.0 and row["mean_steps"] == 4.0
    (engine,) = engines
    chunk = policy.processor.action_chunk_size  # one query a chunk of actions
    assert engine.stats()["requests"] == 4 * -(-4 // chunk) and engine._stop.is_set()


def test_libero_serial_and_parallel(policy):
    suites = [LiberoSuite("LIBERO-Spatial", "libero_spatial", max_steps=4),
              LiberoSuite("LIBERO-Object", "libero_object", max_steps=4)]
    thresholds = {"libero_spatial": 0.0, "libero_object": np.inf}

    def task_factory(suite):
        for i in range(2):
            yield f"task {i} of {suite.benchmark}", (
                lambda suite=suite: FakeLiberoEnv(thresholds[suite.benchmark]))

    kw = dict(task_factory=task_factory, episodes_per_task=3, unnorm_key="bridge_orig/1.0.0")
    serial = evaluate_libero(policy, suites, **kw)
    parallel = evaluate_libero(policy, suites, parallel_envs=3, **kw)
    assert parallel == serial
    spatial, obj = serial["rows"]
    assert spatial["episodes"] == 6 and spatial["success_rate"] == 1.0
    assert obj["success_rate"] == 0.0 and serial["average"]["success_rate"] == 0.5
    assert "100.0 ± 0.0%" in format_libero_table(serial)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def fake_simpler(monkeypatch):
    sim = types.ModuleType("simpler_env")
    sim.make = lambda env_id: FakeEnv(env_id, WIDOWX.get(env_id, 0.0))
    utils = types.ModuleType("simpler_env.utils")
    env_m = types.ModuleType("simpler_env.utils.env")
    obs_m = types.ModuleType("simpler_env.utils.env.observation_utils")
    obs_m.get_image_from_maniskill2_obs_dict = lambda env, obs: obs["image"]
    sim.utils, utils.env, env_m.observation_utils = utils, env_m, obs_m
    for name, m in {"simpler_env": sim, "simpler_env.utils": utils,
                    "simpler_env.utils.env": env_m,
                    "simpler_env.utils.env.observation_utils": obs_m}.items():
        monkeypatch.setitem(sys.modules, name, m)


@pytest.mark.parametrize("parallel_envs", [1, 2])
def test_simpler_cli_with_a_fake_sim(ckpt, tmp_path, monkeypatch, parallel_envs):
    fake_simpler(monkeypatch)
    out = tmp_path / "res.json"
    rc = load_script("run_simpler_eval_torch").main([
        "--checkpoint_dir", ckpt, "--hf", "--suites", "widowx", "--episodes", "2",
        "--parallel_envs", str(parallel_envs), "--out", str(out), "--device", "cpu"])
    assert rc == 0
    results = json.loads(out.read_text())
    assert results["suites"]["widowx"] == pytest.approx(0.5)
    assert {r["env_id"]: r["success_rate"] for r in results["rows"]} == \
        {k: float(v == 0.0) for k, v in WIDOWX.items()}


def test_libero_cli_with_a_fake_sim(ckpt, tmp_path, monkeypatch):
    class Bench:
        n_tasks = 2

        def get_task(self, i):
            return types.SimpleNamespace(language=f"task {i}", problem_folder="p",
                                         bddl_file=f"t{i}.bddl")

    made = []

    def render_env(bddl_file_name, camera_heights, camera_widths):
        made.append(bddl_file_name)
        return FakeLiberoEnv(0.0)

    libero = types.ModuleType("libero")
    pkg = types.ModuleType("libero.libero")
    bench = types.ModuleType("libero.libero.benchmark")
    envs = types.ModuleType("libero.libero.envs")
    bench.get_benchmark_dict = lambda: {s.benchmark: Bench for s in LIBERO_SUITES}
    pkg.get_libero_path = lambda key: f"/fake/{key}"
    pkg.benchmark, pkg.envs, libero.libero = bench, envs, pkg
    envs.OffScreenRenderEnv = render_env
    for name, m in {"libero": libero, "libero.libero": pkg, "libero.libero.benchmark": bench,
                    "libero.libero.envs": envs}.items():
        monkeypatch.setitem(sys.modules, name, m)
    out = tmp_path / "libero.json"
    rc = load_script("run_libero_eval_torch").main([
        "--checkpoint_dir", ckpt, "--hf", "--suites", "libero_spatial", "libero_goal",
        "--episodes_per_task", "1", "--unnorm_key", "bridge_orig/1.0.0", "--out", str(out),
        "--device", "cpu"])
    assert rc == 0
    results = json.loads(out.read_text())
    assert [r["label"] for r in results["rows"]] == ["LIBERO-Spatial", "LIBERO-Goal"]
    assert results["average"]["success_rate"] == 1.0
    assert made == ["/fake/bddl_files/p/t0.bddl", "/fake/bddl_files/p/t1.bddl"] * 2


@pytest.mark.parametrize("script, missing", [("run_simpler_eval_torch", "simpler_env"),
                                             ("run_libero_eval_torch", "libero")])
def test_clis_report_a_missing_sim(script, missing, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, missing, None)
    assert load_script(script).main(["--checkpoint_dir", str(tmp_path)]) == 2
    assert "is not installed" in capsys.readouterr().out


def test_eval_quant_cli_writes_a_gate(ckpt, tmp_path, capsys):
    from spatialvla_tpu_torch.serve.gating import check_gate, load_gate

    gate_path = tmp_path / "gate.json"
    load_script("eval_quant_torch").main([
        "--checkpoint_dir", ckpt, "--hf", "--n_synthetic", "2", "--bits", "8",
        "--depth_res", "32", "--gate_out", str(gate_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "baseline (bf16): 2 obs" in out and "int8: token agreement" in out
    assert "depth@32: token agreement" in out
    for line in out.splitlines():
        if "action L1" in line:
            assert float(line.split("action L1")[1].split()[0]) >= 0.0
    gate = load_gate(str(gate_path))
    assert [e["label"] for e in gate["entries"]] == ["int8", "depth@32"]
    assert check_gate(gate, gate["entries"][0]["knobs"])[0]


def test_save_results_round_trip(policy, tmp_path):
    results = evaluate(policy, widowx_tasks(episodes=1, max_steps=2),
                       env_factory=lambda t: FakeEnv(t.env_id, WIDOWX[t.env_id]),
                       image_getter=fake_image_getter)
    save_results(str(tmp_path / "r.json"), results)
    assert json.loads((tmp_path / "r.json").read_text())["suites"] == results["suites"]
