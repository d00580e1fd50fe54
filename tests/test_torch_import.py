"""The port never loads jax, optax, the JAX package (spatialvla_tpu) or the
``safetensors`` package, and its image step needs no PIL: without it, frames
of any size are resized.

A fresh interpreter (this test process has jax loaded) imports every module
of spatialvla_tpu_torch with PIL, safetensors and transformers blocked (the
card's machine has none of them), runs a tiny predict with the int8 tree and
one with the mixed tree on an int8 KV cache, exports an HF checkpoint, bakes
it into a serving checkpoint with scripts/quantize_checkpoint_torch.py,
serves a request from that, imports the pretrain and fine-tuning CLIs and the
three eval CLIs (the SimplerEnv and LIBERO ones run to their missing-sim
exit), runs the pretrain CLI for a step over the committed RLDS fixture
(tests/fixtures_rlds: its JPEGs decoded by the native reader), imports the
training and data front ends (bench_train_torch, bench_data_torch,
fit_gaussian_torch, convert_checkpoint_torch, export_hf_torch,
make_rlds_fixture_torch, trace_data_cli_torch) and utils.profiling,
serves a request from the int8 tree sharded over two model shards
(SpatialVLAPolicy.shard), runs a LoRA step, a ring step and a pipeline step held by one process
(the parallel package) and one eval episode through the eval driver, and
reports which jax, optax, safetensors and spatialvla_tpu modules are loaded.
No ``import`` or ``from`` in the port, chip_smoke.py, or the port's scripts
(quantize_checkpoint_torch, serve_torch, bench_serve_torch,
run_simpler_eval_torch, run_libero_eval_torch, eval_quant_torch and the
seven front ends above), the entry points (graft_entry_torch.py) or the front
profiler (profile_front_torch), which the child also loads, names the JAX
package or safetensors."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, pkgutil, importlib, sys
for blocked in ("PIL", "safetensors", "transformers"):  # none of them on the card's machine
    sys.modules[blocked] = None
import numpy as np
import spatialvla_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(spatialvla_tpu_torch.__path__, "spatialvla_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
torch.set_num_threads(2)
import dataclasses
from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_tiny
from spatialvla_tpu_torch.train import pretrain
cfg = spatialvla_tiny(use_vision_zoe=True)
policy = SpatialVLAPolicy.init_random(cfg, "cpu", seed=0).quantize(bits=8)
size = cfg.vision.image_size
frame = (np.random.RandomState(0).rand(size, size, 3) * 255).astype(np.uint8)
out = policy.predict(frame, "pick up the cup")
# tensor-parallel serving: the int8 tree over two model shards of this process
out_tp = SpatialVLAPolicy.init_random(cfg, "cpu", seed=0).quantize(bits=8).shard(
    n_model=2).predict(frame, "pick up the cup")
# an HF checkpoint, baked by the script into a serving checkpoint, served
import importlib.util, os, tempfile
from spatialvla_tpu_torch.convert import export_hf_checkpoint
work = tempfile.mkdtemp()
export_hf_checkpoint(SpatialVLAPolicy.init_random(cfg, "cpu", seed=1).params, cfg,
                     os.path.join(work, "hf"), processor=policy.processor)
spec = importlib.util.spec_from_file_location("qc", os.path.join("scripts", "quantize_checkpoint_torch.py"))
script = importlib.util.module_from_spec(spec)
spec.loader.exec_module(script)
script.main(["--ckpt", os.path.join(work, "hf"), "--hf", "--out", os.path.join(work, "serving"),
             "--device", "cpu"])
served = SpatialVLAPolicy.load_serving(os.path.join(work, "serving"), device="cpu")
out_served = served.predict(frame, "pick up the cup")
# the fine-tuning CLI, a LoRA step, and the eval driver and CLIs
from spatialvla_tpu_torch.train import finetune, lora, train_step as ts, optimizer as opt
tx = opt.make_optimizer(opt.OptimizerConfig(), None, None)
from spatialvla_tpu_torch.models import spatialvla as sv
base = sv.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
lstate = ts.init_lora_train_state(torch.Generator().manual_seed(1), base, tx,
                                  target_patterns=lora.TARGET_PRESETS["linear"], rank=4)
N, begin = cfg.num_image_tokens, cfg.action_token_begin_idx
ids = np.concatenate([np.full((1, N), cfg.image_token_index), [[5, 6, begin, begin + 1]]], 1)
tt = np.zeros(ids.shape, np.int32)
tt[:, -2:] = 1
batch = {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32), "token_type_ids": tt,
         "labels": np.where(tt == 0, -100, ids),
         "pixel_values": np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32),
         "intrinsic": np.eye(3, dtype=np.float32)[None]}
lstate, lmetrics = ts.make_lora_train_step(cfg, tx, ts.TrainStepConfig(compute_dtype=torch.float32),
                                           rank=4)(lstate, base, batch)
# the parallel package: a ring step and a pipeline step held by this process
from spatialvla_tpu_torch.parallel import LocalMesh
par_losses = []
for backend, mesh in (("ring", LocalMesh(sp=2)), ("pipeline", LocalMesh(pipe=2))):
    pstate = ts.init_train_state(sv.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                                device="cpu"), tx)
    pstep = ts.make_train_step(cfg, tx, ts.TrainStepConfig(compute_dtype=torch.float32,
                                                           attn_backend=backend), mesh=mesh)
    par_losses.append(float(pstep(pstate, batch)[1]["loss"]))
from spatialvla_tpu_torch.eval.driver import EvalTask, evaluate_task
class Env:
    def reset(self):
        return {"image": frame}, {}
    def get_language_instruction(self):
        return "pick up the cup"
    def step(self, action):
        return {"image": frame}, 1.0, True, False, {"success": True}
row = evaluate_task(EvalTask("t", "e", "widowx", "widowx_bridge", "random_init", episodes=1,
                             max_steps=2), policy, env_factory=lambda t: Env(),
                    image_getter=lambda env, obs: obs["image"])
rcs = []
for script, sim in (("run_simpler_eval_torch", "simpler_env"), ("run_libero_eval_torch", "libero"),
                    ("eval_quant_torch", None)):
    spec = importlib.util.spec_from_file_location(script, os.path.join("scripts", script + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if sim is not None:
        sys.modules[sim] = None
        rcs.append(mod.main(["--checkpoint_dir", work]))
# the int8 KV cache needs the fused path, which the CPU takes only when asked,
# and a window that holds the whole cache
import functools
from spatialvla_tpu_torch.models import spatialvla as sv
sv.predict_action = functools.partial(sv.predict_action, use_fused_decode=True)
wide = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=512))
kv8 = SpatialVLAPolicy.init_random(wide, "cpu", seed=0).quantize(bits=8, mlp_bits=4, kv_bits=8)
out_kv8 = kv8.predict(frame, "pick up the cup")
resized = policy.processor(frame[:-1], "a frame that needs resizing")
# the pretrain CLI over the committed RLDS fixture: the native reader decodes
# its JPEGs (PIL is blocked here); the new front ends import without jax
from spatialvla_tpu_torch.data import native, statistics as data_stats
from spatialvla_tpu_torch.utils import profiling
data_stats._CACHE_DIR = os.path.join(work, "stats")
cli = pretrain.main(["--data_root_dir", os.path.join("tests", "fixtures_rlds"), "--mixture",
                     "bridge", "--model_preset", "spatialvla_tiny", "--image_size", "56",
                     "--seq_len", "80", "--max_steps", "1", "--save_steps", "1",
                     "--per_device_batch_size", "2", "--shuffle_buffer_size", "4",
                     "--logging_steps", "1", "--device", "cpu",
                     "--output_dir", os.path.join(work, "pretrain")])
front_ends = []
for name in ("bench_train_torch", "bench_data_torch", "fit_gaussian_torch",
             "convert_checkpoint_torch", "export_hf_torch", "make_rlds_fixture_torch",
             "trace_data_cli_torch"):
    spec = importlib.util.spec_from_file_location(name, os.path.join("scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    front_ends.append(callable(mod.main))
# the entry points and the front profiler
import graft_entry_torch
spec = importlib.util.spec_from_file_location("profile_front_torch",
                                              os.path.join("scripts", "profile_front_torch.py"))
profile_front = importlib.util.module_from_spec(spec)
spec.loader.exec_module(profile_front)
entry_surfaces = [callable(graft_entry_torch.entry), callable(graft_entry_torch.dryrun_multichip),
                   callable(profile_front.main)]
print(json.dumps({
    "modules": mods,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "optax": sorted(m for m in sys.modules if m == "optax" or m.startswith("optax.")),
    "spatialvla_tpu": sorted(m for m in sys.modules
                             if m == "spatialvla_tpu" or m.startswith("spatialvla_tpu.")),
    "safetensors": sorted(m for m in sys.modules
                          if (m == "safetensors" or m.startswith("safetensors."))
                          and sys.modules[m] is not None),
    "actions_shape": [list(np.asarray(o["actions"]).shape)
                      for o in (out, out_kv8, out_served, out_tp)],
    "finite": bool(all(np.isfinite(o["actions"]).all()
                       for o in (out, out_kv8, out_served, out_tp))),
    "ids": [np.asarray(o["action_ids"]).tolist() for o in (out, out_kv8, out_served, out_tp)],
    "served_quant": served.quant_desc,
    "resized_shape": list(resized["pixel_values"].shape),
    "resized_finite": bool(np.isfinite(resized["pixel_values"]).all()),
    "resized_keys": sorted(resized),
    "image_size": size,
    "lora_loss_finite": bool(np.isfinite(float(lmetrics["loss"]))),
    "parallel_losses": par_losses,
    "eval_row": row,
    "missing_sim_rcs": rcs,
    "decode_path": native.decode_path(),
    "cli_step": cli["step"],
    "front_ends": front_ends,
    "entry_surfaces": entry_surfaces,
    "profiling": [profiling.timeit.__name__, profiling.sync.__name__, profiling.trace.__name__],
}))
"""


@pytest.fixture(scope="module")
def child():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(child):
    for m in ("ops.decode_step", "ops.flash_attention", "models.zoe", "train.train_step",
              "train.optimizer", "train.trainer", "train.pretrain", "train.tb_writer", "config",
              "action.tokenizer", "processor.processor", "data.pipeline", "data.native",
              "convert.safetensors_io", "convert.hf_checkpoint", "convert.export_hf",
              "train.checkpoints", "serve.gating", "serve.engine", "serve.split_engine",
              "train.lora", "train.finetune", "eval.adapters", "eval.driver", "utils.tree",
              "parallel", "parallel.mesh", "parallel.partitioning", "parallel.ring_attention",
              "parallel.pipeline", "utils.profiling"):
        assert f"spatialvla_tpu_torch.{m}" in child["modules"]
    assert child["jax"] == []
    assert child["optax"] == []
    assert child["spatialvla_tpu"] == []
    assert child["safetensors"] == []
    assert child["lora_loss_finite"] and child["missing_sim_rcs"] == [2, 2]
    assert len(child["parallel_losses"]) == 2 and np.isfinite(child["parallel_losses"]).all()
    assert child["eval_row"]["episodes"] == 1 and child["eval_row"]["success_rate"] == 1.0
    # the RLDS fixture through the pretrain CLI without PIL, by the native reader
    assert child["decode_path"] in ("libjpeg", "nvjpeg") and child["cli_step"] == 1
    assert child["front_ends"] == [True] * 7 and len(child["profiling"]) == 3
    # graft_entry_torch.py and scripts/profile_front_torch.py load without jax
    assert child["entry_surfaces"] == [True] * 3


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_import_names_the_jax_package():
    files = sorted(Path(ROOT, "spatialvla_tpu_torch").rglob("*.py")) + [
        Path(ROOT, "chip_smoke.py")] + [Path(ROOT, "scripts", f"{name}.py") for name in (
        "quantize_checkpoint_torch", "serve_torch", "bench_serve_torch", "run_simpler_eval_torch",
        "run_libero_eval_torch", "eval_quant_torch", "bench_train_torch", "bench_data_torch",
        "fit_gaussian_torch", "convert_checkpoint_torch", "export_hf_torch",
        "make_rlds_fixture_torch", "trace_data_cli_torch", "profile_front_torch")] + [
        Path(ROOT, "graft_entry_torch.py")]
    assert len(files) > 40
    assert {f.name for f in files if f.parent.name == "parallel"} == {
        "__init__.py", "mesh.py", "partitioning.py", "ring_attention.py", "pipeline.py"}
    banned = ("spatialvla_tpu", "jax", "jaxlib", "optax", "safetensors")
    bad = [(str(f.relative_to(ROOT)), name) for f in files for name in _imported_names(f)
           if name.split(".")[0] in banned]
    assert bad == []


def test_tiny_predict_without_pil(child):
    from spatialvla_tpu.config import spatialvla_tiny

    cfg = spatialvla_tiny(use_vision_zoe=True)
    assert child["actions_shape"] == [[4, 7]] * 4 and child["finite"]
    assert child["served_quant"] == {"bits": 8, "vision_bits": 8, "mlp_bits": None,
                                     "group_size": None}
    ids = np.asarray(child["ids"])
    begin = cfg.action_token_begin_idx
    assert ((ids >= begin) & (ids < begin + cfg.spatial_token_num)).all()
    # without PIL a frame of another size is resized (the bicubic path, off
    # the u8 grid, so without the exact-u8 transport form)
    size = child["image_size"]
    assert child["resized_shape"] == [1, size, size, 3] and child["resized_finite"]
    assert "pixel_values" in child["resized_keys"]
    assert "pixel_values_u8" not in child["resized_keys"]


@pytest.mark.parametrize("texts", [["pick up the cup"], ["a", "move the red block left"]])
def test_processor_matches_base_processor(texts):
    """With PIL present the port's processor gives the base processor's
    arrays exactly (ids, masks, token types, intrinsics, pixels)."""
    from spatialvla_tpu.processor import SpatialVLAProcessor as Base
    from spatialvla_tpu_torch.processor import SpatialVLAProcessor as Port

    rng = np.random.RandomState(0)
    images = [(rng.rand(40, 52, 3) * 255).astype(np.uint8) for _ in texts]
    kw = dict(image_token_id=1000, action_token_begin_idx=1024, image_seq_length=16,
              image_size=56)
    a = Port(**kw)(images, texts, suffix_actions=np.zeros((4, 7)))
    b = Base(**kw)(images, texts, suffix_actions=np.zeros((4, 7)))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
