"""The port's training checkpoints (train/checkpoints.py: format version 2,
CheckpointManager), resume in train_loop, and the CLIs that use them
(pretrain's --init_checkpoint, step checkpoints and final export; the
fine-tuning CLI train/finetune.py), on the CPU at spatialvla_tiny.

* Round trips of a LoRA and a full train state (keys with "/", int and
  float leaves, bf16, fp32 and int8 tensors): bit for bit, into the live
  tensors in place.
* The manager's save decisions, retention and sidecar pruning against the
  JAX package's Orbax manager on the same calls.
* A half-written step is ignored; a version 1 file still loads.
* train_loop resume: the resumed run ends bit-identical to an uninterrupted
  one (the CPU's sums are deterministic).
* --adapt_emb: the re-gridded table equals the JAX processor's, exactly.
"""
import itertools
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from spatialvla_tpu.train.checkpoints import CheckpointManager as JaxManager
from spatialvla_tpu_torch.config import spatialvla_tiny
from spatialvla_tpu_torch.convert.safetensors_io import save_file
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.ops.quant import quantize_int8
from spatialvla_tpu_torch.train import checkpoints as tck
from spatialvla_tpu_torch.train import lora as tlora
from spatialvla_tpu_torch.train import optimizer as topt
from spatialvla_tpu_torch.train import train_step as tts
from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop
from spatialvla_tpu_torch.utils.tree import iter_leaves, map_with_paths

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=False)


def tiny_params(seed=0):
    return tsv.init_params(CFG, generator=torch.Generator().manual_seed(seed), device="cpu",
                           dtype=torch.float32)


def randomize(tree, seed):
    """Every tensor leaf refilled from a seed (moments, factors), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, t in iter_leaves(tree):
            if torch.is_tensor(t) and t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return tree


def full_state(seed):
    params = tiny_params(seed)
    tx = topt.make_optimizer(topt.OptimizerConfig(), params, topt.trainable_mask(params))
    state = tts.init_train_state(params, tx)
    randomize(state["opt_state"], seed + 1)
    state["opt_state"]["count"] = 7 + seed
    state["step"] = 7 + seed
    g = torch.Generator().manual_seed(seed + 2)
    state["extra"] = {"bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
                      "q8": quantize_int8(torch.randn(16, 8, generator=g)),
                      "flags": [True, None, 2.5 + seed], "lr": 1e-4 * (seed + 1)}
    return state


def lora_state(seed):
    base = tiny_params(0)
    tx = topt.make_optimizer(topt.OptimizerConfig(), None, None)
    state = tts.init_lora_train_state(torch.Generator().manual_seed(seed), base, tx,
                                      target_patterns=tlora.TARGET_PRESETS["linear+emb+h"],
                                      rank=4)
    randomize(state["trainable"], seed + 1)
    randomize(state["opt_state"], seed + 2)
    state["opt_state"]["count"] = state["step"] = 3 + seed
    return state


def assert_states_equal(a, b):
    la, lb = dict(iter_leaves(a)), dict(iter_leaves(b))
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        y = lb[path]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), path
        else:
            assert type(x) is type(y) and x == y, path


@pytest.mark.parametrize("make", [full_state, lora_state], ids=["full", "lora"])
def test_manager_round_trip_is_bit_exact_and_in_place(make, tmp_path):
    saved = make(1)
    if make is lora_state:  # factor keys are flat paths with "/"
        assert "lm/layers/attn/q" in saved["trainable"]["lora"]
        assert "lm/lm_head" in saved["trainable"]["lora"]
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=1, max_to_keep=2)
    assert mgr.save(saved["step"], saved, sidecar={"k": 1})
    fresh = make(2)  # another state of the same structure
    live = dict(iter_leaves(fresh))
    restored = tck.CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert_states_equal(restored, saved)
    for path, t in iter_leaves(restored):  # written into the live tensors
        if torch.is_tensor(t):
            assert t is live[path], path
    grads = [p for _, p in iter_leaves(restored) if torch.is_tensor(p) and p.requires_grad]
    assert grads and len(grads) == sum(
        1 for _, p in iter_leaves(saved) if torch.is_tensor(p) and p.requires_grad)
    # the template-free reader gives the same tree
    assert_states_equal(tck.load_params(mgr._step_dir(saved["step"]), device="cpu"), saved)


def test_save_params_rejects_what_it_cannot_read_back(tmp_path):
    t = torch.zeros(2)
    with pytest.raises(ValueError, match="two tensor leaves have the path 'a/b'"):
        tck.save_params(str(tmp_path / "x"), {"a/b": t, "a": {"b": t}})
    with pytest.raises(TypeError, match="not a tensor or a number"):
        tck.save_params(str(tmp_path / "y"), {"s": "text"})
    with pytest.raises(ValueError, match="non-empty strings"):
        tck.save_params(str(tmp_path / "z"), {1: t})


def test_version_1_files_still_load(tmp_path):
    """A file of the first format (no scalar leaves) loads as before."""
    tree = {"lm": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "q": [torch.ones(4, dtype=torch.int8)]}
    spec = {"lm": {"w": "lm/w"}, "q": ["q/0"]}
    save_file({"lm/w": tree["lm"]["w"], "q/0": tree["q"][0]},
              str(tmp_path / tck.PARAMS_FILE),
              {"format": tck.FORMAT, "format_version": "1", "tree": json.dumps(spec)})
    assert_states_equal(tck.load_params(str(tmp_path), device="cpu"), tree)
    v9 = tmp_path / "v9"
    v9.mkdir()
    save_file({"w": torch.zeros(1)}, str(v9 / tck.PARAMS_FILE),
              {"format": tck.FORMAT, "format_version": "9", "tree": '{"w": "w"}'})
    with pytest.raises(ValueError, match="version '9'"):
        tck.load_params(str(v9), device="cpu")


def test_restore_refuses_another_structure(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": torch.zeros(2, 3), "step": 1})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(3, 2), "step": 0})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore({"v": torch.zeros(2, 3), "step": 0})


def test_save_decisions_retention_and_sidecars_match_orbax(tmp_path):
    """The same save calls on the port's manager and the JAX package's
    (interval 2, keep 2): the same answers, kept steps and sidecars
    (mirrors tests/test_trainer_resume.py's retention test)."""
    port = tck.CheckpointManager(str(tmp_path / "port"), save_interval_steps=2, max_to_keep=2)
    ref = JaxManager(str(tmp_path / "jax"), save_interval_steps=2, max_to_keep=2)
    calls = [(1, False), (2, False), (3, False), (4, False), (5, True), (5, True), (7, False),
             (8, False), (10, False)]
    for step, force in calls:
        a = port.save(step, {"x": torch.full((2,), float(step)), "step": step},
                      sidecar={"step": step}, force=force)
        b = ref.save(step, {"x": jnp.full((2,), float(step)), "step": jnp.int32(step)},
                     sidecar={"step": step}, force=force)
        ref.wait()
        assert a == bool(b), (step, force)
        assert port.all_steps() == sorted(ref._mgr.all_steps()), step
    assert port.all_steps() == [8, 10]
    for name in ("port", "jax"):
        assert sorted(f for f in os.listdir(tmp_path / name) if f.startswith("artifacts")) == \
            ["artifacts-10.json", "artifacts-8.json", "artifacts.json"]
    assert port.load_sidecar(8) == ref.load_sidecar(8) == {"step": 8}
    assert port.load_sidecar() == {"step": 10} and port.latest_step() == 10
    ref.close()


def test_a_half_written_step_is_ignored(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    mgr = tck.CheckpointManager(str(d), save_interval_steps=1)
    mgr.save(2, {"w": torch.full((4,), 2.0), "step": 2})

    def crash(tensors, path, metadata=None):  # dies after a partial write
        with open(path, "wb") as f:
            f.write(b"\x10\x00")
        raise OSError("disk gone")

    monkeypatch.setattr(tck, "save_file", crash)
    with pytest.raises(OSError, match="disk gone"):
        mgr.save(4, {"w": torch.full((4,), 4.0), "step": 4})
    monkeypatch.undo()
    assert mgr.latest_step() == 2 and sorted(os.listdir(d)) == ["2"]
    # what a killed process leaves: a temporary directory and a bare step name
    os.makedirs(d / "6.tmp-killed")
    (d / "6.tmp-killed" / tck.PARAMS_FILE).write_bytes(b"\x00" * 16)
    os.makedirs(d / "8")
    mgr2 = tck.CheckpointManager(str(d))
    assert mgr2.latest_step() == 2 and not (d / "6.tmp-killed").exists()
    state = mgr2.restore({"w": torch.zeros(4), "step": 0})
    assert state["step"] == 2 and torch.equal(state["w"], torch.full((4,), 2.0))


def _tiny_batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    N, begin = CFG.num_image_tokens, CFG.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), CFG.image_token_index), rng.randint(3, 250, (B, 4)),
                          rng.randint(begin, begin + CFG.spatial_token_num, (B, 6))], axis=1)
    tt = np.zeros(ids.shape, np.int32)
    tt[:, N + 4:] = 1
    size = CFG.vision.image_size
    return {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
            "token_type_ids": tt, "labels": np.where(tt == 0, -100, ids),
            "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
            "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                                  np.float32)[None].repeat(B, 0)}


def test_train_loop_resume(tmp_path):
    """Checkpoints at intervals, a fresh loop (fresh parameters: the port
    updates in place) restores the latest step and continues; it ends where
    an uninterrupted run ends (mirrors tests/test_trainer_resume.py)."""
    ocfg = topt.OptimizerConfig(learning_rate=1e-3, total_steps=10, schedule="constant")
    scfg = tts.TrainStepConfig(use_remat=False, compute_dtype=torch.float32)
    batch = _tiny_batch()

    def setup():
        params = tiny_params(0)
        tx = topt.make_optimizer(ocfg, params, None)
        return tts.init_train_state(params, tx), tts.make_train_step(CFG, tx, scfg)

    def run(state, step, max_steps, mgr, out):
        return train_loop(state=state, train_step=step, batches=itertools.repeat(batch),
                          config=TrainerConfig(output_dir=out, max_steps=max_steps, log_every=1,
                                               save_every=2, tensorboard=False),
                          checkpoint_manager=mgr)

    straight = run(*setup(), 5, None, str(tmp_path / "a"))
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=2, max_to_keep=2)
    state = run(*setup(), 3, mgr, str(tmp_path / "b"))
    assert state["step"] == 3 and mgr.all_steps() == [2, 3]  # the final forced save
    after_3 = {p: t.detach().clone() for p, t in iter_leaves(state["params"])}
    mgr2 = tck.CheckpointManager(str(tmp_path / "ck"), save_interval_steps=2, max_to_keep=2)
    resumed = run(*setup(), 5, mgr2, str(tmp_path / "b"))
    assert resumed["step"] == 5 and mgr2.all_steps() == [4, 5]
    assert resumed["opt_state"]["count"] == 5
    assert any(not torch.equal(after_3[p], t) for p, t in iter_leaves(resumed["params"]))
    assert_states_equal(resumed["params"], straight["params"])
    assert_states_equal(resumed["opt_state"], straight["opt_state"])
    rows = [json.loads(line) for line in open(tmp_path / "b" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]


def test_train_loop_without_resume_starts_over(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(4, {"w": torch.ones(2), "step": 4})
    seen = []

    def step(state, batch):
        seen.append(state["step"])
        state["step"] += 1
        return state, {"loss": torch.tensor(0.0)}

    state = train_loop(state={"w": torch.zeros(2), "step": 0}, train_step=step,
                       batches=iter([{}] * 2),
                       config=TrainerConfig(output_dir=str(tmp_path / "o"), max_steps=2,
                                            resume=False, tensorboard=False),
                       checkpoint_manager=mgr)
    assert seen == [0, 1] and state["step"] == 2 and mgr.all_steps() == [2, 4]


# ---------------------------------------------------------------------------
# the CLIs on the synthetic RLDS fixture
# ---------------------------------------------------------------------------

COMMON = ["--model_preset", "spatialvla_tiny", "--no_vision_zoe", "--image_size", "56",
          "--seq_len", "80", "--per_device_batch_size", "2", "--shuffle_buffer_size", "4",
          "--logging_steps", "1", "--device", "cpu", "--mixture", "bridge"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from tests.fixtures import make_bridge_like_dataset

    root = str(tmp_path_factory.mktemp("rlds"))
    make_bridge_like_dataset(root, img_hw=(48, 64))
    return root


@pytest.fixture(scope="module")
def pretrained(data_dir, tmp_path_factory):
    """pretrain.main for 2 steps: (output dir, final state)."""
    from spatialvla_tpu_torch.train import pretrain

    out = str(tmp_path_factory.mktemp("pretrain"))
    state = pretrain.main(["--data_root_dir", data_dir, "--output_dir", out, "--max_steps", "2",
                           "--save_steps", "1", "--save_total_limit", "1",
                           "--learning_rate", "1e-3"] + COMMON)
    return out, state


def test_pretrain_writes_step_checkpoints_and_the_final_export(pretrained):
    out, state = pretrained
    mgr = tck.CheckpointManager(os.path.join(out, "checkpoints"))
    assert state["step"] == 2 and mgr.all_steps() == [2]  # save_total_limit 1
    side = mgr.load_sidecar()
    assert side == {"model_config": json.loads(CFG.to_json()), "mixture": "bridge"}
    export = tck.load_params(out, device="cpu")
    assert_states_equal(export, state["params"])
    for name in ("processor_config.json", "ds_stats.json", "config.json", tck.PARAMS_FILE):
        assert os.path.exists(os.path.join(out, name)), name


def test_pretrain_init_checkpoint_starts_from_the_export(pretrained, data_dir, tmp_path):
    from spatialvla_tpu_torch.train import pretrain

    out, state = pretrained
    args = pretrain.build_argparser().parse_args(
        ["--data_root_dir", data_dir, "--output_dir", str(tmp_path / "again"),
         "--init_checkpoint", out, "--seed", "5"] + COMMON)
    parts = pretrain.build_everything(args)
    assert_states_equal(parts["state"]["params"], state["params"])
    assert all(p.requires_grad for _, p in iter_leaves(parts["state"]["params"]))


def test_finetune_lora_runs_checkpoints_and_resumes(pretrained, data_dir, tmp_path):
    from spatialvla_tpu_torch.train import finetune

    out = str(tmp_path / "ft")
    argv = ["--pretrained_dir", pretrained[0], "--data_root_dir", data_dir, "--output_dir", out,
            "--use_lora", "--lora_rank", "4", "--save_steps", "2",
            "--attn_backend", "xla"] + COMMON
    state = finetune.main(argv + ["--max_steps", "2"])
    assert state["step"] == 2 and set(state["trainable"]) == {"lora", "saved"}
    mgr = tck.CheckpointManager(os.path.join(out, "checkpoints"))
    assert mgr.all_steps() == [2]
    proc = json.load(open(os.path.join(out, "processor_config.json")))
    assert "bridge_orig/1.0.0" in proc["statistics"]
    after_2 = {p: t.detach().clone() for p, t in iter_leaves(state["trainable"])}
    resumed = finetune.main(argv + ["--max_steps", "4"])
    assert resumed["step"] == 4 and mgr.all_steps() == [2, 4]
    assert resumed["opt_state"]["count"] == 4
    assert any(not torch.equal(after_2[p], t) for p, t in iter_leaves(resumed["trainable"]))
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in rows) and "grad_norm" not in rows[-1]


def test_finetune_full_parameters(pretrained, data_dir, tmp_path):
    from spatialvla_tpu_torch.train import finetune

    out = str(tmp_path / "full")
    state = finetune.main(["--pretrained_dir", pretrained[0], "--data_root_dir", data_dir,
                           "--output_dir", out, "--max_steps", "1", "--save_steps", "5",
                           "--attn_backend", "xla"] + COMMON)
    assert state["step"] == 1 and "params" in state
    assert tck.CheckpointManager(os.path.join(out, "checkpoints")).all_steps() == [1]
    # the frozen LM embedding is the pretrained one
    assert torch.equal(state["params"]["lm"]["embed"].detach(),
                       pretrained[1]["params"]["lm"]["embed"].detach())


def test_finetune_adapt_emb_matches_jax(pretrained, data_dir, tmp_path):
    from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
    from spatialvla_tpu_torch.train import finetune

    gs = {d: {"mu": 0.1 * i, "sigma": 0.5 + 0.1 * i}
          for i, d in enumerate(("theta", "phi", "r", "roll", "pitch", "yaw"))}
    path = tmp_path / "gs.json"
    path.write_text(json.dumps(gs))
    args = finetune.build_argparser().parse_args(
        ["--pretrained_dir", pretrained[0], "--data_root_dir", data_dir, "--output_dir",
         str(tmp_path / "o"), "--use_lora", "--lora_rank", "4", "--adapt_emb", str(path),
         "--min_sigma", "0.05"] + COMMON)
    parts = finetune.build_everything(args)
    emb = pretrained[1]["params"]["spatial_embed"].detach().numpy()
    jproc = JaxProcessor.load(pretrained[0])
    want = jproc.action_tokenizer.adapt_to_gaussian(gs, min_sigma=0.05, embeddings=emb)
    got = parts["base_params"]["spatial_embed"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(want, jnp.float32)))
    assert not np.array_equal(got.numpy(), emb)
    # the LoRA state's saved copy starts from the re-gridded table
    np.testing.assert_array_equal(
        parts["state"]["trainable"]["saved"]["spatial_embed"].detach().numpy(), got.numpy())
    assert parts["processor"].action_tokenizer.gs_params == gs


@pytest.mark.parametrize("argv", [["--attn_backend", "pipeline"], ["--mesh_sp", "2"]],
                         ids=["model2-pipeline", "model2-sp2"])
def test_finetune_lora_over_the_model_axis_with_sp_or_pipe(pretrained, data_dir, tmp_path, argv):
    """--use_lora --mesh_model 2 with the pipeline backend (a pipe of one
    stage) and with --mesh_sp 2 (the ring), in one process: two steps, a
    step checkpoint and finite losses."""
    from spatialvla_tpu_torch.train import finetune

    out = str(tmp_path / "ft")
    state = finetune.main(["--pretrained_dir", pretrained[0], "--data_root_dir", data_dir,
                           "--output_dir", out, "--use_lora", "--lora_rank", "4",
                           "--save_steps", "2", "--max_steps", "2", "--mesh_model", "2"]
                          + argv + COMMON)
    assert state["step"] == 2 and set(state["trainable"]) == {"lora", "saved"}
    assert tck.CheckpointManager(os.path.join(out, "checkpoints")).all_steps() == [2]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)


def test_finetune_without_a_card_raises_unless_asked_for_the_cpu(pretrained, tmp_path,
                                                                 monkeypatch):
    from spatialvla_tpu_torch.train import finetune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = finetune.build_argparser().parse_args(
        ["--pretrained_dir", pretrained[0], "--data_root_dir", "d",
         "--output_dir", str(tmp_path / "o")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        finetune.build_everything(args)
    assert not (tmp_path / "o").exists()


def test_tree_walk_serves_the_lora_state():
    """The LoRA state's optimizer moments are keyed by the shared walker's
    paths, flat factor keys included."""
    state = lora_state(0)
    paths = [p for p, _ in iter_leaves(state["trainable"])]
    assert "lora/lm/layers/attn/q/a" in paths and "saved/spatial_embed" in paths
    assert sorted(state["opt_state"]["mu"]) == sorted(paths)
    assert map_with_paths(lambda p, t: p, {"x/y": [1]}) == {"x/y": ["x/y/0"]}
