"""The port's training path (spatialvla_tpu_torch/train, models/spatialvla.py
forward) against the JAX package on the CPU, at fp32, with the same
numpy-seeded weights and batches, on spatialvla_tiny(use_vision_zoe=True).

Tolerances (fp32; the sums run in another order, and the port's flash
backward is the kernels' plain version where JAX's CPU backward is the
reference's VJP):
* forward loss and hidden states, both backends: atol 2e-5 / rtol 1e-5;
* chunked loss, metrics and d(loss)/d(hidden): rtol 1e-5, atol 1e-6;
* schedule values: rtol 1e-4 (optax evaluates them in float32); optimizer updates on identical gradients:
  atol 1e-7 / rtol 1e-5 on the parameters after each of 3 updates;
* two full train steps: loss, metrics and grad_norm rtol 1e-4; parameters
  atol 1e-6 after 2 steps. The step test uses eps = 1e-3 (at the default
  1e-8 the Adam update is nearly sign(g), so a gradient within rounding of
  0 could flip a whole lr-sized step); the optimizer test covers the
  default eps on identical gradients;
* micro_steps=2 against the doubled batch (the port with itself): loss
  rtol 1e-5, parameters atol 1e-6.
"""
import dataclasses
import json
import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.action import SpatialActionTokenizer
from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.train import optimizer as jopt
from spatialvla_tpu.train import train_step as jts
from spatialvla_tpu.train.loss import chunked_loss_and_metrics as j_chunked
from spatialvla_tpu.train.metrics import build_decode_luts as j_luts
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.train import optimizer as topt
from spatialvla_tpu_torch.train import train_step as tts
from spatialvla_tpu_torch.train.loss import chunked_loss_and_metrics as t_chunked
from spatialvla_tpu_torch.train.metrics import build_decode_luts as t_luts

torch.set_num_threads(2)

CFG = spatialvla_tiny(use_vision_zoe=True)
METRICS = ("loss", "accuracy", "translation_accuracy", "rotation_accuracy",
           "gripper_accuracy", "l1_loss")


@pytest.fixture(scope="module")
def params():
    init = jax.jit(lambda key: jsv.init_params(key, CFG))  # one compile, not one per op
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def luts():
    tok = SpatialActionTokenizer(token_begin_idx=CFG.action_token_begin_idx)
    return j_luts(tok)


def make_batch(seed, B=2, n_text=5, n_action=6):
    """Image tokens + text + action suffix; row 1 right-padded by 2."""
    rng = np.random.RandomState(seed)
    N = CFG.num_image_tokens
    begin = CFG.action_token_begin_idx
    ids = np.concatenate([np.full((B, N), CFG.image_token_index), rng.randint(3, 250, (B, n_text)),
                          rng.randint(begin, begin + CFG.spatial_token_num, (B, n_action))],
                         axis=1).astype(np.int32)
    T = ids.shape[1]
    am = np.ones((B, T), np.int32)
    tt = np.zeros((B, T), np.int32)
    tt[:, N + n_text:] = 1
    if B > 1:
        am[1, -2:], tt[1, -2:], ids[1, -2:] = 0, 0, 0
    size = CFG.vision.image_size
    return {
        "input_ids": ids, "attention_mask": am, "token_type_ids": tt,
        "labels": np.where(tt == 0, -100, ids).astype(np.int32),
        "pixel_values": rng.rand(B, size, size, 3).astype(np.float32),
        "intrinsic": np.array([[60.0, 0, 28], [0, 55.0, 27], [0, 0, 1]],
                              np.float32)[None].repeat(B, 0),
    }


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("backend", ["xla", "flash"])
def test_forward_matches_jax(params, backend):
    batch = make_batch(0)
    jo = jax.jit(lambda p, b: jsv.forward(p, CFG, b.pop("input_ids"), **b, attn_backend=backend))(
        params, _jax_batch(batch))
    tb = tts.batch_to_tensors(batch, "cpu")
    to = tsv.forward(from_numpy_tree(params), CFG, tb.pop("input_ids"), **tb,
                     attn_backend=backend)
    np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(to["hidden"].detach().numpy(), np.asarray(jo["hidden"]),
                               atol=2e-5, rtol=1e-5)


def test_chunked_loss_and_metrics_match_jax(params, luts):
    batch = make_batch(1)
    rng = np.random.RandomState(1)
    T, H = batch["input_ids"].shape[1], CFG.text.hidden_size
    hidden = rng.randn(2, T, H).astype(np.float32)
    kw = dict(begin_idx=CFG.action_token_begin_idx, chunk_size=7)

    def jloss(h):
        return j_chunked(params["lm"], CFG.text, h, jnp.asarray(batch["labels"]),
                         jnp.asarray(batch["attention_mask"]),
                         luts={k: jnp.asarray(v) for k, v in luts.items()}, **kw)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hidden))
    th = torch.from_numpy(hidden).requires_grad_()
    tl, tm = t_chunked(from_numpy_tree(params["lm"]), CFG.text, th,
                       torch.from_numpy(batch["labels"]).long(),
                       torch.from_numpy(batch["attention_mask"]),
                       luts={k: torch.from_numpy(v) for k, v in luts.items()}, **kw)
    tl.backward()
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "constant"])
def test_schedule_matches_optax(schedule):
    cfg = topt.OptimizerConfig(learning_rate=3e-4, warmup_ratio=0.1, total_steps=50,
                               schedule=schedule)
    jsched = jopt.make_schedule(jopt.OptimizerConfig(**dataclasses.asdict(cfg)))
    tsched = topt.make_schedule(cfg)
    steps = np.arange(0, 60)
    np.testing.assert_allclose([tsched(int(s)) for s in steps],
                               np.asarray(jax.vmap(jsched)(jnp.asarray(steps))), rtol=1e-4,
                               atol=1e-12)
    assert tsched(0) == 0.0


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_updates_match_optax(grad_scale, weight_decay):
    """multi_transform(clip_by_global_norm + adamw | set_to_zero) on the same
    gradients; the first update uses lr = schedule(0) = 0."""
    rng = np.random.RandomState(2)
    tree = {"lm": {"embed": rng.randn(6, 4), "w": rng.randn(4, 3)}, "b": rng.randn(5)}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    cfg = topt.OptimizerConfig(learning_rate=1e-2, warmup_ratio=0.2, total_steps=10,
                               weight_decay=weight_decay)
    jmask = jopt.trainable_mask(tree)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**dataclasses.asdict(cfg)), tree, jmask)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, tree), None
    jstate = tx.init(jp)
    tp = from_numpy_tree(tree)
    topt_ = topt.make_optimizer(cfg, tp, topt.trainable_mask(tp))
    tstate = topt_.init(tp)
    assert topt.trainable_mask(tp) == jmask
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * grad_scale).astype(np.float32),
                                   tree)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        lr = topt_.update(tp, dict(topt.iter_leaves(from_numpy_tree(g))), tstate)
        if step == 0:
            assert lr == 0.0
            np.testing.assert_array_equal(tp["lm"]["w"].numpy(), tree["lm"]["w"])
        for (path, a), (_, b) in zip(topt.iter_leaves(to_numpy_tree(tp)),
                                     topt.iter_leaves(jax.tree_util.tree_map(np.asarray, jp))):
            np.testing.assert_allclose(a, b, atol=1e-7, rtol=1e-5, err_msg=f"{path} step {step}")
    np.testing.assert_array_equal(tp["lm"]["embed"].numpy(), tree["lm"]["embed"])  # frozen


def _train_setup(params, luts, backend, eps=1e-3, micro_steps=1, lr=1e-3):
    ocfg = dict(learning_rate=lr, warmup_ratio=0.2, total_steps=10, eps=eps)
    step_kw = dict(use_remat=True, attn_backend=backend, loss_chunk_size=7,
                   micro_steps=micro_steps)
    tparams = from_numpy_tree(params)
    tmask = topt.trainable_mask(tparams)
    ttx = topt.make_optimizer(topt.OptimizerConfig(**ocfg), tparams, tmask)
    tstep = tts.make_train_step(CFG, ttx, tts.TrainStepConfig(compute_dtype=torch.float32,
                                                              **step_kw),
                                luts={k: torch.from_numpy(v) for k, v in luts.items()})
    return ocfg, step_kw, tts.init_train_state(tparams, ttx), tstep


def test_two_train_steps_match_jax(params, luts):
    ocfg, step_kw, tstate, tstep = _train_setup(params, luts, "flash")
    jmask = jopt.trainable_mask(params)
    jtx = jopt.make_optimizer(jopt.OptimizerConfig(**ocfg), params, jmask)
    jstep = jax.jit(jts.make_train_step(
        CFG, jtx, jts.TrainStepConfig(compute_dtype=jnp.float32, **step_kw),
        luts={k: jnp.asarray(v) for k, v in luts.items()}))
    jstate = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtx)
    zoe_before = to_numpy_tree(tstate["params"]["zoe"])
    for seed in (3, 4):
        batch = make_batch(seed)
        jstate, jm = jstep(jstate, _jax_batch(batch))
        tstate, tm = tstep(tstate, batch)
        for k in METRICS + ("grad_norm",):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert tstate["step"] == 2 and int(jstate["step"]) == 2
    jp = jax.tree_util.tree_map(np.asarray, jstate["params"])
    for (path, a), (_, b) in zip(topt.iter_leaves(to_numpy_tree(tstate["params"])),
                                 topt.iter_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=path)
    # the frozen LM embedding and ZoeDepth are bit-identical; a trained leaf moved
    np.testing.assert_array_equal(tstate["params"]["lm"]["embed"].detach().numpy(),
                                  params["lm"]["embed"])
    for (path, a), (_, b) in zip(topt.iter_leaves(to_numpy_tree(tstate["params"]["zoe"])),
                                 topt.iter_leaves(zoe_before)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert not np.array_equal(tstate["params"]["spatial_embed"].detach().numpy(),
                              params["spatial_embed"])


def test_micro_steps_match_doubled_batch(params, luts):
    b1, b2 = make_batch(5), make_batch(6)
    big = {k: np.concatenate([b1[k], b2[k]]) for k in b1}
    micro = {k: np.stack([b1[k], b2[k]]) for k in b1}
    _, _, s1, step1 = _train_setup(params, luts, "flash")
    _, _, s2, step2 = _train_setup(params, luts, "flash", micro_steps=2)
    s1, m1 = step1(s1, big)
    s2, m2 = step2(s2, micro)
    s1, m1 = step1(s1, big)  # the second update moves the parameters (lr > 0)
    s2, m2 = step2(s2, micro)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    for (path, a), (_, b) in zip(topt.iter_leaves(to_numpy_tree(s1["params"])),
                                 topt.iter_leaves(to_numpy_tree(s2["params"]))):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from tests.fixtures import make_bridge_like_dataset

    root = str(tmp_path_factory.mktemp("rlds"))
    make_bridge_like_dataset(root, img_hw=(48, 64))
    return root


def test_pretrain_main_on_the_fixture(data_dir, tmp_path):
    from spatialvla_tpu_torch.train import pretrain

    out = str(tmp_path / "pretrain")
    state = pretrain.main([
        "--data_root_dir", data_dir, "--mixture", "bridge", "--output_dir", out,
        "--model_preset", "spatialvla_tiny", "--image_size", "56", "--seq_len", "80",
        "--max_steps", "2", "--per_device_batch_size", "2", "--shuffle_buffer_size", "4",
        "--logging_steps", "1", "--learning_rate", "1e-3", "--device", "cpu",
    ])
    assert state["step"] == 2
    for name in ("processor_config.json", "ds_stats.json", "config.json"):
        assert os.path.exists(os.path.join(out, name)), name
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)
    assert "translation_accuracy" in rows[-1] and "l1_loss" in rows[-1]
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(os.path.join(out, "tb")))


def test_pretrain_without_a_card_raises_unless_asked_for_the_cpu(data_dir, tmp_path,
                                                                 monkeypatch):
    from spatialvla_tpu_torch.models import spatialvla as port_model
    from spatialvla_tpu_torch.train import pretrain

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built although no device was usable")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_model, "init_params", no_model)
    args = pretrain.build_argparser().parse_args([
        "--data_root_dir", data_dir, "--output_dir", str(tmp_path / "o"),
        "--model_preset", "spatialvla_tiny",
    ])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain.build_everything(args)
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("argv, axes, backend", [
    (["--mesh_model", "2", "--attn_backend", "ring"], dict(model=2), "ring"),
    (["--mesh_model", "2", "--mesh_sp", "2"], dict(model=2, sp=2), "ring"),
    (["--mesh_model", "2", "--mesh_pp", "2"], dict(model=2, pipe=2), "pipeline"),
], ids=["model2-ring", "model2-sp2", "model2-pp2"])
def test_pretrain_model_axis_with_sp_or_pipe_in_one_process(data_dir, tmp_path, argv, axes,
                                                            backend):
    """The model axis with the ring or pipeline backend, and with --mesh_sp
    / --mesh_pp (which select them), held by one process: a LocalMesh of
    those sizes; two steps, a step checkpoint and finite metrics."""
    from spatialvla_tpu_torch.parallel import LocalMesh
    from spatialvla_tpu_torch.train import pretrain
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager

    out = str(tmp_path / "pretrain")
    argv = ["--data_root_dir", data_dir, "--mixture", "bridge", "--output_dir", out,
            "--model_preset", "spatialvla_tiny", "--image_size", "56", "--seq_len", "80",
            "--max_steps", "2", "--per_device_batch_size", "2", "--shuffle_buffer_size", "4",
            "--logging_steps", "1", "--learning_rate", "1e-3", "--device", "cpu"] + argv
    args = pretrain.build_argparser().parse_args(argv)
    _, mesh, _, _ = pretrain.setup_parallel(args, torch.device("cpu"), explain=False)
    assert mesh == LocalMesh(**axes) and args.attn_backend == backend
    state = pretrain.main(argv)
    assert state["step"] == 2 and state["params"]["lm"]["layers"]["attn"]["q"].shape[0] == 2
    assert CheckpointManager(os.path.join(out, "checkpoints")).all_steps() == [2]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)


def test_train_loop_passes_step_args_and_saves_through_the_manager(tmp_path):
    """train_step(state, *step_args, batch) as JAX's loop calls it; a save
    every save_every steps, then one forced final save (trainer.py:85-153)."""
    from spatialvla_tpu_torch.train.checkpoints import CheckpointManager
    from spatialvla_tpu_torch.train.trainer import TrainerConfig, train_loop

    base = torch.ones(3)
    seen = []

    def step(state, base_arg, batch):
        assert base_arg is base
        seen.append(batch["i"])
        state["w"].add_(base_arg)
        state["step"] += 1
        return state, {"loss": torch.tensor(float(batch["i"]))}

    mgr = CheckpointManager(str(tmp_path / "ck"), save_interval_steps=2, max_to_keep=5)
    state = train_loop(state={"w": torch.zeros(3), "step": 0}, train_step=step,
                       batches=iter([{"i": i} for i in range(5)]),
                       config=TrainerConfig(output_dir=str(tmp_path), max_steps=5, log_every=1,
                                            save_every=2, tensorboard=False),
                       checkpoint_manager=mgr, sidecar={"run": "a"}, step_args=(base,))
    assert seen == [0, 1, 2, 3, 4] and state["step"] == 5
    assert mgr.all_steps() == [2, 4, 5] and mgr.load_sidecar(4) == {"run": "a"}
    restored = mgr.restore({"w": torch.zeros(3), "step": 0}, step=4)
    assert restored["step"] == 4 and torch.equal(restored["w"], torch.full((3,), 4.0))
