"""The port's jax-free front ends beside the JAX package's scripts:
fit_gaussian_torch.py against fit_gaussian.py on the committed RLDS
fixture, convert_checkpoint_torch.py and export_hf_torch.py round-tripping a
tiny tree bit for bit, bench_train_torch.py and bench_data_torch.py
printing their JSON lines, and utils.profiling on the CPU."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from spatialvla_tpu.data import statistics as j_statistics
from spatialvla_tpu_torch import SpatialVLAPolicy, spatialvla_tiny
from spatialvla_tpu_torch.convert import export_hf_checkpoint
from spatialvla_tpu_torch.convert.hf_checkpoint import load_hf_checkpoint
from spatialvla_tpu_torch.data import statistics as t_statistics
from spatialvla_tpu_torch.train import checkpoints as tck
from spatialvla_tpu_torch.utils import profiling
from spatialvla_tpu_torch.utils.tree import iter_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures_rlds")

torch.set_num_threads(2)


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fit_gaussian_matches_the_jax_script(tmp_path, monkeypatch):
    monkeypatch.setattr(j_statistics, "_CACHE_DIR", str(tmp_path / "jax_stats"))
    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "port_stats"))
    common = ["--data_root_dir", FIXTURE, "--mixture", "bridge", "--exclude", "no_exclude"]
    script("fit_gaussian_torch").main(common + ["--output", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["fit_gaussian.py"] + common
                        + ["--output", str(tmp_path / "jax.json")])
    script("fit_gaussian").main()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert sorted(port) == sorted(ref) and len(ref) == 9  # x y z, the spherical 3, the rotations
    for dim in ref:
        assert sorted(port[dim]) == sorted(ref[dim])
        for k in ref[dim]:
            assert port[dim][k] == pytest.approx(ref[dim][k], rel=1e-6, abs=1e-6), (dim, k)


def _assert_trees_bit_equal(a, b):
    la, lb = dict(iter_leaves(a)), dict(iter_leaves(b))
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        y = lb[path]
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), path


def test_convert_and_export_round_trip_a_tiny_tree(tmp_path):
    """A tiny bf16 tree as an HF dir -> convert_checkpoint_torch.py -> the
    port's format (the stored dtype) -> export_hf_torch.py (float32, as the
    JAX script exports) -> an HF dir: every leaf the tree's, bit for bit
    (bf16 widens to float32 exactly)."""
    cfg = spatialvla_tiny(use_vision_zoe=True)
    policy = SpatialVLAPolicy.init_random(cfg, "cpu", seed=3)
    tree = policy.params
    hf = export_hf_checkpoint(tree, cfg, str(tmp_path / "hf"), processor=policy.processor)
    out = str(tmp_path / "port")
    script("convert_checkpoint_torch").main(["--hf_dir", hf, "--output", out, "--device", "cpu"])
    _assert_trees_bit_equal(tck.load_params(out, device="cpu"), tree)
    for name in ("config.json", "processor_config.json", tck.PARAMS_FILE):
        assert os.path.exists(os.path.join(out, name)), name
    wide = {p: t.float() for p, t in iter_leaves(tree)}
    for argv in (["--checkpoint_dir", out], ["--checkpoint_dir", hf, "--from_hf"]):
        hf2 = str(tmp_path / f"hf{len(argv)}")
        script("export_hf_torch").main(argv + ["--output_dir", hf2, "--device", "cpu"])
        again, config, _ = load_hf_checkpoint(hf2, device="cpu")
        assert all(t.dtype == torch.float32 for _, t in iter_leaves(again))
        _assert_trees_bit_equal({p: t for p, t in iter_leaves(again)}, wide)
        assert config.to_json() == cfg.to_json()


def test_the_scripts_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no card"):
        script("convert_checkpoint_torch").main(["--hf_dir", str(tmp_path), "--output",
                                                 str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no card"):
        script("bench_train_torch").main(["--preset", "spatialvla_tiny"])
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        script("trace_data_cli_torch").main(["--out", str(tmp_path / "trace")])


def test_bench_train_prints_its_json_line(capsys):
    result = script("bench_train_torch").main(
        ["--preset", "spatialvla_tiny", "--zoe", "--batch", "2", "--seq", "64", "--real_tokens",
         "40", "--attn", "xla", "--reps", "1", "--sets", "1", "--loss_chunk", "0",
         "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and line["device"] == "cpu"
    assert line["metric"].startswith("spatialvla_tiny LoRA-r32 train step (B2 x T64")
    assert line["ms_per_step"] > 0 and np.isfinite(line["loss"])


def test_bench_data_prints_its_json_line(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "stats"))
    result = script("bench_data_torch").main(["--n_frames", "40", "--threads", "2",
                                              "--image_size", "56"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and line["n_frames"] == 40 and line["frames_per_s"] > 0
    assert line["decode_path"] in ("libjpeg", "nvjpeg") and line["augment"]
    assert line["data_root_dir"] == FIXTURE


def test_profiling_helpers_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2, "z": [x + 1]}

    x = torch.ones(8)
    mean = profiling.timeit(fn, x, iters=3, warmup=2)
    assert len(calls) == 5 and mean > 0
    profiling.sync({"a": [x], "b": 3})  # CPU tensors and non-tensors: nothing to wait for
    profiling.sync(x)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert prof is not None and any("mm" in e.get("name", "") for e in trace["traceEvents"])
