"""The committed RLDS fixture (tests/fixtures_rlds/bridge_orig/1.0.0, written
by scripts/make_rlds_fixture_torch.py) and its golden.npz; the port's data
layer over it against the JAX package's; both training CLIs of the port
over it on the CPU.

golden.npz holds what the JAX package's source layer and frame transform
give on the fixture: the dataset statistics, and, for each trajectory
sorted by its actions (the shard reader runs on threads), its actions and
the primary frame of its first and last step decoded at 224 x 224 (the
frame transform's decode, ``native.decode_jpeg_resize``). Regenerate it
after a change to the fixture with
``PYTHONPATH=. python tests/test_torch_data_cli.py``.
The card's machine has no libjpeg: chip_smoke.py holds the port's nvJPEG
route to the same file within a stated bound.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from spatialvla_tpu.data import FrameTransformConfig as JaxFrameConfig
from spatialvla_tpu.data import InterleavedRLDSDataset as JaxDataset
from spatialvla_tpu.data import TrajTransformConfig as JaxTrajConfig
from spatialvla_tpu.data import native as j_native
from spatialvla_tpu.data import statistics as j_statistics
from spatialvla_tpu.data.pipeline import RLDSDataSource as JaxSource
from spatialvla_tpu_torch.data import FrameTransformConfig as PortFrameConfig
from spatialvla_tpu_torch.data import InterleavedRLDSDataset as PortDataset
from spatialvla_tpu_torch.data import TrajTransformConfig as PortTrajConfig
from spatialvla_tpu_torch.data import native as t_native
from spatialvla_tpu_torch.data import statistics as t_statistics
from spatialvla_tpu_torch.data import tfds_schema
from spatialvla_tpu_torch.data.pipeline import RLDSDataSource as PortSource
from spatialvla_tpu_torch.train import checkpoints as tck
from spatialvla_tpu_torch.utils.tree import iter_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures_rlds")
DATASET = "bridge_orig/1.0.0"
GOLDEN = os.path.join(FIXTURE, DATASET, "golden.npz")
SIZE = 224

torch.set_num_threads(2)


def flat_statistics(stats, prefix="statistics"):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out.update(flat_statistics(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def golden_of(Source, native, cache_dir):
    """The golden arrays from one package's source layer and decode."""
    src = Source(DATASET, FIXTURE, seed=0)
    trajs = sorted(src.iter_canonical(), key=lambda t: t["action"].tobytes())
    out = {"actions": np.stack([t["action"] for t in trajs])}
    for key, i in (("first_frames", 0), ("last_frames", -1)):
        out[key] = np.stack([native.decode_jpeg_resize(t["observation"]["image_primary"][i],
                                                       SIZE, SIZE) for t in trajs])
    out.update(flat_statistics(src.statistics(force=True, cache_dir=cache_dir)))
    return out


def write_golden():
    with tempfile.TemporaryDirectory() as cache:
        np.savez_compressed(GOLDEN, **golden_of(JaxSource, j_native, cache))


def assert_matches_golden(got, golden):
    """Actions and frames exactly; the statistics to 1e-6 relative (numpy's
    float32 reductions may round the last bit differently for arrays at
    other memory offsets, as tests/test_torch_copies.py says)."""
    assert sorted(got) == sorted(golden.files)
    for k in golden.files:
        if k.startswith("statistics/") and golden[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], golden[k], rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            assert got[k].dtype == golden[k].dtype, k
            np.testing.assert_array_equal(got[k], golden[k], err_msg=k)


def test_the_fixture_parses_and_is_small():
    ds_dir = os.path.join(FIXTURE, DATASET)
    schema = tfds_schema.load_schema(ds_dir)
    shards = tfds_schema.list_shards(ds_dir, "train")
    assert len(shards) == 2
    episodes = [tfds_schema.decode_episode(f, schema) for f in t_native.iter_parsed(shards)]
    assert len(episodes) == 4
    for ep in episodes:
        steps = ep["steps"]
        assert len(steps["action"]) == 8 and np.asarray(steps["action"]).shape == (8, 7)
        jpeg = steps["observation"]["image_0"][0]
        assert jpeg[:2] == b"\xff\xd8"  # a JPEG, decoded at its own 256 x 256
        frame = t_native.decode_jpeg_resize(jpeg, 256, 256)
        assert frame.shape == (256, 256, 3) and frame.std() > 10
    total = sum(os.path.getsize(os.path.join(ds_dir, n)) for n in os.listdir(ds_dir))
    assert total < 2 << 20


def test_the_jax_package_gives_the_golden(tmp_path):
    assert_matches_golden(golden_of(JaxSource, j_native, str(tmp_path)), np.load(GOLDEN))


def test_the_port_reader_gives_the_golden(tmp_path):
    assert t_native.decode_path() in ("libjpeg", "nvjpeg")
    assert_matches_golden(golden_of(PortSource, t_native, str(tmp_path)), np.load(GOLDEN))


def test_the_port_frames_match_the_jax_frames(tmp_path, monkeypatch):
    """One epoch of decoded frames (no shuffle, no augmentation, 224 x 224)
    from each package's whole pipeline: the same images, in any order, the
    golden's first and last frames among them. (Which trajectory takes which
    random draw of the trajectory transforms depends on the reader threads'
    order, so the frames' action chunks are not compared here; the source
    layer's actions are, against the golden.)"""
    monkeypatch.setattr(j_statistics, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "port"))
    images = []
    for Dataset, Traj, Frame in ((JaxDataset, JaxTrajConfig, JaxFrameConfig),
                                 (PortDataset, PortTrajConfig, PortFrameConfig)):
        ds = Dataset([(DATASET, 1.0)], FIXTURE, traj_config=Traj(forward_window_size=3),
                     frame_config=Frame(resize_size=(SIZE, SIZE), augment=False, num_workers=2),
                     shuffle_buffer_size=0, seed=0)
        frames = [f["image_primary"] for f, _ in zip(ds.frames(), range(24))]
        assert all(f.shape == (SIZE, SIZE, 3) and f.dtype == np.uint8 for f in frames)
        images.append({f.tobytes() for f in frames})
    assert images[0] == images[1] and len(images[0]) == 24  # 4 trajectories x 6 steps
    golden = np.load(GOLDEN)
    for key in ("first_frames", "last_frames"):
        assert {f.tobytes() for f in golden[key]} <= images[1], key


def _test_image(gray):
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:131, 0:197]  # odd sizes: the chroma planes' last column and row
    img = np.stack([128 + 60 * np.sin(x / 9.0 + c) + 40 * np.cos(y / 7.0 * c) for c in range(3)],
                   -1)
    img[40:80, 50:120] = [250, 20, 90]  # sharp chroma edges
    img = np.clip(img + rng.randn(*img.shape) * 8, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


@pytest.mark.parametrize("kind", ["fixture", "444", "422", "420", "gray"])
def test_the_planar_route_matches_libjpeg(kind):
    """The nvJPEG route's host half (the decoder's Y, Cb, Cr planes upsampled
    and converted to RGB as libjpeg does it), fed libjpeg's own planes, gives
    libjpeg's RGB decode bit for bit: on the fixture's JPEGs (4:2:0, 256 x
    256, at 256 and 224) and on 4:4:4 / 4:2:2 / 4:2:0 / gray test images of
    odd size, at sizes where libjpeg decodes at full size (its DCT scaling,
    which the nvJPEG route does not have, engages at half the size and
    below)."""
    import io

    from PIL import Image

    if t_native.decode_path() != "libjpeg":
        pytest.skip("the libjpeg route holds the planar path to libjpeg's decode")
    if kind == "fixture":
        shards = tfds_schema.list_shards(os.path.join(FIXTURE, DATASET), "train")
        jpegs = [b for f in t_native.iter_parsed(shards)
                 for b in f["steps/observation/image_0"] + f["steps/observation/image_1"]]
        sizes = [(256, 256), (224, 224)]
    else:
        buf = io.BytesIO()
        Image.fromarray(_test_image(kind == "gray")).save(
            buf, format="JPEG", quality=85,
            **({} if kind == "gray" else {"subsampling": ("444", "422", "420").index(kind)}))
        jpegs, sizes = [buf.getvalue()], [(131, 197), (112, 160)]  # no DCT scaling
    assert len(jpegs) in (1, 64)
    for jpeg in jpegs:
        for hw in sizes:
            np.testing.assert_array_equal(t_native.decode_jpeg_resize_planar(jpeg, *hw),
                                          t_native.decode_jpeg_resize(jpeg, *hw))


SUBSAMPLING = os.path.join(FIXTURE, "subsampling.npz")


@pytest.mark.parametrize("kind", ["444", "422", "420", "440", "411", "410", "gray"])
def test_each_subsampling_decodes_as_libjpeg(kind):
    """tests/fixtures_rlds/subsampling.npz (scripts/make_rlds_fixture_torch.py
    --subsampling: a 67 x 101 frame encoded by libjpeg at each chroma
    subsampling, and PIL's decode of it): the libjpeg route and the planar
    route (the nvJPEG route's host half: libjpeg-turbo's fancy upsampling
    at 4:2:2, 4:2:0 and 4:4:0, its sample repetition at 4:1:1 and 4:1:0)
    both give PIL's decode bit for bit."""
    if t_native.decode_path() != "libjpeg":
        pytest.skip("the libjpeg route holds the planar path to libjpeg's decode")
    z = np.load(SUBSAMPLING)
    jpeg, want = z[kind + "/jpeg"].tobytes(), z[kind + "/rgb"]
    hw = want.shape[:2]
    np.testing.assert_array_equal(t_native.decode_jpeg_resize(jpeg, *hw), want)
    np.testing.assert_array_equal(t_native.decode_jpeg_resize_planar(jpeg, *hw), want)


COMMON = ["--data_root_dir", FIXTURE, "--mixture", "bridge", "--model_preset", "spatialvla_tiny",
          "--image_size", "56", "--seq_len", "80", "--per_device_batch_size", "2",
          "--shuffle_buffer_size", "8", "--logging_steps", "1", "--device", "cpu"]


def _assert_restores(ckpt_dir, state):
    mgr = tck.CheckpointManager(ckpt_dir)
    like = {p: t for p, t in iter_leaves(state)}
    fresh = tck.restore_params(os.path.join(ckpt_dir, str(mgr.latest_step())),
                               _zeros_like(state))
    got = dict(iter_leaves(fresh))
    assert sorted(got) == sorted(like)
    for p, t in like.items():
        if torch.is_tensor(t):
            assert got[p].dtype == t.dtype and torch.equal(got[p], t.detach()), p
        else:
            assert got[p] == t, p


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree.detach()) if torch.is_tensor(tree) else tree


def test_both_clis_over_the_fixture(tmp_path, monkeypatch):
    """pretrain.main for 3 steps with a step checkpoint every 2 (kept: the
    last), its export; finetune.main with LoRA from that export, a save
    every step; each run's last checkpoint restores to the state it
    returned, bit for bit."""
    from spatialvla_tpu_torch.train import finetune, pretrain

    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "stats"))
    pre, ft = str(tmp_path / "pretrain"), str(tmp_path / "finetune")
    state = pretrain.main(["--output_dir", pre, "--max_steps", "3", "--save_steps", "2",
                           "--save_total_limit", "1", "--no_augment", "--loader_workers", "1",
                           "--learning_rate", "1e-3"] + COMMON)
    assert state["step"] == 3
    assert tck.CheckpointManager(os.path.join(pre, "checkpoints")).all_steps() == [3]
    _assert_restores(os.path.join(pre, "checkpoints"), state)
    for name in ("params.safetensors", "config.json", "processor_config.json", "ds_stats.json"):
        assert os.path.exists(os.path.join(pre, name)), name
    rows = [json.loads(line) for line in open(os.path.join(pre, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in rows)

    lora = finetune.main(["--pretrained_dir", pre, "--output_dir", ft, "--use_lora",
                          "--lora_rank", "4", "--max_steps", "2", "--save_steps", "1"] + COMMON)
    assert lora["step"] == 2 and set(lora["trainable"]) == {"lora", "saved"}
    assert tck.CheckpointManager(os.path.join(ft, "checkpoints")).all_steps() == [1, 2]
    _assert_restores(os.path.join(ft, "checkpoints"), lora)
    rows = [json.loads(line) for line in open(os.path.join(ft, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)


def test_chip_smoke_data_cli_phase_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's data_cli_path rehearsed at spatialvla_tiny on the CPU:
    the reader's route, the golden, both CLIs and their checks, the
    stepping thread's CPU time a step and the pretrain run's traced steps."""
    import chip_smoke

    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "stats"))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    res = chip_smoke.data_cli_path(torch, [], device="cpu", preset="spatialvla_tiny",
                                   text_layers=2, image_size=56, seq_len=80, work_root=None,
                                   trace_dir=str(tmp_path / "trace"))
    assert res["reader"]["decode_path"] == t_native.decode_path()
    assert res["golden"]["exact"] and res["golden"]["trajectories"] == 4
    for run in ("pretrain", "finetune"):
        assert len(res[run]["losses"]) == 3 and res[run]["restore"]["step"] == 3
        assert all(w["bytes"] > 0 and w["write_s"] >= 0 for w in res[run]["writes"])
    assert [w["step"] for w in res["pretrain"]["writes"]] == [2, 3]
    assert [w["step"] for w in res["finetune"]["writes"]] == [1, 2, 3]
    assert res["room"]["text_layers"] == 2
    steps = res["pretrain"]["steps"]
    assert all(s["user_ms"] + s["sys_ms"] > 0 for s in steps)
    assert [i for i, s in enumerate(steps) if "trace" in s] == [1, 2]
    assert "trace" not in str(res["finetune"]["steps"])
    for i in (1, 2):
        summary = steps[i]["trace"]
        assert summary["outer_ops"] > 0 and summary["kernels"] == 0  # no card
        assert summary["top_self_cpu"] and (tmp_path / "trace" / f"step{i}" / "trace.json").exists()


def test_chip_smoke_data_cli_work_root(monkeypatch):
    """The phase's runs go to /dev/shm on the card unless
    CHIP_SMOKE_WORK_ROOT names a directory; an empty value is TMPDIR."""
    import chip_smoke

    monkeypatch.delenv("CHIP_SMOKE_WORK_ROOT", raising=False)
    assert chip_smoke.data_cli_work_root() == "/dev/shm"
    monkeypatch.setenv("CHIP_SMOKE_WORK_ROOT", "/some/dir")
    assert chip_smoke.data_cli_work_root() == "/some/dir"
    monkeypatch.setenv("CHIP_SMOKE_WORK_ROOT", "")
    assert chip_smoke.data_cli_work_root() is None


if __name__ == "__main__":
    write_golden()
    print(f"wrote {GOLDEN}")
