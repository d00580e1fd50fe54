"""The port's own copies of the JAX package's jax-free modules (config,
action tokenizer, processor, TensorBoard writer, RLDS data layer, the HF
config and processor readers and config writer of convert/, serve/gating)
give the originals' dataclass fields, tokens, arrays, bytes, batches, dicts
and verdicts exactly, on the same inputs."""
import dataclasses
import json

import numpy as np
import pytest

from spatialvla_tpu import config as j_config
from spatialvla_tpu.convert import config_to_hf as j_config_to_hf
from spatialvla_tpu.convert import hf_checkpoint as j_hf
from spatialvla_tpu.action import SpatialActionTokenizer as JaxActionTokenizer
from spatialvla_tpu.data import FrameTransformConfig as JaxFrameConfig
from spatialvla_tpu.data import InterleavedRLDSDataset as JaxDataset
from spatialvla_tpu.data import TrajTransformConfig as JaxTrajConfig
from spatialvla_tpu.data import VLABatcher as JaxBatcher
from spatialvla_tpu.data import statistics as j_statistics
from spatialvla_tpu.data.pipeline import RLDSDataSource as JaxSource
from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
from spatialvla_tpu.serve import gating as j_gating
from spatialvla_tpu.parallel import partitioning as j_partitioning
from spatialvla_tpu.train import tb_writer as j_tb
from spatialvla_tpu_torch import config as t_config
from spatialvla_tpu_torch.convert import config_to_hf as t_config_to_hf
from spatialvla_tpu_torch.convert import hf_checkpoint as t_hf
from spatialvla_tpu_torch.action import SpatialActionTokenizer as PortActionTokenizer
from spatialvla_tpu_torch.data import FrameTransformConfig as PortFrameConfig
from spatialvla_tpu_torch.data import InterleavedRLDSDataset as PortDataset
from spatialvla_tpu_torch.data import TrajTransformConfig as PortTrajConfig
from spatialvla_tpu_torch.data import VLABatcher as PortBatcher
from spatialvla_tpu_torch.data import statistics as t_statistics
from spatialvla_tpu_torch.data.pipeline import RLDSDataSource as PortSource
from spatialvla_tpu_torch.processor import SpatialVLAProcessor as PortProcessor
from spatialvla_tpu_torch.serve import gating as t_gating
from spatialvla_tpu_torch.parallel import partitioning as t_partitioning
from spatialvla_tpu_torch.train import tb_writer as t_tb
from tests.fixtures import make_bridge_like_dataset


@pytest.mark.parametrize("preset", ["spatialvla_4b", "spatialvla_tiny", "spatialvla_tiny_zoe"])
def test_config_copy_matches(preset):
    name, kw = (preset[:-4], dict(use_vision_zoe=True)) if preset.endswith("_zoe") else (preset, {})
    a, b = getattr(t_config, name)(**kw), getattr(j_config, name)(**kw)
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.to_json() == b.to_json()
    assert dataclasses.asdict(t_config.SpatialVLAConfig.from_json(b.to_json())) == \
        dataclasses.asdict(b)


PRESETS = ["spatialvla_4b", "spatialvla_tiny", "spatialvla_tiny_zoe"]


def _preset(module, preset):
    name, kw = (preset[:-4], dict(use_vision_zoe=True)) if preset.endswith("_zoe") else (preset, {})
    return getattr(module, name)(**kw)


@pytest.mark.parametrize("preset", PRESETS)
def test_hf_config_copies_match(preset):
    """config_to_hf and config_from_hf (convert/export_hf.py,
    convert/hf_checkpoint.py): the same config.json dict, the same config
    read back, and the same defaults for a config.json that names little."""
    d = t_config_to_hf(_preset(t_config, preset))
    assert d == j_config_to_hf(_preset(j_config, preset))
    assert dataclasses.asdict(t_hf.config_from_hf(d)) == dataclasses.asdict(j_hf.config_from_hf(d))
    sparse = {"text_config": {"num_hidden_layers": 2}, "vision_zoe_config": {},
              "use_spatial_token": False}
    assert dataclasses.asdict(t_hf.config_from_hf(sparse)) == \
        dataclasses.asdict(j_hf.config_from_hf(sparse))


def test_processor_from_hf_copy_matches(tmp_path):
    """processor_from_hf on a directory with processor_config.json and on one
    without: the same processor state and prompt ids (no tokenizer files:
    both fall back to the ByteTokenizer)."""
    cfg = t_config.spatialvla_tiny(use_vision_zoe=True)
    state = {"statistics": {"d": {"action": {"q01": [-0.5] * 7, "q99": [2.0] * 7}}},
             "action_chunk_size": 2, "num_obs_steps": 1, "obs_delta": 1, "min_sigma": 0.1}
    full = tmp_path / "full"
    full.mkdir()
    (full / "processor_config.json").write_text(json.dumps(state))
    empty = tmp_path / "empty"
    empty.mkdir()
    for d in (full, empty):
        a = t_hf.processor_from_hf(str(d), cfg)
        b = j_hf.processor_from_hf(str(d), _preset(j_config, "spatialvla_tiny_zoe"))
        for name in ("image_token_id", "action_token_begin_idx", "image_seq_length",
                     "image_size", "statistics", "bin_policy", "intrinsic_config",
                     "action_config", "num_obs_steps", "obs_delta", "action_chunk_size",
                     "min_sigma"):
            assert getattr(a, name) == getattr(b, name), name
        assert type(a.text_tokenizer).__name__ == type(b.text_tokenizer).__name__
        assert a.build_prompt_ids("open the drawer") == b.build_prompt_ids("open the drawer")


KNOB_SETS = [dict(), dict(bits=8), dict(bits=4), dict(bits=4, group_size=128),
             dict(bits=8, mlp_bits=4), dict(bits=8, mlp_bits=8), dict(vision_bits=8),
             dict(bits=4, vision_bits=4, kv_bits=8, depth_image_size=256)]


def test_gating_copy_matches(tmp_path):
    """serve/gating.py: the same knobs, covering entries, verdicts, gate files
    and server-log lines (or the same refusal)."""
    class Policy:
        def __init__(self, desc, kv_bits=None, depth_image_size=None):
            self.quant_desc, self.kv_bits, self.depth_image_size = desc, kv_bits, depth_image_size

    gate = {"checkpoint": "c", "entries": [
        {"label": "int4", "knobs": {"bits": 4, "vision_bits": 8}, "token_agreement": 0.97,
         "action_l1": 0.004},
        {"label": "kv8", "knobs": {"kv_bits": 8}, "token_agreement": 0.99, "action_l1": 0.001}]}
    t_gating.write_gate(str(tmp_path / "t.json"), gate)
    j_gating.write_gate(str(tmp_path / "j.json"), gate)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert t_gating.load_gate(str(tmp_path / "j.json")) == j_gating.load_gate(str(tmp_path / "t.json"))
    (tmp_path / "bad.json").write_text(json.dumps({"format_version": 9}))
    for mod in (t_gating, j_gating):
        with pytest.raises(ValueError, match="format_version"):
            mod.load_gate(str(tmp_path / "bad.json"))
    for kw in KNOB_SETS:
        knobs = t_gating.quality_trade_knobs(**kw)
        assert knobs == j_gating.quality_trade_knobs(**kw)
        for g in (None, gate, {"entries": []}):
            assert t_gating.check_gate(g, knobs) == j_gating.check_gate(g, knobs)
            assert t_gating.covering_entry(g, knobs) == j_gating.covering_entry(g, knobs)
        desc = {k: kw.get(k) for k in ("bits", "vision_bits", "mlp_bits", "group_size")}
        policy = Policy(desc, kw.get("kv_bits"), kw.get("depth_image_size"))
        assert t_gating.policy_quality_knobs(policy) == j_gating.policy_quality_knobs(policy)
        for g, ungated in ((gate, False), (None, True), (None, False)):
            outs = []
            for mod in (t_gating, j_gating):
                try:
                    outs.append(("ok", mod.enforce_gate(policy, g, ungated=ungated)))
                except SystemExit as e:
                    outs.append(("refused", str(e)))
            assert outs[0] == outs[1]


@pytest.mark.parametrize("use_spherical", [True, False])
def test_action_tokenizer_copy_matches(use_spherical):
    num_bins = {"translation": {"theta_bins": 16, "phi_bins": 32, "r_bins": 8},
                "rotation": {"roll_bins": 16, "pitch_bins": 16, "yaw_bins": 16}, "gripper": 2}
    kw = dict(num_bins=num_bins, use_spherical=use_spherical, token_begin_idx=1024)
    port, ref = PortActionTokenizer(**kw), JaxActionTokenizer(**kw)
    assert port.vocab_size == ref.vocab_size
    actions = np.random.RandomState(0).uniform(-1, 1, (5, 4, 7))
    actions[..., 6] = np.random.RandomState(1).randint(0, 2, (5, 4))
    for a in actions:
        g = ref.encode_to_global_ids(a)
        np.testing.assert_array_equal(port.encode_to_global_ids(a), g)
        np.testing.assert_array_equal(port.decode_global_ids(g), ref.decode_global_ids(g))


def test_processor_copy_decodes_and_saves_as_the_original(tmp_path):
    kw = dict(image_token_id=1000, action_token_begin_idx=1024, image_seq_length=16,
              image_size=56, statistics={"d": {"action": {"q01": [-0.5] * 7, "q99": [2.0] * 7}}})
    port, ref = PortProcessor(**kw), JaxProcessor(**kw)
    ids = np.random.RandomState(2).randint(1024, 1024 + 8194, (3, 12))
    a, b = port.decode_actions(ids), ref.decode_actions(ids)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    port.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "ref"))
    assert (tmp_path / "port" / "processor_config.json").read_text() == \
        (tmp_path / "ref" / "processor_config.json").read_text()
    loaded = PortProcessor.load(str(tmp_path / "ref"))
    assert loaded.build_prompt_ids("pick up the cup") == ref.build_prompt_ids("pick up the cup")


def test_tb_writer_copy_writes_the_same_records():
    for t in (1.5, 1700000000.25):
        assert t_tb.encode_file_version_event(t) == j_tb.encode_file_version_event(t)
        assert t_tb.encode_scalar_event(t, 7, {"loss": 0.5, "lr": 1e-4}) == \
            j_tb.encode_scalar_event(t, 7, {"loss": 0.5, "lr": 1e-4})
    payload = t_tb.encode_scalar_event(2.0, 3, {"x": 1.0})
    assert t_tb._frame(payload) == j_tb._frame(payload)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rlds"))
    make_bridge_like_dataset(root)
    return root


def _assert_stats_close(a, b):
    """numpy's float32 reductions may round the last bit differently for
    arrays at other memory offsets, so the statistics agree to 1e-6
    relative; counts and shapes exactly."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _assert_stats_close(a[k], b[k])
    elif isinstance(b, (list, np.ndarray)) and np.asarray(b).dtype.kind == "f":
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-9)
    else:
        assert np.array_equal(a, b) if isinstance(b, (list, np.ndarray)) else a == b


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, (list, tuple, np.ndarray)):
        assert len(a) == len(b)
        if isinstance(b, np.ndarray) and b.dtype != object:
            np.testing.assert_array_equal(a, b)
        else:
            for x, y in zip(a, b):
                _assert_tree_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("augment", [False, True])
def test_data_pipeline_copy_matches(data_dir, augment, tmp_path, monkeypatch):
    """The same statistics; the same canonical trajectories from the source
    layer (read with the port's own build of the native reader, or the same
    pure-Python fallback); and from the same frames the same batches. (The
    shard reader and the frame stream run on threads, so their order may
    differ between two runs of either package.)"""
    # fresh statistics caches for both packages (a cache hit would skip the code under test)
    monkeypatch.setattr(j_statistics, "_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(t_statistics, "_CACHE_DIR", str(tmp_path / "port"))
    kw = dict(traj_config=JaxTrajConfig(forward_window_size=3), shuffle_buffer_size=8, seed=0,
              frame_config=JaxFrameConfig(resize_size=(56, 56), augment=augment))
    port_kw = dict(kw, traj_config=PortTrajConfig(forward_window_size=3),
                   frame_config=PortFrameConfig(resize_size=(56, 56), augment=augment))
    jds = JaxDataset([("bridge_orig/1.0.0", 1.0)], data_dir, **kw)
    tds = PortDataset([("bridge_orig/1.0.0", 1.0)], data_dir, **port_kw)
    _assert_stats_close(tds.statistics, jds.statistics)
    # the shard reader prefetches on threads: compare the trajectories in a
    # fixed order (by their actions)
    trajs = [sorted(S("bridge_orig/1.0.0", data_dir, seed=0).iter_canonical(),
                    key=lambda t: t["action"].tobytes())
             for S in (PortSource, JaxSource)]
    assert len(trajs[0]) == len(trajs[1]) == 6
    for a, b in zip(*trajs):
        _assert_tree_equal(a, b)
    frames = [f for f, _ in zip(jds.frames(), range(9))]
    out = []
    for Processor, Batcher in ((JaxProcessor, JaxBatcher), (PortProcessor, PortBatcher)):
        proc = Processor(image_token_id=5000, action_token_begin_idx=6000, image_seq_length=16,
                         image_size=56, statistics=jds.statistics, action_chunk_size=4)
        batches = Batcher(proc, batch_size=3, seq_len=96).batches(iter(frames))
        out.append(list(batches))
    assert len(out[0]) == len(out[1]) == 3
    for bt, bj in zip(out[1], out[0]):
        assert sorted(bt) == sorted(bj)
        for k in bj:
            np.testing.assert_array_equal(np.asarray(bt[k]), np.asarray(bj[k]), err_msg=k)


@pytest.mark.parametrize("name", ["__init__.py", "adapters.py", "driver.py"])
def test_eval_copies_match_their_originals(name):
    """eval/: the port's files are the JAX package's, byte for byte (their
    imports are relative, so the driver's ``..serve.ServingEngine`` is the
    port's engine); tests/test_torch_eval.py runs them."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = open(os.path.join(root, "spatialvla_tpu_torch", "eval", name)).read()
    assert port == open(os.path.join(root, "spatialvla_tpu", "eval", name)).read()
    assert "jax" not in port.replace("SimplerEnv", "")


def test_partitioning_rules_copy_matches():
    """The port's DEFAULT_RULES are JAX's (partitioning.py:23-54): the same
    patterns in the same order, each with the same axes (a PartitionSpec as
    a tuple)."""
    want = [(pattern, tuple(spec)) for pattern, spec in j_partitioning.DEFAULT_RULES]
    assert t_partitioning.DEFAULT_RULES == want
    assert len(want) == 25
