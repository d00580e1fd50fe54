"""Tensor-parallel serving in the port against the JAX package's shard() on the
CPU (the 8 virtual devices of tests/conftest.py), on the tiny reference-format
checkpoint that both packages load
(test_hf_checkpoint._build_reference_style_checkpoint), in fp32 compute as
tests/test_tp_serving.py runs it, and on seeded random weights with the depth
branch on:

* the specs: the port's param_pspecs(..., mesh=LocalMesh(model=n)) are JAX's
  for the bf16, int8, int4 and grouped int4 trees;
* the cut (TensorShards): every tree format joins back bit for bit at n = 2
  and 4; the fused qkv follows the heads (kv heads duplicated at n = 4, where
  the tiny config's 2 kv heads are fewer than the shards), gate|up is cut in
  pairs, grouped scales along their groups, biases with their columns or
  whole; the vocabulary (9218 ids) stays whole at n = 4; a KV state cuts
  over its kv heads and joins back; a block stays whole where the kernels'
  one shape rule (qmatmul_refusal) refuses its shard; one model shard
  computes bit for bit what the whole tree does;
* predict parity: ids identical to JAX's shard() and actions within 1e-5
  (the bf16 tree at n_model=4, the int8 tree at n_model=2, a padded batch of
  mixed lengths at n_model=2 x n_data=2, the depth branch at n_model=2);
* the engines: ServingEngine over shard(n_model=2) gives predict's ids;
  SplitServingEngine over shard(n_model=2) gives the ids of JAX's split
  engine under the same mesh, with the bf16 and the int8 tree and with
  kv_bits=8;
* the errors of JAX's shard(), quantize() after shard() and save_serving()
  on a sharded policy;
* sum_shards on one device: the fp32 sum of the parts in shard order;
  distinct devices that the machine lacks raise (the distinct-device branch
  runs on two cards in test_torch_cuda_kernels.py).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from spatialvla_tpu.config import spatialvla_tiny as j_spatialvla_tiny
from spatialvla_tpu.inference import SpatialVLAPolicy as JaxPolicy
from spatialvla_tpu.parallel.mesh import MeshConfig, make_mesh
from spatialvla_tpu.parallel.partitioning import param_pspecs as j_param_pspecs
from spatialvla_tpu.processor import SpatialVLAProcessor as JaxProcessor
from spatialvla_tpu_torch import SpatialVLAPolicy
from spatialvla_tpu_torch.config import spatialvla_tiny
from spatialvla_tpu_torch.convert import from_numpy_tree, to_numpy_tree
from spatialvla_tpu_torch.inference import default_processor
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.ops.quant import matvec_refusal, qmatmul_refusal, unpack_int4
from spatialvla_tpu_torch.parallel import LocalMesh, param_pspecs
from spatialvla_tpu_torch.parallel.mesh import sum_shards
from spatialvla_tpu_torch.parallel.partitioning import TensorShards
from spatialvla_tpu_torch.utils.tree import iter_leaves
from tests.test_hf_checkpoint import _build_reference_style_checkpoint

torch.set_num_threads(2)

UNNORM = "bridge_orig/1.0.0"
ATOL = 1e-5  # actions, fp32 compute: the shards' sums change only the order of fp32 additions
CFG = spatialvla_tiny(use_vision_zoe=True)
FORMATS = {
    "bf16": None,
    "int8": dict(bits=8),
    "int4": dict(bits=4, vision_bits=4),
    "int4_g8": dict(bits=4, group_size=8, vision_bits=4),
    "mixed": dict(bits=8, mlp_bits=4),
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_ckpt")
    _build_reference_style_checkpoint(d)
    return str(d)


def _widen(cfg):
    """A window that holds a split engine's cache (the tiny config's is 8)."""
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, sliding_window=4096))


def _pair(ckpt_dir, quant=None, widen=False):
    """The JAX and the port's policy from the checkpoint, fp32 compute."""
    jp = JaxPolicy.from_hf_checkpoint(ckpt_dir, param_dtype=None)
    tp = SpatialVLAPolicy.from_hf_checkpoint(ckpt_dir, device="cpu", param_dtype=None)
    jp.compute_dtype, tp.compute_dtype = jnp.float32, torch.float32
    for p in (jp, tp):
        if widen:
            p.config = _widen(p.config)
        if quant:
            p.quantize(**quant)
    return jp, tp


def _image(rng, size):
    return (rng.rand(size, size, 3) * 255).astype(np.uint8)


def _tiny_tree(quant):
    p = SpatialVLAPolicy.init_random(CFG, "cpu", seed=0)
    return (p.quantize(**quant) if quant else p).params


# ---------------------------------------------------------------------------
# the specs and the cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4", "int4_g8"])
def test_param_pspecs_match_jax(fmt, n):
    """The same tree (as numpy for JAX) gives the same specs, with the mesh's
    divisibility check on both sides."""
    tree = _tiny_tree(FORMATS[fmt])
    specs = param_pspecs(tree, mesh=LocalMesh(model=n))
    port = {}
    for path, _ in iter_leaves(tree):
        node = specs
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        port[path] = node
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, model=n))
    ref = jax.tree_util.tree_leaves_with_path(
        j_param_pspecs(to_numpy_tree(tree), mesh=mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
           for path, spec in ref}
    assert port == ref


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_cut_joins_back_bit_for_bit(fmt, n):
    tree = _tiny_tree(FORMATS[fmt])
    cut = TensorShards(tree, CFG, n)
    shards = [cut.cut_tree(tree, s) for s in range(n)]
    whole, back = dict(iter_leaves(tree)), dict(iter_leaves(cut.join_tree(shards)))
    assert whole.keys() == back.keys()
    for k, t in whole.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    for s in shards:  # every shard of a cut leaf is a contiguous copy
        for path in cut.cuts:
            leaf = dict(iter_leaves(s))[path]
            assert leaf.is_contiguous() and leaf.data_ptr() % 16 == 0, path
    assert cut.blocks["lm_attn"] and cut.blocks["vision_mlp"] and cut.blocks["projector"]
    assert cut.blocks["vocab"] == (n == 2)  # 9218 ids: whole at n = 4
    # the tiny config's 16 patches take the few-row kernels, which refuse an
    # int8 o shard of K = 32 / 4 = 8: the int8 vision attention stays whole
    int8_vision = fmt in ("int8", "mixed")
    assert cut.blocks["vision_attn"] == (n == 2 or not int8_vision)


@pytest.mark.parametrize("n", [2, 4])
def test_fused_qkv_follows_the_heads(n):
    """Shard s holds q heads [s Nq / n, (s + 1) Nq / n) and the kv heads they
    read: by heads at n = 2, the one kv head of its group at n = 4 (shards
    0 and 1 both hold kv head 0)."""
    tree = _tiny_tree(FORMATS["int8"])
    t = CFG.text
    D, Nq, Nkv = t.head_dim, t.num_heads, t.num_kv_heads
    cut = TensorShards(tree, CFG, n)
    qt = tree["lm"]["layers"]["attn"]["qkv"]["qt"]  # (L, (Nq + 2 Nkv) D, K)
    q, k, v = torch.split(qt, [Nq * D, Nkv * D, Nkv * D], dim=1)
    heads = lambda w, h: w.reshape(w.shape[0], -1, D, w.shape[-1])[:, h].flatten(1, 2)  # noqa
    want_kv = [0, 1] if n == 2 else [0, 0, 1, 1]
    for s in range(n):
        shard = cut.cut_tree(tree, s)["lm"]["layers"]["attn"]
        qs = list(range(s * Nq // n, (s + 1) * Nq // n))
        sq, sk, sv = torch.split(shard["qkv"]["qt"], [len(qs) * D, D, D], dim=1)
        assert torch.equal(sq, heads(q, qs))
        assert torch.equal(sk, heads(k, [want_kv[s]])) and torch.equal(sv, heads(v, [want_kv[s]]))
        assert cut.kv_index(s).tolist() == [want_kv[s]]
        # o: the rows of K that those q heads produce; per-channel scales whole
        o = tree["lm"]["layers"]["attn"]["o"]
        assert torch.equal(shard["o"]["qt"], o["qt"][..., qs[0] * D:(qs[-1] + 1) * D])
        assert shard["o"]["scale"] is o["scale"]


def test_gate_up_pairs_and_grouped_scales():
    """gate|up: shard s holds gate_s | up_s (an even cut would give shard 0
    all of gate); int4 down: the codes of its K rows, repacked, and grouped
    scales cut along G."""
    tree = _tiny_tree(FORMATS["int4_g8"])
    I = CFG.text.intermediate_size
    cut = TensorShards(tree, CFG, 2)
    gu, down = (tree["lm"]["layers"]["mlp"][k] for k in ("gate_up", "down"))
    for s in range(2):
        shard = cut.cut_tree(tree, s)["lm"]["layers"]["mlp"]
        rows = list(range(s * I // 2, (s + 1) * I // 2))
        want = torch.cat([gu["qt"][:, rows], gu["qt"][:, [I + r for r in rows]]], dim=1)
        assert torch.equal(shard["gate_up"]["qt"], want)
        G = down["scale"].shape[-1]
        assert torch.equal(shard["down"]["scale"], down["scale"][..., s * G // 2:(s + 1) * G // 2])
        codes = unpack_int4(down["qt"])[..., s * I // 2:(s + 1) * I // 2]
        assert torch.equal(unpack_int4(shard["down"]["qt"]), codes)


def test_biases_cut_with_their_columns_or_whole():
    """SigLIP q/k/v/fc1, the patch conv and the projector cut their biases
    with their columns; o / fc2 keep theirs whole (added once, after
    sum_shards); the LM norms and the Zoe / Ego3D trees are the same
    tensors in every shard."""
    tree = _tiny_tree(FORMATS["int8"])
    H = CFG.vision.hidden_size
    cut = TensorShards(tree, CFG, 2)
    s1 = cut.cut_tree(tree, 1)
    att, mlp = tree["vision"]["layers"]["attn"], tree["vision"]["layers"]["mlp"]
    assert torch.equal(s1["vision"]["layers"]["attn"]["q"]["b"], att["q"]["b"][:, H // 2:])
    I = CFG.vision.intermediate_size
    assert torch.equal(s1["vision"]["layers"]["mlp"]["fc1"]["b"], mlp["fc1"]["b"][:, I // 2:])
    assert s1["vision"]["layers"]["attn"]["o"]["b"] is att["o"]["b"]
    assert s1["vision"]["layers"]["mlp"]["fc2"]["b"] is mlp["fc2"]["b"]
    Ht = CFG.text.hidden_size
    assert torch.equal(s1["projector"]["b"], tree["projector"]["b"][Ht // 2:])
    assert torch.equal(s1["vision"]["patch_embed"]["b"], tree["vision"]["patch_embed"]["b"][H // 2:])
    assert s1["lm"]["layers"]["input_norm"] is tree["lm"]["layers"]["input_norm"]
    assert s1["zoe"] is not tree["zoe"]  # a new dict of the same tensors
    assert all(a is b for (_, a), (_, b) in zip(iter_leaves(s1["zoe"]), iter_leaves(tree["zoe"])))


def test_whole_blocks():
    """The vocabulary at n = 4 and a LoRA-factored leaf (which no rule names)
    keep their blocks whole: the leaves are the whole tree's."""
    tree = _tiny_tree(FORMATS["int8"])
    cut = TensorShards(tree, CFG, 4)
    assert not cut.blocks["vocab"]
    s3 = cut.cut_tree(tree, 3)
    assert s3["lm"]["embed"] is tree["lm"]["embed"]
    assert s3["lm"]["lm_head"]["qt"] is tree["lm"]["lm_head"]["qt"]
    lora = dict(tree)
    lora["lm"] = dict(tree["lm"], layers=dict(tree["lm"]["layers"]))
    mlp = dict(tree["lm"]["layers"]["mlp"])
    mlp["down"] = {"w": mlp["down"], "a": torch.zeros(4, 96, 2), "b": torch.zeros(4, 2, 48)}
    lora["lm"]["layers"]["mlp"] = mlp
    cut = TensorShards(lora, CFG, 2)
    assert cut.blocks["lm_attn"] and not cut.blocks["lm_mlp"]


@pytest.mark.parametrize("qt_dtype, K, G, rows, refused", [
    (torch.int8, 1024, 0, 1, False),  # the int8 o shard at n = 2, full width
    (torch.int8, 1076, 0, 1, True),  # SigLIP fc2's 4304 / 4: not a multiple of 16
    (torch.int8, 8, 0, 16, True),  # the tiny o shard at n = 4, 16 patches
    (torch.int8, 8, 0, 17, False),  # more rows than the kernel's: dequantized
    (torch.uint8, 1076, 0, 256, False),  # the int4 fc2 shard, per channel
    (torch.uint8, 1152, 9, 1, True),  # an odd group count splits K's halves
    (torch.uint8, 1152, 18, 1, False),
    (torch.uint8, 1152, 18, 513, False),  # above 512 rows: dequantized
])
def test_qmatmul_refusal_is_the_kernels_rule(qt_dtype, K, G, rows, refused):
    """The one shape rule of the few-row kernels (ops/quant.py), which the
    cut asks of a shard at the fewest rows its block's calls have."""
    assert bool(qmatmul_refusal(qt_dtype, K, G, rows)) == refused
    if rows <= (512 if qt_dtype == torch.uint8 else 16):
        assert matvec_refusal(qt_dtype, K, G, rows) == qmatmul_refusal(qt_dtype, K, G, rows)
    else:
        assert "rows" in matvec_refusal(qt_dtype, K, G, rows)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_one_model_shard_is_the_whole_tree(fmt):
    """shard(n_model=1) runs the layers' one loop over a group of one shard,
    as the whole tree does: ids and margins bit for bit (the CPU's unfused
    loop both ways)."""
    frame = (np.random.RandomState(3).rand(56, 56, 3) * 255).astype(np.uint8)
    whole = SpatialVLAPolicy.init_random(CFG, "cpu", seed=0)
    if FORMATS[fmt]:
        whole.quantize(**FORMATS[fmt])
    tp = SpatialVLAPolicy(whole.params, CFG, whole.processor, device="cpu").shard(n_model=1)
    inputs = whole.processor(frame, "pick up the cup")
    ids, margins = whole._generate(inputs, return_margins=True)
    tids, tmargins = tp._generate(inputs, return_margins=True)
    assert torch.equal(ids, tids) and torch.equal(margins, tmargins)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_kv_state_cuts_over_kv_heads(kv_bits):
    """A serving state's K / V (L, slots, Nkv, S, D) and int8 scales (L, Nkv,
    1, slots S) cut over kv heads, as JAX's split engine shards them (at
    n = 4 shards 0-1 and 2-3 hold kv heads 0 and 1); the rest of the state
    is the same tensors."""
    tree = _tiny_tree(FORMATS["int8"])
    state = tsv.init_serving_state(CFG, 3, 16, 12, kv_bits=kv_bits)
    gen = torch.Generator().manual_seed(0)
    for k in ("k", "v", "k_scale", "v_scale"):
        if k in state:
            state[k] = torch.randint(-9, 9, state[k].shape, generator=gen).to(state[k].dtype)
    for n, heads in ((2, [0, 1]), (4, [0, 0, 1, 1])):
        sharded = TensorShards(tree, CFG, n).cut_state(state, ["cpu"] * n)
        assert all(sharded[k] is state[k] for k in ("tok", "pos", "steps", "out"))
        assert len(sharded["shards"]) == n
        for shard, h in zip(sharded["shards"], heads):
            assert shard.keys() == ({"k", "v", "k_scale", "v_scale"} if kv_bits else {"k", "v"})
            for k, t in shard.items():
                dim = 1 if k.endswith("scale") else 2
                assert torch.equal(t, state[k].narrow(dim, h, 1)), k


# ---------------------------------------------------------------------------
# predict parity against JAX's shard()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt, n", [("bf16", 4), ("int8", 2)])
def test_predict_matches_jax_shard(ckpt_dir, fmt, n):
    quant = None if fmt == "bf16" else dict(bits=8, vision_bits=8)
    jp, tp = _pair(ckpt_dir, quant)
    jp.shard(n_model=n)
    tp.shard(n_model=n)
    assert tp.mesh.shape["model"] == n and tp.params.cut.blocks["lm_attn"]
    img = _image(np.random.RandomState(n), CFG.vision.image_size)
    a = tp.predict(img, "push the plate left", unnorm_key=UNNORM)
    b = jp.predict(img, "push the plate left", unnorm_key=UNNORM)
    np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    np.testing.assert_allclose(a["actions"], b["actions"], atol=ATOL, rtol=0)


def test_padded_batch_over_data_and_model(ckpt_dir):
    """A batch of mixed instruction lengths over n_model=2 x n_data=2: the
    rows split over the two data groups."""
    jp, tp = _pair(ckpt_dir)
    jp.shard(n_model=2, n_data=2)
    tp.shard(n_model=2, n_data=2)
    rng = np.random.RandomState(2)
    imgs = [_image(rng, CFG.vision.image_size) for _ in range(4)]
    instrs = ["go", "pick up the green cup", "push left", "stack the bowls"]
    a = tp.predict_batch(imgs, instrs, unnorm_key=UNNORM)
    b = jp.predict_batch(imgs, instrs, unnorm_key=UNNORM)
    np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    np.testing.assert_allclose(a["actions"], b["actions"], atol=ATOL, rtol=0)


def test_depth_branch_matches_jax_shard():
    """spatialvla_tiny(use_vision_zoe=True) on seeded weights through the
    weight bridge (the lm_head scaled so that greedy margins are not flat):
    ZoeDepth and Ego3D run once, on the group's device, beside the shards."""
    from spatialvla_tpu_torch.models import spatialvla as sv

    with torch.no_grad():
        params = to_numpy_tree(sv.init_params(CFG, generator=torch.Generator().manual_seed(0),
                                              device="cpu"))
    params["lm"]["lm_head"] = params["lm"]["lm_head"] * 50.0
    jcfg = j_spatialvla_tiny(use_vision_zoe=True)
    proc = default_processor(CFG)
    j_proc = JaxProcessor(image_token_id=CFG.image_token_index,
                          action_token_begin_idx=CFG.action_token_begin_idx,
                          image_seq_length=CFG.num_image_tokens,
                          image_size=CFG.vision.image_size, statistics=proc.statistics)
    jp = JaxPolicy(jax.tree_util.tree_map(jnp.asarray, params), jcfg, j_proc,
                   compute_dtype=jnp.float32).shard(n_model=2)
    tp = SpatialVLAPolicy(from_numpy_tree(params), CFG, proc, device="cpu",
                          compute_dtype=torch.float32).shard(n_model=2)
    img = _image(np.random.RandomState(7), CFG.vision.image_size)
    a = tp.predict(img, "pick up the cup", return_margins=True)
    b = jp.predict(img, "pick up the cup", return_margins=True)
    np.testing.assert_array_equal(a["action_ids"], b["action_ids"])
    np.testing.assert_allclose(a["actions"], b["actions"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(a["margins"], b["margins"], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the engines over a sharded policy
# ---------------------------------------------------------------------------

# two prompt lengths (33 and 37 tokens) in one 16-token bucket: one prefill
# program a JAX engine
INSTRS = ["pick up the cup", "push the plate left", "stack the bowls"]
ENGINE_KW = dict(n_slots=4, max_prompt_len=64, prompt_pad_multiple=16, decode_block=1)


def test_serving_engine_over_a_sharded_policy(ckpt_dir):
    from spatialvla_tpu_torch.serve import ServingEngine

    _, tp = _pair(ckpt_dir, dict(bits=8, vision_bits=8))
    tp.shard(n_model=2)
    img = _image(np.random.RandomState(3), CFG.vision.image_size)
    refs = [tp.predict(img, s, unnorm_key=UNNORM) for s in INSTRS]
    assert len(tp.decode_graphs) == 0
    with ServingEngine(tp, max_batch_size=4, batch_buckets=(1, 2, 4)) as eng:
        futs = [eng.submit(img, s, unnorm_key=UNNORM) for s in INSTRS]
        outs = [f.result(timeout=120) for f in futs]
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o["action_ids"], r["action_ids"])
        np.testing.assert_allclose(o["actions"], r["actions"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant, kv_bits", [("bf16", None), ("int8", None), ("int8", 8)])
def test_split_engine_under_a_mesh_matches_jax(ckpt_dir, quant, kv_bits):
    """SplitServingEngine over shard(n_model=2), the KV state cut over kv
    heads and the decode step xla_decode_step over each shard's heads,
    against JAX's split engine under the same mesh: ids identical."""
    from spatialvla_tpu.serve.split_engine import SplitServingEngine as JaxSplit
    from spatialvla_tpu_torch.serve import SplitServingEngine

    jp, tp = _pair(ckpt_dir, None if quant == "bf16" else dict(bits=8, vision_bits=8),
                   widen=True)
    jp.shard(n_model=2)
    tp.shard(n_model=2)
    img = _image(np.random.RandomState(5), CFG.vision.image_size)
    with SplitServingEngine(tp, kv_bits=kv_bits, **ENGINE_KW) as eng:
        shards = eng._programs.loop.state["shards"]
        assert len(shards) == 2 and shards[0]["k"].shape[2] == 1
        assert shards[0]["k"].dtype == (torch.int8 if kv_bits else torch.bfloat16)
        outs = [eng.predict(img, s, unnorm_key=UNNORM) for s in INSTRS]
    with JaxSplit(jp, kv_bits=kv_bits, **ENGINE_KW) as eng:
        refs = [eng.predict(img, s, unnorm_key=UNNORM) for s in INSTRS]
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o["action_ids"], r["action_ids"])


# ---------------------------------------------------------------------------
# the errors, and sum_shards
# ---------------------------------------------------------------------------

def _first_clause(msg: str) -> str:
    """A message up to its first dash or colon (JAX writes a dash, the port
    a colon)."""
    return msg.split(" —")[0].split(":")[0].strip()


@pytest.mark.parametrize("case", ["kv_bits", "quantize_after_shard", "save_serving"])
def test_rejections_are_jaxs(ckpt_dir, case, tmp_path):
    """JAX's three rejections, in JAX's words. (JAX's save_serving imports its
    Orbax layer before it looks at the mesh, seconds of imports: its message
    is JAX's inference.py:251-252.)"""
    jp, tp = _pair(ckpt_dir, dict(bits=8, kv_bits=8) if case == "kv_bits" else None)
    errors = []
    for p in (tp,) if case == "save_serving" else (tp, jp):
        with pytest.raises(ValueError) as e:
            if case == "kv_bits":
                p.shard(n_model=2)
            elif case == "quantize_after_shard":
                p.shard(n_model=2).quantize(bits=8)
            else:
                p.shard(n_model=2).save_serving(str(tmp_path))
        errors.append(_first_clause(str(e.value)))
    if case == "save_serving":
        errors.append("save_serving() on a sharded policy is unsupported")
    assert errors[0] == errors[1]
    assert {"kv_bits": "kv_bits", "quantize_after_shard": "quantize() after shard()",
            "save_serving": "save_serving() on a sharded policy"}[case] in errors[0]


def test_sum_shards_on_one_device():
    """The fp32 sum of the parts in shard order, cast back to their dtype,
    handed to every shard."""
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 257, generator=gen).to(torch.bfloat16) for _ in range(4)]
    out = sum_shards(parts)
    want = ((parts[0].float() + parts[1].float()) + parts[2].float()) + parts[3].float()
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], want.to(torch.bfloat16))


def test_distinct_devices_a_machine_lacks_raise():
    with pytest.raises(RuntimeError, match="CUDA device"):
        LocalMesh(model=2, devices=("cuda:0", "cuda:1"))
    with pytest.raises(ValueError, match="share one device or take one device each"):
        LocalMesh(model=4, devices=("cpu", "cpu", "cuda:0", "cuda:1"))
    with pytest.raises(ValueError, match="devices for a data=1 x model=2 mesh"):
        LocalMesh(model=2, devices=("cpu",))


# ---------------------------------------------------------------------------
# the front ends' mesh flags
# ---------------------------------------------------------------------------

def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_serve_torch_over_a_mesh():
    """--mesh_model 2 --split --kv_bits 8: the split engine takes the int8
    cache over the sharded policy, its ids held to the sharded predict
    (--parity_check); --kv_bits without --split is refused, as JAX's
    bench_serve.py refuses it."""
    bench = _script("bench_serve_torch")
    result = bench.main(["--tiny", "--device", "cpu", "--clients", "2", "--requests", "1",
                         "--n_slots", "2", "--mesh_model", "2", "--split", "--kv_bits", "8",
                         "--parity_check"])
    assert "int8 kv, split-phase, mesh model=2 data=1" in result["metric"]
    assert result["requests"] == 2 and result["parity"]["ok"]
    with pytest.raises(SystemExit):
        bench.main(["--tiny", "--device", "cpu", "--mesh_model", "2", "--kv_bits", "8"])


@pytest.mark.parametrize("split", [True, False])
def test_serve_torch_moves_a_baked_kv_bits_under_a_mesh(tmp_path, split):
    """serve_torch.py's load_policy under --mesh_model 2 (JAX's rules,
    scripts/serve.py:201-250): a serving checkpoint's baked kv_bits moves to
    the split engine, or is cleared for the monolithic one; the policy comes
    back sharded. A quantized HF load with --kv_bits and no --split exits."""
    import argparse

    serve = _script("serve_torch")
    wide = _widen(CFG)
    SpatialVLAPolicy.init_random(wide, "cpu", seed=0).quantize(bits=8, kv_bits=8).save_serving(
        str(tmp_path / "serving"))
    flags = dict(serving=str(tmp_path / "serving"), hf=None, ckpt=None, bits=8, vision_bits=8,
                 mlp_bits=0, kv_bits=0, depth_res=0, group_size=0, device="cpu", split=split,
                 mesh_model=2, mesh_data=1)
    args = argparse.Namespace(**flags)
    policy = serve.load_policy(args)
    assert policy.mesh.shape["model"] == 2 and policy.kv_bits is None
    assert args.kv_bits == (8 if split else 0)
    with pytest.raises(SystemExit, match="needs --split"):
        serve.load_policy(argparse.Namespace(**dict(flags, serving=None, hf="unused",
                                                    kv_bits=8, split=False)))
