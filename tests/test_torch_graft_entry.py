"""graft_entry_torch.py, the port's entry points, against
__graft_entry__.py on the CPU:

* ``_example_batch`` gives __graft_entry__._example_batch's arrays, value for
  value, at the flagship's and the tiny config;
* the entry step at the tiny width (spatialvla_tiny(use_vision_zoe=True),
  fp32) equals JAX's spatialvla.forward on the same weights (the numpy
  bridge): loss within 1e-5 and logits within 1e-4 absolute (fp32, the
  same function in another summation order); ``entry()`` raises with no
  card;
* ``dryrun_multichip(4, "cpu")`` and ``dryrun_multichip(8, "cpu")`` print the
  JAX surface's lines in its order and end: the training meshes as gloo
  ranks (finite losses), the serving half (ids (2, 6) in the action
  block), the flagship's state cut and its loss and gradients on meta;
* chip_smoke's entry_surfaces phase, rehearsed on the CPU at the tiny size
  (entry step, the serving half, the headline's profiled stages);
* the cut of the full spatialvla_4b() train state over each of the three
  meshes of the JAX surface's ahead-of-time compiles is exact; the pipe
  stages are JAX's partition of the 13 layer pairs; T=2048 cuts into sp
  halves; the flash wrappers take their plain versions on meta;
* ``entry()`` and ``dryrun_multichip(n)`` raise with no card unless the
  caller passes ``device="cpu"``.
"""
import re
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import __graft_entry__ as jentry
import graft_entry_torch as tentry
from spatialvla_tpu.config import spatialvla_4b as j_4b
from spatialvla_tpu.config import spatialvla_tiny as j_tiny
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu_torch.config import spatialvla_4b, spatialvla_tiny
from spatialvla_tpu_torch.convert import from_numpy_tree

torch.set_num_threads(2)

LOSS_ATOL = 1e-5
LOGITS_ATOL = 1e-4


@pytest.mark.parametrize("configs", [(j_4b, spatialvla_4b), (j_tiny, spatialvla_tiny)],
                         ids=["spatialvla_4b", "spatialvla_tiny"])
def test_example_batch_equals_jax(configs):
    jcfg, tcfg = (c() for c in configs)
    want = jentry._example_batch(jcfg)
    got = tentry._example_batch(tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_entry_step_matches_jax_at_tiny_width():
    jcfg, tcfg = j_tiny(use_vision_zoe=True), spatialvla_tiny(use_vision_zoe=True)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jsv.init_params(key, jcfg))(jax.random.PRNGKey(0)))
    fn, (init, batch) = tentry.entry_for(tcfg, device="cpu", dtype=torch.float32,
                                         compute_dtype=torch.float32)
    # the entry's own weights are the seeded init's, of the JAX tree's shapes
    assert {k: tuple(v.shape) for k, v in from_numpy_tree(params)["lm"].items()
            if torch.is_tensor(v)} == {k: tuple(v.shape) for k, v in init["lm"].items()
                                       if torch.is_tensor(v)}
    with torch.inference_mode():
        loss, logits = fn(from_numpy_tree(params), batch)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    out = jax.jit(lambda p, b: jsv.forward(
        p, jcfg, b["input_ids"], pixel_values=b["pixel_values"], intrinsic=b["intrinsic"],
        attention_mask=b["attention_mask"], token_type_ids=b["token_type_ids"],
        labels=b["labels"], compute_dtype=jnp.float32))(params, jb)
    assert tuple(logits.shape) == out["logits"].shape
    assert abs(float(loss) - float(out["loss"])) < LOSS_ATOL
    np.testing.assert_allclose(logits.numpy(), np.asarray(out["logits"]), atol=LOGITS_ATOL,
                               rtol=0)


def test_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(8)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_the_cpu(n, capsys):
    t0 = time.perf_counter()
    out = tentry.dryrun_multichip(n, device="cpu")
    seconds = time.perf_counter() - t0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("dryrun_multichip")]
    mesh = "(1,2,2)" if n == 4 else "(2,2,2)"
    want = [rf"mesh={re.escape(mesh)} loss=\d+\.\d{{4}} ok \(tiny executed\)"]
    if n == 8:
        want += [r"mesh=\(data=2,fsdp=2,pipe=2\) loss=\d+\.\d{4} ok \(tiny pp executed\)",
                 r"mesh=\(data=2,sp=4\) loss=\d+\.\d{4} ok \(tiny sp executed\)"]
    want += [r"mesh=\(data=2,model=2\) int8 TP serving ok \(tiny tp-serving executed\)",
             r"mesh=\(data=2,model=2\) split-phase TP serving ok",
             rf"spatialvla_4b \(4\.03B params\) mesh={re.escape(mesh)} full-pretrain state cut "
             r"exact .* on meta ok \(4b cut\)"]
    if n == 8:
        want += [r"spatialvla_4b pipe=2 stages of \[14, 12\] layers \(7\+6",
                 r"spatialvla_4b \(4\.03B params\) mesh=\(data=2,fsdp=2,pipe=2\) .*\(4b cut\)",
                 r"spatialvla_4b T=2048 over sp=2: \[\(0, 1024\), \(1024, 2048\)\]",
                 r"spatialvla_4b \(4\.03B params\) mesh=\(data=2,fsdp=2,sp=2\) T=2048 .*"
                 r"\(4b cut\)"]
    assert len(lines) == len(want), lines
    for line, pattern in zip(lines, want):
        assert re.search(pattern, line), (pattern, line)
    assert all(np.isfinite(v) for v in out["losses"].values())
    begin, n_act = spatialvla_tiny().action_token_begin_idx, spatialvla_tiny().spatial_token_num
    for key in ("tp_serving_ids", "split_tp_serving_ids"):
        ids = np.asarray(out[key])
        assert ids.shape == (2, 6) and ((ids >= begin) & (ids < begin + n_act)).all()
    for check in out["flagship"].values():
        assert check["meta_step"]["loss"] == () and check["meta_step"]["grads"] > 40
    print(f"dryrun_multichip({n}) took {seconds:.1f} s")


@pytest.mark.parametrize("shape", [(2, 2, 2, 1, 1), (2, 2, 1, 1, 2), (2, 2, 1, 2, 1)],
                         ids=["data2-fsdp2-model2", "data2-fsdp2-pipe2", "data2-fsdp2-sp2"])
def test_flagship_state_cut_is_exact_on_meta(shape):
    cut = tentry.cut_flagship_state(shape)
    model, fsdp = shape[2], shape[1]
    # every fp32 master, and both AdamW moments of each trainable leaf (the
    # LM embedding and ZoeDepth are frozen)
    assert cut["params"] == 4_027_850_123
    assert 2 * 4 * cut["params"] < cut["state_bytes"] < 3 * 4 * cut["params"]
    assert (cut["model_cut"] > 0) == (model > 1) and cut["fsdp_cut"] > 0
    # a rank holds no more than its share plus the leaves kept whole
    assert cut["rank_bytes"] < cut["state_bytes"] / (model * fsdp) * 1.2 + 1.5e9


def test_flagship_pipe_stages_and_sequence_shards_are_jax_partitions():
    L = spatialvla_4b().text.num_layers
    # JAX's forward_pipeline: the balanced partition of the layer pairs
    base, rem = divmod(L // 2, 2)
    counts = [2 * (base + (s < rem)) for s in range(2)]
    stages = tentry.flagship_stages(2)
    assert [len(s) for s in stages] == counts == [14, 12]
    assert sum(stages, []) == list(range(L))
    assert tentry.flagship_seq_shards(2048, 2) == [(0, 1024), (1024, 2048)]


def test_flash_wrappers_take_their_plain_versions_on_meta():
    from spatialvla_tpu_torch.ops import flash_attention as fa

    B, T, Nq, Nkv, D = 4, 1024, 8, 4, 256
    q = torch.empty((B, T, Nq, D), dtype=torch.bfloat16, device="meta")
    k = v = torch.empty((B, T, Nkv, D), dtype=torch.bfloat16, device="meta")
    lens = torch.full((B,), T, dtype=torch.int32, device="meta")
    zero = torch.zeros((B,), dtype=torch.int32, device="meta")
    before = [w.launches for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    kw = dict(scale=D ** -0.5, logit_softcap=50.0, window=4096)
    out, lse = fa.flash_attention_fwd(q, k, v, zero, lens, zero, **kw)
    assert out.device.type == "meta" and out.shape == q.shape and lse.shape == (B, Nq, T, 1)
    delta = torch.empty((B, Nq, T), dtype=torch.float32, device="meta")
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, delta, zero, lens, zero, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, delta, zero, lens, zero, **kw)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert [w.launches for w in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == before


def test_chip_smoke_entry_surfaces_rehearsed_on_the_cpu(capsys):
    import chip_smoke

    out = chip_smoke.entry_surfaces(torch, [], cfg=spatialvla_tiny(use_vision_zoe=True),
                                     device="cpu", profile_iters=1)
    assert out["entry"]["rel"] < chip_smoke.LOSS_BOUND
    assert out["entry"]["logits_shape"][:2] == [1, spatialvla_tiny().num_image_tokens + 22]
    for key in ("tp_serving", "split_tp_serving"):
        assert np.asarray(out[key]["ids"]).shape == (2, 6)
    assert list(out["profile_front"]["stages"]) == ["full_predict", "zoe_depth", "siglip",
                                                    "image_features", "prefill"]
    assert "entry surfaces: the phase" in capsys.readouterr().out
