"""The port's parallel package (spatialvla_tpu_torch/parallel) and the
models' ring and pipeline forwards against the JAX package on the CPU, in
one process: the mesh arithmetic, the partitioning specs, ring attention
and the GPipe pipeline over the one-process transports (``LocalMesh``).
The process-group transports and the sharded train steps are in
test_torch_distributed.py.

Tolerances are the JAX tests': ring forward atol = rtol = 2e-5, its
gradients atol 5e-5 / rtol 5e-4 (test_ring_attention.py:56-57, 88-89),
compared on the query rows with at least one allowed key (the port's plain
flash versions and JAX's reference define the others differently,
ops/flash_attention.py); pipeline_apply 1e-6 and gradients 1e-4
(test_pp_train.py:57, 63); the decoder forwards atol 2e-5 / rtol 1e-5
against JAX's XLA forward (test_torch_train.py's forward tolerance).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JaxMesh

from spatialvla_tpu.config import spatialvla_tiny
from spatialvla_tpu.models import gemma2 as jg2
from spatialvla_tpu.models import spatialvla as jsv
from spatialvla_tpu.ops.flash_attention import _attention_reference
from spatialvla_tpu.ops.quant import quantize_lm_params as j_qlm
from spatialvla_tpu.parallel import mesh as jmesh
from spatialvla_tpu.parallel import partitioning as jpart
from spatialvla_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from spatialvla_tpu.parallel.ring_attention import ring_flash_attention as j_ring
from spatialvla_tpu_torch.convert import from_numpy_tree
from spatialvla_tpu_torch.models import gemma2 as tg2
from spatialvla_tpu_torch.models import spatialvla as tsv
from spatialvla_tpu_torch.ops.flash_attention import allowed_rows
from spatialvla_tpu_torch.ops.quant import quantize_lm_params as t_qlm
from spatialvla_tpu_torch.parallel import (LocalMesh, MeshConfig, param_pspecs, pipeline_apply,
                                           ring_flash_attention)
from spatialvla_tpu_torch.parallel.pipeline import LocalPipe
from spatialvla_tpu_torch.parallel.ring_attention import LocalRing

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

RESOLVE_CASES = [  # (data, fsdp, model, sp, pipe), devices
    ((1, -1, 1, 1, 1), 8), ((2, -1, 1, 1, 1), 8), ((1, -1, 2, 2, 1), 8),
    ((1, 1, 1, 4, 2), 8), ((2, 2, 1, 1, 2), 8), ((-1, 1, 1, 1, 1), 4),
    ((1, -1, 1, 1, 1), 1), ((2, 2, 1, 1, 1), 6), ((4, 2, 1, 1, 1), 4),
    ((1, 1, 1, 2, 1), 1),
]


@pytest.mark.parametrize("dims, n", RESOLVE_CASES, ids=[f"{d}-{n}" for d, n in RESOLVE_CASES])
def test_mesh_config_resolve_matches_jax(dims, n):
    try:
        want = jmesh.MeshConfig(*dims).resolve(n)
    except AssertionError:
        with pytest.raises(ValueError, match="needs more than"):
            MeshConfig(*dims).resolve(n)
        return
    assert MeshConfig(*dims).resolve(n) == want


_LAUNCH_ENV = ("SPATIALVLA_COORDINATOR", "SPATIALVLA_NUM_PROCESSES", "SPATIALVLA_PROCESS_ID",
               "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
               "SLURM_PROCID", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for key in _LAUNCH_ENV:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_initialize_distributed_resolves_as_jax_does(no_launcher):
    """No flags and no launcher: one process and no group (mesh.py:95-96);
    a launcher's size without an address raises; explicit flags on cuda
    without a card raise before any rendezvous; make_mesh needs a group."""
    from spatialvla_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(device_type="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    no_launcher.setenv("SLURM_NTASKS", "2")
    no_launcher.setenv("SLURM_PROCID", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        initialize_distributed(device_type="cpu")
    no_launcher.delenv("SLURM_NTASKS")
    no_launcher.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        initialize_distributed("localhost:1", 2, 0)
    no_launcher.setenv("SPATIALVLA_COORDINATOR", "localhost:1")
    no_launcher.setenv("SPATIALVLA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="--process_id"):
        initialize_distributed(device_type="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(MeshConfig(), "cpu")


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """path -> spec as a tuple, for JAX's PartitionSpecs and the port's tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.fixture(scope="module")
def bf16_tree():
    cfg = spatialvla_tiny(use_vision_zoe=True)
    init = jax.jit(lambda key: jsv.init_params(key, cfg, dtype=jnp.bfloat16))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


MESHES = [None, (1, 2, 1, 1, 1), (1, 2, 2, 1, 1), (1, 3, 1, 1, 1), (1, 1, 3, 1, 1)]
QUANT = [None, dict(bits=8), dict(bits=4), dict(bits=4, group_size=8)]


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("quant", QUANT, ids=["bf16", "int8", "int4", "int4-g8"])
def test_param_pspecs_match_jax(bf16_tree, shape, quant):
    """Specs as tuples, on the same tiny tree in bf16 and after each
    package's own quantize; model = 3 and fsdp = 3 divide some dims and not
    others (the vocabulary 9218, int4's packed K / 2), so _divisible drops
    those axes."""
    jtree, ttree = dict(bf16_tree), from_numpy_tree(bf16_tree)
    if quant is not None:
        jtree["lm"] = j_qlm(jtree["lm"], **quant)
        ttree["lm"] = t_qlm(ttree["lm"], **quant)
    jm = None if shape is None else JaxMesh(
        np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), jmesh.AXES)
    want = _flat(jpart.param_pspecs(jtree, mesh=jm))
    got = _flat(param_pspecs(ttree, mesh=None if shape is None else dict(zip(jmesh.AXES, shape))))
    assert got == want
    if shape == (1, 1, 3, 1, 1):  # the vocabulary is not a multiple of 3
        assert got["lm/embed"] == (None, "fsdp")


# ---------------------------------------------------------------------------
# ring attention, one process
# ---------------------------------------------------------------------------

B, T, NQ, NKV, D = 2, 32, 4, 2, 8
SCALE = D ** -0.5
RING_CASES = [  # (name, prefix, valid, window, causal): test_ring_attention.py:30-37
    ("causal", [0, 0], [T, T], None, True),
    ("prefix_lm", [10, 7], [T, T], None, True),
    ("padded", [9, 0], [T - 5, T - 11], None, True),
    ("window", [0, 0], [T, T], 9, True),
    ("prefix_window_pad", [6, 11], [T - 3, T], 13, True),
    ("bidirectional", [0, 0], [T, T - 7], None, False),
]


def _ring_inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, NQ, D).astype(np.float32)
    k = rng.randn(B, T, NKV, D).astype(np.float32)
    v = rng.randn(B, T, NKV, D).astype(np.float32)
    co = rng.randn(B, T, NQ, D).astype(np.float32)
    return q, k, v, co


def _port_ring(q, k, v, co, prefix, valid, window, causal, n):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_flash_attention(tq, tk, tv, torch.tensor(prefix), torch.tensor(valid),
                               mesh=LocalMesh(sp=n), scale=SCALE, logit_softcap=50.0,
                               window=window, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (tq, tk, tv))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _rows(prefix, valid, window, causal):
    z = torch.zeros(B, dtype=torch.int32)
    rows = allowed_rows(torch.tensor(prefix), torch.tensor(valid), z, T, T, window=window,
                        causal=causal)
    return rows.expand(B, T).numpy()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name, prefix, valid, window, causal", RING_CASES,
                         ids=[c[0] for c in RING_CASES])
def test_ring_matches_reference(n, name, prefix, valid, window, causal):
    """Forward and gradients through n shards held by one process against
    JAX's dense oracle; the cotangent is zero on rows with no allowed key,
    whose output the oracle defines differently."""
    rows = _rows(prefix, valid, window, causal)
    q, k, v, co = _ring_inputs(0)
    co = co * rows[..., None, None]
    got, got_g = _port_ring(q, k, v, co, prefix, valid, window, causal, n)

    def ref(q, k, v):
        return _attention_reference(q, k, v, jnp.asarray(prefix, jnp.int32),
                                    jnp.asarray(valid, jnp.int32), jnp.zeros(B, jnp.int32),
                                    scale=SCALE, logit_softcap=50.0, window=window,
                                    causal=causal)

    want = np.asarray(ref(q, k, v))
    want_g = jax.grad(lambda *a: jnp.sum(ref(*a) * co), argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5, rtol=2e-5)
    for a, b, tag in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4, err_msg=f"d{tag}")


def test_ring_matches_jax_ring_in_interpret_mode():
    """One case against JAX's own ring (its Pallas kernels in interpret mode
    on two virtual devices), forward and gradients: the merge and the
    shifted offsets as JAX computes them."""
    name, prefix, valid, window, causal = RING_CASES[4]
    rows = _rows(prefix, valid, window, causal)
    q, k, v, co = _ring_inputs(3)
    co = co * rows[..., None, None]
    got, got_g = _port_ring(q, k, v, co, prefix, valid, window, causal, 2)
    jm = JaxMesh(np.asarray(jax.devices()[:2]), ("sp",))

    def ring(q, k, v):
        return j_ring(q, k, v, jnp.asarray(prefix, jnp.int32), jnp.asarray(valid, jnp.int32),
                      mesh=jm, scale=SCALE, logit_softcap=50.0, window=window, causal=causal,
                      interpret=True)

    want = np.asarray(ring(q, k, v))
    want_g = jax.grad(lambda *a: jnp.sum(ring(*a) * co), argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5, rtol=2e-5)
    for a, b, tag in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=5e-4, err_msg=f"d{tag}")


def test_local_transports_rotate_and_hand_off():
    """The one-process ring moves slot j to j + 1; the pipe hands stage s's
    output to s + 1 and its gradient back to s - 1."""
    assert LocalRing(3).rotate([("a",), ("b",), ("c",)]) == [("c",), ("a",), ("b",)]
    pipe = LocalPipe(3)
    assert pipe.forward_hand_off({0: "x", 2: "y"}, 0, None) == {1: "x"}
    assert pipe.backward_hand_off({0: "x", 2: "y"}, 0, None) == {1: "y"}


# ---------------------------------------------------------------------------
# the pipeline, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 4])
def test_pipeline_apply_matches_jax(m):
    """S = 2 stages of a plain stage function (no kernel) against JAX's
    pipeline_apply on two virtual devices: output and gradients."""
    S, Bp, Tp, H = 2, 8, 6, 16
    rng = np.random.RandomState(0)
    w = (rng.randn(S, H, H) * 0.3).astype(np.float32)
    x = rng.randn(Bp, Tp, H).astype(np.float32)
    scale = (rng.rand(Bp) + 0.5).astype(np.float32)
    jm = JaxMesh(np.asarray(jax.devices()[:S]).reshape(1, 1, 1, 1, S), jmesh.AXES)

    def j_fn(w_s, h, aux):
        return jnp.tanh(h @ w_s) * aux["scale"][:, None, None]

    def j_loss(w, x):
        y = j_pipeline_apply(j_fn, w, x, {"scale": jnp.asarray(scale)}, mesh=jm,
                             n_microbatches=m)
        return jnp.sum(y ** 2), y

    (_, want), want_g = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(w, x)

    tw = [torch.from_numpy(w[s]).requires_grad_() for s in range(S)]
    tx = torch.from_numpy(x).requires_grad_()
    got = pipeline_apply(lambda w_s, h, aux: torch.tanh(h @ w_s) * aux["scale"][:, None, None],
                         tw, tx, {"scale": torch.from_numpy(scale)}, mesh=LocalMesh(pipe=S),
                         n_microbatches=m)
    gx, *gw = torch.autograd.grad((got ** 2).sum(), [tx] + tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(torch.stack(gw).numpy(), np.asarray(want_g[0]), atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_g[1]), atol=1e-4)


# ---------------------------------------------------------------------------
# the decoder's ring and pipeline forwards
# ---------------------------------------------------------------------------

G_CFG = dataclasses.replace(spatialvla_tiny().text, num_layers=10, vocab_size=64)


@pytest.fixture(scope="module")
def decoder():
    """A 10-layer (5-pair) tiny decoder, inputs with a prefix and padding,
    and JAX's XLA forward on them."""
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jg2.init_params(key, G_CFG))(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)
    Bd, Td = 4, 16
    x = rng.randn(Bd, Td, G_CFG.hidden_size).astype(np.float32)
    prefix = np.array([5, 0, 9, 16], np.int32)
    valid = np.array([16, 13, 16, 11], np.int32)
    am = (np.arange(Td)[None] < valid[:, None]).astype(np.int32)
    pos = np.cumsum(am, axis=1).astype(np.int32)
    k, q = np.arange(Td)[None, None], np.arange(Td)[None, :, None]
    mask = (k < valid[:, None, None]) & ((k <= q) | (k < prefix[:, None, None]))
    want, _ = jax.jit(lambda p, x: jg2.forward(p, G_CFG, x, pos, jnp.asarray(mask[:, None])))(
        params, x)
    return params, x, pos, prefix, valid, np.asarray(want)


def _valid_rows_of(valid, Td):
    return np.arange(Td)[None] < valid[:, None]


@pytest.mark.parametrize("S", [2, 3])
def test_forward_pipeline_matches_jax_forward(decoder, S):
    """5 pairs over S stages (3+2 at S=2, 2+2+1 at S=3: uneven stages), the
    default microbatches, remat on: the valid rows equal JAX's forward."""
    params, x, pos, prefix, valid, want = decoder
    got = tg2.forward_pipeline(from_numpy_tree(params), G_CFG, torch.from_numpy(x),
                               torch.from_numpy(pos), torch.from_numpy(prefix),
                               torch.from_numpy(valid), mesh=LocalMesh(pipe=S), use_remat=True)
    rows = _valid_rows_of(valid, x.shape[1])
    np.testing.assert_allclose(got.detach().numpy()[rows], want[rows], atol=2e-5, rtol=1e-5)
    assert tg2.stage_pairs(13, 2) == [(0, 7), (7, 13)]
    assert [b - a for a, b in tg2.stage_pairs(13, 4)] == [4, 3, 3, 3]


def test_forward_ring_matches_jax_forward(decoder):
    params, x, pos, prefix, valid, want = decoder
    got = tg2.forward_ring(from_numpy_tree(params), G_CFG, torch.from_numpy(x),
                           torch.from_numpy(pos), torch.from_numpy(prefix),
                           torch.from_numpy(valid), mesh=LocalMesh(sp=2), use_remat=True)
    rows = _valid_rows_of(valid, x.shape[1])
    np.testing.assert_allclose(got.detach().numpy()[rows], want[rows], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", ["ring", "pipeline"])
def test_spatialvla_forward_backend_needs_a_mesh(backend):
    """JAX's ValueError (spatialvla.py:241-250) without a mesh."""
    cfg = spatialvla_tiny(use_vision_zoe=False)
    with pytest.raises(ValueError, match=f"attn_backend='{backend}' requires a mesh"):
        tsv.forward({}, cfg, torch.zeros((1, 4), dtype=torch.long), attn_backend=backend)
