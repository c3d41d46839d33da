"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's on the production meshes (``AbstractMesh``, no
devices): for every registry arch and both meshes, each parameter leaf's
spec and shard shape (training and serving layouts), the AdamW moments',
the decode caches' at ``decode_32k`` and ``long_500k`` and the batches';
the mesh helpers; ``constrain``; and ``moe_block`` routing G > 1
data-parallel groups against the reference's grouped dispatch."""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

import repro.models.moe as RM
from repro.configs import base as rbase
from repro.configs.registry import all_lm_configs as r_configs
from repro.distributed import sharding as RSH
from repro.models import transformer as RT
from repro.optim import adamw as radamw
from repro.serve import kvcache as RKC
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import all_lm_configs as t_configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve import kvcache as KC


def _jmesh(sizes, names):
    """jax changed AbstractMesh's signature across versions."""
    try:
        return JAbstractMesh(tuple(zip(names, sizes)))
    except TypeError:
        return JAbstractMesh(sizes, names)


MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(r_configs())


def _dotted(path) -> str:
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
        else:
            out.append(str(k))
    return ".".join(out)


def _ref_table(shardings, shapes) -> dict:
    """{dotted path: (spec, shard shape)} of a reference sharding tree."""
    flat_s = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_x = jax.tree.leaves(shapes)
    out = {}
    for (path, sh), leaf in zip(flat_s, flat_x):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out[_dotted(path)] = (spec, tuple(sh.shard_shape(leaf.shape)))
    return out


def _port_table(shardings, t) -> dict:
    out = {}
    for (path, leaf), sh in zip(tree.flatten_with_paths(t),
                                tree.leaves(shardings)):
        out[path] = (sh.spec, sh.shard_shape(leaf.shape))
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = r_configs()[arch]
    return jax.eval_shape(lambda: RT.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str):
    return T.init_params(t_configs()[arch], 0, device="meta")


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh, serve):
    """Every parameter leaf: the reference's spec and shard shape.  The
    port's tied models also carry ``embed_t``, which takes an untied
    head's layout (``head``: vocab over model, d over data)."""
    rcfg, tcfg = r_configs()[arch], t_configs()[arch]
    rmesh, tmesh = _jmesh(*MESHES[mesh]), SH.AbstractMesh(*MESHES[mesh])
    rshapes = _ref_params(arch)
    want = _ref_table(RSH.param_shardings(rcfg, rshapes, rmesh, serve=serve),
                      rshapes)
    params = _port_params(arch)
    got = _port_table(SH.param_shardings(tcfg, params, tmesh, serve=serve),
                      params)
    if tcfg.tie_embeddings:
        spec, shard = got.pop("embed_t")
        rules = SH.dataclass_mesh_without_fsdp(tmesh) if serve and \
            tcfg.n_params() * 2 / SH.tp_size(tmesh) < 12 * 2**30 else tmesh
        head = SH._param_spec(tcfg, rules, ("head",),
                              tuple(params["embed_t"].shape))
        assert spec == head
    assert got == want


@functools.lru_cache(maxsize=None)
def _ref_qparams(arch: str):
    from repro.core import quant as RQ
    return jax.eval_shape(RQ.quantize_params, _ref_params(arch))


@functools.lru_cache(maxsize=None)
def _port_qparams(arch: str):
    from repro_torch.core.quant import quantize_params
    return quantize_params(_port_params(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_equals_reference(arch):
    """The int8 serving tree (the dry run's ``--quant``): the same leaves
    become QTensors as under the reference's ``_is_weight`` (stacked and
    per-expert dims kept in the scale), and every leaf has the
    reference's shape and dtype.  The port's tied models also carry
    ``embed_t``, which stays as it is, as ``embed`` does."""
    want = {_dotted(p): (tuple(x.shape), str(x.dtype)) for p, x in
            jax.tree_util.tree_flatten_with_path(_ref_qparams(arch))[0]}
    got = {p: (tuple(x.shape), str(x.dtype).split(".")[-1]) for p, x in
           tree.flatten_with_paths(_port_qparams(arch))}
    if t_configs()[arch].tie_embeddings:
        assert got.pop("embed_t") == (got["embed"][0][::-1], got["embed"][1])
    assert got == want
    quantized = {p.rsplit(".", 1)[0] for p in got if p.endswith(".scale")}
    assert quantized and all(got[f"{p}.q"][1] == "int8" for p in quantized)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_param_specs_equal_reference(arch, mesh):
    """The serving layout of the int8 tree: each ``q`` and ``scale`` (and
    every leaf left as it was) gets the reference's spec and shard shape
    from ``param_shardings(..., serve=True)``; ``embed_t`` an untied
    head's."""
    rcfg, tcfg = r_configs()[arch], t_configs()[arch]
    rmesh, tmesh = _jmesh(*MESHES[mesh]), SH.AbstractMesh(*MESHES[mesh])
    rshapes = _ref_qparams(arch)
    want = _ref_table(RSH.param_shardings(rcfg, rshapes, rmesh, serve=True),
                      rshapes)
    params = _port_qparams(arch)
    got = _port_table(SH.param_shardings(tcfg, params, tmesh, serve=True),
                      params)
    if tcfg.tie_embeddings:
        spec, _ = got.pop("embed_t")
        unquantized = _port_table(SH.param_shardings(
            tcfg, _port_params(arch), tmesh, serve=True), _port_params(arch))
        assert spec == unquantized["embed_t"][0]
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_reference(arch, mesh):
    """The AdamW moments (and the replicated step) of the trained leaves,
    in the moment dtype the dry run gives the arch."""
    rcfg, tcfg = r_configs()[arch], t_configs()[arch]
    rmesh, tmesh = _jmesh(*MESHES[mesh]), SH.AbstractMesh(*MESHES[mesh])
    shape = tbase.SHAPES_BY_NAME["train_4k"]
    tc = D.train_config_for(tcfg, shape, tmesh)
    rshapes = _ref_params(arch)
    ropt = jax.eval_shape(lambda: radamw.init(
        rshapes, rbase.TrainConfig(moment_dtype=tc.moment_dtype)))
    want = _ref_table(RSH.opt_shardings(rcfg, ropt, rmesh), ropt)
    opt = adamw.init(T.trainable(_port_params(arch)), tc)
    got = _port_table(SH.opt_shardings(tcfg, opt, tmesh), opt)
    assert got == want
    assert [str(x.dtype) for x in jax.tree.leaves(ropt.m)] == \
        [str(x.dtype).split(".")[-1] for x in tree.leaves(opt.m)]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_reference(arch, mesh, shape):
    """Every decode-cache leaf of ``init_cache`` at the shape (bf16, an
    enc-dec config's cross entries at the dry run's frame count), and the
    batch specs of every shape's inputs."""
    rcfg, tcfg = r_configs()[arch], t_configs()[arch]
    rmesh, tmesh = _jmesh(*MESHES[mesh]), SH.AbstractMesh(*MESHES[mesh])
    sh = tbase.SHAPES_BY_NAME[shape]
    enc = D.audio_frames_for(sh) if tcfg.enc_dec else 0
    rcache = jax.eval_shape(lambda: RKC.init_cache(
        rcfg, sh.global_batch, sh.seq_len, enc_len=enc, dtype=jnp.bfloat16))
    want = _ref_table(RSH.cache_shardings(rcfg, rmesh, rcache), rcache)
    cache = KC.init_cache(tcfg, sh.global_batch, sh.seq_len, enc_len=enc,
                          dtype=torch.bfloat16, device="meta")
    got = _port_table(SH.cache_shardings(tcfg, tmesh, cache), cache)
    assert got == want
    for s in tbase.SHAPES:
        batch = D.input_specs(tcfg, s)
        rbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32 if
                                          v.dtype == torch.int32 else
                                          jnp.bfloat16)
                  for k, v in batch.items()}
        assert _port_table(SH.batch_shardings(tmesh, batch), batch) == \
            _ref_table(RSH.batch_shardings(rmesh, rbatch), rbatch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_helpers_equal_reference(mesh):
    rmesh, tmesh = _jmesh(*MESHES[mesh]), SH.AbstractMesh(*MESHES[mesh])
    assert SH.dp_axes(tmesh) == RSH.dp_axes(rmesh)
    assert SH.dp_size(tmesh) == RSH.dp_size(rmesh)
    assert SH.tp_size(tmesh) == RSH.tp_size(rmesh)
    assert tmesh.size == rmesh.size and tmesh.devices == ()
    prod = make_production_mesh(multi_pod=mesh == "2pod")
    assert (prod.axis_names, prod.axis_sizes) == (tmesh.axis_names,
                                                  tmesh.axis_sizes)
    none = SH.dataclass_mesh_without_fsdp(tmesh)
    rnone = RSH.dataclass_mesh_without_fsdp(rmesh)
    assert none.shape == dict(rnone.shape)
    x = torch.empty((2, 32, 8))
    assert SH.replicated(tmesh, {"x": x})["x"].spec == (None,) * 3


def test_meshes_and_constrain():
    """The one-axis device mesh of the fleet is unchanged; the local mesh
    covers the CPU when asked (and never falls back to it); ``constrain``
    returns its input, checking the spec's length only inside an
    activation mesh."""
    one = SH.Mesh(("cpu",))
    assert (one.axis_names, one.axis_sizes, one.shape) == \
        (("data",), (1,), {"data": 1})
    assert SH.dp_size(SH.Mesh(("cpu", "meta"))) == 2
    two = SH.Mesh(("cpu", "meta"), ("data", "model"), (1, 2))
    assert SH.tp_size(two) == 2 and SH.dp_size(two) == 1
    with pytest.raises(ValueError):
        SH.Mesh(("cpu", "meta"), ("data", "model"), (1, 3))
    with pytest.raises(ValueError):
        SH.wave_sharding(two)
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_local_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_local_mesh()
    x = torch.zeros((2, 3, 4))
    assert SH.active_mesh() is None
    assert SH.constrain(x, ("dp",)) is x             # no mesh: no check
    m = SH.AbstractMesh((2, 4), ("data", "model"))
    with SH.activation_mesh(m):
        assert SH.active_mesh() is m
        assert SH.constrain(x, ("dp", None, "tp")) is x
        with pytest.raises(ValueError):
            SH.constrain(x, ("dp", None))
    assert SH.active_mesh() is None
    sh = SH.NamedSharding(m, (("data", "model"), None, "model"))
    assert sh.shard_shape((16, 3, 8)) == (2, 3, 2)
    assert SH.shard_bytes({"a": sh}, {"a": torch.empty((16, 3, 8))}) == \
        2 * 3 * 2 * 4


# ---------------------------------------------------------------------------
# MoE: G data-parallel dispatch groups
# ---------------------------------------------------------------------------
_MOE = dict(name="m", family="moe", n_layers=2, d_model=16, n_heads=4,
            n_kv_heads=2, d_ff=32, vocab_size=64, head_dim=4,
            param_dtype="float32", compute_dtype="float32")


def _moe_cfgs(shared: bool):
    r = rbase.ModelConfig(moe=rbase.MoEConfig(4, 2, capacity_factor=1.25,
                                              shared_expert=shared), **_MOE)
    t = tbase.ModelConfig(moe=tbase.MoEConfig(4, 2, capacity_factor=1.25,
                                              shared_expert=shared), **_MOE)
    return r, t


def _ref_grouped(cfg, rp, x, G: int, scatter: bool):
    """The reference's grouped dispatch on G groups, composed from its
    parts as its ``moe_block`` composes them on a G-way data mesh."""
    B, S, d = x.shape
    T_ = B * S
    Tg = T_ // G
    C = RM._capacity(Tg, cfg)
    xg = x.reshape(G, Tg, d)
    vals, idx, aux = RM._route(cfg, rp, xg.reshape(T_, d), "moe")
    vals = vals.reshape(G, Tg, -1)
    idx = idx.reshape(G, Tg, -1)
    if scatter:
        out = RM._moe_scatter_grouped(cfg, rp, xg, vals, idx, C, "moe")
    else:
        out = jnp.stack([RM._moe_einsum(cfg, rp, xg[g], vals[g], idx[g], C,
                                        "moe") for g in range(G)])
    out = out.reshape(B, S, d)
    if cfg.moe.shared_expert:
        out = out + RM.mlp(cfg, rp["shared"], x, name="moe.shared")
    return out, aux


@pytest.mark.parametrize("shared", [False, True], ids=["plain", "shared"])
@pytest.mark.parametrize("path", ["einsum", "scatter"])
@pytest.mark.parametrize("G", [2, 4])
def test_moe_groups_match_reference(G, path, shared, monkeypatch):
    """Under a data-parallel activation mesh of G the port's ``moe_block``
    routes G groups (capacity per group), through the one-hot einsums per
    group or the grouped scatter, and matches the reference's grouped
    dispatch on the same inputs within 5e-5 (fp32: only summation order
    differs).  Without a mesh it routes one group, as before."""
    rcfg, tcfg = _moe_cfgs(shared)
    rp = RM.init_moe(rcfg, jax.random.PRNGKey(G), 16, 32, jnp.float32)
    p = lm_params_from_reference({"embed": jnp.zeros((1, 1)),
                                  "head": jnp.zeros((1, 1)), "t": rp},
                                 device="cpu")["t"]
    x = np.random.default_rng(G).standard_normal((8, 24, 16)).astype(
        np.float32)
    if path == "scatter":                  # force the scatter at this size
        monkeypatch.setattr(M, "_EINSUM_DISPATCH_MAX_T", 0)
    want, waux = _ref_grouped(rcfg, rp, jnp.asarray(x), G,
                              path == "scatter")
    kern = Engine(backend="kernels")
    with SH.activation_mesh(SH.AbstractMesh((G, 1), ("data", "model"))), \
            kern.activate(), kern.tracing() as tr:
        assert M._n_groups(8 * 24, 8) == G
        got, aux = M.moe_block(tcfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    experts = [r for r in tr if r.name == "moe.experts"]
    assert {r.m for r in experts} == {M._capacity(8 * 24 // G, tcfg)}
    one, _ = _ref_grouped(rcfg, rp, jnp.asarray(x), 1, path == "scatter")
    with kern.activate():
        assert M._n_groups(8 * 24, 8) == 1
        ungrouped, _ = M.moe_block(tcfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(ungrouped.numpy(), np.asarray(one),
                               rtol=5e-5, atol=5e-5)
    # a batch the groups do not divide routes one group
    with SH.activation_mesh(SH.AbstractMesh((G, 1), ("data", "model"))):
        assert M._n_groups(3 * 24, 3) == 1


def test_padded_heads_inside_a_mesh_only():
    """Inside an activation mesh whose model axis does not divide the
    query heads, attention pads them as the reference does (llava: 56 ->
    64 over 16); outside a mesh nothing is padded.  With one kv head the
    padding keeps every query head's kv head, and the forward equals the
    unpadded one bitwise on the CPU (with more kv heads the padded count
    regroups them, in the reference as here: a layout for the dry run's
    shapes, not for serving)."""
    from repro_torch.configs.base import reduced
    from repro_torch.models import attention as A
    cfg = reduced(t_configs()["olmo-1b"], n_heads=6, n_kv_heads=1,
                  head_dim=8)
    q = torch.zeros((1, 4, 6, 8))
    assert A._pad_heads(cfg, q)[0] is q
    with SH.activation_mesh(SH.AbstractMesh((1, 4), ("data", "model"))):
        padded, hq = A._pad_heads(cfg, q)
        assert (padded.shape[2], hq) == (8, 6)
    assert D._padded_heads(cfg, 4) == 8
    assert D._padded_heads(dataclasses.replace(cfg, n_kv_heads=2), 4) == 8
    assert D._padded_heads(r_configs()["llava-next-34b"], 16) == 64
    p = T.init_params(cfg, 0, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = T.forward(cfg, p, {"tokens": tok})[0]
        with SH.activation_mesh(SH.AbstractMesh((1, 4),
                                                ("data", "model"))):
            got = T.forward(cfg, p, {"tokens": tok})[0]
    assert torch.equal(got, want)
    assert os.environ.get("XLA_FLAGS", "").find("512") < 0
