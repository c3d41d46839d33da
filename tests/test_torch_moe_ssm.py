"""The port's MoE and Mamba2/SSD blocks on the CPU against the JAX
package: the reference's own MoE and SSD tests (``tests/test_moe_ssd.py``)
mirrored on the port, then the port's ``ref.ssd``, ``ssd_chunked``,
``mamba_forward`` and ``moe_block`` against the reference's on the same
inputs.  The stacks built from them are held in
``tests/test_torch_moe_ssm_stacks.py``.

Parameters are made by the reference (``jax.random``) and carried across as
numpy; inputs are made with numpy.  The reference runs on its XLA backend;
the port on its ``"kernels"`` backend, whose wrappers take their plain
versions for CPU tensors.  Tolerances: the reference's own, 2e-5 / 5e-5 for
the two dispatch paths and 5e-4 for SSD (``tests/test_moe_ssd.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.models.moe as RM
from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.kernels import ref as rref
from repro.models import ssm as RS
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import tree
from repro_torch.core.engine import Engine
from repro_torch.kernels import ref
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

TOL = dict(rtol=5e-4, atol=5e-4)
KERNELS = Engine(backend="kernels")

# tests/test_moe_ssd.py's MoE config
_MOE = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, head_dim=8,
            param_dtype="float32", compute_dtype="float32")
RCFG = rbase.ModelConfig(moe=rbase.MoEConfig(4, 2, capacity_factor=1.25),
                         **_MOE)
TCFG = tbase.ModelConfig(moe=tbase.MoEConfig(4, 2, capacity_factor=1.25),
                         **_MOE)


def _torch(tree_):
    """A reference tree (dicts of arrays) as CPU tensors."""
    return lm_params_from_reference({"embed": jnp.zeros((1, 1)),
                                     "head": jnp.zeros((1, 1)),
                                     "t": tree_}, device="cpu")["t"]


def _normal(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe_setup(T_=256, d=32, ff=64, seed=0):
    """(reference params, port params, x as numpy)."""
    rp = RM.init_moe(RCFG, jax.random.PRNGKey(seed), d, ff, jnp.float32)
    return rp, _torch(rp), _normal((T_, d), seed + 1)


def _route(p, x: np.ndarray):
    return M._route(TCFG, p, torch.from_numpy(x), "t")


# ---------------------------------------------------------------------------
# tests/test_moe_ssd.py, on the port
# ---------------------------------------------------------------------------
def test_einsum_equals_scatter_dispatch():
    _, p, x = _moe_setup()
    C = M._capacity(256, TCFG)
    vals, idx, _ = _route(p, x)
    xt = torch.from_numpy(x)
    a = M._moe_einsum(TCFG, p, xt, vals, idx, C, "t")
    b = M._moe_scatter(TCFG, p, xt, vals, idx, C, "t")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


@settings(max_examples=10, deadline=None)
@given(T_=st.sampled_from([32, 64, 96]), seed=st.integers(0, 20))
def test_dispatch_equivalence_property(T_, seed):
    _, p, x = _moe_setup(T_=T_, seed=seed)
    C = M._capacity(T_, TCFG)
    vals, idx, _ = _route(p, x)
    xt = torch.from_numpy(x)
    a = M._moe_einsum(TCFG, p, xt, vals, idx, C, "t")
    b = M._moe_scatter(TCFG, p, xt, vals, idx, C, "t")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5, atol=5e-5)


def test_capacity_drops_are_priority_ordered():
    """Tokens over capacity drop; earlier tokens win (choice-major): equal
    to the reference's drops, and different from a run with room for
    every token."""
    rp, p, x = _moe_setup(T_=64)
    vals, idx, _ = _route(p, x)
    xt = torch.from_numpy(x)
    out = M._moe_scatter(TCFG, p, xt, vals, idx, 4, "t")
    assert torch.isfinite(out).all()
    big = M._moe_scatter(TCFG, p, xt, vals, idx, 64, "t")
    assert not np.allclose(out.numpy(), big.numpy())
    rv, ri, _ = RM._route(RCFG, rp, jnp.asarray(x), "t")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    want = RM._moe_scatter(RCFG, rp, jnp.asarray(x), rv, ri, 4, "t")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_router_aux_loss_balanced_uniform():
    """A uniform router gives aux ~ 1 (the Switch normalization)."""
    _, p, x = _moe_setup()
    p = dict(p, router=torch.zeros_like(p["router"]))
    _, _, aux = _route(p, x)
    assert 0.9 <= float(aux) <= 1.1


def test_moe_block_grad_finite():
    _, p, x = _moe_setup()
    p = tree.map_leaves(lambda t: t.clone().requires_grad_(True), p)
    out, aux = M.moe_block(TCFG, p, torch.from_numpy(x).reshape(2, 128, 32))
    (torch.sum(out ** 2) + aux).backward()
    for leaf in tree.leaves(p):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


def _ssd_inputs(B, S_, H, D, N, seed):
    """x, dt (softplus'd), a (< 0), b, c as numpy, from one seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S_, H, D)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, S_, H)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b = rng.standard_normal((B, S_, N)).astype(np.float32)
    c = rng.standard_normal((B, S_, N)).astype(np.float32)
    return x, dt, a, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@settings(max_examples=8, deadline=None)
@given(S_=st.sampled_from([17, 32, 50, 64]),
       chunk=st.sampled_from([8, 16, 32]), seed=st.integers(0, 10))
def test_ssd_chunked_matches_recurrence(S_, chunk, seed):
    x, dt, a, b, c = _t(*_ssd_inputs(2, S_, 3, 8, 4, seed))
    got, hg = S.ssd_chunked(x, dt, a, b, c, chunk=chunk, return_state=True)
    want, hw = ref.ssd(x, dt, a, b, c, return_state=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(hg.numpy(), hw.numpy(), rtol=5e-4, atol=5e-4)


def test_ssd_chunk_invariance():
    """The output must not depend on the chunk size (pure reparametrization
    of the same recurrence)."""
    x, dt, a, b, c = _t(*_ssd_inputs(1, 48, 2, 8, 4, 3))
    y8 = S.ssd_chunked(x, dt, a, b, c, chunk=8)
    y24 = S.ssd_chunked(x, dt, a, b, c, chunk=24)
    np.testing.assert_allclose(y8.numpy(), y24.numpy(), rtol=5e-4, atol=5e-4)


def test_ssd_state_continuation():
    """Splitting a sequence and carrying the state equals one pass — the
    prefill->decode hand-off contract."""
    x, dt, a, b, c = _t(*_ssd_inputs(1, 40, 2, 8, 4, 5))
    full = S.ssd_chunked(x, dt, a, b, c, chunk=8)
    y1, h = S.ssd_chunked(x[:, :24], dt[:, :24], a, b[:, :24], c[:, :24],
                          chunk=8, return_state=True)
    y2 = S.ssd_chunked(x[:, 24:], dt[:, 24:], a, b[:, 24:], c[:, 24:],
                       chunk=8, init_state=h)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(),
                               rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# the port's functions against the reference's, on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("init", [False, True])
def test_ssd_and_chunked_match_reference(init):
    """ref.ssd and ssd_chunked (S = 50 over chunks of 16, padded), with and
    without an initial state, against the reference's on the same
    inputs."""
    arrays = _ssd_inputs(2, 50, 3, 8, 4, 7)
    h0 = _normal((2, 3, 8, 4), 8) if init else None
    want, hw = rref.ssd(*map(jnp.asarray, arrays), init_state=None
                        if h0 is None else jnp.asarray(h0),
                        return_state=True)
    wantc, hwc = RS.ssd_chunked(*map(jnp.asarray, arrays), chunk=16,
                                init_state=None if h0 is None
                                else jnp.asarray(h0), return_state=True)
    h0t = None if h0 is None else torch.from_numpy(h0)
    got, hg = ref.ssd(*_t(*arrays), init_state=h0t, return_state=True)
    gotc, hgc = S.ssd_chunked(*_t(*arrays), chunk=16, init_state=h0t,
                              return_state=True)
    for g, w in ((got, want), (hg, hw), (gotc, wantc), (hgc, hwc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-4)


def test_softplus_is_the_reference_function():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(S.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def _mamba_cfgs():
    rc = rbase.reduced(rreg.get_config("mamba2-130m"),
                       param_dtype="float32", compute_dtype="float32")
    tc = tbase.reduced(treg.get_config("mamba2-130m"),
                       param_dtype="float32", compute_dtype="float32")
    return rc, tc


def test_mamba_forward_matches_reference():
    """A 20-token prefill (two chunks of 16, padded) with its cache, then
    three decode steps through the cache, against the reference's."""
    rc, tc = _mamba_cfgs()
    rp = RS.init_mamba(rc, jax.random.PRNGKey(0), jnp.float32)
    tp = _torch(rp)
    x = _normal((2, 23, rc.d_model), 1)
    want, rcache = RS.mamba_forward(rc, rp, jnp.asarray(x[:, :20]),
                                    return_cache=True)
    with KERNELS.activate():
        got, tcache = S.mamba_forward(tc, tp, torch.from_numpy(x[:, :20]),
                                      return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(rcache[key]), **TOL)
    for t in range(20, 23):
        want, rcache = RS.mamba_forward(rc, rp, jnp.asarray(x[:, t:t + 1]),
                                        cache=rcache)
        with KERNELS.activate():
            got, tcache = S.mamba_forward(tc, tp,
                                          torch.from_numpy(x[:, t:t + 1]),
                                          cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tcache["h"].numpy(),
                                   np.asarray(rcache["h"]), **TOL)


@pytest.mark.parametrize("T_,path", [(96, "einsum"), (8200, "scatter")])
def test_moe_block_matches_reference(T_, path):
    """``moe_block``'s output and aux loss against the reference's, on
    both dispatch paths: 96 tokens take the one-hot einsums, 8200 (past
    ``_EINSUM_DISPATCH_MAX_T``) the scatter."""
    rp, p, x = _moe_setup(T_=T_, d=16, ff=32, seed=2)
    C = M._capacity(T_, TCFG)
    small = T_ <= M._EINSUM_DISPATCH_MAX_T and \
        T_ * TCFG.moe.n_experts * C <= M._EINSUM_DISPATCH_MAX_TEC
    assert small == (path == "einsum")
    want, waux = RM.moe_block(RCFG, rp, jnp.asarray(x).reshape(2, -1, 16))
    with KERNELS.activate():
        got, aux = M.moe_block(TCFG, p, torch.from_numpy(x).reshape(2, -1,
                                                                    16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_top_k_ties_pick_the_lower_expert_first():
    """Equal gates: ``jax.lax.top_k`` puts the lower index first, and so
    does the port, for an all-equal router and for two equal experts
    among unequal ones."""
    rp, p, x = _moe_setup(T_=16)
    for router in (np.zeros((32, 4), np.float32),
                   np.asarray(rp["router"])[:, [0, 1, 2, 1]]):
        rv, ri, raux = RM._route(RCFG, dict(rp, router=jnp.asarray(router)),
                                 jnp.asarray(x), "t")
        vals, idx, aux = _route(dict(p, router=torch.from_numpy(router)), x)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    # expert 3 ties expert 1: chosen only behind it
    rows = idx.tolist()
    assert all(r.index(1) < r.index(3) for r in rows if 3 in r)
    assert any(3 in r for r in rows)
