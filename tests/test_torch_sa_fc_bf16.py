"""SA-FC's bf16-activation path on the tensor cores (``csrc/sa_fc_tc.cu``):
its route, its launch geometry at the served shapes, its shared memory
and the derived bound it is held to on the card, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_gpu.py -k
sa_fc``, ``chip_smoke.py``); here the wrapper's choice of kernel, the
geometry it launches (built in Python, as the wrapper builds it) and
``widened_bound`` are checked, and the plain version the CPU runs is held
against the reference's ``sa_fc_matmul`` in interpret mode at a few
shapes of each route.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sa_fc as jfc
from repro_torch.analysis import launch as tlaunch
from repro_torch.kernels import sa_fc as tfc
from repro_torch.kernels.sa_fc import (fc_split, sa_fc_matmul, sa_fc_plain,
                                       tc_launch, tc_route, widened_bound)

W_DTYPES = {"fp32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}
W_BYTES = {"fp32": 4, "int8": 1, "bf16": 2}
#: what a CTA may opt into on an H100 (232448 B, 227 KB)
SMEM_OPTIN = 232448


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the route: bf16 x on the tensor-core kernel at every b, fp32 x on the FMA
# kernel, the CPU on the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wdtype", list(W_DTYPES))
def test_every_bf16_x_launch_routes_to_the_tensor_core_kernel(wdtype):
    """At every b from 1 to 130 and with every weight type the launch pass
    (built as the wrapper builds its launch) puts bf16 x on ``sa_fc_tc``
    and fp32 x on ``sa_fc``, and finds nothing in either launch."""
    w_kind = tlaunch.W_KIND[{"fp32": "float32", "int8": "int8",
                             "bf16": "bfloat16"}[wdtype]]
    for b in range(1, 131):
        tc = tlaunch.fc_launch(f"b={b}", b, 300, 200, w_kind,
                               tlaunch.X_KIND["bfloat16"])
        fma = tlaunch.fc_launch(f"b={b}", b, 300, 200, w_kind,
                                tlaunch.X_KIND["float32"])
        assert (tc.kernel, fma.kernel) == ("sa_fc_tc", "sa_fc"), b
        assert tlaunch.check_launch(tc) == [] == tlaunch.check_launch(fma)
    assert tc_route(torch.bfloat16) and not tc_route(torch.float32)


@pytest.mark.parametrize("xdtype", ["fp32", "bf16"])
@pytest.mark.parametrize("wdtype", list(W_DTYPES))
def test_the_cpu_runs_the_plain_version_and_launches_nothing(xdtype, wdtype):
    """A CPU tensor takes :func:`sa_fc_plain` (fp32 epilogue, one rounding)
    and counts no launch of either kernel."""
    x = torch.from_numpy(_np(0, (5, 40)))
    if xdtype == "bf16":
        x = x.to(torch.bfloat16)
    w = torch.from_numpy(_np(1, (40, 24), 0.2))
    scale = None
    if wdtype == "int8":
        w = torch.from_numpy(np.clip(np.round(_np(1, (40, 24)) * 40), -127,
                                     127).astype(np.int8))
        scale = torch.from_numpy(np.abs(_np(2, (24,))) * 0.01 + 1e-3)
    elif wdtype == "bf16":
        w = w.to(torch.bfloat16)
    before = (sa_fc_matmul.launches, sa_fc_matmul.tc_launches)
    got = sa_fc_matmul(x, w, act="silu", w_scale=scale)
    assert (sa_fc_matmul.launches, sa_fc_matmul.tc_launches) == before
    assert torch.equal(got, sa_fc_plain(x, w, act="silu", w_scale=scale))
    assert got.dtype == x.dtype


@pytest.mark.parametrize("b,k,n", [(1, 130, 190), (9, 300, 257),
                                   (64, 256, 384)])
@pytest.mark.parametrize("wdtype", ["fp32", "bf16"])
def test_plain_bf16_version_against_the_reference_kernel(b, k, n, wdtype):
    """What the CPU runs for bf16 x against the reference's Pallas
    ``sa_fc_matmul`` in interpret mode on the same numpy inputs, within
    the reference's bf16 tolerance (3e-2)."""
    x, w, bias = _np(0, (b, k)), _np(1, (k, n), k ** -0.5), _np(2, (n,))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w)
    if wdtype == "bf16":
        wt = wt.to(torch.bfloat16)
    got = sa_fc_plain(xt, wt, torch.from_numpy(bias), act="relu")
    jw = jnp.asarray(w) if wdtype == "fp32" else jnp.asarray(w).astype(
        jnp.bfloat16)
    want = jfc.sa_fc_matmul(jnp.asarray(x).astype(jnp.bfloat16), jw,
                            jnp.asarray(bias), act="relu", interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# the launch geometry at the served shapes
# ---------------------------------------------------------------------------
#: AlexNet's head (fc1-fc3; fp32 weights, int8 in the int8 variant)
ALEXNET_FC = [(9216, 4096), (4096, 4096), (4096, 1000)]


@functools.lru_cache(maxsize=None)
def _seamless_prefill_shapes() -> tuple:
    """(m, k, n) of the bf16 SA-FC launches of seamless-m4t-large-v2's
    prefill of 4 requests of 16 tokens (the decoder at m = 64), from the
    engine's dispatch records on meta tensors (one decoder period deep)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config("seamless-m4t-large-v2")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern),
                              n_enc_layers=1)
    entries = tlaunch.traced_entries(cfg, "prefill", 4, 16)
    return tuple(sorted({(key.m, key.k, key.n) for key, plan in
                         entries.items() if plan.regime == "sa_fc"
                         and key.dtype == "bfloat16"}))


def _served_shapes():
    out = [pytest.param(b, k, n, wd, id=f"alexnet-{wd}-b{b}-{k}x{n}")
           for wd in ("fp32", "int8") for b in (1, 2, 64)
           for k, n in ALEXNET_FC]
    out += [pytest.param(4, k, n, "bf16", id=f"olmo-b4-{k}x{n}")
            for k, n in ((2048, 2048), (2048, 8192), (8192, 2048),
                         (2048, 50304))]
    return out


def _check_geometry(b, k, n, w_bytes):
    d = tc_launch(b, k, n, w_bytes)
    # the split, and so every output's order, follows (k, n) alone
    assert (d.segments, d.seg_k) == fc_split(k, n)
    for bb in (1, 2, 3, 8, 9, 16, 17, 33, 64, 65, 130):
        other = tc_launch(bb, k, n, w_bytes)
        assert (other.segments, other.seg_k) == (d.segments, d.seg_k), bb
    # every (tile, segment, row tile) once, on one warp
    runs = {}
    for c in range(d.ctas):
        for i in range(d.workers):
            for unit in d.worker_units(c, i):
                runs[unit] = runs.get(unit, 0) + 1
    assert set(runs.values()) == {1}
    assert len(runs) == d.tiles * d.segments * d.row_tiles
    assert 1 <= d.ctas <= 132 and d.tiles * d.cols >= n
    assert d.rows * d.row_tiles >= b
    # shared memory: the launch pass's model, under what a CTA may opt into
    assert d.smem == tlaunch._fc_tc_smem(d.narrow, d.rows, w_bytes,
                                         d.segments, d.span)
    assert d.smem <= SMEM_OPTIN
    return d


@pytest.mark.parametrize("b,k,n,wdtype", _served_shapes())
def test_launch_geometry_at_the_served_shapes(b, k, n, wdtype):
    """AlexNet's head at b = 1, 2 (the bf16 server's last wave) and 64 (a
    full wave) with fp32 and int8 weights, OLMo-1B's decode step at b = 4:
    the split a function of (k, n) alone, each unit on one warp, the grid
    on the SMs, shared memory as the launch pass derives it; a full wave
    is wide, at a row tile of 64 (32-column units), or, where k is split
    into 8 or more segments (fc3: 19), at 8 row tiles of 8."""
    d = _check_geometry(b, k, n, W_BYTES[wdtype])
    if b == 64:
        assert not d.narrow and (d.rows, d.row_tiles) == (
            (8, 8) if d.segments >= 8 else (64, 1))
        assert (d.rows == 8) == (n == 1000)
    assert d.narrow == (b <= 8 and k <= 4096 and n <= 4096)


def test_launch_geometry_of_seamless_decoder_prefill():
    """seamless-m4t-large-v2's decoder prefill at m = 64 (bf16 weights):
    every SA-FC launch on the tensor-core kernel, wide, at row tiles of 8
    where k is split into 8 or more segments (1024 x 1024: 32; 8192 x
    1024: 18), else one of 64, and the geometry checks of the served
    shapes."""
    shapes = _seamless_prefill_shapes()
    assert shapes and {m for m, _, _ in shapes} == {64}
    assert (64, 1024, 256206) in shapes                 # the head
    for m, k, n in shapes:
        d = _check_geometry(m, k, n, 2)
        assert not d.narrow and d.rows == (8 if d.segments >= 8 else 64)
        lau = tlaunch.fc_launch("seamless", m, k, n, tlaunch.W_KIND[
            "bfloat16"], tlaunch.X_KIND["bfloat16"])
        assert lau.kernel == "sa_fc_tc" and tlaunch.check_launch(lau) == []


@pytest.mark.parametrize("rows", tfc.TC_ROWS)
@pytest.mark.parametrize("wdtype", list(W_DTYPES))
def test_every_instantiation_fits_shared_memory(rows, wdtype):
    """Each wide instantiation's CTA, and the most a narrow CTA opts into
    (its rings and the full 64 KiB of partials), fit what a CTA may opt
    into, one CTA an SM."""
    wb = W_BYTES[wdtype]
    wide = tfc.wide_smem_bytes(rows, wb)
    assert wide == tlaunch._fc_tc_smem(False, rows, wb, 1, 0) <= SMEM_OPTIN
    assert tfc.wide_stage_bytes(rows, wb) % 1024 == 0
    narrow = tfc.narrow_smem_bytes(wb, 1, 1) + tfc.PART_SMEM_MAX
    assert narrow <= SMEM_OPTIN
    # a chunk's weights are 4 KB at row tiles 8 and 16 (2 KB of int8), and
    # a thread holds at most 64 accumulators
    cols = tfc.tc_cols(rows, wb)
    assert cols * rows // 32 <= 64
    if rows <= 16:
        assert 32 * cols * wb == (2048 if wb == 1 else 4096)


# ---------------------------------------------------------------------------
# widened_bound
# ---------------------------------------------------------------------------
def _widened_case(seed, b, k, n, wdtype):
    """bf16 x, w of ``wdtype``, its scale, and the FMA kernel's fp32
    function on the widened operands (the plain version in fp32)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)
                         ).to(torch.bfloat16)
    scale = None
    if wdtype == "int8":
        w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        scale = torch.from_numpy((rng.random(n) * 0.02 + 1e-3)
                                 .astype(np.float32))
        wide = w.float()
    else:
        w = torch.from_numpy((rng.standard_normal((k, n)) * k ** -0.5)
                             .astype(np.float32))
        if wdtype == "bf16":
            w = w.to(torch.bfloat16)
        wide = w.to(torch.bfloat16).float()
    fp32 = sa_fc_plain(x.float(), wide, w_scale=scale)
    return x, w, scale, wide, fp32


@pytest.mark.parametrize("wdtype", list(W_DTYPES))
@pytest.mark.parametrize("out", ["fp32", "bf16"])
def test_widened_bound_holds_the_exact_product_and_not_twice_it(wdtype, out):
    """The exact product (fp64 of the exact bf16 operands, scaled, rounded
    to the output type) lies within ``widened_bound`` of the fp32 launch on
    the widened operands; an output moved by twice the bound lies outside
    it."""
    out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
    x, _, scale, wide, fp32 = _widened_case(3, 9, 700, 130, wdtype)
    exact = x.double() @ wide.double()
    if scale is not None:
        exact = exact * scale.double()
    exact = exact.to(out_dtype).double()
    bound = widened_bound(x, wide, fp32, w_scale=scale, out_dtype=out_dtype)
    assert bound.dtype == torch.float64 and bound.shape == fp32.shape
    assert ((exact - fp32.double()).abs() <= bound).all()
    moved = fp32.double() + 2 * bound
    assert ((moved - fp32.double()).abs() > bound).all()


def test_widened_bound_grows_with_k_and_the_scale():
    """k 2^-22 (|x| @ |w|): linear in k for the same terms, scaled by the
    int8 scale's magnitude, one bf16 ulp more for a bf16 output."""
    x = torch.ones((1, 64), dtype=torch.bfloat16)
    w = torch.ones((64, 2))
    ref = torch.full((1, 2), 64.0)
    b = widened_bound(x, w, ref, out_dtype=torch.float32)
    assert torch.equal(b, torch.full((1, 2), 64 * 64 * 2.0 ** -22,
                                     dtype=torch.float64))
    s = widened_bound(x, w, ref, w_scale=torch.tensor([2.0, -0.5]),
                      out_dtype=torch.float32)
    assert torch.equal(s, b * torch.tensor([[2.0, 0.5]], dtype=torch.float64))
    h = widened_bound(x, w, ref)                  # x's dtype: bf16
    assert torch.equal(h - b, torch.full((1, 2), 2.0 ** (7 - 8),
                                         dtype=torch.float64))
