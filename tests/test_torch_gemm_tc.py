"""The SA-CONV GEMM's tensor-core geometry (bf16 x), on the CPU.

``csrc/sa_conv.cu`` runs bf16 activations on the tensor cores: one CTA of
two consumer warpgroups and a producer warpgroup per 128 x 128 output
tile, ``wgmma`` products of 16 k into fp32 accumulators, a ring of 64-k
stages filled by TMA or by cp.async.  The CUDA kernel cannot run here;
``kernels/sa_conv.py`` mirrors its tiling, shared memory, producer and
summation order in Python, and these tests hold that mirror: every output
covered once, the shared memory within an H100 CTA's, nothing chosen from
m, the producer of every LM matmul the port serves and trains, and the
constants against the CUDA source.  The launch pass
(``analysis/launch.py``) checks the same launches, so seeded faults show
that it catches a producer or a kernel chosen wrongly.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.analysis import launch as tlaunch
from repro_torch.kernels import _build
from repro_torch.kernels import sa_conv as tgemm

#: the most shared memory a Hopper CTA may opt into, and an SM holds
SMEM_OPTIN, SMEM_PER_SM = 232448, 233472
BF16 = 2


def _cover(g) -> np.ndarray:
    """How many consumer threads own each output of a CTA's tile."""
    cover = np.zeros((g.bm, g.bn), np.int32)
    for t in range(g.threads):
        rows, cols = g.thread_outputs(t)
        cover[np.ix_(rows, cols)] += 1
    return cover


@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 700), n=st.integers(1, 900), k=st.integers(0, 3000),
       w_kind=st.sampled_from([0, 1, 2]))
def test_tc_geometry_covers_every_output_once(m, n, k, w_kind):
    """Ragged (m, n, k): every output in exactly one CTA and one consumer
    thread, the CTAs' origins the distinct tiles, row tiles fastest."""
    g = tgemm.gemm_geometry(m, n, k, w_kind, BF16)
    assert g.tensor_cores and (g.bm, g.bn, g.threads) == (128, 128, 256)
    assert (_cover(g) == 1).all()
    seen = np.zeros((g.row_tiles * g.bm, g.col_tiles * g.bn), np.int32)
    for cta in range(g.ctas):
        r0, c0 = g.cta_origin(cta)
        seen[r0:r0 + g.bm, c0:c0 + g.bn] += 1
        if cta + 1 < g.ctas and (cta + 1) % g.row_tiles:
            assert g.cta_origin(cta + 1) == (r0 + g.bm, c0)
    assert (seen == 1).all()
    assert seen.shape[0] - g.bm < m <= seen.shape[0]
    assert seen.shape[1] - g.bn < n <= seen.shape[1]


@pytest.mark.parametrize("warp,lane", [(0, 0), (0, 5), (3, 31), (6, 9)])
def test_tc_thread_outputs_are_the_wgmma_fragment(warp, lane):
    """Consumer warp v of warpgroup wg holds rows 64 wg + 16 v + lane / 4
    and that + 8, columns 8 j + 2 (lane % 4) and that + 1 for j = 0..15."""
    g = tgemm.gemm_geometry(256, 256, 64, 2, BF16)
    rows, cols = g.thread_outputs(32 * warp + lane)
    r = 64 * (warp // 4) + 16 * (warp % 4) + lane // 4
    assert rows == [r, r + 8]
    assert cols == sorted(8 * j + 2 * (lane % 4) + e for j in range(16)
                          for e in (0, 1))


@pytest.mark.parametrize("w_kind", [0, 1, 2])
def test_tc_shared_memory_fits_a_cta(w_kind):
    """The ring (4 stages of 32 KB), 3 raw stages for fp32 and int8 weights,
    the mbarriers and the alignment slack fit what a CTA may opt into and
    an SM holds with its reserve; the launch pass derives the same."""
    g = tgemm.gemm_geometry(2048, 8192, 2048, w_kind, BF16)
    raw = {0: 3 * 64 * 128 * 4, 1: 3 * 64 * 128, 2: 0}[w_kind]
    assert g.smem_bytes == 1024 + 4 * 32768 + raw + 64
    assert g.smem_bytes <= SMEM_OPTIN
    assert g.per_sm * (g.smem_bytes + tlaunch.SMEM_RESERVED) <= SMEM_PER_SM
    lau = tlaunch.gemm_launch("tc", 2048, 8192, 2048, w_kind, BF16)
    ((lib, args, derived),) = tlaunch.smem_queries(lau)
    assert (lib, args, derived) == ("sa_conv", (w_kind, BF16), g.smem_bytes)
    assert tlaunch.check_launch(lau) == []


@pytest.mark.parametrize("n,k,w_kind", [(2048, 2048, 2), (256206, 1024, 2),
                                        (1024, 256206, 2), (300, 520, 0),
                                        (261, 301, 1), (50304, 2048, 2)])
def test_tc_launch_does_not_read_m(n, k, w_kind):
    """Tile, stages, producer, copies and k order are the same for m = 1
    to 300: rows == m = 1 and batched == unbatched rest on it."""
    ref = tgemm.gemm_geometry(1, n, k, w_kind, BF16)
    for m in range(1, 301):
        g = tgemm.gemm_geometry(m, n, k, w_kind, BF16)
        assert dataclasses.replace(g, row_tiles=1) == ref, m
        assert g.row_tiles == -(-m // 128)
        assert g.k_order(k) == ref.k_order(k)


@pytest.mark.parametrize("k", [0, 1, 16, 63, 64, 1001, 2048])
def test_tc_sum_order_is_increasing_k(k):
    """Every output adds its k terms in increasing order, 16 a wgmma step,
    then the zero-filled terms of the last 64-k stage."""
    want = list(range(k)) + [-1] * (-k % 64)
    for n, w_kind in ((128, 2), (256206, 2), (201, 1), (200, 0)):
        assert tgemm.gemm_geometry(3, n, k, w_kind, BF16).k_order(k) == want


@pytest.mark.parametrize("k,n,w_kind,x_off,w_off,want", [
    (2048, 2048, 2, 0, 0, True), (1024, 256206, 2, 0, 0, False),
    (256206, 1024, 2, 0, 0, False), (2048, 2048, 0, 0, 0, False),
    (2048, 2048, 1, 0, 0, False), (2048, 2048, 2, 2, 0, False),
    (2048, 2048, 2, 0, 8, False), (2048, 2048, 2, 16, 32, True),
    (0, 2048, 2, 0, 0, False), (8, 8, 2, 0, 0, True)])
def test_tma_ok_needs_bf16_weights_and_16_byte_rows(k, n, w_kind, x_off,
                                                   w_off, want):
    assert tgemm.tma_ok(k, n, w_kind, 4096 + x_off, 8192 + w_off) is want


def _bf16_gemms():
    return [lau for lau in tlaunch.lm_launches()
            if lau.kernel == "sa_conv" and lau.shape[4] == BF16]


@pytest.fixture(scope="module")
def bf16_gemms():
    return _bf16_gemms()


def test_tc_producer_of_every_lm_matmul(bf16_gemms):
    """Every bf16-x GEMM the LM configs serve and train (forward, dx, dw)
    runs on the tensor cores; TMA wherever w is bf16 with 16-byte rows,
    cp.async otherwise: seamless's 256206-wide head, forward, dx (k =
    256206) and dw."""
    assert bf16_gemms
    cp = set()
    for lau in bf16_gemms:
        m, n, k, w_kind, _ = lau.shape
        (g,) = lau.geoms
        assert g.tensor_cores, lau.op
        ok = w_kind == 2 and k % 8 == 0 and n % 8 == 0
        assert g.producer == ("tma" if ok else "cp.async"), lau.op
        if not ok:
            cp.add(re.sub(r" b\dx512", "", lau.op.split(":")[0]) + ":"
                   + lau.op.split(":")[1])
    assert cp == {
        "seamless-m4t-large-v2 prefill: lm_head [sa_conv]",
        "seamless-m4t-large-v2 train: lm_head dx [sa_conv]",
        "seamless-m4t-large-v2 train: lm_head dw [sa_conv]"}, cp
    assert sum(g.geoms[0].producer == "tma" for g in bf16_gemms) > 100


def test_tc_launch_pass_is_clean_on_every_lm_matmul(bf16_gemms):
    for lau in bf16_gemms:
        assert tlaunch.check_launch(lau) == [], lau.op


def test_tc_edge_launches_take_both_producers():
    """Phase 11 of chip_smoke.py launches the bf16 GEMM through TMA and
    through cp.async (odd widths with element x loads; fp32 and int8
    weights rounded into the tile)."""
    edges = {lau.op: lau for lau in tlaunch.edge_launches()
             if lau.kernel == "sa_conv" and lau.shape[4] == BF16}
    producers = {op: lau.geoms[0].producer for op, lau in edges.items()}
    assert producers == {
        "edge 130x200 bf16 [sa_conv]": "tma",
        "edge 130x202 bf16 cp.async [sa_conv]": "cp.async",
        "edge 130x200 bf16 x fp32 w [sa_conv]": "cp.async",
        "edge 130x201 bf16 x int8 w [sa_conv]": "cp.async"}
    assert edges["edge 130x202 bf16 cp.async [sa_conv]"].geoms[0].x_copy == 0
    for lau in edges.values():
        assert tlaunch.check_launch(lau) == [], lau.op


def test_launch_catches_a_producer_tma_ok_refuses():
    lau = tlaunch.gemm_launch("odd", 130, 202, 1001, 2, BF16)
    (g,) = lau.geoms
    bad = dataclasses.replace(lau, geoms=(dataclasses.replace(
        g, producer="tma"),))
    msgs = " | ".join(f.message for f in tlaunch.check_launch(bad))
    assert "sa_conv coverage: out: the tma producer where tma_ok says" in \
        msgs, msgs


def test_launch_catches_bf16_x_on_the_fma_loop():
    real = tgemm.gemm_geometry

    def fma(m, n, k, w_kind, x_kind=0):
        return real(m, n, k, w_kind, 0)

    lau = tlaunch.gemm_launch("bf16", 300, 256, 512, 2, BF16)
    bad = dataclasses.replace(lau, geoms=(fma(300, 256, 512, 2),))
    msgs = " | ".join(f.message for f in tlaunch.check_launch(bad))
    assert "sa_conv order: out: bf16 x on the FMA loop" in msgs, msgs
    assert "residency" in msgs, msgs


def test_launch_catches_a_producer_that_reads_m(monkeypatch):
    """A geometry that switches producer above 128 rows breaks rows == m
    = 1: the pass finds the launch at m = 1 differs."""
    real = tgemm.gemm_geometry

    def reading_m(m, n, k, w_kind, x_kind=0):
        g = real(m, n, k, w_kind, x_kind)
        if m > 128 and g.tensor_cores:
            g = dataclasses.replace(g, producer="cp.async")
        return g

    monkeypatch.setattr(tgemm, "gemm_geometry", reading_m)
    lau = tlaunch.gemm_launch("qkv", 200, 2048, 2048, 2, BF16)
    msgs = " | ".join(f.message for f in tlaunch.check_launch(lau))
    assert "the launch at m=1 differs from m=200 in ['producer']" in msgs, \
        msgs


def test_tc_constants_match_the_cuda_source():
    """kernels/sa_conv.py mirrors csrc/sa_conv.cu's tensor-core tiling,
    ring and alignment, and the producer query is bound (the wgmma, TMA and
    tensor-map helpers it shares with the other tensor-core kernels live in
    csrc/common.cuh, which it includes)."""
    src = (_build.CSRC / "sa_conv.cu").read_text()
    assert '#include "common.cuh"' in src
    src += (_build.CSRC / "common.cuh").read_text()
    for name, value in (("TC_BM", tgemm.TC_BM), ("TC_BN", tgemm.TC_BN),
                        ("TC_BK", tgemm.TC_BK),
                        ("TC_STAGES", tgemm.TC_STAGES),
                        ("TC_RAW_STAGES", tgemm.TC_RAW_STAGES),
                        ("TC_CONSUMERS", tgemm.TC_CONSUMERS),
                        ("TC_THREADS", tgemm.TC_THREADS),
                        ("TC_ALIGN", tgemm.TC_ALIGN)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "cp.async.bulk.tensor.2d" in src
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src
    ((fn, args),) = _build.QUERY_SIGNATURES["sa_conv"]
    assert fn == "sa_conv_producer" and len(args) == 6
    assert f"extern \"C\" int {fn}(" in src


def test_fp32_x_keeps_the_fma_loop():
    """fp32 x keeps the FMA loop's tiling: 128 x 128, 16-k stages, two
    CTAs an SM, no tensor cores (no TF32)."""
    g = tgemm.gemm_geometry(2048, 2048, 2048, 0)
    assert not g.tensor_cores
    assert (g.bm, g.bn, g.bk, g.stages, g.threads, g.per_sm) == \
        (128, 128, 16, 4, 256, 2)
    assert g.smem_bytes == 4 * (16 * 132 * 4 + 16 * 128 * 4)
