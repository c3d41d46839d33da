"""Mixture-of-Experts block of the port (Switch-style capacity dispatch) —
the JAX package's ``repro.models.moe`` on tensors.

Top-k routing with a static capacity per expert.  Small token counts
(decode steps, short prefills) dispatch and combine through one-hot
einsums; large ones scatter tokens into the (E, C, d) expert buffer and
gather them back.  The router is a named engine matmul (SA-FC in decode,
the SA-CONV GEMM in a large prefill); the expert FFN is a plain batched
product, as the reference computes it outside any Pallas kernel, and is
recorded on the engine as ``<name>.experts`` so the dispatch traces
compare.

Everything here also runs on ``meta`` tensors (schedule compilation).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import dataflow, engine
from repro_torch.core.quant import QTensor, dequantize
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.ref import apply_act
from repro_torch.models.layers import dense_init, truncated_normal
from repro_torch.models.mlp import init_mlp, mlp

# Above this token count the one-hot (T,E,C) dispatch einsums (memory
# O(T^2 k cf / E)) switch to the scatter path (memory O(TkE + ECd)); a
# copy of the reference's constant, as is the 2**24 bound on T*E*C.
_EINSUM_DISPATCH_MAX_T = 8192
_EINSUM_DISPATCH_MAX_TEC = 2 ** 24


def init_moe(cfg, gen: torch.Generator | None, d: int, ff: int, dtype,
             device, lead: tuple[int, ...] = ()) -> dict:
    """The fp32 router (d, E), the stacked expert weights (E, d, ff) and
    (E, ff, d) in ``dtype``, and the always-on ``shared`` expert where the
    config has one."""
    m = cfg.moe
    E = m.n_experts
    std = d ** -0.5
    p = {
        "router": dense_init(gen, d, E, torch.float32, device, lead),
        "wg": truncated_normal((*lead, E, d, ff), std, gen, dtype, device),
        "wu": truncated_normal((*lead, E, d, ff), std, gen, dtype, device),
        "wd": truncated_normal((*lead, E, ff, d), ff ** -0.5, gen, dtype,
                               device),
    }
    if m.shared_expert:
        p["shared"] = init_mlp(cfg, gen, d, ff, dtype, device, lead)
    return p


def _capacity(tokens: int, cfg) -> int:
    m = cfg.moe
    c = math.ceil(tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, min(tokens, ((c + 3) // 4) * 4))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(cfg, p: dict, xf: torch.Tensor, name: str):
    """Shared router: returns (vals (T,k), idx (T,k), aux loss).

    ``jax.lax.top_k`` puts the lower expert index first among equal gates;
    a stable descending sort does the same (``torch.topk`` promises no
    order among ties)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    logits = engine.current().matmul(xf.to(torch.float32), p["router"],
                                     name=f"{name}.router",
                                     out_dtype=torch.float32)
    gates = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(gates, dim=-1, descending=True, stable=True)
    vals, idx = srt[:, :k], order[:, :k]
    vals = vals / torch.sum(vals, -1, keepdim=True)
    top1 = _one_hot(idx[:, 0], E, torch.float32)
    aux = E * torch.sum(torch.mean(top1, 0) * torch.mean(gates, 0))
    return vals, idx, aux


def _position_in_expert(idx: torch.Tensor, E: int) -> torch.Tensor:
    """idx: (T,k) expert choices -> (T,k) arrival position within each
    expert's queue, choice-major priority (all first choices first)."""
    T, k = idx.shape
    flat_e = idx.t().reshape(k * T)                         # choice-major
    onehot = _one_hot(flat_e, E, torch.int64)               # (kT, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot
    pos_flat = pos_all.gather(1, flat_e[:, None])[:, 0]
    return pos_flat.reshape(k, T).t()                       # (T, k)


def _w(p: dict, key: str, cd) -> torch.Tensor:
    """Expert weight fetch, dequantizing int8 QTensors on the fly."""
    w = p[key]
    if isinstance(w, QTensor):
        return dequantize(w, cd)
    return w.to(cd)


def _record_experts(name: str, p: dict, m: int, k: int) -> None:
    """Record the expert products as the reference does: m rows a slot
    buffer, n = ff, k = d, no plan."""
    wg = p["wg"]
    n = (wg.q if isinstance(wg, QTensor) else wg).shape[-1]
    engine.current().record(name=f"{name}.experts",
                            regime=dataflow.classify_regime(m, n, k),
                            m=m, n=n, k=k, case=0, backend="torch")


def _experts(cfg, p: dict, xe: torch.Tensor, spec: str) -> torch.Tensor:
    """The per-expert SwiGLU/GeGLU of ``xe`` (..., E, C, d), ``spec`` its
    leading axes' einsum letters."""
    cd = xe.dtype
    act = "silu" if cfg.mlp == "swiglu" else "gelu"
    g = torch.einsum(f"{spec}cd,edf->{spec}cf", xe, _w(p, "wg", cd))
    u = torch.einsum(f"{spec}cd,edf->{spec}cf", xe, _w(p, "wu", cd))
    h = apply_act(g.to(torch.float32), act).to(cd) * u
    if spec == "ge":                 # the grouped buffer: ff over TP
        h = constrain(h, ("dp", None, None, "tp"))
    return torch.einsum(f"{spec}cf,efd->{spec}cd", h, _w(p, "wd", cd))


def _expert_ffn(cfg, p: dict, xe: torch.Tensor, name: str) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d) through the per-expert SwiGLU/GeGLU."""
    _record_experts(name, p, xe.shape[1], xe.shape[-1])
    return _experts(cfg, p, xe, "e")


def _moe_einsum(cfg, p: dict, xf: torch.Tensor, vals: torch.Tensor,
                idx: torch.Tensor, C: int, name: str) -> torch.Tensor:
    """One-hot dispatch/combine (small T: decode steps, tests)."""
    E = cfg.moe.n_experts
    f32 = torch.float32
    onehot = _one_hot(idx, E, f32)                          # (T, k, E)
    pos = _position_in_expert(idx, E)[..., None]            # (T, k, 1)
    pos_e = torch.where(onehot > 0, pos, C)                 # (T, k, E)
    keep = (pos_e < C).to(f32) * onehot
    slot = _one_hot(torch.clamp(pos_e, max=C - 1), C, f32)  # (T, k, E, C)
    dispatch = torch.einsum("tke,tkec->tec", keep, slot)
    combine = torch.einsum("tk,tke,tkec->tec", vals, keep, slot)
    cd = xf.dtype
    xe = torch.einsum("tec,td->ecd", dispatch.to(cd), xf)
    ye = _expert_ffn(cfg, p, xe, name)
    return torch.einsum("tec,ecd->td", combine.to(cd), ye)


def _moe_scatter(cfg, p: dict, xf: torch.Tensor, vals: torch.Tensor,
                 idx: torch.Tensor, C: int, name: str) -> torch.Tensor:
    """Scatter/gather dispatch for one group — linear memory."""
    return _moe_scatter_grouped(cfg, p, xf[None], vals[None], idx[None], C,
                                name)[0]


def _moe_scatter_grouped(cfg, p: dict, xg: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor, C: int,
                         name: str) -> torch.Tensor:
    """Grouped scatter dispatch: xg (G,Tg,d).  Group g writes the slots
    ``[g*E*C, (g+1)*E*C)`` of one flat buffer; a (token, choice) past its
    expert's capacity goes to one extra row past them, which is dropped
    (the reference's ``.at[].add(mode="drop")`` with its out-of-range
    sentinel), and reads back from an appended zero row (``.at[].get(
    mode="fill")``).  Every kept (token, choice) owns its slot, so each
    slot row receives at most one addition (the dropped pairs all land on
    the discarded extra row): ``index_add_``'s atomics on CUDA still give
    one deterministic result.  G is 1 outside a data-parallel activation
    mesh (:func:`_n_groups`)."""
    m = cfg.moe
    G, Tg, d = xg.shape
    E, k = m.n_experts, m.top_k
    cd = xg.dtype
    EC = E * C

    pos = torch.stack([_position_in_expert(i, E) for i in idx])  # (G,Tg,k)
    base = torch.arange(G, device=xg.device)[:, None, None] * EC
    dest = torch.where(pos < C, base + idx * C + pos, G * EC).reshape(-1)
    x_rep = xg[:, :, None, :].expand(G, Tg, k, d).reshape(G * Tg * k, d)
    buf = torch.zeros((G * EC + 1, d), dtype=cd, device=xg.device)
    buf.index_add_(0, dest, x_rep)
    xe = constrain(buf[:G * EC].reshape(G, E, C, d),
                   ("dp", None, None, None))

    _record_experts(name, p, C, d)
    ye = constrain(_experts(cfg, p, xe, "ge"), ("dp", None, None, None))
    ye = ye.reshape(G * EC, d)

    back = torch.cat([ye, ye.new_zeros((1, d))])[dest]
    back = back.reshape(G, Tg, k, d)
    return torch.einsum("gtk,gtkd->gtd", vals.to(cd), back)


def _n_groups(T: int, B: int) -> int:
    """Dispatch groups = data shards of the activation mesh, so tokens
    never cross the DP axis for routing (the Switch per-core capacity
    scheme); group boundaries follow the batch dim, which the DP sharding
    slices.  One group without a mesh (every served and trained path on
    the card), or where the batch does not divide."""
    mesh = SH.active_mesh()
    if mesh is None:
        return 1
    g = SH.dp_size(mesh)
    return g if (g > 1 and B % g == 0 and T % g == 0) else 1


def moe_block(cfg, p: dict, x: torch.Tensor,
              name: str = "moe") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_load_balance_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = _n_groups(T, B)
    Tg = T // G
    C = _capacity(Tg, cfg)
    xg = constrain(x.reshape(G, Tg, d), ("dp", None, None))

    vals, idx, aux = _route(cfg, p, xg.reshape(T, d), name)
    vals = vals.reshape(G, Tg, m.top_k)
    idx = idx.reshape(G, Tg, m.top_k)

    if Tg <= _EINSUM_DISPATCH_MAX_T and \
            Tg * m.n_experts * C <= _EINSUM_DISPATCH_MAX_TEC:
        # small per-group token counts (decode steps): one-hot dispatch
        out = torch.stack([_moe_einsum(cfg, p, xg[g], vals[g], idx[g], C,
                                       name) for g in range(G)])
    else:
        out = _moe_scatter_grouped(cfg, p, xg, vals, idx, C, name)
    out = out.reshape(B, S, d)
    if m.shared_expert:
        out = out + mlp(cfg, p["shared"], x, name=f"{name}.shared")
    return out, aux
