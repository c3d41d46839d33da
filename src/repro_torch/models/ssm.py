"""Mamba2 blocks of the port — the SSD (state-space duality) chunked
algorithm, the JAX package's ``repro.models.ssm`` on tensors.

Prefill uses the chunked SSD decomposition of arXiv:2405.21060: within a
chunk the output is a masked quadratic (attention-like) term; across
chunks the state is carried by the chunk *summaries*.  The reference runs
that inter-chunk recurrence as a ``lax.associative_scan``; here it is a
sequential fp32 loop over chunks, of which there are few (2 for a
512-token prompt at chunk 256).  Decode is the O(1) recurrent step on the
cached state (:func:`repro_torch.kernels.ref.ssd`, one step).

Everything here also runs on ``meta`` tensors (schedule compilation):
no value is read back to the host and no branch depends on data.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import engine
from repro_torch.kernels import ref
from repro_torch.models.layers import dense_init, rmsnorm


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_mamba(cfg, gen: torch.Generator | None, dtype, device,
               lead: tuple[int, ...] = ()) -> dict:
    """The reference's shapes and dtypes: the two projections in ``dtype``,
    the conv, ``dt_bias``, ``a_log`` and ``norm_w`` in fp32."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, ns, cw = s.d_inner(d), s.n_heads(d), s.d_state, s.conv_width
    f32 = torch.float32

    def uniform(lo: float, hi: float) -> torch.Tensor:
        u = torch.rand((*lead, nh), generator=gen, dtype=f32, device=device)
        return lo + (hi - lo) * u

    # in_proj -> [z(di), x(di), B(ns), C(ns), dt(nh)]
    in_proj = dense_init(gen, d, 2 * di + 2 * ns + nh, dtype, device, lead)
    conv_w = torch.randn((*lead, cw, di + 2 * ns), generator=gen, dtype=f32,
                         device=device) * cw ** -0.5
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((*lead, di + 2 * ns), dtype=f32, device=device),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 1e-1))),  # softplus^-1
        "a_log": torch.log(uniform(1.0, 16.0)),
        "norm_w": torch.zeros((*lead, di), dtype=f32, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device, lead),
    }


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                init_state: torch.Tensor | None = None,
                return_state: bool = False):
    """Same contract as :func:`repro_torch.kernels.ref.ssd`, chunk-parallel.

    x: (B,S,H,D); dt: (B,S,H); a: (H,); b,c: (B,S,N); state: (B,H,D,N)."""
    Bt, S, H, D = x.shape
    N = b.shape[-1]
    pad = (-S) % chunk
    if pad:                                 # the seq axis, from the end
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, b, c = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b, c))
    nc = (S + pad) // chunk

    f32 = torch.float32
    xc = x.to(f32).reshape(Bt, nc, chunk, H, D)
    dtc = dt.to(f32).reshape(Bt, nc, chunk, H)
    bc = b.to(f32).reshape(Bt, nc, chunk, N)
    cc = c.to(f32).reshape(Bt, nc, chunk, N)

    dA = dtc * a.to(f32)[None, None, None, :]               # (B,nc,c,H) <= 0
    cum = torch.cumsum(dA, dim=2)                           # inclusive

    # ---- intra-chunk (masked quadratic) --------------------------------
    # decay[t,s] = exp(cum[t]-cum[s]) for s <= t, else 0.  Above the
    # diagonal rel >= 0 and reaches +inf in fp32 at published sizes (a
    # 256-step span of dt*|A| passes 88.7), so rel is masked to -inf before
    # the exp: the same values as the reference's where(mask, exp(rel), 0)
    # (exp(-inf) == 0), and a backward with no 0 * inf in it.
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,t,s,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    decay = torch.exp(rel.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bztn,bzsn->bzts", cc, bc)            # (B,nc,t,s)
    dx = dtc[..., None] * xc                                # (B,nc,c,H,D)
    y = torch.einsum("bzts,bztsh,bzshd->bzthd", cb, decay, dx)

    # ---- chunk summaries + inter-chunk recurrence ----------------------
    # state contribution of chunk z: sum_s exp(cum_end - cum_s) dx_s b_s^T
    edge = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,c,H)
    states = torch.einsum("bzsh,bzshd,bzsn->bzhdn", edge, dx, bc)
    total = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)

    h = (torch.zeros((Bt, H, D, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    entering = []                                           # state entering z
    for z in range(nc):
        entering.append(h)
        h = h * total[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(entering, 1)                       # (B,nc,H,D,N)

    # ---- inter-chunk contribution --------------------------------------
    inflow = torch.exp(cum)                                 # decay since entry
    y = y + torch.einsum("bztn,bzth,bzhdn->bzthd", cc, inflow, h_prev)

    y = y.reshape(Bt, nc * chunk, H, D)[:, :S].to(x.dtype)
    if return_state:
        return y, h
    return y


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def _split(cfg, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d = cfg.d_model
    di, ns, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns:]
    return z, xbc, dt, di, ns, nh


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 prev: torch.Tensor | None = None):
    """Depthwise causal conv in fp32, ``sum(x[i] w[i]) + bias`` in the
    reference's order; ``prev`` is the (B, cw-1, ch) decode tail."""
    cw = w.shape[0]
    if prev is not None:
        xin = torch.cat([prev, xbc], dim=1)
    else:
        xin = F.pad(xbc, (0, 0, cw - 1, 0))
    out = sum(xin[:, i:i + xbc.shape[1], :].to(torch.float32) * w[i]
              for i in range(cw)) + bias
    tail = xin[:, -(cw - 1):, :]
    return F.silu(out).to(xbc.dtype), tail


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` for every x, as ``jax.nn.softplus`` computes it
    (``F.softplus`` returns ``x`` itself above 20, another function)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_forward(cfg, p: dict, x: torch.Tensor, *,
                  cache: dict | None = None, return_cache: bool = False):
    """x: (B,S,d).  ``cache={'conv': (B,cw-1,ch), 'h': (B,H,D,N)}`` for
    decode.  Returns (out, new cache or None); the new cache holds fresh
    tensors (the caller writes them into its cache)."""
    eng = engine.current()
    s = cfg.ssm
    zxbcdt = eng.matmul(x, p["in_proj"], name="ssm.in_proj")
    z, xbc, dt, di, ns, nh = _split(cfg, zxbcdt)
    hd = s.head_dim

    prev = cache["conv"] if cache is not None else None
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], prev)
    xin, bm, cm = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]

    B_, S_ = x.shape[:2]
    xh = xin.reshape(B_, S_, nh, hd)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    h0 = cache["h"] if cache is not None else None
    if cache is not None and S_ == 1:
        # O(1) recurrent decode step (the oracle recurrence, one step)
        y, h = ref.ssd(xh, dt, a, bm, cm, init_state=h0, return_state=True)
    else:
        y, h = ssd_chunked(xh, dt, a, bm, cm, chunk=s.chunk, init_state=h0,
                           return_state=True)

    y = y.reshape(B_, S_, di)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm_w"])
    out = eng.matmul(y, p["out_proj"], name="ssm.out_proj")
    if return_cache or cache is not None:
        return out, {"conv": conv_tail, "h": h}
    return out, None


def init_mamba_cache(cfg, batch: int, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict:
    """An empty decode cache: the conv tail in ``dtype``, the state in
    fp32."""
    s = cfg.ssm
    d = cfg.d_model
    di, ns, nh = s.d_inner(d), s.d_state, s.n_heads(d)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
        "h": torch.zeros((*lead, batch, nh, s.head_dim, ns),
                         dtype=torch.float32, device=device),
    }
