"""Entry kind ``lm_train``: back-to-back steps of the port's donated train
step (``repro_torch.train.train_step.make_train_step(donate=True)``), as
``trainer.run`` calls it: draw the step's batch, run the step, read its
loss.

Set-up builds one train step with its state (the weights drawn on the
card from the seed), drives it through the first ``checked_steps`` steps
on batches that all differ, and hands the same step and state to the
window.  Of those first steps it keeps each loss, the first gradient as
the optimizer got it (read back from AdamW's first moment, ``m / (1 -
beta1)`` after one step) and the change of the weights after the last,
each gradient and change as one L2 norm per leaf: the embedding, and
each layer's slice of every stacked matrix.  After the window the plain
reference (``bench/reference/olmo.py``) takes the same steps from the same
weights and batches in fp32.

The window keeps the card fed while the host stands still: each batch is
copied to the card without a wait, and each step's loss is read
``ahead_steps`` steps late (the cell's ``traffic_params``), so that many
steps are dispatched ahead of the one the host waits for.  When its time
is up the window sends nothing more, reads every loss still pending and
only then reads the clock: all the steps sent count, over all that time.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import statistics
import time

import torch

from bench import traffic
from bench.harness import sync
from bench.reference import olmo as reference

LIBS = ("sa_conv", "sa_fc", "sa_fc_tc", "attention")

#: the program's tree path of each reference leaf
PATHS = {"embed": "embed", "wq": "blocks.0.attn.wq",
         "wk": "blocks.0.attn.wk", "wv": "blocks.0.attn.wv",
         "wo": "blocks.0.attn.wo", "wg": "blocks.0.mlp.wg",
         "wu": "blocks.0.mlp.wu", "wd": "blocks.0.mlp.wd"}


def leaf_shapes(m: dict) -> dict:
    """(shape, init std) of each reference leaf."""
    d, L, ff, V = m["d_model"], m["n_layers"], m["d_ff"], m["vocab_size"]
    hd = d // m["n_heads"]
    hq, hk = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return {"embed": ((V, d), d ** -0.5),
            "wq": ((L, d, hq), d ** -0.5), "wk": ((L, d, hk), d ** -0.5),
            "wv": ((L, d, hk), d ** -0.5), "wo": ((L, hq, d), hq ** -0.5),
            "wg": ((L, d, ff), d ** -0.5), "wu": ((L, d, ff), d ** -0.5),
            "wd": ((L, ff, d), ff ** -0.5)}


def draw_leaf(m: dict, name: str, seed: int, device, dtype) -> torch.Tensor:
    """One leaf from the seed: truncated normal(+-3) times its std, drawn
    in one call on ``device`` from the leaf's own generator, rounded once
    to the configuration's parameter type and returned in ``dtype``."""
    shape, std = leaf_shapes(m)[name]
    gen = torch.Generator(device=device).manual_seed(
        traffic.seed_of(seed, "lm-weights", name))
    t = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=gen)
    t.mul_(std)
    return t.to(getattr(torch, m["param_dtype"])).to(dtype)


def program_params(mc, m: dict, seed: int, device) -> dict:
    """The program's parameter tree holding the benchmark's weights; its
    layout is checked against the program's own (drawn on ``meta``)."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    dt = getattr(torch, m["param_dtype"])
    like = T.init_params(mc, 0, device="meta")
    leaves = {PATHS[k]: draw_leaf(m, k, seed, device, dt) for k in PATHS}
    if mc.tie_embeddings:
        leaves["embed_t"] = leaves["embed"].t().contiguous()
    got = dict(tree.flatten_with_paths(like))
    if set(got) != set(leaves) or any(
            tuple(got[p].shape) != tuple(leaves[p].shape) for p in got):
        raise ValueError("the benchmark's weights do not match the "
                         f"program's layout: {sorted(got)}")
    return tree.unflatten(like, [leaves[p] for p, _ in
                                 tree.flatten_with_paths(like)])


def slice_norms(name: str, t: torch.Tensor) -> dict:
    """L2 norm of each leaf of ``t``: the embedding whole, a stacked
    matrix one layer at a time."""
    t = t.to(torch.float32)
    if name == "embed":
        return {name: float(torch.linalg.vector_norm(t))}
    return {f"{name}.{i}": float(torch.linalg.vector_norm(t[i]))
            for i in range(t.shape[0])}


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cfg["model"])


def train_config(cfg: dict, wl: dict):
    from repro_torch.configs.base import TrainConfig
    tp, opt = wl["traffic_params"], cfg["optimizer"]
    return TrainConfig(global_batch=tp["global_batch"], seq_len=tp["seq_len"],
                       lr=opt["lr"], warmup_steps=opt["warmup_steps"],
                       total_steps=opt["total_steps"],
                       weight_decay=opt["weight_decay"],
                       grad_clip=opt["grad_clip"], beta1=opt["beta1"],
                       beta2=opt["beta2"], eps=opt["eps"],
                       moment_dtype=opt["moment_dtype"],
                       remat=wl["train"]["remat"])


@dataclasses.dataclass
class State:
    cfg: dict
    wl: dict
    seed: int
    device: torch.device
    step_fn: object = None
    state: tuple | None = None
    step: int = 0
    losses: list = dataclasses.field(default_factory=list)
    grad_norms: dict = dataclasses.field(default_factory=dict)
    change_norms: dict = dataclasses.field(default_factory=dict)
    warm_enqueue_s: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0

    def batch(self, step: int) -> torch.Tensor:
        tp, m = self.wl["traffic_params"], self.cfg["model"]
        return traffic.lm_batch(self.seed, step, m["vocab_size"],
                                tp["global_batch"], tp["seq_len"])


def _enqueue(st: State, tracer):
    """Send one step: its batch copied to the card without a wait (from
    pinned memory), then the step's call.  Returns its loss, still on the
    card, and the host seconds the call took."""
    tokens = st.batch(st.step)
    if st.device.type == "cuda":
        tokens = tokens.pin_memory().to(st.device, non_blocking=True)
    with tracer.span("enqueue step"):
        t0 = time.perf_counter()
        params, opt, cs, met = st.step_fn(*st.state, {"tokens": tokens})
        enq = time.perf_counter() - t0
    st.state = (params, opt, cs)
    st.step += 1
    return met["loss"], enq


def _later(loss):
    """A loss to be read later without waiting for the whole stream (a
    tensor's own read waits for every step sent since): on the card, copied
    into pinned memory with an event recorded behind it."""
    if loss.device.type != "cuda":
        return loss, None
    host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
    host.copy_(loss.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _read(later, tracer) -> float:
    """Wait for the step behind ``later`` (only that far) and read it."""
    loss, done = later
    with tracer.span("read loss"):
        if done is not None:
            done.synchronize()
        return float(loss)


def setup(cfg: dict, wl: dict, seed: int, device, tracer) -> State:
    from repro_torch.core import tree
    from repro_torch.core.engine import Engine
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, grad_compress
    from repro_torch.train import train_step as TS
    m = cfg["model"]
    mc, tc = model_config(cfg), train_config(cfg, wl)
    st = State(cfg, wl, seed, device)
    params = program_params(mc, m, seed, device)
    tp = T.trainable(params)
    opt = adamw.init(tp, tc)
    cs = grad_compress.CompressState(error=tree.map_leaves(
        lambda p: torch.zeros((), dtype=torch.float32, device=p.device), tp))
    st.step_fn = TS.make_train_step(mc, tc, engine=Engine(backend="kernels"),
                                    donate=bool(wl["train"]["donate"]))
    st.state = (params, opt, cs)
    del params, tp, opt, cs
    b1 = cfg["optimizer"]["beta1"]
    for i in range(int(wl["traffic_params"]["checked_steps"])):
        loss, enq = _enqueue(st, tracer)
        st.losses.append(_read(_later(loss), tracer))
        if i:
            st.warm_enqueue_s.append(enq)
        if st.step == 1:
            mom = dict(tree.flatten_with_paths(st.state[1].m))
            for k, p in PATHS.items():
                st.grad_norms.update(slice_norms(k, mom[p] / (1 - b1)))
    now = dict(tree.flatten_with_paths(T.trainable(st.state[0])))
    for k, p in PATHS.items():
        p0 = draw_leaf(m, k, seed, device, torch.float32)
        st.change_norms.update(slice_norms(k, now[p].to(torch.float32) - p0))
        del p0
    sync(device)
    return st


def window(st: State, seconds: float, tracer) -> dict:
    tokens = st.wl["traffic_params"]["global_batch"] * \
        st.wl["traffic_params"]["seq_len"]
    ahead = int(st.wl["traffic_params"]["ahead_steps"])
    pending = collections.deque()
    steps, bad = 0, 0

    def read_oldest():
        loss = _read(pending.popleft(), tracer)
        return not (loss == loss and abs(loss) != float("inf"))

    sync(st.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        pending.append(_later(_enqueue(st, tracer)[0]))
        steps += 1
        if len(pending) > ahead:
            bad += read_oldest()
    while pending:
        bad += read_oldest()
    sync(st.device)
    t1 = time.perf_counter()
    st.attempted, st.failed = steps, bad
    return {"window_s": t1 - t0, "steps": steps, "tokens": steps * tokens,
            "warm_enqueue_s": list(st.warm_enqueue_s)}


def worst_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = statistics.median(ref.values())
    keys = [k for k in ref if keep is None or keep(k)]
    gaps = [abs(prog.get(k, float("nan")) - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys]
    return max((g if g == g else float("inf")) for g in gaps)


def reference_readings(st: State, *, mm=reference.plain_mm, rows=None
                       ) -> dict:
    """The reference's losses, first clipped gradient norms and change
    norms over the checked steps, from the seed's weights in fp32."""
    m = st.cfg["model"]
    opt = dict(st.cfg["optimizer"])
    w = {k: draw_leaf(m, k, st.seed, st.device, torch.float32)
         for k in PATHS}
    grads = {}

    def first(g):
        for k in reference.LEAVES:
            grads.update(slice_norms(k, g[k]))

    n = int(st.wl["traffic_params"]["checked_steps"])
    batches = [st.batch(s).to(st.device) for s in range(n)]
    losses = reference.train(m, w, batches, opt, mm=mm, rows=rows,
                             on_first_grads=first)
    change = {}
    for k in PATHS:
        p0 = draw_leaf(m, k, st.seed, st.device, torch.float32)
        change.update(slice_norms(k, w[k] - p0))
        del p0
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def compare(prog: dict, ref: dict) -> dict:
    """The three compared numbers of one reading against the reference's:
    the largest loss gap over the checked steps (nats), and the worst
    leaf's gaps of the first gradient and of the change.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    rounding alone and are left out of the change."""
    med = statistics.median(ref["grad_norms"].values())
    live = {k for k, v in ref["grad_norms"].items() if v >= 1e-3 * med}
    loss = max(abs(a - b) if a == a else float("inf")
               for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss,
            "grad_gap": worst_gap(prog["grad_norms"], ref["grad_norms"]),
            "change_gap": worst_gap(prog["change_norms"],
                                    ref["change_norms"],
                                    keep=lambda k: k in live)}


def program_readings(st: State) -> dict:
    return {"losses": st.losses, "grad_norms": st.grad_norms,
            "change_norms": st.change_norms}


def free(st: State) -> None:
    st.state = st.step_fn = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def check(st: State, limits: dict, *, control: bool = False) -> dict:
    """The compared numbers, each beside its limit: those of
    :func:`compare` that the cell's limits name, and ``failed_steps``.
    The program's state is freed first.  ``control`` puts the reference's
    fp8 step in the program's place."""
    free(st)
    ref = reference_readings(st)
    got = (reference_readings(st, mm=reference.fp8_mm) if control
           else program_readings(st))
    vals = {**compare(got, ref), "failed_steps": st.failed}
    return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()
            if k in limits}
