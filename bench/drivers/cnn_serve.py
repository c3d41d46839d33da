"""Entry kind ``cnn_serve``: single-image classification requests served by
the port's ``CNNServer`` (``repro_torch.serve.cnn_server``), the conv stage
on SA-CONV with its fused pools and the head on SA-FC.

Traffic (a cell's ``traffic_params``):

* ``"loop": "closed"``: chunks of ``chunk_waves`` full waves submitted and
  drained by ``CNNServer.run()`` (pipelined), the next chunk after the
  last one's answers, until the window has run ``--seconds``.
* ``"loop": "open"``: arrivals at a fixed rate (``bench/traffic.py``); due
  requests are submitted and ``CNNServer.step_wave()`` serves a wave
  whenever the queue holds any.  Requests still queued when the last one
  is due are drained and count.

Weights and images are drawn on the card from the seed; the images form a
pool of ``image_pool`` distinct ones that requests cycle through with
fresh uids.  Every delivered request's logits are compared after the
window with the plain reference's logits of its image
(``bench/reference/vgg.py``).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import traffic
from bench.harness import sync
from bench.reference import vgg as reference

#: the port's kernel libraries this entry runs (built in parallel first)
LIBS = ("sa_conv_implicit", "sa_fc", "pool_act")


def layer_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(kind, weight shape) of each entry of the network, in order, a pool
    after every block: the program's parameter layout."""
    out, res, ch, k = [], cfg["in_res"], cfg["in_ch"], cfg["kernel"]
    for reps, co in cfg["conv_blocks"]:
        for _ in range(reps):
            out.append(("conv", (k, k, ch, co)))
            ch = co
        out.append(("pool", ()))
        res //= cfg["pool"]
    fan_in = res * res * ch
    for n in cfg["fc"]:
        out.append(("fc", (fan_in, n)))
        fan_in = n
    return out


def make_weights(cfg: dict, seed: int, device) -> list:
    """The network's weights from the seed, drawn on ``device`` in three
    calls (filters, FC weights, biases) and split into one tensor a leaf:
    filters N(0, 2 / fan_in), FC weights truncated normal(+-3) times
    sqrt(2 / fan_in) (sqrt(1 / fan_in) for the last, which feeds no ReLU),
    biases N(0, 0.01^2)."""
    shapes = layer_shapes(cfg)
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(
        traffic.seed_of(seed, "cnn-weights"))
    conv_n = sum(int(np.prod(s)) for kind, s in shapes if kind == "conv")
    fc_n = sum(int(np.prod(s)) for kind, s in shapes if kind == "fc")
    bias_n = sum(s[-1] for kind, s in shapes if kind != "pool")
    filt = torch.randn(conv_n, generator=gen, device=device)
    fcw = torch.empty(fc_n, device=device)
    torch.nn.init.trunc_normal_(fcw, a=-3.0, b=3.0, generator=gen)
    bias = torch.randn(bias_n, generator=gen, device=device) * 0.01
    n_fc = sum(kind == "fc" for kind, _ in shapes)
    params, offs, fc_i = [], {"conv": 0, "fc": 0, "b": 0}, 0
    for kind, s in shapes:
        if kind == "pool":
            params.append({})
            continue
        n, fan_in = int(np.prod(s)), int(np.prod(s[:-1]))
        src = filt if kind == "conv" else fcw
        fc_i += kind == "fc"
        gain = 1.0 if fc_i == n_fc else 2.0
        w = src[offs[kind]:offs[kind] + n].view(s) * (gain / fan_in) ** 0.5
        b = bias[offs["b"]:offs["b"] + s[-1]]
        offs[kind] += n
        offs["b"] += s[-1]
        params.append({"f" if kind == "conv" else "w": w.to(dt).contiguous(),
                       "b": b.to(dt).contiguous()})
    return params


def make_images(cfg: dict, n: int, seed: int, device) -> np.ndarray:
    """``n`` distinct (h, w, c) float32 images, standard normal (the
    normalised pixels a classifier is fed), drawn on ``device``, on the
    host."""
    gen = torch.Generator(device=device).manual_seed(
        traffic.seed_of(seed, "images"))
    x = torch.randn((n, cfg["in_res"], cfg["in_res"], cfg["in_ch"]),
                    generator=gen, device=device)
    return x.cpu().numpy()


def _instrument(srv, tracer) -> None:
    """Host spans around the server's stages where it has them (for the
    traced run's idle gaps; a server without them runs as it is)."""
    if not tracer.on:
        return
    for attr, label in (("_to_device", "stack+copy"),
                        ("_conv_stage_dispatch", "conv dispatch"),
                        ("_fc_stage_complete", "fc dispatch+wait logits")):
        fn = getattr(srv, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with tracer.span(_label):
                return _fn(*a, **kw)
        setattr(srv, attr, wrapped)


class State:
    """One run of the entry: the server, its weights' seed, the image pool
    and what the window delivered."""

    def __init__(self, cfg, wl, seed, device, tracer):
        from repro_torch.serve.cnn_server import CNNRequest, CNNServer
        self.cfg, self.wl, self.seed, self.device = cfg, wl, seed, device
        self.tp = wl["traffic_params"]
        self.Request = CNNRequest
        params = make_weights(cfg, seed, device)
        self.pool = make_images(cfg, int(self.tp["image_pool"]), seed, device)
        self.srv = CNNServer(cfg["net"], params, in_res=cfg["in_res"],
                             in_ch=cfg["in_ch"],
                             width_mult=cfg.get("width_mult", 1.0),
                             max_batch=int(wl["server"]["max_batch"]),
                             dtype=getattr(torch, cfg["dtype"]),
                             pipeline=bool(wl["server"].get("pipelined",
                                                            True)),
                             device=device)
        _instrument(self.srv, tracer)
        self.next_uid = 0
        self.delivered: list = []          # (request, image index)
        self.attempted = 0
        self.failed = 0                    # a request is failed by check()

    def requests(self, images) -> list:
        out = []
        for i in images:
            out.append((self.Request(uid=self.next_uid,
                                     image=self.pool[int(i)]), int(i)))
            self.next_uid += 1
        return out


def setup(cfg: dict, wl: dict, seed: int, device, tracer) -> State:
    """Weights, images and the server; then every wave size the traffic
    uses, served once (schedules compiled, kernels loaded)."""
    st = State(cfg, wl, seed, device, tracer)
    mb = st.srv.microbatch
    sizes = ([mb] * 2 if st.tp["loop"] == "closed"
             else range(1, mb + 1))
    for b in sizes:
        for r, _ in st.requests(range(b)):
            st.srv.submit(r)
        st.srv.step_wave()
    if st.tp["loop"] == "closed":          # the pipelined path too
        for r, _ in st.requests(range(2 * mb)):
            st.srv.submit(r)
        st.srv.run()
    sync(device)
    st.waves_before = len(st.srv.waves)
    return st


def window(st: State, seconds: float, tracer) -> dict:
    return (_closed if st.tp["loop"] == "closed" else _open)(
        st, seconds, tracer)


def _closed(st: State, seconds: float, tracer) -> dict:
    srv, chunk = st.srv, int(st.tp["chunk_waves"]) * st.srv.microbatch
    sent = 0
    sync(st.device)
    t0 = time.perf_counter()
    while True:
        reqs = st.requests(traffic.closed_loop_images(st.tp, sent, chunk))
        sent += chunk
        with tracer.span("submit"):
            for r, _ in reqs:
                srv.submit(r)
        with tracer.span("run"):
            srv.run()
        st.delivered += reqs
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    st.attempted = sent
    return {"window_s": t1 - t0, "images": sent,
            "wave_batches": [w.batch for w in srv.waves[st.waves_before:]]}


def _open(st: State, seconds: float, tracer) -> dict:
    srv = st.srv
    due, images = traffic.open_loop(st.tp, st.seed, seconds)
    reqs = st.requests(images)
    n = len(reqs)
    start = np.full(n, np.nan)      # the step_wave call that served each
    done = np.full(n, np.nan)
    index = {r.uid: i for i, (r, _) in enumerate(reqs)}
    i = 0
    sync(st.device)
    t0 = time.perf_counter()
    while i < n or srv.queue:
        now = time.perf_counter() - t0
        while i < n and due[i] <= now:
            srv.submit(reqs[i][0])
            i += 1
        if srv.queue:
            t = time.perf_counter() - t0
            for r in srv.queue[:srv.microbatch]:
                start[index[r.uid]] = t
            with tracer.span("step_wave"):
                served = srv.step_wave()
            t = time.perf_counter() - t0
            for r in served:
                done[index[r.uid]] = t
        elif i < n:
            wait = due[i] - (time.perf_counter() - t0)
            if wait > 2e-4:
                time.sleep(wait - 1e-4)
    t1 = time.perf_counter()
    st.delivered = reqs
    st.attempted = n
    lat = (done - due) * 1e3
    return {"window_s": t1 - t0, "images": n,
            "latency_ms": lat.tolist(),
            "queue_wait_ms": ((start - due) * 1e3).tolist(),
            "wave_batches": [w.batch for w in srv.waves[st.waves_before:]]}


def check(st: State, limits: dict, *, control: bool = False) -> dict:
    """The compared numbers, each beside its limit: ``logit_gap``, the
    largest over delivered requests of max |logit - reference| / max
    |reference| of the request's image, and ``missing``, the requests
    that never came back.  ``control`` puts the reference's TF32 forward
    in the program's place.  The server is freed first."""
    got = [(r.logits, i) for r, i in st.delivered
           if r.done and r.logits is not None]
    missing = st.attempted - len(got)
    st.srv = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    layers = make_weights(st.cfg, st.seed, st.device)
    used = sorted({i for _, i in got})
    ref = {}
    block = 64
    for a in range(0, len(used), block):
        idx = used[a:a + block]
        x = torch.from_numpy(st.pool[idx]).to(st.device)
        want = reference.forward(st.cfg, layers, x).cpu().numpy()
        if control:
            y = reference.forward(st.cfg, layers, x, control=True)
            ctl = y.cpu().numpy()
        for j, img in enumerate(idx):
            ref[img] = (want[j], ctl[j] if control else None)
    gap = 0.0
    for logits, img in got:
        want, ctl = ref[img]
        y = ctl if control else logits
        scale = max(float(np.abs(want).max()), 1e-30)
        g = float(np.abs(np.asarray(y, np.float64) - want).max()) / scale
        gap = max(gap, g if np.isfinite(g) else np.inf)
    return {"logit_gap": {"value": gap, "limit": limits["logit_gap"]},
            "missing": {"value": missing, "limit": limits["missing"]}}
