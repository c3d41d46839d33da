"""The port's launchers leave the caller's process as they found it (C9).

The tests call the launchers' ``main`` in process, and pytest-xdist runs
the next test file of a worker in that same process: a launcher that
turned autograd off for good made a later file's backward fail
(``tests/test_torch_cnn_server.py::test_unported_routes_raise``) on every
run whose files lined up that way.  Each launcher runs here at the tests'
small size on the CPU, once to its end and once raising from inside its
body, and grad mode must be what it was.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.engine import Engine
from repro_torch.launch import fleet as lfleet
from repro_torch.launch import serve as lserve
from repro_torch.launch import train as ltrain
from repro_torch.launch import zoo as lzoo
from repro_torch.models import transformer as T
from repro_torch.train import trainer

#: launcher, its arguments at the tests' small size, and a (module, name)
#: its body calls, which the raising case replaces with a function that
#: raises
LAUNCHERS = {
    "zoo": (lzoo, ["--device", "cpu", "--width-mult", "0.125",
                   "--reduced-res", "--per-tenant", "1", "--max-batch", "2"],
            (lzoo, "build_zoo")),
    "fleet": (lfleet, ["--device", "cpu", "--width-mult", "0.0625",
                       "--reduced-res", "--max-batch", "4"],
              (lfleet, "build_zoo")),
    "serve": (lserve, ["--arch", "olmo-1b", "--device", "cpu",
                       "--requests", "2", "--max-new", "2"],
              (T, "init_params")),
    "train": (ltrain, ["--arch", "olmo-1b", "--device", "cpu", "--reduced",
                       "--steps", "1", "--batch", "2", "--seq", "16"],
              (trainer, "run")),
}


class _Planted(RuntimeError):
    pass


def _raise(*args, **kwargs):
    raise _Planted("planted failure inside the launcher's body")


@pytest.mark.parametrize("outcome", ["returns", "raises"])
@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launchers_leave_grad_mode_as_they_found_it(name, outcome,
                                                    monkeypatch, capsys):
    module, argv, (target, attr) = LAUNCHERS[name]
    assert torch.is_grad_enabled()
    if outcome == "raises":
        monkeypatch.setattr(target, attr, _raise)
        with pytest.raises(_Planted):
            module.main(argv)
    else:
        module.main(argv)
    capsys.readouterr()
    assert torch.is_grad_enabled(), f"{name}.main left autograd off"


def test_backward_runs_after_the_zoo_launcher(capsys):
    """The order that failed: the zoo launcher, then the matmul backward of
    ``test_unported_routes_raise`` in the same process (kernels and torch
    backends, equal gradients)."""
    lzoo.main(LAUNCHERS["zoo"][1])
    capsys.readouterr()
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((4, 32)).astype(np.float32)
    wn = rng.standard_normal((32, 16)).astype(np.float32)
    grads = []
    for backend in ("kernels", "torch"):
        x = torch.from_numpy(xn).requires_grad_()
        w = torch.from_numpy(wn).requires_grad_()
        y = Engine(backend=backend).matmul(x, w, act="relu", name="fc")
        grads.append(torch.autograd.grad((y * y).sum(), (x, w)))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
