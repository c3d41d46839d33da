"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C entry
point, compiled for ``sm_90a`` into ``build/repro_torch/`` at the repo root
(ignored by git) under a name keyed by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.  Libraries are
built at first use; :func:`build` starts one ``nvcc`` per source, all at
once.  A missing ``nvcc`` or a failed build raises: nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` turns a non-zero code into an exception.  Each library also
exports a shared-memory query (:data:`SMEM_SIGNATURES`,
:func:`smem_query`): the bytes its launch passes for given arguments.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("sa_fc", "sa_fc_tc", "sa_conv_implicit", "pool_act",
           "sa_conv", "attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: further nvcc flags of one library: the SA-CONV GEMM's tensor-core
#: instantiations made it the longest build, so its kernels are compiled
#: in parallel (``-split-compile=0``: as many threads as the machine has;
#: the same registers and spills as one thread gives), and so are SA-CONV
#: implicit's FMA and tensor-core instantiations, and SA-FC's tensor-core
#: ones
LIB_FLAGS = {"sa_conv": ("-split-compile=0",),
             "sa_conv_implicit": ("-split-compile=0",),
             "sa_fc_tc": ("-split-compile=0",)}

#: activation codes of csrc/common.cuh
ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "silu": 3, "gelu": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C signature (argument types) of each library's launch function
SIGNATURES = {
    "sa_fc": ("sa_fc_launch",
              (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P) + (_I,) * 7 + (_P,)),
    "sa_fc_tc": ("sa_fc_tc_launch",
                 (_P, _P, _I, _I, _P, _P, _P, _P, _P) + (_I,) * 7 + (_P,)),
    "sa_conv_implicit": ("sa_conv_implicit_launch",
                         (_P, _I, _I, _P, _I, _P, _P, _P) + (_I,) * 18
                         + (_P, _P, _P)),
    "pool_act": ("pool_act_launch", (_P, _P) + (_I,) * 10 + (_P,)),
    "sa_conv": ("sa_conv_launch",
                (_P, _P, _I, _I, _I, _P, _P, _P) + (_I,) * 6 + (_P,)),
    "attention": ("flash_attention_launch",
                  (_P,) * 4 + (_I,) * 7 + (_L,) * 9
                  + (_I, _I, _F, _F, _I, _I, _P)),
}

#: each library's shared-memory query: the dynamic shared memory (bytes)
#: its launch passes for the launch's arguments, -1 where it has no
#: instantiation (repro_torch/analysis/launch.py derives the same figures)
SMEM_SIGNATURES = {
    "sa_fc": ("sa_fc_smem", (_I,) * 3),
    "sa_fc_tc": ("sa_fc_tc_smem", (_I,) * 7),
    "sa_conv_implicit": ("sa_conv_implicit_smem", (_I,) * 9),
    "pool_act": ("pool_act_smem", (_I,) * 2),
    "sa_conv": ("sa_conv_smem", (_I,) * 2),
    "attention": ("flash_smem", (_I,) * 3),
}

#: further exported queries of a library, bound beside those two: the
#: GEMM's producer for given operands (1 TMA, 0 cp.async, -1 the FMA
#: loop), what kernels/sa_conv.py ``tma_ok`` derives
QUERY_SIGNATURES = {
    "sa_conv": (("sa_conv_producer", (_P, _P, _I, _I, _I, _I)),),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin/ on PATH)")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for part in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LIB_FLAGS.get(name, ())).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_log(name: str) -> str:
    """What ``nvcc``/``ptxas -v`` printed when the library was built
    (registers, shared memory and spills of each kernel)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, float]:
    """Build the named libraries that are missing, one ``nvcc`` process per
    source, all started together; returns the seconds each library took to
    build, from the common start to its own process's end."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_name(f"{out.name}.{os.getpid()}.log.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *LIB_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT),
                           tmp, out, log)
    seconds, failed = {}, []
    while len(seconds) < len(procs):
        for name, (proc, tmp, out, log) in procs.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            text = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{text}")
                continue
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in (SIGNATURES[name],
                                      SMEM_SIGNATURES[name],
                                      *QUERY_SIGNATURES.get(name, ())):
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def smem_query(name: str, *args: int) -> int:
    """The dynamic shared memory library ``name``'s launch passes for
    ``args`` (its :data:`SMEM_SIGNATURES` query), built first if missing."""
    fn_name, _ = SMEM_SIGNATURES[name]
    return getattr(load(name), fn_name)(*args)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def act_code(act: str) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    return ACT_CODES[act]
