"""repro_torch — the PyTorch/CUDA port of :mod:`repro` (MPNA's
heterogeneous systolic dataflows) for one NVIDIA Hopper card.

The layout mirrors the JAX package module for module (``core/``,
``kernels/``, ``models/``, ``serve/``).  Plain tensor code is PyTorch; every
TPU kernel on the CNN serving path is a CUDA C++ kernel written for
``sm_90a`` (``kernels/csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes``.  The package imports neither JAX nor :mod:`repro`.
"""

__version__ = "0.1.0"
