"""Hardware descriptions.

Three machines appear in the port:

* :data:`MPNA_PAPER` — the ASIC of the paper (Table II/III), kept as data.
* :data:`TPU_V5E` — the planning constants the dataflow planner
  (:mod:`repro_torch.core.dataflow`) costs its plans with.  They are a copy
  of the JAX package's planner model, kept under the same names so that the
  port's plans (regime, pool fusion, serving micro-batch) equal the
  reference's field for field.  They describe no property of the card the
  port runs on; re-planning for that card is later work.
* :func:`gpu_card` — what the CUDA device actually is, read from
  ``torch.cuda.get_device_properties`` at run time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SystolicArray:
    rows: int    # K — contraction tile held per column
    cols: int    # L — parallel filters / output channels
    # SA-FC has per-PE weight buses (weights replaced every cycle);
    # SA-CONV streams weights through the array (K-cycle refill),
    # hidden by the double-buffer register after the first tile.
    dedicated_weight_buses: bool = False

    @property
    def macs_per_cycle(self) -> int:
        return self.rows * self.cols


@dataclass(frozen=True)
class MPNAConfig:
    """Paper Table II."""
    sa_conv: SystolicArray = SystolicArray(8, 8, dedicated_weight_buses=False)
    sa_fc: SystolicArray = SystolicArray(8, 8, dedicated_weight_buses=True)
    spm_bytes: int = 256              # per accumulation sub-unit
    weight_buffer_bytes: int = 36 * 1024
    data_buffer_bytes: int = 256 * 1024
    dram_bandwidth: float = 12.8e9    # B/s   [16]
    frequency: float = 280e6          # Hz
    weight_bytes: int = 1             # 8-bit fixed point
    act_bytes: int = 1
    # published physical numbers (28 nm synthesis), used as constants
    power_w: float = 0.239
    area_mm2: float = 2.34

    @property
    def dram_bytes_per_cycle(self) -> float:
        return self.dram_bandwidth / self.frequency


#: Energy per operation class, pJ (28/32 nm-scaled, Horowitz ISSCC'14 style).
ENERGY_PJ = {
    "dram_byte": 160.0,
    "sram_byte": 1.25,
    "spm_byte": 0.6,
    "mac8": 0.2,
}


@dataclass(frozen=True)
class TPUChip:
    """The planner's cost model (copied field for field from the JAX
    package).  Only the ratio ``peak_flops_bf16 / hbm_bandwidth`` (the
    regime threshold) and ``vmem_budget`` (the tile budget) reach a plan;
    the wave costs of :mod:`repro_torch.core.perf_model` read the rates
    too, as the reference's TPU roofline."""
    peak_flops_bf16: float = 197e12
    hbm_bandwidth: float = 819e9
    ici_link_bandwidth: float = 50e9
    ici_links: int = 4
    hbm_bytes: int = 16 * 1024**3
    vmem_bytes: int = 128 * 1024**2
    vmem_budget: int = 96 * 1024**2

    @property
    def ridge_flops_per_byte(self) -> float:
        """Arithmetic-intensity threshold of the SA-CONV/SA-FC dispatch."""
        return self.peak_flops_bf16 / self.hbm_bandwidth

    @property
    def ici_broadcast_bandwidth(self) -> float:
        """One-to-all broadcast rate of the mesh (``2 * ici_links``
        edge-disjoint trees at the link rate), as the cost model of a
        cooperative sharded wave
        (:func:`repro_torch.core.perf_model.sharded_wave_cost`) reads it."""
        return 2 * self.ici_links * self.ici_link_bandwidth


MPNA_PAPER = MPNAConfig()
TPU_V5E = TPUChip()


@dataclass(frozen=True)
class GPUCard:
    """One CUDA device as the kernels see it."""
    name: str
    sm_count: int
    smem_per_block_optin: int         # bytes of dynamic shared memory a CTA may use
    capability: tuple[int, int]


def gpu_card(index: int = 0) -> GPUCard:
    """Read the card's name, SM count and opt-in shared memory per block.
    Raises where there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("gpu_card: no CUDA device is available")
    props = torch.cuda.get_device_properties(index)
    return GPUCard(name=props.name, sm_count=props.multi_processor_count,
                   smem_per_block_optin=props.shared_memory_per_block_optin,
                   capability=(props.major, props.minor))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Asking for CUDA where there is none raises; nothing falls
    back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
