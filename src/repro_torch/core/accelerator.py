"""Hardware descriptions.

Three machines appear in the port:

* :data:`MPNA_PAPER` — the ASIC of the paper (Table II/III), kept as data.
* :data:`TPU_V5E` — the planning constants the dataflow planner
  (:mod:`repro_torch.core.dataflow`) costs its plans with.  They are a copy
  of the JAX package's planner model, kept under the same names so that the
  port's plans (regime, pool fusion, serving micro-batch) equal the
  reference's field for field.  They describe no property of the card the
  port runs on; re-planning for that card is later work.
* :data:`H100_SXM` — the card's data-sheet rates, which the roofline of
  a whole step (:mod:`repro_torch.core.roofline`) and the dry run
  (:mod:`repro_torch.launch.dryrun`) divide by.
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

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        """The roofline's compute rate: the reference's model has one
        (bf16) for every dtype."""
        return self.peak_flops_bf16

    def link_bandwidth(self, mesh=None, axis: str | None = None) -> float:
        """Wire rate of one mesh axis: one ICI link for every axis."""
        return self.ici_link_bandwidth


@dataclass(frozen=True)
class GPUChip:
    """A GPU's rates for the roofline of a whole step.  Every field is a
    data-sheet figure except ``internode_bandwidth``, which is an
    assumption about the cluster, not the card."""
    name: str
    peak_flops_bf16: float            # dense tensor-core bf16, FLOP/s
    peak_flops_fp32: float            # fp32 (no TF32), FLOP/s
    hbm_bandwidth: float              # B/s
    hbm_bytes: int
    nvlink_bandwidth: float           # B/s per direction per GPU
    node_gpus: int                    # GPUs one NVLink switch joins
    internode_bandwidth: float        # B/s per GPU between nodes

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        return self.peak_flops_fp32 if dtype == "float32" else \
            self.peak_flops_bf16

    def link_bandwidth(self, mesh=None, axis: str | None = None) -> float:
        """Wire rate of one axis of ``mesh`` (the last axis fastest, as
        devices are numbered): NVLink where the axis and every axis inside
        it fit one node, else the inter-node rate (also without a mesh)."""
        if mesh is None or axis is None:
            return self.internode_bandwidth
        names = list(mesh.axis_names)
        inner = 1
        for a in names[names.index(axis):]:
            inner *= mesh.shape[a]
        return self.nvlink_bandwidth if inner <= self.node_gpus else \
            self.internode_bandwidth


MPNA_PAPER = MPNAConfig()
TPU_V5E = TPUChip()
#: NVIDIA H100 SXM5 80 GB, the data sheet's dense figures: 989 TFLOP/s
#: bf16 and 67 TFLOP/s fp32, 3.35 TB/s of HBM3, 80 GB, NVLink 4 at 900
#: GB/s both ways (450e9 B/s each way) among the 8 GPUs of an HGX node;
#: between nodes the assumption of one 400 Gb/s NIC per GPU (50e9 B/s)
H100_SXM = GPUChip(name="H100 SXM", peak_flops_bf16=989e12,
                   peak_flops_fp32=67e12, hbm_bandwidth=3.35e12,
                   hbm_bytes=80 * 10**9, nvlink_bandwidth=450e9,
                   node_gpus=8, internode_bandwidth=50e9)


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
