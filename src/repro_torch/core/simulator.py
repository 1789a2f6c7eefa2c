"""Hardware description for the migration cost model (the port's copy of
the ``HardwareConfig`` dataclass and the ``A100_PCIE`` preset of the JAX
package's ``core/simulator.py``).

The continuous engine costs a re-plan's weight movement on
``A100_PCIE.link_bw`` (64 GB/s, the paper's Fig 7 PCIe point) when no
controller supplies the deployment's hardware, as the JAX engine does.
That stall is the paper's modelled deployment, not a measurement of the
card the port runs on. The rest of the simulator comes with the GPS
decision loop.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareConfig:
    name: str
    num_devices: int
    peak_flops: float            # per device, bf16/fp16 FLOP/s
    hbm_bw: float                # per device, bytes/s
    link_bw: float               # per device interconnect bandwidth, bytes/s
    mxu_util: float = 0.7        # achievable fraction of peak on big GEMMs
    topology: str = "fully_connected"   # fully_connected | torus2d
    torus_links_per_axis: int = 2

    def with_(self, **kw) -> "HardwareConfig":
        return dataclasses.replace(self, **kw)


# Paper validation point: 4x A100 (312 TF/s bf16, 2.0 TB/s HBM) fully
# connected over PCIe 4.0 (Fig 7 uses 64 GB/s).
A100_PCIE = HardwareConfig("4xA100-PCIe", 4, 312e12, 2.0e12, 64e9)
