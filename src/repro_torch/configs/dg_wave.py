"""The paper's own evaluation problem (the ``dg-paper`` scenario): DGSEM
coupled elastic-acoustic wave propagation on a brick with a centered
material discontinuity (Fig 6.1), order N=7, 8192 elements per node
(Table 6.1)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class DGConfig:
    order: int = 7
    grid: tuple = (32, 16, 16)          # 8192 elements (one node's share)
    n_nodes: int = 1                    # level-1 partitions
    accel_ratio: float = 1.6            # published K_MIC/K_CPU optimum
    # two material trees (Fig 6.1): acoustic cp=1 cs=0 | elastic cp=3 cs=2
    cp: tuple = (1.0, 3.0)
    cs: tuple = (0.0, 2.0)
    rho: tuple = (1.0, 1.0)
    dt: float = 1e-3
    final_time: float = 0.118           # 118 steps at dt=1e-3


CONFIG = DGConfig()
