"""The multi-device layer on ``torch.distributed``: the process mesh
(``mesh``), a launcher of N ranks (``launch``), the bank search over a
row-split descriptor bank (``sharded_bank``), the distributed pose-graph
solve (``dist_pgo``) and data-parallel odometry (``sharded_odometry``)."""

from navtech_radar_slam_torch.parallel.mesh import (BANK_AXIS, Mesh, init_distributed,  # noqa: F401
                                                    make_mesh, row_block)
