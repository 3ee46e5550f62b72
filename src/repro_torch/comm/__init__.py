"""The 1.5D communication-avoiding layer on ``torch.distributed``: the
processor grid (``grid``), its process teams and collectives
(``group``), the ring products and replication-aware transposes
(``matmul1p5d``, ``sparse1p5d``), the compressed gradient collectives
(``collectives``) and their declared schedules (``contract``)."""
from .grid import AXES, Grid1p5D, best_grid  # noqa: F401
from .group import (Comm, comm_for, destroy_process_group,  # noqa: F401
                    init_process_group, set_collective_watcher, world_size)
