from aps_tpu_torch.parallel.mesh import (fit_batch_to_mesh, rank_rows,
                                         sharded_map)

__all__ = ["fit_batch_to_mesh", "rank_rows", "sharded_map"]
