from aps_tpu_torch.parallel.mesh import (SeqSplit, fit_batch_to_mesh,
                                         rank_rows, sharded_map,
                                         tp_param_shardings)

__all__ = ["SeqSplit", "fit_batch_to_mesh", "rank_rows", "sharded_map",
           "tp_param_shardings"]
