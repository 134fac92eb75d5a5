# -*- coding: utf-8 -*-
from distributed_dot_product_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, data_seq_mesh, seq_mesh, shard_seq, unshard_seq,
)
