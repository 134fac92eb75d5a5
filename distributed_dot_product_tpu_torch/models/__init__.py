# -*- coding: utf-8 -*-
from distributed_dot_product_tpu_torch.models.attention import (  # noqa: F401
    DistributedDotProductAttn,
)
