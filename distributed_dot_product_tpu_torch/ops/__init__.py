# -*- coding: utf-8 -*-
from distributed_dot_product_tpu_torch.ops.flash_attention import (  # noqa
    flash_attention,
)
from distributed_dot_product_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode,
)
from distributed_dot_product_tpu_torch.ops.rope import rope  # noqa: F401
