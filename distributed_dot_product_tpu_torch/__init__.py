# -*- coding: utf-8 -*-
"""
distributed_dot_product_tpu_torch — the PyTorch / CUDA port of
``distributed_dot_product_tpu``, built beside it slice by slice and held
against it on identical inputs and parameters.

The ported paths serve the package's ``TransformerLM`` by greedy
generation and train it, on one NVIDIA Hopper card: the prefill and the
training forward run the flash-attention forward
(``ops/flash_attention.py``, CUDA kernel ``csrc/flash_fwd.cu``), the
training backward its dq and dk/dv kernels (``csrc/flash_bwd.cu``), and
each decode step the fused append + split-K decode kernel
(``ops/flash_decode.py``, ``csrc/flash_decode.cu``); ``train.py`` holds
the train step. Every wrapper keeps a plain PyTorch version of its
kernel, which runs for CPU tensors (the tests) and is the card's
reference.

Entry points run on the card (``device='cuda'``) unless the caller asks
for the CPU; without a card they raise. The package imports ``torch``
and never ``jax``.
"""

from distributed_dot_product_tpu_torch.utils.comm import (  # noqa: F401
    SEQ_AXIS, resolve_device,
)
from distributed_dot_product_tpu_torch.ops.rope import rope  # noqa: F401
from distributed_dot_product_tpu_torch.ops.flash_attention import (  # noqa
    flash_attention, flash_attention_backward_plain, flash_attention_dkv,
    flash_attention_dq,
)
from distributed_dot_product_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode,
)
from distributed_dot_product_tpu_torch.models.dense import (  # noqa: F401
    OwnedDense,
)
from distributed_dot_product_tpu_torch.models.decode import (  # noqa: F401
    DecodeCache, append_kv, decode_attention, decode_step, init_cache,
)
from distributed_dot_product_tpu_torch.models.attention import (  # noqa: F401
    DistributedDotProductAttn,
)
from distributed_dot_product_tpu_torch.models.transformer import (  # noqa
    LayerNorm, TransformerBlock, TransformerStack,
)
from distributed_dot_product_tpu_torch.models.lm import (  # noqa: F401
    TransformerLM, greedy_generate, lm_targets,
)
from distributed_dot_product_tpu_torch.train import (  # noqa: F401
    make_lm_train_step,
)
from distributed_dot_product_tpu_torch.convert import (  # noqa: F401
    attn_state_from_jax, lm_state_from_jax,
)
