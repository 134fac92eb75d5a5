# -*- coding: utf-8 -*-
"""
distributed_dot_product_tpu_torch — the PyTorch / CUDA port of
``distributed_dot_product_tpu``, built beside it slice by slice and held
against it on identical inputs and parameters.

The ported paths serve the package's ``TransformerLM`` by greedy
generation and train it, and serve request bursts through the
continuous-batching ``serve.Scheduler`` over the ``serve.KernelEngine``
(per-slot slab or paged KV cache), on one NVIDIA Hopper card; and they
run the paper's subject, ``DistributedDotProductAttn`` over a
sequence-sharded ``torch.distributed`` group (``utils/comm.py``,
``parallel/mesh.py``; the distributed matmuls nt/tn/all in
``ops/functions.py`` and their gradients in ``ops/ops.py``; ring and
Ulysses attention in ``models/``), trained DP × SP by ``train.py``'s
``make_train_step``. The prefill, the training forward and every
sequence-parallel flash path run the flash-attention forward
(``ops/flash_attention.py``, CUDA kernels ``csrc/flash_fwd.cu``: exact,
and bounded softmax), the backward its dq and dk/dv kernels
(``csrc/flash_bwd.cu``), and each decode step the fused append + split-K
decode kernel, slab or paged (``ops/flash_decode.py``,
``csrc/flash_decode.cu``). Every wrapper keeps a plain PyTorch version
of its kernel, which runs for CPU tensors (the tests) and is the card's
reference.

Entry points run on the card (``device='cuda'``) unless the caller asks
for the CPU; without a card they raise. The package imports ``torch``
and never ``jax``.
"""

from distributed_dot_product_tpu_torch.utils.comm import (  # noqa: F401
    SEQ_AXIS, get_rank, get_world_size, init, is_main_process,
    resolve_device, synchronize,
)
from distributed_dot_product_tpu_torch.parallel.mesh import (  # noqa: F401
    data_seq_mesh, seq_mesh, shard_seq, unshard_seq,
)
from distributed_dot_product_tpu_torch.ops.functions import (  # noqa: F401
    distributed_matmul_all, distributed_matmul_nt, distributed_matmul_tn,
)
from distributed_dot_product_tpu_torch.ops.ops import (  # noqa: F401
    FullMultiplication, LeftTransposeMultiplication,
    RightTransposeMultiplication, matmul_all, matmul_nt, matmul_tn,
)
from distributed_dot_product_tpu_torch.ops.rope import (  # noqa: F401
    rope, rope_seq_parallel,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (  # noqa
    flash_attention, flash_attention_backward_plain, flash_attention_bounded,
    flash_attention_dkv, flash_attention_dq,
)
from distributed_dot_product_tpu_torch.ops.flash_decode import (  # noqa: F401
    flash_decode, flash_decode_paged,
)
from distributed_dot_product_tpu_torch.models.dense import (  # noqa: F401
    OwnedDense,
)
from distributed_dot_product_tpu_torch.models.decode import (  # noqa: F401
    DecodeCache, PagedDecodeCache, PagePool, append_kv, append_kv_slots,
    decode_attention, decode_step, init_cache, init_paged_cache,
    init_slot_cache,
)
from distributed_dot_product_tpu_torch.models.ring_attention import (  # noqa
    ring_attention,
)
from distributed_dot_product_tpu_torch.models.ulysses_attention import (  # noqa
    ulysses_attention,
)
from distributed_dot_product_tpu_torch.models.attention import (  # noqa: F401
    DistributedDotProductAttn, apply_seq_parallel,
)
from distributed_dot_product_tpu_torch.models.transformer import (  # noqa
    LayerNorm, TransformerBlock, TransformerStack,
)
from distributed_dot_product_tpu_torch.models.lm import (  # noqa: F401
    TransformerLM, greedy_generate, lm_targets,
)
from distributed_dot_product_tpu_torch.train import (  # noqa: F401
    make_lm_train_step, make_train_step, mse_loss,
)
from distributed_dot_product_tpu_torch.serve import (  # noqa: F401
    KernelEngine, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.convert import (  # noqa: F401
    attn_state_from_jax, engine_state_from_jax, lm_state_from_jax,
    stack_state_from_jax,
)
