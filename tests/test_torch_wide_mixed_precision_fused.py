"""One minibatch update of dandelion at ``hidden_dim=1024`` under mixed
precision (``mixed_precision=True``, ``mp_stages="qkvo"``) on the CPU
against the JAX trainer, on ``fused_attention`` (the wide fused attention
kernels on the card): the checks of ``tests/torch_wide_trainer.py``, with the tolerances of
``tests/test_torch_mixed_precision_update.py``.
"""

import torch

from torch_threads import one_torch_thread  # noqa: F401
from torch_wide_trainer import check_minibatch_update, pair


def test_bf16_minibatch_update_at_hidden_1024_matches_jax():
    trainer, jtrainer = pair(fused=True, mixed_precision=True)
    assert trainer.critic.self_attn.dtypes == dict.fromkeys("qkvo", torch.bfloat16)
    check_minibatch_update(trainer, jtrainer)
