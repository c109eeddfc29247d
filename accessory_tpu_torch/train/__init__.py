"""Training: loss, LR schedules, AdamW with parameter groups, the train step
and training checkpoints. Port of ``accessory_tpu/train/``: the step runs
eagerly (no jit) on one device, or as one rank of a context-parallel mesh
(``make_train_step(..., attn_fn=parallel.make_cp_attn_fn(mesh))``),
gradients come from autograd through the port's differentiable kernels
(``quant.qtensor._KernelQmm``, ``ops.flash_attention``), and the optimizer is
optax's AdamW written out in PyTorch (``train/optim.py``)."""

from accessory_tpu_torch.train.loss import cross_entropy_loss  # noqa: F401
from accessory_tpu_torch.train.lr_sched import (  # noqa: F401
    adjust_learning_rate,
    adjust_learning_rate_epoch,
    cosine_lr,
)
from accessory_tpu_torch.train.optim import make_optimizer, param_label_fn  # noqa: F401
from accessory_tpu_torch.train.train_step import TrainState, make_train_step  # noqa: F401
