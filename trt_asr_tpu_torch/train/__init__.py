"""Training of the port: the TDT loss, the train step (offline and
streaming, remat, SpecAugment, the optimizers and their schedules),
checkpoint/resume and the manifest data feed."""

from trt_asr_tpu_torch.train.augment import spec_augment  # noqa: F401
from trt_asr_tpu_torch.train.tdt_loss import tdt_loss  # noqa: F401
from trt_asr_tpu_torch.train.train_step import (  # noqa: F401
    make_optimizer,
    make_train_step,
    training_forward,
)
