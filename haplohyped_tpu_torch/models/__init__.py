from haplohyped_tpu_torch.models.enformer import Enformer, EnformerConfig
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.models.train import (
    TrainState,
    create_train_state,
    loss_fn,
    make_train_step,
)

__all__ = [
    "Enformer",
    "EnformerConfig",
    "HaploFormer",
    "HaploFormerConfig",
    "TrainState",
    "create_train_state",
    "loss_fn",
    "make_train_step",
]
