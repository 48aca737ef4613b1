from haplohyped_tpu_torch.models.enformer import Enformer, EnformerConfig
from haplohyped_tpu_torch.models.granite_hybrid import GraniteHybrid, GraniteHybridConfig
from haplohyped_tpu_torch.models.haploformer import HaploFormer, HaploFormerConfig
from haplohyped_tpu_torch.models.nemotron_h import NemotronH, NemotronHConfig
from haplohyped_tpu_torch.models.train import (
    TrainState,
    create_train_state,
    loss_fn,
    make_train_step,
)

__all__ = [
    "Enformer",
    "EnformerConfig",
    "GraniteHybrid",
    "GraniteHybridConfig",
    "HaploFormer",
    "HaploFormerConfig",
    "NemotronH",
    "NemotronHConfig",
    "TrainState",
    "create_train_state",
    "loss_fn",
    "make_train_step",
]
