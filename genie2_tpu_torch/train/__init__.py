from genie2_tpu_torch.train.data import (
    MotifAugmentConfig,
    StructureDataset,
    apply_motif_augmentation,
    discover_structures,
    resolve_filepath,
    setup_split,
    synthetic_dataset,
)
from genie2_tpu_torch.train.loss import genie_loss, residue_error_norm
from genie2_tpu_torch.train.prefetch import PrefetchIterator, prefetch
from genie2_tpu_torch.train.state import TrainState, create_train_state, make_train_step, step_randomness

__all__ = [
    "MotifAugmentConfig",
    "StructureDataset",
    "apply_motif_augmentation",
    "discover_structures",
    "resolve_filepath",
    "setup_split",
    "synthetic_dataset",
    "genie_loss",
    "residue_error_norm",
    "PrefetchIterator",
    "prefetch",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "step_randomness",
]
