from genie2_tpu_torch.features.schema import (
    Features,
    batchify,
    create_empty_features,
    debatchify,
    pad_features,
    to_device,
    to_host,
)
from genie2_tpu_torch.features.pdb import read_ca_coords, save_features_to_pdb

__all__ = [
    "Features",
    "batchify",
    "create_empty_features",
    "debatchify",
    "pad_features",
    "to_device",
    "to_host",
    "read_ca_coords",
    "save_features_to_pdb",
]
