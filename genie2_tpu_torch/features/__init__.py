from genie2_tpu_torch.features.schema import (
    Features,
    batchify,
    create_empty_features,
    debatchify,
    pad_features,
    to_device,
    to_host,
)
from genie2_tpu_torch.features.pdb import (
    features_from_pdb,
    parse_pdb,
    read_ca_coords,
    save_coords_to_pdb,
    save_features_to_pdb,
    summarize_pdb,
)
from genie2_tpu_torch.features.motif import (
    features_from_motif_pdb,
    load_motif_spec,
    sample_motif_mask,
    save_motif_pdb,
)
from genie2_tpu_torch.features.secstruct import assign_secstruct, helix_statistic, sec_struct_frac

__all__ = [
    "Features",
    "batchify",
    "create_empty_features",
    "debatchify",
    "pad_features",
    "to_device",
    "to_host",
    "features_from_pdb",
    "parse_pdb",
    "read_ca_coords",
    "save_coords_to_pdb",
    "save_features_to_pdb",
    "summarize_pdb",
    "features_from_motif_pdb",
    "load_motif_spec",
    "sample_motif_mask",
    "save_motif_pdb",
    "assign_secstruct",
    "helix_statistic",
    "sec_struct_frac",
]
