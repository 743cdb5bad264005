from genie2_tpu_torch.nn.denoiser import Denoiser
from genie2_tpu_torch.nn.feature_nets import PairFeatureNet, SingleFeatureNet
from genie2_tpu_torch.nn.pair_stack import (
    PairTransformLayer,
    PairTransformNet,
    PairTransition,
    TriangleMultiplicativeUpdate,
)
from genie2_tpu_torch.nn.primitives import Linear
from genie2_tpu_torch.nn.structure import (
    BackboneUpdate,
    InvariantPointAttention,
    StructureLayer,
    StructureNet,
    StructureTransition,
)

__all__ = [
    "Denoiser",
    "SingleFeatureNet",
    "PairFeatureNet",
    "PairTransformLayer",
    "PairTransformNet",
    "PairTransition",
    "TriangleMultiplicativeUpdate",
    "Linear",
    "BackboneUpdate",
    "InvariantPointAttention",
    "StructureLayer",
    "StructureNet",
    "StructureTransition",
]
