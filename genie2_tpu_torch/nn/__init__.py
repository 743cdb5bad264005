from genie2_tpu_torch.nn.denoiser import Denoiser
from genie2_tpu_torch.nn.feature_nets import PairFeatureNet, SingleFeatureNet
from genie2_tpu_torch.nn.pair_stack import (
    PairTransformLayer,
    PairTransformNet,
    PairTransition,
    TriangleAttention,
    TriangleMultiplicativeUpdate,
)
from genie2_tpu_torch.nn.primitives import Attention, Linear
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
    "TriangleAttention",
    "TriangleMultiplicativeUpdate",
    "Attention",
    "Linear",
    "BackboneUpdate",
    "InvariantPointAttention",
    "StructureLayer",
    "StructureNet",
    "StructureTransition",
]
