"""The SE(3)-equivariant denoiser: rescale frames -> single features -> pair
features -> pair transform stack -> IPA structure net -> descale -> noise
prediction z = trans_in - trans_out.

Submodules carry the reference's state_dict names
(`pair_transform_net.net.{i}.tri_mul_out.linear_a_p.weight`, ...), so a
released Lightning checkpoint loads with plain `load_state_dict`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genie2_tpu_torch.geometry import Rigid
from genie2_tpu_torch.nn.feature_nets import PairFeatureNet, SingleFeatureNet
from genie2_tpu_torch.nn.pair_stack import PairTransformNet
from genie2_tpu_torch.nn.structure import StructureNet
from genie2_tpu_torch.parallel.sequence_parallel import mean_grad_over_seq, padded_length, row_slice
from genie2_tpu_torch.utils.profiling import spanned


class Denoiser(nn.Module):
    """Given noisy frames at timestep t, predict the added noise.

    A Denoiser starts in eval mode, as the samplers call it: no dropout. In
    `train()` mode its forward takes a CPU `torch.Generator`, from which it
    draws one seed for each pair layer and each structure layer
    application; each layer draws its dropout masks on the activations'
    device from a generator of its own seed, never from the global RNG, for
    the global batch, and keeps this batch's rows (`rows`), so a row's masks
    do not depend on how the global batch is split over ranks.
    `remat` checkpoints each pair layer in training (nn/pair_stack.py).
    `tri_att_chunk` is the row chunk of triangle attention's plain version
    (0 = all rows at once). Built whole, it is split over a mesh's model
    axis in place by parallel/tensor_parallel.py:shard_model (the loaders
    and the Trainer do so for a mesh that has one); its forward is then a
    collective of the model group. Over a mesh's seq axis (`seq`, set by
    the same call) each rank holds its residue rows of the pair
    representation (parallel/sequence_parallel.py): the forward pads the
    residues to a multiple of the seq axis with masked ones, and gives z,
    s, the states and the frames back whole for the real residues and `p`
    as this rank's rows of the padded length; its forward is then a
    collective of the seq group."""

    seq = None

    def __init__(
        self, c_s, c_p, n_timestep, rescale, c_pos_emb, c_chain_emb, c_timestep_emb, max_n_res,
        max_n_chain, relpos_k, template_dist_min, template_dist_step, template_dist_n_bin,
        n_pair_transform_layer, include_mul_update, include_tri_att, c_hidden_mul, c_hidden_tri_att,
        n_head_tri, tri_dropout, pair_transition_n, n_structure_layer, n_structure_block,
        c_hidden_ipa, n_head_ipa, n_qk_point, n_v_point, ipa_dropout, n_structure_transition_layer,
        structure_transition_dropout, quat_method: str = "closed", tri_att_chunk: int = 0, remat: bool = False,
    ):
        super().__init__()
        self.rescale = rescale
        self.single_feature_net = SingleFeatureNet(
            c_s, n_timestep, c_pos_emb, c_chain_emb, c_timestep_emb, max_n_res, max_n_chain
        )
        self.pair_feature_net = PairFeatureNet(
            c_s, c_p, relpos_k, template_dist_min, template_dist_step, template_dist_n_bin, quat_method
        )
        self.pair_transform_net = (
            PairTransformNet(c_p, n_pair_transform_layer, include_mul_update, include_tri_att,
                             c_hidden_mul, pair_transition_n, c_hidden_tri_att, n_head_tri, tri_att_chunk,
                             tri_dropout, remat)
            if n_pair_transform_layer > 0 else None
        )
        self.structure_net = StructureNet(
            c_s, c_p, n_structure_layer, n_structure_block, c_hidden_ipa, n_head_ipa, n_qk_point,
            n_v_point, n_structure_transition_layer, ipa_dropout, structure_transition_dropout,
        )
        self.n_dropout_seeds = (n_pair_transform_layer, n_structure_layer * n_structure_block)
        self.eval()

    @classmethod
    def from_config(cls, config) -> "Denoiser":
        return cls(
            **config.model,
            n_timestep=config.diffusion["n_timestep"],
            max_n_res=config.io["max_n_res"],
            max_n_chain=config.io["max_n_chain"],
            quat_method=config.tpu.get("rot_to_quat_method", "closed"),
            tri_att_chunk=config.tpu.get("tri_att_chunk", 0),
            remat=config.tpu.get("remat", True),
        )

    def dropout_seeds(self, generator: Optional[torch.Generator], rows: Tuple[int, int, int], residues=None):
        """(pair layer keys, structure layer keys) in training mode: each
        the layer's seed, drawn from the CPU `generator`, with `rows`
        (start, stop, total: this batch's rows of the global batch) and,
        under sequence parallelism, `residues` (nn/primitives.py:
        DropoutSource); (None, None) in eval mode."""
        if not self.training:
            return None, None
        if generator is None:
            raise ValueError("a Denoiser in train() mode needs a CPU torch.Generator for its dropout masks; "
                             "call eval() for inference")
        n_pair, n_structure = self.n_dropout_seeds
        extra = () if residues is None else (residues,)
        seeds = [(s, *rows, *extra)
                 for s in torch.randint(0, 2**62, (n_pair + n_structure,), generator=generator).tolist()]
        return seeds[:n_pair], seeds[n_pair:]

    def static_bias(self, features: Dict[str, Any], dtype=torch.float32) -> torch.Tensor:
        """The step-invariant pair bias (relpos + motif template) that the
        samplers compute once and pass to every call: [B, N, N, c_p]; under
        sequence parallelism this rank's rows of the padded residues."""
        if self.seq is None:
            return self.pair_feature_net.static_bias(features, dtype)
        n_pad = padded_length(features["residue_mask"].shape[1], self.seq)
        return self.pair_feature_net.static_bias(pad_residues(features, n_pad), dtype, row_slice(n_pad, self.seq))

    @spanned("denoiser")
    def forward(
        self, ts: Rigid, timesteps: torch.Tensor, features: Dict[str, Any],
        static_pair_bias: torch.Tensor = None, generator: Optional[torch.Generator] = None,
        rows: Optional[Tuple[int, int, int]] = None,
    ) -> Dict[str, Any]:
        """`rows`: (start, stop, total), this batch's rows of a global batch
        of `total` rows, which the dropout masks are drawn for (default: the
        batch is the whole batch)."""
        rows = (0, timesteps.shape[0], timesteps.shape[0]) if rows is None else rows
        trans_in = ts.trans
        n = trans_in.shape[1]
        seq, residues, mine = self.seq, None, slice(None)
        if seq is not None:
            # Masked residues up to a multiple of the seq axis; the input
            # frames' gradient is whole on every rank (twisted SMC takes it).
            n_pad = padded_length(n, seq)
            ts = Rigid(*mean_grad_over_seq(seq, ts.rots, ts.trans))
            ts, features = pad_frames(ts, n_pad), pad_residues(features, n_pad)
            mine = row_slice(n_pad, seq)
            residues = (mine.start, mine.stop, n, n_pad)
            if static_pair_bias is not None and static_pair_bias.shape[1:3] != (mine.stop - mine.start, n_pad):
                raise ValueError(f"static_pair_bias {tuple(static_pair_bias.shape)}: under sequence parallelism "
                                 "pass this rank's rows (Denoiser.static_bias)")
        pair_seeds, structure_seeds = self.dropout_seeds(generator, rows, residues)
        # The frames' dtype selects the compute precision; the encodings
        # are built in float32 and the activations cast to it.
        compute_dtype = ts.trans.dtype
        ts = ts.scale_translation(self.rescale)
        s = self.single_feature_net(ts, timesteps, features).to(compute_dtype)
        p = self.pair_feature_net(s, ts, features, static_bias=static_pair_bias, rows=mine).to(compute_dtype)
        if self.pair_transform_net is not None:
            p = self.pair_transform_net(p, features, pair_seeds)
        states, ts = self.structure_net(s, p, ts, features, structure_seeds)
        ts = ts.scale_translation(1.0 / self.rescale)
        if seq is not None:
            s, states, ts = s[:, :n], states[:, :, :n], Rigid(ts.rots[:, :n], ts.trans[:, :n])
        return {"z": trans_in - ts.trans, "s": s, "p": p, "states": states, "ts": ts}


def pad_frames(ts: Rigid, n_pad: int) -> Rigid:
    """Frames [B, N] padded to `n_pad` residues at the origin, each with the
    last residue's rotation (a constant): the pairwise orientations of the
    pair features are then products of frames of one handedness (Frenet
    frames may all be improper), whose quaternion is well defined, so the
    eigh method's backward stays finite at the masked pairs too."""
    n = ts.trans.shape[1]
    if n == n_pad:
        return ts
    rots = ts.rots[:, -1:].detach().expand(-1, n_pad - n, 3, 3)
    return Rigid(torch.cat([ts.rots, rots], 1), F.pad(ts.trans, (0, 0, 0, n_pad - n)))


def pad_residues(features: Dict[str, Any], n_pad: int) -> Dict[str, Any]:
    """Batched features padded to `n_pad` residues with zeros (masked
    residues), as features/schema.py:pad_features pads a short chain: the
    pairwise `fixed_structure_mask` on both residue axes, the `num_*` counts
    not at all, every other feature on its residue axis 1."""
    n = features["residue_mask"].shape[1]
    if n == n_pad:
        return features
    out = {}
    for key, val in features.items():
        if key.startswith("num") or not isinstance(val, torch.Tensor):
            out[key] = val
        elif key == "fixed_structure_mask":
            out[key] = F.pad(val, (0, n_pad - n, 0, n_pad - n))
        else:
            out[key] = F.pad(val, [0, 0] * (val.dim() - 2) + [0, n_pad - n])
    return out
