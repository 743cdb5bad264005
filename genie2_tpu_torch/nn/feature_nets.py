"""Single and pair feature networks.

The single net concatenates sinusoidal encodings of residue index, chain
index and timestep with the masked aatype, the doubled fixed-sequence mask
and the interface mask, then applies one bias-free linear layer. The pair
net adds an outer sum of the single features, a relative-position
encoding, a template of the noised structure (soft distance bins
softmax(-4|d - v|) and pairwise orientation quaternions) and a motif
template. Relpos and the motif template depend only on static features:
`static_bias` computes their sum once so samplers can hoist it out of the
reverse loop. Under sequence parallelism the pair net builds only the rows
`rows` of the pair representation (global residue indices): the i side of
every pairwise term reads those residues, the j side all of them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genie2_tpu_torch.features.residues import NUM_RESTYPES
from genie2_tpu_torch.geometry import Rigid, distogram, rot_to_quat, sinusoidal_encoding
from genie2_tpu_torch.nn.primitives import Linear
from genie2_tpu_torch.utils.profiling import spanned


class SingleFeatureNet(nn.Module):
    def __init__(self, c_s, n_timestep, c_pos_emb, c_chain_emb, c_timestep_emb, max_n_res, max_n_chain):
        super().__init__()
        self.n_timestep = n_timestep
        self.c_pos_emb, self.c_chain_emb, self.c_timestep_emb = c_pos_emb, c_chain_emb, c_timestep_emb
        self.max_n_res, self.max_n_chain = max_n_res, max_n_chain
        c_in = c_pos_emb + c_chain_emb + c_timestep_emb + NUM_RESTYPES + 3
        self.linear = Linear(c_in, c_s, bias=False)

    @spanned("single_features")
    def forward(self, ts: Rigid, timesteps: torch.Tensor, features) -> torch.Tensor:
        n = ts.trans.shape[1]
        pos_emb = sinusoidal_encoding(features["residue_index"], self.max_n_res, self.c_pos_emb)
        chain_emb = sinusoidal_encoding(features["chain_index"], self.max_n_chain, self.c_chain_emb)
        t_broadcast = timesteps[:, None].expand(-1, n)
        timestep_emb = sinusoidal_encoding(t_broadcast, self.n_timestep, self.c_timestep_emb)

        fixed_seq = features["fixed_sequence_mask"].float()
        interface = features["interface_mask"].float()
        aatype_emb = features["aatype"].float() * fixed_seq[..., None]
        inputs = torch.cat(
            [pos_emb, chain_emb, timestep_emb, aatype_emb,
             fixed_seq[..., None], fixed_seq[..., None], interface[..., None]],
            dim=-1,
        )
        # The encodings stay float32; a bf16 weight is promoted, as JAX does.
        s = F.linear(inputs, self.linear.weight.float())
        return s * features["residue_mask"][..., None].float()


class PairFeatureNet(nn.Module):
    def __init__(self, c_s, c_p, relpos_k, template_dist_min, template_dist_step,
                 template_dist_n_bin, quat_method="closed"):
        super().__init__()
        self.relpos_k = relpos_k
        self.template_dist_min = template_dist_min
        self.template_dist_step = template_dist_step
        self.template_dist_n_bin = template_dist_n_bin
        self.quat_method = quat_method
        self.linear_s_p_i = Linear(c_s, c_p, bias=False)
        self.linear_s_p_j = Linear(c_s, c_p, bias=False)
        self.linear_relpos = Linear(2 * relpos_k + 3, c_p, bias=False)
        self.linear_template = Linear(template_dist_n_bin + 6, c_p, bias=False)
        self.linear_motif_template = Linear(template_dist_n_bin + 2, c_p, bias=False)

    def _relpos(self, features, dtype, rows=slice(None)):
        """AF2 Algorithm 4/5 with an extra cross-chain bin."""
        ri = features["residue_index"].long()
        ci = features["chain_index"]
        k = self.relpos_k
        same_chain = ci[:, rows, None] == ci[:, None, :]
        d_same = torch.clamp(ri[:, rows, None] - ri[:, None, :] + k, 0, 2 * k)
        d = torch.where(same_chain, d_same, torch.full_like(d_same, 2 * k + 1))
        oh = F.one_hot(d, 2 * k + 2).to(dtype)
        feats = torch.cat([oh, same_chain[..., None].to(dtype)], dim=-1)
        return self.linear_relpos(feats)

    def _encode_positions(self, coords, mask, rows=slice(None)):
        """Soft distance bins softmax(-4 |d - v|), masked pairwise."""
        d = distogram(coords[:, rows], coords)
        v = self.template_dist_min + self.template_dist_step * torch.arange(
            self.template_dist_n_bin, dtype=d.dtype, device=d.device
        )
        oh = torch.softmax(-4.0 * (d[..., None] - v).abs(), dim=-1)
        pair_mask = mask[:, rows, None] * mask[:, None, :]
        return oh * pair_mask[..., None].to(oh.dtype)

    @spanned("orientations")
    def _encode_orientations(self, rots, mask, rows=slice(None)):
        """Pairwise orientation quaternions of r[i, j] = R_j @ R_i (the
        reference's broadcasting convention, not R_i^T R_j)."""
        r = torch.matmul(rots[:, None, :, :, :], rots[:, rows, None, :, :])
        q = rot_to_quat(r, method=self.quat_method)
        pair_mask = mask[:, rows, None] * mask[:, None, :]
        return q * pair_mask[..., None].to(q.dtype)

    def static_bias(self, features, dtype=torch.float32, rows=slice(None)):
        """relpos + motif template: constant across diffusion steps; the
        rows `rows` of it."""
        fixed_structure = features["fixed_structure_mask"][:, rows].to(dtype)
        fixed_seq = features["fixed_sequence_mask"].to(dtype)
        bias = self._relpos(features, dtype, rows)
        motif_template = torch.cat(
            [
                self._encode_positions(features["atom_positions"].to(dtype), fixed_seq, rows)
                * fixed_structure[..., None],
                fixed_structure[..., None],
                fixed_structure[..., None],
            ],
            dim=-1,
        )
        return bias + self.linear_motif_template(motif_template)

    @spanned("pair_features")
    def forward(self, s, ts: Rigid, features, static_bias=None, rows=slice(None)):
        """The pair representation's rows `rows` (all of them by default)."""
        dtype = s.dtype
        residue_mask = features["residue_mask"].to(dtype)
        pair_mask = residue_mask[:, rows, None] * residue_mask[:, None, :]
        fixed_structure = features["fixed_structure_mask"][:, rows].to(dtype)

        p = self.linear_s_p_i(s[:, rows])[:, :, None, :] + self.linear_s_p_j(s)[:, None, :, :]
        template = torch.cat(
            [
                self._encode_positions(ts.trans, residue_mask, rows),
                self._encode_orientations(ts.rots, residue_mask, rows),
                fixed_structure[..., None],
                fixed_structure[..., None],
            ],
            dim=-1,
        )
        p = p + self.linear_template(template)
        if static_bias is None:
            static_bias = self.static_bias(features, dtype, rows)
        p = p + static_bias.to(dtype)
        return p * pair_mask[..., None]
