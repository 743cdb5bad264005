"""IPA-based structure module: invariant point attention with the pair head,
the structure transition, the backbone update and the stack of layers that
is reapplied per block (parameters shared across blocks). In training, the
whole of s goes through dropout after s + IPA (before the layer norm) and
after the transition's residual blocks (before its layer norm), as
genie2_tpu places them; each application of a layer takes its own seed.

Under tensor parallelism (parallel/tensor_parallel.py) the IPA splits its
heads and the first block of the transition its hidden channels; both
leave s reduced and replicated, so the dropout after them draws the same
masks on every model rank.

Under sequence parallelism (parallel/sequence_parallel.py, `seq`) s and
the frames stay whole on every rank and p is this rank's rows: a
structure layer takes its residues as the IPA's queries (the keys and
values are every residue, from the whole s and frames; the pair bias and
o_pair come from this rank's rows of p), runs the transition and the
backbone update on them, and closes with one gather of s and the frames'
rows. Dropout masks are drawn for every residue and sliced
(nn/primitives.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genie2_tpu_torch.geometry import Rigid, quat_to_rot
from genie2_tpu_torch.nn.primitives import SOFTPLUS_INVERSE_1, Linear, dropout, layer_generator, layer_norm
from genie2_tpu_torch.ops.ipa import ipa_attention
from genie2_tpu_torch.parallel.sequence_parallel import gather_seq_rows, row_slice
from genie2_tpu_torch.parallel.tensor_parallel import copy_to_model, reduce_from_model
from genie2_tpu_torch.utils.profiling import spanned


def _to_points(x: torch.Tensor) -> torch.Tensor:
    """[.., 3P] laid out as thirds (x-coords, y, z) -> [.., P, 3]."""
    return torch.stack(torch.chunk(x, 3, dim=-1), dim=-1)


class InvariantPointAttention(nn.Module):
    """AF2 Algorithm 22 with the reference's output head, which concatenates
    the pair-attended features (width H * (c_z + c_hidden + 4 * P_v)). The
    attention core masks the key side only (ops/ipa.py): real rows equal the
    square mask's, padded rows differ and are dead downstream.

    Under tensor parallelism (`tp`) it holds this rank's heads (`no_heads`
    of them): every projection by columns, head by head (the point
    projections from each of their thirds), `linear_out` by rows (its input
    is six head-major blocks, `out_blocks`), its bias after the reduction;
    `head_weights` stays whole and is sliced at use. s, z and the frames
    come in through copy_to_model. Under `seq` the queries are this rank's
    residues: z is their rows of the pair representation [B,I,N,c_z], and
    the outputs are theirs [B,I,c_s]."""

    tp = None
    seq = None

    def __init__(self, c_s, c_z, c_hidden, no_heads, no_qk_points, no_v_points, inf=1e5, eps=1e-8):
        super().__init__()
        self.c_z, self.c_hidden, self.no_heads = c_z, c_hidden, no_heads
        self.no_qk_points, self.no_v_points = no_qk_points, no_v_points
        self.inf, self.eps = inf, eps
        hc = no_heads * c_hidden
        self.linear_q = Linear(c_s, hc)
        self.linear_kv = Linear(c_s, 2 * hc)
        self.linear_q_points = Linear(c_s, no_heads * no_qk_points * 3)
        self.linear_kv_points = Linear(c_s, no_heads * (no_qk_points + no_v_points) * 3)
        self.linear_b = Linear(c_z, no_heads)
        self.head_weights = nn.Parameter(torch.full((no_heads,), SOFTPLUS_INVERSE_1))
        self.linear_out = Linear(no_heads * (c_z + c_hidden + no_v_points * 4), c_s, init="final")

    def tp_units(self) -> int:
        return self.no_heads

    def out_blocks(self):
        """The widths of `linear_out`'s input blocks, in the order of the concatenation below."""
        h = self.no_heads
        return (h * self.c_hidden, *(h * self.no_v_points,) * 4, h * self.c_z)

    def shard_(self, tp):
        self.tp = tp
        self.no_heads //= tp.size

    @spanned("ipa")
    def forward(self, s, z, t: Rigid, mask):
        h, c = self.no_heads, self.c_hidden
        pq, pv = self.no_qk_points, self.no_v_points
        B, N = s.shape[:2]
        tp = self.tp
        head_weights = self.head_weights
        if tp is not None:
            s, z = copy_to_model(s, tp), copy_to_model(z, tp)
            t = Rigid(copy_to_model(t.rots, tp), copy_to_model(t.trans, tp))
            head_weights = copy_to_model(head_weights, tp)[tp.rank * h:(tp.rank + 1) * h]
        # The query residues: this rank's rows under `seq`, else all.
        rows = row_slice(N, self.seq) if self.seq is not None else slice(None)
        s_q, t_q = s[:, rows], Rigid(t.rots[:, rows], t.trans[:, rows])
        I = s_q.shape[1]

        q = self.linear_q(s_q).view(B, I, h, c)
        kv = self.linear_kv(s).view(B, N, h, 2 * c)
        k, v = kv[..., :c], kv[..., c:]

        frames, frames_q = t.unsqueeze(-1), t_q.unsqueeze(-1)
        q_pts = frames_q.apply(_to_points(self.linear_q_points(s_q))).view(B, I, h, pq, 3)
        kv_pts = frames.apply(_to_points(self.linear_kv_points(s))).view(B, N, h, pq + pv, 3)
        k_pts, v_pts = kv_pts[..., :pq, :], kv_pts[..., pq:, :]

        # Logits, softmax and the three value sums: one kernel on the card.
        o, o_pt, o_pair = ipa_attention(
            q, k, v, q_pts, k_pts, v_pts, self.linear_b(z), z, F.softplus(head_weights), mask, self.inf
        )
        o = o.reshape(B, I, h * c)
        o_pt = frames_q.unsqueeze(-1).invert_apply(o_pt)
        o_pt_norm = torch.sqrt((o_pt * o_pt).sum(-1) + self.eps).reshape(B, I, h * pv)
        o_pt_flat = o_pt.reshape(B, I, h * pv, 3)
        o_pair = o_pair.reshape(B, I, h * self.c_z)

        out = torch.cat(
            [o, o_pt_flat[..., 0], o_pt_flat[..., 1], o_pt_flat[..., 2], o_pt_norm, o_pair], dim=-1
        )
        if tp is None:
            return self.linear_out(out)
        return reduce_from_model(F.linear(out, self.linear_out.weight), tp) + self.linear_out.bias


class _TransitionBlock(nn.Module):
    """Under tensor parallelism (`tp`; the first block of the transition
    only) `linear_1` by columns, `linear_2` by rows, its bias after the
    reduction; `linear_3` whole."""

    tp = None

    def __init__(self, c):
        super().__init__()
        self.linear_1 = Linear(c, c, init="relu")
        self.linear_2 = Linear(c, c, init="relu")
        self.linear_3 = Linear(c, c, init="final")

    def tp_units(self) -> int:
        return self.linear_1.weight.shape[0]

    def shard_(self, tp):
        self.tp = tp

    def forward(self, s):
        if self.tp is None:
            h = self.linear_2(torch.relu(self.linear_1(s)))
        else:
            h = torch.relu(self.linear_1(copy_to_model(s, self.tp)))
            h = reduce_from_model(F.linear(h, self.linear_2.weight), self.tp) + self.linear_2.bias
        return self.linear_3(torch.relu(h)) + s


class StructureTransition(nn.Module):
    """Residual 3-linear ReLU blocks, dropout, then LayerNorm."""

    def __init__(self, c, num_layers, dropout_rate=0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layers = nn.ModuleList(_TransitionBlock(c) for _ in range(num_layers))
        self.layer_norm = layer_norm(c)

    @spanned("structure_transition")
    def forward(self, s, generator=None):
        for layer in self.layers:
            s = layer(s)
        return self.layer_norm(dropout(s, self.dropout_rate, generator))


class BackboneUpdate(nn.Module):
    """AF2 Algorithm 23; the linear is not zero-initialised, as in the
    reference fork."""

    def __init__(self, c_s):
        super().__init__()
        self.linear = Linear(c_s, 6)

    @spanned("backbone_update")
    def forward(self, s) -> Rigid:
        params = self.linear(s)
        quats, trans = params[..., :3], params[..., 3:]
        norm = torch.sqrt((quats * quats).sum(-1, keepdim=True) + 1.0)
        quats = torch.cat([torch.ones_like(quats[..., :1]), quats], dim=-1) / norm
        return Rigid(quat_to_rot(quats), trans)


class StructureLayer(nn.Module):
    """s += IPA; dropout; LN; transition; frame compose. Under `seq`, on
    this rank's residues, then s and the frames gathered whole."""

    seq = None

    def __init__(self, c_s, c_p, c_hidden_ipa, n_head_ipa, n_qk_point, n_v_point, n_structure_transition_layer,
                 ipa_dropout=0.0, transition_dropout=0.0):
        super().__init__()
        self.ipa_dropout = ipa_dropout
        self.ipa = InvariantPointAttention(c_s, c_p, c_hidden_ipa, n_head_ipa, n_qk_point, n_v_point)
        self.ipa_layer_norm = layer_norm(c_s)
        self.transition = StructureTransition(c_s, n_structure_transition_layer, transition_dropout)
        self.bb_update = BackboneUpdate(c_s)

    @spanned("structure_layer")
    def forward(self, s, p, t: Rigid, mask, seed=None):
        """`seed` (a dropout key, nn/primitives.py) seeds this application's dropout masks; None: no dropout."""
        gen = layer_generator(seed, s.device)
        if self.seq is None:
            s = self.ipa_layer_norm(dropout(s + self.ipa(s, p, t, mask), self.ipa_dropout, gen))
            s = self.transition(s, gen)
            return s, t.compose(self.bb_update(s))
        rows = row_slice(s.shape[1], self.seq)
        s_rows = self.ipa_layer_norm(dropout(s[:, rows] + self.ipa(s, p, t, mask), self.ipa_dropout, gen))
        s_rows = self.transition(s_rows, gen)
        t_rows = Rigid(t.rots[:, rows], t.trans[:, rows]).compose(self.bb_update(s_rows))
        s, rots, trans = gather_seq_rows(self.seq, 1, s_rows, t_rows.rots, t_rows.trans)
        return s, Rigid(rots, trans)


class StructureNet(nn.Module):
    """n_structure_block passes over n_structure_layer layers; returns the
    stacked single representations and the final frames."""

    def __init__(self, c_s, c_p, n_structure_layer, n_structure_block, c_hidden_ipa, n_head_ipa,
                 n_qk_point, n_v_point, n_structure_transition_layer, ipa_dropout=0.0, transition_dropout=0.0):
        super().__init__()
        self.n_structure_block = n_structure_block
        self.net = nn.ModuleList(
            StructureLayer(c_s, c_p, c_hidden_ipa, n_head_ipa, n_qk_point, n_v_point,
                           n_structure_transition_layer, ipa_dropout, transition_dropout)
            for _ in range(n_structure_layer)
        )

    def forward(self, s, p, ts: Rigid, features, seeds=None):
        """`seeds`: one dropout seed for each (block, layer) application, in
        order, or None (no dropout)."""
        mask = features["residue_mask"].float()  # cast once for all layers' attention cores
        states = [s]
        seeds = iter(seeds) if seeds is not None else None
        for _ in range(self.n_structure_block):
            for layer in self.net:
                s, ts = layer(s, p, ts, mask, None if seeds is None else next(seeds))
                states.append(s)
        return torch.stack(states, dim=0), ts
