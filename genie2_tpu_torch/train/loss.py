"""The motif-weighted noise-prediction loss of training.

The per-residue error is the L2 norm of the error vector, sqrt(eps +
|z_pred - z|^2), not its square; condition (motif) and infill (scaffold)
residues are weighted as the reference's training step weights them, and
the per-category means are NaN-free (weighted by membership).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from genie2_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


def residue_error_norm(x_pred: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, aggregate: str = None,
                       eps: float = 1e-10) -> torch.Tensor:
    """sqrt(eps + |x_pred - x|^2) per residue, masked; summed or averaged
    over the residues where `aggregate` says so."""
    masked = torch.sqrt(eps + ((x_pred - x) ** 2).sum(-1)) * mask
    if aggregate is None:
        return masked
    if aggregate == "mean":
        return masked.sum(-1) / mask.sum(-1)
    if aggregate == "sum":
        return masked.sum(-1)
    raise ValueError(f"Invalid aggregate method: {aggregate}")


def genie_loss(z_pred: torch.Tensor, z: torch.Tensor, features: Dict[str, torch.Tensor],
               condition_loss_weight: float, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar weighted loss, metrics): unweighted_loss, weighted_loss,
    motif_mse_loss, scaffold_mse_loss, unconditional_mse_loss and
    frac_conditioned, each a 0-d tensor. Each metric is a sum over the batch
    divided by a count over it; with a mesh both are summed over the ranks
    first, so the metrics are the global batch's. The loss is this batch's
    mean (with equal rows a rank, the mean of the ranks' losses is the
    global one)."""
    residue_mask = features["residue_mask"].float()
    fixed_seq = features["fixed_sequence_mask"].float()
    condition_mask = residue_mask * fixed_seq
    infill_mask = residue_mask * (1.0 - fixed_seq)

    condition_losses = residue_error_norm(z_pred, z, condition_mask, aggregate="sum")
    infill_losses = residue_error_norm(z_pred, z, infill_mask, aggregate="sum")

    num_residues = features["num_residues"].float().reshape(-1)
    unweighted = (condition_losses + infill_losses) / num_residues

    w = condition_loss_weight
    n_cond = condition_mask.sum(-1)
    n_infill = infill_mask.sum(-1)
    weighted = (w * condition_losses + infill_losses) / (w * n_cond + n_infill)

    has_motif = (n_cond > 0).float()
    no_motif = 1.0 - has_motif
    safe_cond = condition_losses / torch.clamp(n_cond, min=1.0)
    safe_infill = infill_losses / torch.clamp(n_infill, min=1.0)
    rows = torch.full((), float(weighted.shape[0]), device=weighted.device)

    # (sum over the batch, count over it) of each metric.
    terms = {
        "unweighted_loss": (unweighted.sum(), rows),
        "weighted_loss": (weighted.sum(), rows),
        "motif_mse_loss": ((safe_cond * has_motif).sum(), has_motif.sum()),
        "scaffold_mse_loss": ((safe_infill * has_motif).sum(), has_motif.sum()),
        "unconditional_mse_loss": ((safe_infill * no_motif).sum(), no_motif.sum()),
        "frac_conditioned": (has_motif.sum(), rows),
    }
    sums = all_reduce_sum(torch.stack([torch.stack(pair) for pair in terms.values()]).detach(), mesh)
    metrics = {k: sums[i, 0] / torch.clamp(sums[i, 1], min=1.0) for i, k in enumerate(terms)}
    return weighted.mean(), metrics
