"""Training state and step.

One step: t ~ U{1..T} per structure, masked Gaussian noise, q_sample of the
translations, Frenet frames of the noisy translations, the denoiser's
forward in train() mode (dropout, remat), the motif-weighted loss, the
gradients, their global norm (metric `grad_norm`, before the update), one
Adam update and, where `ema_decay` > 0, the weights' exponential moving
average d * ema + (1 - d) * params after it.

Adam is `torch.optim.Adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 and the same
bias-corrected update as genie2_tpu's `optax.adam(lr)`. The master weights,
the Adam moments, the loss and the update stay float32; under
`compute_dtype` "bf16" the forward and backward run on bf16 casts of the
weights made inside the differentiated call (nn/policy.py).

The step's randomness is explicit: t and the noise are drawn from a
generator on the batch's device, the dropout masks from a seed
(nn/denoiser.py), and all three can be injected instead (the CPU parity
tests inject genie2_tpu's). `step_randomness` derives both from (seed,
epoch, batch index) through `np.random.SeedSequence`, as the samplers seed
their noise streams.

Data parallel (`mesh`): each data index runs its rows of the global batch
and the gradients are all-reduced over the data group by hand after the
backward, not by DistributedDataParallel: the bf16 policy calls the model
through `torch.func.functional_call`, which bypasses a DDP wrapper's
forward, so DDP's reducer would never be prepared. Tensor parallel (a
model sharded by parallel/tensor_parallel.py:shard_model): the parameters,
their gradients, Adam's moments and the EMA are this rank's shards;
`grad_norm` is the full model's, and `state_dict` / `load_state_dict`
read and write the full state (collectives over the model group).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule, q_sample
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn.policy import apply_denoiser_cast, compute_dtype
from genie2_tpu_torch.parallel.mesh import Mesh, average_gradients, data_axis_size, local_rows
from genie2_tpu_torch.parallel.tensor_parallel import gather_train_state, grad_norm, place_train_state
from genie2_tpu_torch.train.loss import genie_loss
from genie2_tpu_torch.utils.profiling import span, spanned


class TrainState:
    """The model (float32 master weights), its Adam optimizer, the step
    count and the weights' EMA (a dict of tensors keyed like the model's
    state_dict, or None where `ema_decay` is 0); of a sharded model, this
    rank's shards of each."""

    def __init__(self, model: torch.nn.Module, lr: float, ema_decay: float = 0.0):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)
        self.step = 0
        self.ema = ({n: p.detach().clone() for n, p in model.named_parameters()} if ema_decay > 0 else None)

    def state_dict(self) -> Dict:
        """The full state (gathered over the model group: every model rank calls it)."""
        blob = {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema is not None:
            blob["ema"] = self.ema
        return gather_train_state(blob, self.model)

    def load_state_dict(self, blob: Dict):
        """From a full state, this rank's shards of it."""
        blob = place_train_state(blob, self.model)
        self.model.load_state_dict(blob["params"])
        self.optimizer.load_state_dict(blob["opt_state"])
        self.step = int(blob["step"])
        if self.ema is not None:
            with torch.no_grad():
                for n, e in self.ema.items():
                    e.copy_(blob["ema"][n])


def create_train_state(model: torch.nn.Module, lr: float, ema_decay: float = 0.0) -> TrainState:
    return TrainState(model, lr, ema_decay)


def step_randomness(seed: int, epoch: int, batch: int, device) -> Tuple[torch.Generator, int]:
    """(generator on `device` for t and the noise, dropout seed) of the
    step at (seed, epoch, batch index in the epoch)."""
    state = np.random.SeedSequence([int(seed), int(epoch), int(batch)]).generate_state(2, np.uint64)
    rng = torch.Generator(device=device).manual_seed(int(state[0]) & (2**63 - 1))
    return rng, int(state[1]) & (2**62 - 1)


@spanned("noise")
def noised_input(schedule: Schedule, features: Dict[str, torch.Tensor], rng: Optional[torch.Generator] = None,
                 t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                 mesh: Optional[Mesh] = None):
    """(t [B], masked noise z [B,N,3], noisy frames): t ~ U{1..T} and the
    standard normal noise are drawn from `rng` unless given; the noise is
    masked to the real residues here. With a mesh, t and the noise are the
    global batch's (drawn for it in the one-process order, or given), and
    this rank takes its rows of them."""
    x0 = features["atom_positions"]
    dev = x0.device
    n = x0.shape[0] * data_axis_size(mesh)
    if t is None:
        t = torch.randint(1, schedule.n_timestep + 1, (n,), generator=rng, device=dev)
    if noise is None:
        noise = torch.randn((n, *x0.shape[1:]), generator=rng, device=dev, dtype=x0.dtype)
    rows = local_rows(n, mesh)
    z = noise[rows].to(dev) * features["residue_mask"].to(x0.dtype)[..., None]
    t = t[rows].to(dev)
    trans_t = q_sample(schedule, x0, t, z)
    rots_t = frenet_frames(trans_t, features["chain_index"], features["residue_mask"])
    return t, z, Rigid(rots_t, trans_t)


def make_train_step(schedule: Schedule, condition_loss_weight: float, compute_dtype_name: str = "fp32",
                    ema_decay: float = 0.0, mesh: Optional[Mesh] = None):
    """The training step: (state, features, rng=None, t=None, noise=None,
    dropout_seed=None) -> metrics (0-d float32 tensors on the batch's
    device). It updates `state` in place. `dropout_seed` seeds the CPU
    generator of the model's dropout (nn/denoiser.py); t and the standard
    normal `noise` [B,N,3] (masked here) are drawn from `rng` where not
    given.

    With a mesh, `features` is this rank's rows of the global batch
    (`shard_batch`), t and `noise` are the global batch's (`noised_input`),
    so are the dropout masks (nn/primitives.py:dropout), the gradients
    are averaged over the ranks before `grad_norm` and the update, and the
    metrics are the global batch's (`genie_loss`): every rank then takes
    the same Adam and EMA update, that of one process on the global
    batch."""
    dtype = compute_dtype(compute_dtype_name)

    @spanned("train_step")
    def train_step(state: TrainState, features: Dict[str, torch.Tensor], rng: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   dropout_seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        t, z, frames = noised_input(schedule, features, rng, t, noise, mesh)
        gen = torch.Generator().manual_seed(int(dropout_seed)) if dropout_seed is not None else None
        n = z.shape[0] * data_axis_size(mesh)
        rows = local_rows(n, mesh)
        with span("forward"):
            z_pred = apply_denoiser_cast(model, frames, t, features, dtype, gen, (rows.start, rows.stop, n))
        with span("loss"):
            loss, metrics = genie_loss(z_pred, z, features, condition_loss_weight, mesh)
        # The host's wait: on the card the backward runs on autograd's thread,
        # under the Functions' and rematerialised layers' own spans.
        with span("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        average_gradients([p.grad for p in params], mesh)
        with span("grad_norm"):
            # The global norm of the gradients (optax.global_norm), before the update.
            metrics["grad_norm"] = grad_norm(model)
        with span("optimizer"):
            state.optimizer.step()
        if state.ema is not None:
            with span("ema"), torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, torch._foreach_mul([p for _, p in model.named_parameters()], 1.0 - ema_decay))
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
