"""Traffic "train": the program's training step on batches of its own data pipeline.

Parameters (the traffic file): `batch`, `corpus` structures, `corpus_seed`,
`min_length` (the corpus's lengths are uniform in [min_length, the
configuration's maximumNumResidues]), `checked_steps`, `warmup_steps` and
`trace_steps`.

Set-up builds one TrainState (the program's Adam, and EMA where the
configuration asks for it) and one step function (`make_train_step`), and
feeds it batches of `synthetic_dataset`'s random-walk corpus, drawn from the
configuration's `corpus_seed` so that every run's work is the same, through
`StructureDataset.epoch` (motif augmentation at the configuration's
motifProbability, each item padded to maximumNumResidues) and the program's
`prefetch`, epoch after epoch. The run's seed orders the epochs and draws
each step's t, noise and dropout seed. The first `checked_steps` steps are
set-up; the window goes on with the same state and feed. A step's work is
the real residues of its batch.

Correctness: the reference repeats the checked steps from the same weights,
with its own batches, and compares the first step's loss, the weights'
first gradients (from the program's Adam state after step 1) and their
changes after the last checked step, by the gaps between the two norms.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.harness import port, registry
from portbench.harness.weights import make_weights
from portbench.reference import genie2 as ref
from portbench.reference import inputs as ref_inputs

TAG_WEIGHTS, TAG_ORDER, TAG_NOISE, TAG_DROPOUT = 1, 5, 6, 7
# An entry whose reference gradient is under this share of the median
# weight's root mean square entry is moved by Adam by round-off alone (a
# bias that softmax cancels, as the key half of the IPA's linear_kv bias and
# its pair bias's bias): its change is not compared.
STILL_ENTRY = 1e-3


def finite(x) -> float:
    v = float(x)
    return float("inf") if v != v else v


class Generator:
    """program "port": the program's training step; "control": the
    reference's step in its place, in TF32."""

    def __init__(self, cell, seed: int, device, program: str = "port"):
        self.cell, self.seed, self.device, self.program = cell, int(seed), device, program
        self.tr = cell.traffic
        self.conf = cell.config["configuration"]
        self.sizes = ref.sizes(self.conf)
        self.B, self.N = int(self.tr["batch"]), int(self.conf["maximumNumResidues"])
        self.dtype = cell.config["dtype"]
        self.model = None
        self.model_calls = 0
        self.residues = 0
        self.losses: List[torch.Tensor] = []
        self.inputs: List[tuple] = []  # (t, noise, dropout seed) of the checked steps

    def length(self) -> int:
        return self.N

    def setup(self):
        self.weights = make_weights(ref.parameter_spec(self.conf), registry.subseed(self.seed, TAG_WEIGHTS),
                                    self.device)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(registry.subseed(self.seed, TAG_NOISE))
        self.dropout_rng = np.random.default_rng(registry.subseed(self.seed, TAG_DROPOUT))
        if self.program == "port":
            self._setup_port()
        else:
            self._setup_control()
        n_checked = int(self.tr["checked_steps"])
        for i in range(n_checked):
            self.step()
            if i == 0:
                self.first_grads = self._first_grads()
        self.after = {k: v.detach().clone() for k, v in self._params().items()}
        for _ in range(int(self.tr["warmup_steps"])):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.residues = 0

    def _setup_port(self):
        from genie2_tpu_torch.diffusion import Schedule
        from genie2_tpu_torch.features import to_device
        from genie2_tpu_torch.train.data import MotifAugmentConfig, synthetic_dataset
        from genie2_tpu_torch.train.prefetch import prefetch
        from genie2_tpu_torch.train.state import create_train_state, make_train_step

        cfg, model = port.build(self.cell.config, self.weights)
        self.model = model
        self.state = create_train_state(model, cfg.optimization["lr"], cfg.training["ema_decay"])
        schedule = Schedule.create(cfg.diffusion["n_timestep"], cfg.diffusion["schedule"], device=self.device)
        self.step_fn = make_train_step(schedule, cfg.training["condition_loss_weight"], cfg.tpu["compute_dtype"],
                                       cfg.training["ema_decay"])
        data = synthetic_dataset(int(self.tr["corpus"]), self.N, np.random.default_rng(int(self.tr["corpus_seed"])),
                                 int(self.tr["min_length"]), MotifAugmentConfig.from_config(cfg))
        order = np.random.default_rng(registry.subseed(self.seed, TAG_ORDER))

        def batches():
            while True:
                yield from data.epoch(self.B, order)

        def place(batch):
            return to_device(batch, self.device), int(batch["residue_mask"].sum())

        self.feed = prefetch(batches(), place, depth=cfg.training["prefetch_depth"])

    def _setup_control(self):
        self.sched = ref.cosine_schedule(int(self.sizes["numTimesteps"]), self.device)
        self.params = {k: v.clone().requires_grad_(True) for k, v in self.weights.items()}
        self.adam = ref.Adam(self.params, float(self.sizes["learningRate"]))
        self.batches = self.reference_batches()

    def reference_batches(self):
        tr = self.tr
        items = ref_inputs.corpus(int(tr["corpus"]), int(tr["min_length"]), self.N, int(tr["corpus_seed"]))
        order = np.random.default_rng(registry.subseed(self.seed, TAG_ORDER))
        prob = float(self.conf.get("motifProbability", 0.8))
        for batch in ref_inputs.epochs(items, self.B, order, prob):
            yield ref_inputs.stack(batch, self.N, self.device)

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters()) if self.program == "port" else self.params

    def _first_grads(self) -> Dict[str, torch.Tensor]:
        """Each weight's first gradient, as its Adam state holds it after one
        step (the first moment is (1 - b1) g)."""
        if self.program == "port":
            state = self.state.optimizer.state
            return {k: state[p]["exp_avg"] / 0.1 if p in state else torch.zeros_like(p)
                    for k, p in self.model.named_parameters()}
        return {k: m / 0.1 for k, m in self.adam.m.items()}

    def _draw(self):
        t = torch.randint(1, int(self.sizes["numTimesteps"]) + 1, (self.B,), generator=self.noise_gen,
                          device=self.device)
        noise = torch.randn((self.B, self.N, 3), generator=self.noise_gen, device=self.device)
        return t, noise, int(self.dropout_rng.integers(2**62))

    def step(self):
        t, noise, dropout_seed = self._draw()
        if self.program == "port":
            features, n_real = next(self.feed)
            metrics = self.step_fn(self.state, features, t=t, noise=noise, dropout_seed=dropout_seed)
            loss = metrics["weighted_loss"]
        else:
            f = next(self.batches)
            n_real = int(f["residue_mask"].sum())
            with ref.precision(tf32=True):
                loss = self.reference_step(self.params, self.adam, self.sched, f, t, noise, dropout_seed)
        if len(self.losses) < int(self.tr["checked_steps"]):
            self.losses.append(loss.detach())
            self.inputs.append((t, noise, dropout_seed))
        self.model_calls += 1
        self.residues += n_real

    def reference_step(self, params, adam, sched, f, t, noise, dropout_seed) -> torch.Tensor:
        mask = f["residue_mask"]
        z, x_t = ref.noised(sched, f["atom_positions"], t, noise, mask)
        rots = ref.frenet_frames(x_t, f["chain_index"], mask)
        z_pred = ref.denoise(params, self.conf, rots, x_t, t, f, dropout_seed)
        loss = ref.loss(z_pred, z, f, float(self.sizes["conditionLossWeight"]))
        grads = torch.autograd.grad(loss, list(params.values()))
        adam.step(params, dict(zip(params, grads)))
        return loss

    def end_to_end(self, steps: int, window_s: float) -> Dict[str, float]:
        return {"train_residues_per_s": self.residues / window_s}

    def release(self):
        if self.program == "port":
            self.feed.close()
            self.model = self.state = self.step_fn = self.feed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """A weight's gap is the gap between the program's and the
        reference's norms of its first gradient (of its change over the
        checked steps), over the larger of the reference's norm of that
        weight and of the median weight. loss_err: the first step's
        |loss - ref| / |ref|; grad_err: the median weight's gradient gap;
        update_err: the worst weight's change gap. The later steps' losses
        and the worst weight's gradient gap are left to `detail`: Adam moves
        every weight by about its rate whatever its gradient's size, so
        rounding in small gradients swings them from seed to seed
        (PERF.md section 2)."""
        n = len(self.losses)
        start = make_weights(ref.parameter_spec(self.conf), registry.subseed(self.seed, TAG_WEIGHTS), self.device)
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        adam = ref.Adam(params, float(self.sizes["learningRate"]))
        sched = ref.cosine_schedule(int(self.sizes["numTimesteps"]), self.device)
        batches = self.reference_batches()
        ref_losses = []
        with ref.precision(tf32=False):
            for i in range(n):
                t, noise, dropout_seed = self.inputs[i]
                loss = self.reference_step(params, adam, sched, next(batches), t, noise, dropout_seed)
                ref_losses.append(loss.detach())
                if i == 0:
                    ref_grads = {k: m / 0.1 for k, m in adam.m.items()}
        loss_gaps = [finite((a - b).abs() / b.abs()) for a, b in zip(self.losses, ref_losses)]
        g_ref = {k: v.norm().item() for k, v in ref_grads.items()}
        g_med = float(np.median(list(g_ref.values())))
        grad_gaps = {k: finite(abs(self.first_grads[k].norm() - g_ref[k]) / max(g_ref[k], g_med)) for k in g_ref}
        # The entries that move: first gradient at least STILL_ENTRY of the
        # median weight's root mean square entry.
        rms = float(np.median([g_ref[k] / v.numel() ** 0.5 for k, v in ref_grads.items()]))
        moving = {k: v.abs() >= STILL_ENTRY * rms for k, v in ref_grads.items()}
        moving = {k: m for k, m in moving.items() if m.any()}
        d_ref = {k: ((params[k].detach() - start[k]) * m).norm().item() for k, m in moving.items()}
        d_med = float(np.median(list(d_ref.values())))
        update_gaps = {k: finite(abs(((self.after[k] - start[k]) * m).norm() - d_ref[k]) / max(d_ref[k], d_med))
                       for k, m in moving.items()}
        worst_g, worst_u = max(grad_gaps, key=grad_gaps.get), max(update_gaps, key=update_gaps.get)
        self.detail = {"loss_gap_by_step": loss_gaps, "worst_gradient": [worst_g, grad_gaps[worst_g]],
                       "worst_change": [worst_u, update_gaps[worst_u]]}
        return {"loss_err": loss_gaps[0], "grad_err": finite(np.median(list(grad_gaps.values()))),
                "update_err": update_gaps[worst_u]}
