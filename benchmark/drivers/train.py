"""Prompt-tuning steps through the program's ``train.make_train_step`` and
``PromptOptimizer`` (AdamW on the prompt table, remat on), fed from a pool
of batches that set-up draws from the run's seed and leaves on the device,
as a loader that prefetches to the card would.  The traffic file gives the
batch, the canvas size and the pool's length; t and the noise come from the
step's own generator.  Set-up takes the first three steps; the window
cycles through the pool after them.  The check follows the three and one
step of the window that the seed picks among its first ``pool``, all from
the start."""

from __future__ import annotations

import torch

from benchmark import flops, inputs, port
from benchmark.reference import pipelines

KIND = "train"
RATE = "train_samples_per_s"
CHECKED_STEPS = 3


class Driver:
    KIND = KIND

    def __init__(self, run):
        self.run, self.cfg, self.t = run, run.cfg, run.traffic
        self.per_unit = self.t["batch"]
        self.losses: list = []
        self.window_states: list = []  # the step generator's state before window step i < pool
        self.window_tables: list = []  # the prompt table after window step i < pool

    def setup(self, weights):
        dev, s, b = self.run.device, self.t["img_size"], self.t["batch"]
        gen = inputs.generator(self.run.seed, "batches", dev)
        tokens = torch.from_numpy(pipelines.tokenize(pipelines.prompts(self.cfg) * b,
                                                     pipelines.special_tokens(self.cfg))).to(dev)
        self.pool = []
        for _ in range(self.t["pool"]):
            image = inputs.photos(gen, b, s, 2 * s, dev)
            mask = torch.zeros((b, s, 2 * s, 1), device=dev)
            mask[:, :, s:] = 1.0  # the target half
            self.pool.append({"image": image, "mask": mask, "masked_image": image * (mask < 0.5), "tokens": tokens})
        self.gen = inputs.generator(self.run.seed, "step draws", dev)
        if weights is None:
            return
        from leftrefill_torch.train import OptimizerConfig, create_train_state, make_train_step

        o = self.cfg["train"]
        model = port.build_model(self.cfg, weights, dev, remat=True)
        self.state, self.tx = create_train_state(model, OptimizerConfig(
            lr=o["lr"], weight_decay=o["weight_decay"], b1=o["betas"][0], b2=o["betas"][1], eps=o["eps"]))
        self.table = self.tx.params[0]
        self.train_step = make_train_step(model, self.tx)

    def _step(self, batch):
        self.state, metrics = self.train_step(self.state, batch, self.gen)
        return metrics["loss"]

    def warm(self):
        self.table0 = self.table.detach().clone()
        self.states = []
        for k in range(CHECKED_STEPS):
            self.states.append(self.gen.get_state())
            self._step(self.pool[k])
            if k == 0:
                st = self.tx.adamw.state.get(self.table, {})
                self.grad1 = (st["exp_avg"] / (1 - self.tx.config.b1) if "exp_avg" in st
                              else torch.zeros_like(self.table0))
        self.table3 = self.table.detach().clone()

    def unit(self, i):
        kept = i < len(self.pool)
        if kept:
            self.window_states.append(self.gen.get_state())
        self.losses.append(self._step(self.pool[(CHECKED_STEPS + i) % len(self.pool)]))
        if kept:  # a copy on the device, 200 KB: nothing is read back inside the window
            self.window_tables.append(self.table.detach().clone())

    def release(self):
        self.train_step = self.state = self.tx = self.table = None

    def _batches(self, n: int) -> list:
        return [self.pool[k % len(self.pool)] for k in range(n)]

    def control_units(self) -> int:
        ds = 2 ** (len(self.cfg["vae"]["ch_mult"]) - 1)
        b, s, dev = self.t["batch"], self.t["img_size"], self.run.device
        states = []
        for _ in range(CHECKED_STEPS + len(self.pool)):  # the draws the program's steps would take: t, the noise
            states.append(self.gen.get_state())
            torch.randint(0, self.cfg["schedule"]["timesteps"], (b,), generator=self.gen, device=dev)
            torch.randn((b, s // ds, 2 * s // ds, self.cfg["vae"]["z_channels"]), generator=self.gen, device=dev)
        self.states, self.window_states = states[:CHECKED_STEPS], states[CHECKED_STEPS:]
        return len(self.pool)

    def control(self, weights, arith):
        n = CHECKED_STEPS + len(self.pool)
        r = pipelines.train_steps(weights, self.cfg, self._batches(n), self.states + self.window_states, arith,
                                  self.run.device, keep=range(1, n + 1))
        self.grad1, self.table0, self.table3 = r["grad1"], r["table0"], r["tables"][CHECKED_STEPS]
        self.window_tables = [r["tables"][k] for k in range(CHECKED_STEPS + 1, n + 1)]

    def check(self, weights, arith, units: int) -> dict:
        """The reference's steps from the same weights, batches and draws,
        from the start through the window step ``w`` that the seed picks
        among the first ``pool`` (so every batch of the pool and the
        optimizer's state after set-up are covered).  The first gradient
        (the optimizer's first moment after one step over 1 - beta1): its
        relative L2 distance from the reference's, and the relative gap of
        the two norms; the relative gap of the norms of the table's change
        over the three set-up steps; the relative L2 distance of the change
        that window step ``w`` made from the reference's; the steps of the
        window whose loss is not finite.  (The losses, and the norm gaps
        alone, do not separate the fp8 control from sound runs: a gap of
        norms sees an error only through its projection on the gradient.)"""
        w = inputs.pick(self.run.seed, "checked window step", min(units, len(self.window_tables)))
        n = CHECKED_STEPS + w + 1
        r = pipelines.train_steps(weights, self.cfg, self._batches(n), self.states + self.window_states[:w + 1],
                                  arith, self.run.device, keep={CHECKED_STEPS, n - 1, n})
        rel = lambda a, b: float((a - b).abs() / b.abs())
        change_ref = (r["tables"][CHECKED_STEPS] - r["table0"]).norm()
        step = self.window_tables[w] - (self.window_tables[w - 1] if w else self.table3)
        step_ref = r["tables"][n] - r["tables"][n - 1]
        window = torch.stack(self.losses) if self.losses else torch.zeros(0)
        return {"grad_rel_l2": float((self.grad1 - r["grad1"]).norm() / r["grad1"].norm()),
                "grad_norm_gap": rel(self.grad1.norm(), r["grad1"].norm()),
                "change_norm_gap": rel((self.table3 - self.table0).norm(), change_ref),
                "window_step_rel_l2": float((step - step_ref).norm() / step_ref.norm()),
                "window_nonfinite": int((~torch.isfinite(window)).sum())}

    @property
    def flops_per_unit(self) -> float:
        s = self.t["img_size"]
        return flops.train_step_flops(self.cfg, self.t["batch"], s, 2 * s)
