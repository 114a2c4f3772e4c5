"""1-reference requests through the demo's entry point,
``leftrefill_torch.serving.gradio_app.predict``, from one client that sends
the next request as the last one returns.  The traffic file gives the served size, the images per request, the sampler
and the hole's share of the target; every request has photos, a
brush-stroke mask and a sampler seed of its own, drawn from the run's seed in
set-up and handed to ``predict`` as the uint8 arrays a user sends."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import flops, inputs, port
from benchmark.reference import pipelines

KIND = "infer"
RATE = "images_per_s"


class Driver:
    KIND = KIND

    def __init__(self, run):
        self.run, self.cfg, self.t = run, run.cfg, run.traffic
        self.per_unit = self.t["num_samples"]
        self.sampler = {"ddim_steps": self.t["ddim_steps"], "eta": self.cfg["sampler"]["eta"],
                        "scale": self.t["scale"]}
        self.outputs: dict = {}

    def setup(self, weights):
        dev, s = self.run.device, self.t["img_size"]
        gen = inputs.generator(self.run.seed, "requests", dev)
        self.requests = []
        for _ in range(self.t["pool"] + 1):  # the last one warms up
            pics = inputs.to_uint8(inputs.photos(gen, 2, s, s, dev)).cpu().numpy()
            mask = (inputs.brush_mask(gen, s, tuple(self.t["hole_share"]), dev) * 255).to(torch.uint8).cpu().numpy()
            seed = int(torch.randint(0, 2**62, (), generator=gen, device=dev))
            self.requests.append({"reference": pics[0], "source": pics[1], "mask": mask, "seed": seed,
                                  "num_samples": self.per_unit})
        if weights is None:
            return
        from leftrefill_torch.pipeline import RefInpaintPipeline
        from leftrefill_torch.serving import gradio_app

        tok, sp, _ = port.tokenizer(self.cfg)
        self.pipe = RefInpaintPipeline(model=port.build_model(self.cfg, weights, dev), tokenizer=tok,
                                       special_tokens=sp, device=dev, ddim_steps=self.t["ddim_steps"],
                                       guidance_scale=self.t["scale"], eta=self.cfg["sampler"]["eta"])
        self.predict = gradio_app.predict

    def _req(self, i):
        return self.requests[i % self.t["pool"]] if i >= 0 else self.requests[-1]

    def warm(self):
        self.unit(-1)

    def unit(self, i):
        r = self._req(i)
        out = self.predict(self.pipe, r["reference"], r["source"], r["mask"], ddim_steps=self.t["ddim_steps"],
                           num_samples=self.per_unit, scale=self.t["scale"], seed=r["seed"],
                           img_size=self.t["img_size"])
        self.outputs[i] = out

    def release(self):
        self.pipe = None

    def control_units(self) -> int:
        return 1

    def control(self, weights, arith):
        self.outputs[0] = pipelines.predict(weights, self.cfg, self._req(0), self.sampler, arith, self.run.device)

    def check(self, weights, arith, units: int) -> dict:
        """The request the seed picks among those finished, against the
        reference on the same photos, mask and seed: the widest RMS over the
        hole of its images (uint8 steps), and the pixels outside the hole
        that differ (none may)."""
        i = inputs.pick(self.run.seed, "checked request", units)
        r = self._req(i)
        ref = pipelines.predict(weights, self.cfg, r, self.sampler, arith, self.run.device)
        hole = r["mask"] > 0
        if len(self.outputs[i]) != len(ref):
            return {"hole_rms": float("inf"), "outside_changed": hole.size * len(ref)}
        rms, outside = 0.0, 0
        for got, want in zip(self.outputs[i], ref):
            d = got.astype(np.float64) - want.astype(np.float64)
            rms = max(rms, float(np.sqrt(np.mean(d[hole] ** 2))))
            outside += int(np.any(d[~hole] != 0, axis=-1).sum())
        return {"hole_rms": rms, "outside_changed": outside}

    @property
    def flops_per_unit(self) -> float:
        s = self.t["img_size"]
        return flops.sampling_flops(self.cfg, self.per_unit, s, 2 * s, self.t["ddim_steps"], cfg_dup=True)
