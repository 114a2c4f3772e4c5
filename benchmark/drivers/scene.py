"""Multi-view scene calls through ``leftrefill_torch.pipeline.MultiViewInpaintPipeline``,
from one client that sends the next call as the last one returns.  The
traffic file gives the scenes a call, the view size, the sampler and the
hole's share of view 0; every call has its views (view 0 holed, the others
whole) and a sampler seed of its own, drawn from the run's seed in set-up
and kept on the device."""

from __future__ import annotations

import torch

from benchmark import flops, inputs, port
from benchmark.reference import pipelines

KIND = "infer"
RATE = "images_per_s"


class Driver:
    KIND = KIND

    def __init__(self, run):
        self.run, self.cfg, self.t = run, run.cfg, run.traffic
        self.per_unit = self.t["scenes"]  # the target view of each scene
        self.sampler = {"ddim_steps": self.t["ddim_steps"], "eta": self.cfg["sampler"]["eta"],
                        "scale": self.t["scale"]}
        self.outputs: dict = {}

    def setup(self, weights):
        dev, s, v, b = self.run.device, self.t["img_size"], self.cfg["view_num"], self.t["scenes"]
        gen = inputs.generator(self.run.seed, "calls", dev)
        self.calls = []
        for _ in range(self.t["pool"] + 1):  # the last one warms up
            images = inputs.photos(gen, b * v, s, s, dev).reshape(b, v, s, s, 3)
            masks = torch.zeros((b, v, s, s, 1), device=dev)
            for j in range(b):
                masks[j, 0, :, :, 0] = inputs.brush_mask(gen, s, tuple(self.t["hole_share"]), dev)
            seed = int(torch.randint(0, 2**62, (), generator=gen, device=dev))
            self.calls.append({"images": images, "masks": masks, "seed": seed})
        if weights is None:
            return
        from leftrefill_torch.pipeline import MultiViewInpaintPipeline

        tok, _, view_prompts = port.tokenizer(self.cfg)
        self.pipe = MultiViewInpaintPipeline(model=port.build_model(self.cfg, weights, dev), tokenizer=tok,
                                             view_prompts=view_prompts, device=dev, ddim_steps=self.t["ddim_steps"],
                                             guidance_scale=self.t["scale"], eta=self.cfg["sampler"]["eta"])

    def _call(self, i):
        return self.calls[i % self.t["pool"]] if i >= 0 else self.calls[-1]

    def warm(self):
        self.unit(-1)

    def unit(self, i):
        c = self._call(i)
        out = self.pipe(c["images"], c["masks"], generator=torch.Generator(self.run.device).manual_seed(c["seed"]))
        self.outputs[i] = out

    def release(self):
        self.pipe = None

    def control_units(self) -> int:
        return 1

    def control(self, weights, arith):
        c = self._call(0)
        j = inputs.pick(self.run.seed, "checked scene", self.t["scenes"])
        out = torch.zeros_like(c["images"])
        out[j] = pipelines.scene(weights, self.cfg, c["images"], c["masks"], c["seed"], j, self.sampler, arith)
        self.outputs[0] = out

    def check(self, weights, arith, units: int) -> dict:
        """The scene the seed picks in the call it picks among those
        finished, against the reference on the same views and seed: the RMS
        over view 0's hole (uint8 steps of the [-1, 1] range), and the pixels
        outside the holes of its views that differ (none may)."""
        i = inputs.pick(self.run.seed, "checked request", units)
        j = inputs.pick(self.run.seed, "checked scene", self.t["scenes"])
        c = self._call(i)
        want = pipelines.scene(weights, self.cfg, c["images"], c["masks"], c["seed"], j, self.sampler, arith)
        got = self.outputs[i][j]
        d = (got.to(torch.float64) - want.to(torch.float64)) * 127.5
        hole = c["masks"][j, :, :, :, 0] > 0.5
        rms = float(torch.sqrt((d[0][hole[0]] ** 2).mean()))
        outside = int(((d != 0).any(dim=-1) & ~hole).sum())
        return {"hole_rms": rms, "outside_changed": outside}

    @property
    def flops_per_unit(self) -> float:
        s, v = self.t["img_size"], self.cfg["view_num"]
        return flops.sampling_flops(self.cfg, self.t["scenes"] * v, s, s, self.t["ddim_steps"], views=v)
