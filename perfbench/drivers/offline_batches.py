"""Offline batches: G serving back to back, the paper's dataset augmentation.

Each batch is `batch` words of `length` letters drawn from the seed on the
device, with noise z drawn likewise, through `Generator.forward(labels, z)`
under `torch.inference_mode`. The rate is every image completed in the
window over the window's seconds, the window ending in a synchronise. A
seeded sample of the window's batches (inputs and outputs) is kept and,
once the program is freed, compared with the reference's float32 G on the
same weights and inputs.

Traffic parameters: kind, batch, length, z_source, compare_batches,
trace_units, warmup.
"""

from __future__ import annotations

import time

import torch

from perfbench import common, trace, weights, work
from perfbench.reference import nets

REF_ROWS = 256  # the reference runs in blocks of rows


class Driver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.cfg_file, self.traffic, self.seed = cfg_file, traffic, seed
        self.device = torch.device(device)
        self.serving = cfg_file["serving"]["offline_batches"]
        self.batch, self.length = traffic["batch"], traffic["length"]

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from scrabblegan_torch.models.build import build_generator

        cfg = common.port_config(self.cfg_file, self.serving, self.seed)
        self.latent, self.classes = cfg.shared.latent_dim, cfg.io.n_classes
        self.generator = build_generator(cfg, self.device)
        self.leaves = weights.specs(self.generator)
        tensors = weights.make({"g": self.leaves}, self.seed, self.device)["g"]
        gen = weights.seed_generator(self.seed + 1, self.device)
        cal_labels = torch.randint(0, self.classes, (64, self.length), generator=gen,
                                   device=self.device)
        cal_z = torch.randn(64, self.latent, generator=gen, device=self.device)
        weights.calibrate_generator(tensors, cal_labels, cal_z)
        weights.load(self.generator, tensors)
        self.host_weights = {k: v.cpu() for k, v in tensors.items()}
        del tensors
        self.inputs_gen = weights.seed_generator(self.seed + 2, self.device)
        with torch.inference_mode():
            for _ in range(self.traffic["warmup"]):
                self.generator(*self._inputs())
        common.sync(self.device)

    def _inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        labels = torch.randint(0, self.classes, (self.batch, self.length),
                               generator=self.inputs_gen, device=self.device)
        z = torch.randn(self.batch, self.latent, generator=self.inputs_gen, device=self.device)
        return labels, z

    def window(self, seconds: float, spans: common.Spans) -> dict:
        self.sample = common.Sample(self.traffic["compare_batches"], self.seed)
        n = 0
        common.sync(self.device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            while True:
                labels, z = self._inputs()
                with spans("forward"):
                    out = self.generator(labels, z)
                self.sample.offer((labels, z, out))
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        common.sync(self.device)
        elapsed = time.perf_counter() - t0
        self.attempted = n * self.batch
        return {"images_per_s": n * self.batch / elapsed, "window_s": elapsed}

    def traced(self, spans: common.Spans) -> trace.Slice:
        units = self.traffic["trace_units"]
        with torch.inference_mode(), trace.profiled(self.device) as prof:
            for _ in range(units):
                with spans("forward"):
                    self.generator(*self._inputs())
        return trace.reduce(prof, units)

    def free(self) -> None:
        self.sample.map(lambda item: tuple(t.cpu() for t in item))
        del self.generator
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- reference
    def reference(self, labels: torch.Tensor, z: torch.Tensor, prec: str = "float32",
                  tensors: dict | None = None) -> torch.Tensor:
        """The reference's images for (labels, z), in blocks of rows, float32."""
        t = tensors or {k: v.to(self.device) for k, v in self.host_weights.items()}
        outs = []
        with torch.no_grad(), common.exact_float32():
            for i in range(0, labels.shape[0], REF_ROWS):
                outs.append(nets.generator(nets.Net(t, prec), labels[i:i + REF_ROWS].to(self.device),
                                           z[i:i + REF_ROWS].to(self.device)).float().cpu())
        return torch.cat(outs)

    def compare(self) -> tuple[dict, list]:
        return self._compare()

    def _compare(self, produce=None) -> tuple[dict, list]:
        """{number: worst reading} over the sampled batches' images, and each
        image's reading: every image is an answer. `produce(labels, z, t)`
        stands in for the program's outputs (controls)."""
        t = {k: v.to(self.device) for k, v in self.host_weights.items()}
        per_unit = []
        for labels, z, out in self.sample.items():
            if produce is not None:
                out = produce(labels, z, t)
            ref = self.reference(labels, z, tensors=t)
            per_unit += [{"img_rel_l2": gap} for gap in common.rel_l2(out.float(), ref)]
        return {"img_rel_l2": max(u["img_rel_l2"] for u in per_unit)}, per_unit

    def control(self) -> tuple[dict, list]:
        """The reference in the nearest precision below the served one, in the
        program's place."""
        prec = common.lower_precision(self.serving["shared.dtype"])
        return self._compare(lambda labels, z, t: self.reference(labels, z, prec, t))

    def work(self) -> dict:
        flops = work.generator_flops(self.leaves, self.batch, self.length)
        q = 32 * 16 * self.length  # G's B3 runs at the full image size
        attn_flops, attn_bytes = work.attention_core(self.batch, q, q // 4)
        return {"flops_per_image": flops / self.batch, "attn_flops_per_unit": attn_flops,
                "attn_bytes_per_unit": attn_bytes}
