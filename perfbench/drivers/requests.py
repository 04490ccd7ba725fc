"""One-user requests in a closed loop: a user renders a word in their own
handwriting.

One client sends a request, waits for its images on the host, and sends the
next. A request is `batch` images of one word: the word's length comes from
a fixed cycle that holds each length as often as its weight says (so every
seed does the same work, in another order), its letters from the seed; its
style page is one of `style_pages` seeded pages, expanded to the batch as
`infer` does. The path is `infer`'s: the labels copied to the card,
`Generator.forward(labels, style_imgs=...)` under `torch.inference_mode`,
the images copied back as float32. Latency is each request's start to its
images on the host; the tail is the 95th percentile over every request of
the window. A seeded sample of the requests, with some of the longest among
them, is compared with the reference once the program is freed.

Traffic parameters: kind, batch, length_cycle (requests a cycle by length
1..n), style_pages, compare_requests, compare_longest, trace_units, warmup
(calls a length at set-up), warm_requests (requests of the loop at set-up,
so the window starts in its steady state).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import common, datagen, trace, weights
from perfbench.reference import nets


class Driver:
    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device):
        self.cfg_file, self.traffic, self.seed = cfg_file, traffic, seed
        self.device = torch.device(device)
        self.serving = cfg_file["serving"]["requests"]
        self.batch = traffic["batch"]
        self.cycle = np.repeat(np.arange(1, len(traffic["length_cycle"]) + 1),
                               traffic["length_cycle"])
        self.rng = np.random.default_rng([seed % (2 ** 63), 3])

    def setup(self) -> None:
        from scrabblegan_torch.models.build import build_generator

        cfg = common.port_config(self.cfg_file, self.serving, self.seed)
        self.classes = cfg.io.n_classes
        self.g_prec = cfg.shared.dtype
        self.style_prec = cfg.shared.trunk_dtype or cfg.shared.dtype
        self.generator = build_generator(cfg, self.device)
        self.leaves = weights.specs(self.generator)
        tensors = weights.make({"g": self.leaves}, self.seed, self.device)["g"]
        pages = datagen.style_pages(self.seed, self.traffic["style_pages"])
        self.pages = torch.from_numpy(pages)[:, None].to(self.device)
        gen = weights.seed_generator(self.seed + 1, self.device)
        cal = torch.randint(0, self.classes, (64, int(self.cycle.max())), generator=gen,
                            device=self.device)
        weights.calibrate_generator(tensors, cal, style_imgs=self.pages[
            torch.arange(64, device=self.device) % self.pages.shape[0]])
        weights.load(self.generator, tensors)
        self.host_weights = {k: v.cpu() for k, v in tensors.items()}
        del tensors
        self._order = []
        with torch.inference_mode():
            for length in sorted(set(self.cycle.tolist())):
                for _ in range(self.traffic["warmup"]):
                    self._serve(*self._request_for(length))
            for _ in range(self.traffic["warm_requests"]):  # the loop's steady state
                self._serve(*self._next_request())
        common.sync(self.device)

    def _request_for(self, length: int) -> tuple[np.ndarray, int]:
        word = self.rng.integers(0, self.classes, size=int(length))
        return word, int(self.rng.integers(0, self.traffic["style_pages"]))

    def _next_request(self) -> tuple[np.ndarray, int]:
        if not self._order:
            self._order = self.rng.permutation(self.cycle).tolist()
        return self._request_for(self._order.pop())

    def _serve(self, word: np.ndarray, page: int) -> torch.Tensor:
        labels = torch.from_numpy(np.tile(word.astype(np.int64), (self.batch, 1))).to(self.device)
        style = self.pages[page][None].expand(self.batch, -1, -1, -1)
        images = self.generator(labels, style_imgs=style)
        return images.float().cpu()

    def window(self, seconds: float, spans: common.Spans) -> dict:
        self.sample = common.Sample(self.traffic["compare_requests"], self.seed, 1)
        self.longest = common.Sample(self.traffic["compare_longest"], self.seed, 2)
        top = int(self.cycle.max())
        latencies = []
        common.sync(self.device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            while time.perf_counter() - t0 < seconds:
                word, page = self._next_request()
                start = time.perf_counter()
                with spans("request"):
                    images = self._serve(word, page)
                latencies.append(time.perf_counter() - start)
                item = (word, page, images)
                self.sample.offer(item)
                if len(word) == top:
                    self.longest.offer(item)
        elapsed = time.perf_counter() - t0
        self.attempted = len(latencies)
        ms = np.asarray(latencies) * 1e3
        return {"request_p95_ms": float(np.percentile(ms, 95)),
                "request_p50_ms": float(np.percentile(ms, 50)),
                "requests_per_s": len(ms) / elapsed, "window_s": elapsed}

    def traced(self, spans: common.Spans) -> trace.Slice:
        units = self.traffic["trace_units"]
        with torch.inference_mode(), trace.profiled(self.device) as prof:
            for _ in range(units):
                with spans("request"):
                    self._serve(*self._next_request())
        return trace.reduce(prof, units)

    def free(self) -> None:
        del self.generator
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, word, page, t, g_prec="float32", style_prec="float32") -> torch.Tensor:
        labels = torch.from_numpy(np.tile(word.astype(np.int64), (self.batch, 1))).to(self.device)
        style = self.pages[page][None].expand(self.batch, -1, -1, -1)
        with torch.no_grad(), common.exact_float32():
            return nets.generator(nets.Net(t, g_prec), labels, style_imgs=style,
                                  style_net=nets.Net(t, style_prec)).float().cpu()

    def compare(self) -> tuple[dict, list]:
        return self._compare()

    def _compare(self, produce=None) -> tuple[dict, list]:
        """{number: worst reading} over the sampled requests' images, and each
        request's worst image. `produce(word, page, t)` stands in for the
        program's images (controls)."""
        t = {k: v.to(self.device) for k, v in self.host_weights.items()}
        per_unit = []
        for word, page, images in self.sample.items() + self.longest.items():
            if produce is not None:
                images = produce(word, page, t)
            per_unit.append({"img_rel_l2": max(common.rel_l2(images,
                                                             self.reference(word, page, t)))})
        return {"img_rel_l2": max(u["img_rel_l2"] for u in per_unit)}, per_unit

    def control(self) -> tuple[dict, list]:
        """The reference with G and the style encoder each one precision below
        their served ones, in the program's place."""
        g, s = common.lower_precision(self.g_prec), common.lower_precision(self.style_prec)
        return self._compare(lambda word, page, t: self.reference(word, page, t, g, s))

    def work(self) -> dict:
        return {}  # no reader of this cell takes a work count
