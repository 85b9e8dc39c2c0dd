"""Serving one clip at a time through ``serving.py::ViMoCLIPPredictor.
predict_videos([clip])``: a closed loop of one client, each request a host
uint8 clip cut from a frame pool made at set-up, sent when the previous one
has been answered. A request's latency is the host clock around the call,
which returns the probabilities on the host.

The check: a sample of the window's requests drawn from the seed, the
longest among them, run through the plain float32 cascade (teacher on the
frames, student on their grey differences, TFAM with each clip's own
masked mean, sigmoid). The numbers, each the sample's worst: the cosine
distance between the program's and the reference's logits, each centred on
its mean; the logit error relative to the reference logits' spread; the
largest probability gap."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import generator as mix
from perfbench import weights
from perfbench.drivers import _common as common
from perfbench.reference import precision
from perfbench.reference import tfam as ref_tfam
from perfbench.reference import vit as ref_vit


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed, self.control = config, traffic, seed, control
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.answers: list[tuple[int, int, np.ndarray]] = []  # (pool start, frames, probs)
        self.latencies: list[float] = []
        self.failed = 0

    def setup(self) -> None:
        from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

        c, s = self.config, self.config["serving"]
        dev = self.device
        self.teacher = common.tower_params(c["teacher"], self.seed, 1, dev)
        self.student = common.tower_params(c["student"], self.seed, 2, dev)
        self.tfam = weights.make_params(ref_tfam.param_shapes(c["tfam"], c["num_classes"]),
                                        weights.generator(self.seed, 3, dev))
        self.pool = common.frame_pool(self.traffic, self.seed)
        self.predictor = ViMoCLIPPredictor(
            self.teacher, common.vision_config(c["teacher"], int8=self.control),
            self.student, common.vision_config(c["student"], int8=self.control),
            self.tfam, common.tfam_config(c["tfam"]), num_classes=c["num_classes"],
            frame_batch=s["frame_batch"], length_bucket=s["length_bucket"],
            max_seq_len=s["max_seq_len"], half_precision=s["dtype"] == "bfloat16",
            device=dev)
        self.order = mix.lengths(self.traffic["lengths"], self.rng)
        # one warm request per (rgb, motion) bucket pair the lengths reach
        for n in mix.warm_lengths(self.traffic["lengths"], s["length_bucket"],
                                  s["max_seq_len"]):
            self._request(n, record=False)

    def _request(self, n: int, record: bool) -> None:
        start = int(self.rng.integers(0, len(self.pool) - n + 1))
        clip = self.pool[start:start + n]
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("perfbench.request"):
                probs = self.predictor.predict_videos([clip])[0].probabilities
        except Exception:  # noqa: BLE001 - a failed request is counted, not hidden
            if not record:
                raise
            self.failed += 1
            return
        if record:
            self.latencies.append(time.perf_counter() - t0)
            self.answers.append((start, n, np.asarray(probs, dtype=np.float64)))

    def window(self, seconds: float, traced: bool) -> dict:
        self.latencies, self.answers, self.failed = [], [], 0
        before = common.launches()
        clock = common.Clock(self.device)
        i = 0
        while clock.elapsed() < seconds:
            self._request(int(self.order[i % len(self.order)]), record=True)
            i += 1
            if i % len(self.order) == 0:
                self.order = self.rng.permutation(self.order)
        elapsed = clock.stop()
        done = len(self.latencies)
        return {"seconds": elapsed, "units": done, "attempted": done + self.failed,
                "failed": self.failed, "latencies_s": list(self.latencies),
                "launches": common.launches_per_unit(before, done) if traced else None}

    def release(self) -> None:
        del self.predictor
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        if not self.answers:
            return {"logit_cos_dist": common.NO_ANSWER, "prob_max_err": common.NO_ANSWER,
                    "logit_rel_err": common.NO_ANSWER}
        rng = np.random.default_rng(self.seed + 1)
        longest = max(range(len(self.answers)), key=lambda i: self.answers[i][1])
        rest = [i for i in rng.permutation(len(self.answers)) if i != longest]
        sample = [longest] + rest[:self.traffic["check_requests"] - 1]
        precision.no_tf32()
        c, dev = self.config, self.device
        prob_err = logit_err = logit_cos = 0.0
        logit = lambda p: np.log(p) - np.log1p(-p)
        for i in sample:
            start, n, got = self.answers[i]
            want = self.reference(torch.from_numpy(self.pool[start:start + n]).to(dev))
            prob_err = max(prob_err, float(np.abs(got - want).max()))
            a, b = logit(got), logit(want)
            a, b = a - b.mean(), b - b.mean()
            logit_err = max(logit_err, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
            cos_d, _ = common.cos_and_rel(a[None] - a.mean(), b[None])
            logit_cos = max(logit_cos, cos_d)
        return {"logit_cos_dist": logit_cos, "prob_max_err": prob_err,
                "logit_rel_err": logit_err, "compared": len(sample)}

    def reference(self, frames: torch.Tensor) -> np.ndarray:
        """The plain cascade's 140 probabilities for one clip."""
        c = self.config
        rgb = ref_vit.embed(self.teacher, c["teacher"], frames)
        mot = ref_vit.embed(self.student, c["student"], ref_vit.frame_diff(frames))
        no = lambda t: torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
        with torch.no_grad():
            logits = ref_tfam.row_logits(self.tfam, c["tfam"], rgb[None], mot[None], no(rgb),
                                         no(mot), None, None, 0)
        return torch.sigmoid(logits.double())[0].cpu().numpy()
