"""Serving with SigLIP towers: ``serve.py``'s closed loop of one client
through ``serving.py::ViMoCLIPPredictor.predict_videos([clip])``, with the
towers' weights and the check's plain cascade taken from
``reference/siglip.py`` (teacher on the frames, student on their grey
differences, TFAM with each clip's own masked mean, sigmoid).

The window also counts what it served, for ``mfu.serve`` and
``tower_attn_roofline.serve``: the frames each tower embedded, read from
the predictor's ``stats()`` and held to the frames the driver sent (n and
n - 1 a request; a mismatch fails the run), times a frame's model FLOPs
(``flops_siglip.py``), plus TFAM's forward at each request's lengths; and
the FLOPs and bytes of the towers' attention calls."""

from __future__ import annotations

import dataclasses

import torch

from perfbench import faults, flops, flops_siglip, weights
from perfbench import generator as mix
from perfbench.drivers import _common as common
from perfbench.drivers import serve
from perfbench.reference import siglip as ref_siglip
from perfbench.reference import tfam as ref_tfam
from perfbench.reference.vit import frame_diff

TOWERS = (("teacher", "teacher_frames", 0), ("student", "student_frames", 1))
# the faults serve.py's driver can have: this one drives the same predictor
# (``faults.py`` plants a driver's faults by its name)
faults.FAULTS.setdefault("serve_siglip", faults.FAULTS["serve"])


class Driver(serve.Driver):
    def setup(self) -> None:
        # first: a program without the SigLIP tower fails here, before any work
        from vimoclip_tpu_torch.models.siglip_vit import SiglipVisionConfig
        from vimoclip_tpu_torch.serving import ViMoCLIPPredictor

        c, s = self.config, self.config["serving"]
        dev = self.device
        fields = {f.name for f in dataclasses.fields(SiglipVisionConfig)}

        def tower_config(spec: dict):
            cfg = SiglipVisionConfig(**{k: v for k, v in spec.items() if k in fields})
            return dataclasses.replace(cfg, matmul_quant="int8") if self.control else cfg

        self.teacher = weights.make_params(ref_siglip.param_shapes(c["teacher"]),
                                           weights.generator(self.seed, 1, dev))
        self.student = weights.make_params(ref_siglip.param_shapes(c["student"]),
                                           weights.generator(self.seed, 2, dev))
        self.tfam = weights.make_params(ref_tfam.param_shapes(c["tfam"], c["num_classes"]),
                                        weights.generator(self.seed, 3, dev))
        self.pool = common.frame_pool(self.traffic, self.seed)
        self.predictor = ViMoCLIPPredictor(
            self.teacher, tower_config(c["teacher"]), self.student, tower_config(c["student"]),
            self.tfam, common.tfam_config(c["tfam"]), num_classes=c["num_classes"],
            frame_batch=s["frame_batch"], length_bucket=s["length_bucket"],
            max_seq_len=s["max_seq_len"], half_precision=s["dtype"] == "bfloat16",
            device=dev)
        self.sent: list[int] = []
        self.order = mix.lengths(self.traffic["lengths"], self.rng)
        for n in mix.warm_lengths(self.traffic["lengths"], s["length_bucket"],
                                  s["max_seq_len"]):
            self._request(n, record=False)

    def _request(self, n: int, record: bool) -> None:
        if record:
            self.sent.append(n)
        super()._request(n, record)

    def window(self, seconds: float, traced: bool) -> dict:
        self.sent = []
        before = self.predictor.stats()
        stats = super().window(seconds, traced)
        after = self.predictor.stats()
        c = self.config
        itemsize = 2 if c["serving"]["dtype"] == "bfloat16" else 4
        model = sum(flops.tfam_forward_flops(n, n - 1, c["tfam"], c["num_classes"])
                    for n in self.sent)
        attn_flops = attn_bytes = 0.0
        for tower, counter, less in TOWERS:
            embedded = after[counter] - before[counter]
            sent = sum(n - less for n in self.sent)
            if embedded != sent:
                raise RuntimeError(f"the predictor's {counter} moved by {embedded} in the "
                                   f"window; the driver sent {sent}")
            model += embedded * flops_siglip.tower_flops_per_frame(c[tower])
            f, b = flops_siglip.tower_attention(c[tower], embedded, itemsize)
            attn_flops, attn_bytes = attn_flops + f, attn_bytes + b
        stats.update(flops=model, tower_attn_flops=attn_flops, tower_attn_bytes=attn_bytes)
        return stats

    def reference(self, frames: torch.Tensor):
        """The plain cascade's probabilities for one clip."""
        c = self.config
        rgb = ref_siglip.embed(self.teacher, c["teacher"], frames)
        mot = ref_siglip.embed(self.student, c["student"], frame_diff(frames))
        no = lambda t: torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
        with torch.no_grad():
            logits = ref_tfam.row_logits(self.tfam, c["tfam"], rgb[None], mot[None], no(rgb),
                                         no(mot), None, None, 0)
        return torch.sigmoid(logits.double())[0].cpu().numpy()
