"""Plain TFAM (the reference AMO_CLIP fusion model: post-norm layers of
self-attention, cross-attention to the motion stream and a ReLU FFN, mean
pooling, LN -> Linear -> GELU -> Linear head) with its training step:
dropout as the port documents its draws, BCE or CE, AdamW with the
reference's betas (0.9, 0.999), eps 1e-8 and decoupled weight decay.

Dropout draws, in the order the program makes them from one
``torch.Generator`` per step: per layer, the self-attention's (B, H) int32
seeds, the 8-bit mask of its output (B, T, d), the cross-attention's seeds,
the mask of its output, the FFN's masks after the activation (B, T, ff) and
after the second linear (B, T, d), that mask's stream once more on the
residual branch (the reference model drops the FFN branch twice); then the
head's uniform draw (B, d / 2). An 8-bit mask keeps where the byte is below
round((1 - p) 256) and divides by that over 256; attention weights are kept
by ``seeding.philox_keep`` and divided by 1 - p.

Training pools as the reference does: an unmasked mean over the batch's
longest clip. Serving pools over each clip's own frames. Sequences are
padded to the bucket the loader pads to, so the draws have the program's
shapes; padded keys are masked out."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.precision import linear, matmul
from perfbench.reference.seeding import philox_keep, stream

BETAS, EPS = (0.9, 0.999), 1e-8
_LN_EPS = 1e-5


def param_shapes(cfg: dict, classes: int) -> list[tuple[str, tuple, str]]:
    d, ff = cfg["d_model"], cfg["dim_feedforward"]
    ln = lambda k: [(f"{k}.weight", (d,), "one"), (f"{k}.bias", (d,), "zero")]
    lin = lambda k, o, i: [(f"{k}.weight", (o, i), "normal"), (f"{k}.bias", (o,), "zero")]
    out = []
    for i in range(cfg["num_layers"]):
        n = f"layers.{i}"
        for a in ("self_attn", "cross_attn"):
            out += [(f"{n}.{a}.in_proj_weight", (3 * d, d), "normal"),
                    (f"{n}.{a}.in_proj_bias", (3 * d,), "zero"),
                    *lin(f"{n}.{a}.out_proj", d, d)]
        out += [*ln(f"{n}.norm_self"), *ln(f"{n}.norm_cross"),
                *lin(f"{n}.ffn.0", ff, d), *lin(f"{n}.ffn.3", d, ff), *ln(f"{n}.norm_ffn")]
    return out + [*lin("projection_layer", d, 2 * d),
                  (f"classifier.0.weight", (d,), "one"), (f"classifier.0.bias", (d,), "zero"),
                  *lin("classifier.1", d // 2, d), *lin("classifier.4", classes, d // 2)]


def bucket_length(n: int, bucket: int | None, cap: int | None) -> int:
    if bucket:
        n = -(-n // bucket) * bucket
    return n if cap is None else min(n, cap)


def draw_all(gen: torch.Generator, cfg: dict, b: int, t: int) -> dict:
    """Every dropout draw of one training step on a (b, t)-row rgb batch."""
    d, ff, h = cfg["d_model"], cfg["dim_feedforward"], cfg["nhead"]
    dev = gen.device
    seeds = lambda: torch.randint(0, 2**31 - 1, (b, h), generator=gen, device=dev,
                                  dtype=torch.int32)
    byte = lambda *s: torch.randint(0, 256, s, dtype=torch.uint8, generator=gen, device=dev)
    layers = []
    for _ in range(cfg["num_layers"]):
        layers.append({"self_seed": seeds(), "self_drop": byte(b, t, d),
                       "cross_seed": seeds(), "cross_drop": byte(b, t, d),
                       "ffn_act": byte(b, t, ff), "ffn_out": byte(b, t, d),
                       "ffn_res": byte(b, t, d)})
    head = torch.rand((b, d // 2), generator=gen, device=dev)
    return {"layers": layers, "head": head, "keep": {}}


def _thin(x, bits, rate):
    thr = int(round((1.0 - rate) * 256.0))
    return torch.where(bits < thr, x / (thr / 256.0), torch.zeros_like(x))


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], _LN_EPS)


def _mha(p, name, x, kv, ignore, heads, rate, keep, mode):
    """One row: x (1, Tq, d), kv (1, Tk, d), ignore (Tk,) bool; ``keep``
    a function of the weights' shape giving the kept weights."""
    d = x.shape[-1]
    w, bias = p[f"{name}.in_proj_weight"], p[f"{name}.in_proj_bias"]
    q = linear(x, w[:d], bias[:d], mode)
    k, v = linear(kv, w[d:], bias[d:], mode).split(d, dim=-1)
    split = lambda z: z.view(z.shape[1], heads, -1).transpose(0, 1)
    q, k, v = split(q), split(k), split(v)
    s = matmul(q / math.sqrt(d // heads), k.transpose(-1, -2), mode)
    s = s + torch.where(ignore, -1e9, 0.0)[None, None, :]
    a = torch.softmax(s, dim=-1)
    if rate > 0.0:
        a = torch.where(keep(a.shape[1], a.shape[2]), a / (1.0 - rate), 0.0)
    o = matmul(a, v, mode).transpose(0, 1).reshape(1, -1, d)
    return linear(o, p[f"{name}.out_proj.weight"], p[f"{name}.out_proj.bias"], mode)


def _keep(draws, row, layer, site, tq, tk, rate):
    """The attention keep mask of one row and site, made once a step."""
    key = (row, layer, site)
    if key not in draws["keep"]:
        seed = draws["layers"][layer][f"{site}_seed"][row]
        draws["keep"][key] = philox_keep(seed, tq, tk, rate)
    return draws["keep"][key]


def row_logits(p: dict, cfg: dict, rgb, mot, ignore_r, ignore_m, pool_limit,
               draws: dict | None, row: int, mode: str = "fp32") -> torch.Tensor:
    """Logits (1, C) of batch row ``row``: rgb (1, Tr, d), mot (1, Tm, d);
    ``draws`` from ``draw_all`` (training) or None (inference);
    ``pool_limit``: pool over the first ``pool_limit`` positions, or
    None for the clip's own frames (serving's masked mean)."""
    rate = cfg["dropout"] if draws else 0.0
    heads = cfg["nhead"]
    x = rgb
    for i in range(cfg["num_layers"]):
        n, dr = f"layers.{i}", (draws["layers"][i] if draws else None)
        pick = lambda k: None if dr is None else dr[k][row]
        drop = (lambda z, k: _thin(z, pick(k), rate)) if draws else (lambda z, k: z)
        keep = lambda site: (lambda tq, tk: _keep(draws, row, i, site, tq, tk, rate))
        a = _mha(p, f"{n}.self_attn", x, x, ignore_r, heads, rate, keep("self"), mode)
        x = _ln(x + drop(a, "self_drop"), p, f"{n}.norm_self")
        a = _mha(p, f"{n}.cross_attn", x, mot, ignore_m, heads, rate, keep("cross"), mode)
        x = _ln(x + drop(a, "cross_drop"), p, f"{n}.norm_cross")
        h = torch.relu(linear(x, p[f"{n}.ffn.0.weight"], p[f"{n}.ffn.0.bias"], mode))
        h = drop(h, "ffn_act")
        h = drop(linear(h, p[f"{n}.ffn.3.weight"], p[f"{n}.ffn.3.bias"], mode), "ffn_out")
        x = _ln(x + drop(h, "ffn_res"), p, f"{n}.norm_ffn")
    if pool_limit is None:
        keep = (~ignore_r).float()[None, :, None]
        pooled = (x * keep).sum(dim=1) / keep.sum().clamp_min(1.0)
    else:
        pooled = x[:, :pool_limit].sum(dim=1) / max(pool_limit, 1)
    h = _ln(pooled, p, "classifier.0")
    h = F.gelu(linear(h, p["classifier.1.weight"], p["classifier.1.bias"], mode),
               approximate="none")
    if draws and cfg["mlp_dropout"] > 0.0:
        r = cfg["mlp_dropout"]
        h = torch.where(draws["head"][row] < 1.0 - r, h / (1.0 - r), torch.zeros_like(h))
    return linear(h, p["classifier.4.weight"], p["classifier.4.bias"], mode)


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "ce":
        return F.cross_entropy(logits, labels.argmax(dim=-1))
    return F.binary_cross_entropy_with_logits(logits, labels)


def _rows(batch, b, dev):
    rgb, mot, mr, mm, _ = batch
    return (rgb[b:b + 1].to(dev), mot[b:b + 1].to(dev), (~mr[b]).to(dev), (~mm[b]).to(dev))


def train_step(params: dict, state: dict, batch, cfg: dict, loss_kind: str, lr: float,
               weight_decay: float, gen: torch.Generator, mode: str = "fp32"):
    """One step, row by row: forward for the loss's gradient at the
    logits, then each row's forward and backward again with it. Returns
    (loss, grads by name); ``params`` and ``state`` are updated in place."""
    rgb, mot, mr, mm, labels = batch
    dev = gen.device
    b, t = rgb.shape[:2]
    draws = draw_all(gen, cfg, b, t)
    limit = min(int(mr.sum(dim=1).max()), t)
    with torch.no_grad():
        logits = torch.cat([row_logits(params, cfg, *_rows(batch, i, dev), limit, draws, i, mode)
                            for i in range(b)])
    logits.requires_grad_(True)
    loss = loss_fn(logits, labels.to(dev), loss_kind)
    (dlogits,) = torch.autograd.grad(loss, logits)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    for i in range(b):
        out = row_logits(leaves, cfg, *_rows(batch, i, dev), limit, draws, i, mode)
        out.backward(dlogits[i:i + 1])
    grads = {k: v.grad for k, v in leaves.items() if v.grad is not None}
    adamw_(params, grads, state, lr, weight_decay)
    return float(loss.detach()), grads


@torch.no_grad()
def adamw_(params: dict, grads: dict, state: dict, lr: float, weight_decay: float) -> None:
    """torch.optim.AdamW's update on the leaves that have a gradient."""
    state["t"] = t = state.get("t", 0) + 1
    b1, b2 = BETAS
    for k, g in grads.items():
        m = state.setdefault(("m", k), torch.zeros_like(g))
        v = state.setdefault(("v", k), torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p = params[k]
        p.mul_(1 - lr * weight_decay)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(EPS)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def cosine_lr(base: float, eta_min: float, epochs: int, epoch: int) -> float:
    """The rate of ``epoch``: torch's ``CosineAnnealingLR(T_max=epochs,
    eta_min)`` stepped once per epoch, as the reference trainer steps it, in
    closed form."""
    return eta_min + (base - eta_min) * (1.0 + math.cos(math.pi * epoch / epochs)) / 2.0


def dropout_stream(seed: int, step: int, device) -> torch.Generator:
    return stream(seed, "dropout", step, device)
