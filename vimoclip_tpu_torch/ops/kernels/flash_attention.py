"""Masked multi-head attention forward: the CUDA kernel and its plain
PyTorch version.

The counterpart of ``vimoclip_tpu/ops/pallas/flash_attention.py::
flash_attention`` (wrapper :751, kernel ``_fwd_kernel`` :113) in its
inference variant. The kernel is ``csrc/flash_attention_fwd.cu``; its header
says what bounds it on the H100 and what the design does about that.

- On a CUDA tensor, ``flash_attention`` launches the kernel or raises.
- On a CPU tensor it runs ``flash_attention_reference``, which rounds at the
  same points as the kernel: q * scale in q's dtype, scores and softmax
  statistics in float32, p rounded to v's dtype before the PV product, the
  output acc / l stored in q's dtype.
- ``flash_attention.launches`` counts kernel launches (never CPU calls).

Dropout is training work (K1's dropout variant, with the lse output and the
backward kernels K2-K4, comes with the training slice): ``dropout_rate > 0``
raises ``NotImplementedError`` after the same argument checks as JAX.
"""

from __future__ import annotations

import ctypes

import torch

_MASK_VALUE = -1e9  # ops/attention.py::_MASK_VALUE
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one softmax over all keys.

    On a card, the float32 products run in full float32 only with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if key_padding_mask is not None:
        s = s + torch.where(key_padding_mask[:, None, None, :], _MASK_VALUE, 0.0)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype)


def _check_args(q, k, v, key_padding_mask, dropout_rate, dropout_seed):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1); got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B,H,Tq,D) and k, v (B,H,Tk,D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, tq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B, H or D"
        )
    tk = k.shape[2]
    if tq < 1 or tk < 1:
        raise ValueError(f"empty sequence: Tq={tq}, Tk={tk}")
    if key_padding_mask is not None and tuple(key_padding_mask.shape) != (b, tk):
        raise ValueError(
            f"key_padding_mask must be (B, Tk) = {(b, tk)}; got "
            f"{tuple(key_padding_mask.shape)}"
        )
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused attention dropout is training work: it comes with the "
            "TFAM training slice of the port (Philox bits in the kernel)"
        )


def _bind():
    from vimoclip_tpu_torch.ops.kernels._build import load_library

    lib = load_library("flash_attention_fwd")
    fn = lib.vimo_flash_attention_fwd
    if fn.argtypes is None:
        ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([ptr] * 5 + [i32] * 6 + [ll] * 13
                       + [ctypes.c_float, ptr])
        fn.restype = i32
        lib.vimo_cuda_error_string.argtypes = [i32]
        lib.vimo_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(q, k, v, key_padding_mask) -> torch.Tensor:
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM} is not supported")
    # the kernel reads through (B, H, T) strides; only the head dim must be
    # contiguous
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    mask_arg, m_sb = None, 0
    if key_padding_mask is not None:
        if key_padding_mask.device != q.device:
            raise ValueError("key_padding_mask must be on q's device")
        mask = key_padding_mask.to(torch.bool).contiguous().view(torch.uint8)
        mask_arg, m_sb = mask.data_ptr(), mask.stride(0)
    # (B, Tq, H, D) storage seen as (B, H, Tq, D): merging the heads after
    # the call is a free view
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib, fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_arg, out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, tq, tk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            m_sb, 1.0 / d ** 0.5, stream,
        )
    if rc != 0:
        reason = (lib.vimo_cuda_error_string(rc).decode() if rc > 0
                  else f"unsupported arguments (code {rc})")
        raise RuntimeError(f"flash_attention kernel launch failed: {reason}")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """Masked attention with torch MHA numerics.

    Args:
        q: (B, H, Tq, D) float32 or bfloat16.
        k, v: (B, H, Tk, D), q's dtype.
        key_padding_mask: (B, Tk) bool, True = IGNORE the key (torch
            convention); masked keys get a -1e9 bias, so a fully masked row
            is uniform over the real keys.
        dropout_rate, dropout_seed: checked as in JAX; a rate above 0 raises
            NotImplementedError (training slice).
    Returns:
        (B, H, Tq, D) in q's dtype.
    """
    _check_args(q, k, v, key_padding_mask, dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, key_padding_mask)


flash_attention.launches = 0
