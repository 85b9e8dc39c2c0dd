"""Masked multi-head attention, forward and backward: the CUDA kernels and
their plain PyTorch versions.

The counterpart of ``vimoclip_tpu/ops/pallas/flash_attention.py::
flash_attention`` (wrapper :751) and its kernels:

- K1  ``_fwd_kernel`` :113, inference variant (no lse, no dropout), and K1'
  the same kernel with the lse output and fused dropout (``need_lse``):
  ``csrc/flash_attention_fwd.cu``;
- K2 ``_dqkv_single_kernel`` :282 (keys fit one 512-key tile), K3
  ``_dq_kernel`` :214 and K4 ``_dkv_kernel`` :244 (longer keys):
  ``csrc/flash_attention_bwd.cu``.

Every head dim runs on the kernels, as on the TPU. Above
``WIDE_ABOVE_HEAD_DIM`` (128) each kernel has a wide variant, its launches
counted under the kind's ``_wide`` name: in bf16 every kernel (K1/K1',
K2, K3 and K4) takes a pair of 128-column output slices per CTA, the scores
once for the pair; in float32 K1/K1', K2 and K4 take one slice per CTA and
K3 a pair, the score products streamed over the whole head dim.

In bf16 every kernel runs on the tensor cores (wgmma) from tiles that TMA
copies into shared memory; with dropout K3 also writes the keep bits of each
64x64 tile to a uint32 buffer that K4 reads instead of drawing them again
(K1' and K2 draw their own; above head dim 128 a small kernel fills the
same buffer for K2 first). In float32 K1, K1', K2 and K4 run on the
tensor cores too, each product as three TF32 passes (hi.hi + hi.lo + lo.hi
of operands split in two, ``csrc/tf32.cuh``), from tiles TMA copies, and so
does K3, which keeps no keep-bit buffer in float32. TMA needs a 16-byte
aligned start and strides of 16-byte multiples: ``_launch_fwd`` and
``backward_kernels`` hand the kernels a padded copy of any operand that
lacks them (``tma_legal``, ``tma_operand``).

The sources' headers say what bounds each kernel on the H100 and what the
design does about it.

- On a CUDA tensor, ``flash_attention`` launches the kernels or raises; on a
  CPU tensor it runs the plain versions (``flash_attention_reference``,
  ``flash_attention_backward_reference``), which round at the kernels'
  points. Nothing falls back from one to the other.
- Like JAX's custom-VJP primal and forward (:704-721): when grad is enabled
  and an input requires grad, the call goes through a
  ``torch.autograd.Function`` whose forward is K1' and whose backward is K2
  (Tk <= 512, JAX's ``nk == 1``) or K3 + K4; otherwise K1 runs, with its
  fused dropout when the rate is above 0 (JAX's lse-free primal).
- Dropout bits are Philox4x32-10 keyed on global (row, key / 4)
  coordinates and one seed per (batch row, head)
  (``csrc/flash_attention_common.cuh``). ``row0`` and ``col0`` (a multiple
  of 4) say where the call's element (0, 0) sits in a longer sequence: a
  call on one (query block, key block) of it, as each step of the ring
  (``parallel/sequence.py``), draws the bits the whole call draws there;
  both are 0 for a whole sequence. ``philox4x32`` here is the same
  generator in int64 arithmetic, so kernel and plain version drop the same
  elements. The bits cannot equal the TPU's. The plain versions also take
  an explicit ``keep`` mask (the tests pass all-True, which is what JAX's
  CPU interpreter's stubbed bits give).
- ``flash_attention.launches`` counts kernel launches by kind (``fwd``,
  ``fwd_lse``, ``bwd_dqkv``, ``bwd_dq``, ``bwd_dkv``, and each of them with
  ``_wide`` above head dim 128; ``fwd_pp`` for bf16 K1 without dropout at
  head dims 65-128, ``launch_kind``), never CPU calls.
- Spans (``utils/profiling.py::annotate``): ``vimo.attn.fwd`` around each
  call, either path; ``vimo.attn.bwd`` around the autograd backward, on the
  engine's thread when the tensors are on the card.

A fully masked row (every key ignored) comes out uniform over the real
keys, and its lse is -1e9 + log(n) rounded in float32, i.e. -1e9: the
backward then recomputes P = 1 for each of its keys, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes

import torch

from vimoclip_tpu_torch.utils.profiling import annotate

_MASK_VALUE = -1e9  # ops/attention.py::_MASK_VALUE
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims above this run on the wide kernels (output slices of 128 columns)
WIDE_ABOVE_HEAD_DIM = 128
# JAX's backward takes its single-pass kernel when the keys fit one
# block_k = 512 tile (nk == 1); the port keeps the same rule
SINGLE_PASS_MAX_TK = 512
# bf16 K1 (no lse, no dropout) above this head dim, up to WIDE_ABOVE_HEAD_DIM,
# runs on its own kernel, counted as ``fwd_pp``
PP_ABOVE_HEAD_DIM = 64
_KINDS = ("fwd", "fwd_lse", "bwd_dqkv", "bwd_dq", "bwd_dkv")
LAUNCH_KINDS = _KINDS + tuple(f"{k}_wide" for k in _KINDS) + ("fwd_pp",)
_BWD_WHICH = {"bwd_dqkv": 0, "bwd_dq": 1, "bwd_dkv": 2}
_BWD_TILE = 64  # key tile of the backward kernels (dq scratch of K2)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ---------------------------------------------------------------------------
# dropout bits
# ---------------------------------------------------------------------------


def keep_threshold(dropout_rate: float) -> int:
    """uint32 threshold with keep = (bits < threshold): keep probability
    round((1 - p) * 2^32) / 2^32, clamped into uint32 range (JAX's
    ``_keep_threshold``)."""
    return min(2**32 - 1, int(round((1.0 - dropout_rate) * 2.0**32)))


def expand_seed(dropout_seed, b: int, h: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """A scalar, (B,) or (B, H) seed -> the kernels' (B, H) int32 seeds
    (JAX's ``_expand_seed``): a (B, H) seed passes through; otherwise the
    seed is multiplied by the golden-ratio constant 0x9E3779B9 and a slot
    index added, with int32 wraparound, so consecutive scalar seeds never
    share streams."""
    seed = torch.as_tensor(dropout_seed).to(device=device, dtype=torch.int64)
    if tuple(seed.shape) == (b, h):
        return seed.to(torch.int32)
    gold = -1640531527  # 0x9E3779B9 as int32
    if seed.numel() == 1:
        slots = torch.arange(b * h, device=device, dtype=torch.int64).view(b, h)
        full = seed.reshape(()) * gold + slots
    elif tuple(seed.shape) == (b,):
        full = seed[:, None] * gold + torch.arange(h, device=device, dtype=torch.int64)
    else:
        raise ValueError(
            f"dropout_seed must be scalar, (B,), or (B, H); got "
            f"{tuple(seed.shape)} for B={b}, H={h}"
        )
    return ((full + 2**31) % 2**32 - 2**31).to(torch.int32)


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x for x in [0, 2^32), in int64 without
    overflow (x split into 16-bit halves)."""
    lo_part = m * (x & 0xFFFF)
    hi_part = m * (x >> 16)
    s = lo_part + ((hi_part & 0xFFFF) << 16)
    return ((s >> 32) + (hi_part >> 16)) & _MASK32, s & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors (or ints) holding uint32 values;
    returns the four output words as int64 tensors."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    k0, k1 = torch.as_tensor(k0, dtype=torch.int64), torch.as_tensor(k1, dtype=torch.int64)
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def check_offsets(row0: int, col0: int) -> None:
    if row0 < 0 or col0 < 0 or col0 % 4:
        raise ValueError(f"dropout offsets must be >= 0 with col0 a multiple of 4 "
                         f"(one Philox call covers 4 keys); got row0={row0}, col0={col0}")


def dropout_keep_mask(seed: torch.Tensor, tq: int, tk: int, dropout_rate: float,
                      row0: int = 0, col0: int = 0) -> torch.Tensor:
    """The kernels' keep mask, (B, H, Tq, Tk) bool: for (b, h, row, col),
    word (col0 + col) % 4 of Philox4x32-10 with counter (row0 + row,
    (col0 + col) // 4, 0, 0) and key (seed[b, h] as uint32, 0), kept where
    it is below the threshold."""
    check_offsets(row0, col0)
    groups = (tk + 3) // 4
    dev = seed.device
    rows = torch.arange(row0, row0 + tq, device=dev, dtype=torch.int64).view(1, 1, tq, 1)
    cols = torch.arange(col0 // 4, col0 // 4 + groups, device=dev,
                        dtype=torch.int64).view(1, 1, 1, groups)
    key = (seed.to(torch.int64) & _MASK32)[:, :, None, None]
    words = philox4x32(rows, cols, 0, 0, key, 0)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(*bits.shape[:3], groups * 4)[..., :tk]
    return bits < keep_threshold(dropout_rate)


def _keep_for(q, k, dropout_rate, seed, keep, row0=0, col0=0):
    if dropout_rate == 0.0:
        return None
    if keep is not None:
        return keep
    if seed is None:
        raise ValueError("dropout needs the (B, H) seeds or an explicit keep mask")
    return dropout_keep_mask(seed, q.shape[2], k.shape[2], dropout_rate, row0, col0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, key_padding_mask):
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = (q.float() * scale).to(q.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if key_padding_mask is not None:
        s = s + torch.where(key_padding_mask[:, None, None, :], _MASK_VALUE, 0.0)
    return s


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    keep: torch.Tensor | None = None,
    return_lse: bool = False,
    row0: int = 0,
    col0: int = 0,
):
    """Plain PyTorch version of K1 / K1', one softmax over all keys.

    ``seed``: the (B, H) int32 seeds (``expand_seed``); ``keep``: an
    explicit (B, H, Tq, Tk) keep mask in their place; ``row0``/``col0``:
    the global coordinates of element (0, 0) for the bits. Returns the
    output in q's dtype, and with ``return_lse`` also lse (B, H, Tq)
    float32.

    On a card, the float32 products run in full float32 only with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default)."""
    s = _scores(q, k, key_padding_mask)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep_for(q, k, dropout_rate, seed, keep, row0, col0)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / (l * (1.0 - dropout_rate))
    o = o.to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    dropout_rate: float = 0.0,
    seed: torch.Tensor | None = None,
    keep: torch.Tensor | None = None,
    row0: int = 0,
    col0: int = 0,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 / K3 + K4: the TPU kernels' formulas
    (flash_attention.py:38-45) from the saved lse, with their rounding
    points (p and dS rounded to the input dtype at each product, float32
    accumulation). ``delta`` = rowsum(dO * O) float32, taken from ``out``
    when not given (a ring block passes the whole row's, with ``out``
    None). Returns (dq, dk, dv) in the inputs' dtypes."""
    scale = 1.0 / q.shape[-1] ** 0.5
    if delta is None:
        delta = (grad_out.float() * out.float()).sum(dim=-1)
    p = torch.exp(_scores(q, k, key_padding_mask) - lse[..., None])
    dp = torch.matmul(grad_out.float(), v.float().transpose(-1, -2))
    keep = _keep_for(q, k, dropout_rate, seed, keep, row0, col0)
    pd = p
    if keep is not None:
        dp = torch.where(keep, dp, 0.0) / (1.0 - dropout_rate)
        pd = torch.where(keep, p, 0.0) / (1.0 - dropout_rate)
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pd.to(grad_out.dtype).float().transpose(-1, -2),
                      grad_out.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


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


def _bind(name: str, entry: str, argtypes: list):
    from vimoclip_tpu_torch.ops.kernels._build import load_library

    lib = load_library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.vimo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vimo_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _U32 = ctypes.c_float, ctypes.c_uint32
_FWD_ARGS = [_P] * 7 + [_I] * 8 + [_LL] * 13 + [_F, _U32, _F, _P]
_BWD_ARGS = [_P] * 13 + [_I] * 9 + [_LL] * 22 + [_F, _U32, _F, _P]
_TMA_ALIGN = 16  # bytes: TMA's start address and stride granule


def launch_kind(kind: str, head_dim: int, dtype: torch.dtype | None = None,
                dropout: bool = False) -> str:
    """The launch counter of ``kind`` at ``head_dim``: its wide variant above
    ``WIDE_ABOVE_HEAD_DIM``; ``fwd_pp`` for K1 (``fwd``) in bf16 without
    dropout above ``PP_ABOVE_HEAD_DIM``, the rule the forward entry routes
    by; else the kind itself."""
    if head_dim > WIDE_ABOVE_HEAD_DIM:
        return f"{kind}_wide"
    if (kind == "fwd" and dtype == torch.bfloat16 and not dropout
            and head_dim > PP_ABOVE_HEAD_DIM):
        return "fwd_pp"
    return kind


def _check_kernel_inputs(q, k, v):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernels take float32 or bfloat16 q, k, v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _rows(t: torch.Tensor) -> torch.Tensor:
    # the kernels read through (B, H, T) strides; only the head dim must be
    # contiguous
    return t if t.stride(-1) == 1 else t.contiguous()


def _mask_arg(key_padding_mask, device):
    if key_padding_mask is None:
        return None, None, 0
    if key_padding_mask.device != device:
        raise ValueError("key_padding_mask must be on q's device")
    mask = key_padding_mask.to(torch.bool).contiguous().view(torch.uint8)
    return mask, mask.data_ptr(), mask.stride(0)


def _heads_major(b, t, h, d, dtype, device) -> torch.Tensor:
    # (B, T, H, D) storage seen as (B, H, T, D): merging the heads after the
    # call is a free view
    return torch.empty((b, t, h, d), dtype=dtype, device=device).transpose(1, 2)


# the entry points' own return codes (the csrc headers list them)
_RC_REASONS = {
    -1: "unknown dtype", -3: "unknown backward kernel",
    -4: "the driver refused a tensor map", -5: "an operand TMA cannot address",
    -6: "dropout without the keep-bit buffer", -7: "K2 without its dq scratch",
    -8: "a negative offset or a col0 that is no multiple of 4",
}


def _raise_on(lib, rc, what):
    if rc != 0:
        reason = (lib.vimo_cuda_error_string(rc).decode() if rc > 0
                  else f"{_RC_REASONS.get(rc, 'unsupported arguments')} (code {rc})")
        raise RuntimeError(f"{what} kernel launch failed: {reason}")


def _launch_fwd(q, k, v, key_padding_mask, seed, dropout_rate, with_lse, row0=0, col0=0):
    """K1 (``with_lse`` False) or K1': the output, and lse (B, H, Tq)
    float32 or None; dropout from the (B, H) ``seed`` at the global
    coordinates from (``row0``, ``col0``) when the rate is above 0."""
    _check_kernel_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v = _rows(q), _rows(k), _rows(v)
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)  # the kernels read them with TMA
    mask, mask_ptr, m_sb = _mask_arg(key_padding_mask, q.device)
    kind = launch_kind("fwd_lse" if with_lse else "fwd", d, q.dtype, dropout_rate > 0.0)
    out = fwd_output(b, tq, h, d, q.dtype, q.device, kind)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    seed_ptr = None
    if dropout_rate > 0.0:
        seed = seed.to(device=q.device, dtype=torch.int32).contiguous()
        seed_ptr = seed.data_ptr()
    lib, fn = _bind("flash_attention_fwd", "vimo_flash_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            None if lse is None else lse.data_ptr(), seed_ptr,
            _DTYPE_CODES[q.dtype], b, h, tq, tk, d, row0, col0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            m_sb, 1.0 / d ** 0.5, keep_threshold(dropout_rate), 1.0 - dropout_rate,
            stream,
        )
    _raise_on(lib, rc, "flash_attention forward")
    flash_attention.launches[kind] += 1
    return out, lse


def fwd_output(b, tq, h, d, dtype, device, kind: str) -> torch.Tensor:
    """K1's output, (B, H, Tq, D) over heads-major storage. ``fwd_pp``'s
    kernel stores it with TMA, so there its rows are padded to 16 bytes (the
    view shows D columns)."""
    if kind != "fwd_pp":
        return _heads_major(b, tq, h, d, dtype, device)
    per = _TMA_ALIGN // dtype.itemsize
    return _heads_major(b, tq, h, -(-d // per) * per, dtype, device)[..., :d]


def tma_legal(t: torch.Tensor) -> bool:
    """Whether TMA can read the (B, H, T, D) operand ``t`` in place: a
    16-byte aligned start, a contiguous head dim, and (B, H, T) strides that
    are positive multiples of 16 bytes."""
    item = t.element_size()
    return (t.data_ptr() % _TMA_ALIGN == 0 and t.stride(-1) == 1
            and all(s > 0 and s * item % _TMA_ALIGN == 0 for s in t.stride()[:3]))


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when ``tma_legal``; otherwise the same values in a fresh
    (B, H, T, D) view whose rows are zero-padded to a multiple of 16 bytes
    (the view shows D columns; the kernels' boxes read zeros past D)."""
    if tma_legal(t):
        return t
    b, h, n, d = t.shape
    per = _TMA_ALIGN // t.element_size()
    padded = torch.zeros((b, h, n, -(-d // per) * per), dtype=t.dtype, device=t.device)
    out = padded[..., :d]
    out.copy_(t)
    return out


def _launch_bwd(kind, q, k, v, key_padding_mask, seed, dropout_rate, lse, delta,
                grad_out, dq, dk, dv, keep_bits=None, row0=0, col0=0):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    mask, mask_ptr, m_sb = _mask_arg(key_padding_mask, q.device)
    seed_ptr = None
    if dropout_rate > 0.0:
        seed = seed.to(device=q.device, dtype=torch.int32).contiguous()
        seed_ptr = seed.data_ptr()
    scratch = None
    if kind == "bwd_dqkv":  # K2's dq shares, one per 64-key tile
        n_kt = -(-tk // _BWD_TILE)
        scratch = torch.empty((b, h, n_kt, tq, d), dtype=torch.float32, device=q.device)
        if (keep_bits is None and seed_ptr is not None and q.dtype == torch.bfloat16
                and d > WIDE_ABOVE_HEAD_DIM):
            # the wide bf16 K2 reads its keep bits as K4 does, from the buffer a
            # small kernel fills first (K3's layout)
            keep_bits = torch.empty((b, h, n_kt, -(-tq // 64) * 64, 2), dtype=torch.int32,
                                    device=q.device)
    null3 = (0, 0, 0)
    lib, fn = _bind("flash_attention_bwd", "vimo_flash_attention_bwd", _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), mask_ptr,
            lse.data_ptr(), delta.data_ptr(), seed_ptr,
            None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(),
            None if dv is None else dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if keep_bits is None else keep_bits.data_ptr(),
            _BWD_WHICH[kind], _DTYPE_CODES[q.dtype], b, h, tq, tk, d, row0, col0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *grad_out.stride()[:3],
            *(null3 if dq is None else dq.stride()[:3]),
            *(null3 if dk is None else dk.stride()[:3]),
            *(null3 if dv is None else dv.stride()[:3]),
            m_sb, 1.0 / d ** 0.5, keep_threshold(dropout_rate), 1.0 - dropout_rate,
            stream,
        )
    _raise_on(lib, rc, f"flash_attention backward ({kind})")
    flash_attention.launches[launch_kind(kind, d)] += 1


def backward_kernels(q, k, v, key_padding_mask, seed, dropout_rate, out, lse,
                     grad_out, row0=0, col0=0, delta=None):
    """The backward kernels on CUDA tensors: K2 when the keys fit one
    512-key tile, else K3 + K4 (with dropout in bf16 through the keep-bit
    buffer K3 fills for K4); the operands are first made readable by TMA.
    ``seed``: the (B, H) int32 seeds; ``row0``/``col0``: the global
    coordinates of element (0, 0) for the bits; ``delta``: rowsum(dO * O)
    in float32, from ``out`` when not given. Returns (dq, dk, dv)."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels run on CUDA tensors, not {q.device}")
    _check_kernel_inputs(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v, grad_out = _rows(q), _rows(k), _rows(v), _rows(grad_out)
    # D = rowsum(dO * O), outside the kernels as on the TPU (:730)
    if delta is None:
        delta = (grad_out.float() * out.float()).sum(dim=-1)
    delta = delta.contiguous()
    lse = lse.contiguous()
    dq = _heads_major(b, tq, h, d, q.dtype, q.device)
    dk = _heads_major(b, tk, h, d, k.dtype, q.device)
    dv = _heads_major(b, tk, h, d, v.dtype, q.device)
    q, k, v, grad_out = (tma_operand(t) for t in (q, k, v, grad_out))
    args = (q, k, v, key_padding_mask, seed, dropout_rate, lse, delta, grad_out)
    at = {"row0": row0, "col0": col0}
    if tk <= SINGLE_PASS_MAX_TK:
        _launch_bwd("bwd_dqkv", *args, dq, dk, dv, **at)
        return dq, dk, dv
    keep_bits = None
    if q.dtype == torch.bfloat16 and dropout_rate > 0.0:
        # K3 writes each 64x64 tile's bits as 512 contiguous bytes, which K4
        # copies with one bulk transfer
        keep_bits = torch.empty((b, h, -(-tk // 64), -(-tq // 64) * 64, 2),
                                dtype=torch.int32, device=q.device)
    _launch_bwd("bwd_dq", *args, dq, None, None, keep_bits, **at)
    _launch_bwd("bwd_dkv", *args, None, dk, dv, keep_bits, **at)
    return dq, dk, dv


def forward_lse(q, k, v, key_padding_mask, seed, dropout_rate, row0=0, col0=0):
    """K1' (its plain version on the CPU): (out, lse) with dropout from the
    (B, H) int32 ``seed`` at the global coordinates from (``row0``,
    ``col0``) when ``dropout_rate`` > 0."""
    check_offsets(row0, col0)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, dropout_rate,
                                         seed=seed, return_lse=True, row0=row0, col0=col0)
    return _launch_fwd(q, k, v, key_padding_mask, seed, dropout_rate, with_lse=True,
                       row0=row0, col0=col0)


def backward(q, k, v, key_padding_mask, seed, dropout_rate, out, lse, grad_out,
             row0=0, col0=0, delta=None):
    """K2 or K3 + K4 on CUDA tensors, their plain version on CPU tensors:
    (dq, dk, dv) from the saved lse (and ``delta``, or ``out``)."""
    check_offsets(row0, col0)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, key_padding_mask, out, lse, grad_out, dropout_rate, seed=seed,
            row0=row0, col0=col0, delta=delta)
    return backward_kernels(q, k, v, key_padding_mask, seed, dropout_rate, out, lse,
                            grad_out, row0=row0, col0=col0, delta=delta)


class _FlashAttention(torch.autograd.Function):
    """K1' forward, K2 / K3 + K4 backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, seed, dropout_rate, row0, col0):
        out, lse = forward_lse(q, k, v, key_padding_mask, seed, dropout_rate, row0, col0)
        ctx.save_for_backward(q, k, v, key_padding_mask, seed, out, lse)
        ctx.dropout_rate, ctx.offsets = dropout_rate, (row0, col0)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, key_padding_mask, seed, out, lse = ctx.saved_tensors
        with annotate("vimo.attn.bwd"):
            grads = backward(q, k, v, key_padding_mask, seed, ctx.dropout_rate, out, lse,
                             grad_out, *ctx.offsets)
        return (*grads, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_padding_mask: torch.Tensor | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: torch.Tensor | int | None = None,
    row0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """Masked attention with torch MHA numerics, differentiable.

    Args:
        q: (B, H, Tq, D) float32 or bfloat16.
        k, v: (B, H, Tk, D), q's dtype.
        key_padding_mask: (B, Tk) bool, True = IGNORE the key (torch
            convention); masked keys get a -1e9 bias, so a fully masked row
            is uniform over the real keys.
        dropout_rate: attention-weight dropout probability in [0, 1).
        dropout_seed: required when dropout_rate > 0: a scalar, (B,) or
            (B, H) int seed, expanded as ``expand_seed`` does.
        row0, col0: the global (query row, key) of element (0, 0) for the
            dropout bits, when q and k are blocks of longer sequences;
            ``col0`` a multiple of 4.
    Returns:
        (B, H, Tq, D) in q's dtype.
    """
    _check_args(q, k, v, key_padding_mask, dropout_rate, dropout_seed)
    check_offsets(row0, col0)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, h = q.shape[:2]
    with annotate("vimo.attn.fwd"):
        seed = None
        if dropout_rate > 0.0:
            seed = expand_seed(dropout_seed, b, h, device=q.device)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _FlashAttention.apply(q, k, v, key_padding_mask, seed,
                                         float(dropout_rate), row0, col0)
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, key_padding_mask, dropout_rate,
                                             seed=seed, row0=row0, col0=col0)
        return _launch_fwd(q, k, v, key_padding_mask, seed, dropout_rate, with_lse=False,
                           row0=row0, col0=col0)[0]


flash_attention.launches = dict.fromkeys(LAUNCH_KINDS, 0)


def reset_launch_counts() -> None:
    """Zero every kernel's launch count."""
    for kind in LAUNCH_KINDS:
        flash_attention.launches[kind] = 0


def kernel_keep_bits(kind: str, seed: torch.Tensor, rows: int, cols: int, dropout_rate: float,
                     row0: int = 0, col0: int = 0, head_dim: int = 64,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The keep bits a kernel of ``dtype`` draws for (``row0`` + r,
    ``col0`` + c), r < ``rows``, c < ``cols``, read back from the card:
    (B, H, rows, cols) bool, for holding the kernels' bits to
    ``dropout_keep_mask`` bit for bit. ``seed``: (B, H) int32 on the card;
    ``head_dim``: which kernel draws them (above 128 the wide ones; the
    probes below sit in its first 64 columns, zeros past them).

    - ``fwd_lse`` (K1'): q = k = 0 and v = I over 64-key windows, so
      o[r, c] = keep[r, c] / (64 (1 - p)); ``cols`` a multiple of 64;
    - ``bwd_dqkv`` (K2, ``cols`` <= 512): q = k = v = 0, lse = delta = 0 and
      dO = I over 64-row windows, so dv[c, r] = keep[r, c] / (1 - p);
      ``rows`` a multiple of 64;
    - ``bwd_dq`` (K3): in bf16 (``cols`` > 512) the keep-bit buffer it
      fills for K4; in float32, which keeps no buffer, q = 0 and lse =
      delta = 0 (P = 1), dO = v = e_0 (dP = 1) and k = I over 64-key
      windows, so dq[r, c] = scale keep[r, c] / (1 - p); ``cols`` a
      multiple of 64.
    Each launch counts as any other."""
    b, h = seed.shape
    dev, dt, d = seed.device, dtype, head_dim
    eye = torch.zeros(b, h, 64, d, dtype=dt, device=dev)
    eye[..., :64] = torch.eye(64, dtype=dt, device=dev)
    if kind == "bwd_dq" and dtype == torch.float32:
        q = torch.zeros(b, h, rows, d, dtype=dt, device=dev)
        zero = torch.zeros(b, h, rows, dtype=torch.float32, device=dev)
        grad = q.clone()
        grad[..., 0] = 1.0
        v = torch.zeros(b, h, 64, d, dtype=dt, device=dev)
        v[..., 0] = 1.0
        outs = []
        for c in range(0, cols, 64):
            dq = _heads_major(b, rows, h, d, dt, dev)
            _launch_bwd("bwd_dq", q, eye, v, None, seed, dropout_rate, zero, zero, grad, dq,
                        None, None, row0=row0, col0=col0 + c)
            outs.append(dq[..., :64])
        return torch.cat(outs, dim=-1) != 0
    if kind == "fwd_lse":
        q, k = (torch.zeros(b, h, n, d, dtype=dt, device=dev) for n in (rows, 64))
        outs = [forward_lse(q, k, eye, None, seed, dropout_rate, row0, col0 + c)[0][..., :64]
                for c in range(0, cols, 64)]
        return torch.cat(outs, dim=-1) != 0
    if kind == "bwd_dqkv":
        q = torch.zeros(b, h, 64, d, dtype=dt, device=dev)
        k = torch.zeros(b, h, cols, d, dtype=dt, device=dev)
        zero = torch.zeros(b, h, 64, dtype=torch.float32, device=dev)
        outs = [backward_kernels(q, k, k, None, seed, dropout_rate, None, zero, eye,
                                 row0 + r, col0, delta=zero)[2][..., :64].transpose(-1, -2)
                for r in range(0, rows, 64)]
        return torch.cat(outs, dim=-2) != 0
    if kind != "bwd_dq":
        raise ValueError(f"no keep-bit probe for {kind!r}")
    q = torch.zeros(b, h, rows, d, dtype=dt, device=dev)
    k = torch.zeros(b, h, cols, d, dtype=dt, device=dev)
    zero = torch.zeros(b, h, rows, dtype=torch.float32, device=dev)
    nk, tq_pad = -(-cols // 64), -(-rows // 64) * 64
    bits = torch.zeros(b, h, nk, tq_pad, 2, dtype=torch.int32, device=dev)
    dq = _heads_major(b, rows, h, d, dt, dev)
    _launch_bwd("bwd_dq", q, k, k, None, seed, dropout_rate, zero, zero, q, dq, None, None,
                bits, row0=row0, col0=col0)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    kept = (words[..., None] >> shifts) & 1  # (B, H, nk, tq_pad, 2, 32)
    kept = kept.reshape(b, h, nk, tq_pad, 64).permute(0, 1, 3, 2, 4).reshape(b, h, tq_pad,
                                                                           nk * 64)
    return kept[:, :, :rows, :cols].bool()
