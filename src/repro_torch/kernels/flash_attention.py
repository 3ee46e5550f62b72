"""Flash attention (online softmax): the CUDA kernel's wrapper.

Port of ``repro.kernels.flash_attention`` (Pallas ``_kernel``).  One
launch of ``csrc/flash_attention.cu`` computes GQA attention with causal
and sliding-window tile skipping, gemma2's logit softcap and the decode
alignment (the last query sees the last key), with a float32 running
max, denominator and accumulator, and an output in q's type.

The kernel reads q, k and v by strides (the last dimension must be
contiguous), so the (B, H, L, D) transposed views of (B, L, H, D)
projections go in without a copy, and the output is allocated in q's
layout.  The bf16 body reads q, k and v through TMA tensor maps, which
need 16-byte aligned pointers and strides: a bf16 input whose pointer is
not 16-byte aligned, or whose strides are not multiples of 8, is copied
to a fresh contiguous tensor first.  This wrapper launches the kernel on
CUDA tensors only;
``kernels.ops`` routes CPU tensors to the plain version in
``kernels.ref`` and CUDA tensors through the opaque custom op
``repro_torch::flash_attention``, whose flop rule is :func:`flops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: head dims the kernel is instantiated for: the manifest's configs (16),
#: h2o-danube (80), the zoo's other decoder attention models (128)
HEAD_DIMS = (16, 80, 128)

_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_fn():
    fn = build.load("flash_attention").flash_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    # bf16, q, k, v, out, strides, B, Hq, Hkv, Lq, Lkv, D, causal, window,
    # softcap, scale, stream
    fn.argtypes = [i, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                   i, i, i, i, i, i, i, i, ctypes.c_float, ctypes.c_float,
                   p]
    fn.restype = ctypes.c_int
    return fn


def aligned16(t: torch.Tensor) -> bool:
    """Every row start of ``t`` is 16-byte aligned: a 16-byte aligned
    pointer and strides (but the last) that are multiples of 16 bytes."""
    return (t.data_ptr() % 16 == 0
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1]))


def validate(q, k, v, window) -> None:
    """The contract both routes share: (B, Hq, Lq, D) q and (B, Hkv, Lkv,
    D) k and v of one float dtype, Hkv | Hq, Lq <= Lkv (every query then
    sees a key) and a window of at least 1 or None."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D tensor (B, H, L, D)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Hq, Lq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Hkv, Lkv, {D})")
    Hkv, Lkv = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"kv heads {Hkv} must divide query heads {Hq}")
    if not 1 <= Lq <= Lkv:
        raise ValueError(f"need 1 <= Lq <= Lkv, got Lq {Lq}, Lkv {Lkv}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def visible_pairs(lq: int, lkv: int, *, causal: bool = True,
                  window: int | None = None) -> int:
    """(query, key) pairs per head that the masks leave visible: query i
    sits at position i + lkv - lq (the last query sees the last key) and
    sees the keys at or before it under ``causal``, within ``window``
    positions of it under a window."""
    total = 0
    for qpos in range(lkv - lq, lkv):
        hi = qpos if causal else lkv - 1
        lo = max(0, qpos - int(window) + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flops(q_shape, k_shape, *, causal: bool = True,
          window: int | None = None) -> int:
    """The kernel's flops on (B, Hq, Lq, D) queries against (B, Hkv, Lkv,
    D) keys: 4 D Hq B per visible pair (2 D for QK^T, 2 D for PV)."""
    B, Hq, Lq, D = q_shape
    return 4 * D * Hq * B * visible_pairs(Lq, k_shape[2], causal=causal,
                                          window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lkv, D), float32 or bfloat16, any
    strides with a unit last stride.  ``scale`` defaults to D ** -0.5.
    Returns (B, Hq, Lq, D) in q's dtype and layout."""
    if not isinstance(q, torch.Tensor) or q.device.type != "cuda":
        raise ValueError("the CUDA flash attention takes CUDA tensors, got q "
                         f"on {getattr(q, 'device', type(q))}")
    validate(q, k, v, window)
    if q.dtype not in _DTYPES:
        raise TypeError(f"the CUDA flash attention supports float32/bfloat16,"
                        f" got {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    B, Hq, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    if softcap is not None and float(softcap) <= 0.0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"batch {B} and heads {Hq} must be <= 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    out = torch.empty_like(q)       # q's layout where q is dense
    if q.dtype == torch.bfloat16:
        q, k, v = (t if aligned16(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    scale = float(D) ** -0.5 if scale is None else float(scale)
    fn = _kernel_fn()
    build.regions("flash_attention", inputs={"q": q, "k": k, "v": v},
                  outputs={"out": out})
    rc = fn(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), strides, B, Hq, Hkv, Lq, Lkv, D,
        int(bool(causal)), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    return out
