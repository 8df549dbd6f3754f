"""The decoder's 3x3 convolution: the Hopper kernel's wrapper and its plain
PyTorch version.

Counterpart of ``fsnet_tpu.ops.fast_conv.conv3x3_packed`` as it reaches the
TPU kernel ``fsnet_tpu.ops.pallas.conv_kernel.conv3x3_fused_mats``
(``fast_conv.py:91-122``), without the TPU's width-packed layout: inputs and
output are NHWC, the weight is HWIO ``[3, 3, sum(C), Co]`` as in the JAX
package, and a two-part input is convolved as the channel concat of its
parts, in order, without building that concat.

:func:`conv3x3` picks its route from the device of the tensors it is given:
on the CPU it runs :func:`conv3x3_plain`; on a CUDA device it launches the
kernel of ``csrc/conv3x3.cu`` or raises. ``conv3x3.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAD_MODES = ("zeros", "replicate")


def _as_parts(x: Parts) -> Tuple[torch.Tensor, ...]:
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


def _check(parts, w, bias, pad_mode) -> None:
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"conv3x3 takes 1 or 2 input parts, got {len(parts)}")
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode must be one of {PAD_MODES}, got {pad_mode!r}")
    x0 = parts[0]
    if x0.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 takes float32 or bfloat16, got {x0.dtype}")
    tensors = list(parts) + [w] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != x0.dtype or t.device != x0.device:
            raise TypeError("conv3x3: inputs, weight and bias must share one "
                            f"dtype and device, got {t.dtype} on {t.device} "
                            f"beside {x0.dtype} on {x0.device}")
        if not t.is_contiguous():
            raise ValueError("conv3x3 takes contiguous tensors (NHWC inputs, "
                             "HWIO weight)")
    for p in parts:
        if p.dim() != 4 or p.shape[:3] != x0.shape[:3]:
            raise ValueError("conv3x3 parts must be NHWC with one [B, H, W], "
                             f"got {[tuple(q.shape) for q in parts]}")
    c_total = sum(p.shape[3] for p in parts)
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c_total):
        raise ValueError(f"weight must be HWIO [3, 3, {c_total}, Co], got "
                         f"{tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[3],):
        raise ValueError(f"bias must be [{w.shape[3]}], got {tuple(bias.shape)}")


def _pad_hw(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """One-pixel spatial pad of an NHWC tensor."""
    if pad_mode == "zeros":
        return torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def conv3x3_plain(x: Parts, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  pad_mode: str = "zeros") -> torch.Tensor:
    """Plain version: pad each part, then sum nine per-tap channel
    contractions in float32; the result is cast to the input dtype."""
    parts = _as_parts(x)
    _check(parts, w, bias, pad_mode)
    B, H, W, _ = parts[0].shape
    wf = w.float()
    out = None
    off = 0
    for p in parts:
        C = p.shape[3]
        xp = _pad_hw(p.float(), pad_mode)
        for dy in range(3):
            for dx in range(3):
                y = torch.einsum("bhwc,cd->bhwd", xp[:, dy:dy + H, dx:dx + W],
                                 wf[dy, dx, off:off + C])
                out = y if out is None else out + y
        off += C
    if bias is not None:
        out = out + bias.float()
    return out.to(parts[0].dtype)


def _kernel():
    """The kernel's C entry point, built and loaded on first use."""
    from . import _build

    fn = _build.load("conv3x3").fsnet_conv3x3_nhwc
    if fn.argtypes is None:     # without them ctypes cuts pointers to 32 bits
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def conv3x3(x: Parts, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
            pad_mode: str = "zeros") -> torch.Tensor:
    """Stride-1 3x3 convolution with one-pixel ``zeros`` or ``replicate``
    padding. ``x`` is an NHWC tensor or a sequence of two that share
    [B, H, W] (convolved as their channel concat), ``w`` HWIO
    ``[3, 3, sum(C), Co]``, ``bias`` ``[Co]`` or None; float32 or bfloat16,
    accumulated in float32. Returns NHWC ``[B, H, W, Co]`` in the input
    dtype."""
    parts = _as_parts(x)
    _check(parts, w, bias, pad_mode)
    x0 = parts[0]
    if x0.device.type == "cpu":
        return conv3x3_plain(parts, w, bias, pad_mode)
    if x0.device.type != "cuda":
        raise RuntimeError(f"conv3x3 runs on the CPU or a CUDA device, not "
                           f"{x0.device}")
    fn = _kernel()
    B, H, W, C0 = x0.shape
    x1 = parts[1] if len(parts) == 2 else None
    Co = w.shape[3]
    out = torch.empty((B, H, W, Co), dtype=x0.dtype, device=x0.device)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        err = fn(x0.data_ptr(), C0,
                 None if x1 is None else x1.data_ptr(),
                 0 if x1 is None else x1.shape[3],
                 w.data_ptr(), None if bias is None else bias.data_ptr(),
                 out.data_ptr(), B, H, W, Co, int(pad_mode == "replicate"),
                 _DTYPES[x0.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
