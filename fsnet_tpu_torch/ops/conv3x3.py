"""The decoder's 3x3 convolution, its BN-moments variant and its gradients:
the Hopper kernels' wrappers and their plain PyTorch versions.

Counterpart of ``fsnet_tpu.ops.fast_conv.conv3x3_packed`` /
``conv3x3_packed_bn`` as they reach the TPU kernels of
``fsnet_tpu.ops.pallas.conv_kernel`` (``conv3x3_fused_mats``,
``conv3x3_fused_mats_m``, ``conv3x3_fused_dw``; ``fast_conv.py:378-524``),
without the TPU's width-packed layout: inputs and output are NHWC, the
weight is HWIO ``[3, 3, sum(C), Co]`` as in the JAX package, and a two-part
input is convolved as the channel concat of its parts, in order, without
building that concat.

:func:`conv3x3` and :func:`conv3x3_bn` are differentiable
(``torch.autograd.Function``). Every function here picks its route from the
device of the tensors it is given: on the CPU it runs the plain version; on
a CUDA device it launches its kernel or raises. Each wrapper counts its
kernel's launches in ``<function>.launches``, and by the dtype of the
operands the kernel ran on in ``<function>.dtypes``:

* :func:`conv3x3`: ``csrc/conv3x3.cu`` (forward, TPU ``conv3x3_fused_mats``),
  launched through the registered operator ``torch.ops.fsnet_tpu_torch.
  conv3x3`` (:func:`conv3x3_op`: the plain version on the CPU, the kernel
  on a CUDA device, a shape function for ``torch.export``); where no
  gradient is needed :func:`conv3x3` calls the operator itself, so an
  exported inference program records it;
* :func:`conv3x3_bn`: the same kernel with its moments epilogue (TPU
  ``conv3x3_fused_mats_m``), float32 or bfloat16: the moments are float32
  sums of the stored output, in bfloat16 of each output after its
  rounding (``conv_kernel.py:196-200``);
* :func:`conv3x3_dx`: the same kernel in its input-cotangent mode (TPU
  ``conv3x3_fused_mats`` on transposed mats): the output cotangent's zero
  halo, the weight's flip and the replicate halo's fold happen inside the
  kernel, and both parts' cotangents come from one launch per conv; float32
  or bfloat16;
* :func:`conv3x3_dw`: ``csrc/conv3x3_dw.cu`` (TPU ``conv3x3_fused_dw``),
  float32 or bfloat16 operands, a float32 cotangent.

Both kernels are implicit GEMMs on the tensor cores (``mma.sync`` m16n8k8
TF32 fed by a ``cp.async`` ring): float32 runs as 3xTF32 (three products of
split operands, as accurate as float32 FMA), bfloat16 as one exact
product. Both sum each staged chunk's products from zero and add the
chunk's partial in float32, so a bfloat16 output is the rounding of a sum
as accurate as the plain version's float32 one.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Parts = Union[torch.Tensor, Sequence[torch.Tensor]]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DT_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def is_low(dtype: torch.dtype) -> bool:
    """Whether the port computes on ``dtype`` widened to float32 and rounds
    its results back to it: bfloat16, the bf16 train step's dtype."""
    return dtype == torch.bfloat16

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
        raise TypeError(f"conv3x3 takes {sorted(map(str, _DTYPES))}, got "
                        f"{x0.dtype}")
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


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on the CPU or a CUDA device, not "
                           f"{x.device}")
    return True


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _pad_hw(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """One-pixel spatial pad of an NHWC tensor."""
    if pad_mode == "zeros":
        return F.pad(x, (0, 0, 1, 1, 1, 1))
    x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


# ----------------------------------------------------------- plain versions

def _conv_core(parts, w, bias, pad_mode) -> torch.Tensor:
    acc = _acc_dtype(parts[0].dtype)
    B, H, W, _ = parts[0].shape
    wf = w.to(acc)
    out = None
    off = 0
    for p in parts:
        C = p.shape[3]
        xp = _pad_hw(p.to(acc), pad_mode)
        for dy in range(3):
            for dx in range(3):
                y = torch.einsum("bhwc,cd->bhwd", xp[:, dy:dy + H, dx:dx + W],
                                 wf[dy, dx, off:off + C])
                out = y if out is None else out + y
        off += C
    if bias is not None:
        out = out + bias.to(acc)
    return out.to(parts[0].dtype)


def conv3x3_plain(x: Parts, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  pad_mode: str = "zeros") -> torch.Tensor:
    """Plain version of the forward: pad each part, then sum nine per-tap
    channel contractions in float32; the result is cast to the input
    dtype."""
    parts = _as_parts(x)
    _check(parts, w, bias, pad_mode)
    return _conv_core(parts, w, bias, pad_mode)


def moments_plain(out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel sum and sum of squares of an NHWC tensor, in float32 or
    wider (the moments epilogue's plain version)."""
    o = out.to(_acc_dtype(out.dtype))
    return o.sum(dim=(0, 1, 2)), (o * o).sum(dim=(0, 1, 2))


def conv3x3_dw_plain(x: Parts, g: torch.Tensor,
                     pad_mode: str = "zeros") -> torch.Tensor:
    """Plain version of the weight cotangent:
    ``dW[dy, dx, ci, co] = sum_{b,h,w} pad(x)[b, h+dy, w+dx, ci] *
    g[b, h, w, co]`` -> ``[3, 3, sum(C), Co]``."""
    parts = _as_parts(x)
    acc = _acc_dtype(g.dtype)
    H, W = g.shape[1:3]
    gf = g.to(acc)
    dws = []
    for p in parts:
        xp = _pad_hw(p.to(acc), pad_mode)
        taps = [torch.einsum("bhwc,bhwd->cd", xp[:, dy:dy + H, dx:dx + W], gf)
                for dy in range(3) for dx in range(3)]
        dws.append(torch.stack(taps).reshape(3, 3, p.shape[3], g.shape[3]))
    return torch.cat(dws, dim=2)


def _flip_w(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, C, Co] -> correlation weights of the input cotangent:
    spatially flipped, channels transposed -> [3, 3, Co, C]
    (``fast_conv._flip_w``)."""
    return w.flip(0, 1).transpose(2, 3)


def _fold_halo(e: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Cotangent of the one-pixel-padded input [B, H+2, W+2, C] -> the
    cotangent of the input [B, H, W, C]. Under replicate padding the halo
    rows and columns fold into the edge rows and columns, corners included
    (rows first, then columns)."""
    H, W = e.shape[1] - 2, e.shape[2] - 2
    if pad_mode == "zeros":
        return e[:, 1:H + 1, 1:W + 1].contiguous()
    r = e[:, 1:H + 1].clone()
    r[:, 0] += e[:, 0]
    r[:, H - 1] += e[:, H + 1]
    d = r[:, :, 1:W + 1].clone()
    d[:, :, 0] += r[:, :, 0]
    d[:, :, W - 1] += r[:, :, W + 1]
    return d


# ------------------------------------------------------------------ kernels

def _entry(lib: str, fn: str, pointers: Sequence[int], nargs: int,
           floats: Sequence[int] = ()):
    """The C entry point ``fn`` of ``csrc/<lib>.cu``, built and loaded on
    first use, with its argument types declared (without them ctypes cuts
    pointers to 32 bits). ``pointers``: positions of pointer arguments;
    the last argument (the stream) is a pointer too; ``floats``: positions
    of float arguments; the rest are ints."""
    from . import _build

    f = getattr(_build.load(lib), fn)
    if f.argtypes is None:
        ptrs = set(pointers) | {nargs - 1}
        f.argtypes = [ctypes.c_void_p if i in ptrs else
                      ctypes.c_float if i in floats else ctypes.c_int
                      for i in range(nargs)]
        f.restype = ctypes.c_int
    return f


def _kernel():
    """The forward kernel's C entry point (no moments)."""
    return _entry("conv3x3", "fsnet_conv3x3_nhwc", (0, 2, 4, 5, 6), 14)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _counted(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s kernel on ``dtype`` operands."""
    fn.launches += 1
    fn.dtypes[_DT_NAMES[dtype]] += 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch_conv(parts, w, bias, pad_mode, mom=None) -> torch.Tensor:
    x0 = parts[0]
    B, H, W, C0 = x0.shape
    x1 = parts[1] if len(parts) == 2 else None
    Co = w.shape[3]
    out = torch.empty((B, H, W, Co), dtype=x0.dtype, device=x0.device)
    args = (x0.data_ptr(), C0, None if x1 is None else x1.data_ptr(),
            0 if x1 is None else x1.shape[3], w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    tail = (B, H, W, Co, int(pad_mode == "replicate"))
    with torch.cuda.device(x0.device):
        if mom is None:
            err = _kernel()(*args, *tail, _DTYPES[x0.dtype], _stream(x0))
        else:
            err = _entry("conv3x3", "fsnet_conv3x3_bn_nhwc",
                         (0, 2, 4, 5, 6, 7), 15)(*args, mom.data_ptr(), *tail,
                                                 _DTYPES[x0.dtype],
                                                 _stream(x0))
    _raise_on(err, "conv3x3")
    return out


@torch.library.custom_op("fsnet_tpu_torch::conv3x3", mutates_args=(),
                         device_types="cpu")
def conv3x3_op(parts: List[torch.Tensor], w: torch.Tensor,
               bias: Optional[torch.Tensor], pad_mode: str) -> torch.Tensor:
    """The forward as a registered operator, ``torch.ops.fsnet_tpu_torch.
    conv3x3`` (so that ``torch.export`` records it and a saved program
    calls it): on the CPU the plain version, on a CUDA device the kernel,
    counted in ``conv3x3.launches``; on any other device it raises."""
    return _conv_core(tuple(parts), w, bias, pad_mode)


@conv3x3_op.register_kernel("cuda")
def _conv3x3_cuda(parts, w, bias, pad_mode):
    parts = tuple(parts)
    out = _launch_conv(parts, w, bias, pad_mode)
    _counted(conv3x3, parts[0].dtype)
    return out


@conv3x3_op.register_fake
def _conv3x3_fake(parts, w, bias, pad_mode):
    B, H, W, _ = parts[0].shape
    return parts[0].new_empty((B, H, W, w.shape[3]))


def _forward(parts, w, bias, pad_mode) -> torch.Tensor:
    _route(parts[0], "conv3x3")
    return conv3x3_op(list(parts), w, bias, pad_mode)


def _forward_bn(parts, w, bias, pad_mode):
    if not _route(parts[0], "conv3x3_bn"):
        out = _conv_core(parts, w, bias, pad_mode)
        return (out, *moments_plain(out))
    mom = torch.zeros((2, w.shape[3]), dtype=torch.float32,
                      device=parts[0].device)
    out = _launch_conv(parts, w, bias, pad_mode, mom)
    _counted(conv3x3_bn, parts[0].dtype)
    return out, mom[0], mom[1]


def conv3x3_dx_plain(g: torch.Tensor, w: torch.Tensor, pad_mode: str,
                     Cs: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Plain version of the input cotangents, one per input part of ``Cs``
    channels: the conv of the zero-padded output cotangent ``g``
    [B, H, W, Co] with the flipped, io-transposed weight slice of each part
    gives the cotangent of the padded input [B, H+2, W+2, C], which
    :func:`_fold_halo` folds to [B, H, W, C], in float32 or wider; the
    result is cast to ``g``'s dtype once (a bfloat16 edge pixel is the
    rounding of its whole sum, as the kernel's epilogue folds it)."""
    acc = _acc_dtype(g.dtype)
    gp = F.pad(g.to(acc), (0, 0, 1, 1, 1, 1))
    wf = _flip_w(w.to(acc))
    dxs = []
    off = 0
    for c in Cs:
        e = _conv_core((gp,), wf[..., off:off + c].contiguous(), None, "zeros")
        dxs.append(_fold_halo(e, pad_mode).to(g.dtype))
        off += c
    return tuple(dxs)


def _dx_weight(w: torch.Tensor) -> torch.Tensor:
    """The weight as the input-cotangent kernel reads it: ``[3, 3, Co, C]``,
    channel axes swapped but not flipped (one copy of the small weight); the
    kernel takes tap ``8 - t`` of it, which is tap ``t`` of
    :func:`_flip_w`."""
    return w.transpose(2, 3).contiguous()


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor, pad_mode: str,
               Cs: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Input cotangents of the conv, one per input part of ``Cs`` channels:
    on a CUDA device one launch of the conv kernel's input-cotangent mode
    for all parts."""
    if not _route(g, "conv3x3_dx"):
        return conv3x3_dx_plain(g, w, pad_mode, Cs)
    if g.dtype not in _DTYPES or w.dtype != g.dtype or \
            w.device != g.device or not g.is_contiguous() or g.dim() != 4:
        raise TypeError("conv3x3_dx takes a contiguous NHWC cotangent and a "
                        f"weight of one dtype of {sorted(map(str, _DTYPES))} "
                        "on one device")
    Cs = tuple(int(c) for c in Cs)
    B, H, W, Co = g.shape
    if not 1 <= len(Cs) <= 2 or tuple(w.shape) != (3, 3, sum(Cs), Co):
        raise ValueError(f"weight {tuple(w.shape)} does not match parts {Cs} "
                         f"and the cotangent's {Co} channels")
    wt = _dx_weight(w)
    dxs = tuple(torch.empty((B, H, W, c), dtype=g.dtype, device=g.device)
                for c in Cs)
    with torch.cuda.device(g.device):
        err = _entry("conv3x3", "fsnet_conv3x3_dx_nhwc", (0, 2, 3, 5), 13)(
            g.data_ptr(), Co, wt.data_ptr(), dxs[0].data_ptr(), Cs[0],
            dxs[1].data_ptr() if len(Cs) == 2 else None,
            Cs[1] if len(Cs) == 2 else 0, B, H, W,
            int(pad_mode == "replicate"), _DTYPES[g.dtype], _stream(g))
    _raise_on(err, "conv3x3_dx")
    _counted(conv3x3_dx, g.dtype)
    return dxs


def conv3x3_dw(x: Parts, g: torch.Tensor, pad_mode: str = "zeros"
               ) -> torch.Tensor:
    """Weight cotangent ``[3, 3, sum(C), Co]`` (float32) of the conv of
    ``x`` (one or two NHWC parts) given the output cotangent ``g``, both of
    one dtype, float32 or bfloat16."""
    parts = _as_parts(x)
    if not _route(g, "conv3x3_dw"):
        return conv3x3_dw_plain(parts, g, pad_mode)
    for t in (*parts, g):
        if t.dtype not in _DTYPES or t.dtype != g.dtype or \
                not t.is_contiguous() or t.device != g.device or \
                t.shape[:3] != g.shape[:3]:
            raise TypeError("conv3x3_dw takes contiguous NHWC tensors of one "
                            f"dtype of {sorted(map(str, _DTYPES))} and one "
                            "[B, H, W] on one device")
    B, H, W, Co = g.shape
    x1 = parts[1] if len(parts) == 2 else None
    dw = torch.zeros((3, 3, sum(p.shape[3] for p in parts), Co),
                     dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = _entry("conv3x3_dw", "fsnet_conv3x3_dw_nhwc", (0, 2, 4, 5), 13)(
            parts[0].data_ptr(), parts[0].shape[3],
            None if x1 is None else x1.data_ptr(),
            0 if x1 is None else x1.shape[3], g.data_ptr(), dw.data_ptr(),
            B, H, W, Co, int(pad_mode == "replicate"), _DTYPES[g.dtype],
            _stream(g))
    _raise_on(err, "conv3x3_dw")
    _counted(conv3x3_dw, g.dtype)
    return dw


# ------------------------------------------------------------------ autograd

class Conv3x3Function(torch.autograd.Function):
    """Forward: the conv (``moments=False``) or the conv and its
    per-channel sum and sum of squares (``moments=True``). Backward
    (``fast_conv._pallas_cvjp_bwd`` / ``_pallas_bn_cvjp_bwd``): the moment
    cotangents fold into the output cotangent as ``g + gs1 + 2*out*gs2``,
    formed in float32 or wider and rounded to the cotangent's dtype, then
    dx of every part (:func:`conv3x3_dx`), dw (:func:`conv3x3_dw`, rounded
    to the weight's dtype) and dbias ``g.sum((0, 1, 2))`` (summed in
    float32 or wider)."""

    @staticmethod
    def forward(ctx, pad_mode, moments, w, bias, *parts):
        if moments:
            out, s1, s2 = _forward_bn(parts, w, bias, pad_mode)
        else:
            out = _forward(parts, w, bias, pad_mode)
        ctx.pad_mode, ctx.moments = pad_mode, moments
        ctx.has_bias = bias is not None
        ctx.Cs = tuple(p.shape[3] for p in parts)
        ctx.save_for_backward(w, out if moments else None, *parts)
        return (out, s1, s2) if moments else out

    @staticmethod
    def backward(ctx, g, gs1=None, gs2=None):
        w, out, *parts = ctx.saved_tensors
        acc = _acc_dtype(g.dtype)
        if ctx.moments:
            g = (g.to(acc) + gs1 + 2.0 * out.to(acc) * gs2).to(g.dtype)
        g = g.contiguous()
        need_x = ctx.needs_input_grad[4:]
        dxs = (conv3x3_dx(g, w, ctx.pad_mode, ctx.Cs) if any(need_x)
               else (None,) * len(parts))
        dw = (conv3x3_dw(parts, g, ctx.pad_mode).to(w.dtype)
              if ctx.needs_input_grad[2] else None)
        db = (g.to(acc).sum(dim=(0, 1, 2)).to(w.dtype)
              if ctx.has_bias and ctx.needs_input_grad[3] else None)
        return (None, None, dw, db, *dxs)


def conv3x3(x: Parts, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
            pad_mode: str = "zeros") -> torch.Tensor:
    """Stride-1 3x3 convolution with one-pixel ``zeros`` or ``replicate``
    padding. ``x`` is an NHWC tensor or a sequence of two that share
    [B, H, W] (convolved as their channel concat), ``w`` HWIO
    ``[3, 3, sum(C), Co]``, ``bias`` ``[Co]`` or None; float32 or bfloat16,
    accumulated in float32. Returns NHWC ``[B, H, W, Co]`` in the input
    dtype. Differentiable."""
    parts = _as_parts(x)
    _check(parts, w, bias, pad_mode)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (w, bias, *parts)):
        return Conv3x3Function.apply(pad_mode, False, w, bias, *parts)
    return _forward(parts, w, bias, pad_mode)


def conv3x3_bn(x: Parts, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
               pad_mode: str = "zeros"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`conv3x3` plus the per-channel sum ``s1`` and sum of squares
    ``s2`` ([Co] float32) of the stored output, for train-mode BatchNorm
    (``fast_conv.conv3x3_packed_bn``). Differentiable in all three."""
    parts = _as_parts(x)
    _check(parts, w, bias, pad_mode)
    return Conv3x3Function.apply(pad_mode, True, w, bias, *parts)


for _fn in (conv3x3, conv3x3_bn, conv3x3_dx, conv3x3_dw):
    _fn.launches = 0
    _fn.dtypes = dict.fromkeys(_DT_NAMES.values(), 0)
