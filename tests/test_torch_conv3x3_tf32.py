"""The accuracy budget of the conv kernels' tensor-core route, on the CPU.

``csrc/conv3x3.cu`` and ``csrc/conv3x3_dw.cu`` run each float32 product on
the TF32 tensor cores as three products of split operands (3xTF32):

    a * b ~= a_hi * b_hi + a_hi * b_lo + a_lo * b_hi,
    x_hi = cvt.rna.tf32(x),  x_lo = cvt.rna.tf32(x - x_hi).

This file emulates that split in torch (rounding to TF32 by bit arithmetic,
as ``cvt.rna`` does) on the plain forward, input cotangent and weight
cotangent at small decoder shapes, against float64. With the products summed
in float32 by the plain versions' own rounding, the split stays within the
card's gates (``chip_smoke.py`` phases 4 and 8: 1e-4 of max |ref| for the
forward, 2e-5 for dx and dw) and one TF32 product (1xTF32) does not, which
is why the kernels take three.

The tensor cores add into their float32 accumulator with truncation, which
the plain versions' rounding does not show. A second test models it on the
forward's GEMM at upconv_4_0 (K = 9 x 512): each m16n8k8 step's sum of eight
products is exact and is truncated toward zero once as it is added. Summed
that way over the whole K, 3xTF32 misses the moments kernel's 2e-5 gate;
summed per staged chunk (9 taps x 8 channels) from zero and added to a
float32 accumulator with round to nearest, as the kernels do
(``csrc/mma_tf32.cuh``), it meets it. It also holds the weight
rearrangement the input-cotangent kernel reads against ``_flip_w``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fsnet_tpu_torch.ops import conv3x3 as tc

GATE = {"forward": 1e-4, "dx": 2e-5, "dw": 2e-5}

# (B, H, W, Cs, Co, pad_mode): the decoder's widths at batch 1 and cut
# frames: upconv_4_0, upconv_4_1, upconv_1_1's 32 + 64 -> 32, a 16 -> 16
SHAPES = [
    (1, 6, 20, (512,), 256, "zeros"),
    (1, 12, 40, (256, 256), 256, "replicate"),
    (1, 24, 40, (32, 64), 32, "replicate"),
    (1, 24, 80, (16,), 16, "replicate"),
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of a finite float32 tensor: round to nearest, ties
    away from zero, on the 13 dropped mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _inputs(shape, seed):
    B, H, W, Cs, Co, _ = shape
    rng = np.random.RandomState(seed)
    parts = [torch.from_numpy(rng.randn(B, H, W, c).astype(np.float32))
             for c in Cs]
    w = torch.from_numpy((rng.randn(3, 3, sum(Cs), Co)
                          / np.sqrt(9 * sum(Cs))).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H, W, Co).astype(np.float32))
    return parts, w, g


def _op(kind, pad_mode, Cs):
    """The plain version as a function of its two float32 operands (both
    linear in each), returning a tuple of outputs."""
    if kind == "forward":       # conv3x3_plain's body, float64 allowed
        return lambda parts, w, g: (tc._conv_core(parts, w, None, pad_mode),)
    if kind == "dx":
        return lambda parts, w, g: tc.conv3x3_dx_plain(g, w, pad_mode, Cs)
    return lambda parts, w, g: (tc.conv3x3_dw_plain(parts, g, pad_mode),)


def _rel_err(got, ref):
    return max(float((a.double() - r).abs().max() / r.abs().max())
               for a, r in zip(got, ref))


def _split_products(kind, op, parts, w, g):
    """(3xTF32, 1xTF32) of the plain version ``op``: its two operands (x and
    w for the forward, g and w for dx, x and g for dw) split into TF32 hi
    and lo, the products hi*hi, hi*lo and lo*hi each summed in float32, the
    small ones first, as the kernels add them."""
    xs = [split(p) for p in parts]
    hi = [h for h, _ in xs]
    lo = [low for _, low in xs]
    sw, sg = split(w), split(g)
    if kind == "forward":
        args = [(hi, sw[0], g), (hi, sw[1], g), (lo, sw[0], g)]
    elif kind == "dx":
        args = [(parts, sw[0], sg[0]), (parts, sw[1], sg[0]),
                (parts, sw[0], sg[1])]
    else:
        args = [(hi, w, sg[0]), (hi, w, sg[1]), (lo, w, sg[0])]
    big, cross_a, cross_b = (op(*a) for a in args)
    return (tuple(a + b + c for a, b, c in zip(cross_a, cross_b, big)),
            big)


@pytest.mark.parametrize("kind", ["forward", "dx", "dw"])
@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_meets_the_gates_and_1xtf32_does_not(shape, kind):
    parts, w, g = _inputs(shape, seed=SHAPES.index(shape))
    op = _op(kind, shape[5], shape[3])
    ref = op([p.double() for p in parts], w.double(), g.double())
    three, one = _split_products(kind, op, parts, w, g)
    e3, e1 = _rel_err(three, ref), _rel_err(one, ref)
    assert e3 <= GATE[kind], (kind, e3)
    assert e1 > GATE[kind], (kind, e1)


def _truncated(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _tensor_core_gemm(A, B, chunk_steps):
    """A [M, K] @ B [K, N] in 3xTF32 on the model of the tensor cores: per
    k8 step three products (lo*hi, hi*lo, hi*hi, the kernels' order), each
    step's sum of eight exact and truncated to float32 as it is added.
    ``chunk_steps``: k8 steps summed from zero before the partial is added
    to a float32 accumulator (round to nearest); None: the whole K on the
    tensor cores."""
    (ah, al), (bh, bl) = split(A), split(B)
    acc = torch.zeros(A.shape[0], B.shape[1])
    d = torch.zeros_like(acc)
    for s in range(A.shape[1] // 8):
        k = slice(8 * s, 8 * s + 8)
        for a, b in ((al, bh), (ah, bl), (ah, bh)):
            d = _truncated(d.double() + a[:, k].double() @ b[k].double())
        if chunk_steps and (s + 1) % chunk_steps == 0:
            acc, d = acc + d, torch.zeros_like(d)
    return acc + d


@pytest.mark.parametrize("per_chunk", [False, True])
def test_truncating_accumulation_needs_the_per_chunk_float32_add(per_chunk):
    """upconv_4_0 (512 -> 256) at one 6x20 frame as the forward kernel's
    GEMM, K in its order (chunks of 8 channels, 9 taps each): the whole K
    truncated on the tensor cores misses 2e-5, chunk partials added in
    float32 stay well inside it."""
    Cin, Co, H, W = 512, 256, 6, 20
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, Cin, H, W).astype(np.float32))
    w = torch.from_numpy((rng.randn(Co, Cin, 3, 3)
                          / np.sqrt(9 * Cin)).astype(np.float32))
    cols = F.unfold(x, 3, padding=1)[0].T                # [HW, (ci, tap)]
    A = cols.reshape(H * W, Cin // 8, 8, 9).permute(0, 1, 3, 2) \
        .reshape(H * W, 9 * Cin).contiguous()            # (chunk, tap, ci)
    B = w.reshape(Co, Cin // 8, 8, 9).permute(1, 3, 2, 0) \
        .reshape(9 * Cin, Co).contiguous()
    ref = A.double() @ B.double()
    got = _tensor_core_gemm(A, B, 9 if per_chunk else None)
    e = float((got.double() - ref).abs().max() / ref.abs().max())
    if per_chunk:
        assert e <= GATE["dx"] / 4, e
    else:
        assert e > GATE["dx"], e


def test_dx_weight_is_the_flipped_weight_read_backwards():
    """The input-cotangent kernel reads ``_dx_weight(w)`` ([3, 3, Co, C],
    channel axes swapped) at tap 8 - t: that is tap t of ``_flip_w(w)``,
    and element [dy, dx, co, ci] is HWIO ``w[dy, dx, ci, co]``."""
    w = torch.from_numpy(np.random.RandomState(3).randn(3, 3, 5, 4)
                         .astype(np.float32))
    wt = tc._dx_weight(w)
    assert wt.shape == (3, 3, 4, 5) and wt.is_contiguous()
    flipped = tc._flip_w(w).reshape(9, 4, 5)
    for t in range(9):
        assert torch.equal(wt.reshape(9, 4, 5)[8 - t], flipped[t])
    for dy, dx, ci, co in [(0, 2, 1, 3), (2, 0, 4, 0), (1, 1, 2, 2)]:
        assert wt[dy, dx, co, ci] == w[dy, dx, ci, co]
