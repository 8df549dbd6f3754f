"""The port's conv3x3 (on the CPU: its plain version) against the JAX
package's Pallas conv kernel in interpret mode and against
``jax.lax.conv_general_dilated``: one and two input parts, zeros and
replicate padding, float32. Tolerance atol 1e-4, rtol 1e-5: the two sides
sum the same float32 products in different orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl

import fsnet_tpu.ops.pallas.conv_kernel as ck
from fsnet_tpu.ops import fast_conv as fc
from fsnet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(ck.pl, "pallas_call", patched)


def _inputs(seed, B, H, W, Cs, Co):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(B, H, W, c).astype(np.float32) for c in Cs]
    w = (rng.randn(3, 3, sum(Cs), Co) * 0.1).astype(np.float32)
    b = (rng.randn(Co) * 0.1).astype(np.float32)
    return xs, w, b


def _port(xs, w, b, pad_mode):
    out = conv3x3([torch.from_numpy(x) for x in xs], torch.from_numpy(w),
                  None if b is None else torch.from_numpy(b), pad_mode)
    assert conv3x3.launches == 0     # the CPU never launches the kernel
    return out.numpy()


@pytest.mark.parametrize("pad_mode", ["zeros", "replicate"])
def test_conv3x3_single_part_vs_pallas(pad_mode):
    B, H, W, C, Co = 2, 16, 128, 16, 16
    xs, w, b = _inputs(0, B, H, W, (C,), Co)
    with jax.default_matmul_precision("highest"):
        ref = fc._conv3x3_pallas_cvjp(
            (fc.pack_width(jnp.asarray(xs[0]), 128 // Co),), jnp.asarray(w),
            jnp.asarray(b), (C,), pad_mode)
    np.testing.assert_allclose(_port(xs, w, b, pad_mode),
                               np.asarray(fc.unpack_width(ref, Co)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pad_mode", ["zeros", "replicate"])
def test_conv3x3_two_part_vs_pallas(pad_mode):
    """The decoder's unmaterialised skip concat: C=(32, 64) -> Co=32, the
    upconv_1_1 widths."""
    B, H, W, Co = 2, 8, 64, 32
    Cs = (32, 64)
    xs, w, b = _inputs(1, B, H, W, Cs, Co)
    with jax.default_matmul_precision("highest"):
        ref = fc._conv3x3_pallas_cvjp(
            (fc.pack_width(jnp.asarray(xs[0]), 2),
             fc.pack_width(jnp.asarray(xs[1]), 1)),
            jnp.asarray(w), jnp.asarray(b), Cs, pad_mode)
    np.testing.assert_allclose(_port(xs, w, b, pad_mode),
                               np.asarray(fc.unpack_width(ref, Co)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pad_mode", ["zeros", "replicate"])
@pytest.mark.parametrize("Cs", [(16,), (24, 40)])
def test_conv3x3_vs_lax_conv(pad_mode, Cs):
    """Ragged sizes (H=6, W=20, as the decoder's coarsest stage) against
    XLA's native conv on the channel concat; no bias."""
    B, H, W, Co = 2, 6, 20, 24
    xs, w, _ = _inputs(2, B, H, W, Cs, Co)
    x = jnp.concatenate([jnp.asarray(a) for a in xs], axis=-1)
    if pad_mode == "replicate":
        x = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    with jax.default_matmul_precision("highest"):
        ref = jax.lax.conv_general_dilated(
            x, jnp.asarray(w), (1, 1),
            "VALID" if pad_mode == "replicate" else "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(_port(xs, w, None, pad_mode), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def test_conv3x3_plain_keeps_bfloat16():
    """The plain version accumulates in float32 and returns the input dtype."""
    xs, w, b = _inputs(3, 1, 5, 7, (8,), 8)
    x, wt, bt = (torch.from_numpy(a).bfloat16() for a in (xs[0], w, b))
    out = conv3x3_plain(x, wt, bt)
    ref = conv3x3_plain(x.float(), wt.float(), bt.float())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.bfloat16(), atol=0, rtol=0)


@pytest.mark.parametrize("case", [
    "three_parts", "weight_shape", "bias_shape", "float64", "mixed_dtype",
    "not_contiguous", "pad_mode", "parts_disagree",
])
def test_conv3x3_rejects(case):
    x = torch.zeros(1, 4, 5, 8)
    w = torch.zeros(3, 3, 8, 4)
    b = torch.zeros(4)
    args = {
        "three_parts": ((x, x, x), torch.zeros(3, 3, 24, 4), b, "zeros"),
        "weight_shape": (x, torch.zeros(3, 3, 4, 8), b, "zeros"),
        "bias_shape": (x, w, torch.zeros(5), "zeros"),
        "float64": (x.double(), w.double(), b.double(), "zeros"),
        "mixed_dtype": (x, w.bfloat16(), b, "zeros"),
        "not_contiguous": (torch.zeros(1, 5, 4, 8).transpose(1, 2), w, b,
                           "zeros"),
        "pad_mode": (x, w, b, "reflect"),
        "parts_disagree": ((x, torch.zeros(1, 4, 6, 8)),
                           torch.zeros(3, 3, 16, 4), b, "zeros"),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        conv3x3(*args)


def test_conv3x3_other_device_raises():
    """Neither CPU nor CUDA: the wrapper raises instead of falling back."""
    x = torch.zeros(1, 4, 5, 8, device="meta")
    w = torch.zeros(3, 3, 8, 4, device="meta")
    with pytest.raises(RuntimeError):
        conv3x3(x, w)


def test_kernel_entry_point_declares_its_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int and cuts a
    pointer: the entry point must carry its argtypes (ctypes' defaults are
    argtypes None, restype c_int)."""
    import ctypes
    import types

    from fsnet_tpu_torch.ops import _build
    from fsnet_tpu_torch.ops import conv3x3 as mod

    fn = types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        fsnet_conv3x3_nhwc=fn))
    assert mod._kernel() is fn
    assert len(fn.argtypes) == 14 and fn.restype is ctypes.c_int
    pointers = [0, 2, 4, 5, 6, 13]       # x0, x1, w, bias, out, stream
    assert all(fn.argtypes[i] is ctypes.c_void_p for i in pointers)
    assert all(t is ctypes.c_int for i, t in enumerate(fn.argtypes)
               if i not in pointers)
