"""Deployment export (counterpart of ``fsnet_tpu.runtime.export``): the
image-only inference graph (``dummy_forward``: no loss, a static input
shape) as a ``torch.export`` program, saved with ``torch.export.save``,
and a numerical smoke check of the reloaded program against the live
model.

The program is traced in float32 with the model in eval mode (its mode is
restored afterwards) and without autograd, on the device of the model's
parameters. The decoder's 3x3 convs enter it as the registered operator
``torch.ops.fsnet_tpu_torch.conv3x3`` (:mod:`fsnet_tpu_torch.ops.conv3x3`),
so the program runs the conv kernel on a CUDA device and the plain version
on the CPU; loading a saved program needs that module imported, which
this module does.

    ep = export_dummy_forward(model, (1, 192, 640, 3), "build/depth.pt2")
    smoke_check("build/depth.pt2", model, (1, 192, 640, 3))

A saved program runs in a process of its own, which knows nothing of the
model, through :func:`run_saved`, or from the command line (the input and
the outputs as ``torch.save`` files; the outputs file also holds the conv
operator's launches and the run's milliseconds):

    python -m fsnet_tpu_torch.runtime.export PROGRAM INPUT OUTPUT \
        [--repeats N]
"""
from __future__ import annotations

import os
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import conv3x3 as _conv3x3  # noqa: F401 - registers the operator


class DummyForward(torch.nn.Module):
    """``model.dummy_forward`` as a module's forward."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model.dummy_forward(image)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_dummy_forward(model: torch.nn.Module, input_shape: Tuple[int, ...],
                         output_path: str):
    """Exports ``model.dummy_forward`` on a float32 NHWC image of
    ``input_shape``; writes the program to ``output_path`` (if non-empty)
    and returns it (``torch.export.ExportedProgram``)."""
    example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                          device=_device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(DummyForward(model), (example,))
    finally:
        model.train(was_training)
    if output_path:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        torch.export.save(program, output_path)
    return program


def conv_ops(program) -> int:
    """How many calls of the registered conv operator ``program``'s graph
    makes."""
    op = torch.ops.fsnet_tpu_torch.conv3x3.default
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and n.target is op)


def smoke_check(path: str, model: torch.nn.Module,
                input_shape: Tuple[int, ...], atol: float = 1e-4) -> Dict:
    """Loads the program saved at ``path``, runs it and the live model's
    ``dummy_forward`` on one seeded image (``RandomState(0)``, uniform in
    [0, 1)) and asserts every output within ``atol``. Returns
    ``max_diff``, the number of ``outputs``, the program's ``conv_ops``,
    the ``image`` and the reloaded program's outputs (``restored``)."""
    program = torch.export.load(path)
    image = torch.from_numpy(np.random.RandomState(0).rand(
        *input_shape).astype(np.float32)).to(_device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            restored = program.module()(image)
            live = model.dummy_forward(image)
    finally:
        model.train(was_training)
    flat_r = [restored[k] for k in sorted(restored)]
    flat_l = [live[k] for k in sorted(live)]
    if sorted(restored) != sorted(live):
        raise AssertionError(f"export outputs {sorted(restored)} against the "
                             f"live model's {sorted(live)}")
    max_diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(flat_r, flat_l))
    assert max_diff < atol, f"export mismatch: {max_diff}"
    return {"max_diff": max_diff, "outputs": len(flat_r),
            "conv_ops": conv_ops(program), "image": image,
            "restored": restored}


def run_saved(path: str, image: torch.Tensor, repeats: int = 1) -> Dict:
    """Loads the program at ``path`` and runs it on ``image`` ``repeats``
    times (without autograd). Returns its ``outputs`` (the last run's),
    ``load_ms``, ``ms`` (each run's wall, the device synchronised on a
    CUDA image) and ``launches``: the conv kernel's launches over the
    first run."""
    cuda = image.device.type == "cuda"
    t0 = time.perf_counter()
    module = torch.export.load(path).module()
    load_ms = (time.perf_counter() - t0) * 1e3
    ms, launches = [], None
    with torch.no_grad():
        for _ in range(max(1, repeats)):
            before = _conv3x3.conv3x3.launches
            t0 = time.perf_counter()
            outputs = module(image)
            if cuda:
                torch.cuda.synchronize(image.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if launches is None:
                launches = _conv3x3.conv3x3.launches - before
    return dict(outputs=outputs, load_ms=load_ms, ms=ms, launches=launches)


def main(argv=None) -> Dict:
    import argparse

    ap = argparse.ArgumentParser(description="Runs a saved dummy_forward "
                                             "program on a saved input.")
    ap.add_argument("program")
    ap.add_argument("input", help="torch.save file of the image tensor")
    ap.add_argument("output", help="torch.save file for the results")
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    res = run_saved(args.program, torch.load(args.input), args.repeats)
    res["outputs"] = {k: v.cpu() for k, v in res["outputs"].items()}
    torch.save(res, args.output)
    print(f"{args.program}: {len(res['outputs'])} outputs, "
          f"{res['launches']} conv3x3 launches, load {res['load_ms']:.1f} "
          f"ms, runs {[round(v, 3) for v in res['ms']]} ms")
    return res


if __name__ == "__main__":
    main()
