"""The supervised 9-metric depth evaluation and its command line, host
code (counterpart of ``fsnet_tpu.evaluation.kitti_supervised_eval``):
``evaluate_depth`` compares two directories of 16-bit depth PNGs (metres x
``scale``), ``evaluate_depth_unsupervised_aligned`` an object-array
``.npz`` of ground-truth maps against a directory of predicted PNGs; each
returns one ``"mean <metric> : <value>\\n"`` line per metric, in the JAX
package's order and wording. The PNGs are read by the port's reader
(``cv2.imread(path, -1)``, bit for bit).

Usage:
    python -m fsnet_tpu_torch.evaluation.kitti_supervised_eval LABEL RESULT \\
        [--png_dirs]
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from ..data.datasets.image_io import imread_unchanged
from ..ops.metrics import compute_supervised_errors

METRIC_DISPLAY_NAMES = [
    "mae", "rmse", "inverse mae", "inverse rmse", "log mae", "log rmse",
    "scale invariant log", "abs relative", "squared relative",
]
# the display order in ops.metrics' names
_ORDER = ("MAE", "RMSE", "iMAE", "iRMSE", "logMAE", "logRMSE", "SILog",
          "absRel", "sqRel")


def _mean_errors(pairs) -> List[str]:
    error_vectors = []
    for gt, pred in pairs:
        errors = compute_supervised_errors(gt, pred)
        error_vectors.append([errors[k] for k in _ORDER])
    error_vectors = np.array(error_vectors)
    return [f"mean {name} : {np.mean(error_vectors[:, i])}\n"
            for i, name in enumerate(METRIC_DISPLAY_NAMES)]


def evaluate_depth(label_path: str, result_path: str, scale: float = 256.0):
    """Two directories of uint16 depth PNGs, paired in sorted order."""
    gt_list = sorted(os.path.join(label_path, g)
                     for g in os.listdir(label_path) if g.endswith(".png"))
    result_list = sorted(os.path.join(result_path, r)
                         for r in os.listdir(result_path) if r.endswith(".png"))
    if len(gt_list) != len(result_list):
        print(f"Notice: gt count {len(gt_list)} != result count "
              f"{len(result_list)}")
    print(f"found {len(gt_list)} images in {label_path} and {result_path}")
    pairs = ((imread_unchanged(g) / scale, imread_unchanged(r) / scale)
             for g, r in zip(gt_list, result_list))
    return _mean_errors(pairs)


def evaluate_depth_unsupervised_aligned(label_path: str, result_path: str,
                                        scale: float = 256.0):
    """An ``.npz`` of ground-truth maps against a directory of PNGs."""
    gt_depths = np.load(label_path, fix_imports=True, encoding="latin1",
                        allow_pickle=True)["data"]
    result_list = sorted(os.path.join(result_path, r)
                         for r in os.listdir(result_path) if r.endswith(".png"))
    if len(gt_depths) != len(result_list):
        print(f"Notice: gt count {len(gt_depths)} != result count "
              f"{len(result_list)}")
    pairs = ((gt_depths[i], imread_unchanged(result_list[i]) / scale)
             for i in range(min(len(gt_depths), len(result_list))))
    return _mean_errors(pairs)


def main(argv=None) -> List[str]:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("label_path")
    parser.add_argument("result_path")
    parser.add_argument("--png_dirs", action="store_true",
                        help="compare two PNG dirs instead of npz-vs-PNG")
    args = parser.parse_args(argv)
    fn = evaluate_depth if args.png_dirs else evaluate_depth_unsupervised_aligned
    lines = fn(args.label_path, args.result_path)
    for text in lines:
        print(text, end="")
    return lines


if __name__ == "__main__":
    main()
