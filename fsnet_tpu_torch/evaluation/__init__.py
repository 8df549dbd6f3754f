"""The port's evaluators (counterpart of ``fsnet_tpu.evaluation``): the
KITTI raw Eigen, KITTI-360, KITTI-360 fisheye, nuScenes and FusionPortable
evaluators and the supervised 9-metric evaluation."""
from .base_evaluator import BaseEvaluator
from .fusionportable_eval import FusionPortableEvaluator
from .kitti360_fisheye_eval import Kitti360FisheyeEvaluator
from .kitti_supervised_eval import (evaluate_depth,
                                    evaluate_depth_unsupervised_aligned)
from .kitti_unsupervised_eval import Kitti360Evaluator, KittiEigenEvaluator
from .nuscenes_unsupervised_eval import NuscenesEvaluator

__all__ = [
    "BaseEvaluator", "KittiEigenEvaluator", "Kitti360Evaluator",
    "Kitti360FisheyeEvaluator", "NuscenesEvaluator", "FusionPortableEvaluator",
    "evaluate_depth", "evaluate_depth_unsupervised_aligned",
]
