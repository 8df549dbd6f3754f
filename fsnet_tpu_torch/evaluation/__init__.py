"""The port's evaluators (counterpart of ``fsnet_tpu.evaluation``): the
KITTI raw Eigen and KITTI-360 evaluators. The fisheye, nuScenes,
FusionPortable and supervised evaluators are not ported yet."""
from .base_evaluator import BaseEvaluator
from .kitti_unsupervised_eval import Kitti360Evaluator, KittiEigenEvaluator

__all__ = ["BaseEvaluator", "KittiEigenEvaluator", "Kitti360Evaluator"]
