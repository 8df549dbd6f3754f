"""The port's evaluators (counterpart of ``fsnet_tpu.evaluation``): the
KITTI raw Eigen, KITTI-360 and nuScenes evaluators. The fisheye,
FusionPortable and supervised evaluators are not ported yet."""
from .base_evaluator import BaseEvaluator
from .kitti_unsupervised_eval import Kitti360Evaluator, KittiEigenEvaluator
from .nuscenes_unsupervised_eval import NuscenesEvaluator

__all__ = ["BaseEvaluator", "KittiEigenEvaluator", "Kitti360Evaluator",
           "NuscenesEvaluator"]
