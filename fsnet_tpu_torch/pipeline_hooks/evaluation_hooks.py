"""Dataset evaluation hooks (counterpart of
``fsnet_tpu.pipeline_hooks.evaluation_hooks``).

:class:`KittiEvaluationHook` runs one evaluation pass: a loader over the
validation dataset (:class:`~fsnet_tpu_torch.data.dataloader.Dataloader`
on an :class:`~fsnet_tpu_torch.data.dataloader.InferenceSampler`, its
workers stopped at the pass's end), the validation hook's forward on the
model's device, per frame the unpad by ``image_resize/effective_size``, the
inverse-space resize ``1 / resize(1 / depth)`` to the original image's
size (it keeps near structure), the evaluator's ``single_call``, then the
means of both error suites and the evaluator's log. The hook takes the
model where the JAX hook takes the train state.
:class:`FastNuscEvaluationHook` is the nuScenes pass: batches of 16, the
depth resized linearly (not in inverse space) to the original image's
size, the evaluator's ``single_call`` on each frame's file name, the errors
grouped by ``camera_type``, each camera's means logged, then their mean.
:class:`BaseEvaluationHook` is the generic pass, one sample at a time.
:class:`KittiEvaluationHook_postopt` and
:class:`PostOptFastNuscEvaluationHook` refine each frame's unpadded depth
with the batch's sparse VO depth (``vo_depth/0``) before the resize:
SLIC superpixels and a per-segment log-scale solve
(:func:`~fsnet_tpu_torch.ops.postopt.post_optimization`) on the hook's
device, with the JAX hooks' defaults and ``post_opt_cfg``'s overrides.
The VO map must have the unpadded depth's size (no dataset resizes it):
a mismatch raises. Where the JAX KITTI hook swallows any error of the
refine, these catch only the refine's own
(:class:`~fsnet_tpu_torch.ops.postopt.PostOptError`, a singular solve),
evaluate that frame unrefined and count it: after a call ``post_opt``
holds the frames refined, those left unrefined and the refine's seconds.
"""
from __future__ import annotations

import time
import warnings
from contextlib import closing
from typing import Dict, Optional

import numpy as np
import torch

from ..data.augmentations import resize_linear
from ..data.dataloader import Dataloader, InferenceSampler
from ..data.datasets.dataset_utils import collate_fn
from ..ops.postopt import (PostOptError, denorm,
                           depth_image_to_point_cloud_array,
                           post_optimization)
from ..utils.builder import build
from ..utils.device import DeviceLike, resolve_device
from ..utils.keys import encode_batch


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _predicted_frames(hook, model, dataset_val, global_step, epoch_num):
    """One pass of ``hook``'s validation forward over ``dataset_val`` in
    batches of ``hook.batch_size``: per frame (the batch, its index in the
    batch, the float32 depth unpadded by ``image_resize/effective_size``,
    and the original image's (width, height)); the loader's workers are
    stopped when the generator ends or is closed."""
    loader = Dataloader(dataset_val, batch_size=hook.batch_size,
                        sampler=InferenceSampler(len(dataset_val)),
                        collate=collate_fn, num_workers=hook.num_workers,
                        drop_last=False,
                        pin_memory=hook.device.type == "cuda")
    try:
        for batched_data in loader:
            output_dict = hook.test_hook(batched_data, model, global_step,
                                         epoch_num)
            depth_batch = _host(output_dict["depth"].float())[..., 0]
            eff = batched_data.get("image_resize/effective_size")
            originals = batched_data["original_image/0"]
            for i in range(depth_batch.shape[0]):
                depth = depth_batch[i]
                if eff is not None:
                    h_eff, w_eff = (int(v) for v in _host(eff[i])[:2])
                    depth = depth[0:h_eff, 0:w_eff]
                h, w = originals[i].shape[:2]
                yield batched_data, i, depth, (w, h)
    finally:
        loader.close()


class KittiEvaluationHook:
    """One evaluation pass over a validation dataset with a KITTI-style
    evaluator (``dataset_eval_cfg``) on ``device``. ``preprocessed_path``,
    which the configs pass, is not read (the JAX hook does not read it
    either)."""

    def __init__(self, test_run_hook_cfg: Dict,
                 dataset_eval_cfg: Optional[Dict] = None,
                 preprocessed_path: str = "", batch_size: int = 1,
                 num_workers: int = 4, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.test_hook = build(**dict(test_run_hook_cfg), device=self.device)
        self.dataset_eval_func = (None if dataset_eval_cfg is None
                                  else build(**dict(dataset_eval_cfg)))
        self.batch_size = batch_size
        self.num_workers = num_workers

    def _refine(self, batched_data, i: int, depth: np.ndarray) -> np.ndarray:
        return depth

    def __call__(self, model, dataset_val, writer=None, global_step: int = 0,
                 epoch_num: int = 0):
        """Returns the mean median-scaled and absolute errors, each [7]."""
        errors, abs_errors = [], []
        with closing(_predicted_frames(self, model, dataset_val, global_step,
                                       epoch_num)) as frames:
            for frame_index, (batch, i, depth, size) in enumerate(frames):
                depth = self._refine(batch, i, depth)
                depth_0 = 1.0 / resize_linear(1.0 / depth, *size)
                result = self.dataset_eval_func.single_call(depth_0,
                                                            frame_index)
                errors.append(result["error"])
                abs_errors.append(result["abs_error"])

        mean_errors = np.array(errors).mean(0)
        mean_abs_errors = np.array(abs_errors).mean(0)
        self.dataset_eval_func.log(writer, mean_errors, mean_abs_errors,
                                   global_step=global_step,
                                   epoch_num=epoch_num)
        return mean_errors, mean_abs_errors


class FastNuscEvaluationHook:
    """One evaluation pass over a nuScenes validation dataset with
    ``NuscenesEvaluator`` on ``device``, the errors grouped by camera.
    After a call, ``channel_means`` maps each camera to its two mean error
    suites."""

    def __init__(self, test_run_hook_cfg: Dict,
                 dataset_eval_cfg: Optional[Dict] = None,
                 batch_size: int = 16, num_workers: int = 4,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.test_hook = build(**dict(test_run_hook_cfg), device=self.device)
        self.dataset_eval_func = (None if dataset_eval_cfg is None
                                  else build(**dict(dataset_eval_cfg)))
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.channel_means: Dict = {}

    def _refine(self, batched_data, i: int, depth: np.ndarray) -> np.ndarray:
        return depth

    def __call__(self, model, dataset_val, writer=None, global_step: int = 0,
                 epoch_num: int = 0):
        """Returns the mean over the cameras of each camera's mean
        median-scaled and absolute errors, each [7]."""
        errors: Dict = {}
        abs_errors: Dict = {}
        with closing(_predicted_frames(self, model, dataset_val, global_step,
                                       epoch_num)) as frames:
            for batched_data, i, depth, size in frames:
                depth = self._refine(batched_data, i, depth)
                depth_0 = resize_linear(depth, *size)
                camera_type = batched_data["camera_type"][i]
                errors.setdefault(camera_type, [])
                abs_errors.setdefault(camera_type, [])
                filename = batched_data["filename/0"][i]
                try:
                    result = self.dataset_eval_func.single_call(depth_0,
                                                                filename)
                except ValueError:
                    warnings.warn(f"sample {filename} has no usable points")
                    continue
                errors[camera_type].append(result["error"])
                abs_errors[camera_type].append(result["abs_error"])

        self.channel_means = {}
        for cam in errors:
            mean_errors = np.array(errors[cam]).mean(0)
            mean_abs = np.array(abs_errors[cam]).mean(0)
            self.dataset_eval_func.log(writer, cam, mean_errors, mean_abs,
                                       global_step=global_step,
                                       epoch_num=epoch_num)
            self.channel_means[cam] = (mean_errors, mean_abs)
        all_mean = np.array([m for m, _ in self.channel_means.values()]
                            ).mean(0)
        all_mean_abs = np.array([a for _, a in self.channel_means.values()]
                                ).mean(0)
        self.dataset_eval_func.log(writer, "all mean", all_mean,
                                   all_mean_abs, global_step=global_step,
                                   epoch_num=epoch_num)
        return all_mean, all_mean_abs


# the JAX hooks' refine parameters; ``post_opt_cfg`` overrides any of them
POST_OPT_DEFAULTS = dict(lab_dist_weight=1, depth_dist_weight=1,
                         image_dist_weight=1, h_seg=10, w_seg=18, iter_num=3,
                         lambda0=0.54 / (10 * 18), lambda1=1.0, lambda2=0.4)
_RGB_MEAN = (0.485, 0.456, 0.406)
_RGB_STD = (0.229, 0.224, 0.225)


class _PostOpt:
    """The VO refine of a frame's unpadded float32 depth, for the hooks
    below: ``post_opt_cfg`` (keyword) overrides :data:`POST_OPT_DEFAULTS`;
    keys it does not name (``vo_path``) are not read."""

    def __init__(self, *args, post_opt_cfg: Optional[Dict] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.post_opt_cfg = post_opt_cfg
        self._start()

    def __call__(self, *args, **kwargs):
        self._start()
        return super().__call__(*args, **kwargs)

    def _params(self) -> Dict:
        params = dict(POST_OPT_DEFAULTS)
        params.update({k: v for k, v in (self.post_opt_cfg or {}).items()
                       if k in params})
        return params

    def _start(self) -> None:
        self.post_opt = dict(refined=0, unrefined=0, seconds=0.0)

    def _refine(self, batched_data, i: int, depth: np.ndarray) -> np.ndarray:
        vo = batched_data.get("vo_depth/0")
        if vo is None:
            return depth
        t0 = time.perf_counter()
        dev = self.device
        vo = torch.as_tensor(_host(vo[i]), dtype=torch.float32, device=dev)
        if tuple(vo.shape) != depth.shape:
            raise ValueError(
                f"vo_depth {tuple(vo.shape)} differs from the unpadded "
                f"depth {depth.shape}: the VO map must come at the "
                "evaluation's unpadded input size (no dataset resizes it)")
        h, w = depth.shape
        image = torch.as_tensor(_host(batched_data["image/0"][i]),
                                device=dev)[:h, :w]
        rgb = denorm(image, _RGB_MEAN, _RGB_STD).to(torch.float32) / 255.0
        d = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        try:
            refined = post_optimization(
                rgb, depth_image_to_point_cloud_array(d), d, vo,
                **self._params()).cpu().numpy()
            self.post_opt["refined"] += 1
        except (PostOptError, torch.linalg.LinAlgError) as e:
            warnings.warn(f"post-optimisation left a frame unrefined: {e}")
            refined = depth
            self.post_opt["unrefined"] += 1
        self.post_opt["seconds"] += time.perf_counter() - t0
        return refined


class KittiEvaluationHook_postopt(_PostOpt, KittiEvaluationHook):
    """:class:`KittiEvaluationHook` with each frame's depth refined by its
    VO depth before the inverse-space resize."""


class PostOptFastNuscEvaluationHook(_PostOpt, FastNuscEvaluationHook):
    """:class:`FastNuscEvaluationHook` with each frame's depth refined by
    its VO depth before the resize."""


class BaseEvaluationHook:
    """The generic pass: the validation hook on each sample in turn, its
    output handed to ``result_write_cfg``'s writer, then the evaluator over
    the written results."""

    def __init__(self, test_run_hook_cfg: Dict,
                 result_write_cfg: Optional[Dict] = None,
                 dataset_eval_cfg: Optional[Dict] = None,
                 device: DeviceLike = "cuda"):
        self.test_hook = build(**dict(test_run_hook_cfg), device=device)
        self.result_processor = (None if result_write_cfg is None
                                 else build(**dict(result_write_cfg)))
        self.dataset_eval_func = (None if dataset_eval_cfg is None
                                  else build(**dict(dataset_eval_cfg)))

    def __call__(self, model, dataset_val, writer=None, global_step: int = 0,
                 epoch_num: int = 0):
        for index in range(len(dataset_val)):
            batch = encode_batch(collate_fn([dataset_val[index]]))
            output = self.test_hook(batch, model, global_step, epoch_num)
            if self.result_processor is not None:
                self.result_processor(output, batch, index)
        if (self.dataset_eval_func is not None
                and self.result_processor is not None):
            self.dataset_eval_func(self.result_processor.result_path, writer,
                                   global_step, epoch_num)
