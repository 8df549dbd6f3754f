"""The process-global nuScenes devkit object (counterpart of
``fsnet_tpu.data.datasets.nuscenes_utils``): building it reads the whole
table set, so it is made once per (dataroot, version) and cached.

The nuscenes-devkit is optional and imported only here, at first use; the
JSON dataset (``NusceneJsonDataset``) needs none.
"""
GLOBAL_DICT = {}


def NuScenes(dataroot, version, *args, **kwargs):
    if (dataroot, version) not in GLOBAL_DICT:
        try:
            from nuscenes.nuscenes import NuScenes as NuSceneObj
        except ImportError as e:
            raise ImportError(
                "nuscenes-devkit is required for raw NuScenes datasets; use "
                "NusceneJsonDataset (precomputed JSON) instead") from e
        GLOBAL_DICT[(dataroot, version)] = NuSceneObj(
            version=version, dataroot=dataroot, *args, **kwargs)
    return GLOBAL_DICT[(dataroot, version)]
