from . import blocks
from .backbones.dla import DLA, dlanet
from .backbones.resnet import ResNet, resnet
from .heads.depth_decoder import (DepthDecoder, MultiChannelDepthDecoder,
                                  MultiChannelDepthDecoderUncertain)
from .heads.fisheye_decoder import FishEyeDecoder
from .heads.monodepth2_decoder import MonoDepth2Decoder
from .heads.pose_decoder import PoseDecoder
from .meta_archs.base_meta import BaseMetaArch
from .meta_archs.monodepth2_model import (DistillWPoseMeta,
                                          MonoDepthInference, MonoDepthMeta,
                                          MonoDepthWPose)

__all__ = [
    "blocks", "DLA", "dlanet", "ResNet", "resnet", "DepthDecoder", "MultiChannelDepthDecoder",
    "MultiChannelDepthDecoderUncertain", "FishEyeDecoder", "MonoDepth2Decoder", "PoseDecoder", "BaseMetaArch",
    "DistillWPoseMeta", "MonoDepthInference", "MonoDepthMeta", "MonoDepthWPose",
]
