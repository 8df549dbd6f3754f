from . import blocks
from .backbones.resnet import ResNet, resnet
from .heads.depth_decoder import DepthDecoder, MultiChannelDepthDecoder
from .heads.monodepth2_decoder import MonoDepth2Decoder
from .meta_archs.base_meta import BaseMetaArch
from .meta_archs.monodepth2_model import MonoDepthInference, MonoDepthWPose

__all__ = [
    "blocks", "ResNet", "resnet", "DepthDecoder", "MultiChannelDepthDecoder",
    "MonoDepth2Decoder", "BaseMetaArch", "MonoDepthInference",
    "MonoDepthWPose",
]
