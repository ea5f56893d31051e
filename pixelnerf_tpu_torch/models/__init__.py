from .attention import (
    CBAM,
    ChannelAttention,
    CrossViewAttention,
    MultiViewAttention,
    SpatialAttention,
)
from .code import PositionalEncoding
from .encoder import SpatialEncoder
from .fusion import (
    AdaptiveFeatureSampler,
    MultiScaleFusionModule,
    SmartFeatureFusion,
    create_feature_fusion,
)
from .pixelnerf import EncodedScene, PixelNeRFNet, make_model
from .resnetfc import ResnetBlockFC, ResnetFC

__all__ = [
    "PositionalEncoding",
    "SpatialEncoder",
    "EncodedScene",
    "PixelNeRFNet",
    "make_model",
    "ResnetBlockFC",
    "ResnetFC",
    "CBAM",
    "ChannelAttention",
    "CrossViewAttention",
    "MultiViewAttention",
    "SpatialAttention",
    "AdaptiveFeatureSampler",
    "MultiScaleFusionModule",
    "SmartFeatureFusion",
    "create_feature_fusion",
]
