from .attention import (
    CBAM,
    ChannelAttention,
    CrossViewAttention,
    MultiViewAttention,
    SpatialAttention,
)
from .code import PositionalEncoding
from .custom_encoder import ConvEncoder
from .encoder import GlobalEncoder, SpatialEncoder
from .fusion import (
    AdaptiveFeatureSampler,
    MultiScaleFusionModule,
    SmartFeatureFusion,
    create_feature_fusion,
)
from .mlp import ImplicitNet
from .pixelnerf import EncodedScene, PixelNeRFNet, make_model
from .resnetfc import ResnetBlockFC, ResnetFC

__all__ = [
    "PositionalEncoding",
    "SpatialEncoder",
    "GlobalEncoder",
    "ConvEncoder",
    "ImplicitNet",
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
