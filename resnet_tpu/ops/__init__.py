from .activation import relu, relu_cap, residual_join
from .batchnorm import (
    batch_moments,
    batch_norm,
    batch_norm_inference,
    bn_act,
    update_running_stats,
)
from .conv import conv2d
from .linear import linear
from .loss import cross_entropy, top1_accuracy, topk_accuracy
from .padding import reference_padding
from .pooling import global_avg_pool, max_pool
from .softmax import log_softmax, softmax

__all__ = [
    "relu",
    "relu_cap",
    "residual_join",
    "batch_moments",
    "batch_norm",
    "batch_norm_inference",
    "bn_act",
    "update_running_stats",
    "conv2d",
    "linear",
    "cross_entropy",
    "top1_accuracy",
    "topk_accuracy",
    "reference_padding",
    "global_avg_pool",
    "max_pool",
    "log_softmax",
    "softmax",
]
