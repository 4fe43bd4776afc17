"""Layers, functionals and control flow (counterpart:
``paddle_tpu/nn``)."""
from . import functional, initializer  # noqa: F401
from .control_flow import (array_length, array_read,  # noqa: F401
                           array_write, case, cond, create_array,
                           switch_case, while_loop)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer.activation import (ELU, GELU, SELU, Hardshrink,  # noqa: F401
                               Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
                               LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                               ReLU, ReLU6, Sigmoid, Silu, Softmax, Softplus,
                               Softshrink, Softsign, Swish, Tanh, Tanhshrink,
                               ThresholdedReLU)
from .layer.common import (Bilinear, CosineSimilarity, Dropout,  # noqa: F401
                           Dropout2D, Embedding, Flatten, Identity, Linear,
                           Pad1D, Pad2D, PixelShuffle, Upsample)
from .layer.container import (LayerDict, LayerList,  # noqa: F401
                              ParameterList, Sequential)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                         Conv2DTranspose, Conv3D)
from .layer.extras import (RNN, AlphaDropout, BiRNN, CosineEmbeddingLoss,  # noqa: F401
                           CTCLoss, SpectralNorm, TripletMarginLoss, Unfold,
                           UpsamplingBilinear2D, UpsamplingNearest2D)
from .layer.layers import Layer, ParamAttr  # noqa: F401
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CrossEntropyLoss, KLDivLoss, L1Loss,
                         MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, GroupNorm, InstanceNorm1D,
                         InstanceNorm2D, InstanceNorm3D, LayerNorm,
                         LocalResponseNorm, RMSNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                            AdaptiveMaxPool2D, AvgPool1D, AvgPool2D,
                            AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .layer.rnn import (GRU, LSTM, BeamSearchDecoder, GRUCell,  # noqa: F401
                        LSTMCell, RNNCellBase, SimpleRNN, SimpleRNNCell,
                        dynamic_decode)
from .layer.transformer import (MultiHeadAttention,  # noqa: F401
                                Transformer, TransformerDecoder,
                                TransformerDecoderLayer, TransformerEncoder,
                                TransformerEncoderLayer)

__all__ = [
    "Layer", "ParamAttr", "Linear", "Embedding", "Dropout", "Dropout2D",
    "Flatten", "Identity", "Upsample", "Pad1D", "Pad2D", "CosineSimilarity",
    "Bilinear", "PixelShuffle", "Conv1D", "Conv2D", "Conv3D",
    "Conv1DTranspose", "Conv2DTranspose", "SyncBatchNorm", "BatchNorm",
    "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "LayerNorm", "RMSNorm",
    "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
    "LocalResponseNorm", "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveMaxPool2D", "Sequential", "LayerList", "LayerDict",
    "ParameterList", "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss",
    "BCELoss", "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
    "MarginRankingLoss", "ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "Silu",
    "Swish", "Mish", "LeakyReLU", "ELU", "SELU", "Hardtanh", "Hardsigmoid",
    "Hardswish", "Softplus", "Softshrink", "Hardshrink", "Tanhshrink",
    "Softsign", "LogSigmoid", "Softmax", "LogSoftmax", "PReLU", "Maxout",
    "ThresholdedReLU", "MultiHeadAttention", "TransformerEncoderLayer",
    "TransformerEncoder", "TransformerDecoderLayer", "TransformerDecoder",
    "Transformer", "SimpleRNN", "LSTM", "GRU", "RNNCellBase", "LSTMCell",
    "GRUCell", "SimpleRNNCell", "BeamSearchDecoder", "dynamic_decode",
    "RNN", "BiRNN", "SpectralNorm", "Unfold", "AlphaDropout",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "CTCLoss",
    "CosineEmbeddingLoss", "TripletMarginLoss", "ClipGradByValue",
    "ClipGradByNorm", "ClipGradByGlobalNorm", "functional", "initializer",
    "cond", "case", "switch_case", "while_loop", "create_array",
    "array_write", "array_read", "array_length"]
