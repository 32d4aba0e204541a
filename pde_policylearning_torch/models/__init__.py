from .dispatcher import (MODEL_ZOO, available_models, dispatch_model,
                         get_model, register_model)
from .deeponet import DeepONetCartesianProd
from .fno import (FNO, FNO1d, FNO2d, FNO3d, TFNO, TFNO1d, TFNO2d, TFNO3d,
                  FNOBlocks)
from .graph import GAT, GCN, GraphAttention, GraphConvolution
from .mfn import FourierNet, MFNFourierLayer, MultiplicativeNet
from .observers import (DoubleConv, FNO2dObserver, RNO2dObserver, UNet,
                        make_grid)
from .pino import (DenseNet, LowRank2d, PINObserver2d, PINObserverFullField,
                   PINOTrunk, PlanePredHead, PolicyModel2D, SpectralConvND,
                   get_act)
from .rno import (RNO2d, FourierLayer2d, RNOCell, RNOLayer,
                  RNOSpectralConv2d, SpectralConvWithFC, SpectralRegressor)
from .sfno import SFNO, SphericalConv
from .spectral_layers import SpectralConv
from .transformer import (BulkRegressor, Conv2dResBlock, DownScaler,
                          FeedForward, FourierTransformer2D,
                          FourierTransformer2DLite, SimpleAttention,
                          SimpleTransformer, SimpleTransformerEncoderLayer,
                          SpectralConv1dToken, UpScaler, attention,
                          causal_linear_attention, freq_attention,
                          linear_attention, positional_encoding)
from .uno import UNO

__all__ = ["FNO", "FNO1d", "FNO2d", "FNO3d", "TFNO", "TFNO1d", "TFNO2d",
           "TFNO3d", "FNOBlocks", "FNO2dObserver", "RNO2dObserver", "UNet",
           "DoubleConv", "make_grid", "SpectralConv", "FourierNet",
           "MFNFourierLayer", "MultiplicativeNet", "DenseNet", "LowRank2d",
           "PINObserver2d", "PINObserverFullField", "PINOTrunk",
           "PlanePredHead", "PolicyModel2D", "SpectralConvND", "get_act",
           "RNO2d", "FourierLayer2d", "RNOCell", "RNOLayer", "RNOSpectralConv2d",
           "SpectralConvWithFC", "SpectralRegressor", "BulkRegressor",
           "Conv2dResBlock", "DownScaler", "FeedForward",
           "FourierTransformer2D", "FourierTransformer2DLite",
           "SimpleAttention", "SimpleTransformer",
           "SimpleTransformerEncoderLayer", "SpectralConv1dToken", "UpScaler",
           "attention", "causal_linear_attention", "freq_attention",
           "linear_attention", "positional_encoding", "MODEL_ZOO",
           "available_models", "dispatch_model", "get_model",
           "register_model", "UNO", "GCN", "GAT", "GraphAttention",
           "GraphConvolution", "SFNO", "SphericalConv",
           "DeepONetCartesianProd"]
