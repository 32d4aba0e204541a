from .fno import (FNO, FNO1d, FNO2d, FNO3d, TFNO, TFNO1d, TFNO2d, TFNO3d,
                  FNOBlocks)
from .observers import FNO2dObserver, make_grid
from .spectral_layers import SpectralConv

__all__ = ["FNO", "FNO1d", "FNO2d", "FNO3d", "TFNO", "TFNO1d", "TFNO2d",
           "TFNO3d", "FNOBlocks", "FNO2dObserver", "make_grid",
           "SpectralConv"]
