from .pino_datasets import (BurgersDataset, DarcyDataset, KFDataset,
                            MultipleReynoldsKFaDataset, get_grid3d)
from .synthetic import (gaussian_rf_2d, generate_kolmogorov_data,
                        ns_vorticity_rollout)
from .channel import (FullFieldNSDataset, PDEDataset, SequentialPDEDataset,
                      batch_arrays, generate_channel_dataset)
from .library import (H5pyDataset, MatReader, PositionalEmbedding2D,
                      RandomMGPatch, TensorDataset, ZarrDataset,
                      append_2d_grid_positional_encoding,
                      grid_positional_encoding, load_burgers,
                      load_darcy_flow, load_navier_stokes,
                      load_spherical_swe)
from .dino_datasets import (SSTDataset, ShallowWaterDataset,
                            generate_mask, generate_navier_stokes_data,
                            generate_shallow_water_data,
                            generate_skipped_lat_lon_mask,
                            generate_wave_data, spherical_xyz_coords)

__all__ = ["FullFieldNSDataset", "PDEDataset", "SequentialPDEDataset",
           "batch_arrays", "generate_channel_dataset", "BurgersDataset",
           "DarcyDataset", "KFDataset", "MultipleReynoldsKFaDataset",
           "get_grid3d", "gaussian_rf_2d", "generate_kolmogorov_data",
           "ns_vorticity_rollout", "H5pyDataset", "MatReader",
           "PositionalEmbedding2D", "RandomMGPatch", "TensorDataset",
           "ZarrDataset", "append_2d_grid_positional_encoding",
           "grid_positional_encoding", "load_burgers", "load_darcy_flow",
           "load_navier_stokes", "load_spherical_swe", "SSTDataset",
           "ShallowWaterDataset", "generate_mask",
           "generate_navier_stokes_data", "generate_shallow_water_data",
           "generate_skipped_lat_lon_mask", "generate_wave_data",
           "spherical_xyz_coords"]
