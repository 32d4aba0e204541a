from .pino_datasets import (BurgersDataset, DarcyDataset, KFDataset,
                            MultipleReynoldsKFaDataset, get_grid3d)
from .synthetic import (gaussian_rf_2d, generate_kolmogorov_data,
                        ns_vorticity_rollout)
from .channel import (FullFieldNSDataset, PDEDataset, SequentialPDEDataset,
                      batch_arrays, generate_channel_dataset)

__all__ = ["FullFieldNSDataset", "PDEDataset", "SequentialPDEDataset",
           "batch_arrays", "generate_channel_dataset", "BurgersDataset",
           "DarcyDataset", "KFDataset", "MultipleReynoldsKFaDataset",
           "get_grid3d", "gaussian_rf_2d", "generate_kolmogorov_data",
           "ns_vorticity_rollout"]
