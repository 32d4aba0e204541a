from .channel import (FullFieldNSDataset, PDEDataset, SequentialPDEDataset,
                      batch_arrays, generate_channel_dataset)

__all__ = ["FullFieldNSDataset", "PDEDataset", "SequentialPDEDataset",
           "batch_arrays", "generate_channel_dataset"]
