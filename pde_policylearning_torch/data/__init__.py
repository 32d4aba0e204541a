from .channel import PDEDataset, generate_channel_dataset

__all__ = ["PDEDataset", "generate_channel_dataset"]
