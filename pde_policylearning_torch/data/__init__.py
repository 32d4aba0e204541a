from .channel import generate_channel_dataset

__all__ = ["generate_channel_dataset"]
