from .pipeline import SyntheticLMDataset, TensorChunkLoader, device_put_batch
