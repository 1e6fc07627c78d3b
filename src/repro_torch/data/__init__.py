from repro_torch.data.pipeline import DataConfig, PrefetchLoader, TokenDataset

__all__ = ["DataConfig", "PrefetchLoader", "TokenDataset"]
