from repro_torch.data.pipeline import HostDataLoader, SyntheticTokenDataset, pack_documents

__all__ = ["SyntheticTokenDataset", "HostDataLoader", "pack_documents"]
