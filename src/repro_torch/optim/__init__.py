from repro_torch.optim.adamw import AdamW, OptState, clip_by_global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "OptState", "clip_by_global_norm", "warmup_cosine", "constant"]
