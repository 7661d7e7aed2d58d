from repro_torch.optim.adamw import AdamW, warmup_cosine

__all__ = ["AdamW", "warmup_cosine"]
