from repro_torch.checkpoint.ckpt import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
