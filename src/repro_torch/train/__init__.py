from repro_torch.train.loop import build_train_step

__all__ = ["build_train_step"]
