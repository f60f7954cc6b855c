from repro_torch.train.loop import TrainLoop, build_train_step

__all__ = ["build_train_step", "TrainLoop"]
