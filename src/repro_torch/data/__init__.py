from repro_torch.data.pipeline import SyntheticText

__all__ = ["SyntheticText"]
