from repro_torch.data.pipeline import (SyntheticCIFAR, SyntheticText,
                                       batch_for, make_pipeline)

__all__ = ["SyntheticText", "SyntheticCIFAR", "batch_for", "make_pipeline"]
