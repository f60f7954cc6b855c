from repro_torch.kernels.rglru_scan.ops import (rglru_scan, scan,
                                                scan_backward)

__all__ = ["rglru_scan", "scan", "scan_backward"]
