from repro_torch.kernels.bucket_pack.ops import (bucket_pack, bucket_unpack,
                                                 pack_ragged, unpack_columns)

__all__ = ["bucket_pack", "bucket_unpack", "pack_ragged", "unpack_columns"]
