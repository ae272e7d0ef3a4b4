from netsdb_tpu_torch.native.pagestore import (NativePageStore,
                                               native_available)

__all__ = ["NativePageStore", "native_available"]
