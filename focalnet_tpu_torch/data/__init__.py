"""Image I/O for the port: the native C++ loader (:mod:`.native_loader`), its
plain PNG codec (:mod:`.png`) and the RESIDE pair loaders (:mod:`.reside`)."""

from focalnet_tpu_torch.data.png import decode_png, encode_png, read_png, write_png

__all__ = ["decode_png", "encode_png", "read_png", "write_png"]
