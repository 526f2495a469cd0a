"""The native scan loader: a C++ PNG decoder (on zlib) with a threaded,
in-order prefetcher, bound with ctypes (``loader``).  The counterpart of
``navtech_radar_slam_tpu/runtime/``; built at first use, never on import."""

from navtech_radar_slam_torch.runtime.loader import (  # noqa: F401
    NativeRadarLoader,
    build_error,
    decode_png_native,
    native_available,
)
