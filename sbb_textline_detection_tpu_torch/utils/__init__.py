def host_library_available() -> bool:
    """True when the C++ host geometry library (native/, built by
    `make -C native` or `pip install .`) is loaded. Without it contours, the
    line split and the profile smoothing run in their bit-exact but much
    slower numpy versions."""
    from sbb_textline_detection_tpu_torch import native_bridge

    return native_bridge.available()
