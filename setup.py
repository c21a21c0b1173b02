"""Build shim: compiles the native geometry library (native/sbb_native.cpp)
into the package so wheel installs ship it; metadata lives in
pyproject.toml. The library is optional at runtime — every caller keeps a
numpy fallback (see sbb_textline_detection_tpu/native_bridge.py and the
PyTorch port's copy of it, which loads its own copy of the library)."""

import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        native = os.path.join(here, "native")
        try:
            subprocess.run(["make", "-C", native], check=True)
            for pkg in ("sbb_textline_detection_tpu",
                        "sbb_textline_detection_tpu_torch"):
                self.copy_file(os.path.join(native, "libsbbnative.so"),
                               os.path.join(here, pkg, "libsbbnative.so"))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"warning: native library build skipped ({e}); "
                  "the package falls back to pure numpy geometry")
        super().run()


setup(cmdclass={"build_py": BuildWithNative})
