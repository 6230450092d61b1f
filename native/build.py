"""Build the native host-runtime shared library.

Usage: python native/build.py  (or let utils._native build lazily).
Produces oclcomputervision_jax/utils/_libocv_native.so.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "ocv_native.cpp")
OUT = os.path.join(
    os.path.dirname(HERE), "oclcomputervision_jax", "utils", "_libocv_native.so"
)


def build(verbose: bool = True) -> str:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-fno-exceptions",
        SRC,
        "-o",
        OUT,
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    sys.exit(0 if os.path.isfile(build()) else 1)
