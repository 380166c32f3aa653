"""Result codes and exceptions.

Mirrors the reference's ``epic/error_codes.h``
(/root/reference/libepic/include/epic/error_codes.h:31-46). The numeric values
are kept identical so tools written against the reference's codes translate
directly. Device-specific CUDA codes are retained for API parity but unused:
here, device placement and transfers are managed by XLA and cannot
fail in the granular ways cudaMalloc/cudaMemcpy can.
"""

from __future__ import annotations

import enum


class Result(enum.IntEnum):
    SUCCESS = 0
    SUCCESS_AND_CONVERGED = 1

    ERROR_INVALID_DATA = 2
    ERROR_INVALID_CUDA_PARAM = 3   # unused (XLA manages devices); kept for code parity
    ERROR_DEVICE_MALLOC = 4        # unused
    ERROR_MEMCPY_TO_DEVICE = 5     # unused
    ERROR_MEMCPY_TO_HOST = 6       # unused
    ERROR_DEVICE_FREE = 7          # unused
    ERROR_KERNEL_EXECUTION = 8
    ERROR_DEVICE_SYNCHRONIZE = 9

    ERROR_INVALID_LOCATION = 10
    ERROR_INVALID_CELL_TYPE = 11
    ERROR_INVALID_GRADIENT = 12
    ERROR_INVALID_PATH = 13


class EpicError(Exception):
    """Raised by APIs that prefer exceptions over result codes."""

    def __init__(self, result: Result, message: str = ""):
        self.result = Result(result)
        super().__init__(f"{self.result.name}: {message}" if message else self.result.name)


class InvalidLocationError(EpicError):
    def __init__(self, message: str = ""):
        super().__init__(Result.ERROR_INVALID_LOCATION, message)


class InvalidGradientError(EpicError):
    def __init__(self, message: str = ""):
        super().__init__(Result.ERROR_INVALID_GRADIENT, message)


class InvalidPathError(EpicError):
    """Path has <= 2 points: the field is not relaxed enough yet.

    This is the reference's anytime contract
    (harmonic_path_cpu.cpp:207-212): callers keep relaxing and retry.
    """

    def __init__(self, message: str = ""):
        super().__init__(Result.ERROR_INVALID_PATH, message)
