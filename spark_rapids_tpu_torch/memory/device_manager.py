"""Device acquisition, the device memory budget and the translation of
device errors (port of spark_rapids_tpu/memory/device_manager.py).

The budget is the card's memory (`torch.cuda.mem_get_info`'s total, or
`hbm.sizeOverride`) times `hbm.allocFraction` (reference `_do_init`
:77-95, `_detect_hbm` :213). Bytes in use are PyTorch's live tensor bytes,
`torch.cuda.memory_allocated`: the caching allocator keeps freed blocks
reserved, and a reserved block is free for the next tensor, so the budget
never reads `memory_reserved`. On the CPU (`device="cpu"`, the tests)
there is no allocator to read: bytes in use are 0 and the total is the
override or the reference's 16 GiB default.

`translate_device_error` maps an error into the retry hierarchy
(reference :125): a CUDA out-of-memory (`torch.cuda.OutOfMemoryError`, a CUDA
"out of memory" RuntimeError, a kernel entry point's
cudaErrorMemoryAllocation through cuda_build.check) is a TpuRetryOOM; the
reference's own message forms (RESOURCE_EXHAUSTED, ABORTED, device lost)
classify as in the reference, so injected faults class the same in both
packages. A sticky CUDA error (illegal address, launch failure, ...)
leaves the context dead: it is never transient and never retried.
"""

from __future__ import annotations

import logging

import torch

from spark_rapids_tpu_torch import conf as C

log = logging.getLogger(__name__)

_DEFAULT_HBM_BYTES = 16 << 30


class TpuDeviceManager:
    """A session's device and budget (reference: GpuDeviceManager), sized
    from that session's conf."""

    def __init__(self, tpu_conf: "C.TpuConf", device=None):
        self.conf = tpu_conf
        self.device = torch.device(device) if device is not None else None
        self.hbm_total = 0
        self.hbm_budget = 0
        self._do_init()

    def _do_init(self) -> None:
        if self.device is None:
            self.device = torch.device("cuda", 0) \
                if torch.cuda.is_available() else torch.device("cpu")
        override = self.conf.get(C.HBM_SIZE_OVERRIDE)
        self.hbm_total = override or self._detect_hbm(self.device)
        self.hbm_budget = int(self.hbm_total *
                              self.conf.get(C.MEMORY_FRACTION))
        log.info("TpuDeviceManager: device=%s total=%d budget=%d",
                 self.device, self.hbm_total, self.hbm_budget)

    @staticmethod
    def _detect_hbm(device) -> int:
        if device.type == "cuda":
            return int(torch.cuda.mem_get_info(device)[1])
        return _DEFAULT_HBM_BYTES

    # -- accounting ----------------------------------------------------------
    def bytes_in_use(self) -> int:
        """Live tensor bytes on the card (0 on the CPU)."""
        if self.device.type == "cuda":
            return int(torch.cuda.memory_allocated(self.device))
        return 0

    # -- error translation ---------------------------------------------------
    _OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                    "Out of memory", "out of memory", "OOM",
                    "Attempting to allocate")
    _TRANSIENT_MARKERS = ("ABORTED", "UNAVAILABLE", "DEADLINE_EXCEEDED",
                          "DATA_LOSS", "device disconnected",
                          "premature end of stream")
    _DEVICE_LOSS_MARKERS = ("device lost", "Device lost", "DEVICE_RESET",
                            "backend restarted", "backend restart",
                            "peer is unreachable", "ICI peer loss",
                            "device has been reset",
                            "hardware failure")
    # the reference's backend error types, matched by name
    _DEVICE_ERROR_TYPES = ("XlaRuntimeError", "JaxRuntimeError",
                           "InternalError", "PjRtError")
    # CUDA errors that leave the context unusable: nothing retries them
    _STICKY_CUDA_MARKERS = ("illegal memory access", "illegal address",
                            "unspecified launch failure",
                            "misaligned address", "illegal instruction",
                            "device-side assert", "hardware stack error",
                            "invalid program counter", "ECC error",
                            "uncorrectable")
    # a kernel entry point's cudaErrorMemoryAllocation (cuda_build.check)
    _CUDA_OOM_MARKERS = ("CUDA out of memory", "CUDA error 2:",
                         "cudaErrorMemoryAllocation", "out of memory")

    @classmethod
    def translate_device_error(cls, e: BaseException):
        """The retry hierarchy's view of a device error, or None."""
        from spark_rapids_tpu_torch.engine.retry import (
            TpuDeviceLostError,
            TpuRetryOOM,
            TpuTransientDeviceError,
        )

        if isinstance(e, (TpuRetryOOM, TpuTransientDeviceError)):
            return e
        tname = type(e).__name__
        msg = str(e)
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return TpuRetryOOM(f"device OOM ({tname}): {msg}")
        if tname in cls._DEVICE_ERROR_TYPES:
            if any(m in msg for m in cls._OOM_MARKERS):
                return TpuRetryOOM(f"device OOM ({tname}): {msg}")
            if any(m in msg for m in cls._DEVICE_LOSS_MARKERS):
                return TpuDeviceLostError(f"device lost ({tname}): {msg}")
            if any(m in msg for m in cls._TRANSIENT_MARKERS):
                return TpuTransientDeviceError(
                    f"transient device error ({tname}): {msg}")
            return None
        if isinstance(e, RuntimeError) and "CUDA" in msg:
            if any(m in msg for m in cls._STICKY_CUDA_MARKERS):
                return None
            if any(m in msg for m in cls._CUDA_OOM_MARKERS):
                return TpuRetryOOM(f"device OOM ({tname}): {msg}")
        return None
