"""Device and dtype choice, precision pins, host-sync accounting.

* ``resolve_device``: the solver's device.  ``"cuda"`` is the default and
  a missing GPU raises; nothing falls back to the CPU silently.  The CPU
  is taken only when asked for by name (tests, ``--device cpu``).
* TF32 is switched off for matmuls and cuDNN at import, mirroring
  ``precision="highest"`` in lorads_tpu/__init__.py:32-35: every dot of
  the solver is DIMACS-critical.  ``assert_full_precision`` checks it.
* ``host_read``: every device-to-host scalar read of the solver's loop
  control goes through here and is counted (``HOST_SYNCS``, and per
  label in ``HOST_SYNCS_BY``), so a run can report how often the host
  waited on the device, and in which loop.  A read while the current
  stream is being captured into a CUDA graph raises.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# device -> host reads made by the solver's control flow (see host_read)
HOST_SYNCS = 0
# the loops a read is made for: the ALM phase's runs (on the CPU also its
# outer, middle and rho steps), the ALM inner loop's steps (read on the
# CPU alone), CG's iterations, the mixed-precision CG's refinement
# passes, the ADMM iterations, the Lanczos restarts, the dual repairs
# (spectral and CGNR), the rest
LABELS = ("alm", "alm_inner", "cg", "cg_ir", "admm", "lanczos", "repair",
          "other")
HOST_SYNCS_BY = dict.fromkeys(LABELS, 0)


def assert_full_precision() -> None:
    """Raise if anything re-enabled TF32 after import."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is enabled; lorads_torch needs full f32")


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(
            f"device {dev} not yet ported to lorads_torch")
    return dev


def resolve_dtype(name: str) -> torch.dtype:
    """``"f32"`` gives float32; ``"auto"`` and ``"f64"`` give float64, on
    the CPU and on the card alike.  lorads_tpu starts ``auto`` at f32
    where f64 is emulated (a TPU) and escalates to f64 on demand
    (lorads_tpu/alg/solver.py:94-100); the H100 runs f64 natively, so
    the port's ``auto`` starts where lorads_tpu's does on the CPU.  A
    solve started at f32 escalates only as ``auto`` (the solver's
    ``_auto_dtype``, ``maybe_escalate_f64``)."""
    if name in ("auto", "f64"):
        return torch.float64
    if name == "f32":
        return torch.float32
    raise NotImplementedError(
        f"dtype={name!r} not yet ported to lorads_torch")


def _count_read(t: torch.Tensor, label: str) -> None:
    global HOST_SYNCS
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"host read ({label}) inside a CUDA graph "
                           "capture")
    HOST_SYNCS_BY[label] += 1
    HOST_SYNCS += 1


def host_read(t: torch.Tensor, label: str):
    """Copy a (small) device tensor to the host as Python numbers,
    counting the sync under ``label`` (one of LABELS).  0-d tensors give
    a float, others a list."""
    _count_read(t, label)
    return t.item() if t.dim() == 0 else t.tolist()


def host_array(t: torch.Tensor, label: str):
    """Copy a device tensor to the host as a NumPy array, counted as one
    read under ``label`` as host_read is (checkpoints and solution
    files, which need the bits and the shape, not Python numbers)."""
    _count_read(t, label)
    return t.detach().cpu().numpy()


def reset_host_syncs() -> None:
    global HOST_SYNCS
    HOST_SYNCS = 0
    for k in HOST_SYNCS_BY:
        HOST_SYNCS_BY[k] = 0


def backend_report(device: torch.device, dtype: torch.dtype) -> str:
    """One line: device name, dtype and which kernel path serves it."""
    from lorads_torch.ops import kernels
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        path = "cuda kernels (" + ", ".join(kernels.KERNEL_NAMES) + ")"
    else:
        name = "cpu"
        path = "plain torch versions (CPU tensors)"
    return (f"lorads_torch backend: device={device} ({name}) "
            f"dtype={str(dtype).replace('torch.', '')} kernels={path}")
