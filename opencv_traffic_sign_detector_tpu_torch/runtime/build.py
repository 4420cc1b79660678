"""Build, load and call the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, ``build/torch_kernels/<hash>/
libtsd_kernels.so`` at the repository root, keyed by a hash of the sources
and flags, and bound with :mod:`ctypes`.  No PyTorch headers are involved,
so a build takes seconds.  Every pointer and the stream are passed as
``c_void_p``; every entry point returns ``cudaGetLastError()`` after its
launches and :func:`check` raises when that is not 0.

Nothing here runs for CPU tensors: the op wrappers take their plain PyTorch
versions for tensors on the CPU and call :func:`library` only for CUDA
tensors.  Each wrapper adds one to its entry of the launch counts where it
launches its kernel, so a run can show that it went through the kernels;
inside a CUDA graph's capture the count goes to the graph's record, which
each replay adds (:func:`recording_launches`, :func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libtsd_kernels.so"
# -fmad=false: kernels that must equal their plain versions bit for bit rely
# on separately rounded products and sums (no contraction into FMA).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false",
)

# Launch counters, one per kernel wrapper.  K5 counts its two call sites
# apart: the XLA level sweep (propagate_rolls) and the roll-flood refine
# (propagate_rolls_refine).  tile_luts is K1 with the LUT tail.
KERNELS = ("tile_histograms", "tile_luts", "clahe_apply", "level_sweep", "flood_bbox",
           "propagate_rolls", "propagate_rolls_refine", "propagate_scan",
           "level_sweep_full")

_V, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tsd_tile_histograms": [_V, _V] + [_I] * 5 + [_V],
    "tsd_tile_luts": [_V, _V, _V] + [_I] * 6 + [_F, _V],
    "tsd_clahe_apply": [_V] * 7 + [_I] * 6 + [_V],
    "tsd_level_sweep": [_V] * 4 + [_I] * 14 + [_F] * 4 + [_V],
    "tsd_level_sweep_full": [_V] * 4 + [_I] * 11 + [_F] * 4 + [_V],
    "tsd_level_sweep_scan": [_V] * 4 + [_I] * 17 + [_F] * 4 + [_V],
    "tsd_flood_bbox": [_V, _V, _V] + [_I] * 8 + [_V],
    "tsd_propagate_scan": [_V, _V, _V] + [_I] * 5 + [_V],
    "tsd_propagate_rolls": [_V] * 4 + [_I] * 8 + [_V],
    "tsd_propagate_rolls_form": [_I, _I],
    "tsd_stamp": [_V, _I, _V],
}

_launches = dict.fromkeys(KERNELS, 0)
_sink = _launches  # where count_launch adds: the counts, or a capture's record
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: PATH first, then ``$CUDA_HOME/bin``, then the
    toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built.  CUDA "
        "tensors need the CUDA toolkit; CPU tensors use the plain PyTorch "
        "versions and need no build."
    )


def sources() -> list[Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source hash is already built.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills per kernel.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists() and not verbose:
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            objs.append(os.path.join(tmp_dir, src.stem + ".o"))
            procs.append((src.name, subprocess.Popen(
                [nvcc, *flags, "-c", "-o", objs[-1], str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        tmp_lib = os.path.join(tmp_dir, LIB_NAME)
        steps = [(name, proc.communicate()[0], proc.returncode) for name, proc in procs]
        if all(rc == 0 for _, _, rc in steps):
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
                                  capture_output=True, text=True)
            steps.append(("link", link.stdout + link.stderr, link.returncode))
        failed = [(name, out, rc) for name, out, rc in steps if rc != 0]
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(
                f"[{name}] exit {rc}\n{out}" for name, out, rc in failed))
        if verbose:
            print("\n".join(f"[{name}]\n{out}" for name, out, _ in steps))
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tsd_error_string.argtypes = [ctypes.c_int]
        lib.tsd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def is_loaded() -> bool:
    return _lib is not None


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().tsd_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {rc} ({msg})")


def count_launch(kernel: str) -> None:
    _sink[kernel] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the launch counts: a CUDA graph's replay launches the
    kernels that its capture recorded (``runtime/graphs.py``)."""
    for k, v in counts.items():
        _launches[k] += v


@contextlib.contextmanager
def recording_launches():
    """Context for a CUDA graph's capture, which enqueues the kernels into the
    graph and launches none: the wrappers' counts inside go into the dict it
    yields, a replay's launches, and not into the launch counts."""
    global _sink
    _sink = dict.fromkeys(KERNELS, 0)
    try:
        yield _sink
    finally:
        _sink = _launches


def uses_plain(*tensors: torch.Tensor) -> bool:
    """True when the inputs lie on the CPU (take the plain version), False
    when they lie on one CUDA device (launch the kernel); raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return False


def missing_card(device: str) -> str | None:
    """Why ``device`` cannot be used when it names CUDA and no card is
    visible, else None: the entry points never fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return (f"--device {device}: torch.cuda.is_available() is false; pass "
                "--device cpu to run the kernels' plain versions on the CPU")
    return None


def card_line(device) -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, the
    line a time on the card is printed beside; ``device <device>`` off a
    card."""
    if torch.device(device).type != "cuda":
        return f"device {device}"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` has the dtype and rank a kernel takes and is
    contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
