"""Build and load the port's CUDA kernels (``mmgl_tpu_torch/csrc``).

The sources have a plain C interface, so they are compiled by ``nvcc`` (one
process per source, all started together) and linked into a shared library
loaded with ``ctypes``: no PyTorch headers, a build of seconds. The library is built at first use into ``build/mmgl_tpu_torch/`` at
the root of the checkout, under a name keyed by a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is not.

Nothing here runs at import: the CPU tests import every module, and a host
without ``nvcc`` only fails when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mmgl_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")


@dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it was obtained."""
    lib: ctypes.CDLL
    path: Path
    seconds: float       # wall time of this process's build (0 when cached)
    ptxas: str           # nvcc's -Xptxas -v report from the build


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    # $CUDA_HOME, else the toolkit's usual place (torch.utils.cpp_extension
    # looks there too)
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.access(nvcc, os.X_OK):
        return nvcc
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
        "mmgl_tpu_torch cannot be built on this host")


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands concurrently; raise on the first that failed;
    return their output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outputs = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        outputs.append((cmd, proc.returncode, text))
    for cmd, rc, text in outputs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return "".join(text for _, _, text in outputs)


def _compile(out: Path) -> float:
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objects = [out.parent / f"{tag}.{s.stem}.o" for s in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    try:
        report = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                       for src, obj in zip(sources, objects)])
        _run([[nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(o) for o in objects)]])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    out.with_suffix(".ptxas.txt").write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return seconds


@functools.lru_cache(maxsize=None)
def load() -> Library:
    """Build (if needed) and load the kernel library; raises on any failure."""
    out = BUILD_DIR / f"mmgl_kernels-{_digest()}.so"
    seconds = 0.0 if out.exists() else _compile(out)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    u32 = ctypes.c_uint
    # K1-K6 have a scalar entry (fp32) and a tensor-core one (bf16, *_tc)
    # with the same arguments
    signatures = {
        "mmgl_allheads_fwd": [ptr] * 5 + [i32] * 5 + [f32, i32, i32, ptr],
        # K4 also takes the row max and sum outputs (null unless K6 follows)
        "mmgl_flash_fwd": [ptr] * 7 + [i32] * 5 + [f32, i32, i32, ptr],
        "mmgl_fused_heads_fwd": [ptr] * 5 + [i32] * 4 + [f32, i32, i32, ptr],
        "mmgl_allheads_bwd": [ptr] * 10 + [i32] * 5 + [f32, i32, i32, ptr],
        "mmgl_flash_bwd": [ptr] * 10 + [i32] * 5 + [f32, i32, i32, ptr],
        "mmgl_blocked_bwd": [ptr] * 12 + [i32] * 5 + [f32, i32, i32, ptr],
    }
    for name, args in signatures.items():
        for fn in (name, name + "_tc"):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = i32
    # K7 and K8/K9: the tensor-core entries also take the row max and sum
    # (null where none are kept) and the bias's row stride
    tail = [f32, i32, u32, f32, i32, i32]
    bias_signatures = {
        "mmgl_bias_fwd": [ptr] * 7 + [i32] * 5 + tail + [ptr],
        "mmgl_bias_fwd_tc": [ptr] * 9 + [i32] * 5 + tail + [i32, ptr],
        "mmgl_bias_bwd": [ptr] * 14 + [i32] * 5 + tail + [ptr],
        "mmgl_bias_bwd_tc": [ptr] * 16 + [i32] * 5 + tail + [i32, ptr],
    }
    for name, args in bias_signatures.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i32
    lib.mmgl_error_string.argtypes = [i32]
    lib.mmgl_error_string.restype = ctypes.c_char_p
    ptxas = out.with_suffix(".ptxas.txt")
    return Library(lib, out, seconds,
                   ptxas.read_text() if ptxas.exists() else "")


def check(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.mmgl_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")
