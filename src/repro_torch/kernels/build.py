"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library under ``csrc/`` is compiled at first use, for ``sm_90a``,
into ``build/repro_torch/`` at the root of the checkout, under a file name
hashed over every source in ``csrc/`` and the flags, so an edited source
rebuilds and an unchanged one loads from disk. The sources export a plain
C interface (no PyTorch headers), which keeps a build to seconds; the
wrappers in ``dpxor.py``, ``fused_scan.py``, ``pir_matmul.py``,
``lwe_matmul.py`` and ``ggm_expand.py`` register each kernel as a
``torch.library`` op that launches on PyTorch's current stream.

A failed build raises :class:`BuildError` with nvcc's output. ``build``
compiles several libraries at once, one nvcc process per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: library name -> (source file in csrc/, exported C functions and argtypes)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARIES = {
    "dpxor": ("dpxor.cu", {"repro_dpxor": [_P, _P, _P, _L, _I, _I, _I, _P]}),
    "fused_scan_xor": ("fused_scan_xor.cu", {
        "repro_fused_scan_xor": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I,
                                 _I, _P],
        "repro_fused_scan_xor_wide_geometry": [_I, _I, _L, _I, _I, _P]}),
    "pir_gemm": ("pir_gemm.cu", {
        "repro_pir_gemm": [_P, _P, _P, _L, _I, _I, _I, _P]}),
    "fused_scan_add": ("fused_scan_add.cu", {
        "repro_fused_scan_add": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L,
                                 _I, _I, _I, _P]}),
    "lwe_gemm": ("lwe_gemm.cu", {
        "repro_lwe_gemm": [_P, _P, _P, _L, _L, _L, _I, _P]}),
    "ggm_expand": ("ggm_expand.cu", {
        "repro_ggm_expand": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P]}),
}


class BuildError(RuntimeError):
    """nvcc failed or is missing."""


class KernelError(RuntimeError):
    """A kernel launch returned a CUDA error."""


@dataclass
class BuildRecord:
    """How one library was obtained: the nvcc command, its wall time and
    ptxas's register / shared-memory / spill lines (``-Xptxas -v``)."""
    name: str
    path: str
    cmd: List[str] = field(default_factory=list)
    seconds: float = 0.0
    ptxas: List[str] = field(default_factory=list)
    cached: bool = False


@dataclass
class KernelCount:
    """Per-kernel counters: kernel launches on the card, and calls that
    took the plain PyTorch version because the tensors were on the CPU."""
    launches: int = 0
    plain_calls: int = 0

    def reset(self):
        self.launches = 0
        self.plain_calls = 0


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: build records of this process, by library name
RECORDS: Dict[str, BuildRecord] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise BuildError("nvcc not found on PATH, nor under CUDA_HOME "
                         f"({home}); the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Sequence[str]) -> Dict[str, BuildRecord]:
    """Compile the named libraries that are not on disk yet, in parallel.

    Returns the build records of all of them; raises ``BuildError`` if any
    nvcc run fails (after every started one has ended).
    """
    for name in names:
        if name not in LIBRARIES:
            raise KeyError(f"unknown CUDA library {name!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            RECORDS.setdefault(name, BuildRecord(name, str(out), cached=True))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / LIBRARIES[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, out)
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        RECORDS[name] = BuildRecord(name, str(out), cmd, seconds, ptxas)
    if failures:
        raise BuildError("nvcc failed:\n" + "\n".join(failures))
    return {name: RECORDS[name] for name in names}


def query_block(queries: int) -> int:
    """Queries per block (QB) of the select kernels' dispatch
    (``csrc/dpxor.cu``, ``csrc/pir_gemm.cu``): 1, 2, 4 or 8."""
    return next(qb for qb in (1, 2, 4, 8) if queries <= qb or qb == 8)


def mangled(kernel: str, *args) -> str:
    """The stem of a template instance's mangled entry name, as ptxas
    reports it: ``mangled("dpxor_kernel", 16, 8)`` is
    ``12dpxor_kernelILi16ELi8EE`` (``dpxor_kernel<16, 8>``); a bool
    argument mangles as ``Lb0E`` / ``Lb1E``."""
    parts = "".join(f"Lb{int(a)}E" if isinstance(a, bool) else f"Li{a}E"
                    for a in args)
    return f"{len(kernel)}{kernel}I{parts}E"


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """ptxas's ``-v`` report of library ``name``'s kernels in this
    process's build, by mangled entry name: ``registers`` per thread and
    the ``stack``, ``spill_stores`` and ``spill_loads`` bytes. Empty when
    the library was not built here (loaded from disk keeps no report)."""
    rec = RECORDS.get(name)
    out: Dict[str, Dict[str, int]] = {}
    current = ""
    for ln in rec.ptxas if rec else ():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            current = m.group(1)
            continue
        entry = out.setdefault(current, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            entry["registers"] = int(m.group(1))
    return out


def registers(name: str, entry: Optional[str] = None) -> Optional[int]:
    """Registers per thread ptxas gave library ``name``'s kernels in this
    process's build: the instance whose mangled entry name contains
    ``entry`` (a :func:`mangled` stem), or the most of any kernel when
    ``entry`` is None. None when the library was not built here or no
    entry matches."""
    used = [r["registers"] for e, r in ptxas_report(name).items()
            if "registers" in r and (entry is None or entry in e)]
    return max(used) if used else None


def library(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed (thread-safe)."""
    with _lock:
        if name not in _loaded:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise ``KernelError`` if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def n_sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def require_cuda_words(name: str, t: torch.Tensor, ndim: int,
                       align: int = 16):
    """Check a kernel operand: a contiguous, ``align``-byte aligned int32
    tensor of rank ``ndim`` on a CUDA device (16 for operands the kernel
    reads in vector loads, 4 for word-by-word reads)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 (u32 words), got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")


def require_cuda_bytes(name: str, t: torch.Tensor):
    """Check a byte operand: a contiguous, 4-byte aligned int8 matrix on a
    CUDA device (the byte kernels read whole 4-byte words and take their
    vector loads only where the address allows them)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.int8:
        raise TypeError(f"{name} must be int8, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must have 2 dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() and t.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")
