"""Build and load the port's CUDA kernels and its native host code.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go to
``build/locust_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  ``build()`` starts one ``nvcc`` per source, all at once, and
waits for them together.  Nothing is built at import: the first kernel
launch, or ``chip_smoke.py``, calls ``load``/``build``.

Host sources (``HOST_SOURCES``: ``csrc/ingest.cpp``, the native reader)
compile with ``g++ -O3 -shared -fPIC`` (``build_host``) into the same
directory, keyed the same way; ``load`` builds either kind.  A host build
that fails, or finds no ``g++``, raises ``OSError`` with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "locust_tpu_torch"
KERNEL_SOURCES = ("tokenize", "bitonic", "fused_fold", "pagerank", "partition")
HOST_SOURCES = ("ingest",)
HOST_FLAGS = ("-O3", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location; raises when there is none."""
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of locust_tpu_torch build "
            "only where the CUDA toolkit is installed"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (or, for a host source, ``csrc/<name>.cpp``)
    builds to, keyed by its source, the shared headers of the CUDA
    sources and the flags."""
    if name in HOST_SOURCES:
        flags, srcs = HOST_FLAGS, [CSRC / f"{name}.cpp"]
    else:
        flags, srcs = NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    h = hashlib.sha1(" ".join(flags).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(names, command, error) -> dict[str, str]:
    """Start ``command(name, tmp_path)`` for every library in ``names``
    not built yet, all at once; wait for them together and publish each
    with an atomic rename.  Returns each new build's compiler output;
    raises ``error`` with the output of every build that failed."""
    pending = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.Popen(command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in pending.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} {name} exited {proc.returncode}:\n{report}")
            continue
        os.replace(tmp, out)
        reports[name] = report
    if failed:
        raise error("\n".join(failed))
    return reports


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Build every CUDA library in ``names`` that is not built yet, one
    nvcc per source, all started together.  Returns each new build's
    compiler report (``-Xptxas -v``: registers, shared memory, spills);
    raises ``RuntimeError`` with the compiler output when a build fails."""
    return _compile(names, lambda name, tmp: [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                              str(CSRC / f"{name}.cu")], RuntimeError)


def build_host(names=HOST_SOURCES) -> dict[str, str]:
    """Build every host library in ``names`` that is not built yet, one
    g++ per source, all started together; raises ``OSError`` with the
    compiler's output when one fails or there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise OSError("g++ not found: the native reader of locust_tpu_torch "
                      "builds only where a C++ compiler is installed")
    return _compile(names, lambda name, tmp: [gxx, *HOST_FLAGS, "-o", str(tmp),
                                              str(CSRC / f"{name}.cpp")], OSError)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``csrc/<name>.cpp``,
    built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (build_host if name in HOST_SOURCES else build)((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
