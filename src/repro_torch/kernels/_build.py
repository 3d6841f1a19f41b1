"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``repro_torch/kernels/**/csrc/<name>.cu`` compiles, on its own, into
``build/repro_torch/<name>-<hash>.so`` at the repository root. The hash
covers the source directory's ``.cu``/``.cuh`` files and the flags, so an
edit rebuilds and an unchanged tree reuses the library. Sources expose a
plain C interface (no PyTorch headers), which keeps each build to seconds;
the wrappers pass tensors as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import: the first CUDA call builds, so the module
imports on a machine without nvcc, and a CUDA call there raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def sources() -> dict[str, Path]:
    """Kernel name -> its ``.cu`` source, for every kernel of the port."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives for the current sources."""
    src = sources()[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(src.parent.glob("*.cu*")):
        digest.update(dep.name.encode())
        digest.update(dep.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel whose library is missing, all nvcc processes
    started together, and wait for them. Returns name -> library path.
    The compiler's register and spill report goes to ``<lib>.log``."""
    srcs = sources()
    paths = {name: library_path(name) for name in srcs}
    todo = [name for name, path in paths.items() if not path.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            paths[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                continue
            os.replace(tmp, paths[name])
    finally:
        for _tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed)."""
    return ctypes.CDLL(str(build_all()[name]))
