"""Build and load the port's CUDA kernels (``legkilo_torch/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into ONE shared library with a plain C interface
that ``ctypes`` loads -- no PyTorch headers, so a build takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o <name>.o           (one per source)
    nvcc -shared -o liblegkilo_kernels_<hash>.so *.o

The library goes into ``build/kernels/`` at the root of the checkout (listed
in .gitignore; ``LEGKILO_TORCH_BUILD_DIR`` overrides it) under a name that
hashes the sources and flags, so an edited source never loads a stale
build.  Nothing is built at import: the first kernel launch builds.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}


def build_dir() -> str:
    return os.environ.get("LEGKILO_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "kernels"
    )


def _nvcc() -> str:
    cands = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(build_dir(), f"liblegkilo_kernels_{_digest()}.so")


def ptxas_log_path() -> str:
    return library_path()[: -len(".so")] + ".ptxas.txt"


def build() -> str:
    """Compile every source in parallel and link one library; returns its
    path.  Reuses an existing library whose name matches the sources' hash.
    Raises with nvcc's output when a compile or the link fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir()) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, objs, failed = [], [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{text}")
            objs.append(obj)
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc] + ARCH_FLAGS + ["-shared", "-o", so_tmp] + objs,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
            f.write("\n".join(logs))
        os.replace(os.path.join(tmp, "ptxas.txt"), ptxas_log_path())
        os.replace(so_tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.lk_error_string.argtypes = [ctypes.c_int]
            lib.lk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _function(name: str, n_ptrs: int, n_ints: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_tensors(name: str, tensors: Sequence[torch.Tensor], dtypes, strided=()) -> torch.device:
    """Every tensor on one CUDA device, of the stated dtype, and contiguous
    unless its index is in ``strided`` (the kernel takes its strides)."""
    dev = tensors[0].device
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: argument {i} on {t.device}, expected {dev} (cuda)")
        if t.dtype != dt:
            raise ValueError(f"{name}: argument {i} has dtype {t.dtype}, expected {dt}")
        if i not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
    return dev


def launch(name: str, tensors: Sequence[torch.Tensor], ints: Sequence[int]) -> None:
    """Call C entry point ``name(ptr..., int..., stream)`` on the current
    stream of the tensors' device; raise on a nonzero CUDA error."""
    fn = _function(name, len(tensors), len(ints))
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*[t.data_ptr() for t in tensors], *[int(i) for i in ints], stream)
    if rc != 0:
        msg = _library().lk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
