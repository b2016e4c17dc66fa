"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers), so
one ``nvcc`` call builds them in seconds. The library goes into
``build/torch_kernels/`` beside the package (or ``$TSDE_TORCH_BUILD_DIR``),
named by a hash of the sources and flags, so an edited source is rebuilt.
Without ``nvcc`` the build raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("latent_fused_fwd.cu",)
BUILD_DIR = Path(os.environ.get(
    "TSDE_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "torch_kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Dynamic shared memory a block may opt into on Hopper (H100/H200).
MAX_SMEM_BYTES = 232448

# nvcc's output from the last build in this process (ptxas prints each
# kernel's registers, shared memory and spills); empty when the library was
# already built.
build_log = ""
_lib = None


def find_nvcc():
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME): torchsde_tpu_torch builds its "
        "CUDA kernels from source at first use and needs the CUDA toolkit")


def _bind(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    fwd = lib.tsde_latent_fused_fwd
    fwd.argtypes = [P] * 23 + [I] * 7 + [P]
    fwd.restype = I
    lib.tsde_latent_fused_fwd_smem_bytes.argtypes = [I, I, I]
    lib.tsde_latent_fused_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.tsde_cuda_error_string.argtypes = [I]
    lib.tsde_cuda_error_string.restype = ctypes.c_char_p


def library_path():
    sources = [_CSRC / name for name in SOURCES]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtsde_kernels_{digest}.so", sources


def load_library():
    """The kernels' shared library, built on the first call of a process
    if its file is missing."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out, sources = library_path()
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code "
                               f"{proc.returncode}:\n{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _lib = lib
    return lib
