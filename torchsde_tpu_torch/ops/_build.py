"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers):
one ``nvcc`` process for each source, all started together, compiles them
in seconds, and one more links them into a shared library. The library goes
into ``build/torch_kernels/`` beside the package (or
``$TSDE_TORCH_BUILD_DIR``), named by a hash of the sources, headers and
flags, so an edited source is rebuilt. Without ``nvcc`` the build raises:
there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("latent_fused_fwd.cu", "latent_fused_bwd.cu", "gan_gen_fwd.cu",
           "gan_cde_fwd.cu", "gan_gen_bwd.cu", "gan_cde_bwd.cu",
           "tower_euler_fwd.cu", "tower_euler_bwd.cu", "tower_rh_fwd.cu",
           "tower_rh_bwd.cu", "tower_euler_logqp_fwd.cu",
           "tower_euler_logqp_bwd.cu")
HEADERS = ("latent_fused_common.cuh", "gan_fused_common.cuh",
           "tower_solve_common.cuh")
BUILD_DIR = Path(os.environ.get(
    "TSDE_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[2] / "build" / "torch_kernels"))
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Dynamic shared memory a block may opt into on Hopper (H100/H200), the
# shared memory of an SM, and what the card reserves for each block on it.
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
BLOCK_SMEM_RESERVED = 1024

# nvcc's output from the last build in this process, source by source
# (ptxas prints each kernel's registers, shared memory and spills); empty
# when the library was already built.
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
    bwd = lib.tsde_latent_fused_bwd
    bwd.argtypes = [P] * 29 + [I] * 7 + [P]
    bwd.restype = I
    for name in ("fwd", "bwd"):
        smem = getattr(lib, f"tsde_latent_fused_{name}_smem_bytes")
        smem.argtypes = [I, I, I]
        smem.restype = ctypes.c_size_t
    gen = lib.tsde_gan_gen_fwd
    gen.argtypes = [P] * 17 + [I] * 7 + [P]
    gen.restype = I
    cde = lib.tsde_gan_cde_fwd
    cde.argtypes = [P] * 11 + [I] * 7 + [P]
    cde.restype = I
    gen_bwd = lib.tsde_gan_gen_bwd
    gen_bwd.argtypes = [P] * 21 + [I] * 7 + [P]
    gen_bwd.restype = I
    cde_bwd = lib.tsde_gan_cde_bwd
    cde_bwd.argtypes = [P] * 14 + [I] * 7 + [P]
    cde_bwd.restype = I
    for name in ("gen_fwd", "cde_fwd", "gen_bwd", "cde_bwd"):
        smem = getattr(lib, f"tsde_gan_{name}_smem_bytes")
        smem.argtypes = [I, I, I]
        smem.restype = ctypes.c_size_t
    lib.tsde_gan_bwd_partials.argtypes = [I, I, I]
    lib.tsde_gan_bwd_partials.restype = I
    lib.tsde_latent_fused_bwd_blocks.argtypes = [I]
    lib.tsde_latent_fused_bwd_blocks.restype = I
    # The TowerSpec solves: two layer tables (host, device), the tensors,
    # then nf, ng, nh, S, m, diag, wt, stage, B, N, device and the stream.
    for name, tensors in (("euler_fwd", 7), ("euler_bwd", 12),
                          ("rh_fwd", 11), ("rh_bwd", 15),
                          ("euler_logqp_fwd", 9), ("euler_logqp_bwd", 14)):
        fn = getattr(lib, f"tsde_tower_{name}")
        fn.argtypes = [P] * (2 + tensors) + [I] * 11 + [P]
        fn.restype = I
    lib.tsde_tower_smem_bytes.argtypes = [I, P] + [I] * 8
    lib.tsde_tower_smem_bytes.restype = ctypes.c_size_t
    lib.tsde_tower_blocks.argtypes = [I]
    lib.tsde_tower_blocks.restype = I
    lib.tsde_cuda_error_string.argtypes = [I]
    lib.tsde_cuda_error_string.restype = ctypes.c_char_p


def library_path():
    sources = [_CSRC / name for name in SOURCES]
    digest = hashlib.sha256(
        b"".join((_CSRC / name).read_bytes() for name in SOURCES + HEADERS)
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
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [(src.name, proc.communicate()[0], proc.returncode)
                for src, proc in zip(sources, procs)]
        build_log = "".join(f"== {name}\n{log}" for name, log, _ in logs)
        failed = [name for name, _, rc in logs if rc != 0]
        if not failed:
            proc = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            build_log += proc.stdout
            if proc.returncode != 0:
                failed = ["link"]
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               f"{build_log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _lib = lib
    return lib


def library_for(smem_fn, *widths):
    """The kernels' library, once the shared memory that ``smem_fn`` (a C
    function of the library) gives for these widths is known to fit a
    block. Raises ValueError beyond it."""
    lib = load_library()
    smem = getattr(lib, smem_fn)(*widths)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"the solve's weights and activations need {smem} "
                         f"bytes of shared memory; a block has "
                         f"{MAX_SMEM_BYTES}")
    return lib


def check_launch(lib, rc, kernel):
    """Raises RuntimeError when a launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.tsde_cuda_error_string(rc).decode())
