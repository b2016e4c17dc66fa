"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers):
one ``nvcc`` process for each source, all started together, compiles them
in seconds, and one more links them into a shared library. The library goes
into ``build/torch_kernels/`` beside the package (or
``$TSDE_TORCH_BUILD_DIR``), named by a hash of the sources, headers and
flags, so an edited source is rebuilt. Without ``nvcc`` the build raises:
there is no fallback.

A kernel whose functions are only known at run time (the SRK solve of
``ops/srk_fused.py`` over a user's drift and diffusion) is a generated
source that includes a header of ``csrc/``: :func:`library_for_source`
compiles it with the same flags into a library of its own, named by a hash
of the text, the headers and the flags, and keeps it for the process.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("latent_fused_fwd.cu", "latent_fused_bwd.cu", "gan_gen_fwd.cu",
           "gan_cde_fwd.cu", "gan_gen_bwd.cu", "gan_gen_bwd_bf16.cu",
           "gan_cde_bwd.cu", "gan_cde_bwd_bf16.cu",
           "tower_euler_fwd.cu", "tower_euler_bwd.cu", "tower_rh_fwd.cu",
           "tower_rh_bwd.cu", "tower_euler_logqp_fwd.cu",
           "tower_euler_logqp_bwd.cu", "tower_bwd_contract.cu",
           "philox_normal.cu")
HEADERS = ("mixed_dtype.cuh", "latent_fused_common.cuh",
           "gan_fused_common.cuh", "gan_warp_rows.cuh", "gan_gen_bwd.cuh",
           "tower_solve_common.cuh", "tower_fwd_tile.cuh", "mma_tf32.cuh",
           "mma_bf16.cuh", "gan_bwd_bf16.cuh")
# Headers that generated sources include (library_for_source).
SOURCE_HEADERS = ("srk_srid2.cuh",)
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

# nvcc's output from the last build in this process, source by source,
# each headed by the seconds from the build's start until its nvcc ended
# (ptxas prints each kernel's registers, shared memory and spills); empty
# when the library was already built.
build_log = ""
_lib = None
_source_libs = {}


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
    # The backward: the widths, the window, the device and the stream.
    bwd = lib.tsde_latent_fused_bwd
    bwd.argtypes = [P] * 29 + [I] * 8 + [P]
    bwd.restype = I
    # K stacked replicas: K before the widths.
    fwd_multi = lib.tsde_latent_fused_fwd_multi
    fwd_multi.argtypes = [P] * 23 + [I] * 8 + [P]
    fwd_multi.restype = I
    bwd_multi = lib.tsde_latent_fused_bwd_multi
    bwd_multi.argtypes = [P] * 29 + [I] * 9 + [P]
    bwd_multi.restype = I
    # Its phases one at a time: K, widths, window, stages, device, stream.
    bwd_stages = lib.tsde_latent_fused_bwd_stages
    bwd_stages.argtypes = [P] * 29 + [I] * 10 + [P]
    bwd_stages.restype = I
    # Their bf16 mixed-mode instantiations take the same arguments.
    for name in ("fwd", "bwd", "fwd_multi", "bwd_multi", "bwd_stages"):
        f32 = getattr(lib, f"tsde_latent_fused_{name}")
        bf16 = getattr(lib, f"tsde_latent_fused_{name}_bf16")
        bf16.argtypes, bf16.restype = f32.argtypes, f32.restype
    for name in ("", "_bf16"):
        ws = getattr(lib, f"tsde_latent_fused_bwd_workspace{name}")
        ws.argtypes = [I] * 5
        ws.restype = ctypes.c_size_t
    lib.tsde_latent_fused_bwd_smem_bytes_bf16.argtypes = [I, I, I]
    lib.tsde_latent_fused_bwd_smem_bytes_bf16.restype = ctypes.c_size_t
    lib.tsde_latent_fused_bwd_blocks_per_sm_bf16.argtypes = [I] * 5
    lib.tsde_latent_fused_bwd_blocks_per_sm_bf16.restype = I
    lib.tsde_latent_fused_fwd_rows.argtypes = [I] * 6
    lib.tsde_latent_fused_fwd_rows.restype = I
    lib.tsde_latent_fused_fwd_smem_bytes_bf16.argtypes = [I, I, I]
    lib.tsde_latent_fused_fwd_smem_bytes_bf16.restype = ctypes.c_size_t
    lib.tsde_latent_fused_fwd_blocks_per_sm_bf16.argtypes = [I] * 6
    lib.tsde_latent_fused_fwd_blocks_per_sm_bf16.restype = I
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
    # Their bf16 mixed-mode instantiations take the same arguments.
    for name in ("gen_fwd", "cde_fwd", "gen_bwd", "cde_bwd"):
        f32 = getattr(lib, f"tsde_gan_{name}")
        bf16 = getattr(lib, f"tsde_gan_{name}_bf16")
        bf16.argtypes, bf16.restype = f32.argtypes, f32.restype
    # The GAN kernels' shared memory depends on their warps a block too.
    for name in ("gen_fwd", "cde_fwd", "gen_bwd", "cde_bwd"):
        smem = getattr(lib, f"tsde_gan_{name}_smem_bytes")
        smem.argtypes = [I, I, I, I]
        smem.restype = ctypes.c_size_t
    lib.tsde_gan_bwd_partials.argtypes = [I, I, I]
    lib.tsde_gan_bwd_partials.restype = I
    # The bf16 reverse sweeps on tensor cores (kernels 6 and 8): their
    # shared memory, instantiation and partials (one a group of 8 rows).
    for name in ("gen_bwd", "cde_bwd"):
        smem = getattr(lib, f"tsde_gan_{name}_smem_bytes_bf16")
        smem.argtypes = [I, I, I, I]
        smem.restype = ctypes.c_size_t
        design = getattr(lib, f"tsde_gan_{name}_design_bf16")
        design.argtypes = [I, I, I]
        design.restype = I
    lib.tsde_gan_bwd_partials_bf16.argtypes = [I]
    lib.tsde_gan_bwd_partials_bf16.restype = I
    # The TowerSpec solves: two layer tables (host, device), the tensors,
    # then nf, ng, nh, S, m, diag, wt, stage, (kernels 11 and 13: rows,
    # threads, cluster; kernel 9: rows, threads, mma,) B, N, (kernels 10,
    # 12 and 14: window, stages,) device and the stream.
    for name, tensors, ints in (("euler_fwd", 7, 14), ("euler_bwd", 12, 13),
                                ("rh_fwd", 11, 14), ("rh_bwd", 15, 13),
                                ("euler_logqp_fwd", 9, 14),
                                ("euler_logqp_bwd", 14, 13)):
        fn = getattr(lib, f"tsde_tower_{name}")
        fn.argtypes = [P] * (2 + tensors) + [I] * ints + [P]
        fn.restype = I
    lib.tsde_tower_bwd_workspace.argtypes = [P] + [I] * 9
    lib.tsde_tower_bwd_workspace.restype = ctypes.c_size_t
    lib.tsde_tower_smem_bytes.argtypes = [I, P] + [I] * 8
    lib.tsde_tower_smem_bytes.restype = ctypes.c_size_t
    lib.tsde_tower_fwd_smem_bytes.argtypes = [I, P] + [I] * 10
    lib.tsde_tower_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.tsde_tower_euler_fwd_mma_smem_bytes.argtypes = [P] + [I] * 6
    lib.tsde_tower_euler_fwd_mma_smem_bytes.restype = ctypes.c_size_t
    for name in ("rh_fwd", "euler_logqp_fwd"):
        getattr(lib, f"tsde_tower_{name}_clusters").argtypes = [I] * 3
        getattr(lib, f"tsde_tower_{name}_clusters").restype = I
    lib.tsde_tower_blocks.argtypes = [I]
    lib.tsde_tower_blocks.restype = I
    lib.tsde_philox_normal.argtypes = [P, P, ctypes.c_longlong, I, P]
    lib.tsde_philox_normal.restype = I
    _bind_error_string(lib)


def _bind_error_string(lib):
    lib.tsde_cuda_error_string.argtypes = [ctypes.c_int]
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
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]

        def finish(proc):
            log = proc.communicate()[0]
            return log, proc.returncode, time.perf_counter() - t0

        # Each source's log and the seconds until its nvcc ended.
        with ThreadPoolExecutor(len(procs)) as pool:
            logs = [(src.name, *done) for src, done in
                    zip(sources, pool.map(finish, procs))]
        build_log = "".join(f"== {name} ({seconds:.1f} s)\n{log}"
                            for name, log, _, seconds in logs)
        failed = [name for name, _, rc, _ in logs if rc != 0]
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


def source_library_path(name, text):
    """Where :func:`library_for_source` puts the library of ``text``: named
    by a hash of the text, the headers it may include and the flags."""
    digest = hashlib.sha256(
        text.encode()
        + b"".join((_CSRC / h).read_bytes() for h in SOURCE_HEADERS)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def library_for_source(name, text):
    """The shared library of a generated CUDA source ``text`` (which may
    include the headers of ``csrc/``), compiled with the kernels' flags at
    its first use and kept for the process; the caller binds its functions.
    Raises RuntimeError without ``nvcc`` or when the source does not
    compile."""
    global build_log
    if (name, text) in _source_libs:
        return _source_libs[name, text]
    out = source_library_path(name, text)
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # The source and the library go through files of this process's
        # own, so that two processes building the same text never write
        # one file under the other's nvcc.
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src = out.with_name(f"{out.stem}.{os.getpid()}.cu")
        try:
            src.write_text(text)
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-I", str(_CSRC), "-o",
                 str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        finally:
            src.unlink(missing_ok=True)
        build_log += f"== {src.name}\n{proc.stdout}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            build_log += f"== the source of {src.name}\n{text}"
            raise RuntimeError(f"nvcc failed ({src.name}):\n{proc.stdout}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _bind_error_string(lib)
    _source_libs[name, text] = lib
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
