"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Nothing here runs at import. :func:`library` builds at the first CUDA
launch: one ``nvcc -c`` per source in ``csrc/``, all started together,
then one link into ``build/repro_torch/libkernels.so`` under the repository
root. The library is rebuilt only when the hash of the sources and flags
changes (``libkernels.sha256`` beside it). ``build.log`` keeps ``ptxas``'s
register and spill report of the last build. A build holds an exclusive
``fcntl`` lock on ``build.lock`` in that directory, so two processes that
launch a kernel for the first time at once build it once, and neither links
or loads the other's half-written objects.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("conv_im2col.cu", "conv_dw.cu", "pool.cu", "conv_shift.cu",
           "conv_add.cu", "matmul_q8.cu", "conv1d_causal.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points: argument types (every pointer and the stream a c_void_p).
#: The pools take their block size (``threads``) as the int before the
#: stream; the float modes take a dtype code (0 float32, 1 bfloat16)
#: before it; every conv, shift conv and add conv takes its tile (bp, q),
#: the depthwise convs theirs (pt, rows), the integer shift convs the
#: table's bound d before their requant shift, the integer matmuls their
#: tile (bn, bm) and cluster size, the float matmul its tile (bm, bn, tm,
#: tn), the causal conv1d x's row stride after D and its run and block
#: size after the dtype code. The ``*_plan``
#: functions fill an int array with a launch's arithmetic and launch
#: nothing.
SIGNATURES = {
    "repro_conv2d_q8": (_P,) * 4 + (_I,) * 11 + (_P,),
    "repro_depthwise2d_q8": (_P,) * 3 + (_I,) * 9 + (_P,),
    "repro_maxpool2d_s8": (_P,) * 2 + (_I,) * 9 + (_P,),
    "repro_shift_conv2d_q8": (_P,) * 5 + (_I,) * 10 + (_P,),
    "repro_add_conv2d_q8": (_P,) * 4 + (_I,) * 12 + (_P,),
    "repro_conv2d_w4": (_P,) * 5 + (_I,) * 11 + (_P,),
    "repro_depthwise2d_w4": (_P,) * 4 + (_I,) * 9 + (_P,),
    "repro_shift_conv2d_w4": (_P,) * 6 + (_I,) * 10 + (_P,),
    "repro_add_conv2d_w4": (_P,) * 5 + (_I,) * 12 + (_P,),
    "repro_matmul_q8": (_P,) * 3 + (_I,) * 8 + (_P,),
    "repro_matmul_w4": (_P,) * 4 + (_I,) * 8 + (_P,),
    "repro_causal_conv1d": (_P,) * 3 + (_I,) * 9 + (_P,),
    "repro_conv2d_f": (_P,) * 4 + (_I,) * 11 + (_P,),
    "repro_depthwise2d_f": (_P,) * 3 + (_I,) * 9 + (_P,),
    "repro_maxpool2d_f": (_P,) * 2 + (_I,) * 10 + (_P,),
    "repro_shift_conv2d_f": (_P,) * 4 + (_I,) * 9 + (_P,),
    "repro_add_conv2d_f": (_P,) * 3 + (_I,) * 10 + (_P,),
    "repro_matmul_f": (_P,) * 3 + (_I,) * 9 + (_P,),
    "repro_conv2d_i8_plan": (_P,) + (_I,) * 9,
    "repro_matmul_f_plan": (_P,) + (_I,) * 7,
    "repro_shift_conv2d_i8_plan": (_P,) + (_I,) * 8,
    "repro_shift_conv2d_f_plan": (_P,) + (_I,) * 7,
    "repro_conv2d_f_plan": (_P,) + (_I,) * 9,
    "repro_add_conv2d_f_plan": (_P,) + (_I,) * 8,
    "repro_depthwise2d_plan": (_P,) + (_I,) * 8,
    "repro_matmul_q8_plan": (_P,) + (_I,) * 7,
    "repro_maxpool2d_s8_plan": (_P,) + (_I,) * 6,
    "repro_maxpool2d_f_plan": (_P,) + (_I,) * 7,
    "repro_causal_conv1d_plan": (_P,) + (_I,) * 7,
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "are built on the machine with the card")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _build_lock():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> dict:
    """Build the library if its sources changed; returns ``{"path",
    "built", "seconds"}``. Raises with ``nvcc``'s output on failure."""
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    want = source_hash()

    def up_to_date():
        return lib.exists() and stamp.exists() and stamp.read_text() == want

    if up_to_date():
        return {"path": lib, "built": False, "seconds": 0.0}
    with _build_lock():
        if up_to_date():                # another process built it meanwhile
            return {"path": lib, "built": False, "seconds": 0.0}
        t0 = time.perf_counter()
        _compile_and_link(lib)
        stamp.write_text(want)
        return {"path": lib, "built": True,
                "seconds": time.perf_counter() - t0}


def _compile_and_link(lib: Path):
    exe = nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src} (rc={p.returncode})\n{out}")
        if p.returncode:
            failed.append(src)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"libkernels.{os.getpid()}.so"
    link = subprocess.run([exe, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)                # a loaded library keeps its inode


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, rc: int):
    """Raise if a C entry point returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           "(cudaGetLastError)")
