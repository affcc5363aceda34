"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The library is compiled by ``nvcc`` at first use, from the sources in this
checkout only, into ``build/nsgp_kernels/`` at the repository root (listed in
``.gitignore``).  Each ``.cu`` is compiled to an object by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library.  Its file name carries a hash of every file under ``csrc/`` and of
the flags, so an edited source or header triggers a rebuild.  It has a plain C
interface and is loaded with ``ctypes``; no PyTorch headers are compiled,
which keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "nsgp_kernels"
# No --use_fast_math: see the note at the top of csrc/fused_kalman.cuh.
# -Xptxas -v: every kernel's registers, shared memory and spills go to the
# build log beside the library (``ptxas_log_path``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "nsgp_fused_fwd_f32": ([_i] + [_p] * 10 + [_i, _i, _i, _p], _i),
    "nsgp_fused_fwd_f64": ([_i] + [_p] * 10 + [_i, _i, _i, _p], _i),
    "nsgp_fused_bwd_f32": ([_i] + [_p] * 9 + [_i, _i, _i, _p], _i),
    "nsgp_fused_bwd_f64": ([_i] + [_p] * 9 + [_i, _i, _i, _p], _i),
    "nsgp_fused_adf_f32": ([_i] + [_p] * 10 + [_d, _d] + [_i] * 6 + [_p] * 6, _i),
    "nsgp_fused_adf_f64": ([_i] + [_p] * 10 + [_d, _d] + [_i] * 6 + [_p] * 6, _i),
    "nsgp_adf_threads": ([], _i),
    "nsgp_adf_max_width": ([], _i),
    "nsgp_adf_cluster": ([_i], _i),
    "nsgp_adf_probe_phases": ([], _i),
    "nsgp_adf_vjp_scratch": ([_i, _i, _i], ctypes.c_longlong),
    "nsgp_fused_adf_mb_f32": ([_i] + [_p] * 10 + [_d, _d] + [_i] * 7 + [_p] * 7, _i),
    "nsgp_fused_adf_mb_f64": ([_i] + [_p] * 10 + [_d, _d] + [_i] * 7 + [_p] * 7, _i),
    "nsgp_fused_ihgp_adf_f32": ([_i] + [_p] * 14 + [_d] * 4 + [_i] * 7 + [_p] * 6, _i),
    "nsgp_fused_ihgp_adf_f64": ([_i] + [_p] * 14 + [_d] * 4 + [_i] * 7 + [_p] * 6, _i),
    "nsgp_fused_ihgp_smooth_f32": ([_i] + [_p] * 5 + [_i] * 3 + [_p], _i),
    "nsgp_fused_ihgp_smooth_f64": ([_i] + [_p] * 5 + [_i] * 3 + [_p], _i),
    "nsgp_fused_adf_vjp_f32": ([_i] + [_p] * 17 + [_d, _d] + [_i] * 6 + [_p] * 8, _i),
    "nsgp_fused_adf_vjp_f64": ([_i] + [_p] * 17 + [_d, _d] + [_i] * 6 + [_p] * 8, _i),
    "nsgp_ihgp_adf_vjp_scratch": ([_i, _i, _i, _i], ctypes.c_longlong),
    "nsgp_fused_ihgp_adf_vjp_f32": ([_i] + [_p] * 21 + [_d] * 4 + [_i] * 7 + [_p] * 8, _i),
    "nsgp_fused_ihgp_adf_vjp_f64": ([_i] + [_p] * 21 + [_d] * 4 + [_i] * 7 + [_p] * 8, _i),
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _run_all(cmds) -> list:
    """Run the commands side by side; raise with the output of the first
    that fails, else return every command's compiler output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return logs


def _compile(tmp: Path, out: Path, sources, flags) -> None:
    """One nvcc per source (in parallel), then the link."""
    nvcc = _nvcc()
    objs = [tmp / (src.stem + ".o") for src in sources]
    logs = _run_all([[nvcc, *flags, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objs)])
    lib = tmp / "lib.so"
    _run_all([[nvcc, *flags, "-shared", "-o", str(lib), *map(str, objs)]])
    ptxas_log_path(out).write_text("\n".join(logs))
    os.replace(lib, out)  # atomic: a concurrent loader never sees half a file


def ptxas_log_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.log")


def library_path(stem: str = "libnsgp_kernels", defines=()) -> Path:
    h = hashlib.sha256()
    for src in sorted(p for p in _CSRC.rglob("*") if p.is_file()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library(stem: str = "libnsgp_kernels", sources=SOURCES, defines=()) -> ctypes.CDLL:
    """Compile (if needed) and load a kernel library; raises on failure.
    The default is the shipped library of all sources; a tool may build a
    subset under another name with extra ``-D`` flags (the cycle probe)."""
    out = library_path(stem, defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            _compile(Path(tmp), out, sources, NVCC_FLAGS + tuple(defines))
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:  # a subset library lacks the other sources' entries
            fn.argtypes = argtypes
            fn.restype = restype
    return lib
