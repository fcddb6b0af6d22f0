"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``blindno_torch/csrc/`` have a plain C interface and include no
PyTorch header, so each compiles in seconds. One ``nvcc`` per source runs at the same
time, and one more links the objects into a single shared library. The library goes
into ``blindno_torch/_build/<hash of csrc and flags>/`` at first use and is reused while
the sources are unchanged. A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = ("common.cu", "fno1d_layer.cu", "fno2d_layer.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I = ctypes.c_void_p, ctypes.c_int
# fno1d_layer_forward(x, wr, wi, pk, pk_si, pk_so, pb, out, B, Cin, Cout, N, M, dc_half,
#                     epilogue, device, stream)
FNO1D_ARGTYPES = [_P] * 4 + [_I, _I] + [_P] * 2 + [_I] * 8 + [_P]
# fno2d_layer_forward(x, fyre, fyim, fxre, fxim, gxre, gxim, gyre, gyim, wr, wi,
#                     pk, pk_si, pk_so, pb, spec, z, out, B, Cin, Cout, H, W, m1, m2,
#                     epilogue, device, stream)
FNO2D_ARGTYPES = [_P] * 12 + [_I, _I] + [_P] * 4 + [_I] * 9 + [_P]


def find_nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if "CUDA_HOME" in os.environ else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
                       "kernels cannot be built")


def build_dir(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in csrc.iterdir() if p.is_file()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return PKG / "_build" / h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at the same time; return their (returncode, output) in order.
    Every process is gone when this returns, also on a timeout or an interrupt."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outputs = [p.communicate(timeout=BUILD_TIMEOUT_S)[0] for p in procs]
        return [(p.returncode, text) for p, text in zip(procs, outputs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources in ``csrc`` into a shared library (once per source hash);
    return its path."""
    out_dir = build_dir(csrc)
    lib = out_dir / "libblindno_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    srcs = [csrc / name for name in SOURCES]
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out_dir / f"tmp.{tag}.so"
    steps = [[[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)],
             [[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]]]
    log = []
    for cmds in steps:
        results = _run_all(cmds)
        log += [" ".join(cmd) + "\n" + text for cmd, (_, text) in zip(cmds, results)]
        (out_dir / "build.log").write_text("\n".join(log))
        failed = [(cmd, rc, text) for cmd, (rc, text) in zip(cmds, results) if rc != 0]
        if failed:
            cmd, rc, text = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text[-4000:]}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare every signature."""
    lib = ctypes.CDLL(str(path))
    lib.fno1d_layer_forward.argtypes = FNO1D_ARGTYPES
    lib.fno1d_layer_forward.restype = ctypes.c_int
    lib.fno2d_layer_forward.argtypes = FNO2D_ARGTYPES
    lib.fno2d_layer_forward.restype = ctypes.c_int
    lib.blindno_error_string.argtypes = [ctypes.c_int]
    lib.blindno_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library of ``csrc/``, built on first use."""
    return load(build())
