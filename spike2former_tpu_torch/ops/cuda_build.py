"""Build a CUDA source of ``csrc/`` into a plain-C shared library with
``nvcc`` and load it with ``ctypes``.

The library is built at first use into ``<checkout>/build/`` (listed in
``.gitignore``), in a directory keyed on a hash of the source and the flags,
so a later call, or another process, reuses it.  PyTorch's extension builder
is not used: a source that includes PyTorch's headers takes minutes to
compile, a plain C interface seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to, keyed on its content, the
    headers of ``csrc/`` (which a source may include) and the flags."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return (BUILD_ROOT / f"{src.stem}-{key.hexdigest()[:16]}"
            / f"lib{src.stem}.so")


def build_all(sources) -> list[Path]:
    """Compile each ``csrc/<source>`` whose keyed library does not exist,
    one ``nvcc`` process per source, all started together; the compiler's
    resource report (``-Xptxas -v``) goes to ``build.log`` beside each
    library.  Returns the library paths in the order of ``sources``."""
    libs = [library_path(src) for src in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, cmd, proc))
    failed = []
    for src, lib, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src}:\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its keyed library exists."""
    return build_all((source,))[0]


def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)))
