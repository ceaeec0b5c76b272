"""Builds the port's CUDA sources with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/lib<name>-<digest>.so`` at the root of the checkout (listed in
``.gitignore``); the digest covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source or header is rebuilt. Nothing is
compiled when the package is imported: a kernel's library is built on its
first launch, or ahead of time by :func:`build`, which starts one ``nvcc``
per source (and variant), all at once. ``defines`` (``-D`` macros) build a
variant of a source into a library of its own, as
``tools/profile_lm_megastep.py`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def card_name(device: str = "cuda") -> str | None:
    """The card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, for the
    card of ``device`` (``cuda`` or ``cuda:<index>``); None for a CPU device.
    Every time or rate the port reports is written beside this line."""
    if not str(device).startswith("cuda"):
        return None
    index = str(device).partition(":")[2] or "0"
    return subprocess.run(["nvidia-smi", "-i", index, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    # the shared headers count too: an edited header rebuilds every source
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None, defines: tuple[str, ...] = (),
          also: tuple[tuple[str, tuple[str, ...]], ...] = ()) -> dict[str, dict]:
    """Compile the named sources (default: all) with ``defines``, and each
    (name, defines) pair of ``also``, all in parallel.

    Returns ``{key: {"seconds": wall time, "ptxas": register/spill report}}``,
    the key a source's name, followed by ``+MACRO`` for each define; a library
    already built reports 0 seconds. Raises with the compiler's output if any
    build fails.
    """
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name, defs in [*((n, defines) for n in names), *also]:
        key = "".join([name, *(f"+{d}" for d in defs)])
        out = library_path(name, defs)
        if out.exists():
            report[key] = {"seconds": 0.0, "ptxas": "cached"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *_flags(defs), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out, time.perf_counter())
    failures = []
    for key, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {key} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        ptxas = "\n".join(line for line in log.splitlines() if "ptxas info" in line or "spill" in line)
        report[key] = {"seconds": seconds, "ptxas": ptxas}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``, built
    first if needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        path = library_path(name, defines)
        if not path.exists():
            build([name], defines)
        lib = ctypes.CDLL(str(path))
        _loaded[(name, defines)] = lib
    return lib
